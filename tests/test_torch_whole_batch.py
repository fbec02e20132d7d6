"""The port's whole-batch path (``call_chromosome``) on the CPU, with
``engine="torch", device="cpu"``: the run that keeps a chromosome's reads
whole and the ``-c`` child region, both held to the committed
reference-binary oracles."""

import os

from test_torch_slice import DATA, DATE, _cfg, _read
from test_full_parity import _rows


def test_torch_whole_batch_matches_oracle(tmp_path, monkeypatch):
    """GROM_TPU_STREAM_BASES above the chromosome length sends it through
    the whole-batch call_chromosome."""
    from grom_tpu_torch.driver import run
    monkeypatch.setenv("GROM_TPU_STREAM_BASES", str(1 << 40))
    out = str(tmp_path / "o.vcf")
    run(_cfg("ds200k", out), file_date=DATE, engine="torch", device="cpu")
    got = _rows(out)
    want = _rows(os.path.join(DATA, "ds200k", "oracle.vcf"))
    assert got == want


def test_torch_child_region_matches_oracle(tmp_path):
    """-c runs the whole-batch path on one sub-region."""
    from grom_tpu_torch.driver import run
    oracle = os.path.join(DATA, "ds200k", "oracle.region-0-0-110000")
    out = str(tmp_path / "o.vcf")
    res = run(_cfg("ds200k", out, one_chromosome="0,0,0,110000"),
              engine="torch", device="cpu")
    assert res.vcf_path == out + ".chrSim-0"
    assert _read(res.vcf_path) == _read(oracle)
    assert _read(res.ctx_path) == _read(oracle + ".ctx")
