"""Whole runs of the harness on the CPU: a host without a card gets no
result, and with the chip check skipped (the port's torch engine on the
CPU, its kernels' plain versions) the comparison passes a sound run and
fails each fault a cell can have, planted underneath the timed path."""

import functools
import json

import numpy as np
import pytest

import harness
import plainref

SEED = 3000000019


def tiny_cell():
    cell = harness.load_cell("human30x.chrom16")
    cell["config"] = dict(cell["config"], contig_length=1_500_000)
    cell["traffic"] = dict(cell["traffic"], contigs=[
        dict(name="chrtiny", length=1_500_000,
             hotspots=[[400_000, 440_000, 60.0]],
             depressions=[[900_000, 950_000, 0.0]],
             repeats=[[1_200_000, 1_203_000, "AT"]])])
    return cell


def run(capsys, monkeypatch, seconds="0.01"):
    from grom_tpu_torch import driver
    monkeypatch.setattr(driver, "run",
                        functools.partial(driver.run, device="cpu"))
    rc = harness.main(["--workload", "human30x.chrom16", "--seed", str(SEED),
                       "--seconds", seconds, "--trace", "0"],
                      require_cuda=False, device="cpu", cell=tiny_cell())
    cap = capsys.readouterr()
    assert rc == 0
    res = json.loads(cap.out.strip().splitlines()[-1])
    res["detail"] = json.loads(cap.err.split("check detail ")[1]
                               .splitlines()[0])
    return res


def test_no_card_no_result(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    rc = harness.main(["--workload", "human30x.chrom16", "--seed", "1",
                       "--seconds", "1", "--trace", "0"])
    cap = capsys.readouterr()
    assert rc != 0
    assert cap.out.strip() == ""
    assert "no result" in cap.err


def test_sound_run_is_correct(capsys, monkeypatch):
    res = run(capsys, monkeypatch)
    assert res["correct"] is True
    assert res["checks"]["rows_wrong"] == {"value": 0, "limit": 0}
    assert list(res)[-2] == "checks"
    # the planted hotspot gives a CNV row, compared whole
    assert res["detail"]["cnv_rows"] >= 1
    assert "card_peak_gib" not in res["metrics"]


def _half_of_the_reads(monkeypatch):
    from grom_tpu_torch import driver
    from grom_tpu_torch.ingest import bam
    orig = bam.read_bam_region

    def half(*a, **k):
        h, reads = orig(*a, **k)
        return h, driver._subset_reads(reads, np.arange(0, len(reads.pos), 2))
    monkeypatch.setattr(bam, "read_bam_region", half)


def _tally_altered(monkeypatch):
    from grom_tpu_torch.ops import accumulate
    orig = accumulate.tile_kernel_plain

    def altered(*a, **k):
        base_tot, n_mm, cand = orig(*a, **k)
        cand["counts"] = cand["counts"].clone()
        cand["counts"][:, :1] += 1
        return base_tot, n_mm, cand
    monkeypatch.setattr(accumulate, "tile_kernel_plain", altered)


def _depth_lists_unchanged(monkeypatch):
    from grom_tpu_torch.ops import state
    monkeypatch.setattr(state.DepthLists, "add_window",
                        lambda self, *a, **k: None)


def _cnv_call_end_moved(monkeypatch):
    from grom_tpu_torch.ops import cnv_device
    orig = cnv_device.window_scan

    def moved(*a, **k):
        calls = orig(*a, **k)
        for c in calls:
            c.end += 1
        return calls
    monkeypatch.setattr(cnv_device, "window_scan", moved)


CNV_FAULTS = (_cnv_call_end_moved,)


@pytest.mark.parametrize("fault", [_half_of_the_reads, _tally_altered,
                                   _depth_lists_unchanged, *CNV_FAULTS],
                         ids=lambda f: f.__name__.strip("_"))
def test_fault_is_not_correct(capsys, monkeypatch, fault):
    fault(monkeypatch)
    res = run(capsys, monkeypatch)
    assert res["correct"] is False
    assert res["checks"]["rows_wrong"]["value"] > 0
    if fault in CNV_FAULTS:
        d = res["detail"]
        assert d["cnv_wrong"] + d["cnv_missing"] > 0


def test_control_is_not_correct():
    cell = tiny_cell()
    specs = harness.contig_specs(cell["config"], cell["traffic"], SEED)
    g = cell["config"]["grom"]
    ex = plainref.expect(specs, g)
    low = plainref.expect(specs, g, "lower", contigs=ex.contigs)
    wrong, d = plainref.judge(plainref.control_vcf(low), "", ex)
    assert wrong > harness.LIMITS["rows_wrong"]
    # its CNV rows alone, from float32 z-scores, null model and walk, fail
    assert d["cnv_wrong"] > 0 and d["cnv_missing"] > 0
    assert d["cnv_wrong"] == len([r for r in low.cnv_rows["chrtiny"]
                                  if r not in ex.cnv_rows["chrtiny"]])
    assert plainref.judge(plainref.control_vcf(ex), "", ex)[0] == 0
