"""The port's tile kernel (grom_tpu_torch/ops/accumulate.py) against
grom_tpu's ``tile_kernel_core`` under CPU jax, on the same inputs: every
output must be exactly equal (all integers; the f32 screen threshold is the
same f32 value on both sides). Also ``TorchAccumulator`` (the packed upload
and copy back, tile by tile) against grom_tpu's ``DeviceAccumulator``.

On the CPU the port's wrapper runs ``tile_kernel_plain``; the CUDA kernel
is held to the same plain version on the card (chip_smoke.py and the
``cuda``-marked tests below)."""

import os

import numpy as np
import pytest
import torch

from grom_tpu_torch.ops import accumulate as tacc
from grom_tpu_torch.ops.state import tile_from_args
from test_torch_slice import grom_tpu_native

DATA = os.path.join(os.path.dirname(__file__), "data")

# one intra-op thread: the suite runs in several worker processes at once,
# and torch's default of one thread per core would oversubscribe the host
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ds200k():
    """grom_tpu's decode of ds200k: its read-name ids need grom_tpu's
    native library in this process."""
    from grom_tpu.testing.fixtures import chrom_inputs
    grom_tpu_native()
    return chrom_inputs(os.path.join(DATA, "ds200k"))


def _jax_tile(args, statics):
    import functools

    import jax
    import jax.numpy as jnp

    from grom_tpu.ops.accumulate import tile_kernel_core
    fn = jax.jit(functools.partial(tile_kernel_core, **statics))
    bt, n_cand, n_mm, cand = fn(*(jnp.asarray(a) for a in args))
    return (np.asarray(bt), int(n_cand), int(n_mm),
            {k: np.asarray(v) for k, v in cand.items()})


def _assert_same(args, statics, device="cpu"):
    want_bt, want_nc, want_mm, want = _jax_tile(args, statics)
    tile, params = tile_from_args(args, statics, device)
    bt, n_mm, cand = tacc.tile_kernel(tile, **params)
    L = tile.chrom_up.shape[0]
    bt = bt.cpu().numpy()
    assert bt.dtype == np.int32
    assert np.array_equal(bt, want_bt[:L])
    assert not want_bt[L:].any()
    assert n_mm == want_mm
    K = int(cand["pos"].shape[0])
    assert K == want_nc
    for k in tacc.CAND_KEYS:
        got = cand[k].cpu().numpy()
        exp = want[k][..., :K]
        assert got.shape == exp.shape, k
        assert np.array_equal(got, exp), k
    return K, n_mm


@pytest.mark.parametrize("t0,t1", [(0, 65536), (70_000, 150_000),
                                   (150_000, None)])
def test_tile_kernel_matches_jax_ds200k(ds200k, t0, t1):
    """Leading, mid-chromosome and ragged last tiles of ds200k."""
    from __graft_entry__ import tile_args_from_fixture
    args, statics, n_ev = tile_args_from_fixture(ci=ds200k, t0=t0, t1=t1)
    assert n_ev > 0
    K, n_mm = _assert_same(args, statics)
    assert K > 0 and n_mm > 0      # the screen and the dedup really ran


def _pad_to(a, n, fill=0):
    out = np.full(n, fill, a.dtype)
    out[:len(a)] = a
    return out


def _synthetic_tile(seed=7, sort_spans=False):
    """A numpy tile built to stress the read-name dedup: 9 short names and
    2 long ones (>= 50 chars) pile mismatches on a few positions, with
    repeat occurrences of the same name, reverse-strand reads, IUPAC and N
    reference bytes and gate zeros. ``sort_spans``: the spans in
    ``SpanIndex`` order (by start, stable), as the CUDA kernel takes them."""
    TILE_L = tacc.TILE_L
    rng = np.random.default_rng(seed)
    L = 600
    ref = rng.choice(np.frombuffer(b"ACGT", np.uint8), L)
    ref[40:44] = np.frombuffer(b"RYNn", np.uint8)
    ref[300:310] = ord("N")
    up = np.where(ref >= 97, ref - 32, ref).astype(np.uint8)
    R = 90
    names = rng.integers(0, 11, R)              # 11 distinct names
    name_len = np.where(names >= 9, 60, 20).astype(np.uint8)
    lseq = np.full(R, 120, np.int32)
    seq_off = (np.arange(R) * 120).astype(np.int32)
    seq = np.empty(R * 120, np.uint8)
    qual = rng.integers(5, 40, R * 120).astype(np.uint8)
    spans = []
    hot = np.array([45, 46, 47, 200, 201])
    for r in range(R):
        start = int(rng.integers(-30, L - 60))
        ln = int(rng.integers(20, 100))
        s0 = max(start, 0)
        ln = min(ln, L - s0)
        off = int(rng.integers(0, 120 - ln))
        spans.append((r, s0, off, ln))
        read = ref[np.clip(s0 - off + np.arange(120), 0, L - 1)].copy()
        read[rng.random(120) < 0.02] = ord("N")
        # pile mismatches (lowercase too) on the hot positions
        for h in hot:
            j = h - s0 + off
            if 0 <= j < 120 and rng.random() < 0.8:
                read[j] = (ord("a") if rng.random() < 0.2 else ord("A")) \
                    if up[h] != ord("A") else ord("T")
        seq[r * 120:(r + 1) * 120] = read
    # a second span of the same read at a hot position repeats its name
    for r in range(0, R, 7):
        spans.append((r, 190, 5, 30))
    sp = np.array(spans, np.int64)
    if sort_spans:
        sp = sp[np.argsort(sp[:, 1], kind="stable")]
    S = len(sp)
    mapq = rng.choice(np.array([0, 10, 30, 60], np.uint8), R)
    flag = np.where(rng.random(R) < 0.5, 16, 0).astype(np.int32)
    elig = (rng.random(R) < 0.95).astype(np.uint8)
    gate = (rng.random(L) < 0.9).astype(np.uint8)
    gate[45:48] = 1
    s_cap, r_cap, q_cap = 1 << 12, 1 << 12, 1 << 16
    cum = np.zeros(s_cap + 1, np.int32)
    cum[1:S + 1] = np.cumsum(sp[:, 3])
    cum[S + 1:] = cum[S]
    args = (
        _pad_to(sp[:, 0].astype(np.int32), s_cap, R),
        _pad_to(sp[:, 1].astype(np.int32), s_cap, TILE_L),
        _pad_to(sp[:, 2].astype(np.int32), s_cap),
        cum,
        _pad_to(elig, r_cap + 1),
        _pad_to(mapq, r_cap + 1),
        _pad_to(flag, r_cap + 1),
        _pad_to(lseq, r_cap + 1),
        _pad_to(seq_off, r_cap + 1),
        _pad_to(seq, q_cap),
        _pad_to(qual, q_cap),
        _pad_to(names.astype(np.int32), r_cap + 1, -1),
        _pad_to(name_len, r_cap + 1),
        _pad_to(np.append(up, np.uint8(0)), TILE_L + 1),
        _pad_to(np.append(up == ord("N"), True), TILE_L + 1, True),
        _pad_to(gate, TILE_L),
        np.float32(0.2),
        np.int32(S),
    )
    statics = dict(min_mapq=20, min_bq=20, min_snv=3, name_len_cap=50,
                   e_cap=1 << 14, m_cap=1 << 12, k_cap=1 << 10)
    return args, statics


def _pow2(n):
    return 1 << max(int(n) - 1, 1).bit_length()


def _spike_args(mismatches):
    """``grom_tpu_torch.testing.tiles.spike_tile`` as a padded
    ``tile_kernel_core`` argument tuple and its statics."""
    from grom_tpu_torch.testing.tiles import PARAMS, spike_tile
    a, _ = spike_tile(0, mismatches)
    S, R, L = len(a["span_read"]), len(a["elig"]), len(a["chrom_up"])
    s_cap, r_cap, q_cap = _pow2(S + 1), _pow2(R + 1), _pow2(len(a["seq"]))
    cum = _pad_to(a["cum"].astype(np.int32), s_cap + 1, int(a["cum"][-1]))
    args = (
        _pad_to(a["span_read"].astype(np.int32), s_cap, R),
        _pad_to(a["span_ref"].astype(np.int32), s_cap, tacc.TILE_L),
        _pad_to(a["span_off"].astype(np.int32), s_cap),
        cum,
        _pad_to(a["elig"], r_cap + 1),
        _pad_to(a["mapq"], r_cap + 1),
        _pad_to(a["flag"], r_cap + 1),
        _pad_to(a["lseq"], r_cap + 1),
        _pad_to(a["seq_off"].astype(np.int32), r_cap + 1),
        _pad_to(a["seq"], q_cap),
        _pad_to(a["qual"], q_cap),
        _pad_to(a["name_id"], r_cap + 1, -1),
        _pad_to(a["name_len"], r_cap + 1),
        _pad_to(np.append(a["chrom_up"], np.uint8(0)), tacc.TILE_L + 1),
        _pad_to(np.append(a["is_n"], True), tacc.TILE_L + 1, True),
        _pad_to(a["gate"], tacc.TILE_L),
        np.float32(PARAMS["min_ratio"]),
        np.int32(S),
    )
    statics = dict(min_mapq=PARAMS["min_mapq"], min_bq=PARAMS["min_bq"],
                   min_snv=PARAMS["min_snv"],
                   name_len_cap=PARAMS["name_len_cap"],
                   e_cap=_pow2(int(a["cum"][-1]) + 1), m_cap=1 << 13,
                   k_cap=1 << 10)
    assert L < tacc.TILE_L
    return args, statics


@pytest.mark.parametrize("mismatches", [True, False])
def test_tile_kernel_spike_matches_jax(mismatches):
    """A coverage spike: thousands of high-quality mismatches at three
    positions from 40 names (more than the CUDA kernel's 512-base window
    keeps on chip, so it spills), piles over window edges, split reads;
    and the same reads with no mismatch at all."""
    K, n_mm = _assert_same(*_spike_args(mismatches))
    if mismatches:
        assert n_mm > 2000 and K >= 6
    else:
        assert n_mm == 0 and K == 0


def test_tile_kernel_sorted_synthetic_matches_jax():
    """The synthetic dedup tile with its spans in SpanIndex order (the
    input of the cuda-marked test)."""
    K, n_mm = _assert_same(*_synthetic_tile(sort_spans=True))
    assert K > 0 and n_mm > 20


@pytest.mark.parametrize("min_snv", [1, 3])
def test_tile_kernel_dedup_synthetic(min_snv):
    args, statics = _synthetic_tile()
    statics = dict(statics, min_snv=min_snv)
    K, n_mm = _assert_same(args, statics)
    assert K > 0 and n_mm > 20


def test_tile_kernel_rejects_other_devices():
    args, statics = _synthetic_tile()
    tile, params = tile_from_args(args, statics, "meta")
    with pytest.raises(ValueError):
        tacc.tile_kernel(tile, **params)


def test_torch_accumulator_matches_device_accumulator():
    """``TorchAccumulator(device="cpu")`` (one packed upload per tile, the
    packed result read back tile by tile) against grom_tpu's
    ``DeviceAccumulator`` on ds200k: whole, and over a position range with
    chunk-local gate and base_tot arrays."""
    from grom_tpu.ops.accumulate import DeviceAccumulator
    from grom_tpu_torch.testing.fixtures import chrom_inputs
    ci = chrom_inputs(os.path.join(DATA, "ds200k"))
    inputs = (ci.chrom, ci.batch, ci.eligible, ci.cfg, ci.gate)
    got = tacc.TorchAccumulator("cpu").run(*inputs)
    want = DeviceAccumulator().run(*inputs)
    lo, hi = 61_000, 133_000
    part = []
    for acc in (tacc.TorchAccumulator("cpu"), DeviceAccumulator()):
        bt = np.zeros(hi - lo, np.int64)
        res = acc.run(*inputs[:4], ci.gate[lo:hi], lo=lo, hi=hi,
                      base_tot_out=bt, gate_base=lo, base_tot_base=lo)
        assert res[0] is bt
        part.append(res)
    for g, w in (got, want), tuple(part):
        assert np.array_equal(g[0], w[0])
        assert g[1]["n"] == w[1]["n"] > 0
        for k in tacc.CAND_KEYS:
            assert np.array_equal(g[1][k], w[1][k]), k


def test_pack_result_round_trip():
    """The plain version's outputs through the packed result layout and
    back: what ``TorchAccumulator`` reads from a CUDA result."""
    args, statics = _synthetic_tile()
    tile, params = tile_from_args(args, statics, "cpu")
    bt, n_mm, cand = tacc.tile_kernel_plain(tile, **params)
    res = tacc.tile_launch(tile, **params)
    L = tile.chrom_up.shape[0]
    assert res.dtype == torch.int32
    assert tacc.read_header(res[:tacc.HDR]) == (n_mm, cand["pos"].numel())
    got_bt, got_mm, got = tacc.TorchAccumulator("cpu")._fetch(res, L)
    assert np.array_equal(got_bt, bt.numpy()) and got_mm == n_mm
    for k in tacc.CAND_KEYS:
        assert np.array_equal(got[k], cand[k].numpy()), k
    bad = res.clone()
    bad[tacc.H_ERR] = 1
    with pytest.raises(ValueError, match="sorted"):
        tacc.TorchAccumulator("cpu")._fetch(bad, L)


def test_fetch_owns_one_candidate_rows():
    """A result of exactly one candidate: its row is contiguous, and the
    candidate dict ``_fetch`` returns must still hold copies, not views of
    the result (on the card, the result buffer is reused by the next
    tile)."""
    args, statics = _synthetic_tile()
    tile, params = tile_from_args(args, statics, "cpu")
    bt, n_mm, cand = tacc.tile_kernel_plain(tile, **params)
    one = {k: v[..., 1:2] for k, v in cand.items()}
    res = tacc.pack_result(bt, n_mm, one)
    L = tile.chrom_up.shape[0]
    _, got_mm, got = tacc.TorchAccumulator("cpu")._fetch(res, L, 1000)
    assert got_mm == n_mm
    assert got["pos"].dtype == np.int64
    assert got["pos"].tolist() == [int(one["pos"][0]) + 1000]
    buf = res.numpy()
    for k in tacc.CAND_KEYS:
        if k != "pos":
            assert np.array_equal(got[k], one[k].numpy()), k
        assert got[k].flags.c_contiguous, k
        assert not np.shares_memory(got[k], buf), k


def _ds200k_inputs():
    from grom_tpu_torch.testing.fixtures import chrom_inputs
    ci = chrom_inputs(os.path.join(DATA, "ds200k"))
    return (ci.chrom, ci.batch, ci.eligible, ci.cfg, ci.gate)


# ds200k's first 2^15 bases in 2^11-base tiles: sparse tiles, among them
# one of exactly one candidate with more candidates in later tiles
SPARSE_TILE_L, SPARSE_HI = 1 << 11, 1 << 15


def _sparse_tiles_run(monkeypatch, device):
    monkeypatch.setattr(tacc, "TILE_L", SPARSE_TILE_L)
    inputs = _ds200k_inputs()
    return tacc.TorchAccumulator(device).run(*inputs, hi=SPARSE_HI)


def _assert_one_candidate_tile(cand):
    per_tile = np.bincount(cand["pos"] // SPARSE_TILE_L,
                           minlength=SPARSE_HI // SPARSE_TILE_L)
    one = np.nonzero(per_tile == 1)[0]
    assert len(one) and per_tile[one[0] + 1:].any(), per_tile


def test_torch_accumulator_sparse_tiles_match_device_accumulator(
        monkeypatch):
    """``TorchAccumulator(device="cpu")`` in small tiles, one of which
    yields a single candidate, against grom_tpu's ``DeviceAccumulator``
    over the same range."""
    from grom_tpu.ops.accumulate import DeviceAccumulator
    got = _sparse_tiles_run(monkeypatch, "cpu")
    _assert_one_candidate_tile(got[1])
    want = DeviceAccumulator().run(*_ds200k_inputs(), hi=SPARSE_HI)
    assert np.array_equal(got[0], want[0])
    assert got[1]["n"] == want[1]["n"]
    for k in tacc.CAND_KEYS:
        assert np.array_equal(got[1][k], want[1][k]), k


def test_torch_accumulator_one_upload_one_fetch_per_tile(monkeypatch):
    """Per tile, ``TorchAccumulator.run`` packs and uploads once, launches
    once and reads the result back once (ds200k in 2^16-base tiles)."""
    calls = {"pack_tile": 0, "tile_launch": 0, "_fetch": 0}

    def counted(owner, name):
        fn = getattr(owner, name)

        def f(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        monkeypatch.setattr(owner, name, f)
    counted(tacc, "pack_tile")
    counted(tacc, "tile_launch")
    counted(tacc.TorchAccumulator, "_fetch")
    monkeypatch.setattr(tacc, "TILE_L", 1 << 16)
    inputs = _ds200k_inputs()
    tacc.TorchAccumulator("cpu").run(*inputs)
    tiles = -(-len(inputs[0]) // (1 << 16))
    assert calls == {"pack_tile": tiles, "tile_launch": tiles,
                     "_fetch": tiles}


@pytest.mark.cuda
def test_torch_accumulator_cuda_syncs_once_per_tile(monkeypatch):
    """On the card, with torch's sync debug mode on: launching a tile
    makes no host sync, and ``TorchAccumulator.run`` makes one per tile
    (ds200k in 2^16-base tiles)."""
    import warnings
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args, statics = _synthetic_tile(sort_spans=True)
    tile, params = tile_from_args(args, statics, "cuda")
    torch.cuda.synchronize()
    monkeypatch.setattr(tacc, "TILE_L", 1 << 16)
    inputs = _ds200k_inputs()
    acc = tacc.TorchAccumulator("cuda")
    acc.run(*inputs)                           # first use: builds, pins
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tacc.tile_launch(tile, **params)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            acc.run(*inputs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # torch's one-time notice that the debug mode is a prototype is no sync
    syncs = [w for w in seen
             if "called a synchronizing CUDA operation" in str(w.message)]
    assert len(syncs) == -(-len(inputs[0]) // (1 << 16))


@pytest.mark.cuda
@pytest.mark.parametrize("min_snv", [1, 3])
def test_tile_kernel_cuda_matches_plain(min_snv):
    """On the card: the CUDA kernel equals the plain version exactly on
    the synthetic dedup tile (spans in SpanIndex order) and on the spike
    tiles (a window that spills its mismatch list; no mismatch at all)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tiles = [_synthetic_tile(sort_spans=True), _spike_args(True),
             _spike_args(False)]
    for args, statics in tiles:
        statics = dict(statics, min_snv=min_snv)
        tile, params = tile_from_args(args, statics, "cuda")
        bt, n_mm, cand = tacc.tile_kernel(tile, **params)
        torch.cuda.synchronize()
        tile_c, params_c = tile_from_args(args, statics, "cpu")
        bt_p, n_mm_p, cand_p = tacc.tile_kernel_plain(tile_c, **params_c)
        assert torch.equal(bt.cpu(), bt_p) and n_mm == n_mm_p
        for k in tacc.CAND_KEYS:
            assert torch.equal(cand[k].cpu(), cand_p[k]), k


@pytest.mark.cuda
def test_tile_kernel_cuda_rejects_unsorted_spans():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args, statics = _synthetic_tile()
    tile, params = tile_from_args(args, statics, "cuda")
    with pytest.raises(ValueError, match="sorted"):
        tacc.tile_kernel(tile, **params)


@pytest.mark.cuda
def test_torch_accumulator_cuda_matches_cpu():
    """On the card, ``TorchAccumulator`` on ds200k equals its CPU run; with
    a first copy back of one candidate row, every tile needs the second
    copy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    inputs = _ds200k_inputs()
    want = tacc.TorchAccumulator("cpu").run(*inputs)
    for guess in (tacc.K_GUESS, 1):
        acc = tacc.TorchAccumulator("cuda")
        acc._k_guess = guess
        got = acc.run(*inputs)
        assert np.array_equal(got[0], want[0])
        for k in tacc.CAND_KEYS:
            assert np.array_equal(got[1][k], want[1][k]), k


@pytest.mark.cuda
def test_torch_accumulator_cuda_one_candidate_tile(monkeypatch):
    """On the card, small tiles where one yields a single candidate and
    later tiles yield more (they reuse the pinned buffer of the copy back)
    equal the CPU run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    want = _sparse_tiles_run(monkeypatch, "cpu")
    _assert_one_candidate_tile(want[1])
    got = _sparse_tiles_run(monkeypatch, "cuda")
    assert np.array_equal(got[0], want[0])
    assert got[1]["n"] == want[1]["n"]
    for k in tacc.CAND_KEYS:
        assert np.array_equal(got[1][k], want[1][k]), k
