"""The port's tile kernel (grom_tpu_torch/ops/accumulate.py) against
grom_tpu's ``tile_kernel_core`` under CPU jax, on the same inputs: every
output must be exactly equal (all integers; the f32 screen threshold is the
same f32 value on both sides).

On the CPU the port's wrapper runs ``tile_kernel_plain``; the CUDA kernel
is held to the same plain version on the card (chip_smoke.py and the
``cuda``-marked test below)."""

import os

import numpy as np
import pytest
import torch

from grom_tpu_torch.ops import accumulate as tacc
from grom_tpu_torch.ops.state import tile_from_args

DATA = os.path.join(os.path.dirname(__file__), "data")

# one intra-op thread: the suite runs in several worker processes at once,
# and torch's default of one thread per core would oversubscribe the host
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ds200k():
    from grom_tpu.testing.fixtures import chrom_inputs
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


def _synthetic_tile(seed=7):
    """A numpy tile built to stress the read-name dedup: 9 short names and
    2 long ones (>= 50 chars) pile mismatches on a few positions, with
    repeat occurrences of the same name, reverse-strand reads, IUPAC and N
    reference bytes and gate zeros."""
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


@pytest.mark.cuda
@pytest.mark.parametrize("min_snv", [1, 3])
def test_tile_kernel_cuda_matches_plain(min_snv):
    """On the card: the CUDA kernel equals the plain version exactly on
    the synthetic dedup tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args, statics = _synthetic_tile()
    statics = dict(statics, min_snv=min_snv)
    tile, params = tile_from_args(args, statics, "cuda")
    bt, n_mm, cand = tacc.tile_kernel(tile, **params)
    torch.cuda.synchronize()
    tile_c, _ = tile_from_args(args, statics, "cpu")
    bt_p, n_mm_p, cand_p = tacc.tile_kernel_plain(tile_c, **params)
    assert torch.equal(bt.cpu(), bt_p) and n_mm == n_mm_p
    for k in tacc.CAND_KEYS:
        assert torch.equal(cand[k].cpu(), cand_p[k]), k
