"""Smoke run of grom_tpu_torch, the PyTorch + CUDA port, on one CUDA card.

    python3 chip_smoke.py

The phases run in this order; any failure raises and the script exits
non-zero without its result line:

1. the toolchain and the card (torch, CUDA, nvcc, triton, nvidia-smi);
2. build the CUDA kernels from grom_tpu_torch/csrc/ with nvcc for sm_90a;
3. every kernel against its plain PyTorch version on the inputs that
   runs of the cnvrich fixture hand it (the torch engine, then the mesh
   engine on a 2x2 grid whose four cells are all on the card): integers
   exactly, f64 bitwise against the plain version run on CPU copies;
4. the committed fixtures through ``python -m grom_tpu_torch`` on the torch
   engine: rows against the reference-binary oracles, files byte for byte
   against the port's own host engine (its native C / numpy engines);
4b. the same fixtures on the mesh engine, against the oracles and the host
   engine's files; then ds200k in process on a 2x2 grid of cells all on
   the card, at 60 kb ingest chunks, so the depth carry crosses cells,
   launches and chunks on the card;
5. real size: one 24 Mb chromosome at 30x (grom_tpu_torch.testing.bulk_sim,
   seed 5), host engine then torch engine, VCF and .ctx.vcf byte-identical;
   the launch counts of the torch run, its phases ``scan.device``,
   ``cnv.zscores_dev``, ``cnv.nullmodel_dev`` and ``call.sv_detect``, the
   host time of one ``SvScorer`` call on the largest SV window, every
   kernel's card time summed over the run
   (torch.profiler) beside the sum of its launches' bounds, the seed_eval
   launches by CUDA events and the card's busy time over the run; then
   every kernel of that path against its plain version, bitwise and timed
   beside it on the card, on the largest inputs that run handed it (a full
   2^18-base tile for the tile kernel), each pass of the tile kernel and
   the null model timed by CUDA events between its launches; and the
   adversarial inputs: a coverage-spike tile whose first window spills its
   mismatch list, a tile with no mismatch, the null model in batches of 64
   segments, the z-score cases of testing/zcases.py (short, empty and
   capped bin rows, keys past a row's largest value and from the clamp, a
   2.5 M-base desert without a class update, a first update at 1.7 M);
6. real size on the mesh engine: the same chromosome in a one-process NCCL
   group (its collectives are real NCCL calls on the card), on the 1x1
   grid of one card, byte-identical to phase 5's host output; the launch
   counts (the tile kernel and K6 at least once per cell, K5 at least once
   per ``MeshAccumulator.run``), its ``scan.device`` in parts (the
   ``mesh.*`` labels), its ``cnv.zscores_dev``, ``cnv.nullmodel_dev`` and
   ``call.sv_detect``, and summed card times of that run; then the depth
   and SV kernels against their plain versions, bitwise and timed, and the
   depth kernels bitwise on the edge batch (testing/spans.py) run whole
   and chunked by the mesh engine on the card, equal to the CPU run;
7. ``-P`` on the card: a two-chromosome genome at 30x (24 Mb and 20 Mb,
   grom_tpu's human-like proportions, testing/bulk_sim.py ``bulk_genome``)
   through the CLI's ``run_parallel`` with two workers, on the host engine
   and then on the default engine (both workers on the card), VCF and
   .ctx.vcf byte-identical; each job's worker, card, peak card memory,
   host memory, wall and CPU seconds; the launches summed over the
   workers (every kernel of the torch path, a tile launch at least per
   2^18 bases of each chromosome); then ``-P 2 -R 1`` on a 2.6 Mb
   chromosome at 30x (three region jobs), card against host;
8. the default geometry of a human chromosome (16 Mi ingest chunks, 4 Mi
   detect sub-chunks, which a chromosome gets from 134,217,728 bases on)
   on phase 5's 24 Mb dataset: ``python -m grom_tpu_torch`` on the torch
   and mesh engines in fresh processes with GROM_TPU_CHUNK_BASES and
   GROM_TPU_DETECT_BASES set (two ingest chunks, the first cut into four
   sub-chunks), VCF and .ctx.vcf byte-identical to phase 5's host output;
   each run's launches (every kernel of its path), its ``peak_memory``
   line (peak host RSS with its label, peak card memory) and, on the mesh
   engine, K5's largest run (spans and cells).

Output: per-phase lines, the card's name and power limit, one JSON line
with the kernel table (each kernel's time beside its bound: the larger of
the bytes it must move over the card's memory rate and its operations
over the peak rate of their type, counted from this run's inputs; and the
time of one PyTorch call for the same work where one exists), and as
the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Everything it writes goes under build/; it imports nothing of jax or of
grom_tpu.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "build", "chip_smoke")
DATA = os.path.join(REPO, "tests", "data")

# name -> (source of the kernel, the grom_tpu device function it replaces)
KERNELS = {
    "tile_accumulate": ("grom_tpu_torch/csrc/tile_accumulate.cu",
                        "grom_tpu/ops/accumulate.py:63"),
    "zscores": ("grom_tpu_torch/csrc/cnv.cu",
                "grom_tpu/ops/cnv_device.py:63"),
    "seed_eval": ("grom_tpu_torch/csrc/cnv.cu",
                  "grom_tpu/ops/cnv_device.py:154"),
    "null_model": ("grom_tpu_torch/csrc/cnv.cu",
                   "grom_tpu/ops/cnv_device.py:371"),
    "rd_scatter": ("grom_tpu_torch/csrc/rd_depth.cu",
                   "grom_tpu/parallel/pipeline.py:54"),
    "rd_scan": ("grom_tpu_torch/csrc/rd_depth.cu",
                "grom_tpu/parallel/pipeline.py:54"),
    "sv_score": ("grom_tpu_torch/csrc/sv_score.cu",
                 "grom_tpu/ops/sv_device.py:31"),
}
# name -> the CUDA functions (csrc/) of its launches, for card-time sums
KERNEL_FUNCS = {
    "tile_accumulate": ("tile_window", "tile_compact"),
    "zscores": ("zs_table", "zs_onepass"),
    "seed_eval": ("seed_eval_tier1", "seed_eval_tier2"),
    "null_model": ("null_prefix", "null_carry", "null_accum"),
    "rd_scatter": ("rd_scatter_kernel",),
    "rd_scan": ("rd_scan_kernel",),
    "sv_score": ("sv_score_kernel",),
}
# the kernels each engine's main path launches
TORCH_PATH = ("tile_accumulate", "zscores", "seed_eval", "null_model",
              "sv_score")
MESH_ONLY = ("rd_scatter", "rd_scan")
# kernels whose wrappers write into buffers the caller reuses: the Recorder
# keeps a copy of the arguments of their heaviest call, taken before it
SNAPSHOT = MESH_ONLY

# (fixture, extra flags, oracle tag); cnvmany is generated, not committed
FIXTURES = [
    ("ds200k", [], ""),
    ("dup60k", ["-M"], ""),
    ("sv400k", [], ""),
    ("ctx2x60k", [], ""),
    ("cnvrich", ["-V", "0.0001"], ""),
    ("cnvrich", ["-V", "0.0001", "-K", "0"], ".k0"),
    ("cnvrich", ["-V", "0.0001", "-g", "1"], ".male"),
    ("cnvmany", ["-V", "0.0001"], ""),
]
# fixtures whose .ctx.vcf oracle the host engine is held to
CTX_ORACLES = ("ds200k", "ctx2x60k")

# the card's published peaks (NVIDIA H100 SXM data sheet, at 700 W): HBM3
# bandwidth, FP64 and FP32 outside the tensor cores (int32 is no faster
# than FP32 there)
HBM_BYTES_S = 3.35e12
F64_OPS_S = 34e12
F32_OPS_S = 67e12

BULK = dict(length=24_000_000, coverage=30.0, seed=5, snp_rate=1e-3,
            hotspots=[(6_000_000, 6_020_000, 20.0)],
            depressions=[(14_000_000, 14_040_000, 0.4)],
            repeats=[(20_000_000, 20_010_000, b"AT")])

# phase 7: the -P genome, two chromosomes at 30x in grom_tpu's human-like
# proportions (tools/wgs_bench.py CHROM_FRACS, 240:200), fixed seeds,
# and BULK's planted features (a hotspot, a depression, an AT repeat)
GENOME = [dict(name="chrp1", length=24_000_000, coverage=30.0, seed=71,
               hotspots=BULK["hotspots"], depressions=BULK["depressions"],
               repeats=BULK["repeats"]),
          dict(name="chrp2", length=20_000_000, coverage=30.0, seed=72,
               hotspots=[(9_000_000, 9_020_000, 20.0)],
               depressions=[(15_000_000, 15_040_000, 0.4)])]
# and the -R chromosome: three region jobs. -X 1000: outside its region a
# job's depth is zero and the CNV scan steps every such position up to the
# longest window (tests/test_torch_parallel.py)
SPLIT = dict(length=2_600_000, coverage=30.0, seed=73)
SPLIT_FLAGS = ["-R", "1", "-X", "1000"]
# phase 8: the ingest chunk and detect sub-chunk of a chromosome of
# 134,217,728 bases or more (driver.py _auto_chunk_bases, DETECT_BASES)
WIDE = {"GROM_TPU_CHUNK_BASES": str(16 << 20),
        "GROM_TPU_DETECT_BASES": str(4 << 20)}


def say(*a) -> None:
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def engine(name: str):
    """GROM_TPU_TORCH_ENGINE set to ``name`` for an in-process run."""
    old = os.environ.get("GROM_TPU_TORCH_ENGINE")
    os.environ["GROM_TPU_TORCH_ENGINE"] = name
    try:
        yield
    finally:
        if old is None:
            del os.environ["GROM_TPU_TORCH_ENGINE"]
        else:
            os.environ["GROM_TPU_TORCH_ENGINE"] = old


def run_cli(argv, engine_name: str) -> float:
    """One in-process run of the port's CLI; returns its wall seconds."""
    import torch

    from grom_tpu_torch import cli
    t0 = time.perf_counter()
    with engine(engine_name):
        rc = cli.main(list(argv))
    torch.cuda.synchronize()
    if rc != 0:
        raise RuntimeError("grom_tpu_torch %s exited %d" % (argv, rc))
    return time.perf_counter() - t0


def run_on_grid(argv, shape=(2, 2)) -> float:
    """One in-process run of the port's driver on the mesh engine over a
    grid of ``shape`` cells, all on cuda:0; returns its wall seconds."""
    import torch

    from grom_tpu_torch.cli import parse_args
    from grom_tpu_torch.driver import run
    from grom_tpu_torch.parallel.mesh import make_mesh
    cfg = parse_args(list(argv))
    mesh = make_mesh(*shape, devices=["cuda:0"] * (shape[0] * shape[1]))
    t0 = time.perf_counter()
    run(cfg, engine="mesh", device="cuda", mesh=mesh)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def run_module(argv, engine_name: str) -> float:
    """One run of ``python -m grom_tpu_torch`` in a child process."""
    env = dict(os.environ, GROM_TPU_TORCH_ENGINE=engine_name)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "grom_tpu_torch", *argv],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=600)
    if r.returncode != 0:
        raise RuntimeError("python -m grom_tpu_torch %s exited %d:\n%s"
                           % (argv, r.returncode, r.stderr[-4000:]))
    return time.perf_counter() - t0


def run_parallel_cli(argv, engine_name: str):
    """One in-process ``-P`` run of the port's CLI (its ``parse_args`` and
    ``run_parallel``, as ``main`` calls them); returns (wall seconds, the
    jobs' reports)."""
    from grom_tpu_torch.cli import parse_args, run_parallel
    cfg = parse_args(list(argv))
    if cfg is None or cfg.processes < 2:
        raise ValueError("not a -P run: %s" % (argv,))
    t0 = time.perf_counter()
    with engine(engine_name):
        reps = run_parallel(cfg)
    return time.perf_counter() - t0, reps


def ctx_path(vcf: str) -> str:
    return vcf[:-4] + ".ctx.vcf"


def body(path: str, drop=("##fileDate",)) -> bytes:
    """The file's bytes without the header lines in ``drop`` (the run
    date; ``##reference`` carries the FASTA path)."""
    with open(path, "rb") as f:
        return b"".join(ln for ln in f
                        if not ln.startswith(tuple(d.encode() for d in drop)))


def same_files(a_vcf: str, b_vcf: str) -> None:
    for a, b in ((a_vcf, b_vcf), (ctx_path(a_vcf), ctx_path(b_vcf))):
        if body(a) != body(b):
            raise AssertionError("%s and %s differ" % (a, b))


def _rows(path):
    """The records of a VCF (tests/test_full_parity.py ``_rows``)."""
    with open(path) as f:
        return [ln.rstrip("\n") for ln in f if not ln.startswith("#")]


def _rows_equal(a, b) -> bool:
    """tests/test_full_parity.py ``_rows_equal``: equal, or a CNV row whose
    SD and Z differ by at most 1e-4 relative (the reference's pval2sd
    bisection depends on its libc's last-ulp pow())."""
    if a == b:
        return True
    ta, tb = a.split("\t"), b.split("\t")
    if len(ta) != len(tb) or ta[:9] != tb[:9]:
        return False
    if not ta[8].startswith("SD:Z:CN"):
        return False
    fa, fb = ta[9].split(":"), tb[9].split(":")
    if len(fa) != 4 or len(fb) != 4:
        return False
    for i in (0, 1):
        va, vb = float(fa[i]), float(fb[i])
        if abs(va - vb) > 1e-4 * max(abs(vb), 1e-300):
            return False
    return fa[2] == fb[2] and fa[3] == fb[3]


def rows_match_oracle(got_vcf: str, oracle_vcf: str) -> int:
    got, want = _rows(got_vcf), _rows(oracle_vcf)
    if len(got) != len(want):
        raise AssertionError("%s: %d rows, oracle %d"
                             % (got_vcf, len(got), len(want)))
    for a, b in zip(got, want):
        if not _rows_equal(a, b):
            raise AssertionError("%s: row %r, oracle %r" % (got_vcf, a, b))
    return len(got)


def count_rows(vcf: str):
    rows = _rows(vcf)
    cnv = sum(1 for r in rows if "SD:Z:CN" in r)
    snv = sum(1 for r in rows if r.split("\t")[4] in ("A", "C", "G", "T"))
    return len(rows), snv, cnv


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------

def _targets():
    """name -> (module, the wrapper the main path calls, the wrapper held
    to the plain version, the plain version). The tile path calls
    ``tile_launch`` (packed result, no wait); ``tile_kernel`` is the same
    launch, unpacked."""
    from grom_tpu_torch.ops import accumulate, cnv_device, rd_depth, sv_device
    return {"tile_accumulate": (accumulate, "tile_launch", "tile_kernel",
                                accumulate.tile_kernel_plain),
            "zscores": (cnv_device, "zscores", "zscores",
                        cnv_device.zscores_plain),
            "seed_eval": (cnv_device, "seed_eval", "seed_eval",
                          cnv_device.seed_eval_plain),
            "null_model": (cnv_device, "null_model", "null_model",
                           cnv_device.null_model_plain),
            "rd_scatter": (rd_depth, "rd_scatter", "rd_scatter",
                           rd_depth.rd_scatter_plain),
            "rd_scan": (rd_depth, "rd_scan", "rd_scan",
                        rd_depth.rd_scan_plain),
            "sv_score": (sv_device, "sv_score", "sv_score",
                         sv_device.score_sv_entries_plain)}


class Recorder:
    """While a run of the port is inside it, keeps for every kernel
    wrapper the arguments of its heaviest call (the most aligned bases of
    a full-width tile, the longest z block, the most window steps, the
    most null segments, the most spans and cells of a depth-list group,
    the widest cell, the most SV entries), so the kernel can then be held
    to its plain version at the shapes the main path gave it; and the bound
    of every call (``bound_sum``), summed per kernel. The arguments of the
    ``SNAPSHOT`` kernels are copied before the call, since the run reuses
    their buffers."""

    def __init__(self):
        self.best = {}
        self.bound_sum = {}
        self._saved = {}
        self._later = []         # seed_eval calls: bound read after the run

    @staticmethod
    def _heavier(name, w, best) -> bool:
        """Whether a call of weight ``w`` replaces the kept one: K6 keeps
        the latest of its heaviest calls (a full cell late in a run, so
        its carry from earlier launches is not zero), the others the
        first."""
        return w >= best if name == "rd_scan" else w > best

    @staticmethod
    def _weight(name, args, out):
        if name == "tile_accumulate":
            t = args[0]
            return (int(t.chrom_up.shape[0]), t.n_events)
        if name == "zscores":
            return (int(args[0].depth.shape[0]),)
        if name == "seed_eval":
            return (int(out[0].sum()), int(args[1].shape[0]))   # f1
        if name == "null_model":
            return (len(args[2].s),)
        if name == "rd_scatter":
            return (int(args[0].ref.shape[0]), int(args[9].shape[0]))
        if name == "rd_scan":
            return (int(args[0].shape[1]), int(args[5]))
        return (int(args[0].shape[1]),)      # sv_score: entries [9, n]

    def __enter__(self):
        for name, (mod, attr, _, _) in _targets().items():
            fn = getattr(mod, attr)
            self._saved[name] = (mod, attr, fn)

            def wrap(*a, _n=name, _f=fn):
                kept = a
                if _n in SNAPSHOT and (_n not in self.best or self._heavier(
                        _n, self._weight(_n, a, None), self.best[_n][0])):
                    kept = _clone(a)
                out = _f(*a)
                if _n == "seed_eval":
                    self._later.append((a, out))
                else:
                    self._add(_n, kept, out)
                return out
            setattr(mod, attr, wrap)
        return self

    def _add(self, name, a, out):
        w = self._weight(name, a, out)
        if name not in self.best or self._heavier(name, w,
                                                  self.best[name][0]):
            self.best[name] = (w, a)
        self.bound_sum[name] = (self.bound_sum.get(name, 0.0)
                                + bound(name, a, out)[0])

    def __exit__(self, *exc):
        for mod, attr, fn in self._saved.values():
            setattr(mod, attr, fn)
        for a, out in self._later:
            self._add("seed_eval", a, out)
        self._later = []


class LaunchTimer:
    """While a run is inside it, CUDA events on the current stream around
    every call of the kernel wrapper ``mod.attr``."""

    def __init__(self, mod, attr):
        self.mod, self.attr, self.events = mod, attr, []

    def __enter__(self):
        import torch
        self.fn = fn = getattr(self.mod, self.attr)

        def wrap(*a):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = fn(*a)
            ev[1].record()
            self.events.append(ev)
            return out
        setattr(self.mod, self.attr, wrap)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.attr, self.fn)

    def total_ms(self) -> float:
        import torch
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events)


@contextlib.contextmanager
def card_profile():
    """torch.profiler over the card's activity only (kernels, copies)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield prof


def device_times(prof) -> dict:
    """Card time of a profiled window: ms per kernel name, and the ms of
    copies and memsets."""
    kernels, other = {}, 0.0
    for e in prof.key_averages():
        us = e.self_device_time_total
        if us <= 0:
            continue
        if e.key.startswith(("Memcpy", "Memset")):
            other += us / 1e3
        else:
            kernels[e.key] = kernels.get(e.key, 0.0) + us / 1e3
    return {"kernels": kernels, "kernel_ms": sum(kernels.values()),
            "other_ms": other}


def kernel_card_ms(card: dict, name: str) -> float:
    """Summed card ms of the CUDA functions of kernel ``name`` in a
    ``device_times`` result."""
    funcs = KERNEL_FUNCS[name]
    return sum(ms for key, ms in card["kernels"].items()
               if re.search(r"\b(%s)\b" % "|".join(funcs), key))


def report_run_sums(card: dict, rec: Recorder, launches: dict, names,
                    label: str) -> dict:
    """Per kernel of a run: card time summed over its launches against
    the sum of those launches' bounds; returns name -> (card ms, bound
    ms)."""
    out = {}
    for k in names:
        ms = kernel_card_ms(card, k)
        b = rec.bound_sum.get(k, 0.0)
        out[k] = (ms, b)
        say("%s %-15s %4d launches: card time %.3f ms (torch.profiler), "
            "launches x bound %.4f ms, loss %.3f ms"
            % (label, k, launches.get(k, 0), ms, b, ms - b))
    return out


def _nbytes(x) -> int:
    """Bytes of every tensor and array in ``x`` (also inside tuples,
    lists and dicts)."""
    import numpy as np
    import torch
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, np.ndarray):
        return x.nbytes
    if isinstance(x, dict):
        return sum(_nbytes(v) for v in x.values())
    if isinstance(x, (tuple, list)):
        return sum(_nbytes(v) for v in x)
    return 0


def _covered(starts, ends) -> int:
    """Positions in the union of the intervals [starts, ends)."""
    import numpy as np
    o = np.argsort(starts, kind="stable")
    s, e = np.asarray(starts)[o], np.asarray(ends)[o]
    prev = np.concatenate([[np.iinfo(np.int64).min],
                           np.maximum.accumulate(e)[:-1]])
    return int(np.maximum(e - np.maximum(s, prev), 0).sum())


def bound(name, args, out):
    """(bound ms, "bytes" or "operations", bytes, operations) of one call:
    each input byte the function needs read once and each output byte
    written once, over the card's memory rate, against the operations
    this call's data needs over the peak rate of their type."""
    import numpy as np
    if name == "tile_accumulate":
        t = args[0]
        ev = t.n_events
        L = int(t.chrom_up.shape[0])
        # per aligned base: its read base and quality byte, and the tallies
        # it adds to (class channel, bq, bq_all, mq, mq_all, n_hi, rc_all);
        # out: base_tot and the candidates (unpacked), or the packed
        # result's header and base_tot (its row count is on the card, and
        # reading it would add a sync to the timed run)
        from grom_tpu_torch.ops.accumulate import result_len
        nb = (_nbytes([v for k, v in t._asdict().items()
                       if k not in ("seq", "qual")]) + 2 * ev
              + (_nbytes(out) if isinstance(out, tuple)
                 else 4 * result_len(L, 0)))
        ops, rate = 8 * ev, F32_OPS_S
    elif name == "zscores":
        # the per-base inputs (depth, mq, gc, low_acgt: 8 bytes a base; the
        # mapq weight is computed, not read), z and the tables
        n = int(args[0].depth.shape[0])
        nb = _nbytes(args[0]) + _nbytes(out) + _nbytes(args[1])
        ops, rate = 6 * n, F64_OPS_S
    elif name == "seed_eval":
        si, seeds, _, minw = args[:4]
        f1, n = out[0].cpu().numpy(), out[4].cpu().numpy()   # packed rows
        seeds = seeds.cpu().numpy()
        L = int(si.svals.shape[0])
        steps = np.minimum(f1 + 1, n)
        run = np.minimum(f1, n)
        # svals (f64) and one byte of flags per position a window reaches,
        # the seeds and their classes, five outputs, win_std
        nb = (9 * _covered(seeds, np.minimum(seeds + steps, L))
              + 9 * len(seeds) + 33 * len(seeds) + 8 * (int(steps.max()) + 1))
        # one add per step of the running total; per grow step the
        # count x stdev product and the score division
        ops = int(run.sum()) + 2 * int(np.maximum(run - minw, 0).sum())
        rate = F64_OPS_S
    elif name == "null_model":
        z, gate, seg = args[:3]
        L = int(z.shape[0])
        ends = np.minimum(seg.s + seg.n, L)
        # per position of a segment: its prefix add (z and count), then per
        # window length the carried add, the mean's division, its square
        # and the sum's add
        nb = 9 * _covered(seg.s, ends) + _nbytes(list(seg)) + _nbytes(out)
        ops, rate = 6 * int(seg.n.sum()), F64_OPS_S
    elif name == "rd_scatter":
        # in: the spans and reads, the slot map; out: the rows, totals and
        # chunk sums of the group; per span two endpoints of three adds
        nb = _nbytes(args[:2]) + _nbytes(args[9:12])
        ops, rate = 6 * int(args[0].ref.shape[0]), F32_OPS_S
    elif name == "rd_scan":
        # in: the cell's rows (its chunk sums, the launch's totals and the
        # carry: a few hundred bytes); out: rd and the histogram
        nb = _nbytes(args[:3]) + _nbytes(args[4]) + _nbytes(args[6:])
        ops, rate = 3 * int(args[0].shape[1]) + int(args[5]), F32_OPS_S
    else:   # sv_score
        n = int(args[0].shape[1])
        tables = args[1]
        # the packed entries and scores, two table entries gathered per
        # entry, the etype index tables; about ten f64 operations per entry
        nb = (_nbytes(args[0]) + _nbytes(out) + 16 * n
              + _nbytes([tables.kind, tables.rev]))
        ops, rate = 10 * n, F64_OPS_S
    t_bytes, t_ops = nb / HBM_BYTES_S, ops / rate
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", nb, ops)



def _to(x, device):
    """``x`` with every tensor in it (also inside tuples) on ``device``."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, tuple):
        vals = [_to(v, device) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    return x


def _clone(x):
    """``x`` with every tensor in it (also inside tuples) copied."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple):
        vals = [_clone(v) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    return x


def _flat(out):
    """Every output of a kernel as a list of numpy arrays."""
    import numpy as np
    import torch
    if isinstance(out, torch.Tensor):
        return [out.detach().cpu().numpy()]
    if isinstance(out, np.ndarray):
        return [out]
    if isinstance(out, dict):
        return [a for k in sorted(out) for a in _flat(out[k])]
    if isinstance(out, (tuple, list)):
        return [a for v in out for a in _flat(v)]
    return [np.asarray(out)]


def _diff(got, want, exact: bool):
    """(max abs difference, max relative difference) over all outputs;
    with ``exact`` raises unless every output is equal bit for bit."""
    import numpy as np
    g, w = _flat(got), _flat(want)
    if len(g) != len(w):
        raise AssertionError("output count %d != %d" % (len(g), len(w)))
    mabs = mrel = 0.0
    for i, (a, b) in enumerate(zip(g, w)):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError("output %d: %s %s != %s %s"
                                 % (i, a.shape, a.dtype, b.shape, b.dtype))
        if a.dtype.kind == "f":
            bits = np.uint64 if a.itemsize == 8 else np.uint32
            neq = a.view(bits) != b.view(bits)
        else:
            neq = a != b
        same = not neq.any()
        if exact and not same:
            raise AssertionError(
                "output %d differs from the plain version at %d of %d "
                "entries (first at %s)" % (i, int(neq.sum()), neq.size,
                                           np.argwhere(neq)[0].tolist()))
        if a.size and not same:
            d = np.abs(a.astype(np.float64) - b.astype(np.float64))
            mabs = max(mabs, float(np.nanmax(d)))
            r = d / np.maximum(np.abs(b.astype(np.float64)), 1e-300)
            mrel = max(mrel, float(np.nanmax(r)))
    return mabs, mrel


def _ms(fn) -> float:
    """Mean milliseconds of one call (wrapper included: uploads of its
    small host tables and its host syncs), timed with CUDA events after a
    warm-up call, over as many calls as fit in about one second."""
    import torch
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    reps = max(1, min(20, int(1.0 / max(time.perf_counter() - t0, 1e-4))))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# kernel -> the plain version's output on CPU copies of the last inputs
# check_kernels held the kernel to
PLAIN_ON_CPU = {}


def check_kernels(rec: Recorder, label: str, timed: bool,
                  names=tuple(KERNELS)) -> dict:
    """Each recorded call of the kernels ``names`` against its plain
    version: bitwise against the plain version on CPU copies; with
    ``timed``, also beside the plain version run on the card. Both
    versions start from copies of the recorded arguments (some wrappers
    write into buffers they are given)."""
    import torch
    results = {}
    for name, (mod, _, attr, plain) in _targets().items():
        if name not in names:
            continue
        if name not in rec.best:
            raise AssertionError("%s: the run never called %s"
                                 % (label, name))
        weight, args = rec.best[name]
        kernel = getattr(mod, attr)
        cpu_args = _to(args, "cpu")
        got = kernel(*_clone(args))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = PLAIN_ON_CPU[name] = plain(*cpu_args)
        cpu_s = time.perf_counter() - t0
        err, _ = _diff(got, want, exact=True)
        b_ms, b_by, b_bytes, b_ops = bound(name, args, got)
        row = {"max_abs_err": err, "shape": list(weight), "bound_ms": b_ms,
               "bound_by": b_by}
        msg = ("%s %s %s: equal to the plain version on CPU copies "
               "(plain on CPU %.3f s)" % (label, name, weight, cpu_s))
        if timed:
            on_card = plain(*_clone(args))
            torch.cuda.synchronize()
            _, rel = _diff(got, on_card, exact=False)
            row["ms"] = _ms(lambda: kernel(*args))
            row["plain_ms"] = _ms(lambda: plain(*args))
            with card_profile() as prof:
                kernel(*args)
                torch.cuda.synchronize()
            parts = {}
            for key, ms in device_times(prof)["kernels"].items():
                m = re.search(r"(\w+)\(", key)
                k = m.group(1) if m else key
                parts[k] = parts.get(k, 0.0) + ms
            row["rel_vs_plain_on_card"] = rel
            msg += ("; max rel diff to plain on card %.3g; kernel %.3f ms, "
                    "plain on card %.3f ms; bound %.4f ms by %s (%d bytes, "
                    "%d operations), kernel at %.2f%% of it"
                    % (rel, row["ms"], row["plain_ms"], b_ms, b_by, b_bytes,
                       b_ops, 100.0 * b_ms / row["ms"]))
            msg += "; one call's kernels (torch.profiler): %s" % ", ".join(
                "%s %.4f ms" % kv for kv in sorted(parts.items()))
        say(msg)
        results[name] = row
    return results


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_toolchain() -> str:
    import torch

    from grom_tpu_torch import _build
    say("== 1. toolchain and card")
    say("python", sys.version.split()[0], "torch", torch.__version__,
        "cuda", torch.version.cuda)
    nvcc = _build.nvcc()
    r = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                       timeout=60, check=True)
    say("nvcc", nvcc, "|", r.stdout.strip().splitlines()[-1])
    try:
        import triton
        say("triton", triton.__version__)
    except ImportError:
        say("triton: not importable")
    from grom_tpu_torch.native import get_lib
    lib = get_lib()
    if lib is None:
        raise RuntimeError("the port's native library (native/*.c, cc) did "
                           "not build: the host engines would run their "
                           "pure-Python fallbacks")
    path = os.path.relpath(lib._name, REPO)
    if not path.startswith(os.path.join("build", "grom_tpu_torch", "")):
        raise AssertionError("native library loaded from %s" % path)
    say("native library (native/*.c):", path)
    smi = nvidia_smi_line()
    say("card", smi, "| torch sees", torch.cuda.device_count(), "x",
        torch.cuda.get_device_name(0))
    return smi


def phase_build() -> None:
    """One nvcc per kernel source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from grom_tpu_torch import _build
    say("== 2. build")

    def one(name):
        t0 = time.perf_counter()
        fresh = not os.path.exists(_build.library_path(name))
        path = _build.build(name)
        return path, fresh, time.perf_counter() - t0

    with ThreadPoolExecutor(len(_build.LIBRARIES)) as pool:
        built = list(pool.map(one, _build.LIBRARIES))
    for name, (path, fresh, dt) in zip(_build.LIBRARIES, built):
        _build.library(name)
        say("%s.cu -> %s (%s, %.1f s)" % (name, os.path.relpath(path, REPO),
                                         "built" if fresh else "cached", dt))


def phase_cnvrich_kernels() -> None:
    say("== 3. kernels against their plain versions (cnvrich inputs; "
        "tolerance: integers exact, f64 bitwise)")
    d = os.path.join(DATA, "cnvrich")
    args = ["-i", os.path.join(d, "ds.bam"), "-r", os.path.join(d, "ds.fa"),
            "-V", "0.0001"]
    with Recorder() as rec:
        run_cli(args + ["-o", os.path.join(OUT, "k_cnvrich.vcf")], "torch")
        run_on_grid(args + ["-o", os.path.join(OUT, "k_cnvrich_grid.vcf")])
    check_kernels(rec, "cnvrich", timed=False)


def fixture_run(fx: str, flags, tag: str):
    """(argv without -o, output stem) of one FIXTURES row; builds cnvmany
    under build/ at first use."""
    if fx == "cnvmany":
        from grom_tpu_torch.testing import cnvmany
        prefix = os.path.join(OUT, "cnvmany", "ds")
        if not os.path.exists(prefix + ".bam.bai"):
            os.makedirs(os.path.dirname(prefix), exist_ok=True)
            cnvmany.build(prefix)
        fa, bam = prefix + ".fa", prefix + ".bam"
    else:
        d = os.path.join(DATA, fx)
        fa, bam = os.path.join(d, "ds.fa"), os.path.join(d, "ds.bam")
    stem = os.path.join(OUT, "%s%s" % (fx, tag or ".default"))
    return ["-i", bam, "-r", fa] + list(flags), stem


def check_fixture(vcf: str, fx: str, tag: str) -> str:
    """Rows of ``vcf`` against the oracle (and its .ctx.vcf where the
    fixture has one); returns a summary."""
    n = rows_match_oracle(vcf, os.path.join(DATA, fx, "oracle%s.vcf" % tag))
    if fx in CTX_ORACLES:
        drop = ("##fileDate", "##reference")
        if body(ctx_path(vcf), drop) != body(
                os.path.join(DATA, fx, "oracle.ctx.vcf"), drop):
            raise AssertionError("%s: .ctx.vcf differs from the oracle" % fx)
    _, snv, cnv = count_rows(vcf)
    return "%4d rows (%d SNV, %d CNV)" % (n, snv, cnv)


def phase_fixtures() -> None:
    say("== 4. fixtures, torch engine vs oracle and host engine")
    for fx, flags, tag in FIXTURES:
        args, stem = fixture_run(fx, flags, tag)
        t_dev = run_module(args + ["-o", stem + ".torch.vcf"], "torch")
        t_host = run_cli(args + ["-o", stem + ".host.vcf"], "host")
        same_files(stem + ".torch.vcf", stem + ".host.vcf")
        summary = check_fixture(stem + ".torch.vcf", fx, tag)
        say("%-8s %-22s %s = oracle = host engine; torch process %.1f s, "
            "host in-process %.1f s"
            % (fx, " ".join(flags) or "-", summary, t_dev, t_host))


def phase_fixtures_mesh() -> None:
    from grom_tpu_torch import _build
    say("== 4b. fixtures, mesh engine vs oracle and host engine")
    for fx, flags, tag in FIXTURES:
        args, stem = fixture_run(fx, flags, tag)
        t_dev = run_module(args + ["-o", stem + ".mesh.vcf"], "mesh")
        same_files(stem + ".mesh.vcf", stem + ".host.vcf")
        summary = check_fixture(stem + ".mesh.vcf", fx, tag)
        say("%-8s %-22s %s = oracle = host engine; mesh process %.1f s"
            % (fx, " ".join(flags) or "-", summary, t_dev))
    # ds200k on a 2x2 grid of cells on one card, in 60 kb ingest chunks
    args, stem = fixture_run("ds200k", [], "")
    os.environ["GROM_TPU_CHUNK_BASES"] = "60000"
    try:
        _build.reset_launches()
        t_grid = run_on_grid(args + ["-o", stem + ".grid.vcf"])
        launches = dict(_build.LAUNCHES)
    finally:
        del os.environ["GROM_TPU_CHUNK_BASES"]
    same_files(stem + ".grid.vcf", stem + ".host.vcf")
    summary = check_fixture(stem + ".grid.vcf", "ds200k", "")
    for k in KERNELS:
        if launches[k] <= 0:
            raise AssertionError("2x2 grid run: kernel %s was not launched"
                                 % k)
    say("ds200k   2x2 grid on cuda:0, 60 kb chunks: %s = oracle = host "
        "engine; %.1f s; launches %s" % (summary, t_grid,
                                         json.dumps(launches)))


def bulk_args():
    """argv (without -o) of the real-size dataset, generated under build/
    at first use."""
    from grom_tpu_torch.testing.bulk_sim import bulk_dataset
    prefix = os.path.join(REPO, "build", "bulk_%d_seed%d" % (
        BULK["length"], BULK["seed"]), "m")
    if not os.path.exists(prefix + ".bam.bai"):
        os.makedirs(os.path.dirname(prefix), exist_ok=True)
        t0 = time.perf_counter()
        bulk_dataset(prefix, **BULK)
        say("dataset generated in %.1f s" % (time.perf_counter() - t0))
    return ["-i", prefix + ".bam", "-r", prefix + ".fa"]


def phase_real_size() -> dict:
    import torch

    from grom_tpu_torch import _build
    from grom_tpu_torch.ops import cnv_device
    from grom_tpu_torch.utils import timing
    say("== 5. real size: %d Mb at %gx" % (BULK["length"] // 10**6,
                                           BULK["coverage"]))
    args = bulk_args()
    host_vcf = os.path.join(OUT, "bulk.host.vcf")
    dev_vcf = os.path.join(OUT, "bulk.torch.vcf")
    t_host = run_cli(args + ["-o", host_vcf], "host")

    timing.timing_enable(True)
    timing.reset()
    with LaunchTimer(cnv_device, "seed_eval") as seed_ev, Recorder() as rec:
        with card_profile() as prof:
            _build.reset_launches()
            t_dev = run_cli(args + ["-o", dev_vcf], "torch")
            launches = dict(_build.LAUNCHES)
    snap = timing.report(file=io.StringIO())   # the driver printed it
    timing.timing_enable(False)
    card = device_times(prof)

    same_files(dev_vcf, host_vcf)
    n, snv, cnv = count_rows(dev_vcf)
    if snv < 1 or cnv < 1:
        raise AssertionError("real-size run emitted %d SNV and %d CNV rows"
                             % (snv, cnv))
    say("VCF and .ctx.vcf byte-identical: %d rows (%d SNV, %d CNV)"
        % (n, snv, cnv))
    say("wall: host engine %.2f s, torch engine %.2f s" % (t_host, t_dev))
    say("launches in the torch run:", json.dumps(launches))
    for k in TORCH_PATH:
        if launches.get(k, 0) <= 0:
            raise AssertionError("kernel %s was not launched" % k)
    tiles = math.ceil(BULK["length"] / (1 << 18))
    if launches["tile_accumulate"] < tiles:
        raise AssertionError("%d tile launches < %d tiles"
                             % (launches["tile_accumulate"], tiles))
    wall = lambda k: snap.get(k, (0.0,))[0]
    cnv_s = wall("call.cnv")
    scan_s = wall("cnv.winscan_dev")
    seed_s = wall("cnv.seed_eval_dev")
    say("CNV stage %.2f s: window scans %.2f s, of which seed_eval "
        "launches %.2f s and the host outer walk %.2f s (%.1f%% of the "
        "CNV stage)" % (cnv_s, scan_s, seed_s, scan_s - seed_s,
                        100.0 * (scan_s - seed_s) / max(cnv_s, 1e-9)))
    seed_prof = sum(v for k, v in card["kernels"].items() if "seed_eval" in k)
    say("seed_eval card time over the run: %.3f ms in %d launches "
        "(torch.profiler; %s), %.3f ms (CUDA events around each launch); "
        "cnv.seed_eval_dev phase %.3f s"
        % (seed_prof, launches["seed_eval"],
           ", ".join("%s %.3f ms" % kv for kv in sorted(card["kernels"].items())
                     if "seed_eval" in kv[0]) or "no device time",
           seed_ev.total_ms(), seed_s))
    say("card busy over the torch run (torch.profiler: kernels %.1f ms, "
        "copies and sets %.1f ms) of %.2f s wall: idle share %.4f"
        % (card["kernel_ms"], card["other_ms"], t_dev,
           1.0 - (card["kernel_ms"] + card["other_ms"]) / 1e3 / t_dev))
    say("phases of the torch run: scan.device %.3f s (%d tiles), "
        "cnv.zscores_dev %.3f s, cnv.nullmodel_dev %.3f s, call.sv_detect "
        "%.3f s" % (wall("scan.device"), launches["tile_accumulate"],
                    wall("cnv.zscores_dev"), wall("cnv.nullmodel_dev"),
                    wall("call.sv_detect")))
    sums = report_run_sums(card, rec, launches, TORCH_PATH, "torch run")
    report_sv_call(rec)

    say("-- kernels against their plain versions (inputs of this run; "
        "tolerance: integers exact, f64 bitwise)")
    res = check_kernels(rec, "real-size", timed=True, names=TORCH_PATH)
    for k, row in res.items():
        row["launches"] = launches[k]
        row["run_ms"], row["run_bound_ms"] = sums[k]
    check_adversarial(rec)
    torch.cuda.synchronize()
    return res


def check_adversarial(rec: Recorder) -> None:
    """The redesigned kernels pass by pass (CUDA events between their
    launches) on the recorded largest inputs, and bitwise against their
    plain versions on inputs built to break them: a coverage-spike tile
    whose first window spills its mismatch list past shared memory, a tile
    with no mismatch, the null model in batches of 64 segments, the z-score
    cases of testing/zcases.py."""
    import numpy as np
    import torch

    from grom_tpu_torch.ops import accumulate, cnv_device
    from grom_tpu_torch.testing.tiles import PARAMS, spike_tile
    say("-- passes (CUDA events) and adversarial inputs (tolerance: "
        "integers exact, f64 bitwise)")
    tile_args = rec.best["tile_accumulate"][1]
    say("largest tile %s: passes %s ms" % (
        rec.best["tile_accumulate"][0], json.dumps(
            accumulate.tile_pass_ms(*tile_args))))
    p = dict(thr=accumulate.screen_threshold(PARAMS["min_ratio"]),
             min_mapq=PARAMS["min_mapq"], min_bq=PARAMS["min_bq"],
             min_snv=PARAMS["min_snv"], name_len_cap=PARAMS["name_len_cap"])
    for label, mm in (("spike tile", True), ("tile without mismatches",
                                             False)):
        arrays, _ = spike_tile(0, mm)
        t = accumulate.pack_tile(arrays, "cuda")
        got = accumulate.tile_kernel(t, **p)
        want = accumulate.tile_kernel_plain(accumulate.pack_tile(arrays,
                                                                 "cpu"), **p)
        _diff(got, want, exact=True)
        if (got[1] > 2000) != mm or (mm and got[2]["pos"].numel() < 6):
            raise AssertionError("%s: %d mismatch events, %d candidates"
                                 % (label, got[1], got[2]["pos"].numel()))
        say("%s (%d positions, %d aligned bases, %d hi & mm events, %d "
            "candidates): equal to the plain version; passes %s ms"
            % (label, t.chrom_up.shape[0], t.n_events, got[1],
               got[2]["pos"].numel(), json.dumps(accumulate.tile_pass_ms(
                   t, **p))))
    z, gate, seg, minw, maxw = rec.best["null_model"][1]
    say("largest null model (%d segments, batches of %d): passes %s ms"
        % (len(seg.s), cnv_device.NULL_BATCH, json.dumps(
            cnv_device.null_pass_ms(z, gate, seg, minw, maxw))))
    got = cnv_device.null_model(z, gate, seg, minw, maxw, batch=64)
    _diff(got, PLAIN_ON_CPU["null_model"], exact=True)
    say("null model in batches of 64 (%d batches): equal to the plain "
        "version; passes %s ms" % (-(-len(seg.s) // 64), json.dumps(
            cnv_device.null_pass_ms(z, gate, seg, minw, maxw, batch=64))))
    if not np.isfinite(got).all():
        raise AssertionError("null model: non-finite window stdev")
    check_zscore_cases()
    torch.cuda.synchronize()


def report_sv_call(rec: Recorder) -> None:
    """Host milliseconds of one ``SvScorer`` call (numpy in, numpy out:
    packing, one upload, the launch, one copy back) on the largest SV
    window of the run, the median of 30 calls after a warm-up one."""
    import numpy as np

    from grom_tpu_torch.ops import sv_device
    entries = rec.best["sv_score"][1][0]
    scorer = [v[2] for v in sv_device._CACHE.values()][-1]
    ent = entries.cpu().numpy()
    args = [ent[k].astype(np.int32) if k == 1 else ent[k].copy()
            for k in range(ent.shape[0])]
    scorer(*args)
    times = []
    for _ in range(30):
        t0 = time.perf_counter()
        scorer(*args)
        times.append(1e3 * (time.perf_counter() - t0))
    say("SvScorer call on the largest window (%d entries): %.4f ms host "
        "time (median of 30; min %.4f, max %.4f)"
        % (ent.shape[1], float(np.median(times)), min(times), max(times)))


def check_zscore_cases() -> None:
    """The z kernel bitwise against its plain version (CPU copies) on the
    seeded cases of testing/zcases.py, ranks on and off."""
    from grom_tpu_torch.call.cnv import build_pval2sd
    from grom_tpu_torch.ops import cnv_device, state
    from grom_tpu_torch.testing import zcases
    pv_p, pv_sd = build_pval2sd()
    par = (zcases.MIN_MAPQ, zcases.MAPQ_FACTOR, zcases.DUP_THR_FACTOR)
    for case in zcases.CASES:
        depth, mq, gc, la, arrs, cap, nb = zcases.zscore_case(case)
        ave, std = zcases.bin_stats(arrs)
        on = {dev: (state.cnv_tables(arrs, ave, std, pv_p, pv_sd, dev,
                                     cap=cap),
                    state.z_inputs(depth, mq, gc, la, 0, len(depth), dev))
              for dev in ("cuda", "cpu")}
        nz = []
        for ranks in (True, False):
            got = cnv_device.zscores(on["cuda"][1], on["cuda"][0], nb, *par,
                                     ranks)
            want = cnv_device.zscores_plain(on["cpu"][1], on["cpu"][0], nb,
                                            *par, ranks)
            _diff(got, want, exact=True)
            nz.append(int((want != 0).sum()))
        say("z case %r (%d bases, table cap %d): equal to the plain version, "
            "ranks on and off (%d and %d non-zero z)"
            % (case, len(depth), cap, nz[0], nz[1]))


def phase_real_size_mesh() -> dict:
    """The 24 Mb run on the mesh engine inside a one-process NCCL group."""
    import socket

    import torch
    import torch.distributed as dist

    from grom_tpu_torch import _build
    from grom_tpu_torch.ops import rd_depth
    from grom_tpu_torch.parallel.pipeline import (MeshAccumulator,
                                                  get_mesh_accumulator)
    from grom_tpu_torch.utils import timing
    say("== 6. real size on the mesh engine (one-process NCCL group)")
    args = bulk_args()
    mesh_vcf = os.path.join(OUT, "bulk.mesh.vcf")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    store = dist.TCPStore("localhost", port, 1, True)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    try:
        mesh = get_mesh_accumulator("cuda").mesh
        if (mesh.shape != (1, 1) or mesh.group is None
                or dist.get_backend(mesh.group) != "nccl"):
            raise AssertionError("mesh %s in group %s" % (mesh.shape,
                                                          mesh.group))
        timing.timing_enable(True)
        timing.reset()
        runs = []
        mesh_run = MeshAccumulator.run

        def counted(self, *a, **kw):
            runs.append(kw.get("hi", 0) - kw.get("lo", 0))
            return mesh_run(self, *a, **kw)
        MeshAccumulator.run = counted
        try:
            with Recorder() as rec, card_profile() as prof:
                _build.reset_launches()
                t_mesh = run_cli(args + ["-o", mesh_vcf], "mesh")
                launches = dict(_build.LAUNCHES)
        finally:
            MeshAccumulator.run = mesh_run
        snap = timing.report(file=io.StringIO())
        timing.timing_enable(False)
        card = device_times(prof)
        same_files(mesh_vcf, os.path.join(OUT, "bulk.host.vcf"))
        say("VCF and .ctx.vcf byte-identical to the host engine's; mesh "
            "engine %.2f s on a %dx%d grid" % ((t_mesh,) + mesh.shape))
        say("launches in the mesh run:", json.dumps(launches),
            "in %d MeshAccumulator.run calls" % len(runs))
        # scan.device of the mesh run in parts (host wall seconds, summed
        # over the run; the labels of parallel/pipeline.py)
        say("phases of the mesh run: scan.device %.3f s; in it: %s" % (
            snap.get("scan.device", (0.0,))[0], ", ".join(
                "%s %.3f s (x%d)" % (k, v[0], v[5])
                for k, v in sorted(snap.items()) if k.startswith("mesh."))))
        say("phases of the mesh run: cnv.zscores_dev %.3f s, "
            "cnv.nullmodel_dev %.3f s, call.sv_detect %.3f s" % tuple(
                snap.get(k, (0.0,))[0] for k in (
                    "cnv.zscores_dev", "cnv.nullmodel_dev",
                    "call.sv_detect")))
        for k in KERNELS:
            if launches.get(k, 0) <= 0:
                raise AssertionError("kernel %s was not launched" % k)
        # the tile kernel and K6 at least once per cell, K5 at least once
        # per run of the mesh (one group per run at this size)
        cells = math.ceil(BULK["length"] / (1 << 18))
        for k in ("tile_accumulate", "rd_scan"):
            if launches[k] < cells:
                raise AssertionError("%d %s launches < %d cells"
                                     % (launches[k], k, cells))
        if not runs or launches["rd_scatter"] < len(runs):
            raise AssertionError("%d rd_scatter launches < %d mesh runs"
                                 % (launches["rd_scatter"], len(runs)))
        sums = report_run_sums(card, rec, launches, tuple(KERNELS),
                               "mesh run")
        say("-- kernels against their plain versions (inputs of this run; "
            "tolerance: integers exact, f64 bitwise)")
        res = check_kernels(rec, "mesh real-size", timed=True,
                            names=MESH_ONLY + ("sv_score",))
        check_rd_scan_terms(rec)
        # no library call computes either function; one call does a part:
        # the kernels table's library_ms
        spans, _, lo, hi, L, min_mapq = rec.best["rd_scatter"][1][:6]
        pos, sign, w_mq, _ = rd_depth.endpoints_plain(spans, lo, hi, L,
                                                      min_mapq)
        idx, w_mq = pos - lo, sign * w_mq
        buf = torch.zeros(hi - lo, dtype=torch.int32, device=pos.device)
        rows = rec.best["rd_scan"][1][0]
        lib_ms = {"rd_scatter": _ms(lambda: buf.index_add_(0, idx, w_mq)),
                  "rd_scan": _ms(lambda: torch.cumsum(rows, 1,
                                                      dtype=torch.int32))}
        say("library calls (CUDA events; partial yardsticks): index_add_ "
            "of one of rd_scatter's three channels over the run's %d kept "
            "endpoints (found beforehand) %.4f ms; torch.cumsum of one "
            "cell's delta rows (no carry, no histogram) %.4f ms"
            % (len(idx), lib_ms["rd_scatter"], lib_ms["rd_scan"]))
        check_rd_edges()
        for k, row in res.items():
            row["launches"] = launches[k]
            row["run_ms"], row["run_bound_ms"] = sums[k]
            row["library_ms"] = lib_ms.get(k)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    return res


def check_rd_scan_terms(rec: Recorder) -> None:
    """K6's recorded real-size call has a carry from earlier launches; on
    a 1x1 grid every cell is cell 0 of its launch, so K6 is held once more
    on the same rows as cell 2 of a four-cell launch, with seeded totals
    of the other cells."""
    import types

    import torch
    weight, args = rec.best["rd_scan"]
    rows, csum, tot_all, j, carry_in = args[:5]
    if not int(carry_in.abs().sum()):
        raise AssertionError("K6's recorded call has no carry")
    g = torch.Generator().manual_seed(6)
    tot4 = torch.randint(-(1 << 20), 1 << 20, (4, 3), generator=g,
                         dtype=torch.int32).to(tot_all.device)
    tot4[2] = tot_all[j]
    check_kernels(types.SimpleNamespace(best={"rd_scan": (
        weight, (rows, csum, tot4, 2) + tuple(args[4:]))}),
        "mesh real-size, as cell 2 of 4 (carry %s)"
        % carry_in.tolist(), timed=False, names=("rd_scan",))


def check_rd_edges() -> None:
    """K5 and K6 bitwise against their plain versions on the edge batch
    (testing/spans.py: spans ending at a cell's first position, a cell with
    end deltas and no span, the whole-span rule, a span ending at hi), run
    by the mesh engine on the card in 1024-base cells: whole on a 2x2 grid
    (K5 once), and over [1000, 4096) on a 1x1 grid in K5 groups of one
    launch; each run's outputs equal to the same run on the CPU."""
    import numpy as np

    from grom_tpu_torch.config import GromConfig
    from grom_tpu_torch.parallel import pipeline
    from grom_tpu_torch.parallel.mesh import make_mesh
    from grom_tpu_torch.testing.spans import EDGE_RANGE, edge_batch
    chrom, batch, eligible, gate = edge_batch()
    cfg = GromConfig(bam="", ref_fasta="", out_vcf="")
    L = len(chrom)
    group_positions = pipeline.GROUP_POSITIONS
    for shape, (lo, hi), group in (((2, 2), (0, L), group_positions),
                                   ((1, 1), EDGE_RANGE, 1024)):
        n = shape[0] * shape[1]

        def one(dev):
            acc = pipeline.MeshAccumulator(
                mesh=make_mesh(*shape, devices=[dev] * n, group=None),
                seg_l=1024)
            return acc.run(chrom, batch, eligible, cfg, gate[lo:hi], lo=lo,
                           hi=hi, base_tot_out=np.zeros(hi - lo, np.int64),
                           gate_base=lo, base_tot_base=lo)
        pipeline.GROUP_POSITIONS = group
        try:
            with Recorder() as rec:
                got = one("cuda:0")
            want = one("cpu")
        finally:
            pipeline.GROUP_POSITIONS = group_positions
        _diff(got, want, exact=True)
        label = "edge batch %dx%d [%d, %d)" % (shape + (lo, hi))
        check_kernels(rec, label, timed=False, names=MESH_ONLY)
        say("%s: the mesh run on the card equals the run on the CPU (rd_hi "
            "max %d)" % (label, int(got[2][1].max())))


def genome_args():
    """argv (without -o) of phase 7's two-chromosome genome, generated
    under build/ at first use."""
    from grom_tpu_torch.testing.bulk_sim import bulk_genome
    prefix = os.path.join(REPO, "build", "genome_%s" % "_".join(
        "%d-%d" % (c["length"], c["seed"]) for c in GENOME), "g")
    if not os.path.exists(prefix + ".bam.bai"):
        os.makedirs(os.path.dirname(prefix), exist_ok=True)
        t0 = time.perf_counter()
        bulk_genome(prefix, GENOME)
        say("genome generated in %.1f s" % (time.perf_counter() - t0))
    return ["-i", prefix + ".bam", "-r", prefix + ".fa"]


def split_args():
    """argv (without -o) of phase 7's -R chromosome."""
    from grom_tpu_torch.testing.bulk_sim import bulk_dataset
    prefix = os.path.join(OUT, "split", "s")
    if not os.path.exists(prefix + ".bam.bai"):
        os.makedirs(os.path.dirname(prefix), exist_ok=True)
        bulk_dataset(prefix, **SPLIT)
    return ["-i", prefix + ".bam", "-r", prefix + ".fa"] + SPLIT_FLAGS


def report_jobs(label: str, wall: float, reps) -> None:
    """Each job of a -P run: its worker, card, peak card and host memory,
    wall and CPU seconds; and the run's CPU seconds over its wall."""
    for r in reps:
        mem, rss = r["max_memory_allocated"], r["max_rss_kib"]
        say("%s job %s: worker %d on %s, peak card memory %s, peak host "
            "RSS %s, wall %.2f s, CPU %.2f s"
            % (label, r["job"], r["pid"], r["device"],
               "-" if mem is None else "%.1f MiB" % (mem / 2**20),
               "-" if rss is None else "%.2f GiB" % (rss / 2**20),
               r["wall_s"], r["cpu_s"]))
    cpu = sum(r["cpu_s"] for r in reps)
    say("%s: wall %.2f s, workers' CPU %.2f s (%.2f cores busy of %d)"
        % (label, wall, cpu, cpu / wall, os.cpu_count()))


def check_card_jobs(label: str, reps, launches: dict) -> None:
    """Every job of a -P run on a card, and the parent's launch counts
    equal to the sum of the jobs'."""
    for r in reps:
        if not r["device"].startswith("cuda:") or r["engine"] == "host":
            raise AssertionError("%s: job %s ran %s on %s"
                                 % (label, r["job"], r["engine"],
                                    r["device"]))
    for k, n in launches.items():
        if n != sum(r["launches"][k] for r in reps):
            raise AssertionError("%s: %s launches %d, the jobs' sum %d"
                                 % (label, k, n, sum(r["launches"][k]
                                                     for r in reps)))


def phase_parallel() -> None:
    """-P 2 on the two-chromosome genome, host engine then the default
    engine on the card; then -P 2 -R 1."""
    import torch

    from grom_tpu_torch import _build
    say("== 7. -P on the card: %s at %gx, 2 workers"
        % (" + ".join("%d Mb" % (c["length"] // 10**6) for c in GENOME),
           GENOME[0]["coverage"]))
    say("torch intra-op threads %d (each worker's default), %d CPUs"
        % (torch.get_num_threads(), os.cpu_count()))
    args = genome_args() + ["-P", "2"]
    host_vcf = os.path.join(OUT, "genome.host.vcf")
    card_vcf = os.path.join(OUT, "genome.card.vcf")
    t_host, host_reps = run_parallel_cli(args + ["-o", host_vcf], "host")
    _build.reset_launches()
    t_card, reps = run_parallel_cli(args + ["-o", card_vcf], "auto")
    launches = dict(_build.LAUNCHES)
    same_files(card_vcf, host_vcf)
    n, snv, cnv = count_rows(card_vcf)
    if snv < 1 or cnv < 1:
        raise AssertionError("-P run emitted %d SNV and %d CNV rows"
                             % (snv, cnv))
    say("VCF and .ctx.vcf byte-identical: %d rows (%d SNV, %d CNV)"
        % (n, snv, cnv))
    say("wall: host engine -P 2 %.2f s, %s engine -P 2 %.2f s"
        % (t_host, reps[0]["engine"], t_card))
    report_jobs("host -P 2", t_host, host_reps)
    report_jobs("card -P 2", t_card, reps)
    say("launches summed over the workers:", json.dumps(launches))
    check_card_jobs("-P 2", reps, launches)
    for k in TORCH_PATH:
        if launches.get(k, 0) <= 0:
            raise AssertionError("-P 2: kernel %s was not launched" % k)
    tiles = sum(math.ceil(c["length"] / (1 << 18)) for c in GENOME)
    if launches["tile_accumulate"] < tiles:
        raise AssertionError("-P 2: %d tile launches < %d tiles"
                             % (launches["tile_accumulate"], tiles))

    args = split_args() + ["-P", "2"]
    host_vcf = os.path.join(OUT, "split.host.vcf")
    card_vcf = os.path.join(OUT, "split.card.vcf")
    t_host, host_reps = run_parallel_cli(args + ["-o", host_vcf], "host")
    _build.reset_launches()
    t_card, reps = run_parallel_cli(args + ["-o", card_vcf], "auto")
    launches = dict(_build.LAUNCHES)
    same_files(card_vcf, host_vcf)
    if len(reps) != 3:
        raise AssertionError("-R 1: %d jobs, not 3" % len(reps))
    check_card_jobs("-P 2 -R 1", reps, launches)
    for k in TORCH_PATH:
        if launches.get(k, 0) <= 0:
            raise AssertionError("-P 2 -R 1: kernel %s was not launched" % k)
    say("-P 2 %s on %g Mb at %gx: %d region jobs, VCF and .ctx.vcf "
        "byte-identical (%d rows); wall: host engine %.2f s, %s engine "
        "%.2f s; launches %s"
        % (" ".join(SPLIT_FLAGS), SPLIT["length"] / 1e6,
           SPLIT["coverage"], len(reps), count_rows(card_vcf)[0], t_host,
           reps[0]["engine"], t_card, json.dumps(launches)))
    report_jobs("card -P 2 -R 1", t_card, reps)


def run_child(argv, engine_name: str, env_extra: dict) -> dict:
    """One run of the port's CLI in a fresh process (``cli_child``) with
    GROM_TPU_TIMING=1; returns its wall seconds and its ``launches``,
    ``peak_memory`` and ``k5_largest`` stderr lines, parsed."""
    env = dict(os.environ, GROM_TPU_TORCH_ENGINE=engine_name,
               GROM_TPU_TIMING="1", **env_extra)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--cli-child", *argv], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=900)
    if r.returncode != 0:
        raise RuntimeError("grom_tpu_torch %s (%s) exited %d:\n%s"
                           % (argv, engine_name, r.returncode,
                              r.stderr[-4000:]))
    out = {"wall_s": time.perf_counter() - t0}
    for ln in r.stderr.splitlines():
        key, _, rest = ln.partition(" ")
        if key in ("launches", "peak_memory", "k5_largest") and \
                rest.startswith("{"):
            out[key] = json.loads(rest)
    for key in ("launches", "peak_memory"):
        if key not in out:
            raise AssertionError("%s run printed no %s line"
                                 % (engine_name, key))
    return out


def cli_child(argv) -> int:
    """``python chip_smoke.py --cli-child <CLI arguments>``: the port's CLI
    (``cli.main``, as ``python -m grom_tpu_torch`` runs it) in this fresh
    process, with K5's largest call (the most spans; its cells) printed as
    a ``k5_largest {...}`` line on stderr when the run made one."""
    sys.path.insert(0, REPO)
    from grom_tpu_torch import cli
    from grom_tpu_torch.ops import rd_depth
    largest = {}
    scatter = rd_depth.rd_scatter

    def probe(spans, slot_of, lo, hi, L, min_mapq, seg_l, g0, ng, rows,
              *rest):
        n = int(spans.ref.shape[0])
        if n > largest.get("spans", -1):
            largest.update(spans=n, cells=int(rows.shape[0]),
                           positions=hi - lo, seg_l=seg_l)
        return scatter(spans, slot_of, lo, hi, L, min_mapq, seg_l, g0, ng,
                       rows, *rest)
    rd_depth.rd_scatter = probe
    rc = cli.main(list(argv))
    if largest:
        print("k5_largest " + json.dumps(largest), file=sys.stderr,
              flush=True)
    return rc


def phase_wide_chunks() -> None:
    """Phase 5's chromosome at a human chromosome's ingest geometry, torch
    and mesh engines in fresh processes, against phase 5's host output."""
    say("== 8. 16 Mi ingest chunks, 4 Mi detect sub-chunks: %d Mb at %gx "
        "on the torch and mesh engines" % (BULK["length"] // 10**6,
                                           BULK["coverage"]))
    args = bulk_args()
    host_vcf = os.path.join(OUT, "bulk.host.vcf")
    tiles = math.ceil(BULK["length"] / (1 << 18))
    subchunks = sum(math.ceil((min(t0 + (16 << 20), BULK["length"]) - t0)
                              / (4 << 20))
                    for t0 in range(0, BULK["length"], 16 << 20))
    for name in ("torch", "mesh"):
        vcf = os.path.join(OUT, "bulk.wide.%s.vcf" % name)
        res = run_child(args + ["-o", vcf], name, WIDE)
        same_files(vcf, host_vcf)
        launches = res["launches"]
        path = TORCH_PATH + (MESH_ONLY if name == "mesh" else ())
        for k in path:
            if launches.get(k, 0) <= 0:
                raise AssertionError("16 Mi %s run: kernel %s was not "
                                     "launched" % (name, k))
        if launches["tile_accumulate"] < tiles:
            raise AssertionError("16 Mi %s run: %d tile launches < %d tiles"
                                 % (name, launches["tile_accumulate"], tiles))
        mem = res["peak_memory"]
        card = mem["card"] or {}
        if not card.get("max_allocated"):
            raise AssertionError("16 Mi %s run: no peak card memory" % name)
        say("16 Mi %s run: VCF and .ctx.vcf byte-identical to phase 5's host "
            "output; %.2f s; launches %s" % (name, res["wall_s"],
                                             json.dumps(launches)))
        say("16 Mi %s run: peak_memory %s (host RSS %s GiB, %s; card %.1f "
            "MiB allocated, %.1f MiB reserved)"
            % (name, json.dumps(mem),
               "-" if mem["rss_peak_kib"] is None
               else "%.2f" % (mem["rss_peak_kib"] / 2**20),
               mem["rss_source"], card["max_allocated"] / 2**20,
               card["max_reserved"] / 2**20))
        if name == "mesh":
            k5 = res.get("k5_largest")
            if not k5:
                raise AssertionError("16 Mi mesh run: no K5 call recorded")
            if launches["rd_scatter"] < subchunks or \
                    launches["rd_scan"] < tiles:
                raise AssertionError(
                    "16 Mi mesh run: %d rd_scatter launches < %d detect "
                    "sub-chunks or %d rd_scan < %d cells"
                    % (launches["rd_scatter"], subchunks,
                       launches["rd_scan"], tiles))
            say("16 Mi mesh run: K5's largest run %d spans over %d cells of "
                "%d positions (%d positions)" % (
                    k5["spans"], k5["cells"], k5["seg_l"], k5["positions"]))


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--cli-child":
        return cli_child(sys.argv[2:])
    if not os.path.isdir(os.path.join(REPO, "grom_tpu_torch")):
        print("chip_smoke.py: grom_tpu_torch is not beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    t0 = time.perf_counter()
    smi = phase_toolchain()
    phase_build()
    phase_cnvrich_kernels()
    phase_fixtures()
    phase_fixtures_mesh()
    res = phase_real_size()
    res.update(phase_real_size_mesh())
    phase_parallel()
    phase_wide_chunks()
    foreign = [m for m in sys.modules if m.split(".")[0] in ("jax",
                                                              "grom_tpu")]
    if foreign:
        raise AssertionError("imported: %s" % foreign)
    say("== done in %.1f s" % (time.perf_counter() - t0))
    say(smi)
    table = [dict(name=k, route="cuda", source=KERNELS[k][0],
                  replaces=KERNELS[k][1], launches=res[k]["launches"],
                  max_abs_err=res[k]["max_abs_err"], ms=res[k]["ms"],
                  plain_ms=res[k]["plain_ms"], bound_ms=res[k]["bound_ms"],
                  bound_by=res[k]["bound_by"],
                  library_ms=res[k].get("library_ms"))
             for k in KERNELS]
    say(json.dumps({"kernels": table}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
