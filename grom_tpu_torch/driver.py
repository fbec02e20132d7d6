"""Pipeline driver of the port: ingest → scan → detect → VCF per chromosome,
with the per-base accumulate + SNV screen, the SV entry scorer and the CNV
stage on the device engines' kernels.

The counterpart of grom_tpu/driver.py. The orchestration is grom_tpu's
(the streamed path, the whole-batch path, ``_ChunkDetect``); only the
engine hooks differ, so fixes made in the reference carry over by diff:

* ``engine="torch"`` runs ops/accumulate.py's ``TorchAccumulator`` per
  detect sub-chunk on ``device``; the caf_rd_* depth lists stay host-side,
  as grom_tpu's single-device engine keeps them;
* ``engine="mesh"`` runs parallel/pipeline.py's ``MeshAccumulator`` over a
  grid of genome cells (``mesh``, default: every visible CUDA device and
  the default ``torch.distributed`` group), which also builds the depth
  lists on the device with a cross-cell carry;
* both device engines score SV entries with ops/sv_device.py's scorer and
  run call/cnv.py's device CNV stage;
* ``engine="host"`` runs the native C / numpy engines of the port's own
  copies of grom_tpu's host modules (``call/``, ``ingest/``, native.py).

grom_tpu's per-stage device policy holds on every engine:
GROM_TPU_DEVICE_CNV=1 puts the CNV stage on ``device`` and =0 keeps it on
the native C / numpy stage; GROM_TPU_DEVICE_SV=1 puts the SV scorer on
``device`` and =0 keeps it on the host screen. Unset (or any other value),
both stages are on the device on the device engines and on the host on the
host engine (``device_stages``).

The engine-free helpers of grom_tpu/driver.py are copied below as they
are. There is no fallback from a kernel to its plain version or from a
device engine to the host engine: an engine that puts a stage on "cuda"
without a card raises, and so does the default engine choice.
"""

from __future__ import annotations

import functools
import os
import sys
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from grom_tpu_torch.call import scan as scan_mod
from grom_tpu_torch.call import snv as snv_mod
from grom_tpu_torch.config import DerivedConfig, GromConfig
from grom_tpu_torch.ingest import bam as bam_mod
from grom_tpu_torch.ingest import fasta as fasta_mod
from grom_tpu_torch.ingest.batches import build_batch
from grom_tpu_torch.ingest.insert_size import InsertStats, load_or_estimate
from grom_tpu_torch.stats import binom
from grom_tpu_torch.vcfio.writer import VcfWriter

ENGINES = ("host", "torch", "mesh")
# where each streamed chromosome of this process kept its depth lists
# through the scan stage ("host", or a device engine's device) and the
# card bytes they took: the ``depth_lists`` field of ``peak_memory``
DEPTH_LISTS: List[dict] = []


@dataclass
class RunResult:
    vcf_path: str
    ctx_path: str
    n_records: int
    insert: InsertStats


def resolve_engine() -> str:
    """Which engine to run: GROM_TPU_TORCH_ENGINE = "host" (the native C /
    numpy engines on the CPU), "torch" (the port's kernels on one device),
    "mesh" (the port's kernels over a grid of cells) or "auto" (default:
    mesh with more than one CUDA device, torch with one). With no CUDA
    device, "auto" raises: the CPU runs only when asked for. An auto choice
    is reported on stderr."""
    e = os.environ.get("GROM_TPU_TORCH_ENGINE", "auto")
    if e != "auto":
        if e not in ENGINES:
            raise ValueError("GROM_TPU_TORCH_ENGINE must be host, torch, "
                             "mesh or auto, not %r" % e)
        return e
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("grom_tpu_torch runs on a CUDA device and none is "
                           "available; set GROM_TPU_TORCH_ENGINE=host to run "
                           "on the CPU")
    e = "mesh" if torch.cuda.device_count() > 1 else "torch"
    print("grom_tpu_torch: engine auto -> %s" % e, file=sys.stderr,
          flush=True)
    return e


def device_stages(engine: str) -> bool:
    """Whether a run of ``engine`` puts any stage on its device: always on
    the device engines; on the host engine when GROM_TPU_DEVICE_CNV=1 or
    GROM_TPU_DEVICE_SV=1 puts the CNV stage or the SV scorer there."""
    return engine in ("torch", "mesh") or "1" in (
        os.environ.get("GROM_TPU_DEVICE_CNV", ""),
        os.environ.get("GROM_TPU_DEVICE_SV", ""))


def check_device(engine: str, device) -> None:
    """Raise when an engine that puts a stage on its device
    (``device_stages``) is asked for a CUDA device that is not there (no
    fallback to the CPU or to the host stage)."""
    if not device_stages(engine):
        return
    import torch
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        why = "" if engine in ("torch", "mesh") else (
            " (GROM_TPU_DEVICE_CNV=1 or GROM_TPU_DEVICE_SV=1 puts a stage "
            "there)")
        raise RuntimeError("engine %r on %s needs a CUDA device%s, and none "
                           "is available" % (engine, device, why))
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("engine %r runs on cuda (or cpu for tests), not %s"
                         % (engine, device))


def _accumulator(engine: str, device, mesh=None):
    """(accumulator, the device of the SV scorer) of a device engine."""
    import torch
    if engine == "mesh":
        from grom_tpu_torch.parallel.pipeline import (MeshAccumulator,
                                                      get_mesh_accumulator)
        acc = (MeshAccumulator(mesh=mesh) if mesh is not None
               else get_mesh_accumulator(device))
        return acc, acc.mesh.devices[0]
    from grom_tpu_torch.ops.accumulate import TorchAccumulator
    return TorchAccumulator(device), torch.device(device)


def bam_header(path: str):
    """``path``'s header. An indexed BAM's comes from the reader that its
    region fetches share (``ingest/bam.py _cached_reader``), not from
    ``read_bam_header``: that opens a reader of its own, whose copy of a
    BAM under ``GROM_TPU_SRC_MMAP_MIN`` bytes stays in
    ``utils/bufpool.POOL``, which nothing returns (a BAM's size of host
    memory a call, for the life of the process)."""
    bai = bam_mod.find_bai(path)
    if bai is None:
        return bam_mod.read_bam_header(path)
    return bam_mod._cached_reader(path, bai)[1]


def run(cfg: GromConfig, file_date: Optional[str] = None,
        engine: Optional[str] = None, device="cuda",
        mesh=None) -> RunResult:
    """Single-host run (the reference's serial mode). With -c
    "chr,sub,start,end" set, runs the sub-region child mode instead.
    ``mesh`` (parallel/mesh.py) is the grid of the mesh engine.

    With a BAI index present, chromosomes are decoded one at a time
    (regional fetches), so peak memory is one chromosome's reads. Without
    an index the whole BAM is decoded once."""
    if engine is None:
        engine = resolve_engine()
    check_device(engine, device)
    if cfg.one_chromosome:
        return run_child_region(cfg, engine, device, mesh)
    from grom_tpu_torch.utils import peakmem
    from grom_tpu_torch.utils.timing import phase, report, timing_enabled
    if timing_enabled():
        peakmem.start()
    # progress prints mirroring the reference's stdout (src/GROM.c:22106-22111,
    # :22274-22275, :1421-1426)
    print("bam %s" % cfg.bam)
    print("ref %s" % cfg.ref_fasta)
    print("results %s" % cfg.out_vcf, flush=True)
    with phase("ingest.fasta_index"):
        info = fasta_mod.index_fasta(cfg.ref_fasta)
    streaming = os.path.exists(cfg.bam + ".bai")
    reads = None
    prefetch: Dict[Tuple[int, int, int], object] = {}
    if streaming:
        header = bam_header(cfg.bam)
        jobs = _chromosome_jobs(cfg, header, info)
        # the prefetched chunk is the host engine's first: a device engine
        # whose first chunk is capped below it would never take it
        L0 = int(header.ref_lengths[jobs[0][0]]) if jobs else 0
        if jobs and _chunk_bases(L0, engine in ("torch", "mesh"))[0] == \
                _auto_chunk_bases(L0)[0]:
            _start_first_chunk_prefetch(cfg, header, info, prefetch)
        with phase("ingest.insert_stats"):
            ins = _streaming_insert_stats(cfg, header)
    else:
        with phase("ingest.read_bam"):
            header, reads = bam_mod.read_bam(cfg.bam)
        jobs = _chromosome_jobs(cfg, header, info)
        with phase("ingest.insert_stats"):
            ins = load_or_estimate(cfg.bam, reads, cfg)
    drv = DerivedConfig.from_insert_stats(cfg, ins.insert_mean, ins.insert_min,
                                          ins.insert_max, ins.read_len,
                                          ins.mapped_read_bases)
    print("insert mean, insert minimum, insert maximum: %d %d %d"
          % (drv.insert_mean, drv.insert_min, drv.insert_max))
    print("median read length: %d" % drv.read_len)
    print("mappable genome length: %d" % info.mappable_length, flush=True)

    with phase("stats.tables"):
        mq_table = binom.build_mq_table(
            cfg.min_mapq if cfg.min_mapq > 10 else 10, cfg.max_trials)
        hez_table = binom.build_hez_table(cfg.max_trials)

    prelude = None
    if not cfg.vcf_output:
        from grom_tpu_torch.vcfio.tabular import main_prelude
        prelude = main_prelude(drv.insert_mean, drv.insert_min,
                               drv.insert_max, drv.read_len)
    writer = VcfWriter(cfg.out_vcf, cfg.ref_fasta, file_date, prelude=prelude)
    n_records = 0
    all_ctx: List[str] = []

    # one item a job: each contig span takes its job's item, from the
    # wait for its sequence to the write of its rows
    stream = _chromosome_stream(cfg, header, info, jobs, reads, streaming)
    for job_refid, job_name in jobs:
        with phase("contig", name=job_name,
                   length=header.ref_lengths[job_refid]):
            with phase("contig.setup"):
                refid, fa_name, creads, sel, chrom = next(stream)
            # chromosome progress (src/GROM.c:20908)
            print(fa_name.lower(), flush=True)
            res = None
            if creads is None:
                # big chromosome: bounded-memory chunked streaming (reads
                # are fetched per genome chunk, never held whole)
                def fetch(t0, t1, _r=refid):
                    hit = prefetch.pop((_r, t0, t1), None)
                    if hit is not None:
                        ev, slot = hit
                        ev.wait()
                        if "reads" in slot:
                            return slot["reads"]
                    return bam_mod.read_bam_region(cfg.bam, _r, t0, t1)[1]
                res = call_chromosome_streamed(chrom, refid, fa_name.lower(),
                                               cfg, drv, mq_table, hez_table,
                                               fetch, engine=engine,
                                               device=device, mesh=mesh)
                if res is None:   # freak CIGARs overflowed the deposit ring
                    _, creads = bam_mod.read_bam_region(
                        cfg.bam, refid, 0, int(header.ref_lengths[refid]))
                    sel = np.arange(len(creads.pos))
            if res is None:
                res = call_chromosome(chrom, creads, sel, refid,
                                      fa_name.lower(), cfg, drv, mq_table,
                                      hez_table, engine=engine, device=device,
                                      mesh=mesh)
            rows, ctx_recs = res
            del creads
            with phase("emit.rows"):
                writer.write_rows(rows)
            all_ctx.extend(ctx_recs)
            n_records += len(rows)
    next(stream, None)   # ends the stream: joins its producer thread
    writer.close()

    ctx_path = _ctx_path(cfg.out_vcf)
    from grom_tpu_torch.call.ctx import write_ctx_vcf
    print("Translocations before filter: %d" % len(all_ctx))
    with phase("emit.ctx_merge"):
        n_bnd = write_ctx_vcf(ctx_path, all_ctx, header.ref_names, cfg, drv,
                              file_date)
    print("Translocations after filter: %d" % n_bnd, flush=True)
    snap = report()
    if timing_enabled():
        _print_run_stats(engine, device, mesh, snap)
    return RunResult(cfg.out_vcf, ctx_path, n_records, ins)


def phase_rss_kib(snap: dict) -> Dict[str, int]:
    """Each timed phase's ``livemax`` (``utils/timing.py report``'s
    snapshot): the peak host RSS, in KiB, at the phase's last end."""
    return {k: v.livemax >> 10 for k, v in snap.items()}


def phase_card_bytes(snap: dict) -> Dict[str, int]:
    """Each timed phase's ``card_peak`` (``utils/timing.py report``'s
    snapshot): the card's running peak of allocated bytes at the phase's
    last end; the phases that ended with CUDA initialized. Read in run
    order, the first phase that shows a new peak is where it grew."""
    return {k: v.card_peak for k, v in snap.items()
            if v.card_peak is not None}


def depth_lists_report() -> dict:
    """``DEPTH_LISTS`` summed up: where this process's streamed chromosomes
    kept their depth lists through the scan stage (``scan``: each place
    once, in order), the largest card bytes they took, and the card's
    peak allocated bytes as a scan on the card ended (``card_peak_scan``;
    None off the card)."""
    scan: List[str] = []
    for rec in DEPTH_LISTS:
        if rec["where"] not in scan:
            scan.append(rec["where"])
    peaks = [rec["card_peak_scan"] for rec in DEPTH_LISTS
             if "card_peak_scan" in rec]
    return {"scan": scan, "card_bytes": max(
        (rec["card_bytes"] for rec in DEPTH_LISTS), default=0),
        "card_peak_scan": max(peaks) if peaks else None}


def queued_jobs_report() -> dict:
    """The most device bytes the inputs of this process's queued device
    jobs held at once (``peak_bytes``: the largest ``queued_peak`` of the
    streamed chromosomes' records; 0 on the host engine)."""
    return {"peak_bytes": max((rec.get("queued_peak", 0)
                               for rec in DEPTH_LISTS), default=0)}


def _print_run_stats(engine: str, device, mesh, snap: dict) -> None:
    """The run's kernel launches (``_build.LAUNCHES``) and its peak host and
    card memory (``utils/peakmem.py``), one JSON line each on stderr:
    ``launches {...}`` and ``peak_memory {...}``, the latter with the
    timed phases' peaks (``phase_rss_kib``, ``phase_card_bytes``), the
    pinned host memory of torch's caching host allocator (``pinned``),
    where the streamed chromosomes' depth lists lived through the scan
    (``depth_lists``) and the device bytes of their queued jobs' inputs
    (``queued_jobs``)."""
    import json

    from grom_tpu_torch import _build
    from grom_tpu_torch.utils import peakmem
    devices = []
    if device_stages(engine):
        devices = [device]
        if mesh is not None:
            devices = list(mesh.devices)
        elif engine == "mesh":
            from grom_tpu_torch.parallel.pipeline import get_mesh_accumulator
            devices = list(get_mesh_accumulator(device).mesh.devices)
    print("launches " + json.dumps(dict(_build.LAUNCHES)), file=sys.stderr)
    mem = peakmem.report(devices)
    mem["phase_rss_kib"] = phase_rss_kib(snap)
    mem["phase_card_bytes"] = phase_card_bytes(snap)
    mem["pinned"] = peakmem.pinned_host(devices)
    mem["depth_lists"] = depth_lists_report()
    mem["queued_jobs"] = queued_jobs_report()
    print("peak_memory " + json.dumps(mem), file=sys.stderr, flush=True)


def _chromosome_stream(cfg: GromConfig, header, info, jobs, reads,
                       streaming: bool):
    """Yields (refid, fa_name, creads, sel, chrom) per eligible chromosome.

    In streaming (BAI) mode, a background thread loads chromosome N+1's
    FASTA (and, below GROM_TPU_STREAM_BASES, its reads) while chromosome N
    computes, double-buffered via a depth-1 queue. Without an index the
    pre-decoded whole-BAM arrays are sliced instead."""
    from grom_tpu_torch.utils.timing import phase

    if not streaming:
        for refid, fa_name in jobs:
            chrom = fasta_mod.load_chromosome(cfg.ref_fasta, info, fa_name)
            sel = np.flatnonzero(reads.refid == refid)
            yield refid, fa_name, reads, sel, chrom
        return

    import queue
    import threading
    q: "queue.Queue" = queue.Queue(maxsize=1)
    stream_thresh = int(os.environ.get("GROM_TPU_STREAM_BASES", "0"))
    if os.environ.get("GROM_TPU_STREAM") == "1":
        stream_thresh = 0

    def produce_one(refid, fa_name):
        if int(header.ref_lengths[refid]) > stream_thresh:
            # big chromosome: the consumer fetches reads chunk-wise
            chrom = fasta_mod.load_chromosome(cfg.ref_fasta, info, fa_name)
            return (refid, fa_name, None, chrom)
        with phase("ingest.read_bam"):
            _, creads = bam_mod.read_bam_region(
                cfg.bam, refid, 0, int(header.ref_lengths[refid]))
            chrom = fasta_mod.load_chromosome(cfg.ref_fasta, info, fa_name)
        return (refid, fa_name, creads, chrom)

    if _sync_ingest():
        for refid, fa_name in jobs:
            refid, fa_name, creads, chrom = produce_one(refid, fa_name)
            sel = np.arange(len(creads.pos)) if creads is not None else None
            yield refid, fa_name, creads, sel, chrom
        return

    def producer():
        try:
            for refid, fa_name in jobs:
                q.put(produce_one(refid, fa_name))
            q.put(None)
        except BaseException as exc:  # surface decode errors to the consumer
            q.put(exc)

    t = threading.Thread(target=producer, name="grom-ingest", daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is None:
            break
        if isinstance(item, BaseException):
            raise item
        refid, fa_name, creads, chrom = item
        sel = np.arange(len(creads.pos)) if creads is not None else None
        yield refid, fa_name, creads, sel, chrom
    t.join()


def run_child_region(cfg: GromConfig, engine: str = "host",
                     device="cuda", mesh=None) -> RunResult:
    """-c "chr,sub,start,end" child: process one sub-region of one
    chromosome through the whole-batch path, writing headerless partial
    files <out>.<bamchr>-<sub> and <out>.<bamchr>-<sub>.ctx
    (src/GROM.c:20676-20692)."""
    refid, sub, rstart, rend = (int(x) for x in cfg.one_chromosome.split(","))
    info = fasta_mod.index_fasta(cfg.ref_fasta)
    header = bam_header(cfg.bam)
    ins = load_or_estimate(cfg.bam, None, cfg)
    drv = DerivedConfig.from_insert_stats(cfg, ins.insert_mean, ins.insert_min,
                                          ins.insert_max, ins.read_len,
                                          ins.mapped_read_bases)
    mq_table = binom.build_mq_table(cfg.min_mapq if cfg.min_mapq > 10 else 10,
                                    cfg.max_trials)
    hez_table = binom.build_hez_table(cfg.max_trials)
    bam_name = header.ref_names[refid]
    out_path = "%s.%s-%d" % (cfg.out_vcf, bam_name, sub)
    ctx_out = out_path + ".ctx"
    fa_name = fasta_mod.match_chromosome(bam_name, info.names)
    rows: List[str] = []
    ctx_recs: List[str] = []
    if fa_name is not None:
        out_name = fa_name.lower()
        chrom = fasta_mod.load_chromosome(cfg.ref_fasta, info, fa_name)
        _, reads = bam_mod.read_bam_region(cfg.bam, refid, max(rstart, 0),
                                           rend)
        ends = bam_mod.alignment_ends(reads)
        sel = np.flatnonzero((reads.pos < rend - 1) & (ends > rstart))
        rows, ctx_recs = call_chromosome(chrom, reads, sel, refid, out_name,
                                         cfg, drv, mq_table, hez_table,
                                         region_start=rstart, engine=engine,
                                         device=device, mesh=mesh)
    with open(out_path, "w") as f:
        for r in rows:
            f.write(r if r.endswith("\n") else r + "\n")
    with open(ctx_out, "w") as f:
        for r in ctx_recs:
            f.write(r if r.endswith("\n") else r + "\n")
    return RunResult(out_path, ctx_out, len(rows), ins)


# ---------------------------------------------------------------------------
# host helpers, copied from grom_tpu/driver.py as they are
# ---------------------------------------------------------------------------

# Ingest-chunk default (GROM_TPU_CHUNK_BASES overrides). 16Mb keeps the
# decoded read tensors at ~1.2GB/chunk at 30x: with the producer queue and
# the current chunk that's ~3 chunk generations live, and 16Mb measured
# no slower end-to-end than 32Mb (2x100Mb@30x -P 2 experiment: worker peak
# RSS 15.1GB -> 11.5GB, equal wall) — a 16Mb chunk still spans thousands
# of BGZF blocks, so the threaded inflate stays saturated.
DEFAULT_CHUNK_BASES = 16 << 20


def _auto_chunk_bases(L: int) -> Tuple[int, bool]:
    """(ingest chunk bases, force_async) for a chromosome of length L.

    Size-scaled default: ~8 chunks per chromosome, floor 1Mb, cap
    DEFAULT_CHUNK_BASES. Small chromosomes get fine chunks AND an async
    producer — the brief per-chunk inflate bursts then overlap compute
    even on narrow hosts (measured on the 4Mb/30x bench: 5.2s -> 4.75s;
    either change alone wins nothing). Large chromosomes keep bounded
    chunk memory and the narrow-host sync-ingest crossover
    (_sync_ingest). GROM_TPU_CHUNK_BASES overrides the size."""
    env = os.environ.get("GROM_TPU_CHUNK_BASES", "")
    if env.isdigit() and int(env) > 0:
        return int(env), False
    C = min(DEFAULT_CHUNK_BASES, max(1 << 20, L // 8))
    return C, C <= (2 << 20) < L



def _chromosome_jobs(cfg: GromConfig, header, info) -> List[tuple]:
    """(refid, FASTA name) of each chromosome to call, in the run's order:
    FASTA order; names lowercased in output like the reference's
    find_genome_length (src/GROM.c:1321-1428)."""
    jobs = []
    for refid, bam_name in enumerate(header.ref_names):
        fa_name = fasta_mod.match_chromosome(bam_name, info.names)
        if fa_name is None:
            continue
        if fasta_mod.is_chry(fa_name) and cfg.gender == 0:
            continue  # chrY skipped for female (src/GROM.c:20979-20988)
        jobs.append((refid, fa_name))
    return jobs


def _start_first_chunk_prefetch(cfg: GromConfig, header, info,
                                out: Dict) -> None:
    """Decode the first eligible chromosome's first chunk on a background
    thread, concurrently with insert estimation — otherwise it is the first
    serial step after it (both read the same cached BGZF source; reader and
    pools are thread-safe). The streamed driver's fetch() consumes it via
    the (refid, t0, t1) key; a miss just decodes normally."""
    import threading
    if _sync_ingest():
        return                      # narrow host: no ingest worker threads
    for refid, bam_name in enumerate(header.ref_names):
        fa_name = fasta_mod.match_chromosome(bam_name, info.names)
        if fa_name is None:
            continue
        if fasta_mod.is_chry(fa_name) and cfg.gender == 0:
            continue
        break
    else:
        return
    L = int(header.ref_lengths[refid])
    C, _ = _auto_chunk_bases(L)
    t1 = min(C, L)
    ev = threading.Event()
    slot: Dict[str, object] = {}

    def work():
        try:
            from grom_tpu_torch.utils.timing import phase
            with phase("ingest.read_bam"):
                slot["reads"] = bam_mod.read_bam_region(cfg.bam, refid, 0,
                                                        t1)[1]
        except Exception:
            slot.pop("reads", None)
        finally:
            ev.set()

    threading.Thread(target=work, daemon=True,
                     name="grom-prefetch0").start()
    out[(refid, 0, t1)] = (ev, slot)



def _sync_ingest() -> bool:
    """True = run ingest inline on the calling thread instead of producer
    threads. On <=2-vCPU hosts the decode's own worker pthreads already
    fill the machine; extra producer threads only add oversubscription,
    which degraded-host schedulers punish hard (measured: the same fetch
    3x slower on a worker thread than on the main thread). Override with
    GROM_TPU_SYNC_INGEST=0/1."""
    env = os.environ.get("GROM_TPU_SYNC_INGEST", "")
    if env in ("0", "1"):
        return env == "1"
    return (os.cpu_count() or 1) <= 2



def _streaming_insert_stats(cfg: GromConfig,
                            header: "bam_mod.BamHeader") -> InsertStats:
    """Insert estimation without decoding the whole BAM: chromosomes are
    fetched in header order (== file order for a coordinate-sorted BAM) and
    decoding stops once the reference's 10M-record sample is full
    (src/GROM.c:1205-1318). Cached like load_or_estimate."""
    import json

    from grom_tpu_torch.ingest.bam import (FDUP, FMUNMAP, FPAIRED, FPROPER_PAIR,
                                     FUNMAP)
    from grom_tpu_torch.ingest.insert_size import (estimate_insert_stats,
                                             estimate_insert_stats_streaming)
    cache = cfg.bam + ".grom_tpu.mean.json"
    if os.path.exists(cache):
        try:
            with open(cache) as f:
                return InsertStats.from_json(f.read())
        except (ValueError, KeyError):
            pass
    ref_cache = cfg.bam + ".mean"    # the reference binary's own cache
    if os.path.exists(ref_cache):
        try:
            with open(ref_cache) as f:
                v = f.read().split()
            if len(v) == 5:
                return InsertStats(int(v[0]), int(v[2]), int(v[3]),
                                   int(v[1]), int(v[4]))
        except (ValueError, OSError):
            pass
    st = estimate_insert_stats_streaming(cfg.bam, cfg)
    if st is not None:
        try:
            with open(cache, "w") as f:
                f.write(st.to_json())
        except OSError:
            pass
        return st
    keys = ("flag", "refid", "mrefid", "pos", "mpos", "tlen", "lseq", "mapq")
    cols = {k: [] for k in keys}
    contributing = 0
    for refid in range(len(header.ref_names)):
        _, r = bam_mod.read_bam_region(cfg.bam, refid, 0,
                                       int(header.ref_lengths[refid]),
                                       want_names=False, fields_only=True)
        if not len(r.pos):
            continue
        for k in keys:
            cols[k].append(getattr(r, k))
        flag = r.flag
        usable = ((flag & FUNMAP) == 0) & ((flag & FDUP) == 0)
        unpaired = usable & ((flag & FPAIRED) == 0)
        paired_ok = (usable & ((flag & FPAIRED) != 0)
                     & ((flag & FMUNMAP) == 0) & (r.refid == r.mrefid)
                     & (r.pos < r.mpos) & ((flag & FPROPER_PAIR) != 0)
                     & (r.tlen > 0))
        contributing += int((unpaired | paired_ok).sum())
        if contributing >= cfg.insert_sample_size:
            break

    class _Lite:
        pass

    lite = _Lite()
    for k in keys:
        setattr(lite, k, np.concatenate(cols[k]) if cols[k]
                else np.empty(0, np.int64))
    st = estimate_insert_stats(lite, cfg)
    try:
        with open(cache, "w") as f:
            f.write(st.to_json())
    except OSError:
        pass
    return st



def _ctx_path(out_vcf: str) -> str:
    """"x.vcf" -> "x.ctx.vcf"; anything else appends ".ctx"
    (src/GROM.c:20488-20504)."""
    if out_vcf.endswith(".vcf"):
        return out_vcf[:-4] + ".ctx.vcf"
    return out_vcf + ".ctx"



def _gather_ragged(data: np.ndarray, off: np.ndarray, sel: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Gather ragged rows data[off[i]:off[i+1]] for i in sel (vectorized)."""
    lens = (off[sel + 1] - off[sel]).astype(np.int64)
    out_off = np.zeros(len(sel) + 1, np.int64)
    np.cumsum(lens, out=out_off[1:])
    total = int(out_off[-1])
    if total == 0:
        return np.empty(0, data.dtype), out_off
    # segment ids: +1 at each non-empty row start (rows may be empty)
    starts = out_off[:-1][lens > 0]
    marks = np.zeros(total + 1, np.int64)
    np.add.at(marks, starts, 1)
    seg = np.cumsum(marks[:total]) - 1
    row = np.flatnonzero(lens > 0)[seg]
    idx = off[sel[row]] + (np.arange(total, dtype=np.int64) - out_off[:-1][row])
    return data[idx], out_off



def _subset_reads(reads: bam_mod.RawReads, sel: np.ndarray) -> bam_mod.RawReads:
    sel = np.asarray(sel, np.int64)
    n = len(sel)
    if n and sel[0] + n - 1 == sel[-1] and sel[-1] - sel[0] == n - 1:
        # contiguous selection (the common case: coordinate-sorted BAM)
        s0, s1 = int(sel[0]), int(sel[-1]) + 1
        c0, c1 = int(reads.cigar_off[s0]), int(reads.cigar_off[s1])
        q0, q1 = int(reads.seq_off[s0]), int(reads.seq_off[s1])
        cigar = reads.cigar[c0:c1]
        cigar_off = reads.cigar_off[s0:s1 + 1] - c0
        seq = reads.seq[q0:q1]
        qual = reads.qual[q0:q1]
        seq_off = reads.seq_off[s0:s1 + 1] - q0
        names = reads.names[s0:s1] if reads.names else []
        sa_tags = reads.sa_tags[s0:s1] if reads.sa_tags else []
    else:
        cigar, cigar_off = _gather_ragged(reads.cigar, reads.cigar_off, sel)
        seq, seq_off = _gather_ragged(reads.seq, reads.seq_off, sel)
        qual, _ = _gather_ragged(reads.qual, reads.seq_off, sel)
        names = [reads.names[i] for i in sel] if reads.names else []
        sa_tags = [reads.sa_tags[i] for i in sel] if reads.sa_tags else []
    return bam_mod.RawReads(
        refid=reads.refid[sel], pos=reads.pos[sel], mapq=reads.mapq[sel],
        flag=reads.flag[sel], mrefid=reads.mrefid[sel], mpos=reads.mpos[sel],
        tlen=reads.tlen[sel], lseq=reads.lseq[sel],
        cigar=cigar, cigar_off=cigar_off, seq=seq, qual=qual, seq_off=seq_off,
        names=names, sa_tags=sa_tags,
        name_id=reads.name_id[sel] if reads.name_id is not None else None,
        name_len=reads.name_len[sel] if reads.name_len is not None else None,
    )



class _RdView:
    """Duck-typed ChromArrays view for _accumulate_rd_lists (py fallback)."""

    def __init__(self, rd_mq, rd_hi, rd_lo, L):
        self.rd_mq = rd_mq
        self.rd_hi = rd_hi
        self.rd_lo = rd_lo
        self.chr_len = L



def _rd_only_arrays(L, rd_mq, rd_hi, rd_lo) -> scan_mod.ChromArrays:
    z0 = np.zeros(0, np.int64)
    z4 = np.zeros((4, 0), np.int64)
    return scan_mod.ChromArrays(
        chr_len=L, rd_mq=rd_mq, rd_hi=rd_hi, rd_lo=rd_lo,
        one_base_rd=None, indel_sc_rd=None, sc_rd=None,
        snv=z4, snv_lowmq=z4, bq=z0, bq_all=z0, mq=z0, mq_all=z0,
        bq_read_count=z0, mq_read_count=z0, read_count_all=z0,
        pos_in_read=z4, fstrand=z4)



class _ChunkDetect:
    """Chunk-local detection pipeline for one chromosome: drained dense/
    evidence/tally windows go in (ascending, possibly partial ranges), the
    detector state machines advance, and only sparse candidates survive
    (the reference's insert-sized sliding window, src/GROM.c:5846-6402, at
    chunk granularity). The SV entries are scored by the device engines'
    scorer (ops/sv_device.py), or on the host."""

    def __init__(self, chrom, cfg, drv, mq_table, hez_table, scan_start,
                 engine="host", device="cuda"):
        from collections import deque

        from grom_tpu_torch.call import indel as indel_mod
        from grom_tpu_torch.call import sv as sv_mod
        self.chrom = chrom
        self.cfg = cfg
        self.drv = drv
        self.mq = mq_table
        self.hez = hez_table
        self.scan_start = scan_start
        L = len(chrom)
        self.sv = sv_mod.SvDetector(L, cfg, drv, mq_table, hez_table)
        self.indel = indel_mod.IndelDetector(L, cfg, drv, mq_table, hez_table)
        from grom_tpu_torch.ops.sv_device import maybe_scorer
        self.sv.scorer = maybe_scorer(engine, mq_table, hez_table, cfg, drv,
                                      device)
        self.snv_parts: List = []
        self.windows = deque()    # dicts: lo, hi, dense, ev, snv (arr|dev), bt
        self.det_lo = 0

    def add_window(self, lo, hi, dense, ev, snv_src, base_tot):
        self.windows.append(dict(lo=lo, hi=hi, dense=dense, ev=ev,
                                 snv=snv_src, bt=base_tot))

    def process(self, upper: int, scan_end: int) -> None:
        """Detect every position in [det_lo, upper) from the queued windows.
        ``upper`` must not exceed the drained bound; during streaming it is
        last_read_pos - IM + 1 (positions at or below that are guaranteed
        <= the final scan_end, so eager detection is exact)."""
        from grom_tpu_torch.utils.timing import phase
        while self.windows and self.det_lo < upper:
            w = self.windows[0]
            lo = max(w["lo"], self.det_lo)
            hi = min(w["hi"], upper)
            if hi > lo:
                head, w["ev"] = w["ev"].split(hi)
                with phase("call.snv"):
                    if isinstance(w["snv"], dict):
                        cand = snv_mod.candidates_from_device(
                            w["snv"], self.chrom, self.cfg, self.mq,
                            self.hez, self.scan_start, scan_end,
                            lo=lo, hi=hi)
                    else:
                        cand = snv_mod.detect_snv_candidates(
                            self.chrom, w["snv"], self.cfg, self.mq,
                            self.hez, self.scan_start, scan_end,
                            lo=lo, hi=hi)
                if len(cand):
                    self.snv_parts.append(cand)
                with phase("call.sv_detect"):
                    self.sv.run_chunk(head, w["dense"], lo, hi,
                                      self.scan_start, scan_end)
                with phase("call.indel"):
                    self.indel.run_chunk(head, w["dense"], lo, hi,
                                         w["bt"], w["dense"].base,
                                         self.scan_start, scan_end)
                self.det_lo = hi
            if w["hi"] <= upper:
                self.windows.popleft()    # fully consumed: free the arrays
            else:
                break


def _rd_window_spans(L: int, batch, eligible: np.ndarray, lo: int,
                     hi: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The spans ``scan._accumulate_rd_lists`` counts in the ingest chunk
    [lo, hi): eligible reads' spans kept on the whole-span rule against L,
    clipped to [lo, hi); (starts, ends) relative to ``lo``, and their
    reads' mapq."""
    sel = eligible[batch.span_read]
    ref = batch.span_ref[sel]
    ln = batch.span_len[sel]
    rid = batch.span_read[sel]
    ok = (ref >= 0) & (ref + ln < L)
    ref, ln, rid = ref[ok], ln[ok], rid[ok]
    mapq = batch.mapq[rid]
    s_cl = np.maximum(ref, lo)
    e_cl = np.minimum(ref + ln, hi)
    keep = e_cl > s_cl
    return s_cl[keep] - lo, e_cl[keep] - lo, mapq[keep]


def _accumulate_rd_window(rd_mq: np.ndarray, rd_hi: np.ndarray,
                          rd_lo: np.ndarray, L: int, batch,
                          eligible: np.ndarray, cfg: GromConfig, lo: int,
                          hi: int) -> None:
    """``scan._accumulate_rd_lists`` of the ingest chunk [lo, hi) into host
    lists in O(hi - lo + spans): the spans of ``_rd_window_spans``, their
    endpoint counts summed over the window only and added into the lists'
    window, where ``_accumulate_rd_lists`` sums over the whole chromosome
    (four [L] int64 arrays a list, each call). Every count is an integer,
    so the lists are the same. The torch engine adds the same spans into
    ``ops/state.py DepthLists`` on its device instead; this host form is
    the reference the tests hold it to."""
    s_cl, e_cl, mapq = _rd_window_spans(L, batch, eligible, lo, hi)
    hi_m = mapq >= cfg.min_mapq
    n = hi - lo

    def add_depth(out, starts, ends, weights=None):
        # the window's endpoint counts, summed in place (two [n] arrays at
        # a time) and added into out's window; mapq sums stay far below
        # 2^53, so the f64 counts and their running sums are exact
        d = np.bincount(starts, weights, minlength=n + 1)
        d -= np.bincount(ends, weights, minlength=n + 1)
        np.cumsum(d, out=d)
        np.add(out[lo:hi], d[:n], out=out[lo:hi], casting="unsafe")

    add_depth(rd_mq, s_cl, e_cl, mapq.astype(np.float64))
    add_depth(rd_hi, s_cl[hi_m], e_cl[hi_m])
    add_depth(rd_lo, s_cl[~hi_m], e_cl[~hi_m])


@functools.lru_cache(maxsize=None)
def _malloc_trim():
    """glibc's ``malloc_trim``, or None off glibc."""
    import ctypes
    try:
        return ctypes.CDLL(None).malloc_trim
    except (OSError, AttributeError):
        return None


def _release_free_heap() -> None:
    """Hand the free pages glibc's heap keeps back to the system
    (``malloc_trim(0)``). The port raises glibc's trim threshold to 1 GiB
    (``grom_tpu_torch/__init__.py _tune_malloc``), so the heap keeps what
    a detect sub-chunk's host work frees, resident, into the next one's:
    a device engine's scan calls this after each drained sub-chunk and
    each ingest chunk."""
    from grom_tpu_torch.utils.timing import phase
    trim = _malloc_trim()
    if trim is not None:
        with phase("scan.trim"):
            trim(0)


# A device engine's ingest chunk: at most half the host engine's default
# (GROM_TPU_CHUNK_BASES overrides both). Its scan holds the chunk it works
# on while the producer decodes the next one, and that fetch's decoded
# parts, their concatenation and the ingest pool's buffers all grow with
# the chunk: at 16 Mi they set its peak host memory, with torch's
# libraries resident beside them. Its detect sub-chunks stay 4 Mi.
DEVICE_CHUNK_BASES = 8 << 20


def _chunk_bases(L: int, device_engine: bool) -> Tuple[int, bool]:
    """``_auto_chunk_bases`` of the engine: a device engine's chunk capped
    at ``DEVICE_CHUNK_BASES`` unless GROM_TPU_CHUNK_BASES sets it."""
    C, force_async = _auto_chunk_bases(L)
    env = os.environ.get("GROM_TPU_CHUNK_BASES", "")
    if device_engine and not (env.isdigit() and int(env) > 0):
        C = min(C, DEVICE_CHUNK_BASES)
    return C, force_async


def call_chromosome_streamed(chrom: np.ndarray, refid: int, out_name: str,
                             cfg: GromConfig, drv: DerivedConfig,
                             mq_table: np.ndarray, hez_table: np.ndarray,
                             fetch, engine: Optional[str] = None,
                             chunk_bases: Optional[int] = None,
                             region_start: int = 0, device="cuda", mesh=None
                             ) -> Optional[Tuple[List[str], List[str]]]:
    """Bounded-memory per-chromosome calling: reads are fetched in
    genome-position INGEST chunks (``fetch(t0, t1) -> RawReads`` overlapping
    [t0, t1)), deposits/tallies are fed in DETECT sub-chunks, and detection
    runs chunk-locally with a one-sub-chunk lag — peak memory is
    O(ingest chunk) for reads plus O(detect chunk) for the dense evidence
    window, independent of chromosome length.

    On the device engines each detect sub-chunk is a device job of
    ``TorchAccumulator`` (torch: the tile kernel) or ``MeshAccumulator``
    (mesh: the tile kernel per cell, and the depth lists): ``prepare``d
    when the sub-chunk is fed, from one span index of its ingest chunk
    (``chunk``), so that the queued job holds its inputs on the device and
    no host read; ``launch``ed under the sub-chunk's gate once its deposits
    have drained. An ingest chunk's reads are freed once its last
    sub-chunk is fed. On the host engine the sub-chunks go through the
    native tally engine. The device engines keep the depth lists on their
    device through the scan (``ops/state.py DepthLists``) and copy them to
    the host once it has ended. Returns
    None when the deposit ring rejects the data (freak CIGARs) — the caller
    redoes the chromosome via the whole-batch path on the same engine."""
    from grom_tpu_torch.call.deposits import DepositsSession
    from grom_tpu_torch.utils.timing import carry, phase

    if engine is None:
        engine = resolve_engine()
    device_engine = engine in ("torch", "mesh")
    mesh_mode = engine == "mesh"
    L = len(chrom)
    if chunk_bases:
        C, force_async = chunk_bases, False
    else:
        C, force_async = _chunk_bases(L, device_engine)
    l0 = scan_mod.window_len_l0(cfg, drv)
    scan_start = (2 * l0) // 4 + 1
    if region_start > 0:
        scan_start = max(scan_start, region_start - cfg.sub_region_overlap)
    im = cfg.overlap_mult * drv.insert_max

    # the contig's set-up up to its first ingest chunk (driver.run's
    # contig.setup holds the wait for its sequence)
    with phase("contig.setup"):
        dep = DepositsSession(L, out_name, cfg, drv, scan_start,
                              windowed=True)
        D = int(os.environ.get("GROM_TPU_DETECT_BASES", str(4 << 20)))
        D = max(min(D, C), dep.back + dep.DRAIN_HALO + 1)
        C = max(C, D)

        acc, sv_dev = None, device
        # whole-chromosome per-base state is ONLY the depth lists (the
        # CNV engine's inputs — the reference holds the same,
        # src/GROM.c:6605-6664). A device engine holds them on its device
        # (the mesh engine's on its collective device) until the scan has
        # ended: on the host they would add 12 bytes a base to the scan
        # stage's peak
        lists = rd_mq = rd_hi = rd_lo = None
        if device_engine:
            acc, sv_dev = _accumulator(engine, device, mesh)
            from grom_tpu_torch.ops.state import DepthLists
            lists = DepthLists(L, acc.coll if mesh_mode else sv_dev)
            DEPTH_LISTS.append({"where": str(lists.device),
                                "card_bytes": lists.nbytes})
        else:
            rd_mq = np.zeros(L, np.int32)
            rd_hi = np.zeros(L, np.int32)
            rd_lo = np.zeros(L, np.int32)
            DEPTH_LISTS.append({"where": "host", "card_bytes": 0})
        # the device bytes the inputs of the queued jobs (prepared when
        # their detect sub-chunk is fed, not yet launched) hold now; the
        # record keeps their most so far as ``queued_peak``
        queued = 0
        rec = DEPTH_LISTS[-1]

        det = _ChunkDetect(chrom, cfg, drv, mq_table, hez_table, scan_start,
                           engine=engine, device=sv_dev)
    scan_native = None     # host tally engine pinned on first chunk
    skipped = 0
    last_pos = -1
    # (d0, d1, device job or None, host SNV band or None) fed but not yet
    # drained
    fed = []
    halo = dep.DRAIN_HALO

    def snv_chunk_arrays(d0, d1):
        band = d1 - d0 + halo
        z = lambda dt: np.zeros(band, dt)
        z4 = lambda dt: np.zeros((4, band), dt)
        return scan_mod.ChromArrays(
            chr_len=L, rd_mq=rd_mq, rd_hi=rd_hi, rd_lo=rd_lo,
            one_base_rd=None, indel_sc_rd=None, sc_rd=None,
            snv=z4(np.int32), snv_lowmq=z4(np.int32),
            bq=z(np.int32), bq_all=z(np.int32), mq=z(np.int32),
            mq_all=z(np.int32), bq_read_count=z(np.int32),
            mq_read_count=z(np.int32), read_count_all=z(np.int32),
            pos_in_read=z4(np.int32), fstrand=z4(np.int32), base=d0)

    def drain_one():
        """Drain + queue the oldest fed sub-chunk; run its device job."""
        nonlocal queued
        d0, d1, job, snv_src = fed.pop(0)
        with phase("scan.drain"):
            res = dep.drain(d1)
        if res is None:
            return False
        dense, ev = res
        n = d1 - d0
        if device_engine:
            bt = np.zeros(n, np.int64)
            if job is None:
                dev = {"n": 0}
            else:
                gate = dense.rd[:n].astype(np.int64) + dense.indel_sc_rd[:n]
                # the mesh engine also writes the depth lists of [d0, d1)
                rd_kw = dict(rd_out=lists) if mesh_mode else {}
                with phase("scan.device"), phase("scan.device.launch"):
                    dev = acc.launch(job, gate, base_tot_out=bt,
                                     gate_base=d0, base_tot_base=d0,
                                     **rd_kw)[1]
                queued -= job.nbytes
            det.add_window(d0, d1, dense, ev, dev, bt)
        else:
            arr_d = snv_src
            arr_d.one_base_rd = dense.rd
            arr_d.indel_sc_rd = dense.indel_sc_rd
            arr_d.sc_rd = dense.sc_rd
            bt = (arr_d.snv.sum(axis=0, dtype=np.int64)
                  + arr_d.snv_lowmq.sum(axis=0, dtype=np.int64))[:n]
            det.add_window(d0, d1, dense, ev, arr_d, bt)
        if last_pos >= 0:
            det.process(min(det.windows[-1]["hi"], last_pos - im + 1), L - 1)
        if device_engine:
            _release_free_heap()
        return True

    # chunk-level I/O–compute overlap: a daemon thread fetches chunk N+1
    # while chunk N computes (the reference's producer/consumer ring,
    # src/GROM.c:82-324, at chunk granularity)
    import queue
    import threading
    chunk_q: "queue.Queue" = queue.Queue(maxsize=1)
    ranges = [(t0, min(t0 + C, L)) for t0 in range(0, L, C)]
    sync = _sync_ingest() and not force_async
    # a device engine's producer decodes one chunk ahead of the main
    # thread, not two (one queued and one waiting to be): its process also
    # holds the previous chunk's last device job, and a second chunk ahead
    # set its peak host memory
    taken = threading.Semaphore(0) if device_engine else None

    def chunk_producer():
        try:
            for k, (f0, f1) in enumerate(ranges):
                if taken is not None and k > 0:
                    with phase("ingest.producer_wait"):
                        taken.acquire()
                with phase("ingest.read_bam"):
                    chunk_q.put((f0, f1, fetch(f0, f1)))
        except BaseException as exc:
            chunk_q.put(exc)

    if not sync:
        prod = threading.Thread(target=carry(chunk_producer),
                                name="grom-chunk-ingest", daemon=True)
        prod.start()

    for rng in ranges:
        if sync:
            with phase("ingest.read_bam"):
                item = (rng[0], rng[1], fetch(rng[0], rng[1]))
        else:
            with phase("ingest.wait"):
                item = chunk_q.get()
            if taken is not None:
                taken.release()
        if isinstance(item, BaseException):
            raise item
        t0, t1, creads = item
        if device_engine:
            # the chunk's reads live as long as ``creads`` and its batch,
            # not on into the wait for the next chunk
            item = None
        n = len(creads.pos)
        with phase("batch.build"):
            batch_all = (build_batch(creads, refid, cfg.min_mapq,
                                     cfg.add_factor, cfg.rmdup)
                         if n else None)
        if n:
            # ownership clip at BOTH edges: regional fetches are BGZF-block
            # granular, so a chunk's decode includes slack reads past t1 —
            # those belong to (and are re-fetched by) the next chunk
            i0 = int(np.searchsorted(creads.pos, t0, side="left"))
            i1 = int(np.searchsorted(creads.pos, t1, side="left")) \
                if t1 < L else n
            skipped += int(np.searchsorted(creads.pos[i0:i1], scan_start,
                                           side="left"))
            elig = batch_all.keep & (batch_all.pos >= scan_start)
            if device_engine:
                # one span index of the chunk for all its sub-chunks' jobs
                with phase("scan.device"), phase("scan.device.chunk"):
                    chunk = acc.chunk(batch_all, elig, t0, t1)
            else:
                span_end = batch_all.span_ref + batch_all.span_len
            if device_engine and not mesh_mode:
                # the torch engine adds the chunk's spans into its lists
                with phase("scan.accumulate"):
                    lists.add_window(t0, t1, *_rd_window_spans(
                        L, batch_all, elig, t0, t1), cfg.min_mapq)
        for d0 in range(t0, t1, D):
            d1 = min(d0 + D, t1)
            job = None
            if n:
                j0 = int(np.searchsorted(creads.pos, d0, side="left"))
                j0 = max(j0, i0)
                j1 = int(np.searchsorted(creads.pos, d1, side="left")) \
                    if d1 < L else n
                j1 = min(max(j1, j0), i1)
                with phase("scan.deposits"):
                    if not dep.feed(batch_all, j0, j1, d_chunk=D):
                        return None
                if j1 > j0:
                    last_pos = max(last_pos, int(creads.pos[j1 - 1]))
                snv_src = None
                if device_engine:
                    # the sub-chunk's inputs go to the device now: the
                    # queued job holds no host read
                    with phase("scan.device"), \
                            phase("scan.device.prepare"):
                        job = acc.prepare(chrom, chunk, cfg, d0, d1)
                    queued += job.nbytes
                    rec["queued_peak"] = max(rec.get("queued_peak", 0),
                                             queued)
                else:
                    arr_d = snv_chunk_arrays(d0, d1)
                    smask = (batch_all.span_ref < d1) & (span_end > d0)
                    with phase("scan.accumulate"):
                        if scan_native is None:
                            scan_native = scan_mod._accumulate_native(
                                arr_d, chrom, batch_all, elig, cfg,
                                lo=d0, hi=d1, finalize=False,
                                span_mask=smask)
                        elif scan_native:
                            if not scan_mod._accumulate_native(
                                    arr_d, chrom, batch_all, elig, cfg,
                                    lo=d0, hi=d1, finalize=False,
                                    span_mask=smask):
                                return None
                        if not scan_native:
                            scan_mod._accumulate_rd_lists(
                                _RdView(rd_mq, rd_hi, rd_lo, L), batch_all,
                                elig, cfg, lo=d0, hi=d1)
                            scan_mod._accumulate_snv(arr_d, chrom, batch_all,
                                                     elig, cfg, lo=d0, hi=d1)
                    snv_src = arr_d
            else:
                snv_src = None if device_engine else snv_chunk_arrays(d0, d1)
            # no queued entry holds the ingest chunk's reads: a host engine
            # never reads them back, a device job holds its inputs on the
            # device
            fed.append((d0, d1, job, snv_src))
            # drain with a one-sub-chunk lag: everything below the chunk
            # just fed is final (back-reach < D)
            while len(fed) > 1:
                if not drain_one():
                    return None
        # drop this chunk's decoded tensors NOW: the device path's queued
        # job (the chunk's last sub-chunk, drained after the next chunk's
        # first one is fed) holds its inputs on the device
        del creads
        batch_all = chunk = None
        if device_engine:
            _release_free_heap()

    while fed:
        if not drain_one():
            return None
    dep.close()

    scan_end = max(scan_start, last_pos - im) if last_pos >= 0 \
        else scan_start - 1
    det.process(scan_end + 1, scan_end)
    det.windows.clear()

    if not device_engine and scan_native:
        # deferred rd-list prefix sums (the native engine fed diffs)
        np.cumsum(rd_mq, out=rd_mq)
        np.cumsum(rd_hi, out=rd_hi)
        np.cumsum(rd_lo, out=rd_lo)
    if lists is not None:
        # the scan's chunks, batches and deposits are gone: the stages
        # after it read the lists on the host, as the host engine's
        if lists.device.type == "cuda":
            import torch
            DEPTH_LISTS[-1]["card_peak_scan"] = \
                torch.cuda.max_memory_allocated(lists.device)
        with phase("scan.rd_to_host"):
            rd_mq, rd_hi, rd_lo = lists.to_host()
        lists = None

    arr_fin = _rd_only_arrays(L, rd_mq, rd_hi, rd_lo)
    # hand ownership of the depth lists to arr_fin: the CNV stage releases
    # them (call_cnv release=) once it has folded them into depth/mq_mean
    del rd_mq, rd_hi, rd_lo
    with phase("call.snv"):
        cands = snv_mod.concat_candidates(det.snv_parts)
    return _finish_chromosome(chrom, arr_fin, cands, det.sv, det.indel,
                              out_name, cfg, drv, scan_start, scan_end,
                              skipped, engine=engine, device=sv_dev)


def _finish_chromosome(chrom, arr, cands, sv_det, ind_det, out_name,
                       cfg: GromConfig, drv: DerivedConfig,
                       scan_start: int, scan_end: int,
                       skipped: int, engine: str = "host", device="cuda"
                       ) -> Tuple[List[str], List[str]]:
    """Post-detection flush/clustering/emission: SNV flush filter, SV
    clustering, indel + CNV emission — shared by the whole-batch and
    streamed paths. ``arr`` needs only the whole-chromosome rd_* depth
    lists. Returns (vcf_rows, ctx_records) in the reference's emission
    order."""
    from grom_tpu_torch.call import indel as indel_mod
    from grom_tpu_torch.call import sv as sv_mod
    from grom_tpu_torch.utils.timing import phase

    with phase("call.snv"):
        keep = snv_mod.flush_filter(cands, chrom, arr, cfg, drv, scan_start,
                                    scan_end, skipped)
        rows = snv_mod.format_snv_rows(cands, keep, chrom, out_name, cfg,
                                       lseq=drv.read_len)

    with phase("call.sv_rows"):
        dup2 = sv_mod.cluster_paired(sv_det.dup_list, cfg, drv)
        del2 = sv_mod.cluster_paired(sv_det.del_list, cfg, drv)
        inv_f2 = sv_mod.cluster_paired(sv_det.inv_f_list, cfg, drv)
        inv_r2 = sv_mod.cluster_paired(sv_det.inv_r_list, cfg, drv)
        ins2 = sv_mod.cluster_ins(sv_det.ins_list, cfg, drv)
        ctx_f2 = sv_mod.cluster_ctx(sv_det.ctx_f_list, cfg, drv)
        ctx_r2 = sv_mod.cluster_ctx(sv_det.ctx_r_list, cfg, drv)

        ins_list, del_list, d_index = (ind_det.ins_list, ind_det.del_list,
                                       ind_det.d_index)

        rows.extend(sv_mod.format_dup_rows(out_name, dup2, cfg))
        rows.extend(sv_mod.format_inv_rows(out_name, inv_f2, inv_r2, arr,
                                           cfg, drv))
        rows.extend(sv_mod.format_ins_rows(out_name, ins2, cfg))
        ctx_records = sv_mod.format_ctx_records(out_name, ctx_f2, ctx_r2,
                                                cfg)
        rows.extend(indel_mod.format_indel_rows(chrom, out_name, ins_list,
                                                del_list, d_index, del2, cfg,
                                                drv))
        rows.extend(sv_mod.format_del_rows(out_name, del2, del_list, d_index,
                                           cfg, drv))

    from grom_tpu_torch.ingest.fasta import is_chrx
    from grom_tpu_torch.call import cnv as cnv_mod
    gen1000: List[str] = []
    with phase("call.cnv"):
        def _release_rd(a=arr):
            a.rd_hi = a.rd_lo = a.rd_mq = None
        rows.extend(cnv_mod.call_cnv(chrom, arr.rd_hi, arr.rd_lo, arr.rd_mq,
                                     cfg, drv, out_name, is_chrx(out_name),
                                     gen1000_out=gen1000, engine=engine,
                                     release=_release_rd, device=device))
    if cfg.gen1000_window > 0:
        # per-chromosome CN track file <out>.1000gen.<chr> (src/GROM.c:20246)
        with open("%s.1000gen.%s" % (cfg.out_vcf, out_name), "w") as f:
            for r in gen1000:
                f.write(r + "\n")
    return rows, ctx_records


def call_chromosome(chrom: np.ndarray, reads: bam_mod.RawReads,
                    sel: np.ndarray, refid: int, out_name: str,
                    cfg: GromConfig, drv: DerivedConfig,
                    mq_table: np.ndarray, hez_table: np.ndarray,
                    region_start: int = 0, engine: Optional[str] = None,
                    device="cuda", mesh=None) -> Tuple[List[str], List[str]]:
    """Whole-batch per-chromosome calling. Returns (vcf_rows, ctx_records)
    in the reference's emission order: SNV, DUP, INV, INS, INDEL_INS,
    INDEL_DEL, DEL (CNV rows are appended by the CNV engine)."""
    from grom_tpu_torch.call import indel as indel_mod
    from grom_tpu_torch.call import sv as sv_mod
    from grom_tpu_torch.call.deposits import run_deposits
    from grom_tpu_torch.utils.timing import phase

    with phase("batch.build"):
        sub = _subset_reads(reads, sel)
        batch = build_batch(sub, refid, cfg.min_mapq, cfg.add_factor, cfg.rmdup)
    scan_start, scan_end, skipped = scan_mod.scan_bounds(cfg, drv, sub.pos,
                                                         region_start)
    with phase("scan.deposits"):
        dense, ev = run_deposits(len(chrom), batch, out_name, cfg, drv,
                                 scan_start)

    if engine is None:
        engine = resolve_engine()
    base_tot = None
    sv_dev = device
    if engine in ("torch", "mesh"):
        acc, sv_dev = _accumulator(engine, device, mesh)
        eligible = batch.keep & (batch.pos >= scan_start)
        gate = dense.rd + dense.indel_sc_rd
        with phase("scan.device"):
            res = acc.run(chrom, batch, eligible, cfg, gate)
        base_tot, dev_cand = res[0], res[1]
        L = len(chrom)
        z0 = np.zeros(0, np.int64)
        z4 = np.zeros((4, 0), np.int64)
        arr = scan_mod.ChromArrays(
            chr_len=L, rd_mq=np.zeros(L, np.int32),
            rd_hi=np.zeros(L, np.int32), rd_lo=np.zeros(L, np.int32),
            one_base_rd=dense.rd, indel_sc_rd=dense.indel_sc_rd,
            sc_rd=dense.sc_rd,
            snv=z4, snv_lowmq=z4, bq=z0, bq_all=z0, mq=z0, mq_all=z0,
            bq_read_count=z0, mq_read_count=z0, read_count_all=z0,
            pos_in_read=z4, fstrand=z4)
        if engine == "mesh":
            # the depth lists came from the device with the cross-cell carry
            arr.rd_mq, arr.rd_hi, arr.rd_lo = res[2]
        else:
            scan_mod._accumulate_rd_lists(arr, batch, eligible, cfg)
        with phase("call.snv"):
            cands = snv_mod.candidates_from_device(
                dev_cand, chrom, cfg, mq_table, hez_table,
                scan_start, scan_end)
    else:
        with phase("scan.accumulate"):
            arr = scan_mod.accumulate_chromosome(chrom, batch, cfg, drv,
                                                 scan_start)
        arr.one_base_rd = dense.rd
        arr.indel_sc_rd = dense.indel_sc_rd
        arr.sc_rd = dense.sc_rd
        with phase("call.snv"):
            cands = snv_mod.detect_snv_candidates(chrom, arr, cfg, mq_table,
                                                  hez_table, scan_start,
                                                  scan_end)

    # detection via the chunk API with one whole-chromosome window
    from grom_tpu_torch.call.evidence import EvidenceChunk
    L = len(chrom)
    ev_chunk = EvidenceChunk.from_state(ev)
    sv_det = sv_mod.SvDetector(L, cfg, drv, mq_table, hez_table)
    from grom_tpu_torch.ops.sv_device import maybe_scorer
    sv_det.scorer = maybe_scorer(engine, mq_table, hez_table, cfg, drv,
                                 sv_dev)
    with phase("call.sv_detect"):
        sv_det.run_chunk(ev_chunk, dense, 0, L, scan_start, scan_end)
    ind_det = indel_mod.IndelDetector(L, cfg, drv, mq_table, hez_table)
    if base_tot is None:
        base_tot = (arr.snv.sum(axis=0, dtype=np.int64)
                    + arr.snv_lowmq.sum(axis=0, dtype=np.int64))
    with phase("call.indel"):
        ind_det.run_chunk(ev_chunk, dense, 0, L, base_tot, 0,
                          scan_start, scan_end)
    return _finish_chromosome(chrom, arr, cands, sv_det, ind_det, out_name,
                              cfg, drv, scan_start, scan_end, skipped,
                              engine=engine, device=sv_dev)
