"""Command line of the port, run through the port's driver. Invoke as
``python -m grom_tpu_torch``.

The flag surface is a copy of grom_tpu/cli.py (``_GETOPT``, ``HELP``,
``parse_args``), mirroring the reference binary's flags
(src/GROM.c:21908-22099). ``-c`` (child region) runs the whole-batch path.

``-P N`` (N > 1) is grom_tpu's chromosome-parallel mode (``split_regions``,
``run_parallel``): a spawn pool of N workers, largest chromosome first, a
job per chromosome or per ``-R`` sub-region, rows merged in header order.
The parent resolves the engine once and builds the kernel libraries and
the native library before it spawns. Each worker runs that engine on one
device: worker k of N on card k mod n of the n visible cards (``deal``),
its card memory capped at its share of the card
(``torch.cuda.set_per_process_memory_fraction``); the mesh engine runs a
1x1 grid on the worker's card. Each job reports its device, its kernel
launches and its peak card memory, and the parent adds the launches into
``_build.LAUNCHES``.
"""

from __future__ import annotations

import getopt
import io
import json
import multiprocessing
import os
import resource
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

from grom_tpu_torch.config import FLAG_MAP, TOGGLE_MAP, GromConfig

# -Q (CNV mapq) is accepted but a no-op like the reference: g_rd_min_mapq is
# unconditionally overwritten by g_min_mapq after getopt (src/GROM.c:21965-21967,
# :22101-22102)
_GETOPT = "i:r:o:g:p:b:q:Q:v:e:V:d:j:u:w:y:z:a:n:x:k:m:s:A:D:E:K:L:U:W:X:Y:Z:N:B:G:l:F:R:P:c:MSfh"

HELP = """GROM-TPU — TPU-native integrated variant caller (SNV/indel/SV/CNV)

Usage: grom-tpu -i <bam> -r <fasta> -o <out.vcf> [options]

Required:
  -i FILE   coordinate-sorted, indexed BAM
  -r FILE   reference FASTA
  -o FILE   output VCF (translocations go to <out>.ctx.vcf)

Common options (defaults mirror the reference, code over README):
  -M        enable duplicate-read filtering            [off]
  -S        disable split-read analysis                [on]
  -g INT    gender: 0 female, 1 male                   [0]
  -p INT    ploidy                                     [2]
  -P INT    process chromosomes in parallel with N workers
  -b INT    min base quality                           [20]
  -q INT    min mapping quality                        [20]
  -v FLOAT  probability threshold (SNV/indel/SV)       [0.001]
  -e FLOAT  probability threshold for insertions       [1e-10]
  -V FLOAT  probability threshold for CNVs             [1e-9]
  -d INT    min reads supporting a breakpoint          [3]
  -a/-n/-x  SNV ratio / min reads / min avg bq         [0.2 / 3 / 15]
  -j/-u     SV ratio / max weak-evidence ratio         [0.05 / 0.25]
  -k/-m     max homopolymer / min indel ratio          [10 / 0.125]
  -w/-y/-z  ins-range / split loss / min split length  [10 / 20 / 30]
  -s FLOAT  SDs for insert-size concordance            [3]
  CNV: -A sampling  -D/-E repeat len/SD  -K ranks  -L dup-cov
       -U excessive-cov  -W/-X window min/max  -Y blocks  -Z block size
  Internal/undocumented (kept for parity): -B max chr len, -G list size,
       -l overlap mult, -F mapq factor, -N 1000genomes window,
       -R sub-region Mb, -c chr,sub,start,end, -f tabular output
"""


def parse_args(argv: List[str]) -> Optional[GromConfig]:
    try:
        opts, _ = getopt.getopt(argv, _GETOPT)
    except getopt.GetoptError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return None
    cfg = GromConfig()
    kw = {}
    for flag, val in opts:
        f = flag.lstrip("-")
        if f == "h":
            print(HELP)
            return None
        if f in TOGGLE_MAP:
            field, value = TOGGLE_MAP[f]
            kw[field] = value
        elif f in FLAG_MAP:
            field, typ = FLAG_MAP[f]
            kw[field] = typ(val)
    cfg = cfg.replace(**kw)
    if not cfg.bam:
        print("ERROR: No bam file specified.", file=sys.stderr)
        return None
    if not cfg.ref_fasta:
        print("ERROR: No reference file specified.", file=sys.stderr)
        return None
    if not cfg.out_vcf:
        print("ERROR: No output file specified.", file=sys.stderr)
        return None
    return cfg


def split_regions(ref_len: int, cfg) -> List:
    """Sub-region splits for one chromosome, mirroring the reference's
    launch loop (src/GROM.c:557-566): regions of -R Mb with a 10kb overlap
    on each region's end; the last region absorbs up to 1.25x a region."""
    S = cfg.sub_region_mb * 1_000_000
    if S <= 0:
        return [(0, 0, ref_len)]
    out = []
    size = ref_len
    sub = 0
    while size > 0:
        start = sub * S
        if size > S // 4 * 5:
            end = (sub + 1) * S + cfg.sub_region_overlap
            size -= S
        else:
            end = start + size
            size = 0
        out.append((sub, start, end))
        sub += 1
    return out


# card share left to each worker's CUDA context, outside the memory cap
CONTEXT_SHARE = 0.01


def deal(n_workers: int, devices: Sequence[str]
         ) -> List[Tuple[str, Optional[float]]]:
    """(device, card memory share) of each of ``n_workers`` workers: worker
    k runs on ``devices[k % len(devices)]``; on a CUDA device its share is
    one over the number of workers dealt to that device, less
    CONTEXT_SHARE; on the CPU it is None (no cap)."""
    on = [devices[k % len(devices)] for k in range(n_workers)]
    return [(d, 1.0 / on.count(d) - CONTEXT_SHARE
             if d.startswith("cuda") else None) for d in on]


# this pool worker's engine, device and grid, set by _init_worker
_WORKER: Dict[str, object] = {}


def _init_worker(counter, n_workers: int, devices: Sequence[str],
                 engine: str) -> None:
    """Pool initializer: take the next worker number k from the shared
    counter and fix this worker's device before anything touches CUDA:
    ``deal``'s device k becomes the current CUDA device, and the caching
    allocator is capped at the worker's share of it. If this raises, the
    pool breaks and the parent's ``map`` raises."""
    from grom_tpu_torch.utils import peakmem
    peakmem.start()
    with counter.get_lock():
        k = counter.value
        counter.value += 1
    device, share = deal(n_workers, devices)[k % n_workers]
    if share is not None:
        import torch
        torch.cuda.set_device(device)
        torch.cuda.set_per_process_memory_fraction(share, device)
    mesh = None
    if engine == "mesh":
        from grom_tpu_torch.parallel.mesh import make_mesh
        mesh = make_mesh(1, 1, devices=[device], group=None)
    _WORKER.update(engine=engine, device=device, mesh=mesh, share=share)


def _run_one_chromosome(args):
    """Worker: call one chromosome (or one sub-region of it) on this
    worker's engine and device. Rows stream to an on-disk part file (the
    reference's per-child ``out.vcf.<chr>-<n>`` files,
    src/GROM.c:20678-20693) so the parent never buffers a chromosome's
    records in memory; ctx candidate records (sparse) come back directly
    for the global merge. Returns ((refid, sub), part_path, n_rows,
    ctx_records, report): the report holds the job (refid, sub), the
    worker's pid, engine and device, the job's kernel launches
    (``_build.LAUNCHES``), its peak card memory allocated and reserved
    (``torch.cuda.max_memory_allocated``/``max_memory_reserved``; None off
    the card) and the worker's share of its card (``deal``), its wall and
    CPU seconds, the worker's peak resident host memory in KiB
    (``utils/peakmem.py``; ``getrusage``'s ru_maxrss would not do: a
    spawned worker inherits its parent's across the exec) and its label
    (``rss_source``: ``vmhwm`` or ``sampled``), whether the worker has
    loaded torch (``torch_loaded``: a host-engine worker with no stage on
    the device loads none), the pinned host memory of torch's caching
    host allocator (``pinned``), where the job's depth lists lived
    through the scan (``depth_lists``) and the device bytes its queued
    device jobs' inputs held at most (``queued_jobs``), and under
    GROM_TPU_TIMING=1 the wall seconds of the job's timed phases
    (``phases``), the worker's peak RSS at each one's last end
    (``phase_rss_kib``) and the card's running peak there
    (``phase_card_bytes``)."""
    cfg_json, refid, sub, rstart, rend, part_path = args
    engine, device, mesh = (_WORKER["engine"], _WORKER["device"],
                            _WORKER["mesh"])
    on_card = device.startswith("cuda")
    import numpy as np

    from grom_tpu_torch import _build, driver
    from grom_tpu_torch.config import DerivedConfig, GromConfig
    from grom_tpu_torch.driver import call_chromosome, call_chromosome_streamed
    from grom_tpu_torch.ingest import bam as bam_mod
    from grom_tpu_torch.ingest import fasta as fasta_mod
    from grom_tpu_torch.ingest.insert_size import load_or_estimate
    from grom_tpu_torch.stats import binom
    from grom_tpu_torch.utils import timing

    start = time.perf_counter()
    ru0 = resource.getrusage(resource.RUSAGE_SELF)
    _build.reset_launches()
    driver.DEPTH_LISTS.clear()
    timing.reset()
    if on_card:
        import torch
        torch.cuda.reset_peak_memory_stats(device)

    def report():
        from grom_tpu_torch.utils import peakmem
        ru = resource.getrusage(resource.RUSAGE_SELF)
        card = peakmem.card_peak([device]) or {}
        rss, source = peakmem.host_peak()
        rep = {"job": [refid, sub], "pid": os.getpid(), "engine": engine,
               "device": device,
               "launches": dict(_build.LAUNCHES),
               "max_memory_allocated": card.get("max_allocated"),
               "max_memory_reserved": card.get("max_reserved"),
               "memory_share": _WORKER.get("share"),
               "wall_s": time.perf_counter() - start,
               "cpu_s": (ru.ru_utime - ru0.ru_utime
                         + ru.ru_stime - ru0.ru_stime),
               "max_rss_kib": rss, "rss_source": source,
               "torch_loaded": "torch" in sys.modules,
               "pinned": peakmem.pinned_host([device]),
               "depth_lists": driver.depth_lists_report(),
               "queued_jobs": driver.queued_jobs_report()}
        if timing.timing_enabled():
            snap = timing.report(file=io.StringIO())
            rep["phases"] = {k: v.wall for k, v in snap.items()}
            rep["phase_rss_kib"] = driver.phase_rss_kib(snap)
            rep["phase_card_bytes"] = driver.phase_card_bytes(snap)
        return rep

    cfg = GromConfig.from_json(cfg_json)
    info = fasta_mod.index_fasta(cfg.ref_fasta)
    key = (refid, sub)
    ins = load_or_estimate(cfg.bam, None, cfg)
    drv = DerivedConfig.from_insert_stats(cfg, ins.insert_mean, ins.insert_min,
                                          ins.insert_max, ins.read_len,
                                          ins.mapped_read_bases)
    header = driver.bam_header(cfg.bam)
    bam_name = header.ref_names[refid]
    fa_name = fasta_mod.match_chromosome(bam_name, info.names)
    if fa_name is None:
        return key, None, 0, [], report()
    out_name = fa_name.lower()
    if fasta_mod.is_chry(fa_name) and cfg.gender == 0:
        return key, None, 0, [], report()
    mq_table = binom.build_mq_table(cfg.min_mapq if cfg.min_mapq > 10 else 10,
                                    cfg.max_trials)
    hez_table = binom.build_hez_table(cfg.max_trials)
    chrom = fasta_mod.load_chromosome(cfg.ref_fasta, info, fa_name)
    engine_kw = dict(engine=engine, device=device, mesh=mesh)
    res = None
    if rstart is None:
        # whole chromosome: bounded-memory chunked streaming, as the serial
        # driver runs it
        def fetch(t0, t1):
            return bam_mod.read_bam_region(cfg.bam, refid, t0, t1)[1]
        res = call_chromosome_streamed(chrom, refid, out_name, cfg, drv,
                                       mq_table, hez_table, fetch,
                                       **engine_kw)
    if res is None:
        # sub-region job (-R split) or streamed-path rejection: regional
        # whole-batch fallback
        if rstart is None:
            _, reads = bam_mod.read_bam_region(cfg.bam, refid)
            sel = np.arange(len(reads))
            region_start = 0
        else:
            _, reads = bam_mod.read_bam_region(cfg.bam, refid,
                                               max(rstart, 0), rend)
            ends = bam_mod.alignment_ends(reads)
            sel = np.flatnonzero((reads.pos < rend - 1) & (ends > rstart))
            region_start = rstart
        res = call_chromosome(chrom, reads, sel, refid, out_name, cfg, drv,
                              mq_table, hez_table, region_start=region_start,
                              **engine_kw)
    rows, ctx = res
    with open(part_path, "w") as f:
        for r in rows:
            f.write(r if r.endswith("\n") else r + "\n")
    return key, part_path, len(rows), ctx, report()


def run_parallel(cfg: GromConfig, engine: Optional[str] = None,
                 devices: Optional[Sequence[str]] = None) -> List[dict]:
    """-P mode: chromosome-level parallelism via a spawn pool of
    ``cfg.processes`` workers (grom_tpu/cli.py ``run_parallel``, the
    replacement of the reference's fork/execv scheduler,
    src/GROM.c:354-624). Output order stays deterministic (BAM header
    order).

    ``engine`` defaults to ``resolve_engine()``, resolved here once, so
    ``auto`` without a card raises before any worker starts. The workers of
    a device engine, and of the host engine when GROM_TPU_DEVICE_CNV=1 or
    GROM_TPU_DEVICE_SV=1 puts a stage on the device
    (``driver.device_stages``), are dealt over ``devices`` (default: every
    visible CUDA card; ``["cpu"]`` runs the plain versions of the
    kernels); the parent builds the kernel libraries before it spawns and
    creates no CUDA context. Otherwise the host engine's workers run on the
    CPU. Returns each job's report (``_run_one_chromosome``), in header
    order, and adds the jobs' launches into ``_build.LAUNCHES``."""
    from grom_tpu_torch import _build, native
    from grom_tpu_torch.call.ctx import write_ctx_vcf
    from grom_tpu_torch.config import DerivedConfig
    from grom_tpu_torch.driver import (_ctx_path, bam_header, check_device,
                                       device_stages, resolve_engine)
    from grom_tpu_torch.ingest.insert_size import load_or_estimate
    from grom_tpu_torch.vcfio.writer import VcfWriter

    if engine is None:
        engine = resolve_engine()
    if not device_stages(engine):
        devices = ["cpu"]
    else:
        if devices is None:
            # no CUDA context: device_count does not create one (with no
            # card, check_device raises on "cuda")
            import torch
            devices = ["cuda:%d" % i
                       for i in range(torch.cuda.device_count())] or ["cuda"]
        devices = [str(d) for d in devices]
        for d in devices:
            check_device(engine, d)
        if any(d.startswith("cuda") for d in devices):
            _build.build_all()
    native.get_lib()

    header = bam_header(cfg.bam)
    if os.path.exists(cfg.bam + ".bai"):
        # bounded-memory insert estimation (stops at the 10M-record sample);
        # writes the cache the workers read
        from grom_tpu_torch.driver import _streaming_insert_stats
        ins = _streaming_insert_stats(cfg, header)
    else:
        ins = load_or_estimate(cfg.bam, None, cfg)
    drv = DerivedConfig.from_insert_stats(cfg, ins.insert_mean, ins.insert_min,
                                          ins.insert_max, ins.read_len,
                                          ins.mapped_read_bases)
    jobs = []
    # largest-chromosome-first scheduling for load balance
    # (src/GROM.c:22318-22336); output order stays header order via the sort
    # over results below
    order = sorted(range(header.n_ref),
                   key=lambda r: -int(header.ref_lengths[r]))
    for refid in order:
        regs = split_regions(header.ref_lengths[refid], cfg)
        if len(regs) <= 1:
            # single region == whole chromosome: identical to serial
            jobs.append((cfg.to_json(), refid, 0, None, None,
                         "%s.part.%d-0" % (cfg.out_vcf, refid)))
        else:
            for sub, start, end in regs:
                jobs.append((cfg.to_json(), refid, sub, start, end,
                             "%s.part.%d-%d" % (cfg.out_vcf, refid, sub)))
    # a worker that dies or fails to start breaks the pool, and map raises
    # (a multiprocessing.Pool would replace it and wait forever); a failed
    # job cancels the jobs not yet started
    ctx = multiprocessing.get_context("spawn")
    counter = ctx.Value("i", 0)
    with ProcessPoolExecutor(cfg.processes, mp_context=ctx,
                             initializer=_init_worker,
                             initargs=(counter, cfg.processes, devices,
                                       engine)) as pool:
        try:
            results = list(pool.map(_run_one_chromosome, jobs))
        except BaseException:
            pool.shutdown(cancel_futures=True)
            raise
    results.sort(key=lambda t: t[0])
    prelude = None
    if not cfg.vcf_output:
        from grom_tpu_torch.vcfio.tabular import main_prelude
        prelude = main_prelude(drv.insert_mean, drv.insert_min,
                               drv.insert_max, drv.read_len)
    writer = VcfWriter(cfg.out_vcf, cfg.ref_fasta, prelude=prelude)
    all_ctx = []
    for _, part, _n, ctx_recs, rep in results:
        if part is not None:
            writer.append_file(part)
            os.remove(part)
        all_ctx.extend(ctx_recs)
        for k, n in rep["launches"].items():
            _build.LAUNCHES[k] += n
    writer.close()
    write_ctx_vcf(_ctx_path(cfg.out_vcf), all_ctx, header.ref_names, cfg, drv)
    return [r[4] for r in results]


def _print_parallel_stats(reports: List[dict]) -> None:
    """Under GROM_TPU_TIMING=1, on stderr: one ``parallel_job {...}`` JSON
    line a job report, then the parent's ``launches`` (summed over the
    jobs) and ``peak_memory`` lines, as the serial driver prints its own."""
    from grom_tpu_torch import _build
    from grom_tpu_torch.utils import peakmem, timing
    if not timing.timing_enabled():
        return
    for rep in reports:
        print("parallel_job " + json.dumps(rep), file=sys.stderr)
    print("launches " + json.dumps(dict(_build.LAUNCHES)), file=sys.stderr)
    print("peak_memory " + json.dumps(peakmem.report()), file=sys.stderr,
          flush=True)


def main(argv: Optional[List[str]] = None) -> int:
    """The command line: one ``run`` span (``utils/timing.py``) around the
    whole call, which ends with the process's anonymous resident bytes
    (``anon_bytes``)."""
    from grom_tpu_torch.utils import peakmem, timing
    with timing.phase("run") as span:
        rc = _main(argv)
        if timing.timing_enabled():
            span.set(anon_bytes=peakmem.anon_bytes())
    return rc


def _main(argv: Optional[List[str]]) -> int:
    cfg = parse_args(sys.argv[1:] if argv is None else argv)
    if cfg is None:
        return 1
    from grom_tpu_torch.utils import peakmem, timing
    if timing.timing_enabled():
        peakmem.start()
    try:
        if cfg.processes > 1:
            reports = run_parallel(cfg)
            _print_parallel_stats(reports)
        else:
            from grom_tpu_torch.driver import run
            run(cfg)
    except FileNotFoundError as exc:
        # clean message instead of a traceback (the reference prints
        # "Error opening file %s", src/GROM.c:22116-22143)
        print("Error opening file %s" % (exc.filename or exc))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
