"""grom_tpu_torch — the PyTorch + CUDA port of grom_tpu.

grom_tpu's calling path with its device kernels written by hand in CUDA C++
for Hopper (``csrc/``, sm_90a): the per-tile accumulate + SNV screen, the
three CNV kernels (z-scores, seed evaluation, null window model), the
caf_rd_* depth lists of the mesh engine (endpoint-delta scatter, carried
scan + histogram) and the SV evidence-entry scorer. Ingest, deposits,
detection tails and the writers are the port's own copies of grom_tpu's
JAX-free modules, under the same relative paths, and native.py builds the
port's own library from the C sources in native/. The port imports nothing
of grom_tpu. Output is byte-identical to the host engine.

Run it as ``python -m grom_tpu_torch -i x.bam -r x.fa -o out.vcf``;
GROM_TPU_TORCH_ENGINE=host|torch|mesh|auto selects the engine (driver.py);
GROM_TPU_EARLY=1 inflates the BAM while the package imports
(_earlyingest.py).
"""


def _tune_malloc() -> None:
    """Keep glibc from mmap()ing every large numpy buffer. The pileup path
    allocates/frees tens of ~50MB arrays per chromosome; with the default
    mmap threshold each one is a fresh anonymous mapping whose pages fault
    on first touch (and on some hosts that costs seconds per call). Raising
    M_MMAP_THRESHOLD/M_TRIM_THRESHOLD makes the heap retain and reuse those
    pages. Measured ~2x end-to-end on the 200kb fixture. No-op off glibc."""
    import ctypes
    import sys
    if not sys.platform.startswith("linux"):
        return
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        M_TRIM_THRESHOLD = -1
        M_MMAP_THRESHOLD = -3
        one_gib = 1 << 30
        libc.mallopt(M_MMAP_THRESHOLD, one_gib)
        libc.mallopt(M_TRIM_THRESHOLD, one_gib)
    except (OSError, AttributeError):
        pass


def _start_early_ingest() -> None:
    """With GROM_TPU_EARLY=1, start inflating the ``-i`` BAM of a CLI run
    on a thread (_earlyingest.py, stdlib + ctypes) while numpy and torch
    import, gated as grom_tpu/__init__.py gates it. grom_tpu's memory
    preheat and slab allocator are not ported."""
    import os
    import sys
    bam = None
    try:
        argv = sys.argv
        if "-i" in argv:
            cand = argv[argv.index("-i") + 1]
            if cand.endswith(".bam") and os.path.exists(cand):
                bam = cand
    except (ValueError, IndexError):
        bam = None
    if bam is not None and os.environ.get("GROM_TPU_EARLY", "0") == "1":
        from grom_tpu_torch import _earlyingest
        _earlyingest.start(bam)


_tune_malloc()
_start_early_ingest()

__version__ = "0.3.0"
