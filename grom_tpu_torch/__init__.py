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
GROM_TPU_TORCH_ENGINE=host|torch|mesh|auto selects the engine (driver.py).
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


_tune_malloc()

__version__ = "0.3.0"
