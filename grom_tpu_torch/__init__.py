"""grom_tpu_torch — the PyTorch + CUDA port of grom_tpu.

grom_tpu's calling path with its device kernels written by hand in CUDA C++
for Hopper (``csrc/``, sm_90a): the per-tile accumulate + SNV screen, the
three CNV kernels (z-scores, seed evaluation, null window model), the
caf_rd_* depth lists of the mesh engine (endpoint-delta scatter, carried
scan + histogram) and the SV evidence-entry scorer. Ingest, deposits,
detection tails and the writers are grom_tpu's JAX-free layers, imported as
they are. Output is byte-identical to grom_tpu's host engine.

Run it as ``python -m grom_tpu_torch -i x.bam -r x.fa -o out.vcf``;
GROM_TPU_TORCH_ENGINE=host|torch|mesh|auto selects the engine (driver.py).
"""

__version__ = "0.2.0"
