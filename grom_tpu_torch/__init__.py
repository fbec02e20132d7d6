"""grom_tpu_torch — the PyTorch + CUDA port of grom_tpu.

The streamed single-GPU calling path of grom_tpu with its device kernels
written by hand in CUDA C++ for Hopper (``csrc/``, sm_90a): the per-tile
accumulate + SNV screen and the three CNV kernels (z-scores, seed
evaluation, null window model). Ingest, deposits, detection tails and the
writers are grom_tpu's JAX-free layers, imported as they are. Output is
byte-identical to grom_tpu's host engine.

Run it as ``python -m grom_tpu_torch -i x.bam -r x.fa -o out.vcf``;
GROM_TPU_TORCH_ENGINE=host|torch|auto selects the engine (driver.py).
"""

__version__ = "0.1.0"
