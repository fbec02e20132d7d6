"""Shared fixture-loading helpers for the differential tests and the
multi-host worker: one call builds everything the per-base engines need for
the first contig of a committed fixture."""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np

from grom_tpu_torch.config import DerivedConfig, GromConfig


class ChromInputs(NamedTuple):
    chrom: np.ndarray
    batch: object
    eligible: np.ndarray
    gate: np.ndarray
    dense: object
    cfg: GromConfig
    drv: DerivedConfig
    scan_start: int
    scan_end: int


def chrom_inputs(fixture_dir: str, **cfg_kw) -> ChromInputs:
    """(chrom, batch, eligible, gate, dense deposits, cfg, drv, scan bounds)
    for the first contig of a fixture directory containing ds.bam / ds.fa."""
    from grom_tpu_torch.call import scan as scan_mod
    from grom_tpu_torch.call.deposits import run_deposits
    from grom_tpu_torch.driver import _subset_reads
    from grom_tpu_torch.ingest import bam as bam_mod
    from grom_tpu_torch.ingest import fasta as fasta_mod
    from grom_tpu_torch.ingest.batches import build_batch
    from grom_tpu_torch.ingest.insert_size import load_or_estimate

    cfg = GromConfig(bam=os.path.join(fixture_dir, "ds.bam"),
                     ref_fasta=os.path.join(fixture_dir, "ds.fa"),
                     out_vcf="/tmp/x.vcf", **cfg_kw)
    info = fasta_mod.index_fasta(cfg.ref_fasta)
    header, reads = bam_mod.read_bam(cfg.bam)
    ins = load_or_estimate(cfg.bam, reads, cfg)
    drv = DerivedConfig.from_insert_stats(cfg, ins.insert_mean,
                                          ins.insert_min, ins.insert_max,
                                          ins.read_len, ins.mapped_read_bases)
    fa = fasta_mod.match_chromosome(header.ref_names[0], info.names)
    chrom = fasta_mod.load_chromosome(cfg.ref_fasta, info, fa)
    sub = _subset_reads(reads, np.flatnonzero(reads.refid == 0))
    batch = build_batch(sub, 0, cfg.min_mapq, cfg.add_factor, cfg.rmdup)
    scan_start, scan_end, _ = scan_mod.scan_bounds(cfg, drv, sub.pos, 0)
    dense, _ = run_deposits(len(chrom), batch, fa.lower(), cfg, drv,
                            scan_start)
    eligible = batch.keep & (batch.pos >= scan_start)
    gate = dense.rd + dense.indel_sc_rd
    return ChromInputs(chrom, batch, eligible, gate, dense, cfg, drv,
                       scan_start, scan_end)
