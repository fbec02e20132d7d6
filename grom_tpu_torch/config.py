"""Run configuration for the TPU-native GROM-capability variant caller.

This is the idiomatic replacement for the reference's ~35 getopt single-letter
flags mapped onto ``g_*`` globals (reference: src/GROM.c:21908-22099 and the
defaults block src/GROM.c:625-980).  One frozen dataclass holds the user-facing
surface; ``DerivedConfig`` holds everything computed from the BAM's insert-size
distribution (reference: src/GROM.c:22260-22290).

Flag-name ↔ field mapping is kept in ``FLAG_MAP`` so the CLI (grom_tpu/cli.py)
exposes the exact same single-letter surface as the reference binary.
"""

from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class GromConfig:
    """User-facing flags. Defaults mirror src/GROM.c:625-980 (code wins over
    README where they disagree, e.g. -d: code g_min_disc=3, README says 2)."""

    # Required I/O (reference -i / -r / -o)
    bam: str = ""
    ref_fasta: str = ""
    out_vcf: str = ""

    # Sample / genome
    gender: int = 0                  # -g  0=female, 1=male (src/GROM.c g_gender)
    ploidy: int = 2                  # -p  g_ploidy

    # Quality thresholds
    min_base_qual: int = 20          # -b  g_min_base_qual
    min_mapq: int = 20               # -q  g_min_mapq (also g_rd_min_mapq; -Q is a no-op in the reference, src/GROM.c:22101-22102)

    # Probability thresholds
    pval_threshold: float = 0.001    # -v  g_pval_threshold
    pval_insertion: float = 1e-10    # -e  g_pval_insertion
    rd_pval_threshold: float = 1e-9  # -V  g_rd_pval_threshold (CNV)

    # SV / evidence thresholds
    min_disc: int = 3                # -d  g_min_disc (README says 2; code says 3)
    min_sv_ratio: float = 0.05       # -j  g_min_sv_ratio
    max_evidence_ratio: float = 0.25 # -u  g_max_evidence_ratio (weak/strong)
    max_ins_range: int = 10          # -w  g_max_ins_range
    max_split_loss: int = 20         # -y  g_max_split_loss (split-read gap/overlap)
    min_sr_len: int = 30             # -z  g_min_sr_len
    splitread: bool = True           # -S turns OFF (g_splitread)
    rmdup: bool = False              # -M  g_rmdup

    # SNV thresholds
    min_snv_ratio: float = 0.2       # -a  g_min_snv_ratio
    min_snv: int = 3                 # -n  g_min_snv
    min_ave_bq: float = 15.0         # -x  g_min_ave_bq

    # Indel thresholds
    max_homopolymer: int = 10        # -k  g_max_homopolymer
    min_indel_ratio: float = 0.125   # -m  g_min_indel_ratio

    # Insert size
    insert_num_st_devs: float = 3.0  # -s  g_insert_num_st_devs

    # CNV engine
    sampling_rate: int = 2           # -A  g_windows_sampling_factor
    min_repeat: int = 20             # -D  g_min_repeat (dinucleotide repeat min len)
    min_repeat_stdev: float = 1.5    # -E  g_min_repeat_stdev
    ranks_stdev: int = 1             # -K  g_ranks_stdev (1=rank-based variance)
    dup_threshold_factor: int = 2    # -L  g_dup_threshold_factor
    chr_rd_threshold_factor: int = 2 # -U  g_chr_rd_threshold_factor (excessive cov)
    min_rd_window_len: int = 100     # -W  g_min_rd_window_len
    max_rd_window_len: int = 10000   # -X  g_max_rd_window_len
    min_blocks: int = 4              # -Y  g_min_blocks
    block_unit_size: int = 10000     # -Z  g_block_unit_size
    gen1000_window: int = 0          # -N  g_1000gen_window (CN track window)

    # Capacity / internal
    max_chr_fasta_len: int = 300_000_000  # -B  g_max_chr_fasta_len
    sv_list_len: int = 1_000_000     # -G  g_sv_list_len
    overlap_mult: int = 1            # -l  g_overlap_mult
    mapq_factor: float = 0.5         # -F  g_mapq_factor (CNV mq weighting)
    sub_region_mb: int = 300         # -R  g_sub_region_size (Mb per shard)
    vcf_output: bool = True          # -f turns OFF (tabular mode, g_vcf)
    processes: int = 0               # -P  number of parallel workers (0 = serial)
    one_chromosome: str = ""         # -c  internal child region spec "chr,sub,start,end"
    sub_region_overlap: int = 10000  # g_sub_region_overlap (src/GROM.c:76)

    # Hard-coded reference constants we keep configurable (same defaults)
    max_trials: int = 1000                 # g_max_trials (binom table size)
    min_n_size: int = 100                  # g_min_n_size (N-block min span)
    sc_min: int = 1                        # g_sc_min
    min_mapq_sr: int = 20                  # g_min_mapq_sr
    snv_rd_min_factor: float = 1.75        # g_snv_rd_min_factor
    high_cov_min_snv_ratio: float = 0.4    # g_high_cov_min_snv_ratio
    max_inv_rd_diff: float = 1.75          # g_max_inv_rd_diff
    min_overlap_ratio: float = 0.5         # g_min_overlap_ratio
    indel_i_seq_len: int = 50              # g_indel_i_seq_len
    other_len: int = 50                    # g_other_len (per-base overflow slots)
    insert_sample_size: int = 10_000_000   # insert_sample_size
    insert_max_mult: int = 5               # g_insert_max_mult
    range_mult: float = 0.75               # g_range_mult (pairing window)
    sc_range: int = 35                     # g_sc_range (INS candidate spacing)
    max_rd_low_acgt_or_windows: float = 2.0  # g_max_rd_low_acgt_or_windows
    num_gc_bins: int = 101                 # g_num_gc_bins
    sample_lists_len: int = 100_000        # g_sample_lists_len
    add_factor: int = 6                    # cdp_add_factor for mq>=min_mapq (src/GROM.c:2548)

    # TPU execution parameters (no reference analogue)
    tile_size: int = 1 << 20         # genome tile length resident per device step
    reads_per_batch: int = 16384     # padded read-batch size
    max_read_len: int = 512          # padded per-read base capacity
    devices: Optional[int] = None    # cap device count (None = all)

    def replace(self, **kw) -> "GromConfig":
        return dataclasses.replace(self, **kw)

    @property
    def pval_threshold1(self) -> float:
        # src/GROM.c:22101 — g_pval_threshold1 = g_pval_threshold
        return self.pval_threshold

    @property
    def pval_insertion1(self) -> float:
        # src/GROM.c:22103-analog — g_pval_insertion1 stays at its 0.01
        # default (only -e changes g_pval_insertion, src/GROM.c:944-945)
        return 0.01

    def range_mult_tol(self, drv) -> float:
        """0.75*(insert_max - insert_min): the breakpoint pairing half-window
        (src/GROM.c:12609-12610)."""
        return self.range_mult * (drv.insert_max - drv.insert_min)

    @property
    def mq_prob(self) -> float:
        # src/GROM.c:21614 — 10^(-min_mapq/10)
        return 10.0 ** (-self.min_mapq / 10.0)

    @property
    def prob2(self) -> float:
        """Two-sided normal tail prob for ``insert_num_st_devs`` SDs, via the
        same Abramowitz-Stegun erf polynomial the reference uses
        (src/GROM.c:21589-21626)."""
        from grom_tpu_torch.stats.normal import erf_as
        xc = self.insert_num_st_devs / math.sqrt(2.0)
        return (1.0 - erf_as(xc)) / 2.0

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=1, sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "GromConfig":
        return GromConfig(**json.loads(s))


@dataclass(frozen=True)
class DerivedConfig:
    """Quantities derived from the BAM (reference src/GROM.c:22260-22290)."""

    insert_mean: int         # median insert of proper pairs
    insert_min: int          # concordant insert lower cut
    insert_max: int          # concordant insert upper cut
    read_len: int            # g_lseq: max sampled read length
    mapped_reads: int        # g_mapped_reads

    # Window geometry (g_one_base_rd_len etc.)
    one_base_rd_len: int = 0
    gc_window: int = 0       # 2*insert_mean - 1 triangular GC window span

    @staticmethod
    def from_insert_stats(cfg: GromConfig, insert_mean: int, insert_min: int,
                          insert_max: int, read_len: int,
                          mapped_reads: int) -> "DerivedConfig":
        # src/GROM.c:22260-22262: insert mean is clamped to >= read length
        if insert_mean < read_len:
            insert_mean = read_len
        # src/GROM.c:22282-22290: window = 2*8*overlap_mult*max(2*mean-1, max+1)
        base = max(2 * insert_mean - 1, insert_max + 1)
        one_base_rd_len = 2 * 8 * cfg.overlap_mult * base
        return DerivedConfig(
            insert_mean=insert_mean,
            insert_min=insert_min,
            insert_max=insert_max,
            read_len=read_len,
            mapped_reads=mapped_reads,
            one_base_rd_len=one_base_rd_len,
            gc_window=2 * insert_mean - 1,
        )


# CLI flag ↔ field map (reference getopt string src/GROM.c:21908)
FLAG_MAP = {
    "i": ("bam", str),
    "r": ("ref_fasta", str),
    "o": ("out_vcf", str),
    "g": ("gender", int),
    "p": ("ploidy", int),
    "b": ("min_base_qual", int),
    "q": ("min_mapq", int),
    "v": ("pval_threshold", float),
    "e": ("pval_insertion", float),
    "V": ("rd_pval_threshold", float),
    "d": ("min_disc", int),
    "j": ("min_sv_ratio", float),
    "u": ("max_evidence_ratio", float),
    "w": ("max_ins_range", int),
    "y": ("max_split_loss", int),
    "z": ("min_sr_len", int),
    "a": ("min_snv_ratio", float),
    "n": ("min_snv", int),
    "x": ("min_ave_bq", float),
    "k": ("max_homopolymer", int),
    "m": ("min_indel_ratio", float),
    "s": ("insert_num_st_devs", float),
    "A": ("sampling_rate", int),
    "D": ("min_repeat", int),
    "E": ("min_repeat_stdev", float),
    "K": ("ranks_stdev", int),
    "L": ("dup_threshold_factor", int),
    "U": ("chr_rd_threshold_factor", int),
    "W": ("min_rd_window_len", int),
    "X": ("max_rd_window_len", int),
    "Y": ("min_blocks", int),
    "Z": ("block_unit_size", int),
    "N": ("gen1000_window", int),
    "B": ("max_chr_fasta_len", int),
    "G": ("sv_list_len", int),
    "l": ("overlap_mult", int),
    "F": ("mapq_factor", float),
    "R": ("sub_region_mb", int),
    "P": ("processes", int),
    "c": ("one_chromosome", str),
}

# Boolean toggles (no argument)
TOGGLE_MAP = {
    "M": ("rmdup", True),      # turn ON duplicate filtering
    "S": ("splitread", False), # turn OFF split-read analysis
    "f": ("vcf_output", False),# tabular output mode
}
