"""Command line of the port, run through the port's driver. Invoke as
``python -m grom_tpu_torch``.

The flag surface is a copy of grom_tpu/cli.py (``_GETOPT``, ``HELP``,
``parse_args``), mirroring the reference binary's flags
(src/GROM.c:21908-22099). ``-c`` (child region) runs the whole-batch path;
``-P N`` with N > 1 is not ported yet and exits with an error.
"""

from __future__ import annotations

import getopt
import sys
from typing import List, Optional

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


def main(argv: Optional[List[str]] = None) -> int:
    cfg = parse_args(sys.argv[1:] if argv is None else argv)
    if cfg is None:
        return 1
    if cfg.processes > 1:
        print("ERROR: -P %d (parallel chromosome workers) is not yet ported "
              "to grom_tpu_torch; run without -P, or use python -m grom_tpu"
              % cfg.processes, file=sys.stderr)
        return 2
    from grom_tpu_torch.driver import run
    try:
        run(cfg)
    except FileNotFoundError as exc:
        # clean message instead of a traceback (the reference prints
        # "Error opening file %s", src/GROM.c:22116-22143)
        print("Error opening file %s" % (exc.filename or exc))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
