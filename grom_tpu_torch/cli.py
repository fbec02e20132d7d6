"""Command line of the port: grom_tpu's getopt surface
(``grom_tpu.cli.parse_args``), run through the port's driver. Invoke as
``python -m grom_tpu_torch``.

``-c`` (child region) runs the whole-batch path; ``-P N`` with N > 1 is not
ported yet and exits with an error.
"""

from __future__ import annotations

import sys
from typing import List, Optional

from grom_tpu.cli import parse_args


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
