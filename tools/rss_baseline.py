"""The host memory a device-engine run holds before it reads any data.

    python3 tools/rss_baseline.py

In one fresh process, the resident set size (``/proc/self/statm``, GiB)
after each step a torch- or mesh-engine run of ``python -m grom_tpu_torch``
takes before its first phase: importing numpy, the port and torch, asking
for a CUDA card, creating the CUDA context (one tensor on the card), and
loading each kernel library (``_build.library``, built with nvcc first
when the checkout has none). Also the resident split by kind where
``/proc/self/status`` gives it (RssAnon, RssFile, RssShmem). One JSON line
a step, then one summing up; exits 2 without a card.
"""

from __future__ import annotations

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_LIBS = ("tile_accumulate", "cnv", "rd_depth", "sv_score")


def reading() -> dict:
    """The resident set size in GiB and the RssAnon/RssFile/RssShmem lines
    of /proc/self/status (GiB), those it has."""
    with open("/proc/self/statm") as f:
        rss = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    out = {"rss_gib": rss / 2**30}
    try:
        with open("/proc/self/status") as f:
            for ln in f:
                key = ln.split(":")[0]
                if key in ("RssAnon", "RssFile", "RssShmem"):
                    out[key] = int(ln.split()[1]) / 2**20
    except OSError:
        pass
    return out


def main() -> int:
    steps = []

    def step(name: str) -> None:
        rec = dict(step=name, **reading())
        steps.append(rec)
        print(json.dumps(rec), flush=True)

    step("start")
    import numpy  # noqa: F401
    step("import numpy")
    sys.path.insert(0, REPO)
    import grom_tpu_torch.driver  # noqa: F401
    step("import grom_tpu_torch.driver")
    import torch
    step("import torch")
    if not torch.cuda.is_available():
        print("rss_baseline.py: no CUDA card", file=sys.stderr)
        return 2
    step("torch.cuda.is_available()")
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    step("CUDA context (one tensor on the card)")
    from grom_tpu_torch import _build
    for name in KERNEL_LIBS:
        _build.library(name)
        step("kernel library %s" % name)
    print(json.dumps({"rss_baseline": {
        "card": torch.cuda.get_device_name(0),
        "before_torch_gib": steps[2]["rss_gib"],
        "after_context_gib": steps[5]["rss_gib"],
        "after_kernels_gib": steps[-1]["rss_gib"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
