"""The host memory a device-engine run holds before it reads any data.

    python3 tools/rss_baseline.py

In one fresh process, the resident set size (``/proc/self/statm``, GiB)
after each step a torch- or mesh-engine run of ``python -m grom_tpu_torch``
takes before its first phase: importing numpy, the port and torch, asking
for a CUDA card, creating the CUDA context (one tensor on the card), and
loading each kernel library (``_build.library``, built with nvcc first
when the checkout has none), and the wall seconds each step took. Also
the resident split by kind, each source where the kernel gives it (some
kernels give no RssAnon/RssFile lines and a ``shared`` field of 0):
the resident pages of the mappings that have a file
(``smaps_file_gib``) and of those that have none (``smaps_anon_gib``)
summed over ``/proc/self/smaps``; the ``shared`` field of
``/proc/self/statm`` (``shared_gib``: RssFile + RssShmem); RssAnon,
RssFile and RssShmem of ``/proc/self/status``. The file-backed part is
mostly the libraries' clean pages, which a second process mapping the
same libraries shares. One JSON line a step, then one summing up; exits
2 without a card.
"""

from __future__ import annotations

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_LIBS = ("tile_accumulate", "cnv", "rd_depth", "sv_score")


def smaps_split():
    """(resident KiB of file-backed mappings, of the others) summed over
    /proc/self/smaps, or None where it cannot be read."""
    kib = [0, 0]
    mapped_file = False
    try:
        with open("/proc/self/smaps") as f:
            for ln in f:
                head = ln.split()
                if "-" in head[0] and len(head) >= 5:
                    # a mapping: address perms offset dev inode [path]
                    mapped_file = head[4] != "0"
                elif head[0] == "Rss:":
                    kib[0 if mapped_file else 1] += int(head[1])
    except (OSError, IndexError, ValueError):
        return None
    return kib


def reading() -> dict:
    """The resident set size and its split by kind in GiB, each source the
    kernel gives: smaps (file-backed, anonymous), statm's ``shared``, and
    the RssAnon/RssFile/RssShmem lines of /proc/self/status."""
    with open("/proc/self/statm") as f:
        pages = f.read().split()
    page = os.sysconf("SC_PAGE_SIZE")
    out = {"rss_gib": int(pages[1]) * page / 2**30,
           "shared_gib": int(pages[2]) * page / 2**30}
    split = smaps_split()
    if split is not None:
        out["smaps_file_gib"], out["smaps_anon_gib"] = (k / 2**20
                                                         for k in split)
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
    last = time.perf_counter()

    def step(name: str) -> None:
        nonlocal last
        rec = dict(step=name, s=time.perf_counter() - last, **reading())
        steps.append(rec)
        print(json.dumps(rec), flush=True)
        last = time.perf_counter()

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
        "import_torch_s": steps[3]["s"],
        "import_torch_rss_gib": steps[3]["rss_gib"] - steps[2]["rss_gib"],
        "import_torch_shared_gib": (steps[3]["shared_gib"]
                                    - steps[2]["shared_gib"]),
        "import_torch_smaps_file_gib": (steps[3].get("smaps_file_gib", 0)
                                        - steps[2].get("smaps_file_gib", 0)),
        "import_torch_smaps_anon_gib": (steps[3].get("smaps_anon_gib", 0)
                                        - steps[2].get("smaps_anon_gib", 0)),
        "after_context_gib": steps[5]["rss_gib"],
        "after_kernels_gib": steps[-1]["rss_gib"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
