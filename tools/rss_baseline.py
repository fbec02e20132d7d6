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
same libraries shares. Each step also names the files whose mappings
hold the most resident pages (``top_files``: path, resident KiB, of it
private-dirty KiB), and the summary line ranks the files that
``import torch`` made resident and gives CUDA_MODULE_LOADING as it was
before the import and after the CUDA context (torch sets it to LAZY when
it is unset): run it with the variable unset, ``=LAZY`` and ``=EAGER``
to see whether the module loading mode moves the mappings. One JSON line
a step, then one summing up; exits 2 without a card.
"""

from __future__ import annotations

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_LIBS = ("tile_accumulate", "cnv", "rd_depth", "sv_score")
TOP_FILES = 12


def smaps_by_file(text: str) -> dict:
    """The resident pages of the mappings in ``text`` (the format of
    /proc/<pid>/smaps), summed by what they map: ``{"file": {path: [rss
    KiB, private-dirty KiB]}, "anon_kib": resident KiB of the mappings
    without a file}``. A file-backed mapping has a non-zero inode; the
    others (no path, ``[heap]``, ``[stack]``, a deleted or pseudo file
    with inode 0) count as anonymous."""
    files: dict = {}
    anon = 0
    cur = None
    for ln in text.splitlines():
        head = ln.split()
        if not head:
            continue
        if "-" in head[0] and not head[0].endswith(":") and len(head) >= 5:
            # a mapping: address perms offset dev inode [path]
            cur = None
            if head[4] != "0":
                path = " ".join(head[5:]) or "inode %s" % head[4]
                cur = files.setdefault(path, [0, 0])
        elif head[0] == "Rss:":
            if cur is None:
                anon += int(head[1])
            else:
                cur[0] += int(head[1])
        elif head[0] == "Private_Dirty:" and cur is not None:
            cur[1] += int(head[1])
    return {"file": files, "anon_kib": anon}


def top_files(files: dict, n: int = TOP_FILES) -> list:
    """The ``n`` files of ``smaps_by_file(...)["file"]`` holding the most
    resident KiB: [path, rss KiB, private-dirty KiB], largest first."""
    ranked = sorted(files.items(), key=lambda kv: (-kv[1][0], kv[0]))
    return [[path, kib[0], kib[1]] for path, kib in ranked[:n]]


def read_smaps():
    """``smaps_by_file`` of this process, or None where it cannot be
    read."""
    try:
        with open("/proc/self/smaps") as f:
            return smaps_by_file(f.read())
    except (OSError, IndexError, ValueError):
        return None


def reading() -> dict:
    """The resident set size and its split by kind in GiB, each source the
    kernel gives: smaps (file-backed, anonymous), statm's ``shared``, and
    the RssAnon/RssFile/RssShmem lines of /proc/self/status."""
    with open("/proc/self/statm") as f:
        pages = f.read().split()
    page = os.sysconf("SC_PAGE_SIZE")
    out = {"rss_gib": int(pages[1]) * page / 2**30,
           "shared_gib": int(pages[2]) * page / 2**30}
    by = read_smaps()
    if by is not None:
        out["smaps_file_gib"] = sum(v[0] for v in by["file"].values()) / 2**20
        out["smaps_anon_gib"] = by["anon_kib"] / 2**20
        out["top_files"] = top_files(by["file"])
        out["_files"] = by["file"]
    try:
        with open("/proc/self/status") as f:
            for ln in f:
                key = ln.split(":")[0]
                if key in ("RssAnon", "RssFile", "RssShmem"):
                    out[key] = int(ln.split()[1]) / 2**20
    except OSError:
        pass
    return out


def grown_files(before: dict, after: dict, n: int = TOP_FILES) -> list:
    """The ``n`` files whose resident KiB grew most from the reading
    ``before`` to ``after``: [path, KiB added], largest first."""
    a, b = before.get("_files") or {}, after.get("_files") or {}
    grown = {p: v[0] - a.get(p, [0, 0])[0] for p, v in b.items()}
    ranked = sorted(grown.items(), key=lambda kv: (-kv[1], kv[0]))
    return [[p, kib] for p, kib in ranked[:n] if kib > 0]


def main() -> int:
    steps = []
    last = time.perf_counter()

    def step(name: str) -> None:
        nonlocal last
        rec = dict(step=name, s=time.perf_counter() - last, **reading())
        steps.append(rec)
        print(json.dumps({k: v for k, v in rec.items() if k != "_files"}),
              flush=True)
        last = time.perf_counter()

    module_loading = os.environ.get("CUDA_MODULE_LOADING")
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
        "import_torch_top_files": grown_files(steps[2], steps[3]),
        "context_top_files": grown_files(steps[4], steps[5]),
        "cuda_module_loading": {"before": module_loading,
                                "after_context": os.environ.get(
                                    "CUDA_MODULE_LOADING")},
        "after_context_gib": steps[5]["rss_gib"],
        "after_kernels_gib": steps[-1]["rss_gib"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
