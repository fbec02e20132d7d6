"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled at first use by ``nvcc`` into a shared
library with a plain C interface and loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -shared -Xcompiler -fPIC -o build/grom_tpu_torch/<name>-<hash>.so

The library name carries a hash of the source and the flags, so an edited
kernel is rebuilt and a second process reuses the first one's build.
``--fmad=false`` keeps every f64 multiply and add separately rounded, as
the host engines round them; fast math is never used. A missing ``nvcc``
or a failed build raises.

Every C entry point launches on the current CUDA device, into the stream it
is given, and returns ``cudaGetLastError()`` after its launches; :func:`check`
turns a non-zero code into an exception. Each kernel wrapper makes its
tensors' card current (``torch.cuda.device``) around its launches, so a
wrapper called with tensors on any card launches there.

``LAUNCHES`` counts, per kernel, the wrapper calls that launched it on the
card; :func:`reset_launches` sets every count to zero.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from typing import Dict

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "grom_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

# the kernel libraries (csrc/<name>.cu) and the kernels counted in LAUNCHES
LIBRARIES = ("tile_accumulate", "cnv", "rd_depth", "sv_score")
KERNELS = ("tile_accumulate", "zscores", "seed_eval", "null_model",
           "rd_scatter", "rd_scan", "sv_score")
LAUNCHES: Dict[str, int] = {k: 0 for k in KERNELS}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def nvcc() -> str:
    """Path of nvcc: on PATH, else under $CUDA_HOME (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin); the CUDA "
                       "kernels of grom_tpu_torch cannot be built")


def library_path(name: str) -> str:
    """Path of the built library for ``csrc/<name>.cu`` (may not exist)."""
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        src = f.read()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, "%s-%s.so" % (name, key[:16]))


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its hashed library exists."""
    so = library_path(name)
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (so, os.getpid())
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError("nvcc failed for %s.cu:\n%s%s"
                           % (name, r.stdout, r.stderr))
    os.replace(tmp, so)
    return so


def build_all() -> list:
    """Compile every kernel library not built yet, one nvcc per source, all
    started together; returns their paths."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        return list(pool.map(build, LIBRARIES))


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built at first use."""
    lib = ctypes.CDLL(build(name))
    lib.gt_error_string.restype = ctypes.c_char_p
    lib.gt_error_string.argtypes = [ctypes.c_int]
    return lib


def bind(lib: ctypes.CDLL, fn: str, argtypes) -> ctypes._CFuncPtr:
    f = getattr(lib, fn)
    f.restype = ctypes.c_int
    f.argtypes = list(argtypes)
    return f


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError("CUDA launch of %s failed: %s"
                           % (what, lib.gt_error_string(err).decode()))


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
