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

The host libraries (``csrc/<name>.c``, plain C that runs on the host) are
built the same way by ``cc`` (``CC_FLAGS``) and loaded with
:func:`host_library`; a missing ``cc`` or a failed build raises too.

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
CC_FLAGS = ("-O3", "-fPIC", "-shared", "-Wall", "-Wextra")

# the kernel libraries (csrc/<name>.cu) and the kernels counted in LAUNCHES
LIBRARIES = ("tile_accumulate", "cnv", "rd_depth", "sv_score")
# the host libraries (csrc/<name>.c): cnv_walk, the device CNV stage's walk
HOST_LIBRARIES = ("cnv_walk",)
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


def _source(name: str):
    """(source path, compiler flags) of library ``name``."""
    if name in HOST_LIBRARIES:
        return os.path.join(CSRC, name + ".c"), CC_FLAGS
    return os.path.join(CSRC, name + ".cu"), NVCC_FLAGS


def library_path(name: str) -> str:
    """Path of the built library for ``csrc/<name>.cu`` or, for a host
    library, ``csrc/<name>.c`` (may not exist)."""
    path, flags = _source(name)
    with open(path, "rb") as f:
        src = f.read()
    key = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()
    return os.path.join(BUILD_DIR, "%s-%s.so" % (name, key[:16]))


def build(name: str) -> str:
    """Compile library ``name`` unless its hashed library exists."""
    so = library_path(name)
    if os.path.exists(so):
        return so
    path, flags = _source(name)
    compiler = "cc" if name in HOST_LIBRARIES else nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (so, os.getpid())
    try:
        r = subprocess.run([compiler, *flags, "-o", tmp, path],
                           capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError("%s cannot be built: %s"
                           % (os.path.relpath(path, _PKG), e)) from e
    if r.returncode != 0:
        raise RuntimeError("%s failed for %s:\n%s%s"
                           % (compiler, os.path.relpath(path, _PKG),
                              r.stdout, r.stderr))
    os.replace(tmp, so)
    return so


def build_all() -> list:
    """Compile every library not built yet, kernels and host libraries, one
    compiler per source, all started together; returns their paths."""
    from concurrent.futures import ThreadPoolExecutor
    names = LIBRARIES + HOST_LIBRARIES
    with ThreadPoolExecutor(len(names)) as pool:
        return list(pool.map(build, names))


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built at first use."""
    lib = ctypes.CDLL(build(name))
    lib.gt_error_string.restype = ctypes.c_char_p
    lib.gt_error_string.argtypes = [ctypes.c_int]
    return lib


@functools.cache
def host_library(name: str) -> ctypes.CDLL:
    """The loaded host library ``name`` (``csrc/<name>.c``), built at first
    use."""
    return ctypes.CDLL(build(name))


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
