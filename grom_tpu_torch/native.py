"""ctypes bindings for the native host kernels (native/grom_native.c and
its siblings at the top of the repository).

A copy of grom_tpu/native/__init__.py with the port's own build: the C
sources in native/ are compiled with ``cc`` and native/Makefile's flags
(libdeflate when the host has it, else zlib alone) into
build/grom_tpu_torch/grom_native-<hash>.so. The name carries a hash of the
sources, the flags and the libraries, so an edited source is rebuilt and a
second process reuses the first one's build. Nothing is written into
native/, and no library built there is loaded. Every entry point has a
pure-Python fallback in the ingest layer, so a missing toolchain only
costs speed (GROM_TPU_NO_NATIVE=1 forces the fallbacks).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from typing import Optional

from grom_tpu_torch._build import BUILD_DIR

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_DIR = os.path.join(_REPO, "native")
SOURCES = ("grom_native.c", "grom_deposits.c", "grom_scan.c", "grom_prep.c",
           "grom_cnv.c")
CFLAGS = ("-O3", "-fPIC", "-shared", "-pthread", "-Wall", "-Wextra")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_c_long_p = ctypes.POINTER(ctypes.c_long)
_u8_p = ctypes.POINTER(ctypes.c_uint8)


@functools.cache
def _have_libdeflate() -> bool:
    """native/Makefile's probe: does ``cc`` link a program against
    libdeflate?"""
    try:
        r = subprocess.run(["cc", "-x", "c", "-include", "libdeflate.h", "-",
                            "-ldeflate", "-o", os.devnull],
                           input="int main(void){return 0;}",
                           capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return False
    return r.returncode == 0


def _recipe():
    """(sources, cc flags, libraries, path of the hashed library) for this
    host; None when a source is missing."""
    srcs = [os.path.join(_SRC_DIR, f) for f in SOURCES]
    if not all(os.path.exists(s) for s in srcs):
        return None
    flags, libs = list(CFLAGS), ["-lz"]
    if _have_libdeflate():
        flags.append("-DGN_HAVE_LIBDEFLATE")
        libs.append("-ldeflate")
    h = hashlib.sha256(" ".join(flags + libs).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(f.read())
    so = os.path.join(BUILD_DIR, "grom_native-%s.so" % h.hexdigest()[:16])
    return srcs, flags, libs, so


def library_path() -> Optional[str]:
    """Path of the hashed library for this host's sources and flags (it
    may not be built yet); None when a source is missing. Builds nothing."""
    r = _recipe()
    return None if r is None else r[3]


def _build() -> Optional[str]:
    """Path of the built library, compiling it unless its hashed build
    exists; None when the sources or the compiler are missing or the
    build fails."""
    r = _recipe()
    if r is None:
        return None
    srcs, flags, libs, so = r
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (so, os.getpid())
    try:
        r = subprocess.run(["cc", *flags, "-o", tmp, *srcs, *libs],
                           capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        return None
    if r.returncode != 0 or not os.path.exists(tmp):
        return None
    os.replace(tmp, so)
    return so


class DepOut(ctypes.Structure):
    """Mirrors gn_dep_out in native/grom_deposits.c."""
    _fields_ = [
        ("n_prim", ctypes.c_long), ("n_other", ctypes.c_long),
        ("prim_pos", ctypes.POINTER(ctypes.c_int64)),
        ("prim_etype", ctypes.POINTER(ctypes.c_int32)),
        ("prim_count", ctypes.POINTER(ctypes.c_int32)),
        ("prim_dist", ctypes.POINTER(ctypes.c_double)),
        ("prim_rs", ctypes.POINTER(ctypes.c_int64)),
        ("prim_re", ctypes.POINTER(ctypes.c_int64)),
        ("prim_mchr", ctypes.POINTER(ctypes.c_int32)),
        ("seq_arena", ctypes.POINTER(ctypes.c_uint8)),
        ("prim_seq_off", ctypes.POINTER(ctypes.c_int32)),
        ("prim_seq_len", ctypes.POINTER(ctypes.c_int32)),
        ("oth_pos", ctypes.POINTER(ctypes.c_int64)),
        ("oth_type", ctypes.POINTER(ctypes.c_int32)),
        ("oth_count", ctypes.POINTER(ctypes.c_int32)),
        ("oth_dist", ctypes.POINTER(ctypes.c_double)),
        ("oth_rs", ctypes.POINTER(ctypes.c_int64)),
        ("oth_re", ctypes.POINTER(ctypes.c_int64)),
        ("oth_mchr", ctypes.POINTER(ctypes.c_int32)),
    ]


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    L = ctypes.c_long
    I = ctypes.c_int
    P = ctypes.c_void_p
    lib.gn_bgzf_scan.restype = L
    lib.gn_bgzf_scan.argtypes = [P, L, P, P, L]
    lib.gn_bgzf_inflate.restype = I
    lib.gn_bgzf_inflate.argtypes = [P, L, P, P, L, P, I]
    lib.gn_bam_count.restype = L
    lib.gn_bam_count.argtypes = [P, L, L, P, I]
    lib.gn_bam_fill.restype = L
    lib.gn_bam_fill.argtypes = [P, L, L] + [P] * 18 + [I, I]
    if hasattr(lib, "gn_bam_offsets"):
        lib.gn_bam_offsets.restype = L
        lib.gn_bam_offsets.argtypes = [P, L, L, P, P, P, P, P, I, L]
        lib.gn_bam_fill_mt.restype = I
        lib.gn_bam_fill_mt.argtypes = [P, P, L] + [P] * 18 + [I, I, I]
    if hasattr(lib, "gn_bam_fixed"):
        lib.gn_bam_fixed.restype = L
        lib.gn_bam_fixed.argtypes = [P, L, L] + [P] * 8 + [L]
    if hasattr(lib, "gn_insert_scan"):
        lib.gn_insert_scan.restype = L
        lib.gn_insert_scan.argtypes = [P, L, L, P, P, L, I, P]
    if hasattr(lib, "gn_batch_build"):
        lib.gn_batch_count_spans.restype = L
        lib.gn_batch_count_spans.argtypes = [P, P, P, L]
        lib.gn_batch_build.restype = L
        lib.gn_batch_build.argtypes = [P, P, P, P, L] + [P] * 8
    if hasattr(lib, "gn_cnv_zscores"):
        D = ctypes.c_double
        lib.gn_cnv_zscores.restype = None
        lib.gn_cnv_zscores.argtypes = [L, L] + [P] * 10 + \
            [L, L, L, D, D, I, P]
        lib.gn_cnv_null_model.restype = None
        lib.gn_cnv_null_model.argtypes = [P, L] + [P] * 6 + \
            [L, L, L, L, L, P, P]
        lib.gn_cnv_scan.restype = L
        lib.gn_cnv_scan.argtypes = [L, L] + [P] * 8 + \
            [L, L, L, L, L, D, I, P, P, P, L]
    lib.gn_deposits_run.restype = I
    lib.gn_deposits_run.argtypes = [L] + [P] * 23 + \
        [P, P, P, ctypes.POINTER(ctypes.POINTER(DepOut))]
    lib.gn_deposits_free.restype = None
    lib.gn_deposits_free.argtypes = [ctypes.POINTER(DepOut)]
    lib.gn_deposits_init.restype = P
    lib.gn_deposits_init.argtypes = [P, P, P, L, L]
    lib.gn_deposits_init_stream.restype = P
    lib.gn_deposits_init_stream.argtypes = [P, P, L, L, L]
    lib.gn_deposits_feed.restype = I
    lib.gn_deposits_feed.argtypes = [P, L, L] + [P] * 23
    lib.gn_deposits_finish.restype = I
    lib.gn_deposits_finish.argtypes = [
        P, ctypes.POINTER(ctypes.POINTER(DepOut))]
    lib.gn_deposits_drain.restype = I
    lib.gn_deposits_drain.argtypes = [
        P, L, ctypes.c_int, L, P, ctypes.POINTER(ctypes.POINTER(DepOut))]
    lib.gn_deposits_abort.restype = None
    lib.gn_deposits_abort.argtypes = [P]
    lib.gn_snv_accumulate.restype = I
    lib.gn_snv_accumulate.argtypes = [L] + [P] * 29
    lib.gn_intern_names.restype = L
    lib.gn_intern_names.argtypes = [P, P, L, P, P]
    lib.gn_tri_weighted.restype = I
    lib.gn_tri_weighted.argtypes = [P, L, L, P, P]
    if hasattr(lib, "gn_broken_sort"):
        lib.gn_broken_sort.restype = None
        lib.gn_broken_sort.argtypes = [P, L, P]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The native library, building it if needed; None when unavailable or
    disabled via GROM_TPU_NO_NATIVE=1."""
    global _lib, _tried
    if _lib is not None:
        return _lib
    if _tried:
        return None
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("GROM_TPU_NO_NATIVE") == "1":
            return None
        so = _build()
        if so is None:
            return None
        try:
            _lib = _bind(ctypes.CDLL(so))
        except OSError:
            _lib = None
    return _lib
