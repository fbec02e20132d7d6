"""Pre-import BAM inflation — pure stdlib + ctypes, NO numpy.

The port's counterpart of grom_tpu/_earlyingest.py, with the same logic:
with GROM_TPU_EARLY=1 (and a CLI run with a ``-i`` BAM), the package's
``__init__`` starts a thread that reads the BAM, scans its BGZF block table
and inflates every block through the port's native C library while numpy
and torch are still importing. The main pipeline's BGZF reader
(ingest/bgzf.BgzfRandomReader) consults :data:`RESULT` and, on a hit, serves
decompressed spans as zero-copy views of the early buffer instead of
re-reading and re-inflating. The output is the same either way.

The library is the hashed build of grom_tpu_torch/native.py
(build/grom_tpu_torch/grom_native-<hash>.so), never native/_grom_native.so.
This module builds nothing: when that library is not built yet (a fresh
checkout's first run), the thread returns at once and the reader finds no
early result, as grom_tpu does when its library is missing.

Gated to inputs whose decompressed size fits comfortably in memory
(GROM_TPU_EARLY_MAX, 2 GiB by default).
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Dict, Optional

# path -> dict(src=ctypes buf, flat=ctypes buf, coff=(c_int64*n),
#              uoff=(c_int64*(n+1)), n_blocks=int)
RESULT: Dict[str, dict] = {}
DONE: Dict[str, threading.Event] = {}

_MAX_FLAT = int(os.environ.get("GROM_TPU_EARLY_MAX", str(2 << 30)))


def _native_so() -> Optional[str]:
    """The port's native library if it is built, else None (the path's
    hash needs the libdeflate probe of native.py, which compiles an empty
    program to /dev/null; no library is compiled here)."""
    from grom_tpu_torch import native
    so = native.library_path()
    return so if so is not None and os.path.exists(so) else None


def _mmap_buf(libc, ctypes_mod, size: int):
    """Raw anonymous mmap wrapped as a ctypes array — unlike
    create_string_buffer it is NOT zero-filled on creation (that would be a
    full extra demand-fault pass over the buffer)."""
    p = libc.mmap(None, size, 0x3, 0x22, -1, 0)
    if not p or p == ctypes_mod.c_void_p(-1).value:
        return None
    return (ctypes_mod.c_char * size).from_address(p)


def _work(path: str, ev: threading.Event, after) -> None:
    try:
        so = _native_so()
        if so is None:
            return
        lib = ctypes.CDLL(so)
        libc = ctypes.CDLL(None, use_errno=True)
        libc.mmap.restype = ctypes.c_void_p
        libc.mmap.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
                              ctypes.c_int, ctypes.c_int, ctypes.c_long]
        L = ctypes.c_long
        P = ctypes.c_void_p
        I = ctypes.c_int
        lib.gn_bgzf_scan.restype = L
        lib.gn_bgzf_scan.argtypes = [P, L, P, P, L]
        lib.gn_bgzf_inflate.restype = I
        lib.gn_bgzf_inflate.argtypes = [P, L, P, P, L, P, I]
        size = os.path.getsize(path)
        src = _mmap_buf(libc, ctypes, size)
        if src is None:
            return
        mv = memoryview(src)
        got = 0
        with open(path, "rb", buffering=0) as f:
            while got < size:       # one readinto syscall caps at ~2GB
                n = f.readinto(mv[got:])
                if not n:
                    break
                got += n
        if got != size:
            return
        cap = max(size // 1024, 64)
        while True:
            coff = (ctypes.c_int64 * cap)()
            usize = (ctypes.c_int64 * cap)()
            n = lib.gn_bgzf_scan(src, size, coff, usize, cap)
            if n == -2:
                cap *= 2
                continue
            if n < 0:
                return
            break
        n = int(n)
        uoff = (ctypes.c_int64 * (n + 1))()
        tot = 0
        for i in range(n):
            uoff[i] = tot
            tot += usize[i]
        uoff[n] = tot
        if tot == 0 or tot > _MAX_FLAT:
            return
        flat = _mmap_buf(libc, ctypes, tot)
        if flat is None:
            return
        rc = lib.gn_bgzf_inflate(src, size, coff, uoff, n, flat, 1)
        if rc != 0:
            return
        RESULT[os.path.abspath(path)] = {
            "src": src, "flat": flat, "coff": coff, "uoff": uoff,
            "n_blocks": n, "size": size,
        }
    except Exception:
        pass
    finally:
        ev.set()
        if after is not None:
            try:
                after()
            except Exception:
                pass


def start(path: str, after=None) -> None:
    """Kick off early inflation of ``path``. ``after`` (optional callable)
    runs on the same worker thread once ingest finishes — used to chain the
    memory-preheat populate behind the CPU-bound inflate so the two don't
    fight for the spare core."""
    key = os.path.abspath(path)
    if key in DONE:
        return
    ev = threading.Event()
    DONE[key] = ev
    t = threading.Thread(target=_work, args=(path, ev, after),
                         name="grom-early-ingest", daemon=True)
    t.start()


def take(path: str, wait: float = 30.0) -> Optional[dict]:
    """The early result for ``path`` (waits for in-flight work), or None."""
    key = os.path.abspath(path)
    ev = DONE.get(key)
    if ev is None:
        return None
    ev.wait(wait)
    return RESULT.pop(key, None)
