"""BGZF (blocked gzip) codec.

The reference relies on vendored htslib for BGZF (src/GROM.c:26-27); we
implement the container natively so the ingest layer has zero external
dependencies. Reader returns (data, block_table) so callers can translate
virtual file offsets (coffset<<16 | uoffset) — the coordinate system of BAI
indexes — into flat offsets of the decompressed stream.
"""

from __future__ import annotations

import struct
import zlib
from typing import BinaryIO, Iterator, List, Tuple

import numpy as np

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)

_HDR = struct.Struct("<4BI2B2H")  # magic(4) mtime xfl os xlen


def _read_block(f: BinaryIO) -> Tuple[bytes, int] | None:
    """Read one BGZF block at the current offset. Returns (payload, csize)."""
    hdr = f.read(12)
    if len(hdr) == 0:
        return None
    if len(hdr) < 12:
        raise ValueError("truncated BGZF header")
    if hdr[0] != 0x1F or hdr[1] != 0x8B:
        raise ValueError("not a BGZF/gzip stream")
    xlen = struct.unpack_from("<H", hdr, 10)[0]
    extra = f.read(xlen)
    bsize = None
    off = 0
    while off + 4 <= xlen:
        si1, si2, slen = extra[off], extra[off + 1], struct.unpack_from("<H", extra, off + 2)[0]
        if si1 == 66 and si2 == 67 and slen == 2:
            bsize = struct.unpack_from("<H", extra, off + 4)[0] + 1
            break
        off += 4 + slen
    if bsize is None:
        raise ValueError("missing BGZF BC subfield")
    cdata = f.read(bsize - 12 - xlen - 8)
    crc, isize = struct.unpack("<II", f.read(8))
    data = zlib.decompress(cdata, wbits=-15) if isize else b""
    if len(data) != isize:
        raise ValueError("BGZF ISIZE mismatch")
    return data, bsize


def read_bgzf(path: str, as_array: bool = False) -> Tuple[bytes, np.ndarray]:
    """Decompress a whole BGZF file.

    Returns (data, blocks) where ``blocks`` is an int64 array of shape [B, 2]:
    (compressed_offset, uncompressed_offset) per block, plus a final sentinel
    row (file_size, len(data)). Virtual offset (co, uo) maps to flat offset
    uncompressed_offset[block_at(co)] + uo.

    Uses the native multithreaded inflater when available (block-parallel —
    BGZF blocks are independent deflate streams); falls back to the
    pure-Python path otherwise.

    With ``as_array=True`` the data comes back as a pooled uint8 ndarray
    (no bytes copy — first-touch page faults are expensive on this kernel;
    see utils/bufpool.py). The caller owns releasing it back to the pool.
    """
    native = _read_bgzf_native(path, as_array)
    if native is not None:
        return native
    chunks: List[bytes] = []
    coffs: List[int] = []
    uoffs: List[int] = []
    with open(path, "rb") as f:
        coff = 0
        uoff = 0
        while True:
            rec = _read_block(f)
            if rec is None:
                break
            data, csize = rec
            coffs.append(coff)
            uoffs.append(uoff)
            chunks.append(data)
            coff += csize
            uoff += len(data)
        coffs.append(coff)
        uoffs.append(uoff)
    blocks = np.stack([np.array(coffs, dtype=np.int64), np.array(uoffs, dtype=np.int64)], axis=1)
    return b"".join(chunks), blocks


def _read_src(path: str) -> np.ndarray:
    """Read a whole file into a pooled uint8 array (avoids the bytes-object
    first-touch; the pool reuses the buffer across decode passes)."""
    import os

    from grom_tpu_torch.utils.bufpool import POOL
    size = os.path.getsize(path)
    buf = POOL.empty(size, np.uint8)
    mv = memoryview(buf)
    got = 0
    with open(path, "rb", buffering=0) as f:
        # loop: a single readinto syscall is capped at ~2GB on Linux, so
        # one call silently truncates WGS-scale BAMs
        while got < size:
            n = f.readinto(mv[got:])
            if not n:
                break
            got += n
    if got != size:
        return buf[:got]
    return buf


def _read_bgzf_native(path: str, as_array: bool = False
                      ) -> Tuple[bytes, np.ndarray] | None:
    from grom_tpu_torch.native import get_lib
    lib = get_lib()
    if lib is None:
        return None
    import ctypes
    import os

    from grom_tpu_torch.utils.bufpool import POOL
    src = _read_src(path)
    srclen = len(src)
    v = ctypes.c_void_p
    cap = max(srclen // 1024, 64)  # blocks are >= ~1KB in practice
    while True:
        coff = np.empty(cap, np.int64)
        usize = np.empty(cap, np.int64)
        n = lib.gn_bgzf_scan(src.ctypes.data_as(v), srclen,
                             coff.ctypes.data_as(v),
                             usize.ctypes.data_as(v), cap)
        if n == -2:
            cap *= 2
            continue
        if n < 0:
            POOL.release(src)
            return None  # malformed; let the Python path raise precisely
        break
    coff = coff[:n]
    uoff = np.zeros(n + 1, np.int64)
    np.cumsum(usize[:n], out=uoff[1:])
    total = int(uoff[-1])
    dst = POOL.empty(total, np.uint8)
    nthreads = min(os.cpu_count() or 1, 16)
    rc = lib.gn_bgzf_inflate(src.ctypes.data_as(v), srclen,
                             coff.ctypes.data_as(v),
                             uoff.ctypes.data_as(v), n,
                             dst.ctypes.data_as(v), nthreads)
    POOL.release(src)
    if rc != 0:
        POOL.release(dst)
        return None
    blocks = np.stack([np.concatenate([coff, [srclen]]), uoff], axis=1)
    if as_array:
        return dst, blocks
    out = dst.tobytes()
    POOL.release(dst)
    return out, blocks


class BgzfRandomReader:
    """Random access over a BGZF file: scans the block table once, then
    inflates only the block span covering a virtual-offset range — the
    building block for BAI-planned regional fetches (htslib-equivalent;
    the reference fetches via bam_fetch, src/GROM.c:981-992)."""

    def __init__(self, path: str):
        self._early = None            # pre-import inflation (grom_tpu/_earlyingest)
        try:
            from grom_tpu_torch import _earlyingest
            early = _earlyingest.take(path)
        except Exception:
            early = None
        if early is not None:
            # zero-copy views over the early thread's ctypes buffers (kept
            # alive by self._early); the whole file is already inflated
            self._early = early
            self._src = np.frombuffer(early["src"], np.uint8)
            n = early["n_blocks"]
            self._coff = np.frombuffer(early["coff"], np.int64)[:n].copy()
            self._uoff = np.frombuffer(early["uoff"], np.int64)[:n + 1].copy()
            self._usize = np.diff(self._uoff)
            self._flat = np.frombuffer(early["flat"], np.uint8)
            return
        self._flat = None
        from grom_tpu_torch.native import get_lib
        import os as _os
        size = _os.path.getsize(path)
        mmap_min = int(_os.environ.get("GROM_TPU_SRC_MMAP_MIN",
                                       str(256 << 20)))
        if get_lib() is not None:
            if size > mmap_min:
                # WGS-scale source: file-backed mapping instead of pinning
                # the whole compressed BAM in anonymous memory — the OS
                # page cache serves (and can reclaim) the touched ranges
                self._src = np.memmap(path, np.uint8, mode="r")
            else:
                self._src = _read_src(path)   # pooled array (native path)
        else:
            with open(path, "rb") as f:
                self._src = f.read()
        # the sidecar only pays at memmap (WGS) scale — a sub-256MB file
        # scans in milliseconds, and persisting tables for every small
        # fixture would litter their directories
        use_sidecar = isinstance(self._src, np.memmap)
        cached = self._load_block_table(path, size) if use_sidecar else None
        if cached is not None:
            self._coff, self._usize = cached
        else:
            self._coff, self._usize = self._scan()
            if use_sidecar:
                self._save_block_table(path, size)
            # the scan touched every page of the mapping: release the
            # residency (pages stay in the OS page cache; regional fetches
            # re-fault only the spans they read)
            self.drop_src_residency()
        self._uoff = np.zeros(len(self._coff) + 1, np.int64)
        np.cumsum(self._usize, out=self._uoff[1:])

    # -- block-table sidecar -------------------------------------------------
    # The whole-file block scan is the one operation that touches EVERY page
    # of a memmap'd WGS-scale BAM (24GB at 1Gb/30x): without a cache each -P
    # worker faults the entire compressed file resident just to learn the
    # block offsets (measured: +4.8GB RSS per worker on a 5.2GB BAM). The
    # table is tiny (16B per 64KB block) and immutable for a given file, so
    # persist it next to the BAM like the insert-size .mean sidecar.

    @staticmethod
    def _block_table_path(path: str) -> str:
        return path + ".grom_tpu.bgzf.npz"

    def _load_block_table(self, path: str, size: int):
        try:
            import os as _os
            side = self._block_table_path(path)
            if not _os.path.exists(side):
                return None
            if _os.path.getmtime(side) < _os.path.getmtime(path):
                return None
            with np.load(side) as z:
                if int(z["src_size"]) != size:
                    return None
                return z["coff"].astype(np.int64), z["usize"].astype(np.int64)
        except Exception:
            return None

    def _save_block_table(self, path: str, size: int) -> None:
        try:
            import os as _os
            import tempfile
            side = self._block_table_path(path)
            fd, tmp = tempfile.mkstemp(dir=_os.path.dirname(side) or ".",
                                       suffix=".tmp")
            with _os.fdopen(fd, "wb") as f:
                np.savez(f, coff=self._coff, usize=self._usize,
                         src_size=np.int64(size))
            _os.replace(tmp, side)
        except Exception:
            pass

    def drop_src_residency(self) -> None:
        """MADV_DONTNEED the compressed-source mapping (memmap'd WGS-scale
        files): drops this process's resident file pages after a scan or a
        consumed regional fetch. Pages stay in the shared OS page cache, so
        re-faulting a span later is a minor fault (~0.04s/GiB), while peak
        RSS stops accumulating the whole compressed BAM per process."""
        mm = getattr(self._src, "_mmap", None)
        if mm is None:
            return
        try:
            import mmap as _mmap
            mm.madvise(_mmap.MADV_DONTNEED)
        except (AttributeError, ValueError, OSError):
            pass

    def _scan(self) -> Tuple[np.ndarray, np.ndarray]:
        from grom_tpu_torch.native import get_lib
        lib = get_lib()
        src = self._src
        if lib is not None:
            import ctypes
            src_p = (src.ctypes.data_as(ctypes.c_void_p)
                     if isinstance(src, np.ndarray) else src)
            cap = max(len(src) // 1024, 64)
            while True:
                coff = np.empty(cap, np.int64)
                usize = np.empty(cap, np.int64)
                n = lib.gn_bgzf_scan(src_p, len(src),
                                     coff.ctypes.data_as(ctypes.c_void_p),
                                     usize.ctypes.data_as(ctypes.c_void_p),
                                     cap)
                if n == -2:
                    cap *= 2
                    continue
                if n >= 0:
                    return coff[:n].copy(), usize[:n].copy()
                break  # malformed: fall through to the Python scanner
        coffs: List[int] = []
        usizes: List[int] = []
        off = 0
        n = len(src)
        while off + 18 <= n:
            xlen = struct.unpack_from("<H", src, off + 10)[0]
            extra = src[off + 12:off + 12 + xlen]
            bsize = None
            eo = 0
            while eo + 4 <= xlen:
                si1, si2 = extra[eo], extra[eo + 1]
                slen = struct.unpack_from("<H", extra, eo + 2)[0]
                if si1 == 66 and si2 == 67 and slen == 2:
                    bsize = struct.unpack_from("<H", extra, eo + 4)[0] + 1
                    break
                eo += 4 + slen
            if bsize is None:
                raise ValueError("missing BGZF BC subfield")
            isize = struct.unpack_from("<I", src, off + bsize - 4)[0]
            coffs.append(off)
            usizes.append(isize)
            off += bsize
        return (np.array(coffs, np.int64), np.array(usizes, np.int64))

    @property
    def n_blocks(self) -> int:
        return len(self._coff)

    def _block_at(self, coff: int) -> int:
        i = int(np.searchsorted(self._coff, coff, side="right")) - 1
        return max(i, 0)

    def inflate_blocks(self, lo: int, hi: int, as_array: bool = False):
        """Inflate blocks [lo, hi) into one flat buffer (bytes by default;
        a pooled uint8 ndarray with ``as_array=True`` — no copy)."""
        hi = min(hi, self.n_blocks)
        lo = min(max(lo, 0), hi)
        if lo >= hi:
            return np.empty(0, np.uint8) if as_array else b""
        if self._flat is not None:
            view = self._flat[int(self._uoff[lo]):int(self._uoff[hi])]
            return view if as_array else view.tobytes()
        from grom_tpu_torch.native import get_lib
        lib = get_lib()
        total = int(self._uoff[hi] - self._uoff[lo])
        if lib is not None:
            import ctypes
            import os as _os

            from grom_tpu_torch.utils.bufpool import POOL
            dst = POOL.empty(total, np.uint8)
            uoff = (self._uoff[lo:hi + 1] - self._uoff[lo]).copy()
            coff = self._coff[lo:hi].copy()
            src = self._src
            src_p = (src.ctypes.data_as(ctypes.c_void_p)
                     if isinstance(src, np.ndarray) else src)
            rc = lib.gn_bgzf_inflate(
                src_p, len(src),
                coff.ctypes.data_as(ctypes.c_void_p),
                uoff.ctypes.data_as(ctypes.c_void_p),
                hi - lo, dst.ctypes.data_as(ctypes.c_void_p),
                min(_os.cpu_count() or 1, 16))
            if rc == 0:
                if as_array:
                    return dst
                out = dst.tobytes()
                POOL.release(dst)
                return out
            POOL.release(dst)
        out = []
        for b in range(lo, hi):
            c0 = int(self._coff[b])
            xlen = struct.unpack_from("<H", self._src, c0 + 10)[0]
            bsize = (int(self._coff[b + 1]) - c0 if b + 1 < self.n_blocks
                     else len(self._src) - c0)
            cdata = self._src[c0 + 12 + xlen:c0 + bsize - 8]
            out.append(zlib.decompress(cdata, wbits=-15)
                       if self._usize[b] else b"")
        return b"".join(out)

    def span(self, vstart: int, vend: int,
             as_array: bool = False) -> Tuple[bytes, int, int]:
        """Inflate the block range covering virtual offsets [vstart, vend)
        and return (flat, start_off, end_off) within the flat bytes (a
        pooled uint8 ndarray with ``as_array=True`` — caller releases)."""
        b0 = self._block_at(vstart >> 16)
        b1 = self._block_at(vend >> 16)
        if (vend & 0xFFFF) > 0 or b1 < b0:
            hi = b1 + 1
        else:
            hi = max(b1, b0 + 1)
        flat = self.inflate_blocks(b0, hi, as_array=as_array)
        s_off = vstart & 0xFFFF
        e_off = int(self._uoff[b1] - self._uoff[b0]) + (vend & 0xFFFF)
        e_off = min(e_off, len(flat))
        return flat, s_off, e_off


def iter_bgzf_blocks(path: str) -> Iterator[Tuple[int, int, bytes]]:
    """Stream (compressed_offset, uncompressed_offset, payload) per block."""
    with open(path, "rb") as f:
        coff = 0
        uoff = 0
        while True:
            rec = _read_block(f)
            if rec is None:
                return
            data, csize = rec
            yield coff, uoff, data
            coff += csize
            uoff += len(data)


def virtual_to_flat(blocks: np.ndarray, voffset: int) -> int:
    """Translate a BGZF virtual offset into a flat decompressed offset."""
    coff = voffset >> 16
    uoff = voffset & 0xFFFF
    idx = int(np.searchsorted(blocks[:, 0], coff, side="right")) - 1
    if idx < 0 or blocks[idx, 0] != coff:
        # coffset must start a block; fall back to nearest preceding block
        idx = max(idx, 0)
    return int(blocks[idx, 1]) + uoff


class BgzfWriter:
    """Minimal BGZF writer used by the BAM writer and tests.

    Tracks virtual offsets so a BAI index can be built while writing.
    """

    def __init__(self, f: BinaryIO, level: int = 6, block_size: int = 60000):
        self._f = f
        self._level = level
        self._buf = bytearray()
        self._block_size = block_size
        self._coff = 0

    @property
    def virtual_offset(self) -> int:
        return (self._coff << 16) | len(self._buf)

    def write(self, data: bytes) -> None:
        self._buf += data
        while len(self._buf) >= self._block_size:
            self._flush_block(self._buf[: self._block_size])
            del self._buf[: self._block_size]

    def _flush_block(self, payload: bytes) -> None:
        comp = zlib.compressobj(self._level, zlib.DEFLATED, -15)
        cdata = comp.compress(bytes(payload)) + comp.flush()
        bsize = len(cdata) + 26
        if bsize > 0x10000:
            raise ValueError("BGZF block too large; lower block_size")
        out = (
            b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
            + struct.pack("<H", 6)
            + b"BC" + struct.pack("<H", 2) + struct.pack("<H", bsize - 1)
            + cdata
            + struct.pack("<II", zlib.crc32(bytes(payload)) & 0xFFFFFFFF, len(payload))
        )
        self._f.write(out)
        self._coff += len(out)

    def flush(self) -> None:
        if self._buf:
            self._flush_block(bytes(self._buf))
            self._buf.clear()

    def close(self) -> None:
        self.flush()
        self._f.write(BGZF_EOF)
