"""Array-backed typed-evidence views for chunked detection.

The deposit engines emit typed evidence (primary slots + other-slot counts,
deposits.py / native/grom_deposits.c) as flat arrays in flush order:
position-ascending, etype-ascending within a position. ``EvidenceChunk``
wraps one drained batch of those arrays: the detectors' vectorized screens
(sv_screen.py, indel._score_events) consume the entry arrays directly, and
``other_len`` serves the per-position other-slot count, without
materializing a Python object per (etype, position) the way the round-3
dict form did.

Chunks concatenate and split losslessly, which is how the streamed driver
carries early-flushed entries (positions beyond the current drain bound)
into the next detection window.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from grom_tpu_torch.call.deposits import EvidenceState

_Z64 = np.empty(0, np.int64)
_Z32 = np.empty(0, np.int32)
_ZF = np.empty(0, np.float64)


@dataclass
class EvidenceChunk:
    """Typed evidence entries sorted by (pos, etype)."""
    pos: np.ndarray
    etype: np.ndarray
    count: np.ndarray
    dist: np.ndarray
    rs: np.ndarray
    re: np.ndarray
    mchr: np.ndarray
    seq_off: np.ndarray          # into seq_arena; -1 = none
    seq_len: np.ndarray
    seq_arena: bytes
    oth_pos: np.ndarray          # sorted; one entry per other slot

    @staticmethod
    def empty() -> "EvidenceChunk":
        return EvidenceChunk(_Z64, _Z32, _Z32, _ZF, _Z64, _Z64, _Z32,
                             _Z32, _Z32, b"", _Z64)

    @staticmethod
    def from_drain(d: dict) -> "EvidenceChunk":
        """From _arrays_from_dep_out's dict (already in flush order)."""
        return EvidenceChunk(d["pos"], d["etype"], d["count"], d["dist"],
                             d["rs"], d["re"], d["mchr"], d["seq_off"],
                             d["seq_len"], d["seq_arena"], d["oth_pos"])

    @staticmethod
    def from_state(st: EvidenceState) -> "EvidenceChunk":
        """From the Python dict engine's state (whole-chromosome runs and
        the no-native fallback)."""
        items = sorted(st.primary.items(), key=lambda kv: (kv[0][1], kv[0][0]))
        n = len(items)
        pos = np.empty(n, np.int64)
        etype = np.empty(n, np.int32)
        count = np.empty(n, np.int32)
        dist = np.empty(n, np.float64)
        rs = np.empty(n, np.int64)
        re = np.empty(n, np.int64)
        mchr = np.empty(n, np.int32)
        seq_off = np.full(n, -1, np.int32)
        seq_len = np.full(n, -1, np.int32)
        arena: List[bytes] = []
        used = 0
        for i, ((et, p_), pr) in enumerate(items):
            pos[i] = p_
            etype[i] = et
            count[i] = pr.count
            dist[i] = pr.dist
            rs[i] = pr.rs
            re[i] = pr.re
            mchr[i] = pr.mchr
            if pr.seq is not None:
                seq_off[i] = used
                seq_len[i] = len(pr.seq)
                arena.append(pr.seq)
                used += len(pr.seq)
        oth = sorted((p_, len(sl)) for p_, sl in st.other.items() if sl)
        oth_pos = (np.repeat(np.array([p_ for p_, _ in oth], np.int64),
                             [c for _, c in oth])
                   if oth else _Z64)
        return EvidenceChunk(pos, etype, count, dist, rs, re, mchr,
                             seq_off, seq_len, b"".join(arena), oth_pos)

    # -- carry plumbing ----------------------------------------------------

    def split(self, upto: int) -> Tuple["EvidenceChunk", "EvidenceChunk"]:
        """(entries with pos < upto, the rest). Arrays are pos-sorted so the
        tail is a suffix; arena bytes are shared (offsets stay valid)."""
        k = int(np.searchsorted(self.pos, upto, side="left"))
        ko = int(np.searchsorted(self.oth_pos, upto, side="left"))
        head = EvidenceChunk(self.pos[:k], self.etype[:k], self.count[:k],
                             self.dist[:k], self.rs[:k], self.re[:k],
                             self.mchr[:k], self.seq_off[:k],
                             self.seq_len[:k], self.seq_arena,
                             self.oth_pos[:ko])
        tail = EvidenceChunk(self.pos[k:], self.etype[k:], self.count[k:],
                             self.dist[k:], self.rs[k:], self.re[k:],
                             self.mchr[k:], self.seq_off[k:],
                             self.seq_len[k:], self.seq_arena,
                             self.oth_pos[ko:])
        return head, tail

    @staticmethod
    def concat(a: "EvidenceChunk", b: "EvidenceChunk") -> "EvidenceChunk":
        """a's entries all precede b's (carry + fresh drain)."""
        if not len(a.pos) and not len(a.oth_pos):
            return b
        if not len(b.pos) and not len(b.oth_pos):
            return a
        off = len(a.seq_arena)
        b_off = np.where(b.seq_off >= 0, b.seq_off + off, b.seq_off)
        return EvidenceChunk(
            np.concatenate([a.pos, b.pos]),
            np.concatenate([a.etype, b.etype]),
            np.concatenate([a.count, b.count]),
            np.concatenate([a.dist, b.dist]),
            np.concatenate([a.rs, b.rs]),
            np.concatenate([a.re, b.re]),
            np.concatenate([a.mchr, b.mchr]),
            np.concatenate([a.seq_off, b_off]).astype(np.int32),
            np.concatenate([a.seq_len, b.seq_len]),
            a.seq_arena + b.seq_arena,
            np.concatenate([a.oth_pos, b.oth_pos]))

    # -- detector lookups --------------------------------------------------

    def other_len(self, pos: int, cap: int = 50) -> int:
        a = int(np.searchsorted(self.oth_pos, pos, side="left"))
        b = int(np.searchsorted(self.oth_pos, pos, side="right"))
        return min(b - a, cap)
