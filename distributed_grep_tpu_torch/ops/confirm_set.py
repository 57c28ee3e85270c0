"""Exact host confirm of literal-set candidates.

``ConfirmSet(patterns, ignore_case).confirm(data, ends)`` is True at end
offset ``e`` iff some member ``p`` has ``hay[e - len(p):e] == p``, where
``hay`` is ``data`` with ASCII A-Z folded to a-z under -i (members are
folded the same way).  It is the host oracle of the FDR filter's
candidates and of the set path's boundary stitch (ops/device_scan.py),
with the contract of the reference's ConfirmSet.

``ConfirmSet`` runs in the host library (utils/native.py,
``dgrep_confirm_*``): a table keyed on each member's last 4 bytes behind
an L1-sized bloom bitmap, probed per candidate, the candidates split over
``native.THREADS`` threads.  ``ConfirmSetNumpy`` is its plain version, one
vectorized pass over the candidates, never a loop over them:

1. one unaligned 8-byte load per candidate gives the word ``w`` of the
   last 8 bytes before ``e`` (the byte at e-1 in its top byte; the few
   candidates with e < 8 are zero-padded);
2. members of length L <= 8 are grouped by L; a candidate hits group L
   iff ``w >> 8*(8-L)`` is one of the group's sorted keys.  A 1 MiB
   bitmap of a multiplicative hash of the key rejects most misses before
   the ``searchsorted``;
3. members longer than 8 bytes are keyed by their last 8 bytes the same
   way; on a key hit the remaining bytes are compared, for every member
   sharing that key.
"""

from __future__ import annotations

import numpy as np

from distributed_grep_tpu_torch.utils import native

_HASH_MUL = np.uint64(0x9E3779B97F4A7C15)
_BITS = 20  # bitmap of 2**20 flags per group
_FOLD = np.arange(256, dtype=np.uint8)
_FOLD[65:91] += 32  # ASCII A-Z -> a-z


def _pack(member: bytes, k: int) -> int:
    """The last k bytes of ``member`` as the candidates' word packs them:
    the last byte in the top byte of a k-byte little-endian integer."""
    return int.from_bytes(member[len(member) - k:], "little")


def _slot(keys: np.ndarray) -> np.ndarray:
    return (keys * _HASH_MUL) >> np.uint64(64 - _BITS)


class _Group:
    """Sorted unique keys of one key length, with their hash bitmap."""

    def __init__(self, keys: np.ndarray):
        self.keys = keys
        self.bitmap = np.zeros(1 << _BITS, dtype=bool)
        self.bitmap[_slot(keys)] = True

    def lookup(self, cand: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(indices into ``cand`` whose key is present, their positions
        in ``self.keys``)."""
        maybe = np.flatnonzero(self.bitmap[_slot(cand)])
        pos = np.searchsorted(self.keys, cand[maybe])
        pos = np.minimum(pos, self.keys.size - 1)
        hit = self.keys[pos] == cand[maybe]
        return maybe[hit], pos[hit]


def _members(patterns, ignore_case: bool) -> list[bytes]:
    """The set's members as bytes (str encoded utf-8/surrogateescape),
    folded under -i, duplicates dropped."""
    members = []
    for p in patterns:
        b = (p.encode("utf-8", "surrogateescape") if isinstance(p, str)
             else bytes(p))
        if not b:
            raise ValueError("empty literal in pattern set")
        members.append(b.lower() if ignore_case else b)
    return list(dict.fromkeys(members))


class _LinesMatch:
    def lines_match(self, data, starts, ends) -> np.ndarray:
        """True where the line span [starts[i], ends[i]) holds a member:
        every end offset inside each span confirmed at once (members hold
        no '\\n', so a hit ending inside a line lies inside it)."""
        starts = np.asarray(starts, dtype=np.int64)
        lens = np.asarray(ends, dtype=np.int64) - starts
        out = np.zeros(starts.size, dtype=bool)
        if not starts.size or int(lens.sum()) == 0:
            return out
        owner = np.repeat(np.arange(starts.size), lens)
        first = np.concatenate(([0], np.cumsum(lens)[:-1]))
        offs = starts[owner] + 1 + (np.arange(owner.size) - first[owner])
        out[np.unique(owner[self.confirm(data, offs)])] = True
        return out


class ConfirmSet(_LinesMatch):
    """Batch-confirm candidate end offsets against a literal set, in the
    host library."""

    def __init__(self, patterns, ignore_case: bool = False):
        self.ignore_case = bool(ignore_case)
        self.patterns = _members(patterns, self.ignore_case)
        # bound now: the handle is freed even while the interpreter exits
        self._free = native.lib().dgrep_confirm_free
        self._handle = native.confirm_build(self.patterns, self.ignore_case)

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._handle = None
            self._free(handle)

    def confirm(self, data, ends) -> np.ndarray:
        """Boolean mask over ``ends``: does some member end there?"""
        ends = np.asarray(ends, dtype=np.int64).reshape(-1)
        return native.confirm_scan(self._handle, data, ends)


class ConfirmSetNumpy(_LinesMatch):
    """``ConfirmSet``'s plain version (numpy)."""

    def __init__(self, patterns, ignore_case: bool = False):
        self.ignore_case = bool(ignore_case)
        self.patterns = _members(patterns, self.ignore_case)
        self.min_len = min((len(p) for p in self.patterns), default=0)
        by_len: dict[int, set[int]] = {}
        longs = []
        for p in self.patterns:
            if len(p) <= 8:
                by_len.setdefault(len(p), set()).add(_pack(p, len(p)))
            else:
                longs.append(p)
        self._short = {
            L: _Group(np.array(sorted(keys), dtype=np.uint64))
            for L, keys in sorted(by_len.items())
        }
        self._long = None
        if longs:
            longs.sort(key=lambda p: _pack(p, 8))
            keys = np.array([_pack(p, 8) for p in longs], dtype=np.uint64)
            ukeys, first, counts = np.unique(keys, return_index=True,
                                             return_counts=True)
            width = max(len(p) for p in longs) - 8
            heads = np.zeros((len(longs), width), dtype=np.uint8)
            for i, p in enumerate(longs):
                heads[i, : len(p) - 8] = np.frombuffer(p[:-8], np.uint8)
            self._long = (_Group(ukeys), first, counts,
                          np.array([len(p) for p in longs], dtype=np.int64),
                          heads)

    def _words(self, hay: np.ndarray, ends: np.ndarray) -> np.ndarray:
        """uint64 of hay[e-8:e] per end (zero bytes before offset 0)."""
        w = np.zeros(ends.size, dtype=np.uint64)
        fast = ends >= 8
        if hay.size >= 8 and fast.any():
            # every 8-byte window of hay, as an unaligned uint64 view
            win = np.ndarray((hay.size - 7,), dtype="<u8", buffer=hay,
                             strides=(1,))
            w[fast] = win[ends[fast] - 8]
        for i in np.flatnonzero(~fast).tolist():
            e = int(ends[i])
            w[i] = int.from_bytes(bytes(8 - e) + hay[:e].tobytes(), "little")
        if self.ignore_case:
            w = _FOLD[w.view(np.uint8)].view(np.uint64)
        return w

    def confirm(self, data, ends) -> np.ndarray:
        """Boolean mask over ``ends``: does some member end there?"""
        ends = np.asarray(ends, dtype=np.int64).reshape(-1)
        out = np.zeros(ends.size, dtype=bool)
        hay = np.frombuffer(data, dtype=np.uint8)
        ok = np.flatnonzero((ends >= max(self.min_len, 1))
                            & (ends <= hay.size))
        if not ok.size or not self.patterns:
            return out
        e = ends[ok]
        w = self._words(hay, e)
        for L, group in self._short.items():
            sel = np.flatnonzero(e >= L)
            key = w[sel] >> np.uint64(8 * (8 - L)) if L < 8 else w[sel]
            found, _ = group.lookup(key)
            out[ok[sel[found]]] = True
        if self._long is not None:
            group, first, counts, lens, heads = self._long
            sel = np.flatnonzero(e > 8)
            found, pos = group.lookup(w[sel])
            cand = sel[found]
            for r in range(int(counts.max())):
                more = counts[pos] > r
                c, idx = cand[more], first[pos[more]] + r
                L = lens[idx]
                fits = e[c] >= L
                c, idx, L = c[fits], idx[fits], L[fits]
                if not c.size:
                    continue
                cols = np.arange(heads.shape[1], dtype=np.int64)
                at = (e[c] - L)[:, None] + cols[None, :]
                used = cols[None, :] < (L - 8)[:, None]
                got = hay[np.where(used, at, 0)]
                if self.ignore_case:
                    got = _FOLD[got]
                same = np.all((got == heads[idx]) | ~used, axis=1)
                out[ok[c[same]]] = True
        return out
