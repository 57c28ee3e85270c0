"""Stripe layout: document bytes -> the (lanes, chunk) stripes of the scan.

The scan is lane-parallel: the document is cut into ``lanes`` contiguous
stripes, and each lane scans its stripe sequentially.  Because a pattern
can never consume '\\n', every lane can start from the empty state; the
only error is each stripe's first partial line, which the engine re-checks
on the host (ops/lines.py boundary lines).

Padding uses '\\n' bytes: the pattern can never consume '\\n', so padding
can't create matches inside real lines, and decoded offsets past the real
data's length are dropped.

Two layouts of the same bytes.  ``padded_stripes``: (lanes, chunk)
row-major, stripes[l, c] = byte c of stripe l, the document as it lies;
the Shift-And, approx, pairset and SWAR kernels read it (16 bytes of a
stripe a load, or a TMA box of 256 stripes x 128 bytes).
``to_device_array``: its column-major transpose, array[c, l] = byte c of
stripe l, so one scan step reads one row with neighbouring lanes on
neighbouring addresses; the NFA, FDR and probe kernels read that.  Each engine kernel's module names the one it reads in ``LAYOUT``
(``STRIPES`` or ``COLUMNS``), and the segment pipeline
(ops/device_scan.py) prepares each segment in the layouts of its route.

The module also holds the warm tiers' data structures (the reference's
``ops/layout.py``): the cross-file batching of small inputs
(``BatchPacker``, ``PackedBatch``) and the corpus cache that keeps the
uploaded segments of unchanged inputs on the card (``CorpusCache``).
"""

from __future__ import annotations

import os
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np

from distributed_grep_tpu_torch.utils import lockdep

NL = 0x0A
STRIPES = "stripes"  # (lanes, chunk), padded_stripes
COLUMNS = "columns"  # (chunk, lanes), to_device_array


@dataclass(frozen=True)
class Layout:
    lanes: int
    chunk: int  # bytes per lane
    n_real: int  # real (unpadded) document length

    @property
    def padded(self) -> int:
        return self.lanes * self.chunk

    def stripe_starts(self) -> np.ndarray:
        """Absolute offsets where a lane's stripe begins (boundary fix-ups)."""
        return np.arange(1, self.lanes, dtype=np.int64) * self.chunk


def choose_layout(
    n_bytes: int,
    target_lanes: int = 1024,
    min_chunk: int = 256,
    lane_multiple: int = 8,
    chunk_multiple: int = 8,
) -> Layout:
    """Pick (lanes, chunk) for a document: enough lanes to fill the device,
    chunks long enough that the sequential scan amortizes its step cost.
    lane_multiple/chunk_multiple let kernels impose tile shapes (the CUDA
    kernel needs lanes % 32 == 0 and chunk % 32 == 0)."""
    if n_bytes <= 0:
        return Layout(lanes=lane_multiple, chunk=chunk_multiple, n_real=max(0, n_bytes))
    lanes = max(lane_multiple, target_lanes // lane_multiple * lane_multiple)
    while lanes > lane_multiple and (n_bytes + lanes - 1) // lanes < min_chunk:
        lanes = max(lane_multiple, lanes // 2 // lane_multiple * lane_multiple)
    chunk = (n_bytes + lanes - 1) // lanes
    chunk = (chunk + chunk_multiple - 1) // chunk_multiple * chunk_multiple
    return Layout(lanes=lanes, chunk=chunk, n_real=n_bytes)


def to_device_array(data: bytes, layout: Layout) -> np.ndarray:
    """Pad with '\\n' and reshape column-major: result[c, l] = data[l*chunk+c]."""
    return np.ascontiguousarray(padded_stripes(data, layout).T)


def padded_stripes(data: bytes, layout: Layout,
                   out: np.ndarray | None = None) -> np.ndarray:
    """The '\\n'-padded document as (lanes, chunk) row-major stripes --
    the Shift-And, approx, pairset and SWAR kernels' layout, and the
    source of the column-major copy.  Written into ``out``
    (``layout.padded`` contiguous uint8) when given."""
    buf = (np.empty(layout.padded, dtype=np.uint8) if out is None
           else out.reshape(-1))
    buf[: len(data)] = np.frombuffer(data, dtype=np.uint8)
    buf[len(data):] = NL
    return buf.reshape(layout.lanes, layout.chunk)


# ----------------------------------------------------- cross-file batching
#
# Many small inputs (grep -r over a source tree) are packed into one
# buffer and scanned as one document.  Every member is '\n'-terminated in
# the pack (a terminator is added where a file lacks one, which adds no
# line: grep counts an unterminated tail as a line already), so no line
# spans two members.  Every scanner resets at '\n' (the DFA's '\n'
# column is its start state, the Shift-And, NFA, FDR, pairset and approx
# kernels restart at a line start), '^' sees a line start at each
# member's first byte and '$' a line end at its last; the stitches own
# the stripe and segment edges as for any document.  So the packed scan's
# lines are each member's own, and the demux is line arithmetic over the
# members' cumulative line counts.

# The packing window: the CLI's JobConfig.batch_bytes for more than one
# input, and the engine's default cap.
DEFAULT_BATCH_BYTES = 32 << 20

# Inputs below this size scan on the host on the card (a dispatch of its
# own costs more than the host scanners take), and below it a file counts
# as small for the map-split planner.
DEFAULT_DEVICE_MIN_BYTES = 1 << 20


def _env_int(name: str) -> int | None:
    """The clamped integer of environment variable ``name``, or None when
    it is unset or does not parse."""
    raw = os.environ.get(name)
    if raw is None:
        return None
    try:
        return max(0, int(raw))
    except ValueError:
        return None


def env_device_min_bytes(fallback: int = DEFAULT_DEVICE_MIN_BYTES) -> int:
    """DGREP_DEVICE_MIN_BYTES, parsed one way for its two readers (the
    engine's small-input route and the map-split planner's small-file
    bound): unset or malformed gives ``fallback``."""
    v = _env_int("DGREP_DEVICE_MIN_BYTES")
    return fallback if v is None else v


def env_batch_bytes(fallback: int = DEFAULT_BATCH_BYTES) -> int:
    """DGREP_BATCH_BYTES, parsed one way for its two readers (the engine's
    packing cap and JobConfig.effective_batch_bytes): unset or malformed
    gives ``fallback``; 0 disables packing."""
    v = _env_int("DGREP_BATCH_BYTES")
    return fallback if v is None else v


@dataclass
class PackedBatch:
    """One packed buffer and the tables that demux it.

    ``byte_starts`` and ``line_starts`` have one entry a member plus a
    last one: the packed byte offset and the packed line count before
    each member.  ``blobs`` are the original member bytes (no added
    terminator), or None on a copy kept by the corpus cache
    (``without_blobs``), whose ``blob_lens`` then give the original
    lengths so ``member_blobs`` can slice them out of ``data``."""

    data: bytes
    names: list
    blobs: list | None
    byte_starts: np.ndarray
    line_starts: np.ndarray
    blob_lens: np.ndarray | None = None

    def __len__(self) -> int:
        return len(self.names)

    def member_blobs(self) -> list:
        """The original member bytes: as stored, or sliced from ``data``."""
        if self.blobs is not None:
            return self.blobs
        return [self.data[int(s):int(s) + int(n)]
                for s, n in zip(self.byte_starts[:-1], self.blob_lens)]

    def without_blobs(self) -> "PackedBatch":
        """A copy that does not hold the member blobs (a second copy of
        ``data``), with their lengths recorded."""
        if self.blobs is None:
            return self
        return PackedBatch(
            data=self.data, names=self.names, blobs=None,
            byte_starts=self.byte_starts, line_starts=self.line_starts,
            blob_lens=np.asarray([len(b) for b in self.blobs],
                                 dtype=np.int64))

    def demux(self, matched_lines: np.ndarray) -> list[np.ndarray]:
        """Sorted packed 1-based line numbers -> each member's own 1-based
        line numbers, in member order: member i owns the packed lines
        (line_starts[i], line_starts[i+1]]."""
        matched = np.asarray(matched_lines, dtype=np.int64)
        splits = np.searchsorted(matched, self.line_starts, side="right")
        return [matched[splits[i]:splits[i + 1]] - self.line_starts[i]
                for i in range(len(self.names))]


def packed_size(blob: bytes) -> int:
    """The bytes ``blob`` takes in a pack: its length plus the added
    terminator where it lacks one; an empty blob takes none (a terminator
    would make an empty line, which '^$' would match)."""
    if not blob:
        return 0
    return len(blob) + (0 if blob.endswith(b"\n") else 1)


class BatchPacker:
    """Collects blobs for one packed scan.  A blob is never split: the
    caller asks ``fits`` and packs (``pack``) when the next blob would take
    the buffer past ``max_bytes``; the first blob always fits."""

    def __init__(self, max_bytes: int):
        self.max_bytes = int(max_bytes)
        self._names: list = []
        self._blobs: list = []
        self._total = 0

    def __len__(self) -> int:
        return len(self._names)

    def fits(self, blob: bytes) -> bool:
        return (not self._names
                or self._total + packed_size(blob) <= self.max_bytes)

    def add(self, name, blob: bytes) -> None:
        self._names.append(name)
        self._blobs.append(blob)
        self._total += packed_size(blob)

    def pack(self) -> PackedBatch | None:
        """The packed buffer and its tables (the packer starts over), or
        None when it holds nothing."""
        if not self._names:
            return None
        names, blobs = self._names, self._blobs
        self._names, self._blobs, self._total = [], [], 0
        pieces: list[bytes] = []
        byte_starts = np.zeros(len(names) + 1, dtype=np.int64)
        line_starts = np.zeros(len(names) + 1, dtype=np.int64)
        pos = lines = 0
        for i, blob in enumerate(blobs):
            byte_starts[i] = pos
            line_starts[i] = lines
            if blob:
                pieces.append(blob)
                n = packed_size(blob)
                if n > len(blob):
                    pieces.append(b"\n")
                pos += n
                lines += blob.count(b"\n") + (0 if blob.endswith(b"\n")
                                               else 1)
        byte_starts[-1] = pos
        line_starts[-1] = lines
        return PackedBatch(data=b"".join(pieces), names=names, blobs=blobs,
                           byte_starts=byte_starts, line_starts=line_starts)


# ------------------------------------------------------------ corpus cache
#
# A repeated query over unchanged files pays the read, the pad into
# stripes and the upload again each time.  The corpus cache keeps a
# scanned input's host bytes and its uploaded segments -- the (lanes,
# chunk) stripes as torch tensors on the card, which every route reads or
# transposes on the card -- keyed by the input's identity and a fresh
# stat, so a warm scan reads no file and uploads nothing.
#
# Never stale: the key holds (realpath, size, mtime_ns, inode) of every
# member, taken at each lookup; an entry whose stored stat differs is
# evicted, so a file changed in place (size or mtime) or replaced (inode)
# misses.  DGREP_CORPUS_BYTES budgets the resident device bytes (the
# padded segments) and evicts whole entries, least recently used first.

# The budget on the card when neither DGREP_CORPUS_BYTES nor the engine's
# corpus_bytes is set; on device="cpu" the default is 0 (off).
DEFAULT_CORPUS_BYTES_ACCEL = 1 << 30


def env_corpus_bytes() -> int | None:
    """DGREP_CORPUS_BYTES (0 disables), or None when it is unset or does
    not parse (the engine then sizes by device)."""
    return _env_int("DGREP_CORPUS_BYTES")


@dataclass(frozen=True)
class CorpusKey:
    """Identity of one cacheable input (a file, or a packed window of
    files) and the stat of each member, (size, mtime_ns, inode), taken
    when the key was made."""

    identity: tuple  # ("file", realpath) or ("pack", (realpath, ...))
    validators: tuple  # ((size, mtime_ns, ino), ...), a member each

    @property
    def n_bytes(self) -> int:
        return sum(v[0] for v in self.validators)


def file_content_key(path) -> CorpusKey | None:
    """The CorpusKey of ``path`` from a fresh stat, or None when it cannot
    be statted (the scan then runs uncached)."""
    try:
        real = os.path.realpath(os.fspath(path))
        st = os.stat(real)
    except OSError:
        return None
    return CorpusKey(identity=("file", real),
                     validators=((int(st.st_size), int(st.st_mtime_ns),
                                  int(st.st_ino)),))


def batch_content_key(member_keys) -> CorpusKey | None:
    """The CorpusKey of a packed window: its members' identities in order,
    their stats concatenated; None when a member has no key."""
    keys = list(member_keys)
    if not keys or any(k is None for k in keys):
        return None
    return CorpusKey(identity=("pack", tuple(k.identity for k in keys)),
                     validators=tuple(v for k in keys for v in k.validators))


@dataclass
class ResidentCorpus:
    """One cached input: its host bytes, and per layout signature (the
    segment size and the layout parameters the scan laid it out with) the
    list of its segments, ``(seg_start, Layout, stripes tensor)``.
    ``batch`` is the PackedBatch behind a packed window's bytes (its demux
    tables), so a warm window needs no member read."""

    key: CorpusKey
    data: bytes
    variants: dict = field(default_factory=dict)
    batch: PackedBatch | None = None
    device_bytes: int = 0


def _segments_nbytes(segments) -> int:
    return sum(int(t.nbytes) for _start, _lay, t in segments)


class CorpusCache:
    """Process-wide LRU of ResidentCorpus entries under a budget of
    resident device bytes.  Thread-safe: one lock over the dict work (the
    stats that validate a lookup are taken by the caller, outside it)."""

    def __init__(self):
        self._lock = lockdep.make_lock("corpus-cache")
        self._entries: OrderedDict = OrderedDict()
        self._bytes = 0
        # a packed window's first member file -> the window's identity:
        # scan_batch recognizes a cached window before reading any member
        self._windows: dict = {}
        self._stats = {
            "corpus_cache_hits": 0,
            "corpus_cache_misses": 0,
            "corpus_cache_evictions": 0,
            # warm serves of the host bytes (scan_file, scan_batch), counted
            # apart from the segment hits: a host-routed scan serves the
            # bytes without reaching the segments
            "corpus_cache_host_hits": 0,
        }

    def _evict_locked(self, identity) -> None:
        ent = self._entries.pop(identity, None)
        if ent is not None:
            self._bytes -= ent.device_bytes
            self._stats["corpus_cache_evictions"] += 1
            if ent.key.identity[0] == "pack":
                first = ent.key.identity[1][0]
                if self._windows.get(first) == identity:
                    del self._windows[first]

    def _lookup_locked(self, key: CorpusKey) -> ResidentCorpus | None:
        ent = self._entries.get(key.identity)
        if ent is None:
            return None
        if ent.key.validators != key.validators:
            self._evict_locked(key.identity)  # changed since: stale
            return None
        self._entries.move_to_end(key.identity)
        return ent

    def lookup(self, key: CorpusKey | None) -> ResidentCorpus | None:
        """The entry of ``key`` if its stats still hold (made most recently
        used), else None; counts nothing (the scan's verdict is counted
        once, by ``resident_segments``)."""
        if key is None:
            return None
        with self._lock:
            return self._lookup_locked(key)

    def resident_segments(self, key: CorpusKey, sig: tuple):
        """The resident segments of (key, sig), or None; counts the scan's
        hit or miss."""
        with self._lock:
            ent = self._lookup_locked(key)
            segs = None if ent is None else ent.variants.get(sig)
            self._stats["corpus_cache_misses" if segs is None
                        else "corpus_cache_hits"] += 1
            return segs

    def count_host_hit(self) -> None:
        with self._lock:
            self._stats["corpus_cache_host_hits"] += 1

    def put_segments(self, key: CorpusKey, sig: tuple, data: bytes,
                     segments, budget: int) -> None:
        """Publish the (key, sig) segments and evict whole entries, least
        recently used first, until the resident bytes fit ``budget``.  A
        variant larger than the whole budget is declined: it could never
        stay, and taking it would evict every other entry first."""
        new_bytes = _segments_nbytes(segments)
        cap = max(0, budget)
        if new_bytes > cap:
            return
        with self._lock:
            ent = self._entries.get(key.identity)
            if ent is not None and ent.key.validators != key.validators:
                self._evict_locked(key.identity)
                ent = None
            if ent is None:
                ent = ResidentCorpus(key=key, data=data)
                self._entries[key.identity] = ent
            old = ent.variants.get(sig)
            if old is not None:  # two scans of the same input: last wins
                delta = _segments_nbytes(old)
                ent.device_bytes -= delta
                self._bytes -= delta
            ent.variants[sig] = list(segments)
            ent.device_bytes += new_bytes
            self._bytes += new_bytes
            self._entries.move_to_end(key.identity)
            if self._bytes > cap and len(ent.variants) > 1:
                # this entry's other layouts go before any other entry:
                # the LRU walk would reach this entry last and drop the
                # variant just built with it
                for other in [s for s in ent.variants if s != sig]:
                    delta = _segments_nbytes(ent.variants.pop(other))
                    ent.device_bytes -= delta
                    self._bytes -= delta
                    self._stats["corpus_cache_evictions"] += 1
                    if self._bytes <= cap:
                        break
            while self._bytes > cap and self._entries:
                self._evict_locked(next(iter(self._entries)))

    def attach_batch(self, key: CorpusKey | None, batch: PackedBatch) -> None:
        """Record the PackedBatch behind a window's entry (without its
        blobs) and index the window by its first member; nothing when the
        entry was not admitted."""
        if key is None:
            return
        slim = batch.without_blobs()
        with self._lock:
            ent = self._entries.get(key.identity)
            if ent is not None and ent.key.validators == key.validators:
                ent.batch = slim
                if key.identity[0] == "pack":
                    self._windows[key.identity[1][0]] = key.identity

    def window_for(self, member_key: CorpusKey | None) -> CorpusKey | None:
        """The stored key of a cached window whose first member is
        ``member_key``'s file, or None.  The caller takes fresh keys of
        every member and looks the window up with them."""
        if member_key is None:
            return None
        with self._lock:
            wid = self._windows.get(member_key.identity)
            ent = self._entries.get(wid) if wid is not None else None
            if ent is None or ent.batch is None:
                return None
            return ent.key

    def counters(self) -> dict:
        """The counters and ``corpus_cache_bytes_resident``, or {} while
        the cache has counted nothing and holds nothing."""
        with self._lock:
            if not any(self._stats.values()) and not self._entries:
                return {}
            out = dict(self._stats)
            out["corpus_cache_bytes_resident"] = self._bytes
            return out

    def clear(self) -> None:
        """Drop every entry (their tensors with them) and zero the
        counters."""
        with self._lock:
            self._entries.clear()
            self._windows.clear()
            self._bytes = 0
            for k in self._stats:
                self._stats[k] = 0


_corpus_cache = CorpusCache()


def corpus_cache() -> CorpusCache:
    """The process-wide corpus cache, shared across engines and jobs."""
    return _corpus_cache


def corpus_cache_counters() -> dict:
    return _corpus_cache.counters()


def corpus_cache_clear() -> None:
    _corpus_cache.clear()
