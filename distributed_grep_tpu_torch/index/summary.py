"""Trigram shard summaries: the format, the builder, the cache, the
counters and the knobs (the reference's index/summary.py).

One summary is a fixed-size bloom over the case-folded trigrams of a
shard's bytes (a file, or a packed batch window): two bits a trigram,
indexed by the low and high 32-bit halves of one 64-bit Fibonacci mix of
the 24-bit folded trigram code.  Folding at build time makes
``ignore_case`` a no-op for the index: a case-insensitive query folds its
required literals to the same grams, and a case-sensitive one only asks
for more than it needs (folding can merge grams, never drop them), so the
"cannot match" verdict is sound both ways.

The bloom is built by the host library's ``trigram_summary_into``
(utils/native.py), or with ``plain=True`` by its numpy leg
``trigram_summary_numpy``; both give the reference's bits, so a summary
one package wrote is read by the other (index/store.py).

Knobs (the reference's):

* ``DGREP_INDEX``: the tier's switch (on by default; 0/false/no turns
  every lookup, build and prune off).
* ``DGREP_INDEX_SUMMARY_BYTES``: the bloom's size a shard (default 16 KB;
  rounded down to a power of two in [1 KB, 1 MB]).
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np

from distributed_grep_tpu_torch.utils import lockdep

DEFAULT_SUMMARY_BYTES = 16384

# The in-memory cache's cap in entries: 4096 x 16 KB is 64 MB.
CACHE_MAX_ENTRIES = 4096

_MIX = np.uint64(0x9E3779B97F4A7C15)  # the library's multiplier


def env_index_enabled(default: bool = True) -> bool:
    """DGREP_INDEX: on unless "0", "false" or "no"."""
    raw = os.environ.get("DGREP_INDEX")
    if raw is None or raw == "":
        return default
    return raw.strip().lower() not in ("0", "false", "no")


def env_summary_bytes(default: int = DEFAULT_SUMMARY_BYTES) -> int:
    """DGREP_INDEX_SUMMARY_BYTES (malformed keeps ``default``), rounded
    down to a power of two in [1 KB, 1 MB]: the bit index is masked with
    size * 8 - 1."""
    raw = os.environ.get("DGREP_INDEX_SUMMARY_BYTES")
    if raw is None or raw == "":
        return default
    try:
        v = int(raw)
    except ValueError:
        return default
    v = min(max(v, 1 << 10), 1 << 20)
    return 1 << (v.bit_length() - 1)


# --------------------------------------------------------------- trigrams

# ASCII case fold (A-Z -> a-z) as a 256-entry table
_FOLD = np.arange(256, dtype=np.uint8)
_FOLD[ord("A"):ord("Z") + 1] += 32


def trigram_codes(literal: bytes) -> np.ndarray:
    """The folded 24-bit trigram codes of ``literal``, deduplicated and
    sorted: the query side of the index.  Empty under 3 bytes (such a
    literal can never be ruled out)."""
    if len(literal) < 3:
        return np.zeros(0, dtype=np.uint64)
    f = _FOLD[np.frombuffer(literal, dtype=np.uint8)].astype(np.uint64)
    v = (f[:-2] << np.uint64(16)) | (f[1:-1] << np.uint64(8)) | f[2:]
    return np.unique(v)


def _bit_indices(codes: np.ndarray, n_bits: int) -> np.ndarray:
    """The two bloom bits of each trigram code, concatenated."""
    h = codes.astype(np.uint64) * _MIX
    mask = np.uint64(n_bits - 1)
    return np.concatenate([h & mask, (h >> np.uint64(32)) & mask])


def build_summary(data, summary_bytes: int | None = None,
                  plain: bool = False) -> bytes:
    """The trigram bloom of ``data`` (bytes-like), of ``summary_bytes``
    (default DGREP_INDEX_SUMMARY_BYTES): the host library's pass, or its
    numpy leg with ``plain``.  Under 3 bytes the summary is all zero,
    which is right: no 3-byte literal fits."""
    from distributed_grep_tpu_torch.utils import native

    m = summary_bytes if summary_bytes is not None else env_summary_bytes()
    bloom = np.zeros(m, dtype=np.uint8)
    if plain:
        native.trigram_summary_numpy(data, bloom)
    else:
        native.trigram_summary_into(data, bloom)
    _count("index_summaries_built")
    return bloom.tobytes()


def has_all_trigrams(summary: bytes, codes: np.ndarray) -> bool:
    """False when some trigram of a literal is absent from the bloom: the
    proof that the literal does not occur in the shard.  True is only
    "maybe"."""
    if codes.size == 0:
        return True
    bloom = np.frombuffer(summary, dtype=np.uint8)
    idx = _bit_indices(codes, bloom.size * 8)
    bits = (bloom[(idx >> np.uint64(3)).astype(np.int64)]
            >> (idx & np.uint64(7)).astype(np.uint8)) & 1
    return bool(bits.all())


# ---------------------------------------------------------------- counters

_counters_lock = lockdep.make_lock("index-counters")
_counters = {
    "index_shards_pruned": 0,
    "index_bytes_skipped": 0,
    "index_maybe_scans": 0,
    "index_summaries_built": 0,
}
# read without the lock while False: a process where the index never
# fired pays no lock a scan for its counters
_touched = False
# the same prune and maybe counts, for the calling thread alone: a worker
# takes the difference over one map attempt (runtime/worker.py)
_local = threading.local()


def _count(key: str, n: int = 1) -> None:
    global _touched
    with _counters_lock:
        _counters[key] += n
        _touched = True


def _count_thread(key: str, n: int) -> None:
    d = getattr(_local, "d", None)
    if d is None:
        d = _local.d = {}
    d[key] = d.get(key, 0) + n


def record_prune(n_bytes: int) -> None:
    """One shard skipped by the engine."""
    global _touched
    with _counters_lock:
        _counters["index_shards_pruned"] += 1
        _counters["index_bytes_skipped"] += int(n_bytes)
        _touched = True
    _count_thread("index_shards_pruned", 1)
    _count_thread("index_bytes_skipped", int(n_bytes))


def record_maybe() -> None:
    """A summary was read and could not rule the query out."""
    _count("index_maybe_scans")
    _count_thread("index_maybe_scans", 1)


def thread_counters() -> dict:
    """The calling thread's prune and maybe counts so far."""
    return dict(getattr(_local, "d", None) or {})


def index_counters() -> dict:
    """A copy of the counters, or {} while they are all 0."""
    if not _touched:
        return {}
    with _counters_lock:
        if not any(_counters.values()):
            return {}
        return dict(_counters)


def index_counters_clear() -> None:
    global _touched
    with _counters_lock:
        for k in _counters:
            _counters[k] = 0
        _touched = False


# -------------------------------------------------------------- shard keys

@dataclass(frozen=True)
class ShardKey:
    """Content identity of one shard, the shape of ops/layout.CorpusKey
    (which the engine passes here as it is)."""

    identity: tuple  # ("file", realpath) or ("pack", (realpath, ...))
    validators: tuple  # ((size, mtime_ns, ino), ...), a member each

    @property
    def n_bytes(self) -> int:
        return sum(v[0] for v in self.validators)


def file_key(path) -> ShardKey | None:
    """The ShardKey of ``path`` from a fresh stat, or None when it cannot
    be statted (nothing is then pruned or published)."""
    try:
        real = os.path.realpath(os.fspath(path))
        st = os.stat(real)
    except OSError:
        return None
    return ShardKey(identity=("file", real),
                    validators=((int(st.st_size), int(st.st_mtime_ns),
                                 int(st.st_ino)),))


# ----------------------------------------------------------- summary cache

class SummaryCache:
    """Process-wide LRU of identity -> (validators, summary).  Only dict
    work runs under the lock; a lookup whose validators differ evicts the
    entry (the content changed)."""

    def __init__(self, max_entries: int = CACHE_MAX_ENTRIES):
        self._lock = lockdep.make_lock("index-cache")
        self._max = int(max_entries)
        self._entries: OrderedDict = OrderedDict()
        # read without the lock by may_route(): True from the first put
        # until clear()
        self.nonempty = False

    def lookup(self, key) -> bytes | None:
        if key is None:
            return None
        with self._lock:
            ent = self._entries.get(key.identity)
            if ent is None:
                return None
            validators, summary = ent
            if validators != key.validators:
                del self._entries[key.identity]
                return None
            self._entries.move_to_end(key.identity)
            return summary

    def put(self, key, summary: bytes) -> None:
        if key is None:
            return
        with self._lock:
            self._entries[key.identity] = (key.validators, summary)
            self._entries.move_to_end(key.identity)
            while len(self._entries) > self._max:
                self._entries.popitem(last=False)
            self.nonempty = True

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.nonempty = False


_cache = SummaryCache()
_store = None  # the attached IndexStore, or None


def summary_cache() -> SummaryCache:
    return _cache


def attach_store(root) -> None:
    """Attach the persistent store at ``root`` (the grep app's
    ``index_dir``), or detach it with None."""
    global _store
    if root is None:
        _store = None
        return
    from distributed_grep_tpu_torch.index.store import IndexStore

    cur = _store
    if cur is None or os.fspath(cur.root) != os.fspath(root):
        _store = IndexStore(root)


def attached_store():
    return _store


def may_route() -> bool:
    """Whether a lookup could answer at all: a store is attached or the
    cache was ever filled.  False lets a scan skip the stat and the lock
    a lookup would cost."""
    return _store is not None or _cache.nonempty


def lookup_summary(key) -> bytes | None:
    """The shard's summary from memory, else from the attached store (a
    store hit fills memory); None when there is none or it is stale."""
    if key is None:
        return None
    s = _cache.lookup(key)
    if s is not None:
        return s
    st = _store
    if st is None:
        return None
    s = st.load(key)
    if s is not None:
        _cache.put(key, s)
    return s


def publish_summary(key, data) -> bytes | None:
    """Build ``data``'s summary and publish it under ``key`` (memory and
    the attached store).  Called after the scan that read ``data``
    succeeded; ``data`` must be the bytes the key's stat described.
    Returns the summary, or None for no key."""
    if key is None:
        return None
    s = build_summary(data)
    _cache.put(key, s)
    st = _store
    if st is not None:
        st.save(key, s)
    return s


def clear() -> None:
    """Empty the cache, detach the store, zero the counters."""
    global _store
    _cache.clear()
    _store = None
    index_counters_clear()
