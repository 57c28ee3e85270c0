"""ctypes bindings of the host library ``csrc/dgrep.cpp``.

``lib()`` builds the library with g++ on first use (ops/_build.py
``load_host``: into ``_build/``, like the CUDA kernels) and binds its
sixteen entry points.  A missing g++ or a failed build raises: no entry
point falls back to Python.  ctypes.CDLL drops the GIL for the length of
a call, so the collect pool's threads overlap in the library.

Two entry points decline some inputs, and their callers then take the
plain leg, because the semantics need it (the same bytes come out):

* ``format_batch`` returns None when a line is not strict UTF-8 (the
  record's text is then the line decoded utf-8/replace) or the separator
  is not one byte;
* ``merge_display`` returns None when a line is not grep-key-shaped.

A return code that means a caller's bug (a capacity overrun, a malformed
record span) raises.

Each entry point has a plain version with the same results: the Python
or numpy functions here (``*_py``, ``trigram_summary_numpy``), or beside
its caller (``ops/lines.newline_index_numpy`` and
``unique_match_lines_numpy``, ``runtime/columnar.gather_ranges_numpy``,
``line_spans_numpy`` and ``LineBatch.split_by_partition_numpy`` /
``format_lines_bytes_numpy``, ``ops/confirm_set.ConfirmSetNumpy``,
``JobResult.iter_display_bytes_sorted``).  The FNV-32a hash is the
reference ``ihash`` (map_reduce/worker.go:13-17), bit for bit.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from distributed_grep_tpu_torch.ops import _build

# Threads of the multithreaded entry points (dfa_scan_mt, confirm_scan).
THREADS = min(8, os.cpu_count() or 1)
# Inputs of at least this many bytes take dfa_scan_mt in
# models/dfa.reference_scan (the reference's threshold, 4 MiB).
MT_THRESHOLD_BYTES = 1 << 22

_bind_lock = threading.Lock()
_bound: ctypes.CDLL | None = None

_u8p = ctypes.POINTER(ctypes.c_uint8)
_u16p = ctypes.POINTER(ctypes.c_uint16)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_u64p = ctypes.POINTER(ctypes.c_uint64)
_i64p = ctypes.POINTER(ctypes.c_int64)
_c = ctypes
_SIGNATURES = {
    "dgrep_fnv32a": (_c.c_uint32, [_c.c_char_p, _c.c_size_t]),
    "dgrep_newline_index": (_c.c_size_t, [_c.c_char_p, _c.c_size_t, _u64p,
                                          _c.c_size_t]),
    "dgrep_literal_scan": (_c.c_size_t, [_c.c_char_p, _c.c_size_t,
                                         _c.c_char_p, _c.c_size_t, _u64p,
                                         _c.c_size_t]),
    "dgrep_dfa_scan": (_c.c_size_t, [_c.c_char_p, _c.c_size_t, _u16p,
                                     _c.c_char_p, _c.c_uint32, _u64p,
                                     _c.c_size_t, _u32p]),
    "dgrep_dfa_scan_mt": (_c.c_size_t, [_c.c_char_p, _c.c_size_t, _u16p,
                                        _c.c_char_p, _c.c_uint32, _u64p,
                                        _c.c_size_t, _c.c_uint32]),
    "dgrep_confirm_build": (_c.c_void_p, [_c.c_char_p, _u32p, _c.c_uint32,
                                          _c.c_int]),
    "dgrep_confirm_free": (None, [_c.c_void_p]),
    "dgrep_confirm_scan": (None, [_c.c_void_p, _c.c_char_p, _c.c_size_t,
                                  _u64p, _c.c_size_t, _u8p, _c.c_uint32]),
    "dgrep_gather_ranges": (None, [_c.c_char_p, _i64p, _i64p, _c.c_size_t,
                                   _u8p]),
    "dgrep_utf8_valid": (_c.c_int, [_c.c_char_p, _c.c_size_t]),
    "dgrep_format_batch": (_c.c_int64, [_c.c_char_p, _c.c_size_t, _i64p,
                                        _i64p, _c.c_char_p, _c.c_size_t,
                                        _c.c_uint8, _u8p, _c.c_size_t]),
    "dgrep_unique_lines": (_c.c_int64, [_u64p, _c.c_int64, _i64p,
                                        _c.c_int64, _i64p]),
    "dgrep_line_spans": (None, [_u64p, _c.c_int64, _i64p, _c.c_int64,
                                _c.c_int64, _i64p, _i64p]),
    "dgrep_build_records": (_c.c_int64, [_c.c_char_p, _c.c_int64, _i64p,
                                         _i64p, _i64p, _c.c_int64,
                                         _c.c_char_p, _c.c_int64,
                                         _c.c_int32, _i64p, _i64p, _u8p,
                                         _i64p, _i64p]),
    "dgrep_merge_display": (_c.c_int64, [_c.c_char_p, _i64p, _c.c_int32,
                                         _u8p]),
    "dgrep_trigram_summary": (None, [_c.c_char_p, _c.c_size_t, _u8p,
                                     _c.c_size_t]),
}
ENTRY_POINTS = tuple(name[len("dgrep_"):] for name in _SIGNATURES)


def lib() -> ctypes.CDLL:
    """The bound library, built first if it has no current build."""
    global _bound
    loaded = _build.load_host("dgrep")
    if loaded is not _bound:
        with _bind_lock:
            if loaded is not _bound:
                for name, (res, args) in _SIGNATURES.items():
                    fn = getattr(loaded, name)
                    fn.restype, fn.argtypes = res, args
                _bound = loaded
    return loaded


def _chars(data):
    """A ``const uint8_t*`` argument for bytes-like ``data``: bytes as
    they are, anything else through a uint8 view (the pointer keeps the
    view, and so ``data``, alive)."""
    if isinstance(data, bytes):
        return data
    return np.frombuffer(data, dtype=np.uint8).ctypes.data_as(ctypes.c_char_p)


def _nbytes(data) -> int:
    return len(data) if isinstance(data, bytes) else memoryview(data).nbytes


def _p(arr: np.ndarray, ptype):
    return arr.ctypes.data_as(ptype)


def _i64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int64)


# --- FNV-32a partition hash (reference ihash, worker.go:13-17) -------------

def _key_bytes(key: str | bytes) -> bytes:
    # keys embed file names whose non-UTF-8 bytes are lone surrogates
    return key.encode("utf-8", "surrogateescape") if isinstance(key, str) else key


def fnv32a(key: str | bytes) -> int:
    data = _key_bytes(key)
    return int(lib().dgrep_fnv32a(data, len(data)))


def fnv32a_py(key: str | bytes) -> int:
    h = 2166136261
    for b in _key_bytes(key):
        h = ((h ^ b) * 16777619) & 0xFFFFFFFF
    return h & 0x7FFFFFFF


def partition(key: str | bytes, n_reduce: int) -> int:
    """ihash(key) % nReduce: the shuffle's partition (worker.go:89)."""
    return fnv32a(key) % n_reduce


# --- newline index ---------------------------------------------------------

def newline_index(data) -> np.ndarray:
    """Byte offsets of every '\\n' of bytes-like ``data``, as int64."""
    n = _nbytes(data)
    ptr = _chars(data)
    cap = max(1024, n // 16)
    while True:
        # int64 offsets are the uint64 the library writes (all < 2**63)
        out = np.empty(cap, dtype=np.int64)
        got = lib().dgrep_newline_index(ptr, n, _p(out, _u64p), cap)
        if got <= cap:
            return out[:got].copy() if got < cap // 2 else out[:got]
        cap = got


# --- literal scan ----------------------------------------------------------

def literal_scan(hay, needle: bytes) -> np.ndarray:
    """End offsets (last byte + 1) of every occurrence of ``needle``,
    overlapping ones included, as int64."""
    if not needle:
        return np.zeros(0, dtype=np.int64)
    n = _nbytes(hay)
    ptr = _chars(hay)
    cap = max(4096, n >> 6)
    while True:
        out = np.empty(cap, dtype=np.int64)
        got = lib().dgrep_literal_scan(ptr, n, needle, len(needle),
                                       _p(out, _u64p), cap)
        if got <= cap:
            return out[:got].copy()
        cap = got


def literal_scan_py(hay, needle: bytes) -> np.ndarray:
    hay = bytes(hay)
    out, at = [], hay.find(needle) if needle else -1
    while at >= 0:
        out.append(at + len(needle))
        at = hay.find(needle, at + 1)
    return np.asarray(out, dtype=np.int64)


# --- DFA scan --------------------------------------------------------------

def _dfa_args(table: np.ndarray, accept: np.ndarray, start: int):
    table = np.ascontiguousarray(table, dtype=np.uint16)
    accept_b = np.ascontiguousarray(accept, dtype=np.uint8).tobytes()
    if (table.ndim != 2 or table.shape[1] != 256
            or len(accept_b) != table.shape[0]
            or not 0 <= start < table.shape[0]):
        raise ValueError("dfa_scan needs an [n_states, 256] table, one "
                         "accept flag a state and a start state below "
                         "n_states")
    return table, accept_b


def dfa_scan(data, table: np.ndarray, accept: np.ndarray,
             start: int = 0) -> tuple[np.ndarray, int]:
    """Feed every byte through the DFA from ``start``: (int64 offsets i+1
    of every byte i after which the state accepts, the final state)."""
    table, accept_b = _dfa_args(table, accept, start)
    n = _nbytes(data)
    ptr = _chars(data)
    final = ctypes.c_uint32(0)
    cap = max(4096, n >> 6)
    while True:
        out = np.empty(cap, dtype=np.int64)
        got = lib().dgrep_dfa_scan(ptr, n, _p(table, _u16p), accept_b, start,
                                   _p(out, _u64p), cap, ctypes.byref(final))
        if got <= cap:
            return out[:got].copy(), int(final.value)
        cap = got


def dfa_scan_py(data, table: np.ndarray, accept: np.ndarray,
                start: int = 0) -> tuple[np.ndarray, int]:
    rows = np.asarray(table).tolist()
    acc = np.asarray(accept, dtype=bool).tolist()
    s, out = int(start), []
    for i, b in enumerate(bytes(data)):
        s = rows[s][b]
        if acc[s]:
            out.append(i + 1)
    return np.asarray(out, dtype=np.int64), s


def dfa_scan_mt(data, table: np.ndarray, accept: np.ndarray, start: int = 0,
                n_threads: int | None = None) -> np.ndarray:
    """``dfa_scan``'s offsets, the data cut at newlines across threads.
    Exact for tables whose every state goes to ``start`` on '\\n' (the
    newline reset of models/dfa.DfaTable)."""
    table, accept_b = _dfa_args(table, accept, start)
    n = _nbytes(data)
    ptr = _chars(data)
    cap = max(4096, n >> 6)
    while True:
        out = np.empty(cap, dtype=np.int64)
        got = lib().dgrep_dfa_scan_mt(
            ptr, n, _p(table, _u16p), accept_b, start, _p(out, _u64p), cap,
            THREADS if n_threads is None else n_threads)
        if got <= cap:
            return out[:got].copy()
        cap = got


# --- literal-set confirm ---------------------------------------------------

def confirm_build(members: list[bytes], ignore_case: bool) -> int:
    """A confirm-set handle over ``members`` (folded by the caller under
    -i; ``ignore_case`` folds the data bytes).  Free it with
    ``confirm_free``."""
    blob = b"".join(members)
    offs = np.zeros(len(members) + 1, dtype=np.uint32)
    np.cumsum([len(m) for m in members], out=offs[1:])
    handle = lib().dgrep_confirm_build(blob, _p(offs, _u32p), len(members),
                                       1 if ignore_case else 0)
    if not handle:
        raise MemoryError("dgrep_confirm_build returned no set")
    return handle


def confirm_free(handle: int) -> None:
    lib().dgrep_confirm_free(handle)


def confirm_scan(handle: int, data, ends: np.ndarray,
                 n_threads: int | None = None) -> np.ndarray:
    """Bool per end offset: does a member end there?"""
    ends = np.ascontiguousarray(ends, dtype=np.int64)
    out = np.zeros(ends.size, dtype=np.uint8)
    if ends.size:
        lib().dgrep_confirm_scan(handle, _chars(data), _nbytes(data),
                                 _p(ends, _u64p), ends.size, _p(out, _u8p),
                                 THREADS if n_threads is None else n_threads)
    return out.view(bool)


# --- the columnar record path ----------------------------------------------

def gather_ranges(arr: np.ndarray, starts: np.ndarray, ends: np.ndarray,
                  total: int) -> bytes:
    """``arr[starts[i]:ends[i]]`` concatenated (``total`` bytes: the
    caller's sum of the lengths) for a 1-D uint8 ``arr``."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype != np.uint8 or arr.ndim != 1:
        raise TypeError("gather_ranges indexes a 1-D uint8 array")
    starts, ends = _i64(starts), _i64(ends)
    out = np.empty(max(int(total), 1), dtype=np.uint8)
    lib().dgrep_gather_ranges(_p(arr, ctypes.c_char_p), _p(starts, _i64p),
                              _p(ends, _i64p), starts.size, _p(out, _u8p))
    return out[: int(total)].tobytes()


def utf8_valid(data) -> bool:
    """True when ``data`` is strict UTF-8 (what Python's decoder accepts)."""
    return bool(lib().dgrep_utf8_valid(_chars(data), _nbytes(data)))


def utf8_valid_py(data) -> bool:
    try:
        bytes(data).decode("utf-8")
    except UnicodeDecodeError:
        return False
    return True


def format_batch(prefix: bytes, linenos: np.ndarray, offsets: np.ndarray,
                 slab: bytes, sep: bytes = b"\t") -> bytes | None:
    """``b"<prefix><N>)<sep><line>\\n"`` per record of a LineBatch, or None
    when a line is not strict UTF-8 or ``sep`` is not one byte (the
    caller's Python leg then decodes utf-8/replace)."""
    if len(sep) != 1:
        return None
    n = int(linenos.size)
    if n == 0:
        return b""
    linenos, offsets = _i64(linenos), _i64(offsets)
    cap = n * (len(prefix) + 23) + len(slab)
    out = np.empty(cap, dtype=np.uint8)
    wrote = lib().dgrep_format_batch(prefix, len(prefix), _p(linenos, _i64p),
                                     _p(offsets, _i64p), _chars(slab), n,
                                     sep[0], _p(out, _u8p), cap)
    if wrote == -2:
        return None
    if wrote < 0:
        raise RuntimeError(f"dgrep_format_batch overran {cap} bytes")
    return out[:wrote].tobytes()


def unique_lines(nl: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """Sorted unique 1-based line numbers of ASCENDING end offsets
    (``ends - 1`` located in the newline index ``nl``)."""
    nl, ends = _i64(nl), _i64(ends)
    out = np.empty(ends.size, dtype=np.int64)
    got = lib().dgrep_unique_lines(_p(nl, _u64p), nl.size, _p(ends, _i64p),
                                   ends.size, _p(out, _i64p))
    return out[:got].copy()


def line_spans(nl: np.ndarray, linenos: np.ndarray,
               n_bytes: int) -> tuple[np.ndarray, np.ndarray]:
    """[start, end) of each 1-based line from the newline index ``nl``."""
    nl, linenos = _i64(nl), _i64(linenos)
    starts = np.empty(linenos.size, dtype=np.int64)
    ends = np.empty(linenos.size, dtype=np.int64)
    lib().dgrep_line_spans(_p(nl, _u64p), nl.size, _p(linenos, _i64p),
                           linenos.size, int(n_bytes), _p(starts, _i64p),
                           _p(ends, _i64p))
    return starts, ends


def build_records(data: np.ndarray, starts: np.ndarray, ends: np.ndarray,
                  linenos: np.ndarray, prefix: bytes, n_reduce: int
                  ) -> dict[int, tuple[np.ndarray, np.ndarray, bytes]]:
    """One pass from record spans of ``data`` to ``{partition: (line
    numbers, offsets, slab)}``: the partition of record i is
    ``fnv32a(prefix + b"%d)" % linenos[i]) % n_reduce``, the records keep
    their order inside a partition.  Raises ValueError on a span outside
    ``data`` or ``n_reduce`` < 1."""
    data = np.ascontiguousarray(data)
    if data.dtype != np.uint8 or data.ndim != 1:
        raise TypeError("build_records indexes a 1-D uint8 array")
    starts, ends, linenos = _i64(starts), _i64(ends), _i64(linenos)
    n = int(linenos.size)
    if n == 0:
        return {}
    total = int(np.sum(ends - starts))
    out_linenos = np.empty(n, dtype=np.int64)
    out_offsets = np.empty(n + 1, dtype=np.int64)
    out_slab = np.empty(max(1, total), dtype=np.uint8)
    counts = np.zeros(max(int(n_reduce), 1), dtype=np.int64)
    nbytes = np.zeros(max(int(n_reduce), 1), dtype=np.int64)
    wrote = lib().dgrep_build_records(
        _p(data, ctypes.c_char_p), data.size, _p(starts, _i64p),
        _p(ends, _i64p), _p(linenos, _i64p), n, prefix, len(prefix),
        int(n_reduce), _p(out_linenos, _i64p), _p(out_offsets, _i64p),
        _p(out_slab, _u8p), _p(counts, _i64p), _p(nbytes, _i64p))
    if wrote < 0:
        raise ValueError(f"build_records: a span outside the {data.size} "
                         f"source bytes, or n_reduce {n_reduce} < 1")
    out = {}
    r0 = b0 = 0
    for p, (c, nb) in enumerate(zip(counts.tolist(), nbytes.tolist())):
        if c:
            out[p] = (out_linenos[r0 : r0 + c].copy(),
                      out_offsets[r0 : r0 + c + 1] - b0,
                      out_slab[b0 : b0 + nb].tobytes())
        r0 += c
        b0 += nb
    return out


def merge_display(bufs: list[bytes]) -> bytes | None:
    """The display lines of pre-sorted mr-out buffers (first tab -> space,
    each line ended by '\\n') merged in (path, line) order, paths compared
    as their surrogateescape-decoded str, ties by buffer order; None when
    a line is not grep-key-shaped (the caller takes its record merge)."""
    data = b"".join(bufs)
    off = np.zeros(len(bufs) + 1, dtype=np.int64)
    np.cumsum([len(b) for b in bufs], out=off[1:])
    # + one byte a buffer: a final line without its '\n' gains one
    out = np.empty(max(1, len(data) + len(bufs)), dtype=np.uint8)
    wrote = lib().dgrep_merge_display(data, _p(off, _i64p), len(bufs),
                                      _p(out, _u8p))
    if wrote < 0:
        return None
    return out[:wrote].tobytes()


# --- trigram summaries (the shard index, ROADMAP item 8) -------------------

_TG_MIX = np.uint64(0x9E3779B97F4A7C15)
_FOLD = np.arange(256, dtype=np.uint8)
_FOLD[65:91] += 32  # ASCII A-Z -> a-z


def trigram_summary_into(data, bloom: np.ndarray) -> None:
    """OR the case-folded trigram bloom of ``data`` into ``bloom`` (uint8,
    C-contiguous, a power-of-two size): two bits a trigram, from one
    64-bit multiply of its 24-bit code."""
    if (bloom.dtype != np.uint8 or not bloom.flags.c_contiguous
            or bloom.size & (bloom.size - 1)):
        raise ValueError("the bloom must be C-contiguous uint8 of a "
                         "power-of-two size")
    lib().dgrep_trigram_summary(_chars(data), _nbytes(data), _p(bloom, _u8p),
                                bloom.size)


def trigram_summary_numpy(data, bloom: np.ndarray) -> None:
    arr = _FOLD[np.frombuffer(data, dtype=np.uint8)].astype(np.uint64)
    if arr.size < 3 or bloom.size == 0:
        return
    codes = (arr[:-2] << np.uint64(16)) | (arr[1:-1] << np.uint64(8)) | arr[2:]
    h = codes * _TG_MIX
    mask = np.uint64(bloom.size * 8 - 1)
    bits = np.unique(np.concatenate([h & mask, (h >> np.uint64(32)) & mask]))
    np.bitwise_or.at(bloom, (bits >> np.uint64(3)).astype(np.int64),
                     np.uint8(1) << (bits & np.uint64(7)).astype(np.uint8))
