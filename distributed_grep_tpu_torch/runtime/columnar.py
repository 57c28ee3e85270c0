"""Columnar record batches: the grep app's matched lines as three arrays.

One ``KeyValue`` per matched line through map -> bucketize -> JSONL encode
-> decode -> sort costs tens of microseconds a record; a match-dense query
(``the`` over 1 GiB: millions of lines) spends its wall there, not in the
kernels.  A ``LineBatch`` carries a whole file's (or chunk's) matched lines
as line numbers, a byte slab and slab offsets, and flows through the same
stages with vectorized equivalents:

* partitioning: FNV-32a of each record's key ``"<file> (line number #N)"``,
  vectorized: the per-batch key prefix is folded once, only the line
  number's digits fold per record (grouped by digit count).  Bit-identical
  to ``shuffle.partition_many`` on the formatted key, so a record lands in
  the same reduce partition as its ``KeyValue`` would;
* wire format: one header line and three binary sections per batch,
  between ordinary JSONL records (``runtime/shuffle.py``);
* reduce: identity-reduce apps (reduce is ``values[0]`` and keys are
  unique) collate batches in (file, line) order through
  ``IdentityCollator``, spilling sorted runs past a memory limit, and the
  ``mr-out-*`` files come out in the CLI's display order.

The counterpart of the reference's ``runtime/columnar.py``.  The hot
loops run in the host library (utils/native.py): a batch's split by
partition is one pass from the source bytes (``build_records``: the line
spans, the FNV-32a of each key, the grouping and the slab copies), the
slab gathers and line spans are single loops, and the reduce's text form
is ``format_batch``, which declines a batch holding a line that is not
strict UTF-8 (that batch's text then decodes utf-8/replace in Python).
The numpy and Python legs stay, named ``*_numpy``, as the plain versions
the tests hold the library to.  A map output of ``KeyValue``s alone takes
the per-record path everywhere.
"""

from __future__ import annotations

import heapq
import json
import re
import shutil
import tempfile
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from distributed_grep_tpu_torch.apps.base import KeyValue
from distributed_grep_tpu_torch.utils import native

# Batch block marker inside intermediate files.  JSONL records always start
# with '[' (json.dumps of a [key, value] list), so a line starting with '#'
# is unambiguous.
MARKER = b"#!dgrep-colv1 "

# The grep applications' key shape, end-anchored so values containing
# " (line number #" cannot confuse parsing.
GREP_KEY_RE = re.compile(r"^(.*) \(line number #(\d+)\)$")

_FNV_OFFSET = np.uint64(2166136261)
_FNV_PRIME = np.uint64(16777619)
_U32 = np.uint64(0xFFFFFFFF)


def grep_key_sort(item: tuple[str, str]):
    """Sort key for (key, value) items: grep-style keys order by (file,
    line number); anything else lexicographically."""
    m = GREP_KEY_RE.match(item[0])
    return (m.group(1), int(m.group(2))) if m else (item[0], 0)


@dataclass
class LineBatch:
    """One file's (or chunk's) matched lines, columnar.

    Logically ``[KeyValue(f"{filename} (line number #{n})", text_n) for n
    in linenos]``, ``text_n`` the line's raw bytes, decoded utf-8/replace
    only at output time (the per-record path decodes at emit time; both
    give the same output bytes).

    linenos   int64[n]    1-based line numbers, strictly increasing
    offsets   int64[n+1]  slab offsets; line i = slab[offsets[i]:offsets[i+1]]
    slab      bytes       the lines' bytes, concatenated without separators
    """

    filename: str
    linenos: np.ndarray
    offsets: np.ndarray
    slab: bytes

    def __len__(self) -> int:
        return int(self.linenos.size)

    @property
    def nbytes(self) -> int:
        return len(self.slab) + self.linenos.nbytes + self.offsets.nbytes

    def line_bytes(self, i: int) -> bytes:
        return self.slab[self.offsets[i] : self.offsets[i + 1]]

    def to_keyvalues(self) -> list[KeyValue]:
        """The per-record form (tests, generic consumers)."""
        return [
            KeyValue(f"{self.filename} (line number #{int(n)})",
                     self.line_bytes(i).decode("utf-8", "replace"))
            for i, n in enumerate(self.linenos)
        ]

    def partitions(self, n_reduce: int) -> np.ndarray:
        """FNV-32a(key) & 0x7FFFFFFF % n_reduce per record, vectorized."""
        h0 = _FNV_OFFSET
        for b in (self.filename + " (line number #").encode(
                "utf-8", "surrogateescape"):
            h0 = ((h0 ^ np.uint64(b)) * _FNV_PRIME) & _U32
        v = np.asarray(self.linenos, dtype=np.int64).astype(np.uint64)
        h = np.full(v.size, h0, dtype=np.uint64)
        ndig = np.ones(v.size, dtype=np.int64)
        t = v // np.uint64(10)
        while np.any(t > 0):
            ndig += (t > 0).astype(np.int64)
            t //= np.uint64(10)
        for d in np.unique(ndig).tolist():
            sel = ndig == d
            vv, hh = v[sel], h[sel]
            for k in range(d):
                digit = (vv // np.uint64(10 ** (d - 1 - k))) % np.uint64(10)
                hh = ((hh ^ (digit + np.uint64(48))) * _FNV_PRIME) & _U32
            h[sel] = ((hh ^ np.uint64(41)) * _FNV_PRIME) & _U32  # ')'
        return ((h & np.uint64(0x7FFFFFFF)) % np.uint64(n_reduce)).astype(
            np.int64)

    def select(self, mask: np.ndarray) -> "LineBatch":
        """The sub-batch of the records where ``mask`` is True (the slab
        rebuilt by one vectorized gather)."""
        idx = np.flatnonzero(mask)
        slab, offsets = gather_ranges(
            np.frombuffer(self.slab, dtype=np.uint8), self.offsets[idx],
            self.offsets[idx + 1],
        )
        return LineBatch(self.filename, self.linenos[idx], offsets, slab)

    def split_by_partition(self, n_reduce: int) -> dict[int, "LineBatch"]:
        """Per-reduce sub-batches: one pass of the library over the slab
        (``build_records``)."""
        return _native_split(self.filename,
                             np.frombuffer(self.slab, dtype=np.uint8),
                             self.offsets[:-1], self.offsets[1:],
                             self.linenos, n_reduce)

    def split_by_partition_numpy(self, n_reduce: int) -> dict[int, "LineBatch"]:
        """``split_by_partition``'s plain version: the vectorized hash, one
        gather a partition present."""
        return _numpy_split(self.filename,
                            np.frombuffer(self.slab, dtype=np.uint8),
                            self.offsets[:-1], self.offsets[1:],
                            self.linenos, self.partitions(n_reduce))

    def texts(self) -> list[str]:
        """Per-line decoded text (utf-8/replace): an ASCII slab is decoded
        once and sliced by the offsets; anything else decodes per line."""
        if self.slab.isascii():
            s = self.slab.decode("ascii")
            off = self.offsets.tolist()
            return [s[off[i] : off[i + 1]] for i in range(len(self))]
        return [self.line_bytes(i).decode("utf-8", "replace")
                for i in range(len(self))]

    def format_lines_bytes(self, sep: str = "\t") -> bytes:
        """The mr-out bytes: ``"<file> (line number #N)<sep><text>\\n"``
        per record, encoded utf-8/surrogateescape.  The library copies a
        batch whose lines are all strict UTF-8 (their decode is then the
        identity); any other batch takes ``format_lines_bytes_numpy``."""
        out = native.format_batch(_key_prefix(self.filename), self.linenos,
                                  self.offsets, self.slab, sep.encode())
        return self.format_lines_bytes_numpy(sep) if out is None else out

    def format_lines_bytes_numpy(self, sep: str = "\t") -> bytes:
        """``format_lines_bytes``'s plain version (Python)."""
        head = f"{self.filename} (line number #"
        return "".join(
            f"{head}{n}){sep}{t}\n"
            for n, t in zip(self.linenos.tolist(), self.texts())
        ).encode("utf-8", "surrogateescape")


def _key_prefix(filename: str) -> bytes:
    return (filename + " (line number #").encode("utf-8", "surrogateescape")


def _native_split(filename: str, data: np.ndarray, starts: np.ndarray,
                  ends: np.ndarray, linenos: np.ndarray,
                  n_reduce: int) -> dict[int, LineBatch]:
    """The library's one-pass record build as per-partition LineBatches:
    the one place both split paths (a built batch, a deferred one) encode
    the key prefix."""
    parts = native.build_records(data, starts, ends, linenos,
                                 _key_prefix(filename), n_reduce)
    return {p: LineBatch(filename, ln, off, slab)
            for p, (ln, off, slab) in parts.items()}


def _numpy_split(filename: str, data: np.ndarray, starts: np.ndarray,
                 ends: np.ndarray, linenos: np.ndarray,
                 parts: np.ndarray) -> dict[int, LineBatch]:
    """``_native_split``'s plain version, given each record's partition:
    one gather a partition present."""
    out = {}
    for r in np.unique(parts).tolist():
        sel = np.flatnonzero(parts == r)
        slab, offsets = gather_ranges_numpy(data, starts[sel], ends[sel])
        out[r] = LineBatch(filename, linenos[sel], offsets, slab)
    return out


def _range_offsets(starts: np.ndarray, ends: np.ndarray):
    starts = np.asarray(starts, dtype=np.int64)
    lens = np.asarray(ends, dtype=np.int64) - starts
    offsets = np.zeros(starts.size + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    return starts, lens, offsets


def gather_ranges(arr: np.ndarray, starts: np.ndarray,
                  ends: np.ndarray) -> tuple[bytes, np.ndarray]:
    """Concatenate ``arr[starts[i]:ends[i]]`` for all i (a memcpy a range,
    in the library).  Returns (slab, int64 offsets[n+1])."""
    starts, _lens, offsets = _range_offsets(starts, ends)
    total = int(offsets[-1])
    if total == 0:
        return b"", offsets
    return native.gather_ranges(arr, starts, ends, total), offsets


def gather_ranges_numpy(arr: np.ndarray, starts: np.ndarray,
                        ends: np.ndarray) -> tuple[bytes, np.ndarray]:
    """``gather_ranges``'s plain version: one vectorized gather."""
    starts, lens, offsets = _range_offsets(starts, ends)
    total = int(offsets[-1])
    if total == 0:
        return b"", offsets
    # idx[j] = the step of the source index at output byte j: +1 within a
    # range, and at each range head the jump from the previous range's
    # last byte.  Empty ranges add no output bytes and are dropped first
    # (their heads would collide with the next range's).
    ne = np.flatnonzero(lens > 0)
    s, ln = starts[ne], lens[ne]
    idx = np.ones(total, dtype=np.int64)
    idx[0] = s[0]
    if ne.size > 1:
        idx[offsets[ne[1:]]] = s[1:] - (s[:-1] + ln[:-1] - 1)
    return arr[np.cumsum(idx)].tobytes(), offsets


def line_spans(linenos: np.ndarray, nl_index: np.ndarray,
               n_bytes: int) -> tuple[np.ndarray, np.ndarray]:
    """[start, end) byte span of each 1-based line (the end excludes the
    '\\n'; the last line ends at ``n_bytes`` when no '\\n' closes it):
    one loop of the library."""
    ln = np.asarray(linenos, dtype=np.int64)
    if ln.size == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z.copy()
    return native.line_spans(nl_index, ln, n_bytes)


def line_spans_numpy(linenos: np.ndarray, nl_index: np.ndarray,
                     n_bytes: int) -> tuple[np.ndarray, np.ndarray]:
    """``line_spans``'s plain version (the same clipping of line numbers
    out of range)."""
    ln = np.asarray(linenos, dtype=np.int64)
    if ln.size == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z.copy()
    nl = np.asarray(nl_index, dtype=np.int64)
    if nl.size == 0:  # no newline: only line 1 exists
        return (np.zeros(ln.size, dtype=np.int64),
                np.full(ln.size, n_bytes, dtype=np.int64))
    # np.where evaluates both branches: clip the indexes so the unselected
    # side (line 1, the last line) reads a harmless slot
    starts = np.where(ln == 1, 0, nl[np.clip(ln - 2, 0, nl.size - 1)] + 1)
    ends = np.where(ln - 1 < nl.size, nl[np.clip(ln - 1, 0, nl.size - 1)],
                    n_bytes)
    return starts.astype(np.int64), ends.astype(np.int64)


def make_batch_from_lines(filename: str, linenos: np.ndarray, data: np.ndarray,
                          nl_index: np.ndarray, n_bytes: int,
                          lineno_base: int = 0) -> LineBatch:
    """The LineBatch of the 1-based ``linenos`` of ``data`` (a uint8 view)
    from its newline index.  ``lineno_base`` shifts the stored line numbers
    (file-global numbering for a chunk of a streamed file); the spans come
    from the local numbers."""
    ln = np.asarray(linenos, dtype=np.int64)
    if ln.size == 0:
        return LineBatch(filename, ln, np.zeros(1, dtype=np.int64), b"")
    starts, ends = line_spans(ln, nl_index, n_bytes)
    slab, offsets = gather_ranges(data, starts, ends)
    return LineBatch(filename, ln + lineno_base, offsets, slab)


class DeferredBatch(LineBatch):
    """A LineBatch whose offsets and slab are built on demand from the
    source buffer and its newline index.  The grep app emits these from
    whole-buffer scans: the shuffle then splits them by partition straight
    from the source bytes (the library's one pass), so the whole-batch
    slab is never built on that path.  Any other access (``offsets``,
    ``slab``, ``select``, the wire encoder) materializes the ordinary batch
    once.

    Holds a reference to the source buffer: emit it only where that buffer
    lives as long as the record anyway (a whole-bytes map, or a streamed
    file that fits one chunk)."""

    def __init__(self, filename: str, linenos: np.ndarray, data: np.ndarray,
                 nl_index: np.ndarray, n_bytes: int, lineno_base: int = 0):
        ln = np.asarray(linenos, dtype=np.int64)
        self.filename = filename
        self.linenos = ln + lineno_base  # the stored (key) numbers
        self._local = ln
        self._base = int(lineno_base)
        self._data = data
        self._nl = nl_index
        self._n_bytes = int(n_bytes)
        self._built: LineBatch | None = None

    def _materialized(self) -> LineBatch:
        if self._built is None:
            self._built = make_batch_from_lines(
                self.filename, self._local, self._data, self._nl,
                self._n_bytes, lineno_base=self._base)
        return self._built

    @property
    def offsets(self) -> np.ndarray:  # type: ignore[override]
        return self._materialized().offsets

    @property
    def slab(self) -> bytes:  # type: ignore[override]
        return self._materialized().slab

    def split_by_partition(self, n_reduce: int) -> dict[int, LineBatch]:
        if self._built is not None:
            return self._built.split_by_partition(n_reduce)
        starts, ends = line_spans(self._local, self._nl, self._n_bytes)
        return _native_split(self.filename, self._data, starts, ends,
                             self.linenos, n_reduce)

    def split_by_partition_numpy(self, n_reduce: int) -> dict[int, LineBatch]:
        """``split_by_partition``'s plain version: the vectorized hash,
        one gather a partition."""
        if self._built is not None:
            return self._built.split_by_partition_numpy(n_reduce)
        starts, ends = line_spans_numpy(self._local, self._nl, self._n_bytes)
        return _numpy_split(self.filename, self._data, starts, ends,
                            self.linenos, self.partitions(n_reduce))


# ------------------------------------------------------------- wire format
def encode_batch(b: LineBatch) -> bytes:
    header = MARKER + json.dumps(
        {"file": b.filename, "n": len(b), "slab": len(b.slab)},
        ensure_ascii=False,
    ).encode("utf-8", "surrogateescape") + b"\n"
    return b"".join([
        header,
        np.ascontiguousarray(b.linenos, dtype="<i8").tobytes(),
        np.ascontiguousarray(b.offsets, dtype="<i8").tobytes(),
        b.slab,
        b"\n",
    ])


def _batch_from_body(meta: dict, body, offset: int = 0) -> LineBatch:
    """One block's binary body (linenos, offsets, slab) read from ``body``
    at ``offset``: the one place that knows the section layout."""
    n, slab_len = int(meta["n"]), int(meta["slab"])
    linenos = np.frombuffer(body, dtype="<i8", count=n,
                            offset=offset).astype(np.int64)
    offsets = np.frombuffer(body, dtype="<i8", count=n + 1,
                            offset=offset + n * 8).astype(np.int64)
    slab_at = offset + (2 * n + 1) * 8
    return LineBatch(meta["file"], linenos, offsets,
                     bytes(body[slab_at : slab_at + slab_len]))


def _block_body_len(meta: dict) -> int:
    n = int(meta["n"])
    return n * 8 + (n + 1) * 8 + int(meta["slab"])


def _meta(header: bytes) -> dict:
    return json.loads(header[len(MARKER):].decode("utf-8", "surrogateescape"))


def decode_batch_at(data: bytes, pos: int) -> tuple[LineBatch, int]:
    """Decode the block that starts at ``pos`` (which points at MARKER);
    returns (batch, position after it)."""
    eol = data.index(b"\n", pos)
    meta = _meta(data[pos:eol])
    p = eol + 1
    batch = _batch_from_body(meta, data, offset=p)
    p += _block_body_len(meta)
    if data[p : p + 1] == b"\n":
        p += 1
    return batch, p


def iter_blocks(path):
    """Stream the records of a spill-run file (the shuffle wire format): a
    KeyValue per JSONL line, a LineBatch per block, one at a time."""
    with open(path, "rb") as f:
        while True:
            line = f.readline()
            if not line:
                return
            if line.startswith(MARKER):
                meta = _meta(line)
                yield _batch_from_body(meta, f.read(_block_body_len(meta) + 1))
            elif line.strip():
                k, v = json.loads(line.decode("utf-8", "surrogateescape"))
                yield KeyValue(k, v)


class IdentityCollator:
    """Reduce-side collation for identity-reduce applications (module
    attribute ``reduce_is_identity``: reduce is ``values[0]`` and keys are
    unique, one per (file, line)).

    Orders everything by (file, line number), the CLI's display order, so
    the ``mr-out-*`` files need no later sort.  Batches stay columnar; the
    memory held is bounded by spilling sorted runs, in the shuffle wire
    format, to ``spill_dir``.  Contract: the batches of one file carry
    pairwise disjoint line ranges (one map task per file, one batch per
    chunk), so merge keys of (file, first line) order every record."""

    def __init__(self, memory_limit_bytes: int = 128 << 20,
                 spill_dir: str | None = None):
        self.memory_limit = memory_limit_bytes
        self._spill_parent = spill_dir
        self._tmp: str | None = None
        self._mem: list = []
        self._mem_bytes = 0
        self._runs: list[Path] = []

    @property
    def spill_count(self) -> int:
        return len(self._runs)

    @staticmethod
    def _sort_key(item) -> tuple[str, int, int]:
        if isinstance(item, LineBatch):
            return (item.filename, int(item.linenos[0]) if len(item) else 0, 0)
        m = GREP_KEY_RE.match(item.key)
        if m:
            return (m.group(1), int(m.group(2)), 1)
        return (item.key, 0, 1)

    def add_many(self, records) -> None:
        for rec in records:
            self._mem.append(rec)
            self._mem_bytes += (rec.nbytes + 256 if isinstance(rec, LineBatch)
                                else len(rec.key) + len(rec.value) + 120)
            if self._mem_bytes >= self.memory_limit:
                self._spill()

    def _spill(self) -> None:
        from distributed_grep_tpu_torch.runtime import shuffle

        if not self._mem:
            return
        if self._tmp is None:
            self._tmp = tempfile.mkdtemp(prefix="dgrep-collate-",
                                         dir=self._spill_parent)
        run = Path(self._tmp) / f"run-{len(self._runs)}"
        self._mem.sort(key=self._sort_key)
        with open(run, "wb") as f:
            for i in range(0, len(self._mem), 1024):
                f.write(shuffle.encode_records(self._mem[i : i + 1024]))
        self._runs.append(run)
        self._mem = []
        self._mem_bytes = 0

    def merged(self):
        """Every item (LineBatch or KeyValue) in (file, line) order."""
        self._mem.sort(key=self._sort_key)
        streams = [iter_blocks(run) for run in self._runs]
        streams.append(iter(self._mem))
        return heapq.merge(*streams, key=self._sort_key)

    def iter_output_blocks(self):
        """The mr-out content in display order: bytes per batch, str per
        loose KeyValue (the writer encodes str utf-8/surrogateescape)."""
        for item in self.merged():
            if isinstance(item, LineBatch):
                if len(item):
                    yield item.format_lines_bytes()
            else:
                yield f"{item.key}\t{item.value}\n"

    def close(self) -> None:
        if self._tmp is not None:
            shutil.rmtree(self._tmp, ignore_errors=True)
            self._tmp = None
        self._mem = []
        self._runs = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
