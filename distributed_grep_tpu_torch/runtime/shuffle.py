"""Shuffle encoding: partitioning and the intermediate-file wire format.

Partitioning is FNV-32a(key) & 0x7FFFFFFF % n_reduce, bit-compatible with
the reference's ihash, so a record lands in the same reduce partition as
it does in the reference package.  Intermediate files are JSON lines of
[key, value] records, encoded utf-8 with surrogateescape (keys embed
filenames, which on POSIX may hold non-UTF-8 bytes), with the grep app's
columnar batches as binary blocks between them.
"""

from __future__ import annotations

import json

import numpy as np

from distributed_grep_tpu_torch.apps.base import KeyValue

# the JSON string encoder json.dumps(..., ensure_ascii=False) uses
_quote = json.encoder.encode_basestring

_FNV_OFFSET = 2166136261
_FNV_PRIME = 16777619


def partition_many(keys: list[str], n_reduce: int) -> np.ndarray:
    """The reduce partition of every key: FNV-32a of the key's utf-8
    (surrogateescape) bytes, masked to 31 bits, mod ``n_reduce``.
    Vectorized over keys with numpy: one FNV step per byte column, masked
    past each key's end."""
    if not keys:
        return np.zeros(0, dtype=np.int64)
    enc = [k.encode("utf-8", "surrogateescape") for k in keys]
    lens = np.fromiter((len(e) for e in enc), dtype=np.int64, count=len(enc))
    flat = np.frombuffer(b"".join(enc), dtype=np.uint8)
    starts = np.concatenate(([0], np.cumsum(lens)[:-1]))
    h = np.full(len(enc), _FNV_OFFSET, dtype=np.uint64)
    prime = np.uint64(_FNV_PRIME)
    mask = np.uint64(0xFFFFFFFF)
    last = max(flat.size - 1, 0)
    for j in range(int(lens.max())):
        active = lens > j
        byte = flat[np.minimum(starts + j, last)].astype(np.uint64)
        h = np.where(active, ((h ^ byte) * prime) & mask, h)
    return ((h & np.uint64(0x7FFFFFFF)) % np.uint64(n_reduce)).astype(np.int64)


def bucketize(records: list, n_reduce: int) -> dict[int, list]:
    """Single-pass partition of map output into reduce buckets, records kept
    in emit order within each bucket.  A record is a KeyValue or a columnar
    ``LineBatch`` (runtime/columnar.py), which is split into one sub-batch
    per partition with the same record-to-partition mapping as its
    KeyValues would get."""
    from distributed_grep_tpu_torch.runtime.columnar import LineBatch

    kvs = [rec for rec in records if not isinstance(rec, LineBatch)]
    parts = iter(partition_many([r.key for r in kvs], n_reduce).tolist())
    buckets: dict[int, list] = {}
    for rec in records:
        if isinstance(rec, LineBatch):
            for r, sub in rec.split_by_partition(n_reduce).items():
                buckets.setdefault(r, []).append(sub)
        else:
            buckets.setdefault(next(parts), []).append(rec)
    return buckets


def encode_records(records: list) -> bytes:
    """JSON lines of [key, value], with each LineBatch as a binary block
    between them (runtime/columnar.encode_batch).  A list without batches
    encodes as plain JSON lines."""
    from distributed_grep_tpu_torch.runtime import columnar

    parts: list[bytes] = []
    jsonl: list[str] = []

    def flush_jsonl() -> None:
        if jsonl:
            parts.append("".join(jsonl).encode("utf-8", "surrogateescape"))
            jsonl.clear()

    for rec in records:
        if isinstance(rec, columnar.LineBatch):
            flush_jsonl()
            parts.append(columnar.encode_batch(rec))
        else:
            # json.dumps([key, value], ensure_ascii=False), one C string
            # encoder call a field
            jsonl.append(f"[{_quote(rec.key)}, {_quote(rec.value)}]\n")
    flush_jsonl()
    return b"".join(parts)


def decode_records(data: bytes) -> list:
    """Inverse of encode_records: a KeyValue per JSON line, a LineBatch per
    block (kept columnar).  A marker starts a block only at a line start: a
    matched line may itself hold the marker text, which JSON embeds as is,
    but never a raw newline."""
    from distributed_grep_tpu_torch.runtime import columnar

    if columnar.MARKER not in data:
        return _decode_jsonl(data)
    out: list = []
    pos, n = 0, len(data)
    while pos < n:
        if data.startswith(columnar.MARKER, pos):
            batch, pos = columnar.decode_batch_at(data, pos)
            out.append(batch)
            continue
        nxt = data.find(b"\n" + columnar.MARKER, pos)
        end = n if nxt < 0 else nxt + 1
        out.extend(_decode_jsonl(data[pos:end]))
        pos = end
    return out


def _decode_jsonl(data: bytes) -> list[KeyValue]:
    """Splits on '\\n' only: JSON escapes '\\n' inside strings, while
    other line separators stay literal."""
    text = data.decode("utf-8", "surrogateescape").strip("\n")
    if not text:
        return []
    # the lines as one JSON array, parsed in one call (a record's JSON
    # holds no raw newline, and empty lines hold none)
    return list(map(KeyValue._make, json.loads(
        "[" + ",".join(x for x in text.split("\n") if x) + "]")))
