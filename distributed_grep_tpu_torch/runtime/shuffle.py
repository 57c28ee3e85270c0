"""Shuffle encoding: partitioning and the intermediate-file wire format.

Partitioning is FNV-32a(key) & 0x7FFFFFFF % n_reduce, bit-compatible with
the reference's ihash, so a record lands in the same reduce partition as
it does in the reference package.  Intermediate files are JSON lines of
[key, value] records, encoded utf-8 with surrogateescape (keys embed
filenames, which on POSIX may hold non-UTF-8 bytes).
"""

from __future__ import annotations

import json

import numpy as np

from distributed_grep_tpu_torch.apps.base import KeyValue

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


def bucketize(records: list[KeyValue], n_reduce: int) -> dict[int, list]:
    """Single-pass partition of map output into reduce buckets, records
    kept in emit order within each bucket."""
    parts = partition_many([r.key for r in records], n_reduce)
    buckets: dict[int, list] = {}
    for r, rec in zip(parts.tolist(), records):
        buckets.setdefault(r, []).append(rec)
    return buckets


def encode_records(records: list[KeyValue]) -> bytes:
    return "".join(
        json.dumps([rec.key, rec.value], ensure_ascii=False) + "\n"
        for rec in records
    ).encode("utf-8", "surrogateescape")


def decode_records(data: bytes) -> list[KeyValue]:
    """Inverse of encode_records.  Splits on '\\n' only: JSON escapes '\\n'
    inside strings, while other line separators stay literal."""
    out: list[KeyValue] = []
    for line in data.decode("utf-8", "surrogateescape").split("\n"):
        if line:
            k, v = json.loads(line)
            out.append(KeyValue(k, v))
    return out
