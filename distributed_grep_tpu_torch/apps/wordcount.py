"""Word count: the second application on the Map/Reduce boundary (the
reference's apps/wordcount.py), with a reduce that is not the identity."""

from __future__ import annotations

import re

from distributed_grep_tpu_torch.apps.base import KeyValue

_WORD = re.compile(r"[A-Za-z]+")


def map_fn(filename: str, contents: bytes) -> list[KeyValue]:
    # latin-1 maps each byte to one code point, and lowercases none of the
    # non-ASCII ones to an ASCII letter: the words, lowercased, of the
    # ASCII letter runs of the bytes
    return [KeyValue(w, "1")
            for w in _WORD.findall(contents.decode("latin-1").lower())]


def reduce_fn(key: str, values: list[str]) -> str:
    return str(sum(int(v) for v in values))


def reduce_stream_fn(key: str, values) -> str:
    """The streaming fold the worker prefers to reduce_fn: a hot key never
    holds its value list in memory (runtime/extsort.py)."""
    return str(sum(int(v) for v in values))
