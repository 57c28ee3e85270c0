"""Inverted index: the third application on the Map/Reduce boundary (the
reference's apps/inverted_index.py).  Map emits (word, filename) for each
distinct word of the split; Reduce folds the filenames into
``"<count> file1,file2,..."``, sorted and de-duplicated."""

from __future__ import annotations

import re

from distributed_grep_tpu_torch.apps.base import KeyValue

_word_re = re.compile(rb"[A-Za-z]+")
_min_len = 1


def configure(min_word_len: int = 1, **_: object) -> None:
    global _min_len
    _min_len = int(min_word_len)


def map_fn(filename: str, contents: bytes) -> list[KeyValue]:
    words = {w.lower().decode("ascii") for w in _word_re.findall(contents)
             if len(w) >= _min_len}
    return [KeyValue(key=w, value=filename) for w in sorted(words)]


def reduce_fn(key: str, values: list[str]) -> str:
    files = sorted(set(values))
    return f"{len(files)} {','.join(files)}"
