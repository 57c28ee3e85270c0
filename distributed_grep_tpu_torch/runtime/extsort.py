"""External sort-merge grouping: the reduce of a non-identity app in
bounded memory.

Records accumulate up to a memory limit; past it they spill as a sorted
run (the shuffle wire format, runtime/shuffle.py) into ``spill_dir``, and
grouping is a lazy k-way merge over the runs and the last in-memory batch.
The counterpart of the reference's ``runtime/extsort.py``.

Determinism (the same as one in-memory sort): keys stream in sorted order,
and within one key the values keep their arrival order -- the merge breaks
ties on (run index, sequence within the run), and runs spill in arrival
order.  ``reduce_fn(key, values)`` gets one key's values as a list; an app
that folds associatively may define ``reduce_stream_fn(key, values_iter)``
instead, which the reduce prefers.
"""

from __future__ import annotations

import heapq
import json
import shutil
import tempfile
from itertools import groupby
from operator import itemgetter
from pathlib import Path
from typing import Iterable, Iterator

from distributed_grep_tpu_torch.apps.base import KeyValue
from distributed_grep_tpu_torch.runtime import shuffle

# Per-record bookkeeping (a tuple and two str objects) counted against the
# limit: the estimate only has to bound memory, not measure it.
_RECORD_OVERHEAD = 120


_KEY = itemgetter(0)
_VALUE = itemgetter(1)


def _by_key(records: Iterable[KeyValue]) -> list[KeyValue]:
    return sorted(records, key=_KEY)


class ExternalReducer:
    """Accumulate KeyValue records under a memory limit; group-reduce them
    by streaming a sorted merge of the spilled runs."""

    def __init__(self, memory_limit_bytes: int = 128 << 20,
                 spill_dir: str | None = None):
        if memory_limit_bytes <= 0:
            raise ValueError("memory_limit_bytes must be positive")
        self.memory_limit = memory_limit_bytes
        self._spill_parent = spill_dir
        self._tmp: str | None = None
        self._mem: list[KeyValue] = []
        self._mem_bytes = 0
        self._runs: list[Path] = []

    @property
    def spill_count(self) -> int:
        return len(self._runs)

    def add_many(self, records: Iterable[KeyValue]) -> None:
        for kv in records:
            self._mem.append(kv)
            self._mem_bytes += len(kv.key) + len(kv.value) + _RECORD_OVERHEAD
            if self._mem_bytes >= self.memory_limit:
                self._spill()

    def _spill(self) -> None:
        if not self._mem:
            return
        if self._tmp is None:
            self._tmp = tempfile.mkdtemp(prefix="dgrep-reduce-",
                                         dir=self._spill_parent)
        run = Path(self._tmp) / f"run-{len(self._runs)}"
        recs = _by_key(self._mem)
        with open(run, "wb") as f:
            for i in range(0, len(recs), 4096):  # bounded encode buffers
                f.write(shuffle.encode_records(recs[i : i + 4096]))
        self._runs.append(run)
        self._mem = []
        self._mem_bytes = 0

    @staticmethod
    def _iter_run(path: Path) -> Iterator[tuple[str, str]]:
        # the wire format escapes '\r' and '\n' inside strings, so the only
        # newlines in a run are the record separators
        with open(path, encoding="utf-8", errors="surrogateescape",
                  newline="\n") as f:
            for line in f:
                line = line.rstrip("\n")
                if line:
                    k, v = json.loads(line)
                    yield k, v

    def merged(self) -> Iterator[tuple[str, str]]:
        """Every record in (key, run index, sequence) order: key-sorted,
        arrival-stable within a key."""
        def tagged(stream, idx):
            return ((k, idx, i, v) for i, (k, v) in enumerate(stream))

        streams = [tagged(self._iter_run(run), idx)
                   for idx, run in enumerate(self._runs)]
        tail = ((kv.key, kv.value) for kv in _by_key(self._mem))
        streams.append(tagged(tail, len(self._runs)))
        for k, _, _, v in heapq.merge(*streams):
            yield k, v

    def reduce(self, reduce_fn, stream_fn=None) -> Iterator[tuple[str, str]]:
        """(key, reduced value) in sorted key order, streamed; ``stream_fn``
        (key, values iterator), when given, is used over ``reduce_fn``."""
        # nothing spilled: one stable sort of the records in memory
        records = self.merged() if self._runs else _by_key(self._mem)
        for k, grp in groupby(records, key=_KEY):
            vals = map(_VALUE, grp)
            yield (k, stream_fn(k, vals)) if stream_fn is not None else (
                k, reduce_fn(k, list(vals)))

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
