"""Worker loop: ask for a task, run it, commit it, report it.

Map: run the application's map over one input file, bucketize the records
by FNV-32a partition, commit one intermediate file per partition (atomic
rename), report the partitions.  Reduce: read the partition's files,
group by key (identity-reduce apps skip grouping and sort records by
(file, line)), commit ``mr-out-<r>`` atomically as ``key<TAB>value`` lines.

``fault_hooks`` maps a point name (so far only "before_map_commit") to a
callable; raising WorkerKilled from it simulates a crash at that point.
"""

from __future__ import annotations

import itertools
import re
import time
from pathlib import Path
from typing import Callable

from distributed_grep_tpu_torch.runtime import shuffle
from distributed_grep_tpu_torch.runtime.scheduler import Assignment, Scheduler
from distributed_grep_tpu_torch.runtime.types import TaskType
from distributed_grep_tpu_torch.utils.io import WorkDir

# The grep applications' key shape, end-anchored so values containing
# " (line number #" can't confuse parsing.
GREP_KEY_RE = re.compile(r"^(.*) \(line number #(\d+)\)$")


def grep_key_sort(item: tuple[str, str]):
    """Sort key for (key, value) items: grep-style keys order by (file,
    line number); anything else lexicographically."""
    m = GREP_KEY_RE.match(item[0])
    return (m.group(1), int(m.group(2))) if m else (item[0], 0)


class WorkerKilled(Exception):
    """Raised by fault-injection hooks to simulate a worker crash."""


class WorkerLoop:
    def __init__(self, scheduler: Scheduler, workdir: WorkDir, app,
                 fault_hooks: dict[str, Callable[[], None]] | None = None):
        self.scheduler = scheduler
        self.workdir = workdir
        self.app = app
        self.fault_hooks = fault_hooks or {}

    def _fault(self, point: str) -> None:
        hook = self.fault_hooks.get(point)
        if hook:
            hook()

    def run(self) -> None:
        while True:
            a = self.scheduler.request_task()
            if a is None:
                continue
            if a.kind is None:
                return
            if a.kind is TaskType.MAP:
                self._map(a)
            else:
                self._reduce(a)

    def _progress(self, kind: TaskType, task_id: int):
        def progress() -> None:
            self.scheduler.heartbeat(kind, task_id)
        return progress

    def _map(self, a: Assignment) -> None:
        self.app.configure(**a.app_options)
        set_progress = getattr(self.app, "set_progress", None)
        if set_progress is not None:
            set_progress(self._progress(TaskType.MAP, a.task_id))
        t0 = time.perf_counter()
        try:
            contents = Path(a.filename).read_bytes()
            t1 = time.perf_counter()
            records = self.app.map_fn(a.filename, contents)
        finally:
            if set_progress is not None:
                set_progress(None)
        t2 = time.perf_counter()
        buckets = shuffle.bucketize(records, a.n_reduce)
        self._fault("before_map_commit")
        for r, kvs in sorted(buckets.items()):
            self.workdir.write_intermediate(f"mr-{a.task_id}-{r}",
                                            shuffle.encode_records(kvs))
        self.scheduler.add_seconds("map_read", t1 - t0)
        self.scheduler.add_seconds("map_fn", t2 - t1)
        self.scheduler.add_seconds("map_shuffle", time.perf_counter() - t2)
        self.scheduler.map_finished(a.task_id, sorted(buckets))

    def _reduce(self, a: Assignment) -> None:
        self.app.configure(**a.app_options)
        t0 = time.perf_counter()
        records = []
        for name in a.files:
            records.extend(shuffle.decode_records(
                self.workdir.read_intermediate(name)))
            self.scheduler.heartbeat(TaskType.REDUCE, a.task_id)
        if getattr(self.app, "reduce_is_identity", False):
            records.sort(key=grep_key_sort)
            out = [f"{k}\t{v}\n" for k, v in records]
        else:
            records.sort(key=lambda kv: kv.key)
            out = [
                f"{k}\t{self.app.reduce_fn(k, [kv.value for kv in group])}\n"
                for k, group in itertools.groupby(records, key=lambda kv: kv.key)
            ]
        data = "".join(out).encode("utf-8", "surrogateescape")
        self.workdir.write_output(a.task_id, data)
        self.scheduler.add_seconds("reduce", time.perf_counter() - t0)
        self.scheduler.reduce_finished(a.task_id)
