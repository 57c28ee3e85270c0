"""Worker loop: ask for a task, run it, commit it, report it.

Map: run the application over one input file -- ``map_path_fn(filename,
path)`` when the app defines it (it reads the file itself, in chunks: the
grep app streams it through ``GrepEngine.scan_file``), else
``map_fn(filename, contents)`` -- or over a batched split's members:
``map_batch_fn(items)`` once, with ``(name, path)`` items when the app
sets ``map_batch_paths`` (it reads them, or serves them from the corpus
cache, itself) and ``(name, bytes)`` otherwise, else ``map_fn`` a member;
bucketize the records by FNV-32a partition (columnar batches split by
partition, runtime/columnar.py), commit one intermediate file per
partition (atomic rename), report the partitions.  Reduce: read the partition's files into a bounded-memory
sink that spills sorted runs into the work dir's ``spill/``: identity-
reduce apps collate in (file, line) order (``IdentityCollator``, batches
stay columnar), every other app groups by key (``ExternalReducer``,
``reduce_stream_fn`` preferred to ``reduce_fn``); commit ``mr-out-<r>``
atomically as ``key<TAB>value`` lines.

``fault_hooks`` maps a point name (so far only "before_map_commit") to a
callable; raising WorkerKilled from it simulates a crash at that point.
"""

from __future__ import annotations

import time
from typing import Callable

from distributed_grep_tpu_torch.runtime import shuffle
from distributed_grep_tpu_torch.runtime.columnar import IdentityCollator, LineBatch
from distributed_grep_tpu_torch.runtime.extsort import ExternalReducer
from distributed_grep_tpu_torch.runtime.scheduler import Assignment, Scheduler
from distributed_grep_tpu_torch.runtime.types import TaskType
from distributed_grep_tpu_torch.utils.io import WorkDir

# Each reduce sink holds this much before it spills a sorted run.
REDUCE_MEMORY_BYTES = 128 << 20


class WorkerKilled(Exception):
    """Raised by fault-injection hooks to simulate a worker crash."""


class WorkerLoop:
    def __init__(self, scheduler: Scheduler, workdir: WorkDir, app,
                 fault_hooks: dict[str, Callable[[], None]] | None = None):
        self.scheduler = scheduler
        self.workdir = workdir
        self.app = app
        self.fault_hooks = fault_hooks or {}

    def _configure(self, a: Assignment) -> None:
        configure = getattr(self.app, "configure", None)
        if configure is not None:
            configure(**a.app_options)

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
        def progress(grace_s: float = 0.0) -> None:
            self.scheduler.heartbeat(kind, task_id, grace_s=grace_s)
        return progress

    def _map(self, a: Assignment) -> None:
        self._configure(a)
        set_progress = getattr(self.app, "set_progress", None)
        if set_progress is not None:
            set_progress(self._progress(TaskType.MAP, a.task_id))
        map_path_fn = getattr(self.app, "map_path_fn", None)
        t0 = time.perf_counter()
        try:
            if a.filenames:
                records, t1 = self._map_split(a.filenames, t0)
            elif map_path_fn is not None:
                t1 = t0  # the app reads the file itself, inside map_fn
                records = map_path_fn(a.filename, a.filename)
            else:
                with open(a.filename, "rb") as f:
                    contents = f.read()
                t1 = time.perf_counter()
                records = self.app.map_fn(a.filename, contents)
        finally:
            if set_progress is not None:
                set_progress(None)
        t2 = time.perf_counter()
        buckets = shuffle.bucketize(records, a.n_reduce)
        self._fault("before_map_commit")
        for r, recs in sorted(buckets.items()):
            self.workdir.write_intermediate(f"mr-{a.task_id}-{r}",
                                            shuffle.encode_records(recs))
        self.scheduler.add_seconds("map_read", t1 - t0)
        self.scheduler.add_seconds("map_fn", t2 - t1)
        self.scheduler.add_seconds("map_shuffle", time.perf_counter() - t2)
        if self.scheduler.map_finished(a.task_id, sorted(buckets)):
            batches = [rec for rec in records if isinstance(rec, LineBatch)]
            self.scheduler.add_count("map_batches", len(batches))
            self.scheduler.add_count("map_records", len(records) - len(batches)
                                     + sum(len(b) for b in batches))

    def _map_split(self, names: list[str], t0: float) -> tuple[list, float]:
        """A batched split's records, and when its reads ended."""
        batch_fn = getattr(self.app, "map_batch_fn", None)
        if batch_fn is not None and getattr(self.app, "map_batch_paths",
                                            False):
            return batch_fn([(n, n) for n in names]), t0
        items = []
        for name in names:
            with open(name, "rb") as f:
                items.append((name, f.read()))
        t1 = time.perf_counter()
        if batch_fn is not None:
            return batch_fn(items), t1
        return [r for name, b in items for r in self.app.map_fn(name, b)], t1

    def _reduce(self, a: Assignment) -> None:
        self._configure(a)
        t0 = time.perf_counter()
        spill_dir = str(self.workdir.spill_dir())
        if getattr(self.app, "reduce_is_identity", False):
            sink = IdentityCollator(REDUCE_MEMORY_BYTES, spill_dir)
            blocks = sink.iter_output_blocks
        else:
            sink = ExternalReducer(REDUCE_MEMORY_BYTES, spill_dir)
            stream_fn = getattr(self.app, "reduce_stream_fn", None)

            def blocks():
                for k, v in sink.reduce(self.app.reduce_fn, stream_fn):
                    yield f"{k}\t{v}\n"
        try:
            for name in a.files:
                sink.add_many(shuffle.decode_records(
                    self.workdir.read_intermediate(name)))
                self.scheduler.heartbeat(TaskType.REDUCE, a.task_id)
            self.workdir.write_output_blocks(a.task_id, blocks())
            spills = sink.spill_count
        finally:
            sink.close()
        self.scheduler.add_seconds("reduce", time.perf_counter() - t0)
        if self.scheduler.reduce_finished(a.task_id):
            self.scheduler.add_count("reduce_spills", spills)
