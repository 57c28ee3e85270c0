"""In-process coordinator: hands out map then reduce tasks to workers.

The fault-tolerance core of the reference scheduler, without its RPC,
journal, peer shuffle or spans:

* tasks, not workers, are tracked: a worker joins by asking for work;
* an IN_PROGRESS task whose last heartbeat is older than
  ``task_timeout_s`` is re-issued;
* the app's progress callback stamps heartbeats mid-task, and may declare
  a silent phase (``grace_s``, the engine's kernel build) during which
  the task is re-issued only after max(task_timeout_s, grace_s);
* the first committed attempt wins: a later finish of the same task is
  ignored (its files were renamed over identical content).

A map task covers one input file, or a batched split of several small
ones (a list among ``files``, runtime/job.plan_map_splits): its
assignment then names the members in ``filenames``.

Reduce tasks are handed out once every map task has committed.
"""

from __future__ import annotations

import threading
import time
from collections import Counter
from dataclasses import dataclass, field

from distributed_grep_tpu_torch.runtime.types import (
    MapTask,
    ReduceTask,
    TaskState,
    TaskType,
)


@dataclass
class Assignment:
    kind: TaskType | None  # None = the job is over: the worker exits
    task_id: int = -1
    filename: str = ""
    filenames: list[str] = field(default_factory=list)  # a split's members
    files: list[str] = field(default_factory=list)  # reduce inputs
    n_reduce: int = 0
    app_options: dict = field(default_factory=dict)


def _split_label(members: tuple[str, ...]) -> str:
    """A batched split's label (the reference's scheduler._split_label)."""
    return f"{members[0]} (+{len(members) - 1} batched)"


class Scheduler:
    def __init__(self, files: list, n_reduce: int, task_timeout_s: float,
                 app_options: dict | None = None):
        self.maps = []
        for i, f in enumerate(files):
            if isinstance(f, (list, tuple)):
                members = tuple(str(m) for m in f)
                self.maps.append(MapTask(i, _split_label(members),
                                         files=members))
            else:
                self.maps.append(MapTask(i, f))
        self.reduces = [ReduceTask(r) for r in range(n_reduce)]
        self.n_reduce = n_reduce
        self.task_timeout_s = task_timeout_s
        self.app_options = dict(app_options or {})
        self.counters: Counter = Counter()
        self.seconds: Counter = Counter()  # wall time per task stage, summed
        self._cv = threading.Condition()
        self._stopped = False

    # ------------------------------------------------------------ state
    def _all(self, tasks) -> bool:
        return all(t.state is TaskState.COMPLETED for t in tasks)

    def done(self) -> bool:
        with self._cv:
            return self._all(self.maps) and self._all(self.reduces)

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify_all()

    def _sweep(self, kind: TaskType, tasks) -> None:
        now = time.monotonic()
        for t in tasks:
            if (t.state is TaskState.IN_PROGRESS
                    and now - t.timestamp > max(self.task_timeout_s,
                                                t.grace_s)):
                t.state = TaskState.UNASSIGNED
                self.counters[f"{kind.value}_retries"] += 1

    # ---------------------------------------------------------- workers
    def request_task(self, wait_s: float = 0.5) -> Assignment | None:
        """The next task; ``Assignment(None)`` once the job is over or
        stopped; None when nothing is assignable within ``wait_s`` (the
        worker polls again)."""
        deadline = time.monotonic() + wait_s
        with self._cv:
            while True:
                if self._stopped or (self._all(self.maps)
                                     and self._all(self.reduces)):
                    return Assignment(None)
                self._sweep(TaskType.MAP, self.maps)
                self._sweep(TaskType.REDUCE, self.reduces)
                for t in self.maps:
                    if t.state is TaskState.UNASSIGNED:
                        return self._assign(TaskType.MAP, t,
                                            filename=t.file,
                                            filenames=list(t.files))
                if self._all(self.maps):
                    for t in self.reduces:
                        if t.state is TaskState.UNASSIGNED:
                            return self._assign(TaskType.REDUCE, t,
                                                files=list(t.task_files))
                left = deadline - time.monotonic()
                if left <= 0:
                    return None
                self._cv.wait(min(left, self.task_timeout_s))

    def _assign(self, kind: TaskType, t, **fields) -> Assignment:
        t.state = TaskState.IN_PROGRESS
        t.heartbeat()
        self.counters[f"{kind.value}_assigned"] += 1
        return Assignment(kind, t.task_id, n_reduce=self.n_reduce,
                          app_options=dict(self.app_options), **fields)

    def heartbeat(self, kind: TaskType, task_id: int,
                  grace_s: float = 0.0) -> None:
        """Stamp an IN_PROGRESS task's liveness.  A nonzero ``grace_s``
        declares a silent phase of that many seconds; the next stamp
        without one ends it."""
        with self._cv:
            t = (self.maps if kind is TaskType.MAP else self.reduces)[task_id]
            if t.state is TaskState.IN_PROGRESS:
                t.heartbeat(grace_s=max(0.0, float(grace_s)))
                if grace_s > 0:
                    self.counters["grace_declared"] += 1

    def add_seconds(self, stage: str, seconds: float) -> None:
        with self._cv:
            self.seconds[stage] += seconds

    def add_count(self, name: str, n: int) -> None:
        with self._cv:
            self.counters[name] += n

    def map_finished(self, task_id: int, parts: list[int]) -> bool:
        """Register a committed map attempt; False if the task was already
        completed by another attempt (first commit wins)."""
        with self._cv:
            t = self.maps[task_id]
            if t.state is TaskState.COMPLETED:
                return False
            t.state = TaskState.COMPLETED
            for r in parts:
                self.reduces[r].task_files.append(f"mr-{task_id}-{r}")
            self.counters["map_completed"] += 1
            self._cv.notify_all()
            return True

    def reduce_finished(self, task_id: int) -> bool:
        with self._cv:
            t = self.reduces[task_id]
            if t.state is TaskState.COMPLETED:
                return False
            t.state = TaskState.COMPLETED
            self.counters["reduce_completed"] += 1
            self._cv.notify_all()
            return True

    def wait_done(self, timeout: float) -> bool:
        with self._cv:
            return self._cv.wait_for(
                lambda: self._stopped or (self._all(self.maps)
                                          and self._all(self.reduces)),
                timeout,
            ) and not self._stopped
