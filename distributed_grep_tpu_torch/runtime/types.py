"""Task state tables -- the coordinator's core bookkeeping.

Tasks, not workers, are the tracked entities: workers join by asking for
work.  Each task carries a state and a heartbeat timestamp; an
IN_PROGRESS task whose heartbeat is older than the job's task timeout is
re-issued, or, while a declared grace (``grace_s``, a silent phase such
as a kernel build) is longer than that timeout, older than the grace.
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field


class TaskType(enum.Enum):
    MAP = "map"
    REDUCE = "reduce"


class TaskState(enum.Enum):
    UNASSIGNED = "unassigned"
    IN_PROGRESS = "in_progress"
    COMPLETED = "completed"


@dataclass
class MapTask:
    task_id: int
    file: str  # the input path, or a batched split's label
    state: TaskState = TaskState.UNASSIGNED
    timestamp: float = 0.0  # heartbeat; stamped at assignment + mid-task
    attempts: int = 0
    grace_s: float = 0.0  # the silent phase the last stamp declared
    # a batched split's member paths (runtime/job.plan_map_splits); () for
    # a task of one file
    files: tuple[str, ...] = ()
    # the worker holding the current attempt (-1: none), charged when the
    # attempt times out (scheduler.WorkerHealth)
    worker: int = -1
    # True once that worker stamped the attempt (a heartbeat, a shuffle
    # fetch): proof it received the assignment
    stamped: bool = False
    # True while the current attempt is another assignment's fused
    # participant (Scheduler.claim_map_task): its timeout charges no worker
    fused_claim: bool = False
    # where a committed attempt kept its output (the peer shuffle):
    # {"endpoint", "worker", "parts": {partition: [size, crc32]}}; None on
    # a relay commit (the bytes are in the coordinator's store)
    peer: dict | None = None

    def heartbeat(self, grace_s: float = 0.0) -> None:
        """Stamp liveness; a later stamp without a grace clears it."""
        self.timestamp = time.monotonic()
        self.grace_s = grace_s


@dataclass
class ReduceTask:
    task_id: int
    state: TaskState = TaskState.UNASSIGNED
    timestamp: float = 0.0
    attempts: int = 0
    # Intermediate files registered as map tasks commit; reducers stream
    # them in arrival order (the streaming shuffle).
    task_files: list[str] = field(default_factory=list)
    grace_s: float = 0.0
    worker: int = -1  # see MapTask.worker
    stamped: bool = False  # see MapTask.stamped

    def heartbeat(self, grace_s: float = 0.0) -> None:
        self.timestamp = time.monotonic()
        self.grace_s = grace_s
