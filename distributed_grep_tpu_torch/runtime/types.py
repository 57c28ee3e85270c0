"""Task state tables -- the coordinator's core bookkeeping.

Tasks, not workers, are the tracked entities: workers join by asking for
work.  Each task carries a state and a heartbeat timestamp; an
IN_PROGRESS task whose heartbeat is older than the job's task timeout is
re-issued.
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
    file: str  # the input path: one map task per input file
    state: TaskState = TaskState.UNASSIGNED
    timestamp: float = 0.0  # heartbeat; stamped at assignment + mid-task

    def heartbeat(self) -> None:
        self.timestamp = time.monotonic()


@dataclass
class ReduceTask:
    task_id: int
    state: TaskState = TaskState.UNASSIGNED
    timestamp: float = 0.0
    # Intermediate files registered as map tasks commit, read in order.
    task_files: list[str] = field(default_factory=list)

    def heartbeat(self) -> None:
        self.timestamp = time.monotonic()
