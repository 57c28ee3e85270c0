"""Control-plane message schema: the five verbs (the reference's
runtime/rpc.py, without the service's and the peer shuffle's fields).

  AssignTask      a worker asks for work; long-polls until a map split or
                  a reduce partition is available, or the job is over.
  MapFinished     a map task's commit notification.
  ReduceFinished  a reduce task's commit notification.
  ReduceNextFile  the streaming shuffle: a reducer asks for its next
                  intermediate file, long-polling until one commits or
                  the map phase ends.
  Heartbeat       a mid-task liveness stamp, with an optional declared
                  silent phase (``grace_s``: a kernel build).

An explicit JOB_DONE assignment ends a worker's loop.  Messages are plain
dicts <-> dataclasses for the JSON transport; optional fields are elided
from the wire at their defaults.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any


class Verb:
    ASSIGN_TASK = "AssignTask"
    MAP_FINISHED = "MapFinished"
    REDUCE_FINISHED = "ReduceFinished"
    REDUCE_NEXT_FILE = "ReduceNextFile"
    HEARTBEAT = "Heartbeat"


class Assignment:
    MAP = "map"
    REDUCE = "reduce"
    JOB_DONE = "job_done"


@dataclass
class AssignTaskArgs:
    worker_id: int = -1  # -1 = not yet registered; the coordinator allocates


@dataclass
class AssignTaskReply:
    assignment: str = Assignment.JOB_DONE
    filename: str = ""
    # a batched split's member files, in order (runtime/job.plan_map_splits);
    # ``filename`` is then the split's label, not a readable path
    filenames: list[str] = field(default_factory=list)
    task_id: int = -1
    n_reduce: int = 0
    worker_id: int = -1
    app_options: dict[str, Any] = field(default_factory=dict)
    # the coordinator's failure-detector window for this task; the worker
    # derives its heartbeat cadence from it (about a third)
    task_timeout_s: float = 10.0
    # "expect no work for this many seconds" on a quarantined worker's
    # retry reply (scheduler.WorkerHealth)
    retry_after_s: float = 0.0
    # a fresh tag per Scheduler: a reduce attempt echoes it on its shuffle
    # fetches, and one from an earlier incarnation (it outlived a
    # coordinator restart, whose task_files order differs) is aborted
    epoch: str = ""


@dataclass
class TaskFinishedArgs:
    task_id: int
    worker_id: int = -1
    # the reduce partitions this map task produced records for
    produced_parts: list[int] = field(default_factory=list)
    # the worker's counters for this attempt: {"counters": {...},
    # "seconds": {...}, "launches": {kernel: n}} (None elided)
    metrics: dict | None = None


@dataclass
class TaskFinishedReply:
    ok: bool = True


@dataclass
class ReduceNextFileArgs:
    task_id: int
    files_processed: int  # the resume-safe cursor
    epoch: str = ""  # the assignment's (AssignTaskReply.epoch)
    # who fetches: only the current assignee's fetches mark the task as
    # held (quarantine attribution)
    worker_id: int = -1
    # a registered file this reducer could not read: its map task runs
    # again, and this attempt is aborted
    lost_file: str = ""


@dataclass
class ReduceNextFileReply:
    next_file: str = ""
    done: bool = False
    # abandon the attempt (no commit, no finished RPC): its cursor belongs
    # to an earlier scheduler incarnation
    abort: bool = False


@dataclass
class HeartbeatArgs:
    task_type: str  # "map" | "reduce"
    task_id: int
    worker_id: int = -1
    # a declared silent phase: "expect no stamp for up to this many
    # seconds"; 0 is a plain stamp, which also ends an earlier grace
    grace_s: float = 0.0


@dataclass
class HeartbeatReply:
    ok: bool = True


_TYPES = {
    "AssignTaskArgs": AssignTaskArgs,
    "AssignTaskReply": AssignTaskReply,
    "TaskFinishedArgs": TaskFinishedArgs,
    "TaskFinishedReply": TaskFinishedReply,
    "ReduceNextFileArgs": ReduceNextFileArgs,
    "ReduceNextFileReply": ReduceNextFileReply,
    "HeartbeatArgs": HeartbeatArgs,
    "HeartbeatReply": HeartbeatReply,
}

# Optional fields elided from serialized arguments at their defaults.
_ELIDE_DEFAULTS: dict[str, Any] = {
    "metrics": None, "filenames": [], "retry_after_s": 0.0, "epoch": "",
    "abort": False, "worker_id": -1, "lost_file": "",
}

# Reply fields dropped from the wire at their (falsy) defaults; the others
# are always there.
_REPLY_ELIDE = ("filenames", "retry_after_s", "epoch", "abort")


def reply_to_dict(msg: Any) -> dict:
    d = dataclasses.asdict(msg)
    for k in _REPLY_ELIDE:
        if not d.get(k, True):
            del d[k]
    return d


def to_dict(msg: Any) -> dict:
    d = dataclasses.asdict(msg)
    for k, default in _ELIDE_DEFAULTS.items():
        if k in d and d[k] == default:
            del d[k]
    return d


def from_dict(cls_name: str, payload: dict) -> Any:
    return _TYPES[cls_name](**payload)
