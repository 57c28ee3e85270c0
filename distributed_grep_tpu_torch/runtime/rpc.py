"""Control-plane message schema: the five verbs (the reference's
runtime/rpc.py).

  AssignTask      a worker asks for work; long-polls until a map split or
                  a reduce partition is available, or the job is over.
  MapFinished     a map task's commit notification.
  ReduceFinished  a reduce task's commit notification.
  ReduceNextFile  the streaming shuffle: a reducer asks for its next
                  intermediate file, long-polling until one commits or
                  the map phase ends.
  Heartbeat       a mid-task liveness stamp, with an optional declared
                  silent phase (``grace_s``: a kernel build).

With the span pipeline on (utils/spans.py) the Heartbeat and the
finished RPCs carry the worker's buffered span records (``spans``, with
``spans_seq``, the batch number the coordinator dedups a retry by), and
the Heartbeat the worker's send time and last round trip (``sent_at``,
``rtt_s``) for the coordinator's clock-offset estimate.

The service daemon (runtime/service.py) multiplexes many jobs over one
worker attach: its assignments carry the job's id and application
(``AssignTaskReply.job_id`` / ``.application``), a fused map's other
participants (``AssignTaskReply.fused``), and every task RPC echoes the
``job_id`` back.  A one-shot coordinator leaves them empty, and then they
are absent from the wire: its payloads are the bytes they were before
the fields existed.

The peer shuffle (runtime/peer.py) adds riders that stay off the wire at
their defaults, so a payload with the peer shuffle off is the relay
protocol's bytes: the worker's shuffle endpoint on each assign poll
(``AssignTaskArgs.peer_endpoint``), a map commit's endpoint and
per-partition ``[size, crc32]`` (``TaskFinishedArgs.peer_endpoint`` /
``.peer_parts``), where a reduce's next file lives
(``ReduceNextFileReply.peer_endpoint`` / ``.peer_size`` /
``.peer_checksum``), and a file the reducer could not fetch
(``ReduceNextFileArgs.lost_file``).

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
    # the worker's peer-shuffle data endpoint ("http://host:port"), on
    # every poll, so the service's worker table shows who holds spool
    # state; "" (off the wire) with the peer shuffle off
    peer_endpoint: str = ""


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
    # the service's job of this task and the application to run it with
    # (a worker attached to the daemon serves a stream of jobs); empty on
    # a one-shot coordinator
    job_id: str = ""
    application: str = ""
    # "expect no work for this many seconds" on a quarantined worker's
    # retry reply (scheduler.WorkerHealth)
    retry_after_s: float = 0.0
    # a fresh tag per Scheduler: a reduce attempt echoes it on its shuffle
    # fetches, and one from an earlier incarnation (it outlived a
    # coordinator restart, whose task_files order differs) is aborted
    epoch: str = ""
    # a fused map's other participants, riding this assignment: one scan
    # serves every one (ops/fuse.py).  Each a dict shaped like a map
    # assignment ({job_id, task_id, filename, filenames, n_reduce,
    # app_options, task_timeout_s, epoch}, Scheduler.claim_map_task).
    # Empty, and then absent from the wire: the payload is the bytes it
    # was before the field existed.
    fused: list = field(default_factory=list)


@dataclass
class TaskFinishedArgs:
    task_id: int
    job_id: str = ""  # the service job of the task (the assignment's)
    worker_id: int = -1
    # the reduce partitions this map task produced records for
    produced_parts: list[int] = field(default_factory=list)
    # the worker's counters for this attempt: {"counters": {...},
    # "seconds": {...}, "launches": {kernel: n}} (None elided); with the
    # span pipeline on also "piggyback", the loop's Metrics snapshot
    metrics: dict | None = None
    # the span pipeline's last flush of the attempt (elided when empty)
    spans: list[dict] = field(default_factory=list)
    spans_seq: int = -1
    # a map commit that kept its output on the producing worker's spool:
    # its endpoint and {partition: [size, crc32-hex]}.  The commit record
    # carries the same; these are the live attempt's truth when a re-run
    # map replaces a vanished producer.  Off the wire on a relay commit.
    peer_endpoint: str = ""
    peer_parts: dict | None = None


@dataclass
class TaskFinishedReply:
    ok: bool = True


@dataclass
class ReduceNextFileArgs:
    task_id: int
    files_processed: int  # the resume-safe cursor
    job_id: str = ""  # the service job of the task (the assignment's)
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
    # where next_file lives when its map kept it on the producer's spool:
    # the reducer fetches GET <peer_endpoint>/shuffle/<job>/<name> and
    # checks size and crc32 against these
    peer_endpoint: str = ""
    peer_size: int = 0
    peer_checksum: str = ""


@dataclass
class HeartbeatArgs:
    task_type: str  # "map" | "reduce"
    task_id: int
    job_id: str = ""  # the service job of the task (the assignment's)
    worker_id: int = -1
    # a declared silent phase: "expect no stamp for up to this many
    # seconds"; 0 is a plain stamp, which also ends an earlier grace
    grace_s: float = 0.0
    # the span pipeline's piggyback (elided at the defaults)
    spans: list[dict] = field(default_factory=list)
    spans_seq: int = -1
    metrics: dict | None = None  # the loop's Metrics snapshot
    sent_at: float = 0.0  # the worker's wall clock at send; 0 = off
    rtt_s: float = -1.0  # the previous heartbeat's round trip; -1 unknown


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
    "abort": False, "worker_id": -1, "lost_file": "", "spans": [],
    "spans_seq": -1, "sent_at": 0.0, "rtt_s": -1.0, "fused": [],
    "job_id": "", "application": "",
    "peer_endpoint": "", "peer_parts": None,
}

# Reply fields dropped from the wire at their (falsy) defaults; the others
# are always there.
_REPLY_ELIDE = ("job_id", "application", "filenames", "retry_after_s",
                "epoch", "fused", "abort",
                "peer_endpoint", "peer_size", "peer_checksum")


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
