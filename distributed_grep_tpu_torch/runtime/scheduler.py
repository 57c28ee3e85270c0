"""Coordinator task scheduler: the reference's runtime/scheduler.py.

* one map task per input file, or per batched split of small files (a
  list among ``files``, runtime/job.plan_map_splits), and reduce
  partitions 0..n_reduce-1, all seeded up front;
* a long-polling ``assign_task``: blocks until a map task is available;
  once every map task has committed, hands out reduce partitions; worker
  ids are allocated at the first assignment;
* a re-issued file keeps its task id (the queues hold task ids);
* the streaming shuffle: ``reduce_next_file`` blocks until the reducer's
  next intermediate file commits, or answers done once the map phase is
  over and the cursor is exhausted, so a reducer's stream follows the
  maps' commits; an attempt from an earlier scheduler incarnation (its
  ``epoch``) is aborted; a reducer that cannot read a registered file
  reports it (``lost_file``) and the producing map task runs again;
* the peer shuffle (runtime/peer.py): a map commit that kept its output
  on its worker's spool registers the endpoint and each partition's size
  and crc32 (the finished RPC's, else the commit record's), and a reduce's
  next-file reply for such a file carries them; a lost-file report walks
  the COMPLETED map back to UNASSIGNED and charges the vanished producer
  (its WorkerHealth), and the stale-epoch check runs before it, so a
  zombie's report never re-runs this incarnation's maps;
* heartbeats stamped at assignment, mid-task and on every next-file
  fetch; a ``grace_s`` declares a silent phase (a kernel build) during
  which the task is re-issued only after max(task_timeout_s, grace_s),
  and the next stamp ends it; a background sweeper re-enqueues every
  IN_PROGRESS task silent for longer;
* a worker charged with three timeouts in a row is quarantined
  (``WorkerHealth``);
* ``claim_map_task`` hands a given idle map task, on its first attempt
  only, to another task's fused assignment (the service daemon's fusion
  planner, runtime/service.py; ``fused_assigned`` counts them).  Such an
  attempt's timeout charges no worker: the K schedulers of one fused
  attempt share the service's WorkerHealth, and the primary assignment's
  timeout carries the one charge;
* ``on_change``, for a layer that multiplexes many schedulers (the
  service's assign loop, which waits on its own condition): called
  outside the lock whenever work may have become assignable here (a map
  commit, a lost output's re-run, a timeout's re-enqueue).  A one-shot
  coordinator passes none;
* completion is idempotent: a duplicate MapFinished/ReduceFinished is
  absorbed; a task's commit record (runtime/store.py), when one resolves,
  is the unit of truth for the partitions it produced;
* the journal (runtime/journal.py) appends every completion, fsync'd
  outside the lock before the reply leaves; a restarted coordinator
  replays it (``resume_entries``) and skips the committed work.  A map
  re-completed after a lost output is journaled once.  A ``journal_gate``
  (the service's work-root lease, runtime/lease.py) is asked before each
  flush batch, in flush context: False drops the batch (the daemon was
  deposed and the promoted one owns the journal).

The counters (assignments, completions, retries, heartbeats, grace
declarations, and what workers ship with their finished RPCs) and the
seconds per worker stage are plain dicts that ``JobResult.metrics``,
``--metrics`` and ``GET /status`` read.  The typed instruments of
utils/metrics.py (the assign long-poll, the map and reduce phases, the
re-issued tasks and quarantines) feed ``GET /metrics``.  A per-worker
table (``worker_status``) holds each worker's last contact, its task, the
Metrics snapshot it shipped and its clock offset.

With an ``event_log`` (the span pipeline on) the scheduler persists the
span batches workers ship (deduplicated by their batch number, so an RPC
retry lands once) and its own decisions as coordinator-row instants
(``assign_map``, ``map_committed``, ``assign_reduce``,
``reduce_committed``, ``task_timeout``, ``grace_declared``,
``quarantine``, ``map_lost_output``), staged under the lock and written
after it; and estimates each worker's clock offset from the heartbeats'
send times and round trips (``ClockSync``, persisted as ``worker_clock``
records).
"""

from __future__ import annotations

import os
import threading
import time
import uuid
from collections import Counter, deque
from typing import Any, Callable, Optional

from distributed_grep_tpu_torch.runtime import rpc
from distributed_grep_tpu_torch.runtime.journal import TaskJournal
from distributed_grep_tpu_torch.runtime.types import (
    MapTask,
    ReduceTask,
    TaskState,
)
from distributed_grep_tpu_torch.utils import lockdep
from distributed_grep_tpu_torch.utils import metrics as metrics_mod
from distributed_grep_tpu_torch.utils.logging import get_logger
from distributed_grep_tpu_torch.utils.spans import ClockSync, EventLog

log = get_logger("scheduler")

# The process's typed instruments (GET /metrics): scheduling latency and
# the failure detector's activity.
_H_ASSIGN_POLL = metrics_mod.histogram("dgrep_assign_poll_seconds")
_H_MAP_PHASE = metrics_mod.histogram("dgrep_map_phase_seconds")
_H_REDUCE_PHASE = metrics_mod.histogram("dgrep_reduce_phase_seconds")
_C_REQUEUED = metrics_mod.counter("dgrep_tasks_requeued_total")
_C_QUARANTINED = metrics_mod.counter("dgrep_workers_quarantined_total")

# Consecutive attributed timeouts before a worker is quarantined, and the
# base window (doubling per episode up to _QUARANTINE_MAX_FACTOR times).
QUARANTINE_AFTER_FAILURES = 3
DEFAULT_QUARANTINE_S = 30.0
_QUARANTINE_MAX_FACTOR = 8


def env_worker_quarantine_s(default: float = DEFAULT_QUARANTINE_S) -> float:
    """The base quarantine window, DGREP_WORKER_QUARANTINE_S (malformed or
    <= 0 keeps the default)."""
    raw = os.environ.get("DGREP_WORKER_QUARANTINE_S")
    if raw is None or raw == "":
        return default
    try:
        v = float(raw)
    except ValueError:
        return default
    return v if v > 0 else default


class WorkerHealth:
    """Per-worker consecutive-failure tracker with exponential-backoff
    quarantine.  A failure is an attributed task timeout (the sweeper
    re-enqueued a task this worker held); a success is any committed task.
    After QUARANTINE_AFTER_FAILURES failures in a row the worker gets no
    assignment for base * 2^(episode-1) seconds (capped); its polls wait
    and answer a retry with a ``retry_after_s`` hint.  Expiry is
    probation: one more timeout quarantines again (for twice as long),
    one success clears the record."""

    def __init__(self, base_s: float | None = None):
        self.base_s = (env_worker_quarantine_s() if base_s is None
                       else float(base_s))
        self._lock = lockdep.make_lock("worker-health")
        self._fails: dict[int, int] = {}
        self._episodes: dict[int, int] = {}
        self._until: dict[int, float] = {}  # monotonic expiry
        self._polls: dict[int, float] = {}  # last assign poll
        self.quarantined_total = 0
        # the service's fleet-timeline stage (runtime/daemon_log.py):
        # called outside the lock with quarantine, quarantine_expire and
        # quarantine_clear, once an episode however many schedulers share
        # this tracker
        self.on_event: Callable[..., None] | None = None

    def _emit(self, kind: str, **payload) -> None:
        cb = self.on_event
        if cb is not None:
            try:
                cb(kind, **payload)
            except Exception:  # noqa: BLE001 -- telemetry, never fatal
                log.exception("worker-health event hook failed")

    def saw(self, worker_id: int) -> None:
        """Record an assign poll: a worker loop is single-threaded, so a
        poll after an assignment proves it no longer runs that task."""
        if worker_id >= 0:
            with self._lock:
                self._polls[worker_id] = time.monotonic()

    def polled_since(self, worker_id: int, t: float) -> bool:
        with self._lock:
            return self._polls.get(worker_id, float("-inf")) > t

    def record_success(self, worker_id: int) -> None:
        if worker_id < 0:
            return
        with self._lock:
            had_episode = worker_id in self._episodes
            for d in (self._fails, self._episodes, self._until,
                      self._polls):
                d.pop(worker_id, None)
        if had_episode:
            self._emit("quarantine_clear", worker=worker_id)

    def record_failure(self, worker_id: int) -> float:
        """Register an attributed failure; the quarantine window entered,
        in seconds, or 0.0 while the worker stays on probation."""
        if worker_id < 0:
            return 0.0
        with self._lock:
            now = time.monotonic()
            if self._until.get(worker_id, 0.0) > now:
                return 0.0  # already quarantined
            n = self._fails.get(worker_id, 0) + 1
            self._fails[worker_id] = n
            if n < QUARANTINE_AFTER_FAILURES:
                return 0.0
            ep = self._episodes.get(worker_id, 0) + 1
            self._episodes[worker_id] = ep
            window = self.base_s * min(2 ** (ep - 1), _QUARANTINE_MAX_FACTOR)
            self._until[worker_id] = now + window
            self._fails[worker_id] = QUARANTINE_AFTER_FAILURES - 1
            self.quarantined_total += 1
        self._emit("quarantine", worker=worker_id, episode=ep,
                   window_s=round(window, 3))
        return window

    def quarantine_remaining(self, worker_id: int) -> float:
        with self._lock:
            until = self._until.get(worker_id)
            if until is None:
                return 0.0
            rem = until - time.monotonic()
            if rem > 0:
                return rem
            del self._until[worker_id]  # expired: probation
        self._emit("quarantine_expire", worker=worker_id)
        return 0.0

    def snapshot(self) -> dict:
        now = time.monotonic()
        with self._lock:
            return {
                "quarantined_total": self.quarantined_total,
                "active": {str(w): round(u - now, 3)
                           for w, u in self._until.items() if u > now},
            }


def _piggyback(metrics: dict | None) -> dict | None:
    """The Metrics snapshot a finished RPC's metrics carry with the span
    pipeline on (utils/spans.py), or None."""
    return (metrics or {}).get("piggyback")


def _split_label(members: tuple[str, ...]) -> str:
    """A batched split's label: the same for the same member list, so a
    replayed journal recognizes its own entries."""
    return f"{members[0]} (+{len(members) - 1} batched)"


def _producer_task_of(name: str) -> int | None:
    """The map task id of an intermediate file name ``mr-<tid>-<r>``."""
    parts = name.split("-")
    if len(parts) == 3 and parts[0] == "mr" and parts[1].isdigit():
        return int(parts[1])
    return None


class Scheduler:
    """Transport-agnostic coordinator state machine (thread-safe).

    ``files`` entries are an input path (a map task a file) or a list of
    paths (a batched split)."""

    def __init__(
        self,
        files: list,
        n_reduce: int,
        task_timeout_s: float = 10.0,
        sweep_interval_s: float = 1.0,
        app_options: Optional[dict[str, Any]] = None,
        journal: Optional[TaskJournal] = None,
        resume_entries: Optional[list[dict]] = None,
        commit_resolver: Optional[Callable] = None,
        worker_health: Optional[WorkerHealth] = None,
        event_log: Optional[EventLog] = None,
        on_change: Optional[Callable[[], None]] = None,
        daemon_events: Optional[Callable[..., None]] = None,
        journal_gate: Optional[Callable[[], bool]] = None,
    ):
        self.n_reduce = n_reduce
        self.task_timeout_s = task_timeout_s
        self.sweep_interval_s = sweep_interval_s
        self.app_options = dict(app_options or {})
        self.journal = journal
        # commit_resolver(kind, task_id) -> the winning task commit record
        # or None (WorkDir.resolve_task_commit)
        self.commit_resolver = commit_resolver
        self.worker_health = worker_health or WorkerHealth()
        # the multiplexing layer's wake-up (module docstring) and its
        # fleet-timeline stage (runtime/daemon_log.py); None costs nothing
        self.on_change = on_change
        self.daemon_events = daemon_events
        # the daemon's write fence (None: no lease, no check)
        self.journal_gate = journal_gate
        self.counters: Counter = Counter()
        self.seconds: Counter = Counter()  # wall time per worker stage
        self.launches: Counter = Counter()  # kernel launches workers shipped
        # completions staged under the lock and journaled (fsync) after it
        self._pending_journal: list[tuple] = []
        self._journal_flush_lock = lockdep.make_lock("journal-flush",
                                                     io_ok=True)
        self._journaled: set[tuple[str, int]] = set()
        # the span pipeline: None is off (no file, no work on any RPC)
        self.event_log = event_log
        self._pending_events: list[dict] = []  # staged under the lock
        self._events_writing = 0  # staged batches being written
        self._span_seqs: dict[int, set[int]] = {}  # worker -> batch seqs
        self._span_seq_lock = lockdep.make_lock("span-seq")
        self._clock = ClockSync()
        # worker id -> {"seen": monotonic, "task": "map:3" | None,
        # "metrics": its last Metrics snapshot, "clock_offset_s", "rtt_s"}
        self.workers: dict[int, dict] = {}
        self._lock = lockdep.make_lock("scheduler")
        self._cond = threading.Condition(self._lock)

        self.map_tasks: list[MapTask] = []
        for i, f in enumerate(files):
            if isinstance(f, (list, tuple)):
                members = tuple(str(m) for m in f)
                self.map_tasks.append(MapTask(i, _split_label(members),
                                              files=members))
            else:
                self.map_tasks.append(MapTask(i, f))
        self.reduce_tasks = [ReduceTask(i) for i in range(n_reduce)]
        self._map_queue: deque[int] = deque(range(len(self.map_tasks)))
        self._reduce_queue: deque[int] = deque(range(n_reduce))
        self._next_worker_id = 0
        self.epoch = uuid.uuid4().hex[:12]
        self._stopped = False
        # COMPLETED is terminal except for a lost-file re-run, so counting
        # at the transitions replaces sweeps over the task tables
        self._maps_completed = 0
        self._reduces_completed = 0
        # the phase histograms: construction to the last map commit, then
        # to the last reduce commit, each observed once
        self._phase_t0 = time.monotonic()
        self._reduce_t0: float | None = None
        self._phase_observed = False
        if resume_entries:
            self._replay(resume_entries)
            # a resumed map phase that was over is not observed again
            self._phase_observed = self._map_phase_done_locked()
        self._sweeper = threading.Thread(target=self._sweep_loop,
                                         name="failure-detector", daemon=True)
        self._sweeper.start()

    # ------------------------------------------------------------ replay
    def _resolve_commit(self, kind: str, task_id: int):
        """The winning commit record, or None (no resolver, no record, or a
        resolver that failed: the finished RPC's args then stand)."""
        if self.commit_resolver is None:
            return None
        try:
            return self.commit_resolver(kind, task_id)
        except Exception:  # noqa: BLE001 -- the RPC args still work
            log.exception("commit record resolution failed for %s %d", kind,
                          task_id)
            return None

    def _replay(self, entries: list[dict]) -> None:
        """Apply journal entries: a restarted coordinator skips the work
        they record."""
        for e in entries:
            tid = e.get("task_id", -1)
            if e.get("kind") == "map_done" and 0 <= tid < len(self.map_tasks):
                t = self.map_tasks[tid]
                files_e = e.get("files")
                if t.file != e.get("file") or (
                        files_e is not None and tuple(files_e) != t.files):
                    # the input list changed since the journal was written:
                    # this entry names another split, which must run again
                    log.warning("journal entry for map task %d names %r, the "
                                "task is %r; ignored", tid, e.get("file"),
                                t.file)
                    continue
                parts = e.get("parts", [])
                peer = None
                if e.get("has_record"):
                    record = self._resolve_commit("map", tid)
                    if record is None:
                        log.warning("journal says map task %d committed with "
                                    "a record, and none resolves; re-running",
                                    tid)
                        continue
                    parts = record.get("parts", parts)
                    # peer-held output: the record's metadata outlives the
                    # coordinator (a producer dead too fails the first
                    # fetch, and the lost-output path re-runs the task)
                    if isinstance(record.get("peer"), dict):
                        peer = record["peer"]
                if t.state is not TaskState.COMPLETED:
                    t.state = TaskState.COMPLETED
                    t.peer = peer
                    self._journaled.add(("map", tid))
                    self._register_map_outputs(tid, parts)
            elif (e.get("kind") == "reduce_done"
                  and 0 <= tid < len(self.reduce_tasks)):
                if (e.get("has_record")
                        and self._resolve_commit("reduce", tid) is None):
                    log.warning("journal says reduce task %d committed with "
                                "a record, and none resolves; re-running",
                                tid)
                    continue
                self.reduce_tasks[tid].state = TaskState.COMPLETED
                self._journaled.add(("reduce", tid))
        self._map_queue = deque(t.task_id for t in self.map_tasks
                                if t.state is not TaskState.COMPLETED)
        self._reduce_queue = deque(t.task_id for t in self.reduce_tasks
                                   if t.state is not TaskState.COMPLETED)
        self._maps_completed = len(self.map_tasks) - len(self._map_queue)
        self._reduces_completed = self.n_reduce - len(self._reduce_queue)
        log.info("journal replay: %d map + %d reduce tasks already complete",
                 self._maps_completed, self._reduces_completed)

    # ---------------------------------------------------------- journal
    def _flush_journal(self) -> None:
        """Write the staged completions outside the scheduler lock (the
        journal fsyncs each).  Never raises: a full disk costs resume, not
        the control plane."""
        if self.journal is None:
            return
        with self._journal_flush_lock:
            self._write_staged_journal()

    def close_journal(self) -> None:
        """Flush the staged completions, then close the journal."""
        if self.journal is None:
            return
        with self._journal_flush_lock:
            self._write_staged_journal()
            self.journal.close()

    def _write_staged_journal(self) -> None:
        with self._lock:
            if not self._pending_journal:
                return
            pending, self._pending_journal = self._pending_journal, []
        if self.journal_gate is not None and not self.journal_gate():
            # deposed: the commit records keep the tasks' truth, and the
            # promoted daemon's replay never sees a stale line
            log.warning("journal flush fenced: lease lost, %d staged entries "
                        "dropped", len(pending))
            return
        for kind, task_id, file, parts, has_record, files in pending:
            try:
                if kind == "map":
                    self.journal.map_completed(task_id, file, parts,
                                               has_record=has_record,
                                               files=files)
                else:
                    self.journal.reduce_completed(task_id,
                                                  has_record=has_record)
            except ValueError:
                # closed by a teardown racing a late completion: the task
                # is committed either way
                log.warning("journal append after close dropped (%s task "
                            "%d)", kind, task_id)
            except OSError:
                log.exception("journal append failed for %s task %d", kind,
                              task_id)

    # ----------------------------------------------------------- status
    def status_counts(self) -> dict:
        with self._lock:
            return {
                "map": {"total": len(self.map_tasks),
                        "completed": self._maps_completed},
                "reduce": {"total": self.n_reduce,
                           "completed": self._reduces_completed},
            }

    def inflight_status(self) -> list[dict]:
        """Every IN_PROGRESS task with its heartbeat age and grace."""
        now = time.monotonic()
        out = []
        with self._lock:
            for kind, table in (("map", self.map_tasks),
                                ("reduce", self.reduce_tasks)):
                for t in table:
                    if t.state is TaskState.IN_PROGRESS:
                        age = now - t.timestamp
                        row = {"type": kind, "task_id": t.task_id,
                               "attempts": t.attempts, "worker": t.worker,
                               "heartbeat_age_s": round(age, 3)}
                        if t.grace_s:
                            row["grace_s"] = t.grace_s
                            row["grace_remaining_s"] = round(
                                max(0.0, t.grace_s - age), 3)
                        out.append(row)
        return out

    def metrics_snapshot(self) -> dict:
        """Copies of the counters, the stage seconds and the shipped
        kernel launches."""
        with self._lock:
            return {"counters": dict(self.counters),
                    "seconds": dict(self.seconds),
                    "launches": dict(self.launches)}

    def _add_metrics_locked(self, metrics: dict | None,
                            accepted: bool) -> None:
        """Fold a worker's shipped counters in: seconds and launches
        always, counters only for the attempt that won."""
        if not metrics:
            return
        for k, v in (metrics.get("seconds") or {}).items():
            self.seconds[k] += float(v)
        for k, v in (metrics.get("launches") or {}).items():
            self.launches[k] += int(v)
        if accepted:
            for k, v in (metrics.get("counters") or {}).items():
                self.counters[k] += v

    # ---------------------------------------------------- observability
    def _event(self, name: str, **args) -> None:
        """Stage a coordinator-row instant (no worker tag: row 0 of
        trace-export); callers hold the lock, ``_flush_events`` writes it
        after.  A no-op without an event log."""
        if self.event_log is None:
            return
        self._pending_events.append({
            "t": "instant", "name": name, "cat": "sched",
            "ts": time.time(), **({"args": args} if args else {})})

    def _flush_events(self) -> None:
        """Write the staged events outside the lock; never raises."""
        if self.event_log is None:
            return
        with self._lock:
            if not self._pending_events:
                return
            pending, self._pending_events = self._pending_events, []
            self._events_writing += 1
        try:
            self._persist_spans(pending)
        finally:
            with self._cond:
                self._events_writing -= 1
                self._cond.notify_all()

    def _persist_spans(self, recs: list[dict], worker_id: int = -1,
                       seq: int = -1) -> None:
        """Persist a batch of records; a worker's batch whose (worker, seq)
        was persisted already (an RPC retry's) is dropped."""
        if self.event_log is None or not recs:
            return
        if seq >= 0 and worker_id >= 0:
            with self._span_seq_lock:
                seen = self._span_seqs.setdefault(worker_id, set())
                if seq in seen:
                    return
                seen.add(seq)
        try:
            self.event_log.write_many(recs)
        except Exception:  # noqa: BLE001 -- telemetry never fails the job
            log.exception("event log write failed")

    def _worker_seen(self, worker_id: int, task: str | None = ...,
                     metrics: dict | None = None) -> None:
        """Stamp a worker's row (under the lock); ``task`` left out keeps
        its task, and the process token of ``metrics`` is dropped."""
        if worker_id < 0:
            return
        info = self.workers.setdefault(worker_id, {"task": None})
        info["seen"] = time.monotonic()
        if task is not ...:
            info["task"] = task
        if metrics is not None:
            metrics = dict(metrics)
            metrics.pop("proc", None)
            info["metrics"] = metrics

    def _observe_clock(self, args: rpc.HeartbeatArgs,
                       recv_at: float) -> None:
        """Fold a heartbeat's clock observation in (under the lock); a
        ``worker_clock`` record is staged when the estimate moves more
        than 5 ms (trace-export reads each worker's last)."""
        prev = self._clock.offsets.get(args.worker_id)
        off = self._clock.observe(args.worker_id, args.sent_at, recv_at,
                                  args.rtt_s)
        if off is None:
            return
        info = self.workers.get(args.worker_id)
        if info is not None:
            info["clock_offset_s"] = off
            info["rtt_s"] = self._clock.rtts.get(args.worker_id)
        if self.event_log is not None and (prev is None
                                           or abs(off - prev) > 0.005):
            self._pending_events.append({
                "t": "worker_clock", "worker": args.worker_id,
                "offset_s": round(off, 6),
                "rtt_s": round(self._clock.rtts.get(args.worker_id, 0.0), 6),
                "ts": time.time()})

    def worker_status(self) -> dict:
        """Per worker: the age of its last contact, its task, the Metrics
        snapshot it last shipped, its clock offset and any quarantine."""
        now = time.monotonic()
        with self._lock:
            out = {}
            for wid, info in sorted(self.workers.items()):
                row: dict = {
                    "last_heartbeat_age_s": round(now - info["seen"], 3),
                    "task": info.get("task")}
                if info.get("metrics") is not None:
                    row["metrics"] = info["metrics"]
                if info.get("clock_offset_s") is not None:
                    row["clock_offset_s"] = round(info["clock_offset_s"], 6)
                q = self.worker_health.quarantine_remaining(wid)
                if q > 0:
                    row["quarantined_s"] = round(q, 3)
                out[str(wid)] = row
            return out

    # ------------------------------------------------------------ assign
    def assign_task(self, args: rpc.AssignTaskArgs,
                    timeout: float = 30.0) -> rpc.AssignTaskReply:
        """Long-poll for work: a task, JOB_DONE once the job is over or
        stopped, or after ``timeout`` a retry reply (task_id -2)."""
        t0 = time.monotonic()
        try:
            return self._assign_task(args, t0 + timeout)
        finally:
            if timeout > 0:  # a real long poll
                _H_ASSIGN_POLL.observe(time.monotonic() - t0)
            self._flush_events()

    def _assign_task(self, args: rpc.AssignTaskArgs,
                     deadline: float) -> rpc.AssignTaskReply:
        with self._cond:
            worker_id = args.worker_id
            if worker_id < 0:
                worker_id = self._next_worker_id
                self._next_worker_id += 1
            # before any assignment stamp: a poll, then an assignment in
            # one call reads as polled before held
            self.worker_health.saw(worker_id)
            while True:
                if self._stopped or self._done_locked():
                    return rpc.AssignTaskReply(
                        assignment=rpc.Assignment.JOB_DONE,
                        worker_id=worker_id)
                quarantine_s = self.worker_health.quarantine_remaining(
                    worker_id)
                if quarantine_s > 0:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return rpc.AssignTaskReply(
                            assignment="retry", task_id=-2,
                            worker_id=worker_id,
                            retry_after_s=round(quarantine_s, 3))
                    self._cond.wait(min(remaining, quarantine_s,
                                        self.sweep_interval_s))
                    continue
                while self._map_queue and (
                        self.map_tasks[self._map_queue[0]].state
                        is not TaskState.UNASSIGNED):
                    # a stale entry: re-enqueued, then completed by its
                    # first attempt (or already re-assigned)
                    self._map_queue.popleft()
                if self._map_queue:
                    task = self.map_tasks[self._map_queue.popleft()]
                    self._start_attempt(task, worker_id, "map")
                    return rpc.AssignTaskReply(
                        assignment=rpc.Assignment.MAP, filename=task.file,
                        filenames=list(task.files), task_id=task.task_id,
                        n_reduce=self.n_reduce, worker_id=worker_id,
                        app_options=self.app_options,
                        task_timeout_s=self.task_timeout_s, epoch=self.epoch)
                while self._reduce_queue and (
                        self.reduce_tasks[self._reduce_queue[0]].state
                        is not TaskState.UNASSIGNED):
                    self._reduce_queue.popleft()
                if self._map_phase_done_locked() and self._reduce_queue:
                    task = self.reduce_tasks[self._reduce_queue.popleft()]
                    self._start_attempt(task, worker_id, "reduce")
                    return rpc.AssignTaskReply(
                        assignment=rpc.Assignment.REDUCE,
                        task_id=task.task_id, n_reduce=self.n_reduce,
                        worker_id=worker_id, app_options=self.app_options,
                        task_timeout_s=self.task_timeout_s, epoch=self.epoch)
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return rpc.AssignTaskReply(assignment="retry", task_id=-2,
                                               worker_id=worker_id)
                self._cond.wait(min(remaining, self.sweep_interval_s))

    def _start_attempt(self, task, worker_id: int, kind: str,
                       fused: bool = False) -> None:
        task.state = TaskState.IN_PROGRESS
        task.heartbeat()
        task.attempts += 1
        task.worker = worker_id
        task.stamped = False  # no evidence from the worker yet
        if kind == "map":
            task.fused_claim = fused  # a fused participant is not charged
        self.counters[f"{kind}_assigned"] += 1
        self._worker_seen(worker_id, task=f"{kind}:{task.task_id}")
        if fused:
            self.counters["fused_assigned"] += 1
            self._event("assign_map", task=task.task_id, worker=worker_id,
                        attempt=task.attempts, file=task.file, fused=True)
        elif kind == "map":
            self._event("assign_map", task=task.task_id, worker=worker_id,
                        attempt=task.attempts, file=task.file)
        else:
            self._event("assign_reduce", task=task.task_id, worker=worker_id,
                        attempt=task.attempts)
        log.debug("assign %s task %d -> worker %d", kind, task.task_id,
                  worker_id)

    def claim_map_task(self, task_id: int, worker_id: int) -> dict | None:
        """Claim one given idle map task for a fused attempt (ops/fuse.py):
        the task joins another task's assignment, so this is the assign
        loop's map branch without the queue pop (its queue entry is then
        stale and skipped).  First attempts only: a task that timed out
        once runs alone again.  Returns the fields of its entry in the
        reply's ``fused`` list, or None (not idle, retried, bad id, or
        stopped)."""
        try:
            with self._cond:
                if self._stopped or not 0 <= task_id < len(self.map_tasks):
                    return None
                task = self.map_tasks[task_id]
                if task.state is not TaskState.UNASSIGNED or task.attempts:
                    return None
                self._start_attempt(task, worker_id, "map", fused=True)
                return {
                    "task_id": task_id,
                    "filename": task.file,
                    "filenames": list(task.files),
                    "n_reduce": self.n_reduce,
                    "app_options": self.app_options,
                    "task_timeout_s": self.task_timeout_s,
                    "epoch": self.epoch,
                }
        finally:
            self._flush_events()

    # -------------------------------------------------------- completion
    def map_finished(self, args: rpc.TaskFinishedArgs) -> rpc.TaskFinishedReply:
        """Idempotent map commit."""
        record = self._resolve_commit("map", args.task_id)
        self._persist_spans(args.spans, args.worker_id, args.spans_seq)
        try:
            with self._cond:
                self._worker_seen(args.worker_id, task=None,
                                  metrics=_piggyback(args.metrics))
                self.worker_health.record_success(args.worker_id)
                task = self.map_tasks[args.task_id]
                if task.state is TaskState.COMPLETED:
                    self._add_metrics_locked(args.metrics, accepted=False)
                    return rpc.TaskFinishedReply(ok=True)  # a duplicate
                task.state = TaskState.COMPLETED
                self._maps_completed += 1
                # the commit record, when it resolves, says what was
                # produced; the RPC's args otherwise
                parts = args.produced_parts
                if record is not None and "parts" in record:
                    parts = record["parts"]
                # peer-held output: the live attempt's args win over the
                # record (the resolved record can still be a dead
                # producer's after a lost-output re-run; a wrong endpoint
                # costs one more lost round, never wrong bytes: the crc);
                # a relay commit clears it
                peer = None
                if record is not None and isinstance(record.get("peer"),
                                                     dict):
                    peer = record["peer"]
                if args.peer_endpoint:
                    peer = {"endpoint": args.peer_endpoint,
                            "worker": args.worker_id,
                            "parts": dict(args.peer_parts or {})}
                task.peer = peer
                self._register_map_outputs(args.task_id, parts)
                self.counters["map_completed"] += 1
                if self._map_phase_done_locked() and not self._phase_observed:
                    self._phase_observed = True
                    self._reduce_t0 = time.monotonic()
                    _H_MAP_PHASE.observe(self._reduce_t0 - self._phase_t0)
                self._add_metrics_locked(args.metrics, accepted=True)
                if self.journal and ("map", args.task_id) not in self._journaled:
                    self._journaled.add(("map", args.task_id))
                    self._pending_journal.append((
                        "map", args.task_id, task.file, parts,
                        record is not None, list(task.files) or None))
                self._event("map_committed", task=args.task_id,
                            worker=args.worker_id, parts=len(parts),
                            has_record=record is not None)
                log.info("map task %d done (%d/%d)", args.task_id,
                         self._maps_completed, len(self.map_tasks))
                self._cond.notify_all()
                return rpc.TaskFinishedReply(ok=True)
        finally:
            self._flush_journal()  # fsync before the reply leaves
            self._flush_events()
            self._notify_change()  # the last map commit unlocks the reduces

    def _notify_change(self) -> None:
        """Wake the multiplexing layer's assign loop (``on_change``); never
        raises: a failing callback must not fail a commit."""
        cb = self.on_change
        if cb is None:
            return
        try:
            cb()
        except Exception:  # noqa: BLE001 -- an advisory wake-up
            log.exception("scheduler on_change callback failed")

    def _register_map_outputs(self, map_task_id: int,
                              produced_parts: list[int]) -> None:
        """Register a committed map task's files with their partitions
        (only the partitions it produced records for)."""
        for r in produced_parts:
            if 0 <= r < self.n_reduce:
                name = f"mr-{map_task_id}-{r}"
                if name not in self.reduce_tasks[r].task_files:
                    self.reduce_tasks[r].task_files.append(name)

    def reduce_finished(self, args: rpc.TaskFinishedArgs
                        ) -> rpc.TaskFinishedReply:
        record = self._resolve_commit("reduce", args.task_id)
        self._persist_spans(args.spans, args.worker_id, args.spans_seq)
        try:
            with self._cond:
                self._worker_seen(args.worker_id, task=None,
                                  metrics=_piggyback(args.metrics))
                self.worker_health.record_success(args.worker_id)
                task = self.reduce_tasks[args.task_id]
                accepted = task.state is not TaskState.COMPLETED
                if accepted:
                    task.state = TaskState.COMPLETED
                    self._reduces_completed += 1
                    self.counters["reduce_completed"] += 1
                    if self._done_locked():
                        _H_REDUCE_PHASE.observe(
                            time.monotonic()
                            - (self._reduce_t0 or self._phase_t0))
                    if self.journal and (("reduce", args.task_id)
                                         not in self._journaled):
                        self._journaled.add(("reduce", args.task_id))
                        self._pending_journal.append((
                            "reduce", args.task_id, None, None,
                            record is not None, None))
                    self._event("reduce_committed", task=args.task_id,
                                worker=args.worker_id,
                                has_record=record is not None)
                    log.info("reduce task %d done (%d/%d)", args.task_id,
                             self._reduces_completed, self.n_reduce)
                self._add_metrics_locked(args.metrics, accepted=accepted)
                self._cond.notify_all()
                return rpc.TaskFinishedReply(ok=True)
        finally:
            self._flush_journal()
            self._flush_events()

    # ------------------------------------------------- streaming shuffle
    def reduce_next_file(self, args: rpc.ReduceNextFileArgs,
                         timeout: float = 30.0) -> rpc.ReduceNextFileReply:
        """The streaming shuffle: block until the reducer's next
        intermediate file exists, or answer done once the map phase is
        over and the cursor is exhausted.  Doubles as a heartbeat.  A
        ``lost_file`` report re-enqueues the producing map task and
        aborts the reporter, whose reduce task is re-enqueued too."""
        if args.epoch and args.epoch != self.epoch:
            # an attempt of an earlier incarnation: its cursor indexes
            # another task_files order
            log.warning("aborting reduce attempt for task %d: stale epoch %s "
                        "(current %s)", args.task_id, args.epoch, self.epoch)
            return rpc.ReduceNextFileReply(abort=True)
        deadline = time.monotonic() + timeout
        if args.lost_file:
            requeued = False
            try:
                with self._cond:
                    requeued = self._report_lost_locked(args)
                    if requeued:
                        return rpc.ReduceNextFileReply(abort=True)
            finally:
                self._flush_events()
                if requeued:
                    self._notify_change()  # the map is assignable again
        with self._cond:
            task = self.reduce_tasks[args.task_id]
            while True:
                task.heartbeat()
                if args.worker_id < 0 or args.worker_id == task.worker:
                    task.stamped = True
                if args.files_processed < len(task.task_files):
                    reply = self._serve_file_locked(
                        task.task_files[args.files_processed])
                    if reply is not None:
                        return reply
                    # its producer runs again (a lost file): wait as for a
                    # file that has not arrived
                elif self._map_phase_done_locked():
                    return rpc.ReduceNextFileReply(done=True)
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return rpc.ReduceNextFileReply()  # the client re-polls
                self._cond.wait(min(remaining, self.sweep_interval_s))

    def _serve_file_locked(self, name: str) -> rpc.ReduceNextFileReply | None:
        """The reply for one registered file, or None while its producing
        map runs again (a lost output).  A peer-held file's reply says
        where it lives and its size and crc32."""
        tid = _producer_task_of(name)
        mt = (self.map_tasks[tid]
              if tid is not None and 0 <= tid < len(self.map_tasks) else None)
        if mt is not None and mt.state is not TaskState.COMPLETED:
            return None
        reply = rpc.ReduceNextFileReply(next_file=name)
        if mt is not None and mt.peer:
            meta = mt.peer.get("parts", {}).get(name.rsplit("-", 1)[1])
            if meta:
                reply.peer_endpoint = str(mt.peer.get("endpoint", ""))
                reply.peer_size = int(meta[0])
                reply.peer_checksum = str(meta[1])
        return reply

    def _report_lost_locked(self, args: rpc.ReduceNextFileArgs) -> bool:
        """A reducer could not read a registered intermediate file: the
        producing map task is re-enqueued (first report wins), the worker
        that kept it on its spool (a peer-held output) is charged, and
        the reporter's reduce task is re-enqueued too, so the pool can run
        the map.  True when the map was re-enqueued."""
        tid = _producer_task_of(args.lost_file)
        if tid is None or not 0 <= tid < len(self.map_tasks):
            log.warning("ignoring a lost-file report for %r: not an "
                        "intermediate file name", args.lost_file)
            return False
        task = self.map_tasks[tid]
        if task.state is not TaskState.COMPLETED:
            return False  # already running again: the cursor waits
        producer = int((task.peer or {}).get("worker", -1))
        log.warning("map task %d's file %s was lost (producer worker %d, "
                    "reported by worker %d); re-running the task", tid,
                    args.lost_file, producer, args.worker_id)
        task.state = TaskState.UNASSIGNED
        task.peer = None
        task.worker = -1
        task.stamped = False
        self._maps_completed -= 1
        self._map_queue.append(tid)
        self.counters["maps_lost_output"] += 1
        self.counters["map_retries"] += 1
        self.counters["tasks_requeued"] += 1
        _C_REQUEUED.inc()
        metrics_mod.counter("dgrep_maps_lost_output_total").inc()
        self._event("map_lost_output", task=tid, file=args.lost_file,
                    producer=producer, reporter=args.worker_id)
        if self.daemon_events is not None:
            # a daemon-level decision: on the fleet timeline too
            self.daemon_events("map_lost_output", task=tid,
                               producer=producer)
        if producer >= 0:
            # the producer held committed output and vanished: the
            # sweeper's attributed timeout, charged here
            window = self.worker_health.record_failure(producer)
            if window > 0:
                self.counters["workers_quarantined"] += 1
                _C_QUARANTINED.inc()
                self._event("quarantine", worker=producer,
                            window_s=round(window, 3))
        rt = (self.reduce_tasks[args.task_id]
              if 0 <= args.task_id < len(self.reduce_tasks) else None)
        if rt is not None and rt.state is TaskState.IN_PROGRESS and (
                args.worker_id < 0 or rt.worker in (-1, args.worker_id)):
            rt.state = TaskState.UNASSIGNED
            rt.worker = -1
            rt.stamped = False
            self._reduce_queue.append(args.task_id)
            self.counters["reduce_retries"] += 1
            self.counters["tasks_requeued"] += 1
            _C_REQUEUED.inc()
        self._cond.notify_all()
        return True

    # ---------------------------------------------------------- liveness
    def heartbeat(self, task_type: str, task_id: int, grace_s: float = 0.0,
                  worker_id: int = -1,
                  args: rpc.HeartbeatArgs | None = None) -> None:
        """Stamp an IN_PROGRESS task's liveness.  A nonzero ``grace_s``
        declares a silent phase of that many seconds; the next stamp
        without one ends it.  A task the sweeper already re-enqueued takes
        no stamp (a straggler must not resurrect it).  ``args``, the whole
        HeartbeatArgs, brings the span pipeline's piggyback: its span batch
        is persisted, its Metrics snapshot lands in the worker's row, and
        its send time and round trip feed the clock-offset estimate."""
        # the arrival time first: the estimate prices the transit at rtt/2
        recv_at = time.time()
        if args is not None:
            worker_id = args.worker_id
            self._persist_spans(args.spans, args.worker_id, args.spans_seq)
        try:
            with self._cond:
                if args is not None:
                    self._worker_seen(args.worker_id, metrics=args.metrics)
                    self._observe_clock(args, recv_at)
                table = (self.map_tasks if task_type == "map"
                         else self.reduce_tasks)
                if not 0 <= task_id < len(table):
                    return
                task = table[task_id]
                if task.state is not TaskState.IN_PROGRESS:
                    return
                g = max(0.0, float(grace_s))
                if g > 0 and task.grace_s != g:
                    # on the transition only: a retried grace stamp
                    # declares the same window again
                    self._event("grace_declared", task=task_id,
                                type=task_type, worker=worker_id, grace_s=g)
                task.heartbeat(grace_s=g)
                if worker_id < 0 or worker_id == task.worker:
                    task.stamped = True
                self.counters["heartbeats"] += 1
                if g > 0:
                    self.counters["grace_declared"] += 1
        finally:
            self._flush_events()

    def sweep(self) -> bool:
        """One pass of the failure detector: re-enqueue every IN_PROGRESS
        task silent for longer than max(task_timeout_s, its grace), and
        charge the worker that held it when there is evidence it held it
        (a stamp) or is gone (no poll since).  True if any was."""
        requeued = False
        failed: set[int] = set()
        with self._cond:
            now = time.monotonic()
            for kind, table, queue in (
                    ("map", self.map_tasks, self._map_queue),
                    ("reduce", self.reduce_tasks, self._reduce_queue)):
                for task in table:
                    if (task.state is TaskState.IN_PROGRESS
                            and now - task.timestamp
                            >= max(self.task_timeout_s, task.grace_s)):
                        log.warning("%s task %d timed out; re-enqueueing",
                                    kind, task.task_id)
                        if (task.stamped
                                or not self.worker_health.polled_since(
                                    task.worker, task.timestamp)) and not (
                                        getattr(task, "fused_claim", False)):
                            # charged with evidence the worker held the
                            # task or is gone; a fused participant never
                            # (the primary's timeout is the one charge)
                            failed.add(task.worker)
                        self._event("task_timeout", type=kind,
                                    task=task.task_id, attempt=task.attempts,
                                    worker=task.worker)
                        task.state = TaskState.UNASSIGNED
                        task.worker = -1
                        queue.append(task.task_id)
                        requeued = True
                        self.counters[f"{kind}_retries"] += 1
                        self.counters["tasks_requeued"] += 1
                        _C_REQUEUED.inc()
            for wid in sorted(failed):
                window = self.worker_health.record_failure(wid)
                if window > 0:
                    log.warning("worker %d quarantined for %.1fs after %d "
                                "consecutive task timeouts", wid, window,
                                QUARANTINE_AFTER_FAILURES)
                    self.counters["workers_quarantined"] += 1
                    _C_QUARANTINED.inc()
                    self._event("quarantine", worker=wid,
                                window_s=round(window, 3))
            if requeued:
                self._cond.notify_all()
        self._flush_events()
        if requeued:
            self._notify_change()  # re-enqueued work is assignable again
        return requeued

    def _sweep_loop(self) -> None:
        while True:
            with self._cond:
                if self._stopped or self._done_locked():
                    return
            self.sweep()
            time.sleep(self.sweep_interval_s)

    # --------------------------------------------------------- predicates
    def _map_phase_done_locked(self) -> bool:
        return self._maps_completed == len(self.map_tasks)

    def _done_locked(self) -> bool:
        return (self._map_phase_done_locked()
                and self._reduces_completed == self.n_reduce)

    def done(self) -> bool:
        """A pure predicate: no side effect."""
        with self._lock:
            return self._done_locked()

    def backlog(self) -> dict:
        """The job's demand for the service's scale advice: the tasks that
        could be handed out now (a reduce only once the map phase is
        done), the tasks in flight, and the oldest in-flight heartbeat's
        age (a growing age with idle workers is a stalled recovery)."""
        now = time.monotonic()
        with self._lock:
            unassigned = sum(t.state is TaskState.UNASSIGNED
                             for t in self.map_tasks)
            if self._map_phase_done_locked():
                unassigned += sum(t.state is TaskState.UNASSIGNED
                                  for t in self.reduce_tasks)
            in_flight = 0
            oldest = 0.0
            for table in (self.map_tasks, self.reduce_tasks):
                for t in table:
                    if t.state is TaskState.IN_PROGRESS:
                        in_flight += 1
                        oldest = max(oldest, now - t.timestamp)
            return {"unassigned": unassigned, "in_flight": in_flight,
                    "oldest_inflight_age_s": round(oldest, 3)}

    def _ended_locked(self) -> bool:
        """Done, and every event staged so far is in the event log: the
        last commit's ``reduce_committed`` is staged under the lock and
        written after it, so a reader woken by ``_done_locked`` alone
        could read the log without it."""
        return (self._done_locked() and not self._pending_events
                and not self._events_writing)

    def wait_done(self, timeout: Optional[float] = None) -> bool:
        """Block until the job is done and its staged events are written
        (``_ended_locked``); False on the timeout."""
        with self._cond:
            return self._cond.wait_for(self._ended_locked, timeout=timeout)

    def stop(self) -> None:
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
