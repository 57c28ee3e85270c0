"""Grep as a service: a long-lived multi-tenant coordinator daemon (the
reference's runtime/service.py, its core).

A one-shot coordinator builds one task table and exits when the job is
done, so every request pays a process start and an engine build.  This
daemon serves a stream of jobs over persistent workers and engines:

* ``GrepService``, the multiplexing core: a bounded job queue with
  admission control (``DGREP_SERVICE_MAX_JOBS`` running jobs,
  ``DGREP_SERVICE_QUEUE`` queued submissions); a Scheduler, a WorkDir, a
  journal and an event log per job (the one-shot machinery, unchanged);
  and a service-level AssignTask that sweeps the running jobs' schedulers
  round-robin.  Workers attach once and serve many jobs: each assignment
  carries its job's id and application (rpc.AssignTaskReply.job_id and
  ``.application``), task RPCs echo the job id, and the data plane is
  scoped by job (``/data/<job>/...``);
* the planners: shard-index pruning at submit (index/plan.pruner_for_job
  over the daemon's ``<work_root>/index``, injected as the grep app's
  ``index_dir``), and scan fusion at assignment (runtime/fusion.py: a map
  assignment takes the idle first-attempt map tasks of the co-running
  jobs with the same fusion key over the same split content, through
  ``Scheduler.claim_map_task``, a literal set only with sets and a
  pattern with patterns; the worker answers all of them from one union
  scan, grep_cuda.map_fused_fn);
* the result cache (runtime/result_cache.py, ``DGREP_RESULT_CACHE``): a
  job's splits are looked up at submit; a full hit completes with no
  scheduler, no worker and no kernel launch, a partial hit scans only the
  changed splits and merges the stored ones in, byte-identical to a cold
  job; a finished job publishes its scanned splits;
* standing queries (a job with ``follow`` set, runtime/follow.py): no map
  or reduce task; a FollowRunner scans the inputs' appended lines on the
  daemon, on the job's device, alone or in a fused group, until the job
  is cancelled; ``GET /jobs/<id>/stream`` pages its records;
* the elastic pool: ``scale_advice`` (grow, shrink or hold, from the
  queued jobs, the assignable tasks and the fresh workers) and
  ``scale_local_pool``, which ``serve --max-workers`` follows;
* ``ServiceServer``, the HTTP surface: ``POST /jobs`` (429 on
  admission), ``GET /jobs/<id>``, ``GET /jobs/<id>/result``, ``GET
  /jobs/<id>/explain`` (runtime/explain.py), ``GET
  /jobs/<id>/stream?cursor=N``, ``POST /jobs/<id>/cancel``, ``GET
  /status`` (queue, running jobs, the worker table with the engine-cache
  counters each worker ships, the fusion, index, result-cache, follow and
  scale views), ``GET /metrics``, ``GET /config``, and the planes the
  workers drive (``/rpc/<verb>``, ``/data/<job>/<kind>/<name>``);
* ``ServiceLocalTransport``, in-process workers of the daemon (``serve
  --workers N``); worker processes attach with ``worker --addr``
  (http_transport.run_http_worker finds the daemon through /status).

The durable job registry (``ServiceRegistry``, ``<work_root>/jobs.jsonl``)
lets a restarted daemon keep its history, advance its id counter past
every id it ever minted, re-admit queued jobs and resume running ones from
their journals.  ``daemon_log`` (runtime/daemon_log.py) writes the
daemon's own decisions to ``daemon.jsonl``.

Exactly-once holds per job: each job keeps its own work dir, journal,
commit records and timeout sweeper, so a worker lost mid-job A re-runs
only A's attempt.  The cross-job engine cache is ops/engine.cached_engine
(a resubmitted pattern skips its build; its counters ride the heartbeats
into /status).

On the card, and nowhere else: a job whose application uses the card
(``uses_device``, runtime/job.job_device) is checked against its device
when it starts, a standing query too; one that asks for CUDA where there
is none ends ``failed`` naming the device, and never runs on the host.  A
task that raises in an in-process worker fails its job with that error
(ROADMAP.md D5, applied per job), and the worker goes on serving the
other jobs; an error of a standing query's scan fails its job (D9).

Failover (runtime/lease.py): a daemon given a ``WorkRootLease``
(``serve --standby``, or DGREP_LEASE_TTL_S set) asks it before every
durable write batch (the registry, each job's journal, the follow logs,
the timeline), in flush context and never under the service lock; a
batch staged when the lease was stolen is dropped whole, and the daemon
is deposed: admission closes, its workers are answered with retries (not
JOB_DONE, so they rotate to the new active) and the ``serve`` loop
demotes it to a standby.  A deposed daemon refuses a submit before any
durable record.  A submit's ``submit_token`` is answered with the job the
token first made, across a promotion too (the registry's submit lines
carry it).  Each renewal snapshots the worker table into the registry,
and a promoted daemon seeds its table from the last snapshot.  /status
says ``"role": "active"`` (or ``"deposed"``) with a lease and nothing
without one.  ``StandbyServer`` is a standby's surface: /status names the
active, assign polls get a retry with ``retry_after_s``, reduce fetches
an abort, and every other request a 503, the answer an address list
rotates past.

The peer shuffle (runtime/peer.py): /status says ``"peer": true`` unless
DGREP_PEER_SHUFFLE=0, and a worker process then keeps its map output on
its own spool; the service's worker rows show each worker's
``data_endpoint``, and the ``shuffle`` view counts the relay bytes that
still pass through the daemon's data plane (0 with every worker on the
peer shuffle) and the maps re-run for a lost output.
"""

from __future__ import annotations

import itertools
import json
import os
import sys
import threading
import time
import urllib.parse
from collections import Counter
from dataclasses import dataclass, field
from dataclasses import replace as _dc_replace
from http.server import ThreadingHTTPServer
from pathlib import Path

from distributed_grep_tpu_torch.runtime import daemon_log as daemon_log_mod
from distributed_grep_tpu_torch.runtime import fusion as fusion_mod
from distributed_grep_tpu_torch.runtime import result_cache as result_cache_mod
from distributed_grep_tpu_torch.runtime import rpc
from distributed_grep_tpu_torch.runtime.http_coordinator import (
    AttachTracker,
    DataPlaneHandler,
    long_poll_window_s,
)
from distributed_grep_tpu_torch.runtime.journal import TaskJournal
from distributed_grep_tpu_torch.runtime.scheduler import Scheduler, WorkerHealth
from distributed_grep_tpu_torch.runtime.store import make_store
from distributed_grep_tpu_torch.utils import lockdep
from distributed_grep_tpu_torch.utils import metrics as metrics_mod
from distributed_grep_tpu_torch.utils import spans as spans_mod
from distributed_grep_tpu_torch.utils.config import JobConfig
from distributed_grep_tpu_torch.utils.io import WorkDir, resolve_input_path
from distributed_grep_tpu_torch.utils.logging import get_logger

log = get_logger("service")

DEFAULT_MAX_JOBS = 4
DEFAULT_QUEUE_DEPTH = 64

# Bounded state over an unbounded job stream: the terminal records kept
# for /status and /jobs/<id> (the oldest finished evicted past this), and
# worker rows dropped after this long without a poll (an idle attached
# worker refreshes its row every long-poll).
_MAX_TERMINAL_RECORDS = 256
_WORKER_EXPIRE_S = 3600.0
# A worker row counts as capacity for the scale advice only this long
# after its last poll (a drained or dead worker stops polling at once; a
# live one polls every long-poll window)
_SCALE_FRESH_S = 90.0
_SPAN_SEQ_WINDOW = 4096

# How long an idle service-level AssignTask waits between sweeps of the
# running jobs' schedulers; a submit, a job start, a map phase's end and
# a timeout's re-enqueue wake it at once (Scheduler.on_change).
_ASSIGN_SWEEP_S = 0.25

# The job-lifecycle instruments (utils/metrics.SERIES), GET /metrics.
_C_SUBMITTED = metrics_mod.counter("dgrep_jobs_submitted_total")
_C_REJECTED = metrics_mod.counter("dgrep_jobs_rejected_total")
_C_DONE = metrics_mod.counter("dgrep_jobs_done_total")
_C_FAILED = metrics_mod.counter("dgrep_jobs_failed_total")
_C_CANCELLED = metrics_mod.counter("dgrep_jobs_cancelled_total")
_H_QUEUE_WAIT = metrics_mod.histogram("dgrep_queue_wait_seconds")
_H_JOB_RUN = metrics_mod.histogram("dgrep_job_run_seconds")
_H_JOB_E2E = metrics_mod.histogram("dgrep_job_e2e_seconds")
_H_FINALIZE = metrics_mod.histogram("dgrep_finalize_seconds")
_H_SVC_ASSIGN_POLL = metrics_mod.histogram("dgrep_assign_poll_seconds")

# The monotonic counters the workers ship that the rolling rates follow.
_TRACKED_COUNTERS = (
    "compile_cache_hits", "compile_cache_misses",
    "corpus_cache_hits", "corpus_cache_misses",
    "index_shards_pruned", "index_bytes_skipped",
    "fused_queries", "fusion_bytes_saved",
)


def env_service_max_jobs(default: int = DEFAULT_MAX_JOBS) -> int:
    """DGREP_SERVICE_MAX_JOBS, the running-job cap (malformed or < 1
    keeps ``default``)."""
    raw = os.environ.get("DGREP_SERVICE_MAX_JOBS")
    if raw is None or raw == "":
        return default
    try:
        return max(1, int(raw))
    except ValueError:
        return default


def env_service_queue(default: int = DEFAULT_QUEUE_DEPTH) -> int:
    """DGREP_SERVICE_QUEUE, the queued-submission cap (0: a submit past
    the running cap is rejected at once; malformed keeps ``default``)."""
    raw = os.environ.get("DGREP_SERVICE_QUEUE")
    if raw is None or raw == "":
        return default
    try:
        return max(0, int(raw))
    except ValueError:
        return default


def env_service_resume(default: bool = True) -> bool:
    """DGREP_SERVICE_RESUME: a restarted daemon re-admits the registry's
    queued jobs and resumes its running ones (on by default; "0", "false"
    or "no" serves afresh, the id counter still advanced)."""
    raw = os.environ.get("DGREP_SERVICE_RESUME")
    if raw is None or raw == "":
        return default
    return raw.strip().lower() not in ("0", "false", "no")


def _config_from_dict(d: dict) -> JobConfig:
    """A registry's job config, through JobConfig.from_json: a config the
    reference's daemon wrote loads as the reference's run_job loads it."""
    return JobConfig.from_json(json.dumps(d))


class ServiceRegistry:
    """The append-only ``jobs.jsonl`` under the work root: the daemon's
    durable job table, one JSON line an event (a submit with its whole
    JobConfig, then its state transitions), fsync'd an append, its torn
    tail truncated at reopen (the task journal's mechanics).  The format
    is the reference's, line for line."""

    FILENAME = "jobs.jsonl"

    def __init__(self, work_root: Path):
        self.path = Path(work_root) / self.FILENAME
        self._journal = TaskJournal(self.path)
        # io_ok: holding it across the fsync'ing append is its purpose
        self._lock = lockdep.make_lock("service-registry", io_ok=True)

    def record_submit(self, job_id: str, config: JobConfig) -> None:
        with self._lock:
            self._journal.record({
                "kind": "job_submit", "job_id": job_id,
                "config": json.loads(config.to_json()), "t": time.time(),
            })

    def record_state(self, job_id: str, state: str, error: str = "",
                     outputs: list[str] | None = None) -> None:
        entry: dict = {"kind": "job_state", "job_id": job_id,
                       "state": state, "t": time.time()}
        if error:
            entry["error"] = error
        if outputs is not None:
            entry["outputs"] = outputs
        with self._lock:
            self._journal.record(entry)

    def record_workers(self, rows: dict[str, dict]) -> None:
        """A worker-table snapshot (replay trusts the last)."""
        with self._lock:
            self._journal.record({"kind": "workers", "rows": rows,
                                  "t": time.time()})

    def close(self) -> None:
        with self._lock:
            self._journal.close()

    @staticmethod
    def replay_workers(work_root: Path) -> dict[str, dict]:
        """The newest worker-table snapshot of the registry, or {}."""
        rows: dict[str, dict] = {}
        for e in TaskJournal.replay(Path(work_root) / ServiceRegistry.FILENAME):
            if e.get("kind") == "workers" and isinstance(e.get("rows"), dict):
                rows = e["rows"]
        return rows

    @staticmethod
    def replay(work_root: Path) -> tuple[dict[str, dict], int]:
        """(jobs, id_floor): job_id -> {"config", "state", "error",
        "outputs", "t"} in submit order, and the first job number a new
        incarnation may mint (past every ``id_floor`` record and every
        registered numeric id).  A state record of an unknown job is
        dropped."""
        jobs: dict[str, dict] = {}
        floor = 1
        for e in TaskJournal.replay(Path(work_root) / ServiceRegistry.FILENAME):
            if e.get("kind") == "id_floor":
                try:
                    floor = max(floor, int(e.get("next", 1)))
                except (TypeError, ValueError):
                    pass
                continue
            jid = e.get("job_id")
            if not isinstance(jid, str):
                continue
            tail = jid.rpartition("-")[2]
            if tail.isdigit():
                floor = max(floor, int(tail) + 1)
            if e.get("kind") == "job_submit":
                jobs[jid] = {"config": e.get("config"),
                             "state": JobState.QUEUED, "error": "",
                             "outputs": [], "t": e.get("t", 0.0)}
            elif e.get("kind") == "job_state" and jid in jobs:
                rec = jobs[jid]
                rec["state"] = e.get("state", rec["state"])
                rec["error"] = e.get("error", "")
                if e.get("outputs") is not None:
                    rec["outputs"] = e["outputs"]
                rec["t"] = e.get("t", rec["t"])
        return jobs, floor

    @staticmethod
    def trim(jobs: dict[str, dict],
             keep_terminal: int = _MAX_TERMINAL_RECORDS) -> dict[str, dict]:
        """Every live job and the newest ``keep_terminal`` terminal ones,
        as the live table is bounded."""
        terminal = [jid for jid, info in jobs.items()
                    if info["state"] in _TERMINAL]
        excess = len(terminal) - keep_terminal
        if excess <= 0:
            return dict(jobs)
        terminal.sort(key=lambda jid: jobs[jid].get("t", 0.0))
        dropped = set(terminal[:excess])
        return {jid: info for jid, info in jobs.items()
                if jid not in dropped}

    @staticmethod
    def compact(work_root: Path, jobs: dict[str, dict],
                id_floor: int) -> None:
        """Rewrite jobs.jsonl from a (trimmed) replay, before the append
        handle opens: an ``id_floor`` record, then a submit and its last
        state a job; atomic (temp, fsync, rename)."""
        path = Path(work_root) / ServiceRegistry.FILENAME
        if not path.exists():
            return
        tmp = path.with_name(path.name + ".compact")
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(json.dumps({"kind": "id_floor", "next": id_floor},
                               sort_keys=True) + "\n")
            for jid, info in jobs.items():
                if not isinstance(info.get("config"), dict):
                    continue
                f.write(json.dumps(
                    {"kind": "job_submit", "job_id": jid,
                     "config": info["config"], "t": info["t"]},
                    sort_keys=True) + "\n")
                if info["state"] != JobState.QUEUED:
                    entry: dict = {"kind": "job_state", "job_id": jid,
                                   "state": info["state"], "t": info["t"]}
                    if info.get("error"):
                        entry["error"] = info["error"]
                    if info.get("outputs"):
                        entry["outputs"] = info["outputs"]
                    f.write(json.dumps(entry, sort_keys=True) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)


class AdmissionError(RuntimeError):
    """A submission admission control rejected (queue full, shutdown)."""


class JobState:
    QUEUED = "queued"
    RUNNING = "running"
    DONE = "done"
    CANCELLED = "cancelled"
    FAILED = "failed"


_TERMINAL = (JobState.DONE, JobState.CANCELLED, JobState.FAILED)

# the canonical objects a replayed state maps to: the runtime compares
# states with ``is``
_CANON_STATE = {s: s for s in (JobState.QUEUED, JobState.RUNNING, *_TERMINAL)}


@dataclass
class JobRecord:
    """One submitted job's state: the one-shot machinery (scheduler, work
    dir, journal, event log), owned by the service."""

    job_id: str
    config: JobConfig
    state: str = JobState.QUEUED
    scheduler: Scheduler | None = None
    workdir: WorkDir | None = None
    journal: TaskJournal | None = None
    event_log: spans_mod.EventLog | None = None
    input_allowlist: frozenset = frozenset()
    submitted_at: float = 0.0
    started_at: float | None = None
    finished_at: float | None = None
    error: str = ""
    outputs: list[str] = field(default_factory=list)
    # the map splits, planned at submit outside the service lock (the
    # planning stats every input)
    map_splits: list = field(default_factory=list)
    # scan fusion (runtime/fusion.py): the job's key, its splits' content
    # identities and identity -> map task id; planned with the splits,
    # empty when fusion is off or the job can never fuse
    fusion_key: tuple | None = None
    split_identities: list = field(default_factory=list)
    fuse_index: dict = field(default_factory=dict)
    # the planner's shard-index prunes, seeded into the job's counters
    # when its scheduler is built
    index_shards_pruned: int = 0
    index_bytes_skipped: int = 0
    # the result cache's plan at submit (runtime/result_cache.ResultPlan):
    # with one, map_splits holds only the splits to scan (the full list
    # is result_plan.splits); a full hit completes with no scheduler.
    # Its tallies are seeded into the job's counters as the index's are.
    result_plan: object = None
    result_splits_reused: int = 0
    result_bytes_unscanned: int = 0
    result_revalidations: int = 0
    # a full hit's counters (it has no scheduler to hold them)
    hit_counters: dict = field(default_factory=dict)
    # a standing query's runner (runtime/follow.FollowRunner): such a job
    # has no scheduler and holds its running slot until cancelled
    follow: object = None
    # a standing query resumed at a restart keeps its work dir (its
    # cursors) instead of clearing it
    resume_follow: bool = False

    def metrics(self) -> dict:
        """The job's counters, seconds and kernel launches (its
        scheduler's; a full hit's counters); empty for a job that never
        started."""
        if self.scheduler is None:
            return {"counters": dict(self.hit_counters), "seconds": {},
                    "launches": {}}
        return self.scheduler.metrics_snapshot()


class GrepService:
    """The multiplexing core: the job queue, admission control, and the
    service-level control plane over the per-job schedulers."""

    def __init__(
        self,
        work_root: str | Path,
        max_jobs: int | None = None,
        queue_depth: int | None = None,
        spans: bool = False,
        task_timeout_s: float | None = None,
        sweep_interval_s: float | None = None,
        rpc_timeout_s: float = 60.0,
        resume: bool | None = None,
        lease=None,
        daemon_log=None,
    ):
        self.work_root = Path(work_root)
        self.work_root.mkdir(parents=True, exist_ok=True)
        # the environment wins over the constructor's values
        self.max_jobs = env_service_max_jobs(
            max_jobs if max_jobs is not None else DEFAULT_MAX_JOBS)
        self.queue_depth = env_service_queue(
            queue_depth if queue_depth is not None else DEFAULT_QUEUE_DEPTH)
        # the daemon-wide span switch: whether attached workers buffer
        # spans at all (a job's event log also honours its own config)
        self.spans = spans
        # per-job detector overrides (tests shrink them); None keeps each
        # job config's
        self._task_timeout_s = task_timeout_s
        self._sweep_interval_s = sweep_interval_s
        self.rpc_timeout_s = rpc_timeout_s
        # the lifecycle log (runtime/daemon_log.py); None: every event
        # site is a no-op
        self._daemon_log = daemon_log
        # the work-root lease (runtime/lease.py): None, no lease file, no
        # fence read, no "role" in /status
        self._lease = lease
        self._deposed = False
        self.deposed_event = threading.Event()
        self._last_worker_snapshot: dict[str, dict] | None = None
        # submit_token -> job id, rebuilt from the registry at resume
        self._tokens: dict[str, str] = {}

        self._lock = lockdep.make_lock("service")
        self._cond = threading.Condition(self._lock)
        self._jobs: dict[str, JobRecord] = {}
        self._queue: list[str] = []  # submitted, awaiting a running slot
        self._running: list[str] = []  # the assign round-robin's order
        # job starts claimed under the lock and built outside it (work dir,
        # journal, scheduler) by _flush_starts, in staging order
        self._pending_starts: list[JobRecord] = []
        self._start_flush_lock = lockdep.make_lock("start-flush", io_ok=True)
        # journal and event-log closes staged under the lock, run after
        self._pending_closes: list[tuple] = []
        self._rr = 0
        self._stopped = False
        self.started_at = time.time()
        # each application's ``uses_device``, loaded once a spec
        self._app_devices: dict[str, bool] = {}

        # the service owns worker identity (each job's scheduler would
        # number its workers from 0)
        self._next_worker_id = 0
        self.workers: dict[int, dict] = {}

        # span-batch dedup across RPC retries, by (worker, seq), before a
        # batch is split by job
        self._span_seqs: dict[int, set[int]] = {}
        self._span_seq_lock = lockdep.make_lock("span-seq")

        # rolling rates over the counters the workers ship, by process
        self._cache_rates = metrics_mod.CounterDeltaTracker(_TRACKED_COUNTERS)

        # one quarantine tracker for every job's scheduler: a worker gone
        # dark under job A gets none of job B's tasks either
        self._health = WorkerHealth()
        if self._daemon_log is not None:
            self._health.on_event = self._daemon_event

        # fusion planning (GET /status "fusion"): participant tasks served
        # by shared attempts, fused attempts handed out, split bytes the
        # co-tenants did not scan again
        self._fusion_lock = lockdep.make_lock("fusion-stats")
        self._fusion_stats = {"fused_jobs": 0, "fused_dispatches": 0,
                              "fusion_bytes_saved": 0}

        # relay shuffle bytes through this daemon's data plane
        self._shuffle_lock = lockdep.make_lock("shuffle-stats")
        self._shuffle_stats = {"daemon_shuffle_bytes": 0, "relay_puts": 0,
                               "relay_gets": 0}

        # shard-index planning (GET /status "index"); the engine's own
        # counters ride the workers' rows
        self._index_lock = lockdep.make_lock("index-stats")
        self._index_stats = {"index_shards_pruned": 0,
                             "index_bytes_skipped": 0,
                             "index_maybe_scans": 0}

        # the result cache (GET /status "result_cache"): jobs answered
        # whole, partial hits, splits and bytes served with no scan, and
        # publications dropped because a split changed while its job ran.
        # DGREP_RESULT_CACHE=0 (or a zero budget) leaves the store None:
        # no results/ dir, no /status key, no instants.
        self._result_lock = lockdep.make_lock("result-stats")
        self._result_stats = {"result_hits": 0, "result_partial_hits": 0,
                              "result_splits_reused": 0,
                              "result_bytes_unscanned": 0,
                              "result_revalidations": 0}
        self._result_store = (
            result_cache_mod.ResultStore(self.work_root / "results")
            if result_cache_mod.env_result_cache()
            and result_cache_mod.env_result_bytes() > 0 else None)

        # the fused follow tier's registry, built by the first standing
        # query's start (under the start-flush lock) unless
        # DGREP_FOLLOW_FUSE=0
        self._follow_groups = None
        # the last scale advice (a daemon event marks each change)
        self._last_scale_advice: str | None = None

        # the durable registry: state changes decided under the lock are
        # staged and written (fsync) after it; a job is registered before
        # its id reaches the client
        replayed, id_floor = ServiceRegistry.replay(self.work_root)
        if self._lease is not None:
            # a promotion: the deposed active's last worker snapshot,
            # read before compaction drops it, so the scale advice sees
            # the attached fleet before each worker's next poll
            self._seed_workers(ServiceRegistry.replay_workers(self.work_root))
        replayed = ServiceRegistry.trim(replayed)
        ServiceRegistry.compact(self.work_root, replayed, id_floor)
        self._registry = ServiceRegistry(self.work_root)
        self._registry_pending: list[tuple] = []
        # orders whole flush batches (replay trusts the last state)
        self._registry_flush_lock = lockdep.make_lock("registry-flush",
                                                      io_ok=True)
        # past every id ever registered, resumed or not: no new job takes
        # a work dir an earlier incarnation owns
        self._ids = itertools.count(id_floor)
        if self._daemon_log is not None:
            self._daemon_event("start", work_root=str(self.work_root),
                               max_jobs=self.max_jobs,
                               queue_depth=self.queue_depth)
            self._flush_daemon_log()
        if env_service_resume() if resume is None else resume:
            self._resume_replayed(replayed)

    # ---------------------------------------------------------- resume
    def _resume_replayed(self, replayed: dict[str, dict]) -> None:
        """Rebuild the job table from the registry (at construction, before
        any worker or client can attach): terminal jobs as history, jobs
        that never started back in the queue, running jobs resumed from
        their journals and commit records."""
        for jid, info in replayed.items():
            cfg_dict = info.get("config")
            if not isinstance(cfg_dict, dict):
                continue
            try:
                cfg = _config_from_dict(cfg_dict)
            except (TypeError, ValueError, NotImplementedError) as e:
                log.warning("registry job %s has an unloadable config (%s); "
                            "dropping it", jid, e)
                continue
            state = _CANON_STATE.get(info["state"])
            if state is None:
                log.warning("registry job %s has an unknown state %r; "
                            "dropping it", jid, info["state"])
                continue
            if cfg.submit_token:
                # a client re-POSTing its token to this daemon lands here
                self._tokens[cfg.submit_token] = jid
            rec = JobRecord(job_id=jid, config=cfg, state=state,
                            submitted_at=info.get("t", 0.0))
            if state in _TERMINAL:
                rec.finished_at = info.get("t", 0.0)
                rec.error = info.get("error", "")
                rec.outputs = list(info.get("outputs") or [])
                self._jobs[jid] = rec
                continue
            if cfg.follow:
                # a standing query: no planning, and a missing input is
                # allowed (its cursor waits for it).  A running one starts
                # again through the start flush with its work dir kept: the
                # runner restores every cursor from follow.jsonl
                self._jobs[jid] = rec
                if state == JobState.RUNNING:
                    rec.started_at = time.time()
                    rec.resume_follow = True
                    self._running.append(jid)
                    self._pending_starts.append(rec)
                else:
                    rec.state = JobState.QUEUED
                    self._queue.append(jid)
                continue
            # submit's readability check again: a map task over an input
            # deleted meanwhile would be re-issued forever
            missing = [f for f in cfg.input_files if not os.access(f, os.R_OK)]
            if missing:
                rec.state = JobState.FAILED
                rec.error = f"inputs unreadable at resume: {missing}"
                rec.finished_at = time.time()
                _C_FAILED.inc()
                self._jobs[jid] = rec
                self._registry_pending.append(
                    (jid, JobState.FAILED, rec.error, None))
                continue
            self._plan(rec)
            self._jobs[jid] = rec
            if state == JobState.RUNNING:
                if rec.result_plan is not None and rec.result_plan.full:
                    # every split answers from the store that survived the
                    # restart: done through the start flush, no scheduler
                    rec.started_at = time.time()
                    self._running.append(jid)
                    self._pending_starts.append(rec)
                else:
                    self._resume_running_job(rec)
            else:
                rec.state = JobState.QUEUED
                self._queue.append(jid)
        # start the backlog before the first worker attaches
        with self._cond:
            self._maybe_start_locked()
        self._flush_starts()
        self._flush_registry()
        if self._jobs:
            self._daemon_event("resume", jobs=len(self._jobs),
                               running=len(self._running),
                               queued=len(self._queue))
            self._flush_daemon_log()
            log.info("service resume: %d jobs from the registry (%d running,"
                     " %d queued)", len(self._jobs), len(self._running),
                     len(self._queue))

    def _resume_running_job(self, rec: JobRecord) -> None:
        """Re-open a job that was running when the daemon died: its work
        dir kept, its journal replayed (committed tasks stay done), its
        event log appended to."""
        cfg = rec.config
        try:
            self._check_device(cfg)
        except (RuntimeError, ValueError) as e:
            rec.state = JobState.FAILED
            rec.error = str(e)
            rec.finished_at = time.time()
            _C_FAILED.inc()
            self._registry_pending.append(
                (rec.job_id, JobState.FAILED, rec.error, None))
            return
        rec.workdir = WorkDir(cfg.work_dir,
                              store=make_store(cfg.store, durable=cfg.durable))
        resume_entries = None
        if cfg.journal:
            resume_entries = TaskJournal.replay(rec.workdir.journal_path())
            rec.journal = TaskJournal(rec.workdir.journal_path())
        if spans_mod.enabled(cfg.spans) or self.spans:
            rec.event_log = spans_mod.EventLog(
                rec.workdir.root / spans_mod.EventLog.FILENAME, fresh=False)
        rec.input_allowlist = frozenset(cfg.input_files)
        rec.scheduler = self._scheduler(rec, rec.journal, rec.event_log,
                                        rec.workdir, resume_entries)
        rec.state = JobState.RUNNING
        rec.started_at = time.time()
        self._running.append(rec.job_id)
        if rec.event_log is not None:
            rec.event_log.write({
                "t": "instant", "name": "resume", "cat": "service",
                "ts": time.time(), "job": rec.job_id,
                "args": {"replayed_entries": len(resume_entries or [])}})
        threading.Thread(target=self._watch_job, args=(rec,), daemon=True,
                         name=f"svc-watch-{rec.job_id}").start()
        log.info("job %s resumed (%d journal entries replayed)", rec.job_id,
                 len(resume_entries or []))

    # ----------------------------------------------------- registry I/O
    def _stage_state(self, rec: JobRecord,
                     outputs: list[str] | None = None) -> None:
        """Stage a transition record under the lock (written after it by
        _flush_registry); a terminal one lands on the fleet timeline."""
        self._registry_pending.append(
            (rec.job_id, rec.state, rec.error, outputs))
        if rec.state in _TERMINAL:
            self._daemon_event("job_terminal", job=rec.job_id,
                               state=rec.state,
                               **({"error": rec.error} if rec.error else {}))

    def _flush_registry(self) -> None:
        """Write the staged registry records outside the service lock, a
        batch as one ordered unit.  Never raises: a full disk degrades
        crash recovery, not the control plane."""
        with self._registry_flush_lock:
            with self._lock:
                if not self._registry_pending:
                    return
                pending, self._registry_pending = self._registry_pending, []
            if not self._lease_ok():
                # the fence: a standby stole the lease while this batch
                # sat staged; it is dropped (the promoted daemon owns the
                # records) and the daemon deposed
                log.warning("registry flush fenced: lease lost, %d staged "
                            "records dropped", len(pending))
                self._on_lease_lost()
                return
            for job_id, state, error, outputs in pending:
                try:
                    self._registry.record_state(job_id, state, error=error,
                                                outputs=outputs)
                except Exception:  # noqa: BLE001 -- see the docstring
                    log.exception("registry append failed for job %s",
                                  job_id)

    def _daemon_event(self, kind: str, **payload) -> None:
        """Stage a fleet-timeline event (a leaf-lock append, safe under the
        service lock); a no-op without a daemon log."""
        dl = self._daemon_log
        if dl is not None:
            dl.stage(kind, **payload)

    def _job_daemon_events(self, job_id: str):
        """A job's scheduler's timeline hook (its events tagged with the
        job), or None without a daemon log."""
        if self._daemon_log is None:
            return None

        def stage(kind: str, **payload) -> None:
            self._daemon_event(kind, job=job_id, **payload)

        return stage

    def _flush_daemon_log(self) -> None:
        """Write the staged timeline events, through the lease's fence."""
        dl = self._daemon_log
        if dl is not None:
            dl.flush(self._write_gate())

    # ------------------------------------------------------------ lease
    def _lease_ok(self) -> bool:
        """The write fence: True without a lease; with one, the lease file
        must still name this incarnation.  A file read: called in flush
        context or unlocked, never under the service lock."""
        lease = self._lease
        if lease is None:
            return True
        return not self._deposed and lease.verify()

    def _on_lease_lost(self) -> None:
        """A standby stole the lease: the daemon is deposed (idempotent,
        no I/O).  Admission closes, and ``deposed_event`` tells the serve
        loop to demote this process to a standby; the jobs' state stays on
        disk for the promoted daemon."""
        with self._cond:
            if self._deposed:
                return
            self._deposed = True
            self._stopped = True
            self._cond.notify_all()
        log.warning("daemon deposed: durable writes fenced, admission closed "
                    "(work root %s)", self.work_root)
        # the fence drops it: the thief's lease_steal line is the record
        self._daemon_event("lease_lost")
        self.deposed_event.set()

    def _write_gate(self):
        """The fence the schedulers' journals and the follow logs ask
        before each write batch: None without a lease, else a callable
        whose False drops the batch and deposes the daemon."""
        if self._lease is None:
            return None

        def gate() -> bool:
            if self._lease_ok():
                return True
            self._on_lease_lost()
            return False

        return gate

    def lease_renewed(self) -> None:
        """The lease renewal's hook (no service lock held): a snapshot of
        the worker table into the registry when it changed, which a
        promoted daemon seeds its own table from."""
        with self._lock:
            rows = {str(wid): {k: info[k]
                               for k in ("job", "task", "metrics",
                                         "data_endpoint")
                               if info.get(k) is not None}
                    for wid, info in self.workers.items()}
        if rows == self._last_worker_snapshot:
            return
        try:
            self._registry.record_workers(rows)
        except Exception:  # noqa: BLE001 -- telemetry, never fatal
            log.exception("worker-table snapshot append failed")
            return
        self._last_worker_snapshot = rows

    def _seed_workers(self, rows: dict[str, dict]) -> None:
        """Adopt a replayed worker snapshot at promotion: fresh seen stamps
        (a monotonic clock is the process's), the id allocator past every
        seeded id (a worker that keeps its id must not meet a new one)."""
        if not rows:
            return
        now = time.monotonic()
        for wid_str, row in rows.items():
            try:
                wid = int(wid_str)
            except (TypeError, ValueError):
                continue
            info: dict = {"job": None, "task": None, "seen": now}
            if isinstance(row, dict):
                for k in ("job", "task", "metrics", "data_endpoint"):
                    if row.get(k) is not None:
                        info[k] = row[k]
            self.workers[wid] = info
            self._next_worker_id = max(self._next_worker_id, wid + 1)
        self._last_worker_snapshot = dict(rows)
        log.info("promotion seeded %d worker rows from the registry's "
                 "snapshot", len(self.workers))

    # ---------------------------------------------------------- submit
    def submit(self, config: JobConfig) -> str:
        """Admit a job: check it, queue it, start it if a slot is free.
        Raises AdmissionError when the queue is full or the daemon stops,
        ValueError for a config that could never complete (an unreadable
        input's map task would be re-issued forever).  A ``submit_token``
        seen before answers the job it made."""
        token = config.submit_token
        if token:
            with self._lock:
                dup = self._tokens.get(token)
            if dup is not None:
                return dup
        # admission first: a submit the overload will reject pays no walk
        # of its inputs (checked again under the lock at enqueue)
        try:
            self._check_admission_locked_or_raise()
        except AdmissionError as e:
            _C_REJECTED.inc()
            self._daemon_event("admission_reject", reason=str(e))
            self._flush_daemon_log()
            raise
        if config.follow:
            # a standing query: no map or reduce planning, no fusion of
            # splits, no index (the runner scans the appended lines
            # itself); its inputs may not exist yet (the cursor waits)
            self._validate_follow_config(config)
            rec = JobRecord(job_id="", config=config)
        else:
            missing = [f for f in config.input_files
                       if not os.access(f, os.R_OK)]
            if missing:
                raise ValueError(f"unreadable input files: {missing}")
            # the shard index: the daemon's store goes to the grep app
            # before planning, so the registry, the fusion key and the
            # workers all see one option set (DGREP_INDEX=0 injects
            # nothing)
            idx_dir = self._index_app_dir(config)
            if idx_dir is not None:
                config = _dc_replace(
                    config, app_options={**config.app_options,
                                         "index_dir": idx_dir})
            rec = JobRecord(job_id="", config=config)
            self._plan(rec)
        with self._cond:
            if token:
                # the planning above is unlocked: a duplicate may have
                # claimed the token meanwhile
                dup = self._tokens.get(token)
                if dup is not None:
                    return dup
            self._check_admission_locked_or_raise(locked=True)
            job_id = f"job-{next(self._ids)}"
            if token:
                self._tokens[token] = job_id
            # the service places every job: its work dir is always
            # <work_root>/<job_id>, and its span tag the job id
            rec.job_id = job_id
            rec.config = _dc_replace(
                config, work_dir=str(self.work_root / job_id), job_id=job_id,
                **({"task_timeout_s": self._task_timeout_s}
                   if self._task_timeout_s is not None else {}),
                **({"sweep_interval_s": self._sweep_interval_s}
                   if self._sweep_interval_s is not None else {}))
            rec.submitted_at = time.time()
        # durable before visible: from here a daemon crash re-admits the
        # job at restart.  A deposed daemon registers nothing the promoted
        # one would never learn of (the client re-POSTs to it; the token
        # makes that safe)
        if not self._lease_ok():
            self._on_lease_lost()
            self._drop_token(token)
            _C_REJECTED.inc()
            raise AdmissionError("daemon deposed: lease lost")
        try:
            self._registry.record_submit(job_id, rec.config)
        except (OSError, ValueError) as e:
            self._drop_token(token)
            _C_REJECTED.inc()
            self._daemon_event("admission_reject", job=job_id,
                               reason=f"cannot register job: {e}")
            self._flush_daemon_log()
            raise AdmissionError(f"cannot register job: {e}") from e
        rejected: AdmissionError | None = None
        with self._cond:
            # again at enqueue: concurrent submits may all have passed the
            # first check during the unlocked fsync
            try:
                self._check_admission_locked_or_raise(locked=True)
            except AdmissionError as e:
                # registered already: record the rejection, so a restart
                # does not re-admit a job its client saw refused
                rejected = e
                rec.state = JobState.CANCELLED
                rec.error = "rejected by admission control at enqueue"
                rec.finished_at = time.time()
                self._jobs[job_id] = rec
                self._stage_state(rec)
                self._daemon_event("admission_reject", job=job_id,
                                   reason=rec.error)
                self._prune_terminal_locked()
            else:
                self._jobs[job_id] = rec
                self._queue.append(job_id)
                self._maybe_start_locked()
            self._cond.notify_all()
        self._flush_starts()
        self._flush_registry()
        self._flush_daemon_log()
        if rejected is not None:
            _C_REJECTED.inc()
            raise rejected
        _C_SUBMITTED.inc()
        return job_id

    def _drop_token(self, token: str) -> None:
        if token:
            with self._lock:
                self._tokens.pop(token, None)

    def _plan(self, rec: JobRecord) -> None:
        """A job's map splits (index-pruned), its planning tallies, its
        result-cache plan and its fusion plan; stat, summary and store
        reads, outside the service lock.  The plan is deterministic for
        unchanged inputs, summaries and stored results, so a resumed job
        re-plans the splits its journal names.  A result-cache hit leaves
        only the splits to scan before fusion is planned, so the fusion
        index's task ids are the scheduler's."""
        from distributed_grep_tpu_torch.runtime.job import plan_map_splits

        cfg = rec.config
        pruner = self._index_pruner(cfg)
        rec.map_splits = plan_map_splits(list(cfg.input_files),
                                         cfg.effective_batch_bytes(),
                                         pruner=pruner)
        self._stamp_index_plan(rec, pruner)
        rec.result_plan = self._result_plan(cfg, rec.map_splits)
        if rec.result_plan is not None:
            rec.map_splits = rec.result_plan.remaining
        self._stamp_result_plan(rec)
        (rec.fusion_key, rec.split_identities,
         rec.fuse_index) = self._fusion_plan(cfg, rec.map_splits)

    @staticmethod
    def _validate_follow_config(config: JobConfig) -> None:
        """Refuse at submit a standing query the follow scanner cannot
        serve (one that could never emit would hold a running slot)."""
        opts = config.effective_app_options()
        if opts.get("pattern") is None and not opts.get("patterns"):
            raise ValueError("follow jobs need a pattern (or patterns) "
                             "app option")
        if not config.input_files:
            raise ValueError("follow jobs need at least one input file")
        unsupported = [k for k in ("word_regexp", "line_regexp",
                                   "max_errors", "mesh_shape")
                       if opts.get(k)]
        if unsupported:
            raise ValueError(
                f"app options unsupported with follow: {unsupported}")

    def _check_admission_locked_or_raise(self, locked: bool = False) -> None:
        if not locked:
            with self._lock:
                return self._check_admission_locked_or_raise(locked=True)
        if self._stopped:
            raise AdmissionError("service is shutting down")
        if len(self._queue) >= max(0, self.queue_depth) and (
                len(self._running) >= self.max_jobs):
            raise AdmissionError(
                f"admission control: {len(self._running)} running "
                f"(cap {self.max_jobs}), {len(self._queue)} queued "
                f"(cap {self.queue_depth})")

    def _maybe_start_locked(self) -> None:
        """Claim queued jobs into free running slots: state only (the
        queue pop, RUNNING, the slot, the registry record); the
        filesystem half is staged for _flush_starts.  Until it publishes
        the scheduler, the job is running but not yet assignable."""
        while self._queue and len(self._running) < self.max_jobs:
            rec = self._jobs[self._queue.pop(0)]
            rec.state = JobState.RUNNING
            rec.started_at = time.time()
            if rec.submitted_at:
                _H_QUEUE_WAIT.observe(rec.started_at - rec.submitted_at)
            self._running.append(rec.job_id)
            self._stage_state(rec)
            self._pending_starts.append(rec)

    def _app_uses_device(self, spec: str) -> bool:
        """Whether the application launches kernels (``uses_device``);
        its module loaded once a spec, for this question alone."""
        if spec not in self._app_devices:
            from distributed_grep_tpu_torch.apps.loader import (
                load_application,
            )

            app = load_application(spec)
            self._app_devices[spec] = bool(
                getattr(app.module, "uses_device", False))
            sys.modules.pop(app.module.__name__, None)
        return self._app_devices[spec]

    def _check_device(self, cfg: JobConfig) -> None:
        """Raise, naming the device, when the job's application uses the
        card and its device is not there (runtime/job.job_device: only an
        application that declares ``uses_device`` is asked, and its host
        backend never).  The job then fails; nothing runs on the host in
        its place."""
        from distributed_grep_tpu_torch.utils.device import resolve_device

        if not self._app_uses_device(cfg.application):
            return
        opts = cfg.effective_app_options()
        if opts.get("backend", "device") == "cpu":
            return
        device = str(opts.get("device", "cuda"))
        try:
            resolve_device(device)
        except RuntimeError as e:
            raise RuntimeError(f"job asks for device {device!r}: {e}") from e

    def _scheduler(self, rec: JobRecord, journal, event_log, workdir,
                   resume_entries=None) -> Scheduler:
        cfg = rec.config
        scheduler = Scheduler(
            files=rec.map_splits,
            n_reduce=cfg.n_reduce,
            task_timeout_s=cfg.task_timeout_s,
            sweep_interval_s=cfg.sweep_interval_s,
            app_options=cfg.effective_app_options(),
            journal=journal,
            resume_entries=resume_entries,
            commit_resolver=workdir.resolve_task_commit,
            worker_health=self._health,
            event_log=event_log,
            on_change=self._wake,
            daemon_events=self._job_daemon_events(rec.job_id),
            journal_gate=self._write_gate(),
        )
        if rec.index_shards_pruned:
            # the planner's prunes, in the job's counters beside the
            # engine's (the /jobs/<id> view and submit's line read them)
            scheduler.counters["index_shards_pruned"] += rec.index_shards_pruned
            scheduler.counters["index_bytes_skipped"] += rec.index_bytes_skipped
        if rec.result_splits_reused:
            scheduler.counters["result_splits_reused"] += (
                rec.result_splits_reused)
            scheduler.counters["result_bytes_unscanned"] += (
                rec.result_bytes_unscanned)
        return scheduler

    def _build_job_runtime(self, rec: JobRecord) -> tuple:
        """The filesystem half of a job start (no service lock held): the
        device check, the work dir (cleared), the journal and event log,
        the scheduler."""
        cfg = rec.config
        self._check_device(cfg)
        workdir = WorkDir(cfg.work_dir,
                          store=make_store(cfg.store, durable=cfg.durable))
        workdir.clear()
        journal = TaskJournal(workdir.journal_path()) if cfg.journal else None
        event_log = (spans_mod.EventLog(
            workdir.root / spans_mod.EventLog.FILENAME, fresh=True)
            if spans_mod.enabled(cfg.spans) or self.spans else None)
        rec.input_allowlist = frozenset(cfg.input_files)
        if rec.result_plan is not None and event_log is not None:
            # a job with a plan that reaches here is a partial hit (a full
            # one completes in _flush_starts) or a miss: explain reads it
            plan = rec.result_plan
            event_log.write({
                "t": "instant",
                "name": "result:partial" if plan.cached else "result:miss",
                "cat": "service", "ts": time.time(), "job": rec.job_id,
                "args": {"splits_reused": plan.splits_reused,
                         "splits_scanned": len(plan.remaining),
                         "bytes_unscanned": plan.bytes_unscanned}})
        scheduler = self._scheduler(rec, journal, event_log, workdir)
        return workdir, journal, event_log, scheduler

    def _fail_start_locked(self, rec: JobRecord, error: str) -> None:
        """A job whose start failed: FAILED with the error, its slot
        refilled (a cancel that won the race keeps its own state)."""
        if rec.state is not JobState.RUNNING:
            return
        rec.state = JobState.FAILED
        rec.error = error
        rec.finished_at = time.time()
        _C_FAILED.inc()
        if rec.job_id in self._running:
            self._running.remove(rec.job_id)
        self._stage_state(rec)
        self._prune_terminal_locked()
        self._maybe_start_locked()
        self._cond.notify_all()

    def _flush_starts(self) -> None:
        """Build the staged job starts outside the service lock, in staging
        order, and publish each under it (or tear it down when a cancel or
        stop won the race).  A start that fails records FAILED with its
        error: a bad job, a healthy daemon."""
        with self._lock:
            if not self._pending_starts:
                return
        with self._start_flush_lock:
            while True:
                with self._cond:
                    while self._pending_starts and (
                            self._pending_starts[0].state
                            is not JobState.RUNNING):
                        self._pending_starts.pop(0)  # cancelled meanwhile
                    if not self._pending_starts:
                        return
                    rec = self._pending_starts.pop(0)
                if rec.config.follow:
                    self._flush_follow_start(rec)
                    continue
                if rec.result_plan is not None and rec.result_plan.full:
                    # every split answers from the store: the job completes
                    # here with no scheduler, no worker and no launch.  A
                    # hit that cannot materialize scans every split on the
                    # workers instead (never the stored blobs on top of a
                    # rescan: that would repeat records)
                    if self._flush_result_hit(rec):
                        continue
                    rec.map_splits = rec.result_plan.splits
                    rec.result_splits_reused = 0
                    rec.result_bytes_unscanned = 0
                    rec.result_plan = None
                    # the fusion plan was made for the empty remainder
                    rec.fusion_key = None
                    rec.split_identities = []
                    rec.fuse_index = {}
                try:
                    parts = self._build_job_runtime(rec)
                except Exception as e:  # noqa: BLE001 -- recorded as FAILED
                    log.error("job %s failed to start: %s", rec.job_id, e)
                    with self._cond:
                        self._fail_start_locked(rec, str(e))
                    continue
                workdir, journal, event_log, scheduler = parts
                published = False
                with self._cond:
                    if rec.state is JobState.RUNNING:
                        rec.workdir = workdir
                        rec.journal = journal
                        rec.event_log = event_log
                        rec.scheduler = scheduler
                        published = True
                        self._cond.notify_all()
                if not published:
                    scheduler.stop()
                    scheduler.close_journal()
                    if event_log is not None:
                        event_log.close()
                    continue
                threading.Thread(target=self._watch_job, args=(rec,),
                                 daemon=True,
                                 name=f"svc-watch-{rec.job_id}").start()
                log.info("job %s started (%d map tasks, %d reduce, %d "
                         "running, %d queued)", rec.job_id,
                         len(scheduler.map_tasks), rec.config.n_reduce,
                         len(self._running), len(self._queue))

    def _flush_follow_start(self, rec: JobRecord) -> None:
        """The start of a standing query (no service lock held; under the
        start-flush lock, so the group registry's lazy build cannot race):
        the device check, the work dir (kept on a resume: it holds the
        cursors), the event log and the FollowRunner, published under the
        lock, then its wake loop started.  A start that fails records
        FAILED with its error."""
        from distributed_grep_tpu_torch.runtime import follow as follow_mod

        if self._follow_groups is None and follow_mod.env_follow_fuse():
            self._follow_groups = follow_mod.FollowGroupRegistry(
                write_gate=self._write_gate())
        cfg = rec.config
        event_log = None
        try:
            self._check_device(cfg)
            workdir = WorkDir(cfg.work_dir,
                              store=make_store(cfg.store, durable=cfg.durable))
            if not rec.resume_follow:
                workdir.clear()
            if spans_mod.enabled(cfg.spans) or self.spans:
                event_log = spans_mod.EventLog(
                    workdir.root / spans_mod.EventLog.FILENAME,
                    fresh=not rec.resume_follow)
            # an error of the query's scan fails the job (ROADMAP.md D9)
            runner = follow_mod.FollowRunner(
                rec.job_id, cfg, workdir.root, event_log=event_log,
                on_fail=self.fail_job, write_gate=self._write_gate(),
                groups=self._follow_groups)
        except Exception as e:  # noqa: BLE001 -- recorded as FAILED
            log.error("follow job %s failed to start: %s", rec.job_id, e)
            if event_log is not None:
                event_log.close()
            with self._cond:
                self._fail_start_locked(rec, str(e))
            return
        published = False
        with self._cond:
            if rec.state is JobState.RUNNING:
                rec.workdir = workdir
                rec.event_log = event_log
                rec.follow = runner
                published = True
                self._cond.notify_all()
        if not published:
            runner.close()
            if event_log is not None:
                event_log.close()
            return
        # standing: no completion watcher; the job runs until a cancel, a
        # stop or an error of its scan
        runner.start()
        log.info("follow job %s standing over %d inputs (poll %.3g s%s)",
                 rec.job_id, len(cfg.input_files), runner.poll_s,
                 ", resumed" if runner.resumed else "")

    def _watch_job(self, rec: JobRecord) -> None:
        """Finalize a running job when its scheduler is done; return when it
        left RUNNING another way (a cancel, a failure)."""
        while True:
            if rec.scheduler.wait_done(timeout=0.2):
                break
            with self._lock:
                if rec.state is not JobState.RUNNING:
                    return
        self._finalize(rec)

    def _finalize(self, rec: JobRecord) -> None:
        # every reduce is committed: list the outputs before taking the
        # lock (the store reads commit records)
        t_fin = time.perf_counter()
        outputs = [str(p) for p in rec.workdir.list_outputs()]
        cache_error = ""
        if rec.result_plan is not None:
            # publish the scanned splits' results (only now, with every
            # reduce committed: a failed job publishes nothing), then write
            # the stored splits' blobs beside the scanned outputs
            self._publish_results(rec, outputs)
            try:
                outputs = outputs + self._materialize_cached(rec)
            except OSError as e:
                # an incomplete result must not end DONE
                cache_error = f"result-cache materialization failed: {e}"
        _H_FINALIZE.observe(time.perf_counter() - t_fin)
        with self._cond:
            if rec.state is not JobState.RUNNING:
                return
            rec.finished_at = time.time()
            if cache_error:
                rec.state = JobState.FAILED
                rec.error = cache_error
                _C_FAILED.inc()
                self._stage_state(rec)
            else:
                rec.state = JobState.DONE
                rec.outputs = outputs
                _C_DONE.inc()
                if rec.submitted_at:
                    _H_JOB_E2E.observe(rec.finished_at - rec.submitted_at)
                if rec.started_at:
                    _H_JOB_RUN.observe(rec.finished_at - rec.started_at)
                self._stage_state(rec, outputs=outputs)
            self._close_job_locked(rec)
            self._maybe_start_locked()
            self._cond.notify_all()
        self._flush_after()
        log.info("job %s %s in %.3fs (%d outputs)", rec.job_id, rec.state,
                 rec.finished_at - (rec.started_at or rec.finished_at),
                 len(rec.outputs))

    def fail_job(self, job_id: str, error: str) -> None:
        """End a running job FAILED with ``error`` (a task of it raised in
        an in-process worker: D5, per job; or a standing query's scan
        failed: D9, the runner's on_fail, called with no follow lock
        held); the other jobs go on."""
        rec = self._jobs.get(job_id)
        if rec is None:
            return
        with self._cond:
            if rec.state is not JobState.RUNNING:
                return
            rec.state = JobState.FAILED
            rec.error = error
            rec.finished_at = time.time()
            _C_FAILED.inc()
            self._stage_state(rec)
            self._close_job_locked(rec)
            self._maybe_start_locked()
            self._cond.notify_all()
        self._flush_after()
        log.error("job %s failed: %s", job_id, error)

    def _flush_after(self) -> None:
        """The writes a state change staged: starts, closes, registry,
        timeline."""
        self._flush_starts()
        self._flush_closes()
        self._flush_registry()
        self._flush_daemon_log()

    def _close_job_locked(self, rec: JobRecord) -> None:
        # stop() and request_stop() are state and a notify; the file
        # closes (and a runner's join) are staged
        if rec.scheduler is not None:
            rec.scheduler.stop()
        if rec.follow is not None:
            rec.follow.request_stop()
        if (rec.journal is not None or rec.event_log is not None
                or rec.follow is not None):
            self._pending_closes.append(
                (rec.scheduler, rec.journal, rec.event_log, rec.follow))
        if rec.job_id in self._running:
            self._running.remove(rec.job_id)
        self._prune_terminal_locked()

    def _flush_closes(self) -> None:
        """Close the staged journals and event logs outside the lock (a
        journal through Scheduler.close_journal, which writes its staged
        completions first).  Never raises."""
        with self._lock:
            if not self._pending_closes:
                return
            pending, self._pending_closes = self._pending_closes, []
        for scheduler, journal, event_log, follow in pending:
            try:
                if follow is not None:
                    # stops the wake loop, wakes the stream's readers,
                    # closes the wake log
                    follow.close()
                if scheduler is not None and journal is not None:
                    scheduler.close_journal()
                elif journal is not None:
                    journal.close()
                if event_log is not None:
                    event_log.close()
            except Exception:  # noqa: BLE001 -- teardown must not fail RPCs
                log.exception("job teardown close failed")

    def _prune_terminal_locked(self) -> None:
        """Keep the newest _MAX_TERMINAL_RECORDS terminal records; an
        evicted id answers 404 (its outputs stay on disk)."""
        terminal = [r for r in self._jobs.values() if r.state in _TERMINAL]
        excess = len(terminal) - _MAX_TERMINAL_RECORDS
        if excess <= 0:
            return
        terminal.sort(key=lambda r: r.finished_at or 0.0)
        for rec in terminal[:excess]:
            del self._jobs[rec.job_id]
        if self._tokens:
            # bounded with the table: an evicted job's token answers as a
            # fresh submit would
            self._tokens = {t: j for t, j in self._tokens.items()
                            if j in self._jobs}

    # ---------------------------------------------------------- cancel
    def cancel(self, job_id: str) -> str:
        """Cancel a queued or running job (a terminal one stays as it is);
        a worker mid-task finishes its attempt and its completion is
        absorbed.  No other job is touched.  The resulting state."""
        rec = self.record(job_id)
        with self._cond:
            if rec.state is JobState.QUEUED:
                self._queue.remove(job_id)
                rec.state = JobState.CANCELLED
                rec.finished_at = time.time()
                _C_CANCELLED.inc()
                self._stage_state(rec)
                self._prune_terminal_locked()
            elif rec.state is JobState.RUNNING:
                rec.state = JobState.CANCELLED
                rec.finished_at = time.time()
                _C_CANCELLED.inc()
                self._stage_state(rec)
                self._close_job_locked(rec)
                self._maybe_start_locked()
            self._cond.notify_all()
        self._flush_after()
        log.info("job %s cancelled", job_id)
        return rec.state

    # ------------------------------------------------------- accessors
    def record(self, job_id: str) -> JobRecord:
        rec = self._jobs.get(job_id)
        if rec is None:
            raise KeyError(f"unknown job: {job_id}")
        return rec

    def wait_job(self, job_id: str, timeout: float | None = None) -> bool:
        """Block until the job is terminal; False on the timeout."""
        rec = self.record(job_id)
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while rec.state not in _TERMINAL:
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    return False
                self._cond.wait(timeout=0.2 if remaining is None
                                else min(0.2, remaining))
        return True

    def _wake(self) -> None:
        with self._cond:
            self._cond.notify_all()

    def stopped(self) -> bool:
        """stop() ran on a daemon that was not deposed: every poll answers
        JOB_DONE.  A deposed daemon's workers are answered with retries,
        so they move on to the new active."""
        with self._lock:
            return self._stopped and not self._deposed

    def count_shuffle_bytes(self, direction: str, n_bytes: int) -> None:
        """One relay shuffle transfer through the daemon's data plane
        (``relay_puts`` or ``relay_gets``)."""
        with self._shuffle_lock:
            self._shuffle_stats["daemon_shuffle_bytes"] += int(n_bytes)
            if direction in self._shuffle_stats:
                self._shuffle_stats[direction] += 1

    def _worker_seen(self, worker_id: int, job: str | None = ...,
                     task: str | None = ..., metrics: dict | None = None,
                     data_endpoint: str | None = None) -> None:
        if worker_id < 0:
            return
        if metrics is not None:
            # the rolling rates, by the worker's process token (consumed
            # here, never stored in the row)
            metrics = dict(metrics)
            src = metrics.pop("proc", None)
            self._cache_rates.observe(
                src if src is not None else float(worker_id), metrics)
        with self._lock:
            info = self.workers.setdefault(worker_id,
                                           {"job": None, "task": None})
            info["seen"] = time.monotonic()
            if job is not ...:
                info["job"] = job
            if task is not ...:
                info["task"] = task
            if metrics is not None:
                info["metrics"] = metrics
            if data_endpoint:
                # the worker's peer-shuffle endpoint: who holds spool state
                info["data_endpoint"] = data_endpoint

    # --------------------------------------------------- control plane
    def assign_task(self, args: rpc.AssignTaskArgs, timeout: float = 30.0,
                    abandon: threading.Event | None = None
                    ) -> rpc.AssignTaskReply:
        """The service-level long poll: sweep the running jobs' schedulers
        round-robin (fair across tenants) with non-blocking polls, and wait
        on the service's condition between sweeps.  A reply names its job
        and application; JOB_DONE only when the daemon stops (an idle
        daemon keeps its workers in retry polls).  An in-process loop
        passes its ``drain`` as ``abandon``: once set, the poll answers a
        retry at the next sweep, so a drained loop ends at once."""
        t0 = time.monotonic()
        try:
            return self._assign_task_inner(args, timeout, abandon)
        finally:
            _H_SVC_ASSIGN_POLL.observe(time.monotonic() - t0)

    def _assign_task_inner(self, args: rpc.AssignTaskArgs, timeout: float,
                           abandon: threading.Event | None = None
                           ) -> rpc.AssignTaskReply:
        deadline = time.monotonic() + timeout
        with self._lock:
            worker_id = args.worker_id
            if worker_id < 0 or worker_id not in self.workers:
                # a fresh attach, or a reconnect across a daemon restart:
                # a new service-allocated id (the worker adopts it)
                while self._next_worker_id in self.workers:
                    self._next_worker_id += 1
                worker_id = self._next_worker_id
                self._next_worker_id += 1
                self.workers[worker_id] = {"job": None, "task": None,
                                           "seen": time.monotonic()}
                self._daemon_event("worker_attach", worker=worker_id)
                now = time.monotonic()
                stale = [wid for wid, info in self.workers.items()
                         if now - info.get("seen", now) > _WORKER_EXPIRE_S]
                for wid in stale:
                    del self.workers[wid]
                    self._daemon_event("worker_expire", worker=wid)
                if stale:
                    with self._span_seq_lock:
                        for wid in stale:
                            self._span_seqs.pop(wid, None)
        # a poll proves the worker alive and not running a task
        self._health.saw(worker_id)
        if args.peer_endpoint:
            # re-advertised every poll (a reconnect under a new id too)
            self._worker_seen(worker_id, data_endpoint=args.peer_endpoint)
        try:
            while True:
                quarantine_s = self._health.quarantine_remaining(worker_id)
                if quarantine_s > 0:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        self._worker_seen(worker_id)
                        return rpc.AssignTaskReply(
                            assignment="retry", task_id=-2,
                            worker_id=worker_id,
                            retry_after_s=round(quarantine_s, 3))
                    with self._cond:
                        if not self._stopped:
                            self._cond.wait(min(remaining, quarantine_s,
                                                _ASSIGN_SWEEP_S))
                with self._lock:
                    if self._deposed:
                        # not JOB_DONE: the worker keeps polling, and its
                        # address list finds the promoted daemon
                        return rpc.AssignTaskReply(
                            assignment="retry", task_id=-2,
                            worker_id=worker_id,
                            retry_after_s=StandbyServer.PARK_RETRY_S)
                    if self._stopped:
                        return rpc.AssignTaskReply(
                            assignment=rpc.Assignment.JOB_DONE,
                            worker_id=worker_id)
                    if quarantine_s > 0:
                        continue
                    order = list(self._running)
                    start = self._rr
                    self._rr += 1
                for i in range(len(order)):
                    rec = self._jobs.get(order[(start + i) % len(order)])
                    if (rec is None or rec.state is not JobState.RUNNING
                            or rec.scheduler is None):
                        continue
                    reply = rec.scheduler.assign_task(
                        rpc.AssignTaskArgs(worker_id=worker_id), timeout=0.0)
                    if reply.assignment in (rpc.Assignment.MAP,
                                            rpc.Assignment.REDUCE):
                        reply.job_id = rec.job_id
                        reply.application = rec.config.application
                        if reply.assignment == rpc.Assignment.MAP:
                            self._plan_fused_assignment(rec, reply,
                                                        worker_id, order)
                        self._worker_seen(
                            worker_id, job=rec.job_id,
                            task=f"{reply.assignment}:{reply.task_id}")
                        return reply
                remaining = deadline - time.monotonic()
                if remaining <= 0 or (abandon is not None
                                      and abandon.is_set()):
                    self._worker_seen(worker_id)
                    return rpc.AssignTaskReply(assignment="retry",
                                               task_id=-2,
                                               worker_id=worker_id)
                with self._cond:
                    if not self._stopped:
                        self._cond.wait(min(remaining, _ASSIGN_SWEEP_S))
        finally:
            self._flush_daemon_log()

    @staticmethod
    def _fusion_plan(config: JobConfig, splits: list) -> tuple:
        """(fusion key, split_identities, fuse_index) of a job; all empty
        when fusion is off (its stats are then never paid) or the job can
        never fuse.  The key is fusion.fusion_key's with the query's family
        (fusion.query_family): a set fuses with sets, a pattern with
        patterns."""
        if not fusion_mod.env_service_fuse():
            return None, [], {}
        key = fusion_mod.fusion_key(config)
        if key is None:
            return None, [], {}
        identities, index = fusion_mod.plan_identities(splits)
        family = fusion_mod.query_family(config.effective_app_options())
        return (key, family), identities, index

    def _plan_fused_assignment(self, rec: JobRecord,
                               reply: rpc.AssignTaskReply, worker_id: int,
                               order: list[str]) -> None:
        """Claim onto a MAP assignment the idle first-attempt map task of
        every other running job with the same fusion key over the same
        split content (Scheduler.claim_map_task), up to
        DGREP_FUSE_MAX_QUERIES queries: one worker scan then serves them
        all.  Each identity is stat'd afresh (the corpus cache's rule): a
        split that changed since submit fuses nothing, and a co-tenant
        whose own paths changed runs solo.  No service lock is held."""
        if rec.fusion_key is None or not fusion_mod.env_service_fuse():
            return
        tid = reply.task_id
        idents = rec.split_identities
        ident = idents[tid] if 0 <= tid < len(idents) else None
        if ident is None:
            return
        if fusion_mod.split_identity(rec.map_splits[tid]) != ident:
            return
        cap = fusion_mod.env_fuse_max_queries()
        planned: list[dict] = []
        for jid2 in order:
            if len(planned) + 1 >= cap:
                break
            if jid2 == rec.job_id:
                continue
            rec2 = self._jobs.get(jid2)
            if (rec2 is None or rec2.state is not JobState.RUNNING
                    or rec2.scheduler is None
                    or rec2.fusion_key != rec.fusion_key):
                continue
            tid2 = rec2.fuse_index.get(ident)
            if tid2 is None:
                continue
            if fusion_mod.split_identity(rec2.map_splits[tid2]) != ident:
                continue
            info = rec2.scheduler.claim_map_task(tid2, worker_id)
            if info is None:
                continue
            planned.append({"job_id": rec2.job_id, **info})
        if not planned:
            return
        reply.fused = planned
        n_bytes = fusion_mod.split_n_bytes(ident)
        with self._fusion_lock:
            self._fusion_stats["fused_jobs"] += 1 + len(planned)
            self._fusion_stats["fused_dispatches"] += 1
            self._fusion_stats["fusion_bytes_saved"] += len(planned) * n_bytes
        # a fuse:plan instant in each participant's events.jsonl
        parts = [(rec.job_id, tid)] + [(p["job_id"], p["task_id"])
                                       for p in planned]
        now = time.time()
        for jid_p, tid_p in parts:
            r = self._jobs.get(jid_p)
            if r is None or r.event_log is None:
                continue
            r.event_log.write({
                "t": "instant", "name": "fuse:plan", "cat": "fuse",
                "ts": now, "job": jid_p,
                "args": {"task": tid_p, "queries": len(parts),
                         "worker": worker_id, "bytes": n_bytes,
                         "participants": [j for j, _ in parts]}})
        log.info("fused map assignment: %d queries share task %s:%d (worker "
                 "%d, %d bytes scanned once)", len(parts), rec.job_id, tid,
                 worker_id, n_bytes)

    # ---------------------------------------------------- shard index
    def _index_app_dir(self, config: JobConfig) -> str | None:
        """The daemon's index store to give the grep app as ``index_dir``,
        or None: the index off (DGREP_INDEX=0), another application, or a
        submitter that chose a store."""
        from distributed_grep_tpu_torch.index.plan import GREP_APPLICATION
        from distributed_grep_tpu_torch.index.summary import env_index_enabled

        if not env_index_enabled():
            return None
        if config.application != GREP_APPLICATION:
            return None
        if config.app_options.get("index_dir"):
            return None
        return str(self.work_root / "index")

    def _index_pruner(self, config: JobConfig):
        """The job's SplitPruner over the store its workers publish to, or
        None (index/plan.pruner_for_job gates it: the index off, a query
        whose empty shards still give output, an ineligible query).  A
        store that cannot be read plans unpruned: that costs a scan, never
        a line."""
        from distributed_grep_tpu_torch.index import plan as index_plan

        try:
            index_dir = (config.effective_app_options().get("index_dir")
                         or self.work_root / "index")
            return index_plan.pruner_for_job(config, index_dir)
        except Exception:  # noqa: BLE001 -- logged; the job plans unpruned
            log.exception("index pruner construction failed; planning "
                          "unpruned")
            return None

    def _stamp_index_plan(self, rec: JobRecord, pruner) -> None:
        """Fold a planning pass's prunes into the record (seeded into the
        job's counters at start) and the daemon's /status "index"."""
        if pruner is None or not (pruner.shards_pruned or pruner.maybe_scans):
            return
        rec.index_shards_pruned += pruner.shards_pruned
        rec.index_bytes_skipped += pruner.bytes_skipped
        with self._index_lock:
            self._index_stats["index_shards_pruned"] += pruner.shards_pruned
            self._index_stats["index_bytes_skipped"] += pruner.bytes_skipped
            self._index_stats["index_maybe_scans"] += pruner.maybe_scans
        if pruner.shards_pruned:
            # the planner's prunes never reach a worker: straight into the
            # rolling window
            self._cache_rates.window.add("index_shards_pruned",
                                         float(pruner.shards_pruned))
            self._cache_rates.window.add("index_bytes_skipped",
                                         float(pruner.bytes_skipped))

    # -------------------------------------------------- result cache
    def _result_plan(self, config: JobConfig, splits: list):
        """The job's ResultPlan, or None: the tier off, a job whose results
        are never cached, or a lookup that failed (a broken store costs a
        scan, never a submit).  Stat and store reads: no lock held."""
        if self._result_store is None or not splits:
            return None
        try:
            key = result_cache_mod.result_key(config)
            if key is None:
                return None
            return result_cache_mod.plan_lookup(self._result_store, key,
                                                splits)
        except Exception:  # noqa: BLE001 -- logged; the job scans
            log.exception("result-cache lookup failed; planning uncached")
            return None

    def _stamp_result_plan(self, rec: JobRecord) -> None:
        """A partial hit's tallies into the record (seeded into its
        counters at start), /status and /metrics.  A full hit stamps in
        _flush_result_hit once its blobs are written: one that cannot be
        written scans instead and must not be counted."""
        plan = rec.result_plan
        if plan is None or not plan.cached or plan.full:
            return
        self._stamp_result_counters(rec, plan)

    def _stamp_result_counters(self, rec: JobRecord, plan) -> None:
        rec.result_splits_reused += plan.splits_reused
        rec.result_bytes_unscanned += plan.bytes_unscanned
        full = plan.full
        with self._result_lock:
            self._result_stats["result_hits" if full
                               else "result_partial_hits"] += 1
            self._result_stats["result_splits_reused"] += plan.splits_reused
            self._result_stats["result_bytes_unscanned"] += (
                plan.bytes_unscanned)
        if full:
            metrics_mod.counter("dgrep_result_hits_total").inc()
        else:
            metrics_mod.counter("dgrep_result_partial_hits_total").inc()
        metrics_mod.counter("dgrep_result_splits_reused_total").inc(
            plan.splits_reused)
        metrics_mod.counter("dgrep_result_bytes_unscanned_total").inc(
            plan.bytes_unscanned)

    @staticmethod
    def _materialize_cached(rec: JobRecord) -> list[str]:
        """Write the plan's stored blobs under the job's work dir
        (``out-cached/result-<i>``, not mr-*, which readers resolve
        through the store) and return their paths.  Each blob is sorted by
        (file, line), so the merge over the scanned and stored outputs is
        a full scan's bytes.  Raises OSError."""
        plan = rec.result_plan
        if not plan.cached:
            return []
        out_dir = rec.workdir.root / "out-cached"
        out_dir.mkdir(parents=True, exist_ok=True)
        paths = []
        for i, blob in plan.cached:
            p = out_dir / f"result-{i}"
            with open(p, "wb") as f:
                f.write(blob)
            paths.append(str(p))
        return paths

    def _flush_result_hit(self, rec: JobRecord) -> bool:
        """Complete a full hit (start-flush context, no service lock): a
        fresh work dir, the stored blobs written as the job's outputs, DONE
        published under the lock with _finalize's accounting; no scheduler,
        no watcher, no worker.  False on any failure: the caller scans the
        job instead."""
        cfg = rec.config
        try:
            workdir = WorkDir(cfg.work_dir,
                              store=make_store(cfg.store, durable=cfg.durable))
            workdir.clear()
            rec.workdir = workdir  # _materialize_cached writes under it
            outputs = self._materialize_cached(rec)
            if spans_mod.enabled(cfg.spans) or self.spans:
                # one instant: explain's verdict for a job no worker saw
                event_log = spans_mod.EventLog(
                    workdir.root / spans_mod.EventLog.FILENAME, fresh=True)
                try:
                    event_log.write({
                        "t": "instant", "name": "result:hit",
                        "cat": "service", "ts": time.time(),
                        "job": rec.job_id,
                        "args": {
                            "splits_reused": rec.result_plan.splits_reused,
                            "bytes_unscanned":
                                rec.result_plan.bytes_unscanned}})
                finally:
                    event_log.close()
        except Exception:  # noqa: BLE001 -- the job scans instead
            log.exception("job %s result-cache hit failed; scanning",
                          rec.job_id)
            rec.workdir = None
            return False
        self._stamp_result_counters(rec, rec.result_plan)
        counters = {"result_splits_reused": rec.result_splits_reused,
                    "result_bytes_unscanned": rec.result_bytes_unscanned}
        if rec.index_shards_pruned:
            counters["index_shards_pruned"] = rec.index_shards_pruned
            counters["index_bytes_skipped"] = rec.index_bytes_skipped
        with self._cond:
            if rec.state is not JobState.RUNNING:
                return True  # a cancel or stop won: its state stands
            rec.hit_counters = counters
            rec.input_allowlist = frozenset(cfg.input_files)
            rec.state = JobState.DONE
            rec.finished_at = time.time()
            rec.outputs = outputs
            _C_DONE.inc()
            if rec.submitted_at:
                _H_JOB_E2E.observe(rec.finished_at - rec.submitted_at)
            if rec.started_at:
                _H_JOB_RUN.observe(rec.finished_at - rec.started_at)
            self._stage_state(rec, outputs=outputs)
            self._close_job_locked(rec)
            self._maybe_start_locked()
            self._cond.notify_all()
        # the staged registry records are written by every caller of
        # _flush_starts after it returns
        log.info("job %s done from the result cache (%d splits, %d bytes "
                 "unscanned)", rec.job_id, rec.result_plan.splits_reused,
                 rec.result_plan.bytes_unscanned)
        return True

    def _publish_results(self, rec: JobRecord,
                         fresh_outputs: list[str]) -> None:
        """Publish the scanned splits' results at the job's end.  Each
        split's identity from submit is checked again with a fresh stat: a
        split that changed while the job ran is not stored (its entry
        would be stale at once).  A job whose records cannot all be
        attributed publishes nothing.  Never raises."""
        plan = rec.result_plan
        if self._result_store is None or plan is None or not plan.remaining:
            return
        try:
            buckets = result_cache_mod.bucket_records(fresh_outputs,
                                                      plan.remaining)
            if buckets is None:
                return
            revalidated = 0
            for split, ident, blob in zip(plan.remaining,
                                          plan.remaining_identities, buckets):
                if ident is None:
                    continue
                if fusion_mod.split_identity(split) != ident:
                    revalidated += 1
                    if rec.event_log is not None:
                        members = (split if isinstance(split, (list, tuple))
                                   else [split])
                        rec.event_log.write({
                            "t": "instant", "name": "result:revalidate",
                            "cat": "service", "ts": time.time(),
                            "job": rec.job_id,
                            "args": {"split": [str(m) for m in members]}})
                    continue
                self._result_store.save(
                    result_cache_mod.ResultKey(plan.query_key, split, ident),
                    blob)
            if revalidated:
                rec.result_revalidations += revalidated
                if rec.scheduler is not None:
                    rec.scheduler.counters["result_revalidations"] += (
                        revalidated)
                with self._result_lock:
                    self._result_stats["result_revalidations"] += revalidated
        except Exception:  # noqa: BLE001 -- best effort, see the docstring
            log.exception("job %s result publication failed", rec.job_id)

    # -------------------------------------------------- task RPCs
    def _route_spans(self, args) -> None:
        """Persist a shipped span batch: dedup by (worker, seq) first, then
        write each record group to its own job's event log (one batch may
        hold several jobs' records).  Consumes ``args.spans``, so the job's
        scheduler does not write it again."""
        recs = getattr(args, "spans", None)
        if not recs:
            return
        args.spans = []
        seq = getattr(args, "spans_seq", -1)
        wid = getattr(args, "worker_id", -1)
        if seq >= 0 and wid >= 0:
            with self._span_seq_lock:
                seen = self._span_seqs.setdefault(wid, set())
                if seq in seen:
                    return
                seen.add(seq)
                if len(seen) > 2 * _SPAN_SEQ_WINDOW:
                    floor = max(seen) - _SPAN_SEQ_WINDOW
                    self._span_seqs[wid] = {s for s in seen if s >= floor}
        for jid, group in spans_mod.split_by_job(
                recs, default=getattr(args, "job_id", "")).items():
            rec = self._jobs.get(jid)
            if rec is None or rec.event_log is None:
                continue  # unknown, terminal, or spans off
            rec.event_log.write_many(group)

    def map_finished(self, args: rpc.TaskFinishedArgs) -> rpc.TaskFinishedReply:
        self._route_spans(args)
        self._worker_seen(args.worker_id, task=None,
                          metrics=(args.metrics or {}).get("piggyback"))
        rec = self._jobs.get(args.job_id)
        if rec is None or rec.scheduler is None:
            return rpc.TaskFinishedReply(ok=False)  # the job is gone
        return rec.scheduler.map_finished(args)

    def reduce_finished(self, args: rpc.TaskFinishedArgs
                        ) -> rpc.TaskFinishedReply:
        self._route_spans(args)
        self._worker_seen(args.worker_id, task=None,
                          metrics=(args.metrics or {}).get("piggyback"))
        rec = self._jobs.get(args.job_id)
        if rec is None or rec.scheduler is None:
            return rpc.TaskFinishedReply(ok=False)
        return rec.scheduler.reduce_finished(args)

    def reduce_next_file(self, args: rpc.ReduceNextFileArgs,
                         timeout: float = 30.0) -> rpc.ReduceNextFileReply:
        rec = self._jobs.get(args.job_id)
        if rec is None or rec.scheduler is None or (
                rec.state is not JobState.RUNNING):
            # the job ended or is gone: abort the attempt (a late duplicate
            # told "done" would commit a short output over the job's)
            return rpc.ReduceNextFileReply(abort=True)
        return rec.scheduler.reduce_next_file(args, timeout=timeout)

    def heartbeat(self, args: rpc.HeartbeatArgs) -> None:
        self._route_spans(args)
        self._worker_seen(args.worker_id, metrics=args.metrics)
        rec = self._jobs.get(args.job_id)
        if rec is not None and rec.scheduler is not None:
            rec.scheduler.heartbeat(args.task_type, args.task_id,
                                    grace_s=args.grace_s, args=args)

    # ------------------------------------------------------- views
    def job_status(self, job_id: str) -> dict:
        rec = self.record(job_id)
        out: dict = {"job_id": rec.job_id, "state": rec.state,
                     "submitted_at": rec.submitted_at,
                     "started_at": rec.started_at,
                     "finished_at": rec.finished_at}
        if rec.error:
            out["error"] = rec.error
        if rec.scheduler is not None:
            out.update(rec.scheduler.status_counts())
            out["metrics"] = rec.metrics()
        elif rec.hit_counters:
            # a full hit has no scheduler: its counters still reach the
            # submit client
            out["metrics"] = rec.metrics()
        if rec.follow is not None:
            out["follow"] = rec.follow.status()
        if rec.state is JobState.DONE:
            out["outputs"] = rec.outputs
        return out

    def job_stream(self, job_id: str, cursor: int = 0,
                   timeout: float = 25.0) -> dict:
        """One page of a standing query's records (GET
        /jobs/<id>/stream?cursor=N), a long poll: the records numbered past
        ``cursor`` (each with its ``seq``; pass the reply's ``next`` back),
        and ``dropped`` when the reader fell behind the ring.  RuntimeError
        for a job that is not a standing query (HTTP 409).  A terminal one
        drains its ring, then answers empty pages with its state."""
        rec = self.record(job_id)
        runner = rec.follow
        if runner is None:
            if rec.config.follow:
                # queued, or its start in flight: an empty page with the
                # state, paced (there is no ring to wait on yet)
                if timeout > 0:
                    time.sleep(min(timeout, 0.5))
                return {"job_id": job_id, "state": rec.state, "records": [],
                        "next": max(0, int(cursor))}
            raise RuntimeError(f"job {job_id} is not a follow job")
        if rec.state is not JobState.RUNNING:
            timeout = 0.0  # terminal: drain, never park the reader
        records, nxt, dropped = runner.ring.read_since(
            cursor, timeout=max(0.0, min(timeout, 60.0)))
        out: dict = {"job_id": job_id, "state": rec.state,
                     "records": records, "next": nxt}
        if dropped:
            out["dropped"] = dropped
            self._daemon_event("stream_shed", job=job_id, dropped=dropped)
            self._flush_daemon_log()
        return out

    def job_explain(self, job_id: str) -> dict:
        """One job's routing report (runtime/explain.assemble over its
        events.jsonl, its record's planning tallies and, with the daemon
        log on, the fleet timeline); the files are read with no lock."""
        from distributed_grep_tpu_torch.runtime import explain as explain_mod

        rec = self.record(job_id)
        events: list = []
        if rec.workdir is not None:
            path = rec.workdir.root / spans_mod.EventLog.FILENAME
            if path.exists():
                events = spans_mod.EventLog.read(path)
        daemon_events = None
        if self._daemon_log is not None:
            self._flush_daemon_log()
            daemon_events = daemon_log_mod.DaemonLog.read(self.work_root)
        return explain_mod.assemble(
            job_id=rec.job_id, config=rec.config, state=rec.state,
            submitted_at=rec.submitted_at, started_at=rec.started_at,
            finished_at=rec.finished_at,
            metrics_counters=rec.metrics()["counters"], events=events,
            index_shards_pruned=rec.index_shards_pruned,
            index_bytes_skipped=rec.index_bytes_skipped,
            result_splits_reused=rec.result_splits_reused,
            result_bytes_unscanned=rec.result_bytes_unscanned,
            result_revalidations=rec.result_revalidations,
            daemon_events=daemon_events)

    def job_result(self, job_id: str) -> dict:
        """A DONE job's committed outputs and final metrics; RuntimeError
        for any other state (HTTP 409)."""
        rec = self.record(job_id)
        if rec.state is not JobState.DONE:
            raise RuntimeError(
                f"job {job_id} has no result: state={rec.state}")
        return {"job_id": rec.job_id, "state": rec.state,
                "outputs": rec.outputs, "metrics": rec.metrics()}

    def status(self) -> dict:
        """The daemon's view: queue, running jobs, a row a job, the worker
        table (with the engine-cache counters each worker ships), and this
        process's own model- and corpus-cache counters (its in-process
        workers'; a daemon whose workers are all remote never imports the
        scan stack, so its view of them stays empty).  The fusion, index
        and shuffle views appear once nonzero; on a daemon serving
        ``grep_cuda`` jobs the fusion and index views are the ones a
        fused or pruned job moves."""
        eng = sys.modules.get("distributed_grep_tpu_torch.ops.engine")
        lay = sys.modules.get("distributed_grep_tpu_torch.ops.layout")
        now = time.monotonic()
        quarantine = self._health.snapshot()
        with self._shuffle_lock:
            shuffle_stats = (dict(self._shuffle_stats)
                             if any(self._shuffle_stats.values()) else {})
        with self._fusion_lock:
            fusion_stats = (dict(self._fusion_stats)
                            if any(self._fusion_stats.values()) else {})
        with self._index_lock:
            index_stats = (dict(self._index_stats)
                           if any(self._index_stats.values()) else {})
        with self._result_lock:
            result_stats = (dict(self._result_stats)
                            if any(self._result_stats.values()) else {})
        if self._result_store is not None:
            # the store's evictions, shown on their own once nonzero
            if self._result_store.stale_evictions:
                result_stats["result_stale_evictions"] = (
                    self._result_store.stale_evictions)
            if self._result_store.lru_evictions:
                result_stats["result_lru_evictions"] = (
                    self._result_store.lru_evictions)
        with self._lock:
            jobs = {jid: {"state": rec.state}
                    for jid, rec in self._jobs.items()}
            queued = len(self._queue)
            running = list(self._running)
            recs = list(self._jobs.values())
            standing = [rec.job_id for rec in recs
                        if rec.state is JobState.RUNNING
                        and rec.follow is not None]
            workers = {}
            for wid, info in sorted(self.workers.items()):
                age = round(now - info["seen"], 3)
                row: dict = {"last_heartbeat_age_s": age,
                             "last_event_age_s": age,
                             "job": info.get("job"),
                             "task": info.get("task")}
                if info.get("metrics") is not None:
                    row["metrics"] = info["metrics"]
                if info.get("data_endpoint"):
                    row["data_endpoint"] = info["data_endpoint"]
                if str(wid) in quarantine["active"]:
                    row["quarantined_s"] = quarantine["active"][str(wid)]
                workers[str(wid)] = row
        tasks_requeued = 0
        maps_lost = 0
        for rec in recs:
            if rec.scheduler is None:
                continue
            counters = rec.scheduler.metrics_snapshot()["counters"]
            tasks_requeued += counters.get("tasks_requeued", 0)
            maps_lost += counters.get("maps_lost_output", 0)
            if rec.job_id in jobs:
                c = rec.scheduler.status_counts()["map"]
                jobs[rec.job_id]["map_completed"] = c["completed"]
                jobs[rec.job_id]["map_total"] = c["total"]
        if maps_lost:
            shuffle_stats["maps_lost_output"] = int(maps_lost)
        # the scale advice, once the daemon is not idle (it reads the
        # running schedulers' own locks: no service lock held)
        scale = self.scale_advice() if (queued or running or workers) else {}
        # the standing queries (the follow module is looked up, never
        # imported, by a daemon that has run none)
        fol = sys.modules.get("distributed_grep_tpu_torch.runtime.follow")
        follow_view: dict = {}
        if standing or (fol is not None and fol.follow_counters()):
            follow_view = {"standing": len(standing)}
            if standing:
                follow_view["jobs"] = standing
            if fol is not None:
                follow_view.update(fol.follow_counters())
        if fol is not None and follow_view:
            follow_view.update(fol.follow_fused_counters())
            if self._follow_groups is not None:
                group_rows = self._follow_groups.status_rows()
                if group_rows:
                    follow_view["groups"] = group_rows
        latency: dict = {}
        for key, hist in (("queue_wait_s", _H_QUEUE_WAIT),
                          ("job_e2e_s", _H_JOB_E2E)):
            p50 = hist.quantile(0.5)
            if p50 is None:
                continue
            p95 = hist.quantile(0.95)
            latency[key] = {"p50": round(p50, 6),
                            "p95": round(p95 if p95 is not None else p50, 6),
                            "count": hist.snapshot()[2]}
        from distributed_grep_tpu_torch.runtime.peer import env_peer_shuffle

        return {
            "service": True,
            # with a lease only: workers and clients tell an active from a
            # standby by it
            **({"role": "deposed" if self._deposed else "active"}
               if self._lease is not None else {}),
            # the peer shuffle on offer: a worker starts its data server
            # only against a daemon that says so
            **({"peer": True} if env_peer_shuffle() else {}),
            "uptime_s": round(time.time() - self.started_at, 3),
            "max_jobs": self.max_jobs,
            "queue_depth_cap": self.queue_depth,
            "queued": queued,
            "running": running,
            "jobs": jobs,
            "workers": workers,
            "tasks_requeued": tasks_requeued,
            "workers_quarantined": quarantine["quarantined_total"],
            "quarantine": quarantine["active"],
            "compile_cache": eng.model_cache_counters() if eng else {},
            "corpus_cache": lay.corpus_cache_counters() if lay else {},
            **({"fusion": fusion_stats} if fusion_stats else {}),
            **({"index": index_stats} if index_stats else {}),
            **({"result_cache": result_stats} if result_stats else {}),
            **({"follow": follow_view} if follow_view else {}),
            **({"shuffle": shuffle_stats} if shuffle_stats else {}),
            **({"scale": scale} if scale else {}),
            **({"latency": latency} if latency else {}),
        }

    def metrics_text(self) -> str:
        """GET /metrics: the process's typed instruments, with scrape-time
        gauges of the queue, the running jobs and the workers, the
        lifetime cache totals and the rolling-window rates."""
        with self._lock:
            queued = len(self._queue)
            running = len(self._running)
            workers = len(self.workers)
            standing = sum(1 for rec in self._jobs.values()
                           if rec.state is JobState.RUNNING
                           and rec.follow is not None)
        metrics_mod.gauge("dgrep_queue_depth").set(queued)
        metrics_mod.gauge("dgrep_jobs_running").set(running)
        metrics_mod.gauge("dgrep_workers_attached").set(workers)
        # the standing queries' gauges, set only once the tier ran (an
        # untouched instrument is not rendered)
        fol = sys.modules.get("distributed_grep_tpu_torch.runtime.follow")
        fc = fol.follow_counters() if fol is not None else {}
        if standing or fc:
            metrics_mod.gauge("dgrep_follow_standing").set(standing)
            metrics_mod.gauge("dgrep_follow_wakes").set(
                fc.get("follow_wakes", 0))
            metrics_mod.gauge("dgrep_follow_suffix_bytes").set(
                fc.get("suffix_bytes_scanned", 0))
            metrics_mod.gauge("dgrep_stream_dropped_records").set(
                fc.get("stream_dropped_records", 0))
        counters: dict = {}
        for mod_name, fn in (
                ("distributed_grep_tpu_torch.ops.engine",
                 "model_cache_counters"),
                ("distributed_grep_tpu_torch.ops.layout",
                 "corpus_cache_counters"),
                ("distributed_grep_tpu_torch.ops.fuse", "fusion_counters"),
                ("distributed_grep_tpu_torch.index.summary",
                 "index_counters")):
            mod = sys.modules.get(mod_name)
            if mod is not None:
                counters.update(getattr(mod, fn)())
        if counters:
            # this process's counters feed the same tracker, under the
            # same token as its in-process workers' piggybacks
            self._cache_rates.observe(metrics_mod.PROC_TOKEN, counters)

        def _c(name: str) -> float:
            return float(counters.get(name, 0))

        metrics_mod.gauge("dgrep_model_cache_hits").set(
            _c("compile_cache_hits"))
        metrics_mod.gauge("dgrep_model_cache_misses").set(
            _c("compile_cache_misses"))
        metrics_mod.gauge("dgrep_corpus_cache_hits").set(
            _c("corpus_cache_hits"))
        metrics_mod.gauge("dgrep_corpus_cache_misses").set(
            _c("corpus_cache_misses"))
        metrics_mod.gauge("dgrep_corpus_cache_bytes_resident").set(
            _c("corpus_cache_bytes_resident"))
        with self._shuffle_lock:
            shuffle_bytes = self._shuffle_stats["daemon_shuffle_bytes"]
        metrics_mod.gauge("dgrep_daemon_shuffle_bytes").set(shuffle_bytes)
        w = self._cache_rates.window_totals()
        metrics_mod.gauge("dgrep_window_model_cache_hits").set(
            w.get("compile_cache_hits", 0.0))
        metrics_mod.gauge("dgrep_window_model_cache_misses").set(
            w.get("compile_cache_misses", 0.0))
        metrics_mod.gauge("dgrep_window_corpus_cache_hits").set(
            w.get("corpus_cache_hits", 0.0))
        metrics_mod.gauge("dgrep_window_corpus_cache_misses").set(
            w.get("corpus_cache_misses", 0.0))
        metrics_mod.gauge("dgrep_window_index_shards_pruned").set(
            w.get("index_shards_pruned", 0.0))
        metrics_mod.gauge("dgrep_window_index_bytes_skipped").set(
            w.get("index_bytes_skipped", 0.0))
        metrics_mod.gauge("dgrep_window_fused_queries").set(
            w.get("fused_queries", 0.0))
        metrics_mod.gauge("dgrep_window_fusion_bytes_saved").set(
            w.get("fusion_bytes_saved", 0.0))

        def _ratio(hits: float, misses: float) -> float:
            total = hits + misses
            return hits / total if total else 0.0

        metrics_mod.gauge("dgrep_model_cache_hit_ratio").set(_ratio(
            w.get("compile_cache_hits", 0.0),
            w.get("compile_cache_misses", 0.0)))
        metrics_mod.gauge("dgrep_corpus_cache_hit_ratio").set(_ratio(
            w.get("corpus_cache_hits", 0.0),
            w.get("corpus_cache_misses", 0.0)))
        if self._lease is not None:
            # touched with a lease only (an untouched gauge is not
            # rendered): 1 active, 0 deposed
            metrics_mod.gauge("dgrep_daemon_role").set(
                0 if self._deposed else 1)
        return metrics_mod.render_prometheus()

    # --------------------------------------------------- elastic pool
    def scale_advice(self) -> dict:
        """The pool's advice: "grow" when assignable demand exceeds the
        idle fresh workers, "shrink" when the daemon is idle with workers
        attached, else "hold", with the inputs it came from.  ``serve
        --max-workers`` follows it for the local pool; a remote fleet's
        operator reads it in GET /status.  A change of verdict is a
        daemon event."""
        with self._lock:
            queued = len(self._queue)
            running = list(self._running)
            recs = [self._jobs.get(jid) for jid in running]
            # only fresh rows are capacity: a drained or dead worker stops
            # polling at once, but its row stays for an hour
            now = time.monotonic()
            workers = sum(1 for info in self.workers.values()
                          if now - info["seen"] <= _SCALE_FRESH_S)
        pending = 0
        in_flight = 0
        oldest_age = 0.0
        for rec in recs:
            if rec is not None and rec.config.follow:
                # a standing query scans on the daemon: a running slot,
                # never a worker task
                continue
            if rec is None or rec.scheduler is None:
                # its start is in flight: its tasks are coming
                pending += 1
                continue
            b = rec.scheduler.backlog()
            pending += b["unassigned"]
            in_flight += b["in_flight"]
            oldest_age = max(oldest_age, b["oldest_inflight_age_s"])
        demand = pending + queued
        if demand > 0 and demand > max(0, workers - in_flight):
            advice, reason = "grow", "assignable demand exceeds idle workers"
        elif workers and not running and not queued:
            advice, reason = "shrink", "no jobs queued or running"
        else:
            advice, reason = "hold", ""
        out = {"advice": advice, "queued_jobs": queued,
               "running_jobs": len(running), "pending_tasks": pending,
               "in_flight_tasks": in_flight,
               "oldest_inflight_age_s": oldest_age,
               "workers_attached": workers}
        if reason:
            out["reason"] = reason
        if advice != self._last_scale_advice:
            self._last_scale_advice = advice
            self._daemon_event("scale_advice", advice=advice,
                               pending_tasks=pending, workers=workers,
                               **({"reason": reason} if reason else {}))
            self._flush_daemon_log()
        return out

    def local_pool_size(self) -> int:
        """The in-process worker loops not draining."""
        return len([lp for lp in getattr(self, "_local_loops", [])
                    if not lp.drain.is_set()])

    def scale_local_pool(self, target: int) -> int:
        """Grow or shrink the in-process pool toward ``target``; the change
        made.  Growing attaches fresh loops (the service allocates their
        ids); shrinking drains the newest, each ending at its next idle
        poll, never in a task."""
        target = max(0, int(target))
        self._prune_local_pool()
        loops = [lp for lp in getattr(self, "_local_loops", [])
                 if not lp.drain.is_set()]
        if target > len(loops):
            self.start_local_workers(target - len(loops))
            self._scale_action("grow", target - len(loops))
            return target - len(loops)
        if target < len(loops):
            for lp in loops[target:]:
                lp.drain.set()
            self._wake()  # a draining loop's long poll returns
            self._scale_action("drain", len(loops) - target)
            return target - len(loops)
        return 0

    def _scale_action(self, action: str, n: int) -> None:
        """One change of the pool: dgrep_scale_actions_total and a daemon
        event (no lock held)."""
        metrics_mod.counter("dgrep_scale_actions_total").inc()
        self._daemon_event("scale_action", action=action, workers=n)
        self._flush_daemon_log()

    def _prune_local_pool(self) -> None:
        """Forget the loops that drained and whose thread ended, so grow
        and shrink cycles do not grow the lists for the daemon's life (the
        two lists grow in step: loop i is thread i)."""
        loops = getattr(self, "_local_loops", [])
        threads = getattr(self, "_local_workers", [])
        if not loops or len(loops) != len(threads):
            return
        kept = [(lp, t) for lp, t in zip(loops, threads)
                if not (lp.drain.is_set() and not t.is_alive())]
        if len(kept) != len(loops):
            self._local_loops = [lp for lp, _ in kept]
            self._local_workers = [t for _, t in kept]

    # ---------------------------------------------------- lifecycle
    def start_local_workers(
        self,
        n: int,
        fault_hooks_per_worker: list[dict] | None = None,
    ) -> list[threading.Thread]:
        """Attach ``n`` in-process worker loops (worker processes attach
        with ``worker --addr``), one shared Metrics among them.  A task
        that raises in one fails the job (or, for a fused attempt, the
        jobs) of that attempt with the error, and the loop goes on with
        the other jobs; a fault hook's WorkerKilled ends the loop."""
        from distributed_grep_tpu_torch.runtime.worker import (
            WorkerKilled,
            WorkerLoop,
        )
        from distributed_grep_tpu_torch.utils import native
        from distributed_grep_tpu_torch.utils.metrics import Metrics

        # the host library builds before any task: no task's detector
        # waits on g++
        native.lib()
        metrics = Metrics()
        loops = [
            WorkerLoop(
                ServiceLocalTransport(self, rpc_timeout_s=self.rpc_timeout_s),
                app=None,  # named by each assignment
                metrics=metrics,
                fault_hooks=(fault_hooks_per_worker or [{}] * n)[i],
                spans_enabled=self.spans)
            for i in range(n)
        ]
        for lp in loops:
            # a draining loop's long poll returns at the next sweep
            lp.transport.drain = lp.drain

        def worker_main(idx: int) -> None:
            loop = loops[idx]
            while True:
                try:
                    loop.run()
                    return
                except WorkerKilled:
                    log.info("service worker %d killed by fault injection",
                             idx)
                    return
                except Exception as e:  # noqa: BLE001 -- fails its jobs
                    jobs = [j for j in loop.attempt_jobs if j]
                    log.error("service worker %d: task of %s failed: %r",
                              idx, jobs, e)
                    for jid in jobs:
                        self.fail_job(jid, f"{type(e).__name__}: {e}")
                    loop.attempt_jobs = []
                    with self._lock:
                        if self._stopped:
                            return
                    if loop.drain.is_set():
                        return

        threads = [threading.Thread(target=worker_main, args=(i,),
                                    name=f"svc-worker-{i}", daemon=True)
                   for i in range(n)]
        for t in threads:
            t.start()
        self._local_workers = getattr(self, "_local_workers", []) + threads
        self._local_loops = getattr(self, "_local_loops", []) + loops
        return threads

    def stop(self, join_timeout_s: float = 10.0) -> None:
        """Stop the daemon: cancel every live job, dismiss long-polling
        workers (JOB_DONE), join the local workers."""
        with self._cond:
            self._stopped = True
            for jid in list(self._queue):
                rec = self._jobs[jid]
                rec.state = JobState.CANCELLED
                rec.finished_at = time.time()
                _C_CANCELLED.inc()
                self._stage_state(rec)
            self._queue.clear()
            for jid in list(self._running):
                rec = self._jobs[jid]
                rec.state = JobState.CANCELLED
                rec.finished_at = time.time()
                _C_CANCELLED.inc()
                self._stage_state(rec)
                self._close_job_locked(rec)
            self._cond.notify_all()
        self._flush_starts()  # drains the cancelled pending starts
        self._flush_closes()
        if self._follow_groups is not None:
            # the runners' closes emptied every group; this stops a loop a
            # raced teardown left
            self._follow_groups.close()
        self._flush_registry()
        if self._daemon_log is not None:
            # a deposed daemon's stop is fenced at the flush (the promoted
            # daemon owns the file), and its log stays for discard()
            self._daemon_event("stop")
            self._flush_daemon_log()
            if self._lease_ok():
                self._daemon_log.close()
        for t in getattr(self, "_local_workers", []):
            t.join(timeout=join_timeout_s)
        self._registry.close()
        if self._lease is not None:
            # the graceful handoff: the lease deleted when still ours, so
            # a standby promotes at its next poll (a deposed daemon's
            # release touches nothing)
            self._lease.release()


# ---------------------------------------------------------- transports
class ServiceLocalTransport:
    """An in-process worker's transport: direct control-plane calls and a
    shared-filesystem data plane scoped to the job of the assignment
    (``bind_job``)."""

    is_local = True

    def __init__(self, service: GrepService, rpc_timeout_s: float = 30.0):
        self.service = service
        self.rpc_timeout_s = rpc_timeout_s
        self._job = ""
        self._wd: WorkDir | None = None
        self.drain: threading.Event | None = None  # the loop's, when pooled

    def bind_job(self, job_id: str) -> None:
        if job_id == self._job and self._wd is not None:
            return
        rec = self.service.record(job_id)
        if rec.workdir is None:
            raise RuntimeError(f"job {job_id} has no work dir (not started)")
        self._job = job_id
        self._wd = rec.workdir

    # control plane
    def assign_task(self, args: rpc.AssignTaskArgs) -> rpc.AssignTaskReply:
        return self.service.assign_task(args, timeout=self.rpc_timeout_s,
                                        abandon=self.drain)

    def map_finished(self, args: rpc.TaskFinishedArgs) -> rpc.TaskFinishedReply:
        return self.service.map_finished(args)

    def reduce_finished(self, args: rpc.TaskFinishedArgs
                        ) -> rpc.TaskFinishedReply:
        return self.service.reduce_finished(args)

    def reduce_next_file(self, args: rpc.ReduceNextFileArgs
                         ) -> rpc.ReduceNextFileReply:
        return self.service.reduce_next_file(args,
                                             timeout=self.rpc_timeout_s)

    def heartbeat(self, args: rpc.HeartbeatArgs) -> float:
        self.service.heartbeat(args)
        return 0.0  # one process, one clock (runtime/transport.py)

    # data plane, scoped to the bound job
    def read_input(self, filename: str) -> bytes:
        return resolve_input_path(filename, self._wd).read_bytes()

    def read_input_path(self, filename: str):
        return resolve_input_path(filename, self._wd), False

    def write_intermediate(self, name: str, data: bytes) -> None:
        self._wd.store.put(self._wd.root / "intermediate" / name, data)

    def read_intermediate(self, name: str) -> bytes:
        return self._wd.store.get(self._wd.root / "intermediate" / name)

    def write_output(self, name: str, data: bytes) -> None:
        self._wd.store.put(self._wd.root / "out" / name, data)

    def write_output_from_file(self, name: str, path: str) -> None:
        self._wd.store.put_from_file(self._wd.root / "out" / name, path,
                                     consume=True)

    def publish_task_commit(self, kind: str, task_id: int, attempt: str,
                            payload: dict) -> None:
        self._wd.store.commit_task(self._wd.commits_dir(), kind, task_id,
                                   attempt, payload)


# ---------------------------------------------------------- HTTP server
class ServiceServer:
    """The HTTP surface of a GrepService (the module docstring)."""

    def __init__(self, service: GrepService, host: str = "127.0.0.1",
                 port: int = 0):
        self.service = service
        self.host = host
        # the data plane's traffic, as the one-shot coordinator counts it
        self._traffic_lock = threading.Lock()
        self.data_plane: Counter = Counter()
        self._httpd = ThreadingHTTPServer((host, port),
                                          _make_service_handler(self))
        self._httpd.daemon_threads = True
        self._serve_thread: threading.Thread | None = None
        # the worker processes attached and not yet polled (ROADMAP.md C9)
        self.attach = AttachTracker()
        # built once: the long-poll window derives from it, and GET /config
        # serves it as the workers' bootstrap
        self._bootstrap = self.bootstrap_config()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def count(self, table: Counter, **adds: float) -> None:
        with self._traffic_lock:
            for k, v in adds.items():
                table[k] += v

    def start(self) -> None:
        self._serve_thread = threading.Thread(
            target=self._httpd.serve_forever, name="http-service",
            daemon=True)
        self._serve_thread.start()
        log.info("service serving on %s:%d (max %d concurrent jobs, queue "
                 "%d)", self.host, self.port, self.service.max_jobs,
                 self.service.queue_depth)

    def ended(self) -> bool:
        return self.service.stopped()

    def shutdown(self, linger_s: float = 0.0) -> None:
        """Stop serving; with ``linger_s`` (the daemon stopped first) serve
        on that long, and while a worker process that attached before the
        stop has not polled (AttachTracker), so each is told JOB_DONE."""
        if linger_s > 0:
            self.attach.wait_settled(linger_s)
        self._httpd.shutdown()
        self._httpd.server_close()

    def bootstrap_config(self) -> JobConfig:
        """A worker's bootstrap (GET /config): the application and options
        come with each assignment, so this names a default application (the
        host grep, which needs no card) and the transport and span knobs."""
        return JobConfig(input_files=[],
                         application="distributed_grep_tpu_torch.apps.grep",
                         work_dir=str(self.service.work_root),
                         spans=self.service.spans,
                         rpc_timeout_s=self.service.rpc_timeout_s)

    def handle_rpc(self, verb: str, payload: dict) -> dict:
        window = long_poll_window_s(self._bootstrap)
        if verb == rpc.Verb.ASSIGN_TASK:
            reply = self.service.assign_task(rpc.AssignTaskArgs(**payload),
                                             timeout=window)
        elif verb == rpc.Verb.MAP_FINISHED:
            reply = self.service.map_finished(rpc.TaskFinishedArgs(**payload))
        elif verb == rpc.Verb.REDUCE_FINISHED:
            reply = self.service.reduce_finished(
                rpc.TaskFinishedArgs(**payload))
        elif verb == rpc.Verb.REDUCE_NEXT_FILE:
            reply = self.service.reduce_next_file(
                rpc.ReduceNextFileArgs(**payload), timeout=window)
        elif verb == rpc.Verb.HEARTBEAT:
            self.service.heartbeat(rpc.HeartbeatArgs(**payload))
            reply = rpc.HeartbeatReply()
        else:
            raise KeyError(f"unknown RPC verb: {verb}")
        return rpc.reply_to_dict(reply)


def _safe_segment(name: str) -> str:
    name = urllib.parse.unquote(name)
    if "/" in name or name.startswith("."):
        raise ValueError(f"invalid path segment: {name!r}")
    return name


def _make_service_handler(server: ServiceServer):
    service = server.service

    class Handler(DataPlaneHandler):
        server_ref = server

        def do_POST(self):
            self._saw_worker()
            try:
                if self.path.startswith("/rpc/"):
                    verb = self.path[len("/rpc/"):]
                    payload = json.loads(self._read_body() or b"{}")
                    self._send_json(server.handle_rpc(verb, payload))
                elif self.path == "/jobs":
                    try:
                        cfg = JobConfig.from_json(
                            (self._read_body() or b"{}").decode("utf-8",
                                                                "strict"))
                        job_id = service.submit(cfg)
                    except AdmissionError as e:
                        self._send_json({"error": str(e)}, 429)
                        return
                    except (TypeError, ValueError, NotImplementedError) as e:
                        self._send_json({"error": f"bad job config: {e}"},
                                        400)
                        return
                    self._send_json({"job_id": job_id}, 202)
                elif (self.path.startswith("/jobs/")
                      and self.path.endswith("/cancel")):
                    job_id = _safe_segment(
                        self.path[len("/jobs/"):-len("/cancel")])
                    try:
                        state = service.cancel(job_id)
                    except KeyError:
                        self._send_json({"error": f"unknown job: {job_id}"},
                                        404)
                        return
                    self._send_json({"ok": True, "state": state})
                else:
                    self._drain_body()
                    self._send_json({"error": "not found"}, 404)
            except BrokenPipeError:
                pass  # a client gave up on a long poll
            except Exception as e:  # noqa: BLE001 -- answered 500
                log.exception("service rpc error on %s", self.path)
                try:
                    self._send_json({"error": str(e)}, 500)
                except OSError:
                    pass

        def do_GET(self):
            self._streaming_body = False  # per request (keep-alive)
            self._saw_worker()
            try:
                path = urllib.parse.urlsplit(self.path).path
                if self.path == "/config":
                    self._send_json(json.loads(server._bootstrap.to_json()))
                elif self.path == "/status":
                    doc = service.status()
                    if service.stopped():
                        # a worker attaching now exits at once (C9)
                        doc["stopped"] = True
                    self._send_json(doc)
                elif self.path == "/metrics":
                    self._send_text(service.metrics_text())
                elif path.startswith("/jobs/") and path.endswith("/stream"):
                    # a page of a standing query's records past ?cursor=N,
                    # a long poll of ?timeout=S; the reader's cursor is its
                    # only state
                    parsed = urllib.parse.urlsplit(self.path)
                    job_id = _safe_segment(
                        parsed.path[len("/jobs/"):-len("/stream")])
                    q = urllib.parse.parse_qs(parsed.query)

                    def _q(name: str, default: float) -> float:
                        try:
                            return float(q.get(name, [default])[0])
                        except (TypeError, ValueError):
                            return default

                    try:
                        self._send_json(service.job_stream(
                            job_id, cursor=int(_q("cursor", 0)),
                            timeout=_q("timeout", 25.0)))
                    except KeyError:
                        self._send_json(
                            {"error": f"unknown job: {job_id}"}, 404)
                    except RuntimeError as e:
                        self._send_json({"error": str(e)}, 409)
                elif self.path.startswith("/jobs/"):
                    rest = self.path[len("/jobs/"):]
                    if rest.endswith("/explain"):
                        job_id = _safe_segment(rest[:-len("/explain")])
                        try:
                            self._send_json(service.job_explain(job_id))
                        except KeyError:
                            self._send_json(
                                {"error": f"unknown job: {job_id}"}, 404)
                    elif rest.endswith("/result"):
                        job_id = _safe_segment(rest[:-len("/result")])
                        try:
                            self._send_json(service.job_result(job_id))
                        except KeyError:
                            self._send_json(
                                {"error": f"unknown job: {job_id}"}, 404)
                        except RuntimeError as e:
                            self._send_json({"error": str(e)}, 409)
                    else:
                        job_id = _safe_segment(rest)
                        try:
                            self._send_json(service.job_status(job_id))
                        except KeyError:
                            self._send_json(
                                {"error": f"unknown job: {job_id}"}, 404)
                elif self.path.startswith("/data/"):
                    job_id, kind, name = self._data_parts()
                    rec = service.record(job_id)
                    if kind == "input":
                        if name not in rec.input_allowlist:
                            self._send_json(
                                {"error": f"not an input split: {name}"}, 403)
                            return
                        p = resolve_input_path(name, rec.workdir)
                        if not p.exists():
                            self._send_json(
                                {"error": f"no such input: {name}"}, 404)
                            return
                        self._send_file(p)
                    elif kind == "intermediate":
                        p = rec.workdir.store.resolve(
                            rec.workdir.root / "intermediate" / name)
                        if p is None:
                            self._send_json(
                                {"error": f"no such file: {name}"}, 404)
                            return
                        service.count_shuffle_bytes("relay_gets",
                                                    p.stat().st_size)
                        self._send_file(p)
                    else:
                        self._send_json({"error": "not found"}, 404)
                else:
                    self._send_json({"error": "not found"}, 404)
            except BrokenPipeError:
                self.close_connection = True
            except KeyError as e:
                self._send_json({"error": str(e)}, 404)
            except Exception as e:  # noqa: BLE001 -- answered 500
                self.close_connection = True
                log.exception("service get error on %s", self.path)
                if getattr(self, "_streaming_body", False):
                    return  # the headers are out: never splice JSON in
                try:
                    self._send_json({"error": str(e)}, 500)
                except OSError:
                    pass

        def do_PUT(self):
            try:
                if not self.path.startswith("/data/"):
                    self._drain_body()
                    self._send_json({"error": "not found"}, 404)
                    return
                job_id, kind, name = self._data_parts()
                wd = service.record(job_id).workdir
                if kind == "intermediate":
                    length = int(self.headers.get("Content-Length", 0))
                    self._receive_file(wd.store,
                                       wd.root / "intermediate" / name)
                    service.count_shuffle_bytes("relay_puts", length)
                    self._send_json({"ok": True})
                elif kind == "out":
                    self._receive_file(wd.store, wd.root / "out" / name)
                    self._send_json({"ok": True})
                elif kind == "commit":
                    self._put_commit(wd.store, wd.commits_dir(), name)
                else:
                    self._drain_body()
                    self._send_json({"error": "not found"}, 404)
            except KeyError as e:
                self._drain_body()
                self._send_json({"error": str(e)}, 404)
            except Exception as e:  # noqa: BLE001 -- answered 500
                self.close_connection = True
                log.exception("service put error on %s", self.path)
                try:
                    self._send_json({"error": str(e)}, 500)
                except OSError:
                    pass

        def _data_parts(self) -> tuple[str, str, str]:
            """'/data/<job>/<kind>/<name>' -> (job, kind, name): job and
            kind are checked segments; an input name may be a whole path
            (one %2F-quoted segment, gated by the job's input allowlist),
            any other name keeps the segment rule."""
            parts = self.path[len("/data/"):].split("/", 2)
            if len(parts) != 3:
                raise ValueError(f"bad data path: {self.path!r}")
            job_id = _safe_segment(parts[0])
            kind = _safe_segment(parts[1])
            name = (urllib.parse.unquote(parts[2]) if kind == "input"
                    else _safe_segment(parts[2]))
            return job_id, kind, name

    return Handler


# ---------------------------------------------------------- standby
class StandbyServer:
    """The surface of a daemon waiting on the work-root lease
    (runtime/lease.py), with no service state behind it: ``/status`` names
    the role and the active's address from the lease file
    (run_http_worker waits on it), an assign poll is answered with a retry
    and ``retry_after_s`` (the worker loop sleeps and polls again), a
    reduce fetch with an abort (the attempt ends with no commit, as a
    zombie's does), a finished RPC or a heartbeat with a plain reply, and
    every other request with a 503, which an address list rotates past.
    A promotion shuts it down and binds the ServiceServer on the same
    address."""

    PARK_RETRY_S = 2.0

    def __init__(self, work_root: str | Path, host: str = "127.0.0.1",
                 port: int = 0):
        self.work_root = Path(work_root)
        self.host = host
        self._httpd = ThreadingHTTPServer((host, port),
                                          _make_standby_handler(self))
        self._httpd.daemon_threads = True
        self._serve_thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "StandbyServer":
        self._serve_thread = threading.Thread(
            target=self._httpd.serve_forever, name="http-standby",
            daemon=True)
        self._serve_thread.start()
        log.info("standby on %s:%d (watching %s)", self.host, self.port,
                 self.work_root)
        return self

    def shutdown(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()

    def status(self) -> dict:
        from distributed_grep_tpu_torch.runtime.lease import WorkRootLease

        rec = WorkRootLease.read(self.work_root) or {}
        # "service": true keeps the readiness probes working; "role" tells
        # a standby from the active
        return {"service": True, "role": "standby",
                "active": rec.get("addr", "")}

    def rpc_reply(self, verb: str, payload: dict):
        if verb == rpc.Verb.ASSIGN_TASK:
            # the caller's worker id echoed: a loop adopts reply.worker_id
            return rpc.AssignTaskReply(
                assignment="retry", task_id=-2,
                worker_id=int(payload.get("worker_id", -1)),
                retry_after_s=self.PARK_RETRY_S)
        if verb == rpc.Verb.REDUCE_NEXT_FILE:
            return rpc.ReduceNextFileReply(abort=True)
        if verb in (rpc.Verb.MAP_FINISHED, rpc.Verb.REDUCE_FINISHED):
            return rpc.TaskFinishedReply()
        if verb == rpc.Verb.HEARTBEAT:
            return rpc.HeartbeatReply()
        raise KeyError(f"unknown RPC verb: {verb}")


_STANDBY_ERROR = {"error": "standby: no lease held here"}


def _make_standby_handler(server: StandbyServer):
    class Handler(DataPlaneHandler):
        def do_POST(self):
            try:
                if self.path.startswith("/rpc/"):
                    verb = self.path[len("/rpc/"):]
                    payload = json.loads(self._read_body() or b"{}")
                    self._send_json(rpc.reply_to_dict(
                        server.rpc_reply(verb, payload)))
                else:
                    self._drain_body()
                    self._send_json(_STANDBY_ERROR, 503)
            except BrokenPipeError:
                pass
            except KeyError as e:
                self._send_json({"error": str(e)}, 404)
            except Exception as e:  # noqa: BLE001 -- answered 500
                log.exception("standby rpc error on %s", self.path)
                try:
                    self._send_json({"error": str(e)}, 500)
                except OSError:
                    pass

        def do_GET(self):
            self._streaming_body = False
            try:
                if self.path == "/status":
                    self._send_json(server.status())
                else:
                    self._send_json(_STANDBY_ERROR, 503)
            except BrokenPipeError:
                self.close_connection = True
            except Exception as e:  # noqa: BLE001 -- answered 500
                self.close_connection = True
                try:
                    self._send_json({"error": str(e)}, 500)
                except OSError:
                    pass

        def do_PUT(self):
            try:
                self._drain_body()
                self._send_json(_STANDBY_ERROR, 503)
            except OSError:
                pass

    return Handler
