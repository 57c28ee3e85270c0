"""Cross-process span and event pipeline for the MapReduce control plane
(the reference's utils/spans.py).

Every task attempt emits structured spans (read, compute, emit, shuffle,
commit, and one ``scan:<mode>`` record per engine scan) tagged with its
(job, task, attempt, worker) ids, plus instant events.  Workers buffer
records in a bounded ``SpanBuffer`` and flush them piggybacked on the
Heartbeat and TaskFinished RPCs (the fields are elided from the wire when
empty); the coordinator persists them, with its own scheduling decisions,
as ``events.jsonl`` in the work dir (``EventLog``) and estimates each
worker's clock offset from heartbeat round-trip midpoints
(``ClockSync``).  ``export_chrome_trace`` renders the log as Chrome
trace_event JSON (Perfetto, chrome://tracing): a row per worker, a
coordinator row for the scheduling decisions.

Everything is a no-op unless a job switches the pipeline on
(``JobConfig.spans`` or DGREP_SPANS=1): outside a task context ``span``,
``instant`` and ``scan_record`` return at once, RPC payloads carry no
extra field, and no file is written.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from pathlib import Path

from distributed_grep_tpu_torch.utils import event_audit, lockdep

_ENV_VAR = "DGREP_SPANS"

# Bounded buffering: a match-dense job can emit one scan record per chunk;
# past the cap records drop (counted, reported as a spans_dropped instant)
# rather than grow worker memory or RPC payloads without bound.
BUFFER_CAP = 4096
FLUSH_MAX = 512  # records per RPC piggyback — bounds heartbeat body size


def env_enabled() -> bool:
    """True when DGREP_SPANS switches the pipeline on process-wide."""
    return os.environ.get(_ENV_VAR, "") not in ("", "0")


def enabled(config_flag: bool = False) -> bool:
    """The effective on/off verdict: an explicit JobConfig.spans wins, the
    DGREP_SPANS env var forces on (operator override, like DGREP_TRACE_DIR)."""
    return bool(config_flag) or env_enabled()


class SpanBuffer:
    """Thread-safe bounded record buffer — one per worker loop.  Records are
    plain dicts (JSON-ready); `drain` hands out at most FLUSH_MAX per call
    so one RPC never ships an unbounded body."""

    def __init__(self, cap: int = BUFFER_CAP):
        self._lock = lockdep.make_lock("span-buffer")
        self._recs: list[dict] = []
        self.cap = cap
        self.dropped = 0
        # Tags applied to buffer-synthesized records (the spans_dropped
        # report) — emitted records carry their task_context tags already,
        # but the buffer itself needs to know at least (job, worker) so a
        # drop report renders on the owning worker's trace row, not the
        # coordinator's.  The owner updates this as ids become known.
        self.base_tags: dict = {}
        self.seq = 0  # batch counter (drain_batch) — the RPC dedup key

    def add(self, rec: dict) -> None:
        if event_audit.is_active() and rec.get("t") in ("span", "instant"):
            event_audit.record(rec["t"], rec.get("name"))
        with self._lock:
            if len(self._recs) >= self.cap:
                self.dropped += 1
                return
            self._recs.append(rec)

    def __len__(self) -> int:
        with self._lock:
            return len(self._recs)

    def drain(self, limit: int = FLUSH_MAX) -> list[dict]:
        """Remove and return up to `limit` buffered records.  A nonzero drop
        count is reported once (as a spans_dropped instant) when the buffer
        fully drains — silent truncation would read as full coverage."""
        with self._lock:
            return self._drain_locked(limit)

    def drain_batch(self, limit: int = FLUSH_MAX) -> tuple[int, list[dict]]:
        """drain() plus a per-buffer batch sequence number, allocated
        atomically with the drain — the RPC piggyback's dedup key: a
        transport-level retry reships the SAME (seq, batch), so the
        coordinator persists it once.  (-1, []) when nothing is buffered."""
        with self._lock:
            out = self._drain_locked(limit)
            if not out:
                return -1, out
            self.seq += 1
            return self.seq, out

    def _drain_locked(self, limit: int) -> list[dict]:
        out, self._recs = self._recs[:limit], self._recs[limit:]
        if self.dropped and not self._recs:
            out.append({
                **self.base_tags,
                "t": "instant", "name": "spans_dropped", "cat": "pipeline",
                "ts": time.time(), "args": {"count": self.dropped},
            })
            self.dropped = 0
        return out


# --------------------------------------------------------------- ambient ctx
# Thread-local task context: the worker loop opens it around each task
# attempt; code below it (engine scans, app hooks) emits without plumbing.
# Thread-local by design — worker slots share one process (and one app
# module), and each slot's attempt must tag its own records.
_tls = threading.local()


@contextmanager
def task_context(buffer: SpanBuffer, **tags):
    """Make `buffer` the current thread's span sink, tagging every record
    with `tags` (job/task/attempt/worker/kind).  Nests: the previous
    context is restored on exit."""
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = (buffer, tags)
    try:
        yield
    finally:
        _tls.ctx = prev


def active() -> bool:
    """True when the current thread is inside a task_context — the single
    gate every emitter checks, so disabled runs never build record dicts."""
    return getattr(_tls, "ctx", None) is not None


def _emit(rec: dict) -> None:
    ctx = getattr(_tls, "ctx", None)
    if ctx is None:
        return
    buffer, tags = ctx
    buffer.add({**tags, **rec})


def complete(name: str, ts: float, dur: float, cat: str = "task",
             **args) -> None:
    """Emit an already-timed span (ts = wall-clock start, dur seconds)."""
    if not active():
        return
    rec: dict = {"t": "span", "name": name, "cat": cat,
                 "ts": ts, "dur": dur}
    if args:
        rec["args"] = args
    _emit(rec)


@contextmanager
def span(name: str, cat: str = "task", **args):
    """Timed region on the current task's row; no-op outside a context."""
    if not active():
        yield
        return
    t0 = time.time()
    try:
        yield
    finally:
        complete(name, t0, time.time() - t0, cat=cat, **args)


def instant(name: str, cat: str = "task", **args) -> None:
    """Point event (degrade/fallback transition); no-op outside a context."""
    if not active():
        return
    rec: dict = {"t": "instant", "name": name, "cat": cat, "ts": time.time()}
    if args:
        rec["args"] = args
    _emit(rec)


# Engine stats keys promoted into scan telemetry records when present
# (ops/engine.py / ops/device_scan.py populate them per scan).
_SCAN_STAT_KEYS = (
    "candidates", "confirm_seconds", "end_offsets",
    "feed_wait_seconds", "read_wait_seconds", "fdr_fallback",
)


def scan_record(mode: str, n_bytes: int, seconds: float,
                stats: dict | None = None, matches: int | None = None) -> None:
    """Per-scan engine telemetry: one span named scan:<mode> whose args are
    the structured form of `engine.stats` (candidates, confirm seconds,
    fallback flags).  The engine calls this after every scan(); it no-ops
    unless the scanning thread is inside a task_context."""
    if not active():
        return
    st = stats or {}
    args: dict = {
        "mode": mode,
        "bytes": int(n_bytes),
        # always present, both paths: the degraded-mode marker the
        # acceptance tests key on
        "device_fallback": bool(st.get("device_fallback", False)),
    }
    if matches is not None:
        args["matches"] = int(matches)
    for k in _SCAN_STAT_KEYS:
        if k in st:
            v = st[k]
            args[k] = round(v, 6) if isinstance(v, float) else v
    now = time.time()
    _emit({"t": "span", "name": f"scan:{mode}", "cat": "engine",
           "ts": now - seconds, "dur": seconds, "args": args})


def split_by_job(recs: list[dict], default: str = "") -> dict[str, list[dict]]:
    """Group span/event records by their 'job' tag, preserving order —
    the service daemon's per-job event routing (runtime/service.py): one
    drained worker batch may carry records from several jobs' attempts
    (the buffer flushes on whatever RPC goes next), and each group must
    land in ITS job's events.jsonl.  Records without a job tag fall to
    ``default`` (the RPC's own job)."""
    out: dict[str, list[dict]] = {}
    for r in recs:
        out.setdefault(r.get("job") or default, []).append(r)
    return out


# ------------------------------------------------------------- coordinator
class EventLog:
    """Append-only events.jsonl writer — the coordinator's persisted job
    event log in the work dir.  Thread-safe (RPC handler threads + the
    sweeper write concurrently); one JSON object per line."""

    FILENAME = "events.jsonl"

    def __init__(self, path: str | Path, fresh: bool = False):
        # fresh=True truncates (a fresh job on a reused work dir must not
        # splice a previous job's events); resume appends — one job, one
        # log across coordinator restarts.
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        # io_ok: serializing the write+flush is this lock's purpose
        self._lock = lockdep.make_lock("event-log", io_ok=True)
        self._f = open(self.path, "w" if fresh else "a", encoding="utf-8")

    def write(self, rec: dict) -> None:
        self.write_many([rec])

    def write_many(self, recs: list[dict]) -> None:
        if not recs:
            return
        if event_audit.is_active():
            for r in recs:
                # non-event records (worker_clock observations, follow
                # cursor lines) pass through unaudited
                if r.get("t") in ("span", "instant"):
                    event_audit.record(r["t"], r.get("name"))
        lines = "".join(
            json.dumps(r, separators=(",", ":"), sort_keys=True,
                       default=str) + "\n"
            for r in recs
        )
        with self._lock:
            if self._f.closed:
                return  # late flush after job teardown: drop, don't crash
            self._f.write(lines)
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()

    @staticmethod
    def read(path: str | Path) -> list[dict]:
        """Parse an events.jsonl; a torn final line (coordinator killed
        mid-write) is skipped, mirroring the journal's torn-tail policy."""
        out: list[dict] = []
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:
                    continue  # torn tail / foreign line
        return out


class ClockSync:
    """Per-worker clock-offset estimation from heartbeat RTT midpoints.

    Each heartbeat carries the worker's wall-clock send time and its
    measured RTT for the previous heartbeat; the coordinator's receive time
    minus half that RTT estimates its own clock at the send instant, so
    offset = (recv - rtt/2) - sent_at, EWMA-smoothed.  Adding the offset to
    a worker's span timestamps aligns them with the coordinator row."""

    def __init__(self, alpha: float = 0.3):
        self.alpha = alpha
        self.offsets: dict[int, float] = {}
        self.rtts: dict[int, float] = {}

    def observe(self, worker_id: int, sent_at: float, recv_at: float,
                rtt_s: float) -> float | None:
        """Fold one heartbeat observation in; returns the updated offset
        estimate (seconds to ADD to worker timestamps), or None when the
        heartbeat carried no send timestamp (old worker / piggyback off)."""
        if worker_id < 0 or sent_at <= 0:
            return None
        rtt = rtt_s if rtt_s and rtt_s > 0 else 0.0
        est = (recv_at - rtt / 2.0) - sent_at
        prev = self.offsets.get(worker_id)
        cur = est if prev is None else prev + self.alpha * (est - prev)
        self.offsets[worker_id] = cur
        if rtt:
            self.rtts[worker_id] = rtt
        return cur


# ------------------------------------------------------------ trace export
# Record keys that are structural (row/time placement), not span payload.
_STRUCTURAL = {"t", "name", "cat", "ts", "dur", "worker", "args"}


def _tid_for(rec: dict) -> int:
    """Row assignment: coordinator records (no worker tag, or worker < 0)
    land on tid 0; worker N gets tid N+1."""
    w = rec.get("worker")
    if not isinstance(w, int) or w < 0:
        return 0
    return w + 1


def export_chrome_trace(events: list[dict]) -> dict:
    """Render event-log records as a Chrome trace_event JSON object
    ({"traceEvents": [...]}) — loadable in Perfetto (ui.perfetto.dev),
    chrome://tracing, and TensorBoard's trace viewer, the same viewers the
    torch.profiler trace of DGREP_TRACE_DIR loads into (utils/trace.py).

    Timestamps are microseconds on the coordinator's clock: worker rows are
    shifted by the last persisted clock-offset estimate for that worker.
    """
    offsets: dict[int, float] = {}
    for r in events:
        if r.get("t") == "worker_clock" and isinstance(r.get("worker"), int):
            offsets[r["worker"]] = float(r.get("offset_s", 0.0))

    out: list[dict] = []
    pid = 1
    out.append({"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
                "args": {"name": "dgrep job"}})
    tids: dict[int, str] = {0: "coordinator"}
    for r in events:
        tid = _tid_for(r)
        if tid not in tids:
            tids[tid] = f"worker {r['worker']}"
    for tid, name in sorted(tids.items()):
        out.append({"ph": "M", "pid": pid, "tid": tid, "name": "thread_name",
                    "args": {"name": name}})
        out.append({"ph": "M", "pid": pid, "tid": tid,
                    "name": "thread_sort_index", "args": {"sort_index": tid}})

    for r in events:
        t = r.get("t")
        if t not in ("span", "instant") or "ts" not in r:
            continue
        tid = _tid_for(r)
        w = r.get("worker")
        off = offsets.get(w, 0.0) if isinstance(w, int) and w >= 0 else 0.0
        args = {k: v for k, v in r.items() if k not in _STRUCTURAL}
        args.update(r.get("args") or {})
        ev: dict = {
            "name": str(r.get("name", "?")),
            "cat": str(r.get("cat", "event")),
            "pid": pid,
            "tid": tid,
            "ts": (float(r["ts"]) + off) * 1e6,
            "args": args,
        }
        if t == "span":
            ev["ph"] = "X"
            ev["dur"] = max(0.0, float(r.get("dur", 0.0))) * 1e6
        else:
            ev["ph"] = "i"
            ev["s"] = "t"
        out.append(ev)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def export_fleet_trace(daemon_events: list[dict],
                       jobs: dict[str, list[dict]] | None = None) -> dict:
    """Render a whole work root — the daemon.jsonl fleet timeline
    (runtime/daemon_log.py) merged with every job's events.jsonl — as one
    Chrome trace (``trace-export --fleet``).

    Layout: pid 1 is the daemon fleet (sorted ABOVE the jobs), one row
    per lease epoch (epoch 0 = single-daemon) carrying the incarnation's
    lifetime as a span, its lifecycle events as instants, and — when a
    steal/acquire is followed by a ``promoted`` event — a synthesized
    ``promotion`` span whose width IS the failover latency.  Each job is
    its own process (pids 2+), rendered by export_chrome_trace
    unchanged, so a chaos SIGKILL-failover run reads top-to-bottom:
    which daemon served when, and what every job's workers were doing
    through the transition."""
    out: list[dict] = []
    pid = 1
    out.append({"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
                "args": {"name": "dgrep daemon fleet"}})
    out.append({"ph": "M", "pid": pid, "tid": 0,
                "name": "process_sort_index", "args": {"sort_index": 0}})
    by_epoch: dict[int, list[dict]] = {}
    for r in daemon_events:
        by_epoch.setdefault(int(r.get("epoch", 0)), []).append(r)
    for tid, epoch in enumerate(sorted(by_epoch)):
        recs = sorted(by_epoch[epoch], key=lambda r: r.get("ts", 0.0))
        pids = sorted({r["pid"] for r in recs if r.get("pid") is not None})
        label = f"daemon epoch {epoch}"
        if pids:
            label += f" (pid {pids[0]})"
        out.append({"ph": "M", "pid": pid, "tid": tid, "name": "thread_name",
                    "args": {"name": label}})
        out.append({"ph": "M", "pid": pid, "tid": tid,
                    "name": "thread_sort_index", "args": {"sort_index": tid}})
        stamps = [float(r["ts"]) for r in recs if "ts" in r]
        if stamps:
            # the incarnation's observed lifetime (first to last event)
            out.append({
                "name": f"lease epoch {epoch}", "cat": "lease", "ph": "X",
                "pid": pid, "tid": tid, "ts": min(stamps) * 1e6,
                "dur": max(0.0, max(stamps) - min(stamps)) * 1e6,
                "args": {"epoch": epoch},
            })
        steal_ts: float | None = None
        for r in recs:
            kind = str(r.get("kind", "?"))
            ts = float(r.get("ts", 0.0))
            args: dict = {"role": r.get("role"), "pid": r.get("pid")}
            args.update(r.get("payload") or {})
            if kind in ("lease_steal", "lease_acquire"):
                steal_ts = ts
            elif kind == "promoted" and steal_ts is not None:
                # promotion latency: stale-lease detection (the steal)
                # to serving — the gap the failover SLO histogram samples
                out.append({
                    "name": "promotion", "cat": "lease", "ph": "X",
                    "pid": pid, "tid": tid, "ts": steal_ts * 1e6,
                    "dur": max(0.0, ts - steal_ts) * 1e6,
                    "args": dict(args),
                })
                steal_ts = None
            out.append({"name": kind, "cat": "daemon", "ph": "i", "s": "t",
                        "pid": pid, "tid": tid, "ts": ts * 1e6,
                        "args": args})
    job_pid = 2
    for job_id in sorted(jobs or {}):
        doc = export_chrome_trace(jobs[job_id])
        out.append({"ph": "M", "pid": job_pid, "tid": 0,
                    "name": "process_sort_index",
                    "args": {"sort_index": job_pid}})
        for ev in doc["traceEvents"]:
            ev = dict(ev)
            ev["pid"] = job_pid
            if ev.get("ph") == "M" and ev.get("name") == "process_name":
                ev["args"] = {"name": f"dgrep job {job_id}"}
            out.append(ev)
        job_pid += 1
    return {"traceEvents": out, "displayTimeUnit": "ms"}
