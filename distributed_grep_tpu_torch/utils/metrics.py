"""Per-job metrics and the process-wide typed instruments (the
reference's utils/metrics.py).

``Metrics``: thread-safe counters and timers, one instance per
coordinator or worker loop, whose ``piggyback()`` snapshot rides the
heartbeat and finished RPCs when the span pipeline is on.

The typed instruments, ``MetricCounter`` / ``Gauge`` / ``Histogram``
(fixed log-spaced buckets), live in a named ``MetricsRegistry`` rendered
as Prometheus text exposition (``GET /metrics`` on the coordinator).
Every exported series name is declared once in ``SERIES``, with its kind
and help line; the table is the reference's, so the same sequence of
``inc``/``observe``/``set`` renders the same bytes in both packages.
Instruments take one leaf lock each (built through ``lockdep.make_lock``)
and a never-touched one renders without taking it.  ``RateWindow`` and
``CounterDeltaTracker`` turn monotonic counters into rolling-window
rates.
"""

from __future__ import annotations

import bisect
import json
import os
import threading
import time
from collections import defaultdict, deque
from contextlib import contextmanager
from dataclasses import dataclass, field

from distributed_grep_tpu_torch.utils import lockdep


def _metrics_lock():
    return lockdep.make_lock("metrics")


@dataclass
class Metrics:
    """Thread-safe counters + timers; one instance per coordinator/worker."""

    counters: dict[str, float] = field(default_factory=lambda: defaultdict(float))
    timings: dict[str, list[float]] = field(default_factory=lambda: defaultdict(list))
    _lock: object = field(default_factory=_metrics_lock, repr=False)

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self.counters[name] += value

    def observe(self, name: str, seconds: float) -> None:
        with self._lock:
            self.timings[name].append(seconds)

    @contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(name, time.perf_counter() - t0)

    def record_scan(self, n_bytes: int, seconds: float) -> None:
        """Throughput accounting for the north-star GB/s metric."""
        with self._lock:
            self.counters["bytes_scanned"] += n_bytes
            self.counters["scan_seconds"] += seconds

    def gbps(self) -> float:
        secs = self.counters.get("scan_seconds", 0.0)
        return (self.counters.get("bytes_scanned", 0.0) / 1e9 / secs) if secs else 0.0

    def piggyback(self) -> dict:
        """Compact counters snapshot for the heartbeat span-pipeline
        piggyback (runtime/rpc.py): every counter plus the computed gbps
        headline — small enough to ship on each stamp, rich enough for
        GET /status per-worker aggregates."""
        with self._lock:
            out = dict(self.counters)
        if out.get("scan_seconds"):
            # 6 digits: tiny jobs (a few KB) must not round to 0.0
            out["gbps"] = round(self.gbps(), 6)
        return out

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "counters": dict(self.counters),
                "timings": {
                    k: {
                        "count": len(v),
                        "total_s": sum(v),
                        "mean_s": sum(v) / len(v),
                        "max_s": max(v),
                    }
                    for k, v in self.timings.items()
                    if v
                },
            }
        if out["counters"].get("scan_seconds"):
            out["throughput_GBps"] = round(self.gbps(), 3)
        return out

    def dump(self) -> str:
        return json.dumps(self.snapshot(), indent=2, sort_keys=True)


# ======================================================================
# Typed process-wide instruments
# ======================================================================

# One stable per-process token, piggybacked (spans-on only) alongside the
# engine-cache counters so the service-side delta tracker can attribute
# monotonic counter streams to their SOURCE PROCESS: N in-process worker
# loops share one process's module-global cache counters — summing their
# per-worker-id deltas would multiply every hit by N — and a worker
# reconnecting across a daemon restart gets a FRESH service-allocated id
# while its counters keep counting, which an id-keyed tracker would
# re-baseline as brand-new activity.  A random 48-bit int is exact in a
# float (the piggyback metrics dict is float-valued on the wire).
PROC_TOKEN: float = float(int.from_bytes(os.urandom(6), "big"))

# Fixed log-spaced (x4) latency buckets, 1 ms .. ~262 s: queue waits,
# assign polls, task walls, and whole-job latencies all land inside.
# Literal floats (not computed) so bucket labels render byte-stable.
DEFAULT_BUCKETS: tuple[float, ...] = (
    0.001, 0.004, 0.016, 0.064, 0.256, 1.024,
    4.096, 16.384, 65.536, 262.144,
)

DEFAULT_WINDOW_S = 300.0
_WINDOW_GRANULARITY_S = 10.0


def env_metrics_window_s(default: float = DEFAULT_WINDOW_S) -> float:
    """Rolling-rate window width — the ONE parser of
    DGREP_METRICS_WINDOW_S (malformed or <= 0 keeps the default, the
    env_batch_bytes shrug-off policy)."""
    raw = os.environ.get("DGREP_METRICS_WINDOW_S")
    if raw is None or raw == "":
        return default
    try:
        v = float(raw)
    except ValueError:
        return default
    return v if v > 0 else default


# The exported-series registry: every series name a `counter()`/
# `gauge()`/`histogram()` call site may create, declared exactly once with
# its kind and help line (the /metrics HELP text).  The table is the
# reference's whole, the series of the tiers this package has not ported
# yet (the service daemon, the follow tier, failover, the result cache)
# included: an instrument renders only once it is created, so a series
# nobody creates costs nothing.
SERIES: dict[str, tuple[str, str]] = {
    # job lifecycle (runtime/service.py)
    "dgrep_jobs_submitted_total": ("counter", "Jobs admitted by submit()."),
    "dgrep_jobs_rejected_total": (
        "counter", "Submits rejected by admission control (429s)."),
    "dgrep_jobs_done_total": ("counter", "Jobs finished successfully."),
    "dgrep_jobs_failed_total": ("counter", "Jobs that ended FAILED."),
    "dgrep_jobs_cancelled_total": ("counter", "Jobs that ended CANCELLED."),
    "dgrep_queue_wait_seconds": (
        "histogram", "Submit-to-start queue wait per job."),
    "dgrep_job_run_seconds": (
        "histogram", "Start-to-finish wall per job."),
    "dgrep_job_e2e_seconds": (
        "histogram", "Submit-to-finish end-to-end latency per job."),
    "dgrep_finalize_seconds": (
        "histogram", "Output-listing finalize wall per job."),
    # scheduling (runtime/scheduler.py + the service assign loop)
    "dgrep_assign_poll_seconds": (
        "histogram", "AssignTask long-poll wall until an answer."),
    "dgrep_map_phase_seconds": (
        "histogram", "Scheduler construction to last map commit."),
    "dgrep_reduce_phase_seconds": (
        "histogram", "Map-phase completion to last reduce commit."),
    "dgrep_tasks_requeued_total": (
        "counter", "Tasks re-enqueued by the timeout sweeper."),
    "dgrep_workers_quarantined_total": (
        "counter", "Quarantine episodes entered (WorkerHealth)."),
    # worker task walls (runtime/worker.py; in-process workers land in the
    # daemon's registry, remote workers in their own process's /metrics)
    "dgrep_map_task_seconds": ("histogram", "Whole map-attempt wall."),
    "dgrep_reduce_task_seconds": ("histogram", "Whole reduce-attempt wall."),
    # live scale signal (set at scrape from service state)
    "dgrep_queue_depth": ("gauge", "Jobs queued, awaiting a running slot."),
    "dgrep_jobs_running": ("gauge", "Jobs currently running."),
    "dgrep_workers_attached": ("gauge", "Worker rows in the service table."),
    # peer-to-peer shuffle (runtime/peer.py): intermediate
    # bytes that transited the DAEMON's data plane — ~0 with peer
    # shuffle on (reducers fetch directly from producers)
    "dgrep_daemon_shuffle_bytes": (
        "gauge", "Relay shuffle bytes through the daemon data plane."),
    # lifetime cache totals (set at scrape from the owning modules,
    # sys.modules-gated — a remote-worker daemon reports zeros)
    "dgrep_model_cache_hits": ("gauge", "Compiled-model cache hits, lifetime."),
    "dgrep_model_cache_misses": (
        "gauge", "Compiled-model cache misses, lifetime."),
    "dgrep_corpus_cache_hits": (
        "gauge", "Device corpus cache hits, lifetime."),
    "dgrep_corpus_cache_misses": (
        "gauge", "Device corpus cache misses, lifetime."),
    "dgrep_corpus_cache_bytes_resident": (
        "gauge", "Device-resident corpus cache bytes."),
    # rolling-window rates (CounterDeltaTracker over the piggybacked
    # counters; window width DGREP_METRICS_WINDOW_S)
    "dgrep_window_model_cache_hits": (
        "gauge", "Model cache hits in the rolling window."),
    "dgrep_window_model_cache_misses": (
        "gauge", "Model cache misses in the rolling window."),
    "dgrep_window_corpus_cache_hits": (
        "gauge", "Corpus cache hits in the rolling window."),
    "dgrep_window_corpus_cache_misses": (
        "gauge", "Corpus cache misses in the rolling window."),
    "dgrep_window_index_shards_pruned": (
        "gauge", "Shards index-pruned in the rolling window."),
    "dgrep_window_index_bytes_skipped": (
        "gauge", "Bytes index-skipped in the rolling window."),
    "dgrep_window_fused_queries": (
        "gauge", "Queries served by fused scans in the rolling window."),
    "dgrep_window_fusion_bytes_saved": (
        "gauge", "Bytes co-tenants did not re-scan in the rolling window."),
    "dgrep_model_cache_hit_ratio": (
        "gauge", "Windowed model-cache hit ratio (hits/(hits+misses))."),
    "dgrep_corpus_cache_hit_ratio": (
        "gauge", "Windowed corpus-cache hit ratio (hits/(hits+misses))."),
    # streaming tier (runtime/follow.py): set at scrape, and only once
    # the tier has activity
    "dgrep_follow_standing": (
        "gauge", "Standing follow queries currently running."),
    "dgrep_follow_wakes": (
        "gauge", "Follow wakes that scanned appended data, lifetime."),
    "dgrep_follow_suffix_bytes": (
        "gauge", "Appended bytes suffix-scanned by standing queries."),
    "dgrep_stream_dropped_records": (
        "gauge", "Stream records shed oldest-first by bounded buffers."),
    # fleet timeline / HA SLOs: created lazily at their event sites
    "dgrep_daemon_failover_seconds": (
        "histogram", "Lease-stale detection to promoted-and-serving wall."),
    "dgrep_daemon_role": (
        "gauge", "Lease role of this daemon: 1 active, 0 deposed."),
    "dgrep_scale_actions_total": (
        "counter", "Elastic pool grow/drain actions applied."),
    "dgrep_maps_lost_output_total": (
        "counter", "Map tasks revoked after a lost peer shuffle output."),
    # query-result cache (runtime/result_cache.py): created lazily at
    # the planning event site
    "dgrep_result_hits_total": (
        "counter", "Jobs answered wholly from the result cache."),
    "dgrep_result_partial_hits_total": (
        "counter", "Jobs answered by incremental re-query (partial hit)."),
    "dgrep_result_splits_reused_total": (
        "counter", "Map splits served from stored results, no scan."),
    "dgrep_result_bytes_unscanned_total": (
        "counter", "Input bytes the result cache kept unscanned."),
}


def _fmt(v: float) -> str:
    """Deterministic Prometheus sample rendering: integral values as
    integers, everything else via repr (shortest round-trip — stable for
    a given value, no locale, no trailing-zero drift)."""
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class MetricCounter:
    """Monotonic counter.  One leaf lock; never-touched reads are
    lock-free (the `_touched` convention — render skips the lock when
    nothing was ever recorded)."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = lockdep.make_lock("metric-series")
        self._v = 0.0
        self._touched = False

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self._v += v
            self._touched = True

    def value(self) -> float:
        if not self._touched:
            return 0.0
        with self._lock:
            return self._v

    def reset(self) -> None:
        with self._lock:
            self._v = 0.0
            self._touched = False

    def render(self) -> list[str]:
        return [f"{self.name} {_fmt(self.value())}"]


class Gauge(MetricCounter):
    """Point-in-time value; set() replaces, inc() adjusts."""

    kind = "gauge"

    def set(self, v: float) -> None:
        with self._lock:
            self._v = float(v)
            self._touched = True


class Histogram:
    """Fixed-bucket histogram (log-spaced defaults).  Cumulative bucket
    counts follow the Prometheus exposition contract; `quantile()` gives
    the /status p50/p95 summary by linear interpolation inside the
    landing bucket."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: tuple[float, ...] = DEFAULT_BUCKETS):
        self.name = name
        self.help = help
        self.buckets = tuple(sorted(buckets))
        self._lock = lockdep.make_lock("metric-series")
        self._counts = [0] * (len(self.buckets) + 1)  # last = +Inf
        self._sum = 0.0
        self._count = 0
        self._touched = False

    def observe(self, v: float) -> None:
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            self._touched = True

    def snapshot(self) -> tuple[list[int], float, int]:
        if not self._touched:
            return [0] * (len(self.buckets) + 1), 0.0, 0
        with self._lock:
            return list(self._counts), self._sum, self._count

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self.buckets) + 1)
            self._sum = 0.0
            self._count = 0
            self._touched = False

    def quantile(self, q: float) -> float | None:
        """Estimated q-quantile (0..1), or None when empty.  Linear
        interpolation between the landing bucket's edges; observations
        past the last finite edge clamp to it (the Prometheus
        histogram_quantile convention)."""
        counts, _sum, count = self.snapshot()
        if count == 0:
            return None
        target = q * count
        cum = 0.0
        for i, c in enumerate(counts):
            cum += c
            if cum >= target and c:
                if i >= len(self.buckets):
                    return self.buckets[-1]
                lo = 0.0 if i == 0 else self.buckets[i - 1]
                hi = self.buckets[i]
                frac = (target - (cum - c)) / c
                return lo + (hi - lo) * frac
        return self.buckets[-1]

    def render(self) -> list[str]:
        counts, total, count = self.snapshot()
        out: list[str] = []
        cum = 0
        for edge, c in zip(self.buckets, counts):
            cum += c
            out.append(
                f'{self.name}_bucket{{le="{_fmt(edge)}"}} {cum}'
            )
        cum += counts[-1]
        out.append(f'{self.name}_bucket{{le="+Inf"}} {cum}')
        out.append(f"{self.name}_sum {_fmt(total)}")
        out.append(f"{self.name}_count {count}")
        return out


_KINDS = {"counter": MetricCounter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Named instrument registry.  Instruments are created on first
    access (kind checked against the declaration table) and live for the
    process; `render()` is the byte-stable Prometheus text exposition
    (series sorted by name, sort order and float formatting fixed)."""

    def __init__(self, series: dict[str, tuple[str, str]] | None = None):
        self._lock = lockdep.make_lock("metric-registry")
        self._instruments: dict[str, object] = {}
        self._series = SERIES if series is None else series

    def _get(self, name: str, kind: str):
        inst = self._instruments.get(name)
        if inst is not None:
            if inst.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {inst.kind}, "
                    f"requested {kind}"
                )
            return inst
        decl = self._series.get(name)
        if decl is not None and decl[0] != kind:
            raise ValueError(
                f"metric {name!r} is declared {decl[0]} in SERIES, "
                f"requested {kind}"
            )
        help_line = decl[1] if decl is not None else ""
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = _KINDS[kind](
                    name, help=help_line
                )
        return inst

    def counter(self, name: str) -> MetricCounter:
        return self._get(name, "counter")

    def gauge(self, name: str) -> Gauge:
        return self._get(name, "gauge")

    def histogram(self, name: str) -> Histogram:
        return self._get(name, "histogram")

    def render(self) -> str:
        with self._lock:
            insts = sorted(self._instruments.items())
        lines: list[str] = []
        for name, inst in insts:
            if inst.help:
                lines.append(f"# HELP {name} {inst.help}")
            lines.append(f"# TYPE {name} {inst.kind}")
            lines.extend(inst.render())
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self) -> None:
        """Zero every instrument IN PLACE (test isolation): module-level
        instrument references stay valid — dropping them instead would
        silently detach callers from the rendered registry."""
        with self._lock:
            insts = list(self._instruments.values())
        for inst in insts:
            inst.reset()


_registry = MetricsRegistry()


def metrics_registry() -> MetricsRegistry:
    return _registry


def counter(name: str) -> MetricCounter:
    return _registry.counter(name)


def gauge(name: str) -> Gauge:
    return _registry.gauge(name)


def histogram(name: str) -> Histogram:
    return _registry.histogram(name)


def render_prometheus() -> str:
    """The default registry as Prometheus text exposition."""
    return _registry.render()


def metrics_reset() -> None:
    """Zero the default registry (per-test isolation)."""
    _registry.reset()


# ------------------------------------------------- rolling-window rates
class RateWindow:
    """Per-key rolling sums over coarse time buckets: add() folds a delta
    into the current bucket, total() sums the buckets still inside the
    window.  O(window/granularity) state per key; expired buckets drop on
    the next touch."""

    def __init__(self, window_s: float | None = None,
                 granularity_s: float = _WINDOW_GRANULARITY_S):
        self.window_s = (
            env_metrics_window_s() if window_s is None else float(window_s)
        )
        self.granularity_s = granularity_s
        self._lock = lockdep.make_lock("metric-window")
        self._buckets: dict[str, deque] = {}

    def _bucket(self, now: float) -> float:
        return now - (now % self.granularity_s)

    def add(self, key: str, v: float, now: float | None = None) -> None:
        now = time.monotonic() if now is None else now
        b = self._bucket(now)
        with self._lock:
            dq = self._buckets.setdefault(key, deque())
            if dq and dq[-1][0] == b:
                dq[-1][1] += v
            else:
                dq.append([b, v])
            floor = now - self.window_s
            while dq and dq[0][0] < floor:
                dq.popleft()

    def total(self, key: str, now: float | None = None) -> float:
        now = time.monotonic() if now is None else now
        floor = now - self.window_s
        with self._lock:
            dq = self._buckets.get(key)
            if not dq:
                return 0.0
            while dq and dq[0][0] < floor:
                dq.popleft()
            return float(sum(v for _, v in dq))

    def reset(self) -> None:
        with self._lock:
            self._buckets.clear()


class CounterDeltaTracker:
    """Monotonic counter streams -> windowed deltas, per SOURCE process.

    Sources report lifetime totals (the engine-cache counters on the
    heartbeat piggyback); the tracker keeps the HIGHEST-seen total per
    (source, name) and folds only the POSITIVE INCREASE into the rolling
    window.  The first report from a source is a BASELINE (delta 0) —
    a worker reconnecting under a fresh service-allocated id, or a daemon
    restart observing a long-lived worker, must not re-count history as
    fresh activity.  A report BELOW the baseline is ignored (the
    baseline is a running max): same-token sources are same-process by
    construction, so a lower reading can only be a stale/out-of-order
    snapshot — two worker loops' heartbeats, or a /metrics scrape racing
    a heartbeat — and lowering the baseline would re-count the gap on
    the next report (double-count); the cost is an undercount on the
    never-observed genuine-reset-behind-a-reused-key case, which is the
    safe direction.  Keying by the worker's PROC_TOKEN (not its service
    id) keeps N same-process worker loops — which all report the SAME
    module-global counters — counted once.  Bounded: least-recently-seen
    sources pruned past MAX_SOURCES.
    """

    MAX_SOURCES = 1024

    def __init__(self, names: tuple[str, ...],
                 window_s: float | None = None):
        self.names = tuple(names)
        self.window = RateWindow(window_s=window_s)
        self._lock = lockdep.make_lock("metric-deltas")
        self._last: dict[object, dict[str, float]] = {}
        self._seen: dict[object, float] = {}

    def observe(self, source: object, counters: dict,
                now: float | None = None) -> None:
        now = time.monotonic() if now is None else now
        deltas: list[tuple[str, float]] = []
        with self._lock:
            prev = self._last.get(source)
            fresh = prev is None
            if fresh:
                prev = self._last[source] = {}
            self._seen[source] = now
            for name in self.names:
                cur = counters.get(name)
                if cur is None:
                    continue
                cur = float(cur)
                last = prev.get(name)
                if last is None:
                    prev[name] = cur  # baseline
                elif cur > last:
                    prev[name] = cur
                    deltas.append((name, cur - last))
                # cur <= last: stale/out-of-order snapshot — keep the
                # running-max baseline (see the class docstring)
            if len(self._last) > self.MAX_SOURCES:
                for src in sorted(self._seen, key=self._seen.get)[
                    : len(self._last) - self.MAX_SOURCES
                ]:
                    self._last.pop(src, None)
                    self._seen.pop(src, None)
        for name, d in deltas:
            self.window.add(name, d, now=now)

    def window_totals(self, now: float | None = None) -> dict[str, float]:
        return {
            name: self.window.total(name, now=now) for name in self.names
        }

    def reset(self) -> None:
        with self._lock:
            self._last.clear()
            self._seen.clear()
        self.window.reset()
