"""The port's telemetry (utils/metrics.py, utils/spans.py, utils/trace.py,
utils/event_audit.py, the scheduler's event log, GET /metrics, and the
``status`` and ``trace-export`` subcommands) against the reference's, on
the same inputs made from a seed: byte-identical Prometheus text and
Chrome trace exports, equal histogram, rate-window and clock-sync
arithmetic, equal span-name multisets of a job's events.jsonl per task
kind, unchanged RPC payloads and mr-out bytes with the pipeline off.

Names the port does not emit, by design (ROADMAP.md "Accepted
differences"): ``cache:*`` (the compiled-model cache verdict, item 5),
``index:*`` (the shard index, item 3), ``device_demoted`` and
``device_recovered`` (the port has no host fallback to demote to)."""

from __future__ import annotations

import contextlib
import json
import re
import threading
import urllib.request
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from distributed_grep_tpu.utils import metrics as ref_metrics
from distributed_grep_tpu.utils import spans as ref_spans
from distributed_grep_tpu_torch.runtime import rpc
from distributed_grep_tpu_torch.utils import event_audit
from distributed_grep_tpu_torch.utils import metrics as port_metrics
from distributed_grep_tpu_torch.utils import spans as port_spans
from distributed_grep_tpu_torch.utils import trace
from distributed_grep_tpu_torch.utils.config import JobConfig

BOTH_METRICS = pytest.mark.parametrize(
    "mm", [port_metrics, ref_metrics], ids=["port", "reference"])
BOTH_SPANS = pytest.mark.parametrize(
    "sm", [port_spans, ref_spans], ids=["port", "reference"])

# event names the port lacks by design (module docstring)
NOT_IN_PORT = ("cache:", "index:", "device_demoted", "device_recovered")

PORT_GREP = "distributed_grep_tpu_torch.apps.grep_cuda"
REF_GREP = "distributed_grep_tpu.apps.grep_tpu"


@pytest.fixture(autouse=True)
def _fresh_port_metrics():
    port_metrics.metrics_reset()
    yield
    port_metrics.metrics_reset()


# ------------------------------------------------------------- metrics
def _drive_registry(mm, seed: int) -> str:
    """A seeded sequence of inc/observe/set on a fresh registry of the
    module's SERIES table; its Prometheus text."""
    rng = np.random.default_rng(seed)
    reg = mm.MetricsRegistry()
    names = sorted(mm.SERIES)
    for _ in range(300):
        name = names[int(rng.integers(len(names)))]
        kind = mm.SERIES[name][0]
        v = float(rng.choice([0.0005, 0.003, 0.5, 2.0, 7.25, 300.0,
                              float(rng.integers(0, 50))]))
        if kind == "counter":
            reg.counter(name).inc(v)
        elif kind == "gauge":
            reg.gauge(name).set(v) if rng.random() < 0.5 else \
                reg.gauge(name).inc(v)
        else:
            reg.histogram(name).observe(v)
    return reg.render()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prometheus_text_byte_identical_to_reference(seed):
    assert port_metrics.SERIES == ref_metrics.SERIES
    text = _drive_registry(port_metrics, seed)
    assert text == _drive_registry(ref_metrics, seed)
    assert "# TYPE" in text


def test_histogram_buckets_and_quantiles_equal_reference():
    rng = np.random.default_rng(7)
    obs = np.exp(rng.uniform(np.log(1e-4), np.log(1e3), 500)).tolist()
    hp = port_metrics.Histogram("dgrep_t_seconds", help="T.")
    hr = ref_metrics.Histogram("dgrep_t_seconds", help="T.")
    assert hp.quantile(0.5) is None and hr.quantile(0.5) is None
    for v in obs:
        hp.observe(v)
        hr.observe(v)
    assert hp.snapshot() == hr.snapshot()
    for q in (0.0, 0.1, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert hp.quantile(q) == hr.quantile(q)
    assert hp.render() == hr.render()


def test_rate_window_and_delta_tracker_equal_reference():
    rng = np.random.default_rng(3)
    wins = [m.RateWindow(window_s=100.0, granularity_s=10.0)
            for m in (port_metrics, ref_metrics)]
    trackers = [m.CounterDeltaTracker(("hits", "misses"), window_s=50.0)
                for m in (port_metrics, ref_metrics)]
    now = 0.0
    totals = {"hits": 0.0, "misses": 0.0}
    for _ in range(200):
        now += float(rng.uniform(0, 7))
        key = "hits" if rng.random() < 0.6 else "misses"
        v = float(rng.integers(0, 5))
        src = int(rng.integers(0, 3))
        totals[key] += v
        snap = {k: t - float(rng.integers(0, 3)) for k, t in totals.items()}
        for w in wins:
            w.add(key, v, now=now)
        for t in trackers:
            t.observe(src, snap, now=now)
        assert wins[0].total(key, now=now) == wins[1].total(key, now=now)
        assert (trackers[0].window_totals(now=now)
                == trackers[1].window_totals(now=now))


@BOTH_METRICS
def test_untouched_instruments_answer_lock_free(mm):
    class Exploding:
        def __enter__(self):
            raise AssertionError("lock taken on the untouched path")

        def __exit__(self, *a):
            return False

    c = mm.MetricCounter("dgrep_x_total")
    c._lock = Exploding()
    assert c.value() == 0.0
    h = mm.Histogram("dgrep_x_seconds")
    h._lock = Exploding()
    assert h.snapshot()[2] == 0 and h.quantile(0.5) is None


@BOTH_METRICS
def test_registry_kind_mismatch_raises(mm):
    series = {"dgrep_g": ("gauge", "G."), "dgrep_n_total": ("counter", "N.")}
    reg = mm.MetricsRegistry(series=series)
    reg.counter("dgrep_n_total")
    with pytest.raises(ValueError):
        reg.gauge("dgrep_n_total")
    with pytest.raises(ValueError):
        reg.histogram("dgrep_g")  # declared gauge


@BOTH_METRICS
def test_reset_zeroes_in_place(mm):
    reg = mm.MetricsRegistry(series={"dgrep_n_total": ("counter", "N.")})
    c = reg.counter("dgrep_n_total")
    c.inc(7)
    reg.reset()
    assert c.value() == 0.0
    c.inc(1)  # the same object still feeds the registry
    assert "dgrep_n_total 1" in reg.render()


@BOTH_METRICS
def test_instrument_concurrency_stress(mm):
    c = mm.MetricCounter("dgrep_s_total")
    h = mm.Histogram("dgrep_s_seconds")
    m = mm.Metrics()

    def work():
        for _ in range(1000):
            c.inc()
            h.observe(0.01)
            m.inc("ops")
            m.record_scan(1000, 0.0001)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.value() == 8000 and h.snapshot()[2] == 8000
    snap = m.snapshot()
    assert snap["counters"]["ops"] == 8000
    assert snap["counters"]["bytes_scanned"] == 8_000_000
    assert m.piggyback()["gbps"] > 0


# --------------------------------------------------------------- spans
@BOTH_SPANS
def test_span_buffer_bound_and_drop_report(sm):
    buf = sm.SpanBuffer(cap=4)
    names = ["corpus:hit", "corpus:miss", "map:read", "map:emit",
             "map:task", "scan:fdr", "scan:nfa"]
    for i, n in enumerate(names):
        buf.add({"t": "instant", "name": n, "ts": float(i)})
    assert len(buf) == 4 and buf.dropped == 3
    assert [r["name"] for r in buf.drain(limit=2)] == names[:2]
    rest = buf.drain()
    assert [r["name"] for r in rest[:-1]] == names[2:4]
    assert rest[-1]["name"] == "spans_dropped"
    assert rest[-1]["args"]["count"] == 3
    assert buf.dropped == 0 and buf.drain() == []
    assert buf.drain_batch() == (-1, [])


@BOTH_SPANS
def test_task_context_tags_nest_and_restore(sm):
    outer, inner = sm.SpanBuffer(), sm.SpanBuffer()
    assert not sm.active()
    with sm.task_context(outer, job="j", worker=3, task=7, attempt="a1",
                         kind="map"):
        with sm.span("map:read", cat="map", detail=1):
            pass
        with sm.task_context(inner, job="j", worker=3, task=8,
                             attempt="a2", kind="map"):
            sm.instant("corpus:miss", cat="engine")
        sm.complete("map:task", 1.0, 2.0, cat="map")
    assert not sm.active()
    recs = outer.drain()
    assert [r["name"] for r in recs] == ["map:read", "map:task"]
    assert all((r["task"], r["attempt"]) == (7, "a1") for r in recs)
    assert recs[0]["args"] == {"detail": 1} and recs[0]["dur"] >= 0
    (rec,) = inner.drain()
    assert (rec["name"], rec["task"], rec["t"]) == ("corpus:miss", 8,
                                                   "instant")


@BOTH_SPANS
def test_emitters_are_noops_outside_a_context(sm):
    sm.instant("corpus:hit")
    sm.scan_record("native", 10, 0.1)
    sm.complete("map:task", 0.0, 1.0)
    with sm.span("map:read"):
        pass
    assert isinstance(sm.span("x"), contextlib.AbstractContextManager)


def test_clock_sync_equals_reference():
    rng = np.random.default_rng(5)
    port, ref = port_spans.ClockSync(), ref_spans.ClockSync()
    for _ in range(100):
        wid = int(rng.integers(-1, 4))
        sent = float(rng.choice([0.0, rng.uniform(1e9, 1e9 + 100)]))
        recv = sent + float(rng.uniform(-2, 5))
        rtt = float(rng.choice([-1.0, 0.0, rng.uniform(0, 0.3)]))
        assert port.observe(wid, sent, recv, rtt) == ref.observe(
            wid, sent, recv, rtt)
    assert port.offsets == ref.offsets and port.rtts == ref.rtts


def _seeded_events(seed: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    names = ["map:task", "map:read", "scan:shift_and", "reduce:task",
             "assign_map", "map_committed", "corpus:hit"]
    out: list[dict] = []
    for i in range(60):
        w = int(rng.integers(-1, 3))
        rec = {"t": str(rng.choice(["span", "instant"])),
               "name": str(rng.choice(names)), "cat": "map",
               "ts": 1.7e9 + float(rng.uniform(0, 10)), "task": i % 5,
               "attempt": f"a{i}", "job": "j"}
        if w >= 0:
            rec["worker"] = w
        if rec["t"] == "span":
            rec["dur"] = float(rng.uniform(-0.1, 2))
        if rng.random() < 0.5:
            rec["args"] = {"bytes": int(rng.integers(0, 1 << 20))}
        out.append(rec)
        if rng.random() < 0.1 and w >= 0:
            out.append({"t": "worker_clock", "worker": w,
                        "offset_s": float(rng.uniform(-1, 1)),
                        "rtt_s": 0.01, "ts": 1.7e9})
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_chrome_and_fleet_exports_byte_identical(seed):
    events = _seeded_events(seed)
    doc = port_spans.export_chrome_trace(events)
    assert json.dumps(doc) == json.dumps(ref_spans.export_chrome_trace(events))
    daemon = [{"kind": k, "epoch": e, "ts": 1.7e9 + t, "pid": 10 + e,
               "role": "active", "payload": {"n": t}}
              for t, (k, e) in enumerate([("start", 1), ("lease_steal", 2),
                                          ("promoted", 2), ("stop", 1)])]
    jobs = {"j1": events[:20], "j0": events[20:]}
    assert json.dumps(port_spans.export_fleet_trace(daemon, jobs)) == \
        json.dumps(ref_spans.export_fleet_trace(daemon, jobs))


def test_span_batch_retry_is_persisted_once(tmp_path):
    """An RPC retry reships the same (worker, seq) batch: the scheduler
    persists it once."""
    from distributed_grep_tpu_torch.runtime.scheduler import Scheduler

    buf = port_spans.SpanBuffer()
    buf.add({"t": "instant", "name": "corpus:hit", "ts": 1.0, "worker": 0})
    seq, batch = buf.drain_batch()
    assert seq == 1 and len(batch) == 1
    log_path = tmp_path / "events.jsonl"
    s = Scheduler(files=["a"], n_reduce=1,
                  event_log=port_spans.EventLog(log_path))
    try:
        args = rpc.HeartbeatArgs(task_type="map", task_id=0, worker_id=0,
                                 spans=batch, spans_seq=seq, sent_at=1.0)
        s.heartbeat("map", 0, args=args)
        s.heartbeat("map", 0, args=args)  # the retry
        fin = rpc.TaskFinishedArgs(task_id=0, worker_id=0, spans=batch,
                                   spans_seq=seq)
        s.map_finished(fin)
        hits = [e for e in port_spans.EventLog.read(log_path)
                if e.get("name") == "corpus:hit"]
        assert len(hits) == 1
        assert s.worker_status()["0"]["clock_offset_s"] > 0
    finally:
        s.stop()


def test_engine_scan_records_carry_the_stats():
    from distributed_grep_tpu_torch.ops.engine import GrepEngine

    data = b"hay\nneedle here\nhay\n" * 50
    for kw in ({"backend": "cpu"}, {}):
        eng = GrepEngine("needle", device="cpu", **kw)
        buf = port_spans.SpanBuffer()
        with port_spans.task_context(buf, job="j", worker=0, task=0,
                                     attempt="a", kind="map"):
            eng.scan(data)
        (rec,) = [r for r in buf.drain() if r["name"].startswith("scan:")]
        assert rec["name"] == f"scan:{eng.mode}" and rec["cat"] == "engine"
        assert rec["args"]["bytes"] == len(data)
        assert rec["args"]["matches"] == 50
        assert rec["args"]["device_fallback"] is False
    assert eng.scan(b"needle\n").n_matches == 1  # no context: no record


# ------------------------------------------------- whole jobs, spans on
def _word_files(tmp_path, n: int = 4) -> list[str]:
    rng = np.random.default_rng(11)
    vocab = ["the", "hello", "needle", "fox", "ash", "lava", "x"]
    files = []
    for i in range(n):
        p = tmp_path / "in" / f"w{i}.txt"
        p.parent.mkdir(exist_ok=True)
        p.write_text("\n".join(" ".join(rng.choice(vocab, rng.integers(0, 6)))
                               for _ in range(200 + 40 * i)) + "\n")
        files.append(str(p))
    return files


def _by_kind(events: list[dict], modeless: bool = False) -> dict:
    """(name, cat) multisets per task kind ("" for the coordinator row),
    less the names the port lacks by design; ``modeless`` folds each
    ``scan:<mode>`` into ``scan:*``."""
    out: dict[str, Counter] = {}
    for e in events:
        name = e.get("name")
        if e.get("t") not in ("span", "instant") or name.startswith(
                NOT_IN_PORT):
            continue
        if modeless and name.startswith("scan:") and name != "scan:batch":
            name = "scan:*"
        out.setdefault(e.get("kind", ""), Counter())[
            (name, e.get("cat"), e["t"])] += 1
    return out


def _mr_out(paths) -> dict:
    return {Path(p).name: Path(p).read_bytes() for p in paths}


@pytest.mark.parametrize("backend", ["cpu", "device"])
@pytest.mark.parametrize("batch", [0, 1 << 20], ids=["solo", "batched"])
def test_local_job_span_multiset_equals_reference(tmp_path, backend, batch):
    """The same job through the reference (grep_tpu, backend cpu) and the
    port (grep_cuda, device cpu; on the host backend, or on the plain
    versions of the kernels, whose scan records name their mode): equal
    event multisets per task kind, and the same mr-out bytes with spans
    on and off."""
    from distributed_grep_tpu.runtime.job import run_job as ref_run_job
    from distributed_grep_tpu.utils.config import JobConfig as RefJobConfig
    from distributed_grep_tpu_torch.runtime.job import run_job

    files = _word_files(tmp_path)
    common = dict(input_files=files, n_reduce=3, batch_bytes=batch,
                  spans=True, job_id="e2e")
    ref = ref_run_job(RefJobConfig(
        application=REF_GREP, work_dir=str(tmp_path / "ref"),
        app_options={"pattern": "needle", "backend": "cpu"}, **common),
        n_workers=2)
    event_audit.activate()
    event_audit.reset()
    try:
        port = run_job(JobConfig(
            application=PORT_GREP, work_dir=str(tmp_path / "port"),
            app_options={"pattern": "needle", "device": "cpu",
                         "backend": backend}, **common), n_workers=2)
        assert event_audit.findings() == []
    finally:
        event_audit.deactivate()
        event_audit.reset()
    off = run_job(JobConfig(
        application=PORT_GREP, work_dir=str(tmp_path / "off"),
        app_options={"pattern": "needle", "device": "cpu",
                     "backend": backend},
        **{**common, "spans": False}), n_workers=2)
    assert _mr_out(port.output_files) == _mr_out(ref.output_files)
    assert _mr_out(off.output_files) == _mr_out(port.output_files)
    assert not (tmp_path / "off" / "events.jsonl").exists()
    got = port_spans.EventLog.read(tmp_path / "port" / "events.jsonl")
    want = ref_spans.EventLog.read(tmp_path / "ref" / "events.jsonl")
    modeless = backend == "device"
    assert _by_kind(got, modeless) == _by_kind(want, modeless)
    for e in got:
        if e.get("name") == "map:task":
            assert e["job"] == "e2e" and e["worker"] >= 0 and e["attempt"]
    scans = [e for e in got if e.get("name", "").startswith("scan:")
             and e["name"] != "scan:batch"]
    # every file ends in a newline: a packed window adds no byte
    assert sum(e["args"]["bytes"] for e in scans) == sum(
        Path(f).stat().st_size for f in files)


def _raise_killed():
    from distributed_grep_tpu_torch.runtime.worker import WorkerKilled

    raise WorkerKilled()


def test_http_job_with_a_killed_worker(tmp_path, corpus):
    """The reference's acceptance case on the port: worker 0 dies after
    reading its first split; the survivor re-runs it after the timeout
    sweep.  events.jsonl covers both attempts, the re-run lands on the
    survivor's row, /status shows the survivor's shipped metrics, and
    trace-export renders it all."""
    from distributed_grep_tpu_torch.__main__ import main
    from distributed_grep_tpu_torch.apps.loader import load_application
    from distributed_grep_tpu_torch.runtime.http_coordinator import (
        CoordinatorServer,
    )
    from distributed_grep_tpu_torch.runtime.http_transport import (
        HttpTransport,
    )
    from distributed_grep_tpu_torch.runtime.worker import (
        WorkerKilled,
        WorkerLoop,
    )

    cfg = JobConfig(
        input_files=[str(p) for p in corpus.values()],
        application="distributed_grep_tpu_torch.apps.grep",
        app_options={"pattern": "hello"}, n_reduce=2,
        work_dir=str(tmp_path / "job"), coordinator_port=0,
        task_timeout_s=1.0, sweep_interval_s=0.1, spans=True,
        job_id="http-e2e")
    server = CoordinatorServer(cfg)
    server.start()
    addr = f"127.0.0.1:{server.port}"
    app = load_application(cfg.application, pattern="hello")

    def dying():
        loop = WorkerLoop(HttpTransport(addr), app, spans_enabled=True,
                          job_id="http-e2e",
                          fault_hooks={"after_map_read": _raise_killed})
        with contextlib.suppress(WorkerKilled):
            loop.run()

    t1 = threading.Thread(target=dying)
    t1.start()
    t1.join(timeout=10.0)
    survivor = WorkerLoop(HttpTransport(addr), app, spans_enabled=True,
                          job_id="http-e2e")
    t2 = threading.Thread(target=survivor.run)
    t2.start()
    try:
        assert server.wait_done(timeout=30.0)
        status = server.status()
        metrics_text = urllib.request.urlopen(
            f"http://{addr}/metrics", timeout=10).read().decode()
    finally:
        t2.join(timeout=10.0)
        server.shutdown(linger_s=0.1)
    events = port_spans.EventLog.read(tmp_path / "job" / "events.jsonl")
    assigns = [e for e in events if e.get("name") == "assign_map"]
    assert len(assigns) > len(corpus)
    retried = [e for e in assigns if e["args"]["attempt"] >= 2]
    assert retried and any(e.get("name") == "task_timeout" for e in events)
    task = retried[0]["args"]["task"]
    retask = [e for e in events
              if e.get("name") == "map:task" and e.get("task") == task]
    assert retask and retask[-1]["worker"] == survivor.worker_id
    row = status["workers"][str(survivor.worker_id)]
    assert row["metrics"]["bytes_scanned"] > 0 and row["metrics"]["gbps"] > 0
    assert "proc" not in row["metrics"]
    requeued = re.search(r"^dgrep_tasks_requeued_total (\d+)$", metrics_text,
                         re.M)
    assert requeued and int(requeued.group(1)) >= 1
    assert "dgrep_map_phase_seconds_count 1" in metrics_text
    assert "dgrep_reduce_phase_seconds_count 1" in metrics_text
    out = tmp_path / "trace.json"
    assert main(["trace-export", str(tmp_path / "job"), "-o", str(out)]) == 0
    evs = json.loads(out.read_text())["traceEvents"]
    names = {(ev["name"], ev["tid"]) for ev in evs}
    assert ("assign_map", 0) in names and ("task_timeout", 0) in names
    tids = [ev["tid"] for ev in evs if ev["name"] == "map:task"
            and ev["args"].get("task") == task]
    assert tids[-1] == survivor.worker_id + 1
    rows = {ev["args"]["name"] for ev in evs
            if ev["ph"] == "M" and ev["name"] == "thread_name"}
    assert {"coordinator", f"worker {survivor.worker_id}"} <= rows


# ------------------------------------------------------- pipeline off
def test_rpc_payloads_unchanged_with_the_pipeline_off():
    """Off, no RPC carries a new field: the key sets are the ones the port
    sent before the pipeline existed."""
    from distributed_grep_tpu_torch.runtime.worker import WorkerLoop

    hb = rpc.to_dict(rpc.HeartbeatArgs(task_type="map", task_id=1,
                                       worker_id=0, grace_s=2.0))
    assert set(hb) == {"task_type", "task_id", "worker_id", "grace_s"}
    fin = rpc.to_dict(rpc.TaskFinishedArgs(task_id=1, worker_id=0,
                                           produced_parts=[0, 1]))
    assert set(fin) == {"task_id", "worker_id", "produced_parts"}
    sent = []

    class Transport:
        is_local = True

        def heartbeat(self, args):
            sent.append(rpc.to_dict(args))

    for on in (False, True):
        loop = WorkerLoop(Transport(), None, spans_enabled=on)
        loop.worker_id = 0
        loop._heartbeat("map", 1)
        fin = loop._finished(rpc.TaskFinishedArgs(
            task_id=1, worker_id=0, metrics={"counters": {}, "seconds": {}}))
        if not on:
            assert set(sent[-1]) == {"task_type", "task_id", "worker_id",
                                     "grace_s"}
            assert set(rpc.to_dict(fin)) == {"task_id", "worker_id",
                                             "produced_parts", "metrics"}
            assert set(fin.metrics) == {"counters", "seconds"}
        else:
            assert {"metrics", "sent_at"} <= set(sent[-1])
            assert sent[-1]["metrics"]["proc"] == port_metrics.PROC_TOKEN
            assert "piggyback" in fin.metrics
    # the port's job config: the bootstrap bytes keep their shape
    assert not {"spans", "mesh_shape", "mesh_axes"} & set(
        json.loads(JobConfig().to_json()))
    assert json.loads(JobConfig(spans=True).to_json())["spans"] is True


def test_pipeline_off_writes_no_log_and_starts_no_profiler(tmp_path,
                                                           monkeypatch):
    import torch

    from distributed_grep_tpu_torch.runtime.job import run_job

    def no_profiler(*_a, **_k):
        raise AssertionError("a profiler was started with tracing off")

    monkeypatch.delenv("DGREP_SPANS", raising=False)
    monkeypatch.delenv("DGREP_TRACE_DIR", raising=False)
    monkeypatch.setattr(torch.profiler, "profile", no_profiler)
    res = run_job(JobConfig(input_files=_word_files(tmp_path, 2), n_reduce=2,
                            work_dir=str(tmp_path / "w"),
                            app_options={"pattern": "needle",
                                         "device": "cpu"}), n_workers=2)
    assert sum(1 for _ in res.iter_results())
    assert not (tmp_path / "w" / "events.jsonl").exists()
    assert isinstance(trace.annotate("x"), contextlib.nullcontext)
    with trace.job_trace() as path:
        assert path is None


# --------------------------------------------------------------- trace
def test_cpu_job_trace_holds_the_task_regions(tmp_path, monkeypatch):
    """Under DGREP_TRACE_DIR a job writes a Chrome trace of this process
    whose regions are the worker's, named as the reference names them
    (recorded from the worker threads)."""
    import os

    from distributed_grep_tpu_torch.runtime.job import run_job

    monkeypatch.setenv("DGREP_TRACE_DIR", str(tmp_path / "trace"))
    run_job(JobConfig(input_files=_word_files(tmp_path, 2), n_reduce=2,
                      work_dir=str(tmp_path / "w"),
                      app_options={"pattern": "needle", "device": "cpu"}),
            n_workers=2)
    (path,) = (tmp_path / "trace").glob(f"trace-{os.getpid()}-*.json")
    names = {ev.get("name") for ev in json.loads(path.read_text())[
        "traceEvents"]}
    for want in ("map_read:0", "map_compute:0", "map_read:1",
                 "map_compute:1", "reduce_compute:0", "reduce_compute:1"):
        assert want in names
    with trace.step_trace("scan", 3), trace.annotate("x"):
        pass


# ----------------------------------------------------------------- CLI
def test_trace_export_cli_byte_identical_to_reference(tmp_path, capsys):
    from distributed_grep_tpu.__main__ import main as ref_main
    from distributed_grep_tpu_torch.__main__ import main

    path = tmp_path / "events.jsonl"
    log = port_spans.EventLog(path, fresh=True)
    log.write_many(_seeded_events(9))
    log.close()
    assert ref_main(["trace-export", str(path)]) == 0
    want = capsys.readouterr().out
    assert main(["trace-export", str(tmp_path)]) == 0
    assert capsys.readouterr().out == want
    assert main(["trace-export", str(path), "-o",
                 str(tmp_path / "t.json")]) == 0
    assert (tmp_path / "t.json").read_text() + "\n" == want
    # a missing log exits as the reference's does; --fleet is not ported
    empty = tmp_path / "none"
    empty.mkdir()
    assert main(["trace-export", str(empty)]) == 2
    assert ref_main(["trace-export", str(empty)]) == 2
    assert main(["trace-export", "--fleet", str(empty)]) == 2
    assert "item 8, slice 3" in capsys.readouterr().err


def test_status_cli_has_the_reference_keys(tmp_path, corpus, capsys):
    """``status --addr`` against each package's live coordinator: the
    port's answer holds every key of the reference's (the port adds its
    counters, RPC and data-plane tables), with the same task-state
    shapes; an address with nobody there exits 2 in both."""
    from distributed_grep_tpu.__main__ import main as ref_main
    from distributed_grep_tpu.runtime.http_coordinator import (
        CoordinatorServer as RefServer,
    )
    from distributed_grep_tpu.utils.config import JobConfig as RefJobConfig
    from distributed_grep_tpu_torch.__main__ import main
    from distributed_grep_tpu_torch.runtime.http_coordinator import (
        CoordinatorServer,
    )
    from distributed_grep_tpu_torch.runtime.http_transport import (
        HttpTransport,
    )

    kw = dict(input_files=[str(p) for p in corpus.values()], n_reduce=2,
              coordinator_port=0, task_timeout_s=60.0)
    port = CoordinatorServer(JobConfig(
        application="distributed_grep_tpu_torch.apps.grep",
        app_options={"pattern": "hello"}, work_dir=str(tmp_path / "p"), **kw))
    ref = RefServer(RefJobConfig(
        application="distributed_grep_tpu.apps.grep",
        app_options={"pattern": "hello"}, work_dir=str(tmp_path / "r"), **kw))
    answers = []
    for server, cli in ((port, main), (ref, ref_main)):
        server.start()
        try:
            t = HttpTransport(f"127.0.0.1:{server.port}")
            a = t.assign_task(rpc.AssignTaskArgs())
            t.heartbeat(rpc.HeartbeatArgs(task_type="map", task_id=a.task_id,
                                          worker_id=a.worker_id,
                                          grace_s=30.0))
            assert cli(["status", "--addr",
                        f"127.0.0.1:{server.port}"]) == 0
            answers.append(json.loads(capsys.readouterr().out))
        finally:
            server.shutdown(linger_s=0.0)
    got, want = answers
    assert set(want) <= set(got)
    for k in ("map", "reduce"):
        assert got[k] == want[k]
    assert set(want["in_flight"][0]) <= set(got["in_flight"][0])
    assert set(got["workers"]["0"]) == set(want["workers"]["0"])
    assert got["workers"]["0"]["task"] == want["workers"]["0"]["task"]
    dead = f"127.0.0.1:{port.port}"
    assert main(["status", "--addr", dead, "--timeout", "1"]) == 2
    assert ref_main(["status", "--addr", dead, "--timeout", "1"]) == 2


def test_coordinator_metrics_endpoint_counts_the_job(tmp_path, corpus):
    """GET /metrics serves the reference's coordinator series, and after a
    job their counts agree with it: one map and one reduce phase, an
    assign poll per answered AssignTask, no re-issue."""
    from distributed_grep_tpu_torch.apps.loader import load_application
    from distributed_grep_tpu_torch.runtime.http_coordinator import (
        CoordinatorServer,
    )
    from distributed_grep_tpu_torch.runtime.http_transport import (
        HttpTransport,
    )
    from distributed_grep_tpu_torch.runtime.worker import WorkerLoop

    server = CoordinatorServer(JobConfig(
        input_files=[str(p) for p in corpus.values()],
        application="distributed_grep_tpu_torch.apps.grep",
        app_options={"pattern": "hello"}, n_reduce=2,
        work_dir=str(tmp_path / "job"), coordinator_port=0))
    server.start()
    addr = f"127.0.0.1:{server.port}"
    try:
        resp = urllib.request.urlopen(f"http://{addr}/metrics", timeout=10)
        assert resp.headers["Content-Type"].startswith("text/plain")
        text = resp.read().decode()
        for name in ("dgrep_assign_poll_seconds", "dgrep_map_phase_seconds",
                     "dgrep_reduce_phase_seconds"):
            assert f"# TYPE {name} histogram" in text
        app = load_application(server.config.application, pattern="hello")
        WorkerLoop(HttpTransport(addr), app).run()
        assert server.wait_done(10.0)
        st = server.status()
        text = urllib.request.urlopen(f"http://{addr}/metrics",
                                      timeout=10).read().decode()
    finally:
        server.shutdown(linger_s=0.0)
    assert "dgrep_map_phase_seconds_count 1" in text
    assert "dgrep_reduce_phase_seconds_count 1" in text
    polls = st["rpcs"]["AssignTask"]
    assert f"dgrep_assign_poll_seconds_count {polls}" in text
    assert "dgrep_map_task_seconds_count 3" in text
    assert "dgrep_tasks_requeued_total" in text
    assert "dgrep_tasks_requeued_total 0" in text
