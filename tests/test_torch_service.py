"""The port's service daemon (distributed_grep_tpu_torch/runtime/service.py,
the ``serve`` and ``submit`` subcommands, the cross-job engine cache of
ops/engine.py) held to the reference's (distributed_grep_tpu/runtime/
service.py, tests/test_service.py's cases).

The reference's daemon runs ``distributed_grep_tpu.apps.grep_tpu`` with
``backend: cpu``, the port's ``grep_cuda`` with ``device: cpu``; both run
with the result cache and the peer shuffle off here (the result cache has
tests/test_torch_result_cache.py, the peer shuffle
tests/test_torch_peer_shuffle.py).  The
tolerance is zero: the ``mr-out-*`` bytes, the states and the exit codes
are equal.  The elastic pool's advice equals the reference's on the same
scripted states, ``top``'s screen is the reference's, and a worker that
joins as its job ends (or as its daemon stops) exits at once (ROADMAP.md
C9).  Beyond the reference's cases: a ``worker --addr``
process serves two jobs through one attach, a registry the reference's
daemon wrote is replayed by the port's ``serve``, a job that asks for a
card that is not there fails naming it (and never runs on the host), and
a one-shot coordinator's wire carries none of the service's fields.

The ``cuda`` tests at the end need the card and skip without one:

    python -m pytest tests/test_torch_service.py -m cuda -q --noconftest
"""

from __future__ import annotations

import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from collections import Counter
from pathlib import Path

import pytest
import torch

from distributed_grep_tpu_torch.index import summary as index_summary
from distributed_grep_tpu_torch.ops import engine as engine_mod
from distributed_grep_tpu_torch.ops import layout
from distributed_grep_tpu_torch.runtime import rpc
from distributed_grep_tpu_torch.runtime.job import job_device, run_job
from distributed_grep_tpu_torch.runtime.service import (
    _MAX_TERMINAL_RECORDS,
    AdmissionError,
    GrepService,
    JobState,
    ServiceRegistry,
    ServiceServer,
    env_service_max_jobs,
    env_service_queue,
    env_service_resume,
)
from distributed_grep_tpu_torch.utils.config import JobConfig

REPO = Path(__file__).resolve().parents[1]
PORT_GREP = "distributed_grep_tpu_torch.apps.grep_cuda"
REF_GREP = "distributed_grep_tpu.apps.grep_tpu"


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """Empty caches and index per test; the reference's daemon with the
    tiers slice 3a does not port switched off."""
    monkeypatch.setenv("DGREP_RESULT_CACHE", "0")
    monkeypatch.setenv("DGREP_PEER_SHUFFLE", "0")
    monkeypatch.setenv("DGREP_NO_CALIBRATE", "1")
    for clear in (engine_mod.model_cache_clear, layout.corpus_cache_clear,
                  index_summary.clear):
        clear()
    yield
    for clear in (engine_mod.model_cache_clear, layout.corpus_cache_clear,
                  index_summary.clear):
        clear()


@pytest.fixture
def service(tmp_path):
    svc = GrepService(work_root=tmp_path / "svc", task_timeout_s=5.0,
                      sweep_interval_s=0.1)
    yield svc
    svc.stop()


def grep_config(corpus, pattern="hello", **kw) -> JobConfig:
    defaults = dict(input_files=[str(p) for p in corpus.values()],
                    application=PORT_GREP,
                    app_options={"pattern": pattern, "device": "cpu"},
                    n_reduce=3)
    defaults.update(kw)
    return JobConfig(**defaults)


def outputs_by_name(paths) -> dict[str, bytes]:
    return {Path(p).name: Path(p).read_bytes() for p in paths}


def ref_service_outputs(tmp_path, corpus, pattern: str, n_reduce: int = 3,
                        sub: str = "ref") -> dict[str, bytes]:
    """The reference's daemon over the same inputs: one job, its mr-out
    bytes."""
    from distributed_grep_tpu.runtime.service import GrepService as RefService
    from distributed_grep_tpu.utils.config import JobConfig as RefConfig

    svc = RefService(work_root=tmp_path / sub, task_timeout_s=5.0,
                     sweep_interval_s=0.1)
    try:
        svc.start_local_workers(2)
        jid = svc.submit(RefConfig(
            input_files=[str(p) for p in corpus.values()],
            application=REF_GREP,
            app_options={"pattern": pattern, "backend": "cpu"},
            n_reduce=n_reduce))
        assert svc.wait_job(jid, timeout=60), svc.job_status(jid)
        return outputs_by_name(svc.job_result(jid)["outputs"])
    finally:
        svc.stop()


def serial(tmp_path, corpus, pattern="hello", sub="serial", **kw):
    """The port's run_job of the same job: its mr-out bytes."""
    return outputs_by_name(run_job(
        grep_config(corpus, pattern=pattern, work_dir=str(tmp_path / sub),
                    **kw), n_workers=2).output_files)


# ------------------------------------------------------- the engine cache

def test_cached_engine_hit_returns_same_object():
    e1, v1 = engine_mod.cached_engine("needle", backend="cpu")
    e2, v2 = engine_mod.cached_engine("needle", backend="cpu")
    e3, v3 = engine_mod.cached_engine("other", backend="cpu")
    assert (v1, v2, v3) == ("miss", "hit", "miss")
    assert e1 is e2 and e1 is not e3
    c = engine_mod.model_cache_counters()
    assert c["compile_cache_hits"] == 1 and c["compile_cache_misses"] == 2


def test_cached_engine_disabled_by_env(monkeypatch):
    monkeypatch.setenv("DGREP_MODEL_CACHE", "0")
    e1, v1 = engine_mod.cached_engine("needle", backend="cpu")
    e2, v2 = engine_mod.cached_engine("needle", backend="cpu")
    assert v1 == v2 == "off" and e1 is not e2
    assert engine_mod.model_cache_counters() == {}


def test_cached_engine_lru_eviction(monkeypatch):
    monkeypatch.setenv("DGREP_MODEL_CACHE", "2")
    for p in ("p1", "p2", "p3"):  # p3 evicts p1, the least recent
        engine_mod.cached_engine(p, backend="cpu")
    assert engine_mod.model_cache_counters()["compile_cache_evictions"] == 1
    assert engine_mod.cached_engine("p3", backend="cpu")[1] == "hit"
    assert engine_mod.cached_engine("p1", backend="cpu")[1] == "miss"


class _Stub:
    """Stands in for GrepEngine: records its arguments (the port's engine
    takes no mesh or device list; those options still raise in grep_cuda,
    ROADMAP.md item 9)."""

    def __init__(self, pattern=None, **kw):
        self.kw = kw


def test_cached_engine_unhashable_args_bypass(monkeypatch):
    class Opaque:
        __hash__ = None

    monkeypatch.setattr(engine_mod, "GrepEngine", _Stub)
    e, v = engine_mod.cached_engine("needle", backend="cpu",
                                    device_min_bytes=1 << 20)
    assert v == "miss"
    e2, v2 = engine_mod.cached_engine("needle", backend="cpu",
                                      segment_bytes=Opaque())
    assert v2 == "off" and e2 is not e


def test_cached_engine_mesh_and_device_list_bypass(monkeypatch):
    """A mesh or a list of devices is never a key (an engine is tied to
    its devices); the symbolic devices="all" is, as in the reference."""
    monkeypatch.setattr(engine_mod, "GrepEngine", _Stub)
    for kw in ({"mesh": ("data", 2)}, {"devices": ["cuda:0", "cuda:1"]}):
        e, v = engine_mod.cached_engine("needle", **kw)
        e2, v2 = engine_mod.cached_engine("needle", **kw)
        assert v == v2 == "off" and e is not e2
    assert engine_mod.model_cache_counters() == {}
    assert engine_mod.cached_engine("needle", devices="all")[1] == "miss"


def test_invalidate_cached_engine_counts_eviction():
    e, _ = engine_mod.cached_engine("needle", backend="cpu")
    engine_mod.invalidate_cached_engine(e)
    assert engine_mod.model_cache_counters()["compile_cache_evictions"] == 1
    assert engine_mod.cached_engine("needle", backend="cpu")[1] == "miss"


def test_cache_counters_stamped_into_engine_stats():
    e, _ = engine_mod.cached_engine("needle", backend="cpu")
    engine_mod.cached_engine("needle", backend="cpu")
    e.scan(b"a needle in a haystack\n")
    assert e.stats["compile_cache_hits"] == 1
    assert e.stats["compile_cache_misses"] == 1


def test_cache_key_holds_the_device_and_the_env_knobs(monkeypatch):
    """A "cpu" engine is never served to a "cuda" caller (with no card the
    "cuda" build raises, naming it), and an engine knob read from the
    environment at build time is part of the key."""
    cpu, _ = engine_mod.cached_engine("needle", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        engine_mod.cached_engine("needle", device="cuda")
    monkeypatch.setenv("DGREP_DEVICE_MIN_BYTES", "0")
    again, v = engine_mod.cached_engine("needle", device="cpu")
    assert v == "miss" and again is not cpu and again.device_min_bytes == 0


# ------------------------------------------------------ the daemon itself

def test_late_reduce_attempt_on_terminal_job_aborts_not_done(
        tmp_path, corpus, service):
    service.start_local_workers(2)
    jid = service.submit(grep_config(corpus))
    assert service.wait_job(jid, timeout=60), service.job_status(jid)
    for job in (jid, "job-999"):  # a finished job, an unknown one
        reply = service.reduce_next_file(
            rpc.ReduceNextFileArgs(task_id=0, files_processed=1, job_id=job,
                                   worker_id=99), timeout=0.1)
        assert reply.abort and not reply.done


def test_c14_events_read_after_wait_job_hold_every_commit(tmp_path, corpus,
                                                         monkeypatch):
    """C14: the job reads as terminal only once the scheduler has written
    the events it staged for the last commit.  With the event write
    slowed, the job's events.jsonl and its trace-export, read right after
    ``wait_job``, hold one ``reduce_committed`` a reduce task."""
    from distributed_grep_tpu_torch.runtime import scheduler as sched_mod
    from distributed_grep_tpu_torch.utils import spans as spans_mod

    real = sched_mod.Scheduler._persist_spans

    def slow(self, recs, worker_id=-1, seq=-1):
        if any(r.get("name") == "reduce_committed" for r in recs):
            time.sleep(0.4)
        return real(self, recs, worker_id, seq)

    monkeypatch.setattr(sched_mod.Scheduler, "_persist_spans", slow)
    svc = GrepService(work_root=tmp_path / "svc", spans=True,
                      task_timeout_s=5.0, sweep_interval_s=0.1)
    try:
        svc.start_local_workers(2)
        jid = svc.submit(grep_config(corpus, n_reduce=4))
        assert svc.wait_job(jid, timeout=60)
        events = tmp_path / "svc" / jid / spans_mod.EventLog.FILENAME
        recs = [json.loads(ln) for ln in events.read_text().splitlines()]
        trace = spans_mod.export_chrome_trace(spans_mod.EventLog.read(events))
    finally:
        svc.stop()
    assert sum(r.get("name") == "reduce_committed" for r in recs) == 4
    assert sum(e.get("name") == "reduce_committed"
               for e in trace["traceEvents"]) == 4


def test_service_single_job_matches_run_job_and_the_reference(
        tmp_path, corpus, service):
    service.start_local_workers(2)
    jid = service.submit(grep_config(corpus))
    assert service.wait_job(jid, timeout=60), service.job_status(jid)
    res = service.job_result(jid)
    assert res["state"] == JobState.DONE
    got = outputs_by_name(res["outputs"])
    assert got == serial(tmp_path, corpus)
    assert got == ref_service_outputs(tmp_path, corpus, "hello")


def test_warm_resubmit_hits_cache_and_skips_rebuild(tmp_path, corpus,
                                                    monkeypatch):
    """The second submit of a pattern (another pattern between, so the
    app's same-config return cannot answer) builds no engine: the job's
    events.jsonl holds a ``cache:hit`` and the build count is unchanged;
    the outputs are the cold job's."""
    builds = []
    orig = engine_mod.GrepEngine.__init__

    def spying_init(self, *a, **kw):
        builds.append(a)
        return orig(self, *a, **kw)

    monkeypatch.setattr(engine_mod.GrepEngine, "__init__", spying_init)
    svc = GrepService(work_root=tmp_path / "svc", spans=True,
                      task_timeout_s=5.0, sweep_interval_s=0.1)
    try:
        svc.start_local_workers(1)  # one loop: no sibling warms the key
        j1 = svc.submit(grep_config(corpus, pattern="hello"))
        assert svc.wait_job(j1, timeout=60)
        j2 = svc.submit(grep_config(corpus, pattern="fox"))
        assert svc.wait_job(j2, timeout=60)
        built, hits = len(builds), engine_mod.model_cache_counters().get(
            "compile_cache_hits", 0)
        j3 = svc.submit(grep_config(corpus, pattern="hello"))
        assert svc.wait_job(j3, timeout=60)
        assert svc.job_result(j3)["state"] == JobState.DONE
        assert len(builds) == built
        assert engine_mod.model_cache_counters()["compile_cache_hits"] > hits
        names = [json.loads(ln).get("name") for ln in
                 (tmp_path / "svc" / j3 / "events.jsonl").read_text()
                 .splitlines()]
        assert "cache:hit" in names and "cache:miss" not in names
        assert outputs_by_name(svc.job_result(j1)["outputs"]) == \
            outputs_by_name(svc.job_result(j3)["outputs"])
    finally:
        svc.stop()


def test_concurrent_jobs_byte_identical_to_serial(tmp_path, corpus, service):
    service.start_local_workers(2)
    ja = service.submit(grep_config(corpus, pattern="hello"))
    jb = service.submit(grep_config(corpus, pattern="fox", n_reduce=2))
    assert service.wait_job(ja, timeout=60), service.job_status(ja)
    assert service.wait_job(jb, timeout=60), service.job_status(jb)
    assert outputs_by_name(service.job_result(ja)["outputs"]) == serial(
        tmp_path, corpus, "hello", "sa")
    assert outputs_by_name(service.job_result(jb)["outputs"]) == serial(
        tmp_path, corpus, "fox", "sb", n_reduce=2)
    assert outputs_by_name(service.job_result(jb)["outputs"]) == \
        ref_service_outputs(tmp_path, corpus, "fox", n_reduce=2)


def test_worker_kill_mid_job_a_reexecutes_only_a(tmp_path, corpus,
                                                 monkeypatch):
    """A worker lost mid-job A while B runs: only A's attempt runs again
    (B has no retry), and both outputs are exact."""
    from distributed_grep_tpu_torch.runtime import worker as worker_mod
    from distributed_grep_tpu_torch.runtime.worker import WorkerKilled

    monkeypatch.setenv("DGREP_SERVICE_FUSE", "0")  # one task an attempt
    svc = GrepService(work_root=tmp_path / "svc", task_timeout_s=2.0,
                      sweep_interval_s=0.1)
    loops: dict[str, object] = {}
    lock = threading.Lock()
    killed = {"n": 0}

    def die_on_job_a_map():
        loop = loops.get(threading.current_thread().name)
        if loop is None or loop._rpc_job_id != "job-1":
            return
        with lock:
            if killed["n"]:
                return
            killed["n"] += 1
        raise WorkerKilled()

    orig_run = worker_mod.WorkerLoop.run

    def capturing_run(self):
        loops[threading.current_thread().name] = self
        return orig_run(self)

    monkeypatch.setattr(worker_mod.WorkerLoop, "run", capturing_run)
    try:
        svc.start_local_workers(2, fault_hooks_per_worker=[
            {"after_map_read": die_on_job_a_map}] * 2)
        ja = svc.submit(grep_config(corpus, pattern="hello"))
        jb = svc.submit(grep_config(corpus, pattern="fox"))
        assert ja == "job-1"
        assert svc.wait_job(ja, timeout=60), svc.job_status(ja)
        assert svc.wait_job(jb, timeout=60), svc.job_status(jb)
        assert killed["n"] == 1
        ca = svc.record(ja).metrics()["counters"]
        cb = svc.record(jb).metrics()["counters"]
        assert ca.get("map_retries", 0) >= 1
        assert cb.get("map_retries", 0) == 0 == cb.get("reduce_retries", 0)
        for jid, pat, sub in ((ja, "hello", "sa"), (jb, "fox", "sb")):
            got = outputs_by_name(svc.job_result(jid)["outputs"])
            assert got == serial(tmp_path, corpus, pat, sub)
            assert got == ref_service_outputs(tmp_path, corpus, pat,
                                              sub=f"ref-{sub}")
    finally:
        svc.stop()


def test_cancel_leaves_other_job_intact(tmp_path, corpus, service):
    ja = service.submit(grep_config(corpus, pattern="hello"))
    jb = service.submit(grep_config(corpus, pattern="fox"))
    assert service.cancel(ja) == JobState.CANCELLED
    service.start_local_workers(2)
    assert service.wait_job(jb, timeout=60), service.job_status(jb)
    assert service.job_status(ja)["state"] == JobState.CANCELLED
    with pytest.raises(RuntimeError):
        service.job_result(ja)
    got = outputs_by_name(service.job_result(jb)["outputs"])
    assert got == serial(tmp_path, corpus, "fox", "sb")
    assert got == ref_service_outputs(tmp_path, corpus, "fox")


def test_admission_control_rejects_beyond_queue(tmp_path, corpus):
    svc = GrepService(work_root=tmp_path / "svc", max_jobs=1, queue_depth=1)
    try:
        svc.submit(grep_config(corpus))  # the running slot (no workers)
        svc.submit(grep_config(corpus))  # the queued one
        with pytest.raises(AdmissionError):
            svc.submit(grep_config(corpus))
    finally:
        svc.stop()


def test_submit_rejects_unreadable_inputs(tmp_path, corpus, service):
    cfg = grep_config(corpus)
    cfg.input_files = [str(tmp_path / "no-such-file.txt")]
    with pytest.raises(ValueError):
        service.submit(cfg)


@pytest.mark.parametrize("env", [{}, {"DGREP_SERVICE_MAX_JOBS": "7",
                                      "DGREP_SERVICE_QUEUE": "3"},
                                 {"DGREP_SERVICE_MAX_JOBS": "bogus",
                                  "DGREP_SERVICE_QUEUE": "-2"},
                                 {"DGREP_SERVICE_MAX_JOBS": "0",
                                  "DGREP_SERVICE_QUEUE": "0"}])
def test_env_knobs_parse_as_the_reference(env, monkeypatch):
    from distributed_grep_tpu.runtime import service as ref

    for k in ("DGREP_SERVICE_MAX_JOBS", "DGREP_SERVICE_QUEUE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert env_service_max_jobs(5) == ref.env_service_max_jobs(5)
    assert env_service_queue(9) == ref.env_service_queue(9)
    monkeypatch.setenv("DGREP_MODEL_CACHE", "bogus")
    assert engine_mod.env_model_cache_entries(9) == 9


@pytest.mark.parametrize("raw", [None, "0", "false", "no", "1", "yes"])
def test_resume_env_knob_parses_as_the_reference(raw, monkeypatch):
    from distributed_grep_tpu.runtime import service as ref

    monkeypatch.delenv("DGREP_SERVICE_RESUME", raising=False)
    if raw is not None:
        monkeypatch.setenv("DGREP_SERVICE_RESUME", raw)
    assert env_service_resume() is ref.env_service_resume()


# ------------------------------------------------------------ HTTP surface

def _call(base, method, path, body=None):
    req = urllib.request.Request(f"{base}{path}", data=body, method=method)
    if body is not None:
        req.add_header("Content-Type", "application/json")
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def test_http_api_submit_status_result_and_telemetry(tmp_path, corpus):
    svc = GrepService(work_root=tmp_path / "svc", spans=True,
                      task_timeout_s=5.0, sweep_interval_s=0.1)
    server = ServiceServer(svc)
    server.start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        svc.start_local_workers(1)
        cfg = grep_config(corpus, spans=True)
        jid = _call(base, "POST", "/jobs", cfg.to_json().encode())["job_id"]
        assert svc.wait_job(jid, timeout=60)
        st = _call(base, "GET", f"/jobs/{jid}")
        assert st["state"] == JobState.DONE, st
        assert st["map"]["completed"] == st["map"]["total"] == len(corpus)
        assert _call(base, "GET", f"/jobs/{jid}/result")["outputs"]
        j2 = _call(base, "POST", "/jobs", grep_config(
            corpus, pattern="fox").to_json().encode())["job_id"]
        j3 = _call(base, "POST", "/jobs", cfg.to_json().encode())["job_id"]
        for j in (j2, j3):
            assert svc.wait_job(j, timeout=60)
        status = _call(base, "GET", "/status")
        assert status["service"] is True
        assert status["compile_cache"]["compile_cache_hits"] >= 1
        rows = list(status["workers"].values())
        assert rows and any("compile_cache_hits" in (r.get("metrics") or {})
                            for r in rows)
        from distributed_grep_tpu_torch.utils.spans import (
            EventLog,
            export_chrome_trace,
        )

        doc = export_chrome_trace(EventLog.read(
            tmp_path / "svc" / j3 / "events.jsonl"))
        assert any(e.get("name", "").startswith("cache:")
                   for e in doc["traceEvents"])
        metrics = urllib.request.urlopen(f"{base}/metrics").read().decode()
        done = re.search(r"^dgrep_jobs_done_total (\d+)", metrics, re.M)
        assert done and int(done.group(1)) >= 3  # the process's lifetime
        assert re.search(r"^dgrep_jobs_running 0$", metrics, re.M)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _call(base, "GET", "/jobs/job-999")
        assert ei.value.code == 404
        # the explain route answers 200 with the job's report; the stream
        # route answers 200 for a standing query and 409 for a batch job
        doc = _call(base, "GET", f"/jobs/{jid}/explain")
        assert doc["job_id"] == jid and doc["spans"] is True
        assert doc["routing"]["route"] == "device"
        with pytest.raises(urllib.error.HTTPError) as ei:
            _call(base, "GET", f"/jobs/{jid}/stream?cursor=0&timeout=0")
        assert ei.value.code == 409
        log = tmp_path / "standing.log"
        log.write_bytes(b"hello standing\n")
        fcfg = JobConfig(input_files=[str(log)], application=PORT_GREP,
                         app_options={"pattern": "hello", "device": "cpu"},
                         follow=True, follow_poll_s=0.05)
        fj = _call(base, "POST", "/jobs", fcfg.to_json().encode())["job_id"]
        page = _call(base, "GET", f"/jobs/{fj}/stream?cursor=0&timeout=10")
        assert [(r["line"], r["text"]) for r in page["records"]] == [
            (1, "hello standing")]
        assert _call(base, "POST", f"/jobs/{fj}/cancel")["state"] == \
            "cancelled"
        assert _call(base, "POST", f"/jobs/{jid}/cancel")["state"] == "done"
    finally:
        svc.stop()
        server.shutdown()


def test_http_admission_answers_429(tmp_path, corpus):
    svc = GrepService(work_root=tmp_path / "svc", max_jobs=1, queue_depth=0)
    server = ServiceServer(svc)
    server.start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        body = grep_config(corpus).to_json().encode()
        _call(base, "POST", "/jobs", body)  # the one running slot
        with pytest.raises(urllib.error.HTTPError) as ei:
            _call(base, "POST", "/jobs", body)
        assert ei.value.code == 429
        with pytest.raises(urllib.error.HTTPError) as ei:
            _call(base, "POST", "/jobs", b'{"n_reduce": 0}')
        assert ei.value.code == 400
    finally:
        svc.stop()
        server.shutdown()


def test_http_worker_attach_serves_service_jobs(tmp_path, corpus):
    """A ``worker --addr``-shaped attach (run_http_worker) finds the
    daemon, scopes its data plane by job, and serves two jobs through one
    attach."""
    from distributed_grep_tpu_torch.runtime.http_transport import (
        run_http_worker,
    )

    svc = GrepService(work_root=tmp_path / "svc", task_timeout_s=5.0,
                      sweep_interval_s=0.1)
    server = ServiceServer(svc)
    server.start()
    t = threading.Thread(target=run_http_worker,
                         kwargs={"addr": f"127.0.0.1:{server.port}"},
                         daemon=True)
    try:
        t.start()
        j1 = svc.submit(grep_config(corpus))
        j2 = svc.submit(grep_config(corpus, pattern="fox"))
        for jid, pat, sub in ((j1, "hello", "s1"), (j2, "fox", "s2")):
            assert svc.wait_job(jid, timeout=60), svc.job_status(jid)
            assert outputs_by_name(svc.job_result(jid)["outputs"]) == \
                serial(tmp_path, corpus, pat, sub)
        assert len(svc.status()["workers"]) == 1  # one attach
    finally:
        svc.stop()
        server.shutdown()
        t.join(timeout=15)
    assert not t.is_alive()


def test_worker_process_attach_serves_two_jobs(tmp_path, corpus):
    """A ``worker --addr`` process and no local worker: two jobs through
    its one attach, each the reference daemon's bytes; the daemon's stop
    ends the process with status 0."""
    svc = GrepService(work_root=tmp_path / "svc", task_timeout_s=30.0,
                      sweep_interval_s=0.1)
    server = ServiceServer(svc)
    server.start()
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_grep_tpu_torch", "worker",
         "--addr", f"127.0.0.1:{server.port}"], cwd=REPO,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    try:
        jobs = {pat: svc.submit(grep_config(corpus, pattern=pat))
                for pat in ("hello", "fox")}
        for pat, jid in jobs.items():
            assert svc.wait_job(jid, timeout=120), svc.job_status(jid)
            assert outputs_by_name(svc.job_result(jid)["outputs"]) == \
                ref_service_outputs(tmp_path, corpus, pat, sub=f"ref-{pat}")
        assert len(svc.status()["workers"]) == 1
    finally:
        svc.stop()
        server.shutdown()
        try:
            _, err = proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            _, err = proc.communicate()
    assert proc.returncode == 0, err.decode()[-2000:]


# --------------------------------------------------- restart and resume

def test_service_restart_preserves_history_and_id_counter(tmp_path, corpus):
    svc = GrepService(work_root=tmp_path / "svc", task_timeout_s=5.0,
                      sweep_interval_s=0.1)
    svc.start_local_workers(2)
    j1 = svc.submit(grep_config(corpus))
    assert svc.wait_job(j1, timeout=60), svc.job_status(j1)
    outs = outputs_by_name(svc.job_result(j1)["outputs"])
    svc.stop()
    svc2 = GrepService(work_root=tmp_path / "svc", task_timeout_s=5.0,
                       sweep_interval_s=0.1)
    try:
        assert svc2.job_status(j1)["state"] == JobState.DONE
        assert outputs_by_name(svc2.job_result(j1)["outputs"]) == outs
        j2 = svc2.submit(grep_config(corpus, pattern="fox"))
        assert j2 == "job-2"
        svc2.start_local_workers(1)
        assert svc2.wait_job(j2, timeout=60), svc2.job_status(j2)
    finally:
        svc2.stop()


def test_service_restart_resumes_mid_job_from_journal(tmp_path, corpus):
    """A daemon lost mid-job (abandoned, as a kill leaves it): a new one
    over the same work root resumes the job, its committed maps replayed
    as done, and the outputs are exact."""
    from distributed_grep_tpu_torch.runtime.worker import WorkerKilled

    svc_a = GrepService(work_root=tmp_path / "svc", task_timeout_s=5.0,
                        sweep_interval_s=0.1)
    reads = {"n": 0}

    def die_on_third_read():
        reads["n"] += 1
        if reads["n"] >= 3:
            raise WorkerKilled()

    svc_a.start_local_workers(1, fault_hooks_per_worker=[
        {"after_map_read": die_on_third_read}])
    j1 = svc_a.submit(grep_config(corpus))  # 3 files: 3 map tasks
    rec_a = svc_a.record(j1)
    deadline = time.monotonic() + 30
    while (rec_a.metrics()["counters"].get("map_completed", 0) < 2
           or reads["n"] < 3):
        assert time.monotonic() < deadline, rec_a.metrics()
        time.sleep(0.05)
    svc_b = GrepService(work_root=tmp_path / "svc", task_timeout_s=5.0,
                        sweep_interval_s=0.1)
    try:
        assert svc_b.job_status(j1)["state"] == JobState.RUNNING
        svc_b.start_local_workers(2)
        assert svc_b.wait_job(j1, timeout=60), svc_b.job_status(j1)
        assert svc_b.record(j1).metrics()["counters"].get(
            "map_assigned", 0) <= 1
        got = outputs_by_name(svc_b.job_result(j1)["outputs"])
        assert got == serial(tmp_path, corpus)
        assert got == ref_service_outputs(tmp_path, corpus, "hello")
    finally:
        svc_b.stop()


def test_service_restart_readmits_queued_jobs(tmp_path, corpus):
    svc_a = GrepService(work_root=tmp_path / "svc", max_jobs=1,
                        task_timeout_s=5.0, sweep_interval_s=0.1)
    j1 = svc_a.submit(grep_config(corpus))
    j2 = svc_a.submit(grep_config(corpus, pattern="fox"))
    assert svc_a.job_status(j2)["state"] == JobState.QUEUED
    svc_b = GrepService(work_root=tmp_path / "svc", task_timeout_s=5.0,
                        sweep_interval_s=0.1)
    try:
        assert svc_b.job_status(j1)["state"] == JobState.RUNNING
        assert svc_b.job_status(j2)["state"] in (JobState.RUNNING,
                                                 JobState.QUEUED)
        svc_b.start_local_workers(2)
        for jid, pat, sub in ((j1, "hello", "sa"), (j2, "fox", "sb")):
            assert svc_b.wait_job(jid, timeout=60), svc_b.job_status(jid)
            assert outputs_by_name(svc_b.job_result(jid)["outputs"]) == \
                serial(tmp_path, corpus, pat, sub)
    finally:
        svc_b.stop()


def test_service_resume_disabled_still_advances_ids(tmp_path, corpus):
    svc_a = GrepService(work_root=tmp_path / "svc")
    j1 = svc_a.submit(grep_config(corpus))
    svc_b = GrepService(work_root=tmp_path / "svc", resume=False)
    try:
        with pytest.raises(KeyError):
            svc_b.record(j1)
        assert svc_b.submit(grep_config(corpus, pattern="fox")) == "job-2"
    finally:
        svc_b.stop()


def test_registry_compaction_bounds_history_and_retires_ids(tmp_path,
                                                            corpus):
    root = tmp_path / "svc"
    root.mkdir()
    reg = ServiceRegistry(root)
    cfg = grep_config(corpus)
    n_hist = _MAX_TERMINAL_RECORDS + 40
    for i in range(1, n_hist + 1):
        reg.record_submit(f"job-{i}", cfg)
        reg.record_state(f"job-{i}", JobState.DONE, outputs=[])
    reg.close()
    size_before = (root / ServiceRegistry.FILENAME).stat().st_size
    svc = GrepService(work_root=root)
    try:
        assert len([r for r in svc._jobs.values()
                    if r.state == JobState.DONE]) == _MAX_TERMINAL_RECORDS
        assert (root / ServiceRegistry.FILENAME).stat().st_size < size_before
        assert svc.submit(grep_config(corpus)) == f"job-{n_hist + 1}"
        jobs, floor = ServiceRegistry.replay(root)
        assert floor >= n_hist + 2 and "job-1" not in jobs
    finally:
        svc.stop()


def test_resume_fails_job_whose_inputs_vanished(tmp_path, corpus):
    svc_a = GrepService(work_root=tmp_path / "svc")
    j1 = svc_a.submit(grep_config(corpus))
    Path(svc_a.record(j1).config.input_files[0]).unlink()
    svc_b = GrepService(work_root=tmp_path / "svc")
    try:
        st = svc_b.job_status(j1)
        assert st["state"] == JobState.FAILED and "unreadable" in st["error"]
    finally:
        svc_b.stop()


def _strip_times(lines: list[str]) -> list[dict]:
    out = []
    for ln in lines:
        d = json.loads(ln)
        d.pop("t", None)
        if "config" in d:
            d["config"] = {k: d["config"][k] for k in
                           ("input_files", "app_options", "n_reduce")}
        out.append(d)
    return out


def test_registry_lines_are_the_references(tmp_path, corpus):
    """The same events through both packages' ServiceRegistry give the
    same jobs.jsonl lines (keys, order, values; the times and the config
    fields only one JobConfig has aside), and each package replays the
    other's file to the same table."""
    from distributed_grep_tpu.runtime.service import (
        ServiceRegistry as RefRegistry,
    )
    from distributed_grep_tpu.utils.config import JobConfig as RefConfig

    files = [str(p) for p in corpus.values()]
    opts = {"pattern": "hello", "device": "cpu"}
    for pkg, reg_cls, cfg in (
            ("port", ServiceRegistry, JobConfig(input_files=files,
                                                app_options=opts)),
            ("ref", RefRegistry, RefConfig(input_files=files,
                                           application=PORT_GREP,
                                           app_options=opts))):
        root = tmp_path / pkg
        root.mkdir()
        reg = reg_cls(root)
        reg.record_submit("job-1", cfg)
        reg.record_state("job-1", "running")
        reg.record_state("job-1", "done", outputs=["a", "b"])
        reg.record_submit("job-2", cfg)
        reg.record_state("job-2", "failed", error="boom")
        reg.close()
    port_lines = (tmp_path / "port" / "jobs.jsonl").read_text().splitlines()
    ref_lines = (tmp_path / "ref" / "jobs.jsonl").read_text().splitlines()
    assert _strip_times(port_lines) == _strip_times(ref_lines)
    for root in (tmp_path / "port", tmp_path / "ref"):
        mine, floor = ServiceRegistry.replay(root)
        theirs, ref_floor = RefRegistry.replay(root)
        assert floor == ref_floor == 3
        assert {j: (v["state"], v["error"], v["outputs"])
                for j, v in mine.items()} == {
            j: (v["state"], v["error"], v["outputs"])
            for j, v in theirs.items()}


# ------------------------------------------------------- the shard index

def _index_corpus(tmp_path, n=8, needle_at=3) -> list[str]:
    paths = []
    for i in range(n):
        p = tmp_path / f"f{i}.txt"
        p.write_bytes(b"plain filler line\n" * 30
                      + (b"one needle line\n" if i == needle_at else b""))
        paths.append(str(p))
    return paths


def _index_job(svc, paths, pattern, **opts):
    jid = svc.submit(JobConfig(
        input_files=paths, application=PORT_GREP,
        app_options={"pattern": pattern, "device": "cpu", **opts},
        n_reduce=2, journal=False))
    assert svc.wait_job(jid, timeout=60), svc.job_status(jid)
    st = svc.job_status(jid)
    assert st["state"] == "done", st
    return st, b"".join(Path(p).read_bytes() for p in sorted(st["outputs"]))


def test_service_indexed_vs_off_byte_identity_and_restart(tmp_path,
                                                          monkeypatch):
    """The daemon's planner prunes the shards whose summaries rule the
    query out (no map task), the outputs equal the DGREP_INDEX=0 daemon's
    and the reference's daemon's, and a restarted daemon prunes from the
    persisted summaries without building one."""
    from distributed_grep_tpu.index import summary as ref_summary
    from distributed_grep_tpu.runtime.service import GrepService as RefService
    from distributed_grep_tpu.utils.config import JobConfig as RefConfig

    paths = _index_corpus(tmp_path)
    monkeypatch.setenv("DGREP_INDEX", "0")
    svc0 = GrepService(work_root=tmp_path / "svc0", task_timeout_s=30)
    svc0.start_local_workers(1)
    try:
        _, out_off = _index_job(svc0, paths, "needle")
        _, out_off_miss = _index_job(svc0, paths, "zzqqxx")
    finally:
        svc0.stop()
    assert "index" not in svc0.status()
    monkeypatch.delenv("DGREP_INDEX", raising=False)
    index_summary.clear()
    svc = GrepService(work_root=tmp_path / "svc", task_timeout_s=30)
    svc.start_local_workers(1)
    try:
        st_cold, out_cold = _index_job(svc, paths, "needle")
        st_warm, out_warm = _index_job(svc, paths, "needle")
        assert out_cold == out_warm == out_off
        assert st_warm["map"]["total"] < st_cold["map"]["total"]
        assert st_warm["metrics"]["counters"]["index_shards_pruned"] == 7
        _, out_miss = _index_job(svc, paths, "zzqqxx")
        assert out_miss == out_off_miss
        assert svc.status()["index"]["index_shards_pruned"] >= 7
    finally:
        svc.stop()
    index_summary.clear()
    svc2 = GrepService(work_root=tmp_path / "svc")
    svc2.start_local_workers(1)
    try:
        built0 = index_summary.index_counters().get("index_summaries_built",
                                                    0)
        st2, out2 = _index_job(svc2, paths, "needle")
        assert out2 == out_off
        assert st2["metrics"]["counters"]["index_shards_pruned"] == 7
        assert index_summary.index_counters().get(
            "index_summaries_built", 0) == built0
    finally:
        svc2.stop()
    ref_summary.clear()
    ref = RefService(work_root=tmp_path / "ref", task_timeout_s=30)
    ref.start_local_workers(1)
    try:
        for _ in range(2):  # cold, then pruned
            jid = ref.submit(RefConfig(
                input_files=paths, application=REF_GREP,
                app_options={"pattern": "needle", "backend": "cpu"},
                n_reduce=2, journal=False))
            assert ref.wait_job(jid, timeout=60)
            st = ref.job_status(jid)
            assert b"".join(Path(p).read_bytes()
                            for p in sorted(st["outputs"])) == out_off
        assert st["metrics"]["counters"]["index_shards_pruned"] == 7
    finally:
        ref.stop()
        ref_summary.clear()


def test_service_count_mode_not_planner_pruned(tmp_path):
    paths = _index_corpus(tmp_path, n=4, needle_at=1)
    svc = GrepService(work_root=tmp_path / "svc", task_timeout_s=30)
    svc.start_local_workers(1)
    try:
        _index_job(svc, paths, "needle")  # builds the summaries
        st, out = _index_job(svc, paths, "needle", count_only=True)
        assert st["map"]["total"] == len(paths)
        for p in paths:
            assert os.fsencode(p) in out
    finally:
        svc.stop()


# ------------------------------------------------ the one-shot contract

def test_one_shot_serve_coordinator_contract_unperturbed(tmp_path, corpus):
    """The one-shot coordinator still returns its status with the committed
    outputs, served to a plain HTTP worker loop."""
    import socket

    from distributed_grep_tpu_torch.apps.loader import load_application
    from distributed_grep_tpu_torch.runtime.http_coordinator import (
        serve_coordinator,
    )
    from distributed_grep_tpu_torch.runtime.http_transport import (
        HttpTransport,
    )
    from distributed_grep_tpu_torch.runtime.worker import WorkerLoop

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cfg = JobConfig(input_files=[str(p) for p in corpus.values()],
                    application="distributed_grep_tpu_torch.apps.grep",
                    app_options={"pattern": "hello"}, n_reduce=3,
                    work_dir=str(tmp_path / "job"), coordinator_port=port)
    app = load_application("distributed_grep_tpu_torch.apps.grep",
                           pattern="hello")
    result: dict = {}
    ct = threading.Thread(target=lambda: result.update(
        serve_coordinator(cfg)))
    ct.start()
    time.sleep(0.3)
    wt = threading.Thread(target=lambda: WorkerLoop(
        HttpTransport(f"127.0.0.1:{port}"), app).run())
    wt.start()
    ct.join(timeout=60)
    wt.join(timeout=15)
    assert not ct.is_alive()
    assert len(result["outputs"]) == 3 and result["done"] is True


def test_cmd_coordinator_stdout_one_json_line(tmp_path, corpus, capsys,
                                              monkeypatch):
    from distributed_grep_tpu_torch import __main__ as cli
    from distributed_grep_tpu_torch.runtime import http_coordinator as hc

    cfg_path = tmp_path / "job.json"
    cfg_path.write_text(JobConfig(
        input_files=[str(p) for p in corpus.values()],
        work_dir=str(tmp_path / "job")).to_json())
    monkeypatch.setattr(hc, "serve_coordinator", lambda config, resume=False:
                        {"outputs": ["a", "b"], "done": True})
    assert cli.main(["coordinator", "--config", str(cfg_path)]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1 and json.loads(lines[0]) == {"outputs": ["a", "b"]}


def test_one_shot_wire_carries_no_service_field(tmp_path, corpus):
    """A one-shot coordinator's AssignTaskReply JSON has no ``job_id`` or
    ``application`` key, and a one-shot worker's task RPCs no ``job_id``
    (the bytes they were before the service existed)."""
    from distributed_grep_tpu_torch.runtime.http_coordinator import (
        CoordinatorServer,
    )

    srv = CoordinatorServer(JobConfig(
        input_files=[str(p) for p in corpus.values()],
        app_options={"pattern": "hello", "device": "cpu"},
        work_dir=str(tmp_path / "h"), coordinator_port=0, n_reduce=2))
    srv.start()
    try:
        reply = _call(f"http://127.0.0.1:{srv.port}", "POST",
                      f"/rpc/{rpc.Verb.ASSIGN_TASK}", b"{}")
        assert reply["assignment"] == "map"
        assert "job_id" not in reply and "application" not in reply
    finally:
        srv.shutdown(linger_s=0.0)
    for msg in (rpc.TaskFinishedArgs(task_id=1, worker_id=0),
                rpc.ReduceNextFileArgs(task_id=0, files_processed=0),
                rpc.HeartbeatArgs(task_type="map", task_id=0)):
        assert "job_id" not in rpc.to_dict(msg)
    assert "job_id" in rpc.reply_to_dict(rpc.AssignTaskReply(job_id="job-1"))


def test_daemon_lock_discipline_under_lockdep(tmp_path, corpus):
    """The daemon's locks under utils/lockdep (the reference audits its
    service suite the same way): three tenants, fused, through the HTTP
    surface, a cancel and a stop record no lock-order inversion and no
    blocking call under a lock that is not io_ok."""
    from distributed_grep_tpu_torch.runtime.daemon_log import DaemonLog
    from distributed_grep_tpu_torch.utils import lockdep

    lockdep.activate()
    lockdep.reset()
    try:
        root = tmp_path / "svc"
        svc = GrepService(work_root=root, spans=True,
                          daemon_log=DaemonLog(root), task_timeout_s=5.0,
                          sweep_interval_s=0.1)
        server = ServiceServer(svc)
        server.start()
        try:
            jids = [svc.submit(grep_config(corpus, pattern=p))
                    for p in ("hello", "fox", "the")]
            svc.start_local_workers(2)
            for j in jids:
                assert svc.wait_job(j, timeout=60), svc.job_status(j)
            base = f"http://127.0.0.1:{server.port}"
            _call(base, "GET", "/status")
            urllib.request.urlopen(f"{base}/metrics").read()
            svc.cancel(jids[0])
        finally:
            server.shutdown()
            svc.stop()
        report = lockdep.report()
    finally:
        lockdep.deactivate()
        lockdep.reset()
    assert "service -> scheduler" in report["edges"]
    assert report["inversions"] == [] and report["blocking"] == []


def test_quarantine_expiry_reprobation_streak_resumes():
    from distributed_grep_tpu_torch.runtime.scheduler import (
        QUARANTINE_AFTER_FAILURES,
        WorkerHealth,
    )

    events = []
    h = WorkerHealth(base_s=0.1)
    h.on_event = lambda kind, **kw: events.append(kind)
    for i in range(QUARANTINE_AFTER_FAILURES - 1):
        assert h.record_failure(5) == 0.0, i
    assert h.record_failure(5) == pytest.approx(0.1)
    assert h.quarantine_remaining(5) > 0
    time.sleep(0.15)
    assert h.quarantine_remaining(5) == 0.0
    assert h.record_failure(5) == pytest.approx(0.2)
    time.sleep(0.25)
    assert h.quarantine_remaining(5) == 0.0
    h.record_success(5)
    for _ in range(QUARANTINE_AFTER_FAILURES - 1):
        assert h.record_failure(5) == 0.0
    assert h.record_failure(5) == pytest.approx(0.1)
    assert events == ["quarantine", "quarantine_expire", "quarantine",
                      "quarantine_expire", "quarantine_clear", "quarantine"]


# ----------------------------------------------------- the port's own

def _serve(root: Path, *extra: str) -> tuple[subprocess.Popen, int]:
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_grep_tpu_torch", "serve",
         "--work-root", str(root), "--port", "0", *extra],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    line = proc.stderr.readline().decode()
    assert "serving on" in line, line + proc.stderr.read().decode()
    return proc, int(line.split(":")[1].split()[0])


def test_serve_replays_a_registry_the_reference_wrote(tmp_path, corpus):
    """The reference's ServiceRegistry writes jobs.jsonl with a done job
    and a queued one, each naming the port's application; the port's
    ``serve`` keeps the history, advances the id counter past both, and
    re-admits the queued job, which completes with the reference's
    mr-out-* bytes."""
    from distributed_grep_tpu.runtime.service import (
        ServiceRegistry as RefRegistry,
    )
    from distributed_grep_tpu.utils.config import JobConfig as RefConfig

    root = tmp_path / "svc"
    root.mkdir()
    files = [str(p) for p in corpus.values()]
    reg = RefRegistry(root)
    reg.record_submit("job-1", RefConfig(
        input_files=files, application=PORT_GREP, n_reduce=3,
        app_options={"pattern": "hello", "device": "cpu"},
        work_dir=str(root / "job-1"), job_id="job-1"))
    reg.record_state("job-1", "running")
    reg.record_state("job-1", "done", outputs=["/x/mr-out-0"])
    reg.record_submit("job-2", RefConfig(
        input_files=files, application=PORT_GREP, n_reduce=3,
        app_options={"pattern": "fox", "device": "cpu"},
        work_dir=str(root / "job-2"), job_id="job-2"))
    reg.close()
    proc, port = _serve(root, "--workers", "1")
    base = f"http://127.0.0.1:{port}"
    try:
        assert _call(base, "GET", "/jobs/job-1")["outputs"] == ["/x/mr-out-0"]
        deadline = time.monotonic() + 60
        while _call(base, "GET", "/jobs/job-2")["state"] != "done":
            assert time.monotonic() < deadline
            time.sleep(0.1)
        got = outputs_by_name(_call(base, "GET",
                                    "/jobs/job-2/result")["outputs"])
        assert got == ref_service_outputs(tmp_path, corpus, "fox")
        out = subprocess.run(
            [sys.executable, "-m", "distributed_grep_tpu_torch", "submit",
             "--addr", f"127.0.0.1:{port}", "--backend", "cpu", "hello",
             *files], cwd=REPO, capture_output=True, timeout=120,
            env=dict(os.environ, PYTHONPATH=str(REPO)))
        assert out.returncode == 0, out.stderr
        doc = json.loads(out.stdout)
        assert doc["job_id"] == "job-3" and doc["state"] == "done"
    finally:
        proc.send_signal(signal.SIGTERM)
        stdout, _ = proc.communicate(timeout=60)
    assert proc.returncode == 0
    lines = stdout.decode().splitlines()
    assert len(lines) == 1
    final = json.loads(lines[0])
    assert final["jobs"]["job-2"]["state"] == "done"
    assert final["jobs"]["job-3"]["state"] == "done"


def test_no_host_fallback(tmp_path, corpus, monkeypatch, capsys):
    """With no card, a grep_cuda job with no device option ends failed
    naming the device (and no task of it ever runs), a word count on the
    same daemon ends done with collections.Counter's counts, and
    ``submit``'s PATTERN/FILE form with no --backend builds a job whose
    device is "cuda"."""
    from distributed_grep_tpu_torch import __main__ as cli
    from distributed_grep_tpu_torch.apps.loader import load_application

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    svc = GrepService(work_root=tmp_path / "svc", task_timeout_s=5.0,
                      sweep_interval_s=0.1)
    server = ServiceServer(svc)
    server.start()
    try:
        svc.start_local_workers(1)
        jg = svc.submit(JobConfig(input_files=[str(p) for p in
                                               corpus.values()],
                                  app_options={"pattern": "hello"}))
        jw = svc.submit(JobConfig(
            input_files=[str(p) for p in corpus.values()],
            application="distributed_grep_tpu_torch.apps.wordcount",
            n_reduce=2))
        for j in (jg, jw):
            assert svc.wait_job(j, timeout=60)
        st = svc.job_status(jg)
        assert st["state"] == "failed" and "'cuda'" in st["error"]
        assert "map" not in st  # no scheduler: nothing ran
        want = Counter()  # the word count's words: lowercased letter runs
        for p in corpus.values():
            want.update(re.findall(r"[a-z]+", p.read_text().lower()))
        got = {}
        for p in svc.job_result(jw)["outputs"]:
            for ln in Path(p).read_text().splitlines():
                k, v = ln.split("\t")
                got[k] = int(v)
        assert got == dict(want)
        rc = cli.main(["submit", "--addr", f"127.0.0.1:{server.port}",
                       "hello", *[str(p) for p in corpus.values()],
                       "--timeout", "60"])
        doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rc == 1 and doc["state"] == "failed" and "cuda" in doc["error"]
        cfg = svc.record(doc["job_id"]).config
        assert "backend" not in cfg.app_options
        assert job_device(load_application(cfg.application),
                          cfg.app_options) == "cuda"
    finally:
        svc.stop()
        server.shutdown()


def _serve_proc(root: Path, *args: str, env: dict | None = None
                ) -> tuple[subprocess.Popen, str]:
    """A ``serve`` process on a free port; (process, address) once its
    stderr names the address (serving or standing by)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_grep_tpu_torch", "serve",
         "--port", "0", "--workers", "0", "--work-root", str(root), *args],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env={**os.environ, **(env or {})})
    line = proc.stderr.readline().decode()
    m = re.search(r"(?:serving|standby) on (\S+:\d+)", line)
    assert m, line
    return proc, m.group(1)


def test_serve_standby_parks_then_promotes(tmp_path):
    """``serve --standby`` beside an active on one work root parks (its
    /status says standby and names the active), and promotes on the same
    address when the active goes: its /status then says active at epoch 2
    and daemon.jsonl has the steal.  SIGTERM prints its final status."""
    from distributed_grep_tpu_torch.runtime.daemon_log import DaemonLog
    from distributed_grep_tpu_torch.runtime.http_transport import client_call

    env = {"DGREP_LEASE_TTL_S": "1", "DGREP_RESULT_CACHE": "0"}
    root = tmp_path / "svc"
    active, a_addr = _serve_proc(root, env=env)
    standby = None
    try:
        assert client_call(a_addr, "GET", "/status")["role"] == "active"
        standby, b_addr = _serve_proc(root, "--standby", env=env)
        st = client_call(b_addr, "GET", "/status", retry=False)
        assert st == {"service": True, "role": "standby", "active": a_addr}
        active.send_signal(signal.SIGKILL)
        active.wait(timeout=30)
        deadline = time.monotonic() + 30
        while True:
            try:
                st = client_call(b_addr, "GET", "/status", retry=False)
                if st.get("role") == "active":
                    break
            except OSError:
                pass
            assert time.monotonic() < deadline, st
            time.sleep(0.1)
        steals = [e for e in DaemonLog.read(root)
                  if e["kind"] == "lease_steal"]
        assert [e["epoch"] for e in steals] == [2]
        standby.send_signal(signal.SIGTERM)
        out, _err = standby.communicate(timeout=30)
        assert standby.returncode == 0
        final = json.loads(out.decode().strip().splitlines()[-1])
        assert final["service"] is True and final["role"] == "active"
    finally:
        for proc in (active, standby):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)


def test_submit_addr_list_rotates_to_the_live_daemon(tmp_path, corpus,
                                                      capsys, monkeypatch):
    """``submit --addr DEAD,LIVE`` lands on the live daemon: one job,
    minted with a submit token, done, one JSON line; a second address
    that refuses is skipped by the retry loop."""
    from distributed_grep_tpu_torch import __main__ as cli

    monkeypatch.setenv("DGREP_RPC_BACKOFF_S", "0.05")
    svc = GrepService(work_root=tmp_path / "svc", task_timeout_s=5.0,
                      sweep_interval_s=0.1)
    server = ServiceServer(svc)
    server.start()
    svc.start_local_workers(1)
    try:
        rc = cli.main(["submit", "--addr", f"127.0.0.1:9,127.0.0.1:"
                       f"{server.port}", "--backend", "cpu", "hello",
                       *[str(p) for p in corpus.values()],
                       "--timeout", "60"])
        lines = capsys.readouterr().out.strip().splitlines()
        assert rc == 0 and len(lines) == 1
        doc = json.loads(lines[0])
        assert doc["state"] == "done" and doc["outputs"]
        assert list(svc._jobs) == [doc["job_id"]]
        assert svc.record(doc["job_id"]).config.submit_token
    finally:
        svc.stop()
        server.shutdown()


@pytest.mark.parametrize("flags", [
    ["serve", "--max-workers", "3"],
    ["submit", "--follow"],
    ["submit", "--follow", "--stream"],
    ["submit", "--explain"],
    ["trace-export", "--fleet"],
], ids=" ".join)
def test_ported_flags_run(flags, tmp_path, corpus, capsys):
    """The flags that raised before the service's tiers were ported now
    run and exit 0: ``serve --max-workers`` (a process: SIGTERM ends it
    and its last line is its status), ``submit --follow`` (the endpoint
    line), ``--follow --stream`` (the records, then the summary),
    ``--explain`` (the report on the line) and ``trace-export --fleet``
    (the work root's timeline as a Chrome trace)."""
    from distributed_grep_tpu_torch import __main__ as cli
    from distributed_grep_tpu_torch.runtime.daemon_log import DaemonLog

    if flags[0] == "serve":
        proc = subprocess.Popen(
            [sys.executable, "-m", "distributed_grep_tpu_torch", *flags,
             "--workers", "1", "--work-root", str(tmp_path / "svc")],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            env={**os.environ, "DGREP_LOG": "INFO"})
        try:
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                line = proc.stderr.readline().decode()
                if "serving on" in line:
                    break
            proc.send_signal(signal.SIGTERM)
            out, _err = proc.communicate(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
        assert proc.returncode == 0
        status = json.loads(out.decode().strip().splitlines()[-1])
        assert status["service"] is True
        return
    root = tmp_path / "svc"
    svc = GrepService(work_root=root, spans=True, task_timeout_s=5.0,
                      sweep_interval_s=0.1, daemon_log=DaemonLog(root))
    server = ServiceServer(svc)
    server.start()
    addr = f"127.0.0.1:{server.port}"
    files = [str(p) for p in corpus.values()]
    try:
        svc.start_local_workers(1)
        if flags[0] == "submit":
            rc = cli.main([*flags, "--addr", addr, "--backend", "cpu",
                           "--timeout", "3", "hello", *files])
            lines = capsys.readouterr().out.strip().splitlines()
            doc = json.loads(lines[-1])
            assert rc == 0
            if "--stream" in flags:
                assert doc["state"] == "running" and doc["records"] == 4
                assert len(lines) == 5
            elif "--follow" in flags:
                assert doc["state"] == "following"
                assert doc["stream"] == f"/jobs/{doc['job_id']}/stream"
            else:
                assert doc["state"] == "done"
                assert doc["explain"]["routing"]["route"] == "host"
        else:
            jid = svc.submit(grep_config(corpus))
            assert svc.wait_job(jid, timeout=60)
            svc._flush_daemon_log()
            assert cli.main([*flags, str(root)]) == 0
            trace = json.loads(capsys.readouterr().out)
            names = {e["args"]["name"] for e in trace["traceEvents"]
                     if e.get("name") == "process_name"}
            assert "dgrep daemon fleet" in names
            assert f"dgrep job {jid}" in names
    finally:
        svc.stop()
        server.shutdown()


# ------------------------------------------------------- elastic pool

def _scripted_advice(svc_cls, cfg, root):
    """A daemon's scale advice over one scripted life: idle and empty,
    demand with no worker, six stale rows, one fresh idle row."""
    svc = svc_cls(work_root=root, resume=False, rpc_timeout_s=0.5)
    out = []
    try:
        out.append("scale" in svc.status())
        svc.submit(cfg)
        out.append(svc.scale_advice())
        with svc._lock:
            for wid in range(100, 106):
                svc.workers[wid] = {"job": None, "task": None,
                                    "seen": time.monotonic() - 600.0}
        out.append(svc.scale_advice())
        with svc._lock:
            svc.workers[7] = {"job": None, "task": None,
                              "seen": time.monotonic()}
        out.append(svc.scale_advice())
    finally:
        svc.stop()
    return out


def test_scale_advice_equals_the_references(tmp_path, corpus):
    """The same scripted states give the reference's advice: grow on
    demand with no worker, stale rows (silent 10 minutes) not counted as
    capacity, one fresh row counted."""
    from distributed_grep_tpu.runtime.service import GrepService as RefService
    from distributed_grep_tpu.utils.config import JobConfig as RefConfig

    port = _scripted_advice(GrepService, grep_config(corpus),
                            tmp_path / "p")
    ref = _scripted_advice(RefService, RefConfig(
        input_files=[str(p) for p in corpus.values()],
        application=REF_GREP, app_options={"pattern": "hello",
                                           "backend": "cpu"}, n_reduce=3),
        tmp_path / "r")
    assert port == ref
    assert port[0] is False
    assert port[1]["advice"] == port[2]["advice"] == "grow"
    assert port[2]["workers_attached"] == 0
    assert port[3]["workers_attached"] == 1


def test_local_pool_grows_and_drains(tmp_path, corpus):
    from distributed_grep_tpu_torch.runtime.daemon_log import DaemonLog

    from distributed_grep_tpu_torch.utils import metrics as metrics_mod

    actions0 = metrics_mod.counter("dgrep_scale_actions_total").value()
    root = tmp_path / "svc"
    svc = GrepService(work_root=root, resume=False, rpc_timeout_s=30.0,
                      daemon_log=DaemonLog(root))
    try:
        jid = svc.submit(grep_config(corpus))
        advice = svc.scale_advice()
        assert advice["advice"] == "grow" and advice["pending_tasks"] > 0
        assert svc.status()["scale"]["advice"] == "grow"
        assert svc.scale_local_pool(2) == 2
        assert svc.local_pool_size() == 2
        assert svc.wait_job(jid, timeout=60)
        deadline = time.monotonic() + 10
        while svc.scale_advice()["advice"] != "shrink":
            assert time.monotonic() < deadline
            time.sleep(0.05)
        # a drained loop ends at once, though its long poll is 30 s
        t0 = time.monotonic()
        assert svc.scale_local_pool(0) == -2
        for t in svc._local_workers:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in svc._local_workers)
        assert time.monotonic() - t0 < 5.0
        assert svc.scale_local_pool(1) == 1
        assert len(svc._local_loops) == len(svc._local_workers) == 1
        assert metrics_mod.counter(
            "dgrep_scale_actions_total").value() == actions0 + 3
        assert "dgrep_scale_actions_total" in svc.metrics_text()
    finally:
        svc.stop()
    events = DaemonLog.read(root)
    actions = [(e["payload"]["action"], e["payload"]["workers"])
               for e in events if e["kind"] == "scale_action"]
    assert actions == [("grow", 2), ("drain", 2), ("grow", 1)]
    advice = [e["payload"]["advice"] for e in events
              if e["kind"] == "scale_advice"]
    assert advice[0] == "grow" and "shrink" in advice


def test_top_once_renders_the_references_screen(tmp_path, corpus, capsys):
    """``top --once`` over a live daemon and a dead address: the banner
    names both, the body is the daemon's view; the reference's renderer
    gives the same screen for the same documents; no daemon at all exits
    2."""
    from distributed_grep_tpu.__main__ import _render_top as ref_render
    from distributed_grep_tpu_torch import __main__ as cli

    svc = GrepService(work_root=tmp_path / "svc", task_timeout_s=5.0,
                      sweep_interval_s=0.1)
    server = ServiceServer(svc)
    server.start()
    addr = f"127.0.0.1:{server.port}"
    try:
        svc.start_local_workers(1)
        jid = svc.submit(grep_config(corpus))
        assert svc.wait_job(jid, timeout=60)
        assert cli.main(["top", "--once", "--addr",
                         f"{addr},127.0.0.1:1", "--timeout", "2"]) == 0
        screen = capsys.readouterr().out
        assert f"{addr} [ACTIVE]" in screen
        assert "127.0.0.1:1 [DOWN]" in screen
        assert "WID" in screen and "queued 0/" in screen
        st = svc.status()
        metrics = cli._parse_metrics_text(svc.metrics_text())
        assert "dgrep_jobs_done_total" in metrics
        assert cli._render_top({addr: st, "b": None}, addr, metrics) == \
            ref_render({addr: st, "b": None}, addr, metrics)
    finally:
        svc.stop()
        server.shutdown()
    assert cli.main(["top", "--once", "--addr", "127.0.0.1:1",
                     "--timeout", "1"]) == 2
    assert "no daemon reachable" in capsys.readouterr().out


def test_top_interval_and_metrics_parse_as_the_references(monkeypatch):
    from distributed_grep_tpu import __main__ as ref_cli
    from distributed_grep_tpu_torch import __main__ as cli

    for raw in (None, "", "0.5", "-1", "zap", "3"):
        if raw is None:
            monkeypatch.delenv("DGREP_TOP_INTERVAL_S", raising=False)
        else:
            monkeypatch.setenv("DGREP_TOP_INTERVAL_S", raw)
        assert cli.env_top_interval_s() == ref_cli.env_top_interval_s()
    text = ("# HELP x\n# TYPE x gauge\nx 1\ny{le=\"1\"} 2\nz_sum 3.5\n"
            "bad line here\nw notanumber\n")
    assert cli._parse_metrics_text(text) == ref_cli._parse_metrics_text(text)


# ------------------------------------------------------------------ C9

def _slow_load(monkeypatch, seconds: float):
    """The application load of the thread named "late" takes ``seconds``
    (a worker process's imports, on the card's hosts 7-13 s)."""
    from distributed_grep_tpu_torch.apps import loader

    real = loader.load_application

    def load(spec, *a, **k):
        if threading.current_thread().name == "late":
            time.sleep(seconds)
        return real(spec, *a, **k)

    monkeypatch.setattr(loader, "load_application", load)


def _late_worker(addr: str) -> dict:
    from distributed_grep_tpu_torch.runtime.http_transport import (
        run_http_worker,
    )

    out: dict = {}

    def run():
        run_http_worker(addr)
        out["ended"] = time.monotonic()

    t = threading.Thread(target=run, name="late", daemon=True)
    out["thread"] = t
    t.start()
    return out


def test_c9_a_worker_joining_as_its_job_ends_exits_at_once(
        tmp_path, corpus, monkeypatch):
    """ROADMAP C9 on a coordinator: a worker that attaches while the job
    runs and loads for longer than the job has left is told JOB_DONE at
    its first poll (the coordinator serves on until it polls) and exits
    within 5 s of the job's end; one that attaches to a finished job
    (``"done": true``) exits at once.  The retry schedule of 10 retries
    (the smoke's) would take about 40 s."""
    from distributed_grep_tpu_torch.runtime.http_coordinator import (
        CoordinatorServer,
    )
    from distributed_grep_tpu_torch.runtime.http_transport import (
        run_http_worker,
    )

    monkeypatch.setenv("DGREP_RPC_RETRIES", "10")
    _slow_load(monkeypatch, 2.0)
    cfg = JobConfig(input_files=[str(p) for p in corpus.values()],
                    application="distributed_grep_tpu_torch.apps.grep",
                    app_options={"pattern": "hello"}, n_reduce=2,
                    work_dir=str(tmp_path / "job"), coordinator_port=0)
    server = CoordinatorServer(cfg)
    server.start()
    addr = f"127.0.0.1:{server.port}"
    late = _late_worker(addr)
    time.sleep(0.5)  # it has attached and is loading
    threading.Thread(target=run_http_worker, args=(addr,),
                     daemon=True).start()
    assert server.wait_done(timeout=60)
    t_done = time.monotonic()
    # attaching to the finished job: "done", the worker goes at once
    run_http_worker(addr)
    assert time.monotonic() - t_done < 5.0
    stopper = threading.Thread(target=server.shutdown, args=(0.5,))
    stopper.start()
    late["thread"].join(timeout=30)
    assert late["ended"] - t_done < 5.0
    stopper.join(timeout=30)
    assert not stopper.is_alive()


def test_c9_a_worker_of_a_stopping_daemon_exits_at_once(tmp_path, corpus,
                                                        monkeypatch):
    """ROADMAP C9 on the daemon: a worker process still loading when the
    daemon stops is told JOB_DONE at its first poll (``serve`` stops the
    service first, then serves on while it has not polled) and exits
    within 5 s of the stop; one that attaches to the stopping daemon
    (``"stopped": true``) exits at once."""
    from distributed_grep_tpu_torch.runtime.http_transport import (
        run_http_worker,
    )

    monkeypatch.setenv("DGREP_RPC_RETRIES", "10")
    _slow_load(monkeypatch, 2.0)
    svc = GrepService(work_root=tmp_path / "svc", task_timeout_s=5.0,
                      sweep_interval_s=0.1)
    server = ServiceServer(svc)
    server.start()
    addr = f"127.0.0.1:{server.port}"
    late = _late_worker(addr)
    time.sleep(0.5)
    t_stop = time.monotonic()
    svc.stop()
    # attaching to the stopping daemon: "stopped", the worker goes at once
    run_http_worker(addr)
    assert time.monotonic() - t_stop < 5.0
    stopper = threading.Thread(target=server.shutdown,
                               kwargs={"linger_s": 0.5})
    stopper.start()
    late["thread"].join(timeout=30)
    assert late["ended"] - t_stop < 5.0
    stopper.join(timeout=30)
    assert not stopper.is_alive()


# ------------------------------------------------------------- the card

@pytest.mark.cuda
def test_service_job_on_card_gives_the_cpus_bytes(tmp_path, monkeypatch):
    """A service job on the card (no device option: "cuda") gives the
    mr-out bytes of the same job with device "cpu"; the kernels launch
    (DGREP_DEVICE_MIN_BYTES=0: the small-input route off)."""
    from distributed_grep_tpu_torch.ops import device_scan

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    monkeypatch.setenv("DGREP_DEVICE_MIN_BYTES", "0")
    corpus = {}
    for i in range(3):
        p = tmp_path / f"c{i}.txt"
        p.write_bytes(b"".join(b"line %d of %d volcano\n" % (j, i)
                               if j % 7 == 0 else b"filler %d\n" % j
                               for j in range(5000)))
        corpus[p.name] = p
    svc = GrepService(work_root=tmp_path / "svc", task_timeout_s=60.0)
    try:
        svc.start_local_workers(2)
        before = sum(device_scan.kernel_launches().values())
        jc = svc.submit(grep_config(corpus, pattern="volcano",
                                    app_options={"pattern": "volcano"}))
        jh = svc.submit(grep_config(corpus, pattern="volcano"))
        for j in (jc, jh):
            assert svc.wait_job(j, timeout=300), svc.job_status(j)
        assert sum(device_scan.kernel_launches().values()) > before
        assert outputs_by_name(svc.job_result(jc)["outputs"]) == \
            outputs_by_name(svc.job_result(jh)["outputs"])
    finally:
        svc.stop()


@pytest.mark.cuda
def test_standing_query_on_card_equals_the_cpus_stream(tmp_path,
                                                       monkeypatch):
    """Standing queries with no device option run on the card: a fused
    pair and a solo count query stream what the same queries stream on
    ``device: cpu``, and the kernels launch (DGREP_DEVICE_MIN_BYTES=0)."""
    from distributed_grep_tpu_torch.ops import device_scan

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    monkeypatch.setenv("DGREP_DEVICE_MIN_BYTES", "0")
    monkeypatch.setenv("DGREP_FOLLOW_POLL_S", "0.05")

    def drain(svc, jid, want):
        out, cursor = [], 0
        deadline = time.monotonic() + 120
        while sum(int(r.get("count", 1)) for r in out) < want:
            assert time.monotonic() < deadline, (out, svc.job_status(jid))
            page = svc.job_stream(jid, cursor=cursor, timeout=0.5)
            out.extend(page["records"])
            cursor = page["next"]
        return [{k: v for k, v in r.items() if k not in ("seq", "file")}
                for r in out]

    streams = {}
    for dev in ("cuda", "cpu"):
        log = tmp_path / f"{dev}.log"
        log.write_bytes(b"hello volcano\nmiss\n")
        svc = GrepService(work_root=tmp_path / f"svc-{dev}")
        before = sum(device_scan.kernel_launches().values())
        try:
            jids = []
            for q in ({"pattern": "volcano"}, {"pattern": "^hello"},
                      {"pattern": "volcano", "count_only": True}):
                opts = {**q, **({"device": "cpu"} if dev == "cpu" else {})}
                jids.append(svc.submit(JobConfig(
                    input_files=[str(log)], application=PORT_GREP,
                    app_options=opts, follow=True)))
            drain(svc, jids[0], 1)
            with open(log, "ab") as f:
                f.write(b"hello again volcano\n" * 3)
            streams[dev] = [drain(svc, j, n) for j, n in zip(jids, (4, 4, 4))]
            if dev == "cuda":
                assert sum(device_scan.kernel_launches().values()) > before
        finally:
            svc.stop()
    assert streams["cuda"] == streams["cpu"]
