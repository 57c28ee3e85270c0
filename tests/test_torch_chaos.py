"""The port's chaos tier: its service daemon under SIGKILL, a hostile
network and a lost peer (distributed_grep_tpu_torch/runtime/
fault_transport.py, the failover and peer halves of runtime/service.py,
scheduler.py, worker.py and http_transport.py), held to the reference's
(tests/test_chaos.py's cases).

Every job's outputs are held to the reference's fault-free run of the
same job (``distributed_grep_tpu.apps.grep_tpu``, ``backend: cpu``; the
port runs ``grep_cuda`` on ``device: cpu``), byte for byte, and every
job's journal holds each (kind, task) once: through duplicated, dropped
and delayed RPCs, a daemon SIGKILLed mid-map or mid-reduce and restarted,
a worker killed mid-fused-attempt, a producer killed between its map
commit and the reduce's fetch, a dropped peer-fetch reply, and an active
daemon SIGKILLed with a standby watching the work root (mid-map,
mid-reduce, mid-stream).  The daemons are ``serve`` processes of the port
(``_Daemon`` below), with a lease TTL of 1 s and small corpora.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_chaos.py -q
"""

from __future__ import annotations

import json
import os
import random
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import pytest

from distributed_grep_tpu_torch.runtime import rpc
from distributed_grep_tpu_torch.runtime.daemon_log import DaemonLog
from distributed_grep_tpu_torch.runtime.fault_transport import (
    FaultPoint,
    FaultTransport,
    seeded_schedule,
)
from distributed_grep_tpu_torch.runtime.http_transport import (
    ServiceHttpTransport,
    client_call,
)
from distributed_grep_tpu_torch.runtime.journal import TaskJournal
from distributed_grep_tpu_torch.runtime.peer import PeerDataServer
from distributed_grep_tpu_torch.runtime.scheduler import (
    QUARANTINE_AFTER_FAILURES,
    Scheduler,
    WorkerHealth,
)
from distributed_grep_tpu_torch.runtime.service import (
    GrepService,
    ServiceLocalTransport,
    ServiceServer,
)
from distributed_grep_tpu_torch.runtime.worker import WorkerKilled, WorkerLoop
from distributed_grep_tpu_torch.utils.config import JobConfig
from distributed_grep_tpu_torch.utils.io import WorkDir

REPO = str(Path(__file__).resolve().parents[1])
PORT_GREP = "distributed_grep_tpu_torch.apps.grep_cuda"


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("DGREP_RESULT_CACHE", "0")
    monkeypatch.setenv("DGREP_NO_CALIBRATE", "1")
    monkeypatch.delenv("DGREP_PEER_SHUFFLE", raising=False)
    monkeypatch.delenv("DGREP_LEASE_TTL_S", raising=False)


# ------------------------------------------------------------ the daemons

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http_json(method: str, url: str, body: bytes | None = None,
               timeout: float = 10.0) -> dict:
    req = urllib.request.Request(url, data=body, method=method)
    if body is not None:
        req.add_header("Content-Type", "application/json")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


class _Daemon:
    """One port ``serve`` process on a fixed (port, work root): a SIGKILL
    and a ``start()`` are a crash and a restart at the same address."""

    def __init__(self, work_root: Path, env: dict | None = None,
                 extra_args: list[str] | None = None):
        self.work_root = Path(work_root)
        self.port = _free_port()
        self.base = f"http://127.0.0.1:{self.port}"
        self.addr = f"127.0.0.1:{self.port}"
        self.extra_args = list(extra_args or [])
        self.env = {**os.environ, "PYTHONPATH": REPO, "DGREP_LOG": "WARNING",
                    "DGREP_RESULT_CACHE": "0", **(env or {})}
        self.proc: subprocess.Popen | None = None
        self._logs: list[Path] = []

    def start(self, timeout: float = 60.0) -> "_Daemon":
        log_path = self.work_root.parent / (
            f"serve-{self.port}-{len(self._logs)}.log")
        self._logs.append(log_path)
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "distributed_grep_tpu_torch", "serve",
             "--host", "127.0.0.1", "--port", str(self.port),
             "--work-root", str(self.work_root), "--workers", "0",
             *self.extra_args],
            stdout=subprocess.DEVNULL, stderr=open(log_path, "wb"),
            env=self.env)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.proc.poll() is not None:
                raise RuntimeError(f"serve died at start: {self.tail_log()}")
            try:
                if self.status().get("service"):
                    return self
            except OSError:
                time.sleep(0.1)
        raise TimeoutError(f"serve not ready: {self.tail_log()}")

    def sigkill(self) -> None:
        self.proc.send_signal(signal.SIGKILL)
        self.proc.wait(timeout=30)

    def terminate(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)

    def tail_log(self, n: int = 2000) -> str:
        return "\n---\n".join(p.read_bytes()[-n:].decode("utf-8", "replace")
                              for p in self._logs if p.exists())

    def status(self, timeout: float = 10.0) -> dict:
        return _http_json("GET", f"{self.base}/status", timeout=timeout)

    def submit(self, config: JobConfig) -> str:
        return _http_json("POST", f"{self.base}/jobs",
                          config.to_json().encode())["job_id"]

    def job_status(self, job_id: str) -> dict:
        return _http_json("GET", f"{self.base}/jobs/{job_id}")

    def job_result(self, job_id: str) -> dict:
        return _http_json("GET", f"{self.base}/jobs/{job_id}/result")

    def wait_job(self, job_id: str, timeout: float = 60.0) -> dict:
        deadline = time.monotonic() + timeout
        last: dict = {}
        while time.monotonic() < deadline:
            try:
                last = self.job_status(job_id)
            except OSError:
                time.sleep(0.1)
                continue
            if last.get("state") in ("done", "failed", "cancelled"):
                return last
            time.sleep(0.1)
        raise TimeoutError(f"{job_id} not terminal: {last} "
                           f"({self.tail_log()})")

    def wait_role(self, role: str, timeout: float = 30.0) -> None:
        deadline = time.monotonic() + timeout
        while True:
            try:
                if self.status(timeout=2.0).get("role") == role:
                    return
            except OSError:
                pass
            assert time.monotonic() < deadline, self.tail_log()
            time.sleep(0.1)


# ------------------------------------------------------------- the oracle

def grep_config(corpus, pattern="hello", **kw) -> JobConfig:
    defaults = dict(input_files=[str(p) for p in corpus.values()],
                    application=PORT_GREP,
                    app_options={"pattern": pattern, "device": "cpu"},
                    n_reduce=3)
    defaults.update(kw)
    return JobConfig(**defaults)


def outputs_by_name(paths) -> dict[str, bytes]:
    return {Path(p).name.split(".part.")[0]: Path(p).read_bytes()
            for p in paths}


_ORACLES: dict[tuple, dict[str, bytes]] = {}


def reference_outputs(corpus, pattern: str, n_reduce: int, store: str,
                      work_dir: Path) -> dict[str, bytes]:
    """The reference's fault-free run of the job, cached by its inputs."""
    from distributed_grep_tpu.runtime.job import run_job as ref_run_job
    from distributed_grep_tpu.utils.config import JobConfig as RefConfig

    files = tuple(str(p) for p in corpus.values())
    key = (files, pattern, n_reduce, store)
    if key not in _ORACLES:
        _ORACLES[key] = outputs_by_name(ref_run_job(RefConfig(
            input_files=list(files),
            application="distributed_grep_tpu.apps.grep_tpu",
            app_options={"pattern": pattern, "backend": "cpu"},
            n_reduce=n_reduce, store=store, work_dir=str(work_dir)),
            n_workers=2).output_files)
    return _ORACLES[key]


def journal_unique(work_root: Path, job_id: str) -> None:
    entries = TaskJournal.replay(WorkDir(str(work_root / job_id))
                                 .journal_path())
    seen = [(e["kind"], e["task_id"]) for e in entries]
    assert len(seen) == len(set(seen)), (job_id, seen)


# ----------------------------------------------------- FaultTransport units

class _FakeTransport:
    def __init__(self):
        self.calls: list[str] = []

    def map_finished(self, args):
        self.calls.append("map_finished")
        return rpc.TaskFinishedReply(ok=True)

    def read_input(self, name):
        self.calls.append(f"read:{name}")
        return b"data"


def test_fault_transport_duplicate_and_passthrough():
    base = _FakeTransport()
    ft = FaultTransport(base, {
        FaultPoint.DUPLICATE: lambda ctx: ctx == "map_finished"})
    assert ft.map_finished(rpc.TaskFinishedArgs(task_id=0)).ok
    assert base.calls == ["map_finished", "map_finished"]
    assert ft.read_input("f") == b"data"


def test_fault_transport_drop_request_never_reaches_base():
    base = _FakeTransport()
    ft = FaultTransport(base, {
        FaultPoint.DROP_REQUEST: lambda ctx: ctx == "map_finished"})
    with pytest.raises(ConnectionResetError):
        ft.map_finished(rpc.TaskFinishedArgs(task_id=0))
    assert base.calls == []


def test_fault_transport_drop_reply_applies_server_side():
    base = _FakeTransport()
    ft = FaultTransport(base, {FaultPoint.DROP_REPLY: lambda ctx: True})
    with pytest.raises(ConnectionResetError):
        ft.map_finished(rpc.TaskFinishedArgs(task_id=0))
    assert base.calls == ["map_finished"]


def test_fault_transport_delay_and_feature_probes():
    from distributed_grep_tpu.runtime.fault_transport import (
        seeded_schedule as ref_schedule,
    )

    base = _FakeTransport()
    t0 = time.monotonic()
    ft = FaultTransport(base, {
        FaultPoint.DELAY: lambda ctx: 0.05 if ctx == "read_input" else 0})
    assert ft.read_input("f") == b"data"
    assert time.monotonic() - t0 >= 0.05
    assert not hasattr(ft, "read_input_path")
    assert not hasattr(ft, "publish_task_commit")
    assert not hasattr(ft, "fetch_peer")
    with pytest.raises(ValueError):
        FaultTransport(base, {"bogus_point": lambda ctx: 1})
    # the seeded schedule draws what the reference's draws
    rates = {FaultPoint.DROP_REPLY: 0.3, FaultPoint.DELAY: 0.5}
    port_h, ref_h = seeded_schedule(7, rates), ref_schedule(7, rates)
    calls = ["map_finished", "read_input", "heartbeat"] * 20
    assert [port_h[p](c) for c in calls for p in rates] == [
        ref_h[p](c) for c in calls for p in rates]


# --------------------------------------- duplicate deliveries, end to end

def test_duplicate_deliveries_keep_outputs_exact(tmp_path, corpus):
    svc = GrepService(work_root=tmp_path / "svc", task_timeout_s=5.0,
                      sweep_interval_s=0.1)
    try:
        jid = svc.submit(grep_config(corpus))
        dup = {"n": 0}

        def dup_hook(ctx: str):
            if ctx in ("map_finished", "reduce_finished",
                       "publish_task_commit", "write_intermediate",
                       "write_output"):
                dup["n"] += 1
                return 1
            return 0

        loop = WorkerLoop(FaultTransport(
            ServiceLocalTransport(svc, rpc_timeout_s=5.0),
            {FaultPoint.DUPLICATE: dup_hook}), app=None)
        threading.Thread(target=loop.run, daemon=True).start()
        assert svc.wait_job(jid, timeout=60), svc.job_status(jid)
        assert dup["n"] > 0
        assert outputs_by_name(svc.job_result(jid)["outputs"]) == \
            reference_outputs(corpus, "hello", 3, "posix", tmp_path / "ref")
        journal_unique(tmp_path / "svc", jid)
    finally:
        svc.stop()


# -------------------------------------------------------------- quarantine

def test_worker_quarantine_and_reprobation(tmp_path, monkeypatch):
    monkeypatch.setenv("DGREP_WORKER_QUARANTINE_S", "0.6")
    from distributed_grep_tpu_torch.utils.spans import (
        EventLog,
        export_chrome_trace,
    )

    ev_path = tmp_path / "events.jsonl"
    event_log = EventLog(ev_path, fresh=True)
    files = [str(tmp_path / "in.txt")]
    Path(files[0]).write_text("hello\n")
    sched = Scheduler(files=files, n_reduce=1, task_timeout_s=0.15,
                      sweep_interval_s=0.05, event_log=event_log)
    try:
        flaky = -1
        for i in range(QUARANTINE_AFTER_FAILURES):
            reply = sched.assign_task(rpc.AssignTaskArgs(worker_id=flaky),
                                      timeout=2.0)
            assert reply.assignment == rpc.Assignment.MAP, (i, reply)
            flaky = reply.worker_id
            deadline = time.monotonic() + 5
            while sched.map_tasks[0].state.value != "unassigned":
                assert time.monotonic() < deadline
                time.sleep(0.02)
        reply = sched.assign_task(rpc.AssignTaskArgs(worker_id=flaky),
                                  timeout=0.1)
        assert reply.assignment == "retry" and reply.retry_after_s > 0
        assert sched.worker_health.quarantine_remaining(flaky) > 0
        assert sched.counters["workers_quarantined"] == 1
        assert sched.counters["tasks_requeued"] >= 3
        reply2 = sched.assign_task(rpc.AssignTaskArgs(worker_id=-1),
                                   timeout=2.0)
        assert reply2.assignment == rpc.Assignment.MAP
        assert reply2.worker_id != flaky
        sched.map_finished(rpc.TaskFinishedArgs(
            task_id=0, worker_id=reply2.worker_id, produced_parts=[0]))
        assert "quarantined_s" in sched.worker_status()[str(flaky)]
        time.sleep(0.7)
        assert sched.worker_health.quarantine_remaining(flaky) == 0.0
        reply3 = sched.assign_task(rpc.AssignTaskArgs(worker_id=flaky),
                                   timeout=2.0)
        assert reply3.assignment == rpc.Assignment.REDUCE
    finally:
        sched.stop()
        event_log.close()
    names = [json.loads(ln).get("name")
             for ln in ev_path.read_text().splitlines() if ln.strip()]
    assert "quarantine" in names
    doc = export_chrome_trace(EventLog.read(ev_path))
    assert any(e.get("name") == "quarantine" for e in doc["traceEvents"])


def test_quarantine_backoff_doubles_and_success_clears():
    from distributed_grep_tpu.runtime.scheduler import (
        WorkerHealth as RefHealth,
    )

    for cls in (WorkerHealth, RefHealth):
        h = cls(base_s=10.0)
        for _ in range(QUARANTINE_AFTER_FAILURES - 1):
            assert h.record_failure(7) == 0.0
        assert h.record_failure(7) == 10.0
        h._until.clear()
        assert h.record_failure(7) == 20.0
        h._until.clear()
        h.record_success(7)
        for _ in range(QUARANTINE_AFTER_FAILURES - 1):
            assert h.record_failure(7) == 0.0
        assert h.record_failure(7) == 10.0


def test_service_status_surfaces_quarantine(tmp_path, corpus):
    svc = GrepService(work_root=tmp_path / "svc", task_timeout_s=0.15,
                      sweep_interval_s=0.05)
    try:
        jid = svc.submit(grep_config(corpus))
        flaky = -1
        for _ in range(QUARANTINE_AFTER_FAILURES):
            reply = svc.assign_task(rpc.AssignTaskArgs(worker_id=flaky),
                                    timeout=5.0)
            assert reply.assignment == rpc.Assignment.MAP
            flaky = reply.worker_id
            rec = svc.record(jid)
            deadline = time.monotonic() + 5
            while (rec.scheduler.map_tasks[reply.task_id].state.value
                   != "unassigned"):
                assert time.monotonic() < deadline
                time.sleep(0.02)
        reply = svc.assign_task(rpc.AssignTaskArgs(worker_id=flaky),
                                timeout=0.1)
        assert reply.assignment == "retry" and reply.retry_after_s > 0
        status = svc.status()
        assert status["workers_quarantined"] >= 1
        assert str(flaky) in status["quarantine"]
        assert status["workers"][str(flaky)].get("quarantined_s", 0) > 0
        assert status["tasks_requeued"] >= QUARANTINE_AFTER_FAILURES
        svc.start_local_workers(1)
        assert svc.wait_job(jid, timeout=60), svc.job_status(jid)
    finally:
        svc.stop()


def test_zombie_reducer_fenced_by_scheduler_epoch(tmp_path):
    f = tmp_path / "in.txt"
    f.write_text("hello\n")
    sched = Scheduler(files=[str(f)], n_reduce=1, task_timeout_s=5.0,
                      sweep_interval_s=0.5)
    try:
        r = sched.reduce_next_file(rpc.ReduceNextFileArgs(
            task_id=0, files_processed=1, epoch="deadbeefcafe",
            lost_file="mr-0-0"), timeout=0.1)
        assert r.abort and not r.done and not r.next_file
        for ep in (sched.epoch, ""):
            r = sched.reduce_next_file(rpc.ReduceNextFileArgs(
                task_id=0, files_processed=0, epoch=ep), timeout=0.1)
            assert not r.abort
        reply = sched.assign_task(rpc.AssignTaskArgs(worker_id=-1),
                                  timeout=1.0)
        assert reply.assignment == rpc.Assignment.MAP
        assert reply.epoch == sched.epoch
    finally:
        sched.stop()


# ------------------------------------------------ the flaky-socket clients

class FlakyProxy:
    """A TCP proxy that RST-closes every ``drop_every``-th connection
    (from the first, or the second with ``offset=1``) and forwards the
    rest."""

    def __init__(self, upstream_port: int, drop_every: int = 3,
                 offset: int = 0):
        self.upstream_port = upstream_port
        self.drop_every = drop_every
        self.dropped = 0
        self._n = offset
        self._srv = socket.socket()
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind(("127.0.0.1", 0))
        self._srv.listen(32)
        self.port = self._srv.getsockname()[1]
        self._stop = False
        threading.Thread(target=self._accept_loop, daemon=True).start()

    def _accept_loop(self):
        while not self._stop:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            i = self._n
            self._n += 1
            if i % self.drop_every == 0:
                self.dropped += 1
                conn.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                                b"\x01\x00\x00\x00\x00\x00\x00\x00")
                conn.close()
                continue
            threading.Thread(target=self._pump, args=(conn,),
                             daemon=True).start()

    def _pump(self, client):
        try:
            up = socket.create_connection(("127.0.0.1", self.upstream_port))
        except OSError:
            client.close()
            return

        def shuttle(src, dst):
            try:
                while True:
                    block = src.recv(1 << 16)
                    if not block:
                        break
                    dst.sendall(block)
            except OSError:
                pass
            finally:
                try:
                    dst.shutdown(socket.SHUT_WR)
                except OSError:
                    pass

        t = threading.Thread(target=shuttle, args=(up, client), daemon=True)
        t.start()
        shuttle(client, up)
        t.join(timeout=10)
        client.close()
        up.close()

    def close(self):
        self._stop = True
        self._srv.close()


def test_client_call_survives_connection_resets(tmp_path, monkeypatch):
    monkeypatch.setenv("DGREP_RPC_BACKOFF_S", "0.05")
    svc = GrepService(work_root=tmp_path / "svc")
    server = ServiceServer(svc)
    server.start()
    proxy = FlakyProxy(server.port, drop_every=2)
    try:
        for _ in range(4):
            assert client_call(f"127.0.0.1:{proxy.port}", "GET",
                               "/status")["service"] is True
        assert proxy.dropped >= 2
    finally:
        proxy.close()
        svc.stop()
        server.shutdown()


def test_client_call_single_shot_never_replays(tmp_path, monkeypatch):
    monkeypatch.setenv("DGREP_RPC_BACKOFF_S", "0.05")
    svc = GrepService(work_root=tmp_path / "svc")
    server = ServiceServer(svc)
    server.start()
    proxy = FlakyProxy(server.port, drop_every=1)
    try:
        with pytest.raises(OSError):
            client_call(f"127.0.0.1:{proxy.port}", "POST", "/jobs", b"{}",
                        retry=False)
        assert proxy.dropped == 1
    finally:
        proxy.close()
        svc.stop()
        server.shutdown()


def test_cmd_submit_poll_survives_flaky_socket(tmp_path, corpus, monkeypatch,
                                               capsys):
    from distributed_grep_tpu_torch import __main__ as cli

    monkeypatch.setenv("DGREP_RPC_BACKOFF_S", "0.05")
    svc = GrepService(work_root=tmp_path / "svc", task_timeout_s=5.0,
                      sweep_interval_s=0.1)
    server = ServiceServer(svc)
    server.start()
    svc.start_local_workers(2)
    proxy = FlakyProxy(server.port, drop_every=3, offset=1)
    try:
        rc = cli.main(["submit", "--addr", f"127.0.0.1:{proxy.port}",
                       "--backend", "cpu", "hello",
                       *[str(p) for p in corpus.values()],
                       "--timeout", "60"])
        lines = [ln for ln in capsys.readouterr().out.splitlines()
                 if ln.strip()]
        assert rc == 0 and len(lines) == 1, lines
        doc = json.loads(lines[0])
        assert doc["state"] == "done" and doc["outputs"]
        assert proxy.dropped >= 1
    finally:
        proxy.close()
        svc.stop()
        server.shutdown()


# -------------------------------------------------------- the SIGKILL matrix

def _chaos_hooks(seed: int) -> dict:
    """Seeded drops on every call, duplicates on the idempotent completion
    and commit calls, small delays on the data plane."""
    rng = random.Random(seed)

    def drop_request(ctx):
        return rng.random() < 0.04

    def drop_reply(ctx):
        return rng.random() < 0.04

    def duplicate(ctx):
        return (ctx in ("map_finished", "reduce_finished",
                        "publish_task_commit", "heartbeat")
                and rng.random() < 0.15)

    def delay(ctx):
        if ctx in ("read_input", "read_intermediate", "write_intermediate",
                   "fetch_peer"):
            return 0.02 * rng.random()
        return 0

    return {FaultPoint.DROP_REQUEST: drop_request,
            FaultPoint.DROP_REPLY: drop_reply,
            FaultPoint.DUPLICATE: duplicate, FaultPoint.DELAY: delay}


@pytest.fixture(scope="module")
def matrix_corpus(tmp_path_factory) -> dict[str, Path]:
    root = tmp_path_factory.mktemp("chaos-corpus")
    files = {}
    for i in range(3):
        p = root / f"in{i}.txt"
        p.write_text("".join(
            f"line {j} of file {i}" + (" hello" if j % 3 == 0 else "")
            + (" fox" if j % 5 == 0 else "") + "\n" for j in range(150)))
        files[p.name] = p
    return files


def _crash_replace_workers(addr: str, stop: threading.Event, seeds,
                           faulty: bool) -> list[threading.Thread]:
    """Worker loops replaced when they die (an injected reset kills a loop
    as a network death kills a worker)."""

    def worker_main(seed: int) -> None:
        rng = random.Random(seed)
        while not stop.is_set():
            transport = ServiceHttpTransport(addr, rpc_timeout_s=10.0)
            if faulty:
                transport = FaultTransport(transport,
                                           _chaos_hooks(rng.randrange(1 << 30)))
            try:
                WorkerLoop(transport, app=None).run()
                return
            except Exception:  # noqa: BLE001 -- a dead worker, replaced
                time.sleep(0.1)

    threads = [threading.Thread(target=worker_main, args=(s,), daemon=True)
               for s in seeds]
    for t in threads:
        t.start()
    return threads


def _kill_point(daemon: _Daemon, job_id: str, phase: str) -> None:
    """Wait until the job is mid-map (a map committed) or mid-reduce (the
    map phase over)."""
    deadline = time.monotonic() + 60
    while True:
        assert time.monotonic() < deadline, daemon.tail_log()
        try:
            st = daemon.job_status(job_id)
        except OSError:
            time.sleep(0.05)
            continue
        m = st.get("map", {})
        if phase == "map" and m.get("completed", 0) >= 1:
            return
        if phase == "reduce" and m and m.get("completed") == m.get("total"):
            return
        if st.get("state") == "done":
            return  # too fast to catch: the restart still resumes
        time.sleep(0.02)


def _stop_workers(monkeypatch, stop, threads, *daemons: _Daemon) -> None:
    """End the worker loops: no replacement, no retry, and their daemons
    gone, so each loop's next call fails at once."""
    stop.set()
    monkeypatch.setenv("DGREP_RPC_RETRIES", "0")
    for d in daemons:
        d.terminate()
    for t in threads:
        t.join(timeout=10)


@pytest.mark.parametrize("phase,store", [
    ("map", "posix"), ("map", "nonatomic"),
    ("reduce", "posix"), ("reduce", "nonatomic"),
])
def test_chaos_matrix_daemon_sigkill(tmp_path, monkeypatch, phase, store,
                                     matrix_corpus):
    """A daemon SIGKILLed mid-stream (2 running jobs and 1 queued) x {map,
    reduce} x {posix, nonatomic} x injected network faults: the restarted
    daemon completes every job with the reference's fault-free bytes and
    no duplicate journal commit."""
    monkeypatch.setenv("DGREP_RPC_RETRIES", "12")
    monkeypatch.setenv("DGREP_RPC_BACKOFF_S", "0.1")
    work_root = tmp_path / "svc-root"
    work_root.mkdir()
    daemon = _Daemon(work_root, env={
        "DGREP_SERVICE_MAX_JOBS": "2", "DGREP_WORKER_QUARANTINE_S": "1",
        "DGREP_SERVICE_FUSE": "0"}).start()
    stop = threading.Event()
    threads = _crash_replace_workers(daemon.addr, stop, (11, 23, 47), True)
    patterns = ["hello", "fox", "line"]
    try:
        jids = [daemon.submit(grep_config(
            matrix_corpus, pattern=p, n_reduce=2, store=store,
            task_timeout_s=1.0, sweep_interval_s=0.1)) for p in patterns]
        _kill_point(daemon, jids[0], phase)
        daemon.sigkill()
        time.sleep(0.3)
        daemon.start()
        results = {}
        for jid in jids:
            st = daemon.wait_job(jid, timeout=90)
            assert st["state"] == "done", (jid, st, daemon.tail_log())
            results[jid] = daemon.job_result(jid)["outputs"]
    finally:
        _stop_workers(monkeypatch, stop, threads, daemon)
    for i, (jid, pattern) in enumerate(zip(jids, patterns)):
        assert outputs_by_name(results[jid]) == reference_outputs(
            matrix_corpus, pattern, 2, store, tmp_path / f"ref{i}"), pattern
        journal_unique(work_root, jid)


# ------------------------------------------------ a worker killed mid-fuse

def test_chaos_worker_killed_mid_fused_attempt(tmp_path, monkeypatch,
                                               corpus):
    """A worker dies after a fused attempt's shared scan and before any
    participant's commit: every participant job ends with the reference's
    bytes, each journal holds each task once, and the tasks re-run solo."""
    monkeypatch.setenv("DGREP_RPC_RETRIES", "4")
    monkeypatch.setenv("DGREP_RPC_BACKOFF_S", "0.05")
    work_root = tmp_path / "svc-root"
    work_root.mkdir()
    daemon = _Daemon(work_root, env={"DGREP_SERVICE_MAX_JOBS": "3"}).start()
    stop = threading.Event()
    killed = threading.Event()

    def kill_once() -> None:
        if not killed.is_set():
            killed.set()
            raise WorkerKilled("mid-fused-attempt")

    def worker_main(assassin: bool) -> None:
        while not stop.is_set():
            hooks = ({"before_map_commit": kill_once}
                     if assassin and not killed.is_set() else {})
            loop = WorkerLoop(ServiceHttpTransport(daemon.addr,
                                                   rpc_timeout_s=10.0),
                              app=None, fault_hooks=hooks)
            try:
                loop.run()
                return
            except Exception:  # noqa: BLE001 -- replaced
                time.sleep(0.1)

    patterns = ["hello", "fox", "line"]
    threads: list[threading.Thread] = []
    try:
        jids = [daemon.submit(grep_config(
            corpus, pattern=p, n_reduce=2, task_timeout_s=2.0,
            sweep_interval_s=0.2)) for p in patterns]
        deadline = time.monotonic() + 30
        while not all(daemon.job_status(j).get("state") == "running"
                      for j in jids):
            assert time.monotonic() < deadline, daemon.tail_log()
            time.sleep(0.05)
        threads = [threading.Thread(target=worker_main, args=(i == 0,),
                                    daemon=True) for i in range(2)]
        for t in threads:
            t.start()
        results = {}
        for jid in jids:
            st = daemon.wait_job(jid, timeout=60)
            assert st["state"] == "done", (jid, st, daemon.tail_log())
            results[jid] = daemon.job_result(jid)["outputs"]
        status = daemon.status()
        assert killed.is_set()
        assert status.get("fusion", {}).get("fused_dispatches", 0) >= 1, \
            status
    finally:
        _stop_workers(monkeypatch, stop, threads, daemon)
    for i, (jid, pattern) in enumerate(zip(jids, patterns)):
        assert outputs_by_name(results[jid]) == reference_outputs(
            corpus, pattern, 2, "posix", tmp_path / f"ref{i}"), pattern
        journal_unique(work_root, jid)


# ------------------------------------- the peer shuffle: a producer's death

def _peer_chaos_service(tmp_path):
    svc = GrepService(work_root=tmp_path / "svc-root", resume=False,
                      task_timeout_s=1.0, sweep_interval_s=0.1)
    server = ServiceServer(svc)
    server.start()
    return svc, server, f"127.0.0.1:{server.port}"


class _DieOnReduce(WorkerLoop):
    """A map-only producer: its loop dies at its first reduce assignment,
    every map it ran committed to its spool."""

    def _run_reduce(self, a):
        raise WorkerKilled("the producer dies before the reduce's fetch")


def _run_producer(loop: WorkerLoop) -> None:
    def main():
        try:
            loop.run()
        except WorkerKilled:
            pass

    t = threading.Thread(target=main, daemon=True)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()


def test_chaos_producer_killed_between_map_commit_and_reduce_fetch(
        tmp_path, corpus, monkeypatch):
    """The producer dies after its maps committed to its spool and before
    a reducer fetched: the survivors' fetches fail, they report the
    outputs lost, the maps re-run, and the job ends with the reference's
    bytes and one journal commit a task."""
    monkeypatch.setenv("DGREP_RPC_RETRIES", "1")
    monkeypatch.setenv("DGREP_RPC_BACKOFF_S", "0.1")
    svc, server, addr = _peer_chaos_service(tmp_path)
    peer_a = PeerDataServer().start()
    loop_a = _DieOnReduce(ServiceHttpTransport(addr, rpc_timeout_s=10.0),
                          app=None, peer=peer_a)
    loops_b: list[WorkerLoop] = []
    try:
        jid = svc.submit(grep_config(corpus, pattern="hello", n_reduce=2))
        _run_producer(loop_a)
        peer_a.close()  # the spool dies with the worker
        st = svc.job_status(jid)
        assert st["map"]["completed"] == st["map"]["total"]
        assert st["state"] == "running"
        for _ in range(2):
            loop = WorkerLoop(ServiceHttpTransport(addr, rpc_timeout_s=10.0),
                              app=None)
            loops_b.append(loop)
            threading.Thread(target=loop.run, daemon=True).start()
        assert svc.wait_job(jid, timeout=60), svc.job_status(jid)
        outputs = svc.job_result(jid)["outputs"]
        counters = svc.record(jid).scheduler.metrics_snapshot()["counters"]
    finally:
        svc.stop()
        server.shutdown()
        peer_a.close()
    assert outputs_by_name(outputs) == reference_outputs(
        corpus, "hello", 2, "posix", tmp_path / "ref")
    assert counters.get("maps_lost_output", 0) >= 1
    assert sum(lp.metrics.counters.get("peer_fetch_failures", 0)
               for lp in loops_b) >= 1
    journal_unique(tmp_path / "svc-root", jid)


def test_chaos_drop_reply_on_peer_fetch_leg(tmp_path, corpus, monkeypatch):
    """The peer-fetch leg's replies dropped: the reducer counts the
    failure, finds no relay copy, reports the output lost, and alone runs
    the re-run maps (its report aborts its own attempt); the job ends with
    the reference's bytes and a unique journal."""
    svc, server, addr = _peer_chaos_service(tmp_path)
    drops = {"left": 2}

    def drop_reply(ctx):
        if ctx == "fetch_peer" and drops["left"] > 0:
            drops["left"] -= 1
            return 1
        return 0

    peer_a = PeerDataServer().start()
    loop_a = _DieOnReduce(ServiceHttpTransport(addr, rpc_timeout_s=10.0),
                          app=None, peer=peer_a)
    loop_b = WorkerLoop(FaultTransport(
        ServiceHttpTransport(addr, rpc_timeout_s=10.0),
        {FaultPoint.DROP_REPLY: drop_reply}), app=None)
    t_b = None
    try:
        jid = svc.submit(grep_config(corpus, pattern="fox", n_reduce=2))
        _run_producer(loop_a)
        t_b = threading.Thread(target=loop_b.run, daemon=True)
        t_b.start()
        assert svc.wait_job(jid, timeout=60), svc.job_status(jid)
        outputs = svc.job_result(jid)["outputs"]
        counters = svc.record(jid).scheduler.metrics_snapshot()["counters"]
    finally:
        monkeypatch.setenv("DGREP_RPC_RETRIES", "0")
        svc.stop()
        server.shutdown()
        peer_a.close()
        if t_b is not None:
            t_b.join(timeout=10)
    assert outputs_by_name(outputs) == reference_outputs(
        corpus, "fox", 2, "posix", tmp_path / "ref-fox")
    assert drops["left"] == 0
    assert loop_b.metrics.counters.get("peer_fetch_failures", 0) >= 1
    assert counters.get("maps_lost_output", 0) >= 1
    journal_unique(tmp_path / "svc-root", jid)


# ------------------------------------------------------------ the failover

@pytest.mark.parametrize("phase", ["map", "reduce"])
def test_chaos_failover_sigkill_active_with_standby(tmp_path, monkeypatch,
                                                    phase, matrix_corpus):
    """The active SIGKILLed mid-{map, reduce} with a ``serve --standby``
    on the work root: the standby steals the lease after the TTL, resumes
    the job and ends it with the reference's bytes and one journal commit
    a task across both lives.  The workers ride the address list and the
    client's one job id holds.  The old active comes back as a standby
    and stays one; the timeline has one steal and one promotion."""
    monkeypatch.setenv("DGREP_RPC_RETRIES", "10")
    monkeypatch.setenv("DGREP_RPC_BACKOFF_S", "0.2")
    work_root = tmp_path / "svc-root"
    work_root.mkdir()
    ha_env = {"DGREP_LEASE_TTL_S": "1", "DGREP_SERVICE_FUSE": "0"}
    active = _Daemon(work_root, env=ha_env).start()
    standby = _Daemon(work_root, env=ha_env,
                      extra_args=["--standby"]).start()
    assert active.status().get("role") == "active"
    assert standby.status().get("role") == "standby"
    addrs = f"{active.addr},{standby.addr}"
    stop = threading.Event()
    threads = _crash_replace_workers(addrs, stop, (1, 2), False)
    try:
        jid = client_call(addrs, "POST", "/jobs", grep_config(
            matrix_corpus, pattern="hello", n_reduce=2, task_timeout_s=2.0,
            sweep_interval_s=0.2, submit_token="tok-failover").to_json()
            .encode(), timeout=10.0)["job_id"]
        _kill_point(active, jid, phase)
        active.sigkill()
        standby.wait_role("active")
        # a re-POST of the same token lands on the same job
        again = client_call(addrs, "POST", "/jobs", grep_config(
            matrix_corpus, pattern="hello", n_reduce=2, task_timeout_s=2.0,
            sweep_interval_s=0.2, submit_token="tok-failover").to_json()
            .encode(), timeout=10.0)["job_id"]
        assert again == jid
        st = standby.wait_job(jid, timeout=90)
        assert st["state"] == "done", (st, standby.tail_log())
        outputs = standby.job_result(jid)["outputs"]
        active.extra_args = ["--standby"]
        active.start()
        assert active.status().get("role") == "standby", active.tail_log()
    finally:
        _stop_workers(monkeypatch, stop, threads, active, standby)
    assert outputs_by_name(outputs) == reference_outputs(
        matrix_corpus, "hello", 2, "posix", tmp_path / "ref")
    journal_unique(work_root, jid)
    events = DaemonLog.read(work_root)
    steals = [e for e in events if e["kind"] == "lease_steal"]
    promotions = [e for e in events if e["kind"] == "promoted"]
    assert len(steals) == 1 and len(promotions) == 1, \
        [(e["epoch"], e["kind"]) for e in events]
    assert steals[0]["epoch"] == promotions[0]["epoch"] == 2
    assert promotions[0]["payload"]["failover_s"] > 0


def test_chaos_failover_sigkill_active_mid_stream(tmp_path, monkeypatch):
    """The active SIGKILLed while a standing query streams a log that keeps
    growing: the promoted standby resumes it from its cursors, and a
    reader going on from its cursor sees every line once, in order, the
    lines written during the outage included."""
    monkeypatch.setenv("DGREP_RPC_RETRIES", "10")
    monkeypatch.setenv("DGREP_RPC_BACKOFF_S", "0.2")
    work_root = tmp_path / "svc-root"
    work_root.mkdir()
    ha_env = {"DGREP_LEASE_TTL_S": "1", "DGREP_FOLLOW_POLL_S": "0.05"}
    active = _Daemon(work_root, env=ha_env).start()
    standby = _Daemon(work_root, env=ha_env,
                      extra_args=["--standby"]).start()
    log_path = tmp_path / "app.log"
    log_path.write_bytes(b"hello 0\n")
    n_lines = {"n": 1}
    stop_append = threading.Event()

    def appender() -> None:
        while not stop_append.is_set():
            with open(log_path, "ab") as f:
                f.write(b"hello %d\n" % n_lines["n"])
            n_lines["n"] += 1
            time.sleep(0.02)

    cfg = JobConfig(input_files=[str(log_path)], application=PORT_GREP,
                    app_options={"pattern": "hello", "device": "cpu"},
                    follow=True, follow_poll_s=0.05)
    at = threading.Thread(target=appender, daemon=True)
    collected: list[dict] = []
    try:
        jid = active.submit(cfg)
        at.start()

        def read_page(proc: _Daemon, cursor: int):
            doc = _http_json(
                "GET", f"{proc.base}/jobs/{jid}/stream?cursor={cursor}"
                       f"&timeout=1", timeout=10.0)
            assert "dropped" not in doc
            return doc["records"], doc["next"]

        cursor = 0
        deadline = time.monotonic() + 60
        while len(collected) < 10:
            assert time.monotonic() < deadline, active.tail_log()
            recs, cursor = read_page(active, cursor)
            collected.extend(recs)
        active.sigkill()
        standby.wait_role("active")
        time.sleep(0.5)
        stop_append.set()
        at.join(timeout=10)
        total = n_lines["n"]
        deadline = time.monotonic() + 60
        while not collected or collected[-1]["line"] < total:
            assert time.monotonic() < deadline, (len(collected), total,
                                                 standby.tail_log())
            recs, cursor = read_page(standby, cursor)
            collected.extend(recs)
    finally:
        stop_append.set()
        active.terminate()
        standby.terminate()
    assert [(r["line"], r["text"]) for r in collected] == [
        (i + 1, f"hello {i}") for i in range(total)]
    seqs = [r["seq"] for r in collected]
    assert seqs == sorted(set(seqs))
