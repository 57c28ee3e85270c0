"""The port's HTTP control and data planes against the reference
(tests/test_http_distributed.py's cases, without the device mesh job and
the status verb): the long-poll protocol, the data plane, worker
processes on the CUDA grep app with ``device: "cpu"``.  Every job's
mr-out bytes equal the reference's in-process run_job on the same corpus,
also after a worker is killed and after a coordinator crash and resume.
A worker asked for CUDA on a machine without it exits nonzero."""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.parse
import urllib.request
from pathlib import Path

import pytest

from distributed_grep_tpu.runtime.job import run_job as ref_run_job
from distributed_grep_tpu.utils.config import JobConfig as RefJobConfig
from distributed_grep_tpu_torch.apps.loader import load_application
from distributed_grep_tpu_torch.runtime.http_coordinator import (
    CoordinatorServer,
)
from distributed_grep_tpu_torch.runtime.http_transport import (
    CoordinatorGone,
    HttpTransport,
    run_http_worker,
)
from distributed_grep_tpu_torch.runtime.worker import WorkerKilled, WorkerLoop
from distributed_grep_tpu_torch.utils.config import JobConfig
from tests.test_torch_job import ENGINE_OPTS

REPO = Path(__file__).resolve().parents[1]
APP = "distributed_grep_tpu_torch.apps.grep_cuda"
OPTS = {"device": "cpu", **ENGINE_OPTS}


def make_server(tmp_path, corpus, pattern="hello", **kw):
    defaults = dict(
        input_files=[str(p) for p in corpus.values()],
        app_options={"pattern": pattern, **OPTS},
        n_reduce=3,
        work_dir=str(tmp_path / "job"),
        coordinator_port=0,  # ephemeral
        task_timeout_s=2.0,
        sweep_interval_s=0.1,
    )
    defaults.update(kw)
    server = CoordinatorServer(JobConfig(**defaults))
    server.start()
    return server


def app_of(server):
    return load_application(server.config.application)


def mr_out(root) -> dict[str, bytes]:
    return {p.name: p.read_bytes()
            for p in sorted(Path(root).glob("out/mr-out-*"))}


def reference_out(tmp_path, corpus, pattern="hello", n_reduce=3):
    """The reference's in-process job over the same corpus."""
    res = ref_run_job(RefJobConfig(
        input_files=[str(p) for p in corpus.values()],
        application="distributed_grep_tpu.apps.grep",
        app_options={"pattern": pattern}, n_reduce=n_reduce,
        work_dir=str(tmp_path / "ref")), n_workers=2)
    return {Path(p).name: Path(p).read_bytes() for p in res.output_files}


def expected_grep_lines(corpus, pattern=b"hello"):
    out = set()
    for path in corpus.values():
        for i, line in enumerate(path.read_bytes().split(b"\n"), start=1):
            if pattern in line:
                out.add(f"{path} (line number #{i})\t{line.decode()}")
    return out


def output_lines(root):
    lines = set()
    for f in sorted(Path(root).glob("out/mr-out-*")):
        lines.update(x for x in f.read_text().splitlines() if x)
    return lines


def _raise_killed():
    raise WorkerKilled()


def test_http_end_to_end(tmp_path, corpus):
    server = make_server(tmp_path, corpus)
    addr = f"127.0.0.1:{server.port}"
    app = app_of(server)
    threads = [threading.Thread(
        target=lambda: WorkerLoop(HttpTransport(addr), app).run())
        for _ in range(2)]
    for t in threads:
        t.start()
    assert server.wait_done(timeout=30.0)
    for t in threads:
        t.join(timeout=10.0)
    assert output_lines(tmp_path / "job") == expected_grep_lines(corpus)
    assert mr_out(tmp_path / "job") == reference_out(tmp_path, corpus)
    status = server.status()
    assert status["done"] and status["map"]["completed"] == 3
    assert status["rpcs"]["AssignTask"] >= 2
    assert status["data_plane"]["bytes_out"] >= sum(
        p.stat().st_size for p in corpus.values())
    assert status["counters"]["map_records"] == len(expected_grep_lines(
        corpus))
    server.shutdown(linger_s=0.1)


def test_http_worker_death_recovery(tmp_path, corpus):
    """A worker dies after reading its input; a second worker, joining
    late, finishes the job after the timeout's re-issue."""
    server = make_server(tmp_path, corpus, task_timeout_s=1.0)
    addr = f"127.0.0.1:{server.port}"
    app = app_of(server)

    def dying_worker():
        try:
            WorkerLoop(HttpTransport(addr), app,
                       fault_hooks={"after_map_read": _raise_killed}).run()
        except WorkerKilled:
            pass

    t1 = threading.Thread(target=dying_worker)
    t1.start()
    t1.join(timeout=10.0)
    assert not server.scheduler.done()
    t2 = threading.Thread(
        target=lambda: WorkerLoop(HttpTransport(addr), app).run())
    t2.start()
    assert server.wait_done(timeout=30.0)
    t2.join(timeout=10.0)
    assert mr_out(tmp_path / "job") == reference_out(tmp_path, corpus)
    assert server.scheduler.counters.get("map_retries", 0) >= 1
    server.shutdown(linger_s=0.1)


def test_http_data_plane_rejects_traversal(tmp_path, corpus):
    server = make_server(tmp_path, corpus)
    t = HttpTransport(f"127.0.0.1:{server.port}")
    with pytest.raises(RuntimeError):
        t.write_intermediate("../escape", b"x")
    with pytest.raises(RuntimeError):
        t.read_intermediate("..%2F..%2Fetc%2Fpasswd")
    assert not (tmp_path / "escape").exists()
    server.shutdown(linger_s=0.1)


def test_http_input_endpoint_allowlist(tmp_path, corpus):
    """GET /data/input/ serves the job's input files and nothing else."""
    server = make_server(tmp_path, corpus)
    t = HttpTransport(f"127.0.0.1:{server.port}")
    legit = server.config.input_files[0]
    assert t.read_input(legit) == Path(legit).read_bytes()
    with pytest.raises(RuntimeError) as e:
        t.read_input("/etc/passwd")
    assert "403" in str(e.value)
    server.shutdown(linger_s=0.1)


def test_http_config_bootstrap(tmp_path, corpus):
    server = make_server(tmp_path, corpus, pattern="fox")
    cfg = HttpTransport(f"127.0.0.1:{server.port}").fetch_config()
    assert cfg.app_options["pattern"] == "fox"
    assert cfg.app_options["device"] == "cpu"
    assert cfg.n_reduce == 3 and cfg.application == APP
    server.shutdown(linger_s=0.1)


def test_coordinator_gone_raises_after_budget(monkeypatch):
    monkeypatch.setenv("DGREP_RPC_RETRIES", "2")
    monkeypatch.setenv("DGREP_RPC_BACKOFF_S", "0.05")
    with socket.socket() as s:  # nothing listens on this port
        s.bind(("127.0.0.1", 0))
        dead_port = s.getsockname()[1]
    t = HttpTransport(f"127.0.0.1:{dead_port}")
    with pytest.raises(CoordinatorGone):
        t.fetch_status()
    assert t.retry_count == 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    return {**os.environ, "PYTHONPATH": str(REPO), "DGREP_LOG": "WARNING"}


def test_multiprocess_cli_job(tmp_path, corpus):
    """Processes: the coordinator and two workers through the CLI, one of
    them with two slots; the coordinator prints one JSON line."""
    port = _free_port()
    cfg = JobConfig(input_files=[str(p) for p in corpus.values()],
                    app_options={"pattern": "hello", **OPTS}, n_reduce=3,
                    work_dir=str(tmp_path / "job"), coordinator_port=port,
                    task_timeout_s=5.0)
    cfg_path = tmp_path / "job.json"
    cfg_path.write_text(cfg.to_json())
    cli = [sys.executable, "-m", "distributed_grep_tpu_torch"]
    coord = subprocess.Popen([*cli, "coordinator", "--config", str(cfg_path)],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             env=_env(), text=True)
    workers = []
    try:
        for slots in ("1", "2"):
            workers.append(subprocess.Popen(
                [*cli, "worker", "--addr", f"127.0.0.1:{port}", "--slots",
                 slots], stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                env=_env()))
        out, err = coord.communicate(timeout=120)
        assert coord.returncode == 0, err[-2000:]
        lines = out.strip().splitlines()
        assert len(lines) == 1
        outputs = json.loads(lines[0])["outputs"]
        assert [Path(p).name for p in outputs] == [f"mr-out-{r}"
                                                   for r in range(3)]
        assert mr_out(tmp_path / "job") == reference_out(tmp_path, corpus)
        for w in workers:
            assert w.wait(timeout=60) == 0, w.stderr.read()[-2000:]
    finally:
        for p in [coord, *workers]:
            if p.poll() is None:
                p.kill()
                p.wait()


def test_worker_asked_for_cuda_without_it_exits_nonzero(tmp_path, corpus):
    """The job asks for the card and this machine has none: the worker
    process exits nonzero naming the device, and scans nothing."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the worker would run")
    server = make_server(tmp_path, corpus,
                         app_options={"pattern": "hello", **ENGINE_OPTS})
    try:
        r = subprocess.run(
            [sys.executable, "-m", "distributed_grep_tpu_torch", "worker",
             "--addr", f"127.0.0.1:{server.port}"],
            capture_output=True, env=_env(), timeout=120)
        assert r.returncode != 0
        assert b"cuda" in r.stderr.lower()
        status = server.status()
        assert status["rpcs"].get("AssignTask", 0) == 0
        assert status["map"]["completed"] == 0
    finally:
        server.shutdown(linger_s=0.0)


def test_http_read_input_path_spools_to_temp(tmp_path, corpus):
    server = make_server(tmp_path, corpus)
    try:
        t = HttpTransport(f"127.0.0.1:{server.port}")
        fname = server.config.input_files[0]
        path, is_temp = t.read_input_path(fname)
        assert is_temp
        try:
            assert path.read_bytes() == Path(fname).read_bytes()
        finally:
            path.unlink()
    finally:
        server.shutdown(linger_s=0.1)


def test_http_streaming_app_end_to_end(tmp_path, corpus):
    """The CUDA grep app's map_path_fn over HTTP: the worker spools each
    split and the app streams it; never a whole-bytes read."""
    server = make_server(tmp_path, corpus)
    try:
        app = app_of(server)
        assert app.map_path_fn is not None
        t = HttpTransport(f"127.0.0.1:{server.port}")

        def no_whole_read(filename):
            raise AssertionError("read_input called on the streaming path")

        t.read_input = no_whole_read
        WorkerLoop(t, app).run()
        assert mr_out(tmp_path / "job") == reference_out(tmp_path, corpus)
    finally:
        server.shutdown(linger_s=0.1)


def test_data_plane_streams_in_small_blocks(tmp_path, monkeypatch):
    """With 512-byte blocks, a split far larger than one block flows GET
    and PUT end to end."""
    from distributed_grep_tpu_torch.runtime import http_coordinator

    monkeypatch.setattr(http_coordinator, "BLOCK_BYTES", 512)
    big = tmp_path / "big.txt"
    big.write_bytes(b"".join(
        (f"line {i} " + ("hello " if i % 97 == 0 else "x " * 20)).encode()
        + b"\n" for i in range(20_000)))
    corpus = {"big.txt": big}
    server = make_server(tmp_path, corpus)
    app = app_of(server)
    t = threading.Thread(target=lambda: WorkerLoop(
        HttpTransport(f"127.0.0.1:{server.port}"), app).run())
    t.start()
    assert server.wait_done(timeout=60.0)
    t.join(timeout=10.0)
    assert mr_out(tmp_path / "job") == reference_out(tmp_path, corpus)
    server.shutdown(linger_s=0.1)


def test_input_get_supports_range_resume(tmp_path, corpus):
    """'bytes=N-' prefix ranges answer 206; other ranges a whole 200."""
    server = make_server(tmp_path, corpus)
    path = str(next(iter(corpus.values())))
    whole = Path(path).read_bytes()
    url = (f"http://127.0.0.1:{server.port}/data/input/"
           + urllib.parse.quote(path, safe=""))
    req = urllib.request.Request(url)
    req.add_header("Range", "bytes=7-")
    with urllib.request.urlopen(req) as resp:
        assert resp.status == 206
        assert resp.headers["Content-Range"] == (
            f"bytes 7-{len(whole) - 1}/{len(whole)}")
        assert resp.read() == whole[7:]
    req = urllib.request.Request(url)
    req.add_header("Range", "bytes=3-5")
    with urllib.request.urlopen(req) as resp:
        assert resp.status == 200
        assert resp.read() == whole
    server.shutdown(linger_s=0.1)


def test_coordinator_memory_flat_on_large_split(tmp_path):
    """A split far larger than a block goes down (GET, spooled) and back up
    (a streaming PUT) while the process's traced allocations stay a
    fraction of it: neither side holds the file."""
    import tracemalloc

    size = 48 << 20
    big = tmp_path / "big.bin"
    with open(big, "wb") as f:
        line = b"x" * 199 + b"\n"
        for _ in range(size // len(line)):
            f.write(line)
    server = make_server(tmp_path, {"big.bin": big})
    try:
        t = HttpTransport(f"127.0.0.1:{server.port}")
        tracemalloc.start()
        try:
            path, _ = t.read_input_path(str(big))
            t.write_output_from_file("mr-out-0", str(path))
            _, peak = tracemalloc.get_traced_memory()
        finally:
            tracemalloc.stop()
        os.unlink(path)
        assert (tmp_path / "job" / "out" / "mr-out-0").stat().st_size == \
            big.stat().st_size
        assert peak < size // 6, peak
    finally:
        server.shutdown(linger_s=0.0)


def test_http_coordinator_crash_resume(tmp_path, corpus):
    """The coordinator goes down after a map commit and restarts with
    resume: the journal's replay skips the committed maps, and a fresh
    worker finishes the job with the reference's bytes."""
    server1 = make_server(tmp_path, corpus)
    addr = f"127.0.0.1:{server1.port}"
    app = app_of(server1)
    committed = {"n": 0}

    def die_after_first_commit():
        committed["n"] += 1
        if committed["n"] >= 2:  # the first call follows task 1's commit
            raise WorkerKilled()

    def dying_worker():
        try:
            WorkerLoop(HttpTransport(addr), app, fault_hooks={
                "before_map_finished": die_after_first_commit}).run()
        except WorkerKilled:
            pass

    t1 = threading.Thread(target=dying_worker)
    t1.start()
    t1.join(timeout=15.0)
    status1 = server1.status()
    assert not status1["done"]
    n_committed = status1["map"]["completed"]
    assert n_committed >= 1
    server1.shutdown(linger_s=0.0)  # the crash: the journal stays

    cfg = server1.config
    server2 = CoordinatorServer(cfg, resume=True)
    server2.start()
    assert server2.status()["map"]["completed"] == n_committed
    t2 = threading.Thread(target=lambda: WorkerLoop(
        HttpTransport(f"127.0.0.1:{server2.port}"), app).run())
    t2.start()
    assert server2.wait_done(timeout=30.0)
    t2.join(timeout=10.0)
    assigned = server2.scheduler.counters.get("map_assigned", 0)
    assert len(cfg.input_files) - n_committed <= assigned < 2 * len(
        cfg.input_files)
    assert server2.status()["map"]["completed"] == len(cfg.input_files)
    assert mr_out(tmp_path / "job") == reference_out(tmp_path, corpus)
    server2.shutdown(linger_s=0.1)


def test_http_worker_slots_parallel(tmp_path, corpus):
    """--slots N: one process runs N task loops."""
    server = make_server(tmp_path, corpus)
    addr = f"127.0.0.1:{server.port}"
    t = threading.Thread(target=lambda: run_http_worker(addr=addr,
                                                        n_parallel=3))
    t.start()
    assert server.wait_done(timeout=30.0)
    t.join(timeout=15.0)
    assert mr_out(tmp_path / "job") == reference_out(tmp_path, corpus)
    server.shutdown(linger_s=0.1)


def test_worker_loop_error_fails_the_worker(tmp_path, corpus, monkeypatch):
    """A slot whose task raises (a failed build or launch) ends the worker
    with that error, not a host scan; the coordinator re-issues the task,
    and a healthy worker finishes the job."""
    from distributed_grep_tpu_torch.ops.engine import GrepEngine

    server = make_server(tmp_path, corpus, task_timeout_s=1.0)
    addr = f"127.0.0.1:{server.port}"
    real_scan_file = GrepEngine.scan_file
    failed = {"n": 0}

    def scan_file_fails_once(self, *a, **kw):
        if not failed["n"]:
            failed["n"] += 1
            raise RuntimeError("kernel launch failed: an injected fault")
        return real_scan_file(self, *a, **kw)

    monkeypatch.setattr(GrepEngine, "scan_file", scan_file_fails_once)
    with pytest.raises(RuntimeError, match="injected fault"):
        run_http_worker(addr=addr, n_parallel=1)
    assert not server.scheduler.done()
    run_http_worker(addr=addr, n_parallel=1)
    assert server.wait_done(timeout=30.0)
    assert mr_out(tmp_path / "job") == reference_out(tmp_path, corpus)
    assert server.scheduler.counters["map_retries"] >= 1
    server.shutdown(linger_s=0.1)


def _wait_up(addr: str) -> None:
    deadline = time.monotonic() + 60
    while True:  # the coordinator is up once /status answers
        try:
            HttpTransport(addr).fetch_status()
            return
        except (CoordinatorGone, RuntimeError):
            assert time.monotonic() < deadline
            time.sleep(0.2)


def test_coordinator_kill_and_resume_through_the_cli(tmp_path, corpus,
                                                      monkeypatch):
    """The coordinator process is SIGKILLed after a map commit and
    restarted with --resume: the committed map is not run again, and the
    outputs equal the reference's."""
    monkeypatch.setenv("DGREP_RPC_RETRIES", "2")
    monkeypatch.setenv("DGREP_RPC_BACKOFF_S", "0.1")
    port = _free_port()
    cfg = JobConfig(input_files=[str(p) for p in corpus.values()],
                    app_options={"pattern": "hello", **OPTS}, n_reduce=3,
                    work_dir=str(tmp_path / "job"), coordinator_port=port,
                    task_timeout_s=5.0)
    cfg_path = tmp_path / "job.json"
    cfg_path.write_text(cfg.to_json())
    cli = [sys.executable, "-m", "distributed_grep_tpu_torch", "coordinator",
           "--config", str(cfg_path)]
    addr = f"127.0.0.1:{port}"
    app = load_application(APP)
    coord = subprocess.Popen(cli, stdout=subprocess.PIPE,
                             stderr=subprocess.DEVNULL, env=_env())
    committed = {"n": 0}

    def die_after_first_commit():
        committed["n"] += 1
        if committed["n"] >= 2:
            raise WorkerKilled()

    try:
        _wait_up(addr)
        with pytest.raises(WorkerKilled):
            WorkerLoop(HttpTransport(addr), app, fault_hooks={
                "before_map_finished": die_after_first_commit}).run()
        first = HttpTransport(addr).fetch_status()["map"]["completed"]
        assert first == 1
    finally:
        coord.send_signal(signal.SIGKILL)
        coord.wait()
    resumed = subprocess.Popen([*cli, "--resume"], stdout=subprocess.PIPE,
                               stderr=subprocess.DEVNULL, env=_env())
    try:
        _wait_up(addr)
        status = HttpTransport(addr).fetch_status()
        assert status["map"]["completed"] == 1  # replayed, not run again
        loop = WorkerLoop(HttpTransport(addr), app)
        loop.run()
        out, _ = resumed.communicate(timeout=60)
        assert resumed.returncode == 0
        assert len(json.loads(out.decode().strip())["outputs"]) == 3
    finally:
        if resumed.poll() is None:
            resumed.kill()
            resumed.wait()
    journal = (tmp_path / "job" / "journal" / "tasks.jsonl").read_text()
    map_lines = [json.loads(x) for x in journal.splitlines()
                 if '"map_done"' in x]
    assert sorted(e["task_id"] for e in map_lines) == [0, 1, 2]  # once each
    assert mr_out(tmp_path / "job") == reference_out(tmp_path, corpus)


def test_client_call_retries_and_single_shot(tmp_path, corpus, monkeypatch):
    """client_call answers from a live coordinator; against a dead one the
    retried call and the single-shot call both end in CoordinatorGone,
    the single shot after one attempt."""
    from distributed_grep_tpu_torch.runtime.http_transport import client_call

    server = make_server(tmp_path, corpus)
    try:
        st = client_call(f"127.0.0.1:{server.port}", "GET", "/status")
        assert st["map"]["total"] == 3 and not st["done"]
    finally:
        server.shutdown(linger_s=0.0)
    monkeypatch.setenv("DGREP_RPC_BACKOFF_S", "0.05")
    dead = _free_port()
    t0 = time.monotonic()
    with pytest.raises(CoordinatorGone):
        client_call(f"127.0.0.1:{dead}", "GET", "/status", timeout=2.0)
    with pytest.raises(CoordinatorGone):
        client_call(f"127.0.0.1:{dead}", "POST", "/rpc/AssignTask",
                    body=b"{}", retry=False)
    assert time.monotonic() - t0 < 10.0


def test_input_spool_resumes_a_body_cut_short(tmp_path, corpus, monkeypatch):
    """A coordinator that dies mid-body closes the connection, and
    urllib's read(n) then just ends: the spool counts the bytes against
    the Content-Length and resumes the rest with a Range request (the
    split is never scanned short)."""
    from distributed_grep_tpu_torch.runtime import http_coordinator

    real = http_coordinator.DataPlaneHandler._send_file
    cut = {"n": 0}

    def send_half_then_close(self, path):
        if cut["n"] or self.headers.get("Range"):
            return real(self, path)
        cut["n"] += 1
        data = path.read_bytes()
        self.send_response(200)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data[: len(data) // 2])
        self.wfile.flush()
        self.close_connection = True  # a clean close, as a killed peer's

    monkeypatch.setattr(http_coordinator.DataPlaneHandler, "_send_file",
                        send_half_then_close)
    monkeypatch.setenv("DGREP_RPC_BACKOFF_S", "0.05")
    server = make_server(tmp_path, corpus)
    try:
        t = HttpTransport(f"127.0.0.1:{server.port}")
        fname = server.config.input_files[0]
        path, is_temp = t.read_input_path(fname)
        try:
            assert path.read_bytes() == Path(fname).read_bytes()
        finally:
            path.unlink()
        assert cut["n"] == 1 and t.retry_count == 1
    finally:
        server.shutdown(linger_s=0.0)

