"""The port's work-root lease and failover surface
(distributed_grep_tpu_torch/runtime/lease.py, the lease half of
runtime/service.py, the address-list rotation of runtime/http_transport.py)
held to the reference's (tests/test_lease.py's cases).

Parity: the same acquire, renew, steal and release sequence on the
reference's ``WorkRootLease`` and the port's gives the same ``LEASE``
keys, epochs and verdicts, and each side reads, renews around and steals
the other's file.  The port's daemon runs ``grep_cuda`` with ``device:
cpu``; its registry lines, its token dedup and its fence are held to the
reference daemon's (``grep_tpu``, ``backend: cpu``).  The tolerance is
zero: keys, epochs, verdicts and bytes are equal.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_lease.py -q
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
from dataclasses import replace as dc_replace
from pathlib import Path

import pytest

from distributed_grep_tpu_torch.runtime.http_transport import (
    HttpTransport,
    client_call,
    split_addrs,
)
from distributed_grep_tpu_torch.runtime.lease import (
    WorkRootLease,
    env_lease_renew_s,
    env_lease_ttl_s,
    lease_configured,
)
from distributed_grep_tpu_torch.runtime.service import (
    AdmissionError,
    GrepService,
    ServiceRegistry,
    ServiceServer,
    StandbyServer,
)
from distributed_grep_tpu_torch.utils.config import JobConfig

PORT_GREP = "distributed_grep_tpu_torch.apps.grep_cuda"


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("DGREP_RESULT_CACHE", "0")
    monkeypatch.setenv("DGREP_NO_CALIBRATE", "1")
    monkeypatch.delenv("DGREP_LEASE_TTL_S", raising=False)
    monkeypatch.delenv("DGREP_LEASE_RENEW_S", raising=False)


# ------------------------------------------------------------- env knobs

def test_lease_env_knob_parsers(monkeypatch):
    from distributed_grep_tpu.runtime import lease as ref

    def both(fn):
        return fn(), getattr(ref, fn.__name__)()

    assert both(env_lease_ttl_s) == (10.0, 10.0)
    assert env_lease_renew_s() == pytest.approx(10.0 / 3.0)
    assert lease_configured() is False
    monkeypatch.setenv("DGREP_LEASE_TTL_S", "6")
    assert both(env_lease_ttl_s) == (6.0, 6.0)
    assert env_lease_renew_s() == pytest.approx(2.0)
    assert both(lease_configured) == (True, True)
    monkeypatch.setenv("DGREP_LEASE_RENEW_S", "0.5")
    assert both(env_lease_renew_s) == (0.5, 0.5)
    for bad in ("banana", "-3"):
        monkeypatch.setenv("DGREP_LEASE_TTL_S", bad)
        assert both(env_lease_ttl_s) == (10.0, 10.0)
    monkeypatch.setenv("DGREP_LEASE_RENEW_S", "0")
    monkeypatch.setenv("DGREP_LEASE_TTL_S", "9")
    assert both(env_lease_renew_s) == (pytest.approx(3.0), pytest.approx(3.0))


# ------------------------------------------------------- lease lifecycle

def _backdate(work_root: Path, by_s: float) -> None:
    """Age the lease record on disk: the stamp a stalled active leaves."""
    path = work_root / "LEASE"
    doc = json.loads(path.read_text())
    doc["renewed"] -= by_s
    path.write_text(json.dumps(doc, sort_keys=True))


def test_acquire_fresh_then_contender_parks(tmp_path):
    a = WorkRootLease(tmp_path, addr="127.0.0.1:1", ttl_s=60.0)
    assert a.acquire() is True
    assert a.epoch == 1 and a.token
    assert a.verify() is True
    rec = WorkRootLease.read(tmp_path)
    assert rec["addr"] == "127.0.0.1:1" and rec["epoch"] == 1
    b = WorkRootLease(tmp_path, ttl_s=60.0)
    assert b.acquire() is False  # a live lease: b stands by
    assert b.verify() is False
    before = WorkRootLease.read(tmp_path)["renewed"]
    time.sleep(0.01)
    assert a.renew() is True
    assert WorkRootLease.read(tmp_path)["renewed"] > before


def test_steal_after_ttl_deposed_renew_never_clobbers(tmp_path):
    a = WorkRootLease(tmp_path, addr="old", ttl_s=0.5)
    assert a.acquire()
    _backdate(tmp_path, 5.0)
    b = WorkRootLease(tmp_path, addr="new", ttl_s=0.5)
    assert b.acquire() is True
    assert b.epoch == 2 and b.token != a.token
    assert WorkRootLease.read(tmp_path)["addr"] == "new"
    assert a.verify() is False
    on_disk = (tmp_path / "LEASE").read_bytes()
    assert a.renew() is False
    assert (tmp_path / "LEASE").read_bytes() == on_disk
    a.release()  # a deposed release touches nothing
    assert b.verify() is True
    b.release()
    assert not (tmp_path / "LEASE").exists()
    assert b.verify() is False


def test_concurrent_stealers_loser_detects(tmp_path):
    a = WorkRootLease(tmp_path, ttl_s=0.2)
    assert a.acquire()
    _backdate(tmp_path, 5.0)
    b = WorkRootLease(tmp_path, ttl_s=0.2)
    assert b.acquire() is True and b.epoch == 2
    _backdate(tmp_path, 5.0)
    c = WorkRootLease(tmp_path, ttl_s=0.2)
    assert c.acquire() is True and c.epoch == 3
    assert b.verify() is False and b.renew() is False
    assert c.verify() is True
    assert WorkRootLease.read(tmp_path)["epoch"] > b.epoch - 1


def test_torn_lease_file_treated_stale(tmp_path):
    (tmp_path / "LEASE").write_bytes(b'{"epoch": 7, "tok')
    assert WorkRootLease.read(tmp_path) is None
    b = WorkRootLease(tmp_path, ttl_s=60.0)
    assert b.acquire() is True
    assert b.verify() is True


def test_release_hands_off_without_ttl_wait(tmp_path):
    a = WorkRootLease(tmp_path, ttl_s=3600.0)
    assert a.acquire()
    a.release()
    b = WorkRootLease(tmp_path, ttl_s=3600.0)
    assert b.acquire() is True and b.epoch == 1


def test_renewal_thread_fires_on_lost_once_and_stops(tmp_path):
    a = WorkRootLease(tmp_path, ttl_s=60.0)
    assert a.acquire()
    lost = threading.Event()
    lost_calls: list[int] = []
    renews: list[int] = []
    a.start_renewal(on_lost=lambda: (lost_calls.append(1), lost.set()),
                    on_renew=lambda: renews.append(1), interval_s=0.05)
    deadline = time.monotonic() + 5
    while not renews:
        assert time.monotonic() < deadline
        time.sleep(0.01)
    assert not lost.is_set()
    (tmp_path / "LEASE").unlink()
    b = WorkRootLease(tmp_path, ttl_s=60.0)
    assert b.acquire()
    assert lost.wait(timeout=5)
    time.sleep(0.2)
    assert lost_calls == [1]
    assert b.verify() is True
    a.stop_renewal()
    b.release()


# ------------------------------------------------- parity with the reference

def _lease_keys(root: Path) -> tuple[list, int, str]:
    doc = json.loads((root / "LEASE").read_text())
    return sorted(doc), doc["epoch"], doc["addr"]


def test_lease_sequence_equals_reference_and_files_interoperate(tmp_path):
    """One acquire, renew, contend, steal, stale renew and release
    sequence on each package's lease over its own root: the same LEASE
    keys, epochs and verdicts.  Then the two share one root: each reads
    the other's record, parks behind it, steals it when stale and is
    fenced by the other's steal."""
    from distributed_grep_tpu.runtime.lease import WorkRootLease as RefLease

    def sequence(cls, root: Path) -> list:
        out = []
        a = cls(root, addr="a:1", ttl_s=0.5)
        out.append(("acquire", a.acquire(), a.epoch, _lease_keys(root)))
        out.append(("renew", a.renew(), a.verify()))
        b = cls(root, addr="b:2", ttl_s=0.5)
        out.append(("contend", b.acquire(), b.epoch))
        _backdate(root, 5.0)
        out.append(("steal", b.acquire(), b.epoch, _lease_keys(root)))
        out.append(("stale", a.renew(), a.verify(), b.verify()))
        a.release()
        out.append(("deposed release", (root / "LEASE").exists()))
        b.release()
        out.append(("release", (root / "LEASE").exists(), b.epoch))
        return out

    (tmp_path / "r").mkdir()
    (tmp_path / "p").mkdir()
    assert sequence(WorkRootLease, tmp_path / "p") == sequence(
        RefLease, tmp_path / "r")

    root = tmp_path / "shared"
    ref = RefLease(root, addr="ref:1", ttl_s=0.5)
    assert ref.acquire()
    assert WorkRootLease.read(root) == RefLease.read(root)
    port = WorkRootLease(root, addr="port:2", ttl_s=0.5)
    assert port.acquire() is False  # parks behind the reference's lease
    _backdate(root, 5.0)
    assert port.acquire() is True and port.epoch == 2
    assert RefLease.read(root)["addr"] == "port:2"
    assert ref.verify() is False and ref.renew() is False
    assert port.renew() is True
    _backdate(root, 5.0)
    ref2 = RefLease(root, addr="ref:3", ttl_s=0.5)
    assert ref2.acquire() is True and ref2.epoch == 3
    assert port.verify() is False
    ref2.release()
    assert not (root / "LEASE").exists()


# ------------------------------------------------ a daemon without a lease

def _tiny_cfg(tmp_path: Path, **kw) -> JobConfig:
    p = tmp_path / "in.txt"
    if not p.exists():
        p.write_text("hello\nmiss\n")
    return JobConfig(input_files=[str(p)], application=PORT_GREP,
                     app_options={"pattern": "hello", "device": "cpu"},
                     n_reduce=1, **kw)


def test_no_lease_single_daemon_true_noop(tmp_path):
    svc = GrepService(work_root=tmp_path / "svc", task_timeout_s=5.0,
                      sweep_interval_s=0.1)
    try:
        jid = svc.submit(_tiny_cfg(tmp_path))
        svc.start_local_workers(1)
        assert svc.wait_job(jid, timeout=60), svc.job_status(jid)
        assert "role" not in svc.status()
        assert not (tmp_path / "svc" / "LEASE").exists()
        assert "dgrep_daemon_role" not in svc.metrics_text()
    finally:
        svc.stop()
    lines = [json.loads(ln) for ln in
             (tmp_path / "svc" / "jobs.jsonl").read_text().splitlines()
             if ln.strip()]
    submits = [e for e in lines if e.get("kind") == "job_submit"]
    assert submits
    for e in submits:
        assert "submit_token" not in (e.get("config") or {})
    assert not any(e.get("kind") == "workers" for e in lines)


# ------------------------------------------------------------ the fence

def test_fence_drops_staged_flush_and_deposes(tmp_path):
    root = tmp_path / "svc"
    root.mkdir()
    lease = WorkRootLease(root, addr="me", ttl_s=0.3)
    assert lease.acquire()
    svc = GrepService(work_root=root, lease=lease, task_timeout_s=5.0,
                      sweep_interval_s=0.1)
    jid = svc.submit(_tiny_cfg(tmp_path))
    assert svc.status()["role"] == "active"
    assert "dgrep_daemon_role 1" in svc.metrics_text()
    registry = root / "jobs.jsonl"
    before = registry.read_bytes()
    _backdate(root, 5.0)
    thief = WorkRootLease(root, addr="thief", ttl_s=0.3)
    assert thief.acquire()
    svc.cancel(jid)  # staged, then fenced at its flush
    assert svc.deposed_event.wait(timeout=5)
    assert registry.read_bytes() == before
    assert svc.status()["role"] == "deposed"
    assert "dgrep_daemon_role 0" in svc.metrics_text()
    with pytest.raises(AdmissionError):
        svc.submit(_tiny_cfg(tmp_path))
    svc.stop()
    assert thief.verify() is True  # a deposed stop keeps the winner's file
    thief.release()


def test_deposed_daemon_answers_its_workers_retry_not_done(tmp_path):
    """Beyond the reference: a deposed daemon's assign polls answer a retry
    with a hint, never JOB_DONE (a worker told done would exit instead of
    following its address list to the promoted daemon), and its /status
    does not say stopped."""
    from distributed_grep_tpu_torch.runtime import rpc

    root = tmp_path / "svc"
    root.mkdir()
    lease = WorkRootLease(root, addr="me", ttl_s=0.3)
    assert lease.acquire()
    svc = GrepService(work_root=root, lease=lease)
    try:
        _backdate(root, 5.0)
        assert WorkRootLease(root, addr="thief", ttl_s=0.3).acquire()
        assert svc._write_gate()() is False
        assert svc.deposed_event.is_set()
        reply = svc.assign_task(rpc.AssignTaskArgs(worker_id=-1), timeout=0.1)
        assert reply.assignment == "retry" and reply.retry_after_s > 0
        assert svc.stopped() is False
    finally:
        svc.stop()


def test_deposed_submit_rejected_before_durable_register(tmp_path):
    root = tmp_path / "svc"
    root.mkdir()
    lease = WorkRootLease(root, addr="me", ttl_s=0.3)
    assert lease.acquire()
    svc = GrepService(work_root=root, lease=lease)
    _backdate(root, 5.0)
    thief = WorkRootLease(root, addr="thief", ttl_s=0.3)
    assert thief.acquire()
    reg = root / "jobs.jsonl"
    before = reg.read_bytes() if reg.exists() else b""
    with pytest.raises(AdmissionError):
        svc.submit(_tiny_cfg(tmp_path, submit_token="tok-race"))
    assert (reg.read_bytes() if reg.exists() else b"") == before
    assert "tok-race" not in svc._tokens
    svc.stop()
    thief.release()


# ------------------------------------------------------- the submit token

def test_submit_token_dedup_inprocess_and_across_resume(tmp_path):
    cfg = _tiny_cfg(tmp_path, submit_token="tok-abc")
    svc = GrepService(work_root=tmp_path / "svc", task_timeout_s=5.0,
                      sweep_interval_s=0.1)
    jid = svc.submit(cfg)
    assert svc.submit(cfg) == jid
    assert svc.submit(dc_replace(cfg, submit_token="tok-xyz")) != jid
    svc.start_local_workers(1)
    assert svc.wait_job(jid, timeout=60), svc.job_status(jid)
    svc.stop()
    svc2 = GrepService(work_root=tmp_path / "svc")
    try:
        assert svc2.submit(cfg) == jid
    finally:
        svc2.stop()


def test_submit_token_registry_lines_equal_reference(tmp_path):
    """A tokened submit's registry line carries the token as the
    reference's does, a token-free one none; a daemon restarted on each
    registry answers the same token with the same job."""
    from distributed_grep_tpu.runtime.service import (
        GrepService as RefService,
    )
    from distributed_grep_tpu.utils.config import JobConfig as RefConfig

    p = tmp_path / "in.txt"
    p.write_text("hello\nmiss\n")
    port_cfg = _tiny_cfg(tmp_path, submit_token="tok-1")
    ref_cfg = RefConfig(input_files=[str(p)],
                        application="distributed_grep_tpu.apps.grep_tpu",
                        app_options={"pattern": "hello", "backend": "cpu"},
                        n_reduce=1, submit_token="tok-1")
    runs = (("port", GrepService, port_cfg), ("ref", RefService, ref_cfg))
    for name, svc_cls, cfg in runs:
        svc = svc_cls(work_root=tmp_path / name)
        try:
            assert svc.submit(cfg) == "job-1"
            assert svc.submit(dc_replace(cfg, submit_token="")) == "job-2"
        finally:
            svc.stop()
    for name, _cls, _cfg in runs:
        submits = [json.loads(ln) for ln in
                   (tmp_path / name / "jobs.jsonl").read_text().splitlines()
                   if '"job_submit"' in ln]
        assert [e["config"].get("submit_token") for e in submits] == [
            "tok-1", None]
    for name, svc_cls, cfg in runs:
        svc = svc_cls(work_root=tmp_path / name)
        try:
            assert svc.submit(cfg) == "job-1"
        finally:
            svc.stop()


# ------------------------------------------------- the worker snapshot

def test_promotion_seeds_worker_table_from_snapshot(tmp_path):
    root = tmp_path / "svc"
    root.mkdir()
    reg = ServiceRegistry(root)
    reg.record_workers({"3": {"job": "job-1", "data_endpoint": "http://w3:9"},
                        "7": {"job": None}, "bogus": {"job": None}})
    reg.close()
    assert ServiceRegistry.replay_workers(root)["3"]["job"] == "job-1"
    lease = WorkRootLease(root, ttl_s=60.0)
    assert lease.acquire()
    svc = GrepService(work_root=root, lease=lease)
    try:
        assert set(svc.workers) == {3, 7}
        assert svc.workers[3]["data_endpoint"] == "http://w3:9"
        assert svc._next_worker_id >= 8
        rows = svc.status()["workers"]
        assert set(rows) == {"3", "7"}
        assert rows["3"]["data_endpoint"] == "http://w3:9"
    finally:
        svc.stop()
        lease.release()
    assert ServiceRegistry.replay_workers(root) == {}
    root2 = tmp_path / "svc2"
    root2.mkdir()
    reg2 = ServiceRegistry(root2)
    reg2.record_workers({"5": {"job": None}})
    reg2.close()
    svc2 = GrepService(work_root=root2)
    try:
        assert svc2.workers == {}
    finally:
        svc2.stop()


def test_lease_renewal_snapshots_worker_rows_change_gated(tmp_path):
    root = tmp_path / "svc"
    root.mkdir()
    lease = WorkRootLease(root, ttl_s=60.0)
    assert lease.acquire()
    svc = GrepService(work_root=root, lease=lease)
    try:
        svc.workers[4] = {"job": None, "task": None,
                          "seen": time.monotonic()}
        svc.lease_renewed()
        assert set(ServiceRegistry.replay_workers(root)) == {"4"}
        size = (root / "jobs.jsonl").stat().st_size
        svc.lease_renewed()
        assert (root / "jobs.jsonl").stat().st_size == size
    finally:
        svc.stop()
        lease.release()


# ------------------------------------------------------ the standby surface

def test_standby_server_parks_workers_and_points_at_active(tmp_path):
    from distributed_grep_tpu.runtime.service import (
        StandbyServer as RefStandby,
    )

    lease = WorkRootLease(tmp_path, addr="127.0.0.1:4242", ttl_s=60.0)
    assert lease.acquire()
    standby = StandbyServer(tmp_path, host="127.0.0.1", port=0).start()
    ref = RefStandby(tmp_path, host="127.0.0.1", port=0).start()
    addr = f"127.0.0.1:{standby.port}"
    try:
        st = client_call(addr, "GET", "/status", retry=False)
        assert st == {"service": True, "role": "standby",
                      "active": "127.0.0.1:4242"}
        assert st == client_call(f"127.0.0.1:{ref.port}", "GET", "/status",
                                 retry=False)
        assert StandbyServer.PARK_RETRY_S == RefStandby.PARK_RETRY_S
        for verb, body in (("AssignTask", {"worker_id": 9}),
                           ("ReduceNextFile", {"task_id": 0}),
                           ("MapFinished", {"task_id": 0}),
                           ("Heartbeat", {"task_type": "map",
                                          "task_id": 0})):
            raw = json.dumps(body).encode()
            got = client_call(addr, "POST", f"/rpc/{verb}", raw, retry=False)
            assert got == client_call(f"127.0.0.1:{ref.port}", "POST",
                                      f"/rpc/{verb}", raw, retry=False)
        r = client_call(addr, "POST", "/rpc/AssignTask",
                        json.dumps({"worker_id": 9}).encode(), retry=False)
        assert r["assignment"] == "retry" and r["worker_id"] == 9
        assert r["retry_after_s"] == StandbyServer.PARK_RETRY_S
        r = client_call(addr, "POST", "/rpc/ReduceNextFile",
                        json.dumps({"task_id": 0}).encode(), retry=False)
        assert r["abort"] is True
        for method, path, body in (("POST", "/jobs", b"{}"),
                                   ("GET", "/jobs/job-1", None)):
            with pytest.raises(urllib.error.HTTPError) as ei:
                client_call(addr, method, path, body, retry=False)
            assert ei.value.code == 503
    finally:
        standby.shutdown()
        ref.shutdown()
        lease.release()


# ------------------------------------------------------------- rotation

def test_split_addrs_and_transport_rotation():
    from distributed_grep_tpu.runtime.http_transport import (
        split_addrs as ref_split,
    )

    assert split_addrs("a:1, b:2 ,,c:3") == ["a:1", "b:2", "c:3"]
    assert split_addrs("a:1, b:2 ,,c:3") == ref_split("a:1, b:2 ,,c:3")
    t = HttpTransport("127.0.0.1:1,127.0.0.1:2")
    assert t.base == "http://127.0.0.1:1"
    t._count_retry()
    assert t.base == "http://127.0.0.1:2"
    t._count_retry()
    assert t.base == "http://127.0.0.1:1"
    s = HttpTransport("127.0.0.1:1")
    s._count_retry()
    assert s.base == "http://127.0.0.1:1"


def test_client_call_rotates_to_live_address(tmp_path, monkeypatch):
    monkeypatch.setenv("DGREP_RPC_BACKOFF_S", "0.05")
    svc = GrepService(work_root=tmp_path / "svc")
    server = ServiceServer(svc)
    server.start()
    try:
        status = client_call(f"127.0.0.1:9,127.0.0.1:{server.port}",
                             "GET", "/status", timeout=5.0)
        assert status["service"] is True
    finally:
        svc.stop()
        server.shutdown()


def test_client_call_rotates_past_parked_standby(tmp_path, monkeypatch):
    monkeypatch.setenv("DGREP_RPC_BACKOFF_S", "0.05")
    (tmp_path / "root").mkdir()
    lease = WorkRootLease(tmp_path / "root", addr="x", ttl_s=60.0)
    assert lease.acquire()
    standby = StandbyServer(tmp_path / "root", host="127.0.0.1",
                            port=0).start()
    svc = GrepService(work_root=tmp_path / "svc")
    server = ServiceServer(svc)
    server.start()
    try:
        addrs = f"127.0.0.1:{standby.port},127.0.0.1:{server.port}"
        reply = client_call(addrs, "POST", "/jobs",
                            _tiny_cfg(tmp_path).to_json().encode(),
                            timeout=10.0)
        svc.start_local_workers(1)
        assert svc.wait_job(reply["job_id"], timeout=30)
        assert len(svc._jobs) == 1  # registered exactly once
        st = client_call(addrs, "GET", f"/jobs/{reply['job_id']}",
                         timeout=5.0)
        assert st["state"] == "done"
        with pytest.raises(urllib.error.HTTPError) as ei:
            client_call(f"127.0.0.1:{standby.port}", "GET", "/jobs/j",
                        timeout=5.0)
        assert ei.value.code == 503
    finally:
        svc.stop()
        server.shutdown()
        standby.shutdown()
        lease.release()


def test_promoted_daemon_fails_a_cuda_job_naming_the_device(tmp_path):
    """A promotion resumes the registry's running jobs; a ``grep_cuda``
    job on the card, resumed where there is none, ends failed naming the
    device (ROADMAP.md D8), never on the host.  (Skips on a card's
    host.)"""
    import torch

    if torch.cuda.is_available():
        pytest.skip("the device check passes where a card is")
    root = tmp_path / "svc"
    root.mkdir()
    p = tmp_path / "in.txt"
    p.write_text("hello\n")
    cfg = JobConfig(input_files=[str(p)], application=PORT_GREP,
                    app_options={"pattern": "hello"}, n_reduce=1,
                    work_dir=str(root / "job-1"), job_id="job-1")
    reg = ServiceRegistry(root)
    reg.record_submit("job-1", cfg)
    reg.record_state("job-1", "running")
    reg.close()
    lease = WorkRootLease(root, ttl_s=60.0)
    assert lease.acquire()
    svc = GrepService(work_root=root, lease=lease)
    try:
        st = svc.job_status("job-1")
        assert st["state"] == "failed" and "cuda" in st["error"]
    finally:
        svc.stop()
        lease.release()


def test_streamed_legs_rotate_past_a_parked_standby(tmp_path, monkeypatch):
    """A worker's streamed data-plane legs (the input spool, the output's
    streaming PUT) move past a standby's 503 to the next address, as its
    other requests do: a worker whose read a failover cut short goes on
    against the promoted daemon instead of failing (ROADMAP.md R6)."""
    from distributed_grep_tpu_torch.runtime.http_transport import (
        ServiceHttpTransport,
    )

    monkeypatch.setenv("DGREP_RPC_BACKOFF_S", "0.05")
    (tmp_path / "root").mkdir()
    lease = WorkRootLease(tmp_path / "root", addr="x", ttl_s=60.0)
    assert lease.acquire()
    standby = StandbyServer(tmp_path / "root", host="127.0.0.1",
                            port=0).start()
    svc = GrepService(work_root=tmp_path / "svc")
    server = ServiceServer(svc)
    server.start()
    try:
        cfg = _tiny_cfg(tmp_path)
        jid = svc.submit(cfg)
        t = ServiceHttpTransport(f"127.0.0.1:{standby.port},127.0.0.1:"
                                 f"{server.port}", rpc_timeout_s=10.0)
        t.bind_job(jid)
        path, is_temp = t.read_input_path(cfg.input_files[0])
        assert is_temp and path.read_bytes() == Path(
            cfg.input_files[0]).read_bytes()
        path.unlink()
        out = tmp_path / "out.txt"
        out.write_bytes(b"a record\n")
        t._base_i = 0  # the standby first again
        t.write_output_from_file("mr-out-0", str(out))
        rec = svc.record(jid)
        assert (rec.workdir.root / "out" / "mr-out-0").read_bytes() == \
            b"a record\n"
        # one address: a 503 is the server's answer, raised at once
        single = ServiceHttpTransport(f"127.0.0.1:{standby.port}",
                                      rpc_timeout_s=10.0)
        single.bind_job(jid)
        with pytest.raises(RuntimeError, match="503"):
            single.read_input_path(cfg.input_files[0])
    finally:
        svc.stop()
        server.shutdown()
        standby.shutdown()
        lease.release()
