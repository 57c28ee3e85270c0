"""The port's peer-to-peer shuffle (distributed_grep_tpu_torch/runtime/
peer.py, the peer halves of runtime/worker.py, scheduler.py, rpc.py,
http_transport.py and service.py) held to the reference's
(tests/test_peer_shuffle.py's cases; its elastic-pool cases are in
tests/test_torch_service.py).

Parity: a daemon job of ``grep_cuda`` on ``device: cpu`` over two HTTP
workers with the peer shuffle on gives the ``mr-out-*`` bytes of the
reference's job (``grep_tpu``, ``backend: cpu``) with the daemon's relay
bytes 0; with DGREP_PEER_SHUFFLE=0 every RPC payload of the same job is,
field for field, the relay protocol's; the spool's checksum is the
reference's.  The tolerance is zero.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_peer_shuffle.py -q
"""

from __future__ import annotations

import threading
import time
from pathlib import Path

import pytest

from distributed_grep_tpu_torch.runtime import rpc
from distributed_grep_tpu_torch.runtime.explain import summarize_events
from distributed_grep_tpu_torch.runtime.http_transport import (
    ServiceHttpTransport,
    client_call,
    fetch_peer_data,
)
from distributed_grep_tpu_torch.runtime.journal import TaskJournal
from distributed_grep_tpu_torch.runtime.peer import (
    PeerDataServer,
    checksum,
    env_peer_bind,
    env_peer_host,
    env_peer_port,
    env_peer_shuffle,
)
from distributed_grep_tpu_torch.runtime.scheduler import Scheduler, WorkerHealth
from distributed_grep_tpu_torch.runtime.service import GrepService, ServiceServer
from distributed_grep_tpu_torch.runtime.types import TaskState
from distributed_grep_tpu_torch.runtime.worker import WorkerLoop
from distributed_grep_tpu_torch.utils.config import JobConfig

PORT_GREP = "distributed_grep_tpu_torch.apps.grep_cuda"
REF_GREP = "distributed_grep_tpu.apps.grep_tpu"


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("DGREP_NO_CALIBRATE", "1")
    monkeypatch.setenv("DGREP_RESULT_CACHE", "0")
    for k in ("DGREP_PEER_SHUFFLE", "DGREP_PEER_PORT", "DGREP_PEER_HOST",
              "DGREP_PEER_BIND"):
        monkeypatch.delenv(k, raising=False)


def outputs_by_name(paths) -> dict[str, bytes]:
    return {Path(p).name.split(".part.")[0]: Path(p).read_bytes()
            for p in paths}


def grep_config(corpus, pattern="hello", **kw) -> JobConfig:
    defaults = dict(input_files=[str(p) for p in corpus.values()],
                    application=PORT_GREP,
                    app_options={"pattern": pattern, "device": "cpu"},
                    n_reduce=2, work_dir="ignored")
    defaults.update(kw)
    return JobConfig(**defaults)


def ref_outputs(tmp_path, corpus, pattern="hello", n_reduce=2):
    """The reference's daemon job over the same inputs (its relay data
    plane: in-process workers)."""
    from distributed_grep_tpu.runtime.service import (
        GrepService as RefService,
    )
    from distributed_grep_tpu.utils.config import JobConfig as RefConfig

    svc = RefService(work_root=tmp_path / "ref-svc", resume=False)
    try:
        jid = svc.submit(RefConfig(
            input_files=[str(p) for p in corpus.values()],
            application=REF_GREP,
            app_options={"pattern": pattern, "backend": "cpu"},
            n_reduce=n_reduce))
        svc.start_local_workers(2)
        assert svc.wait_job(jid, timeout=60)
        return outputs_by_name(svc.job_result(jid)["outputs"])
    finally:
        svc.stop()


# ------------------------------------------------------------ the server

def test_peer_server_put_get_and_checksum(tmp_path):
    from distributed_grep_tpu.runtime.peer import checksum as ref_checksum

    srv = PeerDataServer().start()
    try:
        size, crc = srv.put("job-1", "mr-0-1", b"hello shuffle\n")
        assert size == len(b"hello shuffle\n")
        assert crc == checksum(b"hello shuffle\n") == ref_checksum(
            b"hello shuffle\n")
        assert srv.get_local("job-1", "mr-0-1") == b"hello shuffle\n"
        assert srv.spool_bytes() == size
        srv.put("job-1", "mr-0-1", b"shorter\n")
        assert srv.spool_bytes() == len(b"shorter\n")
        assert fetch_peer_data(srv.endpoint, "job-1", "mr-0-1") == b"shorter\n"
        with pytest.raises(RuntimeError):  # a 404: an honest absence
            fetch_peer_data(srv.endpoint, "job-1", "mr-9-9")
    finally:
        srv.close()
    assert not srv.spool_root.exists()  # its own spool goes with it


def test_peer_server_rejects_traversal(tmp_path):
    srv = PeerDataServer()
    try:
        with pytest.raises(ValueError):
            srv.spool_path("../evil", "mr-0-0")
        with pytest.raises(ValueError):
            srv.spool_path("job-1", ".hidden")
    finally:
        srv.close()


def test_reference_fetch_reads_the_port_spool_and_back(tmp_path):
    """Each package's fetch reads the other's data server, byte for
    byte."""
    from distributed_grep_tpu.runtime.http_transport import (
        fetch_peer_data as ref_fetch,
    )
    from distributed_grep_tpu.runtime.peer import (
        PeerDataServer as RefServer,
    )

    data = bytes(range(256)) * 40
    port, ref = PeerDataServer().start(), RefServer().start()
    try:
        assert port.put("j", "mr-3-1", data) == ref.put("j", "mr-3-1", data)
        assert ref_fetch(port.endpoint, "j", "mr-3-1") == data
        assert fetch_peer_data(ref.endpoint, "j", "mr-3-1") == data
    finally:
        port.close()
        ref.close()


def test_env_knob_accessors(monkeypatch):
    from distributed_grep_tpu.runtime import peer as ref

    assert env_peer_shuffle() is True
    for off in ("0", "false", "no"):
        monkeypatch.setenv("DGREP_PEER_SHUFFLE", off)
        assert env_peer_shuffle() is False is ref.env_peer_shuffle()
    monkeypatch.setenv("DGREP_PEER_SHUFFLE", "1")
    assert env_peer_shuffle() is True
    for raw, want in (("8125", 8125), ("bogus", 0), ("-1", 0)):
        monkeypatch.setenv("DGREP_PEER_PORT", raw)
        assert env_peer_port() == want == ref.env_peer_port()
    monkeypatch.setenv("DGREP_PEER_HOST", "10.0.0.7")
    assert env_peer_host() == "10.0.0.7" == ref.env_peer_host()


def test_bind_knob_cascade(monkeypatch):
    assert env_peer_bind() == "127.0.0.1"
    monkeypatch.setenv("DGREP_PEER_HOST", "worker-7.cluster")
    assert env_peer_bind() == "0.0.0.0"
    monkeypatch.setenv("DGREP_PEER_BIND", "10.0.0.7")
    assert env_peer_bind() == "10.0.0.7"


def test_server_binds_wildcard_and_advertises_routable_host(monkeypatch):
    monkeypatch.setenv("DGREP_PEER_HOST", "127.0.0.1")
    srv = PeerDataServer().start()
    try:
        assert srv._httpd.server_address[0] == "0.0.0.0"
        assert srv.endpoint == f"http://127.0.0.1:{srv.port}"
        srv.put("j", "mr-0-0", b"cross-host\n")
        assert fetch_peer_data(srv.endpoint, "j", "mr-0-0") == b"cross-host\n"
    finally:
        srv.close()
    monkeypatch.delenv("DGREP_PEER_HOST")
    monkeypatch.setenv("DGREP_PEER_BIND", "0.0.0.0")
    srv = PeerDataServer()
    try:
        assert "0.0.0.0" not in srv.endpoint
    finally:
        srv.close()


# -------------------------------------------------------------- the wire

def test_wire_shapes_unchanged_when_off():
    """The peer riders off the wire at their defaults, on it when set; the
    same dicts as the reference's messages."""
    from distributed_grep_tpu.runtime import rpc as ref

    pairs = [
        (rpc.AssignTaskArgs(worker_id=3), ref.AssignTaskArgs(worker_id=3)),
        (rpc.TaskFinishedArgs(task_id=1, produced_parts=[0]),
         ref.TaskFinishedArgs(task_id=1, produced_parts=[0])),
        (rpc.ReduceNextFileArgs(task_id=0, files_processed=2),
         ref.ReduceNextFileArgs(task_id=0, files_processed=2)),
        (rpc.AssignTaskArgs(worker_id=3, peer_endpoint="http://h:1"),
         ref.AssignTaskArgs(worker_id=3, peer_endpoint="http://h:1")),
        (rpc.TaskFinishedArgs(task_id=1, produced_parts=[0],
                              peer_endpoint="http://h:1",
                              peer_parts={"0": [4, "aa"]}),
         ref.TaskFinishedArgs(task_id=1, produced_parts=[0],
                              peer_endpoint="http://h:1",
                              peer_parts={"0": [4, "aa"]})),
        (rpc.ReduceNextFileArgs(task_id=0, files_processed=2,
                                lost_file="mr-0-0"),
         ref.ReduceNextFileArgs(task_id=0, files_processed=2,
                                lost_file="mr-0-0")),
    ]
    for port_msg, ref_msg in pairs:
        assert rpc.to_dict(port_msg) == ref.to_dict(ref_msg)
    assert rpc.to_dict(rpc.AssignTaskArgs(worker_id=3)) == {"worker_id": 3}
    assert set(rpc.to_dict(rpc.TaskFinishedArgs(
        task_id=1, produced_parts=[0]))) == {"task_id", "produced_parts"}
    reply = rpc.reply_to_dict(rpc.ReduceNextFileReply(next_file="mr-0-0"))
    assert set(reply) == {"next_file", "done"}
    full = rpc.ReduceNextFileReply(next_file="mr-0-0",
                                   peer_endpoint="http://h:1", peer_size=4,
                                   peer_checksum="aa")
    r2 = rpc.reply_to_dict(full)
    assert r2 == ref.reply_to_dict(ref.ReduceNextFileReply(
        next_file="mr-0-0", peer_endpoint="http://h:1", peer_size=4,
        peer_checksum="aa"))
    assert rpc.ReduceNextFileReply(**r2) == full


def test_status_advertises_peer_capability(tmp_path, monkeypatch):
    svc = GrepService(work_root=tmp_path / "svc", resume=False)
    try:
        assert svc.status()["peer"] is True
        monkeypatch.setenv("DGREP_PEER_SHUFFLE", "0")
        assert "peer" not in svc.status()
    finally:
        svc.stop()


# ------------------------------------------ a daemon job: the bytes receipt

def _spin_service(tmp_path, peer_on: bool, n_workers: int = 2,
                  transport_cls=ServiceHttpTransport):
    svc = GrepService(work_root=tmp_path / f"svc-{peer_on}", resume=False,
                      task_timeout_s=10.0, sweep_interval_s=0.2)
    server = ServiceServer(svc)
    server.start()
    addr = f"127.0.0.1:{server.port}"
    peers, loops = [], []
    for _ in range(n_workers):
        peer = PeerDataServer().start() if peer_on else None
        peers.append(peer)
        loop = WorkerLoop(transport_cls(addr, rpc_timeout_s=10.0), app=None,
                          peer=peer)
        loops.append(loop)
        threading.Thread(target=loop.run, daemon=True).start()
    return svc, server, addr, peers, loops


def _submit_and_wait(addr, cfg, timeout=60.0) -> dict:
    jid = client_call(addr, "POST", "/jobs", cfg.to_json().encode(),
                      timeout=10.0)["job_id"]
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        st = client_call(addr, "GET", f"/jobs/{jid}", timeout=10.0)
        if st["state"] in ("done", "failed", "cancelled"):
            assert st["state"] == "done", st
            return {**client_call(addr, "GET", f"/jobs/{jid}/result",
                                  timeout=10.0), "status": st}
        time.sleep(0.05)
    raise AssertionError("job did not finish")


def test_peer_job_byte_identical_with_daemon_bytes_zero(tmp_path, corpus):
    """The receipt: the peer and relay jobs' outputs equal each other and
    the reference's, the peer job's daemon data plane moved 0 shuffle
    bytes and its reducers fetched from the peers."""
    results = {}
    for peer_on in (True, False):
        svc, server, addr, peers, loops = _spin_service(tmp_path, peer_on)
        try:
            res = _submit_and_wait(addr, grep_config(corpus))
            status = client_call(addr, "GET", "/status", timeout=10.0)
            results[peer_on] = (
                outputs_by_name(res["outputs"]), dict(svc._shuffle_stats),
                sum(lp.metrics.counters.get("peer_fetches", 0)
                    for lp in loops),
                status, res["status"]["metrics"]["counters"])
        finally:
            svc.stop()
            server.shutdown()
            for p in peers:
                if p is not None:
                    p.close()
    outs_p, stats_p, fetches_p, status_p, counters_p = results[True]
    outs_r, stats_r, fetches_r, status_r, counters_r = results[False]
    assert outs_p == outs_r == ref_outputs(tmp_path, corpus) and outs_p
    assert stats_p["daemon_shuffle_bytes"] == 0
    assert fetches_p > 0 and counters_p["peer_fetches"] == fetches_p
    assert stats_r["daemon_shuffle_bytes"] > 0 and fetches_r == 0
    assert "peer_fetches" not in counters_r
    assert "shuffle" not in status_p
    assert status_r["shuffle"]["daemon_shuffle_bytes"] > 0
    endpoints = [row.get("data_endpoint")
                 for row in status_p["workers"].values()]
    assert all(e and e.startswith("http://") for e in endpoints)
    assert [r.get("data_endpoint")
            for r in status_r["workers"].values()] == [None, None]


class _Recorder(ServiceHttpTransport):
    """Records every control-plane payload a loop sends."""

    sent: list = []

    def _rpc(self, verb, payload):
        self.sent.append((verb, dict(payload)))
        return super()._rpc(verb, payload)


def test_peer_shuffle_off_payloads_equal_the_relay_protocol(
        tmp_path, corpus, monkeypatch):
    """DGREP_PEER_SHUFFLE=0: no server, /status without "peer", and every
    RPC payload of the job carries exactly the fields the reference's
    relay workers send (no peer key anywhere); with it on, the same job's
    payloads differ only by the peer riders."""

    def run(peer_on: bool, sub: str):
        _Recorder.sent = []
        svc, server, addr, peers, _loops = _spin_service(
            tmp_path / sub, peer_on, transport_cls=_Recorder)
        try:
            _submit_and_wait(addr, grep_config(corpus))
            return list(_Recorder.sent), client_call(addr, "GET", "/status")
        finally:
            svc.stop()
            server.shutdown()
            for p in peers:
                if p is not None:
                    p.close()

    monkeypatch.setenv("DGREP_PEER_SHUFFLE", "0")
    off, status_off = run(False, "off")
    assert "peer" not in status_off
    peer_keys = {"peer_endpoint", "peer_parts", "peer_size", "peer_checksum",
                 "lost_file"}
    relay_fields = {
        "AssignTask": {"worker_id"},
        "MapFinished": {"task_id", "job_id", "worker_id", "produced_parts",
                        "metrics"},
        "ReduceNextFile": {"task_id", "files_processed", "job_id", "epoch",
                           "worker_id"},
        "ReduceFinished": {"task_id", "job_id", "worker_id", "metrics",
                           "produced_parts"},
    }
    verbs = set()
    for verb, payload in off:
        verbs.add(verb)
        assert not peer_keys & set(payload), (verb, payload)
        if verb in relay_fields:
            assert set(payload) <= relay_fields[verb], (verb, payload)
    assert {"AssignTask", "MapFinished", "ReduceNextFile",
            "ReduceFinished"} <= verbs
    monkeypatch.delenv("DGREP_PEER_SHUFFLE")
    on, _status = run(True, "on")
    assert any("peer_endpoint" in p for v, p in on if v == "AssignTask")
    assert all(set(p["peer_parts"]) for v, p in on
               if v == "MapFinished" and p.get("produced_parts"))
    for verb, payload in on:
        extra = set(payload) - relay_fields.get(verb, set(payload))
        assert extra <= peer_keys, (verb, extra)


# ------------------------------------------- a lost output runs its map again

def test_scheduler_lost_output_reexecutes_map(tmp_path):
    from distributed_grep_tpu_torch.runtime import scheduler as sched_mod

    files = [tmp_path / "a.txt", tmp_path / "b.txt"]
    for f in files:
        f.write_text("hello\n")
    journal = TaskJournal(tmp_path / "journal.jsonl")
    health = WorkerHealth(base_s=30.0)
    phases_before = sched_mod._H_MAP_PHASE.snapshot()[2]
    sched = Scheduler(files=[str(f) for f in files], n_reduce=1,
                      task_timeout_s=30.0, sweep_interval_s=5.0,
                      journal=journal, worker_health=health)
    try:
        for _ in range(2):
            a = sched.assign_task(rpc.AssignTaskArgs(worker_id=0),
                                  timeout=1.0)
            assert a.assignment == rpc.Assignment.MAP
            sched.map_finished(rpc.TaskFinishedArgs(
                task_id=a.task_id, worker_id=0, produced_parts=[0],
                peer_endpoint="http://127.0.0.1:1",
                peer_parts={"0": [6, checksum(b"hello\n")]}))
        r = sched.reduce_next_file(rpc.ReduceNextFileArgs(
            task_id=0, files_processed=0, epoch=sched.epoch, worker_id=1),
            timeout=0.2)
        assert r.next_file == "mr-0-0"
        assert r.peer_endpoint == "http://127.0.0.1:1"
        assert r.peer_size == 6 and r.peer_checksum == checksum(b"hello\n")
        ra = sched.assign_task(rpc.AssignTaskArgs(worker_id=1), timeout=1.0)
        assert ra.assignment == rpc.Assignment.REDUCE and ra.task_id == 0
        r = sched.reduce_next_file(rpc.ReduceNextFileArgs(
            task_id=0, files_processed=0, epoch=sched.epoch, worker_id=1,
            lost_file="mr-0-0"), timeout=0.2)
        assert r.abort
        assert sched.map_tasks[0].state is TaskState.UNASSIGNED
        assert sched.map_tasks[0].peer is None
        assert sched.status_counts()["map"]["completed"] == 1
        assert sched.reduce_tasks[0].state is TaskState.UNASSIGNED
        assert health._fails.get(0) == 1  # the producer, charged once
        assert sched.counters["maps_lost_output"] == 1
        r2 = sched.reduce_next_file(rpc.ReduceNextFileArgs(
            task_id=0, files_processed=0, epoch=sched.epoch, worker_id=1,
            lost_file="mr-0-0"), timeout=0.2)
        assert not r2.abort
        assert health._fails.get(0) == 1
        a = sched.assign_task(rpc.AssignTaskArgs(worker_id=2), timeout=1.0)
        assert a.assignment == rpc.Assignment.MAP and a.task_id == 0
        sched.map_finished(rpc.TaskFinishedArgs(task_id=0, worker_id=2,
                                                produced_parts=[0]))
        assert sched.status_counts()["map"]["completed"] == 2
        # the map phase ended twice and was observed once
        assert sched_mod._H_MAP_PHASE.snapshot()[2] == phases_before + 1
        r = sched.reduce_next_file(rpc.ReduceNextFileArgs(
            task_id=0, files_processed=0, epoch=sched.epoch, worker_id=1),
            timeout=0.2)
        assert r.next_file == "mr-0-0" and not r.peer_endpoint
    finally:
        sched.stop()
        sched.close_journal()
    seen = [(e["kind"], e["task_id"])
            for e in TaskJournal.replay(tmp_path / "journal.jsonl")]
    assert len(seen) == len(set(seen))
    assert ("map_done", 0) in seen


def test_lost_report_of_a_relay_output_reruns_and_bogus_names_are_ignored(
        tmp_path):
    """A malformed or out-of-range name is ignored, as the reference
    ignores it.  A report against a relay-committed output re-runs its
    map, with no producer charged: the port's relay read reports a file
    gone from the store as lost (ROADMAP.md D10), where the reference
    ignores the report."""
    f = tmp_path / "a.txt"
    f.write_text("hello\n")
    health = WorkerHealth(base_s=30.0)
    sched = Scheduler(files=[str(f)], n_reduce=1, task_timeout_s=30.0,
                      sweep_interval_s=5.0, worker_health=health)
    try:
        a = sched.assign_task(rpc.AssignTaskArgs(worker_id=0), timeout=1.0)
        sched.map_finished(rpc.TaskFinishedArgs(
            task_id=a.task_id, worker_id=0, produced_parts=[0]))
        for bogus in ("not-a-name", "mr-99-0"):
            sched.reduce_next_file(rpc.ReduceNextFileArgs(
                task_id=0, files_processed=0, epoch=sched.epoch,
                lost_file=bogus), timeout=0.1)
        assert sched.map_tasks[0].state is TaskState.COMPLETED
        r = sched.reduce_next_file(rpc.ReduceNextFileArgs(
            task_id=0, files_processed=0, epoch=sched.epoch,
            lost_file="mr-0-0"), timeout=0.1)
        assert r.abort
        assert sched.map_tasks[0].state is TaskState.UNASSIGNED
        assert health._fails == {}
    finally:
        sched.stop()


def test_zombie_lost_report_fenced_by_epoch(tmp_path):
    f = tmp_path / "a.txt"
    f.write_text("hello\n")
    sched = Scheduler(files=[str(f)], n_reduce=1, task_timeout_s=30.0,
                      sweep_interval_s=5.0)
    try:
        a = sched.assign_task(rpc.AssignTaskArgs(worker_id=0), timeout=1.0)
        sched.map_finished(rpc.TaskFinishedArgs(
            task_id=a.task_id, worker_id=0, produced_parts=[0],
            peer_endpoint="http://127.0.0.1:1", peer_parts={"0": [1, "x"]}))
        r = sched.reduce_next_file(rpc.ReduceNextFileArgs(
            task_id=0, files_processed=0, epoch="deadbeefcafe",
            lost_file="mr-0-0"), timeout=0.1)
        assert r.abort
        assert sched.map_tasks[0].state is TaskState.COMPLETED
    finally:
        sched.stop()


def test_replay_registers_peer_metadata_from_the_commit_record(tmp_path):
    """A restarted scheduler takes a peer-held map's endpoint and
    checksums from its commit record, and serves them."""
    meta = {"endpoint": "http://127.0.0.1:1", "worker": 4,
            "parts": {"0": [6, checksum(b"hello\n")]}}
    sched = Scheduler(files=["a.txt"], n_reduce=1, task_timeout_s=30.0,
                      sweep_interval_s=5.0,
                      resume_entries=[{"kind": "map_done", "task_id": 0,
                                       "file": "a.txt", "parts": [0],
                                       "has_record": True}],
                      commit_resolver=lambda kind, tid: {"parts": [0],
                                                         "peer": meta})
    try:
        assert sched.map_tasks[0].peer == meta
        r = sched.reduce_next_file(rpc.ReduceNextFileArgs(
            task_id=0, files_processed=0, epoch=sched.epoch), timeout=0.1)
        assert (r.next_file, r.peer_endpoint, r.peer_size) == (
            "mr-0-0", "http://127.0.0.1:1", 6)
    finally:
        sched.stop()


# --------------------------------------------------------- the fetch legs

class _RelayOnlyTransport:
    def __init__(self, blobs: dict[str, bytes]):
        self.blobs = blobs

    def read_intermediate(self, name: str) -> bytes:
        return self.blobs[name]


def test_relay_fallback_on_dead_peer(monkeypatch):
    monkeypatch.setenv("DGREP_RPC_RETRIES", "0")
    data = b"relay copy\n"
    loop = WorkerLoop(_RelayOnlyTransport({"mr-0-0": data}), app=None)
    reply = rpc.ReduceNextFileReply(next_file="mr-0-0",
                                    peer_endpoint="http://127.0.0.1:1",
                                    peer_size=len(data),
                                    peer_checksum=checksum(data))
    assert loop._fetch_shuffle(reply) == data
    assert loop.metrics.counters["peer_fetch_failures"] == 1
    assert loop.metrics.counters["relay_fallbacks"] == 1


def test_checksum_mismatch_is_a_declared_failure(monkeypatch):
    srv = PeerDataServer().start()
    try:
        srv.put("j", "mr-0-0", b"corrupted bytes")

        class _NoRelay:
            def read_intermediate(self, name):
                raise RuntimeError("404")

        loop = WorkerLoop(_NoRelay(), app=None)
        loop._rpc_job_id = "j"
        reply = rpc.ReduceNextFileReply(next_file="mr-0-0",
                                        peer_endpoint=srv.endpoint,
                                        peer_size=5,
                                        peer_checksum="00000000")
        assert loop._fetch_shuffle(reply) is None
        assert loop.metrics.counters["peer_fetch_failures"] == 1
        # the producer's own spool serves the reducer without HTTP
        own = WorkerLoop(_NoRelay(), app=None, peer=srv)
        own._rpc_job_id = "j"
        good = rpc.ReduceNextFileReply(
            next_file="mr-0-0", peer_endpoint=srv.endpoint,
            peer_size=len(b"corrupted bytes"),
            peer_checksum=checksum(b"corrupted bytes"))
        assert own._fetch_shuffle(good) == b"corrupted bytes"
        assert own.metrics.counters["peer_fetches"] == 1
    finally:
        srv.close()


# ---------------------------------------------------------------- explain

def test_explain_summarizes_shuffle_route():
    from distributed_grep_tpu.runtime.explain import (
        summarize_events as ref_summarize,
    )

    events = [
        {"t": "instant", "name": "shuffle:peer", "ts": 1.0,
         "args": {"bytes": 100}},
        {"t": "instant", "name": "shuffle:peer", "ts": 2.0,
         "args": {"bytes": 50}},
    ]
    agg = summarize_events(events)
    assert agg["shuffle"] == {
        "peer_fetches": 2, "peer_bytes": 150, "relay_fetches": 0,
        "relay_fallbacks": 0, "lost_outputs": 0, "route": "peer"}
    events += [
        {"t": "instant", "name": "shuffle:relay", "ts": 3.0,
         "args": {"fallback": True}},
        {"t": "instant", "name": "map_lost_output", "ts": 4.0},
    ]
    agg = summarize_events(events)
    assert agg["shuffle"] == ref_summarize(events)["shuffle"]
    assert agg["shuffle"]["route"] == "mixed"
    assert agg["shuffle"]["relay_fallbacks"] == 1
    assert agg["shuffle"]["lost_outputs"] == 1
    assert summarize_events([
        {"t": "instant", "name": "shuffle:relay", "ts": 1.0},
    ])["shuffle"]["route"] == "relay"
    assert "shuffle" not in summarize_events([])


def test_peer_job_spans_explain_the_peer_route(tmp_path, corpus):
    """A peer job with spans on: its explain says the shuffle went peer
    to peer, from the workers' ``shuffle:peer`` instants."""
    svc = GrepService(work_root=tmp_path / "svc", resume=False, spans=True,
                      task_timeout_s=10.0, sweep_interval_s=0.2)
    server = ServiceServer(svc)
    server.start()
    addr = f"127.0.0.1:{server.port}"
    peers = [PeerDataServer().start() for _ in range(2)]
    for peer in peers:
        loop = WorkerLoop(ServiceHttpTransport(addr, rpc_timeout_s=10.0),
                          app=None, peer=peer, spans_enabled=True)
        threading.Thread(target=loop.run, daemon=True).start()
    try:
        res = _submit_and_wait(addr, grep_config(corpus))
        jid = res["status"]["job_id"]
        shuffle = client_call(addr, "GET",
                              f"/jobs/{jid}/explain")["routing"]["shuffle"]
        assert shuffle["route"] == "peer" and shuffle["peer_fetches"] > 0
        assert shuffle["relay_fetches"] == 0
    finally:
        svc.stop()
        server.shutdown()
        for p in peers:
            p.close()
