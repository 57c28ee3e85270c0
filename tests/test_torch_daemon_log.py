"""The port's daemon lifecycle log (distributed_grep_tpu_torch/runtime/
daemon_log.py) held to the reference's (tests/test_daemon_log.py's
first eight cases): the staged-flush round trip and its epoch order, a
fenced flush that drops its batch with the file's bytes unchanged, the
torn tail truncated at reopen, ``discard()``, the missing file, the
service's lifecycle on the timeline, and no file at all without a log.
Beyond them, the same events through both packages give the same
records, and each package reads the other's file.

The readers of the log: the fleet trace of two daemon incarnations (the
reference's golden, and byte for byte the reference's export and its
``trace-export --fleet`` stdout), the explain report's disruptions view
(the reference's windowing case), and a job's explain with and without
the log."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from distributed_grep_tpu_torch.ops import engine as engine_mod
from distributed_grep_tpu_torch.runtime.daemon_log import (
    FILENAME,
    DaemonLog,
    env_daemon_log,
)
from distributed_grep_tpu_torch.runtime.service import GrepService
from distributed_grep_tpu_torch.utils.config import JobConfig


@pytest.fixture(autouse=True)
def _fresh():
    engine_mod.model_cache_clear()
    yield
    engine_mod.model_cache_clear()


@pytest.mark.parametrize("raw,want", [(None, True), ("0", False),
                                      ("1", True), (" 0 ", False)])
def test_env_knob_parser(raw, want, monkeypatch):
    from distributed_grep_tpu.runtime.daemon_log import (
        env_daemon_log as ref_env,
    )

    monkeypatch.delenv("DGREP_DAEMON_LOG", raising=False)
    if raw is not None:
        monkeypatch.setenv("DGREP_DAEMON_LOG", raw)
    assert env_daemon_log() is want is ref_env()


def test_stage_flush_roundtrip_and_epoch_ordering(tmp_path):
    d1 = DaemonLog(tmp_path, epoch=1, role="active")
    d1.append_now("lease_acquire", addr="a:1")
    d1.stage("start", work_root=str(tmp_path))
    d1.stage("job_terminal", job="job-000001", state="done")
    assert d1.flush() is True
    d1.close()
    d2 = DaemonLog(tmp_path, epoch=2, role="active")
    d2.append_now("lease_steal", addr="a:2", prev_epoch=1)
    d2.close()
    events = DaemonLog.read(tmp_path)
    assert [(e["epoch"], e["kind"]) for e in events] == [
        (1, "lease_acquire"), (1, "start"), (1, "job_terminal"),
        (2, "lease_steal")]
    assert all(e["pid"] and e["role"] == "active" for e in events)
    assert events[2]["payload"] == {"job": "job-000001", "state": "done"}


def test_fence_drops_staged_batch_bytes_unchanged(tmp_path):
    d = DaemonLog(tmp_path, epoch=1, role="active")
    d.append_now("start")
    before = (tmp_path / FILENAME).read_bytes()
    d.stage("lease_lost")
    d.stage("stop")
    assert d.flush(gate=lambda: False) is False
    assert (tmp_path / FILENAME).read_bytes() == before
    assert d.flush() is True  # the fenced batch is gone, not re-staged
    assert (tmp_path / FILENAME).read_bytes() == before
    d.close()


def test_torn_tail_truncated_on_reopen(tmp_path):
    d = DaemonLog(tmp_path, epoch=1)
    d.append_now("start")
    d.close()
    path = tmp_path / FILENAME
    good = path.read_bytes()
    with path.open("ab") as f:
        f.write(b'{"ts": 1.0, "epoch": 1, "kind": "sto')
    assert DaemonLog.read(tmp_path) == [json.loads(good)]
    d2 = DaemonLog(tmp_path, epoch=2)
    d2.append_now("lease_steal", prev_epoch=1)
    d2.close()
    assert [e["kind"] for e in DaemonLog.read(tmp_path)] == [
        "start", "lease_steal"]


def test_discard_drops_staged_without_flush(tmp_path):
    d = DaemonLog(tmp_path, epoch=1)
    d.append_now("start")
    before = (tmp_path / FILENAME).read_bytes()
    d.stage("lease_lost")
    d.discard()
    assert (tmp_path / FILENAME).read_bytes() == before
    d.discard()  # idempotent


def test_read_missing_file_answers_empty(tmp_path):
    assert DaemonLog.read(tmp_path) == []


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_records_equal_the_references_and_read_across(writer, tmp_path):
    """One event sequence through each package: the same records (but for
    the time and the pid), and either package's ``read`` of either file
    gives the same list."""
    from distributed_grep_tpu.runtime.daemon_log import DaemonLog as RefLog

    def write(cls, root: Path) -> None:
        d = cls(root, epoch=3, role="active")
        d.stage("start", work_root="w", max_jobs=4, queue_depth=64)
        d.stage("worker_attach", worker=0)
        d.stage("job_terminal", job="job-1", state="failed", error="x")
        d.flush()
        d.append_now("stop")
        d.close()

    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    write(DaemonLog, tmp_path / "port")
    write(RefLog, tmp_path / "ref")

    def strip(events):
        return [{k: v for k, v in e.items() if k not in ("ts", "pid")}
                for e in events]

    assert strip(DaemonLog.read(tmp_path / "port")) == strip(
        RefLog.read(tmp_path / "ref"))
    root = tmp_path / ("port" if writer == "port" else "ref")
    assert DaemonLog.read(root) == RefLog.read(root)


def _tiny_cfg(tmp_path: Path) -> JobConfig:
    p = tmp_path / "in.txt"
    if not p.exists():
        p.write_text("hello\nmiss\n")
    return JobConfig(input_files=[str(p)],
                     app_options={"pattern": "hello", "device": "cpu"},
                     n_reduce=1)


def test_service_lifecycle_lands_on_timeline(tmp_path):
    root = tmp_path / "svc"
    svc = GrepService(work_root=root, daemon_log=DaemonLog(root),
                      task_timeout_s=5.0, sweep_interval_s=0.1)
    try:
        jid = svc.submit(_tiny_cfg(tmp_path))
        svc.start_local_workers(1)
        assert svc.wait_job(jid, timeout=60), svc.job_status(jid)
        rows = svc.status()["workers"]
        assert rows and all("last_event_age_s" in r for r in rows.values())
    finally:
        svc.stop()
    events = DaemonLog.read(root)
    kinds = [e["kind"] for e in events]
    assert kinds[0] == "start"
    assert "worker_attach" in kinds
    assert kinds[-1] == "stop"
    assert [(e["payload"]["job"], e["payload"]["state"]) for e in events
            if e["kind"] == "job_terminal"] == [(jid, "done")]


def test_daemon_log_off_is_true_noop(tmp_path):
    root = tmp_path / "svc"
    svc = GrepService(work_root=root, task_timeout_s=5.0,
                      sweep_interval_s=0.1)
    try:
        jid = svc.submit(_tiny_cfg(tmp_path))
        svc.start_local_workers(1)
        assert svc.wait_job(jid, timeout=60), svc.job_status(jid)
        assert "daemon" not in svc.status()
    finally:
        svc.stop()
    assert not (root / FILENAME).exists()


# ------------------------------------------------------- fleet trace

def _two_incarnation_root(root: Path, cls=DaemonLog) -> Path:
    """A failover written to ``root``: epoch 1 serves and dies (no stop
    line), epoch 2 parks, steals, promotes, serves a job and stops."""
    root.mkdir(parents=True, exist_ok=True)
    d1 = cls(root, epoch=1, role="active")
    d1.append_now("lease_acquire", addr="h:1")
    d1.stage("start", work_root=str(root))
    d1.flush()
    d1.close()
    d2 = cls(root, epoch=2, role="active")
    d2.stage("standby_park", parked_s=1.5)
    d2.append_now("lease_steal", addr="h:2", prev_epoch=1)
    d2.append_now("promoted", addr="h:2", failover_s=2.25, running=1,
                  queued=0)
    d2.stage("job_terminal", job="job-000001", state="done")
    d2.append_now("stop")
    d2.close()
    return root


def test_fleet_trace_two_incarnations_golden(tmp_path):
    from distributed_grep_tpu.utils.spans import (
        export_fleet_trace as ref_export,
    )
    from distributed_grep_tpu_torch.utils.spans import export_fleet_trace

    root = _two_incarnation_root(tmp_path / "root")
    jobs = {"job-000001": [{"t": "span", "name": "map:compute", "ts": 10.0,
                            "dur": 0.5, "worker": 0, "args": {}}]}
    doc = export_fleet_trace(DaemonLog.read(root), jobs=jobs)
    assert json.dumps(doc) == json.dumps(ref_export(DaemonLog.read(root),
                                                    jobs=jobs))
    evs = doc["traceEvents"]
    pnames = {e["pid"]: e["args"]["name"] for e in evs
              if e["ph"] == "M" and e["name"] == "process_name"}
    assert pnames[1] == "dgrep daemon fleet"
    assert pnames[2] == "dgrep job job-000001"
    tnames = [e["args"]["name"] for e in evs if e["ph"] == "M"
              and e["name"] == "thread_name" and e["pid"] == 1]
    assert any(n.startswith("daemon epoch 1") for n in tnames)
    assert any(n.startswith("daemon epoch 2") for n in tnames)
    spans = {e["name"]: e for e in evs if e["ph"] == "X" and e["pid"] == 1}
    assert "lease epoch 1" in spans and "lease epoch 2" in spans
    assert spans["promotion"]["args"]["failover_s"] == 2.25
    instants = {e["name"] for e in evs if e["ph"] == "i" and e["pid"] == 1}
    assert {"lease_acquire", "start", "standby_park", "lease_steal",
            "promoted", "job_terminal", "stop"} <= instants


def test_trace_export_fleet_cli_prints_the_references(tmp_path, capsys):
    """``trace-export --fleet`` of a service work root (a job's events
    beside its daemon.jsonl), and of its daemon.jsonl path: the
    reference's stdout; a root without the log exits 2 in both."""
    from distributed_grep_tpu.__main__ import main as ref_main
    from distributed_grep_tpu_torch.__main__ import main
    from distributed_grep_tpu_torch.utils.spans import EventLog

    root = _two_incarnation_root(tmp_path / "root")
    log = EventLog(root / "job-000001" / "events.jsonl", fresh=True)
    log.write_many([{"t": "span", "name": "map:task", "ts": 11.0,
                     "dur": 0.25, "worker": 0, "job": "job-000001"},
                    {"t": "instant", "name": "scale_advice", "ts": 12.0}])
    log.close()
    for target in (root, root / FILENAME):
        assert ref_main(["trace-export", "--fleet", str(target)]) == 0
        want = capsys.readouterr().out
        assert main(["trace-export", "--fleet", str(target)]) == 0
        assert capsys.readouterr().out == want
    out = tmp_path / "fleet.json"
    assert main(["trace-export", "--fleet", str(root), "-o", str(out)]) == 0
    assert out.read_text() + "\n" == want


def test_disruptions_view_windowing():
    from distributed_grep_tpu.runtime.explain import (
        disruptions_view as ref_view,
    )
    from distributed_grep_tpu_torch.runtime.explain import disruptions_view

    ev = [
        {"ts": 5.0, "epoch": 1, "kind": "start"},
        {"ts": 12.0, "epoch": 1, "kind": "quarantine",
         "payload": {"worker": 0}},
        {"ts": 13.0, "epoch": 1, "kind": "map_lost_output",
         "payload": {"job": "job-000001", "task": 3}},
        {"ts": 13.5, "epoch": 1, "kind": "map_lost_output",
         "payload": {"job": "job-OTHER", "task": 1}},
        {"ts": 14.0, "epoch": 2, "kind": "promoted",
         "payload": {"failover_s": 2.5}},
        {"ts": 15.0, "epoch": 2, "kind": "resume"},
        {"ts": 99.0, "epoch": 2, "kind": "quarantine"},
    ]
    view = disruptions_view(ev, "job-000001", submitted_at=10.0,
                            finished_at=20.0)
    assert view == {"quarantines": 1, "lost_outputs": 1,
                    "daemon_restarts": 1, "failovers": 1,
                    "max_failover_s": 2.5}
    assert view == ref_view(ev, "job-000001", submitted_at=10.0,
                            finished_at=20.0)
    assert "daemon_restarts" not in disruptions_view(
        ev[:1], "job-000001", submitted_at=5.0, finished_at=20.0)
    assert disruptions_view(ev, "job-000001", submitted_at=50.0,
                            finished_at=60.0) == {"lost_outputs": 1}
    assert disruptions_view(ev, "job-000099", submitted_at=50.0,
                            finished_at=60.0) == {}
    assert disruptions_view([], "job-000001") == {}


def test_job_explain_reads_the_timeline_only_when_it_is_on(tmp_path):
    """A daemon restart while a job runs is a disruption in its report;
    without a daemon log the report has no such section."""
    root = tmp_path / "svc"
    svc = GrepService(work_root=root, daemon_log=DaemonLog(root),
                      task_timeout_s=5.0, sweep_interval_s=0.1)
    try:
        jid = svc.submit(_tiny_cfg(tmp_path))
        DaemonLog(root).append_now("resume", jobs=1, running=1, queued=0)
        svc.start_local_workers(1)
        assert svc.wait_job(jid, timeout=60), svc.job_status(jid)
        assert svc.job_explain(jid)["disruptions"] == {"daemon_restarts": 1}
    finally:
        svc.stop()
    svc = GrepService(work_root=tmp_path / "off", task_timeout_s=5.0,
                      sweep_interval_s=0.1)
    try:
        jid = svc.submit(_tiny_cfg(tmp_path))
        svc.start_local_workers(1)
        assert svc.wait_job(jid, timeout=60)
        assert "disruptions" not in svc.job_explain(jid)
    finally:
        svc.stop()
