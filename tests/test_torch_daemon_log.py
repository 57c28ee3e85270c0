"""The port's daemon lifecycle log (distributed_grep_tpu_torch/runtime/
daemon_log.py) held to the reference's (tests/test_daemon_log.py's
first eight cases): the staged-flush round trip and its epoch order, a
fenced flush that drops its batch with the file's bytes unchanged, the
torn tail truncated at reopen, ``discard()``, the missing file, the
service's lifecycle on the timeline, and no file at all without a log.
Beyond them, the same events through both packages give the same
records, and each package reads the other's file.

The fleet trace (``trace-export --fleet``) and the explain report's
disruptions view read this log in slice 3b (ROADMAP.md item 5b)."""

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
