"""The kernel build's grace: a scan that must first build its libraries
declares the silent time to the task's failure detector, so a build
longer than the task timeout does not get the task re-issued."""

import time

import pytest

from distributed_grep_tpu_torch.ops import _build, device_scan
from distributed_grep_tpu_torch.runtime.job import run_job
from distributed_grep_tpu_torch.runtime import rpc
from distributed_grep_tpu_torch.runtime.scheduler import Scheduler
from distributed_grep_tpu_torch.utils.config import JobConfig
from tests.test_torch_job import ENGINE_OPTS, corpus  # noqa: F401

TIMEOUT_S = 2.0
BUILD_S = 5.0


@pytest.mark.parametrize("grace", [True, False], ids=["grace", "no grace"])
def test_slow_first_build_is_not_retried(tmp_path, corpus, monkeypatch,
                                         grace):
    """The first scan's build sleeps past the task timeout.  With the
    grace the job ends with no retry; with the declaration taken out
    (a grace of 0 s) the other worker's sweep re-issues the task."""
    builds = []

    def unbuilt(names, device):
        return [] if builds else list(names)  # one build, then built

    def build_all(names):
        builds.append(names)
        time.sleep(BUILD_S)

    monkeypatch.setattr(_build, "unbuilt", unbuilt)
    monkeypatch.setattr(_build, "build_all", build_all)
    if not grace:
        monkeypatch.setattr(device_scan, "BUILD_GRACE_S", 0.0)
    res = run_job(JobConfig(
        input_files=corpus[:1],
        app_options={"pattern": "volcano", **ENGINE_OPTS},
        task_timeout_s=TIMEOUT_S, n_reduce=2,
        work_dir=str(tmp_path / "job")), n_workers=2, device="cpu")
    counters = res.metrics["counters"]
    assert builds == [("shift_and",)]
    if grace:
        assert counters.get("map_retries", 0) == 0
        assert counters["grace_declared"] == 1
    else:
        assert counters["map_retries"] >= 1
        assert "grace_declared" not in counters
    assert sum(1 for _ in res.iter_results()) > 0


@pytest.mark.parametrize("grace", [True, False], ids=["grace", "no grace"])
def test_slow_first_build_over_http(tmp_path, corpus, monkeypatch, grace):
    """The same over the HTTP control plane: the worker process's task
    declares the grace through the heartbeat RPC (two slots, so the other
    slot's poll would take a re-issued task)."""
    from distributed_grep_tpu_torch.runtime.http_coordinator import (
        CoordinatorServer,
    )
    from distributed_grep_tpu_torch.runtime.http_transport import (
        run_http_worker,
    )

    builds = []

    def unbuilt(names, device):
        return [] if builds else list(names)

    def build_all(names):
        builds.append(names)
        time.sleep(BUILD_S)

    monkeypatch.setattr(_build, "unbuilt", unbuilt)
    monkeypatch.setattr(_build, "build_all", build_all)
    if not grace:
        monkeypatch.setattr(device_scan, "BUILD_GRACE_S", 0.0)
    server = CoordinatorServer(JobConfig(
        input_files=corpus[:1],
        app_options={"pattern": "volcano", "device": "cpu", **ENGINE_OPTS},
        task_timeout_s=TIMEOUT_S, sweep_interval_s=0.2, n_reduce=2,
        coordinator_port=0, work_dir=str(tmp_path / "job")))
    server.start()
    try:
        run_http_worker(f"127.0.0.1:{server.port}", n_parallel=2)
        assert server.wait_done(timeout=5.0)
        counters = server.status()["counters"]
    finally:
        server.shutdown(linger_s=0.0)
    assert builds == [("shift_and",)]
    if grace:
        assert counters.get("map_retries", 0) == 0
        assert counters["grace_declared"] == 1
    else:
        assert counters["map_retries"] >= 1
        assert "grace_declared" not in counters
    assert any(p.stat().st_size for p in (tmp_path / "job" / "out").glob(
        "mr-out-*"))


def test_slow_host_build_is_done_before_the_first_task(tmp_path, corpus,
                                                      monkeypatch):
    """The host library (csrc/dgrep.cpp, g++) is not yet loaded and its
    build sleeps past the task timeout: the job builds it before the
    scheduler hands out a task, so no task is re-issued."""
    real = _build.build_host
    builds = []

    def build_host(names=_build.HOST_SOURCES):
        builds.append(tuple(names))
        time.sleep(BUILD_S)
        real(names)

    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "build_host", build_host)
    res = run_job(JobConfig(
        input_files=corpus[:1],
        app_options={"pattern": "volcano", **ENGINE_OPTS},
        task_timeout_s=TIMEOUT_S, n_reduce=2,
        work_dir=str(tmp_path / "job")), n_workers=2, device="cpu")
    assert builds == [("dgrep",)]
    assert res.metrics["counters"].get("map_retries", 0) == 0
    assert sum(1 for _ in res.iter_results()) > 0


def test_unbuilt_names_the_host_library_on_either_device(tmp_path,
                                                         monkeypatch):
    import torch

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    for device in ("cpu", "cuda"):
        assert _build.unbuilt(("dgrep",), torch.device(device)) == ["dgrep"]
    _build.build_host()
    assert _build.unbuilt(("dgrep",), torch.device("cpu")) == []


def test_grace_lasts_until_the_next_stamp(monkeypatch):
    sched = Scheduler(files=["f"], n_reduce=1, task_timeout_s=1.0,
                      sweep_interval_s=3600.0)
    clock = [100.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    a = sched.assign_task(rpc.AssignTaskArgs(), timeout=0)
    assert a.assignment == rpc.Assignment.MAP
    sched.heartbeat("map", 0, grace_s=30.0)
    clock[0] += 20.0  # inside the grace, past the timeout
    assert not sched.sweep()
    assert sched.assign_task(rpc.AssignTaskArgs(), timeout=0).task_id == -2
    assert sched.counters.get("map_retries", 0) == 0
    sched.heartbeat("map", 0)  # a plain stamp ends the grace
    clock[0] += 2.0
    assert sched.sweep()
    b = sched.assign_task(rpc.AssignTaskArgs(), timeout=0)
    assert b.assignment == rpc.Assignment.MAP and b.task_id == a.task_id
    assert sched.counters["map_retries"] == 1
    sched.stop()


def test_unbuilt_names_nothing_on_the_cpu():
    import torch

    assert _build.unbuilt(_build.SOURCES, torch.device("cpu")) == []
