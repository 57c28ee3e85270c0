"""utils/lockdep.py, the runtime lock-discipline harness: the reference's
cases (tests/test_lockdep.py), each run against both packages' copies,
and the port's own lock registries under DGREP_LOCKDEP=1."""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from distributed_grep_tpu.utils import lockdep as ref_lockdep
from distributed_grep_tpu_torch.utils import lockdep as port_lockdep

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(params=[port_lockdep, ref_lockdep],
                ids=["port", "reference"])
def lockdep(request):
    """A fresh, activated harness of one package, leaving the process as
    found (patched calls restored)."""
    mod = request.param
    mod.activate()
    mod.reset()
    yield mod
    mod.deactivate()
    mod.reset()


def test_make_lock_is_raw_when_off(lockdep, monkeypatch):
    monkeypatch.delenv("DGREP_LOCKDEP", raising=False)
    lockdep.deactivate()  # undo the fixture's activation for this test
    try:
        assert not lockdep.active()
        assert isinstance(lockdep.make_lock("off-test"),
                          type(threading.Lock()))
        assert isinstance(lockdep.make_rlock("off-test"),
                          type(threading.RLock()))
    finally:
        lockdep.activate()  # the fixture's teardown pairs with this


def test_seeded_inversion_is_detected(lockdep):
    a = lockdep.make_lock("inv-a")
    b = lockdep.make_lock("inv-b")
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    report = lockdep.report()
    assert "inv-a -> inv-b" in report["edges"]
    assert "inv-b -> inv-a" in report["edges"]
    (inv,) = report["inversions"]
    assert set(inv["edge"]) == {"inv-a", "inv-b"}
    assert inv["stack"]


def test_consistent_order_is_clean(lockdep):
    a = lockdep.make_lock("ord-a")
    b = lockdep.make_lock("ord-b")
    for _ in range(3):
        with a:
            with b:
                pass
    report = lockdep.report()
    assert report["inversions"] == []
    assert "ord-a -> ord-b" in report["edges"]


def test_cross_thread_inversion_is_detected(lockdep):
    a = lockdep.make_lock("xt-a")
    b = lockdep.make_lock("xt-b")

    def t1():
        with a:
            with b:
                pass

    def t2():
        with b:
            with a:
                pass

    for fn in (t1, t2):
        th = threading.Thread(target=fn)
        th.start()
        th.join()
    assert len(lockdep.report()["inversions"]) == 1


def test_blocking_call_while_held(lockdep, tmp_path):
    lk = lockdep.make_lock("blk")
    (tmp_path / "f").write_text("x")  # outside the lock: not an event
    before = len(lockdep.report()["blocking"])
    with lk:
        time.sleep(0)
    events = lockdep.report()["blocking"][before:]
    assert any(e["lock"] == "blk" and "sleep" in e["call"] for e in events)


def test_fsync_while_held_and_io_ok_escape(lockdep, tmp_path):
    hot = lockdep.make_lock("hot")
    io = lockdep.make_lock("flush", io_ok=True)
    with open(tmp_path / "f", "w") as f:
        f.write("x")
        f.flush()
        with hot:
            os.fsync(f.fileno())
        with io:
            os.fsync(f.fileno())
    events = lockdep.report()["blocking"]
    assert any(e["lock"] == "hot" and "fsync" in e["call"] for e in events)
    assert not any(e["lock"] == "flush" for e in events)


def test_io_ok_inner_under_hot_outer_still_reports(lockdep):
    hot = lockdep.make_lock("outer-hot")
    io = lockdep.make_lock("inner-io", io_ok=True)
    with hot:
        with io:
            time.sleep(0)
    assert any(e["lock"] == "outer-hot"
               for e in lockdep.report()["blocking"])


def test_condition_wait_releases_the_held_entry(lockdep):
    lk = lockdep.make_lock("cond-lock")
    cond = threading.Condition(lk)
    hit = []

    def waiter():
        with cond:
            cond.wait(timeout=5)
            hit.append(len(getattr(lockdep._tls, "held", [])))

    th = threading.Thread(target=waiter)
    th.start()
    time.sleep(0.1)
    with cond:
        cond.notify_all()
    th.join(timeout=5)
    assert hit == [1]  # held again (tracked) when wait returned
    assert lockdep.report()["blocking"] == []


def test_nonblocking_acquire_failure_records_nothing(lockdep):
    lk = lockdep.make_lock("nb")
    with lk:
        assert not lk.acquire(False)
    assert lockdep.report()["inversions"] == []


def test_rlock_reentry_is_one_hold(lockdep):
    rl = lockdep.make_rlock("re")
    other = lockdep.make_lock("re-other")
    with rl:
        with rl:
            with other:
                pass
    report = lockdep.report()
    assert report["inversions"] == []
    assert "re -> re-other" in report["edges"]


def test_env_knob_parser(lockdep, monkeypatch):
    monkeypatch.delenv("DGREP_LOCKDEP", raising=False)
    assert not lockdep.env_lockdep()
    monkeypatch.setenv("DGREP_LOCKDEP", "1")
    assert lockdep.env_lockdep()
    monkeypatch.setenv("DGREP_LOCKDEP", "false")
    assert not lockdep.env_lockdep()


def test_a_job_under_the_harness_is_clean(tmp_path):
    """The port's scheduler, event log and span pipeline built under the
    harness run a spans-on job with no inversion and no blocking call
    under a lock that is not io_ok; the scheduler's journal flush takes
    the scheduler's lock inside it, the recorded order."""
    from distributed_grep_tpu_torch.runtime.job import run_job
    from distributed_grep_tpu_torch.utils.config import JobConfig

    port_lockdep.activate()
    port_lockdep.reset()
    try:
        files = []
        for i in range(3):
            p = tmp_path / f"f{i}.txt"
            p.write_text("needle\nhay\n" * (20 + i))
            files.append(str(p))
        run_job(JobConfig(input_files=files, n_reduce=2, spans=True,
                          work_dir=str(tmp_path / "w"),
                          app_options={"pattern": "needle", "device": "cpu"}),
                n_workers=2)
        report = port_lockdep.report()
    finally:
        port_lockdep.deactivate()
        port_lockdep.reset()
    assert report["inversions"] == []
    assert report["blocking"] == []
    assert {"journal-flush -> scheduler", "scheduler -> worker-health"} <= set(
        report["edges"])


def test_env_enabled_run_instruments_the_port_registries():
    """DGREP_LOCKDEP=1 before the process starts instruments the locks the
    port's modules build at import (the model cache, the corpus cache) and
    the scheduler's, which the per-test activation cannot reach."""
    code = (
        "from distributed_grep_tpu_torch.utils import lockdep\n"
        "assert lockdep.active()\n"
        "from distributed_grep_tpu_torch.ops import engine, layout\n"
        "from distributed_grep_tpu_torch.runtime.scheduler import Scheduler\n"
        "s = Scheduler(files=['a'], n_reduce=1)\n"
        "for lk, io_ok in ((engine._model_cache_lock, True),\n"
        "                  (layout.corpus_cache()._lock, False),\n"
        "                  (s._lock, False), (s._journal_flush_lock, True),\n"
        "                  (s._span_seq_lock, False),\n"
        "                  (s.worker_health._lock, False)):\n"
        "    assert isinstance(lk, lockdep._TrackedLock), lk\n"
        "    assert lk.io_ok is io_ok, lk\n"
        "with engine._model_cache_lock:\n"
        "    with layout.corpus_cache()._lock:\n"
        "        pass\n"
        "s.stop()\n"
        "rep = lockdep.report()\n"
        "assert 'model-cache -> corpus-cache' in rep['edges'], rep\n"
        "import sys\n"
        "assert 'jax' not in sys.modules\n"
        "print('registries instrumented')\n")
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
        env={**os.environ, "DGREP_LOCKDEP": "1", "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr
    assert "registries instrumented" in out.stdout
