"""The service daemon's lifecycle event log, the fleet timeline (the
reference's runtime/daemon_log.py).

A job's ``events.jsonl`` records what happened inside that job; this log
records what the daemon itself decided: its start, resume and stop,
worker attaches and expiries, quarantine episodes, admission 429s, job
ends, lost-output re-runs.  ``DaemonLog`` writes each as one JSON line to
``<work_root>/daemon.jsonl`` (the task journal's mechanics: fsync a line,
a torn tail truncated at reopen), shared by every daemon incarnation over
the work root.  Each line is ``{"ts", "epoch", "pid", "role", "kind",
"payload"}`` (payload left out when empty).  The epoch and role are the
work-root lease's (runtime/lease.py) when the daemon holds one, epoch 0
and role "active" when it runs without one; a flush given the lease's
write gate drops a deposed daemon's batch.

Event sites run under the service's and the schedulers' locks, so
``stage()`` only appends to a list under a leaf lock of its own;
``flush()`` swaps the staged batch out and writes it under an io_ok lock,
from call sites that hold no other lock.  A flush given a write gate that
answers False drops its batch whole.

``DGREP_DAEMON_LOG=0``: ``serve`` builds no DaemonLog, so no file is
written and the service's hooks are never installed.
"""

from __future__ import annotations

import os
import time
from pathlib import Path

from distributed_grep_tpu_torch.runtime.journal import TaskJournal
from distributed_grep_tpu_torch.utils import event_audit, lockdep
from distributed_grep_tpu_torch.utils.logging import get_logger

log = get_logger("daemon_log")

FILENAME = "daemon.jsonl"


def env_daemon_log() -> bool:
    """DGREP_DAEMON_LOG: the daemon lifecycle log when serving; on by
    default, ``0`` disables it."""
    return os.environ.get("DGREP_DAEMON_LOG", "").strip() != "0"


class DaemonLog:
    """Staged-flush journal of daemon lifecycle events."""

    def __init__(self, work_root: str | Path, epoch: int = 0,
                 role: str = "active"):
        self.path = Path(work_root) / FILENAME
        self.pid = os.getpid()
        self.epoch = int(epoch)
        self.role = str(role)
        self._pending: list[dict] = []
        # the leaf staging lock (taken under the service and scheduler
        # locks), and the io_ok lock that orders swap and appends
        self._stage_lock = lockdep.make_lock("daemon-log")
        self._flush_lock = lockdep.make_lock("daemon-log-flush", io_ok=True)
        self._journal = TaskJournal(self.path)
        self._closed = False

    def set_identity(self, epoch: int, role: str) -> None:
        """Events staged from now on carry this (epoch, role)."""
        self.epoch = int(epoch)
        self.role = str(role)

    def stage(self, kind: str, **payload) -> None:
        """Stage one event: a list append under the leaf lock, callable
        under any lock (the fsync happens in flush())."""
        if event_audit.is_active():
            event_audit.record("daemon", kind)
        rec = {"ts": time.time(), "epoch": self.epoch, "pid": self.pid,
               "role": self.role, "kind": str(kind)}
        if payload:
            rec["payload"] = payload
        with self._stage_lock:
            self._pending.append(rec)

    def flush(self, gate=None) -> bool:
        """Write the staged events.  ``gate`` (None: no fence) is asked
        after the swap; False drops the batch whole.  Never raises: a full
        disk degrades the timeline, not the control plane."""
        with self._flush_lock:
            with self._stage_lock:
                if not self._pending:
                    return True
                pending, self._pending = self._pending, []
            if gate is not None and not gate():
                log.warning("daemon log flush fenced: %d staged events "
                            "dropped", len(pending))
                return False
            if self._closed:
                log.warning("daemon log closed: %d staged events dropped",
                            len(pending))
                return False
            for rec in pending:
                try:
                    self._journal.record(rec)
                except Exception:  # noqa: BLE001 -- telemetry, never fatal
                    log.exception("daemon log append failed")
        return True

    def append_now(self, kind: str, **payload) -> None:
        """Stage and flush in one call, for sites that hold no lock."""
        self.stage(kind, **payload)
        self.flush()

    def close(self) -> None:
        self.flush()
        with self._flush_lock:
            if not self._closed:
                self._closed = True
                self._journal.close()

    def discard(self) -> None:
        """Close without flushing: the staged events are dropped.  A no-op
        once closed."""
        with self._flush_lock:
            with self._stage_lock:
                self._pending.clear()
            if not self._closed:
                self._closed = True
                self._journal.close()

    @staticmethod
    def read(work_root: str | Path) -> list[dict]:
        """Every durable event of a work root (a torn tail left out),
        ordered by epoch, then time; [] without a file."""
        events = TaskJournal.replay(Path(work_root) / FILENAME)
        events.sort(key=lambda r: (r.get("epoch", 0), r.get("ts", 0.0)))
        return events
