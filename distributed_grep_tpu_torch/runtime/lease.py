"""The work-root lease: the active/standby election (the reference's
runtime/lease.py).

One JSON file, ``<work_root>/LEASE``, names the daemon allowed to write
the work root's durable state (the ``jobs.jsonl`` registry, the per-job
task journals, the follow logs, ``daemon.jsonl``).  The active creates it
with ``O_EXCL``, renews it every ``DGREP_LEASE_RENEW_S`` seconds, and a
standby steals it once its ``renewed`` stamp is older than
``DGREP_LEASE_TTL_S``: a temp file and ``os.replace``, the epoch bumped
and a fresh random token.

Ownership is the (epoch, token) pair: the epoch orders incarnations (a
deposed active that comes back sees a larger epoch than its own), the
token tells two stealers of one instant apart (both replace, the last
writer wins, the loser's re-read finds another token).  Taking the lease
is advisory; writing under it is not: every registry and journal flush
batch asks ``verify()`` before it writes, so a deposed active's late
batch is dropped whole, never interleaved with the new active's lines.

Staleness compares ``time.time()`` deltas on one host (the active and the
standby share the work root's file system); renewals come at a third of
the TTL by default.

The lease's mutex is a lockdep lock ``"lease"`` with ``io_ok`` (its
purpose is to serialize the lease file's I/O), and the lease is never
touched under the service lock: the fence runs in the io_ok flush locks
(registry flush, journal flush), in flush context only.
"""

from __future__ import annotations

import json
import os
import secrets
import threading
import time
from pathlib import Path

from distributed_grep_tpu_torch.utils import lockdep
from distributed_grep_tpu_torch.utils.logging import get_logger

log = get_logger("lease")

LEASE_FILENAME = "LEASE"

_DEFAULT_TTL_S = 10.0


def env_lease_ttl_s(default: float = _DEFAULT_TTL_S) -> float:
    """DGREP_LEASE_TTL_S: seconds without a renewal after which a lease
    may be stolen (malformed or <= 0 keeps the default: a zero TTL would
    make every lease stealable at once)."""
    raw = os.environ.get("DGREP_LEASE_TTL_S")
    if raw is None or raw == "":
        return default
    try:
        val = float(raw)
    except ValueError:
        return default
    return val if val > 0 else default


def env_lease_renew_s(default: float | None = None) -> float:
    """DGREP_LEASE_RENEW_S: the active's renewal and the standby's poll
    period; a third of the TTL by default (malformed or <= 0 keeps it)."""
    raw = os.environ.get("DGREP_LEASE_RENEW_S")
    fallback = default if default is not None else env_lease_ttl_s() / 3.0
    if raw is None or raw == "":
        return fallback
    try:
        val = float(raw)
    except ValueError:
        return fallback
    return val if val > 0 else fallback


def lease_configured() -> bool:
    """True when DGREP_LEASE_TTL_S is set: ``serve`` then contends for the
    lease as ``serve --standby`` does.  A daemon with neither writes no
    lease file."""
    return bool(os.environ.get("DGREP_LEASE_TTL_S"))


class WorkRootLease:
    """The lease file of one work root.  Unacquired (``epoch == 0``),
    held (``verify()`` true), or lost (a later incarnation replaced the
    file: ``verify()`` and every ``renew()`` false)."""

    def __init__(self, work_root: str | Path, *, addr: str = "",
                 ttl_s: float | None = None):
        self.work_root = Path(work_root)
        self.path = self.work_root / LEASE_FILENAME
        self.addr = addr
        self.ttl_s = float(ttl_s) if ttl_s is not None else env_lease_ttl_s()
        self.epoch = 0
        self.token = ""
        self._mutex = lockdep.make_lock("lease", io_ok=True)
        self._renew_stop: threading.Event | None = None
        self._renew_thread: threading.Thread | None = None

    # ------------------------------------------------------------ file I/O
    @staticmethod
    def read(work_root: str | Path) -> dict | None:
        """The lease record, or None (no file, or a torn one).  A standby
        reads the active's address here for its /status."""
        path = Path(work_root) / LEASE_FILENAME
        try:
            doc = json.loads(path.read_text("utf-8"))
        except (OSError, ValueError):
            return None
        return doc if isinstance(doc, dict) else None

    def _payload(self, renewed: float) -> dict:
        return {"epoch": self.epoch, "token": self.token,
                "renewed": renewed, "addr": self.addr}

    def _write_replace(self) -> None:
        """A temp file and os.replace: a reader sees the old record or the
        new one, never a torn one."""
        tmp = self.path.with_name(
            f".{LEASE_FILENAME}.tmp.{os.getpid()}.{self.token[:8]}")
        tmp.write_text(json.dumps(self._payload(time.time()),
                                  sort_keys=True), "utf-8")
        os.replace(tmp, self.path)

    # ----------------------------------------------------------- lifecycle
    def acquire(self) -> bool:
        """Take the lease: create it when absent, steal it when stale.
        False while a live active holds it (the caller stands by)."""
        with self._mutex:
            self.work_root.mkdir(parents=True, exist_ok=True)
            token = secrets.token_hex(16)
            try:
                fd = os.open(self.path, os.O_WRONLY | os.O_CREAT | os.O_EXCL,
                             0o644)
            except FileExistsError:
                pass
            else:
                self.epoch, self.token = 1, token
                payload = json.dumps(self._payload(time.time()),
                                     sort_keys=True).encode("utf-8")
                try:
                    os.write(fd, payload)
                finally:
                    os.close(fd)
                log.info("lease acquired at %s (epoch %d)", self.path,
                         self.epoch)
                return True
            current = self.read(self.work_root)
            if current is None:
                # a torn or unreadable record is stale: replace it
                stale = True
                old_epoch = 0
            else:
                stale = (time.time() - float(current.get("renewed", 0.0))
                         > self.ttl_s)
                old_epoch = int(current.get("epoch", 0))
            if not stale:
                return False
            # steal: the epoch bumped, a fresh token, replaced atomically,
            # then read back (of two stealers, the surviving token won)
            self.epoch, self.token = old_epoch + 1, token
            self._write_replace()
            after = self.read(self.work_root)
            if after is None or after.get("token") != self.token:
                self.epoch, self.token = 0, ""
                return False
            log.info("lease stolen at %s (epoch %d after stale epoch %d)",
                     self.path, self.epoch, old_epoch)
            return True

    def renew(self) -> bool:
        """Refresh the ``renewed`` stamp; False, writing nothing, when the
        record on disk is no longer ours (deposed: the winner's record is
        never overwritten)."""
        with self._mutex:
            if not self.token:
                return False
            current = self.read(self.work_root)
            if (current is None or current.get("token") != self.token
                    or int(current.get("epoch", -1)) != self.epoch):
                return False
            self._write_replace()
            return True

    def verify(self) -> bool:
        """The write fence: does the record on disk still name us?"""
        if not self.token:
            return False
        current = self.read(self.work_root)
        return (current is not None
                and current.get("token") == self.token
                and int(current.get("epoch", -1)) == self.epoch)

    def release(self) -> None:
        """The graceful handoff: delete the lease when it is still ours, so
        a standby takes over at its next poll instead of after the TTL."""
        self.stop_renewal()
        with self._mutex:
            if not self.token:
                return
            current = self.read(self.work_root)
            if current is not None and current.get("token") == self.token:
                try:
                    self.path.unlink()
                except OSError:
                    pass
            self.epoch, self.token = 0, ""

    # ------------------------------------------------------------- renewal
    def start_renewal(self, on_lost, on_renew=None,
                      interval_s: float | None = None) -> None:
        """A thread that renews every ``interval_s`` (DGREP_LEASE_RENEW_S
        by default); a failed renewal calls ``on_lost()`` once and ends
        it.  ``on_renew()`` runs after each renewal (the service's worker
        table snapshot, which a promoted daemon seeds its table from)."""
        if self._renew_thread is not None:
            return
        period = interval_s if interval_s is not None else env_lease_renew_s()
        stop = threading.Event()

        def _loop() -> None:
            while not stop.wait(period):
                if not self.renew():
                    log.warning("lease lost at %s (our epoch %d)", self.path,
                                self.epoch)
                    try:
                        on_lost()
                    except Exception:  # noqa: BLE001 -- logged
                        log.exception("lease on_lost callback failed")
                    return
                if on_renew is not None:
                    try:
                        on_renew()
                    except Exception:  # noqa: BLE001 -- logged
                        log.exception("lease on_renew callback failed")

        self._renew_stop = stop
        self._renew_thread = threading.Thread(target=_loop,
                                              name="lease-renew", daemon=True)
        self._renew_thread.start()

    def stop_renewal(self) -> None:
        if self._renew_stop is not None:
            self._renew_stop.set()
        t = self._renew_thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=10)
        self._renew_stop = None
        self._renew_thread = None
