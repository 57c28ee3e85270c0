"""Runtime lock-discipline harness (the reference's utils/lockdep.py).

The lock registries (the scheduler's, the model cache's, the corpus
cache's, the span pipeline's, the metrics instruments') construct their
locks through ``make_lock(name)``: a plain ``threading.Lock`` when the
harness is off (the default: nothing recorded, nothing wrapped), an
instrumented wrapper when it is on (``DGREP_LOCKDEP=1`` before the
process starts, or ``activate()`` from a test).  The wrapper records, per
thread, the stack of held locks and:

* **lock-order inversions**: every first-seen (held -> acquired) pair
  becomes an edge in a process-wide order graph, keyed by the lock's
  NAME (its class), not the instance; an edge that closes a cycle is
  recorded with its acquisition stack;
* **blocking calls while a lock is held**: while the harness is active,
  ``os.fsync``, ``os.replace``, ``os.rename``, ``time.sleep``,
  ``builtins.open`` and ``socket.create_connection`` are wrapped, and a
  call on a thread holding an instrumented lock not declared ``io_ok``
  is recorded.  ``io_ok`` declares a lock whose purpose is to serialize
  I/O (the journal flush, the event log, the model cache's build).

The harness never raises into instrumented code: findings accumulate in
``report()``.  ``threading.Condition(make_lock(...))`` works: Condition
aliases the wrapped ``acquire``/``release``, so the held stack stays
exact across ``cond.wait()``.
"""

from __future__ import annotations

import builtins
import os
import socket
import threading
import time
import traceback

_ENV_VAR = "DGREP_LOCKDEP"


def env_lockdep(default: bool = False) -> bool:
    """The ONE parser of DGREP_LOCKDEP: truthy ("1"/"true"/"yes") switches
    the harness on for locks constructed from then on."""
    raw = os.environ.get(_ENV_VAR)
    if raw is None or raw == "":
        return default
    return raw.strip().lower() not in ("0", "false", "no")


# ------------------------------------------------------------------ state
# The harness's own mutex is a RAW lock (never instrumented — it must not
# appear in the graph it maintains).
_state_lock = threading.Lock()
_tls = threading.local()  # .held: list[_TrackedLock], .busy: reentrancy

_active = 0  # activate() nesting count (env_lockdep() counts as one)
_edges: dict[tuple[str, str], dict] = {}  # (held, acquired) -> stacks
_inversions: list[dict] = []
_blocking: list[dict] = []
_patched: dict[str, object] = {}  # original syscalls while installed

_STACK_LIMIT = 16


def _stack() -> list[str]:
    """Compact acquisition stack, reentrancy-guarded: formatting reads
    source via linecache (which calls the possibly-patched open)."""
    _tls.busy = True
    try:
        frames = traceback.extract_stack(limit=_STACK_LIMIT)[:-2]
        return [f"{f.filename.rsplit('/', 1)[-1]}:{f.lineno}:{f.name}"
                for f in frames]
    finally:
        _tls.busy = False


def _held() -> list:
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


def _cycle_path(frm: str, to: str) -> list[str] | None:
    """A path frm -> ... -> to through the recorded edges, or None.
    Called under _state_lock."""
    stack = [(frm, [frm])]
    seen = {frm}
    while stack:
        node, path = stack.pop()
        for (a, b) in _edges:
            if a != node or b in seen and b != to:
                continue
            if b == to:
                return path + [b]
            seen.add(b)
            stack.append((b, path + [b]))
    return None


class _TrackedLock:
    """Instrumented threading.Lock stand-in (duck-typed: acquire/release/
    locked/__enter__/__exit__ — everything Condition and `with` need)."""

    def __init__(self, name: str, io_ok: bool = False, rlock: bool = False):
        self.name = name
        self.io_ok = io_ok
        self._l = threading.RLock() if rlock else threading.Lock()
        self._rlock = rlock
        self._depth_by_thread: dict[int, int] = {}

    # -- bookkeeping (called with the lock just acquired / about to drop)
    def _note_acquired(self) -> None:
        if self._rlock:
            me = threading.get_ident()
            with _state_lock:
                d = self._depth_by_thread.get(me, 0) + 1
                self._depth_by_thread[me] = d
            if d > 1:
                return  # reentrant re-acquire: not a new hold
        held = _held()
        # active() not _active: an env-enabled process (DGREP_LOCKDEP=1,
        # no fixture activate()) must record edges too
        if held and active():
            holder = held[-1]
            if holder is not self:
                key = (holder.name, self.name)
                # double-checked: the unlocked membership probe keeps the
                # steady state (edge already known — every acquisition
                # after the first) off the global state lock, or nested
                # acquires process-wide would serialize through it
                if key not in _edges:
                    with _state_lock:
                        if key not in _edges:
                            back = _cycle_path(self.name, holder.name)
                            _edges[key] = {"stack": _stack()}
                            if back is not None:
                                _inversions.append({
                                    "cycle": [holder.name] + back,
                                    "edge": key,
                                    "stack": _edges[key]["stack"],
                                })
        held.append(self)

    def _note_released(self) -> None:
        if self._rlock:
            me = threading.get_ident()
            with _state_lock:
                d = self._depth_by_thread.get(me, 1) - 1
                if d > 0:
                    self._depth_by_thread[me] = d
                    return
                self._depth_by_thread.pop(me, None)
        held = getattr(_tls, "held", None)
        if held:
            # remove by identity (releases are LIFO in practice, but a
            # Condition.wait on an outer lock releases out of order)
            for i in range(len(held) - 1, -1, -1):
                if held[i] is self:
                    del held[i]
                    break

    # -- the Lock surface
    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._l.acquire(blocking, timeout)
        if got:
            self._note_acquired()
        return got

    def release(self) -> None:
        self._note_released()
        self._l.release()

    def locked(self) -> bool:
        if self._rlock:
            # RLock has no locked(); "some thread holds it" is the
            # closest true answer the wrapper can give
            return bool(self._depth_by_thread)
        return self._l.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # diagnostics only
        return f"<TrackedLock {self.name!r} io_ok={self.io_ok}>"


def make_lock(name: str, io_ok: bool = False):
    """A lock for one of the named registries.  Off (the default): a raw
    ``threading.Lock`` — zero overhead, nothing recorded.  On: a tracked
    lock feeding the order graph.  ``io_ok=True`` declares that blocking
    I/O under this lock is the lock's PURPOSE (flush/compile/probe
    serialization) — the blocking-syscall detector skips it, and the
    static ``locked-blocking`` rule reads the same declaration."""
    if _active > 0 or env_lockdep():
        _ensure_patched()
        return _TrackedLock(name, io_ok=io_ok)
    return threading.Lock()


def make_rlock(name: str, io_ok: bool = False):
    """RLock variant of make_lock (reentrant holds count as one)."""
    if _active > 0 or env_lockdep():
        _ensure_patched()
        return _TrackedLock(name, io_ok=io_ok, rlock=True)
    return threading.RLock()


# -------------------------------------------------- blocking-syscall watch
def _non_io_held() -> "_TrackedLock | None":
    if getattr(_tls, "busy", False):
        return None
    # innermost non-io_ok hold wins: the report should name the critical
    # section actually enclosing the syscall
    for lk in reversed(getattr(_tls, "held", ())):
        if not lk.io_ok:
            return lk
    return None


def _record_blocking(call: str) -> None:
    lk = _non_io_held()
    if lk is None:
        return
    with _state_lock:
        _blocking.append({
            "call": call, "lock": lk.name, "stack": _stack(),
        })


def _wrap_syscall(label: str, fn):
    def wrapped(*a, **kw):
        _record_blocking(label)
        return fn(*a, **kw)

    wrapped.__lockdep_original__ = fn
    return wrapped


_SYSCALLS = (
    (os, "fsync"),
    (os, "replace"),
    (os, "rename"),
    (time, "sleep"),
    (builtins, "open"),
    (socket, "create_connection"),
)


def _ensure_patched() -> None:
    with _state_lock:
        if _patched:
            return
        for mod, attr in _SYSCALLS:
            label = f"{mod.__name__}.{attr}"
            orig = getattr(mod, attr)
            _patched[label] = (mod, attr, orig)
            setattr(mod, attr, _wrap_syscall(label, orig))


def _unpatch() -> None:
    with _state_lock:
        for mod, attr, orig in _patched.values():
            setattr(mod, attr, orig)
        _patched.clear()


# ------------------------------------------------------------- public API
def activate() -> None:
    """Switch the harness on for locks constructed from now on (nests)."""
    global _active
    with _state_lock:
        _active += 1
    _ensure_patched()


def deactivate() -> None:
    """Undo one activate().  At zero the syscall patches are removed;
    already-constructed tracked locks keep working (their recording is
    gated per event, and edges from them stay in the report until
    reset())."""
    global _active
    unpatch = False
    with _state_lock:
        _active = max(0, _active - 1)
        unpatch = _active == 0 and not env_lockdep()
    if unpatch:
        _unpatch()


def active() -> bool:
    return _active > 0 or env_lockdep()


def reset() -> None:
    """Drop every recorded edge/finding (test isolation)."""
    with _state_lock:
        _edges.clear()
        _inversions.clear()
        _blocking.clear()


def report() -> dict:
    """{"edges": {...}, "inversions": [...], "blocking": [...]} — the
    suite fixture asserts inversions == [] and blocking == []."""
    with _state_lock:
        return {
            "edges": {f"{a} -> {b}": dict(v) for (a, b), v in _edges.items()},
            "inversions": [dict(i) for i in _inversions],
            "blocking": [dict(b) for b in _blocking],
        }
