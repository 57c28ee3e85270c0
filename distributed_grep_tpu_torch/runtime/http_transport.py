"""The worker side of the HTTP control and data planes (the reference's
runtime/http_transport.py, without its multi-host JAX init).

``HttpTransport`` implements the Transport protocol (runtime/transport.py)
over urllib.  Transient errors (a refused or reset connection, a body cut
short) are retried DGREP_RPC_RETRIES times with jittered exponential
backoff from DGREP_RPC_BACKOFF_S; after the last, ``CoordinatorGone``,
which the worker loop takes as the job's end.  Retrying is safe: task
effects commit through idempotent per-task commit records and the
scheduler absorbs duplicate completions.  An HTTP error status is the
server's answer and is never retried.

An address may be a comma-separated list (the active daemon and its
standbys, runtime/lease.py): every retry moves to the next address, and
so does a 503, the parked standby's answer (it registered nothing, and
the real daemon never sends one), so a worker or client whose active
died follows the promoted standby inside its retry schedule.  A single
address keeps the strict rule.

``fetch_peer_data`` (and ``HttpTransport.fetch_peer``) reads a peer-held
shuffle file from the worker that produced it (runtime/peer.py) through
the same retry loop: the peer gone after the schedule raises
CoordinatorGone, an HTTP error status RuntimeError, the reducer's
declared failures.

``ServiceHttpTransport`` is the same against the service daemon
(runtime/service.py): its data plane is scoped by job,
``/data/<job>/<kind>/<name>``, following the worker's assignment
(``bind_job``), so one attach serves a stream of jobs.

``run_http_worker`` is the ``worker`` subcommand: it asks each address's
``/status`` once; when every one that answers is a parked standby
(``"role": "standby"``) it waits and asks again, until one promotes (a
worker process may take longer to start than a lease's TTL, so it
attaches whenever the active is).  It fetches the job config from the
active, asks its ``/status`` whether the address is a service daemon
(``"service": true``: its config names a default application, and each
assignment its own), loads the application, checks the job's device when the
application uses one (runtime/job.job_device; an application that
launches no kernel never asks for the card) and runs ``n_parallel`` task
loops in the process, under the profiler when DGREP_TRACE_DIR is set and
with the span pipeline when the config switches it on.  A loop that fails with
anything but CoordinatorGone makes the process exit nonzero with that
error; the coordinator re-issues its task to a live worker.  Attached to
a service daemon whose ``/status`` says ``"peer": true``, the process
starts one ``PeerDataServer`` its loops share (DGREP_PEER_SHUFFLE=0: none;
a server that cannot bind leaves the loops on the relay data plane,
logged).  Every
request names the worker (``X-Dgrep-Worker``: a token a run_http_worker
call, by default one a process):
a coordinator whose job ended serves on until each worker process that
attached while it ran has polled once and been told JOB_DONE.  A worker
that attaches to a job already done (``"done": true``) or to a stopping
daemon (``"stopped": true``) exits at once (ROADMAP.md C9); a standby's
park answer is neither.

``split_addrs``, ``client_call`` and ``client_text`` are the CLI's
clients (``submit``, ``status``, ``explain``, ``top``).
"""

from __future__ import annotations

import errno
import http.client
import itertools
import json
import os
import random
import shutil
import tempfile
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from pathlib import Path

from distributed_grep_tpu_torch.runtime import rpc
from distributed_grep_tpu_torch.utils.config import JobConfig
from distributed_grep_tpu_torch.utils.metrics import PROC_TOKEN
from distributed_grep_tpu_torch.utils.logging import get_logger

log = get_logger("http_transport")

DEFAULT_RPC_RETRIES = 6
DEFAULT_RPC_BACKOFF_S = 0.5
_RETRY_SLEEP_CAP_S = 5.0


def env_rpc_retries(default: int = DEFAULT_RPC_RETRIES) -> int:
    """DGREP_RPC_RETRIES: transient retries a call (0: none; malformed or
    negative keeps the default)."""
    raw = os.environ.get("DGREP_RPC_RETRIES")
    if raw is None or raw == "":
        return default
    try:
        v = int(raw)
    except ValueError:
        return default
    return v if v >= 0 else default


def env_rpc_backoff_s(default: float = DEFAULT_RPC_BACKOFF_S) -> float:
    """DGREP_RPC_BACKOFF_S: the first retry's backoff (malformed or <= 0
    keeps the default)."""
    raw = os.environ.get("DGREP_RPC_BACKOFF_S")
    if raw is None or raw == "":
        return default
    try:
        v = float(raw)
    except ValueError:
        return default
    return v if v > 0 else default


def retry_delays():
    """A call's backoff sleeps: env_rpc_retries() of them, doubling from
    env_rpc_backoff_s(), capped, each times a 0.5-1.5 jitter draw (workers
    retrying after one coordinator restart do not hit it in lockstep)."""
    base = env_rpc_backoff_s()
    for i in range(env_rpc_retries()):
        yield min(_RETRY_SLEEP_CAP_S, base * (2 ** i)) * random.uniform(0.5,
                                                                         1.5)


# "The peer may be gone, or the connection broke": retried.  HTTPError is
# handled before these at every site (the server answered).
TRANSIENT_ERRORS = (OSError, http.client.HTTPException)


class CoordinatorGone(OSError):
    """The coordinator stopped answering (the retry schedule ran dry)."""


# a worker's name in its requests (http_coordinator.WORKER_HEADER)
_WORKER_HEADER = "X-Dgrep-Worker"
_WORKER_TOKEN = str(int(PROC_TOKEN))


def split_addrs(addr: str) -> list[str]:
    """The members of a comma-separated address list."""
    return [a.strip() for a in str(addr).split(",") if a.strip()]


def _base_urls(addr: str) -> list[str]:
    bases = [(a if a.startswith("http") else f"http://{a}").rstrip("/")
             for a in split_addrs(addr)]
    if not bases:
        raise ValueError(f"no coordinator address in {addr!r}")
    return bases


def _open_with_retries(build_request, timeout: float, desc: str,
                       on_retry=None, deadline: float | None = None,
                       delays=None, rotate_on_503: bool = False) -> bytes:
    """The one transient-retry loop of every JSON-over-HTTP call: urlopen
    a freshly built request, retry TRANSIENT_ERRORS on the jittered
    schedule, raise CoordinatorGone when it runs dry.  HTTPError passes
    through, except a 503 with ``rotate_on_503`` (an address list: a
    parked standby's answer), which steps through the same schedule and
    re-raises when it runs dry.  ``on_retry`` runs before each retry's
    sleep (the address rotation rides it).  ``deadline`` (monotonic)
    bounds the whole call, retries included."""
    if delays is None:
        delays = retry_delays()
    while True:
        attempt_timeout = timeout
        if deadline is not None:
            attempt_timeout = max(0.5, min(timeout,
                                           deadline - time.monotonic()))
        try:
            with urllib.request.urlopen(build_request(),
                                        timeout=attempt_timeout) as resp:
                return resp.read()
        except urllib.error.HTTPError as e:
            if not (rotate_on_503 and e.code == 503):
                raise
            delay = next(delays, None)
            if delay is None or (deadline is not None
                                 and time.monotonic() + delay >= deadline):
                raise
            if on_retry is not None:
                on_retry()
            time.sleep(delay)
        except TRANSIENT_ERRORS as e:
            delay = next(delays, None)
            if delay is None or (deadline is not None
                                 and time.monotonic() + delay >= deadline):
                raise CoordinatorGone(f"{desc}: {e}") from e
            log.info("%s: %s; retrying in %.2f s", desc, e, delay)
            if on_retry is not None:
                on_retry()
            time.sleep(delay)


def fetch_peer_data(endpoint: str, job_id: str, name: str,
                    timeout: float = 30.0, on_retry=None) -> bytes:
    """One peer-held shuffle file, ``GET <endpoint>/shuffle/<job>/<name>``
    from a worker's PeerDataServer, through the retry loop.  Raises
    CoordinatorGone when the schedule runs dry (the peer is gone) and
    RuntimeError on an HTTP error status (the peer answered: a 404 is a
    spool entry gone, not a worker)."""
    base = endpoint if endpoint.startswith("http") else f"http://{endpoint}"
    url = (f"{base.rstrip('/')}/shuffle/"
           f"{urllib.parse.quote(job_id or '_', safe='')}/"
           f"{urllib.parse.quote(name, safe='')}")
    try:
        return _open_with_retries(lambda: urllib.request.Request(url),
                                  timeout, f"GET {url}", on_retry)
    except urllib.error.HTTPError as e:
        raise RuntimeError(f"GET {url} -> {e.code}") from e


class HttpTransport:
    def __init__(self, addr: str, rpc_timeout_s: float = 60.0,
                 worker_token: str = _WORKER_TOKEN):
        # addr: "host:port", "http://host:port", or a comma-separated list
        # of them (the module docstring); rpc_timeout_s is the client
        # socket timeout (the coordinator long-polls for half of it)
        self._bases = _base_urls(addr)
        self._base_i = 0
        self.rpc_timeout_s = rpc_timeout_s
        self.worker_token = worker_token
        self.retry_count = 0  # transient retries so far

    @property
    def base(self) -> str:
        """The address in rotation; every request reads it an attempt."""
        return self._bases[self._base_i]

    def _count_retry(self) -> None:
        self.retry_count += 1
        if len(self._bases) > 1:
            # before the backoff's sleep: the next attempt dials the next
            # address
            self._base_i = (self._base_i + 1) % len(self._bases)

    def _sleep_or_give_up(self, delays, desc: str, err: Exception) -> None:
        delay = next(delays, None)
        if delay is None:
            raise CoordinatorGone(f"{desc}: {err}") from err
        log.info("%s: %s; retrying in %.2f s", desc, err, delay)
        self._count_retry()
        time.sleep(delay)

    def _standby_or_raise(self, delays, err, desc: str) -> None:
        """A streamed leg's HTTP error: over an address list a 503 (a parked
        standby) moves to the next address on the retry schedule, as
        _request's legs do; anything else, or a dry schedule, raises
        RuntimeError."""
        if len(self._bases) > 1 and err.code == 503:
            delay = next(delays, None)
            if delay is not None:
                self._count_retry()
                time.sleep(delay)
                return
        raise RuntimeError(
            f"{desc} -> {err.code}: {err.read()[:200]!r}") from err

    def _request(self, method: str, path: str,
                 body: bytes | None = None) -> bytes:
        def build():
            req = urllib.request.Request(f"{self.base}{path}", data=body,
                                         method=method)
            if body is not None:
                req.add_header("Content-Type", "application/json")
            req.add_header(_WORKER_HEADER, self.worker_token)
            return req

        try:
            return _open_with_retries(build, self.rpc_timeout_s,
                                      f"{method} {path}", self._count_retry,
                                      rotate_on_503=len(self._bases) > 1)
        except urllib.error.HTTPError as e:
            raise RuntimeError(
                f"{method} {path} -> {e.code}: {e.read()[:200]!r}") from e

    def _rpc(self, verb: str, payload: dict) -> dict:
        return json.loads(self._request(
            "POST", f"/rpc/{verb}", json.dumps(payload).encode("utf-8")))

    # ------------------------------------------------------ control plane
    def assign_task(self, args: rpc.AssignTaskArgs) -> rpc.AssignTaskReply:
        return rpc.AssignTaskReply(**self._rpc(rpc.Verb.ASSIGN_TASK,
                                               rpc.to_dict(args)))

    def map_finished(self, args: rpc.TaskFinishedArgs
                     ) -> rpc.TaskFinishedReply:
        return rpc.TaskFinishedReply(**self._rpc(rpc.Verb.MAP_FINISHED,
                                                 rpc.to_dict(args)))

    def reduce_finished(self, args: rpc.TaskFinishedArgs
                        ) -> rpc.TaskFinishedReply:
        return rpc.TaskFinishedReply(**self._rpc(rpc.Verb.REDUCE_FINISHED,
                                                 rpc.to_dict(args)))

    def reduce_next_file(self, args: rpc.ReduceNextFileArgs
                         ) -> rpc.ReduceNextFileReply:
        return rpc.ReduceNextFileReply(**self._rpc(rpc.Verb.REDUCE_NEXT_FILE,
                                                   rpc.to_dict(args)))

    def heartbeat(self, args: rpc.HeartbeatArgs) -> float | None:
        """An advisory stamp that never raises; the round trip of the POST
        that landed, or None.  A plain stamp is tried once (a missed one
        costs at most a sweep window); a grace stamp three times, since a
        lost declaration costs the whole silent phase it covers.  A retry
        stamps ``sent_at`` anew (the span batch keeps its number, so the
        coordinator still persists it once)."""
        attempts = 3 if args.grace_s > 0 else 1
        for i in range(attempts):
            if args.sent_at > 0:
                args.sent_at = time.time()
            body = json.dumps(rpc.to_dict(args)).encode("utf-8")
            try:
                req = urllib.request.Request(
                    f"{self.base}/rpc/{rpc.Verb.HEARTBEAT}", data=body,
                    method="POST")
                req.add_header("Content-Type", "application/json")
                t0 = time.monotonic()
                with urllib.request.urlopen(req, timeout=5.0):
                    return time.monotonic() - t0
            except Exception:  # noqa: BLE001 -- advisory by contract
                if i + 1 < attempts:
                    time.sleep(0.5)
        return None

    # --------------------------------------------------------- data plane
    @staticmethod
    def _data_path(kind: str, name: str) -> str:
        return f"/data/{kind}/{urllib.parse.quote(name, safe='')}"

    def read_input(self, filename: str) -> bytes:
        return self._request("GET", self._data_path("input", filename))

    def read_input_path(self, filename: str):
        """(local path, is_temp): stream the split to a spool file, so the
        worker never holds the whole input (streaming apps then scan it in
        chunks).  A body cut short (an error, or fewer bytes than its
        Content-Length) resumes with a Range request; a 200 to it
        restarts the spool.  The spool's directory: DGREP_SPOOL_DIR,
        else the system temp dir."""
        delays = retry_delays()
        tmp = tempfile.NamedTemporaryFile(
            prefix="dgrep-in-", dir=os.environ.get("DGREP_SPOOL_DIR") or None,
            delete=False)
        try:
            while True:
                url = f"{self.base}{self._data_path('input', filename)}"
                try:
                    req = urllib.request.Request(url)
                    got = tmp.tell()
                    if got:
                        req.add_header("Range", f"bytes={got}-")
                    with urllib.request.urlopen(
                            req, timeout=self.rpc_timeout_s) as resp:
                        if got and resp.status != 206:
                            tmp.seek(0)
                            tmp.truncate()
                        start = tmp.tell()
                        length = int(resp.headers.get("Content-Length", -1))
                        shutil.copyfileobj(resp, tmp, length=1 << 20)
                        # a peer that closes mid-body ends read(n) early
                        # without an error: count, and resume the rest
                        if length >= 0 and tmp.tell() - start != length:
                            raise http.client.IncompleteRead(
                                b"", length - (tmp.tell() - start))
                    tmp.close()
                    return Path(tmp.name), True
                except urllib.error.HTTPError as e:
                    self._standby_or_raise(delays, e, f"GET {url}")
                except TRANSIENT_ERRORS as e:
                    # a full or read-only spool disk is no liveness failure
                    if isinstance(e, OSError) and e.errno in (
                            errno.ENOSPC, errno.EDQUOT, errno.EROFS):
                        raise
                    self._sleep_or_give_up(delays, f"GET {url}", e)
        except BaseException:
            tmp.close()
            os.unlink(tmp.name)
            raise

    def write_intermediate(self, name: str, data: bytes) -> None:
        self._request("PUT", self._data_path("intermediate", name), data)

    def read_intermediate(self, name: str) -> bytes:
        return self._request("GET", self._data_path("intermediate", name))

    def fetch_peer(self, endpoint: str, job_id: str, name: str) -> bytes:
        """A peer-held shuffle file (fetch_peer_data), as a transport
        method so FaultTransport can inject on this leg."""
        return fetch_peer_data(endpoint, job_id, name,
                               timeout=self.rpc_timeout_s,
                               on_retry=self._count_retry)

    def write_output(self, name: str, data: bytes) -> None:
        self._request("PUT", self._data_path("out", name), data)

    def publish_task_commit(self, kind: str, task_id: int, attempt: str,
                            payload: dict) -> None:
        """The per-task commit record, on the coordinator's store, sent
        before the finished RPC."""
        self._request("PUT",
                      self._data_path("commit", f"{kind}-{task_id}.{attempt}"),
                      json.dumps(payload).encode("utf-8"))

    def write_output_from_file(self, name: str, path: str) -> None:
        """A streaming PUT of a local file (an output larger than memory
        commits without being held); each retry reopens the file."""
        size = os.path.getsize(path)
        delays = retry_delays()
        while True:
            url = f"{self.base}{self._data_path('out', name)}"
            try:
                with open(path, "rb") as f:
                    req = urllib.request.Request(url, data=f, method="PUT")
                    req.add_header("Content-Length", str(size))
                    with urllib.request.urlopen(req,
                                                timeout=self.rpc_timeout_s):
                        return
            except urllib.error.HTTPError as e:
                self._standby_or_raise(delays, e, f"PUT {url}")
            except TRANSIENT_ERRORS as e:
                self._sleep_or_give_up(delays, f"PUT {url}", e)

    # ---------------------------------------------------------- bootstrap
    def fetch_config(self) -> JobConfig:
        return JobConfig.from_json(self._request("GET", "/config"))

    def fetch_status(self) -> dict:
        return json.loads(self._request("GET", "/status"))


class ServiceHttpTransport(HttpTransport):
    """HttpTransport against the service daemon: the control plane is the
    same, the data plane is scoped to the job of the worker's assignment
    (``bind_job``, called by the worker loop)."""

    def __init__(self, addr: str, rpc_timeout_s: float = 60.0,
                 worker_token: str = _WORKER_TOKEN):
        super().__init__(addr, rpc_timeout_s=rpc_timeout_s,
                         worker_token=worker_token)
        self._job = ""

    def bind_job(self, job_id: str) -> None:
        self._job = job_id

    def _data_path(self, kind: str, name: str) -> str:
        if not self._job:
            return super()._data_path(kind, name)
        return (f"/data/{urllib.parse.quote(self._job, safe='')}"
                f"/{kind}/{urllib.parse.quote(name, safe='')}")


def _client_open(addr: str, method: str, path: str, body: bytes | None,
                 timeout: float, retry: bool) -> bytes:
    """client_call's and client_text's request: over an address list each
    retry (a transient failure, or a standby's 503) dials the next
    address."""
    bases = _base_urls(addr)
    state = {"i": 0}

    def build():
        req = urllib.request.Request(f"{bases[state['i']]}{path}", data=body,
                                     method=method)
        if body is not None:
            req.add_header("Content-Type", "application/json")
        return req

    def rotate():
        state["i"] = (state["i"] + 1) % len(bases)

    desc = f"{method} {addr}{path}"
    if retry:
        return _open_with_retries(build, timeout, desc, on_retry=rotate,
                                  deadline=time.monotonic() + timeout,
                                  rotate_on_503=len(bases) > 1)
    return _open_with_retries(build, timeout, desc, delays=iter(()))


def client_call(addr: str, method: str, path: str, body: bytes | None = None,
                timeout: float = 30.0, retry: bool = True) -> dict:
    """One JSON-over-HTTP call with the transport's retry policy, bounded
    by ``timeout`` in all; ``retry=False`` makes it single-shot (for a
    request a duplicate delivery could change).  An HTTP error status
    raises HTTPError at once, but a 503 over an address list moves to the
    next address (the module docstring)."""
    return json.loads(_client_open(addr, method, path, body, timeout, retry))


def client_text(addr: str, path: str, timeout: float = 30.0) -> str:
    """client_call's sibling for a text body (``/metrics``, which ``top``
    reads): the same retry policy and rotation, the body decoded utf-8."""
    return _client_open(addr, "GET", path, None, timeout, True).decode(
        "utf-8", "replace")


_ATTACHES = itertools.count()


def run_http_worker(addr: str, n_parallel: int = 1) -> None:
    """The ``worker`` subcommand: fetch the job's config from the
    coordinator (a service daemon's bootstrap: each assignment then names
    its job and application), load the application, join the process
    group when ``MASTER_ADDR`` names one (parallel/multihost.py), check
    its device when it uses one
    (CUDA asked for where there is none raises, naming it: nothing scans
    on the host instead), build the host library and run ``n_parallel``
    task loops in this process.  Returns when the job is over or the
    coordinator is gone; raises the first error of a loop that failed
    otherwise."""
    from distributed_grep_tpu_torch.apps.loader import load_application
    from distributed_grep_tpu_torch.parallel import multihost
    from distributed_grep_tpu_torch.runtime.job import job_device
    from distributed_grep_tpu_torch.runtime.worker import WorkerLoop
    from distributed_grep_tpu_torch.utils import native
    from distributed_grep_tpu_torch.utils import spans as spans_mod
    from distributed_grep_tpu_torch.utils import trace

    # the start's legs, logged once the worker is ready: where a worker
    # process's seconds before its first task go
    marks = [("entry", time.perf_counter())]
    addr = _find_active(addr)
    log.info("worker for %s: fetching the job's config", addr)
    # this attach's name: the coordinator serves on after the job's end
    # until it has polled once
    token = f"{_WORKER_TOKEN}-{next(_ATTACHES)}"
    transport = HttpTransport(addr, worker_token=token)
    try:
        config = transport.fetch_config()
    except CoordinatorGone:
        log.error("no coordinator at %s", addr)
        raise SystemExit(1)
    # a service daemon answers {"service": true} at /status: its data
    # plane is scoped by job, and each assignment names its application
    try:
        status = transport.fetch_status()
    except (OSError, RuntimeError, ValueError):
        status = {}  # a coordinator without /status
    if status.get("done") or status.get("stopped"):
        # the job (or the daemon) is over: nothing to load, nothing to do
        log.info("worker for %s: the %s is over, exiting", addr,
                 "daemon" if status.get("stopped") else "job")
        return
    is_service = bool(status.get("service"))
    if is_service:
        log.info("attached to a service daemon at %s", addr)
    transport_cls = ServiceHttpTransport if is_service else HttpTransport
    marks.append(("config", time.perf_counter()))
    app = load_application(config.application)
    marks.append(("app", time.perf_counter()))
    device = job_device(app, config.app_options)
    # a mesh spanning processes: join the process group (MASTER_ADDR and
    # the rest; none is one process) before anything touches CUDA, as the
    # reference's runtime/http_transport.py:579-582 does
    multihost.init_distributed(device=device or "cpu")
    if device is not None:
        from distributed_grep_tpu_torch.utils.device import resolve_device

        resolve_device(device)  # raises, naming the device
    marks.append(("device", time.perf_counter()))
    native.lib()  # before any task: a task's detector never waits on g++
    marks.append(("host library", time.perf_counter()))
    spans_on = spans_mod.enabled(config.spans)
    peer = _start_peer(status) if is_service else None
    log.info("worker for %s: %d slots on %s; start: %s", addr, n_parallel,
             device or "the host backend",
             ", ".join(f"{name} {t - t_prev:.3f} s" for (_n, t_prev),
                       (name, t) in zip(marks, marks[1:])))
    errors: list[BaseException] = []
    ended = threading.Event()  # a loop failed, or every loop returned
    live = [n_parallel]
    lock = threading.Lock()

    def run_loop(slot: int) -> None:
        loop = WorkerLoop(
            transport_cls(addr, rpc_timeout_s=config.rpc_timeout_s,
                          worker_token=token), app,
            reduce_memory_bytes=config.reduce_memory_bytes,
            # the coordinator's spill path may not exist here: honoured
            # only when set
            spill_dir=config.spill_dir,
            # the coordinator's config decides: it is the one that
            # persists the spans
            spans_enabled=spans_on, job_id=config.effective_job_id(),
            peer=peer)
        try:
            loop.run()
        except CoordinatorGone:
            log.info("slot %d: coordinator gone, exiting", slot)
        except BaseException as e:  # noqa: BLE001 -- re-raised below
            log.error("slot %d failed: %r", slot, e)
            errors.append(e)
            ended.set()
        finally:
            with lock:
                live[0] -= 1
                if not live[0]:
                    ended.set()

    # daemon threads: a failed loop ends the process without waiting for
    # the others' tasks, which the coordinator re-issues
    try:
        with trace.job_trace(device=device):
            for i in range(n_parallel):
                threading.Thread(target=run_loop, args=(i,),
                                 name=f"slot-{i}", daemon=True).start()
            ended.wait()
    finally:
        if peer is not None:
            peer.close()
    log.info("worker for %s: %s", addr,
             f"failed: {errors[0]!r}" if errors else "every slot ended")
    if errors:
        raise errors[0]


def _find_active(addr: str, park_s: float = 2.0) -> str:
    """The address list reordered with the first daemon that is not a
    parked standby first (each address's /status asked once,
    single-shot).  While every address that answers is a standby, wait
    ``park_s`` and ask again: one promotes within its lease's TTL.  When
    none answers, the list as it was (fetching the config then runs the
    retry schedule dry)."""
    bases = split_addrs(addr)
    while True:
        saw_standby = False
        for b in bases:
            try:
                st = client_call(b, "GET", "/status", timeout=5.0,
                                 retry=False)
            except (OSError, ValueError):
                continue
            if st.get("role") == "standby":
                saw_standby = True
                continue
            return ",".join([b] + [o for o in bases if o != b])
        if not saw_standby:
            return addr
        log.info("every daemon of %s answers standby; waiting for one to "
                 "promote", addr)
        time.sleep(park_s)


def _start_peer(status: dict):
    """The process's PeerDataServer (runtime/peer.py) when the daemon
    offers the peer shuffle (``"peer": true``) and DGREP_PEER_SHUFFLE is
    on, else None; a server that cannot bind leaves the relay data plane
    (logged)."""
    from distributed_grep_tpu_torch.runtime.peer import (
        PeerDataServer,
        env_peer_shuffle,
    )

    if not (status.get("peer") and env_peer_shuffle()):
        return None
    try:
        return PeerDataServer().start()
    except OSError:
        log.exception("peer data server failed to start; relay shuffle")
        return None
