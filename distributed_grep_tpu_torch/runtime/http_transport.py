"""The worker side of the HTTP control and data planes (the reference's
runtime/http_transport.py, without the service transport, the peer fetch
and the multi-host init).

``HttpTransport`` implements the Transport protocol (runtime/transport.py)
over urllib.  Transient errors (a refused or reset connection, a body cut
short) are retried DGREP_RPC_RETRIES times with jittered exponential
backoff from DGREP_RPC_BACKOFF_S; after the last, ``CoordinatorGone``,
which the worker loop takes as the job's end.  Retrying is safe: task
effects commit through idempotent per-task commit records and the
scheduler absorbs duplicate completions.  An HTTP error status is the
server's answer and is never retried.

``run_http_worker`` is the ``worker`` subcommand: it fetches the job
config, loads the application, checks the job's device when the
application uses one (runtime/job.job_device; an application that
launches no kernel never asks for the card) and runs ``n_parallel`` task
loops in the process, under the profiler when DGREP_TRACE_DIR is set and
with the span pipeline when the config switches it on.  A loop that fails with
anything but CoordinatorGone makes the process exit nonzero with that
error; the coordinator re-issues its task to a live worker.
"""

from __future__ import annotations

import errno
import http.client
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


def _base_url(addr: str) -> str:
    addr = addr.strip()
    if not addr:
        raise ValueError("no coordinator address")
    return (addr if addr.startswith("http") else f"http://{addr}").rstrip("/")


def _open_with_retries(build_request, timeout: float, desc: str,
                       on_retry=None, deadline: float | None = None,
                       delays=None) -> bytes:
    """The one transient-retry loop of every JSON-over-HTTP call: urlopen
    a freshly built request, retry TRANSIENT_ERRORS on the jittered
    schedule, raise CoordinatorGone when it runs dry.  HTTPError passes
    through.  ``deadline`` (monotonic) bounds the whole call, retries
    included."""
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
        except urllib.error.HTTPError:
            raise
        except TRANSIENT_ERRORS as e:
            delay = next(delays, None)
            if delay is None or (deadline is not None
                                 and time.monotonic() + delay >= deadline):
                raise CoordinatorGone(f"{desc}: {e}") from e
            log.info("%s: %s; retrying in %.2f s", desc, e, delay)
            if on_retry is not None:
                on_retry()
            time.sleep(delay)


class HttpTransport:
    def __init__(self, addr: str, rpc_timeout_s: float = 60.0):
        # addr: "host:port" or "http://host:port"; rpc_timeout_s is the
        # client socket timeout (the coordinator long-polls for half of it)
        self.base = _base_url(addr)
        self.rpc_timeout_s = rpc_timeout_s
        self.retry_count = 0  # transient retries so far

    def _count_retry(self) -> None:
        self.retry_count += 1

    def _sleep_or_give_up(self, delays, desc: str, err: Exception) -> None:
        delay = next(delays, None)
        if delay is None:
            raise CoordinatorGone(f"{desc}: {err}") from err
        log.info("%s: %s; retrying in %.2f s", desc, err, delay)
        self._count_retry()
        time.sleep(delay)

    def _request(self, method: str, path: str,
                 body: bytes | None = None) -> bytes:
        def build():
            req = urllib.request.Request(f"{self.base}{path}", data=body,
                                         method=method)
            if body is not None:
                req.add_header("Content-Type", "application/json")
            return req

        try:
            return _open_with_retries(build, self.rpc_timeout_s,
                                      f"{method} {path}", self._count_retry)
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
        url = f"{self.base}{self._data_path('input', filename)}"
        try:
            while True:
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
                    raise RuntimeError(f"GET {url} -> {e.code}") from e
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
        url = f"{self.base}{self._data_path('out', name)}"
        while True:
            try:
                with open(path, "rb") as f:
                    req = urllib.request.Request(url, data=f, method="PUT")
                    req.add_header("Content-Length", str(size))
                    with urllib.request.urlopen(req,
                                                timeout=self.rpc_timeout_s):
                        return
            except urllib.error.HTTPError as e:
                raise RuntimeError(
                    f"PUT {url} -> {e.code}: {e.read()[:200]!r}") from e
            except TRANSIENT_ERRORS as e:
                self._sleep_or_give_up(delays, f"PUT {url}", e)

    # ---------------------------------------------------------- bootstrap
    def fetch_config(self) -> JobConfig:
        return JobConfig.from_json(self._request("GET", "/config"))

    def fetch_status(self) -> dict:
        return json.loads(self._request("GET", "/status"))


def client_call(addr: str, method: str, path: str, body: bytes | None = None,
                timeout: float = 30.0, retry: bool = True) -> dict:
    """One JSON-over-HTTP call with the transport's retry policy, bounded
    by ``timeout`` in all; ``retry=False`` makes it single-shot (for a
    request a duplicate delivery could change).  An HTTP error status
    raises HTTPError at once."""
    base = _base_url(addr)

    def build():
        req = urllib.request.Request(f"{base}{path}", data=body,
                                     method=method)
        if body is not None:
            req.add_header("Content-Type", "application/json")
        return req

    desc = f"{method} {addr}{path}"
    if retry:
        return json.loads(_open_with_retries(
            build, timeout, desc, deadline=time.monotonic() + timeout))
    return json.loads(_open_with_retries(build, timeout, desc,
                                         delays=iter(())))


def run_http_worker(addr: str, n_parallel: int = 1) -> None:
    """The ``worker`` subcommand: fetch the job's config from the
    coordinator, load the application, check its device when it uses one
    (CUDA asked for where there is none raises, naming it: nothing scans
    on the host instead), build the host library and run ``n_parallel``
    task loops in this process.  Returns when the job is over or the
    coordinator is gone; raises the first error of a loop that failed
    otherwise."""
    from distributed_grep_tpu_torch.apps.loader import load_application
    from distributed_grep_tpu_torch.runtime.job import job_device
    from distributed_grep_tpu_torch.runtime.worker import WorkerLoop
    from distributed_grep_tpu_torch.utils import native
    from distributed_grep_tpu_torch.utils import spans as spans_mod
    from distributed_grep_tpu_torch.utils import trace

    # the start's legs, logged once the worker is ready: where a worker
    # process's seconds before its first task go
    marks = [("entry", time.perf_counter())]
    log.info("worker for %s: fetching the job's config", addr)
    transport = HttpTransport(addr)
    try:
        config = transport.fetch_config()
    except CoordinatorGone:
        log.error("no coordinator at %s", addr)
        raise SystemExit(1)
    marks.append(("config", time.perf_counter()))
    app = load_application(config.application)
    marks.append(("app", time.perf_counter()))
    device = job_device(app, config.app_options)
    if device is not None:
        from distributed_grep_tpu_torch.utils.device import resolve_device

        resolve_device(device)  # raises, naming the device
    marks.append(("device", time.perf_counter()))
    native.lib()  # before any task: a task's detector never waits on g++
    marks.append(("host library", time.perf_counter()))
    spans_on = spans_mod.enabled(config.spans)
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
            HttpTransport(addr, rpc_timeout_s=config.rpc_timeout_s), app,
            reduce_memory_bytes=config.reduce_memory_bytes,
            # the coordinator's spill path may not exist here: honoured
            # only when set
            spill_dir=config.spill_dir,
            # the coordinator's config decides: it is the one that
            # persists the spans
            spans_enabled=spans_on, job_id=config.effective_job_id())
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
    with trace.job_trace(device=device):
        for i in range(n_parallel):
            threading.Thread(target=run_loop, args=(i,), name=f"slot-{i}",
                             daemon=True).start()
        ended.wait()
    log.info("worker for %s: %s", addr,
             f"failed: {errors[0]!r}" if errors else "every slot ended")
    if errors:
        raise errors[0]
