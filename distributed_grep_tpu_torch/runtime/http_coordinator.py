"""The coordinator as an HTTP server (the reference's
runtime/http_coordinator.py).

* control plane: the five verbs of runtime/rpc.py as JSON-over-HTTP
  long-poll endpoints (``POST /rpc/<verb>``); the long polls wait on the
  scheduler's condition variable;
* data plane: HTTP GET/PUT of input splits, intermediate files, outputs
  and per-task commit records (``/data/...``), streamed in BLOCK_BYTES
  blocks, so no file is ever held whole in the coordinator's memory; a
  GET serves a ``Range: bytes=N-`` prefix (206) so a worker whose
  download died can resume; ``/data/input/`` serves only the job's own
  input files, and a name with a ``/`` or a leading ``.`` is refused;
* bootstrap: ``GET /config`` hands workers the JobConfig (application and
  options, the device among them);
* ``GET /status``: task states, the scheduler's counters and seconds, the
  kernel launches the workers shipped, the RPCs and data-plane bytes and
  seconds served, in-flight tasks, quarantines, and a row a worker (its
  last contact, its task, the Metrics snapshot it shipped, its clock
  offset); the reference's keys ``done``, ``map``, ``reduce``,
  ``metrics``, ``workers`` and ``in_flight`` among them;
* ``GET /metrics``: the process's typed instruments as Prometheus text
  (utils/metrics.py: the assign long-poll and the phase histograms, the
  re-issue and quarantine counters);
* the span pipeline (``JobConfig.spans`` or DGREP_SPANS=1): the spans the
  workers ship and the scheduler's decisions go to ``events.jsonl`` in the
  work dir (a resumed coordinator appends to it).

Workers join by calling AssignTask; ``serve_coordinator`` blocks until
the job completes.
"""

from __future__ import annotations

import json
import shutil
import threading
import time
import urllib.parse
from collections import Counter
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from distributed_grep_tpu_torch.runtime import rpc
from distributed_grep_tpu_torch.runtime.journal import TaskJournal
from distributed_grep_tpu_torch.runtime.scheduler import Scheduler
from distributed_grep_tpu_torch.runtime.store import make_store
from distributed_grep_tpu_torch.utils import metrics as metrics_mod
from distributed_grep_tpu_torch.utils import spans as spans_mod
from distributed_grep_tpu_torch.utils import trace
from distributed_grep_tpu_torch.utils.config import JobConfig
from distributed_grep_tpu_torch.utils.io import WorkDir, resolve_input_path
from distributed_grep_tpu_torch.utils.logging import get_logger

log = get_logger("http_coordinator")

# The data plane streams GET and PUT bodies in blocks of this many bytes.
BLOCK_BYTES = 1 << 20


def long_poll_window_s(config: JobConfig) -> float:
    """The server's long-poll window: half the client's socket timeout
    (rpc_timeout_s), within [5 s, 30 s], so an idle long poll returns
    before the client gives up."""
    return min(30.0, max(5.0, config.rpc_timeout_s / 2.0))


class CoordinatorServer:
    def __init__(self, config: JobConfig, resume: bool = False):
        from distributed_grep_tpu_torch.runtime.job import plan_map_splits

        self.config = config
        self.store = make_store(config.store, durable=config.durable)
        self.workdir = WorkDir(config.work_dir, store=self.store)
        resume_entries = None
        if resume:
            if config.journal:
                resume_entries = TaskJournal.replay(
                    self.workdir.journal_path())
        else:
            self.workdir.clear()
        journal = (TaskJournal(self.workdir.journal_path()) if config.journal
                   else None)
        # GET /data/input/ serves exactly the job's input files
        self.input_allowlist = frozenset(config.input_files)
        self.event_log = (
            spans_mod.EventLog(self.workdir.root / spans_mod.EventLog.FILENAME,
                               fresh=not resume)
            if spans_mod.enabled(config.spans) else None)
        self.scheduler = Scheduler(
            files=plan_map_splits(list(config.input_files),
                                  config.effective_batch_bytes()),
            n_reduce=config.n_reduce,
            task_timeout_s=config.task_timeout_s,
            sweep_interval_s=config.sweep_interval_s,
            app_options=config.effective_app_options(),
            journal=journal,
            resume_entries=resume_entries,
            commit_resolver=self.workdir.resolve_task_commit,
            event_log=self.event_log,
        )
        self._traffic_lock = threading.Lock()
        self.rpcs: Counter = Counter()
        self.data_plane: Counter = Counter()  # bytes and seconds by direction
        self._httpd = ThreadingHTTPServer(
            (config.coordinator_host, config.coordinator_port),
            _make_handler(self))
        self._httpd.daemon_threads = True

    # ---------------------------------------------------------- lifecycle
    def start(self) -> None:
        threading.Thread(target=self._httpd.serve_forever,
                         name="http-coordinator", daemon=True).start()
        log.info("coordinator serving on %s:%d (%d map tasks, %d reduce "
                 "tasks)", self.config.coordinator_host, self.port,
                 len(self.scheduler.map_tasks), self.config.n_reduce)

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def wait_done(self, timeout: float | None = None) -> bool:
        return self.scheduler.wait_done(timeout=timeout)

    def shutdown(self, linger_s: float = 2.0) -> None:
        """Give long-polling workers a moment to receive JOB_DONE, then
        stop serving."""
        self.scheduler.stop()
        time.sleep(linger_s)
        self._httpd.shutdown()
        self._httpd.server_close()
        self.scheduler.close_journal()
        if self.event_log is not None:
            self.event_log.close()

    def count(self, table: Counter, **adds: float) -> None:
        with self._traffic_lock:
            for k, v in adds.items():
                table[k] += v

    # ------------------------------------------------------- RPC dispatch
    def handle_rpc(self, verb: str, payload: dict) -> dict:
        window = long_poll_window_s(self.config)
        s = self.scheduler
        self.count(self.rpcs, **{verb: 1})
        if verb == rpc.Verb.ASSIGN_TASK:
            reply = s.assign_task(rpc.AssignTaskArgs(**payload),
                                  timeout=window)
        elif verb == rpc.Verb.MAP_FINISHED:
            reply = s.map_finished(rpc.TaskFinishedArgs(**payload))
        elif verb == rpc.Verb.REDUCE_FINISHED:
            reply = s.reduce_finished(rpc.TaskFinishedArgs(**payload))
        elif verb == rpc.Verb.REDUCE_NEXT_FILE:
            reply = s.reduce_next_file(rpc.ReduceNextFileArgs(**payload),
                                       timeout=window)
        elif verb == rpc.Verb.HEARTBEAT:
            args = rpc.HeartbeatArgs(**payload)
            s.heartbeat(args.task_type, args.task_id, grace_s=args.grace_s,
                        args=args)
            reply = rpc.HeartbeatReply()
        else:
            raise KeyError(f"unknown RPC verb: {verb}")
        return rpc.reply_to_dict(reply)

    def status(self) -> dict:
        s = self.scheduler
        with self._traffic_lock:
            rpcs = dict(self.rpcs)
            data_plane = dict(self.data_plane)
        snapshot = s.metrics_snapshot()
        return {
            "done": s.done(),
            **s.status_counts(),
            **snapshot,
            "metrics": snapshot,
            "rpcs": rpcs,
            "data_plane": data_plane,
            "workers": s.worker_status(),
            "in_flight": s.inflight_status(),
            "quarantine": s.worker_health.snapshot(),
        }


class DataPlaneHandler(BaseHTTPRequestHandler):
    """JSON replies, block-streamed file GET with a prefix-Range resume,
    store-routed PUT bodies, a bounded body drain, and the per-task commit
    record PUT."""

    protocol_version = "HTTP/1.1"
    server_ref: CoordinatorServer

    def log_message(self, fmt, *args):  # through the logger, DEBUG only
        log.debug("http: " + fmt, *args)

    def _send_json(self, obj: dict, code: int = 200) -> None:
        body = json.dumps(obj).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_file(self, path) -> None:
        """Stream a file in BLOCK_BYTES blocks; a single 'Range: bytes=N-'
        prefix range answers 206 with the rest of the file."""
        t0 = time.perf_counter()
        size = path.stat().st_size
        start = 0
        rng = self.headers.get("Range")
        if rng and rng.startswith("bytes="):
            lo, _, hi = rng[len("bytes="):].split(",")[0].strip().partition("-")
            if lo.isdigit() and (not hi or hi.isdigit()):
                start = int(lo)
                # open-ended or to-the-end prefixes inside the file only;
                # anything else is answered whole (200)
                if start >= size or (hi and int(hi) != size - 1):
                    start = 0
        with open(path, "rb") as f:
            f.seek(start)
            if start:
                self.send_response(206)
                self.send_header("Content-Range",
                                 f"bytes {start}-{size - 1}/{size}")
            else:
                self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Length", str(size - start))
            self.end_headers()
            # the headers are out: a failure from here must not write a
            # JSON error into the body (a Range resume would splice it in)
            self._streaming_body = True
            shutil.copyfileobj(f, self.wfile, BLOCK_BYTES)
        self.server_ref.count(self.server_ref.data_plane,
                              bytes_out=size - start, get_requests=1,
                              get_seconds=time.perf_counter() - t0)

    def _send_text(self, text: str, code: int = 200) -> None:
        """A plain-text reply: the Prometheus exposition content type."""
        body = text.encode("utf-8", "strict")
        self.send_response(code)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _read_body(self) -> bytes:
        length = int(self.headers.get("Content-Length", 0))
        return self.rfile.read(length) if length else b""

    def _receive_file(self, store, dst) -> None:
        """Stream the PUT body through the store's commit protocol."""
        t0 = time.perf_counter()
        length = int(self.headers.get("Content-Length", 0))
        store.put_from_stream(dst, self.rfile, length, BLOCK_BYTES)
        self.server_ref.count(self.server_ref.data_plane, bytes_in=length,
                              put_requests=1,
                              put_seconds=time.perf_counter() - t0)

    def _drain_body(self) -> None:
        """Discard a request body in bounded blocks."""
        remaining = int(self.headers.get("Content-Length", 0))
        while remaining > 0:
            block = self.rfile.read(min(BLOCK_BYTES, remaining))
            if not block:
                break
            remaining -= len(block)

    def _put_commit(self, store, commits_dir, name: str) -> None:
        """A per-task commit record: name "<kind>-<task_id>.<attempt>",
        the body its payload."""
        kind_tid, _, attempt = name.partition(".")
        kind, _, tid = kind_tid.rpartition("-")
        if kind not in ("map", "reduce") or not tid.isdigit() or not attempt:
            self._drain_body()
            self._send_json({"error": f"bad commit name: {name}"}, 400)
            return
        if int(self.headers.get("Content-Length", 0)) > 1 << 20:
            self._drain_body()
            self._send_json({"error": "commit record too large"}, 413)
            return
        body = self._read_body()
        store.commit_task(commits_dir, kind, int(tid), attempt,
                          json.loads(body or b"{}"))
        self._send_json({"ok": True})


def _make_handler(server: CoordinatorServer):
    workdir = server.workdir

    class Handler(DataPlaneHandler):
        server_ref = server

        def do_POST(self):
            try:
                if self.path.startswith("/rpc/"):
                    verb = self.path[len("/rpc/"):]
                    payload = json.loads(self._read_body() or b"{}")
                    self._send_json(server.handle_rpc(verb, payload))
                else:
                    self._drain_body()
                    self._send_json({"error": "not found"}, 404)
            except BrokenPipeError:
                pass  # the client gave up on a long poll
            except Exception as e:  # noqa: BLE001 -- report, keep serving
                log.exception("rpc error on %s", self.path)
                try:
                    self._send_json({"error": str(e)}, 500)
                except OSError:
                    pass

        def do_GET(self):
            self._streaming_body = False  # per request (keep-alive)
            try:
                if self.path == "/config":
                    self._send_json(json.loads(server.config.to_json()))
                elif self.path == "/status":
                    self._send_json(server.status())
                elif self.path == "/metrics":
                    self._send_text(metrics_mod.render_prometheus())
                elif self.path.startswith("/data/input/"):
                    fname = urllib.parse.unquote(
                        self.path[len("/data/input/"):])
                    if fname not in server.input_allowlist:
                        self._send_json(
                            {"error": f"not an input split: {fname}"}, 403)
                        return
                    p = resolve_input_path(fname, workdir)
                    if not p.exists():
                        self._send_json({"error": f"no such input: {fname}"},
                                        404)
                        return
                    self._send_file(p)
                elif self.path.startswith("/data/intermediate/"):
                    name = _safe_name(self.path[len("/data/intermediate/"):])
                    # through the store: a torn or uncommitted attempt is
                    # never served
                    p = server.store.resolve(
                        workdir.root / "intermediate" / name)
                    if p is None:
                        self._send_json({"error": f"no such file: {name}"},
                                        404)
                        return
                    self._send_file(p)
                else:
                    self._send_json({"error": "not found"}, 404)
            except BrokenPipeError:
                self.close_connection = True
            except Exception as e:  # noqa: BLE001
                self.close_connection = True
                log.exception("get error on %s", self.path)
                if self._streaming_body:
                    return  # a short body: the client retries
                try:
                    self._send_json({"error": str(e)}, 500)
                except OSError:
                    pass

        def do_PUT(self):
            try:
                if self.path.startswith("/data/intermediate/"):
                    name = _safe_name(self.path[len("/data/intermediate/"):])
                    self._receive_file(server.store,
                                       workdir.root / "intermediate" / name)
                    self._send_json({"ok": True})
                elif self.path.startswith("/data/out/"):
                    name = _safe_name(self.path[len("/data/out/"):])
                    self._receive_file(server.store,
                                       workdir.root / "out" / name)
                    self._send_json({"ok": True})
                elif self.path.startswith("/data/commit/"):
                    name = _safe_name(self.path[len("/data/commit/"):])
                    self._put_commit(server.store, workdir.commits_dir(),
                                     name)
                else:
                    self._drain_body()
                    self._send_json({"error": "not found"}, 404)
            except Exception as e:  # noqa: BLE001
                # a body read in part spoils the connection: close it; the
                # client's error fails the attempt, and the task's timeout
                # re-issues it
                self.close_connection = True
                log.exception("put error on %s", self.path)
                try:
                    self._send_json({"error": str(e)}, 500)
                except OSError:
                    pass

    return Handler


def _safe_name(name: str) -> str:
    name = urllib.parse.unquote(name)
    if "/" in name or name.startswith("."):
        raise ValueError(f"invalid data-plane file name: {name!r}")
    return name


def serve_coordinator(config: JobConfig, resume: bool = False) -> dict:
    """Serve until the job completes, then shut down; the final status
    with the committed output paths under "outputs"."""
    server = CoordinatorServer(config, resume=resume)
    with trace.job_trace():
        server.start()
        server.wait_done()
    status = server.status()
    log.info("job complete: %s", json.dumps(
        {k: status[k] for k in ("counters", "seconds", "launches", "rpcs",
                                "data_plane")}, sort_keys=True))
    server.shutdown()
    status["outputs"] = [str(p) for p in server.workdir.list_outputs()]
    return status
