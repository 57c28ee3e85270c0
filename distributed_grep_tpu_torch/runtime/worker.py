"""Worker loop over a Transport (the reference's runtime/worker.py without
its fused map and peer fetch): ask for work, run it, commit it, report
it.

Map: run the application over one input file -- ``map_path_fn(filename,
path)`` when the app defines it and the transport gives a local path (it
reads the file itself, in chunks: the grep app streams it through
``GrepEngine.scan_file``; over HTTP the split is spooled to a temp file
first), else ``map_fn(filename, contents)`` -- or over a batched split's
members: ``map_batch_fn(items)`` once, with ``(name, path)`` items when
the app sets ``map_batch_paths`` and the data plane is local (it reads
them, or serves them from the corpus cache, itself) and ``(name, bytes)``
otherwise, else ``map_fn`` a member; bucketize the records by FNV-32a
partition (columnar batches split by partition, runtime/columnar.py),
commit one intermediate file per partition, publish the attempt's commit
record, report the partitions.

Reduce: ask for the partition's intermediate files one at a time
(``reduce_next_file``, the streaming shuffle) and feed each into a
bounded-memory sink that spills sorted runs: identity-reduce apps collate
in (file, line) order (``IdentityCollator``, batches stay columnar), every
other app groups by key (``ExternalReducer``, ``reduce_stream_fn``
preferred to ``reduce_fn``); spool ``mr-out-<r>`` as ``key<TAB>value``
lines and commit it, publish the commit record, report it.  A registered
file that cannot be read is reported (``lost_file``) and its map task
runs again.

Liveness: the app's progress callback stamps heartbeats (plain stamps at
most every third of the task timeout; a ``grace_s`` stamp, the engine's
kernel build, always goes through); apps without one, remote downloads
and large shuffles get a pump thread that stamps while they run.

Each finished RPC ships the attempt's counters and stage seconds, and,
from a worker process, the kernel launches made since its last report.

The span pipeline (utils/spans.py), when the job switches it on: each
attempt runs in a task context tagged (job, task, attempt, worker, kind)
and emits the reference's spans (``map:read``, ``map:compute``,
``map:shuffle``, ``map:commit``, ``map:task``; ``reduce:shuffle``,
``reduce:compute``, ``reduce:commit``, ``reduce:task``; the engine's
``scan:<mode>`` and the app's ``map:emit`` under them) into the loop's
SpanBuffer, which drains onto each heartbeat (at most FLUSH_MAX records)
and whole onto the finished RPC, with the loop's Metrics snapshot.  The
read, compute and reduce legs are also profiler regions (utils/trace.py:
``map_read:<id>``, ``map_compute:<id>``, ``reduce_compute:<id>``).  Off,
no buffer exists and no RPC carries a new field.

``fault_hooks`` maps a point name ("after_map_read", "before_map_commit",
"before_map_finished", "after_reduce_file", "before_reduce_commit") to a
callable; raising WorkerKilled from it simulates a crash at that point.
"""

from __future__ import annotations

import contextlib
import os
import sys
import tempfile
import threading
import time
from typing import Callable, Optional

from distributed_grep_tpu_torch.runtime import rpc, shuffle
from distributed_grep_tpu_torch.runtime.columnar import (
    IdentityCollator,
    LineBatch,
)
from distributed_grep_tpu_torch.runtime.extsort import ExternalReducer
from distributed_grep_tpu_torch.utils import metrics as metrics_mod
from distributed_grep_tpu_torch.utils import spans as spans_mod
from distributed_grep_tpu_torch.utils import trace
from distributed_grep_tpu_torch.utils.logging import get_logger
from distributed_grep_tpu_torch.utils.metrics import Metrics

log = get_logger("worker")

# Task walls in the process's /metrics registry (in-process workers land
# in their job's process, worker processes in their own).
_H_MAP_TASK = metrics_mod.histogram("dgrep_map_task_seconds")
_H_REDUCE_TASK = metrics_mod.histogram("dgrep_reduce_task_seconds")

# Each reduce sink holds this much before it spills a sorted run, unless
# the job says otherwise (JobConfig.reduce_memory_bytes).
REDUCE_MEMORY_BYTES = 128 << 20

# A local shuffle leg of fewer records than this runs without a pump.
PUMP_RECORDS = 50_000


class WorkerKilled(Exception):
    """Raised by fault-injection hooks to simulate a worker crash."""


class TaskAborted(Exception):
    """The coordinator fenced this attempt off: abandon it with no commit
    and no finished RPC."""


_shipped_lock = threading.Lock()
_shipped: dict[str, int] = {}


def unshipped_launches() -> dict[str, int]:
    """The kernel launches this process made since the last call, by
    library (each launch reported once however many task loops share the
    process); {} when no scan module was imported."""
    ds = sys.modules.get("distributed_grep_tpu_torch.ops.device_scan")
    if ds is None:
        return {}
    with _shipped_lock:
        now = ds.kernel_launches()
        delta = {}
        for k, v in now.items():
            before = _shipped.get(k, 0)
            d = v - before if v >= before else v  # the counter was reset
            if d:
                delta[k] = d
        _shipped.update(now)
    return delta


def _engine_cache_counters() -> dict | None:
    """This process's model-cache, corpus-cache and follow counters, or
    None when none was touched; the owning modules are read only when
    already imported (a word-count worker imports no scan module)."""
    counters: dict = {}
    eng = sys.modules.get("distributed_grep_tpu_torch.ops.engine")
    if eng is not None:
        counters.update(eng.model_cache_counters())
    lay = sys.modules.get("distributed_grep_tpu_torch.ops.layout")
    if lay is not None:
        counters.update(lay.corpus_cache_counters())
    fol = sys.modules.get("distributed_grep_tpu_torch.runtime.follow")
    if fol is not None:
        counters.update(fol.follow_counters())
    return counters or None


@contextlib.contextmanager
def _stack(*cms):
    """The context managers entered in order, as one ``with``."""
    with contextlib.ExitStack() as stack:
        for cm in cms:
            stack.enter_context(cm)
        yield


class WorkerLoop:
    def __init__(self, transport, app,
                 fault_hooks: Optional[dict[str, Callable[[], None]]] = None,
                 reduce_memory_bytes: int | None = None,
                 spill_dir: Optional[str] = None,
                 metrics: Optional[Metrics] = None,
                 spans_enabled: Optional[bool] = None,
                 job_id: str = ""):
        self.transport = transport
        self.app = app  # a LoadedApplication (apps/loader.py)
        self.fault_hooks = fault_hooks or {}
        self.reduce_memory_bytes = reduce_memory_bytes
        self.spill_dir = spill_dir
        self.worker_id = -1
        self.is_local = bool(getattr(transport, "is_local", False))
        self.metrics = metrics or Metrics()
        # the span pipeline: None defers to DGREP_SPANS; off means no
        # buffer, so every emit site below is a no-op
        if spans_enabled is None:
            spans_enabled = spans_mod.env_enabled()
        self.spans = spans_mod.SpanBuffer() if spans_enabled else None
        self.job_id = job_id
        self._hb_rtt = -1.0  # the last heartbeat's round trip (ClockSync)
        self._assign_wait_s = 0.0

    def _fault(self, point: str) -> None:
        hook = self.fault_hooks.get(point)
        if hook:
            hook()

    # ---------------------------------------------------------- liveness
    @staticmethod
    def _hb_interval(window_s: float) -> float:
        """A third of the detector window, within [50 ms, 5 s]: two chances
        to land a stamp a window."""
        return min(5.0, max(0.05, float(window_s) / 3.0))

    def _piggyback(self) -> dict:
        """The loop's Metrics snapshot, the process's cache counters and
        the process token (the span pipeline's metrics piggyback)."""
        out = self.metrics.piggyback()
        out.update(_engine_cache_counters() or {})
        out["proc"] = metrics_mod.PROC_TOKEN
        return out

    def _heartbeat(self, task_type: str, task_id: int,
                   grace_s: float = 0.0) -> None:
        """An advisory stamp; never raises (the task's own RPCs surface a
        transport failure).  With the span pipeline on it carries a batch
        of the buffered spans (lost with the stamp if it fails), the
        metrics piggyback, and the send time and last round trip."""
        hb = getattr(self.transport, "heartbeat", None)
        if hb is None:
            return
        args = rpc.HeartbeatArgs(task_type=task_type, task_id=task_id,
                                 worker_id=self.worker_id, grace_s=grace_s)
        if self.spans is not None:
            args.spans_seq, args.spans = self.spans.drain_batch()
            args.metrics = self._piggyback()
            args.sent_at = time.time()
            args.rtt_s = self._hb_rtt
        try:
            rtt = hb(args)
            # a measured round trip only: a failed stamp's None (or a
            # transport that does not measure) must not feed the clock sync
            if isinstance(rtt, float):
                self._hb_rtt = rtt
        except Exception:  # noqa: BLE001 -- advisory by contract
            pass

    def _progress_fn(self, task_type: str, task_id: int,
                     window_s: float) -> Callable:
        last = [0.0]
        min_interval = self._hb_interval(window_s)

        def progress(grace_s: float = 0.0) -> None:
            now = time.monotonic()
            if not grace_s and now - last[0] < min_interval:
                return
            last[0] = now
            self._heartbeat(task_type, task_id, grace_s=grace_s)

        return progress

    def _pumping(self, task_type: str, task_id: int, interval_s: float):
        """Stamp heartbeats from a side thread while the body runs."""

        @contextlib.contextmanager
        def ctx():
            stop = threading.Event()

            def pump() -> None:
                while not stop.wait(interval_s):
                    self._heartbeat(task_type, task_id)

            t = threading.Thread(target=pump, name="hb-pump", daemon=True)
            t.start()
            try:
                yield
            finally:
                stop.set()
                t.join(timeout=interval_s + 1.0)

        return ctx()

    # -------------------------------------------------------------- loop
    def run(self) -> None:
        while True:
            t_wait = time.monotonic()
            reply = self.transport.assign_task(
                rpc.AssignTaskArgs(worker_id=self.worker_id))
            # the wait for work, an argument of the task's span
            self._assign_wait_s = time.monotonic() - t_wait
            self.worker_id = reply.worker_id
            if self.spans is not None:
                # records the buffer makes itself (a drop report) land on
                # this worker's row
                self.spans.base_tags.update(job=self.job_id,
                                            worker=self.worker_id)
            log.info("worker %d: %s %d", self.worker_id, reply.assignment,
                     reply.task_id)
            if reply.assignment == rpc.Assignment.JOB_DONE:
                log.info("worker %d: job done, exiting", self.worker_id)
                return
            if reply.assignment == rpc.Assignment.MAP:
                self._run_map(reply)
            elif reply.assignment == rpc.Assignment.REDUCE:
                self._run_reduce(reply)
            elif reply.retry_after_s > 0:
                # quarantined: sleep a bounded slice of the hinted window
                time.sleep(min(reply.retry_after_s, 5.0))
            # else a retry: the long-poll window expired

    def _publish_commit(self, kind: str, task_id: int, attempt: str,
                        payload: dict) -> None:
        publish = getattr(self.transport, "publish_task_commit", None)
        if publish is not None:
            with spans_mod.span(f"{kind}:commit", cat=kind):
                publish(kind, task_id, attempt, payload)

    def _task_ctx(self, kind: str, task_id: int, attempt: str):
        """The span pipeline's task context of one attempt; a nullcontext
        when the pipeline is off."""
        if self.spans is None:
            return contextlib.nullcontext()
        return spans_mod.task_context(
            self.spans, job=self.job_id, worker=self.worker_id,
            task=task_id, attempt=attempt, kind=kind)

    def _metrics(self, counters: dict, seconds: dict) -> dict:
        out = {"counters": counters, "seconds": seconds}
        if not self.is_local:
            launches = unshipped_launches()
            if launches:
                out["launches"] = launches
        return out

    def _finished(self, args: rpc.TaskFinishedArgs) -> rpc.TaskFinishedArgs:
        """A finished RPC's last flush: every buffered span (the worker may
        exit before another heartbeat) and the metrics piggyback."""
        if self.spans is not None:
            args.spans_seq, args.spans = self.spans.drain_batch(
                limit=self.spans.cap + 1)
            args.metrics = {**(args.metrics or {}),
                            "piggyback": self._piggyback()}
        return args

    # --------------------------------------------------------------- map
    def _read_members(self, names: list[str], want_paths: bool
                      ) -> tuple[list, int]:
        """A split's members as (name, bytes) items, or (name, local path)
        on a local data plane when the app takes paths; and their bytes."""
        if want_paths and self.is_local and hasattr(self.transport,
                                                    "read_input_path"):
            items = [(n, str(self.transport.read_input_path(n)[0]))
                     for n in names]
            return items, sum(os.path.getsize(p) for _n, p in items)
        items = [(n, self.transport.read_input(n)) for n in names]
        return items, sum(len(b) for _n, b in items)

    def _run_map(self, a: rpc.AssignTaskReply) -> None:
        from distributed_grep_tpu_torch.runtime.store import new_attempt_id

        t0 = time.perf_counter()
        t0_wall = time.time()
        attempt = new_attempt_id()
        with self._task_ctx("map", a.task_id, attempt):
            produced, metrics = self._map_attempt(a, attempt)
            spans_mod.complete(
                "map:task", t0_wall, time.time() - t0_wall, cat="map",
                assign_wait_s=round(self._assign_wait_s, 6))
            self._fault("before_map_finished")
            self.transport.map_finished(self._finished(rpc.TaskFinishedArgs(
                task_id=a.task_id, worker_id=self.worker_id,
                produced_parts=produced, metrics=metrics)))
        self.metrics.inc("map_tasks")
        self.metrics.observe("map_task_total", time.perf_counter() - t0)
        _H_MAP_TASK.observe(time.perf_counter() - t0)

    def _map_attempt(self, a: rpc.AssignTaskReply,
                     attempt: str) -> tuple[list[int], dict]:
        self.app.configure(**a.app_options)
        use_path = (self.app.map_path_fn is not None
                    and hasattr(self.transport, "read_input_path"))
        has_progress = self.app.set_progress(
            self._progress_fn("map", a.task_id, a.task_timeout_s))
        pump_s = min(2.0, self._hb_interval(a.task_timeout_s))

        def compute_guard():
            # an app without progress gets coarse liveness over its compute
            return (contextlib.nullcontext() if has_progress
                    else self._pumping("map", a.task_id, pump_s))

        def download_guard():
            return (contextlib.nullcontext() if self.is_local
                    else self._pumping("map", a.task_id, pump_s))

        def read_guard(**span_args):
            return _stack(
                download_guard(), trace.annotate(f"map_read:{a.task_id}"),
                spans_mod.span("map:read", cat="map", file=a.filename,
                               **span_args))

        def compute():
            return _stack(self.metrics.timer("map_compute"),
                          trace.annotate(f"map_compute:{a.task_id}"),
                          spans_mod.span("map:compute", cat="map"),
                          compute_guard())

        t0 = time.perf_counter()
        try:
            if a.filenames:
                batch_fn = self.app.map_batch_fn
                with read_guard(files=len(a.filenames)):
                    items, n_bytes = self._read_members(
                        a.filenames,
                        want_paths=batch_fn is not None
                        and self.app.map_batch_paths)
                self._fault("after_map_read")
                t1 = time.perf_counter()
                with compute():
                    if batch_fn is not None:
                        records = batch_fn(items)
                    else:
                        records = [r for name, b in items
                                   for r in self.app.map_fn(name, b)]
            elif use_path:
                with read_guard():
                    path, is_temp = self.transport.read_input_path(a.filename)
                try:
                    self._fault("after_map_read")
                    n_bytes = os.path.getsize(path)
                    t1 = time.perf_counter()
                    with compute():
                        records = self.app.map_path_fn(a.filename, str(path))
                finally:
                    if is_temp:
                        os.unlink(path)
            else:
                with read_guard():
                    contents = self.transport.read_input(a.filename)
                self._fault("after_map_read")
                n_bytes = len(contents)
                t1 = time.perf_counter()
                with compute():
                    records = self.app.map_fn(a.filename, contents)
            self.metrics.record_scan(n_bytes, time.perf_counter() - t0)
        finally:
            if has_progress:
                self.app.set_progress(None)
        t2 = time.perf_counter()

        def shuffle_guard():
            # a dense map's shuffle can outlast the window by itself; a
            # remote push can stall at any size
            if self.is_local and sum(
                    len(r) if isinstance(r, LineBatch) else 1
                    for r in records) < PUMP_RECORDS:
                return contextlib.nullcontext()
            return self._pumping("map", a.task_id, pump_s)

        with shuffle_guard():
            with spans_mod.span("map:shuffle", cat="map"):
                buckets = shuffle.bucketize(records, a.n_reduce)
                self._fault("before_map_commit")
                produced = []
                for r, recs in sorted(buckets.items()):
                    self.transport.write_intermediate(
                        f"mr-{a.task_id}-{r}", shuffle.encode_records(recs))
                    produced.append(r)
            self._publish_commit("map", a.task_id, attempt,
                                 {"parts": produced})
        batches = [rec for rec in records if isinstance(rec, LineBatch)]
        counters = {"map_batches": len(batches),
                    "map_records": len(records) - len(batches)
                    + sum(len(b) for b in batches)}
        seconds = {"map_read": t1 - t0, "map_fn": t2 - t1,
                   "map_shuffle": time.perf_counter() - t2}
        return produced, self._metrics(counters, seconds)

    # ------------------------------------------------------------ reduce
    def _run_reduce(self, a: rpc.AssignTaskReply) -> None:
        from distributed_grep_tpu_torch.runtime.store import new_attempt_id

        t0 = time.perf_counter()
        t0_wall = time.time()
        attempt = new_attempt_id()
        with self._task_ctx("reduce", a.task_id, attempt):
            try:
                metrics = self._reduce_attempt(a, attempt)
            except TaskAborted:
                log.warning("reduce task %d attempt abandoned: fenced off "
                            "by the coordinator", a.task_id)
                self.metrics.inc("reduce_aborted")
                return
            spans_mod.complete(
                "reduce:task", t0_wall, time.time() - t0_wall, cat="reduce",
                assign_wait_s=round(self._assign_wait_s, 6))
            self.transport.reduce_finished(self._finished(
                rpc.TaskFinishedArgs(task_id=a.task_id,
                                     worker_id=self.worker_id,
                                     metrics=metrics)))
        self.metrics.inc("reduce_tasks")
        self.metrics.observe("reduce_task_total", time.perf_counter() - t0)
        _H_REDUCE_TASK.observe(time.perf_counter() - t0)

    def _reduce_attempt(self, a: rpc.AssignTaskReply, attempt: str) -> dict:
        self.app.configure(**a.app_options)
        t0 = time.perf_counter()
        if self.spill_dir:
            os.makedirs(self.spill_dir, exist_ok=True)
        memory = (self.reduce_memory_bytes if self.reduce_memory_bytes
                  is not None else REDUCE_MEMORY_BYTES)
        if getattr(self.app.module, "reduce_is_identity", False):
            sink = IdentityCollator(memory, self.spill_dir)
            chunks = sink.iter_output_blocks  # bytes a batch, str a record
            progress_stride = 64
        else:
            sink = ExternalReducer(memory, self.spill_dir)
            stream_fn = self.app.reduce_stream_fn

            def chunks():
                for k, v in sink.reduce(self.app.reduce_fn, stream_fn):
                    yield f"{k}\t{v}\n"

            progress_stride = 4096
        try:
            files_processed = 0
            lost = ""
            t_shuffle = time.time()
            while True:
                r = self.transport.reduce_next_file(rpc.ReduceNextFileArgs(
                    task_id=a.task_id, files_processed=files_processed,
                    epoch=a.epoch, worker_id=self.worker_id, lost_file=lost))
                lost = ""
                if r.abort:
                    raise TaskAborted(a.task_id)
                if r.done:
                    break
                if not r.next_file:
                    continue  # the long-poll window expired: poll again
                try:
                    data = self.transport.read_intermediate(r.next_file)
                except (OSError, RuntimeError) as e:
                    # a registered file gone from the store: report it on
                    # the next poll, the cursor unmoved
                    log.warning("intermediate file %s unreadable (%s); "
                                "reporting it lost", r.next_file, e)
                    lost = r.next_file
                    continue
                sink.add_many(shuffle.decode_records(data))
                files_processed += 1
                self._fault("after_reduce_file")
            # the streaming shuffle leg, its long-poll waits included
            spans_mod.complete(
                "reduce:shuffle", t_shuffle, time.time() - t_shuffle,
                cat="reduce", files=files_processed)
            with spans_mod.span("reduce:compute", cat="reduce"):
                self._write_reduce_output(a, chunks(), progress_stride)
            spills = sink.spill_count
        finally:
            if sink.spill_count:
                self.metrics.inc("reduce_spills", sink.spill_count)
            sink.close()
        self._publish_commit("reduce", a.task_id, attempt,
                             {"output": f"mr-out-{a.task_id}"})
        return self._metrics({"reduce_spills": spills},
                             {"reduce": time.perf_counter() - t0})

    def _write_reduce_output(self, a: rpc.AssignTaskReply, chunks,
                             progress_stride: int) -> None:
        """Spool the output locally, then commit it: its size never
        bounds on memory.  Stamps keep a long merge alive."""
        fd, spool = tempfile.mkstemp(prefix="dgrep-redout-",
                                     dir=self.spill_dir or None)
        try:
            progress = self._progress_fn("reduce", a.task_id,
                                         a.task_timeout_s)
            with self.metrics.timer("reduce_compute"), \
                    trace.annotate(f"reduce_compute:{a.task_id}"), \
                    os.fdopen(fd, "wb") as out:
                for i, chunk in enumerate(chunks):
                    out.write(chunk if isinstance(chunk, bytes)
                              else chunk.encode("utf-8", "surrogateescape"))
                    if i % progress_stride == 0:
                        progress()
            self._fault("before_reduce_commit")
            wof = getattr(self.transport, "write_output_from_file", None)
            if wof is not None:
                wof(f"mr-out-{a.task_id}", spool)
            else:
                with open(spool, "rb") as f:
                    self.transport.write_output(f"mr-out-{a.task_id}",
                                                f.read())
        finally:
            # the transport may have consumed the spool (a rename)
            if os.path.exists(spool):
                os.unlink(spool)
