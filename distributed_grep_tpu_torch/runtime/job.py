"""In-process job runner: a Scheduler and N worker threads over
LocalTransports, one call (the reference's runtime/job.py).

``run_job(config, n_workers, device=...)`` runs every input file as its
own map task through the application named by ``config.application``
(default: the CUDA grep app, loaded as a fresh module instance) and
returns the committed ``mr-out-*`` files; with batching on
(``config.effective_batch_bytes()``) consecutive small files share a map
task (``plan_map_splits``).  ``resume=True`` replays the work dir's
journal.  An application that launches kernels declares it
(``uses_device = True``, the CUDA grep app): its device defaults to
"cuda" and raises when CUDA is absent, unless the caller asks for "cpu";
any other application never asks for the card.  A worker that raises
anything but WorkerKilled fails the job with that exception: a build,
launch or CUDA error is never retried on another route.

With ``config.spans`` (or DGREP_SPANS=1) the workers ship their spans
and the scheduler writes ``events.jsonl`` into the work dir
(utils/spans.py); with DGREP_TRACE_DIR the job runs under the profiler
(utils/trace.py ``job_trace``), its device's activity included.

``JobResult`` reads the outputs back as streams: ``(key, value)`` records
as str (``iter_results``, ``iter_results_sorted``), or, for the grep
apps' outputs (``fileline_sorted``: every file already in (file, line)
order), as bytes that are never decoded per record -- the grep keys
(``iter_grep_keys``), the record values (``iter_grep_records_bytes``)
and the display lines (``iter_display_bytes_sorted``,
``display_blocks_sorted``: the host library's k-way display merge up to
DISPLAY_VECTOR_CAP), the counterpart of the reference's bytes-mode
streams.
"""

from __future__ import annotations

import heapq
import os
import sys
import tempfile
import threading
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from distributed_grep_tpu_torch.apps.base import KeyValue
from distributed_grep_tpu_torch.apps.loader import (
    LoadedApplication,
    load_application,
)
from distributed_grep_tpu_torch.ops.layout import env_device_min_bytes
from distributed_grep_tpu_torch.ops.lines import newline_index
from distributed_grep_tpu_torch.runtime.columnar import (
    GREP_KEY_RE,
    gather_ranges,
    grep_key_sort,
)
from distributed_grep_tpu_torch.runtime.extsort import ExternalReducer
from distributed_grep_tpu_torch.runtime.journal import TaskJournal
from distributed_grep_tpu_torch.runtime.scheduler import Scheduler
from distributed_grep_tpu_torch.runtime.transport import LocalTransport
from distributed_grep_tpu_torch.runtime.worker import WorkerKilled, WorkerLoop
from distributed_grep_tpu_torch.utils import native
from distributed_grep_tpu_torch.utils import spans as spans_mod
from distributed_grep_tpu_torch.utils import trace
from distributed_grep_tpu_torch.utils.config import JobConfig
from distributed_grep_tpu_torch.utils.device import resolve_device
from distributed_grep_tpu_torch.utils.io import WorkDir
from distributed_grep_tpu_torch.utils.logging import get_logger

log = get_logger("job")

__all__ = ["GREP_KEY_RE", "JobResult", "grep_key_sort",
           "parse_grep_key_bytes", "plan_map_splits", "run_job"]

_GREP_KEY_MARKER = b" (line number #"

# The external sort of outputs that are not fileline_sorted holds this
# much before it spills a sorted run.
SORT_MEMORY_BYTES = 64 << 20


def parse_grep_key_bytes(key: bytes) -> tuple[bytes, int] | None:
    """(path bytes, line number) of a grep-shaped key, or None: the bytes
    twin of GREP_KEY_RE, accepting exactly what it accepts (the digits
    are ASCII digits only)."""
    i = key.rfind(_GREP_KEY_MARKER)
    if i < 0 or not key.endswith(b")"):
        return None
    digits = key[i + len(_GREP_KEY_MARKER) : -1]
    if not digits.isdigit():
        return None
    return key[:i], int(digits)


def _split_record(raw: bytes) -> tuple[bytes, bytes, int] | None:
    """(line without its newline, key, index of the tab or -1) of one
    mr-out line; None for an empty line."""
    line = raw.rstrip(b"\n")
    if not line:
        return None
    tab = line.find(b"\t")
    return line, (line[:tab] if tab >= 0 else line), tab


@dataclass
class JobResult:
    """Job outputs, backed by the work dir's mr-out-* files."""

    output_files: list[Path]
    metrics: dict = field(default_factory=dict)
    # every output file is in (file, line) order (identity-reduce apps)
    fileline_sorted: bool = False

    # ``results`` refuses to hold more output than this in memory
    RESULTS_MATERIALIZE_LIMIT = 256 << 20

    @property
    def results(self) -> dict:
        """Every record as one key -> value dict, held in memory: refused
        past RESULTS_MATERIALIZE_LIMIT bytes of output (stream with
        ``iter_results`` instead)."""
        total = sum(p.stat().st_size for p in self.output_files)
        if total > self.RESULTS_MATERIALIZE_LIMIT:
            raise RuntimeError(
                f"job output is {total >> 20} MB: .results would hold it all "
                f"in memory; stream via iter_results()/iter_results_sorted() "
                f"instead (or raise JobResult.RESULTS_MATERIALIZE_LIMIT)")
        return dict(self.iter_results())

    def sorted_lines(self) -> list[str]:
        """``"<key> <value>"`` lines in grep_key_sort order."""
        return [f"{k} {v}" for k, v in self.iter_results_sorted()]

    @staticmethod
    def _iter_file(path: Path):
        with open(path, "rb") as f:
            for raw in f:
                line = raw.decode("utf-8", "surrogateescape").rstrip("\n")
                if line:
                    k, _, v = line.partition("\t")
                    yield k, v

    def iter_results(self):
        """(key, value) records, output file by output file."""
        for path in self.output_files:
            yield from self._iter_file(path)

    def iter_results_sorted(self):
        """(key, value) records in grep_key_sort order: a k-way merge of
        the per-file streams when each is already in that order
        (``fileline_sorted``), else an external sort that spills sorted
        runs past SORT_MEMORY_BYTES (runtime/extsort.py).  The sort key is
        grep_key_sort's tuple encoded in the same order: the path, a NUL
        (below every path character, so a path sorts before its
        extensions) and the line number zero-padded to 20 digits."""
        if self.fileline_sorted:
            yield from heapq.merge(
                *(self._iter_file(p) for p in self.output_files),
                key=grep_key_sort,
            )
            return

        def encode(k: str) -> str:
            path, line = grep_key_sort((k, ""))
            return f"{path}\x00{line:020d}"

        with ExternalReducer(memory_limit_bytes=SORT_MEMORY_BYTES) as sorter:
            # keys hold no tab (the first tab of a line ends its key)
            sorter.add_many(KeyValue(encode(k), f"{k}\t{v}")
                            for k, v in self.iter_results())
            for _, payload in sorter.merged():
                k, _, v = payload.partition("\t")
                yield k, v

    def iter_grep_keys(self):
        """(path, line number) of every grep-shaped record, output file by
        output file: the keys parsed as bytes, the values never decoded,
        the path decoded once per run of records of one file."""
        last_raw: bytes | None = None
        last_path = ""
        for out in self.output_files:
            with open(out, "rb") as f:
                for raw in f:
                    rec = _split_record(raw)
                    parsed = rec and parse_grep_key_bytes(rec[1])
                    if not parsed:
                        continue
                    pb, ln = parsed
                    if pb != last_raw:
                        last_raw = pb
                        last_path = pb.decode("utf-8", "surrogateescape")
                    yield last_path, ln

    def _iter_records_bytes_sorted(self):
        """((path, line number), line bytes, tab index) in display order:
        the bytes record merge every bytes stream builds on.  The merge
        key holds the DECODED path (decoded once per run of records of a
        file): the collator sorted each file under grep_key_sort's str
        order, and where surrogateescape code points order differently
        from UTF-8 bytes a merge on raw bytes would misorder names.  A
        key that is not grep-shaped sorts as (key, 0).  Needs
        ``fileline_sorted``."""
        if not self.fileline_sorted:
            raise RuntimeError(
                "bytes-mode record streams need fileline_sorted outputs")

        def keyed(path):
            last_pb = None
            last_p = ""
            with open(path, "rb") as f:
                for raw in f:
                    rec = _split_record(raw)
                    if rec is None:
                        continue
                    line, key, tab = rec
                    parsed = parse_grep_key_bytes(key)
                    if parsed is None:
                        k = (key.decode("utf-8", "surrogateescape"), 0)
                    else:
                        pb, ln = parsed
                        if pb != last_pb:
                            last_pb = pb
                            last_p = pb.decode("utf-8", "surrogateescape")
                        k = (last_p, ln)
                    yield k, line, tab

        return heapq.merge(*(keyed(p) for p in self.output_files),
                           key=lambda t: t[0])

    def iter_grep_records_bytes(self):
        """((path, line number), value bytes) in display order; the line
        number is 0 for a key that is not grep-shaped (grep -o matches
        the raw value bytes)."""
        for k, line, tab in self._iter_records_bytes_sorted():
            yield k, (line[tab + 1 :] if tab >= 0 else b"")

    def iter_display_bytes_sorted(self):
        """The display lines, ``b"<key> <value>\\n"``, in (file, line)
        order: bytes in, bytes out (a file name that is not UTF-8 passes
        through as its bytes, as GNU grep prints it)."""
        for _k, line, _tab in self._iter_records_bytes_sorted():
            yield line.replace(b"\t", b" ", 1) + b"\n"

    # Outputs up to this size may take the library's merge or the
    # vectorized display pass, which hold a few times the output (the
    # joined buffer and the result; for the vectorized pass the prefix and
    # digit windows and the int64 gather index); larger outputs keep the
    # record merge, one record resident per file.
    DISPLAY_VECTOR_CAP = 128 << 20

    def display_blocks_sorted(self):
        """The display output as bytes blocks in (file, line) order: the
        same bytes as ``iter_display_bytes_sorted`` joined.  Up to
        DISPLAY_VECTOR_CAP, the library merges the files in one block
        (``native.merge_display``, several paths too); where it declines
        (a line that is not grep-key-shaped), an output of one path takes
        the vectorized pass; anything else, and larger outputs, the record
        merge."""
        total = sum(p.stat().st_size for p in self.output_files)
        if 0 < total <= self.DISPLAY_VECTOR_CAP:
            if self.fileline_sorted:
                block = native.merge_display(
                    [p.read_bytes() for p in self.output_files])
                if block is not None:
                    if block:
                        yield block
                    return
            block = self._single_path_display_block()
            if block is not None:
                yield block
                return
        yield from self.iter_display_bytes_sorted()

    def _single_path_display_block(self) -> bytes | None:
        """The vectorized display pass over an output of one path, or
        None when the output is not that (the caller falls back): every
        file must end in a newline (or a record would fuse across files),
        and every line must be ``<path> (line number #<1-18 digits>)\\t``
        then its value, with the same path."""
        parts = [p.read_bytes() for p in self.output_files]
        if any(part and not part.endswith(b"\n") for part in parts):
            return None
        buf = b"".join(parts)
        del parts
        if not buf:
            return None
        arr = np.frombuffer(buf, dtype=np.uint8)
        nl = newline_index(buf)
        starts = np.concatenate(([0], nl[:-1] + 1)).astype(np.int64)
        keep = nl > starts  # drop empty lines
        starts, ends = starts[keep], nl[keep]
        if not starts.size:
            return None
        first = buf[int(starts[0]) : int(ends[0])]
        tab = first.find(b"\t")
        parsed = parse_grep_key_bytes(first[:tab] if tab >= 0 else first)
        if parsed is None:
            return None
        prefix = parsed[0] + _GREP_KEY_MARKER
        plen = len(prefix)
        if np.any(ends - starts < plen + 2):
            return None  # a line too short for the prefix, a digit and ')'
        win = arr[starts[:, None] + np.arange(plen)]
        same_prefix = bool((win == np.frombuffer(prefix, np.uint8)).all())
        del win
        if not same_prefix:
            return None
        # up to 19 bytes after the prefix: 1-18 digits, then a non-digit
        max_d = 19
        dwin = arr[np.minimum(starts[:, None] + plen + np.arange(max_d),
                              arr.size - 1)]
        isdig = (dwin >= 0x30) & (dwin <= 0x39)
        ndig = np.where(isdig.all(axis=1), max_d,
                        np.argmin(isdig, axis=1)).astype(np.int64)
        if np.any(ndig == 0) or np.any(ndig >= max_d):
            return None
        after = starts + plen + ndig  # must hold ')' then the tab
        if not ((arr[np.minimum(after, arr.size - 1)] == 0x29).all()
                and (arr[np.minimum(after + 1, arr.size - 1)] == 0x09).all()):
            return None
        linenos = np.zeros(starts.size, dtype=np.int64)
        for k in range(int(ndig.max())):
            active = ndig > k
            linenos[active] = (linenos[active] * 10
                               + dwin[active, k].astype(np.int64) - 0x30)
        del dwin, isdig
        order = np.argsort(linenos, kind="stable")
        slab, offsets = gather_ranges(arr, starts[order], ends[order] + 1)
        out = np.frombuffer(slab, dtype=np.uint8).copy()
        out[offsets[:-1] + plen + ndig[order] + 1] = 0x20  # the tab
        return out.tobytes()


def plan_map_splits(input_files: list[str], batch_bytes: int,
                    small_bytes: int | None = None) -> list:
    """Group consecutive small input files into multi-file map splits
    (the reference's runtime/job.plan_map_splits, without its shard-index
    pruner): a file of at least ``small_bytes`` (default the engine's
    device_min_bytes, DGREP_DEVICE_MIN_BYTES) keeps a task of its own, as
    does one that cannot be statted (its map reports the error); runs of
    smaller files become lists whose packed size (a file plus its
    terminator) fits ``batch_bytes``.  Consecutive grouping keeps the
    plan deterministic and the members in input order.  ``batch_bytes``
    <= 0, or fewer than two files, gives the files as they are."""
    if batch_bytes <= 0 or len(input_files) < 2:
        return list(input_files)
    if small_bytes is None:
        small_bytes = env_device_min_bytes()
    out: list = []
    group: list[str] = []
    group_bytes = 0

    def close() -> None:
        nonlocal group, group_bytes
        if group:
            out.append(group[0] if len(group) == 1 else group)
            group, group_bytes = [], 0

    for f in input_files:
        try:
            size = os.path.getsize(f)
        except OSError:
            size = None
        if size is None or size >= small_bytes:
            close()
            out.append(f)
            continue
        if group and group_bytes + size + 1 > batch_bytes:
            close()
        group.append(f)
        group_bytes += size + 1
    close()
    return out


def job_device(app: LoadedApplication, options: dict) -> str | None:
    """The device an application's tasks run on: None for an application
    that launches no kernel (it does not declare ``uses_device``) or for
    the host backend, else the options' "device" (default "cuda")."""
    if not getattr(app.module, "uses_device", False):
        return None
    if options.get("backend", "device") == "cpu":
        return None
    return str(options.get("device", "cuda"))


def run_job(
    config: JobConfig,
    n_workers: int = 2,
    app: LoadedApplication | None = None,
    resume: bool = False,
    device: str | None = None,
    fault_hooks_per_worker: list[dict] | None = None,
    store_faults_per_worker: list[dict] | None = None,
) -> JobResult:
    """Run the job to completion: a Scheduler, ``n_workers`` worker threads
    each on a LocalTransport, and the application named by the config (a
    fresh module instance, apps/loader.py) unless ``app`` is given.
    For an application that uses the card, ``device`` overrides the app
    option of the same name; with neither, the job runs on "cuda".  With
    the app option ``backend="cpu"`` (the host scanners), or an
    application that launches no kernel, the device is never asked for.
    ``resume`` replays the work dir's journal and skips the tasks it records; else the work dir
    is cleared.  ``store_faults_per_worker`` wraps each worker's commits
    in a FaultStore (runtime/store.py CrashPoint hooks)."""
    from distributed_grep_tpu_torch.runtime.store import FaultStore, make_store

    opts = config.effective_app_options()
    loaded = app is None
    if loaded:
        app = load_application(config.application)
    try:
        if getattr(app.module, "uses_device", False):
            opts["device"] = str(device if device is not None
                                 else opts.get("device", "cuda"))
        run_device = job_device(app, opts)
        if run_device is not None:
            resolve_device(run_device)  # fail before any worker starts
        # the host library builds before the scheduler hands out a task,
        # so no task's failure detector waits on g++
        native.lib()
    except BaseException:
        if loaded:
            sys.modules.pop(app.module.__name__, None)
        raise
    work_dir = config.work_dir or tempfile.mkdtemp(prefix="dgrep-")
    workdir = WorkDir(work_dir, store=make_store(config.store,
                                                 durable=config.durable))
    resume_entries = None
    if resume:
        if config.journal:
            resume_entries = TaskJournal.replay(workdir.journal_path())
    else:
        workdir.clear()  # a reused work dir leaks nothing into this job
    journal = TaskJournal(workdir.journal_path()) if config.journal else None
    spans_on = spans_mod.enabled(config.spans)
    event_log = (spans_mod.EventLog(workdir.root / spans_mod.EventLog.FILENAME,
                                    fresh=not resume)
                 if spans_on else None)
    job_id = config.effective_job_id(work_dir)
    scheduler = Scheduler(
        files=plan_map_splits(list(config.input_files),
                              config.effective_batch_bytes()),
        n_reduce=config.n_reduce,
        task_timeout_s=config.task_timeout_s,
        sweep_interval_s=config.sweep_interval_s,
        app_options=opts,
        journal=journal,
        resume_entries=resume_entries,
        commit_resolver=workdir.resolve_task_commit,
        event_log=event_log,
    )
    spill_dir = config.spill_dir or str(Path(work_dir) / "spill")
    errors: list[BaseException] = []

    def worker_main(idx: int) -> None:
        hooks = (fault_hooks_per_worker or [{}] * n_workers)[idx]
        sfaults = (store_faults_per_worker or [{}] * n_workers)[idx]
        store = FaultStore(workdir.store, sfaults) if sfaults else None
        loop = WorkerLoop(
            LocalTransport(scheduler, workdir,
                           rpc_timeout_s=config.rpc_timeout_s, store=store),
            app, fault_hooks=hooks,
            reduce_memory_bytes=config.reduce_memory_bytes,
            spill_dir=spill_dir, spans_enabled=spans_on, job_id=job_id)
        try:
            loop.run()
        except WorkerKilled:
            log.info("worker thread %d killed by fault injection", idx)
        except BaseException as e:  # noqa: BLE001 -- re-raised below
            # a build, launch or CUDA error fails the job: it is never
            # retried on another route
            errors.append(e)
            scheduler.stop()

    threads = [
        threading.Thread(target=worker_main, args=(i,), name=f"worker-{i}",
                         daemon=True)
        for i in range(n_workers)
    ]
    try:
        with trace.job_trace(device=run_device):
            for t in threads:
                t.start()
            while not scheduler.wait_done(timeout=0.5):
                if errors:
                    break
                if all(not t.is_alive() for t in threads):
                    scheduler.stop()
                    raise RuntimeError(
                        "job aborted: all workers exited with tasks "
                        "outstanding")
            scheduler.stop()
            for t in threads:
                t.join()
    finally:
        scheduler.stop()
        scheduler.close_journal()
        if event_log is not None:
            event_log.close()
        if loaded:  # the job's own module instance goes with the job
            sys.modules.pop(app.module.__name__, None)
    if errors:
        raise errors[0]
    return JobResult(
        output_files=workdir.list_outputs(),
        metrics={"counters": dict(scheduler.counters),
                 "seconds": dict(scheduler.seconds), "work_dir": work_dir},
        fileline_sorted=bool(getattr(app.module, "reduce_is_identity",
                                     False)),
    )
