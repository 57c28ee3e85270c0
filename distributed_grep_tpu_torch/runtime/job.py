"""In-process job runner: coordinator + N worker threads, one call.

``run_job(config, n_workers, device=...)`` runs every input file as its
own map task through the application named by ``config.application``
(default: the CUDA grep app) and returns the committed ``mr-out-*``
files.  The device defaults to "cuda" and raises when CUDA is absent,
unless the caller asks for "cpu".  A worker that raises anything but
WorkerKilled fails the job with that exception: a build, launch or CUDA
error is never retried on another route.
"""

from __future__ import annotations

import heapq
import importlib
import logging
import tempfile
import threading
from dataclasses import dataclass, field
from pathlib import Path

from distributed_grep_tpu_torch.runtime.scheduler import Scheduler
from distributed_grep_tpu_torch.runtime.columnar import (
    GREP_KEY_RE,
    grep_key_sort,
)
from distributed_grep_tpu_torch.runtime.worker import WorkerKilled, WorkerLoop
from distributed_grep_tpu_torch.utils.config import JobConfig
from distributed_grep_tpu_torch.utils.device import resolve_device
from distributed_grep_tpu_torch.utils.io import WorkDir

log = logging.getLogger("distributed_grep_tpu_torch.job")

__all__ = ["GREP_KEY_RE", "JobResult", "grep_key_sort", "run_job"]


@dataclass
class JobResult:
    """Job outputs, backed by the work dir's mr-out-* files."""

    output_files: list[Path]
    metrics: dict = field(default_factory=dict)
    # every output file is in (file, line) order (identity-reduce apps)
    fileline_sorted: bool = False

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
        the per-file streams when each is already in that order, else one
        in-memory sort."""
        if self.fileline_sorted:
            yield from heapq.merge(
                *(self._iter_file(p) for p in self.output_files),
                key=grep_key_sort,
            )
        else:
            yield from sorted(self.iter_results(), key=grep_key_sort)


def run_job(
    config: JobConfig,
    n_workers: int = 2,
    device: str | None = None,
    fault_hooks_per_worker: list[dict] | None = None,
) -> JobResult:
    """Run the job to completion.  ``device`` overrides the app option of
    the same name; with neither, the job runs on "cuda"."""
    opts = dict(config.app_options)
    opts["device"] = str(device if device is not None
                         else opts.get("device", "cuda"))
    resolve_device(opts["device"])  # fail before any worker starts
    app = importlib.import_module(config.application)
    work_dir = config.work_dir or tempfile.mkdtemp(prefix="dgrep-")
    workdir = WorkDir(work_dir)
    workdir.clear()
    scheduler = Scheduler(
        files=list(config.input_files),
        n_reduce=config.n_reduce,
        task_timeout_s=config.task_timeout_s,
        app_options=opts,
    )
    errors: list[BaseException] = []

    def worker_main(idx: int) -> None:
        hooks = (fault_hooks_per_worker or [{}] * n_workers)[idx]
        try:
            WorkerLoop(scheduler, workdir, app, fault_hooks=hooks).run()
        except WorkerKilled:
            log.info("worker thread %d killed by fault injection", idx)
        except BaseException as e:  # noqa: BLE001 -- re-raised below
            errors.append(e)
            scheduler.stop()

    threads = [
        threading.Thread(target=worker_main, args=(i,), name=f"worker-{i}",
                         daemon=True)
        for i in range(n_workers)
    ]
    for t in threads:
        t.start()
    while not scheduler.wait_done(timeout=0.5):
        if errors:
            break
        if all(not t.is_alive() for t in threads):
            scheduler.stop()
            raise RuntimeError(
                "job aborted: all workers exited with tasks outstanding"
            )
    scheduler.stop()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return JobResult(
        output_files=workdir.list_outputs(),
        metrics={"counters": dict(scheduler.counters),
                 "seconds": dict(scheduler.seconds), "work_dir": work_dir},
        fileline_sorted=bool(getattr(app, "reduce_is_identity", False)),
    )
