"""torch.profiler integration: a job's host and device trace, and named
regions (the reference's utils/trace.py, on torch.profiler in place of
jax.profiler).

``job_trace`` wraps a whole job in a ``torch.profiler.profile`` that
records CPU activity from every thread of the process, and CUDA activity
(kernels, copies) when the job's device is ``cuda``; on exit it writes a
Chrome trace (Perfetto, chrome://tracing, TensorBoard) into the trace
directory, one file per process and job (``trace-<pid>-<n>.json``), so a
coordinator and its worker processes never overwrite each other.
``annotate`` marks task phases as ``record_function`` regions, and on a
``cuda`` job also as NVTX ranges, which an ``nsys`` run sees; the worker
names them as the reference does (``map_read:<id>``,
``map_compute:<id>``, ``reduce_compute:<id>``), beside the span
pipeline's ``map:read``/``map:compute`` spans of utils/spans.py.

Everything is a no-op, and the profiler is never imported, unless tracing
is on: a ``trace_dir`` passed in, or DGREP_TRACE_DIR in the environment.
A ``cuda`` job on a torch without CUDA profiling raises rather than write
a trace with the device left out.
"""

from __future__ import annotations

import itertools
import os
import threading
from contextlib import contextmanager, nullcontext
from pathlib import Path

from distributed_grep_tpu_torch.utils.logging import get_logger

log = get_logger("trace")

_ENV_VAR = "DGREP_TRACE_DIR"

_lock = threading.Lock()
_active = False  # a job_trace holds the profiler (one per process)
_nvtx = False  # the active job_trace is a cuda job's: regions are NVTX too
_seq = itertools.count()


def trace_dir() -> str | None:
    """The active trace directory, or None when tracing is off."""
    return os.environ.get(_ENV_VAR) or None


def enabled() -> bool:
    return trace_dir() is not None


def _profile_kwargs(torch, cuda: bool) -> dict:
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if cuda:
        if ProfilerActivity.CUDA not in torch.profiler.supported_activities():
            raise RuntimeError(
                "DGREP_TRACE_DIR: the job runs on cuda but this torch "
                "cannot profile CUDA activity; unset DGREP_TRACE_DIR")
        activities.append(ProfilerActivity.CUDA)
    kw: dict = {"activities": activities}
    try:
        # regions of the worker threads, the prepare thread and the collect
        # pool: the default records only the thread that starts it
        kw["experimental_config"] = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except (AttributeError, TypeError):
        log.warning("this torch records only the tracing thread's regions")
    return kw


@contextmanager
def job_trace(out_dir: str | None = None, device: str | None = None):
    """Trace the job run in the body; yields the trace file's path, or
    None when tracing is off or another job_trace of this process holds
    the profiler (the outer trace records this job too).  ``device``
    "cuda" (or "cuda:<i>") records the card's activity as well."""
    global _active, _nvtx
    d = out_dir or trace_dir()
    if d is None:
        yield None
        return
    with _lock:
        nested = _active
        _active = True
    if nested:
        yield None
        return
    try:
        import torch

        cuda = str(device or "").startswith("cuda")
        prof = torch.profiler.profile(**_profile_kwargs(torch, cuda))
        os.makedirs(d, exist_ok=True)
        path = Path(d) / f"trace-{os.getpid()}-{next(_seq)}.json"
        log.info("profiler trace -> %s", path)
        _nvtx = cuda
        with prof:
            yield path
        prof.export_chrome_trace(str(path))
    finally:
        with _lock:
            _active = False
            _nvtx = False


@contextmanager
def _region(name: str):
    import torch

    if _nvtx:
        with torch.cuda.nvtx.range(name), \
                torch.profiler.record_function(name):
            yield
    else:
        with torch.profiler.record_function(name):
            yield


def annotate(name: str):
    """A named region in the profiler's timeline; a nullcontext when
    tracing is off, so callers annotate unconditionally."""
    if not enabled():
        return nullcontext()
    return _region(name)


def step_trace(name: str, step: int):
    """A region named ``<name>#<step>``, one per numbered pass."""
    if not enabled():
        return nullcontext()
    return _region(f"{name}#{step}")
