"""CUDA grep application: the counterpart of the reference's apps/grep_tpu.

Same Map/Reduce contract and the same output records: key
``"<filename> (line number #N)"``, value the line's bytes decoded
utf-8/replace; Reduce is the identity (keys are unique per (file, line)).
The scan is GrepEngine's (the CUDA Shift-And kernel for literals and
byte-class sequences, the FDR filter and pairset kernels for literal sets
-- ``patterns`` -- and for regexes that denote one, the Glushkov NFA kernel
for other regexes, the Wu-Manber kernel for ``max_errors=k`` approximate
matching; the host scanners where the engine routes a pattern there, and
for every pattern with ``backend="cpu"``).  Map emits a file's matched lines as columnar batches
(runtime/columnar.py), never one record per line:

* ``map_path_fn`` (what the worker calls) streams the file through
  ``GrepEngine.scan_file`` in newline-aligned chunks: a file that fits one
  chunk gives one ``DeferredBatch`` over its bytes, a longer one a batch a
  chunk;
* ``map_fn`` scans bytes in hand and gives one ``DeferredBatch``;
* ``map_batch_fn`` (a batched split of small files, runtime/job
  plan_map_splits) scans the members through ``GrepEngine.scan_batch``,
  packed into shared windows, and builds each member's records as
  ``map_fn`` would (``map_batch_paths``: the worker hands it paths, which
  the engine reads or serves from the corpus cache).

Options, as the reference's: ``invert`` (grep -v, the complement of the
selected lines: ``map_path_fn`` reads the whole file for it),
``word_regexp`` / ``line_regexp`` (grep -w / -x: the card scans the plain
pattern and the host confirms each candidate line against the
boundary-wrapped regex, apps/grep.build_confirm), ``count_only`` (grep -c:
one record per file, key the filename, value the selected line count) and
``presence_only`` (with count_only, grep -q/-l/-L: only whether a file's
count is nonzero is meaningful; the stream may stop at the first chunk
with a selected line).  As in the reference, -w/-x with one case-sensitive
literal (a Shift-And pattern of single bytes) selects its lines with
``apps/grep.literal_mode_lines`` (one scan of the host library for the
literal, then byte masks) in place of the regex over each candidate line.

The device mesh and the shard index raise NotImplementedError naming the
ROADMAP.md item that will port them; the port drives one card, so
``devices`` raises too.  A falsy value of such an option
(``index_dir=None``) is accepted and dropped.

With the span pipeline on (utils/spans.py), each record build (a whole
input's, or a streamed chunk's) is a ``map:emit`` span, which separates
record-build time from the engine's ``scan:<mode>`` spans.
"""

from __future__ import annotations

import os
import threading

import numpy as np

from distributed_grep_tpu_torch.apps.base import KeyValue
from distributed_grep_tpu_torch.apps.grep import (
    build_confirm,
    literal_mode_lines,
)
from distributed_grep_tpu_torch.ops.engine import GrepEngine
from distributed_grep_tpu_torch.ops.lines import count_lines, newline_index
from distributed_grep_tpu_torch.runtime.columnar import (
    DeferredBatch,
    line_spans,
    make_batch_from_lines,
)
from distributed_grep_tpu_torch.utils import spans as spans_mod

# this application launches kernels: the runtime checks its device
# (runtime/job.job_device) before a task runs
uses_device = True

# keys are unique per (file, line) and Reduce is values[0]: the runtime
# collates each reduce partition in (file, line) order, batches columnar
reduce_is_identity = True

_engine: GrepEngine | None = None
_configured_with: tuple | None = None
_lock = threading.Lock()
_invert = False  # grep -v
_confirm = None  # -w/-x: the boundary-wrapped host regex over candidates
_confirm_lit: bytes | None = None  # -w/-x on one case-sensitive literal
_confirm_mode = "search"
_count_only = False  # one count record per file
_presence = False  # -q/-l/-L: per-file truthiness only

# The worker installs a progress callback per task (thread-local: worker
# threads share this module); the engine calls it once per segment.
_progress = threading.local()

_UNPORTED = {
    "devices": "item 9 (multi-GPU)",
    "mesh_shape": "item 9 (multi-GPU)",
    "mesh_axes": "item 9 (multi-GPU)",
    "pattern_axis": "item 9 (multi-GPU)",
    "index_dir": "item 8 (the service runtime)",
}


def set_progress(fn) -> bool:
    """Worker hook: install (fn) or clear (None) this task's progress
    callback -- fn() stamps liveness, fn(grace_s=N) declares a silent
    phase of N seconds (the engine's kernel build)."""
    _progress.fn = fn
    return True


def _progress_fn():
    return getattr(_progress, "fn", None)


def configure(
    pattern: str | bytes = "",
    ignore_case: bool = False,
    device: str = "cuda",
    patterns: list[str | bytes] | None = None,
    backend: str = "device",
    invert: bool = False,
    word_regexp: bool = False,
    line_regexp: bool = False,
    count_only: bool = False,
    presence_only: bool = False,
    **options: object,
) -> None:
    """Compile the pattern, or the literal set ``patterns`` when given
    (members str, decoded utf-8/surrogateescape, or bytes; ``pattern`` is
    then ignored), for ``device`` (default "cuda"; raises when CUDA is
    absent unless "cpu" is asked for).  ``backend="cpu"`` scans every
    plan with the host scanners (ops/engine.py) and never asks for the
    device.  ``max_errors=k`` (1..3) matches
    the single pattern within k edit errors.  Engine knobs (target_lanes,
    segment_bytes, min_chunk) pass through ``options``; the grep options
    are the module docstring's."""
    global _engine, _configured_with, _invert, _confirm, _count_only, \
        _presence, _confirm_lit, _confirm_mode
    for name, value in options.items():
        if name in _UNPORTED and value:
            raise NotImplementedError(
                f"grep option {name!r} is not ported yet: ROADMAP.md "
                f"'Slices still to port', {_UNPORTED[name]}"
            )
    engine_opts = {k: v for k, v in options.items() if k not in _UNPORTED}
    if isinstance(pattern, bytes):
        pattern = pattern.decode("utf-8", "surrogateescape")
    if patterns is not None:
        pattern, patterns = None, list(patterns)
    mode = "line" if line_regexp else ("word" if word_regexp else "search")
    key = (pattern, tuple(patterns or ()), bool(ignore_case), str(device),
           backend, bool(invert), mode, tuple(sorted(engine_opts.items())))
    with _lock:
        _invert = bool(invert)
        _count_only = bool(count_only)
        _presence = bool(presence_only)
        if key == _configured_with:
            return
        _engine = GrepEngine(pattern, patterns=patterns,
                             ignore_case=ignore_case, device=device,
                             backend=backend, **engine_opts)  # type: ignore[arg-type]
        _confirm = build_confirm(pattern=pattern, patterns=patterns,
                                 ignore_case=ignore_case, mode=mode)
        _confirm_mode = mode
        _confirm_lit = (_engine.literal() if _confirm is not None
                        and patterns is None and not ignore_case else None)
        _configured_with = key


def _stamp_every(progress, i: int, stride: int = 16384) -> None:
    """Liveness inside the per-line confirm loops: the engine's stamps stop
    when the scan returns, and confirming millions of candidates can
    outlast the task timeout by itself."""
    if progress is not None and i % stride == 0:
        progress()


def _confirmed(lines: np.ndarray, spans, data) -> np.ndarray:
    """The candidate ``lines`` whose bytes (``spans`` into ``data``) the
    -w/-x confirm regex accepts.  Each line is its own memoryview slice,
    so the regex anchors see the line as the whole string."""
    progress = _progress_fn()
    mv = memoryview(data)
    starts, ends = (x.tolist() for x in spans)

    def verdicts():
        for i in range(lines.size):
            _stamp_every(progress, i)
            yield _confirm.search(mv[starts[i]:ends[i]]) is not None

    return lines[np.fromiter(verdicts(), dtype=bool, count=lines.size)]


def _records_for(filename: str, contents: bytes, result) -> list:
    """Everything after a whole-bytes scan: the -w/-x confirm, -v, the
    count record, the columnar batch (a ``map:emit`` span)."""
    with spans_mod.span("map:emit", cat="map"):
        return _records_inner(filename, contents, result)


def _records_inner(filename: str, contents: bytes, result) -> list:
    emit = result.matched_lines
    nl = result.nl_index
    if _confirm is not None and emit.size:
        if nl is None:
            nl = newline_index(contents)
        if _confirm_lit is not None:
            emit = np.intersect1d(emit, literal_mode_lines(
                contents, _confirm_lit, _confirm_mode, nl))
        else:
            emit = _confirmed(emit, line_spans(emit, nl, len(contents)),
                              contents)
    if _invert:
        emit = np.setdiff1d(np.arange(1, count_lines(contents) + 1,
                                      dtype=np.int64), emit)
    if _count_only:
        return [KeyValue(filename, str(int(emit.size)))]
    if not emit.size:
        return []
    if nl is None:
        nl = newline_index(contents)
    return [DeferredBatch(filename, emit, np.frombuffer(contents, np.uint8),
                          nl, len(contents))]


def _check_configured() -> GrepEngine:
    if _engine is None:
        raise RuntimeError("grep_cuda used before configure() -- no pattern set")
    return _engine


def map_fn(filename: str, contents: bytes) -> list:
    result = _check_configured().scan(contents, progress=_progress_fn())
    return _records_for(filename, contents, result)


# a batched split's items are (filename, path): scan_batch reads them, or
# serves a warm window from the corpus cache with no read
map_batch_paths = True


def map_batch_fn(items) -> list:
    """A batched split in one call: the engine packs the members into
    shared windows (GrepEngine.scan_batch) and each member's records are
    those ``map_fn`` gives for its bytes."""
    records: list = []
    _check_configured().scan_batch(
        items, progress=_progress_fn(),
        emit=lambda name, data, res: records.extend(
            _records_for(name, data, res)))
    return records


def map_path_fn(filename: str, path: str) -> list:
    """Streaming map: scan ``path`` in newline-aligned chunks
    (GrepEngine.scan_file) and build the records while each chunk is in
    memory.  grep -v needs every line the stream does not select, so it
    reads the whole file and takes ``map_fn``'s path."""
    engine = _check_configured()
    progress = _progress_fn()
    if _invert:
        with open(path, "rb") as f:
            return map_fn(filename, f.read())
    if _count_only:
        if _confirm is None:
            res = engine.scan_file(path, progress=progress,
                                   stop_after_match=_presence)
            return [KeyValue(filename, str(len(res.matched_lines)))]
        # the engine's matches are pre-confirm: presence stops on the
        # first confirmed line, through ``stop``
        n = 0

        def count_chunk(lines_before: int, buf: bytes, lines, nl) -> None:
            nonlocal n
            if _confirm_lit is not None:
                n += literal_mode_lines(buf, _confirm_lit, _confirm_mode,
                                        nl).size
            else:
                n += _confirmed(lines, line_spans(lines, nl, len(buf)),
                                buf).size

        engine.scan_file(path, emit_chunk=count_chunk, progress=progress,
                         stop=(lambda: n > 0) if _presence else None)
        return [KeyValue(filename, str(n))]
    batches: list = []
    file_size = os.path.getsize(path)

    def emit_chunk(lines_before: int, buf: bytes, lines, nl) -> None:
        with spans_mod.span("map:emit", cat="map"):
            emit_inner(lines_before, buf, lines, nl)

    def emit_inner(lines_before: int, buf: bytes, lines, nl) -> None:
        arr = np.frombuffer(buf, dtype=np.uint8)
        if _confirm_lit is not None:
            lines = lines[np.isin(lines, literal_mode_lines(
                buf, _confirm_lit, _confirm_mode, nl))]
            if not lines.size:
                return
        if (lines_before == 0 and len(buf) == file_size
                and (_confirm is None or _confirm_lit is not None)):
            # the whole file is this one chunk: the buffer lives as long as
            # a whole-bytes map's, so the slab gather waits for the shuffle
            batches.append(DeferredBatch(filename, lines, arr, nl, len(buf)))
            return
        if _confirm is not None and _confirm_lit is None:
            lines = _confirmed(lines, line_spans(lines, nl, len(buf)), buf)
            if not lines.size:
                return
        batches.append(make_batch_from_lines(filename, lines, arr, nl,
                                             len(buf), lineno_base=lines_before))

    engine.scan_file(path, emit_chunk=emit_chunk, progress=progress)
    return batches


def reduce_fn(key: str, values: list[str]) -> str:
    return values[0]
