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

``index_dir`` (the reference's) attaches the shard index's persistent
store (index/store.py) there: the engine publishes a trigram summary of
each shard it reads whole, and a later job with the same ``index_dir``
never opens a shard whose summary proves that no line can match
(``map_batch_fn`` prunes members unless -v, whose complement needs the
bytes).  A later configure without it detaches the store.

``map_fused_fn`` answers K participants' queries over one split with one
union scan a window (ops/fuse.FusedScanner), each participant's records
built with its own options (``_EmitOpts``), equal to its solo
``map_batch_fn``'s.  The worker's fused map attempt calls it
(runtime/worker.py), for the assignments the service daemon's planner
fuses (runtime/service.py).

``configure`` takes its engine from the cross-job cache
(ops/engine.cached_engine): a job whose query an earlier job of the
process compiled reuses that engine and skips the build, and a
``cache:hit|miss|off`` instant says which.

The cards, as the reference's: ``devices`` (default "all", every local
card; None the one ``device``; or a list, an int i naming card i)
round-robins a scan's segments over them; ``mesh_shape`` (e.g. [4] or
[2, 2]) with ``mesh_axes`` (default ["data"]) builds a mesh
(parallel/mesh.py) and shards each segment's lanes over it instead.  A
``devices`` list given beside ``mesh_shape`` names the mesh's entries (a
card may repeat: four entries of cuda:0 on a host of one card); without
it the mesh spans every local card, or on ``device="cpu"`` as many host
entries as the shape needs (under a process group, each rank's share of
them).  ``pattern_axis`` (with ``mesh_shape``) names the axis a literal
set's FDR banks shard over: lanes shard over every other axis, and a
``pattern_axis`` that leaves none raises ValueError (the reference's
apps/grep_tpu.py:118-134).

With the span pipeline on (utils/spans.py), each record build (a whole
input's, or a streamed chunk's) is a ``map:emit`` span, which separates
record-build time from the engine's ``scan:<mode>`` spans.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import torch

from distributed_grep_tpu_torch.apps.base import KeyValue
from distributed_grep_tpu_torch.apps.grep import (
    build_confirm,
    literal_mode_lines,
)
from distributed_grep_tpu_torch.ops.engine import GrepEngine, cached_engine
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

# options not ported yet, each naming its ROADMAP.md item (none now)
_UNPORTED: dict[str, str] = {}
# the options that pick the cards (module docstring): configure turns
# them into the engine's devices or mesh
_CARD_OPTIONS = ("devices", "mesh_shape", "mesh_axes", "pattern_axis")


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
    index_dir: object = None,
    devices: object = "all",
    mesh_shape: object = None,
    mesh_axes: object = ("data",),
    pattern_axis: object = None,
    **options: object,
) -> None:
    """Compile the pattern, or the literal set ``patterns`` when given
    (members str, decoded utf-8/surrogateescape, or bytes; ``pattern`` is
    then ignored), for ``device`` (default "cuda"; raises when CUDA is
    absent unless "cpu" is asked for).  ``backend="cpu"`` scans every
    plan with the host scanners (ops/engine.py) and never asks for the
    device.  ``max_errors=k`` (1..3) matches
    the single pattern within k edit errors.  Engine knobs (target_lanes,
    segment_bytes, min_chunk) pass through ``options``; the grep options,
    ``index_dir`` and the cards (``devices``, ``mesh_shape``,
    ``mesh_axes``, ``pattern_axis``) are the module docstring's."""
    global _engine, _configured_with, _invert, _confirm, _count_only, \
        _presence, _confirm_lit, _confirm_mode
    if index_dir is not None or _configured_with is not None:
        # before the same-config return: the store follows each job, and
        # a first configure without one never imports the index
        from distributed_grep_tpu_torch.index import summary as index_summary

        index_summary.attach_store(index_dir if index_dir else None)
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
           backend, bool(invert), mode, tuple(sorted(engine_opts.items())),
           ((devices, mesh_shape, mesh_axes, pattern_axis)
            if backend == "device" else None))
    with _lock:
        _invert = bool(invert)
        _count_only = bool(count_only)
        _presence = bool(presence_only)
        if key == _configured_with:
            return
        # the cross-job engine cache (ops/engine.cached_engine): a
        # repeated query gets the same engine, its models and uploaded
        # tables, and skips its build; the verdict lands on the task's
        # trace row when the span pipeline is on
        if backend == "device":
            engine_opts.update(card_options(device, devices, mesh_shape,
                                            mesh_axes, pattern_axis))
        _engine, cache_verdict = cached_engine(
            pattern, patterns=patterns, ignore_case=ignore_case,
            device=device, backend=backend,
            **engine_opts)  # type: ignore[arg-type]
        spans_mod.instant(f"cache:{cache_verdict}", cat="engine",
                          mode=_engine.mode)
        _confirm = build_confirm(pattern=pattern, patterns=patterns,
                                 ignore_case=ignore_case, mode=mode)
        _confirm_mode = mode
        _confirm_lit = (_engine.literal() if _confirm is not None
                        and patterns is None and not ignore_case else None)
        _configured_with = key


def card_options(device, devices, mesh_shape, mesh_axes,
                 pattern_axis=None) -> dict:
    """The engine's ``devices`` or ``mesh`` for these app options (the
    module docstring)."""
    if not mesh_shape:
        return {"devices": devices}
    from distributed_grep_tpu_torch.parallel.mesh import (
        make_mesh,
        resolve_devices,
    )
    from distributed_grep_tpu_torch.parallel.multihost import process_count

    shape = tuple(int(x) for x in mesh_shape)
    axes = tuple(mesh_axes)
    if isinstance(devices, (list, tuple)):
        entries = resolve_devices(devices, device)
    elif torch.device(device).type == "cpu":
        entries = ["cpu"] * -(-int(np.prod(shape)) // process_count())
    else:
        entries = None  # every local card
    # lanes shard over every axis not reserved for the pattern banks
    lane_axes = tuple(a for a in axes if a != pattern_axis)
    if not lane_axes:
        raise ValueError(f"pattern_axis {pattern_axis!r} consumes every "
                         f"mesh axis {axes}: no axis left for document "
                         f"lanes")
    opts = {"mesh": make_mesh(shape, axes, devices=entries),
            "mesh_axis": lane_axes[0] if len(lane_axes) == 1 else lane_axes}
    if pattern_axis:
        opts["pattern_axis"] = pattern_axis
    return opts


def _stamp_every(progress, i: int, stride: int = 16384) -> None:
    """Liveness inside the per-line confirm loops: the engine's stamps stop
    when the scan returns, and confirming millions of candidates can
    outlast the task timeout by itself."""
    if progress is not None and i % stride == 0:
        progress()


def _confirmed(confirm, lines: np.ndarray, spans, data) -> np.ndarray:
    """The candidate ``lines`` whose bytes (``spans`` into ``data``) the
    -w/-x ``confirm`` regex accepts.  Each line is its own memoryview
    slice, so the regex anchors see the line as the whole string."""
    progress = _progress_fn()
    mv = memoryview(data)
    starts, ends = (x.tolist() for x in spans)

    def verdicts():
        for i in range(lines.size):
            _stamp_every(progress, i)
            yield confirm.search(mv[starts[i]:ends[i]]) is not None

    return lines[np.fromiter(verdicts(), dtype=bool, count=lines.size)]


class _EmitOpts:
    """A query's options after the scan (what configure() keeps in the
    module's globals), as an object: map_fused_fn builds K participants'
    records side by side without configuring the module again."""

    __slots__ = ("confirm", "confirm_lit", "confirm_mode", "invert",
                 "count_only")

    def __init__(self, confirm, confirm_lit, confirm_mode, invert,
                 count_only):
        self.confirm = confirm
        self.confirm_lit = confirm_lit
        self.confirm_mode = confirm_mode
        self.invert = invert
        self.count_only = count_only


def _module_emit_opts() -> _EmitOpts:
    return _EmitOpts(_confirm, _confirm_lit, _confirm_mode, _invert,
                     _count_only)


def _records_for(filename: str, contents: bytes, result,
                 opts: _EmitOpts | None = None, nl=None) -> list:
    """Everything after a whole-bytes scan: the -w/-x confirm, -v, the
    count record, the columnar batch (a ``map:emit`` span); with the
    module's options unless ``opts``.  ``nl``: the newline index of
    ``contents`` where the caller has one."""
    with spans_mod.span("map:emit", cat="map"):
        return _records_inner(filename, contents, result,
                              opts or _module_emit_opts(), nl)


def _records_inner(filename: str, contents: bytes, result, o: _EmitOpts,
                   nl=None) -> list:
    emit = result.matched_lines
    if nl is None:
        nl = result.nl_index
    if o.confirm is not None and emit.size:
        if nl is None:
            nl = newline_index(contents)
        if o.confirm_lit is not None:
            emit = np.intersect1d(emit, literal_mode_lines(
                contents, o.confirm_lit, o.confirm_mode, nl))
        else:
            emit = _confirmed(o.confirm, emit,
                              line_spans(emit, nl, len(contents)), contents)
    if o.invert:
        emit = np.setdiff1d(np.arange(1, count_lines(contents) + 1,
                                      dtype=np.int64), emit)
    if o.count_only:
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
            _records_for(name, data, res)),
        # a pruned member emits no bytes and no lines: exact for printed
        # lines and counts, not for -v, which keeps every read
        index_prune=not _invert)
    return records


# the app options configure() takes itself (and the ones it refuses);
# every other option is an engine keyword, shared by a fused group
_APP_OPTION_KEYS = frozenset((
    "pattern", "patterns", "ignore_case", "invert", "word_regexp",
    "line_regexp", "count_only", "presence_only", "max_errors", "index_dir",
    *_UNPORTED, *_CARD_OPTIONS,
))


def map_fused_fn(items, participants) -> list:
    """K participants' queries over one shared split: one union scan a
    packed window (ops/fuse.FusedScanner), then each participant's own
    -w/-x confirm, -v and record build over its exact result.
    ``participants`` are dicts with the participant's ``app_options`` and
    its names of the split's members (``filenames``, or ``filename`` for
    a split of one; two participants may name the same content by
    different paths).  Returns a record list a participant, each equal to
    its solo ``map_batch_fn`` over the same items.  Raises
    ops/fuse.FuseError where the union cannot host a query (the caller
    then runs each participant solo); any other error fails the map."""
    from distributed_grep_tpu_torch.ops import fuse as fuse_mod
    from distributed_grep_tpu_torch.runtime.fusion import query_spec

    items = list(items)
    specs, opt_sets = [], []
    for p in participants:
        o = dict(p.get("app_options") or {})
        spec = query_spec(o)
        if spec is None:
            raise fuse_mod.FuseError(
                f"participant {p.get('job_id')!r} query is not fusable")
        specs.append(spec)
        opt_sets.append(o)
    base = opt_sets[0]
    engine_kw = {k: v for k, v in base.items() if k not in _APP_OPTION_KEYS}
    if engine_kw.get("backend", "device") == "device":
        # the reference's default: every local card (apps/grep_tpu.py:300)
        engine_kw["devices"] = base.get("devices", "all")
    scanner = fuse_mod.FusedScanner(specs, **engine_kw)
    emit_opts, names_per = [], []
    for p, o in zip(participants, opt_sets):
        mode = ("line" if o.get("line_regexp")
                else "word" if o.get("word_regexp") else "search")
        confirm = build_confirm(pattern=o.get("pattern"),
                                patterns=o.get("patterns"),
                                ignore_case=bool(o.get("ignore_case")),
                                mode=mode)
        # the regex confirm (no literal fast path, which needs the
        # participant's own engine): the same lines
        emit_opts.append(_EmitOpts(confirm, None, mode, bool(o.get("invert")),
                                   bool(o.get("count_only"))))
        nm = list(p.get("filenames") or [])
        if not nm and p.get("filename"):
            nm = [p["filename"]]
        if len(nm) != len(items):
            raise fuse_mod.FuseError(
                f"participant {p.get('job_id')!r} has {len(nm)} member names "
                f"for a {len(items)}-item split")
        names_per.append(nm)
    outs: list[list] = [[] for _ in participants]

    def emit(i, _name, data, results, nl) -> None:
        for k, res in enumerate(results):
            outs[k].extend(_records_for(names_per[k][i], data, res,
                                        opts=emit_opts[k], nl=nl))

    scanner.scan_batch(items, progress=_progress_fn(), emit=emit)
    return outs


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
                n += _confirmed(_confirm, lines,
                                line_spans(lines, nl, len(buf)), buf).size

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
            lines = _confirmed(_confirm, lines,
                               line_spans(lines, nl, len(buf)), buf)
            if not lines.size:
                return
        batches.append(make_batch_from_lines(filename, lines, arr, nl,
                                             len(buf), lineno_base=lines_before))

    engine.scan_file(path, emit_chunk=emit_chunk, progress=progress)
    return batches


def reduce_fn(key: str, values: list[str]) -> str:
    return values[0]
