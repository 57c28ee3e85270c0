"""CUDA grep application: the counterpart of the reference's apps/grep_tpu.

Same Map/Reduce contract and the same output records: key
``"<filename> (line number #N)"``, value the line's bytes decoded
utf-8/replace; Reduce is the identity (keys are unique per (file, line)).
Map scans the whole split with GrepEngine (the CUDA Shift-And kernel for
literals and byte-class sequences, the FDR filter and pairset kernels for
literal sets -- ``patterns`` -- and for regexes that denote one, the
Glushkov NFA kernel for other regexes, the Wu-Manber kernel for
``max_errors=k`` approximate matching) and slices only the matched lines
out of the buffer.

Options outside this package's slices (-v/-w/-x, counts, the device mesh,
the shard index) raise NotImplementedError naming the ROADMAP.md item that
will port them; the port drives one card, so ``devices`` raises too.  A
falsy value of such an option (``index_dir=None``) is accepted and
dropped.
"""

from __future__ import annotations

import threading

from distributed_grep_tpu_torch.apps.base import KeyValue
from distributed_grep_tpu_torch.ops.engine import GrepEngine
from distributed_grep_tpu_torch.ops.lines import line_spans, newline_index

# keys are unique per (file, line) and Reduce is values[0]: the runtime
# sorts each reduce partition in (file, line) order
reduce_is_identity = True

_engine: GrepEngine | None = None
_configured_with: tuple | None = None
_lock = threading.Lock()

# The worker installs a progress callback per task (thread-local: worker
# threads share this module); the engine calls it once per segment.
_progress = threading.local()

_UNPORTED = {
    "invert": "item 7 (the grep app's remaining options)",
    "word_regexp": "item 7 (the grep app's remaining options)",
    "line_regexp": "item 7 (the grep app's remaining options)",
    "count_only": "item 7 (the grep app's remaining options)",
    "presence_only": "item 7 (the grep app's remaining options)",
    "devices": "item 9 (multi-GPU)",
    "mesh_shape": "item 9 (multi-GPU)",
    "mesh_axes": "item 9 (multi-GPU)",
    "pattern_axis": "item 9 (multi-GPU)",
    "index_dir": "item 8 (the service runtime)",
}


def set_progress(fn) -> bool:
    """Worker hook: install (fn) or clear (None) this task's progress
    callback -- fn() stamps liveness."""
    _progress.fn = fn
    return True


def configure(
    pattern: str | bytes = "",
    ignore_case: bool = False,
    device: str = "cuda",
    patterns: list[str | bytes] | None = None,
    **options: object,
) -> None:
    """Compile the pattern, or the literal set ``patterns`` when given
    (members str, decoded utf-8/surrogateescape, or bytes; ``pattern`` is
    then ignored), for ``device`` (default "cuda"; raises when CUDA is
    absent unless "cpu" is asked for).  ``max_errors=k`` (1..3) matches
    the single pattern within k edit errors.  Engine knobs (target_lanes,
    segment_bytes, min_chunk) pass through ``options``."""
    global _engine, _configured_with
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
    key = (pattern, tuple(patterns or ()), bool(ignore_case), str(device),
           tuple(sorted(engine_opts.items())))
    with _lock:
        if key == _configured_with:
            return
        _engine = GrepEngine(pattern, patterns=patterns,
                             ignore_case=ignore_case, device=device,
                             **engine_opts)  # type: ignore[arg-type]
        _configured_with = key


def map_fn(filename: str, contents: bytes) -> list[KeyValue]:
    if _engine is None:
        raise RuntimeError("grep_cuda used before configure() -- no pattern set")
    result = _engine.scan(contents, progress=getattr(_progress, "fn", None))
    lines = result.matched_lines
    if not lines.size:
        return []
    nl = result.nl_index if result.nl_index is not None else newline_index(
        contents)
    starts, ends = line_spans(lines, nl, len(contents))
    head = f"{filename} (line number #"
    return [
        KeyValue(f"{head}{n})", contents[s:e].decode("utf-8", "replace"))
        for n, s, e in zip(lines.tolist(), starts.tolist(), ends.tolist())
    ]


def reduce_fn(key: str, values: list[str]) -> str:
    return values[0]
