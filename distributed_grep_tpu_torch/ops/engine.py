"""GrepEngine: one compiled pattern, scanned over documents on a device.

The slice this package covers: a literal or byte-class sequence of at
most 32 symbols (optionally case-folded), compiled to a Shift-And model
and scanned by the CUDA kernel (ops/cuda_scan.py) through the segment
pipeline in ops/device_scan.py.  Patterns outside it raise
NotImplementedError naming the ROADMAP.md slice that will port them;
there is no host scanner to fall back to.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np
import torch

from distributed_grep_tpu_torch.models.dfa import (
    NL,
    RegexError,
    UnsupportedSyntax,
)
from distributed_grep_tpu_torch.models.shift_and import (
    MAX_SYMBOLS,
    ShiftAndModel,
    filtered_for_device,
    parse_pattern,
    try_compile_shift_and,
)
from distributed_grep_tpu_torch.utils.device import resolve_device

# Span path: above this many candidate lines per segment, the per-line host
# confirm would crawl -- one exact-mode kernel pass over the segment on the
# device resolves every line instead.
SPAN_CONFIRM_LINE_LIMIT = 4096

# Lanes per 64 MB segment on the card: 65536 stripes of 1024 bytes give
# 256 blocks of 256 threads, about two blocks per SM of an H100.
DEFAULT_TARGET_LANES = 65536
DEFAULT_SEGMENT_BYTES = 64 * 1024 * 1024

REGEX_SLICE = (
    "ROADMAP.md 'Slices still to port', item 1 (regex NFA kernel with its "
    "filter/rescue routes)"
)


@dataclass
class ScanResult:
    matched_lines: np.ndarray  # sorted 1-based line numbers (always exact)
    n_matches: int  # == matched_lines.size
    bytes_scanned: int
    nl_index: np.ndarray | None = None  # the document's '\n' offsets


def check_pattern(pattern: str, ignore_case: bool = False) -> ShiftAndModel:
    """The pattern's Shift-And model.  A malformed pattern raises
    RegexError; a valid one outside this package's slice raises
    NotImplementedError."""
    try:
        parse_pattern(pattern, ignore_case)
    except UnsupportedSyntax as e:
        raise NotImplementedError(
            f"pattern {pattern!r} ({e}) is outside the literal/byte-class "
            f"slice; it belongs to {REGEX_SLICE}"
        ) from e
    model = try_compile_shift_and(pattern, ignore_case=ignore_case)
    if model is None:
        raise NotImplementedError(
            f"pattern {pattern!r} is not a sequence of 1..{MAX_SYMBOLS} "
            f"single-byte symbols without '\\n' (repeats, alternation, "
            f"anchors, empty or longer patterns); it belongs to {REGEX_SLICE}"
        )
    return model


def lines_match(
    model: ShiftAndModel, data, starts: np.ndarray, ends: np.ndarray
) -> np.ndarray:
    """Host Shift-And over many lines at once: True where [starts[i],
    ends[i]) of ``data`` contains a match of ``model`` (which must be exact,
    i.e. no wildcard positions).  The lines are gathered into one buffer
    with a '\\n' after each; a match of m symbols starts at p iff bit j of
    B[buf[p + j]] is set for every j, and never crosses a '\\n' (no symbol
    class contains it), so it is one vectorized AND of m shifted table
    lookups."""
    n = len(starts)
    out = np.zeros(n, dtype=bool)
    if n == 0:
        return out
    starts = np.asarray(starts, dtype=np.int64)
    lens = np.asarray(ends, dtype=np.int64) - starts
    m = model.length
    total = int(lens.sum())
    if total < m:
        return out
    arr = np.frombuffer(data, dtype=np.uint8)
    csum = np.concatenate(([0], np.cumsum(lens)))
    owner = np.repeat(np.arange(n, dtype=np.int64), lens)
    k = np.arange(total, dtype=np.int64)
    buf = np.full(total + n, NL, dtype=np.uint8)
    buf[k + owner] = arr[k - csum[owner] + starts[owner]]
    b = model.b_table[buf]
    span = buf.size - m + 1
    acc = (b[:span] & np.uint32(1)) != 0
    for j in range(1, m):
        acc &= ((b[j : j + span] >> np.uint32(j)) & np.uint32(1)) != 0
    hits = np.flatnonzero(acc)
    if hits.size:
        line_start = csum[:-1] + np.arange(n, dtype=np.int64)
        out[np.searchsorted(line_start, hits, side="right") - 1] = True
    return out


class GrepEngine:
    """Scan documents for one compiled pattern on one device."""

    def __init__(
        self,
        pattern: str | bytes,
        *,
        ignore_case: bool = False,
        device: str | torch.device = "cuda",
        target_lanes: int = DEFAULT_TARGET_LANES,
        segment_bytes: int = DEFAULT_SEGMENT_BYTES,
        min_chunk: int = 256,
    ):
        self.device = resolve_device(device)
        if isinstance(pattern, bytes):
            pattern = pattern.decode("utf-8", "surrogateescape")
        if segment_bytes <= 0 or target_lanes < 32 or target_lanes % 32:
            raise ValueError(
                "segment_bytes must be positive and target_lanes a positive "
                "multiple of 32"
            )
        self.pattern = pattern
        self.ignore_case = ignore_case
        self.target_lanes = target_lanes
        self.segment_bytes = segment_bytes
        self.min_chunk = min_chunk
        self.shift_and = check_pattern(pattern, ignore_case)
        # Rare-class device filter: the kernel checks only the pattern's
        # rarest byte-classes; the span confirm restores exact lines, and
        # the scan drops the filter if a corpus defeats the byte prior.
        self._sa_filtered = filtered_for_device(self.shift_and)
        self._stats_local = threading.local()
        self._copy_stream = None
        self._copy_lock = threading.Lock()
        # numeric stats summed over every scan of this engine (all threads)
        self.totals: dict = {}

    @property
    def stats(self) -> dict:
        """Counters of the last scan run by the calling thread."""
        d = getattr(self._stats_local, "d", None)
        if d is None:
            d = {}
            self._stats_local.d = d
        return d

    @stats.setter
    def stats(self, value: dict) -> None:
        self._stats_local.d = value

    def layout_kwargs(self) -> dict:
        """choose_layout parameters: the kernel needs lanes % 32 == 0 and
        chunk % 32 == 0."""
        return dict(
            target_lanes=self.target_lanes, min_chunk=self.min_chunk,
            lane_multiple=32, chunk_multiple=32,
        )

    def copy_stream(self):
        """This engine's side stream for host-to-device copies."""
        with self._copy_lock:
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(device=self.device)
            return self._copy_stream

    def lines_match(self, data, starts, ends) -> np.ndarray:
        """Exact host verdicts for [starts, ends) line spans of ``data``."""
        return lines_match(self.shift_and, data, starts, ends)

    def scan(self, data: bytes, progress=None) -> ScanResult:
        """Scan one in-memory document.  ``progress`` (optional callable) is
        called once per segment so a failure detector sees liveness."""
        from distributed_grep_tpu_torch.ops.device_scan import scan_device

        if not data:
            self.stats = {"segments": 0}
            return ScanResult(np.zeros(0, dtype=np.int64), 0, 0)
        res = scan_device(self, data, progress=progress)
        with self._copy_lock:
            for k, v in self.stats.items():
                self.totals[k] = self.totals.get(k, 0) + v
        return res


__all__ = [
    "DEFAULT_SEGMENT_BYTES",
    "DEFAULT_TARGET_LANES",
    "GrepEngine",
    "RegexError",
    "SPAN_CONFIRM_LINE_LIMIT",
    "ScanResult",
    "check_pattern",
    "lines_match",
]
