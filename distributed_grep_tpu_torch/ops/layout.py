"""Stripe layout: document bytes -> (chunk, lanes) array for the scan.

The scan is lane-parallel: the document is cut into ``lanes`` contiguous
stripes, and each lane scans its stripe sequentially.  Because a pattern
can never consume '\\n', every lane can start from the empty state; the
only error is each stripe's first partial line, which the engine re-checks
on the host (ops/lines.py boundary lines).

Padding uses '\\n' bytes: the pattern can never consume '\\n', so padding
can't create matches inside real lines, and decoded offsets past the real
data's length are dropped.

Layout is column-major: array[c, l] = byte c of stripe l, so one scan step
reads one row, with neighbouring lanes on neighbouring addresses.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

NL = 0x0A


@dataclass(frozen=True)
class Layout:
    lanes: int
    chunk: int  # bytes per lane
    n_real: int  # real (unpadded) document length

    @property
    def padded(self) -> int:
        return self.lanes * self.chunk

    def stripe_starts(self) -> np.ndarray:
        """Absolute offsets where a lane's stripe begins (boundary fix-ups)."""
        return np.arange(1, self.lanes, dtype=np.int64) * self.chunk


def choose_layout(
    n_bytes: int,
    target_lanes: int = 1024,
    min_chunk: int = 256,
    lane_multiple: int = 8,
    chunk_multiple: int = 8,
) -> Layout:
    """Pick (lanes, chunk) for a document: enough lanes to fill the device,
    chunks long enough that the sequential scan amortizes its step cost.
    lane_multiple/chunk_multiple let kernels impose tile shapes (the CUDA
    kernel needs lanes % 32 == 0 and chunk % 32 == 0)."""
    if n_bytes <= 0:
        return Layout(lanes=lane_multiple, chunk=chunk_multiple, n_real=max(0, n_bytes))
    lanes = max(lane_multiple, target_lanes // lane_multiple * lane_multiple)
    while lanes > lane_multiple and (n_bytes + lanes - 1) // lanes < min_chunk:
        lanes = max(lane_multiple, lanes // 2 // lane_multiple * lane_multiple)
    chunk = (n_bytes + lanes - 1) // lanes
    chunk = (chunk + chunk_multiple - 1) // chunk_multiple * chunk_multiple
    return Layout(lanes=lanes, chunk=chunk, n_real=n_bytes)


def to_device_array(data: bytes, layout: Layout) -> np.ndarray:
    """Pad with '\\n' and reshape column-major: result[c, l] = data[l*chunk+c]."""
    return np.ascontiguousarray(padded_stripes(data, layout).T)


def padded_stripes(data: bytes, layout: Layout,
                   out: np.ndarray | None = None) -> np.ndarray:
    """The '\\n'-padded document as a (lanes, chunk) row-major view -- the
    transpose of the scan layout, before the column-major copy.  Written
    into ``out`` (``layout.padded`` contiguous uint8) when given."""
    buf = (np.empty(layout.padded, dtype=np.uint8) if out is None
           else out.reshape(-1))
    buf[: len(data)] = np.frombuffer(data, dtype=np.uint8)
    buf[len(data):] = NL
    return buf.reshape(layout.lanes, layout.chunk)
