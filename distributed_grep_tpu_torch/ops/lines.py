"""Host-side line machinery: match offsets -> line numbers, plus exact
stitching of lines that span stripe/segment boundaries.

The device scan starts every stripe from the empty state.  That is exact
for every byte after the stripe's first newline; the stripe's head partial
line may miss a match that spans the boundary.  The fix is exact and local:
every line that contains a stripe or segment boundary is re-checked on the
host (ops/device_scan.py checks the bytes around each boundary).

numpy only: the reference's native newline index and line merge are not
part of this package.
"""

from __future__ import annotations

import numpy as np

NL = 0x0A


def line_of_offsets(offsets: np.ndarray, nl_index: np.ndarray) -> np.ndarray:
    """1-based line number containing each match end offset (i+1 convention):
    the match's last byte is at offset-1."""
    return np.searchsorted(nl_index, offsets - 1, side="right") + 1


def unique_match_lines(offsets: np.ndarray, nl_index: np.ndarray) -> np.ndarray:
    """Sorted unique 1-based line numbers of match end offsets."""
    if offsets.size == 0:
        return np.zeros(0, dtype=np.int64)
    return np.unique(line_of_offsets(offsets, nl_index)).astype(np.int64)


def line_spans(
    line_nos: np.ndarray, nl_index: np.ndarray, n_bytes: int
) -> tuple[np.ndarray, np.ndarray]:
    """``line_span`` vectorized: [starts, ends) of many 1-based lines."""
    ln = np.asarray(line_nos, dtype=np.int64)
    padded = np.concatenate(
        (np.asarray(nl_index, dtype=np.int64), np.array([n_bytes], np.int64))
    )
    starts = np.where(ln == 1, 0, padded[np.maximum(ln - 2, 0)] + 1)
    ends = padded[np.minimum(ln - 1, padded.size - 1)]
    return starts, ends


def newline_index(data: bytes) -> np.ndarray:
    """Byte offsets of every '\\n', as int64."""
    return np.flatnonzero(np.frombuffer(data, dtype=np.uint8) == NL).astype(
        np.int64
    )
