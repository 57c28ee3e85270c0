"""Host-side line machinery: match offsets -> line numbers, plus exact
stitching of lines that span stripe/segment boundaries.

The device scan starts every stripe from the empty state at a line start.
That is exact for every byte after the stripe's first newline; the
stripe's head partial line may miss a match that spans the boundary and,
for a '^' pattern, may show a false match (the stripe start is taken for a
line start).  The fix is exact and local: every line that contains a
stripe or segment boundary is re-checked on the host.  The literal path
checks only the bytes around each boundary and adds what it finds
(ops/device_scan.py); the regex path replaces the device verdict of every
such line with the host verdict (``boundary_lines`` + ``stitch_lines``).

``newline_index`` and ``unique_match_lines`` run in the host library
(utils/native.py: an AVX2 newline scan, a linear merge of the sorted
offsets against the newline index); ``newline_index_numpy`` and
``unique_match_lines_numpy`` are their plain versions.
"""

from __future__ import annotations

import numpy as np

from distributed_grep_tpu_torch.utils import native

NL = 0x0A


def line_of_offsets(offsets: np.ndarray, nl_index: np.ndarray) -> np.ndarray:
    """1-based line number containing each match end offset (i+1 convention):
    the match's last byte is at offset-1."""
    return np.searchsorted(nl_index, offsets - 1, side="right") + 1


def unique_match_lines(offsets: np.ndarray, nl_index: np.ndarray) -> np.ndarray:
    """Sorted unique 1-based line numbers of match end offsets (sorted
    first if they are not ascending)."""
    offsets = np.asarray(offsets, dtype=np.int64)
    if offsets.size == 0:
        return np.zeros(0, dtype=np.int64)
    if offsets.size > 1 and bool(np.any(offsets[1:] < offsets[:-1])):
        offsets = np.sort(offsets)
    return native.unique_lines(nl_index, offsets)


def unique_match_lines_numpy(offsets: np.ndarray,
                             nl_index: np.ndarray) -> np.ndarray:
    """``unique_match_lines``'s plain version."""
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


def boundary_lines(
    boundaries: np.ndarray, nl_index: np.ndarray, n_bytes: int
) -> np.ndarray:
    """Sorted unique 1-based numbers of the lines containing any of the
    byte positions ``boundaries`` (positions outside (0, n_bytes) are
    ignored)."""
    p = np.asarray(boundaries, dtype=np.int64)
    p = p[(p > 0) & (p < n_bytes)]
    return np.unique(np.searchsorted(nl_index, p, side="right") + 1)


def stitch_lines(
    device_lines: np.ndarray, suspects: np.ndarray, verdicts: np.ndarray
) -> np.ndarray:
    """Replace the device verdict with the host verdict on every suspect
    line: drop the suspects from ``device_lines``, add back those whose
    host verdict is True.  Sorted unique line numbers."""
    kept = np.setdiff1d(device_lines, suspects)
    return np.union1d(kept, np.asarray(suspects)[np.asarray(verdicts, bool)])


def newline_index(data: bytes) -> np.ndarray:
    """Byte offsets of every '\\n', as int64."""
    return native.newline_index(data)


def newline_index_numpy(data: bytes) -> np.ndarray:
    """``newline_index``'s plain version."""
    return np.flatnonzero(np.frombuffer(data, dtype=np.uint8) == NL).astype(
        np.int64
    )


def empty_line_numbers(data: bytes,
                       nl_index: np.ndarray | None = None) -> np.ndarray:
    """Sorted 1-based numbers of the zero-length lines of ``data``: a line
    is empty iff its '\\n' sits at the line's start, offset 0 for line 1
    or right after the previous '\\n'.  The bytes after the last '\\n'
    are a line only when there are some (``count_lines``), so they are
    never reported.  ``nl_index`` is ``newline_index(data)`` when the
    caller has it."""
    nl = newline_index(data) if nl_index is None else nl_index
    if nl.size == 0:
        return np.zeros(0, dtype=np.int64)
    out = (np.flatnonzero(np.diff(nl) == 1) + 2).astype(np.int64)
    if nl[0] == 0:
        out = np.concatenate([np.ones(1, np.int64), out])
    return out


def count_lines(data: bytes) -> int:
    """Line count with grep -n semantics: a trailing '\\n' closes the last
    line rather than opening an empty one; empty input has zero lines."""
    if not data:
        return 0
    return data.count(b"\n") + (0 if data.endswith(b"\n") else 1)
