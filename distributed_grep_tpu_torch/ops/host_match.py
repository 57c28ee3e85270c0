"""Host line oracle of the regex path: one exact verdict per line, for many
lines at once.

``dfa_lines_match(table, data, starts, ends)`` walks the pattern's DFA
(models/dfa.compile_dfa) over every line [starts[i], ends[i]) of ``data``
together: all lines step one byte at a time from the line-start state, as
numpy gathers over the ``full_table()``.  A line matches iff it reaches an
``accept`` state at any byte, or an ``accept_eol`` state after its last
byte (the '$' plane).  The lines are sorted longest first, so the lines
still walking at step t are a prefix of the order and no mask is needed;
when few long lines remain, a plain Python loop per line finishes them
(one numpy step per byte would cost more than the loop).

``re_lines_match(rx, data, starts, ends)`` is the oracle of the patterns no
DFA expresses (word boundaries, repeats past the expansion cap): Python
``re`` per line.

The reference's oracle is a native C DFA scanner (its ``utils/native``);
this package keeps numpy only.  A per-line Python DFA walk would take
seconds per 64 MB segment on the ~65536 boundary lines the stitch checks
(ops/device_scan.py); the batched walk takes one numpy step per byte of
the longest line.
"""

from __future__ import annotations

import re

import numpy as np

from distributed_grep_tpu_torch.models.dfa import DfaTable

# Below this many lines still walking, the remaining bytes go through the
# per-line Python loop instead of numpy steps.
LOOP_LINES = 16


def _rows(table: DfaTable) -> list[list[int]]:
    """The full table as nested lists, for the per-line loop (cached)."""
    rows = getattr(table, "_rows_cache", None)
    if rows is None:
        rows = table.full_table().tolist()
        object.__setattr__(table, "_rows_cache", rows)
    return rows


def _walk_one(table: DfaTable, line: bytes, state: int) -> tuple[bool, int]:
    """Walk ``line`` from ``state``; (accepted at some byte, end state)."""
    rows, accept = _rows(table), table.accept
    for b in line:
        state = rows[state][b]
        if accept[state]:
            return True, state
    return False, state


def dfa_lines_match(
    table: DfaTable, data, starts: np.ndarray, ends: np.ndarray
) -> np.ndarray:
    """Exact verdicts (bool per line) of ``table`` on the lines [starts[i],
    ends[i]) of ``data``; a line holds no '\\n'."""
    starts = np.asarray(starts, dtype=np.int64)
    lens = np.asarray(ends, dtype=np.int64) - starts
    n = starts.size
    out = np.zeros(n, dtype=bool)
    if n == 0:
        return out
    arr = np.frombuffer(data, dtype=np.uint8)
    flat = table.full_table().astype(np.int64).reshape(-1)
    accept, accept_eol = table.accept, table.accept_eol
    order = np.argsort(-lens, kind="stable")
    lens_o = lens[order]
    pos = starts[order].copy()
    state = np.full(n, table.start, dtype=np.int64)
    hit = np.zeros(n, dtype=bool)
    lens_l = lens_o.tolist()
    t, k = 0, n  # k = lines longer than t (lens_o is descending)
    while k and lens_l[k - 1] <= t:
        k -= 1
    while k > LOOP_LINES:
        st = flat[state[:k] * 256 + arr[pos[:k]]]
        state[:k] = st
        hit[:k] |= accept[st]
        pos[:k] += 1
        t += 1
        while k and lens_l[k - 1] <= t:
            k -= 1
    for i in range(k):  # the few longest lines: finish them one by one
        if hit[i]:
            continue
        line = arr[pos[i] : starts[order[i]] + lens_o[i]].tobytes()
        hit[i], state[i] = _walk_one(table, line, int(state[i]))
    # the '$' plane: a line's end state (the start state for an empty line)
    hit |= accept_eol[state]
    out[order] = hit
    return out


def re_lines_match(
    rx: re.Pattern, data, starts: np.ndarray, ends: np.ndarray
) -> np.ndarray:
    """Verdicts of the compiled bytes regex ``rx`` on each line, each line
    searched whole (so \\b, ^ and $ see its true edges)."""
    view = memoryview(data)
    return np.fromiter(
        (rx.search(view[s:e]) is not None
         for s, e in zip(np.asarray(starts).tolist(), np.asarray(ends).tolist())),
        dtype=bool, count=len(starts),
    )
