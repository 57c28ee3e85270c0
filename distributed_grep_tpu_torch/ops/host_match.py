"""Host line oracle of the regex path: one exact verdict per line, for many
lines at once.

``dfa_lines_match(table, data, starts, ends)`` runs the pattern's DFA
(models/dfa.compile_dfa) over every line [starts[i], ends[i]) of ``data``
in the host library: the lines are gathered into one slab, each followed
by a '\\n' (``native.gather_ranges``), and the slab is walked once with
the ``accept`` plane and, for a '$' pattern, once with the ``accept_eol``
plane, kept where the next byte is a line's '\\n' (``native.dfa_scan_mt``,
the slab cut at newlines across threads).  Every state goes to the start
state on '\\n' (the newline reset of ``DfaTable``), so each line of the
slab is walked from the line start, as in place.  The accepting offsets
map back to their lines by a linear merge (``native.unique_lines``).  A
line matches iff it reaches an ``accept`` state at any byte, or an
``accept_eol`` state after its last byte (an empty line: the start state).

``dfa_lines_match_numpy`` is its plain version: all lines step one byte
at a time from the line-start state, as numpy gathers over the
``full_table()``.  The lines are sorted longest first, so the lines still
walking at step t are a prefix of the order and no mask is needed; when
few long lines remain, a plain Python loop per line finishes them (one
numpy step per byte would cost more than the loop).

``re_lines_match(rx, data, starts, ends)`` is the oracle of the patterns no
DFA expresses (word boundaries, repeats past the expansion cap): Python
``re`` per line.

``approx_windows_match(model, data, starts, ends)`` is the approx path's
stitch oracle: the Wu-Manber recurrence (models/approx.py) over many short
spans at once.  The reference re-checks every boundary line with a
Python-int loop (about 1 MB/s); at 65536 boundaries per 64 MB segment that
would cost tens of seconds per GiB, while the spans here are the stitch's
short windows, stepped together one numpy column at a time.
"""

from __future__ import annotations

import re

import numpy as np

from distributed_grep_tpu_torch.models.approx import NL, ApproxModel
from distributed_grep_tpu_torch.models.dfa import DfaTable
from distributed_grep_tpu_torch.utils import native

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
    ends = np.asarray(ends, dtype=np.int64)
    n = starts.size
    hit = np.zeros(n, dtype=bool)
    if n == 0:
        return hit
    lens = ends - starts
    src = np.frombuffer(data, dtype=np.uint8)
    nl_at = (data.find(b"\n") if isinstance(data, bytes)
             else int(np.argmax(src == NL)) if (src == NL).any() else -1)
    if nl_at < 0:  # no '\n' to gather after each line: add one
        src = np.concatenate((src, np.array([NL], dtype=np.uint8)))
        nl_at = src.size - 1
    # ranges: line 0, a '\n', line 1, a '\n', ...
    r_starts = np.empty(2 * n, dtype=np.int64)
    r_ends = np.empty(2 * n, dtype=np.int64)
    r_starts[0::2], r_ends[0::2] = starts, ends
    r_starts[1::2], r_ends[1::2] = nl_at, nl_at + 1
    total = int(lens.sum()) + n
    slab = native.gather_ranges(src, r_starts, r_ends, total)
    seps = np.cumsum(lens + 1) - 1  # each line's '\n' in the slab
    sl = np.frombuffer(slab, dtype=np.uint8)
    full = table.full_table()
    acc = native.dfa_scan_mt(slab, full, table.accept, table.start)
    acc = acc[sl[acc - 1] != NL]  # a state after a line's byte, not a '\n'
    if acc.size:
        hit[native.unique_lines(seps, acc) - 1] = True
    if table.accept_eol.any():
        eol = native.dfa_scan_mt(slab, full, table.accept_eol, table.start)
        eol = eol[eol < total]
        eol = eol[sl[eol] == NL]  # the state after a line's last byte
        if eol.size:
            hit[native.unique_lines(seps, eol) - 1] = True
        if table.accept_eol[table.start]:
            hit[lens == 0] = True
    return hit


def dfa_lines_match_numpy(
    table: DfaTable, data, starts: np.ndarray, ends: np.ndarray
) -> np.ndarray:
    """``dfa_lines_match``'s plain version: the batched numpy walk."""
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


# approx_windows_match serves the stitch's windows (at most 2 * (32 + 3 -
# 1) bytes each), not whole lines: one numpy step per column of the widest
# span would make a long line cost its length for every span.
APPROX_SPAN_CAP = 1024


def approx_windows_match(
    model: ApproxModel, data, starts: np.ndarray, ends: np.ndarray
) -> np.ndarray:
    """Verdicts (bool per span) of ``model``: True where [starts[i],
    ends[i]) of ``data`` contains a match with at most ``model.k`` edits.
    The spans are gathered into one (n, W) uint8 matrix padded with '\\n'
    (the rows reset there, so padding adds no match) and the k+1 rows of
    every span step over the W columns together as numpy uint32 vectors.
    Spans must hold no '\\n' and be at most APPROX_SPAN_CAP bytes."""
    starts = np.asarray(starts, dtype=np.int64)
    lens = np.asarray(ends, dtype=np.int64) - starts
    n = starts.size
    if n == 0:
        return np.zeros(0, dtype=bool)
    width = int(lens.max())
    if width > APPROX_SPAN_CAP:
        raise ValueError(f"approx span of {width} bytes is over the "
                         f"{APPROX_SPAN_CAP}-byte cap (windows, not lines)")
    arr = np.frombuffer(data, dtype=np.uint8)
    cols = np.arange(width, dtype=np.int64)
    inside = cols[None, :] < lens[:, None]
    text = np.full((n, width), NL, dtype=np.uint8)
    text[inside] = arr[(starts[:, None] + cols[None, :])[inside]]
    table = model.base.b_table.astype(np.uint32)
    k, mb = model.k, np.uint32(model.match_bit)
    seeds = [np.uint32(s) for s in model.seeds]
    rows = [np.full(n, s, dtype=np.uint32) for s in seeds]
    hit = np.zeros(n, dtype=bool)
    one = np.uint32(1)
    for c in range(width):
        byte = text[:, c]
        b = table[byte]
        nl = byte == NL
        new = [((rows[0] << one) | one) & b]
        for j in range(1, k + 1):
            new.append((((rows[j] << one) | one) & b) | rows[j - 1]
                       | (rows[j - 1] << one) | (new[j - 1] << one)
                       | seeds[j])
        rows = [np.where(nl, seeds[j], new[j]) for j in range(k + 1)]
        hit |= (rows[k] & mb) != 0
    return hit


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
