"""grep -w / -x: the boundary-wrapped confirm regex, and its literal form.

The card scans the plain pattern; its matched lines are a superset of the
word (-w) or whole-line (-x) matches, and the host confirms each candidate
line against the pattern wrapped here.  One case-sensitive literal takes
``literal_mode_lines`` instead: one scan of the library for the literal's
occurrences and two byte masks.  The counterpart of ``wrap_mode``,
``build_confirm`` and ``literal_mode_lines`` of the reference's
``apps/grep.py`` (the host grep application itself is ROADMAP item 13).
"""

from __future__ import annotations

import re

import numpy as np

from distributed_grep_tpu_torch.models.dfa import expand_posix_classes
from distributed_grep_tpu_torch.ops.lines import newline_index, unique_match_lines
from distributed_grep_tpu_torch.utils import native

# GNU grep's word constituents in the C locale
_W = rb"[0-9A-Za-z_]"
_WORD_BYTES = np.zeros(256, dtype=bool)
for _lo, _hi in ((48, 57), (65, 90), (97, 122), (95, 95)):
    _WORD_BYTES[_lo : _hi + 1] = True


def wrap_mode(pattern: bytes, mode: str) -> bytes:
    """``pattern`` wrapped for grep -w ("word") or -x ("line") semantics;
    non-capturing, so its group numbers are unchanged."""
    if mode == "word":
        return rb"(?<!" + _W + rb")(?:" + pattern + rb")(?!" + _W + rb")"
    if mode == "line":
        return rb"\A(?:" + pattern + rb")\Z"
    return pattern


def build_confirm(pattern: str | bytes | None = None,
                  patterns: list | None = None, ignore_case: bool = False,
                  mode: str = "search") -> re.Pattern[bytes] | None:
    """The per-line confirm regex of -w/-x: a literal set escaped and
    alternated, a single pattern wrapped as it is (POSIX classes expanded
    first: re has none); None for mode "search", which needs no confirm."""
    if mode == "search":
        return None
    if patterns is not None:
        members = [p.encode("utf-8", "surrogateescape") if isinstance(p, str)
                   else bytes(p) for p in patterns]
        base = b"(?:" + b"|".join(re.escape(p) for p in members) + b")"
    else:
        base = expand_posix_classes(
            pattern.encode("utf-8", "surrogateescape")
            if isinstance(pattern, str) else bytes(pattern))
    return re.compile(wrap_mode(base, mode), re.IGNORECASE if ignore_case else 0)


def literal_mode_lines(contents: bytes, lit: bytes, mode: str,
                       nl: np.ndarray | None = None) -> np.ndarray:
    """Sorted 1-based numbers of the lines ``grep -w`` ("word") or ``-x``
    ("line") selects for the literal ``lit``: the same lines as
    ``wrap_mode``'s regex.  -w keeps an occurrence whose bytes before and
    after are not word constituents (a line or buffer edge counts as
    none); -x one that spans its line from start to end.  ``nl`` is the
    newline index of ``contents`` when the caller has it."""
    ends = native.literal_scan(contents, lit)
    if not ends.size:
        return ends
    n = len(contents)
    arr = np.frombuffer(contents, dtype=np.uint8)
    starts = ends - len(lit)
    prev = np.where(starts > 0, arr[np.maximum(starts - 1, 0)], 0x0A)
    nxt = np.where(ends < n, arr[np.minimum(ends, n - 1)], 0x0A)
    if mode == "word":
        ok = ~_WORD_BYTES[prev] & ~_WORD_BYTES[nxt]
    else:
        ok = (prev == 0x0A) & (nxt == 0x0A)
    ends = ends[ok]
    if not ends.size:
        return ends
    return unique_match_lines(ends, newline_index(contents) if nl is None
                              else nl)
