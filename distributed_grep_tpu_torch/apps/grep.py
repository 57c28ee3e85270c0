"""The host grep application (the reference's apps/grep.py), and the
-w / -x confirm the CUDA app shares with it.

Map splits the input on newlines and emits, for each selected line, the
record ``"<filename> (line number #N)"`` -> the line (1-based, as grep -n;
a final newline opens no empty line), as one columnar ``LineBatch`` a
split; Reduce is the identity on the first value.  ``configure`` takes a
regex (``pattern``, run with Python ``re`` over each line, POSIX classes
expanded) or a literal set (``patterns``: Aho-Corasick banks,
models/aho.py, scanned by the host DFA scanner over the whole split),
and ``ignore_case``, ``invert`` (grep -v), ``word_regexp`` /
``line_regexp`` (grep -w / -x), ``count_only`` (one record a file: key the
filename, value the selected line count) and ``presence_only`` (with
count_only, the scan may stop at the first selected line).

The -w / -x confirm: the card scans the plain pattern; its matched lines
are a superset of the word (-w) or whole-line (-x) matches, and the host
confirms each candidate line against the pattern wrapped here.  One
case-sensitive literal takes ``literal_mode_lines`` instead: one scan of
the library for the literal's occurrences and two byte masks.
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


# Reduce is values[0] and keys are unique per (file, line): the runtime
# collates each partition in (file, line) order (runtime/columnar.py).
reduce_is_identity = True

# Job-configured state (configure()); the loader gives every job its own
# module instance.
_pattern: re.Pattern[bytes] | None = re.compile(b"")
_ac_tables: list | None = None  # Aho-Corasick banks of a literal set
_ac_confirm: re.Pattern[bytes] | None = None  # -w/-x confirm of a set
_invert = False
_line_mode = "search"  # "search" | "word" (-w) | "line" (-x)
_count_only = False
_presence = False
_configured_with: tuple | None = None


def configure(pattern: str | bytes = b"", ignore_case: bool = False,
              patterns: list[str | bytes] | None = None,
              invert: bool = False, word_regexp: bool = False,
              line_regexp: bool = False, count_only: bool = False,
              presence_only: bool = False, **_: object) -> None:
    """Set the job's query (the module docstring's options; the CUDA
    app's other options are accepted and ignored)."""
    global _pattern, _ac_tables, _ac_confirm, _invert, _line_mode, \
        _count_only, _presence, _configured_with
    if isinstance(pattern, str):
        pattern = pattern.encode("utf-8", "surrogateescape")
    _invert = bool(invert)
    _count_only = bool(count_only)
    _presence = bool(presence_only)
    _line_mode = "line" if line_regexp else ("word" if word_regexp
                                             else "search")
    key = (pattern, ignore_case, tuple(patterns) if patterns else None,
           _invert, _line_mode)
    if key == _configured_with:
        return  # configure runs at every assignment: no recompile
    if patterns:
        from distributed_grep_tpu_torch.models.aho import (
            compile_aho_corasick_banks,
        )

        members = [p.encode("utf-8", "surrogateescape") if isinstance(p, str)
                   else bytes(p) for p in patterns]
        _ac_tables = compile_aho_corasick_banks(members,
                                                ignore_case=ignore_case)
        _pattern = None
        _ac_confirm = build_confirm(patterns=members, ignore_case=ignore_case,
                                    mode=_line_mode)
    else:
        _ac_tables = None
        _ac_confirm = None
        _pattern = re.compile(
            wrap_mode(expand_posix_classes(pattern), _line_mode),
            re.IGNORECASE if ignore_case else 0)
    _configured_with = key


def map_fn(filename: str, contents: bytes) -> list:
    from distributed_grep_tpu_torch.apps.base import KeyValue
    from distributed_grep_tpu_torch.runtime.columnar import LineBatch

    matched = _ac_matched_lines(contents) if _ac_tables is not None else None
    lines = contents.split(b"\n")
    if lines and lines[-1] == b"":
        lines.pop()  # a final newline opens no line (grep -n)
    sel_nos: list[int] = []
    sel_lines: list[bytes] = []
    n_selected = 0
    for lineno, line in enumerate(lines, start=1):
        if matched is not None:
            hit = lineno in matched and (_ac_confirm is None
                                         or _ac_confirm.search(line))
        else:
            hit = _pattern.search(line)
        if bool(hit) != _invert:
            if _count_only:
                n_selected += 1
                if _presence:
                    break  # -q/-l: the first selected line settles it
                continue
            sel_nos.append(lineno)
            sel_lines.append(line)
    if _count_only:
        return [KeyValue(key=filename, value=str(n_selected))]
    if not sel_nos:
        return []
    lens = np.fromiter((len(x) for x in sel_lines), dtype=np.int64,
                       count=len(sel_lines))
    offsets = np.zeros(lens.size + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    return [LineBatch(filename=filename,
                      linenos=np.asarray(sel_nos, dtype=np.int64),
                      offsets=offsets, slab=b"".join(sel_lines))]


def _ac_matched_lines(contents: bytes) -> set[int]:
    """One host DFA pass a bank over the whole split; offsets -> lines."""
    from distributed_grep_tpu_torch.models.dfa import reference_scan
    from distributed_grep_tpu_torch.ops.lines import line_of_offsets

    offsets = np.unique(np.concatenate(
        [reference_scan(t, contents) for t in _ac_tables]))
    if offsets.size == 0:
        return set()
    return set(line_of_offsets(offsets.astype(np.int64),
                               newline_index(contents)).tolist())


def reduce_fn(key: str, values: list[str]) -> str:
    return values[0]
