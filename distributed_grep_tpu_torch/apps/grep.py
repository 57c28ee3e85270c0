"""grep -w / -x: the boundary-wrapped confirm regex.

The card scans the plain pattern; its matched lines are a superset of the
word (-w) or whole-line (-x) matches, and the host confirms each candidate
line against the pattern wrapped here.  The counterpart of ``wrap_mode``
and ``build_confirm`` of the reference's ``apps/grep.py`` (the host grep
application itself is ROADMAP item 13).
"""

from __future__ import annotations

import re

from distributed_grep_tpu_torch.models.dfa import expand_posix_classes

# GNU grep's word constituents in the C locale
_W = rb"[0-9A-Za-z_]"


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
