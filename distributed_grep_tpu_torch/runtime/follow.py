"""Standing queries over growing files: the cursors and suffix scans of
``grep --follow`` (the reference's runtime/follow.py:93-398).

``FollowScanner`` keeps a cursor a file: the byte offset of its first
incomplete line (always a line start) and that line's number.  Each
``poll_once`` scans only what was appended since, through
``GrepEngine.scan_file_suffix``: the complete lines; a partial tail line
is carried (not consumed) and read again, grown, at the next poll, so the
selected lines equal a one-shot scan of the final file.  The scan is exact
at every append edge for the reason cross-file batching is: the buffer
starts at a line start and ends at a line end, and every scanner resets
at '\\n'.  A file that shrinks below its cursor or gets a new inode
(truncated, or replaced by a rename) gives a ``reset`` record and is
scanned again from offset 0.

Records are dicts: ``{"file", "line", "text"}`` a selected line (text
decoded utf-8/surrogateescape), ``{"file", "count"}`` a count delta
(``count_only``: no line is materialized), ``{"file", "match": True}``
once (``presence_only``: the file is then not scanned again) and
``{"file", "reset": True}``.

The service's halves of the reference module -- ``FollowLog``,
``StreamRing``, ``FollowRunner`` and the fused groups -- are the standing
queries of the service daemon (runtime/service.py), its slice 3b
(ROADMAP.md queue B, item 5b), and are not here.
"""

from __future__ import annotations

import logging
import os
import threading
from dataclasses import dataclass

import numpy as np

from distributed_grep_tpu_torch.ops import lines as lines_mod

log = logging.getLogger("distributed_grep_tpu_torch.follow")

DEFAULT_FOLLOW_POLL_S = 0.5

# One poll scans at most this much of a file's suffix: catching up with a
# large existing file goes in steps of this size.
MAX_WAKE_BYTES = 64 << 20


def env_follow_poll_s(default: float = DEFAULT_FOLLOW_POLL_S) -> float:
    """DGREP_FOLLOW_POLL_S, the poll cadence in seconds (malformed or
    <= 0 keeps ``default``)."""
    raw = os.environ.get("DGREP_FOLLOW_POLL_S")
    if not raw:
        return default
    try:
        v = float(raw)
    except ValueError:
        return default
    return v if v > 0 else default


# Process-wide counters: polls that found news, and suffix bytes scanned.
_stats_lock = threading.Lock()
_stats = {"follow_wakes": 0, "suffix_bytes_scanned": 0}


def _count(name: str, n: int = 1) -> None:
    with _stats_lock:
        _stats[name] += n


def follow_counters() -> dict:
    """The follow counters, or {} while they are all 0."""
    with _stats_lock:
        if not any(_stats.values()):
            return {}
        return dict(_stats)


def follow_counters_clear() -> None:
    with _stats_lock:
        for k in _stats:
            _stats[k] = 0


@dataclass
class FileCursor:
    """One file's position: ``offset`` of its first incomplete line (a
    line start), ``line`` that line's 1-based number, ``ino`` the inode
    it was read under, ``emitted`` the lines selected so far and ``done``
    once presence is settled.  ``seen`` is the size at the last poll that
    consumed nothing, so an unterminated tail is not read again until the
    file grows."""

    path: str
    offset: int = 0
    line: int = 1
    ino: int = -1
    emitted: int = 0
    done: bool = False
    seen: int = -1

    def state(self) -> dict:
        return {"offset": self.offset, "line": self.line, "ino": self.ino,
                "emitted": self.emitted, "done": self.done}

    def restore(self, st: dict) -> None:
        self.offset = int(st.get("offset", 0))
        self.line = int(st.get("line", 1))
        self.ino = int(st.get("ino", -1))
        self.emitted = int(st.get("emitted", 0))
        self.done = bool(st.get("done", False))


class FollowScanner:
    """The cursors and suffix scans of one standing query over ``files``
    with ``engine``.  ``invert`` selects the complement of each suffix's
    lines, ``count_only`` gives count deltas, ``presence_only`` one match
    record a file."""

    def __init__(self, engine, files, *, invert: bool = False,
                 count_only: bool = False, presence_only: bool = False):
        self.engine = engine
        self.invert = bool(invert)
        self.count_only = bool(count_only)
        self.presence_only = bool(presence_only)
        self.cursors: dict[str, FileCursor] = {
            str(f): FileCursor(path=str(f)) for f in files}

    def any_selected(self) -> bool:
        return any(c.emitted for c in self.cursors.values())

    def poll_once(self, final: bool = False
                  ) -> list[tuple[str, list[dict], dict]]:
        """One poll of every file: ``[(path, records, cursor state)]`` for
        the files with news.  ``final`` scans an unterminated tail line too
        (the last poll, so the output equals a one-shot scan).  A file
        that fails to read keeps its cursor and is tried again next
        poll; the other files' news stands."""
        groups = []
        scanned = 0
        for cur in self.cursors.values():
            snap = cur.state()
            try:
                got = self._poll_file(cur, final)
            except OSError:
                cur.restore(snap)
                log.exception("follow poll failed for %s", cur.path)
                continue
            if got is None:
                continue
            recs, n_bytes = got
            scanned += n_bytes
            if recs or n_bytes:
                groups.append((cur.path, recs, cur.state()))
        if groups:
            _count("follow_wakes")
        if scanned:
            _count("suffix_bytes_scanned", scanned)
        return groups

    def _poll_file(self, cur: FileCursor, final: bool):
        """(records, suffix bytes) of one file, or None when nothing
        changed."""
        try:
            st = os.stat(cur.path)
        except OSError:
            return None  # not there yet, or gone: the cursor waits
        records: list[dict] = []
        if st.st_size < cur.offset or (cur.ino >= 0 and st.st_ino != cur.ino):
            records.append({"file": cur.path, "reset": True})
            cur.offset, cur.line, cur.emitted = 0, 1, 0
            cur.done, cur.seen = False, -1
        cur.ino = int(st.st_ino)
        idle = (records, 0) if records else None
        if st.st_size <= cur.offset or (self.presence_only and cur.done):
            return idle
        if not final and st.st_size == cur.seen:
            return idle  # the same unterminated tail as last time
        res, consumed, data = self.engine.scan_file_suffix(
            cur.path, cur.offset, final=final, max_bytes=MAX_WAKE_BYTES)
        if consumed == 0:
            cur.seen = int(st.st_size)
            return idle
        records.extend(self._emit(cur, res, data))
        cur.offset += consumed
        return records, consumed

    def _emit(self, cur: FileCursor, res, data: bytes) -> list[dict]:
        """The records of one scanned suffix; advances ``cur.line`` and
        ``cur.emitted`` (suffix line k is file line cur.line + k - 1)."""
        nl = lines_mod.newline_index(data)
        n_lines = nl.size + (0 if data.endswith(b"\n") else 1)
        matched = res.matched_lines
        if self.invert:
            matched = np.setdiff1d(np.arange(1, n_lines + 1, dtype=np.int64),
                                   matched)
        selected = int(matched.size)
        records: list[dict] = []
        if self.presence_only:
            if selected:
                records.append({"file": cur.path, "match": True})
                cur.done = True
        elif self.count_only:
            if selected:
                records.append({"file": cur.path, "count": selected})
        else:
            starts, ends = lines_mod.line_spans(matched, nl, len(data))
            for ln, s, e in zip(matched.tolist(), starts.tolist(),
                                ends.tolist()):
                records.append({
                    "file": cur.path, "line": cur.line + ln - 1,
                    "text": data[s:e].decode("utf-8", "surrogateescape")})
        cur.emitted += selected
        cur.line += n_lines
        return records
