"""Durable task-commit journal — coordinator checkpoint/resume (the
reference's runtime/journal.py).

This journal makes the rename-commit philosophy durable: every task completion is
appended as one JSON line, fsync'd, and a restarted coordinator replays it
to skip finished work.  Entries carry ``has_record`` when the completion was
committed via a per-task commit record (runtime/store.py) — replay then
re-resolves the record as the unit of truth instead of trusting the journal
line alone (scheduler._replay).

A coordinator crash mid-append can tear the tail line.  Replay reports the
torn tail (warning + byte offset) and excludes it; reopening for append
truncates the file back to the last complete line first, so the next append
starts clean instead of gluing onto half a record.
"""

from __future__ import annotations

import json
import logging
import os
from pathlib import Path

log = logging.getLogger("distributed_grep_tpu_torch.journal")


def _scan_valid_prefix(path: Path) -> tuple[list[dict], int, int | None]:
    """(entries, valid_byte_length, torn_offset_or_None) of a journal file.

    A line counts only if it is newline-terminated AND parses as JSON — a
    torn tail that coincidentally parses (e.g. ``{"task_id": 12}`` torn to
    ``{"task_id": 1}``) must not be trusted, and record() always terminates
    lines, so an unterminated tail is torn by definition.  The first bad
    line is the torn point; everything after it is excluded."""
    entries: list[dict] = []
    valid = 0
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    n = len(data)
    while pos < n:
        nl = data.find(b"\n", pos)
        if nl < 0:
            return entries, valid, pos  # unterminated tail: torn
        line = data[pos:nl].strip()
        if line:
            try:
                entries.append(json.loads(line))
            except (json.JSONDecodeError, UnicodeDecodeError):
                return entries, valid, pos  # torn/corrupt line
        pos = nl + 1
        valid = pos
    return entries, valid, None


class TaskJournal:
    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._truncate_torn_tail()
        self._f = open(self.path, "a", encoding="utf-8")

    def _truncate_torn_tail(self) -> None:
        """Drop a torn tail line before appending — without this, the next
        record() would glue onto the half-written line and corrupt BOTH."""
        if not self.path.exists():
            return
        size = self.path.stat().st_size
        _, valid, torn_at = _scan_valid_prefix(self.path)
        if torn_at is None:
            return
        log.warning(
            "journal %s has a torn tail at byte %d (%d bytes dropped); "
            "truncating so the next append starts on a clean line",
            self.path, torn_at, size - valid,
        )
        with open(self.path, "rb+") as f:
            f.truncate(valid)
            f.flush()
            os.fsync(f.fileno())

    def record(self, entry: dict) -> None:
        self._f.write(json.dumps(entry, sort_keys=True) + "\n")
        self._f.flush()
        os.fsync(self._f.fileno())

    def map_completed(self, task_id: int, file: str, produced_parts: list[int],
                      has_record: bool = False,
                      files: list[str] | None = None) -> None:
        entry = {"kind": "map_done", "task_id": task_id, "file": file,
                 "parts": produced_parts}
        if has_record:
            entry["has_record"] = True
        if files:
            # batched multi-file split: replay must match the member list,
            # not just the display label (scheduler._replay)
            entry["files"] = list(files)
        self.record(entry)

    def reduce_completed(self, task_id: int, has_record: bool = False) -> None:
        entry = {"kind": "reduce_done", "task_id": task_id}
        if has_record:
            entry["has_record"] = True
        self.record(entry)

    def close(self) -> None:
        self._f.close()

    @staticmethod
    def replay(path: str | Path) -> list[dict]:
        p = Path(path)
        if not p.exists():
            return []
        entries, _valid, torn_at = _scan_valid_prefix(p)
        if torn_at is not None:
            # torn tail write from a crash: report it (with the offset a
            # operator needs to inspect the file) and exclude it — the
            # uncommitted task simply re-runs.
            log.warning(
                "journal %s: torn tail at byte %d ignored during replay "
                "(%d complete entries)", p, torn_at, len(entries),
            )
        return entries
