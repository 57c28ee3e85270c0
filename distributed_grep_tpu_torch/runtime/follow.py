"""Standing queries over growing files (the reference's
runtime/follow.py): the cursors and suffix scans of ``grep --follow``, and
the service daemon's standing queries with their fused groups.

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

The daemon's half (runtime/service.py runs a job with ``follow`` set as a
standing query, no map or reduce task):

* ``FollowLog``, the durable wake log in the job's work dir (the task
  journal's mechanics: fsync a line, a torn tail truncated at reopen):
  one line a (wake, file) holding the advanced cursor and the records it
  emitted, so a restarted daemon resumes each standing query with no
  duplicate and no lost line; compacted at startup past 1 MiB;
* ``StreamRing``, the bounded subscriber buffer behind ``GET
  /jobs/<id>/stream``: publishing never blocks, the oldest records are
  shed past ``DGREP_STREAM_BUFFER`` bytes, and a reader that fell behind
  gets an explicit ``dropped`` count;
* ``FollowRunner``, one standing query: its engine (ops.engine.
  cached_engine, on the job's device: ``cuda`` unless the job asks for the
  CPU), its wake loop every ``DGREP_FOLLOW_POLL_S``, journal before
  publish;
* ``FollowGroupRegistry`` and ``FollowGroup``, the fused tier: standing
  queries with one ``runtime/fusion.follow_fusion_key`` (the same watched
  files, the same other options, a query a union hosts, one family) share
  one cursor a file and one wake loop: one suffix read and one union scan
  (``ops/fuse.FusedScanner.scan_suffix``) a grown file, each member's
  exact result journaled and published into its own log and ring.  A
  member that joins a live group catches up solo first.  ``DGREP_FOLLOW_FUSE=0``
  turns the tier off.

Errors (ROADMAP.md D9).  An ``OSError`` of a watched file (missing,
unreadable, replaced) is logged and the file tried again at the next
wake, as in the reference; so is a failed write of the wake log (the
cursors roll back).  ``FuseError`` and a truncation of a watched file
send a group's members to their solo runners, as in the reference.  Any
other error of a scan (a CUDA build or launch error, a result of the wrong
shape, any error of a solo or a union suffix scan, or of an engine build)
fails the job, through the runner's ``on_fail``, and closes its ring: in
a group it fails every member's job.  It is never logged and retried,
and never rescanned solo.  The reference logs and retries every error of
a wake and sends a fused group's failures to solo scans.

No scan-stack import at module level: the engines are built on the
runner's thread.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from distributed_grep_tpu_torch.ops import lines as lines_mod
from distributed_grep_tpu_torch.runtime.journal import TaskJournal
from distributed_grep_tpu_torch.utils import lockdep
from distributed_grep_tpu_torch.utils.logging import get_logger

log = get_logger("follow")

DEFAULT_FOLLOW_POLL_S = 0.5
DEFAULT_STREAM_BUFFER = 4 << 20

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


def env_stream_buffer(default: int = DEFAULT_STREAM_BUFFER) -> int:
    """DGREP_STREAM_BUFFER, a subscriber ring's byte cap (a slow reader
    loses the oldest records past it; malformed or < 1 keeps
    ``default``)."""
    raw = os.environ.get("DGREP_STREAM_BUFFER")
    if raw is None or raw == "":
        return default
    try:
        v = int(raw)
    except ValueError:
        return default
    return v if v > 0 else default


def env_follow_fuse(default: bool = True) -> bool:
    """DGREP_FOLLOW_FUSE, the fused follow tier's switch: on by default;
    "0", "false" or "no" builds no group registry (every standing query
    runs its own solo wake loop)."""
    raw = os.environ.get("DGREP_FOLLOW_FUSE")
    if raw is None or raw == "":
        return default
    return raw.strip().lower() not in ("0", "false", "no")


# Process-wide counters: polls that found news, suffix bytes scanned, and
# records the stream rings shed ({} while all 0; the daemon's /status and
# /metrics read them).
_stats_lock = lockdep.make_lock("follow-stats")
_stats = {"follow_wakes": 0, "suffix_bytes_scanned": 0,
          "stream_dropped_records": 0}


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


# The fused tier's counters, kept apart so DGREP_FOLLOW_FUSE=0 never
# touches them: standing queries adopted into groups, group wakes with
# news that served two members or more, and the suffix bytes the
# co-members did not read again ((K - 1) x the bytes a shared scan
# consumed).
_fused_stats_lock = lockdep.make_lock("follow-fused-stats")
_fused_stats = {"follow_fused_queries": 0, "follow_fused_wakes": 0,
                "follow_suffix_bytes_saved": 0}


def _count_fused(name: str, n: int = 1) -> None:
    with _fused_stats_lock:
        _fused_stats[name] += n


def follow_fused_counters() -> dict:
    """The fused tier's counters, or {} while they are all 0."""
    with _fused_stats_lock:
        if not any(_fused_stats.values()):
            return {}
        return dict(_fused_stats)


def follow_fused_counters_clear() -> None:
    with _fused_stats_lock:
        for k in _fused_stats:
            _fused_stats[k] = 0


def _watched_file_error(e: OSError, path: str) -> bool:
    """Whether an OSError is one of the watched file ``path`` (missing,
    unreadable, replaced), which the next wake tries again (D9), rather
    than an error of the scan's own files (a kernel build's), which
    fails the job."""
    return getattr(e, "filename", None) in (None, path)


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

    def restore(self, state: dict[str, dict]) -> None:
        """Cursors from a replayed wake log (FollowLog.replay)."""
        for path, st in state.items():
            cur = self.cursors.get(path)
            if cur is not None:
                cur.restore(st)

    def any_selected(self) -> bool:
        return any(c.emitted for c in self.cursors.values())

    def poll_once(self, final: bool = False,
                  limits: dict[str, int] | None = None
                  ) -> list[tuple[str, list[dict], dict]]:
        """One poll of every file: ``[(path, records, cursor state)]`` for
        the files with news.  ``final`` scans an unterminated tail line too
        (the last poll, so the output equals a one-shot scan).  A watched
        file that fails to read keeps its cursor and is tried again next
        poll; the other files' news stands; any other error raises.
        ``limits`` (a fused group's catch-up) polls only the listed paths,
        each read capped at its byte budget: the group's cursor is a line
        start, so the capped read lands on it exactly."""
        groups = []
        scanned = 0
        for cur in self.cursors.values():
            cap = None
            if limits is not None:
                cap = limits.get(cur.path)
                if cap is None or cap <= 0:
                    continue
            snap = cur.state()
            try:
                got = self._poll_file(cur, final, cap)
            except OSError as e:
                if not _watched_file_error(e, cur.path):
                    raise
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

    def _poll_file(self, cur: FileCursor, final: bool,
                   cap: int | None = None):
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
            cur.path, cur.offset, final=final,
            max_bytes=(MAX_WAKE_BYTES if cap is None
                       else min(MAX_WAKE_BYTES, cap)))
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


# ------------------------------------------------------------ durability
class FollowLogError(OSError):
    """A wake-log write failed: the wake's cursors rolled back, and the
    next wake tries again (the log reopens first)."""


class FollowLog:
    """The durable wake log in a job's work dir (TaskJournal mechanics).
    One line a (wake, file): the advanced cursor and the records it
    emitted land together, so a replay neither loses a line whose cursor
    advanced nor repeats one whose advance never landed."""

    FILENAME = "follow.jsonl"
    # A log past this size is rewritten at runner construction as its
    # snapshot (cursors and the retained tail): the wake stream has no
    # end, the state it encodes is bounded.
    COMPACT_BYTES = 1 << 20
    # Records a replay keeps (and so a compaction): bounds a restart's
    # memory however long the query streamed.
    REPLAY_TAIL_RECORDS = 8192

    def __init__(self, path: str | Path):
        self._journal = TaskJournal(path)

    def record_wake(self, path: str, cursor: dict, seq0: int,
                    records: list[dict]) -> None:
        self._journal.record({
            "kind": "wake", "file": path, "cursor": cursor,
            "seq0": seq0, "records": records, "t": time.time()})

    def close(self) -> None:
        self._journal.close()

    @staticmethod
    def replay(path: str | Path):
        """(cursors, next_seq, tail): each file's last cursor, the next
        record number, and the last REPLAY_TAIL_RECORDS (seq, record)
        pairs in order.  A record whose seq was already given is skipped:
        a wake whose line landed but whose fsync failed journals the same
        records again under the same seq0 after the rollback, and the
        first occurrence wins."""
        cursors: dict[str, dict] = {}
        next_seq = 1
        tail: deque = deque(maxlen=FollowLog.REPLAY_TAIL_RECORDS)
        for e in TaskJournal.replay(path):
            if e.get("kind") != "wake":
                continue
            f = e.get("file")
            if isinstance(f, str) and isinstance(e.get("cursor"), dict):
                cursors[f] = e["cursor"]
            seq = int(e.get("seq0", next_seq))
            for rec in e.get("records") or []:
                if seq >= next_seq:
                    tail.append((seq, rec))
                seq += 1
            next_seq = max(next_seq, seq)
        return cursors, next_seq, list(tail)

    @staticmethod
    def compact(path: str | Path, cursors: dict[str, dict], next_seq: int,
                tail: list[tuple[int, dict]]) -> None:
        """Rewrite the log as its snapshot (temp, fsync, rename): the
        retained tail in seq order, then one cursor line a file stamped
        seq0=next_seq, so a replay gives back the (cursors, next_seq,
        tail) it was built from."""
        p = Path(path)
        tmp = p.with_name(p.name + ".tmp")
        with open(tmp, "w", encoding="utf-8") as f:
            for seq, rec in tail:
                f.write(json.dumps(
                    {"kind": "wake", "file": str(rec.get("file", "")),
                     "seq0": seq, "records": [rec]}, sort_keys=True) + "\n")
            for fp, st in cursors.items():
                f.write(json.dumps(
                    {"kind": "wake", "file": fp, "cursor": st,
                     "seq0": next_seq, "records": []}, sort_keys=True) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, p)


# ------------------------------------------------------------ streaming
class StreamRing:
    """A bounded subscriber buffer: publish never blocks, the oldest
    records go past the byte cap, and a reader whose cursor fell behind
    learns how many it lost (``dropped``) before it goes on from the
    oldest record kept."""

    # a reply's records at most: a reader catching up drains in pages
    MAX_READ_RECORDS = 1024

    def __init__(self, cap_bytes: int | None = None, start_seq: int = 1):
        self.cap_bytes = (env_stream_buffer() if cap_bytes is None
                          else int(cap_bytes))
        self._lock = lockdep.make_lock("follow-stream")
        self._cond = threading.Condition(self._lock)
        self._dq: deque = deque()  # (seq, record, approximate bytes)
        self._bytes = 0
        self.next_seq = int(start_seq)
        self._closed = False

    @staticmethod
    def _size(rec: dict) -> int:
        return 48 + sum(len(str(k)) + len(str(v)) for k, v in rec.items())

    def publish(self, records: list[dict]) -> int:
        """Append records (numbering them) and shed the oldest past the
        cap; the first number given."""
        if not records:
            return self.next_seq
        dropped = 0
        with self._cond:
            seq0 = self.next_seq
            for rec in records:
                sz = self._size(rec)
                self._dq.append((self.next_seq, rec, sz))
                self._bytes += sz
                self.next_seq += 1
            while self._bytes > self.cap_bytes and len(self._dq) > 1:
                _seq, _rec, sz = self._dq.popleft()
                self._bytes -= sz
                dropped += 1
            self._cond.notify_all()
        if dropped:
            _count("stream_dropped_records", dropped)
        return seq0

    def read_since(self, cursor: int, timeout: float = 0.0):
        """(records, next cursor, dropped): the records numbered past
        ``cursor`` (each with its ``seq``), the cursor to pass next, and
        how many records between ``cursor`` and the oldest one kept were
        shed.  Waits up to ``timeout`` for news (a long poll)."""
        cursor = max(0, int(cursor))
        deadline = time.monotonic() + max(0.0, timeout)
        with self._cond:
            while not self._closed:
                if self._dq and self._dq[-1][0] > cursor:
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(min(remaining, 0.5))
            out: list[dict] = []
            dropped = 0
            nxt = cursor
            if self._dq and self._dq[-1][0] > cursor:
                first_seq = self._dq[0][0]
                if first_seq > cursor + 1:
                    dropped = first_seq - 1 - cursor
                # the ring's numbers are contiguous: the page starts at an
                # index, with no scan of the ring
                start = max(0, cursor + 1 - first_seq)
                for seq, rec, _sz in itertools.islice(
                        self._dq, start, start + self.MAX_READ_RECORDS):
                    out.append({"seq": seq, **rec})
                    nxt = seq
        return out, nxt, dropped

    def preload(self, tail: list[tuple[int, dict]]) -> None:
        """Seed the ring from a replayed tail (a restart): the records keep
        their numbers, and the oldest go past the cap as in publish, but
        uncounted (nothing was lost: the log holds them)."""
        with self._cond:
            for seq, rec in tail:
                if seq >= self.next_seq:
                    continue
                sz = self._size(rec)
                self._dq.append((seq, rec, sz))
                self._bytes += sz
            while self._bytes > self.cap_bytes and len(self._dq) > 1:
                _seq, _rec, sz = self._dq.popleft()
                self._bytes -= sz

    def close(self) -> None:
        """Wake every long-polling reader (a cancel, a stop, a failure)."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()


# --------------------------------------------------------------- runner
class FollowRunner:
    """One standing query of the daemon: engine, scanner, wake loop, wake
    log and ring.  Built with no service lock held (the log's open and
    replay are file I/O); the engine builds on the runner's thread.  A
    wake journals a file's line first (fsync) and publishes second: a
    crash between the two serves the records again from the replayed
    tail instead of losing them."""

    def __init__(self, job_id: str, config, work_root: str | Path, *,
                 event_log=None, on_fail=None, write_gate=None, groups=None):
        self.job_id = job_id
        self.config = config
        self.event_log = event_log
        self.on_fail = on_fail
        # the daemon's write fence (runtime/lease.py), asked before each
        # wake's journal writes: False means the daemon was deposed, and
        # the wake is dropped before a cursor moves or a record publishes
        # (the promoted daemon resumed the query from follow.jsonl) and
        # the loop stops.  None: no lease, no check
        self.write_gate = write_gate
        # the daemon's FollowGroupRegistry, or None (DGREP_FOLLOW_FUSE=0):
        # then start() runs the solo thread
        self.groups = groups
        self.fused = False  # a FollowGroup drives this runner
        self.poll_s = env_follow_poll_s(
            float(config.follow_poll_s or DEFAULT_FOLLOW_POLL_S))
        self._log_path = Path(work_root) / FollowLog.FILENAME
        cursors, next_seq, tail = FollowLog.replay(self._log_path)
        self._resume_cursors = cursors
        self.resumed = bool(cursors)
        self.ring = StreamRing(start_seq=next_seq)
        # the durable tail, so a subscriber reconnecting across a restart
        # goes on from its cursor
        self.ring.preload(tail)
        try:
            if (self._log_path.exists() and self._log_path.stat().st_size
                    > FollowLog.COMPACT_BYTES):
                FollowLog.compact(self._log_path, cursors, next_seq, tail)
        except OSError:
            log.exception("follow log compaction failed for %s", job_id)
        self._log = FollowLog(self._log_path)
        self._log_dirty = False
        self._scanner: FollowScanner | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.wakes = 0
        self.error = ""
        self.started_at = time.time()

    # ------------------------------------------------------------ engine
    def _build_engine(self):
        """The query's engine, on the job's device: ``cuda`` unless the
        options ask for ``device: cpu`` or ``backend: cpu`` (ROADMAP.md
        D8)."""
        from distributed_grep_tpu_torch.ops.engine import cached_engine

        opts = dict(self.config.effective_app_options())
        patterns = opts.get("patterns")
        pattern = opts.get("pattern") if patterns is None else None
        if isinstance(pattern, bytes):
            pattern = pattern.decode("utf-8", "surrogateescape")
        engine, _verdict = cached_engine(
            pattern, patterns=list(patterns) if patterns is not None else None,
            ignore_case=bool(opts.get("ignore_case", False)),
            **engine_options(opts))
        return engine

    def _make_scanner(self, engine) -> FollowScanner:
        """The cursors and emit semantics around ``engine``, which is None
        for a fused group's member (the group's union scan feeds ``_emit``;
        the engine comes only for a catch-up or after a demotion)."""
        opts = dict(self.config.effective_app_options())
        scanner = FollowScanner(
            engine, list(self.config.input_files),
            invert=bool(opts.get("invert", False)),
            count_only=bool(opts.get("count_only", False)),
            presence_only=bool(opts.get("presence_only", False)))
        scanner.restore(self._resume_cursors)
        return scanner

    def _build_scanner(self) -> FollowScanner:
        return self._make_scanner(self._build_engine())

    # --------------------------------------------------------- lifecycle
    def start(self) -> None:
        if self.groups is not None and self.groups.adopt(self):
            return  # a FollowGroup's wake thread drives this runner
        self.start_solo()

    def start_solo(self) -> None:
        """Start the solo wake thread: without a registry, for a query no
        group takes, and for a member a group sent back (its scanner keeps
        the exact cursors; its engine comes at the first solo wake)."""
        if self._thread is not None and self._thread.is_alive():
            return
        self.fused = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"follow-{self.job_id}")
        self._thread.start()

    def request_stop(self) -> None:
        """State only (safe under any lock): the loop ends at its next
        check; readers wake through ring.close()."""
        self._stop.set()

    def close(self, join_timeout_s: float = 10.0) -> None:
        """Teardown with no service lock held: stop the loop, wake the
        readers, close the log.  Safe from the runner's own thread (a
        failure's on_fail closes the job on it)."""
        self._stop.set()
        if self.groups is not None:
            # waits for a group wake in flight, which may be writing this
            # member's log; afterwards no group touches the runner
            self.groups.discard(self)
        self.ring.close()
        if (self._thread is not None
                and self._thread is not threading.current_thread()):
            self._thread.join(timeout=join_timeout_s)
        try:
            self._log.close()
        except Exception:  # noqa: BLE001 -- teardown must not raise
            log.exception("follow log close failed for %s", self.job_id)

    def fail(self, error: str) -> None:
        """End the standing query on an error of its scan (D9): the loop
        stops, the ring closes and the daemon fails the job."""
        log.error("follow job %s failed: %s", self.job_id, error)
        self.error = error
        self._stop.set()
        self.ring.close()
        if self.on_fail is not None:
            self.on_fail(self.job_id, error)

    def _run(self) -> None:
        if self._stop.is_set():
            return  # cancelled before the thread ran: no build
        try:
            if self._scanner is None:
                self._scanner = self._build_scanner()
            elif self._scanner.engine is None:
                # sent back by a group: the cursors are the member's own
                self._scanner.engine = self._build_engine()
        except Exception as e:  # noqa: BLE001 -- fails the job
            self.fail(f"{type(e).__name__}: {e}")
            return
        while not self._stop.is_set():
            try:
                self.wake_once()
            except FollowLogError:
                # the log's write failed; the cursors rolled back and the
                # next wake journals the same records
                log.exception("follow wake log failed for %s", self.job_id)
            except Exception as e:  # noqa: BLE001 -- D9: fails the job
                self.fail(f"{type(e).__name__}: {e}")
                return
            self._stop.wait(self.poll_s)

    def _reopen_log_if_dirty(self) -> None:
        """A failed write may have torn a line mid-file; reopening
        truncates the torn tail, so the next line does not join it."""
        if not self._log_dirty:
            return
        try:
            self._log.close()
        except Exception:  # noqa: BLE001 -- the handle may be dead
            log.exception("follow log close-for-reopen failed")
        self._log = FollowLog(self._log_path)
        self._log_dirty = False

    def wake_once(self) -> int:
        """One wake: scan, journal, publish; the records emitted.  Raises
        FollowLogError when the log's write failed (the cursors of the
        files not yet journaled rolled back), and any error of the scan
        as it came."""
        if self.write_gate is not None and not self.write_gate():
            # deposed: no scan, no log line, no publish, no more wakes
            self.request_stop()
            return 0
        if self._scanner is None:
            self._scanner = self._build_scanner()
        elif self._scanner.engine is None:
            self._scanner.engine = self._build_engine()
        self._reopen_log_if_dirty()
        snap = {p: c.state() for p, c in self._scanner.cursors.items()}
        groups = self._scanner.poll_once()
        emitted = 0
        for i, (path, records, cursor) in enumerate(groups):
            seq0 = self.ring.next_seq
            try:
                self._log.record_wake(path, cursor, seq0, records)
            except OSError as e:
                self._log_dirty = True
                for p2, _recs2, _cur2 in groups[i:]:
                    c2 = self._scanner.cursors.get(p2)
                    if c2 is not None and p2 in snap:
                        c2.restore(snap[p2])
                raise FollowLogError(str(e)) from e
            self.ring.publish(records)
            emitted += len(records)
        if groups:
            self.wakes += 1
            self._wake_event("follow:wake", len(groups), emitted)
        return emitted

    def _wake_event(self, name: str, n_files: int, n_records: int) -> None:
        if self.event_log is None:
            return
        try:
            self.event_log.write({
                "t": "instant", "name": name, "cat": "follow",
                "ts": time.time(), "job": self.job_id,
                "args": {"files": n_files, "records": n_records}})
        except Exception:  # noqa: BLE001 -- telemetry only
            log.exception("%s event write failed", name)

    # ------------------------------------ the fused tier's entries
    def fused_commit(self, path: str, cursor: dict,
                     records: list[dict]) -> None:
        """Journal and publish one (file, wake) of this member, scanned by
        its group: wake_once's order and torn-line reopen, without the
        scan.  Raises FollowLogError when the log's write fails (the group
        rolls the member's cursor back and sends it solo)."""
        self._reopen_log_if_dirty()
        seq0 = self.ring.next_seq
        try:
            self._log.record_wake(path, cursor, seq0, records)
        except OSError as e:
            self._log_dirty = True
            raise FollowLogError(str(e)) from e
        self.ring.publish(records)

    def note_fused_wake(self, n_files: int, n_records: int, *,
                        fused: bool = True) -> None:
        """A group-driven wake: ``fuse:wake`` for a shared scan (explain's
        fused route), ``follow:wake`` for a catch-up (solo semantics on
        the group's thread)."""
        self.wakes += 1
        self._wake_event("fuse:wake" if fused else "follow:wake", n_files,
                         n_records)

    def status(self) -> dict:
        out: dict = {"poll_s": self.poll_s, "wakes": self.wakes,
                     "files": len(self.config.input_files),
                     "next_seq": self.ring.next_seq}
        if self.resumed:
            out["resumed"] = True
        if self.fused:
            out["fused"] = True
        if self.error:
            out["error"] = self.error
        sc = self._scanner
        if sc is not None:
            out["selected"] = int(sum(c.emitted for c in sc.cursors.values()))
        return out


# The engine knobs of a job's app options a standing query's engines take
# too (grep_cuda passes them to its engine the same way).
_ENGINE_KNOBS = ("target_lanes", "segment_bytes", "min_chunk",
                 "device_min_bytes")


def engine_options(opts: dict) -> dict:
    """The engine arguments of a standing query: the job's ``device``
    (``cuda`` unless it asks for ``cpu``), ``backend`` (``device`` unless
    ``cpu``, the host scanners) and the engine knobs it sets."""
    return {"device": str(opts.get("device", "cuda")),
            "backend": "cpu" if opts.get("backend") == "cpu" else "device",
            **{k: opts[k] for k in _ENGINE_KNOBS if k in opts}}


# ------------------------------------------------------------ fused tier
@dataclass
class _GroupMember:
    """One standing query in a FollowGroup: its runner, its query spec
    (its slot in the union), the map from the group's realpaths to the
    member's own spellings (its records carry them), and its scanner
    without an engine (the exact cursors and emit semantics)."""

    runner: FollowRunner
    spec: tuple
    paths: dict[str, str]
    scanner: FollowScanner
    catching_up: bool = True


class FollowGroup:
    """One wake loop and one cursor a file serving K fused standing
    queries: a wake runs one stat, one suffix read and one union scan a
    grown file (FusedScanner.scan_suffix) and hands each member its exact
    result through FollowRunner.fused_commit, into the member's own log
    and ring.

    Membership changes under the registry's lock (state only); the scans
    and the journal writes run under the group's wake lock
    ("follow-group-wake", io_ok), which FollowGroupRegistry.discard also
    takes.  The wake lock is taken before the registry's lock, never
    after."""

    def __init__(self, key: tuple, reg: "FollowGroupRegistry"):
        self.key = key
        self._reg = reg
        # by realpath: offsets and lines are the same for every member
        self.cursors: dict[str, FileCursor] = {}
        self._members: list[_GroupMember] = []
        self._wake_lock = lockdep.make_lock("follow-group-wake", io_ok=True)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._fused = None  # the FusedScanner of the current members
        self._fused_specs: tuple = ()
        self.poll_s = DEFAULT_FOLLOW_POLL_S
        self.wakes = 0
        self.last_wake = time.monotonic()

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"follow-group-{id(self):x}")
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.wake_once()
            except Exception as e:  # noqa: BLE001 -- D9: fails the jobs
                self.fail_all(f"{type(e).__name__}: {e}")
                return
            self._stop.wait(self.poll_s)

    def members(self) -> list[_GroupMember]:
        with self._reg._lock:
            return list(self._members)

    def _recompute_cadence_locked(self) -> None:
        # the tightest member's poll_s (state only: under the registry lock)
        if self._members:
            self.poll_s = min(m.runner.poll_s for m in self._members)

    def wake_once(self) -> int:
        """One group wake: the joiners caught up, then one shared suffix
        scan a grown file handed to every fused member; the records
        emitted.  An error of the union's scan or build raises (the
        group's loop fails every member's job: D9); a member whose
        catch-up scan fails has its job failed once the wake lock is
        released."""
        failed: list[tuple[_GroupMember, str]] = []
        try:
            with self._wake_lock:
                return self._wake_under_lock(failed)
        finally:
            for m, error in failed:
                self._fail_member(m, error)

    def _wake_under_lock(self, failed: list) -> int:
        gate = self._reg.write_gate
        if gate is not None and not gate():
            # deposed: every member stops before any log write (the
            # promoted daemon owns the cursors)
            for m in self.members():
                m.runner.request_stop()
            self._stop.set()
            return 0
        self.last_wake = time.monotonic()
        emitted = 0
        for m in self.members():
            if m.catching_up and not m.runner._stop.is_set():
                emitted += self._catch_up(m, failed)
        done = {id(m) for m, _ in failed}
        fused = [m for m in self.members()
                 if not m.catching_up and not m.runner._stop.is_set()
                 and id(m) not in done]
        if not fused:
            return emitted
        if not self._ensure_union(fused):
            return emitted  # FuseError: every member went solo
        tally: dict[str, list[int]] = {m.runner.job_id: [0, 0]
                                       for m in fused}
        dead: set[int] = set()
        news = False
        for real in sorted(self.cursors):
            n = self._wake_file(self.cursors[real], fused, dead, tally)
            if n is None:
                return emitted  # a truncation: the group went solo
            if n:
                news = True
                emitted += n
        if news:
            self.wakes += 1
            # the group's one scan pass is one wake, as a solo runner's
            _count("follow_wakes")
            alive = [m for m in fused if id(m) not in dead]
            if len(alive) >= 2:
                _count_fused("follow_fused_wakes")
            for m in alive:
                files, recs = tally[m.runner.job_id]
                if files:
                    m.runner.note_fused_wake(files, recs)
        return emitted

    def _wake_file(self, gcur: FileCursor, fused: list[_GroupMember],
                   dead: set[int], tally: dict[str, list[int]]):
        """One shared suffix scan handed to every fused member: the records
        emitted, 0 when the file had no news, or None when a truncation or
        replacement sent the group solo."""
        try:
            st = os.stat(gcur.path)
        except OSError:
            return 0  # not there yet, or gone: the cursor waits
        if st.st_size < gcur.offset or (gcur.ino >= 0
                                        and st.st_ino != gcur.ino):
            # each member's solo runner sees the reset against its own
            # cursor and emits its reset record and rescan
            self._demote_all()
            return None
        gcur.ino = int(st.st_ino)
        if st.st_size <= gcur.offset or st.st_size == gcur.seen:
            return 0
        try:
            results, consumed, data = self._fused.scan_suffix(
                gcur.path, gcur.offset, max_bytes=MAX_WAKE_BYTES)
        except OSError as e:
            if not _watched_file_error(e, gcur.path):
                raise
            log.exception("fused follow read failed for %s", gcur.path)
            return 0  # the next wake tries again
        if consumed == 0:
            gcur.seen = int(st.st_size)
            return 0
        # one read and one union scan for K members
        _count("suffix_bytes_scanned", consumed)
        live = [m for m in fused if id(m) not in dead
                and not m.runner._stop.is_set()]
        if len(live) >= 2:
            _count_fused("follow_suffix_bytes_saved",
                         consumed * (len(live) - 1))
        n_records = 0
        for k, m in enumerate(fused):
            if id(m) in dead or m.runner._stop.is_set():
                continue
            mpath = m.paths[gcur.path]
            mcur = m.scanner.cursors[mpath]
            snap = mcur.state()
            recs = m.scanner._emit(mcur, results[k], data)
            mcur.offset += consumed
            mcur.ino = gcur.ino
            try:
                m.runner.fused_commit(mpath, mcur.state(), recs)
            except FollowLogError:
                # the member's log failed: its cursor rolls back and it
                # goes solo (no line lost, none repeated); the others go on
                log.exception("fused commit failed for %s: solo",
                              m.runner.job_id)
                mcur.restore(snap)
                dead.add(id(m))
                self._demote(m)
                continue
            t = tally[m.runner.job_id]
            t[0] += 1
            t[1] += len(recs)
            n_records += len(recs)
        gcur.offset += consumed
        # consumed > 0 and not final: the data ends at a newline
        gcur.line += data.count(b"\n")
        return n_records

    def _ensure_union(self, fused: list[_GroupMember]) -> bool:
        """(Re)build the FusedScanner when the members changed (its
        engines come from the cross-job cache, so a stable group builds
        nothing).  FuseError sends every member solo and answers False;
        any other error of the build raises (D9)."""
        from distributed_grep_tpu_torch.ops.fuse import FusedScanner, FuseError

        specs = tuple(m.spec for m in fused)
        if self._fused is not None and specs == self._fused_specs:
            return True
        opts = dict(fused[0].runner.config.effective_app_options())
        try:
            self._fused = FusedScanner(list(specs), **engine_options(opts))
        except FuseError:
            log.exception("fused follow union refused: the members go solo")
            self._fused = None
            self._fused_specs = ()
            self._demote_all()
            return False
        self._fused_specs = specs
        return True

    def _catch_up(self, m: _GroupMember, failed: list) -> int:
        """Bring a joiner from its durable cursor to the group's (solo
        semantics on the group's thread, each read capped so it ends on
        the group's cursor).  A member ahead of the group, or on another
        inode, goes solo: only a member behind or level can fuse without
        emitting twice.  An error of its engine build or its scan fails
        its job (D9)."""
        limits: dict[str, int] = {}
        for real, gcur in self.cursors.items():
            mpath = m.paths.get(real)
            mcur = m.scanner.cursors.get(mpath) if mpath else None
            if mcur is None:
                self._demote(m)
                return 0
            if mcur.offset > gcur.offset or (
                    mcur.ino >= 0 and gcur.ino >= 0 and mcur.ino != gcur.ino):
                self._demote(m)
                return 0
            if mcur.offset < gcur.offset:
                limits[mpath] = gcur.offset - mcur.offset
        if not limits:
            m.catching_up = False
            m.runner.fused = True
            return 0
        snap = {p: c.state() for p, c in m.scanner.cursors.items()}
        try:
            if m.scanner.engine is None:
                m.scanner.engine = m.runner._build_engine()
            groups = m.scanner.poll_once(limits=limits)
        except Exception as e:  # noqa: BLE001 -- D9: fails the member
            for p, st in snap.items():
                c = m.scanner.cursors.get(p)
                if c is not None:
                    c.restore(st)
            failed.append((m, f"{type(e).__name__}: {e}"))
            return 0
        emitted = 0
        for i, (path, records, cursor) in enumerate(groups):
            try:
                m.runner.fused_commit(path, cursor, records)
            except FollowLogError:
                log.exception("fused catch-up commit failed for %s: solo",
                              m.runner.job_id)
                for p2, _r2, _c2 in groups[i:]:
                    c2 = m.scanner.cursors.get(p2)
                    if c2 is not None and p2 in snap:
                        c2.restore(snap[p2])
                self._demote(m)
                return emitted
            emitted += len(records)
        if groups:
            m.runner.note_fused_wake(len(groups), emitted, fused=False)
        return emitted

    def _demote(self, m: _GroupMember) -> None:
        self._reg.demote(self, m)

    def _demote_all(self) -> None:
        for m in self.members():
            self._reg.demote(self, m)

    def _fail_member(self, m: _GroupMember, error: str) -> None:
        """Fail one member's job (no group lock held): out of the group,
        never solo."""
        self._reg.remove(self, m)
        m.runner.fail(error)

    def fail_all(self, error: str) -> None:
        """Fail every member's job on an error of the shared scan (D9)."""
        for m in self.members():
            self._fail_member(m, error)
        self._stop.set()

    def status(self) -> dict:
        with self._reg._lock:
            members = list(self._members)
        row: dict = {
            "members": len(members),
            "jobs": [m.runner.job_id for m in members],
            "files": len(self.cursors),
            "poll_s": self.poll_s,
            "wakes": self.wakes,
            "cursor_bytes": int(sum(c.offset for c in self.cursors.values())),
            # a stalled group shows here before its readers see shed
            # records (`top` renders it)
            "wake_lag_s": round(max(0.0, time.monotonic() - self.last_wake),
                                3),
        }
        catching = sum(1 for m in members if m.catching_up)
        if catching:
            row["catching_up"] = catching
        return row


class FollowGroupRegistry:
    """The daemon's table of fused groups.  ``adopt`` puts a starting
    runner into its group (one a runtime/fusion.follow_fusion_key);
    ``discard`` takes a stopping runner out; ``demote`` sends a member
    back to its solo runner.  The registry's lock ("follow-groups") guards
    state only: the key's stats and every scan and write run outside it,
    and a group's wake lock is taken before it."""

    def __init__(self, *, write_gate=None, start_threads: bool = True,
                 auto_solo: bool = True):
        from distributed_grep_tpu_torch.runtime.fusion import (
            env_fuse_max_queries,
        )

        self._lock = lockdep.make_lock("follow-groups")
        self._groups: dict[tuple, FollowGroup] = {}
        # the daemon's write fence, asked before each group wake
        # (FollowRunner.write_gate)
        self.write_gate = write_gate
        # tests: start_threads=False drives group.wake_once by hand;
        # auto_solo=False leaves a demoted runner unstarted
        self.start_threads = start_threads
        self.auto_solo = auto_solo
        self.max_members = env_fuse_max_queries()

    def adopt(self, runner: FollowRunner) -> bool:
        """Put a starting runner into its group when it has a key; False:
        the caller runs it solo."""
        from distributed_grep_tpu_torch.runtime.fusion import (
            follow_fusion_key,
            query_spec,
        )

        key = follow_fusion_key(runner.config)
        if key is None:
            return False
        spec = query_spec(dict(runner.config.effective_app_options()))
        if spec is None:
            return False
        paths: dict[str, str] = {}
        for f in runner.config.input_files:
            paths[os.path.realpath(os.fspath(f))] = str(f)
        if len(paths) != len(runner.config.input_files):
            # two spellings of one file: the solo scanner keeps a cursor
            # a spelling, which a shared cursor cannot
            return False
        member = _GroupMember(runner=runner, spec=spec, paths=paths,
                              scanner=runner._make_scanner(None))
        fresh: FollowGroup | None = None
        with self._lock:
            group = self._groups.get(key)
            if group is None or group._stop.is_set():
                group = FollowGroup(key, self)
                for real, mpath in member.paths.items():
                    gcur = FileCursor(path=real)
                    gcur.restore(member.scanner.cursors[mpath].state())
                    group.cursors[real] = gcur
                self._groups[key] = group
                fresh = group
            elif len(group._members) >= self.max_members:
                # DGREP_FUSE_MAX_QUERIES bounds the union, as in batch
                # fusion
                return False
            group._members.append(member)
            group._recompute_cadence_locked()
            runner._scanner = member.scanner
        _count_fused("follow_fused_queries")
        if fresh is not None and self.start_threads:
            fresh.start()
        return True

    def remove(self, group: FollowGroup, member: _GroupMember) -> bool:
        """Take a member out (state only); True when the group is then
        empty and retired."""
        with self._lock:
            if member in group._members:
                group._members.remove(member)
            group._recompute_cadence_locked()
            if group._members:
                return False
            if self._groups.get(group.key) is group:
                del self._groups[group.key]
        group._stop.set()
        return True

    def demote(self, group: FollowGroup, member: _GroupMember) -> None:
        """Send a member back to its solo runner (from the group's wake,
        under its wake lock); the last one retires the group."""
        self.remove(group, member)
        member.runner.fused = False
        if self.auto_solo and not member.runner._stop.is_set():
            member.runner.start_solo()

    def discard(self, runner: FollowRunner) -> None:
        """Take a stopping runner out (a cancel, a stop, a failure).  Takes
        the group's wake lock first, so a wake in flight finishes its
        writes to this runner's log and ring before close() tears them
        down."""
        found = None
        with self._lock:
            for g in self._groups.values():
                for m in g._members:
                    if m.runner is runner:
                        found = (g, m)
                        break
                if found:
                    break
        if found is not None:
            g, m = found
            with g._wake_lock:
                self.remove(g, m)
        runner.fused = False

    def status_rows(self) -> list[dict]:
        with self._lock:
            groups = list(self._groups.values())
        return [g.status() for g in groups]

    def close(self) -> None:
        """Stop every group's loop (the daemon's stop; normally the last
        member's discard retired each group already)."""
        with self._lock:
            groups = list(self._groups.values())
            self._groups.clear()
        for g in groups:
            g._stop.set()
