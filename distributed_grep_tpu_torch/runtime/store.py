"""Pluggable blob-store commit layer — exactly-once without atomic rename
(the reference's runtime/store.py).

The MapReduce commit is "write to temp, rename" on a POSIX filesystem.
Object stores (GCS/S3-style) have no atomic rename:
a crash mid-"rename" can leave duplicate, torn, or phantom objects.  This
module makes the commit protocol a pluggable Store with two semantics:

* PosixStore — temp + fsync + rename (the fsync before the rename: the
  commit-record design promises blob durability before anything
  publishes, and a host crash must not leave a committed-but-empty
  file).  A blob is visible iff the
  rename happened; duplicate executions overwrite idempotently.
* NonAtomicStore — object-store semantics emulated on a local directory:
  there is NO rename.  A write lands as ``<name>.part.<attempt>`` (plain
  write — a crash can tear it), then publishes a small self-checksummed
  commit record ``<name>.commit.<attempt>``.  Readers resolve a logical
  name to exactly one winning attempt: the lexicographically smallest
  attempt whose record parses, checksums, and whose part file matches the
  recorded size.  Torn parts (no record), torn records (bad checksum), and
  racing duplicate attempts (two records) all resolve deterministically —
  a reader can never observe a torn or half-committed blob.

Exactly-once task commit layers on top: a worker publishes one *task
commit record* (``commits/<kind>-<task_id>.<attempt>``) after all its
blobs are durable and before notifying the coordinator.  The scheduler
treats that record — not the MapFinished RPC args, not mr-* file
existence — as the unit of truth when registering map outputs and when
replaying the journal, so a re-executed straggler whose late commit races
the sweeper's re-issue can never double-register or expose a torn file.

FaultStore wraps any store with deterministic crash injection at the four
points where the protocol can be interrupted (CrashPoint); the crash
tests drive it.

Scale note: resolution is glob-based (one directory scan per lookup), so a
job with N tasks does O(N) dirent work per completion/read — O(N^2)
total.  Fine to ~thousands of tasks; past that the known fix is an
in-memory attempt index keyed by logical name (built from one scandir),
deferred until a workload needs it.
"""

from __future__ import annotations

import fnmatch
import json
import os
import shutil
import tempfile
import uuid
import zlib
from pathlib import Path
from typing import Callable, Optional, Protocol

from distributed_grep_tpu_torch.utils.logging import get_logger

log = get_logger("store")


class CrashPoint:
    """Injection points for FaultStore — each models a worker dying at a
    distinct instruction of the commit protocol."""

    # blob bytes staged (temp/part file written + fsync'd) but not yet
    # published: rename not executed (posix) / blob record not written
    # (non-atomic).  The blob must be invisible to readers.
    AFTER_TEMP_WRITE = "after_temp_write"
    # all blobs committed, task commit record not yet published: the task
    # must re-run; its re-committed blobs must resolve to one winner.
    BEFORE_COMMIT_RECORD = "before_commit_record"
    # task commit record published, coordinator never notified (worker died
    # before the MapFinished/ReduceFinished RPC): a re-run commits a second
    # attempt; resolution must still pick exactly one.
    AFTER_COMMIT_BEFORE_ACK = "after_commit_before_ack"
    # the task commit record itself tears mid-write (non-atomic store
    # semantics): the torn record must parse as absent, never as truth.
    TORN_COMMIT_RECORD = "torn_commit_record"

    ALL = (AFTER_TEMP_WRITE, BEFORE_COMMIT_RECORD,
           AFTER_COMMIT_BEFORE_ACK, TORN_COMMIT_RECORD)


def new_attempt_id() -> str:
    """Attempt ids sort the way they were created only by accident — the
    winner pick is 'lexicographically smallest valid attempt', which is
    deterministic for every reader without any clock assumptions."""
    return uuid.uuid4().hex


# --------------------------------------------------------------- records
# One record format for blob commit markers and task commit records:
#   <json payload>\n<crc32 of the json bytes, 8 hex digits>\n
# A torn write (any prefix of the file) fails either the JSON parse or the
# checksum line and is treated as absent — tearing is detectable, which is
# all a non-atomic store can promise for a small single-block PUT.

def encode_record(payload: dict) -> bytes:
    body = json.dumps(payload, sort_keys=True).encode("utf-8")
    return body + b"\n" + f"{zlib.crc32(body):08x}".encode("ascii") + b"\n"


def decode_record(data: bytes) -> Optional[dict]:
    """The payload, or None for anything torn/invalid."""
    lines = data.split(b"\n")
    if len(lines) < 3:  # body, crc, trailing '' — anything shorter is torn
        return None
    body, crc_line = lines[0], lines[1]
    if crc_line != f"{zlib.crc32(body):08x}".encode("ascii"):
        return None
    try:
        payload = json.loads(body)
    except (json.JSONDecodeError, UnicodeDecodeError):
        return None
    return payload if isinstance(payload, dict) else None


def task_commit_path(directory: Path, kind: str, task_id: int,
                     attempt: str) -> Path:
    return Path(directory) / f"{kind}-{task_id}.{attempt}"


def _fsync_file(f) -> None:
    f.flush()
    os.fsync(f.fileno())


# -------------------------------------------------------------- protocol
class Store(Protocol):
    """How blobs become visible.  Paths are the LOGICAL blob paths (e.g.
    <workdir>/intermediate/mr-3-1); a store may materialize them under
    decorated concrete names — readers go through get()/resolve()/
    list_committed() and only ever see fully-committed winners."""

    name: str

    # blob writes (visible-on-return, never torn for readers).
    # consume=True on put_from_file: the caller donates src and tolerates
    # it disappearing — a store MAY commit it by rename (PosixStore);
    # stores whose protocol needs staged copies simply ignore the flag.
    def put(self, path: Path, data: bytes) -> None: ...
    def put_from_file(self, path: Path, src: Path,
                      chunk_bytes: int = 1 << 20,
                      consume: bool = False) -> None: ...
    def put_from_stream(self, path: Path, stream, length: int,
                        chunk_bytes: int = 1 << 20) -> None: ...

    # blob reads
    def get(self, path: Path) -> bytes: ...
    def exists(self, path: Path) -> bool: ...
    def resolve(self, path: Path) -> Optional[Path]: ...
    def list_committed(self, directory: Path, pattern: str) -> list[Path]: ...

    # exactly-once task commit
    def commit_task(self, directory: Path, kind: str, task_id: int,
                    attempt: str, payload: dict) -> None: ...
    def resolve_task_commit(self, directory: Path, kind: str,
                            task_id: int) -> Optional[dict]: ...


# ----------------------------------------------------------------- posix
class PosixStore:
    """temp + fsync + rename — the reference's commit protocol
    (worker.go:103), extracted from utils/io.py with fsync added before
    the rename (a deliberate durability upgrade — see the module
    docstring; on the tmpfs-backed work dirs of tests/CI it is ~free).
    os.replace is atomic on POSIX, so duplicate executions overwrite
    idempotently and readers never see a torn blob."""

    name = "posix"

    def __init__(self, durable: bool = True):
        # durable=False skips the fsync-before-rename — the ATOMICITY
        # contract is unchanged (temp + rename; readers never see torn
        # blobs, duplicate attempts still overwrite idempotently), only
        # crash DURABILITY is waived.  For ephemeral work dirs only (the
        # CLI's unresumable temp dirs — the same argument that
        # disables the journal there): a blob lost to a power cut costs
        # a re-run, never corruption.  Resumable/service work dirs keep
        # the default; the dense receipt measured ~0.3 s of fsync per
        # 64 MB job on this box (31 calls x ~10 ms).
        self.durable = durable

    def _sync(self, f) -> None:
        if self.durable:
            _fsync_file(f)

    # --- two-phase internals (FaultStore injects between them) ----------
    def _stage_put(self, path: Path, data: bytes) -> str:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=f".{path.name}.tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
                self._sync(f)
        except BaseException:
            _unlink_quiet(tmp)
            raise
        return tmp

    def _stage_put_from_file(self, path: Path, src: Path,
                             chunk_bytes: int) -> str:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=f".{path.name}.tmp")
        try:
            with os.fdopen(fd, "wb") as out, open(src, "rb") as f:
                shutil.copyfileobj(f, out, chunk_bytes)
                self._sync(out)
        except BaseException:
            _unlink_quiet(tmp)
            raise
        return tmp

    def _stage_put_from_stream(self, path: Path, stream, length: int,
                               chunk_bytes: int) -> str:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=f".{path.name}.tmp")
        try:
            with os.fdopen(fd, "wb") as out:
                remaining = length
                while remaining > 0:
                    block = stream.read(min(chunk_bytes, remaining))
                    if not block:
                        raise ConnectionError(
                            f"short body: {remaining} of {length} bytes missing"
                        )
                    out.write(block)
                    remaining -= len(block)
                self._sync(out)
        except BaseException:
            _unlink_quiet(tmp)
            raise
        return tmp

    def _publish_put(self, path: Path, staged: str) -> None:
        try:
            os.replace(staged, path)
        except BaseException:
            _unlink_quiet(staged)
            raise

    # --- Store API ------------------------------------------------------
    def put(self, path: Path, data: bytes) -> None:
        self._publish_put(path, self._stage_put(path, data))

    def put_from_file(self, path: Path, src: Path,
                      chunk_bytes: int = 1 << 20,
                      consume: bool = False) -> None:
        # consume=True: the caller DONATES src (it tolerates the file
        # disappearing) — commit by RENAME instead of a full copy when
        # the filesystems allow (the worker's reduce spool was measured
        # as a second full write of the output).  Durability is
        # preserved: the durable path fsyncs src IN PLACE first — the
        # same fsync-before-rename ordering the copy path gives.
        # Cross-device renames (EXDEV) fall back to the copy.
        if consume:
            src = Path(src)
            try:
                if self.durable:
                    fd = os.open(src, os.O_RDONLY)
                    try:
                        os.fsync(fd)
                    finally:
                        os.close(fd)
                path = Path(path)
                path.parent.mkdir(parents=True, exist_ok=True)
                os.replace(src, path)
                return
            except OSError:
                pass  # cross-device or permissions: copy below
        self._publish_put(path, self._stage_put_from_file(path, src, chunk_bytes))

    def put_from_stream(self, path: Path, stream, length: int,
                        chunk_bytes: int = 1 << 20) -> None:
        self._publish_put(
            path, self._stage_put_from_stream(path, stream, length, chunk_bytes)
        )

    def get(self, path: Path) -> bytes:
        return Path(path).read_bytes()

    def exists(self, path: Path) -> bool:
        return Path(path).exists()

    def resolve(self, path: Path) -> Optional[Path]:
        path = Path(path)
        return path if path.exists() else None

    def list_committed(self, directory: Path, pattern: str) -> list[Path]:
        return sorted(Path(directory).glob(pattern))

    def commit_task(self, directory: Path, kind: str, task_id: int,
                    attempt: str, payload: dict) -> None:
        rec = dict(payload, kind=kind, task_id=task_id, attempt=attempt)
        self.put(task_commit_path(directory, kind, task_id, attempt),
                 encode_record(rec))

    def resolve_task_commit(self, directory: Path, kind: str,
                            task_id: int) -> Optional[dict]:
        return _resolve_task_commit(self, directory, kind, task_id)


# ------------------------------------------------------------ non-atomic
class NonAtomicStore:
    """Object-store commit semantics on a plain directory: no rename, no
    atomic overwrite — visibility comes from the marker protocol.

    write  : bytes -> <name>.part.<attempt> (plain write + fsync; a crash
             before the fsync returns can leave a torn part with no record)
    publish: <name>.commit.<attempt> — a small self-checksummed record
             naming the attempt and the part's size + crc32.  Emulates the
             atomic small-object PUT every real object store provides.
    resolve: smallest valid attempt whose part exists at the recorded
             size.  Size is re-checked on every resolve (a record without
             its part — e.g. partial cleanup — must not win); the part's
             content crc is recorded for audits but not re-read per
             resolve (the part was fsync'd before its record was
             published, so a valid record implies durable bytes).
    """

    name = "nonatomic"

    # --- two-phase internals --------------------------------------------
    def _stage_put(self, path: Path, data: bytes) -> tuple[Path, str, int, int]:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        attempt = new_attempt_id()
        part = path.parent / f"{path.name}.part.{attempt}"
        with open(part, "wb") as f:
            f.write(data)
            _fsync_file(f)
        return part, attempt, len(data), zlib.crc32(data)

    def _stage_put_stream_like(self, path: Path, writer) -> tuple[Path, str, int, int]:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        attempt = new_attempt_id()
        part = path.parent / f"{path.name}.part.{attempt}"
        crc = 0
        size = 0
        with open(part, "wb") as f:
            for block in writer():
                f.write(block)
                crc = zlib.crc32(block, crc)
                size += len(block)
            _fsync_file(f)
        return part, attempt, size, crc

    def _publish_put(self, path: Path, staged: tuple[Path, str, int, int]) -> None:
        _part, attempt, size, crc = staged
        path = Path(path)
        rec = {"name": path.name, "attempt": attempt, "size": size, "crc": crc}
        marker = path.parent / f"{path.name}.commit.{attempt}"
        with open(marker, "wb") as f:
            f.write(encode_record(rec))
            _fsync_file(f)

    def _stage_put_from_file(self, path: Path, src: Path,
                             chunk_bytes: int) -> tuple[Path, str, int, int]:
        def writer():
            with open(src, "rb") as f:
                while True:
                    block = f.read(chunk_bytes)
                    if not block:
                        return
                    yield block

        return self._stage_put_stream_like(path, writer)

    def _stage_put_from_stream(self, path: Path, stream, length: int,
                               chunk_bytes: int) -> tuple[Path, str, int, int]:
        def writer():
            remaining = length
            while remaining > 0:
                block = stream.read(min(chunk_bytes, remaining))
                if not block:
                    raise ConnectionError(
                        f"short body: {remaining} of {length} bytes missing"
                    )
                remaining -= len(block)
                yield block

        return self._stage_put_stream_like(path, writer)

    # --- Store API ------------------------------------------------------
    def put(self, path: Path, data: bytes) -> None:
        self._publish_put(path, self._stage_put(path, data))

    def put_from_file(self, path: Path, src: Path,
                      chunk_bytes: int = 1 << 20,
                      consume: bool = False) -> None:
        # consume is IGNORED here: the marker protocol's visibility rests
        # on the part file being fully fsync'd under its staged
        # .part.<attempt> name before the commit record lands — a rename
        # shortcut would skip that staging entirely.
        self._publish_put(path, self._stage_put_from_file(path, src, chunk_bytes))

    def put_from_stream(self, path: Path, stream, length: int,
                        chunk_bytes: int = 1 << 20) -> None:
        self._publish_put(
            path, self._stage_put_from_stream(path, stream, length, chunk_bytes)
        )

    def _valid_attempts(self, path: Path) -> list[tuple[str, Path, dict]]:
        """(attempt, part_path, record) for every committed attempt of a
        logical path, sorted by attempt id."""
        path = Path(path)
        out = []
        for marker in path.parent.glob(f"{path.name}.commit.*"):
            attempt = marker.name.rpartition(".commit.")[2]
            try:
                rec = decode_record(marker.read_bytes())
            except OSError:
                continue
            if not rec or rec.get("attempt") != attempt:
                continue
            part = path.parent / f"{path.name}.part.{attempt}"
            try:
                if part.stat().st_size != rec.get("size"):
                    continue  # record without its (whole) part: not a winner
            except OSError:
                continue
            out.append((attempt, part, rec))
        out.sort(key=lambda t: t[0])
        return out

    def resolve(self, path: Path) -> Optional[Path]:
        attempts = self._valid_attempts(path)
        return attempts[0][1] if attempts else None

    def get(self, path: Path) -> bytes:
        p = self.resolve(path)
        if p is None:
            raise FileNotFoundError(f"no committed attempt for {path}")
        return p.read_bytes()

    def exists(self, path: Path) -> bool:
        return self.resolve(path) is not None

    def list_committed(self, directory: Path, pattern: str) -> list[Path]:
        directory = Path(directory)
        logical: dict[str, Path] = {}
        for marker in directory.glob("*.commit.*"):
            name = marker.name.rpartition(".commit.")[0]
            if name in logical or not fnmatch.fnmatchcase(name, pattern):
                continue
            p = self.resolve(directory / name)
            if p is not None:
                logical[name] = p
        return [logical[name] for name in sorted(logical)]

    def commit_task(self, directory: Path, kind: str, task_id: int,
                    attempt: str, payload: dict) -> None:
        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        rec = dict(payload, kind=kind, task_id=task_id, attempt=attempt)
        # a small single-block PUT: plain write + fsync.  Tearing is
        # possible — and detectable, because the record self-checksums.
        with open(task_commit_path(directory, kind, task_id, attempt), "wb") as f:
            f.write(encode_record(rec))
            _fsync_file(f)

    def resolve_task_commit(self, directory: Path, kind: str,
                            task_id: int) -> Optional[dict]:
        return _resolve_task_commit(self, directory, kind, task_id)


def _resolve_task_commit(store, directory: Path, kind: str,
                         task_id: int) -> Optional[dict]:
    """Winner pick shared by both stores: smallest attempt whose record
    parses and checksums.  (Task records carry no blob bytes, so there is
    no part file to cross-check — blob visibility is the blob protocol's
    job.)"""
    directory = Path(directory)
    best: Optional[dict] = None
    best_attempt = ""
    for p in directory.glob(f"{kind}-{task_id}.*"):
        attempt = p.name.rpartition(".")[2]
        try:
            rec = decode_record(p.read_bytes())
        except OSError:
            continue
        if not rec or rec.get("kind") != kind or rec.get("task_id") != task_id:
            continue
        if best is None or attempt < best_attempt:
            best, best_attempt = rec, attempt
    return best


# ----------------------------------------------------------------- fault
class FaultStore:
    """Deterministic crash injection around any Store.

    ``hooks`` maps CrashPoint -> callable(ctx).  ctx is the logical blob
    name (puts) or "<kind>-<task_id>" (task commits); the hook raises
    (typically WorkerKilled) to simulate the worker dying at that exact
    instruction, or returns to let the call proceed — so a hook can target
    one phase ("mr-out-*") or one task and fire once.  Exception:
    TORN_COMMIT_RECORD hooks RETURN TRUTHY to inject — FaultStore then
    writes a half-length task commit record and raises WorkerKilled
    itself (the tear and the death are the same event).
    """

    def __init__(self, base: Store, hooks: dict[str, Callable]):
        self.base = base
        self.name = base.name
        self.hooks = dict(hooks)
        unknown = set(self.hooks) - set(CrashPoint.ALL)
        if unknown:
            raise ValueError(f"unknown crash points: {sorted(unknown)}")

    def _fire(self, point: str, ctx: str) -> None:
        hook = self.hooks.get(point)
        if hook:
            hook(ctx)

    # --- blob writes: stage, maybe die, publish -------------------------
    # (both stores expose the same two-phase _stage_put* / _publish_put
    # internals, so injection is store-agnostic)
    def put(self, path: Path, data: bytes) -> None:
        staged = self.base._stage_put(path, data)
        self._fire(CrashPoint.AFTER_TEMP_WRITE, Path(path).name)
        self.base._publish_put(path, staged)

    def put_from_file(self, path: Path, src: Path,
                      chunk_bytes: int = 1 << 20,
                      consume: bool = False) -> None:
        # consume ignored: fault injection needs the two-phase internals
        staged = self.base._stage_put_from_file(path, src, chunk_bytes)
        self._fire(CrashPoint.AFTER_TEMP_WRITE, Path(path).name)
        self.base._publish_put(path, staged)

    def put_from_stream(self, path: Path, stream, length: int,
                        chunk_bytes: int = 1 << 20) -> None:
        staged = self.base._stage_put_from_stream(path, stream, length, chunk_bytes)
        self._fire(CrashPoint.AFTER_TEMP_WRITE, Path(path).name)
        self.base._publish_put(path, staged)

    # --- task commit: the three protocol-interrupting points ------------
    def commit_task(self, directory: Path, kind: str, task_id: int,
                    attempt: str, payload: dict) -> None:
        ctx = f"{kind}-{task_id}"
        self._fire(CrashPoint.BEFORE_COMMIT_RECORD, ctx)
        torn = self.hooks.get(CrashPoint.TORN_COMMIT_RECORD)
        if torn is not None and torn(ctx):
            directory = Path(directory)
            directory.mkdir(parents=True, exist_ok=True)
            rec = encode_record(
                dict(payload, kind=kind, task_id=task_id, attempt=attempt)
            )
            with open(task_commit_path(directory, kind, task_id, attempt),
                      "wb") as f:
                f.write(rec[: len(rec) // 2])
                _fsync_file(f)
            from distributed_grep_tpu_torch.runtime.worker import WorkerKilled

            raise WorkerKilled(f"torn commit record for {ctx}")
        self.base.commit_task(directory, kind, task_id, attempt, payload)
        self._fire(CrashPoint.AFTER_COMMIT_BEFORE_ACK, ctx)

    # --- reads delegate: a dead worker reads nothing --------------------
    def get(self, path: Path) -> bytes:
        return self.base.get(path)

    def exists(self, path: Path) -> bool:
        return self.base.exists(path)

    def resolve(self, path: Path) -> Optional[Path]:
        return self.base.resolve(path)

    def list_committed(self, directory: Path, pattern: str) -> list[Path]:
        return self.base.list_committed(directory, pattern)

    def resolve_task_commit(self, directory: Path, kind: str,
                            task_id: int) -> Optional[dict]:
        return self.base.resolve_task_commit(directory, kind, task_id)


# --------------------------------------------------------------- factory
STORES = {"posix": PosixStore, "nonatomic": NonAtomicStore}


def make_store(name: str, durable: bool = True) -> Store:
    """Store factory for JobConfig.store ("posix" | "nonatomic").

    ``durable=False`` (JobConfig.durable — ephemeral temp work dirs only)
    reaches stores that support waiving fsync (PosixStore); stores whose
    COMMIT protocol depends on fsync ordering (NonAtomicStore's marker
    records) ignore it and stay fully durable."""
    try:
        cls = STORES[name]
    except KeyError:
        raise ValueError(
            f"unknown store {name!r} (choose from {sorted(STORES)})"
        ) from None
    store = cls()
    if not durable and isinstance(store, PosixStore):
        store.durable = False
    return store


def _unlink_quiet(path) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass
