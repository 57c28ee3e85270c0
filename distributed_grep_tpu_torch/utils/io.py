"""IO helpers: chunked reads and the work-dir layout.

Every blob a job commits goes through the work dir's Store
(runtime/store.py): ``PosixStore`` writes a temp file, fsyncs it and
renames it over the target, so readers see either nothing or one whole
attempt and a re-executed task overwrites idempotently;
``NonAtomicStore`` emulates an object store (no rename).
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator


def read_chunks(path: str | Path, chunk_bytes: int,
                overlap: int = 0) -> Iterator[tuple[int, bytes]]:
    """Stream a file as (offset, chunk) pairs, each chunk repeating the
    last ``overlap`` bytes of the one before it (a halo of at least the
    longest match)."""
    if chunk_bytes <= 0:
        raise ValueError("chunk_bytes must be positive")
    if overlap >= chunk_bytes:
        raise ValueError("overlap must be smaller than chunk_bytes")
    with open(path, "rb") as f:
        offset = 0
        carry = b""
        while True:
            block = f.read(chunk_bytes - len(carry))
            if not block:
                # the carried halo was yielded with the chunk before it:
                # never emit a chunk of halo alone
                return
            chunk = carry + block
            yield offset, chunk
            if len(chunk) < chunk_bytes:
                return
            carry = chunk[-overlap:] if overlap else b""
            offset += len(chunk) - len(carry)


def resolve_input_path(filename: str, workdir: "WorkDir") -> Path:
    """An input split's path, as every data plane resolves it: absolute
    paths and existing paths relative to the working directory as they
    are; other names under the work dir's ``inputs/``."""
    p = Path(filename)
    if not p.is_absolute() and not p.exists():
        p = workdir.root / "inputs" / p
    return p


class WorkDir:
    """The layout of one job under a root.

    inputs/         input splits named by bare names
    intermediate/   mr-<map_task>-<r> shuffle files
    out/            mr-out-<r> final outputs
    journal/        the coordinator's task-commit journal
    commits/        per-task commit records (runtime/store.py)
    spill/          the reduce sinks' sorted runs (removed as each ends)

    ``store`` gives the commit semantics of intermediate/ and out/ (a
    ``PosixStore`` by default).  Readers go through the store
    (``list_outputs`` does): on a ``NonAtomicStore`` the directories hold
    attempt files, and only the store knows which attempt won.
    """

    def __init__(self, root: str | Path, store=None):
        if store is None:
            from distributed_grep_tpu_torch.runtime.store import PosixStore

            store = PosixStore()
        self.store = store
        self.root = Path(root)
        for sub in ("inputs", "intermediate", "out", "journal", "commits"):
            (self.root / sub).mkdir(parents=True, exist_ok=True)

    def intermediate_path(self, map_task: int, reduce_part: int) -> Path:
        return self.root / "intermediate" / f"mr-{map_task}-{reduce_part}"

    def journal_path(self) -> Path:
        return self.root / "journal" / "tasks.jsonl"

    def commits_dir(self) -> Path:
        return self.root / "commits"

    def resolve_task_commit(self, kind: str, task_id: int):
        """The winning task commit record (a ``{"parts": ...}`` payload),
        or None: the scheduler's unit of truth for completed work."""
        return self.store.resolve_task_commit(self.commits_dir(), kind,
                                              task_id)

    def clear(self) -> None:
        """Remove all job state (a fresh job in a reused work dir)."""
        for sub in ("inputs", "intermediate", "out", "journal", "commits"):
            for p in (self.root / sub).iterdir():
                if p.is_file():
                    p.unlink()

    def list_outputs(self) -> list[Path]:
        """The committed mr-out-* files, sorted by reduce task number: on
        a PosixStore the files themselves, on a NonAtomicStore each
        one's winning attempt."""
        outs = self.store.list_committed(self.root / "out", "mr-out-*")

        def number(p: Path) -> int:
            name = p.name[len("mr-out-"):]
            digits = name.split(".", 1)[0]
            return int(digits) if digits.isdigit() else -1

        return sorted(outs, key=number)
