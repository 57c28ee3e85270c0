"""The work-dir layout, with atomic temp-file + rename commits.

    intermediate/   mr-<map_task>-<r> shuffle files
    out/            mr-out-<r> final outputs
    spill/          the reduce sinks' sorted runs (removed as each ends)

A re-executed task overwrites its files idempotently: every write lands
in a temp file in the same directory and is renamed over the target, so
readers see either nothing or one whole attempt.
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path


class WorkDir:
    def __init__(self, root: str | Path):
        self.root = Path(root)
        for sub in ("intermediate", "out"):
            (self.root / sub).mkdir(parents=True, exist_ok=True)

    def intermediate_path(self, name: str) -> Path:
        return self.root / "intermediate" / name

    def output_path(self, reduce_task: int) -> Path:
        return self.root / "out" / f"mr-out-{reduce_task}"

    @staticmethod
    def _atomic_write(path: Path, blocks) -> None:
        """Write the pieces ``blocks`` (bytes as they are, str encoded
        utf-8/surrogateescape) to a temp file, then rename it over
        ``path``."""
        fd, tmp = tempfile.mkstemp(prefix=f".{path.name}.", dir=path.parent)
        try:
            with os.fdopen(fd, "wb") as f:
                for b in blocks:
                    f.write(b if isinstance(b, bytes)
                            else b.encode("utf-8", "surrogateescape"))
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def write_intermediate(self, name: str, data: bytes) -> None:
        self._atomic_write(self.intermediate_path(name), [data])

    def read_intermediate(self, name: str) -> bytes:
        return self.intermediate_path(name).read_bytes()

    def write_output_blocks(self, reduce_task: int, blocks) -> None:
        """Commit ``mr-out-<reduce_task>`` streamed from its pieces."""
        self._atomic_write(self.output_path(reduce_task), blocks)

    def spill_dir(self) -> Path:
        d = self.root / "spill"
        d.mkdir(exist_ok=True)
        return d

    def clear(self) -> None:
        """Remove all job state (fresh-job reset of a reused work dir)."""
        for sub in ("intermediate", "out"):
            for p in (self.root / sub).iterdir():
                if p.is_file():
                    p.unlink()

    def list_outputs(self) -> list[Path]:
        """The committed mr-out-* files, sorted by reduce task number."""
        outs = [p for p in (self.root / "out").iterdir()
                if p.name.startswith("mr-out-") and p.name[7:].isdigit()]
        return sorted(outs, key=lambda p: int(p.name[7:]))
