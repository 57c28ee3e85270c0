"""Job configuration: the fields this package's runtime reads.

The reference's JobConfig (its utils/config.py) without the fields of
slices still to port: the span pipeline, follow mode, the service's
submit token and the device mesh.  Loadable from JSON with overrides
(``JobConfig.load``), which is how the ``run`` and ``coordinator``
subcommands and the HTTP workers' ``GET /config`` bootstrap read it.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

DEFAULT_APPLICATION = "distributed_grep_tpu_torch.apps.grep_cuda"

# Valid JobConfig.store names; runtime/store.py STORES holds the same
# two (a literal here, so a config does not import the runtime).
STORE_NAMES = frozenset({"posix", "nonatomic"})


@dataclass
class JobConfig:
    # --- what to run
    input_files: list[str] = field(default_factory=list)
    application: str = DEFAULT_APPLICATION
    app_options: dict[str, Any] = field(default_factory=dict)  # {"pattern": ...}
    n_reduce: int = 10

    # --- where data lives
    # Job state root (inputs/, intermediate/, out/, journal/, commits/,
    # spill/); "" = a fresh temp dir (in-process jobs only).
    work_dir: str = ""
    # Commit semantics of the work dir's blobs (runtime/store.py): "posix"
    # (temp + fsync + rename) or "nonatomic" (attempt-scoped part files and
    # self-checksummed commit records, no rename).
    store: str = "posix"
    # False waives the posix store's fsync before the rename (atomicity
    # stays): for work dirs nobody resumes.
    durable: bool = True

    # --- control plane
    coordinator_host: str = "127.0.0.1"
    coordinator_port: int = 1234
    rpc_timeout_s: float = 60.0  # the client's long-poll ceiling

    # --- cross-file batching (runtime/job.plan_map_splits): consecutive
    # input files below the engine's device_min_bytes are grouped into map
    # splits of at most this many packed bytes, each scanned as packed
    # windows (GrepEngine.scan_batch).  None/0: a map task a file.
    # DGREP_BATCH_BYTES overrides (0 disables): effective_batch_bytes.
    batch_bytes: int | None = None

    # --- fault tolerance
    # An IN_PROGRESS task silent for longer than this is re-issued.
    task_timeout_s: float = 10.0
    sweep_interval_s: float = 1.0  # the failure detector's period
    journal: bool = True  # the task-commit journal a restart replays
    job_id: str = ""  # the job's tag (the span log's, ROADMAP.md item 8)

    # --- worker resources
    # Each reduce sink holds this much before it spills a sorted run.
    reduce_memory_bytes: int = 128 << 20
    # Where reduce spills land.  None: in-process jobs use <work_dir>/spill,
    # HTTP workers the system temp dir (the coordinator's path may not
    # exist on their host).
    spill_dir: str | None = None

    def __post_init__(self) -> None:
        if self.n_reduce <= 0:
            raise ValueError(f"n_reduce must be positive, got {self.n_reduce}")
        if self.task_timeout_s <= 0:
            raise ValueError(
                f"task_timeout_s must be positive, got {self.task_timeout_s}"
            )
        if self.store not in STORE_NAMES:
            raise ValueError(
                f"store must be one of {sorted(STORE_NAMES)}, got {self.store!r}"
            )

    def effective_batch_bytes(self) -> int:
        """The batching window in force: DGREP_BATCH_BYTES when set (parsed
        as the engine parses it), else ``batch_bytes``; 0 is off."""
        from distributed_grep_tpu_torch.ops.layout import env_batch_bytes

        return env_batch_bytes(max(0, int(self.batch_bytes or 0)))

    def effective_app_options(self) -> dict:
        """``app_options`` with the batching window added (explicit options
        win), so the workers' engines pack with the planner's window."""
        out = dict(self.app_options)
        bb = self.effective_batch_bytes()
        if bb:
            out.setdefault("batch_bytes", bb)
        return out

    # --- (de)serialization
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "JobConfig":
        return cls(**json.loads(text))

    @classmethod
    def load(cls, path: str | Path, **overrides: Any) -> "JobConfig":
        cfg = cls.from_json(Path(path).read_text())
        return dataclasses.replace(cfg, **overrides) if overrides else cfg
