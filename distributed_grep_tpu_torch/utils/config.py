"""Job configuration: the fields this package's runtime reads."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

DEFAULT_APPLICATION = "distributed_grep_tpu_torch.apps.grep_cuda"


@dataclass
class JobConfig:
    input_files: list[str] = field(default_factory=list)
    application: str = DEFAULT_APPLICATION
    app_options: dict[str, Any] = field(default_factory=dict)  # {"pattern": ...}
    n_reduce: int = 10
    # An IN_PROGRESS task silent for longer than this is re-issued.
    task_timeout_s: float = 10.0
    # Job state root (intermediate/, out/, spill/); "" = a fresh temp dir.
    work_dir: str = ""
    # Cross-file batching (runtime/job.plan_map_splits): consecutive input
    # files below the engine's device_min_bytes are grouped into map
    # splits of at most this many packed bytes, each scanned as packed
    # windows (GrepEngine.scan_batch).  None/0: a map task a file.
    # DGREP_BATCH_BYTES overrides (0 disables): effective_batch_bytes.
    batch_bytes: int | None = None

    def __post_init__(self) -> None:
        if self.n_reduce <= 0:
            raise ValueError(f"n_reduce must be positive, got {self.n_reduce}")
        if self.task_timeout_s <= 0:
            raise ValueError(
                f"task_timeout_s must be positive, got {self.task_timeout_s}"
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
