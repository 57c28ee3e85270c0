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

    def __post_init__(self) -> None:
        if self.n_reduce <= 0:
            raise ValueError(f"n_reduce must be positive, got {self.n_reduce}")
        if self.task_timeout_s <= 0:
            raise ValueError(
                f"task_timeout_s must be positive, got {self.task_timeout_s}"
            )
