"""Job configuration: the fields this package's runtime reads.

The reference's JobConfig (its utils/config.py).  Loadable from JSON with
overrides (``JobConfig.load``), which is how the ``run`` and
``coordinator`` subcommands and the HTTP workers' ``GET /config``
bootstrap read it.  A config the reference wrote loads too
(``from_json``): its ``backend`` and ``chunk_bytes``, which no reader
uses, are dropped; its ``mesh_shape``/``mesh_axes`` go to the
application's options (``effective_app_options``), where the CUDA grep
app names item 9.  ``to_json`` leaves out ``spans``, the mesh fields, the
follow fields and ``submit_token`` at their defaults (``follow_poll_s``
also while ``follow`` is off), as the reference's leaves out its follow
fields and its token, so the bootstrap of a job that uses none of them is
the same bytes as before they existed.
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

# Keys the reference's to_json writes and no reader of a job uses.
_DROPPED_KEYS = ("backend", "chunk_bytes")
# Fields to_json leaves out at these values.
_ELIDE_DEFAULTS = {"spans": False, "mesh_shape": (), "mesh_axes": ("data",),
                   "submit_token": ""}


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

    # --- observability (utils/spans.py)
    # The span pipeline: workers ship per-attempt spans on their heartbeat
    # and finished RPCs, and the coordinator persists them with its own
    # decisions as events.jsonl in the work dir (``trace-export`` renders
    # it).  Off: no RPC carries a new field and no file is written.
    # DGREP_SPANS=1 switches it on whatever this says.
    spans: bool = False
    job_id: str = ""  # the span tag; "" is the work dir's basename

    # --- standing query (runtime/follow.py): the service daemon scans the
    # inputs' appended lines as they grow, until the job is cancelled, and
    # keeps its cursors in the work dir's follow.jsonl; follow_poll_s is
    # the wake cadence (None: DEFAULT_FOLLOW_POLL_S; DGREP_FOLLOW_POLL_S
    # wins)
    follow: bool = False
    follow_poll_s: float | None = None

    # --- failover (runtime/lease.py): a token the client makes for a
    # submit to an address list; the daemon answers a second POST of the
    # same token with the first one's job, so a submit whose reply a
    # failover lost lands on one job
    submit_token: str = ""

    # --- device mesh (ROADMAP.md item 9): merged into the app options
    mesh_shape: tuple[int, ...] = ()
    mesh_axes: tuple[str, ...] = ("data",)

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
        self.mesh_shape = tuple(self.mesh_shape)
        self.mesh_axes = tuple(self.mesh_axes)

    def effective_job_id(self, work_dir: str | None = None) -> str:
        """The span pipeline's job tag: ``job_id``, else the basename of
        the work dir (``work_dir`` names the one in use when the config
        leaves it to the job)."""
        return self.job_id or Path(work_dir or self.work_dir).name

    def effective_batch_bytes(self) -> int:
        """The batching window in force: DGREP_BATCH_BYTES when set (parsed
        as the engine parses it), else ``batch_bytes``; 0 is off."""
        from distributed_grep_tpu_torch.ops.layout import env_batch_bytes

        return env_batch_bytes(max(0, int(self.batch_bytes or 0)))

    def effective_app_options(self) -> dict:
        """``app_options`` with the mesh fields (when a mesh is asked for)
        and the batching window added (explicit options win), so the
        workers' engines pack with the planner's window."""
        out = dict(self.app_options)
        if self.mesh_shape:
            out.setdefault("mesh_shape", list(self.mesh_shape))
            out.setdefault("mesh_axes", list(self.mesh_axes))
        bb = self.effective_batch_bytes()
        if bb:
            out.setdefault("batch_bytes", bb)
        return out

    # --- (de)serialization
    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        for k, default in _ELIDE_DEFAULTS.items():
            v = d[k]
            if (tuple(v) if isinstance(v, (list, tuple)) else v) == default:
                del d[k]
        if not d.get("follow"):
            d.pop("follow", None)
            d.pop("follow_poll_s", None)
        elif d.get("follow_poll_s") is None:
            d.pop("follow_poll_s", None)
        return json.dumps(d, indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "JobConfig":
        d = json.loads(text)
        for k in _DROPPED_KEYS:
            d.pop(k, None)
        return cls(**d)

    @classmethod
    def load(cls, path: str | Path, **overrides: Any) -> "JobConfig":
        cfg = cls.from_json(Path(path).read_text())
        return dataclasses.replace(cfg, **overrides) if overrides else cfg
