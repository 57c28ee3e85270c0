"""Transports: how a worker reaches the coordinator and the data plane
(the reference's runtime/transport.py).

Control and data are split behind one protocol with two implementations:
``LocalTransport`` (the in-process scheduler and a shared work dir: the
in-process job) and ``HttpTransport`` (runtime/http_transport.py:
long-poll control plane and an HTTP data plane, for worker processes
without a shared filesystem).
"""

from __future__ import annotations

from typing import Protocol

from distributed_grep_tpu_torch.runtime import rpc
from distributed_grep_tpu_torch.runtime.scheduler import Scheduler
from distributed_grep_tpu_torch.utils.io import WorkDir, resolve_input_path


class Transport(Protocol):
    # --- control plane
    def assign_task(self, args: rpc.AssignTaskArgs) -> rpc.AssignTaskReply: ...
    def map_finished(self, args: rpc.TaskFinishedArgs) -> rpc.TaskFinishedReply: ...
    def reduce_finished(self, args: rpc.TaskFinishedArgs) -> rpc.TaskFinishedReply: ...
    def reduce_next_file(self, args: rpc.ReduceNextFileArgs) -> rpc.ReduceNextFileReply: ...
    # Optional: heartbeat(args), an advisory stamp that never raises.

    # --- data plane
    def read_input(self, filename: str) -> bytes: ...
    def write_intermediate(self, name: str, data: bytes) -> None: ...
    def read_intermediate(self, name: str) -> bytes: ...
    def write_output(self, name: str, data: bytes) -> None: ...
    # Optional: read_input_path(filename) -> (path, is_temp), for apps that
    # read the split themselves; write_output_from_file(name, path), the
    # streaming commit of a reduce output; publish_task_commit(kind,
    # task_id, attempt, payload), the per-task commit record published
    # after a task's blobs are durable and before its finished RPC.


class LocalTransport:
    """Direct scheduler calls and a shared-filesystem data plane."""

    # data-plane calls resolve in microseconds: the worker skips its
    # liveness pump around them
    is_local = True

    def __init__(self, scheduler: Scheduler, workdir: WorkDir,
                 rpc_timeout_s: float = 30.0, store=None):
        self.scheduler = scheduler
        self.workdir = workdir
        self.rpc_timeout_s = rpc_timeout_s
        # a fault-injecting store wraps this worker's commits alone
        self.store = store if store is not None else workdir.store

    def assign_task(self, args: rpc.AssignTaskArgs) -> rpc.AssignTaskReply:
        return self.scheduler.assign_task(args, timeout=self.rpc_timeout_s)

    def map_finished(self, args: rpc.TaskFinishedArgs) -> rpc.TaskFinishedReply:
        return self.scheduler.map_finished(args)

    def reduce_finished(self, args: rpc.TaskFinishedArgs
                        ) -> rpc.TaskFinishedReply:
        return self.scheduler.reduce_finished(args)

    def reduce_next_file(self, args: rpc.ReduceNextFileArgs
                         ) -> rpc.ReduceNextFileReply:
        return self.scheduler.reduce_next_file(args,
                                               timeout=self.rpc_timeout_s)

    def heartbeat(self, args: rpc.HeartbeatArgs) -> None:
        self.scheduler.heartbeat(args.task_type, args.task_id,
                                 grace_s=args.grace_s,
                                 worker_id=args.worker_id)

    def read_input(self, filename: str) -> bytes:
        return resolve_input_path(filename, self.workdir).read_bytes()

    def read_input_path(self, filename: str):
        """(local path, is_temp): the original path, nothing to remove."""
        return resolve_input_path(filename, self.workdir), False

    def write_intermediate(self, name: str, data: bytes) -> None:
        self.store.put(self.workdir.root / "intermediate" / name, data)

    def read_intermediate(self, name: str) -> bytes:
        return self.store.get(self.workdir.root / "intermediate" / name)

    def write_output(self, name: str, data: bytes) -> None:
        self.store.put(self.workdir.root / "out" / name, data)

    def write_output_from_file(self, name: str, path: str) -> None:
        # the worker hands its spool over: a posix store renames it
        self.store.put_from_file(self.workdir.root / "out" / name, path,
                                 consume=True)

    def publish_task_commit(self, kind: str, task_id: int, attempt: str,
                            payload: dict) -> None:
        self.store.commit_task(self.workdir.commits_dir(), kind, task_id,
                               attempt, payload)
