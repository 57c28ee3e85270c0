"""Several processes on one mesh (the reference's parallel/multihost.py,
on ``torch.distributed``).

Topology, as the reference's: the control plane is the coordinator's
HTTP protocol (runtime/http_coordinator.py), one worker process a host
asking for splits.  For a job that wants one mesh spanning processes,
``init_distributed`` joins this process to a process group; then
``parallel.mesh.make_mesh`` builds the global mesh (every rank's local
cards, in rank order, each entry tagged with its rank), and every rank
runs the same scan over the same segment (SPMD): each materializes only
its own entries' blocks (``sharded_kernels.prepare_tiles``, the
reference's ``_put_spec``), launches their kernels, and the blocks come
back to every rank through ``all_gather_entries`` and the counts through
``all_reduce_sum``.  Without a group everything here is the one-process
case: rank 0 of 1, and no collective runs.

The group's backend is ``nccl`` on the card and ``gloo`` where the caller
asks for the CPU, or whatever ``backend`` names; nothing swaps backends
after a failure.  Under ``gloo`` the collectives run on host tensors, so
blocks on the card are staged through host memory.  The group has a
finite timeout: a rank that died fails the others' next collective
instead of hanging them.

Differences from the reference (ROADMAP.md D15): torchrun's variables
``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` stand where
the reference reads ``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``
and ``JAX_PROCESS_ID``; and torch's tcp init cannot infer the world size
or the rank, so a partial spec raises ValueError naming what is missing
where the reference passes what it has and jax infers the rest.
"""

from __future__ import annotations

import logging
import math
import os
from datetime import timedelta

import torch

log = logging.getLogger("distributed_grep_tpu_torch.multihost")

# The process group's timeout: a collective waiting on a rank that died
# fails after this long at most (gloo often fails at once, on the closed
# connection).
DEFAULT_TIMEOUT_S = 120.0


def _env_address() -> str | None:
    host = os.environ.get("MASTER_ADDR")
    if not host:
        return None
    port = os.environ.get("MASTER_PORT")
    return f"{host}:{port}" if port else host


def _dist():
    import torch.distributed as dist

    return dist


def group_on() -> bool:
    """A process group is initialised in this process."""
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None,
                     device: str | torch.device = "cuda",
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group from the arguments or torchrun's variables
    (``MASTER_ADDR``:``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); explicit
    arguments win over the environment.  Returns False with no address
    (one process: the common case), True once the group is up.  A partial
    spec raises ValueError naming what is missing (D15).  ``backend``
    None is ``nccl`` for a ``device`` on the card and ``gloo`` for the
    CPU."""
    addr = coordinator_address or _env_address()
    if addr is None:
        return False
    n = (num_processes if num_processes is not None
         else os.environ.get("WORLD_SIZE"))
    pid = process_id if process_id is not None else os.environ.get("RANK")
    host, _, port = addr.rpartition(":")
    missing = [name for name, v in (("the port (MASTER_PORT)",
                                     port if host else None),
                                    ("num_processes (WORLD_SIZE)", n),
                                    ("process_id (RANK)", pid)) if v is None]
    if missing:
        raise ValueError(
            f"torch.distributed's tcp init needs the address, the world "
            f"size and the rank; {addr!r} leaves out {', '.join(missing)}")
    if backend is None:
        backend = "gloo" if torch.device(device).type == "cpu" else "nccl"
    dist = _dist()
    dist.init_process_group(backend, init_method=f"tcp://{host}:{port}",
                            world_size=int(n), rank=int(pid),
                            timeout=timedelta(seconds=float(timeout_s)))
    log.info("torch.distributed initialized: process %d/%d over %s",
             dist.get_rank(), dist.get_world_size(), backend)
    return True


def process_index() -> int:
    """This process's rank; 0 without a group."""
    return _dist().get_rank() if group_on() else 0


def process_count() -> int:
    """The group's world size; 1 without a group."""
    return _dist().get_world_size() if group_on() else 1


def local_mesh_devices(kind: str = "cuda") -> list[torch.device]:
    """The devices this process puts in its share of a mesh: every local
    card (raises without one), or the host on "cpu"."""
    from distributed_grep_tpu_torch.parallel.mesh import local_devices

    return local_devices(kind)


def _wire_device() -> torch.device:
    """Where a collective's tensors live: the host under gloo, this
    rank's card under nccl."""
    if _dist().get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather_object(obj) -> list:
    """Every rank's ``obj``, in rank order (``[obj]`` without a group)."""
    if not group_on():
        return [obj]
    out = [None] * process_count()
    _dist().all_gather_object(out, obj)
    return out


def all_reduce_sum(value: torch.Tensor, home: torch.device) -> torch.Tensor:
    """The sum of every rank's int64 ``value`` (a 0-d tensor), on
    ``home``; ``value`` itself without a group."""
    if not group_on():
        return value.to(home)
    t = value.to(_wire_device(), dtype=torch.int64).reshape(1)
    _dist().all_reduce(t)
    return t[0].to(home)


def all_gather_entries(local: dict[int, torch.Tensor], owners,
                       home) -> list[torch.Tensor]:
    """Every mesh entry's tensor on every rank, in entry order, on
    ``home``.  ``local``: entry -> tensor for the entries this rank owns;
    ``owners``: each entry's rank (the same list on every rank).  All
    entries' tensors have one shape and dtype.  One ``all_gather`` of each
    rank's entries packed as bytes (a rank owning fewer is padded; where a
    rank owns none, the shape and dtype go round first); without a group,
    ``local`` in order."""
    n = len(owners)
    if not group_on():
        return [local[e].to(home) for e in range(n)]
    rank, world = process_index(), process_count()
    mine = [e for e in range(n) if owners[e] == rank]
    counts = [sum(1 for o in owners if o == r) for r in range(world)]
    if min(counts) == 0:
        metas = all_gather_object(
            (tuple(local[mine[0]].shape), str(local[mine[0]].dtype))
            if mine else None)
        shape, name = next(m for m in metas if m is not None)
        dtype = getattr(torch, name.removeprefix("torch."))
    else:
        shape, dtype = tuple(local[mine[0]].shape), local[mine[0]].dtype
    wire = _wire_device()
    nbytes = torch.empty((), dtype=dtype).element_size() * math.prod(shape)
    buf = torch.zeros((max(counts), nbytes), dtype=torch.uint8, device=wire)
    for k, e in enumerate(mine):
        buf[k] = local[e].contiguous().reshape(-1).view(torch.uint8).to(wire)
    out = [torch.empty_like(buf) for _ in range(world)]
    _dist().all_gather(out, buf)
    slot, seen = {}, [0] * world
    for e in range(n):
        slot[e] = seen[owners[e]]
        seen[owners[e]] += 1
    return [out[owners[e]][slot[e]].view(dtype).reshape(shape).to(home)
            for e in range(n)]
