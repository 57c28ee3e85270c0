"""Device meshes of cards, on one host or over several processes (the
reference's parallel/mesh.py).

A mesh is an array of ``torch.device`` entries with named axes, at most
two in practice:

* ``data``: independent document shards;
* ``seq``: stripes within one document, for a document larger than one
  card.

Both split a segment's lanes the same way; they differ only in which
entries hold which block.  Lanes split into contiguous blocks over the
product of the named axes, in the reference's axes-major order, so a
block boundary is an ordinary stripe boundary and the existing stitches
see the same stripe starts as on one device.  With a pattern axis
(``pattern_sharding``), each (data block, pattern index) entry pairs one
lane block of the data axes with one contiguous run of a set's banks.

A mesh may name one card more than once (four entries of ``cuda:0`` on
a host with one card, as the reference's CPU tests force a host device
count): each entry then runs its block on that card in turn.  ``cards``
counts the distinct devices beside the entries.

Each entry carries the rank of the process that owns it
(parallel/multihost.py); in one process every rank is 0.  Under an
initialised process group, ``make_mesh`` builds the global mesh: every
rank's local entries, in rank order (the reference's global
``jax.devices()``), so every rank holds the same mesh.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from distributed_grep_tpu_torch.utils.device import resolve_device


def local_devices(kind: str = "cuda") -> list[torch.device]:
    """Every local device of ``kind``: each card on "cuda" (raises naming
    the device when there is none, as ``resolve_device`` does), the one
    host device on "cpu"."""
    if torch.device(kind).type == "cpu":
        return [torch.device("cpu")]
    resolve_device(kind)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def resolve_devices(devices, device="cuda") -> list[torch.device]:
    """The engine's device list: None is ``device`` alone, "all" every
    local device of its kind, a list each entry (an int i is card i, or
    the host on "cpu"; a device may repeat).  Raises naming the device
    where CUDA is asked for and absent, and for an empty list."""
    kind = torch.device(device).type
    if devices is None:
        return [resolve_device(device)]
    if isinstance(devices, str):
        if devices != "all":
            raise ValueError(f"devices must be None, 'all' or a list, got "
                             f"{devices!r}")
        return local_devices(kind)
    out = []
    for d in devices:
        if isinstance(d, int) and not isinstance(d, bool):
            d = "cpu" if kind == "cpu" else torch.device("cuda", d)
        out.append(resolve_device(d))
    if not out:
        raise ValueError("devices is an empty list")
    return out


@dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``: an object array of ``torch.device``, one axis a name
    of ``axis_names``; ``ranks``: an int array of the same shape, the
    process that owns each entry (None: all 0, one process)."""

    devices: np.ndarray
    axis_names: tuple[str, ...]
    ranks: np.ndarray | None = None

    def __post_init__(self):
        if self.ranks is None:
            object.__setattr__(self, "ranks",
                               np.zeros(self.devices.shape, dtype=np.int64))
        if self.ranks.shape != self.devices.shape:
            raise ValueError(f"ranks {self.ranks.shape} do not match "
                             f"devices {self.devices.shape}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def cards(self) -> int:
        """The distinct devices among the entries (a device of each rank
        counts apart)."""
        return len({(int(r), str(d))
                    for r, d in zip(self.ranks.flat, self.devices.flat)})

    @property
    def n_ranks(self) -> int:
        """The distinct processes owning entries."""
        return len(set(int(r) for r in self.ranks.flat))


def _gathered(local: list) -> tuple[list[torch.device], list[int]]:
    """Every rank's ``local`` entries in rank order, with their ranks (a
    collective: every rank of the group calls it)."""
    from distributed_grep_tpu_torch.parallel import multihost

    lists = multihost.all_gather_object([str(d) for d in local])
    devs, ranks = [], []
    for rank, names in enumerate(lists):
        devs += [torch.device(n) for n in names]
        ranks += [rank] * len(names)
    return devs, ranks


def make_mesh(shape: tuple[int, ...] = (), axes: tuple[str, ...] = ("data",),
              devices: list | None = None) -> Mesh:
    """A mesh of ``shape`` over ``axes``; shape () puts every entry on the
    first axis.  ``devices`` None is every local card (raises without
    one); entries may repeat a device.  Under an initialised process
    group, ``devices`` (or every local card) names this rank's entries,
    and the mesh holds every rank's, in rank order: a collective, so every
    rank calls it.  A shape that needs more entries than there are raises
    ValueError, with the reference's words."""
    from distributed_grep_tpu_torch.parallel import multihost

    local = ([resolve_device(d) for d in devices] if devices is not None
             else local_devices("cuda"))
    if multihost.process_count() > 1:
        devs, ranks = _gathered(local)
    else:
        devs, ranks = local, [0] * len(local)
    axes = tuple(axes)
    if not shape:
        shape = (len(devs),) + (1,) * (len(axes) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} does not match axes {axes}")
    n = int(np.prod(shape))
    if n > len(devs):
        raise ValueError(f"mesh shape {shape} needs {n} devices, have "
                         f"{len(devs)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devs[:n]
    return Mesh(arr.reshape(shape), axes,
                np.asarray(ranks[:n], dtype=np.int64).reshape(shape))


def axes_tuple(axis) -> tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


@dataclass(frozen=True)
class LaneSharding:
    """The split of a (lanes, chunk) segment into ``n`` contiguous row
    blocks over the data axes, and of a set's banks into ``n_pat`` runs:
    entry ``i * n_pat + j`` (``devices``, ``ranks``) holds block i and
    bank run j.  Without a pattern axis ``n_pat`` is 1 and entry i holds
    block i (axes-major over the named axes)."""

    devices: tuple[torch.device, ...]
    ranks: tuple[int, ...] = ()
    n_pat: int = 1

    def __post_init__(self):
        if not self.ranks:
            object.__setattr__(self, "ranks", (0,) * len(self.devices))

    @property
    def n(self) -> int:
        """The lane blocks."""
        return len(self.devices) // self.n_pat

    def block_of(self, e: int) -> int:
        return e // self.n_pat

    def part_of(self, e: int) -> int:
        return e % self.n_pat

    def bounds(self, lanes: int) -> list[tuple[int, int]]:
        """Each block's [start, end) rows; ``lanes`` must divide evenly."""
        if lanes % self.n:
            raise ValueError(f"lanes={lanes} must divide {self.n} mesh "
                             f"entries")
        step = lanes // self.n
        return [(i * step, (i + 1) * step) for i in range(self.n)]

    def lanes_only(self) -> "LaneSharding":
        """Each block once, at bank run 0: the lane sharding over the data
        axes alone (a lane-sharded kernel beside the pattern axis)."""
        keep = range(0, len(self.devices), self.n_pat)
        return LaneSharding(tuple(self.devices[e] for e in keep),
                            tuple(self.ranks[e] for e in keep))


def _check_axes(mesh: Mesh, axes: tuple[str, ...], what: str, given):
    unknown = [a for a in axes if a not in mesh.axis_names]
    if not axes or unknown:
        raise ValueError(f"{what} {given!r} not in mesh axes "
                         f"{sorted(mesh.axis_names)}")


def _arranged(mesh: Mesh, lead: list[str]):
    """The mesh's devices and ranks with the ``lead`` axes first, in that
    order, and index 0 of every other axis."""
    order = [mesh.axis_names.index(a) for a in lead]
    rest = [i for i in range(len(mesh.axis_names)) if i not in order]
    out = []
    for arr in (mesh.devices, mesh.ranks):
        arr = np.transpose(arr, order + rest)
        out.append(arr[(Ellipsis,) + (0,) * len(rest)] if rest else arr)
    return out


def lane_sharding(mesh: Mesh, axis="data") -> LaneSharding:
    """Lanes split over the product of ``axis`` (one name or a tuple), in
    that order, axes-major.  A block is replicated over the mesh's other
    axes in the reference; here the entry at index 0 of each other axis
    runs it, once."""
    axes = axes_tuple(axis)
    _check_axes(mesh, axes, "mesh_axis", axis)
    devs, ranks = _arranged(mesh, list(axes))
    return LaneSharding(tuple(devs.reshape(-1)),
                        tuple(int(r) for r in ranks.reshape(-1)))


def pattern_sharding(mesh: Mesh, data_axis="data",
                     pattern_axis="seq") -> LaneSharding:
    """Lanes split over the product of ``data_axis`` as ``lane_sharding``
    splits them, and a set's banks into contiguous runs over
    ``pattern_axis``: every entry along the pattern axis runs (the
    reference's ``P(None, data_axis)`` data beside ``P(pattern_axis)``
    tables), at index 0 of any other axis."""
    axes = axes_tuple(data_axis)
    pat = axes_tuple(pattern_axis)
    _check_axes(mesh, axes, "mesh_axis", data_axis)
    _check_axes(mesh, pat, "pattern_axis", pattern_axis)
    if set(axes) & set(pat):
        raise ValueError(f"pattern_axis {pattern_axis!r} must name a mesh "
                         f"axis outside mesh_axis {axes}")
    devs, ranks = _arranged(mesh, list(axes) + list(pat))
    n_pat = int(np.prod([mesh.shape[a] for a in pat]))
    return LaneSharding(tuple(devs.reshape(-1)),
                        tuple(int(r) for r in ranks.reshape(-1)), n_pat)


def bank_runs(n_banks: int, n_shards: int) -> list[range]:
    """The banks each of ``n_shards`` pattern indices holds: the bank
    count padded to a multiple of ``n_shards`` and cut into equal
    contiguous runs (the reference's ``stack_bank_tables`` and
    ``P(pattern_axis)``), the padding left out, so a count that does not
    divide leaves the last runs shorter or empty."""
    per = -(-n_banks // n_shards) if n_banks else 0
    return [range(min(j * per, n_banks), min((j + 1) * per, n_banks))
            for j in range(n_shards)]


def home_device(mesh: Mesh, sharding: LaneSharding | None = None,
                rank: int = 0) -> torch.device:
    """Where ``rank``'s results land: its first entry of ``sharding``, else
    its first entry of the mesh; raises ValueError when it owns none."""
    for devs, ranks in ((sharding.devices, sharding.ranks) if sharding
                        else ((), ()),
                        (tuple(mesh.devices.flat), tuple(mesh.ranks.flat))):
        for d, r in zip(devs, ranks):
            if int(r) == rank:
                return d
    raise ValueError(f"rank {rank} owns no entry of the mesh")
