"""Device meshes of one host's cards (the reference's parallel/mesh.py).

A mesh is an array of ``torch.device`` entries with named axes, at most
two in practice:

* ``data``: independent document shards;
* ``seq``: stripes within one document, for a document larger than one
  card.

Both split a segment's lanes the same way; they differ only in which
entries hold which block.  Lanes split into contiguous blocks over the
product of the named axes, in the reference's axes-major order, so a
block boundary is an ordinary stripe boundary and the existing stitches
see the same stripe starts as on one device.

A mesh may name one card more than once (four entries of ``cuda:0`` on
a host with one card, as the reference's CPU tests force a host device
count): each entry then runs its block on that card in turn.  ``cards``
counts the distinct devices beside the entries.
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
    of ``axis_names``."""

    devices: np.ndarray
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def cards(self) -> int:
        """The distinct devices among the entries."""
        return len({str(d) for d in self.devices.flat})


def make_mesh(shape: tuple[int, ...] = (), axes: tuple[str, ...] = ("data",),
              devices: list | None = None) -> Mesh:
    """A mesh of ``shape`` over ``axes``; shape () puts every device on the
    first axis.  ``devices`` None is every local card (raises without
    one); entries may repeat a device.  A shape that needs more entries
    than the devices given raises ValueError, with the reference's
    words."""
    devs = ([resolve_device(d) for d in devices] if devices is not None
            else local_devices("cuda"))
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
    return Mesh(arr.reshape(shape), axes)


def axes_tuple(axis) -> tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


@dataclass(frozen=True)
class LaneSharding:
    """The split of a (lanes, chunk) segment into contiguous row blocks,
    one an entry of ``devices`` (axes-major over the named axes)."""

    devices: tuple[torch.device, ...]

    @property
    def n(self) -> int:
        return len(self.devices)

    def bounds(self, lanes: int) -> list[tuple[int, int]]:
        """Each block's [start, end) rows; ``lanes`` must divide evenly."""
        if lanes % self.n:
            raise ValueError(f"lanes={lanes} must divide {self.n} mesh "
                             f"entries")
        step = lanes // self.n
        return [(i * step, (i + 1) * step) for i in range(self.n)]


def lane_sharding(mesh: Mesh, axis="data") -> LaneSharding:
    """Lanes split over the product of ``axis`` (one name or a tuple), in
    that order, axes-major.  A block is replicated over the mesh's other
    axes in the reference; here the entry at index 0 of each other axis
    runs it, once."""
    axes = axes_tuple(axis)
    unknown = [a for a in axes if a not in mesh.axis_names]
    if not axes or unknown:
        raise ValueError(f"mesh_axis {axis!r} not in mesh axes "
                         f"{sorted(mesh.axis_names)}")
    order = [mesh.axis_names.index(a) for a in axes]
    rest = [i for i in range(len(mesh.axis_names)) if i not in order]
    arr = np.transpose(mesh.devices, order + rest)
    arr = arr[(Ellipsis,) + (0,) * len(rest)] if rest else arr
    return LaneSharding(tuple(arr.reshape(-1)))
