"""The mesh's table-DFA step (the lane half of the reference's
parallel/sharded_scan.py ``sharded_grep_step``).

Each mesh entry holds a contiguous block of the segment's stripes and
runs K1 (csrc/dfa.cu) on it, with the per-lane exit states; the results
combine as the reference's collectives do:

* the words stay in lane order, as one device's;
* the total is the matched-position count summed over the entries (the
  reference's ``psum``);
* each entry receives the exit state of the left neighbour's last lane,
  the ring the reference's ``ppermute`` rides over the linearized entry
  order (on one process, a handoff between tensors).

Not here yet (ROADMAP item 9, second half): ``stack_bank_tables`` and
``sharded_pattern_set_step``, the DFA banks over a pattern axis.
"""

from __future__ import annotations

import torch

from distributed_grep_tpu_torch.models.dfa import DfaTable
from distributed_grep_tpu_torch.ops import dfa_scan
from distributed_grep_tpu_torch.ops.layout import STRIPES
from distributed_grep_tpu_torch.parallel.mesh import Mesh
from distributed_grep_tpu_torch.parallel.sharded_kernels import (
    prepare_tiles,
)


def popcount(words: torch.Tensor) -> torch.Tensor:
    """The set bits of uint32 ``words``, summed (int64, on their
    device)."""
    x = words.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).sum()


def sharded_grep_step(data, table: DfaTable, mesh: Mesh, axis="data"):
    """K1 over the mesh; returns (words, total, exit_states,
    neighbor_states): the (chunk // 32, lanes) uint32 words of
    ``dfa_scan_words``, the matched-position count summed over the
    entries, each lane's state after its stripe's last byte (int32
    (lanes,)), and for each entry the left neighbour's last exit state
    (int32 (entries,)); all on the first entry's device.  ``axis`` is one
    mesh axis or a tuple (lanes shard over the product).  ``data``: the
    (lanes, chunk) stripes; lanes must split into whole lane tiles."""
    entries = prepare_tiles(data, mesh, axis, (STRIPES,))
    words, exits, counts = [], [], []
    for v in entries:
        w, x = dfa_scan.dfa_scan_words(v[STRIPES], table, with_exits=True)
        words.append(w)
        exits.append(x)
        counts.append(popcount(w))
    home = words[0].device
    total = sum(c.to(home) for c in counts)
    right_edge = torch.stack([x[-1].to(home) for x in exits])
    neighbor = torch.roll(right_edge, 1)
    return (torch.cat([w.to(home) for w in words], dim=1), total,
            torch.cat([x.to(home) for x in exits]), neighbor)
