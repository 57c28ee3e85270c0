"""The ported kernels on a mesh of cards, lanes sharded, and FDR's banks
over a pattern axis (the reference's parallel/sharded_kernels.py).

The reference runs its Pallas kernels under ``shard_map``: a segment's
lanes shard over the mesh axis, each device runs the unchanged
single-chip kernel on its lane block, and the candidate count is a
``psum``.  Here each mesh entry's block of (lanes, chunk) stripes, a
contiguous run of rows, is copied to its device (``prepare_tiles``), the
ported kernel is launched there on that block (the NFA and FDR kernels
on the block's on-card transpose), and the blocks' words are put back in
lane order: they equal the single-device words bit for bit, since every
kernel's word of a lane depends on that lane's stripe alone.  The count
is the sum of each entry's nonzero-word count (the reference's ``psum``
of ``count_nonzero``).

On a mesh spanning processes (parallel/multihost.py) every rank calls
the same function on the same segment: ``prepare_tiles`` copies only the
blocks of the entries this rank owns (``local_blocks``, the reference's
``_local_shard_index_map`` and ``_put_spec``), each rank launches its
entries' kernels, and ``sharded_words`` gathers the blocks to every rank
in lane order and sums the counts over the ranks, so every rank returns
what one process would.

The pattern axis (``sharded_fdr_pattern_step``): same-plan FDR banks cut
into contiguous runs over ``pattern_axis`` while lanes shard over the
data axes; entry (i, j) runs run j's banks on lane block i, and the
words are OR'd across the pattern axis (never summed: colliding bits
must stay one bit), so they equal one device's OR of every bank.

Every function returns ``(words, total)``: the (chunk // 32, lanes)
words (SWAR's (chunk // 32, lanes // 4)) and the total as an int64
tensor, on this rank's first entry's device.  A kernel that fails on one
entry fails the call, and on a rank fails every rank's collective within
the group's timeout: nothing is retried on another entry, rank or the
host.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from distributed_grep_tpu_torch.ops import (
    approx_scan,
    cuda_scan,
    fdr_scan,
    nfa_scan,
    pairset_scan,
    swar_scan,
)
from distributed_grep_tpu_torch.ops.fdr_scan import or_into
from distributed_grep_tpu_torch.ops.layout import COLUMNS, STRIPES
from distributed_grep_tpu_torch.parallel import multihost
from distributed_grep_tpu_torch.parallel.mesh import (
    LaneSharding,
    Mesh,
    axes_tuple,
    bank_runs,
    home_device,
    lane_sharding,
    pattern_sharding,
)

# The stripe kernels' lane tile (a warp's 32 stripes; csrc/*.cu take any
# multiple of 32) and the packed SWAR kernel's (4 stripes an element, 32
# elements a warp: ops/device_scan.SWAR_LANE_MULTIPLE).
LANE_TILE = 32
SWAR_LANE_TILE = 128


def mesh_lane_multiple(mesh: Mesh, axis="data", swar: bool = False) -> int:
    """Lanes must split into whole lane tiles per entry: the lane blocks
    times the kernels' lane tile."""
    return lane_sharding(mesh, axis).n * (SWAR_LANE_TILE if swar
                                          else LANE_TILE)


def _stream_ctx(stream):
    return (torch.cuda.stream(stream) if stream is not None
            else contextlib.nullcontext())


class Tiles(list):
    """``prepare_tiles``' result: one dict an entry of ``sharding``,
    layout -> the entry's block on its device, or None for an entry
    another rank owns; ``home`` is where this rank's results land."""

    def __init__(self, views, sharding: LaneSharding, rank: int,
                 home: torch.device):
        super().__init__(views)
        self.sharding = sharding
        self.rank = rank
        self.home = home

    def local_devices(self) -> list[torch.device]:
        """The distinct devices of this rank's entries."""
        return list({str(d): d for d, r in zip(self.sharding.devices,
                                              self.sharding.ranks)
                     if r == self.rank}.values())

    def lanes_only(self) -> "Tiles":
        """The entries at bank run 0: each lane block once, as a lane
        sharding over the data axes alone holds them."""
        n_pat = self.sharding.n_pat
        return Tiles(self[::n_pat], self.sharding.lanes_only(), self.rank,
                     self.home)


def local_blocks(sharding: LaneSharding, lanes: int,
                 rank: int) -> dict[int, tuple[int, int]]:
    """{entry: its [start, end) rows} for exactly the entries ``rank``
    owns: the blocks that rank materializes (the reference's
    ``_local_shard_index_map``).  Pure over the sharding, so a two-rank
    topology can be checked in one process."""
    bounds = sharding.bounds(lanes)
    return {e: bounds[sharding.block_of(e)]
            for e, r in enumerate(sharding.ranks) if r == rank}


def prepare_tiles(stripes, mesh: Mesh, axis="data", layouts=(STRIPES,),
                  stream_for=None, swar: bool = False,
                  pattern_axis=None) -> Tiles:
    """(lanes, chunk) stripes (a tensor on any device, or a numpy array)
    -> ``Tiles``: one dict an entry, layout -> its block on its device, in
    the layouts asked for: STRIPES the rows themselves, COLUMNS their
    transpose, made on the entry's device.  With ``pattern_axis`` the
    entries are ``pattern_sharding``'s: each lane block of ``axis`` on
    every entry along the pattern axis (entries sharing a device share
    the copy).  Only this rank's entries are materialized.
    ``stream_for(device)`` names the stream each entry's copy and
    transpose go on (None: the current one).  Raises ValueError where the
    lanes do not split into whole tiles, as the reference's layout
    check."""
    if isinstance(stripes, np.ndarray):
        stripes = torch.from_numpy(stripes)
    lanes, chunk = stripes.shape
    mult = mesh_lane_multiple(mesh, axis, swar)
    if lanes % mult or chunk % 32:
        raise ValueError(
            f"sharded layout needs lanes%{mult}==0 (got {lanes}), "
            f"chunk%32==0 (got {chunk})")
    sharding = (pattern_sharding(mesh, axis, pattern_axis)
                if pattern_axis is not None else lane_sharding(mesh, axis))
    rank = multihost.process_index()
    mine = local_blocks(sharding, lanes, rank)
    made: dict = {}
    views: list = []
    for e, dev in enumerate(sharding.devices):
        if e not in mine:
            views.append(None)
            continue
        r0, r1 = mine[e]
        key = (r0, str(dev))
        if key not in made:
            stream = stream_for(dev) if stream_for is not None else None
            with _stream_ctx(stream):
                blk = stripes[r0:r1].to(dev, non_blocking=True)
                v = {STRIPES: blk} if STRIPES in layouts else {}
                if COLUMNS in layouts:
                    v[COLUMNS] = blk.t().contiguous()
            made[key] = v
        views.append(made[key])
    return Tiles(views, sharding, rank, home_device(mesh, sharding, rank))


def run_entries(entries: Tiles, fn) -> list[torch.Tensor]:
    """``fn(e, views)`` on each of this rank's entries (its kernel
    launches on that entry's device), then every entry's result on every
    rank, on ``entries.home``."""
    local = {e: fn(e, v) for e, v in enumerate(entries) if v is not None}
    return multihost.all_gather_entries(local, entries.sharding.ranks,
                                        entries.home)


def _count(words: torch.Tensor) -> torch.Tensor:
    return torch.count_nonzero(words.view(torch.int32))


def sharded_words(entries: Tiles, fn) -> tuple[torch.Tensor, torch.Tensor]:
    """``fn(views)`` on each of this rank's entries, the words put back
    in lane order on every rank, and the sum over every entry of its
    nonzero-word count (summed over the ranks)."""
    counts = []

    def run(_e, v):
        w = fn(v)
        counts.append(_count(w))
        return w

    words = run_entries(entries, run)
    home = entries.home
    local = (sum(c.to(home) for c in counts) if counts
             else torch.zeros((), dtype=torch.int64, device=home))
    total = multihost.all_reduce_sum(local, home)
    out = words[0] if len(words) == 1 else torch.cat(words, dim=1)
    return out, total


def _entries(data, mesh, axis, layouts, swar: bool = False,
             pattern_axis=None):
    """Prepared entries as given, or ``data``'s stripes prepared now."""
    if isinstance(data, list):
        return data
    return prepare_tiles(data, mesh, axis, layouts, swar=swar,
                         pattern_axis=pattern_axis)


def sharded_shift_and_words(data, model, mesh: Mesh, axis="data",
                            coarse: bool = True, swar: bool = False):
    """Row 1 over the mesh: the Shift-And kernel (csrc/shift_and.cu), or
    with ``swar`` the packed kernel (csrc/shift_and_swar.cu, coarse
    only), on each entry's stripes.  ``data``: the segment's (lanes,
    chunk) stripes, or ``prepare_tiles``' entries."""
    entries = _entries(data, mesh, axis, (STRIPES,), swar)
    if swar:
        return sharded_words(entries, lambda v: swar_scan.swar_scan_words(
            v[STRIPES], model))
    return sharded_words(entries, lambda v: cuda_scan.shift_and_scan_words(
        v[STRIPES], model, coarse))


def sharded_nfa_words(data, model, mesh: Mesh, axis="data"):
    """Row 3 over the mesh: the Glushkov NFA kernel (csrc/nfa.cu) on each
    entry's columns."""
    entries = _entries(data, mesh, axis, (COLUMNS,))
    return sharded_words(entries, lambda v: nfa_scan.nfa_scan_words(
        v[COLUMNS], model))


def sharded_fdr_words(data, fdr_model, mesh: Mesh, axis="data",
                      fold_case: bool = False, pairset=None):
    """Row 4 over the mesh, lanes only: every bank's FDR filter kernel
    (csrc/fdr.cu) on each entry's columns, OR'd in one plane, and a mixed
    set's ``pairset`` sidecar (csrc/pairset.cu, on the stripes) OR'd in
    too, so the count is the union's."""
    layouts = (COLUMNS, STRIPES) if pairset is not None else (COLUMNS,)
    entries = _entries(data, mesh, axis, layouts)

    def fn(v):
        words = None
        for bank in fdr_model.banks:
            words = fdr_scan.fdr_scan_words(v[COLUMNS], bank,
                                            fold_case=fold_case, out=words)
        if pairset is not None:
            words = pairset_scan.pairset_scan_words(v[STRIPES], pairset,
                                                    out=words)
        return words

    return sharded_words(entries, fn)


def sharded_pairset_words(data, model, mesh: Mesh, axis="data"):
    """Row 5 over the mesh: the exact pairset kernel (csrc/pairset.cu) on
    each entry's stripes; the words are exact, so the count counts
    words holding a match."""
    entries = _entries(data, mesh, axis, (STRIPES,))
    return sharded_words(entries, lambda v: pairset_scan.pairset_scan_words(
        v[STRIPES], model))


def sharded_approx_words(data, model, mesh: Mesh, axis="data"):
    """Row 6 over the mesh: the Wu-Manber kernel (csrc/approx.cu) on each
    entry's stripes."""
    entries = _entries(data, mesh, axis, (STRIPES,))
    return sharded_words(entries, lambda v: approx_scan.approx_scan_words(
        v[STRIPES], model))


# ------------------------------------------------------ the pattern axis

def bank_plan(bank) -> tuple:
    """What the reference's kernel compiles against: the slots and the
    (slot, family, domain) checks."""
    return bank.m, tuple(bank.checks)


def same_plan(banks) -> bool:
    """Every bank compiles against one plan (``bank_plan``): the pattern
    axis runs one kernel instance on every entry."""
    return len({bank_plan(b) for b in banks}) == 1


def fdr_pattern_tables(fdr_model, mesh: Mesh,
                       pattern_axis="seq") -> list[list]:
    """The banks of ``fdr_model`` over ``pattern_axis``: ``runs[j]``, the
    banks of pattern index j (``bank_runs``), each bank's plan packed and
    uploaded once on each of this rank's devices at pattern index j
    (``fdr_scan`` keeps a bank's plan a device).  Engines cache this a
    plan (the reference's ``_fdr_ep_tables``).  A bank count that does not
    divide the axis leaves the last runs shorter or empty: an empty run
    gives zero words, so nothing is padded."""
    pat = axes_tuple(pattern_axis)
    if any(a not in mesh.axis_names for a in pat):
        raise ValueError(f"pattern_axis {pattern_axis!r} not in mesh axes "
                         f"{sorted(mesh.axis_names)}")
    n_pat = int(np.prod([mesh.shape[a] for a in pat]))
    banks = list(fdr_model.banks)
    runs = [[banks[b] for b in r] for r in bank_runs(len(banks), n_pat)]
    order = [mesh.axis_names.index(a) for a in pat]
    rest = [i for i in range(len(mesh.axis_names)) if i not in order]
    devs = np.transpose(mesh.devices, order + rest).reshape(n_pat, -1)
    ranks = np.transpose(mesh.ranks, order + rest).reshape(n_pat, -1)
    rank = multihost.process_index()
    for j, run in enumerate(runs):
        held = {str(d): d for d, r in zip(devs[j], ranks[j]) if r == rank}
        for dev in held.values():
            for bank in run:
                if dev.type == "cuda":
                    fdr_scan._plans(bank, dev)
    return runs


def sharded_fdr_pattern_step(data, fdr_model, mesh: Mesh, data_axis="data",
                             pattern_axis="seq", fold_case: bool = False,
                             tabs_dev: list[list] | None = None):
    """Pattern-parallel FDR (the reference's expert-parallel analogue):
    the banks' runs over ``pattern_axis``, lanes over ``data_axis``; entry
    (i, j) runs run j's banks with the FDR kernel (csrc/fdr.cu) on lane
    block i's columns, and the words are OR'd across the pattern axis.
    Returns (words, total): the words bit for bit one device's OR of every
    bank, the total the nonzero words of that OR'd plane (the reference's
    ``psum(count_nonzero) // n_pat``).  ``data``: the segment's (lanes,
    chunk) stripes, or ``prepare_tiles(..., pattern_axis=...)``'s entries
    with COLUMNS; ``tabs_dev``: ``fdr_pattern_tables``' result (built now
    when None).  Mixed-plan banks raise ValueError."""
    if not same_plan(fdr_model.banks):
        raise ValueError(
            "pattern-parallel FDR needs same-plan banks (mixed-window "
            "models keep the lane-sharded step)")
    entries = _entries(data, mesh, data_axis, (COLUMNS,),
                       pattern_axis=pattern_axis)
    if tabs_dev is None:
        tabs_dev = fdr_pattern_tables(fdr_model, mesh, pattern_axis)
    sharding = entries.sharding
    if len(tabs_dev) != sharding.n_pat:
        raise ValueError(f"{len(tabs_dev)} bank runs for a pattern "
                         f"axis of {sharding.n_pat}")

    def fn(e, v):
        cols = v[COLUMNS]
        words = None
        for bank in tabs_dev[sharding.part_of(e)]:
            words = fdr_scan.fdr_scan_words(cols, bank, fold_case=fold_case,
                                            out=words)
        if words is None:  # an empty run: no candidates
            words = torch.zeros((cols.shape[0] // 32, cols.shape[1]),
                                dtype=torch.uint32, device=cols.device)
        return words

    words = pattern_or(entries, run_entries(entries, fn))
    return words, _count(words).to(torch.int64)


def pattern_or(entries: Tiles, words: list[torch.Tensor]) -> torch.Tensor:
    """Every entry's words (``run_entries``'s list, entry i * n_pat + j) OR'd
    across the pattern axis, the lane blocks then put in lane order."""
    n_pat = entries.sharding.n_pat
    blocks = []
    for i in range(entries.sharding.n):
        acc = words[i * n_pat].clone()
        for j in range(1, n_pat):
            or_into(acc, words[i * n_pat + j])
        blocks.append(acc)
    return blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=1)
