"""The ported kernels on a mesh of one host's cards, lanes sharded (the
lane half of the reference's parallel/sharded_kernels.py).

The reference runs its Pallas kernels under ``shard_map``: a segment's
lanes shard over the mesh axis, each device runs the unchanged
single-chip kernel on its lane block, and the candidate count is a
``psum``.  Here each mesh entry's block of (lanes, chunk) stripes, a
contiguous run of rows, is copied to its device (``prepare_tiles``), the
ported kernel is launched there on that block (the NFA and FDR kernels
on the block's on-card transpose), and the blocks' words are put back in
lane order on the first entry's device: they equal the single-device
words bit for bit, since every kernel's word of a lane depends on that
lane's stripe alone.  The count is the sum of each entry's nonzero-word
count (the reference's ``psum`` of ``count_nonzero``).

Every function returns ``(words, total)``: the (chunk // 32, lanes)
words (SWAR's (chunk // 32, lanes // 4)) and the total as an int64
tensor on the first entry's device.  A kernel that fails on one entry
fails the call: nothing is retried on another entry or on the host.

Not here yet (ROADMAP item 9, second half): the pattern axis (FDR banks
sharded over a second axis), the multi-process feed.
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
from distributed_grep_tpu_torch.ops.layout import COLUMNS, STRIPES
from distributed_grep_tpu_torch.parallel.mesh import Mesh, lane_sharding

# The stripe kernels' lane tile (a warp's 32 stripes; csrc/*.cu take any
# multiple of 32) and the packed SWAR kernel's (4 stripes an element, 32
# elements a warp: ops/device_scan.SWAR_LANE_MULTIPLE).
LANE_TILE = 32
SWAR_LANE_TILE = 128


def mesh_lane_multiple(mesh: Mesh, axis="data", swar: bool = False) -> int:
    """Lanes must split into whole lane tiles per entry: the entries
    times the kernels' lane tile."""
    return lane_sharding(mesh, axis).n * (SWAR_LANE_TILE if swar
                                          else LANE_TILE)


def _stream_ctx(stream):
    return (torch.cuda.stream(stream) if stream is not None
            else contextlib.nullcontext())


def prepare_tiles(stripes, mesh: Mesh, axis="data", layouts=(STRIPES,),
                  stream_for=None, swar: bool = False) -> list[dict]:
    """(lanes, chunk) stripes (a tensor on any device, or a numpy array)
    -> one dict an entry, layout -> its block on its device, in the
    layouts asked for: STRIPES the rows themselves, COLUMNS their
    transpose, made on the entry's device.  ``stream_for(device)`` names
    the stream each entry's copy and transpose go on (None: the current
    one).  Raises ValueError where the lanes do not split into whole
    tiles, as the reference's layout check."""
    if isinstance(stripes, np.ndarray):
        stripes = torch.from_numpy(stripes)
    lanes, chunk = stripes.shape
    mult = mesh_lane_multiple(mesh, axis, swar)
    if lanes % mult or chunk % 32:
        raise ValueError(
            f"sharded layout needs lanes%{mult}==0 (got {lanes}), "
            f"chunk%32==0 (got {chunk})")
    sharding = lane_sharding(mesh, axis)
    entries = []
    for dev, (r0, r1) in zip(sharding.devices, sharding.bounds(lanes)):
        stream = stream_for(dev) if stream_for is not None else None
        with _stream_ctx(stream):
            blk = stripes[r0:r1].to(dev, non_blocking=True)
            views = {STRIPES: blk} if STRIPES in layouts else {}
            if COLUMNS in layouts:
                views[COLUMNS] = blk.t().contiguous()
        entries.append(views)
    return entries


def sharded_words(entries: list[dict], fn) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    """``fn(views)`` on each entry's views (its kernel launches on that
    entry's device), the words put back in lane order on the first
    entry's device, and the sum of the entries' nonzero-word counts."""
    words, counts = [], []
    for views in entries:
        w = fn(views)
        words.append(w)
        counts.append(torch.count_nonzero(w.view(torch.int32)))
    home = words[0].device
    total = sum(c.to(home) for c in counts)
    out = (words[0] if len(words) == 1
           else torch.cat([w.to(home) for w in words], dim=1))
    return out, total


def _entries(data, mesh, axis, layouts, swar: bool = False):
    """Prepared entries as given, or ``data``'s stripes prepared now."""
    if isinstance(data, list):
        return data
    return prepare_tiles(data, mesh, axis, layouts, swar=swar)


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
