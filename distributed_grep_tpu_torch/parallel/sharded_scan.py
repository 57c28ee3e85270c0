"""The mesh's table-DFA steps (the reference's parallel/sharded_scan.py):
``sharded_grep_step`` and, over a pattern axis, ``stack_bank_tables``
and ``sharded_pattern_set_step``.

Each mesh entry holds a contiguous block of the segment's stripes and
runs K1 (csrc/dfa.cu) on it; the results combine as the reference's
collectives do:

* the words stay in lane order, as one device's;
* the total is the matched-position count summed over the entries (the
  reference's ``psum``);
* each entry receives the exit state of the left neighbour's last lane,
  the ring the reference's ``ppermute`` rides over the linearized entry
  order.  On a mesh spanning processes the exit states are gathered to
  every rank first, so the ring crosses ranks as it crosses entries.

The pattern-set step shards a set's DFA banks (Aho-Corasick banks, say)
over a pattern axis while lanes shard over the data axes: entry (i, j)
runs run j's banks with K1 on lane block i, and the matches are OR'd
across the pattern axis (parallel/sharded_kernels.py ``pattern_or``).
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_grep_tpu_torch.models.dfa import DfaTable
from distributed_grep_tpu_torch.ops import dfa_scan
from distributed_grep_tpu_torch.ops.fdr_scan import or_into
from distributed_grep_tpu_torch.ops.layout import STRIPES
from distributed_grep_tpu_torch.parallel import multihost
from distributed_grep_tpu_torch.parallel.mesh import Mesh, bank_runs
from distributed_grep_tpu_torch.parallel.sharded_kernels import (
    pattern_or,
    prepare_tiles,
    run_entries,
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
    (int32 (entries,)); all on this rank's first entry's device, the same
    on every rank.  ``axis`` is one mesh axis or a tuple (lanes shard
    over the product).  ``data``: the (lanes, chunk) stripes; lanes must
    split into whole lane tiles."""
    entries = prepare_tiles(data, mesh, axis, (STRIPES,))
    home = entries.home
    words_l, exits_l, counts = {}, {}, []
    for e, v in enumerate(entries):
        if v is None:
            continue
        w, x = dfa_scan.dfa_scan_words(v[STRIPES], table, with_exits=True)
        words_l[e], exits_l[e] = w, x
        counts.append(popcount(w).to(home))
    owners = entries.sharding.ranks
    words = multihost.all_gather_entries(words_l, owners, home)
    exits = multihost.all_gather_entries(exits_l, owners, home)
    local = (sum(counts) if counts
             else torch.zeros((), dtype=torch.int64, device=home))
    total = multihost.all_reduce_sum(local, home)
    right_edge = torch.stack([x[-1] for x in exits])
    neighbor = torch.roll(right_edge, 1)
    return torch.cat(words, dim=1), total, torch.cat(exits), neighbor


def _check_set_banks(tables: list[DfaTable]) -> None:
    if any(t.accept_eol.any() for t in tables):
        raise ValueError("pattern-set banks never use accept_eol")


def stack_bank_tables(tables: list[DfaTable], n_shards: int):
    """The reference's padded stack of per-bank tables, array for array:
    banks padded to a common (n_states, n_classes) shape (padding rows a
    dead state-0 loop that never accepts) and the bank count to a
    multiple of ``n_shards``.  Returns (trans_flat (B, S*C) int32,
    byte_to_cls (B, 256) int32, accept (B, S) bool, starts (B,) int32,
    n_classes_max).  Shard j of the pattern axis holds rows [j * B /
    n_shards, (j + 1) * B / n_shards): ``mesh.bank_runs``, which
    ``sharded_pattern_set_step`` runs without the padding."""
    _check_set_banks(tables)
    s_max = max(t.trans.shape[0] for t in tables)
    c_max = max(t.n_classes for t in tables)
    b = len(tables) + (-len(tables) % n_shards)
    trans = np.zeros((b, s_max, c_max), dtype=np.int32)
    b2c = np.zeros((b, 256), dtype=np.int32)
    accept = np.zeros((b, s_max), dtype=bool)
    starts = np.zeros(b, dtype=np.int32)
    for i, t in enumerate(tables):
        s, c = t.trans.shape
        trans[i, :s, :c] = t.trans.astype(np.int32)
        b2c[i] = t.byte_to_cls.astype(np.int32)
        accept[i, :s] = t.accept
        starts[i] = t.start
    return trans.reshape(b, -1), b2c, accept, starts, c_max


def sharded_pattern_set_step(data, tables: list[DfaTable], mesh: Mesh,
                             data_axis="data", pattern_axis="seq"):
    """Pattern-parallel table-DFA scan (the reference's expert-parallel
    analogue): the banks' runs (``mesh.bank_runs``, as
    ``stack_bank_tables`` lays them out) over ``pattern_axis``, lanes over
    ``data_axis``; entry (i, j) runs run j's banks with K1 on lane block
    i, and the matches are OR'd across the pattern axis.  Returns (words,
    total): the (chunk // 32, lanes) uint32 words, the OR of every bank's
    ``dfa_scan_words``, and the matched-position count (the set bits).
    The reference returns the same plane as ``_pack_lane_bits``' (chunk,
    lanes // 8) bytes: its bit l % 8 of byte (c, l // 8) is the port's
    bit c % 32 of word (c // 32, l).  Banks with ``accept_eol`` raise
    ValueError, as the reference's."""
    _check_set_banks(tables)
    entries = prepare_tiles(data, mesh, data_axis, (STRIPES,),
                            pattern_axis=pattern_axis)
    sharding = entries.sharding
    runs = bank_runs(len(tables), sharding.n_pat)

    def fn(e, v):
        st = v[STRIPES]
        words = None
        for b in runs[sharding.part_of(e)]:
            words = or_into(words, dfa_scan.dfa_scan_words(st, tables[b]))
        if words is None:  # an empty run: no matches
            words = torch.zeros((st.shape[1] // 32, st.shape[0]),
                                dtype=torch.uint32, device=st.device)
        return words

    words = pattern_or(entries, run_entries(entries, fn))
    return words, popcount(words)
