"""Sparse match-result decoding: packed scan words -> host byte offsets.

Companion to ops/scan_torch.sparse_nonzero: the device keeps the dense
word plane; the host receives only (index, value) pairs of its nonzero
words and decodes document offsets from their coordinates.

The port's words are a row-major ``(chunk // 32, lanes)`` uint32 array:
flat index ``w * lanes + lane``, bit t of word w = chunk position
``w * 32 + t``.  (The reference decode hard-codes the TPU tile
``(chunk // 32, lanes // 128, 128)``; its lane formula reduces to
``s * 128 + l``, so the reference's words reshaped to ``(chunk // 32,
lanes)`` are this layout exactly.)
"""

from __future__ import annotations

import numpy as np

from distributed_grep_tpu_torch.ops.layout import Layout


def span_starts_from_sparse_words(idx: np.ndarray, layout: Layout) -> np.ndarray:
    """Decode COARSE words: a nonzero word means "some candidate match ends
    in this 32-byte stripe span"; values don't matter.  Returns sorted
    document offsets of span starts -- each span is [start, min(start + 32,
    document end)); the engine confirms the lines overlapping it."""
    if idx.size == 0:
        return np.zeros(0, dtype=np.int64)
    idx = idx.astype(np.int64)
    w, lane = np.divmod(idx, layout.lanes)
    starts = lane * layout.chunk + w * 32
    starts = starts[starts < layout.n_real]
    starts.sort()
    return starts


def span_starts_from_packed_words(
    idx: np.ndarray, vals: np.ndarray, layout: Layout
) -> np.ndarray:
    """Decode the SWAR kernel's packed COARSE words (ops/swar_scan.py):
    the plane is (chunk // 32, lanes // 4), flat index ``w * (lanes // 4)
    + j``, and a nonzero byte k of the value names a candidate 32-byte span
    of stripe 4j + k.  Returns sorted document offsets of span starts, the
    ``span_starts_from_sparse_words`` contract."""
    if idx.size == 0:
        return np.zeros(0, dtype=np.int64)
    w, j = np.divmod(idx.astype(np.int64), layout.lanes // 4)
    vals = vals.astype(np.uint32)
    out = []
    for k in range(4):
        sel = (vals >> np.uint32(8 * k)) & np.uint32(0xFF) != 0
        if sel.any():
            out.append((4 * j[sel] + k) * layout.chunk + w[sel] * 32)
    starts = np.concatenate(out) if out else np.zeros(0, dtype=np.int64)
    starts = starts[starts < layout.n_real]
    starts.sort()
    return starts


def offsets_from_sparse_words(
    idx: np.ndarray, vals: np.ndarray, layout: Layout
) -> np.ndarray:
    """Decode EXACT words: bit t of word w at lane l = a match ends at chunk
    position w * 32 + t of stripe l.  Returns sorted end offsets (i + 1),
    clamped to the real document length."""
    if idx.size == 0:
        return np.zeros(0, dtype=np.int64)
    idx = idx.astype(np.int64)
    vals = vals.astype(np.uint32)
    w, lane = np.divmod(idx, layout.lanes)
    out = []
    for t in range(32):
        sel = (vals >> np.uint32(t)) & np.uint32(1) != 0
        if sel.any():
            out.append(lane[sel] * layout.chunk + w[sel] * 32 + t + 1)
    offsets = np.concatenate(out)
    offsets = offsets[offsets <= layout.n_real]
    offsets.sort()
    return offsets
