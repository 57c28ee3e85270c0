"""The per-segment device pipeline of GrepEngine.scan.

The document is cut into segments of ``engine.segment_bytes``.  For each:

1. prepare (one-slot feed thread): copy the segment into pinned host
   memory padded with '\\n', start its host-to-device copy on a side
   stream, and transpose it there into the (chunk, lanes) stripe layout
   -- so segment i+1 is uploading and laid out while segment i scans.
   The transpose runs on the card: on the host, a strided copy of the
   segment costs more than the rest of this pipeline (PERF.md);
2. dispatch (scanning thread): wait for the copy, launch the coarse
   Shift-And kernel with the rare-class filter model (or the full model);
3. collect (two pool threads, overlapping the next segment's scan): fetch
   the nonzero words (ops/scan_torch.py), decode them to 32-byte span
   starts, map spans to candidate lines and confirm those exactly:
   * up to SPAN_CONFIRM_LINE_LIMIT lines: the vectorized host matcher;
   * above it (the dense confirm): one exact-mode kernel pass over the
     segment, still on the device, decoded to match-end lines.  If the
     filter model produced mostly false candidates (true lines * 4 <
     candidate lines), the remaining segments of this scan run the full
     model (the defeat guard);
   then the boundary stitch: a match the device missed must span one of
   the segment's stripe starts or the segment start, so it lies inside
   the window of m-1 bytes on either side of that boundary (clipped to
   the boundary's line; m = pattern length), and the host checks just
   those windows.

Every line the pipeline reports is a confirmed match, so the stitch only
adds lines, and segments can be collected in any order.  A build, launch
or CUDA failure raises: nothing falls back to another route.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from distributed_grep_tpu_torch.ops import cuda_scan
from distributed_grep_tpu_torch.ops import engine as engine_mod
from distributed_grep_tpu_torch.ops import lines as lines_mod
from distributed_grep_tpu_torch.ops.layout import (
    choose_layout,
    padded_stripes,
    to_device_array,
)
from distributed_grep_tpu_torch.ops.scan_torch import sparse_nonzero
from distributed_grep_tpu_torch.ops.sparse import (
    offsets_from_sparse_words,
    span_starts_from_sparse_words,
)

MAX_INFLIGHT = 2  # segments dispatched but not yet collected


def _expand_line_ranges(l0: np.ndarray, l1: np.ndarray) -> np.ndarray:
    """Sorted unique union of the inclusive line ranges [l0[i], l1[i]]."""
    counts = l1 - l0 + 1
    base = np.repeat(l0 - np.concatenate(([0], np.cumsum(counts)[:-1])), counts)
    return np.unique(base + np.arange(int(counts.sum()), dtype=np.int64))


def scan_device(eng, data: bytes, progress=None):
    t_wall0 = time.perf_counter()
    st = {"candidates": 0, "segments": 0, "dense_confirms": 0,
          "stitch_windows": 0, "filter_defeated": False,
          "feed_wait_seconds": 0.0, "prepare_seconds": 0.0,
          "collect_seconds": 0.0}
    eng.stats = st
    n = len(data)
    view = memoryview(data)
    nl = lines_mod.newline_index(data)
    device = eng.device
    on_cuda = device.type == "cuda"
    full = eng.shift_and
    lay_kwargs = eng.layout_kwargs()
    seg = eng.segment_bytes
    seg_starts = list(range(0, n, seg))
    lock = threading.Lock()
    scan_state = {"filtered": eng._sa_filtered}  # dropped by the defeat guard
    found: list[np.ndarray] = []

    def prepare(i: int):
        t0 = time.perf_counter()
        try:
            return _prepare(i)
        finally:
            with lock:
                st["prepare_seconds"] += time.perf_counter() - t0

    def _prepare(i: int):
        seg_start = seg_starts[i]
        seg_view = view[seg_start : seg_start + seg]
        lay = choose_layout(len(seg_view), **lay_kwargs)
        if not on_cuda:
            return seg_start, len(seg_view), lay, torch.from_numpy(
                to_device_array(seg_view, lay)), None
        host = torch.empty((lay.lanes, lay.chunk), dtype=torch.uint8,
                           pin_memory=True)
        padded_stripes(seg_view, lay, out=host.numpy())
        side = eng.copy_stream()
        with torch.cuda.stream(side):
            arr = host.to(device, non_blocking=True).t().contiguous()
            ready = torch.cuda.Event()
            ready.record(side)
        return seg_start, len(seg_view), lay, arr, ready

    def confirm(cand: np.ndarray) -> np.ndarray:
        starts, ends = lines_mod.line_spans(cand, nl, n)
        return cand[eng.lines_match(data, starts, ends)]

    reach = full.length - 1  # bytes a spanning match extends past a boundary

    def stitch(bounds: np.ndarray) -> np.ndarray:
        suspects = np.searchsorted(nl, bounds, side="right") + 1
        ls, le = lines_mod.line_spans(suspects, nl, n)
        keep = eng.lines_match(data, np.maximum(ls, bounds - reach),
                               np.minimum(le, bounds + reach))
        return np.unique(suspects[keep])

    def collect(*job) -> None:
        t0 = time.perf_counter()
        try:
            _collect(*job)
        finally:
            with lock:
                st["collect_seconds"] += time.perf_counter() - t0

    def _collect(seg_start: int, seg_len: int, lay, arr, words) -> None:
        idx, _ = sparse_nonzero(words)
        spans = span_starts_from_sparse_words(idx, lay)
        new: list[np.ndarray] = []
        n_cand = 0
        dense = False
        if spans.size:
            g0 = spans + seg_start
            g1 = np.minimum(g0 + 32, n)
            cand = _expand_line_ranges(
                lines_mod.line_of_offsets(g0 + 1, nl),
                lines_mod.line_of_offsets(g1, nl),
            )
            n_cand = int(cand.size)
            if n_cand > engine_mod.SPAN_CONFIRM_LINE_LIMIT:
                # dense confirm: exact end bits of the FULL model, on device
                dense = True
                exact = cuda_scan.shift_and_scan_words(arr, full, coarse=False)
                e_idx, e_vals = sparse_nonzero(exact)
                offs = offsets_from_sparse_words(e_idx, e_vals, lay)
                true_lines = lines_mod.unique_match_lines(offs + seg_start, nl)
                new.append(true_lines)
            else:
                new.append(confirm(cand))
        bounds = seg_start + lay.stripe_starts()
        bounds = bounds[bounds < seg_start + seg_len]
        if seg_start > 0:
            bounds = np.concatenate(([seg_start], bounds))
        new.append(stitch(bounds))
        with lock:
            found.extend(new)
            st["candidates"] += n_cand
            st["stitch_windows"] += int(bounds.size)
            if dense:
                st["dense_confirms"] += 1
                if (scan_state["filtered"] is not None
                        and new[0].size * 4 < n_cand):
                    # mostly-false candidates: this corpus defeats the
                    # filter's byte prior -- the remaining segments of
                    # THIS scan run the full model
                    scan_state["filtered"] = None
                    st["filter_defeated"] = True

    with ThreadPoolExecutor(1, thread_name_prefix="dgrep-feed") as feed, \
            ThreadPoolExecutor(2, thread_name_prefix="dgrep-collect") as pool:
        nxt = feed.submit(prepare, 0)
        pending: deque = deque()
        for i in range(len(seg_starts)):
            t0 = time.perf_counter()
            seg_start, seg_len, lay, arr, ready = nxt.result()
            st["feed_wait_seconds"] += time.perf_counter() - t0
            if i + 1 < len(seg_starts):
                nxt = feed.submit(prepare, i + 1)
            if ready is not None:
                cur = torch.cuda.current_stream(device)
                cur.wait_event(ready)
                arr.record_stream(cur)
            with lock:
                model = scan_state["filtered"] or full
            words = cuda_scan.shift_and_scan_words(arr, model, coarse=True)
            st["segments"] += 1
            pending.append(pool.submit(collect, seg_start, seg_len, lay,
                                       arr, words))
            while len(pending) > MAX_INFLIGHT:
                pending.popleft().result()
            if progress is not None:
                progress()
        while pending:
            pending.popleft().result()
            if progress is not None:
                progress()

    lines_arr = (np.unique(np.concatenate(found)).astype(np.int64)
                 if found else np.zeros(0, dtype=np.int64))
    st["scan_wall_seconds"] = time.perf_counter() - t_wall0
    return engine_mod.ScanResult(lines_arr, int(lines_arr.size), n,
                                 nl_index=nl)
