"""Slope-method kernel timing, shared by the port's bench and benchmarks/.

The port's counterpart of ``distributed_grep_tpu/utils/slope.py``.  One
timed pass mixes launch and fetch overhead into the kernel's time, so the
slope method runs r chained passes and takes the per-pass time from the
difference between two chain lengths: the constants cancel.

Each pass scans a window of the device tensor at a row offset that
alternates with the pass index (``(i % 2) * pad_rows``), as in the
reference, whose compiler would otherwise hoist a loop-invariant scan out
of its loop.  Eager launches are never hoisted, but the alternating
windows keep the reference's even/odd count contract, which the exact
count-drift check below rests on.

How a chain is timed on the card.  The passes are launched through ctypes
(``csrc/*.cu``) and each ends in ``torch.count_nonzero``: some tens of
microseconds of host work per pass, against kernel times of 0.05-0.5 ms
per 64 MB segment.  With eager launches the card can wait on the host, and
that wait grows with r, so it would not cancel in the slope.  The chain of
r passes is therefore captured once in a CUDA graph, and each timed run
replays the graph between two CUDA events on the current stream: the
per-pass host work is gone and the events read the card's own clock.  On
the CPU (the plain versions, asked for explicitly) the passes run eagerly
and the host clock times them.

The pad.  The reference's 512 pad rows assume chunk ~ 8192 (its 8192-lane
layout).  The port's setups use the main path's layout (65536 lanes x
1024 bytes per 64 MB segment), where an odd window that drops 512 rows
would scan half the data; the pad here is 32 rows (one word row), so an
odd window drops about 3% of each stripe.  Each window is ``chunk`` rows
of '\\n'-padded stripes, so a pass scans ``chunk * lanes`` bytes
(``pass_bytes``): callers divide those bytes by the per-pass time.

Layouts.  The harness windows ``dev`` by rows, ``dev[off : off + chunk]``.
For the kernels that read the column layout ``dev`` is the contiguous
(chunk + pad, lanes) tensor of ``device_setup``.  The Shift-And and
pairset kernels read the stripes as they lie: ``stripe_setup`` gives the
contiguous (lanes, chunk + pad) stripes, 32 pad columns of '\\n', and
``shift_and_setup`` and ``pairset_setup`` hand the harness their (row,
lane) view, so each window, seen as stripes again, is a (lanes, chunk)
stripe window whose pitch is chunk + pad, with no copy.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from distributed_grep_tpu_torch.ops.engine import DEFAULT_TARGET_LANES
from distributed_grep_tpu_torch.ops.layout import (
    NL,
    choose_layout,
    padded_stripes,
    to_device_array,
)
from distributed_grep_tpu_torch.utils.device import resolve_device

PAD_ROWS = 32
# Chain lengths on the CPU: one pass of a plain version takes milliseconds
# there and has no launch queue to amortize, so short chains clear the
# noise gate (callers pass their card chain lengths through ``reps``).
CPU_REPS = (2, 4)


def reps(device: torch.device, r1: int, r2: int) -> tuple[int, int]:
    """(r1, r2) on the card; ``CPU_REPS`` on the CPU."""
    return (r1, r2) if torch.device(device).type == "cuda" else CPU_REPS


def pass_bytes(dev: torch.Tensor, chunk: int) -> int:
    """Bytes one pass scans: ``chunk`` rows of every lane."""
    return chunk * int(dev.shape[1])


def _chain(dev, chunk: int, pad_rows: int, scan_count_fn, r: int):
    acc = torch.zeros((), dtype=torch.int64, device=dev.device)
    for i in range(r):
        off = (i % 2) * pad_rows
        out = scan_count_fn(dev[off : off + chunk])
        if out.dtype == torch.uint32:  # no count_nonzero for uint32
            out = out.view(torch.int32)
        acc += out if out.dim() == 0 else torch.count_nonzero(out)
    return acc


class _CudaChains:
    """One CUDA graph per chain length, each captured once."""

    def __init__(self, dev, chunk, pad_rows, scan_count_fn):
        self.args = (dev, chunk, pad_rows, scan_count_fn)
        self.graphs: dict[int, tuple] = {}
        self.device = dev.device
        # Warm up on a side stream before the first capture: loads each
        # kernel's library and uploads the models' device plans.
        side = torch.cuda.Stream(device=self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            _chain(*self.args, 2)
        torch.cuda.current_stream(self.device).wait_stream(side)
        torch.cuda.synchronize(self.device)

    def _graph(self, r: int):
        got = self.graphs.get(r)
        if got is None:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                acc = _chain(*self.args, r)
            got = self.graphs[r] = (graph, acc)
        return got

    def count(self, r: int) -> int:
        graph, acc = self._graph(r)
        graph.replay()
        return int(acc.item())

    def seconds(self, r: int, iters: int) -> float:
        graph, _acc = self._graph(r)
        graph.replay()  # the first replay uploads the graph
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            graph.replay()
        stop.record()
        torch.cuda.synchronize(self.device)
        return start.elapsed_time(stop) / 1e3 / iters


class _CpuChains:
    def __init__(self, dev, chunk, pad_rows, scan_count_fn):
        self.args = (dev, chunk, pad_rows, scan_count_fn)

    def count(self, r: int) -> int:
        return int(_chain(*self.args, r))

    def seconds(self, r: int, iters: int) -> float:
        t0 = time.perf_counter()
        for _ in range(iters):
            int(_chain(*self.args, r))
        return (time.perf_counter() - t0) / iters


def slope_per_pass(
    dev: torch.Tensor,
    chunk: int,
    pad_rows: int,
    scan_count_fn,
    r1: int = 2,
    r2: int = 6,
    iters: int = 3,
    count_range: tuple[int, int] | None = None,
    measurements: int = 1,
):
    """Per-pass seconds for scan_count_fn over ``dev``'s row windows.

    dev            (chunk + pad_rows, lanes) uint8 tensor on the card or
                   the CPU
    scan_count_fn  window -> a 0-dim count, or a tensor whose nonzero
                   elements are counted
    count_range    optional (lo, hi) per-pass count sanity band
    r1, r2         chain lengths; both must be even so the two chains see
                   the same even/odd window mix (the count-drift check
                   below compares per-pass counts exactly)
    measurements   > 1 repeats only the timed section and returns the
                   median slope
    Returns (per_pass_seconds, per_pass_count_avg).
    """
    if r1 % 2 or r2 % 2:
        raise ValueError(f"r1/r2 must be even (same window mix per run): {r1=} {r2=}")
    chains = (_CudaChains if dev.device.type == "cuda" else _CpuChains)(
        dev, chunk, pad_rows, scan_count_fn)
    c1, c2 = chains.count(r1), chains.count(r2)
    # Both chains see the same even/odd window mix, so per-pass counts
    # must agree exactly.
    assert c2 * r1 == c1 * r2, f"per-pass count drift: {c1}/{r1} vs {c2}/{r2}"
    if count_range is not None:
        lo, hi = count_range
        assert lo * r1 <= c1 <= hi * r1, f"match count off: {c1} for {r1} passes"

    # Noise gate: a non-positive slope, or a difference under 30% of the
    # r1 time, escalates r2 (three times at most) and measures again; a
    # measurement that never clears the gate raises rather than report a
    # number the gate distrusts.
    slopes: list[float] = []
    for _ in range(max(1, measurements)):
        for attempt in range(4):
            d1, d2 = chains.seconds(r1, iters), chains.seconds(r2, iters)
            delta = d2 - d1
            if delta > 0 and delta >= 0.3 * d1:
                slopes.append(delta / (r2 - r1))
                break
            if attempt < 3:
                r2 = r2 * 3
                c2 = chains.count(r2)
                assert c2 * r1 == c1 * r2, f"count drift: {c1}/{r1} vs {c2}/{r2}"
        else:
            raise RuntimeError(
                f"slope never cleared the noise gate: "
                f"{d1=:.6f}s ({r1}) {d2=:.6f}s ({r2})"
            )
    return sorted(slopes)[len(slopes) // 2], c1 / r1


def device_setup(
    data: bytes,
    device: str | torch.device = "cuda",
    *,
    lane_multiple: int = 32,
    chunk_multiple: int = 32,
    min_chunk: int = 256,
):
    """The (chunk, lanes) column layout of ``data`` (the engine's layout
    rule: 65536 lanes, 1024 bytes each for 64 MiB) with PAD_ROWS rows of
    '\\n' appended, on ``device``.  Returns (dev, layout, PAD_ROWS)."""
    device = resolve_device(device)
    lay = _layout(data, lane_multiple, chunk_multiple, min_chunk)
    arr = to_device_array(data, lay)
    pad = np.full((PAD_ROWS, lay.lanes), NL, dtype=np.uint8)
    dev = torch.from_numpy(np.concatenate([arr, pad], axis=0)).to(device)
    return dev, lay, PAD_ROWS


def stripe_setup(data: bytes, device: str | torch.device = "cuda"):
    """The (lanes, chunk) stripes of ``data`` (the engine's layout rule)
    with PAD_ROWS columns of '\\n' appended, contiguous on ``device``.
    Returns (stripes, layout, PAD_ROWS)."""
    device = resolve_device(device)
    lay = _layout(data, 32, 32, 256)
    pad = np.full((lay.lanes, PAD_ROWS), NL, dtype=np.uint8)
    host = np.concatenate([padded_stripes(data, lay), pad], axis=1)
    return torch.from_numpy(host).to(device), lay, PAD_ROWS


def _layout(data: bytes, lane_multiple: int, chunk_multiple: int,
            min_chunk: int):
    return choose_layout(len(data), target_lanes=DEFAULT_TARGET_LANES,
                         min_chunk=min_chunk, lane_multiple=lane_multiple,
                         chunk_multiple=chunk_multiple)


def shift_and_setup(data: bytes, model, *, device="cuda"):
    """Device tensor + scan closure for slope-timing the Shift-And kernel
    (csrc/shift_and.cu) in coarse mode, the engine's first pass, on stripe
    windows (module docstring).  Returns
    (dev, chunk, pad_rows, scan) for slope_per_pass."""
    from distributed_grep_tpu_torch.ops import cuda_scan

    stripes, lay, pad_rows = stripe_setup(data, device)

    def scan(win):  # a row window of stripes.t(): a pitched stripe window
        return cuda_scan.shift_and_scan_words(win.t(), model, True)

    return stripes.t(), lay.chunk, pad_rows, scan


def nfa_setup(data: bytes, model, *, device="cuda"):
    """Device tensor + scan closure for slope-timing the Glushkov NFA
    kernel (csrc/nfa.cu)."""
    from distributed_grep_tpu_torch.ops import nfa_scan

    dev, lay, pad_rows = device_setup(data, device)

    def scan(win):
        return nfa_scan.nfa_scan_words(win, model)

    return dev, lay.chunk, pad_rows, scan


def fdr_setup(data: bytes, model, *, device="cuda", fold_case: bool = False):
    """Device tensor + scan closure for slope-timing the FDR filter kernel
    (csrc/fdr.cu): every bank of ``model`` runs per pass, ORing its
    candidate words into one plane, as the engine does per segment."""
    from distributed_grep_tpu_torch.ops import fdr_scan

    dev, lay, pad_rows = device_setup(data, device)

    def scan(win):
        words = None
        for bank in model.banks:
            words = fdr_scan.fdr_scan_words(win, bank, fold_case, out=words)
        return words

    return dev, lay.chunk, pad_rows, scan


def dfa_setup(data: bytes, tables, *, device="cuda"):
    """Device tensor + scan closure for slope-timing the table-DFA kernel
    (csrc/dfa.cu) on stripe windows, as ``shift_and_setup``: one launch a
    table of ``tables``, ORed (ops/dfa_scan.dfa_scan_bank_words)."""
    from distributed_grep_tpu_torch.ops import dfa_scan

    stripes, lay, pad_rows = stripe_setup(data, device)

    def scan(win):  # a row window of stripes.t(): a pitched stripe window
        return dfa_scan.dfa_scan_bank_words(win.t(), tables)

    return stripes.t(), lay.chunk, pad_rows, scan


def stride_setup(data: bytes, stride_table, *, device="cuda"):
    """Device tensor + scan closure for slope-timing K2, the k-byte-stride
    table-DFA kernel (csrc/dfa.cu stride_kernel), on stripe windows, as
    ``dfa_setup``."""
    from distributed_grep_tpu_torch.ops import dfa_scan

    stripes, lay, pad_rows = stripe_setup(data, device)

    def scan(win):  # a row window of stripes.t(): a pitched stripe window
        return dfa_scan.dfa_stride_words(win.t(), stride_table)

    return stripes.t(), lay.chunk, pad_rows, scan


def pairset_setup(data: bytes, model, *, device="cuda"):
    """Device tensor + scan closure for slope-timing the exact 1-2-byte set
    kernel (csrc/pairset.cu) on stripe windows, as ``shift_and_setup``."""
    from distributed_grep_tpu_torch.ops import pairset_scan

    stripes, lay, pad_rows = stripe_setup(data, device)

    def scan(win):  # a row window of stripes.t(): a pitched stripe window
        return pairset_scan.pairset_scan_words(win.t(), model)

    return stripes.t(), lay.chunk, pad_rows, scan
