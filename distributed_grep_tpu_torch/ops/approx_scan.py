"""Approximate-match words: the CUDA kernel's wrapper and its plain version.

``approx_scan_words(data, model)`` takes the document's stripes as they
lie, a (lanes, chunk) uint8 tensor with a pitch (``check_stripes``,
ops/cuda_scan.py), and returns (chunk // 32, lanes) uint32 EXACT words:
bit t of word w of lane l is set iff a match of ``model`` with at
most ``model.k`` edit errors ends at byte 32w + t of stripe l, the rows
seeded at the stripe head as at a line start (models/approx.py).  These
are the words of the reference TPU kernel
(``distributed_grep_tpu/ops/pallas_approx.py:_kernel``) reshaped from its
tile (chunk // 32, lanes // 128, 128) to the port's (chunk // 32, lanes).

A CUDA tensor launches the hand-written kernel (csrc/approx.cu, k = 1..3,
the B table passed by value; sub-stripes after the first start
``warmup_words(model)`` words early from the seeds); a CPU tensor
runs ``approx_scan_words_plain``.  Anything else raises.

Routing difference from the reference, which changes no output line: the
TPU kernel builds B[c] from range compares and refuses models past
``pallas_scan.MAX_TOTAL_RANGES`` (48) ranges, which the reference then
scans on its XLA path; the CUDA kernel looks B[c] up in a table, so every
approx model runs on it.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from distributed_grep_tpu_torch.models.approx import MAX_ERRORS, NL, ApproxModel
from distributed_grep_tpu_torch.ops import _build
from distributed_grep_tpu_torch.ops.cuda_scan import check_stripes
from distributed_grep_tpu_torch.ops.fdr_scan import pack_bits
from distributed_grep_tpu_torch.ops.layout import STRIPES

_U32 = 0xFFFFFFFF

LAYOUT = STRIPES  # the layout the kernel reads (ops/layout.py)
# the csrc/ source this module builds and launches
LIBRARY = "approx"

# Launch count of the CUDA kernel: incremented once per launch, nowhere
# else.  chip_smoke.py zeroes it before the main path and reads it after.
_count_lock = threading.Lock()
launches = 0


def reset_launches() -> None:
    global launches
    with _count_lock:
        launches = 0


def _count_launch() -> None:
    global launches
    with _count_lock:
        launches += 1


def _check_model(model: ApproxModel) -> None:
    if not 1 <= model.k <= MAX_ERRORS or model.k >= model.length:
        raise ValueError(
            f"approx model needs 1 <= k <= {MAX_ERRORS} and k < length, got "
            f"k={model.k} length={model.length}"
        )


def warmup_words(model: ApproxModel) -> int:
    """Words a sub-stripe steps before its own start: a match of at most k
    edits ending at byte c starts at or after c - (m + k - 1), so m + k - 1
    bytes of warm-up suffice, rounded up to whole words (1, or 2 when
    m + k - 1 > 32)."""
    return -(-(model.length + model.k - 1) // 32)


def approx_scan_words_plain(data: torch.Tensor,
                            model: ApproxModel) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on ``data``'s device: a loop
    over the chunk, vectorized over lanes.  The rows are int64 masked to 32
    bits (PyTorch on the CPU has no ``<<`` for uint32)."""
    lanes, chunk, _pitch = check_stripes(data)
    _check_model(model)
    dev = data.device
    table = torch.from_numpy(model.base.b_table.astype(np.int64)).to(dev)
    k, mb, seeds = model.k, int(model.match_bit), model.seeds
    rows = [torch.full((lanes,), s, dtype=torch.int64, device=dev)
            for s in seeds]
    hit = torch.empty((chunk, lanes), dtype=torch.bool, device=dev)
    for c in range(chunk):
        byte = data[:, c].long()
        b = table[byte]
        nl = byte == NL
        new = [((rows[0] << 1) | 1) & b]
        for j in range(1, k + 1):
            new.append(((((rows[j] << 1) | 1) & b) | rows[j - 1]
                        | (rows[j - 1] << 1) | (new[j - 1] << 1)
                        | seeds[j]) & _U32)
        rows = [torch.where(nl, seeds[j], new[j]) for j in range(k + 1)]
        hit[c] = (rows[k] & mb) != 0
    return pack_bits(hit)


def _lib():
    lib = _build.load(LIBRARY)
    fn = lib.dgrep_approx_scan
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def approx_scan_words(data: torch.Tensor, model: ApproxModel) -> torch.Tensor:
    """Match-end words for ``data`` (see the module docstring).  CUDA
    tensors launch the kernel on the current stream (no synchronization;
    the output is allocated here); CPU tensors take the plain version."""
    lanes, chunk, pitch = check_stripes(data)
    _check_model(model)
    if data.device.type == "cpu":
        return approx_scan_words_plain(data, model)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    fn = _lib()
    out = torch.empty((chunk // 32, lanes), dtype=torch.uint32,
                      device=data.device)
    table = np.ascontiguousarray(model.base.b_table, dtype=np.uint32)
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        err = fn(data.data_ptr(), out.data_ptr(), table.ctypes.data,
                 chunk, lanes, pitch, int(model.match_bit), int(model.k),
                 warmup_words(model), stream)
    if err != 0:
        raise RuntimeError(
            f"approx CUDA kernel launch failed: cudaError {err} "
            f"(lanes={lanes}, chunk={chunk}, pitch={pitch}, k={model.k})"
        )
    _count_launch()
    return out
