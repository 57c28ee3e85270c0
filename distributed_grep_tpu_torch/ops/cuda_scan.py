"""Shift-And scan words: the CUDA kernel's wrapper and its plain version.

``shift_and_scan_words(data, model, coarse)`` takes the (chunk, lanes)
uint8 stripe layout (ops/layout.py) and returns (chunk // 32, lanes)
uint32 words, the same words as the reference TPU kernel
(``distributed_grep_tpu/ops/pallas_scan.py:_kernel``) reshaped to that
shape:

* coarse=True  -- word w of lane l is nonzero iff a candidate match ends
  in bytes 32w .. 32w+31 of stripe l (masked by the model's match bit);
* coarse=False -- bit t of word w is set iff a match ends at byte 32w+t.

A CUDA tensor launches the hand-written kernel (csrc/shift_and.cu); a CPU
tensor runs ``shift_and_scan_words_plain``.  Anything else raises.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from distributed_grep_tpu_torch.models.shift_and import ShiftAndModel
from distributed_grep_tpu_torch.ops import _build

_U32 = 0xFFFFFFFF

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


def _check(data: torch.Tensor) -> tuple[int, int]:
    if not isinstance(data, torch.Tensor):
        raise TypeError(f"data must be a torch.Tensor, got {type(data).__name__}")
    if data.dtype != torch.uint8 or data.dim() != 2:
        raise ValueError(
            f"data must be a 2-D uint8 (chunk, lanes) tensor, got "
            f"{data.dtype} {tuple(data.shape)}"
        )
    if not data.is_contiguous():
        raise ValueError("data must be contiguous (column-major stripes)")
    chunk, lanes = data.shape
    if chunk == 0 or lanes == 0 or chunk % 32 or lanes % 32:
        raise ValueError(
            f"layout needs chunk % 32 == 0 and lanes % 32 == 0, got "
            f"chunk={chunk} lanes={lanes}"
        )
    return chunk, lanes


def shift_and_scan_words_plain(
    data: torch.Tensor, model: ShiftAndModel, coarse: bool
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on ``data``'s device: a loop
    over the chunk, vectorized over lanes.  The state is int64 masked to 32
    bits (PyTorch on the CPU has no ``<<`` for uint32)."""
    chunk, lanes = _check(data)
    dev = data.device
    table = torch.from_numpy(model.b_table.astype(np.int64)).to(dev)
    mb = int(model.match_bit)
    s = torch.zeros(lanes, dtype=torch.int64, device=dev)
    words = torch.empty((chunk // 32, lanes), dtype=torch.int64, device=dev)
    for w in range(chunk // 32):
        b = table[data[w * 32 : (w + 1) * 32].long()]  # (32, lanes) B-masks
        word = torch.zeros(lanes, dtype=torch.int64, device=dev)
        for t in range(32):
            s = (((s << 1) | 1) & _U32) & b[t]
            if coarse:
                word |= s
            else:
                word |= ((s & mb) != 0).to(torch.int64) << t
        words[w] = (word & mb) if coarse else word
    return words.to(torch.uint32)


def _lib():
    lib = _build.load("shift_and")
    fn = lib.dgrep_shift_and_scan
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_uint, ctypes.c_int,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def shift_and_scan_words(
    data: torch.Tensor, model: ShiftAndModel, coarse: bool
) -> torch.Tensor:
    """Scan words for ``data`` (see the module docstring).  CUDA tensors
    launch the kernel on the current stream (no synchronization; the
    output is allocated here); CPU tensors take the plain version."""
    chunk, lanes = _check(data)
    if data.device.type == "cpu":
        return shift_and_scan_words_plain(data, model, coarse)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    fn = _lib()
    out = torch.empty((chunk // 32, lanes), dtype=torch.uint32,
                      device=data.device)
    table = np.ascontiguousarray(model.b_table, dtype=np.uint32)
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        err = fn(data.data_ptr(), out.data_ptr(), table.ctypes.data,
                 chunk, lanes, int(model.match_bit), int(bool(coarse)),
                 stream)
    if err != 0:
        raise RuntimeError(
            f"shift_and CUDA kernel launch failed: cudaError {err} "
            f"(chunk={chunk}, lanes={lanes})"
        )
    _count_launch()
    return out
