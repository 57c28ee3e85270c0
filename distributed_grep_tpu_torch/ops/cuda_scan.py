"""Shift-And scan words: the CUDA kernel's wrapper and its plain version.

``shift_and_scan_words(data, model, coarse)`` takes the document's
stripes as they lie, a (lanes, chunk) uint8 tensor (``padded_stripes``,
ops/layout.py) whose rows may be further apart than ``chunk``
(``stride(0)``, the pitch, a multiple of 16; ``stride(1) == 1``), and
returns (chunk // 32, lanes) uint32 words, the same words as the
reference TPU kernel (``distributed_grep_tpu/ops/pallas_scan.py:_kernel``)
reshaped to that shape:

* coarse=True  -- word w of lane l is nonzero iff a candidate match ends
  in bytes 32w .. 32w+31 of stripe l (masked by the model's match bit);
* coarse=False -- bit t of word w is set iff a match ends at byte 32w+t.

A CUDA tensor launches the hand-written kernel (csrc/shift_and.cu); a CPU
tensor runs ``shift_and_scan_words_plain``.  Anything else raises, and so
does a tensor in another layout: the column layout (chunk, lanes) of the
other kernels seen as (lanes, chunk) has a last stride other than 1.  A
contiguous (chunk, lanes) tensor cannot be told from stripes by its shape:
callers hand stripes.

The kernel cuts each stripe into sub-stripes (more than one only when
the lanes leave SMs without a block); a sub-stripe after the first starts ``warmup_words(model)``
words early from the stripe-head state, which gives the full scan's words
from its own start on (the proof is in csrc/shift_and.cu).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from distributed_grep_tpu_torch.models.shift_and import ShiftAndModel
from distributed_grep_tpu_torch.ops import _build
from distributed_grep_tpu_torch.ops.layout import STRIPES

_U32 = 0xFFFFFFFF

LAYOUT = STRIPES  # the layout the kernel reads (ops/layout.py)

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


def check_stripes(data: torch.Tensor) -> tuple[int, int, int]:
    """(lanes, chunk, pitch) of a stripe tensor, or raise: 2-D uint8,
    last stride 1, the pitch ``stride(0)`` and the base address multiples
    of 16 (the kernels read 16 bytes at a time), lanes and chunk nonzero
    multiples of 32."""
    if not isinstance(data, torch.Tensor):
        raise TypeError(f"data must be a torch.Tensor, got {type(data).__name__}")
    if data.dtype != torch.uint8 or data.dim() != 2:
        raise ValueError(
            f"data must be a 2-D uint8 (lanes, chunk) tensor, got "
            f"{data.dtype} {tuple(data.shape)}"
        )
    lanes, chunk = data.shape
    if lanes == 0 or chunk == 0 or chunk % 32 or lanes % 32:
        raise ValueError(
            f"layout needs chunk % 32 == 0 and lanes % 32 == 0, got "
            f"lanes={lanes} chunk={chunk}"
        )
    pitch = data.stride(0)
    if data.stride(1) != 1 or pitch < chunk:
        raise ValueError(
            f"data must be (lanes, chunk) stripes with byte c of stripe l at "
            f"l * pitch + c, got strides {data.stride()}"
        )
    if pitch % 16 or data.data_ptr() % 16:
        raise ValueError(
            f"stripe pitch and base address must be multiples of 16 bytes, "
            f"got pitch {pitch}, address % 16 = {data.data_ptr() % 16}"
        )
    return lanes, chunk, pitch


def warmup_words(model: ShiftAndModel) -> int:
    """Words a sub-stripe steps before its own start: the match bit
    (bit m - 1) depends on the last m bytes alone, so m - 1 bytes of
    warm-up suffice, rounded up to whole words (1 for m > 1, 0 for m = 1)."""
    return -(-(int(model.match_bit).bit_length() - 1) // 32)


def shift_and_scan_words_plain(
    data: torch.Tensor, model: ShiftAndModel, coarse: bool
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on ``data``'s device: a loop
    over the chunk, vectorized over lanes.  The state is int64 masked to 32
    bits (PyTorch on the CPU has no ``<<`` for uint32)."""
    lanes, chunk, _pitch = check_stripes(data)
    dev = data.device
    table = torch.from_numpy(model.b_table.astype(np.int64)).to(dev)
    mb = int(model.match_bit)
    s = torch.zeros(lanes, dtype=torch.int64, device=dev)
    words = torch.empty((chunk // 32, lanes), dtype=torch.int64, device=dev)
    for w in range(chunk // 32):
        # (32, lanes) B-masks of the word's bytes
        b = table[data[:, w * 32 : (w + 1) * 32].long()].t()
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
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def shift_and_scan_words(
    data: torch.Tensor, model: ShiftAndModel, coarse: bool
) -> torch.Tensor:
    """Scan words for ``data`` (see the module docstring).  CUDA tensors
    launch the kernel on the current stream (no synchronization; the
    output is allocated here); CPU tensors take the plain version."""
    lanes, chunk, pitch = check_stripes(data)
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
                 chunk, lanes, pitch, int(model.match_bit),
                 int(bool(coarse)), warmup_words(model), stream)
    if err != 0:
        raise RuntimeError(
            f"shift_and CUDA kernel launch failed: cudaError {err} "
            f"(lanes={lanes}, chunk={chunk}, pitch={pitch})"
        )
    _count_launch()
    return out
