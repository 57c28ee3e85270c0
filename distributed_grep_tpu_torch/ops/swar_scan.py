"""SWAR Shift-And words: the CUDA kernel's wrapper and its plain version.

``swar_scan_words(data, model)`` takes the document's stripes as they
lie, a (lanes, chunk) uint8 tensor (``padded_stripes``, ops/layout.py)
whose rows may be further apart than ``chunk`` (the pitch, checked by
``cuda_scan.check_stripes``), packs stripes 4j .. 4j + 3 into element j
-- byte k is stripe 4j + k, the reference's ``swar_pack_tiles`` -- and
returns (chunk // 32, lanes // 4) uint32 COARSE words: byte k of word w of
element j is nonzero iff a candidate match of ``model`` ends in bytes
32w .. 32w+31 of stripe 4j + k (it equals that stripe's unpacked coarse
word, ops/cuda_scan.py).  These are the words of the
reference TPU kernel (``distributed_grep_tpu/ops/pallas_scan.py:
_swar_kernel``) reshaped from its tile (chunk // 32, lanes // 512, 128) to
(chunk // 32, lanes // 4).  ``ops/sparse.span_starts_from_packed_words``
decodes them.

The model needs at most SWAR_MAX_SYMBOLS (8) symbols, so that its state
and match bit fit one byte.  The engine routes here only models that pass
``models/shift_and.swar_values`` (the reference's rule); the kernel itself
looks every class up in a table and takes any model of at most 8 symbols.

A CUDA tensor launches the hand-written kernel (csrc/shift_and_swar.cu); a
CPU tensor runs ``swar_scan_words_plain``.  Anything else raises, and so
does a tensor in another layout.  The kernel cuts each stripe into
sub-stripes until every SM has two blocks; one after the first starts
``warmup_words(model)`` words early from state 0, as the Shift-And
kernel's do (ops/cuda_scan.py).
``swar_enabled()`` reads ``DGREP_SWAR`` (default off, as in the
reference).
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np
import torch

from distributed_grep_tpu_torch.models.shift_and import (
    SWAR_MAX_SYMBOLS,
    ShiftAndModel,
)
from distributed_grep_tpu_torch.ops import _build
# a packed stripe's state byte depends on its last m <= 8 bytes alone, as
# the unpacked state does: the Shift-And kernel's warm-up
from distributed_grep_tpu_torch.ops.cuda_scan import (
    check_stripes,
    warmup_words,
)
from distributed_grep_tpu_torch.ops.layout import STRIPES

_U32 = 0xFFFFFFFF
_ONES = 0x01010101

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


def swar_enabled() -> bool:
    """``DGREP_SWAR=1`` routes eligible Shift-And scans through the packed
    kernel; read at scan time.  Default off, as in the reference."""
    return os.environ.get("DGREP_SWAR", "") == "1"


def _check_model(model: ShiftAndModel) -> None:
    if model.length > SWAR_MAX_SYMBOLS:
        raise ValueError(
            f"the SWAR kernel holds at most {SWAR_MAX_SYMBOLS} symbols per "
            f"stripe, got {model.length}"
        )


def _masks(model: ShiftAndModel) -> np.ndarray:
    """The 8-bit B-mask of every byte (the model has at most 8 symbols)."""
    return np.ascontiguousarray(model.b_table & 0xFF, dtype=np.uint8)


def swar_scan_words_plain(data: torch.Tensor,
                          model: ShiftAndModel) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on ``data``'s device: the
    same packed step on the column copy of the stripes read as uint32 (byte
    k of element j is stripe 4j + k), a loop over the chunk vectorized over
    packed elements.  int64 arithmetic masked to 32 bits (PyTorch on the
    CPU has no ``<<`` for uint32)."""
    lanes, chunk, _pitch = check_stripes(data)
    _check_model(model)
    dev = data.device
    packed = data.t().contiguous().view(torch.int32)  # (chunk, lanes // 4)
    x = packed.to(torch.int64) & _U32
    t8 = torch.from_numpy(_masks(model).astype(np.int64)).to(dev)
    match_rep = int(model.match_bit) * _ONES
    s = torch.zeros(lanes // 4, dtype=torch.int64, device=dev)
    words = torch.empty((chunk // 32, lanes // 4), dtype=torch.int64,
                        device=dev)
    for w in range(chunk // 32):
        v = x[w * 32 : (w + 1) * 32]
        bm = (t8[v & 0xFF] | (t8[(v >> 8) & 0xFF] << 8)
              | (t8[(v >> 16) & 0xFF] << 16) | (t8[v >> 24] << 24))
        word = torch.zeros_like(s)
        for t in range(32):
            s = ((s << 1) | _ONES) & bm[t]
            word |= s
        words[w] = word & match_rep
    return words.to(torch.uint32)


def _lib():
    lib = _build.load("shift_and_swar")
    fn = lib.dgrep_swar_scan
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint,
            ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def swar_scan_words(data: torch.Tensor, model: ShiftAndModel) -> torch.Tensor:
    """Packed coarse words for ``data`` (see the module docstring).  CUDA
    tensors launch the kernel on the current stream (no synchronization;
    the output is allocated here); CPU tensors take the plain version."""
    lanes, chunk, pitch = check_stripes(data)
    _check_model(model)
    if data.device.type == "cpu":
        return swar_scan_words_plain(data, model)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    fn = _lib()
    out = torch.empty((chunk // 32, lanes // 4), dtype=torch.uint32,
                      device=data.device)
    masks = _masks(model)
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        err = fn(data.data_ptr(), out.data_ptr(), masks.ctypes.data, chunk,
                 lanes, pitch, int(model.match_bit), warmup_words(model),
                 stream)
    if err != 0:
        raise RuntimeError(
            f"shift_and_swar CUDA kernel launch failed: cudaError {err} "
            f"(lanes={lanes}, chunk={chunk}, pitch={pitch})"
        )
    _count_launch()
    return out
