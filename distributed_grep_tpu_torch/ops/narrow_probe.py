"""Narrow-width probe words: the CUDA kernel's wrapper and its plain version.

``narrow_probe_words(data, width)`` takes the (chunk, lanes) uint8 stripe
layout (ops/layout.py) and a state width ("i32", "i16" or "i8", the
reference's names) and returns (chunk // 32, lanes) uint32 coarse words:
word w of lane l is nonzero iff 'volcano' ends in bytes 32w .. 32w+31 of
stripe l.  These are the words of the reference's probe kernel
(``benchmarks/probe_narrow.py:_mini_kernel``): a Shift-And-shaped loop
over six (byte, mask) classes with the state kept at the chosen width,
starting from 0 in every lane; its (chunk // 32, lanes // 128, 128) output
is the same memory.  All three widths give the same words: the state
never holds a bit above the match bit (1 << 6).

A CUDA tensor launches the hand-written kernel (csrc/probe_narrow.cu); a
CPU tensor runs ``narrow_probe_words_plain``.  Anything else raises.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from distributed_grep_tpu_torch.ops import _build
from distributed_grep_tpu_torch.ops.cuda_scan import _check

# (byte, mask) classes, the match bit and the wildcard mask of the
# reference probe (benchmarks/probe_narrow.py:56-60): 'volcano' with the
# two 'o's sharing one class.
CLASSES = ((ord("v"), 0b0000001), (ord("o"), 0b1000010),
           (ord("l"), 0b0000100), (ord("c"), 0b0001000),
           (ord("a"), 0b0010000), (ord("n"), 0b0100000))
MATCH_BIT = 1 << 6
WILDCARD = 0
WIDTHS = {"i32": 32, "i16": 16, "i8": 8}

# Launch count of the CUDA kernel: incremented once per launch, nowhere
# else.  chip_smoke.py zeroes it before a path and reads it after.
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


def _bits(width: str) -> int:
    if width not in WIDTHS:
        raise ValueError(f"width must be one of {sorted(WIDTHS)}, got {width!r}")
    return WIDTHS[width]


def narrow_probe_words_plain(data: torch.Tensor, width: str) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on ``data``'s device: the
    class masks of every byte at once, then a loop over the chunk
    vectorized over lanes.  The state is int64 masked to the width
    (PyTorch on the CPU has no ``<<`` for uint32)."""
    chunk, lanes = _check(data)
    full = (1 << _bits(width)) - 1
    b = data.to(torch.int64)
    bmask = torch.full_like(b, WILDCARD)
    for val, mask in CLASSES:
        bmask |= (b == val).to(torch.int64) * mask
    bmask &= full
    s = torch.zeros(lanes, dtype=torch.int64, device=data.device)
    words = torch.empty((chunk // 32, lanes), dtype=torch.int64,
                        device=data.device)
    for w in range(chunk // 32):
        word = torch.zeros_like(s)
        for t in range(w * 32, w * 32 + 32):
            s = (((s << 1) | 1) & full) & bmask[t]
            word |= s
        words[w] = word & MATCH_BIT
    return words.to(torch.uint32)


def _lib():
    lib = _build.load("probe_narrow")
    fn = lib.dgrep_narrow_probe
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def narrow_probe_words(data: torch.Tensor, width: str) -> torch.Tensor:
    """Coarse probe words for ``data`` (see the module docstring).  CUDA
    tensors launch the kernel on the current stream (no synchronization;
    the output is allocated here); CPU tensors take the plain version."""
    chunk, lanes = _check(data)
    bits = _bits(width)
    if data.device.type == "cpu":
        return narrow_probe_words_plain(data, width)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    fn = _lib()
    out = torch.empty((chunk // 32, lanes), dtype=torch.uint32,
                      device=data.device)
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        err = fn(data.data_ptr(), out.data_ptr(), chunk, lanes, bits, stream)
    if err != 0:
        raise RuntimeError(
            f"narrow probe CUDA kernel launch failed: cudaError {err} "
            f"(chunk={chunk}, lanes={lanes}, width={width})"
        )
    _count_launch()
    return out
