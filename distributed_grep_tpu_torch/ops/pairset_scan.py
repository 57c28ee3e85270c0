"""Pairset match words: the CUDA kernel's wrapper and its plain version.

``pairset_scan_words(data, model, out=None)`` takes the document's
stripes as they lie, a (lanes, chunk) uint8 tensor (``padded_stripes``,
ops/layout.py) whose rows may be further apart than ``chunk`` (the pitch,
checked by ``cuda_scan.check_stripes``), and returns (chunk // 32, lanes)
uint32 EXACT words: bit t of word w of lane l is set iff a member of the
1-2-byte set ends at byte 32w + t of stripe l (the model's ``ignore_case``
folds the data).  These are the words of the reference TPU kernel
(``distributed_grep_tpu/ops/pallas_pairset.py:_kernel``) reshaped from its
tile (chunk // 32, lanes // 128, 128) to the port's (chunk // 32, lanes).
With ``out`` the words are OR'd into that plane in place (a mixed set's
FDR candidate words) and ``out`` is returned.

A CUDA tensor launches the hand-written kernel (csrc/pairset.cu) with the
two 256-entry tables passed by value; a CPU tensor runs
``pairset_scan_words_plain``.  Anything else raises, and so does a tensor
in another layout (see ops/cuda_scan.py).  The kernel cuts each stripe
into sub-stripes where the lanes leave SMs without a block; one starting
at byte c0 > 0 seeds its previous byte with byte c0 - 1 of its stripe,
which gives the full scan's words (a bit depends on its byte and the one
before alone).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from distributed_grep_tpu_torch.models.pairset import NL, PairsetModel
from distributed_grep_tpu_torch.ops import _build
from distributed_grep_tpu_torch.ops.cuda_scan import check_stripes
from distributed_grep_tpu_torch.ops.fdr_scan import _check_out, or_into, pack_bits
from distributed_grep_tpu_torch.ops.layout import STRIPES

LAYOUT = STRIPES  # the layout the kernel reads (ops/layout.py)
# the csrc/ source this module builds and launches
LIBRARY = "pairset"

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


def pairset_scan_words_plain(
    data: torch.Tensor, model: PairsetModel
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on ``data``'s device,
    vectorized over bytes and lanes (int64 arithmetic)."""
    lanes, _chunk, _pitch = check_stripes(data)
    dev = data.device
    b = data.t().to(torch.int64)  # (chunk, lanes)
    if model.ignore_case:
        b = torch.where((b >= 65) & (b <= 90), b + 32, b)
    prev = torch.cat([torch.full((1, lanes), NL, dtype=torch.int64,
                                 device=dev), b[:-1]])
    rowcls = torch.from_numpy(model.rowcls.astype(np.int64)).to(dev)
    words = torch.from_numpy(model.words.astype(np.int64)).to(dev)
    cls_idx, word_idx = (b, prev) if model.transposed else (prev, b)
    return pack_bits(((words[word_idx] >> rowcls[cls_idx]) & 1) != 0)


def _lib():
    lib = _build.load(LIBRARY)
    fn = lib.dgrep_pairset_scan
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def pairset_scan_words(
    data: torch.Tensor, model: PairsetModel, out: torch.Tensor | None = None
) -> torch.Tensor:
    """Match-end words for ``data`` (see the module docstring).  CUDA
    tensors launch the kernel on the current stream (no synchronization);
    CPU tensors take the plain version."""
    lanes, chunk, pitch = check_stripes(data)
    shape = (chunk // 32, lanes)
    if out is not None:
        _check_out(out, shape, data.device)
    if data.device.type == "cpu":
        return or_into(out, pairset_scan_words_plain(data, model))
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    fn = _lib()
    res = (torch.empty(shape, dtype=torch.uint32, device=data.device)
           if out is None else out)
    rowcls = np.ascontiguousarray(model.rowcls, dtype=np.uint32)
    words = np.ascontiguousarray(model.words, dtype=np.uint32)
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        err = fn(data.data_ptr(), res.data_ptr(), rowcls.ctypes.data,
                 words.ctypes.data, chunk, lanes, pitch,
                 int(model.transposed), int(model.ignore_case),
                 int(out is not None), stream)
    if err != 0:
        raise RuntimeError(
            f"pairset CUDA kernel launch failed: cudaError {err} "
            f"(lanes={lanes}, chunk={chunk}, pitch={pitch})"
        )
    _count_launch()
    return res
