"""One-hot membership product: the CUDA kernel's wrapper and its plain version.

``mxu_dot(data, member)`` takes the (chunk, lanes) uint8 stripe layout
(ops/layout.py, lanes % 4096 == 0, chunk % 512 == 0) and a (256, 128) int8
membership matrix and returns (lanes // 4096, 128, 128) int32:

    out[li, l, j] = sum over t < chunk, s < 32 of
                    member[data[t, li*4096 + s*128 + l], j]

the one-hot product of the reference's MXU probe
(``benchmarks/kernel_compare.py:bench_mxu_dot``'s ``kernel``): per lane
block, one-hot(bytes) (128 x 256) @ member (256 x 128) summed over every
step.  The reference keeps only the last lane block's sum (its output block
is re-zeroed at the start of each lane block), which is ``out[-1]`` here.

A CUDA tensor launches the hand-written tensor-core kernel
(csrc/mxu_dot.cu); a CPU tensor runs ``mxu_dot_plain``, which counts each
lane's byte values and multiplies the counts by ``member``: the same
numbers, by a histogram, not a one-hot product.  Anything else raises.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from distributed_grep_tpu_torch.ops import _build

LANE_BLOCK = 4096  # 32 sublanes x 128 lanes, the reference's tile
COLS = 128
VALUES = 256
CHUNK_MULTIPLE = 512  # the reference's 16 words x 32 steps per grid step
STAGE_STEPS = 32  # csrc/mxu_dot.cu stages 32 (t, s) steps per round

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


def probe_member() -> np.ndarray:
    """The reference probe's membership matrix
    (``benchmarks/kernel_compare.py:187-190``)."""
    rng = np.random.default_rng(0)
    return rng.integers(0, 2, size=(VALUES, COLS), dtype=np.int8)


def _check(data: torch.Tensor, member: torch.Tensor) -> tuple[int, int]:
    if not isinstance(data, torch.Tensor) or not isinstance(member, torch.Tensor):
        raise TypeError("data and member must be torch.Tensors")
    if data.dtype != torch.uint8 or data.dim() != 2 or not data.is_contiguous():
        raise ValueError(
            f"data must be a contiguous 2-D uint8 (chunk, lanes) tensor, got "
            f"{data.dtype} {tuple(data.shape)}"
        )
    chunk, lanes = data.shape
    if chunk == 0 or lanes == 0 or chunk % CHUNK_MULTIPLE or lanes % LANE_BLOCK:
        raise ValueError(
            f"layout needs chunk % {CHUNK_MULTIPLE} == 0 and lanes % "
            f"{LANE_BLOCK} == 0, got chunk={chunk} lanes={lanes}"
        )
    if (member.dtype != torch.int8 or tuple(member.shape) != (VALUES, COLS)
            or not member.is_contiguous()):
        raise ValueError(
            f"member must be a contiguous (256, 128) int8 tensor, got "
            f"{member.dtype} {tuple(member.shape)}"
        )
    if member.device != data.device:
        raise ValueError(f"member on {member.device}, data on {data.device}")
    return chunk, lanes


def _byte_counts(data: torch.Tensor) -> torch.Tensor:
    """(lanes // 4096, 128, 256) int64: how often each byte value occurs in
    each lane column l over every (t, s) of each lane block."""
    chunk, lanes = data.shape
    nb = lanes // LANE_BLOCK
    x = data.view(chunk, nb, 32, COLS).to(torch.int64)
    col = (torch.arange(nb, device=data.device)[:, None] * COLS
           + torch.arange(COLS, device=data.device)[None, :]) * VALUES
    idx = (x + col[None, :, None, :]).reshape(-1)
    return torch.bincount(idx, minlength=nb * COLS * VALUES).view(
        nb, COLS, VALUES)


def mxu_dot_plain(data: torch.Tensor, member: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on ``data``'s device: byte
    counts @ member in float64 (every value an integer below 2^53, so
    exact; CUDA has no int64 matmul)."""
    _check(data, member)
    counts = _byte_counts(data).to(torch.float64)
    return (counts @ member.to(torch.float64)).to(torch.int32)


def default_splits(chunk: int, lanes: int, device: torch.device) -> int:
    """Blocks per lane block: about four blocks per SM over the grid, and
    at least one staged round of steps per block."""
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    nb = lanes // LANE_BLOCK
    return max(1, min(chunk * 32 // STAGE_STEPS, -(-4 * n_sm // nb)))


def _lib():
    lib = _build.load("mxu_dot")
    fn = lib.dgrep_mxu_dot
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def mxu_dot(data: torch.Tensor, member: torch.Tensor,
            splits: int | None = None) -> torch.Tensor:
    """The one-hot product for ``data`` (see the module docstring).  CUDA
    tensors launch the kernel on the current stream (no synchronization;
    the zeroed output is allocated here), ``splits`` blocks per lane block
    (default ``default_splits``); CPU tensors take the plain version."""
    chunk, lanes = _check(data, member)
    if data.device.type == "cpu":
        return mxu_dot_plain(data, member)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    if splits is None:
        splits = default_splits(chunk, lanes, data.device)
    if not 1 <= splits <= chunk * 32:
        raise ValueError(f"splits must be in 1..{chunk * 32}, got {splits}")
    if data.data_ptr() % 16:
        raise ValueError("data must be 16-byte aligned")
    fn = _lib()
    out = torch.zeros((lanes // LANE_BLOCK, COLS, COLS), dtype=torch.int32,
                      device=data.device)
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        err = fn(data.data_ptr(), member.data_ptr(), out.data_ptr(), chunk,
                 lanes, splits, stream)
    if err != 0:
        raise RuntimeError(
            f"mxu_dot CUDA kernel launch failed: cudaError {err} "
            f"(chunk={chunk}, lanes={lanes}, splits={splits})"
        )
    _count_launch()
    return out
