"""FDR filter words: the CUDA kernel's wrapper and its plain version.

``fdr_scan_words(data, bank, fold_case, out=None)`` takes the (chunk,
lanes) uint8 stripe layout (ops/layout.py) and returns (chunk // 32,
lanes) uint32 CANDIDATE words: bit t of word w of lane l is set iff the
bank's pipeline is nonzero at byte 32w + t of stripe l.  These are the
words of the reference TPU kernel
(``distributed_grep_tpu/ops/pallas_fdr.py:_kernel``) reshaped from its
tile (chunk // 32, lanes // 128, 128) to the port's (chunk // 32, lanes).
With ``out`` the words are OR'd into that plane in place (the later
banks of a set, then its pairset sidecar) and ``out`` is returned.

A CUDA tensor launches the hand-written kernel (csrc/fdr.cu), one thread
per output word, with the bank packed into one buffer (``pack_bank``: the
check descriptors, which the launcher passes as a kernel parameter, then
the tables, which each block copies to shared memory; packed and uploaded
once per bank and card); a CPU tensor runs ``fdr_scan_words_plain``.
Anything else raises.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from distributed_grep_tpu_torch.models.fdr import HASHES, MAX_DEPTHS, FdrBank
from distributed_grep_tpu_torch.ops import _build
from distributed_grep_tpu_torch.ops.cuda_scan import _check
from distributed_grep_tpu_torch.ops.layout import COLUMNS
from distributed_grep_tpu_torch.utils import lockdep

# The plan buffer's layout in uint32 words; csrc/fdr.cu reads the same.
_M, _N_CHECKS, _N_TABLE, _SLOT_START = 0, 1, 2, 8
_MUL_PREV, _MUL_BYTE, _DMASK, _OFF = 16, 32, 48, 64
_TABLES = 128
MAX_CHECKS = 16
MAX_TABLE = 64 * 128

LAYOUT = COLUMNS  # the layout the kernel reads (ops/layout.py)
# the csrc/ source this module builds and launches
LIBRARY = "fdr"

# Launch count of the CUDA kernel: incremented once per launch, nowhere
# else.  chip_smoke.py zeroes it before the main path and reads it after.
_count_lock = threading.Lock()
launches = 0
_plan_lock = lockdep.make_lock("fdr-plans", io_ok=True)


def reset_launches() -> None:
    global launches
    with _count_lock:
        launches = 0


def _count_launch() -> None:
    global launches
    with _count_lock:
        launches += 1


def pack_bank(bank: FdrBank) -> np.ndarray:
    """The kernel's plan as one uint32 array (layout in csrc/fdr.cu): a
    header with the checks sorted by slot, each check's hash multipliers
    (its family's), domain mask and table offset, then the tables in that
    order, padded to a multiple of 4 words."""
    if not 1 <= bank.m <= MAX_DEPTHS or bank.n_checks > MAX_CHECKS:
        raise ValueError(f"bank has m={bank.m} and {bank.n_checks} checks; "
                         f"the kernel takes 1..{MAX_DEPTHS} slots and <= "
                         f"{MAX_CHECKS} checks")
    order = sorted(range(bank.n_checks), key=lambda i: bank.checks[i][0])
    total = sum(bank.checks[i][2] for i in order)
    if total > MAX_TABLE:
        raise ValueError(f"bank tables hold {total} entries; the kernel "
                         f"takes <= {MAX_TABLE}")
    n_table = -(-total // 4) * 4
    plan = np.zeros(_TABLES + n_table, dtype=np.uint32)
    plan[_M], plan[_N_CHECKS], plan[_N_TABLE] = bank.m, bank.n_checks, n_table
    counts = np.bincount([bank.checks[i][0] for i in order],
                         minlength=bank.m)
    plan[_SLOT_START : _SLOT_START + bank.m + 1] = np.concatenate(
        ([0], np.cumsum(counts)))
    plan[_SLOT_START + bank.m + 1 : _MUL_PREV] = bank.n_checks
    off = 0
    for j, i in enumerate(order):
        _slot, fam, dom = bank.checks[i]
        plan[_MUL_PREV + j], plan[_MUL_BYTE + j] = HASHES[fam]
        plan[_DMASK + j], plan[_OFF + j] = dom - 1, off
        plan[_TABLES + off : _TABLES + off + dom] = bank.tables[i]
        off += dom
    return plan


def pack_bits(hit: torch.Tensor) -> torch.Tensor:
    """(chunk, lanes) bool -> (chunk // 32, lanes) uint32: bit t of word w
    is row 32w + t."""
    chunk, lanes = hit.shape
    shifts = torch.arange(32, device=hit.device, dtype=torch.int64)
    bits = hit.view(chunk // 32, 32, lanes).to(torch.int64) << shifts.view(
        1, 32, 1)
    return bits.sum(dim=1).to(torch.uint32)


def or_into(out: torch.Tensor | None, words: torch.Tensor) -> torch.Tensor:
    """``out |= words`` in place (``words`` when ``out`` is None); the OR
    runs on int32 views, which every PyTorch build has for uint32 bits."""
    if out is None:
        return words
    _check_out(out, words.shape, words.device)
    out.view(torch.int32).bitwise_or_(words.view(torch.int32))
    return out


def _check_out(out: torch.Tensor, shape, device) -> None:
    if (out.dtype != torch.uint32 or tuple(out.shape) != tuple(shape)
            or out.device != device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous uint32 {tuple(shape)} "
                         f"tensor on {device}, got {out.dtype} "
                         f"{tuple(out.shape)} on {out.device}")


def fdr_scan_words_plain(
    data: torch.Tensor, bank: FdrBank, fold_case: bool = False
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on ``data``'s device,
    vectorized over bytes and lanes: every slot's mask M_k at every byte,
    then V_{m-1}(t) = AND over k of M_k(t - (m-1-k)), with all ones before
    the stripe head.  int64 arithmetic (PyTorch on the CPU has no ``<<``
    for uint32)."""
    chunk, lanes = _check(data)
    dev = data.device
    b = data.to(torch.int64)
    if fold_case:
        b = torch.where((b >= 65) & (b <= 90), b + 32, b)
    prev = torch.cat([torch.zeros((1, lanes), dtype=torch.int64, device=dev),
                      b[:-1]])
    hashes = [(prev * a) ^ (b * c) for a, c in HASHES]
    masks: list[torch.Tensor | None] = [None] * bank.m
    for (slot, fam, dom), table in zip(bank.checks, bank.tables):
        t = torch.from_numpy(table.astype(np.int64)).to(dev)
        r = t[hashes[fam] & (dom - 1)]
        masks[slot] = r if masks[slot] is None else masks[slot] & r
    v = None
    for k, mk in enumerate(masks):
        if mk is None:
            continue
        s = bank.m - 1 - k
        if s:
            mk = torch.cat([torch.full((s, lanes), 0xFFFFFFFF,
                                       dtype=torch.int64, device=dev),
                            mk[:-s]])
        v = mk if v is None else v & mk
    return pack_bits(v != 0)


def _lib():
    lib = _build.load(LIBRARY)
    fn = lib.dgrep_fdr_scan
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def _plans(bank: FdrBank, device: torch.device):
    """The bank's packed plan on the host and on ``device``, packed and
    uploaded once and kept on the bank."""
    with _plan_lock:
        cache = bank.__dict__.setdefault("_device_plans", {})
        host = cache.get("host")
        if host is None:
            host = cache["host"] = pack_bank(bank)
        plan = cache.get(device)
        if plan is None:
            plan = torch.from_numpy(host.view(np.int32)).to(device)
            cache[device] = plan
        return host, plan


def fdr_scan_words(
    data: torch.Tensor, bank: FdrBank, fold_case: bool = False,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Candidate words for ``data`` (see the module docstring).  CUDA
    tensors launch the kernel on the current stream (no synchronization);
    CPU tensors take the plain version."""
    chunk, lanes = _check(data)
    shape = (chunk // 32, lanes)
    if out is not None:
        _check_out(out, shape, data.device)
    if data.device.type == "cpu":
        return or_into(out, fdr_scan_words_plain(data, bank, fold_case))
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    fn = _lib()
    host, plan = _plans(bank, data.device)
    if out is None:
        res = torch.empty(shape, dtype=torch.uint32, device=data.device)
    else:
        res = out
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        err = fn(data.data_ptr(), res.data_ptr(), host.ctypes.data,
                 plan.data_ptr(), chunk, lanes, int(bool(fold_case)),
                 int(out is not None), stream)
    if err != 0:
        raise RuntimeError(
            f"fdr CUDA kernel launch failed: cudaError {err} (chunk={chunk}, "
            f"lanes={lanes}, m={bank.m}, checks={bank.n_checks})"
        )
    _count_launch()
    return res
