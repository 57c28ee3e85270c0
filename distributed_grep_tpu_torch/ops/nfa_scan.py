"""Glushkov NFA scan words: the CUDA kernel's wrapper and its plain version.

``nfa_scan_words(data, model)`` takes the (chunk, lanes) uint8 stripe
layout (ops/layout.py) and returns (chunk // 32, lanes) uint32 EXACT
words: bit t of word w of lane l is set iff a match of ``model`` ends at
byte 32w + t of stripe l.  These are the words of the reference TPU kernel
(``distributed_grep_tpu/ops/pallas_nfa.py:_kernel``) reshaped from its
tile (chunk // 32, lanes // 128, 128) to the port's (chunk // 32, lanes).
Each stripe starts from the empty state at a line start, so a stripe's
head line is re-checked on the host (ops/device_scan.py).

A CUDA tensor launches the hand-written kernel (csrc/nfa.cu) with the
model's plan packed into one buffer (``pack_plan``: a header the launcher
passes as a kernel parameter, then B interleaved by byte and the
specials' exception tables, which the kernel keeps in shared memory;
uploaded once per model and card); a CPU tensor runs
``nfa_scan_words_plain``.
Anything else raises.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from distributed_grep_tpu_torch.models.nfa import GlushkovModel
from distributed_grep_tpu_torch.ops import _build
from distributed_grep_tpu_torch.ops.cuda_scan import _check
from distributed_grep_tpu_torch.ops.layout import COLUMNS

NL = 0x0A
MAX_WORDS = 4
# The plan buffer's layout in uint32 words; csrc/nfa.cu reads the same.
_CHAIN, _INIT_FLOAT, _INIT_ANCHOR, _FINAL = 0, 4, 8, 12
_N_TABLES, _N_SHARED, _TAB_WORD, _TAB_SLICE = 16, 17, 32, 48
_HEADER = 64  # the shared part (B, then the exception tables) starts here

LAYOUT = COLUMNS  # the layout the kernel reads (ops/layout.py)
# the csrc/ source this module builds and launches
LIBRARY = "nfa"

# Launch count of the CUDA kernel: incremented once per launch, nowhere
# else.  chip_smoke.py zeroes it before the main path and reads it after.
_count_lock = threading.Lock()
launches = 0
_plan_lock = threading.Lock()


def reset_launches() -> None:
    global launches
    with _count_lock:
        launches = 0


def _count_launch() -> None:
    global launches
    with _count_lock:
        launches += 1


def b_table(model: GlushkovModel) -> np.ndarray:
    """(n_words, 256) uint32: word w of B[byte] -- the reference's
    ``build_b_tables`` before its lo/hi split into 128-lane tiles."""
    full = np.zeros((model.n_words, 256), dtype=np.uint32)
    for ranges, pos_words in zip(model.cls_ranges, model.cls_pos_words):
        for wi, m in pos_words:
            for lo, hi in ranges:
                full[wi, lo : hi + 1] |= np.uint32(m)
    return full


def entry_words(n_words: int) -> int:
    """Words per B or table entry: n_words padded to a 32-, 64- or 128-bit
    shared-memory load."""
    return 1 if n_words == 1 else 2 if n_words == 2 else 4


def exception_tables(model: GlushkovModel) -> dict[tuple[int, int], np.ndarray]:
    """{(w, s): (256, n_words) uint32} for every byte slice s of a state
    word w that holds special source bits: entry v is the OR of ``follow``
    over the specials (w, j, follow) with 8s <= j < 8s + 8 and bit j - 8s
    set in v.  Slices in (w, s) order."""
    nw = model.n_words
    values = np.arange(256)
    tables: dict[tuple[int, int], np.ndarray] = {}
    for wp, jp, flist in model.specials:
        key = (wp, jp // 8)
        tab = tables.setdefault(key, np.zeros((256, nw), dtype=np.uint32))
        follow = np.zeros(nw, dtype=np.uint32)
        for wj, m in flist:
            follow[wj] = m
        tab[(values >> (jp % 8)) & 1 == 1] |= follow
    return dict(sorted(tables.items()))


def pack_plan(model: GlushkovModel) -> np.ndarray:
    """The kernel's plan as one uint32 array (layout in csrc/nfa.cu): the
    header (masks, the tables' words and slices), then B[byte] interleaved
    by byte and the exception tables in (word, slice) order, each entry
    ``entry_words`` words."""
    nw = model.n_words
    if not 1 <= nw <= MAX_WORDS:
        raise ValueError(f"model has {nw} state words; the kernel takes "
                         f"1..{MAX_WORDS}")
    s = entry_words(nw)
    tables = exception_tables(model)
    n_shared = (1 + len(tables)) * 256 * s
    plan = np.zeros(_HEADER + n_shared, dtype=np.uint32)
    plan[_CHAIN : _CHAIN + nw] = model.chain_src
    plan[_INIT_FLOAT : _INIT_FLOAT + nw] = model.init_float_words
    plan[_INIT_ANCHOR : _INIT_ANCHOR + nw] = model.init_anchor_words
    plan[_FINAL : _FINAL + nw] = model.final_words
    plan[_N_TABLES], plan[_N_SHARED] = len(tables), n_shared
    shared = plan[_HEADER:].reshape(1 + len(tables), 256, s)
    shared[0, :, :nw] = b_table(model).T
    for i, ((w, sl), tab) in enumerate(tables.items()):
        plan[_TAB_WORD + i], plan[_TAB_SLICE + i] = w, sl
        shared[1 + i, :, :nw] = tab
    return plan


def nfa_scan_words_plain(
    data: torch.Tensor, model: GlushkovModel, live: list | None = None
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on ``data``'s device: a loop
    over the chunk, vectorized over lanes, the recurrence of csrc/nfa.cu.
    The state words are int64 masked to 32 bits (PyTorch on the CPU has no
    ``<<`` for uint32).

    ``live`` (a list of n_words ints, optional) receives, per state word,
    the number of (byte, lane) steps at which some special source bit of
    that word was set (chip_smoke.py prices these steps in its NFA
    bound)."""
    chunk, lanes = _check(data)
    dev = data.device
    nw = model.n_words
    table = torch.from_numpy(b_table(model).astype(np.int64)).to(dev)
    chain, init_f = model.chain_src, model.init_float_words
    init_a, final = model.init_anchor_words, model.final_words
    smask = [0] * nw
    for wp, jp, _ in model.specials:
        smask[wp] |= 1 << jp
    zero = torch.zeros(lanes, dtype=torch.int64, device=dev)
    live_n = torch.zeros(nw, dtype=torch.int64, device=dev)
    d = [zero] * nw
    prev_nl = torch.ones(lanes, dtype=torch.bool, device=dev)
    words = torch.empty((chunk // 32, lanes), dtype=torch.int64, device=dev)
    for w in range(chunk // 32):
        rows = data[w * 32 : (w + 1) * 32].long()  # (32, lanes) bytes
        bm = table[:, rows]  # (n_words, 32, lanes) B-masks
        word = torch.zeros(lanes, dtype=torch.int64, device=dev)
        for t in range(32):
            if live is not None:
                for wi in range(nw):
                    if smask[wi]:
                        live_n[wi] += ((d[wi] & smask[wi]) != 0).sum()
            reached = []
            for wi in range(nw):
                r = ((d[wi] & chain[wi]) << 1) | init_f[wi]
                if init_a[wi]:
                    r = r | torch.where(prev_nl, init_a[wi], 0)
                reached.append(r)
            for wp, jp, flist in model.specials:
                sel = -((d[wp] >> jp) & 1)  # all ones where bit jp is set
                for wj, m in flist:
                    reached[wj] = reached[wj] | (sel & m)
            d = [reached[wi] & bm[wi, t] for wi in range(nw)]
            hit = d[0] & final[0]
            for wi in range(1, nw):
                hit = hit | (d[wi] & final[wi])
            word |= (hit != 0).to(torch.int64) << t
            prev_nl = rows[t] == NL
        words[w] = word
    if live is not None:
        live[:] = live_n.tolist()
    return words.to(torch.uint32)


def _lib():
    lib = _build.load(LIBRARY)
    fn = lib.dgrep_nfa_scan
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def _plans(model: GlushkovModel, device: torch.device):
    """The model's packed plan on the host and on ``device``, packed and
    uploaded once and kept on the model."""
    with _plan_lock:
        cache = model.__dict__.setdefault("_device_plans", {})
        host = cache.get("host")
        if host is None:
            host = cache["host"] = pack_plan(model)
        plan = cache.get(device)
        if plan is None:
            plan = torch.from_numpy(host.view(np.int32)).to(device)
            cache[device] = plan
        return host, plan


def nfa_scan_words(data: torch.Tensor, model: GlushkovModel) -> torch.Tensor:
    """Exact match-end words for ``data`` (see the module docstring).
    CUDA tensors launch the kernel on the current stream (no
    synchronization; the output is allocated here); CPU tensors take the
    plain version."""
    chunk, lanes = _check(data)
    if data.device.type == "cpu":
        return nfa_scan_words_plain(data, model)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    fn = _lib()
    host, plan = _plans(model, data.device)
    out = torch.empty((chunk // 32, lanes), dtype=torch.uint32,
                      device=data.device)
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        err = fn(data.data_ptr(), out.data_ptr(), host.ctypes.data,
                 plan.data_ptr(), chunk, lanes, model.n_words, stream)
    if err != 0:
        raise RuntimeError(
            f"nfa CUDA kernel launch failed: cudaError {err} (chunk={chunk}, "
            f"lanes={lanes}, n_words={model.n_words}, "
            f"specials={model.n_specials})"
        )
    _count_launch()
    return out
