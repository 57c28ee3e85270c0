"""Table-DFA match words: the CUDA kernel's wrapper and its plain version.

``dfa_scan_words(data, table)`` takes the document's stripes as they lie,
a (lanes, chunk) uint8 tensor with a pitch (``check_stripes``,
ops/cuda_scan.py), and a ``models/dfa.DfaTable`` (a compiled pattern, or
an Aho-Corasick bank of models/aho.py), and returns (chunk // 32, lanes)
uint32 EXACT words: bit t of word w of lane l is set iff, every stripe
walked from ``table.start``, the state after byte c = 32w + t of stripe l
accepts, or accepts at end of line (``accept_eol``) and byte c + 1 of the
stripe is '\\n'.  The stripe's last byte counts as followed by '\\n'.
These are the bits of the reference's XLA device scan
(``distributed_grep_tpu/ops/scan_jnp.py:_dfa_scan_core``, the recurrence
``dfa_scan_body``), there packed (chunk, lanes // 8) uint8 with bit k of
byte g for lane 8g + k, here as the port's words.

A CUDA tensor launches the hand-written kernel (csrc/dfa.cu; the table in
shared memory up to SMEM_TABLE_BYTES, else read through the L2); a CPU
tensor runs ``dfa_scan_words_plain``.  Anything else raises.
``dfa_scan_bank_words(data, tables)`` launches once a table and ORs the
words (the reference's one pass a bank).  Each table's packed entries are
uploaded once per device and kept beside the table (``device_table``), as
the reference keeps its ``_device_tables`` per engine and device.
``dfa_scan_words(..., with_exits=True)`` also returns each stripe's state
after its last byte, int32 (lanes,) (the reference's ``dfa_scan_body``
final states; parallel/sharded_scan.py reads them).

``dfa_stride_words(data, stride_table)`` is K2, the k-byte-stride walk
(csrc/dfa.cu ``stride_kernel``; the reference's ``scan_jnp.
_dfa_stride_core`` over a ``models/dfa.StrideTable``, k = 2 or 4): the
same words as ``dfa_scan_words`` on the table it was composed from, with
one table read a stride; ``dfa_stride_words_plain`` is its plain version.
Its launches are counted apart, in ``stride``.

K1 runs on the mesh engine's ``dfa`` route (ops/engine.py: a pattern
outside the kernel subset on a mesh engine keeps mode ``dfa``, as the
reference's), K2 where ``choose_stride`` allows a stride on that route;
both run in benchmarks/kernel_compare.py (engines ``dfa``, ``aho<N>``,
``stride<k>``) and in chip_smoke.py's checks.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from distributed_grep_tpu_torch.models.dfa import NL, DfaTable, StrideTable
from distributed_grep_tpu_torch.ops import _build
from distributed_grep_tpu_torch.ops.cuda_scan import check_stripes
from distributed_grep_tpu_torch.ops.fdr_scan import or_into, pack_bits
from distributed_grep_tpu_torch.ops.layout import STRIPES

LAYOUT = STRIPES  # the layout the kernel reads (ops/layout.py)
# the csrc/ source this module builds and launches
LIBRARY = "dfa"

# Tables of at most this many bytes of entries sit in shared memory
# (csrc/dfa.cu kSmemTableBytes); larger ones are read from global memory.
SMEM_TABLE_BYTES = 96 * 1024

_ACCEPT = 1 << 31
_ACCEPT_EOL = 1 << 30

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


class LaunchCount:
    """K2's launch count, apart from K1's module-level one: ``launches``,
    incremented once per launch and nowhere else, and
    ``reset_launches()``."""

    LIBRARY = LIBRARY

    def __init__(self):
        self.launches = 0

    def reset_launches(self) -> None:
        with _count_lock:
            self.launches = 0

    def count(self) -> None:
        with _count_lock:
            self.launches += 1


stride = LaunchCount()


def packed_table(table: DfaTable) -> np.ndarray:
    """The kernel's entries, uint32 [n_states * n_classes]: the next
    state's row offset (next * n_classes) in bits 0..29, accept[next] in
    bit 31, accept_eol[next] in bit 30."""
    n_entries = table.n_states * table.n_classes
    if n_entries > _ACCEPT_EOL:
        raise ValueError(f"DFA table of {n_entries} entries is over the "
                         f"kernel's 2**30")
    nxt = table.trans.astype(np.int64)
    packed = (nxt * table.n_classes
              | table.accept[nxt].astype(np.int64) << 31
              | table.accept_eol[nxt].astype(np.int64) << 30)
    return np.ascontiguousarray(packed.reshape(-1).astype(np.uint32))


def uses_shared_memory(table: DfaTable) -> bool:
    """True when the kernel keeps ``table``'s entries in shared memory."""
    return 4 * table.n_states * table.n_classes <= SMEM_TABLE_BYTES


_upload_lock = threading.Lock()


def device_table(table: DfaTable, device: torch.device):
    """(entries uint32, classes uint8) of ``table`` on ``device``,
    uploaded at the first call for that device and kept on the table."""
    cache = getattr(table, "_device_cache", None)
    if cache is None:
        cache = {}
        object.__setattr__(table, "_device_cache", cache)
    key = str(device)
    with _upload_lock:
        if key not in cache:
            cache[key] = (
                torch.from_numpy(packed_table(table)).to(device),
                torch.from_numpy(table.byte_to_cls.astype(np.uint8)).to(device),
            )
    return cache[key]


def dfa_scan_words_plain(data: torch.Tensor, table: DfaTable,
                         with_exits: bool = False):
    """The kernel's function in plain PyTorch, on ``data``'s device: the
    reference's recurrence, a loop over the chunk vectorized over lanes,
    the state in int64 (PyTorch on the CPU has no uint32 shifts).  With
    ``with_exits``, (words, each stripe's final state as int32)."""
    lanes, chunk, _pitch = check_stripes(data)
    dev = data.device
    trans = torch.from_numpy(table.trans.astype(np.int64).reshape(-1)).to(dev)
    byte_cls = torch.from_numpy(table.byte_to_cls.astype(np.int64)).to(dev)
    accept = torch.from_numpy(table.accept.copy()).to(dev)
    accept_eol = torch.from_numpy(table.accept_eol.copy()).to(dev)
    cols = data.t()  # (chunk, lanes)
    cls = byte_cls[cols.long()]
    nl_next = torch.ones((chunk, lanes), dtype=torch.bool, device=dev)
    nl_next[:-1] = cols[1:] == NL
    n_classes = table.n_classes
    state = torch.full((lanes,), table.start, dtype=torch.int64, device=dev)
    hit = torch.empty((chunk, lanes), dtype=torch.bool, device=dev)
    for c in range(chunk):
        state = trans[state * n_classes + cls[c]]
        hit[c] = accept[state] | (accept_eol[state] & nl_next[c])
    if with_exits:
        return pack_bits(hit), state.to(torch.int32)
    return pack_bits(hit)


def _lib():
    lib = _build.load(LIBRARY)
    fn = lib.dgrep_dfa_scan
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_uint, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def _stride_lib():
    lib = _build.load(LIBRARY)
    fn = lib.dgrep_dfa_stride_scan
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_uint, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def dfa_scan_words(data: torch.Tensor, table: DfaTable,
                   with_exits: bool = False):
    """Match-end words for ``data`` (see the module docstring); with
    ``with_exits``, (words, exit states).  CUDA tensors launch the kernel
    on the current stream (no synchronization; the outputs are allocated
    here); CPU tensors take the plain version."""
    lanes, chunk, pitch = check_stripes(data)
    if data.device.type == "cpu":
        return dfa_scan_words_plain(data, table, with_exits)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    fn = _lib()
    entries, cls = device_table(table, data.device)
    out = torch.empty((chunk // 32, lanes), dtype=torch.uint32,
                      device=data.device)
    exits = (torch.empty((lanes,), dtype=torch.int32, device=data.device)
             if with_exits else None)
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        err = fn(data.data_ptr(), out.data_ptr(), entries.data_ptr(),
                 cls.data_ptr(), entries.numel(), chunk, lanes, pitch,
                 table.start * table.n_classes,
                 exits.data_ptr() if exits is not None else None,
                 table.n_classes, stream)
    if err != 0:
        raise RuntimeError(
            f"dfa CUDA kernel launch failed: cudaError {err} (lanes={lanes}, "
            f"chunk={chunk}, pitch={pitch}, states={table.n_states}, "
            f"classes={table.n_classes})"
        )
    _count_launch()
    return (out, exits) if with_exits else out


def packed_stride_table(st: StrideTable) -> np.ndarray:
    """K2's entries, uint32 [n_states * n_classes**k]: the reference's
    ``trans_k`` with the next state premultiplied by the row width
    n_classes**k (its row offset), still above the k accept bits."""
    k = st.k
    cols = st.n_classes ** k
    trans = st.trans_k.astype(np.int64).reshape(-1)
    packed = ((trans >> k) * cols) << k | (trans & ((1 << k) - 1))
    if trans.size and int(packed.max()) > 0xFFFFFFFF:
        raise ValueError(f"stride table of {trans.size} entries is over "
                         f"K2's 2**{32 - k}")
    return np.ascontiguousarray(packed.astype(np.uint32))


def device_stride_table(st: StrideTable, device: torch.device):
    """(entries uint32, classes uint8) of ``st`` on ``device``, uploaded
    at the first call for that device and kept on the table."""
    cache = st.__dict__.setdefault("_device_cache", {})
    key = str(device)
    with _upload_lock:
        if key not in cache:
            cache[key] = (
                torch.from_numpy(packed_stride_table(st)).to(device),
                torch.from_numpy(st.byte_to_cls.astype(np.uint8)).to(device),
            )
    return cache[key]


def _check_stride(data: torch.Tensor, st: StrideTable) -> tuple:
    lanes, chunk, pitch = check_stripes(data)
    if st.k not in (2, 4):
        raise ValueError(f"K2 takes a stride of 2 or 4, got {st.k}")
    if chunk % st.k:
        raise ValueError(f"stride {st.k} must divide chunk {chunk}")
    return lanes, chunk, pitch


def dfa_stride_words_plain(data: torch.Tensor, st: StrideTable
                           ) -> torch.Tensor:
    """K2's function in plain PyTorch, on ``data``'s device: the
    reference's ``_dfa_stride_core``, chunk / k steps vectorized over
    lanes, the state in int64 (C4)."""
    lanes, chunk, _pitch = _check_stride(data, st)
    dev = data.device
    k = st.k
    cols = st.n_classes ** k
    trans = torch.from_numpy(st.trans_k.astype(np.int64).reshape(-1)).to(dev)
    byte_cls = torch.from_numpy(st.byte_to_cls.astype(np.int64)).to(dev)
    cls = byte_cls[data.t().long()].reshape(chunk // k, k, lanes)
    idx = cls[:, 0]
    for t in range(1, k):  # the stride's first byte is the top digit
        idx = idx * st.n_classes + cls[:, t]
    state = torch.full((lanes,), st.start, dtype=torch.int64, device=dev)
    bitmaps = torch.empty((chunk // k, lanes), dtype=torch.int64, device=dev)
    for s in range(chunk // k):
        entry = trans[state * cols + idx[s]]
        state = entry >> k
        bitmaps[s] = entry & ((1 << k) - 1)
    shifts = torch.arange(k, dtype=torch.int64, device=dev)
    hit = ((bitmaps[:, None, :] >> shifts[None, :, None]) & 1).bool()
    return pack_bits(hit.reshape(chunk, lanes))


def dfa_stride_words(data: torch.Tensor, st: StrideTable) -> torch.Tensor:
    """K2's words for ``data``: those of ``dfa_scan_words`` on the table
    ``st`` was composed from.  CUDA tensors launch the kernel on the
    current stream; CPU tensors take the plain version; anything else
    raises."""
    lanes, chunk, pitch = _check_stride(data, st)
    if data.device.type == "cpu":
        return dfa_stride_words_plain(data, st)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    fn = _stride_lib()
    entries, cls = device_stride_table(st, data.device)
    out = torch.empty((chunk // 32, lanes), dtype=torch.uint32,
                      device=data.device)
    cols = st.n_classes ** st.k
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        err = fn(data.data_ptr(), out.data_ptr(), entries.data_ptr(),
                 cls.data_ptr(), entries.numel(), chunk, lanes, pitch,
                 st.start * cols, st.k, st.n_classes, stream)
    if err != 0:
        raise RuntimeError(
            f"dfa stride CUDA kernel launch failed: cudaError {err} "
            f"(lanes={lanes}, chunk={chunk}, pitch={pitch}, k={st.k}, "
            f"states={st.n_states}, classes={st.n_classes})"
        )
    stride.count()
    return out


def stride_uses_shared_memory(st: StrideTable) -> bool:
    """True when K2 keeps ``st``'s entries in shared memory."""
    return 4 * st.trans_k.size <= SMEM_TABLE_BYTES


def dfa_scan_bank_words(data: torch.Tensor,
                        tables: list[DfaTable]) -> torch.Tensor:
    """The OR of ``dfa_scan_words`` over ``tables`` (an Aho-Corasick
    set's banks): one launch a table."""
    if not tables:
        raise ValueError("no DFA tables to scan")
    words = None
    for t in tables:
        words = or_into(words, dfa_scan_words(data, t))
    return words
