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

No engine route runs this kernel: the port routes as the reference does
with its native library present, which scans these tables on the host
(ops/engine.py).  It runs in benchmarks/kernel_compare.py (engines ``dfa``
and ``aho<N>``) and in chip_smoke.py's checks.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from distributed_grep_tpu_torch.models.dfa import NL, DfaTable
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


def dfa_scan_words_plain(data: torch.Tensor, table: DfaTable) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on ``data``'s device: the
    reference's recurrence, a loop over the chunk vectorized over lanes,
    the state in int64 (PyTorch on the CPU has no uint32 shifts)."""
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
    return pack_bits(hit)


def _lib():
    lib = _build.load(LIBRARY)
    fn = lib.dgrep_dfa_scan
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_uint, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def dfa_scan_words(data: torch.Tensor, table: DfaTable) -> torch.Tensor:
    """Match-end words for ``data`` (see the module docstring).  CUDA
    tensors launch the kernel on the current stream (no synchronization;
    the output is allocated here); CPU tensors take the plain version."""
    lanes, chunk, pitch = check_stripes(data)
    if data.device.type == "cpu":
        return dfa_scan_words_plain(data, table)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    fn = _lib()
    entries, cls = device_table(table, data.device)
    out = torch.empty((chunk // 32, lanes), dtype=torch.uint32,
                      device=data.device)
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        err = fn(data.data_ptr(), out.data_ptr(), entries.data_ptr(),
                 cls.data_ptr(), entries.numel(), chunk, lanes, pitch,
                 table.start * table.n_classes, stream)
    if err != 0:
        raise RuntimeError(
            f"dfa CUDA kernel launch failed: cudaError {err} (lanes={lanes}, "
            f"chunk={chunk}, pitch={pitch}, states={table.n_states}, "
            f"classes={table.n_classes})"
        )
    _count_launch()
    return out


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
