"""Table-DFA match words: the CUDA kernels' wrappers and their plain versions.

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

A CUDA tensor launches the hand-written kernel (csrc/dfa.cu); a CPU
tensor runs ``dfa_scan_words_plain``.  Anything else raises.  The kernel
cuts each stripe into ``n_sub`` sub-stripes walked from a guessed entry
state and fixed up after (csrc/dfa.cu's note), and keeps the table in
shared memory where it fits: byte-indexed (``packed_byte_table``, at most
256 slots), or the class map and ``packed_table``'s entries; else it
reads the entries through the L2, all but the head of the table, whose
rows (``bfs_order``: the states nearest the start) it keeps in shared
memory as far as they fit.  ``launch_plan`` is the launcher's
choice of both, mirrored; a launch checks the kernel's own report
against it.  ``n_sub=`` and ``branch=`` force them (refused as the
kernel refuses them); ``fixups=``, a (2,) int64 tensor on the card, gains
the bytes the fix-ups re-walked and keeps the most fix-up rounds a warp
ran (the plain version leaves it as it is).
``dfa_scan_bank_words(data, tables)`` launches once a table and ORs the
words (the reference's one pass a bank).  Each table's packed entries are
uploaded once per device and kept beside the table (``device_table``), as
the reference keeps its ``_device_tables`` per engine and device.
``dfa_scan_words(..., with_exits=True)`` also returns each stripe's state
after its last byte, int32 (lanes,) (the reference's ``dfa_scan_body``
final states; parallel/sharded_scan.py reads them).

``dfa_stride_words(data, stride_table)`` is K2, the k-byte-stride walk
(csrc/dfa.cu's stride walker; the reference's ``scan_jnp.
_dfa_stride_core`` over a ``models/dfa.StrideTable``, k = 2 or 4): the
same words as ``dfa_scan_words`` on the table it was composed from, with
one table read a stride, on the same skeleton (``stride_launch_plan``;
``stride_class_maps`` premultiplies its class maps);
``dfa_stride_words_plain`` is its plain version.  Its launches are
counted apart, in ``stride``.

K1 runs on the mesh engine's ``dfa`` route (ops/engine.py: a pattern
outside the kernel subset on a mesh engine keeps mode ``dfa``, as the
reference's), K2 where ``choose_stride`` allows a stride on that route;
both run in benchmarks/kernel_compare.py (engines ``dfa``, ``aho<N>``,
``stride<k>``), benchmarks/substripe_sweep.py and chip_smoke.py's checks.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import NamedTuple

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

# The launcher's constants (csrc/dfa.cu): a block of THREADS threads an
# SM; SMEM_BYTES of shared memory a block (kSmemBytes, the H100's 227 KB),
# the mbarrier first; the sub-stripe counts it chooses among.
THREADS = 1024
SMEM_BYTES = 232448
BAR_BYTES = 16
SUB_COUNTS = (1, 2, 4, 8)
H100_SMS = 132
# The most bytes of tables (entries and class maps) a block holds in
# shared memory.
SMEM_TABLE_BYTES = SMEM_BYTES - BAR_BYTES
# where the table lies, csrc/dfa.cu's branch codes 1, 2, 3
BRANCHES = ("bytes", "shared", "global")

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


def _pad16(n_bytes: int) -> int:
    return (n_bytes + 15) // 16 * 16


def choose_sub(lanes: int, chunk: int, sms: int, n_sub: int = 0) -> int:
    """csrc/dfa.cu's sub-stripe count: the fewest rounds of lane groups
    (THREADS // n_sub stripes) over the SMs times the longest sub-stripe
    in words, the smaller count on a tie; a forced count as it is, or
    ValueError where the kernel refuses it."""
    n_words = chunk // 32
    if n_sub:
        if n_sub not in (1, 2, 4, 8, 16, 32) or n_sub > n_words:
            raise ValueError(
                f"sub-stripe count {n_sub} refused: a power of two up to 32 "
                f"and at most the chunk's {n_words} words")
        return n_sub

    def cost(s: int) -> tuple[int, int]:
        groups = -(-lanes * s // THREADS)
        return -(-groups // sms) * -(-n_words // s), s

    return min((s for s in SUB_COUNTS if s <= n_words), key=cost)


def _choose(lanes: int, chunk: int, sms: int, n_sub: int, branch,
            shared: dict) -> tuple[int, str]:
    """csrc/dfa.cu's ``choose``: the sub-stripe count, and the first
    shared-memory format whose tables (``shared`` maps "bytes" and
    "shared" to their bytes, 0 where the format does not apply) fit
    SMEM_TABLE_BYTES, else the global branch (which keeps the rows of the
    states nearest the start in shared memory: as many as fit for K1, 32
    KB of them for K2, whose wide rows the L1 serves better).
    ValueError where a forced count or branch is refused."""
    if branch is not None and branch not in BRANCHES:
        raise ValueError(f"unknown branch {branch!r}: one of {BRANCHES}")
    s = choose_sub(lanes, chunk, sms, n_sub)
    for name in ("bytes", "shared"):
        if (0 < shared.get(name, 0) <= SMEM_TABLE_BYTES
                and branch in (None, name)):
            return s, name
    if branch not in (None, "global"):
        raise ValueError(f"launch refused: the table does not take branch "
                         f"{branch} in shared memory")
    return s, "global"


class ByteTable(NamedTuple):
    """K1's byte-indexed table: ``entries`` uint8 [n_slots * 256], the next
    slot at [slot * 256 + byte]; ``slot_of_state`` and ``state_of_slot``
    int32.  A slot's bit 0 is its state's accept flag and, for a table
    with '$' accepts, bit 1 its accept_eol flag."""

    entries: np.ndarray
    slot_of_state: np.ndarray
    state_of_slot: np.ndarray


def packed_byte_table(table: DfaTable) -> ByteTable | None:
    """K1's byte-indexed table (the class map folded in), or None where
    the slots pass 256.  The states of each flag value take the slots of
    that value in order, so the flags ride in the slot's low bits.  Kept
    on the table."""
    if "_byte_table" in table.__dict__:
        return table.__dict__["_byte_table"]
    eol = bool(table.accept_eol.any())
    n_flags = 4 if eol else 2
    flags = table.accept.astype(np.int64)
    if eol:
        flags = flags | table.accept_eol.astype(np.int64) << 1
    slot = np.empty(table.n_states, np.int64)
    for f in range(n_flags):
        states = np.flatnonzero(flags == f)
        slot[states] = np.arange(states.size) * n_flags + f
    n_slots = int(slot.max()) + 1
    result = None
    if n_slots <= 256:
        state_of_slot = np.zeros(n_slots, np.int64)
        state_of_slot[slot] = np.arange(table.n_states)
        nxt = table.trans.astype(np.int64)[state_of_slot][
            :, table.byte_to_cls.astype(np.int64)]
        result = ByteTable(np.ascontiguousarray(slot[nxt].astype(np.uint8)
                                                .reshape(-1)),
                           slot.astype(np.int32),
                           state_of_slot.astype(np.int32))
    object.__setattr__(table, "_byte_table", result)
    return result


def bfs_order(table) -> np.ndarray:
    """The states of a ``DfaTable`` or ``StrideTable`` in breadth-first
    order from the start state, each level in state order, unreachable
    states last: int64 [n_states], order[i] the state of row i.  The
    kernel's packed rows come in this order, so the rows it keeps in
    shared memory where a table is read through the L2 are those of the
    states nearest the start.  (A table of ``compile_dfa`` is numbered so
    already.)  Kept on the table."""
    if "_bfs_order" in table.__dict__:
        return table.__dict__["_bfs_order"]
    nxt = (table.trans_k >> table.k if isinstance(table, StrideTable)
           else table.trans).astype(np.int64)
    rank = np.full(table.n_states, -1, np.int64)
    rank[table.start] = 0
    levels = [np.array([table.start], np.int64)]
    count = 1
    while levels[-1].size:
        seen = np.unique(nxt[levels[-1]])
        new = seen[rank[seen] < 0]
        rank[new] = np.arange(count, count + new.size)
        count += new.size
        levels.append(new)
    levels.append(np.flatnonzero(rank < 0))
    order = np.concatenate(levels)
    object.__setattr__(table, "_bfs_order", order)
    return order


def _rank(order: np.ndarray) -> np.ndarray:
    rank = np.empty_like(order)
    rank[order] = np.arange(order.size)
    return rank


def packed_table(table: DfaTable) -> np.ndarray:
    """The kernel's entries, uint32 [n_states * n_classes], rows in
    ``bfs_order``: the next state's row offset (its row times n_classes)
    in bits 0..29, accept[next] in bit 31, accept_eol[next] in bit 30."""
    n_entries = table.n_states * table.n_classes
    if n_entries > _ACCEPT_EOL:
        raise ValueError(f"DFA table of {n_entries} entries is over the "
                         f"kernel's 2**30")
    order = bfs_order(table)
    nxt = table.trans.astype(np.int64)[order]
    packed = (_rank(order)[nxt] * table.n_classes
              | table.accept[nxt].astype(np.int64) << 31
              | table.accept_eol[nxt].astype(np.int64) << 30)
    return np.ascontiguousarray(packed.reshape(-1).astype(np.uint32))


def launch_plan(table: DfaTable, lanes: int, chunk: int, *,
                sms: int = H100_SMS, n_sub: int = 0,
                branch: str | None = None) -> tuple[int, str]:
    """(n_sub, branch) of K1 on ``table`` over (lanes, chunk) stripes on a
    card of ``sms`` SMs: branch "bytes" (the byte-indexed table in shared
    memory), "shared" (the class map and the entries there) or "global"
    (the entries read through the L2), as csrc/dfa.cu chooses; ``n_sub``
    and ``branch`` force them, or raise ValueError where the kernel would
    refuse."""
    byte = packed_byte_table(table)
    shared = {"bytes": byte.entries.size if byte is not None else 0,
              "shared": 256 + _pad16(4 * table.n_states * table.n_classes)}
    return _choose(lanes, chunk, sms, n_sub, branch, shared)


def uses_shared_memory(table: DfaTable, lanes: int = 65536,
                       chunk: int = 1024) -> bool:
    """True when K1 keeps ``table`` in shared memory at that stripe shape
    (by default the main path's 64 MiB segment)."""
    return launch_plan(table, lanes, chunk)[1] != "global"


_upload_lock = threading.Lock()


def _padded(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """``arr`` on ``device`` in a buffer padded to 16 bytes (the kernel's
    bulk copy moves whole 16-byte pieces); the view holds ``arr``."""
    buf = np.zeros(_pad16(arr.nbytes) // arr.itemsize, dtype=arr.dtype)
    buf[:arr.size] = arr
    return torch.from_numpy(buf).to(device)[:arr.size]


def device_table(table: DfaTable, device: torch.device):
    """(entries uint32, classes uint8, byte-indexed entries uint8 or None,
    each slot's state int32 or None, each row's state int32) of ``table``
    on ``device``, uploaded at the first call for that device and kept on
    the table."""
    cache = getattr(table, "_device_cache", None)
    if cache is None:
        cache = {}
        object.__setattr__(table, "_device_cache", cache)
    key = str(device)
    with _upload_lock:
        if key not in cache:
            byte = packed_byte_table(table)
            cache[key] = (
                _padded(packed_table(table), device),
                torch.from_numpy(table.byte_to_cls.astype(np.uint8)).to(device),
                None if byte is None
                else torch.from_numpy(byte.entries).to(device),
                None if byte is None
                else torch.from_numpy(byte.state_of_slot).to(device),
                torch.from_numpy(bfs_order(table).astype(np.int32)).to(device),
            )
    return cache[key]


_sms: dict[str, int] = {}


def device_sms(device: torch.device) -> int:
    """The SM count of a CUDA device, asked once."""
    key = str(device)
    if key not in _sms:
        _sms[key] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _sms[key]


def _cached_plan(obj, plan_fn, lanes, chunk, sms, n_sub, branch):
    """``plan_fn``'s plan, kept on the table per shape and forcing."""
    plans = obj.__dict__.setdefault("_plans", {})
    key = (lanes, chunk, sms, n_sub, branch)
    if key not in plans:
        plans[key] = plan_fn(obj, lanes, chunk, sms=sms, n_sub=n_sub,
                             branch=branch)
    return plans[key]


def _on(device: torch.device):
    """The context that makes ``device`` current: none where it is (an
    eager launch's host time is part of its scan's)."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _stream(device: torch.device) -> int:
    """The current stream of ``device`` as a cudaStream_t: the raw handle,
    without the Stream object ``torch.cuda.current_stream`` builds (about
    6 us a launch on the card's host)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _fixups_ptr(fixups, device):
    if fixups is None:
        return None
    if (fixups.dtype != torch.int64 or fixups.numel() != 2
            or fixups.device != device or not fixups.is_contiguous()):
        raise ValueError("fixups must be a contiguous (2,) int64 tensor on "
                         "the stripes' device")
    return fixups.data_ptr()


def _check_report(kernel: str, report, want) -> None:
    code = int(report[1])
    got = (int(report[0]), BRANCHES[code - 1] if 1 <= code <= 3 else code)
    if got != tuple(want):
        raise RuntimeError(f"{kernel}: the launcher chose {got}, "
                           f"launch_plan {tuple(want)}")


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


_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
# The parameters of csrc/dfa.cu's dgrep_dfa_scan and dgrep_dfa_stride_scan
K1_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, ctypes.c_longlong, _U, _P, _I,
               _P, _I, _U, _P, _P, _I, _I, _I, _P,
               ctypes.POINTER(ctypes.c_int), _P]
K2_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, ctypes.c_longlong, _U, _I, _I,
               _I, _P, ctypes.POINTER(ctypes.c_int), _P]


def _lib():
    fn = _build.load(LIBRARY).dgrep_dfa_scan
    if fn.argtypes is None:
        fn.argtypes = K1_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _stride_lib():
    fn = _build.load(LIBRARY).dgrep_dfa_stride_scan
    if fn.argtypes is None:
        fn.argtypes = K2_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _k1_args(table: DfaTable, device: torch.device) -> tuple:
    """The table's arguments of ``dgrep_dfa_scan``, from ``table`` to
    ``has_eol`` less the stripes' and the outputs', kept per device (a
    launch's host time is part of an eager scan's)."""
    key = ("k1 args", str(device))
    cache = table.__dict__.setdefault("_device_cache", {})
    if key not in cache:
        entries, cls, byte, slot_state, row_state = device_table(table,
                                                                 device)
        bt = packed_byte_table(table)
        start = int(_rank(bfs_order(table))[table.start]) * table.n_classes
        cache[key] = (
            (entries.data_ptr(), cls.data_ptr(), entries.numel()),
            (start,),
            (table.n_classes,
             byte.data_ptr() if byte is not None else None,
             bt.state_of_slot.size if bt is not None else 0,
             int(bt.slot_of_state[table.start]) if bt is not None else 0,
             slot_state.data_ptr() if slot_state is not None else None,
             row_state.data_ptr(), int(bool(table.accept_eol.any()))))
    return cache[key]


def launch_k1(fn, data: torch.Tensor, table: DfaTable, with_exits: bool,
              n_sub: int, branch, fixups, plan, stream):
    """One call of csrc/dfa.cu's ``dgrep_dfa_scan`` (``fn``) on ``data``'s
    device: the outputs allocated here, the launcher's report held to
    ``plan``; (out, exits or None).  Raises on a refused or failed
    launch."""
    lanes, chunk, pitch = data.shape[0], data.shape[1], data.stride(0)
    head, start, tail = _k1_args(table, data.device)
    out = torch.empty((chunk // 32, lanes), dtype=torch.uint32,
                      device=data.device)
    exits = (torch.empty((lanes,), dtype=torch.int32, device=data.device)
             if with_exits else None)
    report = (ctypes.c_int * 4)()
    err = fn(data.data_ptr(), out.data_ptr(), *head, chunk, lanes, pitch,
             *start, exits.data_ptr() if exits is not None else None, *tail,
             n_sub, BRANCHES.index(branch) + 1 if branch else 0,
             _fixups_ptr(fixups, data.device), report, stream)
    if err != 0:
        raise RuntimeError(
            f"dfa CUDA kernel launch failed: cudaError {err} (lanes={lanes}, "
            f"chunk={chunk}, pitch={pitch}, states={table.n_states}, "
            f"classes={table.n_classes}, n_sub={n_sub}, branch={branch})"
        )
    _check_report("dfa", report, plan)
    return out, exits


def dfa_scan_words(data: torch.Tensor, table: DfaTable,
                   with_exits: bool = False, *, n_sub: int = 0,
                   branch: str | None = None, fixups=None):
    """Match-end words for ``data`` (see the module docstring); with
    ``with_exits``, (words, exit states).  CUDA tensors launch the kernel
    on the current stream (no synchronization; the outputs are allocated
    here); CPU tensors take the plain version.  ``n_sub`` and ``branch``
    force the launch plan, on the CPU too (where they change nothing but
    what is refused)."""
    lanes, chunk, _pitch = check_stripes(data)
    if data.device.type == "cpu":
        _cached_plan(table, launch_plan, lanes, chunk, H100_SMS, n_sub,
                     branch)
        return dfa_scan_words_plain(data, table, with_exits)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    plan = _cached_plan(table, launch_plan, lanes, chunk,
                        device_sms(data.device), n_sub, branch)
    with _on(data.device):
        out, exits = launch_k1(_lib(), data, table, with_exits, n_sub,
                               branch, fixups, plan, _stream(data.device))
    _count_launch()
    return (out, exits) if with_exits else out


def packed_stride_table(st: StrideTable) -> np.ndarray:
    """K2's entries, uint32 [n_states * n_classes**k], rows in
    ``bfs_order``: the reference's ``trans_k`` with the next state's row
    premultiplied by the row width n_classes**k (its row offset), still
    above the k accept bits."""
    k = st.k
    cols = st.n_classes ** k
    order = bfs_order(st)
    trans = st.trans_k.astype(np.int64)[order].reshape(-1)
    packed = (_rank(order)[trans >> k] * cols) << k | (trans & ((1 << k) - 1))
    if trans.size and int(packed.max()) > 0xFFFFFFFF:
        raise ValueError(f"stride table of {trans.size} entries is over "
                         f"K2's 2**{32 - k}")
    return np.ascontiguousarray(packed.astype(np.uint32))


def stride_class_maps(st: StrideTable) -> np.ndarray:
    """K2's class maps, uint32 [k * 256]: map i is each byte's class times
    n_classes**(k - 1 - i), the weight of the stride's byte i in the
    combined column, so a column is the sum of k lookups."""
    cls = st.byte_to_cls.astype(np.int64)
    return np.ascontiguousarray(np.concatenate(
        [cls * st.n_classes ** (st.k - 1 - i) for i in range(st.k)]
    ).astype(np.uint32))


def stride_launch_plan(st: StrideTable, lanes: int, chunk: int, *,
                       sms: int = H100_SMS, n_sub: int = 0,
                       branch: str | None = None) -> tuple[int, str]:
    """(n_sub, branch) of K2 on ``st``, as ``launch_plan``: "shared" (the
    class maps and the composed table in shared memory) or "global"."""
    if branch == "bytes":
        raise ValueError("K2 has no byte-indexed table")
    maps = 1024 * st.k
    shared = {"shared": maps + _pad16(4 * st.trans_k.size)}
    return _choose(lanes, chunk, sms, n_sub, branch, shared)


def stride_uses_shared_memory(st: StrideTable, lanes: int = 65536,
                              chunk: int = 1024) -> bool:
    """True when K2 keeps ``st``'s entries in shared memory at that stripe
    shape (by default the main path's 64 MiB segment)."""
    return stride_launch_plan(st, lanes, chunk)[1] != "global"


def device_stride_table(st: StrideTable, device: torch.device):
    """(entries uint32, premultiplied class maps uint32) of ``st`` on
    ``device``, uploaded at the first call for that device and kept on the
    table."""
    cache = st.__dict__.setdefault("_device_cache", {})
    key = str(device)
    with _upload_lock:
        if key not in cache:
            cache[key] = (
                _padded(packed_stride_table(st), device),
                torch.from_numpy(stride_class_maps(st)).to(device),
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


def _k2_args(st: StrideTable, device: torch.device) -> tuple:
    """``_k1_args`` for ``dgrep_dfa_stride_scan``: (table, class maps,
    entries) and (start, k)."""
    key = ("k2 args", str(device))
    cache = st.__dict__.setdefault("_device_cache", {})
    if key not in cache:
        entries, maps = device_stride_table(st, device)
        start = int(_rank(bfs_order(st))[st.start]) * st.n_classes ** st.k
        cache[key] = ((entries.data_ptr(), maps.data_ptr(), entries.numel()),
                      (start, st.k))
    return cache[key]


def launch_k2(fn, data: torch.Tensor, st: StrideTable, n_sub: int, branch,
              fixups, plan, stream) -> torch.Tensor:
    """One call of csrc/dfa.cu's ``dgrep_dfa_stride_scan`` (``fn``), as
    ``launch_k1``."""
    lanes, chunk, pitch = data.shape[0], data.shape[1], data.stride(0)
    head, tail = _k2_args(st, data.device)
    out = torch.empty((chunk // 32, lanes), dtype=torch.uint32,
                      device=data.device)
    report = (ctypes.c_int * 4)()
    err = fn(data.data_ptr(), out.data_ptr(), *head, chunk, lanes, pitch,
             *tail, n_sub, BRANCHES.index(branch) + 1 if branch else 0,
             _fixups_ptr(fixups, data.device), report, stream)
    if err != 0:
        raise RuntimeError(
            f"dfa stride CUDA kernel launch failed: cudaError {err} "
            f"(lanes={lanes}, chunk={chunk}, pitch={pitch}, k={st.k}, "
            f"states={st.n_states}, classes={st.n_classes}, n_sub={n_sub}, "
            f"branch={branch})"
        )
    _check_report("dfa_stride", report, plan)
    return out


def dfa_stride_words(data: torch.Tensor, st: StrideTable, *, n_sub: int = 0,
                     branch: str | None = None, fixups=None) -> torch.Tensor:
    """K2's words for ``data``: those of ``dfa_scan_words`` on the table
    ``st`` was composed from.  CUDA tensors launch the kernel on the
    current stream; CPU tensors take the plain version; anything else
    raises.  ``n_sub``, ``branch`` and ``fixups`` as ``dfa_scan_words``'s."""
    lanes, chunk, _pitch = _check_stride(data, st)
    if data.device.type == "cpu":
        _cached_plan(st, stride_launch_plan, lanes, chunk, H100_SMS, n_sub,
                     branch)
        return dfa_stride_words_plain(data, st)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    plan = _cached_plan(st, stride_launch_plan, lanes, chunk,
                        device_sms(data.device), n_sub, branch)
    with _on(data.device):
        out = launch_k2(_stride_lib(), data, st, n_sub, branch, fixups, plan,
                        _stream(data.device))
    stride.count()
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
