"""Kernel comparison on the card: GB/s per scan engine via the slope harness.

The port's counterpart of ``benchmarks/kernel_compare.py``.  Times each
engine on the same synthetic corpus and prints one JSON line per engine,
``{"engine", "value", "unit": "GB/s"}`` or ``{"engine", "error"}``:

    python -m distributed_grep_tpu_torch.benchmarks.kernel_compare \\
        [--size-mb 64] [--engines pallas,nfa,nfa_alt8,pairset,mxu_dot,dfa,
        stride2,stride4,aho256,native_mt] [--device cuda|cpu]

The engines keep the reference's names, so their lines can be matched:

* ``pallas``   -- the Shift-And kernel (csrc/shift_and.cu) on 'needle',
  on stripe windows;
* ``nfa``      -- the Glushkov NFA kernel (csrc/nfa.cu) on 'nee(dle|t)';
* ``nfa_alt8`` -- the NFA kernel on an 8-word alternation;
* ``pairset``  -- the exact 1-2-byte set kernel (csrc/pairset.cu), on
  stripe windows (``utils/slope.pairset_setup``);
* ``mxu_dot``  -- the one-hot membership product on the tensor cores
  (csrc/mxu_dot.cu): 32768 MACs per byte, the cost of any one-hot-dot
  membership engine; its scan semantics are elided, as in the reference;
* ``dfa``      -- the table-DFA kernel (csrc/dfa.cu) on the DFA of
  'nee(dle|t)', on stripe windows (``utils/slope.dfa_setup``);
* ``stride<k>`` -- K2, the k-byte-stride table-DFA kernel (csrc/dfa.cu
  stride_kernel), on the k-byte composition of the DFA of 'nee(dle|t)'
  (``models/dfa.build_stride_table``), on stripe windows
  (``utils/slope.stride_setup``); k is the engine name's number;
* ``aho<n>``   -- the same kernel on the Aho-Corasick banks of n seeded
  members ('needle' and n - 1 random words of 5-11 letters), one slope a
  bank, summed; the line also gives ``banks``;
* ``native_mt`` -- the host library's multithreaded DFA scanner over the
  Aho-Corasick table of the pairset members, the best of three host-clock
  runs (the host reference point of the short-set engines).

``xla_sa`` (the reference's XLA Shift-And, its fallback past the Pallas
kernel's budgets, which the CUDA Shift-And does not have: ROADMAP.md
accepted difference D1) is not ported: it prints an error line saying
so.  A kernel that fails prints its error line too;
nothing falls back.  GB/s are the bytes one pass scans
(``utils/slope.pass_bytes``) over its time.
Without a card and without --device cpu the script exits 2 and prints
nothing on stdout.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

NOT_PORTED = {
    "xla_sa": "the reference's XLA Shift-And, its fallback past the Pallas "
              "kernel's budgets, which the CUDA Shift-And does not have "
              "(ROADMAP.md accepted difference D1)",
}
NFA_ALT8 = "(volcano|anarchy|physics|quantum|needle|breadth|journal|mineral)"
PAIRSET_MEMBERS = [b"ne", b"ed", b"zq", b"9!", b"x"]


def make_corpus(n: int) -> bytes:
    """Printable random bytes, a newline every ~80 bytes, and 1000
    'needle's (the reference's corpus)."""
    rng = np.random.default_rng(0)
    data = rng.integers(32, 127, size=n, dtype=np.uint8)
    data[rng.integers(0, n, size=n // 80)] = 0x0A
    needle = np.frombuffer(b"needle", np.uint8)
    for p in rng.integers(0, n - 16, size=1000):
        data[p : p + len(needle)] = needle
    return data.tobytes()


def _gbs(dev, chunk, pad_rows, scan, r1, r2) -> float:
    from distributed_grep_tpu_torch.utils import slope

    r1, r2 = slope.reps(dev.device, r1, r2)
    per_pass, _ = slope.slope_per_pass(dev, chunk, pad_rows, scan, r1=r1, r2=r2)
    return slope.pass_bytes(dev, chunk) / 1e9 / per_pass


def bench_pallas(data: bytes, device) -> float:
    from distributed_grep_tpu_torch.models.shift_and import try_compile_shift_and
    from distributed_grep_tpu_torch.utils.slope import shift_and_setup

    model = try_compile_shift_and("needle")
    return _gbs(*shift_and_setup(data, model, device=device), 2, 10)


def bench_nfa(data: bytes, device, pattern: str = "nee(dle|t)") -> float:
    from distributed_grep_tpu_torch.models.nfa import try_compile_glushkov
    from distributed_grep_tpu_torch.utils.slope import nfa_setup

    model = try_compile_glushkov(pattern)
    assert model is not None, pattern
    return _gbs(*nfa_setup(data, model, device=device), 8, 64)


def bench_pairset(data: bytes, device) -> float:
    """Exact 1-2-byte set kernel: the device engine for the sets FDR
    cannot host, on the stripes as the engine uploads them."""
    from distributed_grep_tpu_torch.models.pairset import compile_pairset
    from distributed_grep_tpu_torch.utils.slope import pairset_setup

    model = compile_pairset(PAIRSET_MEMBERS)
    return _gbs(*pairset_setup(data, model, device=device), 8, 64)


def bench_dfa(data: bytes, device, pattern: str = "nee(dle|t)") -> float:
    """The table-DFA kernel on one compiled pattern."""
    from distributed_grep_tpu_torch.models.dfa import compile_dfa
    from distributed_grep_tpu_torch.utils.slope import dfa_setup

    return _gbs(*dfa_setup(data, [compile_dfa(pattern)], device=device), 2, 6)


def bench_stride(data: bytes, device, k: int,
                 pattern: str = "nee(dle|t)") -> float:
    """K2 on the k-byte-stride composition of one compiled pattern."""
    from distributed_grep_tpu_torch.models.dfa import (
        build_stride_table,
        compile_dfa,
    )
    from distributed_grep_tpu_torch.utils.slope import stride_setup

    st = build_stride_table(compile_dfa(pattern), k)
    return _gbs(*stride_setup(data, st, device=device), 2, 6)


def aho_members(n: int) -> list[str]:
    """'needle' and n - 1 random lowercase words of 5-11 letters (seed 1,
    the reference's set)."""
    rng = np.random.default_rng(1)
    return ["needle"] + [
        "".join(chr(c) for c in rng.integers(97, 123,
                                             size=int(rng.integers(5, 12))))
        for _ in range(n - 1)
    ]


def bench_aho(data: bytes, device, n_patterns: int = 256) -> tuple[float, int]:
    """The table-DFA kernel on the Aho-Corasick banks of ``aho_members``:
    one slope a bank, the pass times summed.  Returns (GB/s, banks)."""
    from distributed_grep_tpu_torch.models.aho import compile_aho_corasick_banks
    from distributed_grep_tpu_torch.utils import slope

    banks = compile_aho_corasick_banks(aho_members(n_patterns))
    total = 0.0
    for table in banks:
        dev, chunk, pad_rows, scan = slope.dfa_setup(data, [table],
                                                     device=device)
        r1, r2 = slope.reps(dev.device, 2, 6)
        per_pass, _ = slope.slope_per_pass(dev, chunk, pad_rows, scan,
                                           r1=r1, r2=r2)
        total += per_pass
    return slope.pass_bytes(dev, chunk) / 1e9 / total, len(banks)


def bench_native_mt(data: bytes) -> float:
    """The host reference point of the short-set engines: the host
    library's multithreaded DFA scanner over the Aho-Corasick table of the
    pairset members, the best of three runs on the host clock."""
    import time

    from distributed_grep_tpu_torch.models.aho import compile_aho_corasick
    from distributed_grep_tpu_torch.utils import native

    t = compile_aho_corasick(PAIRSET_MEMBERS)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        native.dfa_scan_mt(data, t.full_table(), t.accept, t.start)
        best = min(best, time.perf_counter() - t0)
    return len(data) / 1e9 / best


def bench_mxu_dot(data: bytes, device) -> float:
    """The one-hot shared-contraction formulation's cost: per byte,
    one-hot(byte) @ membership (256, 128) on the tensor cores.  Scan
    semantics (pair chaining, bit packing) are elided, so this measures an
    upper bound on what any one-hot-dot membership engine could reach;
    compare against ``pairset``.  A kernel failure raises (the reference's
    XLA-materialized fallback served a TPU that could not compile it)."""
    import torch

    from distributed_grep_tpu_torch.ops import mxu_probe
    from distributed_grep_tpu_torch.utils.slope import device_setup

    dev, lay, pad_rows = device_setup(
        data, device, lane_multiple=mxu_probe.LANE_BLOCK,
        chunk_multiple=mxu_probe.CHUNK_MULTIPLE,
        min_chunk=mxu_probe.CHUNK_MULTIPLE)
    member = torch.from_numpy(mxu_probe.probe_member()).to(dev.device)

    def scan(win):
        return mxu_probe.mxu_dot(win, member)

    return _gbs(dev, lay.chunk, pad_rows, scan, 2, 6)


def run_engine(eng: str, data: bytes, device) -> dict:
    """One engine's JSON line as a dict (an error line on any failure)."""
    try:
        extra = {}
        why = NOT_PORTED.get(eng)
        if why is not None:
            raise NotImplementedError(f"engine {eng!r} is not ported: {why}")
        if eng == "pallas":
            v = bench_pallas(data, device)
        elif eng == "nfa":
            v = bench_nfa(data, device)
        elif eng == "nfa_alt8":
            v = bench_nfa(data, device, NFA_ALT8)
        elif eng == "pairset":
            v = bench_pairset(data, device)
        elif eng == "mxu_dot":
            v = bench_mxu_dot(data, device)
        elif eng == "dfa":
            v = bench_dfa(data, device)
        elif eng.startswith("stride") and eng[6:].isdigit():
            v = bench_stride(data, device, int(eng[6:]))
        elif eng.startswith("aho") and eng[3:].isdigit():
            v, extra["banks"] = bench_aho(data, device, int(eng[3:]))
        elif eng == "native_mt":
            v = bench_native_mt(data)
        else:
            raise ValueError(f"unknown engine {eng}")
        return {"engine": eng, "value": v, "unit": "GB/s", **extra}
    except Exception as e:  # noqa: BLE001 -- each engine reports its own line
        return {"engine": eng, "error": f"{type(e).__name__}: {e}"}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size-mb", type=int, default=64)
    ap.add_argument("--engines", default="pallas,xla_sa,dfa,stride2,stride4,aho256")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from distributed_grep_tpu_torch.utils.device import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    data = make_corpus(args.size_mb * 1024 * 1024)
    print(f"device={device}", file=sys.stderr)
    for eng in args.engines.split(","):
        print(json.dumps(run_engine(eng, data, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
