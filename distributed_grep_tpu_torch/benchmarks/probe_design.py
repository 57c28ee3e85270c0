"""Sub-stripe sweep of the narrow probe kernel, on the card.

    python -m distributed_grep_tpu_torch.benchmarks.probe_design

csrc/probe_narrow.cu cuts each stripe into a power of two of sub-stripes
(an 8-byte warm-up each) until the card holds 16 warps an SM.  This
script times the kernel as its launcher chooses, beside copies of the
same source built with the count forced to each of COUNTS (``LAUNCH_LINE``:
the launcher's line replaced, built by ``substripe_sweep.build_variants``),
at i32, i16 and i8 on probe_narrow's own corpus in the measuring path's
layout (SIZE, 64 MiB: 65536 lanes x 1024 bytes,
``utils/slope.device_setup``).  Every output is held to the plain version
bit for bit before it is timed; the variants of one width are timed in
turns (forward, then backward), each as 20 calls captured in a CUDA graph
(the card's clock), and the launcher also eagerly.  One JSON line per
width, naming the card and its power limit.  Without a card it prints
nothing and exits 2.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys

import torch

SIZE = 64 << 20
COUNTS = (1, 2, 4, 16)  # forced sub-stripe counts, beside the launcher's
# the launcher's line that sets the sub-stripe count, and the same line
# with the count forced to {n} (still capped at the words)
LAUNCH_LINE = ("  n_sub = std::min(n_sub, n_words);",
               "  n_sub = std::min(n_words, {n});")


def _call(lib, y, width: str):
    """ops/narrow_probe.py's call, on a variant library."""
    from distributed_grep_tpu_torch.ops import narrow_probe

    chunk, lanes = y.shape
    out = torch.empty((chunk // 32, lanes), dtype=torch.uint32,
                      device=y.device)
    fn = lib.dgrep_narrow_probe
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, i, i, p]
    fn.restype = i
    err = fn(y.data_ptr(), out.data_ptr(), chunk, lanes,
             narrow_probe.WIDTHS[width],
             torch.cuda.current_stream(y.device).cuda_stream)
    if err:
        raise RuntimeError(f"narrow probe variant launch failed: "
                           f"cudaError {err}")
    return out


def main(argv: list[str] | None = None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(
        argv)
    if not torch.cuda.is_available():
        print("error: torch.cuda.is_available() is False: the sweep needs "
              "an NVIDIA card", file=sys.stderr)
        return 2

    from distributed_grep_tpu_torch.benchmarks import probe_narrow
    from distributed_grep_tpu_torch.benchmarks.substripe_sweep import (
        build_variants,
        card_line,
        cuda_ms,
        graph_ms,
    )
    from distributed_grep_tpu_torch.ops import narrow_probe

    card = card_line()
    libs = build_variants("probe_narrow", COUNTS, LAUNCH_LINE)
    dev, lay, _ = probe_narrow._setup(probe_narrow._corpus(SIZE), "cuda")
    y = dev[: lay.chunk]
    for width in narrow_probe.WIDTHS:
        fns = {"launcher": lambda w=width:
               narrow_probe.narrow_probe_words(y, w)}
        for name, (n, lib) in libs.items():
            if n <= lay.chunk // 32:
                fns[name] = lambda lib=lib, w=width: _call(lib, y, w)
        plain = narrow_probe.narrow_probe_words_plain(y, width)
        for name, fn in fns.items():
            got = fn()
            torch.cuda.synchronize()
            if not torch.equal(got, plain):
                raise AssertionError(f"narrow probe {width}: {name} != plain")
        turns: dict[str, list[float]] = {k: [] for k in fns}
        for name in list(fns) + list(fns)[::-1]:
            turns[name].append(graph_ms(fns[name]))
        print(json.dumps({
            "kernel": "probe_narrow", "width": width, "chunk": lay.chunk,
            "lanes": lay.lanes,
            "ms": {k: sum(v) / len(v) for k, v in turns.items()},
            "turns": turns, "launcher_eager_ms": cuda_ms(fns["launcher"]),
            "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
