"""Headline benchmark of the port: literal scan throughput (GB/s per card).

    python -m distributed_grep_tpu_torch.bench [--device cuda|cpu]

Prints exactly ONE JSON line on stdout:
    {"metric": "regex_scan_throughput_per_chip_literal", "value": N,
     "unit": "GB/s", "vs_baseline": N}

The port's counterpart of the root ``bench.py``.  It measures the flagship
path -- BASELINE.md config 1: the Shift-And kernel (csrc/shift_and.cu)
running the engine's rare-class device filter for 'volcano' on a words
corpus resident in device memory -- with the slope harness
(``utils/slope.py``: r-pass chains captured in CUDA graphs, per-pass time
from two chain lengths), as the median of 5 slope draws, each the median
of 3 measurements, with a per-pass match-count band.  GB/s are the bytes
one pass scans (the corpus in the engine's 65536-lane layout, padded to
whole rows) over its time.  vs_baseline is value / 10.0, the ratio
against the north star's 10 GB/s per chip (BASELINE.json).

The corpus size is BENCH_CORPUS_BYTES (default 64 * 10^6, the config
suite's size).  Without a card the script prints no JSON line and exits 2;
``--device cpu``, asked for explicitly, times the kernel's plain PyTorch
version instead, with one slope draw of one measurement, and names the
metric ``..._literal_cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

import numpy as np


def _env_int(name: str, default: int, lo: int) -> int:
    """Env override: a malformed value keeps the default, an absurd one
    the floor."""
    try:
        v = int(os.environ.get(name, default))
    except ValueError:
        return default
    return max(lo, v)


CORPUS_BYTES = _env_int("BENCH_CORPUS_BYTES", 64 * 1000 * 1000, lo=10_000)
PATTERN = "volcano"  # BASELINE.md config 1's pattern (the flagship row)
TARGET_GBPS = 10.0  # north-star baseline (BASELINE.json)
METRIC = "regex_scan_throughput_per_chip_literal"
COUNT_RANGE = (900, 1100)  # per-pass matches: 1000 planted needles
# (slope draws, measurements a draw): the card's median of 5 x 3; on the
# CPU, where a pass of the plain version takes milliseconds and a busy
# host makes the noise gate lengthen the chains, one of one
DRAWS = (5, 3)
CPU_DRAWS = (1, 1)

# English-like filler (enwik/WET-shaped words, spaces, newlines).  PATTERN
# is absent from the vocabulary; 1000 occurrences are injected, keeping the
# match count a calibrated sanity band.
_WORDS = (
    "the of and to in a is that for it as was with be by on not he his but "
    "at are this have from or had they you which one were her all she there "
    "would their we him been has when who will more no if out so said what "
    "up its about into than them can only other new some could time these "
    "two may then do first any my now such like our over man me even most "
    "made after also did many before must through years where much your way "
    "well down should because each just those people how too little state "
    "good very make world still own see men work long get here between both "
    "life being under never day same another know while last might us great "
    "old year off come since against go came right used take three"
).split()


def make_corpus(n: int) -> bytes:
    rng = np.random.default_rng(0)
    out, size = [], 0
    while size < n:
        k = int(rng.integers(3, 24))
        line = b" ".join(
            _WORDS[i].encode() for i in rng.integers(0, len(_WORDS), k)
        )
        out.append(line)
        size += len(line) + 1
    data = np.frombuffer(b"\n".join(out)[:n], dtype=np.uint8).copy()
    needle = np.frombuffer(PATTERN.encode(), np.uint8)
    for p in rng.integers(0, n - 16, size=1000):
        data[p : p + len(needle)] = needle
    return data.tobytes()


def bench(data: bytes, device) -> float:
    """GB/s of the engine's device filter for PATTERN over ``data``."""
    from distributed_grep_tpu_torch.models.shift_and import (
        filtered_for_device,
        try_compile_shift_and,
    )
    from distributed_grep_tpu_torch.utils import slope

    model = try_compile_shift_and(PATTERN)
    # the kernel the engine dispatches: the rare-class device filter, whose
    # candidates the host span confirm makes exact downstream
    kernel_model = filtered_for_device(model) or model
    print(f"bench: kernel checks {sum(1 for r in kernel_model.sym_ranges if r)}"
          f"/{len(model.sym_ranges)} symbol classes", file=sys.stderr)
    dev, chunk, pad_rows, scan = slope.shift_and_setup(data, kernel_model,
                                                       device=device)
    n_bytes = slope.pass_bytes(dev, chunk)
    r1, r2 = slope.reps(dev.device, 8, 104)
    n_draws, n_meas = DRAWS if dev.device.type == "cuda" else CPU_DRAWS
    draws = []
    for i in range(n_draws):
        per_pass, per_count = slope.slope_per_pass(
            dev, chunk, pad_rows, scan, r1=r1, r2=r2, count_range=COUNT_RANGE,
            measurements=n_meas,
        )
        print(f"bench: draw {i}: {n_bytes / 1e9 / per_pass:.2f} GB/s "
              f"({per_pass * 1e3:.4f} ms/pass, {per_count:.0f} matches/pass)",
              file=sys.stderr)
        draws.append(per_pass)
    per_pass = statistics.median(draws)
    print(f"bench: shift_and {n_bytes / 1e9 / per_pass:.2f} GB/s (median of "
          f"{len(draws)} slope draws, chunk={chunk} lanes={dev.shape[1]}, "
          f"device {dev.device})", file=sys.stderr)
    return n_bytes / 1e9 / per_pass


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from distributed_grep_tpu_torch.utils.device import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    value = bench(make_corpus(CORPUS_BYTES), device)
    metric = METRIC if device.type == "cuda" else METRIC + "_cpu"
    print(json.dumps({
        "metric": metric,
        "value": value,
        "unit": "GB/s",
        "vs_baseline": value / TARGET_GBPS,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
