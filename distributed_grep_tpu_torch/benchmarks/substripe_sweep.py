"""Sub-stripe sweep of the two stripe kernels, on the card.

    python -m distributed_grep_tpu_torch.benchmarks.substripe_sweep \\
        [--sizes-mb 64,8,4] [--n-sub 1,2,4,8]

csrc/shift_and.cu and csrc/approx.cu cut each stripe into sub-stripes,
one thread (block row) each, and their launchers choose how many.  This
script times each kernel as its launcher chooses, beside copies of the
same source built with that count forced (the launcher's one line that
sets it replaced, ``variant_source``), on segments of English-word lines
in the engine's layout (64 MiB: 65536 lanes x 1024 bytes; 8 MiB: 32768 x
256; 4 MiB: 16384 x 256).  Every output is held to the plain version bit
for bit before it is timed; the variants of one model are timed in turns
(forward, then backward), each as 20 calls captured in a CUDA graph, so
the times are the card's and not the host's (the launcher is also timed
eagerly, host included, as chip_smoke.py times the kernels).  One JSON
line per segment and model, then one with torch's int64 sum of the largest segment, the card's practical floor
for reading it once; each line names the card and its power limit.
Without a card it prints nothing and exits 2.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

# Per kernel: the launcher's line that sets the sub-stripe count, and the
# same line with the count forced to {n} (still capped at the words).
LAUNCH_LINE = {
    "shift_and": (
        "const int n_want = max(1, min(n_words, sms[dev] / lane_blocks));",
        "const int n_want = max(1, min(n_words, {n}));"),
    "approx": (
        "const int n_want = max(1, min(n_words, sms / lane_blocks));",
        "const int n_want = max(1, min(n_words, {n}));"),
}
ENTRY = {"shift_and": "dgrep_shift_and_scan", "approx": "dgrep_approx_scan"}
VOCAB = (b"the of and to in is was for on as with by he at from his that it "
         b"an were are which this be or had not first one their its new "
         b"after who they have her she two been other when there all during "
         b"into school time may years more most only over city some world "
         b"would where later up such used many can state about national out "
         b"known university united then made").split()


def words_text(n: int, seed: int = 0) -> bytes:
    """n bytes of words from VOCAB, about 12 a line, with 'volcano' and
    some misspellings of the approx models' patterns among them."""
    rng = np.random.default_rng(seed)
    vocab = list(VOCAB) + [b"volcano", b"Volcano", b"volcxno", b"Schwarzena"]
    p = np.full(len(vocab), 1.0)
    p[-4:] = 0.02
    tokens = [w + b" " for w in vocab] + [w + b"\n" for w in vocab]
    idx = rng.choice(len(vocab), size=n // 4, p=p / p.sum())
    idx += len(vocab) * (rng.random(idx.size) < 1 / 12)
    return b"".join(tokens[i] for i in idx.tolist())[:n]


def variant_source(kernel: str, n_sub: int) -> str:
    """csrc/<kernel>.cu with the launcher's sub-stripe count forced to
    n_sub.  Raises if the launcher's line is not there exactly once."""
    from distributed_grep_tpu_torch.ops import _build

    text = (_build.CSRC / f"{kernel}.cu").read_text()
    line, forced = LAUNCH_LINE[kernel]
    if text.count(line) != 1:
        raise ValueError(f"csrc/{kernel}.cu: the sub-stripe line "
                         f"{line!r} is not there exactly once")
    return text.replace(line, forced.format(n=n_sub))


def build_variants(kernel: str, counts) -> dict[int, ctypes.CDLL]:
    """One library per forced count, nvcc processes started together,
    built under the package's git-ignored _build directory."""
    from distributed_grep_tpu_torch.ops import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for n in counts:
        src = variant_source(kernel, n)
        h = hashlib.sha256(src.encode() + " ".join(_build.NVCC_FLAGS)
                           .encode()).hexdigest()[:12]
        cu = _build.BUILD_DIR / f"{kernel}_nsub{n}-{h}.cu"
        so = cu.with_suffix(".so")
        if not so.exists():
            cu.write_text(src)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(tmp),
                   str(cu)]
            jobs[n] = (so, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        else:
            jobs[n] = (so, None, None)
    libs = {}
    for n, (so, tmp, proc) in jobs.items():
        if proc is not None:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {kernel} n_sub={n}:\n{log}")
            os.replace(tmp, so)
        libs[n] = ctypes.CDLL(str(so))
    return libs


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20) -> float:
    """Eager: back-to-back calls between CUDA events, host time included
    where a call takes longer to issue than to run."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device time: `reps` calls captured in one CUDA graph, replayed
    between CUDA events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()  # the first replay uploads the graph
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (reps * replays)


def _launch(lib, kernel, dev, table, match_bit, mode, warm):
    """The wrapper's call (ops/cuda_scan.py, ops/approx_scan.py) on a
    variant library: mode is `coarse` for Shift-And, k for approx."""
    fn = getattr(lib, ENTRY[kernel])
    fn.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lanes, chunk = dev.shape
    out = torch.empty((chunk // 32, lanes), dtype=torch.uint32,
                      device=dev.device)
    err = fn(dev.data_ptr(), out.data_ptr(), table.ctypes.data, chunk, lanes,
             dev.stride(0), match_bit, mode, warm,
             torch.cuda.current_stream(dev.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel} variant launch failed: cudaError {err}")
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sizes-mb", default="64,8,4")
    ap.add_argument("--n-sub", default="1,2,4,8")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: torch.cuda.is_available() is False: the sweep needs "
              "an NVIDIA card", file=sys.stderr)
        return 2

    from distributed_grep_tpu_torch.models import approx as ax_mod
    from distributed_grep_tpu_torch.models import shift_and as sa_mod
    from distributed_grep_tpu_torch.ops import approx_scan, cuda_scan
    from distributed_grep_tpu_torch.ops.engine import DEFAULT_TARGET_LANES
    from distributed_grep_tpu_torch.ops.layout import (
        choose_layout,
        padded_stripes,
    )

    card = card_line()
    counts = [int(x) for x in args.n_sub.split(",")]
    libs = {k: build_variants(k, counts) for k in LAUNCH_LINE}
    full = sa_mod.try_compile_shift_and("volcano")
    runs = [("shift_and", "volcano filter, coarse",
             sa_mod.filtered_for_device(full), 1),
            ("shift_and", "volcano, exact", full, 0)]
    runs += [("approx", f"{p} k={k}{' -i' if ic else ''}",
              ax_mod.try_compile_approx(p, k, ignore_case=ic), k)
             for p, k, ic in (("volcano", 1, False), ("volcano", 2, True),
                              ("[Ss]chwarzen[ae]", 3, False))]
    largest = None
    for size_mb in (float(x) for x in args.sizes_mb.split(",")):
        data = words_text(int(size_mb * (1 << 20)))
        lay = choose_layout(len(data), target_lanes=DEFAULT_TARGET_LANES,
                            min_chunk=256, lane_multiple=32,
                            chunk_multiple=32)
        dev = torch.from_numpy(padded_stripes(data, lay)).cuda()
        if largest is None or dev.numel() > largest.numel():
            largest = dev
        n_words = lay.chunk // 32
        for kernel, label, model, mode in runs:
            if kernel == "shift_and":
                def kept(m=model, c=bool(mode)):
                    return cuda_scan.shift_and_scan_words(dev, m, c)

                plain = cuda_scan.shift_and_scan_words_plain(dev, model,
                                                             bool(mode))
                table = model.b_table
                warm = cuda_scan.warmup_words(model)
            else:
                def kept(m=model):
                    return approx_scan.approx_scan_words(dev, m)

                plain = approx_scan.approx_scan_words_plain(dev, model)
                table = model.base.b_table
                warm = approx_scan.warmup_words(model)
            table = np.ascontiguousarray(table, dtype=np.uint32)
            fns = {"launcher": kept}
            for n in counts:
                if n <= n_words:
                    fns[f"n_sub={n}"] = (
                        lambda lib=libs[kernel][n]: _launch(
                            lib, kernel, dev, table, int(model.match_bit),
                            mode, warm))
            for name, fn in fns.items():
                got = fn()
                torch.cuda.synchronize()
                if not torch.equal(got, plain):
                    raise AssertionError(f"{kernel} {label}: {name} != plain")
            turns: dict[str, list[float]] = {k: [] for k in fns}
            for name in list(fns) + list(fns)[::-1]:
                turns[name].append(graph_ms(fns[name]))
            print(json.dumps({
                "kernel": kernel, "model": label, "lanes": lay.lanes,
                "chunk": lay.chunk, "warm_words": warm,
                "ms": {k: sum(v) / len(v) for k, v in turns.items()},
                "turns": turns, "launcher_eager_ms": cuda_ms(kept),
                "card": card}), flush=True)
    flat = largest.view(torch.int64)
    print(json.dumps({"read_floor": "torch int64 sum of the segment",
                      "bytes": largest.numel(),
                      "ms": cuda_ms(lambda: flat.sum()), "card": card}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
