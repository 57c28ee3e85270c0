"""Sub-stripe sweep of the four stripe kernels, on the card.

    python -m distributed_grep_tpu_torch.benchmarks.substripe_sweep \\
        [--sizes-mb 64,8,4] [--n-sub 1,2,4,8]

csrc/shift_and.cu, csrc/approx.cu, csrc/pairset.cu and
csrc/shift_and_swar.cu cut each stripe into sub-stripes, one thread
(block row) each, and their launchers choose how many.  This script times
each kernel as its launcher chooses, beside copies of the same source
built with that count forced (the launcher's one line that sets it
replaced, ``variant_source``), on segments in the engine's layout (64 MiB:
65536 lanes x 1024 bytes; 8 MiB: 32768 x 256; 4 MiB: 16384 x 256): English
-word lines for Shift-And, approx and SWAR, random bytes with a newline
every ~120 for pairset (the PCAP-like corpus its query runs on) and words
for its transposed set.  Every output is held to the plain version bit
for bit before it is timed; the variants of one model are timed in turns
(forward, then backward), each as 20 calls captured in a CUDA graph, so
the times are the card's and not the host's (the launcher is also timed
eagerly, host included, as chip_smoke.py times the kernels).  One JSON
line per segment and model, then one with torch's int64 sum of the largest
segment, the card's practical floor for reading it once; each line names
the card and its power limit.  Without a card it prints nothing and exits
2.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

# Per kernel: the launcher's line that sets the sub-stripe count, and the
# same line with the count forced to {n} (still capped at the words).
_SUB = "const int n_want = max(1, min(n_words, sms / lane_blocks));"
_FORCED = "const int n_want = max(1, min(n_words, {n}));"
LAUNCH_LINE = {
    "shift_and": (_SUB, _FORCED), "approx": (_SUB, _FORCED),
    "pairset": (_SUB, _FORCED),
    "shift_and_swar": ("const int n_want = max(1, min(n_words, 2 * sms / "
                       "lane_blocks));", _FORCED)}
ENTRY = {"shift_and": "dgrep_shift_and_scan", "approx": "dgrep_approx_scan",
         "pairset": "dgrep_pairset_scan", "shift_and_swar": "dgrep_swar_scan"}
PAIR_SET = [b"zq", b"9!", b"Q#", b"~~"]  # chip_smoke.py's 2-byte set
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


def build_variants(kernel: str, counts) -> dict:
    """One library per forced count, keyed "n_sub=N", nvcc processes
    started together, built under the package's git-ignored _build
    directory."""
    from distributed_grep_tpu_torch.ops import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for n in counts:
        name = f"n_sub={n}"
        src = variant_source(kernel, n)
        h = _build.source_hash(src.encode())
        cu = _build.BUILD_DIR / f"{kernel}_nsub{n}-{h}.cu"
        so = cu.with_suffix(".so")
        if not so.exists():
            cu.write_text(src)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            jobs[name] = (n, so, tmp, subprocess.Popen(
                _build.nvcc_command(cu, tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        else:
            jobs[name] = (n, so, None, None)
    libs = {}
    for name, (n, so, tmp, proc) in jobs.items():
        if proc is not None:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {kernel} {name}:\n{log}")
            os.replace(tmp, so)
        libs[name] = (n, ctypes.CDLL(str(so)))
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


def random_text(n: int, seed: int = 0) -> bytes:
    """n random bytes with a newline every ~120 and the 2-byte set's
    members planted, the PCAP-like corpus of chip_smoke.py's set query."""
    rng = np.random.default_rng(seed)
    text = rng.integers(0, 256, size=n, dtype=np.uint8)
    text[rng.integers(0, n, size=n // 120)] = 0x0A
    at = rng.integers(0, n - 2, size=n // 3000)
    for i, p in enumerate(at.tolist()):
        text[p : p + 2] = np.frombuffer(PAIR_SET[i % len(PAIR_SET)], np.uint8)
    return text.tobytes()


def _call(lib, kernel: str, dev, model, mode):
    """The wrapper's call (ops/cuda_scan.py, approx_scan.py, pairset_scan.py,
    swar_scan.py) on a variant library: mode is `coarse` for Shift-And, k
    for approx, unused otherwise."""
    from distributed_grep_tpu_torch.ops import approx_scan, cuda_scan, swar_scan

    fn = getattr(lib, ENTRY[kernel])
    lanes, chunk = dev.shape
    stream = torch.cuda.current_stream(dev.device).cuda_stream
    out = torch.empty((chunk // 32, lanes // 4 if kernel == "shift_and_swar"
                       else lanes), dtype=torch.uint32, device=dev.device)
    p = ctypes.c_void_p
    i, ll, u = ctypes.c_int, ctypes.c_longlong, ctypes.c_uint
    if kernel == "pairset":
        fn.argtypes = [p, p, p, p, i, i, ll, i, i, i, p]
        rowcls = np.ascontiguousarray(model.rowcls, dtype=np.uint32)
        words = np.ascontiguousarray(model.words, dtype=np.uint32)
        args = (rowcls.ctypes.data, words.ctypes.data, chunk, lanes,
                dev.stride(0), int(model.transposed), int(model.ignore_case),
                0)
    elif kernel == "shift_and_swar":
        fn.argtypes = [p, p, p, i, i, ll, u, i, p]
        masks = np.ascontiguousarray(model.b_table & 0xFF, dtype=np.uint8)
        args = (masks.ctypes.data, chunk, lanes, dev.stride(0),
                int(model.match_bit), swar_scan.warmup_words(model))
    else:
        fn.argtypes = [p, p, p, i, i, ll, u, i, i, p]
        table = np.ascontiguousarray(
            model.b_table if kernel == "shift_and" else model.base.b_table,
            dtype=np.uint32)
        warm = (cuda_scan.warmup_words(model) if kernel == "shift_and"
                else approx_scan.warmup_words(model))
        args = (table.ctypes.data, chunk, lanes, dev.stride(0),
                int(model.match_bit), mode, warm)
    fn.restype = ctypes.c_int
    err = fn(dev.data_ptr(), out.data_ptr(), *args, stream)
    if err != 0:
        raise RuntimeError(f"{kernel} variant launch failed: cudaError {err}")
    return out


def _runs():
    """(kernel, label, model, mode, corpus) of each timed model."""
    from distributed_grep_tpu_torch.models import approx as ax_mod
    from distributed_grep_tpu_torch.models import pairset as ps_mod
    from distributed_grep_tpu_torch.models import shift_and as sa_mod

    full = sa_mod.try_compile_shift_and("volcano")
    filt = sa_mod.filtered_for_device(full)
    runs = [("shift_and", "volcano filter, coarse", filt, 1, "words"),
            ("shift_and", "volcano, exact", full, 0, "words")]
    runs += [("approx", f"{p} k={k}{' -i' if ic else ''}",
              ax_mod.try_compile_approx(p, k, ignore_case=ic), k, "words")
             for p, k, ic in (("volcano", 1, False), ("volcano", 2, True),
                              ("[Ss]chwarzen[ae]", 3, False))]
    runs += [("pairset", "2-byte set", ps_mod.compile_pairset(PAIR_SET), 0,
              "random"),
             ("pairset", "transposed -i", ps_mod.compile_pairset(
                 [bytes([100 + i, b"uvwxyz"[j]]) for i in range(40)
                  for j in range(6) if (i + 1) >> j & 1], ignore_case=True),
              0, "words")]
    runs += [("shift_and_swar", "volcano filter", filt, 0, "words"),
             ("shift_and_swar", "volcano", full, 0, "words")]
    return runs


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sizes-mb", default="64,8,4")
    ap.add_argument("--n-sub", default="1,2,4,8")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: torch.cuda.is_available() is False: the sweep needs "
              "an NVIDIA card", file=sys.stderr)
        return 2

    from distributed_grep_tpu_torch.ops import (
        approx_scan,
        cuda_scan,
        pairset_scan,
        swar_scan,
    )
    from distributed_grep_tpu_torch.ops.engine import DEFAULT_TARGET_LANES
    from distributed_grep_tpu_torch.ops.layout import (
        choose_layout,
        padded_stripes,
    )

    wrappers = {
        "shift_and": (lambda d, m, mode: cuda_scan.shift_and_scan_words(
            d, m, bool(mode)), lambda d, m, mode:
            cuda_scan.shift_and_scan_words_plain(d, m, bool(mode))),
        "approx": (lambda d, m, mode: approx_scan.approx_scan_words(d, m),
                   lambda d, m, mode:
                   approx_scan.approx_scan_words_plain(d, m)),
        "pairset": (lambda d, m, mode: pairset_scan.pairset_scan_words(d, m),
                    lambda d, m, mode:
                    pairset_scan.pairset_scan_words_plain(d, m)),
        "shift_and_swar": (lambda d, m, mode: swar_scan.swar_scan_words(d, m),
                           lambda d, m, mode:
                           swar_scan.swar_scan_words_plain(d, m)),
    }
    card = card_line()
    counts = [int(x) for x in args.n_sub.split(",")]
    libs = {k: build_variants(k, counts) for k in LAUNCH_LINE}
    runs = _runs()
    largest = None
    for size_mb in (float(x) for x in args.sizes_mb.split(",")):
        n = int(size_mb * (1 << 20))
        texts = {"words": words_text(n), "random": random_text(n)}
        lay = choose_layout(n, target_lanes=DEFAULT_TARGET_LANES,
                            min_chunk=256, lane_multiple=32,
                            chunk_multiple=32)
        devs = {k: torch.from_numpy(padded_stripes(t, lay)).cuda()
                for k, t in texts.items()}
        if largest is None or devs["words"].numel() > largest.numel():
            largest = devs["words"]
        n_words = lay.chunk // 32
        for kernel, label, model, mode, corpus in runs:
            dev = devs[corpus]
            kernel_fn, plain_fn = wrappers[kernel]

            def kept(m=model, f=kernel_fn, mo=mode, d=dev):
                return f(d, m, mo)

            plain = plain_fn(dev, model, mode)
            fns = {"launcher": kept}
            for name, (n, lib) in libs[kernel].items():
                if n <= n_words:
                    fns[name] = (lambda lib=lib, k=kernel, d=dev, m=model,
                                 mo=mode: _call(lib, k, d, m, mo))
            for name, fn in fns.items():
                got = fn()
                torch.cuda.synchronize()
                if not torch.equal(got, plain):
                    raise AssertionError(f"{kernel} {label}: {name} != plain")
            turns: dict[str, list[float]] = {k: [] for k in fns}
            for name in list(fns) + list(fns)[::-1]:
                turns[name].append(graph_ms(fns[name]))
            print(json.dumps({
                "kernel": kernel, "model": label, "corpus": corpus,
                "lanes": lay.lanes, "chunk": lay.chunk,
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
