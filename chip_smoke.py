#!/usr/bin/env python3
"""Smoke run of distributed_grep_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--file-mb 128] [--n-files 8]

Phase 1  environment: the card's name and power limit, torch/CUDA versions,
         the build of every CUDA source of the package (nvcc, timed).
Phase 2  every kernel against its plain PyTorch version on the same inputs
         (bit-identical words: tolerance 0), at the main path's shapes and
         at small ones, both scan modes, five pattern models.
Phase 3  the main path at real size: 8 files of 128 MB made from --seed
         (English-word lines with injected needles), three queries through
         runtime.job.run_job on "cuda" -- 'volcano' (sparse, rare-class
         filter), '-i Volcano', 'the' (dense: the on-device dense
         confirm), 'being it' (its rare-class filter, b??ng???, is
         defeated by this corpus: dense confirm, then the defeat guard
         drops the filter) -- each checked line for line against a plain
         Python oracle, plus the CLI on one file.  The kernel's launch count is
         zeroed just before the queries and read just after.  Then the
         kernel, its plain version and the sparse fetch are timed with CUDA
         events at the main path's segment shape.

The last two lines of standard output are one JSON object with every
kernel's numbers and one JSON object with the device.  Any failure raises
(exit status 1); without CUDA, or without the package beside this file,
the script prints no result and exits 2.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / ".smoke"  # git-ignored: corpus and job state, removed at exit

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
# 32-bit integer issue rate: 132 SMs x 64 INT32 lanes x 1.98 GHz boost
# (an SM has half as many INT32 as FP32 lanes; the 67 TFLOP/s fp32 figure
# counts an FMA as two operations).
H100_INT32_OPS_PER_S = 132 * 64 * 1.98e9
SHIFT_AND_OPS_PER_BYTE = 5  # load, table lookup, shift-or, and, accumulate

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


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# ------------------------------------------------------------- corpus
def words_block(rng, n_bytes: int):
    """English-word lines (3..23 words each, words drawn uniformly from
    _WORDS, as the reference benchmark's corpus recipe), vectorized:
    exactly n_bytes bytes."""
    import numpy as np

    vocab = [w.encode() for w in _WORDS]
    wlen = np.array([len(w) for w in vocab], dtype=np.int64)
    table = np.zeros((len(vocab), int(wlen.max())), dtype=np.uint8)
    for i, w in enumerate(vocab):
        table[i, : len(w)] = np.frombuffer(w, np.uint8)
    n_lines = n_bytes // 40 + 16
    per_line = rng.integers(3, 24, size=n_lines)
    idx = rng.integers(0, len(vocab), size=int(per_line.sum()))
    tok_len = wlen[idx] + 1  # word + separator
    pos = np.concatenate(([0], np.cumsum(tok_len)[:-1]))
    total = int(tok_len.sum())
    if total < n_bytes:  # lines average ~60 bytes: never at these sizes
        raise RuntimeError("corpus block estimate too small")
    out = np.empty(total, dtype=np.uint8)
    for k in range(table.shape[1]):
        sel = wlen[idx] > k
        out[pos[sel] + k] = table[idx[sel], k]
    sep = np.full(idx.size, ord(" "), dtype=np.uint8)
    sep[np.cumsum(per_line) - 1] = ord("\n")
    out[pos + wlen[idx]] = sep
    return out[:n_bytes]


def make_corpus(seed: int, n_files: int, file_bytes: int) -> list[Path]:
    import numpy as np

    rng = np.random.default_rng(seed)
    block = words_block(rng, 64 << 20)
    needles = [b"volcano", b"Volcano", b"VOLCANO", b"volCANo"]
    corpus = WORK / "corpus"
    corpus.mkdir(parents=True, exist_ok=True)
    paths = []
    reps = -(-file_bytes // block.size)
    for i in range(n_files):
        data = np.tile(block, reps)[:file_bytes].copy()
        n_inj = 1000 * file_bytes // (64 << 20)
        where = np.sort(rng.choice(file_bytes - 16, size=n_inj, replace=False))
        kinds = rng.integers(0, len(needles), size=n_inj)
        for p, k in zip(where.tolist(), kinds.tolist()):
            nd = needles[k]
            data[p : p + len(nd)] = np.frombuffer(nd, np.uint8)
        path = corpus / f"part-{i:02d}.txt"
        data.tofile(path)
        paths.append(path)
    return paths


def oracle_lines(path: Path, pred) -> list[tuple[int, str]]:
    data = path.read_bytes()
    lines = data.split(b"\n")
    if data.endswith(b"\n"):
        lines.pop()
    return [(i, ln.decode("utf-8", "replace"))
            for i, ln in enumerate(lines, 1) if pred(ln)]


def job_lines(res) -> dict[str, list[tuple[int, str]]]:
    marker = " (line number #"
    out: dict[str, list] = {}
    for k, v in res.iter_results():
        i = k.rfind(marker)
        out.setdefault(k[:i], []).append((int(k[i + len(marker) : -1]), v))
    for lst in out.values():
        lst.sort()
    return out


# -------------------------------------------------------------- phases
def phase_kernels(torch, np, cuda_scan, sa_mod) -> int:
    """Kernel words vs the plain version's, bit for bit.  Returns the
    largest absolute difference seen (0 or the script has failed)."""
    from distributed_grep_tpu_torch.ops.layout import choose_layout, to_device_array

    rng = np.random.default_rng(1234)
    full = sa_mod.try_compile_shift_and("volcano")
    models = {
        "volcano": full,
        "volcano-filter": sa_mod.filtered_for_device(full),
        "-i Volcano": sa_mod.try_compile_shift_and("Volcano", ignore_case=True),
        "h[ae]llo": sa_mod.try_compile_shift_and("h[ae]llo"),
        "32 classes": sa_mod.try_compile_shift_and("[a-z ]" * 32),
    }
    assert all(m is not None for m in models.values())
    # (chunk, lanes): the reference tile shape, the main path's 64 MB
    # segment shape, and a small multi-word layout
    shapes = [(512, 4096), (1024, 65536), (160, 64)]
    worst = 0
    for chunk, lanes in shapes:
        text = words_block(rng, chunk * lanes)
        for p in rng.choice(text.size - 40, size=max(4, text.size // 20000),
                            replace=False).tolist():
            text[p : p + 7] = np.frombuffer(b"volcano", np.uint8)
            text[p + 20 : p + 25] = np.frombuffer(b"hallo", np.uint8)
        lay = choose_layout(text.size, target_lanes=lanes, min_chunk=chunk,
                            lane_multiple=32, chunk_multiple=32)
        assert (lay.chunk, lay.lanes) == (chunk, lanes), lay
        arr = to_device_array(text.tobytes(), lay)
        if chunk == 160:
            # a match ending across a word edge: bytes 29..35 of stripe 3
            arr[29:36, 3] = np.frombuffer(b"volcano", np.uint8)
        cpu = torch.from_numpy(arr)
        dev = cpu.cuda()
        for name, model in models.items():
            for coarse in (True, False):
                got = cuda_scan.shift_and_scan_words(dev, model, coarse)
                torch.cuda.synchronize()
                want = cuda_scan.shift_and_scan_words_plain(cpu, model, coarse)
                g = got.cpu().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
                w = want.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
                err = int((g - w).abs().max())
                worst = max(worst, err)
                nz = int(torch.count_nonzero(w))
                if not torch.equal(got.cpu(), want) or err:
                    raise AssertionError(
                        f"kernel != plain: {name} coarse={coarse} "
                        f"chunk={chunk} lanes={lanes} max_abs_err={err}")
                log(f"  ok {name:15s} coarse={int(coarse)} chunk={chunk:5d} "
                    f"lanes={lanes:6d} nonzero words={nz}")
    return worst


def cuda_ms(torch, fn, reps: int) -> float:
    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--file-mb", type=int, default=128)
    ap.add_argument("--n-files", type=int, default=8)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after phase 2 (build + kernel checks); "
                         "prints no result lines")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("error: torch.cuda.is_available() is False: this smoke run "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        from distributed_grep_tpu_torch.apps import grep_cuda
        from distributed_grep_tpu_torch.models import shift_and as sa_mod
        from distributed_grep_tpu_torch.ops import _build, cuda_scan
        from distributed_grep_tpu_torch.ops.layout import choose_layout
        from distributed_grep_tpu_torch.ops.scan_torch import sparse_nonzero
        from distributed_grep_tpu_torch.runtime.job import run_job
        from distributed_grep_tpu_torch.utils.config import JobConfig
    except ImportError as e:
        print(f"error: distributed_grep_tpu_torch is not importable beside "
              f"this script ({e})", file=sys.stderr)
        return 2
    import numpy as np

    t_all = time.perf_counter()
    # ---------------------------------------------------------- phase 1
    card = card_line()
    log("== phase 1: environment")
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s "
        f"({', '.join(_build.SOURCES)})")
    for name, text in _build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    # ---------------------------------------------------------- phase 2
    log("== phase 2: kernel vs plain version (tolerance 0: integer words)")
    max_err = phase_kernels(torch, np, cuda_scan, sa_mod)
    log(f"phase 2 launches (comparisons, not counted): {cuda_scan.launches}")
    if args.kernels_only:
        return 0

    # ---------------------------------------------------------- phase 3
    log(f"== phase 3: main path, {args.n_files} x {args.file_mb} MB, "
        f"seed {args.seed}, card: {card}")
    if WORK.exists():
        shutil.rmtree(WORK)
    try:
        t0 = time.perf_counter()
        files = make_corpus(args.seed, args.n_files, args.file_mb << 20)
        total_bytes = sum(p.stat().st_size for p in files)
        log(f"corpus: {len(files)} files, {total_bytes} bytes, "
            f"{time.perf_counter() - t0:.1f} s")
        queries = [
            ("volcano", False, lambda ln: b"volcano" in ln),
            ("Volcano", True, lambda ln: b"volcano" in ln.lower()),
            ("the", False, lambda ln: b"the" in ln),
            ("being it", False, lambda ln: b"being it" in ln),
        ]
        segs_per_query = sum(-(-p.stat().st_size // (64 << 20)) for p in files)
        per_query = []
        cuda_scan.reset_launches()
        for pattern, ic, _pred in queries:
            before = cuda_scan.launches
            cfg = JobConfig(
                input_files=[str(p) for p in files],
                app_options={"pattern": pattern, "ignore_case": ic},
                n_reduce=10, task_timeout_s=60.0,
                work_dir=str(WORK / f"job-{pattern}-{int(ic)}"),
            )
            t0 = time.perf_counter()
            res = run_job(cfg, n_workers=args.workers, device="cuda")
            wall = time.perf_counter() - t0
            totals = dict(grep_cuda._engine.totals)
            totals.update(res.metrics["seconds"])
            per_query.append((pattern, ic, res, wall,
                              cuda_scan.launches - before, totals))
        main_launches = cuda_scan.launches
        log(f"main path launches: {main_launches} "
            f"(segments per query: {segs_per_query})")

        for (pattern, ic, pred), (_, _, res, wall, n_launch, totals) in zip(
                queries, per_query):
            t0 = time.perf_counter()
            got = job_lines(res)
            n_rec = 0
            for p in files:
                want = oracle_lines(p, pred)
                if got.get(str(p), []) != want:
                    raise AssertionError(
                        f"query {'-i ' if ic else ''}{pattern}: job output "
                        f"for {p.name} differs from the oracle "
                        f"({len(got.get(str(p), []))} vs {len(want)} lines)")
                n_rec += len(want)
            if n_launch < segs_per_query:
                raise AssertionError(
                    f"query {pattern}: {n_launch} kernel launches for "
                    f"{segs_per_query} segments")
            if pattern == "being it" and not (
                    totals["dense_confirms"] and totals["filter_defeated"]):
                raise AssertionError(
                    f"query {pattern}: expected the dense confirm and the "
                    f"defeat guard, engine totals {totals}")
            log(f"query {'-i ' if ic else ''}{pattern!r}: {n_rec} lines "
                f"identical to the oracle (checked in "
                f"{time.perf_counter() - t0:.1f} s); job wall {wall:.3f} s = "
                f"{total_bytes / wall / 1e9:.3f} GB/s end to end; "
                f"{n_launch} launches [{card}]")
            log("  engine totals (seconds summed over worker threads): "
                + json.dumps(totals, sort_keys=True))
            shutil.rmtree(res.metrics["work_dir"], ignore_errors=True)

        # the CLI on one file, against the same oracle's display lines
        t0 = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "distributed_grep_tpu_torch", "grep",
             "volcano", str(files[0]), "--work-dir", str(WORK / "cli")],
            cwd=ROOT, capture_output=True, check=True, timeout=600,
        )
        want_lines = oracle_lines(files[0], lambda ln: b"volcano" in ln)
        want = "".join(f"{files[0].resolve()} (line number #{n}) {v}\n"
                       for n, v in want_lines)
        if cli.stdout != want.encode("utf-8", "surrogateescape"):
            raise AssertionError("CLI output differs from the oracle")
        log(f"CLI grep volcano {files[0].name}: {len(want_lines)} lines "
            f"identical to the oracle ({time.perf_counter() - t0:.1f} s)")

        # ------------------------------------------- timings (not counted)
        seg = files[0].read_bytes()[: 64 << 20]
        lay = choose_layout(len(seg), **grep_cuda._engine.layout_kwargs())
        from distributed_grep_tpu_torch.ops.layout import to_device_array

        dev = torch.from_numpy(to_device_array(seg, lay)).cuda()
        full = sa_mod.try_compile_shift_and("volcano")
        filt = sa_mod.filtered_for_device(full)
        ms = cuda_ms(torch, lambda: cuda_scan.shift_and_scan_words(
            dev, filt, True), 20)
        ms_full = cuda_ms(torch, lambda: cuda_scan.shift_and_scan_words(
            dev, full, True), 20)
        ms_exact = cuda_ms(torch, lambda: cuda_scan.shift_and_scan_words(
            dev, full, False), 20)
        plain_ms = cuda_ms(torch, lambda: cuda_scan.shift_and_scan_words_plain(
            dev, filt, True), 2)
        rowmajor = dev.t().contiguous()  # the segment as the document lies
        transpose_ms = cuda_ms(torch, lambda: rowmajor.t().contiguous(), 20)
        words = cuda_scan.shift_and_scan_words(dev, filt, True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            idx, _v = sparse_nonzero(words)
        fetch_ms = (time.perf_counter() - t0) * 100
        n_in = lay.chunk * lay.lanes
        n_out = (lay.chunk // 32) * lay.lanes * 4
        bytes_ms = (n_in + n_out) / H100_BYTES_PER_S * 1e3
        ops_ms = SHIFT_AND_OPS_PER_BYTE * n_in / H100_INT32_OPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        gbs = len(seg) / (ms / 1e3) / 1e9
        log(f"kernel shift_and coarse, volcano filter, chunk={lay.chunk} "
            f"lanes={lay.lanes} (one 64 MB segment): {ms:.4f} ms = "
            f"{gbs:.1f} GB/s; full model {ms_full:.4f} ms; exact mode "
            f"{ms_exact:.4f} ms; plain version on the card {plain_ms:.2f} ms; "
            f"layout transpose on the card {transpose_ms:.4f} ms; "
            f"bound {bound_ms:.4f} ms (bytes {bytes_ms:.4f}, ops "
            f"{ops_ms:.4f}); sparse fetch of {idx.size} words "
            f"{fetch_ms:.3f} ms [{card}]")
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "shift_and",
        "route": "cuda",
        "source": "distributed_grep_tpu_torch/csrc/shift_and.cu",
        "replaces": "distributed_grep_tpu/ops/pallas_scan.py:91",
        "launches": main_launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    sys.exit(main())
