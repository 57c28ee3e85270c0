"""Many small files: packed cross-file batching against a host scan a file.

The port's counterpart of ``benchmarks/many_small_files.py``: a ``grep
-r``-shaped corpus of thousands of small files (about 1 in 8 holds a
needle), where the cost of a dispatch, not bandwidth, prices the work.

* ``host``: ``GrepEngine.scan`` a file on the host backend
  (``backend="cpu"``), one scan a file;
* ``packed``: ``GrepEngine.scan_batch`` on ``--device``: the files pack
  into windows of ``--batch-mb`` and each window is one scan
  (ops/layout.BatchPacker), on the card's kernels.

    python -m distributed_grep_tpu_torch.benchmarks.many_small_files \\
        [--files 2000] [--file-kb 32] [--pattern volcano | --set N]
        [--batch-mb 32] [--timing e2e|slope] [--check] [--device cuda|cpu]

``--timing e2e`` (default) times a second ``scan_batch`` (the first
builds and loads the kernels; reported as ``compile_s``); ``--timing
slope`` times the route's kernels alone over the whole corpus packed into
one buffer and resident on the device
(``benchmarks/baseline_configs.slope_gbps``).  ``--check`` holds every
file's packed lines to its host lines.  Prints one JSON line, with the
kernel launches of the packed scans; without a card and without
``--device cpu`` it prints nothing and exits 2.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

WORDS = (
    "the of and to in a is that for it as was with be by on not he this are "
    "at from or have an they which one you were all her she there would "
    "fff needle volcano anarchism philosophy wikipedia"
).split()


def synth_files(n_files: int, file_bytes: int, needles: list[bytes],
                seed: int = 9) -> list[tuple[str, bytes]]:
    """The reference's corpus: English-like files of ``file_bytes``, a
    needle injected into every eighth."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_files):
        lines, n = [], 0
        while n < file_bytes:
            k = int(rng.integers(3, 12))
            line = b" ".join(WORDS[int(rng.integers(0, len(WORDS)))].encode()
                             for _ in range(k))
            lines.append(line)
            n += len(line) + 1
        blob = b"\n".join(lines)[:file_bytes]
        if i % 8 == 0 and needles:
            nd = needles[int(rng.integers(0, len(needles)))]
            pos = int(rng.integers(0, max(1, len(blob) - len(nd) - 1)))
            blob = blob[:pos] + nd + blob[pos + len(nd):]
        out.append((f"f{i:05d}", blob))
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--files", type=int, default=2000)
    ap.add_argument("--file-kb", type=float, default=32)
    ap.add_argument("--pattern", default="volcano")
    ap.add_argument("--set", type=int, default=0, metavar="N",
                    help="an N-literal set (the FDR route) in place of the "
                         "single pattern")
    ap.add_argument("--batch-mb", type=float, default=32)
    ap.add_argument("--timing", default="e2e", choices=["e2e", "slope"])
    ap.add_argument("--check", action="store_true",
                    help="hold the packed per-file lines to the host's")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from distributed_grep_tpu_torch.benchmarks.baseline_configs import (
        slope_gbps,
    )
    from distributed_grep_tpu_torch.ops.device_scan import kernel_launches
    from distributed_grep_tpu_torch.ops.engine import GrepEngine
    from distributed_grep_tpu_torch.ops.layout import BatchPacker
    from distributed_grep_tpu_torch.utils.device import resolve_device

    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    file_bytes = int(args.file_kb * 1024)
    patterns = None
    pattern = args.pattern
    if args.set:
        rng = np.random.default_rng(5)
        pats = {args.pattern}
        while len(pats) < args.set:
            k = int(rng.integers(5, 10))
            pats.add("".join(chr(c) for c in rng.integers(97, 123, size=k)))
        patterns, pattern = sorted(pats), None
        needles = [p.encode() for p in patterns[:20]]
    else:
        needles = [pattern.encode()]
    files = synth_files(args.files, file_bytes, needles)
    total = sum(len(b) for _, b in files)
    out: dict = {"bench": "many_small_files", "files": args.files,
                 "file_bytes": file_bytes, "bytes": total,
                 "pattern": pattern or f"<set of {len(patterns)}>",
                 "device": args.device}

    host = GrepEngine(pattern, patterns=patterns, backend="cpu")
    t0 = time.perf_counter()
    host_results = [(name, host.scan(blob)) for name, blob in files]
    host_s = time.perf_counter() - t0
    out["host_gbps"] = total / 1e9 / host_s
    out["dispatches_host"] = args.files

    eng = GrepEngine(pattern, patterns=patterns, device=args.device,
                     batch_bytes=int(args.batch_mb * (1 << 20)))
    before = kernel_launches()
    t0 = time.perf_counter()
    packed_results = eng.scan_batch(files)
    first_s = time.perf_counter() - t0
    st = dict(eng.stats)
    out["mode"] = eng.mode
    out["batched_files"] = st.get("batched_files", 0)
    out["dispatches_packed"] = (st.get("batch_dispatches", 0)
                                + st.get("solo_dispatches", 0))
    out["dispatches_saved"] = st.get("dispatches_saved", 0)
    out["batch_fill_ratio"] = st.get("batch_fill_ratio", 0.0)
    out["small_host_scans"] = int(st.get("small_host_scan", 0))
    out["launches"] = {k: v - before[k] for k, v in kernel_launches().items()
                       if v - before[k]}
    if args.timing == "slope":
        packer = BatchPacker(total + args.files + 1)
        for name, blob in files:
            packer.add(name, blob)
        got = slope_gbps(eng, packer.pack().data)
        if got is None:
            out["error"] = f"no slope setup for mode {eng.mode}"
        else:
            out["packed_gbps"], out["engine"] = got
            out["timing"] = "slope(device-resident,packed)"
    else:
        t0 = time.perf_counter()
        packed_results = eng.scan_batch(files)
        dt = time.perf_counter() - t0
        out["packed_gbps"] = total / 1e9 / dt
        out["timing"] = "e2e"
        out["compile_s"] = first_s - dt
    if out.get("packed_gbps") and out.get("host_gbps"):
        out["speedup_vs_host"] = out["packed_gbps"] / out["host_gbps"]
    if args.check:
        want = dict(host_results)
        mism = [name for name, res in packed_results
                if not np.array_equal(res.matched_lines,
                                      want[name].matched_lines)]
        out["check"] = "ok" if not mism else f"MISMATCH {mism[:5]}"
        out["matched_lines"] = int(sum(r.n_matches
                                       for _, r in packed_results))
    print(json.dumps(out), flush=True)
    return 0 if "error" not in out and "MISMATCH" not in str(
        out.get("check", "")) else 1


if __name__ == "__main__":
    sys.exit(main())
