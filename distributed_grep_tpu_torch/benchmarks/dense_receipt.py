"""Match-dense receipt: the CLI wall and where the host's time goes.

    python -m distributed_grep_tpu_torch.benchmarks.dense_receipt [--mb 64]
        [--pattern the] [--check] [--device cuda|cpu]

A dense English-like corpus (lowercase words, ``the`` planted so about
40% of the lines match) makes the job's cost everything between the
kernels' output and ``mr-out-*``: the record build, the partition split,
the shuffle's encode and decode, the reduce's collation and format, the
CLI's print.  The counterpart of the reference's
``benchmarks/dense_receipt.py`` (same corpus recipe, same stage method;
no ``--ab``: it switched the reference's native record code off, and the
port's host library has no such switch).

* the CLI leg runs ``python -m distributed_grep_tpu_torch grep PATTERN
  CORPUS --metrics`` as a subprocess with stdout to a file: its wall
  (interpreter start included), and from its metrics the job's seconds
  (``cli_job_s``) and the print's (``cli_print_s``); then the same
  command over an empty file (``cli_floor_s``: the process's start, the
  card's set-up, an empty job and the exit);
* the stage leg runs the same job in this process with the pipeline's own
  entry points wrapped in wall clocks (``GrepEngine._scan``, the scan of
  each piece ``scan_file`` reads, as ``scan``; the app's
  ``map_path_fn``, ``bucketize``, the batches' ``split_by_partition``,
  ``encode_records``/``decode_records``, ``IdentityCollator.add_many``,
  ``LineBatch.format_lines_bytes``), summed over the worker threads.  The
  corpus fits one ``scan_file`` chunk, so the map gives a
  ``DeferredBatch`` and its record build -- the line gather the
  reference's receipt times as ``_records_for`` -- runs inside
  ``bucketize``, as ``record_build`` (the partition split): the
  ``bucketize`` seconds include it;
* ``--check`` holds the CLI's stdout to the reference-format oracle: every
  line of the corpus that Python ``re`` finds the pattern in, as
  ``<abs path> (line number #N) <line>``.  A mismatch exits 1.

Prints one JSON line.  Exits 2 without a card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]


def make_corpus(path: Path, n_bytes: int, seed: int = 6) -> None:
    """About 36-byte lines of lowercase words with 'the' planted so about
    40% of the lines match (the reference's receipt shape)."""
    rng = np.random.default_rng(seed)
    data = rng.integers(97, 123, size=n_bytes, dtype=np.uint8)  # a-z
    data[rng.integers(0, n_bytes, size=n_bytes // 6)] = 0x20
    data[rng.integers(0, n_bytes, size=n_bytes // 36)] = 0x0A
    pos = rng.integers(0, n_bytes - 4, size=n_bytes // 90)
    for i, b in enumerate(b"the"):
        data[pos + i] = b
    data[-1] = 0x0A
    path.write_bytes(data.tobytes())


class StageClock:
    """Wall seconds per stage, summed, by wrapping entry points in place;
    the originals come back when the ``with`` block ends."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self._saved: list = []
        self._lock = threading.Lock()
        self._active = threading.local()  # the stages a thread is inside

    def wrap(self, obj, name: str, stage: str) -> None:
        """Time ``obj.name`` as ``stage``; a call made from inside the same
        stage (a batch's split calling its built batch's) counts once."""
        fn = getattr(obj, name)
        self._saved.append((obj, name, fn))

        @functools.wraps(fn)
        def timed(*a, **k):
            active = self._active.__dict__.setdefault("stages", set())
            if stage in active:
                return fn(*a, **k)
            active.add(stage)
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                active.discard(stage)
                with self._lock:
                    self.totals[stage] = (self.totals.get(stage, 0.0)
                                          + time.perf_counter() - t0)

        setattr(obj, name, timed)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for obj, name, fn in reversed(self._saved):
            setattr(obj, name, fn)


def stage_run(corpus: Path, pattern: str, work: Path, device: str) -> dict:
    """The job in this process, its stages timed."""
    from distributed_grep_tpu_torch.apps import grep_cuda
    from distributed_grep_tpu_torch.ops.engine import GrepEngine
    from distributed_grep_tpu_torch.runtime import columnar, shuffle
    from distributed_grep_tpu_torch.runtime.job import run_job
    from distributed_grep_tpu_torch.utils.config import JobConfig

    from distributed_grep_tpu_torch.apps.loader import from_module

    # a throwaway work dir, as the CLI's: no journal, no fsync
    cfg = JobConfig(input_files=[str(corpus)], work_dir=str(work),
                    app_options={"pattern": pattern}, n_reduce=10,
                    journal=False, durable=False)
    with StageClock() as clock:
        clock.wrap(GrepEngine, "_scan", "scan")
        clock.wrap(grep_cuda, "map_path_fn", "map_path_fn")
        clock.wrap(shuffle, "bucketize", "bucketize")
        clock.wrap(columnar.LineBatch, "split_by_partition", "record_build")
        clock.wrap(columnar.DeferredBatch, "split_by_partition",
                   "record_build")
        clock.wrap(shuffle, "encode_records", "shuffle_encode")
        clock.wrap(shuffle, "decode_records", "shuffle_decode")
        clock.wrap(columnar.IdentityCollator, "add_many", "collate_add")
        clock.wrap(columnar.LineBatch, "format_lines_bytes", "reduce_format")
        t0 = time.perf_counter()
        # the module the clock wrapped, not a fresh instance
        res = run_job(cfg, n_workers=2, device=device,
                      app=from_module(grep_cuda))
        job_s = time.perf_counter() - t0
    return {
        "job_s": job_s,
        "stages": dict(sorted(clock.totals.items())),
        "seconds": dict(res.metrics["seconds"]),
        "counters": dict(res.metrics["counters"]),
    }


def cli_run(corpus: Path, pattern: str, device: str, out: Path
            ) -> tuple[float, dict]:
    """The CLI's wall and its --metrics seconds (its job, its print)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    with open(out, "wb") as f:
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "distributed_grep_tpu_torch", "grep",
             pattern, str(corpus), "--device", device, "--metrics"],
            stdout=f, stderr=subprocess.PIPE, env=env, timeout=1200)
        wall = time.perf_counter() - t0
    if r.returncode not in (0, 1):
        raise RuntimeError(f"CLI failed rc={r.returncode}: "
                           f"{r.stderr[-500:].decode(errors='replace')}")
    err = r.stderr.decode(errors="replace")
    metrics, _ = json.JSONDecoder().raw_decode(err[err.index("{"):])
    return wall, metrics["seconds"]


def oracle(corpus: Path, pattern: str) -> bytes:
    """The reference-format output of a Python re search, line by line."""
    from distributed_grep_tpu_torch.models.dfa import expand_posix_classes

    rx = re.compile(expand_posix_classes(
        pattern.encode("utf-8", "surrogateescape")))
    head = f"{corpus.resolve()} (line number #"
    data = corpus.read_bytes()
    lines = data.split(b"\n")
    if data.endswith(b"\n"):
        lines.pop()
    return "".join(
        f"{head}{n}) {ln.decode('utf-8', 'replace')}\n"
        for n, ln in enumerate(lines, 1) if rx.search(ln)
    ).encode("utf-8", "surrogateescape")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mb", type=float, default=64,
                    help="corpus size in MiB")
    ap.add_argument("--pattern", default="the")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from distributed_grep_tpu_torch.utils.device import resolve_device

    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    result: dict = {"benchmark": "dense_receipt", "mb": args.mb,
                    "pattern": args.pattern, "device": args.device}
    with tempfile.TemporaryDirectory(prefix="dgrep-dense-") as td:
        tmp = Path(td)
        corpus = tmp / "corpus.txt"
        t0 = time.perf_counter()
        make_corpus(corpus, int(args.mb * (1 << 20)))
        result["gen_s"] = time.perf_counter() - t0
        out = tmp / "cli.out"
        wall, seconds = cli_run(corpus, args.pattern, args.device, out)
        result["cli_wall_s"] = wall
        result["cli_job_s"] = seconds["cli_job"]
        result["cli_print_s"] = seconds["cli_print"]
        empty = tmp / "empty.txt"
        empty.write_bytes(b"")
        result["cli_floor_s"] = cli_run(empty, args.pattern, args.device,
                                        tmp / "empty.out")[0]
        got = out.read_bytes()
        result["matched_lines"] = got.count(b"\n")
        if args.check:
            result["check"] = ("ok" if got == oracle(corpus, args.pattern)
                               else "MISMATCH")
        result.update(stage_run(corpus, args.pattern, tmp / "job",
                                args.device))
    print(json.dumps(result))
    return 1 if result.get("check") == "MISMATCH" else 0


if __name__ == "__main__":
    sys.exit(main())
