"""Command line: distributed grep on the card.

    python -m distributed_grep_tpu_torch grep PATTERN FILE... [-i]
        [--workers N] [--n-reduce R] [--device cuda|cpu] [--work-dir DIR]

Prints ``<abs path> (line number #N) <line>`` for every matching line, in
(path, line) order -- the reference CLI's default print mode, byte for
byte.  Exit status: 0 when a line matched, 1 when none did, 2 on error
(bad pattern, unreadable file, a pattern or device this package cannot
serve).  PATTERN is a grep -E regex: a literal or byte-class sequence
runs on the Shift-And kernel, any other regex on the Glushkov NFA kernel;
the few patterns outside both (backreferences and other syntax only
Python re knows, '^$'-style patterns that match the empty string at a
line's end) exit 2 naming their ROADMAP.md item.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m distributed_grep_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    g = sub.add_parser("grep", help="search files for a pattern")
    g.add_argument("pattern")
    g.add_argument("files", nargs="+")
    g.add_argument("-i", "--ignore-case", action="store_true")
    g.add_argument("--workers", type=int, default=2,
                   help="in-process worker threads")
    g.add_argument("--n-reduce", type=int, default=10)
    g.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the scan runs (default: cuda; cpu runs the "
                        "kernels' plain PyTorch versions)")
    g.add_argument("--work-dir", default=None)
    return p


def cmd_grep(args: argparse.Namespace) -> int:
    from distributed_grep_tpu_torch.models.dfa import RegexError
    from distributed_grep_tpu_torch.ops.engine import check_pattern
    from distributed_grep_tpu_torch.runtime.job import run_job
    from distributed_grep_tpu_torch.utils.config import JobConfig

    try:
        check_pattern(args.pattern, args.ignore_case)
    except RegexError as e:
        print(f"error: invalid pattern {args.pattern!r}: {e}", file=sys.stderr)
        return 2
    bad = [f for f in args.files if not Path(f).is_file()]
    if bad:
        print(f"error: cannot read: {', '.join(bad)}", file=sys.stderr)
        return 2
    cfg = JobConfig(
        input_files=[str(Path(f).resolve()) for f in args.files],
        app_options={"pattern": args.pattern,
                     "ignore_case": args.ignore_case},
        n_reduce=args.n_reduce,
        work_dir=args.work_dir or tempfile.mkdtemp(prefix="dgrep-"),
    )
    res = run_job(cfg, n_workers=args.workers, device=args.device)
    out = sys.stdout.buffer
    any_line = False
    for key, value in res.iter_results_sorted():
        out.write(f"{key} {value}\n".encode("utf-8", "surrogateescape"))
        any_line = True
    out.flush()
    return 0 if any_line else 1


def main(argv: list[str] | None = None) -> int:
    args = _parser().parse_args(argv)
    try:
        return cmd_grep(args)
    except (NotImplementedError, RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
