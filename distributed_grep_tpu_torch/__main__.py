"""Command line: distributed grep on the card.

    python -m distributed_grep_tpu_torch grep [PATTERN] FILE... [-i]
        [-e PATTERN]... [-f FILE] [-F] [-E] [--max-errors K]
        [--workers N] [--n-reduce R] [--device cuda|cpu] [--work-dir DIR]

Prints ``<abs path> (line number #N) <line>`` for every matching line, in
(path, line) order -- the reference CLI's default print mode, byte for
byte.  Exit status: 0 when a line matched, 1 when none did, 2 on error
(bad pattern, unreadable file, a pattern or device this package cannot
serve).

PATTERN is a grep -E regex: a literal or byte-class sequence runs on the
Shift-And kernel, a regex that denotes a finite literal set on the literal
set kernels, any other regex on the Glushkov NFA kernel; the few patterns
outside them (backreferences and other syntax only Python re knows,
'^$'-style patterns that match the empty string at a line's end) exit 2
naming their ROADMAP.md item.  The pattern options follow the reference
CLI (and GNU grep):

  -e PATTERN  repeatable; several -e without -F join into one
              ``(?:...)`` alternation;
  -f FILE     one member per line: a literal set (grep -F -f), or with -E
              one regex per line joined into an alternation; an empty line
              matches every line;
  -F          PATTERN / -e patterns are literal strings; a newline inside
              one separates members of a set;
  -E          with -f: the lines are regexes (-E with -F exits 2).

  --max-errors K
              agrep: lines holding a match of PATTERN within K edit
              errors (K = 1..3), on the Wu-Manber kernel; PATTERN must be
              one literal or class sequence of at most 32 symbols (exit 2
              otherwise, and with -f or a set of -F patterns).

A positional PATTERN displaced by -e or -f is the first input file.
Literal sets run on the FDR filter kernel, with an exact host confirm, or,
when every member is 1-2 bytes, on the exact pairset kernel.
"""

from __future__ import annotations

import argparse
import re
import sys
import tempfile
from pathlib import Path


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m distributed_grep_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    g = sub.add_parser("grep", help="search files for a pattern")
    g.add_argument("pattern", nargs="?", default=None)
    g.add_argument("files", nargs="*")
    g.add_argument("-i", "--ignore-case", action="store_true")
    g.add_argument("-e", "--regexp", action="append", default=None,
                   metavar="PATTERN", dest="e_patterns",
                   help="pattern to match (repeatable; lines matching any "
                        "are selected)")
    g.add_argument("-f", "--patterns-file", default=None,
                   help="pattern set, one per line: literals by default "
                        "(grep -F -f), or regexes with -E (one alternation)")
    g.add_argument("-F", "--fixed-strings", action="store_true",
                   help="treat PATTERN / -e patterns as literal strings")
    g.add_argument("-E", "--extended-regexp", action="store_true",
                   help="with -f: treat pattern-file lines as regexes")
    g.add_argument("--max-errors", type=int, default=0, metavar="K",
                   help="agrep: match within K edit errors (literal/class "
                        "patterns, K=1..3)")
    g.add_argument("--workers", type=int, default=2,
                   help="in-process worker threads")
    g.add_argument("--n-reduce", type=int, default=10)
    g.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the scan runs (default: cuda; cpu runs the "
                        "kernels' plain PyTorch versions)")
    g.add_argument("--work-dir", default=None)
    return p


def _validate_regex(rx: str) -> None:
    """re.compile after POSIX-class expansion: the user-facing validity
    check; both failures raise re.error."""
    from distributed_grep_tpu_torch.models.dfa import (
        RegexError,
        expand_posix_classes,
    )

    try:
        re.compile(expand_posix_classes(rx))
    except RegexError as e:
        raise re.error(str(e)) from e


def _has_backref(rx: str) -> bool:
    """True when the regex uses a group-number-sensitive construct (a
    backreference or a conditional group), which joining it into an
    alternation would silently repoint; unparseable counts as True."""
    import re._parser as parser

    def walk(node) -> bool:
        if isinstance(node, parser.SubPattern):
            return any(walk(item) for item in node)
        if isinstance(node, tuple):
            if node[0] in (parser.GROUPREF, parser.GROUPREF_EXISTS):
                return True
            return any(walk(x) for x in node[1:])
        if isinstance(node, list):
            return any(walk(x) for x in node)
        return False

    try:
        return walk(parser.parse(rx))
    except Exception:  # noqa: BLE001 -- unparseable: not joinable
        return True


def _error(msg: str) -> tuple[int, None]:
    print(f"error: {msg}", file=sys.stderr)
    return 2, None


def _join(regexes: list[str], what: str) -> tuple[int, str | None]:
    """Several regexes as one non-capturing alternation, each validated."""
    for rx in regexes:
        try:
            _validate_regex(rx)
        except re.error as e:
            return _error(f"invalid pattern {rx!r}: {e}")
    if len(regexes) > 1 and any(_has_backref(rx) for rx in regexes):
        return _error(f"{what} use backreferences, which do not survive "
                      f"being joined into one alternation")
    return 0, "(?:" + "|".join(f"(?:{rx})" for rx in regexes) + ")"


def _resolve_pattern_args(args: argparse.Namespace) -> tuple[int, list | None]:
    """Resolve -e/-f/-F/-E and the positional PATTERN into the query, as
    the reference CLI does.  Returns (0, patterns): ``patterns`` the
    literal set, or None with ``args.pattern`` the single pattern; or
    (2, None) after printing the diagnostic."""
    patterns: list[str] | None = None
    if args.e_patterns:
        if args.pattern is not None:  # the positional slot is a file
            args.files.insert(0, args.pattern)
            args.pattern = None
        if args.patterns_file:
            return _error("use -e or -f, not both")
        if args.fixed_strings:
            patterns = [p for e in args.e_patterns for p in e.split("\n")]
        elif len(args.e_patterns) == 1:
            args.pattern = args.e_patterns[0]
        else:
            rc, args.pattern = _join(args.e_patterns, "-e patterns")
            if rc:
                return rc, None
    elif (args.fixed_strings and args.pattern is not None
          and not args.patterns_file):
        # (with -f the positional slot is a file: the reference CLI
        # escapes it first, and then cannot open it)
        if "\n" in args.pattern:
            patterns = args.pattern.split("\n")  # grep -F: newline = OR
        else:
            args.pattern = re.escape(args.pattern)
    if args.patterns_file:
        if args.pattern is not None:  # -f displaces the positional pattern
            args.files.insert(0, args.pattern)
            args.pattern = None
        pf = Path(args.patterns_file)
        if not pf.exists():
            return _error(f"no such file: {args.patterns_file}")
        # bytes split on '\n' only (splitlines would also split on \r,
        # \v, \f, \x85 inside members); members need not be UTF-8
        raw = pf.read_bytes().split(b"\n")
        if raw and raw[-1] == b"":
            raw.pop()  # a trailing newline ends the last member
        if not raw:
            return _error(f"empty pattern file: {args.patterns_file}")
        decoded = [ln.decode("utf-8", "surrogateescape") for ln in raw]
        if any(not ln for ln in raw):
            patterns, args.pattern = None, ""  # matches every line
        elif args.extended_regexp:
            patterns = None
            rc, args.pattern = _join(decoded, "-E -f pattern lines")
            if rc:
                return rc, None
        else:
            patterns = decoded
    if args.pattern is None and patterns is None:
        return _error("need a PATTERN or -f FILE")
    if patterns is None:
        try:
            _validate_regex(args.pattern)
        except re.error as e:
            return _error(f"invalid pattern {args.pattern!r}: {e}")
    return 0, patterns


def _check_max_errors(args: argparse.Namespace, patterns) -> int:
    """The reference CLI's --max-errors refusals: 0, or 2 after printing
    the diagnostic."""
    from distributed_grep_tpu_torch.models.approx import MAX_ERRORS
    from distributed_grep_tpu_torch.models.shift_and import try_compile_shift_and

    if patterns:
        return _error("--max-errors applies to a single pattern, not -f")[0]
    if not 1 <= args.max_errors <= MAX_ERRORS:
        return _error(f"--max-errors must be 1..{MAX_ERRORS}")[0]
    if try_compile_shift_and(args.pattern, ignore_case=args.ignore_case) is None:
        return _error("--max-errors needs a literal/class-sequence pattern "
                      "of <= 32 symbols")[0]
    return 0


def cmd_grep(args: argparse.Namespace) -> int:
    from distributed_grep_tpu_torch.models.dfa import RegexError
    from distributed_grep_tpu_torch.ops.engine import check_pattern
    from distributed_grep_tpu_torch.runtime.job import run_job
    from distributed_grep_tpu_torch.utils.config import JobConfig

    if args.fixed_strings and args.extended_regexp:
        print("error: -E and -F are conflicting matchers", file=sys.stderr)
        return 2
    rc, patterns = _resolve_pattern_args(args)
    if rc:
        return rc
    if args.max_errors:
        rc = _check_max_errors(args, patterns)
        if rc:
            return rc
    if not args.files:
        print("error: no input FILE given", file=sys.stderr)
        return 2
    if patterns is None and not args.max_errors:
        try:
            check_pattern(args.pattern, args.ignore_case)
        except RegexError as e:
            print(f"error: invalid pattern {args.pattern!r}: {e}",
                  file=sys.stderr)
            return 2
    bad = [f for f in args.files if not Path(f).is_file()]
    if bad:
        print(f"error: cannot read: {', '.join(bad)}", file=sys.stderr)
        return 2
    query = ({"patterns": patterns} if patterns is not None
             else {"pattern": args.pattern, "max_errors": args.max_errors})
    cfg = JobConfig(
        input_files=[str(Path(f).resolve()) for f in args.files],
        app_options={**query, "ignore_case": args.ignore_case},
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
