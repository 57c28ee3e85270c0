"""Command line: distributed grep on the card.

    python -m distributed_grep_tpu_torch grep [PATTERN] FILE... [-i]
        [-e PATTERN]... [-f FILE] [-F] [-E] [--max-errors K]
        [-v] [-w] [-x] [-c] [-l] [-L] [-q] [-m NUM] [-h] [-s] [-n] [-H] [-a]
        [--workers N] [--n-reduce R] [--device cuda|cpu] [--work-dir DIR]

Prints ``<abs path> (line number #N) <line>`` for every selected line, in
(path, line) order -- the reference CLI's default print mode, byte for
byte.  Exit status: 0 when a line was selected, 1 when none was, 2 on
error (bad pattern, an unreadable file or directory, a pattern, option or
device this package cannot serve); -q exits 0 on a selected line even
after a file error.

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
              otherwise, with -f or a set of -F patterns, and with -w/-x).

The selection and output options, as the reference CLI's:

  -v          select the lines that do not match;
  -w, -x      the match must be a whole word / the whole line (-x wins
              over -w): the card scans the plain pattern and the host
              confirms each candidate line;
  -c          one count per file, in argument order (``PATH:N`` with
              several files or -H, ``N`` alone for one file or with -h);
  -l, -L      the names of the files with / without a selected line; -L's
              exit status follows whether any line was selected;
  -q          no output: the exit status alone;
  -m NUM      at most NUM selected lines per file (printed or counted);
              a negative NUM exits 2;
  -h          print lines without the path;
  -s          no messages about missing or unreadable files (the exit
              status is still 2);
  -n, -H, -a  accepted for GNU grep compatibility: line numbers and paths
              always print, input is always read as binary-safe text (-H
              does put the path before -c's count for one file).

Still to port, each exiting 2 with the ROADMAP.md item named: -o, -A/-B/-C,
-b, -r/-R, --include/--exclude/--exclude-dir and standard input (FILE ``-``
or no FILE) -- item 7's remainder; --follow -- item 5.

A positional PATTERN displaced by -e or -f is the first input file.
Literal sets run on the FDR filter kernel, with an exact host confirm, or,
when every member is 1-2 bytes, on the exact pairset kernel.
"""

from __future__ import annotations

import argparse
import os
import re
import sys
import tempfile
from pathlib import Path

ITEM_7B = "ROADMAP.md 'Slices still to port', item 7's remainder"
ITEM_5 = "ROADMAP.md 'Slices still to port', item 5 (warm tiers)"


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m distributed_grep_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    # add_help=False frees -h for grep's no-filename flag; --help stays
    g = sub.add_parser("grep", help="search files for a pattern",
                       add_help=False)
    g.add_argument("--help", action="help",
                   help="show this help message and exit")
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
    g.add_argument("-v", "--invert", action="store_true",
                   help="select non-matching lines")
    g.add_argument("-w", "--word-regexp", action="store_true",
                   help="match only whole words")
    g.add_argument("-x", "--line-regexp", action="store_true",
                   help="match only whole lines")
    g.add_argument("-c", "--count", action="store_true",
                   help="print a count of selected lines per file")
    g.add_argument("-l", "--files-with-matches", action="store_true",
                   help="print only the names of files with selected lines")
    g.add_argument("-L", "--files-without-match", action="store_true",
                   help="print only the names of files without selected "
                        "lines")
    g.add_argument("-q", "--quiet", "--silent", action="store_true",
                   help="no output; exit 0 iff a line is selected")
    g.add_argument("-m", "--max-count", type=int, default=None,
                   metavar="NUM", help="stop after NUM selected lines per "
                                       "file")
    g.add_argument("-h", "--no-filename", action="store_true",
                   help="print lines without the file name")
    g.add_argument("-s", "--no-messages", action="store_true",
                   help="no messages about missing or unreadable files")
    g.add_argument("-n", "--line-number", action="store_true",
                   help="accepted for GNU compatibility (line numbers "
                        "always print)")
    g.add_argument("-H", "--with-filename", action="store_true",
                   help="accepted for GNU compatibility (file names always "
                        "print unless -h; puts the name before -c's count)")
    g.add_argument("-a", "--text", action="store_true",
                   help="accepted for GNU compatibility (input is always "
                        "binary-safe text)")
    # parsed so that they exit 2 naming their ROADMAP.md item
    g.add_argument("-o", "--only-matching", action="store_true",
                   help=f"not ported yet ({ITEM_7B})")
    for flag, long_ in (("-A", "--after-context"), ("-B", "--before-context"),
                        ("-C", "--context")):
        g.add_argument(flag, long_, type=int, default=None, metavar="N",
                       help=f"not ported yet ({ITEM_7B})")
    g.add_argument("-b", "--byte-offset", action="store_true",
                   help=f"not ported yet ({ITEM_7B})")
    g.add_argument("-r", "--recursive", action="store_true",
                   help=f"not ported yet ({ITEM_7B})")
    g.add_argument("-R", "--dereference-recursive", action="store_true",
                   help=f"not ported yet ({ITEM_7B})")
    for long_ in ("--include", "--exclude", "--exclude-dir"):
        g.add_argument(long_, action="append", default=None, metavar="GLOB",
                       help=f"not ported yet ({ITEM_7B})")
    g.add_argument("--follow", action="store_true",
                   help=f"not ported yet ({ITEM_5})")
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


def _deferred_flag(args: argparse.Namespace) -> str | None:
    """The first option given that this package has not ported, with the
    ROADMAP.md item that will, or None."""
    for flag, on in (
            ("-o", args.only_matching),
            ("-A", args.after_context is not None),
            ("-B", args.before_context is not None),
            ("-C", args.context is not None),
            ("-b", args.byte_offset),
            ("-r", args.recursive),
            ("-R", args.dereference_recursive),
            ("--include", args.include),
            ("--exclude", args.exclude),
            ("--exclude-dir", args.exclude_dir)):
        if on:
            return f"option {flag} is not ported yet: {ITEM_7B}"
    if args.follow:
        return f"option --follow is not ported yet: {ITEM_5}"
    return None


def _select_files(args: argparse.Namespace) -> tuple[int, bool]:
    """Drop the unreadable FILE arguments, with a message unless -s.
    Returns (0, had_file_errors), or (2, True) when nothing is left or a
    FILE is a directory."""
    def readable(f: str) -> bool:
        p = Path(f)
        return p.exists() and (p.is_dir() or os.access(f, os.R_OK))

    bad = [f for f in args.files if not readable(f)]
    if bad:
        if not args.no_messages:
            print(f"error: cannot read: {', '.join(bad)}", file=sys.stderr)
        args.files = [f for f in args.files if f not in bad]
        if not args.files:
            return 2, True
    dirs = [f for f in args.files if Path(f).is_dir()]
    if dirs:
        if not args.no_messages:
            print(f"error: {', '.join(dirs)}: is a directory (use -r)",
                  file=sys.stderr)
        return 2, True
    return 0, bool(bad)


def _write(out, text: str) -> None:
    out.write(text.encode("utf-8", "surrogateescape"))


def cmd_grep(args: argparse.Namespace) -> int:
    from distributed_grep_tpu_torch.models.dfa import RegexError
    from distributed_grep_tpu_torch.ops.engine import check_pattern
    from distributed_grep_tpu_torch.runtime.job import GREP_KEY_RE, run_job
    from distributed_grep_tpu_torch.utils.config import JobConfig

    deferred = _deferred_flag(args)
    if deferred:
        return _error(deferred)[0]
    if args.fixed_strings and args.extended_regexp:
        return _error("-E and -F are conflicting matchers")[0]
    if args.word_regexp and args.line_regexp:
        args.word_regexp = False  # grep: -x subsumes -w
    if args.max_count is not None and args.max_count < 0:
        return _error("invalid max count")[0]
    if args.max_errors and (args.word_regexp or args.line_regexp):
        return _error("-w/-x are not supported with --max-errors "
                      "(approximate matches have no exact boundaries)")[0]
    rc, patterns = _resolve_pattern_args(args)
    if rc:
        return rc
    if args.max_errors:
        rc = _check_max_errors(args, patterns)
        if rc:
            return rc
    if not args.files or "-" in args.files:
        return _error(f"standard input is not ported yet: {ITEM_7B}")[0]
    if patterns is None and not args.max_errors:
        try:
            check_pattern(args.pattern, args.ignore_case)
        except RegexError as e:
            return _error(f"invalid pattern {args.pattern!r}: {e}")[0]
    rc, had_file_errors = _select_files(args)
    if rc:
        return rc
    # -c/-l/-L/-q: one count record per file instead of a record per line;
    # -q/-l/-L need only whether it is nonzero
    count_only = (args.count or args.quiet or args.files_with_matches
                  or args.files_without_match)
    query = ({"patterns": patterns} if patterns is not None
             else {"pattern": args.pattern, "max_errors": args.max_errors})
    cfg = JobConfig(
        input_files=[str(Path(f).resolve()) for f in args.files],
        app_options={
            **query,
            "ignore_case": args.ignore_case,
            "invert": args.invert,
            **({"word_regexp": True} if args.word_regexp else {}),
            **({"line_regexp": True} if args.line_regexp else {}),
            **({"count_only": True} if count_only else {}),
            **({"presence_only": True}
               if count_only and not args.count else {}),
        },
        n_reduce=args.n_reduce,
        work_dir=args.work_dir or tempfile.mkdtemp(prefix="dgrep-"),
    )
    res = run_job(cfg, n_workers=args.workers, device=args.device)
    files = cfg.input_files
    out = sys.stdout.buffer
    if not count_only:
        # default print, in (file, line) order; -m caps each file as the
        # lines stream past, and a capped line does not count for the exit
        # status
        emitted = dict.fromkeys(files, 0)
        parse = args.max_count is not None or args.no_filename
        saw_any = False
        for key, value in res.iter_results_sorted():
            m = GREP_KEY_RE.match(key) if parse else None
            if args.max_count is not None and m and m.group(1) in emitted:
                if emitted[m.group(1)] >= args.max_count:
                    continue
                emitted[m.group(1)] += 1
            saw_any = True
            if m and args.no_filename:
                _write(out, f"(line number #{m.group(2)}) {value}\n")
            else:
                _write(out, f"{key} {value}\n")
        out.flush()
        return 2 if had_file_errors else (0 if saw_any else 1)
    counts = dict.fromkeys(files, 0)
    for key, value in res.iter_results():  # key: the file; value: its count
        if key in counts:
            counts[key] += int(value)
            if args.quiet and counts[key]:
                break  # -q: one selected line settles it
    if args.max_count is not None:
        counts = {f: min(c, args.max_count) for f, c in counts.items()}
    any_selected = any(counts.values())
    rc_final = 2 if had_file_errors else (0 if any_selected else 1)
    if args.quiet:
        return 0 if any_selected else rc_final
    if args.files_without_match:
        # -L's exit status follows whether any line was selected, not
        # whether a name was listed (GNU grep 3.8)
        for f in files:
            if not counts[f]:
                _write(out, f"{f}\n")
    elif args.files_with_matches:
        for f in files:
            if counts[f]:
                _write(out, f"{f}\n")
    else:
        prefix = ((len(files) > 1 or args.with_filename)
                  and not args.no_filename)
        for f in files:
            _write(out, f"{f}:{counts[f]}\n" if prefix else f"{counts[f]}\n")
    out.flush()
    return rc_final


def main(argv: list[str] | None = None) -> int:
    args = _parser().parse_args(argv)
    try:
        return cmd_grep(args)
    except (NotImplementedError, RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
