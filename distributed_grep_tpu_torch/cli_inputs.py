"""The grep CLI's inputs: the file walk of -r/-R, the --include/--exclude
and --exclude-dir filters, and standard input (streamed, or spooled to a
file when the job must re-read it or mix it with files).

The semantics are the reference CLI's (``distributed_grep_tpu/__main__.py``
cmd_grep and _grep_stdin_stream), which follow GNU grep 3.8:

* --include and --exclude form one ordered list; the last glob that
  matches a file's basename decides, and a file no glob matches is
  included when the list is empty or starts with an --exclude.  The list
  applies to named files too, with or without -r, never to standard input;
* --exclude-dir matches directory basenames, descended or named, so a glob
  holding '/' never matches;
* -r walks each named directory with ``os.walk``, pruning excluded
  directories in place, and sorts the files found under each root; it
  skips the symlinked files it meets (a symlink named on the command line
  is followed).  -R follows symlinks, visits each real directory once
  (a ``(dev, ino)`` set, which also breaks cycles), searches each resolved
  file once, and reports the dangling symlinks it meets as unreadable.
"""

from __future__ import annotations

import argparse
import fnmatch
import json
import os
import select
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

STDIN_LABEL = "(standard input)"


class GlobFilterAction(argparse.Action):
    """--include / --exclude into one ordered list of (kind, glob)."""

    def __call__(self, parser, namespace, value, option_string=None):
        lst = list(getattr(namespace, self.dest, None) or [])
        lst.append(("include" if "include" in option_string else "exclude",
                    value))
        setattr(namespace, self.dest, lst)


def included(name: str, filters: list[tuple[str, str]]) -> bool:
    """Whether a file of basename ``name`` passes the ordered filters."""
    decision = None
    for kind, glob in filters:
        if fnmatch.fnmatch(name, glob):
            decision = kind
    if decision is None:
        return not filters or filters[0][0] == "exclude"
    return decision == "include"


def dir_excluded(name: str, globs: list[str]) -> bool:
    """Whether a directory of basename ``name`` matches an --exclude-dir."""
    return any(fnmatch.fnmatch(name, g) for g in globs)


def walk(root: Path, filters, excl_dirs, deref: bool,
         bad: list[str]) -> list[str]:
    """The searchable files under directory ``root``, in sorted order;
    the unreadable ones (and under -R the dangling symlinks) are appended
    to ``bad`` instead."""
    collected: list[Path] = []
    seen_dirs: set[tuple[int, int]] = set()
    seen_files: set[str] = set()
    if deref:
        try:
            st = os.stat(root)
            seen_dirs.add((st.st_dev, st.st_ino))
        except OSError:
            pass
    for base, dirnames, filenames in os.walk(root, followlinks=deref):
        if excl_dirs:
            dirnames[:] = [d for d in dirnames
                           if not dir_excluded(d, excl_dirs)]
        if deref:
            keep = []
            for d in dirnames:
                try:
                    st = os.stat(os.path.join(base, d))
                except OSError:
                    continue  # vanished mid-walk
                if (st.st_dev, st.st_ino) not in seen_dirs:
                    seen_dirs.add((st.st_dev, st.st_ino))
                    keep.append(d)
            dirnames[:] = keep
        collected.extend(Path(base) / name for name in filenames)
    out = []
    for sub in sorted(collected):
        if deref and sub.is_symlink() and not sub.exists():
            bad.append(str(sub))  # GNU -R: "No such file or directory"
            continue
        if not sub.is_file() or not included(sub.name, filters):
            continue
        if not deref and sub.is_symlink():
            continue  # plain -r skips the symlinked files it meets
        if deref:
            try:
                key = str(sub.resolve())
            except OSError:
                pass  # vanished mid-walk: the access check reports it
            else:
                if key in seen_files:
                    continue
                seen_files.add(key)
        if not os.access(sub, os.R_OK):
            bad.append(str(sub))
            continue
        out.append(str(sub))
    return out


def expand_files(args: argparse.Namespace,
                 spool: str | None) -> tuple[int, bool]:
    """Resolve ``args.files`` into the files to search: drop the
    unreadable ones (a message unless -s), walk directories under -r/-R,
    apply --include/--exclude (never to the stdin ``spool``).  Returns
    (0, had_file_errors), or (the exit status, True/False) when nothing
    is left to search."""
    def readable(f: str) -> bool:
        p = Path(f)
        return p.exists() and (p.is_dir() or os.access(f, os.R_OK))

    bad = [f for f in args.files if not readable(f)]
    had_file_errors = bool(bad)
    if bad:
        if not args.no_messages:
            print(f"error: cannot read: {', '.join(bad)}", file=sys.stderr)
        args.files = [f for f in args.files if f not in bad]
        if not args.files:
            return 2, True
    filters = args.glob_filters or []
    excl_dirs = args.exclude_dir or []
    if args.recursive:
        expanded: list[str] = []
        walk_bad: list[str] = []
        for f in args.files:
            pf = Path(f)
            if pf.is_dir():
                if not (excl_dirs and dir_excluded(pf.name, excl_dirs)):
                    expanded += walk(pf, filters, excl_dirs,
                                     args.dereference_recursive, walk_bad)
            elif f == spool or included(pf.name, filters):
                expanded.append(f)
        if walk_bad:
            had_file_errors = True
            if not args.no_messages:
                print(f"error: cannot read: {', '.join(walk_bad)}",
                      file=sys.stderr)
        if not expanded:  # GNU grep -r: nothing searchable exits 1
            return (2 if had_file_errors else 1), had_file_errors
        args.files = expanded
        return 0, had_file_errors
    dirs = [f for f in args.files if Path(f).is_dir()]
    if dirs:
        if not args.no_messages:
            print(f"error: {', '.join(dirs)}: is a directory (use -r)",
                  file=sys.stderr)
        return 2, True
    args.files = [f for f in args.files
                  if f == spool or included(Path(f).name, filters)]
    if not args.files:  # everything --include/--exclude-filtered
        return (2 if had_file_errors else 1), had_file_errors
    return 0, had_file_errors


def spool_stdin() -> str:
    """Copy standard input to a temporary file; returns its path (the
    caller deletes it)."""
    fd, path = tempfile.mkstemp(prefix="dgrep-stdin-")
    with os.fdopen(fd, "wb") as out:
        shutil.copyfileobj(sys.stdin.buffer, out, 1 << 20)
    return path


# The stdin stream closes a block once the pipe has been quiet this long,
# or this long after the block's first read: a pipe that keeps up with the
# reader (``cat FILE |``) fills blocks up to a segment, a live pipe's lines
# wait at most STDIN_BLOCK_S before their scan.
STDIN_QUIET_S = 0.01
STDIN_BLOCK_S = 0.1


def _ready(fd: int | None, timeout: float) -> bool:
    """Whether a read of ``fd`` returns within ``timeout`` (data or EOF)."""
    if fd is None:
        return False
    return bool(select.select([fd], [], [], timeout)[0])


def stdin_blocks(f, gather_bytes: int):
    """Newline-aligned blocks of the stream ``f`` as it arrives; the last
    block may lack its newline.  A block gathers reads of ``f`` until it
    holds ``gather_bytes``, the stream has been quiet for STDIN_QUIET_S,
    or STDIN_BLOCK_S have passed since its first read (a stream without a
    file descriptor gives one read a block).  Nothing is read beyond what
    the consumer has asked for."""
    read1 = getattr(f, "read1", None) or f.read
    try:
        fd = f.fileno()
    except (AttributeError, OSError, ValueError):
        fd = None
    carry = b""
    while True:
        parts, n, eof = [carry], len(carry), False
        t0 = None
        while True:
            block = read1(1 << 20)
            if not block:
                eof = True
                break
            if t0 is None:
                t0 = time.monotonic()
            parts.append(block)
            n += len(block)
            left = STDIN_BLOCK_S - (time.monotonic() - t0)
            if n >= gather_bytes or left <= 0 or not _ready(
                    fd, min(STDIN_QUIET_S, left)):
                break
        buf = b"".join(parts)
        if eof:
            if buf:
                yield buf
            return
        cut = buf.rfind(b"\n")
        if cut < 0:
            carry = buf  # no complete line yet
            continue
        carry = buf[cut + 1 :]
        yield buf[: cut + 1]


def grep_stdin_stream(args: argparse.Namespace, patterns, out) -> int:
    """grep over standard input as it streams, with GNU grep's semantics:
    each newline-aligned block is scanned on ``args.device``, or on the
    host with ``--backend cpu`` (one ``GrepEngine.scan``), -w/-x candidates are confirmed on the host, -v
    takes the complement, and the selected lines print as their block
    arrives.  -q/-l/-L return at the first selected line without draining
    the pipe; -m stops reading at the cap."""
    from distributed_grep_tpu_torch.apps.grep import build_confirm
    from distributed_grep_tpu_torch.ops.device_scan import kernel_launches
    from distributed_grep_tpu_torch.ops.engine import GrepEngine
    from distributed_grep_tpu_torch.ops.lines import count_lines, line_spans
    from distributed_grep_tpu_torch.ops.lines import newline_index

    eng = GrepEngine(args.pattern if patterns is None else None,
                     patterns=patterns, ignore_case=args.ignore_case,
                     max_errors=args.max_errors or 0, device=args.device,
                     backend=args.backend)
    confirm = build_confirm(
        pattern=args.pattern, patterns=patterns,
        ignore_case=args.ignore_case,
        mode=("line" if args.line_regexp
              else "word" if args.word_regexp else "search"))
    presence = (args.quiet or args.files_with_matches
                or args.files_without_match)
    cap = args.max_count
    head = b"" if args.no_filename else STDIN_LABEL.encode() + b" "
    lines_before = n_selected = n_scans = n_bytes = 0
    scan_s = 0.0
    t_all = time.perf_counter()
    done = cap == 0  # GNU -m 0 reads nothing
    blocks = stdin_blocks(sys.stdin.buffer, eng.segment_bytes)
    while not done:
        buf = next(blocks, None)
        if buf is None:
            break
        t0 = time.perf_counter()
        sel = eng.scan(buf).matched_lines
        scan_s += time.perf_counter() - t0
        n_scans += 1
        n_bytes += len(buf)
        nl = None
        if confirm is not None and sel.size:
            nl = newline_index(buf)
            starts, ends = line_spans(sel, nl, len(buf))
            mv = memoryview(buf)
            sel = sel[np.fromiter(
                (confirm.search(mv[s:e]) is not None
                 for s, e in zip(starts.tolist(), ends.tolist())),
                dtype=bool, count=sel.size)]
        n_lines = count_lines(buf)
        if args.invert:
            sel = np.setdiff1d(np.arange(1, n_lines + 1, dtype=np.int64), sel)
        if cap is not None:
            sel = sel[: cap - n_selected]
        if presence:
            sel = sel[:1]
        n_selected += int(sel.size)
        if sel.size and not presence and not args.count:
            if nl is None:
                nl = newline_index(buf)
            starts, ends = line_spans(sel, nl, len(buf))
            out.write(b"".join(
                b"%s(line number #%d) %s\n" % (
                    head, lines_before + ln,
                    buf[s:e].decode("utf-8", "replace").encode())
                for ln, s, e in zip(sel.tolist(), starts.tolist(),
                                    ends.tolist())))
            out.flush()  # lines appear as the pipe produces them
        lines_before += n_lines
        done = (presence and n_selected > 0) or (
            cap is not None and n_selected >= cap)
    if args.quiet:
        pass
    elif args.files_with_matches:
        if n_selected:
            out.write(STDIN_LABEL.encode() + b"\n")
    elif args.files_without_match:
        if not n_selected:
            out.write(STDIN_LABEL.encode() + b"\n")
    elif args.count:
        prefix = (STDIN_LABEL + ":" if args.with_filename
                  and not args.no_filename else "")
        out.write(f"{prefix}{n_selected}\n".encode())
    out.flush()
    if args.metrics:
        print(json.dumps({
            "counters": {"stdin_lines": lines_before,
                         "selected_lines": n_selected,
                         "scans": n_scans, "bytes": n_bytes},
            "launches": kernel_launches(),
            "seconds": {"scan": scan_s,
                        "stream": time.perf_counter() - t_all},
            "streaming_stdin": True,
        }, indent=2, sort_keys=True), file=sys.stderr)
    return 0 if n_selected else 1
