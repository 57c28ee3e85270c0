"""The grep CLI's display options that re-read the inputs: -b (byte
offsets), -o (only the matched parts) and -A/-B/-C (context).

The output is the reference CLI's, byte for byte
(``distributed_grep_tpu/__main__.py`` _line_offsets, _print_only_matching,
_print_with_context): lines are written to a binary stream as UTF-8, a
line's text decoded utf-8/replace as the grep app decodes it, a path as
its surrogateescape bytes.
"""

from __future__ import annotations

import collections
import re

import numpy as np

from distributed_grep_tpu_torch.apps.grep import wrap_mode
from distributed_grep_tpu_torch.models.dfa import expand_posix_classes
from distributed_grep_tpu_torch.ops.lines import newline_index
from distributed_grep_tpu_torch.runtime.job import GREP_KEY_RE

# -b and the context printer read the files in blocks of this size
OFFSET_BLOCK_BYTES = 1 << 24


def _enc(text: str) -> bytes:
    return text.encode("utf-8", "surrogateescape")


def line_offsets(matched: dict[str, set[int]]) -> dict[str, dict[int, int]]:
    """Per file, the byte offset at which each of its ``matched`` lines
    starts (grep -b), read in bounded blocks: a block's newline index
    gives its line starts, numbered by the running line count."""
    out: dict[str, dict[int, int]] = {}
    for path, lines in matched.items():
        offs = out[path] = {}
        if not lines:
            continue
        want = sorted(lines)
        wi = 0
        line_no = 1  # the line that starts right after the bytes read
        base = 0
        with open(path, "rb") as f:
            if want[0] == 1:
                offs[1] = 0
                wi = 1
            while wi < len(want):
                block = f.read(OFFSET_BLOCK_BYTES)
                if not block:
                    break
                nl = newline_index(block)
                # the line after the k-th newline of this block is number
                # line_no + k + 1 and starts at base + nl[k] + 1
                while wi < len(want):
                    k = want[wi] - line_no - 1
                    if k < 0 or k >= len(nl):
                        break
                    offs[want[wi]] = base + int(nl[k]) + 1
                    wi += 1
                line_no += len(nl)
                base += len(block)
    return out


def read_line_bytes(f, offset: int) -> bytes:
    """The raw bytes of the line that starts at ``offset`` of the open
    file ``f``, without its newline."""
    chunks = []
    f.seek(offset)
    while True:
        block = f.read(1 << 16)
        if not block:
            break
        cut = block.find(b"\n")
        if cut >= 0:
            chunks.append(block[:cut])
            break
        chunks.append(block)
    return b"".join(chunks)


def only_matching_regex(args, patterns) -> re.Pattern[bytes]:
    """grep -o's one matcher, a bytes regex (GNU's C locale: -i folds
    ASCII only): the pattern with its POSIX classes expanded, or a
    literal set as an alternation longest member first, wrapped for -w
    or -x."""
    mode = ("line" if args.line_regexp
            else "word" if args.word_regexp else "search")
    if patterns is not None:
        base = "|".join(re.escape(p) for p in
                        sorted(patterns, key=len, reverse=True))
    else:
        base = args.pattern
    return re.compile(wrap_mode(expand_posix_classes(_enc(base)), mode),
                      re.IGNORECASE if args.ignore_case else 0)


def print_only_matching(out, res, args, patterns, matched, offsets,
                        disp) -> None:
    """grep -o: every nonempty match of each selected line on its own
    line.  Three legs: the bytes record merge (no line set and no -b; no
    record is decoded); the parsed records kept to the -m line sets; and
    with -b the raw line bytes read at each line's offset, one handle a
    path, so a match's offset is exact in any encoding."""
    rx = only_matching_regex(args, patterns)
    if offsets is None and matched is None and res.fileline_sorted:
        last_p = None
        prefix_path = b""
        for (p, ln), value in res.iter_grep_records_bytes():
            if ln:
                if p != last_p:
                    last_p = p
                    prefix_path = (b"" if args.no_filename
                                   else _enc(disp(p)) + b" ")
                prefix = prefix_path + b"(line number #%d) " % ln
            else:
                prefix = b""  # a key that is not grep-shaped
            for hit in rx.finditer(value):
                if hit.group(0):
                    out.write(prefix + hit.group(0).decode(
                        "utf-8", "replace").encode() + b"\n")
        return
    handles: dict[str, object] = {}
    try:
        for key, value in res.iter_results_sorted():
            m = GREP_KEY_RE.match(key)
            if m and matched is not None and \
                    int(m.group(2)) not in matched.get(m.group(1), ()):
                continue  # a line past the -m cap
            prefix = b""
            line_off = None
            if m:
                if not args.no_filename:
                    prefix = _enc(disp(m.group(1))) + b" "
                prefix += b"(line number #%s) " % m.group(2).encode()
                if offsets is not None:
                    line_off = offsets.get(m.group(1), {}).get(
                        int(m.group(2)))
            if line_off is not None:
                path = m.group(1)
                f = handles.get(path)
                if f is None:
                    f = handles[path] = open(path, "rb")
                for hit in rx.finditer(read_line_bytes(f, line_off)):
                    if hit.group(0):
                        out.write(prefix + b"(byte #%d) " % (
                            line_off + hit.start()) + hit.group(0).decode(
                                "utf-8", "replace").encode() + b"\n")
                continue
            for hit in rx.finditer(_enc(value)):
                if hit.group(0):
                    out.write(prefix + hit.group(0).decode(
                        "utf-8", "replace").encode() + b"\n")
    finally:
        for f in handles.values():
            f.close()


def context_window_lines(lines_set: set[int], before: int,
                         after: int) -> np.ndarray:
    """Sorted line numbers within ``before`` lines before or ``after``
    lines after a selected line: the only lines the context printer's
    state can depend on."""
    lines = np.fromiter(sorted(lines_set), dtype=np.int64,
                        count=len(lines_set))
    if not lines.size:
        return lines
    lo = np.maximum(lines - before, 1)
    hi = lines + after
    # lo and hi are sorted: a window opens a new range where it starts
    # past the end of the one before it
    brk = np.flatnonzero(lo[1:] > hi[:-1] + 1) + 1
    starts = lo[np.concatenate(([0], brk))]
    ends = hi[np.concatenate((brk - 1, [hi.size - 1]))]
    counts = ends - starts + 1
    skip = np.repeat(starts - np.concatenate(([0], np.cumsum(counts)[:-1])),
                     counts)
    return skip + np.arange(int(counts.sum()), dtype=np.int64)


def lines_at(path: str, wanted: np.ndarray):
    """(line number, start offset, raw bytes with the newline) of each
    line of ``path`` numbered in the sorted array ``wanted``, read in
    bounded blocks (a line longer than a block is gathered whole)."""
    wi = 0
    line_no = 0  # lines before ``buf``
    base = 0  # the offset of ``buf`` in the file
    carry = b""
    with open(path, "rb") as f:
        while wi < wanted.size:
            block = f.read(OFFSET_BLOCK_BYTES)
            buf = carry + block
            if block:
                cut = buf.rfind(b"\n") + 1
                if cut == 0:
                    carry = buf
                    continue
                carry, buf = buf[cut:], buf[:cut]
            elif not buf:
                return
            nl = newline_index(buf)
            n_lines = nl.size + (0 if buf.endswith(b"\n") else 1)
            hi = int(np.searchsorted(wanted, line_no + n_lines,
                                     side="right"))
            ln = wanted[wi:hi] - line_no  # 1-based within ``buf``
            ends = np.append(nl + 1, len(buf))
            starts = np.where(ln == 1, 0, ends[np.maximum(ln - 2, 0)])
            for n, s, e in zip((ln + line_no).tolist(), starts.tolist(),
                               ends[ln - 1].tolist()):
                yield n, base + s, buf[s:e]
            wi = hi
            line_no += n_lines
            base += len(buf)
            if not block:
                return


def print_with_context(out, path: str, lines_set: set[int], before: int,
                       after: int, printed_any: bool, no_filename: bool,
                       byte_offset: bool, display: str) -> bool:
    """grep -A/-B/-C over one file, streamed (memory bounded by the
    context width).  Selected lines print as the default print does,
    context lines with ``)-`` in place of ``)``, and ``--`` separates
    groups that are not contiguous.  With ``byte_offset`` (-b) a line
    carries its start offset, ``(byte #K)`` on a selected line and
    ``(byte #K)-`` on a context line.  ``printed_any`` carries across
    files, so the separator is global; returns its new value.

    The reference's state machine over every line of the file, fed only
    the lines of ``context_window_lines``: a line outside every window is
    neither printed nor still queued when the next selected line comes
    (the queue holds the ``before`` lines just before it, all inside its
    window), so skipping it changes no output."""
    prevq: collections.deque = collections.deque(maxlen=max(before, 0))
    pending_after = 0
    last_printed = 0
    head = b"" if no_filename else _enc(display) + b" "

    def line(n: int, off: int, raw: bytes, ctx: bool) -> bytes:
        sep = b"-" if ctx else b""
        b = b" (byte #%d)%s" % (off, sep) if byte_offset else b""
        text = raw.rstrip(b"\n").decode("utf-8", "replace").encode()
        return b"%s(line number #%d)%s%s %s\n" % (head, n, sep, b, text)

    wanted = context_window_lines(lines_set, before, after)
    for n, off, raw in lines_at(path, wanted):
        if n in lines_set:
            if printed_any and (
                    last_printed == 0 or n - last_printed > len(prevq) + 1):
                out.write(b"--\n")
            for qn, qoff, qraw in prevq:
                if qn > last_printed:
                    out.write(line(qn, qoff, qraw, ctx=True))
            prevq.clear()
            out.write(line(n, off, raw, ctx=False))
            printed_any = True
            last_printed = n
            pending_after = after
        elif pending_after > 0:
            out.write(line(n, off, raw, ctx=True))
            last_printed = n
            pending_after -= 1
        elif before:
            prevq.append((n, off, raw))
    return printed_any
