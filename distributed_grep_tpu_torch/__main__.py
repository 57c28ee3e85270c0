"""Command line: distributed grep on the card.

    python -m distributed_grep_tpu_torch grep [PATTERN] [FILE...] [-i]
        [-e PATTERN]... [-f FILE] [-F] [-E] [--max-errors K]
        [-v] [-w] [-x] [-c] [-l] [-L] [-q] [-m NUM] [-h] [-s] [-n] [-H] [-a]
        [-o] [-A N] [-B N] [-C N] [-b] [-r] [-R] [--include GLOB]...
        [--exclude GLOB]... [--exclude-dir GLOB]... [--metrics]
        [--follow [--follow-idle-s S]]
        [--workers N] [--n-reduce R] [--device cuda|cpu]
        [--backend device|cpu] [--work-dir DIR]

Prints ``<abs path> (line number #N) <line>`` for every selected line, in
(path, line) order -- the reference CLI's default print mode, byte for
byte.  Exit status: 0 when a line was selected, 1 when none was, 2 on
error (bad pattern, an unreadable file or directory, a pattern, option or
device this package cannot serve); -q exits 0 on a selected line even
after a file error.

PATTERN is a grep -E regex: a literal or byte-class sequence runs on the
Shift-And kernel, a regex that denotes a finite literal set on the literal
set kernels, any other regex on the Glushkov NFA kernel; as in the
reference, '^$'-style patterns that match the empty string at a line's end
run on the host DFA scanner, and backreferences and other syntax only
Python re knows on the host re loop.  ``--backend cpu`` (the reference
CLI's default) runs every pattern on the host scanners and never asks for
the card; ``--device`` says where the kernels run.  The pattern options
follow the reference CLI (and GNU grep):

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
              otherwise, with -f or a set of -F patterns, with -w/-x, and
              with -o).

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
  -o          each nonempty match of a selected line on its own line,
              ``<path> (line number #N) <match>`` (nothing with -v), from
              one bytes regex: -i folds ASCII only, as GNU grep's C
              locale does;
  -A/-B/-C N  N lines of context after / before / around each selected
              line: context lines print ``)-`` in place of ``)``, and
              ``--`` separates groups, across files too;
  -b          the byte offset of each printed line, ``(line number #N)
              (byte #K) <line>`` (``(byte #K)-`` on context lines); with
              -o the offset of each match;
  -r, -R      search the files under each directory argument (the
              current directory with no FILE), sorted under each root;
              -r skips the symlinks it meets, -R follows them (each real
              directory and file once; a dangling symlink is an error);
  --include GLOB, --exclude GLOB
              one ordered list: the last glob that matches a file's
              basename decides, for named files too;
  --exclude-dir GLOB
              skip the directories whose basename matches GLOB;
  --metrics   print the job's counters, stage seconds and kernel
              launches as JSON to stderr;
  --follow    a standing query (tail -f | grep): print the selected lines
              of the named files, then poll them every
              DGREP_FOLLOW_POLL_S seconds (0.5) and print the selected
              lines of what was appended, as they arrive; a truncated or
              replaced file is searched again from its start (a notice on
              stderr).  -c prints the counts at the end, -l each file at
              its first selected line, -q exits at the first one.  Not
              with -o, context, -b, -m, -w, -x, -L, --max-errors or
              standard input (exit 2);
  --follow-idle-s S
              with --follow: end once no file has grown for S seconds
              (0, the default: run until interrupted); the last poll
              takes an unterminated last line too, so the output equals a
              one-shot run over the final files;
  -n, -H, -a  accepted for GNU grep compatibility: line numbers and paths
              always print, input is always read as binary-safe text (-H
              does put the path before -c's count for one file).

Standard input is read when FILE is ``-`` or absent (without -r) and
prints as ``(standard input)``.  Alone, and without -o, -b or context, it
streams: each newline-aligned block that arrives (gathered up to a
segment when the pipe is ahead) is scanned on the card and its lines
print at once; -q, -l and -L return at the first selected line without
draining the pipe, -m stops reading at its cap.  Otherwise it is spooled
to a temporary file and searched as one.

With more than one input file (-r trees, and standard input spooled
beside files included) the job batches: consecutive files below
DGREP_DEVICE_MIN_BYTES (1 MiB) share a map task, and are scanned packed
into windows of DGREP_BATCH_BYTES (32 MiB; 0 turns batching off).

A positional PATTERN displaced by -e or -f is the first input file.
Literal sets run on the FDR filter kernel, with an exact host confirm, or,
when every member is 1-2 bytes, on the exact pairset kernel; a set too
dense for both (a member ' ') on the host scanner over its Aho-Corasick
banks.

Any application, from a JobConfig JSON file (utils/config.py):

    python -m distributed_grep_tpu_torch run --config JOB.json [--resume]
        [--workers N] [--n-reduce R] [--work-dir DIR] [--metrics]
    python -m distributed_grep_tpu_torch coordinator --config JOB.json
        [--resume]
    python -m distributed_grep_tpu_torch worker --addr HOST:PORT[,HOST:PORT]
        [--slots N]

``run`` runs the job in process (``--resume`` replays the work dir's
journal) and prints its records as ``<key> <value>`` lines, sorted.
``coordinator`` serves the job over HTTP (runtime/http_coordinator.py)
until it completes and prints one JSON line, ``{"outputs": [...]}``, the
committed ``mr-out-*`` paths; ``worker`` processes (``--slots`` task loops
each) join it, fetch the config and run its tasks.  The grep tasks run on
the card unless the job's app_options say ``"device": "cpu"`` or
``"backend": "cpu"``; a worker asked for CUDA where there is none exits
nonzero.  An application that launches no kernel (the word count, the
inverted index, the host grep) never asks for the card.

Grep as a service (runtime/service.py), a daemon serving a stream of jobs
over persistent workers and engines:

    python -m distributed_grep_tpu_torch serve [--host H] [--port P]
        [--work-root DIR] [--workers N] [--max-workers M] [--max-jobs J]
        [--queue Q] [--spans] [--no-resume] [--standby]
    python -m distributed_grep_tpu_torch submit --addr HOST:PORT[,HOST:PORT]
        (--config JOB.json | [PATTERN] FILE... [-i] [-e PATTERN]...
         [-f FILE] [-F] [-E] [--backend device|cpu])
        [--n-reduce R] [--no-wait] [--timeout S] [--explain]
        [--follow [--follow-poll-s S] [--stream]]
    python -m distributed_grep_tpu_torch explain (--addr HOST:PORT JOB_ID
        | WORK_DIR) [--timeout S]
    python -m distributed_grep_tpu_torch top --addr HOST:PORT[,HOST:PORT...]
        [--interval S] [--once] [--timeout S]

``serve`` runs the daemon until SIGINT or SIGTERM, then prints one JSON
line, its final ``GET /status``; ``--workers`` in-process worker loops
serve it (0: none), and ``worker --addr`` processes attach to it as to a
coordinator.  With ``--max-workers M`` above ``--workers`` the in-process
pool follows the daemon's scale advice every 2 s: one more loop while it
says grow (up to M), one fewer while it says shrink (down to
``--workers``).  Its result cache (``<work_root>/results``,
DGREP_RESULT_CACHE, DGREP_RESULT_BYTES) answers a repeated query over
unchanged files with no scan.  Its work root keeps the job registry (``jobs.jsonl``: a
restarted daemon keeps its history and resumes its jobs, unless
``--no-resume``), a work dir a job, the shard index's store and the
daemon's own log (``daemon.jsonl``; DGREP_DAEMON_LOG=0 turns it off).
``submit`` posts a job, waits for it (unless ``--no-wait``) and prints one
JSON line: ``job_id``, ``state``, the ``outputs`` of a done job or the
``error`` of a failed one, and ``index_shards_pruned`` and
``index_bytes_skipped`` once the index pruned a shard,
``result_splits_reused`` and ``result_bytes_unscanned`` once the result
cache served a split, and with ``--explain`` the job's routing report
under ``explain``; it exits 0 when the job is done, 1 otherwise, 2 when
the daemon refused it or cannot be reached.  Its PATTERN/FILE form builds
a ``grep_cuda`` job that runs on the card; ``--backend cpu`` asks for the
host scanners.  ``--follow`` submits a standing query (the daemon scans
the files' appended lines as they grow, until the job is cancelled) and
prints ``{"job_id", "state": "following", "stream"}``; with ``--stream``
it prints the records as they arrive, as ``grep --follow`` prints them
(a count record as ``FILE: +N``), until ``--timeout`` or the job's end,
then one JSON summary line.  ``explain`` prints a job's routing report:
the daemon's (``--addr``), or one built from a work dir's events.jsonl.
``top`` polls each daemon of the list and prints its view (``--once``:
one snapshot, exit 2 when none answers).

Failover (runtime/lease.py): ``serve --standby``, or any ``serve`` with
DGREP_LEASE_TTL_S set, contends for the work root's lease.  The winner
serves (``/status`` says ``"role": "active"``) and renews the lease every
DGREP_LEASE_RENEW_S (a third of the TTL); the others park on their
address as standbys (``"role": "standby"``) and poll it, and the first to
find it older than the TTL steals it and promotes through the registry's
resume, on the same address.  A deposed active (its lease stolen after a
stall) stops serving at once and stands by again.  ``worker --addr A,B``
and ``submit --addr A,B`` follow whichever daemon is active: every retry
dials the next address, a standby's 503 too, and a worker waits while
every address is a standby.  ``submit`` to a list sends a fresh
``submit_token``, so a POST repeated after a failover lands on the one
job; it re-POSTs while a standby answers, and its polls ride out the
failover.  Worker processes attached to a daemon keep their map output
on their own spool and serve it to the reducers (the peer shuffle,
runtime/peer.py; DGREP_PEER_SHUFFLE=0 sends it through the daemon).

Telemetry:

    python -m distributed_grep_tpu_torch status --addr HOST:PORT
        [--timeout S]
    python -m distributed_grep_tpu_torch trace-export EVENTS [-o OUT]

``status`` prints a running coordinator's ``GET /status`` (task states,
counters, in-flight tasks, a row a worker) as indented JSON, with
``index_shards_pruned`` and ``index_bytes_skipped`` at the top once the
shard index (a job's ``index_dir``) has pruned a shard.
``trace-export`` renders a job's ``events.jsonl`` (the span pipeline's
log, written with ``"spans": true`` in the job config or DGREP_SPANS=1;
EVENTS is the file or the work dir holding it) as Chrome trace JSON for
Perfetto or chrome://tracing; with ``--fleet`` EVENTS is a service work
root: its daemon.jsonl (every incarnation) merged with every job's
events.jsonl into one trace.  DGREP_TRACE_DIR=DIR runs each job under
torch.profiler and writes its trace into DIR.

Static analysis:

    python -m distributed_grep_tpu_torch analyze [--json | --sarif]
        [--rule NAME]... [--baseline FILE] [--write-baseline FILE]
        [--root DIR] [--list-rules] [--knobs] [--events]

``analyze`` runs the package's invariant rules (analysis/rules.py) over
its own source and prints ``path:line: [rule] message`` for each
violation; it exits 0 when there is none, 1 when there is one, 2 on a
usage error.  ``--knobs`` and ``--events`` print the DGREP_* knob and
telemetry event registries as markdown.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import sys
import tempfile
import time
from pathlib import Path

from distributed_grep_tpu_torch.cli_inputs import GlobFilterAction


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
    g.add_argument("-o", "--only-matching", action="store_true",
                   help="print each matched part of a line on its own line")
    g.add_argument("-A", "--after-context", type=int, default=0,
                   metavar="N", help="print N lines of trailing context")
    g.add_argument("-B", "--before-context", type=int, default=0,
                   metavar="N", help="print N lines of leading context")
    g.add_argument("-C", "--context", type=int, default=None, metavar="N",
                   help="print N lines of context before and after")
    g.add_argument("-b", "--byte-offset", action="store_true",
                   help="print the byte offset of each line (of each match "
                        "with -o)")
    g.add_argument("-r", "--recursive", action="store_true",
                   help="search the files under directory arguments")
    g.add_argument("-R", "--dereference-recursive", action="store_true",
                   help="like -r, following every symlink")
    g.add_argument("--include", action=GlobFilterAction, dest="glob_filters",
                   default=None, metavar="GLOB",
                   help="search only files whose basename matches GLOB "
                        "(ordered with --exclude: the last matching glob "
                        "wins)")
    g.add_argument("--exclude", action=GlobFilterAction, dest="glob_filters",
                   default=None, metavar="GLOB",
                   help="skip files whose basename matches GLOB (ordered "
                        "with --include)")
    g.add_argument("--exclude-dir", action="append", default=None,
                   metavar="GLOB",
                   help="skip directories whose basename matches GLOB")
    g.add_argument("--follow", action="store_true",
                   help="standing query: poll the files for appended data "
                        "and print the selected lines as they arrive")
    g.add_argument("--follow-idle-s", type=float, default=0.0, metavar="S",
                   help="with --follow: exit once no file has grown for S "
                        "seconds (0 = run until interrupted)")
    g.add_argument("--metrics", action="store_true",
                   help="print job metrics as JSON to stderr")
    g.add_argument("--workers", type=int, default=2,
                   help="in-process worker threads")
    g.add_argument("--n-reduce", type=int, default=10)
    g.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the scan runs (default: cuda; cpu runs the "
                        "kernels' plain PyTorch versions)")
    g.add_argument("--backend", default="device", choices=["device", "cpu"],
                   help="device (default): the kernels, and the host "
                        "scanners where the engine routes a pattern there; "
                        "cpu: the host scanners for every pattern")
    g.add_argument("--work-dir", default=None)

    r = sub.add_parser("run", help="run any MapReduce application from a "
                                   "job config, in process")
    r.add_argument("--config", required=True)
    r.add_argument("--resume", action="store_true",
                   help="replay the journal: skip the committed tasks")
    r.add_argument("--workers", type=int, default=2,
                   help="in-process worker threads")
    r.add_argument("--n-reduce", type=int, default=None)
    r.add_argument("--work-dir", default=None)
    r.add_argument("--metrics", action="store_true",
                   help="print job metrics as JSON to stderr")

    c = sub.add_parser("coordinator",
                       help="serve a job's control and data planes over HTTP")
    c.add_argument("--config", required=True)
    c.add_argument("--resume", action="store_true")

    w = sub.add_parser("worker", help="connect to a coordinator and run its "
                                      "tasks")
    w.add_argument("--addr", required=True,
                   help="the coordinator's address, host:port, or a "
                        "daemon's and its standbys', comma-separated")
    w.add_argument("--slots", type=int, default=1,
                   help="task loops in this process")

    st = sub.add_parser("status", help="query a running coordinator's "
                                       "task and metric state")
    st.add_argument("--addr", required=True,
                    help="the coordinator's address, host:port")
    st.add_argument("--timeout", type=float, default=5.0)

    sv = sub.add_parser("serve", help="grep as a service: a multi-tenant "
                                      "daemon serving a stream of jobs")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=0,
                    help="listen port (0: any free one, printed on stderr)")
    sv.add_argument("--work-root", default=None,
                    help="the daemon's job state (default: a fresh temp dir)")
    sv.add_argument("--workers", type=int, default=2,
                    help="in-process worker loops (0: none; worker processes "
                         "attach with `worker --addr`)")
    sv.add_argument("--max-jobs", type=int, default=None,
                    help="running-job cap (DGREP_SERVICE_MAX_JOBS wins)")
    sv.add_argument("--queue", type=int, default=None,
                    help="queued-submission cap (DGREP_SERVICE_QUEUE wins)")
    sv.add_argument("--spans", action="store_true",
                    help="the span pipeline for every job")
    sv.add_argument("--no-resume", action="store_true",
                    help="do not re-admit or resume the registry's jobs "
                         "(DGREP_SERVICE_RESUME=0)")
    sv.add_argument("--standby", action="store_true",
                    help="active/standby failover on the work root's lease: "
                         "serve while holding it, stand by while another "
                         "daemon does (DGREP_LEASE_TTL_S set does the same)")
    sv.add_argument("--max-workers", type=int, default=None,
                    help="the elastic pool's ceiling: the in-process pool "
                         "grows toward it on the scale advice and shrinks "
                         "back to --workers when idle (unset: a fixed "
                         "pool)")

    sb = sub.add_parser("submit", help="submit a job to a service daemon and "
                                       "print one JSON line")
    sb.add_argument("--addr", required=True,
                    help="the daemon's address, host:port, or the "
                         "active's and its standbys', comma-separated")
    sb.add_argument("--config", default=None,
                    help="a job config JSON (as `run --config`); otherwise "
                         "PATTERN and FILE arguments")
    sb.add_argument("pattern", nargs="?", default=None)
    sb.add_argument("files", nargs="*")
    sb.add_argument("-i", "--ignore-case", action="store_true")
    sb.add_argument("-e", "--regexp", action="append", default=None,
                    metavar="PATTERN", dest="e_patterns")
    sb.add_argument("-f", "--patterns-file", default=None)
    sb.add_argument("-F", "--fixed-strings", action="store_true")
    sb.add_argument("-E", "--extended-regexp", action="store_true")
    sb.add_argument("--backend", default=None, choices=["device", "cpu"],
                    help="the PATTERN/FILE form's engine: the card (the "
                         "default) or cpu, the host scanners")
    sb.add_argument("--n-reduce", type=int, default=None)
    sb.add_argument("--no-wait", dest="wait", action="store_false",
                    help="return once the job is submitted")
    sb.add_argument("--timeout", type=float, default=300.0,
                    help="the wait's budget in seconds")
    sb.add_argument("--follow", action="store_true",
                    help="a standing query: the daemon scans the files' "
                         "appended lines as they grow; read it at GET "
                         "/jobs/<id>/stream or with --stream")
    sb.add_argument("--follow-poll-s", type=float, default=None,
                    metavar="S",
                    help="with --follow: the wake cadence "
                         "(DGREP_FOLLOW_POLL_S wins; default 0.5 s)")
    sb.add_argument("--stream", action="store_true",
                    help="with --follow: print the records as they arrive "
                         "until --timeout, then one JSON summary line")
    sb.add_argument("--explain", action="store_true",
                    help="add the job's routing report (GET "
                         "/jobs/<id>/explain) to the JSON line")

    ex = sub.add_parser("explain", help="a job's routing report: kernel "
                                        "family, host or device, prunes, "
                                        "fusion, cache verdicts")
    ex.add_argument("target", help="a job id (with --addr), or a work dir "
                                   "or events.jsonl path")
    ex.add_argument("--addr", default=None,
                    help="the daemon's address, host:port (it assembles "
                         "the report)")
    ex.add_argument("--timeout", type=float, default=10.0)

    tp = sub.add_parser("top", help="a console of daemons: queue, running "
                                    "jobs, workers, scale advice, cache "
                                    "ratios, standing queries")
    tp.add_argument("--addr", required=True,
                    help="a daemon's address host:port, or a comma-"
                         "separated list (each is polled)")
    tp.add_argument("--interval", type=float, default=None, metavar="S",
                    help="the refresh cadence (default "
                         "DGREP_TOP_INTERVAL_S, 2 s)")
    tp.add_argument("--once", action="store_true",
                    help="print one snapshot and exit (2 when no daemon "
                         "answers)")
    tp.add_argument("--timeout", type=float, default=5.0)

    te = sub.add_parser("trace-export",
                        help="render a job's events.jsonl span log as "
                             "Chrome trace JSON")
    te.add_argument("events", help="path to events.jsonl, or the job's "
                                   "work dir holding it")
    te.add_argument("-o", "--out", default="-",
                    help="output file (default: stdout)")
    te.add_argument("--fleet", action="store_true",
                    help="EVENTS is a service work root: its daemon.jsonl "
                         "fleet timeline merged with every job's "
                         "events.jsonl")

    # listed for --help; main() dispatches it before this parser runs, so
    # analysis/checker.py owns the checker's flags
    sub.add_parser("analyze",
                   help="the package's invariant checker (exit 1 on "
                        "violations; see `analyze --help` for rules, "
                        "baseline, knobs and events)")
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


def _write(out, text: str) -> None:
    out.write(text.encode("utf-8", "surrogateescape"))


def _print_metrics(res, job_s: float, print_s: float) -> None:
    """The job's metrics as JSON on stderr, with the CLI's own seconds
    (the job, then the print), the grep engine's route and summed scan
    counters and the kernels' launches."""
    from distributed_grep_tpu_torch.apps import grep_cuda
    from distributed_grep_tpu_torch.ops.device_scan import kernel_launches

    metrics = dict(res.metrics)
    metrics["seconds"] = {**metrics["seconds"], "cli_job": job_s,
                          "cli_print": print_s}
    if grep_cuda._engine is not None:
        eng = metrics["engine"] = dict(grep_cuda._engine.totals)
        if eng.get("batch_dispatches"):  # the mean fill of the windows
            eng["batch_fill_ratio"] = (eng["batch_fill_sum"]
                                       / eng["batch_dispatches"])
        metrics["route"] = grep_cuda._engine.route
    metrics["launches"] = kernel_launches()
    print(json.dumps(metrics, indent=2, sort_keys=True), file=sys.stderr)


def cmd_grep(args: argparse.Namespace) -> int:
    from distributed_grep_tpu_torch.cli_inputs import (
        STDIN_LABEL,
        expand_files,
        grep_stdin_stream,
        spool_stdin,
    )
    from distributed_grep_tpu_torch.models.dfa import RegexError
    from distributed_grep_tpu_torch.ops.engine import check_pattern

    if args.dereference_recursive:
        args.recursive = True  # -R implies -r everywhere
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
    if args.follow:
        rc = _check_follow(args)
        if rc:
            return rc
    if args.max_errors:
        # before standard input is read: an exit-2 call must not drain it
        rc = _check_max_errors(args, patterns)
        if rc:
            return rc
        if args.only_matching:
            return _error("-o is not supported with --max-errors "
                          "(approximate matches have no unique matched "
                          "substring)")[0]
    if patterns is None and not args.max_errors:
        try:
            check_pattern(args.pattern, args.ignore_case,
                          backend=args.backend)
        except RegexError as e:
            return _error(f"invalid pattern {args.pattern!r}: {e}")[0]
    out = sys.stdout.buffer
    rereads = (args.only_matching or args.byte_offset
               or args.context is not None or args.before_context
               or args.after_context)
    if (((not args.files and not args.recursive) or args.files == ["-"])
            and not rereads):
        return grep_stdin_stream(args, patterns, out)
    spool = None
    work_dir = args.work_dir
    try:
        if (not args.files and not args.recursive) or "-" in args.files:
            # standard input mixed with files, or re-read by -o/-b/context:
            # one spool, searched as a file and shown under GNU's label;
            # a repeated '-' reads it once
            spool = spool_stdin()
            files = [spool if f == "-" else f for f in args.files or ["-"]]
            args.files = [f for i, f in enumerate(files)
                          if f != spool or spool not in files[:i]]
        if args.recursive and not args.files:
            args.files = ["."]  # GNU grep -r with no FILE searches the cwd
        rc, had_file_errors = expand_files(args, spool)
        if rc:
            return rc
        if args.follow:
            return _grep_follow(args, patterns, had_file_errors, out)
        if work_dir is None:
            work_dir = tempfile.mkdtemp(prefix="dgrep-")
        return _run_and_print(args, patterns, out, had_file_errors,
                              work_dir, STDIN_LABEL,
                              str(Path(spool).resolve()) if spool else None)
    finally:
        if spool is not None:
            os.unlink(spool)
        if args.work_dir is None and work_dir is not None:
            shutil.rmtree(work_dir, ignore_errors=True)


def _run_and_print(args: argparse.Namespace, patterns, out,
                   had_file_errors: bool, work_dir: str, label: str,
                   stdin_path: str | None) -> int:
    """Run the grep job over ``args.files`` and print its result in the
    mode the options ask for; returns the exit status."""
    from distributed_grep_tpu_torch.cli_display import (
        line_offsets,
        print_only_matching,
        print_with_context,
    )
    from distributed_grep_tpu_torch.runtime.job import GREP_KEY_RE, run_job
    from distributed_grep_tpu_torch.utils.config import JobConfig

    ctx_before = (args.context if args.context is not None
                  else args.before_context)
    ctx_after = (args.context if args.context is not None
                 else args.after_context)
    # -c/-l/-L/-q: one count record per file instead of a record per
    # line (-q/-l/-L need only whether it is nonzero), unless -b, -o or
    # context need the line sets and the records' values
    count_only = ((args.count or args.quiet or args.files_with_matches
                   or args.files_without_match)
                  and not (ctx_before or ctx_after or args.byte_offset
                           or args.only_matching
                           or args.context is not None))
    query = ({"patterns": patterns} if patterns is not None
             else {"pattern": args.pattern, "max_errors": args.max_errors})
    cfg = JobConfig(
        input_files=[str(Path(f).resolve()) for f in args.files],
        app_options={
            **query,
            "ignore_case": args.ignore_case,
            "invert": args.invert,
            **({"backend": "cpu"} if args.backend == "cpu" else {}),
            **({"word_regexp": True} if args.word_regexp else {}),
            **({"line_regexp": True} if args.line_regexp else {}),
            **({"count_only": True} if count_only else {}),
            **({"presence_only": True}
               if count_only and not args.count else {}),
        },
        n_reduce=args.n_reduce,
        work_dir=work_dir,
        # a temp work dir nobody resumes: no journal, no fsync before the
        # commits' renames (they stay atomic)
        journal=args.work_dir is not None,
        durable=args.work_dir is not None,
    )
    if len(cfg.input_files) > 1:
        # cross-file batching, as the reference CLI: small files share map
        # tasks and packed scans (runtime/job.plan_map_splits)
        from distributed_grep_tpu_torch.ops.layout import DEFAULT_BATCH_BYTES

        cfg.batch_bytes = DEFAULT_BATCH_BYTES
    if args.device == "cuda" and args.backend == "device":
        # the scan's heartbeats and its build grace keep a task alive;
        # the window needs only headroom over their cadence
        cfg.task_timeout_s = max(cfg.task_timeout_s, 30.0)
    t0 = time.perf_counter()
    # the app module itself, not a fresh instance: --metrics reads its
    # engine
    from distributed_grep_tpu_torch.apps import grep_cuda
    from distributed_grep_tpu_torch.apps.loader import from_module

    res = run_job(cfg, n_workers=args.workers, device=args.device,
                  app=from_module(grep_cuda))
    t_job = time.perf_counter()
    files = cfg.input_files

    def disp(path: str) -> str:
        return label if path == stdin_path else path

    # the modes that re-read the inputs (-b, context, -o -m) need each
    # file's selected line set, built from the keys alone
    need_sets = bool(ctx_before or ctx_after or args.byte_offset
                     or (args.only_matching and args.max_count is not None))
    default_print = not (args.quiet or args.files_without_match
                         or args.files_with_matches or args.count
                         or args.only_matching or ctx_before or ctx_after)
    # the default print decides the exit status from the records it
    # streams: no counting pass before it
    stream_counts = default_print and not need_sets and not count_only
    matched: dict[str, set[int]] | None = None
    counts = dict.fromkeys(files, 0)
    if need_sets:
        matched = {f: set() for f in files}
        for path, ln in res.iter_grep_keys():
            s = matched.get(path)
            if s is not None:
                s.add(ln)
        if args.max_count is not None:
            matched = {f: set(sorted(lns)[: args.max_count])
                       for f, lns in matched.items()}
        counts = {f: len(matched[f]) for f in files}
    elif not stream_counts:
        # count records (key: the file, value: N), or else (-o, -C 0) the
        # grep keys, parsed as bytes: one a selected line
        pairs = (((k, int(v)) for k, v in res.iter_results()) if count_only
                 else ((path, 1) for path, _ln in res.iter_grep_keys()))
        for f, add in pairs:
            if f in counts:
                counts[f] += add
                if args.quiet and counts[f]:
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
                _write(out, f"{disp(f)}\n")
    elif args.files_with_matches:
        for f in files:
            if counts[f]:
                _write(out, f"{disp(f)}\n")
    elif args.count:
        prefix = ((len(files) > 1 or args.with_filename)
                  and not args.no_filename)
        for f in files:
            _write(out, f"{disp(f)}:{counts[f]}\n" if prefix
                   else f"{counts[f]}\n")
    elif args.only_matching:
        if not args.invert:  # -v -o: no matched parts to print
            print_only_matching(
                out, res, args, patterns, matched,
                line_offsets(matched) if args.byte_offset else None, disp)
    elif ctx_before or ctx_after:
        printed_any = False  # the '--' separator is global across files
        for f in files:
            printed_any = print_with_context(
                out, f, matched[f], ctx_before, ctx_after, printed_any,
                no_filename=args.no_filename, byte_offset=args.byte_offset,
                display=disp(f))
    else:
        offsets = line_offsets(matched) if args.byte_offset else None
        # the key's parts are needed only by -m, -h, -b and the stdin label
        parse = (args.max_count is not None or args.no_filename
                 or offsets is not None or stdin_path is not None)
        saw_any = False
        if not parse and res.fileline_sorted:
            # display lines stream as bytes from the sorted output files
            for block in res.display_blocks_sorted():
                if block:
                    out.write(block)
                    saw_any = True
        else:
            emitted = dict.fromkeys(files, 0)
            for key, value in res.iter_results_sorted():
                m = GREP_KEY_RE.match(key) if parse else None
                if args.max_count is not None and m and m.group(1) in emitted:
                    if emitted[m.group(1)] >= args.max_count:
                        continue  # past the -m cap: not counted either
                    emitted[m.group(1)] += 1
                saw_any = True
                if m and (args.no_filename or offsets is not None
                          or stdin_path is not None):
                    path, ln = m.group(1), int(m.group(2))
                    head = "" if args.no_filename else f"{disp(path)} "
                    boff = (f"(byte #{offsets[path].get(ln, '?')}) "
                            if offsets is not None else "")
                    _write(out, f"{head}(line number #{ln}) {boff}{value}\n")
                else:
                    _write(out, f"{key} {value}\n")
        if stream_counts:
            rc_final = 2 if had_file_errors else (0 if saw_any else 1)
    out.flush()
    if args.metrics:
        _print_metrics(res, t_job - t0, time.perf_counter() - t_job)
    return rc_final


def _check_follow(args: argparse.Namespace) -> int:
    """The reference CLI's --follow refusals: 0, or 2 after printing the
    diagnostic."""
    conflicts = [flag for flag, on in (
        ("-o", args.only_matching),
        ("-A/-B/-C", args.context is not None or args.before_context
         or args.after_context),
        ("-b", args.byte_offset),
        ("-m", args.max_count is not None),
        ("-w", args.word_regexp),
        ("-x", args.line_regexp),
        ("-L", args.files_without_match),
        ("--max-errors", bool(args.max_errors)),
    ) if on]
    if conflicts:
        return _error(f"--follow does not support {', '.join(conflicts)}")[0]
    if (not args.files and not args.recursive) or "-" in args.files:
        return _error("--follow needs named FILE arguments (cannot follow "
                      "standard input)")[0]
    return 0


def _follow_record_line(rec: dict, *, no_filename: bool = False) -> str:
    """A follow record's text line as the default print prints it, shared
    by ``grep --follow`` and ``submit --stream``: the text's bytes
    (surrogateescape) decoded with replacement."""
    text = rec["text"].encode("utf-8", "surrogateescape").decode(
        "utf-8", "replace")
    head = "" if no_filename else f"{rec['file']} "
    return f"{head}(line number #{rec['line']}) {text}"


def _print_follow_reset(rec: dict) -> None:
    """A truncated or replaced file, on stderr as tail says it: its line
    numbers start again."""
    print(f"dgrep: {rec['file']}: file truncated or replaced; following "
          f"new data", file=sys.stderr)


def _grep_follow(args: argparse.Namespace, patterns, had_file_errors: bool,
                 out) -> int:
    """``grep --follow``: one engine (on ``args.device``, or the host with
    ``--backend cpu``), the files polled every DGREP_FOLLOW_POLL_S seconds
    and each poll's selected lines printed as the default print prints
    them (runtime/follow.FollowScanner).  ``--follow-idle-s S`` ends the
    loop once no file has grown for S seconds; the last polls take an
    unterminated last line too, until nothing is left to read."""
    from distributed_grep_tpu_torch.ops.engine import cached_engine
    from distributed_grep_tpu_torch.runtime.follow import (
        FollowScanner,
        env_follow_poll_s,
    )

    files = [str(Path(f).resolve()) for f in args.files]
    eng, _verdict = cached_engine(
        args.pattern if patterns is None else None, patterns=patterns,
        ignore_case=args.ignore_case, device=args.device,
        backend=args.backend)
    count_only = bool(args.count or args.quiet or args.files_with_matches)
    scanner = FollowScanner(eng, files, invert=args.invert,
                            count_only=count_only,
                            presence_only=count_only and not args.count)
    poll_s = env_follow_poll_s()
    idle_s = max(0.0, float(args.follow_idle_s or 0.0))

    def print_records(groups) -> None:
        for _path, records, _cursor in groups:
            for rec in records:
                if rec.get("reset"):
                    _print_follow_reset(rec)
                elif "text" in rec:
                    out.write(_follow_record_line(
                        rec, no_filename=args.no_filename).encode(
                        "utf-8", "surrogateescape") + b"\n")
                elif rec.get("match") and args.files_with_matches:
                    _write(out, f"{rec['file']}\n")
        out.flush()

    last_news = time.monotonic()
    try:
        while True:
            groups = scanner.poll_once()
            print_records(groups)
            if groups:
                last_news = time.monotonic()
            if args.quiet and scanner.any_selected():
                return 0
            if idle_s and time.monotonic() - last_news >= idle_s:
                break
            time.sleep(poll_s)
    except KeyboardInterrupt:
        pass
    # the last polls: an unterminated last line too, until nothing is
    # left (one poll reads at most a window a file)
    while groups := scanner.poll_once(final=True):
        print_records(groups)
    if args.count:
        prefix = ((len(files) > 1 or args.with_filename)
                  and not args.no_filename)
        for f in files:
            n = scanner.cursors[f].emitted
            _write(out, f"{f}:{n}\n" if prefix else f"{n}\n")
        out.flush()
    any_selected = scanner.any_selected()
    if args.quiet:
        return 0 if any_selected else (2 if had_file_errors else 1)
    return 2 if had_file_errors else (0 if any_selected else 1)


def cmd_run(args: argparse.Namespace) -> int:
    from distributed_grep_tpu_torch.runtime.job import run_job
    from distributed_grep_tpu_torch.utils.config import JobConfig

    overrides = {}
    if args.n_reduce:
        overrides["n_reduce"] = args.n_reduce
    if args.work_dir:
        overrides["work_dir"] = args.work_dir
    cfg = JobConfig.load(args.config, **overrides)
    res = run_job(cfg, n_workers=args.workers, resume=args.resume)
    out = sys.stdout.buffer
    for k, v in res.iter_results_sorted():
        _write(out, f"{k} {v}\n")
    out.flush()
    if args.metrics:
        print(json.dumps(res.metrics, indent=2, sort_keys=True),
              file=sys.stderr)
    return 0


def cmd_coordinator(args: argparse.Namespace) -> int:
    from distributed_grep_tpu_torch.runtime.http_coordinator import (
        serve_coordinator,
    )
    from distributed_grep_tpu_torch.utils.config import JobConfig

    status = serve_coordinator(JobConfig.load(args.config),
                               resume=args.resume)
    # stdout: exactly one JSON line naming the committed outputs
    print(json.dumps({"outputs": status["outputs"]}), flush=True)
    return 0


def cmd_worker(args: argparse.Namespace) -> int:
    from distributed_grep_tpu_torch.runtime.http_transport import (
        run_http_worker,
    )

    run_http_worker(addr=args.addr, n_parallel=args.slots)
    return 0


def cmd_status(args: argparse.Namespace) -> int:
    """Print a running coordinator's GET /status as indented JSON; exit 2
    when it cannot be reached or does not answer JSON."""
    import urllib.error

    from distributed_grep_tpu_torch.runtime.http_transport import client_call

    url = f"http://{args.addr}/status"
    try:
        status = client_call(args.addr, "GET", "/status",
                             timeout=args.timeout)
    except urllib.error.HTTPError as e:  # reached, but not a coordinator
        print(f"error: {url} answered {e.code} {e.reason}", file=sys.stderr)
        return 2
    except OSError as e:
        print(f"error: cannot reach coordinator at {args.addr}: {e}",
              file=sys.stderr)
        return 2
    except ValueError:  # 200 with a body that is not JSON
        print(f"error: {url} did not return JSON: not a coordinator?",
              file=sys.stderr)
        return 2
    # the shard index's prunes (shipped by the workers' map attempts), on
    # lines of their own and only when nonzero, as the reference's submit
    counters = status.get("counters") or {}
    if counters.get("index_shards_pruned"):
        status["index_shards_pruned"] = int(counters["index_shards_pruned"])
        status["index_bytes_skipped"] = int(
            counters.get("index_bytes_skipped", 0))
    print(json.dumps(status, indent=2, sort_keys=True))
    return 0


def cmd_serve(args: argparse.Namespace) -> int:
    """The service daemon (runtime/service.py) until SIGINT or SIGTERM;
    then its final status as one JSON line on stdout."""
    import signal
    import threading

    from distributed_grep_tpu_torch.runtime.daemon_log import (
        DaemonLog,
        env_daemon_log,
    )
    from distributed_grep_tpu_torch.runtime.lease import lease_configured
    from distributed_grep_tpu_torch.runtime.service import (
        GrepService,
        ServiceServer,
    )

    work_root = args.work_root or tempfile.mkdtemp(prefix="dgrep-svc-")
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            signal.signal(sig, lambda *_: stop.set())
        except ValueError:
            pass  # not the main thread (a test drives it)
    if args.standby or lease_configured():
        return _serve_ha(args, work_root, stop)
    service = GrepService(
        work_root=work_root, max_jobs=args.max_jobs, queue_depth=args.queue,
        spans=args.spans, resume=False if args.no_resume else None,
        daemon_log=DaemonLog(work_root) if env_daemon_log() else None)
    server = ServiceServer(service, host=args.host, port=args.port)
    server.start()
    print(f"serving on {args.host}:{server.port} (work root {work_root})",
          file=sys.stderr, flush=True)
    scaler = _start_worker_pool(args, service, stop)
    try:
        stop.wait()
    except KeyboardInterrupt:
        pass
    stop.set()
    if scaler is not None:
        scaler.join(timeout=5.0)
    # the service stops first: the server's last seconds answer the
    # workers' polls JOB_DONE, so none waits out its retry schedule (C9)
    service.stop()
    server.shutdown(linger_s=2.0)
    # stdout: exactly one JSON line, the final status
    print(json.dumps(service.status()), flush=True)
    return 0


def _serve_ha(args: argparse.Namespace, work_root: str, stop) -> int:
    """``serve`` on the work root's lease: contend for it; serve while
    holding it (renewed, every durable write fenced on it); stand by on
    the same address while another daemon holds it.  A deposed active
    stops serving at once (no JOB_DONE to its workers: they move on to
    the new active) and contends again; a standby promotes through the
    registry's resume.  The last status as one JSON line on stdout."""
    import threading

    from distributed_grep_tpu_torch.runtime.daemon_log import (
        DaemonLog,
        env_daemon_log,
    )
    from distributed_grep_tpu_torch.runtime.lease import (
        WorkRootLease,
        env_lease_renew_s,
    )
    from distributed_grep_tpu_torch.runtime.service import (
        GrepService,
        ServiceServer,
        StandbyServer,
    )
    from distributed_grep_tpu_torch.utils import metrics as metrics_mod

    port = args.port
    standby = None
    last_status: dict = {"service": True, "role": "standby"}
    try:
        while not stop.is_set():
            if port == 0 and standby is None:
                # the address is fixed before the lease advertises it: a
                # daemon keeps one address across its roles
                standby = StandbyServer(work_root, host=args.host,
                                        port=0).start()
                port = standby.port
            lease = WorkRootLease(work_root, addr=f"{args.host}:{port}")
            poll_s = env_lease_renew_s()
            park_t0 = None
            # the failover clock: from the poll that found the lease stale
            detect_t = time.monotonic()
            while not lease.acquire():
                if standby is None:
                    standby = StandbyServer(work_root, host=args.host,
                                            port=port).start()
                if park_t0 is None:
                    park_t0 = time.monotonic()
                    print(f"standby on {args.host}:{port} (work root "
                          f"{work_root})", file=sys.stderr, flush=True)
                    last_status = standby.status()
                if stop.wait(poll_s):
                    return _emit_status(last_status)
                detect_t = time.monotonic()
            stolen = lease.epoch > 1
            # only the lease holder opens daemon.jsonl (opening truncates a
            # torn tail, which would cut the active's live file)
            daemon_log = None
            if env_daemon_log():
                daemon_log = DaemonLog(work_root, epoch=lease.epoch,
                                       role="active")
                if park_t0 is not None:
                    daemon_log.stage("standby_park", parked_s=round(
                        time.monotonic() - park_t0, 3))
                daemon_log.append_now(
                    "lease_steal" if stolen else "lease_acquire",
                    addr=f"{args.host}:{port}",
                    **({"prev_epoch": lease.epoch - 1} if stolen else {}))
            # renewed from here: a resume that outlasts the TTL must not
            # let the lease go stale under it
            box: list = []
            lease.start_renewal(
                on_lost=lambda: box and box[0]._on_lease_lost(),
                on_renew=lambda: box and box[0].lease_renewed())
            # a promotion is a resume: the registry re-admits the queued
            # jobs, resumes the running ones and the follow cursors
            service = GrepService(
                work_root=work_root, max_jobs=args.max_jobs,
                queue_depth=args.queue, spans=args.spans,
                resume=False if args.no_resume else None, lease=lease,
                daemon_log=daemon_log)
            if standby is not None:
                # the standby answered while the service resumed (a job's
                # device check may import the CUDA stack, seconds on a
                # card's host); the real server takes the address now
                standby.shutdown()
                standby = None
            box.append(service)
            if not service._lease_ok():
                service._on_lease_lost()  # lost while it resumed
            server = ServiceServer(service, host=args.host, port=port)
            server.start()
            port = server.port
            print(f"serving on {args.host}:{port} (work root {work_root}, "
                  f"epoch {lease.epoch})", file=sys.stderr, flush=True)
            if daemon_log is not None and (stolen or park_t0 is not None):
                failover_s = time.monotonic() - detect_t
                metrics_mod.histogram(
                    "dgrep_daemon_failover_seconds").observe(failover_s)
                daemon_log.append_now(
                    "promoted", addr=f"{args.host}:{port}",
                    failover_s=round(failover_s, 6),
                    running=len(service._running),
                    queued=len(service._queue))
            # a deposed service's scaler stops with it
            pool_stop = threading.Event()
            scaler = _start_worker_pool(args, service, pool_stop)
            try:
                while not stop.wait(0.5):
                    if service.deposed_event.is_set():
                        break
            except KeyboardInterrupt:
                stop.set()
            pool_stop.set()
            if scaler is not None:
                scaler.join(timeout=5.0)
            # the server goes first: the workers' next requests fail and
            # their address lists find the standby that takes over
            server.shutdown()
            lease.stop_renewal()
            # a deposed service's stop stages cancellations the fence
            # drops; an owner's stop flushes them and releases the lease
            service.stop()
            if daemon_log is not None:
                daemon_log.discard()  # a deposed daemon's staged events
            last_status = service.status()
            if stop.is_set():
                return _emit_status(last_status)
            print(f"deposed on {args.host}:{port}: standing by",
                  file=sys.stderr, flush=True)
    finally:
        if standby is not None:
            standby.shutdown()
    return _emit_status(last_status)


def _emit_status(status: dict) -> int:
    # stdout: exactly one JSON line, the last status
    print(json.dumps(status), flush=True)
    return 0


def _start_worker_pool(args: argparse.Namespace, service, stop):
    """``serve``'s in-process loops, and with ``--max-workers`` above
    ``--workers`` the thread that follows the daemon's scale advice every
    2 s (one loop more on grow, one fewer on shrink, between the two
    bounds; a shrink drains a loop at its next idle poll).  The scaler
    thread, or None."""
    import threading

    if args.workers:
        service.start_local_workers(args.workers)
    if not (args.max_workers and args.max_workers > args.workers):
        return None

    def scale_loop() -> None:
        while not stop.wait(2.0):
            advice = service.scale_advice()["advice"]
            cur = service.local_pool_size()
            if advice == "grow" and cur < args.max_workers:
                service.scale_local_pool(cur + 1)
            elif advice == "shrink" and cur > args.workers:
                service.scale_local_pool(max(args.workers, cur - 1))

    scaler = threading.Thread(target=scale_loop, name="svc-scaler",
                              daemon=True)
    scaler.start()
    return scaler


def _submit_config(args: argparse.Namespace):
    """The job of a ``submit``: its --config, or a grep_cuda job of the
    PATTERN/FILE form (on the card unless --backend cpu); or (2, None)
    after printing the diagnostic."""
    from distributed_grep_tpu_torch.utils.config import JobConfig

    if args.config:
        return 0, JobConfig.load(args.config)
    if args.pattern is None and not args.e_patterns and not args.patterns_file:
        return _error("need --config, or PATTERN/-e/-f and FILE arguments")
    if args.fixed_strings and args.extended_regexp:
        return _error("-E and -F are conflicting matchers")
    rc, patterns = _resolve_pattern_args(args)
    if rc:
        return rc, None
    if not args.files:
        return _error("need FILE arguments to submit")
    opts: dict = {}
    if args.backend:
        opts["backend"] = args.backend
    if args.ignore_case:
        opts["ignore_case"] = True
    if patterns:
        opts["patterns"] = patterns
    else:
        opts["pattern"] = args.pattern
    return 0, JobConfig(input_files=[str(Path(f).resolve())
                                     for f in args.files],
                        app_options=opts, n_reduce=args.n_reduce or 10)


def _with_follow(args: argparse.Namespace, cfg):
    """``--follow`` and ``--follow-poll-s`` applied to a submit's job (the
    cadence also over a --config that asked for follow itself)."""
    from dataclasses import replace

    if args.follow and not cfg.follow:
        cfg = replace(cfg, follow=True)
    if args.follow_poll_s and cfg.follow:
        cfg = replace(cfg, follow_poll_s=args.follow_poll_s)
    return cfg


def cmd_submit(args: argparse.Namespace) -> int:
    """Post a job to a service daemon, wait for it unless --no-wait, and
    print exactly one JSON line."""
    import secrets
    import urllib.error
    from dataclasses import replace

    from distributed_grep_tpu_torch.runtime.http_transport import (
        client_call,
        split_addrs,
    )

    rc, cfg = _submit_config(args)
    if rc:
        return rc
    cfg = _with_follow(args, cfg)

    # an address list: a request's bound is at most 30 s, so one that a
    # daemon's death leaves hanging is retried on the next address
    multi_addr = len(split_addrs(args.addr)) > 1
    call_timeout = min(args.timeout, 30.0) if multi_addr else args.timeout

    def call(method: str, path: str, body: bytes | None = None) -> dict:
        return client_call(args.addr, method, path, body=body,
                           timeout=call_timeout)

    # an address list: the submit carries a token, so a POST repeated
    # after a failover (its first reply lost, or a standby's 503) lands on
    # the job the first made; one address: the single-shot, token-free
    # submit
    if multi_addr and not cfg.submit_token:
        cfg = replace(cfg, submit_token=secrets.token_hex(16))
    submit_deadline = time.monotonic() + args.timeout
    while True:
        try:
            # single-shot with one address: a submit is not idempotent
            # without its token, and a retried POST whose first reply was
            # lost would admit the job twice
            reply = client_call(args.addr, "POST", "/jobs",
                                cfg.to_json().encode("utf-8", "strict"),
                                timeout=call_timeout, retry=multi_addr)
            break
        except urllib.error.HTTPError as e:
            if (multi_addr and e.code == 503
                    and time.monotonic() < submit_deadline):
                # every daemon answered standby: one promotes within the
                # TTL, and the token makes the re-POST safe
                time.sleep(0.5)
                continue
            detail = e.read()[:500].decode("utf-8", "replace")
            print(f"error: submit rejected ({e.code}): {detail}",
                  file=sys.stderr)
            return 2
        except OSError as e:
            if multi_addr and time.monotonic() < submit_deadline:
                time.sleep(0.5)  # the token makes the re-POST safe
                continue
            print(f"error: cannot reach service at {args.addr}: {e}",
                  file=sys.stderr)
            return 2
    job_id = reply["job_id"]
    if cfg.follow:
        # a standing query has no end to wait for: its records, or the
        # endpoint that serves them
        if args.stream:
            return _stream_follow(call, job_id, args)
        print(json.dumps({"job_id": job_id, "state": "following",
                          "stream": f"/jobs/{job_id}/stream"}))
        return 0
    if not args.wait:
        print(json.dumps({"job_id": job_id, "state": "submitted"}))
        return 0
    deadline = time.monotonic() + args.timeout
    status: dict = {}
    out: dict = {"job_id": job_id, "state": "unknown"}
    try:
        # the job is admitted: every outcome from here prints one line
        while time.monotonic() < deadline:
            try:
                status = call("GET", f"/jobs/{job_id}")
            except OSError:
                # a failover (a standby answers 503 until it promotes, and
                # the promoted daemon resumes the job): with an address
                # list, poll on within the budget
                if not multi_addr:
                    raise
                time.sleep(0.5)
                continue
            if status.get("state") in ("done", "failed", "cancelled"):
                break
            time.sleep(0.2)
        out["state"] = status.get("state", "unknown")
        if status.get("state") == "done":
            out["outputs"] = call("GET", f"/jobs/{job_id}/result")["outputs"]
        elif status.get("error"):
            out["error"] = status["error"]
        # the shard index's prunes, only when nonzero
        counters = (status.get("metrics") or {}).get("counters") or {}
        if counters.get("index_shards_pruned"):
            out["index_shards_pruned"] = int(counters["index_shards_pruned"])
            out["index_bytes_skipped"] = int(
                counters.get("index_bytes_skipped", 0))
        # the result cache's reuse, only when nonzero
        if counters.get("result_splits_reused"):
            out["result_splits_reused"] = int(
                counters["result_splits_reused"])
            out["result_bytes_unscanned"] = int(
                counters.get("result_bytes_unscanned", 0))
        if args.explain and status.get("state") in ("done", "failed"):
            # the routing report on the same line, best effort
            try:
                out["explain"] = call("GET", f"/jobs/{job_id}/explain")
            except (OSError, ValueError):
                pass
    except OSError as e:
        out["error"] = f"lost service at {args.addr}: {e}"
    print(json.dumps(out))
    return 0 if out["state"] == "done" else 1


def _stream_follow(call, job_id: str, args: argparse.Namespace) -> int:
    """Read GET /jobs/<id>/stream with a moving cursor and print each
    record as ``grep --follow`` prints it (a count record as ``FILE:
    +N``, a presence record as FILE), until --timeout or the job leaves
    RUNNING; then one JSON summary line."""
    deadline = time.monotonic() + args.timeout
    cursor = 0
    printed = 0
    dropped = 0
    state = "running"
    while time.monotonic() < deadline:
        # the server's long poll stays well inside the socket's timeout
        window = min(10.0, max(0.5, deadline - time.monotonic()),
                     max(0.5, args.timeout - 2.0))
        try:
            reply = call("GET", f"/jobs/{job_id}/stream?cursor={cursor}"
                                f"&timeout={window:.1f}")
        except OSError as e:
            print(f"error: lost service mid-stream: {e}", file=sys.stderr)
            break
        cursor = int(reply.get("next", cursor))
        state = reply.get("state", state)
        dropped += int(reply.get("dropped", 0))
        records = reply.get("records") or []
        for rec in records:
            printed += 1
            if rec.get("reset"):
                _print_follow_reset(rec)
            elif "text" in rec:
                print(_follow_record_line(rec), flush=True)
            elif "count" in rec:
                print(f"{rec['file']}: +{int(rec['count'])}", flush=True)
            elif rec.get("match"):
                print(rec["file"], flush=True)
        if state in ("done", "failed", "cancelled") and not records:
            break  # terminal and drained; a queued job keeps polling
        if not records and state != "running":
            # a queued job's page answers at once: pace the polls
            time.sleep(min(0.5, max(0.0, deadline - time.monotonic())))
    out: dict = {"job_id": job_id, "state": state, "records": printed,
                 "cursor": cursor}
    if dropped:
        out["dropped"] = dropped
    print(json.dumps(out))
    return 0


def cmd_trace_export(args: argparse.Namespace) -> int:
    """Render a job's events.jsonl as Chrome trace_event JSON (stdout, or
    ``-o OUT``); exit 2 when there is no event log."""
    from distributed_grep_tpu_torch.utils.spans import (
        EventLog,
        export_chrome_trace,
    )

    if args.fleet:
        from distributed_grep_tpu_torch.runtime import (
            daemon_log as daemon_log_mod,
        )
        from distributed_grep_tpu_torch.utils.spans import export_fleet_trace

        root = Path(args.events)
        if root.is_file():  # a daemon.jsonl path: its dir is the root
            root = root.parent
        if not (root / daemon_log_mod.FILENAME).exists():
            print(f"error: no {daemon_log_mod.FILENAME} under {root} "
                  f"(serve with DGREP_DAEMON_LOG on)", file=sys.stderr)
            return 2
        jobs = {p.parent.name: EventLog.read(p)
                for p in sorted(root.glob(f"*/{EventLog.FILENAME}"))}
        doc = export_fleet_trace(daemon_log_mod.DaemonLog.read(root), jobs)
    else:
        path = Path(args.events)
        if path.is_dir():  # a work dir: the log lives at its root
            path = path / EventLog.FILENAME
        if not path.exists():
            print(f"error: no event log at {path} (run the job with "
                  f"JobConfig.spans=true or DGREP_SPANS=1)", file=sys.stderr)
            return 2
        doc = export_chrome_trace(EventLog.read(path))
    if args.out and args.out != "-":
        Path(args.out).write_text(json.dumps(doc))
        print(f"{len(doc['traceEvents'])} trace events -> {args.out}",
              file=sys.stderr)
    else:
        json.dump(doc, sys.stdout)
        print()
    return 0


def cmd_explain(args: argparse.Namespace) -> int:
    """A job's routing report as indented JSON: the daemon's (``--addr``,
    GET /jobs/<id>/explain), or one built from a work dir's events.jsonl
    (with the daemon's timeline when daemon.jsonl sits in its parent, a
    service work root).  Exit 2 when there is no report."""
    import urllib.error

    if args.addr:
        from distributed_grep_tpu_torch.runtime.http_transport import (
            client_call,
        )

        try:
            doc = client_call(args.addr, "GET",
                              f"/jobs/{args.target}/explain",
                              timeout=args.timeout)
        except urllib.error.HTTPError as e:
            detail = e.read()[:200].decode("utf-8", "replace")
            print(f"error: explain failed ({e.code}): {detail}",
                  file=sys.stderr)
            return 2
        except OSError as e:
            print(f"error: cannot reach service at {args.addr}: {e}",
                  file=sys.stderr)
            return 2
        print(json.dumps(doc, indent=2, sort_keys=True))
        return 0
    from distributed_grep_tpu_torch.runtime import daemon_log as daemon_log_mod
    from distributed_grep_tpu_torch.runtime import explain as explain_mod
    from distributed_grep_tpu_torch.utils.spans import EventLog

    path = Path(args.target)
    if path.is_dir():
        path = path / EventLog.FILENAME
    if not path.exists():
        print(f"error: no event log at {path} (run the job with "
              f"\"spans\": true or DGREP_SPANS=1, or pass --addr for a "
              f"service job)", file=sys.stderr)
        return 2
    daemon_events = None
    work_root = path.parent.parent
    if (work_root / daemon_log_mod.FILENAME).exists():
        daemon_events = daemon_log_mod.DaemonLog.read(work_root)
    doc = explain_mod.assemble(
        job_id=path.parent.name, config=None, state="", submitted_at=None,
        started_at=None, finished_at=None, metrics_counters={},
        events=EventLog.read(path), daemon_events=daemon_events)
    print(json.dumps(doc, indent=2, sort_keys=True))
    return 0


def env_top_interval_s(default: float = 2.0) -> float:
    """DGREP_TOP_INTERVAL_S, ``top``'s refresh cadence (malformed or <= 0
    keeps ``default``)."""
    raw = os.environ.get("DGREP_TOP_INTERVAL_S")
    if raw is None or raw == "":
        return default
    try:
        v = float(raw)
    except ValueError:
        return default
    return v if v > 0 else default


def _parse_metrics_text(text: str) -> dict[str, float]:
    """Prometheus text to {name: value} for the samples without labels
    (gauges, counters, a histogram's _sum and _count)."""
    out: dict[str, float] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if len(parts) != 2 or "{" in parts[0]:
            continue
        try:
            out[parts[0]] = float(parts[1])
        except ValueError:
            continue
    return out


def _kv_line(d: dict) -> str:
    return "  ".join(f"{k}={d[k]}" for k in sorted(d))


def _render_top(statuses: dict[str, dict | None], active_addr: str | None,
                metrics: dict[str, float]) -> str:
    """One screen of ``top``: each address's role, the active daemon's
    gauges, scale advice, windowed cache-hit ratios (from /metrics),
    latency, standing queries and groups, the worker table (with the
    freshness the scale advice reads) and the live jobs."""
    lines: list[str] = []
    roles = []
    for addr, st in statuses.items():
        role = "down" if st is None else str(st.get("role", "active"))
        roles.append(f"{addr} [{role.upper()}]")
    lines.append("dgrep top — " + "   ".join(roles))
    st = statuses.get(active_addr) if active_addr else None
    if st is None:
        standby = next((s for s in statuses.values() if s), None)
        if standby is None:
            lines.append("no daemon reachable")
        else:
            lines.append("no ACTIVE daemon — parked standby answers; "
                         f"lease names {standby.get('active', '?')}")
        return "\n".join(lines)
    lines.append(
        f"uptime {st.get('uptime_s', 0.0):8.1f}s   "
        f"queued {st.get('queued', 0)}/{st.get('queue_depth_cap', '?')}   "
        f"running {len(st.get('running', []))}/{st.get('max_jobs', '?')}   "
        f"workers {len(st.get('workers', {}))}   "
        f"quarantined {st.get('workers_quarantined', 0)}")
    scale = st.get("scale")
    if scale:
        lines.append(f"scale: {_kv_line(scale)}")
    ratios = {k.replace("dgrep_", "").replace("_hit_ratio", ""): round(v, 3)
              for k, v in metrics.items() if k.endswith("_hit_ratio")}
    if ratios:
        lines.append("cache hit ratios (window): " + _kv_line(ratios))
    failovers = metrics.get("dgrep_daemon_failover_seconds_count")
    if failovers:
        mean = metrics.get("dgrep_daemon_failover_seconds_sum", 0.0) / failovers
        lines.append(f"failovers: {int(failovers)} "
                     f"(mean {mean:.2f}s promotion latency)")
    latency = st.get("latency")
    if latency:
        for key, summ in sorted(latency.items()):
            lines.append(f"latency {key}: {_kv_line(summ)}")
    follow = st.get("follow")
    if follow:
        follow = dict(follow)
        groups = follow.pop("groups", None)
        lines.append(f"follow: {_kv_line(follow)}")
        for g in groups or []:
            lines.append(
                f"  group [{','.join(str(j) for j in g.get('jobs', []))}]: "
                f"members={g.get('members', 0)} files={g.get('files', 0)} "
                f"poll_s={g.get('poll_s', 0)} wakes={g.get('wakes', 0)} "
                f"wake_lag_s={g.get('wake_lag_s', 0.0)}")
    workers = st.get("workers") or {}
    if workers:
        lines.append("")
        lines.append(f"{'WID':>4} {'EVENT AGE':>10} {'JOB':>8} "
                     f"{'TASK':>6} {'QUAR':>6}  GBPS")
        for wid in sorted(workers, key=lambda w: int(w)):
            row = workers[wid]
            m = row.get("metrics") or {}
            quar = row.get("quarantined_s")
            task = row.get("task")
            lines.append(
                f"{wid:>4} {row.get('last_event_age_s', 0.0):>9.1f}s "
                f"{str(row.get('job') or '-'):>8} "
                f"{str(task if task is not None else '-'):>6} "
                f"{(f'{quar:.0f}s' if quar else '-'):>6}  "
                f"{m.get('gbps', 0.0):.3f}")
    jobs = st.get("jobs") or {}
    active_jobs = {j: d for j, d in jobs.items()
                   if d.get("state") in ("running", "queued")}
    if active_jobs:
        lines.append("")
        for jid in sorted(active_jobs):
            d = active_jobs[jid]
            prog = ""
            if "map_total" in d:
                prog = f"  map {d.get('map_completed', 0)}/{d['map_total']}"
            lines.append(f"job {jid}: {d.get('state')}{prog}")
    return "\n".join(lines)


def cmd_top(args: argparse.Namespace) -> int:
    """A console of daemons: each address of the list polled (GET /status
    once, no retry: a dead one shows "down"), the active one's view with
    its /metrics ratios; ``--once`` prints one screen, else it redraws
    every interval until interrupted."""
    from distributed_grep_tpu_torch.runtime.http_transport import (
        client_call,
        client_text,
        split_addrs,
    )

    addrs = split_addrs(args.addr)
    interval = args.interval if args.interval else env_top_interval_s()
    try:
        while True:
            statuses: dict[str, dict | None] = {}
            for a in addrs:
                try:
                    st = client_call(a, "GET", "/status",
                                     timeout=args.timeout, retry=False)
                    statuses[a] = st if isinstance(st, dict) else None
                except Exception:  # noqa: BLE001 -- down, or not a daemon
                    statuses[a] = None
            active_addr = next(
                (a for a, st in statuses.items()
                 if st and st.get("service")
                 and st.get("role", "active") == "active"), None)
            metrics: dict[str, float] = {}
            if active_addr is not None:
                try:
                    metrics = _parse_metrics_text(client_text(
                        active_addr, "/metrics", timeout=args.timeout))
                except Exception:  # noqa: BLE001 -- the console stays up
                    pass
            screen = _render_top(statuses, active_addr, metrics)
            if args.once:
                print(screen)
                return 0 if any(statuses.values()) else 2
            sys.stdout.write("\x1b[H\x1b[2J" + screen + "\n")
            sys.stdout.flush()
            time.sleep(interval)
    except KeyboardInterrupt:
        return 0


COMMANDS = {"grep": cmd_grep, "run": cmd_run, "coordinator": cmd_coordinator,
            "worker": cmd_worker, "status": cmd_status, "serve": cmd_serve,
            "submit": cmd_submit, "trace-export": cmd_trace_export,
            "explain": cmd_explain, "top": cmd_top}


def main(argv: list[str] | None = None) -> int:
    from distributed_grep_tpu_torch.utils import logging as dgrep_logging

    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "analyze":
        from distributed_grep_tpu_torch.analysis.checker import (
            main as analyze_main,
        )

        return analyze_main(argv[1:])
    args = _parser().parse_args(argv)
    if args.cmd != "grep":  # the runtime's log on stderr, at DGREP_LOG
        dgrep_logging.configure()
    try:
        return COMMANDS[args.cmd](args)
    except (NotImplementedError, RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
