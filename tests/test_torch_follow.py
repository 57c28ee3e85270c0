"""``grep --follow`` in the port (runtime/follow.py and
``GrepEngine.scan_file_suffix``) against the reference's FollowScanner
(backend "cpu") on the same appends, and against a one-shot scan of the
final file: the line carry, truncation and replacement, a file created
late, -v/-c/-l/-q, a line longer than the read cap, and the CLI's
``--follow --follow-idle-s`` output against the reference CLI's and the
one-shot run's, with appends from a thread.  Tolerance: exact."""

import threading
import time
from pathlib import Path

import pytest

from distributed_grep_tpu.ops.engine import GrepEngine as RefEngine
from distributed_grep_tpu.runtime.follow import FollowScanner as RefScanner
from distributed_grep_tpu_torch.ops import engine as engine_mod
from distributed_grep_tpu_torch.ops import lines as lines_mod
from distributed_grep_tpu_torch.ops.engine import GrepEngine
from distributed_grep_tpu_torch.runtime import follow as follow_mod
from distributed_grep_tpu_torch.runtime.follow import FollowScanner
from tests.test_torch_job import ENGINE_OPTS


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setenv("DGREP_FOLLOW_POLL_S", "0.02")
    yield
    engine_mod.model_cache_clear()
    follow_mod.follow_counters_clear()


def _oracle(eng, data: bytes) -> list[tuple[int, bytes]]:
    """(line, bytes) of a one-shot scan of the final file."""
    res = eng.scan(data)
    nl = lines_mod.newline_index(data)
    starts, ends = lines_mod.line_spans(res.matched_lines, nl, len(data))
    return [(int(n), data[s:e]) for n, s, e in zip(
        res.matched_lines.tolist(), starts.tolist(), ends.tolist())]


def _streamed(groups) -> list[tuple[int, bytes]]:
    return [(rec["line"], rec["text"].encode("utf-8", "surrogateescape"))
            for _p, records, _c in groups for rec in records
            if "text" in rec]


# every edge shape: a catch-up, an append cutting a line mid-byte, the
# append completing it, one exact line, an empty append, CRLF, a non-UTF-8
# byte, and an unterminated tail (taken by the final poll)
STAGES = [
    b"hello start\nhallo there\nmiss\n",
    b"partial hel",
    b"lo end\nab zz q volcano needle\n",
    b"hello exactly one helloo line\r\n",
    b"",
    b"\n\xffends with hello\n",
    b"tail hello no newline",
]

FAMILIES = [
    ("shift_and", {"pattern": "hello"}),
    ("-i", {"pattern": "HELLO", "ignore_case": True}),
    ("nfa", {"pattern": "h[ae]llo+"}),
    ("^ anchor", {"pattern": "^hello"}),
    ("$ anchor", {"pattern": "hello$"}),
    ("^$", {"pattern": "^$"}),
    ("pairset", {"patterns": ["ab", "zz", "q"]}),
    ("fdr", {"patterns": ["hello", "volcano", "needle", "tail hel"]}),
    ("approx", {"pattern": "volcanx", "max_errors": 1}),
    ("re", {"pattern": "(l)\\1"}),
    ("host backend", {"pattern": "hello", "backend": "cpu"}),
]


def _port_engine(opts):
    opts = dict(opts)
    if opts.get("backend") == "cpu":
        return GrepEngine(**opts)
    return GrepEngine(device="cpu", **opts, **ENGINE_OPTS)


def _ref_engine(opts):
    return RefEngine(**{**opts, "backend": "cpu"})


def _run_stages(scanner, path: Path, stages) -> list:
    path.write_bytes(b"")
    groups = []
    for stage in stages:
        with open(path, "ab") as f:
            f.write(stage)
        groups.extend(scanner.poll_once())
    groups.extend(scanner.poll_once(final=True))
    return groups


@pytest.mark.parametrize("label,opts", FAMILIES, ids=[f[0] for f in FAMILIES])
def test_suffix_exactness_across_families(tmp_path, label, opts):
    path = tmp_path / "grow.log"
    eng = _port_engine(opts)
    got = _run_stages(FollowScanner(eng, [str(path)]), path, STAGES)
    want = _run_stages(RefScanner(_ref_engine(opts), [str(path)]), path,
                       STAGES)
    assert _streamed(got) == _streamed(want)
    assert _streamed(got) == _oracle(eng, b"".join(STAGES))
    assert [(p, c) for p, _r, c in got] == [(p, c) for p, _r, c in want]
    assert label == "re" or _streamed(got)


def test_scan_file_suffix_equals_reference(tmp_path):
    p = tmp_path / "s.log"
    p.write_bytes(b"hello a\nhay\nhello b\npartial hello")
    port, ref = GrepEngine("hello", device="cpu"), _ref_engine(
        {"pattern": "hello"})
    for offset in (0, 8, 12):
        for final in (False, True):
            for cap in (None, 5, 9, 1000):
                g, gn, gd = port.scan_file_suffix(p, offset, final=final,
                                                  max_bytes=cap)
                w, wn, wd = ref.scan_file_suffix(p, offset, final=final,
                                                 max_bytes=cap)
                assert (g.matched_lines.tolist(), gn, gd) == (
                    w.matched_lines.tolist(), wn, wd)
    port.scan_file_suffix(p, 0)
    assert port.stats["suffix_bytes_scanned"] == 20


def test_line_carry_is_not_emitted_early(tmp_path):
    path = tmp_path / "carry.log"
    path.write_bytes(b"hello done\nhello half")
    sc = FollowScanner(GrepEngine("hello", device="cpu"), [str(path)])
    assert _streamed(sc.poll_once()) == [(1, b"hello done")]
    assert sc.poll_once() == []
    with open(path, "ab") as f:
        f.write(b" more\nhello next\n")
    assert _streamed(sc.poll_once()) == [(2, b"hello half more"),
                                        (3, b"hello next")]
    assert sc.cursors[str(path)].offset == path.stat().st_size


def test_truncation_and_replacement_full_rescan(tmp_path):
    path = tmp_path / "rot.log"
    path.write_bytes(b"hello old\nhello older\n")
    sc = FollowScanner(GrepEngine("hello", device="cpu"), [str(path)])
    assert len(_streamed(sc.poll_once())) == 2
    path.write_bytes(b"hello x\n")  # truncated below the cursor
    groups = sc.poll_once()
    recs = groups[0][1]
    assert recs[0] == {"file": str(path), "reset": True}
    assert _streamed(groups) == [(1, b"hello x")]
    new = tmp_path / "new.log"  # replaced by a rename, the same size
    new.write_bytes(b"hello y\n")
    new.replace(path)
    groups = sc.poll_once()
    assert groups[0][1][0]["reset"] and _streamed(groups) == [(1, b"hello y")]


def test_missing_then_created_file(tmp_path):
    path = tmp_path / "later.log"
    sc = FollowScanner(GrepEngine("hello", device="cpu"), [str(path)])
    assert sc.poll_once() == []
    path.write_bytes(b"miss\nhello born\n")
    assert _streamed(sc.poll_once()) == [(2, b"hello born")]


@pytest.mark.parametrize("mode", ["invert", "count", "presence"])
def test_invert_count_presence_equal_reference(tmp_path, mode):
    kw = {"invert": {"invert": True},
          "count": {"count_only": True},
          "presence": {"count_only": True, "presence_only": True}}[mode]
    path = tmp_path / "m.log"
    eng = GrepEngine("hello", device="cpu", **ENGINE_OPTS)
    port = FollowScanner(eng, [str(path)], **kw)
    ref = RefScanner(_ref_engine({"pattern": "hello"}), [str(path)], **kw)
    got = _run_stages(port, path, STAGES)
    want = _run_stages(ref, path, STAGES)
    assert got == want
    final = b"".join(STAGES)
    n_lines = lines_mod.count_lines(final)
    hits = len(_oracle(eng, final))
    emitted = port.cursors[str(path)].emitted
    assert emitted == ref.cursors[str(path)].emitted
    if mode == "presence":  # the first poll with a selected line settles it
        assert 0 < emitted < hits
    else:
        assert emitted == (n_lines - hits if mode == "invert" else hits)
    if mode == "count":
        assert all("text" not in r for _p, rs, _c in got for r in rs)
    if mode == "presence":
        assert sum(r.get("match", False) for _p, rs, _c in got
                   for r in rs) == 1


def test_giant_line_larger_than_wake_cap_does_not_stall(tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(follow_mod, "MAX_WAKE_BYTES", 64)
    path = tmp_path / "giant.log"
    giant = b"hello " + b"x" * 300
    path.write_bytes(giant + b"\nhello after\n")
    sc = FollowScanner(GrepEngine("hello", device="cpu", **ENGINE_OPTS),
                       [str(path)])
    assert _streamed(sc.poll_once()) == [(1, giant), (2, b"hello after")]
    with open(path, "ab") as f:
        f.write(b"hello " + b"y" * 200)
    assert sc.poll_once() == []
    with open(path, "ab") as f:
        f.write(b"tail\n")
    assert _streamed(sc.poll_once()) == [(3, b"hello " + b"y" * 200
                                          + b"tail")]


def test_unterminated_tail_not_reread_until_growth(tmp_path, monkeypatch):
    eng = GrepEngine("hello", device="cpu")
    path = tmp_path / "tail.log"
    path.write_bytes(b"hello a\npartial hel")
    sc = FollowScanner(eng, [str(path)])
    calls = []
    real = eng.scan_file_suffix
    monkeypatch.setattr(eng, "scan_file_suffix",
                        lambda p, off, **kw: calls.append(off)
                        or real(p, off, **kw))
    assert len(_streamed(sc.poll_once())) == 1
    sc.poll_once()
    n = len(calls)
    for _ in range(4):
        assert sc.poll_once() == []
    assert len(calls) == n
    with open(path, "ab") as f:
        f.write(b"lo\n")
    assert _streamed(sc.poll_once()) == [(2, b"partial hello")]


def test_one_bad_file_does_not_discard_other_groups(tmp_path, monkeypatch):
    a, b = tmp_path / "a.log", tmp_path / "b.log"
    a.write_bytes(b"hello a\n")
    b.write_bytes(b"hello b\n")
    eng = GrepEngine("hello", device="cpu")
    sc = FollowScanner(eng, [str(a), str(b)])
    real = eng.scan_file_suffix

    def flaky(p, off, **kw):
        if str(p) == str(a):
            raise OSError("transient")
        return real(p, off, **kw)

    monkeypatch.setattr(eng, "scan_file_suffix", flaky)
    groups = sc.poll_once()
    assert [g[0] for g in groups] == [str(b)]
    assert sc.cursors[str(a)].offset == 0
    monkeypatch.setattr(eng, "scan_file_suffix", real)
    assert _streamed(sc.poll_once()) == [(1, b"hello a")]


def test_follow_counters_ride_engine_stats(tmp_path):
    """The counters of one poll are the reference's FollowScanner's on
    the same file (the stream rings' shed count among them, 0 here)."""
    path = tmp_path / "c.log"
    path.write_bytes(b"hello\n")
    eng = GrepEngine("hello", device="cpu")
    FollowScanner(eng, [str(path)]).poll_once()
    ref_follow_mod = __import__("distributed_grep_tpu.runtime.follow",
                                fromlist=["follow_counters"])
    ref_follow_mod.follow_counters_clear()
    RefScanner(_ref_engine({"pattern": "hello"}), [str(path)]).poll_once()
    assert follow_mod.follow_counters() == {"follow_wakes": 1,
                                            "suffix_bytes_scanned": 6,
                                            "stream_dropped_records": 0}
    assert follow_mod.follow_counters() == ref_follow_mod.follow_counters()
    ref_follow_mod.follow_counters_clear()
    assert eng.stats["suffix_bytes_scanned"] == 6
    follow_mod.follow_counters_clear()
    assert follow_mod.follow_counters() == {}


# ----------------------------------------------------------------- CLI
def _port_cli(argv):
    from distributed_grep_tpu_torch.__main__ import main

    return main(["grep", *argv, "--device", "cpu"])


def _ref_cli(argv):
    from distributed_grep_tpu.__main__ import main

    return main(["grep", *argv, "--backend", "cpu"])


def _follow_with_appends(cli, path: Path, capsysbinary, argv):
    """One CLI --follow run while a thread appends (a line cut in two,
    then an unterminated tail); returns (exit, stdout, stderr)."""
    path.write_bytes(b"hello first\nmiss\n")

    def appender():
        time.sleep(0.1)
        with open(path, "ab") as f:
            f.write(b"hello sec")
        time.sleep(0.1)
        with open(path, "ab") as f:
            f.write(b"ond\n\xffhello caf\xc3\xa9\nhello tail")

    t = threading.Thread(target=appender)
    t.start()
    try:
        rc = cli(["--follow", "--follow-idle-s", "0.5", *argv, str(path)])
    finally:
        t.join()
    got = capsysbinary.readouterr()
    return rc, got.out, got.err


@pytest.mark.parametrize("flags", [[], ["-h"], ["-c"], ["-v"], ["-i"],
                                   ["-F", "-e", "hello", "-e", "miss"]],
                         ids=lambda f: " ".join(f) or "plain")
def test_cli_follow_equals_reference_and_one_shot(tmp_path, capsysbinary,
                                                  flags):
    path = tmp_path / "cli.log"
    pat = [] if "-F" in flags else ["HELLO" if "-i" in flags else "hello"]
    got = _follow_with_appends(_port_cli, path, capsysbinary, [*flags, *pat])
    want = _follow_with_appends(_ref_cli, path, capsysbinary, [*flags, *pat])
    assert got[:2] == want[:2]
    assert _port_cli([*flags, *pat, str(path)]) == got[0]  # one-shot
    assert capsysbinary.readouterr().out == got[1]
    assert got[0] == 0 and got[1]


@pytest.mark.parametrize("flags", [["-l"], ["-q"], ["-c", "-H"]],
                         ids=" ".join)
def test_cli_follow_several_files_equal_reference(tmp_path, capsysbinary,
                                                  flags):
    files = []
    for i, body in enumerate((b"hello a\n", b"miss\n", b"x\nhello c")):
        p = tmp_path / f"f{i}.log"
        p.write_bytes(body)
        files.append(str(p))
    argv = ["--follow", "--follow-idle-s", "0.05", *flags, "hello", *files]
    rc = _port_cli(argv)
    got = capsysbinary.readouterr().out
    assert (rc, got) == (_ref_cli(argv), capsysbinary.readouterr().out)
    if "-q" not in flags:
        assert _port_cli([*flags, "hello", *files]) == rc
        assert capsysbinary.readouterr().out == got


def test_cli_follow_reset_notice_and_drain(tmp_path, capsysbinary,
                                           monkeypatch):
    monkeypatch.setattr(follow_mod, "MAX_WAKE_BYTES", 64)
    path = tmp_path / "burst.log"
    body = b"".join(b"hello line %02d\n" % i for i in range(20))
    path.write_bytes(body + b"hello tail")
    assert _port_cli(["--follow", "--follow-idle-s", "0.05", "-h", "hello",
                      str(path)]) == 0
    assert len(capsysbinary.readouterr().out.splitlines()) == 21
    path.write_bytes(b"hello old\n")

    def truncator():
        time.sleep(0.15)
        path.write_bytes(b"hello x\n")

    t = threading.Thread(target=truncator)
    t.start()
    rc = _port_cli(["--follow", "--follow-idle-s", "0.4", "-h", "hello",
                    str(path)])
    t.join()
    got = capsysbinary.readouterr()
    assert rc == 0
    assert got.out.splitlines() == [b"(line number #1) hello old",
                                    b"(line number #1) hello x"]
    assert b"truncated or replaced" in got.err


@pytest.mark.parametrize("argv,msg", [
    (["-o"], "does not support -o"), (["-C", "1"], "-A/-B/-C"),
    (["-b"], "-b"), (["-m", "1"], "-m"), (["-w"], "-w"), (["-x"], "-x"),
    (["-L"], "-L"), (["--max-errors", "1"], "--max-errors"),
], ids=lambda a: " ".join(a) if isinstance(a, list) else "")
def test_cli_follow_refusals_equal_reference(tmp_path, capsysbinary, argv,
                                             msg):
    path = tmp_path / "x.log"
    path.write_bytes(b"hello\n")
    assert _port_cli(["--follow", *argv, "hello", str(path)]) == 2
    assert msg.encode() in capsysbinary.readouterr().err
    assert _ref_cli(["--follow", *argv, "hello", str(path)]) == 2
    capsysbinary.readouterr()


def test_cli_follow_refuses_standard_input(capsysbinary):
    assert _port_cli(["--follow", "hello", "-"]) == 2
    assert b"cannot follow standard input" in capsysbinary.readouterr().err
    assert _port_cli(["--follow", "hello"]) == 2
    capsysbinary.readouterr()


def test_follow_engine_is_cached(tmp_path, capsysbinary):
    path = tmp_path / "c.log"
    path.write_bytes(b"hello\n")
    argv = ["--follow", "--follow-idle-s", "0.01", "-q", "hello", str(path)]
    assert _port_cli(argv) == 0 and _port_cli(argv) == 0
    assert engine_mod.model_cache_counters()["compile_cache_hits"] == 1
    capsysbinary.readouterr()


# =================================================================
# The daemon's standing queries: FollowLog, StreamRing, FollowRunner,
# the fused groups, the service and ``submit --follow``, each held to the
# reference's on the same appends.  The port's runners run on ``device:
# cpu`` with the small layout and DGREP_DEVICE_MIN_BYTES=0 (the kernels'
# plain versions scan every append), the reference's on ``backend: cpu``.

import json  # noqa: E402

from distributed_grep_tpu.runtime import follow as ref_follow  # noqa: E402
from distributed_grep_tpu_torch.runtime.follow import (  # noqa: E402
    FollowGroupRegistry,
    FollowLog,
    FollowLogError,
    FollowRunner,
    StreamRing,
)
from distributed_grep_tpu_torch.utils.config import JobConfig  # noqa: E402

PORT_GREP = "distributed_grep_tpu_torch.apps.grep_cuda"
REF_GREP = "distributed_grep_tpu.apps.grep_tpu"


@pytest.fixture
def _kernels(monkeypatch):
    """Every append scans on the kernels' plain versions, not the
    small-input host route (ROADMAP.md C8)."""
    monkeypatch.setenv("DGREP_DEVICE_MIN_BYTES", "0")
    monkeypatch.setenv("DGREP_NO_CALIBRATE", "1")
    follow_mod.follow_fused_counters_clear()
    ref_follow.follow_counters_clear()
    ref_follow.follow_fused_counters_clear()
    yield
    follow_mod.follow_fused_counters_clear()


def _port_fcfg(path, work_dir, **opts) -> JobConfig:
    app = {"device": "cpu", **ENGINE_OPTS, **opts}
    if "pattern" not in app and "patterns" not in app:
        app["pattern"] = "hello"
    files = path if isinstance(path, list) else [path]
    return JobConfig(input_files=[str(f) for f in files], application=PORT_GREP,
                     app_options=app, work_dir=str(work_dir), follow=True)


def _ref_fcfg(path, work_dir, **opts):
    from distributed_grep_tpu.utils.config import JobConfig as RefConfig

    app = {"backend": "cpu", **opts}
    if "pattern" not in app and "patterns" not in app:
        app["pattern"] = "hello"
    files = path if isinstance(path, list) else [path]
    return RefConfig(input_files=[str(f) for f in files],
                     application=REF_GREP, app_options=app,
                     work_dir=str(work_dir), follow=True)


def _recs(runner, cursor: int = 0) -> list[dict]:
    return runner.ring.read_since(cursor, timeout=0)[0]


def _lt(recs) -> list[tuple]:
    return [(r["line"], r["text"]) for r in recs if "text" in r]


def _pair(tmp_path, tag, path, reg=None, ref_reg=None, **opts):
    """The port's runner and the reference's, each in its own work dir."""
    p = FollowRunner(f"job-{tag}", _port_fcfg(path, tmp_path / f"p-{tag}",
                                              **opts),
                     tmp_path / f"p-{tag}", groups=reg)
    r = ref_follow.FollowRunner(f"job-{tag}",
                                _ref_fcfg(path, tmp_path / f"r-{tag}", **opts),
                                tmp_path / f"r-{tag}", groups=ref_reg)
    return p, r


def test_runner_restart_resumes_with_no_duplicate_and_no_loss(tmp_path,
                                                             _kernels):
    """A second runner over the same work dir (the first dropped without
    a close: only its fsync'd log survives) resumes from the logged
    cursors; both lives' records are the reference's, numbers go on."""
    log_path = tmp_path / "app.log"
    log_path.write_bytes(b"hello one\nmiss\n")
    p1, r1 = _pair(tmp_path, "t", log_path)
    assert p1.wake_once() == r1.wake_once() == 1
    with open(log_path, "ab") as f:
        f.write(b"hello two\n")
    assert p1.wake_once() == r1.wake_once() == 1
    first = _recs(p1)
    assert first == _recs(r1)
    del p1, r1
    with open(log_path, "ab") as f:
        f.write(b"hello three\nhello four\n")
    p2, r2 = _pair(tmp_path, "t", log_path)
    assert p2.resumed and r2.resumed
    assert p2.wake_once() == r2.wake_once() == 2
    seen = first + _recs(p2, first[-1]["seq"])
    assert _recs(p2, first[-1]["seq"]) == _recs(r2, first[-1]["seq"])
    assert [(r["line"], r["text"]) for r in seen] == [
        (1, "hello one"), (3, "hello two"), (4, "hello three"),
        (5, "hello four")]
    assert [r["seq"] for r in seen] == [1, 2, 3, 4]
    p2.close()
    r2.close()


def test_follow_log_torn_tail_rescans_once(tmp_path, _kernels):
    log_path = tmp_path / "app.log"
    log_path.write_bytes(b"hello a\nhello b\n")
    p1 = FollowRunner("job-t", _port_fcfg(log_path, tmp_path / "wd"),
                      tmp_path / "wd")
    p1.wake_once()
    jp = tmp_path / "wd" / FollowLog.FILENAME
    raw = jp.read_bytes()
    jp.write_bytes(raw[:len(raw) - 9])  # torn inside the last record
    del p1
    p2 = FollowRunner("job-t", _port_fcfg(log_path, tmp_path / "wd"),
                      tmp_path / "wd")
    assert not p2.resumed
    assert p2.wake_once() == 2
    assert _lt(_recs(p2)) == [(1, "hello a"), (2, "hello b")]
    p2.close()


def test_log_write_failure_rolls_the_cursor_back(tmp_path, monkeypatch,
                                                 _kernels):
    """A failed wake-log write publishes nothing and rolls the cursor back
    (FollowLogError, which the loop logs and retries); a write that landed
    before its fsync failed is journaled again under the same numbers,
    and a replay keeps the first."""
    log_path = tmp_path / "app.log"
    log_path.write_bytes(b"hello one\nhello two\n")
    r = FollowRunner("job-j", _port_fcfg(log_path, tmp_path / "wd"),
                     tmp_path / "wd")
    orig = r._log.record_wake

    def landed_then_failed(*a, **kw):
        orig(*a, **kw)
        raise OSError("fsync failed")

    monkeypatch.setattr(r._log, "record_wake", landed_then_failed)
    with pytest.raises(FollowLogError):
        r.wake_once()
    assert _recs(r) == []
    monkeypatch.setattr(r._log, "record_wake", orig)
    assert r.wake_once() == 2
    assert _lt(_recs(r)) == [(1, "hello one"), (2, "hello two")]
    del r
    r2 = FollowRunner("job-j", _port_fcfg(log_path, tmp_path / "wd"),
                      tmp_path / "wd")
    assert [(x["seq"], x["line"]) for x in _recs(r2)] == [(1, 1), (2, 2)]
    # a torn fragment left by a failed write: the next wake reopens first
    with open(tmp_path / "wd" / FollowLog.FILENAME, "ab") as f:
        f.write(b'{"kind": "wa')
    r2._log_dirty = True
    with open(log_path, "ab") as f:
        f.write(b"hello three\n")
    assert r2.wake_once() == 1
    del r2
    r3 = FollowRunner("job-j", _port_fcfg(log_path, tmp_path / "wd"),
                      tmp_path / "wd")
    assert _lt(_recs(r3)) == [(1, "hello one"), (2, "hello two"),
                              (3, "hello three")]
    r3.close()


def test_follow_log_compaction_equals_the_reference(tmp_path, monkeypatch,
                                                    _kernels):
    """Past COMPACT_BYTES the log is rewritten at the next start as its
    snapshot; replay keeps REPLAY_TAIL_RECORDS, the cursor and the
    numbers, as the reference's does (and reads the reference's file)."""
    for mod in (follow_mod, ref_follow):
        monkeypatch.setattr(mod.FollowLog, "COMPACT_BYTES", 256)
        monkeypatch.setattr(mod.FollowLog, "REPLAY_TAIL_RECORDS", 4)
    log_path = tmp_path / "app.log"
    log_path.write_bytes(b"")
    p1, r1 = _pair(tmp_path, "c", log_path)
    for i in range(10):
        with open(log_path, "ab") as f:
            f.write(b"hello %d\n" % i)
        assert p1.wake_once() == r1.wake_once() == 1
    jp = tmp_path / "p-c" / FollowLog.FILENAME
    big = jp.stat().st_size
    del p1, r1
    p2, r2 = _pair(tmp_path, "c", log_path)
    assert jp.stat().st_size < big and p2.resumed
    got = p2.ring.read_since(0, timeout=0)
    assert got == r2.ring.read_since(0, timeout=0)
    assert got[2] == 6 and [x["seq"] for x in got[0]] == [7, 8, 9, 10]
    assert (FollowLog.replay(jp)[:2]
            == ref_follow.FollowLog.replay(jp)[:2])
    with open(log_path, "ab") as f:
        f.write(b"hello post\n")
    assert p2.wake_once() == 1
    assert _lt(_recs(p2, 10)) == [(11, "hello post")]
    p2.close()
    r2.close()


def test_stream_ring_sheds_and_long_polls_as_the_reference():
    port, ref = StreamRing(cap_bytes=600), ref_follow.StreamRing(600)
    for i in range(50):
        rec = {"file": "f", "line": i + 1, "text": "x" * 40}
        assert port.publish([dict(rec)]) == ref.publish([dict(rec)])
    for cursor in (0, 5, 40, 49, 50, 60):
        assert port.read_since(cursor, timeout=0) == \
            ref.read_since(cursor, timeout=0)
    recs, nxt, dropped = port.read_since(0, timeout=0)
    assert dropped == recs[0]["seq"] - 1 > 0 and nxt == 50
    assert follow_mod.follow_counters()["stream_dropped_records"] == dropped
    ring = StreamRing(cap_bytes=1 << 20)
    got: list = []

    def reader():
        got.extend(ring.read_since(0, timeout=5.0)[0])

    t = threading.Thread(target=reader)
    t.start()
    time.sleep(0.1)
    ring.publish([{"file": "f", "line": 1, "text": "hello"}])
    t.join(timeout=5.0)
    assert [r["seq"] for r in got] == [1]
    closed = StreamRing()
    closed.close()
    t0 = time.monotonic()
    assert closed.read_since(0, timeout=5.0) == ([], 0, 0)
    assert time.monotonic() - t0 < 1.0


# the edge shapes of a growing file: a catch-up, a line cut mid-byte and
# its completion, one exact line, an empty append, an empty line, an
# unterminated tail
FUSED_STAGES = [
    b"hello start\nhallo there\nmiss\n",
    b"partial hel",
    b"lo end\nab zz q volcano needle\n",
    b"hello exactly one helloo line\n",
    b"",
    b"\nends with HELLO\n",
    b"tail hello no newline",
]

FUSED_QUERIES = [
    ("literal", {"pattern": "hello"}),
    ("nfa", {"pattern": "h[ae]llo+"}),
    ("anchor_start", {"pattern": "^hello"}),
    ("anchor_end", {"pattern": "hello$"}),
    ("ignore_case", {"pattern": "HELLO", "ignore_case": True}),
    ("set", {"patterns": ["hello", "needle"]}),
    ("pairset", {"patterns": ["ab", "zz", "q"]}),
]


@pytest.mark.parametrize("label,opts", FUSED_QUERIES,
                         ids=[q[0] for q in FUSED_QUERIES])
def test_fused_streams_equal_solo_and_the_reference(tmp_path, label, opts,
                                                    _kernels):
    """A query in a fused group streams what its solo runner streams,
    what the reference's fused group streams, and the one-shot scan of the
    final file; its co-member (of its own family: a set with a set) never
    leaks into its confirm."""
    co = ({"patterns": ["volcano", "tail"]} if "patterns" in opts
          else {"pattern": "volcano"})
    logs = {k: tmp_path / f"{k}.log" for k in ("solo", "fused", "ref")}
    for p in logs.values():
        p.write_bytes(b"")
    solo = [FollowRunner(f"job-s{i}", _port_fcfg(logs["solo"],
                                                 tmp_path / f"s{i}", **o),
                         tmp_path / f"s{i}") for i, o in enumerate((opts, co))]
    reg = FollowGroupRegistry(start_threads=False, auto_solo=False)
    fused = [FollowRunner(f"job-f{i}", _port_fcfg(logs["fused"],
                                                  tmp_path / f"f{i}", **o),
                          tmp_path / f"f{i}", groups=reg)
             for i, o in enumerate((opts, co))]
    rreg = ref_follow.FollowGroupRegistry(start_threads=False,
                                          auto_solo=False)
    refs = [ref_follow.FollowRunner(
        f"job-r{i}", _ref_fcfg(logs["ref"], tmp_path / f"r{i}", **o),
        tmp_path / f"r{i}", groups=rreg) for i, o in enumerate((opts, co))]
    assert all(reg.adopt(r) for r in fused)
    assert all(rreg.adopt(r) for r in refs)
    (group,) = reg._groups.values()
    (rgroup,) = rreg._groups.values()
    for stage in FUSED_STAGES:
        for p in logs.values():
            with open(p, "ab") as f:
                f.write(stage)
        for r in solo:
            r.wake_once()
        group.wake_once()
        rgroup.wake_once()
    final = b"".join(FUSED_STAGES)
    done = final[:final.rfind(b"\n") + 1]
    for s, f, r, o in zip(solo, fused, refs, (opts, co)):
        eng = _port_engine(o)
        assert _lt(_recs(f)) == _lt(_recs(s)) == _lt(_recs(r)) == \
            [(n, t.decode("utf-8", "surrogateescape"))
             for n, t in _oracle(eng, done)]
        assert f.fused
    assert follow_mod.follow_fused_counters() == \
        ref_follow.follow_fused_counters()
    for r in solo + fused + refs:
        r.close()
    assert reg._groups == {}


def test_join_mid_stream_catches_up_then_fuses(tmp_path, _kernels):
    log = tmp_path / "app.log"
    log.write_bytes(b"hello a\nvolcano b\n")
    reg = FollowGroupRegistry(start_threads=False, auto_solo=False)
    first = FollowRunner("job-1", _port_fcfg(log, tmp_path / "w1"),
                         tmp_path / "w1", groups=reg)
    assert reg.adopt(first)
    (group,) = reg._groups.values()
    group.wake_once()
    with open(log, "ab") as f:
        f.write(b"hello c\n")
    group.wake_once()
    late = FollowRunner("job-2", _port_fcfg(log, tmp_path / "w2",
                                            pattern="volcano"),
                        tmp_path / "w2", groups=reg)
    assert reg.adopt(late)
    assert not late.fused  # catching up until its cursor is the group's
    group.wake_once()  # the catch-up: solo semantics on the group thread
    assert _lt(_recs(late)) == [(2, "volcano b")]
    with open(log, "ab") as f:
        f.write(b"volcano d hello\n")
    follow_mod.follow_fused_counters_clear()
    group.wake_once()  # level now: it fuses and rides the shared scan
    assert late.fused
    assert follow_mod.follow_fused_counters()[
        "follow_suffix_bytes_saved"] == len(b"volcano d hello\n")
    assert _lt(_recs(first)) == [(1, "hello a"), (3, "hello c"),
                                 (4, "volcano d hello")]
    assert _lt(_recs(late)) == [(2, "volcano b"), (4, "volcano d hello")]
    row = group.status()
    assert row["members"] == 2 and row["cursor_bytes"] == log.stat().st_size
    late.close()
    first.close()
    assert reg._groups == {}


def test_truncation_sends_the_group_solo_and_streams_stay_exact(tmp_path,
                                                               _kernels):
    loga = tmp_path / "a.log"
    loga.write_bytes(b"hello a1\nhello a2\n")
    reg = FollowGroupRegistry(start_threads=False, auto_solo=False)
    ra = [FollowRunner(f"job-{i}", _port_fcfg(loga, tmp_path / f"w{i}"),
                       tmp_path / f"w{i}", groups=reg) for i in range(2)]
    assert all(reg.adopt(r) for r in ra)
    (ga,) = reg._groups.values()
    ga.wake_once()
    loga.write_bytes(b"hello cut\n")
    ga.wake_once()
    assert all(not r.fused for r in ra) and reg._groups == {}
    for r in ra:
        r.wake_once()
        recs = _recs(r)
        assert {"file": str(loga), "reset": True} in [
            {k: v for k, v in x.items() if k != "seq"} for x in recs]
        assert _lt(recs) == [(1, "hello a1"), (2, "hello a2"),
                             (1, "hello cut")]
        r.close()


def test_commit_failure_sends_only_that_member_solo(tmp_path, monkeypatch,
                                                    _kernels):
    log = tmp_path / "app.log"
    log.write_bytes(b"hello x\n")
    reg = FollowGroupRegistry(start_threads=False, auto_solo=False)
    ok = FollowRunner("job-ok", _port_fcfg(log, tmp_path / "ok"),
                      tmp_path / "ok", groups=reg)
    bad = FollowRunner("job-bad", _port_fcfg(log, tmp_path / "bad"),
                       tmp_path / "bad", groups=reg)
    assert reg.adopt(ok) and reg.adopt(bad)
    (group,) = reg._groups.values()
    orig = bad._log.record_wake

    def failing(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(bad._log, "record_wake", failing)
    group.wake_once()
    assert _lt(_recs(ok)) == [(1, "hello x")] and _recs(bad) == []
    assert ok.fused and not bad.fused
    monkeypatch.setattr(bad._log, "record_wake", orig)
    assert bad.wake_once() == 1
    assert _lt(_recs(bad)) == [(1, "hello x")]
    ok.close()
    bad.close()


def test_fuse_error_sends_the_members_solo(tmp_path, monkeypatch, _kernels):
    """A union FusedScanner refuses (FuseError) sends every member to its
    solo runner, as the reference does; their streams stay exact."""
    from distributed_grep_tpu_torch.ops import fuse as fuse_mod

    def refuse(*a, **k):
        raise fuse_mod.FuseError("injected: no kernel hosts the union")

    monkeypatch.setattr(fuse_mod, "FusedScanner", refuse)
    log = tmp_path / "app.log"
    log.write_bytes(b"hello x\nvolcano y\n")
    reg = FollowGroupRegistry(start_threads=False, auto_solo=False)
    rs = [FollowRunner(f"job-{i}", _port_fcfg(log, tmp_path / f"w{i}",
                                              pattern=p),
                       tmp_path / f"w{i}", groups=reg)
          for i, p in enumerate(("hello", "volcano"))]
    assert all(reg.adopt(r) for r in rs)
    (group,) = reg._groups.values()
    assert group.wake_once() == 0
    assert reg._groups == {} and not any(r.fused for r in rs)
    for r, want in zip(rs, ([(1, "hello x")], [(2, "volcano y")])):
        assert r.wake_once() == 1 and _lt(_recs(r)) == want
        r.close()


def test_ineligible_configs_stay_solo(tmp_path, _kernels):
    """Count and presence queries, approximate matching, an empty pattern
    and two spellings of one file run solo; a set never joins a pattern's
    group (the family rule)."""
    log = tmp_path / "app.log"
    log.write_bytes(b"hello\n")
    reg = FollowGroupRegistry(start_threads=False, auto_solo=False)
    for i, opts in enumerate(({"count_only": True}, {"presence_only": True},
                              {"max_errors": 1}, {"pattern": ""})):
        r = FollowRunner(f"job-i{i}", _port_fcfg(log, tmp_path / f"i{i}",
                                                 **opts),
                         tmp_path / f"i{i}", groups=reg)
        assert not reg.adopt(r)
        r.close()
    dup = FollowRunner("job-d", _port_fcfg([log, log], tmp_path / "d"),
                       tmp_path / "d", groups=reg)
    assert not reg.adopt(dup)
    dup.close()
    pat = FollowRunner("job-p", _port_fcfg(log, tmp_path / "p"),
                       tmp_path / "p", groups=reg)
    sets = FollowRunner("job-s", _port_fcfg(log, tmp_path / "s",
                                            patterns=["hello", "x"]),
                        tmp_path / "s", groups=reg)
    assert reg.adopt(pat) and reg.adopt(sets)
    assert len(reg._groups) == 2
    pat.close()
    sets.close()


# ------------------------------------------------------------ the service

def _drain(svc, jid, want: int, deadline_s: float = 20.0) -> list[dict]:
    out: list[dict] = []
    cursor = 0
    deadline = time.monotonic() + deadline_s
    while len(out) < want:
        assert time.monotonic() < deadline, (jid, out, svc.job_status(jid))
        page = svc.job_stream(jid, cursor=cursor, timeout=0.5)
        out.extend(page["records"])
        cursor = page["next"]
    return out


def _wait_state(svc, jid, state: str, deadline_s: float = 20.0) -> dict:
    deadline = time.monotonic() + deadline_s
    while True:
        st = svc.job_status(jid)
        if st["state"] == state:
            return st
        assert time.monotonic() < deadline, st
        time.sleep(0.05)


@pytest.fixture
def _svc_env(monkeypatch, _kernels):
    monkeypatch.setenv("DGREP_FOLLOW_POLL_S", "0.05")
    monkeypatch.setenv("DGREP_RESULT_CACHE", "0")
    monkeypatch.setenv("DGREP_PEER_SHUFFLE", "0")


def test_service_streams_equal_the_references_and_status(tmp_path,
                                                         _svc_env):
    """Three standing queries over one file on both daemons: one fused
    group of two patterns and a set in a group of its own; each stream, over HTTP, equals
    the reference daemon's and the one-shot scan; /status shows the group,
    /jobs/<id> the runner, explain the fused route; a batch job's stream
    answers 409; a cancel drains the stream with its state."""
    import urllib.error
    import urllib.request

    from distributed_grep_tpu.runtime.service import GrepService as RefService
    from distributed_grep_tpu_torch.__main__ import _render_top
    from distributed_grep_tpu_torch.runtime.service import (
        GrepService,
        ServiceServer,
    )

    log = tmp_path / "app.log"
    log.write_bytes(b"hello t0x\nvolcano ash\n")
    queries = [{"pattern": "hello"}, {"pattern": "vol(cano)"},
               {"patterns": ["ash", "t0x"]}]
    svc = GrepService(work_root=tmp_path / "svc", spans=True)
    ref = RefService(work_root=tmp_path / "ref")
    server = ServiceServer(svc)
    server.start()
    base = f"http://127.0.0.1:{server.port}"

    def get(path):
        with urllib.request.urlopen(base + path, timeout=10) as r:
            return json.loads(r.read())

    try:
        jids = [svc.submit(_port_fcfg(log, "x", **q)) for q in queries]
        rjids = [ref.submit(_ref_fcfg(log, "x", **q)) for q in queries]
        firsts = [get(f"/jobs/{j}/stream?cursor=0&timeout=5") for j in jids]
        assert [len(p["records"]) for p in firsts] == [1, 1, 2]
        with open(log, "ab") as f:
            f.write(b"hello volcano t0x\nmiss\nash hello\n")
        want = [3, 2, 4]
        got = [_drain(svc, j, n) for j, n in zip(jids, want)]
        rgot = [_drain(ref, j, n) for j, n in zip(rjids, want)]
        assert got == rgot
        data = log.read_bytes()
        for q, recs in zip(queries, got):
            assert _lt(recs) == [(n, t.decode()) for n, t in
                                 _oracle(_port_engine(q), data)]
        st = get("/status")
        # the two patterns share a group; the set has one of its own (a
        # set fuses only with sets)
        assert sorted(sorted(row["jobs"]) for row in st["follow"]["groups"]
                      ) == [sorted(jids[:2]), [jids[2]]]
        assert st["follow"]["standing"] == 3
        assert "group [" in _render_top({"x": st}, "x", {})
        assert get(f"/jobs/{jids[0]}")["follow"]["wakes"] >= 1
        assert svc.job_explain(jids[0])["routing"]["follow"]["route"] in (
            "fused", "mixed")
        plain = tmp_path / "plain.txt"
        plain.write_text("hello\n")
        bj = svc.submit(JobConfig(input_files=[str(plain)],
                                  application=PORT_GREP,
                                  app_options={"pattern": "hello",
                                               "device": "cpu"}))
        with pytest.raises(urllib.error.HTTPError) as ei:
            get(f"/jobs/{bj}/stream?cursor=0&timeout=0")
        assert ei.value.code == 409
        svc.cancel(jids[0])
        page = get(f"/jobs/{jids[0]}/stream?cursor=0&timeout=0")
        assert page["state"] == "cancelled" and len(page["records"]) == 3
        assert "dgrep_follow_standing 2" in svc.metrics_text()
    finally:
        server.shutdown()
        svc.stop()
        ref.stop()


def test_service_follow_validation_and_queued_page(tmp_path, _svc_env):
    from distributed_grep_tpu_torch.runtime.service import GrepService

    log = tmp_path / "v.log"
    log.write_bytes(b"hello\n")
    svc = GrepService(work_root=tmp_path / "svc", max_jobs=1)
    try:
        for bad in ({"word_regexp": True}, {"max_errors": 1}):
            with pytest.raises(ValueError, match="unsupported with follow"):
                svc.submit(_port_fcfg(log, "x", **bad))
        with pytest.raises(ValueError, match="need a pattern"):
            svc.submit(JobConfig(input_files=[str(log)], application=PORT_GREP,
                                 app_options={"device": "cpu"}, follow=True))
        # a missing input is allowed: the cursor waits for it
        first = svc.submit(_port_fcfg(tmp_path / "later.log", "x"))
        queued = svc.submit(_port_fcfg(log, "x"))
        page = svc.job_stream(queued, cursor=0, timeout=0)
        assert page == {"job_id": queued, "state": "queued", "records": [],
                        "next": 0}
        (tmp_path / "later.log").write_bytes(b"hello late\n")
        assert _lt(_drain(svc, first, 1)) == [(1, "hello late")]
        svc.cancel(first)
        assert _lt(_drain(svc, queued, 1)) == [(1, "hello")]
    finally:
        svc.stop()


def test_a_standing_query_without_a_card_fails_naming_it(tmp_path,
                                                         _svc_env):
    """No device option: the runner would run on "cuda" (ROADMAP.md D8);
    with no card the job fails naming the device, nothing scans on the
    host."""
    import torch

    from distributed_grep_tpu_torch.runtime.service import GrepService

    if torch.cuda.is_available():
        pytest.skip("this host has a card: the job would run on it")
    log = tmp_path / "c.log"
    log.write_bytes(b"hello\n")
    cfg = _port_fcfg(log, "x")
    cfg.app_options.pop("device")
    svc = GrepService(work_root=tmp_path / "svc")
    try:
        jid = svc.submit(cfg)
        st = _wait_state(svc, jid, "failed")
        assert "'cuda'" in st["error"]
        assert svc.record(jid).follow is None
    finally:
        svc.stop()


@pytest.mark.parametrize("fused", [False, True], ids=["solo", "fused"])
def test_a_scan_error_fails_the_job_and_is_never_retried(tmp_path, _svc_env,
                                                         monkeypatch, fused):
    """D9: an error of a standing query's scan (here injected into the
    solo engine's suffix scan, or the fused group's union scan) fails the
    job, every member's in a group, closes the stream, and is neither
    retried nor rescanned solo."""
    from distributed_grep_tpu_torch.ops import fuse as fuse_mod
    from distributed_grep_tpu_torch.ops.engine import GrepEngine as PortEngine
    from distributed_grep_tpu_torch.runtime.service import GrepService

    calls = {"solo": 0, "union": 0}
    orig = PortEngine.scan_file_suffix

    def solo_scan(self, *a, **k):
        calls["solo"] += 1
        if not fused:
            raise RuntimeError("injected: the kernel failed to launch")
        return orig(self, *a, **k)

    def union_scan(self, *a, **k):
        calls["union"] += 1
        raise RuntimeError("injected: the union's kernel failed to launch")

    monkeypatch.setattr(PortEngine, "scan_file_suffix", solo_scan)
    monkeypatch.setattr(fuse_mod.FusedScanner, "scan_suffix", union_scan)
    if not fused:  # a lone fusable query would get a group of its own
        monkeypatch.setenv("DGREP_FOLLOW_FUSE", "0")
    log = tmp_path / "e.log"
    log.write_bytes(b"hello volcano\n")
    svc = GrepService(work_root=tmp_path / "svc")
    try:
        pats = ("hello", "volcano") if fused else ("hello",)
        jids = [svc.submit(_port_fcfg(log, "x", pattern=p)) for p in pats]
        for jid in jids:
            st = _wait_state(svc, jid, "failed")
            assert "failed to launch" in st["error"]
            page = svc.job_stream(jid, cursor=0, timeout=1.0)
            assert page["records"] == [] and page["state"] == "failed"
        seen = dict(calls)
        time.sleep(0.3)  # a retry would come within a few polls
        assert calls == seen  # nothing scanned again, solo or fused
        if fused:
            # one union scan a group at most (the first query may have
            # failed alone before the second one joined), no solo scan
            assert calls["solo"] == 0 and 1 <= calls["union"] <= len(jids)
        else:
            assert calls == {"solo": 1, "union": 0}
    finally:
        svc.stop()


def test_daemon_restart_resumes_the_stream(tmp_path, _svc_env, monkeypatch):
    """A daemon that dies with a standing query running (its runner
    stopped, no registry record of an end) resumes it at restart from its
    wake log: the reader goes on from its cursor with no duplicate and no
    lost line."""
    from distributed_grep_tpu_torch.runtime.service import GrepService

    monkeypatch.setenv("DGREP_FOLLOW_FUSE", "0")
    log = tmp_path / "r.log"
    log.write_bytes(b"hello 1\nmiss\n")
    root = tmp_path / "svc"
    svc = GrepService(work_root=root)
    jid = svc.submit(_port_fcfg(log, "x"))
    first = _drain(svc, jid, 1)
    runner = svc.record(jid).follow
    runner.request_stop()  # the crash: the loop ends, nothing is recorded
    runner._thread.join(timeout=5)
    with open(log, "ab") as f:
        f.write(b"hello 2\nhello 3\n")
    svc2 = GrepService(work_root=root)
    try:
        assert svc2.record(jid).state == "running"
        cursor = first[-1]["seq"]
        more: list = []
        deadline = time.monotonic() + 20
        while len(more) < 2:
            assert time.monotonic() < deadline
            page = svc2.job_stream(jid, cursor=cursor, timeout=0.5)
            more.extend(page["records"])
            cursor = page["next"]
        assert _lt(first + more) == [(1, "hello 1"), (3, "hello 2"),
                                     (4, "hello 3")]
        assert [r["seq"] for r in first + more] == [1, 2, 3]
        assert svc2.job_status(jid)["follow"]["resumed"] is True
    finally:
        svc2.stop()


def test_follow_fuse_off_gives_the_same_streams(tmp_path, _svc_env,
                                                monkeypatch):
    from distributed_grep_tpu_torch.runtime.service import GrepService

    log = tmp_path / "o.log"
    log.write_bytes(b"hello t0x\nhello t1x\n")
    pages = []
    for knob in ("0", "1"):
        monkeypatch.setenv("DGREP_FOLLOW_FUSE", knob)
        svc = GrepService(work_root=tmp_path / f"svc{knob}")
        try:
            jids = [svc.submit(_port_fcfg(log, "x", pattern=f"t{k}x"))
                    for k in range(2)]
            pages.append([_lt(_drain(svc, j, 1)) for j in jids])
            fol = svc.status()["follow"]
            if knob == "0":
                assert svc._follow_groups is None and "groups" not in fol
                assert not any(k.startswith("follow_fused") for k in fol)
        finally:
            svc.stop()
    assert pages[0] == pages[1] == [[(1, "hello t0x")], [(2, "hello t1x")]]


def _submit_stream(main, addr, log, extra, capsys):
    rc = main(["submit", "--addr", addr, "--follow", "--stream",
               "--timeout", "3", *extra, str(log)])
    out = capsys.readouterr().out.splitlines()
    return rc, out


def test_submit_follow_stream_prints_the_references_lines(tmp_path,
                                                          _svc_env, capsys):
    """``submit --follow --stream`` against each package's daemon, with
    appends from a thread: the same record lines, and the same summary
    (but its job id); ``--follow`` alone prints the endpoint."""
    from distributed_grep_tpu.__main__ import main as ref_main
    from distributed_grep_tpu.runtime.service import GrepService as RefService
    from distributed_grep_tpu.runtime.service import (
        ServiceServer as RefServer,
    )
    from distributed_grep_tpu_torch.__main__ import main
    from distributed_grep_tpu_torch.runtime.service import (
        GrepService,
        ServiceServer,
    )

    outs = []
    for svc_cls, srv_cls, cli, extra in (
            (GrepService, ServiceServer, main, ["--backend", "cpu"]),
            (RefService, RefServer, ref_main, [])):
        log = tmp_path / f"s{len(outs)}.log"
        log.write_bytes(b"hello first\nmiss\n")
        svc = svc_cls(work_root=tmp_path / f"svc{len(outs)}")
        srv = srv_cls(svc)
        srv.start()
        addr = f"127.0.0.1:{srv.port}"

        def appender(path=log):
            time.sleep(0.5)
            with open(path, "ab") as f:
                f.write(b"hello sec")
            time.sleep(0.3)
            with open(path, "ab") as f:
                f.write(b"ond\nhello caf\xc3\xa9\n")

        t = threading.Thread(target=appender)
        t.start()
        try:
            rc, lines = _submit_stream(cli, addr, log,
                                       [*extra, "-i", "HELLO"], capsys)
            t.join()
            rc_c, lines_c = _submit_stream(cli, addr, log,
                                           [*extra, "-F", "-e", "second",
                                            "-e", "first"], capsys)
            assert cli(["submit", "--addr", addr, "--follow", *extra,
                        "hello", str(log)]) == 0
            following = json.loads(capsys.readouterr().out)
        finally:
            srv.shutdown()
            svc.stop()
        summary = json.loads(lines[-1])
        outs.append((rc, [ln.replace(str(log), "LOG") for ln in lines[:-1]],
                     {k: v for k, v in summary.items() if k != "job_id"},
                     rc_c, [ln.replace(str(log), "LOG")
                            for ln in lines_c[:-1]],
                     {k: v for k, v in following.items()
                      if k not in ("job_id", "stream")}))
    assert outs[0] == outs[1]
    rc, lines, summary = outs[0][:3]
    assert rc == 0 and lines == ["LOG (line number #1) hello first",
                                 "LOG (line number #3) hello second",
                                 "LOG (line number #4) hello café"]
    assert summary == {"state": "running", "records": 3, "cursor": 3}
    assert outs[0][4] == ["LOG (line number #1) hello first",
                          "LOG (line number #3) hello second"]
    assert outs[0][5] == {"state": "following"}
