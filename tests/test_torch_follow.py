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
    path = tmp_path / "c.log"
    path.write_bytes(b"hello\n")
    eng = GrepEngine("hello", device="cpu")
    FollowScanner(eng, [str(path)]).poll_once()
    assert follow_mod.follow_counters() == {"follow_wakes": 1,
                                            "suffix_bytes_scanned": 6}
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
