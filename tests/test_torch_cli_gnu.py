"""The port CLI's display options against GNU grep (LC_ALL=C) over seeded
random files: both outputs parsed into tuples with the parsers of
tests/test_fuzz_cli.py."""

import re

import numpy as np
import pytest

from distributed_grep_tpu_torch.__main__ import main as port_main
from tests.test_fuzz_cli import (
    GNU_GREP,
    WORDS,
    _make_files,
    _parse_gnu,
    _parse_ours,
    _run_gnu,
)

pytestmark = pytest.mark.skipif(GNU_GREP is None, reason="no system grep")


def _run_port(argv, capsysbinary):
    rc = port_main(["grep", *argv, "--device", "cpu"])
    out = capsysbinary.readouterr().out.decode("utf-8", "replace")
    return rc, [ln for ln in out.split("\n") if ln]


@pytest.mark.parametrize("seed", range(4))
def test_only_matching_equals_gnu(seed, tmp_path, capsysbinary):
    rng = np.random.default_rng(21000 + seed)
    paths = _make_files(rng, tmp_path)
    pattern = ["foo", "fox", "o", "foofoo"][seed]
    for ours_f, gnu_f in ((["-o"], ["-o", "-n"]),
                          (["-o", "-i"], ["-o", "-n", "-i"]),
                          (["-o", "-w"], ["-o", "-n", "-w"]),
                          (["-o", "-m", "2"], ["-o", "-n", "-m", "2"])):
        rc, out = _run_port([*ours_f, pattern, *paths], capsysbinary)
        grc, gout = _run_gnu([*gnu_f, pattern, *paths])
        assert _parse_ours(out) == _parse_gnu(gout, paths, 2), (seed, ours_f)
        assert rc == grc


@pytest.mark.parametrize("seed", range(4))
def test_byte_offsets_equal_gnu(seed, tmp_path, capsysbinary):
    rng = np.random.default_rng(22000 + seed)
    paths = _make_files(rng, tmp_path)
    pattern = WORDS[int(rng.integers(0, len(WORDS)))]
    rc, out = _run_port(["-b", pattern, *paths], capsysbinary)
    grc, gout = _run_gnu(["-b", "-n", pattern, *paths])
    assert _parse_ours(out, with_boff=True) == _parse_gnu(gout, paths, 3)
    assert rc == grc
    rc, out = _run_port(["-o", "-b", pattern, *paths], capsysbinary)
    grc, gout = _run_gnu(["-o", "-b", "-n", pattern, *paths])
    assert _parse_ours(out, with_boff=True) == _parse_gnu(gout, paths, 3)
    assert rc == grc


CTX_OURS = re.compile(r"^(?P<path>.*) \(line number #(?P<ln>\d+)\)(?P<c>-?)"
                      r"( \(byte #(?P<b>\d+)\)-?)? (?P<text>.*)$")
CTX_GNU = re.compile(r"^(?P<ln>\d+)(?P<c>[:-])((?P<b>\d+)[:-])?(?P<text>.*)$")


def _ctx(lines, rx, paths):
    out = []
    for ln in lines:
        if ln == "--":
            out.append("--")
            continue
        path = None
        if rx is CTX_GNU:  # strip the known path and its separator
            path = next(p for p in paths if ln.startswith(p))
            ln = ln[len(path) + 1:]
        m = rx.match(ln)
        assert m, ln
        out.append((path or m.group("path"), int(m.group("ln")),
                    m.group("c") == "-", m.group("b"), m.group("text")))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_context_equals_gnu(seed, tmp_path, capsysbinary):
    """-A/-B/-C with the group separators, across several files, with
    -m and -b: GNU grep's lines, context marks and separators."""
    rng = np.random.default_rng(23000 + seed)
    paths = _make_files(rng, tmp_path, n_files=3)
    pattern = WORDS[int(rng.integers(0, len(WORDS)))]
    for flags in (["-A", "1"], ["-B", "2"], ["-C", "1"], ["-C", "1", "-m", "2"],
                  ["-C", "2", "-b"], ["-A", "1", "-v"]):
        rc, out = _run_port([*flags, pattern, *paths], capsysbinary)
        grc, gout = _run_gnu(["-n", *flags, pattern, *paths])
        assert _ctx(out, CTX_OURS, paths) == _ctx(gout, CTX_GNU, paths), (
            seed, flags, pattern)
        assert rc == grc
