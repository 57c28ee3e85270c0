"""The port's regex path vs the reference: identical matched lines, job
output and CLI stdout.

The port runs on ``device="cpu"`` (the kernels' plain versions) with small
segments and few lanes, so stripe and segment edges are everywhere; the
reference runs its host engines (``backend="cpu"``) and, for one case per
pattern, its Pallas kernels in interpret mode.  Every route of
``ops/engine.check_pattern`` is covered: exact and relaxed NFA models, '^'
at stripe heads, the DFA-confirmed '$' and prefix filters, the
re-confirmed filters, nullable patterns, the dense confirm on the exact
kernel and the defeat guard; and the host routes, "native" (patterns
nullable at '$') and "re" (syntax only Python re knows), on both
backends.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from distributed_grep_tpu.ops.engine import GrepEngine as RefEngine
from distributed_grep_tpu.runtime.job import run_job as ref_run_job
from distributed_grep_tpu.utils.config import JobConfig as RefJobConfig
from distributed_grep_tpu_torch.ops import engine as port_engine
from distributed_grep_tpu_torch.ops import nfa_scan
from distributed_grep_tpu_torch.ops.engine import GrepEngine
from distributed_grep_tpu_torch.runtime.job import run_job
from distributed_grep_tpu_torch.utils.config import JobConfig
from tests.test_torch_engine import CASES, SMALL

REPO = Path(__file__).resolve().parents[1]
CONFIG2 = ("(volcano|anarchism|philosophy|needle|wikipedia|quantum|zeppelin"
           "|obsidian)")
CONFIG4 = r"get /[a-z0-9/.-]{4,24}\.gif"

# (pattern, -i, route): every route over the vocabulary of CASES
PATTERNS = [
    # a finite literal set: decomposed onto the set kernels (the id dates
    # from before literal decomposition, when the NFA kernel ran it)
    pytest.param("(volcano|hallo)", False, "fdr_literal_set",
                 id="(volcano|hallo)-False-nfa"),
    ("vol(cano)?", True, "nfa"),
    ("h[ae]l+o", False, "nfa"),
    ("^(the|x) ", False, "nfa"),
    ("^volc", True, "nfa"),
    ("l[a-z]{1,3}a", False, "nfa"),
    ("volcano$", False, "dfa_filter"),
    ("(^x|the) ", False, "dfa_filter"),
    (r"\bvolc", False, "re_filter"),
    (r"\bano\b", True, "re_filter"),
    ("x*", False, "all_lines"),
]


def _ref_cpu(pattern: str, ic: bool, data: bytes) -> list[int]:
    return RefEngine(pattern, ignore_case=ic, backend="cpu").scan(
        data).matched_lines.tolist()


def _oracle(pattern: str, ic: bool, data: bytes) -> list[int]:
    lines = data.split(b"\n")
    if data.endswith(b"\n"):
        lines.pop()
    rx = re.compile(pattern.encode(), re.I if ic else 0)
    return [i for i, ln in enumerate(lines, 1) if rx.search(ln)]


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("pattern,ic,route", PATTERNS)
def test_regex_lines_equal_reference(case, pattern, ic, route):
    data = CASES[case]
    eng = GrepEngine(pattern, ignore_case=ic, **SMALL)
    assert eng.route == route
    got = eng.scan(data)
    assert got.matched_lines.tolist() == _ref_cpu(pattern, ic, data)
    assert got.n_matches == got.matched_lines.size
    assert got.bytes_scanned == len(data)


@pytest.mark.parametrize("pattern,ic,route", [
    p for p in PATTERNS
    if p[0] in ("vol(cano)?", "^(the|x) ", "volcano$", r"\bano\b")])
def test_regex_lines_equal_reference_interpret_kernels(pattern, ic, route):
    data = CASES["crlf"]
    want = RefEngine(pattern, ignore_case=ic, interpret=True).scan(data)
    got = GrepEngine(pattern, ignore_case=ic, **SMALL).scan(data)
    assert got.matched_lines.tolist() == want.matched_lines.tolist()


def test_anchor_at_stripe_heads_replaced_by_host_verdict():
    """'^volcano' where stripes start mid-line on 'volcano': the kernel
    sees line starts there, and the stitch removes those lines."""
    lines = [b"x" * 13 + b" volcano" + b"y" * 43 for _ in range(400)]
    lines += [b"volcano at the start"]
    data = b"\n".join(lines) + b"\n"
    # 64-byte lines of 32-byte stripes: every other stripe starts on 'v'
    eng = GrepEngine("^volcano", device="cpu", target_lanes=1024,
                     min_chunk=32, segment_bytes=1 << 15)
    assert eng.layout_kwargs()["lane_multiple"] == 32
    got = eng.scan(data)
    assert got.matched_lines.tolist() == [401] == _oracle("^volcano", False, data)
    assert eng.stats["stitch_removed"] > 0


def test_repeat_past_expansion_cap_is_rescued_with_re():
    pattern = "q[ab]{10,900}z"
    data = b"".join([b"q" + b"ab" * 30 + b"z hit\n",
                     b"q" + b"a" * 950 + b"z over-bound\n",
                     b"qabz too short\n", CASES["edges"][:20000], b"\n"] * 3)
    eng = GrepEngine(pattern, **SMALL)
    assert (eng.mode, eng.route, eng.table) == ("nfa", "re_filter", None)
    assert eng._nfa_filter and eng.glushkov_exact is None
    want = _oracle(pattern, False, data)
    assert want and eng.scan(data).matched_lines.tolist() == want
    assert want == _ref_cpu(pattern, False, data)


def test_long_literal_runs_its_prefix_filter():
    lit = bytes(range(65, 91)) * 8  # 208 bytes: past the 128 positions
    data = b"".join([b"pre " + lit + b" hit\n", lit[:60] + b" prefix only\n",
                     CASES["long-lines"]] * 4)
    eng = GrepEngine(lit.decode(), **SMALL)
    assert (eng.route, eng.glushkov.n_pos) == ("dfa_filter", 32)
    got = eng.scan(data).matched_lines.tolist()
    assert got == _oracle(lit.decode(), False, data) == _ref_cpu(
        lit.decode(), False, data)
    assert len(got) == 4


def _log_lines(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    paths = [b"/images/logo", b"/shuttle/missions", b"/cgi-bin/query",
             b"/images/KSC-small.gif", b"/history/apollo", b"/icons/menu.gif"]
    return b"".join(
        b'host%d - - [01/Jul/1995:00:00:%02d -0400] "GET %s HTTP/1.0" %d %d\n'
        % (rng.integers(0, 100), rng.integers(0, 60),
           paths[rng.integers(0, 6)], rng.integers(200, 505),
           rng.integers(0, 100000))
        for _ in range(n))


def test_dense_segments_confirm_on_the_exact_kernel(monkeypatch):
    """Config 4 on access logs: a third of the lines match, so every
    segment has more than SPAN_CONFIRM_LINE_LIMIT candidate lines and the
    exact 2-word model runs over it (on the CPU: its plain version)."""
    data = _log_lines(26_000, 4)
    eng = GrepEngine(CONFIG4, ignore_case=True, device="cpu",
                     target_lanes=1024, min_chunk=32, segment_bytes=1 << 20)
    assert eng._nfa_filter and eng.glushkov.n_words == 1
    assert eng.glushkov_exact.n_words == 2
    runs = []
    real = nfa_scan.nfa_scan_words
    monkeypatch.setattr(nfa_scan, "nfa_scan_words",
                        lambda a, m: runs.append(m) or real(a, m))
    got = eng.scan(data).matched_lines.tolist()
    assert got == _oracle(CONFIG4, True, data) == _ref_cpu(CONFIG4, True, data)
    assert eng.stats["dense_confirms"] >= 2  # each full segment
    assert sum(m is eng.glushkov_exact for m in runs) == \
        eng.stats["dense_confirms"]
    assert not eng.stats["nfa_filter_defeated"]  # the candidates were true


def test_defeat_guard_swaps_in_the_exact_model():
    """Every line a candidate of the relaxed x[ab]{2,}y, none a match of
    x[ab]{2,40}y: after a dense segment the scan runs the exact model."""
    bad = b"x" + b"a" * 45 + b"y"
    lines = [bad] * 16_000
    lines[12_000] = b"x" + b"ab" * 5 + b"y real match"
    data = b"\n".join(lines) + b"\n"
    eng = GrepEngine("x[ab]{2,40}y", device="cpu", target_lanes=256,
                     min_chunk=32, segment_bytes=1 << 18)
    assert eng._nfa_filter and eng.glushkov_exact.n_words == 2
    got = eng.scan(data)
    assert got.matched_lines.tolist() == [12_001]
    assert eng.stats["nfa_filter_defeated"] is True
    assert eng.stats["dense_confirms"] >= 1
    assert eng.stats["candidates"] > port_engine.SPAN_CONFIRM_LINE_LIMIT
    # the next scan starts with the filter again (the swap is scan-local)
    good = b"\n".join([b"no match here"] * 50 + [b"xababy hit"]) + b"\n"
    assert eng.scan(good).matched_lines.tolist() == [51]
    assert eng.stats["nfa_filter_defeated"] is False


def test_boundary_lines_and_stitch_equal_reference():
    from distributed_grep_tpu.ops import lines as ref_lines
    from distributed_grep_tpu_torch.ops import lines as port_lines

    data = CASES["long-lines"] + CASES["crlf"][:3000]
    nl = port_lines.newline_index(data)
    bounds = np.array([-5, 0, 1, 17, 90, 91, 500, 2047, 3000, len(data),
                       len(data) + 9])
    sus = port_lines.boundary_lines(bounds, nl, len(data))
    assert sus.tolist() == sorted(ref_lines.boundary_lines(bounds, nl, len(data)))
    rx = re.compile(rb"vol(cano)?$")
    device = {1, 2, 5, 9, 30, 31}
    want = ref_lines.stitch_lines(device, data, nl, bounds,
                                  lambda ln: rx.search(ln) is not None)
    ls, le = port_lines.line_spans(sus, nl, len(data))
    verdicts = [rx.search(data[a:b]) is not None for a, b in zip(ls, le)]
    got = port_lines.stitch_lines(np.array(sorted(device)), sus, verdicts)
    assert got.tolist() == sorted(want)


def test_nullable_pattern_matches_every_line_without_a_scan():
    eng = GrepEngine("a*", **SMALL)
    assert eng.mode == "all_lines"
    assert eng.scan(b"x\n\nyy\n").matched_lines.tolist() == [1, 2, 3]
    assert eng.scan(b"x\nyy").matched_lines.tolist() == [1, 2]
    assert eng.scan(b"").matched_lines.tolist() == []
    assert eng.stats["segments"] == 0


@pytest.mark.parametrize("pattern", ["^$", "x?$", "(ab)*$", r"(a)\1", "a\nb",
                                     "a{1,3}+", "(?=a)b"])
def test_outside_the_slice_raises_naming_item_11(pattern):
    """Once outside the port (they raised naming ROADMAP item 11), these
    patterns now take the reference's host routes: "native" for the
    patterns nullable at '$', "re" for the rest; their lines equal the
    reference's on both backends, and the CPU oracle's where re reads the
    pattern as grep does."""
    route = "native" if pattern.endswith("$") else "re"
    for backend in ("device", "cpu"):
        eng = GrepEngine(pattern, backend=backend, **SMALL)
        assert (eng.mode, eng.route) == (route, route), backend
        for name, data in CASES.items():
            got = eng.scan(data).matched_lines.tolist()
            ref = RefEngine(pattern, backend=backend).scan(data)
            assert got == ref.matched_lines.tolist(), (backend, name)
            if pattern != "a\nb":  # re's '\n' never matches within a line
                assert got == _oracle(pattern, False, data), (backend, name)
    assert eng.stats["host_scan_seconds"] >= 0


_ATOMS = ["a", "b", "ab", "[ab]", "[^a\n]", ".", "x", "(a|bx)", "(^a|b)",
          "a$", "\\w", "[[:digit:]]", "1", "(ab)?", "b{2,5}", "a{1,3}",
          "[a-c]{3,}"]
_ZERO_WIDTH = ["^", "$", "\\b", "\\B"]
_REPEATS = ["", "", "", "*", "+", "?", "{1,2}", "{0,3}", "{2,}"]


@pytest.mark.parametrize("seed", range(4))
def test_random_regexes_equal_reference(seed):
    """Random patterns over every route, the host routes included,
    against the reference's host engine."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"aabbbx1 \n\nc", np.uint8)
    data = rng.choice(alpha, size=12_000).tobytes()
    routes = set()
    for _ in range(60):
        parts = []
        for _ in range(rng.integers(1, 5)):
            if rng.random() < 0.2:
                parts.append(_ZERO_WIDTH[rng.integers(0, 4)])
            else:
                parts.append(_ATOMS[rng.integers(0, len(_ATOMS))]
                             + _REPEATS[rng.integers(0, len(_REPEATS))])
        pattern = "".join(parts)
        if rng.random() < 0.2:
            pattern += "|" + _ATOMS[rng.integers(0, len(_ATOMS))]
        ic = bool(rng.random() < 0.3)
        try:
            eng = GrepEngine(pattern, ignore_case=ic, **SMALL)
        except port_engine.RegexError:  # malformed: the reference agrees
            with pytest.raises((ValueError, re.error)):
                RefEngine(pattern, ignore_case=ic, backend="cpu")
            continue
        routes.add(eng.route)
        got = eng.scan(data).matched_lines.tolist()
        assert got == _ref_cpu(pattern, ic, data), (pattern, ic, eng.route)
    assert {"nfa", "dfa_filter", "re_filter"} <= routes


# ------------------------------------------------------------- job and CLI
@pytest.fixture
def corpus(tmp_path):
    rng = np.random.default_rng(7)
    vocab = [b"the", b"volcano", b"Volcano", b"quantum", b"x",
             b"caf\xc3\xa9", b"\xff\xfe", b'"GET /images/KSC-small.gif',
             b'"get /icons/menu.GIF', b"GET /images/logo", b"(line number #7)"]
    files = []
    for i in range(3):
        lines = [b" ".join(vocab[j] for j in rng.integers(0, len(vocab),
                                                          rng.integers(0, 8)))
                 for _ in range(900)]
        p = tmp_path / f"f{i}.txt"
        p.write_bytes(b"\n".join(lines) + (b"\n" if i != 1 else b""))
        files.append(str(p))
    return files


@pytest.mark.parametrize("pattern,ic", [(CONFIG2, False), (CONFIG4, True)])
def test_mr_out_files_byte_identical_to_reference(tmp_path, corpus, pattern, ic):
    ref = ref_run_job(RefJobConfig(
        input_files=corpus, application="distributed_grep_tpu.apps.grep_tpu",
        app_options={"pattern": pattern, "ignore_case": ic, "backend": "cpu"},
        work_dir=str(tmp_path / "ref")), n_workers=2)
    port = run_job(JobConfig(
        input_files=corpus,
        app_options={"pattern": pattern, "ignore_case": ic,
                     "target_lanes": 64, "min_chunk": 32,
                     "segment_bytes": 4096},
        work_dir=str(tmp_path / "port")), n_workers=2, device="cpu")
    out = {Path(p).name: Path(p).read_bytes() for p in port.output_files}
    assert out == {Path(p).name: Path(p).read_bytes() for p in ref.output_files}
    assert sum(len(v) for v in out.values()) > 0


def _cli(module, args):
    env = dict(os.environ, JAX_PLATFORMS="cpu", DGREP_LOG="WARNING",
               PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, "-m", module, *args],
                          capture_output=True, env=env, cwd=REPO, timeout=300)


@pytest.mark.parametrize("flags", [[CONFIG2], ["-i", CONFIG4]])
def test_cli_stdout_identical_to_reference_cli(corpus, flags):
    ref = _cli("distributed_grep_tpu", ["grep", *flags, *corpus,
                                        "--backend", "cpu"])
    port = _cli("distributed_grep_tpu_torch", ["grep", *flags, *corpus,
                                               "--device", "cpu"])
    assert ref.returncode == 0, ref.stderr
    assert port.returncode == 0, port.stderr
    assert port.stdout == ref.stdout and port.stdout


def test_cli_exits_2_naming_item_11_outside_the_slice(corpus):
    """'^$' once exited 2 naming ROADMAP item 11; it now runs on the host
    DFA scanner and prints the reference CLI's bytes, on both backends."""
    ref = _cli("distributed_grep_tpu", ["grep", "^$", *corpus,
                                        "--backend", "cpu"])
    assert ref.returncode == 0, ref.stderr
    assert ref.stdout.count(b"\n") > 0
    for backend in ("device", "cpu"):
        port = _cli("distributed_grep_tpu_torch",
                    ["grep", "^$", *corpus, "--device", "cpu",
                     "--backend", backend])
        assert port.returncode == 0, port.stderr
        assert port.stdout == ref.stdout, backend
