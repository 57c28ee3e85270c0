"""The port's literal-set path vs the reference: identical matched lines,
job output and CLI stdout.

The port runs on ``device="cpu"`` (the kernels' plain versions) with small
segments and few lanes, so stripe and segment edges are everywhere; the
reference runs its host engines (``backend="cpu"``).  Covered: FDR sets,
-i, a mixed set whose 1-byte members ride the pairset sidecar, a pure
pairset set, BASELINE config 2 through literal decomposition, members
planted across every stripe and segment start (the stitch), the sets
too dense for both kernels on the host scanner (mode "native"),
``run_job`` output, and the CLI's -e, -f, -F and -E.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from distributed_grep_tpu.ops.engine import GrepEngine as RefEngine
from distributed_grep_tpu.runtime.job import run_job as ref_run_job
from distributed_grep_tpu.utils.config import JobConfig as RefJobConfig
from distributed_grep_tpu_torch.ops.engine import GrepEngine, check_patterns
from distributed_grep_tpu_torch.runtime.job import run_job
from distributed_grep_tpu_torch.utils.config import JobConfig
from tests.test_torch_engine import CASES, SMALL
from tests.test_torch_sets_models import CONFIG2_WORDS, rand_literals

REPO = Path(__file__).resolve().parents[1]
CONFIG2 = "(" + "|".join(CONFIG2_WORDS) + ")"
LITS = rand_literals(200, 3, 11, seed=41)
SETS = {
    "fdr": (LITS + ["volcano", "hallo"], False, "fdr"),
    "fdr -i": ([p.upper() for p in LITS[:60]] + ["VolCano", "ano"], True,
               "fdr"),
    "sidecar": (LITS[:80] + ["#", "\x00", "~"], False, "fdr"),
    "pairset": (["ab", "zq", "x", "Vo", b"\xff\xfe"], False, "pairset"),
    "pairset -i": (["LA", "he", "oL"], True, "pairset"),
    "binary members": ([b"vol\x00cano", b"\xff\xfe", b"e\x00c"], False, "fdr"),
}


def _ref_lines(pats, ic: bool, data: bytes) -> list[int]:
    return RefEngine(patterns=pats, ignore_case=ic, backend="cpu").scan(
        data).matched_lines.tolist()


def _oracle(pats, ic: bool, data: bytes) -> list[int]:
    members = [p.encode("utf-8", "surrogateescape") if isinstance(p, str)
               else p for p in pats]
    lines = data.split(b"\n")
    if data.endswith(b"\n"):
        lines.pop()
    if ic:
        lines = [ln.lower() for ln in lines]
        members = [m.lower() for m in members]
    return [i for i, ln in enumerate(lines, 1) if any(m in ln for m in members)]


def _planted(data: bytes, members: list[bytes], seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    arr = np.frombuffer(data, np.uint8).copy()
    for i, p in enumerate(rng.choice(arr.size - 16, size=arr.size // 700,
                                     replace=False).tolist()):
        m = members[i % len(members)]
        arr[p : p + len(m)] = np.frombuffer(m, np.uint8)
    return arr.tobytes()


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("name", sorted(SETS))
def test_set_lines_equal_reference(case, name):
    pats, ic, mode = SETS[name]
    members = [p.encode("utf-8", "surrogateescape") if isinstance(p, str)
               else p for p in pats]
    data = _planted(CASES[case], members, len(name))
    eng = GrepEngine(patterns=pats, ignore_case=ic, **SMALL)
    assert (eng.mode, eng.route) == (mode, mode)
    assert (eng.fdr_pairset is not None) == (name == "sidecar")
    got = eng.scan(data)
    assert got.matched_lines.tolist() == _ref_lines(pats, ic, data) == \
        _oracle(pats, ic, data)
    assert got.bytes_scanned == len(data)
    assert eng.stats["segments"] == -(-len(data) // SMALL["segment_bytes"])
    assert eng.stats["stitch_offsets"] > 0


@pytest.mark.parametrize("name", ["fdr", "sidecar", "pairset", "pairset -i"])
def test_members_across_every_stripe_and_segment_start(name):
    """A member planted across every stripe start (64-byte stripes) and
    every segment start: the kernels' seeds miss those, and the stitch
    must add every one of their lines back."""
    pats, ic, _ = SETS[name]
    long = [p if isinstance(p, bytes) else p.encode("latin-1")
            for p in pats if len(p) >= 2]
    rng = np.random.default_rng(3)
    data = bytearray(rng.choice(np.frombuffer(b"ghijkmnp     \n", np.uint8),
                                size=40_000).tobytes())
    for k, b in enumerate(range(64, len(data) - 16, 64)):
        m = long[k % len(long)]
        at = b - 1 if len(m) == 2 else b - len(m) // 2
        data[at : at + len(m)] = m
    data = bytes(data)
    eng = GrepEngine(patterns=pats, ignore_case=ic, **SMALL)
    got = eng.scan(data).matched_lines.tolist()
    assert got == _oracle(pats, ic, data) == _ref_lines(pats, ic, data)
    assert eng.stats["stitch_added"] >= 50


def test_fdr_candidates_are_confirmed_against_the_whole_document():
    """Long members whose window lies after a segment start but whose
    head lies before it: the confirm reads back across the segment."""
    member = b"abcdefghijklmnopq"
    data = bytearray(b"x" * 20_000)
    for s in range(4096, len(data), 4096):
        data[s - 10 : s - 10 + len(member)] = member
    data = bytes(data)
    eng = GrepEngine(patterns=[member, b"zzz"], **SMALL)
    assert eng.fdr.window < 10
    got = eng.scan(data).matched_lines.tolist()
    assert got == [1] == _ref_lines([member, b"zzz"], False, data)
    assert eng.stats["candidates"] >= 4


def test_config2_routes_through_literal_decomposition():
    data = _planted(CASES["edges"], [w.encode() for w in CONFIG2_WORDS], 2)
    eng = GrepEngine(CONFIG2, **SMALL)
    assert (eng.mode, eng.route, eng.pattern) == ("fdr", "fdr_literal_set",
                                                  CONFIG2)
    assert [(b.m, b.checks) for b in eng.fdr.banks] == [
        (2, ((1, 0, 128), (0, 0, 128)))]
    got = eng.scan(data).matched_lines.tolist()
    assert got == RefEngine(CONFIG2, backend="cpu").scan(
        data).matched_lines.tolist()
    assert got
    short = GrepEngine("(ab|cd|x[yz])", ignore_case=True, **SMALL)
    assert (short.mode, short.route) == ("pairset", "fdr_literal_set")
    # 1-byte members are outside compile_fdr: the regex keeps the NFA
    assert GrepEngine("(a|bc)", **SMALL).route == "nfa"


def test_empty_member_matches_every_line_and_bad_sets_raise():
    eng = GrepEngine(patterns=["volcano", ""], **SMALL)
    assert eng.mode == "all_lines"
    assert eng.scan(b"x\n\nvolcano\n").matched_lines.tolist() == [1, 2, 3]
    with pytest.raises(ValueError):
        GrepEngine(patterns=[], device="cpu")
    with pytest.raises(ValueError):
        GrepEngine("x", patterns=["x"], device="cpu")
    with pytest.raises(ValueError):
        GrepEngine(device="cpu")


@pytest.mark.parametrize("pats", [
    [" ", "e"],  # dense 1-byte members: no FDR, over the pairset ceiling
    LITS[:40] + [" "],  # a mixed set whose 1-byte member is dense
    [" ", "ab"],  # dense short set whose FDR refuses the dense sidecar
    rand_literals(3000, 2, 2, seed=31, alphabet=np.arange(32, 127)),
])
def test_sets_outside_both_kernels_raise_naming_item_11(pats):
    """Once outside the port (they raised naming ROADMAP item 11), these
    sets now run on the host scanner over their Aho-Corasick banks (mode
    "native"), as the reference routes them: the reference's lines."""
    plan = check_patterns(pats)
    assert (plan.mode, plan.route) == ("native", "native")
    eng = GrepEngine(patterns=pats, **SMALL)
    assert eng.mode == "native" and len(eng.tables) >= 1
    for name, data in CASES.items():
        got = eng.scan(data).matched_lines.tolist()
        assert got == _ref_lines(pats, False, data), name
        assert got == RefEngine(patterns=pats, backend="device").scan(
            data).matched_lines.tolist(), name
        assert got == _oracle(pats, False, data), name
    assert eng.stats["end_offsets"] >= 0


# ------------------------------------------------------------- job and CLI
@pytest.fixture
def corpus(tmp_path):
    rng = np.random.default_rng(9)
    vocab = [b"the", b"volcano", b"Volcano", b"quantum", b"x", b"#",
             b"caf\xc3\xa9", b"\xff\xfe", b"needle", b"zq", b"HALLO",
             b"(line number #7)"] + [p.encode() for p in LITS[:20]]
    files = []
    for i in range(3):
        lines = [b" ".join(vocab[j] for j in rng.integers(0, len(vocab),
                                                          rng.integers(0, 8)))
                 for _ in range(900)]
        p = tmp_path / f"corpus{i}"  # names re.escape leaves alone
        p.write_bytes(b"\n".join(lines) + (b"\n" if i != 1 else b""))
        files.append(str(p))
    return files


@pytest.mark.parametrize("query", [
    {"patterns": LITS[:50] + ["volcano"]},
    {"patterns": ["VOLCANO", "zq", "#"], "ignore_case": True},
    {"pattern": CONFIG2},
])
def test_mr_out_files_byte_identical_to_reference(tmp_path, corpus, query):
    ref = ref_run_job(RefJobConfig(
        input_files=corpus, application="distributed_grep_tpu.apps.grep_tpu",
        app_options={**query, "backend": "cpu"},
        work_dir=str(tmp_path / "ref")), n_workers=2)
    port = run_job(JobConfig(
        input_files=corpus,
        app_options={**query, "target_lanes": 64, "min_chunk": 32,
                     "segment_bytes": 4096},
        work_dir=str(tmp_path / "port")), n_workers=2, device="cpu")
    out = {Path(p).name: Path(p).read_bytes() for p in port.output_files}
    assert out == {Path(p).name: Path(p).read_bytes() for p in ref.output_files}
    assert sum(len(v) for v in out.values()) > 0


def _cli(module, args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu", DGREP_LOG="WARNING",
               PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, "-m", module, *args],
                          capture_output=True, env=env, cwd=cwd, timeout=300)


@pytest.mark.parametrize("flags", [
    ["-F", "-f", "pats.txt"],
    ["-e", "volcano", "-e", "zq", "-e", "qua[nm]tum"],
    ["-F", "-i", "volcano\nHallo\n#"],
    ["-E", "-f", "pats.txt"],
])
def test_cli_stdout_identical_to_reference_cli(tmp_path, corpus, flags):
    (tmp_path / "pats.txt").write_bytes(
        "\n".join(LITS[:30] + ["needle", "café"]).encode() + b"\n")
    names = [Path(p).name for p in corpus]
    ref = _cli("distributed_grep_tpu", ["grep", *flags, *names,
                                        "--backend", "cpu"], tmp_path)
    port = _cli("distributed_grep_tpu_torch", ["grep", *flags, *names,
                                               "--device", "cpu"], tmp_path)
    assert ref.returncode == 0, ref.stderr
    assert port.returncode == 0, port.stderr
    assert port.stdout == ref.stdout and port.stdout


def test_cli_pattern_rules(tmp_path, corpus, capsys):
    from distributed_grep_tpu_torch.__main__ import main

    pats = tmp_path / "p.txt"
    pats.write_bytes(b"volcano\n\n")
    dotted = tmp_path / "a.b.txt"  # a first file GNU grep -F -f reads as is
    dotted.write_bytes(b"no\nvolcano here\n")
    assert main(["grep", "-F", "-f", str(pats), str(dotted),
                 "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2  # the empty member matches every line
    assert main(["grep", "-E", "-F", "x", corpus[0], "--device", "cpu"]) == 2
    assert "conflicting" in capsys.readouterr().err
    assert main(["grep", "-e", "(a)\\1", "-e", "b", corpus[0],
                 "--device", "cpu"]) == 2
    assert "backreferences" in capsys.readouterr().err
    assert main(["grep", "-e", "x", "-f", str(pats), corpus[0],
                 "--device", "cpu"]) == 2
    assert main(["grep", "-f", str(tmp_path / "missing"), corpus[0],
                 "--device", "cpu"]) == 2
    assert main(["grep", "-F", "zzzq.*", corpus[0], "--device", "cpu"]) == 1
