"""The host routes against the reference, on the CPU: the engine's modes
"native" (the DFA scanner over a pattern's table or a set's Aho-Corasick
banks, memmem for a literal) and "re" (the per-line re loop), on both
backends (``backend="device"`` routes there only what the reference
routes there; ``backend="cpu"`` routes every plan there).

Held to the reference, byte for byte: matched lines over texts with an
empty line at offset 0, CRLF, NUL and 0xFF and no trailing newline;
``scan_file`` with chunk edges on empty lines; the ``mr-out-*`` files of a
job with ``n_reduce`` 3; the CLI's stdout and exit code under -v -w -x -c
-l -o; the Aho-Corasick tables and ``reference_scan``'s offsets.  Also:
the host scan's pieces and progress calls, its counters, and that the
host backend makes no CUDA call.
"""

import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from distributed_grep_tpu.__main__ import main as ref_main
from distributed_grep_tpu.models import aho as ref_aho
from distributed_grep_tpu.models import dfa as ref_dfa
from distributed_grep_tpu.ops import lines as ref_lines
from distributed_grep_tpu.ops.engine import GrepEngine as RefEngine
from distributed_grep_tpu.runtime.job import run_job as ref_run_job
from distributed_grep_tpu.utils.config import JobConfig as RefJobConfig
from distributed_grep_tpu_torch.__main__ import main as port_main
from distributed_grep_tpu_torch.models import aho as port_aho
from distributed_grep_tpu_torch.models import dfa as port_dfa
from distributed_grep_tpu_torch.ops import engine as engine_mod
from distributed_grep_tpu_torch.ops import lines as port_lines
from distributed_grep_tpu_torch.ops.engine import GrepEngine
from distributed_grep_tpu_torch.runtime.job import run_job
from distributed_grep_tpu_torch.utils.config import JobConfig
from tests.test_torch_job import ENGINE_OPTS, _outputs
from tests.test_torch_sets_models import rand_literals

SMALL = dict(device="cpu", target_lanes=64, min_chunk=32, segment_bytes=4096)

# (pattern, route on backend="device"): the patterns the reference sends
# to its host scanners
HOST_PATTERNS = [
    ("^$", "native"), ("^ *$", "native"), ("x?$", "native"),
    ("(ab)*$", "native"), ("o?$", "native"), ("a{1,3}$|^$", "native"),
    ("b*$", "native"), ("$", "native"), ("a|^$", "native"),
    (r"(a)\1", "re"), (r"(the) \1", "re"), ("a{1,3}+", "re"),
    ("(?=a)b", "re"), ("a\nb", "re"), (r"(x|[^\x00-\xff])y", "re"),
]
# sets too dense for both set kernels (the reference: native)
DENSE_SETS = [[" ", "e"], [" ", "xy"], [" ", "ab"],
              rand_literals(3000, 2, 2, seed=31, alphabet=np.arange(32, 127))]
# what backend="cpu" also routes to the host: kernel patterns, a set, a
# regex that denotes a set, approx
CPU_ONLY = [("volcano", {}), ("Volcano", {"ignore_case": True}),
            ("h[ae]llo", {}), ("(volcano|the)", {}), ("^the ", {}),
            ("volcano$", {}), (r"\bthe\b", {}), ("x[ab]{2,40}y", {}),
            ("volcano", {"max_errors": 1})]

VOCAB = [b"the", b"volcano", b"Volcano", b"ab", b"abab", b"x", b"o", b" ",
         b"  ", b"aa", b"the the", b"hello", b"\x00", b"\xff\xfe", b"a\tb",
         b"caf\xc3\xa9", b"xaby", b"y"]


def _text(seed: int, n_lines: int, eol: bytes = b"\n",
          trailing: bool = True) -> bytes:
    """Seeded lines of 0-4 vocabulary words: many empty lines, one at
    offset 0."""
    rng = np.random.default_rng(seed)
    lines = [b""] + [b" ".join(VOCAB[j] for j in rng.integers(
        0, len(VOCAB), rng.integers(0, 5))) for _ in range(n_lines - 1)]
    out = eol.join(lines)
    return out + eol if trailing else out


TEXTS = {
    "lf": _text(0, 600),
    "crlf": _text(1, 400, eol=b"\r\n"),
    "no-trailing-newline": _text(2, 400, trailing=False),
    "empty-last-line-open": _text(3, 300) + b"tail",
    "only-newlines": b"\n\n\n",
    "one-newline": b"\n",
    "empty": b"",
    "no-newline": b"x",
}


def _ref_lines(backend: str, data: bytes, pattern=None, patterns=None,
               **kw) -> list[int]:
    eng = RefEngine(pattern, patterns=patterns, backend=backend, **kw)
    return eng.scan(data).matched_lines.tolist()


@pytest.mark.parametrize("backend", ["device", "cpu"])
@pytest.mark.parametrize("pattern,route", HOST_PATTERNS)
def test_host_pattern_lines_equal_reference(pattern, route, backend):
    eng = GrepEngine(pattern, backend=backend, **SMALL)
    assert (eng.mode, eng.route) == (route, route)
    assert RefEngine(pattern, backend=backend).mode == route
    for name, data in TEXTS.items():
        got = eng.scan(data)
        assert got.matched_lines.tolist() == _ref_lines(
            backend, data, pattern), name
        assert got.n_matches == got.matched_lines.size
        assert got.bytes_scanned == len(data)


@pytest.mark.parametrize("backend", ["device", "cpu"])
@pytest.mark.parametrize("pats", DENSE_SETS, ids=lambda p: f"{len(p)} members")
def test_dense_sets_run_native_with_reference_lines(pats, backend):
    eng = GrepEngine(patterns=pats, backend=backend, **SMALL)
    assert (eng.mode, eng.route) == ("native", "native")
    for name, data in TEXTS.items():
        assert eng.scan(data).matched_lines.tolist() == _ref_lines(
            backend, data, patterns=pats), name


@pytest.mark.parametrize("pattern,kw", CPU_ONLY, ids=str)
def test_cpu_backend_runs_every_plan_on_the_host(pattern, kw):
    eng = GrepEngine(pattern, backend="cpu", **kw, **SMALL)
    assert eng.mode == RefEngine(pattern, backend="cpu", **kw).mode
    assert eng.mode in ("native", "re")
    for name, data in TEXTS.items():
        assert eng.scan(data).matched_lines.tolist() == _ref_lines(
            "cpu", data, pattern, **kw), name
    # the line matcher of the stitch and the confirm answers on the host
    # routes too: each line alone, as a one-line document
    data = TEXTS["lf"]
    nl = port_lines.newline_index(data)
    starts = np.concatenate(([0], nl + 1))[:-1]
    verdicts = eng.host_line_matcher(data, starts, nl)
    want = [bool(eng.scan(data[s:e] + b"\n").matched_lines.size)
            for s, e in zip(starts.tolist(), nl.tolist())]
    assert verdicts.tolist() == want


def test_cpu_backend_set_and_literal_routes():
    data = TEXTS["lf"]
    eng = GrepEngine(patterns=["volcano", "ab", "x"], backend="cpu", **SMALL)
    assert eng.mode == "native" and len(eng.tables) == 1
    assert eng.scan(data).matched_lines.tolist() == _ref_lines(
        "cpu", data, patterns=["volcano", "ab", "x"])
    lit = GrepEngine("volcano", backend="cpu", **SMALL)
    assert lit.literal() == b"volcano" and lit.mode == "native"
    lit.scan(data)
    assert lit.stats["end_offsets"] == data.count(b"volcano")


def test_host_scan_runs_in_pieces_with_one_progress_each(monkeypatch):
    """With a progress callback the host scan cuts the data at newlines
    into pieces of about HOST_CHUNK bytes, one call a piece, a line longer
    than a piece kept whole; the lines equal one whole scan's."""
    monkeypatch.setattr(engine_mod, "HOST_CHUNK", 64)
    data = TEXTS["lf"] + b"y" * 300 + b"\n" + TEXTS["no-trailing-newline"]
    for pattern in ("^$", "x?$", r"(the) \1"):
        eng = GrepEngine(pattern, **SMALL)
        calls = []
        got = eng.scan(data, progress=lambda: calls.append(1))
        assert got.matched_lines.tolist() == _ref_lines("device", data,
                                                        pattern)
        assert len(calls) > 10
        assert np.array_equal(got.nl_index if got.nl_index is not None
                              else port_lines.newline_index(data),
                              port_lines.newline_index(data))
        st = eng.stats
        assert st["host_scan_seconds"] > 0
        assert ("end_offsets" in st) == (eng.mode == "native")
        assert eng.totals["host_scan_seconds"] >= st["host_scan_seconds"]


@pytest.mark.parametrize("chunk", [7, 64, 333])
@pytest.mark.parametrize("pattern", ["^$", "^ *$", "x?$", r"(a)\1"])
def test_scan_file_chunk_edges_on_empty_lines(tmp_path, monkeypatch, chunk,
                                              pattern):
    """Chunks cut after a newline start with an empty line, or end a file
    without one: the nullable-at-'$' fix-up holds at every edge."""
    monkeypatch.setattr(engine_mod, "FILE_CHUNK_BYTES", chunk)
    for name in ("lf", "crlf", "no-trailing-newline", "only-newlines"):
        data = b"\n" + TEXTS[name]  # the first chunk starts with '\n'
        path = tmp_path / f"{name}.txt"
        path.write_bytes(data)
        for backend in ("device", "cpu"):
            eng = GrepEngine(pattern, backend=backend, **SMALL)
            got = eng.scan_file(path, chunk_bytes=chunk)
            want = _ref_lines(backend, data, pattern)
            assert got.matched_lines.tolist() == want, (name, backend)
            emitted = []
            eng.scan_file(path, emit=lambda ln, b: emitted.append(ln))
            assert emitted == want


def test_empty_line_numbers_equal_reference():
    for data in [*TEXTS.values(), b"\n\na\n\n", b"a\n\n\nb"]:
        nl = port_lines.newline_index(data)
        assert port_lines.empty_line_numbers(data).tolist() == (
            ref_lines.empty_line_numbers(data).tolist())
        assert port_lines.empty_line_numbers(data, nl).tolist() == (
            ref_lines.empty_line_numbers(data).tolist())


@pytest.mark.parametrize("n_reduce", [3])
@pytest.mark.parametrize("opts", [
    {"pattern": "^$"}, {"pattern": "^$", "invert": True},
    {"pattern": r"(the) \1", "count_only": True},
    {"patterns": [" ", "xy"]}, {"pattern": "o?$", "word_regexp": True},
    {"pattern": "^ *$", "line_regexp": True},
], ids=str)
def test_mr_out_byte_identical_to_reference(tmp_path, opts, n_reduce):
    files = []
    for name in ("lf", "crlf", "no-trailing-newline"):
        p = tmp_path / f"{name}.txt"
        p.write_bytes(TEXTS[name])
        files.append(str(p))
    ref = ref_run_job(RefJobConfig(
        input_files=files, application="distributed_grep_tpu.apps.grep_tpu",
        app_options={**opts, "backend": "cpu"}, n_reduce=n_reduce,
        work_dir=str(tmp_path / "ref")), n_workers=2)
    want = _outputs(ref.output_files)
    assert sum(len(v) for v in want.values()) > 0
    for backend in ("device", "cpu"):
        port = run_job(JobConfig(
            input_files=files,
            app_options={**opts, **ENGINE_OPTS, "backend": backend},
            n_reduce=n_reduce, work_dir=str(tmp_path / f"port-{backend}")),
            n_workers=2, device="cpu")
        assert _outputs(port.output_files) == want, backend


@pytest.fixture
def files(tmp_path):
    out = []
    for name in ("lf", "crlf", "no-trailing-newline"):
        p = tmp_path / f"{name}.txt"
        p.write_bytes(TEXTS[name])
        out.append(str(p))
    return out


@pytest.mark.parametrize("flags", [
    ["^$"], ["-v", "^$"], ["-c", "^ *$"], ["-l", "x?$"], ["-L", "(ab)*$"],
    ["-w", "o?$"], ["-x", "^ *$"], ["-o", "(ab)*$"], ["-E", r"(the) \1"],
    ["-o", "-E", r"(the) \1"], ["-c", "-v", "-E", r"(a)\1"],
    ["-F", "-e", " ", "-e", "xy"], ["-c", "-F", "-e", " ", "-e", "xy"],
    ["-w", "-F", "-e", " ", "-e", "xy"], ["-q", "^$"],
], ids=str)
def test_cli_identical_to_reference_cli(capsysbinary, files, flags):
    ref_rc = ref_main(["grep", *flags, *files, "--backend", "cpu"])
    ref = capsysbinary.readouterr()
    for backend in ("device", "cpu"):
        rc = port_main(["grep", *flags, *files, "--device", "cpu",
                        "--backend", backend])
        got = capsysbinary.readouterr()
        assert rc == ref_rc, (backend, got.err)
        assert got.out == ref.out, backend


def test_cli_metrics_show_the_host_scan(capsysbinary, files):
    import json

    assert port_main(["grep", "^$", *files, "--device", "cpu",
                      "--metrics"]) == 0
    err = capsysbinary.readouterr().err.decode()
    metrics = json.loads(err[err.index("{"):])
    assert metrics["engine"]["host_scan_seconds"] > 0
    assert metrics["engine"]["end_offsets"] >= 0
    assert set(metrics["launches"].values()) == {0}


@pytest.mark.parametrize("pats,ic", [
    (["he", "she", "his", "hers"], False), (["Ab", "aB", "x", "Q"], True),
    ([b"\xff\xfe", b"a\x00", b"\x00"], False),
    (["needle", "nee", "edle", "dle"], False),
])
def test_aho_tables_equal_reference(pats, ic):
    r = ref_aho.compile_aho_corasick(pats, ic)
    p = port_aho.compile_aho_corasick(pats, ic)
    for field in ("trans", "byte_to_cls", "accept", "accept_eol"):
        assert np.array_equal(getattr(p, field), getattr(r, field)), field
        assert getattr(p, field).dtype == getattr(r, field).dtype, field
    assert p.start == r.start


def test_aho_banks_equal_reference():
    rng = np.random.default_rng(3)
    pats = [bytes(rng.integers(97, 101, size=int(rng.integers(2, 9))))
            for _ in range(400)]
    r = ref_aho.compile_aho_corasick_banks(pats, max_states_per_bank=300)
    p = port_aho.compile_aho_corasick_banks(pats, max_states_per_bank=300)
    assert len(p) == len(r) > 1
    for a, b in zip(p, r):
        assert np.array_equal(a.trans, b.trans)
        assert np.array_equal(a.accept, b.accept)
    for bad in ([], [""], ["a\nb"]):
        with pytest.raises(port_dfa.RegexError):
            port_aho.compile_aho_corasick(bad)


@pytest.mark.parametrize("pattern", ["^$", "x?$", "(ab)*$", "a$", "ab",
                                     "^a", "$^", "(a|^)b$", "a{1,3}$|^$"])
def test_reference_scan_offsets_equal_reference(pattern, monkeypatch):
    t = port_dfa.compile_dfa(pattern)
    r = ref_dfa.compile_dfa(pattern)
    for data in TEXTS.values():
        assert port_dfa.reference_scan(t, data).tolist() == (
            ref_dfa.reference_scan(r, data).tolist())
    # the multithreaded scanner past the threshold gives the same offsets
    from distributed_grep_tpu_torch.utils import native

    monkeypatch.setattr(native, "MT_THRESHOLD_BYTES", 16)
    data = TEXTS["lf"] * 3
    assert port_dfa.reference_scan(t, data).tolist() == (
        ref_dfa.reference_scan(r, data).tolist())


def test_cpu_backend_makes_no_cuda_call(tmp_path, capsysbinary, monkeypatch):
    """backend="cpu" never asks for the card: with every CUDA entry the
    port could reach replaced by one that raises, engines, scan_file, a
    job and the CLI run on the default device="cuda"."""
    def no_cuda(*a, **k):
        raise AssertionError("a CUDA call on the host backend")

    for name in ("is_available", "current_device", "device_count",
                 "synchronize", "Stream", "Event", "current_stream",
                 "set_device", "device", "get_device_name"):
        monkeypatch.setattr(torch.cuda, name, no_cuda)
    monkeypatch.setattr(torch.Tensor, "cuda", no_cuda)
    monkeypatch.setattr(torch.Tensor, "to", no_cuda)
    data = TEXTS["lf"]
    path = tmp_path / "a.txt"
    path.write_bytes(data)
    for pattern, kw in [("^$", {}), ("volcano", {}), ("h[ae]llo", {}),
                        (r"(a)\1", {}), ("volcano", {"max_errors": 1})]:
        eng = GrepEngine(pattern, backend="cpu", **kw)
        assert eng.scan(data).matched_lines.tolist() == _ref_lines(
            "cpu", data, pattern, **kw)
        eng.scan_file(path)
    eng = GrepEngine(patterns=["the", "x"], backend="cpu")
    eng.scan(data)
    res = run_job(JobConfig(input_files=[str(path)],
                            app_options={"pattern": "^ *$",
                                         "backend": "cpu"},
                            n_reduce=3, work_dir=str(tmp_path / "job")),
                  n_workers=2)
    assert sum(1 for _ in res.iter_results()) == len(
        _ref_lines("cpu", data, "^ *$"))
    assert port_main(["grep", "-c", "^$", str(path), "--backend",
                      "cpu"]) == 0
    assert capsysbinary.readouterr().out.strip() == str(
        len(_ref_lines("cpu", data, "^$"))).encode()


def test_demotions_are_logged_at_warning(caplog):
    with caplog.at_level("WARNING", logger="distributed_grep_tpu_torch.engine"):
        GrepEngine("^$", **SMALL)
        GrepEngine(r"(a)\1", **SMALL)
        GrepEngine(patterns=[" ", "xy"], **SMALL)
    text = caplog.text
    assert "'^$'" in text and "nullable at '$'" in text
    assert r"'(a)\\1'" in text and "host re loop" in text
    assert "outside the FDR filter" in text


def test_unparsable_patterns_still_raise():
    for pattern in ("h[", "(a", r"(a)?\2"):
        for backend in ("device", "cpu"):
            with pytest.raises(port_dfa.RegexError):
                GrepEngine(pattern, backend=backend, **SMALL)
    with pytest.raises(ValueError):
        GrepEngine(patterns=[], backend="cpu", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        GrepEngine("x", backend="tpu", device="cpu")


def test_oracle_agrees_on_the_re_routes():
    """Where re reads the pattern as GNU grep does, the re loop's lines
    are re.search over each line."""
    data = TEXTS["lf"]
    lines = data.split(b"\n")[:-1]
    for pattern in (r"(a)\1", r"(the) \1"):
        rx = re.compile(pattern.encode())
        want = [i for i, ln in enumerate(lines, 1) if rx.search(ln)]
        assert GrepEngine(pattern, **SMALL).scan(
            data).matched_lines.tolist() == want


GNU_GREP = shutil.which("grep")


@pytest.mark.skipif(GNU_GREP is None, reason="no system grep")
@pytest.mark.parametrize("flags", [
    ["^$"], ["^ *$"], ["x?$"], ["(ab)*$"], ["o?$"], ["a{1,3}$|^$"],
    ["b*$"], ["$"], ["a|^$"], ["^(ab)*$"], [r"(a)\1"], [r"(the) \1"],
    ["a{1,3}+"], ["-w", r"(the) \1"], ["-x", "^ *$"], ["-v", "^$"],
    ["-F", "-e", " ", "-e", "xy"], ["-c", "^ *$"],
], ids=str)
def test_cli_lines_equal_gnu_grep(capsysbinary, tmp_path, flags):
    """Where GNU grep reads the pattern as Python re does (it reads a
    '\\n' in a pattern as a separator of patterns, and refuses '(?='), the
    port's selected lines or count equal ``LC_ALL=C grep -na``'s."""
    for name in ("lf", "crlf", "no-trailing-newline"):
        path = tmp_path / f"{name}.txt"
        path.write_bytes(TEXTS[name])
        gnu_flags = flags if "-F" in flags else ["-E", *flags]
        gnu = subprocess.run([GNU_GREP, "-na", *gnu_flags, str(path)],
                             capture_output=True,
                             env={**os.environ, "LC_ALL": "C"})
        assert gnu.returncode in (0, 1), gnu.stderr
        rc = port_main(["grep", *flags, str(path), "--device", "cpu"])
        out = capsysbinary.readouterr().out
        assert rc == gnu.returncode, name
        if "-c" in flags:
            assert out == gnu.stdout, name
            continue
        got = [int(m) for m in re.findall(rb"\(line number #(\d+)\) ",
                                          out)]
        want = [int(ln.split(b":", 1)[0])
                for ln in gnu.stdout.split(b"\n") if ln]
        assert got == want, name
