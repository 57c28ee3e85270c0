"""The port's approximate matching (grep --max-errors K) vs the reference.

Models: the port's ApproxModel equals the reference's field for field, the
compile bounds agree, and ``scan_reference`` / ``dp_oracle_line`` give the
same answers on fuzzed text.  Kernel: the plain PyTorch version of the
Wu-Manber kernel, fed the REFERENCE's model through ``approx_from_arrays``,
gives words bit-identical (tolerance 0: integer words) to the reference
Pallas kernel in interpret mode, reshaped from its tile (chunk//32,
lanes//128, 128) to (chunk//32, lanes), at chunk 512 and lanes 4096; the
reference reads the (chunk, lanes) columns, the port the (lanes, chunk)
stripes of the same bytes (the sub-stripe warm-up is held in
tests/test_torch_substripe.py).  The
host window check equals ``line_matches``.  Engine, job and CLI: the port
on ``device="cpu"`` with small segments (so stripe and segment starts are
everywhere) gives the reference engine's lines, which Sellers' DP
confirms, the reference job's ``mr-out-*`` bytes and the reference CLI's
stdout and exit codes.  The CUDA kernel itself is held against the plain
version on the card in tests/test_torch_cuda.py.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from distributed_grep_tpu.models import approx as ref_ax
from distributed_grep_tpu.ops import pallas_approx
from distributed_grep_tpu.ops.engine import GrepEngine as RefEngine
from distributed_grep_tpu.runtime.job import run_job as ref_run_job
from distributed_grep_tpu.utils.config import JobConfig as RefJobConfig
from distributed_grep_tpu_torch.models import approx as port_ax
from distributed_grep_tpu_torch.ops import approx_scan, host_match, layout
from distributed_grep_tpu_torch.ops.engine import GrepEngine
from distributed_grep_tpu_torch.runtime.job import run_job
from distributed_grep_tpu_torch.utils.config import JobConfig
from tests.test_torch_engine import CASES, SMALL

REPO = Path(__file__).resolve().parents[1]

MODELS = [("volcano", 1, False), ("volcano", 2, False), ("Volcano", 2, True),
          ("h[ae]llo", 3, False), ("[Ss]chwarzen[ae]", 3, False),
          ("a.c", 1, False), ("x" * 32, 3, False), ("café", 2, True)]
BASES = [b"volcano", b"Volcano", b"hallo", b"hello", b"Schwarzena"]


def _fields(m):
    if m is None:
        return None
    return (m.base.b_table.tolist(),
            [list(map(tuple, r)) for r in m.base.sym_ranges], m.k,
            list(m.seeds), int(m.match_bit), m.length)


def _errorful(rng, base: bytes) -> bytes:
    """``base`` after 1..3 random substitutions, insertions or deletions."""
    b = bytearray(base)
    for _ in range(int(rng.integers(1, 4))):
        op, p = int(rng.integers(0, 3)), int(rng.integers(0, len(b)))
        ch = int(rng.integers(97, 123))
        if op == 0:
            b[p] = ch
        elif op == 1:
            b.insert(p, ch)
        elif len(b) > 1:
            del b[p]
    return bytes(b)


def _text(seed: int, n_bytes: int, every: int = 2000) -> np.ndarray:
    """Seeded lowercase text with newlines and an errorful needle per
    ``every`` bytes."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz     \nVOLC", np.uint8)
    text = rng.choice(alpha, size=n_bytes)
    for p in rng.choice(n_bytes - 16, size=max(1, n_bytes // every),
                        replace=False).tolist():
        v = _errorful(rng, BASES[p % len(BASES)])
        text[p : p + len(v)] = np.frombuffer(v, np.uint8)
    return text


# ------------------------------------------------------------------ models
@pytest.mark.parametrize("pattern,k,ic", MODELS + [
    ("abc", 3, False), ("abcdef", 4, False), ("abcdef", 0, False),
    ("a(b|c)d", 1, False), ("x" * 33, 1, False), ("ab$", 1, False)])
def test_models_equal_reference(pattern, k, ic):
    ref = ref_ax.try_compile_approx(pattern, k, ignore_case=ic)
    port = port_ax.try_compile_approx(pattern, k, ignore_case=ic)
    assert _fields(port) == _fields(ref)
    if ref is not None:
        carried = port_ax.approx_from_arrays(ref.base.b_table,
                                             ref.base.sym_ranges, k)
        assert _fields(carried)[:5] == _fields(ref)[:5]


def test_approx_from_arrays_rejects_bad_budgets():
    ref = ref_ax.try_compile_approx("volcano", 1)
    for k in (0, 4, 7):
        with pytest.raises(ValueError):
            port_ax.approx_from_arrays(ref.base.b_table, ref.base.sym_ranges, k)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scan_reference_and_dp_oracle_equal_reference(seed):
    rng = np.random.default_rng(seed)
    data = bytes(rng.choice(np.frombuffer(b"volcanhxeVOLC\n ", np.uint8),
                            size=3000).tolist())
    for pattern, k, ic in MODELS[:5]:
        ref = ref_ax.try_compile_approx(pattern, k, ignore_case=ic)
        port = port_ax.try_compile_approx(pattern, k, ignore_case=ic)
        np.testing.assert_array_equal(port_ax.scan_reference(port, data),
                                      ref_ax.scan_reference(ref, data))
        for line in data.split(b"\n")[:40]:
            assert port_ax.dp_oracle_line(port.base.sym_ranges, line, k) == \
                ref_ax.dp_oracle_line(ref.base.sym_ranges, line, k) == \
                port_ax.line_matches(port, line)


# ------------------------------------------------------------------ kernel
@pytest.mark.parametrize("pattern,k,ic", [
    ("volcano", 1, False), ("volcano", 2, True), ("h[ae]llo", 3, False),
    ("Volcano", 3, True)])
def test_plain_words_equal_pallas_interpret(pattern, k, ic):
    chunk, lanes = 512, 4096
    text = _text(k + 10 * ic, chunk * lanes)
    lay = layout.Layout(lanes=lanes, chunk=chunk, n_real=text.size)
    arr = layout.to_device_array(text.tobytes(), lay)
    arr[0:7, ::5] = np.frombuffer(b"volcxno", np.uint8)[:, None]  # heads
    arr[28:35, 1::7] = np.frombuffer(b"hxllo\nv", np.uint8)[:, None]
    ref = ref_ax.try_compile_approx(pattern, k, ignore_case=ic)
    want = np.asarray(pallas_approx.approx_scan_words(
        arr, ref, interpret=True)).reshape(chunk // 32, lanes)
    model = port_ax.approx_from_arrays(ref.base.b_table, ref.base.sym_ranges,
                                       k)
    got = approx_scan.approx_scan_words(
        torch.from_numpy(np.ascontiguousarray(arr.T)), model)
    assert got.dtype == torch.uint32 and got.shape == (chunk // 32, lanes)
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.count_nonzero(want) > 100


def test_wrapper_refuses_bad_models_and_shapes():
    model = port_ax.try_compile_approx("volcano", 1)
    with pytest.raises(ValueError):
        approx_scan.approx_scan_words(torch.zeros((48, 64), dtype=torch.uint8),
                                      model)
    bad = port_ax.ApproxModel(base=model.base, k=7)
    with pytest.raises(ValueError):
        approx_scan.approx_scan_words(torch.zeros((64, 64), dtype=torch.uint8),
                                      bad)


# --------------------------------------------------------- host windows
@pytest.mark.parametrize("seed", [0, 1])
def test_windows_match_equals_line_matches(seed):
    rng = np.random.default_rng(seed)
    data = _text(seed + 5, 60_000, every=100).tobytes()
    nl = np.flatnonzero(np.frombuffer(data, np.uint8) == 10)
    starts = rng.integers(0, len(data) - 80, size=3000)
    ends = starts + rng.integers(0, 70, size=3000)
    # clip each span to its line, as the stitch does
    nxt = nl[np.minimum(np.searchsorted(nl, starts), nl.size - 1)]
    ends = np.where(nxt >= starts, np.minimum(ends, nxt), ends)
    for pattern, k, ic in MODELS[:5]:
        model = port_ax.try_compile_approx(pattern, k, ignore_case=ic)
        got = host_match.approx_windows_match(model, data, starts, ends)
        want = [port_ax.line_matches(model, data[s:e])
                for s, e in zip(starts.tolist(), ends.tolist())]
        assert got.tolist() == want
        assert 0 < got.sum() < got.size
    with pytest.raises(ValueError, match="cap"):
        host_match.approx_windows_match(
            model, data, [0], [host_match.APPROX_SPAN_CAP + 1])
    assert host_match.approx_windows_match(model, data, [], []).size == 0


# ------------------------------------------------------------------ engine
def _dp_lines(pattern: str, k: int, ic: bool, data: bytes) -> list[int]:
    model = port_ax.try_compile_approx(pattern, k, ignore_case=ic)
    lines = data.split(b"\n")
    if data.endswith(b"\n"):
        lines.pop()
    return [i for i, ln in enumerate(lines, 1)
            if port_ax.dp_oracle_line(model.base.sym_ranges, ln, k)]


def _ref_lines(pattern: str, k: int, ic: bool, data: bytes) -> list[int]:
    return RefEngine(pattern, max_errors=k, ignore_case=ic,
                     backend="cpu").scan(data).matched_lines.tolist()


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("pattern,k,ic", [
    ("volcano", 1, False), ("Volcano", 2, True), ("h[ae]llo", 3, False)])
def test_engine_lines_equal_reference(case, pattern, k, ic):
    data = CASES[case]
    eng = GrepEngine(pattern, max_errors=k, ignore_case=ic, **SMALL)
    assert (eng.mode, eng.route) == ("approx", "approx")
    got = eng.scan(data)
    assert got.matched_lines.tolist() == _ref_lines(pattern, k, ic, data)
    assert got.bytes_scanned == len(data)
    assert eng.stats["segments"] == -(-len(data) // SMALL["segment_bytes"])
    assert eng.stats["stitch_windows"] > 0


@pytest.mark.parametrize("pattern,k,ic,base", [
    ("volcano", 1, False, b"volcano"), ("volcano", 2, True, b"VolCano"),
    ("[Ss]chwarzen[ae]", 3, False, b"Schwarzena")])
def test_errorful_needles_across_stripe_and_segment_starts(pattern, k, ic,
                                                           base):
    """An errorful needle across every stripe start (64-byte stripes) and
    so every segment start: the kernel misses each, and the window stitch
    must add every line back."""
    rng = np.random.default_rng(k)
    data = bytearray(rng.choice(np.frombuffer(b"ghijkmnp     \n", np.uint8),
                                size=40_000).tobytes())
    for b in range(64, len(data) - 16, 64):
        v = _errorful(rng, base)
        at = b - 3
        data[at - 1 : at + len(v) + 1] = b" " + v + b" "
    data = bytes(data)
    eng = GrepEngine(pattern, max_errors=k, ignore_case=ic, **SMALL)
    got = eng.scan(data).matched_lines.tolist()
    assert got == _ref_lines(pattern, k, ic, data) == \
        _dp_lines(pattern, k, ic, data)
    assert eng.stats["stitch_added"] >= 50


def test_all_lines_route_and_refusals():
    eng = GrepEngine("ab", max_errors=2, **SMALL)
    assert (eng.mode, eng.route) == ("all_lines", "all_lines")
    data = b"xx\n\nyy\nzz"
    assert eng.scan(data).matched_lines.tolist() == [1, 2, 3, 4] == \
        _ref_lines("ab", 2, False, data)
    with pytest.raises(ValueError, match="single pattern"):
        GrepEngine(patterns=["volcano"], max_errors=1, device="cpu")
    for k in (4, -1):
        with pytest.raises(ValueError, match="1..3"):
            GrepEngine("volcano", max_errors=k, device="cpu")
    for pattern in ("a(b|c)d", "x" * 33, "vol+cano"):
        with pytest.raises(ValueError, match="literal/class-sequence"):
            GrepEngine(pattern, max_errors=1, device="cpu")


# ------------------------------------------------------------ job and CLI
@pytest.fixture
def corpus(tmp_path):
    rng = np.random.default_rng(12)
    vocab = [b"the", b"volcano", b"Volcano", b"volcxno", b"volano",
             b"vulcan", b"hallo", b"hxllo", b"caf\xc3\xa9", b"\xff\xfe",
             b"(line number #7)"]
    files = []
    for i in range(3):
        lines = [b" ".join(vocab[j] for j in rng.integers(0, len(vocab),
                                                          rng.integers(0, 7)))
                 for _ in range(700)]
        p = tmp_path / f"corpus{i}"
        p.write_bytes(b"\n".join(lines) + (b"\n" if i != 1 else b""))
        files.append(str(p))
    return files


@pytest.mark.parametrize("query", [
    {"pattern": "volcano", "max_errors": 1},
    {"pattern": "VOLCANO", "max_errors": 2, "ignore_case": True},
    {"pattern": "h[ae]llo", "max_errors": 3},
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
    ["--max-errors", "1", "volcano"],
    ["--max-errors", "2", "-i", "-e", "VOLCANO"],
    ["--max-errors", "1", "-F", "hallo"],
    ["--max-errors", "2", "ab"],  # no longer than K: every line
    ["--max-errors", "1", "zzzzzzq"],  # no line: exit 1
    ["--max-errors", "4", "volcano"],  # refusals: exit 2
    ["--max-errors", "1", "vol(cano|can)"],
    ["--max-errors", "1", "-e", "volcano", "-e", "hallo"],
    ["--max-errors", "1", "-f", "pats.txt"],
])
def test_cli_identical_to_reference_cli(tmp_path, corpus, flags):
    (tmp_path / "pats.txt").write_bytes(b"volcano\nhallo\n")
    names = [Path(p).name for p in corpus]
    ref = _cli("distributed_grep_tpu", ["grep", *flags, *names,
                                        "--backend", "cpu"], tmp_path)
    port = _cli("distributed_grep_tpu_torch", ["grep", *flags, *names,
                                               "--device", "cpu"], tmp_path)
    assert port.returncode == ref.returncode, (port.stderr, ref.stderr)
    assert port.stdout == ref.stdout
    if ref.returncode == 2:
        assert port.stderr.splitlines()[-1] == ref.stderr.splitlines()[-1]
    else:
        assert ref.returncode in (0, 1), ref.stderr
