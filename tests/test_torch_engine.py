"""Port GrepEngine vs the reference engine: identical matched lines.

The port runs on ``device="cpu"`` (the kernels' plain versions) with small
segments and few lanes, so stripe and segment edges are everywhere; the
reference runs its Pallas kernels in interpret mode and its host engines
(``backend="cpu"``).  Also the port's guards: entry points raise without
CUDA unless the CPU is asked for, and the patterns the reference routes to
its host scanners take the same routes (the regex routes are in
tests/test_torch_regex_engine.py, the host routes in
tests/test_torch_host_routes.py).
"""

import re

import numpy as np
import pytest

from distributed_grep_tpu.ops.engine import GrepEngine as RefEngine
from distributed_grep_tpu_torch.ops import engine as port_engine
from distributed_grep_tpu_torch.ops.engine import GrepEngine

SMALL = dict(device="cpu", target_lanes=64, min_chunk=32, segment_bytes=4096)


def _text(seed: int, n_lines: int, vocab: list[bytes], eol=b"\n",
          trailing=True) -> bytes:
    rng = np.random.default_rng(seed)
    lines = [b" ".join(vocab[i] for i in rng.integers(0, len(vocab),
                                                      rng.integers(0, 9)))
             for _ in range(n_lines)]
    return eol.join(lines) + (eol if trailing else b"")


VOCAB = [b"the", b"volcano", b"Volcano", b"VOLCANO", b"hello", b"hallo",
         b"x", b"lava", b"volc", b"ano"]


def _ref_lines(pattern: str, ic: bool, data: bytes) -> list[int]:
    a = RefEngine(pattern, ignore_case=ic, interpret=True).scan(data)
    b = RefEngine(pattern, ignore_case=ic, backend="cpu").scan(data)
    assert a.matched_lines.tolist() == b.matched_lines.tolist()
    return a.matched_lines.tolist()


CASES = {
    "edges": _text(0, 4000, VOCAB),
    "crlf": _text(1, 1500, VOCAB, eol=b"\r\n"),
    "binary": _text(2, 1500, VOCAB + [b"\x00", b"\xff\xfe", b"vol\x00cano"]),
    "no-trailing-newline": _text(3, 1500, VOCAB, trailing=False) + b" volcano",
    "long-lines": _text(4, 40, VOCAB * 30),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("pattern,ic", [
    ("volcano", False), ("Volcano", True), ("h[ae]llo", False),
    ("o ", False), ("[[:upper:]]O", False), ("(volc)", False),
    ("[^a-z ]O", False),
])
def test_engine_lines_equal_reference(case, pattern, ic):
    data = CASES[case]
    eng = GrepEngine(pattern, ignore_case=ic, **SMALL)
    got = eng.scan(data)
    assert got.matched_lines.tolist() == _ref_lines(pattern, ic, data)
    assert got.n_matches == got.matched_lines.size
    assert got.bytes_scanned == len(data)
    assert eng.stats["segments"] == -(-len(data) // SMALL["segment_bytes"])


def test_dense_corpus_takes_the_dense_confirm():
    """> SPAN_CONFIRM_LINE_LIMIT candidate lines in a segment: one exact
    kernel pass resolves the segment instead of per-line confirms."""
    data = _text(5, 30_000, [b"the", b"x", b"tea"])
    eng = GrepEngine("the", device="cpu", target_lanes=256, min_chunk=32,
                     segment_bytes=1 << 16)
    got = eng.scan(data)
    assert eng.stats["dense_confirms"] >= 1
    assert got.matched_lines.tolist() == _ref_lines("the", False, data)


def test_defeat_guard_drops_the_filter_on_mostly_false_candidates():
    """'volcano' filters on v, l, c; a corpus of 'vXlc' words makes the
    filter's candidates mostly false, so the scan drops it."""
    rng = np.random.default_rng(6)
    lines = [b"vxlc %d" % i if rng.random() < 0.97 else b"a volcano"
             for i in range(30_000)]
    data = b"\n".join(lines) + b"\n"
    eng = GrepEngine("volcano", device="cpu", target_lanes=256, min_chunk=32,
                     segment_bytes=1 << 17)
    assert eng._sa_filtered is not None
    got = eng.scan(data)
    assert eng.stats["filter_defeated"] is True
    assert eng.stats["dense_confirms"] >= 1
    assert got.matched_lines.tolist() == _ref_lines("volcano", False, data)


def test_empty_and_tiny_inputs():
    eng = GrepEngine("ab", **SMALL)
    assert eng.scan(b"").matched_lines.size == 0
    assert eng.scan(b"ab").matched_lines.tolist() == [1]
    assert eng.scan(b"\n\nab\n").matched_lines.tolist() == [3]
    assert eng.scan(b"a\nb").matched_lines.tolist() == []


@pytest.mark.parametrize("seed", range(4))
def test_host_lines_matcher_vs_python(seed):
    rng = np.random.default_rng(seed)
    data = bytes(rng.choice(np.frombuffer(b"abc\nABC", np.uint8),
                            size=5000).tolist())
    nl = np.flatnonzero(np.frombuffer(data, np.uint8) == 10)
    starts = np.concatenate(([0], nl + 1))
    ends = np.concatenate((nl, [len(data)]))
    for pattern, ic in [("abc", False), ("ab", True), ("[ab]c", False), ("c", False)]:
        model = port_engine.check_pattern(pattern, ic).shift_and
        got = port_engine.lines_match(model, data, starts, ends)
        rx = re.compile(pattern.encode(), re.I if ic else 0)
        want = [rx.search(data[s:e]) is not None for s, e in zip(starts, ends)]
        assert got.tolist() == want


@pytest.mark.parametrize("make", [
    lambda: GrepEngine("volcano"),
    lambda: GrepEngine("volcano", device="cuda"),
])
def test_engine_raises_without_cuda_unless_cpu_asked(make, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
    assert GrepEngine("volcano", device="cpu").device.type == "cpu"


@pytest.mark.parametrize("pattern", [
    "^$", "x?$", "(ab)*$", "a?$|^b*$", "a\nb", r"(a)\1", r"a\z", r"(a)?\2",
    r"(x|[^\x00-\xff])y", "x{0,600}",
])
def test_out_of_slice_patterns_raise_not_implemented(pattern):
    """Once outside the port (they raised NotImplementedError naming a
    ROADMAP.md item), these patterns now take the reference's host routes,
    "native" where a DFA table exists ('$'-nullable patterns) and "re"
    where none does, with the reference's lines and mode on both
    backends.  Two of them ('a\\z', '(a)?\\2') Python re refuses too: the
    reference refuses them, and the port raises RegexError (the CLI's
    "invalid pattern", exit 2)."""
    for backend in ("device", "cpu"):
        try:
            ref = RefEngine(pattern, backend=backend)
        except re.error:
            with pytest.raises(port_engine.RegexError):
                GrepEngine(pattern, backend=backend, **SMALL)
            continue
        eng = GrepEngine(pattern, backend=backend, **SMALL)
        assert eng.mode == eng.route == ref.mode, backend
        for name, data in CASES.items():
            assert eng.scan(data).matched_lines.tolist() == ref.scan(
                data).matched_lines.tolist(), (backend, name)


def test_malformed_pattern_raises_regex_error():
    with pytest.raises(port_engine.RegexError):
        GrepEngine("h[", device="cpu")
