"""The port's host library (csrc/dgrep.cpp through utils/native.py) vs the
reference's native library and the port's own plain versions: each of the
sixteen entry points bit for bit, the two legs that decline their input,
the build's failures, and the port paths that call the library."""

import ctypes
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from distributed_grep_tpu.runtime import columnar as ref_col
from distributed_grep_tpu.utils import native as ref
from distributed_grep_tpu_torch.models.dfa import compile_dfa
from distributed_grep_tpu_torch.ops import _build, host_match
from distributed_grep_tpu_torch.ops import lines as lines_mod
from distributed_grep_tpu_torch.ops.confirm_set import (
    ConfirmSet,
    ConfirmSetNumpy,
)
from distributed_grep_tpu_torch.runtime import columnar
from distributed_grep_tpu_torch.runtime.job import JobResult
from distributed_grep_tpu_torch.utils import native

REPO = Path(__file__).resolve().parents[1]
NAMES = ["/d/f.txt", "café/文.log", "bad\udcff name", "", "x (line number #3)"]
# bytes a corpus draws from: NUL, 0xFF, CR, '\n', UTF-8 and broken UTF-8
PIECES = [b"the", b"volcano", b"Volcano", b"\x00", b"\xff", b"\r", b"\n",
          b"\n\n", b"caf\xc3\xa9", b"\xe2\x82\xac", b"\xf0\x9f\x98\x80",
          b"\xc3", b"\xed\xa0\x80", b"\xc0\xaf", b" ", b"ab", b"_x9"]


@pytest.fixture(scope="module", autouse=True)
def _reference_library():
    assert ref.native_available(), "the reference's native library"
    lib = ref._try_load()
    lib.dgrep_utf8_valid.restype = ctypes.c_int
    lib.dgrep_utf8_valid.argtypes = [ctypes.c_char_p, ctypes.c_size_t]


def corpus(seed: int, n_pieces: int, trailing: bool = True) -> bytes:
    rng = np.random.default_rng(seed)
    data = b"".join(PIECES[i] for i in rng.integers(0, len(PIECES), n_pieces))
    return data.rstrip(b"\n") + (b"\n" if trailing and data else b"")


CORPORA = [b"", b"\n", b"abc", b"\n\nx\r\n\x00\xff", corpus(1, 3000),
           corpus(2, 3000, trailing=False), corpus(3, 40000)]


def test_the_library_holds_and_binds_sixteen_entry_points():
    src = (_build.CSRC / "dgrep.cpp").read_text()
    # definitions at column 0 that are not static
    exported = sorted(set(re.findall(
        r"^(?!static)\w[\w ]*?\**\s*(dgrep_\w+)\(", src, re.M)))
    assert len(native.ENTRY_POINTS) == 16
    assert exported == sorted("dgrep_" + n for n in native.ENTRY_POINTS)
    lib = native.lib()
    for name in native.ENTRY_POINTS:
        assert getattr(lib, "dgrep_" + name).argtypes is not None
    # its own build: under the package's _build/, nothing of native/
    assert Path(lib._name).parent == _build.BUILD_DIR
    assert Path(lib._name).name.startswith("libdgrep-")


@pytest.mark.parametrize("key", ["", "a", "bad\udcff name (line number #3)",
                                 b"\x00\xff\r\n", "café (line number #10)"])
def test_fnv32a(key):
    assert native.fnv32a(key) == native.fnv32a_py(key) == ref.fnv32a(key)
    for n_reduce in (1, 3, 10):
        assert native.partition(key, n_reduce) == ref.partition(key, n_reduce)


@pytest.mark.parametrize("i", range(len(CORPORA)))
def test_newline_index(i):
    data = CORPORA[i]
    got = lines_mod.newline_index(data)
    assert got.dtype == np.int64
    assert got.tolist() == lines_mod.newline_index_numpy(data).tolist() \
        == ref.newline_index(data).tolist()
    # any bytes-like buffer
    assert native.newline_index(np.frombuffer(data, np.uint8)).tolist() \
        == got.tolist()
    assert native.newline_index(memoryview(data)).tolist() == got.tolist()


@pytest.mark.parametrize("needle", [b"a", b"aa", b"the", b"\xff", b"\r\n",
                                    b"volcano", b"caf\xc3\xa9 volcano",
                                    b"x" * 20, b"\n"])
def test_literal_scan(needle):
    for data in CORPORA + [b"aaaa" * 100, needle, needle[:-1]]:
        got = native.literal_scan(data, needle)
        assert got.tolist() == native.literal_scan_py(data, needle).tolist() \
            == ref.literal_scan(data, needle).tolist()
    assert native.literal_scan(b"abc", b"").size == 0


DFA_PATTERNS = ["the", "a[bc]+d", "(vol|caf)", "volcano$", "(x|e)$", "^the",
                "^ab$", "[^a-z]{2}", "\xff", "x?$", "^$"]


@pytest.mark.parametrize("pattern", DFA_PATTERNS)
def test_dfa_scan(pattern):
    t = compile_dfa(pattern)
    full = t.full_table()
    for data in CORPORA:
        for accept in (t.accept, t.accept_eol):
            for start in {t.start, t.n_states - 1}:
                got = native.dfa_scan(data, full, accept, start)
                py = native.dfa_scan_py(data, full, accept, start)
                want = ref.dfa_scan(data, full, accept, start)
                assert got[0].tolist() == py[0].tolist() \
                    == want[0].tolist()
                assert got[1] == py[1] == want[1]


@pytest.mark.parametrize("pattern", DFA_PATTERNS)
@pytest.mark.parametrize("threads", [1, 3, 8])
def test_dfa_scan_mt_equals_the_sequential_walk(pattern, threads):
    t = compile_dfa(pattern)
    full = t.full_table()
    data = CORPORA[-1] * 2  # > 8 x 4096 bytes: every thread gets a piece
    for accept in (t.accept, t.accept_eol):
        got = native.dfa_scan_mt(data, full, accept, t.start, threads)
        assert got.tolist() == native.dfa_scan(data, full, accept,
                                                t.start)[0].tolist() \
            == ref.dfa_scan_mt(data, full, accept, t.start,
                               threads).tolist()


def test_dfa_scan_refuses_a_table_of_another_shape():
    t = compile_dfa("the")
    with pytest.raises(ValueError):
        native.dfa_scan(b"x", t.trans, t.accept, t.start)
    with pytest.raises(ValueError):
        native.dfa_scan_mt(b"x", t.full_table(), t.accept, t.n_states)


def _members(seed: int, n: int, ic: bool) -> list[bytes]:
    rng = np.random.default_rng(seed)
    text = corpus(seed, 2000)
    out = []
    for _ in range(n):
        length = int(rng.integers(1, 21))
        at = int(rng.integers(0, len(text) - length))
        m = text[at : at + length].replace(b"\n", b"q")
        out.append(m.upper() if ic and rng.random() < 0.5 else m)
    return out


@pytest.mark.parametrize("ic", [False, True], ids=["case", "-i"])
@pytest.mark.parametrize("n", [1, 7, 300])
def test_confirm_equals_reference_and_numpy(ic, n):
    members = _members(n, n, ic)
    data = corpus(9, 30000)
    rng = np.random.default_rng(n)
    ends = np.concatenate([np.arange(0, 40), rng.integers(0, len(data) + 3,
                                                         size=9000),
                           np.arange(len(data) - 30, len(data) + 3)])
    ends.sort()
    got = ConfirmSet(members, ignore_case=ic).confirm(data, ends)
    plain = ConfirmSetNumpy(members, ignore_case=ic).confirm(data, ends)
    norm = [m.lower() if ic else m for m in members]
    want = ref.ConfirmSet(norm, ignore_case=ic).confirm(
        data, ends.astype(np.uint64), n_threads=native.THREADS)
    assert got.dtype == bool
    assert got.tolist() == plain.tolist() == want.tolist()
    assert got.any()
    nl = lines_mod.newline_index(data)
    starts, line_ends = columnar.line_spans(np.arange(1, nl.size + 1), nl,
                                            len(data))
    assert ConfirmSet(members, ic).lines_match(data, starts, line_ends) \
        .tolist() == ConfirmSetNumpy(members, ic).lines_match(
            data, starts, line_ends).tolist()


def test_confirm_set_frees_its_handle(monkeypatch):
    freed = []
    cs = ConfirmSet([b"volcano", b"ab"])
    handle = cs._handle
    real = cs._free
    cs._free = lambda h: (freed.append(h), real(h))
    del cs
    assert freed == [handle]


def test_gather_ranges():
    rng = np.random.default_rng(2)
    arr = rng.integers(0, 256, size=5000, dtype=np.uint8)
    for n in (0, 1, 2, 50, 400):
        starts = rng.integers(0, 5000, size=n)
        lens = rng.integers(0, 40, size=n) * (rng.random(n) < 0.7)
        ends = np.minimum(starts + lens, 5000)
        got = columnar.gather_ranges(arr, starts, ends)
        plain = columnar.gather_ranges_numpy(arr, starts, ends)
        assert got[0] == plain[0]
        assert got[1].tolist() == plain[1].tolist()
        total = int(got[1][-1])
        if total:
            assert native.gather_ranges(arr, starts, ends, total) == got[0] \
                == ref.gather_ranges_native(arr, starts.astype(np.int64),
                                            ends.astype(np.int64), got[1],
                                            total)


UTF8 = [b"", b"plain", "café €😀".encode(), b"\xc3", b"\xc3\x28", b"\xc0\xaf",
        b"\xc1\xbf", b"\xe0\x80\xaf", b"\xed\xa0\x80", b"\xed\x9f\xbf",
        b"\xf4\x90\x80\x80", b"\xf4\x8f\xbf\xbf", b"\xf5\x80\x80\x80",
        b"\x80", b"\xff", b"a\x00b", b"\xf0\x9f\x98"]


@pytest.mark.parametrize("data", UTF8)
def test_utf8_valid(data):
    lib = ref._try_load()
    assert native.utf8_valid(data) == native.utf8_valid_py(data) \
        == bool(lib.dgrep_utf8_valid(data, len(data)))


def _batch(mod, name: str, data: bytes, lines):
    nl = lines_mod.newline_index(data)
    return mod.make_batch_from_lines(name, np.asarray(lines, np.int64),
                                     np.frombuffer(data, np.uint8), nl,
                                     len(data))


@pytest.mark.parametrize("name", NAMES)
def test_format_batch(name):
    data = corpus(5, 4000)
    nl = lines_mod.newline_index(data)
    all_lines = np.arange(1, nl.size + 1)
    for lines in (all_lines, all_lines[::7], all_lines[:1]):
        b = _batch(columnar, name, data, lines)
        rb = _batch(ref_col, name, data, lines)
        got = b.format_lines_bytes()
        assert got == b.format_lines_bytes_numpy() == rb.format_lines_bytes()
        prefix = (name + " (line number #").encode("utf-8", "surrogateescape")
        valid = all(native.utf8_valid(b.line_bytes(i)) for i in range(len(b)))
        out = native.format_batch(prefix, b.linenos, b.offsets, b.slab)
        assert (out is not None) == valid
        assert out == ref.format_batch(prefix, b.linenos, b.offsets, b.slab)
        if valid:
            assert out == got
    assert native.format_batch(b"p", np.array([1]), np.array([0, 1]),
                               b"x", sep=b"::") is None
    assert native.format_batch(b"p", np.zeros(0, np.int64),
                               np.zeros(1, np.int64), b"") == b""


@pytest.mark.parametrize("leg", ["utf8", "not utf8"])
def test_format_lines_bytes_takes_python_only_for_non_utf8(monkeypatch, leg):
    """The one data-dependent leg of the reduce format: a batch holding a
    line that is not strict UTF-8 decodes it utf-8/replace in Python."""
    data = (b"caf\xc3\xa9 ok\n" if leg == "utf8" else b"caf\xc3 bad\n") * 3
    b = _batch(columnar, "f", data, [1, 3])
    calls = []
    real = columnar.LineBatch.format_lines_bytes_numpy
    monkeypatch.setattr(columnar.LineBatch, "format_lines_bytes_numpy",
                        lambda self, sep="\t": calls.append(1)
                        or real(self, sep))
    got = b.format_lines_bytes()
    assert got == _batch(ref_col, "f", data, [1, 3]).format_lines_bytes()
    assert len(calls) == (0 if leg == "utf8" else 1)


def test_unique_lines():
    rng = np.random.default_rng(3)
    for data in CORPORA:
        nl = lines_mod.newline_index(data)
        if not data:
            continue
        for n in (1, 10, 5000):
            ends = np.sort(rng.integers(1, len(data) + 1, size=n))
            got = lines_mod.unique_match_lines(ends, nl)
            assert got.tolist() \
                == lines_mod.unique_match_lines_numpy(ends, nl).tolist() \
                == ref.unique_lines_native(nl, ends).tolist()
            # unsorted offsets are sorted first
            shuffled = rng.permutation(ends)
            assert lines_mod.unique_match_lines(shuffled, nl).tolist() \
                == got.tolist()


def test_line_spans():
    for data in CORPORA:
        nl = lines_mod.newline_index(data)
        n_lines = lines_mod.count_lines(data)
        ln = np.array([0, 1, 2, n_lines, n_lines + 1, n_lines + 5, 10**9],
                      dtype=np.int64)
        got = columnar.line_spans(ln, nl, len(data))
        plain = columnar.line_spans_numpy(ln, nl, len(data))
        want = ref.line_spans_native(nl, ln, len(data))
        for g, p, w in zip(got, plain, want):
            assert g.tolist() == p.tolist() == w.tolist()


def _parts(split) -> dict:
    return {int(p): (b.filename, b.linenos.tolist(), b.offsets.tolist(),
                     b.slab) for p, b in split.items()}


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("n_reduce", [1, 3, 10])
def test_build_records(name, n_reduce):
    data = corpus(7, 6000, trailing=False)
    nl = lines_mod.newline_index(data)
    n_lines = lines_mod.count_lines(data)
    lines = np.arange(1, n_lines + 1)[::3]
    b = _batch(columnar, name, data, lines)
    got = _parts(b.split_by_partition(n_reduce))
    assert got == _parts(b.split_by_partition_numpy(n_reduce)) \
        == _parts(_batch(ref_col, name, data, lines)
                  .split_by_partition(n_reduce))
    arr = np.frombuffer(data, np.uint8)
    for base in (0, 1000):
        d = columnar.DeferredBatch(name, lines, arr, nl, len(data), base)
        r = ref_col.DeferredBatch(name, lines, arr, nl, len(data), base)
        plain = columnar.DeferredBatch(name, lines, arr, nl, len(data), base)
        assert _parts(d.split_by_partition(n_reduce)) \
            == _parts(plain.split_by_partition_numpy(n_reduce)) \
            == _parts(r.split_by_partition(n_reduce))
    for p, (_f, linenos, _o, _s) in got.items():
        for n in linenos:
            assert native.partition(f"{name} (line number #{n})",
                                    n_reduce) == p


def test_build_records_raises_on_a_malformed_span():
    data = np.frombuffer(b"0123456789", np.uint8)
    with pytest.raises(ValueError):
        native.build_records(data, [5], [100], [1], b"f (line number #", 3)
    with pytest.raises(ValueError):
        native.build_records(data, [6], [5], [1], b"f (line number #", 3)
    with pytest.raises(ValueError):
        native.build_records(data, [0], [5], [1], b"f (line number #", 0)
    assert native.build_records(data, [], [], [], b"f", 3) == {}


def _mr_out(path: str, records) -> bytes:
    p = path.encode("utf-8", "surrogateescape")
    return b"".join(p + b" (line number #%d)\t" % n + v + b"\n"
                    for n, v in records)


# paths whose codepoint order differs from their byte order: a valid
# multi-byte character against a surrogate-escaped byte, a prefix ending
# inside a sequence
MERGE_PATHS = ["a", "a\udcc3", "aé", "a\udcc3\udca9", "ab", "a€", "a\udcff",
               "é", "", "b/c.txt"]


def _merge_bufs(seed: int, n_bufs: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    bufs = []
    for _ in range(n_bufs):
        recs = []
        for path in sorted(rng.choice(MERGE_PATHS, size=3,
                                      replace=False).tolist()):
            lines = np.unique(rng.integers(1, 10**6, size=20)).tolist()
            recs.append(_mr_out(path, [(n, PIECES[n % len(PIECES)]
                                        .replace(b"\n", b"\t"))
                                       for n in lines]))
        bufs.append(b"".join(recs))
    return bufs


def _result(tmp_path: Path, bufs: list[bytes]) -> JobResult:
    files = []
    for i, b in enumerate(bufs):
        p = tmp_path / f"mr-out-{i}"
        p.write_bytes(b)
        files.append(p)
    return JobResult(output_files=files, fileline_sorted=True)


@pytest.mark.parametrize("seed", range(4))
def test_merge_display(tmp_path, seed):
    bufs = _merge_bufs(seed, 1 + seed * 3)
    # buffers may start with an empty line and end without a '\n'
    bufs[0] = b"\n" + bufs[0]
    bufs[-1] = bufs[-1].rstrip(b"\n")
    got = native.merge_display(bufs)
    plain = b"".join(_result(tmp_path, bufs).iter_display_bytes_sorted())
    assert got == plain == ref.merge_display(bufs)


def test_merge_display_declines_a_line_not_grep_shaped():
    bufs = [_mr_out("a", [(1, b"x")]), b"not a grep key\tv\n"]
    assert native.merge_display(bufs) is None
    assert ref.merge_display(bufs) is None


@pytest.mark.parametrize("case", ["paths", "not grep-shaped"])
def test_display_blocks_sorted_merges_several_files_in_the_library(
        tmp_path, monkeypatch, case):
    """Several paths go through the library's merge; a line that is not
    grep-key-shaped is its one data-dependent leg (the record merge)."""
    bufs = _merge_bufs(11, 4)
    if case == "not grep-shaped":
        bufs[1] += b"zz no key\tvalue\n"
    calls = []
    real = native.merge_display
    monkeypatch.setattr(native, "merge_display",
                        lambda b: calls.append(real(b)) or calls[-1])
    res = _result(tmp_path, bufs)
    got = b"".join(res.display_blocks_sorted())
    assert got == b"".join(res.iter_display_bytes_sorted())
    assert len(calls) == 1
    assert (calls[0] is None) == (case == "not grep-shaped")


@pytest.mark.parametrize("size", [1024, 1 << 16])
def test_trigram_summary(size):
    for data in CORPORA + [b"The Volcano THE volcano"]:
        got = np.zeros(size, np.uint8)
        native.trigram_summary_into(data, got)
        plain = np.zeros(size, np.uint8)
        native.trigram_summary_numpy(data, plain)
        want = np.zeros(size, np.uint8)
        assert ref.trigram_summary_into(data, want)
        assert got.tobytes() == plain.tobytes() == want.tobytes()
    with pytest.raises(ValueError):
        native.trigram_summary_into(b"abcd", np.zeros(1000, np.uint8))


def test_dfa_lines_match_equals_numpy_on_lines_and_windows():
    rng = np.random.default_rng(4)
    for pattern in DFA_PATTERNS:
        t = compile_dfa(pattern)
        for data in CORPORA[1:]:
            nl = lines_mod.newline_index(data)
            n = lines_mod.count_lines(data)
            s, e = columnar.line_spans(np.arange(1, n + 1), nl, len(data))
            w0 = np.minimum(s + rng.integers(0, 4, s.size), e)
            w1 = np.maximum(w0, e - rng.integers(0, 4, s.size))
            for a, b in ((s, e), (w0, w1), (s[::-1], e[::-1])):
                got = host_match.dfa_lines_match(t, data, a, b)
                assert got.tolist() == host_match.dfa_lines_match_numpy(
                    t, data, a, b).tolist(), (pattern, data[:40])
    t = compile_dfa("b$")
    data = b"ab"  # no '\n' anywhere: the gather adds its own
    assert host_match.dfa_lines_match(t, data, [0, 0], [2, 1]).tolist() \
        == [True, False]


def test_a_missing_compiler_raises_and_nothing_falls_back(tmp_path):
    code = f"""
from pathlib import Path
from distributed_grep_tpu_torch.ops import _build
_build.BUILD_DIR = Path({str(tmp_path)!r})
from distributed_grep_tpu_torch.ops import lines
try:
    print(lines.newline_index(b"a\\nb\\n"))
except RuntimeError as e:
    print("raised:", e)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         cwd=REPO, timeout=120,
                         env=dict(os.environ, PATH="", PYTHONPATH=str(REPO)))
    assert out.returncode == 0, out.stderr.decode()
    assert out.stdout.startswith(b"raised: g++ not found on PATH")
    assert not list(tmp_path.iterdir())


def test_a_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "GXX_FLAGS",
                        _build.GXX_FLAGS + ("-fdgrep-no-such-option",))
    with pytest.raises(RuntimeError, match="failed for csrc/dgrep.cpp"):
        native.lib()
    assert not list(tmp_path.glob("*.so"))


def test_the_port_paths_call_the_library(tmp_path, monkeypatch):
    """ops/lines, runtime/columnar, ConfirmSet, the DFA oracle and -w on a
    literal each reach their entry point (a spy on each binding)."""
    called = {}

    def spy(name):
        real = getattr(native, name)

        def wrapper(*a, **k):
            called[name] = called.get(name, 0) + 1
            return real(*a, **k)
        monkeypatch.setattr(native, name, wrapper)

    for name in ("newline_index", "unique_lines", "build_records",
                 "gather_ranges", "line_spans", "format_batch",
                 "confirm_scan", "dfa_scan_mt", "literal_scan"):
        spy(name)
    data = b"a volcano\nno\nvolcanoes\n"
    nl = lines_mod.newline_index(data)
    lines_mod.unique_match_lines(np.array([5, 20]), nl)
    b = _batch(columnar, "f", data, [1, 3])
    b.split_by_partition(3)
    b.format_lines_bytes()
    columnar.DeferredBatch("f", np.array([1]), np.frombuffer(data, np.uint8),
                           nl, len(data)).split_by_partition(3)
    ConfirmSet([b"volcano"]).confirm(data, np.array([9]))
    from distributed_grep_tpu_torch.ops.engine import GrepEngine
    eng = GrepEngine("volcano$", device="cpu")
    assert eng.host_line_matcher(data, [0, 10], [9, 12]).tolist() \
        == [True, False]
    from distributed_grep_tpu_torch.apps import grep_cuda
    grep_cuda.configure(pattern="volcano", device="cpu", word_regexp=True)
    assert grep_cuda._confirm_lit == b"volcano"
    recs = grep_cuda.map_fn("f", data)
    assert recs[0].linenos.tolist() == [1]
    assert set(called) == {"newline_index", "unique_lines", "build_records",
                           "gather_ranges", "line_spans", "format_batch",
                           "confirm_scan", "dfa_scan_mt", "literal_scan"}


@pytest.mark.parametrize("opts,lit", [
    ({"pattern": "volcano"}, b"volcano"),
    ({"pattern": "volcano", "ignore_case": True}, None),
    ({"pattern": "vol.ano"}, None),
    ({"patterns": ["volcano", "ash"]}, None),
    ({"pattern": "(volcano|ash)"}, None),
])
def test_the_literal_word_path_is_taken_where_the_reference_takes_it(opts,
                                                                      lit):
    from distributed_grep_tpu_torch.apps import grep_cuda
    for mode in ("word_regexp", "line_regexp"):
        grep_cuda.configure(device="cpu", **opts, **{mode: True})
        assert grep_cuda._confirm_lit == lit
    grep_cuda.configure(device="cpu", **opts)
    assert grep_cuda._confirm_lit is None


@pytest.mark.parametrize("mode", ["word", "line"])
def test_literal_mode_lines_equals_the_wrapped_regex(mode):
    from distributed_grep_tpu.apps.grep import literal_mode_lines as ref_lml
    from distributed_grep_tpu_torch.apps.grep import (
        build_confirm,
        literal_mode_lines,
    )
    for lit in (b"the", b"volcano", b"_x9", b"\xff", b"ab"):
        rx = build_confirm(pattern=lit, mode=mode)
        for data in CORPORA:
            got = literal_mode_lines(data, lit, mode)
            nl = lines_mod.newline_index(data)
            n = lines_mod.count_lines(data)
            s, e = columnar.line_spans(np.arange(1, n + 1), nl, len(data))
            want = [i + 1 for i in range(n)
                    if rx.search(data[s[i]:e[i]]) is not None]
            assert got.tolist() == want == ref_lml(data, lit, mode).tolist()
