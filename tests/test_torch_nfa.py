"""Port regex models, NFA kernel function and host oracle vs the reference.

The compiled automata are the state both implementations share (a grep
system has no weights): the port's Glushkov models and DFA tables must be
equal field for field and array for array to the reference's.  The plain
PyTorch version of the NFA kernel, fed the REFERENCE's models through
``glushkov_from_arrays``, must give words bit-identical (tolerance 0:
integer words) to the reference Pallas kernel in interpret mode, reshaped
from its tile (chunk//32, lanes//128, 128) to (chunk//32, lanes).  The
host line oracle must give the reference DFA oracle's lines.  The CUDA
kernel itself is held against the plain version on the card in
tests/test_torch_cuda.py.
"""

import re

import numpy as np
import pytest
import torch

from distributed_grep_tpu.models import dfa as ref_dfa
from distributed_grep_tpu.models import nfa as ref_nfa
from distributed_grep_tpu.ops import pallas_nfa
from distributed_grep_tpu_torch.models import dfa as port_dfa
from distributed_grep_tpu_torch.models import nfa as port_nfa
from distributed_grep_tpu_torch.ops import host_match, layout, nfa_scan
from tests.test_nfa import PATTERNS

CONFIG2 = ("(volcano|anarchism|philosophy|needle|wikipedia|quantum|zeppelin"
           "|obsidian)")
CONFIG4 = r"get /[a-z0-9/.-]{4,24}\.gif"
WIDE = "(" + "|".join([
    "volcano", "anarchism", "philosophy", "wikipedia", "quantum", "zeppelin",
    "obsidian", "telescope", "metabolic", "hurricane", "labyrinth",
    "xylophone"]) + ")"

MODEL_CASES = (
    [(p, False) for p in PATTERNS]
    + [("NeEdLe", True), ("[A-F]{3}", True), ("^GeT", True)]
    + [(CONFIG2, False), (CONFIG4, True), (CONFIG4, False), (WIDE, False),
       ("a[bc]{40,90}d", False), ("x[ab]{2,40}y", False),
       ("q[ab]{10,200}z", False), ("a{1,3}b", False), ("ne+dle", False)]
)
FILTER_CASES = [
    "error$", "abc$|def$", "^end$", "a*b$", "x*$", "^$", "(ab)*$", "A" * 200,
    "x{200}", "[0-9]{150}", "x*y{200}", r"\berror\b", r"wordy\B",
    r"\b[ew]or\w+\b", r"(^a|b)c", r"a(b$|c)d", r"(^ab|cd$)", "[ab]{4,200}c$",
    "q[ab]{10,900}z",
]
FIELDS = ("n_pos", "sym_masks", "follow", "init_float", "init_anchor",
          "final", "chain_src", "specials", "init_float_words",
          "init_anchor_words", "final_words", "n_words")


def _fields(m):
    return None if m is None else tuple(getattr(m, f) for f in FIELDS)


@pytest.mark.parametrize("pattern,ic", MODEL_CASES)
def test_glushkov_models_equal_reference(pattern, ic):
    assert _fields(port_nfa.try_compile_glushkov(pattern, ic)) == _fields(
        ref_nfa.try_compile_glushkov(pattern, ic))
    pm, pf = port_nfa.compile_scan_model(pattern, ic)
    rm, rf = ref_nfa.compile_scan_model(pattern, ic)
    assert (_fields(pm), pf) == (_fields(rm), rf)
    assert _fields(port_nfa.compile_device_filter(pattern, ic)) == _fields(
        ref_nfa.compile_device_filter(pattern, ic))


@pytest.mark.parametrize("pattern", FILTER_CASES)
def test_device_filters_equal_reference(pattern):
    for ic in (False, True):
        assert _fields(port_nfa.compile_device_filter(pattern, ic)) == \
            _fields(ref_nfa.compile_device_filter(pattern, ic))
        try:
            rm = ref_nfa.compile_scan_model(pattern, ic)
        except ref_dfa.RegexError as e:
            with pytest.raises(port_dfa.RegexError):
                port_nfa.compile_scan_model(pattern, ic)
            assert type(e).__name__ in ("RegexError", "TooManyStates")
            continue
        pm = port_nfa.compile_scan_model(pattern, ic)
        assert (_fields(pm[0]), pm[1]) == (_fields(rm[0]), rm[1])


@pytest.mark.parametrize("pattern,ic", MODEL_CASES + [
    (p, False) for p in FILTER_CASES] + [("a\nb", False), ("[^a]b", True)])
def test_dfa_tables_equal_reference(pattern, ic):
    try:
        ref = ref_dfa.compile_dfa(pattern, ignore_case=ic)
    except ref_dfa.RegexError as e:
        with pytest.raises(port_dfa.RegexError) as got:
            port_dfa.compile_dfa(pattern, ignore_case=ic)
        assert type(got.value).__name__ == type(e).__name__
        return
    port = port_dfa.compile_dfa(pattern, ignore_case=ic)
    for name in ("trans", "byte_to_cls", "accept", "accept_eol"):
        a, b = getattr(port, name), getattr(ref, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (port.start, port.pattern) == (ref.start, ref.pattern)
    np.testing.assert_array_equal(port.full_table(), ref.full_table())
    again = port_dfa.dfa_table_from_arrays(
        ref.trans, ref.byte_to_cls, ref.accept, ref.accept_eol, ref.start,
        ref.pattern)
    np.testing.assert_array_equal(again.full_table(), ref.full_table())


def test_from_arrays_reject_bad_shapes():
    m = ref_nfa.try_compile_glushkov("ab")
    with pytest.raises(ValueError):
        port_nfa.glushkov_from_arrays(0, [], [], 0, 0, 0, "x")
    with pytest.raises(ValueError):
        port_nfa.glushkov_from_arrays(2, m.sym_masks, m.follow[:1], 1, 0, 2, "x")
    with pytest.raises(ValueError):
        port_nfa.glushkov_from_arrays(2, m.sym_masks, m.follow, 4, 0, 2, "x")
    t = ref_dfa.compile_dfa("ab")
    with pytest.raises(ValueError):
        port_dfa.dfa_table_from_arrays(t.trans, t.byte_to_cls[:255], t.accept,
                                       t.accept_eol, 0, "ab")
    with pytest.raises(ValueError):
        port_dfa.dfa_table_from_arrays(t.trans, t.byte_to_cls, t.accept[:1],
                                       t.accept_eol, 0, "ab")


@pytest.mark.parametrize("pattern", ["(cat|dog|bird)", r"\d+ ab", "x.y"])
def test_expand_posix_classes_equal_reference(pattern):
    for p in (pattern, "[[:digit:]]+x", "[^[:alpha:]_]", "[a[.-.]z]"):
        assert port_dfa.expand_posix_classes(p) == ref_dfa.expand_posix_classes(p)
        assert port_dfa.expand_posix_classes(p.encode()) == \
            ref_dfa.expand_posix_classes(p.encode())


def _stripes(seed: int, chunk: int, lanes: int) -> np.ndarray:
    """(chunk, lanes) stripe layout of seeded text with every model's
    matches planted, some across 32-byte word edges, and '^' lines at
    stripe heads and mid-stripe."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz     \nGET/.", np.uint8)
    text = rng.choice(alphabet, size=chunk * lanes)
    plants = [b"volcano", b"needle", b"labyrinth", b"xylophone", b"neet",
              b"GET /images/KSC-small.gif", b"get /a.gif", b"\nanchor x",
              b"hurricane quantum"]
    for i, p in enumerate(rng.choice(text.size - 40, size=text.size // 1500,
                                     replace=False).tolist()):
        nd = plants[i % len(plants)]
        text[p : p + len(nd)] = np.frombuffer(nd, np.uint8)
    arr = layout.to_device_array(
        text.tobytes(), layout.Layout(lanes=lanes, chunk=chunk, n_real=text.size))
    arr[0:6, ::7] = np.frombuffer(b"anchor", np.uint8)[:, None]
    arr[28:37, 3::50] = np.frombuffer(b"labyrinth", np.uint8)[:, None]
    return arr


@pytest.mark.parametrize("pattern,ic,n_words", [
    ("nee(dle|t)", False, 1), (CONFIG2, False, 2), (WIDE, False, 4),
    ("^anchor", False, 1), (CONFIG4, True, 2),
])
def test_plain_words_bit_identical_to_reference_kernel(pattern, ic, n_words):
    chunk, lanes = 512, 4096
    arr = _stripes(len(pattern), chunk, lanes)
    ref = ref_nfa.try_compile_glushkov(pattern, ignore_case=ic)
    assert ref.n_words == n_words
    port = port_nfa.glushkov_from_arrays(
        ref.n_pos, ref.sym_masks, ref.follow, ref.init_float,
        ref.init_anchor, ref.final, ref.pattern)
    assert port.kernel_plan() == ref.kernel_plan()
    want = np.asarray(pallas_nfa.nfa_scan_words(arr, ref, interpret=True)
                      ).reshape(chunk // 32, lanes)
    got = nfa_scan.nfa_scan_words(torch.from_numpy(arr), port)
    assert got.dtype == torch.uint32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any(), "the text must contain matches"


# 'Z' then 127 starred classes: 128 positions over 4 words, every one a
# special (each follows itself and every later position)
ALL_SPECIALS = "Z" + "".join(f"{chr(97 + i % 26)}*" for i in range(127))


def _walk_packed_plan(plan: np.ndarray, n_words: int,
                      arr: np.ndarray) -> np.ndarray:
    """csrc/nfa.cu's recurrence in numpy, reading only the packed plan:
    the header masks, B[byte] at the interleaved entries and one lookup
    in each exception table, at the byte of its word and slice."""
    chunk, lanes = arr.shape
    s = nfa_scan.entry_words(n_words)
    head = plan[: nfa_scan._HEADER].astype(np.int64)
    shared = plan[nfa_scan._HEADER :].astype(np.int64)
    assert shared.size == head[nfa_scan._N_SHARED]

    def hdr(base, w):
        return int(head[base + w])

    d = np.zeros((n_words, lanes), dtype=np.int64)
    prev_nl = np.ones(lanes, dtype=bool)
    hits = np.zeros((chunk, lanes), dtype=bool)
    for t in range(chunk):
        b = arr[t].astype(np.int64)
        r = np.stack([hdr(nfa_scan._INIT_FLOAT, w)
                      | np.where(prev_nl, hdr(nfa_scan._INIT_ANCHOR, w), 0)
                      | ((d[w] & hdr(nfa_scan._CHAIN, w)) << 1) & 0xFFFFFFFF
                      for w in range(n_words)])
        for i in range(int(head[nfa_scan._N_TABLES])):
            w = hdr(nfa_scan._TAB_WORD, i)
            v = (d[w] >> (8 * hdr(nfa_scan._TAB_SLICE, i))) & 0xFF
            off = (1 + i) * 256 * s
            for x in range(n_words):
                r[x] |= shared[off + v * s + x]
        d = np.stack([r[w] & shared[b * s + w] for w in range(n_words)])
        hits[t] = np.any(d & head[nfa_scan._FINAL : nfa_scan._FINAL + n_words,
                                  None], axis=0)
        prev_nl = b == 0x0A
    bits = hits.reshape(chunk // 32, 32, lanes).astype(np.uint64)
    return (bits << np.arange(32, dtype=np.uint64)[None, :, None]).sum(
        axis=1).astype(np.uint32)


def test_pack_plan_layout():
    """The header, B interleaved by byte and padded to the entry width,
    and the table mask and offsets of a model with 51 specials."""
    m = port_nfa.try_compile_glushkov("a[bc]{40,90}d")
    assert m.n_specials == 51
    plan = nfa_scan.pack_plan(m)
    nw, s = m.n_words, nfa_scan.entry_words(m.n_words)
    assert plan.dtype == np.uint32 and s in (1, 2, 4) and s >= nw
    tables = nfa_scan.exception_tables(m)
    assert plan.size == nfa_scan._HEADER + (1 + len(tables)) * 256 * s
    for base, want in ((nfa_scan._CHAIN, m.chain_src),
                       (nfa_scan._INIT_FLOAT, m.init_float_words),
                       (nfa_scan._INIT_ANCHOR, m.init_anchor_words),
                       (nfa_scan._FINAL, m.final_words)):
        assert plan[base : base + 4].tolist() == list(want) + [0] * (4 - nw)
    b = plan[nfa_scan._HEADER : nfa_scan._HEADER + 256 * s].reshape(256, s)
    np.testing.assert_array_equal(b[:, :nw].T, nfa_scan.b_table(m))
    assert not b[:, nw:].any()
    n = int(plan[nfa_scan._N_TABLES])
    slices = [(int(plan[nfa_scan._TAB_WORD + i]),
               int(plan[nfa_scan._TAB_SLICE + i])) for i in range(n)]
    assert slices == list(tables) == sorted(slices) and n == len(tables) == 8
    assert not plan[nfa_scan._TAB_WORD + n : nfa_scan._TAB_SLICE].any()
    assert not plan[nfa_scan._TAB_SLICE + n : nfa_scan._HEADER].any()
    assert plan[nfa_scan._N_SHARED] == plan.size - nfa_scan._HEADER


@pytest.mark.parametrize("pattern", [
    "a[bc]{40,90}d", CONFIG2, "^anchor", ALL_SPECIALS])
def test_packed_plan_walk_equals_plain(pattern):
    """A walk of the packed plan (the kernel's step in numpy) gives the
    plain version's words: 51 specials over 3 words, 2 words without
    specials, '^', and 128 specials over 4 words."""
    m = port_nfa.try_compile_glushkov(pattern)
    plan = nfa_scan.pack_plan(m)
    nw, tables = m.n_words, nfa_scan.exception_tables(m)
    arr = _stripes(3, 64, 64)
    arr[5:57, 1::9] = np.frombuffer(b"a" + b"bc" * 25 + b"d", np.uint8)[:, None]
    arr[30:36, 2::11] = np.frombuffer(b"Zabbcz", np.uint8)[:, None]
    arr[40:47, 5::13] = np.frombuffer(b"volcano", np.uint8)[:, None]
    want = nfa_scan.nfa_scan_words_plain(torch.from_numpy(arr), m).numpy()
    np.testing.assert_array_equal(_walk_packed_plan(plan, nw, arr), want)
    assert want.any()
    if pattern == ALL_SPECIALS:
        assert (m.n_pos, nw, m.n_specials, len(tables)) == (128, 4, 128, 16)
    if pattern in (CONFIG2, "^anchor"):
        assert m.n_specials == 0 and plan[nfa_scan._N_TABLES] == 0


@pytest.mark.parametrize("pattern,ic", MODEL_CASES + [
    ("a[bc]{0,126}d", False), (ALL_SPECIALS, False)])
def test_exception_tables_are_the_or_of_follow(pattern, ic):
    """Every exception table of the packed plan, every slice and all 256
    values: the entry is the OR of ``follow`` over the specials whose
    source bit lies in the slice and is set in the value; a slice without
    special source bits has no table.  Exact (integer words).  A pattern
    too wide for a Glushkov model is checked on its filter model, the one
    the kernel runs."""
    m = port_nfa.try_compile_glushkov(pattern, ignore_case=ic)
    if m is None:  # too wide: the kernel runs the pattern's filter model
        m = port_nfa.compile_scan_model(pattern, ic)[0]
    plan = nfa_scan.pack_plan(m)
    nw, s = m.n_words, nfa_scan.entry_words(m.n_words)
    slices = [(int(plan[nfa_scan._TAB_WORD + i]),
               int(plan[nfa_scan._TAB_SLICE + i]))
              for i in range(int(plan[nfa_scan._N_TABLES]))]
    n_tables = 0
    for w in range(nw):
        for sl in range(4):
            mine = [(jp % 8, flist) for wp, jp, flist in m.specials
                    if wp == w and jp // 8 == sl]
            assert ((w, sl) in slices) == bool(mine)
            if not mine:
                continue
            i = slices.index((w, sl))
            assert i == n_tables  # tables in (word, slice) order
            n_tables += 1
            off = nfa_scan._HEADER + (1 + i) * 256 * s
            tab = plan[off : off + 256 * s].reshape(256, s)
            for v in range(256):
                want = [0] * s
                for bit, flist in mine:
                    if v >> bit & 1:
                        for wj, fm in flist:
                            want[wj] |= fm
                assert tab[v].tolist() == want, (w, sl, v)
    assert n_tables == len(slices)
    assert plan.size == nfa_scan._HEADER + (1 + n_tables) * 256 * s


def test_wrapper_on_cpu_is_plain_and_not_counted():
    arr = torch.from_numpy(_stripes(5, 64, 64))
    model = port_nfa.try_compile_glushkov(CONFIG2)
    before = nfa_scan.launches
    a = nfa_scan.nfa_scan_words(arr, model)
    live = [0] * model.n_words
    b = nfa_scan.nfa_scan_words_plain(arr, model, live=live)
    assert torch.equal(a, b)
    assert nfa_scan.launches == before  # counts CUDA launches only
    with pytest.raises(ValueError):
        nfa_scan.nfa_scan_words(arr[:48], model)  # chunk % 32
    with pytest.raises(ValueError):
        nfa_scan.nfa_scan_words(arr.to(torch.int32), model)


def _lines_data(seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    vocab = [b"error", b"Error", b"the", b"old", b"new", b"ab", b"c", b"x",
             b"aab", b"bc", b"get", b"/img.gif", b"GET", b"wordy", b"word",
             b"", b"\xff\x00"]
    lines = [b" ".join(vocab[i] for i in rng.integers(0, len(vocab),
                                                      rng.integers(0, 10)))
             for _ in range(3000)]
    lines[7] = b"ab" * 3000 + b" error"  # one long line
    return b"\n".join(lines) + (b"\n" if seed % 2 else b" ab error")


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("pattern,ic", [
    ("error$", False), ("error$", True), ("^the (old|new)", False),
    ("(^a|b)c", False), ("a(b$|c)", False), ("x[ab]{1,4}", False),
    (r"get /[a-z./]{3,10}\.gif", True), ("(ab)+ error$", False),
    ("^$|x$", False),
])
def test_dfa_oracle_lines_equal_reference(seed, pattern, ic):
    data = _lines_data(seed)
    nl = np.flatnonzero(np.frombuffer(data, np.uint8) == 10)
    starts = np.concatenate(([0], nl + 1))
    ends = np.concatenate((nl, [len(data)]))
    if data.endswith(b"\n"):
        starts, ends = starts[:-1], ends[:-1]
    got = host_match.dfa_lines_match(port_dfa.compile_dfa(pattern, ic), data,
                                     starts, ends)
    want = ref_dfa.matched_lines(ref_dfa.compile_dfa(pattern, ic), data)
    assert set((np.flatnonzero(got) + 1).tolist()) == want
    rx = re.compile(pattern.encode(), re.I if ic else 0)
    np.testing.assert_array_equal(
        host_match.re_lines_match(rx, data, starts, ends), got)
