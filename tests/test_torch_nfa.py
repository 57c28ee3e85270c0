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


def test_pack_plan_layout():
    m = port_nfa.try_compile_glushkov("a[bc]{40,90}d")
    plan = nfa_scan.pack_plan(m)
    assert plan.dtype == np.uint32
    assert plan.size == nfa_scan._SPECIALS + 5 * m.n_specials
    starts = plan[nfa_scan._SPEC_START : nfa_scan._SPEC_START + 5].tolist()
    assert starts[0] == 0 and starts[-1] == m.n_specials == 51
    b = plan[nfa_scan._B : nfa_scan._B + 256 * m.n_words].reshape(m.n_words, 256)
    np.testing.assert_array_equal(b, nfa_scan.b_table(m))
    for w in range(m.n_words):  # each word's records carry its own bits
        mask = 0
        for i in range(starts[w], starts[w + 1]):
            mask |= 1 << int(plan[nfa_scan._SPECIALS + 5 * i])
        assert mask == plan[nfa_scan._SPEC_MASK + w]


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
