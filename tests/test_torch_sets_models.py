"""Port literal-set models vs the reference: FDR plans, pairset models,
density estimates and literal decomposition, equal field for field.

A grep system has no weights: its compiled tables are the state both
implementations must share.  ``compile_fdr`` is held to the reference with
the same explicit ``Pricing`` given to both (banks' m, checks, tables,
members, and fp to 1e-12 relative), on BASELINE configs 2, 3 and 5 (the
10,000-member set at full size), -i sets, mixed-length sets that split
into two groups, and sets too dense for both.  The one expected
difference is the reference's native-scanner crossover: the port has no
host scanner and keeps such a set on the card.
"""

import numpy as np
import pytest

from distributed_grep_tpu.models import dfa as ref_dfa
from distributed_grep_tpu.models import fdr as ref_fdr
from distributed_grep_tpu.models import pairset as ref_ps
from distributed_grep_tpu.models import shift_and as ref_sa
from distributed_grep_tpu_torch.models import dfa as port_dfa
from distributed_grep_tpu_torch.models import fdr as port_fdr
from distributed_grep_tpu_torch.models import pairset as port_ps
from distributed_grep_tpu_torch.models import shift_and as port_sa

CONFIG2_WORDS = ["volcano", "anarchism", "philosophy", "needle", "wikipedia",
                 "quantum", "zeppelin", "obsidian"]
NO_NL = np.delete(np.arange(1, 256), 9)  # 0x01..0xFF without '\n'


def rand_literals(n: int, lo: int, hi: int, seed: int, alphabet=None) -> list:
    """The recipe of benchmarks/baseline_configs.py _rand_literals: n
    distinct members of lo..hi bytes, lowercase unless ``alphabet``."""
    rng = np.random.default_rng(seed)
    pats = set()
    while len(pats) < n:
        k = int(rng.integers(lo, hi + 1))
        chars = (rng.integers(97, 123, size=k) if alphabet is None
                 else rng.choice(alphabet, size=k))
        pats.add("".join(chr(c) for c in chars))
    return sorted(pats)


def config3() -> list[str]:
    return rand_literals(1000, 6, 12, seed=3)


def config5() -> list[bytes]:
    return [p.encode("latin-1")
            for p in rand_literals(10_000, 5, 9, seed=5, alphabet=NO_NL)]


def _pricings(threads: int = 8):
    kw = dict(confirm_ps_per_candidate=8600.0, confirm_threads=threads,
              fp_bias=2.5, overlap_residue=0.2)
    return port_fdr.Pricing(**kw), ref_fdr.Pricing(**kw)


def assert_same_model(port, ref):
    assert (port.n_patterns, port.ignore_case, len(port.banks)) == (
        ref.n_patterns, ref.ignore_case, len(ref.banks))
    for a, b in zip(port.banks, ref.banks):
        assert (a.m, a.checks, a.patterns) == (b.m, b.checks, b.patterns)
        assert len(a.tables) == len(b.tables)
        for x, y in zip(a.tables, b.tables):
            assert x.dtype == y.dtype == np.uint32
            np.testing.assert_array_equal(x, y)
        assert a.fp_per_byte == pytest.approx(b.fp_per_byte, rel=1e-12)
    assert port.fp_per_byte == pytest.approx(ref.fp_per_byte, rel=1e-12)


SETS = {
    "config2": (CONFIG2_WORDS, False),
    "config3": (config3(), False),
    "config5": (config5(), False),
    "-i mixed case": ([p.upper() if i % 3 == 0 else p for i, p in
                       enumerate(rand_literals(300, 4, 9, seed=21))], True),
    "-i config2": ([w.capitalize() for w in CONFIG2_WORDS], True),
    "two groups": (rand_literals(80, 2, 3, seed=22)
                   + rand_literals(300, 7, 11, seed=23), False),
    "short window": (["ab", "zq", "needle"], False),
}


@pytest.mark.parametrize("name", sorted(SETS))
@pytest.mark.parametrize("threads", [8, 1])
def test_compile_fdr_equals_reference(name, threads):
    pats, ic = SETS[name]
    pp, rp = _pricings(threads)
    port = port_fdr.compile_fdr(pats, ignore_case=ic, pricing=pp)
    ref = ref_fdr.compile_fdr(pats, ignore_case=ic, pricing=rp)
    assert_same_model(port, ref)
    if name == "two groups":
        assert len({b.m for b in port.banks}) == 2
    if name == "config5":
        assert port.banks[0].families == (0, 1)


def test_plans_of_the_baseline_sets():
    """The plans the card sees for BASELINE configs 2, 3 and 5."""
    shapes = {
        "config2": [(2, ((1, 0, 128), (0, 0, 128)))],
        "config3": [(5, tuple((k, 0, 128) for k in range(4, -1, -1)))],
        "config5": [(4, ((3, 0, 128), (2, 0, 512), (1, 0, 512),
                         (0, 0, 512), (3, 1, 256), (2, 1, 256)))],
    }
    for name, want in shapes.items():
        model = port_fdr.compile_fdr(SETS[name][0])
        assert [(b.m, b.checks) for b in model.banks] == want


@pytest.mark.parametrize("n", [3000, 1500])
def test_too_dense_sets_raise_in_both(n):
    pats = rand_literals(n, 2, 2, seed=31, alphabet=np.arange(32, 127))
    with pytest.raises(ref_fdr.FdrError, match="too dense"):
        ref_fdr.compile_fdr(pats)
    with pytest.raises(port_fdr.FdrError, match="too dense"):
        port_fdr.compile_fdr(pats)


@pytest.mark.parametrize("pats", [[], ["a", "bc"], ["has\nnewline"], [""]])
def test_unusable_sets_raise_in_both(pats):
    with pytest.raises(ref_fdr.FdrError):
        ref_fdr.compile_fdr(pats)
    with pytest.raises(port_fdr.FdrError):
        port_fdr.compile_fdr(pats)


def test_native_crossover_is_the_one_difference():
    """Priced with a huge host fan, the reference cedes a set to its native
    scanner (when its library is built); the port keeps it on the card."""
    from distributed_grep_tpu.utils.native import native_available

    pats = config3()
    pp, rp = _pricings(threads=100_000)
    port = port_fdr.compile_fdr(pats, pricing=pp)
    assert port.banks and port.fp_per_byte * pp.fp_bias <= \
        port_fdr.FP_CEILING_PER_BYTE
    if native_available():
        with pytest.raises(ref_fdr.FdrError, match="native host fan"):
            ref_fdr.compile_fdr(pats, pricing=rp)


def test_fdr_bank_from_arrays_round_trip_and_rejects():
    ref = ref_fdr.compile_fdr(config3()).banks[0]
    bank = port_fdr.fdr_bank_from_arrays(ref.m, ref.checks, ref.tables,
                                         ref.patterns, ref.fp_per_byte)
    assert (bank.m, bank.checks, bank.patterns) == (ref.m, ref.checks,
                                                    ref.patterns)
    assert all(a is not b and np.array_equal(a, b)
               for a, b in zip(bank.tables, ref.tables))
    with pytest.raises(ValueError):
        port_fdr.fdr_bank_from_arrays(7, ref.checks, ref.tables, [], 0.0)
    with pytest.raises(ValueError):
        port_fdr.fdr_bank_from_arrays(ref.m, ref.checks, ref.tables[1:], [], 0)
    with pytest.raises(ValueError):
        port_fdr.fdr_bank_from_arrays(2, [(0, 0, 384)], [np.zeros(384)], [], 0)
    with pytest.raises(ValueError):
        port_fdr.fdr_bank_from_arrays(2, [(0, 0, 256)], [np.zeros(128)], [], 0)


def test_reference_candidates_equal_reference():
    model = ref_fdr.compile_fdr(SETS["-i mixed case"][0], ignore_case=True)
    port = port_fdr.FdrModel(
        banks=[port_fdr.fdr_bank_from_arrays(b.m, b.checks, b.tables,
                                             b.patterns, b.fp_per_byte)
               for b in model.banks],
        ignore_case=True, n_patterns=model.n_patterns)
    rng = np.random.default_rng(5)
    data = rng.choice(np.frombuffer(b"abcdeABCDE \n", np.uint8),
                      size=20_000).tobytes()
    np.testing.assert_array_equal(
        port_fdr.reference_candidates_model(port, data),
        ref_fdr.reference_candidates_model(model, data))


# ------------------------------------------------------------------ pairset
PAIR_SETS = {
    "products and singles": ([bytes([a, b]) for a in b"abcde" for b in b"XYZ"]
                             + [b"q", b"7"], False),
    "transposed": ([bytes([100 + i, b"uvwxyz"[j]]) for i in range(40)
                    for j in range(6) if (i + 1) >> j & 1], False),
    "-i": (["AB", "c", "zQ", "9!"], True),
    "1-byte only": (["#", "~", "\x01"], False),
    "binary": ([bytes([200, 13]), b"\xff\xfe", b"\x00"], False),
}


@pytest.mark.parametrize("name", sorted(PAIR_SETS))
def test_compile_pairset_equals_reference(name):
    pats, ic = PAIR_SETS[name]
    port = port_ps.compile_pairset(pats, ignore_case=ic)
    ref = ref_ps.compile_pairset(pats, ignore_case=ic)
    for f in ("rowcls", "words"):
        a, b = getattr(port, f), getattr(ref, f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (port.transposed, port.n_classes, port.patterns, port.ignore_case) \
        == (ref.transposed, ref.n_classes, ref.patterns, ref.ignore_case)
    assert port.transposed == (name == "transposed")
    again = port_ps.pairset_from_arrays(ref.rowcls, ref.words, ref.transposed,
                                        ref.n_classes, ref.patterns,
                                        ref.ignore_case)
    np.testing.assert_array_equal(again.words, ref.words)
    for fold in (False, True):
        assert port_ps.expected_match_density(pats, ignore_case=fold) == \
            pytest.approx(ref_ps.expected_match_density(pats, ignore_case=fold),
                          rel=1e-12)


def test_pairset_rejects_in_both_and_from_arrays_checks():
    rng = np.random.default_rng(2)
    dense = sorted({bytes(rng.integers(32, 127, size=2).tolist())
                    for _ in range(3000)})
    for bad in (dense, [b"abc"], [b"\n"], []):
        with pytest.raises(ref_ps.PairsetError):
            ref_ps.compile_pairset(bad)
        with pytest.raises(port_ps.PairsetError):
            port_ps.compile_pairset(bad)
    with pytest.raises(ValueError):
        port_ps.pairset_from_arrays(np.zeros(255), np.zeros(256), False, 1,
                                    [], False)
    with pytest.raises(ValueError):
        port_ps.pairset_from_arrays(np.full(256, 32), np.zeros(256), False, 1,
                                    [], False)


@pytest.mark.parametrize("pats", [[" "], ["e", "zq"], ["th", "he", "in"],
                                  ["\xff", "ab"]])
def test_density_and_priors_equal_reference(pats):
    np.testing.assert_array_equal(port_sa._text_prior(), ref_sa._text_prior())
    np.testing.assert_array_equal(port_sa._byte_prior(), ref_sa._byte_prior())
    for ic in (False, True):
        assert port_ps.expected_match_density(pats, ignore_case=ic) == \
            pytest.approx(ref_ps.expected_match_density(pats, ignore_case=ic),
                          rel=1e-12)


# ----------------------------------------------------- literal decomposition
@pytest.mark.parametrize("pattern,ic", [
    ("(ab|cd)", False), ("x[01][01]", False), ("a+", False), ("^ab", False),
    ("(a|)", False), ("[0-9]{4}", False), ("volcano", False),
    ("(" + "|".join(CONFIG2_WORDS) + ")", False), ("nee(dle|t)", True),
    ("([^x]|zz)", True), ("(q[^x]|qq)", True), ("([^x]|zz)", False),
    ("(?:(?:volcano)|(?:he))", False), ("[ab][cd]{2}", False),
    ("(a\nb|cd)", False), ("h[", False), (r"(\d\d|x)", False),
    ("[a-z]{2}", False),
])
def test_enumerate_literal_set_equals_reference(pattern, ic):
    assert port_dfa.enumerate_literal_set(pattern, ignore_case=ic) == \
        ref_dfa.enumerate_literal_set(pattern, ignore_case=ic)
    assert port_dfa.enumerate_literal_set(pattern, cap=8) == \
        ref_dfa.enumerate_literal_set(pattern, cap=8)
    assert port_dfa.LITERAL_SET_CAP == ref_dfa.LITERAL_SET_CAP
