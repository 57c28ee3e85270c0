"""Port pattern models vs the reference package's: the compiled Shift-And
model is the state both implementations share (a grep system has no
weights), so it must be equal field for field."""

import numpy as np
import pytest

from distributed_grep_tpu.models import shift_and as ref_sa
from distributed_grep_tpu_torch.models import shift_and as port_sa

PATTERNS = [
    ("volcano", False),
    ("Volcano", True),
    ("h[ae]llo", False),
    ("h[ae]llo", True),
    ("[^x]yz", True),
    ("[a-z0-9_]q", False),
    ("a.c", False),
    (r"\d\w\s\D\W\S", False),
    (r"\x41\t\.\[", False),
    (r"[[:digit:]][[:alpha:]][[:punct:]][[:space:]]", False),
    (r"[[:upper:]]x", True),
    ("[.a.][=b=]", False),
    (r"[\0101]", False),
    ("x" * 32, False),
    ("x" * 33, False),  # one symbol past the uint32 state: not eligible
    ("[a-z ]" * 32, False),
    ("café", False),  # multi-byte UTF-8: one symbol per byte
    ("a\nb", False),  # newline-consuming
    (r"a\nb", False),
    ("[^a]b", False),  # negated class contains '\n'
    ("a+", False),
    ("a|b", False),
    ("^ab", False),
    ("ab$", False),
    (r"\bword", False),
    ("(ab)", False),
    ("", False),
    ("h[", False),  # invalid patterns
    ("a{2,1}", False),
    ("*a", False),
    ("[:alpha:]", False),
    ("[[:nope:]]", False),
    (r"(a)\1", False),
]


def _fields(m):
    if m is None:
        return None
    return (m.b_table.tolist(), [list(map(tuple, r)) for r in m.sym_ranges],
            m.length, m.pattern)


@pytest.mark.parametrize("pattern,ignore_case", PATTERNS)
def test_shift_and_models_equal_reference(pattern, ignore_case):
    ref = ref_sa.try_compile_shift_and(pattern, ignore_case=ignore_case)
    port = port_sa.try_compile_shift_and(pattern, ignore_case=ignore_case)
    assert _fields(port) == _fields(ref)
    if ref is not None:
        assert port.b_table.dtype == np.uint32
        assert int(port.match_bit) == int(ref.match_bit)
        assert _fields(port_sa.filtered_for_device(port)) == _fields(
            ref_sa.filtered_for_device(ref))


@pytest.mark.parametrize("pattern,ignore_case", [
    ("volcano", False), ("Volcano", True), ("h[ae]llo", False),
    ("[a-z ]" * 32, False),
])
def test_model_from_arrays_round_trip(pattern, ignore_case):
    """The reference model's plain arrays rebuild the port's model."""
    ref = ref_sa.try_compile_shift_and(pattern, ignore_case=ignore_case)
    for r in (ref, ref_sa.filtered_for_device(ref)):
        if r is None:
            continue
        rebuilt = port_sa.model_from_arrays(
            r.b_table, r.sym_ranges, r.length, r.pattern)
        assert _fields(rebuilt) == _fields(r)
        assert rebuilt.b_table is not r.b_table
        again = port_sa.model_from_arrays(
            rebuilt.b_table.tolist(), rebuilt.sym_ranges, rebuilt.length,
            rebuilt.pattern)
        assert _fields(again) == _fields(rebuilt)


def test_model_from_arrays_rejects_bad_shapes():
    with pytest.raises(ValueError):
        port_sa.model_from_arrays(np.zeros(255, np.uint32), [[(1, 1)]], 1, "x")
    with pytest.raises(ValueError):
        port_sa.model_from_arrays(np.zeros(256, np.uint32), [], 1, "x")
    with pytest.raises(ValueError):
        port_sa.model_from_arrays(np.zeros(256, np.uint32), [[]] * 33, 33, "x")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scan_reference_equal(seed):
    rng = np.random.default_rng(seed)
    data = bytes(rng.choice(np.frombuffer(b"volcanVOLC\n ", np.uint8),
                            size=4000).tolist())
    for pat, ic in [("volcano", False), ("vol", True), ("[ol]c", False)]:
        ref = ref_sa.try_compile_shift_and(pat, ignore_case=ic)
        port = port_sa.try_compile_shift_and(pat, ignore_case=ic)
        np.testing.assert_array_equal(
            port_sa.scan_reference(port, data),
            ref_sa.scan_reference(ref, data))
