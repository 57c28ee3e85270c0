"""The table-DFA kernel's plain version vs the reference's XLA device scan.

``ops/dfa_scan.dfa_scan_words_plain`` gives words bit-identical (tolerance
0: integer words) to ``distributed_grep_tpu/ops/scan_jnp.py:
_dfa_scan_core`` once the reference's packed bits, (chunk, lanes // 8)
uint8 with bit k of byte g for lane 8g + k, are mapped to the port's
(chunk // 32, lanes) words: over seeded ``compile_dfa`` tables of random
regexes ('$' accepts among them), Aho-Corasick banks and the stripe-tail
rule (the stripe's last byte counts as followed by '\\n'), at small
shapes.  The kernel's own arithmetic (csrc/dfa.cu: packed entries, the
premultiplied state, the next-newline bit across words) is walked in numpy
and held to the plain version; the CUDA kernel itself is held to the plain
version on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_grep_tpu.models import dfa as ref_dfa
from distributed_grep_tpu.ops import scan_jnp
from distributed_grep_tpu_torch.models import aho as port_aho
from distributed_grep_tpu_torch.models import dfa as port_dfa
from distributed_grep_tpu_torch.ops import dfa_scan
from distributed_grep_tpu_torch.ops.fdr_scan import pack_bits

ALPHABET = np.frombuffer(b"abnedlt x\n", np.uint8)
ATOMS = ["a", "b", "n", "e", "ne", "[ab]", "[^a\n]", ".", "(a|ne)", "d",
         "(^a|b)", "x", "t"]
REPEATS = ["", "", "*", "+", "?", "{1,2}"]


def _ref_words(data_cl: np.ndarray, table) -> torch.Tensor:
    """The reference scan's bits for (chunk, lanes) columns, as words."""
    packed = np.asarray(scan_jnp._dfa_scan_core(
        jnp.asarray(data_cl),
        jnp.asarray(table.trans.astype(np.int32).reshape(-1)),
        jnp.asarray(table.byte_to_cls.astype(np.int32)),
        jnp.asarray(table.accept), jnp.asarray(table.accept_eol),
        jnp.int32(table.start), table.n_classes))
    bits = np.unpackbits(packed, axis=1, bitorder="little").astype(bool)
    return pack_bits(torch.from_numpy(bits))


def _plain(data_cl: np.ndarray, table) -> torch.Tensor:
    return dfa_scan.dfa_scan_words(
        torch.from_numpy(np.ascontiguousarray(data_cl.T)), table)


def _columns(seed: int, chunk: int, lanes: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    data = rng.choice(ALPHABET, size=(chunk, lanes))
    data[-1, ::2] = ord("e")  # stripes whose last byte is not '\n'
    data[0, 1::4] = ord("\n")  # and stripes that start at a line end
    return data


def _random_regex(rng) -> str:
    parts = [ATOMS[rng.integers(0, len(ATOMS))]
             + REPEATS[rng.integers(0, len(REPEATS))]
             for _ in range(rng.integers(1, 4))]
    pattern = "".join(parts)
    if rng.random() < 0.5:
        pattern += "$"
    if rng.random() < 0.2:
        pattern = "^" + pattern
    if rng.random() < 0.2:
        pattern += "|" + ATOMS[rng.integers(0, len(ATOMS))] + "$"
    return pattern


@pytest.mark.parametrize("seed", range(6))
def test_plain_words_equal_reference_on_random_dfas(seed):
    rng = np.random.default_rng(100 + seed)
    data = _columns(seed, 64, 64)
    eol_seen = 0
    for _ in range(12):
        pattern = _random_regex(rng)
        try:
            ref_t = ref_dfa.compile_dfa(pattern)
        except ref_dfa.RegexError:
            continue
        t = port_dfa.compile_dfa(pattern)
        eol_seen += bool(t.accept_eol.any())
        got = _plain(data, t)
        assert torch.equal(got, _ref_words(data, ref_t)), pattern
    assert eol_seen


@pytest.mark.parametrize("pats,ic,budget", [
    (["needle", "nee", "edle", "at"], False, 8),
    (["NE", "b", "Ta"], True, 4),
    ([b"\xff\x00", b"a\x00e", b"x"], False, 4),
])
def test_plain_words_equal_reference_on_aho_banks(pats, ic, budget):
    data = _columns(7, 96, 32)
    data[5:8, 3] = np.frombuffer(b"\xff\x00\n", np.uint8)
    banks = port_aho.compile_aho_corasick_banks(pats, ic,
                                                max_states_per_bank=budget)
    assert len(banks) > 1
    want = None
    for t in banks:
        w = _ref_words(data, t)
        assert torch.equal(_plain(data, t), w)
        want = w if want is None else want | w
    stripes = torch.from_numpy(np.ascontiguousarray(data.T))
    assert torch.equal(dfa_scan.dfa_scan_bank_words(stripes, banks), want)


def test_stripe_tail_counts_as_followed_by_newline():
    """An accept_eol state after a stripe's last byte is a match, though
    the byte after it (the next stripe's first) is not '\\n'."""
    t = port_dfa.compile_dfa("e$")
    data = np.full((32, 32), ord("a"), dtype=np.uint8)
    data[-1, :] = ord("e")
    data[10, 4] = ord("e")
    data[11, 4] = ord("\n")
    words = _plain(data, t)
    assert torch.equal(words, _ref_words(data, ref_dfa.compile_dfa("e$")))
    assert int(words[0, 4]) >> 10 & 1 == 1
    assert all(int(w) >> 31 & 1 for w in words[0].tolist())
    assert int(words[0, 4]) >> 30 & 1 == 0


def _kernel_walk(data_cl: np.ndarray, table) -> np.ndarray:
    """csrc/dfa.cu's arithmetic in numpy: packed entries, the
    premultiplied state, one word of 32 bits at a time with the next
    word's first byte (or, past the stripe, a '\\n') for bit 31."""
    entries = dfa_scan.packed_table(table).astype(np.uint64)
    cls = table.byte_to_cls.astype(np.uint64)
    chunk, lanes = data_cl.shape
    state = np.full(lanes, table.start * table.n_classes, dtype=np.uint64)
    out = np.zeros((chunk // 32, lanes), dtype=np.uint64)
    for w in range(chunk // 32):
        acc = np.zeros(lanes, np.uint64)
        eol = np.zeros(lanes, np.uint64)
        nl = np.zeros(lanes, np.uint64)
        for t in range(32):
            b = data_cl[32 * w + t]
            e = entries[state + cls[b]]
            state = e & np.uint64((1 << 30) - 1)
            acc |= (e >> np.uint64(31)) << np.uint64(t)
            eol |= ((e >> np.uint64(30)) & np.uint64(1)) << np.uint64(t)
            nl |= (b == 10).astype(np.uint64) << np.uint64(t)
        nxt = ((data_cl[32 * w + 32] == 10).astype(np.uint64)
               if 32 * w + 32 < chunk else np.ones(lanes, np.uint64))
        out[w] = acc | (eol & ((nl >> np.uint64(1)) | (nxt << np.uint64(31))))
    return out.astype(np.uint32)


@pytest.mark.parametrize("pattern", ["nee(dle|t)", "e$", "^$", "(ab)*$",
                                     "^d", "a.b|x$"])
def test_kernel_arithmetic_equals_plain(pattern):
    data = _columns(11, 96, 32)
    t = port_dfa.compile_dfa(pattern)
    got = _kernel_walk(data, t)
    assert np.array_equal(got, _plain(data, t).numpy())


def test_packed_table_and_branch_choice():
    t = port_dfa.compile_dfa("nee(dle|t)$")
    p = dfa_scan.packed_table(t)
    assert p.dtype == np.uint32 and p.size == t.n_states * t.n_classes
    nxt = t.trans.reshape(-1).astype(np.int64)
    assert np.array_equal(p & ((1 << 30) - 1), nxt * t.n_classes)
    assert np.array_equal(p >> 31, t.accept[nxt])
    assert np.array_equal((p >> 30) & 1, t.accept_eol[nxt])
    assert dfa_scan.uses_shared_memory(t)
    rng = np.random.default_rng(1)
    big = port_aho.compile_aho_corasick(
        [bytes(rng.integers(97, 123, size=8)) for _ in range(400)])
    assert 4 * big.n_states * big.n_classes > dfa_scan.SMEM_TABLE_BYTES
    assert not dfa_scan.uses_shared_memory(big)


def test_wrapper_checks_and_device_cache():
    t = port_dfa.compile_dfa("ab")
    with pytest.raises(ValueError, match="chunk % 32"):
        dfa_scan.dfa_scan_words(torch.zeros((32, 40), dtype=torch.uint8), t)
    with pytest.raises(ValueError, match="uint8"):
        dfa_scan.dfa_scan_words(torch.zeros((32, 32), dtype=torch.int32), t)
    with pytest.raises(ValueError, match="unsupported device"):
        dfa_scan.dfa_scan_words(
            torch.zeros((32, 32), dtype=torch.uint8, device="meta"), t)
    with pytest.raises(ValueError, match="no DFA tables"):
        dfa_scan.dfa_scan_bank_words(torch.zeros((32, 32), dtype=torch.uint8), [])
    a = dfa_scan.device_table(t, torch.device("cpu"))
    assert dfa_scan.device_table(t, torch.device("cpu")) is a
    assert np.array_equal(a[0].numpy(), dfa_scan.packed_table(t))
    before = dfa_scan.launches
    dfa_scan.dfa_scan_words(torch.zeros((32, 32), dtype=torch.uint8), t)
    assert dfa_scan.launches == before  # the plain version launches nothing
