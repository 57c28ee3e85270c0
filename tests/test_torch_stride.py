"""K2, the k-byte-stride table DFA, held to the reference.

The port's ``models/dfa.choose_stride`` and ``build_stride_table`` equal
the reference's (``distributed_grep_tpu/models/dfa.py``) array for array
on seeded tables; ``ops/dfa_scan.dfa_stride_words_plain`` gives words
bit-identical (tolerance 0: integer words) to the reference's
``scan_jnp.dfa_scan_stride`` (the XLA ``_dfa_stride_core``) once its
packed bits are mapped to the port's (chunk // 32, lanes) words, for
k = 2 and 4, and to K1's plain words on the table the stride table was
composed from.  csrc/dfa.cu's ``stride_kernel`` arithmetic (the
premultiplied entries of ``packed_stride_table``, 32 / k strides a word)
is walked in numpy and held to the plain version; the CUDA kernel itself
is held to the plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py).  K1's plain exit states equal the reference's
``dfa_scan_body`` final states.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_grep_tpu.models import aho as ref_aho
from distributed_grep_tpu.models import dfa as ref_dfa
from distributed_grep_tpu.ops import scan_jnp
from distributed_grep_tpu_torch.models import aho as port_aho
from distributed_grep_tpu_torch.models import dfa as port_dfa
from distributed_grep_tpu_torch.ops import dfa_scan
from distributed_grep_tpu_torch.ops.fdr_scan import pack_bits

ALPHABET = np.frombuffer(b"abcdefghlnox \n", np.uint8)
PATTERNS = ["hello", "h[ae]llo", "(fox|needle)", "ab+a"]


def _text_columns(seed: int, chunk: int, lanes: int) -> np.ndarray:
    """(chunk, lanes) columns of seeded letters and newlines with the
    patterns' matches planted, some across stride and word edges."""
    rng = np.random.default_rng(seed)
    data = rng.choice(ALPHABET, size=(chunk, lanes))
    for i, s in enumerate([b"hello fox", b"needle hallo abba abbba",
                           b"xab\nab", b"hello\n"]):
        for lane in range(i, lanes, 5):
            at = int(rng.integers(0, chunk - len(s)))
            data[at:at + len(s), lane] = np.frombuffer(s, np.uint8)
    return data


def _stripes(data_cl: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(data_cl.T))


def _as_words(packed) -> torch.Tensor:
    bits = np.unpackbits(np.asarray(packed), axis=1,
                         bitorder="little").astype(bool)
    return pack_bits(torch.from_numpy(bits))


def _ref_stride_words(data_cl: np.ndarray, pattern: str, k: int):
    st = ref_dfa.build_stride_table(ref_dfa.compile_dfa(pattern), k)
    return _as_words(scan_jnp.dfa_scan_stride(data_cl, st))


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("k", [2, 4])
def test_stride_plain_equals_reference(pattern, k):
    data = _text_columns(3, 64, 32)
    st = port_dfa.build_stride_table(port_dfa.compile_dfa(pattern), k)
    got = dfa_scan.dfa_stride_words_plain(_stripes(data), st)
    want = _ref_stride_words(data, pattern, k)
    assert torch.equal(got, want), (pattern, k)
    assert int(torch.count_nonzero(want.view(torch.int32)))
    # and K1's words on the same table
    k1 = dfa_scan.dfa_scan_words_plain(_stripes(data),
                                       port_dfa.compile_dfa(pattern))
    assert torch.equal(got, k1)


def _random_tables(seed: int):
    rng = np.random.default_rng(seed)
    atoms = ["a", "b", "n", "e", "ne", "[ab]", "[^a\n]", ".", "(a|ne)",
             "^a", "x"]
    for _ in range(10):
        pattern = "".join(atoms[rng.integers(0, len(atoms))]
                          + ["", "*", "+", "?"][rng.integers(0, 4)]
                          for _ in range(rng.integers(1, 4)))
        try:
            ref_t = ref_dfa.compile_dfa(pattern)
        except ref_dfa.RegexError:
            continue
        yield pattern, ref_t, port_dfa.compile_dfa(pattern)
    pats = [bytes(rng.choice(ALPHABET[:11], size=int(rng.integers(2, 6))))
            for _ in range(12)]
    yield "aho", ref_aho.compile_aho_corasick(pats), \
        port_aho.compile_aho_corasick(pats)


@pytest.mark.parametrize("seed", range(3))
def test_stride_tables_equal_reference(seed):
    seen = 0
    for label, ref_t, t in _random_tables(700 + seed):
        k = port_dfa.choose_stride(t)
        assert k == ref_dfa.choose_stride(ref_t), label
        if t.accept_eol.any():  # '$' accepts: stride 1 only
            assert k == 1
            continue
        for kk in (1, 2, 4):
            a = port_dfa.build_stride_table(t, kk)
            b = ref_dfa.build_stride_table(ref_t, kk)
            assert a.trans_k.dtype == b.trans_k.dtype == np.int32
            assert np.array_equal(a.trans_k, b.trans_k), (label, kk)
            assert np.array_equal(a.byte_to_cls, b.byte_to_cls)
            assert (a.k, a.n_classes, a.start, a.n_states) == (
                b.k, b.n_classes, b.start, b.n_states)
        seen += 1
    assert seen >= 5


def test_stride_plain_equals_reference_on_random_tables():
    data = _text_columns(9, 32, 32)
    for label, ref_t, t in _random_tables(711):
        if t.accept_eol.any():
            continue
        for k in (2, 4):
            got = dfa_scan.dfa_stride_words_plain(
                _stripes(data), port_dfa.build_stride_table(t, k))
            want = _as_words(scan_jnp.dfa_scan_stride(
                data, ref_dfa.build_stride_table(ref_t, k)))
            assert torch.equal(got, want), (label, k)


def test_choose_stride_rules():
    assert port_dfa.choose_stride(port_dfa.compile_dfa("hello")) in (2, 4)
    assert port_dfa.choose_stride(port_dfa.compile_dfa("hel+o$")) == 1
    pats = [bytes([b, b]) for b in range(1, 256) if b != 0x0A]
    bank = port_aho.compile_aho_corasick(pats)
    assert port_dfa.choose_stride(bank, max_cols=1 << 6) == 1
    assert port_dfa.choose_stride(bank, max_cols=1 << 6) == \
        ref_dfa.choose_stride(ref_aho.compile_aho_corasick(pats),
                              max_cols=1 << 6)


def test_accept_eol_and_bad_stride_raise():
    with pytest.raises(ValueError, match="next-byte"):
        port_dfa.build_stride_table(port_dfa.compile_dfa("ab$"), 2)
    with pytest.raises(ValueError, match=">= 1"):
        port_dfa.build_stride_table(port_dfa.compile_dfa("ab"), 0)
    one = port_dfa.build_stride_table(port_dfa.compile_dfa("ab$"), 1)
    assert one.k == 1


def test_stride_preserves_midstride_newline_attribution():
    """A match ending just before a '\\n' inside a stride keeps its exact
    offset (the reference's tests/test_ops.py case, here in 32 stripes
    of 32 bytes, the port's smallest layout)."""
    data = b"xxab\nyyyy\nzzab\nqqqq\n" * 8
    buf = np.frombuffer(data + b"\n" * (1024 - len(data)), np.uint8)
    stripes = torch.from_numpy(buf.reshape(32, 32).copy())
    table = port_dfa.compile_dfa("ab")
    got = dfa_scan.dfa_stride_words_plain(
        stripes, port_dfa.build_stride_table(table, 4))
    assert torch.equal(got, dfa_scan.dfa_scan_words_plain(stripes, table))
    want = _as_words(scan_jnp.dfa_scan_stride(
        stripes.numpy().T.copy(),
        ref_dfa.build_stride_table(ref_dfa.compile_dfa("ab"), 4)))
    assert torch.equal(got, want)
    # the ab's end at bytes 3 and 13 of each 20-byte group: stripe 0's
    # bits 3, 13 and 23
    assert int(got[0, 0]) & (1 << 3 | 1 << 13 | 1 << 23) == (
        1 << 3 | 1 << 13 | 1 << 23)


def _stride_kernel_walk(data_cl: np.ndarray, st) -> np.ndarray:
    """csrc/dfa.cu stride_kernel's arithmetic in numpy: the premultiplied
    packed entries, the combined class index, 32 / k strides a word."""
    k = st.k
    entries = dfa_scan.packed_stride_table(st).astype(np.uint64)
    cls = st.byte_to_cls.astype(np.uint64)
    chunk, lanes = data_cl.shape
    cols = st.n_classes ** k
    state = np.full(lanes, st.start * cols, dtype=np.uint64)
    out = np.zeros((chunk // 32, lanes), dtype=np.uint64)
    for w in range(chunk // 32):
        acc = np.zeros(lanes, np.uint64)
        for j in range(32 // k):
            idx = np.zeros(lanes, np.uint64)
            for i in range(k):
                idx = idx * np.uint64(st.n_classes) + cls[
                    data_cl[32 * w + k * j + i]]
            e = entries[state + idx]
            state = e >> np.uint64(k)
            acc |= (e & np.uint64((1 << k) - 1)) << np.uint64(k * j)
        out[w] = acc
    return out.astype(np.uint32)


@pytest.mark.parametrize("pattern", ["nee(dle|t)", "ab+a", "^d", "a.b|x"])
@pytest.mark.parametrize("k", [2, 4])
def test_stride_kernel_arithmetic_equals_plain(pattern, k):
    data = _text_columns(11, 96, 32)
    st = port_dfa.build_stride_table(port_dfa.compile_dfa(pattern), k)
    got = _stride_kernel_walk(data, st)
    assert np.array_equal(
        got, dfa_scan.dfa_stride_words_plain(_stripes(data), st).numpy())


def test_packed_stride_table_and_wrapper_checks():
    t = port_dfa.compile_dfa("nee(dle|t)")
    st = port_dfa.build_stride_table(t, 4)
    p = dfa_scan.packed_stride_table(st).astype(np.int64)
    cols = t.n_classes ** 4
    raw = st.trans_k.reshape(-1).astype(np.int64)
    assert np.array_equal(p >> 4, (raw >> 4) * cols)
    assert np.array_equal(p & 15, raw & 15)
    assert dfa_scan.stride_uses_shared_memory(st)
    stripes = torch.full((32, 64), ord("n"), dtype=torch.uint8)
    with pytest.raises(ValueError, match="a stride of 2 or 4"):
        dfa_scan.dfa_stride_words(stripes,
                                  port_dfa.build_stride_table(t, 1))
    with pytest.raises(ValueError, match="unsupported device"):
        dfa_scan.dfa_stride_words(stripes.to("meta"), st)
    with pytest.raises(ValueError, match="chunk % 32"):
        dfa_scan.dfa_stride_words(torch.zeros((32, 40), dtype=torch.uint8),
                                  st)
    a = dfa_scan.device_stride_table(st, torch.device("cpu"))
    assert dfa_scan.device_stride_table(st, torch.device("cpu")) is a
    before = dfa_scan.stride.launches
    dfa_scan.dfa_stride_words(stripes, st)
    assert dfa_scan.stride.launches == before  # the plain version


def test_k1_exit_states_equal_reference_final_states():
    data = _text_columns(5, 64, 32)
    for pattern in ("nee(dle|t)", "ab+a$", "^h"):
        ref_t = ref_dfa.compile_dfa(pattern)
        init = jnp.full((32,), ref_t.start, dtype=jnp.int32)
        final, _match = scan_jnp.dfa_scan_body(
            jnp.asarray(data),
            jnp.asarray(ref_t.trans.astype(np.int32).reshape(-1)),
            jnp.asarray(ref_t.byte_to_cls.astype(np.int32)),
            jnp.asarray(ref_t.accept), jnp.asarray(ref_t.accept_eol),
            init, ref_t.n_classes)
        words, exits = dfa_scan.dfa_scan_words(
            _stripes(data), port_dfa.compile_dfa(pattern), with_exits=True)
        assert exits.dtype == torch.int32
        assert np.array_equal(exits.numpy(), np.asarray(final)), pattern
        assert torch.equal(words, dfa_scan.dfa_scan_words_plain(
            _stripes(data), port_dfa.compile_dfa(pattern)))
