"""The table-DFA kernel's plain version vs the reference's XLA device scan.

``ops/dfa_scan.dfa_scan_words_plain`` gives words bit-identical (tolerance
0: integer words) to ``distributed_grep_tpu/ops/scan_jnp.py:
_dfa_scan_core`` once the reference's packed bits, (chunk, lanes // 8)
uint8 with bit k of byte g for lane 8g + k, are mapped to the port's
(chunk // 32, lanes) words: over seeded ``compile_dfa`` tables of random
regexes ('$' accepts among them), Aho-Corasick banks and the stripe-tail
rule (the stripe's last byte counts as followed by '\\n'), at small
shapes.  The kernel's own arithmetic (csrc/dfa.cu: the byte-indexed
slots and the packed entries, the funnel-shift gathers, the four-byte
newline bits, the next-newline bit across words) is walked in numpy and
held to the plain version, and so is its speculative scheme
(``speculative_walk``: sub-stripes walked from the start state, then the
fix-up rounds; ``launch_plan`` says how many), on every sub-stripe count
the launcher takes, against the plain version and the reference; the CUDA
kernel itself is held to the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).
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


_MASK = (1 << 30) - 1
_U32 = 0xFFFFFFFF


def _newline_bits4(x: np.ndarray) -> np.ndarray:
    """csrc/dfa.cu newline_bits4: bit i set iff byte i of x is '\\n' (a
    zero-byte test of x ^ 0x0A0A0A0A, then one multiply)."""
    v = x ^ 0x0A0A0A0A
    z = ~(((v & 0x7F7F7F7F) + 0x7F7F7F7F) | v) & 0x80808080
    return (((z >> 7) * 0x00204081 & _U32) >> 21) & 0xF


def _brev(x: np.ndarray) -> np.ndarray:
    out = np.zeros_like(x)
    for i in range(32):
        out |= ((x >> i) & 1) << (31 - i)
    return out


def _kernel_walk(data_cl: np.ndarray, table, branch: str):
    """csrc/dfa.cu's word step in numpy, one stripe a lane from the start:
    branch "bytes" (ByteWalker: the next slot at [slot << 8 | byte], the
    accept and end-of-line flags in the slot's low bits, gathered by a
    funnel shift to the right) or the class map and packed entries
    (ClassWalker: flags in bits 31 and 30 carried with the row offset,
    gathered by a funnel shift to the left and a bit reverse); newline
    bits four bytes at a time.  (words, exit states)."""
    chunk, lanes = data_cl.shape
    eol_table = bool(table.accept_eol.any())
    if branch == "bytes":
        bt = dfa_scan.packed_byte_table(table)
        entries = bt.entries.astype(np.int64)
        state = np.full(lanes, bt.slot_of_state[table.start], np.int64)
    else:  # rows in bfs_order
        entries = dfa_scan.packed_table(table).astype(np.int64)
        cls = table.byte_to_cls.astype(np.int64)
        order = dfa_scan.bfs_order(table)
        row = int(np.flatnonzero(order == table.start)[0])
        state = np.full(lanes, row * table.n_classes, np.int64)
    out = np.zeros((chunk // 32, lanes), dtype=np.int64)
    quads = data_cl.astype(np.int64).reshape(chunk // 4, 4, lanes)
    quads = (quads << (8 * np.arange(4))[None, :, None]).sum(axis=1)
    for w in range(chunk // 32):
        acc = np.zeros(lanes, np.int64)
        eol = np.zeros(lanes, np.int64)
        for t in range(32):
            b = data_cl[32 * w + t].astype(np.int64)
            if branch == "bytes":
                state = entries[(state << 8) | b]
                acc = (acc >> 1) | ((state & 1) << 31)
                eol = (eol >> 1) | (((state >> 1) & 1) << 31)
            else:
                state = entries[(state & _MASK) + cls[b]]
                acc = ((acc << 1) & _U32) | (state >> 31)
                eol = ((eol << 1) & _U32) | ((state >> 30) & 1)
        if branch != "bytes":
            acc, eol = _brev(acc), _brev(eol)
        word = acc
        if eol_table:
            nl = np.zeros(lanes, np.int64)
            for j in range(8):
                nl |= _newline_bits4(quads[8 * w + j]) << (4 * j)
            nxt = ((data_cl[32 * w + 32] == 10).astype(np.int64)
                   if 32 * w + 32 < chunk else np.ones(lanes, np.int64))
            word = acc | (eol & ((nl >> 1) | (nxt << 31)))
        out[w] = word
    exits = (bt.state_of_slot[state] if branch == "bytes"
             else order[(state & _MASK) // table.n_classes])
    return out.astype(np.uint32), exits.astype(np.int32)


@pytest.mark.parametrize("pattern", ["nee(dle|t)", "e$", "^$", "(ab)*$",
                                     "^d", "a.b|x$"])
def test_kernel_arithmetic_equals_plain(pattern):
    data = _columns(11, 96, 32)
    t = port_dfa.compile_dfa(pattern)
    want, want_exits = dfa_scan.dfa_scan_words_plain(
        torch.from_numpy(np.ascontiguousarray(data.T)), t, with_exits=True)
    for branch in ("bytes", "shared"):
        got, exits = _kernel_walk(data, t, branch)
        assert np.array_equal(got, want.numpy()), branch
        assert np.array_equal(exits, want_exits.numpy()), branch


def test_newline_bits_of_every_byte_pattern():
    """The four-byte newline test is exact: every 4-byte pattern of
    '\\n', 0x0A's neighbours and 0x8A (the high bit set)."""
    vals = np.array([0x0A, 0x0B, 0x09, 0x8A, 0x00, 0xFF, 0x0A ^ 0x80],
                    np.int64)
    quad = np.stack(np.meshgrid(*[vals] * 4, indexing="ij"),
                    axis=-1).reshape(-1, 4)
    x = (quad << (8 * np.arange(4))).sum(axis=1)
    want = ((quad == 0x0A) << np.arange(4)).sum(axis=1)
    assert np.array_equal(_newline_bits4(x), want)


class _ByteModel:
    """ByteWalker's unit step: one byte, the state a slot."""

    def __init__(self, table):
        bt = dfa_scan.packed_byte_table(table)
        self.entries = bt.entries.astype(np.int64)
        self.start = int(bt.slot_of_state[table.start])
        self.state_of_slot = bt.state_of_slot
        self.eol = bool(table.accept_eol.any())
        self.unit, self.keep = 1, 0

    def step(self, s, b):
        s = self.entries[(s << 8) | b[0]]
        return s, s & 1, (s >> 1) & 1

    def norm(self, s):
        return s

    def exit(self, s):
        return int(self.state_of_slot[s])


class _ClassModel:
    """ClassWalker's unit step: one byte, the state a row offset (rows in
    ``bfs_order``) carried with its entry's flags."""

    def __init__(self, table):
        self.entries = dfa_scan.packed_table(table).astype(np.int64)
        self.cls = table.byte_to_cls.astype(np.int64)
        self.order = dfa_scan.bfs_order(table)
        row = int(np.flatnonzero(self.order == table.start)[0])
        self.start = row * table.n_classes
        self.n_classes = table.n_classes
        self.eol = bool(table.accept_eol.any())
        self.unit, self.keep = 1, 0

    def step(self, s, b):
        e = self.entries[(s & _MASK) + self.cls[b[0]]]
        return e, e >> 31, (e >> 30) & 1

    def norm(self, s):
        return s & _MASK

    def exit(self, s):
        return int(self.order[(s & _MASK) // self.n_classes])


class _StrideModel:
    """K2's unit step: k bytes, the column a sum of the premultiplied
    class maps, the state a row offset."""

    def __init__(self, st):
        self.k = st.k
        self.entries = dfa_scan.packed_stride_table(st).astype(np.int64)
        self.maps = dfa_scan.stride_class_maps(st).astype(np.int64)
        row = int(np.flatnonzero(dfa_scan.bfs_order(st) == st.start)[0])
        self.start = row * st.n_classes ** st.k
        self.eol = False
        self.unit = self.keep = st.k

    def step(self, s, b):
        col = sum(self.maps[256 * i + b[i]] for i in range(self.k))
        e = self.entries[s + col]
        return e >> self.k, e & ((1 << self.k) - 1), e * 0

    def norm(self, s):
        return s

    def exit(self, s):
        return int(s)


def _walk_words(model, row_bytes, w0, w1, s, words, nl_after):
    """The speculative walk of words [w0, w1) of the stripes in
    ``row_bytes`` (chunk, n) from states ``s`` (n,): each word's bits into
    ``words`` [w]; the states after the last byte."""
    u = model.unit
    for w in range(w0, w1):
        acc = np.zeros(s.shape, np.int64)
        eol = np.zeros(s.shape, np.int64)
        for t in range(0, 32, u):
            s, a, e = model.step(s, row_bytes[32 * w + t:32 * w + t + u]
                                 .astype(np.int64))
            acc |= a << t
            eol |= e << t
        if model.eol:
            acc |= eol & nl_after[w]
        words[w] = acc
    return s


def speculative_walk(data_cl: np.ndarray, model, n_sub: int):
    """csrc/dfa.cu's scheme in numpy: each stripe cut into ``n_sub``
    sub-stripes of whole words (the first ``rem`` one word longer), each
    walked from the start state; then rounds in which every sub-stripe
    whose entry (its predecessor's exit as the round began) differs from
    the state its words came from is walked again from that entry beside
    a walk from the old state, its words rewritten until the two states
    are equal after a unit (then the old exit stands) or to its end (then
    the new exit is handed on).  Returns (words, exit states, bytes
    re-walked, the most rounds a stripe took)."""
    chunk, lanes = data_cl.shape
    n_words = chunk // 32
    base, rem = divmod(n_words, n_sub)
    bounds = []
    for j in range(n_sub):
        w0 = j * base + min(j, rem)
        bounds.append((w0, w0 + base + (j < rem)))
    data = data_cl.astype(np.int64)
    nl = (data == 10).astype(np.int64)
    # each word's '$' factor: the next byte is '\n' (past the stripe, yes)
    nxt = np.ones((chunk, lanes), np.int64)
    nxt[:-1] = nl[1:]
    weights = np.int64(1) << np.arange(32, dtype=np.int64)
    nl_after = (nxt.reshape(n_words, 32, lanes)
                * weights[None, :, None]).sum(axis=1)
    words = np.zeros((n_words, lanes), np.int64)
    exits = np.zeros((n_sub, lanes), np.int64)
    for j, (w0, w1) in enumerate(bounds):
        s = np.full(lanes, model.start, np.int64)
        exits[j] = _walk_words(model, data, w0, w1, s, words, nl_after)
    steps = most = 0
    u = model.unit
    for lane in range(lanes):
        row = data[:, lane]
        cur = [model.start] * n_sub
        rounds = 0
        while True:
            want = [model.start] + [int(x) for x in exits[:-1, lane]]
            need = [j for j in range(1, n_sub)
                    if model.norm(want[j]) != model.norm(cur[j])]
            if not need:
                break
            rounds += 1
            for j in need:
                sn, so = want[j], cur[j]
                w0, w1 = bounds[j]
                met = False
                for w in range(w0, w1):
                    acc = eol = 0
                    for t in range(0, 32, u):
                        b = row[32 * w + t:32 * w + t + u]
                        sn, a, e = model.step(sn, b)
                        so, _a, _e = model.step(so, b)
                        acc |= int(a) << t
                        eol |= int(e) << t
                        steps += u
                        if model.norm(sn) == model.norm(so):
                            met = True
                            break
                    bits = acc | (eol & int(nl_after[w, lane])
                                  if model.eol else 0)
                    if met:
                        keep = (1 << min(t + model.keep, 32)) - 1
                        words[w, lane] = (bits & keep) | (
                            int(words[w, lane]) & ~keep & _U32)
                        break
                    words[w, lane] = bits
                if not met:
                    exits[j, lane] = sn
                cur[j] = want[j]
        most = max(most, rounds)
    out_exits = np.array([model.exit(int(x)) for x in exits[-1]], np.int32)
    return words.astype(np.uint32), out_exits, steps, most


def _models(table):
    """(branch, unit model) of each of K1's table layouts ``table`` takes."""
    out = [("shared", _ClassModel(table))]
    if dfa_scan.packed_byte_table(table) is not None:
        out.insert(0, ("bytes", _ByteModel(table)))
    return out


def _ref_exits(data_cl: np.ndarray, ref_t) -> np.ndarray:
    """The reference's ``dfa_scan_body`` final states, one a stripe."""
    init = jnp.full((data_cl.shape[1],), ref_t.start, dtype=jnp.int32)
    final, _match = scan_jnp.dfa_scan_body(
        jnp.asarray(data_cl),
        jnp.asarray(ref_t.trans.astype(np.int32).reshape(-1)),
        jnp.asarray(ref_t.byte_to_cls.astype(np.int32)),
        jnp.asarray(ref_t.accept), jnp.asarray(ref_t.accept_eol),
        init, ref_t.n_classes)
    return np.asarray(final)


def _draw_tables(rng, n: int):
    """(pattern, reference table, port table): ``n`` random regexes ('$'
    accepts among them) and two Aho-Corasick banks."""
    out = []
    while len(out) < n:
        pattern = _random_regex(rng)
        try:
            ref_t = ref_dfa.compile_dfa(pattern)
        except ref_dfa.RegexError:
            continue
        out.append((pattern, ref_t, port_dfa.compile_dfa(pattern)))
    pats = [bytes(rng.choice(ALPHABET[:8], size=int(rng.integers(2, 6))))
            for _ in range(10)]
    for budget in (6, 400):
        for ref_t, t in zip(
                ref_aho.compile_aho_corasick_banks(
                    pats, max_states_per_bank=budget),
                port_aho.compile_aho_corasick_banks(
                    pats, max_states_per_bank=budget)):
            out.append((f"aho bank <= {budget}", ref_t, t))
    return out


@pytest.mark.parametrize("n_sub", [1, 2, 4, 8])
@pytest.mark.parametrize("seed", range(3))
def test_speculative_walk_equals_plain_and_reference(seed, n_sub):
    """The scheme's words and exit states equal the plain version's (on
    pitched stripes) and the reference's ``_dfa_scan_core`` words and
    ``dfa_scan_body`` final states, on both table layouts; a '$' accept
    at a sub-stripe's last byte whose '\\n' is the next sub-stripe's
    first byte keeps its bit."""
    rng = np.random.default_rng(300 + seed)
    chunk, lanes = 256, 32
    data = _columns(seed, chunk, lanes)
    edge = chunk // max(n_sub, 2)  # sub-stripe 1's first byte (S > 1)
    data[edge - 3:edge, 2] = np.frombuffer(b"xae", np.uint8)
    data[edge, 2] = ord("\n")
    pitched = torch.full((lanes, chunk + 32), 10, dtype=torch.uint8)
    pitched[:, :chunk] = torch.from_numpy(np.ascontiguousarray(data.T))
    tables = _draw_tables(rng, 6)
    tables.append(("ae$", ref_dfa.compile_dfa("ae$"),
                   port_dfa.compile_dfa("ae$")))
    for pattern, ref_t, t in tables:
        want = _ref_words(data, ref_t)
        want_exits = _ref_exits(data, ref_t)
        got_plain, plain_exits = dfa_scan.dfa_scan_words(
            pitched[:, :chunk], t, with_exits=True)
        assert torch.equal(got_plain, want), pattern
        assert np.array_equal(plain_exits.numpy(), want_exits), pattern
        for branch, model in _models(t):
            words, exits, steps, rounds = speculative_walk(data, model,
                                                           n_sub)
            assert np.array_equal(words, want.numpy()), (pattern, branch)
            assert np.array_equal(exits, want_exits), (pattern, branch)
            if n_sub == 1:
                assert steps == rounds == 0
        if pattern == "ae$":
            assert int(want[edge // 32 - 1, 2]) >> 31 & 1


@pytest.mark.parametrize("chunk,n_sub", [(160, 2), (160, 4), (96, 2),
                                         (224, 4), (224, 8)])
def test_speculative_walk_uneven_splits(chunk, n_sub):
    """Words that do not split evenly (5 words into 4: 2, 1, 1, 1; 7 into
    8 is refused by the launcher, 7 into 4 is 2, 2, 2, 1)."""
    rng = np.random.default_rng(chunk + n_sub)
    data = _columns(chunk, chunk, 64)
    for pattern, ref_t, t in _draw_tables(rng, 4):
        want = _ref_words(data, ref_t)
        want_exits = _ref_exits(data, ref_t)
        for branch, model in _models(t):
            if n_sub > chunk // 32:
                with pytest.raises(ValueError, match="refused"):
                    dfa_scan.launch_plan(t, 64, chunk, n_sub=n_sub)
                continue
            words, exits, _steps, _rounds = speculative_walk(data, model,
                                                             n_sub)
            assert np.array_equal(words, want.numpy()), (pattern, branch)
            assert np.array_equal(exits, want_exits), (pattern, branch)


@pytest.mark.parametrize("n_sub", [2, 4, 8])
def test_speculative_walk_that_never_meets(n_sub):
    """'^a*b' over stripes of 'x' then 'a's and no '\\n': the walk from the
    start state and the true one (past the line's start) never meet, so
    every round re-walks a whole sub-stripe and hands its exit on: n_sub -
    1 rounds, and still the reference's words and exit states."""
    chunk, lanes = 256, 32
    data = np.full((chunk, lanes), ord("a"), dtype=np.uint8)
    data[0] = ord("x")
    data[100, 5] = ord("b")
    data[3:6, 9] = np.frombuffer(b"\nab", np.uint8)  # one stripe meets
    ref_t = ref_dfa.compile_dfa("^a*b")
    t = port_dfa.compile_dfa("^a*b")
    want = _ref_words(data, ref_t)
    want_exits = _ref_exits(data, ref_t)
    assert int(want[0, 9]) >> 5 & 1  # '\nab' matches at its 'b'
    for branch, model in _models(t):
        words, exits, steps, rounds = speculative_walk(data, model, n_sub)
        assert np.array_equal(words, want.numpy()), branch
        assert np.array_equal(exits, want_exits), branch
        assert rounds == n_sub - 1, branch
        assert steps >= (lanes - 1) * (n_sub - 1) * chunk // n_sub, branch


def test_launch_plan_and_budget():
    """launch_plan mirrors csrc/dfa.cu's choice: the fewest rounds of lane
    groups times the longest sub-stripe, the smaller count on a tie; the
    byte-indexed table where the slots fit 256, else the class map and
    entries in shared memory where they fit SMEM_TABLE_BYTES, else the
    L2 (with as much of the table's head as fits in shared memory);
    forced counts and branches, and their refusals."""
    t = port_dfa.compile_dfa("nee(dle|t)")
    assert dfa_scan.launch_plan(t, 65536, 1024) == (2, "bytes")
    assert dfa_scan.launch_plan(t, 64, 160) == (4, "bytes")
    assert dfa_scan.launch_plan(t, 4128, 96) == (2, "bytes")
    assert dfa_scan.launch_plan(t, 32, 32) == (1, "bytes")
    assert dfa_scan.launch_plan(t, 65536, 1024, sms=16) == (1, "bytes")
    assert dfa_scan.launch_plan(t, 65536, 1024, n_sub=8,
                                branch="global") == (8, "global")
    assert dfa_scan.launch_plan(t, 65536, 1024, n_sub=32) == (32, "bytes")
    for kw in ({"n_sub": 3}, {"n_sub": 64}, {"branch": "tiles"}):
        with pytest.raises(ValueError):
            dfa_scan.launch_plan(t, 65536, 1024, **kw)
    assert dfa_scan.SMEM_TABLE_BYTES == dfa_scan.SMEM_BYTES - 16
    # a table of 22,500 states and 2 classes: past 256 slots, its 180,256
    # bytes of class map and entries in shared memory; twice as many
    # states pass the budget
    for n, plan in ((22_500, (2, "shared")), (45_000, (2, "global"))):
        synth = port_dfa.DfaTable(
            trans=(np.arange(2 * n).reshape(n, 2) % n).astype(np.uint16),
            byte_to_cls=(np.arange(256) % 2).astype(np.uint8),
            accept=np.arange(n) % 7 == 0, accept_eol=np.zeros(n, bool),
            start=0, pattern="synthetic")
        assert dfa_scan.packed_byte_table(synth) is None
        assert dfa_scan.launch_plan(synth, 65536, 1024) == plan
        with pytest.raises(ValueError, match="refused"):
            dfa_scan.launch_plan(synth, 65536, 1024, branch="bytes")
    rng = np.random.default_rng(1)
    big = port_aho.compile_aho_corasick(
        [bytes(rng.integers(97, 123, size=8)) for _ in range(400)])
    assert dfa_scan.launch_plan(big, 65536, 1024) == (2, "global")


def test_bfs_order_puts_the_shallow_states_first():
    """The packed rows come in breadth-first order from the start state
    (the head the global branch keeps in shared memory): a table of
    ``compile_dfa`` is numbered so already; an Aho-Corasick bank, numbered
    as its trie was built, is reordered, its root's children first, and
    the reordered entries walk to the same words."""
    assert np.array_equal(dfa_scan.bfs_order(port_dfa.compile_dfa(
        "nee(dle|t)$")), np.arange(9))
    bank = port_aho.compile_aho_corasick([b"needle", b"nee", b"at", b"tea"])
    order = dfa_scan.bfs_order(bank)
    assert sorted(order.tolist()) == list(range(bank.n_states))
    depth = {0: 0}
    for s in order[1:]:  # each state's depth: one more than a parent's
        parents = [int(p) for p in order if int(p) in depth
                   and int(s) in bank.trans[int(p)].tolist()]
        depth[int(s)] = min(depth[p] for p in parents) + 1
    assert [depth[int(s)] for s in order] == sorted(depth.values())
    assert not np.array_equal(order, np.arange(bank.n_states))
    data = _columns(4, 96, 32)
    got, exits = _kernel_walk(data, bank, "shared")
    want, want_exits = dfa_scan.dfa_scan_words_plain(
        torch.from_numpy(np.ascontiguousarray(data.T)), bank, True)
    assert np.array_equal(got, want.numpy())
    assert np.array_equal(exits, want_exits.numpy())


def test_argtypes_match_the_c_interface():
    """The ctypes parameters bound to csrc/dfa.cu's two entry points are as
    many as the C signatures declare, pointers where they take pointers
    (a pointer passed as an int would be cut to 32 bits)."""
    import ctypes
    import re

    from distributed_grep_tpu_torch.ops import _build

    text = (_build.CSRC / "dfa.cu").read_text()
    for name, types in (("dgrep_dfa_scan", dfa_scan.K1_ARGTYPES),
                        ("dgrep_dfa_stride_scan", dfa_scan.K2_ARGTYPES)):
        params = re.search(rf'extern "C" int {name}\(([^)]*)\)',
                           text).group(1).split(",")
        assert len(params) == len(types), name
        for param, typ in zip(params, types):
            pointer = "*" in param
            assert pointer == (typ in (ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_int))), (
                name, param)


def test_packed_byte_table():
    """The byte-indexed table folds the class map in; a slot's bit 0 is
    its state's accept flag and bit 1 (with '$' accepts) its accept_eol
    flag; more than 256 slots take no byte table."""
    for pattern in ("nee(dle|t)$", "nee(dle|t)", "^(of|the) [a-z]+$"):
        t = port_dfa.compile_dfa(pattern)
        bt = dfa_scan.packed_byte_table(t)
        slot = bt.slot_of_state.astype(np.int64)
        assert np.array_equal(slot & 1, t.accept.astype(np.int64))
        if t.accept_eol.any():
            assert np.array_equal((slot >> 1) & 1,
                                  t.accept_eol.astype(np.int64))
        assert np.array_equal(bt.state_of_slot[slot], np.arange(t.n_states))
        rows = bt.entries.reshape(-1, 256).astype(np.int64)
        assert rows.shape[0] == bt.state_of_slot.size <= 256
        nxt = t.trans.astype(np.int64)[:, t.byte_to_cls.astype(np.int64)]
        assert np.array_equal(rows[slot], slot[nxt])
        assert dfa_scan.packed_byte_table(t) is bt  # kept on the table
    rng = np.random.default_rng(2)
    bank = port_aho.compile_aho_corasick(
        [bytes(rng.integers(97, 123, size=6)) for _ in range(80)])
    assert bank.n_states > 256 and dfa_scan.packed_byte_table(bank) is None


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
