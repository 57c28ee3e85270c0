"""The sub-stripe warm-up of the four stripe kernels, on the CPU.

csrc/shift_and.cu, csrc/approx.cu, csrc/pairset.cu and
csrc/shift_and_swar.cu cut each (lanes, chunk) stripe into sub-stripes,
as many as the card's size asks for, so any word boundary may start one;
a sub-stripe starting at byte c0 > 0 starts ``warmup_words(model)`` words
early from the stripe-head state (pairset: seeds its previous byte with
byte c0 - 1) and stores only its own words.  That is exact iff a scan
started there gives the full scan's words from c0 on.  Here, for seeded
random models (Shift-And m = 1-32 with classes, '.', -i and the
rare-class filter; approx k = 1-3 with m up to 32 and -i; SWAR m = 1-8;
pairset sets of both orientations, with -i) and every word boundary c0:

* the plain version on the pitched window ``stripes[:, c0 - 32W:]`` gives
  the full scan's words from c0 on (the kernel's thread, word for word;
  every fourth boundary, for time);
* a numpy scan of the same recurrence started at any byte c0 - b with b >=
  the minimal warm-up (m - 1 bytes for Shift-And, m + k - 1 for approx)
  gives the full scan's match bits from c0 on, and its words equal the
  plain version's;
* b one byte short loses a match planted to start exactly there: the
  invariant test can fail (pairset: a '\\n' seed in place of byte c0 - 1
  loses a pair planted across c0).

Tolerance 0 everywhere: integer words.  Also the engine's routing (the
Shift-And, approx, pairset and SWAR routes hand their wrappers stripes and
transpose nothing; NFA and FDR get columns, one transpose per segment),
the wrappers' layout checks and the slope harness's stripe windows.  The
kernels themselves meet the same cases on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 2).
"""

import numpy as np
import pytest
import torch

from distributed_grep_tpu_torch.models import approx as port_ax
from distributed_grep_tpu_torch.models import pairset as port_ps
from distributed_grep_tpu_torch.models import shift_and as port_sa
from distributed_grep_tpu_torch.ops import (
    approx_scan,
    cuda_scan,
    device_scan,
    fdr_scan,
    layout,
    nfa_scan,
    pairset_scan,
    swar_scan,
)
from distributed_grep_tpu_torch.ops.engine import GrepEngine
from distributed_grep_tpu_torch.utils import slope

NL = 0x0A
LANES, CHUNK = 64, 576  # 18 words
STARTS = list(range(32, CHUNK, 32))  # every word boundary after the head
ALPHA = "abcxyz"


def _rand_pattern(rng, m: int) -> str:
    """m symbols over ALPHA: letters, two-letter classes and '.'."""
    out = []
    for _ in range(m):
        r = int(rng.integers(0, 6))
        if r == 0:
            out.append("[" + "".join(sorted(set(
                rng.choice(list(ALPHA), size=2).tolist()))) + "]")
        elif r == 1:
            out.append(".")
        else:
            out.append(str(rng.choice(list(ALPHA))))
    return "".join(out)


def _sample(rng, sym_ranges) -> bytes:
    """One string the symbols match: a random byte of a random range each."""
    out = bytearray()
    for ranges in sym_ranges:
        lo, hi = ranges[int(rng.integers(0, len(ranges)))]
        out.append(int(rng.integers(lo, hi + 1)))
    return bytes(out)


def _errorful(rng, s: bytes, k: int) -> bytes:
    """``s`` after 0..k random substitutions, insertions or deletions."""
    b = bytearray(s)
    for _ in range(int(rng.integers(0, k + 1))):
        op, p = int(rng.integers(0, 3)), int(rng.integers(0, len(b)))
        ch = ord(str(rng.choice(list(ALPHA))))
        if op == 0:
            b[p] = ch
        elif op == 1:
            b.insert(p, ch)
        elif len(b) > 1:
            del b[p]
    return bytes(b)


def _stripes(rng, samples: list[bytes], warm: int) -> np.ndarray:
    """(LANES, CHUNK) stripes of ALPHA text (upper case too) with a few
    '\\n's; at every word boundary c0, a sample ending d = 0..warm + 2
    bytes after c0 on lane (d + 3 * c0 // 32) % LANES (so across c0 for
    the smaller d), and '\\n' at c0 - warm - 1, c0 - warm and c0 - 1 (where
    they exist) on three other lanes; more samples at random places."""
    alpha = np.frombuffer((ALPHA + ALPHA.upper() + "\n").encode(), np.uint8)
    arr = rng.choice(alpha, size=(LANES, CHUNK)).astype(np.uint8)
    for _ in range(LANES * CHUNK // 80):
        s = samples[int(rng.integers(0, len(samples)))]
        lane, at = int(rng.integers(0, LANES)), int(rng.integers(0, CHUNK))
        s = s[: CHUNK - at]
        arr[lane, at : at + len(s)] = np.frombuffer(s, np.uint8)
    for c0 in STARTS:
        for d in range(warm + 3):
            s = samples[d % len(samples)]
            end = min(CHUNK - 1, c0 + d)
            s = s[max(0, len(s) - end - 1):]
            arr[(d + 3 * c0 // 32) % LANES, end + 1 - len(s) : end + 1] = \
                np.frombuffer(s, np.uint8)
        for i, at in enumerate((c0 - warm - 1, c0 - warm, c0 - 1)):
            if at >= 0:
                arr[(3 * c0 // 32 + warm + 3 + i) % LANES, at] = NL
    return arr


def _np_shift_and(arr: np.ndarray, model, start: int) -> np.ndarray:
    """Match bits (lanes, chunk) of the Shift-And recurrence started from
    state 0 at byte ``start`` (False before it)."""
    b = model.b_table.astype(np.uint64)
    mb = np.uint64(int(model.match_bit))
    s = np.zeros(arr.shape[0], np.uint64)
    hit = np.zeros(arr.shape, bool)
    for c in range(start, arr.shape[1]):
        s = ((s << np.uint64(1)) | np.uint64(1)) & b[arr[:, c]]
        hit[:, c] = (s & mb) != 0
    return hit


def _np_approx(arr: np.ndarray, model, start: int) -> np.ndarray:
    """Match bits (lanes, chunk) of the Wu-Manber rows started from the
    seeds at byte ``start`` (False before it)."""
    b = model.base.b_table.astype(np.uint64)
    mb = np.uint64(int(model.match_bit))
    one, m32 = np.uint64(1), np.uint64(0xFFFFFFFF)
    seeds = [np.uint64(s) for s in model.seeds]
    rows = [np.full(arr.shape[0], s, np.uint64) for s in seeds]
    hit = np.zeros(arr.shape, bool)
    for c in range(start, arr.shape[1]):
        byte = arr[:, c]
        bb, nl = b[byte], byte == NL
        new = [((rows[0] << one) | one) & bb]
        for j in range(1, model.k + 1):
            new.append(((((rows[j] << one) | one) & bb) | rows[j - 1]
                        | (rows[j - 1] << one) | (new[j - 1] << one)
                        | seeds[j]) & m32)
        rows = [np.where(nl, seeds[j], new[j]) for j in range(model.k + 1)]
        hit[:, c] = (rows[model.k] & mb) != 0
    return hit


def _words(hit: np.ndarray, match_bit: int | None) -> np.ndarray:
    """(chunk // 32, lanes) words of per-byte match bits: exact bits, or
    the coarse word (the match bit where any byte of the word matched)."""
    w = hit.T.reshape(-1, 32, hit.shape[0])
    if match_bit is not None:
        return (w.any(axis=1) * match_bit).astype(np.uint32)
    return (w.astype(np.uint64) << np.arange(32, dtype=np.uint64)[None, :, None]
            ).sum(axis=1).astype(np.uint32)


def _sa_models(seed: int) -> list:
    """Seeded random Shift-And models, m = 1-32, with -i and filters."""
    rng = np.random.default_rng(seed)
    out = []
    for m in (1, 2, 3, 7, 16, 31, 32, int(rng.integers(4, 30))):
        ic = bool(rng.integers(0, 3) == 0)
        full = port_sa.try_compile_shift_and(_rand_pattern(rng, m), ic)
        assert full is not None and full.length == m
        out.append((full, full))
        filt = port_sa.filtered_for_device(full)
        if filt is not None:
            out.append((filt, full))
    out.append((port_sa.try_compile_shift_and("volcano"),) * 2)
    out.append((port_sa.filtered_for_device(out[-1][0]), out[-1][0]))
    return out


def _ax_models(seed: int) -> list:
    """Seeded random approx models: k = 1-3, m up to 32 (m + k - 1 up to
    34: two warm-up words), with -i."""
    rng = np.random.default_rng(seed)
    out = []
    for k, m in ((1, 2), (1, 8), (2, 17), (3, 29), (3, 30), (3, 32), (2, 32),
                 (1, 32), (int(rng.integers(1, 4)), int(rng.integers(5, 33)))):
        ic = bool(rng.integers(0, 3) == 0)
        model = port_ax.try_compile_approx(_rand_pattern(rng, m), k, ic)
        assert model is not None
        out.append(model)
    return out


def test_warmup_words():
    for m in range(1, 33):
        model = port_sa.try_compile_shift_and("a" * m)
        assert cuda_scan.warmup_words(model) == (0 if m == 1 else 1)
        for k in range(1, min(m, 4)):
            ax = port_ax.try_compile_approx("a" * m, k)
            need = m + k - 1
            w = approx_scan.warmup_words(ax)
            assert w * 32 >= need > (w - 1) * 32
    assert approx_scan.warmup_words(port_ax.try_compile_approx("a" * 32, 3)) == 2


@pytest.mark.parametrize("seed", range(4))
def test_shift_and_warmup_invariant(seed):
    rng = np.random.default_rng(100 + seed)
    for model, full in _sa_models(seed):
        need = model.length - 1  # minimal warm-up in bytes
        w = cuda_scan.warmup_words(model)
        arr = _stripes(rng, [_sample(rng, full.sym_ranges) for _ in range(8)],
                       w * 32)
        data = torch.from_numpy(arr)
        hit = _np_shift_and(arr, model, 0)
        assert hit.any(), model.pattern
        for coarse in (True, False):
            mb = int(model.match_bit) if coarse else None
            whole = cuda_scan.shift_and_scan_words_plain(data, model, coarse)
            np.testing.assert_array_equal(whole.numpy(), _words(hit, mb))
            for c0 in STARTS[w::4]:
                win = data[:, c0 - 32 * w:]  # pitched: stride(0) == CHUNK
                assert win.stride(0) == CHUNK
                got = cuda_scan.shift_and_scan_words_plain(win, model, coarse)
                np.testing.assert_array_equal(got[w:].numpy(),
                                              whole[c0 // 32:].numpy())
        for c0 in STARTS:
            late = _np_shift_and(arr, model, c0 - need)
            np.testing.assert_array_equal(late[:, c0:], hit[:, c0:])


@pytest.mark.parametrize("seed", range(3))
def test_approx_warmup_invariant(seed):
    rng = np.random.default_rng(200 + seed)
    for model in _ax_models(seed):
        need = model.length + model.k - 1
        w = approx_scan.warmup_words(model)
        samples = [_errorful(rng, _sample(rng, model.base.sym_ranges), model.k)
                   for _ in range(6)]
        for _ in range(2):  # k insertions after two bytes: m + k long
            b = bytearray(_sample(rng, model.base.sym_ranges))
            for _ in range(model.k):
                b.insert(int(rng.integers(2, len(b) + 1)), ord("#"))
            samples.append(bytes(b))
        arr = _stripes(rng, samples, w * 32)
        data = torch.from_numpy(arr)
        hit = _np_approx(arr, model, 0)
        assert hit.any(), model.base.pattern
        whole = approx_scan.approx_scan_words_plain(data, model)
        np.testing.assert_array_equal(whole.numpy(), _words(hit, None))
        for c0 in STARTS[w::4]:
            got = approx_scan.approx_scan_words_plain(data[:, c0 - 32 * w:],
                                                      model)
            np.testing.assert_array_equal(got[w:].numpy(),
                                          whole[c0 // 32:].numpy())
        for c0 in STARTS:
            late = _np_approx(arr, model, max(0, c0 - need))
            np.testing.assert_array_equal(late[:, c0:], hit[:, c0:])


@pytest.mark.parametrize("pattern,ic", [("volcano", False), ("ab", False),
                                        ("x[ab].y" * 4, True), ("z" * 32, False)])
def test_shift_and_warmup_is_tight(pattern, ic):
    """A match starting exactly m - 1 bytes before c0 (ending at c0) is
    found from c0 - (m - 1) and lost from one byte later."""
    rng = np.random.default_rng(7)
    model = port_sa.try_compile_shift_and(pattern, ic)
    m, c0 = model.length, STARTS[7]
    arr = np.full((LANES, CHUNK), ord("q"), np.uint8)
    arr[3, c0 - m + 1 : c0 + 1] = np.frombuffer(_sample(rng, model.sym_ranges),
                                                np.uint8)
    full = _np_shift_and(arr, model, 0)
    assert full[3, c0]
    assert _np_shift_and(arr, model, c0 - (m - 1))[3, c0]
    assert not _np_shift_and(arr, model, c0 - (m - 1) + 1)[3, c0]


TIGHT_31 = "abcdefghijklmnopqrstuvwxyz01234"


@pytest.mark.parametrize("pattern,k,text", [
    ("volcano", 1, b"volxcano"), ("volcano", 2, b"volxcanyo"),
    ("abcdefgh", 3, b"abcXdeYfgZh"),
    (TIGHT_31, 3, b"abcXdefYghiZjklmnopqrstuvwxyz01234")])
def test_approx_warmup_is_tight(pattern, k, text):
    """A match of m + k bytes (k insertions, the first after two pattern
    bytes, so no suffix of it is within k edits) ending at c0 is found
    from c0 - (m + k - 1) and lost from one byte later."""
    model = port_ax.try_compile_approx(pattern, k)
    m, c0 = model.length, STARTS[7]
    assert len(text) == m + k
    arr = np.full((LANES, CHUNK), ord("#"), np.uint8)
    arr[5, c0 - len(text) + 1 : c0 + 1] = np.frombuffer(text, np.uint8)
    assert _np_approx(arr, model, 0)[5, c0]
    assert _np_approx(arr, model, c0 - (m + k - 1))[5, c0]
    assert not _np_approx(arr, model, c0 - (m + k - 1) + 1)[5, c0]


def _np_pairset(arr: np.ndarray, model, start: int,
                prev: np.ndarray) -> np.ndarray:
    """Match bits (lanes, chunk) of the pairset scan from byte ``start``,
    its previous byte seeded with ``prev`` (one per lane; False before
    ``start``)."""
    b = arr.astype(np.int64)
    p = np.asarray(prev, np.int64)
    if model.ignore_case:
        b = np.where((b >= 65) & (b <= 90), b + 32, b)
        p = np.where((p >= 65) & (p <= 90), p + 32, p)
    cur = b[:, start:]
    before = np.concatenate([p[:, None], cur[:, :-1]], axis=1)
    cls, wi = (cur, before) if model.transposed else (before, cur)
    hit = np.zeros(arr.shape, bool)
    hit[:, start:] = (model.words.astype(np.int64)[wi]
                      >> model.rowcls.astype(np.int64)[cls]) & 1 != 0
    return hit


def _ps_models(seed: int) -> list:
    """Seeded random pairset sets over ALPHA (1-2-byte members, -i for
    some) and the 40-row set the factorization must transpose."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(4):
        n = int(rng.integers(1, 7))
        members = {bytes(rng.choice(list(ALPHA.encode()),
                                    size=int(rng.integers(1, 3))).tolist())
                   for _ in range(n)}
        ic = bool(rng.integers(0, 2))
        out.append(port_ps.compile_pairset(sorted(members), ignore_case=ic))
    out.append(port_ps.compile_pairset(
        [bytes([100 + i, b"uvwxyz"[j]]) for i in range(40) for j in range(6)
         if (i + 1) >> j & 1], ignore_case=bool(seed % 2)))
    assert out[-1].transposed
    return out


def _packed(words: np.ndarray) -> np.ndarray:
    """(chunk // 32, lanes) coarse words of single bytes -> the SWAR
    plane (chunk // 32, lanes // 4): byte k of element j is stripe 4j+k."""
    n, lanes = words.shape
    as_bytes = np.ascontiguousarray(words.astype(np.uint8))
    return as_bytes.view(np.uint32).reshape(n, lanes // 4)


def _swar_models(seed: int) -> list:
    """Seeded random SWAR models: m = 1-8 with classes, '.', -i, and the
    rare-class filters among them."""
    rng = np.random.default_rng(seed)
    out = []
    for m in (1, 2, 5, 8, int(rng.integers(3, 9))):
        full = port_sa.try_compile_shift_and(_rand_pattern(rng, m),
                                             bool(rng.integers(0, 3) == 0))
        assert full is not None and full.length == m
        out.append((full, full))
        filt = port_sa.filtered_for_device(full)
        if filt is not None:
            out.append((filt, full))
    return out


@pytest.mark.parametrize("seed", range(2))
def test_pairset_warmup_invariant(seed):
    rng = np.random.default_rng(300 + seed)
    for model in _ps_models(seed):
        samples = [m.upper() if i % 3 == 0 else m
                   for i, m in enumerate(model.patterns)]
        arr = _stripes(rng, samples, 0)
        data = torch.from_numpy(arr)
        hit = _np_pairset(arr, model, 0, np.full(LANES, NL))
        assert hit.any(), model.patterns
        whole = pairset_scan.pairset_scan_words_plain(data, model)
        np.testing.assert_array_equal(whole.numpy(), _words(hit, None))
        for c0 in STARTS:
            # the kernel's sub-stripe: prev seeded with byte c0 - 1
            late = _np_pairset(arr, model, c0, arr[:, c0 - 1])
            np.testing.assert_array_equal(late[:, c0:], hit[:, c0:])
        for c0 in STARTS[1::4]:  # a pitched window one word early
            got = pairset_scan.pairset_scan_words_plain(data[:, c0 - 32:],
                                                        model)
            np.testing.assert_array_equal(got[1:].numpy(),
                                          whole[c0 // 32:].numpy())


@pytest.mark.parametrize("seed", range(2))
def test_swar_warmup_invariant(seed):
    rng = np.random.default_rng(400 + seed)
    for model, full in _swar_models(seed):
        need = model.length - 1
        w = swar_scan.warmup_words(model)
        assert w == (0 if model.length == 1 else 1)
        arr = _stripes(rng, [_sample(rng, full.sym_ranges) for _ in range(8)],
                       w * 32)
        data = torch.from_numpy(arr)
        hit = _np_shift_and(arr, model, 0)
        assert hit.any(), model.pattern
        whole = swar_scan.swar_scan_words_plain(data, model)
        np.testing.assert_array_equal(
            whole.numpy(), _packed(_words(hit, int(model.match_bit))))
        for c0 in STARTS[w::4]:
            got = swar_scan.swar_scan_words_plain(data[:, c0 - 32 * w:], model)
            np.testing.assert_array_equal(got[w:].numpy(),
                                          whole[c0 // 32:].numpy())
        for c0 in STARTS:
            late = _np_shift_and(arr, model, c0 - need)
            np.testing.assert_array_equal(late[:, c0:], hit[:, c0:])


@pytest.mark.parametrize("members,ic,pair", [
    ([b"zq", b"9!", b"Q#", b"~~"], False, b"9!"),
    ([b"LA", b"he", b"q"], True, b"lA"),
    ([bytes([100 + i, b"uvwxyz"[j]]) for i in range(40) for j in range(6)
      if (i + 1) >> j & 1], False, b"ev")])
def test_pairset_warmup_is_tight(members, ic, pair):
    """A pair whose first byte is c0 - 1 and second c0 is found with prev
    seeded from byte c0 - 1 and lost with the stripe head's '\\n'."""
    model = port_ps.compile_pairset(members, ignore_case=ic)
    c0 = STARTS[7]
    arr = np.full((LANES, CHUNK), ord("."), np.uint8)
    arr[6, c0 - 1 : c0 + 1] = np.frombuffer(pair, np.uint8)
    assert _np_pairset(arr, model, 0, np.full(LANES, NL))[6, c0]
    assert _np_pairset(arr, model, c0, arr[:, c0 - 1])[6, c0]
    assert not _np_pairset(arr, model, c0, np.full(LANES, NL))[6, c0]


@pytest.mark.parametrize("pattern,ic", [("volcano", False), ("ab", True),
                                        ("x[ab].y" * 2, False)])
def test_swar_warmup_is_tight(pattern, ic):
    """A match of m bytes ending at c0 (so starting m - 1 bytes before
    it): the plain version finds it on the window one warm-up word early
    and loses it on the window that starts at c0."""
    rng = np.random.default_rng(8)
    model = port_sa.try_compile_shift_and(pattern, ic)
    m, c0 = model.length, STARTS[7]
    assert swar_scan.warmup_words(model) == 1 < m <= 8
    arr = np.full((LANES, CHUNK), ord("q"), np.uint8)
    arr[9, c0 - m + 1 : c0 + 1] = np.frombuffer(_sample(rng, model.sym_ranges),
                                                np.uint8)
    data = torch.from_numpy(arr)
    byte = (c0 // 32, 9 // 4, 9 % 4)  # (word, element, byte) of the match
    early = swar_scan.swar_scan_words_plain(data[:, c0 - 32:], model)
    assert early[1:].numpy().view(np.uint8).reshape(
        -1, LANES // 4, 4)[0, byte[1], byte[2]]
    late = swar_scan.swar_scan_words_plain(data[:, c0:], model)
    assert not late.numpy().view(np.uint8).reshape(
        -1, LANES // 4, 4)[0, byte[1], byte[2]]
    assert not _np_shift_and(arr, model, c0 - (m - 1) + 1)[9, c0]


# ------------------------------------------------------------- layouts
ROUTES = [
    ("shift_and", dict(pattern="volcano"), "stripes"),
    ("approx", dict(pattern="volcano", max_errors=1), "stripes"),
    ("nfa", dict(pattern="vol(cano|can)s?"), "columns"),
    ("fdr", dict(patterns=["volcano", "lava", "hello"]), "columns"),
    ("pairset", dict(patterns=["vo", "zq"]), "stripes"),
    ("swar", dict(pattern="volcano"), "stripes"),
]
WRAPPERS = {"shift_and": (cuda_scan, "shift_and_scan_words"),
            "approx": (approx_scan, "approx_scan_words"),
            "nfa": (nfa_scan, "nfa_scan_words"),
            "fdr": (fdr_scan, "fdr_scan_words"),
            "pairset": (pairset_scan, "pairset_scan_words"),
            "swar": (swar_scan, "swar_scan_words")}


@pytest.mark.parametrize("route,opts,want", ROUTES)
def test_kernel_modules_declare_the_layout_they_read(route, opts, want):
    mod, _name = WRAPPERS[route]
    assert mod.LAYOUT == {"stripes": layout.STRIPES,
                          "columns": layout.COLUMNS}[want]


@pytest.mark.parametrize("route,opts,want", ROUTES)
def test_engine_routes_hand_their_kernels_their_layout(monkeypatch, route,
                                                       opts, want):
    rng = np.random.default_rng(11)
    words = [b"volcano", b"lava", b"hello", b"vo", b"zq", b"the", b"volcan"]
    data = b"\n".join(b" ".join(words[i] for i in rng.integers(0, 7, 6))
                      for _ in range(3000)) + b"\n"
    monkeypatch.setenv("DGREP_SWAR", "1" if route == "swar" else "0")
    seen = []
    mod, name = WRAPPERS[route]
    inner = getattr(mod, name)

    def spy(data_t, *a, **kw):
        seen.append(data_t)
        return inner(data_t, *a, **kw)

    monkeypatch.setattr(mod, name, spy)
    eng = GrepEngine(device="cpu", target_lanes=64, min_chunk=64,
                     segment_bytes=1 << 14, **opts)
    before = device_scan.transposes
    got = eng.scan(data).matched_lines.tolist()
    transposed = device_scan.transposes - before
    assert eng.mode == ("shift_and" if route == "swar" else route)
    assert eng.stats.get("swar", False) == (route == "swar")
    segs = eng.stats["segments"]
    assert segs > 3 and len(seen) >= segs
    first = seen[0].numpy()
    head = np.frombuffer(data[: max(first.shape)], np.uint8)
    if want == "stripes":
        assert seen[0].stride(1) == 1
        np.testing.assert_array_equal(first[0], head[: first.shape[1]])
        assert transposed == 0
    else:
        assert seen[0].is_contiguous()
        np.testing.assert_array_equal(first[:, 0], head[: first.shape[0]])
        assert transposed == segs
    monkeypatch.setattr(mod, name, inner)
    monkeypatch.setenv("DGREP_SWAR", "0")
    assert got == GrepEngine(device="cpu", **opts).scan(data).matched_lines.tolist()


@pytest.mark.parametrize("wrapper", [
    lambda d: cuda_scan.shift_and_scan_words(
        d, port_sa.try_compile_shift_and("ab"), True),
    lambda d: approx_scan.approx_scan_words(
        d, port_ax.try_compile_approx("abc", 1)),
    lambda d: pairset_scan.pairset_scan_words(
        d, port_ps.compile_pairset([b"ab", b"c"])),
    lambda d: swar_scan.swar_scan_words(
        d, port_sa.try_compile_shift_and("ab")),
])
@pytest.mark.parametrize("bad", [
    lambda: torch.zeros((64, 96), dtype=torch.uint8).t(),  # columns as stripes
    lambda: torch.zeros((64, 64, 2), dtype=torch.uint8)[:, :, 0],  # stride 2
    lambda: torch.zeros((64, 40), dtype=torch.uint8)[:, :32],  # pitch % 16
    lambda: torch.zeros((64, 80), dtype=torch.uint8)[:, 4:36],  # address % 16
])
def test_stripe_wrappers_refuse_other_layouts(wrapper, bad):
    with pytest.raises(ValueError):
        wrapper(bad())


PITCHED = {
    "shift_and": [lambda d, c=c: cuda_scan.shift_and_scan_words(
        d, port_sa.try_compile_shift_and("volcano"), c) for c in (True, False)],
    "approx": [lambda d: approx_scan.approx_scan_words(
        d, port_ax.try_compile_approx("volcano", 1))],
    "pairset": [lambda d, ic=ic: pairset_scan.pairset_scan_words(
        d, port_ps.compile_pairset([b"lc", b"NO", b"v"], ignore_case=ic))
        for ic in (False, True)],
    "swar": [lambda d: swar_scan.swar_scan_words(
        d, port_sa.try_compile_shift_and("volcano"))],
}


def test_stripe_wrappers_take_pitched_windows():
    rng = np.random.default_rng(3)
    arr = rng.choice(np.frombuffer(b"volcan \n", np.uint8), size=(64, 160))
    arr[:, 40:47] = np.frombuffer(b"volcano", np.uint8)
    wide = torch.from_numpy(arr)
    win = wide[:, 32:128]  # pitch 160, base 32 bytes in
    copy = win.contiguous()
    for kernel, scans in PITCHED.items():
        for scan in scans:
            got = scan(win)
            assert torch.equal(got, scan(copy)), kernel
            assert bool(got.view(torch.int32).any()), kernel


def test_slope_stripe_setup_windows_are_pitched_stripes():
    data = (b"a volcano and the lava\n" * 3000)[:60_000]
    padded, lay, pad = slope.stripe_setup(data, "cpu")
    assert padded.shape == (lay.lanes, lay.chunk + pad)
    assert padded.is_contiguous()
    assert bool((padded[:, lay.chunk:] == NL).all())
    stripes = layout.padded_stripes(data, lay)
    model = port_sa.try_compile_shift_and("volcano")
    dev, chunk, pad_rows, scan = slope.shift_and_setup(data, model,
                                                       device="cpu")
    assert chunk == lay.chunk and pad_rows == pad
    assert torch.equal(dev.t(), padded)
    assert slope.pass_bytes(dev, chunk) == lay.chunk * lay.lanes
    for off in (0, pad):  # the harness's row windows, seen as stripes
        win = dev[off : off + chunk].t()
        assert win.stride() == (lay.chunk + pad, 1)
        np.testing.assert_array_equal(win[:, : lay.chunk - off].numpy(),
                                      stripes[:, off:])
    want = cuda_scan.shift_and_scan_words(torch.from_numpy(stripes), model,
                                          True)
    assert torch.equal(scan(dev[:chunk]), want)


def test_substripe_sweep_needs_a_card(capsys):
    from distributed_grep_tpu_torch.benchmarks import substripe_sweep

    assert not torch.cuda.is_available()
    assert substripe_sweep.main([]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "torch.cuda.is_available() is False" in out.err
    text = substripe_sweep.words_text(1 << 16)
    assert len(text) == 1 << 16 and text == substripe_sweep.words_text(1 << 16)
    assert b"volcano" in text and text.count(b"\n") > 100


@pytest.mark.parametrize("kernel", ["shift_and", "approx", "pairset",
                                    "shift_and_swar"])
def test_substripe_sweep_forces_the_launchers_count(kernel):
    from distributed_grep_tpu_torch.benchmarks import substripe_sweep
    from distributed_grep_tpu_torch.ops import _build

    src = (_build.CSRC / f"{kernel}.cu").read_text()
    line, forced = substripe_sweep.LAUNCH_LINE[kernel]
    got = substripe_sweep.variant_source(kernel, 4)
    assert src.count(line) == 1 and line not in got
    assert got == src.replace(line, forced.format(n=4))
