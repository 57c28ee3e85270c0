"""The FDR filter kernel's function and the exact confirm vs the reference.

The plain PyTorch version of the filter kernel, fed the REFERENCE's banks
through ``fdr_bank_from_arrays``, must give words bit-identical
(tolerance 0: integer words) to the reference Pallas kernel in interpret
mode, reshaped from its tile (chunk//32, lanes//128, 128) to (chunk//32,
lanes), at chunk 512 and lanes 4096: one bank per plan shape (m = 1..6,
both hash families, domains up to 1024) and ``fold_case``.  At other
shapes the words are held to the numpy oracle ``reference_candidates``
stripe by stripe, and the port's ConfirmSet to the reference's
(``use_native=False``).  The CUDA kernel itself is held against the plain
version on the card in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from distributed_grep_tpu.models import fdr as ref_fdr
from distributed_grep_tpu.ops import pallas_fdr
from distributed_grep_tpu.utils.native import ConfirmSet as RefConfirmSet
from distributed_grep_tpu_torch.models import fdr as port_fdr
from distributed_grep_tpu_torch.ops import fdr_scan, layout
from distributed_grep_tpu_torch.ops.confirm_set import ConfirmSet
from tests.test_torch_sets_models import rand_literals

# (m, checks): one bank per pipeline depth, both families, D up to 1024
PLANS = {
    1: ((0, 0, 128), (0, 1, 1024)),
    2: ((1, 0, 128), (0, 0, 256)),
    3: ((2, 0, 128), (1, 0, 512), (0, 1, 128)),
    4: ((3, 0, 128), (2, 0, 512), (1, 0, 512), (0, 0, 512), (3, 1, 256),
        (2, 1, 256)),
    5: tuple((k, 0, 128) for k in range(4, -1, -1)),
    6: ((5, 0, 128), (4, 0, 1024), (3, 0, 256), (1, 0, 512), (0, 0, 1024),
        (5, 1, 512), (2, 1, 1024)),
}


def ref_bank(m: int, seed: int = 0, ignore_case: bool = False):
    """A reference FdrBank of the given plan over seeded members of m+1..
    m+5 bytes, built with the reference's own tuner pieces."""
    pats = [p.encode() for p in rand_literals(150, m + 1, m + 5, seed=seed + m)]
    group = ref_fdr._normalize(pats, ignore_case)
    checks = PLANS[m]
    tables = ref_fdr._build_tables(group, ref_fdr._bucket_of(group), m, checks)
    return ref_fdr.FdrBank(m=m, checks=checks, tables=tables, patterns=group,
                           fp_per_byte=ref_fdr._fp_of_tables(tables))


def port_bank(ref):
    return port_fdr.fdr_bank_from_arrays(ref.m, ref.checks, ref.tables,
                                         ref.patterns, ref.fp_per_byte)


def stripes(members, seed: int, chunk: int, lanes: int) -> np.ndarray:
    """(chunk, lanes) stripe layout of seeded text (some upper case) with
    members planted anywhere, at stripe heads and across 32-byte words."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"abcdefghijklmnopqrstuvwxyzABCXYZ   \n", np.uint8)
    text = rng.choice(alphabet, size=chunk * lanes)
    for i, p in enumerate(rng.choice(text.size - 20, size=text.size // 400,
                                     replace=False).tolist()):
        nd = members[i % len(members)]
        if i % 5 == 0:
            nd = nd.upper()
        text[p : p + len(nd)] = np.frombuffer(nd, np.uint8)
    arr = layout.to_device_array(
        text.tobytes(), layout.Layout(lanes=lanes, chunk=chunk, n_real=text.size))
    nd = members[0]
    arr[: len(nd), ::7] = np.frombuffer(nd, np.uint8)[:, None]
    arr[30 : 30 + len(nd), 3::50] = np.frombuffer(nd, np.uint8)[:, None]
    return arr


@pytest.mark.parametrize("m,fold", [(1, False), (2, True), (3, False),
                                    (4, False), (5, False), (6, False)])
def test_plain_words_bit_identical_to_reference_kernel(m, fold):
    chunk, lanes = 512, 4096
    ref = ref_bank(m, ignore_case=fold)
    arr = stripes(ref.patterns, m, chunk, lanes)
    want = np.asarray(pallas_fdr.fdr_scan_words(
        arr, ref, interpret=True, fold_case=fold)).reshape(chunk // 32, lanes)
    got = fdr_scan.fdr_scan_words(torch.from_numpy(arr), port_bank(ref), fold)
    assert got.dtype == torch.uint32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()


def _stripe_oracle(bank, arr: np.ndarray, fold: bool) -> np.ndarray:
    """Expected words from reference_candidates, stripe by stripe."""
    chunk, lanes = arr.shape
    want = np.zeros((chunk, lanes), dtype=bool)
    for lane in range(lanes):
        stripe = bytes(arr[:, lane])
        if fold:
            stripe = stripe.lower()
        ends = ref_fdr.reference_candidates(bank, stripe)
        want[ends - 1, lane] = True
    bits = want.reshape(chunk // 32, 32, lanes).astype(np.uint64)
    return (bits << np.arange(32, dtype=np.uint64)[None, :, None]).sum(
        axis=1).astype(np.uint32)


@pytest.mark.parametrize("chunk,lanes", [(160, 64), (96, 32)])
@pytest.mark.parametrize("m", sorted(PLANS))
def test_plain_words_equal_reference_candidates(m, chunk, lanes):
    ref = ref_bank(m, seed=9)
    arr = stripes(ref.patterns, m + chunk, chunk, lanes)
    for fold in (False, True):
        got = fdr_scan.fdr_scan_words(torch.from_numpy(arr), port_bank(ref),
                                      fold)
        np.testing.assert_array_equal(got.numpy(), _stripe_oracle(ref, arr,
                                                                   fold))


def test_out_ors_into_the_word_plane_and_cpu_is_not_counted():
    a, b = port_bank(ref_bank(2)), port_bank(ref_bank(5))
    arr = torch.from_numpy(stripes(a.patterns + b.patterns, 3, 96, 64))
    want = fdr_scan.fdr_scan_words(arr, a).numpy() | \
        fdr_scan.fdr_scan_words(arr, b).numpy()
    before = fdr_scan.launches
    out = fdr_scan.fdr_scan_words(arr, a)
    same = fdr_scan.fdr_scan_words(arr, b, out=out)
    assert same is out
    np.testing.assert_array_equal(out.numpy(), want)
    assert fdr_scan.launches == before  # counts CUDA launches only
    with pytest.raises(ValueError):
        fdr_scan.fdr_scan_words(arr, a, out=out[:1])
    with pytest.raises(ValueError):
        fdr_scan.fdr_scan_words(arr[:48], a)  # chunk % 32
    with pytest.raises(ValueError):
        fdr_scan.fdr_scan_words(arr.to(torch.int32), a)


def _walk_packed_bank(plan: np.ndarray, arr: np.ndarray,
                      fold: bool) -> np.ndarray:
    """csrc/fdr.cu's window in numpy, reading only the packed plan: for
    each output row t and each check i of slot k, the table lookup at row
    t - (m-1-k), all ones before the stripe head, prev = 0 at row 0."""
    chunk, lanes = arr.shape
    m, n = int(plan[fdr_scan._M]), int(plan[fdr_scan._N_CHECKS])
    starts = plan[fdr_scan._SLOT_START : fdr_scan._SLOT_START + 8]
    tabs = plan[fdr_scan._TABLES :].astype(np.int64)
    b = arr.astype(np.int64)
    if fold:
        b = np.where((b >= 65) & (b <= 90), b + 32, b)
    prev = np.vstack([np.zeros((1, lanes), np.int64), b[:-1]])
    v = np.full((chunk, lanes), 0xFFFFFFFF, dtype=np.int64)
    for k in range(m):
        lag = m - 1 - k
        for i in range(int(starts[k]), int(starts[k + 1])):
            a, c = int(plan[fdr_scan._MUL_PREV + i]), int(plan[fdr_scan._MUL_BYTE + i])
            dm, off = int(plan[fdr_scan._DMASK + i]), int(plan[fdr_scan._OFF + i])
            x = tabs[off + (((prev * a) ^ (b * c)) & dm)]
            v[lag:] &= x[: chunk - lag]
    assert starts[m:].tolist() == [n] * (8 - m)
    bits = (v != 0).reshape(chunk // 32, 32, lanes).astype(np.uint64)
    return (bits << np.arange(32, dtype=np.uint64)[None, :, None]).sum(
        axis=1).astype(np.uint32)


def test_pack_bank_layout():
    """The header: the checks sorted by slot, each with its family's hash
    multipliers, domain mask and table offset; the tables padded to 4
    words."""
    m = 6
    bank = port_bank(ref_bank(m))
    plan = fdr_scan.pack_bank(bank)
    assert plan.dtype == np.uint32
    n = bank.n_checks
    assert plan[fdr_scan._M] == m and plan[fdr_scan._N_CHECKS] == n
    starts = plan[fdr_scan._SLOT_START : fdr_scan._SLOT_START + m + 1].tolist()
    assert starts[0] == 0 and starts[-1] == n and starts == sorted(starts)
    seen = set()
    for k in range(m):  # each slot's records point at its checks' tables
        for j in range(starts[k], starts[k + 1]):
            mul = (int(plan[fdr_scan._MUL_PREV + j]),
                   int(plan[fdr_scan._MUL_BYTE + j]))
            fam = port_fdr.HASHES.index(mul)
            dmask, off = plan[[fdr_scan._DMASK + j, fdr_scan._OFF + j]].tolist()
            i = next(i for i, c in enumerate(bank.checks)
                     if c == (k, fam, dmask + 1) and i not in seen)
            seen.add(i)
            np.testing.assert_array_equal(
                plan[fdr_scan._TABLES + off : fdr_scan._TABLES + off + dmask + 1],
                bank.tables[i])
    assert seen == set(range(n))
    total = sum(d for _, _, d in bank.checks)
    assert plan[fdr_scan._N_TABLE] == -(-total // 4) * 4
    assert plan.size == fdr_scan._TABLES + plan[fdr_scan._N_TABLE]


@pytest.mark.parametrize("m", sorted(PLANS))
def test_packed_bank_walk_equals_plain(m):
    """A walk of the packed plan (the kernel's window in numpy) gives the
    plain version's words, with and without case folding."""
    bank = port_bank(ref_bank(m))
    plan = fdr_scan.pack_bank(bank)
    arr = stripes(bank.patterns, m, 96, 64)
    for fold in (False, True):
        want = fdr_scan.fdr_scan_words_plain(torch.from_numpy(arr), bank, fold)
        np.testing.assert_array_equal(_walk_packed_bank(plan, arr, fold),
                                      want.numpy())


def _confirm_data(seed: int, members: list[bytes]) -> bytes:
    rng = np.random.default_rng(seed)
    text = rng.choice(np.frombuffer(b"abcdABCD \n", np.uint8), size=60_000)
    for i, p in enumerate(rng.choice(text.size - 20, size=3000,
                                     replace=False).tolist()):
        nd = members[i % len(members)]
        text[p : p + len(nd)] = np.frombuffer(nd, np.uint8)
    return members[1] + text.tobytes() + members[2]


@pytest.mark.parametrize("ic", [False, True])
def test_confirm_set_equals_reference_confirm(ic):
    rng = np.random.default_rng(7)
    members = [bytes(rng.choice(np.frombuffer(b"abcdABCD", np.uint8),
                                size=int(rng.integers(1, 15))).tolist())
               for _ in range(300)]
    # long members sharing their last 8 bytes, one a suffix of another
    members += [b"xABCDabcd", b"yyABCDabcd", b"ABCDabcd", b"zzzzzzzzzzzzz"]
    data = _confirm_data(8, members)
    ends = np.concatenate([rng.integers(0, len(data) + 1, size=40_000),
                           [0, 1, 7, 8, 9, len(data) - 1, len(data),
                            len(data) + 5]])
    norm = [p.lower() if ic else p for p in members]
    want = RefConfirmSet(norm, ignore_case=ic, use_native=False).confirm(
        data, np.minimum(ends, len(data) + 5).astype(np.uint64))
    got = ConfirmSet(members, ignore_case=ic).confirm(data, ends)
    np.testing.assert_array_equal(got, want)
    assert want.sum() > 1000
    assert got[-2] and not got[-1]  # the last member; past the end


def test_confirm_set_lines_match_is_per_line_containment():
    members = [b"needle", b"abcdefghijk", b"q"]
    data = (b"a needle\nabcdefghij\nxabcdefghijk\n\nqq\nneedl\n"
            b"ABCDEFGHIJK")
    nl = np.flatnonzero(np.frombuffer(data, np.uint8) == 10)
    starts = np.concatenate(([0], nl + 1))
    ends = np.concatenate((nl, [len(data)]))
    for ic, want in ((False, [1, 3, 5]), (True, [1, 3, 5, 7])):
        got = ConfirmSet(members, ignore_case=ic).lines_match(data, starts,
                                                              ends)
        assert (np.flatnonzero(got) + 1).tolist() == want
