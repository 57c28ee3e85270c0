"""The port on the card: the CUDA kernels against their plain versions, and
the engine and job on "cuda" against themselves on "cpu".

Every test here needs an NVIDIA card (marker ``cuda``) and skips without
one.  This file imports only the port, so it also runs where jax is not
installed:

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from distributed_grep_tpu_torch.models import nfa as port_nfa
from distributed_grep_tpu_torch.models import shift_and as port_sa
from distributed_grep_tpu_torch.ops import cuda_scan, layout, nfa_scan
from distributed_grep_tpu_torch.ops.engine import GrepEngine
from distributed_grep_tpu_torch.runtime.job import run_job
from distributed_grep_tpu_torch.utils.config import JobConfig

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _text(seed: int, n_bytes: int) -> np.ndarray:
    """Seeded lowercase text with newlines and injected matches."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz     \nVOLC", np.uint8)
    text = rng.choice(alphabet, size=n_bytes)
    for p in rng.choice(n_bytes - 16, size=max(1, n_bytes // 3000),
                        replace=False):
        text[p : p + 7] = np.frombuffer(b"volcano", np.uint8)
        text[p + 9 : p + 14] = np.frombuffer(b"hallo", np.uint8)
    return text


MODELS = [("volcano", False, False), ("volcano", False, True),
          ("Volcano", True, False), ("h[ae]llo", False, False)]


@pytest.mark.parametrize("chunk,lanes", [(512, 4096), (1024, 65536), (160, 64)])
def test_cuda_kernel_matches_plain_on_card(card, chunk, lanes):
    text = _text(11, chunk * lanes)
    lay = layout.Layout(lanes=lanes, chunk=chunk, n_real=text.size)
    arr = layout.to_device_array(text.tobytes(), lay)
    arr[29:36, ::97] = np.frombuffer(b"volcano", np.uint8)[:, None]
    cpu = torch.from_numpy(np.ascontiguousarray(arr.T))  # (lanes, chunk)
    dev = cpu.to(card)
    for pattern, ic, filtered in MODELS:
        model = port_sa.try_compile_shift_and(pattern, ignore_case=ic)
        if filtered:
            model = port_sa.filtered_for_device(model)
        for coarse in (True, False):
            before = cuda_scan.launches
            got = cuda_scan.shift_and_scan_words(dev, model, coarse)
            torch.cuda.synchronize()
            assert cuda_scan.launches == before + 1
            want = cuda_scan.shift_and_scan_words_plain(cpu, model, coarse)
            assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("pattern,ic", [
    ("volcano", False), ("Volcano", True), ("h[ae]llo", False), ("o ", False),
])
def test_engine_on_card_equals_cpu(card, pattern, ic):
    data = _text(3, 3 << 20).tobytes()
    opts = dict(target_lanes=4096, min_chunk=32, segment_bytes=1 << 20)
    before = cuda_scan.launches
    got = GrepEngine(pattern, ignore_case=ic, device="cuda", **opts).scan(data)
    assert cuda_scan.launches - before >= 3  # one per segment at least
    want = GrepEngine(pattern, ignore_case=ic, device="cpu", **opts).scan(data)
    assert got.matched_lines.tolist() == want.matched_lines.tolist()


def test_job_on_card_byte_identical_to_cpu(card, tmp_path):
    files = []
    for i in range(3):
        p = tmp_path / f"f{i}.txt"
        p.write_bytes(_text(20 + i, 1 << 20).tobytes())
        files.append(str(p))
    outs = {}
    for device in ("cuda", "cpu"):
        res = run_job(JobConfig(
            input_files=files,
            app_options={"pattern": "volcano", "target_lanes": 4096,
                         "min_chunk": 32, "segment_bytes": 1 << 19},
            work_dir=str(tmp_path / device)), n_workers=2, device=device)
        outs[device] = {Path(p).name: Path(p).read_bytes()
                        for p in res.output_files}
    assert outs["cuda"] == outs["cpu"]
    assert any(outs["cuda"].values())


NFA_MODELS = [
    ("(volcano|hallo)", False),  # 1 word
    (r"get /[a-z0-9/.-]{4,24}\.gif", True),  # 2 words, 21 specials
    ("(" + "|".join(["volcano", "anarchism", "philosophy", "wikipedia",
                     "quantum", "zeppelin", "obsidian", "telescope",
                     "metabolic", "hurricane", "labyrinth", "xylophone"])
     + ")", False),  # 4 words
    ("^volc", False),  # init_anchor
    ("a[bc]{40,90}d", False),  # 3 words, 51 specials
    ("v[a-z ]{0,100}o", False),  # 4 words, 100 specials, edges across words
    # 'v' then 127 starred letters: 4 words, exactly 128 specials (16
    # exception tables, 68 KB of shared memory: the opt-in above 48 KB)
    ("v" + "".join(f"{chr(97 + i % 26)}*" for i in range(127)), False),
]


@pytest.mark.parametrize("chunk,lanes", [(512, 4096), (1024, 65536), (160, 64)])
def test_nfa_kernel_matches_plain_on_card(card, chunk, lanes):
    text = _text(12, chunk * lanes)
    lay = layout.Layout(lanes=lanes, chunk=chunk, n_real=text.size)
    arr = layout.to_device_array(text.tobytes(), lay)
    arr[0:4, ::5] = np.frombuffer(b"volc", np.uint8)[:, None]  # stripe heads
    arr[29:36, ::97] = np.frombuffer(b"volcano", np.uint8)[:, None]
    dev = torch.from_numpy(arr).to(card)
    for pattern, ic in NFA_MODELS:
        model = port_nfa.try_compile_glushkov(pattern, ignore_case=ic)
        assert pattern[0] != "v" or (model.n_words, model.n_specials) in (
            (4, 100), (4, 128))
        before = nfa_scan.launches
        got = nfa_scan.nfa_scan_words(dev, model)
        torch.cuda.synchronize()
        assert nfa_scan.launches == before + 1
        want = nfa_scan.nfa_scan_words_plain(dev, model)
        assert torch.equal(got, want), pattern


@pytest.mark.parametrize("pattern,ic", [
    ("(volcano|hal+o)", False), ("^volc", True), ("volcano$", False),
    (r"\bvolcano\b", False), ("vol[a-z]{2,9}o", False), ("hal*o", False),
])
def test_regex_engine_on_card_equals_cpu(card, pattern, ic):
    data = _text(4, 3 << 20).tobytes()
    opts = dict(target_lanes=4096, min_chunk=32, segment_bytes=1 << 20)
    before = nfa_scan.launches
    got = GrepEngine(pattern, ignore_case=ic, device="cuda", **opts).scan(data)
    assert nfa_scan.launches - before >= 3  # one per segment at least
    want = GrepEngine(pattern, ignore_case=ic, device="cpu", **opts).scan(data)
    assert got.matched_lines.tolist() == want.matched_lines.tolist()
    assert got.matched_lines.size


def _literals(n: int, lo: int, hi: int, seed: int) -> list[str]:
    rng = np.random.default_rng(seed)
    pats: set[str] = set()
    while len(pats) < n:
        pats.add("".join(chr(c) for c in rng.integers(
            97, 123, size=int(rng.integers(lo, hi + 1)))))
    return sorted(pats)


def _set_models():
    from distributed_grep_tpu_torch.models import fdr as port_fdr
    from distributed_grep_tpu_torch.models import pairset as port_ps

    banks = []
    for pats in (["volcano", "hallo", "anarchism", "needle"],
                 _literals(1000, 6, 12, 3), _literals(3000, 4, 6, 5)):
        banks += port_fdr.compile_fdr(pats).banks
    # m = 6, both families, domains up to 1024 (the tuner of compile_fdr
    # picks shallower banks for these sets)
    group = [p.encode() for p in _literals(300, 7, 12, 11)]
    checks = ((5, 0, 128), (4, 0, 1024), (3, 0, 256), (1, 0, 512),
              (0, 0, 1024), (5, 1, 512), (2, 1, 1024))
    tables = port_fdr._build_tables(group, port_fdr._bucket_of(group), 6,
                                    checks)
    banks.append(port_fdr.fdr_bank_from_arrays(
        6, checks, tables, group, port_fdr._fp_of_tables(tables)))
    pairsets = [
        port_ps.compile_pairset(["ab", "zq", "x", "Vo"]),
        port_ps.compile_pairset([bytes([100 + i, b"uvwxyz"[j]])
                                 for i in range(40) for j in range(6)
                                 if (i + 1) >> j & 1]),
        port_ps.compile_pairset(["LA", "he", "q"], ignore_case=True),
    ]
    return banks, pairsets


@pytest.mark.parametrize("chunk,lanes", [(512, 4096), (1024, 65536), (160, 64),
                                         (32, 4096)])
def test_fdr_and_pairset_kernels_match_plain_on_card(card, chunk, lanes):
    from distributed_grep_tpu_torch.ops import fdr_scan, pairset_scan

    banks, pairsets = _set_models()
    assert {b.m for b in banks} >= {2, 5, 6} and any(
        b.families == (0, 1) for b in banks)
    assert any(p.transposed for p in pairsets)
    text = _text(13, chunk * lanes)
    arr = layout.to_device_array(
        text.tobytes(), layout.Layout(lanes=lanes, chunk=chunk, n_real=text.size))
    arr[0:5, ::5] = np.frombuffer(b"hallo", np.uint8)[:, None]
    for r, p in enumerate(banks[-1].patterns[:7]):  # m = 6: ends at rows 0..6
        arr[: r + 1, 1 + r :: 9] = np.frombuffer(p[-r - 1 :], np.uint8)[:, None]
    dev = torch.from_numpy(arr).to(card)  # FDR: the columns
    dev_st = torch.from_numpy(np.ascontiguousarray(arr.T)).to(card)  # pairset
    for bank in banks:
        for fold in (False, True):
            before = fdr_scan.launches
            got = fdr_scan.fdr_scan_words(dev, bank, fold)
            torch.cuda.synchronize()
            assert fdr_scan.launches == before + 1
            want = fdr_scan.fdr_scan_words_plain(dev, bank, fold)
            assert torch.equal(got, want), (bank.m, bank.checks, fold)
    for model in pairsets:
        before = pairset_scan.launches
        got = pairset_scan.pairset_scan_words(dev_st, model)
        torch.cuda.synchronize()
        assert pairset_scan.launches == before + 1
        assert torch.equal(got, pairset_scan.pairset_scan_words_plain(dev_st,
                                                                     model))
    # out=: the later banks and the sidecar OR into one plane
    out = fdr_scan.fdr_scan_words(dev, banks[0])
    fdr_scan.fdr_scan_words(dev, banks[1], out=out)
    pairset_scan.pairset_scan_words(dev_st, pairsets[0], out=out)
    want = (fdr_scan.fdr_scan_words_plain(dev, banks[0]).view(torch.int32)
            | fdr_scan.fdr_scan_words_plain(dev, banks[1]).view(torch.int32)
            | pairset_scan.pairset_scan_words_plain(dev_st, pairsets[0]).view(
                torch.int32))
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), want)
    # the m = 6 bank ORed into a nonzero plane
    rng = np.random.default_rng(chunk)
    base = torch.from_numpy(rng.integers(0, 2**32, size=(chunk // 32, lanes),
                                         dtype=np.uint32)).to(card)
    out = base.clone()
    assert fdr_scan.fdr_scan_words(dev, banks[-1], out=out) is out
    want = (fdr_scan.fdr_scan_words_plain(dev, banks[-1]).view(torch.int32)
            | base.view(torch.int32))
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), want)


@pytest.mark.parametrize("patterns,ic", [
    (["volcano", "hallo", "ano v"], False),
    (["VOLCANO", "hal", "#", "q"], True),
    (["ab", "zq", "Vo"], False),
])
def test_set_engine_on_card_equals_cpu(card, patterns, ic):
    from distributed_grep_tpu_torch.ops import fdr_scan, pairset_scan

    data = _text(5, 3 << 20).tobytes()
    opts = dict(target_lanes=4096, min_chunk=32, segment_bytes=1 << 20)
    before = fdr_scan.launches + pairset_scan.launches
    eng = GrepEngine(patterns=patterns, ignore_case=ic, device="cuda", **opts)
    got = eng.scan(data)
    assert fdr_scan.launches + pairset_scan.launches - before >= 3
    want = GrepEngine(patterns=patterns, ignore_case=ic, device="cpu",
                      **opts).scan(data)
    assert got.matched_lines.tolist() == want.matched_lines.tolist()
    assert got.matched_lines.size


def test_set_job_on_card_byte_identical_to_cpu(card, tmp_path):
    files = []
    for i in range(3):
        p = tmp_path / f"f{i}.txt"
        p.write_bytes(_text(30 + i, 1 << 20).tobytes())
        files.append(str(p))
    outs = {}
    for device in ("cuda", "cpu"):
        res = run_job(JobConfig(
            input_files=files,
            app_options={"patterns": _literals(200, 5, 9, 7) + ["volcano"],
                         "target_lanes": 4096, "min_chunk": 32,
                         "segment_bytes": 1 << 19},
            work_dir=str(tmp_path / device)), n_workers=2, device=device)
        outs[device] = {Path(p).name: Path(p).read_bytes()
                        for p in res.output_files}
    assert outs["cuda"] == outs["cpu"]
    assert any(outs["cuda"].values())


APPROX_MODELS = [("volcano", 1, False), ("volcano", 2, True),
                 ("[Ss]chwarzen[ae]", 3, False), ("Volcano", 3, True)]


@pytest.mark.parametrize("chunk,lanes", [(512, 4096), (1024, 65536), (160, 64)])
def test_approx_kernel_matches_plain_on_card(card, chunk, lanes):
    from distributed_grep_tpu_torch.models import approx as port_ax
    from distributed_grep_tpu_torch.ops import approx_scan

    text = _text(17, chunk * lanes)
    lay = layout.Layout(lanes=lanes, chunk=chunk, n_real=text.size)
    arr = layout.to_device_array(text.tobytes(), lay)
    arr[0:7, ::5] = np.frombuffer(b"volcxno", np.uint8)[:, None]
    arr[27:37, 3] = np.frombuffer(b"Schwarzeen", np.uint8)
    dev = torch.from_numpy(np.ascontiguousarray(arr.T)).to(card)
    for pattern, k, ic in APPROX_MODELS:
        model = port_ax.try_compile_approx(pattern, k, ignore_case=ic)
        before = approx_scan.launches
        got = approx_scan.approx_scan_words(dev, model)
        torch.cuda.synchronize()
        assert approx_scan.launches == before + 1
        want = approx_scan.approx_scan_words_plain(dev, model)
        assert torch.equal(got, want), (pattern, k, ic)


def _rand_pattern(rng, m: int) -> str:
    """m symbols: letters of 'abcxyz', two-letter classes and '.'."""
    out = []
    for _ in range(m):
        r = int(rng.integers(0, 6))
        pick = rng.choice(list("abcxyz"), size=2).tolist()
        out.append("[" + "".join(sorted(set(pick))) + "]" if r == 0
                   else "." if r == 1 else pick[0])
    return "".join(out)


def _sample(rng, sym_ranges) -> bytes:
    """One string the symbols match: a random byte of a random range each."""
    return bytes(int(rng.integers(lo, hi + 1)) for lo, hi in (
        r[int(rng.integers(0, len(r)))] for r in sym_ranges))


def _errorful(rng, s: bytes, k: int) -> bytes:
    """``s`` after 0..k random substitutions, insertions or deletions."""
    b = bytearray(s)
    for _ in range(int(rng.integers(0, k + 1))):
        op, p = int(rng.integers(0, 3)), int(rng.integers(0, len(b)))
        if op == 0:
            b[p] = ord("x")
        elif op == 1:
            b.insert(p, ord("y"))
        elif len(b) > 1:
            del b[p]
    return bytes(b)


@pytest.mark.parametrize("seed", range(3))
def test_substripe_warmup_sweep_on_card(card, seed):
    """The four stripe kernels against their plain versions on seeded
    random models (Shift-And m = 1-32 in both modes; approx k = 1-3 up to
    m + k - 1 = 34; SWAR m = 1-8; a 1-2-byte set, also ORed into a
    nonzero plane), at chunks of 1 to 32 words (288: a short last
    sub-stripe) and on a pitched window, samples planted across every word
    boundary (the kernels start sub-stripes at word boundaries, more of
    them on narrow tensors)."""
    from distributed_grep_tpu_torch.models import approx as port_ax
    from distributed_grep_tpu_torch.models import pairset as port_ps
    from distributed_grep_tpu_torch.ops import (
        approx_scan,
        pairset_scan,
        swar_scan,
    )

    rng = np.random.default_rng(seed)
    for chunk, lanes in [(32, 32), (64, 64), (96, 96), (288, 32), (1024, 64)]:
        m = int(rng.integers(1, 33))
        sa = port_sa.try_compile_shift_and(_rand_pattern(rng, m),
                                           bool(seed % 2))
        k = int(rng.integers(1, 4))
        ax = port_ax.try_compile_approx(_rand_pattern(rng, max(m, k + 1)), k)
        sw = port_sa.try_compile_shift_and(
            _rand_pattern(rng, int(rng.integers(1, 9))), bool(seed % 2))
        pair = bytes(rng.choice(list(b"abcxyz"), size=2).tolist())
        ps = port_ps.compile_pairset([pair, pair[:1].upper() + b"q"],
                                     ignore_case=bool(seed % 2))
        scans = {
            "shift_and": [lambda d, c=c: cuda_scan.shift_and_scan_words(
                d, sa, c) for c in (True, False)],
            "approx": [lambda d: approx_scan.approx_scan_words(d, ax)],
            "swar": [lambda d: swar_scan.swar_scan_words(d, sw)],
            "pairset": [lambda d: pairset_scan.pairset_scan_words(d, ps)],
        }
        plains = {
            "shift_and": [lambda d, c=c: cuda_scan.shift_and_scan_words_plain(
                d, sa, c) for c in (True, False)],
            "approx": [lambda d: approx_scan.approx_scan_words_plain(d, ax)],
            "swar": [lambda d: swar_scan.swar_scan_words_plain(d, sw)],
            "pairset": [lambda d: pairset_scan.pairset_scan_words_plain(d,
                                                                        ps)],
        }
        samples = {"shift_and": _sample(rng, sa.sym_ranges),
                   "approx": _errorful(rng, _sample(rng, ax.base.sym_ranges),
                                       k),
                   "swar": _sample(rng, sw.sym_ranges), "pairset": pair}
        for kind, sample in samples.items():
            text = rng.choice(np.frombuffer(b"abcxyzABC\n", np.uint8),
                              size=(lanes, chunk + 64))
            for c0 in range(32, chunk, 32):
                for d in range(0, 40, 3):
                    end = min(chunk - 1, c0 + d)
                    s = sample[max(0, len(sample) - end - 1):]
                    text[d % lanes, end + 1 - len(s) : end + 1] = \
                        np.frombuffer(s, np.uint8)
            wide = torch.from_numpy(text).to(card)
            for dev in (wide[:, :chunk].contiguous(), wide[:, 32 : 32 + chunk]):
                for scan, plain in zip(scans[kind], plains[kind]):
                    got, want = scan(dev), plain(dev)
                    assert torch.equal(got, want), (kind, sample, chunk)
                if kind == "pairset":  # out=: ORed into a nonzero plane
                    base = torch.from_numpy(rng.integers(
                        0, 2**32, size=(chunk // 32, lanes),
                        dtype=np.uint32)).to(card)
                    out = pairset_scan.pairset_scan_words(dev, ps,
                                                          out=base.clone())
                    want = (plains[kind][0](dev).view(torch.int32)
                            | base.view(torch.int32))
                    assert torch.equal(out.view(torch.int32), want)


@pytest.mark.parametrize("chunk,lanes", [(512, 16384), (1024, 65536), (160, 128)])
def test_swar_kernel_matches_plain_on_card(card, chunk, lanes):
    from distributed_grep_tpu_torch.ops import swar_scan

    text = _text(19, chunk * lanes)
    lay = layout.Layout(lanes=lanes, chunk=chunk, n_real=text.size)
    arr = layout.to_device_array(text.tobytes(), lay)
    arr[29:36, 1::7] = np.frombuffer(b"volcano", np.uint8)[:, None]
    dev = torch.from_numpy(np.ascontiguousarray(arr.T)).to(card)  # stripes
    full = port_sa.try_compile_shift_and("volcano")
    for model in (full, port_sa.filtered_for_device(full),
                  port_sa.try_compile_shift_and("Volcano", True),
                  port_sa.try_compile_shift_and("h[ae]llo")):
        before = swar_scan.launches
        got = swar_scan.swar_scan_words(dev, model)
        torch.cuda.synchronize()
        assert swar_scan.launches == before + 1
        assert torch.equal(got, swar_scan.swar_scan_words_plain(dev, model))


@pytest.mark.parametrize("pattern,k,ic", [("volcano", 1, False),
                                          ("hallo", 2, True)])
def test_approx_engine_on_card_equals_cpu(card, pattern, k, ic):
    from distributed_grep_tpu_torch.ops import approx_scan

    data = _text(23, 3 << 20).tobytes()
    opts = dict(target_lanes=4096, min_chunk=32, segment_bytes=1 << 20)
    before = approx_scan.launches
    eng = GrepEngine(pattern, max_errors=k, ignore_case=ic, device="cuda",
                     **opts)
    got = eng.scan(data)
    assert approx_scan.launches - before == 3
    want = GrepEngine(pattern, max_errors=k, ignore_case=ic, device="cpu",
                      **opts).scan(data)
    assert got.matched_lines.tolist() == want.matched_lines.tolist()
    assert got.matched_lines.size


@pytest.mark.parametrize("pattern,ic", [("volcano", False), ("Volcano", True)])
def test_swar_engine_on_card_equals_cpu(card, monkeypatch, pattern, ic):
    from distributed_grep_tpu_torch.ops import swar_scan

    monkeypatch.setenv("DGREP_SWAR", "1")
    data = _text(29, 3 << 20).tobytes()
    opts = dict(target_lanes=4096, min_chunk=32, segment_bytes=1 << 20)
    before = swar_scan.launches
    eng = GrepEngine(pattern, ignore_case=ic, device="cuda", **opts)
    got = eng.scan(data)
    assert eng.stats["swar"] and swar_scan.launches - before == 3
    want = GrepEngine(pattern, ignore_case=ic, device="cpu", **opts).scan(data)
    assert got.matched_lines.tolist() == want.matched_lines.tolist()
    assert got.matched_lines.size


@pytest.mark.parametrize("chunk,lanes", [(512, 4096), (1024, 65536), (160, 64)])
def test_narrow_probe_kernel_matches_plain_on_card(card, chunk, lanes):
    from distributed_grep_tpu_torch.ops import narrow_probe

    text = _text(31, chunk * lanes)
    lay = layout.Layout(lanes=lanes, chunk=chunk, n_real=text.size)
    arr = layout.to_device_array(text.tobytes(), lay)
    arr[29:36, ::13] = np.frombuffer(b"volcano", np.uint8)[:, None]
    arr[100:103, :] = 0xF6  # bytes above 127
    dev = torch.from_numpy(arr).to(card)
    words = {}
    for width in ("i32", "i16", "i8"):
        before = narrow_probe.launches
        got = narrow_probe.narrow_probe_words(dev, width)
        torch.cuda.synchronize()
        assert narrow_probe.launches == before + 1
        want = narrow_probe.narrow_probe_words_plain(dev, width)
        assert torch.equal(got, want), width
        words[width] = got
    assert torch.count_nonzero(words["i32"].view(torch.int32))
    assert torch.equal(words["i32"], words["i16"])
    assert torch.equal(words["i32"], words["i8"])


@pytest.mark.parametrize("chunk,lanes,splits", [
    (512, 4096, None),  # 1 lane block, the default split count
    (512, 4096, 1),
    (1024, 65536, None),  # 16 lane blocks: the 64 MiB segment
    (1024, 65536, 7),  # an odd split count: uneven (t, s) ranges
    (1536, 8192, 33),
])
def test_mxu_dot_kernel_matches_plain_on_card(card, chunk, lanes, splits):
    from distributed_grep_tpu_torch.ops import mxu_probe

    text = np.random.default_rng(chunk + lanes).integers(
        0, 256, size=chunk * lanes, dtype=np.uint8)
    dev = torch.from_numpy(text.reshape(chunk, lanes)).to(card)
    member = torch.from_numpy(mxu_probe.probe_member()).to(card)
    before = mxu_probe.launches
    got = mxu_probe.mxu_dot(dev, member, splits=splits)
    torch.cuda.synchronize()
    assert mxu_probe.launches == before + 1
    want = mxu_probe.mxu_dot_plain(dev, member)
    assert got.shape == (lanes // 4096, 128, 128)
    assert torch.equal(got, want)
