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


@pytest.fixture(autouse=True)
def _kernels_at_every_size(monkeypatch):
    """These tests exist to run the kernels: on the card an input below
    DGREP_DEVICE_MIN_BYTES (1 MiB) would take the host, so the bound is
    0 unless a test sets its own."""
    monkeypatch.setenv("DGREP_DEVICE_MIN_BYTES", "0")


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


@pytest.mark.parametrize("options", [{"word_regexp": True},
                                     {"count_only": True, "invert": True}],
                         ids=["-w", "-c -v"])
def test_option_job_on_card_byte_identical_to_cpu(card, tmp_path, monkeypatch,
                                                  options):
    """grep -w and -c -v on the card: files streamed in several chunks
    (scan_file), the -w confirm on the host, the -v complement."""
    from distributed_grep_tpu_torch.ops import engine as engine_mod

    monkeypatch.setattr(engine_mod, "FILE_CHUNK_BYTES", 1 << 19)
    files = []
    for i in range(3):
        p = tmp_path / f"f{i}.txt"
        p.write_bytes(_text(40 + i, 1 << 20).tobytes())
        files.append(str(p))
    outs = {}
    for device in ("cuda", "cpu"):
        res = run_job(JobConfig(
            input_files=files,
            app_options={"pattern": "volcano", **options,
                         "target_lanes": 4096, "min_chunk": 32,
                         "segment_bytes": 1 << 18},
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


@pytest.mark.parametrize("chunk,lanes", [(512, 4096), (1024, 65536), (160, 64),
                                         (96, 544)])
def test_narrow_probe_kernel_matches_plain_on_card(card, chunk, lanes):
    """Every width; 'volcano' across a word edge at every lane position of
    a thread's group of lanes; every byte value; lanes a multiple of 32 but
    not of a block's lanes (544)."""
    from distributed_grep_tpu_torch.ops import narrow_probe

    text = _text(31, chunk * lanes)
    lay = layout.Layout(lanes=lanes, chunk=chunk, n_real=text.size)
    arr = layout.to_device_array(text.tobytes(), lay)
    arr[29:36, ::13] = np.frombuffer(b"volcano", np.uint8)[:, None]
    arr[61:68, 1::6] = np.frombuffer(b"volcano", np.uint8)[:, None]
    arr[100 % chunk:(100 % chunk) + 3, :] = 0xF6  # bytes above 127
    arr[-2, :256 if lanes >= 256 else lanes] = np.arange(
        min(lanes, 256), dtype=np.uint8)
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


@pytest.mark.parametrize("chunk,lanes,blocks,full_range", [
    (512, 4096, None, False),  # 1 lane block, one block per SM
    (512, 4096, 1, True),
    (512, 4096, 600, False),  # more blocks than rows: empty ranges
    (1024, 65536, None, True),  # 16 lane blocks: the 64 MiB segment
    (1024, 65536, 7, False),  # ranges straddling lane blocks
    (1536, 8192, 33, True),
    (512, 8192, 3, False),  # ranges that start and end mid-block
])
def test_mxu_dot_kernel_matches_plain_on_card(card, chunk, lanes, blocks,
                                              full_range):
    from distributed_grep_tpu_torch.ops import mxu_probe

    rng = np.random.default_rng(chunk + lanes)
    text = rng.integers(0, 256, size=chunk * lanes, dtype=np.uint8)
    dev = torch.from_numpy(text.reshape(chunk, lanes)).to(card)
    member = (rng.integers(-128, 128, size=(256, 128), dtype=np.int8)
              if full_range else mxu_probe.probe_member())
    member = torch.from_numpy(member).to(card)
    before = mxu_probe.launches
    got = mxu_probe.mxu_dot(dev, member, blocks=blocks)
    torch.cuda.synchronize()
    assert mxu_probe.launches == before + 1
    want = mxu_probe.mxu_dot_plain(dev, member)
    assert got.shape == (lanes // 4096, 128, 128)
    assert torch.equal(got, want)


@pytest.mark.parametrize("flags", [["-o", "volcano"], ["-C", "1", "volcano"],
                                   ["-b", "volcano"], ["-o", "-b", "-i", "HALLO"],
                                   ["-c", "volcano", "-"], ["volcano"]],
                         ids=" ".join)
def test_cli_display_and_stdin_on_card_equal_cpu(card, tmp_path, capsysbinary,
                                                 monkeypatch, flags):
    """-o, -C 1, -b and standard input (the stream) on the card: the same
    stdout and exit code as --device cpu."""
    import io
    import sys

    from distributed_grep_tpu_torch.__main__ import main

    files = []
    for i in range(2):
        p = tmp_path / f"f{i}.txt"
        p.write_bytes(_text(60 + i, 1 << 20).tobytes())
        files.append(str(p))
    stdin = "-" in flags or flags == ["volcano"]
    got = {}
    for device in ("cuda", "cpu"):
        if stdin:
            monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(
                io.BufferedReader(io.BytesIO(Path(files[0]).read_bytes()))))
        rc = main(["grep", *flags, *([] if stdin else files),
                   "--device", device])
        got[device] = (rc, capsysbinary.readouterr().out)
    assert got["cuda"] == got["cpu"]
    assert got["cuda"][0] == 0 and got["cuda"][1]


def _dfa_variants(plan_fn, table, lanes, chunk, card):
    """(n_sub, branch) of the launcher's plan, then of every forced
    sub-stripe count up to the chunk's words on every branch the kernel
    takes for ``table`` (ops/dfa_scan.launch_plan's refusals skipped)."""
    from distributed_grep_tpu_torch.ops import dfa_scan

    sms = dfa_scan.device_sms(card)
    out = [(0, None)]
    for s in (1, 2, 4, 8):
        for b in dfa_scan.BRANCHES:
            try:
                plan_fn(table, lanes, chunk, sms=sms, n_sub=s, branch=b)
            except ValueError:
                continue
            out.append((s, b))
    return out


@pytest.mark.parametrize("chunk,lanes", [(1024, 65536), (160, 64), (96, 4128)])
def test_dfa_kernel_matches_plain_on_card(card, chunk, lanes):
    """csrc/dfa.cu K1 against its plain version, bit for bit, words and
    exit states: DFAs with '$' accepts, an Aho-Corasick bank too large for
    shared memory and a '^' table, on contiguous and pitched stripes,
    stripes whose last byte is not '\\n' and stripes with no '\\n' at
    all (where '^a*b''s fix-ups never meet their speculative walk), at
    the launcher's plan and at every forced sub-stripe count on every
    branch the table fits (byte-indexed or class map in shared memory,
    entries through the L2)."""
    from distributed_grep_tpu_torch.models import aho as port_aho
    from distributed_grep_tpu_torch.models import dfa as port_dfa
    from distributed_grep_tpu_torch.ops import dfa_scan

    text = _text(61, chunk * lanes)
    lay = layout.Layout(lanes=lanes, chunk=chunk, n_real=text.size)
    stripes = np.ascontiguousarray(layout.to_device_array(text.tobytes(),
                                                          lay).T)
    stripes[::3, -1] = ord("e")
    stripes[1::5] = ord("a")  # no '\n' in the stripe
    stripes[1::5, 0] = ord("x")
    cpu = torch.from_numpy(stripes)
    wide = torch.zeros((lanes, chunk + 32), dtype=torch.uint8, device=card)
    wide[:, :chunk] = cpu.to(card)
    rng = np.random.default_rng(5)
    bank = port_aho.compile_aho_corasick(
        ["volcano", "hallo"] + [bytes(rng.integers(97, 123, size=8))
                                for _ in range(400)])
    tables = [port_dfa.compile_dfa(p) for p in ("vol(cano)?$", "^$", "e$",
                                                "h[ae]llo", "x?o$", "^a*b")]
    assert not dfa_scan.uses_shared_memory(bank, lanes, chunk)
    seen = set()
    for t in tables + [bank]:
        # the plain version on the card: the CPU would take minutes at the
        # 64 MiB shape
        want, want_exits = dfa_scan.dfa_scan_words_plain(cpu.to(card), t,
                                                         with_exits=True)
        for n_sub, branch in _dfa_variants(dfa_scan.launch_plan, t, lanes,
                                           chunk, card):
            seen.add(branch or dfa_scan.launch_plan(
                t, lanes, chunk, sms=dfa_scan.device_sms(card))[1])
            for dev in (cpu.to(card), wide[:, :chunk]):
                before = dfa_scan.launches
                got, exits = dfa_scan.dfa_scan_words(
                    dev, t, True, n_sub=n_sub, branch=branch)
                torch.cuda.synchronize()
                assert dfa_scan.launches == before + 1
                assert torch.equal(got, want), (t.pattern, n_sub, branch)
                assert torch.equal(exits, want_exits), (t.pattern, n_sub,
                                                        branch)
    assert seen == set(dfa_scan.BRANCHES)


def test_dfa_launches_refused_on_card(card):
    """A forced sub-stripe count or branch the kernel cannot take raises
    before a launch, and csrc/dfa.cu's launcher refuses it too; a tensor
    on neither the CPU nor the card raises."""
    import ctypes

    from distributed_grep_tpu_torch.models import aho as port_aho
    from distributed_grep_tpu_torch.models import dfa as port_dfa
    from distributed_grep_tpu_torch.ops import dfa_scan

    t = port_dfa.compile_dfa("nee(dle|t)")
    dev = torch.zeros((64, 96), dtype=torch.uint8, device=card)
    rng = np.random.default_rng(5)
    bank = port_aho.compile_aho_corasick(
        [bytes(rng.integers(97, 123, size=8)) for _ in range(400)])
    before = dfa_scan.launches
    for kw, table in (({"n_sub": 3}, t), ({"n_sub": 4}, t),
                      ({"n_sub": 64}, t), ({"branch": "bytes"}, bank),
                      ({"branch": "tiles"}, t)):
        with pytest.raises(ValueError):
            dfa_scan.dfa_scan_words(dev, table, **kw)
    st = port_dfa.build_stride_table(t, 2)
    with pytest.raises(ValueError):
        dfa_scan.dfa_stride_words(dev, st, branch="bytes")
    with pytest.raises(ValueError, match="unsupported device"):
        dfa_scan.dfa_scan_words(dev.to("meta"), t)
    assert dfa_scan.launches == before
    # the launcher itself: n_sub 3 and 4 (past the chunk's 3 words)
    entries, cls, byte, slot_state, row_state = dfa_scan.device_table(
        t, card)
    bt = dfa_scan.packed_byte_table(t)
    out = torch.empty((3, 64), dtype=torch.uint32, device=card)
    report = (ctypes.c_int * 4)()
    for n_sub, branch in ((3, 0), (4, 0), (2, 9)):
        err = dfa_scan._lib()(
            dev.data_ptr(), out.data_ptr(), entries.data_ptr(),
            cls.data_ptr(), entries.numel(), 96, 64, 96,
            t.start * t.n_classes, None, t.n_classes, byte.data_ptr(),
            bt.state_of_slot.size, int(bt.slot_of_state[t.start]),
            slot_state.data_ptr(), row_state.data_ptr(), 0, n_sub, branch,
            None, report, None)
        assert err != 0, (n_sub, branch)


@pytest.mark.parametrize("chunk,lanes", [(1024, 65536), (160, 64), (96, 4128)])
def test_dfa_stride_kernel_matches_plain_on_card(card, chunk, lanes):
    """K2 (csrc/dfa.cu's stride walker) against its plain version and K1's
    words, bit for bit, at k = 2 and 4: tables whose composed table sits
    in shared memory and an Aho-Corasick bank read through the L2 (and
    each on the other branch where it fits), at every forced sub-stripe
    count, on contiguous and pitched stripes with no-'\\n' stripes among
    them; and K1's exit states against its plain version."""
    from distributed_grep_tpu_torch.models import aho as port_aho
    from distributed_grep_tpu_torch.models import dfa as port_dfa
    from distributed_grep_tpu_torch.ops import dfa_scan

    text = _text(62, chunk * lanes)
    lay = layout.Layout(lanes=lanes, chunk=chunk, n_real=text.size)
    stripes = np.ascontiguousarray(layout.to_device_array(text.tobytes(),
                                                          lay).T)
    stripes[2::7] = ord("h")  # no '\n' in the stripe
    cpu = torch.from_numpy(stripes)
    wide = torch.zeros((lanes, chunk + 32), dtype=torch.uint8, device=card)
    wide[:, :chunk] = cpu.to(card)
    rng = np.random.default_rng(6)
    bank = port_aho.compile_aho_corasick(
        ["volcano", "hallo"] + [bytes(rng.integers(97, 105, size=6))
                                for _ in range(60)])
    seen = set()
    for t in (port_dfa.compile_dfa("nee(dle|t)"),
              port_dfa.compile_dfa("h[ae]llo"), bank):
        k1, k1_exits = dfa_scan.dfa_scan_words_plain(cpu.to(card), t,
                                                     with_exits=True)
        got_words, got_exits = dfa_scan.dfa_scan_words(cpu.to(card), t,
                                                       with_exits=True)
        torch.cuda.synchronize()
        assert torch.equal(got_words, k1) and torch.equal(got_exits,
                                                          k1_exits)
        for k in (2, 4):
            if port_dfa.choose_stride(t) < k and t is not bank:
                continue
            st = port_dfa.build_stride_table(t, k)
            if st.trans_k.size > 1 << 23:
                continue
            want = dfa_scan.dfa_stride_words_plain(cpu.to(card), st)
            assert torch.equal(want, k1)
            for n_sub, branch in _dfa_variants(dfa_scan.stride_launch_plan,
                                               st, lanes, chunk, card):
                seen.add(branch or dfa_scan.stride_launch_plan(
                    st, lanes, chunk, sms=dfa_scan.device_sms(card))[1])
                for dev in (cpu.to(card), wide[:, :chunk]):
                    before = dfa_scan.stride.launches
                    got = dfa_scan.dfa_stride_words(dev, st, n_sub=n_sub,
                                                    branch=branch)
                    torch.cuda.synchronize()
                    assert dfa_scan.stride.launches == before + 1
                    assert torch.equal(got, want), (t.pattern, k, n_sub,
                                                    branch)
    assert seen == {"shared", "global"}


@pytest.mark.parametrize("kw,kernel", [
    ({"pattern": "volcano"}, "shift_and"), ({"pattern": "h[ae]l+o"}, "nfa"),
    ({"patterns": ["volcano", "hallo", "ash"]}, "fdr"),
    ({"patterns": ["zq", "qz"]}, "pairset"),
    ({"pattern": "volcano", "max_errors": 1}, "approx"),
])
def test_mesh_engine_of_two_entries_equals_one_card(card, kw, kernel):
    """A mesh of two cuda:0 entries (parallel/mesh.py) against the
    one-card engine: the same lines, twice the kernel's launches, and the
    one-entry mesh's psum_candidates."""
    from distributed_grep_tpu_torch.ops.device_scan import kernel_launches
    from distributed_grep_tpu_torch.parallel import make_mesh

    data = _text(71, 3 << 20).tobytes()
    opts = dict(segment_bytes=1 << 20, **kw)
    one = GrepEngine(**opts)
    before = kernel_launches()[kernel]
    want = one.scan(data)
    one_launches = kernel_launches()[kernel] - before
    ref = GrepEngine(mesh=make_mesh((1,), devices=["cuda:0"]), **opts)
    ref.scan(data)
    mesh = make_mesh((2,), devices=["cuda:0", "cuda:0"])
    eng = GrepEngine(mesh=mesh, **opts)
    before = kernel_launches()[kernel]
    got = eng.scan(data)
    assert kernel_launches()[kernel] - before == 2 * one_launches > 0
    assert np.array_equal(got.matched_lines, want.matched_lines)
    assert want.n_matches > 0
    assert eng.stats["psum_candidates"] == ref.stats["psum_candidates"] > 0
    # '^$' keeps mode "dfa" on the mesh: K1 on the first entry
    dfa = GrepEngine("^$", mesh=mesh, segment_bytes=1 << 20)
    before = kernel_launches()["dfa"]
    lines = dfa.scan(data).matched_lines
    assert dfa.route == "dfa" and kernel_launches()["dfa"] > before
    host = GrepEngine("^$", segment_bytes=1 << 20)
    assert host.route == "native"
    assert np.array_equal(lines, host.scan(data).matched_lines)


@pytest.mark.parametrize("pats,ignore_case", [
    (["volcano", "hallo", "ash"], False), (["Volcano", "hallo"], True),
    (["volcano", "hallo", "q"], False),
])
def test_pattern_axis_engine_on_card_equals_one_card(card, pats,
                                                     ignore_case):
    """A set's FDR banks over the pattern axis of a (2, 2) mesh of cuda:0
    entries (a 1-byte member adds the pairset sidecar): the one-card
    engine's lines and the CPU engine's; and ``sharded_fdr_pattern_step``
    over two same-plan banks is bit for bit one card's OR of both."""
    from distributed_grep_tpu_torch.models.fdr import FdrModel, compile_fdr
    from distributed_grep_tpu_torch.ops import fdr_scan
    from distributed_grep_tpu_torch.ops.device_scan import kernel_launches
    from distributed_grep_tpu_torch.parallel import make_mesh
    from distributed_grep_tpu_torch.parallel import sharded_kernels as shk

    data = _text(73, 3 << 20).tobytes()
    opts = dict(patterns=pats, ignore_case=ignore_case,
                segment_bytes=1 << 20)
    want = GrepEngine(**opts).scan(data).matched_lines
    mesh = make_mesh((2, 2), ("data", "seq"), devices=["cuda:0"] * 4)
    eng = GrepEngine(mesh=mesh, mesh_axis="data", pattern_axis="seq",
                     **opts)
    before = kernel_launches()["fdr"]
    got = eng.scan(data).matched_lines
    assert kernel_launches()["fdr"] > before
    assert np.array_equal(got, want) and len(want) > 0
    cpu = GrepEngine(device="cpu", **opts).scan(data).matched_lines
    assert np.array_equal(got, cpu)
    model = FdrModel(banks=[*compile_fdr(["volcano", "hallos"]).banks,
                            *compile_fdr(["ashes", "zebra"]).banks],
                     ignore_case=False, n_patterns=4)
    if not shk.same_plan(model.banks):
        pytest.skip("the two banks compiled to two plans")
    st = torch.from_numpy(_text(74, 512 * 4096).reshape(4096, 512)).to(card)
    words, total = shk.sharded_fdr_pattern_step(st, model, mesh, "data",
                                                "seq")
    cols = st.t().contiguous()
    ref = None
    for bank in model.banks:
        ref = fdr_scan.or_into(ref, fdr_scan.fdr_scan_words(cols, bank))
    assert torch.equal(words, ref)
    assert int(total) == int(torch.count_nonzero(ref.view(torch.int32))) > 0


def test_nullable_eol_job_on_card_byte_identical_to_cpu(card, tmp_path):
    """A '^$' job on device="cuda" (the engine routes it to the host DFA
    scanner, as the reference does) equals the job on the CPU."""
    files = []
    for i in range(3):
        text = _text(80 + i, 1 << 20)
        text[::97] = ord("\n")
        p = tmp_path / f"f{i}.txt"
        p.write_bytes(b"\n" + text.tobytes())
        files.append(str(p))
    outs = {}
    for device in ("cuda", "cpu"):
        res = run_job(JobConfig(
            input_files=files, app_options={"pattern": "^$"},
            work_dir=str(tmp_path / device)), n_workers=2, device=device)
        outs[device] = {Path(p).name: Path(p).read_bytes()
                        for p in res.output_files}
    assert outs["cuda"] == outs["cpu"]
    assert any(outs["cuda"].values())


def _small_tree(tmp_path, n: int = 40) -> list[str]:
    """``n`` files of 4-64 KiB, some without a final newline, one empty."""
    rng = np.random.default_rng(90)
    files = []
    for i in range(n):
        data = _text(90 + i, int(rng.integers(4 << 10, 64 << 10))).tobytes()
        if i % 3 == 0:
            data = data.rstrip(b"\n")
        p = tmp_path / "tree" / f"f{i:02d}.txt"
        p.parent.mkdir(exist_ok=True)
        p.write_bytes(b"" if i == 7 else data)
        files.append(str(p))
    return files


@pytest.mark.parametrize("pattern", ["volcano", "(volcano|hallo)x?"])
def test_packed_job_on_card_byte_identical_to_cpu(card, tmp_path,
                                                  monkeypatch, pattern):
    """A batched job: the small files share map tasks and are scanned as
    packed windows of 512 KiB on the card's kernels (every window is past
    the small-input bound of 128 KiB, so none takes the host)."""
    from distributed_grep_tpu_torch.apps import grep_cuda
    from distributed_grep_tpu_torch.apps.loader import from_module
    from distributed_grep_tpu_torch.ops.device_scan import kernel_launches

    monkeypatch.setenv("DGREP_DEVICE_MIN_BYTES", str(128 << 10))
    files = _small_tree(tmp_path)
    outs = {}
    for device in ("cuda", "cpu"):
        before = kernel_launches()
        res = run_job(JobConfig(
            input_files=files, batch_bytes=512 << 10,
            app_options={"pattern": pattern, "target_lanes": 4096,
                         "min_chunk": 32, "segment_bytes": 1 << 18},
            work_dir=str(tmp_path / device)), n_workers=2, device=device,
            app=from_module(grep_cuda))  # its engine is read
        outs[device] = {Path(p).name: Path(p).read_bytes()
                        for p in res.output_files}
        totals = grep_cuda._engine.totals
        assert res.metrics["counters"]["map_completed"] < len(files)
        assert totals["batch_dispatches"] >= 2
        if device == "cuda":
            launched = {k: v - before[k] for k, v in kernel_launches().items()}
            assert launched["shift_and" if pattern == "volcano" else "nfa"] \
                >= totals["segments"] > 0
            assert not totals.get("small_host_scan")
    assert outs["cuda"] == outs["cpu"]
    assert any(outs["cuda"].values())


def test_warm_corpus_job_on_card_byte_identical_to_cpu(card, tmp_path,
                                                       monkeypatch):
    """Two jobs on the card under the default budget (1 GiB on the card):
    the second reads no file and uploads nothing, its segments resident
    on the card; both equal the job on the CPU."""
    from distributed_grep_tpu_torch.apps import grep_cuda
    from distributed_grep_tpu_torch.apps.loader import from_module
    from distributed_grep_tpu_torch.ops import engine as engine_mod
    from distributed_grep_tpu_torch.ops import layout as layout_mod

    monkeypatch.delenv("DGREP_CORPUS_BYTES", raising=False)
    monkeypatch.setenv("DGREP_DEVICE_MIN_BYTES", str(128 << 10))
    layout_mod.corpus_cache_clear()
    # a fresh engine: the totals read below are this test's jobs' alone
    # (the engine cache keeps an earlier test's engine and its totals)
    engine_mod.model_cache_clear()
    files = _small_tree(tmp_path, 12)
    for i in range(2):
        p = tmp_path / f"big{i}.txt"
        p.write_bytes(_text(120 + i, 1 << 20).tobytes())
        files.append(str(p))
    opts = {"pattern": "volcano", "target_lanes": 4096, "min_chunk": 32,
            "segment_bytes": 1 << 18}
    outs, reads = {}, {}
    monkeypatch.setattr(grep_cuda, "_configured_with", None)
    for name, device in (("cold", "cuda"), ("warm", "cuda"), ("cpu", "cpu")):
        res = run_job(JobConfig(input_files=files, batch_bytes=512 << 10,
                                app_options=opts,
                                work_dir=str(tmp_path / name)),
                      n_workers=2, device=device,
                      app=from_module(grep_cuda))  # its engine is read

        outs[name] = {Path(p).name: Path(p).read_bytes()
                      for p in res.output_files}
        t = grep_cuda._engine.totals
        reads[name] = (t.get("file_reads", 0), t.get("uploads", 0))
    assert reads["cold"][0] == len(files) and reads["cold"][1] > 0
    assert reads["warm"] == reads["cold"]  # nothing more read or uploaded
    c = layout_mod.corpus_cache_counters()
    assert c["corpus_cache_hits"] >= 3 and c["corpus_cache_bytes_resident"]
    ent = layout_mod.corpus_cache().lookup(
        layout_mod.file_content_key(files[-1]))
    assert all(t.is_cuda for segs in ent.variants.values()
               for *_, t in segs)
    assert outs["cold"] == outs["warm"] == outs["cpu"]
    assert any(outs["cpu"].values())
    layout_mod.corpus_cache_clear()


def test_small_input_takes_the_host_on_card(card, monkeypatch):
    """Below device_min_bytes a scan on the card runs on the host: no
    launch, stamped, equal to the kernels' lines; with the bound at 0
    the kernel runs."""
    monkeypatch.setenv("DGREP_DEVICE_MIN_BYTES", str(1 << 20))
    data = _text(7, 64 << 10).tobytes()
    eng = GrepEngine("volcano", device="cuda")
    before = cuda_scan.launches
    small = eng.scan(data)
    assert cuda_scan.launches == before
    assert eng.stats["small_host_scan"] is True
    kern = GrepEngine("volcano", device="cuda", device_min_bytes=0)
    want = kern.scan(data)
    assert cuda_scan.launches > before
    assert "small_host_scan" not in kern.stats
    assert small.matched_lines.tolist() == want.matched_lines.tolist()
    assert want.n_matches > 0


def test_stripe_kernels_launch_from_a_fresh_thread(card):
    """The three stripe-ring kernels encode a tensor map (a driver call)
    before their launch: from a thread whose first CUDA call that launch
    is (a warm scan of resident segments uploads nothing first) they must
    run and equal their plain versions."""
    import threading

    from distributed_grep_tpu_torch.models import pairset as port_ps
    from distributed_grep_tpu_torch.ops import pairset_scan, swar_scan

    cpu = torch.from_numpy(np.ascontiguousarray(
        _text(33, 4096 * 256).reshape(4096, 256)))
    dev = cpu.to(card)
    sa = port_sa.try_compile_shift_and("volcano")
    ps = port_ps.compile_pairset(["ab", "zq"])
    runs = {
        "shift_and": (lambda d: cuda_scan.shift_and_scan_words(d, sa, True),
                      lambda: cuda_scan.shift_and_scan_words_plain(cpu, sa,
                                                                   True)),
        "pairset": (lambda d: pairset_scan.pairset_scan_words(d, ps),
                    lambda: pairset_scan.pairset_scan_words_plain(cpu, ps)),
        "swar": (lambda d: swar_scan.swar_scan_words(d, sa),
                 lambda: swar_scan.swar_scan_words_plain(cpu, sa)),
    }
    got = {}

    def launch(name, fn):
        try:
            got[name] = fn(dev).cpu()
        except Exception as e:  # noqa: BLE001 -- asserted below
            got[name] = e

    for name, (fn, _plain) in runs.items():
        t = threading.Thread(target=launch, args=(name, fn))
        t.start()
        t.join()
    for name, (_fn, plain) in runs.items():
        assert isinstance(got[name], torch.Tensor), got[name]
        assert torch.equal(got[name], plain()), name


def test_peer_shuffle_daemon_job_on_card_equals_cpu(card, tmp_path,
                                                    monkeypatch):
    """A daemon job of ``volcano`` on the card over two HTTP worker loops
    with the peer shuffle on: the records equal the CPU job's, the
    reducers fetched every file from the peers (the daemon's relay bytes
    0), and the maps launched Shift-And."""
    import threading
    import time

    from distributed_grep_tpu_torch.ops.device_scan import kernel_launches
    from distributed_grep_tpu_torch.runtime.http_transport import (
        ServiceHttpTransport,
    )
    from distributed_grep_tpu_torch.runtime.peer import PeerDataServer
    from distributed_grep_tpu_torch.runtime.service import (
        GrepService,
        ServiceServer,
    )
    from distributed_grep_tpu_torch.runtime.worker import WorkerLoop

    monkeypatch.setenv("DGREP_RESULT_CACHE", "0")
    monkeypatch.delenv("DGREP_PEER_SHUFFLE", raising=False)
    files = []
    for i in range(3):
        p = tmp_path / f"w{i}.txt"
        p.write_bytes(_text(40 + i, 1 << 20).tobytes())
        files.append(str(p))
    cpu = run_job(JobConfig(input_files=files,
                            app_options={"pattern": "volcano",
                                         "device": "cpu"},
                            n_reduce=2, work_dir=str(tmp_path / "cpu")),
                  n_workers=2, device="cpu")
    want = sorted(line for p in cpu.output_files
                  for line in Path(p).read_bytes().splitlines())
    svc = GrepService(work_root=tmp_path / "svc", resume=False)
    server = ServiceServer(svc)
    server.start()
    addr = f"127.0.0.1:{server.port}"
    peers = [PeerDataServer().start() for _ in range(2)]
    for peer in peers:
        loop = WorkerLoop(ServiceHttpTransport(addr, rpc_timeout_s=30.0),
                          app=None, peer=peer)
        threading.Thread(target=loop.run, daemon=True).start()
    before = kernel_launches()
    try:
        jid = svc.submit(JobConfig(input_files=files,
                                   app_options={"pattern": "volcano"},
                                   n_reduce=2))
        assert svc.wait_job(jid, timeout=300), svc.job_status(jid)
        st = svc.job_status(jid)
        assert st["state"] == "done", st
        got = sorted(line for p in svc.job_result(jid)["outputs"]
                     for line in Path(p).read_bytes().splitlines())
        launched = kernel_launches()["shift_and"] - before.get("shift_and", 0)
        shipped = svc.record(jid).scheduler.metrics_snapshot()["launches"]
        counters = st["metrics"]["counters"]
    finally:
        svc.stop()
        server.shutdown()
        time.sleep(0.2)
        for peer in peers:
            peer.close()
    assert got == want and got
    assert launched > 0 and shipped.get("shift_and", 0) > 0
    assert counters["peer_fetches"] > 0
    assert svc._shuffle_stats["daemon_shuffle_bytes"] == 0
