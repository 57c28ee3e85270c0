"""The port's SWAR Shift-And route (DGREP_SWAR=1) vs the reference.

``swar_values`` equals the reference's.  The plain PyTorch version of the
packed kernel gives words bit-identical (tolerance 0: integer words) to
the reference Pallas kernel in interpret mode, reshaped from its tile
(chunk//32, lanes//512, 128) to (chunk//32, lanes//4), at the reference's
smallest packed layout (16384 lanes x 512) -- the reference reading the
(chunk, lanes) columns, the port the (lanes, chunk) stripes of the same
bytes -- and the port's packed decode
gives the reference's span starts for those words.  The engine gives the
same lines with DGREP_SWAR=1 as without it, through the filter, the full
model and the defeat guard.  The CUDA kernel itself is held against the
plain version on the card in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from distributed_grep_tpu.models import shift_and as ref_sa
from distributed_grep_tpu.ops import layout as ref_layout
from distributed_grep_tpu.ops import pallas_scan
from distributed_grep_tpu.ops import sparse as ref_sparse
from distributed_grep_tpu_torch.models import shift_and as port_sa
from distributed_grep_tpu_torch.ops import device_scan, layout, sparse, swar_scan
from distributed_grep_tpu_torch.ops.engine import GrepEngine
from tests.test_torch_engine import CASES, SMALL
from tests.test_torch_models import PATTERNS

MODELS = [("volcano", False, False), ("volcano", False, True),
          ("Volcano", True, False), ("being it", False, False),
          ("h[ae]llo", False, False)]


def _models(pattern: str, ic: bool, filtered: bool):
    ref = ref_sa.try_compile_shift_and(pattern, ignore_case=ic)
    port = port_sa.try_compile_shift_and(pattern, ignore_case=ic)
    if filtered:
        ref, port = ref_sa.filtered_for_device(ref), port_sa.filtered_for_device(port)
    return ref, port


@pytest.mark.parametrize("pattern,ic", PATTERNS + [
    ("volcano", True), ("abcdefgh", False), ("abcdefghi", False),
    ("[ab][cd][ef][gh][ij][kl][mn][op][qr]", False), ("[ab]" * 8, True)])
def test_swar_values_equal_reference(pattern, ic):
    ref = ref_sa.try_compile_shift_and(pattern, ignore_case=ic)
    port = port_sa.try_compile_shift_and(pattern, ignore_case=ic)
    if ref is None:
        assert port is None
        return
    assert port_sa.swar_values(port) == ref_sa.swar_values(ref)
    rf, pf = ref_sa.filtered_for_device(ref), port_sa.filtered_for_device(port)
    if rf is not None:
        assert port_sa.swar_values(pf) == ref_sa.swar_values(rf)


@pytest.mark.parametrize("pattern,ic,filtered", MODELS)
def test_plain_words_and_decode_equal_pallas_interpret(pattern, ic, filtered):
    chunk, lanes = 512, 16384
    rng = np.random.default_rng(len(pattern) + ic + 2 * filtered)
    alpha = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz     \nVOLC", np.uint8)
    text = rng.choice(alpha, size=chunk * lanes)
    for p in rng.choice(text.size - 24, size=text.size // 3000,
                        replace=False).tolist():
        text[p : p + 7] = np.frombuffer(b"volcano", np.uint8)
        text[p + 9 : p + 17] = np.frombuffer(b"being it", np.uint8)
        text[p + 18 : p + 23] = np.frombuffer(b"hallo", np.uint8)
    lay = layout.Layout(lanes=lanes, chunk=chunk, n_real=text.size - 100)
    arr = layout.to_device_array(text.tobytes(), lay)
    arr[29:36, 1::7] = np.frombuffer(b"volcano", np.uint8)[:, None]  # word edge
    ref, port = _models(pattern, ic, filtered)
    assert port_sa.swar_values(port) is not None
    want = np.asarray(pallas_scan.swar_shift_and_scan_words(
        arr, ref, interpret=True)).reshape(chunk // 32, lanes // 4)
    got = swar_scan.swar_scan_words(
        torch.from_numpy(np.ascontiguousarray(arr.T)), port)
    assert got.dtype == torch.uint32 and got.shape == (chunk // 32, lanes // 4)
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.count_nonzero(want) > 100
    # the decode: the reference's tile arithmetic and the port's row-major
    # formula name the same spans for the same flat words
    flat = want.reshape(-1)
    idx = np.flatnonzero(flat)
    np.testing.assert_array_equal(
        sparse.span_starts_from_packed_words(idx, flat[idx], lay),
        ref_sparse.span_starts_from_packed_words(
            idx, flat[idx],
            ref_layout.Layout(lanes=lanes, chunk=chunk, n_real=lay.n_real)))


def test_packed_words_equal_unpacked_coarse_words():
    """Byte k of packed element j is stripe 4j+k's coarse word (the
    Shift-And kernel's, on the same stripes), at a small layout the engine
    uses."""
    text = np.frombuffer(CASES["edges"][: 160 * 256], np.uint8)
    lay = layout.Layout(lanes=256, chunk=160, n_real=text.size)
    stripes = layout.padded_stripes(text.tobytes(), lay)
    from distributed_grep_tpu_torch.ops import cuda_scan

    for pattern, ic, filtered in MODELS:
        _ref, port = _models(pattern, ic, filtered)
        packed = swar_scan.swar_scan_words(torch.from_numpy(stripes),
                                           port).numpy()
        unpacked = cuda_scan.shift_and_scan_words(
            torch.from_numpy(stripes), port, True).numpy()
        as_bytes = packed.view(np.uint8).reshape(160 // 32, 256)
        np.testing.assert_array_equal(as_bytes != 0, unpacked != 0)


def test_wrapper_refuses_long_models():
    model = port_sa.try_compile_shift_and("abcdefghi")
    with pytest.raises(ValueError, match="at most 8"):
        swar_scan.swar_scan_words(torch.zeros((64, 128), dtype=torch.uint8),
                                  model)


# ------------------------------------------------------------------ engine
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("pattern,ic", [
    ("volcano", False), ("Volcano", True), ("h[ae]llo", False),
    ("being it", False), ("o ", False)])
def test_engine_lines_equal_with_and_without_swar(monkeypatch, case,
                                                  pattern, ic):
    data = CASES[case]
    eng = GrepEngine(pattern, ignore_case=ic, **SMALL)
    monkeypatch.delenv("DGREP_SWAR", raising=False)
    want = eng.scan(data).matched_lines.tolist()
    assert eng.stats["swar"] is False
    monkeypatch.setenv("DGREP_SWAR", "1")  # read at scan time
    got = eng.scan(data).matched_lines.tolist()
    assert eng.stats["swar"] is True
    assert got == want
    assert eng.stats["stitch_windows"] > 0


def test_swar_keeps_the_dense_confirm_and_the_defeat_guard(monkeypatch):
    """'volcano' filters on v, l, c; a corpus of 'vxlc' words makes its
    candidates dense and mostly false: the dense confirm runs the exact
    unpacked kernel on the segment's stripes and the guard drops the
    filter."""
    rng = np.random.default_rng(6)
    data = b"\n".join(b"vxlc %d" % i if rng.random() < 0.97 else b"a volcano"
                      for i in range(30_000)) + b"\n"
    opts = dict(device="cpu", target_lanes=256, min_chunk=32,
                segment_bytes=1 << 17)
    monkeypatch.setenv("DGREP_SWAR", "1")
    eng = GrepEngine("volcano", **opts)
    got = eng.scan(data).matched_lines.tolist()
    assert eng.stats["swar"] and eng.stats["dense_confirms"] >= 1
    assert eng.stats["filter_defeated"] is True
    monkeypatch.delenv("DGREP_SWAR")
    assert got == GrepEngine("volcano", **opts).scan(data).matched_lines.tolist()
    assert got


@pytest.mark.parametrize("pattern,ic", [
    ("[a-z]olcano", False),  # a real range: no packed equality form
    ("abcdefghi", False),  # past SWAR_MAX_SYMBOLS
    ("[abcd][efgh][ijkl][mnop][qr]", False),  # past SWAR_MAX_VALUES
    ("vol(cano|can)", False),  # not a Shift-And engine
])
def test_ineligible_patterns_keep_the_unpacked_kernel(monkeypatch, pattern, ic):
    monkeypatch.setenv("DGREP_SWAR", "1")
    eng = GrepEngine(pattern, ignore_case=ic, **SMALL)
    assert not device_scan.use_swar(eng)
    monkeypatch.setenv("DGREP_SWAR", "0")
    assert not device_scan.use_swar(GrepEngine("volcano", **SMALL))
