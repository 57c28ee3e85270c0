"""Port scan kernel function, fetch and decode vs the reference package.

The plain PyTorch version of the Shift-And kernel must give words
bit-identical (tolerance 0: integer words) to the reference Pallas kernel
run in interpret mode, reshaped from its TPU tile (chunk//32, lanes//128,
128) to the port's (chunk//32, lanes).  The CUDA kernel itself is held
against the plain version on the card in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from distributed_grep_tpu.models import shift_and as ref_sa
from distributed_grep_tpu.ops import layout as ref_layout
from distributed_grep_tpu.ops import pallas_scan, scan_jnp
from distributed_grep_tpu.ops import sparse as ref_sparse
from distributed_grep_tpu_torch.models import shift_and as port_sa
from distributed_grep_tpu_torch.ops import cuda_scan, layout, scan_torch, sparse


def _corpus(seed: int, chunk: int, lanes: int) -> np.ndarray:
    """(chunk, lanes) stripe layout of seeded text with injected matches,
    some of them across 32-byte word edges."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz     \nVOLC", np.uint8)
    text = rng.choice(alphabet, size=chunk * lanes)
    for p in rng.choice(text.size - 16, size=text.size // 3000, replace=False):
        text[p : p + 7] = np.frombuffer(b"volcano", np.uint8)
        text[p + 9 : p + 14] = np.frombuffer(b"hallo", np.uint8)
    lay = layout.Layout(lanes=lanes, chunk=chunk, n_real=text.size)
    arr = layout.to_device_array(text.tobytes(), lay)
    for lane in range(0, lanes, 97):  # "volcano" ending in the next word
        arr[29:36, lane] = np.frombuffer(b"volcano", np.uint8)
    return arr


MODELS = [("volcano", False, False), ("volcano", False, True),
          ("Volcano", True, False), ("h[ae]llo", False, False)]


@pytest.mark.parametrize("chunk,lanes,models", [
    (512, 4096, MODELS), (1024, 8192, MODELS[:2]),
])
@pytest.mark.parametrize("coarse", [True, False])
def test_plain_words_bit_identical_to_reference_kernel(chunk, lanes, models,
                                                       coarse):
    arr = _corpus(chunk + lanes, chunk, lanes)
    for pattern, ic, filtered in models:
        ref_model = ref_sa.try_compile_shift_and(pattern, ignore_case=ic)
        port_model = port_sa.try_compile_shift_and(pattern, ignore_case=ic)
        if filtered:
            ref_model = ref_sa.filtered_for_device(ref_model)
            port_model = port_sa.filtered_for_device(port_model)
            assert ref_model is not None
        ref_words = np.asarray(pallas_scan.shift_and_scan_words(
            arr, ref_model, interpret=True, coarse=coarse
        )).reshape(chunk // 32, lanes)
        got = cuda_scan.shift_and_scan_words(torch.from_numpy(arr),
                                             port_model, coarse)
        assert got.dtype == torch.uint32 and got.shape == ref_words.shape
        np.testing.assert_array_equal(got.numpy(), ref_words)
        assert ref_words.any(), "corpus must contain matches"


def test_fetch_and_decode_match_reference():
    chunk, lanes = 512, 4096
    arr = _corpus(7, chunk, lanes)
    n_real = chunk * lanes - 1000  # some padding lanes past the data
    model = ref_sa.try_compile_shift_and("volcano")
    port_model = port_sa.try_compile_shift_and("volcano")
    for coarse in (True, False):
        ref_dev = pallas_scan.shift_and_scan_words(arr, model, interpret=True,
                                                   coarse=coarse)
        r_idx, r_vals = scan_jnp.sparse_nonzero(ref_dev)
        words = cuda_scan.shift_and_scan_words(torch.from_numpy(arr),
                                               port_model, coarse)
        p_idx, p_vals = scan_torch.sparse_nonzero(words)
        np.testing.assert_array_equal(p_idx, r_idx)
        np.testing.assert_array_equal(p_vals, np.asarray(r_vals, np.uint32))
        r_lay = ref_layout.Layout(lanes=lanes, chunk=chunk, n_real=n_real)
        p_lay = layout.Layout(lanes=lanes, chunk=chunk, n_real=n_real)
        if coarse:
            np.testing.assert_array_equal(
                sparse.span_starts_from_sparse_words(p_idx, p_lay),
                ref_sparse.span_starts_from_sparse_words(r_idx, r_lay))
        else:
            np.testing.assert_array_equal(
                sparse.offsets_from_sparse_words(p_idx, p_vals, p_lay),
                ref_sparse.offsets_from_sparse_words(r_idx, r_vals, r_lay))


def test_sparse_nonzero_empty_plane():
    idx, vals = scan_torch.sparse_nonzero(torch.zeros((4, 64), dtype=torch.uint32))
    assert idx.size == 0 and vals.size == 0 and vals.dtype == np.uint32


@pytest.mark.parametrize("bad", [
    lambda: torch.zeros((64, 64), dtype=torch.int32),  # dtype
    lambda: torch.zeros(64 * 64, dtype=torch.uint8),  # rank
    lambda: torch.zeros((48, 64), dtype=torch.uint8),  # chunk % 32
    lambda: torch.zeros((64, 40), dtype=torch.uint8),  # lanes % 32
    lambda: torch.zeros((64, 64), dtype=torch.uint8).t(),  # non-contiguous
])
def test_wrapper_rejects_bad_inputs(bad):
    model = port_sa.try_compile_shift_and("ab")
    with pytest.raises(ValueError):
        cuda_scan.shift_and_scan_words(bad(), model, True)


def test_wrapper_on_cpu_tensor_is_plain_and_not_counted():
    arr = torch.from_numpy(_corpus(3, 64, 64))
    model = port_sa.try_compile_shift_and("volcano")
    before = cuda_scan.launches
    a = cuda_scan.shift_and_scan_words(arr, model, True)
    b = cuda_scan.shift_and_scan_words_plain(arr, model, True)
    assert torch.equal(a, b)
    assert cuda_scan.launches == before  # counts CUDA launches only


def test_layout_and_stripes():
    lay = layout.choose_layout(10_000, target_lanes=256, min_chunk=32,
                               lane_multiple=32, chunk_multiple=32)
    assert lay.lanes % 32 == 0 and lay.chunk % 32 == 0
    assert lay.padded >= 10_000
    data = bytes(range(256)) * 40
    arr = layout.to_device_array(data[:10_000], lay)
    assert arr.shape == (lay.chunk, lay.lanes)
    assert arr[5, 2] == data[2 * lay.chunk + 5]
    assert (arr.T.reshape(-1)[10_000:] == 0x0A).all()
    np.testing.assert_array_equal(
        layout.to_device_array(data[:10_000], lay),
        ref_layout.to_device_array(data[:10_000], ref_layout.Layout(
            lanes=lay.lanes, chunk=lay.chunk, n_real=lay.n_real)))
