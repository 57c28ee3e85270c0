"""The pairset kernel's function vs the reference.

The plain PyTorch version of the exact 1-2-byte set kernel, fed the
REFERENCE's models through ``pairset_from_arrays``, must give words
bit-identical (tolerance 0: integer words) to the reference Pallas kernel
in interpret mode, reshaped from its tile (chunk//32, lanes//128, 128) to
(chunk//32, lanes), at chunk 512 and lanes 4096, in both orientations and
under -i.  The reference reads the (chunk, lanes) columns, the port the
(lanes, chunk) stripes of the same bytes.  At other shapes the words are held to the numpy oracle
``reference_ends`` stripe by stripe.  The CUDA kernel itself is held
against the plain version on the card in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from distributed_grep_tpu.models import pairset as ref_ps
from distributed_grep_tpu.ops import pallas_pairset
from distributed_grep_tpu_torch.models import pairset as port_ps
from distributed_grep_tpu_torch.ops import fdr_scan, layout, pairset_scan

SETS = {
    "rows": ([b"ab", b"zq", b"9!", b"x", bytes([200, 13])], False),
    "transposed -i": ([bytes([100 + i, b"UVWXYZ"[j]]) for i in range(40)
                       for j in range(6) if (i + 1) >> j & 1] + [b"Q"], True),
}


def models(name: str):
    pats, ic = SETS[name]
    ref = ref_ps.compile_pairset(pats, ignore_case=ic)
    port = port_ps.pairset_from_arrays(ref.rowcls, ref.words, ref.transposed,
                                       ref.n_classes, ref.patterns,
                                       ref.ignore_case)
    return ref, port


def stripes(members, seed: int, chunk: int, lanes: int) -> np.ndarray:
    """(chunk, lanes) stripe layout of seeded printable bytes with members
    planted (some upper case), and 2-byte members across stripe heads and
    32-byte words."""
    rng = np.random.default_rng(seed)
    text = rng.integers(32, 127, size=chunk * lanes, dtype=np.uint8)
    text[rng.integers(0, text.size, size=text.size // 60)] = 0x0A
    for i, p in enumerate(rng.choice(text.size - 4, size=text.size // 50,
                                     replace=False).tolist()):
        nd = members[i % len(members)]
        text[p : p + len(nd)] = np.frombuffer(
            nd.upper() if i % 3 == 0 else nd, np.uint8)
    arr = layout.to_device_array(
        text.tobytes(), layout.Layout(lanes=lanes, chunk=chunk, n_real=text.size))
    two = next(m for m in members if len(m) == 2)
    arr[0, ::5] = two[1]  # the second byte at a stripe head
    arr[-1, ::5] = two[0]
    if chunk >= 64:
        arr[31:33, 2::9] = np.frombuffer(two, np.uint8)[:, None]
    return arr


def as_stripes(arr: np.ndarray) -> torch.Tensor:
    """The (lanes, chunk) stripes of a (chunk, lanes) column array."""
    return torch.from_numpy(np.ascontiguousarray(arr.T))


@pytest.mark.parametrize("name", sorted(SETS))
def test_plain_words_bit_identical_to_reference_kernel(name):
    chunk, lanes = 512, 4096
    ref, port = models(name)
    assert ref.transposed == (name == "transposed -i")
    arr = stripes(ref.patterns, 1, chunk, lanes)
    want = np.asarray(pallas_pairset.pairset_scan_words(
        arr, ref, interpret=True)).reshape(chunk // 32, lanes)
    got = pairset_scan.pairset_scan_words(as_stripes(arr), port)
    assert got.dtype == torch.uint32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any()


@pytest.mark.parametrize("chunk,lanes", [(160, 64), (96, 32), (32, 96)])
@pytest.mark.parametrize("name", sorted(SETS))
def test_plain_words_equal_reference_ends(name, chunk, lanes):
    ref, port = models(name)
    arr = stripes(ref.patterns, chunk + lanes, chunk, lanes)
    want = np.zeros((chunk, lanes), dtype=bool)
    for lane in range(lanes):
        ends = ref_ps.reference_ends(ref, bytes(arr[:, lane]))
        want[ends - 1, lane] = True
    got = pairset_scan.pairset_scan_words(as_stripes(arr), port)
    np.testing.assert_array_equal(got.numpy(), fdr_scan.pack_bits(
        torch.from_numpy(want)).numpy())
    np.testing.assert_array_equal(
        ref_ps.reference_ends(ref, bytes(arr[:, 3])),
        port_ps.reference_ends(port, bytes(arr[:, 3])))


def test_out_ors_into_the_word_plane_and_cpu_is_not_counted():
    ref, port = models("rows")
    arr = as_stripes(stripes(ref.patterns, 2, 96, 64))
    base = torch.zeros((3, 64), dtype=torch.uint32)
    base[1, 5] = 1 << 31
    before = pairset_scan.launches
    want = pairset_scan.pairset_scan_words(arr, port).numpy()
    got = pairset_scan.pairset_scan_words(arr, port, out=base)
    assert got is base
    want[1, 5] |= np.uint32(1 << 31)
    np.testing.assert_array_equal(got.numpy(), want)
    assert pairset_scan.launches == before  # counts CUDA launches only
    with pytest.raises(ValueError):
        pairset_scan.pairset_scan_words(arr, port, out=base.to(torch.int32))
    with pytest.raises(ValueError):
        pairset_scan.pairset_scan_words(arr[:40], port)
