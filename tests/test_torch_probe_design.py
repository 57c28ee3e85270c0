"""The two probe kernels' designs, modelled on the CPU.

Narrow probe (csrc/probe_narrow.cu): a numpy model written as the kernel
computes -- lanes packed 1, 2 or 4 a uint32 (i32, i16, i8), the exact
packed compare, the shift with the carry cleared, sub-stripes started by
an 8-byte warm-up -- gives words bit-identical (tolerance 0: integer
words) to ``narrow_probe_words_plain`` on seeded text where every byte
value stands next to the class bytes in one register; the packed compare
is exact on every pair of neighbouring element values.

One-hot product (csrc/mxu_dot.cu): the launcher's row ranges
(``row_bounds``) tile every (lane block, t) row exactly once, and the
kernel's flush rule splits them at lane-block crossings; the plain version
equals the one-hot product in numpy with a full-range int8 member.
"""

import numpy as np
import pytest
import torch

from distributed_grep_tpu_torch.ops import mxu_probe, narrow_probe

# bit p of a class mask <-> the byte it tests ('o' owns bits 1 and 6)
CLASS_BYTES = b"volcano"
BITS = {"i32": 32, "i16": 16, "i8": 8}
WARM = narrow_probe.WARM  # bytes of warm-up before a sub-stripe's first word


def test_class_bytes_are_the_plain_versions_classes():
    want = {}
    for byte, mask in narrow_probe.CLASSES:
        for p in range(7):
            if mask >> p & 1:
                want[p] = byte
    assert want == dict(enumerate(CLASS_BYTES))


def nonzero_top(v: np.ndarray, w: int) -> np.ndarray:
    """csrc/probe_narrow.cu nonzero_top<W>: bit W - 1 of each element set
    iff the element is nonzero (elements of 16 bits hold widened bytes)."""
    if w == 8:
        return ((v & np.uint32(0x7F7F7F7F)) + np.uint32(0x7F7F7F7F)) | v
    return v + np.uint32(0x7FFF7FFF)


def class_mask_packed(x: np.ndarray, w: int) -> np.ndarray:
    ones = np.uint32(0x01010101 if w == 8 else 0x00010001)
    top = np.uint32(int(ones) << (w - 1))
    miss = np.zeros_like(x)
    for p, byte in enumerate(CLASS_BYTES):
        ne = nonzero_top(x ^ np.uint32(byte * int(ones)), w) & top
        miss |= ne >> np.uint32(w - 1 - p)
    return ~miss & np.uint32(0x7F * int(ones))


def class_mask32(b: np.ndarray) -> np.ndarray:
    m = np.zeros_like(b)
    for p, byte in enumerate(CLASS_BYTES):
        m |= np.where(b == byte, np.uint32(1 << p), np.uint32(0))
    return m


def packed_registers(rows: np.ndarray, bits: int) -> list[np.ndarray]:
    """The state registers' inputs of each thread for (n, lanes) bytes: the
    4-byte load of lanes 4g .. 4g + 3, one byte a register at i32, two
    bytes widened to halfwords (__byte_perm 0x4140 / 0x4342) at i16, the
    load itself at i8."""
    v = np.ascontiguousarray(rows).view("<u4")  # (n, lanes / 4)
    if bits == 8:
        return [v]
    byte = [(v >> np.uint32(8 * i)) & np.uint32(0xFF) for i in range(4)]
    if bits == 16:
        return [byte[0] | (byte[1] << np.uint32(16)),
                byte[2] | (byte[3] << np.uint32(16))]
    return byte


def model_words(arr: np.ndarray, width: str, n_sub: int) -> np.ndarray:
    """(chunk // 32, lanes) uint32 words as csrc/probe_narrow.cu computes
    them with n_sub sub-stripes."""
    bits = BITS[width]
    per = 32 // bits
    ones = np.uint32({32: 1, 16: 0x00010001, 8: 0x01010101}[bits])
    chunk, lanes = arr.shape
    n_words = chunk // 32

    def mask(x):
        return class_mask32(x) if bits == 32 else class_mask_packed(x, bits)

    out = np.zeros((n_words, lanes), np.uint32)
    for j in range(n_sub):
        w0, w1 = n_words * j // n_sub, n_words * (j + 1) // n_sub
        regs = len(packed_registers(arr[:1], bits))
        s = [np.zeros(lanes // 4, np.uint32) for _ in range(regs)]
        if w0 > 0:
            warm = packed_registers(arr[w0 * 32 - WARM : w0 * 32], bits)
            for q in range(regs):
                for t in range(WARM):
                    s[q] = ((s[q] << np.uint32(1)) | ones) & mask(warm[q][t])
        for w in range(w0, w1):
            x = packed_registers(arr[w * 32 : w * 32 + 32], bits)
            for q in range(regs):
                acc = np.zeros(lanes // 4, np.uint32)
                for t in range(32):
                    s[q] = ((s[q] << np.uint32(1)) | ones) & mask(x[q][t])
                    acc |= s[q]
                for e in range(per):  # lane 4g + q * per + e
                    out[w, q * per + e :: 4] = (
                        (acc >> np.uint32(bits * e)) & np.uint32(0x40))
    return out


def _neighbour_text(chunk: int, lanes: int, seed: int) -> np.ndarray:
    """Rows of 4-byte registers, each holding one byte value next to class
    bytes (every value 0-255 at every position of a register, many times
    over), with 'volcano' planted down some lanes, across word edges."""
    rng = np.random.default_rng(seed)
    arr = rng.choice(np.frombuffer(b"volcan", np.uint8), size=(chunk, lanes))
    pos = rng.integers(0, 4, size=(chunk, lanes // 4))
    vals = rng.integers(0, 256, size=(chunk, lanes // 4), dtype=np.uint8)
    vals.reshape(-1)[: 256 * 4] = np.repeat(np.arange(256, dtype=np.uint8), 4)
    pos.reshape(-1)[: 256 * 4] = np.tile(np.arange(4), 256)
    rows, groups = np.indices(pos.shape)
    arr[rows, groups * 4 + pos] = vals
    word = np.frombuffer(b"volcano", np.uint8)[:, None]
    for c0 in range(0, chunk - 7, 11):
        arr[c0 : c0 + 7, (c0 % 13) :: 13] = word
    for edge in range(32, chunk, 32):  # ending 0..6 bytes into a word
        for k in range(1, 8):
            arr[edge - k : edge - k + 7, (k * 37 + edge) % 29 :: 29] = word
    # 'volcann' with an 'o' in the lane below the last 'n', in one register:
    # v = x ^ 'o' is 0x00 there and 0x01 in the 'n' lane, where a borrow
    # of the textbook zero test would see a seventh 'o' (a false match)
    for c0 in range(3, chunk - 7, 17):
        cols = np.arange(1 + c0 % 3, lanes, 4 * 7)
        arr[c0 : c0 + 7, cols] = np.frombuffer(b"volcann", np.uint8)[:, None]
        arr[c0 + 6, cols - 1] = ord("o")
    return arr


@pytest.mark.parametrize("width", ["i32", "i16", "i8"])
def test_packed_model_equals_plain(width):
    chunk, lanes = 128, 1024
    arr = _neighbour_text(chunk, lanes, seed=BITS[width])
    regs = arr.reshape(chunk, lanes // 4, 4)
    has_class = np.isin(regs, np.frombuffer(b"volcan", np.uint8))
    for i in range(4):  # every value next to a class byte at every position
        others = np.delete(has_class, i, axis=2).any(axis=2)
        assert np.unique(regs[:, :, i][others]).size == 256, i
    want = narrow_probe.narrow_probe_words_plain(torch.from_numpy(arr), width)
    want = want.numpy()
    assert 200 < np.count_nonzero(want) < want.size // 2
    for n_sub in (1, 2, 3, 4):
        np.testing.assert_array_equal(model_words(arr, width, n_sub), want,
                                      err_msg=f"{width} n_sub={n_sub}")


@pytest.mark.parametrize("w", [8, 16])
def test_packed_nonzero_test_is_exact_on_every_neighbour_pair(w):
    """The textbook zero-byte test flags the element above a real zero when
    a borrow crosses; this one flags exactly the zero elements."""
    a, b = np.meshgrid(np.arange(256, dtype=np.uint32),
                       np.arange(256, dtype=np.uint32), indexing="ij")
    a, b = a.ravel(), b.ravel()
    top = np.uint32(0x80808080 if w == 8 else 0x80008000)
    if w == 8:  # every pair at every pair of neighbouring bytes
        for lo in range(3):
            v = (a << np.uint32(8 * lo)) | (b << np.uint32(8 * lo + 8))
            got = nonzero_top(v, 8) & top
            want = ((a != 0).astype(np.uint32) << np.uint32(8 * lo + 7)) | (
                (b != 0).astype(np.uint32) << np.uint32(8 * lo + 15))
            np.testing.assert_array_equal(got, want)
    else:
        v = a | (b << np.uint32(16))
        got = nonzero_top(v, 16) & top
        want = ((a != 0).astype(np.uint32) << np.uint32(15)) | (
            (b != 0).astype(np.uint32) << np.uint32(31))
        np.testing.assert_array_equal(got, want)


def flushes(bounds: list[int], chunk: int) -> list[tuple[int, int, int]]:
    """(lane block, first row, end row) of each flush csrc/mxu_dot.cu makes
    for these ranges: after a row that ends its lane block, and after the
    last row of a block's range."""
    out = []
    for r0, r1 in zip(bounds, bounds[1:]):
        start = r0
        for r in range(r0, r1):
            if r + 1 == r1 or (r + 1) % chunk == 0:
                out.append((r // chunk, start, r + 1))
                start = r + 1
    return out


@pytest.mark.parametrize("lane_blocks,chunk", [(1, 512), (2, 512), (16, 1024)])
def test_mxu_row_ranges_tile_every_row_and_flush_at_crossings(lane_blocks,
                                                             chunk):
    rows = lane_blocks * chunk
    for blocks in sorted({1, 2, 3, 7, 33, 132, rows - 1, rows, rows + 5,
                          mxu_probe.MAX_BLOCKS} & set(range(1, 1001))):
        bounds = mxu_probe.row_bounds(lane_blocks, chunk, blocks)
        assert len(bounds) == blocks + 1
        assert bounds[0] == 0 and bounds[-1] == rows
        assert all(a <= b for a, b in zip(bounds, bounds[1:]))
        sizes = np.diff(bounds)
        assert sizes.max() - sizes.min() <= 1  # as even as whole rows allow
        seen = np.zeros(rows, np.int64)
        for li, r0, r1 in flushes(bounds, chunk):
            assert li * chunk <= r0 < r1 <= (li + 1) * chunk  # one lane block
            seen[r0:r1] += 1
        np.testing.assert_array_equal(seen, 1)
        # a range that crosses k lane-block ends flushes k + 1 times at most
        for r0, r1 in zip(bounds, bounds[1:]):
            n = sum(1 for _li, a, _b in flushes([r0, r1], chunk) if a >= r0)
            assert n == (0 if r0 == r1 else
                         (r1 - 1) // chunk - r0 // chunk + 1)


def test_mxu_rejects_block_counts_the_kernel_does_not_take():
    data = torch.zeros((512, 4096), dtype=torch.uint8)
    member = torch.from_numpy(mxu_probe.probe_member())
    for blocks in (0, mxu_probe.MAX_BLOCKS + 1):
        with pytest.raises(ValueError, match="blocks"):
            mxu_probe.mxu_dot(data, member, blocks=blocks)


def test_mxu_plain_equals_numpy_one_hot_product_with_full_range_member():
    rng = np.random.default_rng(77)
    chunk, lanes = 512, 8192
    data = rng.integers(0, 256, size=(chunk, lanes), dtype=np.uint8)
    data[:, 5::128] = 255  # one lane column always the top value
    member = rng.integers(-128, 128, size=(256, 128), dtype=np.int8)
    member[255] = -128
    got = mxu_probe.mxu_dot_plain(torch.from_numpy(data),
                                  torch.from_numpy(member)).numpy()
    eye = np.eye(256, dtype=np.int32)
    x = data.reshape(chunk, lanes // 4096, 32, 128)
    for li in range(lanes // 4096):
        onehot = np.zeros((128, 256), np.int64)  # summed over the steps
        for t in range(chunk):
            onehot += eye[x[t, li]].sum(axis=0)
        want = onehot @ member.astype(np.int64)
        np.testing.assert_array_equal(got[li], want)
        assert want[5].tolist() == (chunk * 32 * member[255].astype(np.int64)).tolist()
        assert want.min() < 0 < want.max()


@pytest.mark.parametrize("source,name,value", [
    ("probe_narrow", "kLanesPerThread", narrow_probe.LANES_PER_THREAD),
    ("probe_narrow", "kWarm", narrow_probe.WARM),
    ("mxu_dot", "kMaxBlocks", mxu_probe.MAX_BLOCKS)])
def test_kernel_constants_equal_the_wrappers_copies(source, name, value):
    import re

    from distributed_grep_tpu_torch.ops import _build

    text = (_build.CSRC / f"{source}.cu").read_text()
    (got,) = re.findall(rf"constexpr int {name} = (\d+);", text)
    assert int(got) == value


def test_probe_design_forces_the_launchers_count():
    from distributed_grep_tpu_torch.benchmarks import probe_design, substripe_sweep
    from distributed_grep_tpu_torch.ops import _build

    src = (_build.CSRC / "probe_narrow.cu").read_text()
    line, forced = probe_design.LAUNCH_LINE
    got = substripe_sweep.variant_source("probe_narrow", 4,
                                         probe_design.LAUNCH_LINE)
    assert src.count(line) == 1 and line not in got
    assert got == src.replace(line, forced.format(n=4))
    assert "probe_narrow" not in substripe_sweep.LAUNCH_LINE


def test_build_keeps_nvccs_output_beside_the_library(tmp_path, monkeypatch):
    import sys

    from distributed_grep_tpu_torch.ops import _build

    calls = []

    def fake_nvcc(src, out):  # writes the library, prints a ptxas line
        calls.append(src)
        return [sys.executable, "-c",
                f"open({str(out)!r}, 'wb').write(b'so'); "
                f"print('ptxas info : Used 32 registers')"]

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "nvcc_command", fake_nvcc)
    with pytest.raises(FileNotFoundError):
        _build.saved_log("probe_narrow")
    _build.build_all(("probe_narrow",))
    assert _build._target("probe_narrow").read_bytes() == b"so"
    assert "Used 32 registers" in _build.saved_log("probe_narrow")
    _build.build_all(("probe_narrow",))
    assert len(calls) == 1  # built once
    _build._target("probe_narrow").with_suffix(".log").unlink()
    _build.build_all(("probe_narrow",))
    assert len(calls) == 2  # a library without its log is built again
    assert "Used 32 registers" in _build.saved_log("probe_narrow")
    assert sorted(p.suffix for p in tmp_path.iterdir()) == [".log", ".so"]
