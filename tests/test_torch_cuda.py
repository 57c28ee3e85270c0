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
    cpu = torch.from_numpy(arr)
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
        before = nfa_scan.launches
        got = nfa_scan.nfa_scan_words(dev, model)
        torch.cuda.synchronize()
        assert nfa_scan.launches == before + 1
        want = nfa_scan.nfa_scan_words_plain(dev, model)
        assert torch.equal(got, want), pattern


@pytest.mark.parametrize("pattern,ic", [
    ("(volcano|hallo)", False), ("^volc", True), ("volcano$", False),
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
