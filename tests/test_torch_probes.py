"""The port's two probe kernels and kernel_compare vs the reference.

Kernel 8 (the narrow-width probe): the plain PyTorch version of
``ops/narrow_probe.py`` gives words bit-identical (tolerance 0: integer
words) to the reference's ``benchmarks/probe_narrow.py:_run`` in Pallas
interpret mode, at i32, i16 and i8, and the three widths agree.

Kernel 7 (the one-hot product): the plain version of ``ops/mxu_probe.py``
on the reference probe's own 4 MiB input (2 lane blocks) gives, in its
last block, exactly the (128, 128) int32 the reference kernel returns in
interpret mode (the reference keeps only the last lane block's sum), and
every block equals byte counts @ member computed in numpy.

The port's kernel_compare and probe_narrow scripts print one JSON line per
engine or probe on the CPU (the table-DFA engines dfa, aho256 and
native_mt among them), name ROADMAP K2 and D1 for the two engines that are
not ported, and exit 2 without a card.  The CUDA kernels themselves are
held against their plain versions on the card in tests/test_torch_cuda.py.
"""

import functools
import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from distributed_grep_tpu_torch.benchmarks import kernel_compare as port_kc
from distributed_grep_tpu_torch.benchmarks import probe_design
from distributed_grep_tpu_torch.benchmarks import probe_narrow as port_pn
from distributed_grep_tpu_torch.ops import layout, mxu_probe, narrow_probe

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "benchmarks"))

import kernel_compare as ref_kc  # noqa: E402
import probe_narrow as ref_pn  # noqa: E402


@pytest.fixture
def interpret(monkeypatch):
    """Pallas kernels traced from here on run in interpret mode."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _volcano_text(chunk: int, lanes: int, seed: int) -> np.ndarray:
    """(chunk, lanes) layout of printable text with newlines, planted
    'volcano's, partial ones ('volca', 'olcano') and 'volcano' across word
    edges of some stripes."""
    rng = np.random.default_rng(seed)
    text = rng.integers(32, 127, size=chunk * lanes, dtype=np.uint8)
    text[rng.integers(0, text.size, size=text.size // 80)] = 0x0A
    for i, p in enumerate(rng.choice(text.size - 16, size=text.size // 2000,
                                     replace=False).tolist()):
        nd = (b"volcano", b"volca", b"olcano", b"vvolcano")[i % 4]
        text[p : p + len(nd)] = np.frombuffer(nd, np.uint8)
    lay = layout.Layout(lanes=lanes, chunk=chunk, n_real=text.size)
    arr = layout.to_device_array(text.tobytes(), lay)
    arr[29:36, ::37] = np.frombuffer(b"volcano", np.uint8)[:, None]
    arr[0:7, 5::41] = np.frombuffer(b"olcanov", np.uint8)[:, None]
    return arr


def test_narrow_plain_equals_pallas_interpret_at_every_width(interpret):
    chunk, lanes = 512, 4096
    arr = _volcano_text(chunk, lanes, seed=8)
    win = jnp.asarray(arr.reshape(chunk, lanes // 128, 128))
    plain = {}
    for width in ("i32", "i16", "i8"):
        ref = np.asarray(ref_pn._run(win, dt_name=width, chunk=chunk,
                                     lane_blocks=lanes // 4096))
        got = narrow_probe.narrow_probe_words(torch.from_numpy(arr), width)
        assert got.dtype == torch.uint32 and got.shape == (chunk // 32, lanes)
        np.testing.assert_array_equal(got.numpy(),
                                      ref.reshape(chunk // 32, lanes))
        plain[width] = got
    assert 100 < int(torch.count_nonzero(plain["i32"].view(torch.int32))) < 2000
    assert torch.equal(plain["i32"], plain["i16"])
    assert torch.equal(plain["i32"], plain["i8"])


def test_narrow_plain_masks_state_to_its_width():
    """The state steps at the chosen width; with the probe's classes no bit
    above the match bit survives, so every width gives the same words."""
    arr = np.frombuffer(b"volcano\nvolcanovolcan", np.uint8)
    data = np.full((32, 32), 0x20, np.uint8)
    data[: arr.size, 0] = arr
    data[:7, 31] = np.frombuffer(b"volcano", np.uint8)
    t = torch.from_numpy(data)
    for width in ("i32", "i16", "i8"):
        w = narrow_probe.narrow_probe_words(t, width)
        assert w[0, 0] == narrow_probe.MATCH_BIT and w[0, 31] == narrow_probe.MATCH_BIT
        assert int(torch.count_nonzero(w.view(torch.int32))) == 2
    with pytest.raises(ValueError, match="width"):
        narrow_probe.narrow_probe_words(t, "i4")


def test_mxu_plain_equals_pallas_interpret_last_block(interpret, monkeypatch):
    from distributed_grep_tpu.utils import slope as ref_slope

    captured = {}

    def capture(dev, chunk, pad_rows, scan, **kw):
        captured.setdefault("args", (dev, chunk, scan))
        return 1.0, 0

    monkeypatch.setattr(ref_slope, "slope_per_pass", capture)
    data = port_kc.make_corpus(4 << 20)
    assert data == ref_kc.make_corpus(4 << 20)
    ref_kc.bench_mxu_dot(data)
    dev, chunk, scan = captured["args"]
    ref = np.asarray(scan(dev[:chunk]))
    assert ref.shape == (128, 128) and ref.dtype == np.int32

    lay = layout.choose_layout(len(data), target_lanes=8192, min_chunk=512,
                               lane_multiple=4096, chunk_multiple=512)
    assert (lay.chunk, lay.lanes) == (chunk, 8192)
    arr = layout.to_device_array(data, lay)
    np.testing.assert_array_equal(np.asarray(dev[:chunk]).reshape(arr.shape), arr)
    member = mxu_probe.probe_member()
    got = mxu_probe.mxu_dot(torch.from_numpy(arr), torch.from_numpy(member))
    assert got.dtype == torch.int32 and got.shape == (2, 128, 128)
    np.testing.assert_array_equal(got[-1].numpy(), ref)

    x = arr.reshape(chunk, 2, 32, 128)
    for li in range(2):
        counts = np.zeros((128, 256), np.int64)
        cols = np.broadcast_to(np.arange(128), x[:, li].shape)
        np.add.at(counts, (cols.ravel(), x[:, li].ravel()), 1)
        np.testing.assert_array_equal(got[li].numpy(), counts @ member)
    assert not np.array_equal(got[0].numpy(), got[1].numpy())


def test_mxu_wrapper_rejects_what_the_kernel_does_not_take():
    member = torch.from_numpy(mxu_probe.probe_member())
    with pytest.raises(ValueError, match="chunk % 512"):
        mxu_probe.mxu_dot(torch.zeros((256, 4096), dtype=torch.uint8), member)
    with pytest.raises(ValueError, match="lanes % 4096"):
        mxu_probe.mxu_dot(torch.zeros((512, 2048), dtype=torch.uint8), member)
    with pytest.raises(ValueError, match="member"):
        mxu_probe.mxu_dot(torch.zeros((512, 4096), dtype=torch.uint8),
                          member.to(torch.int32))
    data = torch.zeros((512, 4096), dtype=torch.uint8)
    data[:, 7::128] = 200  # l = 7 of every (t, s) holds 200, the rest 0
    out = mxu_probe.mxu_dot(data, member)
    m = member.to(torch.int64)
    want = torch.where(torch.arange(128)[:, None] == 7,
                       512 * 32 * m[200], 512 * 32 * m[0])
    assert torch.equal(out[0].to(torch.int64), want)


def test_kernel_compare_prints_one_line_per_engine(capsys):
    engines = ["pallas", "nfa", "nfa_alt8", "pairset", "mxu_dot", "xla_sa",
               "dfa", "stride2", "aho256", "native_mt", "bogus"]
    assert port_kc.main(["--device", "cpu", "--size-mb", "1",
                         "--engines", ",".join(engines)]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["engine"] for ln in lines] == engines
    ported = {"pallas", "nfa", "nfa_alt8", "pairset", "mxu_dot", "dfa",
              "stride2", "aho256", "native_mt"}
    for ln in lines[:10]:
        if ln["engine"] in ported:
            assert ln["unit"] == "GB/s" and ln["value"] > 0, ln
    assert lines[8]["banks"] == 1  # 256 members fit one bank
    assert "D1" in lines[5]["error"], lines[5]  # xla_sa
    # K2 runs (stride2): its line has the dfa engine's keys
    assert set(lines[7]) == set(lines[6]) == {"engine", "value", "unit"}
    assert set(port_kc.NOT_PORTED) == {"xla_sa"}
    assert lines[10]["error"] == "ValueError: unknown engine bogus"


def test_probe_narrow_compile_probes_on_cpu(capsys):
    assert port_pn._corpus(1 << 16) == ref_pn._corpus(1 << 16)
    for probe, width in (("compile16", "i16"), ("compile8", "i8")):
        assert port_pn.main([probe, "--device", "cpu"]) == 0
        (line,) = capsys.readouterr().out.splitlines()
        rec = json.loads(line)
        assert rec["probe"] == f"compile_{width}" and rec["ok"] is True
        assert rec["nonzero_words"] > 900  # 1000 planted 'volcano's


@pytest.mark.parametrize("main", [port_kc.main, port_pn.main,
                                  probe_design.main])
def test_probes_exit_2_without_a_card(main, capsys):
    assert not torch.cuda.is_available()
    assert main([]) == 2
    assert capsys.readouterr().out == ""
