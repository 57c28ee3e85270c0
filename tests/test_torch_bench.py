"""The port's measuring path on the CPU: the slope harness, the headline
bench and the BASELINE config suite, against the reference's.

The slope harness keeps the reference's contract (even chain lengths, an
exact per-pass count-drift check, the count band, a noise gate that
escalates r2 three times and then raises).  ``bench --device cpu`` prints
exactly one JSON line; with the default device and no card it prints
nothing and exits 2.  The config suite builds the reference's corpora byte
for byte, and each config's engine on the CPU matches the independent
oracle and the reference suite's matched lines (a twin of
tests/test_bench_suite.py).
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from distributed_grep_tpu_torch import bench as port_bench
from distributed_grep_tpu_torch.benchmarks import baseline_configs as port_bc
from distributed_grep_tpu_torch.utils import slope

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "benchmarks"))

import baseline_configs as ref_bc  # noqa: E402


def _ref_bench():
    spec = importlib.util.spec_from_file_location("ref_bench", REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _dev(chunk=64, lanes=32, pad=slope.PAD_ROWS):
    """A (chunk + pad, lanes) tensor: 'x' rows, a 'y' in rows 0..pad-1 of
    lane 0 (seen by even windows only) and one in row chunk - 1 of lane 1
    (seen by both)."""
    d = torch.full((chunk + pad, lanes), ord("x"), dtype=torch.uint8)
    d[5, 0] = ord("y")
    d[chunk - 1, 1] = ord("y")
    return d


def _count_y(win):
    return (win == ord("y")).sum()


def test_slope_counts_even_and_odd_windows():
    per_pass, count = slope.slope_per_pass(_dev(), 64, slope.PAD_ROWS,
                                           _count_y, r1=2, r2=4)
    assert per_pass > 0
    assert count == 1.5  # even windows see both 'y's, odd windows one


@pytest.mark.parametrize("r1,r2", [(1, 4), (2, 5), (3, 3)])
def test_slope_rejects_odd_chain_lengths(r1, r2):
    with pytest.raises(ValueError, match="must be even"):
        slope.slope_per_pass(_dev(), 64, slope.PAD_ROWS, _count_y, r1=r1, r2=r2)


def test_slope_per_pass_count_drift_asserts():
    calls = []

    def drifting(win):
        calls.append(1)
        return torch.tensor(len(calls))  # a count that changes every pass

    with pytest.raises(AssertionError, match="count drift"):
        slope.slope_per_pass(_dev(), 64, slope.PAD_ROWS, drifting, r1=2, r2=4)


def test_slope_count_band_asserts():
    with pytest.raises(AssertionError, match="match count off"):
        slope.slope_per_pass(_dev(), 64, slope.PAD_ROWS, _count_y, r1=2, r2=4,
                             count_range=(5, 10))


def test_slope_noise_gate_escalates_three_times_then_raises(monkeypatch):
    seen = []

    def flat(self, r, iters):
        seen.append(r)
        return 0.01  # a chain whose time does not grow with r

    monkeypatch.setattr(slope._CpuChains, "seconds", flat)
    with pytest.raises(RuntimeError, match="noise gate"):
        slope.slope_per_pass(_dev(), 64, slope.PAD_ROWS, _count_y, r1=2, r2=4)
    assert seen == [2, 4, 2, 12, 2, 36, 2, 108]


def test_slope_median_over_measurements(monkeypatch):
    times = iter([1.0, 2.0, 1.0, 5.0, 1.0, 3.0])  # slopes 0.5, 2.0, 1.0

    monkeypatch.setattr(slope._CpuChains, "seconds",
                        lambda self, r, iters: next(times))
    per_pass, _ = slope.slope_per_pass(_dev(), 64, slope.PAD_ROWS, _count_y,
                                       r1=2, r2=4, measurements=3)
    assert per_pass == 1.0


def test_device_setup_pads_with_newline_rows():
    data = bytes(range(256)) * 400
    dev, lay, pad = slope.device_setup(data, "cpu")
    assert pad == slope.PAD_ROWS and dev.shape == (lay.chunk + pad, lay.lanes)
    assert lay.lanes % 32 == 0 and lay.chunk % 32 == 0
    assert bool((dev[lay.chunk:] == 0x0A).all())
    assert slope.pass_bytes(dev, lay.chunk) == lay.chunk * lay.lanes
    assert slope.reps("cpu", 8, 104) == slope.CPU_REPS


def test_bench_corpus_equals_reference():
    assert port_bench.make_corpus(200_000) == _ref_bench().make_corpus(200_000)


def test_bench_cpu_prints_one_json_line():
    env = dict(os.environ, BENCH_CORPUS_BYTES="600000", PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "distributed_grep_tpu_torch.bench",
         "--device", "cpu"],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1, proc.stdout
    rec = json.loads(lines[0])
    assert set(rec) == {"metric", "value", "unit", "vs_baseline"}
    assert rec["metric"] == "regex_scan_throughput_per_chip_literal_cpu"
    assert rec["unit"] == "GB/s" and rec["value"] > 0
    assert rec["vs_baseline"] == rec["value"] / 10.0


def test_bench_default_device_without_a_card_exits_2(capsys):
    assert not torch.cuda.is_available()
    assert port_bench.main([]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "torch.cuda.is_available() is False" in out.err


@pytest.mark.parametrize("num", [1, 2, 3, 4, 5])
def test_config_corpora_equal_reference(num):
    size = 150_000
    kw = {"n_patterns": 300} if num == 5 else {}
    got, want = port_bc.CONFIGS[num](size, **kw), ref_bc.CONFIGS[num](size, **kw)
    assert got == want


@pytest.mark.parametrize("num", [1, 2, 3, 4, 5])
def test_config_runs_checks_and_matches_reference(num):
    kw = {"n_patterns": 300} if num == 5 else {}
    got = port_bc.run_config(num, size=200_000, device="cpu", check=True, **kw)
    want = ref_bc.run_config(num, size=200_000, backend="device", check=True, **kw)
    assert got["check"] == "ok", got
    assert want["check"] == "ok", want
    for key in ("config", "name", "unit", "timing", "matched_lines", "bytes",
                "check_bytes"):
        assert got[key] == want[key], key
    assert got["matched_lines"] > 0 or num == 3
    mode = {1: "shift_and", 2: "fdr", 3: "fdr", 4: "nfa", 5: "fdr"}[num]
    assert got["mode"] == mode and got["banks"] >= 1


@pytest.mark.parametrize("num", [1, 4, 5])
def test_config_slope_timing_on_cpu(num):
    kw = {"n_patterns": 300} if num == 5 else {}
    out = port_bc.run_config(num, size=100_000, device="cpu", timing="slope", **kw)
    assert out["timing"] == "slope(device-resident)" and out["value"] > 0
    assert out["engine"] == {1: "shift_and_filt3", 4: "nfa_filt",
                             5: "fdr_x1"}[num]


def test_config_main_prints_one_line_per_config(capsys):
    assert port_bc.main(["--device", "cpu", "--size-mb", "0.1", "--configs",
                         "1,4", "--check"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["config"] for ln in lines] == [1, 4]
    assert all(ln["check"] == "ok" for ln in lines), lines
    assert port_bc.main(["--configs", "1"]) == 2  # no card, default device
    assert capsys.readouterr().out == ""


def test_config_launches_per_segment():
    from distributed_grep_tpu_torch.ops.engine import GrepEngine

    assert port_bc.launches_per_segment(GrepEngine("volcano", device="cpu")) == 1
    sets = GrepEngine(patterns=["volcano", "needle", "#"], device="cpu")
    assert sets.mode == "fdr" and sets.fdr_pairset is not None
    assert port_bc.launches_per_segment(sets) == len(sets.fdr.banks) + 1
