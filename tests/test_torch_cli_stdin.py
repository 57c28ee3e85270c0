"""The port CLI's standard input: the stream (stdin alone) and the spool
(stdin mixed with files, or re-read by -o/-b/context), against the
reference CLI -- in process with a buffered stdin, and by subprocess over
real pipes -- plus a live pipe that -q and -l must leave undrained, the
stream's block gathering and --metrics."""

import io
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from distributed_grep_tpu_torch import cli_inputs
from distributed_grep_tpu_torch.__main__ import main as port_main
from tests.test_torch_cli_display import _stdin, assert_same
from tests.test_torch_job import REPO, corpus  # noqa: F401

STREAM_FLAGS = [
    [], ["-c"], ["-c", "-H"], ["-c", "-h", "-H"], ["-l"], ["-L"], ["-q"],
    ["-m", "3"], ["-m", "0"], ["-v"], ["-v", "-c"], ["-w"], ["-x"], ["-h"],
    ["-i"], ["-c", "-m", "2"], ["-l", "-L"], ["-q", "-c"], ["-n", "-a"],
]


@pytest.mark.parametrize("flags", STREAM_FLAGS, ids=" ".join)
@pytest.mark.parametrize("form", ["no FILE", "-"])
def test_stream_identical_to_reference_cli(corpus, capsysbinary, monkeypatch,
                                           flags, form):
    data = Path(corpus[1]).read_bytes()  # CRLF lines, odd bytes
    pattern = "x" if "-x" in flags else "hello" if "-w" in flags else (
        "VOLCANO" if "-i" in flags else "volcano")
    args = [*flags, pattern, *(["-"] if form == "-" else [])]
    assert_same(capsysbinary, monkeypatch, args, stdin=data)


@pytest.mark.parametrize("query", [
    ["-F", "-e", "the", "-e", "x"], ["h[ae]llo"], ["--max-errors", "1",
                                                   "volcxno"],
    ["zzzq"], ["-L", "zzzq"], ["-E", "(volcano|hallo)$"]], ids=" ".join)
def test_stream_routes_identical(corpus, capsysbinary, monkeypatch, query):
    data = Path(corpus[2]).read_bytes()  # no trailing newline
    assert_same(capsysbinary, monkeypatch, query, stdin=data)


@pytest.mark.parametrize("flags", [
    ["volcano", "-", "FILE"], ["-c", "volcano", "FILE", "-"],
    ["-l", "volcano", "-", "FILE"], ["-L", "volcano", "FILE", "-"],
    ["-h", "volcano", "-", "FILE", "-"], ["-m", "2", "the", "FILE", "-"],
    ["-o", "volcano"], ["-o", "volcano", "-"], ["-o", "-b", "volcano", "-"],
    ["-C", "1", "volcano"], ["-A", "1", "volcano", "-", "FILE"],
    ["-b", "volcano"], ["-b", "-m", "1", "the", "-"],
    ["--include", "*.log", "volcano", "-", "FILE"],
    ["--exclude", "*", "-c", "volcano", "FILE", "-"],
    ["-r", "-c", "volcano", "-", "FILE"],
], ids=" ".join)
def test_spool_identical_to_reference_cli(corpus, capsysbinary, monkeypatch,
                                          flags):
    data = Path(corpus[0]).read_bytes()
    args = [corpus[3] if f == "FILE" else f for f in flags]
    out = assert_same(capsysbinary, monkeypatch, args, stdin=data)
    if not {"-c", "-L", "-h", "--exclude"} & set(flags):
        assert b"(standard input)" in out


def test_stream_spans_blocks(capsysbinary, monkeypatch):
    """Several read1 blocks: line numbers carry across blocks, a line cut
    by a block boundary is whole, -m stops mid-stream."""
    rng = np.random.default_rng(3)
    words = np.array([b"volcano", b"the", b"x", b"ash", b"\xff"])
    lines = [b" ".join(rng.choice(words, size=int(rng.integers(0, 40))))
             for _ in range(30000)]
    data = b"\n".join(lines) + b"\n"
    assert len(data) > (2 << 20)
    for flags in ([], ["-c"], ["-m", "7000"], ["-v", "-c"]):
        assert_same(capsysbinary, monkeypatch, [*flags, "volcano"],
                    stdin=data)


def test_stdin_blocks_gather_while_the_input_keeps_coming(tmp_path):
    """A regular file as stdin is always ready: its blocks fill to the
    gather size; a buffered stream without a file descriptor gives one
    block a read."""
    data = b"".join(b"line %d volcano\n" % i for i in range(200000))
    p = tmp_path / "in.txt"
    p.write_bytes(data)
    with open(p, "rb") as f:
        blocks = list(cli_inputs.stdin_blocks(f, 64 << 20))
    assert len(blocks) == 1 and blocks[0] == data
    with open(p, "rb") as f:
        blocks = list(cli_inputs.stdin_blocks(f, 1 << 20))
    assert b"".join(blocks) == data and len(blocks) in (3, 4)
    assert all(b.endswith(b"\n") for b in blocks)
    blocks = list(cli_inputs.stdin_blocks(
        io.BufferedReader(io.BytesIO(data + b"tail")), 64 << 20))
    assert b"".join(blocks) == data + b"tail" and len(blocks) >= 3
    assert blocks[-1].endswith(b"tail")


def test_stdin_blocks_close_when_a_live_pipe_goes_quiet():
    """Lines written 0.5 s apart each come out as their own block,
    before the next write."""
    import threading

    r, w = os.pipe()
    times = []

    def writer():
        for i in range(3):
            time.sleep(0.5)
            times.append(time.monotonic())
            os.write(w, b"line %d volcano\n" % i)
        os.close(w)

    t = threading.Thread(target=writer)
    t.start()
    with os.fdopen(r, "rb") as f:
        got = [(time.monotonic(), b)
               for b in cli_inputs.stdin_blocks(f, 64 << 20)]
    t.join(timeout=10)
    assert not t.is_alive()
    assert [b for _, b in got] == [b"line %d volcano\n" % i
                                   for i in range(3)]
    for (at, _), wrote in zip(got, times):
        assert 0 <= at - wrote < 0.45


def test_metrics_json_on_stderr_stdout_unchanged(corpus, capsysbinary,
                                                 monkeypatch):
    from distributed_grep_tpu_torch.ops.layout import DEFAULT_BATCH_BYTES
    from distributed_grep_tpu_torch.runtime.job import plan_map_splits

    assert port_main(["grep", "volcano", *corpus, "--device", "cpu"]) == 0
    plain = capsysbinary.readouterr().out
    for extra in ([], ["-c"], ["-o"], ["-L"]):
        assert port_main(["grep", *extra, "volcano", *corpus, "--device",
                          "cpu", "--metrics"]) == 0
        cap = capsysbinary.readouterr()
        if not extra:
            assert cap.out == plain
        metrics = json.loads(cap.err)
        assert {"counters", "seconds", "launches"} <= set(metrics)
        # several files batch: a map task a planned split
        assert metrics["counters"]["map_completed"] == len(plan_map_splits(
            [str(Path(f).resolve()) for f in corpus], DEFAULT_BATCH_BYTES))
        assert metrics["counters"].get("map_retries", 0) == 0
    _stdin(monkeypatch, Path(corpus[0]).read_bytes())
    assert port_main(["grep", "-c", "volcano", "--device", "cpu",
                      "--metrics"]) == 0
    cap = capsysbinary.readouterr()
    metrics = json.loads(cap.err)
    assert metrics["streaming_stdin"] is True
    assert metrics["counters"]["scans"] >= 1
    assert int(cap.out) == metrics["counters"]["selected_lines"] > 0


# ------------------------------------------------------- real pipes
@pytest.mark.parametrize("args", [["volcano"], ["-c", "volcano", "-"]],
                         ids=" ".join)
def test_pipe_identical_to_reference_cli(corpus, args):
    data = Path(corpus[1]).read_bytes()
    ref = subprocess.run(
        [sys.executable, "-m", "distributed_grep_tpu", "grep", *args,
         "--backend", "cpu"], input=data, capture_output=True, cwd=REPO,
        env=dict(os.environ, JAX_PLATFORMS="cpu", DGREP_LOG="WARNING",
                 PYTHONPATH=str(REPO)), timeout=300)
    port = subprocess.run(
        [sys.executable, "-m", "distributed_grep_tpu_torch", "grep", *args,
         "--device", "cpu", "--metrics"], input=data, capture_output=True,
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)), timeout=300)
    assert (port.returncode, port.stdout) == (ref.returncode, ref.stdout)
    assert port.returncode == 0
    assert json.loads(port.stderr)["counters"]["scans"] >= 1


@pytest.mark.parametrize("flag,want", [("-q", b""),
                                       ("-l", b"(standard input)\n")])
def test_live_pipe_returns_at_first_selected_line(flag, want):
    """-q and -l over a pipe that stays open after one matching line exit
    0 without waiting for the pipe to end."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_grep_tpu_torch", "grep", flag,
         "volcano", "--device", "cpu"], stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    try:
        proc.stdin.write(b"ash\nthe volcano\n")
        proc.stdin.flush()
        t0 = time.monotonic()
        rc = proc.wait(timeout=60)
        assert time.monotonic() - t0 < 60
        assert rc == 0, proc.stderr.read()
        assert proc.stdout.read() == want
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.stdin.close()
        proc.wait(timeout=10)
        proc.stdout.close()
        proc.stderr.close()
