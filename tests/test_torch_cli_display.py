"""The port CLI's display options (-o, -A/-B/-C, -b) and the bytes-mode
result streams, against the reference CLI and JobResult: byte-identical
stdout and the same exit code, both CLIs called in process."""

import io
import os
import sys
from pathlib import Path

import numpy as np
import pytest

from distributed_grep_tpu.__main__ import main as ref_main
from distributed_grep_tpu.runtime.job import JobResult as RefJobResult
from distributed_grep_tpu.runtime.job import (
    parse_grep_key_bytes as ref_parse_grep_key_bytes,
)
from distributed_grep_tpu_torch import cli_display
from distributed_grep_tpu_torch.__main__ import main as port_main
from distributed_grep_tpu_torch.runtime import job as job_mod
from distributed_grep_tpu_torch.runtime.job import (
    GREP_KEY_RE,
    JobResult,
    parse_grep_key_bytes,
    run_job,
)
from distributed_grep_tpu_torch.utils.config import JobConfig
from tests.test_torch_job import ENGINE_OPTS, corpus  # noqa: F401


def _stdin(monkeypatch, data: bytes | None) -> None:
    if data is not None:
        monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(
            io.BufferedReader(io.BytesIO(data))))


def run_both(capsysbinary, monkeypatch, argv, stdin: bytes | None = None):
    """(exit code, stdout) of the port CLI (--device cpu) and of the
    reference CLI (--backend cpu) on ``argv``, ``stdin`` fed to each."""
    _stdin(monkeypatch, stdin)
    port_rc = port_main(["grep", *argv, "--device", "cpu"])
    port = capsysbinary.readouterr()
    _stdin(monkeypatch, stdin)
    ref_rc = ref_main(["grep", *argv, "--backend", "cpu"])
    ref = capsysbinary.readouterr()
    return (port_rc, port.out, port.err), (ref_rc, ref.out)


def assert_same(capsysbinary, monkeypatch, argv, stdin=None) -> bytes:
    (prc, pout, perr), (rrc, rout) = run_both(capsysbinary, monkeypatch,
                                              argv, stdin)
    assert prc == rrc, perr
    assert pout == rout
    return pout


DISPLAY_FLAGS = [
    # -o
    ["-o", "volcano"], ["-o", "-i", "VOLCANO"], ["-o", "-w", "the"],
    ["-o", "-F", "-e", "the", "-e", "volcano"], ["-o", "h[ae]llo"],
    ["-o", "-m", "2", "volcano"], ["-o", "-b", "volcano"],
    ["-o", "-v", "volcano"], ["-o", "-h", "x"], ["-o", "-x", "x"],
    ["-o", "-b", "-i", "-w", "HALLO"], ["-o", "-c", "volcano"],
    ["-o", "-q", "volcano"], ["-o", "-l", "the"], ["-o", "-E", "[[:digit:]]+"],
    ["-o", "-m", "1", "-b", "-h", "the"], ["-o", "e"],
    ["-o", "-F", "-e", "th", "-e", "the"],
    # context
    ["-A", "1", "volcano"], ["-B", "2", "volcano"], ["-C", "1", "volcano"],
    ["-C", "1", "-m", "2", "volcano"], ["-C", "1", "-b", "volcano"],
    ["-C", "1", "-h", "volcano"], ["-A", "2", "-B", "1", "-v", "the"],
    ["-C", "0", "volcano"], ["-C", "1", "-c", "volcano"],
    ["-C", "2", "-l", "volcano"], ["-B", "1", "-w", "x"],
    ["-A", "1", "-b", "-m", "3", "hello"],
    ["-C", "1", "--max-errors", "1", "volcxno"],
    # -b
    ["-b", "volcano"], ["-b", "-m", "1", "hello"], ["-b", "-h", "-v", "the"],
    ["-b", "-w", "x"], ["-b", "-c", "volcano"],
    ["-b", "--max-errors", "1", "-i", "VOLCXNO"],
    # the default print, the record merge and the parsed loop
    ["volcano"], ["-h", "the"], ["-m", "3", "the"], ["zzzq"],
]


@pytest.mark.parametrize("flags", DISPLAY_FLAGS, ids=" ".join)
def test_display_flags_identical_to_reference_cli(corpus, capsysbinary,
                                                  monkeypatch, flags):
    assert_same(capsysbinary, monkeypatch, [*flags, *corpus])


@pytest.mark.parametrize("flags", [["-o", "volcano"], ["-C", "1", "the"],
                                   ["-b", "hello"], ["the"], ["-o", "-b", "x"]],
                         ids=" ".join)
def test_display_flags_on_one_file_identical(corpus, capsysbinary,
                                             monkeypatch, flags):
    assert_same(capsysbinary, monkeypatch, [*flags, corpus[1]])


@pytest.mark.parametrize("block", [7, 64, 4096])
@pytest.mark.parametrize("flags", [["-C", "1", "volcano"],
                                   ["-B", "3", "-b", "the"],
                                   ["-A", "2", "-m", "3", "x"],
                                   ["-b", "hello"], ["-C", "4", "-v", "the"]],
                         ids=" ".join)
def test_context_and_offsets_read_in_small_blocks(corpus, capsysbinary,
                                                  monkeypatch, block, flags):
    """The block readers of -b and context at block sizes below a line's
    length: the carried partial lines, lines longer than a block, a file
    without a trailing newline."""
    monkeypatch.setattr(cli_display, "OFFSET_BLOCK_BYTES", block)
    assert_same(capsysbinary, monkeypatch, [*flags, *corpus])


@pytest.mark.parametrize("before,after", [(0, 0), (1, 0), (0, 2), (2, 3),
                                          (5, 5)])
def test_context_window_lines_equal_brute_force(before, after):
    rng = np.random.default_rng(before * 10 + after)
    for _ in range(20):
        lines = set(rng.integers(1, 60, size=int(rng.integers(0, 12))).tolist())
        want = sorted({n for m in lines
                       for n in range(max(1, m - before), m + after + 1)})
        got = cli_display.context_window_lines(lines, before, after)
        assert got.tolist() == want


def test_only_matching_refused_with_max_errors(corpus, capsysbinary,
                                               monkeypatch):
    (prc, pout, perr), (rrc, rout) = run_both(
        capsysbinary, monkeypatch, ["-o", "--max-errors", "1", "volcano",
                                    corpus[0]])
    assert prc == rrc == 2 and pout == rout == b""
    assert b"-o is not supported with --max-errors" in perr


@pytest.mark.parametrize("argv,n_files", [
    (["volcano"], 4), (["the"], 1), (["-o", "volcano"], 4),
    (["-o", "-h", "the"], 4)], ids=lambda x: " ".join(x)
    if isinstance(x, list) else str(x))
def test_bytes_paths_never_decode_a_record(corpus, capsysbinary, monkeypatch,
                                          argv, n_files):
    """The default print and plain -o over a fileline_sorted job read the
    outputs as bytes: neither the str record merge nor the str file
    reader runs."""
    _, (ref_rc, want) = run_both(capsysbinary, monkeypatch,
                                 [*argv, *corpus[:n_files]])

    def forbidden(*_a, **_k):
        raise AssertionError("a record was decoded to str")

    monkeypatch.setattr(JobResult, "iter_results_sorted", forbidden)
    monkeypatch.setattr(JobResult, "_iter_file", staticmethod(forbidden))
    assert port_main(["grep", *argv, *corpus[:n_files], "--device",
                      "cpu"]) == ref_rc == 0
    assert capsysbinary.readouterr().out == want


# ----------------------------------------------------- result streams
def _names_in_both_orders(tmp_path: Path) -> list[str]:
    """Files whose names order differently as UTF-8 bytes and as
    surrogateescape code points (b'\\xff' is U+DCFF, below U+E000 whose
    UTF-8 starts with 0xEE)."""
    rng = np.random.default_rng(7)
    paths = []
    for raw in (b"a\xff.txt", "a\ue000.txt".encode(), b"plain.txt"):
        p = tmp_path / os.fsdecode(raw)
        lines = [b" ".join(rng.choice([b"volcano", b"the", b"x", b"\xfe"],
                                      size=int(rng.integers(0, 6))))
                 for _ in range(300)]
        p.write_bytes(b"\n".join(lines) + b"\n")
        paths.append(str(p))
    return paths


def _port_result(tmp_path, files, pattern="volcano", n_reduce=4):
    return run_job(JobConfig(
        input_files=files, app_options={"pattern": pattern, **ENGINE_OPTS},
        n_reduce=n_reduce, work_dir=str(tmp_path / "job")),
        n_workers=2, device="cpu")


@pytest.mark.parametrize("which", ["one file", "several", "names"])
def test_display_blocks_equal_record_merge_and_reference(tmp_path, corpus,
                                                         which):
    files = {"one file": corpus[:1], "several": corpus,
             "names": _names_in_both_orders(tmp_path)}[which]
    res = _port_result(tmp_path, files)
    assert res.fileline_sorted
    blocks = b"".join(res.display_blocks_sorted())
    assert blocks == b"".join(res.iter_display_bytes_sorted())
    assert blocks.count(b"\n") > 10
    ref = RefJobResult(output_files=res.output_files, fileline_sorted=True)
    assert blocks == b"".join(ref.display_blocks_sorted())
    # the str merge orders the same records the same way
    want = b"".join(f"{k} {v}\n".encode("utf-8", "surrogateescape")
                    for k, v in res.iter_results_sorted())
    assert blocks == want
    if which == "names":  # the code-point order, not the bytes order
        heads = [ln.split(b" (line number #")[0]
                 for ln in blocks.splitlines()]
        firsts = list(dict.fromkeys(heads))
        assert [h.rsplit(b"/", 1)[1] for h in firsts] == [
            b"a\xff.txt", "a\ue000.txt".encode(), b"plain.txt"]
        assert sorted(firsts) != firsts


def test_single_path_block_taken_only_for_one_path(tmp_path, corpus,
                                                    monkeypatch):
    one = _port_result(tmp_path / "1", corpus[:1])
    assert one._single_path_display_block() is not None
    many = _port_result(tmp_path / "2", corpus)
    assert many._single_path_display_block() is None
    # a file that does not end in a newline would fuse two records
    out = one.output_files[0]
    out.write_bytes(out.read_bytes().rstrip(b"\n"))
    assert one._single_path_display_block() is None
    assert b"".join(one.display_blocks_sorted()) == b"".join(
        one.iter_display_bytes_sorted())
    # above the cap the record merge runs
    monkeypatch.setattr(JobResult, "DISPLAY_VECTOR_CAP", 16)
    calls = []
    monkeypatch.setattr(JobResult, "_single_path_display_block",
                        lambda self: calls.append(1))
    assert b"".join(many.display_blocks_sorted()) == b"".join(
        many.iter_display_bytes_sorted())
    assert calls == []


@pytest.mark.parametrize("key", [
    b"/a/b (line number #12)", b"/a (line number #7) (line number #3)",
    b"x (line number #)", b"x (line number #1a)", b"x (line number #-1)",
    b"x (line number #1", b"plain", b"(line number #4)",
    " (line number #٣)".encode(), b"p\xff (line number #0)",
])
def test_parse_grep_key_bytes_equals_reference_and_regex(key):
    got = parse_grep_key_bytes(key)
    assert got == ref_parse_grep_key_bytes(key)
    m = GREP_KEY_RE.match(key.decode("utf-8", "surrogateescape"))
    if got is None:
        assert m is None or not m.group(2).isascii()
    else:
        assert m and m.group(1).encode("utf-8", "surrogateescape") == got[0]
        assert int(m.group(2)) == got[1]


def test_iter_results_sorted_external_sort_spills(tmp_path, corpus,
                                                  monkeypatch):
    """Outputs that are not fileline_sorted go through the bounded
    external sort; with a tiny memory limit it spills and still gives
    grep_key_sort's order."""
    res = _port_result(tmp_path, corpus, pattern="the")
    res.fileline_sorted = False
    runs = []
    orig_spill = job_mod.ExternalReducer._spill

    def spill(self):
        runs.append(1)
        return orig_spill(self)

    monkeypatch.setattr(job_mod.ExternalReducer, "_spill", spill)
    monkeypatch.setattr(job_mod, "SORT_MEMORY_BYTES", 4096)
    got = list(res.iter_results_sorted())
    assert len(runs) >= 2
    assert got == sorted(res.iter_results(), key=job_mod.grep_key_sort)
    assert len(got) > 1000
    # and the same records as the k-way merge of the sorted files
    res.fileline_sorted = True
    assert got == list(res.iter_results_sorted())


def test_iter_grep_keys_and_record_bytes(tmp_path, corpus):
    res = _port_result(tmp_path, corpus)
    keys = list(res.iter_grep_keys())
    want = [(m.group(1), int(m.group(2))) for m in (
        GREP_KEY_RE.match(k) for k, _ in res.iter_results()) if m]
    assert keys == want and keys
    recs = list(res.iter_grep_records_bytes())
    assert [k for k, _ in recs] == sorted(want)
    assert [v.decode("utf-8", "surrogateescape") for _, v in recs] == [
        v for _, v in res.iter_results_sorted()]
