"""The grep app's selection and count options and the CLI's flags, port vs
reference: byte-identical mr-out files (per-file truthiness under
presence_only), CLI stdout and exit codes, columnar records end to end,
and the flag still to port exiting 2 with its ROADMAP item."""

import pytest

from distributed_grep_tpu.runtime.job import run_job as ref_run_job
from distributed_grep_tpu.utils.config import JobConfig as RefJobConfig
from distributed_grep_tpu_torch.apps.base import KeyValue
from distributed_grep_tpu_torch.ops import engine as engine_mod
from distributed_grep_tpu_torch.runtime import shuffle
from distributed_grep_tpu_torch.runtime.columnar import LineBatch
from distributed_grep_tpu_torch.runtime.job import run_job
from distributed_grep_tpu_torch.utils.config import JobConfig
from tests.test_torch_job import ENGINE_OPTS, _cli, _outputs, corpus  # noqa: F401

QUERIES = {
    "literal": {"pattern": "volcano"},
    "-i": {"pattern": "Volcano", "ignore_case": True},
    "set": {"patterns": ["hello", "x", "the"]},
    "regex": {"pattern": "h[ae]llo"},
}
OPTIONS = {
    "invert": {"invert": True},
    "word_regexp": {"word_regexp": True},
    "line_regexp": {"line_regexp": True},
    "count_only": {"count_only": True},
}


def _jobs(tmp_path, files, opts, n_reduce=10):
    ref = ref_run_job(RefJobConfig(
        input_files=files, application="distributed_grep_tpu.apps.grep_tpu",
        app_options={**opts, "backend": "cpu"}, n_reduce=n_reduce,
        work_dir=str(tmp_path / "ref")), n_workers=2)
    port = run_job(JobConfig(
        input_files=files, app_options={**opts, **ENGINE_OPTS},
        n_reduce=n_reduce, work_dir=str(tmp_path / "port")),
        n_workers=2, device="cpu")
    return ref, port


@pytest.mark.parametrize("option", OPTIONS)
@pytest.mark.parametrize("query", QUERIES)
def test_mr_out_byte_identical_to_reference(tmp_path, corpus, query, option):
    ref, port = _jobs(tmp_path, corpus, {**QUERIES[query], **OPTIONS[option]})
    got = _outputs(port.output_files)
    assert got == _outputs(ref.output_files)
    assert sum(len(v) for v in got.values()) > 0


@pytest.mark.parametrize("opts", [
    {"invert": True, "word_regexp": True},
    {"count_only": True, "line_regexp": True, "invert": True},
    {"count_only": True, "word_regexp": True},
    {"pattern": "volcxno", "max_errors": 1, "count_only": True},
    {"pattern": "volcxno", "max_errors": 2, "invert": True,
     "ignore_case": True},
], ids=["-v -w", "-c -x -v", "-c -w", "-c approx", "-v approx -i"])
def test_option_combinations_byte_identical(tmp_path, corpus, opts):
    ref, port = _jobs(tmp_path, corpus, {"pattern": "hello", **opts})
    assert _outputs(port.output_files) == _outputs(ref.output_files)


def _counts(res) -> dict[str, int]:
    return {k: int(v) for k, v in res.iter_results()}


@pytest.mark.parametrize("opts", [
    {"pattern": "volcano"}, {"pattern": "zzzq"}, {"patterns": ["hello", "x"]},
    {"pattern": "hello", "word_regexp": True},
    {"pattern": "the", "invert": True},
], ids=["literal", "none", "set", "-w", "-v"])
def test_presence_only_per_file_truthiness(tmp_path, corpus, opts, monkeypatch):
    # several chunks a file, so presence may stop early
    monkeypatch.setattr(engine_mod, "FILE_CHUNK_BYTES", 1024)
    opts = {**opts, "count_only": True, "presence_only": True}
    ref, port = _jobs(tmp_path, corpus, opts)
    got, want = _counts(port), _counts(ref)
    assert sorted(got) == sorted(want) == sorted(corpus)
    assert {f: bool(n) for f, n in got.items()} == {
        f: bool(n) for f, n in want.items()}


@pytest.mark.parametrize("opts", [
    {"pattern": "volcano"}, {"pattern": "hello", "word_regexp": True},
    {"pattern": "the", "count_only": True},
    {"pattern": "h[ae]llo", "line_regexp": True, "count_only": True},
], ids=["print", "-w", "-c", "-c -x"])
def test_multi_chunk_streams_byte_identical(tmp_path, corpus, opts,
                                            monkeypatch):
    """Files of many 4 KB chunks: eager batches a chunk, file-global line
    numbers, the per-line confirm of -w/-x on a stream."""
    monkeypatch.setattr(engine_mod, "FILE_CHUNK_BYTES", 1024)
    ref, port = _jobs(tmp_path, corpus, opts, n_reduce=3)
    assert _outputs(port.output_files) == _outputs(ref.output_files)
    if not opts.get("count_only"):
        assert port.metrics["counters"]["map_batches"] > len(corpus)


def test_dense_output_stays_columnar_end_to_end(tmp_path, corpus,
                                                monkeypatch):
    """'the' matches most lines: bucketize gets one batch per file and no
    KeyValue, the reduce reads batches, and the output equals the
    reference's, also when the reduce spills."""
    seen = []
    orig_bucketize, orig_decode = shuffle.bucketize, shuffle.decode_records

    def bucketize(records, n_reduce):
        seen.extend(type(r) for r in records)
        return orig_bucketize(records, n_reduce)

    def decode_records(data):
        recs = orig_decode(data)
        seen.extend(type(r) for r in recs)
        return recs

    monkeypatch.setattr(shuffle, "bucketize", bucketize)
    monkeypatch.setattr(shuffle, "decode_records", decode_records)
    kv_made = []
    monkeypatch.setattr(KeyValue, "__new__", lambda cls, *a: (
        kv_made.append(a), tuple.__new__(cls, a))[1])
    ref, port = _jobs(tmp_path, corpus, {"pattern": "the"})
    assert kv_made == [] and seen and all(
        issubclass(t, LineBatch) for t in seen)
    assert port.metrics["counters"]["map_records"] > 1000
    assert _outputs(port.output_files) == _outputs(ref.output_files)
    KeyValue("k", "v")
    assert kv_made == [("k", "v")]  # the probe sees a construction
    spilled = run_job(JobConfig(
        input_files=corpus, app_options={"pattern": "the", **ENGINE_OPTS},
        work_dir=str(tmp_path / "spill"), reduce_memory_bytes=4096),
        n_workers=2, device="cpu")
    assert spilled.metrics["counters"]["reduce_spills"] >= 2
    assert _outputs(spilled.output_files) == _outputs(ref.output_files)


CLI_FLAGS = [
    ["-v", "volcano"], ["-c", "volcano"], ["-l", "volcano"],
    ["-L", "volcano"], ["-q", "volcano"], ["-w", "hello"], ["-x", "x"],
    ["-w", "-x", "x"], ["-m", "2", "volcano"], ["-m", "0", "volcano"],
    ["-c", "-v", "volcano"], ["-l", "-v", "volcano"], ["-L", "-w", "hall"],
    ["-i", "-w", "VOLCANO"], ["-h", "volcano"], ["-n", "-H", "-a", "hello"],
    ["-q", "zzzq"], ["-c", "-m", "3", "-F", "-e", "the", "-e", "x"],
]


@pytest.mark.parametrize("flags", CLI_FLAGS, ids=" ".join)
def test_cli_identical_to_reference_cli(corpus, flags):
    ref = _cli("distributed_grep_tpu", ["grep", *flags, *corpus,
                                        "--backend", "cpu"])
    port = _cli("distributed_grep_tpu_torch", ["grep", *flags, *corpus,
                                               "--device", "cpu"])
    assert port.returncode == ref.returncode, port.stderr
    assert port.stdout == ref.stdout


@pytest.mark.parametrize("case", ["-c -H one", "-c one", "-s missing",
                                  "missing", "-q missing", "-L -s missing"])
def test_cli_single_file_and_missing_file_identical(corpus, case):
    flags = case.split()[:-1]
    files = [corpus[0]] + ([corpus[0] + ".missing"]
                           if case.endswith("missing") else [])
    ref = _cli("distributed_grep_tpu", ["grep", *flags, "volcano", *files,
                                        "--backend", "cpu"])
    port = _cli("distributed_grep_tpu_torch", ["grep", *flags, "volcano",
                                               *files, "--device", "cpu"])
    assert (port.returncode, port.stdout) == (ref.returncode, ref.stdout)
    assert bool(port.stderr) == bool(ref.stderr)


@pytest.mark.parametrize("flags,item", [
    (["--follow"], "item 5"),
])
def test_deferred_flags_exit_2_naming_their_item(corpus, capsys, monkeypatch,
                                                  flags, item):
    """The flags once deferred to their ROADMAP item now run: --follow
    (item 5) prints what the one-shot run prints and exits as it does."""
    from distributed_grep_tpu_torch.__main__ import main

    monkeypatch.setenv("DGREP_FOLLOW_POLL_S", "0.01")
    assert main(["grep", "volcano", corpus[0], "--device", "cpu"]) == 0
    once = capsys.readouterr().out
    assert main(["grep", *flags, "--follow-idle-s", "0.05", "volcano",
                 corpus[0], "--device", "cpu"]) == 0
    got = capsys.readouterr()
    assert got.out == once and once
    assert f"'Slices still to port', {item}" not in got.err


def test_cli_refusals(corpus, capsys):
    from distributed_grep_tpu_torch.__main__ import main

    for argv, msg in (
            (["-m", "-1", "volcano", corpus[0]], "invalid max count"),
            (["-w", "--max-errors", "1", "volcano", corpus[0]], "-w/-x"),
            (["-x", "--max-errors", "1", "volcano", corpus[0]], "-w/-x"),
            (["volcano", str(__import__("pathlib").Path(corpus[0]).parent)],
             "is a directory")):
        assert main(["grep", *argv, "--device", "cpu"]) == 2
        assert msg in capsys.readouterr().err


def test_dense_receipt_checks_on_the_cpu(capsys):
    import json

    import torch

    from distributed_grep_tpu_torch.benchmarks import dense_receipt

    assert dense_receipt.main(["--mb", "0.5", "--check", "--device",
                               "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["check"] == "ok" and line["matched_lines"] > 1000
    assert line["counters"]["map_records"] == line["matched_lines"]
    stages = line["stages"]
    assert {"scan", "map_path_fn", "bucketize", "record_build",
            "shuffle_encode", "shuffle_decode", "collate_add",
            "reduce_format"} == set(stages)
    # one DeferredBatch: its record build is the split inside bucketize
    assert 0 < stages["record_build"] <= stages["bucketize"]
    # the stage clocks are gone once the receipt returns
    from distributed_grep_tpu_torch.ops.engine import GrepEngine

    assert GrepEngine.scan.__code__.co_name == "scan"
    assert shuffle.bucketize.__code__.co_name == "bucketize"
    if not torch.cuda.is_available():
        assert dense_receipt.main(["--mb", "0.5"]) == 2
