"""Cross-file batching in the port against the reference (backend "cpu"):
the map-split planner, the packer and its demux, ``GrepEngine.scan_batch``
per file over every route family, the small-input host scan, batched
``run_job`` outputs and the multi-file CLI.  Tolerance: exact (equal
integer arrays, byte-identical bytes)."""

from pathlib import Path

import numpy as np
import pytest

from distributed_grep_tpu.ops import layout as ref_layout
from distributed_grep_tpu.ops.engine import GrepEngine as RefEngine
from distributed_grep_tpu.runtime.job import plan_map_splits as ref_plan
from distributed_grep_tpu.runtime.job import run_job as ref_run_job
from distributed_grep_tpu.utils.config import JobConfig as RefJobConfig
from distributed_grep_tpu_torch.apps import grep_cuda
from distributed_grep_tpu_torch.apps.loader import from_module
from distributed_grep_tpu_torch.ops import engine as engine_mod
from distributed_grep_tpu_torch.ops import layout
from distributed_grep_tpu_torch.ops.engine import GrepEngine
from distributed_grep_tpu_torch.runtime.job import plan_map_splits, run_job
from distributed_grep_tpu_torch.utils.config import JobConfig
from tests.test_torch_cli_display import assert_same
from tests.test_torch_job import ENGINE_OPTS, _outputs

VOCAB = [b"the", b"volcano", b"Volcano", b"volcxno", b"hello", b"hallooo",
         b"ab", b"zz", b"q", b"lava", b"flow", b"x", b"caf\xc3\xa9", b"\xff",
         b"needle", b"(the) the"]


def _blob(rng, n_lines: int, eol=b"\n", trailing=True) -> bytes:
    lines = [b" ".join(VOCAB[j] for j in rng.integers(0, len(VOCAB),
                                                      rng.integers(0, 7)))
             for _ in range(n_lines)]
    return eol.join(lines) + (eol if trailing and lines else b"")


@pytest.fixture(scope="module")
def small_files(tmp_path_factory):
    """36 small files in three directories: empty ones, CRLF, files with
    no final newline, blank lines, one of a lone newline."""
    rng = np.random.default_rng(14)
    root = tmp_path_factory.mktemp("batch")
    files = []
    for i in range(36):
        if i % 11 == 4:
            data = b""
        elif i == 7:
            data = b"\n"
        else:
            data = _blob(rng, int(rng.integers(1, 60)),
                         eol=b"\r\n" if i % 5 == 2 else b"\n",
                         trailing=i % 3 != 1)
        d = root / f"d{i % 3}"
        d.mkdir(exist_ok=True)
        p = d / f"f{i:02d}.txt"
        p.write_bytes(data)
        files.append(str(p))
    return files


@pytest.fixture(autouse=True)
def _fresh_caches():
    yield
    layout.corpus_cache_clear()
    engine_mod.model_cache_clear()


# ------------------------------------------------------------ the planner
@pytest.mark.parametrize("batch_bytes,small_bytes", [
    (0, None), (1, None), (700, None), (5000, None), (32 << 20, None),
    (32 << 20, 300), (1500, 800),
], ids=["off", "1B", "700B", "5000B", "32MiB", "32MiB-small300",
        "1500B-small800"])
def test_plan_map_splits_equals_reference(small_files, batch_bytes,
                                          small_bytes):
    files = small_files + [small_files[0] + ".missing", small_files[5]]
    got = plan_map_splits(files, batch_bytes, small_bytes)
    assert got == ref_plan(files, batch_bytes, small_bytes)
    if batch_bytes >= 5000 and small_bytes is None:
        assert any(isinstance(s, list) for s in got)
        assert [f for s in got for f in (s if isinstance(s, list) else [s])
                ] == files  # every file once, in order


def test_plan_map_splits_reads_the_env_bound(small_files, monkeypatch):
    monkeypatch.setenv("DGREP_DEVICE_MIN_BYTES", "200")
    assert plan_map_splits(small_files, 1 << 20) == ref_plan(small_files,
                                                             1 << 20)
    monkeypatch.setenv("DGREP_DEVICE_MIN_BYTES", "junk")  # falls back
    assert plan_map_splits(small_files, 1 << 20) == ref_plan(small_files,
                                                             1 << 20)


def test_env_knobs_parse_as_the_reference(monkeypatch):
    for raw in (None, "0", "4096", "-5", "junk"):
        for name in ("DGREP_DEVICE_MIN_BYTES", "DGREP_BATCH_BYTES",
                     "DGREP_CORPUS_BYTES"):
            if raw is None:
                monkeypatch.delenv(name, raising=False)
            else:
                monkeypatch.setenv(name, raw)
        assert layout.env_device_min_bytes() == ref_layout.env_device_min_bytes()
        assert layout.env_batch_bytes() == ref_layout.env_batch_bytes()
        assert layout.env_corpus_bytes() == ref_layout.env_corpus_bytes()
        assert (JobConfig(batch_bytes=1000).effective_batch_bytes()
                == RefJobConfig(batch_bytes=1000).effective_batch_bytes())


# --------------------------------------------------------- packer, demux
def test_packer_and_demux_equal_reference(small_files):
    rng = np.random.default_rng(3)
    blobs = [Path(f).read_bytes() for f in small_files]
    for cap in (1, 300, 2000, 1 << 20):
        mine, theirs = layout.BatchPacker(cap), ref_layout.BatchPacker(cap)
        got, want = [], []
        for i, b in enumerate(blobs):
            assert layout.packed_size(b) == ref_layout.packed_size(b)
            assert mine.fits(b) == theirs.fits(b)
            if not mine.fits(b):
                got.append(mine.pack())
                want.append(theirs.pack())
            mine.add(i, b)
            theirs.add(i, b)
        got.append(mine.pack())
        want.append(theirs.pack())
        assert mine.pack() is None and theirs.pack() is None
        for g, w in zip(got, want):
            assert g.data == w.data and g.names == w.names
            assert np.array_equal(g.byte_starts, w.byte_starts)
            assert np.array_equal(g.line_starts, w.line_starts)
            n_lines = int(g.line_starts[-1])
            lines = np.unique(rng.integers(1, n_lines + 2, size=n_lines))
            for a, b in zip(g.demux(lines), w.demux(lines)):
                assert np.array_equal(a, b)
            slim = g.without_blobs()
            assert slim.blobs is None
            assert slim.member_blobs() == g.blobs == w.blobs


# ---------------------------------------------------------- scan_batch
FAMILIES = [
    ("shift_and", {"pattern": "volcano"}),
    ("-i", {"pattern": "VOLCANO", "ignore_case": True}),
    ("fdr set", {"patterns": ["hello", "lava flow", "needle", "caf\xe9"]}),
    ("pairset", {"patterns": ["ab", "zz", "q"]}),
    ("nfa", {"pattern": "h[ae]llo+ (the|ab)"}),
    ("^ anchor", {"pattern": "^(the|ab) "}),
    ("$ anchor", {"pattern": "(flow|x)$"}),
    ("approx 1", {"pattern": "volcano", "max_errors": 1}),
    ("approx 2 -i", {"pattern": "VOLCANO", "max_errors": 2,
                     "ignore_case": True}),
    ("native ^$", {"pattern": "^$"}),
    ("re backref", {"pattern": r"(the) \1"}),
    ("all lines", {"pattern": "x*"}),
]


@pytest.mark.parametrize("batch_bytes", [300, 2500, 1 << 20],
                         ids=["300B", "2500B", "1MiB"])
@pytest.mark.parametrize("label,opts", FAMILIES, ids=[f[0] for f in FAMILIES])
def test_scan_batch_per_file_equals_reference(small_files, label, opts,
                                              batch_bytes):
    """Windows that split mid-list, each packed buffer cut into 4 KB
    segments of 64 lanes, so stripe and segment edges fall inside and
    between members."""
    items = [(Path(f).name, f) for f in small_files]
    port = GrepEngine(device="cpu", batch_bytes=batch_bytes, **opts,
                      **ENGINE_OPTS)
    ref = RefEngine(backend="cpu", batch_bytes=batch_bytes, **opts)
    emitted = []
    got = port.scan_batch(items, emit=lambda n, d, r: emitted.append((n, d)))
    pst = dict(port.stats)
    want = ref.scan_batch(items)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, g), (_n, w), path in zip(got, want, small_files):
        assert g.matched_lines.dtype == np.int64
        assert g.matched_lines.tolist() == w.matched_lines.tolist(), name
        assert (g.n_matches, g.bytes_scanned) == (w.n_matches,
                                                  w.bytes_scanned)
        solo = port.scan(Path(path).read_bytes())
        assert g.matched_lines.tolist() == solo.matched_lines.tolist()
    assert emitted == [(Path(f).name, Path(f).read_bytes())
                       for f in small_files]
    for k in ("batched_files", "batch_dispatches", "solo_dispatches",
              "dispatches_saved", "batch_fill_ratio"):
        assert pst[k] == ref.stats[k], k
    assert pst["file_reads"] == len(small_files)
    assert pst["batch_dispatches"] >= 1
    assert sum(r.n_matches for _, r in got) > 0


def test_scan_batch_bytes_large_inputs_solo_and_disabled(small_files):
    """A large input flushes the pending window and scans alone, in
    order; batch_bytes 0 scans every input alone."""
    big = b"volcano\n" * 200
    items = [("a", Path(small_files[0]).read_bytes()), ("big", big),
             ("b", Path(small_files[1]).read_bytes())]
    for eng_kw in ({"device_min_bytes": 1000}, {"batch_bytes": 0}):
        port = GrepEngine("volcano", device="cpu", **eng_kw, **ENGINE_OPTS)
        ref = RefEngine("volcano", backend="cpu", **eng_kw)
        got, want = port.scan_batch(items), ref.scan_batch(items)
        assert [(n, r.matched_lines.tolist()) for n, r in got] == [
            (n, r.matched_lines.tolist()) for n, r in want]
        assert port.stats["solo_dispatches"] == ref.stats["solo_dispatches"]
        assert port.stats["batch_dispatches"] == ref.stats["batch_dispatches"]


# ----------------------------------------------------- small-input route
@pytest.mark.parametrize("label,opts", FAMILIES[:7],
                         ids=[f[0] for f in FAMILIES[:7]])
def test_small_host_scan_equals_the_kernels(small_files, label, opts,
                                            monkeypatch):
    """The card's small-input route, driven on the CPU: every line through
    host_line_matcher gives the kernels' lines, and the scan is stamped."""
    eng = GrepEngine(device="cpu", **opts, **ENGINE_OPTS)
    assert not eng._small_for_device(1)  # never on the CPU
    data = b"".join(Path(f).read_bytes() + b"\n" for f in small_files)
    want = eng.scan(data)
    assert "small_host_scan" not in eng.stats
    monkeypatch.setattr(GrepEngine, "_small_for_device", lambda self, n: True)
    got = eng.scan(data)
    assert eng.stats["small_host_scan"] is True
    assert "segments" not in eng.stats  # no device pipeline ran
    assert got.matched_lines.tolist() == want.matched_lines.tolist()


def test_small_route_rule(monkeypatch):
    """On the card: below device_min_bytes, backend "device", never approx
    (its host recurrence is slow at any size)."""
    import torch

    eng = GrepEngine("volcano", device="cpu", device_min_bytes=100)
    monkeypatch.setattr(eng, "device", torch.device("cuda"))
    assert eng._small_for_device(99) and not eng._small_for_device(100)
    eng.device_min_bytes = 0
    assert not eng._small_for_device(0)
    ax = GrepEngine("volcano", max_errors=1, device="cpu",
                    device_min_bytes=100)
    monkeypatch.setattr(ax, "device", torch.device("cuda"))
    assert not ax._small_for_device(1)
    monkeypatch.setenv("DGREP_DEVICE_MIN_BYTES", "7")
    assert GrepEngine("volcano", device="cpu").device_min_bytes == 7


# ---------------------------------------------------------------- jobs
def _ref_job(tmp_path, files, opts, n_reduce, batch_bytes):
    return ref_run_job(RefJobConfig(
        input_files=files, application="distributed_grep_tpu.apps.grep_tpu",
        app_options={**opts, "backend": "cpu"}, n_reduce=n_reduce,
        work_dir=str(tmp_path / "ref"), batch_bytes=batch_bytes),
        n_workers=2)


def _port_job(tmp_path, files, opts, n_reduce, batch_bytes, name="port",
              app=None):
    return run_job(JobConfig(
        input_files=files, app_options={**opts, **ENGINE_OPTS},
        n_reduce=n_reduce, work_dir=str(tmp_path / name),
        batch_bytes=batch_bytes), n_workers=2, device="cpu", app=app)


JOB_OPTIONS = [
    ("print", {}), ("invert", {"invert": True}),
    ("count", {"count_only": True}),
    ("presence", {"count_only": True, "presence_only": True}),
]


@pytest.mark.parametrize("n_reduce", [1, 3])
@pytest.mark.parametrize("label,option", JOB_OPTIONS,
                         ids=[o[0] for o in JOB_OPTIONS])
def test_batched_job_byte_identical(tmp_path, small_files, label, option,
                                    n_reduce):
    opts = {"pattern": "h[ae]llo", **option}
    files = small_files[:20]
    port = _port_job(tmp_path, files, opts, n_reduce, 700)
    ref = _ref_job(tmp_path, files, opts, n_reduce, 700)
    unbatched = _port_job(tmp_path, files, opts, n_reduce, 0, "solo")
    assert port.metrics["counters"]["map_completed"] < len(files)
    assert unbatched.metrics["counters"]["map_completed"] == len(files)
    got = _outputs(port.output_files)
    if label == "presence":  # only each file's truthiness is meaningful
        def truth(outs):
            return sorted((ln.split(b"\t")[0], ln.split(b"\t")[1] != b"0")
                          for v in outs.values() for ln in v.splitlines())
        assert truth(got) == truth(_outputs(ref.output_files))
        assert truth(got) == truth(_outputs(unbatched.output_files))
    else:
        assert got == _outputs(ref.output_files)
        assert got == _outputs(unbatched.output_files)
    assert sum(len(v) for v in got.values()) > 0
    c = port.metrics["counters"]
    if label in ("print", "invert"):  # the columnar counters of the splits
        assert c["map_records"] == sum(v.count(b"\n") for v in got.values())
        assert c["map_batches"] >= 1


def test_map_batch_fn_records_equal_map_fn(small_files):
    grep_cuda.configure(pattern="volcano", device="cpu", **ENGINE_OPTS)
    items = [(f, f) for f in small_files]
    got = grep_cuda.map_batch_fn(items)
    want = [r for f in small_files
            for r in grep_cuda.map_fn(f, Path(f).read_bytes())]

    def rows(records):
        return [(b.filename, b.linenos.tolist(), bytes(b.slab))
                for b in records]

    assert rows(got) == rows(want) and got


def test_job_without_map_batch_fn_maps_each_member(tmp_path, small_files,
                                                   monkeypatch):
    opts = {"pattern": "volcano"}
    want = _outputs(_port_job(tmp_path, small_files, opts, 3, 0,
                              "solo").output_files)
    monkeypatch.delattr(grep_cuda, "map_batch_fn")
    # the module as patched (run_job would load a fresh instance)
    res = _port_job(tmp_path, small_files, opts, 3, 1 << 20,
                    app=from_module(grep_cuda))
    assert res.metrics["counters"]["map_batches"] > 0
    assert res.metrics["counters"]["map_completed"] < len(small_files)
    assert _outputs(res.output_files) == want


# ----------------------------------------------------------------- CLI
CLI_FLAGS = [
    ["volcano"], ["-c", "volcano"], ["-l", "hello"], ["-L", "hello"],
    ["-v", "the"], ["-w", "ab"], ["-F", "-e", "ab", "-e", "zz"],
    ["-i", "-o", "VOLCANO"], ["-C", "1", "lava"], ["-b", "-m", "2", "the"],
    ["^$"], ["--max-errors", "1", "volcano"], ["-q", "needle"],
]


@pytest.mark.parametrize("flags", CLI_FLAGS, ids=" ".join)
def test_cli_several_files_identical_to_reference(small_files, capsysbinary,
                                                  monkeypatch, flags):
    assert_same(capsysbinary, monkeypatch, [*flags, *small_files[:14]])


@pytest.mark.parametrize("flags", [["-r"], ["-r", "-c"], ["-r", "-l"],
                                   ["-R", "--include", "*.txt", "-h"]],
                         ids=" ".join)
def test_cli_recursive_batched_identical_to_reference(
        small_files, capsysbinary, monkeypatch, flags):
    root = str(Path(small_files[0]).parent.parent)
    out = assert_same(capsysbinary, monkeypatch, [*flags, "volcano", root])
    monkeypatch.setenv("DGREP_BATCH_BYTES", "0")  # the same bytes unbatched
    assert assert_same(capsysbinary, monkeypatch,
                       [*flags, "volcano", root]) == out


def test_cli_batches_with_metrics(small_files, capsysbinary):
    import json

    from distributed_grep_tpu_torch.__main__ import main

    root = str(Path(small_files[0]).parent.parent)
    assert main(["grep", "-r", "volcano", root, "--device", "cpu",
                 "--metrics"]) == 0
    m = json.loads(capsysbinary.readouterr().err)
    assert m["counters"]["map_completed"] == 1  # one split of 36 files
    assert m["engine"]["batch_dispatches"] >= 1
    assert m["engine"]["batched_files"] == len(small_files)
    assert 0 < m["engine"]["batch_fill_ratio"] <= 1
