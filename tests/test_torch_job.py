"""Port MapReduce job and CLI vs the reference package: byte-identical
mr-out files and stdout, fault tolerance, and the port's import guard."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from distributed_grep_tpu.runtime.job import run_job as ref_run_job
from distributed_grep_tpu.utils.config import JobConfig as RefJobConfig
from distributed_grep_tpu.utils.native import partition as ref_partition
from distributed_grep_tpu_torch.apps import grep_cuda
from distributed_grep_tpu_torch.runtime import shuffle
from distributed_grep_tpu_torch.runtime.job import run_job
from distributed_grep_tpu_torch.runtime.worker import WorkerKilled
from distributed_grep_tpu_torch.utils.config import JobConfig

REPO = Path(__file__).resolve().parents[1]
ENGINE_OPTS = {"target_lanes": 64, "min_chunk": 32, "segment_bytes": 4096}


@pytest.fixture
def corpus(tmp_path):
    rng = np.random.default_rng(42)
    vocab = [b"the", b"volcano", b"Volcano", b"hello", b"hallo", b"x",
             b"caf\xc3\xa9", b"\xff\xfe", b"\x00", b"a\tb", b"(line number #7)"]
    files = []
    for i, (eol, trailing) in enumerate([(b"\n", True), (b"\r\n", True),
                                         (b"\n", False), (b"\n", True)]):
        lines = [b" ".join(vocab[j] for j in rng.integers(0, len(vocab),
                                                          rng.integers(0, 9)))
                 for _ in range(700 + 300 * i)]
        d = tmp_path / ("in" if i % 2 else "in-b")
        d.mkdir(exist_ok=True)
        p = d / f"f{i}.txt"
        p.write_bytes(eol.join(lines) + (eol if trailing else b""))
        files.append(str(p))
    empty = tmp_path / "empty.txt"
    empty.write_bytes(b"")
    files.append(str(empty))
    return files


def _outputs(paths) -> dict[str, bytes]:
    return {Path(p).name: Path(p).read_bytes() for p in paths}


def _port_job(tmp_path, files, pattern, ic, **kw):
    cfg = JobConfig(
        input_files=files,
        app_options={"pattern": pattern, "ignore_case": ic, **ENGINE_OPTS},
        work_dir=str(tmp_path / "port"), **kw.pop("cfg", {}),
    )
    return run_job(cfg, n_workers=2, device="cpu", **kw)


@pytest.mark.parametrize("pattern,ic", [
    ("volcano", False), ("Volcano", True), ("h[ae]llo", False),
])
def test_mr_out_files_byte_identical_to_reference(tmp_path, corpus, pattern, ic):
    ref = ref_run_job(RefJobConfig(
        input_files=corpus,
        application="distributed_grep_tpu.apps.grep_tpu",
        app_options={"pattern": pattern, "ignore_case": ic, "backend": "cpu"},
        work_dir=str(tmp_path / "ref"),
    ), n_workers=2)
    port = _port_job(tmp_path, corpus, pattern, ic)
    ref_out, port_out = _outputs(ref.output_files), _outputs(port.output_files)
    assert sorted(port_out) == [f"mr-out-{r}" for r in range(10)]
    assert port_out == ref_out
    assert sum(len(v) for v in port_out.values()) > 0
    assert port.fileline_sorted


def test_worker_killed_mid_map_still_identical(tmp_path, corpus):
    clean = _outputs(_port_job(tmp_path / "a", corpus, "volcano",
                               False).output_files)
    killed = {"n": 0}

    def die_once():
        if killed["n"] == 0:
            killed["n"] += 1
            raise WorkerKilled()

    res = _port_job(tmp_path / "b", corpus, "volcano", False,
                    cfg={"task_timeout_s": 1.0},
                    fault_hooks_per_worker=[{"before_map_commit": die_once},
                                            {}])
    assert killed["n"] == 1
    assert res.metrics["counters"].get("map_retries", 0) >= 1
    assert res.metrics["counters"]["map_completed"] == len(corpus)
    assert _outputs(res.output_files) == clean


def test_stalled_attempt_is_reissued_and_first_commit_wins(tmp_path, corpus):
    import time

    clean = _outputs(_port_job(tmp_path / "a", corpus, "hello",
                               False).output_files)
    stalled = {"done": False}

    def stall():
        if not stalled["done"]:
            stalled["done"] = True
            time.sleep(2.0)  # > task_timeout_s: the task is re-issued

    res = _port_job(tmp_path / "b", corpus, "hello", False,
                    cfg={"task_timeout_s": 0.5},
                    fault_hooks_per_worker=[{"before_map_commit": stall}, {}])
    assert res.metrics["counters"].get("map_retries", 0) >= 1
    assert _outputs(res.output_files) == clean


def test_kernel_failure_fails_the_job(tmp_path, corpus, monkeypatch):
    from distributed_grep_tpu_torch.ops import cuda_scan

    def broken(*a, **k):
        raise RuntimeError("simulated kernel launch failure")

    monkeypatch.setattr(cuda_scan, "shift_and_scan_words", broken)
    with pytest.raises(RuntimeError, match="simulated kernel launch failure"):
        _port_job(tmp_path, corpus, "volcano", False)


def _cli(module, args, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", DGREP_LOG="WARNING",
               PYTHONPATH=str(REPO))
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-m", module, *args],
                          capture_output=True, env=env, cwd=REPO, timeout=300)


@pytest.mark.parametrize("flags", [["volcano"], ["-i", "h[ae]LLO"]])
def test_cli_stdout_identical_to_reference_cli(corpus, flags):
    ref = _cli("distributed_grep_tpu", ["grep", *flags, *corpus,
                                        "--backend", "cpu"])
    port = _cli("distributed_grep_tpu_torch", ["grep", *flags, *corpus,
                                               "--device", "cpu"])
    assert ref.returncode == 0, ref.stderr
    assert port.returncode == 0, port.stderr
    assert port.stdout == ref.stdout and port.stdout


def test_cli_exit_codes(corpus, capsys):
    import torch

    from distributed_grep_tpu_torch.__main__ import main

    assert main(["grep", "zzzq", corpus[0], "--device", "cpu"]) == 1
    assert main(["grep", "h[", corpus[0], "--device", "cpu"]) == 2
    assert "invalid pattern" in capsys.readouterr().err
    # 'x?$' once exited 2 naming ROADMAP item 11; it now runs on the host
    # DFA scanner and selects every line; --follow runs too (item 5), and
    # exits 2 only on the modes it cannot stream
    assert main(["grep", "-q", "x?$", corpus[0], "--device", "cpu"]) == 0
    assert main(["grep", "--follow", "-o", "x", corpus[0],
                 "--device", "cpu"]) == 2
    assert "--follow does not support -o" in capsys.readouterr().err
    assert main(["grep", "x", corpus[0] + ".missing", "--device", "cpu"]) == 2
    if not torch.cuda.is_available():
        assert main(["grep", "x", corpus[0]]) == 2
        assert "--device cpu" in capsys.readouterr().err


def test_entry_points_raise_without_cuda(tmp_path, corpus, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        grep_cuda.configure(pattern="volcano")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_job(JobConfig(input_files=corpus,
                          app_options={"pattern": "volcano"},
                          work_dir=str(tmp_path / "w")))
    grep_cuda.configure(pattern="volcano", device="cpu")


@pytest.mark.parametrize("opt,item", [
    ({"devices": [0]}, "item 9"), ({"devices": "all"}, "item 9"),
    ({"mesh_shape": [2]}, "item 9"), ({"mesh_axes": ("data",)}, "item 9"),
    ({"pattern_axis": "model"}, "item 9"),
])
def test_mesh_options_raise_naming_their_item(tmp_path, corpus, opt, item):
    """The card options of ROADMAP item 9's first half run: a job on
    device "cpu" with ``devices``, ``mesh_shape`` (a mesh of two host
    entries) or ``mesh_axes`` gives mr-out files byte-identical to the
    single-device job's.  ``pattern_axis``, the item's second half, still
    raises naming it (the port used to pass such options on to GrepEngine,
    which raised TypeError); a falsy value is accepted and not passed
    on."""
    name = next(iter(opt))
    if name == "pattern_axis":
        with pytest.raises(NotImplementedError,
                           match=f"ROADMAP.md.*{item}.*second half"):
            grep_cuda.configure("volcano", device="cpu", **opt)
        grep_cuda.configure("volcano", device="cpu", **{name: None})
        assert grep_cuda._engine is not None
        return
    single = _port_job(tmp_path / "one", corpus, "volcano", False)
    cfg = JobConfig(
        input_files=corpus,
        app_options={"pattern": "volcano", "device": "cpu", **ENGINE_OPTS,
                     **opt},
        work_dir=str(tmp_path / "opt"))
    res = run_job(cfg, n_workers=2, device="cpu",
                  app=grep_cuda_module())
    got = _outputs(res.output_files)
    assert got == _outputs(single.output_files)
    assert sum(len(v) for v in got.values()) > 0
    eng = grep_cuda._engine
    if name == "mesh_shape":
        assert eng.mesh is not None and eng.mesh.size == 2
        assert eng.totals.get("psum_candidates", 0) > 0
    else:
        assert eng.mesh is None and [d.type for d in eng.devices] == ["cpu"]


def grep_cuda_module():
    from distributed_grep_tpu_torch.apps.loader import from_module

    return from_module(grep_cuda)


def test_partition_bit_compatible_with_reference():
    rng = np.random.default_rng(0)
    keys = [f"/d/f{rng.integers(0, 9)}.txt (line number #{rng.integers(1, 10**7)})"
            for _ in range(500)]
    keys += ["", "x", "café (line number #1)", "bad\udcff name",
             "  (line number #12)"]
    for n_reduce in (1, 7, 10):
        want = [ref_partition(k, n_reduce) for k in keys]
        assert shuffle.partition_many(keys, n_reduce).tolist() == want


def test_shuffle_wire_round_trip():
    from distributed_grep_tpu_torch.apps.base import KeyValue

    recs = [KeyValue("a (line number #1)", "x\ty\r z"),
            KeyValue("bad\udcff (line number #2)", "�"), KeyValue("k", "")]
    assert shuffle.decode_records(shuffle.encode_records(recs)) == recs


def test_port_imports_no_jax_and_nothing_of_the_reference(tmp_path):
    """Every port module (the bench and benchmarks/ included, the service
    daemon's among them), plus tiny exact, approx and SWAR scans, a
    daemon serving two tenants, and a tiny run of each probe kernel, in a
    fresh interpreter."""
    src = tmp_path / "in.txt"
    src.write_bytes(b"a volcano\nnothing\n")
    code = f"""
import importlib, pkgutil, sys
import distributed_grep_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from distributed_grep_tpu_torch.runtime.job import run_job
from distributed_grep_tpu_torch.utils.config import JobConfig
res = run_job(JobConfig(input_files=[{str(src)!r}],
                        app_options={{"pattern": "volcano"}},
                        work_dir={str(tmp_path / "w")!r}),
              n_workers=1, device="cpu")
assert sum(1 for _ in res.iter_results()) == 1
# the shard index and scan fusion: a job that publishes a summary, and a
# fused scan of two queries
import pathlib
res = run_job(JobConfig(input_files=[{str(src)!r}],
                        app_options={{"pattern": "volcano",
                                      "index_dir": {str(tmp_path / "idx")!r}}},
                        work_dir={str(tmp_path / "wi")!r}),
              n_workers=1, device="cpu")
assert sum(1 for _ in res.iter_results()) == 1
assert len(list(pathlib.Path({str(tmp_path / "idx")!r}).glob("*.tgs"))) == 1
from distributed_grep_tpu_torch.ops.fuse import FusedScanner
fused = FusedScanner([("volcano", None, False), ("noth", None, True)],
                     device="cpu").scan(b"a volcano\\nnothing\\n")
assert [r.matched_lines.tolist() for r in fused] == [[1], [2]]
# the control plane: a coordinator and a worker loop over HTTP, and the
# host apps through the loader
from distributed_grep_tpu_torch.apps.loader import load_application
from distributed_grep_tpu_torch.runtime.http_coordinator import CoordinatorServer
from distributed_grep_tpu_torch.runtime.http_transport import run_http_worker
srv = CoordinatorServer(JobConfig(input_files=[{str(src)!r}],
                                  app_options={{"pattern": "volcano", "device": "cpu"}},
                                  work_dir={str(tmp_path / "h")!r},
                                  coordinator_port=0, n_reduce=2))
srv.start()
run_http_worker(f"127.0.0.1:{{srv.port}}")
assert srv.wait_done(5.0)
srv.shutdown(linger_s=0.0)
for name in ("grep", "wordcount", "inverted_index"):
    load_application("distributed_grep_tpu_torch.apps." + name)
# the service daemon: two tenants through one in-process worker (fused),
# its registry and lifecycle log
from distributed_grep_tpu_torch.runtime.daemon_log import DaemonLog
from distributed_grep_tpu_torch.runtime.service import GrepService, ServiceServer
svc = GrepService(work_root={str(tmp_path / "svc")!r},
                  daemon_log=DaemonLog({str(tmp_path / "svc")!r}))
server = ServiceServer(svc)
server.start()
jids = [svc.submit(JobConfig(input_files=[{str(src)!r}],
                             app_options={{"pattern": q, "device": "cpu"}}))
        for q in ("volcano", "noth")]
svc.start_local_workers(1)
assert all(svc.wait_job(j, timeout=60) for j in jids)
assert [svc.job_status(j)["state"] for j in jids] == ["done", "done"]
server.shutdown()
svc.stop()
import os
os.environ["DGREP_SWAR"] = "1"
res = run_job(JobConfig(input_files=[{str(src)!r}],
                        app_options={{"pattern": "volcxno", "max_errors": 1}},
                        work_dir={str(tmp_path / "w2")!r}),
              n_workers=1, device="cpu")
assert sum(1 for _ in res.iter_results()) == 1
from distributed_grep_tpu_torch.ops.engine import GrepEngine
eng = GrepEngine("volcano", device="cpu")
assert eng.scan(b"a volcano").matched_lines.tolist() == [1]
assert eng.stats["swar"] is True
import torch
from distributed_grep_tpu_torch.ops import mxu_probe, narrow_probe
x = torch.zeros((512, 4096), dtype=torch.uint8)
x[0:7, 3] = torch.tensor(list(b"volcano"), dtype=torch.uint8)
assert int(narrow_probe.narrow_probe_words(x, "i16")[0, 3]) == 64
m = torch.from_numpy(mxu_probe.probe_member())
assert int(mxu_probe.mxu_dot(x, m).sum()) == int(m.sum(1).to(torch.int64)[x.long().flatten()].sum())
bad = [m for m in sys.modules
       if m == "jax" or m.startswith("jax.") or m == "distributed_grep_tpu"
       or m.startswith("distributed_grep_tpu.")]
assert not bad, bad
# the host library is the port's own build, nothing under the repo's native/
maps = open("/proc/self/maps").read()
assert "/_build/libdgrep-" in maps
assert {str(REPO / "native")!r} + "/" not in maps
print("clean", len([m for m in sys.modules if m.startswith(pkg.__name__)]))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         cwd=REPO, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert out.returncode == 0, out.stderr.decode()
    assert out.stdout.startswith(b"clean")
