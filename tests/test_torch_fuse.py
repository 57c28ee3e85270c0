"""The port's scan fusion (ops/fuse.py, runtime/fusion.py, the grep app's
``map_fused_fn``, the scheduler's ``claim_map_task``, the RPC's
``fused``) held to the reference's (distributed_grep_tpu/ops/fuse.py,
runtime/fusion.py, apps/grep_tpu.map_fused_fn): each query's fused lines
equal its solo scan's and the reference's fused result across the
literal, set, regex and -i-mix families; the union's arguments and the
fusion keys equal the reference's (but for the application's name, C1);
the fused records equal each participant's solo records and the
reference's; a retried task never joins a fusion; and (ROADMAP.md D7)
only FuseError sends a query solo, while an error in the union's scan
fails it.  Through the service daemon (runtime/service.py: its planner,
the worker's fused attempt): K = 4 co-running jobs take one scan a split,
the fused outputs equal the solo jobs' and the reference daemon's, with
the fuse:plan and fuse:split instants in each participant's log;
DGREP_SERVICE_FUSE=0 fuses nothing; ``submit``'s sets equal the local
jobs'; a FuseError runs the participants solo and a scan error fails
their attempt, never retried solo.

The ``cuda`` test at the end needs the card and skips without one; the
reference is imported inside the tests that run it (it imports jax):

    python -m pytest tests/test_torch_fuse.py -m cuda -q --noconftest
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from distributed_grep_tpu_torch.apps.loader import load_application
from distributed_grep_tpu_torch.ops import device_scan
from distributed_grep_tpu_torch.ops import engine as engine_mod
from distributed_grep_tpu_torch.ops import fuse as fuse_mod
from distributed_grep_tpu_torch.ops import layout
from distributed_grep_tpu_torch.ops.engine import GrepEngine
from distributed_grep_tpu_torch.runtime import fusion as fusion_mod
from distributed_grep_tpu_torch.runtime import rpc
from distributed_grep_tpu_torch.runtime.scheduler import Scheduler
from distributed_grep_tpu_torch.runtime.types import TaskState
from distributed_grep_tpu_torch.utils.config import JobConfig

ENGINE_OPTS = {"target_lanes": 64, "min_chunk": 32, "segment_bytes": 4096}
GREP_CUDA = "distributed_grep_tpu_torch.apps.grep_cuda"


@pytest.fixture(autouse=True)
def _fresh_tiers():
    for clear in (fuse_mod.fusion_counters_clear, layout.corpus_cache_clear,
                  engine_mod.model_cache_clear):
        clear()
    yield
    for clear in (fuse_mod.fusion_counters_clear, layout.corpus_cache_clear,
                  engine_mod.model_cache_clear):
        clear()


def _doc() -> bytes:
    """The reference test's document (tests/test_fuse.py _doc), with CR,
    NUL and 0xFF lines beside it."""
    lines = []
    for j in range(120):
        lines.append(f"line {j} " + ("hello " if j % 3 == 0 else "")
                     + ("NEEDLE " if j % 7 == 0 else "")
                     + ("error" if j % 5 == 0 else "tail"))
    lines.append("")
    lines.append("last line without newline")
    return ("\n".join(lines[:60]) + "\nHELLO\r\nx\x00hello\xff\n"
            + "\n".join(lines[60:])).encode("latin-1")


# the reference test's specs, a family each (tests/test_fuse.py _SPECS)
SPECS = [
    ("hello", None, False),                              # shift_and
    ("(needle|err+or)", None, True),                     # nfa, -i
    (None, ("hello", "needle", "line 11", "tail"), False),  # fdr set
    (None, ("he", "ta", "x"), False),                    # pairset set
    ("error$", None, False),                             # '$' filter
    (r"\bhello\b", None, False),                         # re filter
    ("zz-never-there", None, False),                     # no candidate
]
MIXES = {
    "families": SPECS,
    "literals": [("hello", None, False), ("tail", None, False)],
    "sets": [(None, ("hello", "needle"), False),
             (None, ("tail", "line 7"), True)],
    "regexes": [("^line [0-9]+ hello", None, False), ("err(o)+r", None, False),
                ("N[A-Z]+LE", None, False)],
    "ignore_case_mix": [("hello", None, True), ("NEEDLE", None, False),
                        (None, ("TAIL",), True), ("Line 1[0-9]", None, False)],
}


def _solo(spec, **kw) -> GrepEngine:
    pat, pats, ic = spec
    return GrepEngine(pat, patterns=list(pats) if pats else None,
                      ignore_case=ic, **kw)


@pytest.mark.parametrize("mix", list(MIXES))
def test_fused_scan_equals_solo_and_the_reference(mix):
    from distributed_grep_tpu.ops import fuse as ref_fuse

    specs = MIXES[mix]
    data = _doc()
    fused = fuse_mod.FusedScanner(specs, device="cpu", **ENGINE_OPTS)
    got = fused.scan(data)
    want = ref_fuse.FusedScanner(specs, backend="cpu").scan(data)
    for spec, g, w in zip(specs, got, want):
        solo = _solo(spec, device="cpu", **ENGINE_OPTS).scan(data)
        assert g.matched_lines.tolist() == w.matched_lines.tolist() == \
            solo.matched_lines.tolist(), spec
        assert g.n_matches == g.matched_lines.size
        assert g.bytes_scanned == len(data)
    cc = fuse_mod.fusion_counters()
    assert cc["fused_queries"] == len(specs)
    assert cc["fused_dispatches"] == 1
    assert cc["fusion_bytes_saved"] == (len(specs) - 1) * len(data)


@pytest.mark.parametrize("mix", ["families", "ignore_case_mix"])
def test_fused_scan_batch_equals_solo_and_the_reference(mix, tmp_path):
    """Packed windows: small files, an empty one, one without a final
    newline; a file past the small bound scans alone."""
    from distributed_grep_tpu.ops import fuse as ref_fuse

    specs = MIXES[mix]
    blobs = {"a.txt": b"hello world\nno match here\nNEEDLE found\n",
             "b.txt": b"", "c.txt": b"error\nhello error", "d.txt": _doc(),
             "e.txt": _doc() * 30}
    items = []
    for name, b in blobs.items():
        (tmp_path / name).write_bytes(b)
        items.append((name, str(tmp_path / name)))
    fs = fuse_mod.FusedScanner(specs, device="cpu", batch_bytes=1 << 14,
                               device_min_bytes=1 << 12, **ENGINE_OPTS)
    emitted = []
    outs = fs.scan_batch(items, emit=lambda i, name, data, res, nl:
                         emitted.append((i, name, len(data))))
    assert emitted == [(i, n, len(blobs[n])) for i, n in enumerate(blobs)]
    assert fs.union.stats["batch_dispatches"] == 1
    assert fs.union.stats["solo_dispatches"] == 1
    ref = ref_fuse.FusedScanner(specs, backend="cpu",
                                batch_bytes=1 << 14).scan_batch(items)
    for spec, per_file, ref_file in zip(specs, outs, ref):
        solo = _solo(spec, backend="cpu")
        assert [n for n, _ in per_file] == list(blobs)
        for (name, fr), (_n, rr) in zip(per_file, ref_file):
            assert fr.matched_lines.tolist() == rr.matched_lines.tolist() == \
                solo.scan(blobs[name]).matched_lines.tolist(), (spec, name)
    assert fuse_mod.fusion_counters()["fused_dispatches"] == 2


@pytest.mark.parametrize("specs", [
    MIXES["sets"], MIXES["families"],
    [(None, ("a.b", "x|y", "(z)"), False), ("q+", None, True)],
    [(None, ("dup", "dup2"), False), (None, ("dup",), False)],
])
def test_union_engine_args_equal_the_reference(specs):
    from distributed_grep_tpu.ops import fuse as ref_fuse

    got = fuse_mod.union_engine_args(
        [fuse_mod.QuerySpec.normalize(s) for s in specs])
    want = ref_fuse.union_engine_args(
        [ref_fuse.QuerySpec.normalize(s) for s in specs])
    assert got == want


FUSION_OPTS = [
    {"pattern": "hello"}, {"pattern": "hello", "ignore_case": True},
    {"patterns": ["a", "bc"]}, {"pattern": "hello", "invert": True},
    {"pattern": "hello", "word_regexp": True},
    {"pattern": "hello", "count_only": True},
    {"pattern": "hello", "count_only": True, "presence_only": True},
    {"pattern": "hello", "max_errors": 1}, {"pattern": r"(a)\1"},
    {"pattern": ""}, {"patterns": ["a", ""]}, {"pattern": "h", "x": [1, 2]},
]


@pytest.mark.parametrize("opts", FUSION_OPTS)
def test_fusion_key_and_query_spec_equal_the_reference(opts):
    """C1: the port's key names grep_cuda where the reference's names
    grep_tpu; the rest of each key, and each query spec, are equal."""
    from distributed_grep_tpu.runtime import fusion as ref_fusion
    from distributed_grep_tpu.utils.config import JobConfig as RefJobConfig

    port = JobConfig(input_files=["x"], app_options=dict(opts))
    ref = RefJobConfig(input_files=["x"],
                       application=ref_fusion.FUSABLE_APPLICATION,
                       app_options=dict(opts))
    assert port.application == fusion_mod.FUSABLE_APPLICATION == GREP_CUDA
    got, want = fusion_mod.fusion_key(port), ref_fusion.fusion_key(ref)
    assert (got is None) == (want is None)
    if want is not None:
        assert got[0] == GREP_CUDA and got[1:] == want[1:]
    assert fusion_mod.query_spec(opts) == ref_fusion.query_spec(opts)
    for rx in ("a(b)c", r"(a)\1", r"(?P<x>a)(?P=x)", "(a)?(?(1)b|c)", "a["):
        assert fusion_mod.has_backref(rx) == ref_fusion.has_backref(rx)
    other = JobConfig(input_files=["x"], app_options=dict(opts),
                      application="distributed_grep_tpu_torch.apps.grep")
    assert fusion_mod.fusion_key(other) is None


def test_print_mode_grep_cuda_config_has_a_fusion_key():
    assert fusion_mod.fusion_key(JobConfig(
        input_files=["x"], app_options={"pattern": "volcano",
                                        "device": "cpu"})) is not None


def test_split_identity_and_plan_identities_equal_the_reference(tmp_path):
    from distributed_grep_tpu.runtime import fusion as ref_fusion

    files = []
    for i in range(3):
        (tmp_path / f"f{i}").write_bytes(b"x" * (10 + i))
        files.append(str(tmp_path / f"f{i}"))
    splits = [files[0], [files[1], files[2]], files[0],
              str(tmp_path / "missing")]
    assert fusion_mod.plan_identities(splits) == \
        ref_fusion.plan_identities(splits)
    idents, _ = fusion_mod.plan_identities(splits)
    assert [fusion_mod.split_n_bytes(x) for x in idents] == [10, 23, 10, 0]


# ------------------------------------------------------------ the app

PARTICIPANTS = [
    {"pattern": "hello", "word_regexp": True},
    {"pattern": "line 1[0-9] hello tail", "line_regexp": True},
    {"patterns": ["NEEDLE", "tail"]},
    {"pattern": "error", "invert": True},
    {"pattern": "Hello", "ignore_case": True, "count_only": True},
]


def _kvs(records) -> list:
    out = []
    for r in records:
        out.extend(r.to_keyvalues() if hasattr(r, "to_keyvalues") else [r])
    return [(kv.key, kv.value) for kv in out]


@pytest.mark.parametrize("k", [1, 3, 5])
def test_map_fused_fn_equals_solo_and_the_reference(k, tmp_path):
    from distributed_grep_tpu.apps import grep_tpu as ref_app
    from tests.conftest import expand_records

    items = []
    for i, blob in enumerate([_doc(), b"hello\nHELLO there\n", b"", _doc()]):
        (tmp_path / f"m{i}.txt").write_bytes(blob)
        items.append((f"m{i}.txt", str(tmp_path / f"m{i}.txt")))
    parts = [{"job_id": f"job-{j}",
              "app_options": {**PARTICIPANTS[j], "device": "cpu",
                              **ENGINE_OPTS},
              "filenames": [f"/j{j}/{n}" for n, _ in items]}
             for j in range(k)]
    app = load_application(GREP_CUDA)
    fused = app.map_fused_fn(list(items), parts)
    ref_parts = [{**p, "app_options": {**PARTICIPANTS[j], "backend": "cpu"}}
                 for j, p in enumerate(parts)]
    ref_fused = ref_app.map_fused_fn(list(items), ref_parts)
    assert len(fused) == k
    for j, p in enumerate(parts):
        solo_app = load_application(GREP_CUDA, **p["app_options"])
        named = [(nm, path) for nm, (_n, path) in zip(p["filenames"], items)]
        solo = _kvs(solo_app.map_batch_fn(named))
        assert _kvs(fused[j]) == solo, PARTICIPANTS[j]
        assert _kvs(expand_records(ref_fused[j])) == solo


def test_loader_exposes_map_fused_fn():
    assert load_application(GREP_CUDA).map_fused_fn is not None
    host = load_application("distributed_grep_tpu_torch.apps.grep")
    assert host.map_fused_fn is None


# ---------------------------------------------- D7: solo only on FuseError

@pytest.mark.parametrize("specs", [
    [("", None, False), ("hello", None, False)],
    [(None, ("ok", ""), False)],
    [(r"(a)b\1", None, False), ("hello", None, False)],
    [("h[", None, False), ("hello", None, False)],
])
def test_unfusable_specs_raise_fuse_error(specs):
    with pytest.raises(fuse_mod.FuseError):
        fuse_mod.FusedScanner(specs, device="cpu")


def test_a_union_no_kernel_hosts_raises_fuse_error_on_the_device():
    """'x?$' is nullable at '$': its union runs on the host scanner, so a
    device engine refuses to fuse it; the host backend fuses it."""
    specs = [("hello", None, False), ("x?$", None, False)]
    with pytest.raises(fuse_mod.FuseError, match="host"):
        fuse_mod.FusedScanner(specs, device="cpu")
    data = _doc()
    got = fuse_mod.FusedScanner(specs, backend="cpu").scan(data)
    for spec, g in zip(specs, got):
        assert g.matched_lines.tolist() == \
            _solo(spec, backend="cpu").scan(data).matched_lines.tolist()


def test_approx_and_mesh_engines_raise_fuse_error():
    for kw in ({"max_errors": 1}, {"mesh": object()}):
        with pytest.raises(fuse_mod.FuseError):
            fuse_mod.FusedScanner([("hello", None, False)], **kw)


def _run_fused_or_solo(items, parts) -> list:
    """A caller's rule (ROADMAP.md D7): FuseError runs each participant
    solo; any other error fails."""
    try:
        return [_kvs(r) for r in
                load_application(GREP_CUDA).map_fused_fn(items, parts)]
    except fuse_mod.FuseError:
        return [_kvs(load_application(GREP_CUDA, **p["app_options"])
                     .map_batch_fn([(nm, d) for nm, (_n, d)
                                    in zip(p["filenames"], items)]))
                for p in parts]


def test_fuse_error_runs_solo_and_a_scan_error_propagates(tmp_path,
                                                          monkeypatch):
    (tmp_path / "a.txt").write_bytes(_doc())
    items = [("a.txt", str(tmp_path / "a.txt"))]
    opts = [{"pattern": "(hel)lo \\1"}, {"pattern": "tail"}]
    parts = [{"app_options": {**o, "device": "cpu", **ENGINE_OPTS},
              "filenames": ["a.txt"]} for o in opts]
    solo = _run_fused_or_solo(items, parts)
    assert solo[1] and len(solo) == 2
    # a fusable pair: the union's scan runs, and its error propagates
    parts[0]["app_options"]["pattern"] = "hello"

    def broken(*a, **k):
        raise RuntimeError("injected: the union's kernel failed to launch")

    monkeypatch.setattr(device_scan, "scan_device", broken)
    with pytest.raises(RuntimeError, match="union's kernel"):
        _run_fused_or_solo(items, parts)
    with pytest.raises(RuntimeError, match="union's kernel"):
        fuse_mod.FusedScanner([("hello", None, False), ("tail", None, False)],
                              device="cpu").scan(_doc() * 1000)


SUFFIX_SPECS = [
    [("hello", None, False), ("h[ae]llo+$", None, False),
     ("^tail", None, False)],
    [(None, ("hello", "needle"), False), (None, ("ab", "zz"), True)],
    [("HELLO", None, True), ("volcano", None, False)],
]


def test_scan_suffix_names_its_item(tmp_path, monkeypatch):
    """FusedScanner.scan_suffix (the fused follow tier's scan of a grown
    file) gives each spec what its solo engine's scan_file_suffix gives
    over the same window: the same lines, the same cursor advance and
    bytes, at every append edge (a line cut mid-byte, an empty append,
    an unterminated tail taken by the final scan)."""
    monkeypatch.setenv("DGREP_DEVICE_MIN_BYTES", "0")
    for k, specs in enumerate(SUFFIX_SPECS):
        _check_scan_suffix(tmp_path / f"grow{k}.log", specs)


def _check_scan_suffix(path, specs) -> None:
    path.write_bytes(b"")
    fs = fuse_mod.FusedScanner(specs, device="cpu", **ENGINE_OPTS)
    solos = [GrepEngine(pat, patterns=list(pats) if pats else None,
                        ignore_case=ic, device="cpu", **ENGINE_OPTS)
             for pat, pats, ic in specs]
    offset = 0
    stages = [b"hello start\nab zz\nmiss\n", b"partial hel", b"",
              b"lo needle\nHELLO\ntail end hello\n", b"tail no newline"]
    for i, stage in enumerate(stages):
        with open(path, "ab") as f:
            f.write(stage)
        final = i == len(stages) - 1
        got, consumed, data = fs.scan_suffix(path, offset, final=final)
        for res, eng in zip(got, solos):
            want, w_consumed, w_data = eng.scan_file_suffix(path, offset,
                                                            final=final)
            assert (consumed, data) == (w_consumed, w_data)
            assert res.matched_lines.tolist() == \
                want.matched_lines.tolist()
        offset += consumed
    assert offset == path.stat().st_size
    # a window with no complete line consumes nothing
    with open(path, "ab") as f:
        f.write(b"\nhello no end")
    got, consumed, _data = fs.scan_suffix(path, offset + 1)
    assert consumed == 0 and all(r.matched_lines.size == 0 for r in got)


# -------------------------------------------------- scheduler and RPC

def test_claim_map_task_first_attempts_only():
    sched = Scheduler(files=["f1", ["f2", "f3"]], n_reduce=1,
                      task_timeout_s=30.0)
    try:
        info = sched.claim_map_task(1, worker_id=7)
        assert info == {"task_id": 1, "filename": sched.map_tasks[1].file,
                        "filenames": ["f2", "f3"], "n_reduce": 1,
                        "app_options": sched.app_options,
                        "task_timeout_s": 30.0, "epoch": sched.epoch}
        assert sched.claim_map_task(1, worker_id=8) is None  # not idle
        t = sched.map_tasks[1]
        t.state = TaskState.UNASSIGNED  # as a timeout leaves it
        assert t.attempts == 1
        assert sched.claim_map_task(1, worker_id=9) is None  # retried
        assert sched.claim_map_task(99, worker_id=9) is None
        assert sched.counters["fused_assigned"] == 1
        assert sched.counters["map_assigned"] == 1
    finally:
        sched.stop()
    assert sched.claim_map_task(0, worker_id=1) is None  # stopped


def test_claimed_task_timeout_requeues_solo():
    """A claimed attempt that times out is swept back into the queue and
    never claimed again; its timeout charges no worker (the reference's
    rule: the K schedulers of one fused attempt share the service's
    WorkerHealth, and the primary assignment's timeout is the one
    charge)."""
    sched = Scheduler(files=["f1", "f2"], n_reduce=1, task_timeout_s=0.01,
                      sweep_interval_s=3600)
    try:
        assert sched.claim_map_task(0, worker_id=5) is not None
        sched.map_tasks[0].stamped = True  # evidence the worker held it
        import time

        time.sleep(0.05)
        assert sched.sweep()
        assert sched.worker_health._fails.get(5) is None
        assert sched.map_tasks[0].state is TaskState.UNASSIGNED
        assert sched.claim_map_task(0, worker_id=6) is None
        reply = sched.assign_task(rpc.AssignTaskArgs(worker_id=6))
        assert (reply.assignment, reply.task_id) == ("map", 0)
        assert sched.map_tasks[0].attempts == 2
    finally:
        sched.stop()


def test_rpc_fused_field_elided_when_empty():
    from distributed_grep_tpu.runtime import rpc as ref_rpc

    fields = dict(assignment="map", filename="f", filenames=["a", "b"],
                  task_id=3, n_reduce=2, worker_id=1,
                  app_options={"pattern": "x"}, task_timeout_s=5.0,
                  epoch="e1")
    got = rpc.reply_to_dict(rpc.AssignTaskReply(**fields))
    assert "fused" not in got
    assert got == ref_rpc.reply_to_dict(ref_rpc.AssignTaskReply(**fields))
    entry = {"job_id": "j", "task_id": 4, "filename": "g", "filenames": [],
             "n_reduce": 2, "app_options": {}, "task_timeout_s": 5.0,
             "epoch": "e2"}
    with_fused = rpc.reply_to_dict(rpc.AssignTaskReply(**fields,
                                                       fused=[entry]))
    assert with_fused["fused"] == [entry]
    assert with_fused == ref_rpc.reply_to_dict(
        ref_rpc.AssignTaskReply(**fields, fused=[entry]))
    assert rpc.from_dict("AssignTaskReply", with_fused).fused == [entry]


def test_worker_ships_fusion_and_index_counters():
    from distributed_grep_tpu_torch.runtime import worker

    fuse_mod.FusedScanner([("a", None, False), ("b", None, False)],
                          backend="cpu").scan(b"a\nb\n")
    got = worker._engine_cache_counters()
    assert got["fused_queries"] == 2 and got["fused_dispatches"] == 1


# ------------------------------------------------------- the service

def _svc_corpus(tmp_path, n_files=2, n_lines=400) -> list[str]:
    """The reference test's corpus (tests/test_fuse.py _mk_corpus)."""
    files = []
    for i in range(n_files):
        p = tmp_path / f"in{i}.txt"
        p.write_text("".join(
            f"line {j} of {i} {'hello' if j % 3 == 0 else ''}"
            f"{' fox' if j % 5 == 0 else ''}\n" for j in range(n_lines)))
        files.append(str(p))
    return files


def _svc_cfg(files, pattern, **extra) -> JobConfig:
    return JobConfig(input_files=files, application=GREP_CUDA,
                     app_options={"pattern": pattern, "device": "cpu",
                                  **extra},
                     n_reduce=2, task_timeout_s=30.0, sweep_interval_s=0.2)


def _svc_run(tmp_path, files, pats, spans=False, **extra) -> tuple:
    """The jobs submitted before the one worker attaches (so their map
    tasks are idle together), run to the end: (job ids, /status, the
    service)."""
    from distributed_grep_tpu_torch.runtime.service import GrepService

    svc = GrepService(work_root=tmp_path / "svc", spans=spans)
    jids = [svc.submit(_svc_cfg(files, p, **extra)) for p in pats]
    deadline = time.monotonic() + 30
    while not all(svc.record(j).scheduler is not None for j in jids):
        assert time.monotonic() < deadline
        time.sleep(0.02)
    svc.start_local_workers(1)
    for j in jids:
        assert svc.wait_job(j, timeout=120), svc.job_status(j)
    return jids, svc.status(), svc


def _outs(paths) -> dict:
    return {Path(p).name: Path(p).read_bytes() for p in paths}


def _solo_job(tmp_path, files, pattern, sub, **extra) -> dict:
    from distributed_grep_tpu_torch.runtime.job import run_job

    cfg = _svc_cfg(files, pattern, **extra)
    cfg.work_dir = str(tmp_path / sub)
    return _outs(run_job(cfg, n_workers=2).output_files)


def test_service_dispatch_count_k4_one_per_split(tmp_path, monkeypatch):
    """K = 4 co-running jobs over one corpus: one scan a split, counted
    where every scan of the kernels' path goes (device_scan.scan_device;
    DGREP_DEVICE_MIN_BYTES=0, so no small-input host route hides it); the
    daemon's and the engine's fusion counters agree."""
    monkeypatch.setenv("DGREP_DEVICE_MIN_BYTES", "0")
    calls: list[int] = []
    orig = device_scan.scan_device

    def counted(eng, data, progress=None, **kw):
        calls.append(len(data))
        return orig(eng, data, progress=progress, **kw)

    monkeypatch.setattr(device_scan, "scan_device", counted)
    files = _svc_corpus(tmp_path)
    pats = ["hello", "fox", "line 1", "of 0"]
    jids, st, svc = _svc_run(tmp_path, files, pats, **ENGINE_OPTS)
    outs = {j: _outs(svc.record(j).outputs) for j in jids}
    svc.stop()
    assert len(calls) == len(files)
    assert st["fusion"]["fused_dispatches"] == len(files)
    assert st["fusion"]["fused_jobs"] == len(pats) * len(files)
    cc = fuse_mod.fusion_counters()
    assert cc["fused_dispatches"] == len(files)
    assert cc["fused_queries"] == len(pats) * len(files)
    for i, (j, p) in enumerate(zip(jids, pats)):
        assert outs[j] == _solo_job(tmp_path, files, p, f"o{i}",
                                    **ENGINE_OPTS), p


def test_service_fused_outputs_identical_and_spans(tmp_path):
    """Fused outputs equal the solo jobs' and the reference daemon's (its
    planner fuses the same pair); fuse:plan and fuse:split land in each
    participant's events.jsonl."""
    from distributed_grep_tpu.runtime.service import GrepService as RefService
    from distributed_grep_tpu.utils.config import JobConfig as RefConfig

    files = _svc_corpus(tmp_path, n_lines=200)
    pats = ["hello", "fox"]
    jids, st, svc = _svc_run(tmp_path, files, pats, spans=True)
    try:
        assert st["fusion"]["fused_dispatches"] >= 1
        outs = {j: _outs(svc.record(j).outputs) for j in jids}
        for j in jids:
            names = {json.loads(ln).get("name") for ln in
                     (svc.work_root / j / "events.jsonl").read_text()
                     .splitlines()}
            assert {"fuse:plan", "fuse:split"} <= names, (j, sorted(names))
    finally:
        svc.stop()
    ref = RefService(work_root=tmp_path / "ref")
    try:
        rj = [ref.submit(RefConfig(
            input_files=files, application="distributed_grep_tpu.apps.grep_tpu",
            app_options={"pattern": p, "backend": "cpu"}, n_reduce=2))
              for p in pats]
        ref.start_local_workers(1)
        for j in rj:
            assert ref.wait_job(j, timeout=60)
        assert ref.status()["fusion"]["fused_dispatches"] >= 1
        ref_outs = [_outs(ref.record(j).outputs) for j in rj]
    finally:
        ref.stop()
    for i, (j, p) in enumerate(zip(jids, pats)):
        assert outs[j] == _solo_job(tmp_path, files, p, f"o{i}"), p
        assert outs[j] == ref_outs[i], p


def test_service_fuses_a_set_only_with_sets(tmp_path):
    """The port's planner keeps a literal-set tenant out of a pattern
    tenants' union (fusion.query_family; their union would be one
    alternation of every member): two patterns and two sets over two
    splits give two fused groups a split, and every output is the solo
    job's."""
    assert fusion_mod.query_family({"patterns": ["a"]}) == "set"
    assert fusion_mod.query_family({"pattern": "a"}) == "pattern"
    files = _svc_corpus(tmp_path, n_lines=120)
    from distributed_grep_tpu_torch.runtime.service import GrepService

    svc = GrepService(work_root=tmp_path / "svc")
    tenants = [{"pattern": "hello"}, {"pattern": "fox"},
               {"patterns": ["line 1", "of 0"]}, {"patterns": ["hello"]}]
    try:
        jids = []
        for t in tenants:
            cfg = _svc_cfg(files, "x")
            cfg.app_options = {**t, "device": "cpu"}
            jids.append(svc.submit(cfg))
        svc.start_local_workers(1)
        for j in jids:
            assert svc.wait_job(j, timeout=60), svc.job_status(j)
        fusion = svc.status()["fusion"]
        outs = {j: _outs(svc.record(j).outputs) for j in jids}
        keys = [svc.record(j).fusion_key for j in jids]
    finally:
        svc.stop()
    assert keys[0] == keys[1] != keys[2] == keys[3]
    assert fusion["fused_dispatches"] == 2 * len(files)
    assert fusion["fused_jobs"] == 4 * len(files)
    from distributed_grep_tpu_torch.runtime.job import run_job

    for i, (j, t) in enumerate(zip(jids, tenants)):
        cfg = _svc_cfg(files, "x")
        cfg.app_options = {**t, "device": "cpu"}
        cfg.work_dir = str(tmp_path / f"o{i}")
        assert outs[j] == _outs(run_job(cfg, n_workers=2).output_files), t


def test_fusion_disabled_is_a_noop(tmp_path, monkeypatch):
    monkeypatch.setenv("DGREP_SERVICE_FUSE", "0")
    assert "fused" not in rpc.reply_to_dict(rpc.AssignTaskReply())
    files = _svc_corpus(tmp_path, n_lines=120)
    pats = ["hello", "fox"]
    jids, st, svc = _svc_run(tmp_path, files, pats)
    try:
        assert all(svc.record(j).fusion_key is None for j in jids)
        assert "fusion" not in st
        outs = {j: _outs(svc.record(j).outputs) for j in jids}
    finally:
        svc.stop()
    assert not fuse_mod.fusion_counters()
    for i, (j, p) in enumerate(zip(jids, pats)):
        assert outs[j] == _solo_job(tmp_path, files, p, f"o{i}"), p


def test_fusion_knobs_parse_as_the_reference(monkeypatch):
    from distributed_grep_tpu.runtime import fusion as ref_fusion

    for fuse, cap in ((None, None), ("0", "1"), ("no", "bogus"),
                      ("1", "5"), ("false", "")):
        for k, v in (("DGREP_SERVICE_FUSE", fuse),
                     ("DGREP_FUSE_MAX_QUERIES", cap)):
            if v is None:
                monkeypatch.delenv(k, raising=False)
            else:
                monkeypatch.setenv(k, v)
        assert fusion_mod.env_service_fuse() is ref_fusion.env_service_fuse()
        assert (fusion_mod.env_fuse_max_queries()
                == ref_fusion.env_fuse_max_queries())


def test_submit_pattern_set_parity(tmp_path, capsys):
    """``submit -F -e A -e B`` sends the set the local CLI would; the
    daemon's outputs equal the port's run_job and the reference's."""
    from distributed_grep_tpu.runtime.job import run_job as ref_run_job
    from distributed_grep_tpu.utils.config import JobConfig as RefConfig
    from distributed_grep_tpu_torch import __main__ as cli
    from distributed_grep_tpu_torch.runtime.job import run_job
    from distributed_grep_tpu_torch.runtime.service import (
        GrepService,
        ServiceServer,
    )

    files = _svc_corpus(tmp_path, n_lines=80)
    svc = GrepService(work_root=tmp_path / "svc")
    server = ServiceServer(svc)
    server.start()
    try:
        svc.start_local_workers(1)
        rc = cli.main(["submit", "--addr", f"127.0.0.1:{server.port}",
                       "--backend", "cpu", "-F", "-e", "hello", "-e", "fox",
                       *files, "--timeout", "60"])
        out = capsys.readouterr().out.strip().splitlines()
        assert rc == 0, out
        doc = json.loads(out[-1])
        assert doc["state"] == "done" and doc["outputs"]
        got = _outs(doc["outputs"])
    finally:
        server.shutdown()
        svc.stop()
    opts = {"patterns": ["hello", "fox"], "backend": "cpu"}
    assert got == _outs(run_job(JobConfig(
        input_files=files, application=GREP_CUDA, app_options=opts,
        n_reduce=10, work_dir=str(tmp_path / "o")), n_workers=2
    ).output_files)
    assert got == _outs(ref_run_job(RefConfig(
        input_files=files, application="distributed_grep_tpu.apps.grep_tpu",
        app_options=opts, n_reduce=10, work_dir=str(tmp_path / "r")),
        n_workers=2).output_files)


def test_service_fuse_error_runs_solo_a_scan_error_fails(tmp_path,
                                                         monkeypatch):
    """D7 through the daemon: a FuseError (the union cannot host these
    queries) runs each participant solo, and every output is exact; an
    error in the union's scan fails the fused attempt's jobs with that
    error, and no participant is run solo."""
    from distributed_grep_tpu_torch.runtime import worker as worker_mod

    files = _svc_corpus(tmp_path, n_lines=120)
    pats = ["hello", "fox"]

    def no_union(*a, **kw):
        raise fuse_mod.FuseError("injected: no union hosts these queries")

    with monkeypatch.context() as m:
        m.setattr(fuse_mod, "FusedScanner", no_union)
        jids, st, svc = _svc_run(tmp_path, files, pats)
        try:
            assert st["fusion"]["fused_dispatches"] >= 1
            outs = {j: _outs(svc.record(j).outputs) for j in jids}
        finally:
            svc.stop()
    for i, (j, p) in enumerate(zip(jids, pats)):
        assert outs[j] == _solo_job(tmp_path, files, p, f"o{i}"), p

    monkeypatch.setenv("DGREP_DEVICE_MIN_BYTES", "0")
    solo_runs = []
    monkeypatch.setattr(worker_mod.WorkerLoop, "_solo_participant_records",
                        lambda *a, **k: solo_runs.append(a))

    def broken(*a, **k):
        raise RuntimeError("injected: the union's kernel failed to launch")

    monkeypatch.setattr(device_scan, "scan_device", broken)
    from distributed_grep_tpu_torch.runtime.service import GrepService

    svc = GrepService(work_root=tmp_path / "svc2")
    try:
        jids = [svc.submit(_svc_cfg(files, p, **ENGINE_OPTS)) for p in pats]
        deadline = time.monotonic() + 30
        while not all(svc.record(j).scheduler is not None for j in jids):
            assert time.monotonic() < deadline
            time.sleep(0.02)
        svc.start_local_workers(1)
        for j in jids:
            assert svc.wait_job(j, timeout=60)
            st = svc.job_status(j)
            assert st["state"] == "failed", st
            assert "union's kernel" in st["error"]
        assert svc.status()["fusion"]["fused_dispatches"] == 1
    finally:
        svc.stop()
    assert not solo_runs


# ------------------------------------------------------------- the card

@pytest.mark.cuda
def test_fused_scan_launches_the_union_kernel_on_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    monkeypatch.setenv("DGREP_DEVICE_MIN_BYTES", "0")
    rng = np.random.default_rng(7)
    words = [b"volcano", b"hello", b"tail", b"needle", b"the", b"of", b"ash"]
    lines = [b" ".join(words[int(j)] for j in rng.integers(0, 7, 6))
             for _ in range(2 << 20 // 30)]
    data = (b"\n".join(lines) + b"\n")[: 2 << 20]
    for mix, kernel in (("sets", "fdr"), ("regexes", "nfa")):
        specs = MIXES[mix]
        before = device_scan.kernel_launches()
        got = fuse_mod.FusedScanner(specs, device="cuda").scan(data)
        launched = {k: v - before[k]
                    for k, v in device_scan.kernel_launches().items()}
        assert launched[kernel] >= 1, launched
        want = fuse_mod.FusedScanner(specs, device="cpu").scan(data)
        for spec, g, w in zip(specs, got, want):
            assert g.matched_lines.tolist() == w.matched_lines.tolist(), spec


@pytest.mark.cuda
def test_service_k4_fused_assignment_launches_one_union_route_a_window(
        tmp_path, monkeypatch):
    """Through the daemon on the card: K = 4 co-running jobs launch one
    kernel of the union's route a split (one window each), no other
    kernel, and give the bytes of the same jobs on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    from distributed_grep_tpu_torch.runtime.service import GrepService

    monkeypatch.setenv("DGREP_DEVICE_MIN_BYTES", "0")
    files = _svc_corpus(tmp_path)
    pats = ["hello", "fox", "line 1", "of 0"]
    outs = {}
    for device in ("cuda", "cpu"):
        svc = GrepService(work_root=tmp_path / f"svc-{device}")
        try:
            jids = [svc.submit(JobConfig(
                input_files=files, application=GREP_CUDA, n_reduce=2,
                app_options={"pattern": p, "device": device}))
                for p in pats]
            deadline = time.monotonic() + 60
            while not all(svc.record(j).scheduler is not None
                          for j in jids):
                assert time.monotonic() < deadline
                time.sleep(0.02)
            before = device_scan.kernel_launches()
            svc.start_local_workers(1)
            for j in jids:
                assert svc.wait_job(j, timeout=300), svc.job_status(j)
            launched = {k: v - before.get(k, 0) for k, v in
                        device_scan.kernel_launches().items()
                        if v - before.get(k, 0)}
            assert svc.status()["fusion"]["fused_dispatches"] == len(files)
            outs[device] = [_outs(svc.record(j).outputs) for j in jids]
        finally:
            svc.stop()
        if device == "cuda":
            assert len(launched) == 1, launched
            assert sum(launched.values()) == len(files), launched
    assert outs["cuda"] == outs["cpu"]
