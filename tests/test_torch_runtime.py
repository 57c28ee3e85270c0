"""The port's runtime against the reference's (tests/test_runtime.py's
cases): scheduler semantics, whole jobs, fault tolerance, the journal, the
heartbeat grace; each job's mr-out bytes equal the reference's run_job on
the same inputs.  Beyond them: the commit protocol's crash points, a lost
intermediate file, and the epoch fence."""

import json
import threading
import time
from pathlib import Path

import pytest

from distributed_grep_tpu.runtime.job import run_job as ref_run_job
from distributed_grep_tpu.utils.config import JobConfig as RefJobConfig
from distributed_grep_tpu_torch.runtime import rpc
from distributed_grep_tpu_torch.runtime.job import JobResult, run_job
from distributed_grep_tpu_torch.runtime.scheduler import Scheduler
from distributed_grep_tpu_torch.runtime.store import CrashPoint
from distributed_grep_tpu_torch.runtime.types import TaskState
from distributed_grep_tpu_torch.runtime.worker import WorkerKilled
from distributed_grep_tpu_torch.utils.config import JobConfig

APPS = {"grep": ("distributed_grep_tpu_torch.apps.grep",
                 "distributed_grep_tpu.apps.grep"),
        "wordcount": ("distributed_grep_tpu_torch.apps.wordcount",
                      "distributed_grep_tpu.apps.wordcount")}


def make_config(tmp_path, corpus, pattern="hello", app="grep", **kw):
    defaults = dict(
        input_files=[str(p) for p in corpus.values()],
        application=APPS[app][0],
        app_options={"pattern": pattern} if app == "grep" else {},
        n_reduce=4,
        work_dir=str(tmp_path / "job"),
        task_timeout_s=2.0,
        sweep_interval_s=0.1,
    )
    defaults.update(kw)
    return JobConfig(**defaults)


def ref_outputs(tmp_path, cfg: JobConfig, app="grep") -> dict[str, bytes]:
    """The reference's run_job over the same inputs and options."""
    res = ref_run_job(RefJobConfig(
        input_files=list(cfg.input_files), application=APPS[app][1],
        app_options=dict(cfg.app_options), n_reduce=cfg.n_reduce,
        work_dir=str(tmp_path / "ref")), n_workers=2)
    return outputs(res.output_files)


def outputs(paths) -> dict[str, bytes]:
    return {Path(p).name: Path(p).read_bytes() for p in paths}


def expected_lines(corpus, needle=b"hello"):
    out = set()
    for path in corpus.values():
        for i, line in enumerate(path.read_bytes().split(b"\n"), start=1):
            if needle in line:
                out.add(f"{path} (line number #{i})\t{line.decode()}")
    return out


def output_lines(res):
    lines = set()
    for f in res.output_files:
        lines.update(x for x in Path(f).read_text().splitlines() if x)
    return lines


# --------------------------------------------------------------- scheduler

def test_scheduler_map_before_reduce():
    s = Scheduler(files=["f1", "f2"], n_reduce=2, sweep_interval_s=0.05)
    r1 = s.assign_task(rpc.AssignTaskArgs(), timeout=1.0)
    r2 = s.assign_task(rpc.AssignTaskArgs(), timeout=1.0)
    assert {r1.assignment, r2.assignment} == {rpc.Assignment.MAP}
    assert {r1.filename, r2.filename} == {"f1", "f2"}
    assert r1.worker_id != r2.worker_id  # ids allocated at assignment
    # no reduce until the map phase completes
    r3 = s.assign_task(rpc.AssignTaskArgs(worker_id=r1.worker_id), timeout=0.2)
    assert r3.assignment == "retry"
    s.map_finished(rpc.TaskFinishedArgs(task_id=r1.task_id, produced_parts=[0]))
    s.map_finished(rpc.TaskFinishedArgs(task_id=r2.task_id, produced_parts=[1]))
    r4 = s.assign_task(rpc.AssignTaskArgs(worker_id=r1.worker_id), timeout=1.0)
    assert r4.assignment == rpc.Assignment.REDUCE
    s.stop()


def test_scheduler_idempotent_map_finished():
    s = Scheduler(files=["f1"], n_reduce=2, sweep_interval_s=0.05)
    a = s.assign_task(rpc.AssignTaskArgs(), timeout=1.0)
    s.map_finished(rpc.TaskFinishedArgs(task_id=a.task_id, produced_parts=[0]))
    # a timed-out clone finishing late is absorbed
    s.map_finished(rpc.TaskFinishedArgs(task_id=a.task_id, produced_parts=[0]))
    assert s.reduce_tasks[0].task_files == ["mr-0-0"]
    assert s.counters["map_completed"] == 1
    s.stop()


def test_scheduler_timeout_reenqueues_same_task_id():
    s = Scheduler(files=["f1"], n_reduce=1, task_timeout_s=0.3,
                  sweep_interval_s=0.05)
    a = s.assign_task(rpc.AssignTaskArgs(), timeout=1.0)
    assert a.assignment == rpc.Assignment.MAP
    b = s.assign_task(rpc.AssignTaskArgs(), timeout=3.0)
    assert b.assignment == rpc.Assignment.MAP
    assert b.task_id == a.task_id
    assert s.map_tasks[a.task_id].attempts == 2
    assert s.counters["map_retries"] == 1
    s.stop()


def test_scheduler_streaming_shuffle_before_map_phase_end():
    """A reducer streams files while maps still run."""
    s = Scheduler(files=["f1", "f2"], n_reduce=1, sweep_interval_s=0.05)
    a1 = s.assign_task(rpc.AssignTaskArgs(), timeout=1.0)
    s.map_finished(rpc.TaskFinishedArgs(task_id=a1.task_id, produced_parts=[0]))
    r = s.reduce_next_file(rpc.ReduceNextFileArgs(task_id=0,
                                                  files_processed=0),
                           timeout=1.0)
    assert r.next_file == f"mr-{a1.task_id}-0" and not r.done
    result = {}

    def fetch():
        result["r"] = s.reduce_next_file(
            rpc.ReduceNextFileArgs(task_id=0, files_processed=1), timeout=5.0)

    t = threading.Thread(target=fetch)
    t.start()
    time.sleep(0.2)
    assert "r" not in result  # the fetch long-polls
    a2 = s.assign_task(rpc.AssignTaskArgs(), timeout=1.0)
    s.map_finished(rpc.TaskFinishedArgs(task_id=a2.task_id, produced_parts=[0]))
    t.join(timeout=5.0)
    assert result["r"].next_file == f"mr-{a2.task_id}-0"
    r3 = s.reduce_next_file(rpc.ReduceNextFileArgs(task_id=0,
                                                   files_processed=2),
                            timeout=1.0)
    assert r3.done
    s.stop()


def test_scheduler_done_predicate_is_pure():
    s = Scheduler(files=[], n_reduce=1, sweep_interval_s=0.05)
    a = s.assign_task(rpc.AssignTaskArgs(), timeout=1.0)
    assert a.assignment == rpc.Assignment.REDUCE  # no map: the phase is over
    s.reduce_finished(rpc.TaskFinishedArgs(task_id=a.task_id))
    assert s.done() and s.done()
    s.stop()


def test_scheduler_stale_epoch_aborts_and_lost_file_reruns_its_map():
    s = Scheduler(files=["f1", "f2"], n_reduce=1, sweep_interval_s=0.05)
    for _ in range(2):
        a = s.assign_task(rpc.AssignTaskArgs(), timeout=1.0)
        s.map_finished(rpc.TaskFinishedArgs(task_id=a.task_id,
                                            produced_parts=[0]))
    red = s.assign_task(rpc.AssignTaskArgs(worker_id=7), timeout=1.0)
    assert red.assignment == rpc.Assignment.REDUCE
    stale = s.reduce_next_file(rpc.ReduceNextFileArgs(
        task_id=0, files_processed=0, epoch="not-this-one"), timeout=0.1)
    assert stale.abort
    lost = s.reduce_next_file(rpc.ReduceNextFileArgs(
        task_id=0, files_processed=0, epoch=red.epoch, worker_id=7,
        lost_file="mr-1-0"), timeout=0.1)
    assert lost.abort
    assert s.map_tasks[1].state is TaskState.UNASSIGNED
    assert s.reduce_tasks[0].state is TaskState.UNASSIGNED
    again = s.assign_task(rpc.AssignTaskArgs(worker_id=7), timeout=1.0)
    assert again.assignment == rpc.Assignment.MAP and again.task_id == 1
    s.stop()


# -------------------------------------------------------------- end-to-end

def test_grep_job_end_to_end(tmp_path, corpus):
    cfg = make_config(tmp_path, corpus, pattern="hello")
    res = run_job(cfg, n_workers=3, device="cpu")
    assert output_lines(res) == expected_lines(corpus)
    assert outputs(res.output_files) == ref_outputs(tmp_path, cfg)
    assert res.metrics["counters"]["map_completed"] == 3
    assert res.metrics["counters"]["reduce_completed"] == 4


def test_wordcount_job_end_to_end(tmp_path, corpus):
    import re

    cfg = make_config(tmp_path, corpus, app="wordcount")
    res = run_job(cfg, n_workers=2, device="cpu")
    text = b" ".join(p.read_bytes() for p in corpus.values()).decode()
    words = [w.lower() for w in re.findall(r"[A-Za-z]+", text)]
    assert res.results["hello"] == str(words.count("hello"))
    assert res.results["fox"] == str(words.count("fox"))
    assert outputs(res.output_files) == ref_outputs(tmp_path, cfg,
                                                    "wordcount")


def test_job_fault_injection_worker_death_recovers(tmp_path, corpus):
    """Worker 0 dies before its first map commit; the job finishes with
    the reference's bytes (at-least-once execution, exactly-once output)."""
    killed = {"n": 0}

    def die_once():
        if killed["n"] == 0:
            killed["n"] += 1
            raise WorkerKilled()

    cfg = make_config(tmp_path, corpus, task_timeout_s=1.0)
    res = run_job(cfg, n_workers=2, device="cpu",
                  fault_hooks_per_worker=[{"before_map_commit": die_once}, {}])
    assert killed["n"] == 1
    assert res.metrics["counters"]["map_completed"] == 3
    assert res.metrics["counters"].get("map_retries", 0) >= 1
    assert outputs(res.output_files) == ref_outputs(tmp_path, cfg)


def test_job_journal_resume_skips_completed_work(tmp_path, corpus):
    """A coordinator restart: the journal's replay skips finished tasks."""
    cfg = make_config(tmp_path, corpus)
    res1 = run_job(cfg, n_workers=2, device="cpu")
    first = outputs(res1.output_files)
    res2 = run_job(cfg, n_workers=2, device="cpu", resume=True)
    assert res2.metrics["counters"].get("map_assigned", 0) == 0
    assert res2.metrics["counters"].get("reduce_assigned", 0) == 0
    assert outputs(res2.output_files) == first == ref_outputs(tmp_path, cfg)


def test_job_journal_resume_after_a_crash_runs_only_the_rest(tmp_path,
                                                              corpus):
    """The journal of a job whose every worker died after one map commit:
    a resumed run assigns the other maps only."""
    commits = {"n": 0}

    def die_after_first():
        commits["n"] += 1
        if commits["n"] >= 2:
            raise WorkerKilled()

    cfg = make_config(tmp_path, corpus, task_timeout_s=30.0)
    with pytest.raises(RuntimeError, match="all workers exited"):
        run_job(cfg, n_workers=1, device="cpu",
                fault_hooks_per_worker=[{"before_map_finished":
                                         die_after_first}])
    res = run_job(cfg, n_workers=2, device="cpu", resume=True)
    assert res.metrics["counters"]["map_assigned"] == 2
    assert outputs(res.output_files) == ref_outputs(tmp_path, cfg)


def test_duplicate_execution_is_idempotent(tmp_path, corpus):
    """Two workers racing the same re-issued task commit identical files."""
    slow_once = {"done": False}

    def stall():
        if not slow_once["done"]:
            slow_once["done"] = True
            time.sleep(2.5)  # past task_timeout_s: the task is re-issued

    cfg = make_config(tmp_path, corpus, task_timeout_s=1.0)
    res = run_job(cfg, n_workers=2, device="cpu",
                  fault_hooks_per_worker=[{"before_map_commit": stall}, {}])
    assert output_lines(res) == expected_lines(corpus)
    assert outputs(res.output_files) == ref_outputs(tmp_path, cfg)


@pytest.mark.parametrize("store", ["posix", "nonatomic"])
@pytest.mark.parametrize("point", CrashPoint.ALL)
def test_crash_at_each_commit_point_keeps_output_exact(tmp_path, corpus,
                                                       store, point):
    """A worker that dies at one instruction of the commit protocol, once,
    on either store: the outputs equal the reference's."""
    fired = {"n": 0}

    def hook(ctx):
        if fired["n"] or not ctx.startswith(("map-", "mr-0-")):
            return False
        fired["n"] += 1
        if point == CrashPoint.TORN_COMMIT_RECORD:
            return True
        raise WorkerKilled(ctx)

    cfg = make_config(tmp_path, corpus, task_timeout_s=1.0, store=store)
    res = run_job(cfg, n_workers=2, device="cpu",
                  store_faults_per_worker=[{point: hook}, {}])
    assert fired["n"] == 1
    got = {Path(p).name.split(".")[0]: Path(p).read_bytes()
           for p in res.output_files}
    assert got == ref_outputs(tmp_path, cfg)


def test_lost_intermediate_file_reruns_its_map(tmp_path, corpus,
                                               monkeypatch):
    """A registered intermediate file gone from the work dir: the reducer
    reports it, its map task runs again, and the outputs stay exact."""
    from distributed_grep_tpu_torch.runtime.transport import LocalTransport

    real = LocalTransport.read_intermediate
    lost = {"n": 0}

    def read_once_lost(self, name):
        if not lost["n"]:
            lost["n"] += 1
            (self.workdir.root / "intermediate" / name).unlink()
        return real(self, name)

    monkeypatch.setattr(LocalTransport, "read_intermediate", read_once_lost)
    cfg = make_config(tmp_path, corpus)
    res = run_job(cfg, n_workers=2, device="cpu")
    assert lost["n"] == 1
    assert res.metrics["counters"]["maps_lost_output"] == 1
    assert outputs(res.output_files) == ref_outputs(tmp_path, cfg)


# ---------------------------------------------------- mid-task heartbeats

def test_heartbeat_grace_window():
    """A declared silent phase extends the sweep window once; a plain stamp
    ends it."""
    s = Scheduler(files=["f1"], n_reduce=1, task_timeout_s=0.3,
                  sweep_interval_s=0.05)
    a = s.assign_task(rpc.AssignTaskArgs(), timeout=1.0)
    s.heartbeat("map", a.task_id, grace_s=2.5)
    time.sleep(0.8)  # past task_timeout_s, inside the grace
    assert s.map_tasks[a.task_id].state is TaskState.IN_PROGRESS
    s.heartbeat("map", a.task_id)  # a plain stamp: the grace ends
    assert s.map_tasks[a.task_id].grace_s == 0.0
    time.sleep(0.8)
    assert s.map_tasks[a.task_id].state is TaskState.UNASSIGNED
    assert s.map_tasks[a.task_id].attempts == 1
    # a straggler's late stamp does not resurrect the re-enqueued task
    s.heartbeat("map", a.task_id, grace_s=99.0)
    assert s.map_tasks[a.task_id].grace_s == 0.0
    assert s.counters["grace_declared"] == 1
    s.stop()


_SLOW_APP = '''
import time

_progress = None
_mode = "progress"


def set_progress(fn):
    global _progress
    _progress = fn


def configure(mode="progress", **kw):
    global _mode
    _mode = mode


def map_fn(filename, contents):
    if _mode == "grace":
        if _progress:
            _progress(grace_s=3.0)
        time.sleep(1.0)
    elif _mode == "hang":
        time.sleep(1.0)  # no progress: swept and retried
    else:
        for _ in range(10):
            time.sleep(0.1)
            if _progress:
                _progress()
    return []


def reduce_fn(key, values):
    return ""
'''


def _slow_job(tmp_path, mode, n_workers, app=_SLOW_APP):
    app_py = tmp_path / "slow_app.py"
    app_py.write_text(app)
    f = tmp_path / "in.txt"
    f.write_text("x\n")
    cfg = JobConfig(input_files=[str(f)], application=str(app_py),
                    app_options={"mode": mode}, n_reduce=1,
                    work_dir=str(tmp_path / "job"), task_timeout_s=0.4,
                    sweep_interval_s=0.05)
    return run_job(cfg, n_workers=n_workers, device="cpu").metrics["counters"]


@pytest.mark.parametrize("mode", ["progress", "grace"])
def test_slow_map_survives_tight_timeout_via_heartbeats(tmp_path, mode):
    """A 1 s map under a 0.4 s window completes in one attempt when it
    reports progress or declares a grace."""
    counters = _slow_job(tmp_path, mode, 1)
    assert counters.get("map_retries", 0) == 0
    assert counters.get("heartbeats", 0) >= 1
    assert counters["map_completed"] == 1


def test_hung_map_still_swept_under_tight_timeout(tmp_path):
    counters = _slow_job(tmp_path, "hang", 2)
    assert counters.get("map_retries", 0) >= 1
    assert counters["map_completed"] == 1


def test_results_materialize_guard(tmp_path):
    p = tmp_path / "mr-out-0"
    p.write_text("k\tv\n" * 1000)
    assert JobResult(output_files=[p]).results == {"k": "v"}
    small = JobResult(output_files=[p])
    small.RESULTS_MATERIALIZE_LIMIT = 100
    with pytest.raises(RuntimeError, match="stream via iter_results"):
        _ = small.results
    assert sum(1 for _ in small.iter_results()) == 1000


def test_progressless_app_survives_via_compute_pump(tmp_path):
    """An app without set_progress is not swept mid-compute: the worker
    pumps liveness over its compute leg."""
    mute = ("import time\n"
            "def configure(**kw): pass\n"
            "def map_fn(filename, contents):\n"
            "    time.sleep(1.0)\n"
            "    return []\n"
            "def reduce_fn(key, values):\n"
            "    return ''\n")
    counters = _slow_job(tmp_path, "x", 1, app=mute)
    assert counters.get("map_retries", 0) == 0
    assert counters.get("heartbeats", 0) >= 1
    assert counters["map_completed"] == 1


def test_slow_shuffle_leg_survives_tight_timeout(tmp_path, monkeypatch):
    """The map's shuffle leg runs after the app's last stamp; the worker
    pumps liveness over it, so a slow one completes in one attempt."""
    from distributed_grep_tpu_torch.runtime import shuffle as shuffle_mod
    from distributed_grep_tpu_torch.runtime.worker import WorkerLoop

    emit = ("from distributed_grep_tpu_torch.apps.base import KeyValue\n"
            "_p = None\n"
            "def set_progress(fn):\n"
            "    global _p; _p = fn\n"
            "def configure(**kw): pass\n"
            "def map_fn(filename, contents):\n"
            "    if _p: _p()\n"
            "    return [KeyValue(key='k', value='v')]\n"
            "def reduce_fn(key, values):\n"
            "    return values[0]\n")
    real_encode = shuffle_mod.encode_records
    encoded = []

    def slow_encode(kvs):
        encoded.append(len(kvs))
        time.sleep(1.0)  # slower than the 0.4 s window
        return real_encode(kvs)

    monkeypatch.setattr(shuffle_mod, "encode_records", slow_encode)
    # a small local shuffle runs without a pump; as a remote transport's
    # the leg is pumped at any size
    real_init = WorkerLoop.__init__

    def remote_init(self, *a, **kw):
        real_init(self, *a, **kw)
        self.is_local = False

    monkeypatch.setattr(WorkerLoop, "__init__", remote_init)
    counters = _slow_job(tmp_path, "x", 1, app=emit)
    assert encoded
    assert counters.get("map_retries", 0) == 0
    assert counters["map_completed"] == 1


@pytest.mark.parametrize("app", ["wordcount", "grep"])
def test_run_subcommand_stdout_equals_reference(tmp_path, corpus,
                                                capsysbinary, app):
    """``run --config`` prints the same lines as the reference CLI's, and
    ``--resume`` over the finished job prints them again with nothing
    assigned."""
    from distributed_grep_tpu.__main__ import main as ref_main
    from distributed_grep_tpu_torch.__main__ import main

    cfg = make_config(tmp_path, corpus, app=app)
    port_cfg = tmp_path / "port.json"
    port_cfg.write_text(cfg.to_json())
    ref_cfg = tmp_path / "ref.json"
    ref_cfg.write_text(RefJobConfig(
        input_files=list(cfg.input_files), application=APPS[app][1],
        app_options=dict(cfg.app_options), n_reduce=cfg.n_reduce,
        work_dir=str(tmp_path / "ref")).to_json())
    assert ref_main(["run", "--config", str(ref_cfg)]) == 0
    want = capsysbinary.readouterr().out
    assert want
    port_opts = {**cfg.app_options, "device": "cpu"}  # the card otherwise
    port_cfg.write_text(JobConfig(**{**json.loads(cfg.to_json()),
                                     "app_options": port_opts}).to_json())
    assert main(["run", "--config", str(port_cfg)]) == 0
    assert capsysbinary.readouterr().out == want
    assert main(["run", "--config", str(port_cfg), "--resume",
                 "--metrics"]) == 0
    captured = capsysbinary.readouterr()
    assert captured.out == want
    assert json.loads(captured.err)["counters"] == {}


def test_rpc_wire_round_trip_and_elision():
    """Optional fields leave the wire at their defaults, as the
    reference's do; what goes out comes back."""
    from distributed_grep_tpu.runtime import rpc as ref_rpc

    args = rpc.TaskFinishedArgs(task_id=3, produced_parts=[0, 2])
    assert rpc.to_dict(args) == ref_rpc.to_dict(
        ref_rpc.TaskFinishedArgs(task_id=3, produced_parts=[0, 2]))
    full = rpc.TaskFinishedArgs(task_id=3, worker_id=1, metrics={
        "counters": {"map_records": 5}, "launches": {"shift_and": 2}})
    assert rpc.from_dict("TaskFinishedArgs", rpc.to_dict(full)) == full
    reply = rpc.AssignTaskReply(assignment=rpc.Assignment.MAP, task_id=0,
                                filename="f", n_reduce=2, worker_id=4)
    wire = rpc.reply_to_dict(reply)
    assert wire == ref_rpc.reply_to_dict(ref_rpc.AssignTaskReply(
        assignment="map", task_id=0, filename="f", n_reduce=2, worker_id=4))
    assert rpc.AssignTaskReply(**wire) == reply
    nxt = rpc.ReduceNextFileArgs(task_id=1, files_processed=2,
                                 lost_file="mr-0-1")
    assert rpc.from_dict("ReduceNextFileArgs", rpc.to_dict(nxt)) == nxt


@pytest.mark.parametrize("chunk,overlap", [(1, 0), (7, 0), (7, 3), (64, 63),
                                           (4096, 16)])
def test_read_chunks_equals_reference(tmp_path, chunk, overlap):
    from distributed_grep_tpu.utils.io import read_chunks as ref_read_chunks
    from distributed_grep_tpu_torch.utils.io import read_chunks

    p = tmp_path / "f.bin"
    p.write_bytes(bytes(range(256)) * 5 + b"tail")
    assert list(read_chunks(p, chunk, overlap)) == list(
        ref_read_chunks(p, chunk, overlap))


# ------------------------------------------- a job config the reference wrote
_APPS3 = {"wordcount": {}, "inverted_index": {"min_word_len": 2},
          "grep": {"pattern": "hello"}}


@pytest.mark.parametrize("app", sorted(_APPS3))
def test_run_loads_the_reference_job_json(tmp_path, corpus, capsysbinary,
                                          app):
    """ROADMAP C10: the reference's JobConfig.to_json (which always writes
    backend, chunk_bytes, mesh_shape, mesh_axes and spans) loads in the
    port's ``run --config``, and the job prints the reference's lines."""
    from distributed_grep_tpu.__main__ import main as ref_main
    from distributed_grep_tpu_torch.__main__ import main

    files = [str(p) for p in corpus.values()]
    ref_cfg = tmp_path / "ref.json"
    ref_cfg.write_text(RefJobConfig(
        input_files=files, application=f"distributed_grep_tpu.apps.{app}",
        app_options=_APPS3[app], n_reduce=2,
        work_dir=str(tmp_path / "ref")).to_json())
    assert ref_main(["run", "--config", str(ref_cfg)]) == 0
    want = capsysbinary.readouterr().out
    assert want
    # the reference's writer, naming the port's application
    port_cfg = tmp_path / "port.json"
    text = RefJobConfig(
        input_files=files,
        application=f"distributed_grep_tpu_torch.apps.{app}",
        app_options=_APPS3[app], n_reduce=2,
        work_dir=str(tmp_path / "port")).to_json()
    assert {"backend", "chunk_bytes", "mesh_shape", "spans"} <= set(
        json.loads(text))
    port_cfg.write_text(text)
    assert main(["run", "--config", str(port_cfg)]) == 0
    assert capsysbinary.readouterr().out == want


@pytest.mark.parametrize("field,value,item", [
    ("submit_token", "tok", None), ("mesh_shape", (2,), "item 9"),
])
def test_reference_fields_of_unported_slices_name_their_item(
        tmp_path, corpus, capsys, field, value, item):
    """A reference config with a submit token (the failover slice) or a
    device mesh (item 9's first half) loads, runs with the reference's
    lines and round-trips, the field kept: the mesh reaches the CUDA grep
    app's options, which build it (on device "cpu", two host entries).
    At their defaults they load."""
    from distributed_grep_tpu.__main__ import main as ref_main
    from distributed_grep_tpu_torch.__main__ import main

    kw = {"input_files": [str(p) for p in corpus.values()],
          "application": "distributed_grep_tpu_torch.apps.grep_cuda",
          "app_options": {"pattern": "hello", "device": "cpu"},
          "n_reduce": 2, "work_dir": str(tmp_path / "w")}
    cfg = tmp_path / "job.json"
    cfg.write_text(RefJobConfig(**kw).to_json())
    assert JobConfig.load(cfg).effective_app_options() == kw["app_options"]
    cfg.write_text(RefJobConfig(**kw, **{field: value}).to_json())
    if item is not None:  # the mesh reaches the app, which builds it
        assert JobConfig.load(cfg).effective_app_options()["mesh_shape"] == [
            2]
    loaded = JobConfig.load(cfg)
    assert getattr(loaded, field) == value
    doc = json.loads(loaded.to_json())
    assert doc[field] == json.loads(cfg.read_text())[field]
    assert JobConfig.from_json(loaded.to_json()) == loaded
    assert main(["run", "--config", str(cfg)]) == 0
    got = capsys.readouterr().out
    ref_cfg = tmp_path / "ref.json"
    ref_cfg.write_text(RefJobConfig(**{
        **kw, "application": "distributed_grep_tpu.apps.grep",
        "app_options": {"pattern": "hello"}, "work_dir": str(tmp_path / "r"),
        field: value}).to_json())
    assert ref_main(["run", "--config", str(ref_cfg)]) == 0
    assert got == capsys.readouterr().out and "hello" in got


def test_reference_follow_config_loads_and_round_trips(tmp_path, corpus,
                                                        capsysbinary):
    """The follow fields load from the reference's JSON (a standing query
    for the daemon), leave the wire at their defaults as the reference's
    do, and round-trip; ``run --config`` of such a job runs it one-shot,
    as the reference's ``run`` does, with the reference's lines."""
    from distributed_grep_tpu.__main__ import main as ref_main
    from distributed_grep_tpu_torch.__main__ import main

    assert json.loads(JobConfig(input_files=["/x"]).to_json()).keys() == \
        json.loads(RefJobConfig(input_files=["/x"]).to_json()).keys() - {
            "backend", "chunk_bytes", "spans", "mesh_shape", "mesh_axes"}
    for kw in ({"follow": True}, {"follow": True, "follow_poll_s": 0.25},
               {"follow_poll_s": 0.25}):
        ref_doc = json.loads(RefJobConfig(input_files=["/x"], **kw).to_json())
        port = JobConfig.from_json(json.dumps(ref_doc))
        assert (port.follow, port.follow_poll_s) == (
            RefJobConfig(**{k: v for k, v in ref_doc.items()}).follow,
            ref_doc.get("follow_poll_s"))
        doc = json.loads(port.to_json())
        assert {k: doc[k] for k in ("follow", "follow_poll_s") if k in doc} \
            == {k: ref_doc[k] for k in ("follow", "follow_poll_s")
                if k in ref_doc}
    files = [str(p) for p in corpus.values()]
    outs = []
    for pkg, run in (("distributed_grep_tpu_torch", main),
                     ("distributed_grep_tpu", ref_main)):
        cfg = tmp_path / f"{pkg}.json"
        cfg.write_text(RefJobConfig(
            input_files=files, application=f"{pkg}.apps.grep",
            app_options={"pattern": "hello"}, n_reduce=2,
            work_dir=str(tmp_path / pkg), follow=True,
            follow_poll_s=0.1).to_json())
        assert run(["run", "--config", str(cfg)]) == 0
        outs.append(capsysbinary.readouterr().out)
    assert outs[0] == outs[1] and b"hello" in outs[0]


def test_host_app_job_never_asks_for_the_card(tmp_path, corpus,
                                              capsysbinary, monkeypatch):
    """ROADMAP C11: a word-count job with no device option runs and exits
    0 where CUDA is absent, in process and through a worker of a
    coordinator, without touching torch.cuda; the CUDA grep app without
    ``device: cpu`` still fails, naming the device."""
    import torch

    from distributed_grep_tpu.__main__ import main as ref_main
    from distributed_grep_tpu_torch.__main__ import main
    from distributed_grep_tpu_torch.runtime.http_coordinator import (
        CoordinatorServer,
    )
    from distributed_grep_tpu_torch.runtime.http_transport import (
        run_http_worker,
    )

    def no_context(*_a, **_k):
        raise AssertionError("a host-only job asked for a CUDA context")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "current_device", no_context)
    files = [str(p) for p in corpus.values()]
    ref_cfg = tmp_path / "ref.json"
    ref_cfg.write_text(RefJobConfig(
        input_files=files, application="distributed_grep_tpu.apps.wordcount",
        n_reduce=2, work_dir=str(tmp_path / "ref")).to_json())
    assert ref_main(["run", "--config", str(ref_cfg)]) == 0
    want = capsysbinary.readouterr().out
    cfg = tmp_path / "wc.json"
    cfg.write_text(json.dumps({
        "application": "distributed_grep_tpu_torch.apps.wordcount",
        "input_files": files, "n_reduce": 2,
        "work_dir": str(tmp_path / "port")}))
    assert main(["run", "--config", str(cfg)]) == 0
    assert capsysbinary.readouterr().out == want
    server = CoordinatorServer(JobConfig.load(
        cfg, work_dir=str(tmp_path / "http"), coordinator_port=0))
    server.start()
    try:
        run_http_worker(f"127.0.0.1:{server.port}")
        assert server.wait_done(10.0)
        assert server.status()["reduce"]["completed"] == 2
    finally:
        server.shutdown(linger_s=0.0)
    cfg.write_text(json.dumps({
        "input_files": files, "app_options": {"pattern": "hello"},
        "n_reduce": 2, "work_dir": str(tmp_path / "grep")}))
    assert main(["run", "--config", str(cfg)]) == 2
    assert b"device='cpu'" in capsysbinary.readouterr().err
