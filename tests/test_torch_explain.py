"""The port's routing reports (distributed_grep_tpu_torch/runtime/
explain.py, ``GET /jobs/<id>/explain``, the ``explain`` subcommand and
``submit --explain``) held to the reference's (distributed_grep_tpu/
runtime/explain.py).

On the same events both packages' ``assemble`` give the same document,
with one difference the port makes on purpose: ``all_lines`` (the port's
mode for a pattern every line matches, which launches nothing) is a host
mode, so a job that only ran it is routed ``"host"`` where the reference
(which has no such mode) would say ``"device"``.  And a fused scan's
per-query host confirms record no ``scan:*`` span of their own (they are
part of the union's scan), so a fused tenant reports its union's route.
The tolerance is zero.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

from distributed_grep_tpu_torch.index import summary as index_summary
from distributed_grep_tpu_torch.ops import engine as engine_mod
from distributed_grep_tpu_torch.ops import layout
from distributed_grep_tpu_torch.runtime import explain
from distributed_grep_tpu_torch.runtime.service import (
    GrepService,
    ServiceServer,
)
from distributed_grep_tpu_torch.utils.config import JobConfig

PORT_GREP = "distributed_grep_tpu_torch.apps.grep_cuda"
REF_GREP = "distributed_grep_tpu.apps.grep_tpu"


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setenv("DGREP_PEER_SHUFFLE", "0")
    monkeypatch.setenv("DGREP_NO_CALIBRATE", "1")
    for clear in (engine_mod.model_cache_clear, layout.corpus_cache_clear,
                  index_summary.clear):
        clear()
    yield
    for clear in (engine_mod.model_cache_clear, layout.corpus_cache_clear,
                  index_summary.clear):
        clear()


_INSTANTS = ["cache:hit", "cache:miss", "cache:off", "corpus:hit",
             "corpus:miss", "index:prune", "index:maybe", "result:hit",
             "result:partial", "result:miss", "result:revalidate",
             "fuse:plan", "fuse:split", "follow:wake", "fuse:wake",
             "shuffle:peer", "shuffle:relay", "map_lost_output",
             "assign_map", "assign_reduce", "task_timeout", "map_committed",
             "reduce_committed", "resume"]
_SPANS = ["scan:shift_and", "scan:nfa", "scan:fdr", "scan:native",
          "scan:re", "scan:batch", "map:task", "map:read", "reduce:task"]


def _events(seed: int, spans=_SPANS, instants=_INSTANTS) -> list[dict]:
    rng = np.random.default_rng(seed)
    out: list[dict] = []
    for _ in range(int(rng.integers(0, 120))):
        if rng.random() < 0.5:
            rec = {"t": "span", "name": str(rng.choice(spans)),
                   "ts": 1.7e9 + float(rng.uniform(0, 5)),
                   "dur": float(rng.uniform(0, 2))}
        else:
            rec = {"t": "instant", "name": str(rng.choice(instants)),
                   "ts": 1.7e9 + float(rng.uniform(0, 5))}
        if rng.random() < 0.7:
            rec["args"] = {
                "bytes": int(rng.integers(0, 1 << 20)),
                "matches": int(rng.integers(0, 50)),
                "queries": int(rng.integers(0, 9)),
                "records": int(rng.integers(0, 30)),
                "splits_reused": int(rng.integers(0, 4)),
                "bytes_unscanned": int(rng.integers(0, 1 << 16)),
                "fallback": bool(rng.random() < 0.3)}
        out.append(rec)
    if rng.random() < 0.2:
        out.append({"t": "worker_clock", "worker": 0, "offset_s": 0.1})
    return out


def _daemon_events(seed: int) -> list[dict]:
    rng = np.random.default_rng(seed + 100)
    kinds = ["start", "resume", "quarantine", "map_lost_output", "promoted",
             "stop", "worker_attach"]
    return [{"ts": float(rng.uniform(0, 30)), "epoch": 0,
             "kind": str(rng.choice(kinds)),
             "payload": {"job": str(rng.choice(["job-1", "job-2"])),
                         "failover_s": float(rng.uniform(0, 3))}}
            for _ in range(int(rng.integers(0, 12)))]


@pytest.mark.parametrize("seed", range(6))
def test_assemble_equals_the_reference_on_the_same_events(seed):
    from distributed_grep_tpu.runtime import explain as ref_explain
    from distributed_grep_tpu.utils.config import JobConfig as RefConfig

    rng = np.random.default_rng(seed)
    opts = {"pattern": "vol(cano)?", "ignore_case": True,
            "count_only": bool(seed % 2), "patterns": ["a", "b"] * (seed % 3)}
    kw = dict(job_id="job-1", state="done",
              submitted_at=10.0, started_at=11.5 + seed, finished_at=25.0,
              metrics_counters={"map_records": seed, "zero": 0,
                                "index_shards_pruned": 2},
              events=_events(seed),
              index_shards_pruned=int(rng.integers(0, 3)),
              index_bytes_skipped=int(rng.integers(0, 999)),
              result_splits_reused=int(rng.integers(0, 3)),
              result_bytes_unscanned=int(rng.integers(0, 999)),
              result_revalidations=int(rng.integers(0, 2)),
              daemon_events=_daemon_events(seed))
    port = explain.assemble(config=JobConfig(application=PORT_GREP,
                                             app_options=opts), **kw)
    ref = ref_explain.assemble(config=RefConfig(application=REF_GREP,
                                                app_options=opts), **kw)
    assert port["application"] == PORT_GREP
    port["application"] = REF_GREP
    assert json.dumps(port, sort_keys=True) == json.dumps(ref,
                                                           sort_keys=True)
    assert "degraded" != port["routing"]["route"]


@pytest.mark.parametrize("modes,route", [
    (["scan:all_lines"], "host"),
    (["scan:all_lines", "scan:native", "scan:re"], "host"),
    (["scan:all_lines", "scan:shift_and"], "mixed"),
    (["scan:shift_and", "scan:batch"], "device"),
    ([], "unknown"),
])
def test_all_lines_is_a_host_route(modes, route):
    """The port's host-only mode ``all_lines`` counts as the host; the rest
    of the report is the reference's (which would call all_lines a
    device family)."""
    from distributed_grep_tpu.runtime import explain as ref_explain

    events = [{"t": "span", "name": m, "ts": 1.0, "dur": 0.5,
               "args": {"bytes": 10, "matches": 2}} for m in modes]
    port = explain.assemble("j", None, "done", None, None, None, {}, events)
    ref = ref_explain.assemble("j", None, "done", None, None, None, {},
                               events)
    assert port["routing"]["route"] == route
    port["routing"]["route"] = ref["routing"]["route"]
    assert port == ref


def test_summarize_and_disruptions_equal_the_reference():
    from distributed_grep_tpu.runtime import explain as ref_explain

    for seed in range(8):
        ev = _events(seed)
        assert explain.summarize_events(ev) == \
            ref_explain.summarize_events(ev)
        dev = _daemon_events(seed)
        for lo, hi in ((None, None), (5.0, 20.0), (10.0, None)):
            assert explain.disruptions_view(dev, "job-1", lo, hi) == \
                ref_explain.disruptions_view(dev, "job-1", lo, hi)
        opts = {"pattern": "x", "invert": seed % 2 == 0, "backend": "cpu",
                "patterns": ["p"] * seed, "max_errors": seed % 3}
        assert explain._query_view(opts) == ref_explain._query_view(opts)


def test_explain_cli_of_a_work_dir_prints_the_references(tmp_path, capsys):
    """``explain WORK_DIR`` builds the report from the events.jsonl (and,
    in a service work root, its daemon.jsonl): the reference's stdout."""
    from distributed_grep_tpu.__main__ import main as ref_main
    from distributed_grep_tpu_torch.__main__ import main
    from distributed_grep_tpu_torch.runtime.daemon_log import DaemonLog
    from distributed_grep_tpu_torch.utils.spans import EventLog

    root = tmp_path / "root"
    job = root / "job-3"
    job.mkdir(parents=True)
    log = EventLog(job / "events.jsonl", fresh=True)
    log.write_many([e for e in _events(3) if e["t"] in ("span", "instant")])
    log.close()
    dl = DaemonLog(root)
    dl.append_now("start", work_root=str(root))
    dl.append_now("quarantine", worker=0)
    dl.close()
    for target in (str(job), str(job / "events.jsonl")):
        assert ref_main(["explain", target]) == 0
        want = capsys.readouterr().out
        assert main(["explain", target]) == 0
        assert capsys.readouterr().out == want
    assert main(["explain", str(tmp_path / "none")]) == 2
    assert "no event log" in capsys.readouterr().err


def _corpus(tmp_path: Path) -> dict[str, Path]:
    rng = np.random.default_rng(5)
    words = ["volcano", "ash", "the", "new", "old", "lava"]
    out = {}
    for i in range(2):
        p = tmp_path / f"w{i}.txt"
        p.write_text("\n".join(" ".join(words[j] for j in rng.integers(
            0, len(words), 4)) for _ in range(400)) + "\n")
        out[p.name] = p
    return out


def test_get_explain_over_http_and_submit_explain(tmp_path, capsys):
    """``GET /jobs/<id>/explain`` of a spans-on job: its route and the
    task accounting; ``submit --explain`` carries the same document on its
    line; an ``all_lines`` query (``a*``) is routed "host"; an unknown job
    answers 404."""
    import urllib.error
    import urllib.request

    from distributed_grep_tpu_torch import __main__ as cli

    corpus = _corpus(tmp_path)
    svc = GrepService(work_root=tmp_path / "svc", spans=True,
                      task_timeout_s=5.0, sweep_interval_s=0.1)
    server = ServiceServer(svc)
    server.start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        svc.start_local_workers(2)
        files = [str(p) for p in corpus.values()]
        jid = svc.submit(JobConfig(input_files=files, application=PORT_GREP,
                                   app_options={"pattern": "volcano",
                                                "device": "cpu"},
                                   n_reduce=2))
        assert svc.wait_job(jid, timeout=60)
        with urllib.request.urlopen(f"{base}/jobs/{jid}/explain") as r:
            doc = json.loads(r.read())
        assert doc["job_id"] == jid and doc["spans"] is True
        assert doc["routing"]["route"] == "device"
        assert set(doc["routing"]["engine_modes"]) == {"shift_and"}
        assert doc["tasks"]["map_commits"] == doc["tasks"]["map_assigns"] == 2
        assert doc["tasks"]["reduce_commits"] == 2
        assert doc["query"] == {"pattern": "volcano"}
        rc = cli.main(["submit", "--addr", f"127.0.0.1:{server.port}",
                       "--backend", "cpu", "--explain", "a*", *files,
                       "--n-reduce", "2", "--timeout", "60"])
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rc == 0 and line["state"] == "done"
        assert line["explain"]["routing"]["route"] == "host"
        assert set(line["explain"]["routing"]["engine_modes"]) == {
            "all_lines"}
        assert cli.main(["explain", "--addr", f"127.0.0.1:{server.port}",
                         line["job_id"]]) == 0
        doc2 = json.loads(capsys.readouterr().out)
        assert doc2["routing"] == line["explain"]["routing"]
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{base}/jobs/job-999/explain")
        assert ei.value.code == 404
        assert cli.main(["explain", "--addr", f"127.0.0.1:{server.port}",
                         "job-999"]) == 2
    finally:
        svc.stop()
        server.shutdown()


def test_service_explain_equals_the_references_on_a_host_job(tmp_path):
    """The same host-routed job (``--backend cpu``, the reference's
    default) through both daemons: the routing reports agree on the route,
    the modes' scans, bytes and matches, the tasks and the query."""
    from distributed_grep_tpu.runtime.service import GrepService as RefService
    from distributed_grep_tpu.utils.config import JobConfig as RefConfig

    corpus = _corpus(tmp_path)
    files = [str(p) for p in corpus.values()]
    docs = []
    for cls, cfg_cls, app, sub in ((GrepService, JobConfig, PORT_GREP, "p"),
                                   (RefService, RefConfig, REF_GREP, "r")):
        svc = cls(work_root=tmp_path / sub, spans=True, task_timeout_s=5.0,
                  sweep_interval_s=0.1)
        try:
            svc.start_local_workers(1)
            jid = svc.submit(cfg_cls(
                input_files=files, application=app, n_reduce=2,
                app_options={"pattern": "lava", "backend": "cpu"}))
            assert svc.wait_job(jid, timeout=60)
            docs.append(svc.job_explain(jid))
        finally:
            svc.stop()

    def shape(doc):
        modes = {m: {k: v for k, v in row.items() if k != "seconds"}
                 for m, row in doc["routing"]["engine_modes"].items()}
        return (doc["routing"]["route"], modes, doc["tasks"], doc["query"],
                doc["state"], sorted(doc["timing"]), doc["spans"])

    assert shape(docs[0]) == shape(docs[1])
    assert docs[0]["routing"]["route"] == "host"


def test_a_fused_tenants_route_is_its_unions(tmp_path, monkeypatch):
    """Three pattern tenants fused by the daemon's planner (spans on): the
    tenant whose assignment carried a split reports the union's kernel
    family (``nfa``) and route "device"; the per-query host confirms of
    the union's candidates record no scan of their own (ops/fuse.py), as
    a solo scan's host confirm records none."""
    monkeypatch.setenv("DGREP_DEVICE_MIN_BYTES", "0")
    monkeypatch.setenv("DGREP_RESULT_CACHE", "0")
    files = []
    for i in range(2):
        p = tmp_path / f"c{i}.txt"
        p.write_bytes(b"".join(b"the new %d volcano\n" % j if j % 5 == 0
                               else b"x %d Volcano\n" % j
                               for j in range(4000)))
        files.append(str(p))
    svc = GrepService(work_root=tmp_path / "svc", spans=True)
    small = {"target_lanes": 64, "min_chunk": 32, "segment_bytes": 4096}
    try:
        jids = [svc.submit(JobConfig(
            input_files=files, n_reduce=2, application=PORT_GREP,
            app_options={**o, "device": "cpu", **small}))
            for o in ({"pattern": "volcano"},
                      {"pattern": "Volcano", "ignore_case": True},
                      {"pattern": "^the (old|new) "})]
        svc.start_local_workers(1)
        for j in jids:
            assert svc.wait_job(j, timeout=120)
        assert svc.status()["fusion"]["fused_dispatches"] == 2
        docs = [svc.job_explain(j)["routing"] for j in jids]
        scanned = [d for d in docs if d["engine_modes"]]
        assert scanned and all(
            d["route"] == "device" and set(d["engine_modes"]) == {"nfa"}
            for d in scanned)
        assert sum(d["engine_modes"]["nfa"]["scans"] for d in scanned) == 2
        assert all(d["fusion"]["fused_plans"] == 2 for d in docs)
    finally:
        svc.stop()
