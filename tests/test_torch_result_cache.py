"""The port's result cache (distributed_grep_tpu_torch/runtime/
result_cache.py and the service's result tier) held to the reference's
(distributed_grep_tpu/runtime/result_cache.py, tests/test_result_cache.py's
cases).

The reference's daemon runs ``distributed_grep_tpu.apps.grep_tpu`` with
``backend: cpu``, the port's ``grep_cuda`` with ``device: cpu``, over the
same files.  The tolerance is zero: each job's records (its outputs'
lines, collated, since a hit's output files are laid out as stored blobs)
are equal, hit, partial hit and miss alike, and equal to a cold job's with
the cache off.  The ``cuda`` test at the end needs the card and skips
without one.
"""

from __future__ import annotations

import os
import time
from pathlib import Path

import pytest
import torch

from distributed_grep_tpu_torch.index import summary as index_summary
from distributed_grep_tpu_torch.ops import engine as engine_mod
from distributed_grep_tpu_torch.ops import layout
from distributed_grep_tpu_torch.runtime import result_cache
from distributed_grep_tpu_torch.runtime.result_cache import (
    ResultKey,
    ResultStore,
    result_key,
)
from distributed_grep_tpu_torch.runtime.service import GrepService
from distributed_grep_tpu_torch.utils import metrics as metrics_mod
from distributed_grep_tpu_torch.utils.config import JobConfig

PORT_GREP = "distributed_grep_tpu_torch.apps.grep_cuda"
REF_GREP = "distributed_grep_tpu.apps.grep_tpu"


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.delenv("DGREP_RESULT_CACHE", raising=False)
    monkeypatch.delenv("DGREP_RESULT_BYTES", raising=False)
    monkeypatch.setenv("DGREP_PEER_SHUFFLE", "0")
    monkeypatch.setenv("DGREP_NO_CALIBRATE", "1")
    for clear in (engine_mod.model_cache_clear, layout.corpus_cache_clear,
                  index_summary.clear, metrics_mod.metrics_reset):
        clear()
    yield
    for clear in (engine_mod.model_cache_clear, layout.corpus_cache_clear,
                  index_summary.clear):
        clear()


@pytest.fixture()
def files(tmp_path):
    """Three seeded files of word lines, each with matches (a file with
    none would be index-pruned from a resubmit's plan)."""
    import numpy as np

    rng = np.random.default_rng(19)
    words = ["hello", "world", "fox", "volcano", "the", "HELLO", "again"]
    root = tmp_path / "data"
    root.mkdir()
    out = {}
    for name in ("a.txt", "b.txt", "c.txt"):
        lines = [" ".join(words[i] for i in rng.integers(0, len(words), 5))
                 for _ in range(300)]
        p = root / name
        p.write_text("\n".join(lines) + "\nlast hello\n")
        out[name] = p
    return out


def _port_cfg(files, pattern="hello", **opts):
    return JobConfig(input_files=[str(p) for p in files.values()],
                     application=PORT_GREP,
                     app_options={"pattern": pattern, "device": "cpu",
                                  **opts}, n_reduce=3)


def _ref_cfg(files, pattern="hello", **opts):
    from distributed_grep_tpu.utils.config import JobConfig as RefConfig

    return RefConfig(input_files=[str(p) for p in files.values()],
                     application=REF_GREP,
                     app_options={"pattern": pattern, "backend": "cpu",
                                  **opts}, n_reduce=3)


def _collate(paths) -> list[bytes]:
    lines = []
    for p in paths:
        lines.extend(ln for ln in Path(p).read_bytes().splitlines(
            keepends=True) if ln.strip())
    return sorted(lines)


def _service(work_root, cls=GrepService, **kw):
    kw.setdefault("task_timeout_s", 10.0)
    kw.setdefault("sweep_interval_s", 0.1)
    return cls(work_root=work_root, **kw)


def _run(svc, config, timeout=60):
    jid = svc.submit(config)
    assert svc.wait_job(jid, timeout=timeout), svc.job_status(jid)
    res = svc.job_result(jid)
    assert res["state"] == "done", res
    return jid, res


def _ref_service(work_root, **kw):
    from distributed_grep_tpu.runtime.service import GrepService as RefService

    return _service(work_root, cls=RefService, **kw)


# --------------------------------------------------- hit / partial / miss

def test_hit_partial_miss_byte_identity_against_the_reference(tmp_path,
                                                              files):
    """Miss, full hit and partial hit on both daemons: equal records at
    each step, equal reuse counts, and the partial hit equals a cold job
    with the cache off.  A full hit runs no scheduler."""
    port = _service(tmp_path / "port")
    ref = _ref_service(tmp_path / "ref")
    port.start_local_workers(1)
    ref.start_local_workers(1)
    try:
        steps = []
        for step in ("miss", "hit", "partial"):
            if step == "partial":
                with open(files["a.txt"], "a") as f:
                    f.write("hello appended\n")
            jp, rp = _run(port, _port_cfg(files))
            jr, rr = _run(ref, _ref_cfg(files))
            assert _collate(rp["outputs"]) == _collate(rr["outputs"]), step
            recp, recr = port.record(jp), ref.record(jr)
            assert recp.result_splits_reused == recr.result_splits_reused
            assert recp.result_bytes_unscanned == recr.result_bytes_unscanned
            assert len(recp.map_splits) == len(recr.map_splits)
            steps.append((recp, rp))
        (m, _), (h, rh), (p, rpart) = steps
        assert m.result_splits_reused == 0 and len(m.map_splits) == 3
        assert h.scheduler is None and h.result_splits_reused == 3
        counters = rh["metrics"]["counters"]
        assert counters["result_splits_reused"] == 3
        assert port.job_status(h.job_id)["metrics"]["counters"][
            "result_splits_reused"] == 3
        assert len(p.map_splits) == 1 and p.result_splits_reused == 2
        assert b"appended" in b"".join(_collate(rpart["outputs"]))
        want = {k: v for k, v in ref.status()["result_cache"].items()}
        assert port.status()["result_cache"] == want
        metrics = port.metrics_text()
        assert "dgrep_result_hits_total 1" in metrics
        assert "dgrep_result_partial_hits_total 1" in metrics
    finally:
        port.stop()
        ref.stop()
    os.environ["DGREP_RESULT_CACHE"] = "0"
    try:
        cold = _service(tmp_path / "cold")
        cold.start_local_workers(1)
        try:
            _j, rc = _run(cold, _port_cfg(files))
        finally:
            cold.stop()
    finally:
        del os.environ["DGREP_RESULT_CACHE"]
    assert _collate(rc["outputs"]) == _collate(rpart["outputs"])


def _records(paths) -> list[bytes]:
    """The outputs' records, split at '\n' only (a matched line may hold
    a bare CR), sorted."""
    out = []
    for p in paths:
        out.extend(r + b"\n" for r in Path(p).read_bytes().split(b"\n") if r)
    return sorted(out)


def _cr_files(root: Path) -> dict:
    """ROADMAP.md C12's input: a.txt's first matched line holds a bare CR
    and, after it, bytes that parse as a record key of b.txt."""
    root.mkdir()
    b = root / "b.txt"
    b.write_bytes(b"x\n" * 3 + b"hello b\n")
    a = root / "a.txt"
    a.write_bytes(b"hello a\r" + str(b).encode()
                  + b" (line number #1)\tforged\n" + b"hello plain\n")
    return {"a.txt": a, "b.txt": b}


def test_c12_bare_cr_records_survive_full_and_partial_hits(tmp_path):
    """C12: the hit's and a partial hit's records equal the cold job's
    and a DGREP_RESULT_CACHE=0 job's; the record holding a bare CR stays
    whole and under its own file (the reference's bucket_records split it
    at the CR, R7)."""
    files = _cr_files(tmp_path / "data")
    a_key = str(files["a.txt"]).encode()
    svc = _service(tmp_path / "svc")
    svc.start_local_workers(1)
    try:
        cfg = _port_cfg(files)
        cfg.n_reduce = 1
        _j, cold = _run(svc, cfg)
        j2, hit = _run(svc, cfg)
        assert svc.record(j2).result_splits_reused == 2
        assert svc.record(j2).scheduler is None
        assert _records(hit["outputs"]) == _records(cold["outputs"])
        assert any(r.startswith(a_key + b" (line number #1)\thello a\r")
                   and r.endswith(b"forged\n")
                   for r in _records(hit["outputs"]))
        with open(files["b.txt"], "ab") as f:
            f.write(b"hello appended\n")
        j3, partial = _run(svc, cfg)
        assert svc.record(j3).result_splits_reused == 1
    finally:
        svc.stop()
    os.environ["DGREP_RESULT_CACHE"] = "0"
    try:
        off = _service(tmp_path / "off")
        off.start_local_workers(1)
        try:
            _j, want = _run(off, cfg)
        finally:
            off.stop()
    finally:
        del os.environ["DGREP_RESULT_CACHE"]
    assert _records(partial["outputs"]) == _records(want["outputs"])
    assert b"appended" in b"".join(_records(want["outputs"]))


def test_c12_a_bare_cr_file_resubmit_is_a_hit(tmp_path):
    """Bytes after the CR that parse as no key: the job still publishes
    (bucket_records no longer returns None), so the resubmit hits."""
    root = tmp_path / "data"
    root.mkdir()
    f = root / "cr.txt"
    f.write_bytes(b"hello a\rtail\nhello b\r\nnothing\n")
    svc = _service(tmp_path / "svc")
    svc.start_local_workers(1)
    try:
        cfg = _port_cfg({"cr.txt": f})
        _j, cold = _run(svc, cfg)
        j2, hit = _run(svc, cfg)
        assert svc.record(j2).result_splits_reused == 1
        assert _records(hit["outputs"]) == _records(cold["outputs"])
        assert len(_records(cold["outputs"])) == 2
    finally:
        svc.stop()


def test_full_hit_needs_no_worker_and_survives_a_restart(tmp_path, files):
    work_root = tmp_path / "svc"
    svc = _service(work_root)
    svc.start_local_workers(1)
    try:
        _j, r1 = _run(svc, _port_cfg(files))
    finally:
        svc.stop()
    assert (work_root / "results").exists()
    svc2 = _service(work_root)  # no worker attached
    try:
        jid, r2 = _run(svc2, _port_cfg(files), timeout=20)
        assert _collate(r2["outputs"]) == _collate(r1["outputs"])
        assert svc2.record(jid).scheduler is None
        assert not svc2.workers
    finally:
        svc2.stop()


def test_inode_drift_is_never_served(tmp_path, files):
    """A replacement with the same size and mtime and new bytes (cp -p and
    mv): the inode tells, only that split scans, on both daemons."""
    port = _service(tmp_path / "port")
    ref = _ref_service(tmp_path / "ref")
    port.start_local_workers(1)
    ref.start_local_workers(1)
    try:
        _run(port, _port_cfg(files))
        _run(ref, _ref_cfg(files))
        target = files["c.txt"]
        st = target.stat()
        clone = target.with_name("c.txt.new")
        clone.write_bytes(target.read_bytes().replace(b"hello", b"hullo"))
        os.utime(clone, ns=(st.st_atime_ns, st.st_mtime_ns))
        os.replace(clone, target)
        jp, rp = _run(port, _port_cfg(files))
        _jr, rr = _run(ref, _ref_cfg(files))
        assert len(port.record(jp).map_splits) == 1
        got = _collate(rp["outputs"])
        assert got == _collate(rr["outputs"])
        assert not any(b"c.txt" in ln and b"\thello" in ln for ln in got)
    finally:
        port.stop()
        ref.stop()


def test_publish_failure_degrades_to_a_partial_hit(tmp_path, files,
                                                   monkeypatch):
    saved = []
    orig = ResultStore.save

    def flaky_save(self, key, records):
        if saved:
            return False  # the publication died after one entry
        saved.append(key)
        return orig(self, key, records)

    monkeypatch.setattr(ResultStore, "save", flaky_save)
    svc = _service(tmp_path / "svc")
    svc.start_local_workers(1)
    try:
        _j, r1 = _run(svc, _port_cfg(files))
        monkeypatch.setattr(ResultStore, "save", orig)
        j2, r2 = _run(svc, _port_cfg(files))
        rec2 = svc.record(j2)
        assert rec2.result_splits_reused == 1
        assert len(rec2.map_splits) == 2
        assert _collate(r2["outputs"]) == _collate(r1["outputs"])
    finally:
        svc.stop()


def test_alias_named_submit_misses(tmp_path, files):
    """The same content through a symlinked directory misses: stored
    records carry the publishing job's spellings of its paths."""
    svc = _service(tmp_path / "svc")
    svc.start_local_workers(1)
    try:
        _run(svc, _port_cfg(files))
        alias = tmp_path / "alias"
        alias.symlink_to(files["a.txt"].parent)
        aliased = {n: alias / n for n in files}
        j2, r2 = _run(svc, _port_cfg(aliased))
        assert svc.record(j2).result_splits_reused == 0
        body = b"".join(_collate(r2["outputs"]))
        assert b"/alias/" in body and b"/data/" not in body
        j3, _r3 = _run(svc, _port_cfg(aliased))
        assert svc.record(j3).result_splits_reused == len(aliased)
    finally:
        svc.stop()


def test_full_hit_that_cannot_materialize_scans_and_counts_nothing(
        tmp_path, files, monkeypatch):
    svc = _service(tmp_path / "svc")
    svc.start_local_workers(1)
    try:
        _j1, r1 = _run(svc, _port_cfg(files))

        def boom(*_a):
            raise OSError("disk full")

        monkeypatch.setattr(GrepService, "_materialize_cached",
                            staticmethod(boom))
        j2, r2 = _run(svc, _port_cfg(files))
        rec2 = svc.record(j2)
        assert rec2.result_splits_reused == 0 and rec2.scheduler is not None
        assert _collate(r2["outputs"]) == _collate(r1["outputs"])
        assert "result_cache" not in svc.status()
    finally:
        svc.stop()


def test_status_shows_evictions_without_hits(tmp_path, corpus,
                                             monkeypatch):
    """Three entries of the small corpus against a 256-byte budget: the
    store evicts, and /status shows it though nothing hit."""
    monkeypatch.setenv("DGREP_RESULT_BYTES", "256")
    svc = _service(tmp_path / "svc")
    svc.start_local_workers(1)
    try:
        _run(svc, _port_cfg(corpus))
        st = svc.status()["result_cache"]
        assert st["result_lru_evictions"] >= 1
        assert "result_hits" not in st
    finally:
        svc.stop()


def test_disabled_tier_is_a_no_op(tmp_path, files, monkeypatch):
    monkeypatch.setenv("DGREP_RESULT_CACHE", "0")
    svc = _service(tmp_path / "svc")
    svc.start_local_workers(1)
    try:
        j1, _r1 = _run(svc, _port_cfg(files))
        j2, _r2 = _run(svc, _port_cfg(files))
        assert svc.record(j1).result_plan is None
        assert svc.record(j2).scheduler is not None
        assert not (tmp_path / "svc" / "results").exists()
        assert "result_cache" not in svc.status()
    finally:
        svc.stop()


def test_explain_of_a_hit_reports_the_reuse(tmp_path, files):
    """With spans on, a full hit's report says ``result:hit`` and the
    planner's reuse, and its route is "unknown" (nothing scanned), as the
    reference's; a partial hit's names the scanned mode."""
    port = _service(tmp_path / "port", spans=True)
    ref = _ref_service(tmp_path / "ref", spans=True)
    port.start_local_workers(1)
    ref.start_local_workers(1)
    try:
        docs = []
        for svc, cfg in ((port, _port_cfg), (ref, _ref_cfg)):
            _run(svc, cfg(files))
            jid, _ = _run(svc, cfg(files))
            docs.append(svc.job_explain(jid)["routing"])
        assert docs[0] == docs[1]
        assert docs[0]["route"] == "unknown"
        assert docs[0]["result_cache"]["planner_splits_reused"] == 3
        assert docs[0]["result_cache"]["hits"] == 1
    finally:
        port.stop()
        ref.stop()


# ------------------------------------------------------------- the store

def _ident_for(path: Path) -> tuple:
    st = path.stat()
    return ((os.path.realpath(path), st.st_size, st.st_mtime_ns,
             st.st_ino),)


def test_store_round_trip_and_stale_eviction(tmp_path):
    f = tmp_path / "x.txt"
    f.write_text("one\ntwo\n")
    store = ResultStore(tmp_path / "results")
    assert store.save(ResultKey(("q",), str(f), _ident_for(f)),
                      b"x.txt\x001\tone\n")
    assert store.load(ResultKey(("q",), str(f), _ident_for(f))) == \
        b"x.txt\x001\tone\n"
    g = tmp_path / "y.txt"
    g.write_text("nope\n")
    assert store.save(ResultKey(("q",), str(g), _ident_for(g)), b"")
    assert store.load(ResultKey(("q",), str(g), _ident_for(g))) == b""
    time.sleep(0.01)
    f.write_text("one\ntwo\nthree\n")
    fresh = ResultKey(("q",), str(f), _ident_for(f))
    assert store.load(fresh) is None
    assert store.stale_evictions == 1
    assert not store._path_for(fresh.identity).exists()


def test_store_file_names_equal_the_reference(tmp_path):
    """One key names one entry file in both packages (the hash of the same
    canonical identity), and a blob either stores loads in the other."""
    from distributed_grep_tpu.runtime import result_cache as ref_rc

    f = tmp_path / "x.txt"
    f.write_text("hit\n")
    ident = _ident_for(f)
    qkey = (("app", (("device", "cpu"),), 0), ("hit", None, False))
    port_store = ResultStore(tmp_path / "results")
    ref_store = ref_rc.ResultStore(tmp_path / "results")
    pk = ResultKey(qkey, str(f), ident)
    rk = ref_rc.ResultKey(qkey, str(f), ident)
    assert port_store._path_for(pk.identity) == ref_store._path_for(
        rk.identity)
    assert ref_store.save(rk, b"blob")
    assert port_store.load(pk) == b"blob"


def test_alias_given_names_are_distinct_entries(tmp_path):
    f = tmp_path / "real.txt"
    f.write_text("hit\n")
    link = tmp_path / "alias.txt"
    link.symlink_to(f)
    ident = _ident_for(f)
    assert _ident_for(link) == ident
    store = ResultStore(tmp_path / "results")
    assert store.save(ResultKey(("q",), str(f), ident), b"real-records")
    assert store.load(ResultKey(("q",), str(link), ident)) is None
    assert store.load(ResultKey(("q",), str(f), ident)) == b"real-records"


def test_bucket_records_equal_the_reference(tmp_path):
    from distributed_grep_tpu.runtime import result_cache as ref_rc

    out = tmp_path / "out-0"
    out.write_bytes(b"b.txt (line number #3)\tz\n"
                    b"a.txt (line number #10)\thit\n"
                    b"a.txt (line number #2)\tx\n")
    for splits in (["a.txt", "a.txt"], ["a.txt", "b.txt"],
                   [["a.txt", "b.txt"]], ["a.txt"]):
        assert result_cache.bucket_records([str(out)], splits) == \
            ref_rc.bucket_records([str(out)], splits)
    assert result_cache.bucket_records([str(out)], ["a.txt", "b.txt"]) == [
        b"a.txt (line number #2)\tx\na.txt (line number #10)\thit\n",
        b"b.txt (line number #3)\tz\n"]


def test_store_sweeps_torn_temp_files(tmp_path):
    root = tmp_path / "results"
    root.mkdir()
    torn = root / ".abc.res.123.456.tmp"
    torn.write_bytes(b"torn half-write")
    ResultStore(root)
    assert not torn.exists()


def test_store_lru_and_oversize_decline(tmp_path, monkeypatch):
    f = tmp_path / "x.txt"
    f.write_text("data\n")
    ident = _ident_for(f)
    store = ResultStore(tmp_path / "results")
    monkeypatch.setenv("DGREP_RESULT_BYTES", "4096")
    old = ResultKey(("old",), str(f), ident)
    assert store.save(old, b"a" * 1500)
    time.sleep(0.01)
    assert store.save(ResultKey(("mid",), str(f), ident), b"b" * 1500)
    time.sleep(0.01)
    assert store.save(ResultKey(("new",), str(f), ident), b"c" * 1500)
    assert store.load(old) is None
    assert store.lru_evictions >= 1
    before = sorted(p.name for p in (tmp_path / "results").glob("*.res"))
    assert not store.save(ResultKey(("huge",), str(f), ident), b"z" * 8192)
    assert before == sorted(p.name for p in
                            (tmp_path / "results").glob("*.res"))
    monkeypatch.setenv("DGREP_RESULT_BYTES", "0")
    assert not store.save(ResultKey(("off",), str(f), ident), b"x")


@pytest.mark.parametrize("opts,cached", [
    ({}, True), ({"invert": True}, False), ({"count_only": True}, False),
    ({"presence_only": True}, False), ({"max_errors": 1}, False),
    ({"ignore_case": True}, True), ({"pattern": ""}, False),
    ({"pattern": "(a)\\1"}, False),
])
def test_eligibility_gates_on_grep_cuda(files, opts, cached):
    """The port's ``grep_cuda`` jobs are eligible as the reference's
    ``grep_tpu`` jobs are, option for option; another application, a
    standing query and the reference's application name in the port are
    not."""
    from distributed_grep_tpu.runtime import result_cache as ref_rc

    assert (result_key(_port_cfg(files, **opts)) is not None) is cached
    assert (ref_rc.result_key(_ref_cfg(files, **opts)) is not None) is cached
    follow = _port_cfg(files, **opts)
    follow.follow = True
    assert result_key(follow) is None
    other = _port_cfg(files, **opts)
    other.application = REF_GREP
    assert result_key(other) is None


def test_env_knobs_parse_as_the_reference(monkeypatch):
    from distributed_grep_tpu.runtime import result_cache as ref_rc

    for raw in (None, "", "0", "false", "no", " NO ", "1", "yes"):
        if raw is None:
            monkeypatch.delenv("DGREP_RESULT_CACHE", raising=False)
        else:
            monkeypatch.setenv("DGREP_RESULT_CACHE", raw)
        assert result_cache.env_result_cache() == ref_rc.env_result_cache()
    for raw in (None, "1024", "-5", "zap", "0"):
        if raw is None:
            monkeypatch.delenv("DGREP_RESULT_BYTES", raising=False)
        else:
            monkeypatch.setenv("DGREP_RESULT_BYTES", raw)
        assert result_cache.env_result_bytes() == ref_rc.env_result_bytes()


# ------------------------------------------------------------- the card

@pytest.mark.cuda
def test_result_hit_on_card_launches_nothing(tmp_path, monkeypatch):
    """A job on the card (no device option) publishes; its resubmit is a
    full hit with no launch and the same records; an append rescans one
    split, with its launches (DGREP_DEVICE_MIN_BYTES=0)."""
    from distributed_grep_tpu_torch.ops import device_scan

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    monkeypatch.setenv("DGREP_DEVICE_MIN_BYTES", "0")
    files = {}
    for i in range(3):
        p = tmp_path / f"c{i}.txt"
        p.write_bytes(b"".join(b"line %d of %d volcano\n" % (j, i)
                               if j % 7 == 0 else b"filler %d\n" % j
                               for j in range(5000)))
        files[p.name] = p
    cfg = _port_cfg(files, pattern="volcano")
    cfg.app_options.pop("device")
    svc = _service(tmp_path / "svc", task_timeout_s=60.0)
    svc.start_local_workers(1)
    try:
        _j1, r1 = _run(svc, cfg, timeout=300)
        before = sum(device_scan.kernel_launches().values())
        j2, r2 = _run(svc, cfg)
        assert sum(device_scan.kernel_launches().values()) == before
        assert svc.record(j2).scheduler is None
        assert _collate(r2["outputs"]) == _collate(r1["outputs"])
        with open(files["c0.txt"], "ab") as f:
            f.write(b"appended volcano\n")
        j3, r3 = _run(svc, cfg, timeout=300)
        assert sum(device_scan.kernel_launches().values()) > before
        assert len(svc.record(j3).map_splits) == 1
        assert b"appended" in b"".join(_collate(r3["outputs"]))
    finally:
        svc.stop()
