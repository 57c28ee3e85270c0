"""The port's shard index (distributed_grep_tpu_torch/index) held to the
reference's (distributed_grep_tpu/index): the summaries bit for bit (the
library pass and its numpy leg, every DGREP_INDEX_SUMMARY_BYTES clamp),
the required literals of the reference test's eligible and ineligible
queries, stores written by one package read and pruned by the other
(same ``.tgs`` names and bytes, stat drift evicts), a soundness fuzz,
and indexed against DGREP_INDEX=0 scans and jobs byte for byte, the jobs
also against the reference's job with the same ``index_dir``.

The ``cuda`` test at the end needs the card and skips without one; the
reference's engine and apps (which import jax) are imported inside the
tests that run them, so this file also loads where jax is absent:

    python -m pytest tests/test_torch_index.py -m cuda -q --noconftest
"""

from __future__ import annotations

import builtins
import json
import os
import re
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from distributed_grep_tpu.index import plan as ref_plan
from distributed_grep_tpu.index import summary as ref_summary
from distributed_grep_tpu.index.store import IndexStore as RefStore
from distributed_grep_tpu_torch.index import plan as index_plan
from distributed_grep_tpu_torch.index import summary as index_summary
from distributed_grep_tpu_torch.index.store import IndexStore
from distributed_grep_tpu_torch.ops import engine as engine_mod
from distributed_grep_tpu_torch.ops import layout
from distributed_grep_tpu_torch.ops.engine import GrepEngine
from distributed_grep_tpu_torch.runtime.job import plan_map_splits, run_job
from distributed_grep_tpu_torch.utils.config import JobConfig

# the tiny layout of the port's CPU tests (tests/test_torch_job.py)
ENGINE_OPTS = {"target_lanes": 64, "min_chunk": 32, "segment_bytes": 4096}


@pytest.fixture(autouse=True)
def _fresh_tiers():
    for clear in (index_summary.clear, ref_summary.clear,
                  layout.corpus_cache_clear, engine_mod.model_cache_clear):
        clear()
    yield
    for clear in (index_summary.clear, ref_summary.clear,
                  layout.corpus_cache_clear, engine_mod.model_cache_clear):
        clear()


def _text(seed: int, n: int) -> bytes:
    """Seeded bytes of mixed case, spaces, newlines, NUL and 0xFF."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"abcdeABCDE  \n\x00\xffxyzXYZ", np.uint8)
    return rng.choice(alphabet, size=n).tobytes()


def _corpus_bytes() -> bytes:
    rng = np.random.default_rng(13)
    words = ["hello", "hallo", "helloo", "volcano", "needle", "ab", "zz",
             "q", "the", "quick", "brown", "fox", "of", "and"]
    out = [" ".join(words[int(j)] for j in rng.integers(0, len(words),
                                                         rng.integers(1, 8)))
           .encode() for _ in range(400)]
    return b"\n".join(out) + b"\n"


def _fdr_patterns() -> list[str]:
    rng = np.random.default_rng(3)
    pats = {"hello", "volcano", "needle"}
    while len(pats) < 50:
        k = int(rng.integers(4, 9))
        pats.add("".join(chr(c) for c in rng.integers(97, 123, size=k)))
    return sorted(pats)


# the reference test's five families (tests/test_index.py ENGINES)
ENGINES = [
    ("shift_and", dict(pattern="hello")),
    ("nfa", dict(pattern="h[ae]llo+")),
    ("pairset", dict(patterns=["ab", "zz", "q"])),  # not eligible
    ("dfa_filter", dict(pattern="hello$")),
    ("fdr", dict(patterns=_fdr_patterns())),
]


# ----------------------------------------------------------- the summary

@pytest.mark.parametrize("n", [0, 2, 3, 5000, 70000])
@pytest.mark.parametrize("env", [None, "1", "5000", "65536", str(1 << 30)])
def test_summary_bit_identical_to_reference(n, env, monkeypatch):
    """Both legs of the port against both legs of the reference, at every
    clamp of DGREP_INDEX_SUMMARY_BYTES."""
    from distributed_grep_tpu.utils import native as ref_native

    if env is None:
        monkeypatch.delenv("DGREP_INDEX_SUMMARY_BYTES", raising=False)
    else:
        monkeypatch.setenv("DGREP_INDEX_SUMMARY_BYTES", env)
    assert index_summary.env_summary_bytes() == ref_summary.env_summary_bytes()
    data = _text(n, n)
    want = ref_summary.build_summary(data)
    monkeypatch.setattr(ref_native, "trigram_summary_into",
                        lambda d, b: False)
    assert ref_summary.build_summary(data) == want  # its numpy leg
    assert index_summary.build_summary(data) == want
    assert index_summary.build_summary(data, plain=True) == want
    assert len(want) == index_summary.env_summary_bytes()


@pytest.mark.parametrize("raw", ["", "notanint", "-5", "1023", "1024",
                                 "3000", "16384", "1048577"])
def test_env_knobs_parse_as_the_reference(raw, monkeypatch):
    for name in ("DGREP_INDEX_SUMMARY_BYTES", "DGREP_INDEX"):
        monkeypatch.setenv(name, raw)
    assert index_summary.env_summary_bytes() == ref_summary.env_summary_bytes()
    assert index_summary.env_index_enabled() == ref_summary.env_index_enabled()


# ---------------------------------------------------------- query side

# the reference test's parametrisations (tests/test_index.py:160-179)
ELIGIBLE = [
    ("needle", {}), ("(volcano|needle)", {}), ("err[0-9]+ors", {}),
    (r"\berror\b", {}), ("hello$", {}), ("^needle", {}),
    ("[[:digit:]]+needle", {}), ("a{3,}", {}),
    ("NEEDLE", {"ignore_case": True}),
]
INELIGIBLE = [
    ("", {}), ("a*", {}), ("x?y?z?", {}), ("ab", {}), ("(foo|ab)", {}),
    ("needle", {"max_errors": 1}), ("[0-9]+", {}),
]


@pytest.mark.parametrize("pat,kw", ELIGIBLE + INELIGIBLE)
def test_requirements_equal_the_reference(pat, kw):
    want = ref_plan.requirements_for_query(pattern=pat, **kw)
    got = index_plan.requirements_for_query(pattern=pat, **kw)
    assert (got is None) == (want is None) == ((pat, kw) in INELIGIBLE)
    if want is not None:
        assert got.literals == want.literals
        for a, b in zip(got.alternatives, want.alternatives):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("pats", [["volcano", "needle"], ["volcano", "ab"],
                                  [], ["abc"] * 65, [b"caf\xc3\xa9", "x\xffy"]])
def test_set_requirements_equal_the_reference(pats):
    want = ref_plan.requirements_for_query(patterns=pats)
    got = index_plan.requirements_for_query(patterns=pats)
    assert (got is None) == (want is None)
    if want is not None:
        assert got.literals == want.literals


def _rand_query(rng) -> str:
    atoms = ["abc", "bca", "cab", "[ab]", "a+", "(ab|cd)", "c{2,}", "d.e",
             "^ab", "cd$", "e?", "abcd", "(abc|bcd)e"]
    return "".join(atoms[int(i)] for i in rng.integers(0, len(atoms),
                                                       rng.integers(1, 4)))


def test_prune_is_sound_fuzz():
    """Where the port's index says "cannot match", no line matches (re
    is the oracle), and the verdict is the reference's."""
    rng = np.random.default_rng(42)
    pruned = 0
    for _ in range(300):
        n = int(rng.integers(10, 600))
        corpus = bytes(rng.choice(np.frombuffer(b"abcdeABC \n", np.uint8),
                                  size=n))
        s = index_summary.build_summary(corpus, summary_bytes=1024)
        assert s == ref_summary.build_summary(corpus, summary_bytes=1024)
        q = _rand_query(rng)
        ic = bool(rng.integers(0, 2))
        req = index_plan.requirements_for_query(pattern=q, ignore_case=ic)
        ref_req = ref_plan.requirements_for_query(pattern=q, ignore_case=ic)
        assert (req is None) == (ref_req is None)
        if req is None:
            continue
        assert req.may_match(s) == ref_req.may_match(s)
        if not req.may_match(s):
            pruned += 1
            rx = re.compile(q.encode(), re.IGNORECASE if ic else 0)
            assert not any(rx.search(line) for line in corpus.split(b"\n")), (
                q, corpus)
    assert pruned > 20  # the fuzz exercised the prune


# --------------------------------------------------------------- stores

def _files(tmp_path, n=6, needle_at=2) -> list[str]:
    out = []
    for i in range(n):
        p = tmp_path / "in" / f"f{i}.txt"
        p.parent.mkdir(exist_ok=True)
        body = b"plain filler line\n" * 30
        if i == needle_at:
            body += b"one needle line\n"
        p.write_bytes(body)
        out.append(str(p))
    return out


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_store_read_across_packages(writer, tmp_path):
    """A store one package writes has the other's names and bytes, and
    the other prunes the same files by it."""
    paths = _files(tmp_path)
    dirs = {"reference": tmp_path / "ref", "port": tmp_path / "port"}
    for f in paths:
        data = Path(f).read_bytes()
        RefStore(dirs["reference"]).save(
            ref_summary.file_key(f), ref_summary.build_summary(data))
        IndexStore(dirs["port"]).save(
            index_summary.file_key(f), index_summary.build_summary(data))
    names = {d: sorted(p.name for p in dirs[d].iterdir()) for d in dirs}
    assert names["reference"] == names["port"] and len(names["port"]) == 6
    for name in names["port"]:
        assert ((dirs["reference"] / name).read_bytes()
                == (dirs["port"] / name).read_bytes())
    store = dirs[writer]
    port = index_plan.SplitPruner(
        index_plan.requirements_for_query(pattern="needle"),
        IndexStore(store))
    ref = ref_plan.SplitPruner(ref_plan.requirements_for_query(
        pattern="needle"), RefStore(store))
    assert ([f for f in paths if port.prune(f)]
            == [f for f in paths if ref.prune(f)]
            == [f for i, f in enumerate(paths) if i != 2])
    assert (port.shards_pruned, port.maybe_scans, port.bytes_skipped) == (
        ref.shards_pruned, ref.maybe_scans, ref.bytes_skipped)


def test_store_stat_drift_evicts_the_other_packages_record(tmp_path):
    p = tmp_path / "f.txt"
    p.write_bytes(b"some corpus bytes here\n")
    RefStore(tmp_path / "idx").save(ref_summary.file_key(p),
                                    ref_summary.build_summary(p.read_bytes()))
    store = IndexStore(tmp_path / "idx")
    key = index_summary.file_key(p)
    assert store.load(key) == index_summary.build_summary(p.read_bytes())
    time.sleep(0.01)
    p.write_bytes(b"different corpus bytes\n")
    assert store.load(index_summary.file_key(p)) is None
    assert not list((tmp_path / "idx").glob("*.tgs"))  # deleted


# ---------------------------------------------------- engine and planner

def _spy_opens(monkeypatch) -> list:
    opened: list = []
    real_open = builtins.open

    def spy(f, *a, **k):
        opened.append(os.fspath(f) if not isinstance(f, int) else f)
        return real_open(f, *a, **k)

    monkeypatch.setattr(builtins, "open", spy)
    return opened


def _engine(**kw) -> GrepEngine:
    return GrepEngine(device="cpu", **ENGINE_OPTS, **kw)


def test_scan_file_pruned_shard_is_never_opened(tmp_path, monkeypatch):
    index_summary.attach_store(tmp_path / "idx")
    p = tmp_path / "shard.txt"
    p.write_bytes(b"nothing of note\nplain filler text\n" * 200)
    eng = _engine(pattern="needle")
    assert eng.scan_file(p).n_matches == 0  # builds and publishes
    opened = _spy_opens(monkeypatch)
    scans: list = []
    orig = GrepEngine._scan_impl
    monkeypatch.setattr(GrepEngine, "_scan_impl", lambda self, *a, **k: (
        scans.append(1), orig(self, *a, **k))[1])
    res = eng.scan_file(p)
    assert res.n_matches == 0 and res.matched_lines.size == 0
    assert str(p) not in [str(x) for x in opened] and not scans
    assert eng.stats["index_shards_pruned"] == 1
    assert eng.stats["index_bytes_skipped"] == p.stat().st_size
    assert eng.stats["file_reads"] == 0


def test_one_shot_engine_builds_nothing(tmp_path):
    """No store and no corpus cache: nothing is built."""
    p = tmp_path / "shard.txt"
    p.write_bytes(b"plain filler\n" * 50)
    eng = _engine(pattern="needle")
    eng.scan_file(p)
    eng.scan_batch([("a", str(p))], index_prune=True)
    assert index_summary.index_counters().get("index_summaries_built", 0) == 0
    assert not index_summary.may_route()


def test_scan_file_maybe_still_scans(tmp_path):
    index_summary.attach_store(tmp_path / "idx")
    p = tmp_path / "shard.txt"
    p.write_bytes(b"the needle is here\nplain filler\n" * 50)
    eng = _engine(pattern="needle")
    assert eng.scan_file(p).n_matches == 50
    assert eng.scan_file(p).n_matches == 50
    assert eng.stats["index_maybe_scans"] == 1
    assert not eng.stats.get("index_shards_pruned")


@pytest.mark.parametrize("label,kw", ENGINES)
def test_indexed_vs_off_scan_file(label, kw, tmp_path, monkeypatch):
    """Every family: the lines with the index warm equal DGREP_INDEX=0's
    and the reference's, on a corpus the query matches and one it
    cannot."""
    hit = tmp_path / "hit.txt"
    hit.write_bytes(_corpus_bytes())
    miss = tmp_path / "miss.txt"
    miss.write_bytes(b"xyzzy plugh 12345\n" * 300)
    results = {}
    for mode in ("off", "indexed"):
        if mode == "off":
            monkeypatch.setenv("DGREP_INDEX", "0")
        else:
            monkeypatch.delenv("DGREP_INDEX", raising=False)
        index_summary.clear()
        index_summary.attach_store(tmp_path / f"idx-{mode}")
        eng = _engine(**kw)
        per = {}
        for p in (hit, miss):
            a = eng.scan_file(p)
            b = eng.scan_file(p)  # the warm pass, pruned where it can be
            assert a.matched_lines.tolist() == b.matched_lines.tolist()
            per[p.name] = a.matched_lines.tolist()
        results[mode] = per
    assert results["off"] == results["indexed"], label
    eligible = index_plan.requirements_for_query(**kw) is not None
    assert bool(index_summary.index_counters().get(
        "index_shards_pruned")) == eligible
    from distributed_grep_tpu.ops.engine import GrepEngine as RefEngine

    ref = RefEngine(backend="cpu", **kw)
    for p in (hit, miss):
        assert ref.scan_file(p).matched_lines.tolist() == \
            results["indexed"][p.name]


def test_scan_batch_pruned_members_are_never_opened(tmp_path, monkeypatch):
    index_summary.attach_store(tmp_path / "idx")
    paths = _files(tmp_path)
    eng = _engine(pattern="needle")
    items = [(Path(p).name, p) for p in paths]
    first = eng.scan_batch(items, index_prune=True)
    assert [r.n_matches for _, r in first] == [0, 0, 1, 0, 0, 0]
    opened = _spy_opens(monkeypatch)
    warm = eng.scan_batch(items, index_prune=True)
    assert [(n, r.matched_lines.tolist()) for n, r in warm] == \
        [(n, r.matched_lines.tolist()) for n, r in first]
    assert {os.path.basename(str(x)) for x in opened} <= {"f2.txt"}
    assert eng.stats["index_shards_pruned"] == 5
    assert eng.stats["file_reads"] == 1


def test_scan_batch_invert_keeps_reads_exact(tmp_path, monkeypatch):
    """grep -v: the app passes index_prune=False, so every member is read
    and the records equal DGREP_INDEX=0's and the reference's."""
    from distributed_grep_tpu.apps import grep_tpu as ref_app
    from distributed_grep_tpu_torch.apps import grep_cuda
    from tests.conftest import expand_records

    paths = []
    for i in range(3):
        p = tmp_path / f"f{i}.txt"
        p.write_bytes(b"alpha\nbeta\n" + (b"needle\n" if i == 1 else b""))
        paths.append(p)
    items = [(p.name, str(p)) for p in paths]

    def records(index_on: bool):
        if index_on:
            monkeypatch.delenv("DGREP_INDEX", raising=False)
        else:
            monkeypatch.setenv("DGREP_INDEX", "0")
        index_summary.clear()
        monkeypatch.setattr(grep_cuda, "_configured_with", None)
        grep_cuda.configure(pattern="needle", device="cpu", invert=True,
                            index_dir=str(tmp_path / "idx"), **ENGINE_OPTS)
        out = []
        for _ in range(2):  # cold, then warm
            out = [kv for r in grep_cuda.map_batch_fn(list(items))
                   for kv in r.to_keyvalues()]
        return sorted((kv.key, kv.value) for kv in out)

    got = records(True)
    assert got == records(False)
    ref_app._configured_with = None
    ref_app.configure(pattern="needle", backend="cpu", invert=True)
    want = expand_records(ref_app.map_batch_fn(
        [(p.name, p.read_bytes()) for p in paths]))
    assert got == sorted((kv.key, kv.value) for kv in want)


def test_warm_window_prunes_whole(tmp_path):
    """With the corpus cache on, a packed window publishes its own summary
    and a warm call whose query it rules out scans nothing."""
    paths = _files(tmp_path, n=4, needle_at=-1)
    items = [(Path(p).name, p) for p in paths]
    cold = _engine(pattern="plain", corpus_bytes=1 << 26)
    assert sum(r.n_matches for _, r in cold.scan_batch(items)) == 120
    assert cold.stats["batch_dispatches"] == 1
    eng = _engine(pattern="needle", corpus_bytes=1 << 26)
    res = eng.scan_batch(items, index_prune=True)
    assert all(r.n_matches == 0 for _, r in res)
    assert [r.bytes_scanned for _, r in res] == [
        os.path.getsize(p) for p in paths]  # the cached member bytes
    assert eng.stats["batch_dispatches"] == 0
    assert eng.stats["file_reads"] == 0
    assert eng.stats["index_shards_pruned"] == 1


def test_stat_drift_never_prunes_stale(tmp_path):
    """Same size and mtime, a new inode holding the needle: a miss."""
    index_summary.attach_store(tmp_path / "idx")
    p = tmp_path / "shard.txt"
    old = b"plain filler text here\n" * 40
    p.write_bytes(old)
    eng = _engine(pattern="needle")
    assert eng.scan_file(p).n_matches == 0
    assert eng.scan_file(p).n_matches == 0
    assert eng.stats["index_shards_pruned"] == 1
    st = p.stat()
    new = b"plain filler text here\n" * 39 + b"x needle yz\n".ljust(23, b"!")
    repl = tmp_path / "shard.txt.new"
    repl.write_bytes(new)
    os.utime(repl, ns=(st.st_atime_ns, st.st_mtime_ns))
    os.replace(repl, p)
    assert eng.scan_file(p).n_matches == 1


def test_plan_map_splits_prunes_files(tmp_path):
    from distributed_grep_tpu.runtime.job import plan_map_splits as ref_plan_

    paths = _files(tmp_path)
    for f in paths:
        data = Path(f).read_bytes()
        index_summary.publish_summary(index_summary.file_key(f), data)
        ref_summary.publish_summary(ref_summary.file_key(f), data)
    pruner = index_plan.SplitPruner(
        index_plan.requirements_for_query(pattern="needle"),
        IndexStore(tmp_path / "idx"))
    splits = plan_map_splits(paths, batch_bytes=32 << 20, pruner=pruner)
    ref_pruner = ref_plan.SplitPruner(
        ref_plan.requirements_for_query(pattern="needle"),
        RefStore(tmp_path / "idx"))
    assert splits == ref_plan_(paths, batch_bytes=32 << 20,
                               pruner=ref_pruner) == [paths[2]]
    assert (pruner.shards_pruned, pruner.maybe_scans) == (5, 1)
    index_summary.clear()
    again = index_plan.SplitPruner(pruner.requirements,
                                   IndexStore(tmp_path / "idx"))
    assert plan_map_splits(paths, 32 << 20, pruner=again) == [paths]


def test_pruner_for_job_gating_names_grep_cuda(tmp_path, monkeypatch):
    """C1: the port's planner prunes for a grep_cuda job, with the
    reference's gates."""
    def cfg(**opts):
        return JobConfig(input_files=["x"], app_options={
            "pattern": "needle", "device": "cpu", **opts})

    assert cfg().application == index_plan.GREP_APPLICATION
    (tmp_path / "idx").mkdir()
    assert index_plan.pruner_for_job(cfg(), tmp_path / "idx") is not None
    for opts in ({"invert": True}, {"count_only": True},
                 {"presence_only": True}, {"max_errors": 1},
                 {"pattern": "ab"}):
        assert index_plan.pruner_for_job(cfg(**opts), tmp_path / "idx") is None
    host = JobConfig(input_files=["x"],
                     application="distributed_grep_tpu_torch.apps.grep",
                     app_options={"pattern": "needle"})
    assert index_plan.pruner_for_job(host, tmp_path / "idx") is None
    assert index_plan.pruner_for_job(cfg(), tmp_path / "none") is None
    monkeypatch.setenv("DGREP_INDEX", "0")
    assert index_plan.pruner_for_job(cfg(), tmp_path / "idx") is None


# ---------------------------------------------------------------- jobs

@pytest.mark.parametrize("opts", [{"pattern": "needle"},
                                  {"patterns": ["needle", "volcano"]},
                                  {"pattern": "needle", "count_only": True},
                                  {"pattern": "needle", "invert": True}])
def test_job_with_index_dir_equals_the_reference(opts, tmp_path, monkeypatch):
    """run_job with ``index_dir``, cold and warm, against the same job with
    DGREP_INDEX=0 and the reference's job with its ``index_dir``: the
    mr-out bytes; the warm job's map attempts ship their prunes."""
    from distributed_grep_tpu.runtime.job import run_job as ref_run_job
    from distributed_grep_tpu.utils.config import JobConfig as RefJobConfig

    paths = _files(tmp_path, n=8, needle_at=3)
    paths.append(str(tmp_path / "big.txt"))
    Path(paths[-1]).write_bytes(b"a needle here\n" + b"filler\n" * 3000)

    def port(name, index_dir):
        res = run_job(JobConfig(
            input_files=paths, batch_bytes=4096, n_reduce=3,
            app_options={**opts, **ENGINE_OPTS, "index_dir": index_dir,
                         "device_min_bytes": 1 << 12},
            work_dir=str(tmp_path / name)), n_workers=2, device="cpu")
        return ({Path(p).name: Path(p).read_bytes()
                 for p in res.output_files}, res.metrics["counters"])

    cold, _ = port("cold", str(tmp_path / "idx"))
    warm, counters = port("warm", str(tmp_path / "idx"))
    monkeypatch.setenv("DGREP_INDEX", "0")
    off, off_counters = port("off", str(tmp_path / "idx-off"))
    monkeypatch.delenv("DGREP_INDEX")
    assert cold == warm == off
    assert not any(k.startswith("index_") for k in off_counters)
    if opts.get("invert"):
        assert "index_shards_pruned" not in counters  # -v reads them all
    else:
        assert counters["index_shards_pruned"] == 7
        assert counters["index_maybe_scans"] == 2
    # -v reads a split of one file (the large one, and f7) whole through
    # map_fn, which publishes no summary, as the reference's does
    assert len(list((tmp_path / "idx").glob("*.tgs"))) == (
        7 if opts.get("invert") else 9)
    ref_opts = {**opts, "backend": "cpu",
                "index_dir": str(tmp_path / "ref-idx")}
    for name in ("ref-cold", "ref-warm"):
        ref = ref_run_job(RefJobConfig(
            input_files=paths, n_reduce=3, batch_bytes=4096,
            application="distributed_grep_tpu.apps.grep_tpu",
            app_options=ref_opts, work_dir=str(tmp_path / name)),
            n_workers=2)
        assert {Path(p).name: Path(p).read_bytes()
                for p in ref.output_files} == cold
    # the same summaries, under the same names
    assert sorted(p.name for p in (tmp_path / "ref-idx").glob("*.tgs")) == \
        sorted(p.name for p in (tmp_path / "idx").glob("*.tgs"))


def test_status_prints_the_index_lines(monkeypatch, capsys):
    import argparse

    from distributed_grep_tpu_torch import __main__ as cli
    from distributed_grep_tpu_torch.runtime import http_transport

    answer = {"done": False, "counters": {"map_assigned": 2}}
    monkeypatch.setattr(http_transport, "client_call",
                        lambda *a, **k: json.loads(json.dumps(answer)))
    args = argparse.Namespace(addr="127.0.0.1:1", timeout=1.0)
    assert cli.cmd_status(args) == 0
    assert "index_shards_pruned" not in json.loads(capsys.readouterr().out)
    answer["counters"].update(index_shards_pruned=3, index_bytes_skipped=90)
    assert cli.cmd_status(args) == 0
    out = json.loads(capsys.readouterr().out)
    assert (out["index_shards_pruned"], out["index_bytes_skipped"]) == (3, 90)


def test_grep_cuda_index_dir_attaches_and_detaches(tmp_path):
    from distributed_grep_tpu_torch.apps import grep_cuda

    grep_cuda._configured_with = None
    grep_cuda.configure("needle", device="cpu", index_dir=str(tmp_path))
    assert index_summary.attached_store().root == tmp_path
    grep_cuda.configure("needle", device="cpu")  # the same engine config
    assert index_summary.attached_store() is None
    assert "index_dir" not in grep_cuda._UNPORTED


# ------------------------------------------------------------- the card

@pytest.mark.cuda
def test_warm_indexed_batch_uploads_only_unpruned_members(tmp_path,
                                                          monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    from distributed_grep_tpu_torch.ops import device_scan

    monkeypatch.setenv("DGREP_DEVICE_MIN_BYTES", "0")
    monkeypatch.setenv("DGREP_CORPUS_BYTES", "0")
    index_summary.attach_store(tmp_path / "idx")
    paths = _files(tmp_path, n=6, needle_at=2)
    items = [(Path(p).name, p) for p in paths]
    outs = {}
    for device in ("cuda", "cpu"):
        eng = GrepEngine("needle", device=device, batch_bytes=0,
                         target_lanes=4096, min_chunk=32,
                         segment_bytes=1 << 18)
        cold = eng.scan_batch(items, index_prune=True)
        before = device_scan.kernel_launches()
        warm = eng.scan_batch(items, index_prune=True)
        launched = {k: v - before[k]
                    for k, v in device_scan.kernel_launches().items()}
        outs[device] = [(n, r.matched_lines.tolist()) for n, r in warm]
        assert outs[device] == [(n, r.matched_lines.tolist())
                                for n, r in cold]
        if device == "cuda":
            assert eng.stats["uploads"] == 1  # the one member that can match
            assert launched["shift_and"] >= 1
            assert eng.stats["file_reads"] == 1
    assert outs["cuda"] == outs["cpu"]
