"""The corpus cache of the port (ops/layout.CorpusCache) held to the
reference's cases (tests/test_corpus_cache.py): a warm ``scan_file`` /
``scan_batch`` / ``run_job`` over unchanged files reads no file and
uploads nothing, and is bit-identical to the cold scan and to the
reference (backend "cpu"); any change of size, mtime or inode is a miss;
entries evict least recently used under the byte budget; the counters
stamp only once nonzero; ``cached_engine`` shares engines.

On the CPU the budget is 0 unless asked for, so every test asks
(``corpus_bytes=``, DGREP_CORPUS_BYTES); the resident segments are then
CPU tensors.  The read point is ``builtins.open``, the upload point
``ops/layout.padded_stripes`` (the pad of a segment before its copy to
the card)."""

import builtins
import os
import weakref

import numpy as np
import pytest
import torch

from distributed_grep_tpu.ops.engine import GrepEngine as RefEngine
from distributed_grep_tpu_torch.ops import engine as engine_mod
from distributed_grep_tpu_torch.ops import layout
from distributed_grep_tpu_torch.ops.engine import GrepEngine, cached_engine
from distributed_grep_tpu_torch.runtime.job import run_job
from distributed_grep_tpu_torch.utils.config import JobConfig
from tests.test_torch_job import ENGINE_OPTS, _outputs

BUDGET = 1 << 28


@pytest.fixture(autouse=True)
def _fresh_caches():
    layout.corpus_cache_clear()
    engine_mod.model_cache_clear()
    yield
    layout.corpus_cache_clear()
    engine_mod.model_cache_clear()


def _corpus_bytes() -> bytes:
    rng = np.random.default_rng(13)
    words = ["hello", "hallo", "helloo", "volcano", "needle", "ab", "zz",
             "q", "the", "quick", "brown", "fox", "of", "and", "volcxno"]
    out = [" ".join(words[int(j)] for j in rng.integers(0, len(words),
                                                         rng.integers(1, 8)))
           .encode() for _ in range(600)]
    return b"\n".join(out) + b"\n"


def _fdr_patterns() -> list[str]:
    rng = np.random.default_rng(3)
    pats = {"hello", "volcano", "needle"}
    while len(pats) < 50:
        k = int(rng.integers(4, 9))
        pats.add("".join(chr(c) for c in rng.integers(97, 123, size=k)))
    return sorted(pats)


FAMILIES = [
    ("shift_and", {"pattern": "hello"}),
    ("nfa", {"pattern": "h[ae]llo+"}),
    ("pairset", {"patterns": ["ab", "zz", "q"]}),
    ("dfa_filter", {"pattern": "hello$"}),
    ("fdr", {"patterns": _fdr_patterns()}),
    ("approx", {"pattern": "volcano", "max_errors": 1}),
]


def _engine(opts, **kw):
    kw.setdefault("corpus_bytes", BUDGET)
    return GrepEngine(device="cpu", **opts, **ENGINE_OPTS, **kw)


def _counters() -> dict:
    return layout.corpus_cache_counters()


def _spy_reads_and_uploads(monkeypatch):
    """Every builtins.open target and every segment pad (the upload
    point of ops/device_scan, resolved at call time)."""
    opens: list[str] = []
    real_open = builtins.open

    def spy_open(f, *a, **k):
        opens.append(str(f))
        return real_open(f, *a, **k)

    uploads: list[int] = []
    real_pad = layout.padded_stripes

    def spy_pad(data, lay, *a, **k):
        uploads.append(len(data))
        return real_pad(data, lay, *a, **k)

    monkeypatch.setattr(builtins, "open", spy_open)
    monkeypatch.setattr(layout, "padded_stripes", spy_pad)
    return opens, uploads


def _files(tmp_path, n=8, lines=60):
    out = []
    for j in range(n):
        q = tmp_path / f"f{j}.txt"
        q.write_bytes(b"".join(
            (b"hello line %d %d\n" % (j, i) if i % 5 == 0
             else b"hay line %d\n" % i) for i in range(lines)))
        out.append((q.name, str(q)))
    return out


# ------------------------------------------------------------- keys, knobs
def test_file_content_key_is_a_fresh_stat(tmp_path):
    p = tmp_path / "a.txt"
    p.write_bytes(b"hello\n")
    k1 = layout.file_content_key(p)
    assert k1.identity == ("file", os.path.realpath(p)) and k1.n_bytes == 6
    p.write_bytes(b"hello!\n")
    k2 = layout.file_content_key(p)
    assert k2.identity == k1.identity and k2 != k1
    assert layout.file_content_key(tmp_path / "missing") is None


def test_batch_content_key_requires_every_member(tmp_path):
    a, b = tmp_path / "a", tmp_path / "b"
    a.write_bytes(b"x\n")
    b.write_bytes(b"yy\n")
    ka, kb = layout.file_content_key(a), layout.file_content_key(b)
    k = layout.batch_content_key([ka, kb])
    assert k.identity == ("pack", (ka.identity, kb.identity))
    assert k.n_bytes == 5
    assert layout.batch_content_key([ka, None]) is None
    assert layout.batch_content_key([]) is None


def test_budget_resolution(monkeypatch):
    monkeypatch.delenv("DGREP_CORPUS_BYTES", raising=False)
    eng = GrepEngine("hello", device="cpu")
    assert eng._corpus_budget() == 0 and not eng._corpus_opt_in()
    monkeypatch.setattr(eng, "device", torch.device("cuda"))
    assert eng._corpus_budget() == layout.DEFAULT_CORPUS_BYTES_ACCEL == 1 << 30
    monkeypatch.setenv("DGREP_CORPUS_BYTES", "12345")
    assert eng._corpus_budget() == 12345
    monkeypatch.setenv("DGREP_CORPUS_BYTES", "0")
    assert eng._corpus_budget() == 0
    assert GrepEngine("hello", device="cpu",
                      corpus_bytes=77)._corpus_budget() == 77
    monkeypatch.setenv("DGREP_CORPUS_BYTES", "junk")
    assert GrepEngine("hello", device="cpu")._corpus_budget() == 0
    host = GrepEngine("hello", backend="cpu")
    monkeypatch.delenv("DGREP_CORPUS_BYTES")
    assert host._corpus_budget() == 0  # the host backend never uses the card


# ------------------------------------------------------- warm == cold
@pytest.mark.parametrize("label,opts", FAMILIES, ids=[f[0] for f in FAMILIES])
def test_warm_scan_file_bit_identical_per_family(label, opts, tmp_path):
    p = tmp_path / "c.txt"
    p.write_bytes(_corpus_bytes() * 3)
    eng = _engine(opts)
    cold = eng.scan_file(str(p))
    cs = dict(eng.stats)
    warm = eng.scan_file(str(p))
    ws = dict(eng.stats)
    want = RefEngine(backend="cpu", **opts).scan_file(str(p))
    for res in (cold, warm):
        assert res.matched_lines.tolist() == want.matched_lines.tolist()
        assert (res.n_matches, res.bytes_scanned) == (want.n_matches,
                                                      want.bytes_scanned)
    assert cold.n_matches > 0
    assert cs["uploads"] == cs["segments"] > 1 and cs["file_reads"] == 1
    assert ws["uploads"] == 0 and ws["file_reads"] == 0
    assert ws["resident_segments"] == cs["segments"]
    assert ws["corpus_cache_hits"] == 1 and ws["corpus_cache_host_hits"] == 1
    assert cs["corpus_cache_misses"] == 1


@pytest.mark.parametrize("label,opts", FAMILIES, ids=[f[0] for f in FAMILIES])
def test_warm_scan_batch_bit_identical_per_family(label, opts, tmp_path):
    files = _files(tmp_path)
    eng = _engine(opts, batch_bytes=1 << 20)
    cold = eng.scan_batch(list(files))
    assert eng.stats["batch_dispatches"] == 1
    warm = eng.scan_batch(list(files))
    ws = dict(eng.stats)
    want = RefEngine(backend="cpu", batch_bytes=1 << 20,
                     **opts).scan_batch(list(files))
    for got in (cold, warm):
        assert [(n, r.matched_lines.tolist(), r.bytes_scanned)
                for n, r in got] == [(n, r.matched_lines.tolist(),
                                      r.bytes_scanned) for n, r in want]
    assert ws["file_reads"] == 0 and ws["uploads"] == 0
    assert ws["corpus_cache_hits"] == 1


def test_warm_scan_file_zero_reads_zero_uploads(tmp_path, monkeypatch):
    p = tmp_path / "c.txt"
    p.write_bytes(_corpus_bytes() * 4)
    eng = _engine({"pattern": "hello"})
    cold = eng.scan_file(str(p))
    opens, uploads = _spy_reads_and_uploads(monkeypatch)
    warm = eng.scan_file(str(p))
    assert not [f for f in opens if str(tmp_path) in f]
    assert uploads == []
    assert np.array_equal(cold.matched_lines, warm.matched_lines)
    assert warm.n_matches > 0
    eng.scan(p.read_bytes())  # an unkeyed scan uploads: the spy sees it
    assert uploads


def test_warm_scan_batch_window_zero_reads_zero_uploads(tmp_path,
                                                        monkeypatch):
    files = _files(tmp_path)
    eng = _engine({"pattern": "hello"}, batch_bytes=1 << 20)
    cold = eng.scan_batch(list(files))
    opens, uploads = _spy_reads_and_uploads(monkeypatch)
    warm = eng.scan_batch(list(files))
    assert not [f for f in opens if str(tmp_path) in f]
    assert uploads == []
    for (na, a), (nb, b) in zip(cold, warm):
        assert na == nb and np.array_equal(a.matched_lines, b.matched_lines)
    assert sum(r.n_matches for _, r in warm) > 0


def test_resident_segments_are_tensors_on_the_engine_device(tmp_path):
    p = tmp_path / "c.txt"
    p.write_bytes(_corpus_bytes() * 3)
    eng = _engine({"pattern": "h[ae]llo+"})  # the NFA route transposes
    eng.scan_file(str(p))
    ent = layout.corpus_cache().lookup(layout.file_content_key(p))
    (sig, segs), = ent.variants.items()
    assert sig[0] == eng.segment_bytes
    for start, lay, t in segs:
        assert isinstance(t, torch.Tensor) and t.device == eng.device
        assert tuple(t.shape) == (lay.lanes, lay.chunk)  # the stripes
    assert ent.device_bytes == sum(t.nbytes for *_, t in segs)
    assert _counters()["corpus_cache_bytes_resident"] == ent.device_bytes


def test_no_trailing_newline_file_populates_and_warm_hits(tmp_path):
    p = tmp_path / "t.txt"
    p.write_bytes(_corpus_bytes() + b"hello at the end, no newline")
    eng = _engine({"pattern": "hello"})
    cold = eng.scan_file(str(p))
    warm = eng.scan_file(str(p))
    assert eng.stats["file_reads"] == 0
    assert cold.matched_lines.tolist() == warm.matched_lines.tolist()
    assert cold.matched_lines[-1] == 601


def test_disabled_budget_never_populates(tmp_path):
    p = tmp_path / "c.txt"
    p.write_bytes(_corpus_bytes())
    eng = _engine({"pattern": "hello"}, corpus_bytes=0)
    eng.scan_file(str(p))
    eng.scan_file(str(p))
    assert _counters() == {}
    assert eng.stats["file_reads"] == 1


def test_multi_chunk_file_streams_uncached(tmp_path):
    p = tmp_path / "c.txt"
    p.write_bytes(_corpus_bytes() * 3)
    eng = _engine({"pattern": "hello"})
    eng.scan_file(str(p), chunk_bytes=4000)
    eng.scan_file(str(p), chunk_bytes=4000)
    assert eng.stats["file_reads"] == 1 and _counters() == {}


# ------------------------------------------------------------ staleness
def test_mtime_change_invalidates_same_size(tmp_path):
    p = tmp_path / "m.txt"
    p.write_bytes(b"hello one\nhay\n")
    eng = _engine({"pattern": "hello"})
    assert eng.scan_file(str(p)).matched_lines.tolist() == [1]
    st = os.stat(p)
    p.write_bytes(b"hay one\nhello\n")  # same size
    os.utime(p, ns=(st.st_atime_ns, st.st_mtime_ns + 5_000_000))
    assert eng.scan_file(str(p)).matched_lines.tolist() == [2]
    assert eng.stats["file_reads"] == 1
    assert _counters()["corpus_cache_evictions"] >= 1


def test_inode_change_invalidates_same_size_same_mtime(tmp_path):
    p = tmp_path / "i.txt"
    p.write_bytes(b"hello one\nhay\n")
    eng = _engine({"pattern": "hello"})
    assert eng.scan_file(str(p)).matched_lines.tolist() == [1]
    st = os.stat(p)
    q = tmp_path / "i.new"
    q.write_bytes(b"hay one\nhello\n")
    os.utime(q, ns=(st.st_atime_ns, st.st_mtime_ns))
    keep = tmp_path / "keep"  # hold the old inode so it is not reused
    os.link(p, keep)
    os.replace(q, p)
    assert os.stat(p).st_mtime_ns == st.st_mtime_ns
    assert os.stat(p).st_ino != st.st_ino
    assert eng.scan_file(str(p)).matched_lines.tolist() == [2]
    assert eng.stats["file_reads"] == 1


def test_size_change_invalidates(tmp_path):
    p = tmp_path / "s.txt"
    p.write_bytes(b"hello\n")
    eng = _engine({"pattern": "hello"})
    eng.scan_file(str(p))
    p.write_bytes(b"hay\nhello\nhello\n")
    assert eng.scan_file(str(p)).matched_lines.tolist() == [2, 3]


def test_batch_member_change_invalidates_window(tmp_path):
    files = _files(tmp_path, n=4)
    eng = _engine({"pattern": "hello"}, batch_bytes=1 << 20)
    eng.scan_batch(list(files))
    with open(files[2][1], "ab") as f:
        f.write(b"hello appended\n")
    got = eng.scan_batch(list(files))
    assert eng.stats["file_reads"] == 4  # a cold window: every member read
    want = RefEngine("hello", backend="cpu").scan_batch(list(files))
    assert [r.matched_lines.tolist() for _, r in got] == [
        r.matched_lines.tolist() for _, r in want]
    assert got[2][1].matched_lines[-1] == 61


def test_shrunk_batch_bytes_governs_warm_windows(tmp_path):
    files = _files(tmp_path, n=6)
    eng = _engine({"pattern": "hello"}, batch_bytes=1 << 20)
    eng.scan_batch(list(files))
    eng.batch_bytes = 2000  # the cached window is larger than this
    got = eng.scan_batch(list(files))
    assert eng.stats["batch_dispatches"] > 1
    assert eng.stats["file_reads"] == 6
    want = RefEngine("hello", backend="cpu",
                     batch_bytes=2000).scan_batch(list(files))
    assert [r.matched_lines.tolist() for _, r in got] == [
        r.matched_lines.tolist() for _, r in want]


# ------------------------------------------------------- budget and LRU
def test_lru_eviction_under_tiny_budget(tmp_path):
    paths = []
    for j in range(3):
        p = tmp_path / f"l{j}.txt"
        p.write_bytes(_corpus_bytes())
        paths.append(str(p))
    one = _engine({"pattern": "hello"})
    one.scan_file(paths[0])
    per_entry = _counters()["corpus_cache_bytes_resident"]
    layout.corpus_cache_clear()
    eng = _engine({"pattern": "hello"}, corpus_bytes=2 * per_entry)
    for p in paths:
        eng.scan_file(p)
    c = _counters()
    assert c["corpus_cache_evictions"] == 1
    assert c["corpus_cache_bytes_resident"] == 2 * per_entry
    eng.scan_file(paths[0])  # evicted first: a miss, read again
    assert eng.stats["file_reads"] == 1
    eng.scan_file(paths[0])  # now resident
    assert eng.stats["file_reads"] == 0


def test_evicted_tensors_are_freed(tmp_path):
    a, b = tmp_path / "a.txt", tmp_path / "b.txt"
    a.write_bytes(_corpus_bytes())
    b.write_bytes(_corpus_bytes())
    eng = _engine({"pattern": "hello"})
    eng.scan_file(str(a))
    ent = layout.corpus_cache().lookup(layout.file_content_key(a))
    refs = [weakref.ref(t) for segs in ent.variants.values()
            for *_, t in segs]
    eng.corpus_bytes = ent.device_bytes  # room for one entry
    del ent
    eng.scan_file(str(b))
    assert _counters()["corpus_cache_evictions"] == 1
    assert refs and all(r() is None for r in refs)


def test_padded_band_input_is_cache_ineligible(tmp_path):
    """raw <= budget < padded: the scan skips the cache, and the entry
    already resident stays."""
    a, b = tmp_path / "a.txt", tmp_path / "b.txt"
    a.write_bytes(_corpus_bytes())
    b.write_bytes((b"hello padded band filler\n" * 200)[:4001])
    eng = _engine({"pattern": "hello"})
    eng.scan_file(str(a))
    c0 = _counters()
    eng.corpus_bytes = b.stat().st_size  # the raw size: the pad exceeds it
    assert eng.scan_file(str(b)).n_matches > 0
    c1 = _counters()
    assert c1["corpus_cache_evictions"] == 0
    assert c1["corpus_cache_misses"] == c0["corpus_cache_misses"]
    assert c1["corpus_cache_bytes_resident"] == c0[
        "corpus_cache_bytes_resident"]
    eng.corpus_bytes = BUDGET
    eng.scan_file(str(a))
    assert _counters()["corpus_cache_hits"] == c1.get("corpus_cache_hits",
                                                      0) + 1


def test_oversized_input_does_not_wipe_resident_entries(tmp_path):
    a, big = tmp_path / "a.txt", tmp_path / "big.txt"
    a.write_bytes(_corpus_bytes())
    big.write_bytes(_corpus_bytes() * 6)
    eng = _engine({"pattern": "hello"})
    eng.scan_file(str(a))
    resident = _counters()["corpus_cache_bytes_resident"]
    eng.corpus_bytes = resident * 2
    eng.scan_file(str(big))  # larger than the whole budget
    c = _counters()
    assert c["corpus_cache_evictions"] == 0
    assert c["corpus_cache_bytes_resident"] == resident
    eng.scan_file(str(a))
    assert eng.stats["file_reads"] == 0


def test_put_segments_declines_oversized_variant():
    cache = layout.CorpusCache()
    key = layout.CorpusKey(("file", "/x"), ((10, 1, 1),))
    lay = layout.choose_layout(10)
    t = torch.zeros(1000, dtype=torch.uint8)
    cache.put_segments(key, ("s",), b"0123456789", [(0, lay, t)], budget=999)
    assert cache.counters() == {}
    cache.put_segments(key, ("s",), b"0123456789", [(0, lay, t)], budget=1000)
    assert cache.counters()["corpus_cache_bytes_resident"] == 1000


def test_sibling_variant_dropped_before_tenant_eviction():
    cache = layout.CorpusCache()
    lay = layout.choose_layout(10)

    def seg(n):
        return [(0, lay, torch.zeros(n, dtype=torch.uint8))]

    k1 = layout.CorpusKey(("file", "/a"), ((10, 1, 1),))
    k2 = layout.CorpusKey(("file", "/b"), ((10, 1, 2),))
    cache.put_segments(k1, ("tenant",), b"a", seg(400), budget=1000)
    cache.put_segments(k2, ("one",), b"b", seg(300), budget=1000)
    cache.put_segments(k2, ("two",), b"b", seg(400), budget=1000)
    c = cache.counters()
    assert c["corpus_cache_evictions"] == 1  # k2's other layout, not k1
    assert cache.lookup(k1) is not None
    assert set(cache.lookup(k2).variants) == {("two",)}


def test_cached_window_is_slim_and_reconstructs_members(tmp_path):
    files = _files(tmp_path, n=5)
    eng = _engine({"pattern": "hello"}, batch_bytes=1 << 20)
    eng.scan_batch(list(files))
    keys = [layout.file_content_key(p) for _, p in files]
    ent = layout.corpus_cache().lookup(layout.batch_content_key(keys))
    assert ent.batch is not None and ent.batch.blobs is None
    assert ent.batch.data is ent.data
    assert ent.batch.member_blobs() == [open(p, "rb").read()
                                        for _, p in files]
    assert layout.corpus_cache().window_for(keys[0]) == ent.key
    assert layout.corpus_cache().window_for(keys[1]) is None


# -------------------------------------------------------------- counters
def test_stats_stamped_nonzero_only(tmp_path):
    p = tmp_path / "c.txt"
    p.write_bytes(_corpus_bytes())
    GrepEngine("hello", device="cpu", **ENGINE_OPTS).scan_file(str(p))
    eng = GrepEngine("hello", device="cpu", **ENGINE_OPTS)
    eng.scan(p.read_bytes())
    assert not any(k.startswith(("corpus_cache", "compile_cache"))
                   for k in eng.stats)
    eng = _engine({"pattern": "hello"})
    eng.scan_file(str(p))
    assert eng.stats["corpus_cache_misses"] == 1
    assert eng.stats["corpus_cache_bytes_resident"] > 0
    eng.scan(p.read_bytes())  # scan() stamps the process counters too
    assert eng.stats["corpus_cache_misses"] == 1
    assert "corpus_cache_misses" not in eng.totals  # never summed


def test_host_routed_warm_serve_counts_host_hit(tmp_path):
    """A host-routed engine serves the cached bytes of a file another
    engine published, without reaching the segments."""
    p = tmp_path / "c.txt"
    p.write_bytes(_corpus_bytes())
    _engine({"pattern": "hello"}).scan_file(str(p))
    host = _engine({"pattern": "^$"})  # mode "native"
    res = host.scan_file(str(p))
    assert host.stats["file_reads"] == 0
    c = _counters()
    assert c["corpus_cache_host_hits"] == 1 and c["corpus_cache_hits"] == 0
    assert res.matched_lines.tolist() == RefEngine(
        "^$", backend="cpu").scan_file(str(p)).matched_lines.tolist()


# ------------------------------------------------------------------ jobs
def test_warm_run_job_reads_and_uploads_nothing(tmp_path, monkeypatch):
    """Two jobs over the same files: a batched split of six small files
    (scan_batch) and one file past the small bound (scan_file); the
    second job reads no file, uploads no segment and writes the same
    mr-out bytes."""
    from distributed_grep_tpu_torch.apps import grep_cuda
    from distributed_grep_tpu_torch.apps.loader import from_module

    monkeypatch.setenv("DGREP_DEVICE_MIN_BYTES", "20000")
    d = tmp_path / "in"
    d.mkdir()
    files = [p for _, p in _files(d, n=6)]
    big = d / "big.txt"
    big.write_bytes(_corpus_bytes() * 3)
    assert big.stat().st_size > 20000
    files.append(str(big))

    def job(name):
        res = run_job(JobConfig(
            input_files=files,
            app_options={"pattern": "hello", "corpus_bytes": BUDGET,
                         **ENGINE_OPTS},
            n_reduce=3, work_dir=str(tmp_path / name),
            batch_bytes=1 << 20), n_workers=2, device="cpu",
            app=from_module(grep_cuda))  # the module whose engine is read
        t = grep_cuda._engine.totals
        return res, {k: t.get(k, 0)
                     for k in ("file_reads", "uploads", "resident_segments")}

    # the app builds its engine afresh, then keeps it for the second job
    monkeypatch.setattr(grep_cuda, "_configured_with", None)
    cold, c = job("cold")
    eng = grep_cuda._engine
    warm, after = job("warm")
    assert grep_cuda._engine is eng
    w = {k: after[k] - c[k] for k in c}
    assert c["file_reads"] == len(files) and c["uploads"] > 0
    assert w == {"file_reads": 0, "uploads": 0,
                 "resident_segments": c["uploads"]}
    assert _outputs(warm.output_files) == _outputs(cold.output_files)
    assert sum(len(v) for v in _outputs(cold.output_files).values()) > 0
    assert warm.metrics["counters"]["map_completed"] == 2  # split + big


# ----------------------------------------------------------- model cache
def test_cached_engine_hit_miss_off(monkeypatch):
    a, va = cached_engine("hello", device="cpu")
    b, vb = cached_engine("hello", device="cpu")
    c, vc = cached_engine("hello", device="cpu", ignore_case=True)
    assert (va, vb, vc) == ("miss", "hit", "miss") and a is b and a is not c
    s, _ = cached_engine(patterns=["ab", "zz"], device="cpu")
    assert cached_engine(patterns=("ab", "zz"), device="cpu")[0] is s
    assert engine_mod.model_cache_counters() == {
        "compile_cache_hits": 2, "compile_cache_misses": 3,
        "compile_cache_evictions": 0}
    eng = GrepEngine("hello", device="cpu")
    eng.scan(b"hello\n")
    assert eng.stats["compile_cache_hits"] == 2
    monkeypatch.setenv("DGREP_MODEL_CACHE", "0")
    d, vd = cached_engine("hello", device="cpu")
    assert vd == "off" and d is not a
    monkeypatch.setenv("DGREP_MODEL_CACHE", "1")
    cached_engine("other", device="cpu")
    assert engine_mod.model_cache_counters()["compile_cache_evictions"] >= 1
    engine_mod.model_cache_clear()
    assert engine_mod.model_cache_counters() == {}
