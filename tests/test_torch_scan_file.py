"""Port GrepEngine.scan_file vs the reference's (backend "cpu") at chunk
sizes of 1-4 KB over every route: the matched lines, the emits, long
lines, an empty file, stop_after_match and stop."""

import numpy as np
import pytest

from distributed_grep_tpu.ops.engine import GrepEngine as RefEngine
from distributed_grep_tpu_torch.ops import engine as engine_mod
from distributed_grep_tpu_torch.ops.engine import GrepEngine
from tests.test_torch_job import ENGINE_OPTS

QUERIES = [
    ("shift_and", {"pattern": "volcano"}),
    ("-i", {"pattern": "Volcano", "ignore_case": True}),
    ("fdr set", {"patterns": ["hello", "lava flow", "x y"]}),
    ("nfa", {"pattern": "h[ae]llo+ (the|a)"}),
    ("dfa_filter", {"pattern": "volcano$"}),
    ("approx", {"pattern": "volcano", "max_errors": 1}),
]
CHUNKS = [1024, 2500, 4096]


@pytest.fixture(scope="module")
def text_file(tmp_path_factory):
    rng = np.random.default_rng(5)
    vocab = [b"the", b"volcano", b"Volcano", b"volcxno", b"hello", b"hallooo",
             b"lava", b"flow", b"x", b"y", b"caf\xc3\xa9", b"\xff", b"a"]
    lines = [b" ".join(vocab[j] for j in rng.integers(0, len(vocab),
                                                      rng.integers(0, 10)))
             for _ in range(3000)]
    # lines longer than every chunk, one with a match at its very end
    lines[700] = b"a" * 9000 + b" volcano"
    lines[1500] = b"lava " * 2000
    p = tmp_path_factory.mktemp("scan_file") / "in.txt"
    p.write_bytes(b"\r\n".join(lines[:100]) + b"\n"
                  + b"\n".join(lines[100:]))  # no trailing newline
    return p


def _engines(opts):
    return (GrepEngine(device="cpu", **opts, **ENGINE_OPTS),
            RefEngine(backend="cpu", **opts))


@pytest.mark.parametrize("label,opts", QUERIES, ids=[q[0] for q in QUERIES])
def test_scan_file_equals_reference(text_file, label, opts):
    port, ref = _engines(opts)
    whole = port.scan(text_file.read_bytes()).matched_lines
    for chunk in CHUNKS:
        got_emit, want_emit, got_chunks = [], [], []
        got = port.scan_file(text_file, chunk_bytes=chunk,
                             emit=lambda n, b: got_emit.append((n, b)))
        want = ref.scan_file(text_file, chunk_bytes=chunk,
                             emit=lambda n, b: want_emit.append((n, b)))
        assert got.matched_lines.tolist() == want.matched_lines.tolist()
        assert got.matched_lines.tolist() == whole.tolist()
        assert got.bytes_scanned == want.bytes_scanned
        assert got_emit == want_emit and got_emit
        assert port.stats["read_wait_seconds"] >= 0

        def emit_chunk(lines_before, buf, lines, nl):
            assert nl.tolist() == np.flatnonzero(
                np.frombuffer(buf, np.uint8) == 10).tolist()
            got_chunks.append(lines + lines_before)

        port.scan_file(text_file, chunk_bytes=chunk, emit_chunk=emit_chunk)
        assert np.concatenate(got_chunks).tolist() == whole.tolist()
        assert len(got_chunks) > 1


@pytest.mark.parametrize("label,opts", QUERIES[:4], ids=[q[0] for q in
                                                         QUERIES[:4]])
def test_stop_after_match_and_stop_equal_reference(text_file, label, opts):
    port, ref = _engines(opts)
    got = port.scan_file(text_file, chunk_bytes=1024, stop_after_match=True)
    want = ref.scan_file(text_file, chunk_bytes=1024, stop_after_match=True)
    assert got.matched_lines.tolist() == want.matched_lines.tolist()
    assert 0 < got.bytes_scanned < text_file.stat().st_size
    calls = []
    got = port.scan_file(text_file, chunk_bytes=1024,
                         stop=lambda: calls.append(1) or len(calls) == 3)
    want = ref.scan_file(text_file, chunk_bytes=1024,
                         stop=lambda: calls.append(1) or len(calls) == 6)
    assert got.matched_lines.tolist() == want.matched_lines.tolist()
    assert got.bytes_scanned == want.bytes_scanned


def test_empty_file_and_default_chunk(tmp_path, monkeypatch):
    empty = tmp_path / "empty.txt"
    empty.write_bytes(b"")
    port, ref = _engines({"pattern": "volcano"})
    got = port.scan_file(empty, emit=lambda *a: pytest.fail("emitted"))
    assert got.matched_lines.tolist() == [] and got.bytes_scanned == 0
    assert port.stats["read_wait_seconds"] >= 0
    one = tmp_path / "one.txt"
    one.write_bytes(b"volcano")
    assert port.scan_file(one).matched_lines.tolist() == [1]
    # the default chunk: the larger of the segment size and FILE_CHUNK_BYTES
    data = b"the volcano\nash\n" * 2000
    src = tmp_path / "many.txt"
    src.write_bytes(data)
    sizes = []
    monkeypatch.setattr(engine_mod, "FILE_CHUNK_BYTES", 1000)
    port.scan_file(src, emit_chunk=lambda lb, buf, *a: sizes.append(len(buf)))
    assert max(sizes) <= ENGINE_OPTS["segment_bytes"] and sum(sizes) == len(
        data)
    assert ref.scan_file(src).matched_lines.tolist() == list(
        range(1, 4001, 2))


def test_reader_thread_is_kept_per_scanning_thread(text_file):
    import threading

    port, _ = _engines({"pattern": "volcano"})
    before = threading.active_count()
    for _ in range(3):
        port.scan_file(text_file, chunk_bytes=1024)
    assert threading.active_count() <= before + 1
    assert engine_mod._thread_reader() is engine_mod._thread_reader()


@pytest.mark.parametrize("last", [b"\n", b"s"], ids=["newline", "no-newline"])
def test_file_of_two_chunks_scans_as_two_segments(tmp_path, last):
    """The last chunk takes the carried tail line and its own tail whole,
    and a segment's few bytes past its size join it, so a file of exactly
    two chunks scans as two segments, as ``scan`` of its bytes does, with
    or without a newline at its end."""
    seg = ENGINE_OPTS["segment_bytes"]
    line = b"the volcano as\n"  # 15 bytes: chunk edges cut a line
    data = (line * (2 * seg // len(line) + 1))[: 2 * seg - 1] + last
    src = tmp_path / "two.txt"
    src.write_bytes(data)
    port, ref = _engines({"pattern": "volcano"})
    got = port.scan_file(src, chunk_bytes=seg)
    assert port.stats["segments"] == 2
    assert got.matched_lines.tolist() == ref.scan_file(
        src, chunk_bytes=seg).matched_lines.tolist()
    assert port.scan(data).matched_lines.tolist() == got.matched_lines.tolist()
    assert port.stats["segments"] == 2
    # a short tail joins the last full segment; a longer one is its own
    for n, want in [(seg + seg // 8, 1), (seg + seg // 8 + 1, 2)]:
        port.scan(data[:n])
        assert port.stats["segments"] == want


def test_reader_threads_end_with_their_jobs(tmp_path, monkeypatch):
    """run_job starts fresh worker threads; each one's read-ahead thread
    ends when the worker does, so jobs leave no threads behind."""
    import threading
    import time

    from distributed_grep_tpu_torch.runtime.job import run_job
    from distributed_grep_tpu_torch.utils.config import JobConfig

    files = []
    for i in range(3):
        p = tmp_path / f"in{i}.txt"
        p.write_bytes(b"the volcano\nash\n" * 500)
        files.append(str(p))
    monkeypatch.setattr(engine_mod, "FILE_CHUNK_BYTES", 1024)
    started = []
    orig = engine_mod._Reader.__init__

    def counting_init(self):
        started.append(1)
        orig(self)

    monkeypatch.setattr(engine_mod._Reader, "__init__", counting_init)
    before = threading.active_count()
    for j in range(2):
        run_job(JobConfig(input_files=files, work_dir=str(tmp_path / f"j{j}"),
                          app_options={"pattern": "volcano", **ENGINE_OPTS}),
                n_workers=2, device="cpu")
    assert len(started) >= 2  # every job's workers read ahead
    deadline = time.monotonic() + 10
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() == before
