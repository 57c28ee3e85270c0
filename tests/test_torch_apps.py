"""The port's application boundary against the reference's
(tests/test_apps.py's host cases): KeyValue grouping, the loader, the host
grep, wordcount and inverted-index apps, record for record with the
reference's apps, and their jobs' mr-out bytes equal to the reference's
run_job with its own apps."""

from pathlib import Path

import numpy as np
import pytest

from distributed_grep_tpu.apps import load_application as ref_load
from distributed_grep_tpu.apps.base import group_reduce as ref_group_reduce
from distributed_grep_tpu.runtime.job import run_job as ref_run_job
from distributed_grep_tpu.utils.config import JobConfig as RefJobConfig
from distributed_grep_tpu_torch.apps.base import KeyValue, group_reduce
from distributed_grep_tpu_torch.apps.loader import load_application
from distributed_grep_tpu_torch.runtime.columnar import LineBatch
from distributed_grep_tpu_torch.runtime.job import run_job
from distributed_grep_tpu_torch.utils.config import JobConfig
from tests.conftest import expand_records as ref_expand

PORT = "distributed_grep_tpu_torch.apps."
REF = "distributed_grep_tpu.apps."


def expand(records):
    out = []
    for r in records:
        out.extend(r.to_keyvalues() if isinstance(r, LineBatch) else [r])
    return out


def pairs(records, expander=expand):
    return [(kv.key, kv.value) for kv in expander(records)]


def test_group_reduce_sort_merge_semantics():
    records = [KeyValue("b", "1"), KeyValue("a", "x"), KeyValue("b", "2"),
               KeyValue("a", "y")]
    calls = []

    def reducef(key, values):
        calls.append((key, list(values)))
        return ",".join(values)

    out = group_reduce(records, reducef)
    assert out == {"a": "x,y", "b": "1,2"}
    assert calls == [("a", ["x", "y"]), ("b", ["1", "2"])]
    assert out == ref_group_reduce(records, lambda k, v: ",".join(v))


def test_load_application_by_module_name():
    app = load_application(PORT + "grep", pattern="fox")
    data = b"a fox\nno match\nfoxfox"
    assert [kv.key for kv in expand(app.map_fn("f.txt", data))] == [
        "f.txt (line number #1)", "f.txt (line number #3)"]
    assert app.reduce_fn("k", ["v1", "v2"]) == "v1"
    ref = ref_load(REF + "grep", pattern="fox")
    assert pairs(app.map_fn("f.txt", data)) == pairs(
        ref.map_fn("f.txt", data), ref_expand)
    # a fresh module instance each load: state never leaks between them
    other = load_application(PORT + "grep", pattern="no")
    assert other.module is not app.module
    assert len(expand(app.map_fn("f.txt", data))) == 2


def test_load_application_by_path(tmp_path):
    p = tmp_path / "custom_app.py"
    p.write_text(
        "from distributed_grep_tpu_torch.apps.base import KeyValue\n"
        "def Map(filename, contents):\n"
        "    return [KeyValue('n_bytes', str(len(contents)))]\n"
        "def Reduce(key, values):\n"
        "    return str(sum(int(v) for v in values))\n")
    app = load_application(str(p))
    assert app.map_fn("x", b"abcd") == [KeyValue("n_bytes", "4")]
    assert app.reduce_fn("n_bytes", ["4", "6"]) == "10"
    assert app.map_path_fn is None and not app.map_batch_paths


def test_load_application_rejects_incomplete_module(tmp_path):
    p = tmp_path / "broken_app.py"
    p.write_text("def Map(f, c): return []\n")  # no Reduce
    with pytest.raises(TypeError):
        load_application(str(p))


def test_grep_app_pattern_plumbing_and_regex():
    app = load_application(PORT + "grep", pattern=r"h[ae]llo")
    data = b"hallo\nhello\nhullo\n"
    assert len(expand(app.map_fn("t", data))) == 2
    app.configure(pattern="hullo")  # a new job's pattern: no state leaks
    assert len(expand(app.map_fn("t", data))) == 1


def test_grep_app_case_insensitive_and_binary_safe():
    app = load_application(PORT + "grep", pattern="hello", ignore_case=True)
    data = b"HELLO\nx\xff\xfehello\xff\n"
    kvs = expand(app.map_fn("t", data))
    assert len(kvs) == 2 and kvs[1].key == "t (line number #2)"
    ref = ref_load(REF + "grep", pattern="hello", ignore_case=True)
    assert pairs(app.map_fn("t", data)) == pairs(ref.map_fn("t", data),
                                                 ref_expand)


def test_wordcount_app():
    app = load_application(PORT + "wordcount")
    kvs = app.map_fn("t", b"the cat and the hat")
    assert group_reduce(kvs, app.reduce_fn) == {"the": "2", "cat": "1",
                                                "and": "1", "hat": "1"}
    assert app.reduce_stream_fn("the", iter(["1", "1"])) == "2"
    ref = ref_load(REF + "wordcount")
    assert kvs == ref.map_fn("t", b"the cat and the hat")


def test_grep_cpu_no_phantom_trailing_line():
    app = load_application(PORT + "grep", pattern="")
    assert [kv.key for kv in expand(app.map_fn("f", b"one\ntwo\n"))] == [
        "f (line number #1)", "f (line number #2)"]


def test_grep_cpu_pattern_set_uses_ac():
    app = load_application(PORT + "grep", patterns=["needle", "vol.cano"])
    assert app.module._ac_tables  # literals, scanned as Aho-Corasick banks
    data = b"a needle\nvolXcano\nvol.cano literal\nnone\n"
    assert [kv.key for kv in expand(app.map_fn("f", data))] == [
        "f (line number #1)", "f (line number #3)"]


GREP_OPTIONS = [
    {"pattern": "hello", "invert": True},
    {"pattern": "the", "word_regexp": True},
    {"pattern": "x", "line_regexp": True},
    {"pattern": "hello", "count_only": True},
    {"pattern": "hello", "count_only": True, "presence_only": True},
    {"patterns": ["the", "fox", "hello"], "word_regexp": True},
    {"patterns": ["HELLO", "x"], "ignore_case": True, "invert": True},
    {"pattern": "[[:digit:]]+"},
]


@pytest.mark.parametrize("opts", GREP_OPTIONS, ids=lambda o: repr(o))
def test_grep_options_equal_reference_app(opts):
    rng = np.random.default_rng(3)
    vocab = [b"the", b"hello", b"HELLO", b"fox", b"x", b"42", b"", b"\xff"]
    data = b"\n".join(b" ".join(rng.choice(vocab, rng.integers(0, 5)))
                      for _ in range(400)) + b"\nx\n"
    port = load_application(PORT + "grep", **opts)
    ref = ref_load(REF + "grep", **opts)
    assert pairs(port.map_fn("f", data)) == pairs(ref.map_fn("f", data),
                                                  ref_expand)


def test_inverted_index_app():
    ii = load_application(PORT + "inverted_index").module
    ii.configure(min_word_len=2)
    recs = (ii.map_fn("a.txt", b"the cat sat\nThe dog")
            + ii.map_fn("b.txt", b"a cat runs"))
    out = group_reduce(recs, ii.reduce_fn)
    assert out["cat"] == "2 a.txt,b.txt"
    assert out["dog"] == "1 a.txt"
    assert "a" not in out


def test_inverted_index_through_runtime(tmp_path):
    f1, f2 = tmp_path / "x.txt", tmp_path / "y.txt"
    f1.write_bytes(b"alpha beta\n")
    f2.write_bytes(b"beta gamma\n")
    res = run_job(JobConfig(input_files=[str(f1), str(f2)],
                            application=PORT + "inverted_index", n_reduce=3,
                            work_dir=str(tmp_path / "job")),
                  n_workers=2, device="cpu")
    assert res.results["beta"] == f"2 {f1},{f2}"
    assert res.results["alpha"] == f"1 {f1}"


def test_literal_mode_lines_matches_wrapped_regex():
    import re

    from distributed_grep_tpu_torch.apps.grep import (
        literal_mode_lines,
        wrap_mode,
    )

    cases = [
        (b"the", b"the\nthe end\nxthe\nthe_y\na the b\n_the\nthe"),
        (b"aa", b"aaa\naa\nb aa c\naaaa\n"),
        (b"a-b", b"a-b\nxa-b\na-b y\nza-bw\n"),
        (b"x", b"x"),
        (b"t t", b"t t\na t t b\nt tt\n"),
    ]
    for lit, data in cases:
        for mode in ("word", "line"):
            rx = re.compile(wrap_mode(re.escape(lit), mode))
            lines = data.split(b"\n")
            if lines and lines[-1] == b"":
                lines.pop()
            want = sorted(i for i, ln in enumerate(lines, 1) if rx.search(ln))
            assert literal_mode_lines(data, lit, mode).tolist() == want


@pytest.fixture
def word_files(tmp_path):
    rng = np.random.default_rng(11)
    vocab = ["the", "hello", "Hello", "fox", "volcano", "ash", "lava", "x",
             "café", "a_b"]
    files = []
    for i in range(5):
        p = tmp_path / f"w{i}.txt"
        p.write_text("\n".join(" ".join(rng.choice(vocab, rng.integers(0, 7)))
                               for _ in range(300 + 50 * i)) + "\n")
        files.append(str(p))
    return files


@pytest.mark.parametrize("app,opts", [
    ("wordcount", {}),
    ("inverted_index", {"min_word_len": 2}),
    ("grep", {"pattern": "hel+o"}),
    ("grep", {"patterns": ["fox", "lava"], "invert": True}),
    ("grep", {"pattern": "ash", "count_only": True}),
], ids=["wordcount", "inverted_index", "grep", "grep -F -v", "grep -c"])
def test_job_mr_out_bytes_equal_reference(tmp_path, word_files, app, opts):
    port = run_job(JobConfig(input_files=word_files, application=PORT + app,
                             app_options=opts, n_reduce=4,
                             work_dir=str(tmp_path / "port")),
                   n_workers=3, device="cpu")
    ref = ref_run_job(RefJobConfig(input_files=word_files,
                                   application=REF + app, app_options=opts,
                                   n_reduce=4, work_dir=str(tmp_path / "ref")),
                      n_workers=3)

    def out(paths):
        return {Path(p).name: Path(p).read_bytes() for p in paths}

    got = out(port.output_files)
    assert got == out(ref.output_files)
    assert sum(map(len, got.values())) > 0
