"""Port runtime/columnar.py and the batch-aware shuffle vs the reference:
partitions, the gathers, the wire format, deferred and eager splits, and
the identity collator's bytes with spills."""

import numpy as np
import pytest

from distributed_grep_tpu.apps.base import KeyValue as RefKeyValue
from distributed_grep_tpu.runtime import columnar as ref_col
from distributed_grep_tpu.runtime import shuffle as ref_shuffle
from distributed_grep_tpu.utils.native import partition as ref_partition
from distributed_grep_tpu_torch.apps.base import KeyValue
from distributed_grep_tpu_torch.ops.lines import newline_index
from distributed_grep_tpu_torch.runtime import columnar, shuffle

NAMES = ["/d/f.txt", "café/文.log", "bad\udcff name", "", "x (line number #3)"]


def _text(seed: int, n_lines: int, trailing: bool = True) -> bytes:
    rng = np.random.default_rng(seed)
    vocab = [b"the", b"volcano", b"caf\xc3\xa9", b"\xff\xfe", b"", b"\r",
             b"(line number #7)", columnar.MARKER, b'"q"\\', b"a\tb"]
    lines = [b" ".join(vocab[j] for j in rng.integers(0, len(vocab),
                                                      rng.integers(0, 6)))
             for _ in range(n_lines)]
    return b"\n".join(lines) + (b"\n" if trailing else b"")


def _batch(mod, name: str, data: bytes, lines) -> "columnar.LineBatch":
    nl = newline_index(data)
    return mod.make_batch_from_lines(name, np.asarray(lines, np.int64),
                                     np.frombuffer(data, np.uint8), nl,
                                     len(data))


@pytest.mark.parametrize("name", NAMES)
def test_partitions_equal_the_reference_fnv_for_every_digit_count(name):
    rng = np.random.default_rng(1)
    linenos = np.unique(np.concatenate([
        10 ** np.arange(0, 13), 10 ** np.arange(1, 13) - 1,
        rng.integers(1, 10 ** 12, size=200)])).astype(np.int64)
    keys = [f"{name} (line number #{n})" for n in linenos.tolist()]
    for n_reduce in (1, 7, 10):
        got = columnar.LineBatch(name, linenos, np.zeros(linenos.size + 1,
                                                         np.int64),
                                 b"").partitions(n_reduce)
        assert got.tolist() == [ref_partition(k, n_reduce) for k in keys]
        assert got.tolist() == shuffle.partition_many(keys, n_reduce).tolist()


def test_gather_ranges_equals_reference_with_empty_ranges():
    rng = np.random.default_rng(2)
    arr = rng.integers(0, 256, size=5000, dtype=np.uint8)
    for n in (0, 1, 2, 50, 400):
        starts = rng.integers(0, 5000, size=n)
        lens = rng.integers(0, 40, size=n) * (rng.random(n) < 0.7)
        ends = np.minimum(starts + lens, 5000)
        got = columnar.gather_ranges(arr, starts, ends)
        want = ref_col.gather_ranges(arr, starts, ends)
        assert got[0] == want[0] == b"".join(
            arr[s:e].tobytes() for s, e in zip(starts, ends))
        assert got[1].tolist() == want[1].tolist()


@pytest.mark.parametrize("trailing", [True, False])
def test_line_spans_equal_reference(trailing):
    data = _text(3, 300, trailing)
    nl = newline_index(data)
    n_lines = nl.size + (0 if trailing else 1)
    lines = np.arange(1, n_lines + 1)
    got = columnar.line_spans(lines, nl, len(data))
    want = ref_col.line_spans(lines, nl.astype(np.uint64), len(data))
    assert [g.tolist() for g in got] == [w.tolist() for w in want]
    one = columnar.line_spans(np.array([1]), np.zeros(0, np.int64), 9)
    assert [x.tolist() for x in one] == [[0], [9]]


def test_wire_format_equals_reference_and_round_trips():
    data = _text(4, 400)
    batch = _batch(columnar, "café \udcff.txt", data, [1, 5, 9, 77, 300])
    empty = _batch(columnar, "e", data, [])
    kvs = [KeyValue("a (line number #1)", "x\n" + columnar.MARKER.decode()),
           KeyValue("bad\udcff (line number #2)", "�"), KeyValue("k", "")]
    records = [kvs[0], batch, kvs[1], empty, batch, kvs[2]]
    wire = shuffle.encode_records(records)
    ref_batch = _batch(ref_col, batch.filename, data, [1, 5, 9, 77, 300])
    ref_records = [RefKeyValue(*kvs[0]), ref_batch, RefKeyValue(*kvs[1]),
                   _batch(ref_col, "e", data, []), ref_batch,
                   RefKeyValue(*kvs[2])]
    assert wire == ref_shuffle.encode_records(ref_records)
    # no batches: the plain JSON lines of before
    assert shuffle.encode_records(kvs) == ref_shuffle.encode_records(
        [RefKeyValue(*kv) for kv in kvs])
    back = shuffle.decode_records(wire)
    assert [type(r).__name__ for r in back] == [
        "KeyValue", "LineBatch", "KeyValue", "LineBatch", "LineBatch",
        "KeyValue"]
    for got, want in zip(back, records):
        if isinstance(want, KeyValue):
            assert got == want
        else:
            assert got.to_keyvalues() == want.to_keyvalues()
            assert got.slab == want.slab


def test_deferred_and_eager_splits_agree_with_reference():
    data = _text(5, 2000, trailing=False)
    nl = newline_index(data)
    arr = np.frombuffer(data, np.uint8)
    lines = np.flatnonzero(np.random.default_rng(6).random(2000) < 0.4) + 1
    deferred = columnar.DeferredBatch("f.txt", lines, arr, nl, len(data),
                                      lineno_base=1000)
    eager = columnar.make_batch_from_lines("f.txt", lines, arr, nl, len(data),
                                           lineno_base=1000)
    ref = ref_col.make_batch_from_lines("f.txt", lines, arr, nl, len(data),
                                        lineno_base=1000)
    for n_reduce in (1, 4, 10):
        d, e = deferred.split_by_partition(n_reduce), eager.split_by_partition(
            n_reduce)
        r = ref.split_by_partition(n_reduce)
        assert sorted(d) == sorted(e) == sorted(r)
        for p in d:
            for b in (d[p], e[p]):
                assert b.linenos.tolist() == r[p].linenos.tolist()
                assert b.offsets.tolist() == r[p].offsets.tolist()
                assert b.slab == r[p].slab
    assert deferred._built is None  # split straight from the source bytes
    assert deferred.to_keyvalues() == eager.to_keyvalues()
    assert deferred.format_lines_bytes() == ref.format_lines_bytes()


def test_bucketize_mixed_records_equals_reference():
    data = _text(7, 500)
    lines = list(range(1, 500, 3))
    kvs = [KeyValue(f"/d/g (line number #{n})", f"v{n}") for n in range(60)]
    port = shuffle.bucketize([*kvs[:30], _batch(columnar, "/d/f", data, lines),
                              *kvs[30:]], 10)
    ref = ref_shuffle.bucketize(
        [*[RefKeyValue(*kv) for kv in kvs[:30]],
         _batch(ref_col, "/d/f", data, lines),
         *[RefKeyValue(*kv) for kv in kvs[30:]]], 10)
    assert sorted(port) == sorted(ref)
    for r in port:
        assert shuffle.encode_records(port[r]) == ref_shuffle.encode_records(
            ref[r])


def _collate(mod, kv_cls, records, limit: int, spill_dir: str):
    with mod.IdentityCollator(memory_limit_bytes=limit,
                              spill_dir=spill_dir) as c:
        c.add_many(records(mod, kv_cls))
        out = b"".join(b if isinstance(b, bytes)
                       else b.encode("utf-8", "surrogateescape")
                       for b in c.iter_output_blocks())
        return out, c.spill_count


def test_identity_collator_bytes_equal_reference_with_spills(tmp_path):
    data = _text(8, 3000)
    rng = np.random.default_rng(9)

    def records(mod, kv_cls):
        recs = []
        for name in ("b.txt", "a\udcff.txt", "a.txt"):
            lines = np.flatnonzero(rng.random(3000) < 0.3) + 1
            for chunk in np.array_split(lines, 6)[::-1]:  # out of order
                recs.append(_batch(mod, name, data, chunk))
        recs += [kv_cls("c.txt", "3"), kv_cls("a.txt (line number #2)", "x"),
                 kv_cls("zz", "y\tz")]
        return recs

    port, n_port = _collate(columnar, KeyValue, records, 20_000,
                            str(tmp_path))
    rng = np.random.default_rng(9)
    ref, n_ref = _collate(ref_col, RefKeyValue, records, 20_000,
                          str(tmp_path))
    assert n_port == n_ref >= 2
    assert port == ref and port.count(b"\n") > 1000
    assert list(tmp_path.iterdir()) == []  # the runs go with the collator
