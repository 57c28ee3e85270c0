"""Port runtime/extsort.ExternalReducer vs the reference's, with spills, and
a non-identity app's job through the port's reduce against the
reference's job."""

from pathlib import Path

import numpy as np
import pytest

from distributed_grep_tpu.apps.base import KeyValue as RefKeyValue
from distributed_grep_tpu.runtime.extsort import ExternalReducer as RefReducer
from distributed_grep_tpu.runtime.job import run_job as ref_run_job
from distributed_grep_tpu.utils.config import JobConfig as RefJobConfig
from distributed_grep_tpu_torch.apps.base import KeyValue
from distributed_grep_tpu_torch.runtime.extsort import ExternalReducer
from distributed_grep_tpu_torch.runtime.job import run_job
from distributed_grep_tpu_torch.utils.config import JobConfig


def _records(seed: int, n: int) -> list[tuple[str, str]]:
    rng = np.random.default_rng(seed)
    keys = ["the", "volcano", "café", "bad\udcff", "", "a\tb", "z\n"]
    keys += [f"k{i}" for i in range(50)]
    return [(keys[k], f"{v}\r{'x' * (v % 7)}")
            for k, v in zip(rng.integers(0, len(keys), n).tolist(),
                            rng.integers(0, 1000, n).tolist())]


def _join(key, values):
    return "|".join(values)


def _stream_join(key, values):
    return "|".join(values) + "#"


@pytest.mark.parametrize("limit", [1 << 30, 4000])
def test_external_reducer_equals_reference(tmp_path, limit):
    recs = _records(0, 3000)
    port = ExternalReducer(limit, spill_dir=str(tmp_path))
    ref = RefReducer(limit, spill_dir=str(tmp_path))
    for i in range(0, len(recs), 500):
        port.add_many(KeyValue(k, v) for k, v in recs[i : i + 500])
        ref.add_many(RefKeyValue(k, v) for k, v in recs[i : i + 500])
    assert port.spill_count == ref.spill_count
    assert (port.spill_count >= 2) == (limit < 1 << 20)
    assert list(port.merged()) == list(ref.merged())
    assert list(port.reduce(_join)) == list(ref.reduce(_join))
    got = list(port.reduce(_join, _stream_join))
    assert got == list(ref.reduce(_join, _stream_join))
    assert all(v.endswith("#") for _, v in got)
    port.close()
    ref.close()
    assert list(tmp_path.iterdir()) == []
    with pytest.raises(ValueError):
        ExternalReducer(0)


@pytest.mark.parametrize("reduce_memory_bytes", [128 << 20, 2000])
def test_non_identity_job_equals_reference(tmp_path, monkeypatch,
                                           reduce_memory_bytes):
    """Word count (the reference's own app, with reduce_stream_fn) through
    the port's reduce: the sort-merge, spilling into the job's work dir."""
    rng = np.random.default_rng(1)
    words = ["the", "volcano", "Volcano", "ash", "lava", "x"]
    files = []
    for i in range(3):
        p = tmp_path / f"w{i}.txt"
        p.write_text("\n".join(" ".join(rng.choice(words, 6))
                               for _ in range(300)))
        files.append(str(p))
    app = "distributed_grep_tpu.apps.wordcount"
    ref = ref_run_job(RefJobConfig(input_files=files, application=app,
                                   work_dir=str(tmp_path / "ref"),
                                   reduce_memory_bytes=reduce_memory_bytes),
                      n_workers=2)
    port = run_job(JobConfig(input_files=files, application=app,
                             work_dir=str(tmp_path / "port"),
                             reduce_memory_bytes=reduce_memory_bytes),
                   n_workers=2, device="cpu")
    out = {p.name: p.read_bytes() for p in port.output_files}
    assert out == {p.name: p.read_bytes() for p in ref.output_files}
    assert sum(map(len, out.values())) > 0
    spills = port.metrics["counters"]["reduce_spills"]
    assert (spills > 0) == (reduce_memory_bytes < 1 << 20)
    assert list(Path(tmp_path / "port" / "spill").iterdir()) == []
