"""Several processes on one mesh (distributed_grep_tpu_torch/parallel/
multihost.py and the multi-process feed of sharded_kernels.py), held to
the reference's parallel/multihost.py (tests/test_multihost.py) and to
its single-device output.

The resolution tests record ``torch.distributed.init_process_group``
instead of running it, as the reference's record
``jax.distributed.initialize``.  The reference can only mock two
processes; here two real gloo ranks run on 127.0.0.1
(tests/torch_mesh_rank.py), each owning two ``cpu`` entries of a (2, 2)
mesh, and every rank must get, bit for bit, what one process gets on the
same mesh and what the reference's kernels give on one device.  The
tolerance is zero.
"""

from __future__ import annotations

import socket
import subprocess
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from distributed_grep_tpu_torch.parallel import multihost
from distributed_grep_tpu_torch.parallel import sharded_kernels as sk
from distributed_grep_tpu_torch.parallel.mesh import (
    LaneSharding,
    make_mesh,
    pattern_sharding,
)

TESTS = Path(__file__).resolve().parent
sys.path.insert(0, str(TESTS))
import torch_mesh_rank as rank_mod  # noqa: E402

ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


@pytest.fixture
def record_init(monkeypatch):
    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.append({"backend": backend,
                                                            **kw}))
    monkeypatch.setattr(dist, "get_rank", lambda *a: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 2)
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    return calls


def _spec(call):
    return (call["backend"], call["init_method"], call["world_size"],
            call["rank"])


def test_no_address_means_single_process(record_init):
    assert multihost.init_distributed() is False
    assert record_init == []
    assert multihost.process_index() == 0 and multihost.process_count() == 1


def test_explicit_args(record_init):
    assert multihost.init_distributed("10.0.0.1:9999", 2, 1,
                                      device="cpu") is True
    assert [_spec(c) for c in record_init] == [
        ("gloo", "tcp://10.0.0.1:9999", 2, 1)]
    assert record_init[0]["timeout"].total_seconds() == \
        multihost.DEFAULT_TIMEOUT_S


def test_env_resolution(record_init, monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.2")
    monkeypatch.setenv("MASTER_PORT", "1111")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    assert multihost.init_distributed() is True
    # no device named: the card's backend
    assert [_spec(c) for c in record_init] == [
        ("nccl", "tcp://10.0.0.2:1111", 4, 3)]


def test_args_override_env(record_init, monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.2")
    monkeypatch.setenv("MASTER_PORT", "1111")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    assert multihost.init_distributed("10.9.9.9:2222", process_id=0,
                                      backend="gloo") is True
    assert [_spec(c) for c in record_init] == [
        ("gloo", "tcp://10.9.9.9:2222", 4, 0)]


@pytest.mark.parametrize("args,missing", [
    (("10.0.0.1:9999",), "WORLD_SIZE"),
    (("10.0.0.1:9999", 2), "RANK"),
    (("10.0.0.1", 2, 0), "MASTER_PORT"),
])
def test_partial_spec_raises_naming_what_is_missing(record_init, args,
                                                    missing):
    """D15: torch's tcp init cannot infer the world size or the rank, so
    where the reference passes only what it has, the port raises."""
    with pytest.raises(ValueError, match=missing):
        multihost.init_distributed(*args)
    assert record_init == []


def test_process_id_zero_env(record_init, monkeypatch):
    """'0' from the environment must not be dropped as falsy."""
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.2")
    monkeypatch.setenv("MASTER_PORT", "1111")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    assert multihost.init_distributed(device="cpu") is True
    assert record_init[0]["rank"] == 0


def test_local_mesh_devices_are_local():
    assert multihost.local_mesh_devices("cpu") == [torch.device("cpu")]


def test_http_worker_calls_init_distributed(monkeypatch, tmp_path, corpus):
    """The HTTP worker entry point wires the glue: run_http_worker calls
    init_distributed before it works (and before any CUDA check), with
    the job's device."""
    from distributed_grep_tpu_torch.runtime import http_transport
    from distributed_grep_tpu_torch.runtime.http_coordinator import (
        CoordinatorServer,
    )
    from distributed_grep_tpu_torch.utils.config import JobConfig

    called = []
    monkeypatch.setattr(multihost, "init_distributed",
                        lambda *a, **k: called.append(k) or False)
    server = CoordinatorServer(JobConfig(
        input_files=[str(p) for p in corpus.values()],
        application="distributed_grep_tpu_torch.apps.grep_cuda",
        app_options={"pattern": "hello", "device": "cpu"}, n_reduce=2,
        work_dir=str(tmp_path / "job"), coordinator_port=0))
    server.start()
    try:
        http_transport.run_http_worker(f"127.0.0.1:{server.port}")
        assert called == [{"device": "cpu"}]
        assert server.wait_done(timeout=10.0)
    finally:
        server.shutdown(linger_s=0.1)


# ------------------------------------------- the multi-process feed

def test_local_blocks_materialize_only_a_ranks_blocks():
    """The multi-process feed contract (the reference's
    test_local_shard_index_map_materializes_only_local_blocks): on a
    two-rank topology of four entries a rank copies only its own entries'
    rows, its 2 of 8 lane tiles each."""
    sharding = LaneSharding(tuple(torch.device("cpu") for _ in range(4)),
                            (0, 0, 1, 1))
    lanes = 8 * sk.LANE_TILE
    for rank in (0, 1):
        local = sk.local_blocks(sharding, lanes, rank)
        assert set(local) == ({0, 1} if rank == 0 else {2, 3})
        for lo, hi in local.values():
            assert hi - lo == 2 * sk.LANE_TILE
    # the pattern axis: every entry along it copies its lane block
    mesh = make_mesh((2, 2), ("data", "seq"), devices=["cpu"] * 4)
    ps = pattern_sharding(mesh, "data", "seq")
    ranked = LaneSharding(ps.devices, (0, 1, 0, 1), ps.n_pat)
    assert sk.local_blocks(ranked, lanes, 1) == {1: (0, lanes // 2),
                                                 3: (lanes // 2, lanes)}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_ranks(tmp_path, *extra, limit_s: float = 45.0):
    """Two ranks of tests/torch_mesh_rank.py; (return codes, outputs,
    seconds).  Each rank has ``limit_s`` at most."""
    port = _free_port()
    outs = [tmp_path / f"rank{r}.pt" for r in (0, 1)]
    t0 = time.monotonic()
    procs = [subprocess.Popen(
        [sys.executable, str(TESTS / "torch_mesh_rank.py"), str(r), "2",
         str(port), str(outs[r]), *extra],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
        for r in (0, 1)]
    rcs, errs = [], []
    try:
        for p in procs:
            _out, err = p.communicate(timeout=limit_s)
            rcs.append(p.returncode)
            errs.append(err.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return rcs, errs, outs, time.monotonic() - t0


def _as_words(packed) -> torch.Tensor:
    from distributed_grep_tpu_torch.ops.fdr_scan import pack_bits

    bits = np.unpackbits(np.asarray(packed), axis=1,
                         bitorder="little").astype(bool)
    return pack_bits(torch.from_numpy(bits))


def _reference(arr: np.ndarray, data: bytes) -> dict:
    """The reference's single-device outputs on the ranks' inputs."""
    from distributed_grep_tpu.models import dfa as ref_dfa
    from distributed_grep_tpu.models import fdr as ref_fdr
    from distributed_grep_tpu.models import shift_and as ref_sa
    from distributed_grep_tpu.ops import pallas_fdr, pallas_scan, scan_jnp
    from distributed_grep_tpu.ops.engine import GrepEngine as RefEngine

    shape = (arr.shape[0] // 32, arr.shape[1])
    sa = np.asarray(pallas_scan.shift_and_scan_words(
        arr, ref_sa.try_compile_shift_and("needle"), interpret=True,
        coarse=True)).reshape(shape)
    fdr = None
    for half in (rank_mod.SET[:4], rank_mod.SET[4:]):
        for bank in ref_fdr.compile_fdr(half).banks:
            w = np.asarray(pallas_fdr.fdr_scan_words(
                arr, bank, interpret=True)).reshape(shape)
            fdr = w if fdr is None else fdr | w
    t = ref_dfa.compile_dfa("needle")
    init = jnp.full((arr.shape[1],), t.start, dtype=jnp.int32)
    final, match = scan_jnp.dfa_scan_body(
        jnp.asarray(arr), jnp.asarray(t.trans.astype(np.int32).reshape(-1)),
        jnp.asarray(t.byte_to_cls.astype(np.int32)), jnp.asarray(t.accept),
        jnp.asarray(t.accept_eol), init, t.n_classes)
    return {
        "sa": sa, "fdr_ep": fdr,
        "k1": (_as_words(scan_jnp._pack_lane_bits(match)).numpy(),
               np.asarray(final), int(np.count_nonzero(np.asarray(match)))),
        "lines_sa": RefEngine("needle", backend="cpu").scan(
            data).matched_lines.tolist(),
        "lines_ep": RefEngine(patterns=rank_mod.SET, backend="cpu").scan(
            data).matched_lines.tolist(),
    }


def test_two_gloo_ranks_equal_one_process_and_the_reference(tmp_path):
    """Two real ranks, two ``cpu`` entries each: the sharded Shift-And,
    the pattern-axis FDR step (its OR crossing the ranks), K1's step
    (words, total, exit states and the ring's neighbour states) and two
    engine scans give, in each rank, what one process gives on the same
    mesh and what the reference gives on one device."""
    rcs, errs, outs, _s = _spawn_ranks(tmp_path)
    assert rcs == [0, 0], errs
    one = rank_mod.run(
        make_mesh((2, 2), ("data", "seq"), devices=["cpu"] * 4),
        make_mesh((2, 2), ("seq", "data"), devices=["cpu"] * 4))
    arr = rank_mod.columns()
    ref = _reference(arr, rank_mod.text())
    for path in outs:
        got = torch.load(path, weights_only=False)
        assert got["ranks"] == [[0, 0], [1, 1]]
        for key in ("sa", "fdr_ep"):
            words, total = got[key]
            assert torch.equal(words, one[key][0])
            assert int(total) == int(one[key][1])
            np.testing.assert_array_equal(words.numpy(), ref[key])
            assert int(total) == int(np.count_nonzero(ref[key])) > 0
        for mine, theirs in zip(got["k1"], one["k1"]):
            assert torch.equal(mine, theirs)
        words, total, exits, neigh = got["k1"]
        want_words, want_final, want_count = ref["k1"]
        np.testing.assert_array_equal(words.numpy(), want_words)
        np.testing.assert_array_equal(exits.numpy(), want_final)
        assert int(total) == want_count > 0
        local = exits.shape[0] // 4
        np.testing.assert_array_equal(
            neigh.numpy(), np.roll(exits.numpy()[local - 1::local], 1))
        for key in ("lines_sa", "lines_ep"):
            assert got[key] == one[key] == ref[key] and got[key]


def test_a_failing_rank_fails_the_other_within_the_timeout(tmp_path):
    """Rank 1's kernel raises before its first collective: both ranks exit
    nonzero, rank 0 on the collective it waited in, well inside the
    group's timeout; nothing is retried or run on the host instead."""
    rcs, errs, outs, seconds = _spawn_ranks(tmp_path, "fail")
    assert rcs[0] != 0 and rcs[1] != 0
    assert "rank 1's kernel failed" in errs[1]
    assert not outs[0].exists() and not outs[1].exists()
    assert seconds < rank_mod.TIMEOUT_S + 15
