"""The mesh and the device list of the port (distributed_grep_tpu_torch/
parallel/ and the engine's ``devices``, ``mesh`` and ``mesh_axis``), on a
mesh of eight ``torch.device("cpu")`` entries: the counterpart of the
reference's ``mesh8`` over eight forced host devices
(tests/test_parallel.py).

The reference's mesh path cannot run in this container (ROADMAP.md C3:
its ``shard_map`` raises), so the oracle is the reference's single-device
output: its Pallas kernels in interpret mode and its XLA DFA scan, as its
own tests run them, mapped to the port's (chunk // 32, lanes) words, and
its host engine and Python ``re`` for lines.  The tolerance is zero:
words bit for bit, lines and counts exactly.  The kernel comparisons run
at 512 x 4096 bytes, the reference kernels' smallest tile; the engine
checks at a few KiB.
"""

import re
import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_grep_tpu.models import aho as ref_aho
from distributed_grep_tpu.models import approx as ref_ax
from distributed_grep_tpu.models import dfa as ref_dfa
from distributed_grep_tpu.models import fdr as ref_fdr
from distributed_grep_tpu.models import nfa as ref_nfa
from distributed_grep_tpu.models import pairset as ref_ps
from distributed_grep_tpu.models import shift_and as ref_sa
from distributed_grep_tpu.ops import scan_jnp
from distributed_grep_tpu.ops.engine import GrepEngine as RefEngine
from distributed_grep_tpu_torch.models import aho as port_aho
from distributed_grep_tpu_torch.models import approx as port_ax
from distributed_grep_tpu_torch.models import dfa as port_dfa
from distributed_grep_tpu_torch.models import fdr as port_fdr
from distributed_grep_tpu_torch.models import nfa as port_nfa
from distributed_grep_tpu_torch.models import pairset as port_ps
from distributed_grep_tpu_torch.models import shift_and as port_sa
from distributed_grep_tpu_torch.ops import cuda_scan, engine as engine_mod
from distributed_grep_tpu_torch.ops import lines as lines_mod
from distributed_grep_tpu_torch.ops.engine import GrepEngine
from distributed_grep_tpu_torch.ops.fdr_scan import pack_bits
from distributed_grep_tpu_torch.ops.layout import choose_layout, padded_stripes
from distributed_grep_tpu_torch.ops.scan_torch import sparse_nonzero
from distributed_grep_tpu_torch.ops.sparse import offsets_from_sparse_words
from distributed_grep_tpu_torch.parallel import sharded_kernels as sk
from distributed_grep_tpu_torch.parallel.mesh import lane_sharding, make_mesh
from distributed_grep_tpu_torch.parallel.sharded_scan import (
    popcount,
    sharded_grep_step,
)

CPU8 = ["cpu"] * 8
SMALL = {"device": "cpu", "target_lanes": 256, "min_chunk": 32}


@pytest.fixture(scope="module")
def mesh8():
    return make_mesh((8,), ("data",), devices=CPU8)


def make_text(n_lines=400, seed=11, inject=()):
    """The reference's recipe (tests/test_parallel.py make_text)."""
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(n_lines):
        n = int(rng.integers(0, 60))
        lines.append(bytes(rng.choice(list(b"abcdef gh"), size=n).tolist()))
    for pos, text in inject:
        lines[pos] = text
    return b"\n".join(lines) + b"\n"


def _stripes_of(data: bytes, n_entries: int):
    lay = choose_layout(len(data), target_lanes=32 * n_entries, min_chunk=8,
                        lane_multiple=32 * n_entries, chunk_multiple=32)
    return lay, torch.from_numpy(padded_stripes(data, lay).copy())


def _as_words(packed) -> torch.Tensor:
    """The reference's (chunk, lanes // 8) packed bits as the port's
    words."""
    bits = np.unpackbits(np.asarray(packed), axis=1,
                         bitorder="little").astype(bool)
    return pack_bits(torch.from_numpy(bits))


def _ref_dfa(data_cl: np.ndarray, pattern: str):
    """The reference's single-device XLA DFA scan: (words, final states,
    matched-position count)."""
    t = ref_dfa.compile_dfa(pattern)
    init = jnp.full((data_cl.shape[1],), t.start, dtype=jnp.int32)
    final, match = scan_jnp.dfa_scan_body(
        jnp.asarray(data_cl), jnp.asarray(t.trans.astype(np.int32).reshape(-1)),
        jnp.asarray(t.byte_to_cls.astype(np.int32)), jnp.asarray(t.accept),
        jnp.asarray(t.accept_eol), init, t.n_classes)
    return (_as_words(scan_jnp._pack_lane_bits(match)), np.asarray(final),
            int(np.count_nonzero(np.asarray(match))))


def _oracle_lines(data: bytes, rx: bytes) -> set[int]:
    return {i for i, ln in enumerate(data.split(b"\n")[:-1], 1)
            if re.search(rx, ln)}


def _stitched_lines(data, lay, words, rx: bytes) -> set[int]:
    """Lines of exact words, every line holding a stripe start given the
    host verdict (the engine's replacing stitch)."""
    idx, vals = sparse_nonzero(words)
    nl = lines_mod.newline_index(data)
    got = lines_mod.unique_match_lines(
        offsets_from_sparse_words(idx, vals, lay), nl)
    sus = lines_mod.boundary_lines(lay.stripe_starts(), nl, len(data))
    ls, le = lines_mod.line_spans(sus, nl, len(data))
    ver = [re.search(rx, data[a:b]) is not None
           for a, b in zip(ls.tolist(), le.tolist())]
    return set(lines_mod.stitch_lines(got, sus, ver).tolist())


# ------------------------------------------- the table-DFA step (K1)

def test_sharded_scan_matches_host_oracle(mesh8):
    data = make_text(inject=[(7, b"a needle here"), (390, b"needle again")])
    lay, st = _stripes_of(data, 8)
    words, total, exits, neigh = sharded_grep_step(
        st, port_dfa.compile_dfa("needle"), mesh8)
    want, final, count = _ref_dfa(st.numpy().T.copy(), "needle")
    assert torch.equal(words, want)
    assert np.array_equal(exits.numpy(), final)
    assert int(total) == count == int(popcount(words))
    assert _stitched_lines(data, lay, words, b"needle") == _oracle_lines(
        data, b"needle")


def test_sharded_scan_collectives_shapes(mesh8):
    data = make_text(100)
    lay, st = _stripes_of(data, 8)
    words, total, exits, neigh = sharded_grep_step(
        st, port_dfa.compile_dfa("abc"), mesh8)
    assert exits.shape == (lay.lanes,) and exits.dtype == torch.int32
    assert neigh.shape == (8,)  # every entry received one neighbour state
    assert words.shape == (lay.chunk // 32, lay.lanes)


def test_mesh_helpers(monkeypatch):
    m = make_mesh(devices=CPU8)
    assert m.size == 8 and m.shape == {"data": 8} and m.cards == 1
    m2 = make_mesh((4, 2), ("data", "seq"), devices=CPU8)
    assert m2.shape == {"data": 4, "seq": 2}
    with pytest.raises(ValueError, match="needs 16 devices, have 8"):
        make_mesh((16,), ("data",), devices=CPU8)
    with pytest.raises(ValueError, match="mesh_axis"):
        lane_sharding(m2, "bogus")
    assert lane_sharding(m2, "seq").n == 2
    assert lane_sharding(m2, ("data", "seq")).n == 8
    assert sk.mesh_lane_multiple(m2, "data") == 4 * sk.LANE_TILE
    assert sk.mesh_lane_multiple(m2, "data", swar=True) == 4 * 128
    # every local card by default: none here, and no fallback to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cuda'"):
        make_mesh()
    with pytest.raises(RuntimeError, match="device='cuda'"):
        GrepEngine("needle", devices="all")


def test_two_axis_mesh_scan():
    """Lanes over 'seq' alone of a (4, 2) mesh: two blocks, each run
    once; exact after the stitch, the words the single device's."""
    mesh = make_mesh((4, 2), ("data", "seq"), devices=CPU8)
    data = make_text(200, inject=[(50, b"the needle sits here")])
    lay, st = _stripes_of(data, 8)
    words, total, _exits, neigh = sharded_grep_step(
        st, port_dfa.compile_dfa("needle"), mesh, axis="seq")
    assert neigh.shape == (2,)
    assert torch.equal(words, _ref_dfa(st.numpy().T.copy(), "needle")[0])
    assert _stitched_lines(data, lay, words, b"needle") == _oracle_lines(
        data, b"needle")


def test_product_axis_sharding_uses_all_devices():
    """axis=("data", "seq"): eight blocks, data-major; the ring wraps over
    that linear order: entry d receives entry (d - 1) % 8's last lane's
    exit state."""
    mesh = make_mesh((4, 2), ("data", "seq"), devices=CPU8)
    data = make_text(300, inject=[(13, b"needle one"), (250, b"two needle")])
    lay, st = _stripes_of(data, 8)
    words, total, exits, neigh = sharded_grep_step(
        st, port_dfa.compile_dfa("needle"), mesh, axis=("data", "seq"))
    entries = sk.prepare_tiles(st, mesh, ("data", "seq"))
    assert {e["stripes"].shape for e in entries} == {(lay.lanes // 8,
                                                      lay.chunk)}
    local = lay.lanes // 8
    np.testing.assert_array_equal(neigh.numpy(),
                                  np.roll(exits.numpy()[local - 1::local], 1))
    assert _stitched_lines(data, lay, words, b"needle") == _oracle_lines(
        data, b"needle")
    idx, vals = sparse_nonzero(words)
    assert int(total) == offsets_from_sparse_words(idx, vals, lay).size


# ---------------------------------------- the ported kernels over a mesh

def _columns(seed: int, inject=(b"needle", b"neeeedle", b"nedle")):
    """(512, 4096) columns of seeded text with matches planted, some
    across word edges (the reference kernels' smallest tile)."""
    rng = np.random.default_rng(seed)
    arr = rng.choice(np.frombuffer(b"abcdefgh \nzq", np.uint8),
                     size=(512, 4096))
    for i, s in enumerate(inject):
        sb = np.frombuffer(s, np.uint8)
        arr[29:29 + len(sb), i::61] = sb[:, None]
        arr[200:200 + len(sb), 3 + i::97] = sb[:, None]
    return arr


def _st(arr):
    return torch.from_numpy(np.ascontiguousarray(arr.T))


def _check(words, total, want: np.ndarray):
    np.testing.assert_array_equal(words.numpy(), want)
    assert int(total) == int(np.count_nonzero(want))
    assert want.any()


def test_sharded_shift_and_bit_identical(mesh8):
    from distributed_grep_tpu.ops import pallas_scan

    arr = _columns(1)
    for coarse in (True, False):
        ref = np.asarray(pallas_scan.shift_and_scan_words(
            arr, ref_sa.try_compile_shift_and("needle"), interpret=True,
            coarse=coarse)).reshape(512 // 32, 4096)
        words, total = sk.sharded_shift_and_words(
            _st(arr), port_sa.try_compile_shift_and("needle"), mesh8,
            coarse=coarse)
        _check(words, total, ref)
    # SWAR (DGREP_SWAR=1): 512 lanes an entry, a multiple of 128
    ref = np.asarray(pallas_scan.swar_shift_and_scan_words(
        np.concatenate([arr] * 4, axis=1),
        ref_sa.try_compile_shift_and("needle"), interpret=True)
    ).reshape(512 // 32, 4096)
    words, total = sk.sharded_shift_and_words(
        _st(np.concatenate([arr] * 4, axis=1)),
        port_sa.try_compile_shift_and("needle"), mesh8, swar=True)
    _check(words, total, ref)


def test_sharded_nfa_bit_identical(mesh8):
    from distributed_grep_tpu.ops import pallas_nfa

    arr = _columns(2)
    ref_m = ref_nfa.try_compile_glushkov("ne+dle")
    port_m = port_nfa.try_compile_glushkov("ne+dle")
    ref = np.asarray(pallas_nfa.nfa_scan_words(arr, ref_m, interpret=True)
                     ).reshape(512 // 32, 4096)
    words, total = sk.sharded_nfa_words(_st(arr), port_m, mesh8)
    _check(words, total, ref)


def test_sharded_fdr_bit_identical(mesh8):
    from distributed_grep_tpu.ops import pallas_fdr

    rng = np.random.default_rng(17)
    pats = [b"needle", b"zebra", b"volcano"] + [
        bytes(rng.choice(list(b"abcdefgh"), size=6).tolist())
        for _ in range(40)]
    arr = _columns(3, inject=(b"needle", pats[5], pats[9]))
    ref_model, port_model = ref_fdr.compile_fdr(pats), port_fdr.compile_fdr(pats)
    ref = None
    for bank in ref_model.banks:
        w = np.asarray(pallas_fdr.fdr_scan_words(arr, bank, interpret=True)
                       ).reshape(512 // 32, 4096)
        ref = w if ref is None else ref | w
    words, total = sk.sharded_fdr_words(_st(arr), port_model, mesh8)
    _check(words, total, ref)


def test_sharded_pairset_bit_identical(mesh8):
    from distributed_grep_tpu.ops import pallas_pairset

    arr = _columns(4, inject=(b"zq", b"ab", b"h\n"))
    members = [b"zq", b"ab", b"h"]
    ref = np.asarray(pallas_pairset.pairset_scan_words(
        arr, ref_ps.compile_pairset(members), interpret=True)
    ).reshape(512 // 32, 4096)
    words, total = sk.sharded_pairset_words(
        _st(arr), port_ps.compile_pairset(members), mesh8)
    _check(words, total, ref)


def test_sharded_approx_bit_identical_and_engine_mesh(mesh8):
    from distributed_grep_tpu.ops import pallas_approx

    arr = _columns(5)
    ref = np.asarray(pallas_approx.approx_scan_words(
        arr, ref_ax.try_compile_approx("needle", 1), interpret=True)
    ).reshape(512 // 32, 4096)
    words, total = sk.sharded_approx_words(
        _st(arr), port_ax.try_compile_approx("needle", 1), mesh8)
    _check(words, total, ref)

    data = make_text(400, inject=[(5, b"a needle"), (300, b"nedle x"),
                                  (350, b"nXedle")])
    eng = GrepEngine("needle", max_errors=1, mesh=mesh8, **SMALL)
    res = eng.scan(data)
    want = RefEngine("needle", max_errors=1, backend="cpu").scan(data)
    assert res.matched_lines.tolist() == want.matched_lines.tolist()
    assert {5 + 1, 300 + 1, 350 + 1} <= set(res.matched_lines.tolist())
    assert eng.stats.get("psum_candidates", 0) >= 1


# ------------------------------------------------------------ the engine

def _engine_text():
    rng = np.random.default_rng(23)
    lines = []
    for i in range(700):
        n = int(rng.integers(0, 60))
        lines.append(bytes(rng.choice(list(b"abcdefg h"), size=n).tolist()))
        if i % 37 == 5:
            lines[-1] = b"xx needle yy"
        if i % 53 == 9:
            lines[-1] = b"neeeedle and needles"
    return b"\n".join(lines) + b"\n"


SET8 = ["needle", "zebra", "volcano", "abcdef", "fedcba", "gabhcd", "hhfgab",
        "deadbe"]


def test_engine_mesh_mode_exact(mesh8):
    """GrepEngine(mesh=...) on every sharded kernel family: the lines of
    the reference's single-device engine and of re, the words' count
    summed over the entries (``psum_candidates``)."""
    data = _engine_text()
    cases = {
        "shift_and": (dict(pattern="needle"), b"needle"),
        "nfa": (dict(pattern="ne+dle"), b"ne+dle"),
        "fdr": (dict(patterns=SET8), "|".join(SET8).encode()),
        "pairset": (dict(patterns=["zq", "gh"]), b"zq|gh"),
    }
    for want_mode, (kw, rx) in cases.items():
        eng = GrepEngine(mesh=mesh8, **kw, **SMALL)
        assert eng.mode == want_mode and eng.device.type == "cpu"
        res = eng.scan(data)
        ref = RefEngine(backend="cpu", **kw).scan(data)
        assert res.matched_lines.tolist() == ref.matched_lines.tolist()
        assert set(res.matched_lines.tolist()) == _oracle_lines(data, rx)
        assert eng.stats.get("psum_candidates", 0) >= 1, want_mode
        # the single-device engine's words: the same count
        one = GrepEngine(**kw, **SMALL)
        one.scan(data)
        assert one.stats["segments"] == eng.stats["segments"]


def test_engine_mesh_multi_segment(mesh8):
    data = make_text(2000, inject=[(5, b"needle a"), (700, b"a needle"),
                                   (1300, b"needle"), (1990, b"z needle")])
    eng = GrepEngine("needle", mesh=mesh8, segment_bytes=16 * 1024, **SMALL)
    res = eng.scan(data)
    assert set(res.matched_lines.tolist()) == _oracle_lines(data, b"needle")
    assert eng.stats["segments"] >= 2
    assert eng.stats.get("psum_candidates", 0) >= 2


def test_engine_mesh_axis_validation(mesh8, tmp_path):
    """Bad axis names fail at construction; a good pattern axis runs: the
    app option's job gives the single-device job's mr-out files."""
    from distributed_grep_tpu_torch.apps import grep_cuda
    from distributed_grep_tpu_torch.apps.loader import from_module
    from distributed_grep_tpu_torch.runtime.job import run_job
    from distributed_grep_tpu_torch.utils.config import JobConfig

    with pytest.raises(ValueError, match="mesh_axis"):
        GrepEngine("needle", mesh=mesh8, mesh_axis="bogus", device="cpu")
    mesh2d = make_mesh((4, 2), ("data", "seq"), devices=CPU8)
    with pytest.raises(ValueError, match="pattern_axis"):
        GrepEngine(patterns=["aa", "bb"], mesh=mesh2d, mesh_axis="data",
                   pattern_axis="typo", device="cpu")
    with pytest.raises(ValueError, match="pattern_axis"):
        GrepEngine(patterns=["aa", "bb"], mesh=mesh2d, mesh_axis="data",
                   pattern_axis="data", device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        GrepEngine("needle", mesh=mesh8, devices=["cpu"], device="cpu")
    eng = GrepEngine(patterns=SET8, mesh=mesh2d, mesh_axis="data",
                     pattern_axis="seq", **SMALL)
    assert eng.pattern_axis == "seq" and eng.mode == "fdr"
    f = tmp_path / "a.txt"
    f.write_bytes(_engine_text())
    outs = {}
    for label, extra in (("one", {}),
                         ("ep", {"mesh_shape": [4, 2],
                                 "mesh_axes": ["data", "seq"],
                                 "pattern_axis": "seq"})):
        res = run_job(JobConfig(
            input_files=[str(f)], n_reduce=3,
            app_options={"patterns": SET8, "device": "cpu",
                         "target_lanes": 256, "min_chunk": 32, **extra},
            work_dir=str(tmp_path / label)), n_workers=1, device="cpu",
            app=from_module(grep_cuda))
        outs[label] = {Path(p).name: Path(p).read_bytes()
                       for p in res.output_files}
    assert outs["one"] == outs["ep"] and any(outs["one"].values())
    assert grep_cuda._engine.pattern_axis == "seq"
    assert grep_cuda._engine.totals.get("psum_candidates", 0) > 0
    with pytest.raises(ValueError, match="no axis left"):
        grep_cuda.card_options("cpu", "all", [2], ["seq"], "seq")


@pytest.mark.parametrize("pattern", ["^$", "x?$", "(ab)*$"])
def test_mesh_engine_routes_dfa(mesh8, pattern):
    """A pattern outside the kernel subset keeps mode "dfa" on a mesh
    engine, as the reference's: K1 on the mesh's first entry, counted in
    ``mesh_unsharded``; the lines equal the host scanner's (mode
    "native" off a mesh) and the reference's."""
    data = make_text(300) + b"\n\nab\nxab\n\n"
    eng = GrepEngine(pattern, mesh=mesh8, **SMALL)
    assert eng.mode == eng.route == "dfa"
    assert GrepEngine(pattern, device="cpu").route == "native"
    res = eng.scan(data)
    assert eng.stats["mesh_unsharded"] is True
    want = RefEngine(pattern, backend="cpu").scan(data)
    assert res.matched_lines.tolist() == want.matched_lines.tolist()
    assert all(isinstance(p, port_dfa.DfaTable) for p in eng.dfa_plans())


def test_dfa_route_takes_k2_where_a_stride_pays(mesh8):
    """The per-table choice (the reference's _device_tables): a table
    without '$' accepts scans by K2, here its plain version, with the
    lines of K1's."""
    data = make_text(300, inject=[(3, b"needle"), (200, b"a needle b")])
    eng = GrepEngine("^$", mesh=mesh8, **SMALL)
    eng.tables = [port_dfa.compile_dfa("needle")]
    eng._nullable_eol = False
    eng._dfa_plans = None
    (plan,) = eng.dfa_plans()
    assert isinstance(plan, port_dfa.StrideTable) and plan.k == 4
    res = eng.scan(data)
    assert set(res.matched_lines.tolist()) == _oracle_lines(data, b"needle")


def test_device_list_round_robin_equals_one_device():
    """``devices``: segments round-robin over the list (three host entries
    here), each device its own prepare slot; the lines equal one
    device's."""
    data = make_text(3000, inject=[(5, b"needle a"), (2990, b"z needle")])
    kw = dict(segment_bytes=8 * 1024, **SMALL)
    for pattern in ("needle", "ne+dle"):
        one = GrepEngine(pattern, **kw).scan(data)
        eng = GrepEngine(pattern, devices=["cpu", "cpu", "cpu"], **kw)
        assert len(eng.devices) == 3
        res = eng.scan(data)
        assert res.matched_lines.tolist() == one.matched_lines.tolist()
        assert eng.stats["segments"] >= 6


def test_confirms_overlap_across_device_segments(monkeypatch):
    """With several devices in flight, FDR confirms of different segments
    run concurrently on the collect pool, and the result stays exact."""
    rng = np.random.default_rng(31)
    alphabet = list(b"abcdefghijklmnopqrstuvwxyz0123456789")
    pats = sorted({bytes(rng.choice(alphabet, size=int(rng.integers(5, 9)))
                         .tolist()) for _ in range(200)})
    lines = []
    for i in range(4000):
        n = int(rng.integers(0, 50))
        lines.append(bytes(rng.choice(alphabet + [32], size=n).tolist()))
        if i % 41 == 3:
            lines[-1] = b"xx " + pats[int(rng.integers(0, len(pats)))] + b" yy"
    data = b"\n".join(lines) + b"\n"
    eng = GrepEngine(patterns=[p.decode() for p in pats],
                     devices=["cpu"] * 4, segment_bytes=16 * 1024, **SMALL)
    assert eng.mode == "fdr"
    assert len(data) // (16 * 1024) >= 4
    real = eng.confirm.confirm
    gate = threading.Event()
    lock = threading.Lock()
    calls = [0]

    def slow_confirm(buf, ends):
        with lock:
            calls[0] += 1
            first = calls[0] == 1
        if first:  # held open until a second confirm enters
            gate.wait(timeout=10)
        else:
            gate.set()
        return real(buf, ends)

    monkeypatch.setattr(eng.confirm, "confirm", slow_confirm)
    res = eng.scan(data)
    expected = {i for i, ln in enumerate(data.split(b"\n")[:-1], 1)
                if any(p in ln for p in pats)}
    assert set(res.matched_lines.tolist()) == expected
    assert eng.stats.get("confirm_concurrency_peak", 0) >= 2


def test_a_failing_entry_fails_the_scan(mesh8, monkeypatch):
    """A kernel that fails on one entry fails the scan: nothing is retried
    on another entry or on the host (ROADMAP.md D5)."""
    real = cuda_scan.shift_and_scan_words
    calls = [0]

    def flaky(data, model, coarse=True):
        calls[0] += 1
        if calls[0] == 3:
            raise RuntimeError("entry 3 failed")
        return real(data, model, coarse)

    monkeypatch.setattr(cuda_scan, "shift_and_scan_words", flaky)
    eng = GrepEngine("needle", mesh=mesh8, **SMALL)
    with pytest.raises(RuntimeError, match="entry 3 failed"):
        eng.scan(_engine_text())
    assert calls[0] == 3


def test_cached_engine_keys_all_by_its_cards():
    engine_mod.model_cache_clear()
    try:
        a, v1 = engine_mod.cached_engine("needle", device="cpu",
                                         devices="all")
        b, v2 = engine_mod.cached_engine("needle", device="cpu",
                                         devices="all")
        assert (v1, v2) == ("miss", "hit") and a is b
        assert [d.type for d in a.devices] == ["cpu"]
        _c, v3 = engine_mod.cached_engine("needle", device="cpu",
                                          devices=["cpu", "cpu"])
        mesh = make_mesh((2,), devices=["cpu", "cpu"])
        _d, v4 = engine_mod.cached_engine("needle", device="cpu", mesh=mesh)
        assert (v3, v4) == ("off", "off")
    finally:
        engine_mod.model_cache_clear()


def test_job_config_mesh_fields_reach_the_engine(tmp_path):
    """JobConfig's mesh fields merge into the app options and reach the
    engine (a mesh of two host entries on device "cpu"), the job's
    mr-out equal to the one-device job's; to_json still leaves them out
    at their defaults."""
    import json

    from distributed_grep_tpu_torch.apps import grep_cuda
    from distributed_grep_tpu_torch.apps.loader import from_module
    from distributed_grep_tpu_torch.runtime.job import run_job
    from distributed_grep_tpu_torch.utils.config import JobConfig

    f = tmp_path / "a.txt"
    f.write_bytes(make_text(600, inject=[(3, b"needle"), (500, b"a needle")]))
    outs = {}
    for label, extra in (("one", {}), ("mesh", {"mesh_shape": (2,),
                                                "mesh_axes": ("data",)})):
        cfg = JobConfig(input_files=[str(f)],
                        app_options={"pattern": "needle", "device": "cpu",
                                     "target_lanes": 64, "min_chunk": 32},
                        work_dir=str(tmp_path / label), **extra)
        if extra:
            assert cfg.effective_app_options()["mesh_shape"] == [2]
        res = run_job(cfg, n_workers=1, device="cpu",
                      app=from_module(grep_cuda))
        outs[label] = {Path(p).name: Path(p).read_bytes()
                       for p in res.output_files}
        mesh = grep_cuda._engine.mesh
        assert (mesh is not None and mesh.size == 2) == bool(extra)
    assert outs["one"] == outs["mesh"] and any(outs["one"].values())
    doc = json.loads(JobConfig(input_files=[str(f)]).to_json())
    assert "mesh_shape" not in doc and "mesh_axes" not in doc


# ------------------------------------------------------- the pattern axis

def _quarters_model(pats, ref: bool, ignore_case: bool = False):
    """``pats`` in four quarters (members i::4) compiled apart, their banks
    in one model: same-plan banks, as config 3's quarters give."""
    mod = ref_fdr if ref else port_fdr
    banks = [b for i in range(4) for b in mod.compile_fdr(
        pats[i::4], ignore_case=ignore_case).banks]
    return mod.FdrModel(banks=banks, ignore_case=ignore_case,
                        n_patterns=len(pats))


def _set_pats(seed=17, n=40):
    rng = np.random.default_rng(seed)
    return [b"needle", b"zebra", b"volcano"] + [
        bytes(rng.choice(list(b"abcdefgh"), size=6).tolist())
        for _ in range(n)]


def test_stack_bank_tables_equals_the_references():
    from distributed_grep_tpu.parallel.sharded_scan import (
        stack_bank_tables as ref_stack,
    )
    from distributed_grep_tpu_torch.parallel.sharded_scan import (
        stack_bank_tables,
    )

    members = [[b"needle"], [b"xx", b"zebra"], [b"volcano", b"ash", b"a"]]
    ref_t = [ref_aho.compile_aho_corasick(m) for m in members]
    port_t = [port_aho.compile_aho_corasick(m) for m in members]
    for n_shards in (1, 2, 4):
        want = ref_stack(ref_t, n_shards)
        got = stack_bank_tables(port_t, n_shards)
        assert got[-1] == want[-1]
        for g, w in zip(got[:-1], want[:-1]):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    eol = port_dfa.compile_dfa("x$")
    assert eol.accept_eol.any()
    with pytest.raises(ValueError, match="accept_eol"):
        stack_bank_tables([eol], 2)
    with pytest.raises(ValueError, match="accept_eol"):
        ref_stack([ref_dfa.compile_dfa("x$")], 2)


@pytest.mark.parametrize("shape,axes", [((4, 2), ("data", "seq")),
                                        ((2, 4), ("data", "seq")),
                                        ((2, 2, 2), ("data", "seq", "x"))])
def test_sharded_fdr_pattern_step_bit_identical(shape, axes):
    """Four same-plan banks over a pattern axis of 2 or 4 (and a mesh with
    a third axis, at its index 0): the words are the reference's
    single-device OR of every bank, bit for bit, the total the nonzero
    words of that plane; one bank over the same axis leaves entries with
    no bank."""
    from distributed_grep_tpu.ops import pallas_fdr

    mesh = make_mesh(shape, axes, devices=CPU8)
    pats = _set_pats()
    arr = _columns(3, inject=(b"needle", pats[5], pats[9]))
    ref_model, port_model = _quarters_model(pats, True), _quarters_model(
        pats, False)
    assert len(port_model.banks) == 4
    assert len({sk.bank_plan(b) for b in port_model.banks}) == 1
    ref = None
    for bank in ref_model.banks:
        w = np.asarray(pallas_fdr.fdr_scan_words(arr, bank, interpret=True)
                       ).reshape(512 // 32, 4096)
        ref = w if ref is None else ref | w
    words, total = sk.sharded_fdr_pattern_step(
        _st(arr), port_model, mesh, data_axis="data", pattern_axis="seq")
    _check(words, total, ref)
    tabs = sk.fdr_pattern_tables(port_model, mesh, "seq")
    assert [len(r) for r in tabs] == (
        [2, 2] if mesh.shape["seq"] == 2 else [1, 1, 1, 1])
    one = port_fdr.FdrModel(banks=port_model.banks[:1], ignore_case=False,
                            n_patterns=1)
    words1, _ = sk.sharded_fdr_pattern_step(_st(arr), one, mesh, "data",
                                            "seq")
    want1 = np.asarray(pallas_fdr.fdr_scan_words(
        arr, ref_model.banks[0], interpret=True)).reshape(512 // 32, 4096)
    np.testing.assert_array_equal(words1.numpy(), want1)


def test_sharded_fdr_pattern_step_refuses_mixed_plans():
    mesh = make_mesh((4, 2), ("data", "seq"), devices=CPU8)
    model = port_fdr.compile_fdr(_mixed_pats())
    assert len({sk.bank_plan(b) for b in model.banks}) == 2
    with pytest.raises(ValueError, match="same-plan banks"):
        sk.sharded_fdr_pattern_step(_st(_columns(3)), model, mesh)


def test_sharded_pattern_set_step_equals_the_references_banks():
    """Three Aho-Corasick banks over the pattern axis on K1: the matched
    positions are the reference's ``dfa_scan_body`` per bank, OR'd (its
    mesh path cannot be the oracle here: C3); the count is their
    number."""
    from distributed_grep_tpu_torch.parallel.sharded_scan import (
        sharded_pattern_set_step,
    )

    members = [[b"needle"], [b"zq", b"abc"], [b"hgf", b"dd"]]
    arr = _columns(6)
    want = None
    for m in members:
        t = ref_aho.compile_aho_corasick(m)
        init = jnp.full((arr.shape[1],), t.start, dtype=jnp.int32)
        _f, match = scan_jnp.dfa_scan_body(
            jnp.asarray(arr),
            jnp.asarray(t.trans.astype(np.int32).reshape(-1)),
            jnp.asarray(t.byte_to_cls.astype(np.int32)),
            jnp.asarray(t.accept), jnp.asarray(t.accept_eol), init,
            t.n_classes)
        match = np.asarray(match)
        want = match if want is None else want | match
    tables = [port_aho.compile_aho_corasick(m) for m in members]
    for shape in ((4, 2), (2, 4)):
        mesh = make_mesh(shape, ("data", "seq"), devices=CPU8)
        words, total = sharded_pattern_set_step(_st(arr), tables, mesh)
        np.testing.assert_array_equal(words.numpy(),
                                      pack_bits(torch.from_numpy(want)).numpy())
        assert int(total) == int(want.sum()) > 0


def _mixed_pats():
    """400 members of 2-15 bytes: two banks of two plans (m 1 and 3)."""
    rng = np.random.default_rng(1)
    al = list(b"abcdefghijklmnopqrstuvwxyz")
    return sorted({bytes(rng.choice(al, size=int(rng.integers(2, 16)))
                         .tolist()) for _ in range(400)})


def _ep_text(pats, seed=41):
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(1500):
        n = int(rng.integers(0, 50))
        lines.append(bytes(rng.choice(list(b"abcdefghij klmnopq"),
                                      size=n).tolist()))
        if i % 29 == 3:
            lines[-1] = b"xx " + pats[int(rng.integers(0, len(pats)))] + b" y"
        if i % 71 == 8:
            lines[-1] = b"#"
    return b"\n".join(lines) + b"\n"


@pytest.mark.parametrize("case", ["quarters", "sidecar", "mixed", "fold"])
def test_engine_pattern_axis_lines(case, caplog):
    """GrepEngine(mesh 4 x 2, mesh_axis="data", pattern_axis="seq"): same-
    plan banks (a set's quarters) over the pattern axis; a set with a
    1-byte member, whose pairset sidecar is OR'd in lane-sharded; a
    mixed-plan set, which logs the reference's line and shards lanes
    alone; and -i.  The lines are the reference host engine's, re's and
    the one-device engine's."""
    mesh = make_mesh((4, 2), ("data", "seq"), devices=CPU8)
    pats = _set_pats(23, 60)
    ignore_case = case == "fold"
    if case == "mixed":
        pats = _mixed_pats()
    elif case == "sidecar":
        pats = pats + [b"#"]
    data = _ep_text(pats)
    if ignore_case:
        data = data.replace(b"needle", b"NeEdLe")
    members = [p.decode() for p in pats]
    kw = dict(segment_bytes=16 * 1024, ignore_case=ignore_case, **SMALL)
    eng = GrepEngine(patterns=members, mesh=mesh, mesh_axis="data",
                     pattern_axis="seq", **kw)
    assert eng.mode == "fdr"
    assert (eng.fdr_pairset is not None) == (case == "sidecar")
    if case in ("quarters", "fold"):
        eng.fdr = _quarters_model(pats, False, ignore_case)
        assert len({sk.bank_plan(b) for b in eng.fdr.banks}) == 1
    with caplog.at_level("INFO", "distributed_grep_tpu_torch.device_scan"):
        res = eng.scan(data)
    mixed_line = "mixed-plan FDR banks: pattern-parallel sharding unavailable"
    assert (mixed_line in caplog.text) == (case == "mixed")
    got = res.matched_lines.tolist()
    ref = RefEngine(patterns=members, ignore_case=ignore_case,
                    backend="cpu").scan(data)
    assert got == ref.matched_lines.tolist() and got
    flags = re.I if ignore_case else 0
    rx = re.compile(b"|".join(re.escape(p) for p in pats), flags)
    assert set(got) == {i for i, ln in enumerate(data.split(b"\n")[:-1], 1)
                        if rx.search(ln)}
    one = GrepEngine(patterns=members, **kw).scan(data)
    assert got == one.matched_lines.tolist()
    assert eng.stats["psum_candidates"] >= 1 and eng.stats["segments"] >= 2
    assert eng._fdr_ep_dev_tables is not None or case == "mixed"
