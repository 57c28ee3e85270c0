"""The port's entry points for a compile check and a multi-card dry run
(the counterparts of the repository's ``__graft_entry__.py``).

``entry(device)`` -> (fn, example_args): the flagship forward step, K1
                     (csrc/dfa.cu) over a stripe layout of the example
                     document, the Map-side compute of the grep app.
``dryrun_multichip(n_devices, devices)`` -> the OK line: an n-entry
                     mesh, the sharded grep step (lanes over the mesh,
                     the summed match count, the ring of exit states),
                     every mesh kernel family through the engine against
                     a host oracle, and on a two-axis mesh the pattern
                     axis: Aho-Corasick banks on K1 and same-plan FDR
                     banks, the latter bit for bit one device's OR.

Both run on the card unless given ``cpu`` devices; ``devices`` may name
one card more than once (four entries of ``cuda:0`` on a host of one
card).
"""

from __future__ import annotations

import re

import numpy as np
import torch


def _example_doc(n_lines: int = 300, seed: int = 0) -> bytes:
    """The reference's example document, byte for byte."""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n_lines):
        n = int(rng.integers(0, 60))
        lines.append(bytes(rng.choice(list(b"abcdefg h"), size=n).tolist()))
        if i % 50 == 7:
            lines[-1] = b"xx needle yy"
        elif i % 50 == 17:
            lines[-1] = b"ends with needle"  # a true '$'-anchor hit
    return b"\n".join(lines) + b"\n"


def _stripes(data: bytes, lanes: int, min_chunk: int,
             device) -> tuple[object, torch.Tensor]:
    from distributed_grep_tpu_torch.ops.layout import (
        choose_layout,
        padded_stripes,
    )

    lay = choose_layout(len(data), target_lanes=lanes, min_chunk=min_chunk,
                        lane_multiple=lanes, chunk_multiple=32)
    st = torch.from_numpy(padded_stripes(data, lay).copy()).to(device)
    return lay, st


def entry(device: str | torch.device = "cuda"):
    """(fn, example_args): ``fn(stripes)`` is K1's match-end words of
    'nee(dle|t)' over the example document's (lanes, chunk) stripes, the
    example tensor on ``device``."""
    from distributed_grep_tpu_torch.models.dfa import compile_dfa
    from distributed_grep_tpu_torch.ops import dfa_scan
    from distributed_grep_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    table = compile_dfa("nee(dle|t)")
    _lay, st = _stripes(_example_doc(), 64, 64, dev)

    def fn(stripes: torch.Tensor) -> torch.Tensor:
        return dfa_scan.dfa_scan_words(stripes, table)

    return fn, (st,)


def dryrun_multichip(n_devices: int, devices: list | None = None) -> str:
    """Build an ``n_devices``-entry mesh over ``devices`` (None: every
    local card), run the reference's dry-run checks on it and print (and
    return) its one OK line; any failed check raises."""
    from distributed_grep_tpu_torch.models.aho import compile_aho_corasick
    from distributed_grep_tpu_torch.models.approx import (
        line_matches,
        try_compile_approx,
    )
    from distributed_grep_tpu_torch.models.dfa import (
        compile_dfa,
        expand_posix_classes,
    )
    from distributed_grep_tpu_torch.models.fdr import FdrModel, compile_fdr
    from distributed_grep_tpu_torch.ops import fdr_scan
    from distributed_grep_tpu_torch.ops.engine import GrepEngine
    from distributed_grep_tpu_torch.ops.fdr_scan import or_into
    from distributed_grep_tpu_torch.parallel import sharded_kernels as shk
    from distributed_grep_tpu_torch.parallel.mesh import (
        local_devices,
        make_mesh,
    )
    from distributed_grep_tpu_torch.parallel.sharded_scan import (
        sharded_grep_step,
        sharded_pattern_set_step,
    )

    devs = list(devices) if devices is not None else local_devices("cuda")
    if len(devs) < n_devices:
        raise ValueError(f"need {n_devices} devices, have {len(devs)}")
    # lanes over the ('data', 'seq') product where the count allows: every
    # entry holds distinct stripes, the count sums over both axes and the
    # ring rides their linear order
    if n_devices >= 4 and n_devices % 2 == 0:
        mesh = make_mesh((n_devices // 2, 2), ("data", "seq"),
                         devices=devs[:n_devices])
        scan_axis: str | tuple = ("data", "seq")
    else:
        mesh = make_mesh((n_devices,), ("data",), devices=devs[:n_devices])
        scan_axis = "data"
    home = mesh.devices.flat[0]

    data = _example_doc()
    lay, st = _stripes(data, shk.mesh_lane_multiple(mesh, scan_axis), 32,
                       home)
    _words, total, exits, _neigh = sharded_grep_step(
        st, compile_dfa("needle"), mesh, axis=scan_axis)
    if int(total) < 1:
        raise RuntimeError("dry run found no matches: scan step broken")
    if tuple(exits.shape) != (lay.lanes,):
        raise RuntimeError(f"exit states {tuple(exits.shape)}, want "
                           f"({lay.lanes},)")

    doc_lines = data.split(b"\n")[:-1]

    def oracle(rx: bytes) -> set[int]:
        pat = re.compile(expand_posix_classes(rx))
        return {i for i, ln in enumerate(doc_lines, 1) if pat.search(ln)}

    # the engine's mesh route on every kernel family, held to the host
    # oracle; device_min_bytes 0 keeps the small document on the kernels
    kw = dict(mesh=mesh, mesh_axis=scan_axis, device_min_bytes=0)
    fdr_pats = ["needle", "zebra", "volcano", "abcdef", "fedcba",
                "gabgab", "hhhhhh", "deadbe"]
    approx_model = try_compile_approx("needle", 1)
    checks = [
        ("needle", GrepEngine("needle", **kw), None),
        ("ne+dle", GrepEngine("ne+dle", **kw), None),
        ("|".join(fdr_pats), GrepEngine(patterns=fdr_pats, **kw), None),
        ("needle~1", GrepEngine("needle", max_errors=1, **kw),
         {i for i, ln in enumerate(doc_lines, 1)
          if line_matches(approx_model, ln)}),
        ("ne|ee|xx", GrepEngine(patterns=["ne", "ee", "xx"], **kw), None),
        ("needle$", GrepEngine("needle$", **kw), None),
    ]
    kernel_modes = []
    for rx, eng, want in checks:
        res = eng.scan(data)
        if want is None:
            want = oracle(rx.encode())
        got = set(res.matched_lines.tolist())
        if got != want:
            raise RuntimeError(f"mesh engine [{eng.mode}] {rx!r}: "
                               f"{sorted(got ^ want)}")
        if eng.stats.get("psum_candidates", 0) < 1:
            raise RuntimeError(f"mesh engine [{eng.mode}]: no summed "
                               f"candidates")
        kernel_modes.append(eng.mode)
    # every family must have run its mesh kernel: a routing change (a
    # family taken to the host, still exact) fails the dry run
    if kernel_modes != ["shift_and", "nfa", "fdr", "approx", "pairset",
                        "nfa"]:
        raise RuntimeError(f"mesh kernel family missing: {kernel_modes}")
    if not checks[-1][1]._nfa_filter:
        raise RuntimeError("'$' pattern did not take the NFA filter route")

    ep_matches = None
    if len(mesh.axis_names) == 2:
        # the pattern axis: banks over 'seq', lanes over 'data'
        banks = [compile_aho_corasick([b"needle"]),
                 compile_aho_corasick([b"xx", b"zebra"]),
                 compile_aho_corasick([b"volcano"])]
        mult = shk.mesh_lane_multiple(mesh, "data")
        _lay_ep, st_ep = _stripes(data, mult, 32, home)
        _w, total_ep = sharded_pattern_set_step(
            st_ep, banks, mesh, data_axis="data", pattern_axis="seq")
        ep_matches = int(total_ep)
        if ep_matches < 1:
            raise RuntimeError("pattern-parallel dry run found no matches")

        # same-plan FDR banks over the pattern axis, bit for bit one
        # device's OR of every bank
        m1 = compile_fdr(["needle", "volcano", "abcdef", "fedcba"])
        m2 = compile_fdr(["zzebra", "gabhcd", "hhfgab", "deadbe"])
        if shk.same_plan((*m1.banks, *m2.banks)):
            model = FdrModel(banks=list(m1.banks) + list(m2.banks),
                             ignore_case=False, n_patterns=8)
            w_ep, t_ep = shk.sharded_fdr_pattern_step(
                st_ep, model, mesh, data_axis="data", pattern_axis="seq")
            cols = st_ep.t().contiguous()
            ref = None
            for bank in model.banks:
                ref = or_into(ref, fdr_scan.fdr_scan_words(cols, bank))
            if not torch.equal(w_ep.to(ref.device), ref):
                raise RuntimeError("pattern-axis FDR words diverge from the "
                                   "all-bank OR")
            if int(t_ep) < 1:
                raise RuntimeError("pattern-axis FDR found no candidates")

    line = (f"dryrun_multichip OK: mesh={dict(mesh.shape)} "
            f"lanes={lay.lanes} chunk={lay.chunk} matches={int(total)} "
            f"ep_matches={ep_matches} mesh_modes={kernel_modes} "
            f"ranks={mesh.n_ranks} cards={mesh.cards}")
    print(line)
    return line
