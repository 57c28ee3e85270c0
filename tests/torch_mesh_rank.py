"""One rank of a two-process mesh on the CPU, for
tests/test_torch_multihost.py: ``python tests/torch_mesh_rank.py RANK
WORLD PORT OUT [fail]``.

The rank joins a gloo group on 127.0.0.1:PORT, builds the global mesh
from two ``cpu`` entries of its own, runs the sharded kernels and two
engine scans on the inputs ``inputs()`` makes, and saves what it got to
OUT (``torch.save``).  With ``fail``, rank 1's Shift-And kernel raises
before its first collective, and the other rank must fail within the
group's timeout.  Imports the port only.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# a collective waits this long at most on a rank that died
TIMEOUT_S = 20.0

SET = ["needle", "volcano", "abcdef", "fedcba", "zzebra", "gabhcd", "hhfgab",
       "deadbe"]


def columns(seed: int = 7) -> np.ndarray:
    """(512, 4096) columns of seeded text with matches planted (the
    reference kernels' smallest tile)."""
    rng = np.random.default_rng(seed)
    arr = rng.choice(np.frombuffer(b"abcdefgh \nzq", np.uint8),
                     size=(512, 4096))
    for i, s in enumerate((b"needle", b"volcano", b"zzebra", b"deadbe")):
        sb = np.frombuffer(s, np.uint8)
        arr[29:29 + len(sb), i::61] = sb[:, None]
        arr[200:200 + len(sb), 3 + i::97] = sb[:, None]
    return arr


def text(n_lines: int = 2500, seed: int = 23) -> bytes:
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n_lines):
        n = int(rng.integers(0, 60))
        lines.append(bytes(rng.choice(list(b"abcdefg h"), size=n).tolist()))
        if i % 37 == 5:
            lines[-1] = b"xx needle yy"
        if i % 53 == 9:
            lines[-1] = b"a volcano and a deadbe"
    return b"\n".join(lines) + b"\n"


def fdr_model():
    """SET in two halves, one bank each, of one plan."""
    from distributed_grep_tpu_torch.models.fdr import FdrModel, compile_fdr

    halves = [compile_fdr(SET[:4]), compile_fdr(SET[4:])]
    return FdrModel(banks=[b for m in halves for b in m.banks],
                    ignore_case=False, n_patterns=len(SET))


def run(mesh, meshes_seq) -> dict:
    """Everything a rank (or one process, on the same mesh shape) gets."""
    from distributed_grep_tpu_torch.models.dfa import compile_dfa
    from distributed_grep_tpu_torch.models.shift_and import (
        try_compile_shift_and,
    )
    from distributed_grep_tpu_torch.ops.engine import GrepEngine
    from distributed_grep_tpu_torch.parallel import sharded_kernels as shk
    from distributed_grep_tpu_torch.parallel.sharded_scan import (
        sharded_grep_step,
    )

    st = torch.from_numpy(np.ascontiguousarray(columns().T))
    out = {}
    out["sa"] = shk.sharded_shift_and_words(
        st, try_compile_shift_and("needle"), mesh, ("data", "seq"))
    # (seq, data): each lane block's two bank runs sit on two ranks, so
    # the OR across the pattern axis crosses them
    out["fdr_ep"] = shk.sharded_fdr_pattern_step(
        st, fdr_model(), meshes_seq, data_axis="data", pattern_axis="seq")
    out["k1"] = sharded_grep_step(st, compile_dfa("needle"), mesh,
                                  ("data", "seq"))
    data = text()
    small = dict(target_lanes=256, min_chunk=32, segment_bytes=16 * 1024)
    out["lines_sa"] = GrepEngine("needle", mesh=mesh, mesh_axis="data",
                                 **small).scan(data).matched_lines.tolist()
    out["lines_ep"] = GrepEngine(patterns=SET, mesh=meshes_seq,
                                 mesh_axis="data", pattern_axis="seq",
                                 **small).scan(data).matched_lines.tolist()
    return out


def main(argv: list[str]) -> int:
    from distributed_grep_tpu_torch.ops import cuda_scan
    from distributed_grep_tpu_torch.parallel import multihost
    from distributed_grep_tpu_torch.parallel.mesh import make_mesh

    rank, world, port, out_path = (int(argv[0]), int(argv[1]), int(argv[2]),
                                   argv[3])
    fail = len(argv) > 4 and argv[4] == "fail"
    assert multihost.init_distributed(f"127.0.0.1:{port}", world, rank,
                                      backend="gloo", timeout_s=TIMEOUT_S)
    try:
        if fail and rank == 1:
            def broken(*_a, **_k):
                raise RuntimeError("rank 1's kernel failed")

            cuda_scan.shift_and_scan_words = broken
        mesh = make_mesh((2, 2), ("data", "seq"), devices=["cpu", "cpu"])
        meshes_seq = make_mesh((2, 2), ("seq", "data"),
                               devices=["cpu", "cpu"])
        res = run(mesh, meshes_seq)
        res["ranks"] = mesh.ranks.tolist()
        torch.save(res, out_path)
    finally:
        multihost._dist().destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
