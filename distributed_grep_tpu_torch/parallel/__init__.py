"""Meshes of one host's cards (the reference's parallel/ package, its
lane half): ``mesh`` builds them, ``sharded_kernels`` runs rows 1 and
3-6 of the kernel table over a mesh with lanes sharded, and
``sharded_scan`` the table-DFA step K1 with its collectives.  The engine's
``mesh=`` option (ops/engine.py) dispatches segments through
``sharded_kernels``; ``devices=`` round-robins whole segments over
cards instead.  No run of record spanned two cards (PERF.md).
"""

from distributed_grep_tpu_torch.parallel.mesh import make_mesh
from distributed_grep_tpu_torch.parallel.sharded_scan import (
    sharded_grep_step,
)

__all__ = ["make_mesh", "sharded_grep_step"]
