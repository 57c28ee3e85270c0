"""PyTorch + CUDA port of distributed_grep_tpu for NVIDIA Hopper (H100).

A MapReduce grep whose scan runs as hand-written CUDA kernels: single
patterns (Shift-And, the Glushkov NFA), literal sets (FDR, pairset) and
approximate matches (Wu-Manber), optionally -i, through
``runtime.job.run_job`` and the ``grep`` CLI; and the measuring path
(``bench``, ``benchmarks/``, ``utils/slope``) with its two probe kernels.
Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU, where the kernels' plain PyTorch versions run instead; the
grep app drives every local card (``devices="all"``), or a mesh of them
(``parallel/``: each segment's lanes sharded over the entries).

This package imports torch and numpy, never jax, and nothing of the
reference package ``distributed_grep_tpu``.
"""

from distributed_grep_tpu_torch.version import __version__

__all__ = ["__version__"]
