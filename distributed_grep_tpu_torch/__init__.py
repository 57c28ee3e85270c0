"""PyTorch + CUDA port of distributed_grep_tpu for NVIDIA Hopper (H100).

A MapReduce grep whose scan runs as hand-written CUDA kernels.  The slice
ported so far: a literal or byte-class sequence of at most 32 symbols
(optionally -i), through ``runtime.job.run_job`` and the ``grep`` CLI.
Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU, where the kernels' plain PyTorch versions run instead.

This package imports torch and numpy, never jax, and nothing of the
reference package ``distributed_grep_tpu``.
"""
