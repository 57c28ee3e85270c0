"""The port's measuring scripts, each a counterpart of a root ``benchmarks/``
script (or of ``bench.py``) that runs the port's kernels: run each with
``python -m distributed_grep_tpu_torch.benchmarks.<name>``.  Importing them
does no work and needs no card."""
