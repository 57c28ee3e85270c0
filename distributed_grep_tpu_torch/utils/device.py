"""Device resolution shared by every entry point of the package.

Entry points run on the card unless the caller asks for the CPU.  Asking
for CUDA on a machine without it raises: nothing quietly scans on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a concrete ``torch.device`` ("cpu" or "cuda[:i]");
    raises RuntimeError when CUDA is asked for and absent."""
    d = torch.device(device)
    if d.type == "cpu":
        return d
    if d.type != "cuda":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' (CLI: --device cpu) to run the plain "
            "PyTorch versions of the kernels on the CPU"
        )
    if d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d
