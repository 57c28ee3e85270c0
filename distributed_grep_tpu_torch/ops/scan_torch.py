"""O(matches) result fetch.

grep matches are sparse.  Instead of copying the dense word plane back to
the host (input/32 bytes), count its nonzero words on the device (one
scalar back), then gather exactly those words and their flat indices.
Plain PyTorch ops on the device (the reference's XLA counterparts are
``count_nonzero_bytes`` / ``gather_nonzero_bytes``, not Pallas kernels).
"""

from __future__ import annotations

import numpy as np
import torch


def sparse_nonzero(words: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """(flat indices int64, values uint32) of the nonzero entries of a
    uint32 word plane, as host arrays.  Works on the plane's own device."""
    flat = words.reshape(-1).view(torch.int32)  # uint32 bits, same zeros
    nnz = int(torch.count_nonzero(flat))
    if nnz == 0:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.uint32)
    idx = torch.nonzero(flat).reshape(-1)
    vals = flat[idx]
    return idx.cpu().numpy(), vals.cpu().numpy().view(np.uint32)
