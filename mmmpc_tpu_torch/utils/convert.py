"""Host data -> tensors.

Both packages build their per-problem data (weights, references, geometry) as
numpy arrays; this moves such a dict onto a device in one dtype, so that the
two packages can compute on identical inputs.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(params: dict[str, np.ndarray], device: torch.device | str,
                      dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """Each entry as a contiguous tensor of ``dtype`` on ``device`` (0-d
    entries stay 0-d)."""
    return {k: torch.as_tensor(np.array(v), dtype=dtype, device=device)
            .contiguous() for k, v in params.items()}
