"""Host data -> tensors.

Both packages build their per-problem data (weights, references, geometry) as
numpy arrays; this moves such a dict onto a device in one dtype, so that the
two packages can compute on identical inputs.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def params_from_numpy(params: dict[str, np.ndarray], device: torch.device | str,
                      dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """Each entry as a contiguous tensor of ``dtype`` on ``device``, in its
    own shape (0-d entries stay 0-d; a moving problem's obstacle table stays
    (N+1, n_obs, 3))."""
    return {k: torch.as_tensor(np.array(v), dtype=dtype, device=device)
            .contiguous() for k, v in params.items()}


@functools.lru_cache(maxsize=512)
def _constant(data: bytes, shape, np_dtype: str, dtype, device):
    return torch.as_tensor(np.frombuffer(data, np_dtype).reshape(shape).copy(),
                           dtype=dtype, device=device)


def device_constant(a, dtype: torch.dtype, device) -> torch.Tensor:
    """Host data ``a`` (numpy or a sequence) as a tensor of ``dtype`` on
    ``device``, made once a process for each value, dtype and device and
    shared afterwards (do not write to it): a tensor made from host data
    is copied to the card, and that copy waits for the card's queue to
    drain, which a loop of ticks must not do at every step.  A tensor is
    converted as it is."""
    if torch.is_tensor(a):
        return a.to(dtype=dtype, device=device)
    a = np.ascontiguousarray(a)
    return _constant(a.tobytes(), a.shape, a.dtype.str, dtype,
                     torch.device(device))
