"""Carry state between numpy (or the JAX package) and the port.

This system's "weights" are the voxel grid of refractive indices.  Its layout
is the same on both sides and is kept as is: ``data[z, y, x]`` with positions
``p = (x, y, z)``, flat index ``(z*H + y)*W + x``.
"""

from __future__ import annotations

import numpy as np
import torch


def require_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "CPU path on purpose")
    return dev


def rif_from_numpy(arr, device="cuda", dtype=torch.float32) -> torch.Tensor:
    """A ``(D, H, W)`` voxel grid ``arr[z, y, x]`` as a contiguous tensor on ``device``."""
    arr = np.asarray(arr)
    if arr.ndim != 3:
        raise ValueError(f"rif_from_numpy: expected a 3D voxel grid, got shape {arr.shape}")
    dev = require_device(device)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device=dev, dtype=dtype).contiguous()


def rif_to_numpy(rif: torch.Tensor) -> np.ndarray:
    """Inverse of :func:`rif_from_numpy`: the grid as a numpy array ``[z, y, x]``."""
    if rif.ndim != 3:
        raise ValueError(f"rif_to_numpy: expected a 3D voxel grid, got shape {tuple(rif.shape)}")
    return rif.detach().cpu().numpy()
