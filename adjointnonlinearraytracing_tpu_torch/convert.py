"""Carry state between numpy (or the JAX package) and the port.

This system's "weights" are the voxel grid of refractive indices.  Its layout
is the same on both sides and is kept as is: ``data[z, y, x]`` with positions
``p = (x, y, z)``, flat index ``(z*H + y)*W + x``.  The fiber driver's weights
are a 1D radial profile ``data[r]``, the same on both sides too.
"""

from __future__ import annotations

import os

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


def profile_from_numpy(src, device="cuda", dtype=torch.float32) -> torch.Tensor:
    """A radial profile as the fiber driver's ``init_profile`` tensor on ``device``.

    ``src`` is the profile itself (a numpy array, a list, or anything
    ``np.asarray`` takes) or the path of a ``result.npz`` written by the fiber
    driver of either package, whose ``rif`` field holds the final profile.
    """
    if isinstance(src, (str, os.PathLike)):
        with np.load(src) as f:
            arr = f["rif"]
    else:
        arr = np.asarray(src.detach().cpu() if isinstance(src, torch.Tensor) else src)
    if arr.ndim != 1:
        raise ValueError(f"profile_from_numpy: expected a 1D radial profile, got shape "
                         f"{arr.shape}")
    dev = require_device(device)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device=dev, dtype=dtype)


def checkpoint_from_jax_npz(path: str, device="cuda"):
    """A checkpoint written by the JAX package's ``save_checkpoint`` as the port's state.

    Returns ``(n, AdamState, loss_hist)``: the field, Adam's step count and
    moments, and the loss history, on ``device`` in the dtypes of the file.
    The file's ``key`` is a JAX PRNG key, which has no meaning for a
    ``torch.Generator``, so none comes back: the resumed run draws from a
    fresh generator of its own.  ``opt.multires_opt(resume_from=path)`` reads
    such a file directly in the same way, so a run begun in the JAX package
    resumes in the port and, given a loss that draws no random numbers, both
    then take the same steps.
    """
    from .opt.multires import load_checkpoint  # opt imports this module

    n, adam, loss_hist, key_state = load_checkpoint(path, device=device)
    if key_state is not None:
        raise ValueError(f"{path} holds a torch generator state: it was written by the "
                         "port, not by the JAX package; use opt.load_checkpoint")
    return n, adam, loss_hist
