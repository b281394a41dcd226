"""Ground-truth volume loaders.

Twin of ``adjointnonlinearraytracing_tpu/experiments/voxel_scenes.py``: the
loader for ``data/fuel_injection_64.npy`` (64^3 float64 in [1.0, 1.0003])
plus simple synthetic scenes used by tests and demos.  Volumes come back as
tensors on an explicit device, the GPU by default.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..convert import require_device

_DATA_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "data")


def data_path(name: str) -> str:
    return os.path.abspath(os.path.join(_DATA_DIR, name))


def load_fuel_injection() -> np.ndarray:
    """The 64^3 fuel-injection gas-density volume (values in [1, 1.0003])."""
    return np.load(data_path("fuel_injection_64.npy"))


def _put(arr: np.ndarray, dtype, device) -> torch.Tensor:
    return torch.from_numpy(arr).to(device=require_device(device), dtype=dtype).contiguous()


def fuel_injection_rif(fuel_val: float = 0.0003, dtype=torch.float32, device="cuda"):
    """The padded 65^3 refractive-index ground truth of the experiment:
    ``n = (1 + fuel_val) - fuel_val * density`` with a normalized fuel density
    in [0, 1], padded to 65^3 with the background value ``1 + fuel_val``.

    The shipped npy is already that rescaled field at ``fuel_val = 3e-4``:
    every face and corner sits at exactly 1.0003 (the background) and the
    plume dips toward 1.0.  The density is recovered from it and the rescale
    applied again, so that ``fuel_val`` stays a parameter.  (Feeding the npy
    through the formula as if it were the density collapses the plume to a
    ~1e-7 perturbation at the f32 noise floor.)
    """
    g = load_fuel_injection()
    density = (g.max() - g) / (g.max() - g.min())  # in [0, 1], 1 = max fuel
    n = (1.0 + fuel_val) - fuel_val * density
    out = np.full((65, 65, 65), 1.0 + fuel_val, dtype=np.float64)
    out[:-1, :-1, :-1] = n
    return _put(out, dtype, device)


def luneburg_lens(res: int, span: float, dtype=torch.float32, device="cuda"):
    """Closed-form Luneburg profile ``n(r) = sqrt(2 - (r/R)^2)`` on a grid whose
    lens fills the volume (radius ``span / 2``), background 1."""
    idx = np.arange(res) * (span / (res - 1))
    z, y, x = np.meshgrid(idx, idx, idx, indexing="ij")
    c = span / 2
    r2 = ((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2) / (c ** 2)
    n = np.where(r2 <= 1.0, np.sqrt(np.clip(2.0 - r2, 0.0, None)), 1.0)
    return _put(n, dtype, device)


def gaussian_bump(res: int, span: float, amp: float = 0.1, dtype=torch.float32,
                  device="cuda"):
    """Smooth centered bump: a handy synthetic ground truth for tests."""
    idx = np.arange(res) * (span / (res - 1))
    z, y, x = np.meshgrid(idx, idx, idx, indexing="ij")
    c = span / 2
    r2 = (x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2
    sigma = span / 4
    return _put(1.0 + amp * np.exp(-r2 / (2 * sigma ** 2)), dtype, device)
