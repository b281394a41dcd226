"""The canonical benchmark/entry-point scene: a smooth Gaussian refractive
bump with slightly tilted upward rays.

Twin of ``adjointnonlinearraytracing_tpu/benchmarks/scenes.py``: the numpy
code and the seed are the same, so the arrays are bit-identical to the JAX
side's before the cast to ``dtype``.  :func:`bench_rows` and :func:`z_rays`
make the same field and spread at sizes whose numpy meshgrids would not fit
the host (the z-slab ring's 1025^3): the field row block by row block on the
device, any rows of its z-padding (``parallel.slabs.pad_rif_z``), and the
rays turned to cross z.
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import require_device

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def build_case(res=128, nrays=1 << 18, span=20.0, dtype="float32", seed=0, device="cuda"):
    """(rif (res^3), x0 (N,3), v0 (N,3), span) as tensors on ``device``.

    ``device`` defaults to the GPU and the call raises if there is none; pass
    ``device="cpu"`` to get CPU tensors.
    """
    dev = require_device(device)
    tdtype = _DTYPES[dtype] if isinstance(dtype, str) else dtype

    idx = np.arange(res) * (span / (res - 1))
    z, y, x = np.meshgrid(idx, idx, idx, indexing="ij")
    c = span / 2
    r2 = (x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2
    rif = 1.0 + 0.2 * np.exp(-r2 / (2 * (span / 4) ** 2))

    rng = np.random.default_rng(seed)
    xz = rng.uniform(0.2 * span, 0.8 * span, (nrays, 2))
    x0 = np.stack([xz[:, 0], -0.25 * np.ones(nrays) * span / res, xz[:, 1]],
                  axis=-1)
    tilt = 0.08 * rng.standard_normal((nrays, 2))
    v0 = np.stack([tilt[:, 0], np.ones(nrays), tilt[:, 1]], axis=-1)
    v0 /= np.linalg.norm(v0, axis=-1, keepdims=True)

    def put(a):
        return torch.from_numpy(a).to(device=dev, dtype=tdtype).contiguous()

    return put(rif), put(x0), put(v0), span


def bench_rows(res, z0, z1, span=20.0, dtype="float32", device="cuda"):
    """Rows ``[z0, z1)`` of :func:`build_case`'s field at ``res^3``, computed on
    ``device`` in float64 a block of 64 rows at a time and cast to
    ``dtype``.  Rows at or past ``res`` repeat row ``res - 1``: the rows of
    ``pad_rif_z(rif, ndev)``, so that a rank of the slab ring makes only its
    own.  (The device's ``exp`` may round the last bit of a float64 value
    unlike numpy's.)"""
    dev = require_device(device)
    tdtype = _DTYPES[dtype] if isinstance(dtype, str) else dtype
    idx = torch.arange(res, dtype=torch.float64, device=dev) * (span / (res - 1))
    c = span / 2
    yx = (idx[:, None] - c) ** 2 + (idx[None, :] - c) ** 2
    out = torch.empty((z1 - z0, res, res), dtype=tdtype, device=dev)
    for a in range(z0, z1, 64):
        b = min(a + 64, z1)
        zz = (idx[torch.clamp(torch.arange(a, b, device=dev), max=res - 1)] - c) ** 2
        r2 = zz[:, None, None] + yx[None]
        out[a - z0:b - z0] = 1.0 + 0.2 * torch.exp(-r2 / (2 * (span / 4) ** 2))
    return out


def z_rays(res, nrays, span=20.0, dtype="float32", seed=0, device="cuda"):
    """``nrays`` rays with :func:`build_case`'s spread and tilt turned to travel
    along z: the even ones enter through z = 0 going +z, the odd ones through
    z = span going -z, a quarter cell outside.  Returns ``(x0, v0)``."""
    dev = require_device(device)
    tdtype = _DTYPES[dtype] if isinstance(dtype, str) else dtype
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0.2 * span, 0.8 * span, (nrays, 2))
    up = np.arange(nrays) % 2 == 0
    off = 0.25 * span / res
    x0 = np.stack([xy[:, 0], xy[:, 1], np.where(up, -off, span + off)], axis=-1)
    tilt = 0.08 * rng.standard_normal((nrays, 2))
    v0 = np.stack([tilt[:, 0], tilt[:, 1], np.where(up, 1.0, -1.0)], axis=-1)
    v0 /= np.linalg.norm(v0, axis=-1, keepdims=True)

    def put(a):
        return torch.from_numpy(a).to(device=dev, dtype=tdtype).contiguous()

    return put(x0), put(v0)
