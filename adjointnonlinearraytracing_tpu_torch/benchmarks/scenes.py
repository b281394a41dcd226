"""The canonical benchmark/entry-point scene: a smooth Gaussian refractive
bump with slightly tilted upward rays.

Twin of ``adjointnonlinearraytracing_tpu/benchmarks/scenes.py``: the numpy
code and the seed are the same, so the arrays are bit-identical to the JAX
side's before the cast to ``dtype``.
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
