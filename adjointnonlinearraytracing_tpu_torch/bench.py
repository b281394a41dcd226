"""Benchmark: rays/s forward + adjoint on one GPU, 128^3 grid, 2^18 rays.

Run as ``python -m adjointnonlinearraytracing_tpu_torch.bench``.  Prints ONE
JSON line with rays/s, the device's name and the sizes.  ``BENCH_RES``,
``BENCH_RAYS`` and ``BENCH_ITERS`` override the sizes.  Timed with CUDA
events; needs a CUDA device.
"""

from __future__ import annotations

import json
import os

import torch

from .benchmarks.scenes import build_case
from .tracer import api


def bench_loss(rif, x0, v0, span, ds=None):
    """The bench objective: ``sum((xt - target)^2) + sum(vt)`` through ``api.trace``,
    at ``ds`` (default ``h/2``)."""
    res = rif.shape[0]
    h = span / (res - 1)
    ds = h / 2 if ds is None else ds
    target = torch.tensor([span / 2, span * 1.1, span / 2], dtype=rif.dtype,
                          device=rif.device)
    xt, vt = api.trace(rif, x0, v0, h, ds)
    return ((xt - target) ** 2).sum() + vt.sum()


def fwd_bwd(rif, x0, v0, span, ds=None):
    """One forward + adjoint pass; returns ``(loss, d loss / d rif)``."""
    r = rif.detach().requires_grad_(True)
    loss = bench_loss(r, x0, v0, span, ds)
    loss.backward()
    return loss.detach(), r.grad


def run(res=128, nrays=1 << 18, iters=3, device="cuda"):
    """Time ``iters`` forward + adjoint passes; returns the result record."""
    rif, x0, v0, span = build_case(res=res, nrays=nrays, device=device)
    if not rif.is_cuda:
        raise RuntimeError("the bench times the GPU path; it needs device='cuda'")
    fwd_bwd(rif, x0, v0, span)  # builds the kernels, warms up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        _, g = fwd_bwd(rif, x0, v0, span)
    stop.record()
    torch.cuda.synchronize()
    seconds = start.elapsed_time(stop) / 1e3
    return {
        "metric": f"rays/s fwd+adjoint {res}^3 grid",
        "value": nrays * iters / seconds,
        "unit": "rays/s",
        "ms_per_iter": 1e3 * seconds / iters,
        "nrays": nrays,
        "iters": iters,
        "device": torch.cuda.get_device_name(rif.device),
        "grad_finite": bool(torch.isfinite(g).all()),
    }


def main():
    res = int(os.environ.get("BENCH_RES", "128"))
    nrays = int(os.environ.get("BENCH_RAYS", str(1 << 18)))
    iters = int(os.environ.get("BENCH_ITERS", "3"))
    print(json.dumps(run(res=res, nrays=nrays, iters=iters)))


if __name__ == "__main__":
    main()
