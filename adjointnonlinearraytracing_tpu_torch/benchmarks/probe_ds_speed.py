"""Rays/s against the step size on the bench scene.

Twin of ``adjointnonlinearraytracing_tpu/benchmarks/probe_ds_speed.py``:
forward + gradient of the bench loss through ``tracer.api.trace`` (K2 and K3
on the card) at ``ds = alpha * h`` for alpha 0.5 (the bench's step), 0.83
(the largest step the JAX package's paired windows allow at the scene's peak
index 1.2), 1.0 and 1.2 (the top of the reference's envelope).  What each
step costs in accuracy is ``ds_study.py``'s.

The JAX probe also sets ``ANRT_FAST_PATH`` and ``ANRT_NMAX``, which pick the
TPU stepper's data layouts (the paired windows or the cell table).  The port
has one stepper for every step size, so it has neither knob, and each row
records the same path.

Usage:  python -m adjointnonlinearraytracing_tpu_torch.benchmarks.probe_ds_speed
Env:    DS_SPEED_OUT (default ``results/probe_ds_speed_torch.json``).
"""

from __future__ import annotations

import json
import os

import torch

from ..bench import fwd_bwd
from ..convert import require_device
from ..utils import profiling
from .scenes import build_case

ALPHAS = (0.5, 0.83, 1.0, 1.2)
# beside the JAX probe's TPU record, results/probe_ds_speed.json, not over it
DEFAULT_OUT = "results/probe_ds_speed_torch.json"


def run_case(alpha, res=128, nrays=1 << 18, iters=10, device="cuda"):
    """One alpha's row: rays/s forward + gradient, and whether the gradient is finite."""
    dev = require_device(device)
    rif, x0, v0, span = build_case(res=res, nrays=nrays, device=dev)
    h = span / (res - 1)
    last = {}

    def step():
        last["grad"] = fwd_bwd(rif, x0, v0, span, ds=alpha * h)[1]
        return last["grad"]

    dt = profiling.timeit(step, iters=iters, warmup=1, device=dev)
    rec = {"alpha": alpha, "ds": alpha * h, "rays_per_s": round(nrays / dt, 1),
           "vs_alpha_0.5": None, "grad_finite": bool(torch.isfinite(last["grad"]).all())}
    print(json.dumps(rec), flush=True)
    return rec


def run(res=128, nrays=1 << 18, iters=10, alphas=ALPHAS, device="cuda"):
    """Every alpha's row, each against the first (alpha 0.5)."""
    rows = [run_case(a, res, nrays, iters, device) for a in alphas]
    base = rows[0]["rays_per_s"]
    for r in rows:
        r["vs_alpha_0.5"] = round(r["rays_per_s"] / base, 3)
    return rows


def main():
    rows = run()
    out = os.environ.get("DS_SPEED_OUT", DEFAULT_OUT)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(rows, f, indent=2)
    print(json.dumps(rows))


if __name__ == "__main__":
    main()
