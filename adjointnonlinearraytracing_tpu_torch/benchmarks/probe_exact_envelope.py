"""The exact gradient at the focal-stack's batch: 1,310,720 rays a step.

Twin of ``adjointnonlinearraytracing_tpu/benchmarks/probe_exact_envelope.py``:
forward + gradient through ``tracer.trace_exact`` on the bench scene at 65^3
and 129^3 (the focal-stack driver's finest stage) with 1,310,720 rays, the
batch split into chunks of ``ANRT_EXACT_CHUNK`` rays in the backward pass
(K5 for the forward pass, then per chunk K5 to recompute its checkpoints and
K6).  Per grid: the first call's seconds (the kernels' build included where
nothing was built yet), the seconds of a later step, rays/s, the peak memory
of a step (``torch.cuda.max_memory_allocated``) and the estimate of one
chunk's (``experiments.common.exact_mem_bytes``).

Usage:  python -m adjointnonlinearraytracing_tpu_torch.benchmarks.probe_exact_envelope
"""

from __future__ import annotations

import json
import time

import torch

from ..convert import require_device
from ..experiments.common import exact_mem_bytes
from ..tracer import checkpointed as CK
from ..tracer import trace_exact
from ..utils import profiling
from .scenes import build_case

NRAYS = 1_310_720


def run_case(res, nrays=NRAYS, steps=2, device="cuda"):
    """One grid's row."""
    dev = require_device(device)
    rif, x0, v0, span = build_case(res=res, nrays=nrays, device=dev)
    h = span / (res - 1)
    ds = h / 2

    def step():
        r = rif.detach().requires_grad_(True)
        xt, vt = trace_exact(r, x0, v0, h, ds)
        (xt ** 2 + xt * vt).sum().backward()
        return r.grad

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    g = step()
    profiling.force(g, dev)
    first = time.perf_counter() - t0
    per_step = profiling.timeit(step, iters=steps, warmup=0, device=dev)
    chunk = CK.exact_chunk_rays()
    rec = {"res": res, "nrays": nrays, "chunk": chunk, "chunks": len(CK._chunks(nrays, chunk)),
           "first_call_s": round(first, 4), "per_step_s": round(per_step, 5),
           "rays_per_s_exact": round(nrays / per_step, 1),
           "peak_gb": profiling.device_memory_gb(dev),
           "chunk_estimate_gb": exact_mem_bytes(nrays, res, span, ds) / 1e9,
           "grad_finite": bool(torch.isfinite(g).all())}
    print(json.dumps(rec), flush=True)
    return rec


def main():
    for res in (65, 129):
        run_case(res)


if __name__ == "__main__":
    main()
