"""Profiling sweeps: the taped plain stepper against the constant-memory adjoint
over the step size and the resolution.

Twin of ``adjointnonlinearraytracing_tpu/benchmarks/sweeps.py``, which follows
the reference's benchmark binary: :func:`profile_stepsize` sweeps
``ds = mult * h`` for mult in 0.3 .. 1.2 on a 33^3 grid, and
:func:`profile_resolution` sweeps the grid from 9^3 to 257^3 at ``ds = h/2``,
each timing forward + gradient of ``sum(xt^2)`` through the adjoint
(``tracer.api.trace``: kernels K2 and K3 on the card) and through the tape
(``tracer.api.trace_ad``: the plain stepper under autograd, its memory
growing with the steps).  A tape that does not fit the card is a result, the
row's ``"oom"``.  The rows have the JAX rows' keys; ``mem_gb`` is the peak
allocated in the row (``torch.cuda.max_memory_allocated``, reset per row),
None on the CPU.

Run:  python -m adjointnonlinearraytracing_tpu_torch.benchmarks.sweeps stepsize
      python -m adjointnonlinearraytracing_tpu_torch.benchmarks.sweeps resolution [129,257]
The sizes default to the JAX module's accelerator sizes on the card (2^18
rays at 33^3; 2^16 rays at 9^3 .. 257^3) and to its CPU sizes where the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

import json
import sys

import torch

from ..convert import require_device
from ..tracer import api
from ..utils import profiling
from .scenes import build_case

DS_MULTS = (0.3, 0.4, 0.5, 0.6, 0.8, 1.0, 1.2)


def _time_grad(trace_fn, rif, x0, v0, h, ds, iters, device):
    """Seconds per forward + gradient of ``sum(xt^2)`` through ``trace_fn``."""
    def step():
        r = rif.detach().requires_grad_(True)
        xt, _ = trace_fn(r, x0, v0, h, ds)
        (xt ** 2).sum().backward()
        return r.grad

    return profiling.timeit(step, iters=iters, warmup=1, device=device)


def _row_times(rif, x0, v0, h, ds, iters, include_ad, device):
    """``(adjoint seconds, tape seconds or None or "oom")``; the peak memory is
    reset first."""
    dev = require_device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    try:
        t_back = _time_grad(api.trace, rif, x0, v0, h, ds, iters, dev)
    except torch.cuda.OutOfMemoryError:
        t_back = "oom"
    t_ad = None
    if include_ad:
        try:
            t_ad = _time_grad(api.trace_ad, rif, x0, v0, h, ds, iters, dev)
        except torch.cuda.OutOfMemoryError:  # the tape is O(steps x rays)
            t_ad = "oom"
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return t_back, t_ad


def _rounded(t):
    return t if t is None or t == "oom" else round(t, 4)


def profile_stepsize(nrays=None, res=33, iters=2, include_ad=True, device="cuda",
                     ds_mults=DS_MULTS):
    """The step-size sweep on a ``res^3`` grid; one row a step size."""
    dev = require_device(device)
    if nrays is None:
        nrays = 1 << 18 if dev.type == "cuda" else 1 << 12
    rif, x0, v0, span = build_case(res=res, nrays=nrays, device=dev)
    h = span / (res - 1)
    rows = []
    for ds_mult in ds_mults:
        ds = h * ds_mult
        t_back, t_ad = _row_times(rif, x0, v0, h, ds, iters, include_ad, dev)
        row = dict(ds=round(ds, 5), ds_mult=ds_mult, back_time_s=_rounded(t_back),
                   back_rays_per_s=None if t_back == "oom" else round(nrays / t_back, 1),
                   ad_time_s=_rounded(t_ad), mem_gb=profiling.device_memory_gb(dev))
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def profile_resolution(nrays=None, iters=2, include_ad=False, res_list=None, device="cuda"):
    """The resolution sweep at ``ds = h/2``; one row a grid."""
    dev = require_device(device)
    on_card = dev.type == "cuda"
    if res_list is None:
        res_list = (9, 17, 33, 65, 129, 257) if on_card else (9, 17, 33, 65)
    if nrays is None:
        nrays = 1 << 16 if on_card else 1 << 12
    rows = []
    for res in res_list:
        rif, x0, v0, span = build_case(res=res, nrays=nrays, device=dev)
        h = span / (res - 1)
        t_back, t_ad = _row_times(rif, x0, v0, h, h / 2, iters, include_ad, dev)
        row = dict(res=res, back_time_s=_rounded(t_back),
                   back_rays_per_s=None if t_back == "oom" else round(nrays / t_back, 1),
                   ad_time_s=_rounded(t_ad), mem_gb=profiling.device_memory_gb(dev))
        rows.append(row)
        print(json.dumps(row), flush=True)
        del rif, x0, v0
    return rows


def main(argv):
    mode = argv[1] if len(argv) > 1 else "stepsize"
    if mode == "stepsize":
        profile_stepsize()
    elif mode == "resolution":
        kw = {}
        if len(argv) > 2:  # a comma-separated list, e.g. "resolution 129,257"
            kw["res_list"] = tuple(int(r) for r in argv[2].split(","))
        profile_resolution(**kw)
    else:
        raise SystemExit(f"unknown mode {mode!r}; use stepsize|resolution")


if __name__ == "__main__":
    main(sys.argv)
