"""Probe: the trilinear value + gradient (kernel K1) against its plain version,
a library call and its bound, on points in ray order and sorted by cell.

Twin of ``adjointnonlinearraytracing_tpu/benchmarks/probe_evalmath.py``.  The
JAX probe asks whether a Pallas kernel that keeps a ray's 5^3 window row and
every intermediate in VMEM beats XLA's fused window math.  Here the same
function is K1 (``kernels/csrc/eval_grad.cu``, through ``fields.grid.eval_grad``)
on the raw grid's 8 corners.  The JAX cases map as follows:

- A, XLA's ``eval_window_fac``: the plain version, ``fields.grid.eval_grad_plain``;
- C, the Pallas kernel: K1, on the points as the rays give them and on the
  same points sorted by their cell (the grid's flat voxel index), so that a
  warp's points share corners;
- the library yardstick: ``torch.nn.functional.grid_sample``, trilinear, the
  value alone (no gradient, no mask);
- D, the lane bound: K1's bound, the larger of its bytes (points read, value
  and gradient written, the mask, the grid once) over 3.35 TB/s and its
  operations (45 a point) over 67 TFLOP/s;
- B, XLA's window backward (``eval_bwd`` + ``contrib``): no kernel of its
  own in the port (K3 and K6 do it inside their ray loops); its counterpart
  is the plain Hessian and splat, ``fields.grid.eval_hess`` +
  ``splat_delta``, timed and labelled plain.

The bench scene's field (``build_case``) and points part-way along its rays,
a fraction off the grid.  Correctness first: K1 bitwise against the plain
version, masked and not, sorted and not; then the times, CUDA events around
one launch after a 256 MB read that flushes the L2 (median of ``reps``).

Usage:  python -m adjointnonlinearraytracing_tpu_torch.benchmarks.probe_evalmath
Env:    PROBE_RES (grid side, default 128), PROBE_N (points, default 262144),
        PROBE_REPS (default 10).
"""

from __future__ import annotations

import json
import os

import torch

from ..convert import require_device
from ..fields import grid as G
from ..utils import profiling
from .scenes import build_case

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# stencil 9 (p/h, floor, pm - floor per axis) + value and gradient 36
FLOPS_EVAL_POINT = 45


def points(res=128, n=1 << 18, device="cuda", seed=1, dtype="float32"):
    """``(field, p, mask)``: the bench field and ``n`` points along its rays,
    ``x0 + t v0`` with ``t`` uniform in ``[0, 1.1 span)``."""
    rif, x0, v0, span = build_case(res=res, nrays=n, dtype=dtype, device=device)
    gen = torch.Generator(device=rif.device).manual_seed(seed)
    t = torch.rand((n, 1), generator=gen, device=rif.device, dtype=rif.dtype) * 1.1 * span
    field = G.GridField(rif, span / (res - 1))
    p = (x0 + t * v0).contiguous()
    return field, p, G.inbounds(field, p)


def cell_order(field, p):
    """The points' order by the flat index of their cell's lower corner (points
    off the grid take the clamped one); a stable sort."""
    d, hgt, wid = field.data.shape
    top = torch.tensor([wid, hgt, d], device=p.device) - 1
    pos = torch.floor(p / G._scalar(field.h, p)).to(torch.int64)
    pos = torch.minimum(torch.maximum(pos, torch.zeros_like(top)), top)
    return torch.argsort((pos[:, 2] * hgt + pos[:, 1]) * wid + pos[:, 0], stable=True)


def bound(field, n):
    """K1's least time, ms, and what bounds it."""
    item = field.data.element_size()
    nbytes = n * 7 * item + n + field.data.numel() * item
    by_bytes = 1e3 * nbytes / PEAK_BYTES_PER_S
    by_ops = 1e3 * n * FLOPS_EVAL_POINT / PEAK_F32_FLOPS
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations", nbytes


def run(res=128, n=1 << 18, reps=10, device="cuda", dtype="float32"):
    """Check K1 and, on a GPU, time every case; returns the record.

    On ``device="cpu"`` only the checks run (through the plain version) and the
    record holds no times.  On the card K1 is launched ``3 + 2 * (reps + 1)``
    times: three checks, then a warm-up and ``reps`` timed launches on the
    points in ray order and sorted."""
    dev = require_device(device)
    field, p, mask = points(res, n, dev, dtype=dtype)
    order = cell_order(field, p)
    ps, masks = p[order].contiguous(), mask[order]

    bitwise, worst = {}, 0.0
    for label, (q, m) in {"masked": (p, mask), "unmasked": (p, None),
                          "sorted by cell": (ps, masks)}.items():
        got, want = G.eval_grad(field, q, m), G.eval_grad_plain(field, q, m)
        worst = max(worst, *(float((a - b).abs().max()) for a, b in zip(got, want)))
        bitwise[label] = all(torch.equal(a, b) for a, b in zip(got, want))
    rec = {"res": res, "N": n, "reps": reps, "device": str(dev), "max_abs_err": worst,
           "bitwise": bitwise, "points_inside": int(mask.sum())}
    if not all(bitwise.values()):
        raise AssertionError(f"eval_grad is not bitwise equal to its plain version: {bitwise}")
    if dev.type != "cuda":
        return rec

    flush = profiling.l2_flush_buffer(dev)
    hi = torch.tensor([(r - 1) * field.h for r in field.res], dtype=p.dtype, device=dev)
    loc = (2.0 * p / hi - 1.0).reshape(1, 1, 1, n, 3)
    vol = field.data[None, None]
    val = torch.ones(n, dtype=p.dtype, device=dev)
    grad = torch.ones((n, 3), dtype=p.dtype, device=dev)
    cases = {
        "k1": lambda: G.eval_grad(field, p, mask),
        "k1_sorted": lambda: G.eval_grad(field, ps, masks),
        "plain": lambda: G.eval_grad_plain(field, p, mask),
        "grid_sample": lambda: torch.nn.functional.grid_sample(
            vol, loc, mode="bilinear", padding_mode="border", align_corners=True),
        "hess_splat_plain": lambda: (G.eval_hess(field, p, mask),
                                     G.splat_delta(field, p, val, grad, mask)),
    }
    rec["device"] = torch.cuda.get_device_name(dev)
    rec["ms"] = {name: profiling.kernel_ms(fn, reps, flush) for name, fn in cases.items()}
    bound_ms, by, nbytes = bound(field, n)
    rec.update(bound_ms=bound_ms, bound_by=by, bytes=nbytes,
               share_of_bound={k: bound_ms / rec["ms"][k] for k in ("k1", "k1_sorted")})
    return rec


def main():
    rec = run(res=int(os.environ.get("PROBE_RES", 128)),
              n=int(os.environ.get("PROBE_N", 1 << 18)),
              reps=int(os.environ.get("PROBE_REPS", 10)))
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
