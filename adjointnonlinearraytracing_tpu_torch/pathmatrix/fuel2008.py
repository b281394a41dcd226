"""Classical fuel-injection reconstruction baseline (Atcheson et al. 2008).

Twin of ``adjointnonlinearraytracing_tpu/pathmatrix/fuel2008.py`` (the
reference's ``path_matrix/run_fuel_injection_2008.py``): trace ground-truth
rays through the volume with the *nonlinear* tracer (``tracer.api.trace``:
K2 on the card), clip entry and exit to the cube, build the linear path
matrix Phi (the native marcher), solve per-axis LSQR for the index-gradient
fields from the ray deflections, then Poisson-integrate under Dirichlet
boundary conditions: a reconstruction independent of the adjoint tracer, with
timing and memory reporting.  Only the trace, the recorded trajectories of
the ``spline="true"`` path model (:func:`record_paths`: K20 on the card) and
the error's field evaluation (K1) run on the device; the rest is numpy/scipy
on the host.

Left out: the JAX module's ``F2008_GRAD_DUMP`` hook (reuse of a previous run's
LSQR solutions) has no counterpart.
"""

from __future__ import annotations

import resource
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..convert import require_device
from ..fields import grid as G
from ..fields.grid import GridField, eval_grad
from ..kernels import wrappers as K
from ..sources import sources as S
from ..tracer import api
from ..tracer import eikonal as E
from . import path_matrix as PM


def intersect_cube(x, v, lo, hi):
    """Ray-box slab intersection: returns (t_entry, t_exit) per ray."""
    with np.errstate(divide="ignore", invalid="ignore"):
        t1 = (lo - x) / v
        t2 = (hi - x) / v
    tmin = np.minimum(t1, t2)
    tmax = np.maximum(t1, t2)
    tmin[~np.isfinite(tmin)] = -np.inf
    tmax[~np.isfinite(tmax)] = np.inf
    return tmin.max(axis=1), tmax.min(axis=1)


def trace_to_cube(x, v, span):
    """Advance ray starts onto the cube entry face."""
    t_in, t_out = intersect_cube(x, v, 0.0, span)
    t = np.clip(t_in, 0.0, None)
    hit = t_in <= t_out
    return x + t[:, None] * v, hit


def trace_back_to_cube(xt, vt, span):
    """Pull exit samples back onto the cube exit face."""
    # going backwards along vt from a point just outside: the first slab hit
    t_in, t_out = intersect_cube(xt, -vt, 0.0, span)
    t = np.clip(t_in, 0.0, None)
    return xt - t[:, None] * vt


def record_steps(res: int, h: float, ds: float, stride: int) -> Tuple[int, int]:
    """``(nrec, steps)``: the records :func:`record_paths` writes for a grid of
    side ``res`` and the steps it takes, ``stride`` between two records."""
    nrec = E.max_steps_fwd(res, h, ds) // stride + 1
    return nrec, (nrec - 1) * stride


def record_paths_plain(gtruth: torch.Tensor, x: torch.Tensor, v: torch.Tensor, h: float,
                       ds: float, stride: int = 8, stats: Optional[dict] = None) -> torch.Tensor:
    """The plain version of :func:`record_paths`: the ``(nrec, N, 3)``
    positions in the grid's type, before the cast to float32.  K2's step with
    no stop, the eval masked by the previous position's ``inbounds`` (a ray
    outside the grid goes on straight); record ``k`` is ``x`` after ``k *
    stride`` steps, record 0 ``x``.  ``stats`` (a dict) gets the ray-steps
    taken and how many of them evaluated the field."""
    field = GridField(gtruth, h)
    nrec, steps = record_steps(max(gtruth.shape), h, ds, stride)
    ds_t = G._scalar(ds, x)
    inside = G.inbounds(field, x)
    recs, evals = [x], torch.zeros((), dtype=torch.int64, device=x.device)
    for _ in range(nrec - 1):
        for _ in range(stride):
            evals += inside.sum()
            x, v = E.forward_step(field, x, v, inside, ds_t)
            inside = G.inbounds(field, x)
        recs.append(x)
    if stats is not None:
        stats.update(ray_steps=steps * x.shape[0], evals=int(evals))
    return torch.stack(recs)


def record_paths(gtruth: torch.Tensor, x: torch.Tensor, v: torch.Tensor, h: float, ds: float,
                 stride: int = 8) -> Tuple[torch.Tensor, int]:
    """Per-ray trajectories every ``stride`` steps, the ``"true"`` path model's.

    Returns ``(path, nrec)``: ``path`` is float32 ``(nrec * N, 3)``, row ``k *
    N + i`` ray ``i``'s position after ``k * stride`` steps (the flat layout
    :func:`path_matrix.get_true_path` indexes), computed in the grid's type
    and cast at the end, as the JAX package's ``record_paths`` does.  On the
    card K20 (``kernels/csrc/trace_fwd.cu``); on the CPU
    :func:`record_paths_plain`.
    """
    gtruth, x, v = (t.detach().contiguous() for t in (gtruth, x, v))
    nrec, _ = record_steps(max(gtruth.shape), h, ds, stride)
    if gtruth.is_cuda:
        return K.record_paths(gtruth, h, x, v, ds, nrec, stride), nrec
    return record_paths_plain(gtruth, x, v, h, ds, stride).to(torch.float32).reshape(-1, 3), nrec


def default_params() -> Dict:
    return dict(
        vol_span=1.0,
        nviews=16,
        nbins=32,
        spp=4,
        step_res=2,
        recon_res=None,     # defaults to gt res - 1 voxels
        int_res=175,
        damp=0.0,           # gradient LSQR damp (reference: 0.000)
        damp_int=1e-4,      # integration damp (reference: 0.0001)
        spline="linear",
        path_stride=8,
        angle_span=360,
        sensor_dist_frac=1.0,
        seed=0,
    )


def gen_rays(params: Dict, dtype=torch.float64, device="cuda") -> S.Rays:
    """The ground-truth rays of the configuration: ``nviews`` planar views of
    ``nbins^2`` pixels x ``spp`` stratified samples around the volume, drawn
    from a generator seeded with ``seed`` on ``device``."""
    p = dict(default_params(), **(params or {}))
    gen = torch.Generator(device=require_device(device)).manual_seed(p["seed"])
    rays, _ = S.rand_rays_in_sphere(
        gen, p["nviews"], (p["nbins"], p["nbins"]), p["spp"], p["vol_span"], circle=False,
        angle_span=p["angle_span"], sensor_dist=p["sensor_dist_frac"] * p["vol_span"],
        dtype=dtype)
    return rays


def fuel_reconstruction(gtruth: torch.Tensor, params: Optional[Dict] = None, *,
                        rays=None, device="cuda"):
    """Run the 2008 pipeline on a ground-truth index volume; returns ``(recon,
    report)`` (``recon`` a numpy ``(recon_res,) * 3`` volume in the field
    layout ``[z, y, x]``).

    ``gtruth``: ``(res, res, res)`` refractive-index field on the span
    ``[0, vol_span]``, moved to ``device`` (the GPU unless the caller asks for
    the CPU) in its own type; the JAX driver traces in float64 (it enables
    x64, and its rays are drawn in float64).  ``rays``: the ground-truth rays
    (``(x, v)`` or a ``Rays``) in place of :func:`gen_rays`' draw, so that two
    runs can share them.  ``spline`` selects the path model: ``"linear"`` (the
    2008 baseline), ``"hermite"`` (entry / exit cubic) or ``"true"`` (the
    trajectories recorded every ``path_stride`` steps by :func:`record_paths`,
    from each ray's first to its last record inside the cube).
    ``angle_span`` / ``sensor_dist_frac`` set the acquisition geometry.
    """
    p = dict(default_params(), **(params or {}))
    if p["spline"] not in ("linear", "hermite", "true"):
        raise ValueError(f"fuel_reconstruction: unknown spline {p['spline']!r}")
    dev = require_device(device)
    gtruth = torch.as_tensor(gtruth).to(dev).contiguous()

    span = p["vol_span"]
    res = gtruth.shape[0]
    h = span / (res - 1)
    ds = h / p["step_res"]
    recon_res = p["recon_res"] or (res - 1)

    def sync():
        if gtruth.is_cuda:
            torch.cuda.synchronize(dev)

    report = {}
    t0 = time.time()

    # 1) ground-truth rays traced with the nonlinear tracer (forward only)
    if rays is None:
        rays = gen_rays(p, dtype=gtruth.dtype, device=dev)
    x, v = (t.to(device=dev, dtype=gtruth.dtype).contiguous() for t in tuple(rays)[:2])
    with torch.no_grad():
        xt, vt = api.trace(gtruth, x, v, h, ds)
        path_buf = None
        if p["spline"] == "true":
            pb, nrec = record_paths(gtruth, x, v, h, ds, p["path_stride"])
            path_buf = (pb.cpu().numpy(), nrec)
    sync()
    x0, v0, xt, vt = (t.double().cpu().numpy() for t in (x, v, xt, vt))
    report["trace_time"] = time.time() - t0

    # normalize: the tracer's |v| grows with n; deflection compares directions
    v0n = v0 / np.linalg.norm(v0, axis=1, keepdims=True)
    vtn = vt / np.linalg.norm(vt, axis=1, keepdims=True)

    # 2) clip to the cube; drop rays that missed or didn't deflect sanely
    sp_, hit = trace_to_cube(x0, v0n, span)
    ep_ = trace_back_to_cube(xt, vtn, span)
    good = hit & np.all(np.isfinite(sp_), 1) & np.all(np.isfinite(ep_), 1)
    good &= np.linalg.norm(ep_ - sp_, axis=1) > 1e-6
    sp_, ep_ = sp_[good], ep_[good]
    dv = (vtn - v0n)[good]
    report["num_rays"] = int(good.sum())

    # 3) path matrix (linear / hermite / recorded paths), the native marcher
    t1 = time.time()
    path_arg = None
    if path_buf is not None:
        pb, nrec = path_buf
        n_all = len(good)
        # per-ray first/last recorded sample inside the cube
        pts = pb.reshape(nrec, n_all, 3)
        inside = np.all((pts >= 0) & (pts <= span), axis=-1)  # (nrec, N)
        any_in = inside.any(axis=0)
        first = np.argmax(inside, axis=0)
        last = nrec - 1 - np.argmax(inside[::-1], axis=0)
        first = np.where(any_in, first, 0)
        last = np.where(any_in, np.maximum(last, first), 0)
        # reindex the flattened buffer to the kept rays
        keep = np.where(good)[0]
        pb_kept = pts[:, keep, :].reshape(-1, 3).astype(np.float64)
        path_arg = (pb_kept, first[keep].astype(float), last[keep].astype(float))
    phi = PM.construct_voxel_matrix(sp_, v0n[good], ep_, vtn[good], span, recon_res,
                                    spline=p["spline"], int_res=p["int_res"], path=path_arg)
    report["phi_time"] = time.time() - t1
    report["phi_nnz"] = int(phi.nnz)

    # 4) per-axis gradient solve + Poisson integration
    t2 = time.time()
    grads = PM.deflection_solve_gradient(phi, dv, damp=p["damp"])
    report["solve_time"] = time.time() - t2

    t3 = time.time()
    diff_mats = PM.construct_diff_matrices(recon_res, span, 3)
    background = float(gtruth[0, 0, 0])
    constraints = PM.construct_boundary_conditions(recon_res, 3, background)
    sol = PM.gradient_integration(diff_mats, constraints, grads, damp=p["damp_int"])
    report["integration_time"] = time.time() - t3

    # flat voxel index is ix + iy*res + iz*res^2 -> F-order gives [ix,iy,iz];
    # transpose to the field layout [iz,iy,ix]
    recon = sol[0].reshape((recon_res,) * 3, order="F").transpose(2, 1, 0)

    # 5) error vs the ground truth sampled at the voxel centers
    box = span / recon_res
    centers = (np.stack(np.meshgrid(*([np.arange(recon_res)] * 3), indexing="ij"), axis=-1)
               .reshape(-1, 3)[:, ::-1] + 0.5) * box  # (N, 3) as (x, y, z)
    pts = torch.from_numpy(np.ascontiguousarray(centers)).to(device=dev, dtype=gtruth.dtype)
    with torch.no_grad():
        gt_vals, _ = eval_grad(GridField(gtruth, h), pts)
    gt_np = gt_vals.double().cpu().numpy().reshape((recon_res,) * 3)
    err = recon - gt_np
    denom = np.linalg.norm(gt_np.ravel() - background) or 1.0
    report["rel_err_norm"] = float(np.linalg.norm(err.ravel()) / denom)
    report["max_err"] = float(np.abs(err).max())
    report["l1_err"] = float(np.abs(err).mean())
    report["total_time"] = time.time() - t0
    # the peak of the whole process so far, earlier work in it included (the
    # JAX module reports psutil's current RSS instead)
    report["process_peak_rss_mb"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e3
    return recon, report
