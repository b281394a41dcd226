"""Fuel-injection gas tomography.

Twin of ``adjointnonlinearraytracing_tpu/experiments/fuel_injection.py``.
Synthetic tomography: the 64^3 fuel-injection volume (padded to 65^3 and
rescaled to a refractive-index field) is traced once to produce reference
exit rays; the optimisation recovers the field by matching plane-projected
exit positions (+ weighted directions) against those references.

Everything runs on the GPU unless the caller passes ``device="cpu"``; with no
GPU and no such argument :func:`run_opt` raises.  The measurement rays and the
reference exit rays stay on the device for the whole run.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..convert import require_device
from ..fields.grid import upres_volume
from ..opt import multires_opt
from ..sensors import trace_rays_to_plane
from ..sources import sources as S
from ..utils.metrics import MetricsLogger
from . import common, voxel_scenes

def default_params() -> Dict:
    return dict(
        res_list=[3, 5, 9, 17, 33, 65],
        vol_span=1.0,
        spp=1,
        nviews=8,
        sensor_distance=0,
        step_res=2,
        optim_iters=300,
        record_iters=30,
        angle_span=360,
        nbins=128,
        lr=1e-4,
        source_type="planar",
        autodiff=False,
        fuel_val=0.0003,
        defl_weight=1.0,
        seed=0,
    )


def gen_start_rays(params: Dict, gen: torch.Generator, dtype=torch.float32):
    """The measurement rays of ``params`` drawn from ``gen``: ``(Rays, rays per view)``."""
    nviews = params.get("nviews", 1)
    nbins = params.get("nbins", 128)
    kwargs = dict(angle_span=params.get("angle_span", 360), circle=False, xaxis=False,
                  sensor_dist=params.get("sensor_distance", 0), dtype=dtype)
    args = (gen, nviews, (nbins, nbins), params.get("spp", 1), params.get("vol_span", 1.0))
    src_type = params.get("source_type", "planar")
    if src_type == "planar":
        return S.rand_rays_in_sphere(*args, **kwargs)
    if src_type == "point":
        return S.rand_ptrays_in_sphere(*args, **kwargs)
    rays, _, _, rpv = S.rand_area_in_sphere(*args, **kwargs)
    return rays, rpv


def run_opt(params: Dict, result_dir: Optional[str] = None, gtruth=None, *,
            rays: Optional[S.Rays] = None, device="cuda", stat_fn=None,
            metrics: Optional[MetricsLogger] = None):
    """Main entry point.

    ``gtruth`` overrides the loaded ground-truth volume and ``rays`` the
    generated measurement rays (tests use both to hand the two packages the
    same scene); both are moved to ``device``.  ``stat_fn(iteration, loss,
    seconds_per_step)`` is handed to the optimiser loop, and ``metrics``
    takes the place of the logger made from ``result_dir``, so that a caller
    can read the run's rows (spot checks, escalation) without a directory.
    Returns ``(final_eta, loss_hist, gtruth)``.
    """
    dev = require_device(device)
    res_list = params.get("res_list", [3, 5, 9, 17, 33, 65])
    vol_span = params.get("vol_span", 1.0)
    step_res = params.get("step_res", 2)
    optim_iters = params.get("optim_iters", 300)
    record_iters = params.get("record_iters", 30)
    nbins = params.get("nbins", 128)
    lr = params.get("lr", 1e-4)
    autodiff = params.get("autodiff", False)
    fuel_val = params.get("fuel_val", 0.0003)
    defl_weight = params.get("defl_weight", 1.0)
    seed = params.get("seed", 0)
    dtype = common.param_dtype(params)

    h = vol_span / max(res_list[-1] - 1, 1)
    ds = h / step_res
    # upper projection n <= h/ds at the finest stage: the physical peak index
    # is far below it, so it never binds on a healthy run
    clamp_max = params.get("clamp_max", float(step_res) if step_res >= 2 else None)

    if gtruth is None:
        gtruth = voxel_scenes.fuel_injection_rif(fuel_val, dtype=dtype, device=dev)
    gtruth = gtruth.to(device=dev, dtype=dtype).contiguous()

    if metrics is None:
        metrics = MetricsLogger(
            f"{result_dir}/metrics.jsonl" if result_dir else None,
            append=params.get("resume_from") is not None)

    grad_holder = {"mode": params.get("gradient")}

    # measurement rays are FIXED across the optimisation (the ground truth is
    # traced once)
    if rays is None:
        rays, _ = gen_start_rays(params, torch.Generator(device=dev).manual_seed(seed), dtype)
    rays = S.Rays(*(t.to(dev) for t in rays))
    rays = S.Rays(rays.x.to(dtype).contiguous(), rays.v.to(dtype).contiguous(),
                  rays.planes.to(dtype), rays.mask)
    sp, sn = rays.planes[:, 0, :], rays.planes[:, 1, :]
    trace = common.make_trace(vol_span, ds, autodiff=autodiff,
                              use_mesh=params.get("mesh", False), gradient=grad_holder,
                              probe_rays=(rays.x[:4096], rays.v[:4096]), device=dev)
    metrics.log(0, exit_buckets=trace.nbuckets)  # the adjoint steps' buckets
    with torch.no_grad():
        x_gt, v_gt = trace_rays_to_plane(trace(gtruth, rays.x, rays.v), (sp, sn))

    # optional smoothness prior (:func:`regularizer`)
    reg_weight = float(params.get("reg_weight", 0.0))
    reg_kind = params.get("reg", "tv")

    def loss_function(eta, key):
        xmp, vmp = trace_rays_to_plane(trace(eta, rays.x, rays.v), (sp, sn))
        disp_loss = common.masked_mean_sq(xmp - x_gt, rays.mask) / 3.0
        defl_loss = common.masked_mean_sq(vmp - v_gt, rays.mask) / 3.0
        loss = (disp_loss + defl_weight * defl_loss) / fuel_val
        if reg_weight:
            loss = loss + reg_weight * regularizer(eta, fuel_val, reg_kind)
        return loss

    def log_function(iter_count, eta):
        metrics.log(iter_count, res=eta.shape[0])
        if (result_dir is None or record_iters > 10 ** 8
                or iter_count % record_iters != 0):
            return
        imx = eta[eta.shape[0] // 2, :, :]
        imy = eta[:, eta.shape[1] // 2, :]
        imz = eta[:, :, eta.shape[2] // 2]
        from ..utils.plotting import save_multiple_images
        save_multiple_images([imx, imy, imz],
                             f"{result_dir}/fuel_injection_{iter_count}.png")

    n0 = torch.ones((res_list[0],) * 3, dtype=dtype, device=dev) + fuel_val
    if params.get("grad_spotcheck", True) and not autodiff:
        common.gradient_spotcheck(n0, rays.x, rays.v, vol_span, ds, mask=rays.mask,
                                  metrics=metrics)
    stage_fn = None
    if (params.get("auto_exact", True) and not autodiff
            and params.get("gradient") is None):
        stage_fn = common.make_stage_escalator(
            grad_holder, vol_span, ds, lambda: (rays.x, rays.v, rays.mask), metrics,
            rays_per_iter=rays.x.shape[0])
    final_eta, loss_hist = multires_opt(
        loss_function, n0, optim_iters, res_list, log_function, lr=lr,
        stage_fn=stage_fn, stat_fn=stat_fn,
        statename=f"{result_dir}/result" if result_dir else None,
        key=torch.Generator(device=dev).manual_seed(seed + 1),
        clamp_max=clamp_max,
        resume_from=params.get("resume_from"))

    if result_dir is not None:
        from ..utils.plotting import save_loss_plot
        save_loss_plot(loss_hist, f"{result_dir}/loss_plot.png")
    return final_eta, loss_hist, gtruth


def regularizer(eta, fuel_val=0.0003, kind="tv"):
    """Smoothness prior on the signal-scaled deviation ``e = (eta - 1) / fuel_val``,
    so that its weight does not depend on the signal's amplitude.

    ``kind="tv"`` is the (smoothed) anisotropic total variation, the mean of
    ``sqrt(d^2 + 1e-6)`` over the differences ``d`` along each axis;
    ``kind="h1"`` the quadratic gradient norm, the mean of ``d^2``.  The
    fuel trainer (``reg_weight``) and the north star (``NS_TV``) add it
    to their losses.
    """
    e = (eta - 1.0) / fuel_val
    diffs = (e[1:] - e[:-1], e[:, 1:] - e[:, :-1], e[:, :, 1:] - e[:, :, :-1])
    if kind == "h1":
        return sum((d ** 2).mean() for d in diffs)
    return sum(torch.sqrt(d ** 2 + 1e-6).mean() for d in diffs)


def reconstruction_error(eta, gtruth, background=1.0):
    """Relative reconstruction error against the ground-truth volume, resampled
    to the recovered resolution.

    ``rel_norm`` is signal-relative: ``||eta - gt|| / ||gt - background||``,
    so 1.0 means "as wrong as guessing the uniform background".  For the fuel
    scene pass ``background = 1 + fuel_val`` (the plume's surround).
    ``ref_norm`` is the norm of the elementwise relative error
    ``||(eta - gt) / gt||``.
    """
    gt = upres_volume(gtruth.to(eta.device), tuple(eta.shape))
    err = eta - gt
    rel = torch.linalg.norm(err.reshape(-1)) / torch.clamp(
        torch.linalg.norm((gt - background).reshape(-1)), min=1e-30)
    return dict(
        rel_norm=float(rel),
        ref_norm=float(torch.linalg.norm((err / gt).reshape(-1))),
        max_abs=float(err.abs().max()),
        l1=float(err.abs().mean()),
    )


if __name__ == "__main__":
    run_opt(default_params(), "results/fuel_injection")
