"""Focal-stack optimisation.

Twin of ``adjointnonlinearraytracing_tpu/experiments/focalstack.py``.  One
view, a cone or planar source; each ray's emission is sampled from a source
image at the source-side plane; sensor images rendered at several focus
distances are MSE-matched against the measured focal stack (the lego-knight
experiment of ``configs/params-focalstack.yaml``).  The lego-knight captures
are not in the repo: :func:`make_synthetic_stack` renders a stack from a
known scene instead, as the runner does when they are absent.

Everything runs on the GPU unless the caller passes ``device="cpu"``; with no
GPU and no such argument :func:`multires_exp` raises.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from .. import sensors
from ..convert import require_device
from ..opt import multires_opt
from ..sources import sources as S
from ..utils.metrics import MetricsLogger
from . import common


def _gen_start_rays(gen, src_type, nbins, samples, span, angle_s, src_angle, dtype):
    """One view of the source: ``(Rays, rays per view, plane distances)``."""
    args = (gen, 1, (nbins, nbins), samples, span)
    kwargs = dict(angle_span=angle_s, circle=False, xaxis=False, dtype=dtype)
    if src_type == "planar":
        rays, rpv = S.rand_rays_in_sphere(*args, sensor_dist=0, **kwargs)
        tpv = torch.ones(rays.x.shape[0], dtype=dtype, device=gen.device)
    elif src_type == "point":
        rays, rpv = S.rand_ptrays_in_sphere(*args, sensor_dist=0, **kwargs)
        tpv = torch.ones(rays.x.shape[0], dtype=dtype, device=gen.device)
    elif src_type == "cone":
        rays, tpv, rpv = S.rand_cone_in_sphere(*args, sensor_dist=0, cone_angle=src_angle,
                                               **kwargs)
    else:
        rays, _, tpv, rpv = S.rand_area_in_sphere(*args, sensor_dist=1.0, **kwargs)
    return rays, rpv, tpv


def render_stack(trace, eta, rays, src_image, sensor_dists, nbins, span, dtype):
    """Trace the rays and render one sensor image per focus distance."""
    planes = rays.planes
    sensor_p = planes[None, 0, 0, :]
    sensor_n = planes[None, 0, 1, :]
    sensor_t = planes[None, 0, 2, :]

    with torch.no_grad():  # the emission carries no gradient
        e = sensors.get_sdf_vals_near(
            (rays.x, rays.v), src_image,
            (sensor_p - (span + sensor_dists[0]) * sensor_n, sensor_n), span, sensor_t)

    xm, vm = trace(eta, rays.x, rays.v)
    images = [
        S.sum_norm(sensors.generate_sensor((xm, vm), e, (sensor_p + d * sensor_n, sensor_n),
                                           nbins, span, sensor_t, mask=rays.mask))
        for d in sensor_dists]
    return torch.stack(images)


def make_synthetic_stack(scene, params, device="cuda") -> List[torch.Tensor]:
    """Render a ground-truth focal stack from a known scene ``(D, H, W)``."""
    dev = require_device(device)
    p = dict(params)
    vol_span = p.get("vol_span", 1.0)
    res_list = p.get("res_list", [3, 5, 9, 17, 33])
    step_res = p.get("step_res", 2)
    nbins = p.get("nbins", scene.shape[0])
    dtype = common.param_dtype(p)
    h = vol_span / max(res_list[-1] - 1, 1)
    ds = h / step_res
    trace = common.make_trace(vol_span, ds, device=dev)
    rays, _, _ = _gen_start_rays(
        torch.Generator(device=dev).manual_seed(p.get("seed", 0) + 77),
        p.get("source_type", "cone"), nbins, p.get("spp", 1), vol_span,
        p.get("angle_span", 360), p.get("src_angle", 30.0), dtype)
    src = torch.as_tensor(p["source_image"]).to(device=dev, dtype=dtype)
    with torch.no_grad():
        stack = render_stack(trace, scene.to(device=dev, dtype=dtype), rays, src,
                             p["sensor_dists"], nbins, vol_span, dtype)
    return list(stack)


def multires_exp(params: Dict, result_dir: Optional[str] = None, *, device="cuda",
                 stat_fn=None, metrics: Optional[MetricsLogger] = None,
                 sample_rays: Optional[Callable[[torch.Generator, int], S.Rays]] = None):
    """Main entry point.  Returns ``(final_eta, loss_hist)``.

    ``stat_fn``, ``metrics`` and ``sample_rays(gen, samples) -> Rays`` as in
    ``image.multires_exp``.
    """
    dev = require_device(device)
    dtype = common.param_dtype(params)
    src_image = torch.as_tensor(params["source_image"]).to(device=dev, dtype=dtype)
    meas_focal = params["focal_stack"]
    meas_dists = params.get("sensor_dists")
    res_list = params.get("res_list", [3, 5, 9, 17, 33, 65])
    vol_span = params.get("vol_span", 1)
    spp = params.get("spp", 1)
    step_res = params.get("step_res", 2)
    angle_s = params.get("angle_span", 360)
    nbins = params.get("nbins", meas_focal[0].shape[0])
    lr = params.get("lr", 1e-4)
    src_type = params.get("source_type", "planar")
    src_angle = params.get("src_angle", 30.0)
    autodiff = params.get("autodiff", False)
    optim_iters = params.get("optim_iters", 300)
    record_iters = params.get("record_iters", optim_iters // 10 + 1)
    seed = params.get("seed", 0)

    h = vol_span / max(res_list[-1] - 1, 1)
    ds = h / step_res
    # upper projection n <= h/ds at the finest stage: the physical peak index
    # is far below it, so it never binds on a healthy run
    clamp_max = params.get("clamp_max", float(step_res) if step_res >= 2 else None)
    span = vol_span
    measurements = torch.stack([torch.as_tensor(m).to(device=dev, dtype=dtype)
                                for m in meas_focal])

    if metrics is None:
        metrics = MetricsLogger(
            f"{result_dir}/metrics.jsonl" if result_dir else None,
            append=params.get("resume_from") is not None)

    def gen_start_rays(gen, samples):
        if sample_rays is not None:
            return S.Rays(*(t.to(dev) for t in sample_rays(gen, samples)))
        return _gen_start_rays(gen, src_type, nbins, samples, span, angle_s, src_angle,
                               dtype)[0]

    def seeded(offset):
        return torch.Generator(device=dev).manual_seed(seed + offset)

    grad_holder = {"mode": params.get("gradient")}
    probe = gen_start_rays(seeded(779), 1)  # a generator of its own: no other draw moves
    trace = common.make_trace(vol_span, ds, autodiff=autodiff,
                              use_mesh=params.get("mesh", False), gradient=grad_holder,
                              probe_rays=(probe.x[:4096], probe.v[:4096]), device=dev)
    metrics.log(0, exit_buckets=trace.nbuckets)  # the adjoint steps' buckets

    def loss_function(eta, gen):
        stack = render_stack(trace, eta, gen_start_rays(gen, spp), src_image, meas_dists,
                             nbins, span, dtype)
        return ((stack - measurements) ** 2).mean()

    def log_function(iter_count, eta):
        metrics.log(iter_count, res=eta.shape[0])
        if result_dir is None or record_iters > 10 ** 8 or iter_count % record_iters != 0:
            return
        rays = gen_start_rays(seeded(300_000 + iter_count), spp * 2)
        with torch.no_grad():
            stack = render_stack(trace, eta, rays, src_image, meas_dists, nbins, span, dtype)
        from ..utils.plotting import save_multiple_images
        save_multiple_images(list(stack), f"{result_dir}/focalstack_{iter_count}.png")

    n0 = params.get("init")
    n0 = (torch.ones((res_list[0],) * 3, dtype=dtype, device=dev) if n0 is None
          else torch.as_tensor(n0).to(device=dev, dtype=dtype))

    if params.get("grad_spotcheck", True) and not autodiff:
        rays = gen_start_rays(seeded(777), 1)
        common.gradient_spotcheck(n0, rays.x, rays.v, vol_span, ds, mask=rays.mask,
                                  metrics=metrics)
    rays_per_iter = nbins * nbins * spp

    def stat(it, loss, secs):
        metrics.log(it, loss=loss, secs=round(secs, 3), rays=rays_per_iter,
                    rays_per_s=round(rays_per_iter / max(secs, 1e-9), 1))
        if stat_fn is not None:
            stat_fn(it, loss, secs)

    stage_fn = None
    if params.get("auto_exact", True) and not autodiff and params.get("gradient") is None:
        def _probe_rays():
            r = gen_start_rays(seeded(778), 1)
            return r.x, r.v, r.mask
        stage_fn = common.make_stage_escalator(grad_holder, vol_span, ds, _probe_rays, metrics,
                                               rays_per_iter=rays_per_iter)
    final_eta, loss_hist = multires_opt(
        loss_function, n0, optim_iters, res_list, log_function, lr=lr,
        stage_fn=stage_fn, stat_fn=stat,
        statename=f"{result_dir}/result" if result_dir else None,
        key=seeded(0), clamp_max=clamp_max,
        resume_from=params.get("resume_from"))

    if result_dir is not None:
        from ..utils.plotting import save_loss_plot
        save_loss_plot(loss_hist, f"{result_dir}/loss_plot.png")
    return final_eta, loss_hist
