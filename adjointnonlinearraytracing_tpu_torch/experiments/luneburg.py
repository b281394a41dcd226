"""Luneburg-lens inverse design.

Twin of ``adjointnonlinearraytracing_tpu/experiments/luneburg.py``.  Random
cube-face sources (parallel beams cropped to a disk, then turned by a random
rotation about the volume centre) are traced through the volume; the loss is
the mean squared distance of plane-projected exit points from each ray's
focal target, the opposite point on the sensor sphere.  Optimised coarse to
fine up to 129^3; the converged field approaches the closed-form Luneburg
profile ``n(r) = sqrt(2 - (r/R)^2)`` (``voxel_scenes.luneburg_lens``).

Everything runs on the GPU unless the caller passes ``device="cpu"``; with no
GPU and no such argument :func:`run_opt` raises.  Each step draws fresh rays
on the device from the run's generator.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from .. import sensors
from ..convert import require_device
from ..opt import multires_opt
from ..sources import sources as S
from ..utils.metrics import MetricsLogger
from . import common


def default_params() -> Dict:
    return dict(
        cube_rots=1,
        res_list=[3, 5, 9, 17, 33, 65, 129],
        vol_span=20,
        step_res=2,
        optim_iters=70,
        record_iters=20,
        nbins=128,
        spp=10,
        planar_source="plane",
        sensor_distance=0,
        autodiff=False,
        lr=1e-2,
        seed=0,
    )


def gen_start_rays(params: Dict, gen: torch.Generator, samples: int, dtype=torch.float32):
    """The rays of one step of ``params`` drawn from ``gen``: for each of
    ``cube_rots`` rotations the six cube faces cropped to the disk, turned by
    a random rotation about the volume centre.  Returns ``(Rays, rays per view)``."""
    nbins, span = params.get("nbins", 128), params.get("vol_span", params["res_list"][0])
    views = []
    for _ in range(params.get("cube_rots", 1)):
        rays, _ = S.rand_rays_cube(gen, (nbins, nbins), samples, span, circle=True,
                                   src_type=params.get("planar_source", "plane"), dtype=dtype)
        x, v, planes = S.random_rotate_ic(gen, rays.x, rays.v, rays.planes, span)
        views.append(S.Rays(x, v, planes, rays.mask))
    return S._cat_rays(views)


def run_opt(params: Dict, result_dir: Optional[str] = None, *, device="cuda", stat_fn=None,
            metrics: Optional[MetricsLogger] = None,
            sample_rays: Optional[Callable[[torch.Generator, int], S.Rays]] = None):
    """Main entry point.  Returns ``(final_eta, loss_hist)``.

    ``stat_fn(iteration, loss, seconds_per_step)`` is handed to the optimiser
    loop; ``metrics`` takes the place of the logger made from ``result_dir``.
    ``sample_rays(gen, samples) -> Rays`` replaces the draw of the cube-face
    rays (tests hand both packages the same rays with it); its rays are taken
    as ``6 * cube_rots`` views of equal size.
    """
    dev = require_device(device)
    res_list = params.get("res_list", [3, 5, 9, 17, 33, 65])
    vol_span = params.get("vol_span", res_list[0])
    spp = params.get("spp", 2)
    sensor_dist = params.get("sensor_distance", 0)
    step_res = params.get("step_res", 2)
    optim_iters = params.get("optim_iters", 30)
    record_iters = params.get("record_iters", 30)
    nbins = params.get("nbins", 128)
    lr = params.get("lr", 1e-2)
    autodiff = params.get("autodiff", False)
    cube_rots = params.get("cube_rots", 1)
    seed = params.get("seed", 0)
    dtype = common.param_dtype(params)

    h = vol_span / max(res_list[-1] - 1, 1)
    ds = h / step_res
    # upper projection n <= h/ds at the finest stage: the physical peak index
    # is sqrt(2), so it never binds on a healthy run
    clamp_max = params.get("clamp_max", float(step_res) if step_res >= 2 else None)
    span = vol_span

    if metrics is None:
        metrics = MetricsLogger(
            f"{result_dir}/metrics.jsonl" if result_dir else None,
            append=params.get("resume_from") is not None)

    def draw(gen, samples):
        if sample_rays is None:
            return gen_start_rays(params, gen, samples, dtype)
        rays = S.Rays(*(t.to(dev) for t in sample_rays(gen, samples)))
        return rays, [rays.x.shape[0] // (6 * cube_rots)] * (6 * cube_rots)

    def seeded(offset):
        return torch.Generator(device=dev).manual_seed(seed + offset)

    grad_holder = {"mode": params.get("gradient")}
    probe, _ = draw(seeded(779), 1)  # a generator of its own: no other draw moves
    trace = common.make_trace(vol_span, ds, autodiff=autodiff,
                              use_mesh=params.get("mesh", False), gradient=grad_holder,
                              probe_rays=(probe.x[:4096], probe.v[:4096]), device=dev)
    metrics.log(0, exit_buckets=trace.nbuckets)  # the adjoint steps' buckets

    def loss_function(eta, gen):
        rays, _ = draw(gen, spp)
        xm, vm = trace(eta, rays.x, rays.v)
        sn = rays.planes[:, 1, :]
        sp = rays.planes[:, 0, :] + sensor_dist * sn
        xmp, _ = sensors.trace_rays_to_plane((xm, vm), (sp, sn))
        # sum over the live rays, normalised by their count and the span
        return common.masked_sum_sq(xmp - sp, rays.mask) \
            / torch.clamp(rays.mask.sum(), min=1) / span

    def log_function(iter_count, eta):
        metrics.log(iter_count, res=eta.shape[0])
        if result_dir is None or record_iters > 10 ** 8 or iter_count % record_iters != 0:
            return
        rays, rpv = draw(seeded(100_000 + iter_count), spp)
        sensor_p, sensor_n, sensor_t = common.per_view_planes(rays.planes, rpv)
        with torch.no_grad():
            xm, vm = trace(eta, rays.x, rays.v)
            images = [
                S.sum_norm(sensors.generate_sensor((xv, vv), 1.0, (sp, sn), nbins, span, st,
                                                   mask=mk))
                for xv, vv, sp, sn, st, mk in zip(
                    common.split_views(xm, rpv), common.split_views(vm, rpv),
                    sensor_p, sensor_n, sensor_t, common.split_views(rays.mask, rpv))]
        from ..utils.plotting import save_multiple_images
        save_multiple_images(images, f"{result_dir}/luneburg_{iter_count}.png")

    n0 = torch.ones((res_list[0],) * 3, dtype=dtype, device=dev)
    if params.get("grad_spotcheck", True) and not autodiff:
        rays, _ = draw(seeded(777), 1)
        common.gradient_spotcheck(n0, rays.x, rays.v, vol_span, ds, mask=rays.mask,
                                  metrics=metrics)
    stage_fn = None
    if params.get("auto_exact", True) and not autodiff and params.get("gradient") is None:
        def _probe_rays():
            r, _ = draw(seeded(778), 1)
            return r.x, r.v, r.mask
        stage_fn = common.make_stage_escalator(
            grad_holder, vol_span, ds, _probe_rays, metrics,
            rays_per_iter=nbins * nbins * spp * cube_rots)
    final_eta, loss_hist = multires_opt(
        loss_function, n0, optim_iters, res_list, log_function, lr=lr,
        stage_fn=stage_fn, stat_fn=stat_fn,
        statename=f"{result_dir}/result" if result_dir else None,
        key=seeded(0), clamp_max=clamp_max,
        resume_from=params.get("resume_from"))

    if result_dir is not None:
        from ..utils.plotting import save_loss_plot
        save_loss_plot(loss_hist, f"{result_dir}/loss_plot.png")
    return final_eta, loss_hist


if __name__ == "__main__":
    run_opt(default_params(), "results/luneburg")
