"""Multi-view image-formation optimisation.

Twin of ``adjointnonlinearraytracing_tpu/experiments/image.py``.  N views
around the volume; per view a near-plane sensor image (tent splat,
mean-normalised) is MSE-matched against a target image (``einstein.png`` /
``turing.png``), optionally with far-field deflection images
(``defl_ims``, weighted by ``defl_weight``), or the rays' hits are scored on
signed-distance textures instead (``sdf_loss``: the sdf family).

Everything runs on the GPU unless the caller passes ``device="cpu"``; with no
GPU and no such argument :func:`multires_exp` raises.  Targets are moved to
the run's device and dtype once.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .. import sensors
from ..convert import require_device
from ..opt import multires_opt
from ..sources import sources as S
from ..utils.metrics import MetricsLogger
from . import common


def load_image(path: str, resolution: int, dtype=torch.float32, device="cuda"):
    """An image file resized to ``(resolution, resolution)``, grayscale float."""
    from PIL import Image

    dev = require_device(device)
    im = Image.open(path).resize((resolution, resolution))
    arr = np.asarray(im).astype(np.float32)
    if arr.ndim == 3:
        arr = arr[..., :3].mean(axis=-1)
    return torch.from_numpy(arr).to(device=dev, dtype=dtype)


def _pool2(x):
    """2x average pooling (even-cropped)."""
    hh = (x.shape[0] // 2) * 2
    ww = (x.shape[1] // 2) * 2
    x = x[:hh, :ww]
    return 0.25 * (x[0::2, 0::2] + x[1::2, 0::2] + x[0::2, 1::2] + x[1::2, 1::2])


def make_image_mse(per_view_norm: bool = False, pyramid_levels: int = 1):
    """The image-match loss: per-view MSE of mean-normalised images, with two
    options.

    * ``per_view_norm``: scale-invariant matching; each rendered image is
      multiplied by its optimal scale ``a* = <im, meas> / <im, im>`` (itself
      differentiable) before the MSE.
    * ``pyramid_levels > 1``: the residual is also measured on 2x, 4x, ...
      average-pooled images and the levels averaged.
    """

    def image_mse(im, meas):
        if per_view_norm:
            a = (im * meas).sum() / torch.clamp((im * im).sum(), min=1e-12)
            im = a * im
        loss = ((im - meas) ** 2).mean()
        if pyramid_levels > 1:
            ca, cb = im, meas
            for _ in range(pyramid_levels - 1):
                ca = _pool2(ca)
                cb = _pool2(cb)
                loss = loss + ((ca - cb) ** 2).mean()
            loss = loss / pyramid_levels
        return loss

    return image_mse


def _on(images, dev, dtype):
    """A list of images (or ``None`` placeholders) as tensors on ``dev``."""
    return [None if im is None else torch.as_tensor(im).to(device=dev, dtype=dtype)
            for im in images]


def gen_start_rays(params: Dict, gen: torch.Generator, samples: int, nviews: int,
                   dtype=torch.float32):
    """The rays of one step of ``params`` drawn from ``gen``: ``nviews`` views
    of the source around the volume.  Returns ``(Rays, rays per view, plane
    distance per ray)``."""
    nbins = params.get("nbins", 128)
    args = (gen, nviews, (nbins, nbins), samples, params.get("vol_span", 1))
    kwargs = dict(angle_span=params.get("angle_span", 360), circle=False, xaxis=False,
                  sensor_dist=params.get("sensor_distance", 0), dtype=dtype)
    src_type = params.get("source_type", "planar")
    if src_type in ("planar", "point"):
        rig = S.rand_rays_in_sphere if src_type == "planar" else S.rand_ptrays_in_sphere
        rays, rpv = rig(*args, **kwargs)
        return rays, rpv, torch.ones(rays.x.shape[0], dtype=dtype, device=gen.device)
    rays, _, tpv, rpv = S.rand_area_in_sphere(*args, **kwargs)
    return rays, rpv, tpv


def multires_exp(params: Dict, result_dir: Optional[str] = None, *, device="cuda",
                 stat_fn=None, metrics: Optional[MetricsLogger] = None,
                 sample_rays: Optional[Callable[[torch.Generator, int], S.Rays]] = None):
    """Main entry point.  Returns ``(final_eta, loss_hist)``.

    ``stat_fn(iteration, loss, seconds_per_step)`` is called after the run's
    own step row is logged; ``metrics`` takes the place of the logger made
    from ``result_dir``.  ``sample_rays(gen, samples) -> Rays`` replaces the
    draw of the source (tests hand both packages the same rays with it); its
    rays are taken as ``nviews`` views of equal size with plane distance 1,
    as the planar and point sources have.
    """
    dev = require_device(device)
    dtype = common.param_dtype(params)
    disp_ims = _on(params.get("disp_ims", [None]), dev, dtype)
    defl_ims = _on(params.get("defl_ims", [None]), dev, dtype)
    defl_weight = params.get("defl_weight", 1.0)
    sdf_loss = params.get("sdf_loss", False)
    sdf_disp = _on(params.get("sdf_disp", [None]), dev, dtype)
    sdf_defl = _on(params.get("sdf_defl", [None]), dev, dtype)
    res_list = params.get("res_list", [3, 5, 9, 17, 33, 65])
    vol_span = params.get("vol_span", 1)
    spp = params.get("spp", 1)
    step_res = params.get("step_res", 2)
    far_sensor_span = params.get("far_sensor_span", 120)
    nbins = params.get("nbins", 128)
    lr = params.get("lr", 1e-4)
    autodiff = params.get("autodiff", False)
    optim_iters = params.get("optim_iters", 300)
    record_iters = params.get("record_iters", optim_iters // 10 + 1)
    seed = params.get("seed", 0)
    image_mse = make_image_mse(params.get("per_view_norm", False),
                               params.get("pyramid_levels", 1))

    h = vol_span / max(res_list[-1] - 1, 1)
    ds = h / step_res
    # upper projection n <= h/ds at the finest stage: the physical peak index
    # is far below it, so it never binds on a healthy run
    clamp_max = params.get("clamp_max", float(step_res) if step_res >= 2 else None)
    span = vol_span
    nviews = max(len(disp_ims), len(defl_ims))

    if result_dir:  # its checkpoints and files, with or without a metrics file there
        os.makedirs(result_dir, exist_ok=True)
    if metrics is None:
        metrics = MetricsLogger(
            f"{result_dir}/metrics.jsonl" if result_dir else None,
            append=params.get("resume_from") is not None)

    def draw(gen, samples):
        if sample_rays is None:
            return gen_start_rays(params, gen, samples, nviews, dtype)
        rays = S.Rays(*(t.to(dev) for t in sample_rays(gen, samples)))
        tpv = torch.ones(rays.x.shape[0], dtype=dtype, device=dev)
        return rays, [rays.x.shape[0] // nviews] * nviews, tpv

    def seeded(offset):
        return torch.Generator(device=dev).manual_seed(seed + offset)

    grad_holder = {"mode": params.get("gradient")}
    probe, _, _ = draw(seeded(779), 1)  # a generator of its own: no other draw moves
    trace = common.make_trace(vol_span, ds, autodiff=autodiff,
                              use_mesh=params.get("mesh", False), gradient=grad_holder,
                              probe_rays=(probe.x[:4096], probe.v[:4096]), device=dev)
    metrics.log(0, exit_buckets=trace.nbuckets)  # the adjoint steps' buckets

    def view_images(eta, gen, samples):
        rays, rpv, tpv = draw(gen, samples)
        planes = common.per_view_planes(rays.planes, rpv)
        xm, vm = trace(eta, rays.x, rays.v)
        xmp, vmp = sensors.trace_rays_to_plane((xm, vm), (rays.planes[:, 0, :],
                                                          rays.planes[:, 1, :]))
        views = [common.split_views(a, rpv) for a in (xmp, vmp, rays.mask, 1.0 / tpv ** 2)]
        return views, planes

    def near_images(views, planes):
        (xs, vs, ms, dists), (sensor_p, sensor_n, sensor_t) = views, planes
        return [S.sum_norm(sensors.generate_sensor((xv, vv), d, (sp, sn), nbins, span, st,
                                                   mask=mk))
                for xv, vv, sp, sn, st, mk, d in zip(xs, vs, sensor_p, sensor_n, sensor_t,
                                                     ms, dists)]

    def loss_function(eta, gen):
        views, planes = view_images(eta, gen, spp)
        (xs, vs, ms, _), (sensor_p, sensor_n, sensor_t) = views, planes

        near_loss = 0.0
        if sdf_loss and sdf_disp[0] is not None:
            near_sdf = [sensors.get_sdf_vals_near((xv, vv), sdi, (sp, sn), span, st)
                        for xv, vv, sdi, sp, sn, st in zip(xs, vs, sdf_disp, sensor_p,
                                                           sensor_n, sensor_t)]
            near_loss = sum((sdi ** 2).sum() / sdi.numel() for sdi in near_sdf)
        elif disp_ims[0] is not None:
            near_loss = sum(image_mse(im, meas) for im, meas in
                            zip(near_images(views, planes), disp_ims)) / len(disp_ims)

        far_loss = 0.0
        if sdf_loss and sdf_defl[0] is not None:
            far_sdf = [sensors.get_sdf_vals_far((xv, vv), sdi, (sp, sn), far_sensor_span, st)
                       for xv, vv, sdi, sp, sn, st in zip(xs, vs, sdf_defl, sensor_p,
                                                          sensor_n, sensor_t)]
            far_loss = defl_weight * sum((sdi ** 2).sum() / sdi.numel() for sdi in far_sdf)
        elif defl_ims[0] is not None:
            far_images = [
                S.sum_norm(sensors.generate_inf_sensor((xv, vv), 1.0, (sp, sn), nbins,
                                                       far_sensor_span, st, mask=mk))
                for xv, vv, sp, sn, st, mk in zip(xs, vs, sensor_p, sensor_n, sensor_t, ms)]
            far_loss = defl_weight * sum(image_mse(im, meas)
                                         for im, meas in zip(far_images, defl_ims))

        return near_loss + far_loss

    def log_function(iter_count, eta):
        metrics.log(iter_count, res=eta.shape[0])
        if result_dir is None or record_iters > 10 ** 8 or iter_count % record_iters != 0:
            return
        with torch.no_grad():
            images = near_images(*view_images(eta, seeded(200_000 + iter_count), spp * 2))
        from ..utils.plotting import save_multiple_images
        save_multiple_images(images, f"{result_dir}/multiview_{iter_count}.png")

    n0 = params.get("init")
    n0 = (torch.ones((res_list[0],) * 3, dtype=dtype, device=dev) if n0 is None
          else torch.as_tensor(n0).to(device=dev, dtype=dtype))

    if params.get("grad_spotcheck", True) and not autodiff:
        rays, _, _ = draw(seeded(777), 1)
        common.gradient_spotcheck(n0, rays.x, rays.v, vol_span, ds, mask=rays.mask,
                                  metrics=metrics)
    rays_per_iter = nbins * nbins * spp * nviews
    stage_fn = None
    if params.get("auto_exact", True) and not autodiff and params.get("gradient") is None:
        def _probe_rays():
            r, _, _ = draw(seeded(778), 1)
            return r.x, r.v, r.mask
        stage_fn = common.make_stage_escalator(grad_holder, vol_span, ds, _probe_rays, metrics,
                                               rays_per_iter=rays_per_iter)

    def stat(it, loss, secs):
        metrics.log(it, loss=loss, secs=round(secs, 3), rays=rays_per_iter,
                    rays_per_s=round(rays_per_iter / max(secs, 1e-9), 1))
        if stat_fn is not None:
            stat_fn(it, loss, secs)

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


def run_multiview_exp(result_dir="results/multiview", resolution=128, optim_iters=10,
                      device="cuda", *, stat_fn=None, metrics: Optional[MetricsLogger] = None,
                      sample_rays=None, **overrides):
    """The einstein / turing two-view experiment.  ``stat_fn``, ``metrics``
    and ``sample_rays`` go to :func:`multires_exp`."""
    from .voxel_scenes import data_path

    ims = [S.sum_norm(load_image(data_path(name), resolution, device=device))
           for name in ("einstein.png", "turing.png")]
    params = dict(disp_ims=ims, optim_iters=optim_iters, record_iters=optim_iters,
                  nbins=resolution)
    params.update(overrides)  # explicit overrides win (e.g. record_iters)
    return multires_exp(params, result_dir, device=device, stat_fn=stat_fn, metrics=metrics,
                        sample_rays=sample_rays)


if __name__ == "__main__":
    run_multiview_exp()
