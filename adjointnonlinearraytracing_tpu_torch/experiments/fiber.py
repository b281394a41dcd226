"""GRIN-fiber radial-profile optimisation.

Twin of ``adjointnonlinearraytracing_tpu/experiments/fiber.py``.  Optimises
the 1D radial refractive-index profile of a graded-index fiber so that a
planar (or cone) bundle entering the bottom cap comes to a focus at
``sensor_distance`` and again one ``hop_distance`` later (weighted by
``hop_weight``).  The known answer is the self-focusing profile
``n(r) = sqrt(2 - r^2)`` (:func:`ground_truth`).

The driver keeps its own loop per resolution, as the JAX one does: a fresh
Adam each stage with ``lr * 0.5^max(k-1, 0)``, the boundary bin's gradient
zeroed, the projection ``n >= 1`` when ``projected_step``, and the
midpoint-insertion upsampling between stages.  Entry rays are normalised by
the profile at their start (``|v| = n`` on entry).  Three gradient modes:
the constant-memory adjoint (``tracer.trace_cable``: K7, K8 on the card), the
tape (``"ad"`` or ``autodiff``: ``trace_cable_ad``) and the exact gradient
(``"exact"``: ``trace_cable_exact``, K9, K10), to which the per-stage spot
check escalates where the adjoint drifts.  A step's two passes (the near and
the hop focus) trace the same rays, so they are traced as one batch
(:class:`FiberLoss`): one forward and one backward launch a step on the card.

Everything runs on the GPU unless the caller passes ``device="cpu"``; with no
GPU and no such argument :func:`multires_exp` raises.  Each step draws fresh
rays on the device from the run's generator.
"""

from __future__ import annotations

import os
import time
import warnings
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..convert import profile_from_numpy, require_device
from ..fields.cylinder import CylinderField, cyl_eval_grad, upres_profile_midpoint
from ..opt.multires import adam_init, adam_update
from ..sources import sources as S
from ..tracer import api, checkpointed
from ..utils.metrics import MetricsLogger
from . import common


def ground_truth(res: int, dtype=torch.float32, device="cuda") -> torch.Tensor:
    """``n(r) = sqrt(2 - r^2)`` on ``[0, 1]`` at ``res`` points."""
    r = torch.linspace(0.0, 1.0, res, dtype=dtype, device=require_device(device))
    return torch.sqrt(2.0 - r ** 2)


def default_params() -> Dict:
    return dict(
        hop_distance=3.14,
        cable_length=5.0,
        cable_radius=1.0,
        cone_ang=30.0,
        camera_span=0.1,
        lr=0.01,
        src_type="planar",
        res_list=[3, 5, 9, 17, 33, 65, 129],
        optim_iters=30,
        record_iters=30,
        nbins=64,
        spp=1,
        npasses=1,
        sensor_distance=1.57,
        hop_weight=0.1,
        plane_epsilon=0.001,
        # without the n >= 1 projection the profile dips below 1 on long
        # stages and the entry normalisation v /= n_bound diverges
        projected_step=True,
        autodiff=False,
        seed=0,
    )


def gen_start_rays(params: Dict, gen: torch.Generator, dtype=torch.float32) -> S.Rays:
    """The rays of one step: ``nbins^2 * spp`` from a planar source cropped to
    the fiber's disk (``src_type`` ``"planar"``) or a cone source, drawn from
    ``gen`` on its device."""
    radius = params.get("cable_radius", 1.0)
    nbins = params.get("nbins", params.get("res_list", [32])[-1])
    spp = params.get("spp", 1)
    sensor_dist = params.get("sensor_distance", 0)
    if params.get("src_type", "planar") == "planar":
        return S.plane_source3_rand(gen, 0.0, (nbins, nbins), spp, radius * 2, circle=True,
                                    sensor_dist=sensor_dist - radius * 2, dtype=dtype)
    return S.cone_source3_rand(gen, 0.0, (nbins, nbins), spp, radius * 2,
                               sensor_dist=sensor_dist, cone_angle=params.get("cone_ang", 100.0),
                               dtype=dtype)


class FiberLoss(NamedTuple):
    """The loss of one step: the squared distance of each ray's closest
    approach to its focal point, the near one (on the rays' sensor plane) and
    the hop one (``hop_distance`` along the plane's normal, weighted by
    ``hop_weight``).  Both passes trace the same rays, so :meth:`step` traces
    them once, as one batch of twice the rays (K7 and K8, or K9 and K10, once
    a step on the card), and takes each pass's loss from its half."""

    radius: float
    length: float
    camera_span: float
    hop_distance: float
    hop_weight: float
    plane_epsilon: float

    @classmethod
    def from_params(cls, params: Dict) -> "FiberLoss":
        radius = params.get("cable_radius", 1.0)
        return cls(radius, params.get("cable_length", float(params.get("res_list", [32])[-1])),
                   params.get("camera_span", radius), params.get("hop_distance", 3.14),
                   params.get("hop_weight", 0.1), params.get("plane_epsilon", 0.001))

    def trace(self, nt, x, v, sp, mode: str):
        """The closest approach of the rays ``(x, v)`` to ``sp`` in the profile
        ``nt``, the rays normalised by the profile at their start; ``mode``
        ``"adjoint"``, ``"ad"`` (the tape) or ``"exact"`` picks the gradient."""
        sds = self.radius / nt.shape[0] / 2
        n_bound, _ = cyl_eval_grad(CylinderField(nt, self.radius, self.length), x)
        v = v / n_bound[:, None]  # |v| = n on entry
        fn = {"ad": api.trace_cable_ad, "exact": checkpointed.trace_cable_exact,
              "adjoint": api.trace_cable}[mode]
        return fn(nt, self.radius, self.length, x, v, sp, sds)

    def pass_loss(self, xm, dist2, sp, mask):
        """Squared distance of the closest approach to the (hopped) focal
        point, over the live rays not already within ``plane_epsilon`` of it."""
        eps_mask = (dist2 > self.plane_epsilon ** 2) & mask
        nrays = torch.clamp(mask.sum(), min=1)  # the live rays
        loss_vec = torch.where(eps_mask[:, None], (xm - sp) ** 2, torch.zeros_like(xm)) \
            / nrays / self.radius
        return loss_vec.sum() / self.camera_span

    def targets(self, rays: S.Rays, hop: float):
        """The focal points ``hop`` along each ray's sensor-plane normal."""
        return rays.planes[:, 0, :] + hop * rays.planes[:, 1, :]

    def step(self, nt, rays: S.Rays, mode: str):
        """Both passes' loss from one trace of the rays twice over."""
        n = rays.x.shape[0]
        sp = torch.cat([self.targets(rays, 0.0), self.targets(rays, self.hop_distance)])
        xm, _, dist2 = self.trace(nt, torch.cat([rays.x, rays.x]), torch.cat([rays.v, rays.v]),
                                  sp, mode)
        return (self.pass_loss(xm[:n], dist2[:n], sp[:n], rays.mask)
                + self.hop_weight * self.pass_loss(xm[n:], dist2[n:], sp[n:], rays.mask))


def multires_exp(params: Dict, result_dir: Optional[str] = None, *, device="cuda",
                 sample_rays: Optional[Callable[[torch.Generator, int], S.Rays]] = None,
                 stat_fn: Optional[Callable[[int, float, float], None]] = None,
                 metrics: Optional[MetricsLogger] = None):
    """Main driver.  Returns ``(final_profile, loss_hist)``.

    ``sample_rays(gen, samples) -> Rays`` replaces the draw of the source's
    rays (tests hand both packages the same rays with it);
    ``stat_fn(iteration, loss, seconds)`` is called after every step, once its
    loss is read back; ``metrics`` takes the place of the logger made from
    ``result_dir``.  ``init_profile`` (an array, or the path of a fiber
    ``result.npz`` of either package) starts the run from a saved profile of
    ``res_list[0]`` bins.
    """
    dev = require_device(device)
    init_offset = params.get("init_offset", 0)
    res_list = params.get("res_list", [32])
    loss_of = FiberLoss.from_params(params)
    cable_radius, cable_length = loss_of.radius, loss_of.length
    spp = params.get("spp", 1)
    optim_iters = params.get("optim_iters", 300)
    record_iters = params.get("record_iters", optim_iters)
    projected_step = params.get("projected_step", False)
    lr = params.get("lr", 1e-4)
    autodiff = params.get("autodiff", False)
    seed = params.get("seed", 0)
    dtype = common.param_dtype(params)

    if result_dir:  # its checkpoints and files, with or without a metrics file there
        os.makedirs(result_dir, exist_ok=True)
    if metrics is None:
        metrics = MetricsLogger(f"{result_dir}/metrics.jsonl" if result_dir else None,
                                append=params.get("resume_from") is not None)

    def draw(gen):
        if sample_rays is None:
            return gen_start_rays(params, gen, dtype)
        return S.Rays(*(t.to(dev) for t in sample_rays(gen, spp)))

    def seeded(offset):
        return torch.Generator(device=dev).manual_seed(seed + offset)

    # the gradient mode, read at every step: the per-stage spot check flips
    # it from the adjoint to "exact" where the adjoint drifts
    grad_holder = {"mode": params.get("gradient")}

    def mode():
        m = grad_holder.get("mode")
        if m == "ad" or (m is None and autodiff):
            return "ad"
        return "exact" if m == "exact" else "adjoint"

    def probe_grad(fn, nt, rays):
        xs, vs, sp0 = rays.x[:512], rays.v[:512], rays.planes[:512, 0, :]
        p = nt.detach().clone().requires_grad_(True)
        xm, vm, _ = fn(p, cable_radius, cable_length, xs, vs, sp0, cable_radius / p.shape[0] / 2)
        (g,) = torch.autograd.grad((xm ** 2 + xm * vm).sum(), p)
        return g

    init = params.get("init_profile")
    if init is not None:
        # refinement or resume from a saved profile of res_list[0] bins
        n = profile_from_numpy(init, device=dev, dtype=dtype)
        if n.shape[0] != res_list[0]:
            raise ValueError(f"init_profile has {n.shape[0]} bins, res_list starts at "
                             f"{res_list[0]}")
    else:
        n = torch.ones((res_list[0],), dtype=dtype, device=dev) + init_offset

    if params.get("grad_spotcheck", True) and not autodiff:
        # the adjoint against the tape on 512 of the run's rays, on the start
        # profile with a smooth bump
        rays0 = draw(seeded(777))
        nprobe = n + 0.05 * torch.exp(
            -torch.linspace(0.0, 1.0, n.shape[0], dtype=dtype, device=dev) ** 2 / 0.18)
        g_adj = probe_grad(api.trace_cable, nprobe, rays0)
        g_ad = probe_grad(api.trace_cable_ad, nprobe, rays0)
        scale = torch.clamp(g_ad.abs().max(), min=1e-30)
        metrics.log(0, grad_spotcheck=float((g_adj - g_ad).abs().max() / scale))

    def stage_spotcheck(stage, nt):
        """The adjoint against the exact gradient on the current profile at the
        start of every stage after the first; escalates to the exact gradient
        for the remaining stages past ``ANRT_EXACT_TOL`` (rel-L2, default 0.01)."""
        if grad_holder.get("mode") not in (None, "adjoint") or autodiff or stage == 0:
            return
        tol = float(os.environ.get("ANRT_EXACT_TOL", "0.01"))
        rays0 = draw(seeded(778))
        g_adj = probe_grad(api.trace_cable, nt, rays0)
        g_ex = probe_grad(checkpointed.trace_cable_exact, nt, rays0)
        l2 = float(torch.linalg.norm(g_adj - g_ex)
                   / torch.clamp(torch.linalg.norm(g_ex), min=1e-30))
        metrics.log(0, **{f"grad_spotcheck_stage{stage}_rel_l2": l2})
        if l2 > tol:
            grad_holder["mode"] = "exact"
            warnings.warn(
                f"fiber stage {stage} ({nt.shape[0]} bins): cable adjoint "
                f"rel-L2 drift {l2:.2e} > {tol:g}; escalating to "
                "trace_cable_exact for the remaining stages")
            metrics.log(0, gradient_escalated_stage=stage, gradient_mode="exact")

    gen = seeded(0)
    loss_hist = []
    cum_steps = 0
    for res_iter in range(len(res_list)):
        if params.get("auto_exact", True):
            stage_spotcheck(res_iter, n)
        stage_lr = (0.5 ** max(res_iter - 1, 0)) * lr
        adam = adam_init(n)
        for j in range(optim_iters * (res_iter + 1)):
            t0 = time.perf_counter()
            nt = n.detach().requires_grad_(True)
            rays = draw(gen)
            loss = loss_of.step(nt, rays, mode())
            (g,) = torch.autograd.grad(loss, nt)
            g[-1] = 0.0  # the boundary bin is frozen
            with torch.no_grad():
                n, adam = adam_update(n, g, adam, stage_lr)
                if projected_step:
                    n = torch.clamp(n, min=1.0)
            loss_f = float(loss.detach())  # reads the loss back: the step has finished
            loss_hist.append(loss_f)
            it = j + cum_steps
            if stat_fn is not None:
                stat_fn(it, loss_f, time.perf_counter() - t0)
            metrics.log(it, loss=loss_f, res=n.shape[0])
            if result_dir and it % record_iters == 0:
                from ..utils.plotting import save_profile_plot
                save_profile_plot(n, g, f"{result_dir}/fiber_profile_{it}.png")
        cum_steps += optim_iters * (res_iter + 1)
        if res_iter < len(res_list) - 1:
            while n.shape[0] < res_list[res_iter + 1]:
                n = upres_profile_midpoint(n)

    if result_dir:
        from ..utils.plotting import save_loss_plot
        save_loss_plot(loss_hist, f"{result_dir}/loss_plot.png")
        np.savez(f"{result_dir}/result.npz", rif=n.detach().cpu().numpy(),
                 loss_hist=np.asarray(loss_hist))
    return n, loss_hist


if __name__ == "__main__":
    multires_exp(default_params(), "results/fiber")
