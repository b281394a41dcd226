"""The fuel-injection north star: a 129^3 grid, 10,485,760 rays an iteration.

Twin of the JAX system's repo-root script ``run_fuel_northstar.py``, the run
``BASELINE.md`` names as its north star.  The 64^3 fuel volume resampled to
the last stage's grid is traced once, at that stage's step size, through a
FIXED measurement set of 32 views x 128^2 pixels x 20 spp = 10,485,760 rays
(``sensor_dist=0``); then a coarse-to-fine ladder (9 -> 17 -> 33 -> 65 ->
129 by default) recovers the field, each iteration summing the voxel
gradient of ``cpi`` microbatches of ``CHUNK`` rays (the whole set in 16
microbatches at 129^3).  Per stage:

* ``ds = ds_alpha * h_stage`` (``ds_mode="final"``: the last stage's),
* an adjoint-against-exact gradient spot check on the first 2,048 rays at
  ``perturb_amp = 10 * FUEL_VAL`` (one K2, K3, K5 and K6 launch on the card),
* a masked Adam step (the boundary shell frozen), then ``eta >= 1``,
* ``reconstruction_error`` every ``err_every`` iterations and at the end,

and between stages the field and Adam's moments are resampled to the next
grid, Adam's step count is kept and the learning rate halved.

Everything stays on the device: the measurement set with its ground-truth
exits (about 0.8 GB at full width in f32) and every microbatch, a slice
``c*CHUNK:(c+1)*CHUNK`` of it.  A microbatch is one ``tracer.trace`` (K2
forward, K3 backward) unless the run takes exit-step buckets: on the card
only from ``ANRT_BUCKETED``, off it also by the JAX package's rule on the
first 8,192 rays (``common.exit_buckets``); the outputs are the same either
way (``compaction.trace_bucketed`` takes ``api.trace`` whole where there are
none).  The losses of an iteration are read back once, after its Adam step,
and summed in the JAX script's order.

Run it on the card from the repo root::

    python -m adjointnonlinearraytracing_tpu_torch.experiments.northstar

with the JAX script's settings in the environment: ``NS_STAGES``
(``"res:iters:chunks,..."``), ``NS_LR``, ``NS_ERR_EVERY``, ``NS_DS_MODE``
(``stage`` | ``final``), ``NS_DS_ALPHA``, ``NS_TV`` and ``NS_REG`` (the
prior's weight and kind, ``tv`` | ``h1``), ``NS_INIT`` (an ``eta_<res>.npy``
to start the first stage from, the JAX script's files too), ``NS_SCALE``
(divides views and pixels) and ``NS_DIR``; ``NS_CPU=1`` runs the plain
versions on the CPU.  Results go to ``NS_DIR`` (default
``results/fuel_northstar_torch``, beside the JAX record): ``metrics.jsonl``
(appended to; an iteration's ``secs`` and ``rays_per_s`` unrounded),
``report.json`` (with ``rel_norm`` at the end of every stage,
``reconstruction_per_stage``; :func:`read_report` reads it back),
``eta_<res>.npy`` after each stage and ``final_eta.npy``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..convert import require_device, rif_from_numpy
from ..fields.grid import upres_volume
from ..opt.multires import (adam_init, adam_update, boundary_interior_mask, upres_adam_state,
                            upres_scene)
from ..sensors import trace_rays_to_plane
from ..sources import sources as S
from ..tracer import compaction
from ..utils.profiling import card_line
from . import common, fuel_injection, voxel_scenes

VOL_SPAN = 1.0
FUEL_VAL = 0.0003
DEFL_WEIGHT = 1.0
BG = 1.0 + FUEL_VAL
NVIEWS, NBINS, SPP = 32, 128, 20
#: microbatches in the whole measurement set
NCHUNKS = 16
#: ``(res, iterations, microbatches an iteration)`` of the shipped ladder
SHIPPED_STAGES = ((9, 100, 1), (17, 100, 1), (33, 300, 2), (65, 200, 4), (129, 60, 16))
#: rays of each stage's gradient spot check, and of the bucket rule's probe
SPOT_RAYS, PROBE_RAYS = 2048, 8192


def default_stages(scale: int):
    """The ladder the JAX script runs at ``scale``: the shipped one at 1, a
    two-stage dry run above."""
    return SHIPPED_STAGES if scale == 1 else ((9, 3, 2), (17, 2, 16))


def parse_stages(text: str):
    """``"33:200:2,65:100:4"`` as ``((33, 200, 2), (65, 100, 4))``."""
    return tuple(tuple(int(v) for v in s.split(":")) for s in text.split(","))


@dataclasses.dataclass(frozen=True)
class Settings:
    """What the JAX script reads from its environment (``NS_*``).

    ``stages`` None takes :func:`default_stages` of ``scale``; ``init`` is the
    path of a saved ``eta`` to start from; ``result_dir`` None writes no files.
    """

    stages: Optional[Tuple[Tuple[int, int, int], ...]] = None
    lr: float = 1e-4
    err_every: int = 20
    ds_mode: str = "stage"
    ds_alpha: float = 0.5
    tv_weight: float = 0.0
    reg: str = "tv"
    init: Optional[str] = None
    scale: int = 1
    result_dir: Optional[str] = "results/fuel_northstar_torch"

    @property
    def ladder(self):
        return tuple(self.stages) if self.stages is not None else default_stages(self.scale)

    @classmethod
    def from_env(cls, environ=os.environ) -> "Settings":
        """The settings as the JAX script reads them, from the same variables."""
        return cls(
            stages=parse_stages(environ["NS_STAGES"]) if environ.get("NS_STAGES") else None,
            lr=float(environ.get("NS_LR", "1e-4")),
            err_every=int(environ.get("NS_ERR_EVERY", "20")),
            ds_mode=environ.get("NS_DS_MODE", "stage"),
            ds_alpha=float(environ.get("NS_DS_ALPHA", "0.5")),
            tv_weight=float(environ.get("NS_TV", "0")),
            reg=environ.get("NS_REG", "tv"),
            init=environ.get("NS_INIT") or None,
            scale=int(environ.get("NS_SCALE", "1")),
            result_dir=environ.get("NS_DIR", cls.result_dir))

    def final_ds(self) -> float:
        return VOL_SPAN / (self.ladder[-1][0] - 1) * self.ds_alpha

    def stage_ds(self, res: int) -> float:
        if self.ds_mode == "final":
            return self.final_ds()
        return VOL_SPAN / (res - 1) * self.ds_alpha


#: where a run with the default settings writes its report
REPORT = os.path.join(Settings.result_dir, "report.json")


def measurement_set(gen: Optional[torch.Generator] = None, scale: int = 1, device="cuda",
                    dtype=torch.float32) -> S.Rays:
    """The fixed measurement rays: ``32/scale`` views of ``(128/scale)^2``
    pixels x 20 spp from ``rand_rays_in_sphere`` (``sensor_dist=0``), drawn
    on ``device`` from ``gen`` (a generator seeded with 0 there if None)."""
    dev = require_device(device)
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(0)
    rays, _ = S.rand_rays_in_sphere(gen, NVIEWS // scale, (NBINS // scale,) * 2, SPP, VOL_SPAN,
                                    sensor_dist=0, dtype=dtype)
    return rays


class Measurements:
    """The measurement set on the device, split into its per-ray tensors, with
    the ground truth's plane-projected exits (:meth:`trace_ground_truth`)."""

    def __init__(self, rays: S.Rays, device, dtype):
        self.x = rays.x.to(device=device, dtype=dtype).contiguous()
        self.v = rays.v.to(device=device, dtype=dtype).contiguous()
        planes = rays.planes.to(device=device, dtype=dtype)
        self.sp = planes[:, 0, :].contiguous()
        self.sn = planes[:, 1, :].contiguous()
        self.mask = rays.mask.to(device)
        self.nrays = self.x.shape[0]
        self.chunk = self.nrays // NCHUNKS
        self.xg = self.vg = None

    def rows(self, c: int) -> slice:
        return slice(c * self.chunk, (c + 1) * self.chunk)

    def trace_ground_truth(self, gt, ds: float, nbuckets: int) -> None:
        """The ground truth's exits on the sensor planes, a microbatch at a time
        (forward passes only: one K2 each, or one a bucket)."""
        h = VOL_SPAN / (gt.shape[0] - 1)
        xg, vg = [], []
        with torch.no_grad():
            for c in range(NCHUNKS):
                s = self.rows(c)
                xm, vm = compaction.trace_bucketed(gt, self.x[s], self.v[s], h, ds, nbuckets)
                xp, vp = trace_rays_to_plane((xm, vm), (self.sp[s], self.sn[s]))
                xg.append(xp)
                vg.append(vp)
        self.xg, self.vg = torch.cat(xg), torch.cat(vg)


def make_chunk_loss(data: Measurements, nbuckets: int, tv_weight: float = 0.0,
                    reg: str = "tv") -> Callable:
    """``chunk_loss(eta, c, h, ds)``: microbatch ``c``'s loss, the JAX script's
    ``(disp + DEFL_WEIGHT * defl) / FUEL_VAL`` of the plane-projected exits
    against the ground truth's, with the prior added per microbatch (the
    iteration divides the sum by ``cpi``, so it enters the iteration's loss
    once)."""

    def chunk_loss(eta, c, h, ds):
        s = data.rows(c)
        xm, vm = compaction.trace_bucketed(eta, data.x[s], data.v[s], h, ds, nbuckets)
        xmp, vmp = trace_rays_to_plane((xm, vm), (data.sp[s], data.sn[s]))
        m = data.mask[s]
        disp = common.masked_mean_sq(xmp - data.xg[s], m) / 3.0
        defl = common.masked_mean_sq(vmp - data.vg[s], m) / 3.0
        loss = (disp + DEFL_WEIGHT * defl) / FUEL_VAL
        if tv_weight:
            loss = loss + tv_weight * fuel_injection.regularizer(eta, FUEL_VAL, reg)
        return loss

    return chunk_loss


def value_and_grad(loss_fn: Callable, eta, *args):
    """``(loss, d loss / d eta)`` of ``loss_fn(eta, *args)``, both detached."""
    leaf = eta.detach().requires_grad_(True)
    loss = loss_fn(leaf, *args)
    (g,) = torch.autograd.grad(loss, leaf)
    return loss.detach(), g


def initial_field(settings: Settings, dtype=torch.float32, device="cuda"):
    """The first stage's field: the background ``1 + FUEL_VAL``, or the saved
    ``settings.init`` (an ``eta_<res>.npy`` of either package) resampled to
    the first stage's grid where it is coarser."""
    res0 = settings.ladder[0][0]
    dev = require_device(device)
    if settings.init:
        eta = rif_from_numpy(np.load(settings.init), device=dev, dtype=dtype)
        if eta.shape[0] != res0:
            eta = upres_scene(eta, res0)
        return eta
    return torch.ones((res0,) * 3, dtype=dtype, device=dev) + FUEL_VAL


def read_report(path: str) -> Tuple[int, float, dict]:
    """The reconstruction errors of a north-star ``report.json`` (this module's
    or the JAX system's record): ``(final grid, its rel_norm, {stage grid:
    rel_norm})``.  Raises, naming ``path``, where the file or a key is missing."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no north-star report at {path}: run python -m "
                                f"adjointnonlinearraytracing_tpu_torch.experiments.northstar "
                                f"first, or name another report")
    with open(path) as f:
        report = json.load(f)
    try:
        final = int(str(report["grid"]).split("^")[0])
        per_stage = {int(r): float(v) for r, v in report["reconstruction_per_stage"].items()}
        return final, float(report["reconstruction"]["rel_norm"]), per_stage
    except KeyError as e:
        raise KeyError(f"the north-star report {path} has no {e}") from None


def run(settings: Settings, rays: Optional[S.Rays] = None, device="cuda",
        on_row: Optional[Callable[[dict], None]] = None):
    """The north-star run of ``settings`` on ``device``.

    ``rays`` replaces the drawn measurement set (the tests hand in the JAX
    package's draws); the run takes its dtype, f32 where it draws its own.
    ``on_row(row)`` sees every row of ``metrics.jsonl`` as it is written.
    Returns ``(eta, report)``: the final field on ``device`` and the JAX
    script's report, with ``device`` and ``card`` added.
    """
    dev = require_device(device)
    stages = settings.ladder
    res_final = stages[-1][0]
    ds_fin = settings.final_ds()
    if rays is None:
        rays = measurement_set(scale=settings.scale, device=dev)
    dtype = rays.x.dtype
    data = Measurements(rays, dev, dtype)
    del rays  # the drawn planes: the run keeps their first two rows only
    if data.nrays != data.chunk * NCHUNKS:
        raise ValueError(f"northstar: {data.nrays} rays do not split into {NCHUNKS} microbatches")
    nbuckets = common.exit_buckets(VOL_SPAN, ds_fin,
                                   (data.x[:PROBE_RAYS], data.v[:PROBE_RAYS]))

    gt = upres_volume(voxel_scenes.fuel_injection_rif(FUEL_VAL, dtype, dev), (res_final,) * 3)
    data.trace_ground_truth(gt, ds_fin, nbuckets)
    chunk_loss = make_chunk_loss(data, nbuckets, settings.tv_weight, settings.reg)

    out = settings.result_dir
    if out:
        os.makedirs(out, exist_ok=True)
    metrics = open(os.path.join(out, "metrics.jsonl"), "a") if out else None

    def write(row):
        if metrics is not None:
            metrics.write(json.dumps(row) + "\n")
            metrics.flush()
        if on_row is not None:
            on_row(row)

    eta = initial_field(settings, dtype, dev)
    adam = adam_init(eta)
    stage_lr = settings.lr
    spotchecks, per_stage, it_total, loss, cpi = {}, {}, 0, 0.0, 1
    try:
        for stage, (res, iters, cpi) in enumerate(stages):
            ds = settings.stage_ds(res)
            h = VOL_SPAN / (res - 1)
            bmask = boundary_interior_mask(eta.shape, dtype, dev)
            stats = common.gradient_spotcheck(
                eta, data.x[:SPOT_RAYS], data.v[:SPOT_RAYS], VOL_SPAN, ds,
                mask=data.mask[:SPOT_RAYS], perturb_amp=10 * FUEL_VAL)
            spotchecks[str(res)] = stats
            write(dict(stage_start=res, ds=ds, grad_spotcheck=stats["max_rel"], **stats))
            for i in range(iters):
                t0 = time.perf_counter()
                g = torch.zeros_like(eta)
                losses = []
                for k in range(cpi):
                    lc, gc = value_and_grad(chunk_loss, eta, (i * cpi + k) % NCHUNKS, h, ds)
                    g = g + gc
                    losses.append(lc)
                with torch.no_grad():
                    eta, adam = adam_update(eta, (g / cpi) * bmask, adam, stage_lr)
                    eta = torch.clamp(eta, min=1.0)
                # the iteration's one read-back: it waits for the Adam step too
                loss = 0.0
                for lc in torch.stack(losses).tolist():
                    loss += lc
                dt = time.perf_counter() - t0
                nr = cpi * data.chunk
                rec = dict(iter=it_total, res=res, loss=loss / cpi, rays=nr, secs=dt,
                           rays_per_s=nr / dt)
                if i % settings.err_every == settings.err_every - 1 or i == iters - 1:
                    rec.update(fuel_injection.reconstruction_error(eta, gt, background=BG))
                write(rec)
                it_total += 1

            err = fuel_injection.reconstruction_error(eta, gt, background=BG)
            per_stage[str(res)] = err["rel_norm"]
            write(dict(stage=res, **err))
            if out:
                np.save(os.path.join(out, f"eta_{res}.npy"), eta.cpu().numpy())
            if stage < len(stages) - 1:
                new_res = stages[stage + 1][0]
                eta = upres_scene(eta, new_res)
                stage_lr *= 0.5
                adam = upres_adam_state(adam, new_res)
    finally:
        if metrics is not None:
            metrics.close()

    report = dict(
        grid=f"{res_final}^3", rays_per_iter=stages[-1][2] * data.chunk,
        final_loss=float(loss / cpi),
        reconstruction=fuel_injection.reconstruction_error(eta, gt, background=BG),
        reconstruction_per_stage=per_stage, grad_spotcheck_per_stage=spotchecks,
        stages=[list(s) for s in stages], lr=settings.lr,
        ds_mode=settings.ds_mode, ds_alpha=settings.ds_alpha, tv_weight=settings.tv_weight,
        reg=settings.reg, nbuckets=nbuckets, device=str(dev),
        card=card_line() if dev.type == "cuda" else None)
    if out:
        with open(os.path.join(out, "report.json"), "w") as f:
            json.dump(report, f, indent=2)
        np.save(os.path.join(out, "final_eta.npy"), eta.cpu().numpy())
    return eta, report


if __name__ == "__main__":
    _, _report = run(Settings.from_env(), device="cpu" if os.environ.get("NS_CPU") else "cuda",
                     on_row=lambda row: print(json.dumps(row), flush=True))
    print(json.dumps(_report))
