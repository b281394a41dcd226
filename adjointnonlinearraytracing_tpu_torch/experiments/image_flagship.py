"""The einstein / turing flagship: two views, 3^3 -> 129^3, scored against its targets.

Twin of the JAX system's repo-root script ``run_image_flagship.py``.  It runs
``image.run_multiview_exp`` with the script's settings (two views of 128^2 x
8 spp = 262,144 rays a step, ``vol_span`` 20, ``step_res`` 2, lr 1e-4, the
scale-invariant per-view match and a 4-level image pyramid, a checkpoint a
stage in ``<dir>/result.npz``), then :func:`write_report`: the correlation of
freshly rendered sensor images with the two target portraits
(:func:`target_correlation`: two views x 128^2 x 32 spp drawn from seed 1234,
one forward trace, each view's image correlated with its target whole and
4x-pooled), beside the loss history.

Run on the card from the repo root::

    python -m adjointnonlinearraytracing_tpu_torch.experiments.image_flagship \\
        [--resume] [--report-only [--checkpoint PATH]]

``--resume`` continues from ``<dir>/result.npz`` where it exists;
``--report-only`` scores a checkpoint without optimising: ``<dir>/result.npz``
or the ``--checkpoint`` given, of either package (a JAX-written file's key is
dropped, as ``convert.checkpoint_from_jax_npz`` drops it), such as the JAX
record ``results/einstein_turing_r4/result.npz``; the report goes into
``<dir>`` all the same.  The script's variables: ``IMG_DIR`` (default
``results/einstein_turing_torch``, beside the JAX records), ``IMG_RES_LIST``,
``IMG_ITERS`` (iterations a stage times the stage's index + 1; 40 makes the
record's 1,120 steps), ``IMG_RECORD``, ``IMG_PVNORM``, ``IMG_PYRAMID``.
:func:`main` runs on the card unless it is given ``device="cpu"``.  On the
card every step is one K2 and one K3, or one K5 and one K6 once the stage spot
check escalates to the exact gradient; the correlation is one K2.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
from typing import Optional, Tuple

import numpy as np
import torch

from .. import sensors
from ..convert import require_device
from ..opt.multires import load_checkpoint
from ..sources import sources as S
from ..tracer import api
from ..utils.profiling import card_line
from . import common, image
from .voxel_scenes import data_path

RESULT_DIR = "results/einstein_turing_torch"
RESOLUTION, VOL_SPAN, STEP_RES = 128, 20, 2
TARGETS = ("einstein.png", "turing.png")
#: the correlation's draw: spp and the generator's seed
CORR_SPP, CORR_SEED = 32, 1234


@dataclasses.dataclass(frozen=True)
class Settings:
    """What the JAX script reads from its environment (``IMG_*``)."""

    result_dir: str = RESULT_DIR
    res_list: Tuple[int, ...] = (3, 5, 9, 17, 33, 65, 129)
    iters: int = 50
    record_iters: int = 50
    per_view_norm: bool = True
    pyramid_levels: int = 4

    @classmethod
    def from_env(cls, environ=os.environ) -> "Settings":
        res = environ.get("IMG_RES_LIST")
        return cls(result_dir=environ.get("IMG_DIR", cls.result_dir),
                   res_list=tuple(int(r) for r in res.split(",")) if res else cls.res_list,
                   iters=int(environ.get("IMG_ITERS", "50")),
                   record_iters=int(environ.get("IMG_RECORD", "50")),
                   per_view_norm=environ.get("IMG_PVNORM", "1") == "1",
                   pyramid_levels=int(environ.get("IMG_PYRAMID", "4")))

    @property
    def checkpoint(self) -> str:
        return os.path.join(self.result_dir, "result.npz")


def run_params(settings: Settings, resume_from: Optional[str] = None) -> dict:
    """The keywords the script hands ``image.run_multiview_exp``."""
    return dict(result_dir=settings.result_dir, resolution=RESOLUTION,
                optim_iters=settings.iters, res_list=list(settings.res_list),
                vol_span=VOL_SPAN, step_res=STEP_RES, spp=8, lr=1e-4, seed=0,
                record_iters=settings.record_iters, resume_from=resume_from,
                per_view_norm=settings.per_view_norm,
                pyramid_levels=settings.pyramid_levels)


def correlation_rays(nviews: int, resolution: int, spp: int, seed: int, device, dtype):
    """The correlation's draw: ``nviews`` planar views of ``resolution^2`` x
    ``spp`` rays on the sphere (``sensor_dist=0``) from a generator seeded with
    ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rays, _ = S.rand_rays_in_sphere(gen, nviews, (resolution, resolution), spp, VOL_SPAN,
                                    sensor_dist=0, dtype=dtype)
    return rays


def render_views(eta, rays: S.Rays, nviews: int, resolution: int):
    """Each view's mean-normalised near-plane image (numpy) of ``rays`` (equal
    views) traced forward through ``eta`` at the flagship's step size."""
    h = VOL_SPAN / (eta.shape[0] - 1)
    ds = (VOL_SPAN / RESOLUTION) / STEP_RES
    rays = S.Rays(*(t.to(eta.device) for t in rays))
    rpv = [rays.x.shape[0] // nviews] * nviews
    planes = rays.planes.to(eta.dtype)
    sensor_p, sensor_n, sensor_t = common.per_view_planes(planes, rpv)
    with torch.no_grad():
        xm, vm = api.trace(eta, rays.x.to(eta.dtype), rays.v.to(eta.dtype), h, ds)
        xmp, vmp = sensors.trace_rays_to_plane((xm, vm), (planes[:, 0, :], planes[:, 1, :]))
        views = zip(common.split_views(xmp, rpv), common.split_views(vmp, rpv), sensor_p,
                    sensor_n, sensor_t, common.split_views(rays.mask, rpv))
        return [S.sum_norm(sensors.generate_sensor((xv, vv), 1.0, (sp, sn), resolution,
                                                   VOL_SPAN, st, mask=mk)).cpu().numpy()
                for xv, vv, sp, sn, st, mk in views]


def load_target(name: str, resolution: int, device="cuda") -> torch.Tensor:
    """A target portrait at ``resolution^2``, f32, mean-normalised."""
    return S.sum_norm(image.load_image(data_path(name), resolution, torch.float32, device))


def corr(x, y) -> float:
    """Pearson correlation of two images (numpy, in their own types)."""
    a = x.ravel() - x.mean()
    b = y.ravel() - y.mean()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def pool(x, k: int):
    """``k x k`` average pooling (cropped to a multiple of ``k``)."""
    n = (x.shape[0] // k) * k
    return x[:n, :n].reshape(n // k, k, n // k, k).mean(axis=(1, 3))


def target_correlation(eta, resolution: int = RESOLUTION, spp: int = CORR_SPP,
                       seed: int = CORR_SEED, rays: Optional[S.Rays] = None, device="cuda"):
    """``(corr, corr_pooled)``: per view, the correlation of a fresh render of
    ``eta`` with its target, whole and 4x-pooled (the structural measure: the
    per-pixel splat noise of a recognisable render dominates the whole-image
    one).  ``rays`` replaces the draw (two equal views)."""
    dev = require_device(device)
    eta = torch.as_tensor(eta).to(dev)
    if rays is None:
        rays = correlation_rays(len(TARGETS), resolution, spp, seed, dev, eta.dtype)
    ims = render_views(eta, rays, len(TARGETS), resolution)
    targets = [load_target(p, resolution, dev).cpu().numpy() for p in TARGETS]
    return ([corr(im, t) for im, t in zip(ims, targets)],
            [corr(pool(im, 4), pool(t, 4)) for im, t in zip(ims, targets)])


def save_report(eta, hist, corrs: dict, out_dir: str, device) -> dict:
    """``report.json`` in ``out_dir``: the loss history's ends, the final grid,
    the correlations ``corrs`` and the card's line; printed and returned."""
    report = {"first_loss": float(hist[0]), "last_loss": float(hist[-1]),
              "n_iters": len(hist), "stage_res": int(eta.shape[0]), **corrs,
              "card": card_line() if torch.device(device).type == "cuda" else None}
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "report.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report), flush=True)
    return report


def write_report(eta, hist, out_dir: str, device="cuda") -> dict:
    """The script's ``report.json`` in ``out_dir``: the loss history's ends,
    the final grid and the four correlations (and the card's line)."""
    dev = require_device(device)
    c, cp = target_correlation(eta, device=dev)
    return save_report(eta, hist, {"corr_einstein": c[0], "corr_turing": c[1],
                                   "corr4x_einstein": cp[0], "corr4x_turing": cp[1]},
                       out_dir, dev)


def load_field(path: str, device="cuda"):
    """``(eta, loss history)`` of a checkpoint of either package."""
    eta, _, hist, _ = load_checkpoint(path, device=device)
    return eta, hist


def run(settings: Settings, *, resume: bool = False, device="cuda", stat_fn=None,
        metrics=None, sample_rays=None):
    """The flagship run and its report.  ``stat_fn``, ``metrics`` and
    ``sample_rays`` go to ``image.multires_exp``.  Returns ``(eta, loss
    history, report)``."""
    resume_from = settings.checkpoint if resume and os.path.exists(settings.checkpoint) \
        else None
    eta, hist = image.run_multiview_exp(device=device, stat_fn=stat_fn, metrics=metrics,
                                        sample_rays=sample_rays,
                                        **run_params(settings, resume_from))
    return eta, hist, write_report(eta, hist, settings.result_dir, device=device)


def main(argv=None, environ=os.environ, device="cuda") -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    settings = Settings.from_env(environ)
    if "--report-only" in argv:
        path = (argv[argv.index("--checkpoint") + 1] if "--checkpoint" in argv
                else settings.checkpoint)
        eta, hist = load_field(path, device)
        return write_report(eta, hist, settings.result_dir, device=device)
    return run(settings, resume="--resume" in argv, device=device)[2]


if __name__ == "__main__":
    main()
