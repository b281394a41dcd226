"""The single-view control of the einstein / turing flagship.

Twin of the JAX system's repo-root script ``run_image_singleview.py``.  Is
the two-view flagship's correlation ceiling an optimisation failure or the
two views' coupling?  The same pipeline (loss, gradient, ladder and budget:
``image.multires_exp`` with 128^2 x 8 spp rays, the per-view scale, a 4-level
pyramid) is run on one target view, einstein, to 65^3; a fresh render of one
view of 128^2 x 32 spp drawn from seed 1234 is then correlated with the
target (:func:`single_view_correlation`).  A single view that correlates far
better puts the ceiling in the coupling.

Run on the card from the repo root::

    python -m adjointnonlinearraytracing_tpu_torch.experiments.image_singleview

with the script's variables ``SV_DIR`` (default
``results/image_singleview_torch``, beside the JAX record), ``SV_RES_LIST``
and ``SV_ITERS``.  Writes the driver's files and ``report.json`` into
``SV_DIR``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..convert import require_device
from ..sources import sources as S
from . import image
from .image_flagship import (CORR_SEED, CORR_SPP, RESOLUTION, VOL_SPAN, corr,
                             correlation_rays, load_target, render_views, save_report)

RESULT_DIR = "results/image_singleview_torch"
TARGET = "einstein.png"


@dataclasses.dataclass(frozen=True)
class Settings:
    """What the JAX script reads from its environment (``SV_*``)."""

    result_dir: str = RESULT_DIR
    res_list: Tuple[int, ...] = (3, 5, 9, 17, 33, 65)
    iters: int = 30

    @classmethod
    def from_env(cls, environ=os.environ) -> "Settings":
        res = environ.get("SV_RES_LIST")
        return cls(result_dir=environ.get("SV_DIR", cls.result_dir),
                   res_list=tuple(int(r) for r in res.split(",")) if res else cls.res_list,
                   iters=int(environ.get("SV_ITERS", "30")))


def run_params(settings: Settings, target) -> dict:
    """The script's parameters of ``image.multires_exp``."""
    return dict(disp_ims=[target], res_list=list(settings.res_list),
                optim_iters=settings.iters, record_iters=200, nbins=RESOLUTION,
                vol_span=VOL_SPAN, step_res=2, spp=8, lr=1e-4, seed=0,
                per_view_norm=True, pyramid_levels=4)


def single_view_correlation(eta, target, resolution: int = RESOLUTION, spp: int = CORR_SPP,
                            seed: int = CORR_SEED, rays: Optional[S.Rays] = None,
                            device="cuda") -> float:
    """The correlation of a fresh one-view render of ``eta`` with ``target``
    (``rays`` in place of the draw), as the script computes it."""
    dev = require_device(device)
    eta = torch.as_tensor(eta).to(dev)
    if rays is None:
        rays = correlation_rays(1, resolution, spp, seed, dev, eta.dtype)
    (im,) = render_views(eta, rays, 1, resolution)
    target = target.cpu().numpy() if isinstance(target, torch.Tensor) else np.asarray(target)
    return corr(im, target)


def run(settings: Settings, device="cuda", rays: Optional[S.Rays] = None, stat_fn=None,
        metrics=None, sample_rays=None):
    """The control run and its report.  ``stat_fn``, ``metrics`` and
    ``sample_rays`` go to ``image.multires_exp``; ``rays`` replaces the
    correlation's draw.  Returns ``(eta, loss history, report)``."""
    dev = require_device(device)
    target = load_target(TARGET, RESOLUTION, dev)
    eta, hist = image.multires_exp(run_params(settings, target), settings.result_dir,
                                   device=dev, stat_fn=stat_fn, metrics=metrics,
                                   sample_rays=sample_rays)
    c = single_view_correlation(eta, target, rays=rays, device=dev)
    return eta, hist, save_report(eta, hist, {"corr_einstein_single_view": c},
                                  settings.result_dir, dev)


if __name__ == "__main__":
    run(Settings.from_env())
