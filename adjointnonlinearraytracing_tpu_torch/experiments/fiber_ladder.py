"""The GRIN fiber's full ladder to 129 bins, then refinement phases.

Twin of the JAX system's repo-root script ``run_fiber_ladder.py``.  The
fiber driver (``fiber.multires_exp``, its default parameters: 3 -> 129 bins,
a planar source of 64^2 rays cropped to the disk, two passes a step) climbs
its ladder with ``iters`` Adam steps a stage times the stage's index + 1 and
``spp`` samples a pixel; then each refinement phase ``(lr, iters, spp)``
starts a fresh run at the last profile's bin count from that profile
(``init_profile``, seed ``100 + i``, no start-up check), to anneal under the
stochastic loss's noise floor.  After each phase the L1 distance of the
profile to ``n(r) = sqrt(2 - r^2)`` (:func:`l1_to_gt`) is written to
``report.json``, which is rewritten then, so that a cut run keeps its
phases; a phase whose profile holds a NaN is written as such.  ``init``
skips the ladder and refines a saved profile: a ``.npy`` of either package
or a fiber ``result.npz`` (``convert.profile_from_numpy``).

Run on the card from the repo root::

    python -m adjointnonlinearraytracing_tpu_torch.experiments.fiber_ladder

with the script's variables ``FIBER_DIR`` (default ``results/fiber_129_torch``,
beside the JAX records), ``FIBER_ITERS``, ``FIBER_SPP``, ``FIBER_REFINE``
(``"lr:iters:spp,..."``) and ``FIBER_INIT``.  Writes each run's files into
``FIBER_DIR`` and ``FIBER_DIR/refine<i>``, ``profile_refine<i>.npy`` after
each refinement, ``final_profile.npy`` and ``report.json``.  On the card every step is one K7
and one K8 (its two passes one batch), or K9 and K10 once a stage spot check
escalates to the exact gradient.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..convert import profile_from_numpy, require_device
from . import fiber

RESULT_DIR = "results/fiber_129_torch"
#: the script's refinement phases, ``(lr, iters, spp)`` at the last bin count
REFINE = ((2e-3, 600, 2), (5e-4, 600, 4), (1e-4, 800, 4))
#: the refinement runs' seeds are this plus the phase's index
REFINE_SEED = 100


def parse_refine(text: str):
    """``"2e-3:600:2,5e-4:600:4"`` as ``((2e-3, 600, 2), (5e-4, 600, 4))``."""
    return tuple((float(a), int(b), int(c))
                 for a, b, c in (s.split(":") for s in text.split(",")))


@dataclasses.dataclass(frozen=True)
class Settings:
    """What the JAX script reads from its environment (``FIBER_*``)."""

    result_dir: str = RESULT_DIR
    iters: int = 100
    spp: int = 2
    refine: Tuple[Tuple[float, int, int], ...] = REFINE
    init: Optional[str] = None

    @classmethod
    def from_env(cls, environ=os.environ) -> "Settings":
        return cls(result_dir=environ.get("FIBER_DIR", cls.result_dir),
                   iters=int(environ.get("FIBER_ITERS", "100")),
                   spp=int(environ.get("FIBER_SPP", "2")),
                   refine=parse_refine(environ["FIBER_REFINE"]) if environ.get("FIBER_REFINE")
                   else cls.refine,
                   init=environ.get("FIBER_INIT") or None)


def l1_to_gt(n: torch.Tensor) -> float:
    """Mean absolute distance of the profile ``n`` to ``sqrt(2 - r^2)`` at its bins."""
    gt = fiber.ground_truth(int(n.shape[0]), dtype=n.dtype, device=n.device)
    return float(torch.mean(torch.abs(n - gt)))


def load_profile(path: str, device="cuda", dtype=torch.float32) -> torch.Tensor:
    """A saved profile: a ``.npy`` array or a fiber ``result.npz`` of either package."""
    src = path if path.endswith(".npz") else np.load(path)
    return profile_from_numpy(src, device=device, dtype=dtype)


def ladder_params(settings: Settings) -> dict:
    return dict(fiber.default_params(), optim_iters=settings.iters, record_iters=10 ** 9,
                spp=settings.spp)


def refine_params(i: int, lr: float, iters: int, spp: int, n: torch.Tensor) -> dict:
    return dict(fiber.default_params(), res_list=[int(n.shape[0])], init_profile=n, lr=lr,
                optim_iters=iters, spp=spp, record_iters=10 ** 9, grad_spotcheck=False,
                seed=REFINE_SEED + i)


def run(settings: Settings, device="cuda", sample_rays=None,
        on_phase: Optional[Callable[[dict, dict], None]] = None):
    """The ladder (or the saved ``init``) and the refinement phases.

    ``sample_rays`` goes to every ``fiber.multires_exp`` run;
    ``on_phase(phase, params)`` sees each phase's record as it is written,
    with the parameters of its run (None for ``init``).  Returns ``(profile,
    report)``."""
    dev = require_device(device)
    out = settings.result_dir
    os.makedirs(out, exist_ok=True)
    report = {"phases": []}

    def flush_phase(phase, params):
        report["phases"].append(phase)
        with open(os.path.join(out, "report.json"), "w") as f:
            json.dump(report, f, indent=2)
        print(json.dumps(phase), flush=True)
        if on_phase is not None:
            on_phase(phase, params)

    hooks = dict(device=dev, sample_rays=sample_rays)
    if settings.init:
        n = load_profile(settings.init, dev)
        flush_phase(dict(phase="init", init=settings.init, l1_vs_gt=l1_to_gt(n)), None)
    else:
        params = ladder_params(settings)
        n, hist = fiber.multires_exp(params, result_dir=out, **hooks)
        flush_phase(dict(phase="ladder", optim_iters=settings.iters, spp=settings.spp,
                         l1_vs_gt=l1_to_gt(n), first_loss=float(hist[0]),
                         last_loss=float(hist[-1])), params)
    for i, (lr, iters, spp) in enumerate(settings.refine):
        params = refine_params(i, lr, iters, spp, n)
        n, hist = fiber.multires_exp(params, result_dir=os.path.join(out, f"refine{i}"),
                                     **hooks)
        np.save(os.path.join(out, f"profile_refine{i}.npy"), n.detach().cpu().numpy())
        flush_phase(dict(phase=f"refine{i}", lr=lr, iters=iters, spp=spp,
                         l1_vs_gt=l1_to_gt(n), last_loss=float(hist[-1])), params)
    report.update(bins=int(n.shape[0]), l1_vs_gt=report["phases"][-1]["l1_vs_gt"])
    np.save(os.path.join(out, "final_profile.npy"), n.detach().cpu().numpy())
    with open(os.path.join(out, "report.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report), flush=True)
    return n, report


if __name__ == "__main__":
    run(Settings.from_env())
