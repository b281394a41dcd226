"""Run a shipped params YAML end to end.

Twin of ``adjointnonlinearraytracing_tpu/experiments/runner.py``: it loads a
section with ``config.load_params``, turns file-path params into tensors
(images, distance textures, with the JAX runner's synthetic stand-ins for the
files the repo does not ship) and dispatches to the experiment, on the GPU
unless ``--device cpu`` is given.  All six families run: fuel, luneburg,
image, sdf, focalstack and fiber.

Usage::

    python -m adjointnonlinearraytracing_tpu_torch.experiments.runner \\
        configs/params-luneburg.yaml --result-dir results/luneburg_torch

The family is inferred from the filename (``params-<family>*.yaml``) or an
explicit ``family:`` key in the YAML.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..convert import require_device
from . import common
from . import config as cfg
from . import voxel_scenes

FAMILIES = ("luneburg", "sdf", "fiber", "focalstack", "image", "fuel")


def infer_family(path: str, params: Dict) -> str:
    if "family" in params:
        return params["family"]
    base = os.path.basename(path)
    for fam in FAMILIES:
        if fam in base:
            return fam
    if "legoknight" in base or "fs" in base.replace("params-", ""):
        return "focalstack"
    raise ValueError(f"cannot infer experiment family from {path}; "
                     "add a 'family:' key to the YAML")


def l2ball_sdf(res: int, span: float, radius_frac: float = 0.25, dtype=torch.float32,
               device="cuda"):
    """Signed-distance texture of a centred disk, zero at ``radius_frac * span``:
    the stand-in for ``data/sdf/l2ball.npy``, which the repo does not ship."""
    c = torch.linspace(-span / 2, span / 2, res, dtype=dtype, device=require_device(device))
    u, w = torch.meshgrid(c, c, indexing="ij")
    return torch.sqrt(u ** 2 + w ** 2) - radius_frac * span


def _load_tex(path: Optional[str], res: int, span: float, device="cuda"):
    """A ``.npy`` distance texture; the l2ball stand-in when it is absent."""
    if path and os.path.exists(path):
        return torch.from_numpy(np.load(path)).to(device=require_device(device),
                                                  dtype=torch.float32)
    return l2ball_sdf(res, span, device=device)


def _load_image_list(paths, resolution, device="cuda"):
    """Sum-normalised target images; ``None`` where a file is absent both at
    its path and, by its base name, in ``data/``."""
    from ..sources import sources as S
    from .image import load_image

    out = []
    for p in paths or []:
        for cand in (p, p and voxel_scenes.data_path(os.path.basename(p))):
            if cand and os.path.exists(cand):
                out.append(S.sum_norm(load_image(cand, resolution, device=device)))
                break
        else:
            out.append(None)
    return out


def run(path: str, section: Optional[str] = None, result_dir: Optional[str] = None,
        overrides: Optional[Dict] = None, device="cuda", stat_fn=None, metrics=None):
    """Load + dispatch.  Returns the experiment's result tuple.

    ``stat_fn`` and ``metrics`` are handed to the experiment (see its
    ``run_opt`` or ``multires_exp``)."""
    params = cfg.load_params(path, section)
    params.update(overrides or {})
    family = infer_family(path, params)
    if family not in FAMILIES:
        raise ValueError(f"unknown experiment family {family!r}")
    if result_dir:
        os.makedirs(result_dir, exist_ok=True)
    hooks = dict(device=device, stat_fn=stat_fn, metrics=metrics)

    if family == "fiber":
        from . import fiber
        return fiber.multires_exp(params, result_dir, **hooks)

    if family == "fuel":
        from . import fuel_injection
        return fuel_injection.run_opt(params, result_dir, **hooks)

    if family == "luneburg":
        from . import luneburg
        return luneburg.run_opt(params, result_dir, **hooks)

    if family in ("image", "sdf"):
        from . import image
        nbins = params.get("nbins", 128)
        if params.get("sdf_loss", False):
            # per-view distance-texture paths, with the l2ball stand-in
            nviews = params.get("nviews", 1)
            span = params.get("vol_span", 20)
            fspan = params.get("far_sensor_span", 90)
            disp = [_load_tex(p, nbins, span, device)
                    for p in (params.get("disp_sdf_path") or [None])]
            defl = [_load_tex(p, nbins, 2 * float(np.sin(0.5 * np.deg2rad(fspan))), device)
                    for p in (params.get("defl_sdf_path") or [None])]
            params.setdefault("sdf_disp", disp * nviews)
            params.setdefault("sdf_defl", defl * nviews)
            params.setdefault("disp_ims", [None] * nviews)
            params.setdefault("defl_ims", [None] * nviews)
        else:
            params.setdefault("disp_ims", _load_image_list(
                params.get("images") or params.get("image_path"), nbins, device))
        return image.multires_exp(params, result_dir, **hooks)

    from . import focalstack
    nbins = params.get("nbins", 256)
    stack = _load_image_list(params.get("focal_list"), nbins, device)
    params.setdefault("src_angle", params.get("source_angle", 1.0))
    source_image = params.get("source_image")
    if any(im is None for im in stack):
        # the lego-knight captures are not in the repo: render a stack from
        # a synthetic scene at the finest resolution instead
        span = params.get("vol_span", 10)
        scene = voxel_scenes.gaussian_bump(params.get("res_list", [33])[-1], span,
                                           dtype=common.param_dtype(params), device=device)
        gen = dict(params)
        # emission weights must not be negative: a disk indicator, not the raw SDF
        gen["source_image"] = torch.clamp(-l2ball_sdf(nbins, span, device=device), min=0.0)
        stack = focalstack.make_synthetic_stack(scene, gen, device=device)
        # the lkfs* sections carry ``source_image: true`` (use the in-focus
        # capture); with no capture, the synthetic emission takes its place
        if source_image is None or source_image is True:
            params["source_image"] = gen["source_image"]
    elif source_image is True or "source_image" not in params:
        # 'srciminfocus' sections: the emission is the in-focus capture
        params["source_image"] = stack[0]
    params["focal_stack"] = stack
    return focalstack.multires_exp(params, result_dir, **hooks)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("yaml")
    ap.add_argument("section", nargs="?", default=None)
    ap.add_argument("--result-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a GPU) or 'cpu'")
    ap.add_argument("--set", action="append", default=[],
                    help="override: key=value (YAML-parsed)")
    args = ap.parse_args(argv)
    import yaml
    overrides = {}
    for kv in args.set:
        k, _, v = kv.partition("=")
        overrides[k] = yaml.safe_load(v)
    return run(args.yaml, args.section, args.result_dir, overrides, device=args.device)


if __name__ == "__main__":
    main()
