"""Step-size (ds) accuracy study: the quality side of the step-size knob.

Twin of ``adjointnonlinearraytracing_tpu/benchmarks/ds_study.py``: the same
scenes, entry rays, sensor-plane projection and rows.  For each scene and
each ``ds = alpha * h`` in the reference's envelope it measures, against a
``ds = h/8`` reference, the exit state projected onto a plane past the volume
(position error in voxels, mean and max), the exit direction's angle (mean
and max, radians), and the exact gradient of the projected loss
(``tracer.trace_exact``: K5 and K6 on the card) against the reference's:
relative L2 distance and cosine.

It runs in f64, on the card by default and on the CPU with
``--device cpu`` (the plain versions).  The ``rough_10pct`` scene draws its
noise from a ``torch.Generator`` (seeded 0 unless one is given) or takes the
array it is given (the JAX module draws it from ``PRNGKey(0)``).

Usage:  python -m adjointnonlinearraytracing_tpu_torch.benchmarks.ds_study \\
            [--res 33] [--nrays 512] [--device cuda] [--out results/ds_study_torch.jsonl]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..convert import require_device
from ..tracer import trace_exact

ALPHAS = (0.3, 0.5, 0.7, 1.0, 1.2)
# beside the JAX module's TPU record, results/ds_study.jsonl, not over it
DEFAULT_OUT = "results/ds_study_torch.jsonl"
SCENES = ("bench_bump", "luneburg", "fuel_weak", "rough_10pct")


def scenes(res, span, dtype=torch.float64, device="cuda", rough=None, names=SCENES):
    """The study's fields ``{name: (res, res, res)}`` on ``device``.  ``rough``:
    the ``rough_10pct`` scene's uniform draw ``(res, res, res)`` (numpy or a
    tensor), or the ``torch.Generator`` on ``device`` to draw it from (default:
    one seeded 0)."""
    dev = require_device(device)
    idx = torch.arange(res, dtype=dtype, device=dev) * (span / (res - 1))
    z, y, x = torch.meshgrid(idx, idx, idx, indexing="ij")
    c = span / 2
    r2 = (x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2
    out = {}
    if "bench_bump" in names:  # the bench scene: a smooth Gaussian bump, peak n = 1.2
        out["bench_bump"] = 1.0 + 0.2 * torch.exp(-r2 / (2 * (span / 4) ** 2))
    if "luneburg" in names:  # n = sqrt(2 - (r/R)^2) inside R = span/2: the strongest curvature
        rr = torch.sqrt(r2) / (span / 2)
        out["luneburg"] = torch.where(rr < 1.0, torch.sqrt(2.0 - rr ** 2), torch.ones_like(rr))
    if "fuel_weak" in names:  # the fuel-injection class: deviations of 3e-4
        out["fuel_weak"] = 1.0 + 3e-4 * torch.exp(-r2 / (2 * (span / 6) ** 2))
    if "rough_10pct" in names:  # the image / focal-stack late-stage regime
        if rough is None or isinstance(rough, torch.Generator):
            gen = torch.Generator(device=dev).manual_seed(0) if rough is None else rough
            rough = torch.rand((res, res, res), generator=gen, dtype=dtype, device=dev)
        out["rough_10pct"] = 1.0 + 0.1 * torch.as_tensor(rough, dtype=dtype, device=dev)
    return out


def entry_rays(nrays, span, dtype=torch.float64, seed=0, device="cuda"):
    """``(x0, v0)``: the JAX module's numpy draws, bit for bit, on ``device``."""
    dev = require_device(device)
    rng = np.random.default_rng(seed)
    xz = rng.uniform(0.2 * span, 0.8 * span, (nrays, 2))
    x0 = np.stack([xz[:, 0], -0.02 * np.ones(nrays) * span, xz[:, 1]], axis=-1)
    tilt = 0.08 * rng.standard_normal((nrays, 2))
    v0 = np.stack([tilt[:, 0], np.ones(nrays), tilt[:, 1]], axis=-1)
    v0 /= np.linalg.norm(v0, axis=-1, keepdims=True)
    return (torch.from_numpy(x0).to(device=dev, dtype=dtype),
            torch.from_numpy(v0).to(device=dev, dtype=dtype))


def project(xt, vt, y_plane):
    """The exit states carried in straight lines onto the plane ``y = y_plane``."""
    t = (y_plane - xt[:, 1]) / vt[:, 1]
    return xt + t[:, None] * vt


def _exact(rif, x0, v0, h, ds, y_plane):
    """Exit state, projected positions and the gradient of ``sum(xp^2)``."""
    r = rif.detach().requires_grad_(True)
    xt, vt = trace_exact(r, x0, v0, h, ds)
    xp = project(xt, vt, y_plane)
    (xp ** 2).sum().backward()
    return vt.detach(), xp.detach(), r.grad


def scene_rows(name, rif, x0, v0, span, alphas=ALPHAS):
    """The study's rows of one scene: one an ``alpha``, each against ``ds = h/8``."""
    res, nrays = rif.shape[0], x0.shape[0]
    h = span / (res - 1)
    y_plane = span * 1.05  # just past the far (+y) face: the experiments' geometry
    nmax = float(rif.max())
    vt_ref, xp_ref, g_ref = _exact(rif, x0, v0, h, h / 8, y_plane)
    gn_ref = torch.linalg.norm(g_ref)

    def unit(a):
        return a / torch.linalg.norm(a, dim=-1, keepdim=True)

    rows = []
    for alpha in alphas:
        ds = alpha * h
        vt, xp, g = _exact(rif, x0, v0, h, ds, y_plane)
        perr = torch.linalg.norm(xp - xp_ref, dim=-1) / h
        aerr = torch.arccos(torch.clamp((unit(vt) * unit(vt_ref)).sum(dim=-1), -1, 1))
        rows.append(dict(
            scene=name, res=res, nrays=nrays, nmax=round(nmax, 4), alpha=alpha,
            ds=round(float(ds), 6),
            plane_err_vox_mean=float(perr.mean()), plane_err_vox_max=float(perr.max()),
            dir_err_rad_mean=float(aerr.mean()), dir_err_rad_max=float(aerr.max()),
            grad_rel_l2=float(torch.linalg.norm(g - g_ref) / torch.clamp(gn_ref, min=1e-30)),
            grad_cos=float((g * g_ref).sum()
                           / torch.clamp(torch.linalg.norm(g) * gn_ref, min=1e-30)),
            paired_ok=bool(ds * nmax <= h * (1 + 1e-12))))
    return rows


def study(res=33, nrays=512, span=20.0, device="cuda", alphas=ALPHAS, names=SCENES,
          rough=None):
    """Every scene's rows, printed one JSON line each; returns them."""
    dev = require_device(device)
    x0, v0 = entry_rays(nrays, span, device=dev)
    rows = []
    for name, rif in scenes(res, span, device=dev, rough=rough, names=names).items():
        for row in scene_rows(name, rif, x0, v0, span, alphas):
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=33)
    ap.add_argument("--nrays", type=int, default=512)
    ap.add_argument("--span", type=float, default=20.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    rows = study(args.res, args.nrays, args.span, args.device)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")


if __name__ == "__main__":
    main()
