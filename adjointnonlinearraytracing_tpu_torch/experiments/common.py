"""Shared plumbing of the experiments.

Twin of ``adjointnonlinearraytracing_tpu/experiments/common.py``.  An experiment
has a params dict, a loss over its rays, and the multires Adam loop.

* randomness flows through an explicit ``torch.Generator`` (``params['seed']``),
* rejected/cropped rays are masked, not dropped,
* ``autodiff`` switches between the constant-memory adjoint
  (``tracer.trace``) and plain autograd through the stepper
  (``tracer.trace_ad``), the cross-validation toggle; mode ``"exact"`` is the
  checkpointed-exact gradient (``tracer.trace_exact``), which the stage
  escalation switches to where the adjoint drifts,
* ``use_mesh=True`` traces sharded over the processes of the ray mesh
  (``parallel/mesh.py``; one rank where no process group exists), the rays
  padded to the shard count,
* exit-step compaction (``tracer/compaction.py``): ``ANRT_BUCKETED`` buckets;
  off the card also where a probe of the run's rays spreads, as the JAX
  package chooses it.
"""

from __future__ import annotations

import os
import warnings

import torch

from ..convert import require_device
from ..parallel import distributed
from ..parallel import mesh as pmesh
from ..tracer import api
from ..tracer import checkpointed
from ..tracer import compaction
from ..tracer import eikonal


_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def param_dtype(params, default=torch.float32) -> torch.dtype:
    """``params['dtype']`` (a torch dtype or its name) as a torch dtype."""
    dtype = params.get("dtype", default)
    return _DTYPES.get(dtype, dtype)


def _per_ray(mask, diff):
    m = mask.to(diff.dtype)
    return m[:, None] if diff.ndim == 2 else m


def masked_mean_sq(diff, mask):
    """sum(mask * diff^2) / count(mask): the masked analog of dropping rows."""
    return (_per_ray(mask, diff) * diff ** 2).sum() / torch.clamp(mask.sum(), min=1)


def masked_sum_sq(diff, mask):
    return (_per_ray(mask, diff) * diff ** 2).sum()


def exit_buckets(vol_span, ds, probe_rays=None) -> int:
    """The exit-step buckets a run's adjoint trace takes: ``ANRT_BUCKETED``
    where it is set; else, where the probe ``(x, v)`` of the run's rays lies
    off the card, the JAX package's rule (``compaction.auto_buckets``: 4 where
    the chord spread is at least 3); else none (the card's rule, ``PERF.md``)."""
    env_buckets = os.environ.get("ANRT_BUCKETED")
    if env_buckets is not None:
        return int(env_buckets)
    if probe_rays is not None and probe_rays[0].device.type != "cuda":
        return compaction.auto_buckets(vol_span, probe_rays[0], probe_rays[1], ds)
    return 0


def make_trace(vol_span, ds, autodiff=False, use_mesh=False, res=None,
               gradient=None, seg=32, probe_rays=None, device=None):
    """Volume trace closure: ``h`` is derived from the *current* grid
    resolution while ``ds`` stays fixed from the finest one.

    ``gradient`` selects the differentiation strategy:
      - "adjoint" (default): O(1)-memory reverse re-integration
        (``tracer.trace``: the kernels on CUDA tensors)
      - "ad": plain autograd through the stepper (``tracer.trace_ad``)
      - "exact": the checkpointed-segment adjoint (``tracer.trace_exact``
        with ``seg``: the kernels K5, K6 on CUDA tensors): the exact
        discrete gradient at any precision, ``O(N*(steps/seg + seg))`` memory
      - a mutable dict ``{"mode": <one of the above>}``, read at trace time:
        the hook of the stage-level escalation
    ``autodiff=True`` is the alias for "ad".

    ``use_mesh=True`` runs the adjoint and the exact modes sharded over the
    ray mesh (``parallel.mesh.make_sharded_trace`` /
    ``make_sharded_trace_exact``, made once per resolution): a batch that
    the world size does not divide is padded with copies of ray 0 (the same
    dynamics, and the cotangents of the copies are zero), and the outputs are
    cut back.  ``ANRT_BUCKETED`` sets the exit-step buckets.  Unset, a
    ``probe_rays`` (a sample ``(x, v)`` of the run's source) off the card
    picks them by the JAX package's rule: 4 where its chord spread is at
    least 3 (``compaction.auto_buckets``), else none.  On the card the rule
    is not applied and the run takes none: the kernels leave the step loop
    per ray, and forced buckets slow the Luneburg adjoint steps on the H100
    (``PERF.md``, ``ROADMAP.md`` B18); no measured source gains from them.
    Buckets apply to the adjoint mode only: ``compaction.trace_bucketed``
    unsharded, per shard under the mesh.

    The closure traces where its tensors live.  With ``device`` given, it is
    checked at once (a CUDA device that is not there raises here) and the
    closure refuses tensors that live elsewhere instead of moving them.  It
    carries its choices as ``trace.nbuckets`` and ``trace.mesh`` (None
    without ``use_mesh``).  ``res`` is accepted for the JAX signature.
    """
    if gradient is None:
        gradient = "ad" if autodiff else "adjoint"
    dev = None if device is None else require_device(device)
    the_mesh = pmesh.make_ray_mesh() if use_mesh else None
    cache = {}
    default_buckets = exit_buckets(vol_span, ds, probe_rays)

    def _pad_call(fn, nt, x, v):
        # pad the ray axis to the shard count with copies of ray 0: the same
        # dynamics, and the cut-off rows get zero cotangents
        n = x.shape[0]
        pad = (-n) % the_mesh.world_size
        if pad:
            xt, vt = fn(nt, torch.cat([x, x[:1].expand(pad, -1)]),
                        torch.cat([v, v[:1].expand(pad, -1)]))
            return xt[:n], vt[:n]
        return fn(nt, x, v)

    def trace(nt, x, v):
        if dev is not None:
            for name, t in (("the field", nt), ("x", x), ("v", v)):
                if t.device.type != dev.type:
                    raise RuntimeError(
                        f"make_trace: {name} is on {t.device}, this trace was made for {dev}")
        h = vol_span / max(nt.shape[0] - 1, 1)
        mode = gradient["mode"] if isinstance(gradient, dict) else gradient
        if mode is None:
            mode = "adjoint"
        if mode == "ad":
            return api.trace_ad(nt, x, v, h, ds)
        if mode == "exact":
            if the_mesh is not None:
                key = ("exact", nt.shape[0], float(h))
                if key not in cache:
                    cache[key] = pmesh.make_sharded_trace_exact(the_mesh, h, ds, max(nt.shape),
                                                                seg=seg)
                return _pad_call(cache[key], nt, x, v)
            return checkpointed.trace_exact(nt, x, v, h, ds, seg)
        if mode != "adjoint":
            raise ValueError(f"make_trace: unknown gradient mode {mode!r}")
        if the_mesh is not None:
            key = (nt.shape[0], float(h), default_buckets)
            if key not in cache:
                cache[key] = pmesh.make_sharded_trace(the_mesh, h, ds, max(nt.shape),
                                                      nbuckets=default_buckets)
            return _pad_call(cache[key], nt, x, v)
        if default_buckets > 1:
            return compaction.trace_bucketed(nt, x, v, h, ds, default_buckets)
        return api.trace(nt, x, v, h, ds)

    trace.nbuckets = default_buckets
    trace.mesh = the_mesh
    return trace


def gradient_spotcheck(eta, x, v, vol_span, ds, mask=None, n_rays=2048,
                       metrics=None, name="grad_spotcheck", perturb=True,
                       perturb_amp=0.05):
    """One-shot adjoint-vs-exact gradient comparison on this run's scene.

    The constant-memory adjoint re-integrates trajectories in reverse; at
    float32 its gradient drifts on rough fields (``tracer/api.py`` precision
    note).  Every experiment run calls this once at startup on a subsample of
    its real rays so drift on a *given* scene is measured, not assumed.  The
    yardstick is the checkpointed-exact gradient
    (``tracer.checkpointed.trace_exact``: K5 and K6 on the card), as in the
    JAX package.  Returns the max relative deviation, the relative L2
    deviation and the cosine, and logs them.

    ``perturb`` adds a smooth gaussian bump of amplitude ``perturb_amp``
    (default 5%) so the check exercises curvature even when the initial field
    is flat.  Pass an amplitude representative of the run's actual field
    deviation: drift grows with ray curvature, so a 5% bump wildly
    overestimates drift for weak-signal scenes like fuel injection.
    """
    x = x[:n_rays]
    v = v[:n_rays]
    m = None if mask is None else mask[:n_rays]
    eta = eta.detach()
    if perturb and eta.shape[0] >= 2:
        ax = torch.linspace(-1.0, 1.0, eta.shape[0], dtype=eta.dtype, device=eta.device)
        zz, yy, xx = torch.meshgrid(ax, ax, ax, indexing="ij")
        eta = eta + perturb_amp * torch.exp(-(xx ** 2 + yy ** 2 + zz ** 2) / 0.18)
    h = vol_span / max(eta.shape[0] - 1, 1)

    def probe_grad(trace_fn):
        nt = eta.clone().requires_grad_(True)
        xt, vt = trace_fn(nt, x, v, h, ds)
        per = (xt ** 2 + xt * vt).sum(dim=-1)
        if m is not None:
            per = torch.where(m, per, torch.zeros_like(per))
        (g,) = torch.autograd.grad(per.sum(), nt)
        return g.reshape(-1)

    g_adj = probe_grad(api.trace)
    g_ex = probe_grad(checkpointed.trace_exact)
    tiny = 1e-30
    diff = g_adj - g_ex
    rel = float(diff.abs().max() / torch.clamp(g_ex.abs().max(), min=tiny))
    l2 = float(torch.linalg.norm(diff) / torch.clamp(torch.linalg.norm(g_ex), min=tiny))
    cos = float(torch.dot(g_adj, g_ex) / torch.clamp(
        torch.linalg.norm(g_adj) * torch.linalg.norm(g_ex), min=tiny))
    if metrics is not None:
        metrics.log(0, **{name: rel, name + "_rel_l2": l2, name + "_cos": cos})
    if rel > 1e-2:
        warnings.warn(
            f"adjoint gradient deviates {rel:.2e} (rel, max-norm; rel-L2 "
            f"{l2:.2e}, cosine {cos:.4f}) from the checkpointed-exact "
            "gradient on this scene; consider gradient='exact' or float64 "
            "(tracer/api.py precision note)")
    return dict(max_rel=rel, rel_l2=l2, cos=cos)


def exact_mem_bytes(n_rays, res, vol_span, ds, seg=32):
    """Checkpoint + replay footprint of ``trace_exact`` for one batch, as the
    JAX package bounds it: ``nseg * N * 7`` checkpoint values plus ``seg * N * 10``
    of replay, 4 bytes each, with ``N`` capped at ``ANRT_EXACT_CHUNK`` (larger
    batches run the backward pass chunk by chunk).  On the card the replay
    lives in each thread's local memory, so the checkpoints are what is
    allocated."""
    chunk = checkpointed.exact_chunk_rays()
    if chunk:
        n_rays = min(n_rays, chunk)
    h = vol_span / max(res - 1, 1)
    steps = eikonal.max_steps_fwd(res, h, ds)
    nseg = -(-steps // seg)
    return 4 * n_rays * (nseg * 7 + seg * 10)


def make_stage_escalator(holder, vol_span, ds, probe_rays, metrics=None,
                         tol=None, n_rays=2048, rays_per_iter=None):
    """Stage-level gradient auto-escalation.

    Returns a ``stage_fn`` for ``opt.multires_opt``: at the start of each
    resolution stage it re-runs the adjoint-vs-exact spot check on the
    *current* field (drift grows with resolution and field roughness: the
    startup check on the coarse init can pass while a fine stage drifts) and
    flips ``holder['mode']`` to ``"exact"`` when the rel-L2 deviation exceeds
    ``tol`` (``ANRT_EXACT_TOL``, default 0.01); the closure's next trace
    then runs ``tracer.trace_exact``.

    ``probe_rays`` is a callable ``() -> (x, v, mask)`` sampling this run's
    real source distribution.  ``rays_per_iter`` is accepted for the JAX
    signature.  Under a process group every rank takes rank 0's drift, so
    the ranks of a ray mesh escalate together (each computes its own from
    atomic sums that round differently).
    """
    if tol is None:
        tol = float(os.environ.get("ANRT_EXACT_TOL", "0.01"))

    def stage_fn(stage, n):
        if holder.get("mode") not in (None, "adjoint"):
            return  # already escalated / explicitly chosen
        if stage == 0:
            return  # startup spot check covers the first stage
        x, v, mask = probe_rays()
        stats = gradient_spotcheck(
            n, x, v, vol_span, ds, mask=mask, n_rays=n_rays, metrics=metrics,
            name=f"grad_spotcheck_stage{stage}", perturb=False)
        drift = distributed.rank0_value(stats["rel_l2"], n.device)
        if drift > tol:
            holder["mode"] = "exact"
            warnings.warn(
                f"stage {stage} (res {n.shape[0]}): adjoint gradient rel-L2 "
                f"drift {drift:.2e} > {tol:g}; escalating to the "
                "exact gradient for the remaining stages")
            if metrics is not None:
                metrics.log(0, gradient_escalated_stage=stage, gradient_mode="exact")

    return stage_fn


def per_view_planes(planes, rpv):
    """First-plane-per-view sensor list.

    ``rpv`` entries are equal counts; returns lists of ``(1, 3)`` tensors.
    """
    sensor_p, sensor_n, sensor_t = [], [], []
    offset = 0
    for count in rpv:
        sensor_p.append(planes[None, offset, 0, :])
        sensor_n.append(planes[None, offset, 1, :])
        sensor_t.append(planes[None, offset, 2, :])
        offset += count
    return sensor_p, sensor_n, sensor_t


def split_views(arr, rpv):
    """Split of a concatenated per-view tensor."""
    return list(torch.split(arr, list(rpv)))
