"""Exit-step compaction: bucketed tracing for sources whose path lengths spread.

Twin of ``adjointnonlinearraytracing_tpu/tracer/compaction.py``.  The JAX
steppers' while_loops leave only when every ray of the batch has escaped, so
one long ray kept every lane marching; sorting the rays by a straight-chord
step estimate and tracing K equal buckets apart let each bucket stop at
roughly its own longest ray.  On the card the kernels already leave the step
loop per ray (K2, K3), so a bucket saves only the lanes of a warp that wait
on a longer neighbour, and costs K launches in place of one; ``make_trace``
takes it where the JAX rule does (:func:`auto_buckets` on a probe of the
run's rays, ``ANRT_BUCKETED`` overriding), and ``PERF.md`` records what it
does on the card.

Bucketing only permutes rays, so the outputs are :func:`tracer.api.trace`'s
bit for bit; the gradient is the same sum in another order.  A bucket is one
K2 launch and, backward, one K3 launch on ``N / K`` rays (on the CPU, the
plain steppers); the sort, the gathers and the scatter back are plain tensor
code.
"""

from __future__ import annotations

import torch

from . import api


def chord_steps(shape, h, x, v, ds):
    """Straight-line step count through the volume's box per ray.

    The slab method on ``[0, (res-1)*h]`` per axis with the *unnormalised*
    velocity (``|v| = n ~ 1`` at entry, the integrator's arc parameter);
    rays that miss the box get 0.  ``shape`` is the grid's ``(D, H, W)``.
    """
    extent = torch.tensor([(s - 1) * h for s in (shape[2], shape[1], shape[0])],
                          dtype=x.dtype, device=x.device)
    # a large finite sentinel, not inf: a ray starting exactly on a slab plane
    # with no speed along that axis would make 0 * inf = NaN
    zero = v.abs() <= 1e-12
    inv = torch.where(zero, torch.full_like(v, 1e30),
                      1.0 / torch.where(zero, torch.ones_like(v), v))
    t0 = (0.0 - x) * inv
    t1 = (extent - x) * inv
    tmin = torch.minimum(t0, t1).amax(dim=-1)
    tmax = torch.maximum(t0, t1).amin(dim=-1)
    tin = torch.clamp(tmin, min=0.0)
    chord = torch.clamp(tmax - tin, min=0.0)
    return torch.where(tmax > tin, chord / ds, torch.zeros_like(chord))


def chord_spread(shape, h, x, v, ds) -> float:
    """``p90 / max(p10, 1)`` of the chord-step estimate, the gating statistic:
    about 1 on uniform scenes, 2 and more on spread sources."""
    steps = chord_steps(shape, h, x, v, ds)
    q = torch.quantile(steps, torch.tensor([0.1, 0.9], dtype=steps.dtype, device=steps.device))
    return float(q[1] / torch.clamp(q[0], min=1.0))


def auto_buckets(vol_span, x, v, ds, threshold=3.0, k=4) -> int:
    """The bucket count for a sample of a source: ``k`` where its chord spread
    is at least ``threshold``, else 0 (the JAX package's rule).  The spread is
    a ratio, so a cube of side ``vol_span`` gives the same answer at every
    resolution."""
    spread = chord_spread((2, 2, 2), vol_span, x, v, ds)
    return k if spread >= threshold else 0


def chord_order(shape, h, x, v, ds) -> torch.Tensor:
    """The rays in order of their chord steps (a stable sort)."""
    return torch.argsort(chord_steps(shape, h, x, v, ds), stable=True)


def trace_bucketed(rif, x, v, h, ds, nbuckets: int = 4):
    """:func:`tracer.api.trace` with exit-step compaction; the same outputs and
    gradient.

    ``nbuckets`` equal buckets in chord order, each traced by ``api.trace``
    (one K2 launch forward and one K3 backward on the card), the outputs put
    back in the caller's order.  A batch that ``nbuckets`` does not divide,
    and ``nbuckets <= 1``, take ``api.trace`` whole.
    """
    n = x.shape[0]
    if nbuckets <= 1 or n % nbuckets:
        return api.trace(rif, x, v, h, ds)
    order = chord_order(rif.shape, h, x.detach(), v.detach(), ds)
    xs, vs = x[order], v[order]
    outs = [api.trace(rif, xb, vb, h, ds)
            for xb, vb in zip(xs.chunk(nbuckets), vs.chunk(nbuckets))]
    inv = torch.argsort(order)
    return tuple(torch.cat([o[k] for o in outs])[inv] for k in range(2))
