"""Exit-step compaction on a scene whose chords spread.

Twin of ``adjointnonlinearraytracing_tpu/benchmarks/compaction_bench.py``.
The bench scene's chords are uniform, where buckets cannot win; this scene
is the one they are for: rays entering one face at positions and pitches
that run from grazing (a few steps in the volume) to the full diagonal.  It
prints the chord percentiles and spread, then times forward + gradient
through ``tracer.compaction.trace_bucketed`` with 1 (``api.trace`` whole),
2, 4 and 8 buckets on the card (1 and 4 on the CPU): a bucket is one K2 and
one K3 launch on the card.  This measures what buckets do on an H100; it sets
no rule (``experiments.common.make_trace`` takes them on the card only from
``ANRT_BUCKETED``).

Run:  python -m adjointnonlinearraytracing_tpu_torch.benchmarks.compaction_bench
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..convert import require_device
from ..tracer import compaction
from ..utils import profiling
from .scenes import build_case


def spread_arrays(nrays=1 << 18, span=20.0, seed=0):
    """The scene's rays as float32 numpy arrays ``(x, v)``, drawn as the JAX
    module draws them."""
    rng = np.random.default_rng(seed)
    x = np.stack([
        rng.uniform(0, span, nrays),
        np.full(nrays, -1e-3),
        rng.uniform(0, span, nrays),
    ], axis=1).astype(np.float32)
    # mostly +y, with a pitch that takes the chord from a sliver to the diagonal
    pitch = rng.uniform(0.05, 1.0, nrays)            # sin of the elevation
    yaw = rng.uniform(0, 2 * np.pi, nrays)
    horiz = np.sqrt(1.0 - pitch ** 2)
    v = np.stack([horiz * np.cos(yaw), pitch, horiz * np.sin(yaw)], axis=1).astype(np.float32)
    return x, v


def spread_case(res=128, nrays=1 << 18, span=20.0, seed=0, device="cuda"):
    """``(rif, x, v, span)``: the bench field at ``res^3`` and the spread rays,
    float32 tensors on ``device``."""
    dev = require_device(device)
    x, v = spread_arrays(nrays, span, seed)
    rif, _, _, _ = build_case(res=res, nrays=8, span=span, dtype="float32", device=dev)
    return rif, torch.from_numpy(x).to(dev), torch.from_numpy(v).to(dev), span


def chord_stats(rif, x, v, h, ds):
    """The chord-step percentiles 10 and 90 and the spread statistic, in the
    rays' type."""
    steps = compaction.chord_steps(rif.shape, h, x, v, ds)
    q = torch.quantile(steps, torch.tensor([0.1, 0.9], dtype=steps.dtype, device=steps.device))
    return dict(chord_steps_p10=float(q[0]), chord_steps_p90=float(q[1]),
                chord_spread=round(compaction.chord_spread(rif.shape, h, x, v, ds), 2))


def run(res=None, nrays=None, buckets=None, iters=2, device="cuda"):
    """The chord line and one row a bucket count (and the best speed-up);
    returns ``(stats, rows)``."""
    dev = require_device(device)
    on_card = dev.type == "cuda"
    res = res or (128 if on_card else 33)
    nrays = nrays or (1 << 18 if on_card else 1 << 12)
    buckets = buckets or ((1, 2, 4, 8) if on_card else (1, 4))
    rif, x, v, span = spread_case(res=res, nrays=nrays, device=dev)
    h = span / (res - 1)
    ds = h / 2
    stats = dict(scene="spread", res=res, nrays=nrays, **chord_stats(rif, x, v, h, ds))
    print(json.dumps(stats), flush=True)

    rows = []
    for k in buckets:
        def fwd_bwd():
            r = rif.detach().requires_grad_(True)
            xt, vt = compaction.trace_bucketed(r, x, v, h, ds, nbuckets=k)
            ((xt ** 2).sum() + vt.sum()).backward()
            return r.grad

        dt = profiling.timeit(fwd_bwd, iters=iters, warmup=1, device=dev)
        row = dict(nbuckets=k, time_s=round(dt, 5), rays_per_s=round(nrays / dt, 1))
        rows.append(row)
        print(json.dumps(row), flush=True)
    if len(rows) > 1:
        base = rows[0]["time_s"]
        best = min(rows[1:], key=lambda r: r["time_s"])
        print(json.dumps(dict(speedup_best=round(base / best["time_s"], 3),
                              at_buckets=best["nbuckets"])), flush=True)
    return stats, rows


def main():
    run()


if __name__ == "__main__":
    main()
