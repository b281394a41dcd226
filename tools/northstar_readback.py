"""What the north star's one read-back an iteration saves, on one card.

Run from the repo root on a machine with a CUDA device and ``nvcc``::

    python tools/northstar_readback.py [--iters N]

``experiments/northstar.py`` reads an iteration's losses back once, after
its Adam step; the JAX script ``run_fuel_northstar.py`` reads each
microbatch's loss as it comes (``loss += float(l)``), which makes the host
wait for the card every microbatch.  On the shipped measurement set
(10,485,760 f32 rays, drawn on the card) at the last stage's grid (129^3,
16 microbatches of 655,360 rays, the ground truth traced once at that
stage's ``ds``), from a field near the truth, this times ``N`` iterations
of the driver's microbatch loop each way, alternated (the first of each
way a warm-up), on the host clock with the card synchronised around each:
the same launches and the same sums.  The Adam step is left out of both.
Prints the card and one JSON line with the median ms an iteration of each
way.  No path of the port runs it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from statistics import median

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from adjointnonlinearraytracing_tpu_torch.experiments import northstar, voxel_scenes  # noqa: E402
from adjointnonlinearraytracing_tpu_torch.fields import grid as G  # noqa: E402
from adjointnonlinearraytracing_tpu_torch.utils import profiling  # noqa: E402


def readback_ab(iters: int):
    settings = northstar.Settings()
    res, _, cpi = settings.ladder[-1]
    h, ds = northstar.VOL_SPAN / (res - 1), settings.stage_ds(res)
    data = northstar.Measurements(northstar.measurement_set(device="cuda"), "cuda",
                                  torch.float32)
    gt = G.upres_volume(voxel_scenes.fuel_injection_rif(northstar.FUEL_VAL, torch.float32,
                                                        "cuda"), (res,) * 3)
    data.trace_ground_truth(gt, ds, 0)
    loss_fn = northstar.make_chunk_loss(data, 0)
    eta = gt + 1e-5  # a field near the truth, as the last stage's are
    ms = {"once": [], "every": []}
    for i in range(2 * iters + 2):
        way = "once" if i % 2 == 0 else "every"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g, losses, total = torch.zeros_like(eta), [], 0.0
        for k in range(cpi):
            lc, gc = northstar.value_and_grad(loss_fn, eta, (i * cpi + k) % northstar.NCHUNKS,
                                              h, ds)
            g = g + gc
            if way == "every":
                total += float(lc)
            else:
                losses.append(lc)
        for lc in torch.stack(losses).tolist() if losses else ():
            total += lc
        torch.cuda.synchronize()
        if i >= 2:
            ms[way].append(1e3 * (time.perf_counter() - t0))
    return dict(res=res, microbatches=cpi, rays=cpi * data.chunk, iters=iters,
                ms_once=median(ms["once"]), ms_every=median(ms["every"]),
                ms_once_all=ms["once"], ms_every_all=ms["every"])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("northstar_readback: no CUDA device")
    card = profiling.card_line()
    print(f"device: {card}", flush=True)
    rec = readback_ab(args.iters)
    print(f"northstar read-back at {rec['res']}^3, {rec['microbatches']} x "
          f"{rec['rays'] // rec['microbatches']} rays: once an iteration {rec['ms_once']:.3f} ms, "
          f"once a microbatch {rec['ms_every']:.3f} ms ({args.iters} of each, alternated); "
          f"{card}", flush=True)
    print(json.dumps(dict(rec, card=card)))


if __name__ == "__main__":
    main()
