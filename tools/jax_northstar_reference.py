"""The JAX north-star script itself on the CPU, against the port's twin.

Run from the repo root on any machine (CPU only; a few minutes)::

    JAX_PLATFORMS=cpu python tools/jax_northstar_reference.py [--case ladder|resume] [--out FILE]

It runs ``run_fuel_northstar.py`` as it is, in this process (``runpy``), at a
sixteenth of the views and pixels (``NS_CPU=1 NS_SCALE=16``: f32, 2 views x
8^2 x 20 spp = 2,560 rays in 16 microbatches) into a temporary ``NS_DIR``,
reads its ``metrics.jsonl`` and, from the script's globals, its measurement
rays, its ground-truth exits and its bucket count; then the port's
``experiments/northstar.py`` runs in f32 on the CPU on the same rays and
settings.  It prints one JSON line with every iteration's loss and every
stage's ``rel_norm`` on both sides.  The cases:

* ``ladder`` (``NS_STAGES=5:2:2,9:2:4``): also the first iteration's loss on
  both sides and their relative distance (limit 1e-5), and the ground truth's
  plane-projected exits' largest distance (limit 1e-6), beside the distance
  between the JAX package's own two f32 steppers on the same rays (the
  script's paired window stepper against ``tracer/eikonal.py``'s plain one,
  which the port's plain version restates); exits 1 where a limit is
  crossed;
* ``resume``: the resume of ``chip_smoke.py``'s case n2 at this size
  (``NS_INIT=results/fuel_northstar/eta_65.npy NS_STAGES=129:20:16
  NS_LR=6.25e-6``, ``NS_ERR_EVERY=5``): the script restarts Adam from its
  first step, as the port does.

The tests (``tests/test_torch_northstar.py``) hold the port against a
restatement of the script in f64; this holds it against the script, so the
restatement is the script.  This is the only code beside the tests and
``tools/jax_fuel2008_reference.py`` that imports the JAX package; nothing of
the port imports it.
"""

from __future__ import annotations

import argparse
import json
import os
import runpy
import sys
import tempfile
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CASES = {
    "ladder": dict(NS_CPU="1", NS_SCALE="16", NS_STAGES="5:2:2,9:2:4"),
    "resume": dict(NS_CPU="1", NS_SCALE="16", NS_STAGES="129:20:16", NS_LR="6.25e-6",
                   NS_ERR_EVERY="5", NS_INIT=os.path.join("results", "fuel_northstar",
                                                          "eta_65.npy")),
}
LOSS_TOL, EXIT_TOL = 1e-5, 1e-6


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--case", default="ladder", choices=sorted(CASES))
    ap.add_argument("--out", default=None, help="also write the JSON line to this file")
    args = ap.parse_args()

    import numpy as np
    import torch

    from adjointnonlinearraytracing_tpu_torch.experiments import northstar as NS
    from adjointnonlinearraytracing_tpu_torch.experiments import voxel_scenes as TV
    from adjointnonlinearraytracing_tpu_torch.fields.grid import upres_volume
    from adjointnonlinearraytracing_tpu_torch.sources import sources as TS

    case = CASES[args.case]
    warnings.simplefilter("ignore", UserWarning)  # the spot checks' drift warnings
    os.chdir(ROOT)
    with tempfile.TemporaryDirectory() as out:
        os.environ.update(case, NS_DIR=out)
        script = runpy.run_path(os.path.join(ROOT, "run_fuel_northstar.py"))
        with open(os.path.join(out, "metrics.jsonl")) as f:
            jax_rows = [json.loads(line) for line in f]

    x, v = script["x_all"], script["v_all"]
    planes = np.stack([script["sp_all"], script["sn_all"], np.zeros_like(x)], axis=1)
    rays = TS.Rays(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (x, v, planes)),
                   torch.from_numpy(np.asarray(script["mask_all"])))
    settings = NS.Settings.from_env({**case, "NS_DIR": ""})
    port_rows = []
    NS.run(settings, rays=rays, device="cpu", on_row=port_rows.append)

    def losses(rows):
        return [r["loss"] for r in rows if "iter" in r]

    def rel_norms(rows):
        return [(r["iter"], r["rel_norm"]) for r in rows if "iter" in r and "rel_norm" in r]

    jl, pl = losses(jax_rows), losses(port_rows)
    line = dict(case=args.case, settings=case, rays=int(x.shape[0]),
                nbuckets=script["NBUCKETS"], losses_jax=jl, losses_port=pl,
                rel_norm_jax=rel_norms(jax_rows), rel_norm_port=rel_norms(port_rows))
    ok = True
    if args.case == "ladder":
        data = NS.Measurements(rays, "cpu", torch.float32)
        gt = upres_volume(TV.fuel_injection_rif(NS.FUEL_VAL, torch.float32, "cpu"),
                          (settings.ladder[-1][0],) * 3)
        data.trace_ground_truth(gt, settings.final_ds(), script["NBUCKETS"])
        exits = (script["xgt"], script["vgt"])
        exit_err = max(float(np.abs(a.numpy() - b).max()) for a, b in zip((data.xg, data.vg),
                                                                          exits))
        plain = jax_plain_exits(script, settings)
        jax_spread = max(float(np.abs(a - b).max()) for a, b in zip(plain, exits))
        plain_err = max(float(np.abs(a.numpy() - b).max()) for a, b in zip((data.xg, data.vg),
                                                                           plain))
        loss_err = abs(pl[0] - jl[0]) / abs(jl[0])
        ok = loss_err <= LOSS_TOL and exit_err <= EXIT_TOL
        line.update(first_loss_jax=jl[0], first_loss_port=pl[0], first_loss_rel_err=loss_err,
                    first_loss_tol=LOSS_TOL, gt_exit_max_abs_err=exit_err, gt_exit_tol=EXIT_TOL,
                    jax_paired_vs_plain_gt_exit_max_abs=jax_spread,
                    port_vs_jax_plain_gt_exit_max_abs=plain_err, ok=ok)
    text = json.dumps(line)
    print(text, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0 if ok else 1


def jax_plain_exits(script, settings):
    """The script's ground-truth exits traced again by the JAX package's plain
    f32 stepper (``tracer/eikonal.py::trace``), a microbatch at a time."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from adjointnonlinearraytracing_tpu import sensors
    from adjointnonlinearraytracing_tpu.fields.grid import GridField
    from adjointnonlinearraytracing_tpu.tracer import eikonal

    res = settings.ladder[-1][0]
    h, ds = 1.0 / (res - 1), settings.final_ds()
    steps = eikonal.max_steps_fwd(res, h, ds)

    @jax.jit
    def exits(gt, x, v, sp, sn):
        return sensors.trace_rays_to_plane(eikonal.trace(GridField(gt, h), x, v, ds, steps),
                                           (sp, sn))

    chunk = script["CHUNK"]
    out = [exits(script["gt"], *(jnp.asarray(script[k][c * chunk:(c + 1) * chunk])
                                 for k in ("x_all", "v_all", "sp_all", "sn_all")))
           for c in range(script["nchunks_total"])]
    return tuple(np.concatenate([np.asarray(o[i]) for o in out]) for i in range(2))


if __name__ == "__main__":
    sys.exit(main())
