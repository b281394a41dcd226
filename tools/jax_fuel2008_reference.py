"""The JAX package's 2008 reconstruction on the CPU, as the port's yardstick.

Run from the repo root on any machine (CPU only; it takes a few minutes and
a few GB at the default size)::

    JAX_PLATFORMS=cpu python tools/jax_fuel2008_reference.py [--spline true] [--out FILE]

It runs the JAX package's ``pathmatrix.fuel2008.fuel_reconstruction`` in
float64 on the 65^3 fuel volume in the repo's screening protocol (32 views of
64^2 x 4 spp = 524,288 rays, ``int_res`` 256, seed 0) with a 16^3
reconstruction, the configuration ``combo_recon16_hermite`` of
``run_fuel2008_finish.py`` with the path model given (``true`` adds
``path_stride`` 8, as ``run_fuel2008_sweep3.py`` runs it), and prints one JSON
line of its report.  ``chip_smoke.py`` holds the port's ``rel_err_norm`` in
the same configuration within 5 % of the value this prints (the port draws
other rays).  This script is the only code beside the tests that imports the
JAX package; nothing of the port imports it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spline", default="true", choices=("linear", "hermite", "true"))
    ap.add_argument("--out", default=None, help="also write the JSON line to this file")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from adjointnonlinearraytracing_tpu.experiments import voxel_scenes
    from adjointnonlinearraytracing_tpu.pathmatrix import fuel2008

    cfg = dict(nviews=32, nbins=64, spp=4, int_res=256, seed=0, recon_res=16,
               spline=args.spline)
    if args.spline == "true":
        cfg["path_stride"] = 8
    gt = voxel_scenes.fuel_injection_rif().astype(jnp.float64)
    t0 = time.time()
    _, rep = fuel2008.fuel_reconstruction(gt, cfg)
    line = json.dumps(dict(cfg=cfg, wall_s=time.time() - t0, device=str(jax.devices()[0]),
                           **rep))
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
