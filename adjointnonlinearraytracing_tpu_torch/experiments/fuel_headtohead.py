"""The nonlinear adjoint against the 2008 linear baseline, in one table.

Twin of the JAX system's repo-root script ``run_fuel_headtohead.py`` and of
the fold-in that later added the tuned baseline to its record
(``results/fuel_headtohead/update_r5.py``).  It runs the Atcheson-2008
pipeline (``pathmatrix.fuel2008.fuel_reconstruction``) on the 65^3 fuel
volume (the f32 field cast to f64, as the script casts it) at the reference's
own baseline protocol, 32 views x 64^2 x 16 spp = 2,097,152 rays with a 64^3
reconstruction (:data:`PROTOCOL`), and tables it against the adjoint north
star's ``rel_norm``, read at run time from a north-star report
(``experiments.northstar.read_report``: the port's
``results/fuel_northstar_torch/report.json`` by default; a missing report
raises, naming its path, before the reconstruction starts).  Given a sweep
report (``experiments.fuel2008_sweep``), the table also holds the baseline at
its best setting (``linear_2008_tuned``: the sweep's best row at the full
protocol and every row's ``rel_norm``).

Every ratio in ``advantage`` is computed here from those inputs and named by
both grids as read: ``adjoint_<a>_vs_2008_recon<r>`` is the 2008
reconstruction's ``rel_norm`` on an ``r^3`` grid over the north star's at its
``a^3`` stage, for the north star's last stage and for the stage whose grid is
nearest ``r + 1`` nodes (``_tuned_`` for the tuned baseline).  No ratio pairs
a reconstruction with an adjoint grid it does not name.

On the card the ground-truth trace is one K2 launch (f64) and the error's
field evaluation one K1; the path matrix, LSQR and the integration run on the
host.  At the full protocol the path matrix holds ~1.4e8 entries and LSQR
took 1,409 s of the JAX host's 1,797 (its record); run it by::

    python -m adjointnonlinearraytracing_tpu_torch.experiments.fuel_headtohead

with ``H2H_DIR`` (default ``results/fuel_headtohead_torch``, beside the JAX
record), ``H2H_NORTHSTAR`` (the north-star report) and ``H2H_SWEEP`` (a
sweep's ``report.json``, optional).  Writes ``recon_2008.npy`` and ``report.json``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np

from ..convert import require_device
from ..pathmatrix import fuel2008
from ..utils.profiling import card_line
from . import fuel2008_sweep, northstar

OUT_DIR = "results/fuel_headtohead_torch"
#: the reference's 2008-baseline protocol (run_fuel_injection_2008.py:92)
PROTOCOL = dict(nviews=32, nbins=64, spp=16, int_res=175, seed=0)
METRIC = ("rel_norm = ||recon - gt|| / ||gt - background|| (run_fuel_injection_2008.py:230-234 "
          "convention)")


def recon_grid(gt, protocol: Dict) -> int:
    """The 2008 reconstruction's grid: ``recon_res``, else the volume's cells."""
    return protocol.get("recon_res") or gt.shape[0] - 1


def compared_grids(recon: int, final: int, per_stage: Dict[int, float]):
    """The north star's grids a reconstruction on ``recon^3`` is set beside:
    the stage nearest ``recon + 1`` nodes (the smaller of two equally near)
    and the last."""
    near = min(per_stage, key=lambda a: (abs(a - (recon + 1)), a)) if per_stage else final
    return sorted({near, final})


def read_sweep(path: str) -> dict:
    """A sweep's report (``fuel2008_sweep``); raises, naming ``path``, if missing."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no sweep report at {path}")
    with open(path) as f:
        return json.load(f)


def run(gt=None, protocol: Dict = PROTOCOL, northstar_report: str = northstar.REPORT,
        sweep_report: Optional[str] = None, out_dir: Optional[str] = OUT_DIR, device="cuda"):
    """The table: the 2008 baseline run at ``protocol`` on ``device``, beside
    the north star of ``northstar_report`` and,
    where given, the tuned baseline of ``sweep_report``.  Returns ``(recon,
    table)``; writes ``recon_2008.npy`` and ``report.json`` into ``out_dir``
    unless it is None."""
    dev = require_device(device)
    final, ns_final, per_stage = northstar.read_report(northstar_report)
    sweep = read_sweep(sweep_report) if sweep_report else None
    gt = fuel2008_sweep.ground_truth(dev) if gt is None else gt
    t0 = time.time()
    recon, rep = fuel2008.fuel_reconstruction(gt, protocol, device=dev)
    wall = time.time() - t0
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        np.save(os.path.join(out_dir, "recon_2008.npy"), recon)

    r = recon_grid(gt, protocol)
    ns = {**per_stage, final: ns_final}
    table = {
        "gt_volume": "fuel_injection_64 -> 65^3 rif (voxel_scenes)",
        "metric": METRIC,
        "linear_2008": {
            "protocol": f"{fuel2008_sweep.protocol_text(protocol)} at int_res "
                        f"{protocol.get('int_res')}, {r}^3 linear-path Phi + per-axis LSQR + "
                        "Poisson integration",
            "recon_res": r,
            "rays": rep["num_rays"],
            "rel_norm": rep["rel_err_norm"],
            "max_err": rep["max_err"],
            "l1_err": rep["l1_err"],
            "phi_nnz": rep["phi_nnz"],
            "trace_time_s": rep["trace_time"],
            "phi_time_s": rep["phi_time"],
            "solve_time_s": rep["solve_time"],
            "integration_time_s": rep["integration_time"],
            "total_time_s": rep["total_time"],
            "wall_time_s": wall,
            "process_peak_rss_mb": rep["process_peak_rss_mb"],
        },
        "nonlinear_adjoint": {
            "protocol": "multires adjoint tomography (north star), its fixed measurement set",
            "grid": final,
            **{f"rel_norm_{a}": v for a, v in sorted(ns.items())},
            "source": northstar_report,
        },
        "scale_note": "Phi at the 10.49M-ray north-star budget would exceed 1e9 nnz; "
                      "2.1M rays/64^3 is the reference's own 2008-baseline protocol.",
        "device": str(dev),
        "card": card_line() if dev.type == "cuda" else None,
    }
    entries = [("2008", r, rep["rel_err_norm"])]
    if sweep is not None:
        best = sweep["best_full_protocol"]
        r_tuned = recon_grid(gt, best["cfg"])
        table["linear_2008_tuned"] = {
            "sweep": sweep_report,
            "best_cfg": best["cfg"],
            "recon_res": r_tuned,
            "rel_norm": best["rel_norm"],
            "lever_summary": {row["name"]: row["rel_norm"] for row in sweep["rows"]
                              if "rel_norm" in row},
        }
        entries.append(("2008_tuned", r_tuned, best["rel_norm"]))
    advantage = {}
    for label, grid, rel in entries:
        for a in compared_grids(grid, final, per_stage):
            advantage[f"adjoint_{a}_vs_{label}_recon{grid}"] = rel / max(ns[a], 1e-12)
    table["advantage"] = advantage
    if out_dir:
        with open(os.path.join(out_dir, "report.json"), "w") as f:
            json.dump(table, f, indent=2)
    return recon, table


def main(environ=os.environ) -> dict:
    _, table = run(northstar_report=environ.get("H2H_NORTHSTAR", northstar.REPORT),
                   sweep_report=environ.get("H2H_SWEEP") or None,
                   out_dir=environ.get("H2H_DIR", OUT_DIR))
    print(json.dumps(table, indent=2))
    return table


if __name__ == "__main__":
    main()
