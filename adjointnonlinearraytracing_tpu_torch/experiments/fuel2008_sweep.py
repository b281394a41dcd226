"""The 2008 linear baseline tuned to its best: the four sweeps of its levers.

Twin of the JAX system's repo-root scripts ``run_fuel2008_sweep.py``
(:func:`sweep`), ``run_fuel2008_sweep2.py`` (:func:`sweep2`),
``run_fuel2008_sweep3.py`` (:func:`sweep3`) and ``run_fuel2008_finish.py``
(:func:`finish`).  Each row is one ``pathmatrix.fuel2008.fuel_reconstruction``
of the 65^3 fuel volume (the f32 field cast to f64, as the scripts cast it) on
a screening protocol of 32 views x 64^2 x 4 spp = 524,288 rays
(:data:`SCREEN`), written by :func:`run_cfg` with the scripts' keys and
appended to ``<out_dir>/sweep.jsonl``; each sweep then runs its best row again
at 16 spp, the reference's full protocol (2,097,152 rays), and writes its
report.  The levers (LSQR damping, the reconstruction grid, the path model,
the acquisition geometry, the integration damping) and the order, names and
choice of the best row are the scripts'.  Every lever list and the protocol
are keyword arguments whose defaults are the scripts' values.  On the card
the ground-truth trace is K2 (f64), the true paths K20 and the error's field
evaluation K1; the path matrix, LSQR and the integration run on the host.

Three departures from the scripts:

* :func:`sweep2` raises if phase 1's ``report.json`` is missing; the script
  polls for it every 60 s without end.
* A row whose configuration fails (a ``ValueError``, an arithmetic or
  linear-algebra error, memory) is written as the scripts write it
  (``error``, ``total_s``) and the sweep goes on, but the sweep raises
  :class:`SweepError` once its report is written, so the run exits non-zero.
  Any other error (a CUDA fault, a kernel that does not build) is raised at
  once; the scripts keep sweeping past every ``Exception``.
* The north star's ``rel_norm`` beside the report is read at run time from a
  north-star report (the port's ``results/fuel_northstar_torch/report.json``
  by default; ``experiments.northstar.read_report``), before the first row;
  the scripts write literals.  A missing report raises, naming its path.

Run on the card from the repo root::

    python -m adjointnonlinearraytracing_tpu_torch.experiments.fuel2008_sweep \\
        {sweep,sweep2,sweep3,finish}

with ``F2008_DIR`` (default ``results/fuel2008_sweep_torch``, beside the JAX
record ``results/fuel2008_sweep/``) and ``F2008_NORTHSTAR`` (the north-star
report).
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, List, Optional

import torch

from ..convert import require_device
from ..pathmatrix import fuel2008
from ..utils.profiling import card_line
from . import northstar, voxel_scenes

OUT_DIR = "results/fuel2008_sweep_torch"
#: the screening protocol of every sweep: 32 views x 64^2 x 4 spp, 64^3
SCREEN = dict(nviews=32, nbins=64, spp=4, int_res=256, seed=0)
#: the reference's full protocol re-runs the best row at this spp
FULL_SPP = 16
#: phase 1's levers: LSQR damping, then integration damping around the default
DAMPS_1 = (0.0, 1e-7, 1e-6, 1e-5, 1e-4, 1e-3)
DAMP_INTS_1 = (1e-5, 1e-3)
#: phase 2's: strong damping and coarser reconstruction grids
DAMPS_2 = (1e-2, 1e-1, 1.0)
RECON_GRIDS = (16, 32, 48)
#: sweep3's one strong damping, by the script's name for it
STRONG_DAMP = ("damp_1e-2", 1e-2)
#: sweep3 combines its two best levers only where the second beats this
#: rel_norm, the one the light damps of phase 1 left pinned near (3.9036)
COMBO_BELOW = 3.9
#: the configuration ``finish`` adds to the rows on file
FINISH_COMBO = ("combo_recon16_hermite", dict(recon_res=16, spline="hermite"))
#: the errors a row records and sweeps past: a configuration the pipeline
#: refuses or cannot solve (numpy's LinAlgError is a ValueError)
ROW_ERRORS = (ValueError, ArithmeticError, MemoryError)
PRIOR_FINDINGS = ("damp_0 reproduces the earlier full damping sweep bit-for-bit (rel_norm "
                  "3.9036); damps up to 1e-3 left rel_norm pinned there")


class SweepError(RuntimeError):
    """Rows of a sweep that hold an error (written to its report first)."""


def ground_truth(device="cuda") -> torch.Tensor:
    """The 65^3 fuel volume as the scripts take it: the f32 field cast to f64."""
    return voxel_scenes.fuel_injection_rif(device=device).to(torch.float64)


def run_cfg(gt, name: str, cfg: Dict, rows: List[dict], out_dir: str = OUT_DIR,
            device="cuda") -> dict:
    """One ``fuel_reconstruction`` of ``cfg``: its row (the scripts' keys),
    appended to ``rows`` and to ``<out_dir>/sweep.jsonl`` and printed."""
    t0 = time.time()
    try:
        _, rep = fuel2008.fuel_reconstruction(gt, cfg, device=device)
        row = dict(name=name, cfg=dict(cfg), rel_norm=rep["rel_err_norm"],
                   max_err=rep["max_err"], l1_err=rep["l1_err"], rays=rep["num_rays"],
                   solve_s=round(rep["solve_time"], 1), total_s=round(time.time() - t0, 1))
    except ROW_ERRORS as e:
        row = dict(name=name, cfg=dict(cfg), error=repr(e), total_s=round(time.time() - t0, 1))
    rows.append(row)
    print(json.dumps(row), flush=True)
    with open(os.path.join(out_dir, "sweep.jsonl"), "a") as f:
        f.write(json.dumps(row) + "\n")
    return row


def best_row(rows: List[dict], where=lambda row: True) -> Optional[dict]:
    """The row of least ``rel_norm`` among those without an error (the first
    of equals, as ``min`` picks), or None."""
    return min((r for r in rows if "rel_norm" in r and where(r)), default=None,
               key=lambda r: r["rel_norm"])


def protocol_text(screen: Dict) -> str:
    """``"32 views x 64^2 x 4 spp (524k rays)"`` for :data:`SCREEN`."""
    n = screen["nviews"] * screen["nbins"] ** 2 * screen["spp"]
    return (f"{screen['nviews']} views x {screen['nbins']}^2 x {screen['spp']} spp "
            f"({n // 1000}k rays)")


def full_protocol(row: dict) -> dict:
    """``row``'s configuration at the full protocol's spp."""
    return dict(row["cfg"], spp=FULL_SPP)


def adjoint_reference(path: str) -> dict:
    """The north star's ``rel_norm`` at each stage, read from ``path``."""
    final, rel_norm, per_stage = northstar.read_report(path)
    return {**{f"rel_norm_{r}": v for r, v in sorted(per_stage.items())},
            f"rel_norm_{final}": rel_norm, "source": path}


class _Run:
    """What every sweep sets up: its device, directory, ground truth and rows."""

    def __init__(self, gt, out_dir, device, truncate=False):
        self.dev = require_device(device)
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        if truncate:
            open(os.path.join(out_dir, "sweep.jsonl"), "w").close()
        self.gt = ground_truth(self.dev) if gt is None else gt
        self.rows: List[dict] = []

    def __call__(self, name, cfg) -> dict:
        return run_cfg(self.gt, name, cfg, self.rows, self.out_dir, self.dev)

    def finish(self, report: dict, filename: str) -> dict:
        """Write ``report``; raise :class:`SweepError` where a row holds an error."""
        report["device"] = str(self.dev)
        report["card"] = card_line() if self.dev.type == "cuda" else None
        with open(os.path.join(self.out_dir, filename), "w") as f:
            json.dump(report, f, indent=2)
        failed = [r["name"] for r in self.rows if "error" in r]
        if failed:
            raise SweepError(f"rows {failed} hold an error (see {self.out_dir}/sweep.jsonl)")
        return report


def sweep(gt=None, *, out_dir: str = OUT_DIR, northstar_report: str = northstar.REPORT,
          screen: Dict = SCREEN, damps=DAMPS_1, damp_ints=DAMP_INTS_1, device="cuda") -> dict:
    """Phase 1 (``run_fuel2008_sweep.py``): LSQR damping; at the best damping
    the reference's 180-degree geometry at 1.4 span, ``int_res`` 175, the
    hermite and the recorded true paths, integration damping; the best row at
    the full protocol.  Starts ``sweep.jsonl`` afresh; writes ``report.json``."""
    reference = adjoint_reference(northstar_report)
    run = _Run(gt, out_dir, device, truncate=True)
    for damp in damps:
        run(f"damp_{damp:g}", dict(screen, damp=damp))
    best_damp = best_row(run.rows)["cfg"]["damp"]
    run("geom_ref180", dict(screen, damp=best_damp, angle_span=180, sensor_dist_frac=1.4))
    run("int_res175", dict(screen, damp=best_damp, int_res=175))
    run("hermite", dict(screen, damp=best_damp, spline="hermite"))
    run("true_paths", dict(screen, damp=best_damp, spline="true", path_stride=8))
    for di in damp_ints:
        run(f"dampint_{di:g}", dict(screen, damp=best_damp, damp_int=di))
    best = best_row(run.rows)
    final = run("BEST_full_protocol", full_protocol(best))
    return run.finish(dict(
        purpose="2008 baseline at its best: sweep of damp / geometry / int_res / path model, "
                "then the best setting at the reference's full 2.1M-ray protocol",
        screening_protocol=f"{protocol_text(screen)}, 64^3", rows=run.rows, best_screening=best,
        best_full_protocol=final, adjoint_rel_norm_for_reference=reference), "report.json")


def sweep2(gt=None, *, out_dir: str = OUT_DIR, screen: Dict = SCREEN, damps=DAMPS_2,
           grids=RECON_GRIDS, device="cuda") -> dict:
    """Phase 2 (``run_fuel2008_sweep2.py``): damping up to 1 and coarser
    reconstruction grids, the best grid with damping 1e-2, the best row at the
    full protocol; appends to ``sweep.jsonl``, writes ``report2.json``.
    Raises if phase 1's ``report.json`` is not there (the script waits)."""
    phase1 = os.path.join(out_dir, "report.json")
    if not os.path.isfile(phase1):
        raise FileNotFoundError(f"sweep2 follows phase 1: {phase1} is missing (run sweep first)")
    run = _Run(gt, out_dir, device)
    for damp in damps:
        run(f"damp_{damp:g}", dict(screen, damp=damp))
    for rr in grids:
        run(f"recon{rr}", dict(screen, recon_res=rr))
    best = best_row(run.rows)
    if best["cfg"].get("recon_res"):
        run(f"recon{best['cfg']['recon_res']}_damp1e-2", dict(best["cfg"], damp=1e-2))
    best = best_row(run.rows)
    final = run("BEST2_full_protocol", full_protocol(best))
    return run.finish(dict(rows=run.rows, best_screening=best, best_full_protocol=final),
                      "report2.json")


def sweep3(gt=None, *, out_dir: str = OUT_DIR, northstar_report: str = northstar.REPORT,
           screen: Dict = SCREEN, grids=RECON_GRIDS, strong_damp=STRONG_DAMP,
           combo_below=COMBO_BELOW, device="cuda") -> dict:
    """The trimmed sweep (``run_fuel2008_sweep3.py``): one configuration a
    lever, the reconstruction grids first; where the best is a grid, it is
    combined with the best other lever if that one beats ``combo_below``; the
    best row at the full protocol.  Appends to ``sweep.jsonl``, writes
    ``report.json``."""
    reference = adjoint_reference(northstar_report)
    run = _Run(gt, out_dir, device)
    for rr in grids:
        run(f"recon{rr}", dict(screen, recon_res=rr))
    run("hermite", dict(screen, spline="hermite"))
    run("true_paths", dict(screen, spline="true", path_stride=8))
    run(strong_damp[0], dict(screen, damp=strong_damp[1]))
    run("geom_ref180", dict(screen, angle_span=180, sensor_dist_frac=1.4))
    best = best_row(run.rows)
    if best["cfg"].get("recon_res") and best["name"].startswith("recon"):
        second = best_row(run.rows, lambda r: not r["name"].startswith("recon"))
        if second is not None and second["rel_norm"] < combo_below:
            combo = dict(best["cfg"])
            for k in ("spline", "path_stride", "damp", "angle_span", "sensor_dist_frac"):
                if k in second["cfg"]:
                    combo[k] = second["cfg"][k]
            run(f"combo_{best['name']}_{second['name']}", combo)
    best = best_row(run.rows)
    final = run("BEST_full_protocol", full_protocol(best))
    return run.finish(dict(
        purpose="2008 baseline at its best, trimmed one-config-per-lever sweep",
        screening_protocol=protocol_text(screen), prior_findings=PRIOR_FINDINGS, rows=run.rows,
        best_screening=best, best_full_protocol=final,
        adjoint_rel_norm_for_reference=reference), "report.json")


def finish(gt=None, *, out_dir: str = OUT_DIR, northstar_report: str = northstar.REPORT,
           screen: Dict = SCREEN, device="cuda") -> dict:
    """``run_fuel2008_finish.py``: the rows of ``sweep.jsonl`` on file, the
    recon16 + hermite combination added, the best of all at the full protocol;
    writes ``report.json``.  Its ``truncated`` names the trimmed sweep's
    screening rows that the file lacks (the script states one it did not run)."""
    reference = adjoint_reference(northstar_report)
    path = os.path.join(out_dir, "sweep.jsonl")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"finish reads the rows on file: {path} is missing")
    with open(path) as f:
        on_file = [json.loads(line) for line in f if line.strip()]
    run = _Run(gt, out_dir, device)
    run.rows = on_file
    name, levers = FINISH_COMBO
    run(name, dict(screen, **levers))
    best = best_row(run.rows)
    final = run("BEST_full_protocol", full_protocol(best))
    trimmed = [f"recon{rr}" for rr in RECON_GRIDS] + ["hermite", "true_paths", STRONG_DAMP[0],
                                                      "geom_ref180"]
    have = {r["name"] for r in on_file}
    return run.finish(dict(
        purpose="2008 baseline at its best, trimmed one-config-per-lever sweep",
        screening_protocol=protocol_text(screen), prior_findings=PRIOR_FINDINGS,
        truncated=[n for n in trimmed if n not in have], rows=run.rows, best_screening=best,
        best_full_protocol=final, adjoint_rel_norm_for_reference=reference), "report.json")


SWEEPS = {"sweep": sweep, "sweep2": sweep2, "sweep3": sweep3, "finish": finish}


def main(argv=None, environ=os.environ) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1 or argv[0] not in SWEEPS:
        raise SystemExit(f"usage: python -m {__name__} {{{','.join(SWEEPS)}}}")
    kwargs = dict(out_dir=environ.get("F2008_DIR", OUT_DIR))
    if argv[0] != "sweep2":
        kwargs["northstar_report"] = environ.get("F2008_NORTHSTAR", northstar.REPORT)
    report = SWEEPS[argv[0]](**kwargs)
    print(f"{argv[0]} complete; best full-protocol rel_norm:",
          report["best_full_protocol"].get("rel_norm"))
    return report


if __name__ == "__main__":
    main()
