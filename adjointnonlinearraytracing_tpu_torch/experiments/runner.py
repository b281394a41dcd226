"""Run a shipped params YAML end to end.

Twin of ``adjointnonlinearraytracing_tpu/experiments/runner.py``, so far for
the fuel-injection family only: it loads a section with
``config.load_params`` and dispatches to the experiment, on the GPU
unless ``--device cpu`` is given.

Usage::

    python -m adjointnonlinearraytracing_tpu_torch.experiments.runner \\
        configs/params-fuel.yaml --result-dir results/fuel_torch

The family is inferred from the filename (``params-<family>*.yaml``) or an
explicit ``family:`` key in the YAML.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional

from . import config as cfg

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


def run(path: str, section: Optional[str] = None, result_dir: Optional[str] = None,
        overrides: Optional[Dict] = None, device="cuda"):
    """Load + dispatch.  Returns the experiment's result tuple."""
    params = cfg.load_params(path, section)
    params.update(overrides or {})
    family = infer_family(path, params)
    if family not in FAMILIES:
        raise ValueError(f"unknown experiment family {family!r}")
    if family != "fuel":
        raise NotImplementedError(
            f"experiment family {family!r} is not ported yet (ROADMAP.md A11); "
            "only 'fuel' runs in the PyTorch port")
    if result_dir:
        os.makedirs(result_dir, exist_ok=True)
    from . import fuel_injection
    return fuel_injection.run_opt(params, result_dir, device=device)


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
