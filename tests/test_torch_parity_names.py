"""Every public top-level function and class of the JAX package has a namesake
in the port's module of the same path, but for the decided exceptions below.

Both trees are parsed with ``ast`` and never imported, so this takes well
under a second.  A namesake is a top-level ``def``, ``class``, assignment or
imported name of the port's module.  Each exception carries its reason; an
exception that is no longer needed fails the test too, so the list stays
exact.
"""

import ast
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "adjointnonlinearraytracing_tpu"
PORT_PKG = ROOT / "adjointnonlinearraytracing_tpu_torch"

# files of the JAX package the port leaves out (B4, decided when the last
# modules were ported): the TPU's window and cell-table layouts, which the
# port's kernels replace with raw 8-corner reads, an empty package and a probe
# of those layouts
NOT_PORTED_FILES = {
    "fields/windows.py": "the TPU's 64-float window table per cell; the port's kernels "
                         "read the 8 corners of the grid itself",
    "tracer/fast.py": "the cell-table stepper of the TPU; the port's plain stepper is "
                      "tracer/eikonal.py, its kernels K2, K3, K11-K14",
    "tracer/paired.py": "the paired window stepper of the TPU; replaced as tracer/fast.py is",
    "pallas/__init__.py": "empty in the JAX package",
    "benchmarks/probe_scatter2.py": "probes scatters into the window layout of "
                                    "fields/windows.py, which the port does not have",
}

# names of ported files that stay JAX-only: each probe's own timing helper and
# its cases, which time JAX or Pallas code (the port's probes time its kernels
# and PyTorch calls instead, under their own names), and the conversion to JAX
NOT_PORTED_NAMES = {
    "benchmarks/probe_bandscatter.py": {
        "timeit": "utils.profiling times the port's probes",
        "baseline_case": "a jitted JAX case; the port's is baseline()",
        "band_case": "a jitted JAX case; the port's is band_scatter()",
        "sort_segsum_case": "a jitted JAX case; the port's is sort_segsum()",
        "segsum_case": "a jitted JAX case; the port's is segsum_unsorted()",
        "sort_only_case": "a jitted JAX case; the port's is sort_only()",
        "take_only_case": "a jitted JAX case; the port's is sort_take()",
    },
    "benchmarks/probe_dma_gather.py": {
        "dma_gather": "the Pallas DMA ring; the port's twin is kernel K4, "
                      "kernels.wrappers.gather_rows",
    },
    "benchmarks/probe_evalmath.py": {
        "timeit": "utils.profiling times the port's probes",
        "xla_eval_case": "XLA's evaluation; the port times its plain version",
        "xla_bwd_case": "XLA's Hessian and splat; the port times its plain ones",
        "pallas_eval_case": "the Pallas kernel; the port's twin is kernel K1",
        "lane_bound_case": "a TPU lane-width bound; the port bounds K1 by bytes",
        "check_pallas_correctness": "holds the Pallas kernel; the port's run() holds K1",
    },
    "benchmarks/probe_scatter3.py": {
        "timeit": "utils.profiling times the port's probes",
        "scatter_case": "a jitted JAX case; the port's is scatter()",
        "gather_case": "a jitted JAX case; the port's is gather()",
        "segsum_case": "a jitted JAX case; the port's is sort_segsum()",
    },
    "experiments/voxel_scenes.py": {
        "to_jax": "converts to JAX arrays; the port keeps torch tensors (convert.py)",
    },
}


def _public(path):
    tree = ast.parse(path.read_text())
    return [n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            and not n.name.startswith("_")]


def _names(path):
    out = set()
    for n in ast.parse(path.read_text()).body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(n.name)
        elif isinstance(n, ast.Assign):
            out.update(e.id for t in n.targets for e in ast.walk(t) if isinstance(e, ast.Name))
        elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            out.add(n.target.id)
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0] for a in n.names)
    return out


def test_every_public_name_has_a_namesake_in_the_port():
    files = sorted(JAX_PKG.rglob("*.py"))
    assert len(files) >= 50
    missing, missing_files, unneeded = [], [], []
    for path in files:
        rel = path.relative_to(JAX_PKG).as_posix()
        port = PORT_PKG / rel
        if rel in NOT_PORTED_FILES:
            if port.exists():
                unneeded.append(rel)
            continue
        public = _public(path)
        if not port.exists():
            if public or path.name != "__init__.py":
                missing_files.append(rel)
            continue
        have = _names(port)
        allowed = NOT_PORTED_NAMES.get(rel, {})
        missing += [f"{rel}::{name}" for name in public if name not in have
                    and name not in allowed]
        unneeded += [f"{rel}::{name}" for name in allowed if name in have or name not in public]
    assert not missing_files, f"JAX modules with no port: {missing_files}"
    assert not missing, f"public names with no namesake in the port: {missing}"
    assert not unneeded, f"exceptions no longer needed: {unneeded}"
    assert all(reason for reasons in NOT_PORTED_NAMES.values() for reason in reasons.values())
