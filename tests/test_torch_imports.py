"""The port stands alone: it imports neither jax nor the JAX package, imports
without a GPU, ``nvcc`` or ``triton``, and its entry points do not quietly
run on the CPU."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import adjointnonlinearraytracing_tpu_torch as port
from adjointnonlinearraytracing_tpu_torch.benchmarks.scenes import build_case
from adjointnonlinearraytracing_tpu_torch.kernels import wrappers

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|adjointnonlinearraytracing_tpu)(\.|\s|$)", re.MULTILINE)


def _modules():
    return [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]


def test_every_module_imports_without_jax():
    names = _modules()
    assert len(names) >= 12
    code = (
        "import importlib, sys\n"
        "from adjointnonlinearraytracing_tpu_torch.kernels import build\n"
        "before = set(build.BUILD_DIR.glob('*'))\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'adjointnonlinearraytracing_tpu'\n"
        "       or m.startswith('adjointnonlinearraytracing_tpu.')]\n"
        "assert not bad, bad\n"
        "# importing builds and loads nothing; libraries of an earlier run may lie there\n"
        "assert not build._libs, build._libs\n"
        "assert set(build.BUILD_DIR.glob('*')) == before\n"
        "print('ok', len(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_sources_name_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "adjointnonlinearraytracing_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) >= 14
    for f in files:
        assert not FORBIDDEN.search(f.read_text()), f


def test_build_case_default_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the GPU-less behaviour")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_case(res=5, nrays=4)
    rif, x0, v0, span = build_case(res=5, nrays=4, device="cpu")
    assert rif.device.type == "cpu" and rif.shape == (5, 5, 5) and x0.shape == (4, 3)


def test_kernel_wrappers_refuse_cpu_tensors():
    rif, x0, v0, _ = build_case(res=5, nrays=4, device="cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        wrappers.eval_grad(rif, 1.0, x0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        wrappers.trace_fwd(rif, 1.0, x0, v0, 0.5, 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        wrappers.backtrace(rif, 1.0, x0, v0, x0, v0, 0.5, 4, 1e-3)
    assert set(wrappers.LAUNCHES.values()) == {0}


def test_chip_smoke_fails_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the GPU-less behaviour")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
