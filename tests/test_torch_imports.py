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
from adjointnonlinearraytracing_tpu_torch import convert
from adjointnonlinearraytracing_tpu_torch.benchmarks.scenes import build_case
from adjointnonlinearraytracing_tpu_torch.kernels import build, wrappers

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|adjointnonlinearraytracing_tpu)(\.|\s|$)", re.MULTILINE)


def _modules():
    return [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]


def test_every_module_imports_without_jax():
    names = _modules()
    assert len(names) >= 60
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
    assert len(files) >= 30
    for f in files:
        assert not FORBIDDEN.search(f.read_text()), f


ROOT_DRIVERS = re.compile(r"^\s*(import|from)\s+(run_\w+|bench|__graft_entry__)(\.|\s|$)",
                          re.MULTILINE)


def test_sources_import_no_root_script():
    """The port's twins of the JAX system's repo-root drivers keep their own
    copies of the scripts' settings: no port module imports a root script."""
    scripts = sorted(p.stem for p in ROOT.glob("run_*.py"))
    assert len(scripts) >= 9
    files = sorted((ROOT / "adjointnonlinearraytracing_tpu_torch").rglob("*.py"))
    for f in files + [ROOT / "chip_smoke.py"]:
        assert not ROOT_DRIVERS.search(f.read_text()), f
    twins = {p.stem for p in (ROOT / "adjointnonlinearraytracing_tpu_torch" / "experiments")
             .glob("*.py")}
    assert {"northstar", "fuel_headtohead", "image_flagship", "image_singleview",
            "fiber_ladder", "fuel2008_sweep"} <= twins


def test_build_case_default_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the GPU-less behaviour")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_case(res=5, nrays=4)
    rif, x0, v0, span = build_case(res=5, nrays=4, device="cpu")
    assert rif.device.type == "cpu" and rif.shape == (5, 5, 5) and x0.shape == (4, 3)


def test_trainer_probe_and_trace_closure_need_a_gpu_and_never_use_the_cpu_instead():
    """The entry points of the fuel trainer and of the gather probe default to
    the GPU; asked for it where there is none they raise."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the GPU-less behaviour")
    from adjointnonlinearraytracing_tpu_torch.benchmarks import probe_dma_gather
    from adjointnonlinearraytracing_tpu_torch.experiments import common, fuel_injection, runner
    from adjointnonlinearraytracing_tpu_torch.experiments import focalstack, image, luneburg
    from adjointnonlinearraytracing_tpu_torch.experiments import voxel_scenes
    from adjointnonlinearraytracing_tpu_torch.sources import sources

    tiny = dict(fuel_injection.default_params(), res_list=[3], nviews=1, nbins=2, optim_iters=1)
    stack = dict(tiny, source_image=torch.ones(2, 2), focal_stack=[torch.ones(2, 2)],
                 sensor_dists=[1.0])
    for call in (
            lambda: fuel_injection.run_opt(tiny),
            lambda: fuel_injection.run_opt(tiny, device="cuda"),
            lambda: luneburg.run_opt(tiny),
            lambda: image.multires_exp(tiny),
            lambda: focalstack.multires_exp(stack),
            lambda: focalstack.make_synthetic_stack(torch.ones(3, 3, 3), stack),
            lambda: image.load_image(voxel_scenes.data_path("turing.png"), 4),
            lambda: runner.l2ball_sdf(4, 1.0),
            lambda: sources.point_source3(0.0, (2, 2), 1, 1.0),
            lambda: runner.run(str(ROOT / "configs" / "params-fuel.yaml")),
            lambda: runner.run(str(ROOT / "configs" / "params-luneburg.yaml")),
            lambda: runner.run(str(ROOT / "configs" / "params-sdf.yaml")),
            lambda: runner.run(str(ROOT / "configs" / "params-image.yaml"), "einstein-turing"),
            lambda: runner.run(str(ROOT / "configs" / "params-focalstack.yaml")),
            lambda: probe_dma_gather.run(R=8, N=4, reps=1),
            lambda: common.make_trace(1.0, 0.1, device="cuda"),
            lambda: voxel_scenes.fuel_injection_rif(),
            lambda: sources.plane_source3(0.0, 2, 1.0),
            lambda: convert.checkpoint_from_jax_npz("missing.npz")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # a closure made for one device refuses tensors that live on another
    # instead of moving them or tracing where they are
    trace = common.make_trace(1.0, 0.1, device="cpu")
    rif, x0, v0, _ = build_case(res=5, nrays=4, span=1.0, device="cpu")
    assert trace(rif, x0, v0)[0].shape == (4, 3)
    with pytest.raises(RuntimeError, match="this trace was made for cpu"):
        trace(rif.to("meta"), x0, v0)


def test_measurement_modules_and_sources_need_a_gpu_unless_asked_for_the_cpu():
    """The entry points of the measurement modules, the profiling helpers and
    the 2D sources default to the GPU; asked for it where there is none they
    raise, and with ``device="cpu"`` they run."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the GPU-less behaviour")
    from adjointnonlinearraytracing_tpu_torch.benchmarks import (
        compaction_bench, ds_study, probe_bandscatter, probe_ds_speed, probe_evalmath,
        probe_exact_envelope, probe_hotops, probe_scatter3, scaling, sweeps)
    from adjointnonlinearraytracing_tpu_torch.sources import sources
    from adjointnonlinearraytracing_tpu_torch.utils import profiling

    one = torch.ones(2)
    for call in (
            lambda: probe_evalmath.run(res=5, n=4, reps=1),
            lambda: sweeps.profile_stepsize(nrays=4, res=5, iters=1),
            lambda: sweeps.profile_resolution(nrays=4, iters=1, res_list=(5,)),
            lambda: ds_study.study(res=5, nrays=4),
            lambda: ds_study.main(["--res", "5", "--nrays", "4", "--out", ""]),
            lambda: ds_study.entry_rays(4, 1.0),
            lambda: compaction_bench.run(res=5, nrays=8),
            lambda: compaction_bench.spread_case(res=5, nrays=8),
            lambda: scaling.profile_scaling(res=5, rays_per_device=4, iters=1),
            lambda: probe_ds_speed.run(res=5, nrays=4, iters=1),
            lambda: probe_exact_envelope.run_case(5, nrays=4, steps=1),
            lambda: probe_scatter3.run(n=4, steps=1, reps=1),
            lambda: probe_hotops.run(steps=1, reps=1),
            lambda: probe_bandscatter.run(n=4, steps=1, reps=1),
            lambda: profiling.force(one),
            lambda: profiling.timeit(lambda: one),
            lambda: profiling.device_memory_gb(),
            lambda: profiling.trace("unused").__enter__(),
            lambda: sources.plane_source(0.0, 4, 1.0),
            lambda: sources.rays_in_circle(2, 4, 1.0)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert profiling.force(one, device="cpu") == 2.0
    assert sources.plane_source(0.0, 4, 1.0, device="cpu")[0].device.type == "cpu"
    assert scaling.profile_scaling(res=5, rays_per_device=4, iters=1, device="cpu")[0][
        "devices"] == 1


def test_kernel_wrappers_refuse_cpu_tensors():
    rif, x0, v0, _ = build_case(res=5, nrays=4, device="cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        wrappers.eval_grad(rif, 1.0, x0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        wrappers.trace_fwd(rif, 1.0, x0, v0, 0.5, 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        wrappers.backtrace(rif, 1.0, x0, v0, x0, v0, 0.5, 4, 1e-3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        wrappers.gather_rows(torch.zeros(4, 128), torch.zeros(2, dtype=torch.int32))
    order = torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        wrappers.trace_ckpt(rif, 1.0, x0, v0, 0.5, 4, 2, order)
    with pytest.raises(ValueError, match="CUDA tensors"):
        wrappers.backtrace_exact(rif, 1.0, torch.zeros(2, 7, 4), torch.zeros(4, dtype=torch.int32),
                                 torch.zeros(4, dtype=torch.uint8), x0, v0, 0.5, 2, order)
    assert set(wrappers.LAUNCHES.values()) == {0}
    assert set(wrappers.LAUNCHES) == set(build.KERNELS) == set(build.SOURCE)
    # every kernel's source is in the checkout, and every source builds a kernel
    assert {p.stem for p in build.CSRC.glob("*.cu")} == set(build.SOURCE.values())


def test_chip_smoke_fails_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the GPU-less behaviour")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_northstar_needs_a_gpu_unless_asked_for_the_cpu(tmp_path):
    """The north star defaults to the GPU: where there is none its
    entry points raise, before they draw or write anything."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the GPU-less behaviour")
    from adjointnonlinearraytracing_tpu_torch.experiments import northstar

    tiny = northstar.Settings(stages=((3, 1, 1),), scale=16, result_dir=str(tmp_path / "ns"))
    for call in (lambda: northstar.run(tiny),
                 lambda: northstar.measurement_set(scale=16),
                 lambda: northstar.initial_field(tiny)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not (tmp_path / "ns").exists()
    assert northstar.initial_field(tiny, device="cpu").shape == (3, 3, 3)
