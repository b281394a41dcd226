"""The fuel-injection trainer of the port against the JAX package's: the
experiment plumbing (``experiments/common.py``, ``voxel_scenes.py``,
``config.py``, the runner) and the slice as a whole through ``run_opt``.

CPU, f64 (conftest enables x64).  Inputs come from numpy seeds or from the JAX
side's own generators and are handed to both packages.  Tolerances, relative
to the reference's largest magnitude: helpers ``1e-12``; the spot check's three
numbers ``1e-6`` absolute; the whole slice ``1e-8`` for the loss history and
for the final field (12 Adam steps on traced gradients in f64, another
summation order in the adjoint's scatter).
"""

import ast
import json
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adjointnonlinearraytracing_tpu.experiments import common as JC
from adjointnonlinearraytracing_tpu.experiments import config as JCFG
from adjointnonlinearraytracing_tpu.experiments import fuel_injection as JF
from adjointnonlinearraytracing_tpu.experiments import runner as JR
from adjointnonlinearraytracing_tpu.experiments import voxel_scenes as JV
from adjointnonlinearraytracing_tpu.sources import sources as JS
from adjointnonlinearraytracing_tpu_torch import tracer as TT
from adjointnonlinearraytracing_tpu_torch.experiments import common as TC
from adjointnonlinearraytracing_tpu_torch.experiments import config as TCFG
from adjointnonlinearraytracing_tpu_torch.experiments import fuel_injection as TF
from adjointnonlinearraytracing_tpu_torch.experiments import runner as TR
from adjointnonlinearraytracing_tpu_torch.experiments import voxel_scenes as TV
from adjointnonlinearraytracing_tpu_torch.sources import sources as TS
from adjointnonlinearraytracing_tpu_torch.utils.metrics import MetricsLogger, StepTimer

ROOT = Path(__file__).resolve().parent.parent
FUEL_YAML = str(ROOT / "configs" / "params-fuel.yaml")
SPAN = 1.0


def _close(got, want, rtol=1e-12):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(1.0, np.abs(want).max()))


def _jax_rays(nviews, nbins, seed=0):
    """The measurement rays the JAX trainer draws for these params, as numpy."""
    rays, _ = JS.rand_rays_in_sphere(jax.random.PRNGKey(seed), nviews, (nbins, nbins), 1, SPAN,
                                     angle_span=360, circle=False, xaxis=False, sensor_dist=0)
    return tuple(np.array(a) for a in rays)


def _torch_rays(arrays):
    return TS.Rays(*(torch.from_numpy(a) for a in arrays))


@pytest.mark.parametrize("ndim", [1, 2])
def test_masked_losses(ndim):
    rng = np.random.default_rng(0)
    diff = rng.standard_normal((20, 3) if ndim == 2 else (20,))
    for mask in (rng.uniform(size=20) < 0.6, np.zeros(20, bool)):
        for name in ("masked_mean_sq", "masked_sum_sq"):
            got = getattr(TC, name)(torch.from_numpy(diff), torch.from_numpy(mask))
            _close(got, getattr(JC, name)(jnp.asarray(diff), jnp.asarray(mask)))


def test_per_view_planes_and_split_views():
    planes = np.random.default_rng(1).standard_normal((10, 3, 3))
    rpv = [4, 4, 2]
    got = TC.per_view_planes(torch.from_numpy(planes), rpv)
    want = JC.per_view_planes(jnp.asarray(planes), rpv)
    for g_list, w_list in zip(got, want):
        assert len(g_list) == 3
        for g, w in zip(g_list, w_list):
            _close(g, w)
    for g, w in zip(TC.split_views(torch.from_numpy(planes), rpv),
                    JC.split_views(jnp.asarray(planes), rpv)):
        _close(g, w)


def test_voxel_scenes_equal_the_jax_package():
    assert TV.data_path("fuel_injection_64.npy") == JV.data_path("fuel_injection_64.npy")
    for fuel_val in (0.0003, 0.001):
        got = TV.fuel_injection_rif(fuel_val, dtype=torch.float64, device="cpu")
        want = np.asarray(JV.fuel_injection_rif(fuel_val, dtype=jnp.float64))
        assert got.shape == (65, 65, 65) and np.array_equal(got.numpy(), want)
        assert got.min() >= 1.0 - 1e-12 and got.max() == 1.0 + fuel_val == got[-1, 0, 0]
    assert np.array_equal(TV.luneburg_lens(7, 2.0, torch.float64, "cpu").numpy(),
                          np.asarray(JV.luneburg_lens(7, 2.0, jnp.float64)))
    assert np.array_equal(TV.gaussian_bump(6, 1.5, 0.2, torch.float64, "cpu").numpy(),
                          np.asarray(JV.gaussian_bump(6, 1.5, 0.2, jnp.float64)))
    assert TV.gaussian_bump(4, 1.0, device="cpu").dtype == torch.float32


def test_config_reads_the_shipped_yaml_like_the_jax_package():
    for section in (None, "fuel-128"):
        assert TCFG.load_params(FUEL_YAML, section) == JCFG.load_params(FUEL_YAML, section)
    assert TCFG.experiment_names(FUEL_YAML) == ["fuel-128"]
    with pytest.raises(KeyError, match="nope"):
        TCFG.load_params(FUEL_YAML, "nope")
    # the shipped default section is default_params() with nviews = 16 ...
    shipped = TCFG.load_params(FUEL_YAML)
    assert shipped.pop("exp_name") == "default"
    assert shipped == dict(TF.default_params(), nviews=16)
    assert TF.default_params() == JF.default_params()
    # ... and that is the dict chip_smoke.py writes out (the GPU machine may lack yaml)
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "fuel_params")
    scope = {"fuel_injection": TF}
    exec(compile(ast.Module([fn], []), "chip_smoke.py", "exec"), scope)
    assert scope["fuel_params"]() == shipped


@pytest.fixture(scope="module")
def probe_scene():
    """A 5^3 field with a bump and 64 of the JAX trainer's rays."""
    x, v, planes, mask = _jax_rays(1, 8)
    eta = np.array(JV.gaussian_bump(5, SPAN, 0.05, jnp.float64))
    return eta, x, v, mask, SPAN / 8 / 2


def test_make_trace_modes_match_jax(probe_scene, monkeypatch):
    eta, x, v, _, ds = probe_scene

    def jgrad(mode):
        trace = JC.make_trace(SPAN, ds, gradient=mode)
        return jax.jit(jax.grad(
            lambda n: jnp.sum(trace(n, jnp.asarray(x), jnp.asarray(v))[0] ** 2)))(
                jnp.asarray(eta))

    def tgrad(trace):
        n = torch.from_numpy(eta).requires_grad_(True)
        (trace(n, torch.from_numpy(x), torch.from_numpy(v))[0] ** 2).sum().backward()
        return n.grad

    want = {mode: np.asarray(jgrad(mode)) for mode in ("adjoint", "ad", "exact")}
    assert np.abs(want["ad"]).max() > 0
    _close(tgrad(TC.make_trace(SPAN, ds)), want["adjoint"], 1e-10)
    _close(tgrad(TC.make_trace(SPAN, ds, autodiff=True)), want["ad"], 1e-10)
    holder = {"mode": None}
    trace = TC.make_trace(SPAN, ds, gradient=holder, device="cpu",
                          probe_rays=(torch.from_numpy(x), torch.from_numpy(v)))
    _close(tgrad(trace), want["adjoint"], 1e-10)
    holder["mode"] = "ad"  # read at trace time
    _close(tgrad(trace), want["ad"], 1e-10)
    holder["mode"] = "exact"
    _close(tgrad(trace), want["exact"], 1e-10)
    with pytest.raises(ValueError, match="unknown gradient mode"):
        tgrad(TC.make_trace(SPAN, ds, gradient="tape"))
    # the ray mesh (one rank in this process) and exit-step buckets: the same
    # gradients, sharded and bucketed
    for mode in ("adjoint", "exact"):
        trace = TC.make_trace(SPAN, ds, use_mesh=True, gradient=mode)
        assert trace.mesh.world_size == 1
        _close(tgrad(trace), want[mode], 1e-10)
    monkeypatch.setenv("ANRT_BUCKETED", "4")
    trace = TC.make_trace(SPAN, ds)
    assert trace.nbuckets == 4 and x.shape[0] % 4 == 0
    _close(tgrad(trace), want["adjoint"], 1e-10)


def test_gradient_spotcheck_matches_jax(probe_scene, monkeypatch):
    # the JAX package's cell-table stepper: its own tests hold it equal to the
    # paired-window one, and run eagerly, as the spot check runs it, it compiles
    # in a quarter of the time
    monkeypatch.setenv("ANRT_FAST_PATH", "classic")
    eta, x, v, mask, ds = probe_scene
    mask = mask.copy()
    mask[::5] = False
    jm, tm = MetricsLogger(), MetricsLogger()
    want = JC.gradient_spotcheck(jnp.asarray(eta), jnp.asarray(x), jnp.asarray(v), SPAN, ds,
                                 mask=jnp.asarray(mask), n_rays=64, metrics=jm)
    got = TC.gradient_spotcheck(torch.from_numpy(eta), torch.from_numpy(x),
                                torch.from_numpy(v), SPAN, ds, mask=torch.from_numpy(mask),
                                n_rays=64, metrics=tm)
    assert set(got) == set(want) == {"max_rel", "rel_l2", "cos"}
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
    assert got["max_rel"] < 1e-6 and abs(got["cos"] - 1) < 1e-9
    strip = [{k: v for k, v in row.items() if k not in ("time",)} for row in tm.history]
    assert [sorted(r) for r in strip] == [
        sorted(k for k in row if k != "time") for row in jm.history]


def test_stage_escalator_flips_the_mode_and_the_next_trace_runs_exact(probe_scene):
    eta, x, v, mask, ds = probe_scene
    tensors = tuple(map(torch.from_numpy, (x, v, mask)))
    holder, metrics = {"mode": None}, MetricsLogger()
    stage_fn = TC.make_stage_escalator(holder, SPAN, ds, lambda: tensors, metrics, n_rays=64)
    stage_fn(0, torch.from_numpy(eta))
    assert not metrics.history  # the first stage is covered by the startup check
    stage_fn(1, torch.from_numpy(eta))
    assert holder["mode"] is None and "grad_spotcheck_stage1_rel_l2" in metrics.last()
    strict = TC.make_stage_escalator(holder, SPAN, ds, lambda: tensors, metrics, tol=-1.0,
                                     n_rays=64)
    with pytest.warns(UserWarning, match="escalating"):
        strict(2, torch.from_numpy(eta))
    assert holder["mode"] == "exact" and metrics.last()["gradient_mode"] == "exact"
    n_rows = len(metrics.history)
    strict(3, torch.from_numpy(eta))  # already escalated: nothing more to do
    assert len(metrics.history) == n_rows
    n = torch.from_numpy(eta).requires_grad_(True)
    xt, vt = TC.make_trace(SPAN, ds, gradient=holder)(n, tensors[0], tensors[1])
    (xt ** 2 + xt * vt).sum().backward()
    ref = torch.from_numpy(eta).requires_grad_(True)
    xt_e, vt_e = TT.trace_exact(ref, tensors[0], tensors[1], SPAN / 4, ds)
    (xt_e ** 2 + xt_e * vt_e).sum().backward()
    assert torch.equal(xt, xt_e) and torch.equal(n.grad, ref.grad)
    assert float(n.grad.abs().max()) > 0


SLICE = dict(res_list=[3, 5], vol_span=SPAN, spp=1, nviews=2, nbins=8, optim_iters=2,
             lr=2e-3, fuel_val=0.05, grad_spotcheck=False, auto_exact=False, seed=0)


@pytest.fixture(scope="module")
def jax_slice():
    gt = JV.gaussian_bump(9, SPAN, 0.05, jnp.float64)
    eta, hist, _ = JF.run_opt(dict(JF.default_params(), dtype=jnp.float64, **SLICE), None, gt)
    return np.array(gt), np.asarray(eta), [float(v) for v in hist]


def test_run_opt_matches_the_jax_trainer(jax_slice):
    """The slice as a whole: same ground truth, same rays, 2 + 4 Adam steps over [3, 5]."""
    gt, want_eta, want_hist = jax_slice
    params = dict(TF.default_params(), dtype="float64", **SLICE)
    eta, hist, gt_out = TF.run_opt(params, None, torch.from_numpy(gt),
                                   rays=_torch_rays(_jax_rays(2, 8)), device="cpu")
    assert len(hist) == len(want_hist) == 6 and eta.shape == (5, 5, 5)
    assert hist[-1] < hist[0]
    np.testing.assert_allclose(hist, want_hist, rtol=1e-8, atol=0)
    _close(eta, want_eta, 1e-8)
    assert float(np.abs(want_eta - (1 + SLICE["fuel_val"])).max()) > 1e-4  # it moved
    assert torch.equal(gt_out, torch.from_numpy(gt))
    err = TF.reconstruction_error(eta, gt_out, background=1 + SLICE["fuel_val"])
    want_err = JF.reconstruction_error(jnp.asarray(want_eta), jnp.asarray(gt),
                                       background=1 + SLICE["fuel_val"])
    assert set(err) == set(want_err)
    for k in err:
        assert abs(err[k] - want_err[k]) <= 1e-7 * max(1.0, abs(want_err[k])), k


@pytest.mark.parametrize("source_type", ["planar", "point", "area"])
def test_run_opt_draws_its_own_rays_and_regularises(source_type):
    """Every source type, the TV prior, the spot check and the stage hook, on rays
    drawn from the port's own generator; the seed makes the run repeatable."""
    params = dict(TF.default_params(), res_list=[3, 5], nviews=2, nbins=4, optim_iters=1,
                  lr=1e-3, fuel_val=0.05, dtype=torch.float64, source_type=source_type,
                  sensor_distance=0.5, reg_weight=0.1)
    gt = TV.gaussian_bump(5, SPAN, 0.02, torch.float64, "cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        eta, hist, _ = TF.run_opt(params, None, gt, device="cpu")
        again = TF.run_opt(params, None, gt, device="cpu")
    assert len(hist) == 3 and all(np.isfinite(hist)) and hist == again[1]
    assert torch.equal(eta, again[0]) and eta.shape == (5, 5, 5)
    assert eta.min() >= 1.0 and eta.max() <= params["step_res"]
    rays, rpv = TF.gen_start_rays(params, torch.Generator().manual_seed(0), torch.float64)
    assert rpv == [16, 16] and rays.x.shape == (32, 3) and rays.x.dtype == torch.float64


def test_runner_runs_the_shipped_yaml(tmp_path):
    """``runner.run`` on the shipped file and the real volume, cut to one view of 4x4
    rays and one step at 3^3; writes metrics, checkpoint and plots."""
    out = tmp_path / "run"
    eta, hist, gt = TR.run(FUEL_YAML, None, str(out), device="cpu", overrides=dict(
        res_list=[3], nviews=1, nbins=4, optim_iters=1, record_iters=1, grad_spotcheck=False))
    assert gt.shape == (65, 65, 65) and gt.dtype == torch.float32 and eta.shape == (3, 3, 3)
    assert len(hist) == 1 and np.isfinite(hist[0])
    rows = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert rows == [{"step": 0, "time": rows[0]["time"], "exit_buckets": 0},
                    {"step": 0, "time": rows[1]["time"], "res": 3}]
    for name in ("result.npz", "loss_plot.png", "fuel_injection_0.png"):
        assert (out / name).stat().st_size > 0
    assert TR.main([FUEL_YAML, "--device", "cpu", "--set", "res_list=[3]", "--set", "nviews=1",
                    "--set", "nbins=2", "--set", "optim_iters=1",
                    "--set", "grad_spotcheck=false"])[0].shape == (3, 3, 3)


def test_what_this_slice_leaves_out_raises_and_names_its_roadmap_item():
    """The sharded variants, once left out, now build and run on the CPU (their
    results are held to the JAX functions by ``test_torch_parallel_variants.py``);
    an unknown experiment family still raises."""
    from adjointnonlinearraytracing_tpu_torch import parallel as TP

    mesh = TP.make_ray_mesh()
    rif = torch.ones((5, 5, 5), dtype=torch.float64)
    x = torch.tensor([[0.5, -0.1, 0.5], [0.4, -0.1, 0.6]], dtype=torch.float64)
    v = torch.tensor([[0.0, 1.0, 0.0], [0.1, 1.0, 0.0]], dtype=torch.float64)
    for exact in (False, True):
        args = {"plane": (x, v, x + 0.5, v), "target": (x, v, x + 2.0), "sdf": (rif - 2.0, x, v)}
        for name, rest in args.items():
            out = getattr(TP, f"make_sharded_trace_{name}")(mesh, 0.25, 0.125, 5, exact=exact)(
                rif, *rest)
            assert out[0].shape == (2, 3) and bool(torch.isfinite(out[0]).all())
        xt, vt, d2 = TP.make_sharded_trace_cable(mesh, 1.0, 2.0, 0.125, exact=exact)(
            torch.ones(5, dtype=torch.float64), x + 0.5, v, x + 1.0)
        assert xt.shape == (2, 3) and d2.shape == (2,)
    with pytest.raises(ValueError, match="unknown experiment family"):
        TR.run(FUEL_YAML, overrides=dict(family="nope"), device="cpu")


FUEL128_TINY = dict(res_list=[3], nviews=2, nbins=4, optim_iters=4, lr=2e-3, fuel_val=0.05,
                    grad_spotcheck=False, auto_exact=False)


def test_fuel128_runs_on_the_mesh_like_the_jax_trainer(monkeypatch):
    """``fuel-128`` (``mesh: true``, spp 4) through the runner's command line
    with tiny ``--set`` overrides, against the JAX runner with the same
    section and overrides on its 8 virtual devices (its cell-table stepper,
    which compiles faster); the port draws the JAX key's rays, the ground
    truth is the shipped volume on both sides, f64."""
    monkeypatch.setenv("ANRT_FAST_PATH", "classic")
    want_eta, want_hist, _ = JR.run(FUEL_YAML, "fuel-128",
                                    overrides=dict(FUEL128_TINY, dtype=jnp.float64))
    rays, rpv = JS.rand_rays_in_sphere(jax.random.PRNGKey(0), 2, (4, 4), 4, SPAN,
                                       angle_span=360, circle=False, xaxis=False, sensor_dist=0)
    assert rays.x.shape[0] == 128
    drawn = []

    def jax_rays(params, gen, dtype=torch.float32):
        assert params["mesh"] is True and params["spp"] == 4
        drawn.append(dtype)
        return _torch_rays(tuple(np.array(a) for a in rays)), rpv

    monkeypatch.setattr(TF, "gen_start_rays", jax_rays)
    sets = [f"{k}={json.dumps(v)}" for k, v in FUEL128_TINY.items()] + ["dtype=float64"]
    got_eta, got_hist, _ = TR.main([FUEL_YAML, "fuel-128", "--device", "cpu",
                                    *(a for kv in sets for a in ("--set", kv))])
    assert drawn == [torch.float64]
    assert len(got_hist) == len(want_hist) == 4
    np.testing.assert_allclose(got_hist, [float(h) for h in want_hist], rtol=1e-8, atol=0)
    _close(got_eta, np.asarray(want_eta), 1e-8)
    assert got_hist[-1] < got_hist[0]


def test_bucketed_exit_steps_run_through_the_runner(monkeypatch):
    """``ANRT_BUCKETED=2`` through the runner: the run equals the unbucketed one
    (the outputs are the same bit for bit; the gradient sums in another order);
    the run logs the buckets it took."""
    overrides = dict(res_list=[3], nviews=1, nbins=4, optim_iters=2, grad_spotcheck=False,
                     dtype="float64")
    m0, m2 = MetricsLogger(), MetricsLogger()
    monkeypatch.setenv("ANRT_BUCKETED", "0")
    eta0, hist0, _ = TR.run(FUEL_YAML, device="cpu", overrides=overrides, metrics=m0)
    monkeypatch.setenv("ANRT_BUCKETED", "2")
    eta2, hist2, _ = TR.run(FUEL_YAML, device="cpu", overrides=overrides, metrics=m2)
    assert [r["exit_buckets"] for r in m0.history if "exit_buckets" in r] == [0]
    assert [r["exit_buckets"] for r in m2.history if "exit_buckets" in r] == [2]
    assert len(hist2) == 2 and all(np.isfinite(hist2))
    np.testing.assert_allclose(hist2, hist0, rtol=1e-12, atol=0)
    _close(eta2, eta0.numpy(), 1e-12)


def test_step_timer_and_metrics_logger(tmp_path):
    timer = StepTimer(100)
    assert timer.rays_per_sec == 0.0
    for _ in range(2):
        with timer:
            pass
    assert timer.steps == 2 and timer.rays_per_sec > 0 and timer.sec_per_step >= 0
    path = tmp_path / "sub" / "m.jsonl"
    log = MetricsLogger(str(path))
    log.log(3, loss=torch.tensor(1.5), tag="a")
    MetricsLogger(str(path), append=True).log(4, loss=2)
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert [(r["step"], r["loss"]) for r in rows] == [(3, 1.5), (4, 2.0)] and rows[0]["tag"] == "a"
    assert log.last()["step"] == 3
