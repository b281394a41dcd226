"""The port's GRIN-fiber driver against the JAX package's, the runner's fiber
family, and carrying a JAX-written profile into the port.

CPU, f64 (conftest enables x64).  The rays are made once with a seeded
generator and handed to both drivers: on the JAX side by replacing the source
function the driver looks up on its ``sources`` module, on the port's side
through the ``sample_rays`` hook.  Each run is the shipped ``default`` section
at ``res_list [3, 5]``, ``nbins`` 8 (64 rays, 52 live), ``optim_iters`` 2 (6
Adam steps); loss history and final profile must agree to ``1e-8``
(relative to the largest magnitude), as the other drivers are held.
"""

import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adjointnonlinearraytracing_tpu.experiments import fiber as JF
from adjointnonlinearraytracing_tpu.sources import sources as JS
from adjointnonlinearraytracing_tpu_torch import convert
from adjointnonlinearraytracing_tpu_torch.experiments import fiber as TF
from adjointnonlinearraytracing_tpu_torch.experiments import runner as TR
from adjointnonlinearraytracing_tpu_torch.sources import sources as TS
from adjointnonlinearraytracing_tpu_torch.utils.metrics import MetricsLogger

ROOT = Path(__file__).resolve().parent.parent
FIBER_YAML = str(ROOT / "configs" / "params-fiber.yaml")
TINY = dict(res_list=[3, 5], nbins=8, optim_iters=2, record_iters=10 ** 9)


def _close(got, want, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(1.0, np.abs(want).max()))


@pytest.fixture(scope="module")
def params():
    return dict(TR.cfg.load_params(FIBER_YAML), **TINY)


@pytest.fixture(scope="module")
def rays(params):
    """One draw of the driver's own source (planar, cropped to the disk) in f64."""
    drawn = TF.gen_start_rays(params, torch.Generator().manual_seed(0), torch.float64)
    return tuple(t.numpy() for t in drawn)


@pytest.fixture
def same_rays(monkeypatch, rays):
    """Both drivers get ``rays`` at every draw."""
    monkeypatch.setattr(JS, "plane_source3_rand",
                        lambda *a, **k: JS.Rays(*(jnp.asarray(t) for t in rays)))
    return lambda gen, samples: TS.Rays(*(torch.from_numpy(t) for t in rays))


def _same_run(got, want, steps=6, res=5):
    (n, hist), (want_n, want_hist) = got, want
    want_hist = [float(h) for h in want_hist]
    assert len(hist) == len(want_hist) == steps and n.shape == (res,)
    assert all(np.isfinite(hist))
    np.testing.assert_allclose(hist, want_hist, rtol=1e-8, atol=0)
    _close(n, np.asarray(want_n), 1e-8)


def test_the_rays_and_the_defaults(params, rays):
    x, v, planes, mask = rays
    assert x.shape == (64, 3) and 40 < mask.sum() < 64  # cropped to the disk
    assert TF.default_params() == JF.default_params()
    _close(TF.ground_truth(129, torch.float64, "cpu"), JF.ground_truth(129, jnp.float64), 1e-15)


def test_fiber_matches_the_jax_driver(params, same_rays):
    """The adjoint gradient at both stages (spot checks off)."""
    p = dict(params, grad_spotcheck=False, auto_exact=False)
    want = JF.multires_exp(dict(p, dtype=jnp.float64))
    got = TF.multires_exp(dict(p, dtype="float64"), device="cpu", sample_rays=same_rays)
    _same_run(got, want)
    assert float(np.abs(np.asarray(want[0]) - 1.0).max()) > 1e-6  # the profile moved


def test_fiber_escalates_at_stage_1_like_the_jax_driver(params, same_rays, monkeypatch):
    """The escalation tolerance is below any drift, so both drivers switch to
    the exact gradient at stage 1; the start-up check (the adjoint against
    the tape) runs too and agrees to rounding in f64."""
    monkeypatch.setenv("ANRT_EXACT_TOL", "-1")
    tm = MetricsLogger()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        want = JF.multires_exp(dict(params, dtype=jnp.float64))
        got = TF.multires_exp(dict(params, dtype="float64"), device="cpu", metrics=tm,
                              sample_rays=same_rays)
    escalations = [str(w.message)[:22] for w in caught if "escalating" in str(w.message)]
    assert escalations == ["fiber stage 1 (5 bins)"] * 2  # the JAX driver's, then the port's
    rows = {k: r[k] for r in tm.history for k in r if k.startswith(("grad", "gradient"))}
    assert rows["gradient_escalated_stage"] == 1 and rows["gradient_mode"] == "exact"
    assert 0 <= rows["grad_spotcheck"] < 1e-8
    assert rows["grad_spotcheck_stage1_rel_l2"] < 1e-8  # f64: adjoint and exact agree
    _same_run(got, want)


def test_fiber_exact_gradient_for_a_whole_run(params, same_rays):
    p = dict(params, grad_spotcheck=False, gradient="exact")
    want = JF.multires_exp(dict(p, dtype=jnp.float64))
    got = TF.multires_exp(dict(p, dtype="float64"), device="cpu", sample_rays=same_rays)
    _same_run(got, want)


def test_init_profile_from_a_jax_result(params, same_rays, tmp_path):
    """A profile written by the JAX driver (``result.npz``) starts the port's run
    through ``convert.profile_from_numpy``, as the same array starts the JAX
    driver's."""
    prof = np.array([1.4, 1.38, 1.3, 1.2, 1.0])
    np.savez(tmp_path / "result.npz", rif=prof, loss_hist=np.zeros(3))
    init = convert.profile_from_numpy(str(tmp_path / "result.npz"), "cpu", torch.float64)
    assert init.dtype == torch.float64 and torch.equal(init, torch.from_numpy(prof))
    assert torch.equal(convert.profile_from_numpy(prof, "cpu", torch.float64), init)
    p = dict(params, res_list=[5], optim_iters=1, grad_spotcheck=False, auto_exact=False)
    out = tmp_path / "jax"
    want = JF.multires_exp(dict(p, dtype=jnp.float64, init_profile=prof), str(out))
    # the JAX run's own result.npz holds its final profile under the same name
    _close(convert.profile_from_numpy(str(out / "result.npz"), "cpu", torch.float64),
           np.asarray(want[0]), 0.0)
    got = TF.multires_exp(dict(p, dtype="float64", init_profile=str(tmp_path / "result.npz")),
                          device="cpu", sample_rays=same_rays)
    _same_run(got, want, steps=1)
    with pytest.raises(ValueError, match="bins"):
        TF.multires_exp(dict(p, init_profile=prof[:3]), device="cpu", sample_rays=same_rays)


def test_runner_dispatches_the_fiber_yaml(tmp_path):
    """The shipped section through the command line on the CPU, cut to one step
    at 3 bins and 4 x 4 rays; the files written where asked."""
    out = tmp_path / "run"
    n, hist = TR.main([FIBER_YAML, "--device", "cpu", "--result-dir", str(out),
                       "--set", "res_list=[3]", "--set", "nbins=4", "--set", "optim_iters=1",
                       "--set", "grad_spotcheck=false"])
    assert n.shape == (3,) and n.dtype == torch.float32 and n.device.type == "cpu"
    assert len(hist) == 1 and np.isfinite(hist[0])
    for name in ("result.npz", "metrics.jsonl", "loss_plot.png", "fiber_profile_0.png"):
        assert (out / name).stat().st_size > 0
    with np.load(out / "result.npz") as f:
        assert set(f.files) == {"rif", "loss_hist"} and f["rif"].shape == (3,)


def test_fiber_entry_points_need_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the GPU-less behaviour")
    tiny = dict(TF.default_params(), res_list=[3], nbins=2, optim_iters=1)
    for call in (lambda: TF.multires_exp(tiny),
                 lambda: TF.ground_truth(5),
                 lambda: TR.run(FIBER_YAML),
                 lambda: convert.profile_from_numpy([1.0, 1.0, 1.0])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
