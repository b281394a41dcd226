"""The port's fiber ladder (``experiments/fiber_ladder.py``) against the JAX
system's repo-root script ``run_fiber_ladder.py``, which acts at import and
is run here through ``runpy`` with its variables set, in a temporary
directory (``monkeypatch.chdir``), never in ``results/``.

CPU, f64.  Both packages' ``fiber.default_params`` are cut to ``res_list
[3, 5]``, ``nbins`` 8, f64, spot checks off (the driver is held with them in
test_torch_fiber.py), and both drivers get the same rays at every draw: on
the JAX side by replacing the source function the driver looks up, on the
port's through ``sample_rays``.  The phases, their parameters and the
report must come out as the script's: losses and L1 distances within 1e-8
relative, the profiles within 1e-8 of their largest magnitude.  The L1 of the
JAX record's refined profile (``results/fiber_129_refine/profile_refine0.npy``,
f32) equals the script's ``l1_to_gt`` to f32 rounding and its record within
1e-6.
"""

import json
import runpy
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adjointnonlinearraytracing_tpu.experiments import fiber as JF
from adjointnonlinearraytracing_tpu.sources import sources as JS
from adjointnonlinearraytracing_tpu_torch.experiments import fiber as TF
from adjointnonlinearraytracing_tpu_torch.experiments import fiber_ladder as TFL
from adjointnonlinearraytracing_tpu_torch.sources import sources as TS

ROOT = Path(__file__).resolve().parent.parent
RECORD = ROOT / "results" / "fiber_129_refine"
SMALL = dict(res_list=[3, 5], nbins=8, grad_spotcheck=False, auto_exact=False)


@pytest.fixture(scope="module")
def rays():
    drawn = TF.gen_start_rays(dict(TF.default_params(), **SMALL),
                              torch.Generator().manual_seed(0), torch.float64)
    return tuple(t.numpy() for t in drawn)


@pytest.fixture
def small(monkeypatch, rays):
    """Both drivers cut to the small size, on ``rays`` at every draw; returns
    the port's ``sample_rays``."""
    jdefaults, tdefaults = JF.default_params, TF.default_params
    monkeypatch.setattr(JF, "default_params",
                        lambda: dict(jdefaults(), **SMALL, dtype=jnp.float64))
    monkeypatch.setattr(TF, "default_params", lambda: dict(tdefaults(), **SMALL, dtype="float64"))
    monkeypatch.setattr(JS, "plane_source3_rand",
                        lambda *a, **k: JS.Rays(*(jnp.asarray(t) for t in rays)))
    return lambda gen, samples: TS.Rays(*(torch.from_numpy(t) for t in rays))


def _run_script(monkeypatch, env):
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    return runpy.run_path(str(ROOT / "run_fiber_ladder.py"), run_name="__main__")


def _same_phases(got, want):
    assert [p["phase"] for p in got["phases"]] == [p["phase"] for p in want["phases"]]
    for g, w in zip(got["phases"], want["phases"]):
        assert set(g) == set(w), w["phase"]
        for key, value in w.items():
            if isinstance(value, float):
                assert abs(g[key] - value) <= 1e-8 * abs(value), (w["phase"], key)
            else:
                assert g[key] == value, (w["phase"], key)


def test_ladder_and_refinement_match_the_script(small, monkeypatch, tmp_path):
    """The ladder (2 steps a stage, spp 1) and a refinement phase."""
    env = dict(FIBER_ITERS="2", FIBER_SPP="1", FIBER_REFINE="1e-3:3:2")
    monkeypatch.chdir(tmp_path)
    _run_script(monkeypatch, dict(env, FIBER_DIR="jax"))
    want = json.loads((tmp_path / "jax" / "report.json").read_text())
    settings = TFL.Settings.from_env(dict(env, FIBER_DIR="port"))
    assert settings.refine == ((1e-3, 3, 2),) and settings.init is None
    phases = []
    n, got = TFL.run(settings, device="cpu", sample_rays=small,
                     on_phase=lambda phase, params: phases.append(params))
    assert json.loads((tmp_path / "port" / "report.json").read_text()) == got
    _same_phases(got, want)
    assert got["bins"] == want["bins"] == 5
    assert abs(got["l1_vs_gt"] - want["l1_vs_gt"]) <= 1e-8 * want["l1_vs_gt"]
    for name in ("profile_refine0.npy", "final_profile.npy"):
        w = np.load(tmp_path / "jax" / name)
        np.testing.assert_allclose(np.load(tmp_path / "port" / name), w, rtol=0,
                                   atol=1e-8 * np.abs(w).max())
    np.testing.assert_array_equal(n.numpy(), np.load(tmp_path / "port" / "final_profile.npy"))
    assert [p["optim_iters"] for p in phases] == [2, 3] and phases[1]["seed"] == 100
    assert all(p["record_iters"] == 10 ** 9 for p in phases)
    assert (tmp_path / "port" / "refine0" / "result.npz").exists()


def _f32_equal(got, want):
    """Equal to f32 rounding of a 129-term mean: JAX's f32 sum of the record's
    profile reads 2 ulps above the exactly rounded mean, which the port's is."""
    return abs(got - want) <= 4 * np.spacing(np.float32(want))


def test_init_from_the_jax_record(small, monkeypatch, tmp_path):
    """``FIBER_INIT`` on the JAX record's refined profile (129 bins, f32): the
    ``init`` phase's L1 is the script's and the record's; each refinement run
    (its optimisation replaced on both sides by one that records its
    parameters and returns its start profile) starts from the last profile
    with the script's parameters and seed."""
    init = str(RECORD / "profile_refine0.npy")
    env = dict(FIBER_INIT=init, FIBER_REFINE="1e-5:1200:2,3e-6:1200:4")
    jcalls, tcalls = [], []

    def recorder(calls, kind):
        def fake(params, result_dir=None, **kwargs):
            calls.append((dict(params), result_dir))
            n = params["init_profile"]
            return (jnp.asarray(n) if kind == "jax" else n.clone()), [6.25]
        return fake

    monkeypatch.setattr(JF, "multires_exp", recorder(jcalls, "jax"))
    monkeypatch.setattr(TF, "multires_exp", recorder(tcalls, "torch"))
    monkeypatch.chdir(tmp_path)
    _run_script(monkeypatch, dict(env, FIBER_DIR="jax"))
    want = json.loads((tmp_path / "jax" / "report.json").read_text())
    _, got = TFL.run(TFL.Settings.from_env(dict(env, FIBER_DIR="port")), device="cpu")
    record = json.loads((RECORD / "report.json").read_text())["phases"][1]["l1_vs_gt"]
    assert got["phases"][0]["init"] == init and got["bins"] == 129
    for g, w in zip(got["phases"], want["phases"]):
        assert _f32_equal(g.pop("l1_vs_gt"), w.pop("l1_vs_gt")) and g == w
    assert abs(TFL.l1_to_gt(torch.from_numpy(np.load(init))) - record) <= 1e-6 * record
    assert [d for _, d in tcalls] == ["port/refine0", "port/refine1"]
    for (jp, _), (tp, _) in zip(jcalls, tcalls):
        np.testing.assert_array_equal(tp.pop("init_profile").numpy(),
                                      np.asarray(jp.pop("init_profile")))
        assert tp == dict(jp, dtype="float64")
    assert [p["seed"] for p, _ in tcalls] == [100, 101]
    assert [p["res_list"] for p, _ in tcalls] == [[129], [129]]


def test_settings_profiles_and_nan(tmp_path):
    """The script's defaults and parser; a profile from a ``.npy`` or a fiber
    ``result.npz``; a NaN profile's L1 is NaN (a phase keeps it)."""
    s = TFL.Settings.from_env({})
    assert s == TFL.Settings() and s.result_dir == "results/fiber_129_torch"
    assert (s.iters, s.spp, s.refine) == (100, 2, ((2e-3, 600, 2), (5e-4, 600, 4),
                                                   (1e-4, 800, 4)))
    prof = np.linspace(1.4, 1.0, 9)
    np.save(tmp_path / "p.npy", prof)
    np.savez(tmp_path / "result.npz", rif=prof, loss_hist=np.zeros(2))
    for path in ("p.npy", "result.npz"):
        got = TFL.load_profile(str(tmp_path / path), device="cpu", dtype=torch.float64)
        np.testing.assert_array_equal(got.numpy(), prof)
    assert TFL.l1_to_gt(torch.from_numpy(prof)) > 0
    assert np.isnan(TFL.l1_to_gt(torch.full((5,), float("nan"))))
    if not torch.cuda.is_available():  # the entry point needs a GPU unless asked for the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TFL.run(TFL.Settings(result_dir=str(tmp_path / "unused")))



def test_a_nonfinite_gradient_step_is_taken(small, rays, tmp_path):
    """A step whose gradient is not finite (here: its rays are NaN, which the
    loss masks out, so its loss stays finite) is taken, as the JAX driver
    takes it: the profile turns NaN, and so does the phase's L1 in the
    ladder's report."""
    draws = []

    def sample(gen, samples):
        draws.append(1)
        arrays = [t.copy() for t in rays]
        if len(draws) == 2:
            arrays[0][:] = np.nan
        return TS.Rays(*(torch.from_numpy(t) for t in arrays))

    params = dict(TF.default_params(), res_list=[5], optim_iters=3)
    n, hist = TF.multires_exp(params, device="cpu", sample_rays=sample)
    assert len(hist) == 3 and np.isfinite(hist[:2]).all()
    assert bool(torch.isnan(n).any())
    draws.clear()
    _, report = TFL.run(TFL.Settings(result_dir=str(tmp_path), iters=3, refine=()),
                        device="cpu", sample_rays=sample)
    assert np.isnan(report["l1_vs_gt"]) and np.isnan(report["phases"][0]["l1_vs_gt"])
