"""The port's image flagship (``experiments/image_flagship.py``) and single-view
control (``experiments/image_singleview.py``) against the JAX system's
repo-root scripts ``run_image_flagship.py`` and ``run_image_singleview.py``.

CPU, f64.  One JAX draw, ``rand_rays_in_sphere(PRNGKey(1234), 2, (16, 16), 2,
20, sensor_dist=0)`` (1,024 rays, two views), is handed to both sides: to the
port's functions through ``rays``, to the scripts by replacing the source
function their code looks up.  The optimisation each script starts
(``image.run_multiview_exp``, ``image.multires_exp``, held against the JAX
driver in test_torch_drivers.py) is replaced on both sides by one that
records its arguments and returns a fixed 5^3 field, so that what is held
here is each script's own part: its settings, the correlation and the report.
The scripts run in a temporary directory (``monkeypatch.chdir``), never in
``results/``.  On the JAX side the scripts' own forward trace, sensor splat
and draw run jitted, each compiled once for the module: eagerly JAX compiles
them op by op, ~15 s here.  Correlations agree to 1e-9; where the 128^2 targets enter, the port is handed
the JAX script's (the two packages' f32 normalisations differ by a few ulps,
held apart to 1e-6).
"""

import json
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import adjointnonlinearraytracing_tpu.tracer as JT
from adjointnonlinearraytracing_tpu import sensors as JSEN
from adjointnonlinearraytracing_tpu.experiments import image as JI
from adjointnonlinearraytracing_tpu.sources import sources as JS
from adjointnonlinearraytracing_tpu_torch.experiments import image as TI
from adjointnonlinearraytracing_tpu_torch.experiments import image_flagship as TIF
from adjointnonlinearraytracing_tpu_torch.experiments import image_singleview as TSV
from adjointnonlinearraytracing_tpu_torch.experiments import voxel_scenes as TV
from adjointnonlinearraytracing_tpu_torch.sources import sources as TS

ROOT = Path(__file__).resolve().parent.parent
JAX_RECORD = ROOT / "results" / "einstein_turing_r4" / "result.npz"
HIST = [0.25, 0.125, 0.0625]
SENSOR = jax.jit(JSEN.generate_sensor, static_argnums=(3,))
TRACE = jax.jit(JT.trace, static_argnums=(3, 4))
CORR_KEYS = ("corr_einstein", "corr_turing", "corr4x_einstein", "corr4x_turing")


@pytest.fixture(scope="module")
def draw():
    """The JAX draw (numpy arrays) and a 5^3 field near 1 (numpy, f64)."""
    rays = jax.jit(lambda key: JS.rand_rays_in_sphere(key, 2, (16, 16), 2, 20,
                                                      sensor_dist=0)[0])(
        jax.random.PRNGKey(1234))
    eta = 1.0 + 0.02 * np.random.default_rng(0).random((5, 5, 5))
    return tuple(np.asarray(a) for a in rays), eta


def _trays(arrays, view=None):
    rows = slice(None) if view is None else slice(512 * view, 512 * (view + 1))
    return TS.Rays(*(torch.from_numpy(a[rows]) for a in arrays))


@pytest.fixture
def jax_side(monkeypatch, draw):
    """The scripts importable; their draw fixed, their trace and splat jitted."""
    arrays, _ = draw
    monkeypatch.syspath_prepend(str(ROOT))

    def fixed_draw(key, nviews, *args, **kwargs):
        n = 512 * nviews
        return JS.Rays(*(jnp.asarray(a[:n]) for a in arrays)), [512] * nviews

    monkeypatch.setattr(JT, "trace", TRACE)
    monkeypatch.setattr(JSEN, "generate_sensor", SENSOR)
    monkeypatch.setattr(JS, "rand_rays_in_sphere", fixed_draw)
    return arrays


def test_target_correlation_matches_the_jax_function(jax_side, draw):
    """``target_correlation`` at 16^2 x 2 spp on the JAX draw, whole and pooled."""
    sys.modules.pop("run_image_flagship", None)
    import run_image_flagship as JF
    arrays, eta = draw
    want = JF.target_correlation(jnp.asarray(eta), resolution=16, spp=2, seed=1234)
    got = TIF.target_correlation(torch.from_numpy(eta), resolution=16, rays=_trays(arrays),
                                 device="cpu")
    sys.modules.pop("run_image_flagship", None)
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=0, atol=1e-9)
    assert all(abs(c) > 1e-3 for c in got[0] + got[1])


def _jax_target(name, resolution, device="cuda"):
    return torch.from_numpy(np.asarray(JS.sum_norm(JI.load_image(TV.data_path(name),
                                                                   resolution))))


@pytest.fixture
def jax_targets(monkeypatch):
    """The targets as the JAX scripts load them, for the port's reports: the
    two packages' f32 sums of a 128^2 image differ by a few ulps, so their
    mean-normalised targets differ by 2.7e-7 relative, which moves a pooled
    correlation near 0 by ~1e-8 (held apart in
    test_targets_are_the_scripts_to_f32_rounding)."""
    monkeypatch.setattr(TIF, "load_target", _jax_target)
    monkeypatch.setattr(TSV, "load_target", _jax_target)


def test_targets_are_the_scripts_to_f32_rounding():
    for name in TIF.TARGETS:
        got = TIF.load_target(name, 128, "cpu")
        want = _jax_target(name, 128)
        assert got.dtype == want.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=0)


def _recorder(calls, eta, dtype):
    def fake(*args, **kwargs):
        calls.append((args, kwargs))
        return (jnp.asarray(eta) if dtype == "jax" else torch.from_numpy(eta)), list(HIST)
    return fake


def _report(path):
    with open(path) as f:
        return json.load(f)


def _same_report(got, want):
    for key in CORR_KEYS + ("first_loss", "last_loss", "n_iters", "stage_res"):
        if key in want:
            assert abs(got[key] - want[key]) <= 1e-9, key


ENV = dict(IMG_RES_LIST="3,5", IMG_ITERS="7", IMG_RECORD="3", IMG_PVNORM="0", IMG_PYRAMID="2")


@pytest.mark.parametrize("resume", [False, True])
def test_flagship_main_matches_the_script(jax_side, jax_targets, draw, monkeypatch, tmp_path,
                                         resume):
    """The script's ``__main__`` (through ``runpy``) and the port's ``main`` with
    the same variables: the keywords handed to ``run_multiview_exp`` (with
    ``--resume``, the checkpoint to resume from) and the report."""
    arrays, eta = draw
    jcalls, tcalls = [], []
    monkeypatch.setattr(JI, "run_multiview_exp", _recorder(jcalls, eta, "jax"))
    monkeypatch.setattr(TI, "run_multiview_exp", _recorder(tcalls, eta, "torch"))
    monkeypatch.setattr(TIF, "correlation_rays", lambda *a: _trays(arrays))
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
        if resume:
            (tmp_path / side / "result.npz").write_bytes(b"")
    monkeypatch.chdir(tmp_path)
    argv = ["--resume"] if resume else []
    for key, value in dict(ENV, IMG_DIR="jax").items():
        monkeypatch.setenv(key, value)
    monkeypatch.setattr(sys, "argv", ["run_image_flagship.py"] + argv)
    runpy.run_path(str(ROOT / "run_image_flagship.py"), run_name="__main__")
    got = TIF.main(argv, dict(ENV, IMG_DIR="port"), device="cpu")
    ((jargs, jkw),), ((targs, tkw),) = jcalls, tcalls
    assert jargs == targs == ()
    assert tkw.pop("device") == "cpu"
    assert {tkw.pop(k) for k in ("stat_fn", "metrics", "sample_rays")} == {None}
    assert tkw.pop("result_dir") == "port" and jkw.pop("result_dir") == "jax"
    want_resume = jkw.pop("resume_from")
    assert tkw.pop("resume_from") == (want_resume and want_resume.replace("jax", "port"))
    assert (want_resume is not None) == resume
    assert tkw == jkw and jkw["res_list"] == [3, 5] and jkw["pyramid_levels"] == 2
    assert jkw["per_view_norm"] is False and jkw["optim_iters"] == 7
    want = _report(tmp_path / "jax" / "report.json")
    assert _report(tmp_path / "port" / "report.json") == got
    _same_report(got, want)
    assert got["card"] is None and set(got) == set(want) | {"card"}


def test_flagship_report_only_scores_a_jax_checkpoint(jax_side, jax_targets, draw, monkeypatch,
                                                      tmp_path):
    """``--report-only`` on a JAX-written ``result.npz``: the script's report and
    the port's, from its own directory and through ``--checkpoint``."""
    arrays, eta = draw
    monkeypatch.setattr(TIF, "correlation_rays", lambda *a: _trays(arrays))
    (tmp_path / "jax").mkdir()
    np.savez(tmp_path / "jax" / "result.npz", rif=eta, adam_count=np.int32(9),
             adam_mu=np.zeros_like(eta), adam_nu=np.zeros_like(eta),
             loss_hist=np.asarray(HIST), key=np.asarray([0, 7], dtype=np.uint32))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("IMG_DIR", "jax")
    monkeypatch.setattr(sys, "argv", ["run_image_flagship.py", "--report-only"])
    with pytest.raises(SystemExit) as done:
        runpy.run_path(str(ROOT / "run_image_flagship.py"), run_name="__main__")
    assert done.value.code == 0
    want = _report(tmp_path / "jax" / "report.json")
    got = TIF.main(["--report-only", "--checkpoint", "jax/result.npz"],
                   dict(IMG_DIR="port"), device="cpu")
    _same_report(got, want)
    assert _report(tmp_path / "port" / "report.json") == got
    assert got["n_iters"] == 3 and got["stage_res"] == 5


def test_the_jax_record_loads_as_a_field():
    """The tracked JAX record's checkpoint, the field ``--report-only`` scores."""
    eta, hist = TIF.load_field(str(JAX_RECORD), device="cpu")
    assert eta.shape == (129, 129, 129) and eta.dtype == torch.float32 and len(hist) == 1120
    assert float(eta.min()) >= 1.0 and TIF.Settings().result_dir.endswith("_torch")


def test_singleview_matches_the_script(jax_side, jax_targets, draw, monkeypatch, tmp_path):
    """``run_image_singleview.main`` and the port's ``run`` with the same
    variables: the parameters handed to ``multires_exp`` (the target image
    bitwise) and the report, on one view of the draw."""
    arrays, eta = draw
    jcalls, tcalls = [], []
    monkeypatch.setattr(JI, "multires_exp", _recorder(jcalls, eta, "jax"))
    monkeypatch.setattr(TI, "multires_exp", _recorder(tcalls, eta, "torch"))
    monkeypatch.chdir(tmp_path)
    env = dict(SV_RES_LIST="3,5", SV_ITERS="4")
    (tmp_path / "jax").mkdir()
    for key, value in dict(env, SV_DIR="jax").items():
        monkeypatch.setenv(key, value)
    sys.modules.pop("run_image_singleview", None)
    import run_image_singleview as JSV
    JSV.main()
    sys.modules.pop("run_image_singleview", None)
    settings = TSV.Settings.from_env(dict(env, SV_DIR="port"))
    _, _, got = TSV.run(settings, device="cpu", rays=_trays(arrays, view=0))
    ((jargs, _),), ((targs, tkw),) = jcalls, tcalls
    (jp, jdir), (tp, tdir) = jargs, targs
    assert (jdir, tdir) == ("jax", "port") and tkw["device"].type == "cpu"
    np.testing.assert_array_equal(tp.pop("disp_ims")[0].numpy(), np.asarray(jp.pop("disp_ims")[0]))
    assert tp == jp and jp["res_list"] == [3, 5] and jp["optim_iters"] == 4
    want = _report(tmp_path / "jax" / "report.json")
    assert abs(got["corr_einstein_single_view"] - want["corr_einstein_single_view"]) <= 1e-9
    _same_report(got, want)
    assert _report(tmp_path / "port" / "report.json") == got
    assert TSV.Settings().result_dir.endswith("_torch")


def test_entry_points_need_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the GPU-less behaviour")
    eta = torch.ones((3, 3, 3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TIF.target_correlation(eta)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSV.run(TSV.Settings(result_dir="unused"))


def test_figures_are_skipped_without_matplotlib(monkeypatch, tmp_path):
    """The drivers' figures are side products: without matplotlib the plotting
    functions warn and write nothing, so a run's numbers and files stand."""
    from adjointnonlinearraytracing_tpu_torch.utils import plotting
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # its import now raises
    out = tmp_path / "loss.png"
    with pytest.warns(UserWarning, match="matplotlib is not installed"):
        plotting.save_loss_plot([1.0, 0.5], str(out))
    with pytest.warns(UserWarning, match="matplotlib is not installed"):
        plotting.save_profile_plot(np.ones(3), np.zeros(3), str(out))
    with pytest.warns(UserWarning, match="matplotlib is not installed"):
        plotting.save_multiple_images([np.ones((2, 2))], str(out))
    assert not out.exists()
