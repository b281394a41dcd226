"""The Luneburg, image (einstein-turing and sdf) and focal-stack drivers of the
port against the JAX package's, the runner's dispatch of their shipped YAMLs,
and the gradient spot check's yardstick.

CPU, f64 (conftest enables x64).  The rays are made once with numpy seeds and
handed to both drivers: on the JAX side by replacing the source functions the
driver looks up on its ``sources`` module, on the port's side through the
``sample_rays`` hook.  Each run is ``res_list [3, 5]``, ``nbins`` 8, ``spp``
1 and 3 iterations a stage (9 Adam steps); loss history and final field must
agree to ``1e-8`` (relative to the largest magnitude), as the fuel trainer is
held.  Only the Luneburg run escalates to the exact gradient (its tolerance
forced below any drift), so that JAX compiles the exact path once.
"""

import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adjointnonlinearraytracing_tpu.experiments import common as JC
from adjointnonlinearraytracing_tpu.experiments import focalstack as JFS
from adjointnonlinearraytracing_tpu.experiments import image as JI
from adjointnonlinearraytracing_tpu.experiments import luneburg as JL
from adjointnonlinearraytracing_tpu.experiments import runner as JRUN
from adjointnonlinearraytracing_tpu.sources import sources as JS
from adjointnonlinearraytracing_tpu_torch.experiments import common as TC
from adjointnonlinearraytracing_tpu_torch.experiments import focalstack as TFS
from adjointnonlinearraytracing_tpu_torch.experiments import image as TI
from adjointnonlinearraytracing_tpu_torch.experiments import luneburg as TL
from adjointnonlinearraytracing_tpu_torch.experiments import runner as TR
from adjointnonlinearraytracing_tpu_torch.experiments import voxel_scenes as TV
from adjointnonlinearraytracing_tpu_torch.sources import sources as TS
from adjointnonlinearraytracing_tpu_torch.tracer import api as TAPI
from adjointnonlinearraytracing_tpu_torch.tracer import checkpointed as TCK
from adjointnonlinearraytracing_tpu_torch.utils.metrics import MetricsLogger

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = ROOT / "configs"
TINY = dict(res_list=[3, 5], nbins=8, spp=1, optim_iters=3, record_iters=10 ** 9)


def _close(got, want, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(1.0, np.abs(want).max()))


def _arrays(rays: TS.Rays):
    return tuple(t.numpy() for t in rays)


def _jrays(arrays):
    return JS.Rays(*(jnp.asarray(a) for a in arrays))


def _hook(arrays):
    """The port's ``sample_rays``: the same rays at every draw."""
    return lambda gen, samples: TS.Rays(*(torch.from_numpy(a) for a in arrays))


def _same_run(got, want):
    (eta, hist), (want_eta, want_hist) = got, want
    want_hist = [float(h) for h in want_hist]
    assert len(hist) == len(want_hist) == 9 and eta.shape == (5, 5, 5)
    assert all(np.isfinite(hist))
    np.testing.assert_allclose(hist, want_hist, rtol=1e-8, atol=0)
    _close(eta, np.asarray(want_eta), 1e-8)
    assert float(np.abs(np.asarray(want_eta) - 1.0).max()) > 1e-6  # the field moved


@pytest.fixture
def plain_jax_trace(monkeypatch):
    """The JAX package's plain tracer, as the port's make_trace runs (no
    exit-step bucketing), with its cell-table stepper, which compiles faster
    and which its own tests hold equal to the paired one."""
    monkeypatch.setenv("ANRT_BUCKETED", "0")
    monkeypatch.setenv("ANRT_FAST_PATH", "classic")


@pytest.fixture(scope="module")
def cube_rays():
    """Luneburg's rays at the tiny size: six faces of 8 x 8, cropped to the
    disk and turned about the centre of a volume of side 20."""
    gen = torch.Generator().manual_seed(0)
    rays, rpv = TS.rand_rays_cube(gen, (8, 8), 1, 20.0, circle=True, dtype=torch.float64)
    turned = TS.random_rotate_ic(gen, rays.x, rays.v, rays.planes, 20.0)
    assert rpv == [64] * 6
    return _arrays(TS.Rays(*turned, rays.mask)), rpv


def test_luneburg_matches_the_jax_driver_and_escalates_like_it(plain_jax_trace, monkeypatch,
                                                              cube_rays):
    """The escalation tolerance is below any drift, so both drivers switch to
    the exact gradient at stage 1 (the start-up check is off: it would only
    compile the JAX spot check a second time)."""
    monkeypatch.setenv("ANRT_EXACT_TOL", "-1")
    arrays, rpv = cube_rays
    assert 0 < arrays[3].sum() < 384
    monkeypatch.setattr(JS, "rand_rays_cube", lambda *a, **k: (_jrays(arrays), rpv))
    monkeypatch.setattr(JS, "random_rotate_ic", lambda key, x, v, planes, span: (x, v, planes))
    params = dict(TL.default_params(), **TINY, grad_spotcheck=False)
    assert TL.default_params() == JL.default_params()
    tm = MetricsLogger()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        want = JL.run_opt(dict(params, dtype=jnp.float64))
        got = TL.run_opt(dict(params, dtype="float64"), device="cpu", metrics=tm,
                         sample_rays=_hook(arrays))
    escalations = [str(w.message)[:9] for w in caught if "escalating" in str(w.message)]
    assert escalations == ["stage 1 (", "stage 1 ("]  # the JAX driver's, then the port's
    assert [r["gradient_escalated_stage"] for r in tm.history if "gradient_mode" in r] == [1]
    _same_run(got, want)


def _planar_rays(nviews, sensor_dist, seed=1):
    rays, rpv = TS.rand_rays_in_sphere(torch.Generator().manual_seed(seed), nviews, (8, 8), 1,
                                       20.0, sensor_dist=sensor_dist, dtype=torch.float64)
    return _arrays(rays), rpv


def test_image_einstein_turing_matches_the_jax_driver(plain_jax_trace, monkeypatch):
    """Two views matched against the two portraits (with the pyramid and the
    per-view scale on, so the options run too)."""
    arrays, rpv = _planar_rays(2, 0)
    monkeypatch.setattr(JS, "rand_rays_in_sphere", lambda *a, **k: (_jrays(arrays), rpv))
    ims = [TS.sum_norm(TI.load_image(TV.data_path(n), 8, torch.float64, "cpu")).numpy()
           for n in ("einstein.png", "turing.png")]
    np.testing.assert_array_equal(
        ims[0], np.asarray(JS.sum_norm(JI.load_image(TV.data_path("einstein.png"), 8,
                                                     jnp.float64))))
    params = dict(TR.cfg.load_params(str(CONFIGS / "params-image.yaml"), "einstein-turing"),
                  **TINY, grad_spotcheck=False, auto_exact=False, per_view_norm=True,
                  pyramid_levels=2)
    want = JI.multires_exp(dict(params, dtype=jnp.float64, disp_ims=list(map(jnp.asarray, ims))))
    got = TI.multires_exp(dict(params, dtype="float64", disp_ims=list(map(torch.from_numpy, ims))),
                          device="cpu", sample_rays=_hook(arrays))
    _same_run(got, want)


def test_sdf_matches_the_jax_driver(plain_jax_trace, monkeypatch):
    """One view scored on the l2ball distance textures, near and far."""
    arrays, rpv = _planar_rays(1, 20)
    monkeypatch.setattr(JS, "rand_rays_in_sphere", lambda *a, **k: (_jrays(arrays), rpv))
    disp = TR.l2ball_sdf(8, 20.0, dtype=torch.float64, device="cpu")
    defl = TR.l2ball_sdf(8, 2 * float(np.sin(0.5 * np.deg2rad(90))), dtype=torch.float64,
                         device="cpu")
    _close(disp, JRUN.l2ball_sdf(8, 20.0, dtype=jnp.float64), 1e-12)
    params = dict(TR.cfg.load_params(str(CONFIGS / "params-sdf.yaml")), **TINY,
                  grad_spotcheck=False, auto_exact=False, disp_ims=[None], defl_ims=[None])
    want = JI.multires_exp(dict(params, dtype=jnp.float64, sdf_disp=[jnp.asarray(disp.numpy())],
                                sdf_defl=[jnp.asarray(defl.numpy())]))
    got = TI.multires_exp(dict(params, dtype="float64", sdf_disp=[disp], sdf_defl=[defl]),
                          device="cpu", sample_rays=_hook(arrays))
    _same_run(got, want)


def test_focalstack_matches_the_jax_driver(plain_jax_trace, monkeypatch):
    """A cone source of 1 degree and three sensor distances, matched against a
    stack the port renders from a bump and the disk emission with the same
    rays (the JAX driver's loss on it then holds the JAX renders too)."""
    rays, tpv, rpv = TS.rand_cone_in_sphere(torch.Generator().manual_seed(2), 1, (8, 8), 1, 10.0,
                                            sensor_dist=0, cone_angle=1.0, dtype=torch.float64)
    arrays, tpv = _arrays(rays), tpv.numpy()
    monkeypatch.setattr(JS, "rand_cone_in_sphere",
                        lambda *a, **k: (_jrays(arrays), jnp.asarray(tpv), rpv))
    params = dict(TR.cfg.load_params(str(CONFIGS / "params-focalstack.yaml"),
                                      "lkfs10_3im_srciminfocus_cone1_dist2"), **TINY,
                  grad_spotcheck=False, auto_exact=False, src_angle=1.0)
    src = TR.l2ball_sdf(8, 10.0, dtype=torch.float64, device="cpu").neg().clamp(min=0.0)
    _close(src, np.maximum(-np.asarray(JRUN.l2ball_sdf(8, 10.0, dtype=jnp.float64)), 0.0), 1e-12)
    scene = TV.gaussian_bump(5, 10.0, 0.1, torch.float64, "cpu")
    stack = TFS.render_stack(TC.make_trace(10.0, 10.0 / 4 / 2), scene, _hook(arrays)(None, 1),
                             src, params["sensor_dists"], 8, 10.0, torch.float64).numpy()
    assert stack.shape == (3, 8, 8) and stack.min() >= 0 and np.isfinite(stack).all()
    want = JFS.multires_exp(dict(params, dtype=jnp.float64, source_image=jnp.asarray(src.numpy()),
                                 focal_stack=list(map(jnp.asarray, stack))))
    got = TFS.multires_exp(dict(params, dtype="float64", source_image=src,
                                focal_stack=list(map(torch.from_numpy, stack))),
                           device="cpu", sample_rays=_hook(arrays))
    _same_run(got, want)
    drawn = TFS.make_synthetic_stack(scene, dict(params, dtype="float64", source_image=src),
                                     device="cpu")
    assert len(drawn) == 3 and drawn[0].shape == (8, 8) and bool(torch.isfinite(drawn[0]).all())


@pytest.mark.parametrize("yaml, section", [
    ("params-luneburg.yaml", None), ("params-image.yaml", "einstein-turing"),
    ("params-sdf.yaml", None), ("params-focalstack.yaml", "lkfs10_3im_srciminfocus_cone1_dist2")])
def test_runner_dispatches_the_shipped_yaml(yaml, section, tmp_path):
    """The shipped sections through the command line on the CPU, cut to one
    step at 3^3 and two rays a pixel row; files written where asked."""
    out = tmp_path / "run"
    argv = [str(CONFIGS / yaml)] + ([section] if section else []) + [
        "--device", "cpu", "--result-dir", str(out), "--set", "res_list=[3]",
        "--set", "nbins=8", "--set", "spp=1", "--set", "optim_iters=1",
        "--set", "record_iters=1000000000", "--set", "grad_spotcheck=false"]
    eta, hist = TR.main(argv)[:2]
    assert eta.shape == (3, 3, 3) and eta.dtype == torch.float32 and eta.device.type == "cpu"
    assert len(hist) == 1 and np.isfinite(hist[0])
    assert (out / "result.npz").stat().st_size > 0 and (out / "metrics.jsonl").exists()


def test_spotcheck_holds_the_adjoint_against_trace_exact(monkeypatch, cube_rays):
    """The spot check's yardstick is ``checkpointed.trace_exact``, as in the JAX
    package: with the taped plain stepper made to raise it still runs, its
    numbers are those of ``api.trace`` against ``trace_exact`` computed here,
    and those of the JAX function on the same scene (Luneburg's at 5^3, whose
    JAX spot check the Luneburg test has compiled)."""
    monkeypatch.setenv("ANRT_FAST_PATH", "classic")
    (x, v, _, mask), _ = cube_rays
    mask = mask.copy()
    mask[::5] = False
    rays = TS.Rays(torch.from_numpy(x), torch.from_numpy(v), None, None)
    eta = TV.gaussian_bump(5, 20.0, 0.05, torch.float64, "cpu").numpy()
    span, h, ds = 20.0, 5.0, 2.5

    def taped(*args, **kwargs):
        raise AssertionError("the spot check taped the plain stepper")

    monkeypatch.setattr(TAPI, "trace_ad", taped)
    got = TC.gradient_spotcheck(torch.from_numpy(eta), rays.x, rays.v, span, ds,
                                mask=torch.from_numpy(mask))

    ax = torch.linspace(-1.0, 1.0, 5, dtype=torch.float64)
    zz, yy, xx = torch.meshgrid(ax, ax, ax, indexing="ij")
    bumped = torch.from_numpy(eta) + 0.05 * torch.exp(-(xx ** 2 + yy ** 2 + zz ** 2) / 0.18)

    def grad(fn):
        n = bumped.clone().requires_grad_(True)
        xt, vt = fn(n, rays.x, rays.v, h, ds)
        per = torch.where(torch.from_numpy(mask), (xt ** 2 + xt * vt).sum(dim=-1), 0.0)
        per.sum().backward()
        return n.grad.reshape(-1)

    g_adj, g_ex = grad(TAPI.trace), grad(TCK.trace_exact)
    d = g_adj - g_ex
    direct = dict(max_rel=float(d.abs().max() / g_ex.abs().max()),
                  rel_l2=float(d.norm() / g_ex.norm()),
                  cos=float(g_adj @ g_ex / (g_adj.norm() * g_ex.norm())))
    want = JC.gradient_spotcheck(jnp.asarray(eta), jnp.asarray(x), jnp.asarray(v), span, ds,
                                 mask=jnp.asarray(mask))
    assert set(got) == set(direct) == set(want)
    for k in want:
        assert abs(got[k] - direct[k]) <= 1e-12, (k, got[k], direct[k])
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
    assert float(g_ex.abs().max()) > 0 and x.shape == (384, 3)
