"""The port's remaining sources (2D beams, the 1D sensor, the area and sphere
sources, the jitter) against the JAX package's.

CPU, f64 (conftest enables x64).  Each random function is fed the JAX side's
own draws, reproduced from its key as its code draws them, so that both sides
compute the same deterministic body.  Tolerance ``1e-12`` of the reference's
largest magnitude; masks and bin indices must be equal.
"""

import jax
import numpy as np
import pytest
import torch

from adjointnonlinearraytracing_tpu.sources import sources as JS
from adjointnonlinearraytracing_tpu_torch.sources import sources as TS

RTOL = 1e-12
PIXELS, SPP, WIDTH = (4, 6), 2, 1.3
N = PIXELS[0] * PIXELS[1] * SPP
KEY = jax.random.PRNGKey(11)


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(1.0, np.abs(want).max()))


def _t(a):
    return torch.from_numpy(np.array(a))


def _same_rays(got, want):
    assert got.x.dtype == torch.float64
    for g, w in zip(got[:3], want[:3]):
        _close(g, w)
    assert np.array_equal(got.mask.numpy(), np.asarray(want.mask))


def _rays2d(n=40, seed=0):
    """2D rays around a view of ``rays_in_circle``, jittered so that some fall
    off the sensor's ends."""
    rng = np.random.default_rng(seed)
    x, v, planes = (np.array(a) for a in TS.rays_in_circle(
        2, n // 2, WIDTH, angle_span=180, dtype=torch.float64, device="cpu"))
    return x + 0.4 * WIDTH * rng.standard_normal((n, 2)), v, planes


AREA_KWARGS = [dict(), dict(circle=True), dict(xaxis=True, sensor_dist=0.4)]
LENSES = ["luneburg", "other"]
DIMS = [2, 3]
SPHERE_N = 30


ROT_X = np.random.default_rng(1).standard_normal((7, 2))
FILTER_X = np.linspace(-1.6, 1.6, 33)


def _jax_refs(key, x, v, planes, v5):
    """Every JAX reference but the area source's, and every draw, in one jit
    (eager JAX compiles one program a primitive)."""
    out = {"rotate": JS.rotate_ray(ROT_X, 37.0), "plane": JS.plane_source(130.0, 9, WIDTH),
           "circle": JS.rays_in_circle(3, 5, WIDTH, angle_span=270),
           "tent": JS.tent_filter(FILTER_X, 0.7), "gauss": JS.gauss_filter(FILTER_X, 0.9, 0.3),
           "sphere": [JS.sample_sphere(key, SPHERE_N, WIDTH, cone_angle=70.0, lens_type=lens)[0]
                      for lens in LENSES],
           "perturb": [JS.perturb_vector(key, v5[:, :d], 3) for d in DIMS],
           "perturb_draw": [jax.random.normal(key, (5 * 3, d)) for d in DIMS],
           "sensor": JS.create_sensor(x, v, planes[0], 7, WIDTH, e=0.3),
           "render": JS.render_intensities(x, v, planes, 2, 20, 6, WIDTH),
           "render_grad": JS.render_intensities(x, v, planes, 2, 20, 6, WIDTH, grad=True)}
    k1, k2 = jax.random.split(key)
    out["area_draw"] = (jax.random.uniform(k1, (2 * SPP, *PIXELS)), jax.random.normal(k2, (N, 3)))
    k1, k2, k3 = jax.random.split(key, 3)
    kz, kt = jax.random.split(k2)
    out["sphere_draw"] = (jax.random.normal(k1, (SPHERE_N, 3)),
                          jax.random.uniform(kz, (SPHERE_N,)),
                          jax.random.uniform(kt, (SPHERE_N,)),
                          jax.random.normal(k3, (SPHERE_N, 3)))
    return out


@pytest.fixture(scope="module")
def refs():
    x, v, planes = _rays2d()
    v5 = np.random.default_rng(2).standard_normal((5, 3))
    out = jax.tree_util.tree_map(np.asarray, jax.jit(_jax_refs)(KEY, x, v, planes, v5))
    # eager, as the function runs outside a jit: its hit-the-volume test lands on
    # the face y = -width / 2 for every ray, where a fused program rounds otherwise
    out["area"] = [JS.area_source3_rand(KEY, 55.0, PIXELS, SPP, WIDTH, **kw) for kw in AREA_KWARGS]
    return dict(out, x=x, v=v, planes=planes, v5=v5)


def test_rotate_ray_and_plane_source(refs):
    _close(TS.rotate_ray(torch.from_numpy(ROT_X), 37.0), refs["rotate"])
    got = TS.plane_source(130.0, 9, WIDTH, dtype=torch.float64, device="cpu")
    for g, w in zip(got, refs["plane"]):
        _close(g, w)


def test_rays_in_circle(refs):
    got = TS.rays_in_circle(3, 5, WIDTH, angle_span=270, dtype=torch.float64, device="cpu")
    assert got[0].shape == (15, 2) and got[2].shape == (15, 2, 2)
    for g, w in zip(got, refs["circle"]):
        _close(g, w)


@pytest.mark.parametrize("k", range(len(DIMS)))
def test_perturb_vector(refs, k):
    v = torch.from_numpy(refs["v5"][:, :DIMS[k]])
    _close(TS.perturb_vector_from_samples(_t(refs["perturb_draw"][k]), v, 3), refs["perturb"][k])


@pytest.mark.parametrize("k", range(len(AREA_KWARGS)))
def test_area_source3_rand(refs, k):
    want, want_xt, want_tpv = refs["area"][k]
    got, xt, tpv = TS.area_source3_from_samples(*map(_t, refs["area_draw"]), 55.0, PIXELS, SPP,
                                                WIDTH, **AREA_KWARGS[k])
    _same_rays(got, want)
    _close(xt, want_xt)
    _close(tpv, want_tpv)
    # the hit-the-volume rejection masks some rays and keeps others
    assert 0 < int(got.mask.sum()) < N


@pytest.mark.parametrize("k", range(len(LENSES)))
def test_sample_sphere(refs, k):
    got, rpv = TS.sample_sphere_from_samples(*map(_t, refs["sphere_draw"]), WIDTH,
                                             cone_angle=70.0, lens_type=LENSES[k])
    _same_rays(got, refs["sphere"][k])
    assert rpv == [SPHERE_N]  # JAX's second output, a Python list
    # the documented deviation from the reference: unit directions
    _close(torch.linalg.norm(got.v, dim=1), np.ones(SPHERE_N))


def test_tent_and_gauss_filters(refs):
    x = torch.from_numpy(FILTER_X)
    for got, want in ((TS.tent_filter(x, 0.7), refs["tent"]),
                      (TS.gauss_filter(x, 0.9, 0.3), refs["gauss"])):
        for g, w in zip(got, want):
            _close(g, w)


def test_create_sensor_and_its_gradient_parts(refs):
    x, v, planes = (torch.from_numpy(refs[k]) for k in ("x", "v", "planes"))
    got, parts = TS.create_sensor(x, v, planes[0], 7, WIDTH, e=0.3)
    want, want_parts = refs["sensor"]
    _close(got, want)
    _close(parts[0], want_parts[0])
    _close(parts[1], want_parts[1])
    for g, w in zip(parts[2:], want_parts[2:]):
        assert np.array_equal(g.numpy(), w)
    assert float(got.sum()) > 0


@pytest.mark.parametrize("grad", [False, True])
def test_render_intensities(refs, grad):
    x, v, planes = (torch.from_numpy(refs[k]) for k in ("x", "v", "planes"))
    got = TS.render_intensities(x, v, planes, 2, 20, 6, WIDTH, grad=grad)
    if not grad:
        _close(got, refs["render"])
        return
    want = refs["render_grad"]
    _close(got[0], want[0])
    assert len(got[1]) == len(want[1]) == 4
    for k, (g, w) in enumerate(zip(got[1], want[1])):
        if k < 2:
            _close(g, w)
        else:
            assert np.array_equal(g.numpy(), w)


def test_random_draws_come_from_the_generator():
    """The drawing functions make their samples from the generator, in the
    order their bodies take them, on the generator's device."""
    gen = torch.Generator().manual_seed(3)
    rays, xt, tpv = TS.area_source3_rand(gen, 20.0, PIXELS, SPP, WIDTH, dtype=torch.float64)
    gen2 = torch.Generator().manual_seed(3)
    off = torch.rand((2 * SPP, *PIXELS), generator=gen2, dtype=torch.float64)
    hemi = torch.randn((N, 3), generator=gen2, dtype=torch.float64)
    want = TS.area_source3_from_samples(off, hemi, 20.0, PIXELS, SPP, WIDTH)
    assert torch.equal(rays.x, want[0].x) and torch.equal(tpv, want[2])

    gen = torch.Generator().manual_seed(4)
    got, _ = TS.sample_sphere(gen, 12, WIDTH, dtype=torch.float64)
    assert got.x.shape == (12, 3) and got.x.device.type == "cpu"
    v = torch.ones((3, 2), dtype=torch.float64)
    assert TS.perturb_vector(torch.Generator().manual_seed(0), v, 2).shape == (6, 2)
