"""The port's sources and ``trace_rays_to_plane`` against the JAX package's.

CPU, f64 (conftest enables x64).  Each random source is fed the JAX side's own
uniform draws (reproduced from its key, as its code draws them), so both sides
compute the same deterministic body.  Tolerance ``1e-12`` relative to the
reference's largest magnitude for ``x``, ``v``, ``planes`` (same f64
arithmetic, different order in the rotation product); masks must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adjointnonlinearraytracing_tpu.sensors import sensors as JSEN
from adjointnonlinearraytracing_tpu.sources import sources as JS
from adjointnonlinearraytracing_tpu_torch.sensors import sensors as TSEN
from adjointnonlinearraytracing_tpu_torch.sources import sources as TS

RTOL = 1e-12
PIXELS, SPP, WIDTH = (4, 6), 2, 1.3
N = PIXELS[0] * PIXELS[1] * SPP
KEY = jax.random.PRNGKey(7)


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(1.0, np.abs(want).max()))


def _same_rays(got: TS.Rays, want: JS.Rays):
    assert got.x.dtype == torch.float64
    _close(got.x, want.x)
    _close(got.v, want.v)
    _close(got.planes, want.planes)
    assert got.mask.dtype == torch.bool
    assert np.array_equal(got.mask.numpy(), np.asarray(want.mask))


def _u(key, shape):
    """The uniform draw the JAX sources make from ``key``, as a torch tensor."""
    return torch.from_numpy(np.array(jax.random.uniform(key, shape)))


@pytest.mark.parametrize("vert", [False, True])
def test_rotate_ray3(vert):
    x = np.random.default_rng(0).standard_normal((9, 3))
    _close(TS.rotate_ray3(torch.from_numpy(x), 33.0, vert=vert),
           JS.rotate_ray3(jnp.asarray(x), 33.0, vert=vert))


@pytest.mark.parametrize("circle", [False, True])
def test_plane_source3_and_rays_in_sphere(circle):
    _same_rays(TS.plane_source3(40.0, 5, WIDTH, circle=circle, dtype=torch.float64,
                                device="cpu"),
               JS.plane_source3(40.0, 5, WIDTH, circle=circle))
    got, got_n = TS.rays_in_sphere(3, 4, WIDTH, angle_span=270, circle=circle,
                                   dtype=torch.float64, device="cpu")
    want, want_n = JS.rays_in_sphere(3, 4, WIDTH, angle_span=270, circle=circle)
    _same_rays(got, want)
    assert got_n == want_n == [16, 16, 16]


@pytest.mark.parametrize("kwargs", [
    dict(), dict(circle=True), dict(xaxis=True, sensor_dist=0.4), dict(independent=True)])
def test_plane_source3_rand(kwargs):
    want = JS.plane_source3_rand(KEY, 25.0, PIXELS, SPP, WIDTH, **kwargs)
    got = TS.plane_source3_from_samples(_u(KEY, (2 * SPP, *PIXELS)), 25.0, PIXELS, SPP, WIDTH,
                                        **kwargs)
    _same_rays(got, want)
    if kwargs.get("circle"):
        assert 0 < int(got.mask.sum()) < N


@pytest.mark.parametrize("kwargs", [dict(), dict(circle=True), dict(xaxis=True, sensor_dist=0.0)])
def test_point_source3_rand(kwargs):
    want = JS.point_source3_rand(KEY, 115.0, PIXELS, SPP, WIDTH, **kwargs)
    got = TS.point_source3_from_samples(_u(KEY, (2 * SPP, *PIXELS)), 115.0, PIXELS, SPP, WIDTH,
                                        **kwargs)
    _same_rays(got, want)


@pytest.mark.parametrize("kwargs", [dict(), dict(circle=True), dict(xaxis=True, sensor_dist=0.3)])
def test_area_source3_rand_bias(kwargs):
    want, want_xt, want_tpv = JS.area_source3_rand_bias(KEY, 200.0, PIXELS, SPP, WIDTH, **kwargs)
    k1, k2 = jax.random.split(KEY)
    got, xt, tpv = TS.area_source3_bias_from_samples(
        _u(k1, (2 * SPP, *PIXELS)), _u(k2, (2, N)), 200.0, PIXELS, SPP, WIDTH, **kwargs)
    _same_rays(got, want)
    _close(xt, want_xt)
    _close(tpv, want_tpv)


@pytest.mark.parametrize("rig", ["rand_rays_in_sphere", "rand_ptrays_in_sphere",
                                 "rand_area_in_sphere"])
def test_multi_view_rigs_draw_in_view_order(rig, monkeypatch):
    """The rigs with the JAX side's per-view draws queued where the port draws."""
    nviews, key = 3, jax.random.PRNGKey(11)
    want = getattr(JS, rig)(key, nviews, PIXELS, SPP, WIDTH, angle_span=180, sensor_dist=0.5)
    queue = []
    for k in jax.random.split(key, nviews):
        if rig == "rand_area_in_sphere":
            k1, k2 = jax.random.split(k)
            queue += [_u(k1, (2 * SPP, *PIXELS)), _u(k2, (2, N))]
        else:
            queue.append(_u(k, (2 * SPP, *PIXELS)))

    def draw(gen, shape, dtype):
        sample = queue.pop(0)
        assert tuple(sample.shape) == tuple(shape) and sample.dtype == dtype
        return sample

    monkeypatch.setattr(TS, "_uniform", draw)
    gen = torch.Generator().manual_seed(0)
    got = getattr(TS, rig)(gen, nviews, PIXELS, SPP, WIDTH, angle_span=180, sensor_dist=0.5,
                           dtype=torch.float64)
    assert not queue
    _same_rays(got[0], want[0])
    assert got[-1] == want[-1] == [N] * nviews
    if rig == "rand_area_in_sphere":
        _close(got[1], want[1])
        _close(got[2], want[2])


def test_random_sources_draw_from_the_generator():
    """Same seed, same rays; the draw advances the generator; f32 by default."""
    a = TS.rand_rays_in_sphere(torch.Generator().manual_seed(3), 2, PIXELS, SPP, WIDTH)[0]
    gen = torch.Generator().manual_seed(3)
    b = TS.rand_rays_in_sphere(gen, 2, PIXELS, SPP, WIDTH)[0]
    c = TS.rand_rays_in_sphere(gen, 2, PIXELS, SPP, WIDTH)[0]
    assert a.x.dtype == torch.float32 and a.x.shape == (2 * N, 3)
    assert a.planes.shape == (2 * N, 3, 3)
    assert torch.equal(a.x, b.x) and not torch.equal(b.x, c.x)
    assert torch.allclose(a.v.norm(dim=-1), torch.ones(2 * N))


def test_trace_rays_to_plane_value_and_gradient():
    rng = np.random.default_rng(5)
    x, v, p, n = (rng.standard_normal((17, 3)) for _ in range(4))
    n[:, 1] += 3.0
    v[:, 1] += 3.0  # keep n.v away from 0
    w = rng.standard_normal((2, 17, 3))

    def jloss(x, v, p, n):
        xp, vp = JSEN.trace_rays_to_plane((x, v), (p, n))
        return jnp.sum(w[0] * xp) + jnp.sum(w[1] * vp)

    want = JSEN.trace_rays_to_plane((jnp.asarray(x), jnp.asarray(v)),
                                    (jnp.asarray(p), jnp.asarray(n)))
    grads = jax.grad(jloss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (x, v, p, n)))

    tx, tv, tp, tn = (torch.from_numpy(a).requires_grad_(True) for a in (x, v, p, n))
    xp, vp = TSEN.trace_rays_to_plane((tx, tv), (tp, tn))
    _close(xp, want[0])
    _close(vp, want[1])
    ((torch.from_numpy(w[0]) * xp).sum() + (torch.from_numpy(w[1]) * vp).sum()).backward()
    for t, g in zip((tx, tv, tp, tn), grads):
        _close(t.grad, g)
    # a single plane broadcasts over the rays
    xp1, _ = TSEN.trace_rays_to_plane((tx, tv), (tp[:1], tn[:1]))
    _close(xp1, JSEN.trace_rays_to_plane((jnp.asarray(x), jnp.asarray(v)),
                                         (jnp.asarray(p[:1]), jnp.asarray(n[:1])))[0])
