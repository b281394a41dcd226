"""The port's RBF toolkit, sensors and the image drivers' sources against the
JAX package's.

CPU, f64 (conftest enables x64).  Inputs come from numpy seeds; the random
sources are fed the JAX side's own draws (reproduced from its keys as its
code draws them).  Tolerance ``1e-12`` relative to the reference's largest
magnitude, for values and for gradients (``jax.grad`` against autograd).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adjointnonlinearraytracing_tpu.fields import rbf as JR
from adjointnonlinearraytracing_tpu.sensors import sensors as JSEN
from adjointnonlinearraytracing_tpu.sources import sources as JS
from adjointnonlinearraytracing_tpu_torch import sensors as TSEN_PKG
from adjointnonlinearraytracing_tpu_torch.fields import rbf as TR
from adjointnonlinearraytracing_tpu_torch.sensors import sensors as TSEN
from adjointnonlinearraytracing_tpu_torch.sources import sources as TS

RTOL = 1e-12
H = 0.25


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, want, rtol=RTOL):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(1.0, np.abs(want).max()))


def _t(a):
    return torch.from_numpy(np.array(a))


def _points(ndim, n=40, seed=0, res=6):
    """Points over the grid and a margin around it, some exactly on nodes of
    the 4^n stencil's lattice (``x / h - 0.5`` an integer: r == 0 there)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.5 * H, (res + 0.5) * H, size=(n, ndim))
    x[:4] = (rng.integers(0, res, size=(4, ndim)) + 0.5) * H  # on a node
    x[4] = 0.5 * H * np.ones(ndim)  # on the first node: corners off the grid
    x[5] = -1.2 * H  # outside, every corner clipped
    return x


def _scene(ndim, res=6, seed=1):
    return np.random.default_rng(seed).standard_normal((res,) * ndim)


def _grids(ndim):
    scene = _scene(ndim)
    return TR.RbfGrid.create(_t(scene), H), JR.RbfGrid.create(jnp.asarray(scene), H)


def _value_and_grads(jfn, tfn, arrays, seed=0):
    """``tfn`` against ``jfn`` on the same inputs: the output, and the gradient
    of ``sum(W * output)`` for a random ``W`` with respect to every input."""
    jargs = [jnp.asarray(a) for a in arrays]
    w = np.random.default_rng(seed).standard_normal(jax.eval_shape(jfn, *jargs).shape)

    def loss(*a):
        out = jfn(*a)
        return jnp.sum(w * out), out

    (_, want), grads = jax.jit(jax.value_and_grad(loss, argnums=tuple(range(len(arrays))),
                                                  has_aux=True))(*jargs)
    targs = [_t(a).requires_grad_(True) for a in arrays]
    got = tfn(*targs)
    _close(got, want)
    (torch.from_numpy(w) * got).sum().backward()
    for t, g in zip(targs, grads):  # an input the output does not reach gets no grad
        _close(torch.zeros_like(t) if t.grad is None else t.grad, g)
    assert any(float(np.abs(np.asarray(g)).max()) > 0 for g in grads)


def test_kernels_and_render():
    r = np.concatenate([np.linspace(-2.5, 2.5, 41), [0.0, 1.0, 2.0, np.sqrt(2.0)]])
    for name in ("rbf_tent", "rbf_cubic"):
        got = getattr(TR, name)(_t(r))
        want = getattr(JR, name)(jnp.asarray(r))
        _close(got[0], want[0])
        _close(got[1], want[1])
        assert got[2] == want[2] == 0.0
    rng = np.random.default_rng(2)
    scene, weights = rng.standard_normal((5, 5)), rng.standard_normal((5, 5))
    weights[::2, 1] = 0.0
    weights[3, 3] = 1e-9  # close to 0: left unnormalised, as in JAX
    got = TR.RbfGrid(_t(scene), _t(weights), H).render()
    _close(got, JR.RbfGrid(jnp.asarray(scene), jnp.asarray(weights), H).render())
    g = TR.RbfGrid.create(_t(scene), H)
    assert torch.equal(g.weights, torch.zeros(5, 5)) and g.h == H


@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_index_values(ndim):
    tg, jg = _grids(ndim)
    x = _points(ndim)
    got = TR._index_values(tg, _t(x))
    want = jax.jit(JR._index_values)(jg, jnp.asarray(x))
    for g, w in zip(got[:3], want[:3]):
        _close(g, w)
    assert len(got[3]) == len(want[3]) == ndim
    for g, w in zip(got[3], want[3]):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert (got[1][:4] == 0).any(dim=1).all()  # the on-node queries have r == 0


@pytest.mark.parametrize("ndim", [1, 2, 3])
@pytest.mark.parametrize("kind", ["tent", "sigmoid", "cubic"])
def test_get_value_and_gradient(ndim, kind):
    tg, jg = _grids(ndim)
    x = _points(ndim)
    kw = dict(sigmoid=kind == "sigmoid", cubic=kind == "cubic")
    got = TR.get(tg, _t(x), **kw)
    w = np.random.default_rng(3).standard_normal(len(x))

    @jax.jit
    def ref(g, p):
        # the value, the gradient, and d(sum w f)/dx through the stencil
        return JR.get(g, p, **kw), jax.grad(lambda q: jnp.sum(w * JR.get(g, q, **kw)[0]))(p)

    want, jgrad = ref(jg, jnp.asarray(x))
    _close(got[0], want[0])
    _close(got[1], want[1])
    tx = _t(x).requires_grad_(True)
    (torch.from_numpy(w) * TR.get(tg, tx, **kw)[0]).sum().backward()
    _close(tx.grad, jgrad)


@pytest.mark.parametrize("ndim", [2, 3])
def test_get_hessian(ndim):
    tg, jg = _grids(ndim)
    x = _points(ndim, n=6)
    got = TR.get_hessian(tg, _t(x))
    want = jax.jit(JR.get_hessian)(jg, jnp.asarray(x))
    assert got[0].shape == (6, 6, ndim) and got[1].shape == (6, ndim, 6, ndim)
    _close(got[0], want[0])
    _close(got[1], want[1])


@pytest.mark.parametrize("ndim", [1, 2, 3])
@pytest.mark.parametrize("average", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_splat_values_and_gradients(ndim, average, masked):
    """The splat and its gradient in the points and the values, with corners
    off the grid, an all-outside point and (optionally) masked points."""
    res = 6
    x = _points(ndim, res=res)
    f = np.random.default_rng(4).standard_normal(len(x))
    mask = np.random.default_rng(5).uniform(size=len(x)) < 0.7 if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)
    wsc, wwt = np.random.default_rng(6).standard_normal((2,) + (res,) * ndim)

    def jsplat(p, v):
        g = JR.splat(JR.RbfGrid.create(jnp.zeros((res,) * ndim), H), p, v, average, jmask)
        return jnp.sum(wsc * g.scene) + jnp.sum(wwt * g.weights), g

    (_, want), (jgx, jgf) = jax.jit(jax.value_and_grad(jsplat, argnums=(0, 1), has_aux=True))(
        jnp.asarray(x), jnp.asarray(f))
    tx, tf = _t(x).requires_grad_(True), _t(f).requires_grad_(True)
    got = TR.splat(TR.RbfGrid.create(torch.zeros((res,) * ndim, dtype=torch.float64), H), tx,
                   tf, average, tmask)
    _close(got.scene, want.scene)
    _close(got.weights, want.weights)
    ((torch.from_numpy(wsc) * got.scene).sum()
     + (torch.from_numpy(wwt) * got.weights).sum()).backward()
    _close(tx.grad, jgx)
    _close(tf.grad, jgf)


@pytest.mark.parametrize("ndim", [2, 3])
def test_splat_grad_and_solve_grad(ndim):
    tg, jg = _grids(ndim)
    x = _points(ndim, n=12)
    rng = np.random.default_rng(7)
    f, fx = rng.standard_normal(12), rng.standard_normal((12, ndim))
    fx[0] = 0.0  # |fx| == 0: the NaN-safe norm
    for name in ("splat_grad", "solve_grad"):
        got = getattr(TR, name)(tg, _t(x), _t(f), _t(fx))
        want = jax.jit(getattr(JR, name))(jg, jnp.asarray(x), jnp.asarray(f), jnp.asarray(fx))
        _close(got.scene, want.scene)
        _close(got.weights, want.weights)


@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_linear_and_spline(ndim):
    tg, jg = _grids(ndim)
    x = np.abs(_points(ndim))  # get_linear's corners are clipped, not masked
    x[6] = 5.99 * H * np.ones(ndim)  # the last cell, the far corner clipped
    got = TR._linear_stencil(tg, _t(x))
    want = jax.jit(lambda g, p: JR._linear_stencil(g, p)[:3])(jg, jnp.asarray(x))
    _close(got[0], want[0])
    for g, w in zip(got[1], want[1]):
        assert np.array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(got[2], want[2]):
        _close(g, w)
    rng = np.random.default_rng(8)
    f, fx = rng.standard_normal(len(x)), rng.standard_normal((len(x), ndim))
    mask = rng.uniform(size=len(x)) < 0.8
    # values and gradients: get_linear and get_spline in the points,
    # splat_linear in the values (masked and not)
    for name in ("get_linear", "get_spline"):
        _value_and_grads(lambda p: jnp.concatenate(
                             [a.reshape(-1) for a in getattr(JR, name)(jg, p)]),
                         lambda p: torch.cat([a.reshape(-1) for a in getattr(TR, name)(tg, p)]),
                         [x])
    for m in (None, mask):
        jm = None if m is None else jnp.asarray(m)
        tm = None if m is None else _t(m)
        _value_and_grads(
            lambda f_, fx_: jnp.stack(JR.splat_linear(jg, jnp.asarray(x), f_, fx_, jm)[:2]),
            lambda f_, fx_: torch.stack(TR.splat_linear(tg, _t(x), f_, fx_, tm)[:2]),
            [f, fx])
    for linear in (False, True):
        _close(TR.render_gradient(tg, linear),
               jax.jit(JR.render_gradient, static_argnums=1)(jg, linear))


# ---------------------------------------------------------------------------
# sensors
# ---------------------------------------------------------------------------

def _rays(n=64, seed=10, span=2.0):
    """Rays leaving a volume of side ``span`` roughly along +y, toward a plane
    at y = 1.3 span; some fall off the sensor."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, span, size=(n, 3))
    x[:, 1] = span
    v = rng.standard_normal((n, 3)) * 0.3
    v[:, 1] = 1.0
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    p = np.array([[span / 2, 1.3 * span, span / 2]])
    nrm = np.array([[0.0, 1.0, 0.0]])
    return x, v, p, nrm


@pytest.mark.parametrize("tangent", [None, "given"])
def test_get_tan_vecs(tangent):
    for nrm in ([[0.0, 1.0, 0.0]], [[0.0, 0.6, 0.8]], [[0.3, 0.0, -0.954]]):
        t = None if tangent is None else np.array([[0.0, 0.0, 1.0]])
        got = TSEN.get_tan_vecs(_t(nrm), None if t is None else _t(t))
        want = jax.jit(JSEN.get_tan_vecs)(jnp.asarray(nrm), None if t is None else jnp.asarray(t))
        _close(got[0], want[0])
        _close(got[1], want[1])


@pytest.mark.parametrize("emission", ["scalar", "per_ray"])
@pytest.mark.parametrize("masked", [False, True])
def test_generate_sensor_image_and_its_gradient(emission, masked):
    """The image, and d(image . W)/d(x, v, e) against ``jax.grad``."""
    x, v, p, nrm = _rays()
    rng = np.random.default_rng(11)
    e = rng.uniform(0.5, 1.5, len(x)) if emission == "per_ray" else 0.7
    mask = rng.uniform(size=len(x)) < 0.75 if masked else None
    res, span = 9, 2.0
    wimg = rng.standard_normal((res, res))
    t = np.array([[0.0, 0.0, 1.0]])

    def jloss(x_, v_, e_):
        m = None if mask is None else jnp.asarray(mask)
        image = JSEN.generate_sensor((x_, v_), e_, (jnp.asarray(p), jnp.asarray(nrm)), res, span,
                                     jnp.asarray(t), mask=m)
        return jnp.sum(wimg * image), image

    argnums = (0, 1, 2) if emission == "per_ray" else (0, 1)
    (_, want), grads = jax.jit(jax.value_and_grad(jloss, argnums=argnums, has_aux=True))(
        jnp.asarray(x), jnp.asarray(v), jnp.asarray(e))
    assert float(jnp.abs(want).max()) > 0
    tx, tv = _t(x).requires_grad_(True), _t(v).requires_grad_(True)
    te = _t(e).requires_grad_(True) if emission == "per_ray" else e
    got = TSEN.generate_sensor((tx, tv), te, (_t(p), _t(nrm)), res, span, _t(t),
                               mask=None if mask is None else torch.from_numpy(mask))
    _close(got, want)
    (torch.from_numpy(wimg) * got).sum().backward()
    _close(tx.grad, grads[0])
    _close(tv.grad, grads[1])
    if emission == "per_ray":
        _close(te.grad, grads[2])
    # the default tangent frame, and a ray that lands exactly on a node of an
    # 8 x 8 sensor (h = 0.25: every coordinate on its way is exact), so that
    # a stencil corner sits at r = 0 (the NaN guard) and four at r = sqrt(2)
    # (the tent's kink)
    res2, w2 = 8, wimg[:8, :8]
    x2, v2 = x.copy(), v.copy()
    x2[0, [0, 2]] = [0.625, 0.875]
    v2[0] = [0.0, 1.0, 0.0]
    tx2 = _t(x2).requires_grad_(True)
    got = TSEN.generate_sensor((tx2, _t(v2)), 1.0, (_t(p), _t(nrm)), res2, span)
    (torch.from_numpy(w2) * got).sum().backward()

    def jloss2(a):
        image = JSEN.generate_sensor((a, jnp.asarray(v2)), 1.0,
                                     (jnp.asarray(p), jnp.asarray(nrm)), res2, span)
        return jnp.sum(w2 * image), image

    (_, want), jg = jax.jit(jax.value_and_grad(jloss2, has_aux=True))(jnp.asarray(x2))
    _close(got, want)
    _close(tx2.grad, jg)
    _, r, _, _ = TR._index_values(TR.RbfGrid.create(got, span / res2), torch.tensor(
        [[0.625, 0.875]], dtype=torch.float64))
    assert int((r == 0).sum()) == 1 and int((r == np.sqrt(2.0)).sum()) == 4


@pytest.mark.parametrize("masked", [False, True])
def test_inf_and_pleno_sensors(masked):
    x, v, p, nrm = _rays(seed=12)
    mask = np.random.default_rng(13).uniform(size=len(x)) < 0.7 if masked else None
    tm = None if mask is None else torch.from_numpy(mask)
    jm = None if mask is None else jnp.asarray(mask)
    bins = (6, 6, 5, 5)
    jplane, tplane = (jnp.asarray(p), jnp.asarray(nrm)), (_t(p), _t(nrm))
    _value_and_grads(
        lambda x_, v_: JSEN.generate_inf_sensor((x_, v_), 1.0, jplane, 8, 90, mask=jm),
        lambda x_, v_: TSEN.generate_inf_sensor((x_, v_), 1.0, tplane, 8, 90, mask=tm), [x, v])
    _value_and_grads(
        lambda x_, v_: JSEN.generate_pleno_sensor((x_, v_), 0.5, jplane, bins, 2.0, 100, mask=jm),
        lambda x_, v_: TSEN.generate_pleno_sensor((x_, v_), 0.5, tplane, bins, 2.0, 100,
                                                  mask=tm), [x, v], seed=1)
    got = TSEN.generate_pleno_sensor((_t(x), _t(v)), 0.5, tplane, bins, 2.0, 100, mask=tm)
    assert got.shape == bins and float(got.abs().max()) > 0


def test_texture_lookups_and_refraction():
    x, v, p, nrm = _rays(seed=14)
    rng = np.random.default_rng(15)
    tex1, tex2 = rng.uniform(size=(10, 10)), rng.uniform(size=(10, 10, 2))
    t = np.array([[1.0, 0.0, 0.0]])
    plane_t, plane_j = (_t(p), _t(nrm)), (jnp.asarray(p), jnp.asarray(nrm))
    # every lookup with a given tangent, the first also with the default frame
    for k, (name, tex, span, tan) in enumerate((
            ("get_sdf_vals_near", tex1, 2.0, None), ("get_sdf_vals_near", tex1, 2.0, t),
            ("get_sdf_vals_far", tex1, 90, t), ("get_disps_from_tex", tex2, 2.0, t),
            ("get_defls_from_tex", tex2, 2.0, t))):
        tt, jt = (None, None) if tan is None else (_t(tan), jnp.asarray(tan))
        _value_and_grads(
            lambda x_, v_: getattr(JSEN, name)((x_, v_), jnp.asarray(tex), plane_j, span, jt),
            lambda x_, v_: getattr(TSEN, name)((x_, v_), _t(tex), plane_t, span, tt),
            [x, v], seed=k)
    # refract keeps a direction only where k >= 1, as the JAX module does: along
    # the normal, where cos = 1
    v_r = v.copy()
    v_r[:3] = [0.0, 1.0, 0.0]
    etas = (0.7, 1.0, 1.4)
    _value_and_grads(
        lambda v_: jnp.concatenate([jnp.concatenate(JSEN.refract((jnp.asarray(x), v_), plane_j,
                                                                 e)) for e in etas]),
        lambda v_: torch.cat([torch.cat(TSEN.refract((_t(x), v_), plane_t, e)) for e in etas]),
        [v_r])


def test_sensors_package_exports_what_the_jax_package_does():
    import adjointnonlinearraytracing_tpu.sensors as jpkg
    names = [n for n in dir(jpkg) if not n.startswith("_") and n != "sensors"]
    assert names and all(getattr(TSEN_PKG, n) is getattr(TSEN, n) for n in names)


# ---------------------------------------------------------------------------
# sources the image drivers draw
# ---------------------------------------------------------------------------

PIXELS, SPP, WIDTH = (3, 4), 2, 1.7
N = PIXELS[0] * PIXELS[1] * SPP


def _u(key, shape):
    return _t(jax.random.uniform(key, shape))


def _hatbox_samples(key, n):
    kz, kt = jax.random.split(key)
    return [_u(kz, (n,)), _u(kt, (n,))]


def _same_rays(got, want):
    assert got.x.dtype == torch.float64
    for g, w in zip(got[:3], want[:3]):
        _close(g, w)
    assert np.array_equal(got.mask.numpy(), np.asarray(want.mask))


def _feed(monkeypatch, uniforms, normals=()):
    """Queue the JAX side's draws where the port draws."""
    qu, qn = list(uniforms), list(normals)

    def take(queue):
        def draw(gen, shape, dtype):
            sample = queue.pop(0)
            assert tuple(sample.shape) == tuple(shape) and sample.dtype == dtype
            return sample
        return draw

    monkeypatch.setattr(TS, "_uniform", take(qu))
    monkeypatch.setattr(TS, "_normal", take(qn))
    return qu, qn


def test_random_rotmat_and_rotations(monkeypatch):
    key = jax.random.PRNGKey(3)
    q = _t(jax.random.normal(key, (4,)))
    R = TS.random_rotmat_from_samples(q)
    _close(R, JS.random_rotmat(key))
    _close(R @ R.T, np.eye(3))
    rng = np.random.default_rng(16)
    x, v = rng.standard_normal((2, 7, 3))
    planes = rng.standard_normal((7, 3, 3))
    want = JS.random_rotate_ic(key, jnp.asarray(x), jnp.asarray(v), jnp.asarray(planes), 2.0)
    _, qn = _feed(monkeypatch, [], [q])
    for got in (TS.random_rotate_ic_from_samples(q, _t(x), _t(v), _t(planes), 2.0),
                TS.random_rotate_ic(None, _t(x), _t(v), _t(planes), 2.0)):
        for g, w in zip(got, want):
            _close(g, w)
    assert not qn
    for vert in (False, True):
        got = TS.rotate_ic(_t(x), _t(v), _t(planes), 35.0, 2.0, vert=vert)
        want = JS.rotate_ic(jnp.asarray(x), jnp.asarray(v), jnp.asarray(planes), 35.0, 2.0,
                            vert=vert)
        for g, w in zip(got, want):
            _close(g, w)


def test_hatbox_and_point_source3():
    key = jax.random.PRNGKey(4)
    v = np.random.default_rng(17).standard_normal((9, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    _close(TS.hatbox_from_samples(*_hatbox_samples(key, 9), _t(v), 40.0),
           jax.jit(lambda k, a: JS.hatbox_sample(k, a, 40.0))(key, jnp.asarray(v)))
    for kwargs in (dict(), dict(xaxis=True, sensor_dist=0.5, cone_angle=60)):
        got = TS.point_source3(30.0, PIXELS, 5, WIDTH, dtype=torch.float64, device="cpu",
                               **kwargs)
        _same_rays(got, jax.jit(lambda: JS.point_source3(30.0, PIXELS, 5, WIDTH, **kwargs))())
        assert got.x.shape == (PIXELS[0] * PIXELS[1] * 4, 3)


@pytest.mark.parametrize("kwargs", [dict(), dict(circle=True), dict(xaxis=True, sensor_dist=0.4)])
def test_cone_sources(kwargs):
    key = jax.random.PRNGKey(5)
    want, want_tpv = jax.jit(lambda k: JS.area_source3_cone(k, 60.0, PIXELS, SPP, WIDTH,
                                                            cone_angle=20, **kwargs))(key)
    k1, k2 = jax.random.split(key)
    got, tpv = TS.area_source3_cone_from_samples(_u(k1, (2 * SPP, *PIXELS)),
                                                 *_hatbox_samples(k2, N), 60.0, PIXELS, SPP,
                                                 WIDTH, cone_angle=20, **kwargs)
    _same_rays(got, want)
    _close(tpv, want_tpv)
    want = jax.jit(lambda k: JS.cone_source3_rand(k, 60.0, PIXELS, SPP, WIDTH, cone_angle=20,
                                                  **kwargs))(key)
    got = TS.cone_source3_from_samples(*_hatbox_samples(key, N), 60.0, PIXELS, SPP, WIDTH,
                                       cone_angle=20, **kwargs)
    _same_rays(got, want)


@pytest.mark.parametrize("rig", ["rand_cone_in_sphere", "rand_ptcone_in_sphere"])
def test_cone_rigs_draw_in_view_order(rig, monkeypatch):
    nviews, key = 3, jax.random.PRNGKey(6)
    want = jax.jit(lambda k: getattr(JS, rig)(k, nviews, PIXELS, SPP, WIDTH, angle_span=180,
                                              sensor_dist=0.5, cone_angle=15.0))(key)
    queue = []
    for k in jax.random.split(key, nviews):
        if rig == "rand_cone_in_sphere":
            k1, k = jax.random.split(k)
            queue.append(_u(k1, (2 * SPP, *PIXELS)))
        queue += _hatbox_samples(k, N)
    qu, _ = _feed(monkeypatch, queue)
    got = getattr(TS, rig)(torch.Generator(), nviews, PIXELS, SPP, WIDTH, angle_span=180,
                           sensor_dist=0.5, cone_angle=15.0, dtype=torch.float64)
    assert not qu
    _same_rays(got[0], want[0])
    _close(got[1], want[1])
    assert got[2] == want[2] == [N] * nviews


@pytest.mark.parametrize("src_type", ["plane", "point", "cone"])
@pytest.mark.parametrize("circle", [False, True])
def test_rand_rays_cube_draws_its_six_faces_in_order(src_type, circle, monkeypatch):
    key = jax.random.PRNGKey(8)
    want = jax.jit(lambda k: JS.rand_rays_cube(k, PIXELS, SPP, WIDTH, circle=circle,
                                               src_type=src_type, cone_ang=25))(key)
    queue = []
    for k in jax.random.split(key, 6):
        if src_type == "plane":
            queue.append(_u(k, (2 * SPP, *PIXELS)))
        elif src_type == "cone":
            queue += _hatbox_samples(k, N)
    qu, _ = _feed(monkeypatch, queue)
    got = TS.rand_rays_cube(torch.Generator(), PIXELS, SPP, WIDTH, circle=circle,
                            src_type=src_type, cone_ang=25, dtype=torch.float64)
    assert not qu
    _same_rays(got[0], want[0])
    assert got[1] == want[1] and len(got[1]) == 6
    if circle and src_type == "plane":
        assert 0 < int(got[0].mask.sum()) < 6 * N


def test_rand_rays_cube_draws_from_the_generator():
    a = TS.rand_rays_cube(torch.Generator().manual_seed(1), PIXELS, SPP, WIDTH, circle=True)[0]
    b = TS.rand_rays_cube(torch.Generator().manual_seed(1), PIXELS, SPP, WIDTH, circle=True)[0]
    assert a.x.dtype == torch.float32 and a.x.shape == (6 * N, 3)
    assert torch.equal(a.x, b.x) and torch.equal(a.mask, b.mask)
    q = TS.random_rotmat(torch.Generator().manual_seed(2), torch.float64)
    torch.testing.assert_close(q @ q.T, torch.eye(3, dtype=torch.float64))


def test_image_norms():
    rng = np.random.default_rng(18)
    im = rng.uniform(0.1, 2.0, size=(7, 5))
    for name in ("sum_norm", "sum_norm2"):
        got, want = getattr(TS, name)(_t(im)), getattr(JS, name)(jnp.asarray(im))
        _close(got, want)
        got, s = getattr(TS, name)(_t(im), scale=True)
        want, ws = getattr(JS, name)(jnp.asarray(im), scale=True)
        _close(got, want)
        _close(s, ws)
    _close(TS.norm_image(_t(im)), JS.norm_image(jnp.asarray(im)))
    const = np.full((3, 3), 2.5)
    _close(TS.norm_image(_t(const)), JS.norm_image(jnp.asarray(const)))
