"""The port's cylinder field and cable tracer against the JAX package.

CPU, f64 (conftest enables x64).  Inputs are numpy arrays made from seeds and
handed to both sides.  Tolerances, relative to the reference's largest
magnitude: the field functions ``1e-12`` (the same f64 arithmetic; the JAX
package sums some products in another order); the closest approach ``1e-12``;
gradients ``1e-9`` (thousands of splats a bin, summed in another order).  Each
JAX reference is jitted and computed once per module.  On the CPU every
function runs its plain version; the kernels K7-K10 are held against these
plain versions on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adjointnonlinearraytracing_tpu import tracer as JT
from adjointnonlinearraytracing_tpu.fields import cylinder as JC
from adjointnonlinearraytracing_tpu_torch import tracer as TT
from adjointnonlinearraytracing_tpu_torch.fields import cylinder as TC
from adjointnonlinearraytracing_tpu_torch.kernels import wrappers as K
from adjointnonlinearraytracing_tpu_torch.tracer import checkpointed as TCK
from adjointnonlinearraytracing_tpu_torch.tracer import eikonal as TE

RES, RADIUS, LENGTH = 17, 1.0, 1.5
DS = RADIUS / RES / 2
STEPS = int(4.0 * LENGTH / DS)  # 204: the last of 13 segments of 16 holds 12 steps
SEG = 16
CHUNK = "70"  # does not divide the batch
N_AXIS = 10  # the last rays start on the axis


def _close(got, want, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(1.0, np.abs(want).max()))


def _profile():
    r = np.linspace(0.0, 1.0, RES)
    return np.sqrt(2.0 - r ** 2) + 0.02 * np.random.default_rng(0).uniform(size=RES)


def _rays():
    """250 rays: most enter through the y = 0 cap toward their target; some
    start outside the radius moving away, some enter through the side (past
    the last bin), some start inside moving back out through the cap, and the
    last ``N_AXIS`` start on the axis itself."""
    rng = np.random.default_rng(1)
    n = 250
    ang = rng.uniform(0, 2 * np.pi, n)
    rad = 0.9 * np.sqrt(rng.uniform(size=n))
    x = np.stack([RADIUS + rad * np.cos(ang), np.full(n, -0.02), RADIUS + rad * np.sin(ang)], -1)
    v = np.stack([0.1 * rng.standard_normal(n), np.ones(n), 0.1 * rng.standard_normal(n)], -1)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    out = slice(180, 200)  # outside the radius, moving outward
    x[out, 0] = RADIUS + 1.2 * np.cos(ang[out])
    x[out, 2] = RADIUS + 1.2 * np.sin(ang[out])
    x[out, 1] = rng.uniform(0.2, 1.0, 20)
    v[out] = np.stack([np.cos(ang[out]), np.zeros(20), np.sin(ang[out])], -1)
    side = slice(200, 220)  # enter through the side
    x[side, 0] = RADIUS + 1.1 * np.cos(ang[side])
    x[side, 2] = RADIUS + 1.1 * np.sin(ang[side])
    x[side, 1] = rng.uniform(0.2, 1.0, 20)
    v[side] = np.stack([-np.cos(ang[side]), 0.3 * np.ones(20), -np.sin(ang[side])], -1)
    back = slice(220, 240)  # inside, moving back out through the cap
    x[back, 1] = rng.uniform(0.1, 0.4, 20)
    v[back, 1] *= -1.0
    x[-N_AXIS:, 0] = RADIUS
    x[-N_AXIS:, 2] = RADIUS
    v[-N_AXIS:] = [0.0, 1.0, 0.0]
    tgt = np.stack([np.full(n, RADIUS), np.full(n, 0.8 * LENGTH), np.full(n, RADIUS)], -1)
    tgt += 0.05 * rng.standard_normal((n, 3))
    return x, v, tgt


@pytest.fixture(scope="module")
def scene():
    return (_profile(), *_rays())


def _field(prof):
    return TC.CylinderField(torch.from_numpy(prof), RADIUS, LENGTH)


def _loss(xt, vt, d2=None, w=None):
    out = (xt ** 2 + xt * vt).sum()
    return out if d2 is None else out + (w * d2).sum()


@pytest.fixture(scope="module")
def jax_refs(scene):
    """The JAX functions' outputs and gradients on the scene, jitted, once."""
    prof, x, v, tgt = (jnp.asarray(a) for a in scene)
    w = jnp.linspace(1.0, 2.0, x.shape[0])
    mp = pytest.MonkeyPatch()
    mp.setenv("ANRT_EXACT_CHUNK", "0")
    try:
        def grad_of(fn, with_d2=False, rays=slice(None)):
            def f(p):
                xt, vt, d2 = fn(p, RADIUS, LENGTH, x[rays], v[rays], tgt[rays], DS)
                return _loss(xt, vt, d2, w[rays]) if with_d2 else _loss(xt, vt)
            return jax.jit(jax.grad(f))(prof)

        exact = jax.jit(lambda p: JT.trace_cable_exact(p, RADIUS, LENGTH, x, v, tgt, DS, SEG))
        off_axis = slice(0, x.shape[0] - N_AXIS)  # the tape's sqrt has no gradient at r = 0
        out = dict(
            fwd=jax.jit(lambda p: JT.trace_cable(p, RADIUS, LENGTH, x, v, tgt, DS))(prof),
            grad=grad_of(JT.trace_cable),
            grad_d2=grad_of(JT.trace_cable, with_d2=True),
            ad_fwd=jax.jit(lambda p: JT.trace_cable_ad(p, RADIUS, LENGTH, x, v, tgt, DS))(prof),
            ad_grad=grad_of(JT.trace_cable_ad, rays=off_axis),
            exact_fwd=exact(prof),
            exact_grad=grad_of(lambda *a: JT.trace_cable_exact(*a, SEG)))
        return jax.tree_util.tree_map(np.asarray, out)
    finally:
        mp.undo()


def _points():
    """Field query points: random in and around the cylinder, on the axis
    (r = 0) and just off it (r < 1e-6), on radial nodes, past the last bin,
    and on the two cap planes."""
    rng = np.random.default_rng(2)
    p = rng.uniform(-0.3, 2 * RADIUS + 0.3, (60, 3))
    p[:, 1] = rng.uniform(-0.2, LENGTH + 0.2, 60)
    p[0:4, 0] = p[0:4, 2] = RADIUS                   # on the axis
    p[4:6, 0] = RADIUS + 3e-7                        # within 1e-6 of it
    p[4:6, 2] = RADIUS
    h = RADIUS / (RES - 1)
    p[6:12, 0] = RADIUS + h * np.arange(1, 7)        # on radial nodes
    p[6:12, 2] = RADIUS
    p[12:16, 0] = RADIUS + np.array([1.0, 1.05, 1.3, 1.6])  # at and past the last bin
    p[12:16, 2] = RADIUS
    p[16:20, 1] = 0.0                                # on the caps
    p[20:24, 1] = LENGTH
    return p


def test_field_functions_match_jax(scene):
    prof = scene[0]
    p = _points()
    rng = np.random.default_rng(3)
    mask = rng.uniform(size=p.shape[0]) < 0.7
    mu = rng.standard_normal(p.shape)
    vel = rng.standard_normal(p.shape)
    val, grad = rng.standard_normal(p.shape[0]), rng.standard_normal(p.shape)
    jf = JC.CylinderField(jnp.asarray(prof), RADIUS, LENGTH)
    tf = _field(prof)
    jp, tp = jnp.asarray(p), torch.from_numpy(p)
    for m in (None, mask):
        jm = None if m is None else jnp.asarray(m)
        tm = None if m is None else torch.from_numpy(m)
        want_n, want_g = JC.cyl_eval_grad(jf, jp, jm)
        got_n, got_g = TC.cyl_eval_grad(tf, tp, tm)
        _close(got_n, want_n, 1e-12)
        _close(got_g, want_g, 1e-12)
        want_h = JC.cyl_eval_hess(jf, jp, jm)
        got_h = TC.cyl_eval_hess(tf, tp, tm)
        for a, b in zip(got_h, want_h):
            _close(a, b, 1e-12)
        _close(TC.cyl_hess_matvec(got_h, torch.from_numpy(mu)),
               JC.cyl_hess_matvec(want_h, jnp.asarray(mu)), 1e-12)
        _close(TC.cyl_splat_delta(tf, tp, torch.from_numpy(val), torch.from_numpy(grad), tm),
               JC.cyl_splat_delta(jf, jp, jnp.asarray(val), jnp.asarray(grad), jm), 1e-12)
    assert float(np.abs(np.asarray(JC.cyl_eval_grad(jf, jp)[1][:6])).max()) == 0.0  # the axis
    assert torch.equal(TC.cyl_inbounds(tf, tp), torch.from_numpy(np.array(
        JC.cyl_inbounds(jf, jp))))
    assert torch.equal(TC.cyl_escaped(tf, tp, torch.from_numpy(vel)), torch.from_numpy(
        np.array(JC.cyl_escaped(jf, jp, jnp.asarray(vel)))))
    tprof = torch.from_numpy(prof)
    _close(TC.upres_profile(tprof, 33), JC.upres_profile(jnp.asarray(prof), 33), 1e-12)
    _close(TC.upres_profile_midpoint(tprof), JC.upres_profile_midpoint(jnp.asarray(prof)), 1e-12)
    _close(TC.cyl_render(tf, (5, 4, 6)), JC.cyl_render(jf, (5, 4, 6)), 1e-12)
    _close(TC.cyl_render2(tf, 7), JC.cyl_render2(jf, 7), 1e-12)


def test_splat_is_the_transpose_of_eval(scene):
    """<splat(val, grad), u> == val * n_u(p) + grad . grad_u(p) for any profile u."""
    p = torch.from_numpy(_points())
    rng = np.random.default_rng(4)
    u = torch.from_numpy(rng.standard_normal(RES))
    val = torch.from_numpy(rng.standard_normal(p.shape[0]))
    grad = torch.from_numpy(rng.standard_normal(tuple(p.shape)))
    delta = TC.cyl_splat_delta(_field(scene[0]), p, val, grad)
    n, g = TC.cyl_eval_grad(TC.CylinderField(u, RADIUS, LENGTH), p)
    want = (val * n).sum() + (grad * g).sum()
    assert abs(float(delta @ u - want)) <= 1e-12 * float(abs(want))


def _port(fn, scene, with_d2=False, rays=slice(None), target=None):
    prof, x, v, tgt = scene
    r = torch.from_numpy(prof).requires_grad_(True)
    tg = torch.from_numpy(tgt[rays]) if target is None else target
    xt, vt, d2 = fn(r, RADIUS, LENGTH, torch.from_numpy(x[rays]), torch.from_numpy(v[rays]),
                    tg, DS)
    w = torch.linspace(1.0, 2.0, x.shape[0], dtype=torch.float64)[rays]
    (_loss(xt, vt, d2, w) if with_d2 else _loss(xt, vt)).backward()
    return xt.detach(), vt.detach(), d2.detach(), r.grad


def test_the_scene_has_every_kind_of_ray(scene):
    prof, x, v, tgt = scene
    assert STEPS == 204 and STEPS % SEG
    xt, vt, d2, c, ck = TCK._fwd_ckpts_cable(_field(prof), torch.from_numpy(x),
                                             torch.from_numpy(v), torch.from_numpy(tgt), DS,
                                             STEPS, SEG)
    assert ck.shape == (-(-STEPS // SEG), 7, 250)
    assert bool((c[:180] > SEG).all()) and int(c[:180].max()) < STEPS  # captured mid-flight
    assert bool((c[180:200] == 0).all())  # moved away at once: the start is the closest
    d0 = TE.sum_sq3(torch.from_numpy(x - tgt))
    assert torch.equal(d2[180:200], d0[180:200])
    assert bool((c[200:220] > 0).all()) and bool((c[-N_AXIS:] > 0).all())
    # the axis rays stay on it
    assert bool((xt[-N_AXIS:, 0] == RADIUS).all() & (xt[-N_AXIS:, 2] == RADIUS).all())


def test_trace_cable_matches_jax(scene, jax_refs):
    xt, vt, d2, g = _port(TT.trace_cable, scene)
    for got, want in zip((xt, vt, d2), jax_refs["fwd"]):
        _close(got, want, 1e-12)
    _close(g, jax_refs["grad"], 1e-9)
    assert np.abs(jax_refs["grad"]).max() > 0


def test_the_dist2_cotangent_does_not_reach_the_profile(scene, jax_refs):
    """A loss with a term in ``dist2``: the gradient is the one without it,
    bit for bit, as the JAX rule drops that cotangent."""
    _, _, _, g = _port(TT.trace_cable, scene)
    _, _, _, g_d2 = _port(TT.trace_cable, scene, with_d2=True)
    assert torch.equal(g, g_d2)
    _close(g_d2, jax_refs["grad_d2"], 1e-9)
    np.testing.assert_array_equal(jax_refs["grad_d2"], jax_refs["grad"])


def test_one_target_for_every_ray(scene):
    """A (3,) target is every ray's: the same as the (N, 3) stack of it."""
    prof, x, v, _ = scene
    one = torch.tensor([RADIUS, 0.8 * LENGTH, RADIUS], dtype=torch.float64)
    got = _port(TT.trace_cable, scene, target=one)
    want = _port(TT.trace_cable, scene, target=one.expand(x.shape[0], 3).clone())
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_trace_cable_ad_matches_jax(scene, jax_refs):
    prof, x, v, tgt = scene
    out = TT.trace_cable_ad(torch.from_numpy(prof), RADIUS, LENGTH, torch.from_numpy(x),
                            torch.from_numpy(v), torch.from_numpy(tgt), DS)
    for got, want in zip(out, jax_refs["ad_fwd"]):
        _close(got, want, 1e-12)
    off_axis = slice(0, x.shape[0] - N_AXIS)
    _, _, _, g = _port(TT.trace_cable_ad, scene, rays=off_axis)
    _close(g, jax_refs["ad_grad"], 1e-9)
    # the tape and the adjoint trace the same rays
    for a, b in zip(out, _port(TT.trace_cable, scene)[:3]):
        assert torch.equal(a.detach(), b)


@pytest.mark.parametrize("chunk", ["0", CHUNK])
def test_trace_cable_exact_matches_jax(scene, jax_refs, chunk, monkeypatch):
    """Whole and split into chunks of ``ANRT_EXACT_CHUNK`` rays, against the
    JAX package's whole batch; the forward pass is the adjoint's bit for bit."""
    monkeypatch.setenv("ANRT_EXACT_CHUNK", chunk)
    exact = lambda *a: TT.trace_cable_exact(*a, SEG)  # noqa: E731
    xt, vt, d2, g = _port(exact, scene)
    for got, want in zip((xt, vt, d2), jax_refs["exact_fwd"]):
        _close(got, want, 1e-12)
    _close(g, jax_refs["exact_grad"], 1e-9)
    for a, b in zip((xt, vt, d2), _port(TT.trace_cable, scene)[:3]):
        assert torch.equal(a, b)
    # a term in dist2 does not reach the profile here either
    assert torch.equal(_port(exact, scene, with_d2=True)[3], g)


def test_trace_cable_exact_equals_the_tape(scene):
    """The exact claim: autograd through the plain stepper, on the rays off the
    axis (the tape's sqrt has no gradient at r = 0)."""
    off_axis = slice(0, 250 - N_AXIS)
    _, _, _, g = _port(lambda *a: TT.trace_cable_exact(*a, SEG), scene, rays=off_axis)
    _, _, _, g_ad = _port(TT.trace_cable_ad, scene, rays=off_axis)
    _close(g, g_ad, 1e-11)


def test_checkpoints_and_f64_sums(scene):
    """The checkpoint stack is ``(nseg, 7, N)`` of ``(x, v, esc)`` (K9 writes it
    so, K10 reads it so); the adjoints sum float32 terms in float64 on request,
    and the stats count the gated-on steps."""
    prof, x, v, tgt = scene
    f = _field(prof)
    xs, vs, ts = (torch.from_numpy(a) for a in (x, v, tgt))
    xt, vt, d2, c, ck = TCK._fwd_ckpts_cable(f, xs, vs, ts, DS, STEPS, SEG)
    assert torch.equal(ck[0, :3], xs.T) and torch.equal(ck[0, 3:6], vs.T)
    assert not bool(ck[0, 6].any())
    live = c > SEG  # rays still moving after one segment
    x1 = xs[live].clone()
    v1 = vs[live].clone()
    for _ in range(SEG):
        x1, v1 = TE.cable_step(f, x1, v1, torch.ones(int(live.sum()), dtype=torch.bool),
                               torch.tensor(DS, dtype=torch.float64))
    assert torch.equal(ck[1, :3].T[live], x1)
    dxt, dvt = 2 * xt, torch.ones_like(vt)
    st = {}
    g = TCK.backtrace_cable_plain(f, xs, vs, ts, c, ck, dxt, dvt, DS, SEG, stats=st)
    assert st["ray_steps"] == st["splats"] == int(c.sum())
    f32 = TC.CylinderField(f.data.float(), RADIUS, LENGTH)
    g64 = TCK.backtrace_cable_plain(f32, xs.float(), vs.float(), ts.float(), c, ck.float(),
                                    dxt.float(), dvt.float(), DS, SEG, acc_dtype=torch.float64)
    assert g64.dtype == torch.float64
    _close(g64, g.numpy(), 1e-4)
    bst = {}
    gb = TE.backtrace_cable(f32, xt.float(), vt.float(), dxt.float(), dvt.float(), DS, STEPS,
                            stats=bst, acc_dtype=torch.float64)
    assert gb.dtype == torch.float64 and 0 < bst["splats"] <= bst["ray_steps"]


def test_cable_kernels_refuse_cpu_tensors(scene):
    prof, x, v, tgt = (torch.from_numpy(a) for a in scene)
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.trace_cable(prof, RADIUS, LENGTH, x, v, tgt, DS, STEPS)
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.backtrace_cable(prof, RADIUS, LENGTH, x, v, x, v, DS, STEPS, 1e-9)
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.trace_cable_ckpt(prof, RADIUS, LENGTH, x, v, tgt, DS, STEPS, SEG)
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.backtrace_cable_exact(prof, RADIUS, LENGTH, torch.zeros(13, 7, 250),
                                torch.zeros(250, dtype=torch.int32), x, v, DS, SEG)
    assert all(K.LAUNCHES[k] == 0 for k in ("trace_cable", "backtrace_cable",
                                             "trace_cable_ckpt", "backtrace_cable_exact"))


@pytest.mark.parametrize("dtype, last_columns", [(torch.float32, 854), (torch.float64, 807)])
def test_k8_takes_columns_while_a_block_of_them_fits_shared_memory(dtype, last_columns):
    """K8's path follows from the profile's size and type alone: a column a
    lane of its 32-lane block plus the per-bin table (16 or 32 bytes a bin)
    within the 232,448 bytes a block may have; above that one gradient a
    block, which every profile the cable kernels take fits."""
    item = torch.empty((), dtype=dtype).element_size()
    assert K.cable_shared_bytes(last_columns, dtype, K.CABLE_COLUMN_THREADS) \
        <= K.SHARED_BYTES_MAX < K.cable_shared_bytes(last_columns + 1, dtype,
                                                     K.CABLE_COLUMN_THREADS)
    assert K.backtrace_cable_path(129, dtype) == "columns"
    assert K.backtrace_cable_path(last_columns, dtype) == "columns"
    assert K.backtrace_cable_path(last_columns + 1, dtype) == "block"
    assert K.cable_shared_bytes(1025, dtype, 1) == 1025 * (4 * item + 8) <= K.SHARED_BYTES_MAX
