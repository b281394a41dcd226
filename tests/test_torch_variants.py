"""The port's trace variants (plane, target, sdf), their tapes, ``sdf_utils``
and ``compat`` against the JAX package.

CPU, f64 (conftest enables x64).  Inputs are numpy arrays made from seeds and
handed to both sides.  Tolerances, relative to the reference's largest
magnitude: forward outputs and the field functions ``1e-12`` (the same f64
arithmetic; the JAX API's window stepper contracts in another order);
gradients ``1e-9`` (splats summed in another order).  Each JAX reference is
jitted and computed once per module.  On the CPU every function runs its
plain version; the kernels K11-K14 are held against these plain versions on
the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from adjointnonlinearraytracing_tpu import compat as JCOMPAT
from adjointnonlinearraytracing_tpu.fields import grid as JG
from adjointnonlinearraytracing_tpu.fields import sdf_utils as JSDF
from adjointnonlinearraytracing_tpu.tracer import api as JA
from adjointnonlinearraytracing_tpu.tracer import eikonal as JE
from adjointnonlinearraytracing_tpu_torch import compat as TCOMPAT
from adjointnonlinearraytracing_tpu_torch import tracer as TT
from adjointnonlinearraytracing_tpu_torch.fields import grid as TG
from adjointnonlinearraytracing_tpu_torch.fields import sdf_utils as TSDF
from adjointnonlinearraytracing_tpu_torch.kernels import wrappers as K
from adjointnonlinearraytracing_tpu_torch.tracer import api as TA
from adjointnonlinearraytracing_tpu_torch.tracer import eikonal as TE

RES, SPAN = 9, 1.0
H = SPAN / (RES - 1)
DS = H / 2
STEPS = TE.max_steps_fwd(RES, H, DS)        # 72
SDF_STEPS = TA.sdf_steps((RES,) * 3, H, DS)  # 36
N_SLOW = 6  # the last rays crawl: they never escape (miss), the horizon is max_steps


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, np.abs(want).max()))


def _coords():
    z, y, x = np.meshgrid(*[np.arange(RES) * H] * 3, indexing="ij")
    return x, y, z


def _rif():
    x, y, z = _coords()
    bump = np.exp(-((x - 0.5) ** 2 + (y - 0.45) ** 2 + (z - 0.55) ** 2) / 0.08)
    return 1.0 + 0.1 * bump + 0.01 * np.random.default_rng(0).uniform(size=(RES,) * 3)


def _sphere_sdf():
    """Distance to the sphere of radius 0.4 * span about the centre, in voxel units."""
    x, y, z = _coords()
    return (np.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2) - 0.4 * SPAN) / H


def _rays():
    """200 rays: most enter through the y = 0 face heading +y, some start past
    their plane, some start outside the grid heading away; the last
    ``N_SLOW`` crawl inside and never escape."""
    rng = np.random.default_rng(1)
    n = 200
    x = np.stack([rng.uniform(0.1, 0.9, n), np.full(n, -0.05), rng.uniform(0.1, 0.9, n)], -1)
    v = np.stack([0.2 * rng.standard_normal(n), np.ones(n), 0.2 * rng.standard_normal(n)], -1)
    x[150:160, 1] = rng.uniform(0.65, 0.8, 10)     # past the plane, inside the grid
    x[160:170, 1] = 1.2                            # outside, moving away
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    x[-N_SLOW:] = rng.uniform(0.3, 0.5, (N_SLOW, 3))
    v[-N_SLOW:] *= 1e-3
    pln_o = np.tile([0.0, 0.6 * SPAN, 0.0], (n, 1)) + 0.02 * rng.standard_normal((n, 3))
    pln_d = np.tile([0.0, 1.0, 0.0], (n, 1)) + 0.1 * rng.standard_normal((n, 3))
    tgt = np.tile([0.5, 1.3, 0.5], (n, 1)) + 0.05 * rng.standard_normal((n, 3))
    return x, v, pln_o, pln_d, tgt


def _late_target_rays():
    """The horizon case: fast rays whose target lies past the grid on their
    way, and one slow ray that escapes long after them."""
    rng = np.random.default_rng(3)
    n = 40
    x = np.stack([rng.uniform(0.3, 0.7, n), np.full(n, 0.02), rng.uniform(0.3, 0.7, n)], -1)
    v = np.stack([0.1 * rng.standard_normal(n), np.ones(n), 0.1 * rng.standard_normal(n)], -1)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    tgt = x + 1.6 * v  # 0.6 past the far face
    x[0], v[0] = [0.5, 0.1, 0.5], [0.0, 0.3, 0.0]  # reaches the far face after ~48 steps
    return x, v, tgt


def _late_sdf():
    """The sdf's late crossing: a half-space sdf (x < 0.5 inside) that reaches
    the y = 0 face, rays that leave the grid through it while still inside and
    drift in +x across x = 0.5 afterwards, and a slow ray that holds the
    batch's loop open meanwhile."""
    x, _, _ = _coords()
    sdf = (x - 0.5 * SPAN) / H
    rng = np.random.default_rng(4)
    n = 20
    x0 = np.stack([rng.uniform(0.2, 0.35, n), rng.uniform(0.15, 0.3, n),
                   rng.uniform(0.3, 0.7, n)], -1)
    v0 = np.stack([np.full(n, 0.3), -np.ones(n), 0.05 * rng.standard_normal(n)], -1)
    v0 /= np.linalg.norm(v0, axis=-1, keepdims=True)
    x0[-1], v0[-1] = [0.3, 0.5, 0.5], [0.0, 0.1, 0.0]
    return sdf, x0, v0


def _sdf_samples():
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(7), (150, 3)))


def _loss(xt, vt):
    return (xt ** 2 + xt * vt).sum()


@pytest.fixture(scope="module")
def scene():
    return (_rif(), *_rays())


@pytest.fixture(scope="module")
def sdf_scene():
    sdf = _sphere_sdf()
    pos, vel = jax.jit(lambda k, s: JSDF.get_pts_sdf(k, s, 150, SPAN))(jax.random.PRNGKey(7),
                                                                       jnp.asarray(sdf))
    return sdf, np.asarray(pos), np.asarray(vel)


def _loss_cotangents(xt, vt):
    """d(_loss)/d(xt), d(_loss)/d(vt)."""
    return 2 * xt + vt, xt


@pytest.fixture(scope="module")
def jax_refs(scene, sdf_scene):
    """The JAX functions' outputs and gradients, jitted, once: each API
    function's forward pass and one VJP taking the cotangents as arguments
    (the loss's, and the plane's miss case).  The JAX API runs its cell-table
    stepper (``ANRT_FAST_PATH=classic``, the eikonal steppers' numbers), which
    compiles four times faster here than its window stepper."""
    mp = pytest.MonkeyPatch()
    mp.setenv("ANRT_FAST_PATH", "classic")
    try:
        return _jax_refs(scene, sdf_scene)
    finally:
        mp.undo()


def _jax_refs(scene, sdf_scene):
    rif, x, v, o, d, tgt = (jnp.asarray(a) for a in scene)
    sdf, xs, vs = (jnp.asarray(a) for a in sdf_scene)
    lx, lv, ltgt = (jnp.asarray(a) for a in _late_target_rays())
    ssdf, sx, sv = (jnp.asarray(a) for a in _late_sdf())
    w = jnp.linspace(0.5, 1.5, x.shape[0])
    calls = {
        "plane": lambda r: JA.trace_plane(r, x, v, o, d, H, DS),
        "target": lambda r: JA.trace_target(r, x, v, tgt, H, DS),
        "sdf": lambda r: JA.trace_sdf(r, sdf, xs, vs, H, DS),
        "plane_ad": lambda r: JA.trace_plane_ad(r, x, v, o, d, H, DS),
        "target_ad": lambda r: JA.trace_target_ad(r, x, v, tgt, H, DS),
        "sdf_ad": lambda r: JA.trace_sdf_ad(r, sdf, xs, vs, H, DS),
    }
    out = {}
    for name, call in calls.items():
        fwd = jax.jit(call)(rif)
        vjp = jax.jit(lambda r, cx, cv, call=call: jax.vjp(lambda q: call(q)[:2], r)[1]((cx, cv))[0])
        out[name] = fwd
        out[f"{name}_grad"] = (_loss(fwd[0], fwd[1]), vjp(rif, *_loss_cotangents(*fwd[:2])))
        if name == "plane":
            # a loss of the missed rays' xt alone (it must pass no gradient) and of their vt
            miss = fwd[2].astype(rif.dtype)[:, None]
            out["plane_grad_miss"] = vjp(rif, 2 * (w[:, None] * miss) * fwd[0],
                                         jnp.broadcast_to(miss, fwd[1].shape))
    out["late"] = jax.jit(lambda r: JE.trace_target(JG.GridField(r, H), lx, lv, ltgt, DS,
                                                    STEPS))(rif)
    out["late_api"] = jax.jit(lambda r: JA.trace_target(r, lx, lv, ltgt, H, DS))(rif)
    out["late_sdf"] = jax.jit(lambda r: JE.trace_sdf(JG.GridField(r, H), JG.GridField(ssdf, H),
                                                     sx, sv, DS, SDF_STEPS))(rif)
    return jax.tree_util.tree_map(np.asarray, out)


def _port_grad(fn, rif, *args):
    r = _t(rif).requires_grad_(True)
    out = fn(r, *args)
    loss = _loss(out[0], out[1])
    loss.backward()
    return out, float(loss.detach()), r.grad


def test_trace_plane_matches_jax(scene, jax_refs):
    rif, x, v, o, d, _ = scene
    xt, vt, miss = TT.trace_plane(_t(rif), _t(x), _t(v), _t(o), _t(d), H, DS)
    want = jax_refs["plane"]
    _close(xt, want[0], 1e-12)
    _close(vt, want[1], 1e-12)
    assert miss.dtype == torch.bool and np.array_equal(miss.numpy(), want[2])
    assert miss[-N_SLOW:].any() and not miss[:-N_SLOW].any()
    # the rays that start past their plane stop at the first step
    assert not np.allclose(xt[150:160].numpy(), x[150:160])
    # the plain stepper alone (no API) and a (3,) plane for every ray
    f = TG.GridField(_t(rif), H)
    got = TE.trace_plane(f, _t(x), _t(v), _t(o), _t(d), DS, STEPS)
    assert all(torch.equal(a, b) for a, b in zip(got, (xt, vt, miss)))
    one = TT.trace_plane(_t(rif), _t(x), _t(v), _t(o[0]), _t(d[0][None]), H, DS)
    ref = JE.trace_plane(JG.GridField(jnp.asarray(rif), H), jnp.asarray(x), jnp.asarray(v),
                         jnp.broadcast_to(jnp.asarray(o[0]), x.shape),
                         jnp.broadcast_to(jnp.asarray(d[0]), x.shape), DS, STEPS)
    _close(one[0], ref[0], 1e-12)


def test_trace_plane_gradient_matches_jax(scene, jax_refs):
    rif, x, v, o, d, _ = scene
    (_, _, _), loss, g = _port_grad(TT.trace_plane, rif, _t(x), _t(v), _t(o), _t(d), H, DS)
    want_loss, want = jax_refs["plane_grad"]
    assert abs(loss - float(want_loss)) <= 1e-12 * abs(float(want_loss))
    _close(g, want, 1e-9)


def test_plane_miss_zeroes_only_the_position_cotangent(scene, jax_refs):
    """A missed ray's ``xt`` passes no gradient, its ``vt`` does."""
    rif, x, v, o, d, _ = scene
    w = torch.linspace(0.5, 1.5, x.shape[0], dtype=torch.float64)
    r = _t(rif).requires_grad_(True)
    xt, vt, miss = TT.trace_plane(r, _t(x), _t(v), _t(o), _t(d), H, DS)
    ((xt ** 2).sum(-1) @ (w * miss) + vt.sum(-1) @ miss.double()).backward()
    _close(r.grad, jax_refs["plane_grad_miss"], 1e-9)
    assert float(r.grad.abs().max()) > 0
    r2 = _t(rif).requires_grad_(True)
    xt, vt, miss = TT.trace_plane(r2, _t(x), _t(v), _t(o), _t(d), H, DS)
    ((xt ** 2).sum(-1) @ (w * miss)).backward()
    assert float(r2.grad.abs().max()) == 0.0


def test_trace_target_matches_jax(scene, jax_refs):
    rif, x, v, _, _, tgt = scene
    (xt, vt, d2), loss, g = _port_grad(TT.trace_target, rif, _t(x), _t(v), _t(tgt), H, DS)
    want = jax_refs["target"]
    for got, ref in zip((xt, vt, d2), want):
        _close(got, ref, 1e-12)
    assert not d2.requires_grad
    want_loss, want_g = jax_refs["target_grad"]
    assert abs(loss - float(want_loss)) <= 1e-12 * abs(float(want_loss))
    _close(g, want_g, 1e-9)
    stats = {}
    TE.trace_target(TG.GridField(_t(rif), H), _t(x), _t(v), _t(tgt), DS, STEPS, stats=stats)
    assert stats["horizon"] == STEPS  # the crawling rays never escape


def test_trace_target_horizon_is_the_batch_s(scene, jax_refs):
    """A ray's closest approach depends on when the last ray of its batch
    escaped: with the slow ray in the batch the fast rays keep going
    (straight, outside the grid) and get closer to their targets."""
    rif = scene[0]
    x, v, tgt = _late_target_rays()
    f = TG.GridField(_t(rif), H)
    stats = {}
    got = TE.trace_target(f, _t(x), _t(v), _t(tgt), DS, STEPS, stats=stats)
    for a, b in zip(got, jax_refs["late"]):
        _close(a, b, 1e-12)
    for a, b in zip(TT.trace_target(_t(rif), _t(x), _t(v), _t(tgt), H, DS), jax_refs["late_api"]):
        _close(a, b, 1e-12)
    assert 20 < stats["horizon"] < STEPS and stats["ballistic_steps"] > 0
    fast = TE.trace_target(f, _t(x[1:]), _t(v[1:]), _t(tgt[1:]), DS, STEPS)
    assert bool((got[2][1:] < fast[2]).all())
    tape = TE.trace_target_scan(f, _t(x), _t(v), _t(tgt), DS, STEPS)
    assert all(torch.equal(a, b) for a, b in zip(tape, got))


# K12's and K16's retirement rule (wrappers.target_retired_plain): an escaped
# ray (outside the grid, n = 0: a straight line) stops once every axis
# recedes from its target or stands still, because no later step can come
# strictly closer.  Held here on lines stepped with the port's own
# forward_step, the eval masked as it is for an escaped ray.
LINE_RES, LINE_STEPS = 17, 160


def _escaped_lines(n, dtype, seed):
    """``n`` rays outside a 17^3 grid of span 1, each moving away from it on
    one axis, with zero and tiny (subnormal) velocity components, rays on
    their target's coordinate on an axis, rays headed for their target's
    coordinate that pass it later, and targets inside and outside the grid."""
    rng = np.random.default_rng(seed)
    tiny = float(torch.finfo(dtype).tiny)
    rows = np.arange(n)
    x = rng.uniform(-0.5, 1.5, (n, 3))
    v = rng.standard_normal((n, 3))
    inner = rng.uniform(size=(n, 1)) < 0.5
    tgt = np.where(inner, rng.uniform(0.0, 1.0, (n, 3)), rng.uniform(-1.0, 2.0, (n, 3)))
    away, below = rng.integers(0, 3, n), rng.uniform(size=n) < 0.5
    x[rows, away] = np.where(below, -0.05 - 0.5 * rng.uniform(size=n),
                             1.05 + 0.5 * rng.uniform(size=n))
    v[rows, away] = np.where(below, -1.0, 1.0) * (0.1 + np.abs(v[rows, away]))
    other, kind = (away + 1 + rng.integers(0, 2, n)) % 3, rng.integers(0, 5, n)
    vo = v[rows, other]
    vo = np.where(kind == 0, 0.0, vo)                                   # standing still
    vo = np.where(kind == 1, tiny * rng.uniform(-8.0, 8.0, n), vo)      # tiny, subnormal too
    x[rows, other] = np.where(kind == 2, tgt[rows, other], x[rows, other])  # on the target's
    vo = np.where(kind == 3, np.sign(tgt[rows, other] - x[rows, other])  # headed past it
                  * (0.3 + np.abs(vo)), vo)
    v[rows, other] = vo
    return tuple(torch.from_numpy(a).to(dtype) for a in (x, v, tgt))


def _straight_steps(x, v, tgt, steps):
    """Each step's squared distance to the target and the retirement rule,
    ``(steps + 1, N)`` each, the rays stepped with ``forward_step`` masked."""
    field = TG.GridField(torch.ones((LINE_RES,) * 3, dtype=x.dtype), 1.0 / (LINE_RES - 1))
    ds_t = TG._scalar(0.5 / (LINE_RES - 1), x)
    outside = torch.zeros((x.shape[0],), dtype=torch.bool)
    d2, rule = [], []
    for _ in range(steps + 1):
        d2.append(TE.sum_sq3(x - tgt))
        rule.append(K.target_retired_plain(x, v, tgt))
        x, v = TE.forward_step(field, x, v, outside, ds_t)
    return torch.stack(d2), torch.stack(rule)


def _closer_after_retirement(d2, rule):
    """The rays, among those the rule retires, with a step at or after their
    first retired one strictly closer than the running minimum there; and
    those whose rule turns false again after it held."""
    has = rule.any(dim=0)
    first = rule.int().argmax(dim=0)
    k = torch.arange(d2.shape[0])[:, None]
    after = (k >= first[None, :]) & has[None, :]
    best = torch.cummin(d2, dim=0).values.gather(0, first[None, :])
    closer = (after & (d2 < best)).any(dim=0)
    unretired = (after & ~rule).any(dim=0)
    return closer, unretired, has, first


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_target_retired_rays_come_no_closer(dtype):
    x, v, tgt = _escaped_lines(1000, dtype, seed=11)
    assert bool(TG.escaped(TG.GridField(torch.ones((LINE_RES,) * 3, dtype=dtype),
                                        1.0 / (LINE_RES - 1)), x, v).all())
    d2, rule = _straight_steps(x, v, tgt, LINE_STEPS)
    closer, unretired, has, first = _closer_after_retirement(d2, rule)
    assert not bool(closer.any()) and not bool(unretired.any())
    # the rule bites, and not only at once: rays that pass their target's
    # coordinate retire after it (the rest creep toward it too slowly)
    assert int(has.sum()) > 800 and int((first > 10).sum()) > 400


_COORD = {dt: st.one_of(st.floats(-3.0, 3.0, width=w),
                        st.sampled_from([0.0, -0.0, float(torch.finfo(dt).tiny),
                                         -float(torch.finfo(dt).tiny), 1e-45 if w == 32
                                         else 5e-324]))
          for dt, w in ((torch.float32, 32), (torch.float64, 64))}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@settings(max_examples=150, deadline=None, derandomize=True, database=None)
@given(data=st.data())
def test_target_retirement_property(dtype, data):
    coord = _COORD[dtype]
    x, v, tgt = (torch.tensor([[data.draw(coord) for _ in range(3)]], dtype=dtype)
                 for _ in range(3))
    if data.draw(st.booleans()):  # on the target's coordinate on one axis
        k = data.draw(st.integers(0, 2))
        x[0, k] = tgt[0, k]
    d2, rule = _straight_steps(x, v, tgt, 60)
    closer, unretired, _, _ = _closer_after_retirement(d2, rule)
    assert not bool(closer.any()) and not bool(unretired.any())


def test_trace_sdf_matches_jax(scene, sdf_scene, jax_refs):
    rif = scene[0]
    sdf, xs, vs = sdf_scene
    (xt, vt), loss, g = _port_grad(lambda r, *a: TT.trace_sdf(r, _t(sdf), *a), rif, _t(xs),
                                   _t(vs), H, DS)
    for got, ref in zip((xt, vt), jax_refs["sdf"]):
        _close(got, ref, 1e-12)
    want_loss, want_g = jax_refs["sdf_grad"]
    assert abs(loss - float(want_loss)) <= 1e-12 * abs(float(want_loss))
    _close(g, want_g, 1e-9)
    assert float(g.abs().max()) > 0
    # every ray crossed the sphere on the far side
    assert not np.allclose(xt.detach().numpy(), xs)


def test_trace_sdf_late_crossing(scene, jax_refs):
    """Rays that leave the grid while still inside the sdf keep stepping (the
    field read at clamped corners) and cross it later, while the batch runs."""
    rif = scene[0]
    sdf, x0, v0 = _late_sdf()
    stats = {}
    got = TE.trace_sdf(TG.GridField(_t(rif), H), TG.GridField(_t(sdf), H), _t(x0), _t(v0), DS,
                       SDF_STEPS, stats=stats)
    for a, b in zip(got, jax_refs["late_sdf"]):
        _close(a, b, 1e-12)
    assert stats["late_steps"] > 0
    crossed_late = (got[0][:-1, 1] < 0) & (got[0][:-1, 0] >= 0.5)
    assert bool(crossed_late.any())


def test_backtrace_sdf_matches_jax(scene, sdf_scene):
    rif = scene[0]
    sdf, xs, vs = sdf_scene
    jf, jsdf = JG.GridField(jnp.asarray(rif), H), JG.GridField(jnp.asarray(sdf), H)
    xt, vt = JE.trace_sdf(jf, jsdf, jnp.asarray(xs), jnp.asarray(vs), DS, SDF_STEPS)
    rng = np.random.default_rng(5)
    dx, dv = rng.standard_normal((2, xs.shape[0], 3))
    steps = TE.max_steps_bwd(RES, H, DS)
    want = jax.jit(lambda r: JE.backtrace_sdf(JG.GridField(r, H), jsdf, xt, vt, jnp.asarray(dx),
                                              jnp.asarray(dv), DS, steps))(jnp.asarray(rif))
    stats = {}
    got = TE.backtrace_sdf(TG.GridField(_t(rif), H), TG.GridField(_t(sdf), H), _t(xt), _t(vt),
                           _t(dx), _t(dv), DS, steps, stats=stats)
    _close(got, want, 1e-9)
    # the sdf rule stops rays where they cross out going back: fewer steps than
    # the plain sweep takes from the same state
    plain = {}
    TE.backtrace(TG.GridField(_t(rif), H), _t(xt), _t(vt), _t(dx), _t(dv), DS, steps, stats=plain)
    assert 0 < stats["ray_steps"] < plain["ray_steps"]
    assert stats["flushes"] > 0


def test_sdf_gets_a_zero_cotangent(scene, sdf_scene):
    rif = scene[0]
    sdf, xs, vs = sdf_scene
    r, s = _t(rif).requires_grad_(True), _t(sdf).requires_grad_(True)
    xt, vt = TT.trace_sdf(r, s, _t(xs), _t(vs), H, DS)
    _loss(xt, vt).backward()
    assert s.grad is not None and float(s.grad.abs().max()) == 0.0
    assert float(r.grad.abs().max()) > 0
    with pytest.raises(ValueError, match="must match rif"):
        TT.trace_sdf(_t(rif), _t(sdf)[:-1], _t(xs), _t(vs), H, DS)


@pytest.mark.parametrize("variant", ["plane", "target", "sdf"])
def test_tape_twins_match_jax(variant, scene, sdf_scene, jax_refs):
    rif, x, v, o, d, tgt = scene
    sdf, xs, vs = sdf_scene
    fn, args = {
        "plane": (TT.trace_plane_ad, (_t(x), _t(v), _t(o), _t(d), H, DS)),
        "target": (TT.trace_target_ad, (_t(x), _t(v), _t(tgt), H, DS)),
        "sdf": (lambda r, *a: TT.trace_sdf_ad(r, _t(sdf), *a), (_t(xs), _t(vs), H, DS)),
    }[variant]
    out, loss, g = _port_grad(fn, rif, *args)
    for got, ref in zip(out, jax_refs[f"{variant}_ad"]):
        _close(got.detach().double(), ref.astype(np.float64), 1e-12)
    want_loss, want_g = jax_refs[f"{variant}_ad_grad"]
    assert abs(loss - float(want_loss)) <= 1e-12 * abs(float(want_loss))
    _close(g, want_g, 1e-9)


def test_variant_wrappers_refuse_cpu_tensors(scene):
    rif, x, v, o, d, tgt = (_t(a) for a in scene)
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.trace_plane(rif, H, x, v, o, d, DS, STEPS)
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.trace_target(rif, H, x, v, tgt, DS, STEPS)
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.trace_sdf(rif, rif, H, x, v, DS, STEPS)
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.backtrace_sdf(rif, rif, H, x, v, x, v, DS, STEPS, 1e-9)
    assert all(K.LAUNCHES[k] == 0 for k in ("trace_plane", "trace_target", "trace_sdf",
                                            "backtrace_sdf"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_trace_sdf_wrapper_hands_the_kernel_node_pairs(scene, dtype, monkeypatch):
    """K13 reads the grid and the sdf as one ``(D, H, W, 2)`` grid of node
    pairs (``wrappers.node_pairs``): node ``(z, y, x)``'s grid value at flat
    element ``2 * ((z * H + y) * W + x)``, its sdf value next to it.  The
    wrapper makes the pairs at each call and hands both passes their
    address (the grid's device check and the launch stubbed out)."""
    rif = torch.from_numpy(np.random.default_rng(0).random((5, 4, 3))).to(dtype)
    sdf = -rif * 2.0 + 0.5
    pairs = K.node_pairs(rif, sdf)
    assert pairs.shape == (5, 4, 3, 2) and pairs.dtype == dtype and pairs.is_contiguous()
    flat = pairs.reshape(-1)
    assert torch.equal(flat[0::2], rif.reshape(-1)) and torch.equal(flat[1::2], sdf.reshape(-1))
    z, y, x = 3, 2, 1
    assert flat[2 * ((z * 4 + y) * 3 + x)] == rif[z, y, x]
    assert flat[2 * ((z * 4 + y) * 3 + x) + 1] == sdf[z, y, x]
    _, xr, vr, *_ = (_t(a).to(dtype) for a in scene)
    made, launched = [], []
    monkeypatch.setattr(K, "_check_grid", lambda data, name: None)
    monkeypatch.setattr(K, "_launch_on_grid", lambda name, data, *args: launched.append(
        (name, args)))
    monkeypatch.setattr(K, "node_pairs", lambda a, b: made.append(torch.stack((a, b), -1))
                        or made[-1])
    K.trace_sdf(rif, sdf, H, xr, vr, DS, STEPS)
    assert len(made) == 1 and torch.equal(made[0], pairs)
    assert [name for name, _ in launched] == ["trace_sdf", "trace_sdf"]
    assert all(args[2] == made[0].data_ptr() and args[-1] == p
               for p, (_, args) in enumerate(launched, 1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_backtrace_sdf_wrapper_hands_the_kernel_a_float64_sum(scene, dtype, monkeypatch):
    """K14 adds in float64 whatever the grid's type (its run and warp sums are
    the grid's): the wrapper hands the kernel a zeroed float64 gradient and
    K3's path of a float64 one, and refuses an sdf, rays, an order or a
    tally that do not fit.  The grid's device check and the launch are
    stubbed out, so that the argument checks run on the CPU."""
    _, x, v, *_ = (_t(a).to(dtype) for a in scene)
    launched = []
    monkeypatch.setattr(K, "_check_grid", lambda data, name: None)
    monkeypatch.setattr(K, "_launch_on_grid", lambda name, data, *args: launched.append(
        (name, args)))
    n = x.shape[0]
    order = torch.arange(n, dtype=torch.int32).flip(0).contiguous()
    tally = torch.zeros(3, dtype=torch.int64)
    for res, path in ((RES, "shared"), (40, "global")):  # 40^3 doubles pass 227 KB
        rif = torch.ones((res, res, res), dtype=dtype)
        K.reset_launches()
        g = K.backtrace_sdf(rif, rif, H, x, v, x, v, DS, STEPS, 1e-9, order, tally)
        assert g.dtype == torch.float64 and g.shape == (res ** 3,) and not bool(g.any())
        name, args = launched[-1]
        assert name == "backtrace_sdf" and K.backtrace_path(rif.numel(), torch.float64) == path
        assert g.data_ptr() in args and order.data_ptr() in args and tally.data_ptr() in args
        assert args[-3:] == (n, STEPS, int(path == "shared"))
        assert K.BACKTRACE_SDF_PATHS == {"shared": int(path == "shared"),
                                         "global": int(path == "global")}
    rif = torch.ones((RES,) * 3, dtype=dtype)
    other = torch.float64 if dtype == torch.float32 else torch.float32
    bad = [dict(sdf=rif.to(other)), dict(sdf=rif[:-1].contiguous()), dict(xt=x.to(other)),
           dict(order=order.long()), dict(tally=torch.zeros(4, dtype=torch.int64))]
    for kw in bad:
        args = {**dict(sdf=rif, xt=x, order=order, tally=tally), **kw}
        with pytest.raises(ValueError):
            K.backtrace_sdf(rif, args["sdf"], H, args["xt"], v, x, v, DS, STEPS, 1e-9,
                            args["order"], args["tally"])
    assert len(launched) == 2


def test_compat_aliases_are_the_api():
    for name in ("ADTracerC", "ADPlaneTracerC", "ADSDFTracerC", "ADCableTracerC",
                 "BackTracerC", "BackPlaneTracerC", "BackTargetTracerC", "BackSDFTracerC",
                 "BackCableTracerC"):
        assert hasattr(JCOMPAT, name)
        assert getattr(TCOMPAT, name).__name__ == getattr(JCOMPAT, name).__name__
    assert TCOMPAT.BackPlaneTracerC is TT.trace_plane
    assert TCOMPAT.BackTargetTracerC is TT.trace_target
    assert TCOMPAT.BackSDFTracerC is TT.trace_sdf
    vol = np.random.default_rng(6).uniform(size=(5, 5, 5))
    want = jax.jit(lambda a: JCOMPAT.upres_volume(a, (7, 7, 7)))(jnp.asarray(vol))
    _close(TCOMPAT.upres_volume(_t(vol), (7, 7, 7)), want, 1e-12)


def test_compat_grid_matches_jax():
    rng = np.random.default_rng(8)
    scene = rng.uniform(size=(6, 6, 6))
    h = 0.2
    pts = rng.uniform(0.05, 0.95, (40, 3))
    f, fx = rng.standard_normal(40), rng.standard_normal((40, 3))

    def jax_side(scene, pts, f, fx):
        jg = JCOMPAT.Grid(scene, h)
        out = [jg.GetLinear(pts), jg.GetSpline(pts), jg.Get(pts), jg.RenderGradient()]
        jg.SplatLinear(pts, f, fx)
        out += [jg.scene, jg.weights]
        jg.Splat(pts, f)
        return out + [jg.render()]

    want = jax.jit(jax_side)(*(jnp.asarray(a) for a in (scene, pts, f, fx)))
    tg = TCOMPAT.Grid(_t(scene), h)
    assert tg.res == (6, 6, 6)
    got = [tg.GetLinear(_t(pts)), tg.GetSpline(_t(pts)), tg.Get(_t(pts)), tg.RenderGradient()]
    assert tg.SplatLinear(_t(pts), _t(f), _t(fx)) is tg
    got += [tg.scene, tg.weights]
    tg.Splat(_t(pts), _t(f))
    got.append(tg.render())
    for a, b in zip(jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(got)):
        _close(b, a, 1e-12)


def test_compat_cable_matches_jax():
    prof = np.sqrt(2.0 - np.linspace(0, 1, 9) ** 2)
    pts = np.random.default_rng(9).uniform(0.1, 1.9, (30, 3))

    def jax_side(prof, pts):
        jc = JCOMPAT.Cable(prof, 1.0, 2.0)
        return [*jc.GetLinear(pts), jc.render((4, 5, 4)), jc.render2(6), jc.RenderGradient()]

    want = jax.jit(jax_side)(jnp.asarray(prof), jnp.asarray(pts))
    tc = TCOMPAT.Cable(_t(prof), 1.0, 2.0)
    assert (tc.radius, tc.length, tc.h) == (1.0, 2.0, 0.125)
    got = [*tc.GetLinear(_t(pts)), tc.render((4, 5, 4)), tc.render2(6), tc.RenderGradient()]
    for a, b in zip(want, got):
        _close(b, a, 1e-12)
    assert TCOMPAT.Cable(_t(prof), 1.0).length == 1.0


def test_compat_fields_need_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the GPU-less behaviour")
    scene, prof = np.ones((4, 4, 4)), np.linspace(1.5, 1.0, 5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TCOMPAT.Grid(scene, 0.25)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TCOMPAT.Cable(prof, 1.0)
    # a numpy input goes where the caller asks; a torch tensor stays where it is
    assert TCOMPAT.Grid(scene, 0.25, device="cpu").scene.device.type == "cpu"
    assert TCOMPAT.Cable(prof, 1.0, device="cpu").rif.device.type == "cpu"
    assert TCOMPAT.Grid(_t(scene), 0.25).scene.device.type == "cpu"


def test_compat_upres_volume_takes_a_numpy_volume_on_the_device_asked_for():
    """A numpy volume goes on ``device``, the card by default: without a GPU it
    raises unless the caller asks for the CPU, and there it matches the JAX
    function, which takes the numpy volume as it is."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the GPU-less behaviour")
    vol = np.random.default_rng(10).uniform(size=(5, 5, 5))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TCOMPAT.upres_volume(vol, (7, 7, 7))
    got = TCOMPAT.upres_volume(vol, (7, 6, 9), device="cpu")
    assert got.device.type == "cpu" and got.dtype == torch.float64
    _close(got, JCOMPAT.upres_volume(vol, (7, 6, 9)), 1e-12)
    # a torch tensor stays where it is, whatever ``device`` says
    assert TCOMPAT.upres_volume(_t(vol), 7).device.type == "cpu"


def test_get_pts_sdf_matches_jax(sdf_scene):
    sdf, pos, vel = sdf_scene
    got_pos, got_vel = TSDF.get_pts_sdf_from_samples(_t(sdf), _t(_sdf_samples()), SPAN)
    _close(got_pos, pos, 1e-12)
    _close(got_vel, vel, 1e-12)
    # the generator's draw lands on the surface as well
    p, _ = TSDF.get_pts_sdf(torch.Generator().manual_seed(0), _t(sdf), 64, SPAN)
    r = torch.linalg.norm(p - 0.5, dim=-1)
    assert bool(((r - 0.4).abs() < 0.05).all())


def test_get_opp_pts_matches_jax(sdf_scene):
    sdf, pos, vel = sdf_scene
    inner = pos + 0.02 * vel  # just inside, heading inward
    want = jax.jit(lambda *a: JSDF.get_opp_pts(*a, SPAN))(jnp.asarray(sdf), jnp.asarray(inner),
                                                          jnp.asarray(vel))
    got = TSDF.get_opp_pts(_t(sdf), _t(inner), _t(vel), SPAN)
    _close(got, want, 1e-12)
    r = torch.linalg.norm(got - 0.5, dim=-1)
    assert bool((r > 0.3).all())
