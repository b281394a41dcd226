"""The port's plain steppers and ``api.trace`` against the JAX package.

CPU, f64.  Inputs are numpy arrays made from a seed and handed to both sides.
Tolerances: exit states ``1e-10`` and gradients ``1e-9``, both relative to the
reference's largest magnitude (same f64 arithmetic, different summation
order, accumulated over at most 60 steps); one f32 case at ``1e-4``.
Each JAX reference value is computed once per module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adjointnonlinearraytracing_tpu import tracer as JT
from adjointnonlinearraytracing_tpu.fields import grid as JG
from adjointnonlinearraytracing_tpu.tracer import eikonal as JE
from adjointnonlinearraytracing_tpu_torch.fields import grid as TG
from adjointnonlinearraytracing_tpu_torch.tracer import api as TA
from adjointnonlinearraytracing_tpu_torch.tracer import eikonal as TE

RES, H = 11, 0.9
DS = H / 2
SPAN = (RES - 1) * H
FWD_RTOL, GRAD_RTOL = 1e-10, 1e-9


def _field():
    rng = np.random.default_rng(0)
    idx = np.arange(RES) * H
    z, y, x = np.meshgrid(idx, idx, idx, indexing="ij")
    r2 = (x - SPAN / 2) ** 2 + (y - SPAN / 2) ** 2 + (z - SPAN / 2) ** 2
    return 1.0 + 0.3 * np.exp(-r2 / (2 * (SPAN / 4) ** 2)) + 0.02 * rng.uniform(size=x.shape)


def _rays(kind, n=48):
    """Ray sets that exercise the stepper's masks."""
    rng = np.random.default_rng(1)
    xz = rng.uniform(0.2 * SPAN, 0.8 * SPAN, (n, 2))
    tilt = 0.15 * rng.standard_normal((n, 2))
    v = np.stack([tilt[:, 0], np.ones(n), tilt[:, 1]], axis=-1)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    y0 = {"outside": -0.6 * H, "face": 0.0, "never_enter": -0.6 * H}[kind]
    x = np.stack([xz[:, 0], np.full(n, y0), xz[:, 1]], axis=-1)
    if kind == "never_enter":
        # half move away from the grid at once, half pass beside it
        v[: n // 2, 1] *= -1.0
        x[n // 2:, 0] = -1.5 * H
        v[n // 2:, 0] = -np.abs(v[n // 2:, 0])
    if kind == "face":
        x[: n // 2, 0] = np.round(x[: n // 2, 0] / H) * H  # also on interior nodes
    return x, v


# (ray kind, forward max_steps, backward max_steps); None = the API's bounds
CASES = {
    "outside": ("outside", None, None),
    "never_enter": ("never_enter", None, None),
    "face": ("face", None, None),
    "cut_short": ("outside", 6, 4),    # no ray escapes: vt must stay v0
    "odd_steps": ("outside", 27, 13),  # some rays are cut mid-grid
}


@pytest.fixture(scope="module")
def refs():
    """Per case: inputs and the JAX package's exit state and adjoint gradient."""
    data = _field()
    jf = JG.GridField(jnp.asarray(data), H)
    rng = np.random.default_rng(2)
    out = {"data": data}
    for name, (kind, nf, nb) in CASES.items():
        x, v = _rays(kind)
        nf = JE.max_steps_fwd(RES, H, DS) if nf is None else nf
        nb = JE.max_steps_bwd(RES, H, DS) if nb is None else nb
        xt, vt = JE.trace(jf, jnp.asarray(x), jnp.asarray(v), DS, nf)
        dx, dv = rng.standard_normal(x.shape), rng.standard_normal(x.shape)
        g = JE.backtrace(jf, xt, vt, jnp.asarray(dx), jnp.asarray(dv), DS, nb)
        out[name] = dict(x=x, v=v, nf=nf, nb=nb, xt=np.asarray(xt), vt=np.asarray(vt),
                         dx=dx, dv=dv, g=np.asarray(g))
    return out


@pytest.fixture(scope="module")
def grad_refs():
    """jax.grad of the bench-style loss through the adjoint API and through the tape."""
    data = _field()
    x, v = _rays("outside")
    target = jnp.asarray([SPAN / 2, SPAN * 1.1, SPAN / 2])

    def loss(fn):
        def f(r):
            xt, vt = fn(r, jnp.asarray(x), jnp.asarray(v), H, DS)
            return jnp.sum((xt - target) ** 2) + jnp.sum(vt)
        return f

    # jitted: one compile each instead of one per eager op; under jit the
    # package's automatic path choice takes the paired stepper for ds = h/2
    val, g_adj = jax.jit(jax.value_and_grad(loss(JT.trace)))(jnp.asarray(data))
    g_tape = jax.jit(jax.grad(loss(JT.trace_ad)))(jnp.asarray(data))
    return dict(data=data, x=x, v=v, loss=float(val), g_adj=np.asarray(g_adj),
                g_tape=np.asarray(g_tape))


def _close(got, want, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(1.0, np.abs(want).max()))


def test_step_bounds():
    for res, h, ds in [(128, 20.0 / 127, 10.0 / 127), (11, 0.9, 0.45), (9, 1.0, 0.3)]:
        assert TE.max_steps_fwd(res, h, ds) == JE.max_steps_fwd(res, h, ds)
        assert TE.max_steps_bwd(res, h, ds) == JE.max_steps_bwd(res, h, ds)
    assert TE.max_steps_fwd(128, 20.0 / 127, 10.0 / 127) == 1024
    assert TE.max_steps_bwd(128, 20.0 / 127, 10.0 / 127) == 512


@pytest.mark.parametrize("name", list(CASES))
def test_trace_matches_jax(refs, name):
    c = refs[name]
    tf = TG.GridField(torch.from_numpy(refs["data"]), H)
    stats = {}
    xt, vt = TE.trace(tf, torch.from_numpy(c["x"]), torch.from_numpy(c["v"]), DS, c["nf"],
                      stats=stats)
    _close(xt, c["xt"], FWD_RTOL)
    _close(vt, c["vt"], FWD_RTOL)
    assert 0 < stats["ray_steps"] <= c["nf"] * c["x"].shape[0]
    if name == "cut_short":
        # nobody escaped in 6 steps: xt is the final position, vt is NOT fixed up
        assert np.array_equal(vt.numpy(), c["v"])
        assert not np.array_equal(xt.numpy(), c["x"])
    if name == "never_enter":
        assert np.array_equal(vt.numpy(), c["v"])


@pytest.mark.parametrize("name", list(CASES))
def test_backtrace_matches_jax(refs, name):
    c = refs[name]
    tf = TG.GridField(torch.from_numpy(refs["data"]), H)
    stats = {}
    g = TE.backtrace(tf, *(torch.from_numpy(c[k].copy()) for k in ("xt", "vt", "dx", "dv")), DS,
                     c["nb"], stats=stats)
    _close(g, c["g"], GRAD_RTOL)
    assert stats["splats"] <= stats["ray_steps"] <= c["nb"] * c["x"].shape[0]
    if name != "never_enter":
        assert np.abs(c["g"]).max() > 0 and stats["splats"] > 0


def _torch_loss_and_grad(data, x, v, dtype=torch.float64):
    rif = torch.from_numpy(data).to(dtype).requires_grad_(True)
    xr = torch.from_numpy(x).to(dtype).requires_grad_(True)
    vr = torch.from_numpy(v).to(dtype).requires_grad_(True)
    target = torch.tensor([SPAN / 2, SPAN * 1.1, SPAN / 2], dtype=dtype)
    xt, vt = TA.trace(rif, xr, vr, H, DS)
    loss = ((xt - target) ** 2).sum() + vt.sum()
    loss.backward()
    return loss, rif, xr, vr


@pytest.mark.parametrize("ref", ["g_adj", "g_tape"])
def test_api_gradient_matches_jax_grad(grad_refs, ref):
    """api.trace's gradient against jax.grad through tracer.trace (the paired
    adjoint) and through tracer.trace_ad (the autodiff tape)."""
    loss, rif, xr, vr = _torch_loss_and_grad(grad_refs["data"], grad_refs["x"], grad_refs["v"])
    assert abs(float(loss.detach()) - grad_refs["loss"]) <= FWD_RTOL * abs(grad_refs["loss"])
    assert rif.grad.shape == rif.shape
    _close(rif.grad, grad_refs[ref], GRAD_RTOL)
    assert xr.grad is None and vr.grad is None  # only rif receives a gradient


def test_f32_forward_and_gradient(grad_refs):
    """The one f32 case.  The forward exit state is held to the JAX package's
    f32 result at 1e-4.  The f32 adjoint gradient is not: a last-bit difference
    flips a mask on some ray-step and moves single voxels by percents (the JAX
    package's own compiled and op-by-op f32 runs differ that much), so it is
    held to the f64 gradient in direction only (cosine > 0.999)."""
    data32 = grad_refs["data"].astype(np.float32)
    x32, v32 = grad_refs["x"].astype(np.float32), grad_refs["v"].astype(np.float32)
    jf = JG.GridField(jnp.asarray(data32), H)
    nf = JE.max_steps_fwd(RES, H, DS)
    xt_ref, vt_ref = JE.trace(jf, jnp.asarray(x32), jnp.asarray(v32), DS, nf)
    xt, vt = TE.trace(TG.GridField(torch.from_numpy(data32), H), torch.from_numpy(x32),
                      torch.from_numpy(v32), DS, nf)
    assert xt.dtype == torch.float32
    _close(xt, np.asarray(xt_ref), 1e-4)
    _close(vt, np.asarray(vt_ref), 1e-4)

    _, rif, _, _ = _torch_loss_and_grad(grad_refs["data"], grad_refs["x"], grad_refs["v"],
                                        torch.float32)
    assert rif.grad.dtype == torch.float32 and bool(torch.isfinite(rif.grad).all())
    g32, g64 = rif.grad.double().reshape(-1).numpy(), grad_refs["g_adj"].reshape(-1)
    assert g32 @ g64 / np.linalg.norm(g32) / np.linalg.norm(g64) > 0.999


def test_api_rejects_bad_shapes():
    rif = torch.ones(4, 4, 4, dtype=torch.float64)
    x = torch.zeros(5, 3, dtype=torch.float64)
    with pytest.raises(ValueError, match="3D voxel grid"):
        TA.trace(rif[0], x, x, 1.0, 0.5)
    with pytest.raises(ValueError, match=r"x must be \(N, 3\)"):
        TA.trace(rif, x[:, :2], x[:, :2], 1.0, 0.5)
    with pytest.raises(ValueError, match="must match"):
        TA.trace(rif, x, x[:4], 1.0, 0.5)


def test_api_trace_takes_strided_inputs(grad_refs):
    """Non-contiguous ``rif``, ``x``, ``v`` give what their contiguous copies give."""
    data, (x, v) = _field(), _rays("outside")
    rif = torch.from_numpy(np.ascontiguousarray(data.transpose(2, 1, 0))).permute(2, 1, 0)
    xv = torch.from_numpy(np.concatenate([x, v], axis=1))
    tx, tv = xv[:, :3], xv[:, 3:]
    assert not (rif.is_contiguous() or tx.is_contiguous() or tv.is_contiguous())
    rif.requires_grad_(True)
    xt, vt = TA.trace(rif, tx, tv, H, DS)
    (xt ** 2).sum().add(vt.sum()).backward()
    ref = torch.from_numpy(data).requires_grad_(True)
    xt_c, vt_c = TA.trace(ref, tx.contiguous(), tv.contiguous(), H, DS)
    (xt_c ** 2).sum().add(vt_c.sum()).backward()
    assert torch.equal(xt, xt_c) and torch.equal(vt, vt_c)
    assert torch.equal(rif.grad, ref.grad) and float(ref.grad.abs().max()) > 0


def test_trace_ad_matches_jax_trace_ad():
    """Value and gradient with respect to ``rif``, ``x`` and ``v`` of the tape twin."""
    data, (x, v) = _field(), _rays("outside")

    def jloss(r, x, v):
        xt, vt = JT.trace_ad(r, x, v, H, DS)
        return jnp.sum(xt ** 2 + xt * vt)

    want = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2)))(
        jnp.asarray(data), jnp.asarray(x), jnp.asarray(v))
    tr, tx, tv = (torch.from_numpy(a).requires_grad_(True) for a in (data, x, v))
    xt, vt = TA.trace_ad(tr, tx, tv, H, DS)
    loss = (xt ** 2 + xt * vt).sum()
    loss.backward()
    assert abs(float(loss.detach()) - float(want[0])) <= FWD_RTOL * abs(float(want[0]))
    for t, g in zip((tr, tx, tv), want[1]):
        _close(t.grad, g, GRAD_RTOL)
