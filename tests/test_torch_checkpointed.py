"""The port's exact gradient (``tracer/checkpointed.py``) against the JAX package.

CPU, f64 (conftest enables x64).  Inputs are numpy arrays made from a seed and
handed to both sides.  Tolerances, relative to the reference's largest
magnitude: exit state and gradient ``1e-9`` (the same f64 arithmetic; the JAX
package evaluates the field through its cell table and sums the splats in
another order); the tiny trainer's loss history ``1e-8`` (Adam steps on traced
gradients).  Each JAX reference is computed once per module.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adjointnonlinearraytracing_tpu import tracer as JT
from adjointnonlinearraytracing_tpu.experiments import common as JC
from adjointnonlinearraytracing_tpu.experiments import fuel_injection as JF
from adjointnonlinearraytracing_tpu.experiments import voxel_scenes as JV
from adjointnonlinearraytracing_tpu.sources import sources as JS
from adjointnonlinearraytracing_tpu_torch import tracer as TT
from adjointnonlinearraytracing_tpu_torch.experiments import common as TC
from adjointnonlinearraytracing_tpu_torch.experiments import fuel_injection as TF
from adjointnonlinearraytracing_tpu_torch.fields import grid as TG
from adjointnonlinearraytracing_tpu_torch.sources import sources as TS
from adjointnonlinearraytracing_tpu_torch.tracer import checkpointed as TCK
from adjointnonlinearraytracing_tpu_torch.tracer import eikonal as TE
from adjointnonlinearraytracing_tpu_torch.utils.metrics import MetricsLogger

RES, H, DS, SEG = 9, 1.0, 0.7, 8
SPAN = (RES - 1) * H
STEPS = TE.max_steps_fwd(RES, H, DS)  # 51: the last of 7 segments holds 3 steps
RTOL = 1e-9
CHUNK = "70"  # does not divide the batch


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(1.0, np.abs(want).max()))


def _field():
    rng = np.random.default_rng(0)
    idx = np.arange(RES) * H
    z, y, x = np.meshgrid(idx, idx, idx, indexing="ij")
    r2 = (x - SPAN / 2) ** 2 + (y - SPAN / 2) ** 2 + (z - SPAN / 2) ** 2
    return 1.0 + 0.25 * np.exp(-r2 / (2 * (SPAN / 4) ** 2)) + 0.02 * rng.uniform(size=x.shape)


def _rays():
    """200 rays: most enter through the y = 0 face, some start outside moving
    away, some pass beside the grid, some start inside too slow to leave."""
    rng = np.random.default_rng(1)
    n = 200
    xz = rng.uniform(0.2 * SPAN, 0.8 * SPAN, (n, 2))
    tilt = 0.15 * rng.standard_normal((n, 2))
    v = np.stack([tilt[:, 0], np.ones(n), tilt[:, 1]], axis=-1)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    x = np.stack([xz[:, 0], np.full(n, -0.4 * H), xz[:, 1]], axis=-1)
    v[150:165, 1] *= -1.0                      # start outside, move away
    x[165:180, 0] = -1.5 * H                   # pass beside the grid
    v[165:180, 0] = -np.abs(v[165:180, 0])
    x[180:, 1] = rng.uniform(0.3 * SPAN, 0.7 * SPAN, 20)  # start inside ...
    v[180:] *= 0.02                            # ... and never get out
    x[::17, 0] = np.round(x[::17, 0] / H) * H  # on node planes
    return x, v


@pytest.fixture(scope="module")
def scene():
    return _field(), *_rays()


@pytest.fixture(scope="module")
def jax_exact(scene):
    """The JAX package's ``trace_exact`` on the whole batch (its own tests hold
    its chunked path equal to it)."""
    rif, x, v = scene
    mp = pytest.MonkeyPatch()
    mp.setenv("ANRT_EXACT_CHUNK", "0")
    try:
        def loss(r):
            xt, vt = JT.trace_exact(r, jnp.asarray(x), jnp.asarray(v), H, DS, SEG)
            return jnp.sum(xt ** 2 + xt * vt)

        xt, vt = JT.trace_exact(jnp.asarray(rif), jnp.asarray(x), jnp.asarray(v), H, DS, SEG)
        g = jax.grad(loss)(jnp.asarray(rif))
        return np.asarray(xt), np.asarray(vt), np.asarray(g)
    finally:
        mp.undo()


def _torch_exact(rif, x, v, seg=SEG, trace=None):
    r = torch.from_numpy(rif).requires_grad_(True)
    xs, vs = torch.from_numpy(x), torch.from_numpy(v)
    if trace is None:
        xt, vt = TT.trace_exact(r, xs, vs, H, DS, seg)
    else:
        xt, vt = trace(r, xs, vs)
    (xt ** 2 + xt * vt).sum().backward()
    return xt.detach(), vt.detach(), r.grad


def test_the_scene_has_every_kind_of_ray(scene):
    rif, x, v = scene
    assert STEPS == 51 and STEPS % SEG
    field = TG.GridField(torch.from_numpy(rif), H)
    _, _, esc, c, captured, ckpts = TCK._forward_with_ckpts(
        field, torch.from_numpy(x), torch.from_numpy(v), DS, STEPS, SEG)
    assert ckpts.shape == (-(-STEPS // SEG), 7, 200)
    assert bool(captured[:150].all()) and int(c[:150].max()) < STEPS
    assert not bool(captured[150:180].any()) and bool(esc[150:180].all())
    assert not bool(esc[180:].any()) and bool((c[180:] == STEPS).all())
    # the segments a ray's gradient needs start before its capture step
    assert int(c[:150].min()) > SEG


def test_checkpoint_rows_are_fields(scene):
    """The checkpoint stack is ``(nseg, 7, N)``, one field of all the rays to a
    row (K5 writes it so, K6 reads it so): row 0 of segment 0 is every ray's
    start x, rows 3-5 its start v, row 6 whether it starts inside; segment s
    holds the state after s * SEG steps of the plain stepper."""
    rif, x, v = scene
    field = TG.GridField(torch.from_numpy(rif), H)
    xs, vs = torch.from_numpy(x), torch.from_numpy(v)
    _, _, esc, c, captured, ckpts = TCK._forward_with_ckpts(field, xs, vs, DS, STEPS, SEG)
    assert torch.equal(ckpts[0, :3], xs.T) and torch.equal(ckpts[0, 3:6], vs.T)
    assert torch.equal(ckpts[0, 6], TG.inbounds(field, xs).to(xs.dtype))
    # after one segment, for the rays not yet out (the stepper reports the
    # final position of a ray that never escapes), x is the stepper's own
    live = (captured & (c > SEG)) | ~esc
    x1, _ = TE.trace(field, xs[live], vs[live], DS, SEG)
    assert torch.equal(ckpts[1, :3].T[live], x1)


@pytest.mark.parametrize("chunk", ["0", CHUNK])
def test_trace_exact_matches_jax(scene, jax_exact, chunk, monkeypatch):
    """Whole and split into chunks of ``ANRT_EXACT_CHUNK`` rays, against the
    JAX package's whole batch."""
    rif, x, v = scene
    monkeypatch.setenv("ANRT_EXACT_CHUNK", chunk)
    xt, vt, g = _torch_exact(rif, x, v)
    want_xt, want_vt, want_g = jax_exact
    _close(xt, want_xt)
    _close(vt, want_vt)
    _close(g, want_g)
    assert np.abs(want_g).max() > 0
    # the exit state is the plain stepper's, bit for bit
    xt0, vt0 = TE.trace(TG.GridField(torch.from_numpy(rif), H), torch.from_numpy(x),
                        torch.from_numpy(v), DS, STEPS)
    assert torch.equal(xt, xt0) and torch.equal(vt, vt0)


def test_chunking_and_seg_do_not_change_the_result(scene, monkeypatch):
    rif, x, v = scene
    monkeypatch.setenv("ANRT_EXACT_CHUNK", "0")
    _, _, g0 = _torch_exact(rif, x, v)
    for chunk, seg in ((CHUNK, 5), ("0", 64)):
        monkeypatch.setenv("ANRT_EXACT_CHUNK", chunk)
        xt, vt, g = _torch_exact(rif, x, v, seg)
        _close(g, g0.numpy(), 1e-12)


def test_trace_exact_equals_the_tape(scene):
    """The exact claim: the gradient of autograd through the plain stepper."""
    rif, x, v = scene
    xt, vt, g = _torch_exact(rif, x, v)
    r = torch.from_numpy(rif).requires_grad_(True)
    xs = torch.from_numpy(x).requires_grad_(True)
    vs = torch.from_numpy(v).requires_grad_(True)
    xt_ad, vt_ad = TT.trace_ad(r, xs, vs, H, DS)
    (xt_ad ** 2 + xt_ad * vt_ad).sum().backward()
    assert torch.equal(xt, xt_ad.detach()) and torch.equal(vt, vt_ad.detach())
    _close(g, r.grad.numpy())
    # x and v get zeros from trace_exact (the tape gives them their own)
    xs2 = torch.from_numpy(x).requires_grad_(True)
    xt2, _ = TT.trace_exact(torch.from_numpy(rif), xs2, torch.from_numpy(v), H, DS, SEG)
    xt2.sum().backward()
    assert torch.equal(xs2.grad, torch.zeros_like(xs2))


def test_backward_stats_count_what_the_kernel_runs(scene):
    rif, x, v = scene
    r, xs, vs = (torch.from_numpy(a) for a in (rif, x, v))
    fw, bw = {}, {}
    xt, vt, esc, c, captured, ckpts = TCK._forward_with_ckpts(TG.GridField(r, H), xs, vs, DS,
                                                              STEPS, SEG, stats=fw)
    dxt, dvt = 2 * xt, torch.ones_like(vt)
    bw["captured"] = captured
    g = TCK.backtrace_plain(r, xs, vs, esc, c, ckpts, dxt, dvt, H, DS, SEG, stats=bw)
    g64 = TCK.backtrace_plain(r.float(), xs.float(), vs.float(), esc, c, ckpts.float(),
                              dxt.float(), dvt.float(), H, DS, SEG, acc_dtype=torch.float64)
    assert g64.dtype == torch.float64
    _close(g64, g.numpy(), 1e-4)
    # a ray's gated-on steps are the steps before its capture step, the rays
    # that escaped without being captured having none
    live = captured | ~esc
    assert bw["ray_steps"] == int(c[live].sum())
    assert 0 < bw["flushes"] <= bw["splats"] == bw["evals"] <= bw["ray_steps"]
    assert fw["ray_steps"] >= bw["ray_steps"] and fw["evals"] == bw["evals"]


def test_make_trace_exact_mode_is_trace_exact(scene):
    """Mirrors the JAX package's ``test_escalation.py::TestHolderTrace``."""
    rif, x, v = scene
    holder = {"mode": None}
    trace = TC.make_trace(SPAN, DS, gradient=holder, seg=SEG, device="cpu")
    _, _, g_adj = _torch_exact(rif, x, v, trace=trace)
    r = torch.from_numpy(rif).requires_grad_(True)
    xt, _ = TT.trace(r, torch.from_numpy(x), torch.from_numpy(v), H, DS)
    (xt ** 2).sum().backward()
    holder["mode"] = "exact"
    xt_e, vt_e, g_ex = _torch_exact(rif, x, v, trace=trace)
    _, _, want = _torch_exact(rif, x, v)
    assert torch.equal(g_ex, want)
    assert float((g_ex - g_adj).abs().max()) > 0


@pytest.mark.parametrize("chunk", [None, "0", "1000"])
def test_exact_mem_bytes_matches_jax(chunk, monkeypatch):
    if chunk is not None:
        monkeypatch.setenv("ANRT_EXACT_CHUNK", chunk)
    for args in ((1_310_720, 65, 1.0, 1 / 128), (4096, 3, 1.0, 1 / 128, 8), (10, 129, 2.0, 0.01)):
        assert TC.exact_mem_bytes(*args) == JC.exact_mem_bytes(*args), args


FUEL = dict(res_list=[3, 5], vol_span=1.0, spp=1, nviews=2, nbins=6, optim_iters=2,
            lr=2e-3, fuel_val=0.05, grad_spotcheck=False, auto_exact=True, seed=0)


def test_fuel_run_escalates_at_stage_1_like_the_jax_trainer(monkeypatch):
    """A tiny f64 run whose escalation tolerance is below any drift: both
    trainers escalate at stage 1 and run it on the exact gradient."""
    monkeypatch.setenv("ANRT_EXACT_TOL", "-1")
    # the JAX package's cell-table stepper, which its spot check compiles faster
    monkeypatch.setenv("ANRT_FAST_PATH", "classic")
    gt = np.array(JV.gaussian_bump(9, 1.0, 0.05, jnp.float64))
    rays, _ = JS.rand_rays_in_sphere(jax.random.PRNGKey(0), FUEL["nviews"],
                                     (FUEL["nbins"],) * 2, 1, 1.0, angle_span=360,
                                     circle=False, xaxis=False, sensor_dist=0)
    rays = tuple(np.array(a) for a in rays)
    tm = MetricsLogger()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _, want_hist, _ = JF.run_opt(dict(JF.default_params(), dtype=jnp.float64, **FUEL),
                                     None, jnp.asarray(gt))
        _, hist, _ = TF.run_opt(dict(TF.default_params(), dtype="float64", **FUEL), None,
                                torch.from_numpy(gt), rays=TS.Rays(*map(torch.from_numpy, rays)),
                                device="cpu", metrics=tm)
    escalations = [str(w.message)[:9] for w in caught if "escalating" in str(w.message)]
    assert escalations == ["stage 1 (", "stage 1 ("]  # the JAX trainer's, then the port's
    assert [r["gradient_escalated_stage"] for r in tm.history if "gradient_mode" in r] == [1]
    assert len(hist) == len(want_hist) == 6
    np.testing.assert_allclose(hist, [float(h) for h in want_hist], rtol=1e-8, atol=0)
