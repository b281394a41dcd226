"""The port's exact gradients of the trace variants (``trace_plane_exact``,
``trace_target_exact``, ``trace_sdf_exact``) against the JAX package, and the
tracer's import surface.

CPU, f64 (conftest enables x64).  The scenes are ``test_torch_variants.py``'s:
numpy arrays made from seeds and handed to both sides.  Tolerances, relative
to the reference's largest magnitude: forward outputs ``1e-12`` (the same f64
arithmetic; the JAX package evaluates the field through its cell table);
gradients ``1e-9`` (splats summed in another order).  Chunked runs set
``ANRT_EXACT_CHUNK`` on both sides, small enough that the last chunk is
padded.  The JAX references are jitted together and computed once per
module (the chunk size is read while tracing, so it is set between calls
inside the one traced function).  On the
CPU every function runs its plain version; the kernels K15-K19 are held
against these plain versions on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adjointnonlinearraytracing_tpu import tracer as JT
from adjointnonlinearraytracing_tpu.fields import grid as JG
from adjointnonlinearraytracing_tpu.tracer import checkpointed as JCK
from adjointnonlinearraytracing_tpu.tracer import eikonal as JE
from adjointnonlinearraytracing_tpu_torch import tracer as TT
from adjointnonlinearraytracing_tpu_torch.fields import grid as TG
from adjointnonlinearraytracing_tpu_torch.kernels import wrappers as K
from adjointnonlinearraytracing_tpu_torch.tracer import checkpointed as TCK
from adjointnonlinearraytracing_tpu_torch.tracer import eikonal as TE
from test_torch_variants import (DS, H, N_SLOW, SDF_STEPS, STEPS, _close, _late_sdf,  # noqa: F401
                                 _late_target_rays, _loss, _rays, _rif, _t, sdf_scene)

SEG = 8          # 9 segments of the 72 steps, 4.5 of the sdf's 36
CHUNK = 70       # 200 rays: 3 chunks, the last padded with 10 copies of ray 0
LATE_CHUNK = 7   # the late-crossing sdf batch's 20 rays: 3 chunks, 1 copy of ray 0
VARIANTS = ("plane", "target", "sdf")


@pytest.fixture(scope="module")
def scene():
    return (_rif(), *_rays())


def _jax_call(variant, scene, sdf_scene, seg=SEG):
    """The JAX function of ``variant`` as a function of ``rif`` alone."""
    _, x, v, o, d, tgt = (jnp.asarray(a) for a in scene)
    sdf, xs, vs = (jnp.asarray(a) for a in sdf_scene)
    return {
        "plane": lambda r: JT.trace_plane_exact(r, x, v, o, d, H, DS, seg),
        "target": lambda r: JT.trace_target_exact(r, x, v, tgt, H, DS, seg),
        "sdf": lambda r: JT.trace_sdf_exact(r, sdf, xs, vs, H, DS, seg),
    }[variant]


def _jax_grad(call, r):
    """Outputs, loss and gradient of ``_loss`` over ``(xt, vt)`` of ``call``
    (a function of ``rif``) at ``r``."""
    def loss(q):
        out = call(q)
        return _loss(out[0], out[1]), out

    (val, out), g = jax.value_and_grad(loss, has_aux=True)(r)
    return out, val, g


@pytest.fixture(scope="module")
def jax_refs(scene, sdf_scene):
    """Each variant whole and chunked; the late-crossing sdf batch whole and
    chunked at seg 4 and 32, and its gradient chunked at seg 8; the target's
    horizon batch chunked: one jit."""
    ssdf, sx, sv = (jnp.asarray(a) for a in _late_sdf())
    lx, lv, ltgt = (jnp.asarray(a) for a in _late_target_rays())

    def all_of(r):
        out = {}
        for chunk in (0, CHUNK):
            mp.setenv("ANRT_EXACT_CHUNK", str(chunk))
            for v in VARIANTS:
                out[v, chunk] = _jax_grad(_jax_call(v, scene, sdf_scene), r)
        for chunk in (0, LATE_CHUNK):
            mp.setenv("ANRT_EXACT_CHUNK", str(chunk))
            for seg in (4, 32):
                out["late_sdf", chunk, seg] = JT.trace_sdf_exact(r, ssdf, sx, sv, H, DS, seg)
        # chunked: the sdf at LATE_CHUNK, the target at twice it
        out["late_sdf_grad",] = _jax_grad(
            lambda q: JT.trace_sdf_exact(q, ssdf, sx, sv, H, DS, SEG), r)
        mp.setenv("ANRT_EXACT_CHUNK", str(LATE_CHUNK * 2))
        out["late_target",] = _jax_grad(
            lambda q: JT.trace_target_exact(q, lx, lv, ltgt, H, DS, SEG), r)
        return out

    mp = pytest.MonkeyPatch()
    try:
        refs = jax.jit(all_of)(jnp.asarray(scene[0]))
    finally:
        mp.undo()
    return {k[0] if len(k) == 1 else k: jax.tree_util.tree_map(np.asarray, o)
            for k, o in refs.items()}


def _port_args(variant, scene, sdf_scene):
    _, x, v, o, d, tgt = scene
    sdf, xs, vs = sdf_scene
    return {
        "plane": (TT.trace_plane_exact, (_t(x), _t(v), _t(o), _t(d))),
        "target": (TT.trace_target_exact, (_t(x), _t(v), _t(tgt))),
        "sdf": (lambda r, *a: TT.trace_sdf_exact(r, _t(sdf), *a), (_t(xs), _t(vs))),
    }[variant]


def _port_grad(fn, rif, *args, seg=SEG):
    r = _t(rif).requires_grad_(True)
    out = fn(r, *args, H, DS, seg)
    loss = _loss(out[0], out[1])
    loss.backward()
    return out, float(loss.detach()), r.grad


@pytest.mark.parametrize("chunk", [0, CHUNK], ids=["whole", "chunked"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_exact_variant_matches_jax(variant, chunk, scene, sdf_scene, jax_refs, monkeypatch):
    """Forward outputs within 1e-12 and the gradient within 1e-9 of the JAX
    function, with the batch whole and in padded chunks."""
    monkeypatch.setenv("ANRT_EXACT_CHUNK", str(chunk))
    fn, args = _port_args(variant, scene, sdf_scene)
    out, loss, g = _port_grad(fn, scene[0], *args)
    want_out, want_loss, want_g = jax_refs[variant, chunk]
    assert len(out) == len(want_out)
    for got, ref in zip(out, want_out):
        if ref.dtype == bool:
            assert got.dtype == torch.bool and np.array_equal(got.numpy(), ref)
        else:
            _close(got, ref, 1e-12)
    assert abs(loss - float(want_loss)) <= 1e-12 * abs(float(want_loss))
    _close(g, want_g, 1e-9)
    assert float(g.abs().max()) > 0
    if variant != "sdf":
        assert not out[2].requires_grad


def test_exact_variants_agree_with_the_adjoint_traces(scene, sdf_scene):
    """The exact variants' forward pass is the adjoint API's, bit for bit, on
    this scene (the sdf's horizon falls on the same step here)."""
    rif, x, v, o, d, tgt = (_t(a) for a in scene)
    sdf, xs, vs = (_t(a) for a in sdf_scene)
    pairs = [(TT.trace_plane_exact(rif, x, v, o, d, H, DS, SEG), TT.trace_plane(rif, x, v, o, d,
                                                                                 H, DS)),
             (TT.trace_target_exact(rif, x, v, tgt, H, DS, SEG), TT.trace_target(rif, x, v, tgt,
                                                                                 H, DS)),
             (TT.trace_sdf_exact(rif, sdf, xs, vs, H, DS, SEG), TT.trace_sdf(rif, sdf, xs, vs, H,
                                                                             DS))]
    for got, want in pairs:
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_sdf_exact_late_crossing_depends_on_the_chunk(scene, jax_refs, monkeypatch):
    """Rays that leave the grid still inside the sdf step on only while a ray
    of their JAX chunk has not escaped (to that segment's end): chunked, most
    of them stop before they cross, as in the JAX package; at seg 32 the
    first segment runs to the crossing either way."""
    rif = _t(scene[0])
    sdf, x0, v0 = (_t(a) for a in _late_sdf())
    for chunk in (0, LATE_CHUNK):
        monkeypatch.setenv("ANRT_EXACT_CHUNK", str(chunk))
        for seg in (4, 32):
            got = TT.trace_sdf_exact(rif, sdf, x0, v0, H, DS, seg)
            for a, b in zip(got, jax_refs["late_sdf", chunk, seg]):
                _close(a, b, 1e-12)
    whole, chunked = jax_refs["late_sdf", 0, 4][0], jax_refs["late_sdf", LATE_CHUNK, 4][0]
    moved = np.abs(chunked - whole).max(axis=1) > 0.1
    assert 10 <= int(moved.sum()) < 20
    np.testing.assert_array_equal(jax_refs["late_sdf", LATE_CHUNK, 32][0],
                                  jax_refs["late_sdf", 0, 32][0])
    # the horizons behind it: the first two chunks stop early, the padded
    # last one runs on while its slow ray has not escaped
    e = TCK._escape_steps(TG.GridField(rif, H), x0, v0, DS, SDF_STEPS, variant="sdf",
                          sdf=TG.GridField(sdf, H))
    hor = TCK._index_chunk_horizons(e, LATE_CHUNK, SEG, SDF_STEPS)
    assert hor.dtype == torch.int32 and hor.shape == (20,)
    assert int(hor[:14].max()) < int(hor[14:].min()) <= SDF_STEPS
    assert bool((hor % SEG == 0).all()) and bool((hor >= e).all())
    # the gradient, chunked
    monkeypatch.setenv("ANRT_EXACT_CHUNK", str(LATE_CHUNK))
    out, loss, g = _port_grad(lambda r, *a: TT.trace_sdf_exact(r, sdf, *a), scene[0], x0, v0)
    want_out, want_loss, want_g = jax_refs["late_sdf_grad"]
    _close(out[0], want_out[0], 1e-12)
    _close(g, want_g, 1e-9)


def test_index_chunk_horizons_pad_with_ray_0():
    esc = torch.tensor([5, 3, 2, 9, 1, 40, 4], dtype=torch.int32)
    # chunks of 3: [5 3 2] [9 1 40] [4 + two copies of ray 0's 5]; seg 8, max 36
    got = TCK._index_chunk_horizons(esc, 3, 8, 36)
    assert got.tolist() == [8, 8, 8, 36, 36, 36, 8]
    assert TCK._index_chunk_horizons(esc, 0, 8, 36).tolist() == [36] * 7
    assert TCK._index_chunk_horizons(esc[:3], 3, 4, 36).tolist() == [8] * 3


@pytest.mark.parametrize("n, chunk", [(12, 4), (14, 4), (5, 8), (9, 0)])
def test_sdf_chunk_horizons_plain_is_the_jax_chunk_rule(n, chunk):
    """K17's horizon rule in plain torch, slot by slot as its passes take it
    (each chunk's largest escape step over the slots whose rays it holds, ray
    0's also into a padded last chunk, rounded up to ``seg`` and capped),
    against ``_index_chunk_horizons`` and against the JAX package's chunks
    (``_to_chunks``: runs of ``chunk`` rays, the last padded with copies of
    ray 0; one chunk where ``N <= chunk`` or ``chunk`` is 0): a chunk that
    divides N, one that does not, N <= chunk and no chunking."""
    seg, max_steps = 7, 48
    rng = np.random.default_rng(n + chunk)
    esc = rng.integers(1, 12, size=n).astype(np.int32)
    esc[0], esc[1] = 46, 30  # ray 0 pads the last chunk; 46 rounds up past the cap
    order = rng.permutation(n).astype(np.int32)
    got = K.sdf_chunk_horizons_plain(torch.from_numpy(esc[order]), torch.from_numpy(order),
                                     chunk, seg, max_steps)
    if chunk and n > chunk:
        (chunks,), nc, pad = JCK._to_chunks([jnp.asarray(esc)], chunk)
        last = np.repeat(np.asarray(chunks.max(axis=1)), chunk)[:n]
    else:
        pad, last = 0, np.full(n, esc.max())
    want = np.minimum(-(-last // seg) * seg, max_steps)
    assert got.dtype == torch.int32 and got.tolist() == want.tolist()
    assert got.tolist() == TCK._index_chunk_horizons(torch.from_numpy(esc), chunk, seg,
                                                     max_steps).tolist()
    if pad:  # the padded last chunk runs to ray 0's horizon
        assert int(got[-1]) == max_steps and int(esc[-(n % chunk):].max()) < 12


def test_sdf_ckpt_wrapper_takes_the_horizons_in_the_kernel(scene, sdf_scene, monkeypatch):
    """K17 makes the horizons itself from the JAX chunk size: the wrapper
    hands its two launches a zeroed word for each chunk's last escape, the
    effective chunk and an int32 (N,) tensor for pass 2 to write the
    horizons to, and returns that tensor; given horizons (a chunk's
    recomputation) go to the kernel as they are.  It refuses a chunk size
    for a chunk of the rays, and anything else for the horizons.  The
    grid's device check and the launch are stubbed out, so that the argument
    checks run on the CPU."""
    rif = _t(scene[0])
    sdf, x, v = (_t(a) for a in sdf_scene)
    n = x.shape[0]
    order = torch.from_numpy(np.random.default_rng(5).permutation(n).astype(np.int32))
    launched, made = [], []
    monkeypatch.setattr(K, "_check_grid", lambda data, name: None)
    monkeypatch.setattr(K, "_launch_on_grid", lambda name, data, *args: launched.append(
        (name, args)))
    horizon = K._horizon
    monkeypatch.setattr(K, "_horizon", lambda data, n_, words=1: made.append(
        horizon(data, n_, words)) or made[-1])
    steps = TCK.variant_steps("sdf", rif.shape, H, DS)
    for chunk, eff in ((CHUNK, CHUNK), (0, n), (n, n)):
        launched.clear()
        *_, hor = K.trace_sdf_ckpt(rif, sdf, H, x, v, DS, steps, SEG, order, chunk)
        last = made[-1][4]
        assert last.dtype == torch.int32 and last.shape == (-(-n // eff),) and not bool(last.any())
        assert hor.dtype == torch.int32 and hor.shape == (n,)
        assert [a[0] for a in launched] == ["trace_sdf_ckpt"] * 2
        (_, a1), (_, a2) = launched
        assert a1[:-1] == a2[:-1] and (a1[-1], a2[-1]) == (1, 2)  # nothing between the passes
        assert a1[-8:-1] == (last.data_ptr(), None, hor.data_ptr(), n, steps, SEG, eff)
    given = torch.full((n,), steps, dtype=torch.int32)
    part = order[:n // 2].contiguous()
    for o in (order, part):
        launched.clear()
        *_, hor = K.trace_sdf_ckpt(rif, sdf, H, x, v, DS, steps, SEG, o, given)
        assert hor is given and launched[0][1][-7:-5] == (given.data_ptr(), None)
    with pytest.raises(ValueError, match="a chunk of the rays"):
        K.trace_sdf_ckpt(rif, sdf, H, x, v, DS, steps, SEG, part, CHUNK)
    for bad in (-1, True, 2.5, lambda e: e, given[:-1], given.long()):
        with pytest.raises(ValueError, match="horizons must be"):
            K.trace_sdf_ckpt(rif, sdf, H, x, v, DS, steps, SEG, order, bad)


def test_target_exact_is_the_same_at_every_chunk_size(scene, jax_refs, monkeypatch):
    """The target's horizon is the whole batch's last escape step however the
    batch is chunked: a slow ray in the first chunk holds every chunk's rays
    stepping, outputs and gradient alike."""
    rif = scene[0]
    x, v, tgt = (_t(a) for a in _late_target_rays())
    runs = []
    for chunk in (0, LATE_CHUNK, 2 * LATE_CHUNK):
        monkeypatch.setenv("ANRT_EXACT_CHUNK", str(chunk))
        runs.append(_port_grad(TT.trace_target_exact, rif, x, v, tgt))
    (out0, loss0, g0) = runs[0]
    for out, loss, g in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(out, out0)) and loss == loss0
        _close(g, g0, 1e-12)
    want_out, want_loss, want_g = jax_refs["late_target"]
    for got, ref in zip(out0, want_out):
        _close(got, ref, 1e-12)
    _close(g0, want_g, 1e-9)
    # and the ballistic captures past the grid happened
    f = TG.GridField(_t(rif), H)
    assert TCK._target_stop_step(f, x, v, DS, STEPS, LATE_CHUNK) < STEPS
    alone = TT.trace_target_exact(_t(rif), x[1:], v[1:], tgt[1:], H, DS, SEG)
    assert bool((out0[2][1:] < alone[2]).all())


def _target_forward_retiring(field, x0, v0, tgt, ds, max_steps):
    """The target's plain forward (``_forward_with_ckpts``'s target steps,
    ``~all(esc)`` gating the batch) with K12's and K16's retirement: an
    escaped ray for which ``wrappers.target_retired_plain`` holds takes no
    more steps.  Returns ``(xt, vt, d2, c, code)`` and the steps it saved."""
    ds_t = TG._scalar(ds, x0)
    x, v, xt, vt = x0, v0, x0, v0
    inside = TG.inbounds(field, x0)
    esc = torch.zeros_like(inside)
    retired = torch.zeros_like(inside)
    captured = torch.zeros_like(inside)
    c = torch.zeros((x0.shape[0],), dtype=torch.int32)
    d2 = TE.sum_sq3(x0 - tgt)
    saved = k = 0
    while k < max_steps and not bool(esc.all()):
        retired = retired | (esc & K.target_retired_plain(x, v, tgt))
        run = ~retired
        saved += int(retired.sum())
        x2, v2 = TE.forward_step(field, x, v, inside, ds_t)
        cur = TG.inbounds(field, x2)
        cur_d2 = TE.sum_sq3(x2 - tgt)
        cap = (cur_d2 < d2) & run
        esc = torch.where(run, esc | (inside & ~cur) | TG.escaped(field, x2, v2), esc)
        x, v = (torch.where(run[:, None], a, b) for a, b in ((x2, x), (v2, v)))
        inside = torch.where(run, cur, inside)
        d2 = torch.where(cap, cur_d2, d2)
        xt, vt = (torch.where(cap[:, None], a, b) for a, b in ((x, xt), (v, vt)))
        c = torch.where(cap, k + 1, c)
        captured = captured | cap
        k += 1
    code = torch.where(esc, torch.where(captured, 1, 2), 0).to(torch.uint8)
    return (xt, vt, d2, c, code), saved


@pytest.mark.parametrize("rays", ["scene", "late"])
def test_target_retirement_changes_no_output(rays, scene):
    """The plain target forward with the kernels' retirement rule gives the
    same ``(xt, vt, d2, c, code)`` as without it, and skips steps."""
    rif = scene[0]
    x, v, tgt = ((_t(a) for a in (scene[1], scene[2], scene[5])) if rays == "scene"
                 else (_t(a) for a in _late_target_rays()))
    f = TG.GridField(_t(rif), H)
    xt, vt, esc, c, cap, _ = TCK._forward_with_ckpts(f, x, v, DS, STEPS, SEG, False,
                                                     variant="target", target=tgt)
    code = torch.where(esc, torch.where(cap, 1, 2), 0).to(torch.uint8)
    want = (xt, vt, TE.sum_sq3(xt - tgt), c, code)
    got, saved = _target_forward_retiring(f, x, v, tgt, DS, STEPS)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert saved > 0


def test_plane_exact_missed_rays_pass_no_gradient(scene):
    """A missed ray's ``xt`` and ``vt`` both pass no gradient (``trace_plane``
    passes the ``vt`` one); a hit ray's do."""
    rif, x, v, o, d, _ = scene
    w = torch.linspace(0.5, 1.5, x.shape[0], dtype=torch.float64)
    grads = []
    for missed in (True, False):
        r = _t(rif).requires_grad_(True)
        xt, vt, miss = TT.trace_plane_exact(r, _t(x), _t(v), _t(o), _t(d), H, DS, SEG)
        sel = (miss if missed else ~miss).double()
        ((xt ** 2).sum(-1) @ (w * sel) + vt.sum(-1) @ sel).backward()
        grads.append(r.grad)
    assert bool(miss[-N_SLOW:].any()) and not bool(miss[:-N_SLOW].any())
    assert float(grads[0].abs().max()) == 0.0 and float(grads[1].abs().max()) > 0


def test_exact_variants_give_zeros_to_all_but_rif(scene, sdf_scene):
    """Only ``rif`` gets a gradient: the sdf, the rays, the planes (given once
    for every ray here) and the targets get zeros of their own shapes."""
    rif, x, v, o, d, tgt = scene
    sdf, xs, vs = sdf_scene
    ins = [_t(a).requires_grad_(True) for a in (rif, sdf, x, v, o[0], d[:1], tgt)]
    r, s, xx, vv, oo, dd, tt = ins
    loss = (_loss(*TT.trace_plane_exact(r, xx, vv, oo, dd, H, DS, SEG)[:2])
            + _loss(*TT.trace_target_exact(r, xx, vv, tt, H, DS, SEG)[:2])
            + _loss(*TT.trace_sdf_exact(r, s, _t(xs), _t(vs), H, DS, SEG)))
    loss.backward()
    assert float(r.grad.abs().max()) > 0
    for t in ins[1:]:
        assert t.grad is not None and t.grad.shape == t.shape
        assert float(t.grad.abs().max()) == 0.0
    with pytest.raises(ValueError, match="must match rif"):
        TT.trace_sdf_exact(_t(rif), _t(sdf)[:-1], _t(xs), _t(vs), H, DS)
    with pytest.raises(ValueError, match="pln_o"):
        TT.trace_plane_exact(_t(rif), _t(x), _t(v), _t(o[:3]), _t(d), H, DS)
    with pytest.raises(ValueError, match="seg"):
        TT.trace_target_exact(_t(rif), _t(x), _t(v), _t(tgt), H, DS, 0)


def test_exact_variant_wrappers_refuse_cpu_tensors(scene):
    rif, x, v, o, d, tgt = (_t(a) for a in scene)
    order = torch.arange(x.shape[0], dtype=torch.int32)
    ck = torch.zeros((9, 7, x.shape[0]), dtype=torch.float64)
    c, code = torch.zeros(x.shape[0], dtype=torch.int32), torch.zeros(x.shape[0],
                                                                        dtype=torch.uint8)
    calls = [lambda: K.trace_plane_ckpt(rif, H, x, v, o, d, DS, STEPS, SEG, order),
             lambda: K.trace_target_ckpt(rif, H, x, v, tgt, DS, STEPS, SEG, order),
             lambda: K.trace_sdf_ckpt(rif, rif, H, x, v, DS, STEPS, SEG, order, c),
             lambda: K.backtrace_plane_exact(rif, H, ck, c, code, o, d, x, v, DS, SEG, order),
             lambda: K.backtrace_sdf_exact(rif, rif, H, ck, c, code, x, v, DS, SEG, order)]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()
    assert all(K.LAUNCHES[k] == 0 for k in ("trace_plane_ckpt", "trace_target_ckpt",
                                            "trace_sdf_ckpt", "backtrace_plane_exact",
                                            "backtrace_sdf_exact"))


def test_exact_backward_wrappers_take_the_exact_tally(scene, monkeypatch):
    """K6, K18 and K19 add to ``len(EXACT_TALLY)`` counters (K18's float4
    adds among them): their wrappers refuse a tally of K3's three, and hand a
    full one to the kernel.  The grid's device check and the launch are
    stubbed out, so that the argument checks run on the CPU."""
    rif, x, v, o, d, _ = (_t(a) for a in scene)
    n = x.shape[0]
    order = torch.arange(n, dtype=torch.int32)
    ck = torch.zeros((9, 7, n), dtype=torch.float64)
    c, code = torch.zeros(n, dtype=torch.int32), torch.zeros(n, dtype=torch.uint8)
    launched = []
    monkeypatch.setattr(K, "_check_grid", lambda data, name: None)
    monkeypatch.setattr(K, "_launch_on_grid", lambda name, data, *args: launched.append(
        (name, args)))
    calls = {
        "backtrace_exact": lambda t: K.backtrace_exact(rif, H, ck, c, code, x, v, DS, SEG, order,
                                                       tally=t),
        "backtrace_plane_exact": lambda t: K.backtrace_plane_exact(
            rif, H, ck, c, code, o, d, x, v, DS, SEG, order, tally=t),
        "backtrace_sdf_exact": lambda t: K.backtrace_sdf_exact(rif, rif, H, ck, c, code, x, v,
                                                               DS, SEG, order, tally=t)}
    assert K.EXACT_TALLY == ("runs", "issued", "adds", "float4_adds")
    for name, call in calls.items():
        for bad in (torch.zeros(3, dtype=torch.int64),
                    torch.zeros(len(K.EXACT_TALLY), dtype=torch.int32)):
            with pytest.raises(ValueError, match=rf"{name}: tally must be a contiguous int64 "
                                                 rf"\({len(K.EXACT_TALLY)},\)"):
                call(bad)
        tally = torch.zeros(len(K.EXACT_TALLY), dtype=torch.int64)
        call(tally)
        assert launched[-1][0] == name and tally.data_ptr() in launched[-1][1]
    assert [name for name, _ in launched] == list(calls)
    # K3's and K14's tallies keep their three counters
    K._check_tally(torch.zeros(3, dtype=torch.int64), rif, "backtrace")
    with pytest.raises(ValueError, match=r"\(3,\)"):
        K._check_tally(torch.zeros(len(K.EXACT_TALLY), dtype=torch.int64), rif, "backtrace")


def test_tracer_exports_every_name_of_the_jax_tracer():
    for name in JT.__all__:
        assert callable(getattr(TT, name)), name
    assert sorted(TT.__all__) == sorted(JT.__all__)


def test_trace_scan_matches_jax(scene):
    """The fixed-trip tape of the volume trace: its outputs and gradient
    against JAX ``trace_scan``, and its outputs against ``trace``'s."""
    rif, x, v = scene[:3]
    xj, vj = jnp.asarray(x), jnp.asarray(v)

    def jloss(r):
        xt, vt = JE.trace_scan(JG.GridField(r, H), xj, vj, DS, STEPS)
        return _loss(xt, vt), (xt, vt)

    (want_loss, want), want_g = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jnp.asarray(rif))
    r = _t(rif).requires_grad_(True)
    out = TT.trace_scan(TG.GridField(r, H), _t(x), _t(v), DS, STEPS)
    loss = _loss(*out)
    loss.backward()
    for got, ref in zip(out, want):
        _close(got, ref, 1e-12)
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-12 * abs(float(want_loss))
    _close(r.grad, want_g, 1e-9)
    plain = TE.trace(TG.GridField(_t(rif), H), _t(x), _t(v), DS, STEPS)
    assert all(torch.equal(a.detach(), b) for a, b in zip(out, plain))
