"""Exit-step compaction (``tracer/compaction.py``) of the port against the JAX
package's, and the choice of buckets in ``experiments.common.make_trace``.

CPU, f64 (conftest enables x64).  The scene is the JAX package's own spread
case (``tests/test_compaction.py``), made with numpy and handed to both.
Tolerances: the chord statistics ``1e-12`` relative; the bucketed outputs
equal to ``api.trace``'s bit for bit (bucketing permutes rays and nothing
else), the gradient ``1e-10`` of its largest magnitude (the same terms summed
in another order); against the JAX package's per-shard bucketing ``1e-12``
forward and ``1e-9`` gradient, as the port's tracer is held.  The drivers'
picks are held to JAX's in ``test_torch_bucket_picks.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adjointnonlinearraytracing_tpu.parallel import mesh as JM
from adjointnonlinearraytracing_tpu.tracer import compaction as JCP
from adjointnonlinearraytracing_tpu_torch.parallel import mesh as TM
from adjointnonlinearraytracing_tpu_torch.tracer import api as TAPI
from adjointnonlinearraytracing_tpu_torch.tracer import compaction as TCP


def _spread_case(res=17, n=96, span=4.0, seed=3):
    """Rays entering a bump through the y = 0 face at pitches from grazing to
    steep: chords from a few steps to the whole volume."""
    rng = np.random.default_rng(seed)
    x = np.stack([rng.uniform(0, span, n), np.full(n, -1e-3), rng.uniform(0, span, n)], axis=1)
    pitch = rng.uniform(0.05, 1.0, n)
    yaw = rng.uniform(0, 2 * np.pi, n)
    horiz = np.sqrt(1 - pitch ** 2)
    v = np.stack([horiz * np.cos(yaw), pitch, horiz * np.sin(yaw)], axis=1)
    idx = np.arange(res) * (span / (res - 1))
    z, y, xx = np.meshgrid(idx, idx, idx, indexing="ij")
    c = span / 2
    rif = 1.0 + 0.1 * np.exp(-((xx - c) ** 2 + (y - c) ** 2 + (z - c) ** 2) / (span / 3) ** 2)
    return rif, x, v, span / (res - 1)


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _loss(trace, rif, x, v):
    n = torch.from_numpy(rif).requires_grad_(True)
    xt, vt = trace(n, x, v)
    ((xt ** 2).sum() + (xt * vt).sum()).backward()
    return xt.detach(), vt.detach(), n.grad


@pytest.fixture(scope="module")
def plain_trace():
    """The scene, and the port's unbucketed outputs and gradient."""
    rif, x, v, h = _spread_case()
    xt, vt, g = _loss(lambda n, a, b: TAPI.trace(n, a, b, h, h / 2), rif, *_t(x, v))
    return rif, x, v, h, (xt, vt, g)


def test_chord_statistics_match_jax():
    rif, x, v, h = _spread_case()
    ds = h / 2
    got = TCP.chord_steps(rif.shape, h, *_t(x, v), ds).numpy()
    want = np.asarray(JCP.chord_steps(rif.shape, h, jnp.asarray(x), jnp.asarray(v), ds))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    # a ray through the middle, one that misses, one at rest on a face
    span = (rif.shape[0] - 1) * h
    edge = np.array([[span / 2, -1.0, span / 2], [span * 10, -1.0, span / 2], [0.0, 1.0, 1.0]])
    dirs = np.array([[0.0, 1.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 0.0]])
    got = TCP.chord_steps(rif.shape, h, *_t(edge, dirs), ds).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(JCP.chord_steps(rif.shape, h, jnp.asarray(edge), jnp.asarray(dirs), ds)))
    assert abs(got[0] - span / ds) < 3 and got[1] == 0.0 and np.isfinite(got).all()
    spread = TCP.chord_spread(rif.shape, h, *_t(x, v), ds)
    assert spread >= 2.0
    assert abs(spread - JCP.chord_spread(rif.shape, h, jnp.asarray(x), jnp.asarray(v), ds)) \
        <= 1e-12 * spread
    for s in (4.0, 40.0):  # the pick does not depend on the span
        assert TCP.auto_buckets(s, *_t(x, v), ds) == JCP.auto_buckets(
            s, jnp.asarray(x), jnp.asarray(v), ds) == 4
    straight = np.tile([[0.0, 0.0, 1.0]], (96, 1))
    assert TCP.auto_buckets(4.0, *_t(x, straight), ds) == 0 == JCP.auto_buckets(
        4.0, jnp.asarray(x), jnp.asarray(straight), ds)


@pytest.mark.parametrize("k", [2, 4])
def test_trace_bucketed_equals_trace(plain_trace, k):
    rif, x, v, h, (xt0, vt0, g0) = plain_trace
    xt, vt, g = _loss(lambda n, a, b: TCP.trace_bucketed(n, a, b, h, h / 2, nbuckets=k),
                      rif, *_t(x, v))
    assert torch.equal(xt, xt0) and torch.equal(vt, vt0)
    np.testing.assert_allclose(g.numpy(), g0.numpy(), rtol=0,
                               atol=1e-10 * float(g0.abs().max()))
    assert float(g0.abs().max()) > 0


def test_indivisible_batches_fall_back_to_one_trace(plain_trace, monkeypatch):
    rif, x, v, h, _ = plain_trace
    calls = []
    real = TAPI.trace

    def counted(rif_, x_, v_, h_, ds_):
        calls.append(x_.shape[0])
        return real(rif_, x_, v_, h_, ds_)

    monkeypatch.setattr(TAPI, "trace", counted)
    xs, vs = _t(x[:95], v[:95])
    xt, vt = TCP.trace_bucketed(torch.from_numpy(rif), xs, vs, h, h / 2, nbuckets=4)
    assert calls == [95]
    xt0, vt0 = real(torch.from_numpy(rif), xs, vs, h, h / 2)
    assert torch.equal(xt, xt0) and torch.equal(vt, vt0)
    calls.clear()
    TCP.trace_bucketed(torch.from_numpy(rif), *_t(x, v), h, h / 2, nbuckets=4)
    assert calls == [24] * 4
    calls.clear()
    TCP.trace_bucketed(torch.from_numpy(rif), *_t(x, v), h, h / 2, nbuckets=1)
    assert calls == [96]


def test_per_shard_bucketing(plain_trace, monkeypatch):
    """``make_sharded_trace(nbuckets=4)`` on this process's mesh of one rank:
    four forward passes over the chord order (``api.trace`` a bucket) and four
    adjoint sweeps, the outputs bitwise and the gradient as unbucketed;
    against the JAX package's per-shard bucketing on its 8 virtual devices
    (12 rays a shard, 3 a bucket)."""
    monkeypatch.setenv("ANRT_FAST_PATH", "classic")
    rif, x, v, h, (xt0, vt0, g0) = plain_trace
    ds = h / 2
    fwd, bwd = [], []
    real_fwd, real_adj = TAPI.trace, TAPI._adjoint
    monkeypatch.setattr(TAPI, "trace", lambda r, a, *rest: fwd.append(a.shape[0])
                        or real_fwd(r, a, *rest))
    monkeypatch.setattr(TAPI, "_adjoint", lambda r, hh, dd, a, *rest: bwd.append(a.shape[0])
                        or real_adj(r, hh, dd, a, *rest))
    sharded = TM.make_sharded_trace(TM.make_ray_mesh(), h, ds, rif.shape[0], nbuckets=4)
    xt, vt, g = _loss(sharded, rif, *_t(x, v))
    assert fwd == [24] * 4 and bwd == [24] * 4
    assert torch.equal(xt, xt0) and torch.equal(vt, vt0)
    np.testing.assert_allclose(g.numpy(), g0.numpy(), rtol=0,
                               atol=1e-10 * float(g0.abs().max()))

    jf = JM.make_sharded_trace(JM.make_ray_mesh(), h, ds, rif.shape[0], nbuckets=4)
    jx, jv = jnp.asarray(x), jnp.asarray(v)

    def jloss(r):
        a, b = jf(r, jx, jv)
        return jnp.sum(a ** 2) + jnp.sum(a * b), a

    jg, jxt = jax.jit(jax.grad(jloss, has_aux=True))(jnp.asarray(rif))
    np.testing.assert_allclose(xt.numpy(), np.asarray(jxt), rtol=0, atol=1e-12)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0,
                               atol=1e-9 * float(np.abs(np.asarray(jg)).max()))
