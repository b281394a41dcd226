"""The port's ``fields/grid.py`` against the JAX package's, function by function.

CPU, f64 (conftest enables x64).  Inputs are made with numpy from a seed and
handed to both sides.  Tolerance: ``RTOL = 1e-12`` relative to the reference's
largest magnitude — both sides do the same f64 arithmetic in a different
summation order, so only rounding separates them.  Integer and boolean results
must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adjointnonlinearraytracing_tpu.benchmarks import probe_evalmath as PE
from adjointnonlinearraytracing_tpu.fields import grid as JG
from adjointnonlinearraytracing_tpu.fields import windows as JW
from adjointnonlinearraytracing_tpu_torch.fields import grid as TG

RTOL = 1e-12
H = 0.8
SHAPE = (7, 8, 9)  # (D, H, W): all different, so a transposed layout would show


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(1.0, np.abs(want).max()))


@pytest.fixture(scope="module")
def case():
    """Field, points (in-grid, far off-grid, on nodes, on the far faces), mask, vectors."""
    rng = np.random.default_rng(0)
    data = 1.0 + rng.uniform(size=SHAPE)
    d, hgt, wid = SHAPE
    hi = (np.array([wid, hgt, d]) - 1) * H
    inside = rng.uniform(0, 1, (64, 3)) * hi
    far = rng.uniform(-2, 3, (32, 3)) * hi
    nodes = rng.integers(0, [wid, hgt, d], (24, 3)) * H
    face = rng.uniform(0, 1, (24, 3)) * hi
    face[np.arange(24), np.arange(24) % 3] = hi[np.arange(24) % 3]  # on a far face
    face[np.arange(6), (np.arange(6) + 1) % 3] = 0.0                 # and a near one
    p = np.concatenate([inside, far, nodes, face])
    n = p.shape[0]
    out = dict(data=data, p=p, mask=rng.uniform(size=n) < 0.7,
               v=rng.standard_normal((n, 3)), val=rng.standard_normal(n),
               g=rng.standard_normal((n, 3)), u=rng.standard_normal(SHAPE))
    out["jf"] = JG.GridField(jnp.asarray(data), H)
    out["tf"] = TG.GridField(torch.from_numpy(data), H)
    out["tp"] = torch.from_numpy(p)
    out["tmask"] = torch.from_numpy(out["mask"])
    return out


def test_res_and_from_flat(case):
    assert case["tf"].res == case["jf"].res == (9, 8, 7)
    f = TG.GridField.from_flat(case["tf"].data.reshape(-1), case["tf"].res, H)
    assert torch.equal(f.data, case["tf"].data)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("fn", ["eval_grad", "eval_grad_plain"])
def test_eval_grad(case, fn, masked):
    jm, tm = (case["mask"], case["tmask"]) if masked else (None, None)
    n_ref, g_ref = JG.eval_grad(case["jf"], jnp.asarray(case["p"]), jm)
    n, g = getattr(TG, fn)(case["tf"], case["tp"], tm)
    _close(n, n_ref)
    _close(g, g_ref)
    if masked:
        assert torch.all(n[~tm] == 0) and torch.all(g[~tm] == 0)


@pytest.mark.parametrize("masked", [False, True])
def test_eval_hess_and_matvec(case, masked):
    jm, tm = (case["mask"], case["tmask"]) if masked else (None, None)
    ref = JG.eval_hess(case["jf"], jnp.asarray(case["p"]), jm)
    got = TG.eval_hess(case["tf"], case["tp"], tm)
    for a, b in zip(got, ref):
        _close(a, b)
    _close(TG.hess_matvec(got, torch.from_numpy(case["v"])),
           JG.hess_matvec(ref, jnp.asarray(case["v"])))


@pytest.mark.parametrize("masked", [False, True])
def test_splat_delta_and_scatter_into(case, masked):
    jm, tm = (case["mask"], case["tmask"]) if masked else (None, None)
    ref = JG.splat_delta(case["jf"], jnp.asarray(case["p"]), jnp.asarray(case["val"]),
                         jnp.asarray(case["g"]), jm)
    val, g = torch.from_numpy(case["val"]), torch.from_numpy(case["g"])
    got = TG.splat_delta(case["tf"], case["tp"], val, g, tm)
    _close(got, ref)
    acc0 = np.random.default_rng(1).standard_normal(ref.shape)
    acc = torch.from_numpy(acc0.copy())
    ret = TG.scatter_into(acc, case["tf"], case["tp"], val, g, tm)
    assert ret is acc  # in place
    _close(acc, JG.scatter_into(jnp.asarray(acc0), case["jf"], jnp.asarray(case["p"]),
                                jnp.asarray(case["val"]), jnp.asarray(case["g"]), jm))


def test_splat_is_transpose_of_eval(case):
    """<splat_delta(p, val, g), u> == sum(val * n_u(p) + g . grad_u(p))."""
    val, g = torch.from_numpy(case["val"]), torch.from_numpy(case["g"])
    delta = TG.splat_delta(case["tf"], case["tp"], val, g)
    uf = TG.GridField(torch.from_numpy(case["u"]), H)
    n_u, grad_u = TG.eval_grad(uf, case["tp"])
    lhs = float(delta @ uf.data.reshape(-1))
    rhs = float((val * n_u).sum() + (g * grad_u).sum())
    assert abs(lhs - rhs) <= 1e-11 * max(1.0, abs(rhs))


def test_inbounds_escaped(case):
    p, v = case["p"], case["v"]
    assert np.array_equal(TG.inbounds(case["tf"], case["tp"]).numpy(),
                          np.asarray(JG.inbounds(case["jf"], jnp.asarray(p))))
    # the far-face points are the interesting ones: on the face is outside
    assert not TG.inbounds(case["tf"], case["tp"][-24:]).any()
    assert np.array_equal(TG.escaped(case["tf"], case["tp"], torch.from_numpy(v)).numpy(),
                          np.asarray(JG.escaped(case["jf"], jnp.asarray(p), jnp.asarray(v))))


@pytest.mark.parametrize("tol", [None, 1e-3])
def test_snap_to_nodes(case, tol):
    rng = np.random.default_rng(2)
    drift = rng.choice([0.0, 1e-13, -1e-13, 1e-5, -1e-5, 1e-2], size=case["p"].shape)
    p = case["p"] + drift * H
    ref = np.asarray(JG.snap_to_nodes(jnp.asarray(p), H, tol))
    got = TG.snap_to_nodes(torch.from_numpy(p), H, tol).numpy()
    assert np.array_equal(got, ref)
    assert (got != p).any()  # something was snapped


def test_f32_eval_matches_f32_reference(case):
    """One f32 case: same arithmetic at single precision, 1e-4 relative."""
    jf = JG.GridField(jnp.asarray(case["data"], jnp.float32), H)
    tf = TG.GridField(torch.from_numpy(case["data"]).float(), H)
    n_ref, g_ref = JG.eval_grad(jf, jnp.asarray(case["p"], jnp.float32))
    n, g = TG.eval_grad(tf, case["tp"].float())
    assert n.dtype == torch.float32 and g.dtype == torch.float32
    _close(n, n_ref, 1e-4)
    _close(g, g_ref, 1e-4)


@pytest.mark.parametrize("shape,new_res", [
    ((6,), 11), ((5, 5), (9, 7)), ((4, 4, 4), 7), ((5, 5, 5), (9, 9, 9)), ((9, 9, 9), 5),
    ((3, 3, 3), 3)])
def test_upres_volume(shape, new_res):
    """1D/2D/3D, up, down and same size; nodes of the coarse grid keep their values."""
    n = np.random.default_rng(4).uniform(size=shape)
    got = TG.upres_volume(torch.from_numpy(n), new_res)
    want = JG.upres_volume(jnp.asarray(n), new_res)
    assert got.dtype == torch.float64
    _close(got, want)
    if new_res == 3:
        _close(got, n)
    assert TG.upres_volume(torch.from_numpy(n).float(), new_res).dtype == torch.float32


def test_eval_grad_against_the_pallas_kernel_it_replaces():
    """The port's eval_grad against ``_pl_eval_kernel`` run in interpret mode.

    512 in-grid points of a 9^3 f32 grid.  The Pallas kernel evaluates a
    gathered 5^3 window row from packed (offset, w0) with h = 1, so its three
    gradient columns are scaled by 1/h here.  Tolerance 1e-5: the kernel's own
    bar (f32, a different contraction order).
    """
    from jax.experimental import pallas as pl

    rng = np.random.default_rng(3)
    h, res, n = 0.7, 9, PE.BLK
    data = (1.0 + rng.uniform(size=(res, res, res))).astype(np.float32)
    p = (rng.uniform(0.0, 1.0, (n, 3)) * (res - 1) * h).astype(np.float32)

    @jax.jit  # one compile instead of one per eager op of the table build
    def window_rows(data, p):
        wf = JW.build_window_table(JG.GridField(data, h))
        return JW.fetch_window(wf, p)

    W, a3, ci3, w0 = window_rows(jnp.asarray(data), jnp.asarray(p))
    offpack = jnp.concatenate(
        [(ci3 - a3).astype(jnp.float32), w0, jnp.zeros((n, 2), jnp.float32)], axis=1)
    row = W.shape[1]
    out = pl.pallas_call(
        PE._pl_eval_kernel,
        grid=(1,),
        in_specs=[pl.BlockSpec((n, row), lambda i: (i, 0)),
                  pl.BlockSpec((n, 8), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((n, row), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((n, row), jnp.float32),
        interpret=True,
    )(W, offpack)
    out = np.asarray(out)

    n_t, g_t = TG.eval_grad_plain(TG.GridField(torch.from_numpy(data), h),
                                  torch.from_numpy(p))
    np.testing.assert_allclose(n_t.numpy(), out[:, 0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(g_t.numpy(), out[:, 1:4] / h, rtol=0, atol=1e-5)
