"""``fields/cells.py``, ``fields.grid.splat`` and the ``fields`` exports of the
port against the JAX package's, and the port's plain stencil math (the math
``kernels/csrc/trilinear.cuh`` repeats) against the JAX cell-table math.

CPU, f64 (conftest enables x64), tolerance ``1e-12`` of the reference's
largest magnitude; indices must be equal.  The JAX references are computed
once, in one jit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import adjointnonlinearraytracing_tpu.fields as JF
from adjointnonlinearraytracing_tpu.fields import cells as JC
from adjointnonlinearraytracing_tpu.fields import grid as JG
import adjointnonlinearraytracing_tpu_torch.fields as TF
from adjointnonlinearraytracing_tpu_torch.fields import cells as TC
from adjointnonlinearraytracing_tpu_torch.fields import grid as TG

RTOL = 1e-12
SHAPE = (5, 6, 7)  # (D, H, W): a grid that is not a cube
# a power of two: points on nodes and faces take the same floor whether p / h
# is a division (the port, and eager JAX) or a multiply by 1 / h (jitted JAX)
H = 0.25
NPTS = 200


def _inputs():
    rng = np.random.default_rng(5)
    data = 1.0 + 0.3 * rng.random(SHAPE)
    hi = np.array([SHAPE[2] - 1, SHAPE[1] - 1, SHAPE[0] - 1]) * H
    # points inside, outside on every side, and on nodes and faces
    p = rng.uniform(-0.3, 1.3, (NPTS, 3)) * hi
    p[:20] = np.round(p[:20] / H) * H
    p[20:30, 0] = hi[0]
    mask = rng.random(NPTS) < 0.8
    val = rng.standard_normal(NPTS)
    grad = rng.standard_normal((NPTS, 3))
    return data, p, mask, val, grad


def _jax_refs(data, p, mask, val, grad):
    f = JG.GridField(data, H)
    cf = JC.build_cell_table(f)
    ci, w0 = JC.cell_index(cf, p)
    vals, w0f, cif = JC.fetch(cf, p, mask)
    rows = JC.splat_rows(w0, val, grad, H, mask)
    cg = JC.scatter_rows(JC.zero_cell_grad(cf), ci, rows)
    return dict(table=cf.table, ci=ci, w0=w0, vals=vals, w0f=w0f, cif=cif,
                eval=JC.eval_grad_from(vals, w0f, H), hess=JC.eval_hess_from(vals, w0f, H),
                rows=rows, cell_grad=cg, folded=JC.fold_cell_grad(cg, cf),
                splat=JG.splat(f, p, val, grad, mask).data)


@pytest.fixture(scope="module")
def case():
    args = _inputs()
    refs = jax.tree_util.tree_map(np.asarray, jax.jit(_jax_refs)(*map(jnp.asarray, args)))
    data, p, mask, val, grad = map(torch.from_numpy, args)
    f = TG.GridField(data, H)
    return dict(refs=refs, field=f, cf=TC.build_cell_table(f), p=p, mask=mask, val=val,
                grad=grad)


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(1.0, np.abs(want).max()))


def test_build_cell_table_and_cell_index(case):
    r, cf = case["refs"], case["cf"]
    assert cf.res == (SHAPE[2], SHAPE[1], SHAPE[0]) and cf.h == H
    assert torch.equal(cf.table, torch.from_numpy(r["table"]))
    assert cf.flat.shape == (np.prod([s + 1 for s in SHAPE]), 8)
    ci, w0 = TC.cell_index(cf, case["p"])
    assert np.array_equal(ci.numpy(), r["ci"])
    _close(w0, r["w0"])


def test_fetch(case):
    r = case["refs"]
    vals, w0, ci = TC.fetch(case["cf"], case["p"], case["mask"])
    _close(vals, r["vals"])
    _close(w0, r["w0f"])
    assert np.array_equal(ci.numpy(), r["cif"])
    assert not bool(vals[~case["mask"]].any())


def test_eval_grad_and_hess_from(case):
    r = case["refs"]
    vals, w0 = torch.from_numpy(r["vals"]), torch.from_numpy(r["w0f"])
    for got, want in zip(TC.eval_grad_from(vals, w0, H), r["eval"]):
        _close(got, want)
    for got, want in zip(TC.eval_hess_from(vals, w0, H), r["hess"]):
        _close(got, want)


def test_splat_rows_scatter_and_fold(case):
    r, cf = case["refs"], case["cf"]
    ci, w0 = TC.cell_index(cf, case["p"])
    rows = TC.splat_rows(w0, case["val"], case["grad"], H, case["mask"])
    _close(rows, r["rows"])
    zero = TC.zero_cell_grad(cf)
    assert zero.shape == (cf.flat.shape[0], 8) and not bool(zero.any())
    cg = TC.scatter_rows(zero, ci, rows)
    assert not bool(zero.any())  # a new tensor, as JAX's functional update
    _close(cg, r["cell_grad"])
    _close(TC.fold_cell_grad(cg, cf), r["folded"])


def test_grid_splat(case):
    f = case["field"]
    out = TG.splat(f, case["p"], case["val"], case["grad"], case["mask"])
    assert isinstance(out, TG.GridField) and out.h == H
    _close(out.data, case["refs"]["splat"])
    assert not torch.equal(out.data, f.data)


def test_plain_stencil_math_equals_the_jax_cell_math(case):
    """The port's plain value + gradient, Hessian and splat (the math the
    kernels repeat on the raw grid's 8 corners) against the JAX cell-table
    forms on the same corners: ``eval_grad_from``, ``eval_hess_from``, and
    ``splat_rows`` scattered and folded back onto the voxels."""
    r, f, p, mask = case["refs"], case["field"], case["p"], case["mask"]
    for got, want in zip(TG.eval_grad_plain(f, p, mask), r["eval"]):
        _close(got, want)
    for got, want in zip(TG.eval_hess(f, p, mask), r["hess"]):
        _close(got, want)
    delta = TG.splat_delta(f, p, case["val"], case["grad"], mask)
    _close(delta.reshape(SHAPE), r["folded"])


def test_fields_exports_every_name_of_the_jax_fields():
    names = set(JF.__all__) | {n for n in vars(JF) if not n.startswith("_")
                               and not isinstance(getattr(JF, n), type(JF))}
    assert {"CellField", "build_cell_table", "get_pts_sdf", "get_opp_pts", "cyl_render",
            "cyl_render2", "render_gradient"} <= names
    for name in names:
        assert hasattr(TF, name), name
    assert sorted(TF.__all__) == sorted(JF.__all__)
