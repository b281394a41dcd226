"""The ray order of ``tracer/order.py``, the plain adjoint's ``flushes`` count
and K3's path rule, on the CPU.

The order is new in the port (the JAX package runs rays as they come), so it
is held to what the kernels need of it: a permutation, a pure function of the
rays, neighbours in key order that are neighbours in the grid, and a trace
that does not depend on it.  ``flushes`` is held to a count made step by step
from the splats' own indices.  f64, seconds in all.
"""

import numpy as np
import pytest
import torch

from adjointnonlinearraytracing_tpu_torch.benchmarks.scenes import build_case
from adjointnonlinearraytracing_tpu_torch.fields import grid as G
from adjointnonlinearraytracing_tpu_torch.kernels import wrappers
from adjointnonlinearraytracing_tpu_torch.tracer import eikonal as E
from adjointnonlinearraytracing_tpu_torch.tracer import order as O


def _mixed_rays(n=300, seed=0):
    """Rays inside and outside a 9^3 box of span 1, some axis-aligned, some missing it."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.5, 1.5, (n, 3))
    v = rng.standard_normal((n, 3))
    v[: n // 5, 1:] = 0.0          # along x only
    v[n // 5: n // 4, :2] = 0.0    # along z only
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return torch.from_numpy(x), torch.from_numpy(v)


def test_order_is_a_permutation_and_its_inverse_restores_the_callers_order():
    x, v = _mixed_rays()
    order = O.ray_order(x, v, (9, 9, 9), 1.0 / 8)
    assert order.dtype == torch.int32 and order.shape == (x.shape[0],)
    assert torch.equal(torch.sort(order.long()).values, torch.arange(x.shape[0]))
    inverse = torch.empty_like(order)
    inverse[order.long()] = torch.arange(x.shape[0], dtype=torch.int32)
    assert torch.equal(x[order.long()][inverse.long()], x)
    # a pure function of the rays: the same call gives the same permutation
    assert torch.equal(O.ray_order(x, v, (9, 9, 9), 1.0 / 8), order)
    keys = O.ray_key(x, v, (9, 9, 9), 1.0 / 8)[order.long()]
    assert bool((keys[1:] >= keys[:-1]).all())


def test_entry_cells_of_hand_made_rays():
    h = 0.25  # 5^3 nodes, 4 cells an axis, box [0, 1]^3
    x = torch.tensor([[-1.0, 0.6, 0.3],    # enters through x = 0 at (0, 0.6, 0.3)
                      [0.3, 0.3, 0.8],     # starts inside
                      [0.5, 2.0, 0.5],     # enters through y = 1 moving -y
                      [-1.0, -1.0, 0.5],   # moves away: its start, clamped
                      [0.7, 0.2, -3.0]],   # along z only, enters at z = 0
                     dtype=torch.float64)
    v = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, -1.0, 0.0],
                      [-0.6, -0.8, 0.0], [0.0, 0.0, 1.0]], dtype=torch.float64)
    cells = O.entry_cells(x, v, (5, 5, 5), h)
    assert cells.tolist() == [[0, 2, 1], [1, 1, 3], [2, 3, 2], [0, 0, 2], [2, 0, 0]]
    keys = O.ray_key(x, v, (5, 5, 5), h)
    # dominant axis and sign first: +x rays before +y before -y before +z
    octant = (keys >> (3 * O.MORTON_BITS)).tolist()
    assert octant == [0, 2, 3, 3, 4]


def test_a_ray_at_rest_takes_its_start_cell():
    """A ray with no speed on any axis, outside the box or inside it, gets its
    start's clamped cell (outside, the slab parameters are all infinite and
    the entry point was 0 * inf: no cell at all)."""
    h = 0.25
    x = torch.tensor([[-0.5, -0.5, -0.5], [0.3, 0.6, 0.8], [2.0, 0.6, 0.3]],
                     dtype=torch.float64)
    v = torch.zeros_like(x)
    assert O.entry_cells(x, v, (5, 5, 5), h).tolist() == [[0, 0, 0], [1, 2, 3], [3, 2, 1]]
    order = O.ray_order(x, v, (5, 5, 5), h)
    assert sorted(order.tolist()) == [0, 1, 2]


def test_neighbours_in_key_order_are_neighbours_in_the_grid():
    """The bench scene's entry points are drawn at random: in key order the
    next ray's entry cell is far closer than in the given order."""
    rif, x0, v0, span = build_case(res=17, nrays=1024, dtype="float64", device="cpu")
    h = span / 16
    cells = O.entry_cells(x0, v0, rif.shape, h)
    order = O.ray_order(x0, v0, rif.shape, h).long()

    def mean_step(c):
        return float((c[1:] - c[:-1]).abs().sum(dim=1).double().mean())

    given, sorted_ = mean_step(cells), mean_step(cells[order])
    assert given > 5.0 and sorted_ < given / 5, (given, sorted_)
    # the rays enter through y = 0, moving +y: one octant, cell y = 0
    assert bool((cells[:, 1] == 0).all())


def test_trace_does_not_depend_on_the_order():
    """What K2 relies on: a ray's exit state is the same bit for bit whatever
    the other rays are, so running them permuted and putting them back is
    the identity; the gradient is a sum in another order."""
    rif, x0, v0, span = build_case(res=9, nrays=96, dtype="float64", device="cpu")
    h = span / 8
    ds = h / 2
    f = G.GridField(rif, h)
    order = O.ray_order(x0, v0, rif.shape, h).long()
    assert not torch.equal(order, torch.arange(96))
    nf, nb = E.max_steps_fwd(9, h, ds), E.max_steps_bwd(9, h, ds)
    xt, vt = E.trace(f, x0, v0, ds, nf)
    xt_o, vt_o = E.trace(f, x0[order], v0[order], ds, nf)
    inverse = torch.argsort(order)
    assert torch.equal(xt_o[inverse], xt) and torch.equal(vt_o[inverse], vt)
    dx, dv = 2.0 * xt, torch.ones_like(vt)
    g = E.backtrace(f, xt, vt, dx, dv, ds, nb)
    g_o = E.backtrace(f, xt[order], vt[order], dx[order], dv[order], ds, nb)
    assert float(g.abs().max()) > 0
    assert float((g - g_o).abs().max()) <= 1e-12 * float(g.abs().max())


@pytest.mark.parametrize("res", [3, 9])
def test_flushes_equal_a_count_of_the_splats_own_stencils(monkeypatch, res):
    """``flushes`` against a count of the runs made from every splat's 8
    indices, ray by ray, as the plain version scatters them."""
    rng = np.random.default_rng(res)
    span, n = 1.0, 12
    h, ds = span / (res - 1), 1.0 / 32
    data = torch.from_numpy(1.0 + 0.05 * rng.uniform(size=(res, res, res)))
    f = G.GridField(data, h)
    xz = rng.uniform(0.1, 0.9, (n, 2))
    x0 = np.stack([xz[:, 0], np.full(n, -0.1), xz[:, 1]], axis=1)
    v0 = np.stack([0.3 * rng.standard_normal(n), np.ones(n), 0.3 * rng.standard_normal(n)], 1)
    x0[: n // 3] = rng.uniform(0.2, 0.8, (n // 3, 3))  # some start inside
    v0 /= np.linalg.norm(v0, axis=1, keepdims=True)
    x0, v0 = torch.from_numpy(x0), torch.from_numpy(v0)
    xt, vt = E.trace(f, x0, v0, ds, E.max_steps_fwd(res, h, ds))
    dx, dv = torch.from_numpy(rng.standard_normal((n, 3))), torch.from_numpy(
        rng.standard_normal((n, 3)))

    steps = []
    scatter = G.scatter_into

    def recording_scatter(acc, field, p, val, grad, mask=None):
        idx = G._stencil(field, p)[0].reshape(8, -1).T  # (N, 8)
        steps.append([(tuple(idx[r].tolist()) if bool(mask[r]) else None) for r in range(n)])
        return scatter(acc, field, p, val, grad, mask)

    monkeypatch.setattr(G, "scatter_into", recording_scatter)
    stats = {}
    E.backtrace(f, xt, vt, dx, dv, ds, E.max_steps_bwd(res, h, ds), stats=stats)

    runs = 0
    for r in range(n):
        targets = [row[r] for row in steps if row[r] is not None]
        runs += sum(1 for k, t in enumerate(targets) if k == 0 or t != targets[k - 1])
    assert stats["flushes"] == runs
    assert n // 2 <= runs < stats["splats"]
    if res == 3:  # h / ds = 16 steps a cell along an axis: long runs
        assert stats["splats"] > 5 * runs


@pytest.mark.parametrize("dtype, res, path", [
    (torch.float32, 33, "shared"), (torch.float32, 38, "shared"),
    (torch.float32, 39, "global"), (torch.float32, 65, "global"),
    (torch.float32, 128, "global"), (torch.float32, 3, "shared"),
    (torch.float64, 30, "shared"), (torch.float64, 31, "global"),
    (torch.float64, 17, "shared"), (torch.float64, 33, "global"),
])
def test_backtrace_path_follows_the_byte_rule(dtype, res, path):
    assert wrappers.backtrace_path(res ** 3, dtype) == path
    size = torch.empty((), dtype=dtype).element_size()
    assert (res ** 3 * size <= wrappers.SHARED_BYTES_MAX) == (path == "shared")


def test_backtrace_path_at_the_byte_limit():
    limit = wrappers.SHARED_BYTES_MAX
    assert limit == 227 * 1024 and limit % 8 == 0
    assert wrappers.backtrace_path(limit // 4, torch.float32) == "shared"
    assert wrappers.backtrace_path(limit // 4 + 1, torch.float32) == "global"
    assert wrappers.backtrace_path(limit // 8, torch.float64) == "shared"
    assert wrappers.backtrace_path(limit // 8 + 1, torch.float64) == "global"
