"""The z-band sweep of the slab ring's phases (``parallel/slabs.py::sweep_bands``).

CPU, f64 (conftest enables x64).  On the card a phase of the ring runs as
sweeps of launches over z-bands of its slab that L2 holds; here the same
sweep runs with the plain phases, whose band is otherwise the whole slab.
Held to: one plain phase over the whole slab (every state tensor bit for bit,
the gradient slab to ``1e-12`` of its largest entry: the splats are added in
another order), and, through the one-rank ring with small bands forced,
``api.trace`` (outputs bit for bit, gradient ``1e-9``) and the JAX package's
slab ring on one device (outputs ``1e-12``, gradient ``1e-9``).  Scenes are
made with numpy; the JAX rings are computed once for the module.
"""

import numpy as np
import pytest
import torch

from adjointnonlinearraytracing_tpu_torch import parallel as TP
from adjointnonlinearraytracing_tpu_torch.fields import grid as TG
from adjointnonlinearraytracing_tpu_torch.parallel import slabs as TS
from adjointnonlinearraytracing_tpu_torch.tracer import api

# the phase check: a 65^3 grid in 4 slabs, the phase of slab 1
RES, H = 65, 1.0
SPAN = (RES - 1) * H
DS = 0.5 * H
NDEV = 4
INNER = 60  # a phase's cap: the rays held in the waveguide reach it inside the slab
# the ring check: 17^3, the rings of one rank
RING_RES = 17
RING_SPAN = (RING_RES - 1) * H


def _waveguide(res):
    """A bump on a planar waveguide along z: the index peaks on the plane z =
    span / 2, so rays that cross it at a shallow angle are bent back across it
    (and across the band edges near it) again and again."""
    span = (res - 1) * H
    idx = np.arange(res) * H
    z, y, x = np.meshgrid(idx, idx, idx, indexing="ij")
    c = span / 2
    guide = 0.5 * np.exp(-((z - c) ** 2) / (2 * (span / 16) ** 2))
    bump = 0.2 * np.exp(-((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2) / (2 * (span / 4) ** 2))
    return 1.0 + guide + bump


def _rays(res, n, seed):
    """``n`` rays: a third up through z = 0, a third down through z = span,
    a third along x through the waveguide's plane with small |v_z|."""
    span = (res - 1) * H
    rng = np.random.default_rng(seed)
    k = n // 3
    xy = rng.uniform(0.2 * span, 0.8 * span, (2 * k, 2))
    t = 0.1 * rng.standard_normal((2 * k, 2))
    up = np.arange(2 * k) % 2 == 0
    x_z = np.stack([xy[:, 0], xy[:, 1], np.where(up, -0.4, span + 0.4)], axis=1)
    v_z = np.stack([t[:, 0], t[:, 1], np.where(up, 1.0, -1.0)], axis=1)
    m = n - 2 * k
    yz = rng.uniform(0.3 * span, 0.7 * span, (m, 2))
    yz[:, 1] = span / 2 + rng.uniform(-3.0, 3.0, m) * H
    x_x = np.stack([np.full(m, -0.4), yz[:, 0], yz[:, 1]], axis=1)
    v_x = np.stack([np.ones(m), 0.05 * rng.standard_normal(m), rng.uniform(-0.15, 0.15, m)],
                   axis=1)
    x, v = np.concatenate([x_z, x_x]), np.concatenate([v_z, v_x])
    return x, v / np.linalg.norm(v, axis=1, keepdims=True)


def _phase_case():
    """Slab 1 of the 65^3 waveguide in 4 slabs and a ray state part-way
    through a trace: positions spread over the grid's depth, step counts
    varied, so some rays start in the slab, some outside, some near their
    cap."""
    rif = torch.from_numpy(_waveguide(RES))
    S = TS.slab_rows(RES + 1, NDEV)
    z_first = S - 1
    slab = TS.pad_rif_z(rif, NDEV)[z_first:z_first + S + 1].contiguous()
    x, v = (torch.from_numpy(a) for a in _rays(RES, 300, 1))
    rng = np.random.default_rng(2)
    x = x.clone()
    n = x.shape[0]
    x[: n // 2, 2] = torch.from_numpy(rng.uniform(0.5, SPAN - 0.5, n // 2))
    cnt = torch.from_numpy(rng.integers(0, 40, n).astype(np.int32))
    return slab, z_first, S, x, v, cnt


def _fwd(case):
    slab, z_first, S, x, v, cnt = case
    shape = TS._grid_shape(slab, (RES,) * 3, H)
    return [x.clone(), v.clone(), x.clone(), v.clone(), TG.inbounds(shape, x),
            torch.zeros(x.shape[0], dtype=torch.bool), cnt.clone()]


def _bwd(case):
    slab, z_first, S, x, v, cnt = case
    shape = TS._grid_shape(slab, (RES,) * 3, H)
    rng = np.random.default_rng(3)
    la, mu = (torch.from_numpy(rng.standard_normal(x.shape)) for _ in range(2))
    return [x.clone(), v.clone(), la, mu, ~TG.escaped(shape, x, -v), cnt.clone()]


def _run(kind, band, case):
    """One phase of ``kind`` on the slab: the plain phase over the whole slab
    (``band`` None) or ``sweep_bands`` over bands of ``band`` cell rows with
    the plain phases.  Returns the state, the gradient slab (the adjoint),
    the pending word and the sweep's (sweeps, launches)."""
    slab, z_first, S, x, v, _ = case
    res = (RES,) * 3
    max_steps = 4 * RES * 2
    st = _fwd(case) if kind == "fwd" else _bwd(case)
    gslab = torch.zeros_like(slab)
    tol = TG.snap_tol(slab.dtype)

    def phase(start=None, bands=None):
        if kind == "fwd":
            return TS.slab_trace_phase_plain(slab, res, z_first, H, DS, *st, max_steps, INNER,
                                             start=start, bands=bands)
        return TS.slab_backtrace_phase_plain(slab, res, z_first, H, DS, tol, *st, gslab,
                                             max_steps, INNER, start=start, bands=bands)

    if band is None:
        return st, gslab, phase(), None
    start = st[-1].clone()
    pending, sweeps, launches = TS.sweep_bands(
        lambda windows, first, last: phase(start, [(z_first + lo, n) for lo, n in windows]),
        S, band)
    return st, gslab, pending, (sweeps, launches)


@pytest.fixture(scope="module")
def phase_case():
    return _phase_case()


@pytest.fixture(scope="module")
def whole_phases(phase_case):
    return {kind: _run(kind, None, phase_case) for kind in ("fwd", "bwd")}


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
@pytest.mark.parametrize("band", [1, 2, 3])
def test_band_sweep_equals_one_plain_phase(phase_case, whole_phases, kind, band):
    """The sweep over bands of 1-3 rows against one plain phase over the whole
    slab: every state tensor and the pending word bit for bit, the gradient
    slab to 1e-12; with bands of 1 and 2 rows the rays bent back across band
    edges take more than the one sweep that rays crossing the slab once
    need."""
    st, gslab, pending, (sweeps, launches) = _run(kind, band, phase_case)
    want, gwant, pwant, _ = whole_phases[kind]
    for a, b in zip(st, want):
        assert torch.equal(a, b)
    assert torch.equal(pending, pwant)
    assert launches == sweeps * len(TS.band_windows(phase_case[2], band))
    if band < 3:  # the rays bent back across the edges of thin bands take another sweep
        assert sweeps >= 2
    moved = st[-1] - phase_case[5]
    assert (moved == INNER).any() and ((moved > 0) & (moved < INNER)).any()
    if kind == "bwd":
        assert float(gwant.abs().max()) > 0
        np.testing.assert_allclose(gslab.numpy(), gwant.numpy(), rtol=0,
                                   atol=1e-12 * float(gwant.abs().max()))


def test_sweep_order_and_flags():
    """A sweep's launches: band j and band nb - 1 - j for j up through the bands,
    one window where the two meet, a launch like the one before it left out,
    the last band holding fewer rows; `first` on the phase's first launch
    only, `last` on each sweep's last; sweeps follow until a sweep's last
    launch reports no ray live."""
    assert TS.band_windows(10, 3) == [[(0, 4), (9, 2)], [(3, 7)], [(0, 4), (9, 2)]]
    assert TS.band_windows(17, 3) == [[(0, 4), (15, 3)], [(3, 4), (12, 4)], [(6, 7)],
                                      [(3, 4), (12, 4)], [(0, 4), (15, 3)]]
    assert TS.band_windows(17, 17) == [[(0, 18)]]
    calls = []
    lives = iter([1, 1, 0])

    def phase(windows, first, last):
        calls.append((windows, first, last))
        return torch.tensor([1, next(lives)], dtype=torch.int32) if last else None

    pending, sweeps, launches = TS.sweep_bands(phase, 10, 3)
    assert (sweeps, launches) == (3, 9)
    assert [c[0] for c in calls] == TS.band_windows(10, 3) * 3
    assert [c[1] for c in calls] == [True] + [False] * 8
    assert [i for i, c in enumerate(calls) if c[2]] == [2, 5, 8]
    assert pending.tolist() == [1]
    # one band: one launch, whatever it reports
    calls.clear()
    lives = iter([1])
    assert TS.sweep_bands(phase, 10, 10)[1:] == (1, 1)
    assert calls == [([(0, 11)], True, True)]


def test_band_height_rule():
    """L2 for a band's voxel rows: the slab's alone for K21, the slab's and its
    gradient's for K22; one launch over the slab where the rays fit one wave
    of the kernel, and off the card."""
    l2 = 50 * 2 ** 20  # an H100's L2, as the card reports it (52,428,800 bytes)
    row = 1025 * 1025 * 4
    assert TS.band_rows(row, l2, 1) == 11 and TS.band_rows(row, l2, 2) == 5
    assert TS.band_rows(257 * 257 * 4, l2, 2) == 98
    assert TS.band_rows(8 * row, l2, 2) == 1  # at least one row
    # rays that fit one wave of the kernel take one launch over the slab
    wave_fwd, wave_bwd = 168960, 67584  # an H100's waves of K21 and K22 in f32
    assert TS.band_height(1026, row, l2, 1, 1 << 18, wave_fwd) == 11
    assert TS.band_height(1026, row, l2, 2, 1 << 18, wave_bwd) == 5
    assert TS.band_height(257, row, l2, 1, 1 << 16, wave_fwd) == 257
    assert TS.band_height(257, row, l2, 2, 1 << 16, wave_bwd) == 257
    assert TS.band_height(513, row, l2, 2, 1 << 17, wave_bwd) == 5
    assert TS.band_height(3, row, l2, 1, 1 << 18, wave_fwd) == 3
    slab = torch.zeros((18, 5, 5), dtype=torch.float64)
    assert TS.slab_band(slab, 1, 1 << 20) == 17 and TS.slab_band(slab, 2, 1 << 20) == 17


def _ring_scene():
    x, v = _rays(RING_RES, 48, 4)
    return _waveguide(RING_RES), x, v


def _loss(xt, vt):
    return (xt ** 2 + xt * vt).sum()


@pytest.fixture(scope="module")
def jax_ring():
    """The JAX package's slab ring on one device: outputs and gradient."""
    import jax
    import jax.numpy as jnp
    from adjointnonlinearraytracing_tpu.parallel import mesh as JM
    from adjointnonlinearraytracing_tpu.parallel import slabs as JS

    rif, x, v = _ring_scene()
    mesh = JM.make_ray_mesh(jax.devices()[:1])
    out = {}
    for inner in (None, 3):
        f = JS.make_slab_trace(mesh, H, DS, RING_RES, inner_steps=inner)

        def loss(r):
            xt, vt = f(r, jnp.asarray(x), jnp.asarray(v))
            return _loss(xt, vt), (xt, vt)

        g, (xt, vt) = jax.jit(jax.grad(loss, has_aux=True))(jnp.asarray(rif))
        out[inner] = tuple(np.asarray(a) for a in (xt, vt, g))
    return out


@pytest.fixture(scope="module")
def api_trace():
    rif, x, v = _ring_scene()
    r = torch.from_numpy(rif).requires_grad_(True)
    xt, vt = api.trace(r, torch.from_numpy(x), torch.from_numpy(v), H, DS)
    _loss(xt, vt).backward()
    return xt.detach(), vt.detach(), r.grad


@pytest.mark.parametrize("inner", [None, 3])
@pytest.mark.parametrize("band", [1, 2, 3])
def test_one_rank_ring_with_small_bands(jax_ring, api_trace, band, inner, monkeypatch):
    """The one-rank ring (every phase holds the whole grid) with bands of 1-3
    rows put in place of the band rule (``slabs.slab_band``): outputs bit for bit against
    ``api.trace``, the gradient 1e-9 against it and against the JAX ring on
    one device; each phase's launches are its sweeps' over its bands."""
    rif, x, v = _ring_scene()
    mesh = TP.make_ray_mesh()
    monkeypatch.setattr(TS, "slab_band", lambda *args, **kwargs: band)
    f = TP.make_slab_trace_zsharded(mesh, H, DS, RING_RES, inner_steps=inner)
    q = torch.from_numpy(rif).requires_grad_(True)
    xt, vt = f(TP.pad_rif_z(q, 1)[:RING_RES + 1], torch.from_numpy(x), torch.from_numpy(v))
    _loss(xt, vt).backward()
    axt, avt, ag = api_trace
    assert torch.equal(xt, axt) and torch.equal(vt, avt)
    jxt, jvt, jg = jax_ring[inner]
    for got, want in ((xt, jxt), (vt, jvt)):
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-12)
    for want in (ag.numpy(), jg):
        np.testing.assert_allclose(q.grad.numpy(), want, rtol=0,
                                   atol=1e-9 * float(np.abs(want).max()))
    for key in ("fwd", "bwd"):
        run = f.ring.bands_run[key]
        assert len(run) == f.ring.phases_run[key]
        for b, per_sweep, sweeps, launches in run:
            assert b == band and per_sweep == len(TS.band_windows(RING_RES + 1, band))
            assert launches == sweeps * per_sweep
