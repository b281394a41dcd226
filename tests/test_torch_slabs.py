"""The z-slab ring (``parallel/slabs.py``) of the port against the JAX package's.

CPU, f64 (conftest enables x64).  A smooth bump in a 9^3 grid, made with
numpy and handed to both packages.  The JAX ring runs on a mesh of two of its
virtual devices; the port's on two gloo ranks, started by running this file
as a script in two processes (rank 0 writes what both computed), and on one
rank in this process.  Each rank passes its own rows of ``pad_rif_z``; the
gradient of the whole grid is the ranks' row gradients summed.  Tolerances:
outputs ``1e-12``, gradients ``1e-9`` of their largest magnitude (the sums
run in another order); a truncated ring must poison the same lanes with NaN
as JAX's does.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from adjointnonlinearraytracing_tpu_torch import parallel as TP
from adjointnonlinearraytracing_tpu_torch.fields import grid as TG
from adjointnonlinearraytracing_tpu_torch.kernels import wrappers as TK
from adjointnonlinearraytracing_tpu_torch.parallel import slabs as TS
from adjointnonlinearraytracing_tpu_torch.tracer import api

ROOT = Path(__file__).resolve().parent.parent
RES, H, DS = 9, 1.0, 0.5
SPAN = (RES - 1) * H
WORLD = 2
#: the rings of the two-rank run: name -> (function, keyword arguments, scene)
CASES = {
    "z": ("zsharded", {}, "cross"),
    "z_inner1": ("zsharded", dict(inner_steps=1), "cross"),
    "z_truncated": ("zsharded", dict(phase_slack=-3), "cross"),
    "plane": ("plane", {}, "entry"),
    "full": ("full", {}, "cross"),
    "down": ("full", {}, "down"),
}


def _rif():
    idx = np.arange(RES) * H
    z, y, x = np.meshgrid(idx, idx, idx, indexing="ij")
    c = SPAN / 2
    return 1.0 + 0.2 * np.exp(-((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2) / (2 * (SPAN / 4) ** 2))


def _rays(scene):
    """``cross``: 16 tilted rays, alternately up through z = 0 and down through
    z = span (every slab, both ways); ``down``: the JAX test's downward rays;
    ``entry``: 32 rays entering through y = 0, with planes at y = span / 2."""
    rng = np.random.default_rng({"cross": 0, "down": 3, "entry": 7}[scene])
    if scene == "entry":
        n = 32
        xz = rng.uniform(0.25 * SPAN, 0.75 * SPAN, (n, 2))
        x = np.stack([xz[:, 0], np.full(n, -0.5), xz[:, 1]], axis=1)
        t = 0.1 * rng.standard_normal((n, 2))
        v = np.stack([t[:, 0], np.ones(n), t[:, 1]], axis=1)
    elif scene == "down":
        n = 16
        xz = rng.uniform(0.3 * SPAN, 0.7 * SPAN, (n, 2))
        x = np.stack([xz[:, 0], xz[:, 1], np.full(n, SPAN + 0.4)], axis=1)
        v = np.tile([[0.02, -0.03, -1.0]], (n, 1))
    else:
        n = 16
        xy = rng.uniform(0.25 * SPAN, 0.75 * SPAN, (n, 2))
        up = np.arange(n) % 2 == 0
        x = np.stack([xy[:, 0], xy[:, 1], np.where(up, -0.4, SPAN + 0.4)], axis=1)
        t = 0.1 * rng.standard_normal((n, 2))
        v = np.stack([t[:, 0], t[:, 1], np.where(up, 1.0, -1.0)], axis=1)
    v = v / np.linalg.norm(v, axis=1, keepdims=True)
    po = np.tile([[0.0, SPAN / 2, 0.0]], (x.shape[0], 1))
    pd = np.tile([[0.0, 1.0, 0.0]], (x.shape[0], 1))
    return x, v, po, pd


def _loss(xt, vt, miss=None):
    per = xt ** 2 + xt * vt
    if miss is not None:
        per = (~miss).to(per.dtype)[:, None] * per
    return per.sum()


def _port_run(mesh, name):
    """One ring of :data:`CASES` on ``mesh``: outputs and the whole grid's gradient."""
    kind, kw, scene = CASES[name]
    x, v, po, pd = (torch.from_numpy(a) for a in _rays(scene))
    r = torch.from_numpy(_rif()).requires_grad_(True)
    if kind == "full":
        out = TP.make_slab_trace(mesh, H, DS, RES, **kw)(r, x, v)
    else:
        f = TP.make_slab_trace_zsharded(mesh, H, DS, RES, variant="plane" if kind == "plane"
                                        else "plain", **kw)
        S = TP.slab_rows(RES + 1, mesh.world_size)
        rows = TP.pad_rif_z(r, mesh.world_size)[mesh.rank * S:(mesh.rank + 1) * S]
        out = f(rows, x, v, po, pd) if kind == "plane" else f(rows, x, v)
    _loss(*out).backward()
    g = r.grad if kind == "full" else mesh.all_reduce(r.grad)
    res = {"xt": out[0], "vt": out[1], "g": g}
    if kind == "plane":
        res["miss"] = out[2]
    return {f"{name}_{k}": t.detach().numpy() for k, t in res.items()}


def _jax_run(mesh, name):
    import jax
    import jax.numpy as jnp
    from adjointnonlinearraytracing_tpu.parallel import slabs as JS

    kind, kw, scene = CASES[name]
    x, v, po, pd = (jnp.asarray(a) for a in _rays(scene))
    if kind == "full":
        f = JS.make_slab_trace(mesh, H, DS, RES, **kw)
        call = lambda r: f(r, x, v)  # noqa: E731
    elif kind == "plane":
        f = JS.make_slab_trace_zsharded(mesh, H, DS, RES, variant="plane", **kw)
        call = lambda r: f(JS.pad_rif_z(r, WORLD), x, v, po, pd)  # noqa: E731
    else:
        f = JS.make_slab_trace_zsharded(mesh, H, DS, RES, **kw)
        call = lambda r: f(JS.pad_rif_z(r, WORLD), x, v)  # noqa: E731

    def loss(r):
        out = call(r)
        per = out[0] ** 2 + out[0] * out[1]
        if kind == "plane":
            per = (~out[2]).astype(r.dtype)[:, None] * per
        return jnp.sum(per), out

    g, out = jax.jit(jax.grad(loss, has_aux=True))(jnp.asarray(_rif()))
    res = {"xt": out[0], "vt": out[1], "g": g}
    if kind == "plane":
        res["miss"] = out[2]
    return {f"{name}_{k}": np.asarray(t) for k, t in res.items()}


def _close(got, want, key):
    if key.endswith("_miss"):
        np.testing.assert_array_equal(got, want, err_msg=key)
        return
    tol = 1e-9 * float(np.nanmax(np.abs(want))) if key.endswith("_g") else 1e-12
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, equal_nan=True, err_msg=key)


@pytest.fixture(scope="module")
def jax_refs(rank_procs):
    """The JAX rings on two of its devices, computed while the ranks run."""
    import jax
    from adjointnonlinearraytracing_tpu.parallel import mesh as JM

    mesh = JM.make_ray_mesh(jax.devices()[:WORLD])
    out = {}
    for name in CASES:
        out.update(_jax_run(mesh, name))
    return out


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(rank, world, port, out_path):
    """One rank of the two-rank run: every ring of :data:`CASES`, the refusals,
    and (rank 0) the results."""
    TP.initialize(f"localhost:{port}", world, rank, backend="gloo")
    try:
        mesh = TP.make_ray_mesh()
        out = {}
        for name in CASES:
            out.update(_port_run(mesh, name))
        # a ray count the ranks do not divide raises on every rank, before any collective
        x, v, _, _ = (torch.from_numpy(a) for a in _rays("cross"))
        f = TP.make_slab_trace(mesh, H, DS, RES)
        try:
            f(torch.from_numpy(_rif()), x[:15], v[:15])
            out["indivisible_raised"] = np.array(False)
        except ValueError as e:
            out["indivisible_raised"] = np.array("pad it first" in str(e))
        # ranks that run different rings (K differs) refuse together, and do not hang
        f = TP.make_slab_trace(mesh, H, DS, RES, inner_steps=2 + rank)
        try:
            f(torch.from_numpy(_rif()), x, v)
            out["disagree_raised"] = np.array(False)
        except RuntimeError as e:
            out["disagree_raised"] = np.array("disagree" in str(e))
        if rank == 0:
            np.savez(out_path, **out)
    finally:
        torch.distributed.destroy_process_group()
    print(f"RANK_OK {rank}", flush=True)


@pytest.fixture(scope="module")
def rank_procs(tmp_path_factory):
    """The two ranks, started (this file run as a script in two processes)."""
    port, out = _free_port(), tmp_path_factory.mktemp("slabs") / "ranks.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""),
               JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, __file__, str(rank), str(WORLD), str(port),
                               str(out)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=env, cwd=ROOT) for rank in range(WORLD)]
    try:
        yield procs, out
    finally:
        for p in procs:
            p.kill()


@pytest.fixture(scope="module")
def two_ranks(rank_procs, jax_refs):
    """What the two ranks computed (rank 0 wrote it)."""
    procs, out = rank_procs
    logs = [p.communicate(timeout=120)[0] for p in procs]
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"RANK_OK {rank}" in log, log
    return dict(np.load(out))


def test_slab_rows_pad_rif_z_and_tables_match_jax():
    import jax
    import jax.numpy as jnp
    from adjointnonlinearraytracing_tpu.fields.grid import GridField as JGridField
    from adjointnonlinearraytracing_tpu.parallel import slabs as JS

    for rows, ndev in ((10, 1), (10, 2), (10, 3), (10, 8), (1026, 4), (17, 16)):
        assert TS.slab_rows(rows, ndev) == JS.slab_rows(rows, ndev)
    rif = _rif()
    weights = np.random.default_rng(1).standard_normal((12, RES, RES))
    for ndev in (1, 2, 3, 4):
        r = torch.from_numpy(rif).requires_grad_(True)
        padded = TS.pad_rif_z(r, ndev)
        want = JS.pad_rif_z(jnp.asarray(rif), ndev)
        np.testing.assert_array_equal(padded.detach().numpy(), np.asarray(want))
        # the padded rows' gradient folds into the last plane, as JAX's autodiff folds it
        w = weights[:padded.shape[0]]
        (padded * torch.from_numpy(w)).sum().backward()
        gj = jax.grad(lambda q: jnp.sum(JS.pad_rif_z(q, ndev) * w))(jnp.asarray(rif))
        np.testing.assert_array_equal(r.grad.numpy(), np.asarray(gj))
        got, S = TS.build_slab_tables(TG.GridField(torch.from_numpy(rif), H), ndev)
        want, S_j = JS.build_slab_tables(JGridField(jnp.asarray(rif), H), ndev)
        assert S == S_j
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_one_rank_ring_equals_api_trace():
    """A mesh of one (no process group): every phase holds the whole grid;
    with ``inner_steps`` 3 a ray takes many phases.  Outputs bit for bit,
    gradient 1e-9 of its largest entry, both ring functions and the plane rule."""
    mesh = TP.make_ray_mesh()
    assert mesh.world_size == 1
    x, v, po, pd = (torch.from_numpy(a) for a in _rays("cross"))
    r = torch.from_numpy(_rif()).requires_grad_(True)
    xt, vt = api.trace(r, x, v, H, DS)
    _loss(xt, vt).backward()
    for inner in (None, 3):
        for zsharded in (True, False):
            q = torch.from_numpy(_rif()).requires_grad_(True)
            if zsharded:
                f = TP.make_slab_trace_zsharded(mesh, H, DS, RES, inner_steps=inner)
                got = f(TP.pad_rif_z(q, 1)[:RES + 1], x, v)
            else:
                f = TP.make_slab_trace(mesh, H, DS, RES, inner_steps=inner)
                got = f(q, x, v)
            _loss(*got).backward()
            assert torch.equal(got[0], xt) and torch.equal(got[1], vt)
            np.testing.assert_allclose(q.grad.numpy(), r.grad.numpy(), rtol=0,
                                       atol=1e-9 * float(r.grad.abs().max()))
            assert (f.ring.phases_run["fwd"] > 1) == (inner is not None)
    x, v, po, pd = (torch.from_numpy(a) for a in _rays("entry"))
    f = TP.make_slab_trace_zsharded(mesh, H, DS, RES, inner_steps=3, variant="plane")
    got = f(TP.pad_rif_z(torch.from_numpy(_rif()), 1)[:RES + 1], x, v, po, pd)
    want = api.trace_plane(torch.from_numpy(_rif()), x, v, po, pd, H, DS)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="rows of pad_rif_z"):
        f(torch.from_numpy(_rif()), x, v, po, pd)


@pytest.mark.parametrize("name", ["z", "z_inner1", "plane", "full", "down"])
def test_two_ranks_equal_jax_on_two_devices_and_api_trace(two_ranks, jax_refs, name):
    """Two gloo ranks against the JAX ring on two devices, key by key, and
    against the port's unsharded ``api.trace`` / ``trace_plane``."""
    keys = [f"{name}_{k}" for k in ("xt", "vt", "g", "miss") if f"{name}_{k}" in jax_refs]
    assert len(keys) == (4 if name == "plane" else 3)
    for key in keys:
        _close(two_ranks[key], jax_refs[key], key)
    kind, _, scene = CASES[name]
    x, v, po, pd = (torch.from_numpy(a) for a in _rays(scene))
    r = torch.from_numpy(_rif()).requires_grad_(True)
    if kind == "plane":
        out = api.trace_plane(r, x, v, po, pd, H, DS)
    else:
        out = api.trace(r, x, v, H, DS)
    _loss(*out).backward()
    assert np.isfinite(two_ranks[f"{name}_xt"]).all()
    for k, t in (("xt", out[0]), ("vt", out[1]), ("g", r.grad)):
        _close(two_ranks[f"{name}_{k}"], t.detach().numpy(), f"{name}_{k}")


def test_phase_exhaustion_poisons_like_jax(two_ranks, jax_refs):
    """``inner_steps=1`` finishes within its budget and equals the replicated
    trace (above); a budget cut below what the rays need (``phase_slack=-3``:
    2 phases) poisons the truncated rays' outputs and the whole gradient with
    NaN, the same lanes as JAX's, and leaves the finished rays exact."""
    xt, want = two_ranks["z_truncated_xt"], jax_refs["z_truncated_xt"]
    bad = np.isnan(xt).any(axis=1)
    assert bad.any() and not bad.all()
    np.testing.assert_array_equal(np.isnan(xt), np.isnan(want))
    np.testing.assert_array_equal(np.isnan(two_ranks["z_truncated_vt"]),
                                  np.isnan(jax_refs["z_truncated_vt"]))
    assert np.isnan(two_ranks["z_truncated_g"]).all() and np.isnan(jax_refs["z_truncated_g"]).all()
    _close(xt, want, "z_truncated_xt")


def test_two_ranks_refuse_indivisible_batches_and_unequal_rings(two_ranks):
    assert bool(two_ranks["indivisible_raised"])
    assert bool(two_ranks["disagree_raised"])


def test_plain_phases_freeze_the_rays_outside_the_slab():
    """K21's and K22's plain versions on one slab that does not cover the grid
    (a quarter of 9^3, cell rows [3, 6)): a ray outside it keeps its state bit
    for bit, a ray inside steps as ``tracer.eikonal`` steps it."""
    rif = torch.from_numpy(_rif())
    x, v, _, _ = (torch.from_numpy(a) for a in _rays("cross"))
    ndev, S = 4, TS.slab_rows(RES + 1, 4)
    z_first = S - 1
    slab = TS.pad_rif_z(rif, ndev)[z_first:z_first + S + 1].contiguous()
    # start the rays inside the grid, a third of them in the slab's rows
    x = x.clone()
    x[:, 2] = torch.linspace(0.2, SPAN - 0.2, x.shape[0], dtype=x.dtype)
    shape = TS._grid_shape(slab, (RES,) * 3, H)
    held = TS._in_window((RES,) * 3, z_first, S + 1, H, x)
    assert held.any() and not held.all()
    st = [x.clone(), v.clone(), x.clone(), v.clone(), TG.inbounds(shape, x),
          torch.zeros(x.shape[0], dtype=torch.bool), torch.zeros(x.shape[0], dtype=torch.int32)]
    before = [t.clone() for t in st]
    pending = TS.slab_trace_phase_plain(slab, (RES,) * 3, z_first, H, DS, *st, 200, 1)
    assert bool(pending)
    for a, b in zip(st, before):
        assert torch.equal(a[~held], b[~held])
    from adjointnonlinearraytracing_tpu_torch.tracer import eikonal as TE
    x1, v1 = TE.forward_step(TG.GridField(rif, H), x[held], v[held], before[4][held],
                             TG._scalar(DS, x))
    assert torch.equal(st[0][held], x1) and torch.equal(st[1][held], v1)
    assert torch.equal(st[6], held.to(torch.int32))
    # the adjoint phase: one step of the rays whose snapped position is held
    la, mu = torch.ones_like(x), torch.ones_like(x)
    bst = [x.clone(), -v, la, mu, torch.ones(x.shape[0], dtype=torch.bool),
           torch.zeros(x.shape[0], dtype=torch.int32)]
    b0 = [t.clone() for t in bst]
    gslab = torch.zeros_like(slab)
    TS.slab_backtrace_phase_plain(slab, (RES,) * 3, z_first, H, DS, TG.snap_tol(slab.dtype),
                                  *bst, gslab, 200, 1)
    xe = TG.snap_to_nodes(x - DS * (-v), H)
    moved = TS._in_window((RES,) * 3, z_first, S + 1, H, xe)
    assert moved.any() and not moved.all()
    for a, b in zip(bst, b0):
        assert torch.equal(a[~moved], b[~moved])
    assert torch.equal(bst[5], moved.to(torch.int32))
    assert gslab.abs().sum() > 0


def test_plain_phases_count_the_sectors_they_reach():
    """The plain phases' ``stats`` mark the 32-byte sectors a kernel must move:
    the forward's those of the corners its stepping rays read, the adjoint's
    splats exactly the sectors of the gradient slab it made nonzero, within
    the sectors it read."""
    rif = torch.from_numpy(_rif())
    x, v, _, _ = (torch.from_numpy(a) for a in _rays("cross"))
    ndev, S = 4, TS.slab_rows(RES + 1, 4)
    z_first = S - 1
    slab = TS.pad_rif_z(rif, ndev)[z_first:z_first + S + 1].contiguous()
    x = x.clone()
    x[:, 2] = torch.linspace(0.2, SPAN - 0.2, x.shape[0], dtype=x.dtype)
    shape = TS._grid_shape(slab, (RES,) * 3, H)
    per = 32 // slab.element_size()
    n_sectors = -(-slab.numel() // per)
    inside = TG.inbounds(shape, x)
    held = TS._in_window((RES,) * 3, z_first, S + 1, H, x) & inside
    st = [x.clone(), v.clone(), x.clone(), v.clone(), inside.clone(),
          torch.zeros(x.shape[0], dtype=torch.bool), torch.zeros(x.shape[0], dtype=torch.int32)]
    fstats = {}
    TS.slab_trace_phase_plain(slab, (RES,) * 3, z_first, H, DS, *st, 200, 1, stats=fstats)
    idx = TG._stencil(shape, x[held])[0] - z_first * slab.shape[1] * slab.shape[2]
    want = torch.zeros(n_sectors, dtype=torch.bool)
    want[idx.reshape(-1) // per] = True
    assert fstats["sectors"].shape == (n_sectors,) and torch.equal(fstats["sectors"], want)
    bst = [x.clone(), -v, torch.ones_like(x), torch.ones_like(x),
           torch.ones(x.shape[0], dtype=torch.bool), torch.zeros(x.shape[0], dtype=torch.int32)]
    gslab, bstats = torch.zeros_like(slab), {}
    TS.slab_backtrace_phase_plain(slab, (RES,) * 3, z_first, H, DS, TG.snap_tol(slab.dtype),
                                  *bst, gslab, 200, 20, stats=bstats)
    g = torch.nn.functional.pad(gslab.reshape(-1), (0, n_sectors * per - gslab.numel()))
    written = (g.reshape(n_sectors, per) != 0).any(dim=1)
    assert written.any() and torch.equal(bstats["grad_sectors"], written)
    assert not (bstats["grad_sectors"] & ~bstats["sectors"]).any()
    assert bstats["splats"] > 0 and bstats["evals"] >= bstats["splats"]


def test_parallel_exports_every_name_of_the_jax_parallel():
    """Every public name of the JAX package's ``parallel`` and the public
    functions of its ``slabs.py`` import from the port's ``parallel``."""
    import inspect
    import types

    from adjointnonlinearraytracing_tpu import parallel as JP
    from adjointnonlinearraytracing_tpu.parallel import slabs as JS

    names = {n for n, o in vars(JP).items()
             if not n.startswith("_") and not isinstance(o, types.ModuleType)}
    names |= {n for n, o in vars(JS).items() if not n.startswith("_") and inspect.isfunction(o)
              and o.__module__ == JS.__name__}
    assert {"make_sharded_trace_sdf", "make_slab_trace_zsharded", "pad_rif_z"} <= names
    missing = sorted(n for n in names if not hasattr(TP, n))
    assert not missing, missing


def test_slab_kernels_refuse_cpu_tensors():
    slab = torch.zeros((3, RES, RES), dtype=torch.float64)
    x = torch.zeros((4, 3), dtype=torch.float64)
    b = torch.zeros(4, dtype=torch.bool)
    c = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        TK.slab_trace_phase(slab, (RES,) * 3, -1, H, DS, x, x, x, x, b, b, c, 10, 2)
    with pytest.raises(ValueError, match="CUDA"):
        TK.slab_backtrace_phase(slab, (RES,) * 3, -1, H, DS, 1e-9, x, x, x, x, b, c,
                                torch.zeros_like(slab), 10, 2)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
