"""The sharded variants of the ray mesh (``parallel/mesh.py``:
``make_sharded_trace_{plane,target,sdf,cable}``, plain and exact) against the
JAX package's functions of those names.

CPU, f64 (conftest enables x64).  The scenes are made with numpy and handed
to both packages.  One port rank (this process, no process group) is held to
the JAX functions on a mesh of one virtual device, two gloo ranks (this file
run as a script in two processes) to the JAX functions on two devices.  Two
shards are where the horizons show: the plain target and sdf step each
shard's rays to **its own** last escape, so with a slow ray in the second
shard and targets beyond the far face, the first shard's closest approaches
differ from the unsharded trace's (they equal the unsharded trace of that
shard), while the exact target takes the global horizon (an ``all_reduce``
with ``MAX``) and equals the unsharded call.  Tolerances: outputs ``1e-12``,
gradients ``1e-9`` of their largest magnitude.  The JAX references are one
jitted function a mesh, computed while the ranks run.
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
from adjointnonlinearraytracing_tpu_torch import tracer as TT

ROOT = Path(__file__).resolve().parent.parent
RES, SPAN = 9, 1.0
H = SPAN / (RES - 1)
DS = H / 2
SEG = 8
NBINS, RADIUS, LENGTH, DS_C = 9, 1.0, 2.0, 0.05
WORLD = 2
NAMES = [f"{b}_{m}" for b in ("plane", "target", "sdf", "cable") for m in ("plain", "exact")]


def _rif():
    z, y, x = np.meshgrid(*[np.arange(RES) * H] * 3, indexing="ij")
    bump = np.exp(-((x - 0.5) ** 2 + (y - 0.45) ** 2 + (z - 0.55) ** 2) / 0.08)
    return 1.0 + 0.1 * bump + 0.01 * np.random.default_rng(0).uniform(size=(RES,) * 3)


def _volume_rays():
    """32 rays entering through y = 0; their targets 0.6 beyond the far face
    on their way, planes near y = 0.6; the last ray (the second shard's at
    two ranks) is slow and escapes long after the others."""
    rng = np.random.default_rng(3)
    n = 32
    x = np.stack([rng.uniform(0.3, 0.7, n), np.full(n, 0.02), rng.uniform(0.3, 0.7, n)], -1)
    v = np.stack([0.1 * rng.standard_normal(n), np.ones(n), 0.1 * rng.standard_normal(n)], -1)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    tgt = x + 1.6 * v
    x[-1], v[-1] = [0.5, 0.1, 0.5], [0.0, 0.3, 0.0]
    po = np.tile([0.0, 0.6 * SPAN, 0.0], (n, 1)) + 0.02 * rng.standard_normal((n, 3))
    pd = np.tile([0.0, 1.0, 0.0], (n, 1)) + 0.1 * rng.standard_normal((n, 3))
    return x, v, tgt, po, pd


def _sdf_scene():
    """A half-space sdf (x < 0.5 inside) reaching the y = 0 face; 20 rays
    leave the grid through it while still inside and cross x = 0.5 later; the
    last (second shard's) is slow and holds the loop open."""
    z, y, x = np.meshgrid(*[np.arange(RES) * H] * 3, indexing="ij")
    sdf = (x - 0.5 * SPAN) / H
    rng = np.random.default_rng(4)
    n = 20
    x0 = np.stack([rng.uniform(0.2, 0.35, n), rng.uniform(0.15, 0.3, n),
                   rng.uniform(0.3, 0.7, n)], -1)
    v0 = np.stack([np.full(n, 0.3), -np.ones(n), 0.05 * rng.standard_normal(n)], -1)
    v0 /= np.linalg.norm(v0, axis=-1, keepdims=True)
    x0[-1], v0[-1] = [0.3, 0.5, 0.5], [0.0, 0.1, 0.0]
    return sdf, x0, v0


def _cable_scene():
    """A radial profile of 9 bins and 16 rays entering the y = 0 cap toward
    targets near 0.8 of the length."""
    rng = np.random.default_rng(5)
    prof = np.sqrt(2.0 - np.linspace(0.0, 1.0, NBINS) ** 2) + 0.02 * rng.uniform(size=NBINS)
    n = 16
    ang, rad = rng.uniform(0, 2 * np.pi, n), 0.9 * np.sqrt(rng.uniform(size=n))
    x = np.stack([RADIUS + rad * np.cos(ang), np.full(n, -0.02), RADIUS + rad * np.sin(ang)], -1)
    v = np.stack([0.1 * rng.standard_normal(n), np.ones(n), 0.1 * rng.standard_normal(n)], -1)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    tgt = np.stack([np.full(n, RADIUS), np.full(n, 0.8 * LENGTH), np.full(n, RADIUS)], -1)
    return prof, x, v, tgt + 0.05 * rng.standard_normal((n, 3))


def _calls(pkg, mesh, name, t):
    """``(field, f)`` of the sharded variant ``name`` of ``pkg``'s ``parallel.mesh`` on
    ``mesh``: ``f(field) -> outputs``, the inputs made by ``t`` from numpy."""
    kind, mode = name.split("_")
    exact = mode == "exact"
    if kind == "cable":
        prof, x, v, tgt = _cable_scene()
        f = pkg.make_sharded_trace_cable(mesh, RADIUS, LENGTH, DS_C, exact=exact, seg=SEG)
        return prof, lambda r: f(r, t(x), t(v), t(tgt))
    x, v, tgt, po, pd = _volume_rays()
    make = getattr(pkg, f"make_sharded_trace_{kind}")
    f = make(mesh, H, DS, RES, exact=exact, seg=SEG)
    if kind == "plane":
        return _rif(), lambda r: f(r, t(x), t(v), t(po), t(pd))
    if kind == "target":
        return _rif(), lambda r: f(r, t(x), t(v), t(tgt))
    sdf, xs, vs = _sdf_scene()
    return _rif(), lambda r: f(r, t(sdf), t(xs), t(vs))


def _port_run(mesh):
    """Every sharded variant on ``mesh``: its outputs and the gradient of
    ``sum(xt^2 + xt * vt)``, as numpy."""
    out = {}
    for name in NAMES:
        field, call = _calls(TP, mesh, name, torch.from_numpy)
        r = torch.from_numpy(field).requires_grad_(True)
        res = call(r)
        (res[0] ** 2 + res[0] * res[1]).sum().backward()
        for k, a in enumerate(res):
            out[f"{name}_{k}"] = a.detach().numpy()
        out[f"{name}_g"] = r.grad.numpy()
    return out


def _jax_run(ndev):
    """Every JAX sharded variant on ``ndev`` of its devices, in one jitted function."""
    import jax
    import jax.numpy as jnp
    from adjointnonlinearraytracing_tpu.parallel import mesh as JM

    mesh = JM.make_ray_mesh(jax.devices()[:ndev])
    calls = {name: _calls(JM, mesh, name, jnp.asarray) for name in NAMES}

    def run(rif, prof):
        res = {}
        for name, (field, call) in calls.items():
            def loss(r, call=call):
                out = call(r)
                return jnp.sum(out[0] ** 2 + out[0] * out[1]), out

            g, outs = jax.grad(loss, has_aux=True)(prof if name.startswith("cable") else rif)
            res.update({f"{name}_{k}": a for k, a in enumerate(outs)})
            res[f"{name}_g"] = g
        return res

    out = jax.jit(run)(jnp.asarray(_rif()), jnp.asarray(_cable_scene()[0]))
    return {k: np.asarray(a) for k, a in out.items()}


def _close(got, want, key):
    if got.dtype == bool:
        np.testing.assert_array_equal(got, want, err_msg=key)
        return
    tol = 1e-9 * float(np.abs(want).max()) if key.endswith("_g") else 1e-12
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=key)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _per_shard_checks(mesh, out):
    """Each rank's rows of the plain target and sdf against the unsharded call
    on its own shard (bitwise), all ranks' verdicts gathered."""
    x, v, tgt, _, _ = (torch.from_numpy(a) for a in _volume_rays())
    sdf, xs, vs = (torch.from_numpy(a) for a in _sdf_scene())
    rif = torch.from_numpy(_rif())
    ok = []
    for name, n, own in (("target_plain", x.shape[0],
                          lambda sl: TT.trace_target(rif, x[sl], v[sl], tgt[sl], H, DS)),
                         ("sdf_plain", xs.shape[0],
                          lambda sl: TT.trace_sdf(rif, sdf, xs[sl], vs[sl], H, DS))):
        sl = mesh.shard(n)
        want = own(sl)
        ok.append(all(torch.equal(torch.from_numpy(out[f"{name}_{k}"])[sl], w)
                      for k, w in enumerate(want)))
    verdicts = mesh.all_gather(torch.tensor([ok], dtype=torch.int32))
    out["per_shard_equal"] = verdicts.numpy()


def _worker(rank, world, port, out_path):
    TP.initialize(f"localhost:{port}", world, rank, backend="gloo")
    try:
        mesh = TP.make_ray_mesh()
        out = _port_run(mesh)
        _per_shard_checks(mesh, out)
        x, v, tgt, _, _ = (torch.from_numpy(a) for a in _volume_rays())
        try:  # a ray count the ranks do not divide raises, before any collective
            TP.make_sharded_trace_target(mesh, H, DS, RES, exact=True)(
                torch.from_numpy(_rif()), x[:31], v[:31], tgt[:31])
            out["indivisible_raised"] = np.array(False)
        except ValueError as e:
            out["indivisible_raised"] = np.array("pad it first" in str(e))
        if rank == 0:
            np.savez(out_path, **out)
    finally:
        torch.distributed.destroy_process_group()
    print(f"RANK_OK {rank}", flush=True)


@pytest.fixture(scope="module")
def rank_procs(tmp_path_factory):
    port, out = _free_port(), tmp_path_factory.mktemp("variants") / "ranks.npz"
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
def jax_refs(rank_procs):
    """The JAX sharded variants on one device and on two, computed while the ranks
    run (the JAX API's cell-table stepper, ``ANRT_FAST_PATH=classic``, which
    compiles faster here)."""
    from concurrent.futures import ThreadPoolExecutor

    mp = pytest.MonkeyPatch()
    mp.setenv("ANRT_FAST_PATH", "classic")
    try:  # the two compile side by side (XLA lets go of the interpreter meanwhile)
        with ThreadPoolExecutor(2) as pool:
            return dict(zip((1, 2), pool.map(_jax_run, (1, 2))))
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def two_ranks(rank_procs, jax_refs):
    procs, out = rank_procs
    logs = [p.communicate(timeout=120)[0] for p in procs]
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"RANK_OK {rank}" in log, log
    return dict(np.load(out))


@pytest.fixture(scope="module")
def one_rank():
    mesh = TP.make_ray_mesh()
    assert mesh.world_size == 1
    return _port_run(mesh)


def _keys(refs, name):
    keys = [k for k in refs if k.rsplit("_", 1)[0] == name]
    assert len(keys) == (3 if name.startswith("sdf") else 4)
    return keys


@pytest.mark.parametrize("name", NAMES)
def test_one_rank_equals_jax_on_one_device(one_rank, jax_refs, name):
    for key in _keys(jax_refs[1], name):
        _close(one_rank[key], jax_refs[1][key], key)


@pytest.mark.parametrize("name", NAMES)
def test_two_ranks_equal_jax_on_two_devices(two_ranks, jax_refs, name):
    for key in _keys(jax_refs[2], name):
        _close(two_ranks[key], jax_refs[2][key], key)


def test_per_shard_horizons_of_the_plain_target_and_sdf(two_ranks, one_rank):
    """On two ranks the plain target's and sdf's rows are the unsharded trace
    of each rank's own shard, and the plain target's first shard differs from
    the whole batch's trace; the exact target (global horizon) does not."""
    assert two_ranks["per_shard_equal"].all()
    d2_two, d2_one = two_ranks["target_plain_2"], one_rank["target_plain_2"]
    differs = d2_two != d2_one
    assert differs[:16].sum() >= 8 and not differs[16:].any()
    assert (d2_two[:16] >= d2_one[:16]).all()  # stopped earlier: no closer
    assert not np.array_equal(two_ranks["sdf_plain_0"], one_rank["sdf_plain_0"])
    for k in range(3):
        np.testing.assert_array_equal(two_ranks[f"target_exact_{k}"], one_rank[f"target_exact_{k}"])
    # one rank is the unsharded call
    x, v, tgt, _, _ = (torch.from_numpy(a) for a in _volume_rays())
    for k, t in enumerate(TT.trace_target(torch.from_numpy(_rif()), x, v, tgt, H, DS)):
        np.testing.assert_array_equal(one_rank[f"target_plain_{k}"], t.numpy())
    for k, t in enumerate(TT.trace_target_exact(torch.from_numpy(_rif()), x, v, tgt, H, DS,
                                                SEG)):
        np.testing.assert_array_equal(one_rank[f"target_exact_{k}"], t.numpy())


def test_cable_and_plane_equal_the_unsharded_calls(two_ranks, one_rank):
    """A cable ray freezes and a plane ray stops at its own escape: two ranks
    give the unsharded calls' outputs bit for bit, and gradients to 1e-9."""
    prof, x, v, tgt = (torch.from_numpy(a) for a in _cable_scene())
    xv, vv, _, po, pd = (torch.from_numpy(a) for a in _volume_rays())
    rif = torch.from_numpy(_rif())
    for name, call, field in (
            ("cable_plain", lambda r: TT.trace_cable(r, RADIUS, LENGTH, x, v, tgt, DS_C), prof),
            ("cable_exact", lambda r: TT.trace_cable_exact(r, RADIUS, LENGTH, x, v, tgt, DS_C,
                                                           SEG), prof),
            ("plane_plain", lambda r: TT.trace_plane(r, xv, vv, po, pd, H, DS), rif),
            ("plane_exact", lambda r: TT.trace_plane_exact(r, xv, vv, po, pd, H, DS, SEG), rif)):
        r = field.clone().requires_grad_(True)
        out = call(r)
        (out[0] ** 2 + out[0] * out[1]).sum().backward()
        for k, t in enumerate(out):
            np.testing.assert_array_equal(two_ranks[f"{name}_{k}"], t.detach().numpy())
        _close(two_ranks[f"{name}_g"], r.grad.numpy(), f"{name}_g")


def test_sharded_variants_refuse_bad_inputs(two_ranks):
    assert bool(two_ranks["indivisible_raised"])
    mesh = TP.make_ray_mesh()
    with pytest.raises(ValueError, match="seg"):
        TP.make_sharded_trace_sdf(mesh, H, DS, RES, exact=True, seg=0)
    sdf, xs, vs = (torch.from_numpy(a) for a in _sdf_scene())
    with pytest.raises(ValueError, match="sdf grid"):
        TP.make_sharded_trace_sdf(mesh, H, DS, RES)(torch.from_numpy(_rif()), sdf[:-1], xs, vs)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
