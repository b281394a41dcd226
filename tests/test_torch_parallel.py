"""The ray mesh (``parallel/``) of the port against the JAX package's, and two
ranks against one.

CPU, f64 (conftest enables x64).  In this process the port's mesh has one
rank (no process group) and the JAX package's eight virtual devices; the
scene (a bump, rays entering from below) is made with numpy and handed to
both.  Tolerances: outputs ``1e-12``, gradients ``1e-9`` of their largest
magnitude (the sharded sums run in another order).  Two ranks: this file run
as a script in two processes joined by gloo over ``localhost``, on a ray
count the ranks do not divide; their outputs and all-reduced gradients
equal one rank's within ``1e-12``.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from adjointnonlinearraytracing_tpu_torch.experiments import common as TC
from adjointnonlinearraytracing_tpu_torch.parallel import distributed as TD
from adjointnonlinearraytracing_tpu_torch.parallel import mesh as TM

ROOT = Path(__file__).resolve().parent.parent
RES, H, DS = 9, 1.0, 0.5
SPAN = (RES - 1) * H


def _scene(n, seed):
    """A smooth bump in a 9^3 grid and ``n`` rays entering through y = 0, tilted."""
    idx = np.arange(RES) * H
    z, y, x = np.meshgrid(idx, idx, idx, indexing="ij")
    c = SPAN / 2
    rif = 1.0 + 0.2 * np.exp(-((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2) / (2 * (SPAN / 4) ** 2))
    rng = np.random.default_rng(seed)
    xz = rng.uniform(0.25 * SPAN, 0.75 * SPAN, (n, 2))
    x0 = np.stack([xz[:, 0], np.full(n, -0.5), xz[:, 1]], axis=1)
    tilt = 0.1 * rng.standard_normal((n, 2))
    v0 = np.stack([tilt[:, 0], np.ones(n), tilt[:, 1]], axis=1)
    return rif, x0, v0 / np.linalg.norm(v0, axis=1, keepdims=True)


def _torch_run(trace, rif, x, v):
    """Outputs and the gradient of ``sum(xt^2 + xt * vt)`` through ``trace``, as numpy."""
    n = torch.from_numpy(rif).requires_grad_(True)
    xt, vt = trace(n, torch.from_numpy(x), torch.from_numpy(v))
    ((xt ** 2).sum() + (xt * vt).sum()).backward()
    return xt.detach().numpy(), vt.detach().numpy(), n.grad.numpy()


def _jax_run(trace, rif, x, v):
    import jax
    import jax.numpy as jnp

    def loss(r):
        xt, vt = trace(r, jnp.asarray(x), jnp.asarray(v))
        return jnp.sum(xt ** 2) + jnp.sum(xt * vt), (xt, vt)

    g, (xt, vt) = jax.jit(jax.grad(loss, has_aux=True))(jnp.asarray(rif))
    return np.asarray(xt), np.asarray(vt), np.asarray(g)


def _same(got, want, tol_out=1e-12, tol_grad=1e-9):
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a, b, rtol=0, atol=tol_out)
    scale = float(np.abs(want[2]).max())
    assert scale > 0
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=tol_grad * scale)


def test_pad_rays_and_local_ray_slice_match_jax():
    import jax.numpy as jnp
    from adjointnonlinearraytracing_tpu.parallel import distributed as JD
    from adjointnonlinearraytracing_tpu.parallel import mesh as JM

    x = np.arange(39.0).reshape(13, 3)
    for n_shards in (1, 4, 8, 13, 16):
        got, mask = TM.pad_rays(torch.from_numpy(x), n_shards)
        want, wmask = JM.pad_rays(jnp.asarray(x), n_shards)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(wmask))
        # one process: the whole padded batch, n_global of it real
        assert TD.local_ray_slice(13, n_shards) == JD.local_ray_slice(13, n_shards)
    got, mask = TM.pad_rays(torch.from_numpy(x.T.copy()), 8, axis=1)
    assert got.shape == (3, 16) and int(mask.sum()) == 13
    assert TD.process_info() == dict(process_index=0, process_count=1, local_devices=1,
                                     global_devices=1)
    mesh = TM.make_ray_mesh()
    assert (mesh.world_size, mesh.rank) == (1, 0)
    assert TM.shard_rays(mesh, torch.from_numpy(x)).shape == (13, 3)
    assert TM.replicate(mesh, torch.from_numpy(x)).shape == (13, 3)
    (whole,) = TD.global_ray_array(mesh, [x])
    np.testing.assert_array_equal(whole.numpy(), x)
    TD.initialize(num_processes=1)  # one process: nothing to join
    assert not torch.distributed.is_initialized()
    assert TD.rank0_value(2.5, "cpu") == 2.5


def test_sharded_traces_match_jax_on_its_eight_devices(monkeypatch):
    """``make_sharded_trace`` and ``make_sharded_trace_exact`` (``seg`` 8,
    ``ANRT_EXACT_CHUNK`` 3 on both sides, so the backward passes recompute
    their checkpoints chunk by chunk) against the JAX builders."""
    from adjointnonlinearraytracing_tpu.parallel import mesh as JM

    monkeypatch.setenv("ANRT_FAST_PATH", "classic")
    monkeypatch.setenv("ANRT_EXACT_CHUNK", "3")
    rif, x, v = _scene(32, 1)
    jmesh, tmesh = JM.make_ray_mesh(), TM.make_ray_mesh()
    _same(_torch_run(TM.make_sharded_trace(tmesh, H, DS, RES), rif, x, v),
          _jax_run(JM.make_sharded_trace(jmesh, H, DS, RES), rif, x, v))
    exact = _torch_run(TM.make_sharded_trace_exact(tmesh, H, DS, RES, seg=8), rif, x, v)
    _same(exact, _jax_run(JM.make_sharded_trace_exact(jmesh, H, DS, RES, seg=8), rif, x, v))
    # the exact gradient does not depend on the chunks
    monkeypatch.setenv("ANRT_EXACT_CHUNK", "0")
    _same(_torch_run(TM.make_sharded_trace_exact(tmesh, H, DS, RES, seg=8), rif, x, v), exact,
          0.0, 1e-12)


def test_make_trace_on_the_mesh_handles_indivisible_counts(monkeypatch):
    """13 rays: JAX pads them to its 8 devices with copies of ray 0; the port's
    one rank takes them whole, two ranks pad to 14 (``test_two_ranks...``)."""
    from adjointnonlinearraytracing_tpu.experiments import common as JC

    monkeypatch.setenv("ANRT_FAST_PATH", "classic")
    rif, x, v = _scene(13, 4)
    trace = TC.make_trace(SPAN, DS, use_mesh=True, device="cpu")
    assert trace.mesh.world_size == 1
    got = _torch_run(trace, rif, x, v)
    assert got[0].shape == (13, 3)
    _same(got, _jax_run(JC.make_trace(SPAN, DS, use_mesh=True), rif, x, v))
    _same(got, _torch_run(TC.make_trace(SPAN, DS, device="cpu"), rif, x, v), 0.0, 1e-12)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_results(world):
    """Both gradient modes of ``make_trace(use_mesh=True)`` on this process's
    mesh over the 13 rays of the two-rank test."""
    rif, x, v = _scene(13, 5)
    out = {}
    for mode in ("adjoint", "exact"):
        trace = TC.make_trace(SPAN, DS, use_mesh=True, gradient=mode, seg=8, device="cpu")
        assert trace.mesh.world_size == world
        for name, val in zip(("xt", "vt", "g"), _torch_run(trace, rif, x, v)):
            out[f"{mode}_{name}"] = val
    return out


def _worker(rank, world, port, out_path):
    """One rank of the two-rank test: join the group, check the per-process ray
    slice, trace, and (rank 0) write the results."""
    TD.initialize(f"localhost:{port}", world, rank, backend="gloo")
    try:
        mesh = TM.make_ray_mesh()
        assert (mesh.world_size, mesh.rank) == (world, rank)
        assert TD.process_info()["process_index"] == rank
        # each process draws only its part of the padded batch; assembled, it is
        # the whole padded batch on every process
        _, x, _ = _scene(13, 5)
        start, stop, n_valid = TD.local_ray_slice(13)
        assert (stop - start, n_valid) == (7, 7 - rank)
        xp, mask = TM.pad_rays(torch.from_numpy(x), world)
        (whole,) = TD.global_ray_array(mesh, [xp[start:stop]])
        assert torch.equal(whole, xp) and int(mask.sum()) == 13
        assert torch.equal(TM.shard_rays(mesh, xp), xp[start:stop])
        rep = TM.replicate(mesh, torch.full((2,), float(rank)))
        assert torch.equal(rep, torch.zeros(2))
        assert TD.rank0_value(0.5 + rank, "cpu") == 0.5  # the ranks decide alike
        out = _rank_results(world)
        if rank == 0:
            np.savez(out_path, **out)
    finally:
        torch.distributed.destroy_process_group()
    print(f"RANK_OK {rank}", flush=True)


def test_two_ranks_equal_one(tmp_path, monkeypatch):
    monkeypatch.setenv("ANRT_EXACT_CHUNK", "3")  # 7 rays a rank: three chunks each
    port, out = _free_port(), tmp_path / "ranks.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""),
               JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, __file__, str(rank), "2", str(port), str(out)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env, cwd=ROOT) for rank in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"RANK_OK {rank}" in log, log
    two = np.load(out)
    one = _rank_results(1)
    assert set(two.files) == set(one)
    for key, want in one.items():
        tol = 1e-12 * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(two[key], want, rtol=0, atol=tol, err_msg=key)
    assert float(np.abs(one["exact_g"]).max()) > 0


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
