"""The port's 2008 path-matrix baseline (``pathmatrix/``, ``native/``) against
the JAX package's.

CPU, f64.  The host-side operators are the same numpy/scipy code on both
sides; the ground-truth trace is the port's plain stepper against the JAX
tracer, fed the same rays (drawn with the JAX package's own key).
Tolerances: the path matrix and operators ``1e-12`` relative; the native
marcher against the numpy marcher ``1e-9`` absolute, as the JAX package holds
its own two (the cubic's powers round differently); the recorded
trajectories ``1e-12`` in f64 and one float32 ulp after the cast (a position
a rounding away from a float32 tie may round the other way); the
reconstruction ``1e-8`` relative to its largest magnitude (LSQR on inputs that
differ by rounding), for each path model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adjointnonlinearraytracing_tpu.experiments import voxel_scenes as JV
from adjointnonlinearraytracing_tpu.pathmatrix import fuel2008 as JF
from adjointnonlinearraytracing_tpu.pathmatrix import path_matrix as JPM
from adjointnonlinearraytracing_tpu.sources import sources as JS
from adjointnonlinearraytracing_tpu_torch.kernels import build
from adjointnonlinearraytracing_tpu_torch.kernels import wrappers as kernels
from adjointnonlinearraytracing_tpu_torch.native import loader
from adjointnonlinearraytracing_tpu_torch.pathmatrix import fuel2008 as TF
from adjointnonlinearraytracing_tpu_torch.pathmatrix import path_matrix as TPM

TINY = dict(nviews=4, nbins=8, spp=2, int_res=64, recon_res=8, seed=0)


def _segments(n, seed):
    rng = np.random.default_rng(seed)
    sp = rng.uniform(0.05, 0.95, (n, 3))
    ep = rng.uniform(0.05, 0.95, (n, 3))
    return sp, rng.normal(0, 0.2, (n, 3)), ep, rng.normal(0, 0.2, (n, 3))


def _true_paths(n=16, steps=12):
    rng = np.random.default_rng(2)
    a, b = rng.uniform(0.1, 0.4, (n, 3)), rng.uniform(0.6, 0.9, (n, 3))
    bend = rng.normal(0, 0.05, (n, 3))
    t = np.linspace(0, 1, steps)[:, None, None]
    traj = (1 - t) * a + t * b + np.sin(np.pi * t) * bend
    return traj, (traj.reshape(steps * n, 3), np.zeros(n), np.full(n, float(steps - 1)))


@pytest.mark.parametrize("spline", ["linear", "hermite", "true"])
def test_native_marcher_matches_the_numpy_marcher(spline):
    if spline == "true":
        traj, path = _true_paths()
        sp, ep = traj[0], traj[-1]
        sd = ed = ep - sp
    else:
        sp, sd, ep, ed = _segments(48, 1)
        path = None
    kw = dict(spline=spline, int_res=60, path=path)
    native = TPM.construct_voxel_matrix(sp, sd, ep, ed, 1.0, 8, **kw)
    plain = TPM.construct_voxel_matrix(sp, sd, ep, ed, 1.0, 8, native=False, **kw)
    assert native.nnz > 0 and abs(native - plain).max() < 1e-9
    # and the JAX package's (native) marcher gives the same matrix
    want = JPM.construct_voxel_matrix(sp, sd, ep, ed, 1.0, 8, **kw)
    assert abs(native - want).max() <= 1e-12 * abs(want).max()


def test_native_library_builds_into_the_build_dir():
    lib = loader.get_lib()
    assert lib is loader.get_lib()
    out = loader.lib_path()
    assert out.parent == build.BUILD_DIR and out.exists()
    assert not list(loader.SRC.parent.glob("*.so"))


def test_a_failed_native_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "pathmatrix.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(loader, "SRC", bad)
    monkeypatch.setattr(loader, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(loader, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        TPM.construct_voxel_matrix(*_segments(4, 3), 1.0, 4, int_res=8)
    assert not list((tmp_path / "_build").glob("*.so"))


def test_operators_match_jax():
    for a, b in zip(TPM.construct_diff_matrices(5, 1.0, 3), JPM.construct_diff_matrices(5, 1.0, 3)):
        assert abs(a - b).max() == 0
    (ca, sa), (cb, sb) = (m.construct_boundary_conditions(5, 3, 1.0003) for m in (TPM, JPM))
    assert abs(ca - cb).max() == 0 and np.array_equal(sa, sb)
    sp, sd, ep, ed = _segments(40, 4)
    phi = TPM.construct_voxel_matrix(sp, sd, ep, ed, 1.0, 4, int_res=32)
    defl = np.random.default_rng(5).standard_normal((40, 3))
    for (ga,), (gb,) in zip(([g[0]] for g in TPM.deflection_solve_gradient(phi, defl)),
                            ([g[0]] for g in JPM.deflection_solve_gradient(phi, defl))):
        np.testing.assert_array_equal(ga, gb)
    x, v = sp - 0.2, ep - sp
    for a, b in zip((TF.intersect_cube(x, v, 0.0, 1.0), TF.trace_to_cube(x, v, 1.0),
                     TF.trace_back_to_cube(ep + 0.1 * v, v, 1.0)),
                    (JF.intersect_cube(x, v, 0.0, 1.0), JF.trace_to_cube(x, v, 1.0),
                     JF.trace_back_to_cube(ep + 0.1 * v, v, 1.0))):
        for p, q in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            np.testing.assert_array_equal(p, q)


@pytest.fixture(scope="module")
def tiny_rays():
    """The tiny configuration's ground truth and rays, drawn with the JAX key."""
    gt = JV.gaussian_bump(17, 1.0, amp=0.0005).astype(jnp.float64)
    rays, _ = JS.rand_rays_in_sphere(jax.random.PRNGKey(TINY["seed"]), TINY["nviews"],
                                     (TINY["nbins"],) * 2, TINY["spp"], 1.0, circle=False,
                                     angle_span=360, sensor_dist=1.0)
    return gt, rays


@pytest.mark.parametrize("stride", [8, 3])
def test_record_paths_matches_jax(tiny_rays, stride, monkeypatch):
    """The recorded trajectories (K20's plain version) against JAX
    ``record_paths`` on the tiny configuration's 512 rays at 17^3, with two
    rays that start outside and never enter (they go on straight): the f64
    positions before the cast within 1e-12, the float32 buffer within one
    float32 ulp, the same record count (stride 3 does not divide the 136
    steps' bound)."""
    gt, rays = tiny_rays
    x = np.concatenate([np.array(rays.x), [[-0.5, -0.5, -0.5], [1.5, 0.5, 0.5]]])
    v = np.concatenate([np.array(rays.v), [[-1.0, 0.0, 0.0], [1.0, 0.0, 0.0]]])
    h = 1.0 / 16
    ds = h / 2
    # the JAX function's positions before its cast to float32 (its last line
    # is np.asarray(path, dtype=np.float32))
    monkeypatch.setattr(JF, "np", type("NoCast", (), dict(asarray=staticmethod(
        lambda a, dtype=None: np.asarray(a)), float32=None)))
    want64, nrec = JF.record_paths(gt, jnp.asarray(x), jnp.asarray(v), h, ds, stride)
    monkeypatch.undo()
    want64 = np.asarray(want64)
    assert want64.dtype == np.float64
    want = np.asarray(want64, dtype=np.float32)
    gt_t, x_t, v_t = (torch.from_numpy(np.array(a)) for a in (gt, x, v))
    assert TF.record_steps(17, h, ds, stride) == (nrec, (nrec - 1) * stride)
    assert nrec == 136 // stride + 1
    got64 = TF.record_paths_plain(gt_t, x_t, v_t, h, ds, stride)
    assert got64.shape == (nrec, 514, 3) and got64.dtype == torch.float64
    np.testing.assert_allclose(got64.numpy().reshape(-1, 3), want64, rtol=0, atol=1e-12)
    got, got_nrec = TF.record_paths(gt_t, x_t, v_t, h, ds, stride)
    assert got_nrec == nrec and got.dtype == torch.float32 and got.shape == (nrec * 514, 3)
    np.testing.assert_array_less(np.abs(got.numpy() - want), np.spacing(np.abs(want)) * 1.0001)
    # the rays outside go on straight, one ds a step
    out = got64.numpy()[:, 512:, :]
    np.testing.assert_allclose(out[-1] - out[0], (nrec - 1) * stride * ds * v[512:], atol=1e-12)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.record_paths(gt_t, h, x_t, v_t, ds, nrec, stride)


@pytest.fixture(scope="module")
def tiny_runs(tiny_rays):
    """The JAX pipeline and the port's (CPU) on the same rays, for each path model."""
    gt, rays = tiny_rays
    rays_t = (torch.from_numpy(np.array(rays.x)), torch.from_numpy(np.array(rays.v)))
    gt_t = torch.from_numpy(np.asarray(gt))
    out = {}
    for spline in ("linear", "hermite", "true"):
        params = dict(TINY, spline=spline)
        out[spline] = (JF.fuel_reconstruction(gt, params),
                       TF.fuel_reconstruction(gt_t, params, rays=rays_t, device="cpu"))
    return out


@pytest.mark.parametrize("spline", ["linear", "hermite", "true"])
def test_fuel_reconstruction_matches_jax_on_the_same_rays(spline, tiny_runs):
    (want, want_rep), (got, rep) = tiny_runs[spline]
    assert got.shape == want.shape == (8, 8, 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-8 * np.abs(want).max())
    assert rep["num_rays"] == want_rep["num_rays"] > 0
    assert rep["phi_nnz"] == want_rep["phi_nnz"]
    for key in ("rel_err_norm", "max_err", "l1_err"):
        assert abs(rep[key] - want_rep[key]) <= 1e-6 * abs(want_rep[key]), key


def test_fuel_reconstruction_needs_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the GPU-less behaviour")
    gt = torch.ones((5, 5, 5), dtype=torch.float64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TF.fuel_reconstruction(gt, TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TF.gen_rays(TINY)
    rays = TF.gen_rays(TINY, device="cpu")
    n = TINY["nviews"] * TINY["nbins"] ** 2 * TINY["spp"]
    assert rays.x.shape == (n, 3) and rays.x.dtype == torch.float64


@pytest.mark.parametrize("h, exact", [
    (1.0 / 64, True), (1.0 / 16, True), (0.5, True), (1.0, True), (8.0, True),
    (2.0 ** -1022, True), (2.0 ** -1023, True), (2.0 ** 1023, True),
    (1.0 / 127, False), (0.9 / 16, False), (1.25, False), (20.0 / 127, False),
    (0.9 / 64, False), (-1.0 / 64, False), (0.0, False), (2.0 ** -1024, False),
    (5e-324, False), (float("inf"), False), (float("nan"), False)])
def test_exact_reciprocal_picks_the_powers_of_two(h, exact):
    """The host's rule for the f64 stencil's division (``trilinear.cuh``'s
    ``exact_reciprocal`` and its twin in the wrappers): the exact multiply at
    a power of two whose reciprocal f64 holds, the operator anywhere else
    (1/127, 0.9/16, a reciprocal that overflows, zero, inf, NaN)."""
    assert kernels.exact_reciprocal(h) is exact


def test_exact_reciprocal_multiply_equals_the_division():
    """At every power-of-two spacing the rule admits, ``a / h`` and ``a * (1 /
    h)`` are the same f64 for random bit patterns, random positions and the
    edge dividends (zeros, infinities, NaN, subnormals, the largest finite):
    each is the real a * 2^-k rounded once.  At 1/127 they are not, which is
    why the rule keeps the operator there."""
    gen = np.random.default_rng(0)
    bits = gen.integers(-2 ** 63, 2 ** 63 - 1, size=1 << 18, dtype=np.int64).view(np.float64)
    a = np.concatenate([np.array(kernels.DIV64_EDGES), bits,
                        gen.uniform(-128.0, 128.0, size=1 << 18)])
    with np.errstate(all="ignore"):
        for h in (1.0 / 64, 1.0 / 16, 0.5, 8.0, 2.0 ** -1022, 2.0 ** -1023, 2.0 ** 1023):
            assert kernels.exact_reciprocal(h)
            want, got = a / h, a * (1.0 / h)
            same = (want.view(np.int64) == got.view(np.int64)) | (np.isnan(want) & np.isnan(got))
            assert same.all(), h
        h = 1.0 / 127
        assert not kernels.exact_reciprocal(h)
        assert (a / h != a * (1.0 / h)).any()
