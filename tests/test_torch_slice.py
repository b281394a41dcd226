"""The port's main path as a whole against the JAX package: the bench
scene, the bench loss and its voxel gradient through ``tracer.trace``.

CPU, f64, ``res = 17`` and 256 rays.  Tolerances: loss ``1e-10`` relative,
gradient ``1e-9`` relative to its largest entry (same f64 arithmetic in a
different summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adjointnonlinearraytracing_tpu import tracer as JT
from adjointnonlinearraytracing_tpu.benchmarks import scenes as JS
from adjointnonlinearraytracing_tpu_torch import bench as TB
from adjointnonlinearraytracing_tpu_torch import convert
from adjointnonlinearraytracing_tpu_torch.benchmarks import scenes as TS

RES, NRAYS = 17, 256


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_build_case_bit_equal(dtype):
    jr, jx, jv, jspan = JS.build_case(res=RES, nrays=NRAYS, dtype=dtype, seed=3)
    tr, tx, tv, tspan = TS.build_case(res=RES, nrays=NRAYS, dtype=dtype, seed=3, device="cpu")
    assert tspan == jspan
    for t, j in ((tr, jr), (tx, jx), (tv, jv)):
        assert str(t.dtype) == f"torch.{dtype}" and t.is_contiguous()
        assert np.array_equal(t.numpy(), np.asarray(j))


def test_bench_loss_and_gradient_match_jax():
    rif, x0, v0, span = JS.build_case(res=RES, nrays=NRAYS, dtype="float64")
    h = span / (RES - 1)
    ds = h / 2
    target = jnp.asarray([span / 2, span * 1.1, span / 2], dtype=rif.dtype)

    @jax.jit
    def fwd_bwd(r):
        def loss(r):
            xt, vt = JT.trace(r, x0, v0, h, ds)
            return jnp.sum((xt - target) ** 2) + jnp.sum(vt)
        return jax.value_and_grad(loss)(r)

    loss_ref, g_ref = fwd_bwd(rif)
    g_ref = np.asarray(g_ref)

    trif, tx0, tv0, tspan = TS.build_case(res=RES, nrays=NRAYS, dtype="float64", device="cpu")
    loss, g = TB.fwd_bwd(trif, tx0, tv0, tspan)
    assert abs(float(loss) - float(loss_ref)) <= 1e-10 * abs(float(loss_ref))
    assert g.shape == trif.shape and trif.grad is None
    assert np.abs(g_ref).max() > 0
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=0, atol=1e-9 * np.abs(g_ref).max())


def test_convert_round_trip():
    arr = np.random.default_rng(0).uniform(size=(3, 4, 5))
    rif = convert.rif_from_numpy(arr.transpose(2, 1, 0), device="cpu", dtype=torch.float64)
    assert rif.is_contiguous() and rif.shape == (5, 4, 3)
    assert rif[4, 1, 2] == arr[2, 1, 4]  # layout data[z, y, x] kept as is
    assert np.array_equal(convert.rif_to_numpy(rif), arr.transpose(2, 1, 0))
    assert convert.rif_from_numpy(arr, device="cpu").dtype == torch.float32
    with pytest.raises(ValueError, match="3D voxel grid"):
        convert.rif_from_numpy(arr[0], device="cpu")


def test_bench_needs_a_gpu_and_never_uses_the_cpu_instead():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the GPU-less behaviour")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TB.run(res=9, nrays=16, iters=1)
    with pytest.raises(RuntimeError, match="needs device='cuda'"):
        TB.run(res=9, nrays=16, iters=1, device="cpu")
