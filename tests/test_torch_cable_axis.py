"""The fiber's near-axial ray (``tests/data/fiber_axial_ray.json``) through the
cable adjoint of both packages, CPU.

The ray comes from a fiber refinement step whose f32 gradient was not finite
on the card (ROADMAP C13).  Backwards from its closest approach it runs
within 2e-3 of the axis for ~1,500 steps, where the radial Hessian
``(rx/r)(I - xhat xhat^T)`` of its profile (a slope of -3.5 in the first
bin) reaches 1e4-1e5: the adjoint, and the sensitivity of the recomputed path
to rounding, grow by some 40 orders of magnitude.  So the two packages, f32
and f64, give the first two bins' gradient no two alike (from ~1e19 to
~1e31, or past f32's range on the card, where K8 and its plain version agree
bit for bit), and what both share, held here, is the blow-up itself.  On the
ground truth's profile ``sqrt(2 - r^2)``, whose first bin's slope is ~1,000
times smaller, the same ray's gradient stays below 1e-3 and the packages
agree to 1e-9 in f64.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adjointnonlinearraytracing_tpu.fields import cylinder as JC
from adjointnonlinearraytracing_tpu.tracer import eikonal as JE
from adjointnonlinearraytracing_tpu_torch.fields import cylinder as TC
from adjointnonlinearraytracing_tpu_torch.tracer import eikonal as TE

CASE = json.loads((Path(__file__).resolve().parent / "data" / "fiber_axial_ray.json").read_text())
RAY = ("xt", "vt", "dx", "dv")


def _both(profile, dtype):
    """Both packages' gradient of the ray in ``dtype`` (numpy)."""
    r, length, ds, steps = CASE["radius"], CASE["length"], CASE["ds"], CASE["max_steps"]
    prof = np.asarray(profile, np.float32).astype(dtype)
    ray = [np.asarray(CASE[k], np.float32).astype(dtype).reshape(1, 3) for k in RAY]
    port = TE.backtrace_cable(TC.CylinderField(torch.from_numpy(prof), r, length),
                              *(torch.from_numpy(a) for a in ray), ds, steps)
    jax_g = jax.jit(lambda p, *a: JE.backtrace_cable(JC.CylinderField(p, r, length), *a, ds,
                                                     steps))(jnp.asarray(prof),
                                                             *(jnp.asarray(a) for a in ray))
    return port.numpy(), np.asarray(jax_g)


def test_the_ray_stays_near_the_axis():
    x = np.asarray(CASE["xt"])
    assert np.hypot(x[0] - CASE["radius"], x[2] - CASE["radius"]) < 2e-3
    h = CASE["radius"] / (len(CASE["profile"]) - 1)
    assert abs(CASE["profile"][1] - CASE["profile"][0]) / h > 3.0  # a slope at the axis


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_both_packages_blow_up_on_the_axial_ray(dtype):
    """Bins 0 and 1 beyond 1e15 in magnitude (or not finite) in both packages,
    every other bin 0: a ray off the axis gives ~1e-8 here."""
    for g in _both(CASE["profile"], dtype):
        big = ~np.isfinite(g[:2]) | (np.abs(g[:2]) > 1e15)
        assert big.all() and not g[2:].any()


def test_on_the_ground_truth_both_packages_agree():
    r = np.linspace(0.0, 1.0, len(CASE["profile"]))
    port, jax_g = _both(np.sqrt(2.0 - r ** 2), np.float64)
    assert np.isfinite(port).all() and 0 < np.abs(port).max() < 1e-3
    np.testing.assert_allclose(port, jax_g, rtol=0, atol=1e-9 * np.abs(jax_g).max())
