"""One step of the port's fiber driver traces both of its passes (the near and
the hop focus) as one batch; here that step is held against the two passes
traced apart, as the driver traced them before, on the CPU in f64.

The rays are one draw of the driver's own source at ``nbins`` 8 with the focus
off the entry plane (``sensor_distance`` 1.57, as the ``hop2opt`` section), so
that both passes have a loss and a gradient; the profile is the known answer
at 9 bins with 1 % noise.  Loss and profile gradient must agree to 1e-12 of
their largest magnitude in each gradient mode: the per-ray work is the same,
only the order of the gradient's sums differs.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from adjointnonlinearraytracing_tpu_torch.experiments import fiber as TF
from adjointnonlinearraytracing_tpu_torch.experiments import runner as TR

FIBER_YAML = str(Path(__file__).resolve().parent.parent / "configs" / "params-fiber.yaml")
TOL = 1e-12


@pytest.fixture(scope="module")
def scene():
    params = dict(TR.cfg.load_params(FIBER_YAML), nbins=8, sensor_distance=1.57)
    rays = TF.gen_start_rays(params, torch.Generator().manual_seed(3), torch.float64)
    noise = np.random.default_rng(0).uniform(0.0, 0.01, 9)
    prof = TF.ground_truth(9, torch.float64, "cpu") + torch.from_numpy(noise)
    return TF.FiberLoss.from_params(params), rays, prof


def _loss_and_grad(fn, prof):
    p = prof.clone().requires_grad_(True)
    loss = fn(p)
    (g,) = torch.autograd.grad(loss, p)
    return float(loss.detach()), g


@pytest.mark.parametrize("mode", ["adjoint", "exact", "ad"])
def test_both_passes_in_one_trace_equal_two_traces(scene, mode):
    loss_of, rays, prof = scene

    def two_traces(p):
        terms = []
        for hop in (0.0, loss_of.hop_distance):
            sp = loss_of.targets(rays, hop)
            xm, _, dist2 = loss_of.trace(p, rays.x, rays.v, sp, mode)
            terms.append(loss_of.pass_loss(xm, dist2, sp, rays.mask))
        assert all(float(t) > 0 for t in terms)  # both passes count
        return terms[0] + loss_of.hop_weight * terms[1]

    loss, g = _loss_and_grad(lambda p: loss_of.step(p, rays, mode), prof)
    want_loss, want_g = _loss_and_grad(two_traces, prof)
    assert float(want_g.abs().max()) > 0
    assert abs(loss - want_loss) <= TOL * abs(want_loss)
    np.testing.assert_allclose(g.numpy(), want_g.numpy(), rtol=0,
                               atol=TOL * float(want_g.abs().max()))
