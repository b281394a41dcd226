"""The probe of each shipped driver section picks the exit-step buckets that
the JAX package's driver picks (``experiments.common.make_trace`` with
``probe_rays``, ``tracer.compaction.auto_buckets``).

CPU.  Each driver draws its probe as it does in a run: 4,096 rays of one
sample per pixel from a generator of its own (the port's ``torch.Generator``
seeded ``seed + 779`` where the JAX driver takes ``PRNGKey(seed + 779)``; the
fuel trainer its measurement rays).  The rays differ between the packages;
the pick must not.  The run stops where the trace is made.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from adjointnonlinearraytracing_tpu.experiments import common as JC
from adjointnonlinearraytracing_tpu.experiments import focalstack as JFS
from adjointnonlinearraytracing_tpu.experiments import runner as JR
from adjointnonlinearraytracing_tpu.tracer import compaction as JCP
from adjointnonlinearraytracing_tpu_torch.experiments import common as TC
from adjointnonlinearraytracing_tpu_torch.experiments import focalstack as TFS
from adjointnonlinearraytracing_tpu_torch.experiments import runner as TR
from adjointnonlinearraytracing_tpu_torch.tracer import compaction as TCP

CONFIGS = Path(__file__).resolve().parent.parent / "configs"


class _Picked(Exception):
    pass


def _pick_of(monkeypatch, common, compaction):
    """Make ``common.make_trace`` record what ``auto_buckets`` picks on the
    probe a driver hands it, and stop the run there."""
    picks = []
    real = common.make_trace

    def recording(vol_span, ds, *args, probe_rays=None, **kwargs):
        if probe_rays is None:  # a trace without a probe (the focal stack's render)
            return real(vol_span, ds, *args, **kwargs)
        assert probe_rays[0].shape[0] == 4096
        picks.append(compaction.auto_buckets(vol_span, probe_rays[0], probe_rays[1], ds))
        raise _Picked

    monkeypatch.setattr(common, "make_trace", recording)
    return picks


@pytest.mark.parametrize("yaml_name,section", [
    ("params-luneburg.yaml", None), ("params-image.yaml", "einstein-turing"),
    ("params-sdf.yaml", None), ("params-fuel.yaml", None),
    ("params-focalstack.yaml", "lkfs10_3im_srciminfocus_cone1_dist2")])
def test_each_driver_picks_the_buckets_jax_picks(monkeypatch, yaml_name, section):
    """The shipped sections' probes: Luneburg's six rotated cube faces spread
    (4 buckets on both sides), the planar views of the image, sdf and fuel
    sources (``fuel-128`` draws more of the fuel source's) and the focal
    stack's narrow cone do not (0).  The focal stack is
    called with a stand-in capture: its probe is drawn before the capture is
    read; its JAX draw runs jitted (the same function: eager, it compiles op by
    op, five times slower here)."""
    monkeypatch.delenv("ANRT_BUCKETED", raising=False)
    jpicks = _pick_of(monkeypatch, JC, JCP)
    tpicks = _pick_of(monkeypatch, TC, TCP)
    path = str(CONFIGS / yaml_name)
    if yaml_name == "params-focalstack.yaml":
        params = JR.cfg.load_params(path, section)
        nb = params["nbins"]
        stub = dict(params, src_angle=params["source_angle"], res_list=[3, 5],
                    source_image=np.zeros((nb, nb)), focal_stack=[np.zeros((nb, nb))] * 3)
        monkeypatch.setattr(JFS, "_gen_start_rays", jax.jit(
            JFS._gen_start_rays, static_argnums=tuple(range(1, 8))))
        with pytest.raises(_Picked):
            JFS.multires_exp(dict(stub, dtype=jnp.float64))
        with pytest.raises(_Picked):
            TFS.multires_exp(dict(stub, dtype="float64"), device="cpu")
    else:
        with pytest.raises(_Picked):
            JR.run(path, section)
        with pytest.raises(_Picked):
            TR.run(path, section, device="cpu")
    want = 4 if yaml_name == "params-luneburg.yaml" else 0
    assert jpicks == tpicks == [want]
