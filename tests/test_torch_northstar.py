"""The north-star run of the port (``experiments/northstar.py``) against the
JAX package, and the native loader's ``accumulate_linear_paths``.

CPU, f64 (conftest enables x64).  The measurement rays are the JAX package's
own draw at a sixteenth of the views and pixels,
``rand_rays_in_sphere(PRNGKey(0), 2, (8, 8), 20, 1.0, sensor_dist=0)``
(2,560 rays, 16 microbatches of 160), handed to both sides as numpy arrays.
The JAX side restates ``run_fuel_northstar.py`` (which runs at import) from
the JAX package's public functions: its ``chunk_loss`` (``:173-186``), its
loop (``:188-272``, optax Adam, the step count carried across the stage
change) and its prior (``:155-167``).  The restated loop leaves out the
spot check, which reads the field and changes nothing;
``test_torch_fuel.py::test_gradient_spotcheck_matches_jax`` holds the port's
against the JAX one.  Each JAX reference is computed once per module.
Tolerances, relative to the reference's largest magnitude: one microbatch's
loss and gradient 1e-9, the whole run 1e-8 (``PERF.md`` §2), the resume
1e-12.  ``tools/jax_northstar_reference.py`` holds the port against the JAX
script itself, run as a script, in f32.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from adjointnonlinearraytracing_tpu import sensors as JSEN
from adjointnonlinearraytracing_tpu import tracer as JT
from adjointnonlinearraytracing_tpu.experiments import common as JC
from adjointnonlinearraytracing_tpu.experiments import fuel_injection as JF
from adjointnonlinearraytracing_tpu.experiments import voxel_scenes as JV
from adjointnonlinearraytracing_tpu.fields.grid import upres_volume as j_upres_volume
from adjointnonlinearraytracing_tpu.native import loader as JL
from adjointnonlinearraytracing_tpu.opt import multires as JM
from adjointnonlinearraytracing_tpu.sources import sources as JS
from adjointnonlinearraytracing_tpu.tracer import compaction as JCOMP
from adjointnonlinearraytracing_tpu_torch.experiments import northstar as NS
from adjointnonlinearraytracing_tpu_torch.experiments import voxel_scenes as TV
from adjointnonlinearraytracing_tpu_torch.fields.grid import upres_volume as t_upres_volume
from adjointnonlinearraytracing_tpu_torch.native import loader as TL
from adjointnonlinearraytracing_tpu_torch.sources import sources as TS

SPAN, FUEL = NS.VOL_SPAN, NS.FUEL_VAL
STAGES = ((5, 2, 2), (9, 2, 4))


def _close(got, want, tol):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-300))


@pytest.fixture(scope="module")
def rays_np():
    # one compile of the whole draw: its arrays equal the eager call's bit for bit
    draw = jax.jit(lambda key: JS.rand_rays_in_sphere(key, 2, (8, 8), 20, SPAN,
                                                      sensor_dist=0)[0])
    return tuple(np.array(a) for a in draw(jax.random.PRNGKey(0)))


def _torch_rays(arrays):
    return TS.Rays(*(torch.from_numpy(a) for a in arrays))


def _j_regularizer(eta, kind):
    """``run_fuel_northstar.py:155-167``."""
    e = (eta - 1.0) / FUEL
    dz = e[1:] - e[:-1]
    dy = e[:, 1:] - e[:, :-1]
    dx = e[:, :, 1:] - e[:, :, :-1]
    if kind == "h1":
        return jnp.mean(dz ** 2) + jnp.mean(dy ** 2) + jnp.mean(dx ** 2)
    eps = 1e-6
    return (jnp.mean(jnp.sqrt(dz ** 2 + eps)) + jnp.mean(jnp.sqrt(dy ** 2 + eps))
            + jnp.mean(jnp.sqrt(dx ** 2 + eps)))


def _j_trace(eta, x, v, h, ds, nbuckets):
    if nbuckets > 1:
        return JCOMP.trace_bucketed(eta, x, v, h, ds, nbuckets)
    return JT.trace(eta, x, v, h, ds)


def _j_data_loss(eta, x, v, sp, sn, xg, vg, m, h, ds, nbuckets):
    """``chunk_loss`` of ``run_fuel_northstar.py:173-183`` without the prior."""
    xm, vm = _j_trace(eta, x, v, h, ds, nbuckets)
    xmp, vmp = JSEN.trace_rays_to_plane((xm, vm), (sp, sn))
    disp = JC.masked_mean_sq(xmp - xg, m) / 3.0
    defl = JC.masked_mean_sq(vmp - vg, m) / 3.0
    return (disp + 1.0 * defl) / FUEL


_j_data_vg = jax.jit(jax.value_and_grad(_j_data_loss), static_argnums=(8, 9, 10))
_j_prior_vg = jax.jit(jax.value_and_grad(lambda e, tv, kind: tv * _j_regularizer(e, kind)),
                      static_argnums=(2,))
_j_gt_trace = jax.jit(
    lambda eta, x, v, sp, sn, h, ds, nb: JSEN.trace_rays_to_plane(
        _j_trace(eta, x, v, h, ds, nb), (sp, sn)), static_argnums=(5, 6, 7))


def _j_chunk_vg(eta, c, chunk, arrays, xg, vg, h, ds, nbuckets, tv=0.0, kind="tv"):
    """``jax.value_and_grad`` of the script's ``chunk_loss`` on microbatch ``c``:
    the prior's term is a sum, so its value and gradient add to the data term's."""
    x, v, planes, mask = arrays
    s = slice(c * chunk, (c + 1) * chunk)
    loss, g = _j_data_vg(eta, jnp.asarray(x[s]), jnp.asarray(v[s]), jnp.asarray(planes[s, 0]),
                         jnp.asarray(planes[s, 1]), xg[s], vg[s], jnp.asarray(mask[s]), h, ds,
                         nbuckets)
    if tv:
        lr_, gr = _j_prior_vg(eta, tv, kind)
        loss, g = loss + lr_, g + gr
    return loss, g


def _j_ground_truth(arrays, res, ds, nbuckets):
    x, v, planes, _ = arrays
    gt = j_upres_volume(JV.fuel_injection_rif(FUEL, jnp.float64), (res,) * 3)
    chunk = x.shape[0] // NS.NCHUNKS
    xg, vg = [], []
    for c in range(NS.NCHUNKS):
        s = slice(c * chunk, (c + 1) * chunk)
        a, b = _j_gt_trace(gt, jnp.asarray(x[s]), jnp.asarray(v[s]), jnp.asarray(planes[s, 0]),
                           jnp.asarray(planes[s, 1]), SPAN / (res - 1), ds, nbuckets)
        xg.append(a)
        vg.append(b)
    return gt, jnp.concatenate(xg), jnp.concatenate(vg)


@pytest.fixture(scope="module")
def jax_run(rays_np):
    """``run_fuel_northstar.py:188-272`` in f64 on ``STAGES``, the spot check left
    out: per-iteration losses, per-stage ``rel_norm``, each stage's field."""
    x = rays_np[0]
    lr, alpha = 1e-4, 0.5
    ds_fin = SPAN / (STAGES[-1][0] - 1) * alpha
    nbuckets = JCOMP.auto_buckets(SPAN, jnp.asarray(x[:8192]), jnp.asarray(rays_np[1][:8192]),
                                  ds_fin)
    gt, xg, vg = _j_ground_truth(rays_np, STAGES[-1][0], ds_fin, nbuckets)
    chunk = x.shape[0] // NS.NCHUNKS
    eta = jnp.ones((STAGES[0][0],) * 3, dtype=jnp.float64) + FUEL
    opt = optax.adam(lr)
    opt_state = opt.init(eta)
    stage_lr, losses, rel_norms, etas = lr, [], [], {}
    for stage, (res, iters, cpi) in enumerate(STAGES):
        h, ds = SPAN / (res - 1), SPAN / (res - 1) * alpha
        bmask = JM.boundary_interior_mask(eta.shape)
        for i in range(iters):
            g = jnp.zeros_like(eta)
            loss = 0.0
            for k in range(cpi):
                l, gc = _j_chunk_vg(eta, (i * cpi + k) % NS.NCHUNKS, chunk, rays_np, xg, vg, h,
                                    ds, nbuckets)
                g = g + gc
                loss += float(l)
            updates, opt_state = opt.update((g / cpi) * bmask.astype(g.dtype), opt_state, eta)
            eta = jnp.maximum(optax.apply_updates(eta, updates), 1.0)
            losses.append(loss / cpi)
        rel_norms.append(JF.reconstruction_error(eta, gt, background=1.0 + FUEL)["rel_norm"])
        etas[res] = np.asarray(eta)
        if stage < len(STAGES) - 1:
            new_res = STAGES[stage + 1][0]
            eta = JM.upres_scene(eta, new_res)
            stage_lr *= 0.5
            opt = optax.adam(stage_lr)
            fresh = opt.init(eta)
            i_old, adam_old = JM._find_adam_state(opt_state)
            opt_state = tuple(JM.upres_adam_state(adam_old, new_res) if j == i_old else sj
                              for j, sj in enumerate(fresh))
    return dict(nbuckets=nbuckets, xg=np.asarray(xg), vg=np.asarray(vg), losses=losses,
                rel_norms=rel_norms, etas=etas)


@pytest.fixture(scope="module")
def port_run(rays_np):
    rows = []
    eta, report = NS.run(NS.Settings(stages=STAGES, result_dir=None), rays=_torch_rays(rays_np),
                         device="cpu", on_row=rows.append)
    return eta, report, rows


@pytest.mark.parametrize("tv, kind", [(0.0, "tv"), (0.05, "tv"), (0.05, "h1")])
def test_one_microbatch_loss_and_gradient_match_the_script(rays_np, jax_run, tv, kind):
    res, c = 9, 3
    h = SPAN / (res - 1)
    ds = h * 0.5
    nbuckets = jax_run["nbuckets"]
    data = NS.Measurements(_torch_rays(rays_np), "cpu", torch.float64)
    gt_t = t_upres_volume(TV.fuel_injection_rif(FUEL, torch.float64, "cpu"), (res,) * 3)
    data.trace_ground_truth(gt_t, ds, nbuckets)
    # the jax_run fixture traced its ground truth at 9^3, ds = h/2 too
    _close(data.xg, jax_run["xg"], 1e-9)
    _close(data.vg, jax_run["vg"], 1e-9)
    rng = np.random.default_rng(7)
    eta_np = 1.0 + FUEL * rng.uniform(size=(res,) * 3)
    loss_fn = NS.make_chunk_loss(data, nbuckets, tv, kind)
    loss, g = NS.value_and_grad(loss_fn, torch.from_numpy(eta_np), c, h, ds)
    want_l, want_g = _j_chunk_vg(jnp.asarray(eta_np), c, data.chunk, rays_np,
                                 jnp.asarray(jax_run["xg"]), jnp.asarray(jax_run["vg"]),
                                 h, ds, nbuckets, tv, kind)
    _close(loss, want_l, 1e-9)
    _close(g, want_g, 1e-9)
    assert float(np.abs(np.asarray(want_g)).max()) > 0


def test_the_run_matches_the_script(jax_run, port_run):
    eta, report, rows = port_run
    assert report["nbuckets"] == jax_run["nbuckets"]
    losses = [r["loss"] for r in rows if "iter" in r]
    assert [r["iter"] for r in rows if "iter" in r] == list(range(4))
    _close(np.array(losses), np.array(jax_run["losses"]), 1e-8)
    stage_rows = [r for r in rows if "stage" in r]
    assert [r["stage"] for r in stage_rows] == [5, 9]
    _close(np.array([r["rel_norm"] for r in stage_rows]), np.array(jax_run["rel_norms"]),
           1e-8)
    _close(eta - 1.0, jax_run["etas"][9] - 1.0, 1e-8)
    assert report["reconstruction"]["rel_norm"] == stage_rows[-1]["rel_norm"]
    assert [r["stage_start"] for r in rows if "stage_start" in r] == [5, 9]
    assert report["rays_per_iter"] == 4 * 160 and report["device"] == "cpu"
    assert float((eta - 1.0).abs().max()) > 0


def test_read_report_gives_each_stage(port_run, tmp_path):
    """The report's ``rel_norm`` at the end of every stage, as the head-to-head
    and the sweeps read it back; the JAX record's report reads the same way;
    a missing report or key raises, naming the file."""
    _, report, rows = port_run
    per_stage = {r["stage"]: r["rel_norm"] for r in rows if "stage" in r}
    assert report["reconstruction_per_stage"] == {str(k): v for k, v in per_stage.items()}
    path = tmp_path / "report.json"
    path.write_text(json.dumps(report))
    assert NS.read_report(str(path)) == (9, report["reconstruction"]["rel_norm"], per_stage)
    final, rel_norm, stages = NS.read_report(
        str(Path(__file__).resolve().parent.parent / "results" / "fuel_northstar" /
            "report.json"))
    assert (final, rel_norm, stages[65]) == (129, 0.27131563425064087, 0.3002689480781555)
    with pytest.raises(FileNotFoundError, match="no north-star report at .*none.json"):
        NS.read_report(str(tmp_path / "none.json"))
    path.write_text(json.dumps({"grid": "9^3"}))
    with pytest.raises(KeyError, match="report.json has no"):
        NS.read_report(str(path))
    assert NS.REPORT == "results/fuel_northstar_torch/report.json"


def test_resume_from_a_jax_field_equals_jax_upres(jax_run, tmp_path):
    path = tmp_path / "eta_5.npy"
    np.save(path, jax_run["etas"][5])
    got = NS.initial_field(NS.Settings(stages=((9, 1, 1),), init=str(path)), torch.float64,
                           "cpu")
    want = JM.upres_scene(jnp.asarray(np.load(path)), 9)
    _close(got - 1.0, np.asarray(want) - 1.0, 1e-12)
    assert got.shape == (9, 9, 9)
    same = NS.initial_field(NS.Settings(stages=((5, 1, 1),), init=str(path)), torch.float64,
                            "cpu")
    assert np.array_equal(same.numpy(), jax_run["etas"][5])


def test_settings_read_the_jax_scripts_variables():
    env = dict(NS_STAGES="33:200:2,65:100:4", NS_LR="5e-5", NS_ERR_EVERY="7",
               NS_DS_MODE="final", NS_DS_ALPHA="1.0", NS_TV="0.1", NS_REG="h1",
               NS_INIT="eta.npy", NS_SCALE="4", NS_DIR="out")
    s = NS.Settings.from_env(env)
    assert s == NS.Settings(stages=((33, 200, 2), (65, 100, 4)), lr=5e-5, err_every=7,
                            ds_mode="final", ds_alpha=1.0, tv_weight=0.1, reg="h1",
                            init="eta.npy", scale=4, result_dir="out")
    assert s.stage_ds(33) == s.final_ds() == 1.0 / 64
    assert NS.Settings.from_env({}).ladder == NS.SHIPPED_STAGES
    assert NS.Settings.from_env({"NS_SCALE": "16"}).ladder == ((9, 3, 2), (17, 2, 16))
    assert NS.Settings().stage_ds(17) == 0.5 / 16


def test_the_run_writes_the_scripts_files(rays_np, tmp_path):
    out = tmp_path / "ns"
    x, v, planes, mask = rays_np
    eta, report = NS.run(NS.Settings(stages=((5, 1, 16),), result_dir=str(out), tv_weight=0.1),
                         rays=_torch_rays((x.astype(np.float32), v.astype(np.float32),
                                           planes.astype(np.float32), mask)), device="cpu")
    assert eta.dtype == torch.float32
    assert sorted(p.name for p in out.iterdir()) == ["eta_5.npy", "final_eta.npy",
                                                    "metrics.jsonl", "report.json"]
    rows = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert list(rows[0])[:3] == ["stage_start", "ds", "grad_spotcheck"]
    assert rows[1]["rays"] == 2560 and "rel_norm" in rows[1] and rows[2]["stage"] == 5
    saved = json.loads((out / "report.json").read_text())
    for key in ("grid", "rays_per_iter", "final_loss", "reconstruction",
                "grad_spotcheck_per_stage", "stages", "lr", "ds_mode", "ds_alpha", "tv_weight",
                "reg", "nbuckets", "device"):
        assert key in saved
    assert np.array_equal(np.load(out / "final_eta.npy"), eta.numpy())


def test_accumulate_linear_paths_equals_the_jax_loader():
    if JL.get_lib() is None:
        pytest.skip("no g++ toolchain")
    rng = np.random.default_rng(3)
    spos = rng.uniform(0.0, 1.0, (64, 3))
    epos = rng.uniform(0.0, 1.0, (64, 3))
    got = TL.accumulate_linear_paths(spos, epos, 1.0 / 16, 16, 64)
    want = JL.accumulate_linear_paths(spos, epos, 1.0 / 16, 16, 64)
    assert len(got[0]) > 64
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
