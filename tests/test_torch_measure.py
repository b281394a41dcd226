"""The port's measurement modules (``benchmarks/``) and ``utils/profiling.py``
on the CPU, against the JAX package's rows and arrays where they have them.

The JAX references are computed once a module: the rows' keys of the JAX
sweeps with their timing stubbed (the keys, not the times, are compared),
the ds study's rows from the JAX module's own ``scenes``, ``entry_rays`` and
``tracer.trace_exact`` in one jit, and the compaction scene's arrays.  f64
where the port computes, tolerance ``1e-12`` of the largest magnitude (the
ds study's rows ``1e-9``: each is a difference of two traces).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adjointnonlinearraytracing_tpu import tracer as JT
from adjointnonlinearraytracing_tpu.benchmarks import compaction_bench as JCB
from adjointnonlinearraytracing_tpu.benchmarks import ds_study as JDS
from adjointnonlinearraytracing_tpu.benchmarks import sweeps as JSW
from adjointnonlinearraytracing_tpu.tracer import compaction as JCP
from adjointnonlinearraytracing_tpu_torch.benchmarks import (
    compaction_bench, ds_study, probe_bandscatter, probe_ds_speed, probe_evalmath,
    probe_exact_envelope, probe_hotops, probe_scatter3, scaling, sweeps)
from adjointnonlinearraytracing_tpu_torch.utils import profiling

F64 = torch.float64


def test_profiling_on_cpu_tensors(tmp_path):
    x = {"a": torch.ones(3, dtype=F64), "b": [torch.full((2,), 2.0), (torch.tensor(4.0),)]}
    assert profiling.force(x, device="cpu") == 11.0
    calls = []
    t = profiling.timeit(lambda v: calls.append(v) or torch.ones(2) * v, 3.0, iters=2, warmup=1,
                         device="cpu")
    assert t > 0 and calls == [3.0] * 3
    assert profiling.best_of(lambda v: torch.ones(2) * v, [(1.0,), (2.0,), (3.0,)], "cpu") > 0
    assert profiling.device_memory_gb("cpu") is None
    with profiling.trace(str(tmp_path / "tr"), device="cpu") as prof:
        torch.ones(8).sum()
    assert prof is not None
    with open(tmp_path / "tr" / "trace.json") as f:
        assert "traceEvents" in json.load(f)


def test_card_line_reads_nvidia_smi_or_gives_none(monkeypatch, tmp_path):
    smi = tmp_path / "nvidia-smi"
    smi.write_text("#!/bin/sh\n[ \"$1 $2\" = \"--query-gpu=name,power.limit "
                   "--format=csv,noheader\" ] || exit 3\n"
                   "printf 'NVIDIA H100 80GB HBM3, 700.00 W\\nNVIDIA H100 80GB HBM3, 700.00 W\\n'\n")
    smi.chmod(0o755)
    monkeypatch.setenv("PATH", str(tmp_path))
    assert profiling.card_line() == "NVIDIA H100 80GB HBM3, 700.00 W"
    smi.unlink()
    assert profiling.card_line() is None


@pytest.fixture(scope="module")
def jax_sweep_rows():
    """The JAX sweeps' rows at res 9, 128 rays, one iteration, their timing
    stubbed out (its compiles would take most of a minute)."""
    saved = JSW._time_grad
    JSW._time_grad = lambda loss_fn, rif, iters=2: 0.5
    try:
        return (JSW.profile_stepsize(nrays=128, res=9, iters=1, include_ad=True),
                JSW.profile_resolution(nrays=128, iters=1, res_list=(9,)))
    finally:
        JSW._time_grad = saved


def test_sweeps_rows_have_the_jax_keys(jax_sweep_rows):
    j_step, j_res = jax_sweep_rows
    step = sweeps.profile_stepsize(nrays=128, res=9, iters=1, device="cpu")
    res = sweeps.profile_resolution(nrays=128, iters=1, res_list=(9,), include_ad=True,
                                    device="cpu")
    assert [r["ds_mult"] for r in step] == [r["ds_mult"] for r in j_step]
    for got, want in zip(step + res, j_step + j_res):
        assert set(got) == set(want)
    for got, want in zip(step, j_step):
        assert got["ds"] == want["ds"]
    assert all(r["back_time_s"] > 0 and r["ad_time_s"] > 0 and r["mem_gb"] is None
               for r in step + res)


RES, SPAN, NRAYS = 9, 20.0, 24
ALPHAS = (0.5, 1.0)


@pytest.fixture(scope="module")
def jax_ds_rows():
    """The JAX study's rows for the Luneburg scene (its loop, on the JAX
    module's own scenes, rays and ``trace_exact``), at res 9, 24 rays."""
    h = SPAN / (RES - 1)
    x0, v0 = JDS.entry_rays(NRAYS, SPAN, jnp.float64)
    y_plane = SPAN * 1.05

    def project(xt, vt):
        t = (y_plane - xt[:, 1]) / vt[:, 1]
        return xt + t[:, None] * vt

    def traced(rif, ds):
        def f(r):
            xt, vt = JT.trace_exact(r, x0, v0, h, ds)
            return jnp.sum(project(xt, vt) ** 2), (vt, project(xt, vt))
        (_, aux), g = jax.value_and_grad(f, has_aux=True)(rif)
        return aux + (g,)

    def all_ds():
        rif = JDS.scenes(RES, SPAN, jnp.float64)["luneburg"]
        return rif, [traced(rif, a * h) for a in (0.125,) + ALPHAS]

    rif, outs = jax.jit(all_ds)()
    (vt_ref, xp_ref, g_ref), rows = outs[0], []
    un = lambda a: a / jnp.linalg.norm(a, axis=-1, keepdims=True)  # noqa: E731
    for alpha, (vt, xp, g) in zip(ALPHAS, outs[1:]):
        perr = jnp.linalg.norm(xp - xp_ref, axis=-1) / h
        aerr = jnp.arccos(jnp.clip(jnp.sum(un(vt) * un(vt_ref), axis=-1), -1, 1))
        gn_ref = jnp.linalg.norm(g_ref)
        rows.append(dict(
            plane_err_vox_mean=float(jnp.mean(perr)), plane_err_vox_max=float(jnp.max(perr)),
            dir_err_rad_mean=float(jnp.mean(aerr)), dir_err_rad_max=float(jnp.max(aerr)),
            grad_rel_l2=float(jnp.linalg.norm(g - g_ref) / jnp.maximum(gn_ref, 1e-30)),
            grad_cos=float(jnp.vdot(g, g_ref) / jnp.maximum(jnp.linalg.norm(g) * gn_ref, 1e-30)),
            nmax=round(float(jnp.max(rif)), 4), ds=round(float(alpha * h), 6)))
    return np.asarray(rif), rows


def test_ds_study_rows_equal_the_jax_rows(jax_ds_rows):
    rif_j, want = jax_ds_rows
    x0, v0 = ds_study.entry_rays(NRAYS, SPAN, device="cpu")
    jx0, jv0 = JDS.entry_rays(NRAYS, SPAN, jnp.float64)
    assert np.array_equal(x0.numpy(), np.asarray(jx0)) and np.array_equal(v0.numpy(),
                                                                          np.asarray(jv0))
    rif = ds_study.scenes(RES, SPAN, device="cpu", names=("luneburg",))["luneburg"]
    np.testing.assert_allclose(rif.numpy(), rif_j, rtol=0, atol=1e-15)
    got = ds_study.scene_rows("luneburg", rif, x0, v0, SPAN, ALPHAS)
    assert [r["alpha"] for r in got] == list(ALPHAS)
    for g, w in zip(got, want):
        assert set(g) == {"scene", "res", "nrays", "alpha", "paired_ok", *w}
        assert g["nmax"] == w["nmax"] and g["ds"] == w["ds"]
        for key in ("plane_err_vox_mean", "plane_err_vox_max", "dir_err_rad_mean",
                    "dir_err_rad_max", "grad_rel_l2", "grad_cos"):
            assert abs(g[key] - w[key]) <= 1e-9 * max(1.0, abs(w[key])), key
    assert got[0]["plane_err_vox_max"] > 0 and got[1]["grad_rel_l2"] > got[0]["grad_rel_l2"]


def test_ds_study_rough_scene_takes_the_given_draw():
    draw = np.random.default_rng(0).random((5, 5, 5))
    rough = ds_study.scenes(5, SPAN, device="cpu", rough=draw, names=("rough_10pct",))
    assert torch.equal(rough["rough_10pct"], 1.0 + 0.1 * torch.from_numpy(draw))
    seeded = ds_study.scenes(5, SPAN, device="cpu", names=("rough_10pct",))["rough_10pct"]
    assert seeded.shape == (5, 5, 5) and bool(((seeded >= 1.0) & (seeded < 1.1)).all())
    given = ds_study.scenes(5, SPAN, device="cpu", rough=torch.Generator().manual_seed(0),
                            names=("rough_10pct",))["rough_10pct"]
    assert torch.equal(given, seeded)


def test_compaction_bench_spread_case_and_chord_stats():
    n = 4096
    _, jx, jv, _ = JCB.spread_case(res=17, nrays=n)
    x, v = compaction_bench.spread_arrays(nrays=n)
    assert x.dtype == np.float32 and np.array_equal(x, np.asarray(jx))
    assert np.array_equal(v, np.asarray(jv))
    rif, tx, tv, span = compaction_bench.spread_case(res=17, nrays=n, device="cpu")
    assert torch.equal(tx, torch.from_numpy(x)) and rif.shape == (17, 17, 17)
    # the statistics on the f64 copies of the same rays, on both sides
    h, ds = span / 16, span / 32
    x64, v64 = np.float64(x), np.float64(v)
    steps = JCP.chord_steps((17, 17, 17), h, jnp.asarray(x64), jnp.asarray(v64), ds)
    want = [float(jnp.percentile(steps, 10.0)), float(jnp.percentile(steps, 90.0)),
            round(JCP.chord_spread((17, 17, 17), h, jnp.asarray(x64), jnp.asarray(v64), ds), 2)]
    got = compaction_bench.chord_stats(rif, torch.from_numpy(x64), torch.from_numpy(v64), h, ds)
    for g, w in zip((got["chord_steps_p10"], got["chord_steps_p90"], got["chord_spread"]), want):
        assert abs(g - w) <= 1e-12 * max(1.0, abs(w))
    assert got["chord_spread"] > 3


def test_compaction_bench_run_on_the_cpu():
    stats, rows = compaction_bench.run(res=9, nrays=256, iters=1, device="cpu")
    assert stats["nrays"] == 256 and [r["nbuckets"] for r in rows] == [1, 4]
    assert all(set(r) == {"nbuckets", "time_s", "rays_per_s"} for r in rows)


def test_scaling_at_world_size_one():
    rows = scaling.profile_scaling(res=9, rays_per_device=64, iters=1, device="cpu")
    assert len(rows) == 1
    assert set(rows[0]) == {"devices", "rays", "time_s", "rays_per_s", "efficiency"}
    assert rows[0]["devices"] == 1 and rows[0]["rays"] == 64 and rows[0]["efficiency"] == 1.0


def test_probe_ds_speed_and_exact_envelope_on_the_cpu(monkeypatch, tmp_path):
    rows = probe_ds_speed.run(res=9, nrays=64, iters=1, device="cpu")
    assert [r["alpha"] for r in rows] == [0.5, 0.83, 1.0, 1.2]
    assert rows[0]["vs_alpha_0.5"] == 1.0 and all(r["grad_finite"] for r in rows)
    rec = probe_exact_envelope.run_case(9, nrays=96, steps=1, device="cpu")
    # the JAX probe's keys, and the memory
    assert {"res", "nrays", "chunk", "first_call_s", "per_step_s", "rays_per_s_exact",
            "grad_finite"} <= set(rec)
    assert rec["grad_finite"] and rec["peak_gb"] is None and rec["chunks"] == 1
    monkeypatch.setenv("ANRT_EXACT_CHUNK", "40")
    assert probe_exact_envelope.run_case(9, nrays=96, steps=1, device="cpu")["chunks"] == 3


def test_probe_evalmath_on_the_cpu():
    rec = probe_evalmath.run(res=9, n=512, device="cpu", dtype="float64")
    assert rec["max_abs_err"] == 0.0 and all(rec["bitwise"].values())
    assert 0 < rec["points_inside"] < 512 and "ms" not in rec
    field, p, _ = probe_evalmath.points(9, 512, "cpu", dtype="float64")
    order = probe_evalmath.cell_order(field, p)
    cells = torch.floor(p[order] / field.h).clamp(0, 8)
    key = (cells[:, 2] * 9 + cells[:, 1]) * 9 + cells[:, 0]
    assert bool((key[1:] >= key[:-1]).all())
    bound_ms, by, nbytes = probe_evalmath.bound(field, 512)
    assert by == "bytes" and nbytes == 512 * 7 * 8 + 512 + 9 ** 3 * 8


def test_scatter_probes_hold_each_case_to_its_baseline():
    rows = probe_scatter3.run(n=300, steps=3, scatter_shapes=((50, 4), (1000, 3)),
                              gather_shapes=((40, 6),), segsum_shapes=((30, 2),), reps=1,
                              dtype=F64, device="cpu")
    rows += probe_hotops.run(steps=3, scatter_shapes=((300, 4),), gather_shapes=((300, 8),),
                             tab_bytes=4096, reps=1, dtype=F64, device="cpu")
    # 64 steps: the window drifts off the table's end, as the JAX probe's does
    rows += probe_bandscatter.run(n=600, lanes=5, sites=3000, steps=64, band=256, rowlen=50,
                                  reps=1, dtype=F64, device="cpu")
    assert len(rows) == 5 + 2 + 7
    for r in rows:
        for key in ("max_rel_err", "max_rel_err_f64"):
            assert r[key] is None or r[key] <= 1e-12, r
        assert r["ms_per_step"] is None  # no time off the card
    idx = probe_bandscatter.coherent_idx(torch.Generator().manual_seed(0), 10_000, 3, 3000, 256,
                                         50)
    assert int(idx.min()) >= 0 and int(idx.max()) < 3000
    near = ((idx - 23 * 50).abs() <= 64).double().mean()
    assert 0.93 < float(near) < 0.99  # 96 % in the window, 4 % stragglers


def test_default_outputs_do_not_overwrite_the_tpu_records():
    for module, record in ((ds_study, "results/ds_study.jsonl"),
                           (probe_ds_speed, "results/probe_ds_speed.json")):
        stem, ext = os.path.splitext(record)
        assert module.DEFAULT_OUT == f"{stem}_torch{ext}"
