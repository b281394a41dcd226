"""The ray mesh across processes: N ranks against one, on N GPUs or N CPU processes.

Run from the repo root::

    python tools/mesh_ranks.py [--ranks 4] [--device cuda|cpu] [--iters 10] [--cases 5,6]

With ``--device cuda`` it needs one GPU a rank (a host with N cards); the
ranks join a NCCL group over ``localhost``.  With ``--device cpu`` the ranks
are CPU processes joined by gloo, at small sizes: a rehearsal of the same
program.  This process first runs every case (or those of ``--cases``) on a
mesh of one rank (no process group), then starts the ranks, which run them
on the mesh of N and compare on rank 0:

1. the bench scene (128^3 f32, 2^18 rays; CPU: 17^3, 4,096 rays) through
   ``parallel.make_sharded_trace`` and ``make_sharded_trace_exact``: outputs
   bitwise equal to one rank's, the gradient within 1e-5 of its largest
   entry (one rank sums its splats in another order than N ranks and an
   ``all_reduce``);
2. ``configs/params-fuel.yaml`` ``fuel-128``'s mesh path in f64 at a small
   size (stages [3, 5, 9], 2 views of 8^2 x 4 spp, escalation forced at
   stage 1 so that the exact path runs): loss history and field within 1e-9;
3. (GPU only) ``fuel-128`` at full width through ``runner.run`` (2,097,152
   rays, seven stages to 129^3, f32), ``--iters`` a stage: ms a step per
   stage, the loss and ``reconstruction_error`` of N ranks beside one's;
4. the sharded variants ``parallel.make_sharded_trace_{plane,target,sdf,
   cable}``, plain and exact, on configuration 9's and 11's scene (the bench
   scene with planes at y = 0.6 span, targets at y = 1.05 span and 2^18 rays
   spawned on a sphere sdf; CPU: 17^3, 4,096 rays) and configuration 7's
   cable (129 bins, 8,192 rays; CPU: 17 bins, 512): the plane, the exact
   plane, the exact target (its global horizon), the exact sdf (one chunk a
   shard), the cable and the exact cable bitwise against one rank,
   gradients within 1e-5; the plain target and sdf, whose horizon is each
   shard's own, bitwise on each rank's rows against the unsharded call on
   that rank's shard, and the count of rays whose ``d2`` differs from the
   whole batch's (the plain target must have some);
5. the z-slab ring ``parallel.make_slab_trace_zsharded`` on configuration 14
   (the bench field at 1025^3 f32, z-crossing rays, 2^18 of them; CPU:
   17^3, 4,096): each rank builds only its own rows of ``pad_rif_z`` on its
   device; outputs bitwise against one card's ``api.trace``, each rank's
   rows of the gradient within 1e-5 of that gradient's largest entry; each
   rank's peak memory during forward + backward under 6 times its slab's
   bytes; rank 0's K21 / K22 launches (as the wrappers count them); ms
   forward + backward beside ``make_sharded_trace``'s (the grid replicated)
   on the same rays, cold and warm (the ring warm once with each launch
   timed, for each rank's kernel time, then ``SLAB_REPS`` times untimed),
   and the time of one hop of a slab-sized buffer and of its ``all_reduce``;
6. the twin of ``__graft_entry__.dryrun_multichip``: one training step on a
   9^3 grid (8 rays a rank): the sharded trace, the loss, the all-reduced
   gradient and the port's Adam update; the gradient within 1e-5 of one
   card's ``api.trace`` gradient's largest entry, and the slab ring's
   gradient (each rank its rows of ``pad_rif_z``) within 1e-4.

Prints the card (GPU) and, from rank 0, one JSON line; exits non-zero if a
check fails or a rank does.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from adjointnonlinearraytracing_tpu_torch import parallel, tracer  # noqa: E402
from adjointnonlinearraytracing_tpu_torch.benchmarks import scenes  # noqa: E402
from adjointnonlinearraytracing_tpu_torch.benchmarks.scenes import build_case  # noqa: E402
from adjointnonlinearraytracing_tpu_torch.experiments import fiber, fuel_injection  # noqa: E402
from adjointnonlinearraytracing_tpu_torch.experiments import runner, voxel_scenes  # noqa: E402
from adjointnonlinearraytracing_tpu_torch.fields import sdf_utils  # noqa: E402
from adjointnonlinearraytracing_tpu_torch.fields.cylinder import (  # noqa: E402
    CylinderField, cyl_eval_grad)
from adjointnonlinearraytracing_tpu_torch.kernels import wrappers as K  # noqa: E402
from adjointnonlinearraytracing_tpu_torch.opt import adam_init, adam_update  # noqa: E402

FUEL_YAML = str(ROOT / "configs" / "params-fuel.yaml")
FIBER_YAML = str(ROOT / "configs" / "params-fiber.yaml")
TOL_F32_GRAD, TOL_F64 = 1e-5, 1e-9
#: case 5: the grid's side on the card and on the CPU
SLAB_RES = {"cuda": 1025, "cpu": 17}
#: case 5: the warm rings timed with no launch timed
SLAB_REPS = 3
#: case 6: the dry run's bars, those of __graft_entry__.dryrun_multichip
TOL_DRYRUN, TOL_DRYRUN_SLAB = 1e-5, 1e-4
CASES = (1, 2, 3, 4, 5, 6)


def bench(device):
    """Both sharded traces on the bench scene over this process's mesh: the
    outputs and the gradient of the bench loss, as numpy."""
    res, n = (128, 1 << 18) if device == "cuda" else (17, 4096)
    rif, x, v, span = build_case(res, n, device=device)
    h = span / (res - 1)
    target = torch.tensor([span / 2, 1.1 * span, span / 2], dtype=rif.dtype, device=rif.device)
    mesh = parallel.make_ray_mesh()
    out = {}
    for name, make in (("trace", parallel.make_sharded_trace),
                       ("exact", parallel.make_sharded_trace_exact)):
        r = rif.clone().requires_grad_(True)
        xt, vt = make(mesh, h, h / 2, res)(r, x, v)
        (((xt - target) ** 2).sum() + vt.sum()).backward()
        for key, t in zip(("xt", "vt", "g"), (xt, vt, r.grad)):
            out[f"{name}_{key}"] = t.detach().cpu().numpy()
    return out


def fuel_small(device):
    """``fuel-128``'s mesh path in f64 at a small size, the escalation forced
    at stage 1: the loss history and the final field."""
    params = dict(runner.cfg.load_params(FUEL_YAML, "fuel-128"), res_list=[3, 5, 9], nviews=2,
                  nbins=8, optim_iters=3, dtype="float64")
    rays, _ = fuel_injection.gen_start_rays(params, torch.Generator().manual_seed(0),
                                            torch.float64)
    gt = voxel_scenes.fuel_injection_rif(params["fuel_val"], torch.float64, "cpu")
    os.environ["ANRT_EXACT_TOL"] = "-1"
    try:
        eta, hist, _ = fuel_injection.run_opt(params, None, gt, rays=rays, device=device)
    finally:
        del os.environ["ANRT_EXACT_TOL"]
    return {"small_eta": eta.cpu().numpy(), "small_hist": np.asarray(hist)}


def fuel_full(iters):
    """``fuel-128`` at full width through the runner on the card: seconds, the
    median ms a step per stage, the loss and the reconstruction error."""
    params = runner.cfg.load_params(FUEL_YAML, "fuel-128")
    rows = []
    t0 = time.time()
    eta, hist, gt = runner.run(FUEL_YAML, "fuel-128", overrides=dict(optim_iters=iters),
                               device="cuda", stat_fn=lambda it, loss, secs: rows.append(secs))
    torch.cuda.synchronize()
    seconds = time.time() - t0
    stage_ms, first = {}, 0
    for s, res in enumerate(params["res_list"]):
        ms = sorted(1e3 * t for t in rows[first:first + iters * (s + 1)])
        first += iters * (s + 1)
        stage_ms[f"{res}^3"] = ms[len(ms) // 2]
    err = fuel_injection.reconstruction_error(eta, gt, background=1.0 + params["fuel_val"])
    return dict(seconds=seconds, steps=len(hist), stage_ms=stage_ms, loss_first=float(hist[0]),
                loss_last=float(hist[-1]), **err)


def _sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


def _timed(device, fn, events=None):
    """Host ms of ``fn()`` between two synchronises; with ``events`` (a list)
    every kernel launch in it is timed into that list (CUDA events)."""
    K.record_events(events)
    try:
        _sync(device)
        t0 = time.time()
        fn()
        _sync(device)
    finally:
        K.record_events(None)
    return 1e3 * (time.time() - t0)


def _kernel_ms(events):
    return sum(a.elapsed_time(b) for _, a, b in events)


def variant_scene(device):
    """Configuration 9's and 11's scene (case 4) and configuration 7's cable."""
    res, n = (128, 1 << 18) if device == "cuda" else (17, 4096)
    rif, x, v, span = build_case(res, n, device=device)
    h = span / (res - 1)

    def per_ray(vec):
        return torch.tensor(vec, dtype=rif.dtype, device=device).expand(n, 3).contiguous()

    idx = torch.arange(res, dtype=torch.float64, device=device) * h
    z, y, xx = torch.meshgrid(idx, idx, idx, indexing="ij")
    c = span / 2
    sdf = ((torch.sqrt((xx - c) ** 2 + (y - c) ** 2 + (z - c) ** 2) - 0.4 * span) / h)
    sdf = sdf.to(rif.dtype).contiguous()
    xs, vs = sdf_utils.get_pts_sdf(torch.Generator(device=device).manual_seed(3), sdf, n, span)
    params = runner.cfg.load_params(FIBER_YAML)
    bins = params["res_list"][-1] if device == "cuda" else 17
    gen = torch.Generator(device=device).manual_seed(0)
    rays = fiber.gen_start_rays(params, gen, torch.float32)
    cx, cv, planes = rays.x, rays.v, rays.planes
    if device != "cuda":
        cx, cv, planes = cx[:256], cv[:256], planes[:256]
    prof = fiber.ground_truth(bins, torch.float32, device) + 0.01 * torch.rand(
        bins, generator=gen, dtype=torch.float32, device=device)
    radius, length = params["cable_radius"], params["cable_length"]
    cv = cv / cyl_eval_grad(CylinderField(prof, radius, length), cx)[0][:, None]
    hop = params.get("hop_distance", 3.14)
    ct = torch.cat([planes[:, 0], planes[:, 0] + hop * planes[:, 1]])
    return dict(rif=rif, x=x, v=v, h=h, ds=h / 2, res=res, span=span, o=per_ray([0, 0.6 * span, 0]),
                d=per_ray([0, 1.0, 0]), tgt=per_ray([span / 2, 1.05 * span, span / 2]),
                sdf=sdf, xs=xs.contiguous(), vs=vs.contiguous(), prof=prof,
                cx=torch.cat([cx, cx]).contiguous(), cv=torch.cat([cv, cv]).contiguous(),
                ct=ct.contiguous(), radius=radius, length=length, cds=radius / bins / 2)


VARIANT_NAMES = [f"{b}_{m}" for b in ("plane", "target", "sdf", "cable")
                 for m in ("plain", "exact")]


def variants(device):
    """Case 4 on this process's mesh: every sharded variant's outputs and the gradient
    of ``sum((xt - aim)^2) + sum(vt)``; on N ranks also whether each rank's
    rows of the plain target and sdf equal the unsharded call on its shard."""
    s = variant_scene(device)
    mesh = parallel.make_ray_mesh()
    h, ds, res = s["h"], s["ds"], s["res"]
    centre = torch.full((3,), s["span"] / 2, dtype=s["rif"].dtype, device=device)
    out = {}
    for name in VARIANT_NAMES:
        kind, mode = name.split("_")
        ex = mode == "exact"
        if kind == "cable":
            f = parallel.make_sharded_trace_cable(mesh, s["radius"], s["length"], s["cds"],
                                                  exact=ex)
            field, args, aim = s["prof"], (s["cx"], s["cv"], s["ct"]), s["ct"]
        else:
            f = getattr(parallel, f"make_sharded_trace_{kind}")(mesh, h, ds, res, exact=ex)
            field = s["rif"]
            args, aim = {"plane": ((s["x"], s["v"], s["o"], s["d"]), s["tgt"]),
                         "target": ((s["x"], s["v"], s["tgt"]), s["tgt"]),
                         "sdf": ((s["sdf"], s["xs"], s["vs"]), centre)}[kind]
        r = field.clone().requires_grad_(True)
        _sync(device)
        t0 = time.time()
        res_ = f(r, *args)
        (((res_[0] - aim) ** 2).sum() + res_[1].sum()).backward()
        _sync(device)
        out[f"{name}_ms"] = np.array(1e3 * (time.time() - t0))
        for k, t in enumerate(res_):
            out[f"{name}_{k}"] = t.detach().cpu().numpy()
        out[f"{name}_g"] = r.grad.cpu().numpy()
    own = []
    for name, n, call in (
            ("target_plain", s["x"].shape[0],
             lambda sl: tracer.trace_target(s["rif"], s["x"][sl], s["v"][sl], s["tgt"][sl], h,
                                            ds)),
            ("sdf_plain", s["xs"].shape[0],
             lambda sl: tracer.trace_sdf(s["rif"], s["sdf"], s["xs"][sl], s["vs"][sl], h, ds))):
        sl = mesh.shard(n)
        own.append(all(torch.equal(torch.from_numpy(out[f"{name}_{k}"][sl]), t.cpu())
                       for k, t in enumerate(call(sl))))
    out["own_shard_equal"] = mesh.all_gather(
        torch.tensor([own], dtype=torch.int32, device=device)).cpu().numpy()
    return out


def slab_case(device, ref):
    """Case 5: on one rank (``ref`` None) one card's ``api.trace`` at full
    width, the reference, written beside ``ref``; on N ranks the slab ring
    (each rank its own rows of ``pad_rif_z``) and then the replicated
    ``make_sharded_trace`` on the same rays."""
    res = SLAB_RES[device]
    n = (1 << 18) if device == "cuda" else 4096
    span = 20.0
    h = span / (res - 1)
    ds = h / 2
    x, v = scenes.z_rays(res, n, span, "float32", device=device)
    centre = torch.full((3,), span / 2, dtype=torch.float32, device=device)
    mesh = parallel.make_ray_mesh()

    def loss(xt, vt):
        return ((xt - centre) ** 2).sum() + vt.sum()

    out = {}
    if mesh.world_size == 1:
        r = scenes.bench_rows(res, 0, res, span, "float32", device).requires_grad_(True)
        _sync(device)
        t0 = time.time()
        xt, vt = tracer.trace(r, x, v, h, ds)
        loss(xt, vt).backward()
        _sync(device)
        out.update(slab_xt=xt.detach().cpu().numpy(), slab_vt=vt.detach().cpu().numpy(),
                   slab_api_ms=np.array(1e3 * (time.time() - t0)),
                   slab_g_max=np.array(float(r.grad.abs().max())))
        return out, r.grad.cpu().numpy()
    S = parallel.slab_rows(res + 1, mesh.world_size)
    rows = scenes.bench_rows(res, mesh.rank * S, (mesh.rank + 1) * S, span, "float32",
                             device).requires_grad_(True)
    f = parallel.make_slab_trace_zsharded(mesh, h, ds, res)
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    _sync(device)
    t0 = time.time()
    xt, vt = f(rows, x, v)
    loss(xt, vt).backward()
    _sync(device)
    out["slab_ms"] = np.array(1e3 * (time.time() - t0))
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    slab_bytes = (S + 1) * res * res * 4
    # this rank's rows of the reference gradient (the padded rows fold into the last plane)
    g_ref = np.load(ref + "_slab_g.npy", mmap_mode="r")
    lo, hi = mesh.rank * S, min((mesh.rank + 1) * S, res)
    g = rows.grad.detach()
    if hi > lo:
        mine = g[:hi - lo].clone()
        if hi == res:
            mine[-1] += g[hi - lo:].sum(dim=0)
        err = float(np.abs(mine.cpu().numpy() - g_ref[lo:hi]).max())
    else:
        err = 0.0
    stats = torch.tensor([[err, float(peak), float(peak) / slab_bytes]], dtype=torch.float64,
                         device=device)
    out["slab_rank_err_peak"] = mesh.all_gather(stats).cpu().numpy()
    out.update(slab_xt=xt.detach().cpu().numpy(), slab_vt=vt.detach().cpu().numpy(),
               slab_phases=np.array([f.ring.phases_run["fwd"], f.ring.phases_run["bwd"]]),
               slab_launches=np.array([K.LAUNCHES[k] for k in ("slab_trace_phase",
                                                               "slab_backtrace_phase")]),
               slab_bytes=np.array(slab_bytes))
    del g, xt, vt

    def ring():
        rows.grad = None
        loss(*f(rows, x, v)).backward()

    # where the time goes: the ring again (warm), its kernels' share, and one
    # hop of a slab-sized buffer round the ring and an all_reduce of it alone
    ring_events = []
    warm = _timed(device, ring, ring_events)
    untimed = [_timed(device, ring) for _ in range(SLAB_REPS)]
    rows = None
    buf = torch.zeros(slab_bytes // 4, dtype=torch.float32, device=device)
    mesh.shift(buf)
    hop = sorted(_timed(device, lambda: mesh.shift(buf)) for _ in range(3))[1]
    mesh.all_reduce(buf)
    reduce_ms = sorted(_timed(device, lambda: mesh.all_reduce(buf)) for _ in range(3))[1]
    del buf
    if device == "cuda":
        torch.cuda.empty_cache()
    r = scenes.bench_rows(res, 0, res, span, "float32", device).requires_grad_(True)
    rep = parallel.make_sharded_trace(mesh, h, ds, res)

    def replicated():
        r.grad = None
        loss(*rep(r, x, v)).backward()

    out["slab_replicated_ms"] = np.array(_timed(device, replicated))
    rep_events = []
    rep_warm = _timed(device, replicated, rep_events)
    times = torch.tensor([[warm, _kernel_ms(ring_events), hop, reduce_ms, rep_warm,
                           _kernel_ms(rep_events), *untimed]], dtype=torch.float64,
                         device=device)
    out["slab_times"] = mesh.all_gather(times).cpu().numpy()
    return out, None


def dryrun(device, ranks):
    """Case 6: one sharded training step on a 9^3 grid, 8 rays a rank; on one
    rank the reference gradient of ``api.trace``."""
    res, span = 9, 20.0
    rif, x, v, _ = build_case(res=res, nrays=8 * ranks, span=span, device=device)
    h = span / (res - 1)
    ds = h / 2
    target = torch.tensor([span / 2, span + 1.0, span / 2], dtype=rif.dtype, device=device)
    mesh = parallel.make_ray_mesh()

    def grad_of(trace, field):
        r = field.clone().requires_grad_(True)
        xt, vt = trace(r)
        loss = ((xt - target) ** 2).sum() / x.shape[0]
        loss.backward()
        return loss, r.grad

    if mesh.world_size == 1:
        loss, g = grad_of(lambda r: tracer.trace(r, x, v, h, ds), rif)
        return {"dry_g_single": g.cpu().numpy(), "dry_loss_single": np.array(float(loss.detach()))}
    traced = parallel.make_sharded_trace(mesh, h, ds, res)
    loss, g = grad_of(lambda r: traced(r, x, v), rif)
    new, state = adam_update(rif, g, adam_init(rif), 1e-2)
    new = torch.clamp(new, min=1.0)
    S = parallel.slab_rows(res + 1, mesh.world_size)
    slab = parallel.make_slab_trace_zsharded(mesh, h, ds, res)
    r = rif.clone().requires_grad_(True)
    rows = parallel.pad_rif_z(r, mesh.world_size)[mesh.rank * S:(mesh.rank + 1) * S]
    xt, vt = slab(rows, x, v)
    (((xt - target) ** 2).sum() / x.shape[0]).backward()
    return {"dry_g_mesh": g.cpu().numpy(), "dry_loss": np.array(float(loss.detach())),
            "dry_step_finite": np.array(bool(torch.isfinite(new).all()) and state.count == 1),
            "dry_g_slab": mesh.all_reduce(r.grad).cpu().numpy()}


def run_cases(device, iters, ranks, ref=None, cases=CASES):
    """The ``cases`` on this process's mesh; ``ref``: where the one-rank run
    leaves what the ranks read (case 5's reference gradient)."""
    out, full = {}, None
    if 1 in cases:
        out.update(bench(device))
    if 2 in cases:
        out.update(fuel_small(device))
    if 3 in cases and device == "cuda":
        full = fuel_full(iters)
    if 4 in cases:
        out.update(variants(device))
    if 5 in cases:
        slab, g_ref = slab_case(device, ref)
        out.update(slab)
        if g_ref is not None:
            np.save(ref + "_slab_g.npy", g_ref)
            del g_ref
    if 6 in cases:
        out.update(dryrun(device, ranks))
    return out, full


def compare_variants(many, one, on_card):
    """Case 4's checks: the sharded variants that stop a ray at its own escape, or take
    the global horizon, bitwise; the plain target and sdf per shard, and (on
    the card's 128^3 scene; the CPU's 17^3 has too few steps) some plain
    target ray whose ``d2`` differs from the whole batch's."""
    rec, failures = {}, []
    for name in VARIANT_NAMES:
        keys = sorted(k for k in one if k.startswith(name + "_") and k[len(name) + 1:].isdigit())
        bitwise = all(np.array_equal(many[k], one[k]) for k in keys)
        g, g1 = many[f"{name}_g"], one[f"{name}_g"]
        err = float(np.abs(g - g1).max() / np.abs(g1).max())
        rec[name] = dict(bitwise=bitwise, grad_rel_err=err, ms=float(many[f"{name}_ms"]),
                         one_rank_ms=float(one[f"{name}_ms"]))
        if name in ("target_plain", "sdf_plain"):
            continue
        if not bitwise or not err <= TOL_F32_GRAD:
            failures.append(f"{name}: bitwise {bitwise}, gradient {err:.3e}")
    d2_differs = int((many["target_plain_2"] != one["target_plain_2"]).sum())
    rec["target_plain"]["d2_differs_from_whole_batch"] = d2_differs
    rec["own_shard_equal"] = many["own_shard_equal"].tolist()
    if not many["own_shard_equal"].all():
        failures.append(f"plain target/sdf: a rank's rows differ from the unsharded call on its "
                        f"shard: {rec['own_shard_equal']}")
    if on_card and d2_differs == 0:
        failures.append("plain target: no ray's d2 differs from the whole batch's: the "
                        "per-shard horizon did not show")
    return rec, failures


def compare_slab(many, one):
    """Case 5's checks (rank 0, with every rank's error and peak gathered)."""
    per_rank = many["slab_rank_err_peak"]
    err = float(per_rank[:, 0].max() / float(one["slab_g_max"]))
    bitwise = bool(np.array_equal(many["slab_xt"], one["slab_xt"])
                   and np.array_equal(many["slab_vt"], one["slab_vt"]))
    t = many["slab_times"]  # a row a rank
    rec = dict(bitwise=bitwise, grad_rel_err=err, ms=float(many["slab_ms"]),
               replicated_ms=float(many["slab_replicated_ms"]),
               warm={k: [float(a) for a in t[:, c]] for c, k in enumerate(
                   ("ring_ms", "ring_kernels_ms", "one_hop_ms", "all_reduce_ms",
                    "replicated_ms", "replicated_kernels_ms"))},
               ring_untimed_ms=t[:, 6:].tolist(),
               one_card_api_trace_ms=float(one["slab_api_ms"]),
               phases=many["slab_phases"].tolist(), launches=many["slab_launches"].tolist(),
               slab_gb=float(many["slab_bytes"]) / 1e9,
               peak_gb=[float(p) / 1e9 for p in per_rank[:, 1]],
               peak_over_slab=[float(p) for p in per_rank[:, 2]])
    failures = []
    if not bitwise or not err <= TOL_F32_GRAD:
        failures.append(f"slab ring: bitwise {bitwise}, gradient {err:.3e}")
    if any(p > 0 and p >= 6.0 for p in rec["peak_over_slab"]):
        failures.append(f"slab ring: a rank's peak memory is 6 slabs or more: "
                        f"{rec['peak_over_slab']}")
    return rec, failures


def compare_dryrun(many, one):
    g1 = one["dry_g_single"]
    scale = float(np.abs(g1).max())
    err = float(np.abs(many["dry_g_mesh"] - g1).max() / scale)
    err_slab = float(np.abs(many["dry_g_slab"] - g1).max() / scale)
    rec = dict(grad_rel_err=err, slab_grad_rel_err=err_slab, loss=float(many["dry_loss"]),
               loss_one=float(one["dry_loss_single"]), step_finite=bool(many["dry_step_finite"]))
    failures = []
    if not (err <= TOL_DRYRUN and err_slab <= TOL_DRYRUN_SLAB and rec["step_finite"]
            and scale > 0):
        failures.append(f"dry run: {rec}")
    return rec, failures


def compare(many, one, full_many, full_one, cases=CASES, on_card=True):
    """Rank 0's checks of the mesh of N against the mesh of one, for ``cases``."""
    rec, failures = {}, []
    for name in ("trace", "exact") if 1 in cases else ():
        bitwise = all(np.array_equal(many[f"{name}_{k}"], one[f"{name}_{k}"]) for k in ("xt", "vt"))
        g, g1 = many[f"{name}_g"], one[f"{name}_g"]
        err = float(np.abs(g - g1).max() / np.abs(g1).max())
        rec[name] = dict(bitwise=bitwise, grad_rel_err=err)
        if not bitwise or not err <= TOL_F32_GRAD:
            failures.append(f"{name}: bitwise {bitwise}, gradient {err:.3e}")
    if 2 in cases:
        hist_err = float(np.max(np.abs(many["small_hist"] - one["small_hist"])
                                / np.abs(one["small_hist"])))
        scale = float(np.abs(one["small_eta"] - one["small_eta"].flat[0]).max())
        eta_err = float(np.abs(many["small_eta"] - one["small_eta"]).max() / scale)
        rec["fuel128_small"] = dict(hist_rel_err=hist_err, eta_err=eta_err)
        if not (hist_err <= TOL_F64 and eta_err <= TOL_F64 and scale > 0):
            failures.append(f"fuel-128 small: loss history {hist_err:.3e}, field "
                            f"{eta_err:.3e}")
    if full_many is not None:
        rec["fuel128"] = dict(ranks=full_many, one_rank=full_one)
        if full_many["steps"] != full_one["steps"] or not full_many["loss_last"] < \
                full_many["loss_first"]:
            failures.append("fuel-128 at full width: steps lost or the loss did not fall")
    for case, key, check in ((4, "variants", lambda a, b: compare_variants(a, b, on_card)),
                             (5, "slab", compare_slab), (6, "dryrun", compare_dryrun)):
        if case in cases:
            rec[key], more = check(many, one)
            failures += more
    return rec, failures


def worker(rank, ranks, port, device, iters, ref_path, cases):
    backend = "nccl" if device == "cuda" else "gloo"
    parallel.initialize(f"localhost:{port}", ranks, rank, backend=backend)
    try:
        mesh = parallel.make_ray_mesh()
        if (mesh.world_size, mesh.rank) != (ranks, rank):
            raise AssertionError(f"rank {rank}: the mesh is {mesh}")
        many, full_many = run_cases(device, iters, ranks, ref_path, cases)
    finally:
        torch.distributed.destroy_process_group()
    if rank == 0:
        ref = np.load(ref_path + ".npz")
        with open(ref_path + ".json") as f:
            full_one = json.load(f)
        rec, failures = compare(many, ref, full_many, full_one, cases, device == "cuda")
        print(json.dumps(dict(ranks=ranks, backend=backend, failures=failures, **rec)), flush=True)
        if failures:
            sys.exit(1)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--iters", type=int, default=10, help="fuel-128's iterations a stage")
    ap.add_argument("--cases", default=",".join(map(str, CASES)),
                    help="the cases to run, as 5,6 (default: all)")
    ap.add_argument("--worker", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--ref", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    cases = tuple(int(c) for c in args.cases.split(","))
    if not set(cases) <= set(CASES):
        ap.error(f"--cases: each of {CASES}, got {args.cases}")
    if args.worker is not None:
        worker(args.worker, args.ranks, args.port, args.device, args.iters, args.ref, cases)
        return
    if args.device == "cuda":
        if torch.cuda.device_count() < args.ranks:
            sys.exit(f"mesh_ranks: {args.ranks} ranks need {args.ranks} GPUs, "
                     f"found {torch.cuda.device_count()}")
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()
        print("devices: " + "; ".join(card), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        ref = os.path.join(tmp, "one_rank")
        one, full_one = run_cases(args.device, args.iters, args.ranks, ref, cases)
        if args.device == "cuda":
            torch.cuda.empty_cache()  # rank 0 shares this process's card
        np.savez(ref + ".npz", **one)
        with open(ref + ".json", "w") as f:
            json.dump(full_one, f)
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        procs = [subprocess.Popen([sys.executable, __file__, "--worker", str(r), "--ranks",
                                   str(args.ranks), "--port", str(port), "--device", args.device,
                                   "--iters", str(args.iters), "--ref", ref, "--cases",
                                   args.cases])
                 for r in range(args.ranks)]
        try:
            codes = [p.wait(timeout=1200) for p in procs]
        finally:
            for p in procs:
                p.kill()
    if any(codes):
        sys.exit(f"mesh_ranks: the ranks exited with {codes}")


if __name__ == "__main__":
    main()
