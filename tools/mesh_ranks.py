"""The ray mesh across processes: N ranks against one, on N GPUs or N CPU processes.

Run from the repo root::

    python tools/mesh_ranks.py [--ranks 4] [--device cuda|cpu] [--iters 10]

With ``--device cuda`` it needs one GPU a rank (a host with N cards); the
ranks join a NCCL group over ``localhost``.  With ``--device cpu`` the ranks
are CPU processes joined by gloo, at small sizes: a rehearsal of the same
program.  This process first runs every case on a mesh of one rank (no
process group), then starts the ranks, which run them on the mesh of N and
compare on rank 0:

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
   stage, the loss and ``reconstruction_error`` of N ranks beside one's.

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

from adjointnonlinearraytracing_tpu_torch import parallel  # noqa: E402
from adjointnonlinearraytracing_tpu_torch.benchmarks.scenes import build_case  # noqa: E402
from adjointnonlinearraytracing_tpu_torch.experiments import fuel_injection  # noqa: E402
from adjointnonlinearraytracing_tpu_torch.experiments import runner, voxel_scenes  # noqa: E402

FUEL_YAML = str(ROOT / "configs" / "params-fuel.yaml")
TOL_F32_GRAD, TOL_F64 = 1e-5, 1e-9


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


def run_cases(device, iters):
    out = {**bench(device), **fuel_small(device)}
    full = fuel_full(iters) if device == "cuda" else None
    return out, full


def compare(many, one, full_many, full_one):
    """Rank 0's checks of the mesh of N against the mesh of one."""
    rec, failures = {}, []
    for name in ("trace", "exact"):
        bitwise = all(np.array_equal(many[f"{name}_{k}"], one[f"{name}_{k}"]) for k in ("xt", "vt"))
        g, g1 = many[f"{name}_g"], one[f"{name}_g"]
        err = float(np.abs(g - g1).max() / np.abs(g1).max())
        rec[name] = dict(bitwise=bitwise, grad_rel_err=err)
        if not bitwise or not err <= TOL_F32_GRAD:
            failures.append(f"{name}: bitwise {bitwise}, gradient {err:.3e}")
    hist_err = float(np.max(np.abs(many["small_hist"] - one["small_hist"])
                            / np.abs(one["small_hist"])))
    scale = float(np.abs(one["small_eta"] - one["small_eta"].flat[0]).max())
    eta_err = float(np.abs(many["small_eta"] - one["small_eta"]).max() / scale)
    rec["fuel128_small"] = dict(hist_rel_err=hist_err, eta_err=eta_err)
    if not (hist_err <= TOL_F64 and eta_err <= TOL_F64 and scale > 0):
        failures.append(f"fuel-128 small: loss history {hist_err:.3e}, field {eta_err:.3e}")
    if full_many is not None:
        rec["fuel128"] = dict(ranks=full_many, one_rank=full_one)
        if full_many["steps"] != full_one["steps"] or not full_many["loss_last"] < \
                full_many["loss_first"]:
            failures.append("fuel-128 at full width: steps lost or the loss did not fall")
    return rec, failures


def worker(rank, ranks, port, device, iters, ref_path):
    backend = "nccl" if device == "cuda" else "gloo"
    parallel.initialize(f"localhost:{port}", ranks, rank, backend=backend)
    try:
        mesh = parallel.make_ray_mesh()
        if (mesh.world_size, mesh.rank) != (ranks, rank):
            raise AssertionError(f"rank {rank}: the mesh is {mesh}")
        many, full_many = run_cases(device, iters)
    finally:
        torch.distributed.destroy_process_group()
    if rank == 0:
        ref = np.load(ref_path + ".npz")
        with open(ref_path + ".json") as f:
            full_one = json.load(f)
        rec, failures = compare(many, ref, full_many, full_one)
        print(json.dumps(dict(ranks=ranks, backend=backend, failures=failures, **rec)), flush=True)
        if failures:
            sys.exit(1)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--iters", type=int, default=10, help="fuel-128's iterations a stage")
    ap.add_argument("--worker", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--ref", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker is not None:
        worker(args.worker, args.ranks, args.port, args.device, args.iters, args.ref)
        return
    if args.device == "cuda":
        if torch.cuda.device_count() < args.ranks:
            sys.exit(f"mesh_ranks: {args.ranks} ranks need {args.ranks} GPUs, "
                     f"found {torch.cuda.device_count()}")
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()
        print("devices: " + "; ".join(card), flush=True)
    one, full_one = run_cases(args.device, args.iters)
    with tempfile.TemporaryDirectory() as tmp:
        ref = os.path.join(tmp, "one_rank")
        np.savez(ref + ".npz", **one)
        with open(ref + ".json", "w") as f:
            json.dump(full_one, f)
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        procs = [subprocess.Popen([sys.executable, __file__, "--worker", str(r), "--ranks",
                                   str(args.ranks), "--port", str(port), "--device", args.device,
                                   "--iters", str(args.iters), "--ref", ref])
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
