"""Times the variants' forward and backward kernels of a checkout, for an A/B on one card.

Run from any directory on a machine with a CUDA device and ``nvcc``::

    python tools/exact_ab.py [--root DIR] [--rounds N] [--reps N] [--out FILE]

It imports ``chip_smoke`` and the port from the checkout at ``DIR`` (this
script's own by default), builds that checkout's kernels, and on
configuration 11's batches (``chip_smoke.variant_scene``: the bench scene,
128^3 f32, 2^18 rays, ``seg`` 32) times, with ``chip_smoke.time_ms`` on a
warm card, round after round, K18 ``backtrace_plane_exact``, K6
``backtrace_exact`` on the target's states and K19 ``backtrace_sdf_exact``,
each from the checkpoints its forward kernel wrote (as ``trace_*_exact``
launches them), K15 ``trace_plane_ckpt``, K16 ``trace_target_ckpt`` and
K17 ``trace_sdf_ckpt`` (as ``chip_smoke.exact_forward_kernel`` calls them;
K16's and K17's pass 1, the gap and pass 2 apart by
``chip_smoke.pass_split``), K11 ``trace_plane`` and K12 ``trace_target``
(as ``compat.BackPlaneTracerC`` and ``BackTargetTracerC`` launch them; K12's
passes apart), K13 ``trace_sdf`` and K14 ``backtrace_sdf`` on the sdf batch
(as ``compat.BackSDFTracerC`` launches them; K13's passes apart), K2
``trace_fwd``, K5 ``trace_ckpt`` and K3 ``backtrace`` on the bench scene, and
K20 ``record_paths`` on ``combo_recon16_true``'s 524,288 f64 rays in the
caller's order (the L2 flushed before each call, as ``chip_smoke.py`` times
it).  Then it times, on
the host clock after a warm-up call, the three ``compat`` tracers and
``tracer.trace_{plane,target,sdf}_exact`` forward and backward on 2^18 and
2^20 rays (the exact ones in four chunks of ``ANRT_EXACT_CHUNK``'s default
at 2^20, each recomputing its checkpoints).  It uses only functions of
``chip_smoke`` and signatures of the wrappers that checkouts since K17
took its horizons in the kernel have too, so that one call can run a parent and a change in turn (parent,
change, change, parent).  Prints the card and one JSON line.  No path of
the port runs it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None, help="also write the JSON line to this file")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch

    import chip_smoke as CS  # exits without a CUDA device
    from adjointnonlinearraytracing_tpu_torch import compat, tracer
    from adjointnonlinearraytracing_tpu_torch.experiments import voxel_scenes
    from adjointnonlinearraytracing_tpu_torch.pathmatrix import fuel2008
    from adjointnonlinearraytracing_tpu_torch.fields import grid as G
    from adjointnonlinearraytracing_tpu_torch.kernels import build
    from adjointnonlinearraytracing_tpu_torch.kernels import wrappers as K
    from adjointnonlinearraytracing_tpu_torch.tracer import order as O

    if Path(CS.__file__).resolve().parent != root:
        raise RuntimeError(f"chip_smoke came from {CS.__file__}, not from {root}")
    for name in build.KERNELS:
        build.load(name)
    s = CS.variant_scene(CS.RES, CS.NRAYS, "float32")
    kernels = {"plane": "backtrace_plane_exact", "target": "backtrace_exact",
               "sdf": "backtrace_sdf_exact"}
    runs, passes = {}, {}
    for variant, name in kernels.items():
        case = CS.exact_case(s, variant)
        order = O.ray_order(case["x"], case["v"], case["rif"].shape, case["h"])
        got, c, code, ck, _ = CS.exact_forward_kernel(case, order, True)
        dx, dv = 2.0 * (got[0] - case["anchor"]), torch.ones_like(got[1])
        if variant == "plane":  # the missed rays pass no gradient
            hit = ~got[2]
            dx = torch.where(hit[:, None], dx, torch.zeros_like(dx))
            dv = torch.where(hit[:, None], dv, torch.zeros_like(dv))
        acc = torch.float64 if variant == "sdf" else case["rif"].dtype
        numel = case["rif"].numel()

        def run(case=case, ck=ck, c=c, code=code, dx=dx, dv=dv, order=order, acc=acc,
                numel=numel):
            out = torch.zeros(numel, dtype=acc, device="cuda")
            CS.exact_backward_kernel(case, ck, c, code, dx, dv, order, out)
            return out

        runs[f"{name} ({variant})"] = run
        fname = {"plane": "trace_plane_ckpt (K15)", "target": "trace_target_ckpt (K16)",
                 "sdf": "trace_sdf_ckpt (K17)"}[variant]
        runs[fname] = (lambda case=case, order=order: CS.exact_forward_kernel(case, order, True))
        if variant != "plane":
            passes[fname] = (fname.split(" ")[0], runs[fname])
        if variant in ("plane", "target"):
            per_ray = (case["o"], case["d"]) if variant == "plane" else (case["tgt"],)
            kname = {"plane": "trace_plane (K11)", "target": "trace_target (K12)"}[variant]
            kernel = K.trace_plane if variant == "plane" else K.trace_target
            runs[kname] = (lambda case=case, order=order, per_ray=per_ray, kernel=kernel: kernel(
                case["rif"], case["h"], case["x"], case["v"], *per_ray, case["ds"], s["nf"],
                order))
            if variant == "target":
                passes[kname] = ("trace_target", runs[kname])
    # K13 and K14 as BackSDFTracerC launches them, K3 on the bench scene
    rif, h, ds, sdf, xs, vs = (s[k] for k in ("rif", "h", "ds", "sdf", "xs", "vs"))
    tol = G.snap_tol(rif.dtype)
    order_s = O.ray_order(xs, vs, rif.shape, h)
    xt, vt = K.trace_sdf(rif, sdf, h, xs, vs, ds, s["ns"], order_s)
    centre = torch.full((3,), s["span"] / 2, dtype=rif.dtype, device="cuda")
    dxs, dvs = (2.0 * (xt - centre)).contiguous(), torch.ones_like(vt)
    runs["trace_sdf (K13)"] = lambda: K.trace_sdf(rif, sdf, h, xs, vs, ds, s["ns"], order_s)
    passes["trace_sdf (K13)"] = ("trace_sdf", runs["trace_sdf (K13)"])
    runs["backtrace_sdf (K14)"] = lambda: K.backtrace_sdf(rif, sdf, h, xt, vt, dxs, dvs, ds,
                                                          s["nb"], tol, order_s)
    order_b = O.ray_order(s["x0"], s["v0"], rif.shape, h)
    xtb, vtb = K.trace_fwd(rif, h, s["x0"], s["v0"], ds, s["nf"], order_b)
    dxb, dvb = (2.0 * (xtb - s["target"])).contiguous(), torch.ones_like(vtb)
    runs["backtrace (K3, bench)"] = lambda: K.backtrace(rif, h, xtb, vtb, dxb, dvb, ds, s["nb"],
                                                        tol, order_b)
    runs["trace_fwd (K2, bench)"] = lambda: K.trace_fwd(rif, h, s["x0"], s["v0"], ds, s["nf"],
                                                        order_b)
    runs["trace_ckpt (K5, bench)"] = lambda: K.trace_ckpt(rif, h, s["x0"], s["v0"], ds, s["nf"],
                                                          CS.SEG, order_b)
    # K20 on combo_recon16_true's rays in the caller's order, as the 2008
    # baseline launches it, L2 flushed before each call as chip_smoke.py times it
    gt = voxel_scenes.fuel_injection_rif(dtype=torch.float64, device="cuda")
    h20 = 1.0 / (gt.shape[0] - 1)
    stride = CS.F2008_TRUE_CONFIG["path_stride"]
    rays = fuel2008.gen_rays(CS.F2008_TRUE_CONFIG, device="cuda")
    x20, v20 = rays.x.contiguous(), rays.v.contiguous()
    nrec, _ = fuel2008.record_steps(gt.shape[0], h20, h20 / 2, stride)
    k20 = "record_paths (K20, combo_recon16_true)"
    runs[k20] = lambda: K.record_paths(gt, h20, x20, v20, h20 / 2, nrec, stride)
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    times = {name: [] for name in runs}
    for _ in range(args.rounds):
        for name, fn in runs.items():
            times[name].append(CS.time_ms(fn, args.reps, flush if name == k20 else None))
    del flush
    ms = {name: sorted(t)[len(t) // 2] for name, t in times.items()}
    passes_ms = {name: CS.pass_split(fn, kernel) for name, (kernel, fn) in passes.items()}
    del runs, passes

    s_big = CS.variant_scene(CS.RES, CS.EXACT_CHUNKED_RAYS, "float32")
    calls = {"trace_plane_exact": lambda r, sc: tracer.trace_plane_exact(
                 r, sc["x0"], sc["v0"], sc["pln_o"][0], sc["pln_d"][0], sc["h"], sc["ds"]),
             "trace_target_exact": lambda r, sc: tracer.trace_target_exact(
                 r, sc["x0"], sc["v0"], sc["tgt"][0], sc["h"], sc["ds"]),
             "trace_sdf_exact": lambda r, sc: tracer.trace_sdf_exact(
                 r, sc["sdf"], sc["xs"], sc["vs"], sc["h"], sc["ds"]),
             "BackSDFTracerC": lambda r, sc: compat.BackSDFTracerC(
                 r, sc["sdf"], sc["xs"], sc["vs"], sc["h"], sc["ds"]),
             "BackPlaneTracerC": lambda r, sc: compat.BackPlaneTracerC(
                 r, sc["x0"], sc["v0"], sc["pln_o"][0], sc["pln_d"][0], sc["h"], sc["ds"]),
             "BackTargetTracerC": lambda r, sc: compat.BackTargetTracerC(
                 r, sc["x0"], sc["v0"], sc["tgt"][0], sc["h"], sc["ds"])}
    big = {}
    for sc, label in ((s, "2^18"), (s_big, "2^20")):
        for name, fn in calls.items():
            variant = next((v for v in ("plane", "target") if v in name.lower()), "sdf")
            anchor = CS.exact_case(sc, variant)["anchor"]
            spans = []
            for _ in range(3):  # a warm-up call, then two timed
                r = sc["rif"].detach().clone().requires_grad_(True)
                torch.cuda.synchronize()
                t0 = time.time()
                out = fn(r, sc)
                (((out[0] - anchor) ** 2).sum() + out[1].sum()).backward()
                torch.cuda.synchronize()
                spans.append(1e3 * (time.time() - t0))
            big[f"{name} {label}"] = spans[1:]
    card = CS.smi_line()
    print(card)
    line = json.dumps({"root": str(root), "card": card, "rounds": args.rounds,
                       "reps": args.reps, "ms": ms, "all": times, "passes_ms": passes_ms,
                       "api_ms": big})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
