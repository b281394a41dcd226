"""Smoke check of the PyTorch/CUDA port on one NVIDIA GPU (built for an H100).

Run from the repo root with no arguments: ``python3 chip_smoke.py``.  It needs
one CUDA device and ``nvcc``; without a GPU it exits non-zero and prints no
result.  Phases (any failure is an uncaught exception):

1. device  - require CUDA, print the card's name and power limit.
2. build   - compile the three kernels from ``kernels/csrc`` and load them.
3. kernels - hold K1 ``eval_grad``, K2 ``trace_fwd``, K3 ``backtrace`` against
   their plain PyTorch versions on the card: at a small size in f64 and at the
   bench scene's full width (128^3 grid, 2^18 rays) in f32; time kernel, plain
   version and, where one exists, a library call; compute each kernel's bound.
4. main path - the bench scene through the entry points a user calls, with
   the launch counters zeroed just before and read just after:
   ``bench.run`` and ``api.trace`` forward + adjoint (K2 and K3, one launch
   each per pass; they never launch K1) and ``fields.grid.eval_grad`` on the
   rays' points (K1, one launch).
5. report  - one JSON line of the kernels, then the result line.

Bounds use the published peaks of one H100 SXM: 3.35 TB/s of device memory,
67 TFLOP/s in f32 outside the tensor cores.
"""

import json
import subprocess
import sys
import time

import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device; this check runs on the GPU only")

from adjointnonlinearraytracing_tpu_torch import bench
from adjointnonlinearraytracing_tpu_torch.benchmarks.scenes import build_case
from adjointnonlinearraytracing_tpu_torch.fields import grid as G
from adjointnonlinearraytracing_tpu_torch.kernels import build
from adjointnonlinearraytracing_tpu_torch.kernels import wrappers as K
from adjointnonlinearraytracing_tpu_torch.tracer import api
from adjointnonlinearraytracing_tpu_torch.tracer import eikonal as E

RES, NRAYS = 128, 1 << 18
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

# Floating-point operations the functions need, for the operation bounds.
# This is the least arithmetic that computes the same function, not what the
# kernel sources spend: a multiply and an add count one each, comparisons,
# masks, integer index arithmetic and multiplies by +-1 count nothing.
#
# stencil, 3 per axis: p/h, floor, pm - floor.
FLOPS_STENCIL = 9
# value + gradient as a tree of lerps a + w*(b - a), 3 flops each: 4 along y,
# 2 along z, 1 along x give n (21); the differences (b - a) those lerps form
# are the y-, z- and x-derivatives of the partial results, so d/dx costs only
# its scale by 1/h (1), d/dy 2 lerps along z, 1 along x and the scale (10),
# d/dz 1 lerp along x and the scale (4).
FLOPS_VALUE_GRAD = 36
# off-diagonal Hessian from the same differences: dxdy 2 subtractions, 1 lerp
# along z, scale by 1/h^2 (6); dxdz is a difference the d/dz lerp formed,
# scale (1); dydz 1 lerp along x of differences the d/dy lerps formed, scale (4).
FLOPS_HESSIAN = 11
# factorised splat of (val, g) onto 8 corners: 1 - w per axis (3),
# A[a] = val*wx[a] +- gx (4), Q[b][c] = wy[b]*wz[c] (4),
# R[b][c] = +-gy*wz[c] +- gz*wy[b] (4 products, 4 sums: 8),
# corner[a][b][c] = A[a]*Q[b][c] + wx[a]*R[b][c] (8 x 3 = 24).
FLOPS_SPLAT = 43

# K1, per point.
FLOPS_EVAL_POINT = FLOPS_STENCIL + FLOPS_VALUE_GRAD                    # 45
# K2, per step of a ray that has not escaped: x += ds*v (6); and per step
# that evaluates the field (ray inside): stencil, value + gradient,
# v += (ds*n)*grad (7).
FLOPS_FWD_STEP = 6
FLOPS_FWD_EVAL = FLOPS_STENCIL + FLOPS_VALUE_GRAD + 7                  # 52
# K3, per step of an active ray: x -= ds*v (6), snap per axis p/h, round,
# pm - r, pm*h (12), mu += ds*la (6).  Per step that evaluates: stencil on
# the snapped quotient (floor and subtraction, 6), value + gradient, Hessian,
# v update (7), dn = mu . grad (5), H mu (9), la += ds*(dn*grad + n*Hmu) (15).
# Per step that scatters: dn*ds, (ds*n)/h reused from the v update, times mu
# (5), and the splat.
FLOPS_BWD_STEP = 24
FLOPS_BWD_EVAL = 6 + FLOPS_VALUE_GRAD + FLOPS_HESSIAN + 7 + 5 + 9 + 15  # 89
FLOPS_BWD_SPLAT = 5 + FLOPS_SPLAT                                      # 48

# Tolerances, relative to the plain version's largest magnitude.
# f64: both sides do the same operations in the same order without FMA
# contraction; what is left is the order of the atomic adds.
TOL_F64 = 1e-9
# f32 at full width: the kernels repeat the plain arithmetic rounding for
# rounding, so exit states agree to rounding; the gradient sums ~10^2 terms
# per voxel by atomics in an order that changes from run to run, on both sides
# (index_add_ on the card is atomic too).  An H100 read 1.3e-6 of the largest
# entry on every run so far; 1e-5 leaves room for the order of the sums and
# none for a splat that is systematically off.
TOL_F32_STATE = 1e-5
TOL_F32_GRAD = 1e-5


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def rel_err(got, want):
    """max |got - want| over max(1, max |want|); also the raw max abs error."""
    err = float((got - want).abs().max())
    return err / max(1.0, float(want.abs().max())), err


def time_ms(fn, reps, flush=None):
    """Mean CUDA-event time of ``fn`` over ``reps`` calls after one warm-up."""
    fn()
    total = 0.0
    for _ in range(reps):
        if flush is not None:
            flush.add_(1.0)  # 256 MB written: evicts the 50 MB L2
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(stop)
    return total / reps


def scene(res, nrays, dtype, noise=0.0):
    """The bench scene plus the cotangents of the bench loss and K1's points."""
    rif, x0, v0, span = build_case(res=res, nrays=nrays, dtype=dtype, device="cuda")
    if noise:
        gen = torch.Generator(device="cuda").manual_seed(0)
        rif = rif + noise * torch.rand(rif.shape, generator=gen, device="cuda", dtype=rif.dtype)
    h = span / (res - 1)
    ds = h / 2
    # K1's points: the rays part-way through the volume, a fraction off-grid
    gen = torch.Generator(device="cuda").manual_seed(1)
    t = torch.rand((nrays, 1), generator=gen, device="cuda", dtype=rif.dtype) * 1.1 * span
    p = (x0 + t * v0).contiguous()
    return dict(rif=rif, field=G.GridField(rif, h), x0=x0, v0=v0, span=span, h=h, ds=ds,
                p=p, nf=E.max_steps_fwd(res, h, ds), nb=E.max_steps_bwd(res, h, ds),
                target=torch.tensor([span / 2, span * 1.1, span / 2], dtype=rif.dtype,
                                    device="cuda"))


def compare_kernels(s, tol_state, tol_grad, label):
    """Run each kernel and its plain version on scene ``s``; returns errors and stats."""
    f, rif, h, ds = s["field"], s["rif"], s["h"], s["ds"]
    mask = G.inbounds(f, s["p"])
    n_k, g_k = G.eval_grad(f, s["p"], mask)  # dispatches to K1 on CUDA tensors
    n_p, g_p = G.eval_grad_plain(f, s["p"], mask)
    e1 = max(rel_err(n_k, n_p)[0], rel_err(g_k, g_p)[0])
    a1 = max(rel_err(n_k, n_p)[1], rel_err(g_k, g_p)[1])
    n_k2, g_k2 = G.eval_grad(f, s["p"])      # unmasked: off-grid points clamp
    n_p2, g_p2 = G.eval_grad_plain(f, s["p"])
    e1 = max(e1, rel_err(n_k2, n_p2)[0], rel_err(g_k2, g_p2)[0])
    a1 = max(a1, rel_err(n_k2, n_p2)[1], rel_err(g_k2, g_p2)[1])

    fstats, bstats = {}, {}
    xt_k, vt_k = K.trace_fwd(rif, h, s["x0"], s["v0"], ds, s["nf"])
    xt_p, vt_p = E.trace(f, s["x0"], s["v0"], ds, s["nf"], stats=fstats)
    e2 = max(rel_err(xt_k, xt_p)[0], rel_err(vt_k, vt_p)[0])
    a2 = max(rel_err(xt_k, xt_p)[1], rel_err(vt_k, vt_p)[1])
    differ = int(((xt_k != xt_p) | (vt_k != vt_p)).any(dim=1).sum())

    dx = 2.0 * (xt_p - s["target"])
    dv = torch.ones_like(vt_p)
    g_k = K.backtrace(rif, h, xt_p, vt_p, dx, dv, ds, s["nb"], G.snap_tol(rif.dtype))
    g_p = E.backtrace(f, xt_p, vt_p, dx, dv, ds, s["nb"], stats=bstats)
    e3, a3 = rel_err(g_k, g_p)

    # one stepper step rebuilt from K1's field evaluation must land where one
    # step of K2 lands
    n1, g1 = K.eval_grad(rif, h, s["p"], mask)
    want = s["p"] + ds * (s["v0"] + (ds * n1)[:, None] * g1)
    got, _ = K.trace_fwd(rif, h, s["p"], s["v0"], ds, 1)
    step_err = rel_err(got[mask], want[mask])[0]  # a ray that starts outside keeps x0
    torch.cuda.synchronize()

    print(f"kernels[{label}] eval_grad rel_err {e1:.3e} (tol {tol_state:g}); "
          f"trace_fwd rel_err {e2:.3e} (tol {tol_state:g}), {differ} of {s['x0'].shape[0]} "
          f"rays not bitwise equal; backtrace rel_err {e3:.3e} (tol {tol_grad:g}), "
          f"max |g| {float(g_p.abs().max()):.4g}; one K2 step vs a step built on K1 "
          f"rel_err {step_err:.3e} (tol {tol_state:g})", flush=True)
    if not (e1 <= tol_state and e2 <= tol_state and e3 <= tol_grad and step_err <= tol_state):
        raise AssertionError(f"a kernel disagrees with its plain version at {label}")
    if not float(g_p.abs().max()) > 0:
        raise AssertionError("the plain gradient is all zero: the comparison is empty")
    return dict(abs_err=(a1, a2, a3), rel_err=(e1, e2, e3), fstats=fstats, bstats=bstats, mask=mask,
                xt=xt_p, vt=vt_p, dx=dx, dv=dv)


def api_small_check():
    """api.trace on the card (kernels) against api.trace on the CPU (plain), f64."""
    grads = []
    for device in ("cuda", "cpu"):
        rif, x0, v0, span = build_case(res=17, nrays=512, dtype="float64", device=device)
        loss, g = bench.fwd_bwd(rif, x0, v0, span)
        grads.append((float(loss), g.cpu()))
    (l_gpu, g_gpu), (l_cpu, g_cpu) = grads
    err = rel_err(g_gpu, g_cpu)[0]
    print(f"api[f64 17^3 x 512] loss gpu {l_gpu:.12g} cpu {l_cpu:.12g}; "
          f"gradient rel_err {err:.3e} (tol {TOL_F64:g})", flush=True)
    if abs(l_gpu - l_cpu) > TOL_F64 * abs(l_cpu) or err > TOL_F64:
        raise AssertionError("api.trace on the card disagrees with the CPU reference")


def time_kernels(s, cmp):
    """Times (ms) of kernel, plain version and library call at full width, and bounds."""
    f, rif, h, ds = s["field"], s["rif"], s["h"], s["ds"]
    n, item = s["x0"].shape[0], rif.element_size()
    grid_bytes = rif.numel() * item
    mask = cmp["mask"]
    flush = torch.zeros(64 << 20, dtype=torch.float32, device="cuda")

    # one trilinear grid_sample gives the value alone (no gradient, no mask):
    # the nearest single library call, timed as a yardstick and used nowhere
    hi = torch.tensor([(r - 1) * h for r in f.res], dtype=rif.dtype, device="cuda")
    loc = (2.0 * s["p"] / hi - 1.0).reshape(1, 1, 1, n, 3)
    vol = rif[None, None]

    def sample():
        return torch.nn.functional.grid_sample(vol, loc, mode="bilinear",
                                               padding_mode="border", align_corners=True)

    inside = mask
    lib_err = float((sample().reshape(-1)[inside] - G.eval_grad_plain(f, s["p"])[0][inside])
                    .abs().max())
    print(f"library grid_sample vs plain value on in-grid points: max abs {lib_err:.3e}")

    t = {}
    t["eval_grad"] = dict(
        ms=time_ms(lambda: K.eval_grad(rif, h, s["p"], mask), 10, flush),
        plain_ms=time_ms(lambda: G.eval_grad_plain(f, s["p"], mask), 5, flush),
        library_ms=time_ms(sample, 10, flush),
        bytes=n * (12 + 16) // 4 * item + n + grid_bytes, flops=n * FLOPS_EVAL_POINT)
    t["trace_fwd"] = dict(
        ms=time_ms(lambda: K.trace_fwd(rif, h, s["x0"], s["v0"], ds, s["nf"]), 5),
        plain_ms=time_ms(lambda: E.trace(f, s["x0"], s["v0"], ds, s["nf"]), 1),
        library_ms=None,
        bytes=4 * n * 3 * item + grid_bytes,
        flops=(cmp["fstats"]["ray_steps"] * FLOPS_FWD_STEP
               + cmp["fstats"]["evals"] * FLOPS_FWD_EVAL))
    args = (cmp["xt"], cmp["vt"], cmp["dx"], cmp["dv"], ds, s["nb"])
    t["backtrace"] = dict(
        ms=time_ms(lambda: K.backtrace(rif, h, *args, G.snap_tol(rif.dtype)), 5),
        plain_ms=time_ms(lambda: E.backtrace(f, *args), 1),
        library_ms=None,
        bytes=4 * n * 3 * item + 2 * grid_bytes,
        flops=(cmp["bstats"]["ray_steps"] * FLOPS_BWD_STEP
               + cmp["bstats"]["evals"] * FLOPS_BWD_EVAL
               + cmp["bstats"]["splats"] * FLOPS_BWD_SPLAT))
    for rec in t.values():
        by_bytes = 1e3 * rec["bytes"] / PEAK_BYTES_PER_S
        by_ops = 1e3 * rec["flops"] / PEAK_F32_FLOPS
        rec["bound_ms"] = max(by_bytes, by_ops)
        rec["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"
    return t


BENCH_ITERS = 3
# forward + adjoint passes of the main path: bench.run's warm-up and timed
# iterations, and the pass made here through api.trace
MAIN_PATH_PASSES = 1 + BENCH_ITERS + 1


def main_path():
    """The bench scene through the entry points a user calls.

    ``bench.run`` and ``api.trace`` + ``backward`` launch K2 and K3 once per
    pass and never K1; ``fields.grid.eval_grad``, the port's field evaluation
    for callers outside the steppers, launches K1 once.
    """
    rec = bench.run(res=RES, nrays=NRAYS, iters=BENCH_ITERS)
    if not rec["grad_finite"]:
        raise AssertionError("bench.run: the gradient is not finite")

    rif, x0, v0, span = build_case(res=RES, nrays=NRAYS, device="cuda")
    rif.requires_grad_(True)
    x0.requires_grad_(True)
    v0.requires_grad_(True)
    loss = bench.bench_loss(rif, x0, v0, span)
    loss.backward()
    g = rif.grad
    if g is None or g.shape != rif.shape or not bool(torch.isfinite(g).all()):
        raise AssertionError("the voxel gradient is missing, misshapen or not finite")
    if not float(g.abs().max()) > 0 or not bool(torch.isfinite(loss)):
        raise AssertionError("the voxel gradient is all zero or the loss is not finite")
    if x0.grad is not None or v0.grad is not None:
        raise AssertionError("x and v must receive no gradient")

    after_trace = dict(K.LAUNCHES)

    # the field and its gradient along the rays, as a user inspects a volume
    with torch.no_grad():
        f = G.GridField(rif.detach(), span / (RES - 1))
        p = (x0 + (0.5 * span) * v0).contiguous()
        inside = G.inbounds(f, p)
        n, grad = G.eval_grad(f, p, inside)
    if n.shape != (NRAYS,) or grad.shape != (NRAYS, 3):
        raise AssertionError("eval_grad: wrong shapes")
    if not bool(torch.isfinite(n).all() and torch.isfinite(grad).all()):
        raise AssertionError("eval_grad: values not finite")
    lo, hi = float(f.data.min()) - 1e-5, float(f.data.max()) + 1e-5
    if not bool(inside.any()) or not bool(((n[inside] >= lo) & (n[inside] <= hi)).all()):
        raise AssertionError("eval_grad: an interpolated value leaves the grid's range")
    if bool((n[~inside] != 0).any()):
        raise AssertionError("eval_grad: a masked point is not zero")
    torch.cuda.synchronize()
    rec.update(loss=float(loss.detach()), grad_abs_max=float(g.abs().max()),
               points_inside=int(inside.sum()))
    return rec, after_trace


def main():
    t_start = time.time()
    card = smi_line()
    print(f"device: {card}", flush=True)

    t0 = time.time()
    for name in build.KERNELS:
        build.load(name)
    print(f"build: {len(build.KERNELS)} kernels for sm_90a in {time.time() - t0:.1f} s "
          f"({' '.join(build.NVCC_FLAGS)})", flush=True)
    for name, log in build.build_logs().items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "warning" in line.lower():
                print(f"  nvcc[{name}] {line.strip()}")

    compare_kernels(scene(17, 512, "float64", noise=0.02), TOL_F64, TOL_F64, "f64 17^3 x 512")
    api_small_check()
    full = scene(RES, NRAYS, "float32")
    cmp = compare_kernels(full, TOL_F32_STATE, TOL_F32_GRAD, f"f32 {RES}^3 x {NRAYS}")
    times = time_kernels(full, cmp)
    print(f"work[f32 full width] forward ray-steps {cmp['fstats']['ray_steps']} "
          f"(evaluating {cmp['fstats']['evals']}), backward ray-steps "
          f"{cmp['bstats']['ray_steps']} (evaluating {cmp['bstats']['evals']}), "
          f"splats {cmp['bstats']['splats']} "
          f"({8 * cmp['bstats']['splats']} atomic adds)", flush=True)

    K.reset_launches()
    rec, after_trace = main_path()
    launches = dict(K.LAUNCHES)
    print(f"main path: {json.dumps(rec)}", flush=True)
    print(f"launches after bench.run and api.trace: {after_trace}; "
          f"after fields.grid.eval_grad as well: {launches}", flush=True)
    want = {"eval_grad": 0, "trace_fwd": MAIN_PATH_PASSES, "backtrace": MAIN_PATH_PASSES}
    if after_trace != want:
        raise AssertionError(f"{MAIN_PATH_PASSES} forward + adjoint passes must launch "
                             f"{want}, counted {after_trace}")
    if launches != {**want, "eval_grad": 1}:
        raise AssertionError(f"fields.grid.eval_grad must launch K1 once, counted {launches}")

    replaces = {
        "eval_grad": "adjointnonlinearraytracing_tpu/benchmarks/probe_evalmath.py:107",
        "trace_fwd": "adjointnonlinearraytracing_tpu/tracer/paired.py:64",
        "backtrace": "adjointnonlinearraytracing_tpu/tracer/paired.py:260",
    }
    # tolerance on the error relative to the plain version's largest magnitude,
    # and the data-dependent work this run's inputs needed
    extra = {
        "eval_grad": {"rel_tol": TOL_F32_STATE, "points": NRAYS,
                      "launched_by": "fields.grid.eval_grad"},
        "trace_fwd": {"rel_tol": TOL_F32_STATE, **cmp["fstats"],
                      "launched_by": "bench.run, tracer.api.trace"},
        "backtrace": {"rel_tol": TOL_F32_GRAD, **cmp["bstats"],
                      "atomic_adds": 8 * cmp["bstats"]["splats"],
                      "launched_by": "bench.run, tracer.api.trace"},
    }
    kernels = []
    for i, name in enumerate(build.KERNELS):
        rec_k = times[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"adjointnonlinearraytracing_tpu_torch/kernels/csrc/{name}.cu",
            "replaces": replaces[name], "launches": launches[name],
            "launches_by_api_trace": after_trace[name],
            "max_abs_err": cmp["abs_err"][i], "max_rel_err": cmp["rel_err"][i], "ms": rec_k["ms"],
            "plain_ms": rec_k["plain_ms"], "bound_ms": rec_k["bound_ms"],
            "bound_by": rec_k["bound_by"], "library_ms": rec_k["library_ms"],
            **extra[name],
        })
    print(f"elapsed: {time.time() - t_start:.1f} s")
    print(smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
