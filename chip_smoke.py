"""Smoke check of the PyTorch/CUDA port on one NVIDIA GPU (built for an H100).

Run from the repo root with no arguments: ``python3 chip_smoke.py``.  It needs
one CUDA device and ``nvcc``; without a GPU it exits non-zero and prints no
result.  Phases (any failure is an uncaught exception):

1. device  - require CUDA, print the card's name and power limit.
2. build   - compile the four kernels from ``kernels/csrc`` and load them.
3. kernels - hold K1 ``eval_grad``, K2 ``trace_fwd``, K3 ``backtrace`` against
   their plain PyTorch versions on the card: at a small size in f64 and at the
   bench scene's full width (128^3 grid, 2^18 rays) in f32, K2 and K3 with
   and without the ray order (``tracer/order.py``) that ``api.trace`` gives
   them; hold K4 ``gather_rows`` against its plain version at the gather
   probe's full size (66^3 rows of 128, 2^18 indices; f32 and f64, int32 and
   int64); time kernel, plain version and, where one exists, a library call,
   and the order's own set-up time; compute each kernel's bound.  Then K2 and
   K3 at every stage resolution of the fuel trainer (3^3 .. 65^3) with the
   run's own rays, f64 and f32: K2 bitwise with and without the order, K3
   against its plain version, the K3 path each stage takes (shared or
   global), and the runs K3 flushed (counted in the kernel) against the
   plain version's ``flushes``.
4. main paths - each through the entry points a user calls, with the launch
   counters zeroed just before and read just after:
   a. the bench scene: ``bench.run`` and ``api.trace`` forward + adjoint (K2
      and K3, one launch each per pass; they never launch K1) and
      ``fields.grid.eval_grad`` on the rays' points (K1, one launch);
   b. the gather probe: ``benchmarks.probe_dma_gather.run`` (K4);
   c. the fuel-injection trainer at full width:
      ``experiments.fuel_injection.run_opt`` with the shipped configuration
      (six stages 3^3 .. 65^3, 16 views of 128x128 = 262,144 rays, the real
      volume, f32), ``optim_iters`` cut from 300 to 10 (210 Adam steps), with
      the spot check and the stage escalation on; K2 and K3 are asserted at
      exactly the launches the code implies, K3 on each path too, K1 and K4
      at none.  Then the same trainer in f64 at a small size on the card
      against the CPU, and, when the short run predicts that it fits, the
      full 300-iteration run (6,300 steps).
5. report  - one JSON line of the kernels, then the result line.

Bounds use the published peaks of one H100 SXM: 3.35 TB/s of device memory,
67 TFLOP/s in f32 outside the tensor cores.
"""

import json
import math
import os
import subprocess
import sys
import time

import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device; this check runs on the GPU only")

from adjointnonlinearraytracing_tpu_torch import bench
from adjointnonlinearraytracing_tpu_torch.benchmarks import probe_dma_gather
from adjointnonlinearraytracing_tpu_torch.benchmarks.scenes import build_case
from adjointnonlinearraytracing_tpu_torch.experiments import fuel_injection, voxel_scenes
from adjointnonlinearraytracing_tpu_torch.fields import grid as G
from adjointnonlinearraytracing_tpu_torch.kernels import build
from adjointnonlinearraytracing_tpu_torch.kernels import wrappers as K
from adjointnonlinearraytracing_tpu_torch.tracer import api
from adjointnonlinearraytracing_tpu_torch.tracer import eikonal as E
from adjointnonlinearraytracing_tpu_torch.tracer import order as O
from adjointnonlinearraytracing_tpu_torch.utils.metrics import MetricsLogger

RES, NRAYS = 128, 1 << 18
# the gather probe's own size: a table of 66^3 rows of 128 f32, 2^18 indices
GATHER_ROWS, GATHER_N, GATHER_REPS = 66 ** 3, 1 << 18, 8
# the fuel trainer: iterations per stage are FUEL_ITERS * (stage + 1); the
# shipped configuration has 300
FUEL_ITERS, FUEL_ITERS_SHIPPED = 10, 300
# the full-length run is made when 30 x the short run's time is below this
FULL_RUN_BUDGET_S = 400.0
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
# f32 K3 at the fuel trainer's coarse stages (3^3 .. 33^3), where ~2.5e8
# terms land on 27 .. 35,937 words, 10^4 to 10^7 a word.  The plain version
# adds them one by one (index_add_, atomic on the card) into a running f32
# sum; once a word's sum is large, each term loses most of its low bits, the
# same way in every run, so the plain version's error is systematic and its
# run-to-run spread does not show it (an H100 read a spread of 2.1e-5 of the
# largest entry at 3^3 but a distance of 7.2e-3 to the exact sum of the same
# terms).  The kernel sums runs in registers, blocks in shared memory, and
# lands within 1e-6 of that exact sum.  So at every f32 stage the kernel is
# held to TOL_F32_GRAD against the f64 sum of the plain version's own f32
# terms (E.backtrace with acc_dtype=float64), and, at the coarse stages,
# to the plain version within that version's own distance to the same sum
# plus TOL_F32_GRAD (all three distances over the f64 sum's largest entry).
# At 65^3 (and at 128^3 above) the kernel is held to the plain version at
# TOL_F32_GRAD as before.
COARSE_RES = 33


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


def set_bound(rec):
    """The least time the card could take for ``rec``'s bytes and operations."""
    by_bytes = 1e3 * rec["bytes"] / PEAK_BYTES_PER_S
    by_ops = 1e3 * rec["flops"] / PEAK_F32_FLOPS
    rec["bound_ms"] = max(by_bytes, by_ops)
    rec["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"
    return rec


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
    order = O.ray_order(s["x0"], s["v0"], rif.shape, h)  # as api.trace makes it
    xt_p, vt_p = E.trace(f, s["x0"], s["v0"], ds, s["nf"], stats=fstats)
    e2, a2, differ = 0.0, 0.0, {}
    for label_o, o in (("ordered", order), ("unordered", None)):
        xt_k, vt_k = K.trace_fwd(rif, h, s["x0"], s["v0"], ds, s["nf"], o)
        e2 = max(e2, rel_err(xt_k, xt_p)[0], rel_err(vt_k, vt_p)[0])
        a2 = max(a2, rel_err(xt_k, xt_p)[1], rel_err(vt_k, vt_p)[1])
        differ[label_o] = int(((xt_k != xt_p) | (vt_k != vt_p)).any(dim=1).sum())

    dx = 2.0 * (xt_p - s["target"])
    dv = torch.ones_like(vt_p)
    g_p = E.backtrace(f, xt_p, vt_p, dx, dv, ds, s["nb"], stats=bstats)
    tally = torch.zeros(3, dtype=torch.int64, device="cuda")
    g_k = K.backtrace(rif, h, xt_p, vt_p, dx, dv, ds, s["nb"], G.snap_tol(rif.dtype), order,
                      tally)
    g_u = K.backtrace(rif, h, xt_p, vt_p, dx, dv, ds, s["nb"], G.snap_tol(rif.dtype))
    e3, a3 = (max(a, b) for a, b in zip(rel_err(g_k, g_p), rel_err(g_u, g_p)))
    runs, issued = int(tally[0]), int(tally[1])

    # one stepper step rebuilt from K1's field evaluation must land where one
    # step of K2 lands
    n1, g1 = K.eval_grad(rif, h, s["p"], mask)
    want = s["p"] + ds * (s["v0"] + (ds * n1)[:, None] * g1)
    got, _ = K.trace_fwd(rif, h, s["p"], s["v0"], ds, 1)
    step_err = rel_err(got[mask], want[mask])[0]  # a ray that starts outside keeps x0
    torch.cuda.synchronize()

    print(f"kernels[{label}] eval_grad rel_err {e1:.3e} (tol {tol_state:g}); "
          f"trace_fwd rel_err {e2:.3e} (tol {tol_state:g}), rays of {s['x0'].shape[0]} not "
          f"bitwise equal: {differ['ordered']} ordered, {differ['unordered']} unordered; "
          f"backtrace ({K.backtrace_path(rif.numel(), rif.dtype)} path) rel_err {e3:.3e} "
          f"(tol {tol_grad:g}, ordered and unordered), max |g| {float(g_p.abs().max()):.4g}, "
          f"runs flushed {runs} (plain version's flushes {bstats['flushes']}), issued after the "
          f"warp sums {issued} ({8 * issued} atomic adds); one K2 step vs "
          f"a step built on K1 rel_err {step_err:.3e} (tol {tol_state:g})", flush=True)
    if not (e1 <= tol_state and e2 <= tol_state and e3 <= tol_grad and step_err <= tol_state):
        raise AssertionError(f"a kernel disagrees with its plain version at {label}")
    if not float(g_p.abs().max()) > 0:
        raise AssertionError("the plain gradient is all zero: the comparison is empty")
    if runs != bstats["flushes"]:
        raise AssertionError(f"K3 flushed {runs} runs, the plain version counts "
                             f"{bstats['flushes']}")
    if any(differ.values()):
        raise AssertionError(f"K2 is not bitwise equal to its plain version: {differ}")
    return dict(abs_err=(a1, a2, a3), rel_err=(e1, e2, e3), fstats=fstats, bstats=bstats, mask=mask,
                xt=xt_p, vt=vt_p, dx=dx, dv=dv, order=order, differ=differ, issued=issued)


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

    # the same call with non-contiguous rif, x, v (the kernels take contiguous
    # tensors: api.trace makes them so) gives the same exit state, bit for bit
    rif, x0, v0, span = build_case(res=17, nrays=512, dtype="float64", device="cuda")
    h = span / 16
    strided_rif = rif.permute(2, 1, 0).contiguous().permute(2, 1, 0)
    xv = torch.cat([x0, v0], dim=1)
    sx, sv = xv[:, :3], xv[:, 3:]
    if strided_rif.is_contiguous() or sx.is_contiguous() or sv.is_contiguous():
        raise AssertionError("the strided case is contiguous")
    strided_rif.requires_grad_(True)
    xt_s, vt_s = api.trace(strided_rif, sx, sv, h, h / 2)
    (xt_s ** 2).sum().backward()
    ref = rif.clone().requires_grad_(True)
    xt_c, vt_c = api.trace(ref, x0, v0, h, h / 2)
    (xt_c ** 2).sum().backward()
    gerr = rel_err(strided_rif.grad, ref.grad)[0]
    print(f"api[strided rif, x, v] exit state equal {bool(torch.equal(xt_s, xt_c))}, "
          f"gradient rel_err {gerr:.3e} (tol {TOL_F64:g})", flush=True)
    if not (torch.equal(xt_s, xt_c) and torch.equal(vt_s, vt_c)) or gerr > TOL_F64:
        raise AssertionError("api.trace on strided inputs disagrees with contiguous ones")


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
    # K2 and K3 as api.trace launches them (with the ray order), and without it
    order = cmp["order"]
    t["trace_fwd"] = dict(
        ms=time_ms(lambda: K.trace_fwd(rif, h, s["x0"], s["v0"], ds, s["nf"], order), 5),
        ms_unordered=time_ms(lambda: K.trace_fwd(rif, h, s["x0"], s["v0"], ds, s["nf"]), 5),
        plain_ms=time_ms(lambda: E.trace(f, s["x0"], s["v0"], ds, s["nf"]), 1),
        library_ms=None,
        bytes=4 * n * 3 * item + grid_bytes,
        flops=(cmp["fstats"]["ray_steps"] * FLOPS_FWD_STEP
               + cmp["fstats"]["evals"] * FLOPS_FWD_EVAL))
    args = (cmp["xt"], cmp["vt"], cmp["dx"], cmp["dv"], ds, s["nb"])
    tol = G.snap_tol(rif.dtype)
    t["backtrace"] = dict(
        ms=time_ms(lambda: K.backtrace(rif, h, *args, tol, order), 5),
        ms_unordered=time_ms(lambda: K.backtrace(rif, h, *args, tol), 5),
        plain_ms=time_ms(lambda: E.backtrace(f, *args), 1),
        library_ms=None,
        bytes=4 * n * 3 * item + 2 * grid_bytes,
        flops=(cmp["bstats"]["ray_steps"] * FLOPS_BWD_STEP
               + cmp["bstats"]["evals"] * FLOPS_BWD_EVAL
               + cmp["bstats"]["splats"] * FLOPS_BWD_SPLAT))
    t["order_ms"] = time_ms(lambda: O.ray_order(s["x0"], s["v0"], rif.shape, h), 10)
    print(f"order: tracer.order.ray_order of {n} rays (key + stable argsort, set-up of "
          f"api.trace's forward pass, not a kernel of the port) {t['order_ms']:.4f} ms; "
          f"K2 {t['trace_fwd']['ms']:.4f} ms ordered, {t['trace_fwd']['ms_unordered']:.4f} ms "
          f"unordered; K3 {t['backtrace']['ms']:.4f} ms ordered, "
          f"{t['backtrace']['ms_unordered']:.4f} ms unordered", flush=True)
    for name in ("eval_grad", "trace_fwd", "backtrace"):
        set_bound(t[name])
    return t


def gather_check_and_time():
    """K4 against its plain version at the probe's size, exactly; times and bound."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    table = torch.randn((GATHER_ROWS, probe_dma_gather.LANES), generator=gen,
                        dtype=torch.float32, device="cuda")
    idx = torch.randint(0, GATHER_ROWS, (GATHER_N,), generator=gen, dtype=torch.int32,
                        device="cuda")
    worst = 0.0
    for tab in (table, table.double()):
        for ind in (idx, idx.long()):
            got = K.gather_rows(tab, ind)
            want = probe_dma_gather.gather_rows_plain(tab, ind)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            worst = max(worst, err)
            print(f"kernels[gather_rows {str(tab.dtype)[6:]} table {tuple(tab.shape)}, "
                  f"{str(ind.dtype)[6:]} idx ({GATHER_N},)] max abs err {err:g} (must be 0), "
                  f"bitwise equal {bool(torch.equal(got, want))}", flush=True)
            if err != 0.0 or not torch.equal(got, want):
                raise AssertionError("gather_rows disagrees with its plain version")
    del tab, got, want
    flush = torch.zeros(64 << 20, dtype=torch.float32, device="cuda")
    row_bytes = table.shape[1] * table.element_size()
    rec = dict(
        ms=time_ms(lambda: K.gather_rows(table, idx), 10, flush),
        plain_ms=time_ms(lambda: probe_dma_gather.gather_rows_plain(table, idx), 10, flush),
        # the one library call that computes the same function; used nowhere in the port
        library_ms=time_ms(lambda: torch.index_select(table, 0, idx), 10, flush),
        # what this run's data needs: each gathered row read once and written
        # once, each index read once (the table as a whole is not an input
        # that must move: only the rows picked are)
        bytes=2 * GATHER_N * row_bytes + GATHER_N * idx.element_size(), flops=0,
        max_abs_err=worst)
    set_bound(rec)
    print(f"gather_rows[f32, int32] {rec['ms']:.4f} ms = {100 * rec['bound_ms'] / rec['ms']:.1f} % "
          f"of the byte bound {rec['bound_ms']:.4f} ms ({rec['bytes'] / 1e6:.1f} MB); plain "
          f"{rec['plain_ms']:.4f} ms; torch.index_select {rec['library_ms']:.4f} ms", flush=True)
    return rec


def gather_probe_path():
    """The probe's entry point; it launches K4 for its check, its warm-up and each repetition."""
    K.reset_launches()
    rec = probe_dma_gather.run(R=GATHER_ROWS, N=GATHER_N, reps=GATHER_REPS)
    launches = dict(K.LAUNCHES)
    print(f"gather probe: {json.dumps(rec)}", flush=True)
    want = {"eval_grad": 0, "trace_fwd": 0, "backtrace": 0, "gather_rows": 2 + GATHER_REPS}
    if launches != want:
        raise AssertionError(f"probe_dma_gather.run must launch {want}, counted {launches}")
    if rec["max_abs_err"] != 0.0 or not rec["kernel"]["ms_per_dispatch"] > 0:
        raise AssertionError("probe_dma_gather.run: wrong result or no time")
    return launches


def fuel_params():
    """Section ``default`` of ``configs/params-fuel.yaml``, written out (the GPU machine
    is not known to have ``yaml``; a CPU test holds the two equal)."""
    return dict(fuel_injection.default_params(), nviews=16)


def fuel_launches(params):
    """K2 and K3 launches that ``run_opt(params)`` implies, from the code:
    one K2 for the ground truth; per Adam step one K2 (loss) and one K3 (its
    gradient); per spot check (one at start-up, one at the start of every
    stage but the first) one K2 and one K3 through ``tracer.trace`` (the exact
    side is the taped plain version and launches nothing).  Every K3 launch
    of stage s runs on that stage's grid, so its path is that grid's
    (``wrappers.backtrace_path``)."""
    stages = len(params["res_list"])
    steps = sum(params["optim_iters"] * (s + 1) for s in range(stages))
    checks = (1 if params.get("grad_spotcheck", True) else 0) + (
        stages - 1 if params.get("auto_exact", True) else 0)
    dtype = {"float32": torch.float32, "float64": torch.float64}[params.get("dtype", "float32")]
    paths = {"shared": 0, "global": 0}
    for s, res in enumerate(params["res_list"]):
        check = 1 if (s == 0 and params.get("grad_spotcheck", True)) or (
            s > 0 and params.get("auto_exact", True)) else 0
        paths[K.backtrace_path(res ** 3, dtype)] += params["optim_iters"] * (s + 1) + check
    return steps, {"eval_grad": 0, "trace_fwd": 1 + steps + checks,
                   "backtrace": steps + checks, "gather_rows": 0}, paths


def fuel_path(iters, label, work):
    """The fuel-injection trainer at full width for ``iters`` iterations a stage.

    In f32 the constant-memory adjoint drifts on this scene (rays of a view
    run along a grid axis and ``ds`` divides ``h``, so every few steps a
    position sits on a node plane, where forward and reverse can pick
    different cells), and the stage spot check would escalate to the exact
    gradient, which the port does not have yet and raises for.  The run keeps
    the spot checks and the escalator on, prints what they measure, and lifts
    the escalation tolerance (``ANRT_EXACT_TOL``) for its duration.
    """
    params = dict(fuel_params(), optim_iters=iters, grad_spotcheck=True, auto_exact=True)
    res_list = params["res_list"]
    nrays = params["nviews"] * params["nbins"] ** 2 * params["spp"]
    steps, want, want_paths = fuel_launches(params)
    step_rows, events = [], []

    def stat(it, loss, secs):
        step_rows.append((it, loss, secs, len(events)))

    metrics = MetricsLogger()
    saved_tol = os.environ.get("ANRT_EXACT_TOL")
    os.environ["ANRT_EXACT_TOL"] = "1e30"
    K.reset_launches()
    K.record_events(events)
    t0 = time.time()
    try:
        eta, hist, gtruth = fuel_injection.run_opt(params, None, stat_fn=stat, metrics=metrics)
        torch.cuda.synchronize()
    finally:
        K.record_events(None)
        if saved_tol is None:
            del os.environ["ANRT_EXACT_TOL"]
        else:
            os.environ["ANRT_EXACT_TOL"] = saved_tol
    seconds = time.time() - t0
    launches = dict(K.LAUNCHES)
    paths = dict(K.BACKTRACE_PATHS)
    checks = {k: v for row in metrics.history for k, v in row.items()
              if k.startswith("grad_spotcheck")}
    for name in ["grad_spotcheck"] + [f"grad_spotcheck_stage{s}" for s in range(1, 6)]:
        print(f"fuel[{label}] {name} (adjoint against the taped plain version, 2048 rays): "
              f"max-rel {checks[name]:.3e}, rel-L2 {checks[name + '_rel_l2']:.3e}, cosine "
              f"{checks[name + '_cos']:.5f}; the escalation tolerance is 0.01 by default",
              flush=True)
    print(f"fuel[{label}] {params['nviews']} views x {params['nbins']}^2 = {nrays} rays, "
          f"stages {res_list}, optim_iters {iters} (shipped {FUEL_ITERS_SHIPPED}), "
          f"{steps} Adam steps in {seconds:.2f} s; launches {launches}; K3 by path {paths} "
          f"(stages {[f'{r}^3: ' + K.backtrace_path(r ** 3, torch.float32) for r in res_list]})",
          flush=True)
    if launches != want or paths != want_paths:
        raise AssertionError(f"run_opt must launch {want}, K3 by path {want_paths}, counted "
                             f"{launches}, {paths}")
    if nrays != 262144 or len(hist) != steps or len(step_rows) != steps:
        raise AssertionError("the fuel run is not at full width or lost steps")
    if not all(map(math.isfinite, hist)):
        raise AssertionError("a loss of the fuel run is not finite")
    if not hist[-1] < hist[0]:
        raise AssertionError(f"the loss did not fall: {hist[0]} -> {hist[-1]}")
    clamp_max = float(params["step_res"])
    if eta.shape != (65, 65, 65) or eta.dtype != torch.float32 or not eta.is_cuda:
        raise AssertionError("the recovered field is not a 65^3 f32 tensor on the card")
    if not bool(torch.isfinite(eta).all()) or float(eta.min()) < 1.0 \
            or float(eta.max()) > clamp_max:
        raise AssertionError("the recovered field leaves [1, clamp_max]")
    # the shell is frozen at every stage and a finer shell is interpolated
    # from the coarser shell alone, so a shell that had moved at any stage
    # would show here; resampling a constant costs a few roundings
    interior = torch.zeros_like(eta, dtype=torch.bool)
    interior[1:-1, 1:-1, 1:-1] = True
    start = torch.ones((), dtype=torch.float32, device="cuda") + params["fuel_val"]
    shell_dev = float((eta[~interior] - start).abs().max())
    moved = float((eta[interior] - start).abs().max())
    if shell_dev > 1e-6 or not moved > 1e-6:
        raise AssertionError(f"boundary shell moved by {shell_dev} or interior stayed ({moved})")

    # per stage: step time on the host clock (each step ends with the loss
    # read back, so the device has finished), and K2 + K3 of that step from
    # the events recorded around the launches
    per_stage, first = [], 0
    for s, res in enumerate(res_list):
        rows = step_rows[first:first + iters * (s + 1)]
        first += len(rows)
        step_ms = sorted(1e3 * r[2] for r in rows)
        kern = []
        for r in rows:
            (n2, a2, b2), (n3, a3, b3) = events[r[3] - 2:r[3]]  # the step's own two launches
            if (n2, n3) != ("trace_fwd", "backtrace"):
                raise AssertionError("a step's launches are not K2 then K3")
            kern.append((a2.elapsed_time(b2), a3.elapsed_time(b3)))
        k2 = sorted(k[0] for k in kern)[len(kern) // 2]
        k3 = sorted(k[1] for k in kern)[len(kern) // 2]
        med = step_ms[len(step_ms) // 2]
        per_stage.append(dict(res=res, steps=len(rows), step_ms_median=med,
                              step_ms_mean=sum(step_ms) / len(step_ms),
                              rays_per_s=nrays / (1e-3 * med), k2_ms_median=k2, k3_ms_median=k3,
                              kernel_share=(k2 + k3) / med, loss_last=rows[-1][1]))
        print(f"fuel[{label}] stage {s} res {res}^3: {len(rows)} steps, median "
              f"{med:.3f} ms/step = {nrays / (1e-3 * med):.4g} rays/s; K2 {k2:.3f} ms + K3 "
              f"{k3:.3f} ms = {100 * (k2 + k3) / med:.1f} % of the step, the rest "
              f"{med - k2 - k3:.3f} ms is host work and small kernels; loss {rows[-1][1]:.6g}",
              flush=True)
    # the work of a pass at each stage as the plain versions counted it on the
    # run's own rays (stage_checks), and the rates the stage's kernel times give
    for st, w in zip(per_stage, work):
        print(f"fuel[{label}] work of a pass at {st['res']}^3: forward {w['ray_steps_fwd']} "
              f"ray-steps, K2 at {w['ray_steps_fwd'] / (1e-3 * st['k2_ms_median']):.4g} "
              f"ray-steps/s; backward {w['ray_steps']} ray-steps, {w['splats']} splats "
              f"({8 * w['splats']} adds a splat each would issue), {w['flushes']} runs, "
              f"issued as {w['issued']} flushes = {8 * w['issued']} adds into K3's "
              f"{w['path']} accumulator"
              + (f" + {w['block_adds']} adds of the block-private gradients"
                 if w["path"] == "shared" else "")
              + f"; K3 at {w['ray_steps'] / (1e-3 * st['k3_ms_median']):.4g} ray-steps/s",
              flush=True)
    err = fuel_injection.reconstruction_error(eta, gtruth,
                                              background=1.0 + params["fuel_val"])
    print(f"fuel[{label}] loss {hist[0]:.6g} -> {hist[-1]:.6g}; shell deviation {shell_dev:.2e}; "
          f"reconstruction_error (background 1 + fuel_val) {json.dumps(err)}", flush=True)
    return dict(seconds=seconds, steps=steps, launches=launches, k3_paths=paths,
                per_stage=per_stage, loss_first=hist[0], loss_last=hist[-1], spot_checks=checks,
                **err)


def stage_checks(params):
    """K2 and K3 against their plain versions at every stage resolution of the
    fuel trainer, with the run's own rays (same seed, same generator), on the
    ground truth resampled to the stage (``ds`` is the run's, fixed by the
    finest grid), in f64 and f32.  K2 must be bitwise equal with and without
    the order; K3 (with the order, as api.trace runs it) within the limits
    above; the runs K3 flushed, counted in the kernel, must equal the plain
    version's ``flushes``.  Returns the f32 work per stage, the rows of the
    report and a list of failures (raised at the end of the script)."""
    res_list, span = params["res_list"], params["vol_span"]
    ds = span / (res_list[-1] - 1) / params["step_res"]
    gt = voxel_scenes.fuel_injection_rif(params["fuel_val"], torch.float64, "cuda")
    work, rows, failures = [], [], []
    for dtype in (torch.float64, torch.float32):
        rays, _ = fuel_injection.gen_start_rays(
            params, torch.Generator(device="cuda").manual_seed(params["seed"]), dtype)
        x0, v0 = rays.x.contiguous(), rays.v.contiguous()
        for res in res_list:
            rif = G.upres_volume(gt, res).to(dtype).contiguous()
            h = span / (res - 1)
            f = G.GridField(rif, h)
            nf, nb, tol_snap = E.max_steps_fwd(res, h, ds), E.max_steps_bwd(res, h, ds), \
                G.snap_tol(dtype)
            order = O.ray_order(x0, v0, rif.shape, h)
            fw, bw = {}, {}
            xt, vt = E.trace(f, x0, v0, ds, nf, stats=fw)
            differ = {}
            for lab, o in (("ordered", order), ("unordered", None)):
                xt_k, vt_k = K.trace_fwd(rif, h, x0, v0, ds, nf, o)
                differ[lab] = int(((xt_k != xt) | (vt_k != vt)).any(dim=1).sum())
            dx, dv = 2.0 * (xt - 0.5), torch.ones_like(vt)
            g_p = E.backtrace(f, xt, vt, dx, dv, ds, nb, stats=bw)
            g_p2 = E.backtrace(f, xt, vt, dx, dv, ds, nb)
            tally = torch.zeros(3, dtype=torch.int64, device="cuda")
            g_k = K.backtrace(rif, h, xt, vt, dx, dv, ds, nb, tol_snap, order, tally)
            path = K.backtrace_path(rif.numel(), dtype)
            err, spread = rel_err(g_k, g_p)[0], rel_err(g_p2, g_p)[0]
            if dtype == torch.float32:
                # every distance over the f64 sum's largest entry, so that the
                # triangle inequality holds between the three
                g_64 = E.backtrace(f, xt, vt, dx, dv, ds, nb, acc_dtype=torch.float64)
                scale = max(1.0, float(g_64.abs().max()))
                err_f = [float((g.double() - w).abs().max()) / scale
                         for g, w in ((g_k, g_p.double()), (g_k, g_64), (g_p, g_64))]
                if res <= COARSE_RES:
                    err = err_f[0]
            row = dict(dtype=str(dtype)[6:], res=res, path=path, max_abs_g=float(g_p.abs().max()),
                       rel_err=err, plain_spread=spread, differ=differ,
                       runs=int(tally[0]), issued=int(tally[1]), block_adds=int(tally[2]),
                       flushes=bw["flushes"],
                       splats=bw["splats"])
            if dtype == torch.float64:
                tol = TOL_F64
            else:
                row.update(kernel_vs_f64_sum=err_f[1], plain_vs_f64_sum=err_f[2])
                tol = TOL_F32_GRAD
                if res <= COARSE_RES:
                    tol = row["plain_vs_f64_sum"] + TOL_F32_GRAD
                if row["kernel_vs_f64_sum"] > TOL_F32_GRAD:
                    failures.append(f"K3 at f32 {res}^3 is {row['kernel_vs_f64_sum']:.3e} from "
                                    "the f64 sum of the same terms")
                k2o = time_ms(lambda: K.trace_fwd(rif, h, x0, v0, ds, nf, order), 3)
                k2u = time_ms(lambda: K.trace_fwd(rif, h, x0, v0, ds, nf), 3)
                k3o = time_ms(lambda: K.backtrace(rif, h, xt, vt, dx, dv, ds, nb, tol_snap,
                                                  order), 3)
                k3u = time_ms(lambda: K.backtrace(rif, h, xt, vt, dx, dv, ds, nb, tol_snap), 3)
                row.update(k2_ms_ordered=k2o, k2_ms_unordered=k2u, k3_ms_ordered=k3o,
                           k3_ms_unordered=k3u,
                           order_ms=time_ms(lambda: O.ray_order(x0, v0, rif.shape, h), 5))
                work.append(dict(res=res, path=path, ray_steps_fwd=fw["ray_steps"],
                                 ray_steps=bw["ray_steps"], splats=bw["splats"],
                                 flushes=bw["flushes"], issued=int(tally[1]),
                                 block_adds=int(tally[2])))
            row["tol"] = tol
            rows.append(row)
            print(f"stage[{row['dtype']} {res}^3, {x0.shape[0]} rays] K3 {path} path: rel_err "
                  f"{err:.3e} (tol {tol:g}); plain version's run-to-run spread {spread:.3e}"
                  + (f"; distance to the f64 sum of the same f32 terms: kernel "
                     f"{row['kernel_vs_f64_sum']:.3e} (tol {TOL_F32_GRAD:g}), plain "
                     f"{row['plain_vs_f64_sum']:.3e}"
                     if dtype == torch.float32 else "")
                  + f"; runs flushed {row['runs']} (plain flushes {row['flushes']}, splats "
                  f"{row['splats']}), issued after the warp sums {row['issued']}: "
                  f"{8 * row['issued']} atomic adds against {8 * row['splats']} a splat each "
                  f"would issue; block-private adds {row['block_adds']}; K2 rays not bitwise "
                  f"equal {differ}"
                  + (f"; K2 {row['k2_ms_ordered']:.4f} ms ordered / "
                     f"{row['k2_ms_unordered']:.4f} unordered, K3 {row['k3_ms_ordered']:.4f} "
                     f"ordered / {row['k3_ms_unordered']:.4f} unordered, the order "
                     f"{row['order_ms']:.4f}"
                     if dtype == torch.float32 else ""), flush=True)
            if not (err <= tol and float(g_p.abs().max()) > 0):
                failures.append(f"K3 disagrees with its plain version at {row['dtype']} {res}^3")
            if any(differ.values()):
                failures.append(f"K2 is not bitwise equal at {row['dtype']} {res}^3: {differ}")
            if row["runs"] != row["flushes"]:
                failures.append(f"K3 flushed {row['runs']} runs at {row['dtype']} {res}^3, the "
                                f"plain version counts {row['flushes']}")
            if (path == "shared") != (row["block_adds"] > 0):
                failures.append(f"K3's block-private adds ({row['block_adds']}) do not fit "
                                f"the {path} path at {row['dtype']} {res}^3")
    return work, rows, failures


def fuel_small_check():
    """The same trainer in f64 at a small size, on the card against the CPU.

    The card runs the kernels (and, for the spot checks, the taped plain
    version); the CPU runs the plain versions throughout: the whole slice,
    kernels in, against plain versions."""
    params = dict(fuel_params(), res_list=[3, 5, 9], nviews=2, nbins=16, optim_iters=3,
                  dtype="float64", grad_spotcheck=True, auto_exact=True)
    rays, _ = fuel_injection.gen_start_rays(params, torch.Generator().manual_seed(0),
                                            torch.float64)
    gtruth = voxel_scenes.fuel_injection_rif(params["fuel_val"], torch.float64, "cpu")
    steps, want, want_paths = fuel_launches(params)
    K.reset_launches()
    eta_gpu, hist_gpu, _ = fuel_injection.run_opt(params, None, gtruth, rays=rays)
    launches = dict(K.LAUNCHES)
    if dict(K.BACKTRACE_PATHS) != want_paths:
        raise AssertionError(f"the small run must launch K3 by path {want_paths}, counted "
                             f"{K.BACKTRACE_PATHS}")
    eta_cpu, hist_cpu, _ = fuel_injection.run_opt(params, None, gtruth, rays=rays, device="cpu")
    if launches != want or dict(K.LAUNCHES) != want:
        raise AssertionError(f"the small run must launch {want} on the card and nothing on "
                             f"the CPU, counted {launches} then {dict(K.LAUNCHES)}")
    hist_err = max(abs(a - b) / abs(b) for a, b in zip(hist_gpu, hist_cpu))
    scale = float((eta_cpu - 1.0).abs().max())
    eta_err = float((eta_gpu.cpu() - eta_cpu).abs().max()) / scale
    print(f"fuel[f64 {params['res_list']}, {rays.x.shape[0]} rays, {steps} steps] card against "
          f"CPU: loss history rel_err {hist_err:.3e}, final field err {eta_err:.3e} of its "
          f"largest deviation from 1 ({scale:.3e}) (tol {TOL_F64:g}); loss "
          f"{hist_cpu[0]:.6g} -> {hist_cpu[-1]:.6g}", flush=True)
    if len(hist_gpu) != steps or not eta_gpu.is_cuda or eta_cpu.is_cuda:
        raise AssertionError("the small runs did not run where they were asked to")
    if not (hist_err <= TOL_F64 and eta_err <= TOL_F64 and hist_cpu[-1] < hist_cpu[0]):
        raise AssertionError("the fuel trainer on the card disagrees with the CPU")


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
    events = []
    K.record_events(events)  # K2 and K3 of each pass, from events around the launches
    try:
        rec = bench.run(res=RES, nrays=NRAYS, iters=BENCH_ITERS)
    finally:
        K.record_events(None)
    torch.cuda.synchronize()
    timed = events[2:]  # the warm-up pass launched the first two
    for name in ("trace_fwd", "backtrace"):
        ms = sorted(a.elapsed_time(b) for n, a, b in timed if n == name)
        rec[f"{name}_ms_median"] = ms[len(ms) // 2]
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
            if any(w in line for w in ("registers", "spill", "Compiling entry", "arning")):
                print(f"  nvcc[{name}] {line.strip()}")

    compare_kernels(scene(17, 512, "float64", noise=0.02), TOL_F64, TOL_F64, "f64 17^3 x 512")
    api_small_check()
    full = scene(RES, NRAYS, "float32")
    cmp = compare_kernels(full, TOL_F32_STATE, TOL_F32_GRAD, f"f32 {RES}^3 x {NRAYS}")
    times = time_kernels(full, cmp)
    print(f"work[f32 full width] forward ray-steps {cmp['fstats']['ray_steps']} "
          f"(evaluating {cmp['fstats']['evals']}), backward ray-steps "
          f"{cmp['bstats']['ray_steps']} (evaluating {cmp['bstats']['evals']}), "
          f"splats {cmp['bstats']['splats']} ({8 * cmp['bstats']['splats']} adds a splat each "
          f"would issue), runs {cmp['bstats']['flushes']} ({8 * cmp['bstats']['flushes']} adds "
          f"one a run would issue), issued after the warp sums {cmp['issued']} "
          f"({8 * cmp['issued']} atomic adds)", flush=True)
    work, stage_rows, failures = stage_checks(fuel_params())

    gather = gather_check_and_time()
    times["gather_rows"] = gather

    K.reset_launches()
    rec, after_trace = main_path()
    bench_launches = dict(K.LAUNCHES)
    bench_k3_paths = dict(K.BACKTRACE_PATHS)
    print(f"main path: {json.dumps(rec)}", flush=True)
    k2, k3 = rec["trace_fwd_ms_median"], rec["backtrace_ms_median"]
    print(f"bench split: {rec['ms_per_iter']:.3f} ms an iteration = K2 {k2:.3f} + K3 {k3:.3f} "
          f"+ {rec['ms_per_iter'] - k2 - k3:.3f} ms of the rest, of which the ray order takes "
          f"about {times['order_ms']:.3f} ms (timed alone above)", flush=True)
    print(f"launches after bench.run and api.trace: {after_trace}; "
          f"after fields.grid.eval_grad as well: {bench_launches}", flush=True)
    want = {"eval_grad": 0, "trace_fwd": MAIN_PATH_PASSES, "backtrace": MAIN_PATH_PASSES,
            "gather_rows": 0}
    if after_trace != want:
        raise AssertionError(f"{MAIN_PATH_PASSES} forward + adjoint passes must launch "
                             f"{want}, counted {after_trace}")
    if bench_launches != {**want, "eval_grad": 1}:
        raise AssertionError(f"fields.grid.eval_grad must launch K1 once, counted "
                             f"{bench_launches}")
    want_paths = {"shared": 0, "global": 0}
    want_paths[K.backtrace_path(RES ** 3, torch.float32)] = MAIN_PATH_PASSES
    if bench_k3_paths != want_paths:
        raise AssertionError(f"K3 on the bench scene must take {want_paths}, counted "
                             f"{bench_k3_paths}")

    probe_launches = gather_probe_path()
    fuel = fuel_path(FUEL_ITERS, f"f32 full width, optim_iters cut to {FUEL_ITERS}", work)
    fuel_small_check()
    predicted = fuel["seconds"] * FUEL_ITERS_SHIPPED / FUEL_ITERS
    if predicted <= FULL_RUN_BUDGET_S:
        print(f"fuel: the {fuel['steps']}-step run took {fuel['seconds']:.1f} s, so the shipped "
              f"{FUEL_ITERS_SHIPPED} iterations a stage are predicted at {predicted:.0f} s: "
              "running them", flush=True)
        full_run = fuel_path(FUEL_ITERS_SHIPPED, "f32 full width, shipped optim_iters", work)
        print(f"fuel[shipped] {full_run['steps']} steps in {full_run['seconds']:.1f} s, "
              f"rel_norm {full_run['rel_norm']:.4f}", flush=True)
    else:
        print(f"fuel: the {fuel['steps']}-step run took {fuel['seconds']:.1f} s; the shipped "
              f"{FUEL_ITERS_SHIPPED} iterations a stage are predicted at {predicted:.0f} s, over "
              f"the {FULL_RUN_BUDGET_S:.0f} s kept for them: not run", flush=True)

    paths = {"bench": bench_launches, "probe": probe_launches, "fuel": fuel["launches"]}
    replaces = {
        "eval_grad": "adjointnonlinearraytracing_tpu/benchmarks/probe_evalmath.py:107",
        "trace_fwd": "adjointnonlinearraytracing_tpu/tracer/paired.py:64",
        "backtrace": "adjointnonlinearraytracing_tpu/tracer/paired.py:260",
        "gather_rows": "adjointnonlinearraytracing_tpu/benchmarks/probe_dma_gather.py:47",
    }
    errs = dict(zip(("eval_grad", "trace_fwd", "backtrace"), zip(cmp["abs_err"], cmp["rel_err"])))
    errs["gather_rows"] = (gather["max_abs_err"], gather["max_abs_err"])
    fuel_stage_ms = {
        "trace_fwd": {f"{st['res']}^3": st["k2_ms_median"] for st in fuel["per_stage"]},
        "backtrace": {f"{st['res']}^3": st["k3_ms_median"] for st in fuel["per_stage"]},
    }
    # tolerance on the error relative to the plain version's largest magnitude,
    # and the data-dependent work this run's inputs needed
    extra = {
        "eval_grad": {"rel_tol": TOL_F32_STATE, "points": NRAYS,
                      "launched_by": "fields.grid.eval_grad"},
        "trace_fwd": {"rel_tol": 0.0, **cmp["fstats"],
                      "ms_unordered": times["trace_fwd"]["ms_unordered"],
                      "order_ms": times["order_ms"],
                      "fuel_ms_by_stage": fuel_stage_ms["trace_fwd"],
                      "launched_by": "bench.run, tracer.api.trace, "
                                     "experiments.fuel_injection.run_opt"},
        "backtrace": {"rel_tol": TOL_F32_GRAD, **cmp["bstats"],
                      "atomic_adds": 8 * cmp["issued"],
                      "ms_unordered": times["backtrace"]["ms_unordered"],
                      "fuel_ms_by_stage": fuel_stage_ms["backtrace"],
                      "launches_by_k3_path": {"bench": bench_k3_paths,
                                              "fuel": fuel["k3_paths"]},
                      "stage_checks": stage_rows,
                      "launched_by": "bench.run, tracer.api.trace, "
                                     "experiments.fuel_injection.run_opt"},
        "gather_rows": {"rel_tol": 0.0, "rows": GATHER_N, "table_rows": GATHER_ROWS,
                        "launched_by": "benchmarks.probe_dma_gather.run"},
    }
    kernels = []
    for name in build.KERNELS:
        rec_k = times[name]
        by_path = {path: counts[name] for path, counts in paths.items()}
        if sum(by_path.values()) < 1:
            raise AssertionError(f"{name} was launched by none of the main paths")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"adjointnonlinearraytracing_tpu_torch/kernels/csrc/{name}.cu",
            "replaces": replaces[name], "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "launches_by_api_trace": after_trace[name],
            "max_abs_err": errs[name][0], "max_rel_err": errs[name][1], "ms": rec_k["ms"],
            "plain_ms": rec_k["plain_ms"], "bound_ms": rec_k["bound_ms"],
            "bound_by": rec_k["bound_by"], "share_of_bound": rec_k["bound_ms"] / rec_k["ms"],
            "library_ms": rec_k["library_ms"],
            **extra[name],
        })
    if failures:
        raise AssertionError("stage checks failed:\n" + "\n".join(failures))
    print(f"elapsed: {time.time() - t_start:.1f} s")
    print(smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
