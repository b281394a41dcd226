"""Times of the cable kernels' designs (K7-K10) on one card.

Run from the repo root on a machine with a CUDA device and ``nvcc``::

    python tools/cable_designs.py [--rounds N] [--reps N] [--out FILE] [--part PART]

``--part k7k8`` runs the K7 and K8 part described next, ``--part exact`` the
K9 and K10 part described after it; both by default.

It builds the shipped kernels and ``tools/cable_designs.cu`` (K7's and K8's
first designs, and the designs tried on the way to the shipped ones, which
no path of the port launches; the file lists them), holds the shipped f32
division and square root (``div_rn``, ``sqrt_rn`` of ``csrc/cylinder.cuh``)
bit for bit against the IEEE operators over every operand of the ranges the
kernels meet (:func:`arith_check`), checks the shipped K7-K10 against their
plain versions (``chip_smoke.cable_check``, f64 at 17 bins and f32 at 129),
checks every K7 design bit for bit against the shipped K7 and
every K8 design within 1e-5 of the shipped K8, and then times each, at block
sizes of 32, 64 and 128 threads, with ``chip_smoke.time_ms`` on a warm card,
round after round in turn, on two scenes at the fiber path's 129-bin stage:

* ``fixed``: ``chip_smoke.cable_scene(129, 4096, float32)``, the hop pass's
  targets, the cotangents of ``cable_check``;
* ``driver``: the profile at the end of a run of ``params-fiber.yaml``
  ``default`` through the runner, one draw of its source, both passes of a
  step (the near and the hop focus) and the cotangents of the driver's loss:
  as two launches of 4,096 rays (a pass each) and as one of 8,192.

For each design it also runs an instrumented copy in which every lane reads
``clock64()`` at the entry and the exit of its step loop, and reports the
cycles a step (mean over the lanes, largest, and the longest ray's steps);
and prints the registers and spills (``ptxas -v``) and, from ``cuobjdump
-sass``, the instructions of each f32 kernel that matter for a step's chain:
MUFU operations, the IEEE division and square-root checks (``FCHK``) and
their slow-path calls (``CALL``), convergence barriers (``BSSY``), shared
atomics (``ATOMS``, with ``.CAS``/``.CAST`` for the f64 adds), and the
global, shared and local (``LDL``, ``STL``) loads and stores.

The exact part builds ``tools/cable_exact_designs.cu`` (K9's and K10's
previous designs verbatim, and the K10 designs between them and the shipped one: per-lane
columns, the replayed positions in shared memory, the replay and the
adjoint as two warps, the adjoint evaluating a step ahead, each path; the
file lists them), checks each K9 design bit for bit against the shipped K9 (closest
approach, capture steps, every checkpoint row read) and each K10 design
within 1e-5 of the shipped K10, and times them beside the shipped K7, K9 and
K10 with ``clock64()`` cycles a step from the instrumented copies, on two
scenes of 8,192 rays at 129 bins: ``both``,
``chip_smoke.cable_scene(129, None, float32, both_passes=True)`` with
``cable_check``'s cotangents, and ``driver`` (below) with its loss's.
Ends with one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402  (exits without a CUDA device)
from kernel_info import demangle, ptxas_lines  # noqa: E402
from adjointnonlinearraytracing_tpu_torch.experiments import fiber, runner  # noqa: E402
from adjointnonlinearraytracing_tpu_torch.fields import cylinder as cyl  # noqa: E402
from adjointnonlinearraytracing_tpu_torch.fields import grid as G  # noqa: E402
from adjointnonlinearraytracing_tpu_torch.kernels import build  # noqa: E402
from adjointnonlinearraytracing_tpu_torch.kernels import wrappers as K  # noqa: E402
from adjointnonlinearraytracing_tpu_torch.tracer import api  # noqa: E402

SOURCE = Path(__file__).resolve().parent / "cable_designs.cu"
EXACT_SOURCE = Path(__file__).resolve().parent / "cable_exact_designs.cu"
K7_DESIGNS = {0: "first", 1: "table", 2: "early eval", 3: "table + early eval",
              4: "table, floor-convert", 5: "table, fast paths",
              6: "table, floor-convert, fast paths", 7: "table + early eval, fast paths"}
K8_DESIGNS = {0: "first", 1: "table, block runs", 2: "table + early, block runs",
              3: "table + early, warp runs", 4: "table + early, columns",
              5: "table + early, run columns", 6: "early, columns", 7: "table, columns",
              8: "table, columns, floor-convert", 9: "table, columns, fast paths",
              10: "table, columns, floor-convert, fast paths",
              11: "table + early, columns, fast paths", 12: "table, block runs, fast paths"}
#: the bin widths h = 1 / (res - 1) of every profile size up to this one take
#: the division check over every f32 significand
CHECK_RES_MAX = 4097
#: and these (none a power of two) over every exponent as well
CHECK_RES_SWEEP = (100, 854, 1000)
K9_DESIGNS = {0: "previous", 1: "segment loop (shipped)"}
K10_DESIGNS = {0: "previous", 1: "columns", 2: "columns, shared buffer", 3: "two roles",
               4: "two roles, block runs",
               5: "two roles, evaluation ahead (shipped columns)",
               6: "two roles, evaluation ahead, branch splat",
               7: "two roles, evaluation ahead, branch splat, block runs",
               8: "two roles, evaluation ahead, block runs (shipped block adjoint)"}
THREADS = (32, 64, 128)
TOL = 1e-5
SASS_OPS = ("MUFU", "FCHK", "CALL", "BSSY", "BRA", "ATOMS", "LDG", "LDS", "STS", "LDL", "STL",
            "DADD", "BAR")


def nvcc_lib(source):
    """Compile ``source`` as ``build.py`` compiles the shipped sources."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = build.BUILD_DIR / f"lib{source.stem}.so"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
                           str(out), str(source)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source.name}:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(out)), out, proc.stdout + proc.stderr


def build_exact_designs():
    lib, out, log = nvcc_lib(EXACT_SOURCE)
    vp, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.anrt_k9_design.argtypes = [i, i, vp, i, d, d, d, vp, vp, vp, vp, vp, vp, vp, vp, vp, i, i,
                                   i, vp]
    lib.anrt_k9_design.restype = i
    lib.anrt_k10_design.argtypes = [i, vp, i, d, d, d, vp, vp, vp, vp, vp, vp, i, i, i, vp]
    lib.anrt_k10_design.restype = i
    return lib, out, log


def build_designs():
    """Compile ``cable_designs.cu`` as ``build.py`` compiles the shipped sources."""
    lib, out, log = nvcc_lib(SOURCE)
    vp, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.anrt_k7_design.argtypes = [i, i, vp, i, d, d, d, vp, vp, vp, vp, vp, vp, vp, i, i, vp]
    lib.anrt_k7_design.restype = i
    lib.anrt_k8_design.argtypes = [i, i, vp, i, d, d, d, d, vp, vp, vp, vp, vp, vp, i, i, vp]
    lib.anrt_k8_design.restype = i
    lib.anrt_arith_check.argtypes = [i, ctypes.c_float, ctypes.c_uint, ctypes.c_uint, vp, vp]
    lib.anrt_arith_check.restype = i
    return lib, out, log


def f32_bits(x):
    return int(np.array([x], dtype=np.float32).view(np.uint32)[0])


def arith_check(lib):
    """``div_rn`` and ``sqrt_rn`` against the operators, bit for bit, on the
    card: the square root of every finite f32 >= 0; the quotient by the bin
    width h = 1 / (res - 1) of every profile of 2 .. ``CHECK_RES_MAX`` bins of
    every dividend in [1, 2) and (-2, -1] (every significand); for the widths
    of ``CHECK_RES_SWEEP`` every dividend of magnitude in [2^-100, 2^100] and,
    reported apart with the largest that differs, every one below 2^-100;
    2^30 random coordinate / radius pairs.  Returns, per check, the values
    that differ and the largest magnitude among them."""
    def run(mode, b, lo, hi):
        out = torch.zeros((2,), dtype=torch.int64, device="cuda")
        rc = lib.anrt_arith_check(mode, b, lo, hi, out.data_ptr(), stream())
        if rc != 0:
            raise RuntimeError(f"anrt_arith_check returned CUDA error {rc}")
        return out

    def result(out):
        n, worst = (int(v) for v in out.cpu())
        value = float(np.array([worst], dtype=np.uint32).view(np.float32)[0])
        return {"differ": n, "largest": value if n else None}
    lo, hi = f32_bits(2.0 ** -100), f32_bits(2.0 ** 100)
    res = {"sqrt_all_finite": result(run(0, 0.0, 0, f32_bits(np.inf))),
           "div_random_pairs": result(run(2, 0.0, 0, 1 << 30))}
    total = torch.zeros((2,), dtype=torch.int64, device="cuda")
    for r in range(2, CHECK_RES_MAX + 1):
        out = run(1, float(np.float32(1.0 / (r - 1))), f32_bits(1.0), f32_bits(2.0))
        total[0] += out[0]
        total[1] = torch.maximum(total[1], out[1])
    res[f"div_h_res2_to_{CHECK_RES_MAX}_significands"] = result(total)
    for r in CHECK_RES_SWEEP:
        h = float(np.float32(1.0 / (r - 1)))
        res[f"div_h_res{r}_2^-100_to_2^100"] = result(run(1, h, lo, hi))
        res[f"div_h_res{r}_below_2^-100"] = result(run(1, h, 1, lo))
    return res


def machine_code(lib_path):
    """Counts of the instructions in ``SASS_OPS`` per f32 kernel of a library,
    by full opcode (``MUFU.RSQ``, ``ATOMS.CAST.SPIN.64``, ...), and the total."""
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    counts = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name = demangle(part.split("\n", 1)[0].strip())
        if "<double" in name or not any(k in name for k in ("cable", "k7<", "k8<", "two_roles",
                                                             "k9_")):
            continue
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", part)
        kinds = {"total": len(ops)}
        for op in ops:
            if op.split(".")[0] in SASS_OPS:
                kinds[op] = kinds.get(op, 0) + 1
        counts[name] = kinds
    return counts


def stream():
    return torch.cuda.current_stream().cuda_stream


def k7_design(lib, num, threads, s, x, v, tg, clock=False):
    def run():
        prof = s["prof"]
        n = x.shape[0]
        xt, vt = torch.empty_like(x), torch.empty_like(v)
        d2 = torch.empty((n,), dtype=prof.dtype, device="cuda")
        clk = torch.zeros((n, 2), dtype=torch.int64, device="cuda") if clock else None
        rc = lib.anrt_k7_design(num, threads, prof.data_ptr(), prof.shape[0], s["radius"],
                                s["length"], s["ds"], x.data_ptr(), v.data_ptr(), tg.data_ptr(),
                                xt.data_ptr(), vt.data_ptr(), d2.data_ptr(),
                                None if clk is None else clk.data_ptr(), n, s["steps"], stream())
        if rc != 0:
            raise RuntimeError(f"anrt_k7_design({num}, {threads}) returned CUDA error {rc}")
        return (xt, vt, d2, clk) if clock else (xt, vt, d2)
    return run


def k8_design(lib, num, threads, s, xt, vt, dx, dv, clock=False):
    def run():
        prof = s["prof"]
        n = xt.shape[0]
        g = torch.zeros((prof.shape[0],), dtype=torch.float64, device="cuda")
        clk = torch.zeros((n, 2), dtype=torch.int64, device="cuda") if clock else None
        rc = lib.anrt_k8_design(num, threads, prof.data_ptr(), prof.shape[0], s["radius"],
                                s["length"], s["ds"], s["cap"], xt.data_ptr(), vt.data_ptr(),
                                dx.data_ptr(), dv.data_ptr(), g.data_ptr(),
                                None if clk is None else clk.data_ptr(), n, s["steps"], stream())
        if rc != 0:
            raise RuntimeError(f"anrt_k8_design({num}, {threads}) returned CUDA error {rc}")
        return (g, clk) if clock else g
    return run


def cycles(clk):
    """Cycles a step from an instrumented launch: mean over the lanes that
    stepped, the largest, and the longest ray's steps and cycles a step."""
    c, n = clk[:, 0].double(), clk[:, 1].double()
    live = n > 0
    per = c[live] / n[live]
    longest = int(torch.argmax(n))
    return dict(mean=float(per.mean()), max=float(per.max()),
                longest_steps=int(n[longest]),
                longest_cycles_per_step=float(c[longest] / max(n[longest], 1.0)),
                all_steps=int(n.sum()), cycles_per_all_steps=float(c[live].sum() / n.sum()))


def fixed_scene():
    s = CS.cable_scene(129, CS.FIBER_RAYS, torch.float32)
    s["cap"] = G.snap_tol(torch.float32) * s["radius"]
    xt, vt, _ = K.trace_cable(s["prof"], s["radius"], s["length"], s["x"], s["v"], s["target"],
                              s["ds"], s["steps"])
    s.update(xt=xt, vt=vt, dx=(2.0 * (xt - s["target"])).contiguous(), dv=torch.ones_like(vt))
    return s


def driver_scene():
    """The end-of-run profile of ``params-fiber.yaml`` ``default``, one draw of
    its rays, both passes concatenated (near first) with the loss's cotangents."""
    params = CS.fiber_params()
    eta, _ = runner.run(os.path.join(CS.CONFIGS, CS.FIBER_YAML), None, device="cuda")
    radius, length = params["cable_radius"], params["cable_length"]
    hop, weight = params.get("hop_distance", 3.14), params.get("hop_weight", 0.1)
    eps, span = params.get("plane_epsilon", 1e-3), params.get("camera_span", radius)
    rays = fiber.gen_start_rays(params, torch.Generator(device="cuda").manual_seed(4242))
    prof = eta.detach().contiguous()
    field = cyl.CylinderField(prof, radius, length)
    v = rays.v / cyl.cyl_eval_grad(field, rays.x)[0][:, None]
    sn, p0 = rays.planes[:, 1], rays.planes[:, 0]
    x2 = torch.cat([rays.x, rays.x]).contiguous()
    v2 = torch.cat([v, v]).contiguous()
    tg = torch.cat([p0 + 0.0 * sn, p0 + hop * sn]).contiguous()
    ds = radius / prof.shape[0] / 2
    s = dict(prof=prof, radius=radius, length=length, ds=ds, steps=api.cable_steps(length, ds),
             cap=G.snap_tol(prof.dtype) * radius, x=x2, v=v2, target=tg)
    xt, vt, d2 = K.trace_cable(prof, radius, length, x2, v2, tg, ds, s["steps"])
    mask2 = torch.cat([rays.mask, rays.mask])
    w = torch.cat([torch.ones_like(d2[:x2.shape[0] // 2]),
                   torch.full_like(d2[:x2.shape[0] // 2], weight)])
    nrays = torch.clamp(rays.mask.sum(), min=1)
    keep = ((d2 > eps ** 2) & mask2)[:, None]
    dx = torch.where(keep, 2.0 * (xt - tg), torch.zeros_like(xt)) * (w / nrays / radius
                                                                     / span)[:, None]
    s.update(xt=xt, vt=vt, dx=dx.contiguous(), dv=torch.zeros_like(vt))
    return s


def time_rounds(fns, args):
    """Median ms of each function over ``args.rounds`` rounds, all in turn each round."""
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for _ in range(args.rounds):
        for name, fn in fns.items():
            times[name].append(CS.time_ms(fn, args.reps))
    return {name: sorted(t)[len(t) // 2] for name, t in times.items()}, times


def report(label, s, fns, med, clocks):
    print(f"{label} ({s['x'].shape[0]} rays, {s['prof'].shape[0]} bins):", flush=True)
    for name in fns:
        c = clocks.get(name)
        print(f"  {name}: {med[name]:.4f} ms"
              + (f"; cycles a step mean {c['mean']:.0f}, max {c['max']:.0f}, longest ray "
                 f"{c['longest_steps']} steps at {c['longest_cycles_per_step']:.0f}, "
                 f"all {c['cycles_per_all_steps']:.0f}" if c else ""), flush=True)


def k7k8_part(lib, scenes, args):
    """The K7 and K8 designs on the ``fixed`` and ``driver`` scenes."""
    results = []
    for label, s in scenes:
        prof, radius, length, ds, steps = s["prof"], s["radius"], s["length"], s["ds"], s["steps"]
        x, v, tg, xt, vt, dx, dv = (s[k] for k in ("x", "v", "target", "xt", "vt", "dx", "dv"))
        fns, clocks, errs = {}, {}, {}
        fns["K7 shipped"] = lambda: K.trace_cable(prof, radius, length, x, v, tg, ds, steps)
        fns["K8 shipped"] = lambda: K.backtrace_cable(prof, radius, length, xt, vt, dx, dv, ds,
                                                      steps, s["cap"])
        if label == "driver":  # the two passes as two launches, a pass each, as before
            half = x.shape[0] // 2
            parts = [(a[:half].contiguous(), a[half:].contiguous())
                     for a in (x, v, tg, xt, vt, dx, dv)]
            (xa, xb), (va, vb), (ta, tb), (xta, xtb), (vta, vtb), (dxa, dxb), (dva, dvb) = parts
            fns["K7 shipped, two launches"] = lambda: (
                K.trace_cable(prof, radius, length, xa, va, ta, ds, steps),
                K.trace_cable(prof, radius, length, xb, vb, tb, ds, steps))
            fns["K8 shipped, two launches"] = lambda: (
                K.backtrace_cable(prof, radius, length, xta, vta, dxa, dva, ds, steps, s["cap"]),
                K.backtrace_cable(prof, radius, length, xtb, vtb, dxb, dvb, ds, steps,
                                  s["cap"]))
            s_half = dict(s, x=xb)
            fns["K7 first, two launches"] = lambda: (
                k7_design(lib, 0, 128, s_half, xa, va, ta)(),
                k7_design(lib, 0, 128, s_half, xb, vb, tb)())
            fns["K8 first, two launches"] = lambda: (
                k8_design(lib, 0, 128, s_half, xta, vta, dxa, dva)(),
                k8_design(lib, 0, 128, s_half, xtb, vtb, dxb, dvb)())
        ref7 = fns["K7 shipped"]()
        ref8 = fns["K8 shipped"]()
        scale = max(float(ref8.abs().max()), 1e-300)
        for num, name in K7_DESIGNS.items():
            for th in THREADS:
                key = f"K7 {name} @{th}"
                fns[key] = k7_design(lib, num, th, s, x, v, tg)
                out = fns[key]()
                if not all(torch.equal(a, b) for a, b in zip(out, ref7)):
                    raise AssertionError(f"{key} differs from the shipped K7 at {label}")
                clocks[key] = cycles(k7_design(lib, num, th, s, x, v, tg, clock=True)()[3])
        for num, name in K8_DESIGNS.items():
            for th in THREADS:
                key = f"K8 {name} @{th}"
                fns[key] = k8_design(lib, num, th, s, xt, vt, dx, dv)
                errs[key] = float((fns[key]() - ref8).abs().max()) / scale
                if errs[key] > TOL:
                    raise AssertionError(f"{key} is {errs[key]:.3e} from the shipped K8 at "
                                         f"{label}")
                clocks[key] = cycles(k8_design(lib, num, th, s, xt, vt, dx, dv, clock=True)()[1])
        med, times = time_rounds(fns, args)
        results.append(dict(scene=label, rays=x.shape[0], res=prof.shape[0], steps=steps, ms=med,
                            all=times, cycles=clocks, rel_err_to_shipped_k8=errs))
        report(label, s, fns, med, clocks)
    return results


def k9_design(lib, num, threads, s, clock=False):
    def run():
        prof, x = s["prof"], s["x"]
        n, nseg = x.shape[0], -(-s["steps"] // CS.SEG)
        xt, vt = torch.empty_like(x), torch.empty_like(x)
        d2 = torch.empty((n,), dtype=prof.dtype, device="cuda")
        c = torch.empty((n,), dtype=torch.int32, device="cuda")
        ck = torch.empty((nseg, K.CKPT_WIDTH, n), dtype=prof.dtype, device="cuda")
        clk = torch.zeros((n, 2), dtype=torch.int64, device="cuda") if clock else None
        rc = lib.anrt_k9_design(num, threads, prof.data_ptr(), prof.shape[0], s["radius"],
                                s["length"], s["ds"], x.data_ptr(), s["v"].data_ptr(),
                                s["target"].data_ptr(), xt.data_ptr(), vt.data_ptr(),
                                d2.data_ptr(), c.data_ptr(), ck.data_ptr(),
                                None if clk is None else clk.data_ptr(), n, s["steps"], CS.SEG,
                                stream())
        if rc != 0:
            raise RuntimeError(f"anrt_k9_design({num}, {threads}) returned CUDA error {rc}")
        return xt, vt, d2, c, ck, clk
    return run


def k10_design(lib, num, s, ck, c, clock=False):
    def run():
        prof, n = s["prof"], s["x"].shape[0]
        g = torch.zeros((prof.shape[0],), dtype=torch.float64, device="cuda")
        clk = torch.zeros((n, 2), dtype=torch.int64, device="cuda") if clock else None
        rc = lib.anrt_k10_design(num, prof.data_ptr(), prof.shape[0], s["radius"], s["length"],
                                 s["ds"], ck.data_ptr(), c.data_ptr(), s["dx"].data_ptr(),
                                 s["dv"].data_ptr(), g.data_ptr(),
                                 None if clk is None else clk.data_ptr(), n, ck.shape[0], CS.SEG,
                                 stream())
        if rc != 0:
            raise RuntimeError(f"anrt_k10_design({num}) returned CUDA error {rc}")
        return (g, clk) if clock else g
    return run


def exact_part(lib, scenes, args):
    """The K9 and K10 designs beside the shipped K7, K9 and K10."""
    results = []
    for label, s in scenes:
        prof, radius, length, ds, steps = s["prof"], s["radius"], s["length"], s["ds"], s["steps"]
        x, v, tg, dx, dv = (s[k] for k in ("x", "v", "target", "dx", "dv"))
        ref9 = K.trace_cable_ckpt(prof, radius, length, x, v, tg, ds, steps, CS.SEG)
        c, ck = ref9[3], ref9[4]
        need = (torch.arange(ck.shape[0], device="cuda")[:, None] * CS.SEG) < c[None, :]
        fns, clocks, errs = {}, {}, {}
        fns["K7 shipped"] = lambda: K.trace_cable(prof, radius, length, x, v, tg, ds, steps)
        fns["K9 shipped"] = lambda: K.trace_cable_ckpt(prof, radius, length, x, v, tg, ds, steps,
                                                       CS.SEG)
        fns["K10 shipped"] = lambda: K.backtrace_cable_exact(prof, radius, length, ck, c, dx, dv,
                                                             ds, CS.SEG)
        ref10 = fns["K10 shipped"]()
        scale = max(float(ref10.abs().max()), 1e-300)
        for num, name in K9_DESIGNS.items():
            for th in THREADS:
                key = f"K9 {name} @{th}"
                fns[key] = k9_design(lib, num, th, s)
                out = fns[key]()
                same = all(torch.equal(a, b) for a, b in zip(out[:4], ref9[:4])) and torch.equal(
                    out[4].transpose(1, 2)[need], ck.transpose(1, 2)[need])
                if not same:
                    raise AssertionError(f"{key} differs from the shipped K9 at {label}")
                clocks[key] = cycles(k9_design(lib, num, th, s, clock=True)()[5])
        for num, name in K10_DESIGNS.items():
            key = f"K10 {name}"
            fns[key] = k10_design(lib, num, s, ck, c)
            errs[key] = float((fns[key]() - ref10).abs().max()) / scale
            if errs[key] > TOL:
                raise AssertionError(f"{key} is {errs[key]:.3e} from the shipped K10 at {label}")
            clocks[key] = cycles(k10_design(lib, num, s, ck, c, clock=True)()[1])
        med, times = time_rounds(fns, args)
        results.append(dict(scene=label, rays=x.shape[0], res=prof.shape[0], steps=steps, ms=med,
                            all=times, cycles=clocks, rel_err_to_shipped_k10=errs,
                            k10_gated_steps=int(c.sum()), max_c=int(c.max())))
        report(label, s, fns, med, clocks)
    return results


def both_scene():
    """A fiber step's two passes on the ground truth plus 1 %: ``cable_check``'s
    full-width scene and cotangents."""
    s = CS.cable_scene(129, None, torch.float32, both_passes=True)
    xt, _, _ = K.trace_cable(s["prof"], s["radius"], s["length"], s["x"], s["v"], s["target"],
                             s["ds"], s["steps"])
    s.update(dx=(2.0 * (xt - s["target"])).contiguous(), dv=torch.ones_like(xt))
    return s


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--part", choices=("all", "k7k8", "exact"), default="all")
    ap.add_argument("--out", default=None, help="also write the JSON line to this file")
    ap.add_argument("--sass", default=None,
                    help="also write the machine code of each library to this directory")
    args = ap.parse_args(argv)
    parts = ("k7k8", "exact") if args.part == "all" else (args.part,)

    card = CS.smi_line()
    print(f"device: {card}", flush=True)
    for name in build.KERNELS:
        build.load(name)
    libs, logs = {}, []
    if "k7k8" in parts:
        libs["k7k8"], lib_path, log = build_designs()
        logs.append((lib_path, log))
    if "exact" in parts:
        libs["exact"], lib_path, log = build_exact_designs()
        logs.append((lib_path, log))
    regs = [line for _, log in logs for line in ptxas_lines(log)]
    for name, text in build.build_logs().items():
        if "cable" in name:
            regs += [f"[{name}] {line}" for line in ptxas_lines(text)]
    for line in regs:
        print(f"ptxas {line}")
    sass = {}
    paths = [Path(build.load(n)._name) for n in ("trace_cable", "backtrace_cable",
                                                 "backtrace_cable_exact")]
    for path in paths + [p for p, _ in logs]:
        sass.update(machine_code(path))
        if args.sass:
            Path(args.sass).mkdir(parents=True, exist_ok=True)
            cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
            text = subprocess.run([str(cuobjdump), "-sass", str(path)], capture_output=True,
                                  text=True, check=True).stdout
            (Path(args.sass) / f"{path.stem}.sass").write_text(demangle(text))
    for name, ops in sass.items():
        print(f"sass {name}: {ops}")

    arith = None
    if "k7k8" in parts:
        arith = arith_check(libs["k7k8"])
        print(f"div_rn, sqrt_rn against the operators (values that differ in any bit): {arith}",
              flush=True)
        if any(v["differ"] for k, v in arith.items() if "below" not in k):
            raise AssertionError(f"div_rn or sqrt_rn differs from the IEEE operators: {arith}")

    # the shipped K7-K10 against their plain versions first
    checks = {}
    for label, sc in (("f64 17 bins", CS.cable_scene(*CS.CABLE_SMALL, torch.float64)),
                      ("f32 129 bins", CS.cable_scene(129, None, torch.float32))):
        row, failures = CS.cable_check(sc, label, times=label.startswith("f32"))
        if failures:
            raise AssertionError("\n".join(failures))
        checks[label] = row
    CS.cable_api_check()

    driver = driver_scene()
    results = []
    if "k7k8" in parts:
        results += k7k8_part(libs["k7k8"], (("fixed", fixed_scene()), ("driver", driver)), args)
    if "exact" in parts:
        results += exact_part(libs["exact"], (("both", both_scene()), ("driver", driver)), args)
    clocks_line = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(f"clocks (sm, max sm) after the runs: {clocks_line}")
    print(card)
    line = json.dumps({"card": card, "rounds": args.rounds, "reps": args.reps, "sass": sass,
                       "ptxas": regs, "arith_check": arith, "checks": checks,
                       "results": results})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(json.dumps({"card": card, "ms": [{r["scene"]: r["ms"]} for r in results]}))


if __name__ == "__main__":
    main()
