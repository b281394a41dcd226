"""Times of K6 ``backtrace_exact``'s and K5 ``trace_ckpt``'s designs, and of K2, K3 beside them, on one card.

Run from the repo root on a machine with a CUDA device and ``nvcc``::

    python tools/k6_designs.py [--rounds N] [--reps N] [--out FILE]

It builds the shipped kernels and ``tools/k6_designs.cu`` (K5's and K6's
first designs, parts of K6's, and the designs tried on the way to the
shipped ones, which no path of the port launches; the file lists them), and
at the bench
scene (``chip_smoke.py``'s: 128^3 f32, 2^18 rays, ``ds = h/2``) and at each
stage grid of the fuel trainer (3^3 .. 65^3, the run's 262,144 rays, ``ds =
1/128``, ``chip_smoke.stage_checks``'s scene and cotangents) times, with
``chip_smoke.time_ms`` on a warm card, round after round in turn:

* the shipped K6 (``kernels.wrappers.backtrace_exact``: global path, the
  lanes of a warp in step) and K6's first design on the path K3's rule
  gives (``wrappers.backtrace_path``); where that is the shared path, each
  on the other path too, and the first design with the L1 carve-out hint;
* the designs between them: the corner cache in the replay and the backward
  step, or in the replay only, each also in a kernel that holds 4 blocks
  an SM; the lanes in step with the cache; stretches of 16 steps; "evaluate
  once";
* the first design's replay with its local buffer and without it;
* the shipped K5, its first design, and the shipped one with the corner
  cache or with streaming checkpoint stores; K2 ``trace_fwd`` and K3 ``backtrace`` (also on
  the global path where K3 takes the shared one) on the same rays, as
  ``api.trace`` and ``trace_exact`` launch them (with the ray order).

Checks first: every K5 design's exit state, capture steps and the checkpoint
entries the backward pass reads equal the shipped K5's bit for bit, and its
exit state K2's; every K6 design is within 1e-5 of the shipped K6's largest
entry.  Prints registers, stack and spills (``ptxas -v``) and the global,
local and shared memory instructions in the machine code (``cuobjdump
-sass``) of each f32 kernel, the card, and one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402  (exits without a CUDA device)
from adjointnonlinearraytracing_tpu_torch.experiments import (  # noqa: E402
    fuel_injection, voxel_scenes)
from adjointnonlinearraytracing_tpu_torch.fields import grid as G  # noqa: E402
from adjointnonlinearraytracing_tpu_torch.kernels import build  # noqa: E402
from adjointnonlinearraytracing_tpu_torch.kernels import wrappers as K  # noqa: E402
from adjointnonlinearraytracing_tpu_torch.tracer import eikonal as E  # noqa: E402
from adjointnonlinearraytracing_tpu_torch.tracer import order as O  # noqa: E402

SOURCE = Path(__file__).resolve().parent / "k6_designs.cu"
#: anrt_k6_design's design numbers (see k6_designs.cu)
(FIRST, REPLAY_BUFFERED, REPLAY_ONLY, FIRST_L1, STRETCH_16, EVALUATE_ONCE, UNALIGNED,
 REPLAY_CACHED, REPLAY_CACHED_4_BLOCKS, UNALIGNED_4_BLOCKS, SHIPPED_IN_SHELL,
 ALIGNED_CACHED) = range(12)
#: anrt_k5_design's
K5_FIRST, K5_CACHED, K5_STREAMING = range(3)
TOL = 1e-5


def build_designs():
    """Compile ``k6_designs.cu`` as ``build.py`` compiles the shipped sources."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = build.BUILD_DIR / "libk6_designs.so"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
                           str(out), str(SOURCE)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SOURCE.name}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    vp, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.anrt_k6_design.argtypes = [i, vp, i, i, i, d, d, vp, vp, vp, vp, vp, vp, vp, vp, i, i,
                                   i, i, vp]
    lib.anrt_k6_design.restype = i
    lib.anrt_k5_design.argtypes = [i, vp, i, i, i, d, d, vp, vp, vp, vp, vp, vp, vp, vp, i, i,
                                   i, vp]
    lib.anrt_k5_design.restype = i
    return lib, out, proc.stdout + proc.stderr


def demangle(text):
    """``text`` with the C++ names in it demangled, where the toolkit has cu++filt."""
    tool = Path(build._nvcc()).with_name("cu++filt")
    if not tool.exists():
        return text
    names = sorted(set(re.findall(r"_Z\w+", text)), key=len, reverse=True)
    if not names:
        return text
    out = subprocess.run([str(tool), *names], capture_output=True, text=True)
    if out.returncode != 0:
        return text
    for name, plain in zip(names, out.stdout.splitlines()):
        text = text.replace(name, plain)
    return text


def ptxas_lines(log):
    """The registers, stack and spills ``ptxas -v`` reported for each kernel."""
    lines, entry = [], None
    for line in demangle(log).splitlines():
        line = line.strip()
        m = re.search(r"Compiling entry function '(.*)' for", line)
        if m:
            entry = m.group(1)
        elif entry and ("registers" in line or "stack frame" in line):
            lines.append(f"{entry}: {line.split(':', 1)[-1].strip()}")
    return lines


def machine_code(lib_path):
    """Memory instructions per f32 kernel of a library, from ``cuobjdump -sass``."""
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    counts = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name = demangle(part.split("\n", 1)[0].strip())
        if "double" in name:
            continue
        ops = re.findall(r"\*/\s+(?:@!?P\w+\s+)?((?:LDG|STG|LDL|STL|LDS|STS|ATOMS|ATOMG|RED)"
                         r"[\w.]*)", part)
        kinds = {}
        for op in ops:
            kinds[op.split(".")[0]] = kinds.get(op.split(".")[0], 0) + 1
        counts[name] = kinds
    return counts


def scenes():
    """The bench scene and the fuel stages: (label, rif, h, ds, x0, v0, cot)."""
    s = CS.scene(CS.RES, CS.NRAYS, "float32")
    yield (f"bench {CS.RES}^3", s["rif"], s["h"], s["ds"], s["x0"], s["v0"],
           lambda xt, vt: (2.0 * (xt - s["target"]), torch.ones_like(vt)))
    params = CS.fuel_params()
    res_list, span = params["res_list"], params["vol_span"]
    ds = span / (res_list[-1] - 1) / params["step_res"]
    gt = voxel_scenes.fuel_injection_rif(params["fuel_val"], torch.float64, "cuda")
    rays, _ = fuel_injection.gen_start_rays(
        params, torch.Generator(device="cuda").manual_seed(params["seed"]), torch.float32)
    x0, v0 = rays.x.contiguous(), rays.v.contiguous()
    for res in res_list:
        rif = G.upres_volume(gt, res).to(torch.float32).contiguous()
        yield (f"fuel {res}^3", rif, span / (res - 1), ds, x0, v0,
               lambda xt, vt: (2.0 * (xt - 0.5), torch.ones_like(vt)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None, help="also write the JSON line to this file")
    args = ap.parse_args(argv)

    for name in build.KERNELS:
        build.load(name)
    lib, lib_path, log = build_designs()
    for line in ptxas_lines(log):
        print(f"ptxas[k6_designs] {line}")
    for name, text in build.build_logs().items():
        if name in ("trace_fwd", "backtrace", "backtrace_exact"):
            for line in ptxas_lines(text):
                print(f"ptxas[{name}] {line}")
    sass = {}
    for lib_name in ("trace_fwd", "backtrace", "backtrace_exact"):
        sass.update(machine_code(Path(build.load(lib_name)._name)))
    sass.update(machine_code(lib_path))
    for name, ops in sass.items():
        print(f"sass {name}: {ops}")

    k3_lib = build.load("backtrace")
    k3_fn = k3_lib.anrt_backtrace
    k3_fn.argtypes = K._ARGTYPES["backtrace"]
    k3_fn.restype = ctypes.c_int
    results = []
    for label, rif, h, ds, x0, v0, cot in scenes():
        steps = E.max_steps_fwd(max(rif.shape), h, ds)
        nb = E.max_steps_bwd(max(rif.shape), h, ds)
        order = O.ray_order(x0, v0, rif.shape, h)
        xt, vt, c, code, ck = K.trace_ckpt(rif, h, x0, v0, ds, steps, CS.SEG, order)
        ck_first = ck.transpose(1, 2).contiguous()  # the first design's layout, (nseg, n, 7)
        dx, dv = cot(xt, vt)
        dv_k = torch.where((code != 0)[:, None], dv, torch.zeros_like(dv))
        k3_path = K.backtrace_path(rif.numel(), rif.dtype)
        depth, height, width = rif.shape
        stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

        def design(num, shared, ckpts):
            def run():
                out = torch.zeros(rif.numel(), dtype=rif.dtype, device="cuda")
                rc = lib.anrt_k6_design(num, rif.data_ptr(), width, height, depth, float(h),
                                        float(ds), ckpts.data_ptr(), order.data_ptr(),
                                        c.data_ptr(), code.data_ptr(), dx.data_ptr(),
                                        dv_k.data_ptr(), out.data_ptr(), None, order.shape[0],
                                        ckpts.shape[0], CS.SEG, int(shared), stream())
                if rc != 0:
                    raise RuntimeError(f"anrt_k6_design({num}) returned CUDA error {rc}")
                return out
            return run

        def k5_design(which, layout):
            def run():
                outs = (torch.empty_like(x0), torch.empty_like(v0), torch.empty_like(c),
                        torch.empty_like(code), torch.empty_like(layout))
                rc = lib.anrt_k5_design(which, rif.data_ptr(), width, height, depth, float(h),
                                        float(ds), x0.data_ptr(), v0.data_ptr(),
                                        order.data_ptr(), *(t.data_ptr() for t in outs),
                                        x0.shape[0], steps, CS.SEG, stream())
                if rc != 0:
                    raise RuntimeError(f"anrt_k5_design({which}) returned CUDA error {rc}")
                return outs
            return run

        k5_first = k5_design(K5_FIRST, ck_first)
        k5_others = {"K5 with the cache": k5_design(K5_CACHED, ck),
                     "K5 streaming stores": k5_design(K5_STREAMING, ck)}

        def k3_global():
            out = torch.zeros(rif.numel(), dtype=rif.dtype, device="cuda")
            rc = k3_fn(0, rif.data_ptr(), width, height, depth, float(h), float(ds),
                       float(G.snap_tol(rif.dtype)), xt.data_ptr(), vt.data_ptr(),
                       dx.data_ptr(), dv.data_ptr(), order.data_ptr(), out.data_ptr(), None,
                       x0.shape[0], nb, 0, stream())
            if rc != 0:
                raise RuntimeError(f"anrt_backtrace returned CUDA error {rc}")
            return out

        shared = k3_path == "shared"
        fns = {"K6 shipped": lambda: K.backtrace_exact(rif, h, ck, c, code, dx, dv_k, ds,
                                                       CS.SEG, order),
               "K6 first design": design(FIRST, shared, ck_first),
               "K6 in step, with the cache": design(ALIGNED_CACHED, False, ck),
               "K6 cache, lanes apart": design(UNALIGNED, False, ck),
               "K6 cache, lanes apart, 4 blocks": design(UNALIGNED_4_BLOCKS, False, ck),
               "K6 replay cache, lanes apart": design(REPLAY_CACHED, False, ck),
               "K6 replay cache, lanes apart, 4 blocks": design(REPLAY_CACHED_4_BLOCKS, False,
                                                                ck)}
        if shared:
            fns["K6 shipped, shared path"] = design(SHIPPED_IN_SHELL, True, ck)
            fns["K6 cache, lanes apart, shared path"] = design(UNALIGNED, True, ck)
            fns["K6 first design, global path"] = design(FIRST, False, ck_first)
            fns["K6 first design, L1 carve-out"] = design(FIRST_L1, True, ck_first)
        fns["K6 stretch 16"] = design(STRETCH_16, False, ck)
        fns["K6 evaluate once"] = design(EVALUATE_ONCE, False, ck)
        fns["replay + buffer"] = design(REPLAY_BUFFERED, shared, ck_first)
        fns["replay alone"] = design(REPLAY_ONLY, shared, ck_first)
        fns["K5 shipped"] = lambda: K.trace_ckpt(rif, h, x0, v0, ds, steps, CS.SEG, order)
        fns["K5 first design"] = k5_first
        fns.update(k5_others)
        fns["K2 trace_fwd"] = lambda: K.trace_fwd(rif, h, x0, v0, ds, steps, order)
        fns["K3 backtrace"] = lambda: K.backtrace(rif, h, xt, vt, dx, dv, ds, nb,
                                                  G.snap_tol(rif.dtype), order)
        if shared:
            fns["K3 backtrace, global path"] = k3_global

        # checks
        live = torch.where(code == 2, 0, c)[order.long()]
        need = (torch.arange(ck.shape[0], device="cuda")[:, None] * CS.SEG) < live[None, :]
        for name, fn in k5_others.items():
            xt_u, vt_u, c_u, code_u, ck_u = fn()
            if not (torch.equal(xt, xt_u) and torch.equal(vt, vt_u) and torch.equal(c, c_u)
                    and torch.equal(code, code_u) and torch.equal(ck.transpose(1, 2)[need],
                                                                  ck_u.transpose(1, 2)[need])):
                raise AssertionError(f"{name} differs from the shipped K5 at {label}")
        xt_4, vt_4, c_4, code_4, ck_4 = k5_first()
        xt_2, vt_2 = fns["K2 trace_fwd"]()
        k5_equal = dict(
            exit_state=bool(torch.equal(xt, xt_4) and torch.equal(vt, vt_4)),
            exit_state_k2=bool(torch.equal(xt, xt_2) and torch.equal(vt, vt_2)),
            capture_steps=bool(torch.equal(c, c_4) and torch.equal(code, code_4)),
            checkpoints=bool(torch.equal(ck.transpose(1, 2)[need], ck_4[need])))
        if not all(k5_equal.values()):
            raise AssertionError(f"the shipped K5 differs from its first design at {label}: "
                                 f"{k5_equal}")
        ref = fns["K6 shipped"]()
        scale = max(1.0, float(ref.abs().max()))
        errs = {}
        for name in [n for n in fns if n.startswith("K6 ")]:
            errs[name] = float((fns[name]() - ref).abs().max()) / scale
            if errs[name] > TOL:
                raise AssertionError(f"{name} at {label} is {errs[name]:.3e} from the shipped K6")
        if shared:
            k3 = fns["K3 backtrace"]()
            errs["K3 global path vs shared"] = float((k3_global() - k3).abs().max()) / max(
                1.0, float(k3.abs().max()))
        torch.cuda.synchronize()
        times = {name: [] for name in fns}
        for _ in range(args.rounds):
            for name, fn in fns.items():
                times[name].append(CS.time_ms(fn, args.reps))
        med = {name: sorted(t)[len(t) // 2] for name, t in times.items()}
        row = dict(scene=label, k3_path=k3_path, rays=x0.shape[0], ms=med, all=times,
                   rel_err_to_shipped=errs, k5_bitwise=k5_equal)
        results.append(row)
        print(f"{label} (K3's path {k3_path}): "
              + "; ".join(f"{n} {t:.4f}" for n, t in med.items())
              + f" ms; K5 + K3 {med['K5 shipped'] + med['K3 backtrace']:.4f} ms; K5 bitwise "
              f"equal to its first design {k5_equal}; errors to the shipped K6 {errs}",
              flush=True)
        del ck, ck_first, ck_4, ck_u, xt, vt
    card = CS.smi_line()
    print(card)
    line = json.dumps({"card": card, "rounds": args.rounds, "reps": args.reps, "sass": sass,
                       "results": results})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(json.dumps({"card": card, "ms": {r["scene"]: r["ms"] for r in results}}))


if __name__ == "__main__":
    main()
