"""The split of the sdf kernels (K14, K17; K13 and K19 beside them), one card.

Run from the repo root on a machine with a CUDA device and ``nvcc``::

    python tools/sdf_designs.py [--rounds N] [--reps N] [--out FILE]

It builds the shipped kernels and ``tools/sdf_designs.cu`` (the split's
variants, which include the shipped headers and instantiate the shipped
forward loop and exact backward ray; no path of the port launches them)
and, on configuration 9's and 11's sdf batch (``chip_smoke.variant_scene``:
the bench scene, 128^3 f32, 2^18 rays spawned on the radius-0.4 sphere sdf,
``seg`` 32), times with ``chip_smoke.time_ms`` on a warm card, round after
round in turn:

* K14 ``backtrace_sdf`` as shipped, and its split: (a) the ray before the
  redesign (the sdf read with a stencil of its own, f64 run and warp sums),
  (b) no sdf read (each ray stopped at (a)'s step), (c) no run and no adds,
  (d) the run and the warp sums but no adds, (e) one stencil for both
  grids, both corner sets loaded before either is used, (f) f32 run and
  warp sums with f64 adds, and (e)+(f);
* K17 ``trace_sdf_ckpt`` as shipped and under each sdf read (its own
  stencil, one stencil, one stencil with both corner sets loaded together),
  with the horizons made between the passes by torch (as before the
  redesign) or in the kernel, with and without checkpoint stores; for each,
  pass 1, the torch work between the passes and pass 2 apart (CUDA events
  around each, the card kept busy before);
* K13 ``trace_sdf`` (the same loop without checkpoints) as shipped and
  under each read;
* K19 ``backtrace_sdf_exact`` as shipped (its replay steps with K17's
  step function, ``rules.cuh::sdf_step``).

Checks first: K13 and K17 variants bitwise against the shipped kernels
(outputs, capture steps, codes, horizons, the checkpoints), K14's within
1e-5 of the shipped kernel's largest entry, (a)'s steps summed
against the plain version's ``ray_steps``.  Prints registers, stack and
spills (``ptxas -v``), the machine code's global loads, local memory,
shuffle, match, atomic and reduction instructions per kernel
(``cuobjdump -sass``), the card, and one JSON line last.
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
from adjointnonlinearraytracing_tpu_torch.fields import grid as G  # noqa: E402
from adjointnonlinearraytracing_tpu_torch.kernels import build  # noqa: E402
from adjointnonlinearraytracing_tpu_torch.kernels import wrappers as K  # noqa: E402
from adjointnonlinearraytracing_tpu_torch.tracer import checkpointed as CK  # noqa: E402
from adjointnonlinearraytracing_tpu_torch.tracer import eikonal as E  # noqa: E402
from adjointnonlinearraytracing_tpu_torch.tracer import order as O  # noqa: E402

sys.path.insert(0, str(ROOT / "tools"))
import kernel_info  # noqa: E402

SOURCE = Path(__file__).resolve().parent / "sdf_designs.cu"
#: anrt_k14_split's modes (sdf_designs.cu K14Mode)
WHOLE, NO_SDF, NO_RUN, NO_ADDS = range(4)
#: the sdf reads (rules.cuh SdfRead)
ALONE, SHARED, AHEAD = range(3)
READS = {"own stencil": ALONE, "one stencil": SHARED, "one stencil, loads together": AHEAD}
TOL = 1e-5
SASS_OPS = ("LDG", "LDL", "STL", "SHFL", "MATCH", "REDUX", "ATOMG", "RED", "REDG", "STG")


def start_build():
    """Start ``nvcc`` on ``sdf_designs.cu`` as ``build.py`` compiles the shipped sources."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = build.BUILD_DIR / "libsdf_designs.so"
    proc = subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
                             str(out), str(SOURCE)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, out


def finish_build(proc, out):
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SOURCE.name}:\n{log}")
    lib = ctypes.CDLL(str(out))
    vp, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.anrt_k14_split.argtypes = [i, i, i, vp, i, i, i, d, d, d] + [vp] * 10 + [i, i, vp]
    lib.anrt_sdf_forward.argtypes = [i, i, vp, i, i, i, d, d] + [vp] * 16 + [i] * 5 + [vp]
    for fn in (lib.anrt_k14_split, lib.anrt_sdf_forward):
        fn.restype = i
    return lib, log


def ptxas_lines(log):
    """Registers, stack and spills per kernel from ``ptxas -v``."""
    rows, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = kernel_info.demangle(m.group(1))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.setdefault(short_name(name), {})["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            rows.setdefault(short_name(name), {}).update(
                stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
    return rows


def short_name(name):
    return re.sub(r"\s+", " ", name.replace("anrt::", ""))[:160]


def sass_counts(lib_path):
    """Global loads, local memory, shuffles, matches, reductions and atomics per kernel."""
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    counts = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name = kernel_info.demangle(part.split("\n", 1)[0].strip())
        kinds = {}
        for op in re.findall(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*(?:\.[\w]+)*)", part):
            base = op.split(".")[0]
            if base in SASS_OPS:
                kinds[base] = kinds.get(base, 0) + 1
        counts[short_name(name)] = kinds
    return counts


def grid_args(rif, h):
    d, hh, w = rif.shape
    return rif.data_ptr(), w, hh, d, float(h)


def ptr(t):
    return None if t is None else t.data_ptr()


class Forward:
    """K13 / K17 through the tool's entry point under one sdf read."""

    def __init__(self, lib, s, read, ckpt, store=True):
        self.lib, self.s, self.read, self.ckpt, self.store = lib, s, read, ckpt, store

    def call(self, order, chunk=0, kernel_horizons=True, events=None):
        """Both passes; the horizons in the kernel (K17's design) or made by
        torch between the passes (before it; K13 takes the batch's word).
        ``events``: a list that gets ms of pass 1, the work between, pass 2."""
        s, rif, h = self.s, self.s["rif"], self.s["h"]
        x, v, ds = s["xs"], s["vs"], s["ds"]
        n = x.shape[0]
        steps = CK.variant_steps("sdf", rif.shape, h, ds) if self.ckpt else s["ns"]
        xt, vt, c, code, ckpts = K._ckpt_outputs(rif, x, n, steps, CS.SEG, self.ckpt and self.store,
                                                 "sdf_designs")
        if not self.ckpt:
            c = code = None
        eff = K._sdf_chunk(chunk, n)
        in_kernel = self.ckpt and kernel_horizons
        hz = K._horizon(rif, n, -(-n // eff) if in_kernel else 1)
        hor_out = torch.empty((n,), dtype=torch.int32, device="cuda") if in_kernel else None
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)] if events is not None \
            else None

        def launch(pass_, hor=None):
            err = self.lib.anrt_sdf_forward(
                self.read, int(self.ckpt), *grid_args(rif, h), float(ds), s["sdf"].data_ptr(),
                x.data_ptr(), v.data_ptr(), order.data_ptr(), xt.data_ptr(), vt.data_ptr(),
                ptr(c), ptr(code), ptr(ckpts), *map(ptr, hz), ptr(hor), ptr(hor_out), n, steps,
                CS.SEG, eff, pass_, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"anrt_sdf_forward failed with CUDA error {err}")

        if marks:
            marks[0].record()
        launch(1)
        if marks:
            marks[1].record()
        hor = None
        if self.ckpt and not kernel_horizons:  # the wrapper before the redesign
            esc_steps = torch.empty((n,), dtype=torch.int32, device="cuda")
            esc_steps[order.long()] = hz[2]
            hor = K._check_horizons(CK._index_chunk_horizons(esc_steps, chunk, CS.SEG, steps),
                                    rif, n)
        if marks:
            marks[2].record()
        launch(2, hor)
        if marks:
            marks[3].record()
            torch.cuda.synchronize()
            events.append([marks[k].elapsed_time(marks[k + 1]) for k in range(3)])
        out = (xt, vt) if not self.ckpt else (xt, vt, c, code, ckpts,
                                               hor if hor is not None else hor_out)
        return out


def event_split(fn, reps):
    """Median ms of each part ``fn(events=...)`` records, the card kept busy before each call."""
    fn(events=[])
    runs = []
    for _ in range(reps):
        torch.cuda._sleep(CS.BUSY_CYCLES)
        fn(events=runs)
    return [sorted(r[k] for r in runs)[len(runs) // 2] for k in range(3)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None, help="also write the JSON line to this file")
    args = ap.parse_args(argv)

    proc, lib_path = start_build()
    for name in build.KERNELS:
        build.load(name)
    lib, log = finish_build(proc, lib_path)
    s = CS.variant_scene(CS.RES, CS.NRAYS, "float32")
    rif, h, ds, sdf, nb = s["rif"], s["h"], s["ds"], s["sdf"], s["nb"]
    xs, vs = s["xs"], s["vs"]
    n = xs.shape[0]
    order = O.ray_order(xs, vs, rif.shape, h)
    tol = G.snap_tol(rif.dtype)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    failures, report = [], {}

    # ---- K13 and K17: checks against the shipped kernels ----
    sdf_out = K.trace_sdf(rif, sdf, h, xs, vs, ds, s["ns"], order)
    case = CS.exact_case(s, "sdf")
    steps = CK.variant_steps("sdf", rif.shape, h, ds)
    shipped17 = K.trace_sdf_ckpt(rif, sdf, h, xs, vs, ds, steps, CS.SEG, order, 0)
    live = torch.where(shipped17[3] == 2, 0, shipped17[2])[order.long()]
    need = (torch.arange(shipped17[4].shape[0], device="cuda")[:, None] * CS.SEG) < live[None, :]

    def same17(got):
        """K17's outputs, capture steps, codes and horizons, and the checkpoint
        rows the backward pass reads, bitwise."""
        return (all(torch.equal(got[k], shipped17[k]) for k in (0, 1, 2, 3, 5))
                and bool(torch.equal(got[4].transpose(1, 2)[need],
                                     shipped17[4].transpose(1, 2)[need])))

    checks = {}
    for label, read in READS.items():
        got13 = Forward(lib, s, read, False).call(order)
        checks[f"K13 {label}"] = all(torch.equal(a, b) for a, b in zip(got13, sdf_out))
        for kh in (True, False):
            got17 = Forward(lib, s, read, True).call(order, kernel_horizons=kh)
            checks[f"K17 {label}, horizons {'in the kernel' if kh else 'by torch'}"] = same17(got17)
    # the chunked horizons of a padded last chunk (2^18 = 2 x 100,000 + 62,144)
    chunk = CS.EXACT_CHECK_CHUNK["float32"]
    want = K.trace_sdf_ckpt(rif, sdf, h, xs, vs, ds, steps, CS.SEG, order, chunk, False)[5]
    by_torch = Forward(lib, s, AHEAD, True, False).call(order, chunk, kernel_horizons=False)[5]
    checks["K17 chunked horizons: kernel = torch"] = bool(torch.equal(want, by_torch))
    print(f"sdf designs: K13 / K17 variants bitwise equal to the shipped kernels: {checks}",
          flush=True)
    if not all(checks.values()):
        failures.append(f"a K13 / K17 variant differs from the shipped kernel: {checks}")

    # ---- K14: (a)'s steps, checks ----
    centre = torch.full((3,), s["span"] / 2, dtype=rif.dtype, device="cuda")
    dx, dv = (2.0 * (sdf_out[0] - centre)).contiguous(), torch.ones_like(sdf_out[1])
    xt, vt = sdf_out
    ray_steps = torch.zeros((n,), dtype=torch.int32, device="cuda")
    probe = torch.zeros((n,), dtype=torch.float64, device="cuda")

    def k14(mode, read, f32, out=None, steps_buf=None, tally=None):
        g = torch.zeros((rif.numel(),), dtype=torch.float64, device="cuda") if out is None else out
        err = lib.anrt_k14_split(mode, read, int(f32), *grid_args(rif, h), float(ds), float(tol),
                                 sdf.data_ptr(), xt.data_ptr(), vt.data_ptr(), dx.data_ptr(),
                                 dv.data_ptr(), order.data_ptr(), g.data_ptr(), ptr(tally),
                                 ptr(steps_buf), probe.data_ptr(), n, nb, stream())
        if err:
            raise RuntimeError(f"anrt_k14_split failed with CUDA error {err}")
        return g

    shipped14 = K.backtrace_sdf(rif, sdf, h, xt, vt, dx, dv, ds, nb, tol, order)
    k14(WHOLE, ALONE, False, steps_buf=ray_steps)
    st = {}
    E.backtrace_sdf(s["field"], s["sdf_field"], xt, vt, dx, dv, ds, nb, stats=st)
    trips = torch.where(ray_steps > nb, nb, ray_steps).long().sum()
    scale = float(shipped14.abs().max())
    k14_runs = {
        "(a) before: own stencil, f64 sums": (WHOLE, ALONE, False),
        "(b) no sdf read": (NO_SDF, ALONE, False),
        "(c) no run, no adds": (NO_RUN, ALONE, False),
        "(d) run and warp sums, no adds": (NO_ADDS, ALONE, False),
        "(e) one stencil": (WHOLE, SHARED, False),
        "(f) f32 sums, f64 adds": (WHOLE, ALONE, True),
        "(e)+(f)": (WHOLE, SHARED, True),
    }
    errs = {}
    for label, (mode, read, f32) in k14_runs.items():
        if mode in (NO_RUN, NO_ADDS):
            continue
        tally = torch.zeros(3, dtype=torch.int64, device="cuda")
        g = k14(mode, read, f32, steps_buf=ray_steps if mode == NO_SDF else None, tally=tally)
        errs[label] = dict(rel_err=float((g - shipped14).abs().max()) / scale,
                           runs=int(tally[0]), issued=int(tally[1]))
    print(f"sdf designs: K14 variants against the shipped kernel (tol {TOL:g}): {errs}; (a)'s "
          f"steps {int(trips)} (the plain version's ray_steps {st.get('ray_steps')}, flushes "
          f"{st.get('flushes')})", flush=True)
    if not all(e["rel_err"] <= TOL for e in errs.values()):
        failures.append(f"a K14 variant differs from the shipped kernel: {errs}")

    # ---- K19 from the shipped K17's checkpoints ----
    dx19 = (2.0 * (shipped17[0] - centre)).contiguous()
    dv19 = torch.ones_like(shipped17[1])
    ck, c17, code17 = shipped17[4], shipped17[2], shipped17[3]
    torch.cuda.synchronize()

    # ---- times ----
    fns = {"K14 shipped": lambda: K.backtrace_sdf(rif, sdf, h, xt, vt, dx, dv, ds, nb, tol, order)}
    for label, (mode, read, f32) in k14_runs.items():
        fns[f"K14 {label}"] = (lambda m=mode, r=read, f=f32: k14(
            m, r, f, steps_buf=ray_steps if m == NO_SDF else None))
    fns["K17 shipped"] = lambda: CS.exact_forward_kernel(case, order, True)
    fns["K13 shipped"] = lambda: K.trace_sdf(rif, sdf, h, xs, vs, ds, s["ns"], order)
    fwd_variants = {}
    for label, read in READS.items():
        for kh in (False, True):
            for store in (True, False):
                name = (f"K17 {label}, horizons {'in the kernel' if kh else 'by torch'}"
                        + ("" if store else ", no checkpoint stores"))
                fwd_variants[name] = (Forward(lib, s, read, True, store), kh)
        fwd_variants[f"K13 {label}"] = (Forward(lib, s, read, False), True)
    for name, (fw, kh) in fwd_variants.items():
        fns[name] = (lambda fw=fw, kh=kh: fw.call(order, kernel_horizons=kh))
    fns["K19 shipped"] = lambda: K.backtrace_sdf_exact(rif, sdf, h, ck, c17, code17, dx19, dv19,
                                                       ds, CS.SEG, order)
    times = {name: [] for name in fns}
    for _ in range(args.rounds):
        for name, fn in fns.items():
            times[name].append(CS.time_ms(fn, args.reps))
    ms = {name: sorted(t)[len(t) // 2] for name, t in times.items()}
    parts = {}
    for name, (fw, kh) in fwd_variants.items():
        if fw.ckpt:
            parts[name] = event_split(lambda events, fw=fw, kh=kh: fw.call(
                order, kernel_horizons=kh, events=events), args.reps)
    for name in fns:
        print(f"sdf designs: {name}: {ms[name]:.4f} ms (rounds {[f'{t:.4f}' for t in times[name]]})"
              + (f"; pass 1 {parts[name][0]:.4f}, between {parts[name][1]:.4f}, pass 2 "
                 f"{parts[name][2]:.4f}" if name in parts else ""), flush=True)
    ptx = ptxas_lines(log)
    shipped_logs = {k: ptxas_lines(v) for k, v in build.build_logs().items()
                    if k in ("trace_fwd", "backtrace", "backtrace_exact")}
    sass = sass_counts(lib_path)
    for name, row in ptx.items():
        print(f"sdf designs: ptxas {name}: {row}; sass {sass.get(name, {})}", flush=True)
    for src, rows in shipped_logs.items():
        for name, row in rows.items():
            if "Sdf" in name or "true" in name:
                print(f"sdf designs: shipped {src}: {name}: {row}", flush=True)
    card = CS.smi_line()
    print(card)
    report.update(card=card, rounds=args.rounds, reps=args.reps, ms=ms, all=times,
                  k17_parts_ms=parts, checks=checks, k14_errs=errs,
                  k14_steps=int(trips), plain_ray_steps=st.get("ray_steps"),
                  ptxas=ptx, sass=sass,
                  shipped_ptxas={k: v for k, v in shipped_logs.items()}, failures=failures)
    line = json.dumps(report)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line)
    if failures:
        sys.exit("sdf designs: " + "; ".join(failures))


if __name__ == "__main__":
    main()
