"""The split of K13 trace_sdf and K20 record_paths, one card.

Run from the repo root on a machine with a CUDA device and ``nvcc``::

    python tools/sdf_record_designs.py [--rounds N] [--reps N] [--out FILE] [--sass DIR]
                                       [--part k20|k13|both]

It builds the shipped kernels and, beside them, ``tools/sdf_record_designs.cu``
(it includes the shipped ``trace_fwd.cu`` and instantiates its kernels under
designs derived from the shipped loop; no path of the port launches them).
Then, round after round in turn, with ``chip_smoke.time_ms``:

K20 on ``combo_recon16_true``'s 524,288 f64 rays through the 65^3 fuel
volume (h = 1/64, 66 records of 8 steps), L2 flushed before each call as
``chip_smoke.py`` times it: (a) as shipped (the division by the exact
multiply); (b) the records off (the last one kept); (c) the division by the
operator; (e) the step loop's machine code per iteration (``cuobjdump
-sass``: each innermost loop holding 8 corner loads, the multiply's and the
operator's; DFMA, DMUL, DADD, DSETP, MUFU, CALL, BSSY, LDG, STG, F2I, FRND,
IMAD and the total), ``clock64()`` cycles a step, registers and spills
(``ptxas -v``), blocks an SM, waves, lane use of the evaluations (a lane's
evaluating steps over 32 times its warp's), the issue bound (instructions a
step x warp-steps / (4 x 132 x the card's maximum clock)) and the bound of
the f64 issue rate (a warp's f64 instruction every other cycle of a
scheduler, over the evaluating warp-steps).

K13 on configuration 9's sdf batch (``chip_smoke.variant_scene``: 128^3 f32,
2^18 rays spawned on the sphere sdf, the ray order): two grids (the read
before the pairs) against the node pairs (the shipped read; its pack made in the call,
beforehand, and alone); pass 1, the gap and pass 2 apart (CUDA events);
K17 under either read; (e) as for K20 (cycles and lane use from the slots'
steps).

Checks: every design's outputs equal the shipped kernel's bit for bit (K20:
every record, the records-off design its last; K13, K17: xt, vt and K17's
capture steps, codes and horizons), the shipped K20 against
``record_paths_plain`` on 2^15 of the rays and on the 17^3 bench grid (h =
1.25: the operator's branch).  Prints the card and one JSON line last.
Designs that lost are gone from the tool (their numbers in ``PERF.md``).
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
from adjointnonlinearraytracing_tpu_torch.experiments import voxel_scenes  # noqa: E402
from adjointnonlinearraytracing_tpu_torch.kernels import build  # noqa: E402
from adjointnonlinearraytracing_tpu_torch.kernels import wrappers as K  # noqa: E402
from adjointnonlinearraytracing_tpu_torch.pathmatrix import fuel2008  # noqa: E402
from adjointnonlinearraytracing_tpu_torch.tracer import checkpointed as CK  # noqa: E402
from adjointnonlinearraytracing_tpu_torch.tracer import order as O  # noqa: E402

sys.path.insert(0, str(ROOT / "tools"))
import kernel_info  # noqa: E402

SOURCE = Path(__file__).resolve().parent / "sdf_record_designs.cu"
AHEAD, PACKED = 2, 3  # rules.cuh SdfRead
SMS_H100 = 132
OPS = ("DFMA", "DMUL", "DADD", "DSETP", "MUFU", "CALL", "BSSY", "LDG", "STG", "F2I", "FRND",
       "IMAD", "FSETP")
_VP, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double


def start_build():
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = build.BUILD_DIR / "libsdf_record_designs.so"
    return out, subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(out), str(SOURCE)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish_build(out, proc):
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SOURCE.name}:\n{log}")
    lib = ctypes.CDLL(str(out))
    for fn_name, args in {
            "anrt_k20_design": [_I, _I, _I, _VP, _I, _I, _I, _D, _D, _VP, _VP, _VP, _VP, _I, _I,
                                _I, _VP],
            "anrt_k13_design": [_I, _I, _VP, _I, _I, _I, _D, _D] + [_VP] * 11 + [_I, _I, _I,
                                                                                 _VP],
            "anrt_k17_design": [_I, _VP, _I, _I, _I, _D, _D] + [_VP] * 16 + [_I] * 5 + [_VP],
            "anrt_rec_set_clock": [_VP], "anrt_rec_occupancy": [_I]}.items():
        fn = getattr(lib, fn_name)
        fn.argtypes, fn.restype = args, _I
    return lib, log


def stream():
    return torch.cuda.current_stream().cuda_stream


def ptr(t):
    return None if t is None else t.data_ptr()


def grid_args(rif, h):
    d, hh, w = rif.shape
    return rif.data_ptr(), w, hh, d, float(h)


def check(err, what):
    if err:
        raise RuntimeError(f"{what} failed with CUDA error {err}")


def innermost_loops(sass):
    """The innermost loops of a kernel's machine code that hold 8 or more
    global loads (the step loops; a kernel that unswitches a choice holds one
    a choice): for each, {op: count an iteration, "total": ...}, in the order
    of their addresses."""
    lines = [(int(m.group(1), 16), m.group(2), m.group(3)) for m in re.finditer(
        r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);", sass)]
    ranges = []
    for addr, op, rest in lines:
        t = re.search(r"0x([0-9a-f]+)", rest) if op.startswith("BRA") else None
        if not t or int(t.group(1), 16) >= addr:
            continue
        lo = int(t.group(1), 16)
        body = [o for a, o, _ in lines if lo <= a <= addr]
        if sum(o.startswith("LDG") for o in body) >= 8:
            ranges.append((lo, addr, body))
    inner = [r for r in ranges if not any(o is not r and r[0] <= o[0] and o[1] <= r[1]
                                          for o in ranges)]
    out = []
    for lo, hi, body in sorted(inner):
        per = max(1, sum(o.startswith("LDG") for o in body) // 8)
        counts = {"total": len(body) / per}
        counts.update({op: sum(o.split(".")[0] == op for o in body) / per for op in OPS})
        counts["f64"] = sum(o.split(".")[0] in ("DFMA", "DMUL", "DADD", "DSETP", "DMNMX")
                            for o in body) / per
        out.append(counts)
    return out


def kernel_loops(lib_path, pattern):
    funcs = kernel_info.sass_functions(lib_path)
    text = next((t for name, t in funcs.items() if re.search(pattern, name)), None)
    return innermost_loops(text) if text else None


def smi_clocks():
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         timeout=60, check=True)
    return [float(v) for v in out.stdout.strip().splitlines()[0].split(",")]


def two_pass_events(launch, reps):
    """Median ms of pass 1, the gap and pass 2 of ``launch(pass_)`` called
    for passes 1 and 2 in turn, the card kept busy before each call."""
    parts = []
    launch(1), launch(2)
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda._sleep(CS.BUSY_CYCLES)
        for p in (1, 2):
            ev[2 * p - 2].record()
            launch(p)
            ev[2 * p - 1].record()
        torch.cuda.synchronize()
        parts.append((ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2]),
                      ev[2].elapsed_time(ev[3])))
    return [sorted(p[j] for p in parts)[reps // 2] for j in range(3)]


# ---------------------------------------------------------------------------
# K20
# ---------------------------------------------------------------------------

def k20_part(lib, args, clock_mhz, failures):
    gt = voxel_scenes.fuel_injection_rif(dtype=torch.float64, device="cuda")
    h = 1.0 / (gt.shape[0] - 1)
    ds = h / 2
    stride = CS.F2008_TRUE_CONFIG["path_stride"]
    rays = fuel2008.gen_rays(CS.F2008_TRUE_CONFIG, device="cuda")
    x, v = rays.x.contiguous(), rays.v.contiguous()
    n = x.shape[0]
    nrec, steps = fuel2008.record_steps(gt.shape[0], h, ds, stride)

    def design(d, operator=False):
        path = torch.empty((nrec * n, 3), dtype=torch.float32, device="cuda")
        check(lib.anrt_k20_design(d, int(operator), 1, *grid_args(gt, h), float(ds),
                                    x.data_ptr(), v.data_ptr(), None, path.data_ptr(), n, nrec,
                                    stride, stream()), "anrt_k20_design")
        return path

    # the shipped kernel against its plain version where it is cheap: 2^15 of
    # the rays here, the 17^3 bench grid at h = 1.25 (the operator's branch)
    checks = {}
    sub = slice(0, 1 << 15)
    err, fails = CS.record_paths_case(gt, h, ds, x[sub].contiguous(), v[sub].contiguous(), stride,
                                      "K20 design tool, 2^15 rays")
    checks["shipped against plain, 2^15 rays (h = 1/64)"] = not fails
    s17 = CS.scene(17, 512, "float64", noise=0.02)
    err17, fails17 = CS.record_paths_case(s17["rif"], s17["h"], s17["ds"], s17["x0"],
                                          s17["v0"], 3, "K20 design tool, 17^3 (h = 1.25)")
    checks["shipped against plain, 17^3 (h = 1.25)"] = not fails17
    shipped = K.record_paths(gt, h, x, v, ds, nrec, stride)
    runs = {"K20 (a) shipped": lambda: K.record_paths(gt, h, x, v, ds, nrec, stride),
            "K20 (b) records off": lambda: design(1),
            "K20 (c) operator division": lambda: design(0, True)}
    for label, fn in runs.items():
        got = fn()
        if "records off" in label:
            checks[label] = bool(torch.equal(got[-n:], shipped[-n:]))
        else:
            checks[label] = bool(torch.equal(got, shipped))
        del got
    del shipped
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    times = {k: [] for k in runs}
    for _ in range(args.rounds):
        for k, fn in runs.items():
            times[k].append(CS.time_ms(fn, args.reps, flush))
    del flush
    ms = {k: sorted(t)[len(t) // 2] for k, t in times.items()}
    # (e) the machine code, the clocks, lane use, occupancy
    clk = torch.zeros((n, 3), dtype=torch.int64, device="cuda")
    check(lib.anrt_rec_set_clock(clk.data_ptr()), "anrt_rec_set_clock")
    path = torch.empty((nrec * n, 3), dtype=torch.float32, device="cuda")
    check(lib.anrt_k20_design(2, 0, 1, *grid_args(gt, h), float(ds), x.data_ptr(),
                              v.data_ptr(), None, path.data_ptr(), n, nrec, stride, stream()),
          "anrt_k20_design")
    torch.cuda.synchronize()
    check(lib.anrt_rec_set_clock(None), "anrt_rec_set_clock")
    del path
    cyc, evals, warp_evals = (clk[:, k].double() for k in range(3))
    w = n // 32 * 32
    warp_eval_steps = float(warp_evals[:w].view(-1, 32)[:, 0].sum())
    lane_use = float(evals.sum()) / (32.0 * warp_eval_steps) if warp_eval_steps else None
    loops = {"shipped": kernel_loops(build.load("trace_fwd")._name,
                                     r"record_paths_kernel<double, anrt::FwdLoop>")}
    blocks = int(lib.anrt_rec_occupancy(0))
    warp_steps = (n / 32) * steps
    rec = dict(rays=n, records=nrec, steps=steps, ms=ms, all=times, checks=checks,
               cycles_per_step=float(cyc.mean()) / steps, evals=float(evals.sum()),
               warp_eval_steps=warp_eval_steps, lane_use=lane_use, loops=loops,
               blocks_an_sm=blocks, waves=n / (blocks * 128 * SMS_H100) if blocks > 0 else None)
    for label, lp in loops.items():
        for j, loop in enumerate(lp or []):
            issue = 1e3 * loop["total"] * warp_steps / (4 * SMS_H100 * clock_mhz * 1e6)
            f64 = 1e3 * 2 * loop["f64"] * warp_eval_steps / (4 * SMS_H100 * clock_mhz * 1e6)
            loop.update(issue_bound_ms=issue, f64_issue_bound_ms=f64)
    print(f"K20 designs: checks {checks}", flush=True)
    for k in runs:
        print(f"K20 designs: {k}: {ms[k]:.4f} ms (rounds {[f'{t:.4f}' for t in times[k]]})",
              flush=True)
    print(f"K20 designs: (e) cycles a step a lane {rec['cycles_per_step']:.1f}; lane use of the "
          f"evaluations {lane_use}; blocks an SM {blocks}, waves {rec['waves']}; loops "
          f"{json.dumps(loops)}", flush=True)
    if not all(checks.values()):
        failures.append(f"K20: a design differs: {[k for k, ok in checks.items() if not ok]}")
    return rec


# ---------------------------------------------------------------------------
# K13 (and K17), the bench scene's kernels under the index design
# ---------------------------------------------------------------------------

class K13:
    """One K13 call (both passes) under a read and a launch of the tool's library."""

    def __init__(self, lib, s, read, launch, order, pairs=None):
        self.lib, self.s, self.read, self.launch, self.order = lib, s, read, launch, order
        self.pairs = pairs  # precomputed pairs (PACKED); None: made in the call

    def call(self, events=None, clocks=None):
        s = self.s
        rif, xs = s["rif"], s["xs"]
        n = xs.shape[0]
        xt, vt = torch.empty_like(xs), torch.empty_like(xs)
        sdf = s["sdf"]
        if self.read == PACKED:
            sdf = self.pairs if self.pairs is not None else K.node_pairs(rif, s["sdf"])
        hz = K._horizon(rif, n)

        def launch(p):
            if clocks is not None:
                clk = torch.zeros((n, 3), dtype=torch.int64, device="cuda")
                check(self.lib.anrt_rec_set_clock(clk.data_ptr()), "anrt_rec_set_clock")
            check(self.lib.anrt_k13_design(
                self.read, 3 if clocks is not None else self.launch, *grid_args(rif, s["h"]),
                float(s["ds"]), sdf.data_ptr(), xs.data_ptr(), s["vs"].data_ptr(),
                self.order.data_ptr(), xt.data_ptr(), vt.data_ptr(), *map(ptr, hz), n, s["ns"],
                p, stream()), "anrt_k13_design")
            if clocks is not None:
                check(self.lib.anrt_rec_set_clock(None), "anrt_rec_set_clock")
                clocks.append(clk)

        if events is not None:
            events.extend(two_pass_events(launch, 5))
        else:
            launch(1)
            launch(2)
        return xt, vt


def k17_call(lib, s, read, order):
    rif, xs = s["rif"], s["xs"]
    n = xs.shape[0]
    steps = CK.variant_steps("sdf", rif.shape, s["h"], s["ds"])
    xt, vt, c, code, ck = K._ckpt_outputs(rif, xs, n, steps, CS.SEG, True, "designs")
    hz = K._horizon(rif, n)
    hor = torch.empty((n,), dtype=torch.int32, device="cuda")
    sdf = K.node_pairs(rif, s["sdf"]) if read == PACKED else s["sdf"]
    for p in (1, 2):
        check(lib.anrt_k17_design(read, *grid_args(rif, s["h"]), float(s["ds"]), sdf.data_ptr(),
                                  xs.data_ptr(), s["vs"].data_ptr(), order.data_ptr(),
                                  xt.data_ptr(), vt.data_ptr(), c.data_ptr(), code.data_ptr(),
                                  ck.data_ptr(), *map(ptr, hz), None, hor.data_ptr(), n, steps,
                                  CS.SEG, 0, p, stream()), "anrt_k17_design")
    return xt, vt, c, code, hor


def lane_use(steps):
    m = steps.shape[0] // 32 * 32
    w = steps[:m].view(-1, 32).double()
    warp_steps = float(w.max(dim=1).values.sum())
    return (float(w.sum()) / (32.0 * warp_steps) if warp_steps else None), warp_steps


def k13_part(lib, args, clock_mhz, failures):
    s = CS.variant_scene(CS.RES, CS.NRAYS, "float32")
    rif, h, ds, sdf, xs, vs = (s[k] for k in ("rif", "h", "ds", "sdf", "xs", "vs"))
    order = O.ray_order(xs, vs, rif.shape, h)
    pairs = K.node_pairs(rif, sdf)
    shipped = K.trace_sdf(rif, sdf, h, xs, vs, ds, s["ns"], order)
    designs = {"K13 two grids": K13(lib, s, AHEAD, 0, order),
               "K13 node pairs": K13(lib, s, PACKED, 0, order),
               "K13 node pairs made beforehand": K13(lib, s, PACKED, 0, order, pairs)}
    checks = {label: all(torch.equal(a, b) for a, b in zip(d.call(), shipped))
              for label, d in designs.items()}
    shipped17 = K.trace_sdf_ckpt(rif, sdf, h, xs, vs, ds,
                                 CK.variant_steps("sdf", rif.shape, h, ds), CS.SEG, order, 0)
    for read, label in ((AHEAD, "two grids"), (PACKED, "node pairs")):
        got = k17_call(lib, s, read, order)
        checks[f"K17 {label}"] = all(torch.equal(a, b) for a, b in
                                     zip(got, shipped17[:4] + shipped17[5:]))
    print(f"K13 designs: checks {checks}", flush=True)
    if not all(checks.values()):
        failures.append(f"K13: a design differs: {[k for k, ok in checks.items() if not ok]}")

    runs = {"K13 shipped (wrapper)": lambda: K.trace_sdf(rif, sdf, h, xs, vs, ds, s["ns"],
                                                         order)}
    for label, d in designs.items():
        runs[label] = d.call
    runs["node pairs alone"] = lambda: K.node_pairs(rif, sdf)
    runs["K17 two grids"] = lambda: k17_call(lib, s, AHEAD, order)
    runs["K17 node pairs"] = lambda: k17_call(lib, s, PACKED, order)
    times = {k: [] for k in runs}
    for _ in range(args.rounds):
        for k, fn in runs.items():
            times[k].append(CS.time_ms(fn, args.reps))
    ms = {k: sorted(t)[len(t) // 2] for k, t in times.items()}
    passes = {}
    for label, d in designs.items():
        ev = []
        d.call(events=ev)
        passes[label] = ev
    for k in runs:
        print(f"K13 designs: {k}: {ms[k]:.4f} ms (rounds {[f'{t:.4f}' for t in times[k]]})"
              + (f"; pass 1 {passes[k][0]:.4f}, between {passes[k][1]:.4f}, pass 2 "
                 f"{passes[k][2]:.4f}" if k in passes else ""), flush=True)
    # (e)
    bounds = {}
    names = {AHEAD: r"trace_fwd_kernel<float, (?:\(bool\)0|false), anrt::SdfRule<float, "
                    r"(?:\(int\))?2>, anrt::FwdLoop>",
             PACKED: r"trace_fwd_kernel<float, (?:\(bool\)0|false), anrt::SdfRule<float, "
                     r"(?:\(int\))?3>, anrt::FwdLoop>"}
    for rname, read in (("two grids", AHEAD), ("node pairs", PACKED)):
        clocks = []
        K13(lib, s, read, 0, order).call(clocks=clocks)
        torch.cuda.synchronize()
        cyc, st = clocks[0][:, 0].double(), clocks[0][:, 1]
        use, warp_steps = lane_use(st)
        loops = kernel_loops(build.BUILD_DIR / "libsdf_record_designs.so", names[read])
        blocks = int(lib.anrt_rec_occupancy(2 if read == AHEAD else 3))
        rec = dict(steps=int(st.sum()), cycles_per_step=float(cyc.sum() / st.sum()),
                   lane_use=use, warp_steps=warp_steps, loops=loops, blocks_an_sm=blocks,
                   pass2_blocks=int(lib.anrt_rec_occupancy(4 if read == AHEAD else 5)),
                   waves=xs.shape[0] / (blocks * 128 * SMS_H100) if blocks > 0 else None)
        if loops:
            rec["issue_bound_ms"] = (1e3 * loops[0]["total"] * warp_steps
                                     / (4 * SMS_H100 * clock_mhz * 1e6))
        bounds[rname] = rec
        print(f"K13 designs: (e) {rname}: {json.dumps(rec)}", flush=True)
    return dict(ms=ms, all=times, passes_ms=passes, checks=checks, bounds=bounds)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None, help="also write the JSON line to this file")
    ap.add_argument("--sass", default=None, help="write K13's and K20's machine code here")
    ap.add_argument("--part", choices=("k20", "k13", "both"), default="both")
    args = ap.parse_args(argv)
    out, proc = start_build()
    for name in build.KERNELS:
        build.load(name)
    lib, log = finish_build(out, proc)
    # the issue bounds take the card's clock under load, its maximum (an idle
    # card reads lower)
    clock_mhz, max_mhz = smi_clocks()
    failures, report = [], {}
    if args.part in ("k20", "both"):
        report["k20"] = k20_part(lib, args, max_mhz, failures)
    if args.part in ("k13", "both"):
        report["k13"] = k13_part(lib, args, max_mhz, failures)
    if args.sass:
        Path(args.sass).mkdir(parents=True, exist_ok=True)
        funcs = kernel_info.sass_functions(build.load("trace_fwd")._name)
        (Path(args.sass) / "trace_fwd.sass").write_text("\n".join(
            f"Function : {name}\n{text}" for name, text in funcs.items()
            if "record_paths" in name or "SdfRule" in name))
    ptx = {"sdf_record_designs": kernel_info.ptxas_lines(log),
           "trace_fwd (shipped)": kernel_info.ptxas_lines(build.build_logs().get("trace_fwd",
                                                                               ""))}
    ptx = {k: [ln for ln in v if "record_paths" in ln or "SdfRule" in ln or "bounded" in ln]
           for k, v in ptx.items()}
    for name, rows in ptx.items():
        for row in rows:
            print(f"designs: ptxas[{name}] {row}", flush=True)
    card = CS.smi_line()
    print(card)
    print(f"designs: SM clock {clock_mhz:.0f} MHz idle (max {max_mhz:.0f}, which the bounds take)")
    report.update(card=card, clock_mhz=clock_mhz, max_clock_mhz=max_mhz, rounds=args.rounds,
                  reps=args.reps, ptxas=ptx, failures=failures)
    line = json.dumps(report)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line)
    if failures:
        sys.exit("designs: " + "; ".join(failures))


if __name__ == "__main__":
    main()
