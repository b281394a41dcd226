"""The split of the plane and target forward kernels (K15, K16; K11, K12, K2 and K5 beside them), one card.

Run from the repo root on a machine with a CUDA device and ``nvcc``::

    python tools/fwd_designs.py [--rounds N] [--reps N] [--out FILE] [--sass DIR]

It builds the shipped kernels and, beside them, ``tools/fwd_designs.cu``
twice (it includes the shipped ``trace_fwd.cu`` and instantiates its loop
under designs derived from the shipped one; no path of the port launches
them): once as shipped, once with ``ANRT_DIV_OPERATOR`` (the stencil's
division by the operator, with the compiler's slow-path branch), and
``csrc/backtrace.cu`` with ``ANRT_DIV_OPERATOR``.  On configuration 9's and
11's batches (``chip_smoke.variant_scene``: the bench scene, 128^3 f32, 2^18
rays, planes at y = 0.6 span, targets beyond the far face, ``seg`` 32, the
ray order that ``tracer/checkpointed.py`` makes) it checks, then times with
``chip_smoke.time_ms`` on a warm card, round after round in turn:

* (a) K15, K16, K11 and K12 as shipped; K2 and K5 on the bench scene (the
  same loop), and K3 there;
* (b) the checkpoint stores off: in pass 1, in pass 2, in both;
* (c) the stencil's division by the operator instead of ``div_h`` (every
  kernel above, K3 too);
* (d) the rows with plain stores instead of evict-first ones (the loop over
  segments that stores them is the shipped loop's own);
* (e) the target without its retirement rule (K16 and K12, with either
  division);

and each two-launch target call's pass 1, the gap and pass 2 apart (CUDA
events around each launch, the card kept busy before).  (f) what bounds the
loop: per kernel the machine code of one iteration of the step loop
(``cuobjdump -sass``, ``chip_smoke.step_instructions``: FCHK, CALL, BSSY,
MUFU, LDG, STG, F2F, DFMA, DMUL and the total; ``--sass DIR`` also writes
the kernels' machine code there), ``clock64()`` cycles a step from the
Clocked design, registers
and spills (``ptxas -v``), resident blocks an SM and hence waves, lane use
(the steps of each warp's lanes over 32 times its longest lane's, from the
Clocked design's per-slot steps) and the instruction-rate bound (instructions a
step x warp-steps / (4 a cycle x the SMs x the clock ``nvidia-smi`` reads))
beside the operation bound.

Checks: every design's outputs, capture steps, codes, horizon and the
checkpoint rows the backward pass reads equal the shipped kernel's bit for
bit (the stores-off designs: their outputs).  Prints the card and one JSON
line last.
"""

from __future__ import annotations

import argparse
import ctypes
import json
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

SOURCE = Path(__file__).resolve().parent / "fwd_designs.cu"
#: anrt_fwd_design's rules and designs (fwd_designs.cu)
PLANE, TARGET, TARGET_KEEP = range(3)
SHIPPED, PLAIN_STORES, CLOCKED = range(3)
#: anrt_fwd_occupancy's kernels
OCCUPANCY = {"K2": (0, 1), "K5": (1, 1), "K11": (2, 1), "K15": (3, 1), "K12": (4, 1),
             "K12 pass 2": (4, 2), "K16": (5, 1), "K16 pass 2": (5, 2)}
#: the kernels by the port's names (chip_smoke.FWD_KERNELS' labels)
KERNEL_NAMES = {"K2": "trace_fwd", "K5": "trace_ckpt", "K11": "trace_plane",
                "K15": "trace_plane_ckpt", "K12": "trace_target", "K16": "trace_target_ckpt"}
SMS_H100 = 132
WARP_INSTR_PER_CYCLE = 4  # warp instructions an SM starts a cycle (one per scheduler)


def start_builds():
    """``nvcc`` on the tool's source (as shipped and with the operator's
    division) and on ``backtrace.cu`` with the operator's division, all at once."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {"fwd_designs": (SOURCE, []),
            "fwd_designs_opdiv": (SOURCE, ["-DANRT_DIV_OPERATOR"]),
            "backtrace_opdiv": (build.CSRC / "backtrace.cu", ["-DANRT_DIV_OPERATOR"])}
    procs = {}
    for name, (src, extra) in jobs.items():
        out = build.BUILD_DIR / f"lib{name}.so"
        procs[name] = (out, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, *extra, "-I", str(build.CSRC), "-o", str(out),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def finish_builds(procs):
    libs, logs = {}, {}
    vp, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(out))
        for fn_name, args in (("anrt_fwd_design", [i, i, vp, i, i, i, d, d] + [vp] * 17
                               + [i, i, i, i, vp]),
                              ("anrt_fwd_set_clock", [vp]), ("anrt_fwd_occupancy", [i, i]),
                              ("anrt_trace_fwd", K._ARGTYPES["trace_fwd"]),
                              ("anrt_trace_ckpt", K._ARGTYPES["trace_ckpt"]),
                              ("anrt_trace_plane_ckpt", K._ARGTYPES["trace_plane_ckpt"]),
                              ("anrt_trace_target_ckpt", K._ARGTYPES["trace_target_ckpt"]),
                              ("anrt_backtrace", K._ARGTYPES["backtrace"])):
            if hasattr(lib, fn_name):
                fn = getattr(lib, fn_name)
                fn.argtypes, fn.restype = args, i
        libs[name], logs[name] = lib, log
    return libs, logs


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


class Forward:
    """One plane or target forward kernel under a design, through
    ``anrt_fwd_design`` of one of the tool's libraries."""

    def __init__(self, lib, case, rule, design=SHIPPED, ckpt=True, stores=(True, True)):
        self.lib, self.case, self.rule, self.design = lib, case, rule, design
        self.ckpt, self.stores = ckpt, stores
        self.max_steps = max_steps(case, ckpt)

    def call(self, order, events=None, clocks=None):
        """Both passes (the plane's one); returns (xt, vt, miss or d2, c, code,
        ckpts, horizon, pass 1's steps at each slot).  ``events``: a list that
        gets ms of pass 1, the gap, pass 2; ``clocks``: a list that gets each
        pass's (cycles, steps) a slot (the Clocked design)."""
        case, rif, h = self.case, self.case["rif"], self.case["h"]
        x, v, n = case["x"], case["v"], case["x"].shape[0]
        plane = self.rule == PLANE
        steps = self.max_steps
        xt, vt, c, code, ckpts = K._ckpt_outputs(rif, x, n, steps, CS.SEG,
                                                 self.ckpt and any(self.stores), "fwd_designs")
        if not self.ckpt:
            c = code = None
        out = (torch.empty((n,), dtype=torch.bool, device="cuda") if plane
               else torch.empty((n,), dtype=rif.dtype, device="cuda"))
        hz = K._horizon(rif, n)
        passes = (1,) if plane else (1, 2)
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)] if events is not None \
            else None
        for p in passes:
            clk = None
            if clocks is not None:
                clk = torch.zeros((n, 2), dtype=torch.int64, device="cuda")
                check(self.lib.anrt_fwd_set_clock(clk.data_ptr()), "anrt_fwd_set_clock")
            if marks:
                marks[2 * (p - 1)].record()
            check(self.lib.anrt_fwd_design(
                self.rule, self.design, *grid_args(rif, h), float(case["ds"]), x.data_ptr(),
                v.data_ptr(), ptr(case.get("o")), ptr(case.get("d")), ptr(case.get("tgt")),
                order.data_ptr(), xt.data_ptr(), vt.data_ptr(), out.data_ptr(), ptr(c),
                ptr(code), ptr(ckpts) if self.stores[p - 1] else None, *map(ptr, hz), n, steps,
                CS.SEG, p, stream()), "anrt_fwd_design")
            if marks:
                marks[2 * (p - 1) + 1].record()
            if clk is not None:
                check(self.lib.anrt_fwd_set_clock(None), "anrt_fwd_set_clock")
                clocks.append(clk)
        if marks:
            torch.cuda.synchronize()
            events.append([marks[0].elapsed_time(marks[1])] + (
                [marks[1].elapsed_time(marks[2]), marks[2].elapsed_time(marks[3])]
                if not plane else [0.0, 0.0]))
        return xt, vt, out, c, code, ckpts, hz[4], hz[2]


def max_steps(case, ckpt):
    """The step bound the API gives the case's exact forward (K15, K16) or
    its plain forward (K11, K12: ``max_steps_fwd``)."""
    rif, h, ds = case["rif"], case["h"], case["ds"]
    if ckpt:
        return CK.variant_steps(case["variant"], rif.shape, h, ds)
    return E.max_steps_fwd(max(rif.shape), h, ds)


def shipped_entry(lib, case, order):
    """The shipped entry point of ``lib`` (the tool's library as shipped or
    with the operator's division) for the case's K15 or K16."""
    rif, h, x, v = case["rif"], case["h"], case["x"], case["v"]
    n = x.shape[0]
    steps = max_steps(case, True)
    xt, vt, c, code, ckpts = K._ckpt_outputs(rif, x, n, steps, CS.SEG, True, "fwd_designs")
    g = (0,) + grid_args(rif, h)
    if case["variant"] == "plane":
        miss = torch.empty((n,), dtype=torch.bool, device="cuda")
        check(lib.anrt_trace_plane_ckpt(*g, float(case["ds"]), x.data_ptr(), v.data_ptr(),
                                        case["o"].data_ptr(), case["d"].data_ptr(),
                                        order.data_ptr(), xt.data_ptr(), vt.data_ptr(),
                                        miss.data_ptr(), c.data_ptr(), code.data_ptr(),
                                        ckpts.data_ptr(), n, steps,
                                        CS.SEG, stream()), "anrt_trace_plane_ckpt")
        return xt, vt, miss, c, code, ckpts, None
    d2 = torch.empty((n,), dtype=rif.dtype, device="cuda")
    hz = K._horizon(rif, n)
    for p in (1, 2):
        check(lib.anrt_trace_target_ckpt(*g, float(case["ds"]), x.data_ptr(), v.data_ptr(),
                                         case["tgt"].data_ptr(), order.data_ptr(), xt.data_ptr(),
                                         vt.data_ptr(), d2.data_ptr(), c.data_ptr(),
                                         code.data_ptr(), ckpts.data_ptr(), *map(ptr, hz), n,
                                         steps, CS.SEG, p,
                                         stream()), "anrt_trace_target_ckpt")
    return xt, vt, d2, c, code, ckpts, hz[4]


def rows_needed(c, code, order, nseg):
    """The checkpoint rows the backward pass reads: row s of slot i where
    s * seg lies below the capture step of ray order[i]."""
    live = torch.where(code == 2, 0, c)[order.long()]
    return (torch.arange(nseg, device="cuda")[:, None] * CS.SEG) < live[None, :]


def same(got, want, need, rows=True):
    """Outputs (and c, code, horizon, the rows read) bitwise."""
    ok = all(torch.equal(a, b) for a, b in zip(got[:3], want[:3]))
    if want[3] is not None:
        ok = ok and torch.equal(got[3], want[3]) and torch.equal(got[4], want[4])
    if len(want) > 6 and want[6] is not None:
        ok = ok and torch.equal(got[6], want[6])
    if rows and want[5] is not None:
        ok = ok and torch.equal(got[5].transpose(1, 2)[need], want[5].transpose(1, 2)[need])
    return bool(ok)


def lane_use(steps):
    """Steps of a warp's lanes over 32 times its longest lane's, summed over
    warps of 32 consecutive slots; and the warp-steps (the longest lane's a warp)."""
    n = steps.shape[0] // 32 * 32
    w = steps[:n].view(-1, 32).double()
    warp_steps = float(w.max(dim=1).values.sum())
    return float(w.sum()) / (32.0 * warp_steps) if warp_steps else 0.0, warp_steps


def smi_clocks():
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         timeout=60, check=True)
    return [float(v) for v in out.stdout.strip().splitlines()[0].split(",")]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None, help="also write the JSON line to this file")
    ap.add_argument("--sass", default=None, help="write the forward kernels' SASS to this dir")
    args = ap.parse_args(argv)

    procs = start_builds()
    for name in build.KERNELS:
        build.load(name)
    libs, logs = finish_builds(procs)
    lib, lib_op, bt_op = libs["fwd_designs"], libs["fwd_designs_opdiv"], libs["backtrace_opdiv"]
    s = CS.variant_scene(CS.RES, CS.NRAYS, "float32")
    rif, h, ds = s["rif"], s["h"], s["ds"]
    cases = {v: CS.exact_case(s, v) for v in ("plane", "target")}
    order = O.ray_order(cases["plane"]["x"], cases["plane"]["v"], rif.shape, h)
    failures, report = [], {}

    # ---- checks against the shipped kernels ----
    shipped = {
        "K15": K.trace_plane_ckpt(rif, h, *(cases["plane"][k] for k in ("x", "v", "o", "d")),
                                  ds, CK.variant_steps("plane", rif.shape, h, ds), CS.SEG,
                                  order),
        "K16": K.trace_target_ckpt(rif, h, *(cases["target"][k] for k in ("x", "v", "tgt")), ds,
                                   CK.variant_steps("target", rif.shape, h, ds), CS.SEG, order),
    }
    plain = {"K11": K.trace_plane(rif, h, *(cases["plane"][k] for k in ("x", "v", "o", "d")),
                                  ds, s["nf"], order),
             "K12": K.trace_target(rif, h, *(cases["target"][k] for k in ("x", "v", "tgt")), ds,
                                   s["nf"], order)}
    nseg = shipped["K15"][5].shape[0]
    need = {k: rows_needed(w[3], w[4], order, nseg) for k, w in shipped.items()}
    designs = {}  # label: (kernel, Forward)
    for kname, variant, rule in (("K15", "plane", PLANE), ("K16", "target", TARGET)):
        case = cases[variant]
        for lab, lb, d in (("design 0 (shipped code)", lib, SHIPPED),
                           ("operator division", lib_op, SHIPPED),
                           ("plain row stores", lib, PLAIN_STORES)):
            designs[f"{kname} {lab}"] = (kname, Forward(lb, case, rule, d))
        passes = ((1,), ) if variant == "plane" else ((1,), (2,), (1, 2))
        for off in passes:
            stores = tuple(p not in off for p in (1, 2))
            lab = "stores off" + ("" if variant == "plane" else
                                  " in pass " + " and ".join(map(str, off)))
            designs[f"{kname} {lab}"] = (kname, Forward(lib, case, rule, SHIPPED, stores=stores))
        if variant == "target":
            designs["K16 no retirement"] = ("K16", Forward(lib, case, TARGET_KEEP))
            designs["K16 no retirement, operator division (the parent's design)"] = (
                "K16", Forward(lib_op, case, TARGET_KEEP))
    for kname, variant, rule in (("K11", "plane", PLANE), ("K12", "target", TARGET)):
        case = cases[variant]
        designs[f"{kname} design 0 (shipped code)"] = (kname, Forward(lib, case, rule,
                                                                      ckpt=False))
        designs[f"{kname} operator division"] = (kname, Forward(lib_op, case, rule, ckpt=False))
        if variant == "target":
            designs["K12 no retirement"] = ("K12", Forward(lib, case, TARGET_KEEP, ckpt=False))
            designs["K12 no retirement, operator division (the parent's design)"] = (
                "K12", Forward(lib_op, case, TARGET_KEEP, ckpt=False))
    checks = {}
    for label, (kname, fw) in designs.items():
        got = fw.call(order)
        if kname in shipped:
            checks[label] = same(got, shipped[kname], need[kname],
                                 rows="stores off" not in label)
        else:
            checks[label] = all(torch.equal(a, b) for a, b in zip(got[:3], plain[kname]))
    for kname, variant in (("K15", "plane"), ("K16", "target")):
        got = shipped_entry(lib_op, cases[variant], order)
        checks[f"{kname} operator division, shipped entry point"] = same(got, shipped[kname],
                                                                         need[kname])
    # K2, K5 and K3 on the bench scene with the operator's division
    x0, v0 = s["x0"], s["v0"]
    order_b = O.ray_order(x0, v0, rif.shape, h)
    steps_b = E.max_steps_fwd(max(rif.shape), h, ds)
    k2 = K.trace_fwd(rif, h, x0, v0, ds, s["nf"], order_b)
    k5 = K.trace_ckpt(rif, h, x0, v0, ds, steps_b, CS.SEG, order_b)

    def k2_op():
        xt, vt = torch.empty_like(x0), torch.empty_like(v0)
        check(lib_op.anrt_trace_fwd(0, *grid_args(rif, h), float(ds), x0.data_ptr(),
                                    v0.data_ptr(), order_b.data_ptr(), xt.data_ptr(),
                                    vt.data_ptr(), x0.shape[0], s["nf"], stream()),
              "anrt_trace_fwd")
        return xt, vt

    def k5_op():
        n = x0.shape[0]
        xt, vt, c, code, ck = K._ckpt_outputs(rif, x0, n, steps_b, CS.SEG, True, "fwd_designs")
        check(lib_op.anrt_trace_ckpt(0, *grid_args(rif, h), float(ds), x0.data_ptr(),
                                     v0.data_ptr(), order_b.data_ptr(), xt.data_ptr(),
                                     vt.data_ptr(), c.data_ptr(), code.data_ptr(), ck.data_ptr(),
                                     n, steps_b, CS.SEG, stream()), "anrt_trace_ckpt")
        return xt, vt, c, code, ck

    checks["K2 operator division"] = all(torch.equal(a, b) for a, b in zip(k2_op(), k2))
    got5 = k5_op()
    need5 = rows_needed(k5[2], k5[3], order_b, k5[4].shape[0])
    checks["K5 operator division"] = bool(
        all(torch.equal(a, b) for a, b in zip(got5[:4], k5[:4]))
        and torch.equal(got5[4].transpose(1, 2)[need5], k5[4].transpose(1, 2)[need5]))
    tol = G.snap_tol(rif.dtype)
    dxb, dvb = (2.0 * (k2[0] - s["target"])).contiguous(), torch.ones_like(k2[1])

    def k3_op():
        g = torch.zeros((rif.numel(),), dtype=rif.dtype, device="cuda")
        path = K.backtrace_path(rif.numel(), rif.dtype)
        check(bt_op.anrt_backtrace(0, *grid_args(rif, h), float(ds), float(tol),
                                   k2[0].data_ptr(), k2[1].data_ptr(), dxb.data_ptr(),
                                   dvb.data_ptr(), order_b.data_ptr(), g.data_ptr(), None,
                                   x0.shape[0], s["nb"], int(path == "shared"), stream()),
              "anrt_backtrace")
        return g

    g3 = K.backtrace(rif, h, k2[0], k2[1], dxb, dvb, ds, s["nb"], tol, order_b)
    checks["K3 operator division (1e-5)"] = bool(
        float((k3_op() - g3).abs().max()) <= 1e-5 * float(g3.abs().max()))
    print(f"fwd designs: every design against the shipped kernel: {checks}", flush=True)
    if not all(checks.values()):
        failures.append(f"a design differs from the shipped kernel: "
                        f"{[k for k, v in checks.items() if not v]}")

    # ---- times ----
    fns = {
        "K15 shipped": lambda: K.trace_plane_ckpt(
            rif, h, *(cases["plane"][k] for k in ("x", "v", "o", "d")), ds,
            CK.variant_steps("plane", rif.shape, h, ds), CS.SEG, order),
        "K16 shipped": lambda: K.trace_target_ckpt(
            rif, h, *(cases["target"][k] for k in ("x", "v", "tgt")), ds,
            CK.variant_steps("target", rif.shape, h, ds), CS.SEG, order),
        "K11 shipped": lambda: K.trace_plane(
            rif, h, *(cases["plane"][k] for k in ("x", "v", "o", "d")), ds, s["nf"], order),
        "K12 shipped": lambda: K.trace_target(
            rif, h, *(cases["target"][k] for k in ("x", "v", "tgt")), ds, s["nf"], order),
        "K2 shipped": lambda: K.trace_fwd(rif, h, x0, v0, ds, s["nf"], order_b),
        "K2 operator division": k2_op,
        "K5 shipped": lambda: K.trace_ckpt(rif, h, x0, v0, ds, steps_b, CS.SEG, order_b),
        "K5 operator division": k5_op,
        "K3 shipped": lambda: K.backtrace(rif, h, k2[0], k2[1], dxb, dvb, ds, s["nb"], tol,
                                          order_b),
        "K3 operator division": k3_op,
    }
    for label, (kname, fw) in designs.items():
        if not label.endswith("(shipped code)"):
            fns[label] = (lambda fw=fw: fw.call(order))
    times = {name: [] for name in fns}
    for _ in range(args.rounds):
        for name, fn in fns.items():
            times[name].append(CS.time_ms(fn, args.reps))
    ms = {name: sorted(t)[len(t) // 2] for name, t in times.items()}
    parts = {}
    for label, (kname, fw) in designs.items():
        if kname in ("K16", "K12"):
            runs = []
            fw.call(order)
            for _ in range(args.reps):
                torch.cuda._sleep(CS.BUSY_CYCLES)
                fw.call(order, events=runs)
            parts[label] = [sorted(r[k] for r in runs)[len(runs) // 2] for k in range(3)]
    parts["K16 shipped"] = list(CS.pass_split(fns["K16 shipped"], "trace_target_ckpt").values())
    parts["K12 shipped"] = list(CS.pass_split(fns["K12 shipped"], "trace_target").values())
    for name in fns:
        print(f"fwd designs: {name}: {ms[name]:.4f} ms (rounds "
              f"{[f'{t:.4f}' for t in times[name]]})"
              + (f"; pass 1 {parts[name][0]:.4f}, between {parts[name][1]:.4f}, pass 2 "
                 f"{parts[name][2]:.4f}" if name in parts else ""), flush=True)
    for name in parts:
        if name not in fns:
            print(f"fwd designs: {name}: pass 1 {parts[name][0]:.4f}, between "
                  f"{parts[name][1]:.4f}, pass 2 {parts[name][2]:.4f}", flush=True)

    # ---- (f) what bounds the loop ----
    clock_mhz, max_mhz = smi_clocks()
    loops = {"shipped": CS.step_instructions(),
             "operator division": CS.step_instructions(
                 build.BUILD_DIR / "libfwd_designs_opdiv.so")}
    if args.sass:
        Path(args.sass).mkdir(parents=True, exist_ok=True)
        for label, path in (("shipped", build.load("trace_fwd")._name),
                            ("opdiv", build.BUILD_DIR / "libfwd_designs_opdiv.so")):
            funcs = kernel_info.sass_functions(path)
            (Path(args.sass) / f"trace_fwd_{label}.sass").write_text("\n".join(
                f"Function : {name}\n{text}" for name, text in funcs.items()
                if "<float" in name and "FwdLoop" in name))
    occupancy = {k: int(lib.anrt_fwd_occupancy(*w)) for k, w in OCCUPANCY.items()}
    bounds = {}
    for kname, variant, rule, ckpt in (("K15", "plane", PLANE, True), ("K11", "plane", PLANE,
                                                                       False),
                                       ("K16", "target", TARGET, True),
                                       ("K12", "target", TARGET, False)):
        clocks = []
        Forward(lib, cases[variant], rule, CLOCKED, ckpt=ckpt).call(order, clocks=clocks)
        torch.cuda.synchronize()
        rec = {}
        for p, clk in enumerate(clocks, 1):
            cyc, st = clk[:, 0].double(), clk[:, 1]
            live = st > 0
            use, warp_steps = lane_use(st)
            rec[f"pass {p}"] = dict(
                steps=int(st.sum()), cycles_per_step_all=float(cyc[live].sum() / st.sum())
                if int(st.sum()) else None,
                cycles_per_step_mean=float((cyc[live] / st[live].double()).mean())
                if bool(live.any()) else None,
                lane_use=use, warp_steps=warp_steps)
        loop = loops["shipped"].get(KERNEL_NAMES[kname])
        if "pass 2" in rec:
            rec["pass 2"]["loop"] = loops["shipped"].get(f"{KERNEL_NAMES[kname]} pass 2")
        p1 = rec["pass 1"]
        if loop:
            p1["instructions_a_step"] = loop["total"]
            p1["instruction_bound_ms"] = (1e3 * loop["total"] * p1["warp_steps"]
                                    / (WARP_INSTR_PER_CYCLE * SMS_H100 * clock_mhz * 1e6))
        blocks = occupancy.get(kname)
        if blocks and blocks > 0:
            p1["blocks_an_sm"] = blocks
            p1["waves"] = cases[variant]["x"].shape[0] / (blocks * 128 * SMS_H100)
        bounds[kname] = rec
        print(f"fwd designs: {kname} (f): {rec}; step loop {loop}; blocks an SM {blocks}",
              flush=True)
    for name, loop in loops["operator division"].items():
        print(f"fwd designs: {name} with the operator's division: step loop {loop}", flush=True)
    ptx = {name: kernel_info.ptxas_lines(log) for name, log in logs.items()}
    shipped_ptx = kernel_info.ptxas_lines(build.build_logs().get("trace_fwd", ""))
    for line in shipped_ptx:
        if "float" in line:
            print(f"fwd designs: ptxas[trace_fwd] {line}", flush=True)
    card = CS.smi_line()
    print(card)
    print(f"fwd designs: SM clock {clock_mhz:.0f} MHz (max {max_mhz:.0f})")
    report.update(card=card, clock_mhz=clock_mhz, max_clock_mhz=max_mhz, rounds=args.rounds,
                  reps=args.reps, ms=ms, all=times, passes_ms=parts, checks=checks,
                  loops=loops, occupancy=occupancy, bounds=bounds, ptxas=ptx,
                  shipped_ptxas=[line for line in shipped_ptx if "float" in line],
                  failures=failures)
    line = json.dumps(report)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line)
    if failures:
        sys.exit("fwd designs: " + "; ".join(failures))


if __name__ == "__main__":
    main()
