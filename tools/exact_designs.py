"""The split of the exact backward ray (K18, K19, K6) and the designs tried on the way, one card.

Run from the repo root on a machine with a CUDA device and ``nvcc``::

    python tools/exact_designs.py [--rounds N] [--reps N] [--tiles 0,16384,49152]
                                  [--k6-scenes bench,fuel,luneburg] [--no-split]
                                  [--out FILE]

It builds the shipped kernels and ``tools/exact_designs.cu`` (the variants of
the ray that the split times and the designs tried, which no path of the
port launches; the file lists them) and, on configuration 11's batches
(``chip_smoke.variant_scene``: the bench scene, 128^3 f32, 2^18 rays, the
plane's and the sdf's, ``seg`` 32) and on K6's (the bench scene; with
``--k6-scenes`` also the fuel stages 3^3 .. 65^3, ``bench_and_fuel_scenes``,
and 2^18 of a Luneburg step's rays through the Luneburg lens at 129^3), times with ``chip_smoke.time_ms`` on a warm card,
round after round in turn:

* the shipped kernels (``kernels.wrappers``: K18 and K19 with PairRun's
  runs, K6 with SplatRun's) and the ray with SplatRun's runs (K18 and K19
  before PairRun);
* unless ``--no-split``, that ray's split: (a) a copy of it, (b) the replay
  alone, (c) the replay and the reverse evaluation with no run and no adds,
  (d) the leader's adds sent to one word a warp, (d') no adds at all (the
  run and the warp sums kept), the run without the warp sums, and (K18,
  K6) each x-pair of a run's corners added as one float4 where it lies in
  an aligned group of 4; for K19 (e) the sdf read sharing the next
  evaluation's stencil and (f) the run and warp sums in f32, the adds in
  f64, each and both;
* the tile path at each tile size of ``--tiles`` (bytes a block; 0: the
  block in step, no tile);
* PairRun, the face runs (carried across a face, and keyed the same way
  without the carry), each (K19, with the split) with (e), (f) and both,
  PairRun in a kernel held to 5 and 6 blocks an SM, and PairRun with its
  reverse step in fused multiply-adds (``FusedRay``).

Checks first: every variant that writes a gradient is within 1e-5 of the
shipped kernel's largest entry.  Prints, per variant, the ``tally`` of the
runs (``wrappers.EXACT_TALLY``; the tile path's and the face runs' own),
the box of each block-stretch of the tile path (median, 95th percentile and
largest, in nodes), blocks an SM
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), registers, stack and
spills (``ptxas -v``), the machine code's atomic, local memory, shuffle and
barrier instructions per kernel (``cuobjdump -sass``), the card, and one
JSON line last.
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
    fuel_injection, luneburg, voxel_scenes)
from adjointnonlinearraytracing_tpu_torch.fields import grid as G  # noqa: E402
from adjointnonlinearraytracing_tpu_torch.kernels import build  # noqa: E402
from adjointnonlinearraytracing_tpu_torch.kernels import wrappers as K  # noqa: E402
from adjointnonlinearraytracing_tpu_torch.tracer import eikonal as E  # noqa: E402
from adjointnonlinearraytracing_tpu_torch.tracer import order as O  # noqa: E402

sys.path.insert(0, str(ROOT / "tools"))
import kernel_info  # noqa: E402

SOURCE = Path(__file__).resolve().parent / "exact_designs.cu"
#: anrt_exact_split's rules and modes (see exact_designs.cu)
RULES = {"target": 0, "plane": 1, "sdf": 2}
(WARP, SPLIT_A, REPLAY, EVAL_ONLY, SCRATCH, TILE, NO_ADDS, NO_WARP_SUMS, VECTOR_ADDS, FACE,
 FACE_PAIRS, PAIR, PAIR_5, PAIR_6, FUSED) = range(15)
#: the face runs' tally: the fourth counter counts the runs that ended across a face
FACE_TALLY = ("runs", "issued", "adds", "faces")
#: the tile path's own tally (exact_designs.cu TileTally)
TILE_TALLY = ("runs", "issued", "tile_adds", "tile_stretches", "over_budget", "direct")
TOL = 1e-5
#: room for the boxes of a launch's block-stretches
BOX_CAP = 1 << 20
#: machine-code instructions counted per kernel
SASS_OPS = ("ATOMG", "REDG", "RED", "ATOMS", "LDL", "STL", "SHFL", "BAR", "LDS", "STS")


def start_build():
    """Start ``nvcc`` on ``exact_designs.cu`` as ``build.py`` compiles the shipped sources."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = build.BUILD_DIR / "libexact_designs.so"
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
    lib.anrt_exact_split.argtypes = [i, i, i, i, i, vp, i, i, i, d, d] + [vp] * 13 + [i, i, i,
                                                                                     vp]
    lib.anrt_exact_split.restype = i
    lib.anrt_exact_occupancy.argtypes = [i, i, i]
    lib.anrt_exact_occupancy.restype = i
    lib.anrt_exact_vector_adds.restype = i
    return lib, log


def sass_counts(lib_path):
    """Atomic, local-memory, shuffle and barrier instructions per kernel of a library."""
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    counts = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name = kernel_info.demangle(part.split("\n", 1)[0].strip())
        ops = re.findall(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*(?:\.[\w]+)*)", part)
        kinds = {}
        for op in ops:
            base = op.split(".")[0]
            if base in SASS_OPS:
                key = f"{base}.CAS" if ".CAS" in op else base
                kinds[key] = kinds.get(key, 0) + 1
        counts[short_name(name)] = kinds
    return counts


def short_name(name):
    """A kernel's demangled name without namespaces and the shell's boilerplate."""
    return re.sub(r"\s+", " ", name.replace("anrt::", "").replace("(anonymous namespace)::", ""))


def percentile(values, q):
    v = sorted(values)
    return v[min(len(v) - 1, int(q * len(v)))] if v else None


def exact_inputs(case):
    """The plane's or the sdf's batch as ``trace_*_exact`` hands it to the
    backward kernel: the checkpoints, capture steps, codes and cotangents."""
    rif, h = case["rif"], case["h"]
    order = O.ray_order(case["x"], case["v"], rif.shape, h)
    got, c, code, ck, _ = CS.exact_forward_kernel(case, order, True)
    xt, vt = got[0], got[1]
    dx, dv = 2.0 * (xt - case["anchor"]), torch.ones_like(vt)
    if case["variant"] == "plane":
        hit = ~got[2]
        dx = torch.where(hit[:, None], dx, torch.zeros_like(dx))
        dv = torch.where(hit[:, None], dv, torch.zeros_like(dv))
    return dict(order=order, c=c, code=code, ck=ck, dx=dx.contiguous(), dv=dv.contiguous())


def volume_inputs(rif, h, ds, x0, v0, cot):
    """K6's batch as ``trace_exact`` hands it over (K5's checkpoints)."""
    steps = E.max_steps_fwd(max(rif.shape), h, ds)
    order = O.ray_order(x0, v0, rif.shape, h)
    xt, vt, c, code, ck = K.trace_ckpt(rif, h, x0, v0, ds, steps, CS.SEG, order)
    dx, dv = cot(xt, vt)
    dv = torch.where((code != 0)[:, None], dv, torch.zeros_like(dv))
    return dict(order=order, c=c, code=code, ck=ck, dx=dx.contiguous(), dv=dv.contiguous())


def bench_and_fuel_scenes():
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


def k6_scenes(which):
    """K6's scenes: the bench scene, the fuel stages, a Luneburg batch at 129^3."""
    for label, rif, h, ds, x0, v0, cot in bench_and_fuel_scenes():
        kind = "bench" if label.startswith("bench") else "fuel"
        if kind in which:
            yield label, rif, h, ds, x0, v0, cot
    if "luneburg" in which:
        params = CS.driver_params("luneburg")
        res, span = params["res_list"][-1], params["vol_span"]
        rays = luneburg.gen_start_rays(params, torch.Generator(device="cuda").manual_seed(99),
                                       params["spp"], torch.float32)[0]
        idx = torch.randperm(rays.x.shape[0], device="cuda",
                             generator=torch.Generator(device="cuda").manual_seed(3))[:CS.NRAYS]
        h = span / (res - 1)
        centre = span / 2
        yield (f"luneburg {res}^3", voxel_scenes.luneburg_lens(res, span, torch.float32),
               h, h / params["step_res"], rays.x[idx].contiguous(), rays.v[idx].contiguous(),
               lambda xt, vt: (2.0 * (xt - centre), torch.ones_like(vt)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--tiles", default="0,16384,49152",
                    help="tile sizes in bytes a block for the tile path")
    ap.add_argument("--k6-scenes", default="bench,fuel,luneburg")
    ap.add_argument("--no-split", dest="split", action="store_false",
                    help="time only the shipped kernels, the runs' kinds and the tiles")
    ap.add_argument("--out", default=None, help="also write the JSON line to this file")
    args = ap.parse_args(argv)
    tiles = [int(t) for t in args.tiles.split(",")]

    proc, lib_path = start_build()
    for name in build.KERNELS:
        build.load(name)
    lib, log = finish_build(proc, lib_path)
    for line in kernel_info.ptxas_lines(log):
        print(f"ptxas[exact_designs] {short_name(line)}")
    for line in kernel_info.ptxas_lines(build.build_logs()["backtrace_exact"]):
        print(f"ptxas[backtrace_exact] {short_name(line)}")
    sass = sass_counts(Path(build.load("backtrace_exact")._name))
    sass.update(sass_counts(lib_path))
    for name, ops in sass.items():
        print(f"sass {name}: {ops}")
    kinds = {WARP: "splat runs", PAIR: "pair runs", FACE: "face runs",
             FACE_PAIRS: "face runs, no carry"}
    occupancy = {f"{rule} {kinds.get(mode, f'tile {b}')}":
                 lib.anrt_exact_occupancy(RULES[rule], mode, b)
                 for rule in RULES for mode, b in [(WARP, 0), (PAIR, 0), (FACE, 0), (FACE_PAIRS, 0)]
                 + [(TILE, b) for b in tiles]}
    print(f"blocks an SM: {occupancy}; vector adds of the f32 tile: "
          f"{bool(lib.anrt_exact_vector_adds())}", flush=True)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    s = CS.variant_scene(CS.RES, CS.NRAYS, "float32")
    batches = []
    for variant in ("plane", "sdf"):
        case = CS.exact_case(s, variant)
        batches.append((f"{variant} {CS.RES}^3", variant, case["rif"], case["h"], case["ds"],
                        case, exact_inputs(case)))
    for label, rif, h, ds, x0, v0, cot in k6_scenes(args.k6_scenes.split(",")):
        batches.append((f"target (K6) {label}", "target", rif, h, ds, None,
                        volume_inputs(rif, h, ds, x0, v0, cot)))

    results = []
    for label, variant, rif, h, ds, case, inp in batches:
        rule = RULES[variant]
        acc = torch.float64 if variant == "sdf" else rif.dtype
        n = inp["order"].shape[0]
        depth, height, width = rif.shape
        sdf = case["sdf"] if variant == "sdf" else None
        probe = torch.zeros(n, dtype=acc, device="cuda")

        def split(mode, tile=0, reuse=False, f32=False, tally=None, boxes=None):
            def run():
                out = torch.zeros(rif.numel(), dtype=acc, device="cuda")
                rc = lib.anrt_exact_split(
                    rule, mode, tile, int(reuse), int(f32), rif.data_ptr(), width, height,
                    depth, float(h), float(ds), K._ptr(sdf) if sdf is not None else None,
                    case["o"].data_ptr() if variant == "plane" else None,
                    case["d"].data_ptr() if variant == "plane" else None,
                    inp["ck"].data_ptr(), inp["order"].data_ptr(), inp["c"].data_ptr(),
                    inp["code"].data_ptr(), inp["dx"].data_ptr(), inp["dv"].data_ptr(),
                    out.data_ptr(), K._ptr(tally), probe.data_ptr(), K._ptr(boxes), n,
                    inp["ck"].shape[0], CS.SEG, stream())
                if rc != 0:
                    raise RuntimeError(f"anrt_exact_split({label}, mode {mode}, tile {tile}) "
                                       f"returned CUDA error {rc}")
                return out
            return run

        def shipped():
            if variant == "plane":
                return K.backtrace_plane_exact(rif, h, inp["ck"], inp["c"], inp["code"],
                                               case["o"], case["d"], inp["dx"], inp["dv"], ds,
                                               CS.SEG, inp["order"])
            if variant == "sdf":
                return K.backtrace_sdf_exact(rif, sdf, h, inp["ck"], inp["c"], inp["code"],
                                             inp["dx"], inp["dv"], ds, CS.SEG, inp["order"])
            return K.backtrace_exact(rif, h, inp["ck"], inp["c"], inp["code"], inp["dx"],
                                     inp["dv"], ds, CS.SEG, inp["order"])

        fns = {"shipped": (shipped, {}), "warp path": (None, dict(mode=WARP))}
        split_all = args.split and (variant != "target" or label.startswith("target (K6) bench"))
        if split_all:
            fns.update({"(a) warp copy": (None, dict(mode=SPLIT_A)),
                        "(b) replay alone": (None, dict(mode=REPLAY)),
                        "(c) replay + reverse evaluation": (None, dict(mode=EVAL_ONLY)),
                        "(d) adds to a word a warp": (None, dict(mode=SCRATCH)),
                        "(d') no adds": (None, dict(mode=NO_ADDS)),
                        "no warp sums": (None, dict(mode=NO_WARP_SUMS))})
            if variant != "sdf":
                fns["float4 adds"] = (None, dict(mode=VECTOR_ADDS))
        if variant == "sdf" and args.split:
            fns.update({"(e) warp copy, sdf read shared": (None, dict(mode=SPLIT_A, reuse=True)),
                        "(f) warp copy, f32 sums": (None, dict(mode=SPLIT_A, f32=True)),
                        "(e)+(f) warp copy": (None, dict(mode=SPLIT_A, reuse=True, f32=True))})
        for b in tiles:
            fns[f"tile {b}"] = (None, dict(mode=TILE, tile=b))
        for kind, mode in (("pair runs", PAIR), ("face runs", FACE),
                           ("face runs, no carry", FACE_PAIRS)):
            fns[kind] = (None, dict(mode=mode))
            if variant == "sdf" and args.split:
                fns.update({f"{kind} (e)": (None, dict(mode=mode, reuse=True)),
                            f"{kind} (f)": (None, dict(mode=mode, f32=True)),
                            f"{kind} (e)+(f)": (None, dict(mode=mode, reuse=True, f32=True))})
        for blocks, mode in ((5, PAIR_5), (6, PAIR_6)):
            fns[f"pair runs, {blocks} blocks an SM"] = (None, dict(
                mode=mode, reuse=variant == "sdf", f32=variant == "sdf"))
        fns["pair runs, fused reverse step"] = (None, dict(
            mode=FUSED, reuse=variant == "sdf", f32=variant == "sdf"))
        runs = {name: fn if fn is not None else split(**kw) for name, (fn, kw) in fns.items()}

        # checks, and the tallies of the runs
        ref = shipped()
        scale = max(1.0, float(ref.abs().max()))
        errs, tallies = {}, {}
        for name, (fn, kw) in fns.items():
            if kw.get("mode") in (REPLAY, EVAL_ONLY, SCRATCH, NO_ADDS):
                runs[name]()
                continue
            names = {TILE: TILE_TALLY, FACE: FACE_TALLY, FACE_PAIRS: FACE_TALLY}.get(
                kw.get("mode"), K.EXACT_TALLY)
            tally = torch.zeros(len(names), dtype=torch.int64, device="cuda")
            got = (split(**kw, tally=tally)() if fn is None else
                   {"plane": lambda: K.backtrace_plane_exact(
                       rif, h, inp["ck"], inp["c"], inp["code"], case["o"], case["d"],
                       inp["dx"], inp["dv"], ds, CS.SEG, inp["order"], tally=tally),
                    "sdf": lambda: K.backtrace_sdf_exact(
                        rif, sdf, h, inp["ck"], inp["c"], inp["code"], inp["dx"], inp["dv"],
                        ds, CS.SEG, inp["order"], tally=tally),
                    "target": lambda: K.backtrace_exact(
                        rif, h, inp["ck"], inp["c"], inp["code"], inp["dx"], inp["dv"], ds,
                        CS.SEG, inp["order"], tally=tally)}[variant]())
            errs[name] = float((got.double() - ref.double()).abs().max()) / scale
            tallies[name] = dict(zip(names, (int(v) for v in tally.tolist())))
            if errs[name] > TOL:
                raise AssertionError(f"{name} at {label} is {errs[name]:.3e} from the shipped "
                                     "kernel")
        boxes = torch.zeros(2 + BOX_CAP, dtype=torch.int32, device="cuda")
        boxes[1] = BOX_CAP
        split(mode=TILE, tile=max(tiles), boxes=boxes,
              tally=torch.zeros(len(TILE_TALLY), dtype=torch.int64, device="cuda"))()
        nbox = min(int(boxes[0]), BOX_CAP)
        sizes = boxes[2:2 + nbox].tolist()
        box = dict(stretches=int(boxes[0]), median=percentile(sizes, 0.5),
                   p95=percentile(sizes, 0.95), max=max(sizes) if sizes else None)
        item = torch.empty((), dtype=acc).element_size()  # the tile's words
        box["over"] = {b: sum(1 for x in sizes if item * x > b) for b in tiles if b}
        torch.cuda.synchronize()
        times = {name: [] for name in runs}
        for _ in range(args.rounds):
            for name, fn in runs.items():
                times[name].append(CS.time_ms(fn, args.reps))
        med = {name: sorted(t)[len(t) // 2] for name, t in times.items()}
        row = dict(batch=label, rays=n, ms=med, all=times, rel_err_to_shipped=errs,
                   tally=tallies, boxes_nodes=box)
        results.append(row)
        print(f"{label}: " + "; ".join(f"{k} {v:.4f}" for k, v in med.items()) + " ms",
              flush=True)
        print(f"  boxes of {box['stretches']} block-stretches, nodes: median {box['median']}, "
              f"95th percentile {box['p95']}, largest {box['max']} (boxes whose words exceed each "
              f"tile size, before x is padded to whole vector adds: {box['over']})", flush=True)
        for name, t in tallies.items():
            print(f"  tally[{name}]: {t}; error to the shipped kernel {errs[name]:.3e}",
                  flush=True)
        del inp, runs, ref
    card = CS.smi_line()
    print(card)
    line = json.dumps({"card": card, "rounds": args.rounds, "reps": args.reps, "tiles": tiles,
                       "occupancy": occupancy, "sass": sass, "results": results})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(json.dumps({"card": card, "ms": {r["batch"]: r["ms"] for r in results}}))


if __name__ == "__main__":
    main()
