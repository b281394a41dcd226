"""Times of K1 ``eval_grad``'s designs on one card, alternated in one process.

Run from the repo root on a machine with a CUDA device and ``nvcc``::

    python tools/k1_designs.py [--rounds N]

It builds the shipped kernels and ``tools/k1_designs.cu`` (earlier designs
that no path of the port launches), holds every design bit for bit to the
plain version at ``chip_smoke.py``'s K1 points (the bench scene's rays part-way
through its 128^3 f32 volume, 2^18 points), and times each design and
``grid_sample`` with ``chip_smoke.time_ms`` after a 256 MB buffer was read
(``chip_smoke.py``'s yardstick), after it was written, and with nothing done
before the launch, round after round.  Prints each kernel's registers
(``ptxas -v``) and global loads in its machine code (``cuobjdump -sass``),
the card, and one JSON line of the medians over the rounds.
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

SOURCE = Path(__file__).resolve().parent / "k1_designs.cu"
#: anrt_k1_design's design numbers
DESIGNS = {"four points a thread": 0, "four-point kernel at one point a thread": 1,
           "first design behind a one-trip loop": 2}


def build_designs():
    """Compile ``k1_designs.cu`` as ``build.py`` compiles the shipped sources."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = build.BUILD_DIR / "libk1_designs.so"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
                           str(out), str(SOURCE)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SOURCE.name}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    vp, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.anrt_k1_design.argtypes = [i, vp, i, i, i, d, vp, vp, vp, vp, i, vp]
    return lib, out, proc.stdout + proc.stderr


def machine_code(lib_path):
    """Global loads per kernel of a library (f32 instantiations), from cuobjdump -sass."""
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    loads = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name = part.split("\n", 1)[0].strip()
        if not re.search(r"kernelId(E|Lb)", name):  # the f32 kernels
            ops = re.findall(r"\*/\s+(?:@!?P\d\s+)?(LDG[\w.]*)", part)
            loads[name] = {op: ops.count(op) for op in sorted(set(ops))}
    return loads


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)

    shipped = Path(build.load("eval_grad")._name)
    lib, lib_path, log = build_designs()
    for line in log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"nvcc[k1_designs] {line.strip()}")
    for name, text in build.build_logs().items():
        if name == "eval_grad":
            for line in text.splitlines():
                if "registers" in line or "Compiling entry" in line:
                    print(f"nvcc[eval_grad] {line.strip()}")
    for path in (shipped, lib_path):
        for name, ops in machine_code(path).items():
            print(f"sass[{path.name}] {name}: global loads {ops}")

    s = CS.scene(CS.RES, CS.NRAYS, "float32")
    rif, h, p, field = s["rif"], s["h"], s["p"], s["field"]
    mask = G.inbounds(field, p)
    n_ref, g_ref = G.eval_grad_plain(field, p, mask)
    depth, height, width = rif.shape
    npts = p.shape[0]

    def design(num):
        def run():
            n = torch.empty(npts, device="cuda")
            g = torch.empty(npts, 3, device="cuda")
            rc = lib.anrt_k1_design(num, rif.data_ptr(), width, height, depth, float(h),
                                    p.data_ptr(), mask.data_ptr(), n.data_ptr(), g.data_ptr(),
                                    npts, torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"anrt_k1_design({num}) returned CUDA error {rc}")
            return n, g
        return run

    hi = torch.tensor([(r - 1) * h for r in field.res], device="cuda")
    loc = (2.0 * p / hi - 1.0).reshape(1, 1, 1, -1, 3)

    def sample():
        return torch.nn.functional.grid_sample(rif[None, None], loc, mode="bilinear",
                                               padding_mode="border", align_corners=True)

    fns = {"shipped: pair loads": lambda: K.eval_grad(rif, h, p, mask),
           "first design (pair_loads=False)": lambda: K.eval_grad(rif, h, p, mask,
                                                                  pair_loads=False),
           **{name: design(num) for name, num in DESIGNS.items()}}
    for name, fn in fns.items():
        n, g = fn()
        if not (torch.equal(n, n_ref) and torch.equal(g, g_ref)):
            raise AssertionError(f"{name} is not bitwise equal to the plain version")
    fns["grid_sample (value only)"] = sample

    flush = torch.zeros(64 << 20, dtype=torch.float32, device="cuda")
    states = {"read": dict(flush=flush), "written": dict(flush=flush, dirty=True), "warm": {}}
    times = {name: {st: [] for st in states} for name in fns}
    for _ in range(args.rounds):
        for name, fn in fns.items():
            for st, kw in states.items():
                times[name][st].append(CS.time_ms(fn, args.reps, **kw))
    medians = {name: {st: sorted(x)[len(x) // 2] for st, x in by.items()}
               for name, by in times.items()}
    for name, by in medians.items():
        print(f"{name}: ms after the buffer was read {by['read']:.4f}, written "
              f"{by['written']:.4f}, warm {by['warm']:.4f}")
    print(CS.smi_line())
    print(json.dumps({"points": npts, "rounds": args.rounds, "reps": args.reps,
                      "card": torch.cuda.get_device_name(0), "ms": medians, "all": times}))


if __name__ == "__main__":
    main()
