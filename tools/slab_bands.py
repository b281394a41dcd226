"""Where the slab ring's phase kernels K21 and K22 lose their time on a grid
beyond L2, and whether stepping a phase in z-bands that L2 holds pays.

Run from the repo root on a machine with a CUDA device and ``nvcc``::

    python tools/slab_bands.py [--bands 2,3,4,5,6,8] [--reps 3] [--out FILE]

Configuration 14 of ``PERF.md``: the bench field at 1025^3 f32 (4.3 GB, made
on the card by ``benchmarks.scenes.bench_rows``), 2^18 rays from
``scenes.z_rays`` crossing z both ways, one rank, so one phase's slab is the
whole padded grid (1,027 voxel rows); with ``--ranks 4``, rank 0's first
phase of a ring of four instead (its 258 rows, its 2^16 rays, the ring's
``K``).  With CUDA events around each launch it
times, for K21 ``slab_trace_phase`` and K22 ``slab_backtrace_phase``:

1. ``whole``: one phase on the whole slab from the ring's start state (K22:
   from the forward phase's exit state and the bench loss's cotangents),
   with the ray order ``api.trace`` uses and without it (``order=None``);
2. ``band``: one launch on a band view of ``B`` cell rows (``B + 1`` voxel
   rows from the middle of the slab) with every ray placed inside it (the
   rays that travel up at its lowest cell, the others at its highest), after
   a 256 MB read that empties L2 (``cold``), again right after the same
   launch (``warm``), and after the read as the ring launches it (``swept``:
   ``K.slab_*_bands`` on the whole slab with the band as its window);
3. ``sweep``: the phase as the ring runs it, ``parallel.slabs.sweep_bands``
   over bands of ``B`` cell rows (the listed ones and the band rule's,
   ``slabs.band_rows``) on ``K.slab_*_bands``, in each state layout of
   ``LAYOUTS`` (``--layouts``); the phase's state is held against the
   whole-slab phase (K21 bitwise; K22's x, v, active and step counts bitwise,
   la, mu and the gradient to the largest difference);
4. last, with the card's persisting L2 set aside (``cudaLimitPersistingL2CacheSize``,
   this process only; ``tools/slab_bands.cu``): the whole phase again, and
   the sweep at the rule's ``B`` without and with an access-policy window
   marking each launch's lowest band persisting.

``--halves`` also sweeps with only the rays that step up, or down, taking
part (the rest start done), at the rule's band and at 64: each launch then
has rays in one of its two bands.

For each it reports milliseconds (a sweep: summed over its launches),
ray-steps (the step counts' sum) and ray-steps per second; a sweep also its
sweeps and launches, the card's span from the first launch's start to the
last one's end, and the host's time.  Prints
the card's name and power limit and, last, one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("slab_bands: no CUDA device; this probe runs on the GPU only")

from adjointnonlinearraytracing_tpu_torch import parallel  # noqa: E402
from adjointnonlinearraytracing_tpu_torch.benchmarks import scenes  # noqa: E402
from adjointnonlinearraytracing_tpu_torch.fields import grid as G  # noqa: E402
from adjointnonlinearraytracing_tpu_torch.kernels import build  # noqa: E402
from adjointnonlinearraytracing_tpu_torch.kernels import wrappers as K  # noqa: E402
from adjointnonlinearraytracing_tpu_torch.parallel import slabs  # noqa: E402
from adjointnonlinearraytracing_tpu_torch.tracer import order as O  # noqa: E402

RES, NRAYS, SPAN = 1025, 1 << 18, 20.0
HELPER = Path(__file__).resolve().parent / "slab_bands.cu"


def smi_line():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]


def build_helper():
    """Compile the L2-window helper as ``build.py`` compiles the shipped sources."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = build.BUILD_DIR / "libslab_bands.so"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(HELPER)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {HELPER.name}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.probe_l2_limits.argtypes = [i, ctypes.POINTER(i), ctypes.POINTER(i)]
    lib.probe_l2_set_aside.argtypes = [ctypes.c_size_t]
    lib.probe_l2_window.argtypes = [vp, ctypes.c_size_t, ctypes.c_float, vp]
    return lib


def _check(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} returned CUDA error {rc}")


#: where the rays' state lies and how the kernels find it: "thread" (the ring's
#: layout: the state permuted into the ray order, thread i on row i),
#: "gather" (the single-launch design's: the caller's order, thread i on ray order[i]) and
#: "none" (the caller's order, no ray order)
LAYOUTS = ("thread", "gather", "none")


class Case:
    """Configuration 14's slab, rays and the two phases' start states."""

    def __init__(self, ranks=1):
        self.h = SPAN / (RES - 1)
        self.ds = self.h / 2
        self.res = (RES,) * 3
        x, v = scenes.z_rays(RES, NRAYS // ranks, SPAN, "float32")
        rif = scenes.bench_rows(RES, 0, RES, SPAN, "float32")
        mesh = parallel.make_ray_mesh()
        ring = slabs._Ring(mesh, self.h, self.ds, RES, None, 2, False)
        # rank 0's slab in the first phase of a ring of `ranks`: the padded
        # grid's rows [-1, S) (row -1 repeats row 0), and its share of the rays
        self.S = parallel.slab_rows(RES + 1, ranks)
        self.slab = ring._slab(parallel.pad_rif_z(rif, 1))[:self.S + 1].clone()
        del rif
        torch.cuda.empty_cache()
        self.K = max(int(self.S * self.h / self.ds) * 2, 8)
        self.nf, self.nb = ring.steps_f, ring.steps_b
        self.shape = slabs._grid_shape(self.slab, self.res, self.h)
        self.x, self.v = x, v
        self.order = O.ray_order(x, v, self.res, self.h)
        self.gslab = torch.zeros_like(self.slab)
        self.tol = G.snap_tol(self.slab.dtype)
        self.flush = torch.zeros(64 << 20, dtype=torch.float32, device="cuda")
        self.side = torch.cuda.Stream()

    def to_layout(self, st, layout):
        return list(slabs._permuted(self.order if layout == "thread" else None, *st))

    def from_layout(self, st, layout):
        return list(slabs._unpermuted(self.order if layout == "thread" else None, *st))

    def fwd_state(self, layout="gather", x=None):
        x = self.x if x is None else x
        n = x.shape[0]
        st = [x.clone(), self.v.clone(), x.clone(), self.v.clone(), G.inbounds(self.shape, x),
              torch.zeros(n, dtype=torch.bool, device="cuda"),
              torch.zeros(n, dtype=torch.int32, device="cuda")]
        return self.to_layout(st, layout)

    def set_bwd_start(self, st):
        """The adjoint phase's start state from a finished forward phase ``st``."""
        xt = torch.where(st[5][:, None], st[2], st[0])
        centre = torch.full((3,), SPAN / 2, dtype=xt.dtype, device="cuda")
        dx, dv = 2.0 * (xt - centre), torch.ones_like(st[3])
        self.bwd0 = [xt, st[3].clone(), dx, dv + G._scalar(self.ds, dx) * dx,
                     ~G.escaped(self.shape, xt, -st[3]),
                     torch.zeros(xt.shape[0], dtype=torch.int32, device="cuda")]

    def bwd_state(self, layout="gather", x=None):
        st = [t.clone() for t in self.bwd0]
        if x is not None:
            st[0] = x.clone()
            st[4] = torch.ones_like(st[4])
        return self.to_layout(st, layout)

    def launch(self, kind, st, b0, rows, order, gslab=None):
        """K21 or K22 in one launch on the slab's voxel rows ``[b0, b0 + rows)``."""
        view = self.slab[b0:b0 + rows]
        zf = -1 + b0
        if kind == "K21":
            return K.slab_trace_phase(view, self.res, zf, self.h, self.ds, *st, self.nf,
                                      self.K, order=order)
        g = self.gslab if gslab is None else gslab
        return K.slab_backtrace_phase(view, self.res, zf, self.h, self.ds, self.tol, *st,
                                      g[b0:b0 + rows], self.nb, self.K, order=order)

    def bands(self, kind, st, order):
        """The ring's phase function for ``sweep_bands`` on the whole slab."""
        if kind == "K21":
            return K.slab_trace_bands(self.slab, self.res, -1, self.h, self.ds, *st, self.nf,
                                      self.K, order=order)
        return K.slab_backtrace_bands(self.slab, self.res, -1, self.h, self.ds, self.tol, *st,
                                      self.gslab, self.nb, self.K, order=order)


def timed(fn, per_launch=True):
    """Run ``fn``; (kernel ms each, card span ms, host ms).  With ``per_launch``
    every launch is timed with two events of its own (the span: from the first
    one's start to the last one's end); without, two events around ``fn``
    alone, so that the host records no more than the launches themselves."""
    events = []
    torch.cuda.synchronize()
    K.record_events(events if per_launch else None)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    try:
        t0 = time.time()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        host = 1e3 * (time.time() - t0)
    finally:
        K.record_events(None)
    if not per_launch:
        return [], a.elapsed_time(b), host
    each = [x.elapsed_time(y) for _, x, y in events]
    return each, events[0][1].elapsed_time(events[-1][2]), host


def median(values):
    s = sorted(values)
    return s[len(s) // 2]


def rate(steps, ms):
    return steps / (ms / 1e3) if ms > 0 else None


def whole(c, kind, layout, reps):
    """One launch over the whole slab."""
    order = c.order if layout == "gather" else None
    times = []
    for _ in range(reps):
        st = c.fwd_state(layout) if kind == "K21" else c.bwd_state(layout)
        if kind == "K22":
            c.gslab.zero_()
        times.append(timed(lambda: c.launch(kind, st, 0, c.S + 1, order))[0][0])
    steps = int(st[-1].sum())
    ms = median(times)
    return dict(ms=ms, ray_steps=steps, ray_steps_per_s=rate(steps, ms)), c.from_layout(st, layout)


def band(c, kind, B, reps):
    """One launch on a band of B cell rows in the middle of the slab, every ray in
    it, the state in the ring's layout: on a view of the band's rows after L2
    was emptied (``cold``) and again (``warm``), and as the ring launches it
    (``swept``: the whole slab, the band a window, the gate written)."""
    b0 = c.S // 2 - B // 2
    zf = -1 + b0  # the band's cells are zf + 1 .. zf + B; cell k holds z in [(k-1)h, kh)
    up = c.v[:, 2] > 0
    rise = up if kind == "K21" else ~up  # K22 steps x -= ds * v
    x = c.x.clone()
    x[:, 2] = torch.where(rise, (zf + 0.25) * c.h, (zf + B - 0.25) * c.h).to(x.dtype)
    gband = torch.zeros_like(c.slab[:B + 1])
    out = {}
    for label in ("cold", "warm", "swept"):
        times = []
        for _ in range(reps):
            st = c.fwd_state("thread", x) if kind == "K21" else c.bwd_state("thread", x)
            if label != "warm":
                c.flush.sum()
            if label == "swept":  # as the ring launches it: the whole slab, the band's window
                c.gslab.zero_()
                phase = c.bands(kind, st, None)
                times.append(timed(lambda: phase([(b0, B + 1)], True, True))[0][0])
                continue
            times.append(timed(lambda: c.launch(kind, st, b0, B + 1, None,
                                                gslab=None if kind == "K21" else
                                                _shifted(gband, b0)))[0][0])
        steps = int(st[-1].sum())
        out[label] = dict(ms=median(times), ray_steps=steps,
                          ray_steps_per_s=rate(steps, median(times)))
    return out


class _shifted:
    """A band's gradient rows addressed as the slab's rows ``[b0, ...)``."""

    def __init__(self, rows, b0):
        self.rows, self.b0 = rows, b0

    def __getitem__(self, sl):
        return self.rows[sl.start - self.b0:sl.stop - self.b0]


def sweep(c, kind, B, layout, reps, ref, l2=None, half=None):
    """The phase as the ring runs it: ``parallel.slabs.sweep_bands`` over bands of
    B cell rows on ``K.slab_*_bands``.  Times the sweep alone (two events) and
    again with each launch timed.  ``half`` "up" or "down": only the rays that
    step that way along z take part (the others start done), so that a
    launch's rays lie in one of its two bands; not held to ``ref``."""
    order = c.order if layout == "gather" else None
    stream = torch.cuda.current_stream().cuda_stream

    def run(st):
        phase = c.bands(kind, st, order)

        def one(windows, first, last):
            if l2 is not None:  # the window is one range: the launch's lowest band
                lo, rows = windows[0]
                view = c.slab[lo:lo + rows]
                nbytes = view.numel() * view.element_size()
                _check(l2["lib"].probe_l2_window(view.data_ptr(), nbytes,
                                                 min(1.0, l2["aside"] / nbytes), stream),
                       "probe_l2_window")
            return phase(windows, first, last)

        out = slabs.sweep_bands(one, c.S, B)
        if l2 is not None:
            _check(l2["lib"].probe_l2_window(None, 0, 0.0, stream), "probe_l2_window")
        return out

    rec = {True: [], False: []}
    for per_launch in (False, True):
        for _ in range(reps):
            st = c.fwd_state(layout) if kind == "K21" else c.bwd_state(layout)
            if half is not None:  # K21 steps along v, K22 against it
                up = (st[1][:, 2] > 0) == (kind == "K21")
                other = ~up if half == "up" else up
                if kind == "K21":
                    st[5] |= other
                else:
                    st[4] &= ~other
            if kind == "K22":
                c.gslab.zero_()
            got = []
            # the window is a stream's attribute: a stream of its own, not the default one
            with torch.cuda.stream(c.side if l2 is not None else torch.cuda.current_stream()):
                each, span, host = timed(lambda: got.append(run(st)), per_launch)
            rec[per_launch].append((sum(each), span, host, max(each, default=0.0)))
    _, sweeps, launches = got[0]
    steps = int(st[-1].sum())
    ms = median([r[1] for r in rec[False]])
    out = dict(B=B, sweeps=sweeps, launches=launches, ms=ms,
               host_ms=median([r[2] for r in rec[False]]),
               kernel_ms=median([r[0] for r in rec[True]]),
               timed_span_ms=median([r[1] for r in rec[True]]),
               timed_host_ms=median([r[2] for r in rec[True]]),
               longest_launch_ms=median([r[3] for r in rec[True]]), ray_steps=steps,
               ray_steps_per_s=rate(steps, ms))
    if half is not None:
        return out
    st = c.from_layout(st, layout)
    ref_st, ref_g = ref
    if kind == "K21":
        out["bitwise"] = all(torch.equal(a, b) for a, b in zip(st, ref_st))
    else:
        out["state_bitwise"] = all(torch.equal(st[i], ref_st[i]) for i in (0, 1, 4, 5))
        scale = max(float(ref_g.abs().max()), 1e-30)
        out["la_mu_abs_err"] = max(float((st[i] - ref_st[i]).abs().max()) for i in (2, 3))
        out["grad_rel_err"] = float((c.gslab - ref_g).abs().max()) / scale
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bands", default="2,3,4,5,6,8")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--layouts", default=",".join(LAYOUTS),
                    help="the sweeps' state layouts (thread, gather, none)")
    ap.add_argument("--ranks", type=int, default=1,
                    help="time rank 0's first phase of a ring of this many ranks instead "
                         "(its slab, its share of the rays)")
    ap.add_argument("--halves", action="store_true",
                    help="also sweeps in which only the rays going up, or down, step")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    bands = [int(b) for b in args.bands.split(",")]
    layouts = args.layouts.split(",")

    t0 = time.time()
    build.load("slab_trace_phase")
    helper = build_helper()
    device = torch.cuda.current_device()
    max_window, max_persist = ctypes.c_int(0), ctypes.c_int(0)
    _check(helper.probe_l2_limits(device, ctypes.byref(max_window), ctypes.byref(max_persist)),
           "probe_l2_limits")
    props = torch.cuda.get_device_properties(device)
    row_bytes = RES * RES * 4
    rule = {kind: slabs.band_rows(row_bytes, props.L2_cache_size, planes)
            for kind, planes in (("K21", 1), ("K22", 2))}
    waves = {kind: K.slab_wave(torch.device("cuda"), torch.float32, kind == "K22")
             for kind in ("K21", "K22")}
    print(f"build and helper {time.time() - t0:.1f} s; L2 {props.L2_cache_size} B, largest "
          f"window {max_window.value} B, persisting set-aside at most {max_persist.value} B; "
          f"the band rule's B {rule}; a wave holds {waves} rays", flush=True)
    for line in build.build_logs().get("slab", "").splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"nvcc[slab] {line.strip()}", flush=True)
    c = Case(args.ranks)
    rec = dict(res=RES, rays=NRAYS // args.ranks, ranks=args.ranks, S=c.S, K=c.K,
               row_bytes=row_bytes,
               l2_bytes=props.L2_cache_size, l2_max_window=max_window.value,
               l2_persisting=max_persist.value, rule_B=rule, wave_rays=waves, whole={},
               band={}, sweep={})
    refs = {}
    for kind in ("K21", "K22"):
        for layout in LAYOUTS:
            r, st = whole(c, kind, layout, args.reps)
            rec["whole"][f"{kind} {layout}"] = r
            if layout == "gather":  # the single-launch design: the reference
                refs[kind] = ([t.clone() for t in st],
                              c.gslab.clone() if kind == "K22" else None)
        if kind == "K21":
            c.set_bwd_start(refs["K21"][0])
        print(f"whole {kind}: " + json.dumps({k: v for k, v in rec["whole"].items()
                                              if k.startswith(kind)}), flush=True)
    for kind in ("K21", "K22"):
        for B in bands:
            rec["band"][f"{kind} B={B}"] = band(c, kind, B, args.reps)
        print(f"band {kind}: " + json.dumps({k: v for k, v in rec["band"].items()
                                             if k.startswith(kind)}), flush=True)
    for kind in ("K21", "K22"):
        for B in sorted(set(bands) | {rule[kind]}):
            for layout in layouts:
                rec["sweep"][f"{kind} B={B} {layout}"] = sweep(c, kind, B, layout, args.reps,
                                                              refs[kind])
        print(f"sweep {kind}: " + json.dumps({k: v for k, v in rec["sweep"].items()
                                              if k.startswith(kind)}), flush=True)
    if args.halves:  # a launch's rays in one of its two bands, or in both
        for kind in ("K21", "K22"):
            for B in sorted({rule[kind], 64}):
                for half in ("up", "down"):
                    rec["sweep"][f"{kind} B={B} thread, {half} only"] = sweep(
                        c, kind, B, "thread", args.reps, refs[kind], half=half)
        print("halves: " + json.dumps({k: v for k, v in rec["sweep"].items() if "only" in k}),
              flush=True)
    # last, with L2 set aside for persisting lines (it stays so for the process):
    # the whole phase again, and the sweep at the rule's B with each band's window
    _check(helper.probe_l2_set_aside(max_persist.value), "probe_l2_set_aside")
    l2 = dict(lib=helper, aside=max_persist.value)
    for kind in ("K21", "K22"):
        rec["whole"][f"{kind} gather, L2 set aside"] = whole(c, kind, "gather", args.reps)[0]
        B = rule[kind]
        rec["sweep"][f"{kind} B={B} thread, L2 set aside"] = sweep(
            c, kind, B, "thread", args.reps, refs[kind])
        rec["sweep"][f"{kind} B={B} thread, L2 window"] = sweep(
            c, kind, B, "thread", args.reps, refs[kind], l2)
    _check(helper.probe_l2_set_aside(0), "probe_l2_set_aside")
    print("L2 set aside: " + json.dumps({k: v for k, v in {**rec["whole"], **rec["sweep"]}.items()
                                         if "L2" in k}), flush=True)
    rec["seconds"] = time.time() - t0
    card = smi_line()
    rec["card"] = card
    print(card, flush=True)
    line = json.dumps(rec)
    if args.out:
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
