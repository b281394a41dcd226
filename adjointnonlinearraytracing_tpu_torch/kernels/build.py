"""Build the CUDA kernels at first use and load them with ``ctypes``.

Each ``csrc/*.cu`` has a plain C interface (no PyTorch headers), so ``nvcc``
compiles it in seconds; all of them compile in parallel into one shared library
each.  A source may hold more than one kernel (``SOURCE``: K2 ``trace_fwd``,
K5 ``trace_ckpt``, the variants K11-K13 ``trace_plane``, ``trace_target``,
``trace_sdf``, their exact forward passes K15-K17 ``trace_*_ckpt`` and K20
``record_paths`` are K2's step in ``trace_fwd.cu``; K6 ``backtrace_exact``
and K18, K19 ``backtrace_plane_exact``, ``backtrace_sdf_exact`` one replaying ray in
``backtrace_exact.cu``; K3 ``backtrace`` and K14 ``backtrace_sdf`` one
adjoint ray in ``backtrace.cu``; K7 ``trace_cable`` and K9
``trace_cable_ckpt`` one loop in ``trace_cable.cu``; K21 ``slab_trace_phase`` and
K22 ``slab_backtrace_phase``, one phase of the z-slab ring, in ``slab.cu``).  Libraries go to
``kernels/_build/`` (git-ignored) under a name that carries a hash of the
sources and flags, so an edited source is rebuilt and an unchanged one is
reused.

Flags: ``sm_90a`` only, and ``-fmad=false``.  Without FMA contraction the
kernels repeat the plain torch arithmetic (separate multiply and add kernels)
rounding for rounding, so a position exactly on a node or face takes the same
``floor`` / ``inbounds`` / ``escaped`` decision in both; the steppers are not
bound by the multiply-add rate, so the cost is small.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
KERNELS = ("eval_grad", "trace_fwd", "backtrace", "gather_rows", "trace_ckpt",
           "backtrace_exact", "trace_cable", "backtrace_cable", "trace_cable_ckpt",
           "backtrace_cable_exact", "trace_plane", "trace_target", "trace_sdf",
           "backtrace_sdf", "trace_plane_ckpt", "trace_target_ckpt", "trace_sdf_ckpt",
           "backtrace_plane_exact", "backtrace_sdf_exact", "record_paths", "slab_trace_phase",
           "slab_backtrace_phase")
#: the source (``csrc/<name>.cu``) that holds each kernel
SOURCE = {**{k: k for k in KERNELS}, "trace_ckpt": "trace_fwd",
          "trace_cable_ckpt": "trace_cable", "trace_plane": "trace_fwd",
          "trace_target": "trace_fwd", "trace_sdf": "trace_fwd", "backtrace_sdf": "backtrace",
          "record_paths": "trace_fwd", "slab_trace_phase": "slab", "slab_backtrace_phase": "slab",
          **{f"trace_{v}_ckpt": "trace_fwd" for v in ("plane", "target", "sdf")},
          **{f"backtrace_{v}_exact": "backtrace_exact" for v in ("plane", "sdf")}}
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: the kernels need nvcc to build")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _digest() -> str:
    hsh = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        hsh.update(src.name.encode())
        hsh.update(src.read_bytes())
    return hsh.hexdigest()[:16]


def _build_all() -> Dict[str, ctypes.CDLL]:
    """Compile every source that has no current library, all at once, and load them."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = _digest()
    targets = {k: BUILD_DIR / f"lib{k}_{tag}.so" for k in sorted(set(SOURCE.values()))}
    procs = {}
    for name, out in targets.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failures = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, targets[name])
    if failures:
        raise RuntimeError("\n".join(failures))
    return {name: ctypes.CDLL(str(out)) for name, out in targets.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library that holds kernel ``name``; builds all kernels on first call."""
    with _lock:
        if not _libs:
            _libs.update(_build_all())
        return _libs[SOURCE[name]]


def build_logs() -> Dict[str, str]:
    """What nvcc printed for each source built by this checkout (registers, spills)."""
    return {p.stem: p.read_text() for p in sorted(BUILD_DIR.glob("*.log"))}
