"""Build-on-first-use loader for the native path-matrix marcher.

Copy of the JAX package's ``native/loader.py`` with two differences: the
library is built with ``g++`` from this package's own ``pathmatrix.cpp`` into
``kernels/_build/`` (git-ignored; the name carries a hash of the source, so an
edited source is rebuilt), never next to the source, and only when a function
here is first called (importing builds nothing); and a failed build raises
instead of returning ``None``, so that no caller falls back quietly.  The
numpy marcher runs only when asked for (``path_matrix.construct_voxel_matrix
(..., native=False)``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..kernels.build import BUILD_DIR

SRC = Path(__file__).resolve().parent / "pathmatrix.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")
_lock = threading.Lock()
_lib = None


def lib_path() -> Path:
    """Where the library of the current source lives."""
    hsh = hashlib.sha256(" ".join(GXX_FLAGS).encode() + SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libpathmatrix_{hsh}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build {SRC.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)


def get_lib() -> ctypes.CDLL:
    """The loaded library; builds it on the first call (raises if it cannot)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = lib_path()
        if not out.exists():
            _build(out)
        lib = ctypes.CDLL(str(out))
        fl = lib.accumulate_linear_paths
        fl.restype = ctypes.c_int64
        fl.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,   # spos, epos
            ctypes.c_int64, ctypes.c_int32,     # num_rays, dim_count
            ctypes.c_double, ctypes.c_int32,    # box_dim, res
            ctypes.c_int32,                     # int_res
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # out buffers
        ]
        fn = lib.accumulate_paths
        fn.restype = ctypes.c_int64
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,   # spos, sdir
            ctypes.c_void_p, ctypes.c_void_p,   # epos, edir
            ctypes.c_int64, ctypes.c_int32,     # num_rays, dim_count
            ctypes.c_double, ctypes.c_int32,    # box_dim, res
            ctypes.c_int32, ctypes.c_int32,     # int_res, mode
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # path buffers
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # out buffers
        ]
        _lib = lib
        return _lib


def accumulate_linear_paths(spos, epos, box_dim, res, int_res):
    """Native marching over straight paths; returns the COO triplets
    ``(data, row, col)`` as numpy arrays.

    Buffers are sized ``num_rays * (int_res + 1)``: one emit per substep at most.
    """
    lib = get_lib()
    spos = np.ascontiguousarray(spos, dtype=np.float64)
    epos = np.ascontiguousarray(epos, dtype=np.float64)
    num_rays, dim = spos.shape
    cap = num_rays * (int_res + 1)
    data = np.empty(cap, dtype=np.float64)
    row = np.empty(cap, dtype=np.int64)
    col = np.empty(cap, dtype=np.int64)
    n = lib.accumulate_linear_paths(
        spos.ctypes.data, epos.ctypes.data,
        ctypes.c_int64(num_rays), ctypes.c_int32(dim),
        ctypes.c_double(box_dim), ctypes.c_int32(res),
        ctypes.c_int32(int_res),
        data.ctypes.data, row.ctypes.data, col.ctypes.data)
    return data[:n], row[:n], col[:n]


_MODES = {"linear": 0, "hermite": 1, "true": 2}


def accumulate_paths(spos, sdir, epos, edir, box_dim, res, int_res,
                     spline="linear", path=None, path_start=None, path_end=None):
    """Native marching over linear / hermite / recorded paths; returns the
    COO triplets ``(data, row, col)`` as numpy arrays.

    For ``spline='true'``, ``path`` is the flattened ``(steps * num_rays,
    dim)`` trajectory buffer and ``path_start`` / ``path_end`` the per-ray
    fractional step bounds, as in ``path_matrix.get_true_path``.  Buffers are
    sized ``num_rays * (int_res + 1)``: one emit per substep at most.
    """
    lib = get_lib()
    mode = _MODES[spline]
    spos = np.ascontiguousarray(spos, dtype=np.float64)
    epos = np.ascontiguousarray(epos, dtype=np.float64)
    num_rays, dim = spos.shape

    def _buf(a):
        if a is None:
            return None, 0
        a = np.ascontiguousarray(a, dtype=np.float64)
        return a, a.ctypes.data

    sdir, sdir_p = _buf(sdir if mode == 1 else None)
    edir, edir_p = _buf(edir if mode == 1 else None)
    path, path_p = _buf(path if mode == 2 else None)
    pstart, pstart_p = _buf(path_start if mode == 2 else None)
    pend, pend_p = _buf(path_end if mode == 2 else None)

    cap = num_rays * (int_res + 1)
    data = np.empty(cap, dtype=np.float64)
    row = np.empty(cap, dtype=np.int64)
    col = np.empty(cap, dtype=np.int64)
    n = lib.accumulate_paths(
        spos.ctypes.data, sdir_p, epos.ctypes.data, edir_p,
        ctypes.c_int64(num_rays), ctypes.c_int32(dim),
        ctypes.c_double(box_dim), ctypes.c_int32(res),
        ctypes.c_int32(int_res), ctypes.c_int32(mode),
        path_p, pstart_p, pend_p,
        data.ctypes.data, row.ctypes.data, col.ctypes.data)
    return data[:n], row[:n], col[:n]
