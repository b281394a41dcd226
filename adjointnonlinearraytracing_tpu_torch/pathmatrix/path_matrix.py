"""Classical linear-tomography operator construction + solvers.

Host-side numpy/scipy copy of ``adjointnonlinearraytracing_tpu/pathmatrix/
path_matrix.py`` (the reference's ``path_matrix/path_matrix.py``): the
independent baseline used to sanity-check the nonlinear tracer (Atcheson et
al. 2008 style): march each ray's (linear/hermite/recorded) path through the
voxel grid accumulating per-voxel path lengths into a sparse matrix Phi,
build finite-difference operators per axis, solve Phi g = deflections with
LSQR per axis, and Poisson-integrate the gradient fields under Dirichlet
boundary conditions.

This is deliberately CPU/scipy (sparse LSQR on the host); the GPU part of the
pipeline, tracing the ground-truth rays, is the port's tracer (K2; see
``fuel2008.py``).  The marcher of :func:`construct_voxel_matrix` is the
native one (``native/pathmatrix.cpp``, built at first use; a failed build
raises) unless the caller passes ``native=False`` for the numpy loop.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.sparse import coo_matrix, spdiags, vstack
from scipy.sparse import linalg
from scipy.sparse.linalg import LinearOperator


# ---------------------------------------------------------------------------
# path parameterizations (path_matrix.py:230-255)
# ---------------------------------------------------------------------------

def get_linear_path(p0, d0, p1, d1, t):
    return (1 - t) * p0 + t * p1


def get_hermite_path(p0, d0, p1, d1, t):
    return ((2 * t ** 3 - 3 * t ** 2 + 1) * p0
            + (t ** 3 - 2 * t ** 2 + t) * d0
            + (-2 * t ** 3 + 3 * t ** 2) * p1
            + (t ** 3 - t ** 2) * d1)


def get_true_path(p0, d0, p1, d1, t, path, path_start, path_end):
    """Interpolate recorded per-ray trajectories (path stored as flattened
    (steps * num_rays, dim) with per-ray start/end step indices)."""
    num_rays = p0.shape[0]
    idx = t * (path_end - path_start) + path_start
    idx_l = np.floor(idx).astype(int)
    idx_h = np.ceil(idx).astype(int)
    a = (idx_h - idx)[:, None]
    idx_l = num_rays * idx_l + np.arange(num_rays)
    idx_h = num_rays * idx_h + np.arange(num_rays)
    return a * path[idx_l, :] + (1 - a) * path[idx_h, :]


# ---------------------------------------------------------------------------
# voxel path matrix (path_matrix.py:8-76)
# ---------------------------------------------------------------------------

def which_voxel(p, box_dim, res):
    """Flat voxel index of points (Fortran-ish: ind = iz*res^2 + iy*res + ix)."""
    if p.ndim == 1:
        p = p[None, :]
    ii = [np.clip(np.floor(p[:, d] / box_dim), 0, res - 1)
          for d in range(p.shape[1])]
    ind = ii[0].copy()
    for d in range(1, p.shape[1]):
        ind = ind + ii[d] * (res ** d)
    return ind.astype(int)


def construct_voxel_matrix(spos, sdir, epos, edir, dim, res, spline="linear",
                           int_res=175, path=None, native=True):
    """Accumulate per-voxel path lengths into sparse Phi (num_rays x res^D).

    March the chosen path parameterization in ``int_res`` substeps; each time
    the voxel id changes (and at the final step), flush the accumulated arc
    length into the (ray, previous_voxel) entry.  ``native`` (default) runs
    the C++ single-pass marcher, built at first use (a failed build raises);
    ``native=False`` the numpy loop below.
    """
    if spos.size == 0:
        dimension = spos.shape[1] if spos.ndim == 2 else 3
        return coo_matrix((0, res ** dimension)).tocsr()
    num_rays, dimension = spos.shape
    if spline not in ("linear", "hermite", "true"):
        raise ValueError(f"unknown spline {spline!r}")
    if spline == "true" and path is None:
        raise ValueError("spline 'true' needs the recorded paths (path=...)")

    if native:
        from ..native.loader import accumulate_paths

        box_dim = dim / max(1, res)
        pbuf, ps, pe = path if spline == "true" else (None, None, None)
        data, row, col = accumulate_paths(
            spos, sdir, epos, edir, box_dim, res, int_res,
            spline=spline, path=pbuf, path_start=ps, path_end=pe)
        phi = coo_matrix((data, (row, col)),
                         shape=(num_rays, res ** dimension)).tocsr()
        phi.sum_duplicates()
        return phi

    if spline == "linear":
        spline_func = get_linear_path
    elif spline == "hermite":
        spline_func = get_hermite_path
    else:
        def spline_func(p0, d0, p1, d1, t):
            return get_true_path(p0, d0, p1, d1, t, path[0], path[1], path[2])

    box_dim = dim / max(1, res)
    data_chunks, row_chunks, col_chunks = [], [], []

    p_pre = spline_func(spos, sdir, epos, edir, 0.0)
    ind_pre = which_voxel(p_pre, box_dim, res)
    dist = np.zeros(num_rays)

    for j in range(int_res):
        p_cur = spline_func(spos, sdir, epos, edir, (j + 1) / int_res)
        ind_cur = which_voxel(p_cur, box_dim, res)

        changed = ind_pre != ind_cur
        if j == int_res - 1:
            changed = np.ones(num_rays, dtype=bool)

        dist = dist + np.sqrt(((p_cur - p_pre) ** 2).sum(1))

        data_chunks.append(dist[changed])
        col_chunks.append(ind_pre[changed])
        row_chunks.append(np.flatnonzero(changed))

        dist[changed] = 0.0
        ind_pre = ind_cur.copy()
        p_pre = p_cur

    phi = coo_matrix(
        (np.concatenate(data_chunks),
         (np.concatenate(row_chunks), np.concatenate(col_chunks))),
        shape=(num_rays, res ** dimension)).tocsr()
    # duplicate (row, col) entries sum, handling revisited voxels
    phi.sum_duplicates()
    return phi


# ---------------------------------------------------------------------------
# finite-difference / boundary operators (path_matrix.py:79-143)
# ---------------------------------------------------------------------------

def construct_diff_matrices(res, vol_dim, dimension):
    """Forward-difference operator per axis, Kronecker-lifted to the volume."""
    box_dim = vol_dim / max(1, res)
    data = np.concatenate((-np.ones((1, res)), np.ones((1, res))))
    data[0, -1] = 0.0
    diff = spdiags(data, np.array([0, 1]), res, res)
    I = sp.eye(res)

    diff_list = []
    if dimension == 2:
        diff_list = [sp.kron(I, diff), sp.kron(diff, I)]
    elif dimension == 3:
        diff_list = [
            sp.kron(I, sp.kron(I, diff)),
            sp.kron(I, sp.kron(diff, I)),
            sp.kron(diff, sp.kron(I, I)),
        ]
    return [(1.0 / box_dim) * d for d in diff_list]


def construct_deflection_matrix(phi, diff_mats):
    full_A = None
    for d in diff_mats:
        full_A = vstack([full_A, phi.dot(d)])
    return full_A


def construct_deflection_matrix_direct(phi, res, vol_dim, dimension):
    return construct_deflection_matrix(
        phi, construct_diff_matrices(res, vol_dim, dimension))


def construct_boundary_conditions(res, dimension, val):
    """Dirichlet rows pinning every boundary voxel to ``val``."""
    num_voxels = res ** dimension
    if dimension == 2:
        num_constraints = 4 * (res - 1)
    else:
        num_constraints = 6 * res * res - 12 * res + 8

    rows, cols = [], []
    idx = 0
    for i in range(num_voxels):
        z = i // (res * res)
        y = (i % (res * res)) // res
        x = i % res
        if (x == 0 or y == 0 or (z == 0 and dimension > 2)
                or x == res - 1 or y == res - 1 or z == res - 1):
            rows.append(idx)
            cols.append(i)
            idx += 1
    c_mat = coo_matrix((np.ones(len(rows)), (rows, cols)),
                       shape=(max(num_constraints, len(rows)), num_voxels))
    c_sol = val * np.ones((c_mat.shape[0], 1))
    return c_mat, c_sol


# ---------------------------------------------------------------------------
# solvers (path_matrix.py:182-228)
# ---------------------------------------------------------------------------

def deflection_solve_gradient(phi, deflection, damp=0):
    """Per-axis LSQR of Phi g_axis = deflection_axis."""
    return [linalg.lsqr(phi, deflection[:, i], damp, show=False)
            for i in range(deflection.shape[1])]


def gradient_integration(diff_mats, constraints, gradients, damp=0):
    """LSQR Poisson integration: stack [C; D_x; D_y; D_z] x = [c; g]."""
    full_A = constraints[0]
    full_b = constraints[1]
    for i, d in enumerate(diff_mats):
        full_A = vstack([full_A, d])
        full_b = np.vstack([full_b, gradients[i][0][:, None]])
    return linalg.lsqr(full_A, full_b, damp, show=False)


def deflection_solve(defl_mat, constraints, deflection, damp=0.0):
    """Joint solve of the stacked deflection system."""
    full_A = vstack([constraints[0], defl_mat])
    full_b = np.vstack([constraints[1],
                        np.reshape(deflection, (-1, 1), order="F")])
    result = linalg.lsqr(full_A, full_b, damp, show=False)
    return result


def deflection_solve_lin_op(defl_mat, constraints, deflection, damp=0.0,
                            x0=None):
    """CG on the normal equations via a LinearOperator."""
    full_A = vstack([constraints[0], defl_mat]).tocsr()
    b = np.vstack([constraints[1],
                   np.reshape(deflection, (-1, 1), order="F")])
    shape = full_A.shape
    A = LinearOperator((shape[1], shape[1]),
                       lambda x: full_A.T.dot(full_A.dot(x)) - damp * x)
    result = linalg.cg(A, full_A.T.dot(b).ravel(), rtol=1e-10, x0=x0)
    res = full_A.dot(result[0]) - b.squeeze()
    res_act = np.linalg.norm(res) / np.linalg.norm(b.squeeze())
    return result, res_act


def tof_solve(phi, tof, damp=0.0):
    return linalg.lsqr(phi, tof, damp)
