// Trilinear voxel-field routines shared by the three kernels of the port:
// clamped 8-corner fetch, value, gradient, off-diagonal Hessian and the splat
// (transpose of value + gradient) with atomicAdd.
//
// Semantics are those of fields/grid.py: data[z, y, x] with p = (x, y, z),
// flat index (z*H + y)*W + x, pm = p / h as a true division, both corners
// clamped to [0, res-1] per corner, a masked lane gathers 0, the gradient and
// the gradient part of the splat carry 1/h.  The arithmetic repeats the plain
// torch version operation by operation; compile with -fmad=false so that
// floor(), inbounds() and escaped() decide alike on nodes and faces.
#pragma once

#include <cuda_runtime.h>

namespace anrt {

template <typename T>
struct Grid {
  const T* data;   // (D, H, W) contiguous
  int W, H, D;     // res_x, res_y, res_z
  T h;             // voxel spacing
  T inv_h;         // 1/h, rounded from double as the plain version does
  T inv_h2;        // 1/(h*h), likewise
  T hi[3];         // upper face per axis: (res - 1) * h in T
};

template <typename T>
__host__ inline Grid<T> make_grid(const void* data, int W, int H, int D, double h) {
  Grid<T> g;
  g.data = static_cast<const T*>(data);
  g.W = W; g.H = H; g.D = D;
  g.h = static_cast<T>(h);
  g.inv_h = static_cast<T>(1.0 / h);
  g.inv_h2 = static_cast<T>(1.0 / (h * h));
  g.hi[0] = static_cast<T>(W - 1) * g.h;
  g.hi[1] = static_cast<T>(H - 1) * g.h;
  g.hi[2] = static_cast<T>(D - 1) * g.h;
  return g;
}

// The 8 corners of the cell that holds p: flat indices idx[a][b][c]
// (a: x-corner, b: y-corner, c: z-corner) and the fractional offsets w0.
template <typename T>
struct Stencil {
  int idx[2][2][2];
  T w0[3];
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

template <typename T>
__device__ __forceinline__ Stencil<T> stencil(const Grid<T>& g, const T p[3]) {
  Stencil<T> s;
  const int res[3] = {g.W, g.H, g.D};
  int c[3][2];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const T pm = p[k] / g.h;
    const T posf = floor(pm);
    s.w0[k] = pm - posf;  // may leave [0, 1] off-grid
    // clamp in floating point first so the cast to int cannot overflow
    const T lo = static_cast<T>(-2), hi = static_cast<T>(res[k] + 1);
    const int pos = static_cast<int>(posf < lo ? lo : (posf > hi ? hi : posf));
    c[k][0] = clampi(pos, 0, res[k] - 1);
    c[k][1] = clampi(pos + 1, 0, res[k] - 1);
  }
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc)
        s.idx[a][b][cc] = (c[2][cc] * g.H + c[1][b]) * g.W + c[0][a];
  return s;
}

// Corner values v[a][b][c]; a masked lane reads nothing and gets zeros.
template <typename T>
__device__ __forceinline__ void fetch(const Grid<T>& g, const Stencil<T>& s, bool mask,
                                      T v[2][2][2]) {
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        v[a][b][c] = mask ? __ldg(g.data + s.idx[a][b][c]) : static_cast<T>(0);
}

// Value n and gradient grad (with 1/h) from the corner values.
template <typename T>
__device__ __forceinline__ void value_grad(const Grid<T>& g, const T v[2][2][2],
                                           const T w0[3], T& n, T grad[3]) {
  const T wx[2] = {static_cast<T>(1) - w0[0], w0[0]};
  const T wy[2] = {static_cast<T>(1) - w0[1], w0[1]};
  const T wz[2] = {static_cast<T>(1) - w0[2], w0[2]};

  T vy[2][2], vyz[2];  // vy[a][c], vyz[a]
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int c = 0; c < 2; ++c) vy[a][c] = wy[0] * v[a][0][c] + wy[1] * v[a][1][c];
    vyz[a] = wz[0] * vy[a][0] + wz[1] * vy[a][1];
  }
  n = wx[0] * vyz[0] + wx[1] * vyz[1];
  grad[0] = (vyz[1] - vyz[0]) * g.inv_h;

  T vx[2][2], vxz[2];  // vx[b][c], vxz[b]
#pragma unroll
  for (int b = 0; b < 2; ++b) {
#pragma unroll
    for (int c = 0; c < 2; ++c) vx[b][c] = wx[0] * v[0][b][c] + wx[1] * v[1][b][c];
    vxz[b] = wz[0] * vx[b][0] + wz[1] * vx[b][1];
  }
  grad[1] = (vxz[1] - vxz[0]) * g.inv_h;

  T vxy[2];  // vxy[c]
#pragma unroll
  for (int c = 0; c < 2; ++c) vxy[c] = wy[0] * vx[0][c] + wy[1] * vx[1][c];
  grad[2] = (vxy[1] - vxy[0]) * g.inv_h;
}

// Off-diagonal Hessian (dxdy, dxdz, dydz), with 1/h^2.
template <typename T>
__device__ __forceinline__ void hessian(const Grid<T>& g, const T v[2][2][2],
                                        const T w0[3], T hess[3]) {
  const T xy0 = v[1][1][0] - v[0][1][0] - v[1][0][0] + v[0][0][0];
  const T xy1 = v[1][1][1] - v[0][1][1] - v[1][0][1] + v[0][0][1];
  const T xz0 = v[1][0][1] - v[0][0][1] - v[1][0][0] + v[0][0][0];
  const T xz1 = v[1][1][1] - v[0][1][1] - v[1][1][0] + v[0][1][0];
  const T yz0 = v[0][1][1] - v[0][0][1] - v[0][1][0] + v[0][0][0];
  const T yz1 = v[1][1][1] - v[1][0][1] - v[1][1][0] + v[1][0][0];
  hess[0] = (xy0 + w0[2] * (xy1 - xy0)) * g.inv_h2;
  hess[1] = (xz0 + w0[1] * (xz1 - xz0)) * g.inv_h2;
  hess[2] = (yz0 + w0[0] * (yz1 - yz0)) * g.inv_h2;
}

// Transpose of value_grad with respect to the voxel data: adds
// val * B_i(p) + grad . dB_i(p) to the 8 corners.  The order of the atomic
// adds across rays is not fixed, so the sum is not bitwise reproducible.
template <typename T>
__device__ __forceinline__ void splat(const Grid<T>& g, T* acc, const Stencil<T>& s,
                                      T val, const T grad[3]) {
  const T wx[2] = {static_cast<T>(1) - s.w0[0], s.w0[0]};
  const T wy[2] = {static_cast<T>(1) - s.w0[1], s.w0[1]};
  const T wz[2] = {static_cast<T>(1) - s.w0[2], s.w0[2]};
  const T sgn[2] = {static_cast<T>(-1), static_cast<T>(1)};
  const T gx = grad[0] * g.inv_h, gy = grad[1] * g.inv_h, gz = grad[2] * g.inv_h;
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const T contrib = val * wx[a] * wy[b] * wz[c] + gx * sgn[a] * wy[b] * wz[c] +
                          gy * wx[a] * sgn[b] * wz[c] + gz * wx[a] * wy[b] * sgn[c];
        atomicAdd(acc + s.idx[a][b][c], contrib);
      }
}

// p inside [0, hi) on every axis.
template <typename T>
__device__ __forceinline__ bool inbounds(const Grid<T>& g, const T p[3]) {
  return p[0] >= 0 && p[0] < g.hi[0] && p[1] >= 0 && p[1] < g.hi[1] && p[2] >= 0 &&
         p[2] < g.hi[2];
}

// Outside the grid and moving away, on any axis; sign = -1 tests against -v.
template <typename T>
__device__ __forceinline__ bool escaped(const Grid<T>& g, const T p[3], const T v[3],
                                        T sign) {
  bool esc = false;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const T vk = sign * v[k];
    esc = esc || (p[k] < 0 && vk < 0) || (p[k] >= g.hi[k] && vk > 0);
  }
  return esc;
}

// Coordinates within tol cells of a node are moved onto it.
template <typename T>
__device__ __forceinline__ void snap_to_nodes(const Grid<T>& g, const T p[3], T tol,
                                              T out[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    T pm = p[k] / g.h;
    const T r = rint(pm);  // round half to even, as torch.round
    if (fabs(pm - r) <= tol) pm = r;
    out[k] = pm * g.h;
  }
}

template <typename T>
__device__ __forceinline__ void load3(const T* base, int i, T out[3]) {
  out[0] = base[3 * i]; out[1] = base[3 * i + 1]; out[2] = base[3 * i + 2];
}

template <typename T>
__device__ __forceinline__ void store3(T* base, int i, const T in[3]) {
  base[3 * i] = in[0]; base[3 * i + 1] = in[1]; base[3 * i + 2] = in[2];
}

constexpr int kThreads = 128;

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace anrt
