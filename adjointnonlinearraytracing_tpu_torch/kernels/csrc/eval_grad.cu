// K1 eval_grad: trilinear value and gradient of a voxel field at N points,
// one thread a point.
//
// Replaces the fused window evaluation of the JAX package's probe
// (benchmarks/probe_evalmath.py::_pl_eval_kernel), with the semantics of
// fields/grid.py::eval_grad: the 8 corners are read from the raw grid, no
// window table.  Bound by bytes: 12 B of point, 1 B of mask and 16 B of
// output a point, plus the grid once; the corner reads of neighbouring
// points hit L1/L2.
//
// What holds it back on the card is not bytes but the corner gathers: with
// the grid and the points already in L2 it takes nearly as long as after a
// flush (PERF.md), so the number of scattered requests L1 and L2 must serve
// is the limit.  The two corners along x of each (y, z) pair are neighbours
// in memory; where both lie in one aligned 16-byte vector of the grid (3 of
// 4 cases in f32, 1 of 2 in f64) they come in one load, so a point issues
// 4 to 8 corner requests where the first design (kPairs = false, kept as
// chip_smoke.py's yardstick) issues 8.  The arithmetic of a point is the
// same in both, so either result is the plain version's bit for bit.
#include <type_traits>

#include "trilinear.cuh"

namespace anrt {

// The value at flat index k of a 16-byte vector q of the grid.
__device__ __forceinline__ float pick(const float4& q, int k) {
  return k == 0 ? q.x : (k == 1 ? q.y : (k == 2 ? q.z : q.w));
}

__device__ __forceinline__ double pick(const double2& q, int k) { return k == 0 ? q.x : q.y; }

// The 8 corners of stencil s, each x-pair in one 16-byte load where it lies
// in one aligned vector (or is one word, where clamped at a face), else one
// by one.  vec: the grid's base address is 16-byte aligned.
template <typename T>
__device__ __forceinline__ void fetch_pairs(const Grid<T>& g, const Stencil<T>& s, bool mask,
                                            bool vec, int n_cells, T v[2][2][2]) {
  using V = typename std::conditional<sizeof(T) == 4, float4, double2>::type;
  constexpr int kVec = 16 / sizeof(T);
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int i0 = s.idx[0][b][c], i1 = s.idx[1][b][c];
      const int base = i0 & ~(kVec - 1);
      if (!mask) {
        v[0][b][c] = v[1][b][c] = static_cast<T>(0);
      } else if (vec && i1 - base < kVec && base + kVec <= n_cells) {
        const V q = __ldg(reinterpret_cast<const V*>(g.data + base));
        v[0][b][c] = pick(q, i0 - base);
        v[1][b][c] = pick(q, i1 - base);
      } else {
        v[0][b][c] = __ldg(g.data + i0);
        v[1][b][c] = __ldg(g.data + i1);
      }
    }
}

template <typename T, bool kPairs>
__global__ void eval_grad_kernel(Grid<T> g, const T* __restrict__ p,
                                 const unsigned char* __restrict__ mask,
                                 T* __restrict__ n_out, T* __restrict__ grad_out,
                                 int n_points) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_points) return;
  T pt[3];
  load3(p, i, pt);
  const bool m = mask == nullptr || mask[i] != 0;
  const Stencil<T> s = stencil(g, pt);
  T v[2][2][2];
  if constexpr (kPairs) {
    const bool vec = (reinterpret_cast<size_t>(g.data) & 15) == 0;
    fetch_pairs(g, s, m, vec, g.W * g.H * g.D, v);
  } else {
    fetch(g, s, m, v);
  }
  T n, grad[3];
  value_grad(g, v, s.w0, n, grad);
  n_out[i] = n;
  store3(grad_out, i, grad);
}

template <typename T>
int launch_eval_grad(const void* rif, int W, int H, int D, double h, const void* p,
                     const void* mask, void* n_out, void* grad_out, int n_points, int pairs,
                     cudaStream_t stream) {
  if (n_points > 0) {
    auto kernel = pairs ? eval_grad_kernel<T, true> : eval_grad_kernel<T, false>;
    kernel<<<blocks_for(n_points), kThreads, 0, stream>>>(
        make_grid<T>(rif, W, H, D, h), static_cast<const T*>(p),
        static_cast<const unsigned char*>(mask), static_cast<T*>(n_out),
        static_cast<T*>(grad_out), n_points);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace anrt

// is_double selects the instantiation; pairs: 1 loads x-pairs of corners
// together, 0 runs the first design; returns cudaGetLastError() after the launch.
extern "C" int anrt_eval_grad(int is_double, const void* rif, int W, int H, int D, double h,
                              const void* p, const void* mask, void* n_out, void* grad_out,
                              int n_points, int pairs, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return is_double ? anrt::launch_eval_grad<double>(rif, W, H, D, h, p, mask, n_out, grad_out,
                                                    n_points, pairs, s)
                   : anrt::launch_eval_grad<float>(rif, W, H, D, h, p, mask, n_out, grad_out,
                                                   n_points, pairs, s);
}
