// Earlier designs of K1 eval_grad, kept to time them beside the shipped one
// (tools/k1_designs.py); no path of the port launches them.  Each computes
// the shipped kernel's result bit for bit.
//
// anrt_k1_design(design, ...): f32 only.
//   0  four points a thread: coordinates and masks in 16-byte vectors, each
//      x-pair of corners in one 16-byte load where it lies in one, all 32
//      corner loads issued before any is used, outputs in 16-byte stores;
//      needs every pointer 16-byte aligned
//   1  the same kernel run at one point a thread (its scalar path)
//   2  the first design (8 corner loads one by one) behind a loop of one trip
#include "eval_grad.cu"

namespace anrt {

constexpr int kPts = 4;

__device__ __forceinline__ void load16(const float* src, float* dst) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(src));
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
}

__device__ __forceinline__ void store16(float* dst, const float* src) {
  *reinterpret_cast<float4*>(dst) = make_float4(src[0], src[1], src[2], src[3]);
}

__device__ __forceinline__ void eval_point(const Grid<float>& g, const float* p,
                                           const unsigned char* mask, float* n_out,
                                           float* grad_out, int i) {
  float pt[3];
  load3(p, i, pt);
  const bool m = mask == nullptr || mask[i] != 0;
  const Stencil<float> s = stencil(g, pt);
  float v[2][2][2];
  fetch(g, s, m, v);
  float n, grad[3];
  value_grad(g, v, s.w0, n, grad);
  n_out[i] = n;
  store3(grad_out, i, grad);
}

__global__ void four_points_kernel(Grid<float> g, const float* __restrict__ p,
                                   const unsigned char* __restrict__ mask,
                                   float* __restrict__ n_out, float* __restrict__ grad_out,
                                   int n_points, int pts) {
  const int first = (blockIdx.x * blockDim.x + threadIdx.x) * pts;
  if (first >= n_points) return;
  if (pts == 1 || first + kPts > n_points) {
    for (int i = first; i < n_points && i < first + pts; ++i)
      eval_point(g, p, mask, n_out, grad_out, i);
    return;
  }
  float pt[3 * kPts];
#pragma unroll
  for (int j = 0; j < 3 * kPts; j += 4) load16(p + 3 * first + j, pt + j);
  bool m[kPts];
  const uchar4 mb = __ldg(reinterpret_cast<const uchar4*>(mask + first));
  m[0] = mb.x != 0; m[1] = mb.y != 0; m[2] = mb.z != 0; m[3] = mb.w != 0;
  const int n_cells = g.W * g.H * g.D;
  const bool grid_vec = (reinterpret_cast<size_t>(g.data) & 15) == 0;
  Stencil<float> s[kPts];
  float v[kPts][2][2][2];
#pragma unroll
  for (int q = 0; q < kPts; ++q) {
    s[q] = stencil(g, pt + 3 * q);
    fetch_pairs(g, s[q], m[q], grid_vec, n_cells, v[q]);
  }
  float n[kPts], grad[3 * kPts];
#pragma unroll
  for (int q = 0; q < kPts; ++q) value_grad(g, v[q], s[q].w0, n[q], grad + 3 * q);
  store16(n_out + first, n);
#pragma unroll
  for (int j = 0; j < 3 * kPts; j += 4) store16(grad_out + 3 * first + j, grad + j);
}

__global__ void one_trip_loop_kernel(Grid<float> g, const float* __restrict__ p,
                                     const unsigned char* __restrict__ mask,
                                     float* __restrict__ n_out, float* __restrict__ grad_out,
                                     int n_points, int pts) {
  const int first = (blockIdx.x * blockDim.x + threadIdx.x) * pts;
  for (int i = first; i < n_points && i < first + pts; ++i)
    eval_point(g, p, mask, n_out, grad_out, i);
}

}  // namespace anrt

extern "C" int anrt_k1_design(int design, const void* rif, int W, int H, int D, double h,
                              const void* p, const void* mask, void* n_out, void* grad_out,
                              int n_points, void* stream) {
  using namespace anrt;
  const auto g = make_grid<float>(rif, W, H, D, h);
  const auto pp = static_cast<const float*>(p);
  const auto mm = static_cast<const unsigned char*>(mask);
  const auto no = static_cast<float*>(n_out);
  const auto go = static_cast<float*>(grad_out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (design == 0)
    four_points_kernel<<<blocks_for((n_points + kPts - 1) / kPts), kThreads, 0, s>>>(
        g, pp, mm, no, go, n_points, kPts);
  else if (design == 1)
    four_points_kernel<<<blocks_for(n_points), kThreads, 0, s>>>(g, pp, mm, no, go, n_points, 1);
  else if (design == 2)
    one_trip_loop_kernel<<<blocks_for(n_points), kThreads, 0, s>>>(g, pp, mm, no, go, n_points,
                                                                    1);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
