// K1 eval_grad: trilinear value and gradient of a voxel field at N points,
// one thread per point.
//
// Replaces the fused window evaluation of the JAX package's probe
// (benchmarks/probe_evalmath.py::_pl_eval_kernel), with the semantics of
// fields/grid.py::eval_grad: the 8 corners are read from the raw grid, no
// window table.  Bound by bytes: 12 B of point and 16 B of output per thread
// plus the grid once; the corner reads of neighbouring points hit L1/L2.
#include "trilinear.cuh"

namespace anrt {

template <typename T>
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
  fetch(g, s, m, v);
  T n, grad[3];
  value_grad(g, v, s.w0, n, grad);
  n_out[i] = n;
  store3(grad_out, i, grad);
}

template <typename T>
int launch_eval_grad(const void* rif, int W, int H, int D, double h, const void* p,
                     const void* mask, void* n_out, void* grad_out, int n_points,
                     cudaStream_t stream) {
  if (n_points > 0) {
    eval_grad_kernel<T><<<blocks_for(n_points), kThreads, 0, stream>>>(
        make_grid<T>(rif, W, H, D, h), static_cast<const T*>(p),
        static_cast<const unsigned char*>(mask), static_cast<T*>(n_out),
        static_cast<T*>(grad_out), n_points);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace anrt

// is_double selects the instantiation; returns cudaGetLastError() after the launch.
extern "C" int anrt_eval_grad(int is_double, const void* rif, int W, int H, int D, double h,
                              const void* p, const void* mask, void* n_out, void* grad_out,
                              int n_points, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return is_double
             ? anrt::launch_eval_grad<double>(rif, W, H, D, h, p, mask, n_out, grad_out, n_points, s)
             : anrt::launch_eval_grad<float>(rif, W, H, D, h, p, mask, n_out, grad_out, n_points, s);
}
