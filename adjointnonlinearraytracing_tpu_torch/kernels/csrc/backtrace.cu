// K3 backtrace: constant-memory adjoint sweep, one thread per ray, atomicAdd
// into the flat (D*H*W) voxel gradient.
//
// Replaces the XLA while_loop of the JAX package's adjoint sweep
// (tracer/paired.py::backtrace, same numbers as tracer/eikonal.py::backtrace).
// Order inside a step is the contract: x -= ds*v; xe = snap_to_nodes(x);
// emask = active & inbounds(xe); n, grad n, hess at xe under emask;
// v -= ds*n*grad n; active &= !escaped(xe, -v) with the new v; splat
// (dn*ds, n*mu*ds) at xe under the updated active & emask;
// la += ds*(dn*grad n + n*H mu); mu += ds*la.  Start: la = dx,
// mu = dv + ds*dx, active = !escaped(xt, -vt).  The integration position x
// stays unsnapped.  Leaving the loop at !active is exact: an inactive ray
// contributes nothing.
//
// Bound by operations and by atomics: ~320 flops (161 would do) and 8 atomicAdds per active
// ray-step into a grid that stays in L2.  Design: one thread owns a ray from
// end to end so nothing but the atomics touches device memory in the loop;
// duplicate targets within a warp are not pre-reduced.  The order of the
// atomics varies from run to run, so the gradient is reproducible to rounding
// only, not bitwise.
#include "trilinear.cuh"

namespace anrt {

template <typename T>
__global__ void backtrace_kernel(Grid<T> g, T ds, T tol, const T* __restrict__ xt_in,
                                 const T* __restrict__ vt_in, const T* __restrict__ dx_in,
                                 const T* __restrict__ dv_in, T* __restrict__ grad_out,
                                 int n_rays, int max_steps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  T x[3], v[3], la[3], mu[3];
  load3(xt_in, i, x);
  load3(vt_in, i, v);
  load3(dx_in, i, la);
  load3(dv_in, i, mu);
#pragma unroll
  for (int k = 0; k < 3; ++k) mu[k] = mu[k] + ds * la[k];
  bool active = !escaped(g, x, v, static_cast<T>(-1));

  for (int step = 0; step < max_steps && active; ++step) {
#pragma unroll
    for (int k = 0; k < 3; ++k) x[k] = x[k] - ds * v[k];
    T xe[3];
    snap_to_nodes(g, x, tol, xe);
    const bool emask = inbounds(g, xe);  // active holds inside the loop

    T n = 0, grad[3] = {0, 0, 0}, hess[3] = {0, 0, 0};
    Stencil<T> s;
    if (emask) {
      s = stencil(g, xe);
      T c[2][2][2];
      fetch(g, s, true, c);
      value_grad(g, c, s.w0, n, grad);
      hessian(g, c, s.w0, hess);
      const T dsn = ds * n;
#pragma unroll
      for (int k = 0; k < 3; ++k) v[k] = v[k] - dsn * grad[k];
    }

    active = !escaped(g, xe, v, static_cast<T>(-1));

    const T dn = mu[0] * grad[0] + mu[1] * grad[1] + mu[2] * grad[2];
    if (active && emask) {
      const T dnx[3] = {n * mu[0] * ds, n * mu[1] * ds, n * mu[2] * ds};
      splat(g, grad_out, s, dn * ds, dnx);
    }

    const T hmu[3] = {hess[0] * mu[1] + hess[1] * mu[2], hess[0] * mu[0] + hess[2] * mu[2],
                      hess[1] * mu[0] + hess[2] * mu[1]};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      la[k] = la[k] + ds * (dn * grad[k] + n * hmu[k]);
      mu[k] = mu[k] + ds * la[k];
    }
  }
}

template <typename T>
int launch_backtrace(const void* rif, int W, int H, int D, double h, double ds, double tol,
                     const void* xt, const void* vt, const void* dx, const void* dv,
                     void* grad_out, int n_rays, int max_steps, cudaStream_t stream) {
  if (n_rays > 0) {
    backtrace_kernel<T><<<blocks_for(n_rays), kThreads, 0, stream>>>(
        make_grid<T>(rif, W, H, D, h), static_cast<T>(ds), static_cast<T>(tol),
        static_cast<const T*>(xt), static_cast<const T*>(vt), static_cast<const T*>(dx),
        static_cast<const T*>(dv), static_cast<T*>(grad_out), n_rays, max_steps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace anrt

// grad_out must be zero-filled (or hold a sum to add to) before the call.
extern "C" int anrt_backtrace(int is_double, const void* rif, int W, int H, int D, double h,
                              double ds, double tol, const void* xt, const void* vt,
                              const void* dx, const void* dv, void* grad_out, int n_rays,
                              int max_steps, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return is_double ? anrt::launch_backtrace<double>(rif, W, H, D, h, ds, tol, xt, vt, dx, dv,
                                                    grad_out, n_rays, max_steps, s)
                   : anrt::launch_backtrace<float>(rif, W, H, D, h, ds, tol, xt, vt, dx, dv,
                                                   grad_out, n_rays, max_steps, s);
}
