// K3 backtrace: constant-memory adjoint sweep, one thread per ray at a time,
// splats summed per ray and cell in registers, then added into a gradient in
// shared memory (grids that fit) or straight into the flat (D*H*W) gradient.
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
// What bounds it on the card: ~320 flops a ray-step (161 would do) and the
// adds of the splat.  Float atomics on one address serialise, and every
// stage of the fuel trainer splats ~2.5e8 terms (ds is fixed by the finest
// grid), onto 27 words at 3^3.  The design removes the adds four ways:
//   * a ray keeps the 8 sums of the cell it is in (SplatRun) and adds them
//     when it leaves the cell: one add a corner per run of h/ds steps or so
//     (64 at 3^3, 2 at 65^3 and on the bench scene);
//   * lanes of a warp that flush runs into the same cell at the same step
//     sum them with shuffles first (__match_any_sync on the stencil), and one
//     lane issues the adds; an H100 measured this before keeping it, because
//     with the other three alone the global adds still cost 40-50 % of K3's
//     time at 65^3 and on the bench scene;
//   * where the D*H*W gradient fits a block's shared memory (kSharedMax
//     bytes: f32 up to 38^3, f64 up to 30^3), persistent blocks (as many as
//     fill the SMs at the occupancy that size allows) walk the rays with a
//     grid-stride loop and flush runs into a block-private gradient with
//     shared-memory atomics, then add its nonzero words to device memory
//     once; larger grids flush runs to device memory;
//   * the caller may give the rays in a coherent order (thread i takes ray
//     order[i], tracer/order.py), so the lanes of a warp flush into the same
//     or neighbouring words.
// What is left is the arithmetic on the shared path, and on the global path
// about as much again for the adds.  Which path runs is the caller's choice
// (kernels/wrappers.py decides it from the grid's size and type alone); a
// refused launch is an error, not a retry.  The order of the adds varies
// from run to run, so the gradient is reproducible to rounding only, not
// bitwise.
#include "trilinear.cuh"

namespace anrt {

// the opt-in dynamic shared memory of one block on sm_90 (227 KB)
constexpr int kSharedMax = 232448;
constexpr int kSharedThreads = 512;

// Adds to counts the runs the ray flushed and the flushes it issued (8
// atomic adds each) for its group of lanes.
template <typename T>
__device__ __forceinline__ void backtrace_ray(const Grid<T>& g, T ds, T tol, const T* xt_in,
                                              const T* vt_in, const T* dx_in, const T* dv_in,
                                              T* acc, int r, int max_steps,
                                              unsigned long long counts[2]) {
  T x[3], v[3], la[3], mu[3];
  load3(xt_in, r, x);
  load3(vt_in, r, v);
  load3(dx_in, r, la);
  load3(dv_in, r, mu);
#pragma unroll
  for (int k = 0; k < 3; ++k) mu[k] = mu[k] + ds * la[k];
  bool active = !escaped(g, x, v, static_cast<T>(-1));
  SplatRun<T> run;

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
    const bool splat = active && emask;
    T terms[2][2][2];
    if (splat) {
      const T dnx[3] = {n * mu[0] * ds, n * mu[1] * ds, n * mu[2] * ds};
      splat_terms(g, s, dn * ds, dnx, terms);
    }
    run.step(acc, splat, s, terms);  // outside the branch: the warp's lanes flush together

    const T hmu[3] = {hess[0] * mu[1] + hess[1] * mu[2], hess[0] * mu[0] + hess[2] * mu[2],
                      hess[1] * mu[0] + hess[2] * mu[1]};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      la[k] = la[k] + ds * (dn * grad[k] + n * hmu[k]);
      mu[k] = mu[k] + ds * la[k];
    }
  }
  run.flush_if(acc, run.open);
  counts[0] += run.flushes;
  counts[1] += run.issued;
}

// kShared: the block sums into a private (D*H*W) gradient in dynamic shared
// memory and adds it to grad_out at the end; otherwise runs go to grad_out.
// tally: null, or three counters the kernel adds to: runs flushed, flushes
// issued after the warp's lanes summed equal targets (8 atomic adds each)
// and, on the shared path, the adds of the block-private gradient into
// grad_out.
template <typename T, bool kShared>
__global__ void __launch_bounds__(kShared ? kSharedThreads : kThreads)
backtrace_kernel(Grid<T> g, T ds, T tol, const T* __restrict__ xt_in,
                 const T* __restrict__ vt_in, const T* __restrict__ dx_in,
                 const T* __restrict__ dv_in, const int* __restrict__ order,
                 T* __restrict__ grad_out, unsigned long long* __restrict__ tally, int n_rays,
                 int max_steps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_cells = g.W * g.H * g.D;
  T* acc = grad_out;
  if (kShared) {
    acc = reinterpret_cast<T*>(smem);
    for (int j = threadIdx.x; j < n_cells; j += blockDim.x) acc[j] = 0;
    __syncthreads();
  }
  const int stride = gridDim.x * blockDim.x;
  unsigned long long counts[2] = {0, 0}, adds = 0;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_rays; i += stride)
    backtrace_ray(g, ds, tol, xt_in, vt_in, dx_in, dv_in, acc, ray_of(order, i), max_steps,
                  counts);
  if (kShared) {
    __syncthreads();
    for (int j = threadIdx.x; j < n_cells; j += blockDim.x) {
      const T sum = acc[j];
      if (sum != static_cast<T>(0)) {
        atomicAdd(grad_out + j, sum);
        ++adds;
      }
    }
  }
  if (tally != nullptr) {
    if (counts[0]) atomicAdd(tally, counts[0]);
    if (counts[1]) atomicAdd(tally + 1, counts[1]);
    if (adds) atomicAdd(tally + 2, adds);
  }
}

template <typename T>
int launch_backtrace(const void* rif, int W, int H, int D, double h, double ds, double tol,
                     const void* xt, const void* vt, const void* dx, const void* dv,
                     const int* order, void* grad_out, unsigned long long* tally, int n_rays,
                     int max_steps, int use_shared, cudaStream_t stream) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  const Grid<T> g = make_grid<T>(rif, W, H, D, h);
  const auto launch = [&](auto kernel, int blocks, int threads, size_t smem) {
    kernel<<<blocks, threads, smem, stream>>>(
        g, static_cast<T>(ds), static_cast<T>(tol), static_cast<const T*>(xt),
        static_cast<const T*>(vt), static_cast<const T*>(dx), static_cast<const T*>(dv), order,
        static_cast<T*>(grad_out), tally, n_rays, max_steps);
  };
  if (!use_shared) {
    launch(backtrace_kernel<T, false>, blocks_for(n_rays), kThreads, 0);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t bytes = static_cast<size_t>(W) * H * D * sizeof(T);
  if (bytes > static_cast<size_t>(kSharedMax)) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = backtrace_kernel<T, true>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kSharedThreads, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int wanted = (n_rays + kSharedThreads - 1) / kSharedThreads;
  const int blocks = per_sm * sms < wanted ? per_sm * sms : wanted;
  launch(kernel, blocks, kSharedThreads, bytes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace anrt

// grad_out must be zero-filled (or hold a sum to add to) before the call.
// order: null, or n_rays ray indices (thread i takes ray order[i]).
// use_shared: 1 for the block-private gradient in shared memory (the grid's
// D*H*W elements must fit kSharedMax bytes, or the call returns an error), 0
// for runs added straight to grad_out.  tally: null, or three zeroed 64-bit
// counters (runs flushed, flushes issued, shared-path adds into grad_out) for
// a check.
extern "C" int anrt_backtrace(int is_double, const void* rif, int W, int H, int D, double h,
                              double ds, double tol, const void* xt, const void* vt,
                              const void* dx, const void* dv, const void* order,
                              void* grad_out, void* tally, int n_rays, int max_steps,
                              int use_shared, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto o = static_cast<const int*>(order);
  auto t = static_cast<unsigned long long*>(tally);
  return is_double
             ? anrt::launch_backtrace<double>(rif, W, H, D, h, ds, tol, xt, vt, dx, dv, o,
                                              grad_out, t, n_rays, max_steps, use_shared, s)
             : anrt::launch_backtrace<float>(rif, W, H, D, h, ds, tol, xt, vt, dx, dv, o,
                                             grad_out, t, n_rays, max_steps, use_shared, s);
}
