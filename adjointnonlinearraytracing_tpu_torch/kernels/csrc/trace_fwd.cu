// K2 trace_fwd: forward eikonal stepper, one thread per ray, the whole step
// loop inside the kernel, ray state in registers, per-ray early exit.
//
// Replaces the XLA while_loop of the JAX package's forward stepper
// (tracer/paired.py::trace, same numbers as tracer/eikonal.py::trace).
// Semantics per step: eval masked by the previous position's inbounds;
// v += ds*n*grad n; x += ds*v; cross = inside & !inbounds(x);
// esc |= cross | escaped(x, v); (xt, vt) captured at cross only.  After the
// loop xt = esc ? xt : x and vt is left as captured (v0 if never crossed).
// Leaving the loop at esc is exact: an escaped ray is outside and moving away
// on some axis, sees n = 0, goes straight and never crosses again.
//
// Bound by operations: the grid (8.4 MB at 128^3 f32) stays in L2, each ray
// reads 24 B and writes 24 B once, and does ~100 flops per step (58 would
// do) for a few hundred steps.  Design: no per-step launch and no state in
// device memory.  What holds it back on the card is how many distinct L1/L2
// lines a warp's 8 corner reads touch each step: 8 x 32 when its rays are
// strangers (the bench scene draws entry points at random), a few when they
// are neighbours.  So the caller may pass an order (tracer/order.py: entry
// cell in Z-order): thread i takes ray order[i], reads x0[order[i]] and
// writes xt[order[i]], so the outputs stay in the caller's order and each
// ray's arithmetic, and so its result, is the same bit for bit.  With it an
// H100 runs ~1e11 ray-steps/s on coherent and on randomly drawn rays alike,
// still under a tenth of the operation bound: each step's corner reads wait
// on the position the step before computed, and that chain of cache hits a
// ray is what is left (not measured apart).
#include "trilinear.cuh"

namespace anrt {

template <typename T>
__global__ void trace_fwd_kernel(Grid<T> g, T ds, const T* __restrict__ x0,
                                 const T* __restrict__ v0, const int* __restrict__ order,
                                 T* __restrict__ xt_out, T* __restrict__ vt_out, int n_rays,
                                 int max_steps) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_rays) return;
  const int i = ray_of(order, t);
  T x[3], v[3], xt[3], vt[3];
  load3(x0, i, x);
  load3(v0, i, v);
#pragma unroll
  for (int k = 0; k < 3; ++k) { xt[k] = x[k]; vt[k] = v[k]; }
  bool inside = inbounds(g, x);
  bool esc = false;

  for (int step = 0; step < max_steps && !esc; ++step) {
    if (inside) {  // a masked lane has n = 0, grad = 0: v is unchanged
      const Stencil<T> s = stencil(g, x);
      T c[2][2][2], n, grad[3];
      fetch(g, s, true, c);
      value_grad(g, c, s.w0, n, grad);
      const T dsn = ds * n;
#pragma unroll
      for (int k = 0; k < 3; ++k) v[k] = v[k] + dsn * grad[k];
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) x[k] = x[k] + ds * v[k];

    const bool cur_inside = inbounds(g, x);
    const bool cross = inside && !cur_inside;
    esc = esc || cross || escaped(g, x, v, static_cast<T>(1));
    if (cross) {
#pragma unroll
      for (int k = 0; k < 3; ++k) { xt[k] = x[k]; vt[k] = v[k]; }
    }
    inside = cur_inside;
  }

  // rays that never escaped report their final position; vt is not fixed up
#pragma unroll
  for (int k = 0; k < 3; ++k) xt[k] = esc ? xt[k] : x[k];
  store3(xt_out, i, xt);
  store3(vt_out, i, vt);
}

template <typename T>
int launch_trace_fwd(const void* rif, int W, int H, int D, double h, double ds,
                     const void* x0, const void* v0, const int* order, void* xt, void* vt,
                     int n_rays, int max_steps, cudaStream_t stream) {
  if (n_rays > 0) {
    trace_fwd_kernel<T><<<blocks_for(n_rays), kThreads, 0, stream>>>(
        make_grid<T>(rif, W, H, D, h), static_cast<T>(ds), static_cast<const T*>(x0),
        static_cast<const T*>(v0), order, static_cast<T*>(xt), static_cast<T*>(vt), n_rays,
        max_steps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace anrt

// order: null, or n_rays ray indices (thread i takes ray order[i]).
extern "C" int anrt_trace_fwd(int is_double, const void* rif, int W, int H, int D, double h,
                              double ds, const void* x0, const void* v0, const void* order,
                              void* xt, void* vt, int n_rays, int max_steps, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto o = static_cast<const int*>(order);
  return is_double ? anrt::launch_trace_fwd<double>(rif, W, H, D, h, ds, x0, v0, o, xt, vt,
                                                    n_rays, max_steps, s)
                   : anrt::launch_trace_fwd<float>(rif, W, H, D, h, ds, x0, v0, o, xt, vt,
                                                   n_rays, max_steps, s);
}
