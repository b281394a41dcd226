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
//
// K5 trace_ckpt is the same loop compiled with kCkpt: the forward pass of the
// exact gradient (tracer/checkpointed.py, replacing the segmented XLA
// forward of the JAX package's tracer/checkpointed.py::_forward_with_ckpts).
// It also writes, for each ray, (x, v, inside) at the start of every
// segment of seg steps that it begins before it escapes (rows of later
// segments are never read: the backward pass stops at the capture step),
// the capture step c (max_steps if it never crossed out) and a code: 0 never
// escaped, 1 captured, 2 escaped without ever being inside (nothing to
// differentiate).  The checkpoints are laid out (nseg, 7, n_rays), field k of
// thread i at [s][k][i], so a warp's store of one field is one 128-byte line;
// the exit state is K2's bit for bit.  The extra bytes are 28 a ray and
// segment in f32, a few per cent of a step's work.  A cache of the current
// cell's 8 corner values (read once a cell, not once a step) took 2-3 % off
// at the fuel trainer's coarse stages and added as much at the fine ones and
// on the bench scene (8 more registers), so K5 reads them at every step, as
// K2 does (tools/k6_designs.py, PERF.md).
#include "trilinear.cuh"

namespace anrt {

template <typename T, bool kCkpt>
__global__ void trace_fwd_kernel(Grid<T> g, T ds, const T* __restrict__ x0,
                                 const T* __restrict__ v0, const int* __restrict__ order,
                                 T* __restrict__ xt_out, T* __restrict__ vt_out,
                                 int* __restrict__ c_out, unsigned char* __restrict__ code_out,
                                 T* __restrict__ ckpts, int n_rays, int max_steps, int seg) {
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
  int c = max_steps;
  bool captured = false;
  // this thread's column of the next segment's checkpoints (field k at
  // ck[k * n_rays]), and the steps until it starts
  T* ck = ckpts == nullptr ? nullptr : ckpts + t;
  const size_t field = static_cast<size_t>(n_rays);
  int until_ck = 0;

  for (int step = 0; step < max_steps && !esc; ++step) {
    if (kCkpt && ck != nullptr) {
      if (until_ck == 0) {
        const T row[7] = {x[0], x[1], x[2], v[0], v[1], v[2], static_cast<T>(inside ? 1 : 0)};
#pragma unroll
        for (int k = 0; k < 7; ++k) ck[k * field] = row[k];
        ck += 7 * field;
        until_ck = seg;
      }
      --until_ck;
    }
    const bool cur_inside = forward_step(g, ds, x, v, inside);
    const bool cross = inside && !cur_inside;
    esc = esc || cross || escaped(g, x, v, static_cast<T>(1));
    if (cross) {
#pragma unroll
      for (int k = 0; k < 3; ++k) { xt[k] = x[k]; vt[k] = v[k]; }
      c = step + 1;
      captured = true;
    }
    inside = cur_inside;
  }
  if (xt_out == nullptr) return;

  // rays that never escaped report their final position; vt is not fixed up
#pragma unroll
  for (int k = 0; k < 3; ++k) xt[k] = esc ? xt[k] : x[k];
  store3(xt_out, i, xt);
  store3(vt_out, i, vt);
  if (kCkpt) {
    c_out[i] = c;
    code_out[i] = !esc ? 0 : (captured ? 1 : 2);
  }
}

template <typename T>
int launch_trace_fwd(const void* rif, int W, int H, int D, double h, double ds,
                     const void* x0, const void* v0, const int* order, void* xt, void* vt,
                     int n_rays, int max_steps, cudaStream_t stream) {
  if (n_rays > 0) {
    trace_fwd_kernel<T, false><<<blocks_for(n_rays), kThreads, 0, stream>>>(
        make_grid<T>(rif, W, H, D, h), static_cast<T>(ds), static_cast<const T*>(x0),
        static_cast<const T*>(v0), order, static_cast<T*>(xt), static_cast<T*>(vt), nullptr,
        nullptr, nullptr, n_rays, max_steps, 1);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_trace_ckpt(const void* rif, int W, int H, int D, double h, double ds,
                      const void* x0, const void* v0, const int* order, void* xt, void* vt,
                      void* c, void* code, void* ckpts, int n_rays, int max_steps, int seg,
                      cudaStream_t stream) {
  if (n_rays > 0) {
    trace_fwd_kernel<T, true><<<blocks_for(n_rays), kThreads, 0, stream>>>(
        make_grid<T>(rif, W, H, D, h), static_cast<T>(ds), static_cast<const T*>(x0),
        static_cast<const T*>(v0), order, static_cast<T*>(xt), static_cast<T*>(vt),
        static_cast<int*>(c), static_cast<unsigned char*>(code), static_cast<T*>(ckpts),
        n_rays, max_steps, seg);
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

// K5.  order: n_rays ray indices (thread i takes ray order[i]; n_rays may be
// a chunk of the rays).  xt, vt (3 per ray), c (int32) and code (uint8) are
// written at the ray's own index; all four null to skip them.  ckpts: null,
// or (ceil(max_steps/seg), 7, n_rays) with column i thread i's.
extern "C" int anrt_trace_ckpt(int is_double, const void* rif, int W, int H, int D, double h,
                               double ds, const void* x0, const void* v0, const void* order,
                               void* xt, void* vt, void* c, void* code, void* ckpts,
                               int n_rays, int max_steps, int seg, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto o = static_cast<const int*>(order);
  return is_double ? anrt::launch_trace_ckpt<double>(rif, W, H, D, h, ds, x0, v0, o, xt, vt, c,
                                                     code, ckpts, n_rays, max_steps, seg, s)
                   : anrt::launch_trace_ckpt<float>(rif, W, H, D, h, ds, x0, v0, o, xt, vt, c,
                                                    code, ckpts, n_rays, max_steps, seg, s);
}
