// K7 trace_cable: the cylinder (radial-profile) forward stepper toward a target
// point per ray, one thread a ray, the whole step loop inside the kernel.
//
// Replaces the XLA while_loop of the JAX package's cable stepper
// (tracer/eikonal.py::trace_cable; the port's plain version is
// tracer/eikonal.py::trace_cable).  Per step: the field read at x unmasked;
// an active lane moves, v += ds*n*grad n, x += ds*v; cur = |x - target|^2 in
// the order (a^2 + b^2) + c^2; the closest approach (xt, vt, d2) is captured
// at every step where cur < d2, not at the crossing; the ray freezes once it
// crosses out of the cylinder (inbounds at the step before, not after) or is
// outside and receding (escaped).  A frozen ray's distance no longer changes,
// so the thread leaves the loop when its ray freezes: the result is the
// plain version's bit for bit (compiled with -fmad=false).
//
// K9 trace_cable_ckpt is the same step compiled with kCkpt: the forward pass
// of the exact cable gradient (replacing the segmented XLA forward of the JAX
// package's tracer/checkpointed.py::_fwd_ckpts_cable; the port's plain
// version is tracer/checkpointed.py::_fwd_ckpts_cable).  It also writes the
// capture step c (0 if the ray never got closer than where it started) and,
// with kStore, for each ray (x, v, esc) at the start of every segment of seg
// steps that it begins before it freezes (later rows are never read: the
// backward pass stops at the capture step).  Checkpoints are (nseg, 7,
// n_rays), field k of ray i at [s][k][i], so a warp's store of one field is
// one line.  With kStore the loop is one over segments around one of at most
// seg steps, as the JAX segment scan is: the store sits at the segment's
// start outside the inner loop, so the step carries no counter of its own and
// no test of the checkpoint pointer (the first design counted down to the
// next store and tested the pointer at every step, 21 % slower than K7).
//
// Bound by the latency of each ray's chain of steps (cylinder.cuh): the
// block's threads build its per-bin table first, and a step reads the table
// and divides and takes its square root by the IEEE fast paths (div_rn,
// sqrt_rn), none of them in a branch region of its own.
#include "cylinder.cuh"

namespace anrt {

// One step of K9's segment loop: the move, the freeze test and the capture of
// the closest approach; returns whether the ray froze.
template <typename T>
__device__ __forceinline__ bool trace_step(const Profile<T>& p, const BinEntry<T>* tab, T ds,
                                           const T tg[3], T x[3], T v[3], T xt[3], T vt[3],
                                           T& d2, bool& inside, int& c, int step) {
  cable_step(p, tab, ds, x, v, true);  // the loop runs active rays only
  const T cur = sum_sq3(x, tg);
  const bool cur_inside = inbounds(p, x);
  const bool esc = (inside && !cur_inside) || escaped(p, x, v, static_cast<T>(1));
  if (cur < d2) {
#pragma unroll
    for (int k = 0; k < 3; ++k) { xt[k] = x[k]; vt[k] = v[k]; }
    d2 = cur;
    c = step + 1;
  }
  inside = cur_inside;
  return esc;
}

template <typename T, bool kCkpt, bool kStore>
__global__ void __launch_bounds__(kThreads)
trace_cable_kernel(Profile<T> p, T ds, const T* __restrict__ x0, const T* __restrict__ v0,
                   const T* __restrict__ target, T* __restrict__ xt_out,
                   T* __restrict__ vt_out, T* __restrict__ d2_out, int* __restrict__ c_out,
                   T* __restrict__ ckpts, int n_rays, int max_steps, int seg) {
  extern __shared__ __align__(16) unsigned char smem[];
  BinEntry<T>* tab = reinterpret_cast<BinEntry<T>*>(smem);
  build_bin_table(p, tab);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  T x[3], v[3], tg[3], xt[3], vt[3];
  load3(x0, i, x);
  load3(v0, i, v);
  load3(target, i, tg);
#pragma unroll
  for (int k = 0; k < 3; ++k) { xt[k] = x[k]; vt[k] = v[k]; }
  T d2 = sum_sq3(x, tg);
  bool inside = inbounds(p, x);
  bool esc = false;
  int c = 0;

  if (kStore) {
    for (int s0 = 0; s0 < max_steps && !esc; s0 += seg) {
      const size_t field = static_cast<size_t>(n_rays);
      T* ck = ckpts + static_cast<size_t>(s0 / seg) * 7 * field + i;
      const T row[7] = {x[0], x[1], x[2], v[0], v[1], v[2], static_cast<T>(0)};
#pragma unroll
      for (int k = 0; k < 7; ++k) ck[k * field] = row[k];
      const int end = max_steps - s0 < seg ? max_steps : s0 + seg;
      for (int step = s0; step < end && !esc; ++step)
        esc = trace_step(p, tab, ds, tg, x, v, xt, vt, d2, inside, c, step);
    }
  } else {
    // K7 (and K9 without checkpoints): K7's loop with the step written out;
    // with trace_step in its place K7 ran 4 % slower on an H100 (PERF.md)
    for (int step = 0; step < max_steps && !esc; ++step) {
      cable_step(p, tab, ds, x, v, true);  // the loop runs active rays only
      const T cur = sum_sq3(x, tg);
      const bool cur_inside = inbounds(p, x);
      esc = (inside && !cur_inside) || escaped(p, x, v, static_cast<T>(1));
      if (cur < d2) {
#pragma unroll
        for (int k = 0; k < 3; ++k) { xt[k] = x[k]; vt[k] = v[k]; }
        d2 = cur;
        c = step + 1;
      }
      inside = cur_inside;
    }
  }
  if (xt_out == nullptr) return;
  store3(xt_out, i, xt);
  store3(vt_out, i, vt);
  d2_out[i] = d2;
  if (kCkpt) c_out[i] = c;
}

template <typename T, bool kCkpt>
int launch_trace_cable(const void* prof, int res, double radius, double length, double ds,
                       const void* x0, const void* v0, const void* target, void* xt, void* vt,
                       void* d2, void* c, void* ckpts, int n_rays, int max_steps, int seg,
                       cudaStream_t stream) {
  if (n_rays > 0) {
    const size_t bytes = table_bytes<T>(res);
    auto kernel = kCkpt && ckpts != nullptr ? trace_cable_kernel<T, kCkpt, kCkpt>
                                            : trace_cable_kernel<T, kCkpt, false>;
    const cudaError_t err = allow_shared(kernel, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<blocks_for(n_rays), kThreads, bytes, stream>>>(
        make_profile<T>(prof, res, radius, length), static_cast<T>(ds),
        static_cast<const T*>(x0), static_cast<const T*>(v0), static_cast<const T*>(target),
        static_cast<T*>(xt), static_cast<T*>(vt), static_cast<T*>(d2), static_cast<int*>(c),
        static_cast<T*>(ckpts), n_rays, max_steps, seg);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace anrt

// K7.  x0, v0, target, xt, vt: 3 per ray; d2: one per ray.
extern "C" int anrt_trace_cable(int is_double, const void* prof, int res, double radius,
                                double length, double ds, const void* x0, const void* v0,
                                const void* target, void* xt, void* vt, void* d2, int n_rays,
                                int max_steps, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return is_double
             ? anrt::launch_trace_cable<double, false>(prof, res, radius, length, ds, x0, v0,
                                                       target, xt, vt, d2, nullptr, nullptr,
                                                       n_rays, max_steps, 1, s)
             : anrt::launch_trace_cable<float, false>(prof, res, radius, length, ds, x0, v0,
                                                      target, xt, vt, d2, nullptr, nullptr,
                                                      n_rays, max_steps, 1, s);
}

// K9.  As K7, plus c (int32 per ray) and ckpts: null, or (ceil(max_steps/seg),
// 7, n_rays).  xt, vt, d2 and c all null to skip the exit state.
extern "C" int anrt_trace_cable_ckpt(int is_double, const void* prof, int res, double radius,
                                     double length, double ds, const void* x0, const void* v0,
                                     const void* target, void* xt, void* vt, void* d2, void* c,
                                     void* ckpts, int n_rays, int max_steps, int seg,
                                     void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return is_double
             ? anrt::launch_trace_cable<double, true>(prof, res, radius, length, ds, x0, v0,
                                                      target, xt, vt, d2, c, ckpts, n_rays,
                                                      max_steps, seg, s)
             : anrt::launch_trace_cable<float, true>(prof, res, radius, length, ds, x0, v0,
                                                     target, xt, vt, d2, c, ckpts, n_rays,
                                                     max_steps, seg, s);
}
