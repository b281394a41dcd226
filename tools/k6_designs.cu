// Designs of K6 backtrace_exact and K5 trace_ckpt timed beside the shipped
// kernels (tools/k6_designs.py); no path of the port launches them.  f32 only.
//
// anrt_k6_design(design, ...) takes backtrace_exact's arguments and a path:
//   0  K6's first design, copied verbatim (FirstExactRay below; it calls
//      the routines of trilinear.cuh and the shell of adjoint.cuh, which
//      are unchanged since): the "before", on the path K3's rule gives
//   1  its replay alone: the same segments, stretches and stores of the
//      replayed positions into the local buffer, each read back once in
//      reverse, and no backward step (no evaluation, update or splat)
//   2  its replay alone without the buffer: the replayed steps only
//   3  design 0 with the shared path's carve-out set to leave L1 the most
//      room (cudaFuncAttributePreferredSharedMemoryCarveout = 0); on the
//      global path the same as 0
//   4  design 6 replaying in stretches of 16 steps (and reading each
//      position when its step comes, not one step ahead): half the local
//      buffer, one and a half replays a step
//   5  design 6 keeping n and grad n of each replayed step beside its
//      position (28 bytes a step), so that the backward step evaluates only
//      the stencil and the Hessian ("evaluate once")
//   6  design 0 with a CornerCache in the replay and the backward step and
//      the shipped checkpoint layout (UnalignedRay: each lane at its own
//      segment and step), in adjoint.cuh's shell on the path given (ptxas
//      gives its global instance 96 registers and spills the cache)
//   7  design 6 with the cache in the replay only, the backward step
//      reading its corners at every step
//   8  design 7 in a kernel that asks for 4 blocks an SM (up to 128
//      registers)
//   9  design 6 in that kernel
//  10  the shipped functor (lanes of a warp in step) on the path given (the
//      shipped wrapper takes the global one)
//  11  the shipped functor with the cache in the replay and the backward
//      step (AlignedCachedRay), on the path given
// Designs 0 to 3 read the first design's checkpoint layout, (nseg,
// n_slots, 7), the others the shipped one, (nseg, 7, n_slots).  Designs 1 and 2 write
// nothing; a sum of the positions they read keeps the compiler from
// dropping the work.
//
// anrt_k5_design(which, ...) takes trace_ckpt's arguments: 0 K5's first
// design (K2's loop writing (nseg, n_rays, 7)), 1 the shipped K5 with the
// corner cache, 2 the shipped K5 storing the checkpoints with __stcs
// (evict-first).
#include "backtrace_exact.cu"
#include "trace_fwd.cu"

namespace anrt {

// The corner cache of designs 4-9 and 11 (the shipped kernels read the
// corners at every step): the 8 corner values of the last
// stencil a ray read, keyed as SplatRun keys its run (idx[0][0][0],
// idx[1][1][1]), read again only when the stencil changes.  The values are
// the same either way, so every result is too, bit for bit.
template <typename T>
struct CornerCache {
  int key[2] = {-1, -1};  // no stencil has a negative index
  T v[2][2][2];
  __device__ __forceinline__ void load(const Grid<T>& g, const Stencil<T>& s) {
    if (s.idx[0][0][0] != key[0] || s.idx[1][1][1] != key[1]) {
      fetch(g, s, true, v);
      key[0] = s.idx[0][0][0];
      key[1] = s.idx[1][1][1];
    }
  }
};

// forward_step (trilinear.cuh) with the corner values from a CornerCache
template <typename T>
__device__ __forceinline__ bool cached_step(const Grid<T>& g, T ds, T x[3], T v[3], bool inside,
                                            CornerCache<T>& corners) {
  if (inside) {
    const Stencil<T> s = stencil(g, x);
    T n, grad[3];
    corners.load(g, s);
    value_grad(g, corners.v, s.w0, n, grad);
    const T dsn = ds * n;
#pragma unroll
    for (int k = 0; k < 3; ++k) v[k] = v[k] + dsn * grad[k];
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) x[k] = x[k] + ds * v[k];
  return inbounds(g, x);
}

// K6's first functor, verbatim but for its name and a tag that makes design
// 3 a kernel of its own, with its own attributes.
template <typename T, int kTag = 0>
struct FirstExactRay {
  Grid<T> g;
  T ds;
  const T* ckpts;  // (nseg, n_slots, 7)
  const int* order;
  const int* c;
  const unsigned char* code;
  const T *dx, *dv;
  int n_slots, nseg, seg;

  __device__ __forceinline__ void operator()(int i, T* acc, unsigned long long counts[2]) const {
    const int r = ray_of(order, i);
    const int steps = __ldg(code + r) == 2 ? 0 : __ldg(c + r);  // the gated-on steps
    if (steps <= 0) return;
    T la[3], mu[3];
    load3(dx, r, la);
    load3(dv, r, mu);
#pragma unroll
    for (int k = 0; k < 3; ++k) mu[k] = mu[k] + ds * la[k];
    SplatRun<T> run;
    T xs[kReplay][3];

    const int last = (steps - 1) / seg < nseg - 1 ? (steps - 1) / seg : nseg - 1;
    for (int s = last; s >= 0; --s) {
      const int n = steps - s * seg < seg ? steps - s * seg : seg;  // the segment's steps
      const T* row = ckpts + (static_cast<size_t>(s) * n_slots + i) * 7;
      for (int b0 = (n - 1) / kReplay * kReplay; b0 >= 0; b0 -= kReplay) {
        T x[3] = {row[0], row[1], row[2]}, v[3] = {row[3], row[4], row[5]};
        bool inside = row[6] > static_cast<T>(0.5);
        for (int j = 0; j < b0; ++j) inside = forward_step(g, ds, x, v, inside);
        const int nb = n - b0 < kReplay ? n - b0 : kReplay;
        unsigned ins = 0u;  // bit j: inside at the stretch's step j
        for (int j = 0; j < nb; ++j) {
#pragma unroll
          for (int k = 0; k < 3; ++k) xs[j][k] = x[k];
          if (inside) ins |= 1u << j;
          inside = forward_step(g, ds, x, v, inside);
        }
        // reverse over the stretch; the next position is read from local memory
        // one step ahead, so that its load overlaps this step's work
        T xn[3] = {xs[nb - 1][0], xs[nb - 1][1], xs[nb - 1][2]};
        for (int j = nb - 1; j >= 0; --j) {
          const T xk[3] = {xn[0], xn[1], xn[2]};
          if (j > 0) {
#pragma unroll
            for (int k = 0; k < 3; ++k) xn[k] = xs[j - 1][k];
          }
          const bool emask = (ins >> j) & 1u;
          T nk = 0, grad[3] = {0, 0, 0}, hess[3] = {0, 0, 0};
          Stencil<T> st;
          if (emask) {
            st = stencil(g, xk);
            T cv[2][2][2];
            fetch(g, st, true, cv);
            value_grad(g, cv, st.w0, nk, grad);
            hessian(g, cv, st.w0, hess);
          }
          adjoint_update(g, ds, st, nk, grad, hess, emask, la, mu, run, acc);
        }
      }
    }
    run.flush_if(acc, run.open);
    counts[0] += run.flushes;
    counts[1] += run.issued;
  }
};

// designs 1 and 2: design 0's replay, with (kBuffer) or without the local buffer
template <typename T, bool kBuffer>
struct ReplayRay {
  Grid<T> g;
  T ds;
  const T* ckpts;
  const int* order;
  const int* c;
  const unsigned char* code;
  const T *dx, *dv;
  int n_slots, nseg, seg;

  __device__ __forceinline__ void operator()(int i, T* acc, unsigned long long counts[2]) const {
    const int r = ray_of(order, i);
    const int steps = __ldg(code + r) == 2 ? 0 : __ldg(c + r);
    if (steps <= 0) return;
    T sum = 0;
    T xs[kReplay][3];
    const int last = (steps - 1) / seg < nseg - 1 ? (steps - 1) / seg : nseg - 1;
    for (int s = last; s >= 0; --s) {
      const int n = steps - s * seg < seg ? steps - s * seg : seg;
      const T* row = ckpts + (static_cast<size_t>(s) * n_slots + i) * 7;
      for (int b0 = (n - 1) / kReplay * kReplay; b0 >= 0; b0 -= kReplay) {
        T x[3] = {row[0], row[1], row[2]}, v[3] = {row[3], row[4], row[5]};
        bool inside = row[6] > static_cast<T>(0.5);
        for (int j = 0; j < b0; ++j) inside = forward_step(g, ds, x, v, inside);
        const int nb = n - b0 < kReplay ? n - b0 : kReplay;
        unsigned ins = 0u;
        for (int j = 0; j < nb; ++j) {
          if (kBuffer) {
#pragma unroll
            for (int k = 0; k < 3; ++k) xs[j][k] = x[k];
          } else {
            sum = sum + x[0] + x[1] + x[2];
          }
          if (inside) ins |= 1u << j;
          inside = forward_step(g, ds, x, v, inside);
        }
        if (kBuffer) {
          for (int j = nb - 1; j >= 0; --j)
            if ((ins >> j) & 1u) sum = sum + xs[j][0] + xs[j][1] + xs[j][2];
        } else {
          sum = sum + static_cast<T>(__popc(ins));
        }
      }
    }
    if (sum == static_cast<T>(-1.2345e30)) atomicAdd(acc, sum);  // never: keeps the work
  }
};

template <typename Ray>
Ray make_ray(const void* rif, int W, int H, int D, double h, double ds, const void* ckpts,
             const void* order, const void* c, const void* code, const void* dx, const void* dv,
             int n_slots, int nseg, int seg) {
  return Ray{make_grid<float>(rif, W, H, D, h), static_cast<float>(ds),
             static_cast<const float*>(ckpts), static_cast<const int*>(order),
             static_cast<const int*>(c), static_cast<const unsigned char*>(code),
             static_cast<const float*>(dx), static_cast<const float*>(dv), n_slots, nseg, seg};
}

// the step of forward_step, also handing out n and grad n (zeros when masked)
template <typename T>
__device__ __forceinline__ bool step_keeping(const Grid<T>& g, T ds, T x[3], T v[3],
                                             bool inside, CornerCache<T>& corners, T& n,
                                             T grad[3]) {
  n = 0;
  grad[0] = grad[1] = grad[2] = 0;
  if (inside) {
    const Stencil<T> s = stencil(g, x);
    corners.load(g, s);
    value_grad(g, corners.v, s.w0, n, grad);
    const T dsn = ds * n;
#pragma unroll
    for (int k = 0; k < 3; ++k) v[k] = v[k] + dsn * grad[k];
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) x[k] = x[k] + ds * v[k];
  return inbounds(g, x);
}

// designs 4 and 5: design 6 with stretches of kStretch steps, and with
// (kOnce) n and grad n kept beside each replayed position
template <typename T, int kStretch, bool kOnce>
struct ExactVariant {
  Grid<T> g;
  T ds;
  const T* ckpts;  // (nseg, 7, n_slots)
  const int* order;
  const int* c;
  const unsigned char* code;
  const T *dx, *dv;
  int n_slots, nseg, seg;

  __device__ __forceinline__ void operator()(int i, T* acc, unsigned long long counts[2]) const {
    constexpr int kW = kOnce ? 7 : 3;  // x, and n, grad n
    const int r = ray_of(order, i);
    const int steps = __ldg(code + r) == 2 ? 0 : __ldg(c + r);
    if (steps <= 0) return;
    T la[3], mu[3];
    load3(dx, r, la);
    load3(dv, r, mu);
#pragma unroll
    for (int k = 0; k < 3; ++k) mu[k] = mu[k] + ds * la[k];
    SplatRun<T> run;
    CornerCache<T> corners;
    T xs[kStretch][kW];

    const int last = (steps - 1) / seg < nseg - 1 ? (steps - 1) / seg : nseg - 1;
    for (int s = last; s >= 0; --s) {
      const int n = steps - s * seg < seg ? steps - s * seg : seg;
      const size_t field = static_cast<size_t>(n_slots);
      const T* row = ckpts + s * 7 * field + i;
      for (int b0 = (n - 1) / kStretch * kStretch; b0 >= 0; b0 -= kStretch) {
        T x[3], v[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          x[k] = row[k * field];
          v[k] = row[(k + 3) * field];
        }
        bool inside = row[6 * field] > static_cast<T>(0.5);
        for (int j = 0; j < b0; ++j) inside = cached_step(g, ds, x, v, inside, corners);
        const int nb = n - b0 < kStretch ? n - b0 : kStretch;
        unsigned ins = 0u;
        for (int j = 0; j < nb; ++j) {
#pragma unroll
          for (int k = 0; k < 3; ++k) xs[j][k] = x[k];
          if (inside) ins |= 1u << j;
          if constexpr (kOnce) {
            T nj, gj[3];
            inside = step_keeping(g, ds, x, v, inside, corners, nj, gj);
            xs[j][kW - 4] = nj;
#pragma unroll
            for (int k = 0; k < 3; ++k) xs[j][kW - 3 + k] = gj[k];
          } else {
            inside = cached_step(g, ds, x, v, inside, corners);
          }
        }
        for (int j = nb - 1; j >= 0; --j) {
          const T xk[3] = {xs[j][0], xs[j][1], xs[j][2]};
          const bool emask = (ins >> j) & 1u;
          T nk = 0, grad[3] = {0, 0, 0}, hess[3] = {0, 0, 0};
          Stencil<T> st;
          if (emask) {
            st = stencil(g, xk);
            corners.load(g, st);
            if constexpr (kOnce) {
              nk = xs[j][kW - 4];
#pragma unroll
              for (int k = 0; k < 3; ++k) grad[k] = xs[j][kW - 3 + k];
            } else {
              value_grad(g, corners.v, st.w0, nk, grad);
            }
            hessian(g, corners.v, st.w0, hess);
          }
          adjoint_update(g, ds, st, nk, grad, hess, emask, la, mu, run, acc);
        }
      }
    }
    run.flush_if(acc, run.open);
    counts[0] += run.flushes;
    counts[1] += run.issued;
  }
};

// K5's first design: trace_fwd_kernel<T, true> as first built (the
// checkpoints laid out (nseg, n_rays, 7)), verbatim but for its name
template <typename T>
__global__ void first_trace_ckpt_kernel(Grid<T> g, T ds, const T* __restrict__ x0,
                                      const T* __restrict__ v0, const int* __restrict__ order,
                                      T* __restrict__ xt_out, T* __restrict__ vt_out,
                                      int* __restrict__ c_out,
                                      unsigned char* __restrict__ code_out,
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
  T* ck = ckpts == nullptr ? nullptr : ckpts + static_cast<size_t>(t) * 7;
  int until_ck = 0;

  for (int step = 0; step < max_steps && !esc; ++step) {
    if (ck != nullptr) {
      if (until_ck == 0) {
        const T row[7] = {x[0], x[1], x[2], v[0], v[1], v[2], static_cast<T>(inside ? 1 : 0)};
#pragma unroll
        for (int k = 0; k < 7; ++k) ck[k] = row[k];
        ck += static_cast<size_t>(n_rays) * 7;
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
#pragma unroll
  for (int k = 0; k < 3; ++k) xt[k] = esc ? xt[k] : x[k];
  store3(xt_out, i, xt);
  store3(vt_out, i, vt);
  c_out[i] = c;
  code_out[i] = !esc ? 0 : (captured ? 1 : 2);
}

// design 6: design 0 with the cache and the shipped layout
template <typename T>
struct UnalignedRay {
  Grid<T> g;
  T ds;
  const T* ckpts;  // (nseg, 7, n_slots)
  const int* order;
  const int* c;
  const unsigned char* code;
  const T *dx, *dv;
  int n_slots, nseg, seg;

  __device__ __forceinline__ void operator()(int i, T* acc, unsigned long long counts[2]) const {
    const int r = ray_of(order, i);
    const int steps = __ldg(code + r) == 2 ? 0 : __ldg(c + r);  // the gated-on steps
    if (steps <= 0) return;
    T la[3], mu[3];
    load3(dx, r, la);
    load3(dv, r, mu);
#pragma unroll
    for (int k = 0; k < 3; ++k) mu[k] = mu[k] + ds * la[k];
    SplatRun<T> run;
    CornerCache<T> corners;  // one read a cell, in the replay and the backward step
    T xs[kReplay][3];

    const int last = (steps - 1) / seg < nseg - 1 ? (steps - 1) / seg : nseg - 1;
    for (int s = last; s >= 0; --s) {
      const int n = steps - s * seg < seg ? steps - s * seg : seg;  // the segment's steps
      const size_t field = static_cast<size_t>(n_slots);
      const T* row = ckpts + s * 7 * field + i;  // this ray's field k at row[k * field]
      for (int b0 = (n - 1) / kReplay * kReplay; b0 >= 0; b0 -= kReplay) {
        T x[3], v[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          x[k] = row[k * field];
          v[k] = row[(k + 3) * field];
        }
        bool inside = row[6 * field] > static_cast<T>(0.5);
        for (int j = 0; j < b0; ++j) inside = cached_step(g, ds, x, v, inside, corners);
        const int nb = n - b0 < kReplay ? n - b0 : kReplay;
        unsigned ins = 0u;  // bit j: inside at the stretch's step j
        for (int j = 0; j < nb; ++j) {
#pragma unroll
          for (int k = 0; k < 3; ++k) xs[j][k] = x[k];
          if (inside) ins |= 1u << j;
          inside = cached_step(g, ds, x, v, inside, corners);
        }
        // reverse over the stretch; the next position is read from local memory
        // one step ahead, so that its load overlaps this step's work
        T xn[3] = {xs[nb - 1][0], xs[nb - 1][1], xs[nb - 1][2]};
        for (int j = nb - 1; j >= 0; --j) {
          const T xk[3] = {xn[0], xn[1], xn[2]};
          if (j > 0) {
#pragma unroll
            for (int k = 0; k < 3; ++k) xn[k] = xs[j - 1][k];
          }
          const bool emask = (ins >> j) & 1u;
          T nk = 0, grad[3] = {0, 0, 0}, hess[3] = {0, 0, 0};
          Stencil<T> st;
          if (emask) {
            st = stencil(g, xk);
            corners.load(g, st);
            value_grad(g, corners.v, st.w0, nk, grad);
            hessian(g, corners.v, st.w0, hess);
          }
          adjoint_update(g, ds, st, nk, grad, hess, emask, la, mu, run, acc);
        }
      }
    }
    run.flush_if(acc, run.open);
    counts[0] += run.flushes;
    counts[1] += run.issued;
  }
};

// designs 8 and 9: one thread a slot, runs to grad_out, at least kMinBlocks
// blocks an SM
template <int kMinBlocks, typename Ray>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
min_blocks_kernel(Ray ray, float* __restrict__ grad_out, unsigned long long* __restrict__ tally,
                  int n_slots) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned long long counts[2] = {0, 0};
  if (i < n_slots) ray(i, grad_out, counts);
  if (tally != nullptr) {
    if (counts[0]) atomicAdd(tally, counts[0]);
    if (counts[1]) atomicAdd(tally + 1, counts[1]);
  }
}

// designs 7 and 8: design 6 with the corner cache in the replay only; each
// stretch's replay starts a cache of its own
template <typename T>
struct ReplayCachedRay {
  Grid<T> g;
  T ds;
  const T* ckpts;  // (nseg, 7, n_slots)
  const int* order;
  const int* c;
  const unsigned char* code;
  const T *dx, *dv;
  int n_slots, nseg, seg;

  __device__ __forceinline__ void operator()(int i, T* acc, unsigned long long counts[2]) const {
    const int r = ray_of(order, i);
    const int steps = __ldg(code + r) == 2 ? 0 : __ldg(c + r);
    if (steps <= 0) return;
    T la[3], mu[3];
    load3(dx, r, la);
    load3(dv, r, mu);
#pragma unroll
    for (int k = 0; k < 3; ++k) mu[k] = mu[k] + ds * la[k];
    SplatRun<T> run;
    T xs[kReplay][3];

    const int last = (steps - 1) / seg < nseg - 1 ? (steps - 1) / seg : nseg - 1;
    for (int s = last; s >= 0; --s) {
      const int n = steps - s * seg < seg ? steps - s * seg : seg;
      const size_t field = static_cast<size_t>(n_slots);
      const T* row = ckpts + s * 7 * field + i;
      for (int b0 = (n - 1) / kReplay * kReplay; b0 >= 0; b0 -= kReplay) {
        T x[3], v[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          x[k] = row[k * field];
          v[k] = row[(k + 3) * field];
        }
        bool inside = row[6 * field] > static_cast<T>(0.5);
        const int nb = n - b0 < kReplay ? n - b0 : kReplay;
        unsigned ins = 0u;
        {
          CornerCache<T> corners;
          for (int j = 0; j < b0; ++j) inside = cached_step(g, ds, x, v, inside, corners);
          for (int j = 0; j < nb; ++j) {
#pragma unroll
            for (int k = 0; k < 3; ++k) xs[j][k] = x[k];
            if (inside) ins |= 1u << j;
            inside = cached_step(g, ds, x, v, inside, corners);
          }
        }
        T xn[3] = {xs[nb - 1][0], xs[nb - 1][1], xs[nb - 1][2]};
        for (int j = nb - 1; j >= 0; --j) {
          const T xk[3] = {xn[0], xn[1], xn[2]};
          if (j > 0) {
#pragma unroll
            for (int k = 0; k < 3; ++k) xn[k] = xs[j - 1][k];
          }
          const bool emask = (ins >> j) & 1u;
          T nk = 0, grad[3] = {0, 0, 0}, hess[3] = {0, 0, 0};
          Stencil<T> st;
          if (emask) {
            st = stencil(g, xk);
            T cv[2][2][2];
            fetch(g, st, true, cv);
            value_grad(g, cv, st.w0, nk, grad);
            hessian(g, cv, st.w0, hess);
          }
          adjoint_update(g, ds, st, nk, grad, hess, emask, la, mu, run, acc);
        }
      }
    }
    run.flush_if(acc, run.open);
    counts[0] += run.flushes;
    counts[1] += run.issued;
  }
};

// design 11: the shipped functor with the cache, verbatim but for its name
// and the cached step
template <typename T>
struct AlignedCachedRay {
  Grid<T> g;
  T ds;
  const T* ckpts;  // (nseg, 7, n_slots)
  const int* order;
  const int* c;
  const unsigned char* code;
  const T *dx, *dv;
  int n_slots, nseg, seg;

  __device__ __forceinline__ void operator()(int i, T* acc, unsigned long long counts[2]) const {
    const unsigned lanes = __activemask();  // the lanes of the warp that have a ray slot
    const int r = ray_of(order, i);
    const int steps = __ldg(code + r) == 2 ? 0 : __ldg(c + r);  // the gated-on steps
    const int last = steps <= 0 ? -1 : ((steps - 1) / seg < nseg - 1 ? (steps - 1) / seg
                                                                     : nseg - 1);
    const int warp_last = __reduce_max_sync(lanes, last);
    T la[3], mu[3];
    load3(dx, r, la);
    load3(dv, r, mu);
#pragma unroll
    for (int k = 0; k < 3; ++k) mu[k] = mu[k] + ds * la[k];
    SplatRun<T> run;
    CornerCache<T> corners;
    T xs[kReplay][3];
    const size_t field = static_cast<size_t>(n_slots);

    for (int s = warp_last; s >= 0; --s) {
      const int n = s > last ? 0 : (steps - s * seg < seg ? steps - s * seg : seg);
      const int n_warp = __reduce_max_sync(lanes, n);
      const T* row = ckpts + s * 7 * field + i;
      for (int b0 = (n_warp - 1) / kReplay * kReplay; b0 >= 0; b0 -= kReplay) {
        const int nb = n - b0 < 0 ? 0 : (n - b0 < kReplay ? n - b0 : kReplay);
        const int nb_warp = n_warp - b0 < kReplay ? n_warp - b0 : kReplay;
        T x[3], v[3];
        bool inside = false;
        if (nb > 0) {
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            x[k] = row[k * field];
            v[k] = row[(k + 3) * field];
          }
          inside = row[6 * field] > static_cast<T>(0.5);
          for (int j = 0; j < b0; ++j) inside = cached_step(g, ds, x, v, inside, corners);
        }
        unsigned ins = 0u;
        for (int j = 0; j < nb_warp; ++j) {
          if (j < nb) {
#pragma unroll
            for (int k = 0; k < 3; ++k) xs[j][k] = x[k];
            if (inside) ins |= 1u << j;
            inside = cached_step(g, ds, x, v, inside, corners);
          }
        }
        T xn[3];
        if (nb > 0) {
#pragma unroll
          for (int k = 0; k < 3; ++k) xn[k] = xs[nb - 1][k];
        }
        for (int j = nb_warp - 1; j >= 0; --j) {
          if (j < nb) {
            const T xk[3] = {xn[0], xn[1], xn[2]};
            if (j > 0) {
#pragma unroll
              for (int k = 0; k < 3; ++k) xn[k] = xs[j - 1][k];
            }
            const bool emask = (ins >> j) & 1u;
            T nk = 0, grad[3] = {0, 0, 0}, hess[3] = {0, 0, 0};
            Stencil<T> st;
            if (emask) {
              st = stencil(g, xk);
              corners.load(g, st);
              value_grad(g, corners.v, st.w0, nk, grad);
              hessian(g, corners.v, st.w0, hess);
            }
            adjoint_update(g, ds, st, nk, grad, hess, emask, la, mu, run, acc);
          }
        }
      }
    }
    run.flush_if(acc, run.open);
    counts[0] += run.flushes;
    counts[1] += run.issued;
  }
};

// The shipped K5 (trace_fwd_kernel<T, true>, the shipped layout) with the
// corners from a CornerCache (kCached) or with streaming stores of the
// checkpoints (kStream: __stcs, evict-first, so that they push fewer of
// the grid's lines out of L2)
template <bool kCached, bool kStream>
__global__ void k5_variant_kernel(Grid<float> g, float ds, const float* __restrict__ x0,
                                  const float* __restrict__ v0, const int* __restrict__ order,
                                  float* __restrict__ xt_out, float* __restrict__ vt_out,
                                  int* __restrict__ c_out, unsigned char* __restrict__ code_out,
                                  float* __restrict__ ckpts, int n_rays, int max_steps, int seg) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_rays) return;
  const int i = ray_of(order, t);
  float x[3], v[3], xt[3], vt[3];
  load3(x0, i, x);
  load3(v0, i, v);
#pragma unroll
  for (int k = 0; k < 3; ++k) { xt[k] = x[k]; vt[k] = v[k]; }
  bool inside = inbounds(g, x);
  bool esc = false;
  int c = max_steps;
  bool captured = false;
  CornerCache<float> corners;
  float* ck = ckpts == nullptr ? nullptr : ckpts + t;
  const size_t field = static_cast<size_t>(n_rays);
  int until_ck = 0;

  for (int step = 0; step < max_steps && !esc; ++step) {
    if (ck != nullptr) {
      if (until_ck == 0) {
        const float row[7] = {x[0], x[1], x[2], v[0], v[1], v[2], inside ? 1.0f : 0.0f};
#pragma unroll
        for (int k = 0; k < 7; ++k) {
          if (kStream)
            __stcs(ck + k * field, row[k]);
          else
            ck[k * field] = row[k];
        }
        ck += 7 * field;
        until_ck = seg;
      }
      --until_ck;
    }
    const bool cur_inside = kCached ? cached_step(g, ds, x, v, inside, corners)
                                    : forward_step(g, ds, x, v, inside);
    const bool cross = inside && !cur_inside;
    esc = esc || cross || escaped(g, x, v, 1.0f);
    if (cross) {
#pragma unroll
      for (int k = 0; k < 3; ++k) { xt[k] = x[k]; vt[k] = v[k]; }
      c = step + 1;
      captured = true;
    }
    inside = cur_inside;
  }
  if (xt_out == nullptr) return;
#pragma unroll
  for (int k = 0; k < 3; ++k) xt[k] = esc ? xt[k] : x[k];
  store3(xt_out, i, xt);
  store3(vt_out, i, vt);
  c_out[i] = c;
  code_out[i] = !esc ? 0 : (captured ? 1 : 2);
}

using First = FirstExactRay<float>;
using FirstL1 = FirstExactRay<float, 1>;
using ReplayBuffered = ReplayRay<float, true>;
using ReplayOnly = ReplayRay<float, false>;
using Stretch16 = ExactVariant<float, 16, false>;
using EvaluateOnce = ExactVariant<float, kReplay, true>;
using Unaligned = UnalignedRay<float>;
using ReplayCached = ReplayCachedRay<float>;
using Shipped = ExactRay<float>;
using AlignedCached = AlignedCachedRay<float>;

}  // namespace anrt

extern "C" int anrt_k6_design(int design, const void* rif, int W, int H, int D, double h,
                              double ds, const void* ckpts, const void* order, const void* c,
                              const void* code, const void* dx, const void* dv, void* grad_out,
                              void* tally, int n_slots, int nseg, int seg, int use_shared,
                              void* stream) {
  using namespace anrt;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto t = static_cast<unsigned long long*>(tally);
  const int cells = W * H * D;
#define ANRT_RAY(R) \
  make_ray<R>(rif, W, H, D, h, ds, ckpts, order, c, code, dx, dv, n_slots, nseg, seg)
  switch (design) {
    case 0:
      return launch_adjoint<float>(ANRT_RAY(First), cells, grad_out, t, n_slots,
                                   use_shared, s);
    case 1:
      return launch_adjoint<float>(ANRT_RAY(ReplayBuffered), cells, grad_out, t,
                                   n_slots, use_shared, s);
    case 2:
      return launch_adjoint<float>(ANRT_RAY(ReplayOnly), cells, grad_out, t,
                                   n_slots, use_shared, s);
    case 3: {
      const cudaError_t err = cudaFuncSetAttribute(
          adjoint_kernel<float, true, FirstL1>,
          cudaFuncAttributePreferredSharedMemoryCarveout, 0);
      if (err != cudaSuccess) return static_cast<int>(err);
      return launch_adjoint<float>(ANRT_RAY(FirstL1), cells, grad_out, t, n_slots,
                                   use_shared, s);
    }
    case 4:
      return launch_adjoint<float>(ANRT_RAY(Stretch16), cells, grad_out, t, n_slots,
                                   use_shared, s);
    case 5:
      return launch_adjoint<float>(ANRT_RAY(EvaluateOnce), cells, grad_out, t, n_slots,
                                   use_shared, s);
    case 6:
      return launch_adjoint<float>(ANRT_RAY(Unaligned), cells, grad_out, t, n_slots, use_shared,
                                   s);
    case 7:
      return launch_adjoint<float>(ANRT_RAY(ReplayCached), cells, grad_out, t, n_slots,
                                   use_shared, s);
    case 8:
      if (n_slots > 0)
        min_blocks_kernel<4><<<blocks_for(n_slots), kThreads, 0, s>>>(
            ANRT_RAY(ReplayCached), static_cast<float*>(grad_out), t, n_slots);
      return static_cast<int>(cudaGetLastError());
    case 9:
      if (n_slots > 0)
        min_blocks_kernel<4><<<blocks_for(n_slots), kThreads, 0, s>>>(
            ANRT_RAY(Unaligned), static_cast<float*>(grad_out), t, n_slots);
      return static_cast<int>(cudaGetLastError());
    case 10:
      return launch_adjoint<float>(ANRT_RAY(Shipped), cells, grad_out, t, n_slots, use_shared,
                                   s);
    case 11:
      return launch_adjoint<float>(ANRT_RAY(AlignedCached), cells, grad_out, t, n_slots,
                                   use_shared, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ANRT_RAY
}

// which: 0 K5's first design, 1 the shipped K5 with the corner cache, 2 the
// shipped K5 with streaming checkpoint stores.
extern "C" int anrt_k5_design(int which, const void* rif, int W, int H, int D, double h,
                              double ds, const void* x0, const void* v0, const void* order,
                              void* xt, void* vt, void* c, void* code, void* ckpts, int n_rays,
                              int max_steps, int seg, void* stream) {
  using namespace anrt;
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  using Kernel = void (*)(Grid<float>, float, const float*, const float*, const int*, float*,
                         float*, int*, unsigned char*, float*, int, int, int);
  Kernel kernel = nullptr;
  if (which == 0)
    kernel = first_trace_ckpt_kernel<float>;
  else if (which == 1)
    kernel = k5_variant_kernel<true, false>;
  else if (which == 2)
    kernel = k5_variant_kernel<false, true>;
  else
    return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<blocks_for(n_rays), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      make_grid<float>(rif, W, H, D, h), static_cast<float>(ds), static_cast<const float*>(x0),
      static_cast<const float*>(v0), static_cast<const int*>(order), static_cast<float*>(xt),
      static_cast<float*>(vt), static_cast<int*>(c), static_cast<unsigned char*>(code),
      static_cast<float*>(ckpts), n_rays, max_steps, seg);
  return static_cast<int>(cudaGetLastError());
}
