// Designs of K9 trace_cable_ckpt and K10 backtrace_cable_exact timed beside the
// shipped kernels (tools/cable_designs.py); no path of the port launches them.
// f32 only.  Where `clk` is given a kernel is the instrumented copy: each ray
// writes the clock64() cycles between the entry and the exit of its loops and
// the steps it took (clk[2i], clk[2i + 1]): K9 the steps it moved, K10 the
// steps it ran the adjoint on (its capture step c); in the two-role designs
// the adjoint lane reads the clock, from the role's start to its end.
//
// anrt_k9_design(design, ...) takes trace_cable_ckpt's arguments (checkpoints
// stored) and a block size:
//   0  K9's previous design, verbatim (namespace previous): K7's loop with a
//      per-step count down to the next store and a test of the checkpoint
//      pointer
//   1  the shipped loop: one over segments around one over a segment's
//      steps, the store between them (trace_cable.cu, kStore)
// anrt_k10_design(design, ...) takes backtrace_cable_exact's arguments:
//   0  K10's previous design, verbatim (namespace previous): one thread a
//      ray, 128 a block, the stretch's positions in the thread's local
//      memory, runs added to the block's gradient (shared f64 atomics)
//   1  as 0, each splat to the lane's own column of the block's gradient
//      (32-lane blocks), no atomics
//   2  as 1, the stretch's positions in shared memory, lane-minor
//   3  two roles: a replay warp and an adjoint warp for the same 32 rays,
//      two buffers, named barriers; the adjoint evaluates each step's field
//      in turn, under the step's gate
//   4  as 3, runs into one gradient a block
//   5  the shipped column path: as 3, the adjoint warp evaluating the next
//      step's field before the current step's update, the update's gate a
//      select
//   6  as 5, the splat under the gate as a branch
//   7  as 6, runs into one gradient a block
//   8  the shipped block path's adjoint: as 5, runs into one gradient a
//      block (the shipped block path keeps the buffers in device memory;
//      here, as in designs 3-7, they are in shared memory)
// Designs 3-8 take shared memory for the buffers on either accumulator, so
// on a profile of the fiber's size the block-path designs (4, 7, 8) time
// the accumulator and the adjoint loop, not where the buffers live.
#include "backtrace_cable_exact.cu"
#include "trace_cable.cu"

namespace anrt {
namespace previous {

// ---- K9's previous design (trace_cable.cu with kCkpt), verbatim but for the clock ----

template <typename T, bool kClock>
__global__ void __launch_bounds__(kThreads)
trace_cable_kernel(Profile<T> p, T ds, const T* __restrict__ x0, const T* __restrict__ v0,
                   const T* __restrict__ target, T* __restrict__ xt_out,
                   T* __restrict__ vt_out, T* __restrict__ d2_out, int* __restrict__ c_out,
                   T* __restrict__ ckpts, long long* clk, int n_rays, int max_steps, int seg) {
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
  T* ck = ckpts == nullptr ? nullptr : ckpts + i;
  const size_t field = static_cast<size_t>(n_rays);
  int until_ck = 0;
  const long long t0 = kClock ? clock64() : 0;
  int step = 0;
  for (; step < max_steps && !esc; ++step) {
    if (ck != nullptr) {
      if (until_ck == 0) {
        const T row[7] = {x[0], x[1], x[2], v[0], v[1], v[2], static_cast<T>(0)};
#pragma unroll
        for (int k = 0; k < 7; ++k) ck[k * field] = row[k];
        ck += 7 * field;
        until_ck = seg;
      }
      --until_ck;
    }
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
  if (kClock) {
    clk[2 * i] = clock64() - t0;
    clk[2 * i + 1] = step;
  }
  store3(xt_out, i, xt);
  store3(vt_out, i, vt);
  d2_out[i] = d2;
  c_out[i] = c;
}

// ---- K10's previous design (backtrace_cable_exact.cu), verbatim but for the clock ----

constexpr int kCableReplay = 32;

template <typename T, bool kClock>
struct CableExactRay {
  Profile<T> p;
  T ds;
  const T* ckpts;  // (nseg, 7, n_rays)
  const int* c;
  const T *dx, *dv;
  int n_rays, nseg, seg;
  long long* clk;

  template <typename Acc>
  __device__ __forceinline__ void operator()(int i, const BinEntry<T>* tab, Acc& run) const {
    const long long t0 = kClock ? clock64() : 0;
    const unsigned lanes = __activemask();  // the lanes of the warp that have a ray
    const int steps = __ldg(c + i);        // the gated-on steps: k < c
    const int last = steps <= 0 ? -1 : ((steps - 1) / seg < nseg - 1 ? (steps - 1) / seg
                                                                    : nseg - 1);
    const int warp_last = __reduce_max_sync(lanes, last);
    T la[3], mu[3];
    load3(dx, i, la);
    load3(dv, i, mu);
#pragma unroll
    for (int k = 0; k < 3; ++k) mu[k] = mu[k] + ds * la[k];
    T xs[kCableReplay][3];
    const size_t field = static_cast<size_t>(n_rays);

    // segment s of every lane at once, from the warp's last segment down, and
    // step j of a segment at once; a lane is idle where it has no step
    for (int s = warp_last; s >= 0; --s) {
      const int n = s > last ? 0 : (steps - s * seg < seg ? steps - s * seg : seg);
      const int n_warp = __reduce_max_sync(lanes, n);
      const T* row = ckpts + s * 7 * field + i;
      for (int b0 = (n_warp - 1) / kCableReplay * kCableReplay; b0 >= 0; b0 -= kCableReplay) {
        const int nb = n - b0 < 0 ? 0 : (n - b0 < kCableReplay ? n - b0 : kCableReplay);
        const int nb_warp = n_warp - b0 < kCableReplay ? n_warp - b0 : kCableReplay;
        T x[3], v[3];
        bool esc = true;
        if (nb > 0) {
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            x[k] = row[k * field];
            v[k] = row[(k + 3) * field];
          }
          esc = row[6 * field] > static_cast<T>(0.5);
          for (int j = 0; j < b0; ++j) replay_step(p, tab, ds, x, v, esc);
        }
        unsigned act = 0u;  // bit j: active at the stretch's step j
        for (int j = 0; j < nb_warp; ++j) {
          if (j < nb) {
#pragma unroll
            for (int k = 0; k < 3; ++k) xs[j][k] = x[k];
            if (!esc) act |= 1u << j;
            if (j + 1 < nb) replay_step(p, tab, ds, x, v, esc);
          }
        }
        for (int j = nb_warp - 1; j >= 0; --j) {
          if (j < nb && ((act >> j) & 1u)) {  // gated off: la, mu unchanged
            const T xk[3] = {xs[j][0], xs[j][1], xs[j][2]};
            const FieldAt<T> f = field_at(p, tab, xk);
            T hess[3];
            hessian(f, hess);
            cable_adjoint_update(p, ds, f, hess, true, la, mu, run);
          }
        }
      }
    }
    run.flush();
    if (kClock) {
      clk[2 * i] = clock64() - t0;
      clk[2 * i + 1] = steps;
    }
  }
};

}  // namespace previous

namespace designs {

// Design 2: the previous design's ray with the columns and the stretch's positions in
// shared memory (after the table and the columns, lane-minor: a warp's
// buffer of kCableReplay steps).
template <bool kClock>
struct SharedBufferRay {
  CableExactArgs<float> a;
  long long* clk;

  __device__ __forceinline__ void operator()(int i, const BinEntry<float>* tab,
                                             LaneColumn& run) const {
    const Profile<float>& p = a.p;
    const float ds = a.ds;
    const int lane = threadIdx.x & 31;
    float(*xs)[3][32] = reinterpret_cast<float(*)[3][32]>(
        reinterpret_cast<double*>(const_cast<BinEntry<float>*>(tab) + p.res) +
        p.res * blockDim.x) + (threadIdx.x >> 5) * kCableReplay;
    const long long t0 = kClock ? clock64() : 0;
    const unsigned lanes = __activemask();
    const int steps = __ldg(a.c + i);
    const int last = steps <= 0 ? -1 : ((steps - 1) / a.seg < a.nseg - 1 ? (steps - 1) / a.seg
                                                                        : a.nseg - 1);
    const int warp_last = __reduce_max_sync(lanes, last);
    float la[3], mu[3];
    load3(a.dx, i, la);
    load3(a.dv, i, mu);
#pragma unroll
    for (int k = 0; k < 3; ++k) mu[k] = mu[k] + ds * la[k];
    const size_t field = static_cast<size_t>(a.n_rays);
    const int seg = a.seg;
    for (int s = warp_last; s >= 0; --s) {
      const int n = s > last ? 0 : (steps - s * seg < seg ? steps - s * seg : seg);
      const int n_warp = __reduce_max_sync(lanes, n);
      const float* row = a.ckpts + s * 7 * field + i;
      for (int b0 = (n_warp - 1) / kCableReplay * kCableReplay; b0 >= 0; b0 -= kCableReplay) {
        const int nb = n - b0 < 0 ? 0 : (n - b0 < kCableReplay ? n - b0 : kCableReplay);
        const int nb_warp = n_warp - b0 < kCableReplay ? n_warp - b0 : kCableReplay;
        float x[3], v[3];
        bool esc = true;
        if (nb > 0) {
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            x[k] = row[k * field];
            v[k] = row[(k + 3) * field];
          }
          esc = row[6 * field] > 0.5f;
          for (int j = 0; j < b0; ++j) replay_step(p, tab, ds, x, v, esc);
        }
        unsigned act = 0u;
        for (int j = 0; j < nb_warp; ++j) {
          if (j < nb) {
#pragma unroll
            for (int k = 0; k < 3; ++k) xs[j][k][lane] = x[k];
            if (!esc) act |= 1u << j;
            if (j + 1 < nb) replay_step(p, tab, ds, x, v, esc);
          }
        }
        for (int j = nb_warp - 1; j >= 0; --j) {
          if (j < nb && ((act >> j) & 1u)) {
            const float xk[3] = {xs[j][0][lane], xs[j][1][lane], xs[j][2][lane]};
            const FieldAt<float> f = field_at(p, tab, xk);
            float hess[3];
            hessian(f, hess);
            cable_adjoint_update(p, ds, f, hess, true, la, mu, run);
          }
        }
      }
    }
    if (kClock) {
      clk[2 * i] = clock64() - t0;
      clk[2 * i + 1] = steps;
    }
  }

  // the shell hands a block-run accumulator only on the block path, which
  // this design does not take
  __device__ __forceinline__ void operator()(int, const BinEntry<float>*, CableRun&) const {}
};

// Designs 3 and 4's adjoint warp: the first two-role design, each step's
// field evaluated in turn before its update, under the step's gate.
template <typename T, typename Acc>
__device__ __forceinline__ void adjoint_role_in_turn(const CableExactArgs<T>& a,
                                                     const BinEntry<T>* tab,
                                                     ReplayBuffer<T>* buf, int i, int lane,
                                                     const Stretches& st, Acc& acc) {
  T la[3], mu[3];
  adjoint_start(a, i, la, mu);
  st.each([&](int u, int, int, int nb, int nb_warp) {
    const ReplayBuffer<T>& b = buf[u & 1];
    __syncwarp();
    bar_sync(kBarFull + (u & 1));
    const unsigned act = b.act[lane];
    for (int j = nb_warp - 1; j >= 0; --j) {
      if (j < nb && ((act >> j) & 1u)) {  // gated off: la, mu unchanged
        const T xk[3] = {b.x[j][0][lane], b.x[j][1][lane], b.x[j][2][lane]};
        const FieldAt<T> f = field_at(a.p, tab, xk);
        T hess[3];
        hessian(f, hess);
        cable_adjoint_update(a.p, a.ds, f, hess, true, la, mu, acc);
      }
    }
    __syncwarp();
    bar_arrive(kBarEmpty + (u & 1));
  });
  acc.flush();
}

// Designs 6 and 7's adjoint warp: the shipped column path's evaluation ahead,
// with the splat under the step's gate as a branch (cable_adjoint_update's
// `splat`) rather than a select.
template <typename T, typename Acc>
__device__ __forceinline__ void adjoint_ahead_branch(const CableExactArgs<T>& a,
                                                     const BinEntry<T>* tab,
                                                     ReplayBuffer<T>* buf, int i, int lane,
                                                     const Stretches& st, Acc& acc) {
  T la[3], mu[3];
  adjoint_start(a, i, la, mu);
  st.each([&](int u, int, int, int nb, int nb_warp) {
    const ReplayBuffer<T>& b = buf[u & 1];
    __syncwarp();
    bar_sync(kBarFull + (u & 1));
    const unsigned act = b.act[lane];
    int j = nb_warp - 1;
    const T xk[3] = {b.x[j][0][lane], b.x[j][1][lane], b.x[j][2][lane]};
    FieldAt<T> f = field_at(a.p, tab, xk);
    for (; j >= 0; --j) {
      const bool on = j < nb && ((act >> j) & 1u);
      const int jn = j > 0 ? j - 1 : 0;
      const T xn[3] = {b.x[jn][0][lane], b.x[jn][1][lane], b.x[jn][2][lane]};
      const FieldAt<T> fn = field_at(a.p, tab, xn);
      T hess[3];
      hessian(f, hess);
      T la2[3] = {la[0], la[1], la[2]}, mu2[3] = {mu[0], mu[1], mu[2]};
      cable_adjoint_update(a.p, a.ds, f, hess, on, la2, mu2, acc);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        la[k] = on ? la2[k] : la[k];
        mu[k] = on ? mu2[k] : mu[k];
      }
      f = fn;
    }
    __syncwarp();
    bar_arrive(kBarEmpty + (u & 1));
  });
  acc.flush();
}

// Designs 3-8: the shipped kernel's body for one group of 32 rays a block,
// the buffers in shared memory, with the clock around the roles; the adjoint
// role kRole: 0 in turn, 1 the shipped one (ahead, a select), 2 ahead with
// the splat under a branch.
template <bool kColumns, int kRole, bool kClock>
__global__ void __launch_bounds__(kExactThreads)
two_roles(CableExactArgs<float> a, double* __restrict__ grad_out, long long* clk) {
  extern __shared__ __align__(16) unsigned char smem[];
  BinEntry<float>* tab = reinterpret_cast<BinEntry<float>*>(smem);
  double* acc = reinterpret_cast<double*>(tab + a.p.res);
  const int slots = kColumns ? kColumnThreads : 1;
  ReplayBuffer<float>* buf = reinterpret_cast<ReplayBuffer<float>*>(acc + a.p.res * slots);
  build_bin_table(a.p, tab);
  for (int j = threadIdx.x; j < a.p.res * slots; j += blockDim.x) acc[j] = 0.0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * 32 + lane;
  const long long t0 = kClock ? clock64() : 0;
  const Stretches st(i < a.n_rays ? __ldg(a.c + i) : 0, a.nseg, a.seg);
  if (threadIdx.x < 32) {
    replay_role(a, tab, buf, i, lane, st);
  } else {
    if (kColumns) {
      LaneColumn col{acc + lane, slots};
      if (kRole == 0) adjoint_role_in_turn(a, tab, buf, i, lane, st, col);
      if (kRole == 1) adjoint_ahead(a, tab, buf, i, lane, st, col);
      if (kRole == 2) adjoint_ahead_branch(a, tab, buf, i, lane, st, col);
    } else {
      CableRun run(acc);
      if (kRole == 0) adjoint_role_in_turn(a, tab, buf, i, lane, st, run);
      if (kRole == 1) adjoint_ahead(a, tab, buf, i, lane, st, run);
      if (kRole == 2) adjoint_ahead_branch(a, tab, buf, i, lane, st, run);
    }
    if (kClock && i < a.n_rays) {
      clk[2 * i] = clock64() - t0;
      clk[2 * i + 1] = st.steps;
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < a.p.res; j += blockDim.x) {
    double sum = 0.0;
    for (int t = 0; t < slots; ++t) sum += acc[j * slots + t];
    if (sum != 0.0) atomicAdd(grad_out + j, sum);
  }
}

// Design 1 instrumented: the shipped K9 loop (trace_cable.cu with kStore) with
// the clock around it and its steps counted.
__global__ void __launch_bounds__(kThreads)
k9_segments_clock(Profile<float> p, float ds, const float* __restrict__ x0,
                  const float* __restrict__ v0, const float* __restrict__ target,
                  float* __restrict__ xt_out, float* __restrict__ vt_out,
                  float* __restrict__ d2_out, int* __restrict__ c_out,
                  float* __restrict__ ckpts, long long* clk, int n_rays, int max_steps,
                  int seg) {
  extern __shared__ __align__(16) unsigned char smem[];
  BinEntry<float>* tab = reinterpret_cast<BinEntry<float>*>(smem);
  build_bin_table(p, tab);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  float x[3], v[3], tg[3], xt[3], vt[3];
  load3(x0, i, x);
  load3(v0, i, v);
  load3(target, i, tg);
#pragma unroll
  for (int k = 0; k < 3; ++k) { xt[k] = x[k]; vt[k] = v[k]; }
  float d2 = sum_sq3(x, tg);
  bool inside = inbounds(p, x);
  bool esc = false;
  int c = 0;
  const long long t0 = clock64();
  int step = 0;
  for (int s0 = 0; s0 < max_steps && !esc; s0 += seg) {
    const size_t field = static_cast<size_t>(n_rays);
    float* ck = ckpts + static_cast<size_t>(s0 / seg) * 7 * field + i;
    const float row[7] = {x[0], x[1], x[2], v[0], v[1], v[2], 0.0f};
#pragma unroll
    for (int k = 0; k < 7; ++k) ck[k * field] = row[k];
    const int end = max_steps - s0 < seg ? max_steps : s0 + seg;
    for (step = s0; step < end && !esc; ++step)
      esc = trace_step(p, tab, ds, tg, x, v, xt, vt, d2, inside, c, step);
  }
  clk[2 * i] = clock64() - t0;
  clk[2 * i + 1] = step;
  store3(xt_out, i, xt);
  store3(vt_out, i, vt);
  d2_out[i] = d2;
  c_out[i] = c;
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, int blocks, int threads, size_t bytes, cudaStream_t s, Args... args) {
  const cudaError_t err = allow_shared(kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, threads, bytes, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <bool kColumns, int kRole>
int two_roles_launch(const CableExactArgs<float>& a, double* g, long long* clk, cudaStream_t s) {
  const size_t bytes = adjoint_shared_bytes<float>(a.p.res, kColumns) +
                       2 * sizeof(ReplayBuffer<float>);
  const int blocks = (a.n_rays + 31) / 32;
  return clk == nullptr
             ? launch(two_roles<kColumns, kRole, false>, blocks, kExactThreads, bytes, s, a, g,
                      clk)
             : launch(two_roles<kColumns, kRole, true>, blocks, kExactThreads, bytes, s, a, g,
                      clk);
}

template <bool kColumns, typename Ray>
int shell_launch(const Ray& ray, const Profile<float>& p, double* g, int n, int threads,
                 size_t extra, cudaStream_t s) {
  const size_t bytes = table_bytes<float>(p.res) +
                       static_cast<size_t>(p.res) * (kColumns ? threads : 1) * sizeof(double) +
                       extra;
  return launch(cable_adjoint_kernel<float, Ray, kColumns>, (n + threads - 1) / threads, threads,
                bytes, s, ray, p, g, n);
}

}  // namespace designs
}  // namespace anrt

extern "C" int anrt_k9_design(int design, int threads, const void* prof, int res, double radius,
                              double length, double ds, const void* x0, const void* v0,
                              const void* target, void* xt, void* vt, void* d2, void* c,
                              void* ckpts, void* clk, int n, int max_steps, int seg,
                              void* stream) {
  using namespace anrt;
  auto s = static_cast<cudaStream_t>(stream);
  const Profile<float> p = make_profile<float>(prof, res, radius, length);
  const float fds = static_cast<float>(ds);
  auto cx0 = static_cast<const float*>(x0), cv0 = static_cast<const float*>(v0);
  auto ctg = static_cast<const float*>(target);
  auto oxt = static_cast<float*>(xt), ovt = static_cast<float*>(vt);
  auto od2 = static_cast<float*>(d2), ock = static_cast<float*>(ckpts);
  auto oc = static_cast<int*>(c);
  auto ck = static_cast<long long*>(clk);
  const int blocks = (n + threads - 1) / threads;
  const size_t bytes = table_bytes<float>(res);
  if (design == 0) {
    return ck == nullptr
               ? designs::launch(previous::trace_cable_kernel<float, false>, blocks, threads,
                                 bytes, s, p, fds, cx0, cv0, ctg, oxt, ovt, od2, oc, ock, ck, n,
                                 max_steps, seg)
               : designs::launch(previous::trace_cable_kernel<float, true>, blocks, threads,
                                 bytes, s, p, fds, cx0, cv0, ctg, oxt, ovt, od2, oc, ock, ck, n,
                                 max_steps, seg);
  }
  if (design == 1) {
    return ck == nullptr
               ? designs::launch(trace_cable_kernel<float, true, true>, blocks, threads, bytes,
                                 s, p, fds, cx0, cv0, ctg, oxt, ovt, od2, oc, ock, n, max_steps,
                                 seg)
               : designs::launch(designs::k9_segments_clock, blocks, threads, bytes, s, p, fds,
                                 cx0, cv0, ctg, oxt, ovt, od2, oc, ock, ck, n, max_steps, seg);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int anrt_k10_design(int design, const void* prof, int res, double radius,
                               double length, double ds, const void* ckpts, const void* c,
                               const void* dx, const void* dv, void* grad_out, void* clk, int n,
                               int nseg, int seg, void* stream) {
  using namespace anrt;
  auto s = static_cast<cudaStream_t>(stream);
  const CableExactArgs<float> a{make_profile<float>(prof, res, radius, length),
                                static_cast<float>(ds), static_cast<const float*>(ckpts),
                                static_cast<const int*>(c), static_cast<const float*>(dx),
                                static_cast<const float*>(dv), n, nseg, seg};
  auto g = static_cast<double*>(grad_out);
  auto ck = static_cast<long long*>(clk);
  switch (design) {
    case 0:
    case 1: {
      const bool columns = design == 1;
      const int threads = columns ? kColumnThreads : kThreads;
      if (ck == nullptr) {
        const previous::CableExactRay<float, false> ray{a.p, a.ds, a.ckpts, a.c, a.dx, a.dv,
                                                   n, nseg, seg, ck};
        return columns ? designs::shell_launch<true>(ray, a.p, g, n, threads, 0, s)
                       : designs::shell_launch<false>(ray, a.p, g, n, threads, 0, s);
      }
      const previous::CableExactRay<float, true> ray{a.p, a.ds, a.ckpts, a.c, a.dx, a.dv,
                                                n, nseg, seg, ck};
      return columns ? designs::shell_launch<true>(ray, a.p, g, n, threads, 0, s)
                     : designs::shell_launch<false>(ray, a.p, g, n, threads, 0, s);
    }
    case 2: {
      const size_t extra = sizeof(float) * kCableReplay * 3 * kColumnThreads;
      if (ck == nullptr) {
        const designs::SharedBufferRay<false> ray{a, ck};
        return designs::shell_launch<true>(ray, a.p, g, n, kColumnThreads, extra, s);
      }
      const designs::SharedBufferRay<true> ray{a, ck};
      return designs::shell_launch<true>(ray, a.p, g, n, kColumnThreads, extra, s);
    }
    case 3:
      return designs::two_roles_launch<true, 0>(a, g, ck, s);
    case 4:
      return designs::two_roles_launch<false, 0>(a, g, ck, s);
    case 5:
      return designs::two_roles_launch<true, 1>(a, g, ck, s);
    case 6:
      return designs::two_roles_launch<true, 2>(a, g, ck, s);
    case 7:
      return designs::two_roles_launch<false, 2>(a, g, ck, s);
    case 8:
      return designs::two_roles_launch<false, 1>(a, g, ck, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
