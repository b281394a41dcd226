// K10 backtrace_cable_exact: the backward pass of the exact cable gradient,
// 32 rays a block, each ray taken by two threads: a replay lane and an
// adjoint lane.
//
// Replaces the segment replay of the JAX package's checkpointed cable adjoint
// (tracer/checkpointed.py::_bwd_segments_cable; the port's plain version is
// tracer/checkpointed.py::_bwd_segments_cable).  Per ray, from the checkpoints
// K9 wrote (trace_cable.cu): for each segment that starts before the ray's
// capture step c, last to first, replay the segment forward from its
// checkpoint (x, v, esc) with the forward's own step (cylinder.cuh
// cable_step), so every position is the forward's bit for bit; then, over the
// replayed positions in reverse, the evaluation at x_k (n, grad n, Hessian)
// and the adjoint update (splat, la/mu recursion), gated by (k < c) &
// active_k.  Steps k >= c are not run, which also skips every segment at or
// past max(c); start la = dx, mu = dv + ds*dx.  A lane is active at every
// step below its capture step (a frozen lane's distance no longer drops), so
// the gate is k < c; the replay still carries esc as the plain version does.
//
// What bounds it on the card: the latency of each ray's chains, step after
// step: the replay's (K7's step) and the adjoint's (the la/mu recursion after
// an evaluation), for 8,192 rays on a fiber step, which leave the card's 528
// schedulers at most a warp each.  The first designs ran both chains one
// after the other in one thread, though the replay of segment s-1 needs only
// its checkpoint and not the adjoint of segment s.  Here a block has two
// warps for the same 32 rays, split by warp and never by lane (lanes of one
// warp on different code would issue apart):
// * the replay warp replays each stretch (at most kCableReplay steps of a
//   segment) into one of two buffers: the positions, lane by lane, and a
//   word a lane of the steps at which it was active;
// * the adjoint warp sweeps the other buffer backward at the same time;
// * they hand the buffers over through named barriers: "full" (the replay
//   warp arrives, the adjoint warp waits) and "empty" (the other way round).
// So a step costs about the longer of the two chains, not their sum, the
// replayed positions live in the block's buffers rather than in the thread's
// local memory, and the kernel has twice the warps to spread over the
// schedulers.  The adjoint warp evaluates the field one step ahead of its
// update (the evaluation needs only the buffer), so that the two overlap:
// 15 % faster than evaluating in turn (tools/cable_designs.py, PERF.md).
// The lanes of each warp walk the segments and steps in step (the segment and
// stretch bounds are warp maxima); the first design, each lane from its own
// last segment, ran 10.2 ms against 1.5 with the lanes in step (PERF.md).
// A segment longer than the buffer is replayed in stretches, the later first,
// each from the segment's checkpoint.
//
// Gradient: as K8's (cylinder.cuh), each adjoint lane adds its splats to its
// own column of its block's gradient in shared memory (LaneColumn), no
// atomics, the two buffers beside it.  Where the columns and buffers do not
// fit beside the table (a profile of more than 763 bins in f32, 635 in f64),
// the block path: one gradient a block and a ray's runs (CableRun), the
// buffers in device memory (two a block, from the caller), so that shared
// memory holds only the table and the gradient, as K8's block path, and K10
// takes every profile K8 takes; its blocks, at most the caller's grid, each
// take every gridDim-th group of 32 rays.  The caller says which path
// (wrappers.backtrace_cable_exact_path).  Sums are in double; each block adds
// its gradient to device memory once.
#include "cylinder.cuh"

namespace anrt {

// the steps of a stretch: the most one buffer holds
constexpr int kCableReplay = 32;
// a block: the replay warp (threads 0-31) and the adjoint warp (32-63)
constexpr int kExactThreads = 64;
// named barriers 1-2: buffer b full; 3-4: buffer b empty (0 is __syncthreads)
constexpr int kBarFull = 1, kBarEmpty = 3;

// One buffer: a stretch's positions of the block's 32 rays, lane-minor so
// that a warp's store or load of one coordinate of one step is 32
// neighbouring words, and the steps at which each lane was active (bit j).
template <typename T>
struct ReplayBuffer {
  T x[kCableReplay][3][32];
  unsigned act[32];
};

// The shared-memory bytes of a block: the table and the gradient (a column a
// lane of the adjoint warp, or one), and on the column path the two buffers.
template <typename T>
__host__ inline size_t exact_shared_bytes(int res, bool columns) {
  return adjoint_shared_bytes<T>(res, columns) + (columns ? 2 * sizeof(ReplayBuffer<T>) : 0);
}

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(kExactThreads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(kExactThreads) : "memory");
}

// One replayed step: the forward's, with `inside` recomputed from x and the
// lane's esc carried, as the plain replay does.
template <typename T>
__device__ __forceinline__ void replay_step(const Profile<T>& p, const BinEntry<T>* tab, T ds,
                                            T x[3], T v[3], bool& esc) {
  const bool inside = inbounds(p, x);
  cable_step(p, tab, ds, x, v, !esc);
  const bool cur_inside = inbounds(p, x);
  esc = esc || (inside && !cur_inside) || escaped(p, x, v, static_cast<T>(1));
}

template <typename T>
struct CableExactArgs {
  Profile<T> p;
  T ds;
  const T* ckpts;  // (nseg, 7, n_rays)
  const int* c;
  const T *dx, *dv;
  int n_rays, nseg, seg;
};

// The stretches of a warp, in the order both roles take them: segments from
// the warp's last down to 0, and within a segment the stretches from the
// last; `n` is the lane's steps in the segment, n_warp the warp's most, b0 the
// stretch's first step, nb and nb_warp its steps for the lane and the warp.
struct Stretches {
  int steps, last, warp_last, seg;

  __device__ Stretches(int steps_, int nseg, int seg_) : steps(steps_), seg(seg_) {
    last = steps <= 0 ? -1 : ((steps - 1) / seg < nseg - 1 ? (steps - 1) / seg : nseg - 1);
    warp_last = __reduce_max_sync(0xffffffffu, last);
  }

  template <typename F>
  __device__ __forceinline__ void each(F&& f) const {
    int u = 0;
    for (int s = warp_last; s >= 0; --s) {
      const int n = s > last ? 0 : (steps - s * seg < seg ? steps - s * seg : seg);
      const int n_warp = __reduce_max_sync(0xffffffffu, n);
      for (int b0 = (n_warp - 1) / kCableReplay * kCableReplay; b0 >= 0;
           b0 -= kCableReplay, ++u) {
        const int nb = n - b0 < 0 ? 0 : (n - b0 < kCableReplay ? n - b0 : kCableReplay);
        const int nb_warp = n_warp - b0 < kCableReplay ? n_warp - b0 : kCableReplay;
        f(u, s, b0, nb, nb_warp);
      }
    }
  }
};

// The replay warp: each stretch into buffer u % 2, once the adjoint warp has
// emptied it (stretch u - 2); at the end it waits until the last two are
// emptied, so that no barrier is left half arrived.
template <typename T>
__device__ __forceinline__ void replay_role(const CableExactArgs<T>& a, const BinEntry<T>* tab,
                                            ReplayBuffer<T>* buf, int i, int lane,
                                            const Stretches& st) {
  const size_t field = static_cast<size_t>(a.n_rays);
  int units = 0;
  st.each([&](int u, int s, int b0, int nb, int nb_warp) {
    T x[3], v[3];
    bool esc = true;
    if (nb > 0) {
      const T* row = a.ckpts + s * 7 * field + i;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        x[k] = row[k * field];
        v[k] = row[(k + 3) * field];
      }
      esc = row[6 * field] > static_cast<T>(0.5);
      for (int j = 0; j < b0; ++j) replay_step(a.p, tab, a.ds, x, v, esc);
    }
    ReplayBuffer<T>& b = buf[u & 1];
    __syncwarp();
    if (u >= 2) bar_sync(kBarEmpty + (u & 1));
    unsigned act = 0u;
    for (int j = 0; j < nb_warp; ++j) {
      if (j < nb) {
#pragma unroll
        for (int k = 0; k < 3; ++k) b.x[j][k][lane] = x[k];
        if (!esc) act |= 1u << j;
        if (j + 1 < nb) replay_step(a.p, tab, a.ds, x, v, esc);
      }
    }
    b.act[lane] = act;
    __syncwarp();
    bar_arrive(kBarFull + (u & 1));
    units = u + 1;
  });
  for (int u = units - 2 < 0 ? 0 : units - 2; u < units; ++u) bar_sync(kBarEmpty + (u & 1));
}

// The adjoint warp's start, la = dx and mu = dv + ds*dx (zero for a lane
// without a ray).
template <typename T>
__device__ __forceinline__ void adjoint_start(const CableExactArgs<T>& a, int i, T la[3],
                                              T mu[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) la[k] = mu[k] = static_cast<T>(0);
  if (i < a.n_rays) {
    load3(a.dx, i, la);
    load3(a.dv, i, mu);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) mu[k] = mu[k] + a.ds * la[k];
}

// An accumulator that takes a splat only where the step is gated on: a
// select, not a branch, keeps a gated-off step's terms out (a zero splat at
// a stale pair of bins adds nothing; the bins are clamped whatever the
// position).
template <typename Acc>
struct Gated {
  Acc& acc;
  bool on;
  __device__ __forceinline__ void add(int j0, int j1, double c0, double c1) {
    acc.add(j0, j1, on ? c0 : 0.0, on ? c1 : 0.0);
  }
};

// The adjoint warp: each stretch out of buffer u % 2 once the replay warp has
// filled it, the steps in reverse, then the buffer handed back.  The field at
// step j - 1 is evaluated before the update of step j: it needs only the
// buffer, not la and mu, so the scheduler issues it beside the update's
// chain.  The update runs at every step; selects keep la, mu and the
// accumulator (a lane's column, or its runs) where the step is gated off (the
// lane is idle there, its position a stale one).
template <typename T, typename Acc>
__device__ __forceinline__ void adjoint_ahead(const CableExactArgs<T>& a, const BinEntry<T>* tab,
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
      Gated<Acc> g{acc, on};
      cable_adjoint_update(a.p, a.ds, f, hess, true, la2, mu2, g);
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

// buffers: on the block path two a block of the grid, in device memory; on
// the column path unused (the block's own two follow its columns).
template <typename T, bool kColumns>
__global__ void __launch_bounds__(kExactThreads)
backtrace_cable_exact_kernel(CableExactArgs<T> a, ReplayBuffer<T>* buffers,
                             double* __restrict__ grad_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  BinEntry<T>* tab = reinterpret_cast<BinEntry<T>*>(smem);
  double* acc = reinterpret_cast<double*>(tab + a.p.res);
  const int slots = kColumns ? kColumnThreads : 1;
  ReplayBuffer<T>* buf = kColumns ? reinterpret_cast<ReplayBuffer<T>*>(acc + a.p.res * slots)
                                  : buffers + 2 * blockIdx.x;
  build_bin_table(a.p, tab);
  for (int j = threadIdx.x; j < a.p.res * slots; j += blockDim.x) acc[j] = 0.0;
  __syncthreads();
  // every lane stays to the end, with or without a ray: the barriers count
  // whole warps, and each group's count is the block's
  const int lane = threadIdx.x & 31;
  for (int g = blockIdx.x; g * 32 < a.n_rays; g += gridDim.x) {
    const int i = g * 32 + lane;
    const Stretches st(i < a.n_rays ? __ldg(a.c + i) : 0, a.nseg, a.seg);
    if (threadIdx.x < 32) {
      replay_role(a, tab, buf, i, lane, st);
    } else if (kColumns) {
      LaneColumn col{acc + lane, slots};
      adjoint_ahead(a, tab, buf, i, lane, st, col);
    } else {
      CableRun run(acc);
      adjoint_ahead(a, tab, buf, i, lane, st, run);
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < a.p.res; j += blockDim.x) {
    double sum = 0.0;
    for (int t = 0; t < slots; ++t) sum += acc[j * slots + t];
    if (sum != 0.0) atomicAdd(grad_out + j, sum);
  }
}

template <typename T>
int launch_backtrace_cable_exact(const void* prof, int res, double radius, double length,
                                 double ds, const void* ckpts, const void* c, const void* dx,
                                 const void* dv, void* grad_out, int n_rays, int nseg, int seg,
                                 int columns, void* buffers, int grid, cudaStream_t stream) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  const CableExactArgs<T> a{make_profile<T>(prof, res, radius, length), static_cast<T>(ds),
                            static_cast<const T*>(ckpts), static_cast<const int*>(c),
                            static_cast<const T*>(dx), static_cast<const T*>(dv), n_rays,
                            nseg, seg};
  const size_t bytes = exact_shared_bytes<T>(res, columns != 0);
  auto kernel = columns ? backtrace_cable_exact_kernel<T, true>
                        : backtrace_cable_exact_kernel<T, false>;
  const cudaError_t err = allow_shared(kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = (n_rays + 31) / 32;
  kernel<<<columns || groups < grid ? groups : grid, kExactThreads, bytes, stream>>>(
      a, static_cast<ReplayBuffer<T>*>(buffers), static_cast<double*>(grad_out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace anrt

// grad_out: res doubles, zero-filled (or holding a sum to add to) before the
// call.  ckpts: (nseg, 7, n_rays) as K9 wrote them for the same rays; c
// (int32), dx, dv (3 per ray) at the rays' indices.  columns: 1 for a column a
// lane, 0 for one gradient a block and runs; then at most `grid` blocks, and
// `buffers` holds 2 * grid replay buffers (ReplayBuffer: 32 * (32 * 3 *
// sizeof(T) + 4) bytes each); unused on the column path.
extern "C" int anrt_backtrace_cable_exact(int is_double, const void* prof, int res,
                                          double radius, double length, double ds,
                                          const void* ckpts, const void* c, const void* dx,
                                          const void* dv, void* grad_out, int n_rays, int nseg,
                                          int seg, int columns, void* buffers, int grid,
                                          void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return is_double
             ? anrt::launch_backtrace_cable_exact<double>(prof, res, radius, length, ds, ckpts, c,
                                                          dx, dv, grad_out, n_rays, nseg, seg,
                                                          columns, buffers, grid, s)
             : anrt::launch_backtrace_cable_exact<float>(prof, res, radius, length, ds, ckpts, c,
                                                         dx, dv, grad_out, n_rays, nseg, seg,
                                                         columns, buffers, grid, s);
}
