// K6 backtrace_exact: the backward pass of the exact gradient, one thread per
// ray at a time.
//
// Replaces the segment replay of the JAX package's checkpointed adjoint
// (tracer/checkpointed.py::_backward_segments, plain variant; the port's
// plain version is tracer/checkpointed.py::_backward_segments).  Per ray,
// from the checkpoints K5 wrote (trace_fwd.cu): for each segment that starts
// before the ray's capture step c, last to first, replay the segment forward
// from its checkpoint (x, v, inside) with K2's own step (forward_step), so
// every position and eval mask is the forward's bit for bit; then, over the
// replayed positions in reverse, K3's evaluation (stencil, fetch,
// value_grad, hessian) and K3's adjoint update (adjoint_update: splat into
// the ray's run, la/mu recursion) with eval mask inside_k and no snapping.
// Steps k >= c are gated off and are not run; start la = dx,
// mu = dv + ds*dx (dv zeroed by the caller for rays that never escaped).  A
// ray that escaped without ever being inside (code 2) has no evaluation, so
// its gradient is zero and it runs no step.
//
// What bounds it on the card.  tools/exact_designs.py splits the ray by
// variants of it (NVIDIA H100 80GB HBM3, 700 W; configuration 11's 2^18-ray
// batches; PERF.md).  Of K18's 2.02 ms on SplatRun's runs the replay alone
// took 0.46, the reverse evaluation (stencil, corners, value, gradient,
// Hessian, the splat terms, the la/mu recursion) 0.43 more, the runs and
// the warp sums 0.33 more, and the runs' adds into device memory 0.80: 133 M
// atomic adds at about 1.7e11 a second, the L2's rate for them.  K6's adds
// took 1.57 of its 3.55 ms.  K19's adds (f64, its warp sums merging 76 % of
// its runs) took 0.05 of 2.30; its runs and f64 warp sums 0.94, its replay,
// which reads the sdf, 0.77.  So the design:
//   * the global path at every grid size, in this file's own kernel
//     (exact_kernel): one thread a ray slot, runs added straight to device
//     memory after K3's run sums and warp sums (trilinear.cuh).  K6's first
//     design took 1.6-1.7 times as long in adjoint.cuh's persistent
//     512-thread blocks with a block-private gradient;
//   * the lanes of a warp in step: the warp walks segment s of all its lanes
//     at once, from its last segment down, and step j of a segment at once,
//     a lane idle where it has no gated-on step.  Rays that are neighbours in
//     the ray order (tracer/order.py) are then at neighbouring positions at
//     every step, so a warp's corner reads touch few lines and its runs meet
//     in the warp sums;
//   * the checkpoints laid out (nseg, 7, n_slots): a warp's load of one field
//     is one 128-byte line;
//   * K18 and K19 (PairRun): the leader of a warp sum adds its 8 sums as 4
//     x-pairs of corners, each f32 pair in one aligned group of 4 words as
//     one float4 add, so the L2 takes 83 M requests for K18's 133 M words
//     (1.71 against 2.00-2.02 ms with SplatRun's adds, one call).  K19's
//     run and warp sums are in the grid's type and only its adds in f64
//     (6.3e-9 of the largest entry from the f64 sum of the same terms in
//     f32; limit 1e-5), and its replay reads the sdf with the stencil that
//     the next step's evaluation takes at the same point (sdf_step,
//     rules.cuh, K17's own step): 1.93-1.95 against 2.28-2.29 ms.  K6
//     keeps SplatRun's adds one by one: with PairRun it took 2.71 against
//     3.54 ms on the bench scene but 4-12 % longer at the fuel stages
//     17^3-65^3 and 1.5 % at 129^3 on a Luneburg batch, where it runs most.
// The replayed positions of one stretch of at most kReplay steps live in the
// thread's local memory (12 B a step in f32), written once and read once; a
// segment longer than kReplay is replayed in stretches, the later ones
// first, each from the segment's checkpoint.  Measured and not kept (PERF.md
// and tools/exact_designs.cu hold them): a tile of the gradient in shared
// memory per block and 32-step stretch, the block's threads in step (its
// boxes of nodes a stretch held a median of 8,640 nodes for K18 and 2,210
// for K19, 2-4 times a 16 KB tile, and shared-memory float adds compile to
// compare-and-swap loops that cost more than the L2's adds even where every
// block-stretch took the tile); runs carried across the face a ray crosses,
// adding 4 of the 8 sums (K18's adds fell to 47 M, its time rose, keyed by
// corner nodes); no warp sums; the reverse step in explicit fused
// multiply-adds (K18 3.5 %, K19 4.5 % faster, for a second copy of that
// arithmetic); K6's corner cache, n and grad n kept per
// replayed step, stretches of 16 steps, a kernel held to 4 blocks an SM
// (PERF.md keeps the numbers, git the design tool).  The order of the adds
// varies from run to run, so the gradient is reproducible to rounding only,
// not bitwise.
//
// K18 backtrace_plane_exact and K19 backtrace_sdf_exact are the same ray
// under the plane's and the sdf's rule (rules.cuh), replacing
// _backward_segments of the JAX package under those hooks: the replay takes
// K2's step and then the rule's "inside" (inbounds and not past the ray's
// plane; sdf < 0 read under the previous inside, one more grid read a
// replayed step), as K15 and K17 did when they wrote the checkpoints.  A ray
// that left the grid while still inside the sdf reads the field at clamped
// corners and splats into the edge voxels, as K14's does.  The target's
// backward pass is K6 itself: its "inside" is inbounds, and K16 writes the
// checkpoints on past a ray's escape up to the batch's horizon, so a capture
// made there is replayed like any other.  K6 and K18 sum in the grid's type
// (in f32 on the bench scene K18 read 3.0-3.7e-7 of the largest entry from
// the f64 sum of the same terms; limit 1e-5).  K19 adds into an f64 sum
// whatever the grid's type, as K14 does on the same sphere-sdf rays: its
// f32 adds read 2.0-3.8e-6 there, and K14's 1.06e-5.
#include "rules.cuh"

// The sm_90 vector atomicAdd on float4 in device memory (CUDA 12.5's
// sm_90_rt.h declares it); without it the f32 adds go one by one.
#if defined(__CUDACC_VER_MAJOR__) && \
    (__CUDACC_VER_MAJOR__ > 12 || (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 5))
#define ANRT_VECTOR_ATOMICS 1
#else
#define ANRT_VECTOR_ATOMICS 0
#endif

namespace anrt {

// the replay buffer's length in steps; a segment of up to kReplay steps is
// replayed once
constexpr int kReplay = 32;

// The tally of the exact backward passes (kernels/wrappers.py EXACT_TALLY):
// runs flushed (the plain version's `flushes`), flushes issued after the
// warp sums, atomic adds into device memory, and those of them that were
// float4 adds (an x-pair of a run's corners each).
enum ExactTally { kTallyRuns, kTallyIssued, kTallyAdds, kTallyFloat4, kTallyLen };

// One replayed forward step: K2's step, then the rule's "inside" at the new x
// with a stencil of its own (the replay of K6 and K18; K19 steps with
// sdf_step, rules.cuh).
template <typename T, typename Rule>
__device__ __forceinline__ bool replay_step(const Grid<T>& g, const Rule& rule,
                                            typename Rule::Ray& rr, T ds, T x[3], T v[3],
                                            bool inside) {
  return rule.inside(rr, x, inside, forward_step(g, ds, x, v, inside));
}

// Where a PairRun's adds go: the flat sum in device memory and its length.
template <typename Acc>
struct PairSink {
  Acc* out;
  int n_cells;
};

// Adds s0, s1 to out[i0], out[i1]; where i1 = i0 + 1 lies in the same
// aligned group of 4 f32 words, as one float4 add (zeros in the other two
// words).  Counts the adds issued in adds, and the float4 ones in float4s.
__device__ __forceinline__ void add_pair(const PairSink<float>& sink, int i0, int i1, float s0,
                                         float s1, int& adds, int& float4s) {
#if ANRT_VECTOR_ATOMICS
  const int base = i0 & ~3, k = i0 & 3;
  if (i1 == i0 + 1 && k != 3 && base + 3 < sink.n_cells) {
    atomicAdd(reinterpret_cast<float4*>(sink.out + base),
              make_float4(k == 0 ? s0 : 0.f, k == 0 ? s1 : (k == 1 ? s0 : 0.f),
                          k == 1 ? s1 : (k == 2 ? s0 : 0.f), k == 2 ? s1 : 0.f));
    ++adds;
    ++float4s;
    return;
  }
#endif
  atomicAdd(sink.out + i0, s0);
  atomicAdd(sink.out + i1, s1);
  adds += 2;
}

__device__ __forceinline__ void add_pair(const PairSink<double>& sink, int i0, int i1, double s0,
                                         double s1, int& adds, int&) {
  atomicAdd(sink.out + i0, s0);
  atomicAdd(sink.out + i1, s1);
  adds += 2;
}

// SplatRun (trilinear.cuh) with its run and warp sums in Sum and its adds in
// Acc, and the leader's 8 adds as 4 x-pairs of corners (a corner and the one
// beside it on x, idx[0][b][c] and idx[1][b][c]): an f32 pair that lies in
// one aligned group of 4 words goes as one float4 add, the L2 taking one
// request for two of the 8 words.  The same runs, warp sums and leaders as
// SplatRun's.
template <typename T, typename Sum, typename Acc>
struct PairRun {
  int idx[2][2][2];
  Sum sum[2][2][2];
  bool open = false;
  int flushes = 0, issued = 0, adds = 0, float4s = 0;

  // Called by every lane of the warp that is at this point; flushes the runs
  // of the lanes whose `cond` holds.
  __device__ __forceinline__ void flush_if(const PairSink<Acc>& sink, bool cond) {
    const unsigned active = __activemask();
    if (!__any_sync(active, cond)) return;
    const unsigned long long key =
        cond ? (static_cast<unsigned long long>(idx[0][0][0]) << 32) |
                   static_cast<unsigned>(idx[1][1][1])
             : ~0ULL;  // never a stencil's key: indices are below 2^31
    unsigned peers = __match_any_sync(active, key);
    if (!cond) peers = 0u;  // a lane that keeps its run takes no part in the sums
    const int lane = threadIdx.x & 31;
    const bool leader = lane == __ffs(peers) - 1;
    // tree sum over the peers into the lowest one, as SplatRun's
    int rank = __popc(peers & ((1u << lane) - 1u));
    peers &= ~((2u << lane) - 1u);
    while (__any_sync(active, peers != 0u)) {
      const int next = __ffs(peers) - 1;
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const Sum t = __shfl_sync(active, sum[a][b][c], next < 0 ? lane : next);
            if (next >= 0) sum[a][b][c] = sum[a][b][c] + t;
          }
      peers &= ~__ballot_sync(active, rank & 1);
      rank >>= 1;
    }
    if (cond && leader) {
#pragma unroll
      for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          add_pair(sink, idx[0][b][c], idx[1][b][c], static_cast<Acc>(sum[0][b][c]),
                   static_cast<Acc>(sum[1][b][c]), adds, float4s);
      ++issued;
    }
    if (cond) {
      ++flushes;
      open = false;
    }
  }

  // One step of the ray, as SplatRun::step.
  __device__ __forceinline__ void step(const PairSink<Acc>& sink, bool splat,
                                       const Stencil<T>& s, const T terms[2][2][2]) {
    const bool same =
        splat && open && idx[0][0][0] == s.idx[0][0][0] && idx[1][1][1] == s.idx[1][1][1];
    flush_if(sink, splat && open && !same);
    if (!splat) return;
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          if (same) {
            sum[a][b][c] = sum[a][b][c] + static_cast<Sum>(terms[a][b][c]);
          } else {
            sum[a][b][c] = static_cast<Sum>(terms[a][b][c]);
            idx[a][b][c] = s.idx[a][b][c];
          }
        }
    open = true;
  }
};

// The runs of a ray: SplatRun's (K6) or PairRun's (K18, K19).
enum RunKind { kSplatRun, kPairRun };

// RunOf<kind, T, Sum, Acc>: a kind of run, the stencil and the sink its steps
// take, and how a ray ends it and counts it (tally: kTallyLen counters).
template <int kKind, typename T, typename Sum, typename Acc>
struct RunOf;

template <typename T, typename Sum, typename Acc>
struct RunOf<kSplatRun, T, Sum, Acc> {
  using Run = SplatRun<T, Acc>;
  using St = Stencil<T>;
  using Sink = Acc*;
  static __device__ __forceinline__ Sink sink(Acc* out, const Grid<T>&) { return out; }
  static __device__ __forceinline__ St stencil_at(const Grid<T>& g, const T p[3]) {
    return stencil(g, p);
  }
  static __device__ __forceinline__ void finish(Run& run, Sink sink,
                                                unsigned long long* counts) {
    run.flush_if(sink, run.open);
    counts[kTallyRuns] += run.flushes;
    counts[kTallyIssued] += run.issued;
    counts[kTallyAdds] += 8ull * run.issued;
  }
};

template <typename T, typename Sum, typename Acc>
struct RunOf<kPairRun, T, Sum, Acc> {
  using Run = PairRun<T, Sum, Acc>;
  using St = Stencil<T>;
  using Sink = PairSink<Acc>;
  static __device__ __forceinline__ Sink sink(Acc* out, const Grid<T>& g) {
    return Sink{out, g.W * g.H * g.D};
  }
  static __device__ __forceinline__ St stencil_at(const Grid<T>& g, const T p[3]) {
    return stencil(g, p);
  }
  static __device__ __forceinline__ void finish(Run& run, const Sink& sink,
                                                unsigned long long* counts) {
    run.flush_if(sink, run.open);
    counts[kTallyRuns] += run.flushes;
    counts[kTallyIssued] += run.issued;
    counts[kTallyAdds] += run.adds;
    counts[kTallyFloat4] += run.float4s;
  }
};

// One ray of the backward pass.  The lanes of a warp walk the segments and
// the steps in step with each other: segment s of every lane at once (from
// the warp's last segment down, a lane idle in the segments past its own last
// one), and step j of a segment at once (a lane idle in the steps past its
// capture step), so that lanes whose rays are neighbours in the ray order
// are at neighbouring positions at every step.
// Acc: the sum in device memory's type (the grid's for K6 and K18, double
// for K19); Sum: the runs' and the warp's sums; kRun: the runs' kind
// (RunOf); kRead: how the sdf rule's replay reads the sdf (SdfRead,
// rules.cuh: kSdfAlone replays with replay_step, the others with sdf_step,
// the forward pass's own step).
template <typename T, typename Rule, typename Acc, typename Sum, int kRun, int kRead>
struct ExactRay {
  Grid<T> g;
  Rule rule;
  T ds;
  const T* ckpts;  // (nseg, 7, n_slots)
  const int* order;
  const int* c;
  const unsigned char* code;
  const T *dx, *dv;
  Acc* out;
  int n_slots, nseg, seg;

  // counts: kTallyLen counters this thread adds to
  __device__ __forceinline__ void operator()(int i, unsigned long long* counts) const {
    using Runs = RunOf<kRun, T, Sum, Acc>;
    const unsigned lanes = __activemask();  // the lanes of the warp that have a ray slot
    const int r = ray_of(order, i);
    typename Rule::Ray rr = rule.start(r, nullptr);
    const int steps = __ldg(code + r) == 2 ? 0 : __ldg(c + r);  // the gated-on steps
    const int last = steps <= 0 ? -1 : ((steps - 1) / seg < nseg - 1 ? (steps - 1) / seg
                                                                     : nseg - 1);
    const int warp_last = __reduce_max_sync(lanes, last);
    T la[3], mu[3];
    load3(dx, r, la);
    load3(dv, r, mu);
#pragma unroll
    for (int k = 0; k < 3; ++k) mu[k] = mu[k] + ds * la[k];
    typename Runs::Run run;
    const auto sink = Runs::sink(out, g);
    T xs[kReplay][3];
    const size_t field = static_cast<size_t>(n_slots);

    for (int s = warp_last; s >= 0; --s) {
      // this lane's steps in segment s, and the most of any lane
      const int n = s > last ? 0 : (steps - s * seg < seg ? steps - s * seg : seg);
      const int n_warp = __reduce_max_sync(lanes, n);
      const T* row = ckpts + s * 7 * field + i;  // this ray's field k at row[k * field]
      for (int b0 = (n_warp - 1) / kReplay * kReplay; b0 >= 0; b0 -= kReplay) {
        const int nb = n - b0 < 0 ? 0 : (n - b0 < kReplay ? n - b0 : kReplay);
        const int nb_warp = n_warp - b0 < kReplay ? n_warp - b0 : kReplay;
        T x[3], v[3];
        bool inside = false;
        Cell<T> cell;
        if (nb > 0) {
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            x[k] = row[k * field];
            v[k] = row[(k + 3) * field];
          }
          inside = row[6 * field] > static_cast<T>(0.5);
          if constexpr (kRead != kSdfAlone) {
            if (inside) sdf_enter<kRead>(g, rule.sdf, x, cell);
          }
          for (int j = 0; j < b0; ++j) inside = replay(rr, x, v, inside, cell);
        }
        unsigned ins = 0u;  // bit j: inside at the stretch's step j
        for (int j = 0; j < nb_warp; ++j) {
          if (j < nb) {
#pragma unroll
            for (int k = 0; k < 3; ++k) xs[j][k] = x[k];
            if (inside) ins |= 1u << j;
            inside = replay(rr, x, v, inside, cell);
          }
        }
        // reverse over the stretch; the next position is read from local memory
        // one step ahead, so that its load overlaps this step's work
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
            typename Runs::St st;
            if (emask) {
              st = Runs::stencil_at(g, xk);
              T cv[2][2][2];
              fetch(g, st, true, cv);
              value_grad(g, cv, st.w0, nk, grad);
              hessian(g, cv, st.w0, hess);
            }
            adjoint_update(g, ds, st, nk, grad, hess, emask, la, mu, run, sink);
          }
        }
      }
    }
    Runs::finish(run, sink, counts);
  }

  __device__ __forceinline__ bool replay(typename Rule::Ray& rr, T x[3], T v[3], bool inside,
                                         Cell<T>& cell) const {
    if constexpr (kRead != kSdfAlone) return sdf_step<kRead>(g, rule.sdf, ds, x, v, inside, cell);
    else return replay_step(g, rule, rr, ds, x, v, inside);
  }
};

// One ray slot a thread, 128 threads a block; tally: null or kTallyLen counters.
template <typename Ray>
__global__ void __launch_bounds__(kThreads)
exact_kernel(Ray ray, unsigned long long* __restrict__ tally, int n_slots) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_slots) return;
  unsigned long long counts[kTallyLen] = {0, 0, 0, 0};
  ray(i, counts);
  if (tally != nullptr) {
#pragma unroll
    for (int k = 0; k < kTallyLen; ++k)
      if (counts[k]) atomicAdd(tally + k, counts[k]);
  }
}

// Launches the ray of `rule` over n_slots slots; returns the launch's CUDA
// error (0 on success).
template <typename T, typename Acc, typename Sum, int kRun, int kRead = kSdfAlone,
          typename Rule>
int launch_exact(const Rule& rule, const void* rif, int W, int H, int D, double h, double ds,
                 const void* ckpts, const int* order, const void* c, const void* code,
                 const void* dx, const void* dv, void* grad_out, unsigned long long* tally,
                 int n_slots, int nseg, int seg, cudaStream_t stream) {
  if (n_slots <= 0) return static_cast<int>(cudaGetLastError());
  const ExactRay<T, Rule, Acc, Sum, kRun, kRead> ray{
      make_grid<T>(rif, W, H, D, h), rule, static_cast<T>(ds), static_cast<const T*>(ckpts),
      order, static_cast<const int*>(c), static_cast<const unsigned char*>(code),
      static_cast<const T*>(dx), static_cast<const T*>(dv), static_cast<Acc*>(grad_out),
      n_slots, nseg, seg};
  exact_kernel<<<blocks_for(n_slots), kThreads, 0, stream>>>(ray, tally, n_slots);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace anrt

// grad_out must be zero-filled (or hold a sum to add to) before the call.
// order: n_slots ray indices (thread i takes ray order[i]); ckpts: (nseg, 7,
// n_slots), column i thread i's, as K5 wrote them for the same order; c, code,
// dx, dv at the rays' own indices.  tally: null, or kTallyLen counters.  K6's
// runs are SplatRun's.
extern "C" int anrt_backtrace_exact(int is_double, const void* rif, int W, int H, int D,
                                    double h, double ds, const void* ckpts, const void* order,
                                    const void* c, const void* code, const void* dx,
                                    const void* dv, void* grad_out, void* tally, int n_slots,
                                    int nseg, int seg, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto o = static_cast<const int*>(order);
  auto t = static_cast<unsigned long long*>(tally);
  if (is_double)
    return anrt::launch_exact<double, double, double, anrt::kSplatRun>(
        anrt::VolumeRule<double>{}, rif, W, H, D, h, ds, ckpts, o, c, code, dx, dv, grad_out, t,
        n_slots, nseg, seg, s);
  return anrt::launch_exact<float, float, float, anrt::kSplatRun>(
      anrt::VolumeRule<float>{}, rif, W, H, D, h, ds, ckpts, o, c, code, dx, dv, grad_out, t,
      n_slots, nseg, seg, s);
}

// K18: as anrt_backtrace_exact, from K15's checkpoints, with the rays' planes
// (pln_o, pln_d: (N, 3) at the rays' own indices); grad_out of the grid's
// type; PairRun's runs.
extern "C" int anrt_backtrace_plane_exact(int is_double, const void* rif, int W, int H, int D,
                                          double h, double ds, const void* ckpts,
                                          const void* order, const void* c, const void* code,
                                          const void* pln_o, const void* pln_d, const void* dx,
                                          const void* dv, void* grad_out, void* tally,
                                          int n_slots, int nseg, int seg, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto o = static_cast<const int*>(order);
  auto t = static_cast<unsigned long long*>(tally);
  if (is_double) {
    const anrt::PlaneRule<double> rule{static_cast<const double*>(pln_o),
                                       static_cast<const double*>(pln_d), nullptr};
    return anrt::launch_exact<double, double, double, anrt::kPairRun>(
        rule, rif, W, H, D, h, ds, ckpts, o, c, code, dx, dv, grad_out, t, n_slots, nseg, seg,
        s);
  }
  const anrt::PlaneRule<float> rule{static_cast<const float*>(pln_o),
                                    static_cast<const float*>(pln_d), nullptr};
  return anrt::launch_exact<float, float, float, anrt::kPairRun>(
      rule, rif, W, H, D, h, ds, ckpts, o, c, code, dx, dv, grad_out, t, n_slots, nseg, seg,
      s);
}

// K19: as anrt_backtrace_exact, from K17's checkpoints, with K17's node
// pairs (rif, sdf) of the grid's type (kernels/wrappers.py node_pairs);
// grad_out is double whatever the grid's type, the run and warp sums in the
// grid's type; the replay steps with K17's sdf_step on the pairs
// (kSdfPacked), the reverse evaluation reads rif.
extern "C" int anrt_backtrace_sdf_exact(int is_double, const void* rif, int W, int H, int D,
                                        double h, double ds, const void* pairs, const void* ckpts,
                                        const void* order, const void* c, const void* code,
                                        const void* dx, const void* dv, void* grad_out,
                                        void* tally, int n_slots, int nseg, int seg,
                                        void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto o = static_cast<const int*>(order);
  auto t = static_cast<unsigned long long*>(tally);
  if (is_double) {
    const anrt::SdfRule<double, anrt::kSdfPacked> rule{
        anrt::make_grid<double>(pairs, W, H, D, h)};
    return anrt::launch_exact<double, double, double, anrt::kPairRun, anrt::kSdfPacked>(
        rule, rif, W, H, D, h, ds, ckpts, o, c, code, dx, dv, grad_out, t, n_slots, nseg, seg,
        s);
  }
  const anrt::SdfRule<float, anrt::kSdfPacked> rule{anrt::make_grid<float>(pairs, W, H, D, h)};
  return anrt::launch_exact<float, double, float, anrt::kPairRun, anrt::kSdfPacked>(
      rule, rif, W, H, D, h, ds, ckpts, o, c, code, dx, dv, grad_out, t, n_slots, nseg, seg,
      s);
}
