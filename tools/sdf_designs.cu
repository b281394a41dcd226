// The split of the sdf kernels, timed beside the shipped ones by
// tools/sdf_designs.py; no path of the port launches them.  f32 grids only.
//
// K14 backtrace_sdf (anrt_k14_split): K3's ray under the sdf rule, written
// here with the shipped routines (trilinear.cuh, adjoint.cuh's kernel shell
// on its global path) and a knob for each part the split takes away:
//   mode 0  the whole ray (with read 0 and f64 sums, the design before the
//           redesign: (a)); it writes each ray's step count to `steps`
//   mode 1  (b) no sdf read: each ray stops at the step count mode 0 wrote
//           (the same ray-steps and splats as mode 0)
//   mode 2  (c) no run and no adds: the splat terms folded into a sum that
//           the thread writes to probe[i]
//   mode 3  (d) the run and the warp sums, no adds: the leader folds the
//           run's sums into that sum instead
// read 0: the sdf read with a stencil of its own after the grid's (value_at);
// read 1: (e) one stencil at xe for both grids, both corner sets loaded
// before either is used.  f32_sums: (f) the run and warp sums in f32, the
// adds in f64 (else f64 throughout, the design before).
//
// K13 / K17 (anrt_sdf_forward): the shipped forward loop (trace_fwd.cu's
// kernels, launch_variant) under SdfRule<float, read>: read 0 (kSdfAlone)
// the sdf read with its own stencil after K2's step, as before the
// redesign; 1 (kSdfShared) one stencil a step, the grid's corners loaded at
// the next step's start; 2 (kSdfAhead) one stencil, both corner sets loaded
// together (the shipped step).  ckpts null: no checkpoint stores; hor given
// or hor_out and chunk as the shipped anrt_trace_sdf_ckpt takes them.
#include "adjoint.cuh"
#include "trace_fwd.cu"

namespace anrt {

enum K14Mode { kK14Whole, kK14NoSdf, kK14NoRun, kK14NoAdds };

// The terms of a step folded into one sum, no run: mode 2.
struct FoldRun {
  double fold = 0;
  bool open = false;
  int flushes = 0, issued = 0;
  __device__ __forceinline__ void flush_if(double*, bool) {}
  template <typename S, typename T>
  __device__ __forceinline__ void step(double*, bool splat, const S&, const T terms[2][2][2]) {
    if (!splat) return;
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int c = 0; c < 2; ++c) fold += static_cast<double>(terms[a][b][c]);
  }
};

// SplatRun's runs and warp sums (trilinear.cuh), whose leader folds the 8
// sums into one sum instead of adding them to the gradient: mode 3.
template <typename Sum>
struct NoAddRun {
  int idx[2][2][2];
  Sum sum[2][2][2];
  bool open = false;
  int flushes = 0, issued = 0;
  double fold = 0;

  __device__ __forceinline__ void flush_if(double*, bool cond) {
    const unsigned active = __activemask();
    if (!__any_sync(active, cond)) return;
    const unsigned long long key =
        cond ? (static_cast<unsigned long long>(idx[0][0][0]) << 32) |
                   static_cast<unsigned>(idx[1][1][1])
             : ~0ULL;
    unsigned peers = __match_any_sync(active, key);
    if (!cond) peers = 0u;
    const int lane = threadIdx.x & 31;
    const bool leader = lane == __ffs(peers) - 1;
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
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b)
#pragma unroll
          for (int c = 0; c < 2; ++c) fold += static_cast<double>(sum[a][b][c]);
      ++issued;
    }
    if (cond) {
      ++flushes;
      open = false;
    }
  }

  template <typename S, typename T>
  __device__ __forceinline__ void step(double* acc, bool splat, const S& s,
                                       const T terms[2][2][2]) {
    const bool same =
        splat && open && idx[0][0][0] == s.idx[0][0][0] && idx[1][1][1] == s.idx[1][1][1];
    flush_if(acc, splat && open && !same);
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

template <int kMode, typename Sum>
struct K14RunOf {
  using Run = SplatRun<float, double, Sum>;
};
template <typename Sum>
struct K14RunOf<kK14NoRun, Sum> {
  using Run = FoldRun;
};
template <typename Sum>
struct K14RunOf<kK14NoAdds, Sum> {
  using Run = NoAddRun<Sum>;
};

template <typename Run>
__device__ __forceinline__ double folded(const Run&) { return 0; }
__device__ __forceinline__ double folded(const FoldRun& r) { return r.fold; }
template <typename Sum>
__device__ __forceinline__ double folded(const NoAddRun<Sum>& r) { return r.fold; }

// K3's ray under the sdf rule (backtrace.cu's order of operations) with the
// split's knobs; the adds in f64, the run and warp sums in Sum.
template <int kMode, int kRead, typename Sum>
struct K14SplitRay {
  Grid<float> g, sdf;
  float ds, tol;
  const float *xt, *vt, *dx, *dv;
  const int* order;
  int max_steps;
  int* steps;     // mode 0 writes the loop's trips (max_steps + 1: still active), mode 1 reads
  double* probe;  // modes 2, 3: a thread's folded sum

  __device__ __forceinline__ void operator()(int i, double* acc,
                                             unsigned long long counts[2]) const {
    const int r = ray_of(order, i);
    float x[3], v[3], la[3], mu[3];
    load3(xt, r, x);
    load3(vt, r, v);
    load3(dx, r, la);
    load3(dv, r, mu);
#pragma unroll
    for (int k = 0; k < 3; ++k) mu[k] = mu[k] + ds * la[k];
    bool active = !escaped(g, x, v, -1.f);
    bool outside = true;
    if (kMode != kK14NoSdf && active) outside = value_at(sdf, x) >= 0.f;
    const int stop = kMode == kK14NoSdf ? steps[r] : 0;
    typename K14RunOf<kMode, Sum>::Run run;
    int step = 0;
    for (; step < max_steps && active; ++step) {
#pragma unroll
      for (int k = 0; k < 3; ++k) x[k] = x[k] - ds * v[k];
      float xe[3];
      snap_to_nodes(g, x, tol, xe);
      const bool emask = inbounds(g, xe);
      float n = 0, grad[3] = {0, 0, 0}, hess[3] = {0, 0, 0}, dist = 0;
      Stencil<float> s;
      if (kMode != kK14NoSdf && kRead == 1) {
        s = stencil(g, xe);
        float c[2][2][2], cs[2][2][2], sg[3];
        fetch(g, s, emask, c);
        fetch(sdf, s, true, cs);
        if (emask) evaluate(s, c, n, grad, hess, v);
        value_grad(sdf, cs, s.w0, dist, sg);
      } else {
        if (emask) {
          s = stencil(g, xe);
          float c[2][2][2];
          fetch(g, s, true, c);
          evaluate(s, c, n, grad, hess, v);
        }
        if (kMode != kK14NoSdf) dist = value_at(sdf, xe);
      }
      active = !escaped(g, xe, v, -1.f);
      if (kMode == kK14NoSdf) {
        active = active && step + 1 < stop;
      } else {
        const bool out = dist >= 0.f;
        active = active && (outside || !out);
        outside = out;
      }
      adjoint_update(g, ds, s, n, grad, hess, active && emask, la, mu, run, acc);
    }
    run.flush_if(acc, run.open);
    if (kMode == kK14Whole && steps != nullptr) steps[r] = active ? max_steps + 1 : step;
    if (kMode == kK14NoRun || kMode == kK14NoAdds) probe[i] = folded(run);
    counts[0] += run.flushes;
    counts[1] += run.issued;
  }

  __device__ __forceinline__ void evaluate(const Stencil<float>& s, const float c[2][2][2],
                                           float& n, float grad[3], float hess[3],
                                           float v[3]) const {
    value_grad(g, c, s.w0, n, grad);
    hessian(g, c, s.w0, hess);
    const float dsn = ds * n;
#pragma unroll
    for (int k = 0; k < 3; ++k) v[k] = v[k] - dsn * grad[k];
  }
};

template <int kMode, int kRead, typename Sum>
int launch_k14(const void* rif, const void* sdf, int W, int H, int D, double h, double ds,
               double tol, const void* xt, const void* vt, const void* dx, const void* dv,
               const int* order, void* grad_out, unsigned long long* tally, int* steps,
               double* probe, int n, int max_steps, cudaStream_t stream) {
  const K14SplitRay<kMode, kRead, Sum> ray{
      make_grid<float>(rif, W, H, D, h), make_grid<float>(sdf, W, H, D, h),
      static_cast<float>(ds), static_cast<float>(tol), static_cast<const float*>(xt),
      static_cast<const float*>(vt), static_cast<const float*>(dx),
      static_cast<const float*>(dv), order, max_steps, steps, probe};
  return launch_adjoint<double>(ray, W * H * D, grad_out, tally, n, 0, stream);
}

template <int kMode, int kRead>
int k14_sums(int f32_sums, const void* rif, const void* sdf, int W, int H, int D, double h,
             double ds, double tol, const void* xt, const void* vt, const void* dx,
             const void* dv, const int* order, void* grad_out, unsigned long long* tally,
             int* steps, double* probe, int n, int max_steps, cudaStream_t stream) {
  return f32_sums ? launch_k14<kMode, kRead, float>(rif, sdf, W, H, D, h, ds, tol, xt, vt, dx,
                                                    dv, order, grad_out, tally, steps, probe, n,
                                                    max_steps, stream)
                  : launch_k14<kMode, kRead, double>(rif, sdf, W, H, D, h, ds, tol, xt, vt, dx,
                                                     dv, order, grad_out, tally, steps, probe, n,
                                                     max_steps, stream);
}

template <int kMode>
int k14_read(int read, int f32_sums, const void* rif, const void* sdf, int W, int H, int D,
             double h, double ds, double tol, const void* xt, const void* vt, const void* dx,
             const void* dv, const int* order, void* grad_out, unsigned long long* tally,
             int* steps, double* probe, int n, int max_steps, cudaStream_t stream) {
  return read ? k14_sums<kMode, 1>(f32_sums, rif, sdf, W, H, D, h, ds, tol, xt, vt, dx, dv,
                                   order, grad_out, tally, steps, probe, n, max_steps, stream)
              : k14_sums<kMode, 0>(f32_sums, rif, sdf, W, H, D, h, ds, tol, xt, vt, dx, dv,
                                   order, grad_out, tally, steps, probe, n, max_steps, stream);
}

template <int kRead>
int sdf_forward(int ckpt, const Grid<float>& g, const Grid<float>& sdf, double ds,
                const void* x0, const void* v0, const int* order, void* xt, void* vt, void* c,
                void* code, void* ckpts, const Horizon<float>& hz, int n, int max_steps,
                int seg, int pass, cudaStream_t stream) {
  const SdfRule<float, kRead> rule{sdf};
  return ckpt ? launch_variant<float, true>(g, ds, x0, v0, order, xt, vt, c, code, ckpts, rule,
                                            hz, n, max_steps, seg, pass, stream)
              : launch_variant<float, false>(g, ds, x0, v0, order, xt, vt, c, code, ckpts, rule,
                                             hz, n, max_steps, seg, pass, stream);
}

}  // namespace anrt

// K14's split: mode (K14Mode), read, f32_sums as above; grad_out (double,
// zeroed), tally (null or 3 counters), steps (n ints at the rays' indices),
// probe (n doubles) as the modes take them.
extern "C" int anrt_k14_split(int mode, int read, int f32_sums, const void* rif, int W, int H,
                              int D, double h, double ds, double tol, const void* sdf,
                              const void* xt, const void* vt, const void* dx, const void* dv,
                              const void* order, void* grad_out, void* tally, void* steps,
                              void* probe, int n, int max_steps, void* stream) {
  using namespace anrt;
  auto s = static_cast<cudaStream_t>(stream);
  auto o = static_cast<const int*>(order);
  auto t = static_cast<unsigned long long*>(tally);
  auto st = static_cast<int*>(steps);
  auto p = static_cast<double*>(probe);
#define ANRT_K14(M)                                                                        \
  k14_read<M>(read, f32_sums, rif, sdf, W, H, D, h, ds, tol, xt, vt, dx, dv, o, grad_out, t, \
              st, p, n, max_steps, s)
  switch (mode) {
    case kK14Whole: return ANRT_K14(kK14Whole);
    case kK14NoSdf: return ANRT_K14(kK14NoSdf);
    case kK14NoRun: return ANRT_K14(kK14NoRun);
    case kK14NoAdds: return ANRT_K14(kK14NoAdds);
  }
#undef ANRT_K14
  return static_cast<int>(cudaErrorInvalidValue);
}

// K13 (c, code, ckpts null; ckpt 0) and K17 (ckpt 1; ckpts may be null) with
// the sdf read `read` (SdfRead), one pass; the other arguments as
// anrt_trace_sdf_ckpt's.
extern "C" int anrt_sdf_forward(int read, int ckpt, const void* rif, int W, int H, int D,
                                double h, double ds, const void* sdf, const void* x0,
                                const void* v0, const void* order, void* xt, void* vt, void* c,
                                void* code, void* ckpts, void* hx, void* hv, void* steps,
                                void* inside, void* last, const void* hor, void* hor_out,
                                int n, int max_steps, int seg, int chunk, int pass,
                                void* stream) {
  using namespace anrt;
  auto s = static_cast<cudaStream_t>(stream);
  auto o = static_cast<const int*>(order);
  const auto g = make_grid<float>(rif, W, H, D, h);
  const auto sg = make_grid<float>(sdf, W, H, D, h);
  const auto hz = make_horizon<float>(hx, hv, steps, inside, last, hor, hor_out, chunk, n, seg,
                                      max_steps);
  if (read == kSdfAlone)
    return sdf_forward<kSdfAlone>(ckpt, g, sg, ds, x0, v0, o, xt, vt, c, code, ckpts, hz, n,
                                  max_steps, seg, pass, s);
  if (read == kSdfShared)
    return sdf_forward<kSdfShared>(ckpt, g, sg, ds, x0, v0, o, xt, vt, c, code, ckpts, hz, n,
                                   max_steps, seg, pass, s);
  return sdf_forward<kSdfAhead>(ckpt, g, sg, ds, x0, v0, o, xt, vt, c, code, ckpts, hz, n,
                                max_steps, seg, pass, s);
}
