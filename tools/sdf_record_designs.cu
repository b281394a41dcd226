// The split of K13 trace_sdf and K20 record_paths, timed beside the shipped
// kernels by tools/sdf_record_designs.py; no path of the port launches these.
// It includes the shipped trace_fwd.cu and instantiates its kernels under
// designs derived from the shipped loop (FwdLoop):
//
// K20 (anrt_k20_design), f64 or f32 grids:
//   design 0  FwdLoop, the shipped kernel's own code
//   design 1  NoRecords: only the last record stored (x kept live)
//   design 2  record_paths_clocked: the shipped loop with each slot's
//             clock64() cycles, its evaluating steps and its warp's (steps
//             where any lane evaluates) written to rec_clk, three words a
//             slot (no order)
//   operator: the grid's rcp_exact cleared, so div_h takes the operator
//
// K13 (anrt_k13_design), f32: pass 1 or 2 of the shipped loop under
// SdfRule<float, read>, read 2 (kSdfAhead: two grids, the step before the pairs) or 3
// (kSdfPacked: one grid of node pairs, the shipped step), launched
//   launch 0  as shipped
//   launch 3  SlotClock (cycles and steps a slot to rec_clk)
// K17 (anrt_k17_design): anrt_trace_sdf_ckpt's launch under either read.
// Designs measured and dropped (their numbers in PERF.md, the code in git): K13 in
// blocks of 64, on resident warps taking 32 slots at a time, and held to 12
// or 16 blocks an SM; K20 held to 10 or 12 blocks an SM, its records stored
// evict-first; the stencil's offset index in f64.
#include "trace_fwd.cu"

namespace anrt {

__device__ long long* rec_clk;  // null: no clocks

struct NoRecords : FwdLoop {
  static constexpr bool kRecords = false;
};

// Design 2: K20's loop with each slot's clock64() cycles, its evaluating
// steps and its warp's (steps where any of its lanes evaluates).
template <typename T>
__global__ void record_paths_clocked(Grid<T> grid, T ds, const T* __restrict__ x0,
                                     const T* __restrict__ v0, float* __restrict__ path,
                                     int n_rays, int nrec, int stride) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_rays) return;
  const long long t0 = clock64();
  T x[3], v[3];
  load3(x0, t, x);
  load3(v0, t, v);
  float* out = path + 3 * static_cast<size_t>(t);
  const size_t rec = 3 * static_cast<size_t>(n_rays);
  long long evals = 0, warp_evals = 0;
  const unsigned lanes = __activemask();
  with_division(grid, [&](const Grid<T>& g) {
    bool inside = inbounds(g, x);
    for (int k = 0; k < nrec; ++k, out += rec) {
      if (k > 0) {
        for (int s = 0; s < stride; ++s) {
          evals += inside;
          warp_evals += __any_sync(lanes, inside);
          inside = forward_step(g, ds, x, v, inside);
        }
      }
#pragma unroll
      for (int a = 0; a < 3; ++a) out[a] = static_cast<float>(x[a]);
    }
  });
  if (rec_clk != nullptr) {
    rec_clk[3 * t] = clock64() - t0;
    rec_clk[3 * t + 1] = evals;
    rec_clk[3 * t + 2] = warp_evals;
  }
}

struct SlotClock : FwdLoop {
  static __device__ __forceinline__ long long clock_start() { return clock64(); }
  static __device__ __forceinline__ void clock_stop(int t, long long t0, int steps) {
    if (rec_clk != nullptr) {
      rec_clk[3 * t] = clock64() - t0;
      rec_clk[3 * t + 1] = steps;
      rec_clk[3 * t + 2] = 0;
    }
  }
};

template <typename T, typename Opt>
int k20_launch(const Grid<T>& g, double ds, const void* x0, const void* v0, const int* order,
               void* path, int n, int nrec, int stride, cudaStream_t s) {
  record_paths_kernel<T, Opt><<<blocks_for(n), kThreads, 0, s>>>(
      g, static_cast<T>(ds), static_cast<const T*>(x0), static_cast<const T*>(v0), order,
      static_cast<float*>(path), n, nrec, stride);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int k20_design(int design, const Grid<T>& g, double ds, const void* x0, const void* v0,
               const int* order, void* path, int n, int nrec, int stride, cudaStream_t s) {
  switch (design) {
    case 0: return k20_launch<T, FwdLoop>(g, ds, x0, v0, order, path, n, nrec, stride, s);
    case 1: return k20_launch<T, NoRecords>(g, ds, x0, v0, order, path, n, nrec, stride, s);
    case 2:
      if (order != nullptr) return static_cast<int>(cudaErrorInvalidValue);
      record_paths_clocked<T><<<blocks_for(n), kThreads, 0, s>>>(
          g, static_cast<T>(ds), static_cast<const T*>(x0), static_cast<const T*>(v0),
          static_cast<float*>(path), n, nrec, stride);
      return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int kRead, typename Opt>
int k13_launch(const Grid<float>& g, const Grid<float>& sdf, double ds,
               const void* x0, const void* v0, const int* order, void* xt, void* vt,
               const Horizon<float>& hz, int n, int max_steps, int pass, cudaStream_t s) {
  using Rule = SdfRule<float, kRead>;
  const Rule rule{sdf};
  const auto f = static_cast<float>(ds);
  const auto xs = static_cast<const float*>(x0), vs = static_cast<const float*>(v0);
  const auto xo = static_cast<float*>(xt), vo = static_cast<float*>(vt);
  const int blocks = blocks_for(n);
  if (pass == 2) {
    trace_horizon_kernel<float, false, Rule, Opt><<<blocks, kThreads, 0, s>>>(
        g, f, order, xo, vo, nullptr, nullptr, nullptr, rule, hz, n, 1);
  } else {
    trace_fwd_kernel<float, false, Rule, Opt><<<blocks, kThreads, 0, s>>>(
        g, f, xs, vs, order, xo, vo, nullptr, nullptr, nullptr, rule, hz, n, max_steps, 1);
  }
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks of 128 an SM: which 0 K20 f64, 1 K20 f32, 2/3 K13 pass 1
// two grids / pairs, 4/5 K13 pass 2 two grids / pairs.
int occupancy(int which) {
  int blocks = -1;
  auto of = [&](auto kernel) {
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, 0))
      blocks = -1;
  };
  using A = SdfRule<float, kSdfAhead>;
  using P = SdfRule<float, kSdfPacked>;
  switch (which) {
    case 0: of(record_paths_kernel<double, FwdLoop>); break;
    case 1: of(record_paths_kernel<float, FwdLoop>); break;
    case 2: of(trace_fwd_kernel<float, false, A>); break;
    case 3: of(trace_fwd_kernel<float, false, P>); break;
    case 4: of(trace_horizon_kernel<float, false, A>); break;
    case 5: of(trace_horizon_kernel<float, false, P>); break;
  }
  return blocks;
}

}  // namespace anrt

// K20 under a design (0-2 above); force_operator: div_h by the operator
// whatever h; order may be null; the other arguments as anrt_record_paths'.
extern "C" int anrt_k20_design(int design, int force_operator, int is_double, const void* rif,
                               int W, int H, int D, double h, double ds, const void* x0,
                               const void* v0, const void* order, void* path, int n, int nrec,
                               int stride, void* stream) {
  using namespace anrt;
  auto s = static_cast<cudaStream_t>(stream);
  auto o = static_cast<const int*>(order);
  if (is_double) {
    auto g = make_grid<double>(rif, W, H, D, h);
    if (force_operator) g.rcp_exact = false;
    return k20_design<double>(design, g, ds, x0, v0, o, path, n, nrec, stride, s);
  }
  auto g = make_grid<float>(rif, W, H, D, h);
  return k20_design<float>(design, g, ds, x0, v0, o, path, n, nrec, stride, s);
}

// K13 pass 1 or 2 under read 2 (sdf: the sdf grid) or 3 (sdf: the node
// pairs) and launch 0 or 3; the horizon state as anrt_trace_sdf's.
extern "C" int anrt_k13_design(int read, int launch, const void* rif, int W, int H, int D,
                               double h, double ds, const void* sdf, const void* x0,
                               const void* v0, const void* order, void* xt, void* vt, void* hx,
                               void* hv, void* steps, void* inside, void* last, int n,
                               int max_steps, int pass, void* stream) {
  using namespace anrt;
  auto s = static_cast<cudaStream_t>(stream);
  auto o = static_cast<const int*>(order);
  const auto g = make_grid<float>(rif, W, H, D, h);
  const auto sg = make_grid<float>(sdf, W, H, D, h);
  const auto hz = make_horizon<float>(hx, hv, steps, inside, last);
  if (read == kSdfAhead)
    return launch == 3 ? k13_launch<kSdfAhead, SlotClock>(g, sg, ds, x0, v0, o, xt, vt, hz, n,
                                                         max_steps, pass, s)
                       : k13_launch<kSdfAhead, FwdLoop>(g, sg, ds, x0, v0, o, xt, vt, hz, n,
                                                        max_steps, pass, s);
  if (read == kSdfPacked)
    return launch == 3 ? k13_launch<kSdfPacked, SlotClock>(g, sg, ds, x0, v0, o, xt, vt, hz, n,
                                                          max_steps, pass, s)
                       : k13_launch<kSdfPacked, FwdLoop>(g, sg, ds, x0, v0, o, xt, vt, hz, n,
                                                         max_steps, pass, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K17 (f32) under read 2 (sdf: the sdf grid) or 3 (sdf: the node pairs); the
// other arguments as anrt_trace_sdf_ckpt's.
extern "C" int anrt_k17_design(int read, const void* rif, int W, int H, int D, double h,
                               double ds, const void* sdf, const void* x0, const void* v0,
                               const void* order, void* xt, void* vt, void* c, void* code,
                               void* ckpts, void* hx, void* hv, void* steps, void* inside,
                               void* last, const void* hor, void* hor_out, int n, int max_steps,
                               int seg, int chunk, int pass, void* stream) {
  using namespace anrt;
  auto s = static_cast<cudaStream_t>(stream);
  auto o = static_cast<const int*>(order);
  const auto g = make_grid<float>(rif, W, H, D, h);
  const auto hz = make_horizon<float>(hx, hv, steps, inside, last, hor, hor_out, chunk, n, seg,
                                      max_steps);
  const auto sg = make_grid<float>(sdf, W, H, D, h);
  if (read == kSdfAhead)
    return launch_variant<float, true>(g, ds, x0, v0, o, xt, vt, c, code, ckpts,
                                       SdfRule<float, kSdfAhead>{sg}, hz, n, max_steps, seg,
                                       pass, s);
  if (read == kSdfPacked)
    return launch_variant<float, true>(g, ds, x0, v0, o, xt, vt, c, code, ckpts,
                                       SdfRule<float, kSdfPacked>{sg}, hz, n, max_steps, seg,
                                       pass, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Where the clocked designs write: null, or three int64 a slot.
extern "C" int anrt_rec_set_clock(void* buf) {
  return static_cast<int>(cudaMemcpyToSymbol(anrt::rec_clk, &buf, sizeof(buf)));
}

extern "C" int anrt_rec_occupancy(int which) { return anrt::occupancy(which); }
