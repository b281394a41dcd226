// The split of the plane and target forward kernels K15 trace_plane_ckpt and
// K16 trace_target_ckpt (K11 trace_plane and K12 trace_target, the same loops
// without checkpoints, beside them), timed by tools/fwd_designs.py; no path of
// the port launches these.  f32 only.  It includes the shipped trace_fwd.cu
// and instantiates its loop (launch_variant) under the shipped rules and a
// design derived from the shipped one (trace_fwd.cu FwdLoop):
//   design 0  FwdLoop, the shipped kernels' own code
//   design 1  PlainStores: the checkpoint rows stored with plain stores, not
//             evict-first
//   design 2  Clocked: FwdLoop with each slot's clock64() cycles and steps
//             written to fwd_clk (anrt_fwd_set_clock), two words a slot
// and the target's rule with or without its retirement (TargetKeep: every
// escaped ray steps on to the horizon, as K12 and K16 did before it).  The
// stencil's division is measured by building the shipped sources again with
// ANRT_DIV_OPERATOR (tools/fwd_designs.py); a checkpoint store is left out by
// passing a null ckpts to that pass.
#include "trace_fwd.cu"

namespace anrt {

__device__ long long* fwd_clk;  // null: no clocks

struct PlainStores : FwdLoop {
  template <typename T>
  static __device__ __forceinline__ void store(T* p, T v) { *p = v; }
};

struct Clocked : FwdLoop {
  static __device__ __forceinline__ long long clock_start() { return clock64(); }
  static __device__ __forceinline__ void clock_stop(int t, long long t0, int steps) {
    if (fwd_clk != nullptr) {
      fwd_clk[2 * t] = clock64() - t0;
      fwd_clk[2 * t + 1] = steps;
    }
  }
};

template <typename T>
struct TargetKeep : TargetRule<T> {
  __device__ __forceinline__ bool continues(const typename TargetRule<T>::Ray&, const T*,
                                            const T*, bool) const {
    return true;
  }
};

enum FwdDesign { kShipped, kPlainStores, kClocked };

template <typename Opt, typename Rule>
int fwd_run(bool ckpt, const Rule& rule, const Grid<float>& g, double ds, const void* x0,
            const void* v0, const int* order, void* xt, void* vt, void* c, void* code,
            void* ckpts, const Horizon<float>& hz, int n, int max_steps, int seg, int pass,
            cudaStream_t s) {
  return ckpt ? launch_variant<float, true, Rule, Opt>(g, ds, x0, v0, order, xt, vt, c, code,
                                                       ckpts, rule, hz, n, max_steps, seg, pass,
                                                       s)
              : launch_variant<float, false, Rule, Opt>(g, ds, x0, v0, order, xt, vt, c, code,
                                                        ckpts, rule, hz, n, max_steps, seg, pass,
                                                        s);
}

// kRows: also the designs of the rows (checkpointing kernels only)
template <bool kRows, typename Rule>
int fwd_design(int design, bool ckpt, const Rule& rule, const Grid<float>& g, double ds,
               const void* x0, const void* v0, const int* order, void* xt, void* vt, void* c,
               void* code, void* ckpts, const Horizon<float>& hz, int n, int max_steps, int seg,
               int pass, cudaStream_t s) {
#define ANRT_ROWS(OPT)                                                                         \
  (ckpt ? launch_variant<float, true, Rule, OPT>(g, ds, x0, v0, order, xt, vt, c, code, ckpts, \
                                                 rule, hz, n, max_steps, seg, pass, s)         \
        : static_cast<int>(cudaErrorInvalidValue))
  switch (design) {
    case kShipped:
      return fwd_run<FwdLoop>(ckpt, rule, g, ds, x0, v0, order, xt, vt, c, code, ckpts, hz, n,
                              max_steps, seg, pass, s);
    case kClocked:
      return fwd_run<Clocked>(ckpt, rule, g, ds, x0, v0, order, xt, vt, c, code, ckpts, hz, n,
                              max_steps, seg, pass, s);
  }
  if constexpr (kRows) {
    if (design == kPlainStores) return ANRT_ROWS(PlainStores);
  }
#undef ANRT_ROWS
  return static_cast<int>(cudaErrorInvalidValue);
}

// Resident blocks an SM of the shipped kernel (pass 1 or 2) of `which`: 0 K2,
// 1 K5, 2 K11, 3 K15, 4 K12, 5 K16.
int fwd_occupancy(int which, int pass) {
  int blocks = -1;
  auto of = [&](auto kernel) {
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, 0))
      blocks = -1;
  };
  using VR = VolumeRule<float>;
  using PR = PlaneRule<float>;
  using TR = TargetRule<float>;
  if (pass == 1) {
    switch (which) {
      case 0: of(trace_fwd_kernel<float, false, VR>); break;
      case 1: of(trace_fwd_kernel<float, true, VR>); break;
      case 2: of(trace_fwd_kernel<float, false, PR>); break;
      case 3: of(trace_fwd_kernel<float, true, PR>); break;
      case 4: of(trace_fwd_kernel<float, false, TR>); break;
      case 5: of(trace_fwd_kernel<float, true, TR>); break;
    }
  } else if (which == 4) {
    of(trace_horizon_kernel<float, false, TR>);
  } else if (which == 5) {
    of(trace_horizon_kernel<float, true, TR>);
  }
  return blocks;
}

}  // namespace anrt

// One pass of a plane or target forward kernel under a design: rule 0 the
// plane (K15 with c and code, K11 with both null; `out` is miss), 1 the
// target (K16 / K12; `out` is d2), 2 the target without its retirement; the
// other arguments as anrt_trace_plane_ckpt's and anrt_trace_target_ckpt's.
extern "C" int anrt_fwd_design(int rule, int design, const void* rif, int W, int H, int D,
                               double h, double ds, const void* x0, const void* v0,
                               const void* pln_o, const void* pln_d, const void* target,
                               const void* order, void* xt, void* vt, void* out, void* c,
                               void* code, void* ckpts, void* hx, void* hv, void* steps,
                               void* inside, void* last, int n, int max_steps, int seg, int pass,
                               void* stream) {
  using namespace anrt;
  auto s = static_cast<cudaStream_t>(stream);
  auto o = static_cast<const int*>(order);
  const bool ckpt = c != nullptr;
  const auto g = make_grid<float>(rif, W, H, D, h);
  const auto tgt = static_cast<const float*>(target);
  const auto hz = make_horizon<float>(hx, hv, steps, inside, last);
  if (rule == 0) {
    const PlaneRule<float> pr{static_cast<const float*>(pln_o), static_cast<const float*>(pln_d),
                              static_cast<unsigned char*>(out)};
    return fwd_design<true>(design, ckpt, pr, g, ds, x0, v0, o, xt, vt, c, code, ckpts,
                            Horizon<float>{}, n, max_steps, seg, 1, s);
  }
  if (rule == 1) {
    const TargetRule<float> tr{tgt, static_cast<float*>(out)};
    return fwd_design<true>(design, ckpt, tr, g, ds, x0, v0, o, xt, vt, c, code, ckpts, hz, n,
                            max_steps, seg, pass, s);
  }
  const TargetKeep<float> keep{{tgt, static_cast<float*>(out)}};
  return fwd_design<false>(design, ckpt, keep, g, ds, x0, v0, o, xt, vt, c, code, ckpts, hz, n,
                           max_steps, seg, pass, s);
}

// Where the Clocked design writes: null, or two int64 a slot (cycles, steps).
extern "C" int anrt_fwd_set_clock(void* buf) {
  return static_cast<int>(cudaMemcpyToSymbol(anrt::fwd_clk, &buf, sizeof(buf)));
}

extern "C" int anrt_fwd_occupancy(int which, int pass) { return anrt::fwd_occupancy(which, pass); }
