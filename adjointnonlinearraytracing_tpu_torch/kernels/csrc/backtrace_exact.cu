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
// What bounds it on the card: operations (about one forward step, the
// replay, and one adjoint step a ray-step), the splats' adds, and how many
// distinct lines a warp's corner reads touch.  The design (tools/k6_designs.py
// times it against K6's first design and the designs in between; PERF.md):
//   * the global path of adjoint.cuh at every grid size: one thread a ray
//     slot, runs added straight to device memory after K3's run sums and
//     warp sums (trilinear.cuh).  The first design took 1.6-1.7 times as
//     long in adjoint.cuh's persistent 512-thread blocks with a
//     block-private gradient (one block an SM at its 104 registers), at
//     every fuel stage K3 takes them;
//   * the lanes of a warp in step: the warp walks segment s of all its lanes
//     at once, from its last segment down, and step j of a segment at once,
//     a lane idle where it has no gated-on step.  Rays that are neighbours in
//     the ray order (tracer/order.py) are then at neighbouring positions at
//     every step, so a warp's corner reads touch few lines and its runs meet
//     in the warp sums.  The first design let each lane start at its own
//     last segment and step, and two lanes whose capture steps fell in
//     different segments ran 32 steps apart for the rest of the ray;
//   * the checkpoints laid out (nseg, 7, n_slots): a warp's load of one field
//     is one 128-byte line.
// The replayed positions of one stretch of at most kReplay steps live in the
// thread's local memory (12 B a step in f32), written once and read once; a
// segment longer than kReplay is replayed in stretches, the later ones
// first, each from the segment's checkpoint.  Measured and not kept: a cache
// of the current cell's 8 corner values (a few per cent either way, and more
// registers), n and grad n kept per replayed step, stretches of 16 steps, a
// kernel held to 4 blocks an SM.  The order of the adds varies from run to
// run, so the gradient is reproducible to rounding only, not bitwise.
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
// (in f32 on the bench scene K18 read 3.9e-7 of the largest entry from the
// f64 sum of the same terms, an H100; limit 1e-5).  K19 sums in f64 whatever
// the grid's type, as K14 does on the same sphere-sdf rays: its f32 sum read
// 2.0-3.8e-6 there, from adds whose order changes from run to run, and
// K14's f32 sum read 1.06e-5.
#include "adjoint.cuh"
#include "rules.cuh"

namespace anrt {

// the replay buffer's length in steps; a segment of up to kReplay steps is
// replayed once
constexpr int kReplay = 32;

// One replayed forward step: K2's step, then the rule's "inside" at the new x.
template <typename T, typename Rule>
__device__ __forceinline__ bool replay_step(const Grid<T>& g, const Rule& rule,
                                            typename Rule::Ray& rr, T ds, T x[3], T v[3],
                                            bool inside) {
  return rule.inside(rr, x, inside, forward_step(g, ds, x, v, inside));
}

// One ray of the backward pass.  The lanes of a warp walk the segments and
// the steps in step with each other: segment s of every lane at once (from
// the warp's last segment down, a lane idle in the segments past its own last
// one), and step j of a segment at once (a lane idle in the steps past its
// capture step), so that lanes whose rays are neighbours in the ray order are
// at neighbouring positions at every step.
// Acc: the accumulator's type (the grid's for K6 and K18, double for K19).
template <typename T, typename Rule, typename Acc>
struct ExactRay {
  Grid<T> g;
  Rule rule;
  T ds;
  const T* ckpts;  // (nseg, 7, n_slots)
  const int* order;
  const int* c;
  const unsigned char* code;
  const T *dx, *dv;
  int n_slots, nseg, seg;

  __device__ __forceinline__ void operator()(int i, Acc* acc, unsigned long long counts[2]) const {
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
    SplatRun<T, Acc> run;
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
        if (nb > 0) {
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            x[k] = row[k * field];
            v[k] = row[(k + 3) * field];
          }
          inside = row[6 * field] > static_cast<T>(0.5);
          for (int j = 0; j < b0; ++j) inside = replay_step(g, rule, rr, ds, x, v, inside);
        }
        unsigned ins = 0u;  // bit j: inside at the stretch's step j
        for (int j = 0; j < nb_warp; ++j) {
          if (j < nb) {
#pragma unroll
            for (int k = 0; k < 3; ++k) xs[j][k] = x[k];
            if (inside) ins |= 1u << j;
            inside = replay_step(g, rule, rr, ds, x, v, inside);
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
    }
    run.flush_if(acc, run.open);
    counts[0] += run.flushes;
    counts[1] += run.issued;
  }
};

// K6, K18, K19 over n_slots thread slots (the rule's inputs in `rule`);
// grad_out holds Acc
template <typename T, typename Acc = T, typename Rule>
int launch_backtrace_exact(const Rule& rule, const void* rif, int W, int H, int D, double h,
                           double ds, const void* ckpts, const int* order, const void* c,
                           const void* code, const void* dx, const void* dv, void* grad_out,
                           unsigned long long* tally, int n_slots, int nseg, int seg,
                           cudaStream_t stream) {
  const ExactRay<T, Rule, Acc> ray{
      make_grid<T>(rif, W, H, D, h), rule, static_cast<T>(ds), static_cast<const T*>(ckpts),
      order, static_cast<const int*>(c), static_cast<const unsigned char*>(code),
      static_cast<const T*>(dx), static_cast<const T*>(dv), n_slots, nseg, seg};
  return launch_adjoint<Acc>(ray, W * H * D, grad_out, tally, n_slots, 0, stream);
}

}  // namespace anrt

// grad_out must be zero-filled (or hold a sum to add to) before the call.
// order: n_slots ray indices (thread i takes ray order[i]); ckpts: (nseg, 7,
// n_slots), column i thread i's, as K5 wrote them for the same order; c, code,
// dx, dv at the rays' own indices.  tally as for K3.  K6 runs on the global
// path at every grid size.
extern "C" int anrt_backtrace_exact(int is_double, const void* rif, int W, int H, int D,
                                    double h, double ds, const void* ckpts, const void* order,
                                    const void* c, const void* code, const void* dx,
                                    const void* dv, void* grad_out, void* tally, int n_slots,
                                    int nseg, int seg, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto o = static_cast<const int*>(order);
  auto t = static_cast<unsigned long long*>(tally);
  return is_double
             ? anrt::launch_backtrace_exact<double>(
                   anrt::VolumeRule<double>{}, rif, W, H, D, h, ds, ckpts, o, c, code, dx, dv,
                   grad_out, t, n_slots, nseg, seg, s)
             : anrt::launch_backtrace_exact<float>(
                   anrt::VolumeRule<float>{}, rif, W, H, D, h, ds, ckpts, o, c, code, dx, dv,
                   grad_out, t, n_slots, nseg, seg, s);
}

// K18: as anrt_backtrace_exact, from K15's checkpoints, with the rays' planes
// (pln_o, pln_d: (N, 3) at the rays' own indices); grad_out of the grid's type.
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
    return anrt::launch_backtrace_exact<double>(rule, rif, W, H, D, h, ds, ckpts, o, c, code,
                                                dx, dv, grad_out, t, n_slots, nseg, seg, s);
  }
  const anrt::PlaneRule<float> rule{static_cast<const float*>(pln_o),
                                    static_cast<const float*>(pln_d), nullptr};
  return anrt::launch_backtrace_exact<float>(rule, rif, W, H, D, h, ds, ckpts, o, c, code, dx,
                                             dv, grad_out, t, n_slots, nseg, seg, s);
}

// K19: as anrt_backtrace_exact, from K17's checkpoints, with the sdf grid (the
// same shape, type and spacing); grad_out is double whatever the grid's type.
extern "C" int anrt_backtrace_sdf_exact(int is_double, const void* rif, int W, int H, int D,
                                        double h, double ds, const void* sdf, const void* ckpts,
                                        const void* order, const void* c, const void* code,
                                        const void* dx, const void* dv, void* grad_out,
                                        void* tally, int n_slots, int nseg, int seg,
                                        void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto o = static_cast<const int*>(order);
  auto t = static_cast<unsigned long long*>(tally);
  if (is_double) {
    const anrt::SdfRule<double> rule{anrt::make_grid<double>(sdf, W, H, D, h)};
    return anrt::launch_backtrace_exact<double>(rule, rif, W, H, D, h, ds, ckpts, o, c, code,
                                                dx, dv, grad_out, t, n_slots, nseg, seg, s);
  }
  const anrt::SdfRule<float> rule{anrt::make_grid<float>(sdf, W, H, D, h)};
  return anrt::launch_backtrace_exact<float, double>(rule, rif, W, H, D, h, ds, ckpts, o, c,
                                                     code, dx, dv, grad_out, t, n_slots, nseg,
                                                     seg, s);
}
