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
#include "adjoint.cuh"

namespace anrt {

// the replay buffer's length in steps; a segment of up to kReplay steps is
// replayed once
constexpr int kReplay = 32;

// One ray of the backward pass.  The lanes of a warp walk the segments and
// the steps in step with each other: segment s of every lane at once (from
// the warp's last segment down, a lane idle in the segments past its own last
// one), and step j of a segment at once (a lane idle in the steps past its
// capture step), so that lanes whose rays are neighbours in the ray order are
// at neighbouring positions at every step.
template <typename T>
struct ExactRay {
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
          for (int j = 0; j < b0; ++j) inside = forward_step(g, ds, x, v, inside);
        }
        unsigned ins = 0u;  // bit j: inside at the stretch's step j
        for (int j = 0; j < nb_warp; ++j) {
          if (j < nb) {
#pragma unroll
            for (int k = 0; k < 3; ++k) xs[j][k] = x[k];
            if (inside) ins |= 1u << j;
            inside = forward_step(g, ds, x, v, inside);
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

template <typename T>
int launch_backtrace_exact(const void* rif, int W, int H, int D, double h, double ds,
                           const void* ckpts, const int* order, const void* c,
                           const void* code, const void* dx, const void* dv, void* grad_out,
                           unsigned long long* tally, int n_slots, int nseg, int seg,
                           cudaStream_t stream) {
  const ExactRay<T> ray{
      make_grid<T>(rif, W, H, D, h), static_cast<T>(ds), static_cast<const T*>(ckpts), order,
      static_cast<const int*>(c), static_cast<const unsigned char*>(code),
      static_cast<const T*>(dx), static_cast<const T*>(dv), n_slots, nseg, seg};
  return launch_adjoint<T>(ray, W * H * D, grad_out, tally, n_slots, 0, stream);
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
  return is_double ? anrt::launch_backtrace_exact<double>(rif, W, H, D, h, ds, ckpts, o, c, code,
                                                          dx, dv, grad_out, t, n_slots, nseg,
                                                          seg, s)
                   : anrt::launch_backtrace_exact<float>(rif, W, H, D, h, ds, ckpts, o, c, code,
                                                         dx, dv, grad_out, t, n_slots, nseg, seg,
                                                         s);
}
