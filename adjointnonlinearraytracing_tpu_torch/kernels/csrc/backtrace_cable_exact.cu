// K10 backtrace_cable_exact: the backward pass of the exact cable gradient,
// one thread a ray.
//
// Replaces the segment replay of the JAX package's checkpointed cable adjoint
// (tracer/checkpointed.py::_bwd_segments_cable; the port's plain version is
// tracer/checkpointed.py::_bwd_segments_cable).  Per ray, from the checkpoints
// K9 wrote (trace_cable.cu): for each segment that starts before the ray's
// capture step c, last to first, replay the segment forward from its
// checkpoint (x, v, esc) with the forward's own step (cylinder.cuh
// cable_step), so every position is the forward's bit for bit; then, over the
// replayed positions in reverse, the evaluation at x_k (n, grad n, Hessian)
// and the adjoint update (splat into the ray's run, la/mu recursion), gated by
// (k < c) & active_k.  Steps k >= c are not run, which also skips every
// segment at or past max(c); start la = dx, mu = dv + ds*dx.  A lane is
// active at every step below its capture step (a frozen lane's distance no
// longer drops), so the gate is k < c; the replay still carries esc as the
// plain version does.
//
// What bounds it on the card: the latency of the replayed and the adjoint
// steps of a ray, as K7's and K8's (cylinder.cuh: the per-bin table and the
// IEEE fast paths of K7 and K8; the splats as runs summed in double in
// registers into a block-private gradient in shared memory).
// The replayed positions of a stretch of at most kReplay steps live in the
// thread's local memory (12 B a step in f32), written once and read once; a
// segment longer than kReplay is replayed in stretches, the later first, each
// from the segment's checkpoint, as K6 does.  The lanes of a warp walk the
// segments and steps in step, as K6's do: on an H100 the first design, each
// lane from its own last segment, ran 10.2 ms against K8's 1.0 ms at 129 bins
// (its lanes drifted out of phase and issued apart; PERF.md).
#include "cylinder.cuh"

namespace anrt {

constexpr int kCableReplay = 32;

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
struct CableExactRay {
  Profile<T> p;
  T ds;
  const T* ckpts;  // (nseg, 7, n_rays)
  const int* c;
  const T *dx, *dv;
  int n_rays, nseg, seg;

  template <typename Acc>
  __device__ __forceinline__ void operator()(int i, const BinEntry<T>* tab, Acc& run) const {
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
  }
};

template <typename T>
int launch_backtrace_cable_exact(const void* prof, int res, double radius, double length,
                                 double ds, const void* ckpts, const void* c, const void* dx,
                                 const void* dv, void* grad_out, int n_rays, int nseg, int seg,
                                 cudaStream_t stream) {
  const Profile<T> p = make_profile<T>(prof, res, radius, length);
  const CableExactRay<T> ray{p, static_cast<T>(ds),
                             static_cast<const T*>(ckpts), static_cast<const int*>(c),
                             static_cast<const T*>(dx), static_cast<const T*>(dv), n_rays,
                             nseg, seg};
  return launch_cable_adjoint(ray, p, grad_out, n_rays, false, stream);
}

}  // namespace anrt

// grad_out: res doubles, zero-filled (or holding a sum to add to) before the
// call.  ckpts: (nseg, 7, n_rays) as K9 wrote them for the same rays; c
// (int32), dx, dv (3 per ray) at the rays' indices.
extern "C" int anrt_backtrace_cable_exact(int is_double, const void* prof, int res,
                                          double radius, double length, double ds,
                                          const void* ckpts, const void* c, const void* dx,
                                          const void* dv, void* grad_out, int n_rays, int nseg,
                                          int seg, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return is_double ? anrt::launch_backtrace_cable_exact<double>(prof, res, radius, length, ds,
                                                                ckpts, c, dx, dv, grad_out,
                                                                n_rays, nseg, seg, s)
                   : anrt::launch_backtrace_cable_exact<float>(prof, res, radius, length, ds,
                                                               ckpts, c, dx, dv, grad_out,
                                                               n_rays, nseg, seg, s);
}
