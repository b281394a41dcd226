// K3 backtrace: constant-memory adjoint sweep, one thread per ray at a time,
// splats summed per ray and cell in registers, then added into a gradient in
// shared memory (grids that fit) or straight into the flat (D*H*W) gradient.
//
// Replaces the XLA while_loop of the JAX package's adjoint sweep
// (tracer/paired.py::backtrace, same numbers as tracer/eikonal.py::backtrace).
// Order inside a step is the contract: x -= ds*v; xe = snap_to_nodes(x);
// emask = active & inbounds(xe); n, grad n, hess at xe under emask;
// v -= ds*n*grad n; active &= !escaped(xe, -v) with the new v; splat
// (dn*ds, n*mu*ds) at xe under the updated active & emask;
// la += ds*(dn*grad n + n*H mu); mu += ds*la.  Start: la = dx,
// mu = dv + ds*dx, active = !escaped(xt, -vt).  The integration position x
// stays unsnapped.  Leaving the loop at !active is exact: an inactive ray
// contributes nothing.
//
// What bounds it on the card: ~320 flops a ray-step (161 would do) and the
// adds of the splat.  Float atomics on one address serialise, and every
// stage of the fuel trainer splats ~2.5e8 terms (ds is fixed by the finest
// grid), onto 27 words at 3^3.  The design removes the adds four ways:
//   * a ray keeps the 8 sums of the cell it is in (SplatRun) and adds them
//     when it leaves the cell: one add a corner per run of h/ds steps or so
//     (64 at 3^3, 2 at 65^3 and on the bench scene);
//   * lanes of a warp that flush runs into the same cell at the same step
//     sum them with shuffles first (__match_any_sync on the stencil), and one
//     lane issues the adds; an H100 measured this before keeping it, because
//     with the other three alone the global adds still cost 40-50 % of K3's
//     time at 65^3 and on the bench scene;
//   * where the D*H*W gradient fits a block's shared memory, persistent
//     blocks flush runs into a block-private gradient and add it to device
//     memory once (adjoint.cuh, K3's kernel shell);
//   * the caller may give the rays in a coherent order (thread i takes ray
//     order[i], tracer/order.py), so the lanes of a warp flush into the same
//     or neighbouring words.
// What is left is the arithmetic on the shared path, and on the global path
// about as much again for the adds.  The order of the adds varies from run
// to run, so the gradient is reproducible to rounding only, not bitwise.
//
// K14 backtrace_sdf is the same ray with the sdf rule (kSdf), replacing the
// JAX package's tracer/paired.py::backtrace_sdf (the numbers of
// tracer/eikonal.py::backtrace_sdf): a second state `outside`, at the start
// sdf(xt) >= 0 (unsnapped, read where the ray is active); each step reads the
// sdf at the snapped xe (unmasked: active holds inside the loop) after the v
// update, and after active &= !escaped(xe, -v) a ray that was inside and
// reads sdf >= 0 turns inactive; outside = (sdf >= 0); the splat is masked by
// the new active, as K3's.  The rest is K3's, paths and order included, but
// for two things:
//   * one stencil a step for both grids (the sdf lies on the grid's
//     lattice), the grid's corners (under the eval mask) and the sdf's
//     loaded together before either is used: one trip to L2 a step;
//   * the adds in double, into a double gradient (shared or global; the
//     caller casts), and the run and warp sums in the grid's type.  On its
//     bench scene (2^18 rays spawned on a sphere sdf, all crossing its
//     centre) f32 adds lay 1.06e-5 of the largest entry from the f64 sum of
//     the same terms (an H100; the plain version's own f32 sum 1.9e-4),
//     over the 1e-5 limit: ~10^5 terms of both signs a voxel.  A run sums a
//     few steps' terms, so f32 costs it nothing measurable, as K19 found
//     (backtrace_exact.cu).
#include "adjoint.cuh"

namespace anrt {

// One ray of the sweep; adds to counts the runs it flushed and the flushes it
// issued (8 atomic adds each) for its group of lanes.  kSdf: K14's rule, with
// the sdf grid `sdf` (unused by K3); Acc: the type of the adds (T for K3,
// double for K14); Sum: that of the run and warp sums (SplatRun).
template <typename T, bool kSdf, typename Acc, typename Sum>
struct BacktraceRay {
  Grid<T> g;
  Grid<T> sdf;
  T ds, tol;
  const T *xt, *vt, *dx, *dv;
  const int* order;
  int max_steps;

  __device__ __forceinline__ void operator()(int i, Acc* acc,
                                             unsigned long long counts[2]) const {
    const int r = ray_of(order, i);
    T x[3], v[3], la[3], mu[3];
    load3(xt, r, x);
    load3(vt, r, v);
    load3(dx, r, la);
    load3(dv, r, mu);
#pragma unroll
    for (int k = 0; k < 3; ++k) mu[k] = mu[k] + ds * la[k];
    bool active = !escaped(g, x, v, static_cast<T>(-1));
    bool outside = true;  // a masked read gives 0, and 0 >= 0
    if (kSdf && active) outside = value_at(sdf, x) >= static_cast<T>(0);
    SplatRun<T, Acc, Sum> run;

    for (int step = 0; step < max_steps && active; ++step) {
#pragma unroll
      for (int k = 0; k < 3; ++k) x[k] = x[k] - ds * v[k];
      T xe[3];
      snap_to_nodes(g, x, tol, xe);
      const bool emask = inbounds(g, xe);  // active holds inside the loop

      T n = 0, grad[3] = {0, 0, 0}, hess[3] = {0, 0, 0}, dist = 0;
      Stencil<T> s;
      if constexpr (kSdf) {  // one stencil, both corner sets loaded before either is used
        s = stencil(g, xe);
        T c[2][2][2], cs[2][2][2], sg[3];
        fetch(g, s, emask, c);
        fetch(sdf, s, true, cs);
        if (emask) evaluate(s, c, n, grad, hess, v);
        value_grad(sdf, cs, s.w0, dist, sg);  // its gradient is dropped
      } else if (emask) {
        s = stencil(g, xe);
        T c[2][2][2];
        fetch(g, s, true, c);
        evaluate(s, c, n, grad, hess, v);
      }
      active = !escaped(g, xe, v, static_cast<T>(-1));
      if (kSdf) {
        const bool out = dist >= static_cast<T>(0);
        active = active && (outside || !out);
        outside = out;
      }
      adjoint_update(g, ds, s, n, grad, hess, active && emask, la, mu, run, acc);
    }
    run.flush_if(acc, run.open);
    counts[0] += run.flushes;
    counts[1] += run.issued;
  }

  // n, grad n and the Hessian at the stencil s from its corners c, and
  // v -= ds*n*grad n
  __device__ __forceinline__ void evaluate(const Stencil<T>& s, const T c[2][2][2], T& n,
                                           T grad[3], T hess[3], T v[3]) const {
    value_grad(g, c, s.w0, n, grad);
    hessian(g, c, s.w0, hess);
    const T dsn = ds * n;
#pragma unroll
    for (int k = 0; k < 3; ++k) v[k] = v[k] - dsn * grad[k];
  }
};

// sdf: null for K3, the sdf grid (same shape and spacing) for K14; grad_out
// holds Acc.
template <typename T, bool kSdf, typename Acc, typename Sum>
int launch_backtrace(const void* rif, const void* sdf, int W, int H, int D, double h,
                     double ds, double tol, const void* xt, const void* vt, const void* dx,
                     const void* dv, const int* order, void* grad_out,
                     unsigned long long* tally, int n_rays, int max_steps, int use_shared,
                     cudaStream_t stream) {
  const BacktraceRay<T, kSdf, Acc, Sum> ray{
      make_grid<T>(rif, W, H, D, h), make_grid<T>(sdf, W, H, D, h), static_cast<T>(ds),
      static_cast<T>(tol), static_cast<const T*>(xt), static_cast<const T*>(vt),
      static_cast<const T*>(dx), static_cast<const T*>(dv), order, max_steps};
  return launch_adjoint<Acc>(ray, W * H * D, grad_out, tally, n_rays, use_shared, stream);
}
}  // namespace anrt

// grad_out must be zero-filled (or hold a sum to add to) before the call.
// order: null, or n_rays ray indices (thread i takes ray order[i]).
// use_shared: 1 for the block-private gradient in shared memory (the grid's
// D*H*W elements must fit kSharedMax bytes, or the call returns an error), 0
// for runs added straight to grad_out.  tally: null, or three zeroed 64-bit
// counters (runs flushed, flushes issued, shared-path adds into grad_out) for
// a check.
extern "C" int anrt_backtrace(int is_double, const void* rif, int W, int H, int D, double h,
                              double ds, double tol, const void* xt, const void* vt,
                              const void* dx, const void* dv, const void* order,
                              void* grad_out, void* tally, int n_rays, int max_steps,
                              int use_shared, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto o = static_cast<const int*>(order);
  auto t = static_cast<unsigned long long*>(tally);
  if (is_double)
    return anrt::launch_backtrace<double, false, double, double>(
        rif, nullptr, W, H, D, h, ds, tol, xt, vt, dx, dv, o, grad_out, t, n_rays, max_steps,
        use_shared, s);
  return anrt::launch_backtrace<float, false, float, float>(rif, nullptr, W, H, D, h, ds, tol, xt,
                                                            vt, dx, dv, o, grad_out, t, n_rays,
                                                            max_steps, use_shared, s);
}

// K14: as anrt_backtrace, with the sdf grid (the same shape, type and
// spacing); grad_out is double whatever the grid's type (use_shared: its
// D*H*W doubles must fit kSharedMax bytes); the run and warp sums in the
// grid's type.
extern "C" int anrt_backtrace_sdf(int is_double, const void* rif, int W, int H, int D,
                                  double h, double ds, double tol, const void* sdf,
                                  const void* xt, const void* vt, const void* dx,
                                  const void* dv, const void* order, void* grad_out,
                                  void* tally, int n_rays, int max_steps, int use_shared,
                                  void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto o = static_cast<const int*>(order);
  auto t = static_cast<unsigned long long*>(tally);
  if (is_double)
    return anrt::launch_backtrace<double, true, double, double>(
        rif, sdf, W, H, D, h, ds, tol, xt, vt, dx, dv, o, grad_out, t, n_rays, max_steps,
        use_shared, s);
  return anrt::launch_backtrace<float, true, double, float>(rif, sdf, W, H, D, h, ds, tol, xt, vt,
                                                            dx, dv, o, grad_out, t, n_rays,
                                                            max_steps, use_shared, s);
}
