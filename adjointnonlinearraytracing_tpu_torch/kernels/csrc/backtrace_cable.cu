// K8 backtrace_cable: the constant-memory adjoint sweep through the cylinder,
// one thread a ray, returning the radial-profile gradient.
//
// Replaces the XLA while_loop of the JAX package's cable adjoint
// (tracer/eikonal.py::backtrace_cable; the port's plain version is
// tracer/eikonal.py::backtrace_cable).  Order inside a step is the contract:
// x -= ds*v (unmasked); xe = x with y snapped onto a cap plane (0 or length)
// where it lies within tol*radius of one (tol 1e-9 in f64, 1e-3 in f32); n,
// grad n and the Hessian at xe, under the old active; v -= ds*n*grad n;
// active &= !escaped(xe, -v) with the new v; the splat (dn*ds, n*mu*ds) at xe
// under the new active; la += ds*(dn*grad n + n*H mu); mu += ds*la.  Start:
// la = dx, mu = dv + ds*dx, active = !escaped(xt, -vt).  The integration
// position x stays unsnapped.  An inactive ray contributes nothing, so the
// thread leaves the loop when its ray turns inactive.
//
// What bounds it on the card: the latency of each ray's chain (x, the cap
// snap, the evaluation, v), step after step.  Design (cylinder.cuh): the
// evaluation reads the block's per-bin table, divisions and square roots take
// the IEEE fast paths (div_rn, sqrt_rn), and each splat goes to the lane's own
// column of its block's gradient in shared memory (LaneColumn): no atomics
// and no branch in the step, so the adjoint update, which feeds nothing back
// into x or v, is scheduled beside the chain.  Where the columns of a block
// of kColumnThreads lanes do not fit shared memory (a profile of more than
// about 800 bins), the launch takes one gradient a block and a ray's runs
// (CableRun) instead; the caller says which (wrappers.backtrace_cable_path).
// Each block adds its gradient to device memory once.  Sums are in double,
// so the f32 gradient is held against the f64 sum of the plain version's own
// f32 terms; the order of the adds across blocks varies from run to run, so
// the result is reproducible to rounding only.
#include "cylinder.cuh"

namespace anrt {

template <typename T>
struct CableBackRay {
  Profile<T> p;
  T ds, cap;  // cap: the snap tolerance tol * radius
  const T *xt, *vt, *dx, *dv;
  int max_steps;

  template <typename Acc>
  __device__ __forceinline__ void operator()(int i, const BinEntry<T>* tab, Acc& acc) const {
    T x[3], v[3], la[3], mu[3];
    load3(xt, i, x);
    load3(vt, i, v);
    load3(dx, i, la);
    load3(dv, i, mu);
#pragma unroll
    for (int k = 0; k < 3; ++k) mu[k] = mu[k] + ds * la[k];
    bool active = !escaped(p, x, v, static_cast<T>(-1));

    for (int step = 0; step < max_steps && active; ++step) {
#pragma unroll
      for (int k = 0; k < 3; ++k) x[k] = x[k] - ds * v[k];
      T y = fabs(x[1]) <= cap ? static_cast<T>(0) : x[1];
      y = fabs(y - p.length) <= cap ? p.length : y;
      const T xe[3] = {x[0], y, x[2]};

      const FieldAt<T> f = field_at(p, tab, xe);
      T hess[3];
      hessian(f, hess);
      const T dsn = ds * f.n;
#pragma unroll
      for (int k = 0; k < 3; ++k) v[k] = v[k] - dsn * f.fx[k];
      active = !escaped(p, xe, v, static_cast<T>(-1));
      cable_adjoint_update(p, ds, f, hess, active, la, mu, acc);
    }
    acc.flush();
  }
};

template <typename T>
int launch_backtrace_cable(const void* prof, int res, double radius, double length, double ds,
                           double cap, const void* xt, const void* vt, const void* dx,
                           const void* dv, void* grad_out, int n_rays, int max_steps,
                           int columns, cudaStream_t stream) {
  const Profile<T> p = make_profile<T>(prof, res, radius, length);
  const CableBackRay<T> ray{p, static_cast<T>(ds), static_cast<T>(cap),
                            static_cast<const T*>(xt), static_cast<const T*>(vt),
                            static_cast<const T*>(dx), static_cast<const T*>(dv), max_steps};
  return launch_cable_adjoint(ray, p, grad_out, n_rays, columns != 0, stream);
}

}  // namespace anrt

// grad_out: res doubles, zero-filled (or holding a sum to add to) before the
// call.  cap: the cap-plane snap tolerance, tol * radius, rounded to T here.
// columns: 1 for a column a lane, 0 for one gradient a block and runs.
extern "C" int anrt_backtrace_cable(int is_double, const void* prof, int res, double radius,
                                    double length, double ds, double cap, const void* xt,
                                    const void* vt, const void* dx, const void* dv,
                                    void* grad_out, int n_rays, int max_steps, int columns,
                                    void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return is_double ? anrt::launch_backtrace_cable<double>(prof, res, radius, length, ds, cap, xt,
                                                          vt, dx, dv, grad_out, n_rays,
                                                          max_steps, columns, s)
                   : anrt::launch_backtrace_cable<float>(prof, res, radius, length, ds, cap, xt,
                                                         vt, dx, dv, grad_out, n_rays,
                                                         max_steps, columns, s);
}
