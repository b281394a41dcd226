// K21 slab_trace_phase and K22 slab_backtrace_phase: one phase of the z-slab
// ring (parallel/slabs.py), the forward and the adjoint sweep on the slab a
// rank holds during that phase.
//
// Replace the inner loops of the JAX package's parallel/slabs.py
// (_fwd_local's and _bwd_local's `inner`, XLA fori_loops over K steps run
// once a ring phase).  The ring splits the grid along z into one slab a rank;
// the slabs rotate one hop a phase, and a ray steps only while its cell row
// lies in the slab at hand, for at most K steps a phase; the rest of its
// steps wait for the slab they need.  Between phases each ray's state lives
// in device memory.
//
// The slab is a z-window of the grid (trilinear.cuh's Grid: voxel rows
// [z0 - 1, z0 + S) for the cell rows [z0, z0 + S), row z0 - 1 the halo of
// the previous rank), and the steps are the unsharded kernels' own:
//   * K21 steps with K2's forward_step under K2's rule (VolumeRule) or K11's
//     (PlaneRule), so a ray's state after any phase is K2's after as many
//     steps, bit for bit: a ray's step count `cnt` caps it at K2's
//     max_steps, and it stops at escape as K2 does.  A crossing writes the
//     exit state (xt, vt) at once; the caller makes the fix-up of a ray that
//     never escaped after the last phase.
//   * K22 is K3's ray on the window: x -= ds*v, the snapped xe, and a ray
//     whose xe lies in a cell row the slab does not hold stops there, before
//     it moves; the rest is K3's step, run sums and warp sums (SplatRun) into
//     the slab's gradient (the same window), with every run flushed before
//     the phase ends, since the gradient slab moves on with the slab.  It
//     takes the global path of adjoint.cuh's shell: a slab's gradient is
//     larger than shared memory at every size the ring is for.
// Both set `pending` (one word, zeroed by the caller) if a ray of theirs has
// steps left after the phase: the ring ends once no rank has one.
//
// One thread a ray, in the caller's ray order (tracer/order.py).  Bound: as
// K2 and K3, a ray's chain of dependent corner reads, and the adds of the
// splats; the ring adds the state's round trip through device memory once a
// phase (48-112 B a ray in f32) and a launch a phase.
#include "adjoint.cuh"
#include "rules.cuh"

namespace anrt {

template <typename T>
struct SlabState {  // K21's, at the rays' own indices
  T* x;
  T* v;
  T* xt;
  T* vt;
  unsigned char* inside;
  unsigned char* esc;
  int* cnt;
};

template <typename T, typename Rule>
__global__ void slab_trace_phase_kernel(Grid<T> g, T ds, const int* __restrict__ order,
                                        SlabState<T> st, Rule rule, int* __restrict__ pending,
                                        int n_rays, int max_steps, int inner) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_rays) return;
  const int i = ray_of(order, t);
  bool esc = st.esc[i];
  int cnt = st.cnt[i];
  if (esc || cnt >= max_steps) return;
  T x[3], v[3];
  load3(st.x, i, x);
  load3(st.v, i, v);
  bool inside = st.inside[i];
  typename Rule::Ray r = rule.start(i, x);
  int k = 0;
  for (; k < inner && !esc && cnt < max_steps && in_window(g, x); ++k, ++cnt) {
    const bool cur_inside = rule.inside(r, x, inside, forward_step(g, ds, x, v, inside));
    const bool cross = inside && !cur_inside;
    esc = esc || cross || escaped(g, x, v, static_cast<T>(1));
    if (rule.capture(r, x, cross)) {
      store3(st.xt, i, x);
      store3(st.vt, i, v);
    }
    inside = cur_inside;
  }
  if (k > 0) {
    store3(st.x, i, x);
    store3(st.v, i, v);
    st.inside[i] = inside;
    st.esc[i] = esc;
    st.cnt[i] = cnt;
  }
  if (!esc && cnt < max_steps) *pending = 1;
}

template <typename T>
struct SlabBacktraceRay {  // K22: K3's ray on the window, for one phase
  Grid<T> g;
  T ds, tol;
  T *x, *v, *la, *mu;
  unsigned char* active;
  int* cnt;
  const int* order;
  int* pending;
  int max_steps, inner;

  __device__ __forceinline__ void operator()(int t, T* acc, unsigned long long counts[2]) const {
    const int i = ray_of(order, t);
    bool act = active[i];
    int c = cnt[i];
    if (!act || c >= max_steps) return;
    T xs[3], vs[3], l[3], m[3];
    load3(x, i, xs);
    load3(v, i, vs);
    load3(la, i, l);
    load3(mu, i, m);
    SplatRun<T, T> run;
    int k = 0;
    for (; k < inner && act && c < max_steps; ++k, ++c) {
      T xr[3], xe[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) xr[d] = xs[d] - ds * vs[d];
      snap_to_nodes(g, xr, tol, xe);
      if (!in_window(g, xe)) break;  // waits, unmoved, for the slab that holds xe
#pragma unroll
      for (int d = 0; d < 3; ++d) xs[d] = xr[d];
      const bool emask = inbounds(g, xe);
      T n = 0, grad[3] = {0, 0, 0}, hess[3] = {0, 0, 0};
      Stencil<T> s;
      if (emask) {
        s = stencil(g, xe);
        T cv[2][2][2];
        fetch(g, s, true, cv);
        value_grad(g, cv, s.w0, n, grad);
        hessian(g, cv, s.w0, hess);
        const T dsn = ds * n;
#pragma unroll
        for (int d = 0; d < 3; ++d) vs[d] = vs[d] - dsn * grad[d];
      }
      act = !escaped(g, xe, vs, static_cast<T>(-1));
      adjoint_update(g, ds, s, n, grad, hess, act && emask, l, m, run, acc);
    }
    run.flush_if(acc, run.open);
    counts[0] += run.flushes;
    counts[1] += run.issued;
    if (k > 0) {
      store3(x, i, xs);
      store3(v, i, vs);
      store3(la, i, l);
      store3(mu, i, m);
      active[i] = act;
      cnt[i] = c;
    }
    if (act && c < max_steps) *pending = 1;
  }
};

template <typename T>
int launch_slab_trace(const void* slab, int W, int H, int D, double h, double ds, int z_first,
                      int rows, const int* order, void* x, void* v, void* xt, void* vt,
                      void* inside, void* esc, void* cnt, const void* pln_o, const void* pln_d,
                      int* pending, int n_rays, int max_steps, int inner, cudaStream_t stream) {
  if (n_rays > 0) {
    const Grid<T> g = make_grid<T>(slab, W, H, D, h, z_first, rows);
    const SlabState<T> st{static_cast<T*>(x), static_cast<T*>(v), static_cast<T*>(xt),
                          static_cast<T*>(vt),
                          static_cast<unsigned char*>(inside), static_cast<unsigned char*>(esc),
                          static_cast<int*>(cnt)};
    if (pln_o == nullptr) {
      slab_trace_phase_kernel<T, VolumeRule<T>><<<blocks_for(n_rays), kThreads, 0, stream>>>(
          g, static_cast<T>(ds), order, st, VolumeRule<T>{}, pending, n_rays, max_steps, inner);
    } else {
      const PlaneRule<T> rule{static_cast<const T*>(pln_o), static_cast<const T*>(pln_d),
                              nullptr};
      slab_trace_phase_kernel<T, PlaneRule<T>><<<blocks_for(n_rays), kThreads, 0, stream>>>(
          g, static_cast<T>(ds), order, st, rule, pending, n_rays, max_steps, inner);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_slab_backtrace(const void* slab, int W, int H, int D, double h, double ds, double tol,
                          int z_first, int rows, const int* order, void* x, void* v, void* la,
                          void* mu, void* active, void* cnt, void* gslab, int* pending,
                          int n_rays, int max_steps, int inner, cudaStream_t stream) {
  const SlabBacktraceRay<T> ray{
      make_grid<T>(slab, W, H, D, h, z_first, rows), static_cast<T>(ds), static_cast<T>(tol),
      static_cast<T*>(x), static_cast<T*>(v), static_cast<T*>(la), static_cast<T*>(mu),
      static_cast<unsigned char*>(active), static_cast<int*>(cnt), order, pending, max_steps,
      inner};
  return launch_adjoint<T>(ray, rows * H * W, gslab, nullptr, n_rays, 0, stream);
}

}  // namespace anrt

// K21: one forward phase on the slab `slab` (voxel rows [z_first, z_first +
// rows) of a (D, H, W) grid; D is the whole grid's).  x, v, xt, vt (N, 3),
// inside, esc (uint8) and cnt (int32) are the rays' state at their own
// indices, read and written in place; pln_o, pln_d: null for the volume
// rule, else the planes (N, 3) of K11's rule.  order: null, or N ray
// indices.  pending: one int32 the caller zeroed; set to 1 if a ray has steps
// left.
extern "C" int anrt_slab_trace_phase(int is_double, const void* slab, int W, int H, int D,
                                     double h, double ds, int z_first, int rows,
                                     const void* order, void* x, void* v, void* xt, void* vt,
                                     void* inside, void* esc, void* cnt, const void* pln_o,
                                     const void* pln_d, void* pending, int n_rays,
                                     int max_steps, int inner, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto o = static_cast<const int*>(order);
  auto p = static_cast<int*>(pending);
  return is_double ? anrt::launch_slab_trace<double>(slab, W, H, D, h, ds, z_first, rows, o, x,
                                                     v, xt, vt, inside, esc, cnt, pln_o, pln_d,
                                                     p, n_rays, max_steps, inner, s)
                   : anrt::launch_slab_trace<float>(slab, W, H, D, h, ds, z_first, rows, o, x,
                                                    v, xt, vt, inside, esc, cnt, pln_o, pln_d,
                                                    p, n_rays, max_steps, inner, s);
}

// K22: one adjoint phase on the slab, adding into gslab (the same window's
// rows x H x W, the slab's type).  x, v, la, mu (N, 3), active (uint8) and
// cnt (int32): the rays' state, in place; order and pending as K21's.
extern "C" int anrt_slab_backtrace_phase(int is_double, const void* slab, int W, int H, int D,
                                         double h, double ds, double tol, int z_first, int rows,
                                         const void* order, void* x, void* v, void* la,
                                         void* mu, void* active, void* cnt, void* gslab,
                                         void* pending, int n_rays, int max_steps, int inner,
                                         void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto o = static_cast<const int*>(order);
  auto p = static_cast<int*>(pending);
  return is_double
             ? anrt::launch_slab_backtrace<double>(slab, W, H, D, h, ds, tol, z_first, rows, o,
                                                   x, v, la, mu, active, cnt, gslab, p, n_rays,
                                                   max_steps, inner, s)
             : anrt::launch_slab_backtrace<float>(slab, W, H, D, h, ds, tol, z_first, rows, o,
                                                  x, v, la, mu, active, cnt, gslab, p, n_rays,
                                                  max_steps, inner, s);
}
