// K21 slab_trace_phase and K22 slab_backtrace_phase: one phase of the z-slab
// ring (parallel/slabs.py), the forward and the adjoint sweep on the slab a
// rank holds during that phase, launched a pair of z-bands of the slab at a
// time.
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
//     whose xe lies in a cell row the launch does not step in stops there,
//     before it moves; the rest is K3's step, run sums and warp sums
//     (SplatRun) into the slab's gradient (the same window), with every run
//     flushed before the launch ends.  It takes the global path of
//     adjoint.cuh's shell: a slab's gradient is larger than shared memory at
//     every size the ring is for.
//
// What bounds them on the H100: bytes beyond L2.  A slab of the grids the
// ring is for is gigabytes (1025^3 f32 at one rank: 4.3 GB; 1.08 GB a slab on
// four cards) against a 50 MB L2.  Where a phase's rays take more than one
// wave of the kernel, the later waves start when the first are far ahead,
// and one launch over the whole slab lets the rays' z positions spread over
// far more rows than L2 holds (12 rows of 1025^2 f32), so each step's
// corners, and K22's splats, come from and go to device memory: a single
// launch over the slab stepped 1.41e10 ray-steps/s at 1025^3 on an H100,
// where K2 steps 1.07e11 at 128^3, in L2.  So the caller runs such a phase
// as a sweep of z-bands (parallel/slabs.py: sweep_bands, band_height): each
// launch steps only the rays whose cell row lies in one of two windows of
// the slab (`bands`), a band going up through the slab with the rays that go
// up and one coming down with those that go down, each of as many rows as
// L2 holds, so the rays of a launch cross their band as a front whose rows
// stay in L2.  Rays that fit one wave (anrt_slab_wave) step together as one
// front already, and take one launch over the slab.  A ray
// takes the same steps in the same order as in one launch over the whole
// slab, so K21's state is the same bit for bit; the cap K is the phase's,
// counted from the step counts at its start (`start`).  Most threads of a
// launch hold rays that wait elsewhere: a gate word a thread (the cell row of
// its ray's next step) lets them leave after one coalesced read, the caller
// keeps the rays' state permuted into the ray order so that a warp's state is
// one coalesced read, and only a sweep's last launch reports its flags, one
// store a warp.  tools/slab_bands.py measures it at 1025^3 f32 (PERF.md): a
// band with every ray in it stepped 4-8e10 ray-steps/s on an H100; a store a
// thread to one flag word had cost ~65-100 us a launch, the state gathered
// through the order ~1.5x, and a sweep that went one way at a time left half
// the rays idle in every launch; registers capped for more blocks an SM, and
// asking L2 for the rows ahead of each ray, made both kernels slower.  One
// thread a ray.
//
// The stencil keeps its full index arithmetic here (trilinear.cuh,
// kOffsetIndex): with the offsets K21 took 8 fewer registers, ran more blocks
// an SM and lost 7 %.
#define ANRT_FULL_INDEX
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

// What a launch of a band sweep (parallel/slabs.py: sweep_bands) needs
// beyond the slab.
//   bands: the voxel-row windows [first, first + rows) of the slab whose cell
//          rows this launch steps rays in (two; rows 0: none).  A ray steps
//          while its cell row lies in one of them, so its stencils read, and
//          its splats add into, those rows of the slab only;
//   start: the rays' step counts at the phase's start (the cap `inner` is a
//          phase's, over all its launches), at the rays' own indices;
//   gate:  a code a thread slot: the cell row of its ray's next step (a row
//          >= 0), kSpent (its phase's steps spent) or kDone (escaped, or at
//          max_steps).  A launch reads it and leaves at once where the row is
//          not in its bands, and writes it for the rays it read; with `init`
//          it reads no code and writes every slot's (a phase's first launch);
//   flags: [pending, live], set to 1 where a ray has steps left (pending) or
//          can still step in the slab in this phase (live).  Zeroed by the
//          caller; null on a launch that reports nothing.
constexpr int kSpent = -1, kDone = -2;

struct Sweep {
  int first[2], rows[2];
  const int* start;
  int* gate;
  int* flags;
  int init;

  __device__ __forceinline__ bool holds(int cz) const {
    return holds_row(cz, first[0], rows[0]) || holds_row(cz, first[1], rows[1]);
  }
};

// Sets the sweep's flags for the lanes at this point, one store a warp.
template <typename T>
__device__ __forceinline__ void report(const Grid<T>& g, const Sweep& sw, int code) {
  if (sw.flags == nullptr) return;
  const unsigned lanes = __activemask();
  const unsigned pending = __ballot_sync(lanes, code != kDone);
  const unsigned live = __ballot_sync(lanes, holds_row(code, g.z_first, g.rows));
  if ((threadIdx.x & 31) == __ffs(lanes) - 1) {
    if (pending) sw.flags[0] = 1;
    if (live) sw.flags[1] = 1;
  }
}

// A gated launch's thread slot whose ray waits outside the bands: report it
// and leave, reading nothing of the ray.
template <typename T>
__device__ __forceinline__ bool skip_slot(const Grid<T>& g, const Sweep& sw, int t) {
  if (sw.init) return false;
  const int code = sw.gate[t];
  if (sw.holds(code)) return false;
  report(g, sw, code);
  return true;
}

template <typename T>
__device__ __forceinline__ void finish_slot(const Grid<T>& g, const Sweep& sw, int t, int code) {
  sw.gate[t] = code;
  report(g, sw, code);
}

template <typename T, typename Rule>
__global__ void slab_trace_phase_kernel(Grid<T> g, T ds, const int* __restrict__ order,
                                        SlabState<T> st, Rule rule, Sweep sw, int n_rays,
                                        int max_steps, int inner) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_rays || skip_slot(g, sw, t)) return;
  const int i = ray_of(order, t);
  bool esc = st.esc[i];
  int cnt = st.cnt[i];
  if (esc || cnt >= max_steps) {
    finish_slot(g, sw, t, kDone);
    return;
  }
  int k = cnt - __ldg(sw.start + i);
  T x[3];
  load3(st.x, i, x);
  if (k < inner && sw.holds(cell_row(g, x))) {
    T v[3];
    load3(st.v, i, v);
    bool inside = st.inside[i];
    typename Rule::Ray r = rule.start(i, x);
    for (; k < inner && !esc && cnt < max_steps && sw.holds(cell_row(g, x)); ++k, ++cnt) {
      const bool cur_inside = rule.inside(r, x, inside, forward_step(g, ds, x, v, inside));
      const bool cross = inside && !cur_inside;
      esc = esc | cross | escaped(g, x, v, static_cast<T>(1));
      if (rule.capture(r, x, cross)) {
        store3(st.xt, i, x);
        store3(st.vt, i, v);
      }
      inside = cur_inside;
    }
    store3(st.x, i, x);
    store3(st.v, i, v);
    st.inside[i] = inside;
    st.esc[i] = esc;
    st.cnt[i] = cnt;
  }
  finish_slot(g, sw, t, esc || cnt >= max_steps ? kDone : (k < inner ? cell_row(g, x) : kSpent));
}

template <typename T>
struct SlabBacktraceRay {  // K22: K3's ray on the window, for one phase or band
  Grid<T> g;
  T ds, tol;
  T *x, *v, *la, *mu;
  unsigned char* active;
  int* cnt;
  const int* order;
  Sweep sw;
  int max_steps, inner;

  // the snapped position of the ray's next step, and its cell row
  __device__ __forceinline__ int next_row(const T xs[3], const T vs[3], T xr[3],
                                          T xe[3]) const {
#pragma unroll
    for (int d = 0; d < 3; ++d) xr[d] = xs[d] - ds * vs[d];
    snap_to_nodes(g, xr, tol, xe);
    return cell_row(g, xe);
  }

  __device__ __forceinline__ void operator()(int t, T* acc, unsigned long long counts[2]) const {
    if (skip_slot(g, sw, t)) return;
    const int i = ray_of(order, t);
    bool act = active[i];
    int c = cnt[i];
    if (!act || c >= max_steps) {
      finish_slot(g, sw, t, kDone);
      return;
    }
    int k = c - __ldg(sw.start + i);
    if (k >= inner) {
      finish_slot(g, sw, t, kSpent);
      return;
    }
    T xs[3], vs[3], xr[3], xe[3];
    load3(x, i, xs);
    load3(v, i, vs);
    int row = next_row(xs, vs, xr, xe);
    if (sw.holds(row)) {
      T l[3], m[3];
      load3(la, i, l);
      load3(mu, i, m);
      SplatRun<T, T> run;
      for (; k < inner && act && c < max_steps; ++k, ++c) {
        row = next_row(xs, vs, xr, xe);
        if (!sw.holds(row)) break;  // waits, unmoved, for its rows
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
      store3(x, i, xs);
      store3(v, i, vs);
      store3(la, i, l);
      store3(mu, i, m);
      active[i] = act;
      cnt[i] = c;
    }
    finish_slot(g, sw, t, !act || c >= max_steps ? kDone : (k < inner ? row : kSpent));
  }
};

template <typename T>
int launch_slab_trace(const void* slab, int W, int H, int D, double h, double ds, int z_first,
                      int rows, const int* order, void* x, void* v, void* xt, void* vt,
                      void* inside, void* esc, void* cnt, const void* pln_o, const void* pln_d,
                      const Sweep& sw, int n_rays, int max_steps, int inner,
                      cudaStream_t stream) {
  if (n_rays > 0) {
    const Grid<T> g = make_grid<T>(slab, W, H, D, h, z_first, rows);
    const SlabState<T> st{static_cast<T*>(x), static_cast<T*>(v), static_cast<T*>(xt),
                          static_cast<T*>(vt),
                          static_cast<unsigned char*>(inside), static_cast<unsigned char*>(esc),
                          static_cast<int*>(cnt)};
    if (pln_o == nullptr) {
      slab_trace_phase_kernel<T, VolumeRule<T>><<<blocks_for(n_rays), kThreads, 0, stream>>>(
          g, static_cast<T>(ds), order, st, VolumeRule<T>{}, sw, n_rays, max_steps, inner);
    } else {
      const PlaneRule<T> rule{static_cast<const T*>(pln_o), static_cast<const T*>(pln_d),
                              nullptr};
      slab_trace_phase_kernel<T, PlaneRule<T>><<<blocks_for(n_rays), kThreads, 0, stream>>>(
          g, static_cast<T>(ds), order, st, rule, sw, n_rays, max_steps, inner);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_slab_backtrace(const void* slab, int W, int H, int D, double h, double ds, double tol,
                          int z_first, int rows, const int* order, void* x, void* v, void* la,
                          void* mu, void* active, void* cnt, void* gslab, const Sweep& sw,
                          int n_rays, int max_steps, int inner, cudaStream_t stream) {
  const SlabBacktraceRay<T> ray{
      make_grid<T>(slab, W, H, D, h, z_first, rows), static_cast<T>(ds), static_cast<T>(tol),
      static_cast<T*>(x), static_cast<T*>(v), static_cast<T*>(la), static_cast<T*>(mu),
      static_cast<unsigned char*>(active), static_cast<int*>(cnt), order, sw, max_steps,
      inner};
  return launch_adjoint<T>(ray, rows * H * W, gslab, nullptr, n_rays, 0, stream);
}

// The rays one wave of a kernel holds on the current card: the blocks an SM
// runs at once at its occupancy, times the SMs, times the threads a block.
template <typename Kernel>
int wave_rays(Kernel kernel, int* rays) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  *rays = per_sm * sms * kThreads;
  return static_cast<int>(err);
}

template <typename T>
int slab_wave(int backward, int plane, int* rays) {
  if (backward) return wave_rays(adjoint_kernel<T, false, SlabBacktraceRay<T>>, rays);
  if (plane) return wave_rays(slab_trace_phase_kernel<T, PlaneRule<T>>, rays);
  return wave_rays(slab_trace_phase_kernel<T, VolumeRule<T>>, rays);
}

}  // namespace anrt

// The rays one wave of K21 (backward 0; plane: K11's rule) or K22 (backward
// 1) holds on the current card, into *rays: a phase whose rays all fit one
// wave steps them together, so they cross the slab as one front.
extern "C" int anrt_slab_wave(int is_double, int backward, int plane, int* rays) {
  return is_double ? anrt::slab_wave<double>(backward, plane, rays)
                   : anrt::slab_wave<float>(backward, plane, rays);
}

// K21: one forward phase, or one band of a phase's sweep, on the slab `slab`
// (voxel rows [z_first, z_first + rows) of a (D, H, W) grid; D is the whole
// grid's).  x, v, xt, vt (N, 3), inside, esc (uint8) and cnt (int32) are the
// rays' state at their own indices, read and written in place; pln_o, pln_d:
// null for the volume rule, else the planes (N, 3) of K11's rule.  order:
// null, or N ray indices.  start, gate, flags, init and the two windows
// (first0, rows0), (first1, rows1): anrt::Sweep's (flags may be null:
// without it nothing is reported).
extern "C" int anrt_slab_trace_phase(int is_double, const void* slab, int W, int H, int D,
                                     double h, double ds, int z_first, int rows,
                                     const void* order, void* x, void* v, void* xt, void* vt,
                                     void* inside, void* esc, void* cnt, const void* pln_o,
                                     const void* pln_d, const void* start, void* gate,
                                     void* flags, int init, int first0, int rows0, int first1,
                                     int rows1, int n_rays, int max_steps, int inner,
                                     void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto o = static_cast<const int*>(order);
  const anrt::Sweep sw{{first0, first1}, {rows0, rows1}, static_cast<const int*>(start),
                       static_cast<int*>(gate), static_cast<int*>(flags), init};
  return is_double ? anrt::launch_slab_trace<double>(slab, W, H, D, h, ds, z_first, rows, o, x,
                                                     v, xt, vt, inside, esc, cnt, pln_o, pln_d,
                                                     sw, n_rays, max_steps, inner, s)
                   : anrt::launch_slab_trace<float>(slab, W, H, D, h, ds, z_first, rows, o, x,
                                                    v, xt, vt, inside, esc, cnt, pln_o, pln_d,
                                                    sw, n_rays, max_steps, inner, s);
}

// K22: one adjoint phase, or one band of a phase's sweep, on the slab, adding
// into gslab (the same window's rows x H x W, the slab's type).  x, v, la, mu
// (N, 3), active (uint8) and cnt (int32): the rays' state, in place; order
// and the sweep's arguments as K21's.
extern "C" int anrt_slab_backtrace_phase(int is_double, const void* slab, int W, int H, int D,
                                         double h, double ds, double tol, int z_first, int rows,
                                         const void* order, void* x, void* v, void* la,
                                         void* mu, void* active, void* cnt, void* gslab,
                                         const void* start, void* gate, void* flags, int init,
                                         int first0, int rows0, int first1, int rows1,
                                         int n_rays, int max_steps, int inner, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto o = static_cast<const int*>(order);
  const anrt::Sweep sw{{first0, first1}, {rows0, rows1}, static_cast<const int*>(start),
                       static_cast<int*>(gate), static_cast<int*>(flags), init};
  return is_double
             ? anrt::launch_slab_backtrace<double>(slab, W, H, D, h, ds, tol, z_first, rows, o,
                                                   x, v, la, mu, active, cnt, gslab, sw, n_rays,
                                                   max_steps, inner, s)
             : anrt::launch_slab_backtrace<float>(slab, W, H, D, h, ds, tol, z_first, rows, o,
                                                  x, v, la, mu, active, cnt, gslab, sw, n_rays,
                                                  max_steps, inner, s);
}
