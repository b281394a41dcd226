// K2 trace_fwd: forward eikonal stepper, one thread per ray, the whole step
// loop inside the kernel, ray state in registers, per-ray early exit.
//
// Replaces the XLA while_loop of the JAX package's forward stepper
// (tracer/paired.py::trace, same numbers as tracer/eikonal.py::trace).
// Semantics per step: eval masked by the previous position's inbounds;
// v += ds*n*grad n; x += ds*v; cross = inside & !inbounds(x);
// esc |= cross | escaped(x, v); (xt, vt) captured at cross only.  After the
// loop xt = esc ? xt : x and vt is left as captured (v0 if never crossed).
// Leaving the loop at esc is exact: an escaped ray is outside and moving away
// on some axis, sees n = 0, goes straight and never crosses again.
//
// Bound by operations: the grid (8.4 MB at 128^3 f32) stays in L2, each ray
// reads 24 B and writes 24 B once, and does ~100 flops per step (58 would
// do) for a few hundred steps.  Design: no per-step launch and no state in
// device memory.  What holds it back on the card is how many distinct L1/L2
// lines a warp's 8 corner reads touch each step: 8 x 32 when its rays are
// strangers (the bench scene draws entry points at random), a few when they
// are neighbours.  So the caller may pass an order (tracer/order.py: entry
// cell in Z-order): thread i takes ray order[i], reads x0[order[i]] and
// writes xt[order[i]], so the outputs stay in the caller's order and each
// ray's arithmetic, and so its result, is the same bit for bit.  With it an
// H100 runs ~1e11 ray-steps/s on coherent and on randomly drawn rays alike,
// still under a tenth of the operation bound: each step's corner reads wait
// on the position the step before computed, and that chain of cache hits a
// ray is what is left (not measured apart).
//
// K5 trace_ckpt is the same loop compiled with kCkpt: the forward pass of the
// exact gradient (tracer/checkpointed.py, replacing the segmented XLA
// forward of the JAX package's tracer/checkpointed.py::_forward_with_ckpts).
// It also writes, for each ray, (x, v, inside) at the start of every
// segment of seg steps that it begins before it escapes (rows of later
// segments are never read: the backward pass stops at the capture step),
// the capture step c (max_steps if it never crossed out) and a code: 0 never
// escaped, 1 captured, 2 escaped without ever being inside (nothing to
// differentiate).  The checkpoints are laid out (nseg, 7, n_rays), field k of
// thread i at [s][k][i], so a warp's store of one field is one 128-byte line,
// stored evict-first at the head of each segment by a loop over segments
// around the step loop (step_with_rows); the exit state is K2's bit for bit.
// The extra bytes are 28 a ray and segment in f32, a few per cent of a
// step's work.  A cache of the current cell's 8 corner values (read once a
// cell, not once a step) took 2-3 % off at the fuel trainer's coarse stages
// and added as much at the fine ones and on the bench scene (8 more
// registers), so K5 reads them at every step, as K2 does (PERF.md keeps the
// numbers; the design tool that measured them is in git).
//
// K11 trace_plane, K12 trace_target and K13 trace_sdf are the same loop under
// another stop and capture rule (a `Rule`, below), replacing the variants of
// the JAX package's paired stepper (tracer/paired.py::trace_plane,
// ::trace_target, ::trace_sdf; the same numbers as tracer/eikonal.py's
// functions of those names):
//   * K11 (PlaneRule): "inside" is inbounds and not past the ray's plane
//     ((x - o) . d > 0); outputs (xt, vt) as K2's and miss = !esc.  Leaving
//     the loop at esc is exact as for K2: an escaped ray is past its plane
//     moving on, or outside the grid moving away.
//   * K12 (TargetRule): the closest approach to the ray's target, captured
//     at every step the squared distance drops; d2 out; no fix-up.  Here an
//     escaped ray does NOT stop: the JAX loop runs until every ray of the
//     batch has escaped, and an escaped ray goes on straight (its eval is
//     masked) and is still captured when it gets closer.  So the kernel runs
//     in two launches: pass 1 (trace_fwd_kernel) steps each ray to its escape
//     as K2 does, saves its state and takes the batch's last escape step S
//     into one word (a warp's max, then atomicMax); pass 2
//     (trace_horizon_kernel) steps each escaped ray on to S, step by step
//     with the same step (so the rounding is the plain version's, not a
//     closed form), capturing as before.  Pass 2's steps are straight lines:
//     6 + 8 flops a step and no grid read.  A ray stops before S once every
//     axis recedes from its target or stands still (TargetRule::continues):
//     no later step can then come strictly closer, so its outputs are final.
//   * K13 (SdfRule): "inside" at the new x is sdf < 0, the sdf read under the
//     previous inside (an outside ray reads 0 and stays outside); escape is
//     tested on the grid; no fix-up.  A step takes one stencil (rules.cuh,
//     sdf_step): the sdf's corners at the new x and the grid's that the next
//     step evaluates at the same point are loaded together, one trip to L2
//     a step as K2 makes, not two in turn with a stencil each, and from one
//     grid of node pairs (rif, sdf) that the wrapper packs at each call
//     (kSdfPacked): a corner of both is one 8-byte load at one address.  A
//     ray that escaped the grid while still inside the sdf (clamped corners can read
//     sdf < 0 outside the grid) may cross later, while the batch runs, so
//     K13 takes K12's two passes, and pass 2 steps only those rays, each
//     until it leaves the sdf (after that nothing of it can change) or S.
// The horizon costs K12 and K13 a second launch and 60 B (f32) of state a
// ray in device memory between them; the launch is cheap where no ray
// continues (K13 on most scenes).  The rules live in rules.cuh, which the
// exact gradient's backward pass (backtrace_exact.cu) shares.
//
// K15 trace_plane_ckpt, K16 trace_target_ckpt and K17 trace_sdf_ckpt are the
// forward passes of the variants' exact gradients (the JAX package's
// tracer/checkpointed.py::_forward_with_ckpts under the plane, target and
// sdf hooks of _make_volume_variant): K11-K13 compiled with kCkpt, writing
// K5's checkpoints (x, v, inside) at every segment start the ray steps
// through, its capture step c (c0: max_steps for the plane, 0 for the target
// and the sdf) and K5's code.  The exact forward differs from K12 and K13 in
// its horizon, and pass 2 writes the checkpoints of the steps it takes, so
// that the backward pass can replay a capture made after the ray escaped:
//   * K16: the batch's last escape step, as K12 (the JAX per-step gate
//     ~all(esc), or the whole batch's stop step when it is chunked); the
//     backward pass of a chunk recomputes its checkpoints with `last` set to
//     the batch's beforehand (pass 1's atomicMax then leaves it).  A ray
//     stops where K12's does: its capture step is then final, and the rows
//     after it, which it no longer writes, are rows the backward pass never
//     reads (it reads those below the capture step);
//   * K17: per ray, the first segment boundary at or after the last escape
//     of the ray's chunk of the JAX package's ray chunks (the whole batch
//     unchunked; the padded last chunk holds copies of ray 0), capped at
//     max_steps: the JAX forward skips a segment only once every ray of its
//     chunk has escaped, and steps on to the segment's end.  Pass 1 takes
//     each chunk's last escape into a word of its own (`last`: the lanes of
//     a warp whose rays share a chunk take their maximum, one atomicMax; the
//     thread of ray 0 also into the padded last chunk's word), and pass 2
//     rounds the word of its ray's chunk up to `seg`, caps it and writes it
//     out (`hor_out`), so that no launch runs between the passes.  A chunk of
//     the rays (the backward pass recomputing its checkpoints) takes the
//     horizons of the whole batch instead (`hor`).
// K15 takes K11's one pass: an escaped plane ray never crosses again, so it
// has nothing left to capture or checkpoint.
#include "rules.cuh"

namespace anrt {

// The state pass 1 of a horizon rule leaves for pass 2, at the thread's slot:
// x, v (3 each), the steps taken, inside.  `last`: the last escape step of
// the batch (one word; chunk 0), or of each chunk of `chunk` rays by ray
// index (the last chunk padded with copies of ray 0; K17), zeroed by the
// caller or set to a batch's beforehand.  Pass 2 steps a ray
// to `hor` at its index where given (K17 on a chunk of the rays), else to
// its word of `last` rounded up to a multiple of `round` and capped at `cap`
// (K12, K13, K16: round 1, no cap), written to `hor_out` where given.
template <typename T>
struct Horizon {
  T* x;
  T* v;
  int* steps;
  unsigned char* inside;
  int* last;
  const int* hor;
  int* hor_out;
  int chunk;     // rays a word of `last` (0: one word)
  int pad_word;  // the word of the last chunk where copies of ray 0 pad it, else -1
  int round, cap;

  __device__ __forceinline__ int word(int i) const { return chunk > 0 ? i / chunk : 0; }
  // the step pass 2 takes ray i to, written to hor_out where given
  __device__ __forceinline__ int take(int i) const {
    if (hor != nullptr) return __ldg(hor + i);
    const int l = last[word(i)];
    const int up = (l + round - 1) / round * round;
    const int h = up < cap ? up : cap;
    if (hor_out != nullptr) hor_out[i] = h;
    return h;
  }
};

// Pass 1's escape step of ray i into its word of hz.last (called by every
// lane of the warp that has a ray): the lanes whose rays share a word take
// their maximum and one of them adds it; ray 0 also goes into the padded
// last chunk's word.
template <typename T>
__device__ __forceinline__ void take_last(const Horizon<T>& hz, int i, int step) {
  const unsigned lanes = __activemask();
  const int w = hz.word(i);
  const unsigned peers = __match_any_sync(lanes, w);
  const int last = __reduce_max_sync(peers, step);
  if ((threadIdx.x & 31) == __ffs(peers) - 1) atomicMax(hz.last + w, last);
  if (i == 0 && hz.pad_word >= 0) atomicMax(hz.last + hz.pad_word, step);
}

// How the forward loop stores its checkpoint rows and what it reports of
// itself.  The rows are stored evict-first (__stcs): no pass reads them
// back, and the 8.4 MB grid the steps read stays in L1 and L2.
// tools/fwd_designs.cu derives the designs it measures from this one (plain
// stores, clock64() cycles a ray).
struct FwdLoop {
  template <typename T>
  static __device__ __forceinline__ void store(T* p, T v) { __stcs(p, v); }
  static __device__ __forceinline__ long long clock_start() { return 0; }
  // slot t took `steps` steps since clock_start() read t0
  static __device__ __forceinline__ void clock_stop(int, long long, int) {}
  // K20: whether each record is stored (a design stores the last one only)
  static constexpr bool kRecords = true;
};

// The checkpoint (x, v, inside) of one ray: field k at ck[k * field].
template <typename Opt, typename T>
__device__ __forceinline__ void store_ckpt(T* ck, size_t field, const T x[3], const T v[3],
                                           bool inside) {
  const T row[7] = {x[0], x[1], x[2], v[0], v[1], v[2], static_cast<T>(inside ? 1 : 0)};
#pragma unroll
  for (int k = 0; k < 7; ++k) Opt::store(ck + k * field, row[k]);
}

// The steps [step, last) of one ray while go(step) holds; body(step) takes
// one step.  With kRows, the checkpoint row of each segment of seg steps is
// stored at its head (ck: the column of the first head at or after `step`,
// null for none) by a loop over segments around a loop of at most seg
// steps, so that no row counter or test stays in the step loop (a countdown
// to the next row in the step loop took 3.6 % longer, PERF.md).  Returns
// the step it stopped at.
template <bool kRows, typename Opt, typename T, typename Go, typename Body>
__device__ __forceinline__ int step_with_rows(int step, int last, int seg, T* ck, size_t field,
                                              const T x[3], const T v[3], const bool& inside,
                                              Go go, Body body) {
  if constexpr (kRows) {
    int end = (step + seg - 1) / seg * seg;  // the first head at or after step
    while (true) {
      if (end > last) end = last;
      for (; step < end && go(step); ++step) body(step);
      if (!(step < last && go(step))) return step;
      if (ck != nullptr) {
        store_ckpt<Opt>(ck, field, x, v, inside);
        ck += 7 * field;
      }
      end = step + seg;
    }
  } else {
    for (; step < last && go(step); ++step) body(step);
    return step;
  }
}

template <typename T, bool kCkpt, typename Rule, typename Opt = FwdLoop>
__global__ void trace_fwd_kernel(Grid<T> g, T ds, const T* __restrict__ x0,
                                 const T* __restrict__ v0, const int* __restrict__ order,
                                 T* __restrict__ xt_out, T* __restrict__ vt_out,
                                 int* __restrict__ c_out, unsigned char* __restrict__ code_out,
                                 T* __restrict__ ckpts, Rule rule, Horizon<T> hz, int n_rays,
                                 int max_steps, int seg) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_rays) return;
  const long long t0 = Opt::clock_start();
  const int i = ray_of(order, t);
  T x[3], v[3], xt[3], vt[3];
  load3(x0, i, x);
  load3(v0, i, v);
#pragma unroll
  for (int k = 0; k < 3; ++k) { xt[k] = x[k]; vt[k] = v[k]; }
  typename Rule::Ray r = rule.start(i, x);
  bool inside = inbounds(g, x);
  rule_enter(g, rule, r, x, inside);
  bool esc = false;
  int c = Rule::c0(max_steps);
  bool captured = false;
  auto body = [&](int step) {
    const bool cur_inside = rule_step(g, rule, r, ds, x, v, inside);
    const bool cross = inside && !cur_inside;
    esc = esc | cross | escaped(g, x, v, static_cast<T>(1));
    if (rule.capture(r, x, cross)) {
#pragma unroll
      for (int k = 0; k < 3; ++k) { xt[k] = x[k]; vt[k] = v[k]; }
      c = step + 1;
      captured = true;
    }
    inside = cur_inside;
  };
  // this thread's column of the checkpoints (field k of row s at
  // ckpts[(s * 7 + k) * n_rays + t])
  T* ck = kCkpt && ckpts != nullptr ? ckpts + t : nullptr;
  const int step = step_with_rows<kCkpt, Opt>(0, max_steps, seg, ck, static_cast<size_t>(n_rays),
                                              x, v, inside, [&](int) { return !esc; }, body);
  Opt::clock_stop(t, t0, step);
  if constexpr (Rule::kHorizon) {
    store3(hz.x, t, x);
    store3(hz.v, t, v);
    hz.steps[t] = step;
    hz.inside[t] = inside;
    take_last(hz, i, step);
  }
  if (xt_out == nullptr) return;

  // K2, K11: rays that never escaped report their final position; vt is not
  // fixed up
  if constexpr (Rule::kFixup) {
#pragma unroll
    for (int k = 0; k < 3; ++k) xt[k] = esc ? xt[k] : x[k];
  }
  store3(xt_out, i, xt);
  store3(vt_out, i, vt);
  rule.finish(r, i, esc);
  if (kCkpt) {
    c_out[i] = c;
    code_out[i] = !esc ? 0 : (captured ? 1 : 2);
  }
}

// Pass 2 of a horizon rule (K12, K13; K16, K17 with kCkpt): each escaped ray
// steps on from where pass 1 left it to its horizon (Horizon::take) while
// the rule continues it (the sdf's while inside, the target's until no step
// can come closer), with the rule's step and capture, and rewrites its
// outputs; with kCkpt also the checkpoint of each segment it starts (null
// ckpts: none), its capture step and code.  A ray the rule does not continue
// from its first state keeps what pass 1 wrote.  Every ray here has escaped
// (one that never did took max_steps).
template <typename T, bool kCkpt, typename Rule, typename Opt = FwdLoop>
__global__ void trace_horizon_kernel(Grid<T> g, T ds, const int* __restrict__ order,
                                     T* __restrict__ xt_out, T* __restrict__ vt_out,
                                     int* __restrict__ c_out, unsigned char* __restrict__ code_out,
                                     T* __restrict__ ckpts, Rule rule, Horizon<T> hz, int n_rays,
                                     int seg) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_rays) return;
  const long long t0 = Opt::clock_start();
  const int first = hz.steps[t];
  bool inside = hz.inside[t];
  const int i = ray_of(order, t);
  const int last = hz.take(i);
  if (first >= last) return;
  T x[3], v[3], xt[3], vt[3];
  load3(hz.x, t, x);
  load3(hz.v, t, v);
  typename Rule::Ray r = rule.resume(i);
  if (!rule.continues(r, x, v, inside)) return;
  load3(xt_out, i, xt);
  load3(vt_out, i, vt);
  rule_enter(g, rule, r, x, inside);
  int c = 0;
  bool captured = false;
  // the column of the first segment that starts at or after `first`
  T* ck = nullptr;
  if (kCkpt) {
    c = c_out[i];
    captured = code_out[i] == 1;
    if (ckpts != nullptr)
      ck = ckpts + t + static_cast<size_t>((first + seg - 1) / seg) * 7 * n_rays;
  }
  auto body = [&](int step) {
    const bool cur_inside = rule_step(g, rule, r, ds, x, v, inside);
    if (rule.capture(r, x, inside && !cur_inside)) {
#pragma unroll
      for (int k = 0; k < 3; ++k) { xt[k] = x[k]; vt[k] = v[k]; }
      c = step + 1;
      captured = true;
    }
    inside = cur_inside;
  };
  const int step = step_with_rows<kCkpt, Opt>(
      first, last, seg, ck, static_cast<size_t>(n_rays), x, v, inside,
      [&](int) { return rule.continues(r, x, v, inside); }, body);
  Opt::clock_stop(t, t0, step - first);
  store3(xt_out, i, xt);
  store3(vt_out, i, vt);
  rule.finish(r, i, true);
  if (kCkpt) {
    c_out[i] = c;
    code_out[i] = captured ? 1 : 2;
  }
}

// One pass of a variant: pass 1 (or the only one) with trace_fwd_kernel,
// pass 2 with trace_horizon_kernel; kCkpt with c, code and ckpts (may be
// null) as K5 takes them.
template <typename T, bool kCkpt, typename Rule, typename Opt = FwdLoop>
int launch_variant(const Grid<T>& g, double ds, const void* x0, const void* v0,
                   const int* order, void* xt, void* vt, void* c, void* code, void* ckpts,
                   const Rule& rule, const Horizon<T>& hz, int n_rays, int max_steps, int seg,
                   int pass, cudaStream_t stream) {
  if (n_rays > 0) {
    if (pass == 1) {
      trace_fwd_kernel<T, kCkpt, Rule, Opt><<<blocks_for(n_rays), kThreads, 0, stream>>>(
          g, static_cast<T>(ds), static_cast<const T*>(x0), static_cast<const T*>(v0), order,
          static_cast<T*>(xt), static_cast<T*>(vt), static_cast<int*>(c),
          static_cast<unsigned char*>(code), static_cast<T*>(ckpts), rule, hz, n_rays,
          max_steps, seg);
    } else if constexpr (Rule::kHorizon) {
      trace_horizon_kernel<T, kCkpt, Rule, Opt><<<blocks_for(n_rays), kThreads, 0, stream>>>(
          g, static_cast<T>(ds), order, static_cast<T*>(xt), static_cast<T*>(vt),
          static_cast<int*>(c), static_cast<unsigned char*>(code), static_cast<T*>(ckpts), rule,
          hz, n_rays, seg);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);  // a rule without a horizon has one pass
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// The horizon state of a call over n_rays slots; chunk > 0 (K17 with hor_out):
// a word of `last` for each chunk of chunk rays, pass 2 rounding up to seg
// and capping at max_steps (the ray slots are then every ray of the batch).
template <typename T>
Horizon<T> make_horizon(void* x, void* v, void* steps, void* inside, void* last,
                        const void* hor = nullptr, void* hor_out = nullptr, int chunk = 0,
                        int n_rays = 0, int seg = 1, int max_steps = 0) {
  const bool chunked = hor_out != nullptr;
  const int words = chunked && chunk > 0 ? (n_rays + chunk - 1) / chunk : 1;
  return Horizon<T>{static_cast<T*>(x), static_cast<T*>(v), static_cast<int*>(steps),
                    static_cast<unsigned char*>(inside), static_cast<int*>(last),
                    static_cast<const int*>(hor), static_cast<int*>(hor_out),
                    chunked ? chunk : 0,
                    chunked && static_cast<long long>(words) * chunk > n_rays ? words - 1 : -1,
                    chunked ? seg : 1, chunked ? max_steps : 0x7fffffff};
}

template <typename T>
int launch_trace_fwd(const void* rif, int W, int H, int D, double h, double ds,
                     const void* x0, const void* v0, const int* order, void* xt, void* vt,
                     int n_rays, int max_steps, cudaStream_t stream) {
  if (n_rays > 0) {
    trace_fwd_kernel<T, false, VolumeRule<T>><<<blocks_for(n_rays), kThreads, 0, stream>>>(
        make_grid<T>(rif, W, H, D, h), static_cast<T>(ds), static_cast<const T*>(x0),
        static_cast<const T*>(v0), order, static_cast<T*>(xt), static_cast<T*>(vt), nullptr,
        nullptr, nullptr, VolumeRule<T>{}, Horizon<T>{}, n_rays, max_steps, 1);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_trace_ckpt(const void* rif, int W, int H, int D, double h, double ds,
                      const void* x0, const void* v0, const int* order, void* xt, void* vt,
                      void* c, void* code, void* ckpts, int n_rays, int max_steps, int seg,
                      cudaStream_t stream) {
  if (n_rays > 0) {
    trace_fwd_kernel<T, true, VolumeRule<T>><<<blocks_for(n_rays), kThreads, 0, stream>>>(
        make_grid<T>(rif, W, H, D, h), static_cast<T>(ds), static_cast<const T*>(x0),
        static_cast<const T*>(v0), order, static_cast<T*>(xt), static_cast<T*>(vt),
        static_cast<int*>(c), static_cast<unsigned char*>(code), static_cast<T*>(ckpts),
        VolumeRule<T>{}, Horizon<T>{}, n_rays, max_steps, seg);
  }
  return static_cast<int>(cudaGetLastError());
}

// K20 record_paths: each ray's trajectory every `stride` steps, the 2008
// baseline's "true" path model (the JAX package's
// pathmatrix/fuel2008.py::record_paths, an XLA scan around a fori_loop).
// K2's step with no escape test and no stop: (nrec - 1) * stride steps, the
// eval masked by the previous position's inbounds, so a ray outside the grid
// goes on straight.  x0 is record 0; x after k * stride steps is record k,
// written cast to float32 (round to nearest, as numpy's astype) at
// path[(k * n_rays + i) * 3], the flat (nrec * n_rays, 3) layout the path
// matrix indexes.  The stepping is K2's bit for bit (forward_step).
//
// Bound: the records, 12 B a ray each (415 MB at 524,288 rays and 66
// records), against the steps' f64 operations (520 steps a ray, 22 % of them
// evaluating: the rays spend most of their steps outside the volume).  An
// evaluating step is 161 instructions, 85 of them f64, which the card issues
// at a warp instruction every other cycle; the stencil's three divisions go
// by the exact multiply where the spacing allows it (div_h, with_division;
// the 2008 volume's h = 1/64; the operator's reciprocal, refinement and
// slow-path call made the step 225 instructions and K20 7 % slower).  The
// records take 3 % (storing none), evict-first stores none of it (PERF.md).
// A warp's store of one record is 384 contiguous bytes when its threads take
// consecutive rays.  `order` as for K2 (null: thread i takes ray i).  Opt:
// FwdLoop, or a design of tools/sdf_record_designs.cu that stores only the
// last record.
template <typename T, typename Opt = FwdLoop>
__global__ void record_paths_kernel(Grid<T> grid, T ds, const T* __restrict__ x0,
                                    const T* __restrict__ v0, const int* __restrict__ order,
                                    float* __restrict__ path, int n_rays, int nrec, int stride) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_rays) return;
  const int i = ray_of(order, t);
  T x[3], v[3];
  load3(x0, i, x);
  load3(v0, i, v);
  float* out = path + 3 * static_cast<size_t>(i);
  const size_t rec = 3 * static_cast<size_t>(n_rays);
  with_division(grid, [&](const Grid<T>& g) {
    bool inside = inbounds(g, x);
    for (int k = 0; k < nrec; ++k, out += rec) {
      if (k > 0) {
        for (int s = 0; s < stride; ++s) inside = forward_step(g, ds, x, v, inside);
      }
      if (Opt::kRecords || k == nrec - 1) {
#pragma unroll
        for (int a = 0; a < 3; ++a) out[a] = static_cast<float>(x[a]);
      }
    }
  });
}

template <typename T>
int launch_record_paths(const void* rif, int W, int H, int D, double h, double ds,
                        const void* x0, const void* v0, const int* order, void* path,
                        int n_rays, int nrec, int stride, cudaStream_t stream) {
  if (n_rays > 0) {
    record_paths_kernel<T><<<blocks_for(n_rays), kThreads, 0, stream>>>(
        make_grid<T>(rif, W, H, D, h), static_cast<T>(ds), static_cast<const T*>(x0),
        static_cast<const T*>(v0), order, static_cast<float*>(path), n_rays, nrec, stride);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace anrt

// K20.  path: (nrec * n_rays, 3) float32 whatever the grid's type; order:
// null, or n_rays ray indices (thread i takes ray order[i]).
extern "C" int anrt_record_paths(int is_double, const void* rif, int W, int H, int D, double h,
                                 double ds, const void* x0, const void* v0, const void* order,
                                 void* path, int n_rays, int nrec, int stride, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto o = static_cast<const int*>(order);
  return is_double ? anrt::launch_record_paths<double>(rif, W, H, D, h, ds, x0, v0, o, path,
                                                       n_rays, nrec, stride, s)
                   : anrt::launch_record_paths<float>(rif, W, H, D, h, ds, x0, v0, o, path,
                                                      n_rays, nrec, stride, s);
}

// order: null, or n_rays ray indices (thread i takes ray order[i]).
extern "C" int anrt_trace_fwd(int is_double, const void* rif, int W, int H, int D, double h,
                              double ds, const void* x0, const void* v0, const void* order,
                              void* xt, void* vt, int n_rays, int max_steps, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto o = static_cast<const int*>(order);
  return is_double ? anrt::launch_trace_fwd<double>(rif, W, H, D, h, ds, x0, v0, o, xt, vt,
                                                    n_rays, max_steps, s)
                   : anrt::launch_trace_fwd<float>(rif, W, H, D, h, ds, x0, v0, o, xt, vt,
                                                   n_rays, max_steps, s);
}

// K5.  order: n_rays ray indices (thread i takes ray order[i]; n_rays may be
// a chunk of the rays).  xt, vt (3 per ray), c (int32) and code (uint8) are
// written at the ray's own index; all four null to skip them.  ckpts: null,
// or (ceil(max_steps/seg), 7, n_rays) with column i thread i's.
extern "C" int anrt_trace_ckpt(int is_double, const void* rif, int W, int H, int D, double h,
                               double ds, const void* x0, const void* v0, const void* order,
                               void* xt, void* vt, void* c, void* code, void* ckpts,
                               int n_rays, int max_steps, int seg, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto o = static_cast<const int*>(order);
  return is_double ? anrt::launch_trace_ckpt<double>(rif, W, H, D, h, ds, x0, v0, o, xt, vt, c,
                                                     code, ckpts, n_rays, max_steps, seg, s)
                   : anrt::launch_trace_ckpt<float>(rif, W, H, D, h, ds, x0, v0, o, xt, vt, c,
                                                    code, ckpts, n_rays, max_steps, seg, s);
}

// K15 (c, code and ckpts given) and K11 (all three null): one pass.  order:
// n_rays thread slots, each a ray index (may be a chunk of the rays); xt, vt,
// miss, c (int32) and code (uint8) at the ray's own index; ckpts null or
// (ceil(max_steps/seg), 7, n_rays), column i slot i's, as K5's.
extern "C" int anrt_trace_plane_ckpt(int is_double, const void* rif, int W, int H, int D,
                                     double h, double ds, const void* x0, const void* v0,
                                     const void* pln_o, const void* pln_d, const void* order,
                                     void* xt, void* vt, void* miss, void* c, void* code,
                                     void* ckpts, int n_rays, int max_steps, int seg,
                                     void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto o = static_cast<const int*>(order);
  auto m = static_cast<unsigned char*>(miss);
  const bool ckpt = c != nullptr;
  if (is_double) {
    const anrt::PlaneRule<double> rule{static_cast<const double*>(pln_o),
                                       static_cast<const double*>(pln_d), m};
    const auto g = anrt::make_grid<double>(rif, W, H, D, h);
    return ckpt ? anrt::launch_variant<double, true>(g, ds, x0, v0, o, xt, vt, c, code, ckpts,
                                                     rule, anrt::Horizon<double>{}, n_rays,
                                                     max_steps, seg, 1, s)
                : anrt::launch_variant<double, false>(g, ds, x0, v0, o, xt, vt, c, code, ckpts,
                                                      rule, anrt::Horizon<double>{}, n_rays,
                                                      max_steps, seg, 1, s);
  }
  const anrt::PlaneRule<float> rule{static_cast<const float*>(pln_o),
                                    static_cast<const float*>(pln_d), m};
  const auto g = anrt::make_grid<float>(rif, W, H, D, h);
  return ckpt ? anrt::launch_variant<float, true>(g, ds, x0, v0, o, xt, vt, c, code, ckpts, rule,
                                                  anrt::Horizon<float>{}, n_rays, max_steps, seg,
                                                  1, s)
              : anrt::launch_variant<float, false>(g, ds, x0, v0, o, xt, vt, c, code, ckpts, rule,
                                                   anrt::Horizon<float>{}, n_rays, max_steps,
                                                   seg, 1, s);
}

// K16 (c and code given) and K12 (c, code, ckpts null), pass 1 or 2: the
// horizon state as for K12, `last` zero before pass 1 or set to the batch's
// last escape step (a chunk's recomputation).
extern "C" int anrt_trace_target_ckpt(int is_double, const void* rif, int W, int H, int D,
                                      double h, double ds, const void* x0, const void* v0,
                                      const void* target, const void* order, void* xt, void* vt,
                                      void* d2, void* c, void* code, void* ckpts, void* hx,
                                      void* hv, void* steps, void* inside, void* last,
                                      int n_rays, int max_steps, int seg, int pass,
                                      void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto o = static_cast<const int*>(order);
  const bool ckpt = c != nullptr;
  if (is_double) {
    const anrt::TargetRule<double> rule{static_cast<const double*>(target),
                                        static_cast<double*>(d2)};
    const auto g = anrt::make_grid<double>(rif, W, H, D, h);
    const auto hz = anrt::make_horizon<double>(hx, hv, steps, inside, last);
    return ckpt ? anrt::launch_variant<double, true>(g, ds, x0, v0, o, xt, vt, c, code, ckpts,
                                                     rule, hz, n_rays, max_steps, seg, pass, s)
                : anrt::launch_variant<double, false>(g, ds, x0, v0, o, xt, vt, c, code, ckpts,
                                                      rule, hz, n_rays, max_steps, seg, pass, s);
  }
  const anrt::TargetRule<float> rule{static_cast<const float*>(target), static_cast<float*>(d2)};
  const auto g = anrt::make_grid<float>(rif, W, H, D, h);
  const auto hz = anrt::make_horizon<float>(hx, hv, steps, inside, last);
  return ckpt ? anrt::launch_variant<float, true>(g, ds, x0, v0, o, xt, vt, c, code, ckpts, rule,
                                                  hz, n_rays, max_steps, seg, pass, s)
              : anrt::launch_variant<float, false>(g, ds, x0, v0, o, xt, vt, c, code, ckpts,
                                                   rule, hz, n_rays, max_steps, seg, pass, s);
}

// K17 (c and code given) and K13 (c, code, ckpts, hor, hor_out null), pass 1
// or 2: the horizon state as for K12 but for `last` and the horizon.  With
// hor_out (K17 over every ray of the batch), `last` holds a word for each
// chunk of `chunk` rays by ray index (0: one word, the whole batch; zeroed
// before pass 1), and pass 2 writes each ray's horizon (int32 at the ray's
// index) to hor_out; with hor, pass 2 takes that horizon per ray (a chunk's
// recomputation); with neither, `last` is one word, the batch's last escape
// step (K13).  pairs: the (D, H, W, 2) grid of node pairs (rif, sdf) of the
// grid's type, which both read (rules.cuh, kSdfPacked; rif is not read).
extern "C" int anrt_trace_sdf_ckpt(int is_double, const void* rif, int W, int H, int D,
                                   double h, double ds, const void* pairs, const void* x0,
                                   const void* v0, const void* order, void* xt, void* vt, void* c,
                                   void* code, void* ckpts, void* hx, void* hv, void* steps,
                                   void* inside, void* last, const void* hor, void* hor_out,
                                   int n_rays, int max_steps, int seg, int chunk, int pass,
                                   void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto o = static_cast<const int*>(order);
  const bool ckpt = c != nullptr;
  if (is_double) {
    const anrt::SdfRule<double, anrt::kSdfPacked> rule{
        anrt::make_grid<double>(pairs, W, H, D, h)};
    const auto g = anrt::make_grid<double>(rif, W, H, D, h);
    const auto hz = anrt::make_horizon<double>(hx, hv, steps, inside, last, hor, hor_out, chunk,
                                               n_rays, seg, max_steps);
    return ckpt ? anrt::launch_variant<double, true>(g, ds, x0, v0, o, xt, vt, c, code, ckpts,
                                                     rule, hz, n_rays, max_steps, seg, pass, s)
                : anrt::launch_variant<double, false>(g, ds, x0, v0, o, xt, vt, c, code, ckpts,
                                                      rule, hz, n_rays, max_steps, seg, pass, s);
  }
  const anrt::SdfRule<float, anrt::kSdfPacked> rule{anrt::make_grid<float>(pairs, W, H, D, h)};
  const auto g = anrt::make_grid<float>(rif, W, H, D, h);
  const auto hz = anrt::make_horizon<float>(hx, hv, steps, inside, last, hor, hor_out, chunk,
                                            n_rays, seg, max_steps);
  return ckpt ? anrt::launch_variant<float, true>(g, ds, x0, v0, o, xt, vt, c, code, ckpts, rule,
                                                  hz, n_rays, max_steps, seg, pass, s)
              : anrt::launch_variant<float, false>(g, ds, x0, v0, o, xt, vt, c, code, ckpts,
                                                   rule, hz, n_rays, max_steps, seg, pass, s);
}

// K11.  pln_o, pln_d: (n_rays, 3) per ray; miss: n_rays bytes (1: never escaped).
extern "C" int anrt_trace_plane(int is_double, const void* rif, int W, int H, int D, double h,
                                double ds, const void* x0, const void* v0, const void* pln_o,
                                const void* pln_d, const void* order, void* xt, void* vt,
                                void* miss, int n_rays, int max_steps, void* stream) {
  return anrt_trace_plane_ckpt(is_double, rif, W, H, D, h, ds, x0, v0, pln_o, pln_d, order, xt,
                               vt, miss, nullptr, nullptr, nullptr, n_rays, max_steps, 1, stream);
}

// K12, pass 1 or 2 (`pass`).  target: (n_rays, 3); d2: n_rays.  The horizon
// state (hx, hv: n_rays x 3 of the grid's type; steps: int32; inside: bytes;
// last: one int32, zero before pass 1) is indexed by thread slot; both passes
// take the same buffers and order.
extern "C" int anrt_trace_target(int is_double, const void* rif, int W, int H, int D, double h,
                                 double ds, const void* x0, const void* v0, const void* target,
                                 const void* order, void* xt, void* vt, void* d2, void* hx,
                                 void* hv, void* steps, void* inside, void* last, int n_rays,
                                 int max_steps, int pass, void* stream) {
  return anrt_trace_target_ckpt(is_double, rif, W, H, D, h, ds, x0, v0, target, order, xt, vt,
                                d2, nullptr, nullptr, nullptr, hx, hv, steps, inside, last,
                                n_rays, max_steps, 1, pass, stream);
}

// K13, pass 1 or 2.  pairs: the (D, H, W, 2) grid of node pairs (rif, sdf)
// of the grid's type (rif itself is not read); the horizon state as for K12.
extern "C" int anrt_trace_sdf(int is_double, const void* rif, int W, int H, int D, double h,
                              double ds, const void* pairs, const void* x0, const void* v0,
                              const void* order, void* xt, void* vt, void* hx, void* hv,
                              void* steps, void* inside, void* last, int n_rays, int max_steps,
                              int pass, void* stream) {
  return anrt_trace_sdf_ckpt(is_double, rif, W, H, D, h, ds, pairs, x0, v0, order, xt, vt,
                             nullptr, nullptr, nullptr, hx, hv, steps, inside, last, nullptr,
                             nullptr, n_rays, max_steps, 1, 0, pass, stream);
}

namespace anrt {

// div_h held to the operator for every f32 dividend: thread u of the grid's
// 2^32 takes the dividend with the bits u; a difference (NaN against NaN is
// none) adds one to count[0] and writes its bits to first[] while it has room.
__global__ void div_h_check_kernel(Grid<float> g, unsigned long long* count, unsigned* first,
                                   int n_first) {
  const unsigned long long n = 1ULL << 32;
  for (unsigned long long u = blockIdx.x * static_cast<unsigned long long>(blockDim.x) +
                              threadIdx.x;
       u < n; u += static_cast<unsigned long long>(gridDim.x) * blockDim.x) {
    const float a = __uint_as_float(static_cast<unsigned>(u));
    const float want = a / g.h;
    const float got = div_h(g, a);
    const bool same = isnan(want) ? isnan(got) : __float_as_uint(got) == __float_as_uint(want);
    if (!same) {
      const unsigned long long k = atomicAdd(count, 1ULL);
      if (k < static_cast<unsigned long long>(n_first)) first[k] = static_cast<unsigned>(u);
    }
  }
}

// div_h held to the operator for n f64 dividends at g.h: dividend u is
// edge[u] for u < n_edge, else 64 random bits (splitmix64 of u and seed) for
// even u, and for odd u those bits made a number in [-2^7, 2^7) (the
// positions a grid's steps divide); counted as div_h_check_kernel counts.
__device__ __forceinline__ unsigned long long splitmix64(unsigned long long z) {
  z += 0x9e3779b97f4a7c15ULL;
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  return z ^ (z >> 31);
}

__global__ void div_h64_check_kernel(Grid<double> g, unsigned long long n,
                                     unsigned long long seed, const double* edge, int n_edge,
                                     unsigned long long* count, unsigned long long* first,
                                     int n_first) {
  for (unsigned long long u = blockIdx.x * static_cast<unsigned long long>(blockDim.x) +
                              threadIdx.x;
       u < n; u += static_cast<unsigned long long>(gridDim.x) * blockDim.x) {
    double a;
    if (u < static_cast<unsigned long long>(n_edge)) {
      a = edge[u];
    } else {
      const unsigned long long bits = splitmix64(u ^ (seed << 40));
      a = (u & 1) ? static_cast<double>(static_cast<long long>(bits)) * 0x1p-56
                  : __longlong_as_double(static_cast<long long>(bits));
    }
    const double want = a / g.h;
    const double got = div_h(g, a);
    const bool same = isnan(want) ? isnan(got)
                                  : __double_as_longlong(got) == __double_as_longlong(want);
    if (!same) {
      const unsigned long long k = atomicAdd(count, 1ULL);
      if (k < static_cast<unsigned long long>(n_first))
        first[k] = static_cast<unsigned long long>(__double_as_longlong(a));
    }
  }
}

}  // namespace anrt

// The f64 stencil's division (trilinear.cuh div_h: the exact multiply where
// h is a power of two, else the operator) against the operator on n
// dividends at the f64 spacing h (div_h64_check_kernel); exact gets 1 where
// the grid took the multiply.  A check, launched by chip_smoke.py, by no path
// of the port.
extern "C" int anrt_div_h64_check(double h, unsigned long long n, unsigned long long seed,
                                  const void* edge, int n_edge, void* count, void* first,
                                  int n_first, void* exact, void* stream) {
  const auto g = anrt::make_grid<double>(nullptr, 2, 2, 2, h);
  *static_cast<int*>(exact) = g.rcp_exact ? 1 : 0;
  anrt::div_h64_check_kernel<<<132 * 16, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      g, n, seed, static_cast<const double*>(edge), n_edge,
      static_cast<unsigned long long*>(count), static_cast<unsigned long long*>(first), n_first);
  return static_cast<int>(cudaGetLastError());
}

// The stencil's division (trilinear.cuh div_h) against the operator over all
// 2^32 f32 dividends at the f32 spacing h: count (one uint64, zeroed) gets
// the dividends whose quotients differ, first (n_first uint32) the bits of
// the first ones.  A check, launched by chip_smoke.py, by no path of the port.
extern "C" int anrt_div_h_check(double h, void* count, void* first, int n_first, void* stream) {
  const auto g = anrt::make_grid<float>(nullptr, 2, 2, 2, h);
  anrt::div_h_check_kernel<<<132 * 16, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      g, static_cast<unsigned long long*>(count), static_cast<unsigned*>(first), n_first);
  return static_cast<int>(cudaGetLastError());
}
