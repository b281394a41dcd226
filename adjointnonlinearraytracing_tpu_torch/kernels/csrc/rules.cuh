// The stop, capture and "inside" rules of the volume variants, shared by the
// forward stepper (trace_fwd.cu: K2, K5, K11-K13, K15-K17) and the exact
// gradient's backward pass (backtrace_exact.cu: K6, K18, K19), which replays
// each segment with the same rule as the forward pass that wrote it.
//
// A rule holds its per-ray inputs and outputs; `Ray` is its per-ray state:
// start(i, x0) makes it (the backward pass passes no x0: only the target's
// reads it, and the target's backward pass is K6's, with VolumeRule),
// inside(r, x, was, in_grid) is "inside" at the new x (in_grid = inbounds(x),
// was = the previous step's inside), capture(r, x, cross) says whether (x, v)
// becomes the output, finish(r, i, esc) writes the rule's own outputs.
// kFixup: a ray that never escaped reports its last x, and its capture step
// starts at max_steps (c0); without it, at 0 (a ray that is never captured
// returns its start and has no gradient).  kHorizon: escaped rays step on to
// a horizon (a second launch), while continues() holds, from the state
// resume(i) rebuilds.  kOwnStep: the rule takes the whole step (step(), after
// enter() at the ray's first position), not forward_step and then inside();
// rule_step() and rule_enter() below pick.  continues(r, x, v, inside) says
// whether pass 2 steps an escaped ray on from (x, v): the sdf's while it is
// inside, the target's until it can come no closer (TargetRule).
#pragma once

#include "trilinear.cuh"

namespace anrt {

template <typename T>
struct VolumeRule {  // K2, K5, K6
  static constexpr bool kFixup = true, kHorizon = false, kOwnStep = false;
  struct Ray {};
  static __device__ __forceinline__ int c0(int max_steps) { return max_steps; }
  __device__ __forceinline__ Ray start(int, const T*) const { return {}; }
  __device__ __forceinline__ bool inside(Ray&, const T*, bool, bool in_grid) const {
    return in_grid;
  }
  __device__ __forceinline__ bool capture(Ray&, const T*, bool cross) const { return cross; }
  __device__ __forceinline__ void finish(const Ray&, int, bool) const {}
};

template <typename T>
struct PlaneRule {  // K11, K15, K18
  const T* __restrict__ o;
  const T* __restrict__ d;
  unsigned char* __restrict__ miss;  // null in the backward pass
  static constexpr bool kFixup = true, kHorizon = false, kOwnStep = false;
  struct Ray { T o[3], d[3]; };
  static __device__ __forceinline__ int c0(int max_steps) { return max_steps; }
  __device__ __forceinline__ Ray start(int i, const T*) const {
    Ray r;
    load3(o, i, r.o);
    load3(d, i, r.d);
    return r;
  }
  __device__ __forceinline__ bool inside(Ray& r, const T x[3], bool, bool in_grid) const {
    const T past = (x[0] - r.o[0]) * r.d[0] + (x[1] - r.o[1]) * r.d[1] +
                   (x[2] - r.o[2]) * r.d[2];
    return in_grid & !(past > static_cast<T>(0));
  }
  __device__ __forceinline__ bool capture(Ray&, const T*, bool cross) const { return cross; }
  __device__ __forceinline__ void finish(const Ray&, int i, bool esc) const { miss[i] = !esc; }
};

template <typename T>
__device__ __forceinline__ T dist2(const T x[3], const T y[3]) {
  const T d[3] = {x[0] - y[0], x[1] - y[1], x[2] - y[2]};
  return d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
}

template <typename T>
struct TargetRule {  // K12, K16
  const T* __restrict__ target;
  T* __restrict__ d2;
  static constexpr bool kFixup = false, kHorizon = true, kOwnStep = false;
  struct Ray { T tgt[3]; T d2; };
  static __device__ __forceinline__ int c0(int) { return 0; }
  __device__ __forceinline__ Ray start(int i, const T* x0) const {
    Ray r;
    load3(target, i, r.tgt);
    r.d2 = dist2(x0, r.tgt);
    return r;
  }
  // pass 2 starts from pass 1's output
  __device__ __forceinline__ Ray resume(int i) const {
    Ray r;
    load3(target, i, r.tgt);
    r.d2 = d2[i];
    return r;
  }
  __device__ __forceinline__ bool inside(Ray&, const T*, bool, bool in_grid) const {
    return in_grid;
  }
  __device__ __forceinline__ bool capture(Ray& r, const T x[3], bool) const {
    const T cur = dist2(x, r.tgt);
    const bool closer = cur < r.d2;
    if (closer) r.d2 = cur;
    return closer;
  }
  __device__ __forceinline__ void finish(const Ray& r, int i, bool) const { d2[i] = r.d2; }
  // Pass 2's rays have escaped: outside the grid, moving away on some axis,
  // their eval masked, so v stays fixed and each coordinate moves
  // monotonically (x + ds*v rounds to nearest, which is monotone).  Once
  // every axis recedes from the target or stands still (x_k >= t_k with
  // v_k >= 0, or x_k <= t_k with v_k <= 0), no |x_k - t_k| shrinks again, and
  // dist2 (three rounded squares summed in a fixed order) is monotone in
  // each, so no later step is strictly closer than this one, which capture()
  // has already seen: the ray's outputs are final, and the backward pass
  // reads no checkpoint row past its last capture.  The ray stops there
  // (wrappers.target_retired_plain is the plain twin).
  __device__ __forceinline__ bool continues(const Ray& r, const T x[3], const T v[3],
                                            bool) const {
    bool retired = true;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      retired = retired & (((x[k] >= r.tgt[k]) & (v[k] >= static_cast<T>(0))) |
                           ((x[k] <= r.tgt[k]) & (v[k] <= static_cast<T>(0))));
    return !retired;
  }
};

// The cell of the point the next step evaluates at, left there by the step
// that moved the ray (the sdf's steps read the sdf with it): its clamped
// corner nodes and offsets (corner_cells) and, where the step loads them
// ahead, the grid's corner values.
template <typename T>
struct Cell {
  int c[3][2];
  T w0[3];
  T cv[2][2][2];
};

// How the sdf's step reads the two grids: kSdfAlone, the sdf with a stencil
// of its own after K2's step (SdfRule::inside); kSdfShared, the sdf with the
// stencil that the next step's grid read takes at the same point; kSdfAhead,
// that, and the next step's grid corners loaded beside the sdf's; kSdfPacked,
// kSdfAhead's reads from one grid of node pairs (grid value, sdf value), the
// rule's `sdf` grid pointing at that (D, H, W, 2) array: a corner of both is
// one 8-byte load (16 in f64) at one address.
enum SdfRead { kSdfAlone, kSdfShared, kSdfAhead, kSdfPacked };

template <typename T> struct NodePair;
template <> struct NodePair<float> { using type = float2; };
template <> struct NodePair<double> { using type = double2; };

// The corners of stencil s in a grid of node pairs: the first of each pair
// to v, the second to w.
template <typename T>
__device__ __forceinline__ void fetch_pairs(const Grid<T>& pairs, const Stencil<T>& s,
                                            T v[2][2][2], T w[2][2][2]) {
  const auto* p = reinterpret_cast<const typename NodePair<T>::type*>(pairs.data);
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const auto q = __ldg(p + s.idx[a][b][c]);
        v[a][b][c] = q.x;
        w[a][b][c] = q.y;
      }
}

// The ray's first position x under the sdf's step: its cell, and (kSdfAhead,
// kSdfPacked: from the pairs in `sdf`) the grid's corners there.
template <int kRead, typename T>
__device__ __forceinline__ void sdf_enter(const Grid<T>& g, const Grid<T>& sdf, const T x[3],
                                          Cell<T>& cell) {
  corner_cells(g, x, cell.c, cell.w0);
  if constexpr (kRead == kSdfAhead) fetch(g, stencil_of(g, cell.c, cell.w0), true, cell.cv);
  if constexpr (kRead == kSdfPacked) {
    T unused[2][2][2];
    fetch_pairs(sdf, stencil_of(g, cell.c, cell.w0), cell.cv, unused);
  }
}

// One step of the sdf's rule with one stencil a step: K2's step from (x, v)
// (the grid evaluated in `cell`, which the step before, or sdf_enter, left
// at x), then "inside" at the new x (was && sdf(x) < 0, the sdf on the
// grid's lattice) read with the stencil that the next step's grid read
// takes, which it leaves in `cell`.  kSdfAhead also loads that read's
// corners now, beside the sdf's, unmasked (both grids are clamped, so every
// corner is in bounds); the next step uses them only where it is inside.
// The positions, masks and values are forward_step's and SdfRule::inside's
// bit for bit: K13, K17 and K19's replay step with this one function.
template <int kRead, typename T>
__device__ __forceinline__ bool sdf_step(const Grid<T>& g, const Grid<T>& sdf, T ds, T x[3],
                                         T v[3], bool inside, Cell<T>& cell) {
  if (inside) {  // an outside ray has n = 0, grad = 0: v is unchanged
    T n, grad[3];
    if constexpr (kRead == kSdfAhead || kRead == kSdfPacked) {
      value_grad(g, cell.cv, cell.w0, n, grad);
    } else {
      const Stencil<T> s = stencil_of(g, cell.c, cell.w0);
      T cv[2][2][2];
      fetch(g, s, true, cv);
      value_grad(g, cv, s.w0, n, grad);
    }
    const T dsn = ds * n;
#pragma unroll
    for (int k = 0; k < 3; ++k) v[k] = v[k] + dsn * grad[k];
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) x[k] = x[k] + ds * v[k];
  if (!inside) return false;  // an outside ray stays outside
  corner_cells(g, x, cell.c, cell.w0);
  const Stencil<T> s = stencil_of(g, cell.c, cell.w0);
  T cs[2][2][2], n, grad[3];
  if constexpr (kRead == kSdfPacked) {
    fetch_pairs(sdf, s, cell.cv, cs);
  } else {
    fetch(sdf, s, true, cs);
    if constexpr (kRead == kSdfAhead) fetch(g, s, true, cell.cv);
  }
  value_grad(sdf, cs, s.w0, n, grad);  // the gradient is dropped
  return n < static_cast<T>(0);
}

template <typename T, int kRead = kSdfAhead>
struct SdfRule {  // K13, K17, K19
  Grid<T> sdf;  // on the grid's lattice
  static constexpr bool kFixup = false, kHorizon = true, kOwnStep = kRead != kSdfAlone;
  struct Ray {
    Cell<T> cell;
  };
  static __device__ __forceinline__ int c0(int) { return 0; }
  __device__ __forceinline__ Ray start(int, const T*) const { return {}; }
  __device__ __forceinline__ Ray resume(int) const { return {}; }
  // "inside" at the new x with a stencil of its own (kSdfAlone's step)
  __device__ __forceinline__ bool inside(Ray&, const T x[3], bool was, bool) const {
    return was && value_at(sdf, x) < static_cast<T>(0);
  }
  __device__ __forceinline__ void enter(Ray& r, const Grid<T>& g, const T x[3],
                                        bool inside) const {
    if (inside) sdf_enter<kRead>(g, sdf, x, r.cell);
  }
  __device__ __forceinline__ bool step(const Grid<T>& g, Ray& r, T ds, T x[3], T v[3],
                                       bool inside) const {
    return sdf_step<kRead>(g, sdf, ds, x, v, inside, r.cell);
  }
  __device__ __forceinline__ bool capture(Ray&, const T*, bool cross) const { return cross; }
  __device__ __forceinline__ void finish(const Ray&, int, bool) const {}
  __device__ __forceinline__ bool continues(const Ray&, const T*, const T*, bool inside) const {
    return inside;
  }
};

// The ray's first position x (inside: the rule's "inside" there), before its
// first rule_step.
template <typename T, typename Rule>
__device__ __forceinline__ void rule_enter(const Grid<T>& g, const Rule& rule,
                                           typename Rule::Ray& r, const T x[3], bool inside) {
  if constexpr (Rule::kOwnStep) rule.enter(r, g, x, inside);
}

// One step under a rule: K2's step, then the rule's "inside" at the new x;
// returns it.  The forward passes (trace_fwd.cu) and the exact backward
// pass's replay (backtrace_exact.cu) step with it, so a replayed trajectory
// is the forward's bit for bit.
template <typename T, typename Rule>
__device__ __forceinline__ bool rule_step(const Grid<T>& g, const Rule& rule,
                                          typename Rule::Ray& r, T ds, T x[3], T v[3],
                                          bool inside) {
  if constexpr (Rule::kOwnStep) return rule.step(g, r, ds, x, v, inside);
  else return rule.inside(r, x, inside, forward_step(g, ds, x, v, inside));
}

}  // namespace anrt
