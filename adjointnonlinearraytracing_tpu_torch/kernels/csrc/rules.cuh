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
// a horizon (a second launch), while continues(inside) holds, from the state
// resume(i) rebuilds.
#pragma once

#include "trilinear.cuh"

namespace anrt {

template <typename T>
struct VolumeRule {  // K2, K5, K6
  static constexpr bool kFixup = true, kHorizon = false;
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
  static constexpr bool kFixup = true, kHorizon = false;
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
    return in_grid && !(past > static_cast<T>(0));
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
  static constexpr bool kFixup = false, kHorizon = true;
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
  __device__ __forceinline__ bool continues(bool) const { return true; }
};

template <typename T>
struct SdfRule {  // K13, K17, K19
  Grid<T> sdf;  // on the grid's lattice
  static constexpr bool kFixup = false, kHorizon = true;
  struct Ray {};
  static __device__ __forceinline__ int c0(int) { return 0; }
  __device__ __forceinline__ Ray start(int, const T*) const { return {}; }
  __device__ __forceinline__ Ray resume(int) const { return {}; }
  __device__ __forceinline__ bool inside(Ray&, const T x[3], bool was, bool) const {
    return was && value_at(sdf, x) < static_cast<T>(0);
  }
  __device__ __forceinline__ bool capture(Ray&, const T*, bool cross) const { return cross; }
  __device__ __forceinline__ void finish(const Ray&, int, bool) const {}
  __device__ __forceinline__ bool continues(bool inside) const { return inside; }
};

}  // namespace anrt
