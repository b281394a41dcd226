// Designs of K7 trace_cable and K8 backtrace_cable timed beside the shipped
// kernels (tools/cable_designs.py); no path of the port launches them.  f32
// only.  Every kernel here takes its block size at launch and, where `clk` is
// given, is the instrumented copy: each lane writes the clock64() cycles
// between the entry and the exit of its step loop and the steps it took
// (clk[2i], clk[2i + 1]).
//
// anrt_k7_design(design, threads, ...) takes trace_cable's arguments:
//   0  K7's first design, copied verbatim below (namespace first): the
//      profile read through __ldg and (v1 - v0) / h divided at every step
//   1  the per-bin table in shared memory (cylinder.cuh BinEntry)
//   2  the next step's evaluation made before the loop's test, no table
//   3  the table and that early evaluation
//   4  as 1, floor and the conversion to int in one instruction
//   5  as 1, divisions and square roots by the IEEE fast paths (div_rn,
//      sqrt_rn): the shipped loop, in this file's kernel so that its block
//      size can change
//   6  as 5, floor and the conversion in one instruction
//   7  as 5 with the early evaluation
// anrt_k8_design(design, threads, ...) takes backtrace_cable's arguments:
//   0  K8's first design, copied verbatim below
//   1  the table; runs added to the block's gradient (shared atomics)
//   2  as 1 with the early evaluation
//   3  as 2, runs added to a gradient of the lane's warp (atomics among
//      the lanes of one warp only)
//   4  as 2, every splat added to the lane's own column of the block's
//      gradient (res x threads doubles; no atomics, no runs)
//   5  as 2, runs added to the lane's own column (no atomics)
//   6  as 4 without the table
//   7  as 4 without the early evaluation
//   8  as 7, floor and the conversion in one instruction
//   9  as 7 with the IEEE fast paths: the shipped column path
//  10  as 9, floor and the conversion in one instruction
//  11  as 9 with the early evaluation
//  12  as 1 with the IEEE fast paths: the shipped block path (profiles too
//      large for the columns)
// Designs 0-4 and 6-8 divide and take roots with the operators.
//
// anrt_arith_check(mode, b, lo, hi, out, stream) counts into out[0], over the
// f32 bit patterns [lo, hi), where the shipped div_rn and sqrt_rn differ from
// the operators in any bit, and keeps in out[1] the bit pattern of the
// largest |a| that differs: mode 0 sqrt_rn(a); mode 1 div_rn(a, b) and
// div_rn(-a, b); mode 2 [lo, hi) indexes pseudo-random pairs b in [1e-6, 4),
// a in (-b, b), as the kernels divide a coordinate by a radius.
#include "cylinder.cuh"

namespace anrt {
namespace first {

// ---- the first design's cylinder.cuh routines that the shipped ones replaced, verbatim ----

template <typename T>
__device__ __forceinline__ Radial<T> radial(const Profile<T>& p, const T x[3]) {
  Radial<T> rd;
  rd.xs0 = x[0] - p.radius;
  rd.xs2 = x[2] - p.radius;
  rd.r = sqrt(rd.xs0 * rd.xs0 + rd.xs2 * rd.xs2);
  const T rm = rd.r / p.h;
  const T fl = floor(rm);
  // clamp in floating point first so the cast to int cannot overflow
  const T lo = static_cast<T>(-1), hi = static_cast<T>(p.res);
  int i = static_cast<int>(fl < lo ? lo : (fl > hi ? hi : fl));
  rd.i0 = i < 0 ? 0 : (i > p.res - 1 ? p.res - 1 : i);
  rd.i1 = rd.i0 + 1 > p.res - 1 ? p.res - 1 : rd.i0 + 1;
  rd.w0 = rm - static_cast<T>(rd.i0);
  rd.w1 = static_cast<T>(1) - rd.w0;
  rd.small = rd.r < p.eps;
  rd.rs = rd.small ? static_cast<T>(1) : rd.r;
  return rd;
}

template <typename T>
__device__ __forceinline__ void value_grad(const Profile<T>& p, const Radial<T>& rd, T& n,
                                           T& rx, T xhat[3], T fx[3]) {
  const T v0 = __ldg(p.data + rd.i0), v1 = __ldg(p.data + rd.i1);
  n = v0 * rd.w1 + v1 * rd.w0;
  rx = (v1 - v0) / p.h;
  xhat[0] = rd.small ? static_cast<T>(0) : rd.xs0 / rd.rs;
  xhat[1] = static_cast<T>(0);
  xhat[2] = rd.small ? static_cast<T>(0) : rd.xs2 / rd.rs;
#pragma unroll
  for (int k = 0; k < 3; ++k) fx[k] = rx * xhat[k];
}

template <typename T>
__device__ __forceinline__ void hessian(const Radial<T>& rd, T rx, const T xhat[3], T hess[3]) {
  const T scale = rd.small ? static_cast<T>(0) : rx / rd.rs;
  hess[0] = scale * (static_cast<T>(1) - xhat[0] * xhat[0]);
  hess[1] = scale * (-(xhat[0] * xhat[2]));
  hess[2] = scale * (static_cast<T>(1) - xhat[2] * xhat[2]);
}

template <typename T>
__device__ __forceinline__ void cable_step(const Profile<T>& p, T ds, T x[3], T v[3],
                                           bool active) {
  const Radial<T> rd = first::radial(p, x);
  T n, rx, xhat[3], fx[3];
  value_grad(p, rd, n, rx, xhat, fx);
  if (active) {
    const T dsn = ds * n;
#pragma unroll
    for (int k = 0; k < 3; ++k) v[k] = v[k] + dsn * fx[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) x[k] = x[k] + ds * v[k];
  }
}

struct CableRun {
  int i0 = -1, i1 = -1;
  double s0 = 0.0, s1 = 0.0;

  __device__ __forceinline__ void flush(double* acc) {
    if (i0 >= 0) {
      atomicAdd(acc + i0, s0);
      atomicAdd(acc + i1, s1);
      i0 = -1;
    }
  }

  __device__ __forceinline__ void add(double* acc, int j0, int j1, double c0, double c1) {
    if (j0 == i0 && j1 == i1) {
      s0 += c0;
      s1 += c1;
      return;
    }
    flush(acc);
    i0 = j0;
    i1 = j1;
    s0 = c0;
    s1 = c1;
  }
};

template <typename T>
__device__ __forceinline__ void cable_adjoint_update(const Profile<T>& p, T ds,
                                                     const Radial<T>& rd, T n,
                                                     const T xhat[3], const T fx[3],
                                                     const T hess[3], bool splat, T la[3],
                                                     T mu[3], CableRun& run, double* acc) {
  const T dn = (mu[0] * fx[0] + mu[1] * fx[1]) + mu[2] * fx[2];
  if (splat) {
    const T val = dn * ds;
    const T g[3] = {n * mu[0] * ds, n * mu[1] * ds, n * mu[2] * ds};
    T gv = (g[0] * xhat[0] + g[1] * xhat[1]) + g[2] * xhat[2];
    if (rd.small) gv = static_cast<T>(0);
    const T gvh = gv / p.h;
    const T c0 = val * rd.w1 - gvh;
    const T c1 = val * rd.w0 + gvh;
    run.add(acc, rd.i0, rd.i1, static_cast<double>(c0), static_cast<double>(c1));
  }
  const T hmu[3] = {hess[0] * mu[0] + hess[1] * mu[2], static_cast<T>(0),
                    hess[1] * mu[0] + hess[2] * mu[2]};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    la[k] = la[k] + ds * (dn * fx[k] + n * hmu[k]);
    mu[k] = mu[k] + ds * la[k];
  }
}

// ---- K7's first design (trace_cable.cu without kCkpt), verbatim but for the clock ----

template <typename T, bool kClock>
__global__ void __launch_bounds__(kThreads)
trace_cable_kernel(Profile<T> p, T ds, const T* __restrict__ x0, const T* __restrict__ v0,
                   const T* __restrict__ target, T* __restrict__ xt_out,
                   T* __restrict__ vt_out, T* __restrict__ d2_out, long long* clk, int n_rays,
                   int max_steps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  T x[3], v[3], tg[3], xt[3], vt[3];
  load3(x0, i, x);
  load3(v0, i, v);
  load3(target, i, tg);
#pragma unroll
  for (int k = 0; k < 3; ++k) { xt[k] = x[k]; vt[k] = v[k]; }
  T d2 = sum_sq3(x, tg);
  bool inside = inbounds(p, x);
  bool esc = false;
  const long long t0 = kClock ? clock64() : 0;
  int step = 0;
  for (; step < max_steps && !esc; ++step) {
    cable_step(p, ds, x, v, true);
    const T cur = sum_sq3(x, tg);
    const bool cur_inside = inbounds(p, x);
    esc = (inside && !cur_inside) || escaped(p, x, v, static_cast<T>(1));
    if (cur < d2) {
#pragma unroll
      for (int k = 0; k < 3; ++k) { xt[k] = x[k]; vt[k] = v[k]; }
      d2 = cur;
    }
    inside = cur_inside;
  }
  if (kClock) {
    clk[2 * i] = clock64() - t0;
    clk[2 * i + 1] = step;
  }
  store3(xt_out, i, xt);
  store3(vt_out, i, vt);
  d2_out[i] = d2;
}

// ---- K8's first design (backtrace_cable.cu and its shell), verbatim but for the clock ----

template <typename T, bool kClock>
struct CableBackRay {
  Profile<T> p;
  T ds, cap;
  const T *xt, *vt, *dx, *dv;
  int max_steps;
  long long* clk;

  __device__ __forceinline__ void operator()(int i, double* acc) const {
    T x[3], v[3], la[3], mu[3];
    load3(xt, i, x);
    load3(vt, i, v);
    load3(dx, i, la);
    load3(dv, i, mu);
#pragma unroll
    for (int k = 0; k < 3; ++k) mu[k] = mu[k] + ds * la[k];
    bool active = !escaped(p, x, v, static_cast<T>(-1));
    CableRun run;
    const long long t0 = kClock ? clock64() : 0;
    int step = 0;
    for (; step < max_steps && active; ++step) {
#pragma unroll
      for (int k = 0; k < 3; ++k) x[k] = x[k] - ds * v[k];
      T y = fabs(x[1]) <= cap ? static_cast<T>(0) : x[1];
      y = fabs(y - p.length) <= cap ? p.length : y;
      const T xe[3] = {x[0], y, x[2]};

      const Radial<T> rd = first::radial(p, xe);
      T n, rx, xhat[3], fx[3], hess[3];
      value_grad(p, rd, n, rx, xhat, fx);
      hessian(rd, rx, xhat, hess);
      const T dsn = ds * n;
#pragma unroll
      for (int k = 0; k < 3; ++k) v[k] = v[k] - dsn * fx[k];
      active = !escaped(p, xe, v, static_cast<T>(-1));
      cable_adjoint_update(p, ds, rd, n, xhat, fx, hess, active, la, mu, run, acc);
    }
    run.flush(acc);
    if (kClock) {
      clk[2 * i] = clock64() - t0;
      clk[2 * i + 1] = step;
    }
  }
};

template <typename Ray>
__global__ void __launch_bounds__(kThreads)
cable_adjoint_kernel(Ray ray, int res, double* __restrict__ grad_out, int n_rays) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* acc = reinterpret_cast<double*>(smem);
  for (int j = threadIdx.x; j < res; j += blockDim.x) acc[j] = 0.0;
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_rays) ray(i, acc);
  __syncthreads();
  for (int j = threadIdx.x; j < res; j += blockDim.x) {
    const double sum = acc[j];
    if (sum != 0.0) atomicAdd(grad_out + j, sum);
  }
}

}  // namespace first

namespace designs {

// Arithmetic variants (kMath bits), f32 only: kFloorCvt takes floor and the
// conversion to int in one instruction (__float2int_rd, which saturates and
// maps NaN to 0 as the float clamp before the conversion does); kNoSlowPath
// divides and takes square roots as the shipped kernels do (div_rn, sqrt_rn);
// without it, by the operators.
enum { kFloorCvt = 1, kNoSlowPath = 2 };

template <int kMath>
__device__ __forceinline__ float divide(float a, float b) {
  return (kMath & kNoSlowPath) ? div_rn(a, b) : a / b;
}

template <int kMath>
__device__ __forceinline__ float root(float a) {
  return (kMath & kNoSlowPath) ? sqrt_rn(a) : sqrtf(a);
}

// radial(), field_at(), hessian() and cable_adjoint_update() of cylinder.cuh
// with the kMath variants; kNoSlowPath alone is the shipped arithmetic.
template <int kMath>
__device__ __forceinline__ Radial<float> radial_m(const Profile<float>& p, const float x[3]) {
  Radial<float> rd;
  rd.xs0 = x[0] - p.radius;
  rd.xs2 = x[2] - p.radius;
  rd.r = root<kMath>(rd.xs0 * rd.xs0 + rd.xs2 * rd.xs2);
  const float rm = divide<kMath>(rd.r, p.h);
  int i;
  if (kMath & kFloorCvt) {
    i = __float2int_rd(rm);
  } else {
    const float fl = floorf(rm);
    const float lo = -1.0f, hi = static_cast<float>(p.res);
    i = static_cast<int>(fl < lo ? lo : (fl > hi ? hi : fl));
  }
  rd.i0 = i < 0 ? 0 : (i > p.res - 1 ? p.res - 1 : i);
  rd.i1 = rd.i0 + 1 > p.res - 1 ? p.res - 1 : rd.i0 + 1;
  rd.w0 = rm - static_cast<float>(rd.i0);
  rd.w1 = 1.0f - rd.w0;
  rd.small = rd.r < p.eps;
  rd.rs = rd.small ? 1.0f : rd.r;
  return rd;
}

template <int kMath>
__device__ __forceinline__ FieldAt<float> field_at_m(const Profile<float>& p,
                                                     const BinEntry<float>* tab,
                                                     const float x[3]) {
  FieldAt<float> f;
  f.rd = radial_m<kMath>(p, x);
  const BinEntry<float> e = tab[f.rd.i0];
  f.n = e.v0 * f.rd.w1 + e.v1 * f.rd.w0;
  f.rx = e.rx;
  f.xhat[0] = f.rd.small ? 0.0f : divide<kMath>(f.rd.xs0, f.rd.rs);
  f.xhat[1] = 0.0f;
  f.xhat[2] = f.rd.small ? 0.0f : divide<kMath>(f.rd.xs2, f.rd.rs);
#pragma unroll
  for (int k = 0; k < 3; ++k) f.fx[k] = f.rx * f.xhat[k];
  return f;
}

template <int kMath>
__device__ __forceinline__ void hessian_m(const FieldAt<float>& f, float hess[3]) {
  const float scale = f.rd.small ? 0.0f : divide<kMath>(f.rx, f.rd.rs);
  hess[0] = scale * (1.0f - f.xhat[0] * f.xhat[0]);
  hess[1] = scale * (-(f.xhat[0] * f.xhat[2]));
  hess[2] = scale * (1.0f - f.xhat[2] * f.xhat[2]);
}

template <int kMath, typename Acc>
__device__ __forceinline__ void update_m(const Profile<float>& p, float ds,
                                         const FieldAt<float>& f, const float hess[3],
                                         bool splat, float la[3], float mu[3], Acc& acc) {
  const float dn = (mu[0] * f.fx[0] + mu[1] * f.fx[1]) + mu[2] * f.fx[2];
  if (splat) {
    const float val = dn * ds;
    const float g[3] = {f.n * mu[0] * ds, f.n * mu[1] * ds, f.n * mu[2] * ds};
    float gv = (g[0] * f.xhat[0] + g[1] * f.xhat[1]) + g[2] * f.xhat[2];
    if (f.rd.small) gv = 0.0f;
    const float gvh = divide<kMath>(gv, p.h);
    const float c0 = val * f.rd.w1 - gvh;
    const float c1 = val * f.rd.w0 + gvh;
    acc.add(f.rd.i0, f.rd.i1, static_cast<double>(c0), static_cast<double>(c1));
  }
  const float hmu[3] = {hess[0] * mu[0] + hess[1] * mu[2], 0.0f,
                        hess[1] * mu[0] + hess[2] * mu[2]};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    la[k] = la[k] + ds * (dn * f.fx[k] + f.n * hmu[k]);
    mu[k] = mu[k] + ds * la[k];
  }
}

// The field at x from the profile in device memory, as the first design reads it
// and with its arithmetic.
template <typename T>
__device__ __forceinline__ FieldAt<T> field_at_global(const Profile<T>& p, const T x[3]) {
  FieldAt<T> f;
  f.rd = first::radial(p, x);
  first::value_grad(p, f.rd, f.n, f.rx, f.xhat, f.fx);
  return f;
}

// the move of a forward step from the field f at x (cylinder.cuh cable_step)
template <typename T>
__device__ __forceinline__ void move(const FieldAt<T>& f, T ds, T x[3], T v[3]) {
  const T dsn = ds * f.n;
#pragma unroll
  for (int k = 0; k < 3; ++k) v[k] = v[k] + dsn * f.fx[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) x[k] = x[k] + ds * v[k];
}

template <typename T, bool kTable, int kMath>
__device__ __forceinline__ FieldAt<T> eval(const Profile<T>& p, const BinEntry<T>* tab,
                                           const T x[3]) {
  return kTable ? field_at_m<kMath>(p, tab, x) : field_at_global(p, x);
}

template <typename T, bool kTable, bool kEarly, bool kClock, int kMath>
__global__ void __launch_bounds__(kThreads)
k7(Profile<T> p, T ds, const T* __restrict__ x0, const T* __restrict__ v0,
   const T* __restrict__ target, T* __restrict__ xt_out, T* __restrict__ vt_out,
   T* __restrict__ d2_out, long long* clk, int n_rays, int max_steps) {
  extern __shared__ __align__(16) unsigned char smem[];
  BinEntry<T>* tab = reinterpret_cast<BinEntry<T>*>(smem);
  if (kTable) {
    build_bin_table(p, tab);
    __syncthreads();
  }
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  T x[3], v[3], tg[3], xt[3], vt[3];
  load3(x0, i, x);
  load3(v0, i, v);
  load3(target, i, tg);
#pragma unroll
  for (int k = 0; k < 3; ++k) { xt[k] = x[k]; vt[k] = v[k]; }
  T d2 = sum_sq3(x, tg);
  bool inside = inbounds(p, x);
  bool esc = false;
  FieldAt<T> f;
  if (kEarly) f = eval<T, kTable, kMath>(p, tab, x);
  const long long t0 = kClock ? clock64() : 0;
  int step = 0;
  for (; step < max_steps && !esc; ++step) {
    if (!kEarly) f = eval<T, kTable, kMath>(p, tab, x);
    move(f, ds, x, v);
    if (kEarly) f = eval<T, kTable, kMath>(p, tab, x);
    const T cur = sum_sq3(x, tg);
    const bool cur_inside = inbounds(p, x);
    esc = (inside && !cur_inside) || escaped(p, x, v, static_cast<T>(1));
    if (cur < d2) {
#pragma unroll
      for (int k = 0; k < 3; ++k) { xt[k] = x[k]; vt[k] = v[k]; }
      d2 = cur;
    }
    inside = cur_inside;
  }
  if (kClock) {
    clk[2 * i] = clock64() - t0;
    clk[2 * i + 1] = step;
  }
  store3(xt_out, i, xt);
  store3(vt_out, i, vt);
  d2_out[i] = d2;
}

// Where a lane's splats go (kAcc): the block's gradient (kBlock), its warp's
// (kWarp), each as runs with shared atomics (CableRun); its own column of
// the block's gradient, every splat (kColumns) or as runs (kRunColumns).
enum { kBlock, kWarp, kColumns, kRunColumns };

struct LaneColumn {
  double* col;  // slot of bin j at col[j * stride]
  int stride;
  __device__ __forceinline__ void add(int j0, int j1, double c0, double c1) {
    col[j0 * stride] += c0;
    col[j1 * stride] += c1;
  }
  __device__ __forceinline__ void flush() {}
};

struct RunColumn {
  double* col;
  int stride;
  int i0 = -1, i1 = -1;
  double s0 = 0.0, s1 = 0.0;
  __device__ RunColumn(double* c, int s) : col(c), stride(s) {}
  __device__ __forceinline__ void flush() {
    if (i0 >= 0) {
      col[i0 * stride] += s0;
      col[i1 * stride] += s1;
      i0 = -1;
    }
  }
  __device__ __forceinline__ void add(int j0, int j1, double c0, double c1) {
    if (j0 == i0 && j1 == i1) {
      s0 += c0;
      s1 += c1;
      return;
    }
    flush();
    i0 = j0;
    i1 = j1;
    s0 = c0;
    s1 = c1;
  }
};

template <int kAcc>
__host__ __device__ inline int slots(int threads) {
  return kAcc == kBlock ? 1 : (kAcc == kWarp ? (threads + 31) / 32 : threads);
}

template <typename T, bool kTable, bool kEarly, bool kClock, int kMath, typename Acc>
__device__ __forceinline__ void k8_ray(const Profile<T>& p, const BinEntry<T>* tab, T ds, T cap,
                                       const T* xt, const T* vt, const T* dx, const T* dv,
                                       long long* clk, int max_steps, int i, Acc& acc) {
  T x[3], v[3], la[3], mu[3], xe[3];
  load3(xt, i, x);
  load3(vt, i, v);
  load3(dx, i, la);
  load3(dv, i, mu);
#pragma unroll
  for (int k = 0; k < 3; ++k) mu[k] = mu[k] + ds * la[k];
  bool active = !escaped(p, x, v, static_cast<T>(-1));
  auto retreat = [&]() {
#pragma unroll
    for (int k = 0; k < 3; ++k) x[k] = x[k] - ds * v[k];
    T y = fabs(x[1]) <= cap ? static_cast<T>(0) : x[1];
    y = fabs(y - p.length) <= cap ? p.length : y;
    xe[0] = x[0];
    xe[1] = y;
    xe[2] = x[2];
  };
  FieldAt<T> f;
  if (kEarly) {
    retreat();
    f = eval<T, kTable, kMath>(p, tab, xe);
  }
  const long long t0 = kClock ? clock64() : 0;
  int step = 0;
  for (; step < max_steps && active; ++step) {
    if (!kEarly) {
      retreat();
      f = eval<T, kTable, kMath>(p, tab, xe);
    }
    T hess[3];
    hessian_m<kMath>(f, hess);
    const T dsn = ds * f.n;
#pragma unroll
    for (int k = 0; k < 3; ++k) v[k] = v[k] - dsn * f.fx[k];
    active = !escaped(p, xe, v, static_cast<T>(-1));
    update_m<kMath>(p, ds, f, hess, active, la, mu, acc);
    if (kEarly) {
      retreat();
      f = eval<T, kTable, kMath>(p, tab, xe);
    }
  }
  acc.flush();
  if (kClock) {
    clk[2 * i] = clock64() - t0;
    clk[2 * i + 1] = step;
  }
}

template <typename T, int kAcc, bool kTable, bool kEarly, bool kClock, int kMath>
__global__ void __launch_bounds__(kThreads)
k8(Profile<T> p, T ds, T cap, const T* __restrict__ xt, const T* __restrict__ vt,
   const T* __restrict__ dx, const T* __restrict__ dv, double* __restrict__ grad_out,
   long long* clk, int n_rays, int max_steps) {
  extern __shared__ __align__(16) unsigned char smem[];
  BinEntry<T>* tab = reinterpret_cast<BinEntry<T>*>(smem);
  double* acc = reinterpret_cast<double*>(kTable ? smem + table_bytes<T>(p.res) : smem);
  const int ns = slots<kAcc>(blockDim.x);
  if (kTable) build_bin_table(p, tab);
  for (int j = threadIdx.x; j < p.res * ns; j += blockDim.x) acc[j] = 0.0;
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_rays) {
    if (kAcc == kBlock || kAcc == kWarp) {
      CableRun run(kAcc == kBlock ? acc : acc + (threadIdx.x / 32) * p.res);
      k8_ray<T, kTable, kEarly, kClock, kMath>(p, tab, ds, cap, xt, vt, dx, dv, clk, max_steps,
                                               i, run);
    } else if (kAcc == kColumns) {
      LaneColumn col{acc + threadIdx.x, static_cast<int>(blockDim.x)};
      k8_ray<T, kTable, kEarly, kClock, kMath>(p, tab, ds, cap, xt, vt, dx, dv, clk, max_steps,
                                               i, col);
    } else {
      RunColumn col(acc + threadIdx.x, static_cast<int>(blockDim.x));
      k8_ray<T, kTable, kEarly, kClock, kMath>(p, tab, ds, cap, xt, vt, dx, dv, clk, max_steps,
                                               i, col);
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < p.res; j += blockDim.x) {
    double sum = 0.0;
    if (kAcc == kWarp) {
      for (int w = 0; w < ns; ++w) sum += acc[w * p.res + j];
    } else {
      for (int t = 0; t < ns; ++t) sum += acc[j * ns + t];
    }
    if (sum != 0.0) atomicAdd(grad_out + j, sum);
  }
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, int threads, size_t bytes, int n_rays, cudaStream_t stream,
           Args... args) {
  if (n_rays <= 0) return 0;
  const cudaError_t err = allow_shared(kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(n_rays + threads - 1) / threads, threads, bytes, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <bool kTable, bool kEarly, int kMath = 0>
int k7_launch(int threads, const Profile<float>& p, float ds, const float* x0, const float* v0,
              const float* tg, float* xt, float* vt, float* d2, long long* clk, int n,
              int max_steps, cudaStream_t s) {
  const size_t bytes = kTable ? table_bytes<float>(p.res) : 0;
  return clk == nullptr
             ? launch(k7<float, kTable, kEarly, false, kMath>, threads, bytes, n, s, p, ds, x0,
                      v0, tg, xt, vt, d2, clk, n, max_steps)
             : launch(k7<float, kTable, kEarly, true, kMath>, threads, bytes, n, s, p, ds, x0,
                      v0, tg, xt, vt, d2, clk, n, max_steps);
}

template <int kAcc, bool kTable, bool kEarly, int kMath = 0>
int k8_launch(int threads, const Profile<float>& p, float ds, float cap, const float* xt,
              const float* vt, const float* dx, const float* dv, double* g, long long* clk,
              int n, int max_steps, cudaStream_t s) {
  const size_t bytes = (kTable ? table_bytes<float>(p.res) : 0) +
                       static_cast<size_t>(p.res) * slots<kAcc>(threads) * sizeof(double);
  return clk == nullptr
             ? launch(k8<float, kAcc, kTable, kEarly, false, kMath>, threads, bytes, n, s, p, ds,
                      cap, xt, vt, dx, dv, g, clk, n, max_steps)
             : launch(k8<float, kAcc, kTable, kEarly, true, kMath>, threads, bytes, n, s, p, ds,
                      cap, xt, vt, dx, dv, g, clk, n, max_steps);
}

__device__ __forceinline__ unsigned long long mix64(unsigned long long z) {
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
  return z ^ (z >> 31);
}

__global__ void arith_check(int mode, float b, unsigned lo, unsigned hi,
                            unsigned long long* out) {
  unsigned long long wrong = 0, worst = 0;
  const unsigned long long stride = static_cast<unsigned long long>(gridDim.x) * blockDim.x;
  for (unsigned long long k = lo + static_cast<unsigned long long>(blockIdx.x) * blockDim.x +
                              threadIdx.x;
       k < hi; k += stride) {
    bool differ;
    float a;
    if (mode == 0) {
      a = __uint_as_float(static_cast<unsigned>(k));
      differ = __float_as_uint(sqrt_rn(a)) != __float_as_uint(sqrtf(a));
    } else if (mode == 1) {
      a = __uint_as_float(static_cast<unsigned>(k));
      differ = __float_as_uint(div_rn(a, b)) != __float_as_uint(a / b) ||
               __float_as_uint(div_rn(-a, b)) != __float_as_uint(-a / b);
    } else {
      const unsigned long long z = mix64(k);
      const float u = static_cast<float>(z >> 40) * 0x1p-24f;
      const float w = static_cast<float>((z >> 16) & 0xffffffull) * 0x1p-24f;
      const float rs = 1e-6f + 4.0f * u;
      a = (2.0f * w - 1.0f) * rs;
      differ = __float_as_uint(div_rn(a, rs)) != __float_as_uint(a / rs);
    }
    if (differ) {
      ++wrong;
      const unsigned long long bits = __float_as_uint(fabsf(a));
      worst = bits > worst ? bits : worst;
    }
  }
  if (wrong) {
    atomicAdd(out, wrong);
    atomicMax(out + 1, worst);
  }
}

}  // namespace designs
}  // namespace anrt

extern "C" int anrt_arith_check(int mode, float b, unsigned lo, unsigned hi, void* out,
                                void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  anrt::designs::arith_check<<<132 * 16, 256, 0, s>>>(mode, b, lo, hi,
                                                      static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int anrt_k7_design(int design, int threads, const void* prof, int res, double radius,
                              double length, double ds, const void* x0, const void* v0,
                              const void* target, void* xt, void* vt, void* d2, void* clk,
                              int n, int max_steps, void* stream) {
  using namespace anrt;
  auto s = static_cast<cudaStream_t>(stream);
  const Profile<float> p = make_profile<float>(prof, res, radius, length);
  const float fds = static_cast<float>(ds);
  auto cx0 = static_cast<const float*>(x0), cv0 = static_cast<const float*>(v0);
  auto ctg = static_cast<const float*>(target);
  auto oxt = static_cast<float*>(xt), ovt = static_cast<float*>(vt);
  auto od2 = static_cast<float*>(d2);
  auto ck = static_cast<long long*>(clk);
  switch (design) {
    case 0:
      return ck == nullptr
                 ? designs::launch(first::trace_cable_kernel<float, false>, threads, 0, n, s, p,
                                   fds, cx0, cv0, ctg, oxt, ovt, od2, ck, n, max_steps)
                 : designs::launch(first::trace_cable_kernel<float, true>, threads, 0, n, s, p,
                                   fds, cx0, cv0, ctg, oxt, ovt, od2, ck, n, max_steps);
    case 1:
      return designs::k7_launch<true, false>(threads, p, fds, cx0, cv0, ctg, oxt, ovt, od2, ck,
                                             n, max_steps, s);
    case 2:
      return designs::k7_launch<false, true>(threads, p, fds, cx0, cv0, ctg, oxt, ovt, od2, ck,
                                             n, max_steps, s);
    case 3:
      return designs::k7_launch<true, true>(threads, p, fds, cx0, cv0, ctg, oxt, ovt, od2, ck,
                                            n, max_steps, s);
    case 4:
      return designs::k7_launch<true, false, designs::kFloorCvt>(
          threads, p, fds, cx0, cv0, ctg, oxt, ovt, od2, ck, n, max_steps, s);
    case 5:
      return designs::k7_launch<true, false, designs::kNoSlowPath>(
          threads, p, fds, cx0, cv0, ctg, oxt, ovt, od2, ck, n, max_steps, s);
    case 6:
      return designs::k7_launch<true, false, designs::kFloorCvt | designs::kNoSlowPath>(
          threads, p, fds, cx0, cv0, ctg, oxt, ovt, od2, ck, n, max_steps, s);
    case 7:
      return designs::k7_launch<true, true, designs::kNoSlowPath>(
          threads, p, fds, cx0, cv0, ctg, oxt, ovt, od2, ck, n, max_steps, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int anrt_k8_design(int design, int threads, const void* prof, int res, double radius,
                              double length, double ds, double cap, const void* xt,
                              const void* vt, const void* dx, const void* dv, void* grad_out,
                              void* clk, int n, int max_steps, void* stream) {
  using namespace anrt;
  using designs::k8_launch;
  auto s = static_cast<cudaStream_t>(stream);
  const Profile<float> p = make_profile<float>(prof, res, radius, length);
  const float fds = static_cast<float>(ds), fcap = static_cast<float>(cap);
  auto cxt = static_cast<const float*>(xt), cvt = static_cast<const float*>(vt);
  auto cdx = static_cast<const float*>(dx), cdv = static_cast<const float*>(dv);
  auto g = static_cast<double*>(grad_out);
  auto ck = static_cast<long long*>(clk);
  switch (design) {
    case 0: {
      if (ck == nullptr) {
        first::CableBackRay<float, false> ray{p, fds, fcap, cxt, cvt, cdx, cdv, max_steps,
                                                    ck};
        return designs::launch(first::cable_adjoint_kernel<decltype(ray)>, threads,
                               res * sizeof(double), n, s, ray, res, g, n);
      }
      first::CableBackRay<float, true> ray{p, fds, fcap, cxt, cvt, cdx, cdv, max_steps, ck};
      return designs::launch(first::cable_adjoint_kernel<decltype(ray)>, threads,
                             res * sizeof(double), n, s, ray, res, g, n);
    }
    case 1:
      return k8_launch<designs::kBlock, true, false>(threads, p, fds, fcap, cxt, cvt, cdx, cdv, g,
                                                     ck, n, max_steps, s);
    case 2:
      return k8_launch<designs::kBlock, true, true>(threads, p, fds, fcap, cxt, cvt, cdx, cdv, g,
                                                    ck, n, max_steps, s);
    case 3:
      return k8_launch<designs::kWarp, true, true>(threads, p, fds, fcap, cxt, cvt, cdx, cdv, g,
                                                   ck, n, max_steps, s);
    case 4:
      return k8_launch<designs::kColumns, true, true>(threads, p, fds, fcap, cxt, cvt, cdx, cdv,
                                                      g, ck, n, max_steps, s);
    case 5:
      return k8_launch<designs::kRunColumns, true, true>(threads, p, fds, fcap, cxt, cvt, cdx,
                                                         cdv, g, ck, n, max_steps, s);
    case 6:
      return k8_launch<designs::kColumns, false, true>(threads, p, fds, fcap, cxt, cvt, cdx, cdv,
                                                       g, ck, n, max_steps, s);
    case 7:
      return k8_launch<designs::kColumns, true, false>(threads, p, fds, fcap, cxt, cvt, cdx, cdv,
                                                       g, ck, n, max_steps, s);
    case 8:
      return k8_launch<designs::kColumns, true, false, designs::kFloorCvt>(
          threads, p, fds, fcap, cxt, cvt, cdx, cdv, g, ck, n, max_steps, s);
    case 9:
      return k8_launch<designs::kColumns, true, false, designs::kNoSlowPath>(
          threads, p, fds, fcap, cxt, cvt, cdx, cdv, g, ck, n, max_steps, s);
    case 10:
      return k8_launch<designs::kColumns, true, false, designs::kFloorCvt | designs::kNoSlowPath>(
          threads, p, fds, fcap, cxt, cvt, cdx, cdv, g, ck, n, max_steps, s);
    case 11:
      return k8_launch<designs::kColumns, true, true, designs::kNoSlowPath>(
          threads, p, fds, fcap, cxt, cvt, cdx, cdv, g, ck, n, max_steps, s);
    case 12:
      return k8_launch<designs::kBlock, true, false, designs::kNoSlowPath>(
          threads, p, fds, fcap, cxt, cvt, cdx, cdv, g, ck, n, max_steps, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
