// Trilinear voxel-field routines shared by the stepper kernels of the port:
// clamped 8-corner fetch, value, gradient, off-diagonal Hessian, the splat
// (transpose of value + gradient), the per-ray run of splats that the
// adjoints sum in registers before they add them anywhere, and the two step
// bodies: the forward step (K2, K5 and K6's replay) and the adjoint update
// after an evaluation (K3 and K6).
//
// Semantics are those of fields/grid.py: data[z, y, x] with p = (x, y, z),
// flat index (z*H + y)*W + x, pm = p / h as a true division, both corners
// clamped to [0, res-1] per corner, a masked lane gathers 0, the gradient and
// the gradient part of the splat carry 1/h.  The arithmetic repeats the plain
// torch version operation by operation; compile with -fmad=false so that
// floor(), inbounds() and escaped() decide alike on nodes and faces.
//
// What bounds them on the card: the corner reads are L1/L2 hits (the grid is
// at most 8.4 MB here) whose cost is how many distinct lines a warp touches,
// so the callers run rays in a coherent order (tracer/order.py); the splat's
// cost is its atomic adds, so SplatRun keeps one cell's 8 sums in registers
// while a ray stays in that cell and adds them once when it leaves, and the
// lanes of a warp that leave the same cell at once add their sums together.
#pragma once

#include <cuda_runtime.h>

#include <cmath>

namespace anrt {

// A grid, or a z-window of one: `data` holds the voxel rows [z_first,
// z_first + rows) of a (D, H, W) grid (the whole grid: z_first 0, rows D).
// Positions, clamping and faces are the whole grid's; only the rows a
// stencil reads must lie in the window (the slab ring's kernels, K21 and K22,
// step a ray only while its cell row is one the window holds: cell_row,
// holds_row).
template <typename T>
struct Grid {
  const T* data;   // (rows, H, W) contiguous
  int W, H, D;     // res_x, res_y, res_z of the whole grid
  int z_first;     // the whole grid's row of data's first row (may be -1)
  int rows;        // rows in data
  T h;             // voxel spacing
  T inv_h;         // 1/h, rounded from double as the plain version does
  T inv_h2;        // 1/(h*h), likewise
  T hi[3];         // upper face per axis: (res - 1) * h in T
  double h64;      // h in f64, and its reciprocal rounded to f64: div_h's divisor
  double rcp64;
  bool rcp_exact;  // h64 a power of two with an exact reciprocal (exact_reciprocal)
};

// Whether h is a power of two whose reciprocal f64 holds exactly: 2^k with k
// >= -1023 (frexp gives 0.5 * 2^(k+1)).  Then a / h and a * (1/h) are the
// same real number a * 2^-k rounded once, so they round alike for every f64
// a: zeros, infinities, subnormal and overflowing quotients included (NaN
// stays NaN).  kernels/wrappers.py::exact_reciprocal is its twin on the host.
__host__ inline bool exact_reciprocal(double h) {
  int e = 0;
  const double m = std::frexp(h, &e);
  return m == 0.5 && e >= -1022;
}

template <typename T>
__host__ inline Grid<T> make_grid(const void* data, int W, int H, int D, double h,
                                  int z_first = 0, int rows = -1) {
  Grid<T> g;
  g.data = static_cast<const T*>(data);
  g.W = W; g.H = H; g.D = D;
  g.z_first = z_first;
  g.rows = rows < 0 ? D : rows;
  g.h = static_cast<T>(h);
  g.inv_h = static_cast<T>(1.0 / h);
  g.inv_h2 = static_cast<T>(1.0 / (h * h));
  g.hi[0] = static_cast<T>(W - 1) * g.h;
  g.hi[1] = static_cast<T>(H - 1) * g.h;
  g.hi[2] = static_cast<T>(D - 1) * g.h;
  g.h64 = static_cast<double>(g.h);
  g.rcp64 = 1.0 / g.h64;
  g.rcp_exact = exact_reciprocal(g.h64);
  return g;
}

// a / g.h, rounded to nearest as the operator rounds it, for every a.  An
// f64 grid whose spacing is a power of two (rcp_exact: the 2008 baseline's
// 65^3 fuel volume, h = 1/64) multiplies by the exact reciprocal; any other
// f64 grid takes the operator, whose reciprocal seed, refinement, operand
// check and slow-path call take K20's step from 161 instructions to 225
// (PERF.md).  K20 takes the choice out of its loop (with_division); the
// other kernels test the flag, which is the same for every thread.  For f32 the
// operator compiles to a fast path, a check of its operands (FCHK) and a
// call to a slow path in a branch region of its own, three a step in the
// stencil; the scheduler does not reach across those regions (as in the
// cable stepper, cylinder.cuh div_rn).  Here the quotient is taken in f64
// with no branch: q = a * RN(1/h) is within an ulp of a/h, r = h*q - a is exact
// and q - RN(1/h)*r is a/h rounded to f64 (Markstein's correction; a and h
// carry 24 bits, far inside f64's range, so nothing under- or overflows);
// rounding that to f32 gives the f32 quotient, since f64 holds more than
// twice f32's bits plus two (a double rounding of a quotient is then
// innocuous, subnormal and overflowing quotients included).  Signed zeros
// come out with the dividend's sign; +-inf passes through a select (h*inf
// - inf would make NaN); NaN gives NaN.  chip_smoke.py holds it to the
// operator on the card for every one of the 2^32 dividends at each spacing
// its scenes use.
template <typename T>
__device__ __forceinline__ T div_h(const Grid<T>& g, T a) {
  return a / g.h;
}

template <>
__device__ __forceinline__ double div_h<double>(const Grid<double>& g, double a) {
  return g.rcp_exact ? a * g.rcp64 : a / g.h;
}

// body(grid) with an f64 grid's rcp_exact a constant the compiler sees, so
// that the loop inside holds either the multiply or the operator, not a test
// of the flag at each of its divisions; an f32 grid goes as it is.
template <typename T, typename Body>
__device__ __forceinline__ void with_division(const Grid<T>& g, Body body) {
  if constexpr (sizeof(T) == sizeof(double)) {
    Grid<T> f = g;
    if (g.rcp_exact) {
      f.rcp_exact = true;
      body(f);
    } else {
      f.rcp_exact = false;
      body(f);
    }
  } else {
    body(g);
  }
}

template <>
__device__ __forceinline__ float div_h<float>(const Grid<float>& g, float a) {
#ifdef ANRT_DIV_OPERATOR  // the operator, as a yardstick (tools/fwd_designs.py)
  return a / g.h;
#else
  const double ad = a;
  const double q = ad * g.rcp64;
  const double r = fma(g.h64, q, -ad);
  const float f = static_cast<float>(fma(-g.rcp64, r, q));
  return isinf(a) ? a : f;
#endif
}

// The 8 corners of the cell that holds p: flat indices idx[a][b][c]
// (a: x-corner, b: y-corner, c: z-corner) and the fractional offsets w0.
template <typename T>
struct Stencil {
  int idx[2][2][2];
  T w0[3];
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Whether an f32 stencil converts its cell with a saturating conversion and
// takes its 8 indices from one base index and three offsets: the same
// corners in fewer instructions, 3-8 % off the f32 forward kernels, up to 6
// % off the backward ones, K3 and K6 level.  Not in f64 (K20 2 % slower),
// nor in a source that defines ANRT_FULL_INDEX before this header (slab.cu:
// K21, freed of 8 registers, ran more blocks an SM and lost 7 % to its band
// sweeps; PERF.md).
#ifdef ANRT_FULL_INDEX
template <typename T>
constexpr bool kOffsetIndex = false;
#else
template <typename T>
constexpr bool kOffsetIndex = sizeof(T) == sizeof(float);
#endif

// The clamped corner nodes c[axis][0 or 1] of the cell that holds p, and the
// fractional offsets w0: what stencil() computes before the flat indices.
template <typename T>
__device__ __forceinline__ void corner_cells(const Grid<T>& g, const T p[3], int c[3][2],
                                             T w0[3]) {
  const int res[3] = {g.W, g.H, g.D};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const T pm = div_h(g, p[k]);
    const T posf = floor(pm);
    w0[k] = pm - posf;  // may leave [0, 1] off-grid
    int pos;
    if constexpr (kOffsetIndex<T>) {
      // the conversion saturates (NaN gives 0), and min() keeps pos + 1 from
      // overflowing: the corners of the clamp in floating point below, with
      // fewer instructions
      pos = min(__float2int_rz(posf), res[k]);
    } else {
      // clamp in floating point first so the cast to int cannot overflow
      const T lo = static_cast<T>(-2), hi = static_cast<T>(res[k] + 1);
      pos = static_cast<int>(posf < lo ? lo : (posf > hi ? hi : posf));
    }
    c[k][0] = clampi(pos, 0, res[k] - 1);
    c[k][1] = clampi(pos + 1, 0, res[k] - 1);
  }
}

// The stencil of the corner nodes c and offsets w0 (corner_cells).
template <typename T>
__device__ __forceinline__ Stencil<T> stencil_of(const Grid<T>& g, const int c[3][2],
                                                 const T w0[3]) {
  Stencil<T> s;
#pragma unroll
  for (int k = 0; k < 3; ++k) s.w0[k] = w0[k];
  if constexpr (kOffsetIndex<T>) {
    // one base index and the steps to the far corners (0 where a corner is
    // clamped onto the near one): the same indices in fewer instructions
    const int base = ((c[2][0] - g.z_first) * g.H + c[1][0]) * g.W + c[0][0];
    const int off[3] = {c[0][1] - c[0][0], (c[1][1] - c[1][0]) * g.W,
                        (c[2][1] - c[2][0]) * (g.W * g.H)};
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc)
          s.idx[a][b][cc] = base + (a ? off[0] : 0) + (b ? off[1] : 0) + (cc ? off[2] : 0);
  } else {
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc)
          s.idx[a][b][cc] = ((c[2][cc] - g.z_first) * g.H + c[1][b]) * g.W + c[0][a];
  }
  return s;
}

template <typename T>
__device__ __forceinline__ Stencil<T> stencil(const Grid<T>& g, const T p[3]) {
  int c[3][2];
  T w0[3];
  corner_cells(g, p, c, w0);
  return stencil_of(g, c, w0);
}

// The cell row of p on z: that of the JAX package's cell table
// (fields/cells.py: clip(floor(z/h), -1, D-1) + 1, in [0, D]), whose corners
// are the voxel rows cz-1 and cz, clamped.
template <typename T>
__device__ __forceinline__ int cell_row(const Grid<T>& g, const T p[3]) {
  const T posf = floor(div_h(g, p[2]));
  const T lo = static_cast<T>(-1), hi = static_cast<T>(g.D - 1);
  return static_cast<int>(posf < lo ? lo : (posf > hi ? hi : posf)) + 1;
}

// Whether the voxel rows [first, first + rows) hold the cell row cz: they
// hold the cell rows [first + 1, first + rows).
__device__ __forceinline__ bool holds_row(int cz, int first, int rows) {
  return cz > first && cz < first + rows;
}

// Corner values v[a][b][c]; a masked lane reads nothing and gets zeros.
template <typename T>
__device__ __forceinline__ void fetch(const Grid<T>& g, const Stencil<T>& s, bool mask,
                                      T v[2][2][2]) {
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        v[a][b][c] = mask ? __ldg(g.data + s.idx[a][b][c]) : static_cast<T>(0);
}

// Value n and gradient grad (with 1/h) from the corner values.
template <typename T>
__device__ __forceinline__ void value_grad(const Grid<T>& g, const T v[2][2][2],
                                           const T w0[3], T& n, T grad[3]) {
  const T wx[2] = {static_cast<T>(1) - w0[0], w0[0]};
  const T wy[2] = {static_cast<T>(1) - w0[1], w0[1]};
  const T wz[2] = {static_cast<T>(1) - w0[2], w0[2]};

  T vy[2][2], vyz[2];  // vy[a][c], vyz[a]
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int c = 0; c < 2; ++c) vy[a][c] = wy[0] * v[a][0][c] + wy[1] * v[a][1][c];
    vyz[a] = wz[0] * vy[a][0] + wz[1] * vy[a][1];
  }
  n = wx[0] * vyz[0] + wx[1] * vyz[1];
  grad[0] = (vyz[1] - vyz[0]) * g.inv_h;

  T vx[2][2], vxz[2];  // vx[b][c], vxz[b]
#pragma unroll
  for (int b = 0; b < 2; ++b) {
#pragma unroll
    for (int c = 0; c < 2; ++c) vx[b][c] = wx[0] * v[0][b][c] + wx[1] * v[1][b][c];
    vxz[b] = wz[0] * vx[b][0] + wz[1] * vx[b][1];
  }
  grad[1] = (vxz[1] - vxz[0]) * g.inv_h;

  T vxy[2];  // vxy[c]
#pragma unroll
  for (int c = 0; c < 2; ++c) vxy[c] = wy[0] * vx[0][c] + wy[1] * vx[1][c];
  grad[2] = (vxy[1] - vxy[0]) * g.inv_h;
}

// Off-diagonal Hessian (dxdy, dxdz, dydz), with 1/h^2.
template <typename T>
__device__ __forceinline__ void hessian(const Grid<T>& g, const T v[2][2][2],
                                        const T w0[3], T hess[3]) {
  const T xy0 = v[1][1][0] - v[0][1][0] - v[1][0][0] + v[0][0][0];
  const T xy1 = v[1][1][1] - v[0][1][1] - v[1][0][1] + v[0][0][1];
  const T xz0 = v[1][0][1] - v[0][0][1] - v[1][0][0] + v[0][0][0];
  const T xz1 = v[1][1][1] - v[0][1][1] - v[1][1][0] + v[0][1][0];
  const T yz0 = v[0][1][1] - v[0][0][1] - v[0][1][0] + v[0][0][0];
  const T yz1 = v[1][1][1] - v[1][0][1] - v[1][1][0] + v[1][0][0];
  hess[0] = (xy0 + w0[2] * (xy1 - xy0)) * g.inv_h2;
  hess[1] = (xz0 + w0[1] * (xz1 - xz0)) * g.inv_h2;
  hess[2] = (yz0 + w0[0] * (yz1 - yz0)) * g.inv_h2;
}

// Transpose of value_grad with respect to the voxel data: the 8 corner terms
// val * B_i(p) + grad . dB_i(p), in the plain version's order of operations.
template <typename T>
__device__ __forceinline__ void splat_terms(const Grid<T>& g, const Stencil<T>& s, T val,
                                            const T grad[3], T out[2][2][2]) {
  const T wx[2] = {static_cast<T>(1) - s.w0[0], s.w0[0]};
  const T wy[2] = {static_cast<T>(1) - s.w0[1], s.w0[1]};
  const T wz[2] = {static_cast<T>(1) - s.w0[2], s.w0[2]};
  const T sgn[2] = {static_cast<T>(-1), static_cast<T>(1)};
  const T gx = grad[0] * g.inv_h, gy = grad[1] * g.inv_h, gz = grad[2] * g.inv_h;
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        out[a][b][c] = val * wx[a] * wy[b] * wz[c] + gx * sgn[a] * wy[b] * wz[c] +
                       gy * wx[a] * sgn[b] * wz[c] + gz * wx[a] * wy[b] * sgn[c];
}

// The splats of one ray into one cell, summed in registers.  A run is the
// steps between two changes of the clamped stencil (the same 8 indices:
// idx[0][0][0] and idx[1][1][1] fix the clamped corners on every axis); its
// 8 sums go to acc (device or shared memory) when the ray leaves the cell and
// at the end of the ray, so acc sees one add a corner per run instead of one
// per step.  Lanes of a warp that flush runs of the same stencil at the same
// time (neighbouring rays in a coherent order do) first sum them with
// shuffles, and one of them issues the 8 atomicAdds.  The order of the adds
// is not fixed, so the sum is reproducible to rounding only, not bitwise.
// Acc is the type of the adds (the terms' type T for K3 and K6; double for
// K14, whose f32 terms are added in f64), Sum the type of the run and the
// lanes' sums (Acc for K3 and K6; the terms' type for K14).
template <typename T, typename Acc = T, typename Sum = Acc>
struct SplatRun {
  int idx[2][2][2];
  Sum sum[2][2][2];
  bool open = false;
  int flushes = 0;  // runs this lane flushed (one a run)
  int issued = 0;   // flushes this lane issued for its group of lanes (8 adds each)

  // Called by every lane of the warp that is at this point; flushes the runs
  // of the lanes whose `cond` holds.
  __device__ __forceinline__ void flush_if(Acc* acc, bool cond) {
    const unsigned active = __activemask();
    if (!__any_sync(active, cond)) return;
    const unsigned long long key =
        cond ? (static_cast<unsigned long long>(idx[0][0][0]) << 32) |
                   static_cast<unsigned>(idx[1][1][1])
             : ~0ULL;  // never a stencil's key: indices are below 2^31
    unsigned peers = __match_any_sync(active, key);
    if (!cond) peers = 0u;  // a lane that keeps its run takes no part in the sums
    const int lane = threadIdx.x & 31;
    const bool leader = lane == __ffs(peers) - 1;
    // tree sum over the peers into the lowest one (after Westphal,
    // "voting and shuffling to optimize atomic operations")
    int rank = __popc(peers & ((1u << lane) - 1u));
    peers &= ~((2u << lane) - 1u);  // the peers above this lane
    while (__any_sync(active, peers != 0u)) {
      const int next = __ffs(peers) - 1;
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const Sum t = __shfl_sync(active, sum[a][b][c], next < 0 ? lane : next);
            if (next >= 0) sum[a][b][c] = sum[a][b][c] + t;
          }
      peers &= ~__ballot_sync(active, rank & 1);  // odd ranks have been summed
      rank >>= 1;
    }
    if (cond && leader) {
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            atomicAdd(acc + idx[a][b][c], static_cast<Acc>(sum[a][b][c]));
      ++issued;
    }
    if (cond) {
      ++flushes;
      open = false;
    }
  }

  // One step of the ray, called by every lane at this point of the step: adds
  // the step's terms to the run when `splat` holds and the stencil is the
  // run's, else flushes the run first and starts another with them.
  __device__ __forceinline__ void step(Acc* acc, bool splat, const Stencil<T>& s,
                                       const T terms[2][2][2]) {
    const bool same =
        splat && open && idx[0][0][0] == s.idx[0][0][0] && idx[1][1][1] == s.idx[1][1][1];
    flush_if(acc, splat && open && !same);
    if (!splat) return;
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          if (same) {
            sum[a][b][c] = sum[a][b][c] + static_cast<Sum>(terms[a][b][c]);
          } else {
            sum[a][b][c] = static_cast<Sum>(terms[a][b][c]);
            idx[a][b][c] = s.idx[a][b][c];
          }
        }
    open = true;
  }
};

// p inside [0, hi) on every axis.  Here and in escaped() the tests are
// combined with & and |, not && and ||: every one is cheap and has no side
// effect, and a short-circuit compiles to branches, each in a region of its
// own that the scheduler does not reach across (four of them cost the
// forward step loop 9-11 %, PERF.md).
template <typename T>
__device__ __forceinline__ bool inbounds(const Grid<T>& g, const T p[3]) {
  return (p[0] >= 0) & (p[0] < g.hi[0]) & (p[1] >= 0) & (p[1] < g.hi[1]) & (p[2] >= 0) &
         (p[2] < g.hi[2]);
}

// Outside the grid and moving away, on any axis; sign = -1 tests against -v.
template <typename T>
__device__ __forceinline__ bool escaped(const Grid<T>& g, const T p[3], const T v[3],
                                        T sign) {
  bool esc = false;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const T vk = sign * v[k];
    esc = esc | ((p[k] < 0) & (vk < 0)) | ((p[k] >= g.hi[k]) & (vk > 0));
  }
  return esc;
}

// One forward step from (x, v) with eval mask `inside`: v += ds*n*grad n
// (a masked ray keeps v), x += ds*v; returns inbounds(x) at the new x.  The
// one copy of the stepper: K2, K5 and the replay of K6 call it, so a replayed
// trajectory is the forward's bit for bit.
template <typename T>
__device__ __forceinline__ bool forward_step(const Grid<T>& g, T ds, T x[3], T v[3],
                                             bool inside) {
  if (inside) {  // a masked lane has n = 0, grad = 0: v is unchanged
    const Stencil<T> s = stencil(g, x);
    T c[2][2][2], n, grad[3];
    fetch(g, s, true, c);
    value_grad(g, c, s.w0, n, grad);
    const T dsn = ds * n;
#pragma unroll
    for (int k = 0; k < 3; ++k) v[k] = v[k] + dsn * grad[k];
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) x[k] = x[k] + ds * v[k];
  return inbounds(g, x);
}

// The adjoint's update at one step, after the field was evaluated there
// (stencil s, n, grad n, Hessian; zeros where the step does not evaluate):
// the splat (dn*ds, n*mu*ds) with dn = mu . grad n joins the ray's run when
// `splat` holds (every lane at this point calls it: the warp's lanes flush
// together), then la += ds*(dn*grad n + n*H mu), mu += ds*la.  K3, K6 and
// their variants call it; each evaluates the field itself, in its own
// branch.  Run: a SplatRun, whose runs go to the accumulator `acc` (Sink =
// Acc*), or another run with its own sink (K18's and K19's PairRun in
// backtrace_exact.cu); S: the stencil the run takes (a Stencil, or one that
// carries more of the cell for a run that keys on it).
template <typename T, typename S, typename Run, typename Sink>
__device__ __forceinline__ void adjoint_update(const Grid<T>& g, T ds, const S& s, T n,
                                               const T grad[3], const T hess[3], bool splat,
                                               T la[3], T mu[3], Run& run, Sink acc) {
  const T dn = mu[0] * grad[0] + mu[1] * grad[1] + mu[2] * grad[2];
  T terms[2][2][2];
  if (splat) {
    const T dnx[3] = {n * mu[0] * ds, n * mu[1] * ds, n * mu[2] * ds};
    splat_terms(g, s, dn * ds, dnx, terms);
  }
  run.step(acc, splat, s, terms);
  const T hmu[3] = {hess[0] * mu[1] + hess[1] * mu[2], hess[0] * mu[0] + hess[2] * mu[2],
                    hess[1] * mu[0] + hess[2] * mu[1]};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    la[k] = la[k] + ds * (dn * grad[k] + n * hmu[k]);
    mu[k] = mu[k] + ds * la[k];
  }
}

// The field's value at p, its corners clamped and read unmasked, as
// value_grad gives it (the gradient is computed and dropped: the compiler
// removes it): the sdf's "inside" with a stencil of its own
// (SdfRule::inside, rules.cuh).
template <typename T>
__device__ __forceinline__ T value_at(const Grid<T>& g, const T p[3]) {
  const Stencil<T> s = stencil(g, p);
  T c[2][2][2], n, grad[3];
  fetch(g, s, true, c);
  value_grad(g, c, s.w0, n, grad);
  return n;
}

// Coordinates within tol cells of a node are moved onto it.
template <typename T>
__device__ __forceinline__ void snap_to_nodes(const Grid<T>& g, const T p[3], T tol,
                                              T out[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    T pm = div_h(g, p[k]);
    const T r = rint(pm);  // round half to even, as torch.round
    if (fabs(pm - r) <= tol) pm = r;
    out[k] = pm * g.h;
  }
}

template <typename T>
__device__ __forceinline__ void load3(const T* base, int i, T out[3]) {
  out[0] = base[3 * i]; out[1] = base[3 * i + 1]; out[2] = base[3 * i + 2];
}

template <typename T>
__device__ __forceinline__ void store3(T* base, int i, const T in[3]) {
  base[3 * i] = in[0]; base[3 * i + 1] = in[1]; base[3 * i + 2] = in[2];
}

// The ray a thread works on: order[i] where the caller gave an order.
__device__ __forceinline__ int ray_of(const int* order, int i) {
  return order == nullptr ? i : __ldg(order + i);
}

constexpr int kThreads = 128;

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace anrt
