// The split of the exact backward ray (K6, K18, K19) and the designs tried on
// the way to the shipped K18 and K19, timed beside the shipped kernels by
// tools/exact_designs.py; no path of the port launches them.  f32 grids only.
//
// anrt_exact_split(rule, mode, tile_bytes, reuse, f32_sums, ...) takes the
// shipped kernels' arguments (rule 0: K6's volume rule, 1: K18's plane, 2:
// K19's sdf, whose sums go to a double gradient) and runs
//   mode 0  the ray of backtrace_exact.cu with SplatRun's runs (kSplatRun):
//           K6 as shipped, and K18 and K19 as they were before PairRun (K19
//           with f64 sums)
//   mode 11 the ray with PairRun's runs (kPairRun): K18 as shipped; with reuse
//           and f32_sums as below, K19's choices (K19 ships both)
//   mode 12 mode 11 in a kernel held to 5 blocks of 128 threads an SM
//   mode 13 the same, 6 blocks
//   mode 14 mode 11 with its reverse step in fused multiply-adds (FusedRay)
//   mode 9  the ray with FaceRun's runs (below), carried across faces
//   mode 10 the ray with FaceRun's runs, every run's 8 sums added as x-pairs
//   mode 1  (a) SplitRay below, a copy of mode 0's ray whose run (SplitRun)
//           can send its adds elsewhere: as mode 0; with reuse, (e) the sdf
//           read sharing the next evaluation's stencil; with f32_sums, (f)
//           run and warp sums in f32, the adds in f64 (sdf only)
//   mode 2  (b) the replay alone: the same segments and stretches, the
//           positions and inside bits into the local buffer, each position
//           read back once in reverse; no reverse step
//   mode 3  (c) the replay and the reverse evaluation (stencil, corners,
//           value, gradient, Hessian, the 8 splat terms, the la/mu update),
//           the terms folded into a sum a thread writes: no run, no adds
//   mode 4  (d) as mode 1, the leader's 8 adds sent to one scratch word a
//           warp (`probe`) instead of the gradient
//   mode 6  (d') as mode 1 with no adds: the leader folds the run's sums into
//           a register sum a thread writes to probe[i]
//   mode 7  as mode 1 without the warp sums: every lane adds its own run
//   mode 8  as mode 1, the adds of each x-pair of corners that lies in one
//           aligned group of 4 words one float4 add (f32 sums only)
//   mode 5  the tile path (TileRay below, not shipped) with a tile of
//           tile_bytes (0: no tile, every run to device memory from the
//           block in step), reuse and f32_sums as above; `boxes` (null, or a
//           counter, its capacity and room for the node count of each
//           block-stretch's box); its tally is TileTally's
// Modes 2, 3 and 6 write a thread's sum to probe[i] so that no work is dropped.
#include "adjoint.cuh"
#include "backtrace_exact.cu"

namespace anrt {

// The face runs measured (modes 9, 10), not shipped: runs keyed by
// the cell's corner nodes, whose sums go on into the next cell where the ray
// crosses one face (kCarry), through the shipped ExactRay as run kinds 2 and 3
// (RunOf below); their tally's fourth counter is the runs that ended across
// one face.
// A stencil with its clamped corner nodes (corner_cells): FaceRun keys its
// runs by the nodes.
template <typename T>
struct CellStencil : Stencil<T> {
  int c[3][2];
};

template <typename T>
__device__ __forceinline__ CellStencil<T> cell_stencil(const Grid<T>& g, const T p[3]) {
  CellStencil<T> s;
  corner_cells(g, p, s.c, s.w0);
  static_cast<Stencil<T>&>(s) = stencil_of(g, s.c, s.w0);
  return s;
}

// Where a FaceRun's adds go: the flat sum in device memory of the grid's shape.
template <typename Acc>
struct FaceSink {
  Acc* out;
  int W, H, z_first, n_cells;
};

// Adds s0, s1 to out[i0], out[i1]; where i1 = i0 + 1 lies in the same
// aligned group of 4 f32 words, as one float4 add (zeros in the other two
// words).  Returns the atomic adds issued.
__device__ __forceinline__ int face_add_pair(const FaceSink<float>& sink, int i0, int i1, float s0,
                                        float s1) {
#if ANRT_VECTOR_ATOMICS
  const int base = i0 & ~3, k = i0 & 3;
  if (i1 == i0 + 1 && k != 3 && base + 3 < sink.n_cells) {
    atomicAdd(reinterpret_cast<float4*>(sink.out + base),
              make_float4(k == 0 ? s0 : 0.f, k == 0 ? s1 : (k == 1 ? s0 : 0.f),
                          k == 1 ? s1 : (k == 2 ? s0 : 0.f), k == 2 ? s1 : 0.f));
    return 1;
  }
#endif
  atomicAdd(sink.out + i0, s0);
  atomicAdd(sink.out + i1, s1);
  return 2;
}

__device__ __forceinline__ int face_add_pair(const FaceSink<double>& sink, int i0, int i1,
                                             double s0, double s1) {
  atomicAdd(sink.out + i0, s0);
  atomicAdd(sink.out + i1, s1);
  return 2;
}

// SplatRun (trilinear.cuh) keyed by the cell's corner nodes, whose sums go on
// into the next cell where the ray crosses one face of its cell into the
// neighbour: the 4 nodes of the face it crossed are the neighbour's too, so
// only the 4 it leaves behind are added and the 4 on the face are carried.
// The warp's lanes that end runs in the same cell across the same face (or
// leaving it altogether) sum them first, as SplatRun's lanes do, and one
// adds them: 4 words (a face across x) or 2 x-pairs, or all 8 as 4 x-pairs.
// Every change of cell ends a run (`flushes`, the plain version's count),
// whatever is carried.  Sum: the type of the run's and the warp's sums; Acc:
// the sum in device memory's; without kCarry every run adds all 8 sums (as 4
// x-pairs).
template <typename T, typename Sum, typename Acc, bool kCarry>
struct FaceRun {
  int c[3][2];
  Sum sum[2][2][2];
  bool open = false;
  int flushes = 0, issued = 0, adds = 0, faces = 0;

  // 1 + 2 * axis + (one cell down): s's cell is the neighbour across one face
  // of the run's (both cells' nodes equal on the other axes); else 0
  __device__ __forceinline__ int face_to(const int n[3][2]) const {
    int code = 0, moved = 0;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (n[k][0] == c[k][0] && n[k][1] == c[k][1]) continue;
      ++moved;
      const bool up = n[k][0] == c[k][1] && n[k][1] == c[k][1] + 1;
      const bool down = n[k][1] == c[k][0] && n[k][0] == c[k][0] - 1;
      code = up ? 1 + 2 * k : (down ? 2 + 2 * k : 0);
    }
    return moved == 1 ? code : 0;
  }

  // the flat index of corner (a, b, cc); selects, not indexing, so that c
  // stays in registers where a corner is a runtime value
  __device__ __forceinline__ int node(const FaceSink<Acc>& sink, int a, int b, int cc) const {
    const int x = a ? c[0][1] : c[0][0], y = b ? c[1][1] : c[1][0], z = cc ? c[2][1] : c[2][0];
    return ((z - sink.z_first) * sink.H + y) * sink.W + x;
  }

  // Called by every lane of the warp that is at this point; ends the runs of
  // the lanes whose `cond` holds, across the face `code` (face_to) or, with
  // code 0, adding all 8 sums.
  __device__ __forceinline__ void flush_if(const FaceSink<Acc>& sink, bool cond, int code) {
    const unsigned active = __activemask();
    if (!__any_sync(active, cond)) return;
    const bool face = code > 0;
    const int k = (code - 1) >> 1, side = (code - 1) & 1;  // side: the index that leaves
    // the sums that leave: on a face out[j] is node (p, q) = (j >> 1, j & 1) of
    // the other two axes at index `side` of axis k; else out[j] is
    // sum[j >> 2][(j >> 1) & 1][j & 1]
    Sum out[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) out[j] = sum[j >> 2][(j >> 1) & 1][j & 1];
    if (face) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = j >> 1, q = j & 1;
        out[j] = k == 0 ? (side ? sum[1][p][q] : sum[0][p][q])
                        : (k == 1 ? (side ? sum[p][1][q] : sum[p][0][q])
                                  : (side ? sum[p][q][1] : sum[p][q][0]));
      }
    }
    const unsigned clamped = (c[0][1] == c[0][0]) | (c[1][1] == c[1][0]) << 1 |
                             (c[2][1] == c[2][0]) << 2;
    const unsigned long long key =
        cond ? static_cast<unsigned long long>(node(sink, 0, 0, 0)) << 6 | clamped << 3 |
                   static_cast<unsigned>(code)
             : ~0ULL;  // never a run's key: indices are below 2^31
    unsigned peers = __match_any_sync(active, key);
    if (!cond) peers = 0u;  // a lane that keeps its run takes no part in the sums
    const int lane = threadIdx.x & 31;
    const bool leader = lane == __ffs(peers) - 1;
    const bool all8 = __any_sync(active, cond && !face);
    // tree sum over the peers into the lowest one, as SplatRun's
    int rank = __popc(peers & ((1u << lane) - 1u));
    peers &= ~((2u << lane) - 1u);
    while (__any_sync(active, peers != 0u)) {
      const int next = __ffs(peers) - 1;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < 4 || all8) {
          const Sum t = __shfl_sync(active, out[j], next < 0 ? lane : next);
          if (next >= 0) out[j] = out[j] + t;
        }
      }
      peers &= ~__ballot_sync(active, rank & 1);
      rank >>= 1;
    }
    if (cond && leader) {
      if (!face) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          adds += face_add_pair(sink, node(sink, 0, j >> 1, j & 1), node(sink, 1, j >> 1, j & 1),
                           static_cast<Acc>(out[j]), static_cast<Acc>(out[4 + j]));
      } else if (k == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          atomicAdd(sink.out + node(sink, side, j >> 1, j & 1), static_cast<Acc>(out[j]));
          ++adds;
        }
      } else {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int b = k == 1 ? side : q, cc = k == 1 ? q : side;
          adds += face_add_pair(sink, node(sink, 0, b, cc), node(sink, 1, b, cc),
                           static_cast<Acc>(out[q]), static_cast<Acc>(out[2 + q]));
        }
      }
      ++issued;
    }
    if (cond) {
      ++flushes;
      open = false;
      if (face) {  // the face's nodes become the neighbour's: index side of axis k
        ++faces;
        Sum old[2][2][2];
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int b = 0; b < 2; ++b)
#pragma unroll
            for (int cc = 0; cc < 2; ++cc) old[a][b][cc] = sum[a][b][cc];
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int b = 0; b < 2; ++b)
#pragma unroll
            for (int cc = 0; cc < 2; ++cc) {
              const int ik = k == 0 ? a : (k == 1 ? b : cc);
              const Sum from = k == 0 ? old[1 - a][b][cc]
                                      : (k == 1 ? old[a][1 - b][cc] : old[a][b][1 - cc]);
              sum[a][b][cc] = ik == side ? from : static_cast<Sum>(0);
            }
      }
    }
  }

  // One step of the ray, called by every lane at this point of the step: adds
  // the step's terms to the run when `splat` holds and the cell is the
  // run's; in a neighbour across one face, to the sums carried over; else
  // after the run was added.
  __device__ __forceinline__ void step(const FaceSink<Acc>& sink, bool splat,
                                       const CellStencil<T>& s, const T terms[2][2][2]) {
    bool same = splat && open;
#pragma unroll
    for (int k = 0; k < 3; ++k) same = same && c[k][0] == s.c[k][0] && c[k][1] == s.c[k][1];
    const bool ends = splat && open && !same;
    const int code = kCarry && ends ? face_to(s.c) : 0;
    flush_if(sink, ends, code);
    if (!splat) return;
    const bool keep = same || code > 0;
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc)
          sum[a][b][cc] = keep ? sum[a][b][cc] + static_cast<Sum>(terms[a][b][cc])
                               : static_cast<Sum>(terms[a][b][cc]);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      c[k][0] = s.c[k][0];
      c[k][1] = s.c[k][1];
    }
    open = true;
  }
};

constexpr int kFaceRunKind = 2, kFacePairKind = 3;

template <int kKind, typename T, typename Sum, typename Acc>
struct FaceRunOf {
  using Run = FaceRun<T, Sum, Acc, kKind == kFaceRunKind>;
  using St = CellStencil<T>;
  using Sink = FaceSink<Acc>;
  static __device__ __forceinline__ Sink sink(Acc* out, const Grid<T>& g) {
    return Sink{out, g.W, g.H, g.z_first, g.W * g.H * g.D};
  }
  static __device__ __forceinline__ St stencil_at(const Grid<T>& g, const T p[3]) {
    return cell_stencil(g, p);
  }
  static __device__ __forceinline__ void finish(Run& run, const Sink& sink,
                                                unsigned long long* counts) {
    run.flush_if(sink, run.open, 0);
    counts[kTallyRuns] += run.flushes;
    counts[kTallyIssued] += run.issued;
    counts[kTallyAdds] += run.adds;
    counts[kTallyFloat4] += run.faces;
  }
};
template <typename T, typename Sum, typename Acc>
struct RunOf<kFaceRunKind, T, Sum, Acc> : FaceRunOf<kFaceRunKind, T, Sum, Acc> {};
template <typename T, typename Sum, typename Acc>
struct RunOf<kFacePairKind, T, Sum, Acc> : FaceRunOf<kFacePairKind, T, Sum, Acc> {};

// The tally of the tile path: runs, issued, the tiles' adds into device
// memory, block-stretches on the tile and over it, flushes issued straight
// to device memory (mode 5's own counters)
enum TileTally {
  kTileRuns, kTileIssued, kTileAdds, kTileStretches, kTileOver, kTileDirect, kTileTallyLen
};

// One replayed step of the tile path: K2's step (forward_step's arithmetic,
// operation by operation), then the rule's "inside" at the new x; where the
// step evaluates, its corner nodes widen the box [lo, hi].  kReuse (the sdf
// rule): `cell` holds the stencil at x, made by the step before, whose
// "inside" read the sdf there; this step's "inside" leaves the stencil at
// the new x in it.  The positions, masks and reads are the forward's bit for
// bit either way.  kBox: widen the box (the stretch's steps; not the steps
// replayed to reach a later stretch).
template <bool kReuse, bool kBox, typename T, typename Rule>
__device__ __forceinline__ bool replay_box(const Grid<T>& g, const Rule& rule,
                                           typename Rule::Ray& rr, T ds, T x[3], T v[3],
                                           bool inside, Cell<T>& cell, int lo[3], int hi[3]) {
  if (inside) {
    if (!kReuse) corner_cells(g, x, cell.c, cell.w0);
    const Stencil<T> s = stencil_of(g, cell.c, cell.w0);
    T cv[2][2][2], n, grad[3];
    fetch(g, s, true, cv);
    value_grad(g, cv, s.w0, n, grad);
    const T dsn = ds * n;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      v[k] = v[k] + dsn * grad[k];
      if (kBox) {
        lo[k] = min(lo[k], cell.c[k][0]);
        hi[k] = max(hi[k], cell.c[k][1]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) x[k] = x[k] + ds * v[k];
  if constexpr (kReuse) {
    // SdfRule::inside: was && value_at(sdf, x) < 0, with value_at's stencil kept
    if (!inside) return false;
    corner_cells(g, x, cell.c, cell.w0);
    const Stencil<T> s = stencil_of(rule.sdf, cell.c, cell.w0);
    T cv[2][2][2], n, grad[3];
    fetch(rule.sdf, s, true, cv);
    value_grad(rule.sdf, cv, s.w0, n, grad);
    return n < static_cast<T>(0);
  } else {
    return rule.inside(rr, x, inside, inbounds(g, x));
  }
}

// Where the runs of a block go in one stretch: its tile holds the nodes
// [lo, lo + n) on each axis (x padded to whole groups of `vec` words), word
// ((z - lo2) * n1 + y - lo1) * n0 + x - lo0; n0 = 0: the stretch has no tile.
struct TileBox {
  int lo[3], n[3];
  __device__ __forceinline__ bool holds(const int c[3][2]) const {
    bool in = true;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      in = in && static_cast<unsigned>(c[k][0] - lo[k]) < static_cast<unsigned>(n[k]) &&
           static_cast<unsigned>(c[k][1] - lo[k]) < static_cast<unsigned>(n[k]);
    return in;
  }
  __device__ __forceinline__ int word(int x, int y, int z) const {
    return ((z - lo[2]) * n[1] + y - lo[1]) * n[0] + x - lo[0];
  }
};

// What a tile run's flush needs: the tile, the box, device memory's sum and
// the grid's shape for its flat indices.
template <typename Acc>
struct TileSink {
  Acc* tile;
  Acc* out;
  TileBox box;
  int W, H, z_first;
};

// SplatRun (trilinear.cuh) keyed by the corner nodes: the same runs (two
// stencils are the same exactly when their corner nodes are), the same warp
// sums; the leader adds a run's 8 sums into the block's tile where the box
// holds its cell, else into device memory.  Sum: the type of the run and
// warp sums; Acc: the tile's and device memory's (K19: f64 adds of f32 or
// f64 sums).
template <typename T, typename Sum, typename Acc>
struct TileRun {
  int c[3][2];
  Sum sum[2][2][2];
  bool open = false;
  int flushes = 0, issued = 0, direct = 0;

  __device__ __forceinline__ void flush_if(const TileSink<Acc>& sink, bool cond) {
    const unsigned active = __activemask();
    if (!__any_sync(active, cond)) return;
    const int W = sink.W, H = sink.H, zf = sink.z_first;
    const unsigned long long key =
        cond ? (static_cast<unsigned long long>((c[2][0] - zf) * H + c[1][0]) * W + c[0][0])
                       << 32 |
                   static_cast<unsigned>(((c[2][1] - zf) * H + c[1][1]) * W + c[0][1])
             : ~0ULL;  // never a stencil's key: indices are below 2^31
    unsigned peers = __match_any_sync(active, key);
    if (!cond) peers = 0u;
    const int lane = threadIdx.x & 31;
    const bool leader = lane == __ffs(peers) - 1;
    int rank = __popc(peers & ((1u << lane) - 1u));
    peers &= ~((2u << lane) - 1u);
    while (__any_sync(active, peers != 0u)) {
      const int next = __ffs(peers) - 1;
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const Sum t = __shfl_sync(active, sum[a][b][cc], next < 0 ? lane : next);
            if (next >= 0) sum[a][b][cc] = sum[a][b][cc] + t;
          }
      peers &= ~__ballot_sync(active, rank & 1);
      rank >>= 1;
    }
    if (cond && leader) {
      if (sink.box.holds(c)) {
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int b = 0; b < 2; ++b)
#pragma unroll
            for (int cc = 0; cc < 2; ++cc)
              atomicAdd(sink.tile + sink.box.word(c[0][a], c[1][b], c[2][cc]),
                        static_cast<Acc>(sum[a][b][cc]));
      } else {
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int b = 0; b < 2; ++b)
#pragma unroll
            for (int cc = 0; cc < 2; ++cc)
              atomicAdd(sink.out + ((c[2][cc] - zf) * H + c[1][b]) * W + c[0][a],
                        static_cast<Acc>(sum[a][b][cc]));
        ++direct;
      }
      ++issued;
    }
    if (cond) {
      ++flushes;
      open = false;
    }
  }

  __device__ __forceinline__ void step(const TileSink<Acc>& sink, bool splat,
                                       const CellStencil<T>& s, const T terms[2][2][2]) {
    bool same = splat && open;
#pragma unroll
    for (int k = 0; k < 3; ++k) same = same && c[k][0] == s.c[k][0] && c[k][1] == s.c[k][1];
    flush_if(sink, splat && open && !same);
    if (!splat) return;
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc)
          sum[a][b][cc] = same ? sum[a][b][cc] + static_cast<Sum>(terms[a][b][cc])
                               : static_cast<Sum>(terms[a][b][cc]);
    if (!same) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        c[k][0] = s.c[k][0];
        c[k][1] = s.c[k][1];
      }
    }
    open = true;
  }
};

// Adds `vec` tile words at t (nonzero somewhere) to device memory at o and
// zeroes them; returns the adds issued.
__device__ __forceinline__ int add_words(float* o, float* t, int vec) {
#if ANRT_VECTOR_ATOMICS
  if (vec == 4) {
    const float4 q = *reinterpret_cast<float4*>(t);
    if (q.x == 0.f && q.y == 0.f && q.z == 0.f && q.w == 0.f) return 0;
    atomicAdd(reinterpret_cast<float4*>(o), q);
    *reinterpret_cast<float4*>(t) = make_float4(0.f, 0.f, 0.f, 0.f);
    return 1;
  }
  if (vec == 2) {
    const float2 q = *reinterpret_cast<float2*>(t);
    if (q.x == 0.f && q.y == 0.f) return 0;
    atomicAdd(reinterpret_cast<float2*>(o), q);
    *reinterpret_cast<float2*>(t) = make_float2(0.f, 0.f);
    return 1;
  }
#endif
  if (*t == 0.f) return 0;
  atomicAdd(o, *t);
  *t = 0.f;
  return 1;
}

__device__ __forceinline__ int add_words(double* o, double* t, int) {
  if (*t == 0.0) return 0;
  atomicAdd(o, *t);
  *t = 0.0;
  return 1;
}

// The tile path measured (mode 5), not shipped: K6's ray with the
// threads of a block walking the segments and stretches together, and the
// runs that flush in a stretch into the box of nodes its steps evaluate
// added into a tile in shared memory, which the block adds to device memory
// after the stretch.
template <typename T, typename Rule, typename Acc, typename Sum, bool kReuse>
struct TileRay {
  Grid<T> g;
  Rule rule;
  T ds;
  const T* ckpts;
  const int* order;
  const int* c;
  const unsigned char* code;
  const T *dx, *dv;
  int n_slots, nseg, seg;

  // The tile path: the block's threads walk the segments and stretches
  // together (from the block's last segment down; a thread with no ray slot
  // takes part in every barrier), the lanes of a warp the steps as above.
  // After a stretch's replay the block's box is the least and greatest
  // corner node of every step it will evaluate; where its words fit the
  // tile, runs that flush in the stretch's reverse pass into a cell the box
  // holds go to the tile (shared-memory adds), the rest to device memory;
  // after the stretch the block adds the tile's nonzero words to device
  // memory (vec words at once) and zeroes them.  part: 6 ints a warp;
  // boxes: null, or a counter, its capacity and the node count of each
  // block-stretch's box (tools/exact_designs.py).
  __device__ __forceinline__ void block(Acc* __restrict__ out, Acc* tile, int tile_words,
                                        int vec, int (*part)[6], int* wsteps,
                                        unsigned long long* tally, int* boxes) const {
    constexpr unsigned kAll = 0xffffffffu;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const bool slot = i < n_slots;
    const int r = slot ? ray_of(order, i) : 0;
    typename Rule::Ray rr = rule.start(r, nullptr);
    const int steps = !slot || __ldg(code + r) == 2 ? 0 : __ldg(c + r);
    const int warp_steps = __reduce_max_sync(kAll, steps);
    if (lane == 0) wsteps[warp] = warp_steps;
    __syncthreads();
    int block_steps = 0;
    for (int w = 0; w < kThreads / 32; ++w) block_steps = max(block_steps, wsteps[w]);
    const int block_last = block_steps <= 0 ? -1 : min((block_steps - 1) / seg, nseg - 1);
    T la[3] = {0, 0, 0}, mu[3] = {0, 0, 0};
    if (slot) {
      load3(dx, r, la);
      load3(dv, r, mu);
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) mu[k] = mu[k] + ds * la[k];
    TileRun<T, Sum, Acc> run;
    TileSink<Acc> sink{tile, out, TileBox{}, g.W, g.H, g.z_first};
    T xs[kReplay][3];
    const size_t field = static_cast<size_t>(n_slots);
    int tile_adds = 0, took = 0, over = 0;

    for (int s = block_last; s >= 0; --s) {
      const int n = min(max(steps - s * seg, 0), seg);
      const int n_warp = min(max(warp_steps - s * seg, 0), seg);
      const int n_block = min(block_steps - s * seg, seg);  // >= 1
      const T* row = ckpts + s * 7 * field + (slot ? i : 0);
      for (int b0 = (n_block - 1) / kReplay * kReplay; b0 >= 0; b0 -= kReplay) {
        const int nb = min(max(n - b0, 0), kReplay);
        const int nb_warp = min(max(n_warp - b0, 0), kReplay);
        int lo[3] = {0x7fffffff, 0x7fffffff, 0x7fffffff}, hi[3] = {-1, -1, -1};
        T x[3], v[3];
        bool inside = false;
        Cell<T> cell;
        if (nb > 0) {
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            x[k] = row[k * field];
            v[k] = row[(k + 3) * field];
          }
          inside = row[6 * field] > static_cast<T>(0.5);
          if (kReuse && inside) corner_cells(g, x, cell.c, cell.w0);
          for (int j = 0; j < b0; ++j)
            inside = replay_box<kReuse, false>(g, rule, rr, ds, x, v, inside, cell, lo, hi);
        }
        unsigned ins = 0u;
        for (int j = 0; j < nb_warp; ++j) {
          if (j < nb) {
#pragma unroll
            for (int k = 0; k < 3; ++k) xs[j][k] = x[k];
            if (inside) ins |= 1u << j;
            inside = replay_box<kReuse, true>(g, rule, rr, ds, x, v, inside, cell, lo, hi);
          }
        }
        // the block's box
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          lo[k] = __reduce_min_sync(kAll, lo[k]);
          hi[k] = __reduce_max_sync(kAll, hi[k]);
        }
        if (lane == 0) {
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            part[warp][k] = lo[k];
            part[warp][3 + k] = hi[k];
          }
        }
        __syncthreads();
        for (int w = 0; w < kThreads / 32; ++w) {
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            lo[k] = min(lo[k], part[w][k]);
            hi[k] = max(hi[k], part[w][3 + k]);
          }
        }
        const bool any = lo[0] <= hi[0];  // the block evaluates somewhere in the stretch
        TileBox& box = sink.box;
        box.n[0] = 0;
        if (any) {
          box.lo[0] = lo[0] / vec * vec;
          box.lo[1] = lo[1];
          box.lo[2] = lo[2];
          const int pitch = (hi[0] - box.lo[0] + vec) / vec * vec;
          const long long words = static_cast<long long>(pitch) * (hi[1] - lo[1] + 1) *
                                  (hi[2] - lo[2] + 1);
          if (words <= tile_words) {
            box.n[0] = pitch;
            box.n[1] = hi[1] - lo[1] + 1;
            box.n[2] = hi[2] - lo[2] + 1;
          }
          if (threadIdx.x == 0) {
            if (box.n[0] > 0) ++took; else ++over;
            if (boxes != nullptr) {
              const int k = atomicAdd(boxes, 1);
              if (k < boxes[1])
                boxes[2 + k] = (hi[0] - lo[0] + 1) * (hi[1] - lo[1] + 1) * (hi[2] - lo[2] + 1);
            }
          }
        }
        // reverse over the stretch
        T xn[3];
        if (nb > 0) {
#pragma unroll
          for (int k = 0; k < 3; ++k) xn[k] = xs[nb - 1][k];
        }
        for (int j = nb_warp - 1; j >= 0; --j) {
          if (j < nb) {
            const T xk[3] = {xn[0], xn[1], xn[2]};
            if (j > 0) {
#pragma unroll
              for (int k = 0; k < 3; ++k) xn[k] = xs[j - 1][k];
            }
            const bool emask = (ins >> j) & 1u;
            T nk = 0, grad[3] = {0, 0, 0}, hess[3] = {0, 0, 0};
            CellStencil<T> st;
            if (emask) {
              st = cell_stencil(g, xk);
              T cv[2][2][2];
              fetch(g, st, true, cv);
              value_grad(g, cv, st.w0, nk, grad);
              hessian(g, cv, st.w0, hess);
            }
            adjoint_update(g, ds, st, nk, grad, hess, emask, la, mu, run, sink);
          }
        }
        if (s == 0 && b0 == 0) run.flush_if(sink, run.open);  // the ray's last run
        __syncthreads();
        if (box.n[0] > 0) {  // the tile into device memory, vec words at a time
          const int groups_row = box.n[0] / vec;
          const int groups = groups_row * box.n[1] * box.n[2];
          for (int e = threadIdx.x; e < groups; e += blockDim.x) {
            const int rw = e / groups_row, xg = e - rw * groups_row;
            const int z = rw / box.n[1], y = rw - z * box.n[1];
            const int flat = ((box.lo[2] + z - g.z_first) * g.H + box.lo[1] + y) * g.W +
                             box.lo[0] + xg * vec;
            tile_adds += add_words(out + flat, tile + e * vec, vec);
          }
        }
      }
    }
    if (tally != nullptr) {
      const unsigned long long mine[kTileTallyLen] = {
          static_cast<unsigned long long>(run.flushes), static_cast<unsigned long long>(run.issued),
          static_cast<unsigned long long>(tile_adds), static_cast<unsigned long long>(took),
          static_cast<unsigned long long>(over), static_cast<unsigned long long>(run.direct)};
#pragma unroll
      for (int k = 0; k < kTileTallyLen; ++k) {
        const unsigned sum = __reduce_add_sync(kAll, static_cast<unsigned>(mine[k]));
        if (lane == 0 && sum) atomicAdd(tally + k, static_cast<unsigned long long>(sum));
      }
    }
  }
};

// The tile path's kernel: one ray slot a thread, 128 threads a block, the
// tile (tile_words of Acc) in dynamic shared memory.
template <typename Ray, typename Acc>
__global__ void __launch_bounds__(kThreads)
exact_tile_kernel(Ray ray, Acc* __restrict__ out, int tile_words, int vec,
                  unsigned long long* __restrict__ tally, int* __restrict__ boxes) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int part[kThreads / 32][6];
  __shared__ int wsteps[kThreads / 32];
  Acc* tile = reinterpret_cast<Acc*>(smem);
  for (int w = threadIdx.x; w < tile_words; w += blockDim.x) tile[w] = 0;
  ray.block(out, tile, tile_words, vec, part, wsteps, tally, boxes);
}

// Launches the tile path over n_slots thread slots with a tile of tile_bytes;
// returns the launch's CUDA error (0 on success).
template <typename Acc, typename Ray>
int launch_exact_tile(const Ray& ray, int n_slots, void* grad_out, unsigned long long* tally,
                      int tile_bytes, int* boxes, cudaStream_t stream) {
  if (n_slots <= 0) return static_cast<int>(cudaGetLastError());
  Acc* out = static_cast<Acc*>(grad_out);
  auto kernel = exact_tile_kernel<Ray, Acc>;
  // with the static words, past the default 48 KB
  if (tile_bytes > 32 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, tile_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // the words a vector add may take: 4 or 2 where x rows and the sum are aligned to them
  const auto addr = reinterpret_cast<unsigned long long>(grad_out);
  int vec = 1;
  if (ANRT_VECTOR_ATOMICS && sizeof(Acc) == 4) {
    if (ray.g.W % 4 == 0 && addr % 16 == 0) vec = 4;
    else if (ray.g.W % 2 == 0 && addr % 8 == 0) vec = 2;
  }
  kernel<<<blocks_for(n_slots), kThreads, tile_bytes, stream>>>(
      ray, out, tile_bytes / static_cast<int>(sizeof(Acc)), vec, tally, boxes);
  return static_cast<int>(cudaGetLastError());
}

template <typename A, typename B>
struct SameType {
  static constexpr bool value = false;
};
template <typename A>
struct SameType<A, A> {
  static constexpr bool value = true;
};

// How a SplitRun's leader adds a run's 8 sums: atomics into the gradient
// (modes 1, 7), into one word a warp (mode 4), into a register sum written at
// the end (mode 6: no adds at all), or (mode 8) each x-pair of corners that
// lies in one aligned group of 4 words as one float4 add (zeros in the other
// two words), the rest one by one.
enum SplitAdds { kAddAtomic, kAddScratch, kAddFold, kAddVector };

// SplatRun (trilinear.cuh) with its sums in Sum and its adds in Acc, the adds
// as kAdd says, the warp sums only with kWarpSums (without them every lane
// adds its own run).
template <int kAdd, bool kWarpSums, typename Sum, typename Acc>
struct SplitRun {
  int idx[2][2][2];
  Sum sum[2][2][2];
  bool open = false;
  int flushes = 0, issued = 0;
  Sum folded = 0;

  __device__ __forceinline__ void add8(Acc* acc, Acc* redirect, int n_cells) {
    if (kAdd == kAddFold) {
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b)
#pragma unroll
          for (int c = 0; c < 2; ++c) folded = folded + sum[a][b][c];
      return;
    }
    if (kAdd == kAddScratch) {
      const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b)
#pragma unroll
          for (int c = 0; c < 2; ++c) atomicAdd(redirect + warp, static_cast<Acc>(sum[a][b][c]));
      return;
    }
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int i0 = idx[0][b][c], i1 = idx[1][b][c];
        if constexpr (kAdd == kAddVector && sizeof(Acc) == 4) {
#if ANRT_VECTOR_ATOMICS
          const int base = i0 & ~3;
          if (i1 == i0 + 1 && (i0 & 3) != 3 && base + 3 < n_cells) {
            const int k = i0 & 3;
            const float s0 = static_cast<float>(sum[0][b][c]);
            const float s1 = static_cast<float>(sum[1][b][c]);
            const float4 q = make_float4(k == 0 ? s0 : 0.f, k == 0 ? s1 : (k == 1 ? s0 : 0.f),
                                         k == 1 ? s1 : (k == 2 ? s0 : 0.f), k == 2 ? s1 : 0.f);
            atomicAdd(reinterpret_cast<float4*>(acc + base), q);
            continue;
          }
#endif
        }
        atomicAdd(acc + i0, static_cast<Acc>(sum[0][b][c]));
        atomicAdd(acc + i1, static_cast<Acc>(sum[1][b][c]));
      }
  }

  __device__ __forceinline__ void flush_if(Acc* acc, Acc* redirect, int n_cells, bool cond) {
    const unsigned active = __activemask();
    if (!__any_sync(active, cond)) return;
    bool leader = cond;
    if (kWarpSums) {
      const unsigned long long key =
          cond ? (static_cast<unsigned long long>(idx[0][0][0]) << 32) |
                     static_cast<unsigned>(idx[1][1][1])
               : ~0ULL;
      unsigned peers = __match_any_sync(active, key);
      if (!cond) peers = 0u;
      const int lane = threadIdx.x & 31;
      leader = lane == __ffs(peers) - 1;
      int rank = __popc(peers & ((1u << lane) - 1u));
      peers &= ~((2u << lane) - 1u);
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
        peers &= ~__ballot_sync(active, rank & 1);
        rank >>= 1;
      }
    }
    if (cond && leader) {
      add8(acc, redirect, n_cells);
      ++issued;
    }
    if (cond) {
      ++flushes;
      open = false;
    }
  }

  template <typename T>
  __device__ __forceinline__ void step(Acc* acc, Acc* redirect, int n_cells, bool splat,
                                       const Stencil<T>& s, const T terms[2][2][2]) {
    const bool same =
        splat && open && idx[0][0][0] == s.idx[0][0][0] && idx[1][1][1] == s.idx[1][1][1];
    flush_if(acc, redirect, n_cells, splat && open && !same);
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

// adjoint_update's sink for a SplitRun: the gradient, the redirect, the cells
template <typename Acc>
struct SplitSink {
  Acc* acc;
  Acc* redirect;
  int n_cells;
};

// the run's step with a SplitSink (adjoint_update calls run.step(sink, ...))
template <int kAdd, bool kWarpSums, typename Sum, typename Acc>
struct SplitRunOf : SplitRun<kAdd, kWarpSums, Sum, Acc> {
  template <typename T>
  __device__ __forceinline__ void step(SplitSink<Acc> sink, bool splat, const Stencil<T>& s,
                                       const T terms[2][2][2]) {
    SplitRun<kAdd, kWarpSums, Sum, Acc>::step(sink.acc, sink.redirect, sink.n_cells, splat, s,
                                              terms);
  }
};

// The warp path's ray (ExactRay::operator()) with the split's modes 1-4 and 6-8.
template <int kMode, typename T, typename Rule, typename Acc, typename Sum, bool kReuse>
struct SplitRay {
  Grid<T> g;
  Rule rule;
  T ds;
  const T* ckpts;
  const int* order;
  const int* c;
  const unsigned char* code;
  const T *dx, *dv;
  int n_slots, nseg, seg;
  Acc* probe;

  __device__ __forceinline__ void operator()(int i, Acc* acc, unsigned long long counts[2]) const {
    const unsigned lanes = __activemask();
    const int r = ray_of(order, i);
    typename Rule::Ray rr = rule.start(r, nullptr);
    const int steps = __ldg(code + r) == 2 ? 0 : __ldg(c + r);
    const int last = steps <= 0 ? -1 : ((steps - 1) / seg < nseg - 1 ? (steps - 1) / seg
                                                                     : nseg - 1);
    const int warp_last = __reduce_max_sync(lanes, last);
    T la[3], mu[3];
    load3(dx, r, la);
    load3(dv, r, mu);
#pragma unroll
    for (int k = 0; k < 3; ++k) mu[k] = mu[k] + ds * la[k];
    constexpr int kAdd = kMode == 4 ? kAddScratch
                         : (kMode == 6 ? kAddFold : (kMode == 8 ? kAddVector : kAddAtomic));
    SplitRunOf<kAdd, kMode != 7, Sum, Acc> run;
    const SplitSink<Acc> sink{acc, kMode == 4 ? probe : nullptr, g.W * g.H * g.D};
    T xs[kReplay][3];
    T folded = 0;  // modes 2 and 3
    const size_t field = static_cast<size_t>(n_slots);
    int lo[3], hi[3];  // unused: no box on the warp path

    for (int s = warp_last; s >= 0; --s) {
      const int n = s > last ? 0 : (steps - s * seg < seg ? steps - s * seg : seg);
      const int n_warp = __reduce_max_sync(lanes, n);
      const T* row = ckpts + s * 7 * field + i;
      for (int b0 = (n_warp - 1) / kReplay * kReplay; b0 >= 0; b0 -= kReplay) {
        const int nb = n - b0 < 0 ? 0 : (n - b0 < kReplay ? n - b0 : kReplay);
        const int nb_warp = n_warp - b0 < kReplay ? n_warp - b0 : kReplay;
        T x[3], v[3];
        bool inside = false;
        Cell<T> cell;
        if (nb > 0) {
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            x[k] = row[k * field];
            v[k] = row[(k + 3) * field];
          }
          inside = row[6 * field] > static_cast<T>(0.5);
          if (kReuse && inside) corner_cells(g, x, cell.c, cell.w0);
          for (int j = 0; j < b0; ++j)
            inside = replay_box<kReuse, false>(g, rule, rr, ds, x, v, inside, cell, lo, hi);
        }
        unsigned ins = 0u;
        for (int j = 0; j < nb_warp; ++j) {
          if (j < nb) {
#pragma unroll
            for (int k = 0; k < 3; ++k) xs[j][k] = x[k];
            if (inside) ins |= 1u << j;
            inside = replay_box<kReuse, false>(g, rule, rr, ds, x, v, inside, cell, lo, hi);
          }
        }
        T xn[3];
        if (nb > 0) {
#pragma unroll
          for (int k = 0; k < 3; ++k) xn[k] = xs[nb - 1][k];
        }
        for (int j = nb_warp - 1; j >= 0; --j) {
          if (j < nb) {
            const T xk[3] = {xn[0], xn[1], xn[2]};
            if (j > 0) {
#pragma unroll
              for (int k = 0; k < 3; ++k) xn[k] = xs[j - 1][k];
            }
            const bool emask = (ins >> j) & 1u;
            if (kMode == 2) {
              folded = folded + (emask ? xk[0] + xk[1] + xk[2] : static_cast<T>(0));
              continue;
            }
            T nk = 0, grad[3] = {0, 0, 0}, hess[3] = {0, 0, 0};
            Stencil<T> st;
            if (emask) {
              st = stencil(g, xk);
              T cv[2][2][2];
              fetch(g, st, true, cv);
              value_grad(g, cv, st.w0, nk, grad);
              hessian(g, cv, st.w0, hess);
            }
            if (kMode == 3) {  // adjoint_update without the run
              const T dn = mu[0] * grad[0] + mu[1] * grad[1] + mu[2] * grad[2];
              if (emask) {
                T terms[2][2][2];
                const T dnx[3] = {nk * mu[0] * ds, nk * mu[1] * ds, nk * mu[2] * ds};
                splat_terms(g, st, dn * ds, dnx, terms);
#pragma unroll
                for (int a = 0; a < 2; ++a)
#pragma unroll
                  for (int b = 0; b < 2; ++b)
#pragma unroll
                    for (int cc = 0; cc < 2; ++cc) folded = folded + terms[a][b][cc];
              }
              const T hmu[3] = {hess[0] * mu[1] + hess[1] * mu[2],
                                hess[0] * mu[0] + hess[2] * mu[2],
                                hess[1] * mu[0] + hess[2] * mu[1]};
#pragma unroll
              for (int k = 0; k < 3; ++k) {
                la[k] = la[k] + ds * (dn * grad[k] + nk * hmu[k]);
                mu[k] = mu[k] + ds * la[k];
              }
              continue;
            }
            adjoint_update(g, ds, st, nk, grad, hess, emask, la, mu, run, sink);
          }
        }
      }
    }
    if (kMode == 2 || kMode == 3) {
      probe[i] = static_cast<Acc>(folded + la[0] + mu[0]);
      return;
    }
    run.flush_if(sink.acc, sink.redirect, sink.n_cells, run.open);
    if (kMode == 6) probe[i] = static_cast<Acc>(run.folded);
    counts[0] += run.flushes;
    counts[1] += run.issued;
  }
};

template <int kMode, typename T, typename Rule, typename Acc, typename Sum, bool kReuse>
int launch_split(const Rule& rule, const void* rif, int W, int H, int D, double h, double ds,
                 const void* ckpts, const int* order, const void* c, const void* code,
                 const void* dx, const void* dv, void* grad_out, unsigned long long* tally,
                 void* probe, int n_slots, int nseg, int seg, cudaStream_t stream) {
  const SplitRay<kMode, T, Rule, Acc, Sum, kReuse> ray{
      make_grid<T>(rif, W, H, D, h), rule, static_cast<T>(ds), static_cast<const T*>(ckpts),
      order, static_cast<const int*>(c), static_cast<const unsigned char*>(code),
      static_cast<const T*>(dx), static_cast<const T*>(dv), n_slots, nseg, seg,
      static_cast<Acc*>(probe)};
  return launch_adjoint<Acc>(ray, W * H * D, grad_out, tally, n_slots, 0, stream);
}

// The shipped exact_kernel held to kMin blocks of 128 threads an SM
// (modes 12, 13: 5 and 6), its registers capped to fit them.
template <int kMin, typename Ray>
__global__ void __launch_bounds__(kThreads, kMin)
exact_kernel_min(Ray ray, unsigned long long* __restrict__ tally, int n_slots) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_slots) return;
  unsigned long long counts[kTallyLen] = {0, 0, 0, 0};
  ray(i, counts);
  if (tally != nullptr) {
#pragma unroll
    for (int k = 0; k < kTallyLen; ++k)
      if (counts[k]) atomicAdd(tally + k, counts[k]);
  }
}

template <int kMin, typename Acc, typename Sum, bool kReuse, typename Rule>
int launch_min(const Rule& rule, const void* rif, int W, int H, int D, double h, double ds,
               const void* ckpts, const int* order, const void* c, const void* code,
               const void* dx, const void* dv, void* grad_out, unsigned long long* tally,
               int n_slots, int nseg, int seg, cudaStream_t stream) {
  if (n_slots <= 0) return static_cast<int>(cudaGetLastError());
  const ExactRay<float, Rule, Acc, Sum, kPairRun, kReuse> ray{
      make_grid<float>(rif, W, H, D, h), rule, static_cast<float>(ds),
      static_cast<const float*>(ckpts), order, static_cast<const int*>(c),
      static_cast<const unsigned char*>(code), static_cast<const float*>(dx),
      static_cast<const float*>(dv), static_cast<Acc*>(grad_out), n_slots, nseg, seg};
  exact_kernel_min<kMin><<<blocks_for(n_slots), kThreads, 0, stream>>>(ray, tally, n_slots);
  return static_cast<int>(cudaGetLastError());
}

// Mode 14: the shipped ray (PairRun, K19's choices) whose reverse step does
// its arithmetic with fused multiply-adds (fma) and the splat's 8 terms
// factored, instead of repeating the plain version's operations one by one
// (the file is built with -fmad=false, so only an explicit fma fuses).  The
// replay is the shipped one, bit for bit; the gradient moves by rounding.
template <typename T>
__device__ __forceinline__ void value_grad_fma(const Grid<T>& g, const T v[2][2][2],
                                               const T w0[3], T& n, T grad[3]) {
  T vy[2][2], vyz[2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int c = 0; c < 2; ++c) vy[a][c] = fma(w0[1], v[a][1][c] - v[a][0][c], v[a][0][c]);
    vyz[a] = fma(w0[2], vy[a][1] - vy[a][0], vy[a][0]);
  }
  n = fma(w0[0], vyz[1] - vyz[0], vyz[0]);
  grad[0] = (vyz[1] - vyz[0]) * g.inv_h;
  T vx[2][2], vxz[2];
#pragma unroll
  for (int b = 0; b < 2; ++b) {
#pragma unroll
    for (int c = 0; c < 2; ++c) vx[b][c] = fma(w0[0], v[1][b][c] - v[0][b][c], v[0][b][c]);
    vxz[b] = fma(w0[2], vx[b][1] - vx[b][0], vx[b][0]);
  }
  grad[1] = (vxz[1] - vxz[0]) * g.inv_h;
  T vxy[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) vxy[c] = fma(w0[1], vx[1][c] - vx[0][c], vx[0][c]);
  grad[2] = (vxy[1] - vxy[0]) * g.inv_h;
}

template <typename T>
__device__ __forceinline__ void hessian_fma(const Grid<T>& g, const T v[2][2][2], const T w0[3],
                                            T hess[3]) {
  const T xy0 = v[1][1][0] - v[0][1][0] - v[1][0][0] + v[0][0][0];
  const T xy1 = v[1][1][1] - v[0][1][1] - v[1][0][1] + v[0][0][1];
  const T xz0 = v[1][0][1] - v[0][0][1] - v[1][0][0] + v[0][0][0];
  const T xz1 = v[1][1][1] - v[0][1][1] - v[1][1][0] + v[0][1][0];
  const T yz0 = v[0][1][1] - v[0][0][1] - v[0][1][0] + v[0][0][0];
  const T yz1 = v[1][1][1] - v[1][0][1] - v[1][1][0] + v[1][0][0];
  hess[0] = fma(w0[2], xy1 - xy0, xy0) * g.inv_h2;
  hess[1] = fma(w0[1], xz1 - xz0, xz0) * g.inv_h2;
  hess[2] = fma(w0[0], yz1 - yz0, yz0) * g.inv_h2;
}

// splat_terms factored: out = wz (wy (val wx + gx sgn_a) + gy wx sgn_b) + gz wx wy sgn_c
template <typename T>
__device__ __forceinline__ void splat_terms_fma(const Grid<T>& g, const Stencil<T>& s, T val,
                                                const T grad[3], T out[2][2][2]) {
  const T wx[2] = {static_cast<T>(1) - s.w0[0], s.w0[0]};
  const T wy[2] = {static_cast<T>(1) - s.w0[1], s.w0[1]};
  const T wz[2] = {static_cast<T>(1) - s.w0[2], s.w0[2]};
  const T gx = grad[0] * g.inv_h, gy = grad[1] * g.inv_h, gz = grad[2] * g.inv_h;
  const T p[2] = {fma(val, wx[0], -gx), fma(val, wx[1], gx)};
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const T gyw = b ? gy * wx[a] : -(gy * wx[a]);
      const T t = fma(wy[b], p[a], gyw);
      const T u = gz * wx[a] * wy[b];
      out[a][b][0] = fma(wz[0], t, -u);
      out[a][b][1] = fma(wz[1], t, u);
    }
}

template <typename T, typename Rule, typename Acc, typename Sum, bool kReuse>
struct FusedRay : ExactRay<T, Rule, Acc, Sum, kPairRun, kReuse> {
  __device__ __forceinline__ void operator()(int i, unsigned long long* counts) const {
    using Runs = RunOf<kPairRun, T, Sum, Acc>;
    const auto& g = this->g;
    const T ds = this->ds;
    const int seg = this->seg, nseg = this->nseg;
    const unsigned lanes = __activemask();
    const int r = ray_of(this->order, i);
    typename Rule::Ray rr = this->rule.start(r, nullptr);
    const int steps = __ldg(this->code + r) == 2 ? 0 : __ldg(this->c + r);
    const int last = steps <= 0 ? -1 : ((steps - 1) / seg < nseg - 1 ? (steps - 1) / seg
                                                                     : nseg - 1);
    const int warp_last = __reduce_max_sync(lanes, last);
    T la[3], mu[3];
    load3(this->dx, r, la);
    load3(this->dv, r, mu);
#pragma unroll
    for (int k = 0; k < 3; ++k) mu[k] = mu[k] + ds * la[k];
    typename Runs::Run run;
    const auto sink = Runs::sink(this->out, g);
    T xs[kReplay][3];
    const size_t field = static_cast<size_t>(this->n_slots);
    for (int s = warp_last; s >= 0; --s) {
      const int n = s > last ? 0 : (steps - s * seg < seg ? steps - s * seg : seg);
      const int n_warp = __reduce_max_sync(lanes, n);
      const T* row = this->ckpts + s * 7 * field + i;
      for (int b0 = (n_warp - 1) / kReplay * kReplay; b0 >= 0; b0 -= kReplay) {
        const int nb = n - b0 < 0 ? 0 : (n - b0 < kReplay ? n - b0 : kReplay);
        const int nb_warp = n_warp - b0 < kReplay ? n_warp - b0 : kReplay;
        T x[3], v[3];
        bool inside = false;
        Cell<T> cell;
        if (nb > 0) {
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            x[k] = row[k * field];
            v[k] = row[(k + 3) * field];
          }
          inside = row[6 * field] > static_cast<T>(0.5);
          if (kReuse && inside) corner_cells(g, x, cell.c, cell.w0);
          for (int j = 0; j < b0; ++j) inside = this->replay(rr, x, v, inside, cell);
        }
        unsigned ins = 0u;
        for (int j = 0; j < nb_warp; ++j) {
          if (j < nb) {
#pragma unroll
            for (int k = 0; k < 3; ++k) xs[j][k] = x[k];
            if (inside) ins |= 1u << j;
            inside = this->replay(rr, x, v, inside, cell);
          }
        }
        T xn[3];
        if (nb > 0) {
#pragma unroll
          for (int k = 0; k < 3; ++k) xn[k] = xs[nb - 1][k];
        }
        for (int j = nb_warp - 1; j >= 0; --j) {
          if (j < nb) {
            const T xk[3] = {xn[0], xn[1], xn[2]};
            if (j > 0) {
#pragma unroll
              for (int k = 0; k < 3; ++k) xn[k] = xs[j - 1][k];
            }
            const bool emask = (ins >> j) & 1u;
            T nk = 0, grad[3] = {0, 0, 0}, hess[3] = {0, 0, 0};
            Stencil<T> st;
            if (emask) {
              st = stencil(g, xk);
              T cv[2][2][2];
              fetch(g, st, true, cv);
              value_grad_fma(g, cv, st.w0, nk, grad);
              hessian_fma(g, cv, st.w0, hess);
            }
            const T dn = fma(mu[2], grad[2], fma(mu[1], grad[1], mu[0] * grad[0]));
            T terms[2][2][2];
            if (emask) {
              const T nds = nk * ds;
              const T dnx[3] = {nds * mu[0], nds * mu[1], nds * mu[2]};
              splat_terms_fma(g, st, dn * ds, dnx, terms);
            }
            run.step(sink, emask, st, terms);
            const T hmu[3] = {fma(hess[0], mu[1], hess[1] * mu[2]),
                              fma(hess[0], mu[0], hess[2] * mu[2]),
                              fma(hess[1], mu[0], hess[2] * mu[1])};
#pragma unroll
            for (int k = 0; k < 3; ++k) {
              la[k] = fma(ds, fma(dn, grad[k], nk * hmu[k]), la[k]);
              mu[k] = fma(ds, la[k], mu[k]);
            }
          }
        }
      }
    }
    Runs::finish(run, sink, counts);
  }
};

template <typename Acc, typename Sum, bool kReuse, typename Rule>
int launch_fused(const Rule& rule, const void* rif, int W, int H, int D, double h, double ds,
                 const void* ckpts, const int* order, const void* c, const void* code,
                 const void* dx, const void* dv, void* grad_out, unsigned long long* tally,
                 int n_slots, int nseg, int seg, cudaStream_t stream) {
  if (n_slots <= 0) return static_cast<int>(cudaGetLastError());
  FusedRay<float, Rule, Acc, Sum, kReuse> ray;
  static_cast<ExactRay<float, Rule, Acc, Sum, kPairRun, kReuse>&>(ray) =
      ExactRay<float, Rule, Acc, Sum, kPairRun, kReuse>{
          make_grid<float>(rif, W, H, D, h), rule, static_cast<float>(ds),
          static_cast<const float*>(ckpts), order, static_cast<const int*>(c),
          static_cast<const unsigned char*>(code), static_cast<const float*>(dx),
          static_cast<const float*>(dv), static_cast<Acc*>(grad_out), n_slots, nseg, seg};
  exact_kernel<<<blocks_for(n_slots), kThreads, 0, stream>>>(ray, tally, n_slots);
  return static_cast<int>(cudaGetLastError());
}

// One rule, one choice of sums and reuse, every mode that applies to it.
template <typename Rule, typename Acc, typename Sum, bool kReuse>
int run_split(int mode, int tile_bytes, const Rule& rule, const void* rif, int W, int H, int D,
              double h, double ds, const void* ckpts, const int* order, const void* c,
              const void* code, const void* dx, const void* dv, void* grad_out,
              unsigned long long* tally, void* probe, int* boxes, int n_slots, int nseg,
              int seg, cudaStream_t stream) {
  constexpr bool kPlain = !kReuse && SameType<Sum, Acc>::value;
#define ANRT_SPLIT(M)                                                                        \
  launch_split<M, float, Rule, Acc, Sum, kReuse>(rule, rif, W, H, D, h, ds, ckpts, order, c, \
                                                 code, dx, dv, grad_out, tally, probe,       \
                                                 n_slots, nseg, seg, stream)
  if (mode == 1) return ANRT_SPLIT(1);
  if (mode == 5) {
    const TileRay<float, Rule, Acc, Sum, kReuse> ray{
        make_grid<float>(rif, W, H, D, h), rule, static_cast<float>(ds),
        static_cast<const float*>(ckpts), order, static_cast<const int*>(c),
        static_cast<const unsigned char*>(code), static_cast<const float*>(dx),
        static_cast<const float*>(dv), n_slots, nseg, seg};
    return launch_exact_tile<Acc>(ray, n_slots, grad_out, tally, tile_bytes, boxes, stream);
  }
  if (mode == 9)  // runs carried across faces
    return launch_exact<float, Acc, Sum, kFaceRunKind, kReuse>(
        rule, rif, W, H, D, h, ds, ckpts, order, c, code, dx, dv, grad_out, tally, n_slots,
        nseg, seg, stream);
  if (mode == 10)  // the same runs, every run's 8 sums added as x-pairs
    return launch_exact<float, Acc, Sum, kFacePairKind, kReuse>(
        rule, rif, W, H, D, h, ds, ckpts, order, c, code, dx, dv, grad_out, tally, n_slots,
        nseg, seg, stream);
  if (mode == 12)  // the shipped PairRun held to 5 blocks an SM
    return launch_min<5, Acc, Sum, kReuse>(rule, rif, W, H, D, h, ds, ckpts, order, c, code, dx,
                                           dv, grad_out, tally, n_slots, nseg, seg, stream);
  if (mode == 13)  // and to 6
    return launch_min<6, Acc, Sum, kReuse>(rule, rif, W, H, D, h, ds, ckpts, order, c, code, dx,
                                           dv, grad_out, tally, n_slots, nseg, seg, stream);
  if (mode == 14)  // the shipped PairRun with the fused reverse step
    return launch_fused<Acc, Sum, kReuse>(rule, rif, W, H, D, h, ds, ckpts, order, c, code, dx,
                                          dv, grad_out, tally, n_slots, nseg, seg, stream);
  if (mode == 11)  // the shipped PairRun
    return launch_exact<float, Acc, Sum, kPairRun, kReuse>(
        rule, rif, W, H, D, h, ds, ckpts, order, c, code, dx, dv, grad_out, tally, n_slots,
        nseg, seg, stream);
  if constexpr (kPlain) {
    if (mode == 0)  // SplatRun's runs: K6, and K18, K19 before PairRun
      return launch_exact<float, Acc, Acc, kSplatRun>(rule, rif, W, H, D, h, ds, ckpts, order, c,
                                                  code, dx, dv, grad_out, tally, n_slots, nseg,
                                                  seg, stream);
    if (mode == 2) return ANRT_SPLIT(2);
    if (mode == 3) return ANRT_SPLIT(3);
    if (mode == 4) return ANRT_SPLIT(4);
    if (mode == 6) return ANRT_SPLIT(6);
    if (mode == 7) return ANRT_SPLIT(7);
    if (mode == 8) return ANRT_SPLIT(8);
  }
#undef ANRT_SPLIT
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace anrt

extern "C" int anrt_exact_split(int rule, int mode, int tile_bytes, int reuse, int f32_sums,
                                const void* rif, int W, int H, int D, double h, double ds,
                                const void* sdf, const void* pln_o, const void* pln_d,
                                const void* ckpts, const void* order, const void* c,
                                const void* code, const void* dx, const void* dv,
                                void* grad_out, void* tally, void* probe, void* boxes,
                                int n_slots, int nseg, int seg, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto o = static_cast<const int*>(order);
  auto t = static_cast<unsigned long long*>(tally);
  auto bx = static_cast<int*>(boxes);
  if (rule == 0)
    return anrt::run_split<anrt::VolumeRule<float>, float, float, false>(
        mode, tile_bytes, anrt::VolumeRule<float>{}, rif, W, H, D, h, ds, ckpts, o, c, code, dx,
        dv, grad_out, t, probe, bx, n_slots, nseg, seg, s);
  if (rule == 1) {
    const anrt::PlaneRule<float> pr{static_cast<const float*>(pln_o),
                                    static_cast<const float*>(pln_d), nullptr};
    return anrt::run_split<anrt::PlaneRule<float>, float, float, false>(
        mode, tile_bytes, pr, rif, W, H, D, h, ds, ckpts, o, c, code, dx, dv, grad_out, t, probe,
        bx, n_slots, nseg, seg, s);
  }
  const anrt::SdfRule<float> sr{anrt::make_grid<float>(sdf, W, H, D, h)};
#define ANRT_SDF(SUM, REUSE)                                                                 \
  anrt::run_split<anrt::SdfRule<float>, double, SUM, REUSE>(mode, tile_bytes, sr, rif, W, H, \
                                                            D, h, ds, ckpts, o, c, code, dx, \
                                                            dv, grad_out, t, probe, bx,      \
                                                            n_slots, nseg, seg, s)
  if (reuse && f32_sums) return ANRT_SDF(float, true);
  if (reuse) return ANRT_SDF(double, true);
  if (f32_sums) return ANRT_SDF(float, false);
  return ANRT_SDF(double, false);
#undef ANRT_SDF
}

// 1 where the tile's f32 words go to device memory in float4 / float2 adds
extern "C" int anrt_exact_vector_adds() { return ANRT_VECTOR_ATOMICS; }

// Blocks of 128 threads an SM for the kernels of `rule` (as in
// anrt_exact_split; the sdf's with f64 sums and no reuse, but in mode 11, as
// shipped): modes 0, 9, 10 and 11 the ray with its kinds of runs, 5 the tile
// path at tile_bytes
extern "C" int anrt_exact_occupancy(int rule, int mode, int tile_bytes) {
  using namespace anrt;
  int blocks = 0;
  auto tile = [&](auto kernel) {
    if (tile_bytes > 32 * 1024)  // with the static words, past the default 48 KB
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, tile_bytes);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, tile_bytes);
  };
  auto plain = [&](auto kernel) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, 0);
  };
  using VR = VolumeRule<float>;
  using PR = PlaneRule<float>;
  using SR = SdfRule<float>;
  if (mode == 0) {
    if (rule == 0) plain(exact_kernel<ExactRay<float, VR, float, float, kSplatRun, false>>);
    else if (rule == 1) plain(exact_kernel<ExactRay<float, PR, float, float, kSplatRun, false>>);
    else plain(exact_kernel<ExactRay<float, SR, double, double, kSplatRun, false>>);
  } else if (mode == 9) {
    if (rule == 0) plain(exact_kernel<ExactRay<float, VR, float, float, kFaceRunKind, false>>);
    else if (rule == 1) plain(exact_kernel<ExactRay<float, PR, float, float, kFaceRunKind, false>>);
    else plain(exact_kernel<ExactRay<float, SR, double, double, kFaceRunKind, false>>);
  } else if (mode == 11) {
    if (rule == 0) plain(exact_kernel<ExactRay<float, VR, float, float, kPairRun, false>>);
    else if (rule == 1) plain(exact_kernel<ExactRay<float, PR, float, float, kPairRun, false>>);
    else plain(exact_kernel<ExactRay<float, SR, double, float, kPairRun, true>>);
  } else if (mode == 10) {
    if (rule == 0) plain(exact_kernel<ExactRay<float, VR, float, float, kFacePairKind, false>>);
    else if (rule == 1)
      plain(exact_kernel<ExactRay<float, PR, float, float, kFacePairKind, false>>);
    else plain(exact_kernel<ExactRay<float, SR, double, double, kFacePairKind, false>>);
  } else {
    if (rule == 0) tile(exact_tile_kernel<TileRay<float, VR, float, float, false>, float>);
    else if (rule == 1) tile(exact_tile_kernel<TileRay<float, PR, float, float, false>, float>);
    else tile(exact_tile_kernel<TileRay<float, SR, double, double, false>, double>);
  }
  return blocks;
}
