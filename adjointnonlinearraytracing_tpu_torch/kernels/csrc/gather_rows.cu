// K4 gather_rows: out[i, :] = table[idx[i], :] for N indices into an (R, L)
// table, one warp per row.
//
// Replaces the semaphore-ring row gather of the JAX package's probe
// (benchmarks/probe_dma_gather.py::_ring_kernel).  That ring keeps `slots`
// row copies in flight because its chip moves one row per DMA descriptor and
// a single descriptor in flight leaves the memory idle.  Here the function
// is kept (rows of a table picked by an index vector) and the ring is not: a
// warp owns a row, each lane moves 16 bytes per pass, so the 32 lanes of one
// pass cover 512 contiguous bytes (one f32 row of 128), and the thousands of
// warps resident on the card are the copies in flight.
//
// Bound by bytes: every row is read once and written once, plus the index.
// The kernel moves 16-byte vectors whatever the element type, so one
// instantiation per index width serves f32 and f64 tables alike; the result
// is bit-exact by construction.  Indices are not range-checked (neither does
// the kernel it replaces): an index outside [0, R) reads outside the table.
#include <cuda_runtime.h>

namespace anrt {

constexpr int kGatherThreads = 256;            // 8 warps a block
constexpr int kGatherMaxBlocks = 132 * 32;     // grid-stride beyond this

template <typename Index>
__global__ void gather_rows_kernel(const uint4* __restrict__ table,
                                   const Index* __restrict__ idx,
                                   uint4* __restrict__ out, long long n_rows,
                                   int vecs_per_row) {
  const int lane = threadIdx.x & 31;
  const long long warps = (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  long long i = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  for (; i < n_rows; i += warps) {
    // every lane reads the same index: one broadcast load
    const long long r = static_cast<long long>(idx[i]);
    const uint4* src = table + r * vecs_per_row;
    uint4* dst = out + i * vecs_per_row;
    for (int k = lane; k < vecs_per_row; k += 32) dst[k] = src[k];
  }
}

template <typename Index>
int launch_gather_rows(const void* table, const void* idx, void* out, long long n_rows,
                       int vecs_per_row, cudaStream_t stream) {
  if (n_rows > 0) {
    const int warps_per_block = kGatherThreads / 32;
    long long blocks = (n_rows + warps_per_block - 1) / warps_per_block;
    if (blocks > kGatherMaxBlocks) blocks = kGatherMaxBlocks;
    gather_rows_kernel<Index><<<static_cast<int>(blocks), kGatherThreads, 0, stream>>>(
        static_cast<const uint4*>(table), static_cast<const Index*>(idx),
        static_cast<uint4*>(out), n_rows, vecs_per_row);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace anrt

// idx_is_64 selects the index width; vecs_per_row is the row length in
// 16-byte vectors.  table and out must be 16-byte aligned.  Returns
// cudaGetLastError() after the launch.
extern "C" int anrt_gather_rows(int idx_is_64, const void* table, const void* idx, void* out,
                                long long n_rows, int vecs_per_row, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return idx_is_64
             ? anrt::launch_gather_rows<long long>(table, idx, out, n_rows, vecs_per_row, s)
             : anrt::launch_gather_rows<int>(table, idx, out, n_rows, vecs_per_row, s);
}
