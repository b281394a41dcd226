// The kernel shell of the adjoint sweeps, K3 backtrace and K14 backtrace_sdf
// (K22's on its global path): where the splats' runs go and how the launch
// is shaped.  A ray's own work is the caller's functor `ray(i, acc, counts)`:
// thread slot i, the accumulator its runs flush into, and two counters it adds
// to (runs flushed, flushes issued).
//
//   * "global" path: 128-thread blocks, one slot a thread, runs go straight
//     into the flat (D*H*W) gradient in device memory;
//   * "shared" path, where the D*H*W gradient fits one block's shared memory
//     (kSharedMax bytes: f32 up to 38^3, f64 up to 30^3): persistent
//     512-thread blocks, as many as fill the SMs at the occupancy that size
//     allows, walk the slots with a grid-stride loop and flush runs into a
//     block-private gradient with shared-memory atomics, then add its nonzero
//     words to device memory once.
//
// Which path runs is the caller's choice (kernels/wrappers.py decides K3's
// from the grid's size and type alone); a refused launch is an error, not a
// retry.  T is the accumulator's type: the grid's for K3, double for K14.
// The exact gradient's backward passes (K6, K18, K19) have a kernel of their
// own in backtrace_exact.cu, the global path's shape.
#pragma once

#include "trilinear.cuh"

namespace anrt {

// the opt-in dynamic shared memory of one block on sm_90 (227 KB)
constexpr int kSharedMax = 232448;
constexpr int kSharedThreads = 512;

// tally: null, or three counters the kernel adds to: runs flushed, flushes
// issued after the warp's lanes summed equal targets (8 atomic adds each)
// and, on the shared path, the adds of the block-private gradient into
// grad_out.
template <typename T, bool kShared, typename Ray>
__global__ void __launch_bounds__(kShared ? kSharedThreads : kThreads)
adjoint_kernel(Ray ray, int n_cells, T* __restrict__ grad_out,
               unsigned long long* __restrict__ tally, int n_slots) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* acc = grad_out;
  if (kShared) {
    acc = reinterpret_cast<T*>(smem);
    for (int j = threadIdx.x; j < n_cells; j += blockDim.x) acc[j] = 0;
    __syncthreads();
  }
  const int stride = gridDim.x * blockDim.x;
  unsigned long long counts[2] = {0, 0}, adds = 0;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_slots; i += stride)
    ray(i, acc, counts);
  if (kShared) {
    __syncthreads();
    for (int j = threadIdx.x; j < n_cells; j += blockDim.x) {
      const T sum = acc[j];
      if (sum != static_cast<T>(0)) {
        atomicAdd(grad_out + j, sum);
        ++adds;
      }
    }
  }
  if (tally != nullptr) {
    if (counts[0]) atomicAdd(tally, counts[0]);
    if (counts[1]) atomicAdd(tally + 1, counts[1]);
    if (adds) atomicAdd(tally + 2, adds);
  }
}

// Launches `ray` over n_slots thread slots on the path `use_shared` names;
// returns the launch's CUDA error (0 on success).
template <typename T, typename Ray>
int launch_adjoint(const Ray& ray, int n_cells, void* grad_out, unsigned long long* tally,
                   int n_slots, int use_shared, cudaStream_t stream) {
  if (n_slots <= 0) return static_cast<int>(cudaGetLastError());
  T* out = static_cast<T*>(grad_out);
  if (!use_shared) {
    adjoint_kernel<T, false, Ray><<<blocks_for(n_slots), kThreads, 0, stream>>>(
        ray, n_cells, out, tally, n_slots);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t bytes = static_cast<size_t>(n_cells) * sizeof(T);
  if (bytes > static_cast<size_t>(kSharedMax)) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = adjoint_kernel<T, true, Ray>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kSharedThreads, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int wanted = (n_slots + kSharedThreads - 1) / kSharedThreads;
  const int blocks = per_sm * sms < wanted ? per_sm * sms : wanted;
  kernel<<<blocks, kSharedThreads, bytes, stream>>>(ray, n_cells, out, tally, n_slots);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace anrt
