// The L2 access-policy window for tools/slab_bands.py: a probe of whether
// marking a z-band of the slab "persisting" in the H100's L2 speeds up the
// slab ring's phase kernels (K21, K22) on that band.  No path of the port
// calls these.
#include <cuda_runtime.h>

#include <cstddef>

// The largest window and persisting set-aside the card takes, in bytes.
extern "C" int probe_l2_limits(int device, int* max_window, int* max_persisting) {
  cudaError_t err = cudaDeviceGetAttribute(max_window, cudaDevAttrMaxAccessPolicyWindowSize,
                                           device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(max_persisting, cudaDevAttrMaxPersistingL2CacheSize, device);
  return static_cast<int>(err);
}

// Set aside `bytes` of L2 for persisting lines (this process's context only).
extern "C" int probe_l2_set_aside(size_t bytes) {
  return static_cast<int>(cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, bytes));
}

// Kernels launched on `stream` from now on keep [base, base + bytes) in L2 as
// persisting lines (a share `hit_ratio` of them); bytes 0 clears the window
// and returns the persisting lines to normal.
extern "C" int probe_l2_window(void* base, size_t bytes, float hit_ratio, void* stream) {
  cudaStreamAttrValue attr = {};
  attr.accessPolicyWindow.base_ptr = base;
  attr.accessPolicyWindow.num_bytes = bytes;
  attr.accessPolicyWindow.hitRatio = bytes ? hit_ratio : 0.0f;
  attr.accessPolicyWindow.hitProp = bytes ? cudaAccessPropertyPersisting
                                          : cudaAccessPropertyNormal;
  attr.accessPolicyWindow.missProp = cudaAccessPropertyStreaming;
  cudaError_t err = cudaStreamSetAttribute(static_cast<cudaStream_t>(stream),
                                           cudaStreamAttributeAccessPolicyWindow, &attr);
  if (err == cudaSuccess && bytes == 0) err = cudaCtxResetPersistingL2Cache();
  return static_cast<int>(err);
}
