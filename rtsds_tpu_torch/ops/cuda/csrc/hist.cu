// Confusion-matrix histogram for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel rtsds_tpu/ops/pallas/hist.py:fast_hist_pallas
// (_hist_kernel). That kernel builds one-hot(labels)^T @ one-hot(preds) for
// each 2048-pixel tile on the TPU's matrix unit and sums in f32. A GPU has
// no reason to spend a 128x128 matrix product on a histogram, so this one
// counts directly: each block keeps an n x n int32 histogram in shared
// memory, adds to it with atomicAdd over a grid-stride loop, then merges its
// non-zero bins into the global (n, n) int32 output with one atomicAdd each.
// Counts are exact in int32.
//
// A pixel counts only if 0 <= label < n and 0 <= pred < n, the TPU kernel's
// rule (there an out-of-range id gets a zero one-hot row or column).
//
// Bound: bytes. Each pixel reads one int32 label and one int32 prediction,
// 8 B/pixel: 134 MB for an eval batch of 8 x 1024 x 2048 pixels, about
// 0.040 ms at the H100's 3.35 TB/s. What limits this simple form is
// contention on the shared-memory atomics: labels come in spatially coherent
// regions, so most of a warp's 32 pixels hit one bin and serialise.
//
// Plain C interface, loaded with ctypes (rtsds_tpu_torch/ops/cuda/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxClasses = 128;  // 64 KB of shared memory at the most

__global__ void __launch_bounds__(kThreads)
hist_kernel(const int32_t* __restrict__ labels,
            const int32_t* __restrict__ preds, int32_t* __restrict__ out,
            int64_t n_pixels, int num_classes) {
  extern __shared__ int32_t bins[];
  const int n_bins = num_classes * num_classes;
  for (int i = threadIdx.x; i < n_bins; i += blockDim.x) bins[i] = 0;
  __syncthreads();

  // one unsigned compare per id also rejects negative ids
  const uint32_t n = static_cast<uint32_t>(num_classes);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n_pixels; i += stride) {
    const uint32_t l = static_cast<uint32_t>(__ldg(labels + i));
    const uint32_t p = static_cast<uint32_t>(__ldg(preds + i));
    if (l < n && p < n) atomicAdd(&bins[l * n + p], 1);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < n_bins; i += blockDim.x) {
    const int32_t c = bins[i];
    if (c != 0) atomicAdd(&out[i], c);
  }
}

}  // namespace

extern "C" {

// Adds the histogram of (labels, preds) to `out`, which the caller zeroes.
// Returns a cudaError_t: 0 when the launch was accepted.
int rtsds_hist_launch(const void* labels, const void* preds, void* out,
                      long long n_pixels, int num_classes, int max_blocks,
                      void* stream) {
  if (num_classes < 1 || num_classes > kMaxClasses || max_blocks < 1 ||
      n_pixels < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_pixels == 0) return static_cast<int>(cudaSuccess);
  const int smem = static_cast<int>(sizeof(int32_t)) * num_classes *
                   num_classes;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  long long blocks = (n_pixels + kThreads - 1) / kThreads;
  if (blocks > max_blocks) blocks = max_blocks;
  hist_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(labels), static_cast<const int32_t*>(preds),
      static_cast<int32_t*>(out), static_cast<int64_t>(n_pixels),
      num_classes);
  return static_cast<int>(cudaGetLastError());
}

const char* rtsds_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
