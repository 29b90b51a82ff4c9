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
// The kernel reads the ids in the dtype its caller holds them in (int32,
// int64 or uint8, chosen per argument), so the wrapper makes no copy: the
// eval step passes int32 labels and the int64 argmax of its logits.
//
// Bound: bytes. Each pixel reads one label and one prediction in their own
// dtypes: with int32 labels and int64 predictions that is 12 B/pixel, 201 MB
// for an eval batch of 8 x 1024 x 2048 pixels, about 0.060 ms at the H100's
// 3.35 TB/s. What limits this simple form is contention on the shared-memory
// atomics: labels come in spatially coherent regions, so most of a warp's 32
// pixels hit one bin and serialise.
//
// Plain C interface, loaded with ctypes (rtsds_tpu_torch/ops/cuda/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxClasses = 128;  // 64 KB of shared memory at the most

// 0 <= id < n, compared in the id's own width: a negative int64 id, or one
// of 2^32 and above, is dropped and never wraps into range
template <typename T>
__device__ __forceinline__ bool in_range(T id, int n) {
  if constexpr (std::is_unsigned<T>::value) {
    return id < static_cast<T>(n);
  } else {
    return id >= T(0) && id < static_cast<T>(n);
  }
}

template <typename L, typename P>
__global__ void __launch_bounds__(kThreads)
hist_kernel(const L* __restrict__ labels, const P* __restrict__ preds,
            int32_t* __restrict__ out, int64_t n_pixels, int num_classes) {
  extern __shared__ int32_t bins[];
  const int n_bins = num_classes * num_classes;
  for (int i = threadIdx.x; i < n_bins; i += blockDim.x) bins[i] = 0;
  __syncthreads();

  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n_pixels; i += stride) {
    const L l = labels[i];
    const P p = preds[i];
    if (in_range(l, num_classes) && in_range(p, num_classes)) {
      atomicAdd(&bins[static_cast<int>(l) * num_classes +
                      static_cast<int>(p)], 1);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < n_bins; i += blockDim.x) {
    const int32_t c = bins[i];
    if (c != 0) atomicAdd(&out[i], c);
  }
}

template <typename L, typename P>
cudaError_t launch(const void* labels, const void* preds, void* out,
                   long long n_pixels, int num_classes, int max_blocks,
                   cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(int32_t)) * num_classes *
                   num_classes;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        hist_kernel<L, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
  }
  long long blocks = (n_pixels + kThreads - 1) / kThreads;
  if (blocks > max_blocks) blocks = max_blocks;
  hist_kernel<L, P><<<static_cast<unsigned>(blocks), kThreads, smem,
                      stream>>>(
      static_cast<const L*>(labels), static_cast<const P*>(preds),
      static_cast<int32_t*>(out), static_cast<int64_t>(n_pixels),
      num_classes);
  return cudaGetLastError();
}

// the ids' dtype codes of the C interface
enum IdType { kInt32 = 0, kInt64 = 1, kUint8 = 2 };

template <typename L>
cudaError_t launch_for_preds(int pred_type, const void* labels,
                             const void* preds, void* out, long long n_pixels,
                             int num_classes, int max_blocks,
                             cudaStream_t stream) {
  switch (pred_type) {
    case kInt32:
      return launch<L, int32_t>(labels, preds, out, n_pixels, num_classes,
                                max_blocks, stream);
    case kInt64:
      return launch<L, int64_t>(labels, preds, out, n_pixels, num_classes,
                                max_blocks, stream);
    case kUint8:
      return launch<L, uint8_t>(labels, preds, out, n_pixels, num_classes,
                                max_blocks, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Adds the histogram of (labels, preds) to `out`, which the caller zeroes.
// `label_type` and `pred_type` are IdType codes. Returns a cudaError_t: 0
// when the launch was accepted.
int rtsds_hist_launch(const void* labels, const void* preds, void* out,
                      long long n_pixels, int num_classes, int max_blocks,
                      int label_type, int pred_type, void* stream) {
  if (num_classes < 1 || num_classes > kMaxClasses || max_blocks < 1 ||
      n_pixels < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_pixels == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (label_type) {
    case kInt32:
      return static_cast<int>(launch_for_preds<int32_t>(
          pred_type, labels, preds, out, n_pixels, num_classes, max_blocks,
          s));
    case kInt64:
      return static_cast<int>(launch_for_preds<int64_t>(
          pred_type, labels, preds, out, n_pixels, num_classes, max_blocks,
          s));
    case kUint8:
      return static_cast<int>(launch_for_preds<uint8_t>(
          pred_type, labels, preds, out, n_pixels, num_classes, max_blocks,
          s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* rtsds_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
