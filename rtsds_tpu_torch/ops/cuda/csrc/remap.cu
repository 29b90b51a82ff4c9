// GTA5 RGB-coded label -> trainId remap for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel rtsds_tpu/ops/pallas/remap.py:rgb_to_train_ids_pallas
// (_remap_kernel). That kernel widens each pixel to int32, pads the channel
// axis 3 -> 4, and compares each pixel's key with 128 class keys laid across
// the TPU's lanes. This one computes the same function, not that layout: it
// reads the packed uint8 RGB bytes as they are, forms the 24-bit key
// R*65536 + G*256 + B, looks it up in a hash table of the class keys, and
// writes the index of the FIRST table row with that key as int32, or
// `default_id` where no row has it.
//
// Bound: bytes. Each pixel reads 3 B and writes 4 B, 7 B/pixel: 51.6 MB
// for a training batch of 8 x 720 x 1280 pixels, 0.0154 ms at the H100's
// 3.35 TB/s. Two things keep the work under that bound:
// - O(1) work per pixel, whatever the number of keys. The host
//   (rtsds_tpu_torch/ops/cuda/remap.py) drops the rows no pixel can match,
//   keeps the first of equal keys, and builds an open-addressed table of
//   2^bits slots with the hash slot = (key * multiplier) >> (32 - bits),
//   searching seeded odd multipliers for the fewest linear probes. The
//   19-key GTA5 table gets a perfect hash into 32 slots: one slot per
//   shared-memory bank, so a warp's lookups never conflict. A pixel then
//   costs one multiply, `probes` shared-memory reads (1 for GTA5), a
//   compare and a select; the loop has no early exit, so a warp never
//   diverges. A slot holds key | id << 24 (ids < 128 leave bit 31 clear);
//   an empty slot holds 0xFFFFFFFF, whose bit 31 no 24-bit key has, so no
//   pixel, white and black included, matches it.
// - 16-byte memory operations with many bytes in flight. Each block owns a
//   tile of 4096 pixels. Its 256 threads first issue three coalesced 16 B
//   loads each (the tile's 12 KB) into shared memory; each thread then
//   reads 4 groups of 4 pixels from there (three 32-bit words a group, at
//   a stride of 3 words: no bank conflicts) and writes each group's ids
//   with one streaming 16 B store, so a warp's store covers 512 B in a
//   row. Eight blocks on an SM keep up to 96 KB of loads in flight. A last
//   partial tile is done one pixel a thread, with byte loads.
// The table travels in the kernel's parameters (__grid_constant__, 2 KB at
// the most), so a launch needs no device copy of it.
//
// Plain C interface, loaded with ctypes (rtsds_tpu_torch/ops/cuda/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroupsPerThread = 4;  // of 4 pixels each
constexpr int kTilePixels = kThreads * kGroupsPerThread * 4;  // 4096
constexpr int kTileVectors = kTilePixels * 3 / 16;           // 768 x 16 B
constexpr int kMinBits = 5;
constexpr int kMaxBits = 9;
constexpr uint32_t kKeyMask = 0x80ffffffu;  // the key and the empty bit

struct SlotTable {
  uint32_t slot[1 << kMaxBits];
};

__device__ __forceinline__ int32_t lookup(uint32_t key, const uint32_t* tab,
                                          uint32_t multiplier, int shift,
                                          uint32_t mask, int probes,
                                          int32_t default_id) {
  const uint32_t home = (key * multiplier) >> shift;
  // the first probe needs no wrap; a one-probe table skips the loop
  const uint32_t w0 = tab[home];
  int32_t id =
      (w0 & kKeyMask) == key ? static_cast<int32_t>(w0 >> 24) : default_id;
  for (int j = 1; j < probes; ++j) {
    const uint32_t w = tab[(home + j) & mask];
    if ((w & kKeyMask) == key) id = static_cast<int32_t>(w >> 24);
  }
  return id;
}

__global__ void __launch_bounds__(kThreads, 8)
remap_kernel(const uint8_t* __restrict__ rgb, int32_t* __restrict__ out,
             int64_t n_pixels, const __grid_constant__ SlotTable table,
             int bits, uint32_t multiplier, int probes, int32_t default_id) {
  __shared__ uint32_t tab[1 << kMaxBits];
  __shared__ uint4 tile[kTileVectors];
  const int t = threadIdx.x;
  const int n_slots = 1 << bits;
  const int shift = 32 - bits;
  const uint32_t mask = static_cast<uint32_t>(n_slots - 1);
  for (int i = t; i < n_slots; i += kThreads) tab[i] = table.slot[i];

  const int64_t first = static_cast<int64_t>(blockIdx.x) * kTilePixels;
  if (n_pixels - first >= kTilePixels) {
    const uint4* src = reinterpret_cast<const uint4*>(rgb + first * 3);
    const uint4 v0 = __ldcs(src + t);
    const uint4 v1 = __ldcs(src + t + kThreads);
    const uint4 v2 = __ldcs(src + t + 2 * kThreads);
    tile[t] = v0;
    tile[t + kThreads] = v1;
    tile[t + 2 * kThreads] = v2;
    __syncthreads();

    const uint32_t* words = reinterpret_cast<const uint32_t*>(tile);
    int4* dst = reinterpret_cast<int4*>(out + first);
#pragma unroll
    for (int k = 0; k < kGroupsPerThread; ++k) {
      const int g = t + k * kThreads;
      // bytes r0 g0 b0 r1 | g1 b1 r2 g2 | b2 r3 g3 b3, little-endian words
      const uint32_t w0 = words[3 * g];
      const uint32_t w1 = words[3 * g + 1];
      const uint32_t w2 = words[3 * g + 2];
      const uint32_t k0 = ((w0 & 0xffu) << 16) | (w0 & 0xff00u) |
                          ((w0 >> 16) & 0xffu);
      const uint32_t k1 = ((w0 >> 24) << 16) | ((w1 & 0xffu) << 8) |
                          ((w1 >> 8) & 0xffu);
      const uint32_t k2 = (((w1 >> 16) & 0xffu) << 16) | ((w1 >> 24) << 8) |
                          (w2 & 0xffu);
      const uint32_t k3 = (((w2 >> 8) & 0xffu) << 16) |
                          (((w2 >> 16) & 0xffu) << 8) | (w2 >> 24);
      __stcs(dst + g,
             make_int4(
                 lookup(k0, tab, multiplier, shift, mask, probes, default_id),
                 lookup(k1, tab, multiplier, shift, mask, probes, default_id),
                 lookup(k2, tab, multiplier, shift, mask, probes, default_id),
                 lookup(k3, tab, multiplier, shift, mask, probes,
                        default_id)));
    }
  } else {
    // the last, partial tile: fewer than 4096 pixels
    __syncthreads();
    for (int64_t p = first + t; p < n_pixels; p += kThreads) {
      const uint32_t key = (static_cast<uint32_t>(rgb[3 * p]) << 16) |
                           (static_cast<uint32_t>(rgb[3 * p + 1]) << 8) |
                           static_cast<uint32_t>(rgb[3 * p + 2]);
      out[p] = lookup(key, tab, multiplier, shift, mask, probes, default_id);
    }
  }
}

}  // namespace

extern "C" {

// Writes the trainId of each of `n_pixels` packed RGB pixels into `out`.
// `slots` points to the 2^bits host words of the hash table (see above);
// `multiplier` is odd; each pixel reads `probes` slots from its hashed one
// on. `rgb` and `out` must be 16-byte aligned. Returns a cudaError_t: 0
// when the launch was accepted.
int rtsds_remap_launch(const uint8_t* rgb, int32_t* out, long long n_pixels,
                       const uint32_t* slots, int bits, uint32_t multiplier,
                       int probes, int32_t default_id, cudaStream_t stream) {
  if (n_pixels < 0 || slots == nullptr || bits < kMinBits ||
      bits > kMaxBits || probes < 1 || probes > (1 << bits) ||
      (multiplier & 1u) == 0 || reinterpret_cast<uintptr_t>(rgb) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_pixels == 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (n_pixels + kTilePixels - 1) / kTilePixels;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  SlotTable table = {};
  memcpy(table.slot, slots, sizeof(uint32_t) << bits);
  remap_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      rgb, out, static_cast<int64_t>(n_pixels), table, bits, multiplier,
      probes, default_id);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
