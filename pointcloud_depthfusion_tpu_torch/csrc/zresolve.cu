// Per-pixel z-buffer resolve by one 64-bit atomicMin per entry.
//
// Replaces the Pallas kernels _resolve3_kernel (zresolve_sorted_entries) and
// _resolve_rgb_kernel (zresolve_winner_rgb) in
// pointcloud_depthfusion_tpu/ops/pallas/zresolve_pallas.py. The TPU version
// sorts the entries by pixel and resolves sorted slabs, because a TPU
// scatter-min is a serial loop. Hopper has native 64-bit atomics, so the
// contract is computed directly: per pixel, the lexicographic minimum of
// (zbits, rgb), both compared as signed i32. XOR-ing each word's sign bit
// maps signed order onto unsigned order, so
//     key = ((u64)(u32)(zbits ^ 0x80000000) << 32) | (u32)(rgb ^ 0x80000000)
// orders exactly like the pair, and the winner is the minimum key.
// The result does not depend on the order of the atomics: it is bit-exact
// and deterministic.
//
// Bound: about 12 B read plus one 8 B atomic per entry, and 8 B per pixel
// for the fill and the decode. Memory-bound; entries per pixel are few
// (two cameras), so atomic contention is low.
// Later: fuse the per-pixel prep (deproject, transform, project) into the
// scatter, and the decode into the color filter.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned int kSign = 0x80000000u;
constexpr int kThreads = 256;

__global__ void fill_keys(unsigned long long* keys, int n_px) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_px;
       i += gridDim.x * blockDim.x) {
    keys[i] = ~0ull;  // key of (INT32_MAX, INT32_MAX)
  }
}

__global__ void scatter_min(const int* __restrict__ pix,
                            const int* __restrict__ zbits,
                            const int* __restrict__ rgb, int n,
                            unsigned long long* keys, int n_px) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const int p = pix[i];
    if (p < 0 || p >= n_px) continue;
    const unsigned int hi = static_cast<unsigned int>(zbits[i]) ^ kSign;
    const unsigned int lo =
        rgb ? (static_cast<unsigned int>(rgb[i]) ^ kSign) : 0u;
    atomicMin(keys + p, (static_cast<unsigned long long>(hi) << 32) | lo);
  }
}

__global__ void decode_keys(const unsigned long long* __restrict__ keys,
                            int n_px, int* minz, int* mrgb) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_px;
       i += gridDim.x * blockDim.x) {
    const unsigned long long k = keys[i];
    if (minz) minz[i] = static_cast<int>(static_cast<unsigned int>(k >> 32) ^ kSign);
    if (mrgb) mrgb[i] = static_cast<int>(static_cast<unsigned int>(k) ^ kSign);
  }
}

int blocks_for(int n) {
  int b = (n + kThreads - 1) / kThreads;
  // Grid-stride loops: a few waves over 132 SMs are enough.
  return b < 1 ? 1 : (b > 132 * 16 ? 132 * 16 : b);
}

}  // namespace

// pix, zbits: (n,) i32. rgb: (n,) i32 or null (depth-only resolve).
// keys: (n_px,) u64 scratch. minz, mrgb: (n_px,) i32 outputs, either may be
// null. Launches on `stream`; returns cudaGetLastError().
extern "C" int zresolve_launch(const int* pix, const int* zbits, const int* rgb,
                               int n, unsigned long long* keys, int n_px,
                               int* minz, int* mrgb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fill_keys<<<blocks_for(n_px), kThreads, 0, s>>>(keys, n_px);
  if (n > 0) {
    scatter_min<<<blocks_for(n), kThreads, 0, s>>>(pix, zbits, rgb, n, keys, n_px);
  }
  decode_keys<<<blocks_for(n_px), kThreads, 0, s>>>(keys, n_px, minz, mrgb);
  return static_cast<int>(cudaGetLastError());
}
