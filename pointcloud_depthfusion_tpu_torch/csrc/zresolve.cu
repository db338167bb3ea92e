// Per-pixel z-buffer resolve: one launch per resolve over a persistent key
// buffer.
//
// Replaces the Pallas kernels _resolve3_kernel (zresolve_sorted_entries and
// its legacy (4, N) feed), _resolve_rgb_kernel (zresolve_winner_rgb) and
// _streams_kernel (zresolve_sorted_streams, whose (S, N) streams arrive here
// as S·N contiguous entries) in
// pointcloud_depthfusion_tpu/ops/pallas/zresolve_pallas.py. The TPU version
// sorts the entries by pixel and resolves sorted slabs, because a TPU
// scatter-min is a serial loop. Hopper has native 32- and 64-bit atomics,
// so the contract is computed directly: per pixel, the lexicographic
// minimum of (zbits, rgb), both compared as signed i32. XOR-ing each word's
// sign bit maps signed order onto unsigned order, so
//     key = ((u64)(u32)(zbits ^ 0x80000000) << 32) | (u32)(rgb ^ 0x80000000)
// orders exactly like the pair, and the winner is the minimum key. A
// depth-only resolve (no rgb) needs only the high word: a 32-bit key and a
// 32-bit atomicMin. The result does not depend on the order of the
// atomics: it is bit-exact and deterministic.
//
// Two feeds. The unmasked feed is the JAX API's (pix, zbits, rgb), with
// dropped entries already routed to an invalid pixel id. The masked feed
// takes what the render's prep produces (pixel index, f32 z, a bool mask,
// rgb24) and drops an entry whose mask is 0 in the kernel: the torch.where
// composition it replaces (pix ← INVALID_PIX, zbits ← INT32_MAX, rgb ←
// INT32_MAX where the mask is off) drops exactly those entries, and on the
// others zbits is z's bit pattern (__float_as_int), so the two agree bit
// for bit.
//
// Bound on this card: the entries are read once (12 B each, 13 B masked),
// each valid one is one 8 B (4 B depth-only) atomicMin into a key buffer
// that stays in the 50 MB L2, and the decode reads each pixel's key,
// writes it back where it was set and writes 4-8 B of results. At the
// fused frame's N = 814,080 and n_px = 407,040 the bytes take 3.4-3.9 µs
// at 3.35 TB/s, but the ~685,000 atomics take longer: the kernel runs in
// about 9 µs on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 6,
// profiler device time), of which the replaced design's scatter alone took
// 10 µs. Entry loads are 16 B a thread (int4, the mask as one 32-bit word
// of four bytes) where the pointers allow, with a scalar loop for the
// ragged tail and for unaligned views. Many entries on one pixel serialize
// their atomics on that key; chip_smoke.py times 100,000 entries on 64
// pixels.
//
// What the design does about the host and the passes. The replaced design
// filled a fresh 8 B × n_px scratch buffer, scattered and decoded in three
// launches. Here the wrapper keeps one key buffer per (device, stream),
// filled with all-ones once when it is allocated; the decode reads each key
// of [0, n_px) and writes all-ones back where a key was set, so every call
// leaves the buffer as it found it and no call needs a fill pass or a
// scratch allocation. The same bytes serve the 32-bit keys of a
// depth-only resolve (all-ones either way).
//
// Why one launch. The scatter and the decode must not interleave with
// another resolve's on the same buffer. With two launches on one stream,
// two host threads (two node apps on the default stream) could enqueue
// scatter₁, scatter₂, decode₁, decode₂ and corrupt both results. So both
// phases run in one cooperative launch (cudaLaunchCooperativeKernel, every
// block resident), separated by a grid-wide barrier
// (cooperative_groups::this_grid().sync(), which needs no relocatable
// device code), with grid-stride loops on both sides: each resolve is one
// atomic unit on its stream, and the wrapper needs no lock around it.
// Measured on the card against the same scatter and decode as two
// launches, the barrier cost no more than the second launch.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned int kSign = 0x80000000u;
constexpr int kThreads = 256;
constexpr int kResolveThreads = 512;

struct Resolve {
  const int* pix;           // (n,) pixel id; outside [0, n_px) is dropped
  const int* zbits;         // (n,) z bits (an f32's bit pattern on the masked feed)
  const unsigned char* ok;  // (n,) mask, 0 drops the entry; unread on the unmasked feed
  const int* rgb;           // (n,) rgb; unread by a depth-only resolve
  int n;
  int n_px;
  void* keys;               // n_px u64 keys (u32 depth-only), all-ones between calls
  int* minz;                // (n_px,) min z bits, or null
  int* mrgb;                // (n_px,) rgb of the winner, or null
  bool vec;                 // entries 16 B aligned (the mask 4 B): int4 loads
};

template <bool kRgb, bool kMask>
__device__ __forceinline__ void put(const Resolve& r, int p, int z, int c, unsigned int ok) {
  if (kMask && ok == 0u) return;
  if (static_cast<unsigned int>(p) >= static_cast<unsigned int>(r.n_px)) return;
  const unsigned int hi = static_cast<unsigned int>(z) ^ kSign;
  if (kRgb) {
    const unsigned int lo = static_cast<unsigned int>(c) ^ kSign;
    atomicMin(static_cast<unsigned long long*>(r.keys) + p,
              (static_cast<unsigned long long>(hi) << 32) | lo);
  } else {
    atomicMin(static_cast<unsigned int*>(r.keys) + p, hi);
  }
}

template <bool kRgb, bool kMask>
__device__ __forceinline__ void scatter(const Resolve& r, int tid, int stride) {
  int done = 0;
  if (r.vec) {
    const int nq = r.n >> 2;
    const int4* pix4 = reinterpret_cast<const int4*>(r.pix);
    const int4* z4 = reinterpret_cast<const int4*>(r.zbits);
    const int4* rgb4 = reinterpret_cast<const int4*>(r.rgb);
    const unsigned int* ok4 = reinterpret_cast<const unsigned int*>(r.ok);
    for (int q = tid; q < nq; q += stride) {
      const int4 p = __ldg(pix4 + q);
      const int4 z = __ldg(z4 + q);
      const int4 c = kRgb ? __ldg(rgb4 + q) : make_int4(0, 0, 0, 0);
      const unsigned int m = kMask ? __ldg(ok4 + q) : 0x01010101u;
      put<kRgb, kMask>(r, p.x, z.x, c.x, m & 0xFFu);
      put<kRgb, kMask>(r, p.y, z.y, c.y, (m >> 8) & 0xFFu);
      put<kRgb, kMask>(r, p.z, z.z, c.z, (m >> 16) & 0xFFu);
      put<kRgb, kMask>(r, p.w, z.w, c.w, m >> 24);
    }
    done = nq << 2;
  }
  // The ragged tail, or every entry of an unaligned view.
  for (int i = done + tid; i < r.n; i += stride) {
    put<kRgb, kMask>(r, __ldg(r.pix + i), __ldg(r.zbits + i), kRgb ? __ldg(r.rgb + i) : 0,
                     kMask ? r.ok[i] : 1u);
  }
}

// Decode each pixel's key into the outputs and reset it to all-ones.
template <bool kRgb>
__device__ __forceinline__ void decode_reset(const Resolve& r, int tid, int stride) {
  if (kRgb) {
    unsigned long long* keys = static_cast<unsigned long long*>(r.keys);
    for (int i = tid; i < r.n_px; i += stride) {
      const unsigned long long k = __ldcg(keys + i);
      if (k != ~0ull) keys[i] = ~0ull;
      if (r.minz) r.minz[i] = static_cast<int>(static_cast<unsigned int>(k >> 32) ^ kSign);
      if (r.mrgb) r.mrgb[i] = static_cast<int>(static_cast<unsigned int>(k) ^ kSign);
    }
  } else {
    unsigned int* keys = static_cast<unsigned int*>(r.keys);
    for (int i = tid; i < r.n_px; i += stride) {
      const unsigned int k = __ldcg(keys + i);
      if (k != ~0u) keys[i] = ~0u;
      if (r.minz) r.minz[i] = static_cast<int>(k ^ kSign);
    }
  }
}

template <bool kRgb, bool kMask>
__global__ void __launch_bounds__(kResolveThreads) resolve(Resolve r) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  scatter<kRgb, kMask>(r, tid, stride);
  cg::this_grid().sync();
  decode_reset<kRgb>(r, tid, stride);
}

// The most blocks of `kernel` that are resident at once on the current
// device (the occupancy on every SM): the size of a cooperative launch.
int resident_most(const void* kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kResolveThreads, 0);
  return sms * per_sm;
}

template <bool kRgb, bool kMask>
int launch_resolve(Resolve r, cudaStream_t s) {
  const void* kernel = reinterpret_cast<const void*>(&resolve<kRgb, kMask>);
  // Asked once per process (every card of a host is of one kind).
  static const int most = resident_most(kernel);
  // Entries are taken four at a time, pixels one at a time; no more blocks
  // than the work needs, since each one waits at the barrier.
  const int quads = (r.n + 3) / 4;
  const int work = quads > r.n_px ? quads : r.n_px;
  int blocks = (work + kResolveThreads - 1) / kResolveThreads;
  blocks = blocks < most ? blocks : most;
  void* args[] = {&r};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      kernel, dim3(blocks < 1 ? 1 : blocks), dim3(kResolveThreads), args, 0, s));
}

int blocks_for(int n) {
  int b = (n + kThreads - 1) / kThreads;
  // Grid-stride loops: a few waves over 132 SMs are enough.
  return b < 1 ? 1 : (b > 132 * 16 ? 132 * 16 : b);
}

bool aligned(const void* p, uintptr_t to) {
  return (reinterpret_cast<uintptr_t>(p) & (to - 1)) == 0;
}

}  // namespace

// pix, zbits: (n,) i32. ok: (n,) bytes, 0 drops the entry, read when
// with_ok (which needs with_rgb). rgb: (n,) i32, read when with_rgb, else
// the resolve is depth-only (32-bit keys). (An empty tensor's pointer may
// be null, so the flags and not the pointers say what the feed holds.)
// keys: at least n_px u64 with every bit set, and left so. minz, mrgb:
// (n_px,) i32 outputs, either may be null. One cooperative launch on
// `stream`; returns its status, or cudaGetLastError() when the launch
// itself succeeded.
extern "C" int zresolve_launch(const int* pix, const int* zbits, const unsigned char* ok,
                               const int* rgb, int n, int with_ok, int with_rgb,
                               unsigned long long* keys, int n_px, int* minz, int* mrgb,
                               void* stream) {
  if (with_ok && !with_rgb) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Resolve r{pix, zbits, ok, rgb, n, n_px, keys, minz, mrgb, false};
  r.vec = aligned(pix, 16) && aligned(zbits, 16) && aligned(rgb, 16) && aligned(ok, 4);
  const int status = !with_rgb ? launch_resolve<false, false>(r, s)
                     : with_ok ? launch_resolve<true, true>(r, s)
                               : launch_resolve<true, false>(r, s);
  return status ? status : static_cast<int>(cudaGetLastError());
}

// Per-slot unsigned 32-bit minimum: the packed, indexed and pallas render
// modes' `buf.at[idx].min(key, mode="drop")` (an XLA scatter in the JAX
// package, pointcloud_depthfusion_tpu/ops/render.py:218, :286 and
// fusion/pipeline.py:358; no Pallas kernel). Keys arrive as the bit
// patterns of i32 tensors. One 32-bit atomicMin per entry; order-free, so
// deterministic. Bound: 8 B read per entry, 4 B written per slot.
namespace {

__global__ void fill_u32(unsigned int* out, int n_slots) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_slots;
       i += gridDim.x * blockDim.x) {
    out[i] = 0xFFFFFFFFu;
  }
}

__global__ void scatter_min_u32_kernel(const int* __restrict__ idx,
                                       const unsigned int* __restrict__ key,
                                       int n, unsigned int* out, int n_slots) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const int p = idx[i];
    if (p < 0 || p >= n_slots) continue;
    atomicMin(out + p, key[i]);
  }
}

}  // namespace

// idx: (n,) i32 slot, dropped outside [0, n_slots). key: (n,) u32 bits.
// out: (n_slots,) u32, 0xFFFFFFFF where no entry landed. Launches on
// `stream`; returns cudaGetLastError().
extern "C" int scatter_min_u32_launch(const int* idx, const unsigned int* key,
                                      int n, unsigned int* out, int n_slots,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fill_u32<<<blocks_for(n_slots), kThreads, 0, s>>>(out, n_slots);
  if (n > 0) {
    scatter_min_u32_kernel<<<blocks_for(n), kThreads, 0, s>>>(idx, key, n, out,
                                                              n_slots);
  }
  return static_cast<int>(cudaGetLastError());
}
