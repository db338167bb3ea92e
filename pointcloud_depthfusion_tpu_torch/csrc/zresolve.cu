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
// depth-only resolve and of the u32 scatter-min below (all-ones either
// way).
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
// fusion/pipeline.py:358; no Pallas kernel), with the packed mode's key
// build and decode folded in. Keys are the bit patterns of i32 tensors.
//
// One cooperative launch a call, like the resolve above: one 32-bit
// atomicMin per entry into the stream's persistent key buffer (its int64
// words read as 2·n u32 words, all-ones either way), a grid-wide barrier,
// then per slot: read the minimum, write the outputs, reset the slot to
// all-ones. The atomics do not depend on their order: bit-exact and
// deterministic.
//
// Inputs: given keys (idx, key), or the masked feed of the render's prep
// (idx, f32 z, ok, rgb24) from which the kernel builds the packed key
//     zq = (int)clamp((z - near) / span · 16383, 0, 16382)
//     key = zq << 18 | RGB666(rgb24)
// (ops/render.py's op order; zparams = (near, span, far) on the device:
// the dual frame's span is f32(far) - f32(near), the rig's f32(far - near)).
// Outputs: the raw minimum bits, or the packed decode: three u8 planes
// (c6 << 2 | c6 >> 4, black where no entry landed) and, when asked, the
// f32 z-buffer zq / 16383 · (far - near) + near (FLT_MAX where empty),
// ops/render._decode_packed_planes's arithmetic.
//
// Bound: bytes and atomics. 8 B read per given entry (13 B from the feed),
// an atomic per landing entry; per slot the key's read and reset and 4 B
// (raw) or 3-7 B (planes) written.
namespace {

constexpr float kZLevels14 = 16383.0f;
constexpr float kFltMax = 3.402823466e+38f;

struct MinU32 {
  const int* idx;            // (n,) slot; outside [0, n_slots) is dropped
  const int* key;            // (n,) given u32 key bits, or unread
  const float* z;            // (n,) the feed's z, or unread
  const unsigned char* ok;   // (n,) the feed's mask
  const int* rgb24;          // (n,) the feed's rgb24
  const float* zparams;      // (3,) near, span, far; read by the feed and the z decode
  int n;
  int n_slots;
  unsigned int* keys;        // the persistent buffer, all-ones between calls
  int* bits;                 // (n_slots,) raw output
  unsigned char* r;          // (n_slots,) planes
  unsigned char* g;
  unsigned char* b;
  float* zbuf;               // (n_slots,), written when with_zbuf
  int with_zbuf;
  bool vec;                  // entries 16 B aligned (the mask 4 B): int4 loads
};

__device__ __forceinline__ void put_key(const MinU32& m, int p, unsigned int key) {
  if (key != 0xFFFFFFFFu && static_cast<unsigned int>(p) < static_cast<unsigned int>(m.n_slots)) {
    atomicMin(m.keys + p, key);
  }
}

__device__ __forceinline__ void put_feed(const MinU32& m, int p, float z, unsigned int ok,
                                         int rgb24, float near, float span) {
  if (ok == 0u || static_cast<unsigned int>(p) >= static_cast<unsigned int>(m.n_slots)) return;
  const float q = fminf(fmaxf(__fmul_rn(__fdiv_rn(__fsub_rn(z, near), span), kZLevels14), 0.0f),
                        kZLevels14 - 1.0f);
  const unsigned int u = static_cast<unsigned int>(rgb24);
  const unsigned int rgb666 =
      (((u >> 18) & 0x3Fu) << 12) | (((u >> 10) & 0x3Fu) << 6) | ((u >> 2) & 0x3Fu);
  atomicMin(m.keys + p, (static_cast<unsigned int>(static_cast<int>(q)) << 18) | rgb666);
}

template <bool kFeed>
__device__ __forceinline__ void scatter_u32(const MinU32& m, int tid, int stride) {
  const float near = kFeed ? m.zparams[0] : 0.0f;
  const float span = kFeed ? m.zparams[1] : 1.0f;
  int done = 0;
  if (m.vec) {
    const int nq = m.n >> 2;
    const int4* idx4 = reinterpret_cast<const int4*>(m.idx);
    for (int q = tid; q < nq; q += stride) {
      const int4 p = __ldg(idx4 + q);
      if (kFeed) {
        const float4 z = __ldg(reinterpret_cast<const float4*>(m.z) + q);
        const int4 c = __ldg(reinterpret_cast<const int4*>(m.rgb24) + q);
        const unsigned int ok = __ldg(reinterpret_cast<const unsigned int*>(m.ok) + q);
        put_feed(m, p.x, z.x, ok & 0xFFu, c.x, near, span);
        put_feed(m, p.y, z.y, (ok >> 8) & 0xFFu, c.y, near, span);
        put_feed(m, p.z, z.z, (ok >> 16) & 0xFFu, c.z, near, span);
        put_feed(m, p.w, z.w, ok >> 24, c.w, near, span);
      } else {
        const int4 k = __ldg(reinterpret_cast<const int4*>(m.key) + q);
        put_key(m, p.x, static_cast<unsigned int>(k.x));
        put_key(m, p.y, static_cast<unsigned int>(k.y));
        put_key(m, p.z, static_cast<unsigned int>(k.z));
        put_key(m, p.w, static_cast<unsigned int>(k.w));
      }
    }
    done = nq << 2;
  }
  // The ragged tail, or every entry of an unaligned view.
  for (int i = done + tid; i < m.n; i += stride) {
    if (kFeed) {
      put_feed(m, __ldg(m.idx + i), __ldg(m.z + i), m.ok[i], __ldg(m.rgb24 + i), near, span);
    } else {
      put_key(m, __ldg(m.idx + i), static_cast<unsigned int>(__ldg(m.key + i)));
    }
  }
}

// Per slot: the minimum into the outputs, and the slot back to all-ones.
template <bool kPlanes>
__device__ __forceinline__ void decode_reset_u32(const MinU32& m, int tid, int stride) {
  float near = 0.0f, zspan = 0.0f;
  if (kPlanes && m.with_zbuf) {
    near = m.zparams[0];
    zspan = __fsub_rn(m.zparams[2], near);
  }
  for (int i = tid; i < m.n_slots; i += stride) {
    const unsigned int k = __ldcg(m.keys + i);
    const bool covered = k != 0xFFFFFFFFu;
    if (covered) m.keys[i] = 0xFFFFFFFFu;
    if (!kPlanes) {
      m.bits[i] = static_cast<int>(k);
      continue;
    }
    const unsigned int kk = covered ? k : 0u;
    const unsigned int r6 = (kk >> 12) & 0x3Fu, g6 = (kk >> 6) & 0x3Fu, b6 = kk & 0x3Fu;
    m.r[i] = static_cast<unsigned char>((r6 << 2) | (r6 >> 4));
    m.g[i] = static_cast<unsigned char>((g6 << 2) | (g6 >> 4));
    m.b[i] = static_cast<unsigned char>((b6 << 2) | (b6 >> 4));
    if (m.with_zbuf) {
      m.zbuf[i] = covered ? __fadd_rn(__fmul_rn(__fdiv_rn(static_cast<float>(kk >> 18), kZLevels14),
                                                zspan), near)
                          : kFltMax;
    }
  }
}

template <bool kFeed, bool kPlanes>
__global__ void __launch_bounds__(kResolveThreads) scatter_min_u32_kernel(MinU32 m) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  scatter_u32<kFeed>(m, tid, stride);
  cg::this_grid().sync();
  decode_reset_u32<kPlanes>(m, tid, stride);
}

template <bool kFeed, bool kPlanes>
int launch_scatter_min(MinU32 m, cudaStream_t s) {
  const void* kernel = reinterpret_cast<const void*>(&scatter_min_u32_kernel<kFeed, kPlanes>);
  static const int most = resident_most(kernel);
  const int quads = (m.n + 3) / 4;
  const int work = quads > m.n_slots ? quads : m.n_slots;
  int blocks = (work + kResolveThreads - 1) / kResolveThreads;
  blocks = blocks < most ? blocks : most;
  void* args[] = {&m};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      kernel, dim3(blocks < 1 ? 1 : blocks), dim3(kResolveThreads), args, 0, s));
}

}  // namespace

// idx: (n,) i32 slot. With feed = 0, key: (n,) u32 bits; with feed = 1, z
// (n,) f32, ok (n,) bytes and rgb24 (n,) i32, keyed with zparams. keys: at
// least n_slots u32 with every bit set, and left so. With planes = 0 the
// minimum bits go to bits (n_slots,) i32, 0xFFFFFFFF where empty; with
// planes = 1 the decode goes to r, g, b (n_slots,) u8 and, when with_zbuf,
// zbuf (n_slots,) f32. (An empty tensor's pointer may be null: n and
// n_slots, not the pointers, say what is read.) One cooperative launch on
// `stream`; returns its status, or cudaGetLastError() when it launched.
extern "C" int scatter_min_u32_launch(const int* idx, const int* key, const float* z,
                                      const unsigned char* ok, const int* rgb24,
                                      const float* zparams, int n, int feed,
                                      unsigned int* keys, int n_slots, int planes, int* bits,
                                      unsigned char* r, unsigned char* g, unsigned char* b,
                                      float* zbuf, int with_zbuf, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MinU32 m{idx, key, z, ok, rgb24, zparams, n, n_slots, keys, bits, r, g, b, zbuf, with_zbuf,
           false};
  m.vec = aligned(idx, 16) &&
          (feed ? aligned(z, 16) && aligned(rgb24, 16) && aligned(ok, 4) : aligned(key, 16));
  const int status = feed ? (planes ? launch_scatter_min<true, true>(m, s)
                                    : launch_scatter_min<true, false>(m, s))
                          : (planes ? launch_scatter_min<false, true>(m, s)
                                    : launch_scatter_min<false, false>(m, s));
  return status ? status : static_cast<int>(cudaGetLastError());
}
