// Per-slot channel sums and minimum entry index of unsorted entries.
//
// Replaces the Pallas kernel _segsum_kernel (segsum_sorted) in
// pointcloud_depthfusion_tpu/ops/pallas/segsum_pallas.py, the accumulation
// under every voxel grid of a registration tick. The TPU sorts the entries
// by slot with XLA and reduces each slot's run; here the kernels group the
// entries themselves, with no library sort:
//
//   1. count   the first radix pass's per-tile digit histogram;
//   2. place   a stable LSD radix placement of the int32 entry indices
//              over the slot's ⌈log2(n_slots + 1)⌉ bits, 8 bits a pass (two
//              passes at 2^15 slots; entries outside [0, n_slots) take the
//              key n_slots and land last). Each tile's block first reads
//              the pass's whole (n_tiles, 256) histogram (coalesced, the
//              loads in flight together) for its offsets: the counts of the
//              smaller digits, and of each digit in the earlier tiles, so no
//              scan kernel runs between the passes. A lane's rank among the
//              earlier lanes of its warp with the same digit comes from nine
//              ballots, warps are ordered by their digit counts, so equal
//              slots keep their entry order. Each pass also counts the next
//              pass's per-tile digits (integer atomics, one per group of
//              equal digits);
//   3. reduce  warp w owns the runs that start among placed entries
//              [128w, 128w + 128) and adds each to its end, wherever that
//              lies. It streams chunks of 32 placed entries through shared
//              memory with cp.async: the keys and indices six chunks ahead
//              (16-byte copies), the rows they index three chunks ahead
//              (4-byte copies, 32 consecutive floats of them an instruction),
//              so no load waits on another. Lane ch adds channel ch of the
//              rows in entry order, starting from 0. A run's first entry is
//              its representative (the smallest index); the slots below a
//              run's key, down to the previous run's, get zero sums and
//              INT32_MAX.
//
// Order: each slot's sums are taken left to right in entry order, starting
// from 0, the order of a sequential scatter-add. So the result does not
// change from run to run, and equals bit for bit the plain version run on
// the CPU (index_add_ there adds in entry order). Float atomics would add in
// an order that changes from run to run; through the covariance's
// cancellation (E[p pᵀ] - μ μᵀ at 1 cm voxels) that moved the registration
// transform by up to 1e-3 between two runs of one tick on an H100, and the
// fitness gate then decided otherwise than on the CPU. Integer atomics (the
// digit counts) give the same result in every order.
//
// Bound: the function reads each entry's slot (4 B) and C channels (4·C B)
// once and writes 4·C + 4 B per slot (≈11.6 MB at 230,400 entries, C = 10,
// 2^15 slots: 3.5 µs at 3.35 TB/s). The grouping adds two radix passes over
// 8 B per entry and each tile's read of the 1 KB-a-tile histogram, in L2 at
// these sizes, and four launches and a memset. A slot holding many entries
// is one chain of dependent adds per channel (about 4 cycles an entry);
// splitting it would change the bits.
//
// segsum_runs_launch keeps the earlier design (the caller sorts the entries
// by slot with a stable library sort; one thread per slot finds its run by
// binary search and walks it). No wrapper calls it: it is the yardstick
// that chip_smoke.py times the redesign against.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxChannels = 16;
constexpr unsigned kFull = 0xffffffffu;

// -- grouping ------------------------------------------------------------------

constexpr int kSortThreads = 256;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kItems = 8;                         // entries per lane per tile
constexpr int kTile = kSortThreads * kItems;      // 2048 entries
constexpr int kRadixBits = 8;
constexpr int kRadix = 1 << kRadixBits;
constexpr int kNone = kRadix;                     // the digit of a lane past n

// The sort key: the slot, or n_slots for an entry that is dropped.
__device__ __forceinline__ int sort_key(int s, int n_slots) {
  return static_cast<unsigned>(s) < static_cast<unsigned>(n_slots) ? s : n_slots;
}

// The lanes of the warp whose value in [0, 512) equals this lane's: nine
// ballots, one per bit.
__device__ __forceinline__ unsigned match9(int v) {
  unsigned peers = kFull;
#pragma unroll
  for (int b = 0; b < 9; ++b) {
    const bool set = (v >> b) & 1;
    const unsigned lanes = __ballot_sync(kFull, set);
    peers &= set ? lanes : ~lanes;
  }
  return peers;
}

__device__ __forceinline__ bool leader(unsigned peers, int lane) {
  return lane == __ffs(peers) - 1;
}

// Block of kSortThreads per tile: the first radix pass's digit histogram
// of the tile into hist, (n_tiles, kRadix).
__global__ void __launch_bounds__(kSortThreads)
count_digits(const int* __restrict__ slot, int n, int n_slots, int* __restrict__ hist,
             int n_tiles) {
  __shared__ int h[kRadix];
  for (int d = threadIdx.x; d < kRadix; d += kSortThreads) h[d] = 0;
  const int lane = threadIdx.x & 31;
  const int base = blockIdx.x * kTile;
  int digit[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = base + k * kSortThreads + threadIdx.x;
    digit[k] = i < n ? sort_key(slot[i], n_slots) & (kRadix - 1) : kNone;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    // Neighbouring entries often share a slot (a voxel holds neighbouring
    // pixels): one shared atomic per distinct digit of the warp.
    const unsigned peers = match9(digit[k]);
    if (digit[k] != kNone && leader(peers, lane)) atomicAdd(&h[digit[k]], __popc(peers));
  }
  __syncthreads();
  for (int d = threadIdx.x; d < kRadix; d += kSortThreads) hist[blockIdx.x * kRadix + d] = h[d];
}

// One stable radix pass over the tile's entries. The first pass reads the
// slots (and the entry indices are the positions); later ones the previous
// pass's keys and indices. hist: this pass's (n_tiles, kRadix) digit
// counts; each block reads them all (coalesced, every load in flight at
// once) for its own offsets: the counts of the smaller digits, and of its
// digit in the earlier tiles. next_hist, when given, counts the next pass's
// digits per output tile (zeroed before).
template <bool kFirst>
__global__ void __launch_bounds__(kSortThreads)
place(const int* __restrict__ keys_in, const int* __restrict__ idx_in, int n, int n_slots,
      int shift, const int* __restrict__ hist, int n_tiles, int* __restrict__ keys_out,
      int* __restrict__ idx_out, int* __restrict__ next_hist) {
  static_assert(kSortThreads == kRadix, "one thread per digit");
  __shared__ int wcount[kSortWarps][kRadix];
  __shared__ int warp_totals[kSortWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < kSortWarps * kRadix; i += kSortThreads) (&wcount[0][0])[i] = 0;
  const unsigned lower = (1u << lane) - 1;
  const int base = blockIdx.x * kTile + warp * kItems * 32;
  int key[kItems], idx[kItems], rank[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = base + k * 32 + lane;
    const bool in = i < n;
    if (kFirst) {
      key[k] = in ? sort_key(keys_in[i], n_slots) : -1;
      idx[k] = i;
    } else {
      key[k] = in ? keys_in[i] : -1;
      idx[k] = in ? idx_in[i] : 0;
    }
  }
  // Thread d: digit d's count in the earlier tiles and in all of them.
  int earlier = 0, total = 0;
#pragma unroll 32
  for (int t = 0; t < n_tiles; ++t) {
    const int v = hist[t * kRadix + threadIdx.x];
    earlier += t < static_cast<int>(blockIdx.x) ? v : 0;
    total += v;
  }
  int incl = total;  // inclusive scan of the totals over the digits
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) warp_totals[warp] = incl;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const bool in = key[k] >= 0;
    const int d = in ? (key[k] >> shift) & (kRadix - 1) : kNone;
    const unsigned peers = match9(d);
    const int before = in ? wcount[warp][d] : 0;
    rank[k] = before + __popc(peers & lower);
    __syncwarp();
    if (in && leader(peers, lane)) wcount[warp][d] = before + __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // Digit d's output offset in this tile, then each warp's past the earlier
  // warps'.
  {
    const int d = threadIdx.x;
    int run = incl - total + earlier;
#pragma unroll
    for (int w = 0; w < kSortWarps; ++w) run += w < warp ? warp_totals[w] : 0;
#pragma unroll
    for (int w = 0; w < kSortWarps; ++w) {
      const int count = wcount[w][d];
      wcount[w][d] = run;
      run += count;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const bool in = key[k] >= 0;
    int pos = 0;
    if (in) {
      pos = wcount[warp][(key[k] >> shift) & (kRadix - 1)] + rank[k];
      keys_out[pos] = key[k];
      idx_out[pos] = idx[k];
    }
    if (next_hist != nullptr) {
      // One atomic for the lanes with the leader's next digit and output
      // tile; a lane of that digit in another tile adds its own.
      const int d = in ? (key[k] >> (shift + kRadixBits)) & (kRadix - 1) : kNone;
      const int tile = pos / kTile;
      const unsigned peers = match9(d);
      const int lead_tile = __shfl_sync(kFull, tile, __ffs(peers) - 1);
      const unsigned same = __ballot_sync(kFull, tile == lead_tile) & peers;
      if (in && leader(peers, lane)) {
        atomicAdd(&next_hist[tile * kRadix + d], __popc(same));
      } else if (in && tile != lead_tile) {
        atomicAdd(&next_hist[tile * kRadix + d], 1);
      }
    }
  }
}

// -- reduce --------------------------------------------------------------------

constexpr int kReduceWarps = 4;
constexpr int kWarpChunks = 4;               // each warp owns the runs starting in 4 chunks
constexpr int kAhead = 3;                    // chunks of rows in flight
constexpr int kMetaSlots = 2 * kAhead + 1;   // keys and indices staged twice as far ahead
constexpr int kRowSlots = kAhead + 1;
constexpr int kRowPitch = 17;                // floats per staged row: odd, no bank conflicts
constexpr int kRowFloats = 32 * kRowPitch;
constexpr int kLaneGap = 3;                  // empty slots one lane writes alone

// Asynchronous copies into shared memory (cp.async), in groups that a
// thread commits and then waits for, all but the newest `pending` of them.
__device__ __forceinline__ void copy_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void copy_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// The keys and entry indices of one chunk of 32 placed entries.
struct Meta {
  int key[32];
  int idx[32];
};

// 16-byte copies of the chunk at position p; the arrays are padded to whole
// chunks.
__device__ __forceinline__ void stage_meta(Meta* dst, const int* __restrict__ keys,
                                           const int* __restrict__ idx, int p, int lane) {
  if (lane < 8) {
    copy_async16(dst->key + 4 * lane, keys + p + 4 * lane);
  } else if (lane < 16) {
    copy_async16(dst->idx + 4 * (lane - 8), idx + p + 4 * (lane - 8));
  }
}

// The rows of the chunk's first cnt in-range entries, by the indices
// staged in `meta`; element i*32 + lane of the 32·c floats is row j,
// channel ch (jc[i] = j << 8 | ch).
__device__ __forceinline__ void stage_rows(float* dst, const Meta* meta,
                                           const float* __restrict__ values, int c, int cnt,
                                           int n_slots, const int jc[kMaxChannels]) {
#pragma unroll
  for (int i = 0; i < kMaxChannels; ++i) {
    if (i < c) {
      const int j = jc[i] >> 8, ch = jc[i] & 0xFF;
      if (j < cnt && meta->key[j] < n_slots) {
        copy_async4(dst + j * kRowPitch + ch,
                    values + static_cast<long long>(meta->idx[j]) * c + ch);
      }
    }
  }
}

// Slots [a, b) hold no entry: zero sums, no representative.
__device__ __forceinline__ void write_empty(float* __restrict__ sums, int* __restrict__ rep,
                                            int c, int a, int b, int lane) {
  for (long long e = lane; e < static_cast<long long>(b - a) * c; e += 32) {
    sums[static_cast<long long>(a) * c + e] = 0.0f;
  }
  for (int s = a + lane; s < b; s += 32) rep[s] = INT_MAX;
}

// keys, idx: the n placed entries (in-range ones first, by slot, in entry
// order within a slot; dropped ones last with the key n_slots), padded to
// whole chunks. Warp w owns the runs that start at positions
// [128w, 128w + 128) and adds each to its end, wherever that is; it also
// writes the empty slots below each of its runs' keys (and, the last warp,
// those above the last run). A chunk's run starts, representatives and
// empty slots are found lane-parallel (a shuffle and two ballots); only the
// adds run in entry order.
__global__ void __launch_bounds__(32 * kReduceWarps)
reduce_runs(const int* __restrict__ keys, const int* __restrict__ idx,
            const float* __restrict__ values, int n, int c, int n_slots,
            float* __restrict__ sums, int* __restrict__ rep) {
  __shared__ __align__(16) Meta metas[kReduceWarps][kMetaSlots];
  __shared__ float row_ring[kReduceWarps][kRowSlots][kRowFloats];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long w = static_cast<long long>(blockIdx.x) * kReduceWarps + warp;
  const int n_warps = (n + 32 * kWarpChunks - 1) / (32 * kWarpChunks);
  if (w >= max(n_warps, 1)) return;
  const int p0 = static_cast<int>(w) * 32 * kWarpChunks;
  const int p1 = min(p0 + 32 * kWarpChunks, n);
  Meta* meta = metas[warp];
  float(*rows)[kRowFloats] = row_ring[warp];
  int prev = p0 > 0 ? keys[p0 - 1] : -1;  // the key before the next position
  int jc[kMaxChannels];
#pragma unroll
  for (int i = 0; i < kMaxChannels; ++i) {
    const int e = i * 32 + lane;
    jc[i] = i < c ? ((e / c) << 8) | (e % c) : 0;
  }
  // Prologue: keys and indices of chunks 0 .. 2·kAhead-1, then the rows of
  // chunks 0 .. kAhead-1.
  for (int q = 0; q < 2 * kAhead; ++q) {
    if (p0 + 32 * q < n) stage_meta(&meta[q], keys, idx, p0 + 32 * q, lane);
    if (q == kAhead - 1 || q == 2 * kAhead - 1) commit_copies();
  }
  wait_copies<1>();
  __syncwarp();
  for (int q = 0; q < kAhead; ++q) {
    const int p = p0 + 32 * q;
    if (p < n) stage_rows(rows[q], &meta[q], values, c, min(32, n - p), n_slots, jc);
  }
  commit_copies();
  wait_copies<0>();

  int cur = -1;  // the key of the run being added, or -1
  float acc = 0.0f;
  for (int q = 0;; ++q) {
    wait_copies<kAhead - 1>();  // the rows of chunk q, the indices of chunk q + kAhead
    __syncwarp();
    const int pm = p0 + 32 * (q + 2 * kAhead);
    if (pm < n) stage_meta(&meta[(q + 2 * kAhead) % kMetaSlots], keys, idx, pm, lane);
    const int pr = p0 + 32 * (q + kAhead);
    if (pr < n) {
      stage_rows(rows[(q + kAhead) % kRowSlots], &meta[(q + kAhead) % kMetaSlots], values, c,
                 min(32, n - pr), n_slots, jc);
    }
    commit_copies();
    const Meta* m = &meta[q % kMetaSlots];
    const float* src = rows[q % kRowSlots];
    const int p = p0 + 32 * q;
    // Lane l's entry, position p + l (the key n_slots past the end): does a
    // run start there, and does this warp own it?
    const int key = p + lane < n ? m->key[lane] : n_slots;
    const int up = __shfl_up_sync(kFull, key, 1);  // every lane takes part
    const int left = lane == 0 ? prev : up;
    const bool start = key != left;
    const bool own = start && p + lane < p1;
    const unsigned starts = __ballot_sync(kFull, start);
    const unsigned past = __ballot_sync(kFull, p + lane >= p1);
    // The owned runs' representatives and the empty slots below them, lane
    // by lane; a long stretch of empty slots by the whole warp.
    const int gap_a = left + 1, gap_b = min(key, n_slots);
    const bool gap = own && gap_b > gap_a;
    if (own && key < n_slots) rep[key] = m->idx[lane];
    if (gap && gap_b - gap_a <= kLaneGap) {
      for (int slot = gap_a; slot < gap_b; ++slot) {
        for (int ch = 0; ch < c; ++ch) sums[static_cast<long long>(slot) * c + ch] = 0.0f;
        rep[slot] = INT_MAX;
      }
    }
    for (unsigned big = __ballot_sync(kFull, gap && gap_b - gap_a > kLaneGap); big;
         big &= big - 1) {
      const int l = __ffs(big) - 1;
      write_empty(sums, rep, c, __shfl_sync(kFull, gap_a, l), __shfl_sync(kFull, gap_b, l),
                  lane);
    }
    // Entries before the first start at or past p1 (the next warp's run)
    // continue or start this warp's runs; lane ch adds channel ch of each
    // in entry order.
    const unsigned ends = starts & past;
    const int stop_at = ends ? __ffs(ends) - 1 : 32;
    if (starts == 0) {
      // The chunk continues the run (or an earlier warp's): 32 adds, or none.
      if (cur >= 0 && lane < c) {
#pragma unroll
        for (int j = 0; j < 32; ++j) acc += src[j * kRowPitch + lane];
      }
    } else {
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        if (j < stop_at) {
          if ((starts >> j) & 1) {
            if (cur >= 0 && lane < c) sums[static_cast<long long>(cur) * c + lane] = acc;
            cur = m->key[j] < n_slots ? m->key[j] : -1;
            acc = 0.0f;
          }
          if (cur >= 0 && lane < c) acc += src[j * kRowPitch + lane];
        }
      }
    }
    prev = __shfl_sync(kFull, key, 31);
    __syncwarp();
    if (stop_at < 32 || (cur < 0 && p + 32 >= p1)) break;
  }
  if (cur >= 0 && lane < c) sums[static_cast<long long>(cur) * c + lane] = acc;
  if (p1 == n) {
    // The last warp: the slots above the last in-range entry's.
    const int last = n > 0 ? keys[n - 1] : -1;
    if (last < n_slots) write_empty(sums, rep, c, last + 1, n_slots, lane);
  }
  wait_copies<0>();
}

// -- the earlier design (timing yardstick) -------------------------------------

constexpr int kRunThreads = 128;

// First position in sorted ss[0, n) whose slot is >= s.
__device__ int lower_bound(const int* __restrict__ ss, int n, int s) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (ss[mid] < s) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void segsum_runs(const int* __restrict__ ss, const long long* __restrict__ si,
                            const float* __restrict__ values, int n, int c, int n_slots,
                            float* __restrict__ sums, int* __restrict__ rep) {
  const int stride = gridDim.x * blockDim.x;
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < n_slots; s += stride) {
    const int begin = lower_bound(ss, n, s);
    const int end = lower_bound(ss, n, s + 1);
    float acc[kMaxChannels];
#pragma unroll
    for (int ch = 0; ch < kMaxChannels; ++ch) acc[ch] = 0.0f;
    for (int j = begin; j < end; ++j) {
      const float* v = values + si[j] * c;
#pragma unroll
      for (int ch = 0; ch < kMaxChannels; ++ch) {
        if (ch < c) acc[ch] += v[ch];
      }
    }
    float* dst = sums + static_cast<long long>(s) * c;
#pragma unroll
    for (int ch = 0; ch < kMaxChannels; ++ch) {
      if (ch < c) dst[ch] = acc[ch];
    }
    rep[s] = begin < end ? static_cast<int>(si[begin]) : INT_MAX;
  }
}

// Where the launch's int32 scratch goes: each radix pass's digit histogram,
// (n_tiles, kRadix), then two (keys, indices) buffers padded to whole
// chunks, 16-byte aligned.
struct Scratch {
  int passes, n_tiles;
  long long hist_len, pad, total;
  int *hist, *keys[2], *idx[2];
};

Scratch layout(int* base, int n, int n_slots) {
  Scratch s{};
  const int bits = n_slots > 0 ? 32 - __builtin_clz(static_cast<unsigned>(n_slots)) : 1;
  s.passes = (bits + kRadixBits - 1) / kRadixBits;
  s.n_tiles = (n + kTile - 1) / kTile;
  s.hist_len = static_cast<long long>(kRadix) * s.n_tiles;
  s.pad = (static_cast<long long>(n) + 31) / 32 * 32;
  const long long at_keys = (s.passes * s.hist_len + 3) / 4 * 4;
  s.total = at_keys + 4 * s.pad;
  if (base != nullptr) {
    s.hist = base;
    for (int b = 0; b < 2; ++b) {
      s.keys[b] = base + at_keys + 2 * b * s.pad;
      s.idx[b] = s.keys[b] + s.pad;
    }
  }
  return s;
}

}  // namespace

// Scratch the launch needs: int32 elements, allocated by the caller.
extern "C" long long segsum_scratch_ints(int n, int n_slots) {
  return layout(nullptr, n, n_slots).total;
}

// slot: (n,) i32; values: (n, c) f32, row-major, 1 <= c <= 16; scratch:
// segsum_scratch_ints(n, n_slots) i32, 16-byte aligned. sums: (n_slots, c)
// f32 and rep: (n_slots,) i32 outputs, every element written here. Launches
// on `stream`; returns the first CUDA error, or cudaErrorInvalidValue for
// arguments the kernels do not take.
extern "C" int segsum_launch(const int* slot, const float* values, int n, int c, int n_slots,
                             int* scratch, float* sums, int* rep, void* stream) {
  if (c < 1 || c > kMaxChannels || n < 0 || n_slots < 0 ||
      (reinterpret_cast<uintptr_t>(scratch) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_slots == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Scratch s = layout(scratch, n, n_slots);
  int cur = 0;
  if (n > 0) {
    const long long later = (s.passes - 1) * s.hist_len;
    if (later > 0) {
      const cudaError_t err =
          cudaMemsetAsync(s.hist + s.hist_len, 0, later * sizeof(int), st);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    count_digits<<<s.n_tiles, kSortThreads, 0, st>>>(slot, n, n_slots, s.hist, s.n_tiles);
    for (int p = 0; p < s.passes; ++p) {
      int* hist = s.hist + p * s.hist_len;
      int* next = p + 1 < s.passes ? hist + s.hist_len : nullptr;
      const int out = p == 0 ? 0 : 1 - cur;
      if (p == 0) {
        place<true><<<s.n_tiles, kSortThreads, 0, st>>>(slot, nullptr, n, n_slots, 0, hist,
                                                        s.n_tiles, s.keys[out], s.idx[out], next);
      } else {
        place<false><<<s.n_tiles, kSortThreads, 0, st>>>(s.keys[cur], s.idx[cur], n, n_slots,
                                                         p * kRadixBits, hist, s.n_tiles,
                                                         s.keys[out], s.idx[out], next);
      }
      cur = out;
    }
  }
  const long long warps = max((static_cast<long long>(n) + 32 * kWarpChunks - 1) /
                                  (32 * kWarpChunks), 1LL);
  const long long blocks = (warps + kReduceWarps - 1) / kReduceWarps;
  reduce_runs<<<static_cast<unsigned>(blocks), 32 * kReduceWarps, 0, st>>>(
      s.keys[cur], s.idx[cur], values, n, c, n_slots, sums, rep);
  return static_cast<int>(cudaGetLastError());
}

// The earlier design, for timing only. ss: (n,) i32 slots sorted
// ascending; si: (n,) i64 entry index of each sorted position (stable:
// ascending within a slot). Outputs as segsum_launch.
extern "C" int segsum_runs_launch(const int* ss, const long long* si, const float* values, int n,
                                  int c, int n_slots, float* sums, int* rep, void* stream) {
  if (n_slots > 0) {
    long long blocks = (static_cast<long long>(n_slots) + kRunThreads - 1) / kRunThreads;
    if (blocks > 65535) blocks = 65535;  // grid-stride beyond
    segsum_runs<<<static_cast<int>(blocks), kRunThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        ss, si, values, n, c, n_slots, sums, rep);
  }
  return static_cast<int>(cudaGetLastError());
}
