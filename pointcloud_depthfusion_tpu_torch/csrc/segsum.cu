// Per-slot channel sums and minimum entry index over entries sorted by slot.
//
// Replaces the Pallas kernel _segsum_kernel (segsum_sorted) in
// pointcloud_depthfusion_tpu/ops/pallas/segsum_pallas.py, the accumulation
// under every voxel grid of a registration tick. As on the TPU, the caller
// sorts the entries by slot (a stable sort, so equal slots keep their entry
// order) and the kernel reduces each slot's run of sorted entries: one
// thread per slot finds its run by binary search and adds the run's rows in
// entry order, all C channels at once. Entries whose slot lies outside
// [0, n_slots) sort before or after every run and are dropped.
//
// Order: each slot's sums are taken left to right in entry order, starting
// from 0, the order of a sequential scatter-add. So the result does not
// change from run to run, and equals bit for bit the plain version run on
// the CPU (index_add_ there adds in entry order). Atomics would add in an
// order that changes from run to run; through the covariance's
// cancellation (E[p pᵀ] - μ μᵀ at 1 cm voxels) that moved the registration
// transform by up to 1e-3 between two runs of one tick on an H100, and
// the fitness gate then decided otherwise than on the CPU.
//
// Bound: each entry's slot (4 B) and C channels (4·C B) are read once, and
// each slot writes 4·C + 4 B: memory-bound (≈11.6 MB at 230,400 entries,
// C = 10, 2^15 slots). A slot holding many entries (a coarse voxel) is one
// thread's serial loop, so the longest run sets the time; splitting long
// runs over a warp would change the addition order and is not done here.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxChannels = 16;

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

}  // namespace

// ss: (n,) i32 slots sorted ascending; si: (n,) i64 entry index of each
// sorted position (stable: ascending within a slot). values: (n, c) f32,
// row-major, 1 <= c <= 16. sums: (n_slots, c) f32 and rep: (n_slots,) i32
// outputs, every element written here. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int segsum_launch(const int* ss, const long long* si, const float* values, int n,
                             int c, int n_slots, float* sums, int* rep, void* stream) {
  if (n_slots > 0) {
    long long blocks = (static_cast<long long>(n_slots) + kThreads - 1) / kThreads;
    if (blocks > 65535) blocks = 65535;  // grid-stride beyond
    segsum_runs<<<static_cast<int>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        ss, si, values, n, c, n_slots, sums, rep);
  }
  return static_cast<int>(cudaGetLastError());
}
