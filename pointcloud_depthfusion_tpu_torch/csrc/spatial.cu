// The rs2 spatial edge-preserving filter's recurrence (spatial_filter):
// per iteration, recursive EMA sweeps left->right (with the hole fill),
// right->left, top->bottom and bottom->top, each step blending a pixel
// with its already filtered neighbour where both are valid and within
// delta.
//
// Not a Pallas kernel: replaces the lax.scan of _spatial_sweep in
// pointcloud_depthfusion_tpu/ops/filters.py, which the port ran as about
// ten eager ops a step, magnitude x 2 x ((W - 1) + (H - 1)) steps a call
// (5,304 at 848x480 with magnitude 2).
//
// Design. The lines of a sweep are independent and the steps of a line are
// not, so one thread runs one line and keeps the carried value in a
// register. A row launch gives each block up to kRowsPerBlock rows staged in
// shared memory (an odd row stride, so that one thread a row reads without
// bank conflicts); all the block's threads load and store the strip
// coalesced, and one thread a row runs both horizontal sweeps. A column
// launch gives each block up to 32 columns staged as (H, 32) rows, one warp
// row a 128-byte segment, and one thread a column runs both vertical sweeps.
// A sweep loads the next kBatch values while the chain runs through the
// current ones, and staging keeps kBatch loads in flight a thread (one
// load's latency an element otherwise). Two launches an
// iteration; the first reads the caller's dtype and the last writes it
// (clamped to [0, 65535] in the integer domain), so no conversion op runs
// around the kernel.
//
// Bits: the JAX op order with explicitly rounded intrinsics (nvcc would
// contract the blend into an FMA): blended = col*alpha + prev*(1-alpha),
// floor(blended + 0.5f) in the integer domain (librealsense's
// (T)(filtered + 0.5f); the floor in two exact adds, see floor_exact); the
// gate is col > 0, prev > 0 and |col - prev| <= delta, all in f32.
//
// Bound (H100 SXM): bytes, 4 B in and 4 B out a pixel, 0.00097 ms at
// 848x480 (3.35 TB/s); but every step waits for the last, so the chain
// binds: at least 5 dependent f32 operations a step (multiply, add, add,
// floor, select) of ~4 cycles each, 5,304 steps at 848x480 with magnitude 2,
// about 0.054 ms at 1.98 GHz. The floor and the gate's predicates make the
// real chain longer than that model.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRowsPerBlock = 8;
constexpr int kColsPerBlock = 32;
constexpr int kThreads = 256;
// Values a sweep loads ahead of its chain, and loads a thread keeps in
// flight while staging.
constexpr int kBatch = 8;

// Element types, by spatial_cuda.KINDS.
enum Kind { kF32 = 0, kU16 = 1, kI32 = 2, kI64 = 3 };

struct Blend {
  float alpha, one_m_alpha, delta;
  int integer_domain;
  int holes_radius;  // the left->right sweep's fill; 0: none
};

// torch.clamp(x, 0, 65535).to(dtype) for the integer types; f32 as it is.
template <typename T>
__device__ __forceinline__ T from_f32(float v) {
  return static_cast<T>(fminf(fmaxf(v, 0.0f), 65535.0f));
}
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}

// Copies the n elements global_at(i) of src into shared memory at
// local_at(i), kBatch loads in flight a thread.
template <typename T, typename G, typename L>
__device__ void stage_in(const T* src, int n, float* smem, G global_at, L local_at) {
  for (int i0 = threadIdx.x; i0 < n; i0 += kThreads * kBatch) {
    float v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = i0 + j * kThreads;
      v[j] = i < n ? static_cast<float>(src[global_at(i)]) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = i0 + j * kThreads;
      if (i < n) smem[local_at(i)] = v[j];
    }
  }
}

template <typename T, typename G, typename L>
__device__ void stage_out(T* dst, int n, const float* smem, G global_at, L local_at) {
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += kThreads) {
    dst[global_at(i)] = from_f32<T>(smem[local_at(i)]);
  }
}

template <bool kOut, typename T, typename G, typename L>
__device__ void stage_as(const void* plane, int n, float* smem, G global_at, L local_at) {
  if constexpr (kOut) {
    stage_out(static_cast<T*>(const_cast<void*>(plane)), n, smem, global_at, local_at);
  } else {
    stage_in(static_cast<const T*>(plane), n, smem, global_at, local_at);
  }
}

// stage_in, or stage_out (kOut), on a plane of kind `kind`.
template <bool kOut, typename G, typename L>
__device__ void stage(const void* plane, int kind, int n, float* smem, G global_at, L local_at) {
  switch (kind) {
    case kU16: stage_as<kOut, uint16_t>(plane, n, smem, global_at, local_at); break;
    case kI32: stage_as<kOut, int32_t>(plane, n, smem, global_at, local_at); break;
    case kI64: stage_as<kOut, int64_t>(plane, n, smem, global_at, local_at); break;
    default: stage_as<kOut, float>(plane, n, smem, global_at, local_at);
  }
}

// floorf(y), in two adds rather than FRND, whose latency sits on the
// chain: for |y| < 2^23, y + copysign(2^23, y) lies in a binade whose ulp
// is 1, so rounding it down (__fadd_rd) is floor(y) + copysign(2^23, y)
// exactly, and subtracting the constant again is exact; from 2^23 on (and
// for inf and NaN) y is its own floor. A y of -0 cannot reach it (y is a
// sum with +0.5).
__device__ __forceinline__ float floor_exact(float y) {
  const float m = copysignf(8388608.0f, y);
  const float f = __fsub_rn(__fadd_rd(y, m), m);
  return fabsf(y) < 8388608.0f ? f : y;
}

// kHoles: the left->right sweep's hole fill; kInt: the integer domain's
// half-up rounding.
template <bool kHoles, bool kInt>
__device__ __forceinline__ float step(float col, float prev, int& run, const Blend& k) {
  if (kHoles) {
    const bool hole = col == 0.0f;
    run = hole ? run + 1 : 0;
    if (hole && prev > 0.0f && run <= k.holes_radius) col = prev;
  }
  const bool gate = col > 0.0f && prev > 0.0f && fabsf(__fsub_rn(col, prev)) <= k.delta;
  float blended = __fadd_rn(__fmul_rn(col, k.alpha), __fmul_rn(prev, k.one_m_alpha));
  if (kInt) blended = floor_exact(__fadd_rn(blended, 0.5f));
  return gate ? blended : col;
}

// One sweep over the n values p[0], p[s], p[2s], ... (s < 0 walks back),
// in place: each value from the second on blends with the one before it,
// already filtered. The next kBatch values are loaded while the chain
// runs through the current ones (they lie past every value it writes).
template <bool kHoles, bool kInt>
__device__ void sweep_as(float* p, int n, int s, const Blend& k) {
  if (n < 2) return;
  float prev = p[0];
  int run = 0;
  int i = 1;
  float next[kBatch];
  if (i + kBatch <= n) {
#pragma unroll
    for (int j = 0; j < kBatch; ++j) next[j] = p[(i + j) * s];
  }
  for (; i + kBatch <= n; i += kBatch) {
    float v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) v[j] = next[j];
    if (i + 2 * kBatch <= n) {
#pragma unroll
      for (int j = 0; j < kBatch; ++j) next[j] = p[(i + kBatch + j) * s];
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      prev = step<kHoles, kInt>(v[j], prev, run, k);
      p[(i + j) * s] = prev;
    }
  }
  for (; i < n; ++i) {
    prev = step<kHoles, kInt>(p[i * s], prev, run, k);
    p[i * s] = prev;
  }
}

template <bool kHoles>
__device__ void sweep(float* p, int n, int s, const Blend& k) {
  if (k.integer_domain) {
    sweep_as<kHoles, true>(p, n, s, k);
  } else {
    sweep_as<kHoles, false>(p, n, s, k);
  }
}

// Rows [blockIdx.x * rows, ...) of src (src_kind) → dst (dst_kind), with
// both horizontal sweeps when `sweeps`.
__global__ void __launch_bounds__(kThreads)
    spatial_rows(const void* src, int src_kind, void* dst, int dst_kind, int h, int w, int rows,
                 int stride, int sweeps, Blend k) {
  extern __shared__ float strip[];
  const int r0 = blockIdx.x * rows;
  const int nr = min(rows, h - r0);
  const size_t base = static_cast<size_t>(r0) * w;
  const auto global_at = [=](int i) { return base + i; };
  const auto local_at = [=](int i) { return i / w * stride + i % w; };
  stage<false>(src, src_kind, nr * w, strip, global_at, local_at);
  __syncthreads();
  if (sweeps && static_cast<int>(threadIdx.x) < nr) {
    float* row = strip + threadIdx.x * stride;
    if (k.holes_radius) {
      sweep<true>(row, w, 1, k);
    } else {
      sweep<false>(row, w, 1, k);
    }
    sweep<false>(row + (w - 1), w, -1, k);
  }
  __syncthreads();
  stage<true>(dst, dst_kind, nr * w, strip, global_at, local_at);
}

// Columns [blockIdx.x * cols, ...) of the f32 plane src → dst (dst_kind),
// with both vertical sweeps.
__global__ void __launch_bounds__(kThreads)
    spatial_cols(const float* src, void* dst, int dst_kind, int h, int w, int cols, Blend k) {
  extern __shared__ float slab[];
  const int c0 = blockIdx.x * cols;
  const int nc = min(cols, w - c0);
  const auto global_at = [=](int i) { return static_cast<size_t>(i / nc) * w + c0 + i % nc; };
  const auto local_at = [=](int i) { return i / nc * cols + i % nc; };
  stage_in(src, h * nc, slab, global_at, local_at);
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < nc) {
    float* col = slab + threadIdx.x;
    sweep<false>(col, h, cols, k);
    sweep<false>(col + (h - 1) * cols, h, -cols, k);
  }
  __syncthreads();
  stage<true>(dst, dst_kind, h * nc, slab, global_at, local_at);
}

// Raises `kernel`'s limit of dynamic shared memory past the default 48 KB
// where `bytes` needs it.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// spatial_filter on an (h, w) contiguous plane src of kind src_kind into
// dst (dst_kind), `magnitude` iterations: per iteration a row launch, then
// a column launch, through the f32 plane `work` (which may be dst when
// dst is f32). magnitude 0: one row launch without sweeps (the
// conversion). Launches on `stream`. Returns the first launch error, or
// cudaErrorInvalidValue when a line does not fit in shared memory.
extern "C" int spatial_launch(const void* src, int src_kind, float* work, void* dst,
                              int dst_kind, int h, int w, int magnitude, float alpha,
                              float one_m_alpha, float delta, int integer_domain,
                              int holes_radius, void* stream) {
  if (h <= 0 || w <= 0) return 0;
  int device = 0, smem_max = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  const int stride = w | 1;
  int rows = kRowsPerBlock;
  while (rows > 1 && static_cast<size_t>(rows) * stride * 4 > static_cast<size_t>(smem_max)) {
    rows /= 2;
  }
  int cols = kColsPerBlock;
  while (cols > 1 && static_cast<size_t>(cols) * h * 4 > static_cast<size_t>(smem_max)) {
    cols /= 2;
  }
  const size_t row_bytes = static_cast<size_t>(rows) * stride * 4;
  const size_t col_bytes = static_cast<size_t>(cols) * h * 4;
  if (row_bytes > static_cast<size_t>(smem_max) || col_bytes > static_cast<size_t>(smem_max)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = allow_smem(spatial_rows, row_bytes);
  if (err == cudaSuccess) err = allow_smem(spatial_cols, col_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Blend k{alpha, one_m_alpha, delta, integer_domain, holes_radius};
  const auto s = static_cast<cudaStream_t>(stream);
  const int row_blocks = (h + rows - 1) / rows, col_blocks = (w + cols - 1) / cols;
  if (magnitude <= 0) {
    spatial_rows<<<row_blocks, kThreads, row_bytes, s>>>(src, src_kind, dst, dst_kind, h, w,
                                                         rows, stride, 0, k);
    return static_cast<int>(cudaGetLastError());
  }
  for (int it = 0; it < magnitude; ++it) {
    const bool last = it + 1 == magnitude;
    spatial_rows<<<row_blocks, kThreads, row_bytes, s>>>(
        it == 0 ? src : work, it == 0 ? src_kind : kF32, work, kF32, h, w, rows, stride, 1, k);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    spatial_cols<<<col_blocks, kThreads, col_bytes, s>>>(work, last ? dst : work,
                                                         last ? dst_kind : kF32, h, w, cols, k);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
