// Kernel B3: the fused per-pixel prep of render_mode="pallas".
//
// Replaces the Pallas kernel `_kernel` of fuse_prep_pallas
// (pointcloud_depthfusion_tpu/ops/pallas/fuse_prep_pallas.py:43-108). Per
// pixel of one camera:
//     depth → window [lo, hi] → z0 = d·scale → pinhole deproject →
//     3×4 transform → project → (int)(x + 0.5) → bounds → mirror
// it writes the flat target index (w·h, the dump slot, when the point is
// invalid) and the packed z-buffer key zq14 << 18 | RGB666 (0xFFFFFFFF when
// invalid), ready for the scatter-min (scatter_min_u32 in zresolve.cu).
//
// The TPU kernel tiles rows and prefetches its scalars into SMEM. Here one
// thread takes one pixel: the 25 parameters are staged in shared memory once
// per block, and color is read straight from the (H, W, 3) u8 frame, so no
// planar copy of it is made.
//
// Bit-exact to the plain version (ops/cuda/fuse_prep_cuda.fuse_prep_plain):
// every product, sum and quotient is an explicitly rounded intrinsic
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn), which nvcc never contracts
// into an FMA, in the JAX op order. Pinhole only, like the Pallas kernel:
// inverse Brown-Conrady intrinsics are not undistorted here (the packed mode
// does undistort them).
//
// Bound: bytes. 4 B depth + 3 B color in, 4 B index + 4 B key out per pixel;
// about 45 f32 operations per pixel lie far below the f32 rate.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// params (f32): 0:fx 1:fy 2:ppx 3:ppy 4:depth_scale (source camera),
// 5..16: row-major 3×4 transform, 17:fx' 18:fy' 19:ppx' 20:ppy' (target
// camera), 21:min_depth 22:max_depth (metres) 23:z_near 24:z_far. The first
// 5 change with the frame's camera, the other 20 only with the pose; the
// derived scalars are computed here.
constexpr int kParams = 25;
constexpr int kThreads = 256;
constexpr float kCastLimit = 1073741824.0f;  // 2^30, the plain version's clamp
constexpr float kZLevels = 16383.0f;         // (1 << 14) - 1

__device__ __forceinline__ int cast_rz(float v) {
  return static_cast<int>(fminf(fmaxf(v, -kCastLimit), kCastLimit));
}

// The u16 window threshold as f32: (u16)(metres / scale), truncated
// (ops/filters._u16_threshold).
__device__ __forceinline__ float u16_threshold(float metres, float scale) {
  const float q = fminf(fmaxf(__fdiv_rn(metres, scale), 0.0f), 65535.0f);
  return static_cast<float>(static_cast<int>(q));
}

// t[0]*x + t[1]*y + t[2]*z + t[3], summed left to right.
__device__ __forceinline__ float row3(const float* t, float x, float y, float z) {
  return __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(t[0], x), __fmul_rn(t[1], y)), __fmul_rn(t[2], z)),
      t[3]);
}

__global__ void fuse_prep_kernel(const int* __restrict__ depth,
                                 const uint8_t* __restrict__ color,
                                 const float* __restrict__ params, int h, int w,
                                 int out_w, int out_h, int mirror,
                                 int* __restrict__ idx,
                                 unsigned int* __restrict__ key) {
  __shared__ float p[kParams];
  if (threadIdx.x < kParams) p[threadIdx.x] = params[threadIdx.x];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= h * w) return;

  const int row = i / w;
  const int col = i - row * w;
  const int d_raw = depth[i];
  const float d = static_cast<float>(d_raw);
  const bool valid =
      d >= u16_threshold(p[21], p[4]) && d <= u16_threshold(p[22], p[4]) && d_raw > 0;
  const float z0 = __fmul_rn(d, p[4]);
  const float x0 = __fmul_rn(__fdiv_rn(__fsub_rn(static_cast<float>(col), p[2]), p[0]), z0);
  const float y0 = __fmul_rn(__fdiv_rn(__fsub_rn(static_cast<float>(row), p[3]), p[1]), z0);

  const float x = row3(p + 5, x0, y0, z0);
  const float y = row3(p + 9, x0, y0, z0);
  const float z = row3(p + 13, x0, y0, z0);

  const bool pos_z = z > 0.0f;
  const float inv_z = __fdiv_rn(1.0f, pos_z ? z : 1.0f);
  const float image_x = __fadd_rn(p[19], __fmul_rn(__fmul_rn(p[17], x), inv_z));
  const float image_y = __fadd_rn(p[20], __fmul_rn(__fmul_rn(p[18], y), inv_z));
  int px = cast_rz(__fadd_rn(image_x, 0.5f));
  const int py = cast_rz(__fadd_rn(image_y, 0.5f));
  const bool ok = valid && pos_z && px >= 0 && py >= 0 && px <= out_w - 1 &&
                  py <= out_h - 1;
  if (mirror) px = (out_w - 1) - px;
  idx[i] = ok ? py * out_w + px : out_w * out_h;

  // Clipped to z_levels - 1, so a far near-white point's key never equals
  // the 0xFFFFFFFF sentinel.
  const float q = __fmul_rn(__fdiv_rn(__fsub_rn(z, p[23]), __fsub_rn(p[24], p[23])), kZLevels);
  const unsigned int zq =
      static_cast<unsigned int>(static_cast<int>(fminf(fmaxf(q, 0.0f), kZLevels - 1.0f)));
  const uint8_t* c = color + 3 * static_cast<size_t>(i);
  const unsigned int rgb666 = (static_cast<unsigned int>(c[0] >> 2) << 12) |
                              (static_cast<unsigned int>(c[1] >> 2) << 6) |
                              static_cast<unsigned int>(c[2] >> 2);
  key[i] = ok ? (zq << 18) | rgb666 : 0xFFFFFFFFu;
}

}  // namespace

// depth: (h, w) i32. color: (h, w, 3) u8. params: (25,) f32 on the device.
// idx: (h, w) i32 out. key: (h, w) u32 out. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int fuse_prep_launch(const int* depth, const uint8_t* color,
                                const float* params, int h, int w, int out_w,
                                int out_h, int mirror, int* idx,
                                unsigned int* key, void* stream) {
  const int n = h * w;
  if (n > 0) {
    fuse_prep_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        depth, color, params, h, w, out_w, out_h, mirror, idx, key);
  }
  return static_cast<int>(cudaGetLastError());
}
