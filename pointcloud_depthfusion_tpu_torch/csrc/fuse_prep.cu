// Kernel B3: the fused per-pixel prep of every render mode, for all N cameras
// of a frame in one launch.
//
// Replaces the Pallas kernel `_kernel` of fuse_prep_pallas
// (pointcloud_depthfusion_tpu/ops/pallas/fuse_prep_pallas.py:43-108) and the
// eager chain the other modes ran in its place (filter_depth →
// deproject_planar → transform_planar → compute_pixel_indices_planar, and
// the rig's batched copy of it). Per pixel of camera c:
//     depth → window [lo, hi] ∧ d > 0 ∧ ROI → metres → deproject (inverse
//     Brown-Conrady undistortion when the row asks for it) → 3×4 transform
//     → project → (int)(x + 0.5) → bounds → mirror
// and it writes one of two outputs, chosen by a template flag:
//   (a) the flat target index (w·h, the dump slot, where the point is
//       dropped) and the packed z-buffer key zq14 << 18 | RGB666
//       (0xFFFFFFFF where dropped): the "pallas" render mode, pinhole only
//       like the Pallas kernel (it never undistorts);
//   (b) the masked exact feed that the z-resolve and the packed scatter-min
//       take (zresolve.cu): idx (w·h where dropped, plus the camera's pixel
//       offset), f32 z, the ok mask and rgb24.
// Both also write the camera's valid plane (window ∧ d > 0 ∧ ROI, and for
// (b) metres > 0, as the deprojection's mask).
//
// Per camera, its 4×4 pose and its depth scale are read from the caller's
// own tensors, and the rest from one (N, 17) f32 and one (N, 6) i32 table
// that the wrapper (ops/cuda/fuse_prep_cuda.py) builds once per set of
// cameras and config: a frame uploads nothing but its frames. A block
// takes 256 pixels of one camera (blockIdx.y), so its row is staged in
// shared memory once. Camera c's frame, pose and depth scale lie at
// base + c·stride bytes: a stacked (N, ...) tensor has its camera stride,
// and two separate tensors (the dual frame's two Framesets, its two poses)
// the distance between them, so none of them needs a copy.
//
// Bit-exact to the plain version (fuse_prep_cuda.fuse_prep_feed_plain and
// fuse_prep_plain, the eager chain): every product, sum and quotient is an
// explicitly rounded intrinsic (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn),
// which nvcc never contracts into an FMA, in the eager op order.
//
// Bound: bytes. Per pixel 4 B depth and 3 B color in; (b) writes 4 B idx,
// 4 B z, 1 B ok, 4 B rgb24 and 1 B valid, (a) 4 B idx, 4 B key and 1 B
// valid. About 60 f32 operations a pixel (90 undistorting) lie far below
// the f32 rate.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// A camera's f32 row as the kernel stages it. The first 17 columns come
// from the frame's pose and depth-scale tensors, the rest (kFx on) from
// the static table, which holds only those.
enum FCol {
  kPose = 0,      // 16: the 4×4 camera → virtual transform, row-major
  kScale = 16,    // metres per depth unit
  kFx = 17, kFy, kPpx, kPpy,   // source intrinsics
  kCoeffs = 21,   // 5 distortion coefficients
  kOutFx = 26, kOutFy, kOutPpx, kOutPpy,  // the virtual camera
  kMinDepth = 30, kMaxDepth,   // the window, metres
  kZNear = 32, kZFar,          // the packed key's depth range (output a)
  kFCols = 34
};
constexpr int kSCols = kFCols - kFx;  // the static table's columns
// The i32 table's columns: the ROI [x0, x1) × [y0, y1), clamped; the pixel
// offset added to every index of output (b); 1 to undistort (b).
enum ICol { kRoiX0 = 0, kRoiY0, kRoiX1, kRoiY1, kPixOffset, kUndistort, kICols };

constexpr int kThreads = 256;
constexpr float kCastLimit = 1073741824.0f;  // 2^30, the plain version's clamp
constexpr float kZLevels = 16383.0f;         // (1 << 14) - 1

struct Prep {
  const char* depth;        // camera 0's (h, w) i32 depth
  long long depth_stride;   // bytes from one camera's depth to the next
  const char* color;        // camera 0's (h, w, 3) u8 or (h, w) i32 rgb24
  long long color_stride;
  int packed_color;         // color is i32 rgb24
  const char* pose;         // camera 0's row-major 4×4 f32 camera → virtual pose
  long long pose_stride;
  const char* scale;        // camera 0's f32 depth scale, metres per unit
  long long scale_stride;
  const float* stab;        // (n, kSCols): columns kFx on
  const int* itab;          // (n, kICols)
  int h, w, out_w, out_h, mirror;
  int* idx;                 // (n·h·w,) outputs
  unsigned int* key;        // (a)
  float* z;                 // (b)
  unsigned char* ok;        // (b)
  int* rgb24;               // (b), written when write_rgb
  int write_rgb;
  unsigned char* valid;     // (n, h, w)
};

__device__ __forceinline__ int cast_rz(float v) {
  return static_cast<int>(fminf(fmaxf(v, -kCastLimit), kCastLimit));
}

// The u16 window threshold: (u16)(metres / scale), truncated
// (ops/filters._u16_threshold).
__device__ __forceinline__ int u16_threshold(float metres, float scale) {
  return static_cast<int>(fminf(fmaxf(__fdiv_rn(metres, scale), 0.0f), 65535.0f));
}

// t[0]*x + t[1]*y + t[2]*z + t[3], summed left to right.
__device__ __forceinline__ float row3(const float* t, float x, float y, float z) {
  return __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(t[0], x), __fmul_rn(t[1], y)), __fmul_rn(t[2], z)),
      t[3]);
}

// Inverse Brown-Conrady undistortion of normalized coordinates
// (core/geometry._undistort_inverse_brown_conrady), products associated
// left to right as the eager expression is written.
__device__ __forceinline__ void undistort(const float* c, float& x, float& y) {
  const float r2 = __fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y));
  const float f = __fadd_rn(
      __fadd_rn(__fadd_rn(1.0f, __fmul_rn(c[0], r2)), __fmul_rn(__fmul_rn(c[1], r2), r2)),
      __fmul_rn(__fmul_rn(__fmul_rn(c[4], r2), r2), r2));
  const float ux = __fadd_rn(
      __fadd_rn(__fmul_rn(x, f), __fmul_rn(__fmul_rn(__fmul_rn(2.0f, c[2]), x), y)),
      __fmul_rn(c[3], __fadd_rn(r2, __fmul_rn(__fmul_rn(2.0f, x), x))));
  const float uy = __fadd_rn(
      __fadd_rn(__fmul_rn(y, f), __fmul_rn(__fmul_rn(__fmul_rn(2.0f, c[3]), x), y)),
      __fmul_rn(c[2], __fadd_rn(r2, __fmul_rn(__fmul_rn(2.0f, y), y))));
  x = ux;
  y = uy;
}

template <bool kFeed>
__global__ void __launch_bounds__(kThreads) fuse_prep_kernel(Prep p) {
  __shared__ float f[kFCols];
  __shared__ int q[kICols];
  const int cam = blockIdx.y;
  if (threadIdx.x < kScale) {
    f[threadIdx.x] = reinterpret_cast<const float*>(p.pose + cam * p.pose_stride)[threadIdx.x];
  } else if (threadIdx.x == kScale) {
    f[kScale] = *reinterpret_cast<const float*>(p.scale + cam * p.scale_stride);
  } else if (threadIdx.x < kFCols) {
    f[threadIdx.x] = p.stab[cam * kSCols + threadIdx.x - kFx];
  }
  if (threadIdx.x < kICols) q[threadIdx.x] = p.itab[cam * kICols + threadIdx.x];
  __syncthreads();
  const int n_cam = p.h * p.w;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_cam) return;
  const size_t o = static_cast<size_t>(cam) * n_cam + i;  // the flat output slot

  const int row = i / p.w;
  const int col = i - row * p.w;
  const int d_raw = reinterpret_cast<const int*>(p.depth + cam * p.depth_stride)[i];
  const float scale = f[kScale];
  // filter_depth: minmax window, then > 0 and the ROI; the depth is zeroed
  // outside the mask.
  const bool keep = d_raw >= u16_threshold(f[kMinDepth], scale) &&
                    d_raw <= u16_threshold(f[kMaxDepth], scale);
  const bool in_roi = col >= q[kRoiX0] && col < q[kRoiX1] && row >= q[kRoiY0] &&
                      row < q[kRoiY1];
  const bool valid0 = keep && d_raw > 0 && in_roi;
  const float dm = __fmul_rn(static_cast<float>(valid0 ? d_raw : 0), scale);
  const bool valid = valid0 && (!kFeed || dm > 0.0f);
  p.valid[o] = valid;

  float nx = __fdiv_rn(__fsub_rn(static_cast<float>(col), f[kPpx]), f[kFx]);
  float ny = __fdiv_rn(__fsub_rn(static_cast<float>(row), f[kPpy]), f[kFy]);
  if (kFeed && q[kUndistort]) undistort(f + kCoeffs, nx, ny);
  const float x0 = __fmul_rn(dm, nx);
  const float y0 = __fmul_rn(dm, ny);
  const float x = row3(f + kPose, x0, y0, dm);
  const float y = row3(f + kPose + 4, x0, y0, dm);
  const float z = row3(f + kPose + 8, x0, y0, dm);

  const bool pos_z = z > 0.0f;
  const float inv_z = __fdiv_rn(1.0f, pos_z ? z : 1.0f);
  const float image_x = __fadd_rn(f[kOutPpx], __fmul_rn(__fmul_rn(f[kOutFx], x), inv_z));
  const float image_y = __fadd_rn(f[kOutPpy], __fmul_rn(__fmul_rn(f[kOutFy], y), inv_z));
  int px = cast_rz(__fadd_rn(image_x, 0.5f));
  const int py = cast_rz(__fadd_rn(image_y, 0.5f));
  const bool ok = valid && pos_z && px >= 0 && py >= 0 && px <= p.out_w - 1 &&
                  py <= p.out_h - 1;
  if (p.mirror) px = (p.out_w - 1) - px;
  const int flat = ok ? py * p.out_w + px : p.out_w * p.out_h;

  int rgb;
  const char* c = p.color + cam * p.color_stride;
  if (p.packed_color) {
    rgb = reinterpret_cast<const int*>(c)[i];
  } else {
    const uint8_t* c3 = reinterpret_cast<const uint8_t*>(c) + 3 * static_cast<size_t>(i);
    rgb = (static_cast<int>(c3[0]) << 16) | (static_cast<int>(c3[1]) << 8) | c3[2];
  }

  if (kFeed) {
    p.idx[o] = flat + q[kPixOffset];
    p.z[o] = z;
    p.ok[o] = ok;
    if (p.write_rgb) p.rgb24[o] = rgb;
  } else {
    p.idx[o] = flat;
    // Clipped to z_levels - 1, so a far near-white point's key never
    // equals the 0xFFFFFFFF sentinel.
    const float qz = __fmul_rn(
        __fdiv_rn(__fsub_rn(z, f[kZNear]), __fsub_rn(f[kZFar], f[kZNear])), kZLevels);
    const unsigned int zq =
        static_cast<unsigned int>(static_cast<int>(fminf(fmaxf(qz, 0.0f), kZLevels - 1.0f)));
    const unsigned int u = static_cast<unsigned int>(rgb);
    const unsigned int rgb666 =
        (((u >> 18) & 0x3Fu) << 12) | (((u >> 10) & 0x3Fu) << 6) | ((u >> 2) & 0x3Fu);
    p.key[o] = ok ? (zq << 18) | rgb666 : 0xFFFFFFFFu;
  }
}

}  // namespace

// n cameras of (h, w) pixels. depth: camera c's (h, w) i32 at depth +
// c·depth_stride bytes; color likewise, (h, w, 3) u8 or, when
// packed_color, (h, w) i32 rgb24; pose (16 f32) and scale (one f32)
// likewise. stab (n, 17) f32 and itab (n, 6) i32 on the device (columns
// above). feed = 1 writes output (b) into idx, z, ok
// and, when write_rgb, rgb24; feed = 0 output (a) into idx and key; both
// write valid. Every output holds n·h·w entries, camera-major.
// One launch on `stream`; returns cudaGetLastError().
extern "C" int fuse_prep_launch(const void* depth, long long depth_stride, const void* color,
                                long long color_stride, int packed_color, const void* pose,
                                long long pose_stride, const void* scale,
                                long long scale_stride, const float* stab, const int* itab, int n, int h, int w, int out_w, int out_h,
                                int mirror, int feed, int* idx, unsigned int* key, float* z,
                                unsigned char* ok, int* rgb24, int write_rgb,
                                unsigned char* valid, void* stream) {
  if (n > 0 && h > 0 && w > 0) {
    Prep p{static_cast<const char*>(depth), depth_stride, static_cast<const char*>(color),
           color_stride, packed_color, static_cast<const char*>(pose), pose_stride,
           static_cast<const char*>(scale), scale_stride, stab, itab, h, w, out_w, out_h, mirror,
           idx, key, z, ok, rgb24, write_rgb, valid};
    const dim3 grid((h * w + kThreads - 1) / kThreads, n);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (feed) {
      fuse_prep_kernel<true><<<grid, kThreads, 0, s>>>(p);
    } else {
      fuse_prep_kernel<false><<<grid, kThreads, 0, s>>>(p);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
