// 3×3 binomial Gauss or 3×3 median of one u8 plane; the border passes through.
//
// Replaces the Pallas kernels _gauss3x3_kernel (gauss3x3_plane) and
// _median3x3_kernel with its _median9 network (median3x3_plane) in
// pointcloud_depthfusion_tpu/ops/pallas/filters_pallas.py, which the JAX
// pipeline computes through XLA's filter_color_planar.
//
// Integer arithmetic only. Gauss: s = sum of w*x with weights [1,2,1]x[1,2,1],
// then (s + 8) >> 4, which equals floor(s/16 + 0.5): the half-up rounding of
// the reference's NPP call, which the JAX package computes exactly in f32.
// Median: the same 19-exchange network on int32.
// Border pixels, and every pixel of a plane with H < 3 or W < 3, copy the
// input through.
//
// Bound: 1 B read (nine taps, mostly from L1) and 1 B written per pixel, a
// few dozen integer operations: memory- and launch-bound at image sizes.
// Later: fuse the winner decode of the resolve and all three channels into
// one launch that writes the (H, W, 3) image.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void sort2(int& a, int& b) {
  const int lo = min(a, b);
  b = max(a, b);
  a = lo;
}

__device__ __forceinline__ int median9(int p[9]) {
  sort2(p[1], p[2]); sort2(p[4], p[5]); sort2(p[7], p[8]);
  sort2(p[0], p[1]); sort2(p[3], p[4]); sort2(p[6], p[7]);
  sort2(p[1], p[2]); sort2(p[4], p[5]); sort2(p[7], p[8]);
  sort2(p[0], p[3]); sort2(p[5], p[8]); sort2(p[4], p[7]);
  sort2(p[3], p[6]); sort2(p[1], p[4]); sort2(p[2], p[5]);
  sort2(p[4], p[7]); sort2(p[4], p[2]); sort2(p[6], p[4]);
  sort2(p[4], p[2]);
  return p[4];
}

__global__ void filter3x3(const uint8_t* __restrict__ in,
                          uint8_t* __restrict__ out, int h, int w,
                          int median) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const int i = y * w + x;
  if (x == 0 || y == 0 || x == w - 1 || y == h - 1) {
    out[i] = in[i];
    return;
  }
  int p[9];
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      p[dy * 3 + dx] = in[(y + dy - 1) * w + (x + dx - 1)];
    }
  }
  int v;
  if (median) {
    v = median9(p);
  } else {
    const int s = p[0] + 2 * p[1] + p[2] + 2 * p[3] + 4 * p[4] + 2 * p[5] +
                  p[6] + 2 * p[7] + p[8];
    v = (s + 8) >> 4;
  }
  out[i] = static_cast<uint8_t>(v);
}

}  // namespace

// in, out: (h, w) contiguous u8 planes. median: 0 = Gauss, 1 = median.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int filter3x3_launch(const uint8_t* in, uint8_t* out, int h, int w,
                                int median, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((w + block.x - 1) / block.x, (h + block.y - 1) / block.y);
  filter3x3<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(in, out, h, w,
                                                                   median);
  return static_cast<int>(cudaGetLastError());
}
