// One erosion (min) or dilation (max) of a u8 plane with the 21-point
// structuring element: the 5x5 box without its four corners
// (nppiMorph*Border's SE, kernels.cu:413-418), replicate border.
//
// Replaces the Pallas kernel _erode_dilate_kernel (morph_plane) in
// pointcloud_depthfusion_tpu/ops/pallas/filters_pallas.py, which builds the
// element as the union of a 3x5 and a 5x3 box from replicate-shifted
// copies of the whole plane (_minmax_1d, _shift_replicate).
//
// Design: one thread per output pixel over a 2-D grid of 32x8 tiles, as
// filters3x3.cu. Each block stages its tile plus a 2-pixel halo (36x12
// bytes) in shared memory, reading every halo pixel at clamped coordinates,
// which is the replicate border; then each thread reduces its 21 taps with
// integer min or max. The same code serves any u8 values, so a 0/1 mask
// (the depth filter's bool mask viewed as u8) stays 0/1.
//
// Bound: 1 B read and 1 B written per pixel (0.81 MB at 848x480): a few
// tenths of a microsecond at 3.35 TB/s, so the launch itself sets the
// time. One launch per pass: each pass of open/close replicates the border
// of its own input, so fusing the four passes behind one 8-pixel halo
// would change the outer two rows and columns.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr int kHalo = 2;
constexpr int kSmemW = kTileW + 2 * kHalo;
constexpr int kSmemH = kTileH + 2 * kHalo;

__global__ void morph21(const uint8_t* __restrict__ in,
                        uint8_t* __restrict__ out, int h, int w,
                        int dilate) {
  __shared__ uint8_t tile[kSmemH][kSmemW];
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  for (int i = tid; i < kSmemH * kSmemW; i += kTileW * kTileH) {
    const int ty = i / kSmemW;
    const int tx = i - ty * kSmemW;
    const int gy = min(max(y0 + ty - kHalo, 0), h - 1);
    const int gx = min(max(x0 + tx - kHalo, 0), w - 1);
    tile[ty][tx] = in[gy * w + gx];
  }
  __syncthreads();
  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  if (x >= w || y >= h) return;
  const int cy = threadIdx.y + kHalo;
  const int cx = threadIdx.x + kHalo;
  int acc = tile[cy][cx];
#pragma unroll
  for (int dy = -2; dy <= 2; ++dy) {
#pragma unroll
    for (int dx = -2; dx <= 2; ++dx) {
      if ((dy == -2 || dy == 2) && (dx == -2 || dx == 2)) continue;
      const int v = tile[cy + dy][cx + dx];
      acc = dilate ? max(acc, v) : min(acc, v);
    }
  }
  out[y * w + x] = static_cast<uint8_t>(acc);
}

}  // namespace

// in, out: (h, w) contiguous u8 planes, h, w >= 1. dilate: 0 = erosion
// (min), 1 = dilation (max). Launches on `stream`; returns
// cudaGetLastError().
extern "C" int morph_launch(const uint8_t* in, uint8_t* out, int h, int w,
                            int dilate, void* stream) {
  const dim3 block(kTileW, kTileH);
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH);
  morph21<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(in, out, h, w,
                                                                 dilate);
  return static_cast<int>(cudaGetLastError());
}
