// 3×3 binomial Gauss or 3×3 median of u8 images; the border passes through.
//
// Replaces the Pallas kernels _gauss3x3_kernel (gauss3x3_plane) and
// _median3x3_kernel with its _median9 network (median3x3_plane) in
// pointcloud_depthfusion_tpu/ops/pallas/filters_pallas.py, which the JAX
// pipeline computes through XLA's filter_color_planar.
//
// Integer arithmetic only. Gauss: s = sum of w*x with weights [1,2,1]x[1,2,1],
// then (s + 8) >> 4, which equals floor(s/16 + 0.5): the half-up rounding of
// the reference's NPP call, which the JAX package computes exactly in f32.
// Median: the same 19-exchange network. Border pixels, and every pixel of an
// image with H < 3 or W < 3, copy the input through.
//
// One kernel, color3x3: the whole color tail of a fused frame in one
// launch. It reads either (a) the packed winner of the z-buffer resolve, an
// int32 r<<16 | g<<8 | b per pixel with INT32_MAX where uncovered (black),
// or (b) one to four u8 channels, as separate planes or interleaved; it
// filters every channel (or only decodes and interleaves, mode 0) and
// writes the interleaved (..., H, W, C) u8 image. Images of a batch lie one
// after another and are filtered apart (blockIdx.z). The per-plane API is
// the same kernel with one channel.
//
// A block loads its 128×16 output tile plus a one-pixel halo into shared
// memory, each pixel once, as one 32-bit word holding its channels in bytes
// 0..C-1 (16 B int4 loads of the packed winner where aligned, u32 words of
// the u8 channels). Each thread then computes four adjacent output pixels
// for all channels at once, in SIMD-within-a-word integer arithmetic: the
// Gauss sums two channels per 32-bit word in 16-bit lanes (at most
// 16·255 + 8 < 2^16, so no lane carries into the next), the median network
// runs on per-byte min/max (__vminu4/__vmaxu4). Stores are 32-bit words
// where the output is aligned.
//
// Bound: form (a) moves 4 B in and 3 B out per pixel, form (b) C in and C
// out; a few dozen integer operations per pixel. At the fused frame's sizes
// (0.4-0.9 Mpx) that is under 2 µs at 3.35 TB/s, so launches, not bytes,
// set the time: one launch per image replaces the resolve decode (about ten
// elementwise launches), three plane launches and a stack.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 128;  // output columns of a block: 32 threads × 4 pixels
constexpr int kTileH = 16;   // output rows of a block: one per thread row
constexpr int kPitch = kTileW + 8;  // shared column j holds x = x0 - 4 + j
constexpr int kModeCopy = 0, kModeGauss = 1;  // 2: median

__device__ __forceinline__ void vsort2(uint32_t& a, uint32_t& b) {
  const uint32_t lo = __vminu4(a, b);
  b = __vmaxu4(a, b);
  a = lo;
}

// The 19-exchange network of median9, on every byte of the words at once.
__device__ __forceinline__ uint32_t vmedian9(uint32_t p[9]) {
  vsort2(p[1], p[2]); vsort2(p[4], p[5]); vsort2(p[7], p[8]);
  vsort2(p[0], p[1]); vsort2(p[3], p[4]); vsort2(p[6], p[7]);
  vsort2(p[1], p[2]); vsort2(p[4], p[5]); vsort2(p[7], p[8]);
  vsort2(p[0], p[3]); vsort2(p[5], p[8]); vsort2(p[4], p[7]);
  vsort2(p[3], p[6]); vsort2(p[1], p[4]); vsort2(p[2], p[5]);
  vsort2(p[4], p[7]); vsort2(p[4], p[2]); vsort2(p[6], p[4]);
  vsort2(p[4], p[2]);
  return p[4];
}

// r<<16 | g<<8 | b → bytes 0, 1, 2 = r, g, b; uncovered (INT32_MAX) → black.
__device__ __forceinline__ uint32_t decode_winner(int v) {
  return v == INT_MAX ? 0u : __byte_perm(static_cast<uint32_t>(v), 0u, 0x4012);
}

struct Source {
  const int* winner;      // form (a), or null
  const uint8_t* ch[4];   // form (b): channel c of flat pixel f at ch[c][f * pstride]
  int pstride;
};

// Pixel channels packed into bytes 0..C-1 of a word.
template <int C>
__device__ __forceinline__ uint32_t load_pixel(const Source& s, long long f) {
  if (s.winner) return decode_winner(s.winner[f]);
  uint32_t v = 0;
#pragma unroll
  for (int c = 0; c < C; ++c) v |= static_cast<uint32_t>(s.ch[c][f * s.pstride]) << (8 * c);
  return v;
}

__device__ __forceinline__ bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// The four pixels of flat index f .. f+3 (all inside one row), by vector
// loads where aligned.
template <int C>
__device__ __forceinline__ void load4(const Source& s, long long f, uint32_t q[4]) {
  if (s.winner) {
    const int* p = s.winner + f;
    if (aligned(p, 16)) {
      const int4 v = *reinterpret_cast<const int4*>(p);
      q[0] = decode_winner(v.x); q[1] = decode_winner(v.y);
      q[2] = decode_winner(v.z); q[3] = decode_winner(v.w);
      return;
    }
  } else if (s.pstride == 1) {
    bool ok = true;
#pragma unroll
    for (int c = 0; c < C; ++c) ok = ok && aligned(s.ch[c] + f, 4);
    if (ok) {
      q[0] = q[1] = q[2] = q[3] = 0;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const uint32_t word = *reinterpret_cast<const uint32_t*>(s.ch[c] + f);
#pragma unroll
        for (int k = 0; k < 4; ++k) q[k] |= ((word >> (8 * k)) & 0xFFu) << (8 * c);
      }
      return;
    }
  } else if (s.pstride == C && aligned(s.ch[0] + f * C, 4)) {
    // interleaved: the 4·C bytes of the four pixels are C words
    uint32_t word[C];
#pragma unroll
    for (int k = 0; k < C; ++k) word[k] = reinterpret_cast<const uint32_t*>(s.ch[0] + f * C)[k];
    q[0] = q[1] = q[2] = q[3] = 0;
#pragma unroll
    for (int i = 0; i < 4 * C; ++i) {
      q[i / C] |= ((word[i / 4] >> (8 * (i % 4))) & 0xFFu) << (8 * (i % C));
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = load_pixel<C>(s, f + k);
}

// Σ w·x of one 16-bit-lane word per tap column: top + 2·mid + bottom.
__device__ __forceinline__ uint32_t lanes_lo(uint32_t v) { return v & 0x00FF00FFu; }
__device__ __forceinline__ uint32_t lanes_hi(uint32_t v) { return (v >> 8) & 0x00FF00FFu; }
__device__ __forceinline__ uint32_t round16(uint32_t s) {
  return ((s + 0x00080008u) >> 4) & 0x00FF00FFu;
}

template <int C>
__global__ void __launch_bounds__(32 * kTileH) color3x3(Source src, uint8_t* __restrict__ out,
                                                        int h, int w, int mode) {
  __shared__ __align__(16) uint32_t tile[kTileH + 2][kPitch];
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const long long img = static_cast<long long>(blockIdx.z) * h * w;
  const int tx = threadIdx.x, ty = threadIdx.y;

  // Load rows y0-1 .. y0+kTileH, columns x0-1 .. x0+kTileW; 0 outside the
  // image (no output that reads a neighbour lies on the image's border).
  for (int r = ty; r < kTileH + 2; r += kTileH) {
    const int y = y0 - 1 + r;
    const bool row = y >= 0 && y < h;
    const long long f = img + static_cast<long long>(y) * w;
    const int x = x0 + 4 * tx;
    uint32_t q[4] = {0u, 0u, 0u, 0u};
    if (row && x + 3 < w) {
      load4<C>(src, f + x, q);
    } else if (row) {
#pragma unroll
      for (int k = 0; k < 4; ++k) q[k] = x + k < w ? load_pixel<C>(src, f + x + k) : 0u;
    }
    *reinterpret_cast<uint4*>(&tile[r][4 + 4 * tx]) = make_uint4(q[0], q[1], q[2], q[3]);
    if (tx < 2) {
      const int xh = tx == 0 ? x0 - 1 : x0 + kTileW;
      tile[r][tx == 0 ? 3 : kTileW + 4] =
          row && xh >= 0 && xh < w ? load_pixel<C>(src, f + xh) : 0u;
    }
  }
  __syncthreads();

  const int y = y0 + ty;
  const int x = x0 + 4 * tx;
  if (y >= h || x >= w) return;
  // Columns x-1 .. x+4 of rows y-1 .. y+1.
  uint32_t a[3][6];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const uint4 mid = *reinterpret_cast<const uint4*>(&tile[ty + r][4 + 4 * tx]);
    a[r][0] = tile[ty + r][3 + 4 * tx];
    a[r][1] = mid.x; a[r][2] = mid.y; a[r][3] = mid.z; a[r][4] = mid.w;
    a[r][5] = tile[ty + r][8 + 4 * tx];
  }
  uint32_t q[4];
  if (mode == kModeGauss) {
    uint32_t vlo[6], vhi[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      vlo[k] = lanes_lo(a[0][k]) + 2 * lanes_lo(a[1][k]) + lanes_lo(a[2][k]);
      vhi[k] = lanes_hi(a[0][k]) + 2 * lanes_hi(a[1][k]) + lanes_hi(a[2][k]);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      q[k] = round16(vlo[k] + 2 * vlo[k + 1] + vlo[k + 2]) |
             (round16(vhi[k] + 2 * vhi[k + 1] + vhi[k + 2]) << 8);
    }
  } else if (mode != kModeCopy) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      uint32_t p[9] = {a[0][k], a[0][k + 1], a[0][k + 2], a[1][k], a[1][k + 1],
                       a[1][k + 2], a[2][k], a[2][k + 1], a[2][k + 2]};
      q[k] = vmedian9(p);
    }
  }
  const bool edge_row = y == 0 || y == h - 1;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (mode == kModeCopy || edge_row || x + k == 0 || x + k >= w - 1) q[k] = a[1][k + 1];
  }

  uint8_t* dst = out + (img + static_cast<long long>(y) * w + x) * C;
  if (x + 3 < w && aligned(dst, 4)) {
#pragma unroll
    for (int k = 0; k < C; ++k) {
      uint32_t word = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int i = 4 * k + b;  // output byte: pixel i / C, channel i % C
        word |= ((q[i / C] >> (8 * (i % C))) & 0xFFu) << (8 * b);
      }
      reinterpret_cast<uint32_t*>(dst)[k] = word;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (x + k < w) {
#pragma unroll
        for (int c = 0; c < C; ++c) dst[k * C + c] = static_cast<uint8_t>(q[k] >> (8 * c));
      }
    }
  }
}

}  // namespace

// batch images of h × w pixels into out, (batch, h, w, channels) u8,
// contiguous. Input: `winner` ((batch, h, w) int32, channels must be 3), or,
// when it is null, 1 to 4 u8 channels with channel c of flat pixel f at
// ch_c[f * pstride] (planes: pstride 1; interleaved: ch_c = base + c,
// pstride = channels). mode: 0 = copy (decode / interleave only), 1 =
// Gauss, 2 = median. Launches on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int color3x3_launch(const int* winner, const uint8_t* ch0, const uint8_t* ch1,
                               const uint8_t* ch2, const uint8_t* ch3, int pstride,
                               int channels, uint8_t* out, int batch, int h, int w, int mode,
                               void* stream) {
  if (channels < 1 || channels > 4 || (winner && channels != 3) || mode < 0 || mode > 2 ||
      batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch <= 0 || h <= 0 || w <= 0) return static_cast<int>(cudaGetLastError());
  const Source src{winner, {ch0, ch1, ch2, ch3}, pstride};
  const dim3 block(32, kTileH);
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, batch);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (channels) {
    case 1: color3x3<1><<<grid, block, 0, s>>>(src, out, h, w, mode); break;
    case 2: color3x3<2><<<grid, block, 0, s>>>(src, out, h, w, mode); break;
    case 3: color3x3<3><<<grid, block, 0, s>>>(src, out, h, w, mode); break;
    default: color3x3<4><<<grid, block, 0, s>>>(src, out, h, w, mode); break;
  }
  return static_cast<int>(cudaGetLastError());
}
