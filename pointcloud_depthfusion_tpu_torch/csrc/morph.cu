// Kernel B6: up to four erosion (min) or dilation (max) passes with the
// 21-point structuring element (the 5x5 box without its four corners,
// nppiMorph*Border's SE, kernels.cu:413-418), each with a replicate border,
// in one launch; and the whole of filter_depth(use_morphology=True) in one
// launch.
//
// Replaces the Pallas kernel _erode_dilate_kernel (morph_plane) in
// pointcloud_depthfusion_tpu/ops/pallas/filters_pallas.py, one pass a call,
// which builds the element as the union of a 3x5 and a 5x3 box from
// replicate-shifted copies of the plane (_minmax_1d, _shift_replicate); and
// the eager chain around its four calls in filter_depth
// (pointcloud_depthfusion_tpu/ops/filters.py): the u16 depth window, depth
// > 0 and the ROI, open (erode, dilate), close (dilate, erode), and the
// depth zeroed outside the final mask.
//
// Design. A block owns a 128x32 output tile and stages it, with an 8-row
// halo above and below (4 passes x radius 2) and at least 8 pixels left and
// right, in shared memory as words of several pixels. A pass works on whole
// words: the horizontal radius-1 and radius-2 min/max from funnel shifts
// with the neighbour words, then the vertical min/max of the 5-wide results
// over 3 rows and of the 3-wide results over 5 rows: the union of the two
// boxes. Passes ping-pong between two buffers. Two word formats:
//   - masks (filter_depth, and bool masks): 1 bit a pixel, 32 a word, six
//     words a staged row (a 32-pixel halo each side). A warp stages a word
//     with one coalesced load and a __ballot_sync; min/max are AND/OR.
//   - any u8 plane (morph_plane's contract): 1 byte a pixel, 4 a word, 36
//     words a staged row; min/max are __vminu4/__vmaxu4 (integer min/max of
//     the bytes, so 0/1 stays 0/1 and other values stay theirs). sm_90 has
//     no byte-SIMD min/max, so these cost several instructions each: on a
//     mask the bit format does a pass with about a twentieth of the work.
//
// Every pass replicates the border of its own input, as a chain of single
// passes does (each pads its input with jnp.pad(mode="edge")). So after
// each pass the tile's pixels outside the image are rewritten from the
// image: each takes the value of the in-image pixel at its clamped row and
// column, which lies in the same tile. The next pass then reads exactly the
// replicate-padded intermediate that the chain reads, and the four passes
// are bit-exact to four launches. Halo pixels inside the image are real
// pixels; the error that the tile's own edge brings in moves inward by 2
// pixels a pass and stays inside the halo over 4 passes. Tiles that touch
// no image edge skip the rewrite.
//
// Each thread issues all its global loads of a phase before it uses any
// (the loops are unrolled into register arrays), so a phase costs about one
// load latency, not one an item.
//
// The depth window divides correctly rounded (__fdiv_rn) and truncates,
// like the eager chain's f32 division and cast; the depth scale and the
// window's metres come from device pointers when the caller holds them as
// tensors on the card, so a call needs no host sync.
//
// Bound (H100 SXM, 3.35 TB/s): filter_depth reads 4 B of depth and writes
// 4 B of depth and 1 B of mask a pixel, 0.0025 ms at 1280x720; a single
// pass reads 1 B and writes 1 B, 0.00055 ms. Bytes bind the work, but at
// these sizes a launch itself takes longer than either bound, which is why
// the chain is one launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxPasses = 4;
constexpr int kHalo = 2 * kMaxPasses;  // rows above and below; pixels at least left and right
constexpr int kTileW = 128;
constexpr int kTileH = 32;
constexpr int kRows = kTileH + 2 * kHalo;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Byte words: 4 pixels, a kHalo-pixel halo left and right.
constexpr int kByteSpan = kTileW + 2 * kHalo;
constexpr int kByteWords = kByteSpan / 4;
// Bit words: 32 pixels, one word of halo left and right.
constexpr int kBitWords = kTileW / 32 + 2;
constexpr int kBitSpan = 32 * kBitWords;
// Items a thread takes in each phase (a warp, for the bit words' staging).
constexpr int kByteStageIters = kRows * kByteSpan / kThreads;
constexpr int kBitStageIters = kRows * kBitWords / kWarps;
constexpr int kOutIters = kTileH * kTileW / kThreads;
static_assert(kRows * kByteSpan % kThreads == 0 && kRows * kBitWords % kWarps == 0 &&
                  kTileH * kTileW % kThreads == 0,
              "the stage and output loops take whole rounds of the block");

// The depth dtypes filter_depth takes on the card (morph_cuda.DEPTH_KINDS).
enum DepthKind { kU8 = 0, kI16 = 1, kU16 = 2, kI32 = 3, kI64 = 4 };

template <int kWords>
using Plane = uint32_t[kRows][kWords];

// filter_depth's window and ROI; a null pointer means the value beside it.
struct Window {
  const float* scale_p;
  float scale;
  const float* min_p;
  float min_m;
  const float* max_p;
  float max_m;
  int x0, y0, x1, y1;  // the clamped ROI, ends exclusive
};

// min (erosion) or max (dilation) of the pixels of two words, kBits bits a
// pixel.
template <int kBits, bool kDilate>
__device__ __forceinline__ uint32_t op(uint32_t a, uint32_t b) {
  if (kBits == 1) return kDilate ? a | b : a & b;
  return kDilate ? __vmaxu4(a, b) : __vminu4(a, b);
}

template <int kBits, bool kDilate>
__device__ __forceinline__ uint32_t op3(uint32_t a, uint32_t b, uint32_t c) {
  return op<kBits, kDilate>(op<kBits, kDilate>(a, b), c);
}

// The horizontal radius-1 (h3) and radius-2 (h5) min/max of word c of a
// staged row (pixel 0 in the word's low bits). __funnelshift_l(l, m, kBits)
// holds each pixel's left neighbour, __funnelshift_r(m, r, kBits) its right
// one.
template <int kBits, int kWords, bool kDilate>
__device__ __forceinline__ void row_boxes(const uint32_t* row, int c, uint32_t& h3,
                                          uint32_t& h5) {
  const uint32_t l = row[max(c - 1, 0)], m = row[c], r = row[min(c + 1, kWords - 1)];
  h3 = op3<kBits, kDilate>(m, __funnelshift_l(l, m, kBits), __funnelshift_r(m, r, kBits));
  h5 = op3<kBits, kDilate>(h3, __funnelshift_l(l, m, 2 * kBits),
                           __funnelshift_r(m, r, 2 * kBits));
}

// One pass over the whole staged tile. Neighbours past the tile's own edge
// are clamped into it: wrong values, but only in the halo (see above).
template <int kBits, int kWords, bool kDilate>
__device__ void pass(Plane<kWords>& in, Plane<kWords>& out) {
  constexpr int kIters = (kRows * kWords + kThreads - 1) / kThreads;
#pragma unroll
  for (int k = 0; k < kIters; ++k) {
    const int i = k * kThreads + threadIdx.x;
    if (i >= kRows * kWords) break;
    const int r = i / kWords, c = i - r * kWords;
    uint32_t h3[5], h5[5];
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      row_boxes<kBits, kWords, kDilate>(in[min(max(r + j - 2, 0), kRows - 1)], c, h3[j], h5[j]);
    }
    // 5 wide over rows r-1..r+1, and 3 wide over rows r-2..r+2 (whose
    // middle three rows the 5-wide boxes already cover).
    out[r][c] = op<kBits, kDilate>(op3<kBits, kDilate>(h5[1], h5[2], h5[3]),
                                   op<kBits, kDilate>(h3[0], h3[4]));
  }
}

// Rewrites every staged pixel outside the image with the in-image pixel at
// its clamped row and column: the replicate border of the next pass's
// input. The sources lie inside the image, so no thread reads what another
// writes. Byte words: pixel by pixel.
__device__ void replicate(Plane<kByteWords>& p, int ox, int oy, int h, int w) {
#pragma unroll
  for (int k = 0; k < kByteStageIters; ++k) {
    const int i = k * kThreads + threadIdx.x;
    const int r = i / kByteSpan, x = i - r * kByteSpan;
    const int gy = oy + r, gx = ox + x;
    const int cy = min(max(gy, 0), h - 1), cx = min(max(gx, 0), w - 1);
    if (cy != gy || cx != gx) {
      reinterpret_cast<uint8_t*>(p[r])[x] = reinterpret_cast<uint8_t*>(p[cy - oy])[cx - ox];
    }
  }
}

// The same for bit words, a word at a time (ox is a multiple of 32). A
// rewritten word keeps its in-image bits, so a thread that reads it
// meanwhile reads the same source bits either way.
__device__ void replicate(Plane<kBitWords>& p, int ox, int oy, int h, int w) {
  for (int i = threadIdx.x; i < kRows * kBitWords; i += kThreads) {
    const int r = i / kBitWords, c = i - r * kBitWords;
    const int sr = min(max(oy + r, 0), h - 1) - oy;
    const int x = ox + 32 * c;  // the word's first pixel
    if (sr == r && x >= 0 && x + 31 < w) continue;
    uint32_t v = p[sr][c];
    if (x < 0) v = p[sr][-ox / 32] & 1u ? ~0u : 0u;  // wholly left of pixel 0
    if (x + 31 >= w) {
      const int e = w - 1 - ox;  // pixel w - 1 of the staged row
      const int first = max(w - x, 0);  // the word's first pixel past the image
      const uint32_t right = first >= 32 ? 0u : ~0u << first;
      v = (v & ~right) | ((p[sr][e >> 5] >> (e & 31)) & 1u ? right : 0u);
    }
    p[r][c] = v;
  }
}

// npass passes over the staged planes (bit p of dilate_bits: pass p
// dilates), each but the last followed by the border's rewrite on a tile
// at the image's edge. cur: the plane holding the result.
template <int kBits, int kWords>
__device__ void run_passes(Plane<kWords> (&planes)[2], int& cur, int npass, int dilate_bits,
                           bool edge, int ox, int oy, int h, int w) {
  for (int p = 0; p < npass; ++p) {
    if ((dilate_bits >> p) & 1) {
      pass<kBits, kWords, true>(planes[cur], planes[cur ^ 1]);
    } else {
      pass<kBits, kWords, false>(planes[cur], planes[cur ^ 1]);
    }
    cur ^= 1;
    __syncthreads();
    if (edge && p + 1 < npass) {
      replicate(planes[cur], ox, oy, h, w);
      __syncthreads();
    }
  }
}

__device__ __forceinline__ int u16_threshold(float meters, float scale) {
  const float q = __fdiv_rn(meters, scale);
  return static_cast<int>(fminf(fmaxf(q, 0.0f), 65535.0f));
}

// Any u8 plane, byte words: in → out after npass passes.
__global__ void __launch_bounds__(kThreads)
    morph_bytes(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, int h, int w,
                int npass, int dilate_bits) {
  __shared__ Plane<kByteWords> planes[2];
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const int ox = x0 - kHalo, oy = y0 - kHalo;
  // Stage the tile at clamped coordinates (the input's replicate border),
  // all of a thread's loads first.
  uint8_t raw[kByteStageIters];
#pragma unroll
  for (int k = 0; k < kByteStageIters; ++k) {
    const int i = k * kThreads + threadIdx.x;
    const int r = i / kByteSpan, x = i - r * kByteSpan;
    const int gy = min(max(oy + r, 0), h - 1), gx = min(max(ox + x, 0), w - 1);
    raw[k] = in[static_cast<size_t>(gy) * w + gx];
  }
#pragma unroll
  for (int k = 0; k < kByteStageIters; ++k) {
    const int i = k * kThreads + threadIdx.x;
    const int r = i / kByteSpan;
    reinterpret_cast<uint8_t*>(planes[0][r])[i - r * kByteSpan] = raw[k];
  }
  __syncthreads();
  int cur = 0;
  run_passes<8, kByteWords>(planes, cur, npass, dilate_bits,
                            ox < 0 || oy < 0 || ox + kByteSpan > w || oy + kRows > h, ox, oy,
                            h, w);
#pragma unroll
  for (int k = 0; k < kOutIters; ++k) {
    const int i = k * kThreads + threadIdx.x;
    const int r = i / kTileW, x = i - r * kTileW;
    const int gy = y0 + r, gx = x0 + x;
    if (gy < h && gx < w) {
      out[static_cast<size_t>(gy) * w + gx] =
          reinterpret_cast<uint8_t*>(planes[cur][r + kHalo])[x + kHalo];
    }
  }
}

// A mask, bit words. kDepth: `in` is depth of type T, and the kernel runs
// filter_depth (the window, depth > 0 and the ROI make the mask; after the
// passes, depth_out holds the window's depth where the mask is set, 0
// elsewhere). Otherwise `in` is a bool plane (bytes, nonzero set). mask_out
// receives the mask as 0/1 bytes.
template <typename T, bool kDepth>
__global__ void __launch_bounds__(kThreads)
    morph_bits(const T* __restrict__ in, uint8_t* __restrict__ mask_out,
               int32_t* __restrict__ depth_out, int h, int w, int npass, int dilate_bits,
               Window win) {
  __shared__ Plane<kBitWords> planes[2];
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const int ox = x0 - 32, oy = y0 - kHalo;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int lo = 0, hi = 0;
  if (kDepth) {
    const float scale = win.scale_p ? *win.scale_p : win.scale;
    lo = u16_threshold(win.min_p ? *win.min_p : win.min_m, scale);
    hi = u16_threshold(win.max_p ? *win.max_p : win.max_m, scale);
  }
  // Stage: a warp makes a word of 32 pixels at clamped coordinates (the
  // input's replicate border) with one load a lane and a ballot; all of a
  // lane's loads first.
  int raw[kBitStageIters];
#pragma unroll
  for (int k = 0; k < kBitStageIters; ++k) {
    const int i = k * kWarps + warp;
    const int r = i / kBitWords, c = i - r * kBitWords;
    const int gy = min(max(oy + r, 0), h - 1), gx = min(max(ox + 32 * c + lane, 0), w - 1);
    raw[k] = static_cast<int>(in[static_cast<size_t>(gy) * w + gx]);
  }
#pragma unroll
  for (int k = 0; k < kBitStageIters; ++k) {
    const int i = k * kWarps + warp;
    const int r = i / kBitWords, c = i - r * kBitWords;
    const int gy = min(max(oy + r, 0), h - 1), gx = min(max(ox + 32 * c + lane, 0), w - 1);
    const int d = raw[k];
    const bool set = kDepth ? d >= lo && d <= hi && d > 0 && gx >= win.x0 && gx < win.x1 &&
                                  gy >= win.y0 && gy < win.y1
                            : d != 0;
    const uint32_t word = __ballot_sync(~0u, set);
    if (lane == 0) planes[0][r][c] = word;
  }
  __syncthreads();
  int cur = 0;
  run_passes<1, kBitWords>(planes, cur, npass, dilate_bits,
                           ox < 0 || oy < 0 || ox + kBitSpan > w || oy + kRows > h, ox, oy, h,
                           w);
  // The depth under the tile (loads first), then both outputs.
  int d[kOutIters];
#pragma unroll
  for (int k = 0; k < kOutIters; ++k) {
    const int i = k * kThreads + threadIdx.x;
    const int gy = y0 + i / kTileW, gx = x0 + i % kTileW;
    d[k] = kDepth && gy < h && gx < w ? static_cast<int>(in[static_cast<size_t>(gy) * w + gx])
                                      : 0;
  }
#pragma unroll
  for (int k = 0; k < kOutIters; ++k) {
    const int i = k * kThreads + threadIdx.x;
    const int r = i / kTileW, x = i - r * kTileW;
    const int gy = y0 + r, gx = x0 + x;
    if (gy >= h || gx >= w) continue;
    const bool v = (planes[cur][r + kHalo][1 + (x >> 5)] >> (x & 31)) & 1u;
    const size_t at = static_cast<size_t>(gy) * w + gx;
    mask_out[at] = v;
    if (kDepth) depth_out[at] = v && d[k] >= lo && d[k] <= hi ? d[k] : 0;
  }
}

dim3 grid_of(int h, int w) {
  return dim3((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH);
}

template <typename T>
void launch_depth(const void* depth, int32_t* depth_out, uint8_t* mask_out, int h, int w,
                  int npass, int dilate_bits, const Window& win, cudaStream_t s) {
  morph_bits<T, true><<<grid_of(h, w), kThreads, 0, s>>>(
      static_cast<const T*>(depth), mask_out, depth_out, h, w, npass, dilate_bits, win);
}

using DepthLaunch = void (*)(const void*, int32_t*, uint8_t*, int, int, int, int,
                             const Window&, cudaStream_t);
// By DepthKind.
constexpr DepthLaunch kDepthLaunch[] = {launch_depth<uint8_t>, launch_depth<int16_t>,
                                        launch_depth<uint16_t>, launch_depth<int32_t>,
                                        launch_depth<int64_t>};

}  // namespace

// in, out: (h, w) contiguous u8 planes of any values, h, w >= 1. npass
// passes (0..4); bit p of dilate_bits: pass p dilates (max), else erodes
// (min). Launches on `stream`; returns cudaGetLastError().
extern "C" int morph_launch(const uint8_t* in, uint8_t* out, int h, int w, int npass,
                            int dilate_bits, void* stream) {
  if (npass < 0 || npass > kMaxPasses) return static_cast<int>(cudaErrorInvalidValue);
  morph_bytes<<<grid_of(h, w), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      in, out, h, w, npass, dilate_bits);
  return static_cast<int>(cudaGetLastError());
}

// The same for a bool mask (bytes, nonzero set), in the bit format; out
// receives 0/1 bytes.
extern "C" int mask_morph_launch(const uint8_t* in, uint8_t* out, int h, int w, int npass,
                                 int dilate_bits, void* stream) {
  if (npass < 0 || npass > kMaxPasses) return static_cast<int>(cudaErrorInvalidValue);
  morph_bits<uint8_t, false><<<grid_of(h, w), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      in, out, nullptr, h, w, npass, dilate_bits, Window{});
  return static_cast<int>(cudaGetLastError());
}

// filter_depth on an (h, w) contiguous depth plane of kind `depth_kind`
// (DepthKind): depth_out (int32) and mask_out (0/1 bytes, a bool plane).
// The depth scale and the window's metres are read from scale_p, min_p and
// max_p (f32 on the card) where those are not null, else taken from the
// values beside them. ROI [x0, x1) x [y0, y1). Returns cudaGetLastError().
extern "C" int filter_depth_morph_launch(const void* depth, int depth_kind, int32_t* depth_out,
                                         uint8_t* mask_out, int h, int w, int npass,
                                         int dilate_bits, const float* scale_p, float scale,
                                         const float* min_p, float min_m, const float* max_p,
                                         float max_m, int x0, int y0, int x1, int y1,
                                         void* stream) {
  if (npass < 0 || npass > kMaxPasses || depth_kind < kU8 || depth_kind > kI64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Window win{scale_p, scale, min_p, min_m, max_p, max_m, x0, y0, x1, y1};
  kDepthLaunch[depth_kind](depth, depth_out, mask_out, h, w, npass, dilate_bits, win,
                           static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
