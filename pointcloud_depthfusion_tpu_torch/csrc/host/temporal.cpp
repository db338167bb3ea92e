// The camera node's temporal EMA step (rs2::temporal_filter as the
// port's CameraNode computes it) in one pass over the frame.
//
// Value-identical to ops/host_filters._temporal_filter_numpy: each pixel
// widens to f32, blends as (a*c) + (b*p) where both frames have depth
// within delta, keeps the previous value over a hole, and for integer
// depth rounds half to even, clips to [0, 65535] and narrows. The caller
// passes a = f32(alpha), b = f32(1 - alpha) with the subtraction in f64,
// and delta = f32(delta): the constants numpy's scalar rules give. Built
// with the runtime's flags into the same library; -ffp-contract=off keeps
// the blend from contracting into an FMA.
//
// One thread: the step is bandwidth-bound (two frames in, one out) and
// runs on a host whose other cores are busy; the ctypes call releases the
// GIL, so the caller's other threads keep running.

#include <cmath>
#include <cstdint>

namespace {

template <typename T>
inline T narrow(float o);

template <>
inline uint16_t narrow<uint16_t>(float o) {
  o = std::nearbyint(o);  // half to even under the default rounding mode
  o = o < 0.0f ? 0.0f : (o > 65535.0f ? 65535.0f : o);
  return static_cast<uint16_t>(o);
}

template <>
inline float narrow<float>(float o) {
  return o;
}

template <typename T>
void temporal_step(const T* __restrict cur, const T* __restrict prev, T* __restrict out,
                   int64_t n, float a, float b, float delta) {
  for (int64_t i = 0; i < n; ++i) {
    const float c = static_cast<float>(cur[i]);
    const float p = static_cast<float>(prev[i]);
    float o = c;
    if (c > 0.0f && p > 0.0f && std::fabs(c - p) <= delta) {
      o = a * c + b * p;
    } else if (c == 0.0f && p > 0.0f) {
      o = p;
    }
    out[i] = narrow<T>(o);
  }
}

}  // namespace

extern "C" {

void pdf_temporal_step_u16(const uint16_t* cur, const uint16_t* prev, uint16_t* out,
                           int64_t n, float a, float b, float delta) {
  temporal_step(cur, prev, out, n, a, b, delta);
}

void pdf_temporal_step_f32(const float* cur, const float* prev, float* out, int64_t n,
                           float a, float b, float delta) {
  temporal_step(cur, prev, out, n, a, b, delta);
}

}  // extern "C"
