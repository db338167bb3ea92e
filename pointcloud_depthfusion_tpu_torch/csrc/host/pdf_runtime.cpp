// pdf_runtime — native host-side runtime for pointcloud_depthfusion_tpu.
//
// TPU-native counterpart of the reference's C++ capture/transport runtime
// (camera_node + DDS fabric): the device compute path is XLA; this library
// covers the host hot paths around it:
//
//   * pdf_render_scene  — the analytic RGB-D scene renderer (the framework's
//     data loader / camera stand-in). OpenMP-parallel; ~20x the numpy
//     renderer's throughput, enough to saturate >30 FPS dual-848x480 feeds.
//   * pdf_pairer_*      — ApproximateTime stream pairing (the message_filters
//     equivalent) as a small deterministic state machine.
//   * pdf_ring_*        — fixed-slot SPSC byte ring for zero-copy frame
//     hand-off between capture and upload threads.
//
// Build: make -C runtime   (produces libpdf_runtime.so; loaded via ctypes —
// pybind11 is unavailable in this image, and the C ABI keeps it simple.)

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// xorshift RNG (deterministic per-pixel noise/holes)
// ---------------------------------------------------------------------------

static inline uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ULL;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

static inline double rng_uniform(uint64_t key) {
  return (double)(splitmix64(key) >> 11) * (1.0 / 9007199254740992.0);
}

static inline double rng_normal(uint64_t key) {
  // Box-Muller from two decorrelated uniforms.
  double u1 = rng_uniform(key * 2 + 1);
  double u2 = rng_uniform(key * 2 + 2);
  u1 = std::max(u1, 1e-12);
  return std::sqrt(-2.0 * std::log(u1)) * std::cos(6.283185307179586 * u2);
}

// ---------------------------------------------------------------------------
// Synthetic scene renderer (matches io/synthetic.py: plane + spheres with
// world-anchored checker colors; depth = camera-frame z)
// ---------------------------------------------------------------------------

void pdf_render_scene(
    int width, int height, double fx, double fy, double ppx, double ppy,
    const double* world_from_cam /* 16 doubles, row-major 4x4 */,
    double plane_z, int n_spheres,
    const double* spheres /* n*7: cx cy cz radius r g b */,
    double checker_period, double max_depth, double depth_scale,
    double noise_std, double hole_fraction, uint64_t seed,
    uint16_t* depth_out, uint8_t* color_out) {
  const double r00 = world_from_cam[0], r01 = world_from_cam[1],
               r02 = world_from_cam[2], tx = world_from_cam[3];
  const double r10 = world_from_cam[4], r11 = world_from_cam[5],
               r12 = world_from_cam[6], ty = world_from_cam[7];
  const double r20 = world_from_cam[8], r21 = world_from_cam[9],
               r22 = world_from_cam[10], tz = world_from_cam[11];

#pragma omp parallel for schedule(static)
  for (int v = 0; v < height; ++v) {
    for (int u = 0; u < width; ++u) {
      const double dx = (u - ppx) / fx;
      const double dy = (v - ppy) / fy;
      // world-frame ray direction (camera dir has unit z => param = depth)
      const double wx = r00 * dx + r01 * dy + r02;
      const double wy = r10 * dx + r11 * dy + r12;
      const double wz = r20 * dx + r21 * dy + r22;

      double s_best = std::numeric_limits<double>::infinity();
      int obj = -1;

      // plane: world z == plane_z
      if (wz > 1e-9) {
        const double s = (plane_z - tz) / wz;
        if (s > 0.05 && s < s_best) {
          s_best = s;
          obj = 0;
        }
      }
      // spheres
      for (int i = 0; i < n_spheres; ++i) {
        const double* sp = spheres + i * 7;
        const double mx = tx - sp[0], my = ty - sp[1], mz = tz - sp[2];
        const double a = wx * wx + wy * wy + wz * wz;
        const double b = 2.0 * (wx * mx + wy * my + wz * mz);
        const double c = mx * mx + my * my + mz * mz - sp[3] * sp[3];
        const double disc = b * b - 4.0 * a * c;
        if (disc > 0.0) {
          const double s = (-b - std::sqrt(disc)) / (2.0 * a);
          if (s > 0.05 && s < s_best) {
            s_best = s;
            obj = i + 1;
          }
        }
      }

      const int idx = v * width + u;
      double depth = 0.0;
      double cr = 0.0, cg = 0.0, cb = 0.0;
      // Match the numpy reference exactly (io/synthetic.py:101,122): depth
      // is zeroed beyond max_depth but COLOR is painted for any hit.
      if (std::isfinite(s_best)) {
        if (s_best < max_depth) depth = s_best;
        const double px = tx + wx * s_best;
        const double py = ty + wy * s_best;
        if (obj == 0) {
          const double checker =
              std::fmod(std::fmod(std::floor(px / checker_period) +
                                      std::floor(py / checker_period),
                                  2.0) + 2.0,
                        2.0);
          if (checker > 0.5) {
            cr = cg = cb = 200.0;
          } else {
            cr = 90.0;
            cg = 110.0;
            cb = 130.0;
          }
        } else {
          const double* sp = spheres + (obj - 1) * 7;
          double shade = 0.7 + 0.3 * std::clamp(
              (py - sp[1]) / std::max(sp[3], 1e-6), -1.0, 1.0);
          cr = sp[4] * shade;
          cg = sp[5] * shade;
          cb = sp[6] * shade;
        }
      }

      if (depth > 0.0 && noise_std > 0.0) {
        depth += noise_std * rng_normal(seed ^ (uint64_t)idx * 0x9E3779B1ULL);
        if (depth < 0.0) depth = 0.0;
      }
      if (depth > 0.0 && hole_fraction > 0.0) {
        if (rng_uniform(seed ^ 0xABCDEF12ULL ^ (uint64_t)idx * 0x85EBCA6BULL) <
            hole_fraction)
          depth = 0.0;
      }

      double q = std::round(depth / depth_scale);
      depth_out[idx] = (uint16_t)std::clamp(q, 0.0, 65535.0);
      color_out[idx * 3 + 0] =
          (uint8_t)std::clamp(std::round(cr), 0.0, 255.0);
      color_out[idx * 3 + 1] =
          (uint8_t)std::clamp(std::round(cg), 0.0, 255.0);
      color_out[idx * 3 + 2] =
          (uint8_t)std::clamp(std::round(cb), 0.0, 255.0);
    }
  }
}

// ---------------------------------------------------------------------------
// ApproximateTime pairer (two streams)
// ---------------------------------------------------------------------------

struct PdfPairer {
  double max_interval;
  int queue_size;
  std::vector<double> qa, qb;       // timestamps
  std::vector<int64_t> ida, idb;    // user frame ids
  int64_t dropped = 0, emitted = 0;
};

void* pdf_pairer_create(double max_interval_s, int queue_size) {
  auto* p = new PdfPairer();
  p->max_interval = max_interval_s;
  p->queue_size = queue_size;
  return p;
}

void pdf_pairer_destroy(void* h) { delete (PdfPairer*)h; }

// Push a frame (stream 0/1). Emits up to max_pairs matched (id_a, id_b)
// pairs into out_ids (2*max_pairs int64). Returns the number of pairs.
int pdf_pairer_push(void* h, int stream, double timestamp, int64_t frame_id,
                    int64_t* out_ids, int max_pairs) {
  auto* p = (PdfPairer*)h;
  auto& q = stream == 0 ? p->qa : p->qb;
  auto& ids = stream == 0 ? p->ida : p->idb;
  q.push_back(timestamp);
  ids.push_back(frame_id);
  if ((int)q.size() > p->queue_size) {
    q.erase(q.begin());
    ids.erase(ids.begin());
    p->dropped++;
  }

  int n_out = 0;
  while (!p->qa.empty() && !p->qb.empty() && n_out < max_pairs) {
    double best_dt = std::numeric_limits<double>::infinity();
    size_t bi = 0, bj = 0;
    for (size_t i = 0; i < p->qa.size(); ++i)
      for (size_t j = 0; j < p->qb.size(); ++j) {
        const double dt = std::abs(p->qa[i] - p->qb[j]);
        if (dt < best_dt) {
          best_dt = dt;
          bi = i;
          bj = j;
        }
      }
    if (best_dt > p->max_interval) {
      const bool sat_a = (int)p->qa.size() >= p->queue_size;
      const bool sat_b = (int)p->qb.size() >= p->queue_size;
      if (sat_a || sat_b) {
        if (p->qa.front() <= p->qb.front()) {
          p->qa.erase(p->qa.begin());
          p->ida.erase(p->ida.begin());
        } else {
          p->qb.erase(p->qb.begin());
          p->idb.erase(p->idb.begin());
        }
        p->dropped++;
        continue;
      }
      break;
    }
    out_ids[n_out * 2] = p->ida[bi];
    out_ids[n_out * 2 + 1] = p->idb[bj];
    n_out++;
    p->emitted++;
    p->dropped += (int64_t)bi + (int64_t)bj;
    p->qa.erase(p->qa.begin(), p->qa.begin() + bi + 1);
    p->ida.erase(p->ida.begin(), p->ida.begin() + bi + 1);
    p->qb.erase(p->qb.begin(), p->qb.begin() + bj + 1);
    p->idb.erase(p->idb.begin(), p->idb.begin() + bj + 1);
  }
  return n_out;
}

int64_t pdf_pairer_dropped(void* h) { return ((PdfPairer*)h)->dropped; }
int64_t pdf_pairer_emitted(void* h) { return ((PdfPairer*)h)->emitted; }

// ---------------------------------------------------------------------------
// SPSC ring buffer of fixed-size byte slots
// ---------------------------------------------------------------------------

struct PdfRing {
  std::vector<uint8_t> data;
  size_t slot_size = 0;
  size_t n_slots = 0;
  std::atomic<uint64_t> head{0};  // next write
  std::atomic<uint64_t> tail{0};  // next read
};

void* pdf_ring_create(size_t slot_size, size_t n_slots) {
  auto* r = new PdfRing();
  r->slot_size = slot_size;
  r->n_slots = n_slots;
  r->data.resize(slot_size * n_slots);
  return r;
}

void pdf_ring_destroy(void* h) { delete (PdfRing*)h; }

// Returns pointer to a writable slot, or null if full.
uint8_t* pdf_ring_acquire_write(void* h) {
  auto* r = (PdfRing*)h;
  const uint64_t head = r->head.load(std::memory_order_relaxed);
  const uint64_t tail = r->tail.load(std::memory_order_acquire);
  if (head - tail >= r->n_slots) return nullptr;
  return r->data.data() + (head % r->n_slots) * r->slot_size;
}

void pdf_ring_commit_write(void* h) {
  auto* r = (PdfRing*)h;
  r->head.fetch_add(1, std::memory_order_release);
}

// Returns pointer to the oldest readable slot, or null if empty.
const uint8_t* pdf_ring_acquire_read(void* h) {
  auto* r = (PdfRing*)h;
  const uint64_t tail = r->tail.load(std::memory_order_relaxed);
  const uint64_t head = r->head.load(std::memory_order_acquire);
  if (tail >= head) return nullptr;
  return r->data.data() + (tail % r->n_slots) * r->slot_size;
}

void pdf_ring_commit_read(void* h) {
  auto* r = (PdfRing*)h;
  r->tail.fetch_add(1, std::memory_order_release);
}

size_t pdf_ring_size(void* h) {
  auto* r = (PdfRing*)h;
  return (size_t)(r->head.load(std::memory_order_acquire) -
                  r->tail.load(std::memory_order_acquire));
}

// ---------------------------------------------------------------------------
// rs2 post-processing filters, native capture-thread versions.
//
// The python host mirrors (ops/host_filters.py) are value-equivalent but the
// spatial filter's sequential recursion costs ~130 ms/frame in numpy at
// 848x480 — far over the 33 ms capture budget. These run the identical f32
// math (value-for-value; tests assert exact equality) with OpenMP over the
// independent rows/columns. Built with -ffp-contract=off so a*alpha +
// b*(1-alpha) rounds exactly like numpy (no FMA contraction).
// ---------------------------------------------------------------------------

}  // extern "C" (templates below need C++ linkage)

template <typename T, bool kRound>
static inline void spatial_sweep_row(T* row, int n, int stride, float alpha,
                                     float delta, int holes_radius = 0) {
  // holes_radius > 0: rs2 hole persistence — a 0 within holes_radius pixels
  // of the last valid value to its LEFT inherits it (left-value fill);
  // identical semantics to ops/filters.py _spatial_sweep(holes_radius=).
  float carry = (float)row[0];
  int run = 0;
  for (int u = 1; u < n; ++u) {
    float col = (float)row[u * stride];
    if (holes_radius) {
      if (col == 0.0f) {
        ++run;
        if (carry > 0.0f && run <= holes_radius) {
          col = carry;
          row[u * stride] = (T)col;
        }
      } else {
        run = 0;
      }
    }
    if (col > 0.0f && carry > 0.0f && std::fabs(col - carry) <= delta) {
      float blended = col * alpha + carry * (1.0f - alpha);
      if (kRound) blended = std::floor(blended + 0.5f);
      col = blended;
      row[u * stride] = (T)blended;
    }
    carry = col;
  }
}

template <typename T, bool kRound>
static void spatial_filter_impl(T* img, int h, int w, float alpha, float delta,
                                int magnitude, int holes_fill) {
  // holes_fill option → persistence radius: 0 off, 1..4 → 2/4/8/16 px,
  // 5 → unlimited (row width). Applied on the left→right sweep only.
  int holes_radius = 0;
  if (holes_fill > 0) holes_radius = holes_fill >= 5 ? w : (1 << holes_fill);
  for (int it = 0; it < magnitude; ++it) {
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
    for (int v = 0; v < h; ++v) {  // left→right then right→left
      spatial_sweep_row<T, kRound>(img + (size_t)v * w, w, 1, alpha, delta,
                                   holes_radius);
      spatial_sweep_row<T, kRound>(img + (size_t)v * w + (w - 1), w, -1, alpha,
                                   delta);
    }
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
    for (int u = 0; u < w; ++u) {  // top→bottom then bottom→top
      spatial_sweep_row<T, kRound>(img + u, h, w, alpha, delta);
      spatial_sweep_row<T, kRound>(img + (size_t)(h - 1) * w + u, h, -w, alpha,
                                   delta);
    }
  }
}

extern "C" {

void pdf_spatial_filter_u16(uint16_t* img, int h, int w, float alpha,
                            float delta, int magnitude, int holes_fill) {
  spatial_filter_impl<uint16_t, true>(img, h, w, alpha, delta, magnitude,
                                      holes_fill);
}

void pdf_spatial_filter_f32(float* img, int h, int w, float alpha, float delta,
                            int magnitude, int holes_fill) {
  spatial_filter_impl<float, false>(img, h, w, alpha, delta, magnitude,
                                    holes_fill);
}

// Decimation: per m×m block, the upper median (sorted[count/2]) of the
// NONZERO depths; 0 when the block is all holes (librealsense semantics).
void pdf_decimation_u16(const uint16_t* in, uint16_t* out, int h, int w,
                        int m) {
  const int oh = h / m, ow = w / m;
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
  for (int i = 0; i < oh; ++i) {
    std::vector<uint16_t> vals((size_t)m * m);
    for (int j = 0; j < ow; ++j) {
      int c = 0;
      for (int bi = 0; bi < m; ++bi) {
        const uint16_t* row = in + (size_t)(i * m + bi) * w + (size_t)j * m;
        for (int bj = 0; bj < m; ++bj) {
          if (row[bj]) vals[c++] = row[bj];
        }
      }
      if (c == 0) {
        out[(size_t)i * ow + j] = 0;
      } else {
        std::sort(vals.begin(), vals.begin() + c);
        out[(size_t)i * ow + j] = vals[c / 2];
      }
    }
  }
}

}  // extern "C"
