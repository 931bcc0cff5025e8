// kpt_native — host-native runtime pieces of kylespathtracer.
//
// The reference's host layer is C++ plumbing around the GPU (window, GL
// resources, shader IO: render.cpp, shader.cpp, main.cpp). The JAX build
// drives XLA's C++ runtime (PJRT) for device plumbing, so the genuinely
// native pieces here are the ones JAX does not provide:
//
//   * kpt_write_png — zlib PNG encoder for frame export (the reference only
//     ever swapped to screen, render.cpp:231-278).
//   * kpt_march    — a multithreaded C++ re-execution of the GLSL sphere
//     tracer (common.glsl:264-295) over a ray batch. This is a *second,
//     independent* oracle for the JAX and NumPy implementations: same math,
//     third language, no shared code.
//
// Exposed with a plain C ABI and loaded via ctypes (no pybind11 in the
// image). Build: `make -C native`.

#include <zlib.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- PNG IO

static void put_be32(std::vector<unsigned char>& out, uint32_t v) {
  out.push_back((v >> 24) & 0xff);
  out.push_back((v >> 16) & 0xff);
  out.push_back((v >> 8) & 0xff);
  out.push_back(v & 0xff);
}

static void put_chunk(std::vector<unsigned char>& out, const char tag[4],
                      const unsigned char* data, size_t n) {
  put_be32(out, (uint32_t)n);
  size_t start = out.size();
  out.insert(out.end(), tag, tag + 4);
  out.insert(out.end(), data, data + n);
  uint32_t crc = crc32(0L, out.data() + start, (uInt)(n + 4));
  put_be32(out, crc);
}

// rgb: 8-bit interleaved, top-down, w*h*3 bytes. Returns 0 on success.
int kpt_write_png(const char* path, int32_t w, int32_t h,
                  const unsigned char* rgb) {
  // Filter-prefixed scanlines.
  std::vector<unsigned char> raw((size_t)h * (1 + (size_t)w * 3));
  for (int y = 0; y < h; y++) {
    unsigned char* row = raw.data() + (size_t)y * (1 + (size_t)w * 3);
    row[0] = 0;  // filter: none
    memcpy(row + 1, rgb + (size_t)y * w * 3, (size_t)w * 3);
  }
  uLongf bound = compressBound((uLong)raw.size());
  std::vector<unsigned char> z(bound);
  if (compress2(z.data(), &bound, raw.data(), (uLong)raw.size(), 6) != Z_OK)
    return 1;

  std::vector<unsigned char> out;
  static const unsigned char sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  out.insert(out.end(), sig, sig + 8);
  unsigned char ihdr[13];
  ihdr[0] = (w >> 24) & 0xff; ihdr[1] = (w >> 16) & 0xff;
  ihdr[2] = (w >> 8) & 0xff;  ihdr[3] = w & 0xff;
  ihdr[4] = (h >> 24) & 0xff; ihdr[5] = (h >> 16) & 0xff;
  ihdr[6] = (h >> 8) & 0xff;  ihdr[7] = h & 0xff;
  ihdr[8] = 8;   // bit depth
  ihdr[9] = 2;   // color type: RGB
  ihdr[10] = ihdr[11] = ihdr[12] = 0;
  put_chunk(out, "IHDR", ihdr, 13);
  put_chunk(out, "IDAT", z.data(), bound);
  put_chunk(out, "IEND", nullptr, 0);

  FILE* f = fopen(path, "wb");
  if (!f) return 2;
  size_t n = fwrite(out.data(), 1, out.size(), f);
  fclose(f);
  return n == out.size() ? 0 : 3;
}

// ------------------------------------------------- CPU reference march

// Scene layout mirrors scene/types.py: planes f32[P][4] (n,d),
// spheres f32[S][4] (c,r), boxes f32[B][7] (c,half,round), with int32 object
// IDs per primitive. Semantics follow common.glsl:199-295 exactly.

struct V3 { float x, y, z; };
static inline V3 v3(const float* p) { return {p[0], p[1], p[2]}; }
static inline V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
static inline V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
static inline V3 scale(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
static inline float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

static const float KPT_EPS = 1e-3f;
static const float KPT_ZFAR = 50.0f;

// sdBox (common.glsl:215-218).
static inline float sd_box(V3 p, V3 half) {
  V3 d = {fabsf(p.x) - half.x, fabsf(p.y) - half.y, fabsf(p.z) - half.z};
  V3 dm = {std::max(d.x, 0.f), std::max(d.y, 0.f), std::max(d.z, 0.f)};
  float outside = sqrtf(dot(dm, dm));
  float inside = std::min(std::max(d.x, std::max(d.y, d.z)), 0.f);
  return inside + outside;
}

struct SceneRef {
  const float* planes; const int32_t* plane_ids; int32_t n_planes;
  const float* spheres; const int32_t* sphere_ids; int32_t n_spheres;
  const float* boxes; const int32_t* box_ids; int32_t n_boxes;
};

// Scene distance with self-exclusion: the sdMin chain of common.glsl:264-273
// (later primitive wins ties via `<`).
static inline void scene_sdf(const SceneRef& s, V3 p, int32_t excl,
                             float* out_d, int32_t* out_id) {
  float d = KPT_ZFAR;
  int32_t id = 0;
  for (int i = 0; i < s.n_planes; i++) {
    if (s.plane_ids[i] == excl) continue;
    const float* pl = s.planes + 4 * i;
    float di = dot(p, v3(pl)) + pl[3];
    if (di <= d) { d = di; id = s.plane_ids[i]; }
  }
  for (int i = 0; i < s.n_spheres; i++) {
    if (s.sphere_ids[i] == excl) continue;
    const float* sp = s.spheres + 4 * i;
    V3 q = sub(p, v3(sp));
    float di = sqrtf(dot(q, q)) - sp[3];
    if (di <= d) { d = di; id = s.sphere_ids[i]; }
  }
  for (int i = 0; i < s.n_boxes; i++) {
    if (s.box_ids[i] == excl) continue;
    const float* bx = s.boxes + 7 * i;
    V3 q = sub(p, v3(bx));
    float di = sd_box(q, v3(bx + 3)) - bx[6];
    if (di <= d) { d = di; id = s.box_ids[i]; }
  }
  *out_d = d;
  *out_id = id;
}

// Sphere trace one ray (common.glsl:283-295).
static inline void march_one(const SceneRef& s, V3 ro, V3 rd, int32_t excl,
                             int32_t steps, float* out_t, int32_t* out_id) {
  float t = 0.f;
  for (int32_t i = 0; i < steps; i++) {
    float d; int32_t id;
    scene_sdf(s, add(ro, scale(rd, t)), excl, &d, &id);
    if (d < KPT_EPS) { *out_t = t; *out_id = id; return; }
    t += d;
    if (t > KPT_ZFAR) break;
  }
  *out_t = KPT_ZFAR;
  *out_id = 0;
}

// Batch march over n rays, multithreaded. ro/rd: f32[n][3]; excl: int32[n]
// (-1 = none); out_t: f32[n]; out_id: int32[n].
void kpt_march(const float* planes, const int32_t* plane_ids, int32_t n_planes,
               const float* spheres, const int32_t* sphere_ids, int32_t n_spheres,
               const float* boxes, const int32_t* box_ids, int32_t n_boxes,
               const float* ro, const float* rd, const int32_t* excl,
               int64_t n, int32_t steps, float* out_t, int32_t* out_id) {
  SceneRef s = {planes, plane_ids, n_planes,
                spheres, sphere_ids, n_spheres,
                boxes, box_ids, n_boxes};
  int nthreads = (int)std::max(1u, std::thread::hardware_concurrency());
  if (n < 4096) nthreads = 1;
  std::vector<std::thread> threads;
  int64_t chunk = (n + nthreads - 1) / nthreads;
  for (int ti = 0; ti < nthreads; ti++) {
    int64_t lo = ti * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back([&, lo, hi]() {
      for (int64_t i = lo; i < hi; i++) {
        march_one(s, v3(ro + 3 * i), v3(rd + 3 * i),
                  excl ? excl[i] : -1, steps, out_t + i, out_id + i);
      }
    });
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
