// Software triangle rasterizer for eval-video rendering.
//
// Native replacement for the reference's OSMesa/EGL GL stack
// (/root/reference/main.py:261,308 renders through mujoco.Renderer, which
// needs a GL context that headless TPU hosts lack). This is a flat-shaded
// z-buffered rasterizer: the Python side tessellates geoms once, transforms
// vertices into world space per frame, and calls btt_raster per frame.
//
// Threading: the screen is split into horizontal bands; every thread walks
// all triangles but only writes rows it owns, so no synchronization is
// needed on the color/depth buffers.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread rasterizer.cc -o librasterizer.so

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Vec3 {
  float x, y, z;
};

inline Vec3 sub(const Vec3& a, const Vec3& b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline Vec3 cross(const Vec3& a, const Vec3& b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
inline float dot(const Vec3& a, const Vec3& b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
inline Vec3 normalize(const Vec3& a) {
  float n = std::sqrt(dot(a, a));
  if (n < 1e-20f) return {0.f, 0.f, 1.f};
  return {a.x / n, a.y / n, a.z / n};
}

struct Vec4 {
  float x, y, z, w;
};

inline Vec4 mat_mul_point(const float* m, const Vec3& p) {
  // m: 4x4 row-major; p treated as [x y z 1]
  return {m[0] * p.x + m[1] * p.y + m[2] * p.z + m[3],
          m[4] * p.x + m[5] * p.y + m[6] * p.z + m[7],
          m[8] * p.x + m[9] * p.y + m[10] * p.z + m[11],
          m[12] * p.x + m[13] * p.y + m[14] * p.z + m[15]};
}

// Pre-projected triangle ready for scan conversion.
struct ScreenTri {
  float x0, y0, z0, x1, y1, z1, x2, y2, z2;  // screen x,y + ndc z
  int ymin, ymax;                             // inclusive row range
  uint8_t r, g, b;
};

void raster_band(const std::vector<ScreenTri>& tris, int W, int H, int y_lo, int y_hi,
                 float* depth, uint8_t* rgb) {
  for (const ScreenTri& t : tris) {
    int ys = std::max(t.ymin, y_lo);
    int ye = std::min(t.ymax, y_hi - 1);
    if (ys > ye) continue;
    float ax = t.x0, ay = t.y0, bx = t.x1, by = t.y1, cx = t.x2, cy = t.y2;
    float area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax);
    if (std::fabs(area) < 1e-9f) continue;
    float inv_area = 1.0f / area;
    int xmin = std::max(0, (int)std::floor(std::min({ax, bx, cx})));
    int xmax = std::min(W - 1, (int)std::ceil(std::max({ax, bx, cx})));
    for (int y = ys; y <= ye; ++y) {
      float py = y + 0.5f;
      for (int x = xmin; x <= xmax; ++x) {
        float px = x + 0.5f;
        float w0 = ((bx - px) * (cy - py) - (by - py) * (cx - px)) * inv_area;
        float w1 = ((cx - px) * (ay - py) - (cy - py) * (ax - px)) * inv_area;
        float w2 = 1.0f - w0 - w1;
        if (w0 < 0.f || w1 < 0.f || w2 < 0.f) continue;
        float z = w0 * t.z0 + w1 * t.z1 + w2 * t.z2;
        size_t di = (size_t)y * W + x;
        if (z < depth[di]) {
          depth[di] = z;
          size_t pi = di * 3;
          rgb[pi] = t.r;
          rgb[pi + 1] = t.g;
          rgb[pi + 2] = t.b;
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// verts: ntri*9 world-space triangle vertices (v0 v1 v2 per tri)
// colors: ntri*3 base colors in [0,1]
// viewproj: 4x4 row-major clip = VP [x y z 1]^T
// light_dir: world-space direction TOWARD the light (normalized by caller)
// bg: background color [0,1] x3
// out: H*W*3 uint8
void btt_raster(const float* verts, const float* colors, int ntri, const float* viewproj,
                const float* light_dir, float ambient, int W, int H, const float* bg,
                uint8_t* out) {
  std::vector<float> depth((size_t)W * H, 1e30f);
  uint8_t bg_r = (uint8_t)(std::clamp(bg[0], 0.f, 1.f) * 255.f);
  uint8_t bg_g = (uint8_t)(std::clamp(bg[1], 0.f, 1.f) * 255.f);
  uint8_t bg_b = (uint8_t)(std::clamp(bg[2], 0.f, 1.f) * 255.f);
  for (size_t i = 0; i < (size_t)W * H; ++i) {
    out[i * 3] = bg_r;
    out[i * 3 + 1] = bg_g;
    out[i * 3 + 2] = bg_b;
  }

  Vec3 L = {light_dir[0], light_dir[1], light_dir[2]};

  // Project + shade all triangles once (serial; cheap vs scan conversion).
  std::vector<ScreenTri> tris;
  tris.reserve(ntri);
  for (int i = 0; i < ntri; ++i) {
    const float* v = verts + (size_t)i * 9;
    Vec3 p0{v[0], v[1], v[2]}, p1{v[3], v[4], v[5]}, p2{v[6], v[7], v[8]};
    Vec4 clip[3] = {mat_mul_point(viewproj, p0), mat_mul_point(viewproj, p1),
                    mat_mul_point(viewproj, p2)};
    // Sutherland-Hodgman clip against the near plane w >= eps (large floor
    // triangles routinely span the plane behind the camera)
    const float eps = 1e-3f;
    Vec4 poly[4];
    int npoly = 0;
    for (int k = 0; k < 3; ++k) {
      const Vec4& a = clip[k];
      const Vec4& b = clip[(k + 1) % 3];
      bool ain = a.w >= eps, bin = b.w >= eps;
      if (ain) poly[npoly++] = a;
      if (ain != bin) {
        float s = (eps - a.w) / (b.w - a.w);
        poly[npoly++] = {a.x + s * (b.x - a.x), a.y + s * (b.y - a.y),
                         a.z + s * (b.z - a.z), eps};
      }
    }
    if (npoly < 3) continue;

    // two-sided flat Lambert in world space (shared by the clipped fan)
    Vec3 n = normalize(cross(sub(p1, p0), sub(p2, p0)));
    float lam = std::fabs(dot(n, L));
    float shade = ambient + (1.0f - ambient) * lam;
    const float* col = colors + (size_t)i * 3;
    uint8_t r = (uint8_t)(std::clamp(col[0] * shade, 0.f, 1.f) * 255.f);
    uint8_t g = (uint8_t)(std::clamp(col[1] * shade, 0.f, 1.f) * 255.f);
    uint8_t b8 = (uint8_t)(std::clamp(col[2] * shade, 0.f, 1.f) * 255.f);

    float sx[4], sy[4], sz[4];
    for (int k = 0; k < npoly; ++k) {
      sx[k] = (poly[k].x / poly[k].w * 0.5f + 0.5f) * W;
      sy[k] = (0.5f - poly[k].y / poly[k].w * 0.5f) * H;
      sz[k] = poly[k].z / poly[k].w;
    }
    for (int k = 2; k < npoly; ++k) {  // fan triangulation
      ScreenTri t;
      t.x0 = sx[0]; t.y0 = sy[0]; t.z0 = sz[0];
      t.x1 = sx[k - 1]; t.y1 = sy[k - 1]; t.z1 = sz[k - 1];
      t.x2 = sx[k]; t.y2 = sy[k]; t.z2 = sz[k];
      if ((t.x0 < 0 && t.x1 < 0 && t.x2 < 0) ||
          (t.x0 >= W && t.x1 >= W && t.x2 >= W) ||
          (t.y0 < 0 && t.y1 < 0 && t.y2 < 0) ||
          (t.y0 >= H && t.y1 >= H && t.y2 >= H))
        continue;
      t.ymin = std::max(0, (int)std::floor(std::min({t.y0, t.y1, t.y2})));
      t.ymax = std::min(H - 1, (int)std::ceil(std::max({t.y0, t.y1, t.y2})));
      if (t.ymin > t.ymax) continue;
      t.r = r; t.g = g; t.b = b8;
      tris.push_back(t);
    }
  }

  int n_threads = (int)std::thread::hardware_concurrency();
  n_threads = std::max(1, std::min(n_threads, H / 16 + 1));
  if (n_threads == 1) {
    raster_band(tris, W, H, 0, H, depth.data(), out);
    return;
  }
  std::vector<std::thread> workers;
  int band = (H + n_threads - 1) / n_threads;
  for (int k = 0; k < n_threads; ++k) {
    int y_lo = k * band, y_hi = std::min(H, (k + 1) * band);
    if (y_lo >= y_hi) break;
    workers.emplace_back(raster_band, std::cref(tris), W, H, y_lo, y_hi, depth.data(), out);
  }
  for (auto& w : workers) w.join();
}

}  // extern "C"
