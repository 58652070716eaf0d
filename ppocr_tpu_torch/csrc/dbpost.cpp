// dbpost: the host half of the DB text-detection postprocess.
//
// A C++17 implementation, with no dependency, of what the reference does
// with postprocess_op.cpp, OpenCV and the vendored Clipper: border following
// on the binary map, polygon scanline scoring, min-area rectangles by
// rotating calipers, and closed-form round-join polygon offsetting
// ("unclip"). A copy of native/dbpost.cpp of the JAX package; in this
// package it is the only backend of ops/db_postprocess.py (the machines that
// serve the port need not have OpenCV).
//
// Exposed as a C ABI for ctypes. ops/native.py builds it at first use with
// the host compiler (-O3 -fPIC -std=c++17 -shared) into _build/ and loads it.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Pt {
  float x, y;
};

// ---------------------------------------------------------------------------
// Border following (Suzuki-Abe style, outer borders only — the equivalent of
// cv::findContours(RETR_LIST) for our use: every connected component's outer
// boundary, 8-connectivity).

struct Contour {
  std::vector<int> xs, ys;  // boundary pixel coordinates
};

// Moore neighborhood, clockwise starting from W.
static const int DX[8] = {-1, -1, 0, 1, 1, 1, 0, -1};
static const int DY[8] = {0, -1, -1, -1, 0, 1, 1, 1};

void follow_border(const uint8_t* bmp, int w, int h, int sx, int sy,
                   int backtrack, Contour& out) {
  // Moore boundary tracing with backtracking (Jacob stopping criterion).
  // ``backtrack`` points at the known-outside neighbor of the start pixel:
  // 0 (W) for outer borders entered from the west raster scan, 6 (S) for
  // hole borders entered from the foreground pixel above the hole.
  int cx = sx, cy = sy;
  out.xs.push_back(cx);
  out.ys.push_back(cy);

  int startx = cx, starty = cy, startdir = -1;
  for (int step = 0; step < w * h * 4; ++step) {
    bool found = false;
    for (int i = 0; i < 8; ++i) {
      int d = (backtrack + 1 + i) % 8;
      int nx = cx + DX[d], ny = cy + DY[d];
      if (nx >= 0 && nx < w && ny >= 0 && ny < h && bmp[ny * w + nx]) {
        // found next boundary pixel
        if (startdir < 0) startdir = d;
        else if (cx == startx && cy == starty && d == startdir) return;
        cx = nx;
        cy = ny;
        out.xs.push_back(cx);
        out.ys.push_back(cy);
        // new backtrack: direction from new pixel back toward the pixel we
        // came from, rotated to resume the scan just past it
        backtrack = (d + 4) % 8;
        found = true;
        break;
      }
    }
    if (!found) return;  // isolated pixel
  }
}

void find_contours(const uint8_t* bmp, int w, int h, int max_contours,
                   std::vector<Contour>& contours) {
  // cv::findContours(RETR_LIST) yields BOTH outer blob borders and hole
  // borders; the hole border traced here is the FOREGROUND ring around
  // the hole (exactly what OpenCV emits — scoring those high-probability
  // pixels matters for threshold parity).
  std::vector<int32_t> comp(static_cast<size_t>(w) * h, 0);
  std::vector<int> stack;
  struct Anchored {
    int anchor;
    Contour c;
  };
  std::vector<Anchored> found;

  // foreground components (8-conn): outer borders. Trace ALL components —
  // the max_contours cap applies AFTER sorting into cv2's bottom-up
  // emission order below, so both backends keep the same subset.
  int next = 0;
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      if (!bmp[y * w + x] || comp[y * w + x]) continue;
      ++next;
      found.push_back({y * w + x, {}});
      follow_border(bmp, w, h, x, y, /*backtrack=*/0, found.back().c);
      stack.clear();
      stack.push_back(y * w + x);
      comp[y * w + x] = next;
      while (!stack.empty()) {
        int p = stack.back();
        stack.pop_back();
        int py = p / w, px = p % w;
        for (int d = 0; d < 8; ++d) {
          int nx = px + DX[d], ny = py + DY[d];
          if (nx >= 0 && nx < w && ny >= 0 && ny < h) {
            int q = ny * w + nx;
            if (bmp[q] && !comp[q]) {
              comp[q] = next;
              stack.push_back(q);
            }
          }
        }
      }
    }
  }

  // background: flood 4-conn from the image border = outside; remaining
  // background components are holes (8-conn foreground ⇒ 4-conn holes)
  std::vector<uint8_t> outside(static_cast<size_t>(w) * h, 0);
  stack.clear();
  for (int x = 0; x < w; ++x) {
    for (int y : {0, h - 1}) {
      if (!bmp[y * w + x] && !outside[y * w + x]) {
        outside[y * w + x] = 1;
        stack.push_back(y * w + x);
      }
    }
  }
  for (int y = 0; y < h; ++y) {
    for (int x : {0, w - 1}) {
      if (!bmp[y * w + x] && !outside[y * w + x]) {
        outside[y * w + x] = 1;
        stack.push_back(y * w + x);
      }
    }
  }
  static const int DX4[4] = {-1, 1, 0, 0};
  static const int DY4[4] = {0, 0, -1, 1};
  while (!stack.empty()) {
    int p = stack.back();
    stack.pop_back();
    int py = p / w, px = p % w;
    for (int d = 0; d < 4; ++d) {
      int nx = px + DX4[d], ny = py + DY4[d];
      if (nx >= 0 && nx < w && ny >= 0 && ny < h) {
        int q = ny * w + nx;
        if (!bmp[q] && !outside[q]) {
          outside[q] = 1;
          stack.push_back(q);
        }
      }
    }
  }
  // Hole borders, Suzuki-style: the border consists of FOREGROUND pixels
  // ringing the hole (what cv::findContours emits — scoring those high-
  // probability pixels matters for threshold parity). For each hole,
  // Moore-trace the fg inner border starting from the pixel directly
  // above the hole's raster-first bg pixel.
  std::vector<int32_t> hole_comp(static_cast<size_t>(w) * h, 0);
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      int p = y * w + x;
      if (bmp[p] || outside[p] || hole_comp[p]) continue;
      ++next;
      // fill this hole component. 4-conn: with 8-conn FOREGROUND, the
      // complementary background/hole connectivity is 4-conn — an 8-conn
      // fill would merge diagonally-touching holes cv2 keeps separate.
      stack.clear();
      stack.push_back(p);
      hole_comp[p] = next;
      while (!stack.empty()) {
        int q = stack.back();
        stack.pop_back();
        int qy = q / w, qx = q % w;
        for (int d = 0; d < 4; ++d) {
          int nx = qx + DX4[d], ny = qy + DY4[d];
          if (nx >= 0 && nx < w && ny >= 0 && ny < h) {
            int r = ny * w + nx;
            if (!bmp[r] && !outside[r] && !hole_comp[r]) {
              hole_comp[r] = next;
              stack.push_back(r);
            }
          }
        }
      }
      if (y == 0) continue;
      int sx = x, sy = y - 1;  // fg pixel above the hole anchor
      if (!bmp[sy * w + sx]) continue;
      found.push_back({p, {}});
      // Moore trace the fg ring around the hole: backtrack initially
      // points S (into the hole), so the scan hugs the hole boundary.
      follow_border(bmp, w, h, sx, sy, /*backtrack=*/6, found.back().c);
    }
  }

  // cv2.findContours emits borders in REVERSE raster order of their start
  // pixel (bottom-up); sorting before the cap means both backends keep
  // the same first-max_contours subset.
  std::sort(found.begin(), found.end(),
            [](const Anchored& a, const Anchored& b) {
              return a.anchor > b.anchor;
            });
  if ((int)found.size() > max_contours) found.resize(max_contours);
  for (auto& f : found) contours.push_back(std::move(f.c));
}

// ---------------------------------------------------------------------------
// Convex hull (Andrew monotone chain) + rotating calipers min-area rect.

float cross(const Pt& o, const Pt& a, const Pt& b) {
  return (a.x - o.x) * (b.y - o.y) - (a.y - o.y) * (b.x - o.x);
}

std::vector<Pt> convex_hull(std::vector<Pt> pts) {
  std::sort(pts.begin(), pts.end(), [](const Pt& a, const Pt& b) {
    return a.x < b.x || (a.x == b.x && a.y < b.y);
  });
  pts.erase(std::unique(pts.begin(), pts.end(),
                        [](const Pt& a, const Pt& b) {
                          return a.x == b.x && a.y == b.y;
                        }),
            pts.end());
  int n = static_cast<int>(pts.size());
  if (n <= 2) return pts;
  std::vector<Pt> hull(2 * n);
  int k = 0;
  for (int i = 0; i < n; ++i) {
    while (k >= 2 && cross(hull[k - 2], hull[k - 1], pts[i]) <= 0) --k;
    hull[k++] = pts[i];
  }
  int lower = k + 1;
  for (int i = n - 2; i >= 0; --i) {
    while (k >= lower && cross(hull[k - 2], hull[k - 1], pts[i]) <= 0) --k;
    hull[k++] = pts[i];
  }
  hull.resize(k - 1);
  return hull;
}

struct RotRect {
  float cx, cy, w, h;
  // unit direction of the "w" edge. Kept as the vector the calipers found
  // and not as an angle: cos and sin of a float angle turn the corners of
  // an axis-aligned rect into 10.999999 instead of 11, and the unclip step
  // truncates them.
  float ex, ey;
};

RotRect min_area_rect(const std::vector<Pt>& points) {
  std::vector<Pt> hull = convex_hull(points);
  int n = static_cast<int>(hull.size());
  if (n == 0) return {0, 0, 0, 0, 1, 0};
  if (n == 1) return {hull[0].x, hull[0].y, 0, 0, 1, 0};
  if (n == 2) {
    float dx = hull[1].x - hull[0].x, dy = hull[1].y - hull[0].y;
    float len = std::hypot(dx, dy);
    return {(hull[0].x + hull[1].x) / 2, (hull[0].y + hull[1].y) / 2,
            len, 0.0f, dx / len, dy / len};
  }
  float best_area = 1e30f;
  RotRect best{0, 0, 0, 0, 1, 0};
  for (int i = 0; i < n; ++i) {
    const Pt& a = hull[i];
    const Pt& b = hull[(i + 1) % n];
    float ex = b.x - a.x, ey = b.y - a.y;
    float len = std::hypot(ex, ey);
    if (len < 1e-12f) continue;
    ex /= len;
    ey /= len;
    float minu = 1e30f, maxu = -1e30f, minv = 1e30f, maxv = -1e30f;
    for (const Pt& p : hull) {
      float u = (p.x - a.x) * ex + (p.y - a.y) * ey;
      float v = -(p.x - a.x) * ey + (p.y - a.y) * ex;
      minu = std::min(minu, u);
      maxu = std::max(maxu, u);
      minv = std::min(minv, v);
      maxv = std::max(maxv, v);
    }
    float area = (maxu - minu) * (maxv - minv);
    if (area < best_area) {
      best_area = area;
      float cu = (minu + maxu) / 2, cv = (minv + maxv) / 2;
      best.cx = a.x + cu * ex - cv * ey;
      best.cy = a.y + cu * ey + cv * ex;
      best.w = maxu - minu;
      best.h = maxv - minv;
      best.ex = ex;
      best.ey = ey;
    }
  }
  return best;
}

void rect_points(const RotRect& r, Pt out[4]) {
  float c = r.ex, s = r.ey;
  float hw = r.w / 2, hh = r.h / 2;
  const float du[4] = {-hw, hw, hw, -hw};
  const float dv[4] = {-hh, -hh, hh, hh};
  for (int i = 0; i < 4; ++i) {
    out[i].x = r.cx + du[i] * c - dv[i] * s;
    out[i].y = r.cy + du[i] * s + dv[i] * c;
  }
}

// GetMiniBoxes ordering (postprocess_op.cpp:134-168): sort 4 pts by x
// (stable), order within left/right pairs by y. ssid = max(w, h).
void order_mini_box(Pt pts[4]) {
  std::stable_sort(pts, pts + 4,
                   [](const Pt& a, const Pt& b) { return a.x < b.x; });
  Pt p0 = pts[0], p1 = pts[1], p2 = pts[2], p3 = pts[3];
  Pt i1 = (p1.y <= p0.y) ? p1 : p0;
  Pt i4 = (p1.y <= p0.y) ? p0 : p1;
  Pt i2 = (p3.y <= p2.y) ? p3 : p2;
  Pt i3 = (p3.y <= p2.y) ? p2 : p3;
  pts[0] = i1;
  pts[1] = i2;
  pts[2] = i3;
  pts[3] = i4;
}

// ---------------------------------------------------------------------------
// Scoring: mean of `pred` inside a polygon (scanline fill — the fillPoly +
// cv::mean(pred, mask) of postprocess_op.cpp:170-253).

float polygon_mean(const float* pred, int w, int h, const Pt* poly, int n) {
  // cv::fillPoly draws the (integer-vertex) boundary AND fills the
  // interior; on the small quads DB scores, the boundary pixels matter.
  // We rasterize the same way: Bresenham edges into a local mask, then an
  // even-odd scanline fill at pixel centers. Vertices are int-truncated
  // exactly like the reference's mask construction
  // (postprocess_op.cpp:199-201, 239-242).
  std::vector<int> vx(n), vy(n);
  int minx = 1 << 30, maxx = -(1 << 30), miny = 1 << 30, maxy = -(1 << 30);
  for (int i = 0; i < n; ++i) {
    vx[i] = (int)poly[i].x;
    vy[i] = (int)poly[i].y;
    minx = std::min(minx, vx[i]);
    maxx = std::max(maxx, vx[i]);
    miny = std::min(miny, vy[i]);
    maxy = std::max(maxy, vy[i]);
  }
  // reference bbox clamp (floor/ceil then clamp to [0, dim-1])
  int x0 = std::max(0, std::min(w - 1, minx));
  int x1 = std::max(0, std::min(w - 1, maxx));
  int y0 = std::max(0, std::min(h - 1, miny));
  int y1 = std::max(0, std::min(h - 1, maxy));
  int mw = x1 - x0 + 1, mh = y1 - y0 + 1;
  if (mw <= 0 || mh <= 0) return 0.0f;
  std::vector<uint8_t> mask((size_t)mw * mh, 0);

  auto plot = [&](int x, int y) {
    if (x >= x0 && x <= x1 && y >= y0 && y <= y1)
      mask[(size_t)(y - y0) * mw + (x - x0)] = 1;
  };
  for (int i = 0; i < n; ++i) {
    int ax = vx[i], ay = vy[i], bx = vx[(i + 1) % n], by = vy[(i + 1) % n];
    int dx = std::abs(bx - ax), sx = ax < bx ? 1 : -1;
    int dy = -std::abs(by - ay), sy = ay < by ? 1 : -1;
    int err = dx + dy;
    while (true) {
      plot(ax, ay);
      if (ax == bx && ay == by) break;
      int e2 = 2 * err;
      if (e2 >= dy) {
        err += dy;
        ax += sx;
      }
      if (e2 <= dx) {
        err += dx;
        ay += sy;
      }
    }
  }
  std::vector<float> xs;
  for (int y = y0; y <= y1; ++y) {
    float fy = (float)y + 0.5f;
    xs.clear();
    for (int i = 0; i < n; ++i) {
      float ax = (float)vx[i], ay = (float)vy[i];
      float bx = (float)vx[(i + 1) % n], by = (float)vy[(i + 1) % n];
      if ((ay <= fy && by > fy) || (by <= fy && ay > fy)) {
        xs.push_back(ax + (fy - ay) / (by - ay) * (bx - ax));
      }
    }
    std::sort(xs.begin(), xs.end());
    for (size_t i = 0; i + 1 < xs.size(); i += 2) {
      int sx = std::max(x0, (int)std::ceil(xs[i] - 0.5f));
      int ex = std::min(x1, (int)std::floor(xs[i + 1] - 0.5f));
      for (int x = sx; x <= ex; ++x)
        mask[(size_t)(y - y0) * mw + (x - x0)] = 1;
    }
  }
  double sum = 0.0;
  long count = 0;
  for (int y = y0; y <= y1; ++y)
    for (int x = x0; x <= x1; ++x)
      if (mask[(size_t)(y - y0) * mw + (x - x0)]) {
        sum += pred[y * w + x];
        ++count;
      }
  return count ? (float)(sum / count) : 0.0f;
}

}  // namespace

extern "C" {

// boxes_from_bitmap:
//   pred   float32 [h*w]  probability map
//   bitmap uint8   [h*w]  binarized map (0/255 or 0/1)
//   min_size  a box is kept when max(w, h) of its min-area rect is
//             >= min_size, and of its unclipped rect >= min_size + 2
//             (postprocess_op.cpp's 3 and 5 when min_size is 3)
//   out_boxes int32 [max_boxes*8]  (x0,y0,...,x3,y3 per box)
//   out_scores float32 [max_boxes]
// returns number of boxes written.
int dbpost_boxes_from_bitmap(const float* pred, const uint8_t* bitmap, int w,
                             int h, float box_thresh, float unclip_ratio,
                             int use_slow_score, int max_candidates,
                             int min_size, int32_t* out_boxes,
                             float* out_scores, int max_boxes) {
  std::vector<Contour> contours;
  find_contours(bitmap, w, h, max_candidates, contours);

  int n_out = 0;
  for (const Contour& c : contours) {
    if (n_out >= max_boxes) break;
    if (c.xs.size() <= 2) continue;

    // Degenerate straight-line blobs: cv::findContours with
    // CHAIN_APPROX_SIMPLE compresses EXACTLY horizontal/vertical/45°
    // 1-px lines to ≤2 points and the reference drops those
    // (postprocess_op.cpp:277). Other thin diagonals (e.g. slope-1/2
    // staircases) keep their corner points in cv2 and survive — a plain
    // "min rect dim < 1" rule over-rejected them.
    bool h_line = true, v_line = true, d1_line = true, d2_line = true;
    for (size_t i = 1; i < c.xs.size(); ++i) {
      if (c.ys[i] != c.ys[0]) h_line = false;
      if (c.xs[i] != c.xs[0]) v_line = false;
      if (c.xs[i] - c.ys[i] != c.xs[0] - c.ys[0]) d1_line = false;
      if (c.xs[i] + c.ys[i] != c.xs[0] + c.ys[0]) d2_line = false;
    }
    if (h_line || v_line || d1_line || d2_line) continue;

    std::vector<Pt> pts(c.xs.size());
    for (size_t i = 0; i < c.xs.size(); ++i)
      pts[i] = {(float)c.xs[i], (float)c.ys[i]};
    RotRect rect = min_area_rect(pts);
    // cv::minAreaRect over integer pixel coords treats each point as a
    // lattice point; ssid check uses max(w, h) like the reference
    float ssid = std::max(rect.w, rect.h);
    if (ssid < (float)min_size) continue;

    Pt box[4];
    rect_points(rect, box);
    order_mini_box(box);

    float score;
    if (use_slow_score) {
      score = polygon_mean(pred, w, h, pts.data(), (int)pts.size());
    } else {
      score = polygon_mean(pred, w, h, box, 4);
    }
    if (score < box_thresh) continue;

    // unclip: distance = area * ratio / perimeter; round-join offset of a
    // rotated rect + re-minAreaRect == the rect expanded by 2d per side
    float area = 0, perim = 0;
    for (int i = 0; i < 4; ++i) {
      const Pt& a = box[i];
      const Pt& b = box[(i + 1) % 4];
      area += a.x * b.y - a.y * b.x;
      perim += std::hypot(a.x - b.x, a.y - b.y);
    }
    area = std::fabs(area / 2.0f);
    if (perim <= 0) continue;
    float dist = area * unclip_ratio / perim;

    // ClipperLib::Path construction int-TRUNCATES the quad corners before
    // offsetting (postprocess_op.cpp:48-51; ops/db_postprocess.unclip_rect
    // mirrors it with np.trunc + minAreaRect) — expanding the float rect
    // directly shifted corners up to 2 px vs the cv2 backend
    std::vector<Pt> tq(4);
    float tarea = 0;
    for (int i = 0; i < 4; ++i)
      tq[i] = {std::trunc(box[i].x), std::trunc(box[i].y)};
    for (int i = 0; i < 4; ++i) {
      const Pt& a = tq[i];
      const Pt& b = tq[(i + 1) % 4];
      tarea += a.x * b.y - a.y * b.x;
    }
    if (std::fabs(tarea / 2.0f) <= 0) continue;  // Clipper empty-solution
    RotRect expanded = min_area_rect(tq);
    expanded.w += 2 * dist;
    expanded.h += 2 * dist;
    if (expanded.w < 1.001f && expanded.h < 1.001f) continue;
    float ssid2 = std::max(expanded.w, expanded.h);
    if (ssid2 < (float)(min_size + 2)) continue;

    Pt ebox[4];
    rect_points(expanded, ebox);
    order_mini_box(ebox);
    for (int i = 0; i < 4; ++i) {
      // the reference rescales from the bitmap's to the map's size before
      // it rounds (postprocess_op.cpp:319). The two sizes are equal here,
      // but x / w * w in float is not always x: a corner at 33.5 can come
      // back as 33.499996 and round down, and parity wants the same.
      float x = std::round(ebox[i].x / (float)w * (float)w);
      float y = std::round(ebox[i].y / (float)h * (float)h);
      out_boxes[n_out * 8 + i * 2 + 0] =
          (int32_t)std::max(0.0f, std::min((float)w, x));
      out_boxes[n_out * 8 + i * 2 + 1] =
          (int32_t)std::max(0.0f, std::min((float)h, y));
    }
    out_scores[n_out] = score;
    ++n_out;
  }
  return n_out;
}

// Standalone min-area rect for testing: points float32 [n*2] → out
// (cx, cy, w, h, angle_rad).
void dbpost_min_area_rect(const float* points, int n, float* out5) {
  std::vector<Pt> pts(n);
  for (int i = 0; i < n; ++i) pts[i] = {points[2 * i], points[2 * i + 1]};
  RotRect r = min_area_rect(pts);
  out5[0] = r.cx;
  out5[1] = r.cy;
  out5[2] = r.w;
  out5[3] = r.h;
  out5[4] = std::atan2(r.ey, r.ex);
}

int dbpost_version() { return 1; }

}  // extern "C"
