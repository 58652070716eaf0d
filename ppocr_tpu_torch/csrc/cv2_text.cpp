// Text drawn as OpenCV 5.0.0's cv::putText draws it with its built-in
// upright face, "Rubik for OpenCV Light" (a variable TrueType font that cv2
// embeds), bit for bit. Host code of the port's synthetic training data
// (train/cv2_text.py): the digit datasets and render_line.
//
// cv2 5.0 maps FONT_HERSHEY_* to a TrueType face, a pixel size and a
// weight (hersheyToTruetype), and draws with its copy of stb_truetype
// (v2 rasteriser), extended with TrueType variations. What it does, and
// what this file replays, in order:
//
//   glyph outlines  The varied outline of each glyph at each weight cv2
//                   selects is made by scripts/make_cv2_text_assets_torch.py
//                   and committed (assets/cv2_text.npz): stb's vertex list
//                   (moves, lines and quadratic curves on int16 points, the
//                   implied on-curve points at (a + b) >> 1), the glyph's
//                   box and its advance in font units. This file reads no
//                   font table.
//   scale           scale = (float)size / (float)ascent, ascent = hhea's
//                   ascender (935 for Rubik).
//   advance         (cvRound(64 * ((float)advance * scale))) >> 6 whole
//                   pixels per glyph, summed from org.x.
//   bitmap          stbtt_GetGlyphBitmapSubpixel as cv2 changed it: the box
//                   scaled (floor of the low sides, ceil of the high sides,
//                   in f32), padded on every side by
//                   max((w + 9) / 10, (h + 9) / 10) + 10 pixels, the outline
//                   flattened (flatness 0.35 px) and rasterised with stb's
//                   exact-area scanline rasteriser into that padded bitmap,
//                   shift = pad, offset = the scaled box's low corner.
//   placement       the bitmap's pixel (r, c) lands on image pixel
//                   (org.y + iy0 - pad + r, pen_x + ix0 - pad + c). A
//                   string whose org.x is at or past the image's right edge
//                   is not drawn at all (not even the ink of a mark or of a
//                   negative side bearing that would reach back into it).
//   blend           each glyph in turn, in logical order, with its alpha a:
//                   dst = (dst * (255 - a) + color * a + 127) / 255 on every
//                   channel of a 1- or 3-channel image; a 4-channel image's
//                   last channel takes a where a > 0. Pixels outside the
//                   image are skipped.
//
// Overlapping glyphs of a string therefore compose as sequential alpha
// blends, not as one rasterisation of the whole string.
//
// Float order matters here (the edges' f32 positions decide the coverage),
// so contraction is switched off: the compiler must not fuse a * b + c.

#include <algorithm>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

#pragma GCC optimize("fp-contract=off")

namespace {

enum { VMOVE = 1, VLINE = 2, VCURVE = 3 };

struct Edge {
  float x0, y0, x1, y1;
  int invert;
};

struct Active {
  Active* next;
  float fx, fdx, fdy, direction, sy, ey;
};

struct Point {
  float x, y;
};

// stbtt__handle_clipped_edge: an edge already clipped to [x, x + 1]
void handle_clipped_edge(float* scanline, int x, const Active* e, float x0, float y0, float x1, float y1) {
  if (y0 == y1) return;
  if (y0 > e->ey) return;
  if (y1 < e->sy) return;
  if (y0 < e->sy) {
    x0 += (x1 - x0) * (e->sy - y0) / (y1 - y0);
    y0 = e->sy;
  }
  if (y1 > e->ey) {
    x1 += (x1 - x0) * (e->ey - y1) / (y1 - y0);
    y1 = e->ey;
  }
  if (x0 <= x && x1 <= x)
    scanline[x] += e->direction * (y1 - y0);
  else if (x0 >= x + 1 && x1 >= x + 1)
    ;
  else
    scanline[x] += e->direction * (y1 - y0) * (1 - ((x0 - x) + (x1 - x)) / 2);
}

float sized_trapezoid_area(float height, float top_width, float bottom_width) {
  return (top_width + bottom_width) / 2.0f * height;
}

float position_trapezoid_area(float height, float tx0, float tx1, float bx0, float bx1) {
  return sized_trapezoid_area(height, tx1 - tx0, bx1 - bx0);
}

float sized_triangle_area(float height, float width) { return height * width / 2; }

// stbtt__fill_active_edges_new: the signed area each active edge covers in
// the scanline [y_top, y_top + 1]
void fill_active_edges(float* scanline, float* scanline_fill, int len, Active* e, float y_top) {
  float y_bottom = y_top + 1;
  for (; e; e = e->next) {
    if (e->fdx == 0) {
      float x0 = e->fx;
      if (x0 < len) {
        if (x0 >= 0) {
          handle_clipped_edge(scanline, (int)x0, e, x0, y_top, x0, y_bottom);
          handle_clipped_edge(scanline_fill - 1, (int)x0 + 1, e, x0, y_top, x0, y_bottom);
        } else {
          handle_clipped_edge(scanline_fill - 1, 0, e, x0, y_top, x0, y_bottom);
        }
      }
      continue;
    }
    float x0 = e->fx, dx = e->fdx, xb = x0 + dx, dy = e->fdy;
    float x_top, x_bottom, sy0, sy1;
    if (e->sy > y_top) {
      x_top = x0 + dx * (e->sy - y_top);
      sy0 = e->sy;
    } else {
      x_top = x0;
      sy0 = y_top;
    }
    if (e->ey < y_bottom) {
      x_bottom = x0 + dx * (e->ey - y_top);
      sy1 = e->ey;
    } else {
      x_bottom = xb;
      sy1 = y_bottom;
    }
    if (x_top >= 0 && x_bottom >= 0 && x_top < len && x_bottom < len) {
      if ((int)x_top == (int)x_bottom) {
        int x = (int)x_top;
        float height = (sy1 - sy0) * e->direction;
        scanline[x] += position_trapezoid_area(height, x_top, x + 1.0f, x_bottom, x + 1.0f);
        scanline_fill[x] += height;
      } else {
        if (x_top > x_bottom) {  // flip the scanline vertically: same signed area
          float t;
          sy0 = y_bottom - (sy0 - y_top);
          sy1 = y_bottom - (sy1 - y_top);
          t = sy0, sy0 = sy1, sy1 = t;
          t = x_bottom, x_bottom = x_top, x_top = t;
          dx = -dx;
          dy = -dy;
          t = x0, x0 = xb, xb = t;
        }
        int x1 = (int)x_top, x2 = (int)x_bottom;
        float y_crossing = y_top + dy * (x1 + 1 - x0);
        float y_final = y_top + dy * (x2 - x0);
        if (y_crossing > y_bottom) y_crossing = y_bottom;
        float sign = e->direction;
        float area = sign * (y_crossing - sy0);
        scanline[x1] += sized_triangle_area(area, x1 + 1 - x_top);
        if (y_final > y_bottom) {
          int denom = (x2 - (x1 + 1));
          y_final = y_bottom;
          if (denom != 0) dy = (y_final - y_crossing) / denom;
        }
        float step = sign * dy * 1;
        for (int x = x1 + 1; x < x2; ++x) {
          scanline[x] += area + step / 2;
          area += step;
        }
        scanline[x2] += area + sign * position_trapezoid_area(sy1 - y_final, (float)x2, x2 + 1.0f, x_bottom,
                                                                x2 + 1.0f);
        scanline_fill[x2] += sign * (sy1 - sy0);
      }
    } else {
      // the edge leaves the bitmap: clip it to each pixel column in turn
      for (int x = 0; x < len; ++x) {
        float y0 = y_top, x1 = (float)(x), x2 = (float)(x + 1), x3 = xb, y3 = y_bottom;
        float y1 = (x - x0) / dx + y_top, y2 = (x + 1 - x0) / dx + y_top;
        if (x0 < x1 && x3 > x2) {
          handle_clipped_edge(scanline, x, e, x0, y0, x1, y1);
          handle_clipped_edge(scanline, x, e, x1, y1, x2, y2);
          handle_clipped_edge(scanline, x, e, x2, y2, x3, y3);
        } else if (x3 < x1 && x0 > x2) {
          handle_clipped_edge(scanline, x, e, x0, y0, x2, y2);
          handle_clipped_edge(scanline, x, e, x2, y2, x1, y1);
          handle_clipped_edge(scanline, x, e, x1, y1, x3, y3);
        } else if (x0 < x1 && x3 > x1) {
          handle_clipped_edge(scanline, x, e, x0, y0, x1, y1);
          handle_clipped_edge(scanline, x, e, x1, y1, x3, y3);
        } else if (x3 < x1 && x0 > x1) {
          handle_clipped_edge(scanline, x, e, x0, y0, x1, y1);
          handle_clipped_edge(scanline, x, e, x1, y1, x3, y3);
        } else if (x0 < x2 && x3 > x2) {
          handle_clipped_edge(scanline, x, e, x0, y0, x2, y2);
          handle_clipped_edge(scanline, x, e, x2, y2, x3, y3);
        } else if (x3 < x2 && x0 > x2) {
          handle_clipped_edge(scanline, x, e, x0, y0, x2, y2);
          handle_clipped_edge(scanline, x, e, x2, y2, x3, y3);
        } else {
          handle_clipped_edge(scanline, x, e, x0, y0, x3, y3);
        }
      }
    }
  }
}

// stbtt__rasterize_sorted_edges (v2): edges sorted by y0, e[n] a sentinel
void rasterize_sorted_edges(uint8_t* pixels, int w, int h, Edge* e, int n, int off_x, int off_y) {
  std::vector<Active> pool(n > 0 ? n : 1);  // each edge becomes active at most once
  int used = 0;
  Active* active = nullptr;
  std::vector<float> lines(2 * w + 1);
  float* scanline = lines.data();
  float* scanline2 = scanline + w;
  int y = off_y;
  e[n].y0 = (float)(off_y + h) + 1;
  for (int j = 0; j < h; ++j, ++y) {
    float scan_y_top = y + 0.0f, scan_y_bottom = y + 1.0f;
    std::memset(scanline, 0, w * sizeof(float));
    std::memset(scanline2, 0, (w + 1) * sizeof(float));
    for (Active** step = &active; *step;) {  // drop the edges that ended above this scanline
      Active* z = *step;
      if (z->ey <= scan_y_top) {
        *step = z->next;
        z->direction = 0;
      } else {
        step = &z->next;
      }
    }
    while (e->y0 <= scan_y_bottom) {  // add the edges that start in it
      if (e->y0 != e->y1) {
        Active* z = &pool[used++];
        float dxdy = (e->x1 - e->x0) / (e->y1 - e->y0);
        z->fdx = dxdy;
        z->fdy = dxdy != 0.0f ? (1.0f / dxdy) : 0.0f;
        z->fx = e->x0 + dxdy * (scan_y_top - e->y0);
        z->fx -= off_x;
        z->direction = e->invert ? 1.0f : -1.0f;
        z->sy = e->y0;
        z->ey = e->y1;
        if (j == 0 && off_y != 0 && z->ey < scan_y_top) z->ey = scan_y_top;
        z->next = active;
        active = z;
      }
      ++e;
    }
    if (active) fill_active_edges(scanline, scanline2 + 1, w, active, scan_y_top);
    float sum = 0;
    for (int i = 0; i < w; ++i) {
      sum += scanline2[i];
      float k = scanline[i] + sum;
      k = (float)std::fabs(k) * 255 + 0.5f;
      int m = (int)k;
      if (m > 255) m = 255;
      pixels[j * w + i] = (uint8_t)m;
    }
    for (Active* z = active; z; z = z->next) z->fx += z->fdx;
  }
}

inline bool edge_before(const Edge& a, const Edge& b) { return a.y0 < b.y0; }

// stbtt__sort_edges: stb's quicksort down to runs of 12, then insertion
// sort (edges with equal y0 keep stb's order, which the sums depend on)
void sort_edges_quicksort(Edge* p, int n) {
  while (n > 12) {
    Edge t;
    int m = n >> 1;
    int c01 = edge_before(p[0], p[m]), c12 = edge_before(p[m], p[n - 1]);
    if (c01 != c12) {
      int c = edge_before(p[0], p[n - 1]);
      int z = (c == c12) ? 0 : n - 1;
      t = p[z];
      p[z] = p[m];
      p[m] = t;
    }
    t = p[0];
    p[0] = p[m];
    p[m] = t;
    int i = 1, j = n - 1;
    for (;;) {
      for (;; ++i)
        if (!edge_before(p[i], p[0])) break;
      for (;; --j)
        if (!edge_before(p[0], p[j])) break;
      if (i >= j) break;
      t = p[i];
      p[i] = p[j];
      p[j] = t;
      ++i;
      --j;
    }
    if (j < (n - i)) {
      sort_edges_quicksort(p, j);
      p = p + i;
      n = n - i;
    } else {
      sort_edges_quicksort(p + i, n - i);
      n = j;
    }
  }
}

void sort_edges_ins_sort(Edge* p, int n) {
  for (int i = 1; i < n; ++i) {
    Edge t = p[i];
    int j = i;
    while (j > 0 && edge_before(t, p[j - 1])) {
      p[j] = p[j - 1];
      --j;
    }
    if (i != j) p[j] = t;
  }
}

// stbtt__tesselate_curve
void tesselate_curve(std::vector<Point>& pts, float x0, float y0, float x1, float y1, float x2, float y2,
                     float flatness_squared, int n) {
  float mx = (x0 + 2 * x1 + x2) / 4, my = (y0 + 2 * y1 + y2) / 4;
  float dx = (x0 + x2) / 2 - mx, dy = (y0 + y2) / 2 - my;
  if (n > 16) return;
  if (dx * dx + dy * dy > flatness_squared) {
    tesselate_curve(pts, x0, y0, (x0 + x1) / 2.0f, (y0 + y1) / 2.0f, mx, my, flatness_squared, n + 1);
    tesselate_curve(pts, mx, my, (x1 + x2) / 2.0f, (y1 + y2) / 2.0f, x2, y2, flatness_squared, n + 1);
  } else {
    pts.push_back({x2, y2});
  }
}

// stbtt_Rasterize(result, 0.35f, vertices, ..., invert = 1): flatten the
// outline, make its edges and rasterise them into the w x h bitmap
void rasterize(const uint8_t* types, const int16_t* xy, int nv, float scale, float shift, int off_x, int off_y,
               int w, int h, uint8_t* out) {
  float flatness = 0.35f / scale;
  float flatness_squared = flatness * flatness;
  std::vector<Point> pts;
  std::vector<int> lengths;
  float x = 0, y = 0;
  int start = 0;
  bool open = false;
  for (int i = 0; i < nv; ++i) {
    const int16_t* v = xy + 4 * i;
    if (types[i] == VMOVE) {
      if (open) lengths.push_back((int)pts.size() - start);
      open = true;
      start = (int)pts.size();
      x = v[0], y = v[1];
      pts.push_back({x, y});
    } else if (types[i] == VLINE) {
      x = v[0], y = v[1];
      pts.push_back({x, y});
    } else {
      tesselate_curve(pts, x, y, v[2], v[3], v[0], v[1], flatness_squared, 0);
      x = v[0], y = v[1];
    }
  }
  if (open) lengths.push_back((int)pts.size() - start);
  float y_scale_inv = -scale;  // invert: font y up, bitmap y down
  std::vector<Edge> edges(pts.size() + 1);
  int n = 0, m = 0;
  for (int len : lengths) {
    const Point* p = pts.data() + m;
    m += len;
    for (int k = 0, j = len - 1; k < len; j = k++) {
      if (p[j].y == p[k].y) continue;
      int a = k, b = j;
      edges[n].invert = 0;
      if (p[j].y > p[k].y) {
        edges[n].invert = 1;
        a = j, b = k;
      }
      edges[n].x0 = p[a].x * scale + shift;
      edges[n].y0 = (p[a].y * y_scale_inv + shift) * 1;
      edges[n].x1 = p[b].x * scale + shift;
      edges[n].y1 = (p[b].y * y_scale_inv + shift) * 1;
      ++n;
    }
  }
  sort_edges_quicksort(edges.data(), n);
  sort_edges_ins_sort(edges.data(), n);
  rasterize_sorted_edges(out, w, h, edges.data(), n, off_x, off_y);
}

struct Table {
  const uint8_t* types;    // per vertex
  const int16_t* xy;       // per vertex: x, y, cx, cy
  const int32_t* vstart;   // per glyph, and one past the last
  const int16_t* boxes;    // per glyph: x0, y0, x1, y1
  const int16_t* advances; // per glyph, font units
};

// One glyph's bitmap cropped to its inked rows and columns (as cv2 crops
// it), and its top-left corner relative to (pen_x, org.y); w = 0 when the
// glyph inks nothing.
struct GlyphBitmap {
  std::vector<uint8_t> pixels;
  int w = 0, h = 0, x = 0, y = 0;
};

GlyphBitmap glyph_bitmap(const Table& t, int g, float scale) {
  GlyphBitmap bm;
  int v0 = t.vstart[g], v1 = t.vstart[g + 1];
  const int16_t* box = t.boxes + 4 * g;
  int ix0 = (int)std::floor((float)box[0] * scale), iy0 = (int)std::floor((float)(-box[3]) * scale);
  int ix1 = (int)std::ceil((float)box[2] * scale), iy1 = (int)std::ceil((float)(-box[1]) * scale);
  int w = ix1 - ix0, h = iy1 - iy0;
  if (v1 <= v0 || w == 0 || h == 0) return bm;
  int pad = std::max((w + 9) / 10, (h + 9) / 10) + 10;
  int pw = w + 2 * pad, ph = h + 2 * pad;
  std::vector<uint8_t> padded((size_t)pw * ph, 0);
  rasterize(t.types + v0, t.xy + 4 * v0, v1 - v0, scale, (float)pad, ix0, iy0, pw, ph, padded.data());
  int c0 = pw, c1 = -1, r0 = ph, r1 = -1;
  for (int r = 0; r < ph; ++r)
    for (int c = 0; c < pw; ++c)
      if (padded[(size_t)r * pw + c]) {
        c0 = std::min(c0, c), c1 = std::max(c1, c), r0 = std::min(r0, r), r1 = std::max(r1, r);
      }
  if (c1 < 0) return bm;
  bm.w = c1 - c0 + 1;
  bm.h = r1 - r0 + 1;
  bm.x = ix0 - pad + c0;
  bm.y = iy0 - pad + r0;
  bm.pixels.resize((size_t)bm.w * bm.h);
  for (int r = 0; r < bm.h; ++r)
    std::memcpy(&bm.pixels[(size_t)r * bm.w], &padded[(size_t)(r0 + r) * pw + c0], bm.w);
  return bm;
}

// Each thread keeps the bitmaps it drew, by (table, glyph, size): the
// caller names a table by a key no other table shares.
struct CacheKey {
  long long table;
  int glyph, size;
  bool operator==(const CacheKey& o) const { return table == o.table && glyph == o.glyph && size == o.size; }
};

struct CacheKeyHash {
  size_t operator()(const CacheKey& k) const {
    return std::hash<long long>()(k.table * 1000003LL + (long long)k.glyph * 65537LL + k.size);
  }
};

const size_t CACHE_LIMIT = 8192;  // bitmaps a thread keeps before it starts over

const GlyphBitmap& cached_bitmap(const Table& t, long long table_key, int g, int size, float scale) {
  thread_local std::unordered_map<CacheKey, GlyphBitmap, CacheKeyHash> cache;
  CacheKey key{table_key, g, size};
  auto it = cache.find(key);
  if (it != cache.end()) return it->second;
  if (cache.size() >= CACHE_LIMIT) cache.clear();
  return cache.emplace(key, glyph_bitmap(t, g, scale)).first->second;
}

int advance_pixels(const Table& t, int g, float scale) {
  float a = (float)t.advances[g] * scale;
  return (int)std::lrint(64.0f * a) >> 6;  // cvRound, ties to even, then whole pixels
}

}  // namespace

extern "C" {

// Draws (img != nullptr) or measures the glyphs[0..n) of one weight's table
// (named by table_key, a key no other table shares) at `size` pixels with
// the baseline-left pen at (org_x, org_y). img is a rows x cols x cn uint8
// image (cn 1, 3 or 4) with a row step of `step` bytes; color holds cn
// values. out[0] is the string's advance in pixels, out[1] one past the
// last row any glyph inks, relative to org_y (INT32_MIN when no glyph
// inks). Returns 0, or 1 on bad arguments.
int cv2_text_draw(const int32_t* glyphs, int n, long long table_key, const uint8_t* types, const int16_t* xy,
                  const int32_t* vstart, const int16_t* boxes, const int16_t* advances, int n_glyphs, int size,
                  int ascent, int org_x, int org_y, uint8_t* img, int rows, int cols, int cn, long long step,
                  const uint8_t* color, int32_t* out) {
  if (n < 0 || size < 0 || ascent <= 0 || (img && cn != 1 && cn != 3 && cn != 4)) return 1;
  for (int i = 0; i < n; ++i)
    if (glyphs[i] < 0 || glyphs[i] >= n_glyphs) return 1;
  Table t{types, xy, vstart, boxes, advances};
  float scale = (float)size / (float)ascent;
  int colour_channels = cn == 4 ? 3 : cn;
  long long pen = org_x;
  int32_t bottom = INT32_MIN;
  if (org_x >= cols) img = nullptr;  // cv2 draws nothing from a pen past the image's right edge
  for (int i = 0; i < n; ++i) {
    int g = glyphs[i];
    const GlyphBitmap& bm = cached_bitmap(t, table_key, g, size, scale);
    if (bm.w && bm.y + bm.h > bottom) bottom = bm.y + bm.h;
    for (int r = 0; img && r < bm.h; ++r) {
      long long yy = (long long)org_y + bm.y + r;
      if (yy < 0 || yy >= rows) continue;
      const uint8_t* src = bm.pixels.data() + (size_t)r * bm.w;
      for (int c = 0; c < bm.w; ++c) {
        int a = src[c];
        long long xx = pen + bm.x + c;
        if (!a || xx < 0 || xx >= cols) continue;
        uint8_t* d = img + yy * step + xx * cn;
        for (int k = 0; k < colour_channels; ++k) d[k] = (uint8_t)((d[k] * (255 - a) + color[k] * a + 127) / 255);
        if (cn == 4) d[3] = (uint8_t)a;
      }
    }
    pen += advance_pixels(t, g, scale);
  }
  out[0] = (int32_t)(pen - org_x);
  out[1] = bottom;
  return 0;
}

}  // extern "C"
