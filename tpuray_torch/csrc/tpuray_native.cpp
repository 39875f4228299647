// tpuray native host library: scene ingestion + acceleration-structure build.
//
// TPU-native equivalents of the reference's C++ host components
// (the original renderer's Utils/obj_loader.h, Utils/BVH.h, Utils/hdr_compute.h,
// lib/hdrloader.cpp, lib/stb_image.h usage) re-designed for flat SoA output
// consumed by JAX. Exposed as a plain C ABI for ctypes binding — no pybind11.
//
// Components:
//   - OBJ parser            -> raw vertex/uv/face index arrays
//   - RGBE (.hdr) codec     -> float RGB decode + encode (for test assets)
//   - BMP decode            -> uncompressed 24/32-bit bottom-up BMP
//   - sweep-SAH BVH builder -> DFS-preorder nodes with skip links (stackless
//                              threaded layout; see tpuray/scene/types.py)
//   - HDR inverse-CDF cache -> (sample_x, sample_y, pdf) per texel
//
// Build: g++ -O3 -march=native -shared -fPIC -o libtpuray_native.so tpuray_native.cpp

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <numeric>
#include <string>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// OBJ parsing. Triangular faces; the three face layouts the reference accepts
// (obj_loader.h:59-79): "v", "v/vt", "v/vt/vn" (distinguished per line).
// ---------------------------------------------------------------------------

struct ObjData {
  std::vector<float> positions;  // (nv, 3)
  std::vector<float> texcoords;  // (nt, 2)
  std::vector<int> face_v;       // (nf, 3)
  std::vector<int> face_vt;      // (nf, 3), -1 if absent
};

void* tr_obj_parse(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string buf(size, '\0');
  if (fread(&buf[0], 1, size, f) != (size_t)size) { fclose(f); return nullptr; }
  fclose(f);

  ObjData* obj = new ObjData();
  const char* p = buf.c_str();
  const char* end = p + buf.size();
  while (p < end) {
    // find end of line
    const char* eol = (const char*)memchr(p, '\n', end - p);
    if (!eol) eol = end;
    // parse line [p, eol)
    while (p < eol && (*p == ' ' || *p == '\t')) p++;
    if (p + 1 < eol && p[0] == 'v' && (p[1] == ' ' || p[1] == '\t')) {
      char* q = (char*)p + 1;
      float x = strtof(q, &q), y = strtof(q, &q), z = strtof(q, &q);
      obj->positions.push_back(x);
      obj->positions.push_back(y);
      obj->positions.push_back(z);
    } else if (p + 2 < eol && p[0] == 'v' && p[1] == 't' &&
               (p[2] == ' ' || p[2] == '\t')) {
      char* q = (char*)p + 2;
      float u = strtof(q, &q), v = strtof(q, &q);
      obj->texcoords.push_back(u);
      obj->texcoords.push_back(v);
    } else if (p + 1 < eol && p[0] == 'f' && (p[1] == ' ' || p[1] == '\t')) {
      int vi[3] = {0, 0, 0}, ti[3] = {0, 0, 0};
      bool has_vt = false;
      char* q = (char*)p + 1;
      for (int k = 0; k < 3; k++) {
        vi[k] = (int)strtol(q, &q, 10);
        if (*q == '/') {
          q++;
          if (*q != '/') { ti[k] = (int)strtol(q, &q, 10); has_vt = true; }
          if (*q == '/') { q++; (void)strtol(q, &q, 10); }  // vn: parsed, unused
        }
      }
      for (int k = 0; k < 3; k++) {
        obj->face_v.push_back(vi[k] - 1);
        obj->face_vt.push_back(has_vt ? ti[k] - 1 : -1);
      }
    }
    p = eol + 1;
  }
  return obj;
}

int tr_obj_counts(void* handle, int* nv, int* nt, int* nf) {
  ObjData* obj = (ObjData*)handle;
  if (!obj) return -1;
  *nv = (int)(obj->positions.size() / 3);
  *nt = (int)(obj->texcoords.size() / 2);
  *nf = (int)(obj->face_v.size() / 3);
  return 0;
}

int tr_obj_fill(void* handle, float* positions, float* texcoords, int* face_v,
                int* face_vt) {
  ObjData* obj = (ObjData*)handle;
  if (!obj) return -1;
  memcpy(positions, obj->positions.data(), obj->positions.size() * 4);
  if (!obj->texcoords.empty())
    memcpy(texcoords, obj->texcoords.data(), obj->texcoords.size() * 4);
  memcpy(face_v, obj->face_v.data(), obj->face_v.size() * 4);
  memcpy(face_vt, obj->face_vt.data(), obj->face_vt.size() * 4);
  return 0;
}

void tr_obj_free(void* handle) { delete (ObjData*)handle; }

// ---------------------------------------------------------------------------
// Radiance RGBE (.hdr) codec. Format: "#?RADIANCE" (or "#?RGBE") header,
// -Y H +X W resolution line, then per-scanline either new-style RLE
// (component-planar, marker 2 2 hi lo) or flat/old-RLE RGBE pixels.
// Equivalent coverage to lib/hdrloader.cpp:29-191, written from the format
// specification.
// ---------------------------------------------------------------------------

struct HdrData {
  int width = 0, height = 0;
  std::vector<float> rgb;  // (h, w, 3)
};

static inline void rgbe_to_float(const uint8_t e[4], float* out) {
  if (e[3] == 0) {
    out[0] = out[1] = out[2] = 0.0f;
  } else {
    float scale = ldexpf(1.0f, (int)e[3] - (128 + 8));
    out[0] = e[0] * scale;
    out[1] = e[1] * scale;
    out[2] = e[2] * scale;
  }
}

void* tr_hdr_read(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  char line[512];
  if (!fgets(line, sizeof line, f) || strncmp(line, "#?", 2) != 0) {
    fclose(f);
    return nullptr;
  }
  // header lines until blank
  while (fgets(line, sizeof line, f)) {
    if (line[0] == '\n' || line[0] == '\r') break;
  }
  int w = 0, h = 0;
  if (!fgets(line, sizeof line, f) ||
      sscanf(line, "-Y %d +X %d", &h, &w) != 2) {
    fclose(f);
    return nullptr;
  }
  HdrData* hdr = new HdrData();
  hdr->width = w;
  hdr->height = h;
  hdr->rgb.resize((size_t)w * h * 3);
  std::vector<uint8_t> scan((size_t)w * 4);
  for (int y = 0; y < h; y++) {
    uint8_t head[4];
    if (fread(head, 1, 4, f) != 4) goto fail;
    if (head[0] == 2 && head[1] == 2 && ((head[2] << 8) | head[3]) == w && w >= 8) {
      // new-style RLE: 4 planes
      for (int c = 0; c < 4; c++) {
        int x = 0;
        while (x < w) {
          int code = fgetc(f);
          if (code < 0) goto fail;
          if (code > 128) {  // run
            int val = fgetc(f);
            if (val < 0) goto fail;
            int n = code - 128;
            if (x + n > w) goto fail;
            for (int k = 0; k < n; k++) scan[(x + k) * 4 + c] = (uint8_t)val;
            x += n;
          } else {  // literal
            int n = code;
            if (x + n > w) goto fail;
            for (int k = 0; k < n; k++) {
              int val = fgetc(f);
              if (val < 0) goto fail;
              scan[(x + k) * 4 + c] = (uint8_t)val;
            }
            x += n;
          }
        }
      }
    } else {
      // flat RGBE (with old-style run markers 1,1,1,count)
      memcpy(&scan[0], head, 4);
      int x = 1;
      int shift = 0;
      while (x < w) {
        uint8_t px[4];
        if (fread(px, 1, 4, f) != 4) goto fail;
        if (px[0] == 1 && px[1] == 1 && px[2] == 1) {
          int n = px[3] << shift;
          if (x + n > w || x == 0) goto fail;
          for (int k = 0; k < n; k++)
            memcpy(&scan[(x + k) * 4], &scan[(x - 1) * 4], 4);
          x += n;
          shift += 8;
        } else {
          memcpy(&scan[x * 4], px, 4);
          x++;
          shift = 0;
        }
      }
    }
    for (int x = 0; x < w; x++)
      rgbe_to_float(&scan[x * 4], &hdr->rgb[((size_t)y * w + x) * 3]);
  }
  fclose(f);
  return hdr;
fail:
  fclose(f);
  delete hdr;
  return nullptr;
}

int tr_hdr_counts(void* handle, int* w, int* h) {
  HdrData* hdr = (HdrData*)handle;
  if (!hdr) return -1;
  *w = hdr->width;
  *h = hdr->height;
  return 0;
}

int tr_hdr_fill(void* handle, float* rgb) {
  HdrData* hdr = (HdrData*)handle;
  if (!hdr) return -1;
  memcpy(rgb, hdr->rgb.data(), hdr->rgb.size() * 4);
  return 0;
}

void tr_hdr_free(void* handle) { delete (HdrData*)handle; }

int tr_hdr_write(const char* path, int w, int h, const float* rgb) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  fprintf(f, "#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y %d +X %d\n", h, w);
  for (long i = 0; i < (long)w * h; i++) {
    float r = rgb[i * 3], g = rgb[i * 3 + 1], b = rgb[i * 3 + 2];
    float m = std::max(r, std::max(g, b));
    uint8_t e[4] = {0, 0, 0, 0};
    if (m >= 1e-32f) {
      int exp;
      float scale = frexpf(m, &exp) * 256.0f / m;
      e[0] = (uint8_t)std::min(255.0f, r * scale);
      e[1] = (uint8_t)std::min(255.0f, g * scale);
      e[2] = (uint8_t)std::min(255.0f, b * scale);
      e[3] = (uint8_t)(exp + 128);
    }
    fwrite(e, 1, 4, f);
  }
  fclose(f);
  return 0;
}

// ---------------------------------------------------------------------------
// BMP decode (uncompressed 24/32-bit, bottom-up or top-down). Covers the
// texture path the reference takes through stb_image (help_func.h:4-20).
// ---------------------------------------------------------------------------

struct BmpData {
  int width = 0, height = 0;
  std::vector<uint8_t> rgba;  // (h, w, 4) top-down
};

void* tr_bmp_read(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  uint8_t header[54];
  if (fread(header, 1, 54, f) != 54 || header[0] != 'B' || header[1] != 'M') {
    fclose(f);
    return nullptr;
  }
  uint32_t data_off; int32_t w, h; uint16_t bpp; uint32_t compression;
  memcpy(&data_off, header + 10, 4);
  memcpy(&w, header + 18, 4);
  memcpy(&h, header + 22, 4);
  memcpy(&bpp, header + 28, 2);
  memcpy(&compression, header + 30, 4);
  if ((bpp != 24 && bpp != 32) || compression != 0) { fclose(f); return nullptr; }
  bool topdown = h < 0;
  if (topdown) h = -h;
  BmpData* bmp = new BmpData();
  bmp->width = w;
  bmp->height = h;
  bmp->rgba.resize((size_t)w * h * 4);
  int bypp = bpp / 8;
  size_t stride = ((size_t)w * bypp + 3) & ~3;
  std::vector<uint8_t> row(stride);
  fseek(f, data_off, SEEK_SET);
  for (int y = 0; y < h; y++) {
    if (fread(row.data(), 1, stride, f) != stride) { fclose(f); delete bmp; return nullptr; }
    int dy = topdown ? y : (h - 1 - y);
    for (int x = 0; x < w; x++) {
      uint8_t* dst = &bmp->rgba[((size_t)dy * w + x) * 4];
      dst[0] = row[x * bypp + 2];  // BGR -> RGB
      dst[1] = row[x * bypp + 1];
      dst[2] = row[x * bypp + 0];
      dst[3] = bypp == 4 ? row[x * bypp + 3] : 255;
    }
  }
  fclose(f);
  return bmp;
}

int tr_bmp_counts(void* handle, int* w, int* h) {
  BmpData* bmp = (BmpData*)handle;
  if (!bmp) return -1;
  *w = bmp->width;
  *h = bmp->height;
  return 0;
}

int tr_bmp_fill(void* handle, uint8_t* rgba) {
  BmpData* bmp = (BmpData*)handle;
  if (!bmp) return -1;
  memcpy(rgba, bmp->rgba.data(), bmp->rgba.size());
  return 0;
}

void tr_bmp_free(void* handle) { delete (BmpData*)handle; }

// ---------------------------------------------------------------------------
// Sweep-SAH BVH -> threaded DFS-preorder layout with skip links.
//
// Same split policy as the reference (Utils/BVH.h:42-173): per axis, order
// the triangle range by centroid, scan prefix/suffix AABBs, take the
// (axis, split) minimizing SA_L*n_L + SA_R*n_R; leaves hold <= leaf_size
// triangles. Differences, by design:
//   - operates on an index permutation over immutable SoA (no struct sorting)
//   - nodes are emitted in DFS preorder with a skip ("escape") pointer, so
//     device traversal is stackless (root = 0, skip terminator = n_nodes)
//   - outputs the triangle permutation so callers reorder the SoA once.
// ---------------------------------------------------------------------------

struct BvhData {
  std::vector<float> aabb_min, aabb_max;  // (N,3)
  std::vector<int> first_tri, tri_count, skip;  // (N)
  std::vector<int> perm;  // (T) new order -> original index
};

struct BvhBuilder {
  const float* verts;  // (T, 9)
  int leaf_size;
  std::vector<float> cmin, cmax, centroid;  // per-tri (T,3)
  BvhData out;

  void tri_bounds(int t, float* mn, float* mx) {
    for (int a = 0; a < 3; a++) {
      float v0 = verts[t * 9 + a], v1 = verts[t * 9 + 3 + a], v2 = verts[t * 9 + 6 + a];
      mn[a] = std::min(v0, std::min(v1, v2));
      mx[a] = std::max(v0, std::max(v1, v2));
    }
  }

  // returns index one past the end of the subtree (preorder)
  int build(int l, int r) {
    int id = (int)out.first_tri.size();
    out.aabb_min.insert(out.aabb_min.end(), {1e30f, 1e30f, 1e30f});
    out.aabb_max.insert(out.aabb_max.end(), {-1e30f, -1e30f, -1e30f});
    out.first_tri.push_back(0);
    out.tri_count.push_back(0);
    out.skip.push_back(0);  // rebuilt from subtree extents after the build

    for (int i = l; i <= r; i++) {
      int t = out.perm[i];
      for (int a = 0; a < 3; a++) {
        out.aabb_min[id * 3 + a] = std::min(out.aabb_min[id * 3 + a], cmin[t * 3 + a]);
        out.aabb_max[id * 3 + a] = std::max(out.aabb_max[id * 3 + a], cmax[t * 3 + a]);
      }
    }

    int n = r - l + 1;
    if (n <= leaf_size) {
      out.first_tri[id] = l;
      out.tri_count[id] = n;
      return id + 1;
    }

    // sweep SAH over the three axes
    float best_cost = 1e30f;
    int best_axis = -1, best_split = (l + r) / 2;
    std::vector<float> suffix_sa(n);
    std::vector<int> order(out.perm.begin() + l, out.perm.begin() + r + 1);
    std::vector<int> best_order = order;
    for (int axis = 0; axis < 3; axis++) {
      // stable: ties keep preorder, matching the numpy oracle bit-for-bit
      std::stable_sort(order.begin(), order.end(), [&](int a, int b) {
        return centroid[a * 3 + axis] < centroid[b * 3 + axis];
      });
      // suffix surface areas
      float mn[3] = {1e30f, 1e30f, 1e30f}, mx[3] = {-1e30f, -1e30f, -1e30f};
      for (int i = n - 1; i >= 0; i--) {
        int t = order[i];
        for (int a = 0; a < 3; a++) {
          mn[a] = std::min(mn[a], cmin[t * 3 + a]);
          mx[a] = std::max(mx[a], cmax[t * 3 + a]);
        }
        float dx = mx[0] - mn[0], dy = mx[1] - mn[1], dz = mx[2] - mn[2];
        suffix_sa[i] = 2.0f * (dx * dy + dx * dz + dy * dz);
      }
      // prefix scan + cost
      for (int a = 0; a < 3; a++) { mn[a] = 1e30f; mx[a] = -1e30f; }
      for (int i = 0; i < n - 1; i++) {
        int t = order[i];
        for (int a = 0; a < 3; a++) {
          mn[a] = std::min(mn[a], cmin[t * 3 + a]);
          mx[a] = std::max(mx[a], cmax[t * 3 + a]);
        }
        float dx = mx[0] - mn[0], dy = mx[1] - mn[1], dz = mx[2] - mn[2];
        float sa_l = 2.0f * (dx * dy + dx * dz + dy * dz);
        float cost = sa_l * (i + 1) + suffix_sa[i + 1] * (n - 1 - i);
        if (cost < best_cost) {
          best_cost = cost;
          best_axis = axis;
          best_split = l + i;
        }
      }
      if (best_axis == axis) best_order = order;
    }
    std::copy(best_order.begin(), best_order.end(), out.perm.begin() + l);

    build(l, best_split);
    return build(best_split + 1, r);
  }
};

void* tr_bvh_build(const float* tri_verts, int n_tris, int leaf_size) {
  BvhBuilder* b = new BvhBuilder();
  b->verts = tri_verts;
  b->leaf_size = std::max(1, leaf_size);
  b->cmin.resize((size_t)n_tris * 3);
  b->cmax.resize((size_t)n_tris * 3);
  b->centroid.resize((size_t)n_tris * 3);
  for (int t = 0; t < n_tris; t++) {
    b->tri_bounds(t, &b->cmin[t * 3], &b->cmax[t * 3]);
    for (int a = 0; a < 3; a++)
      b->centroid[t * 3 + a] =
          (tri_verts[t * 9 + a] + tri_verts[t * 9 + 3 + a] + tri_verts[t * 9 + 6 + a]) / 3.0f;
  }
  b->out.perm.resize(n_tris);
  std::iota(b->out.perm.begin(), b->out.perm.end(), 0);
  if (n_tris > 0) {
    int n_nodes = b->build(0, n_tris - 1);
    // Rebuild skip links from subtree extents: in preorder the subtree of
    // node i spans [i, end_i) and skip[i] = end_i (root's = n_nodes, the
    // traversal terminator). One forward pass with a (node, children-seen)
    // stack: a leaf closes itself; closing a subtree notifies its parent.
    std::vector<int> end(n_nodes, 0);
    std::vector<std::pair<int, int>> st;  // (inner node, subtrees completed)
    for (int i = 0; i < n_nodes; i++) {
      if (b->out.tri_count[i] == 0) {
        st.push_back({i, 0});
      } else {
        end[i] = i + 1;
        int last_end = end[i];
        while (!st.empty()) {
          auto& top = st.back();
          if (++top.second == 2) {
            end[top.first] = last_end;
            last_end = end[top.first];
            st.pop_back();
          } else {
            break;
          }
        }
      }
    }
    for (int i = 0; i < n_nodes; i++) b->out.skip[i] = end[i];
  }
  return b;
}

int tr_bvh_counts(void* handle, int* n_nodes, int* n_tris) {
  BvhBuilder* b = (BvhBuilder*)handle;
  if (!b) return -1;
  *n_nodes = (int)b->out.first_tri.size();
  *n_tris = (int)b->out.perm.size();
  return 0;
}

int tr_bvh_fill(void* handle, float* aabb_min, float* aabb_max, int* first_tri,
                int* tri_count, int* skip, int* perm) {
  BvhBuilder* b = (BvhBuilder*)handle;
  if (!b) return -1;
  memcpy(aabb_min, b->out.aabb_min.data(), b->out.aabb_min.size() * 4);
  memcpy(aabb_max, b->out.aabb_max.data(), b->out.aabb_max.size() * 4);
  memcpy(first_tri, b->out.first_tri.data(), b->out.first_tri.size() * 4);
  memcpy(tri_count, b->out.tri_count.data(), b->out.tri_count.size() * 4);
  memcpy(skip, b->out.skip.data(), b->out.skip.size() * 4);
  memcpy(perm, b->out.perm.data(), b->out.perm.size() * 4);
  return 0;
}

void tr_bvh_free(void* handle) { delete (BvhBuilder*)handle; }

// ---------------------------------------------------------------------------
// HDR importance-sampling cache (Utils/hdr_compute.h:5-102 equivalent).
// cache[i,j] = (invCDF_x(i/H), invCDF_{y|x}(j/W), pdf[i,j]); pdf is the
// luminance-normalized per-texel probability, luminance = .2R+.7G+.1B.
// ---------------------------------------------------------------------------

int tr_env_cache(const float* rgb, int width, int height, float* cache) {
  size_t n = (size_t)width * height;
  std::vector<double> pdf(n);
  double lum_sum = 0.0;
  for (size_t i = 0; i < n; i++) {
    double lum = 0.2 * rgb[i * 3] + 0.7 * rgb[i * 3 + 1] + 0.1 * rgb[i * 3 + 2];
    pdf[i] = lum;
    lum_sum += lum;
  }
  if (lum_sum <= 0.0) return -1;
  for (size_t i = 0; i < n; i++) pdf[i] /= lum_sum;

  // column marginal + its CDF
  std::vector<double> pdf_x(width, 0.0), cdf_x(width);
  for (int i = 0; i < height; i++)
    for (int j = 0; j < width; j++) pdf_x[j] += pdf[(size_t)i * width + j];
  double acc = 0.0;
  for (int j = 0; j < width; j++) { acc += pdf_x[j]; cdf_x[j] = acc; }

  // conditional CDF per column (stored column-major)
  std::vector<double> cdf_y((size_t)width * height);
  for (int j = 0; j < width; j++) {
    double cacc = 0.0;
    double denom = pdf_x[j] > 0.0 ? pdf_x[j] : 1.0;
    for (int i = 0; i < height; i++) {
      cacc += pdf[(size_t)i * width + j] / denom;
      cdf_y[(size_t)j * height + i] = cacc;
    }
  }

  for (int i = 0; i < height; i++) {
    double xi_1 = (double)i / height;
    int x = (int)(std::lower_bound(cdf_x.begin(), cdf_x.end(), xi_1) - cdf_x.begin());
    if (x >= width) x = width - 1;
    const double* col = &cdf_y[(size_t)x * height];
    for (int j = 0; j < width; j++) {
      double xi_2 = (double)j / width;
      int y = (int)(std::lower_bound(col, col + height, xi_2) - col);
      if (y >= height) y = height - 1;
      size_t o = ((size_t)i * width + j) * 3;
      cache[o] = (float)((double)x / width);
      cache[o + 1] = (float)((double)y / height);
      cache[o + 2] = (float)pdf[(size_t)i * width + j];
    }
  }
  return 0;
}

}  // extern "C"
