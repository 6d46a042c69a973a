// BVH-accelerated first-hit ray casting.
//
// Native replacement for the reference's open3d (embree) RaycastingScene uses
// (virtual-edge discovery, per-texel visibility, inference occlusion — see
// the reference's utils/geometry_utils.py:311-348,
// scene/avatar_gaussian_model.py:227-263, inference.py:295-316).
//
// Design: median-split BVH over triangle centroids, iterative stack
// traversal, Möller–Trumbore first-hit. OpenMP across rays. Exposed as a
// plain C ABI consumed via ctypes (no pybind11 in this image).
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

struct Vec3 {
  float x, y, z;
};

static inline Vec3 vsub(Vec3 a, Vec3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
static inline Vec3 vcross(Vec3 a, Vec3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
static inline float vdot(Vec3 a, Vec3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
static inline Vec3 vmin(Vec3 a, Vec3 b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3 vmax(Vec3 a, Vec3 b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct Node {
  Vec3 bmin, bmax;
  int32_t left;   // internal: left child; leaf: first tri index
  int32_t count;  // 0 for internal nodes; >0 leaf triangle count
  int32_t right;  // internal only
};

struct BVH {
  std::vector<Vec3> v0, e1, e2;  // per-triangle (reordered)
  std::vector<int32_t> tri_id;   // reordered -> original index
  std::vector<Node> nodes;
};

constexpr float kInf = std::numeric_limits<float>::infinity();
constexpr int kLeafSize = 4;

int build_node(BVH& b, std::vector<Vec3>& centroids, std::vector<int32_t>& order,
               int begin, int end) {
  Node node;
  node.bmin = {kInf, kInf, kInf};
  node.bmax = {-kInf, -kInf, -kInf};
  for (int i = begin; i < end; ++i) {
    int t = order[i];
    Vec3 a = b.v0[t];
    Vec3 p1 = {a.x + b.e1[t].x, a.y + b.e1[t].y, a.z + b.e1[t].z};
    Vec3 p2 = {a.x + b.e2[t].x, a.y + b.e2[t].y, a.z + b.e2[t].z};
    node.bmin = vmin(node.bmin, vmin(a, vmin(p1, p2)));
    node.bmax = vmax(node.bmax, vmax(a, vmax(p1, p2)));
  }
  int idx = (int)b.nodes.size();
  b.nodes.push_back(node);
  if (end - begin <= kLeafSize) {
    b.nodes[idx].left = begin;
    b.nodes[idx].count = end - begin;
    return idx;
  }
  Vec3 ext = vsub(node.bmax, node.bmin);
  int axis = (ext.x > ext.y && ext.x > ext.z) ? 0 : (ext.y > ext.z ? 1 : 2);
  int mid = (begin + end) / 2;
  std::nth_element(order.begin() + begin, order.begin() + mid, order.begin() + end,
                   [&](int32_t a, int32_t c) {
                     const float* pa = &centroids[a].x;
                     const float* pc = &centroids[c].x;
                     return pa[axis] < pc[axis];
                   });
  b.nodes[idx].count = 0;
  int l = build_node(b, centroids, order, begin, mid);
  int r = build_node(b, centroids, order, mid, end);
  b.nodes[idx].left = l;
  b.nodes[idx].right = r;
  return idx;
}

static inline bool aabb_hit(const Node& n, Vec3 o, Vec3 inv_d, float tmax) {
  float t0 = (n.bmin.x - o.x) * inv_d.x, t1 = (n.bmax.x - o.x) * inv_d.x;
  float tn = std::min(t0, t1), tf = std::max(t0, t1);
  t0 = (n.bmin.y - o.y) * inv_d.y;
  t1 = (n.bmax.y - o.y) * inv_d.y;
  tn = std::max(tn, std::min(t0, t1));
  tf = std::min(tf, std::max(t0, t1));
  t0 = (n.bmin.z - o.z) * inv_d.z;
  t1 = (n.bmax.z - o.z) * inv_d.z;
  tn = std::max(tn, std::min(t0, t1));
  tf = std::min(tf, std::max(t0, t1));
  return tf >= std::max(tn, 0.0f) && tn <= tmax;
}

}  // namespace

extern "C" {

void* bvh_build(const float* verts, int32_t nv, const int32_t* tris, int32_t nt) {
  (void)nv;
  BVH* b = new BVH();
  b->v0.resize(nt);
  b->e1.resize(nt);
  b->e2.resize(nt);
  std::vector<Vec3> centroids(nt);
  std::vector<int32_t> order(nt);
  for (int i = 0; i < nt; ++i) {
    const int32_t* f = tris + 3 * i;
    Vec3 a = {verts[3 * f[0]], verts[3 * f[0] + 1], verts[3 * f[0] + 2]};
    Vec3 p1 = {verts[3 * f[1]], verts[3 * f[1] + 1], verts[3 * f[1] + 2]};
    Vec3 p2 = {verts[3 * f[2]], verts[3 * f[2] + 1], verts[3 * f[2] + 2]};
    b->v0[i] = a;
    b->e1[i] = vsub(p1, a);
    b->e2[i] = vsub(p2, a);
    centroids[i] = {(a.x + p1.x + p2.x) / 3.f, (a.y + p1.y + p2.y) / 3.f,
                    (a.z + p1.z + p2.z) / 3.f};
    order[i] = i;
  }
  if (nt > 0) build_node(*b, centroids, order, 0, nt);
  // reorder triangle arrays to BVH order
  std::vector<Vec3> v0(nt), e1(nt), e2(nt);
  b->tri_id.resize(nt);
  for (int i = 0; i < nt; ++i) {
    v0[i] = b->v0[order[i]];
    e1[i] = b->e1[order[i]];
    e2[i] = b->e2[order[i]];
    b->tri_id[i] = order[i];
  }
  b->v0.swap(v0);
  b->e1.swap(e1);
  b->e2.swap(e2);
  return b;
}

void bvh_free(void* h) { delete static_cast<BVH*>(h); }

void bvh_raycast(void* h, const float* origins, const float* dirs, int32_t nrays,
                 float* t_out, int32_t* id_out) {
  const BVH& b = *static_cast<BVH*>(h);
  const float eps = 1e-9f;
#pragma omp parallel for schedule(dynamic, 64)
  for (int32_t r = 0; r < nrays; ++r) {
    Vec3 o = {origins[3 * r], origins[3 * r + 1], origins[3 * r + 2]};
    Vec3 d = {dirs[3 * r], dirs[3 * r + 1], dirs[3 * r + 2]};
    Vec3 inv_d = {1.0f / (d.x == 0 ? 1e-30f : d.x), 1.0f / (d.y == 0 ? 1e-30f : d.y),
                  1.0f / (d.z == 0 ? 1e-30f : d.z)};
    float best_t = kInf;
    int32_t best_id = -1;
    if (!b.nodes.empty()) {
      int32_t stack[64];
      int sp = 0;
      stack[sp++] = 0;
      while (sp) {
        const Node& n = b.nodes[stack[--sp]];
        if (!aabb_hit(n, o, inv_d, best_t)) continue;
        if (n.count > 0) {
          for (int i = n.left; i < n.left + n.count; ++i) {
            Vec3 pvec = vcross(d, b.e2[i]);
            float det = vdot(pvec, b.e1[i]);
            if (std::fabs(det) <= eps) continue;
            float inv_det = 1.0f / det;
            Vec3 tvec = vsub(o, b.v0[i]);
            float u = vdot(tvec, pvec) * inv_det;
            if (u < 0.f || u > 1.f) continue;
            Vec3 qvec = vcross(tvec, b.e1[i]);
            float v = vdot(d, qvec) * inv_det;
            if (v < 0.f || u + v > 1.f) continue;
            float t = vdot(b.e2[i], qvec) * inv_det;
            if (t > 1e-9f && t < best_t) {
              best_t = t;
              best_id = b.tri_id[i];
            }
          }
        } else if (sp + 2 <= 64) {
          stack[sp++] = n.left;
          stack[sp++] = n.right;
        }
      }
    }
    t_out[r] = best_t;
    id_out[r] = best_id;
  }
}

}  // extern "C"
