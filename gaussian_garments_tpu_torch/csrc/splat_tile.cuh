// What composite_fwd.cu and composite_bwd.cu share: the tile and warp
// geometry of the splat compositor, the JAX package's gates, and the
// per-warp splat mask.
//
// A block covers one 16x32 tile with 512 threads, one pixel each. Its 16
// warps each own an 8x4-pixel sub-tile (2 columns x 8 rows of warps), so
// that a small splat meets few warps: warp w holds the pixels
// x = 8 (w % 2) + lane % 8, y = 4 (w / 2) + lane / 8 of the tile.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace splat_tile {

constexpr int kTileW = 16;
constexpr int kTileH = 32;
constexpr int kPix = kTileW * kTileH;  // threads per block
constexpr int kWarpW = 8;              // a warp's sub-tile, in pixels
constexpr int kWarpH = 4;
constexpr int kWarpCols = kTileW / kWarpW;
constexpr int kWarpRows = kTileH / kWarpH;
constexpr unsigned kAllWarps = (1u << (kWarpCols * kWarpRows)) - 1u;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kAlphaEps = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;

// The pixel of thread t in the tile whose top-left pixel is (ox, oy).
__device__ __forceinline__ int pixel_x(int ox, int t) {
  return ox + ((t >> 5) % kWarpCols) * kWarpW + (t & 31) % kWarpW;
}
__device__ __forceinline__ int pixel_y(int oy, int t) {
  return oy + ((t >> 5) / kWarpCols) * kWarpH + (t & 31) / kWarpW;
}

constexpr float kSpanEps = 1e-3f;          // margin in pixels (ops/tiles.py SPAN_EPS_PX)
constexpr float kBoxRound = 1.0f / 262144.0f;  // 2^-18 (ops/tiles.py BOX_ROUND)

// Bit w is set when the splat's warp box holds a pixel of warp w of the tile
// at (ox, oy). The box, centred on (mx, my), is the bounding box of the
// splat's alpha >= 1/255 ellipse {d^T C d <= tau^2}, C = [[ca, cb], [cb, cc]],
// tau^2 = 2 ln(opacity * 255): half-widths sqrt(tau^2 cc / det) and
// sqrt(tau^2 ca / det), not clamped by the 3-sigma radius, each widened by
// kSpanEps and by kBoxRound * extent * kappa for the float32 rounding of the
// gate, kappa = (ca cc + |cb| sqrt(ca cc)) / det. Every pixel where the
// splat's alpha can reach 1/255 lies in the box, so a warp whose bit is
// clear would gate the splat out at each of its pixels. A bad conic (as
// ops/tiles.py::ellipse tests it) or a NaN extent: every warp. The torch
// twin ops/tiles.py::warp_extents computes the same box for the tests.
__device__ __forceinline__ unsigned warp_mask(float mx, float my, float ca, float cb, float cc,
                                              float opacity, int ox, int oy) {
  const float det = ca * cc - cb * cb;
  const float tau2 = 2.0f * logf(fmaxf(opacity, 1e-12f) / kAlphaEps);
  const bool ok = det > 1e-24f && det < CUDART_INF_F && tau2 < CUDART_INF_F && ca > 1e-24f &&
                  cc > 1e-24f;
  if (!ok) return kAllWarps;
  const float ac = ca * cc;
  const float kappa = (ac + fabsf(cb) * sqrtf(ac)) / det;
  const float ex0 = sqrtf(fmaxf(tau2 * cc, 0.0f) / det);
  const float ey0 = sqrtf(fmaxf(tau2 * ca, 0.0f) / det);
  const float ex = ex0 + kSpanEps + kBoxRound * ex0 * kappa;
  const float ey = ey0 + kSpanEps + kBoxRound * ey0 * kappa;
  if (!(ex >= 0.0f && ey >= 0.0f)) return kAllWarps;
  const float x_lo = mx - ex, x_hi = mx + ex, y_lo = my - ey, y_hi = my + ey;
  unsigned cols = 0u, mask = 0u;
#pragma unroll
  for (int c = 0; c < kWarpCols; ++c) {
    const int x0 = ox + c * kWarpW;
    if (x_lo <= static_cast<float>(x0 + kWarpW - 1) && x_hi >= static_cast<float>(x0)) {
      cols |= 1u << c;
    }
  }
#pragma unroll
  for (int r = 0; r < kWarpRows; ++r) {
    const int y0 = oy + r * kWarpH;
    if (y_lo <= static_cast<float>(y0 + kWarpH - 1) && y_hi >= static_cast<float>(y0)) {
      mask |= cols << (kWarpCols * r);
    }
  }
  return mask;
}

}  // namespace splat_tile
