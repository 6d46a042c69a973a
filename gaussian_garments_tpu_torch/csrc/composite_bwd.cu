// Backward splat compositor for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_backward_kernel` / `_backward_body` of
// gaussian_garments_tpu/ops/pallas_tiles.py (launched by
// `backward_tiles_flat`), together with the pair-gradient `segment_sum` of
// `_flat_bwd` that reduced its per-pair output to splats.
//
// Math (per pixel, walking its pairs back to front from the last pair that
// contributed in the forward, composite_fwd.cu):
//   log T_before = log T_after - log1p(-alpha)
//   G  = gC . c + gD * d + gA           (gA: the cotangent of sum w, with the
//                                        background blend already folded in
//                                        by autograd outside the kernel)
//   w  = alpha * T_before
//   dalpha = T_before * G - S / (1 - alpha),  S = sum_{j after i} G_j w_j
//   dalpha = 0 where the raw alpha was capped at 0.99
//   dpower = dalpha * alpha,  dopacity = dalpha * exp(power)
//   dmx = -dpower (a dx + b dy), dmy = -dpower (c dy + b dx),
//   da = -dpower dx^2 / 2, db = -dpower dx dy, dc = -dpower dy^2 / 2,
//   drgb = gC * w, ddepth = gD * w.
// A pair is walked exactly when it contributed in the forward: index <=
// last_pair, power <= 0 and alpha >= 1/255. The build uses -fmad=false, like
// the forward, so these gate decisions round as they did there.
//
// What bounds it on this card: instructions, not device-memory bytes (a
// splat is read once per tile and its gradient written once per tile): the
// gates of each pair a warp walks, two expf, one log1pf and ~40 flops for
// each pair a pixel uses, and one reduction of ten gradient values per
// (splat, warp) that any pixel uses, which costs more than the rest where
// splats cover most of a warp.
//
// Design: one 512-thread block per 16x32 tile, one pixel a thread, each warp
// an 8x4-pixel sub-tile (splat_tile.cuh), as in the forward. The block
// stages its tile's range back to front in batches of 256 splats from the
// block's deepest last_pair, and the staging thread computes the splat's
// warp box and warp mask. Each warp starts at its own deepest last_pair and
// walks only the splats whose mask holds its bit (a ballot over 32 staged
// splats, then the set bits deepest first). The ten gradient values of a
// splat that any lane of a warp uses are summed by a warp shuffle butterfly
// (warp_sum_into: 16 shuffles where a tree per value takes 50) into the
// batch's shared gradient rows. Per-lane shared atomics for splats that few
// lanes use were measured on the H100 and never beat the butterfly (PERF.md),
// so the butterfly is the only reduction. Each batch ends with one device
// atomicAdd per (splat, tile, gradient component) into d_feats. The atomics
// sum in an order that changes from run to run, so results agree with the
// plain version to rounding, not bit for bit.

#include "splat_tile.cuh"

namespace {

using namespace splat_tile;

constexpr int kBatch = 256;  // splats staged per batch
constexpr int kGrad = 10;    // gradient columns written per splat
constexpr int kFeat = 12;    // columns of feats / d_feats

// One level of warp_sum_into: lanes 2*kHalf apart swap halves of their
// first 2*kHalf values and each keeps the sums of the half its lane bit picks.
template <int kHalf>
__device__ __forceinline__ void fold(float (&u)[16], int lane) {
  const bool upper = (lane & (2 * kHalf)) != 0;
#pragma unroll
  for (int c = 0; c < kHalf; ++c) {
    const float keep = upper ? u[c + kHalf] : u[c];
    const float send = upper ? u[c] : u[c + kHalf];
    u[c] = keep + __shfl_xor_sync(kFull, send, 2 * kHalf);
  }
}

// Adds the sums over the warp's 32 lanes of v[0..9] into row[0..9]. A
// butterfly that halves the values each lane carries at every level: at
// offset 16 a lane keeps 8 of the 16 (ten, padded with zeros) and sends the
// other 8, then 4, 2, 1, and at offset 1 the last pair; 16 shuffles in all,
// against 50 for a tree per value. Lane 2i ends with the sum of value i,
// and the ten such lanes add into the row in one instruction.
__device__ __forceinline__ void warp_sum_into(const float (&v)[kGrad], float* row, int lane) {
  float u[16];
#pragma unroll
  for (int c = 0; c < 16; ++c) u[c] = c < kGrad ? v[c] : 0.0f;
  fold<8>(u, lane);
  fold<4>(u, lane);
  fold<2>(u, lane);
  fold<1>(u, lane);
  u[0] += __shfl_xor_sync(kFull, u[0], 1);
  const int c = lane >> 1;
  if ((lane & 1) == 0 && c < kGrad) atomicAdd(&row[c], u[0]);
}

// feats: (N, 12) f32 rows [mx, my, ca, cb | cc, opacity, r, g | b, depth, 0, 0]
__global__ void __launch_bounds__(kPix) composite_bwd_kernel(
    const float4* __restrict__ feats, const int* __restrict__ pair_splat,
    const int* __restrict__ ranges, const float* __restrict__ final_logt,
    const int* __restrict__ last_pair, const float* __restrict__ g_color,
    const float* __restrict__ g_depth, const float* __restrict__ g_alpha, int tiles_x,
    int width, int height, float* __restrict__ d_feats) {
  __shared__ float4 s_a[kBatch];
  __shared__ float4 s_b[kBatch];
  __shared__ float2 s_c[kBatch];
  __shared__ int s_id[kBatch];
  __shared__ unsigned short s_mask[kBatch];
  __shared__ float s_grad[kBatch * kGrad];
  __shared__ int s_last;

  const int tile = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const unsigned bit = 1u << (t >> 5);
  const int ox = (tile % tiles_x) * kTileW;
  const int oy = (tile / tiles_x) * kTileH;
  const int px = pixel_x(ox, t);
  const int py = pixel_y(oy, t);
  const bool inside = px < width && py < height;
  const float fx = static_cast<float>(px);
  const float fy = static_cast<float>(py);
  const int start = ranges[tile];

  int last = -1;
  float log_t = 0.0f, gr = 0.0f, gg = 0.0f, gb = 0.0f, gd = 0.0f, ga = 0.0f;
  if (inside) {
    const int hw = width * height;
    const int idx = py * width + px;
    last = last_pair[idx];
    log_t = final_logt[idx];
    gr = g_color[idx];
    gg = g_color[hw + idx];
    gb = g_color[2 * hw + idx];
    gd = g_depth[idx];
    ga = g_alpha[idx];
  }
  if (t == 0) s_last = -1;
  __syncthreads();
  const int warp_last = __reduce_max_sync(kFull, last);
  if (lane == 0) atomicMax(&s_last, warp_last);
  __syncthreads();
  const int stop = s_last + 1;  // no pixel of the tile used a pair at or after it

  float suffix = 0.0f;  // S: sum of G_j w_j over the pairs after the current one
  for (int hi = stop; hi > start; hi -= kBatch) {
    const int lo = max(start, hi - kBatch);
    const int n = hi - lo;
    __syncthreads();  // the previous batch's flush has read s_grad and s_id
    for (int i = t; i < n * kGrad; i += kPix) s_grad[i] = 0.0f;
    if (t < n) {
      const int s = pair_splat[lo + t];
      const float4 a = feats[3 * s];
      const float4 b = feats[3 * s + 1];
      const float4 c = feats[3 * s + 2];
      s_id[t] = s;
      s_a[t] = a;
      s_b[t] = b;
      s_c[t] = make_float2(c.x, c.y);
      s_mask[t] = static_cast<unsigned short>(warp_mask(a.x, a.y, a.z, a.w, b.x, b.y, ox, oy));
    }
    __syncthreads();
    // this warp's part of the batch: the pairs at or before its deepest last pair
    for (int j1 = min(n, warp_last - lo + 1); j1 > 0; j1 -= 32) {
      const int j0 = max(0, j1 - 32);
      const int jl = j0 + lane;
      unsigned hits = __ballot_sync(kFull, jl < j1 && (s_mask[jl] & bit) != 0u);
      while (hits != 0u) {
        const int hb = 31 - __clz(hits);
        hits &= ~(1u << hb);
        const int j = j0 + hb;
        const float4 a = s_a[j];  // mx, my, conic a, conic b
        const float4 b = s_b[j];  // conic c, opacity, r, g
        const float dx = a.x - fx;
        const float dy = a.y - fy;
        const float power = -0.5f * (a.z * dx * dx + b.x * dy * dy) - a.w * dx * dy;
        bool use = (lo + j) <= last && power <= 0.0f;
        float ep = 0.0f, raw = 0.0f, al = 0.0f;
        if (use) {
          ep = expf(power);
          raw = b.y * ep;
          al = fminf(kAlphaMax, raw);
          use = al >= kAlphaEps;
        }
        if (!__any_sync(kFull, use)) continue;
        float v[kGrad];
#pragma unroll
        for (int c = 0; c < kGrad; ++c) v[c] = 0.0f;
        if (use) {
          const float2 c = s_c[j];  // b, depth
          const float log_before = log_t - log1pf(-al);
          const float trans = expf(log_before);
          const float g = gr * b.z + gg * b.w + gb * c.x + gd * c.y + ga;
          const float w = al * trans;
          const float d_alpha = trans * g - suffix / (1.0f - al);
          suffix += g * w;
          log_t = log_before;
          const float d_al = raw > kAlphaMax ? 0.0f : d_alpha;
          const float d_pow = d_al * al;
          v[0] = -d_pow * (a.z * dx + a.w * dy);
          v[1] = -d_pow * (b.x * dy + a.w * dx);
          v[2] = -0.5f * d_pow * dx * dx;
          v[3] = -d_pow * dx * dy;
          v[4] = -0.5f * d_pow * dy * dy;
          v[5] = d_al * ep;
          v[6] = gr * w;
          v[7] = gg * w;
          v[8] = gb * w;
          v[9] = gd * w;
        }
        warp_sum_into(v, s_grad + j * kGrad, lane);
      }
    }
    __syncthreads();
    for (int i = t; i < n * kGrad; i += kPix) {
      const float g = s_grad[i];
      if (g != 0.0f) atomicAdd(&d_feats[s_id[i / kGrad] * kFeat + i % kGrad], g);
    }
  }
}

}  // namespace

extern "C" {

// d_feats must be zeroed by the caller. Launches on `stream`; returns
// cudaGetLastError() (0 on success).
int gg_composite_bwd(const float* feats, const int* pair_splat, const int* ranges,
                     const float* final_logt, const int* last_pair, const float* g_color,
                     const float* g_depth, const float* g_alpha, int num_tiles, int tiles_x,
                     int width, int height, float* d_feats, void* stream) {
  if (num_tiles > 0) {
    composite_bwd_kernel<<<num_tiles, splat_tile::kPix, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(feats), pair_splat, ranges, final_logt, last_pair,
        g_color, g_depth, g_alpha, tiles_x, width, height, d_feats);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* gg_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
