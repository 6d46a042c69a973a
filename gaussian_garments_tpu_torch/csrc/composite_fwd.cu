// Forward splat compositor for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_composite_kernel` of
// gaussian_garments_tpu/ops/pallas_tiles.py (launched by
// `composite_tiles_flat`), keeping its numerics:
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy     (d = splat centre - pixel,
//                                                 pixel centres at integers)
//   alpha = min(0.99, opacity * exp(power)), used iff power <= 0 and
//           alpha >= 1/255
//   a splat contributes alpha * T while the transmittance T *before* it is
//   >= 1e-4; T is carried as log T (log1pf / expf), like the TPU kernel.
// Outputs are premultiplied colour (3,H,W), sum depth*w (1,H,W) and
// sum w (1,H,W), written planar with no untile pass, plus each pixel's final
// log T and the index of its last contributing pair (for the backward kernel).
//
// What bounds it on this card: the pixel-pair evaluations, each an expf and
// its gates, and for each contributing pair a log1pf, an expf and ~10 flops;
// not device-memory bytes (a splat is read once per tile it touches). The
// binning (ops/tiles.py) already keeps only the tile rows that the splat's
// alpha >= 1/255 ellipse reaches; inside a tile most splats still cover a
// few of its 512 pixels.
//
// Design: one 512-thread block per 16x32 tile, one pixel a thread, each warp
// an 8x4-pixel sub-tile (splat_tile.cuh). The block stages its tile's
// depth-sorted pairs in batches of 512 in shared memory; the staging thread
// also computes the splat's warp box from its conic and opacity and from it
// the warp mask, the warps whose pixels the box reaches. Each warp then
// walks only the splats whose mask holds its bit: a ballot over 32 staged
// splats at a time, then the set bits in depth order, so every pixel still
// sees its splats front to back and a skipped splat is one that its gates
// would have dropped at every pixel of the warp.
// A pixel stops when it saturates, a warp when all its pixels have
// (__all_sync), the block when all warps have (__syncthreads_count).
//
// The build uses -fmad=false so that the gate decisions (power <= 0,
// alpha >= 1/255, T >= 1e-4) round exactly as the plain PyTorch version's
// separate elementwise ops do; the kernel's output equals the plain
// version's bit for bit.

#include "splat_tile.cuh"

namespace {

using namespace splat_tile;

// feats: (N, 12) f32 rows [mx, my, ca, cb | cc, opacity, r, g | b, depth, 0, 0]
__global__ void __launch_bounds__(kPix) composite_fwd_kernel(
    const float4* __restrict__ feats, const int* __restrict__ pair_splat,
    const int* __restrict__ ranges, int tiles_x, int width, int height,
    float* __restrict__ color, float* __restrict__ depth, float* __restrict__ alpha,
    float* __restrict__ final_logt, int* __restrict__ last_pair) {
  __shared__ float4 s_a[kPix];
  __shared__ float4 s_b[kPix];
  __shared__ float2 s_c[kPix];
  __shared__ unsigned short s_mask[kPix];

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
  const int end = ranges[tile + 1];

  float log_t = 0.0f, trans = 1.0f;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_d = 0.0f, acc_a = 0.0f;
  int last = -1;
  bool done = !inside;

  for (int base = start; base < end; base += kPix) {
    // also the barrier that protects the previous batch's shared reads
    if (__syncthreads_count(!done) == 0) break;
    const int p = base + t;
    if (p < end) {
      const int s = pair_splat[p];
      const float4 a = feats[3 * s];
      const float4 b = feats[3 * s + 1];
      const float4 c = feats[3 * s + 2];
      s_a[t] = a;
      s_b[t] = b;
      s_c[t] = make_float2(c.x, c.y);
      s_mask[t] = static_cast<unsigned short>(warp_mask(a.x, a.y, a.z, a.w, b.x, b.y, ox, oy));
    }
    __syncthreads();
    const int n = min(kPix, end - base);
    for (int j0 = 0; j0 < n; j0 += 32) {
      if (__all_sync(kFull, done)) break;
      const int jl = j0 + lane;
      unsigned hits = __ballot_sync(kFull, jl < n && (s_mask[jl] & bit) != 0u);
      while (hits != 0u) {
        const int j = j0 + __ffs(hits) - 1;
        hits &= hits - 1u;
        if (done) continue;
        const float4 a = s_a[j];  // mx, my, conic a, conic b
        const float4 b = s_b[j];  // conic c, opacity, r, g
        const float dx = a.x - fx;
        const float dy = a.y - fy;
        const float power = -0.5f * (a.z * dx * dx + b.x * dy * dy) - a.w * dx * dy;
        if (power > 0.0f) continue;
        const float al = fminf(kAlphaMax, b.y * expf(power));
        if (al < kAlphaEps) continue;
        const float2 c = s_c[j];  // b, depth
        const float w = al * trans;
        acc_r += b.z * w;
        acc_g += b.w * w;
        acc_b += c.x * w;
        acc_d += c.y * w;
        acc_a += w;
        log_t += log1pf(-al);
        trans = expf(log_t);
        last = base + j;
        // the next splat would see T < 1e-4 and contribute nothing, nor would
        // any after it: this pixel is done
        if (trans < kTEps) done = true;
      }
    }
  }

  if (inside) {
    const int hw = width * height;
    const int idx = py * width + px;
    color[idx] = acc_r;
    color[hw + idx] = acc_g;
    color[2 * hw + idx] = acc_b;
    depth[idx] = acc_d;
    alpha[idx] = acc_a;
    final_logt[idx] = log_t;
    last_pair[idx] = last;
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 on success).
int gg_composite_fwd(const float* feats, const int* pair_splat, const int* ranges,
                     int num_tiles, int tiles_x, int width, int height, float* color,
                     float* depth, float* alpha, float* final_logt, int* last_pair,
                     void* stream) {
  if (num_tiles > 0) {
    composite_fwd_kernel<<<num_tiles, splat_tile::kPix, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(feats), pair_splat, ranges, tiles_x, width, height,
        color, depth, alpha, final_logt, last_pair);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* gg_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
