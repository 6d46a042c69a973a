// Cost probes of the forward splat compositor for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU probe kernels
//   `null_kernel`  scripts/profile_kernel_null.py:81   (grid, DMA and init only)
//   `nomxu_kernel` scripts/profile_kernel_null.py:93   (elementwise body, no matmul)
//   `kern_a`..`kern_e` scripts/profile_grid_overhead.py:72,101,124,147,178
//                  (null bodies that split the per-grid-step overhead)
// The `full` row of profile_kernel_null.py is composite_fwd.cu itself.
//
// Kernels:
//   probe_null        the launch shape of composite_fwd (one 512-thread block
//                     per 16x32 tile): walks the tile's pair range in batches
//                     of 512, stages each batch's 12 features in shared
//                     memory (composite_fwd stages 10 and a warp mask),
//                     writes the tile's empty outputs (zeros, last_pair -1)
//                     and does no per-pixel work.
//                     One checksum per tile, the float64 sum of the staged
//                     features, keeps the staging live.
//   probe_alpha_only  composite_fwd's per-warp walk with its gates
//                     (power <= 0, alpha = min(0.99, o exp(power)),
//                     alpha >= 1/255) but no colour, depth, transmittance or
//                     early stop: sum(alpha) and sum(log1p(-alpha)) over all
//                     of the tile's pairs into a (2, H, W) output. Like
//                     composite_fwd it takes 8x4-pixel warps
//                     (splat_tile.cuh), computes each staged splat's warp
//                     mask, and each warp walks only the splats whose mask
//                     holds its bit (a ballot over 32 staged splats, then the
//                     set bits in depth order). A skipped splat is one that
//                     the gates drop at every pixel of the warp, so each
//                     pixel sums the same terms in the same order as a walk
//                     over every pair, bit for bit.
//   grid_ladder       null blocks over the (tile x 256-pair chunk) work list
//                     of the TPU kernel, one block per item, 256 threads:
//                     variant 0 (a) reads 5 separate metadata arrays, stages
//                     its chunk's features (pairs outside its tile's range
//                     masked), zeroes its tile's (8, 512) output when k == 0
//                     and writes one checksum per item; 1 (b) reads the item
//                     metadata as one int4 table and the tile ranges as int2;
//                     2 (c) stages nothing (its checksum is the count of the
//                     item's valid pairs); 3 (d) zeroes tile 0 in every block
//                     (same values, a benign race); 4 (e) one block per two
//                     items.
//
// What bounds them on this card: the null kernels move few bytes (features
// once per pair, the zeroed outputs once) and do no arithmetic, so they
// measure block scheduling and staging latency, which is the point. The
// alpha_only kernel is bound by the special-function units, like
// composite_fwd: its function needs an expf and a log1pf for each term it
// sums; without the early stop a warp walks every pair of its tile whose
// warp box reaches it.
//
// Built with -fmad=false, so alpha_only's gates round like the plain PyTorch
// version's separate elementwise ops.

#include "splat_tile.cuh"

namespace {

using splat_tile::kPix;
using splat_tile::kTileH;
using splat_tile::kTileW;
constexpr int kChunk = 256;
constexpr int kOutRows = 8;

__device__ double sum12(float4 a, float4 b, float4 c) {
  return (static_cast<double>(a.x) + a.y + a.z + a.w) + (static_cast<double>(b.x) + b.y + b.z + b.w)
       + (static_cast<double>(c.x) + c.y + c.z + c.w);
}

// Sum of v over the block; valid in thread 0. `scratch` holds one double a warp.
__device__ double block_sum(double v, double* scratch) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  double total = 0.0;
  if (threadIdx.x == 0) {
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) total += scratch[w];
  }
  return total;
}

// feats: (N, 12) f32 rows [mx, my, ca, cb | cc, opacity, r, g | b, depth, 0, 0]
__global__ void __launch_bounds__(kPix) probe_null_kernel(
    const float4* __restrict__ feats, const int* __restrict__ pair_splat,
    const int* __restrict__ ranges, int tiles_x, int width, int height,
    float* __restrict__ color, float* __restrict__ depth, float* __restrict__ alpha,
    float* __restrict__ final_logt, int* __restrict__ last_pair, double* __restrict__ checksum) {
  __shared__ float4 s_a[kPix];
  __shared__ float4 s_b[kPix];
  __shared__ float4 s_c[kPix];
  __shared__ double s_red[kPix / 32];

  const int tile = blockIdx.x;
  const int t = threadIdx.x;
  const int start = ranges[tile];
  const int end = ranges[tile + 1];
  double acc = 0.0;
  for (int base = start; base < end; base += kPix) {
    __syncthreads();
    const int p = base + t;
    if (p < end) {
      const int s = pair_splat[p];
      s_a[t] = feats[3 * s];
      s_b[t] = feats[3 * s + 1];
      s_c[t] = feats[3 * s + 2];
    }
    __syncthreads();
    if (p < end) acc += sum12(s_a[t], s_b[t], s_c[t]);
  }

  const int px = (tile % tiles_x) * kTileW + (t % kTileW);
  const int py = (tile / tiles_x) * kTileH + (t / kTileW);
  if (px < width && py < height) {
    const int hw = width * height;
    const int idx = py * width + px;
    color[idx] = 0.0f;
    color[hw + idx] = 0.0f;
    color[2 * hw + idx] = 0.0f;
    depth[idx] = 0.0f;
    alpha[idx] = 0.0f;
    final_logt[idx] = 0.0f;
    last_pair[idx] = -1;
  }
  const double total = block_sum(acc, s_red);
  if (t == 0) checksum[tile] = total;
}

__global__ void __launch_bounds__(kPix) probe_alpha_only_kernel(
    const float4* __restrict__ feats, const int* __restrict__ pair_splat,
    const int* __restrict__ ranges, int tiles_x, int width, int height,
    float* __restrict__ out) {
  using namespace splat_tile;
  __shared__ float4 s_a[kPix];
  __shared__ float2 s_b[kPix];
  __shared__ unsigned short s_mask[kPix];

  const int tile = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const unsigned bit = 1u << (t >> 5);
  const int ox = (tile % tiles_x) * kTileW;
  const int oy = (tile / tiles_x) * kTileH;
  const int px = pixel_x(ox, t);
  const int py = pixel_y(oy, t);
  const float fx = static_cast<float>(px);
  const float fy = static_cast<float>(py);
  const int start = ranges[tile];
  const int end = ranges[tile + 1];
  float sum_alpha = 0.0f, sum_log = 0.0f;
  for (int base = start; base < end; base += kPix) {
    __syncthreads();
    const int p = base + t;
    if (p < end) {
      const int s = pair_splat[p];
      const float4 a = feats[3 * s];
      const float4 b = feats[3 * s + 1];
      s_a[t] = a;
      s_b[t] = make_float2(b.x, b.y);
      s_mask[t] = static_cast<unsigned short>(warp_mask(a.x, a.y, a.z, a.w, b.x, b.y, ox, oy));
    }
    __syncthreads();
    const int n = min(kPix, end - base);
    for (int j0 = 0; j0 < n; j0 += 32) {
      const int jl = j0 + lane;
      unsigned hits = __ballot_sync(kFull, jl < n && (s_mask[jl] & bit) != 0u);
      while (hits != 0u) {
        const int j = j0 + __ffs(hits) - 1;
        hits &= hits - 1u;
        const float4 a = s_a[j];  // mx, my, conic a, conic b
        const float2 b = s_b[j];  // conic c, opacity
        const float dx = a.x - fx;
        const float dy = a.y - fy;
        const float power = -0.5f * (a.z * dx * dx + b.x * dy * dy) - a.w * dx * dy;
        if (power > 0.0f) continue;
        const float al = fminf(kAlphaMax, b.y * expf(power));
        if (al < kAlphaEps) continue;
        sum_alpha += al;
        sum_log += log1pf(-al);
      }
    }
  }
  if (px < width && py < height) {
    const int idx = py * width + px;
    out[idx] = sum_alpha;
    out[width * height + idx] = sum_log;
  }
}

// Zero one (8, 512) output tile with the block's 256 threads.
__device__ void zero_tile(float* __restrict__ out, int tile) {
  float4* dst = reinterpret_cast<float4*>(out + static_cast<long long>(tile) * kOutRows * kPix);
  const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int i = threadIdx.x; i < kOutRows * kPix / 4; i += blockDim.x) dst[i] = z;
}

struct Item {
  int chunk, tile, k, start, count;
};

// Stage item `it`'s chunk into (s_a, s_b, s_c); returns this thread's
// staged feature sum (0 for pairs outside the item's tile range).
__device__ double stage_chunk(const float4* __restrict__ feats,
                              const int* __restrict__ pair_splat, const Item& it,
                              float4* s_a, float4* s_b, float4* s_c) {
  const int p = it.chunk * kChunk + static_cast<int>(threadIdx.x);
  const bool valid = p >= it.start && p < it.start + it.count;
  if (valid) {
    const int s = pair_splat[p];
    s_a[threadIdx.x] = feats[3 * s];
    s_b[threadIdx.x] = feats[3 * s + 1];
    s_c[threadIdx.x] = feats[3 * s + 2];
  }
  __syncthreads();
  return valid ? sum12(s_a[threadIdx.x], s_b[threadIdx.x], s_c[threadIdx.x]) : 0.0;
}

__global__ void __launch_bounds__(kChunk) grid_ladder_kernel(
    const float4* __restrict__ feats, const int* __restrict__ pair_splat,
    const int* __restrict__ chunk_of_item, const int* __restrict__ tile_of_item,
    const int* __restrict__ k_of_item, const int* __restrict__ starts,
    const int* __restrict__ counts, const int4* __restrict__ item4,
    const int2* __restrict__ seg2, float* __restrict__ out, double* __restrict__ checksum,
    long long n_items, int variant) {
  __shared__ float4 s_a[2][kChunk];
  __shared__ float4 s_b[2][kChunk];
  __shared__ float4 s_c[2][kChunk];
  __shared__ double s_red[kChunk / 32];

  const int per_block = variant == 4 ? 2 : 1;
  for (int q = 0; q < per_block; ++q) {
    const long long i = static_cast<long long>(blockIdx.x) * per_block + q;
    if (i >= n_items) break;
    Item it;
    if (variant == 1) {
      const int4 m = item4[i];
      const int2 g = seg2[m.y];
      it = Item{m.x, m.y, m.z, g.x, g.y};
    } else {
      it.chunk = chunk_of_item[i];
      it.tile = tile_of_item[i];
      it.k = k_of_item[i];
      it.start = starts[it.tile];
      it.count = counts[it.tile];
    }
    double acc;
    if (variant == 2) {
      const int p = it.chunk * kChunk + static_cast<int>(threadIdx.x);
      acc = __syncthreads_count(p >= it.start && p < it.start + it.count);
    } else {
      acc = stage_chunk(feats, pair_splat, it, s_a[q], s_b[q], s_c[q]);
    }
    if (it.k == 0) zero_tile(out, variant == 3 ? 0 : it.tile);
    const double total = variant == 2 ? acc : block_sum(acc, s_red);
    if (threadIdx.x == 0) checksum[i] = total;
  }
}

int blocks_for(long long n, int per_block) {
  return static_cast<int>((n + per_block - 1) / per_block);
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError().

int gg_probe_null(const float* feats, const int* pair_splat, const int* ranges, int num_tiles,
                  int tiles_x, int width, int height, float* color, float* depth, float* alpha,
                  float* final_logt, int* last_pair, double* checksum, void* stream) {
  if (num_tiles > 0) {
    probe_null_kernel<<<num_tiles, kPix, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(feats), pair_splat, ranges, tiles_x, width, height,
        color, depth, alpha, final_logt, last_pair, checksum);
  }
  return static_cast<int>(cudaGetLastError());
}

int gg_probe_alpha_only(const float* feats, const int* pair_splat, const int* ranges,
                        int num_tiles, int tiles_x, int width, int height, float* out,
                        void* stream) {
  if (num_tiles > 0) {
    probe_alpha_only_kernel<<<num_tiles, kPix, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(feats), pair_splat, ranges, tiles_x, width, height,
        out);
  }
  return static_cast<int>(cudaGetLastError());
}

int gg_grid_ladder(const float* feats, const int* pair_splat, const int* chunk_of_item,
                   const int* tile_of_item, const int* k_of_item, const int* starts,
                   const int* counts, const int* item4, const int* seg2, float* out,
                   double* checksum, long long n_items, int variant, void* stream) {
  if (n_items > 0) {
    grid_ladder_kernel<<<blocks_for(n_items, variant == 4 ? 2 : 1), kChunk, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(feats), pair_splat, chunk_of_item, tile_of_item,
        k_of_item, starts, counts, reinterpret_cast<const int4*>(item4),
        reinterpret_cast<const int2*>(seg2), out, checksum, n_items, variant);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* gg_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
