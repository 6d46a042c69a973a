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
//                     of the TPU kernel, 256 threads a block, as a
//                     persistent walk: as many blocks as the card holds at
//                     once (occupancy x SMs, at most one per step); block b
//                     takes steps b, b + grid, ... A step is one item (two,
//                     2j and 2j + 1, for e). While step s is summed and its
//                     tile zeroed, step s + grid's chunk is in flight into
//                     the other half of a double buffer (16-byte cp.async,
//                     indirect through pair_splat, one commit group a step)
//                     and step s + 2 grid's metadata is read into
//                     registers in three dependent rounds (item, its tile's
//                     range, the splats of the pairs) spread over the
//                     iteration's work. A warp's copies cover whole 48-byte
//                     feature rows. One float64 checksum per
//                     item, the feature sum of its pairs inside its tile's
//                     range, reduced by warp shuffles.
//                     Variant 0 (a) reads 5 separate metadata arrays,
//                     stages its chunk and zeroes its tile's (8, 512) output
//                     when k == 0, four streaming float4 stores a thread;
//                     1 (b) reads the item metadata as one int4 table and the
//                     tile ranges as int2; 2 (c) stages nothing (its
//                     checksum is the count of the item's valid pairs);
//                     3 (d) has the TPU kern_d's fixed output block: a block
//                     whose item has k == 0 zeroes a shared-memory copy of
//                     the tile (the counterpart of the VMEM block), and tile 0
//                     goes to global memory once a launch, from the block
//                     that takes the first item with k == 0 (item 0), at the
//                     end of its walk. d is the ladder with no output
//                     write-backs: a - d is what a-c pay per tile.
//                     4 (e) takes two items a step, both chunks in one
//                     cp.async group. The TPU's kern_e reads the tile and k
//                     of the even item only and drops an odd last item
//                     (profile_grid_overhead.py:170-175); here each item is
//                     taken whole, as the plain version computes.
//                     A launch may count its writes of output tiles to
//                     global memory (one atomic add a block).
//
// What bounds them on this card: the null kernels move few bytes (features
// once per pair, the zeroed outputs once) and do no arithmetic, so they
// measure block scheduling and staging latency, which is the point. The
// ladder's staging reads each pair's 48-byte feature row from a random
// place (two 32-byte sectors), so it pays the rate at which L2 serves
// scattered sectors, not HBM bytes; a-c and e also write 16 KB per tile
// that holds pairs. The alpha_only kernel is bound by the special-function
// units, like composite_fwd: its function needs an expf and a log1pf for
// each term it sums; without the early stop a warp walks every pair of its
// tile whose warp box reaches it.
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

// ---------------------------------------------------------------------------
// grid_ladder: a persistent walk of the (tile x 256-pair chunk) work list
// ---------------------------------------------------------------------------

constexpr int kWarps = kChunk / 32;
constexpr int kTileF4 = kOutRows * kPix / 4;  // float4s of one (8, 512) output tile
constexpr int kSlotF4 = 3 * kChunk;           // float4s of one staged chunk

__device__ __forceinline__ void cp_async16(float4* dst, const float4* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// every group but the `pending` most recent of this thread's has landed
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(pending) : "memory");
}

// Zero output tile `tile` with four streaming float4 stores a thread.
__device__ __forceinline__ void zero_tile(float* __restrict__ out, int tile) {
  float4* dst = reinterpret_cast<float4*>(out) + static_cast<long long>(tile) * kTileF4;
  const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int r = 0; r < kTileF4 / kChunk; ++r) __stcs(dst + r * kChunk + threadIdx.x, z);
}

__device__ __forceinline__ void zero_shared_tile(float4* s_out) {
  const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int r = 0; r < kTileF4 / kChunk; ++r) s_out[r * kChunk + threadIdx.x] = z;
}

__device__ __forceinline__ void write_tile(float* __restrict__ out, int tile,
                                           const float4* s_out) {
  float4* dst = reinterpret_cast<float4*>(out) + static_cast<long long>(tile) * kTileF4;
#pragma unroll
  for (int r = 0; r < kTileF4 / kChunk; ++r) {
    __stcs(dst + r * kChunk + threadIdx.x, s_out[r * kChunk + threadIdx.x]);
  }
}

struct Item {
  int chunk, tile, k, start, count;
};

// The work list as the ladder reads it: variant b the two tables, the
// others the five arrays.
struct WorkList {
  const int* chunk_of_item;
  const int* tile_of_item;
  const int* k_of_item;
  const int* starts;
  const int* counts;
  const int4* item4;
  const int2* seg2;
  long long n_items;
};

// One step of the walk: kPer items from `first` on, `n` of which exist, and
// for each the splats of the pairs whose feature pieces this thread stages
// (-1 for a pair outside the item's tile range).
template <int kPer>
struct Step {
  Item it[kPer];
  int splat[kPer][3];
  long long first;
  int n;
};

// A step's metadata comes in three dependent rounds of loads: the item
// (begin), its tile's range (range), the splats of this thread's pairs
// (splat).
template <int V, int kPer>
__device__ __forceinline__ void begin_step(const WorkList& wl, long long s, long long n_steps,
                                           Step<kPer>& st) {
  st.first = s * kPer;
  st.n = s < n_steps ? static_cast<int>(min(static_cast<long long>(kPer), wl.n_items - st.first))
                     : 0;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    if (q >= st.n) continue;
    const long long i = st.first + q;
    if (V == 1) {
      const int4 m = wl.item4[i];
      st.it[q].chunk = m.x;
      st.it[q].tile = m.y;
      st.it[q].k = m.z;
    } else {
      st.it[q].chunk = wl.chunk_of_item[i];
      st.it[q].tile = wl.tile_of_item[i];
      st.it[q].k = wl.k_of_item[i];
    }
  }
}

template <int V, int kPer>
__device__ __forceinline__ void range_step(const WorkList& wl, Step<kPer>& st) {
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    if (q >= st.n) continue;
    if (V == 1) {
      const int2 g = wl.seg2[st.it[q].tile];
      st.it[q].start = g.x;
      st.it[q].count = g.y;
    } else {
      st.it[q].start = wl.starts[st.it[q].tile];
      st.it[q].count = wl.counts[st.it[q].tile];
    }
  }
}

// pair j of item `it`'s chunk lies in the item's tile range
__device__ __forceinline__ bool holds(const Item& it, int j) {
  const int p = it.chunk * kChunk + j;
  return p >= it.start && p < it.start + it.count;
}

// A staged chunk is its pairs' feature rows end to end, 3 float4 pieces a
// pair. Thread t stages pieces t, t + kChunk, t + 2 kChunk: piece q is part
// q % 3 of pair q / 3, so a warp's copies cover whole 48-byte rows, ~11
// rows (two 32-byte sectors each) for 32 pieces.
__device__ __forceinline__ int piece(int r) { return static_cast<int>(threadIdx.x) + r * kChunk; }

template <int kPer>
__device__ __forceinline__ void splat_step(const int* __restrict__ pair_splat, Step<kPer>& st) {
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int j = piece(r) / 3;
      st.splat[q][r] =
          q < st.n && holds(st.it[q], j) ? pair_splat[st.it[q].chunk * kChunk + j] : -1;
    }
  }
}

// Start this thread's 16-byte copies of the step's pieces into `buf` (kPer
// staged chunks of kSlotF4 pieces).
template <int kPer>
__device__ __forceinline__ void stage_step(const float4* __restrict__ feats,
                                           const Step<kPer>& st, float4* buf) {
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      if (st.splat[q][r] >= 0) {
        cp_async16(buf + q * kSlotF4 + piece(r), feats + 3LL * st.splat[q][r] + piece(r) % 3);
      }
    }
  }
}

__device__ __forceinline__ double sum4(float4 a) {
  return (static_cast<double>(a.x) + a.y) + (static_cast<double>(a.z) + a.w);
}

// The block's sums of v[0..kPer), valid in thread 0. `scratch` alternates
// between two halves from one call to the next, so one barrier a call
// keeps a warp from overwriting what thread 0 has not read yet.
template <int kPer>
__device__ __forceinline__ void block_sums(double (&v)[kPer], double* scratch) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    for (int off = 16; off > 0; off >>= 1) v[q] += __shfl_down_sync(0xffffffffu, v[q], off);
    if (lane == 0) scratch[q * kWarps + warp] = v[q];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      double total = 0.0;
      for (int w = 0; w < kWarps; ++w) total += scratch[q * kWarps + w];
      v[q] = total;
    }
  }
}

// Variant V (0..4 = a..e). Block b walks steps b, b + grid, ...; a step is
// one item (two for e). While step s is summed and its tile zeroed, step
// s + grid's chunk is in flight into the other half of the double buffer,
// and step s + 2 grid's metadata is being read.
template <int V>
__global__ void __launch_bounds__(kChunk) grid_ladder_kernel(
    const float4* __restrict__ feats, const int* __restrict__ pair_splat, WorkList wl,
    float* __restrict__ out, double* __restrict__ checksum,
    unsigned long long* __restrict__ tile_writes) {
  constexpr int kPer = V == 4 ? 2 : 1;
  constexpr bool kStages = V != 2;
  // two buffers of kPer staged chunks, then (d) the shared copy of the tile
  extern __shared__ float4 smem[];
  __shared__ double s_red[2][kPer * kWarps];
  float4* s_out = smem + 2 * kPer * kSlotF4;

  const long long n_steps = (wl.n_items + kPer - 1) / kPer;
  const long long grid = gridDim.x;
  long long s = blockIdx.x;
  unsigned long long writes = 0;
  bool owns_tile0 = false;

  Step<kPer> cur, nxt, later;
  begin_step<V>(wl, s, n_steps, cur);
  range_step<V>(wl, cur);
  if (kStages) {
    splat_step(pair_splat, cur);
    stage_step(feats, cur, smem);
    cp_async_commit();
  }
  begin_step<V>(wl, s + grid, n_steps, nxt);
  range_step<V>(wl, nxt);
  if (kStages) splat_step(pair_splat, nxt);

  int buf = 0;
  for (; s < n_steps; s += grid) {
    if (kStages) {
      stage_step(feats, nxt, smem + (buf ^ 1) * kPer * kSlotF4);
      cp_async_commit();  // an empty group past the end keeps the count
    }
    begin_step<V>(wl, s + 2 * grid, n_steps, later);

    double acc[kPer];
    if (kStages) {
      cp_async_wait<1>();  // step s's copies of this thread have landed;
      // each thread sums only the pieces it staged
      const float4* slot = smem + buf * kPer * kSlotF4;
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        acc[q] = 0.0;
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          if (cur.splat[q][r] >= 0) acc[q] += sum4(slot[q * kSlotF4 + piece(r)]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      if (q >= cur.n || cur.it[q].k != 0) continue;
      if (V == 3) {
        zero_shared_tile(s_out);
        owns_tile0 |= cur.first + q == 0;  // the first item with k == 0
      } else {
        zero_tile(out, cur.it[q].tile);
        ++writes;
      }
    }
    range_step<V>(wl, later);
    if (V == 2) {
      acc[0] = __syncthreads_count(holds(cur.it[0], static_cast<int>(threadIdx.x)));
    } else {
      block_sums<kPer>(acc, s_red[buf]);
    }
    if (kStages) splat_step(pair_splat, later);
    if (threadIdx.x == 0) {
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        if (q < cur.n) checksum[cur.first + q] = acc[q];
      }
    }
    cur = nxt;
    nxt = later;
    buf ^= 1;
  }
  if (V == 3 && owns_tile0) {  // tile 0's one write to global memory
    __syncthreads();
    write_tile(out, 0, s_out);
    ++writes;
  }
  if (tile_writes != nullptr && threadIdx.x == 0 && writes > 0) atomicAdd(tile_writes, writes);
}

// Dynamic shared memory of variant V: two buffers of staged chunks (none
// for c), and for d the shared copy of the output tile.
constexpr size_t ladder_smem(int v) {
  return (v == 2 ? 0 : 2 * (v == 4 ? 2 : 1) * kSlotF4 * sizeof(float4)) +
         (v == 3 ? kTileF4 * sizeof(float4) : 0);
}

// Variant V's grid for n_items: as many blocks as the card holds at once,
// at most one per step.
template <int V>
cudaError_t ladder_grid(long long n_items, int* grid) {
  constexpr size_t smem = ladder_smem(V);
  cudaError_t err = cudaFuncSetAttribute(grid_ladder_kernel<V>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, grid_ladder_kernel<V>, kChunk,
                                                        smem);
  }
  if (err != cudaSuccess) return err;
  const long long per = V == 4 ? 2 : 1;
  const long long steps = (n_items + per - 1) / per;
  const long long resident = static_cast<long long>(per_sm) * sms;
  *grid = static_cast<int>(steps < resident ? steps : resident);
  return *grid > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

template <int V>
cudaError_t launch_ladder(const float4* feats, const int* pair_splat, const WorkList& wl,
                          float* out, double* checksum, unsigned long long* tile_writes,
                          cudaStream_t stream) {
  int grid = 0;
  const cudaError_t err = ladder_grid<V>(wl.n_items, &grid);
  if (err != cudaSuccess) return err;
  grid_ladder_kernel<V><<<grid, kChunk, ladder_smem(V), stream>>>(feats, pair_splat, wl, out,
                                                                  checksum, tile_writes);
  return cudaGetLastError();
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

// variant 0..4 = a..e; tile_writes: null, or a zeroed counter to which the
// launch adds its writes of output tiles to global memory.
int gg_grid_ladder(const float* feats, const int* pair_splat, const int* chunk_of_item,
                   const int* tile_of_item, const int* k_of_item, const int* starts,
                   const int* counts, const int* item4, const int* seg2, float* out,
                   double* checksum, unsigned long long* tile_writes, long long n_items,
                   int variant, void* stream) {
  if (n_items <= 0) return static_cast<int>(cudaGetLastError());
  const WorkList wl{chunk_of_item, tile_of_item, k_of_item, starts, counts,
                    reinterpret_cast<const int4*>(item4), reinterpret_cast<const int2*>(seg2),
                    n_items};
  const float4* f = reinterpret_cast<const float4*>(feats);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (variant) {
    case 0: err = launch_ladder<0>(f, pair_splat, wl, out, checksum, tile_writes, s); break;
    case 1: err = launch_ladder<1>(f, pair_splat, wl, out, checksum, tile_writes, s); break;
    case 2: err = launch_ladder<2>(f, pair_splat, wl, out, checksum, tile_writes, s); break;
    case 3: err = launch_ladder<3>(f, pair_splat, wl, out, checksum, tile_writes, s); break;
    case 4: err = launch_ladder<4>(f, pair_splat, wl, out, checksum, tile_writes, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// Writes to *grid the blocks gg_grid_ladder launches for variant `variant`
// over n_items; launches nothing.
int gg_grid_ladder_grid(long long n_items, int variant, int* grid) {
  cudaError_t err;
  switch (variant) {
    case 0: err = ladder_grid<0>(n_items, grid); break;
    case 1: err = ladder_grid<1>(n_items, grid); break;
    case 2: err = ladder_grid<2>(n_items, grid); break;
    case 3: err = ladder_grid<3>(n_items, grid); break;
    case 4: err = ladder_grid<4>(n_items, grid); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

const char* gg_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
