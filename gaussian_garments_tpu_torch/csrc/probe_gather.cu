// Gather probes for NVIDIA Hopper (sm_90a): is a table held on chip faster
// than a gather through L2?
//
// Replaces the TPU probe kernels
//   `kern`  scripts/profile_pallas_gather.py:42   (flat gather, table in VMEM)
//   `kernA` scripts/profile_pallas_gather2.py:46  (take_along_axis, axis 0)
//   `kernB` scripts/profile_pallas_gather2.py:72  (take_along_axis, axis 1)
//   `kernC` scripts/profile_pallas_gather2.py:98  (flat gather as row fetch +
//           one-hot lane select; the one-hot matmul works around Mosaic and
//           is not carried over: it is the flat gather at C's shape)
//   `kern`  scripts/profile_pallas_gather3.py:54  (flat gather as two
//           dynamic_gathers; again the flat gather, at its shape)
//
// Kernels:
//   gather_flat_l2      out[p] = table[idx[p]] through L2: as many 256-thread
//                       blocks as the card holds at once stride over the
//                       int4 groups of the index stream; each thread loads
//                       kL2Vec groups (streaming, __ldcs), makes all their
//                       table reads (__ldg) before it stores one float4 a
//                       group (streaming, __stcs), so the 606-655 KB table
//                       keeps its place in the 50 MB L2. A ragged last group
//                       goes through the valid-first Group helper that
//                       gather_flat_cluster shares. The indices must be
//                       16-byte aligned (the wrapper raises otherwise).
//   gather_flat_cluster the counterpart of the VMEM-resident table: each
//                       thread block cluster of C blocks (C = 4, 8 or 16, a
//                       template parameter; 16 is a non-portable size) holds
//                       the table in its blocks' dynamic shared memory and
//                       gathers through distributed shared memory. The
//                       layout interleaves the table's float4 groups over the
//                       ranks: entry j lies in rank (j >> 2) & (C - 1) at
//                       float offset ((j >> (2 + log2 C)) << 2) | (j & 3), so
//                       owner and offset are shifts and masks, every rank
//                       holds an equal slice (a power-of-two padded
//                       contiguous slice would leave 3 of 8 or 6 of 16 ranks
//                       empty, and the reads on the others), and a block
//                       stages its slice with float4 loads of every C-th
//                       group. Blocks of 1,024 threads, as many clusters as
//                       cudaOccupancyMaxActiveClusters allows (two blocks an
//                       SM where the slice fits twice, C >= 8). The index
//                       stream is cut into units of `blk` indices (the TPU
//                       scripts' block), dealt to the clusters in turn; in a
//                       cluster's units each thread takes two int4 groups of
//                       indices a step, loaded streaming (__ldcs), makes
//                       their 8 remote reads before it uses one, and stores
//                       two float4s streaming (__stcs). The cluster barrier
//                       is split: a block arrives when its slice is staged
//                       and loads its first indices before it waits, and
//                       arrives and waits again before it exits, since no
//                       block may leave while another reads its slice.
//                       mode 1 skips the staging: the same gathers from
//                       unstaged shared memory (values undefined), to time
//                       the gathers alone.
//   gather_axis0/1      out[e,j] = tab[idx[e,j], j] and out[r,k] = tab[r,
//                       idx[r,k]], one thread per output, in blocks of 256.
//   launch_floor        an empty kernel: what a launch costs in the same
//                       call, the floor the axis gathers are judged against.
//
// The axis gathers and launch_floor are launched with programmatic stream
// serialization (Hopper's programmatic dependent launch): each waits on the
// grid before it (griddepcontrol.wait) before its first global read, and
// lets the next one launch (griddepcontrol.launch_dependents) after its
// store.
//
// What bounds them on this card: bytes. The indices are read and the output
// written once (8 B an element) at 3.35 TB/s; the table is read once from
// device memory and then from L2 or shared memory. A random 4-byte read
// from L2 moves a 32-byte sector, so the L2 variant is bound by the rate at
// which L2 serves scattered sectors long before HBM (the probe also times
// it with the table in an L2 persisting window); the cluster variant replaces those sectors by
// distributed-shared-memory reads over the SM-to-SM network, and pays for
// staging the table into each cluster (one copy of it per cluster, from
// L2). Rows 4A and 4B move under 1.2 MB (4A 1,130,496 B, 0.34 us at 3.35
// TB/s; 4B 671,744 B, 0.20 us), less than a launch costs on this card: what
// bounds them is the launch (timed beside them as launch_floor, at one block
// and at their grid) plus the latency of one dependent chain: an index load,
// a scattered table read (one 32-byte L2 sector each; 4A's 65,536 take >=
// 0.59 us at the ~112 G sectors/s that gather_flat_l2 reaches) and a store.
// Since the launch is most of their time, they are launched with
// programmatic dependent launch, which overlaps a launch with the end of the
// kernel before it. A vectorised body (one int4 group of outputs a thread,
// no 64-bit division, every read before the store) took as long or 0.1-0.2
// us longer under the same launch, so the one-thread-per-output body stays.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kClusterThreads = 1024;  // a cluster block's threads
constexpr int kVec = 2;                // int4 index groups a cluster thread has in flight
constexpr int kL2Vec = 2;              // int4 index groups an L2 thread has in flight

__device__ __forceinline__ unsigned cluster_ctarank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ unsigned cluster_id() {
  unsigned r;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return r;
}
__device__ __forceinline__ unsigned cluster_count() {
  unsigned r;
  asm volatile("mov.u32 %0, %%nclusterid.x;" : "=r"(r));
  return r;
}
// arrive releases this thread's earlier writes to the cluster; wait acquires
// every other thread's
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

// The float at shared::cta address `addr` of block `rank` of the cluster.
__device__ __forceinline__ float load_dsmem(unsigned addr, unsigned rank) {
  unsigned remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

// Programmatic dependent launch: wait until the grid before this one has
// completed and its writes are visible / let the grid after this one launch.
// Both do nothing in a kernel launched without programmatic stream
// serialization.
__device__ __forceinline__ void wait_prior_grid() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// One int4 group of the index stream: its indices (valid ones first) and
// how many of them lie before n; g < 0 for none.
struct Group {
  int4 j;
  int g, count;
};

__device__ __forceinline__ Group load_group(const int* __restrict__ idx, int n, int g) {
  Group r{make_int4(0, 0, 0, 0), g, 0};
  if (g < 0) return r;
  const int first = 4 * g;
  r.count = min(4, n - first);
  if (r.count == 4) {
    r.j = __ldcs(reinterpret_cast<const int4*>(idx) + g);
  } else {
    r.j.x = idx[first];
    if (r.count > 1) r.j.y = idx[first + 1];
    if (r.count > 2) r.j.z = idx[first + 2];
  }
  return r;
}

// Store group `grp`'s values: one streaming float4, or its first count floats.
__device__ __forceinline__ void store_group(float* __restrict__ out, const Group& grp,
                                            float4 val) {
  const int c = grp.count;
  if (c == 4) {
    __stcs(reinterpret_cast<float4*>(out) + grp.g, val);
  } else if (c > 0) {
    float* o = out + 4 * grp.g;
    o[0] = val.x;
    if (c > 1) o[1] = val.y;
    if (c > 2) o[2] = val.z;
  }
}

// grid-stride over the int4 groups of the index stream: each thread takes
// the groups g, g + stride, ... kL2Vec at a time (launched with as many
// blocks as the card holds at once)
__global__ void __launch_bounds__(kThreads) gather_flat_l2_kernel(
    const float* __restrict__ table, const int* __restrict__ idx, float* __restrict__ out,
    int n) {
  const int n4 = (n + 3) >> 2;
  const int stride = static_cast<int>(gridDim.x * blockDim.x);
  for (int g = static_cast<int>(blockIdx.x * blockDim.x + threadIdx.x); g < n4;
       g += kL2Vec * stride) {
    Group grp[kL2Vec];
#pragma unroll
    for (int v = 0; v < kL2Vec; ++v) {
      const int gv = g + v * stride;
      grp[v] = load_group(idx, n, gv < n4 ? gv : -1);
    }
    float4 val[kL2Vec];
#pragma unroll
    for (int v = 0; v < kL2Vec; ++v) {  // every table read before the first store
      val[v].x = grp[v].count > 0 ? __ldg(table + grp[v].j.x) : 0.0f;
      val[v].y = grp[v].count > 1 ? __ldg(table + grp[v].j.y) : 0.0f;
      val[v].z = grp[v].count > 2 ? __ldg(table + grp[v].j.z) : 0.0f;
      val[v].w = grp[v].count > 3 ? __ldg(table + grp[v].j.w) : 0.0f;
    }
#pragma unroll
    for (int v = 0; v < kL2Vec; ++v) store_group(out, grp[v], val[v]);
  }
}

template <int kShift>
__device__ __forceinline__ float gather_one(unsigned base, int j) {
  constexpr int kMask = (1 << kShift) - 1;
  const unsigned owner = static_cast<unsigned>(j >> 2) & kMask;
  const unsigned offset = ((static_cast<unsigned>(j) >> (2 + kShift)) << 2) | (j & 3);
  return load_dsmem(base + 4u * offset, owner);
}

// launched as clusters of C = 1 << kShift blocks of kClusterThreads threads
// (cudaLaunchKernelEx); the dynamic shared memory holds ceil(ceil(table_size
// / 4) / C) float4 groups
template <int kShift>
__global__ void __launch_bounds__(kClusterThreads, kShift >= 3 ? 2 : 1)
    gather_flat_cluster_kernel(const float* __restrict__ table, int table_size,
                               const int* __restrict__ idx, float* __restrict__ out, int n,
                               int blk, int mode) {
  constexpr int C = 1 << kShift;
  extern __shared__ float4 s_slice[];
  const unsigned rank = cluster_ctarank();
  if (mode == 0) {
    const int groups = (table_size + 3) >> 2;
    const int slots = (groups + C - 1) >> kShift;
    for (int s = threadIdx.x; s < slots; s += blockDim.x) {
      const int q = (s << kShift) + static_cast<int>(rank);
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (4 * q + 3 < table_size) {
        v = __ldg(reinterpret_cast<const float4*>(table) + q);
      } else if (q < groups) {
        v.x = table[4 * q];
        if (4 * q + 1 < table_size) v.y = table[4 * q + 1];
        if (4 * q + 2 < table_size) v.z = table[4 * q + 2];
      }
      s_slice[s] = v;
    }
  }
  cluster_arrive();  // this block's slice is staged

  // this cluster's int4 groups of the index stream: units u = cid, cid + nc,
  // ... of blk / 4 groups each, laid end to end; the cluster's threads take
  // the local positions k = tc, tc + stride, ... kVec at a time
  const int n4 = (n + 3) >> 2;
  const int unit4 = blk >> 2;
  const int n_units = (n4 + unit4 - 1) / unit4;
  const int cid = static_cast<int>(cluster_id());
  const int nc = static_cast<int>(cluster_count());
  const int local4 = cid < n_units ? ((n_units - 1 - cid) / nc + 1) * unit4 : 0;
  const int stride = C * static_cast<int>(blockDim.x);
  const int tc = static_cast<int>(rank * blockDim.x + threadIdx.x);
  auto group_at = [&](int k) {
    if (k >= local4) return -1;
    const int u = k / unit4;
    const int g = (cid + u * nc) * unit4 + (k - u * unit4);
    return g < n4 ? g : -1;
  };
  const unsigned base = static_cast<unsigned>(__cvta_generic_to_shared(s_slice));

  int k = tc;
  Group grp[kVec];
#pragma unroll
  for (int v = 0; v < kVec; ++v) grp[v] = load_group(idx, n, group_at(k + v * stride));
  cluster_wait();  // every block's slice is staged
  while (true) {
    float4 val[kVec];
#pragma unroll
    for (int v = 0; v < kVec; ++v) {  // all remote reads before the first use
      val[v].x = grp[v].count > 0 ? gather_one<kShift>(base, grp[v].j.x) : 0.0f;
      val[v].y = grp[v].count > 1 ? gather_one<kShift>(base, grp[v].j.y) : 0.0f;
      val[v].z = grp[v].count > 2 ? gather_one<kShift>(base, grp[v].j.z) : 0.0f;
      val[v].w = grp[v].count > 3 ? gather_one<kShift>(base, grp[v].j.w) : 0.0f;
    }
#pragma unroll
    for (int v = 0; v < kVec; ++v) store_group(out, grp[v], val[v]);
    k += kVec * stride;
    if (k >= local4) break;
#pragma unroll
    for (int v = 0; v < kVec; ++v) grp[v] = load_group(idx, n, group_at(k + v * stride));
  }
  cluster_arrive();  // this block reads no other slice any more
  cluster_wait();    // and no other block reads this one
}

__global__ void __launch_bounds__(kThreads) gather_axis0_kernel(
    const float* __restrict__ tab, const int* __restrict__ idx, float* __restrict__ out,
    int rows_out, int cols) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(rows_out) * cols) return;
  const int j = static_cast<int>(i % cols);
  wait_prior_grid();
  out[i] = __ldg(tab + static_cast<long long>(__ldg(idx + i)) * cols + j);
  launch_dependents();
}

__global__ void __launch_bounds__(kThreads) gather_axis1_kernel(
    const float* __restrict__ tab, const int* __restrict__ idx, float* __restrict__ out,
    int rows, int len, int k) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(rows) * k) return;
  const long long r = i / k;
  wait_prior_grid();
  out[i] = __ldg(tab + r * len + __ldg(idx + i));
  launch_dependents();
}

// No work: the cost of a launch.
__global__ void launch_floor_kernel() {
  wait_prior_grid();
  launch_dependents();
}

template <typename T>
struct Same {
  using type = T;
};

// Launch `kernel` on `stream` with programmatic stream serialization. The
// arguments take the kernel's parameter types; the trailing null keeps the
// argument array non-empty for a kernel without parameters.
template <typename... Params>
cudaError_t launch_pdl(void (*kernel)(Params...), dim3 grid, dim3 block, cudaStream_t stream,
                       typename Same<Params>::type... args) {
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = block;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  void* arg_ptrs[] = {static_cast<void*>(&args)..., nullptr};
  return cudaLaunchKernelExC(&config, reinterpret_cast<const void*>(kernel), arg_ptrs);
}

int blocks_for(long long n) { return static_cast<int>((n + kThreads - 1) / kThreads); }

// gather_flat_l2_kernel's grid for n indices: as many blocks as the card
// holds at once, and no more than one thread per int4 group needs.
cudaError_t l2_grid(int n, int* grid) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gather_flat_l2_kernel, kThreads, 0);
  }
  if (err != cudaSuccess) return err;
  const int needed = blocks_for((static_cast<long long>(n) + 3) / 4);
  const int resident = per_sm * sms;
  *grid = needed < resident ? needed : resident;
  return *grid > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

// Sets up the launch of gather_flat_cluster_kernel<kShift> for a table of
// table_size entries: shared memory, cluster size, one cluster's grid; and
// `max_clusters`, how many such clusters the card holds at once (0 if none
// fits).
template <int kShift>
cudaError_t cluster_config(int table_size, cudaLaunchConfig_t* config, cudaLaunchAttribute* attr,
                           int* max_clusters) {
  constexpr int C = 1 << kShift;
  const int slots = ((table_size + 3) / 4 + C - 1) / C;
  const size_t smem = static_cast<size_t>(slots) * sizeof(float4);
  cudaError_t err = cudaFuncSetAttribute(gather_flat_cluster_kernel<kShift>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (C > 8) {
    err = cudaFuncSetAttribute(gather_flat_cluster_kernel<kShift>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  *config = {};
  config->gridDim = dim3(C);
  config->blockDim = dim3(kClusterThreads);
  config->dynamicSmemBytes = smem;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config->attrs = attr;
  config->numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(max_clusters, gather_flat_cluster_kernel<kShift>, config);
}

template <int kShift>
cudaError_t launch_cluster(const float* table, const int* idx, float* out, int n, int table_size,
                           int blk, int mode, cudaStream_t stream) {
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr[1];
  int max_clusters = 0;
  cudaError_t err = cluster_config<kShift>(table_size, &config, attr, &max_clusters);
  if (err != cudaSuccess) return err;
  if (max_clusters < 1) return cudaErrorInvalidConfiguration;
  const int units = ((n + 3) / 4 + blk / 4 - 1) / (blk / 4);
  const int clusters = units < max_clusters ? units : max_clusters;
  config.gridDim = dim3(clusters << kShift);
  config.stream = stream;
  return cudaLaunchKernelEx(&config, gather_flat_cluster_kernel<kShift>, table, table_size, idx,
                            out, n, blk, mode);
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError().

// idx 16-byte aligned, n < 2^31 (the wrapper checks both).
int gg_gather_flat_l2(const float* table, const int* idx, float* out, int n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  int grid = 0;
  const cudaError_t err = l2_grid(n, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_flat_l2_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(table, idx,
                                                                                 out, n);
  return static_cast<int>(cudaGetLastError());
}

// Writes to *grid the blocks gg_gather_flat_l2 launches for n indices;
// launches nothing.
int gg_gather_l2_grid(int n, int* grid) { return static_cast<int>(l2_grid(n, grid)); }

// cluster: 4, 8 or 16 blocks; blk: a positive multiple of 4; table and idx
// 16-byte aligned; n < 2^31 (the wrapper checks all of these).
int gg_gather_flat_cluster(const float* table, const int* idx, float* out, int n,
                           int table_size, int cluster, int blk, int mode, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (cluster) {
    case 4: err = launch_cluster<2>(table, idx, out, n, table_size, blk, mode, s); break;
    case 8: err = launch_cluster<3>(table, idx, out, n, table_size, blk, mode, s); break;
    case 16: err = launch_cluster<4>(table, idx, out, n, table_size, blk, mode, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Writes to *clusters how many clusters of `cluster` blocks the card holds at
// once for a table of table_size entries (what gg_gather_flat_cluster
// launches at most); launches nothing.
int gg_gather_cluster_grid(int table_size, int cluster, int* clusters) {
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr[1];
  cudaError_t err;
  switch (cluster) {
    case 4: err = cluster_config<2>(table_size, &config, attr, clusters); break;
    case 8: err = cluster_config<3>(table_size, &config, attr, clusters); break;
    case 16: err = cluster_config<4>(table_size, &config, attr, clusters); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Sets (bytes > 0) or clears (bytes == 0) an L2 persisting access-policy
// window over [base, base + bytes) on `stream`, with the persisting L2 set
// aside to match; a clear also resets the lines already persisting. For the
// probe's timing of gather_flat_l2 both ways; no kernel reads it.
int gg_l2_persisting_window(void* stream, const void* base, long long bytes) {
  cudaError_t err = cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, static_cast<size_t>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStreamAttrValue v = {};
  v.accessPolicyWindow.base_ptr = const_cast<void*>(base);
  v.accessPolicyWindow.num_bytes = static_cast<size_t>(bytes);
  v.accessPolicyWindow.hitRatio = bytes > 0 ? 1.0f : 0.0f;
  v.accessPolicyWindow.hitProp = cudaAccessPropertyPersisting;
  v.accessPolicyWindow.missProp = cudaAccessPropertyStreaming;
  err = cudaStreamSetAttribute(static_cast<cudaStream_t>(stream),
                               cudaStreamAttributeAccessPolicyWindow, &v);
  if (err == cudaSuccess && bytes == 0) err = cudaCtxResetPersistingL2Cache();
  return static_cast<int>(err);
}

int gg_gather_axis0(const float* tab, const int* idx, float* out, int rows_out, int cols,
                    void* stream) {
  const long long n = static_cast<long long>(rows_out) * cols;
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const cudaError_t err = launch_pdl(gather_axis0_kernel, dim3(blocks_for(n)), dim3(kThreads),
                                     static_cast<cudaStream_t>(stream), tab, idx, out,
                                     rows_out, cols);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

int gg_gather_axis1(const float* tab, const int* idx, float* out, int rows, int len, int k,
                    void* stream) {
  const long long n = static_cast<long long>(rows) * k;
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const cudaError_t err = launch_pdl(gather_axis1_kernel, dim3(blocks_for(n)), dim3(kThreads),
                                     static_cast<cudaStream_t>(stream), tab, idx, out, rows,
                                     len, k);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// `blocks` blocks of `threads` threads of the empty kernel, launched as the
// axis gathers are.
int gg_launch_floor(int blocks, int threads, void* stream) {
  const cudaError_t err = launch_pdl(launch_floor_kernel, dim3(blocks), dim3(threads),
                                     static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* gg_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
