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
//   gather_flat_l2      out[p] = table[idx[p]], one thread per index, the
//                       table read through __ldg. At 606-655 KB the table
//                       stays in the 50 MB L2 after the first touch.
//   gather_flat_cluster the counterpart of the VMEM-resident table: a thread
//                       block cluster of 4 stages the table across its 4
//                       blocks' dynamic shared memory (a quarter each, at
//                       most 163,840 B a block), then every block gathers
//                       through distributed shared memory
//                       (cluster.map_shared_rank). 33 clusters (132 blocks,
//                       one an SM) walk over the index blocks. mode 1 skips
//                       the staging: the same gathers from unstaged shared
//                       memory (values undefined), to time the gather alone.
//   gather_axis0/1      out[e,j] = tab[idx[e,j], j] and out[r,k] = tab[r,
//                       idx[r,k]], one thread per output.
//
// What bounds them on this card: bytes. The indices are read and the output
// written once (8 B an element) at 3.35 TB/s; the table is read once from
// device memory and then from L2 or shared memory. A random 4-byte read
// from L2 moves a 32-byte sector, so the L2 variant is bound by L2 sector
// throughput long before HBM; the cluster variant replaces those sectors by
// distributed-shared-memory reads over the SM-to-SM network, and pays for
// staging the table into each cluster (33 copies of it). Rows 4A and 4B
// move under 1.2 MB: they sit at launch latency.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kClusterSize = 4;

__global__ void __launch_bounds__(kThreads) gather_flat_l2_kernel(
    const float* __restrict__ table, const int* __restrict__ idx, float* __restrict__ out,
    long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = __ldg(table + __ldg(idx + i));
  }
}

// launched as clusters of kClusterSize blocks (cudaLaunchKernelEx)
__global__ void __launch_bounds__(kThreads) gather_flat_cluster_kernel(
    const float* __restrict__ table, const int* __restrict__ idx, float* __restrict__ out,
    long long n, int table_size, int slice, long long blk, int mode) {
  extern __shared__ float s_table[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  if (mode == 0) {
    const int lo = rank * slice;
    const int hi = lo + slice < table_size ? lo + slice : table_size;
    for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) s_table[i - lo] = table[i];
  }
  cluster.sync();  // every block's quarter is staged before anyone reads it

  float* parts[kClusterSize];
#pragma unroll
  for (int r = 0; r < kClusterSize; ++r) parts[r] = cluster.map_shared_rank(s_table, r);

  const long long n_blocks = (n + blk - 1) / blk;
  for (long long b = blockIdx.x; b < n_blocks; b += gridDim.x) {
    const long long end = (b + 1) * blk < n ? (b + 1) * blk : n;
    for (long long i = b * blk + threadIdx.x; i < end; i += blockDim.x) {
      const int j = __ldg(idx + i);
      const int owner = j / slice;
      out[i] = parts[owner][j - owner * slice];
    }
  }
  cluster.sync();  // no block leaves while another may still read its table
}

__global__ void __launch_bounds__(kThreads) gather_axis0_kernel(
    const float* __restrict__ tab, const int* __restrict__ idx, float* __restrict__ out,
    int rows_out, int cols) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(rows_out) * cols) return;
  const int j = static_cast<int>(i % cols);
  out[i] = __ldg(tab + static_cast<long long>(__ldg(idx + i)) * cols + j);
}

__global__ void __launch_bounds__(kThreads) gather_axis1_kernel(
    const float* __restrict__ tab, const int* __restrict__ idx, float* __restrict__ out,
    int rows, int len, int k) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(rows) * k) return;
  const long long r = i / k;
  out[i] = __ldg(tab + r * len + __ldg(idx + i));
}

int blocks_for(long long n) { return static_cast<int>((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError().

int gg_gather_flat_l2(const float* table, const int* idx, float* out, long long n,
                      void* stream) {
  if (n > 0) {
    const int grid = blocks_for(n) < 132 * 16 ? blocks_for(n) : 132 * 16;
    gather_flat_l2_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        table, idx, out, n);
  }
  return static_cast<int>(cudaGetLastError());
}

int gg_gather_flat_cluster(const float* table, const int* idx, float* out, long long n,
                           int table_size, int n_clusters, long long blk, int mode,
                           void* stream) {
  const int slice = (table_size + kClusterSize - 1) / kClusterSize;
  const size_t smem = static_cast<size_t>(slice) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gather_flat_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(n_clusters * kClusterSize);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kClusterSize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, gather_flat_cluster_kernel, table, idx, out, n, table_size,
                           slice, blk, mode);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

int gg_gather_axis0(const float* tab, const int* idx, float* out, int rows_out, int cols,
                    void* stream) {
  const long long n = static_cast<long long>(rows_out) * cols;
  if (n > 0) {
    gather_axis0_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        tab, idx, out, rows_out, cols);
  }
  return static_cast<int>(cudaGetLastError());
}

int gg_gather_axis1(const float* tab, const int* idx, float* out, int rows, int len, int k,
                    void* stream) {
  const long long n = static_cast<long long>(rows) * k;
  if (n > 0) {
    gather_axis1_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        tab, idx, out, rows, len, k);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* gg_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
