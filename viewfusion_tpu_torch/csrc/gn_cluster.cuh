// What K1 (groupnorm.cu) and K2 (groupnorm_bwd.cu) share: one
// thread-block cluster per sample, each block staging its contiguous
// range of the sample's rows into shared memory with 1-D bulk copies,
// per-channel partial sums pushed to every block of the cluster through
// distributed shared memory (DSMEM), and the launch of such clusters.
//
// The work plan (cluster size, rows per block, rows staged, chunk rows,
// threads, dynamic shared memory, vector width) is made in Python
// (viewfusion_tpu_torch/ops/groupnorm.py: group_norm_plan); the C
// entries only validate it (gn_check_plan).  Dynamic shared memory:
//   [kBarBytes: one mbarrier per chunk]
//   [stage: rows_staged rows of each of n_tensors tensors, 16-aligned]
//   [red: threads * VEC f32, the threads' sums, folded per channel]
//   [gather: cluster * 2 * C f32, every block's per-channel sums, each
//    written by its block through DSMEM]
//   [csum: 2 * C f32, the sample's per-channel sums]
//   [gstat: 2 * C f32 (2 * G used), per-group values]
#pragma once

#include <cooperative_groups.h>

#include <initializer_list>
#include <map>
#include <mutex>
#include <set>
#include <tuple>

#include "common.cuh"
#include "tma.cuh"

namespace vf {

constexpr int kSmemBytes = 232448;  // dynamic shared memory of one block
constexpr int kMaxChunks = kBarBytes / 8;  // one 8-byte mbarrier each
constexpr int kMaxThreads = 512;

struct GnPlan {
  int cluster, rows_per_block, rows_staged, chunk_rows, threads, smem, vec;
};

inline size_t gn_stage_bytes(const GnPlan& p, int C, int itemsize,
                             int n_tensors) {
  const size_t bytes = static_cast<size_t>(p.rows_staged) * C * itemsize *
                       n_tensors;
  return (bytes + 15) / 16 * 16;
}

inline size_t gn_smem_bytes(const GnPlan& p, int C, int itemsize,
                            int n_tensors) {
  return kBarBytes + gn_stage_bytes(p, C, itemsize, n_tensors) +
         4 * static_cast<size_t>(p.threads) * p.vec +
         8 * static_cast<size_t>(C) * (p.cluster + 2);
}

// The plan must cover every row of a sample, stage whole chunks of
// multiples of the rows one sweep of the block covers, and fit the
// block's shared memory.  `ptrs` are the tensors read or written as
// vectors of p.vec elements.
inline bool gn_check_plan(const GnPlan& p, int B, int L, int C, int G,
                          int itemsize, int n_tensors,
                          std::initializer_list<const void*> ptrs) {
  if (B < 1 || B > 65535 || L < 1 || C < 1 || G < 1 || C % G) return false;
  if (!(p.vec == 1 || p.vec == 2 || p.vec == 4 || p.vec == 8) ||
      p.vec * itemsize > 16 || C % p.vec)
    return false;
  for (const void* q : ptrs)
    if (!aligned(q, p.vec * itemsize)) return false;
  const int nv = C / p.vec;
  if (p.threads < nv || p.threads > kMaxThreads || p.threads % nv) return false;
  const int rpi = p.threads / nv;
  if (!(p.cluster == 1 || p.cluster == 2 || p.cluster == 4 ||
        p.cluster == 8 || p.cluster == 16))
    return false;
  if (p.rows_per_block < 1 ||
      static_cast<long long>(p.cluster) * p.rows_per_block < L)
    return false;
  if (p.rows_staged < 0 || p.rows_staged > p.rows_per_block ||
      p.chunk_rows < 1 || p.chunk_rows % rpi ||
      (p.rows_staged + p.chunk_rows - 1) / p.chunk_rows > kMaxChunks)
    return false;
  return p.smem <= kSmemBytes &&
         static_cast<size_t>(p.smem) >= gn_smem_bytes(p, C, itemsize,
                                                      n_tensors);
}

// How many clusters of the plan's shape the card holds at once
// (cudaOccupancyMaxActiveClusters), asked once per kernel and shape; the
// kernel is allowed all of a block's shared memory, and clusters of 16,
// the first time it is seen.
template <typename Kernel>
int gn_active_clusters(Kernel kernel, const GnPlan& p, int* active) {
  static std::mutex mu;
  static std::set<const void*> prepared;
  static std::map<std::tuple<const void*, int, int, int>, int> seen;
  const void* key = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> lock(mu);
  if (!prepared.count(key)) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    prepared.insert(key);
  }
  const auto shape = std::make_tuple(key, p.cluster, p.threads, p.smem);
  const auto it = seen.find(shape);
  if (it == seen.end()) {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p.cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(p.cluster, 1);
    cfg.blockDim = dim3(p.threads);
    cfg.dynamicSmemBytes = p.smem;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    const cudaError_t err = cudaOccupancyMaxActiveClusters(&n, key, &cfg);
    if (err != cudaSuccess) return err;
    seen[shape] = n;
  }
  *active = seen[shape];
  return cudaSuccess;
}

// Launch `kernel` on a (cluster, B) grid in clusters of p.cluster blocks
// along x, one cluster per sample.  A plan the card cannot schedule
// returns cudaErrorInvalidConfiguration and launches nothing.
template <typename... Params, typename... Args>
int gn_launch(void (*kernel)(Params...), const GnPlan& p, int B,
              cudaStream_t stream, Args... args) {
  int active = 0;
  const int err = gn_active_clusters(kernel, p, &active);
  if (err != cudaSuccess) return err;
  if (active < 1) return cudaErrorInvalidConfiguration;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(p.cluster, B);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// ----------------------------------------------------------------- device

// Starts the bulk copies of the block's first `staged` rows of each
// tensor src[t] (rows of C elements) into dst[t], in chunks of
// `chunk_rows` rows, chunk k completing on bars[k]: thread 0 initialises
// the barriers, and lane k of warp 0 starts chunk k.  Called by all
// threads (it synchronises the block).
template <typename T, int N>
__device__ void stage_rows(uint64_t* bars, T* const (&dst)[N],
                           const T* const (&src)[N], int staged,
                           int chunk_rows, int C) {
  const int nchunks = (staged + chunk_rows - 1) / chunk_rows;
  if (threadIdx.x == 0) {
    for (int k = 0; k < nchunks; ++k) mbar_init(&bars[k], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x < nchunks) {
    const int k = threadIdx.x;
    const size_t off = static_cast<size_t>(k) * chunk_rows * C;
    const uint32_t bytes = static_cast<uint32_t>(
        min(chunk_rows, staged - k * chunk_rows) * C * sizeof(T));
    mbar_expect(&bars[k], N * bytes);
#pragma unroll
    for (int t = 0; t < N; ++t)
      bulk_load(dst[t] + off, src[t] + off, bytes, &bars[k]);
  }
}

// Every block's per-channel sums of its threads' a1 and a2 (VEC channels
// from lane_c * VEC, rows r0 + j * rpi) into every block's
// gather[cluster][2 * C]: the block folds its threads' sums over rows in
// a fixed order (rows of one warp by a lane-shuffle butterfly where a
// warp holds whole rows, then warps in order through red) and stores the
// 2 * C results into its rank's slot of each block's gather through
// DSMEM; then the cluster barrier, after which every slot is in place.
template <int VEC>
__device__ void push_block_sums(const float (&a1)[VEC],
                                const float (&a2)[VEC], float* red,
                                float* gather, int C, int r0, int lane_c,
                                int rpi) {
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int n = static_cast<int>(cluster.num_blocks());
  float* slot = gather + 2 * C * static_cast<int>(cluster.block_rank());
  const int nv = C / VEC;
  const int rows_w =  // rows of a warp, folded by shuffles
      nv < 32 && 32 % nv == 0 && blockDim.x % 32 == 0 ? 32 / nv : 1;
  for (int s = 0; s < 2; ++s) {
    float v[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = s == 0 ? a1[i] : a2[i];
    for (int off = nv; rows_w > 1 && off < 32; off *= 2)
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        v[i] += __shfl_xor_sync(0xffffffffu, v[i], off);
    if (r0 % rows_w == 0)
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        red[r0 / rows_w * C + lane_c * VEC + i] = v[i];
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      float t = 0.f;
      for (int j = 0; j < rpi / rows_w; ++j) t += red[j * C + c];
      for (int q = 0; q < n; ++q)
        cluster.map_shared_rank(slot, q)[s * C + c] = t;
    }
    __syncthreads();
  }
  cluster.sync();
}

// Element e (< 2 * C) of the sample's sums: the n slots of gather added
// in rank order, so that every block gets the same bits.
__device__ __forceinline__ float gathered_sum(const float* gather, int e,
                                              int n, int C) {
  float t = 0.f;
  for (int q = 0; q < n; ++q) t += gather[q * 2 * C + e];
  return t;
}

}  // namespace vf
