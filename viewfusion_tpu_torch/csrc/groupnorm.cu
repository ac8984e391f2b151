// K1: fused GroupNorm(+SiLU) forward for Hopper (sm_90a).
//
// Replaces viewfusion_tpu/ops/groupnorm.py `_fwd_kernel_v2` (reached
// through `_pallas_fwd`), and with it `_fwd_kernel` (v1), which computes
// the same function in another TPU tiling.
//
// Function, per sample b and channel group g of x viewed as (B, L, C)
// rows (NHWC, or an NCHW tensor in channels_last memory):
//   S1, S2 = f32 sums of x and x*x over the n = L * C/G elements of g,
//   mean = S1 / n, var = max(S2 / n - mean^2, 0), rstd = rsqrt(var + eps),
//   y = act(x * sc + sh), sc = rstd * scale[c], sh = bias[c] - mean * sc,
// all in f32; y is stored in x's dtype, mean/rstd as (B, G) f32 for the
// backward kernel.  act is identity or SiLU.  scale and bias are (C,), the
// GroupNorm's own affine, or (B, C), one per (sample, channel) (a
// scale-shift norm's, folded into the GroupNorm's affine by the caller),
// read at b * C + c by an instantiation of its own (kPerSample), so that
// the per-channel kernel is the same code as before it existed.
//
// Bound on the H100: bytes.  About 10 flops per element against 4 bytes
// moved in bf16 (2 read, 2 written) is ~2.5 flop/byte, far below the
// ~20 flop/byte ridge of f32 CUDA-core math over 3.35 TB/s.  The least
// traffic is one read of x and one write of y.
//
// Design: one launch per call, one thread-block cluster per sample
// (csrc/gn_cluster.cuh), so that x is read from device memory once, as
// the TPU kernel holds a sample in VMEM.  A sample's slice (up to 1.5 MiB
// in bf16 at the paper UNet's sites) does not fit one SM, but it fits a
// cluster of up to 16 blocks of up to 227 KB each:
//  * the sample's L rows are cut into `cluster` contiguous ranges, one
//    per block; x is (B, L, C) contiguous, so a block's range is one
//    contiguous byte range, staged into shared memory by 1-D bulk copies
//    (cp.async.bulk) in up to 16 chunks, each completing on its own
//    mbarrier, all started at once;
//  * threads run along the contiguous C axis with 16-byte vector reads
//    of the staged rows and add S1/S2 as each chunk lands;
//  * each block folds its threads' sums into 2 * C f32 per-channel sums
//    and stores them into its slot of every block's gather buffer
//    through DSMEM (stores do not wait on the remote SM, loads would);
//    after one cluster barrier every block adds the slots in rank order
//    0..cluster-1, so that every block computes the same group
//    statistics bit for bit (no atomics); rank 0 stores mean and rstd;
//  * each block normalises its staged rows into y, with no second read
//    of device memory.  SiLU divides with __fdividef (the f32
//    reciprocal approximation, as __expf approximates the exponential):
//    IEEE division took as long as the rest of the second pass.
// The plan (ops/groupnorm.py: group_norm_plan) sizes the cluster: at
// least one block for every other SM at 28, 48 and 98 rows (a cluster's
// fixed costs, not bandwidth, bound the small sites), then as many blocks
// as it takes to stage the whole slice, in half an SM's shared memory
// where that can be (two blocks an SM), else in up to 227 KB; every bf16
// site of the paper UNet is staged whole.  Where a slice does not fit
// even 16 blocks (large f32 shapes), each block stages a prefix of its
// rows and reads the rest from device memory in both passes, inside the
// same launch.  Where rows are not 16-byte multiples (C * size of the
// dtype) or x is not 16-byte aligned, the block's threads stage the rows
// themselves with narrower vectors instead of bulk copies.

#include "gn_cluster.cuh"

namespace {

template <typename T, int VEC, bool kPerSample>
__global__ void __launch_bounds__(vf::kMaxThreads)
    gn_fwd(const T* __restrict__ x, const float* __restrict__ scale,
           const float* __restrict__ bias, T* __restrict__ y,
           float* __restrict__ mean_out, float* __restrict__ rstd_out, int L,
           int C, int G, int rows_per_block, int rows_staged, int chunk_rows,
           float eps, int act) {
  using V = vf::Vec<T, VEC>;
  constexpr bool kBulk = VEC * sizeof(T) == 16;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  T* stage = reinterpret_cast<T*>(smem + vf::kBarBytes);
  float* red = reinterpret_cast<float*>(
      smem + vf::kBarBytes +
      (static_cast<size_t>(rows_staged) * C * sizeof(T) + 15) / 16 * 16);
  const int rank = static_cast<int>(cooperative_groups::this_cluster()
                                        .block_rank());
  const int n_blocks = static_cast<int>(cooperative_groups::this_cluster()
                                            .num_blocks());
  float* gather = red + blockDim.x * VEC;  // [n_blocks][2 * C]
  float* csum = gather + 2 * C * n_blocks;
  float* gstat = csum + 2 * C;  // [G] mean, [G] rstd
  const int b = blockIdx.y;
  const int nv = C / VEC, rpi = blockDim.x / nv, tid = threadIdx.x;
  const int lane_c = tid % nv, r0 = tid / nv;
  const int row0 = rank * rows_per_block;
  const int rows = max(0, min(rows_per_block, L - row0));
  const int staged = min(rows_staged, rows);
  const T* xb = x + (static_cast<size_t>(b) * L + row0) * C + lane_c * VEC;
  T* yb = y + (static_cast<size_t>(b) * L + row0) * C + lane_c * VEC;
  V* sv = reinterpret_cast<V*>(stage + lane_c * VEC);  // row r at r * nv
  auto gload = [&](int r) {
    return *reinterpret_cast<const V*>(xb + static_cast<size_t>(r) * C);
  };

  if constexpr (kBulk) {
    const T* src[1] = {x + (static_cast<size_t>(b) * L + row0) * C};
    T* const dst[1] = {stage};
    vf::stage_rows<T, 1>(bars, dst, src, staged, chunk_rows, C);
  }
  if constexpr (kPerSample) {  // this sample's row of the (B, C) affine
    scale += static_cast<size_t>(b) * C;
    bias += static_cast<size_t>(b) * C;
  }
  float vsc[VEC], vsh[VEC];  // scale and bias of this thread's channels
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    vsc[i] = scale[lane_c * VEC + i];
    vsh[i] = bias[lane_c * VEC + i];
  }

  // pass 1: S1, S2 of this thread's VEC channels over its rows
  float a1[VEC], a2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) a1[i] = a2[i] = 0.f;
  auto add = [&](const V& v) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float f = vf::to_f(v.v[i]);
      a1[i] += f;
      a2[i] += f * f;
    }
  };
  for (int k = 0; k * chunk_rows < staged; ++k) {
    if constexpr (kBulk) vf::mbar_wait(&bars[k], 0);
    const int end = min(staged, (k + 1) * chunk_rows);
#pragma unroll 4
    for (int r = k * chunk_rows + r0; r < end; r += rpi) {
      if constexpr (kBulk) {
        add(sv[r * nv]);
      } else {  // this thread stages its own rows (and reads them back)
        const V v = gload(r);
        sv[r * nv] = v;
        add(v);
      }
    }
  }
#pragma unroll 4
  for (int r = staged + r0; r < rows; r += rpi) add(gload(r));

  // the sample's S1, S2 per channel, then per group
  vf::push_block_sums<VEC>(a1, a2, red, gather, C, r0, lane_c, rpi);
  for (int e = tid; e < 2 * C; e += blockDim.x)
    csum[e] = vf::gathered_sum(gather, e, n_blocks, C);
  __syncthreads();
  const int cpg = C / G;
  const float n = static_cast<float>(L) * static_cast<float>(cpg);
  for (int g = tid; g < G; g += blockDim.x) {
    float s1 = 0.f, s2 = 0.f;
    for (int j = 0; j < cpg; ++j) {
      s1 += csum[g * cpg + j];
      s2 += csum[C + g * cpg + j];
    }
    const float mean = s1 / n;
    const float var = fmaxf(s2 / n - mean * mean, 0.f);
    const float rstd = rsqrtf(var + eps);
    gstat[g] = mean;
    gstat[G + g] = rstd;
    if (rank == 0 && mean_out != nullptr) {
      mean_out[b * G + g] = mean;
      rstd_out[b * G + g] = rstd;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < VEC; ++i) {  // sc = rstd * scale, sh = bias - mean * sc
    const int g = (lane_c * VEC + i) / cpg;
    vsc[i] *= gstat[G + g];
    vsh[i] -= gstat[g] * vsc[i];
  }

  // pass 2: y from the staged rows (the rest from device memory)
  auto normalize = [&](const V& v, int r) {
    V o;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      float z = vf::to_f(v.v[i]) * vsc[i] + vsh[i];
      if (act) z = __fdividef(z, 1.f + __expf(-z));
      o.v[i] = vf::from_f<T>(z);
    }
    *reinterpret_cast<V*>(yb + static_cast<size_t>(r) * C) = o;
  };
#pragma unroll 4
  for (int r = r0; r < staged; r += rpi) normalize(sv[r * nv], r);
#pragma unroll 4
  for (int r = staged + r0; r < rows; r += rpi) normalize(gload(r), r);
}

template <typename T, bool S>
auto kernel_for(int vec) -> void (*)(const T*, const float*, const float*,
                                     T*, float*, float*, int, int, int, int,
                                     int, int, float, int) {
  if (vec == 8 && sizeof(T) == 2)
    return gn_fwd<T, (sizeof(T) == 2 ? 8 : 4), S>;
  if (vec == 4) return gn_fwd<T, 4, S>;
  if (vec == 2) return gn_fwd<T, 2, S>;
  return gn_fwd<T, 1, S>;
}

template <typename T>
int dispatch(const vf::GnPlan& p, const void* x, const void* scale,
             const void* bias, void* y, void* mean, void* rstd, int B, int L,
             int C, int G, float eps, int act, int affine_stride,
             cudaStream_t stream) {
  if (!vf::gn_check_plan(p, B, L, C, G, sizeof(T), 1, {x, y}) ||
      !(affine_stride == 0 || affine_stride == C))
    return cudaErrorInvalidValue;
  return vf::gn_launch(affine_stride ? kernel_for<T, true>(p.vec)
                                     : kernel_for<T, false>(p.vec),
                       p, B, stream,
                       static_cast<const T*>(x),
                       static_cast<const float*>(scale),
                       static_cast<const float*>(bias), static_cast<T*>(y),
                       static_cast<float*>(mean), static_cast<float*>(rstd),
                       L, C, G, p.rows_per_block, p.rows_staged,
                       p.chunk_rows, eps, act);
}

}  // namespace

// mean and rstd may both be null (the statistics are then not stored).
// scale and bias are (C,) with affine_stride 0, (B, C) with C.
extern "C" int vf_group_norm_act_fwd(
    const void* x, const void* scale, const void* bias, void* y, void* mean,
    void* rstd, int B, int L, int C, int G, int cluster, int rows_per_block,
    int rows_staged, int chunk_rows, int threads, int smem, int vec,
    float eps, int act, int affine_stride, int dtype, void* stream) {
  const vf::GnPlan p{cluster, rows_per_block, rows_staged, chunk_rows,
                     threads, smem, vec};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == vf::kBFloat16)
    return dispatch<__nv_bfloat16>(p, x, scale, bias, y, mean, rstd, B, L,
                                   C, G, eps, act, affine_stride, st);
  if (dtype == vf::kFloat32)
    return dispatch<float>(p, x, scale, bias, y, mean, rstd, B, L, C, G, eps,
                           act, affine_stride, st);
  return cudaErrorInvalidValue;
}

// How many clusters of a plan's shape the card holds at once.
extern "C" int vf_group_norm_act_fwd_clusters(int cluster, int threads,
                                              int smem, int vec, int dtype,
                                              int* active) {
  const vf::GnPlan p{cluster, 1, 0, 1, threads, smem, vec};
  if (dtype == vf::kBFloat16)
    return vf::gn_active_clusters(kernel_for<__nv_bfloat16, false>(vec), p,
                                  active);
  if (dtype == vf::kFloat32)
    return vf::gn_active_clusters(kernel_for<float, false>(vec), p, active);
  return cudaErrorInvalidValue;
}

extern "C" const char* vf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
