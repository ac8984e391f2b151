// K2: fused GroupNorm(+SiLU) backward for Hopper (sm_90a).
//
// Replaces viewfusion_tpu/ops/groupnorm.py `_bwd_kernel_v2` (reached
// through `_pallas_bwd`), and with it `_bwd_kernel` (v1) and
// `_bwd_kernel_v3` (`_pallas_bwd4`, the same math on (B, H, W, C)
// blocks), which compute the same function in other TPU tilings.
//
// Function, per sample b and channel c of group g(c), with x and the
// upstream gradient g viewed as (B, L, C) rows and the forward's saved
// (B, G) mean and rstd:
//   sc = rstd * scale[c], sh = bias[c] - mean * sc,
//   xhat = x * rstd - mean * rstd, dy = g * act'(x * sc + sh)
//     (act' = 1, or silu'(z) = s (1 + z (1 - s)) with s = sigmoid(z)),
//   dbias_p[b, c] = sum_l dy, dscale_p[b, c] = sum_l dy * xhat,
//   a = sum_{c in g} dbias_p * scale / n, bb = sum_{c in g} dscale_p *
//     scale / n (n = L * C / G),
//   dx = dy * sc - (xhat * rstd * bb + rstd * a),
// all in f32; dx is stored in x's dtype, rounded once; the per-sample
// partials are f32 and summed over B by the caller in a fixed order (or
// kept per sample, where the affine is per sample).  A (B, C) affine is
// read at b * C + c by an instantiation of its own (kPerSample), as in K1.
//
// Bound on the H100: bytes.  About 16 flops per element against 6 bytes
// moved in bf16 (x and g read, dx written) is ~3 flop/byte, far below the
// ~20 flop/byte ridge of f32 CUDA-core math over 3.35 TB/s.  The least
// traffic is one read of x and g and one write of dx.
//
// Design: K1's cluster scheme (csrc/groupnorm.cu, csrc/gn_cluster.cuh),
// one launch per call.  The TPU kernel holds a sample in VMEM and keeps
// dy and xhat in f32 scratch between its two passes; here one cluster per
// sample stages its rows of x and g (bf16 or f32, as they arrive: half
// the shared memory of f32 dy and xhat) with two streams of 1-D bulk
// copies into one set of chunks, and both passes re-derive dy and xhat from
// the staged rows (a few FMAs, one __expf and one __fdividef an element:
// the sigmoid's division is the f32 reciprocal approximation, as in K1):
//  * pass 1 adds dbias = sum dy and dscale = sum dy * xhat per channel as
//    each chunk lands;
//  * the blocks exchange their per-channel sums through DSMEM, added in
//    rank order (every block gets the same bits; no atomics, no
//    workspace); rank 0 stores the per-sample (B, C) partials;
//  * every block folds them into the per-group a and b and writes dx
//    from its staged x and g, with no second read of device memory.
// The plan (ops/groupnorm.py: group_norm_plan, two tensors) takes a
// cluster of up to 16 blocks (non-portable above 8) to stage the whole
// slice (3 MiB at the paper UNet's largest site in bf16); where even that
// does not fit, each block stages a prefix of its rows and reads the rest
// from device memory in both passes, inside the same launch.

#include "gn_cluster.cuh"

namespace {

__device__ __forceinline__ float act_grad(float z, int act) {
  if (!act) return 1.f;
  const float s = __fdividef(1.f, 1.f + __expf(-z));
  return s * (1.f + z * (1.f - s));
}

template <typename T, int VEC, bool kPerSample>
__global__ void __launch_bounds__(vf::kMaxThreads)
    gn_bwd(const T* __restrict__ x, const T* __restrict__ g,
           const float* __restrict__ scale, const float* __restrict__ bias,
           const float* __restrict__ mean, const float* __restrict__ rstd,
           T* __restrict__ dx, float* __restrict__ dscale_p,
           float* __restrict__ dbias_p, int L, int C, int G,
           int rows_per_block, int rows_staged, int chunk_rows, int act) {
  using V = vf::Vec<T, VEC>;
  constexpr bool kBulk = VEC * sizeof(T) == 16;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  T* stage_x = reinterpret_cast<T*>(smem + vf::kBarBytes);
  T* stage_g = stage_x + static_cast<size_t>(rows_staged) * C;
  float* red = reinterpret_cast<float*>(
      smem + vf::kBarBytes +
      (2 * static_cast<size_t>(rows_staged) * C * sizeof(T) + 15) / 16 * 16);
  const int rank = static_cast<int>(cooperative_groups::this_cluster()
                                        .block_rank());
  const int n_blocks = static_cast<int>(cooperative_groups::this_cluster()
                                            .num_blocks());
  float* gather = red + blockDim.x * VEC;  // [n_blocks][2 * C]
  float* csum = gather + 2 * C * n_blocks;
  float* gstat = csum + 2 * C;  // [G] a, [G] b
  const int b = blockIdx.y;
  const int nv = C / VEC, rpi = blockDim.x / nv, tid = threadIdx.x;
  const int lane_c = tid % nv, r0 = tid / nv;
  const int cpg = C / G;
  const int row0 = rank * rows_per_block;
  const int rows = max(0, min(rows_per_block, L - row0));
  const int staged = min(rows_staged, rows);
  const size_t first = (static_cast<size_t>(b) * L + row0) * C;
  const T* xb = x + first + lane_c * VEC;
  const T* gb = g + first + lane_c * VEC;
  T* dxb = dx + first + lane_c * VEC;
  V* sx = reinterpret_cast<V*>(stage_x + lane_c * VEC);  // row r at r * nv
  V* sg = reinterpret_cast<V*>(stage_g + lane_c * VEC);
  auto gload = [&](const T* p, int r) {
    return *reinterpret_cast<const V*>(p + static_cast<size_t>(r) * C);
  };

  if constexpr (kBulk) {
    const T* src[2] = {x + first, g + first};
    T* const dst[2] = {stage_x, stage_g};
    vf::stage_rows<T, 2>(bars, dst, src, staged, chunk_rows, C);
  }

  if constexpr (kPerSample) {  // this sample's row of the (B, C) affine
    scale += static_cast<size_t>(b) * C;
    bias += static_cast<size_t>(b) * C;
  }
  // this thread's channels: rstd, mean * rstd, sc, sh
  float rs[VEC], mr[VEC], sc[VEC], sh[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int c = lane_c * VEC + i;
    const int grp = b * G + c / cpg;
    const float r = rstd[grp], m = mean[grp];
    rs[i] = r;
    mr[i] = m * r;
    sc[i] = r * scale[c];
    sh[i] = bias[c] - m * sc[i];
  }

  // pass 1: sum dy and sum dy * xhat of this thread's channels
  float a1[VEC], a2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) a1[i] = a2[i] = 0.f;
  auto add = [&](const V& xv, const V& gv) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float xf = vf::to_f(xv.v[i]);
      const float dy = vf::to_f(gv.v[i]) * act_grad(xf * sc[i] + sh[i], act);
      a1[i] += dy;
      a2[i] += dy * (xf * rs[i] - mr[i]);
    }
  };
  for (int k = 0; k * chunk_rows < staged; ++k) {
    if constexpr (kBulk) vf::mbar_wait(&bars[k], 0);
    const int end = min(staged, (k + 1) * chunk_rows);
#pragma unroll 4
    for (int r = k * chunk_rows + r0; r < end; r += rpi) {
      if constexpr (kBulk) {
        add(sx[r * nv], sg[r * nv]);
      } else {  // this thread stages its own rows (and reads them back)
        const V xv = gload(xb, r), gv = gload(gb, r);
        sx[r * nv] = xv;
        sg[r * nv] = gv;
        add(xv, gv);
      }
    }
  }
#pragma unroll 4
  for (int r = staged + r0; r < rows; r += rpi)
    add(gload(xb, r), gload(gb, r));

  // the sample's sums per channel (rank 0 stores them), times scale,
  // then a and b per group, and each channel's rstd * a, rstd * b
  vf::push_block_sums<VEC>(a1, a2, red, gather, C, r0, lane_c, rpi);
  for (int e = tid; e < 2 * C; e += blockDim.x) {
    const float t = vf::gathered_sum(gather, e, n_blocks, C);
    const int c = e < C ? e : e - C;
    if (rank == 0)
      (e < C ? dbias_p : dscale_p)[static_cast<size_t>(b) * C + c] = t;
    csum[e] = t * scale[c];
  }
  __syncthreads();
  const float n = static_cast<float>(L) * static_cast<float>(cpg);
  for (int grp = tid; grp < G; grp += blockDim.x) {
    float sa = 0.f, sb = 0.f;
    for (int j = 0; j < cpg; ++j) {
      sa += csum[grp * cpg + j];
      sb += csum[C + grp * cpg + j];
    }
    gstat[grp] = sa / n;
    gstat[G + grp] = sb / n;
  }
  __syncthreads();
  float ra[VEC], rb[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int grp = (lane_c * VEC + i) / cpg;
    ra[i] = rs[i] * gstat[grp];
    rb[i] = rs[i] * gstat[G + grp];
  }

  // pass 2: dx from the staged rows (the rest from device memory)
  auto grad = [&](const V& xv, const V& gv, int r) {
    V o;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float xf = vf::to_f(xv.v[i]);
      const float dy = vf::to_f(gv.v[i]) * act_grad(xf * sc[i] + sh[i], act);
      const float xhat = xf * rs[i] - mr[i];
      o.v[i] = vf::from_f<T>(dy * sc[i] - (xhat * rb[i] + ra[i]));
    }
    *reinterpret_cast<V*>(dxb + static_cast<size_t>(r) * C) = o;
  };
#pragma unroll 4
  for (int r = r0; r < staged; r += rpi) grad(sx[r * nv], sg[r * nv], r);
#pragma unroll 4
  for (int r = staged + r0; r < rows; r += rpi)
    grad(gload(xb, r), gload(gb, r), r);
}

template <typename T, bool S>
auto kernel_for(int vec) -> void (*)(const T*, const T*, const float*,
                                     const float*, const float*,
                                     const float*, T*, float*, float*, int,
                                     int, int, int, int, int, int) {
  if (vec == 8 && sizeof(T) == 2)
    return gn_bwd<T, (sizeof(T) == 2 ? 8 : 4), S>;
  if (vec == 4) return gn_bwd<T, 4, S>;
  if (vec == 2) return gn_bwd<T, 2, S>;
  return gn_bwd<T, 1, S>;
}

struct Args {
  const void *x, *g, *scale, *bias, *mean, *rstd;
  void *dx, *dscale_p, *dbias_p;
  int B, L, C, G, act, affine_stride;
};

template <typename T>
int dispatch(const vf::GnPlan& p, const Args& a, cudaStream_t stream) {
  if (!vf::gn_check_plan(p, a.B, a.L, a.C, a.G, sizeof(T), 2,
                         {a.x, a.g, a.dx}) ||
      !(a.affine_stride == 0 || a.affine_stride == a.C))
    return cudaErrorInvalidValue;
  return vf::gn_launch(
      a.affine_stride ? kernel_for<T, true>(p.vec)
                      : kernel_for<T, false>(p.vec),
      p, a.B, stream, static_cast<const T*>(a.x),
      static_cast<const T*>(a.g), static_cast<const float*>(a.scale),
      static_cast<const float*>(a.bias), static_cast<const float*>(a.mean),
      static_cast<const float*>(a.rstd), static_cast<T*>(a.dx),
      static_cast<float*>(a.dscale_p), static_cast<float*>(a.dbias_p), a.L,
      a.C, a.G, p.rows_per_block, p.rows_staged, p.chunk_rows, a.act);
}

}  // namespace

extern "C" int vf_group_norm_act_bwd(
    const void* x, const void* g, const void* scale, const void* bias,
    const void* mean, const void* rstd, void* dx, void* dscale_p,
    void* dbias_p, int B, int L, int C, int G, int cluster,
    int rows_per_block, int rows_staged, int chunk_rows, int threads,
    int smem, int vec, int act, int affine_stride, int dtype, void* stream) {
  const vf::GnPlan p{cluster, rows_per_block, rows_staged, chunk_rows,
                     threads, smem, vec};
  const Args a{x, g, scale, bias, mean, rstd, dx, dscale_p, dbias_p,
               B, L, C, G, act, affine_stride};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == vf::kBFloat16) return dispatch<__nv_bfloat16>(p, a, st);
  if (dtype == vf::kFloat32) return dispatch<float>(p, a, st);
  return cudaErrorInvalidValue;
}

// How many clusters of a plan's shape the card holds at once.
extern "C" int vf_group_norm_act_bwd_clusters(int cluster, int threads,
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
