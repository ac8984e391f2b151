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
// partials are f32 and summed over B by the caller in a fixed order.
//
// Bound on the H100: bytes.  About 16 flops per element against 6 bytes
// moved in bf16 (x and g read, dx written) is ~3 flop/byte, far below the
// ~20 flop/byte ridge of f32 CUDA-core math over 3.35 TB/s.  The least
// traffic is one read of x and g and one write of dx.
//
// Design: K1's row-split scheme (csrc/groupnorm.cu).  A TPU grid step
// holds a whole sample (up to 1.5 MB) in VMEM with dy and xhat kept in
// scratch between its two passes; an SM cannot, and one block per sample
// would fill B of the 132 SMs.  The rows of a sample are split over
// `splits` blocks:
//  * gn_bwd_reduce re-derives dy and xhat from x, g and the statistics
//    and writes each block's per-channel sums of dy and dy * xhat to a
//    (B, splits, C) workspace (no atomics: deterministic);
//  * gn_bwd_apply sums its sample's splits into the (B, C) partials
//    (block 0 stores them), folds them into the per-group a and b in
//    shared memory (channels per group are 2..20, rarely a power of two),
//    re-reads x and g and writes dx.
// x and g are read twice and dx written once: 5 tensors against the
// least 3, so at most 60% of the byte bound, less the part of the second
// read that hits the 50 MB L2.  Threads run along the contiguous C axis
// with 16-byte vector accesses, as in K1.

#include "common.cuh"

namespace {

constexpr int kUnroll = 4;  // rows whose loads are in flight per thread

__device__ __forceinline__ float act_grad(float z, int act) {
  if (!act) return 1.f;
  const float s = 1.f / (1.f + __expf(-z));
  return s * (1.f + z * (1.f - s));
}

// Per-thread constants of the VEC channels a thread owns.
template <int VEC>
struct ChannelConsts {
  float rs[VEC], mr[VEC], sc[VEC], sh[VEC];

  __device__ void load(const float* scale, const float* bias,
                       const float* mean, const float* rstd, int b, int c0,
                       int G, int cpg) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const int c = c0 + i;
      const int g = b * G + c / cpg;
      const float r = rstd[g], m = mean[g];
      rs[i] = r;
      mr[i] = m * r;
      sc[i] = r * scale[c];
      sh[i] = bias[c] - m * sc[i];
    }
  }
};

template <typename T, int VEC>
__global__ void gn_bwd_reduce(const T* __restrict__ x,
                              const T* __restrict__ g,
                              const float* __restrict__ scale,
                              const float* __restrict__ bias,
                              const float* __restrict__ mean,
                              const float* __restrict__ rstd,
                              float* __restrict__ ws1,
                              float* __restrict__ ws2, int L, int C, int G,
                              int splits, int rows_per_split, int act) {
  extern __shared__ float smem[];
  const int nv = C / VEC;
  const int rpi = blockDim.x / nv;  // rows covered per sweep of the block
  const int tid = threadIdx.x;
  const int lane_c = tid % nv;
  const int r0 = tid / nv;
  const int s = blockIdx.x, b = blockIdx.y;
  const int row_end = min(L, (s + 1) * rows_per_split);
  const size_t base = static_cast<size_t>(b) * L * C + lane_c * VEC;

  ChannelConsts<VEC> k;
  k.load(scale, bias, mean, rstd, b, lane_c * VEC, G, C / G);
  float a1[VEC], a2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) a1[i] = a2[i] = 0.f;
  auto accumulate = [&](const vf::Vec<T, VEC>& xv,
                        const vf::Vec<T, VEC>& gv) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float xf = vf::to_f(xv.v[i]);
      const float dy = vf::to_f(gv.v[i]) * act_grad(xf * k.sc[i] + k.sh[i],
                                                    act);
      a1[i] += dy;
      a2[i] += dy * (xf * k.rs[i] - k.mr[i]);
    }
  };

  int r = s * rows_per_split + r0;
  for (; r + (kUnroll - 1) * rpi < row_end; r += kUnroll * rpi) {
    vf::Vec<T, VEC> xv[kUnroll], gv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const size_t off = base + static_cast<size_t>(r + u * rpi) * C;
      xv[u] = *reinterpret_cast<const vf::Vec<T, VEC>*>(x + off);
      gv[u] = *reinterpret_cast<const vf::Vec<T, VEC>*>(g + off);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) accumulate(xv[u], gv[u]);
  }
  for (; r < row_end; r += rpi) {
    const size_t off = base + static_cast<size_t>(r) * C;
    accumulate(*reinterpret_cast<const vf::Vec<T, VEC>*>(x + off),
               *reinterpret_cast<const vf::Vec<T, VEC>*>(g + off));
  }

  float* red1 = smem;            // [rpi][C]
  float* red2 = smem + rpi * C;  // [rpi][C]
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    red1[r0 * C + lane_c * VEC + i] = a1[i];
    red2[r0 * C + lane_c * VEC + i] = a2[i];
  }
  __syncthreads();
  float* o1 = ws1 + (static_cast<size_t>(b) * splits + s) * C;
  float* o2 = ws2 + (static_cast<size_t>(b) * splits + s) * C;
  for (int c = tid; c < C; c += blockDim.x) {
    float t1 = 0.f, t2 = 0.f;
    for (int j = 0; j < rpi; ++j) {
      t1 += red1[j * C + c];
      t2 += red2[j * C + c];
    }
    o1[c] = t1;
    o2[c] = t2;
  }
}

template <typename T, int VEC>
__global__ void gn_bwd_apply(const T* __restrict__ x,
                             const T* __restrict__ g,
                             const float* __restrict__ scale,
                             const float* __restrict__ bias,
                             const float* __restrict__ mean,
                             const float* __restrict__ rstd,
                             const float* __restrict__ ws1,
                             const float* __restrict__ ws2,
                             T* __restrict__ dx, float* __restrict__ dscale_p,
                             float* __restrict__ dbias_p, int L, int C, int G,
                             int splits, int rows_per_split, int act) {
  extern __shared__ float smem[];
  float* ch1 = smem;     // [C] sum of dy over the sample
  float* ch2 = ch1 + C;  // [C] sum of dy * xhat
  float* ga = ch2 + C;   // [G] a
  float* gb = ga + G;    // [G] b
  const int tid = threadIdx.x;
  const int s = blockIdx.x, b = blockIdx.y;
  const int cpg = C / G;

  for (int c = tid; c < C; c += blockDim.x) {
    float t1 = 0.f, t2 = 0.f;
    for (int j = 0; j < splits; ++j) {
      t1 += ws1[(static_cast<size_t>(b) * splits + j) * C + c];
      t2 += ws2[(static_cast<size_t>(b) * splits + j) * C + c];
    }
    ch1[c] = t1;
    ch2[c] = t2;
    if (s == 0) {
      dbias_p[static_cast<size_t>(b) * C + c] = t1;
      dscale_p[static_cast<size_t>(b) * C + c] = t2;
    }
  }
  __syncthreads();
  const float n = static_cast<float>(L) * static_cast<float>(cpg);
  for (int grp = tid; grp < G; grp += blockDim.x) {
    float sa = 0.f, sb = 0.f;
    for (int j = 0; j < cpg; ++j) {
      const int c = grp * cpg + j;
      sa += ch1[c] * scale[c];
      sb += ch2[c] * scale[c];
    }
    ga[grp] = sa / n;
    gb[grp] = sb / n;
  }
  __syncthreads();

  const int nv = C / VEC;
  const int rpi = blockDim.x / nv;
  const int lane_c = tid % nv;
  const int r0 = tid / nv;
  ChannelConsts<VEC> k;
  k.load(scale, bias, mean, rstd, b, lane_c * VEC, G, cpg);
  float ra[VEC], rb[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int grp = (lane_c * VEC + i) / cpg;
    ra[i] = k.rs[i] * ga[grp];
    rb[i] = k.rs[i] * gb[grp];
  }
  const size_t base = static_cast<size_t>(b) * L * C + lane_c * VEC;
  const int row_end = min(L, (s + 1) * rows_per_split);
  auto grad = [&](const vf::Vec<T, VEC>& xv, const vf::Vec<T, VEC>& gv) {
    vf::Vec<T, VEC> o;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float xf = vf::to_f(xv.v[i]);
      const float dy = vf::to_f(gv.v[i]) * act_grad(xf * k.sc[i] + k.sh[i],
                                                    act);
      const float xhat = xf * k.rs[i] - k.mr[i];
      o.v[i] = vf::from_f<T>(dy * k.sc[i] - (xhat * rb[i] + ra[i]));
    }
    return o;
  };
  int r = s * rows_per_split + r0;
  for (; r + (kUnroll - 1) * rpi < row_end; r += kUnroll * rpi) {
    vf::Vec<T, VEC> xv[kUnroll], gv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const size_t off = base + static_cast<size_t>(r + u * rpi) * C;
      xv[u] = *reinterpret_cast<const vf::Vec<T, VEC>*>(x + off);
      gv[u] = *reinterpret_cast<const vf::Vec<T, VEC>*>(g + off);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      *reinterpret_cast<vf::Vec<T, VEC>*>(
          dx + base + static_cast<size_t>(r + u * rpi) * C) =
          grad(xv[u], gv[u]);
  }
  for (; r < row_end; r += rpi) {
    const size_t off = base + static_cast<size_t>(r) * C;
    *reinterpret_cast<vf::Vec<T, VEC>*>(dx + off) =
        grad(*reinterpret_cast<const vf::Vec<T, VEC>*>(x + off),
             *reinterpret_cast<const vf::Vec<T, VEC>*>(g + off));
  }
}

struct Args {
  const void *x, *g, *scale, *bias, *mean, *rstd;
  void *dx, *dscale_p, *dbias_p, *ws1, *ws2;
  int B, L, C, G, splits, act;
};

template <typename T, int VEC>
int launch(const Args& a, cudaStream_t stream) {
  const int nv = a.C / VEC;
  if (nv > 1024) return cudaErrorInvalidValue;
  const int rpi = nv >= 256 ? 1 : 256 / nv;
  const int threads = nv * rpi;
  const int rows_per_split = (a.L + a.splits - 1) / a.splits;
  const size_t smem1 = 2 * static_cast<size_t>(rpi) * a.C * sizeof(float);
  const size_t smem2 = (2 * static_cast<size_t>(a.C) + 2 * a.G) *
                       sizeof(float);
  if (smem1 > 48 * 1024 || smem2 > 48 * 1024) return cudaErrorInvalidValue;
  const dim3 grid(a.splits, a.B);
  const T* x = static_cast<const T*>(a.x);
  const T* g = static_cast<const T*>(a.g);
  const float* scale = static_cast<const float*>(a.scale);
  const float* bias = static_cast<const float*>(a.bias);
  const float* mean = static_cast<const float*>(a.mean);
  const float* rstd = static_cast<const float*>(a.rstd);
  float* ws1 = static_cast<float*>(a.ws1);
  float* ws2 = static_cast<float*>(a.ws2);
  gn_bwd_reduce<T, VEC><<<grid, threads, smem1, stream>>>(
      x, g, scale, bias, mean, rstd, ws1, ws2, a.L, a.C, a.G, a.splits,
      rows_per_split, a.act);
  gn_bwd_apply<T, VEC><<<grid, threads, smem2, stream>>>(
      x, g, scale, bias, mean, rstd, ws1, ws2, static_cast<T*>(a.dx),
      static_cast<float*>(a.dscale_p), static_cast<float*>(a.dbias_p), a.L,
      a.C, a.G, a.splits, rows_per_split, a.act);
  return cudaGetLastError();
}

// Widest vector (at most 16 bytes) that divides C and keeps every row of
// x, g and dx aligned.
template <typename T>
int dispatch(const Args& a, cudaStream_t stream) {
  constexpr int kMax = 16 / sizeof(T);
  auto fits = [&](int vec) {
    const int bytes = vec * static_cast<int>(sizeof(T));
    return a.C % vec == 0 && vf::aligned(a.x, bytes) &&
           vf::aligned(a.g, bytes) && vf::aligned(a.dx, bytes);
  };
  if (kMax >= 8 && fits(8)) return launch<T, (kMax >= 8 ? 8 : 1)>(a, stream);
  if (fits(4)) return launch<T, 4>(a, stream);
  if (fits(2)) return launch<T, 2>(a, stream);
  return launch<T, 1>(a, stream);
}

}  // namespace

extern "C" int vf_group_norm_act_bwd(const void* x, const void* g,
                                     const void* scale, const void* bias,
                                     const void* mean, const void* rstd,
                                     void* dx, void* dscale_p, void* dbias_p,
                                     void* ws1, void* ws2, int B, int L,
                                     int C, int G, int splits, int act,
                                     int dtype, void* stream) {
  if (B < 1 || L < 1 || C < 1 || G < 1 || C % G != 0 || splits < 1 ||
      splits > L)
    return cudaErrorInvalidValue;
  const Args a{x,    g,       scale,   bias, mean, rstd, dx, dscale_p,
               dbias_p, ws1, ws2, B, L, C, G, splits, act};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == vf::kBFloat16) return dispatch<__nv_bfloat16>(a, st);
  if (dtype == vf::kFloat32) return dispatch<float>(a, st);
  return cudaErrorInvalidValue;
}
