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
// backward kernel.  act is identity or SiLU.
//
// Bound on the H100: bytes.  About 10 flops per element against 4 bytes
// moved in bf16 (2 read, 2 written) is ~2.5 flop/byte, far below the
// ~20 flop/byte ridge of f32 CUDA-core math over 3.35 TB/s.  The least
// traffic is one read of x and one write of y.
//
// Design:
//  * Threads run along the contiguous C axis with 16-byte vector accesses
//    (8 bf16 or 4 f32 channels a thread), so a warp covers whole rows and
//    every access is coalesced.  A group holds 2..20 channels, mostly not
//    a power of two, so channels are folded into groups in shared memory
//    rather than by lane shuffles.
//  * A sample's statistics need all of its rows, and one block per sample
//    fills only B of the 132 SMs (48 at the serving batch).  The rows of
//    a sample are therefore split over `splits` blocks.  Pass 1
//    (gn_stats) writes each block's per-channel partial sums to a small
//    workspace (no atomics, so the result is deterministic); pass 2
//    (gn_apply) folds the partials of its sample into group statistics
//    and normalises its own rows.  x is read twice and y written once:
//    1.5x the least traffic, less where the second read hits the 50 MB
//    L2.  Keeping a sample's slice on chip between the two passes is
//    left for a later change.

#include "common.cuh"

namespace {

constexpr int kUnroll = 4;  // rows whose loads are in flight per thread

template <typename T, int VEC>
__global__ void gn_stats(const T* __restrict__ x, float* __restrict__ ws1,
                         float* __restrict__ ws2, int L, int C, int splits,
                         int rows_per_split) {
  extern __shared__ float smem[];
  const int nv = C / VEC;
  const int rpi = blockDim.x / nv;  // rows covered per sweep of the block
  const int tid = threadIdx.x;
  const int lane_c = tid % nv;
  const int r0 = tid / nv;
  const int s = blockIdx.x, b = blockIdx.y;
  const int row_end = min(L, (s + 1) * rows_per_split);
  const T* xb = x + static_cast<size_t>(b) * L * C + lane_c * VEC;

  float a1[VEC], a2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) a1[i] = a2[i] = 0.f;

  int r = s * rows_per_split + r0;
  for (; r + (kUnroll - 1) * rpi < row_end; r += kUnroll * rpi) {
    vf::Vec<T, VEC> v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      v[u] = *reinterpret_cast<const vf::Vec<T, VEC>*>(
          xb + static_cast<size_t>(r + u * rpi) * C);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float f = vf::to_f(v[u].v[i]);
        a1[i] += f;
        a2[i] += f * f;
      }
  }
  for (; r < row_end; r += rpi) {
    const vf::Vec<T, VEC> v = *reinterpret_cast<const vf::Vec<T, VEC>*>(
        xb + static_cast<size_t>(r) * C);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float f = vf::to_f(v.v[i]);
      a1[i] += f;
      a2[i] += f * f;
    }
  }

  float* red1 = smem;             // [rpi][C]
  float* red2 = smem + rpi * C;   // [rpi][C]
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
    for (int k = 0; k < rpi; ++k) {
      t1 += red1[k * C + c];
      t2 += red2[k * C + c];
    }
    o1[c] = t1;
    o2[c] = t2;
  }
}

template <typename T, int VEC>
__global__ void gn_apply(const T* __restrict__ x,
                         const float* __restrict__ scale,
                         const float* __restrict__ bias,
                         const float* __restrict__ ws1,
                         const float* __restrict__ ws2, T* __restrict__ y,
                         float* __restrict__ mean_out,
                         float* __restrict__ rstd_out, int L, int C, int G,
                         int splits, int rows_per_split, float eps, int act) {
  extern __shared__ float smem[];
  float* ch1 = smem;          // [C] per-channel sums of the sample
  float* ch2 = ch1 + C;       // [C]
  float* sc = ch2 + C;        // [C] rstd * scale
  float* sh = sc + C;         // [C] bias - mean * rstd * scale
  float* gmean = sh + C;      // [G]
  float* grstd = gmean + G;   // [G]
  const int tid = threadIdx.x;
  const int s = blockIdx.x, b = blockIdx.y;

  for (int c = tid; c < C; c += blockDim.x) {
    float t1 = 0.f, t2 = 0.f;
    for (int k = 0; k < splits; ++k) {
      t1 += ws1[(static_cast<size_t>(b) * splits + k) * C + c];
      t2 += ws2[(static_cast<size_t>(b) * splits + k) * C + c];
    }
    ch1[c] = t1;
    ch2[c] = t2;
  }
  __syncthreads();
  const int cpg = C / G;
  const float n = static_cast<float>(L) * static_cast<float>(cpg);
  for (int g = tid; g < G; g += blockDim.x) {
    float s1 = 0.f, s2 = 0.f;
    for (int j = 0; j < cpg; ++j) {
      s1 += ch1[g * cpg + j];
      s2 += ch2[g * cpg + j];
    }
    const float mean = s1 / n;
    const float var = fmaxf(s2 / n - mean * mean, 0.f);
    const float rstd = rsqrtf(var + eps);
    gmean[g] = mean;
    grstd[g] = rstd;
    if (s == 0) {
      mean_out[b * G + g] = mean;
      rstd_out[b * G + g] = rstd;
    }
  }
  __syncthreads();
  for (int c = tid; c < C; c += blockDim.x) {
    const int g = c / cpg;
    const float v = grstd[g] * scale[c];
    sc[c] = v;
    sh[c] = bias[c] - gmean[g] * v;
  }
  __syncthreads();

  const int nv = C / VEC;
  const int rpi = blockDim.x / nv;
  const int lane_c = tid % nv;
  const int r0 = tid / nv;
  float vsc[VEC], vsh[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    vsc[i] = sc[lane_c * VEC + i];
    vsh[i] = sh[lane_c * VEC + i];
  }
  const size_t base = static_cast<size_t>(b) * L * C + lane_c * VEC;
  const int row_end = min(L, (s + 1) * rows_per_split);
  auto normalize = [&](const vf::Vec<T, VEC>& v) {
    vf::Vec<T, VEC> o;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      float z = vf::to_f(v.v[i]) * vsc[i] + vsh[i];
      if (act) z = z / (1.f + __expf(-z));
      o.v[i] = vf::from_f<T>(z);
    }
    return o;
  };
  int r = s * rows_per_split + r0;
  for (; r + (kUnroll - 1) * rpi < row_end; r += kUnroll * rpi) {
    vf::Vec<T, VEC> v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      v[u] = *reinterpret_cast<const vf::Vec<T, VEC>*>(
          x + base + static_cast<size_t>(r + u * rpi) * C);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      *reinterpret_cast<vf::Vec<T, VEC>*>(
          y + base + static_cast<size_t>(r + u * rpi) * C) = normalize(v[u]);
  }
  for (; r < row_end; r += rpi) {
    const size_t off = base + static_cast<size_t>(r) * C;
    *reinterpret_cast<vf::Vec<T, VEC>*>(y + off) =
        normalize(*reinterpret_cast<const vf::Vec<T, VEC>*>(x + off));
  }
}

template <typename T, int VEC>
int launch(const void* x, const void* scale, const void* bias, void* y,
           void* mean, void* rstd, void* ws1, void* ws2, int B, int L, int C,
           int G, int splits, float eps, int act, cudaStream_t stream) {
  const int nv = C / VEC;
  if (nv > 1024) return cudaErrorInvalidValue;
  const int rpi = nv >= 256 ? 1 : 256 / nv;
  const int threads = nv * rpi;
  const int rows_per_split = (L + splits - 1) / splits;
  const size_t smem1 = 2 * static_cast<size_t>(rpi) * C * sizeof(float);
  const size_t smem2 = (4 * static_cast<size_t>(C) + 2 * G) * sizeof(float);
  if (smem1 > 48 * 1024 || smem2 > 48 * 1024) return cudaErrorInvalidValue;
  const dim3 grid(splits, B);
  gn_stats<T, VEC><<<grid, threads, smem1, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(ws1),
      static_cast<float*>(ws2), L, C, splits, rows_per_split);
  gn_apply<T, VEC><<<grid, threads, smem2, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const float*>(ws1),
      static_cast<const float*>(ws2), static_cast<T*>(y),
      static_cast<float*>(mean), static_cast<float*>(rstd), L, C, G, splits,
      rows_per_split, eps, act);
  return cudaGetLastError();
}

// Widest vector (at most 16 bytes) that divides C and keeps every row of
// x and y aligned.
template <typename T>
int dispatch(const void* x, const void* scale, const void* bias, void* y,
             void* mean, void* rstd, void* ws1, void* ws2, int B, int L,
             int C, int G, int splits, float eps, int act,
             cudaStream_t stream) {
  constexpr int kMax = 16 / sizeof(T);
  auto fits = [&](int vec) {
    const int bytes = vec * static_cast<int>(sizeof(T));
    return C % vec == 0 && vf::aligned(x, bytes) && vf::aligned(y, bytes);
  };
  if (kMax >= 8 && fits(8))
    return launch<T, (kMax >= 8 ? 8 : 1)>(x, scale, bias, y, mean, rstd, ws1,
                                           ws2, B, L, C, G, splits, eps, act,
                                           stream);
  if (fits(4))
    return launch<T, 4>(x, scale, bias, y, mean, rstd, ws1, ws2, B, L, C, G,
                        splits, eps, act, stream);
  if (fits(2))
    return launch<T, 2>(x, scale, bias, y, mean, rstd, ws1, ws2, B, L, C, G,
                        splits, eps, act, stream);
  return launch<T, 1>(x, scale, bias, y, mean, rstd, ws1, ws2, B, L, C, G,
                      splits, eps, act, stream);
}

}  // namespace

extern "C" int vf_group_norm_act_fwd(const void* x, const void* scale,
                                     const void* bias, void* y, void* mean,
                                     void* rstd, void* ws1, void* ws2, int B,
                                     int L, int C, int G, int splits,
                                     float eps, int act, int dtype,
                                     void* stream) {
  if (B < 1 || L < 1 || C < 1 || G < 1 || C % G != 0 || splits < 1 ||
      splits > L)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == vf::kBFloat16)
    return dispatch<__nv_bfloat16>(x, scale, bias, y, mean, rstd, ws1, ws2, B,
                                   L, C, G, splits, eps, act, st);
  if (dtype == vf::kFloat32)
    return dispatch<float>(x, scale, bias, y, mean, rstd, ws1, ws2, B, L, C,
                           G, splits, eps, act, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* vf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
