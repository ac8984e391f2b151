// K3: single-head dense attention forward for Hopper (sm_90a).
//
// Replaces viewfusion_tpu/ops/attention.py `_attn_kernel` (reached
// through `_pallas_attention`).
//
// Function, per batch row b: out = softmax(q k^T * scale) v with q, k, v
// of shape (S, C) in bf16 or f32 and scores, softmax and P.V in f32
// (inputs are widened to f32 before any product, as `_attn_kernel` does);
// out is f32.  q, k and v may be column slices of one buffer (the UNet
// slices them out of one qkv 1x1-conv output, row stride 3C): the kernel
// takes a row stride and a batch stride instead of a copy.
//
// Bound on the H100 at the UNet's shapes (S = 256, C = 192 and S = 64,
// C = 320, B = 48): bytes.  4*S*C flops per row of q against 3*2*C bytes
// read (bf16) and 4*C written is 4*S/10 ~ 100 flop/byte at S = 256, under
// the ~295 flop/byte ridge of the bf16 tensor cores but far above the
// ~20 flop/byte ridge of f32 math on the CUDA cores.  So the products
// must run on the tensor cores without giving up f32 results:
//
// attn_fwd_mma (bf16 inputs, C a multiple of 8, C <= 320: the UNet's
// path).  One block of 4 warps per (batch row, 64 queries); each warp
// owns 16 queries.  K and V stream through shared memory in tiles of 64
// keys with an online (running max and sum) softmax.  S = Q.K^T runs as
// mma.sync m16n8k16 bf16 with f32 accumulation: a product of two bf16
// values is exact in f32, so this is the f32 math of the TPU kernel up
// to summation order.  For P.V the f32 probabilities are split exactly
// into three bf16 terms (8 + 8 + 8 bits of mantissa), each multiplied by
// the bf16 V on the tensor cores and accumulated in f32: again exact
// products, f32 sums.  P stays in registers: the accumulator fragment of
// S is the A fragment of P.V.  Rows in shared memory are padded so the
// fragment loads are free of bank conflicts; V is stored transposed so
// its B fragments are contiguous.  Channels are zero-padded to the
// instantiated width.
//
// attn_fwd (f32 inputs, or shapes the mma path does not take): the same
// online softmax with f32 FMAs on the CUDA cores.  One block per (batch
// row, 32 queries), 256 threads as a 16 x 16 grid, key tiles of 32; each
// thread owns 2 queries x 2 keys of a score tile and 2 queries x
// ceil(C/16) output channels in registers; K is stored transposed.

#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kBQ = 32;  // queries per block
constexpr int kBK = 32;  // keys per tile
constexpr int kThreads = 256;

template <typename T, int NC>  // NC: output channels per thread, C <= 16 NC
__global__ void __launch_bounds__(kThreads)
    attn_fwd(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, float* __restrict__ out, int S, int C,
             long long bstride, long long rstride, float scale) {
  extern __shared__ float smem[];
  const int ldq = C + 1;    // padded: a warp's two q rows in distinct banks
  const int ldk = kBK + 1;  // padded: transposed stores conflict-free
  const int ldp = kBK + 1;
  float* qs = smem;               // [kBQ][ldq]
  float* kt = qs + kBQ * ldq;     // [C][ldk], K transposed
  float* vs = kt + C * ldk;       // [kBK][C]
  float* ps = vs + kBK * C;       // [kBQ][ldp], probabilities of the tile

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.y, q0 = blockIdx.x * kBQ;
  const T* qb = q + b * bstride;
  const T* kb = k + b * bstride;
  const T* vb = v + b * bstride;

  for (int i = tid; i < kBQ * C; i += kThreads) {
    const int r = i / C, c = i - r * C;
    const int qi = q0 + r;
    qs[r * ldq + c] = qi < S ? vf::to_f(qb[qi * rstride + c]) : 0.f;
  }

  float o[2][NC];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < NC; ++n) o[i][n] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < S; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed (and q is stored)
    for (int i = tid; i < kBK * C; i += kThreads) {
      const int r = i / C, c = i - r * C;
      const int kj = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (kj < S) {
        kv = vf::to_f(kb[kj * rstride + c]);
        vv = vf::to_f(vb[kj * rstride + c]);
      }
      kt[c * ldk + r] = kv;
      vs[r * C + c] = vv;
    }
    __syncthreads();

    float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    for (int c = 0; c < C; ++c) {
      const float a0 = qs[ty * ldq + c], a1 = qs[(ty + 16) * ldq + c];
      const float b0 = kt[c * ldk + tx], b1 = kt[c * ldk + tx + 16];
      s[0][0] += a0 * b0;
      s[0][1] += a0 * b1;
      s[1][0] += a1 * b0;
      s[1][1] += a1 * b1;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
        s[i][j] = (k0 + tx + 16 * j < S) ? s[i][j] * scale : -CUDART_INF_F;
      // the 16 threads of a query row are one half-warp: xor < 16 stays
      float mx = fmaxf(s[i][0], s[i][1]);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);  // finite: key k0 is valid
      const float alpha = expf(m[i] - m_new);
      const float p0 = expf(s[i][0] - m_new), p1 = expf(s[i][1] - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < NC; ++n) o[i][n] *= alpha;
      ps[(ty + 16 * i) * ldp + tx] = p0;
      ps[(ty + 16 * i) * ldp + tx + 16] = p1;
    }
    __syncthreads();

    const int kn = min(kBK, S - k0);
    for (int j = 0; j < kn; ++j) {
      const float p0 = ps[ty * ldp + j], p1 = ps[(ty + 16) * ldp + j];
      const float* vr = vs + j * C;
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const int c = tx + 16 * n;
        if (c < C) {
          const float vv = vr[c];
          o[0][n] += p0 * vv;
          o[1][n] += p1 * vv;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= S) continue;
    const float inv = 1.f / l[i];
    float* orow = out + (static_cast<size_t>(b) * S + qi) * C;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int c = tx + 16 * n;
      if (c < C) orow[c] = o[i][n] * inv;
    }
  }
}

template <typename T, int NC>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int C, long long bstride, long long rstride, float scale,
           cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(kBQ) * (C + 1) + static_cast<size_t>(C) * (kBK + 1) +
       static_cast<size_t>(kBK) * C + kBQ * (kBK + 1)) *
      sizeof(float);
  constexpr int kMaxSmem = 227 * 1024;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  // once per instantiation (not per launch, so that launches can be
  // captured into a CUDA graph): allow the whole of shared memory
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        attn_fwd<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((S + kBQ - 1) / kBQ, B);
  attn_fwd<T, NC><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<float*>(out), S, C, bstride,
      rstride, scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int S, int C, long long bstride, long long rstride, float scale,
             cudaStream_t st) {
  const int nc = (C + 15) / 16;
#define VF_ATTN_CASE(N)                                                     \
  if (nc <= N)                                                              \
    return launch<T, N>(q, k, v, out, B, S, C, bstride, rstride, scale, st);
  VF_ATTN_CASE(4)
  VF_ATTN_CASE(8)
  VF_ATTN_CASE(12)
  VF_ATTN_CASE(16)
  VF_ATTN_CASE(20)
  VF_ATTN_CASE(24)
  VF_ATTN_CASE(32)
  VF_ATTN_CASE(36)
#undef VF_ATTN_CASE
  return cudaErrorInvalidValue;  // C > 576 does not fit shared memory
}


// ---------------------------------------------------------------------
// tensor-core path (bf16)
// ---------------------------------------------------------------------
constexpr int kMmaBQ = 64;  // queries per block: 4 warps x 16
constexpr int kMmaBK = 64;  // keys per tile
constexpr int kMmaThreads = 128;
constexpr int kMmaMaxC = 320;

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// x0, x1 = hi + mid + lo exactly, each term a bf16 pair (packed as a
// fragment register: x0 in the low half).
__device__ __forceinline__ void split3(float x0, float x1, uint32_t* hi,
                                       uint32_t* mid, uint32_t* lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = x0 - hf.x, r1 = x1 - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  *hi = as_u32(h);
  *mid = as_u32(m);
  *lo = as_u32(__floats2bfloat162_rn(r0 - mf.x, r1 - mf.y));
}

template <int CP>  // CP: channels padded to a multiple of 16 (>= C)
__global__ void __launch_bounds__(kMmaThreads)
    attn_fwd_mma(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, float* __restrict__ out,
                 int S, int C, long long bstride, long long rstride,
                 float scale) {
  constexpr int NT = CP / 8;       // 8-channel output tiles per warp
  constexpr int LDQ = CP + 8;      // padded rows (bf16 elements)
  constexpr int LDV = kMmaBK + 8;
  constexpr int CHUNKS = CP / 8;   // 16-byte chunks per padded row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kMmaBQ * LDQ;   // [key][LDQ]
  __nv_bfloat16* vt = ks + kMmaBK * LDQ;   // [channel][LDV], V transposed

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.y, q0 = blockIdx.x * kMmaBQ;
  const __nv_bfloat16* qb = q + b * bstride;
  const __nv_bfloat16* kb = k + b * bstride;
  const __nv_bfloat16* vb = v + b * bstride;
  const int cchunks = C / 8;  // real 16-byte chunks per row
  const uint4 zero = make_uint4(0, 0, 0, 0);

  for (int i = tid; i < kMmaBQ * CHUNKS; i += kMmaThreads) {
    const int r = i / CHUNKS, cc = i - r * CHUNKS;
    const int qi = q0 + r;
    uint4 val = zero;
    if (qi < S && cc < cchunks)
      val = *reinterpret_cast<const uint4*>(qb + qi * rstride + cc * 8);
    *reinterpret_cast<uint4*>(qs + r * LDQ + cc * 8) = val;
  }

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;  // rows g and g + 8
  float l0 = 0.f, l1 = 0.f;                      // this thread's part
  const __nv_bfloat16* qw = qs + warp * 16 * LDQ;

  for (int k0 = 0; k0 < S; k0 += kMmaBK) {
    __syncthreads();  // the previous tile is consumed (and q is stored)
    for (int i = tid; i < kMmaBK * CHUNKS; i += kMmaThreads) {
      const int r = i / CHUNKS, cc = i - r * CHUNKS;
      const int kj = k0 + r;
      uint4 val = zero;
      if (kj < S && cc < cchunks)
        val = *reinterpret_cast<const uint4*>(kb + kj * rstride + cc * 8);
      *reinterpret_cast<uint4*>(ks + r * LDQ + cc * 8) = val;
    }
    // V: consecutive threads take consecutive keys, so the transposed
    // 2-byte stores fall in distinct banks
    for (int i = tid; i < kMmaBK * CHUNKS; i += kMmaThreads) {
      const int cc = i / kMmaBK, r = i - cc * kMmaBK;
      const int kj = k0 + r;
      uint4 val = zero;
      if (kj < S && cc < cchunks)
        val = *reinterpret_cast<const uint4*>(vb + kj * rstride + cc * 8);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) vt[(cc * 8 + j) * LDV + r] = e[j];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 queries x 64 keys
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll 2
    for (int kc = 0; kc < CP / 16; ++kc) {
      const int c = kc * 16 + t4 * 2;
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(qw + g * LDQ + c);
      a[1] = *reinterpret_cast<const uint32_t*>(qw + (g + 8) * LDQ + c);
      a[2] = *reinterpret_cast<const uint32_t*>(qw + g * LDQ + c + 8);
      a[3] = *reinterpret_cast<const uint32_t*>(qw + (g + 8) * LDQ + c + 8);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const __nv_bfloat16* kr = ks + (n * 8 + g) * LDQ + c;
        mma_bf16(s[n], a, *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    // online softmax; a row's 64 scores live in the 4 lanes of its group
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool valid = k0 + n * 8 + t4 * 2 + j < S;
        s[n][j] = valid ? s[n][j] * scale : -CUDART_INF_F;
        s[n][j + 2] = valid ? s[n][j + 2] * scale : -CUDART_INF_F;
        mx0 = fmaxf(mx0, s[n][j]);
        mx1 = fmaxf(mx1, s[n][j + 2]);
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);  // finite
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= al0;
    l1 *= al1;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= al0;
      o[n][1] *= al0;
      o[n][2] *= al1;
      o[n][3] *= al1;
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = expf(s[n][0] - mn0);
      s[n][1] = expf(s[n][1] - mn0);
      s[n][2] = expf(s[n][2] - mn1);
      s[n][3] = expf(s[n][3] - mn1);
      l0 += s[n][0] + s[n][1];
      l1 += s[n][2] + s[n][3];
    }

    // O += P V, 16 keys at a time, P split into three exact bf16 terms
#pragma unroll
    for (int kc = 0; kc < kMmaBK / 16; ++kc) {
      uint32_t ph[4], pm[4], pl[4];
      split3(s[2 * kc][0], s[2 * kc][1], &ph[0], &pm[0], &pl[0]);
      split3(s[2 * kc][2], s[2 * kc][3], &ph[1], &pm[1], &pl[1]);
      split3(s[2 * kc + 1][0], s[2 * kc + 1][1], &ph[2], &pm[2], &pl[2]);
      split3(s[2 * kc + 1][2], s[2 * kc + 1][3], &ph[3], &pm[3], &pl[3]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const __nv_bfloat16* vr = vt + (n * 8 + g) * LDV + kc * 16 + t4 * 2;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(vr);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(vr + 8);
        mma_bf16(o[n], ph, b0, b1);
        mma_bf16(o[n], pm, b0, b1);
        mma_bf16(o[n], pl, b0, b1);
      }
    }
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = n * 8 + t4 * 2;
    if (c >= C) continue;
    if (r0 < S)
      *reinterpret_cast<float2*>(out + (static_cast<size_t>(b) * S + r0) * C +
                                 c) = make_float2(o[n][0] * inv0,
                                                  o[n][1] * inv0);
    if (r1 < S)
      *reinterpret_cast<float2*>(out + (static_cast<size_t>(b) * S + r1) * C +
                                 c) = make_float2(o[n][2] * inv1,
                                                  o[n][3] * inv1);
  }
}

template <int CP>
int launch_mma(const void* q, const void* k, const void* v, void* out, int B,
               int S, int C, long long bstride, long long rstride,
               float scale, cudaStream_t stream) {
  constexpr int kSmem =
      ((kMmaBQ + kMmaBK) * (CP + 8) + CP * (kMmaBK + 8)) * 2;
  static bool configured = false;  // once, so launches can be captured
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        attn_fwd_mma<CP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((S + kMmaBQ - 1) / kMmaBQ, B);
  attn_fwd_mma<CP><<<grid, kMmaThreads, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<float*>(out), S, C,
      bstride, rstride, scale);
  return cudaGetLastError();
}

// The mma path reads 16-byte chunks: C, both strides and the three base
// pointers must keep every row 16-byte aligned.
bool mma_fits(const void* q, const void* k, const void* v, int C,
              long long bstride, long long rstride) {
  return C % 8 == 0 && C <= kMmaMaxC && rstride % 8 == 0 &&
         bstride % 8 == 0 && vf::aligned(q, 16) && vf::aligned(k, 16) &&
         vf::aligned(v, 16);
}

int dispatch_mma(const void* q, const void* k, const void* v, void* out,
                 int B, int S, int C, long long bstride, long long rstride,
                 float scale, cudaStream_t st) {
#define VF_MMA_CASE(CP)                                                      \
  if (C <= CP)                                                               \
    return launch_mma<CP>(q, k, v, out, B, S, C, bstride, rstride, scale, st);
  VF_MMA_CASE(16)
  VF_MMA_CASE(32)
  VF_MMA_CASE(64)
  VF_MMA_CASE(96)
  VF_MMA_CASE(128)
  VF_MMA_CASE(192)
  VF_MMA_CASE(256)
  VF_MMA_CASE(320)
#undef VF_MMA_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int vf_attention_fwd(const void* q, const void* k, const void* v,
                                void* out, int B, int S, int C,
                                long long bstride, long long rstride,
                                float scale, int dtype, void* stream) {
  if (B < 1 || S < 1 || C < 1 || B > 65535) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == vf::kBFloat16) {
    if (mma_fits(q, k, v, C, bstride, rstride))
      return dispatch_mma(q, k, v, out, B, S, C, bstride, rstride, scale, st);
    return dispatch<__nv_bfloat16>(q, k, v, out, B, S, C, bstride, rstride,
                                   scale, st);
  }
  if (dtype == vf::kFloat32)
    return dispatch<float>(q, k, v, out, B, S, C, bstride, rstride, scale,
                           st);
  return cudaErrorInvalidValue;
}
