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
// C = 320; 48 rows served, 98 trained, 28 in the ancestral chain): bytes.
// 4*S*C flops per row of q against 3*2*C bytes read (bf16) and 4*C
// written is 4*S/10 ~ 100 flop/byte at S = 256, under the ~295 flop/byte
// ridge of the bf16 tensor cores but far above the ~20 flop/byte ridge of
// f32 math on the CUDA cores.  At 48 rows, S = 256, C = 192 the bytes
// (23.6 MB) take 7.0 us at 3.35 TB/s.  So the products run on the tensor
// cores without giving up f32 results:
//
// attn_fwd_wgmma (bf16 inputs, C a multiple of 8, C <= 320: the UNet's
// path).  A block is one warpgroup (128 threads) and owns 64 queries of a
// row and `cpart` of its output channels; `parts` blocks split the
// channels (ops/attention.py attention_plan).  Work units (blocks) per
// site: S = 256, C = 192: 192 at 48 rows, 392 at 98, 112 at 28 (parts 1:
// a second part would fetch all of K again);
// S = 64, C = 320: parts 2 (one 320-wide O accumulator would take 160
// registers a thread), 96 blocks at 48 rows, 196 at 98, 56 at 28.
//  * S = Q.K^T: wgmma m64n64k16, A = Q and B = K both K-major (channels
//    contiguous, as the qkv slices are) from shared memory, C/16 products
//    per 64-key tile into 32 f32 registers a thread.  A product of two
//    bf16 values is exact in f32, so this is the f32 math of the TPU
//    kernel up to summation order.
//  * Online softmax (running max and sum) on the accumulator in registers.
//  * O += P.V: wgmma m64nNk16 (N = 64, 128 or 192: the block's channels
//    rounded up to 64) with A = P from registers (the S accumulator of a
//    warp is the A fragment of its 16 rows) and B = V read N-major
//    ("transposed") straight from its staged tile: no transposed copy.
//    P is split exactly into three bf16 terms (8 + 8 + 8 bits of
//    mantissa), three products into one f32 accumulator: exact products,
//    f32 sums (SDPA rounds P to bf16 once; this does not).
//  * Operand layout: 128-byte swizzle.  A tile is stored as blocks of 64
//    channels x 64 rows (8 KB: rows of 128 bytes, their 16-byte chunks
//    permuted by row % 8), exactly as one TMA box with SWIZZLE_128B
//    writes it.  Q and K (K-major): SBO 1 KB (next 8 rows); the k-slice
//    of channels 16c .. 16c + 15 starts (c / 4) * 8 KB + (c % 4) * 32
//    bytes in.  V (N-major): SBO 1 KB (next 8 keys), LBO 8 KB (next 64
//    channels); the slice of keys 16kk .. starts kk * 2 KB in.
//  * Staging: TMA tiled loads from three tensor maps over the strided
//    q, k, v views (dims C, S, B; the row stride 3C * 2 bytes is a
//    multiple of 16), one 8 KB box per 64 channels (128 contiguous bytes
//    of a row each; 16-byte-wide boxes took 28.7 us per (48, 256, 192)
//    call against 16.3 on an H100 at 700 W, chip_smoke.py phase 4),
//    issued by one thread into a ring of three slots with one mbarrier
//    each, K and V tiles alternating (K0 V0 K1 V1 ...), so V_j and
//    K_{j+1} fly while S_j is multiplied, and K_{j+1} and V_{j+1} while
//    P_j V_j is.  Q is staged once.  Shared memory: 96 KB at C = 192 (two blocks an SM),
//    120 KB at S = 64, C = 320 (two slots).  The host encodes the three
//    maps per call (cuTensorMapEncodeTiled, found in the loaded driver).
//  * Rows past S and channels past C arrive as zeros from TMA (no NaN
//    from stale memory can reach an MMA); keys past S are masked to -inf
//    before the softmax.
//
// attn_fwd (f32 inputs, or shapes the wgmma path does not take): the same
// online softmax with f32 FMAs on the CUDA cores.  One block per (batch
// row, 32 queries), 256 threads as a 16 x 16 grid, key tiles of 32; each
// thread owns 2 queries x 2 keys of a score tile and 2 queries x
// ceil(C/16) output channels in registers; K is stored transposed.

#include <math_constants.h>

#include "common.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

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
// tensor-core path (bf16): wgmma, TMA staging
// ---------------------------------------------------------------------
constexpr int kWgQ = 64;        // queries per block: one warpgroup, wgmma M
constexpr int kWgKeys = 64;     // keys per tile: the N of S = Q K^T
constexpr int kWgThreads = 128;
constexpr int kWgMaxC = 320;
constexpr int kWgMaxNV = 3;     // output channels per block <= 64 * 3
constexpr int kWgSlots = 3;     // staging ring: K and V tiles alternate
constexpr int kBlockCh = 64;    // channels of a TMA box: 128-byte rows
constexpr int kBlockBytes = kWgQ * 128;  // 64 rows x 64 channels, one box

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

// Stage 64 rows (r0 ...) x 64 * blocks channels (ch0 ...) of row b of a
// (B, S, C) tensor map: one 8 KB box per 64 channels (64 rows of 128
// bytes, 128-byte swizzled), block k at k * 8192.  Rows >= S and channels
// >= C arrive as zeros.
__device__ __forceinline__ void stage_tile(unsigned char* dst,
                                           const CUtensorMap* map,
                                           uint64_t* bar, int r0, int ch0,
                                           int blocks, int b) {
  vf::mbar_expect(bar, blocks * kBlockBytes);
  for (int k = 0; k < blocks; ++k)
    vf::tma_load_3d(dst + k * kBlockBytes, map, bar, ch0 + kBlockCh * k, r0,
                    b);
}

template <int NV>  // NV: 64-channel blocks of the output channels a block owns
__global__ void __launch_bounds__(kWgThreads)
    attn_fwd_wgmma(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   float* __restrict__ out, int S, int C, int cpart,
                   float scale) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int qb = (C + kBlockCh - 1) / kBlockCh;    // Q/K blocks (K of Q.K^T)
  constexpr int vb = NV;                            // V blocks (N of P.V)
  const int slot_bytes = kBlockBytes * (qb > vb ? qb : vb);
  const int ntiles = (S + kWgKeys - 1) / kWgKeys, nloads = 2 * ntiles;
  const int nslots = nloads < kWgSlots ? nloads : kWgSlots;
  unsigned char* qs = smem_raw;
  unsigned char* slots = qs + kBlockBytes * qb;
  // mbarriers of the ring's slots, then Q's, after the tiles (all of
  // shared memory is dynamic: the launch may ask for the whole 227 KB)
  uint64_t* bars = reinterpret_cast<uint64_t*>(slots + nslots * slot_bytes);
  const uint32_t qs_a = vf::smem_u32(qs), slots_a = vf::smem_u32(slots);

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * kWgQ, n0 = blockIdx.y * cpart, b = blockIdx.z;
  const int n_end = min(C, n0 + cpart);
  const bool leader = threadIdx.x == 0;
  const CUtensorMap *kp = &kmap, *vp = &vmap;

  // load i of the ring: K tile i / 2 (even i) or V tile i / 2 (odd i)
  // into slot i % kWgSlots, issued by one thread
  auto issue = [&](int i) {
    if (!leader || i >= nloads) return;
    const int slot = i % kWgSlots;
    unsigned char* dst = slots + slot * slot_bytes;
    if (i % 2 == 0)
      stage_tile(dst, kp, &bars[slot], (i / 2) * kWgKeys, 0, qb, b);
    else
      stage_tile(dst, vp, &bars[slot], (i / 2) * kWgKeys, n0, vb, b);
  };
  // the parity of load i's completion on its slot's barrier
  auto wait_load = [&](int i) {
    vf::mbar_wait(&bars[i % kWgSlots], (i / kWgSlots) & 1);
  };
  if (leader) {
    for (int i = 0; i <= kWgSlots; ++i) vf::mbar_init(&bars[i], 1);
    vf::mbar_fence_init();
  }
  __syncthreads();
  if (leader) stage_tile(qs, &qmap, &bars[kWgSlots], q0, 0, qb, b);
  issue(0);
  issue(1);
  issue(2);

  float o[NV * 32];
#pragma unroll
  for (int i = 0; i < NV * 32; ++i) o[i] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;  // rows g and g + 8
  float l0 = 0.f, l1 = 0.f;                      // this thread's part
  vf::mbar_wait(&bars[kWgSlots], 0);            // Q

  for (int j = 0; j < ntiles; ++j) {
    wait_load(2 * j);  // K_j
    const uint32_t ks = slots_a + ((2 * j) % kWgSlots) * slot_bytes;
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) vf::fence_reg(s[i]);
    vf::wg_fence();
    // Q and K are K-major, 128-byte swizzled: SBO 1 KB (next 8 rows); the
    // k-slice of channels 16c.. starts 32 bytes into its block's rows
    for (int c = 0; c < (C + 15) / 16; ++c) {
      const uint32_t off = (c / 4) * kBlockBytes + (c % 4) * 32;
      vf::wgmma_m64n64k16_ss<0, 0>(s, vf::wg_desc_sw128(qs_a + off, 16, 1024),
                                   vf::wg_desc_sw128(ks + off, 16, 1024),
                                   c > 0);
    }
    vf::wg_commit();
    vf::wg_wait<0>();
#pragma unroll
    for (int i = 0; i < 32; ++i) vf::fence_reg(s[i]);
    __syncthreads();  // every warp is done with K_j's slot
    issue(2 * j + 3);

    // online softmax; a row's 64 scores live in the 4 lanes of its group
    const int k0 = j * kWgKeys;
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool valid = k0 + n * 8 + t4 * 2 + e < S;
        s[4 * n + e] = valid ? s[4 * n + e] * scale : -CUDART_INF_F;
        s[4 * n + e + 2] = valid ? s[4 * n + e + 2] * scale : -CUDART_INF_F;
        mx0 = fmaxf(mx0, s[4 * n + e]);
        mx1 = fmaxf(mx1, s[4 * n + e + 2]);
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
    for (int i = 0; i < NV * 8; ++i) {
      o[4 * i] *= al0;
      o[4 * i + 1] *= al0;
      o[4 * i + 2] *= al1;
      o[4 * i + 3] *= al1;
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[4 * n] = expf(s[4 * n] - mn0);
      s[4 * n + 1] = expf(s[4 * n + 1] - mn0);
      s[4 * n + 2] = expf(s[4 * n + 2] - mn1);
      s[4 * n + 3] = expf(s[4 * n + 3] - mn1);
      l0 += s[4 * n] + s[4 * n + 1];
      l1 += s[4 * n + 2] + s[4 * n + 3];
    }
    // P as A fragments, split into three exact bf16 terms: [term][kk][4]
    uint32_t p[3][4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int i = 8 * kk + 2 * f;  // f: (row g | g+8) x (keys | keys+8)
        split3(s[i], s[i + 1], &p[0][kk][f], &p[1][kk][f], &p[2][kk][f]);
      }
    }

    wait_load(2 * j + 1);  // V_j
    const uint32_t vs = slots_a + ((2 * j + 1) % kWgSlots) * slot_bytes;
#pragma unroll
    for (int i = 0; i < NV * 32; ++i) vf::fence_reg(o[i]);
    vf::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // V is N-major, 128-byte swizzled: SBO 1 KB (next 8 keys), LBO 8 KB
      // (next 64 channels)
      const uint64_t d =
          vf::wg_desc_sw128(vs + kk * 2048, kBlockBytes, 1024);
#pragma unroll
      for (int t = 0; t < 3; ++t) vf::wgmma_rs<64 * NV>(o, p[t][kk], d);
    }
    vf::wg_commit();
    vf::wg_wait<0>();
#pragma unroll
    for (int i = 0; i < NV * 32; ++i) vf::fence_reg(o[i]);
    __syncthreads();  // every warp is done with V_j's slot
    issue(2 * j + 4);
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  float* ob = out + static_cast<size_t>(b) * S * C;
#pragma unroll
  for (int i = 0; i < NV * 8; ++i) {
    const int c = n0 + 8 * i + t4 * 2;
    if (c >= n_end) continue;
    if (r0 < S)
      *reinterpret_cast<float2*>(ob + static_cast<size_t>(r0) * C + c) =
          make_float2(o[4 * i] * inv0, o[4 * i + 1] * inv0);
    if (r1 < S)
      *reinterpret_cast<float2*>(ob + static_cast<size_t>(r1) * C + c) =
          make_float2(o[4 * i + 2] * inv1, o[4 * i + 3] * inv1);
  }
}

// Shared memory of one block: Q, min(3, 2 * key tiles) ring slots and
// the barriers.
size_t wgmma_smem(int S, int C, int vb) {
  const int qb = (C + kBlockCh - 1) / kBlockCh;
  const int nloads = 2 * ((S + kWgKeys - 1) / kWgKeys);
  const int slots = nloads < kWgSlots ? nloads : kWgSlots;
  return static_cast<size_t>(kBlockBytes) * (qb + slots * (qb > vb ? qb : vb)) +
         vf::kBarBytes;
}

// A (B, S, C) bf16 map with row stride `rstride` and batch stride
// `bstride` (elements), boxes of 64 channels x 64 rows, 128-byte swizzled.
bool encode_rows(CUtensorMap* map, const void* base, int B, int S, int C,
                 long long bstride, long long rstride) {
  const uint64_t dims[3] = {static_cast<uint64_t>(C),
                            static_cast<uint64_t>(S),
                            static_cast<uint64_t>(B)};
  const uint64_t strides[2] = {static_cast<uint64_t>(rstride) * 2,
                               static_cast<uint64_t>(bstride) * 2};
  const uint32_t box[3] = {kBlockCh, kWgKeys, 1};
  return vf::encode_bf16(map, base, 3, dims, strides, box,
                         CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int NV>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 int B, int S, int C, int parts, int cpart, long long bstride,
                 long long rstride, float scale, cudaStream_t stream) {
  static bool configured = false;  // once, so launches can be captured
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        attn_fwd_wgmma<NV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        227 * 1024);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  CUtensorMap maps[3];
  const void* bases[3] = {q, k, v};
  for (int i = 0; i < 3; ++i)
    if (!encode_rows(&maps[i], bases[i], B, S, C, bstride, rstride))
      return cudaErrorInvalidValue;
  const dim3 grid((S + kWgQ - 1) / kWgQ, parts, B);
  attn_fwd_wgmma<NV><<<grid, kWgThreads, wgmma_smem(S, C, NV), stream>>>(
      maps[0], maps[1], maps[2], static_cast<float*>(out), S, C, cpart,
      scale);
  return cudaGetLastError();
}

// The wgmma path's tensor maps need 16-byte strides and base pointers.
bool wgmma_fits(const void* q, const void* k, const void* v, int C,
                long long bstride, long long rstride) {
  return C % 8 == 0 && C <= kWgMaxC && rstride % 8 == 0 &&
         bstride % 8 == 0 && vf::aligned(q, 16) && vf::aligned(k, 16) &&
         vf::aligned(v, 16);
}

// Channels a block owns for `parts` parts: ceil(C / parts) rounded up to
// the 16-byte chunk (ops/attention.py attention_plan computes the same).
int part_width(int C, int parts) { return ((C + parts - 1) / parts + 7) / 8 * 8; }

int dispatch_wgmma(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int C, int parts, long long bstride,
                   long long rstride, float scale, cudaStream_t st) {
  if (parts < 1 || parts > 2) return cudaErrorInvalidValue;
  const int cpart = part_width(C, parts);
  const int nv = (cpart + kBlockCh - 1) / kBlockCh;
  if (nv > kWgMaxNV || wgmma_smem(S, C, nv) > 227 * 1024)
    return cudaErrorInvalidValue;
#define VF_WG_CASE(N)                                                       \
  if (nv == N)                                                              \
    return launch_wgmma<N>(q, k, v, out, B, S, C, parts, cpart, bstride,    \
                           rstride, scale, st);
  VF_WG_CASE(1)
  VF_WG_CASE(2)
  VF_WG_CASE(3)
#undef VF_WG_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// `parts`: blocks along the output channels per (row, 64 queries) on the
// tensor-core path (1 or 2; ops/attention.py attention_plan); the
// CUDA-core path ignores it.
extern "C" int vf_attention_fwd(const void* q, const void* k, const void* v,
                                void* out, int B, int S, int C,
                                long long bstride, long long rstride,
                                float scale, int parts, int dtype,
                                void* stream) {
  if (B < 1 || S < 1 || C < 1 || B > 65535) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == vf::kBFloat16) {
    if (wgmma_fits(q, k, v, C, bstride, rstride))
      return dispatch_wgmma(q, k, v, out, B, S, C, parts, bstride, rstride,
                            scale, st);
    return dispatch<__nv_bfloat16>(q, k, v, out, B, S, C, bstride, rstride,
                                   scale, st);
  }
  if (dtype == vf::kFloat32)
    return dispatch<float>(q, k, v, out, B, S, C, bstride, rstride, scale,
                           st);
  return cudaErrorInvalidValue;
}
