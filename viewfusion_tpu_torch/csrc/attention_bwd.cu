// K5: the backward of K3's single-head attention for heads of 64, Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX op's custom VJP (viewfusion_tpu/ops/
// attention.py `_attn_bwd`) leaves the closed-form gradient to XLA.  The
// port's closed form (ops/attention.py spatial_self_attention_backward)
// writes P, dP and dS, each (B, S, S) f32, to device memory and runs its
// four products in f32 with TF32 off; at the ADM's S = 1024 sites that
// took 212 of a 471 ms training step on the H100.  K5 computes the same
// gradients tile by tile and writes no score-sized tensor.
//
// Function, per batch row b, with s = q k^T * scale and P = softmax(s)
// over the keys (f32):
//   dv = P^T g,  dP = g v^T,  D = rowsum(P o dP),
//   dS = P o (dP - D) * scale,  dq = dS k,  dk = dS^T q,
// q, k, v bf16 (B, S, 64) with a row and a batch stride (channels
// contiguous), g f32 (B, S, 64) contiguous, dq, dk, dv bf16 (B, S, 64)
// contiguous.
//
// Bound on the H100: operations.  The four products are 8 * S^2 * 64
// FLOPs a row against 16 * S * 64 bytes (q, k, v, dq, dk, dv in bf16, g in
// f32), S / 2 FLOP a byte: above the bf16 ridge (~295) at S = 1024, below
// it at S = 256 and 64.  So every product runs on the tensor cores
// (wgmma), without giving up the f32 products of the closed form:
//  * q, k, v are bf16: their products are exact in f32 accumulators.
//  * P and dS are f32: as A operands from registers they are split exactly
//    into three bf16 terms (vf::split3, as K3 splits P), three products.
//  * g is f32.  On the models' paths it is the gradient of a cast to bf16,
//    so its values are bf16 values; the first kernel splits it into bf16
//    planes hi, mid, lo and marks each 64-query tile whose mid or lo term
//    is not zero.  Only the marked tiles run the products of mid and lo
//    (P g: p_hi g_mid, p_mid g_mid, p_hi g_lo besides the three of g_hi;
//    the terms left out are below 2^-24 of the product).  The test reads
//    the input, so the result does not depend on it.
//
// Three kernels, tiles of 64 queries x 64 keys, one warpgroup (128
// threads) a block, operand tiles staged by TMA as 64 rows x 64 channels
// of 128-byte swizzled bf16 (one 8 KB box, the layout of K3's tiles):
//  attn_bwd_rows (b, 64 queries): S = Q K^T (ss) and dP = g V^T (A = g
//    from registers, B = V K-major) over the key tiles with an online
//    max: row max m, 1 / l and D = sum(e^(s - m) dP) / l; it writes g's
//    planes and the tile's mark.  Shared memory 57 KB (Q, three K/V
//    stages).
//  attn_bwd_kv (b, 64 keys): walks the query tiles with dK and dV in
//    registers: S^T = K Q^T and dP^T = V G^T (ss, keys as the M rows, so
//    P^T is the A fragment as it stands), then dV += P^T G and dK += dS^T
//    Q (A from registers, B = G or Q read N-major from its staged tile, as
//    K3 reads V).  Two stages of (Q, G hi, mid, lo, the tile's m, 1/l, D):
//    84 KB, two blocks an SM.
//  attn_bwd_q (b, 64 queries): walks the key tiles with dQ in registers:
//    S = Q K^T, dP = G V^T (ss), dQ += dS K (B = K N-major).  dQ is summed
//    in one block, without atomics, so the result repeats bit for bit.
//    64 KB (two K/V stages: three blocks an SM, 5% faster at the ADM's
//    sites than three stages and two blocks on an H100).
// Rows past S arrive as zeros from TMA; keys past S are masked out of the
// softmax and out of P^T, and a query tile's statistics past S are zero,
// which makes its P zero.
// Kernel names carry `attn_bwd`: the benchmark's trace classifier reads
// them as K5's and as no GEMM.

#include <math_constants.h>

#include "common.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kC = 64;              // head width
constexpr int kT = 64;              // queries or keys a tile
constexpr int kThreads = 128;       // one warpgroup: wgmma's 64 rows
constexpr int kTile = kT * 128;     // one staged 64 x 64 bf16 tile: 8 KB
constexpr int kStats = 3 * kT;      // m, 1 / l, D of a query tile (floats)
constexpr int kStatBytes = kStats * 4;
constexpr int kRowsStages = 3;      // attn_bwd_rows: K/V stages
constexpr int kKvStages = 2;        // attn_bwd_kv: Q/G/stats stages
constexpr int kKvStage = 4 * kTile + 1024;  // Q, G hi/mid/lo, stats
constexpr int kQStages = 2;         // attn_bwd_q: K/V stages

constexpr size_t kRowsSmem =
    static_cast<size_t>(kTile) * (1 + 2 * kRowsStages) + vf::kBarBytes;
constexpr size_t kKvSmem = static_cast<size_t>(2 * kTile) +
                           static_cast<size_t>(kKvStage) * kKvStages +
                           vf::kBarBytes;
constexpr size_t kQSmem =
    static_cast<size_t>(kTile) * (4 + 2 * kQStages) + vf::kBarBytes;
// two blocks of each pass to an SM (228 KB, 1 KB of it reserved a block)
static_assert(2 * kRowsSmem <= 227 * 1024 && 2 * kKvSmem <= 227 * 1024 &&
                  2 * kQSmem <= 227 * 1024,
              "K5: a pass's block must leave room for a second on its SM");

// wgmma descriptors of a staged tile: the k-slice c (channels 16c ..) of a
// K-major operand (rows of 64 channels), or the k-slice kk (rows 16kk ..)
// of an N-major one (B read "transposed": its rows are the K of the
// product, its channels the N).
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int c) {
  return vf::wg_desc_sw128(tile + c * 32, 16, 1024);
}
__device__ __forceinline__ uint64_t nmajor(uint32_t tile, int kk) {
  return vf::wg_desc_sw128(tile + kk * 2048, kTile, 1024);
}

__device__ __forceinline__ void fence_all(float* r) {
#pragma unroll
  for (int i = 0; i < 32; ++i) vf::fence_reg(r[i]);
}

// The accumulator of a warp's 16 rows (index 4n + 2h + e: row g + 8h,
// column 8n + 2 t4 + e) as the A fragments of the next product, each
// value split into three exact bf16 terms: a[term][k-slice][register].
__device__ __forceinline__ void split_frags(const float* x,
                                            uint32_t (*a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int i = 8 * kk + 2 * f;  // f: (row g | g+8) x (cols | cols+8)
      vf::split3(x[i], x[i + 1], &a[0][kk][f], &a[1][kk][f], &a[2][kk][f]);
    }
}

// Write a warp's 16 rows of a 64 x 64 f32 accumulator as bf16 rows r0 ..
// of `out` (B, S, 64) row b; rows past S are left out.
__device__ __forceinline__ void store_rows(const float* acc,
                                           __nv_bfloat16* out, int b, int S,
                                           int r0, int t4) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= S) continue;
    __nv_bfloat16* row = out + (static_cast<size_t>(b) * S + r) * kC;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * n + 2 * t4) =
          __floats2bfloat162_rn(acc[4 * n + 2 * h], acc[4 * n + 2 * h + 1]);
  }
}

// ---------------------------------------------------------------------
// 1. per query tile: softmax statistics, D, g's planes and the tile's mark
// ---------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
    attn_bwd_rows(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  const float* __restrict__ g,
                  __nv_bfloat16* __restrict__ planes,
                  float* __restrict__ stats, int* __restrict__ marks, int S,
                  float scale) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* qs = smem_raw;
  unsigned char* ring = qs + kTile;  // stage st: K at 2 st, V at 2 st + 1
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(ring + 2 * kRowsStages * kTile);
  const int lane = threadIdx.x & 31, gr = lane >> 2, t4 = lane & 3;
  const int warp = threadIdx.x >> 5;
  const int tile = blockIdx.x, b = blockIdx.y;
  const int ntiles = gridDim.x, B = gridDim.y;
  const int q0 = tile * kT;
  const bool leader = threadIdx.x == 0;
  const CUtensorMap *kp = &kmap, *vp = &vmap;

  auto issue = [&](int j) {
    if (!leader || j >= ntiles) return;
    const int st = j % kRowsStages;
    unsigned char* dst = ring + 2 * st * kTile;
    vf::mbar_expect(&bars[st], 2 * kTile);
    vf::tma_load_3d(dst, kp, &bars[st], 0, j * kT, b);
    vf::tma_load_3d(dst + kTile, vp, &bars[st], 0, j * kT, b);
  };
  if (leader) {
    for (int i = 0; i <= kRowsStages; ++i) vf::mbar_init(&bars[i], 1);
    vf::mbar_fence_init();
  }
  __syncthreads();
  if (leader) {
    vf::mbar_expect(&bars[kRowsStages], kTile);
    vf::tma_load_3d(qs, &qmap, &bars[kRowsStages], 0, q0, b);
  }
  for (int j = 0; j < kRowsStages; ++j) issue(j);

  // g's A fragments (rows r0, r1 of the tile), split into three terms
  const int r0 = q0 + warp * 16 + gr, r1 = r0 + 8;
  const float* gb = g + static_cast<size_t>(b) * S * kC;
  uint32_t ga[3][4][4];
  bool low = false;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int r = (f & 1) ? r1 : r0;
      const int c = 16 * kk + 8 * (f >> 1) + 2 * t4;
      float2 x = make_float2(0.f, 0.f);
      if (r < S)
        x = *reinterpret_cast<const float2*>(gb + static_cast<size_t>(r) * kC
                                             + c);
      vf::split3(x.x, x.y, &ga[0][kk][f], &ga[1][kk][f], &ga[2][kk][f]);
      low |= (ga[1][kk][f] | ga[2][kk][f]) != 0u;
    }
  const int terms = __syncthreads_or(low) ? 3 : 1;
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    if (t >= terms) break;
    __nv_bfloat16* pb = planes + (static_cast<size_t>(t) * B + b) * S * kC;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int r = (f & 1) ? r1 : r0;
        const int c = 16 * kk + 8 * (f >> 1) + 2 * t4;
        if (r < S)
          *reinterpret_cast<uint32_t*>(pb + static_cast<size_t>(r) * kC + c) =
              ga[t][kk][f];
      }
  }
  if (leader) marks[b * ntiles + tile] = terms == 3;

  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;  // rows r0 and r1
  float l0 = 0.f, l1 = 0.f, d0 = 0.f, d1 = 0.f;  // this thread's part
  const uint32_t qa = vf::smem_u32(qs), ring_a = vf::smem_u32(ring);
  vf::mbar_wait(&bars[kRowsStages], 0);  // Q
  for (int j = 0; j < ntiles; ++j) {
    const int st = j % kRowsStages;
    vf::mbar_wait(&bars[st], (j / kRowsStages) & 1);
    const uint32_t ka = ring_a + 2 * st * kTile, va = ka + kTile;
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    fence_all(s);
    fence_all(dp);
    vf::wg_fence();
#pragma unroll
    for (int c = 0; c < 4; ++c)
      vf::wgmma_m64n64k16_ss<0, 0>(s, kmajor(qa, c), kmajor(ka, c), c > 0);
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      if (t >= terms) break;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        vf::wgmma_m64n64k16_rs_kmajor(dp, ga[t][kk], kmajor(va, kk), 1);
    }
    vf::wg_commit();
    vf::wg_wait<0>();
    fence_all(s);
    fence_all(dp);
    __syncthreads();  // every warp is done with stage st
    issue(j + kRowsStages);

    // online max; e = exp(s - m) summed into l, e dP into d
    const int k0 = j * kT;
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool valid = k0 + 8 * n + 2 * t4 + e < S;
        s[4 * n + e] = valid ? s[4 * n + e] * scale : -CUDART_INF_F;
        s[4 * n + 2 + e] = valid ? s[4 * n + 2 + e] * scale : -CUDART_INF_F;
        mx0 = fmaxf(mx0, s[4 * n + e]);
        mx1 = fmaxf(mx1, s[4 * n + 2 + e]);
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
    d0 *= al0;
    l1 *= al1;
    d1 *= al1;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float e0 = expf(s[4 * n + e] - mn0);
        const float e1 = expf(s[4 * n + 2 + e] - mn1);
        l0 += e0;
        d0 += e0 * dp[4 * n + e];
        l1 += e1;
        d1 += e1 * dp[4 * n + 2 + e];
      }
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    d0 += __shfl_xor_sync(0xffffffffu, d0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    d1 += __shfl_xor_sync(0xffffffffu, d1, off);
  }
  if (t4 == 0) {
    float* out = stats + (static_cast<size_t>(b) * ntiles + tile) * kStats;
    const int w0 = warp * 16 + gr, w1 = w0 + 8;
    const bool v0 = r0 < S, v1 = r1 < S;
    out[w0] = v0 ? m0 : 0.f;
    out[kT + w0] = v0 ? 1.f / l0 : 0.f;
    out[2 * kT + w0] = v0 ? d0 / l0 : 0.f;
    out[w1] = v1 ? m1 : 0.f;
    out[kT + w1] = v1 ? 1.f / l1 : 0.f;
    out[2 * kT + w1] = v1 ? d1 / l1 : 0.f;
  }
}

// ---------------------------------------------------------------------
// 2. per key tile: dK and dV over every query tile
// ---------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
    attn_bwd_kv(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                const __grid_constant__ CUtensorMap pmap,
                const float* __restrict__ stats,
                const int* __restrict__ marks,
                __nv_bfloat16* __restrict__ dk,
                __nv_bfloat16* __restrict__ dv, int S, float scale) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* kvs = smem_raw;           // K_j, V_j
  unsigned char* ring = kvs + 2 * kTile;   // Q, G hi, mid, lo, stats
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(ring + kKvStages * kKvStage);
  const int lane = threadIdx.x & 31, gr = lane >> 2, t4 = lane & 3;
  const int warp = threadIdx.x >> 5;
  const int tile = blockIdx.x, b = blockIdx.y;
  const int ntiles = gridDim.x, B = gridDim.y;
  const bool leader = threadIdx.x == 0;
  const CUtensorMap *qp = &qmap, *pp = &pmap;
  const int* mk = marks + b * ntiles;

  auto issue = [&](int i) {
    if (!leader || i >= ntiles) return;
    const int st = i % kKvStages;
    const int terms = mk[i] ? 3 : 1;
    unsigned char* dst = ring + st * kKvStage;
    vf::mbar_expect(&bars[st], (1 + terms) * kTile + kStatBytes);
    vf::tma_load_3d(dst, qp, &bars[st], 0, i * kT, b);
    for (int t = 0; t < terms; ++t)
      vf::tma_load_3d(dst + (1 + t) * kTile, pp, &bars[st], 0, i * kT,
                      t * B + b);
    vf::bulk_load(dst + 4 * kTile,
                  stats + (static_cast<size_t>(b) * ntiles + i) * kStats,
                  kStatBytes, &bars[st]);
  };
  if (leader) {
    for (int i = 0; i <= kKvStages; ++i) vf::mbar_init(&bars[i], 1);
    vf::mbar_fence_init();
  }
  __syncthreads();
  if (leader) {
    vf::mbar_expect(&bars[kKvStages], 2 * kTile);
    vf::tma_load_3d(kvs, &kmap, &bars[kKvStages], 0, tile * kT, b);
    vf::tma_load_3d(kvs + kTile, &vmap, &bars[kKvStages], 0, tile * kT, b);
  }
  for (int i = 0; i < kKvStages; ++i) issue(i);

  float dka[32], dva[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dka[i] = dva[i] = 0.f;
  const int kr0 = tile * kT + warp * 16 + gr;  // this thread's keys
  const bool kv0 = kr0 < S, kv1 = kr0 + 8 < S;
  const uint32_t ka = vf::smem_u32(kvs), va = ka + kTile;
  const uint32_t ring_a = vf::smem_u32(ring);
  vf::mbar_wait(&bars[kKvStages], 0);  // K_j, V_j
  for (int i = 0; i < ntiles; ++i) {
    const int st = i % kKvStages;
    const int terms = mk[i] ? 3 : 1;
    vf::mbar_wait(&bars[st], (i / kKvStages) & 1);
    const uint32_t qa = ring_a + st * kKvStage, ga = qa + kTile;
    const float* sm =
        reinterpret_cast<const float*>(ring + st * kKvStage + 4 * kTile);
    float s[32], dp[32];
#pragma unroll
    for (int x = 0; x < 32; ++x) s[x] = dp[x] = 0.f;
    fence_all(s);
    fence_all(dp);
    vf::wg_fence();
#pragma unroll
    for (int c = 0; c < 4; ++c)  // S^T = K Q^T
      vf::wgmma_m64n64k16_ss<0, 0>(s, kmajor(ka, c), kmajor(qa, c), c > 0);
#pragma unroll
    for (int t = 0; t < 3; ++t) {  // dP^T = V G^T
      if (t >= terms) break;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        vf::wgmma_m64n64k16_ss<0, 0>(dp, kmajor(va, c),
                                     kmajor(ga + t * kTile, c),
                                     t > 0 || c > 0);
    }
    vf::wg_commit();
    vf::wg_wait<0>();
    fence_all(s);
    fence_all(dp);

    // P^T and dS^T in place; the statistics are the columns' (queries')
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * n + 2 * t4 + e;
        const float mq = sm[col], il = sm[kT + col], dd = sm[2 * kT + col];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int x = 4 * n + 2 * h + e;
          const float p =
              (h ? kv1 : kv0) ? expf(s[x] * scale - mq) * il : 0.f;
          s[x] = p;
          dp[x] = p * (dp[x] - dd) * scale;
        }
      }
    uint32_t pa[3][4][4], sa[3][4][4];
    split_frags(s, pa);
    split_frags(dp, sa);
    fence_all(dva);
    fence_all(dka);
    vf::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t g0 = nmajor(ga, kk);
#pragma unroll
      for (int t = 0; t < 3; ++t) vf::wgmma_rs<64>(dva, pa[t][kk], g0);
      if (terms == 3) {
        const uint64_t g1 = nmajor(ga + kTile, kk);
        const uint64_t g2 = nmajor(ga + 2 * kTile, kk);
        vf::wgmma_rs<64>(dva, pa[0][kk], g1);
        vf::wgmma_rs<64>(dva, pa[1][kk], g1);
        vf::wgmma_rs<64>(dva, pa[0][kk], g2);
      }
      const uint64_t q0 = nmajor(qa, kk);
#pragma unroll
      for (int t = 0; t < 3; ++t) vf::wgmma_rs<64>(dka, sa[t][kk], q0);
    }
    vf::wg_commit();
    vf::wg_wait<0>();
    fence_all(dva);
    fence_all(dka);
    __syncthreads();  // every warp is done with stage st
    issue(i + kKvStages);
  }
  store_rows(dka, dk, b, S, kr0, t4);
  store_rows(dva, dv, b, S, kr0, t4);
}

// ---------------------------------------------------------------------
// 3. per query tile: dQ over every key tile
// ---------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
    attn_bwd_q(const __grid_constant__ CUtensorMap qmap,
               const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap,
               const __grid_constant__ CUtensorMap pmap,
               const float* __restrict__ stats,
               const int* __restrict__ marks,
               __nv_bfloat16* __restrict__ dq, int S, float scale) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* qs = smem_raw;            // Q, G hi, mid, lo
  unsigned char* ring = qs + 4 * kTile;    // stage st: K, V
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(ring + 2 * kQStages * kTile);
  const int lane = threadIdx.x & 31, gr = lane >> 2, t4 = lane & 3;
  const int warp = threadIdx.x >> 5;
  const int tile = blockIdx.x, b = blockIdx.y;
  const int ntiles = gridDim.x, B = gridDim.y;
  const bool leader = threadIdx.x == 0;
  const CUtensorMap *kp = &kmap, *vp = &vmap;
  const int terms = marks[b * ntiles + tile] ? 3 : 1;

  auto issue = [&](int j) {
    if (!leader || j >= ntiles) return;
    const int st = j % kQStages;
    unsigned char* dst = ring + 2 * st * kTile;
    vf::mbar_expect(&bars[st], 2 * kTile);
    vf::tma_load_3d(dst, kp, &bars[st], 0, j * kT, b);
    vf::tma_load_3d(dst + kTile, vp, &bars[st], 0, j * kT, b);
  };
  if (leader) {
    for (int i = 0; i <= kQStages; ++i) vf::mbar_init(&bars[i], 1);
    vf::mbar_fence_init();
  }
  __syncthreads();
  if (leader) {
    vf::mbar_expect(&bars[kQStages], (1 + terms) * kTile);
    vf::tma_load_3d(qs, &qmap, &bars[kQStages], 0, tile * kT, b);
    for (int t = 0; t < terms; ++t)
      vf::tma_load_3d(qs + (1 + t) * kTile, &pmap, &bars[kQStages], 0,
                      tile * kT, t * B + b);
  }
  for (int j = 0; j < kQStages; ++j) issue(j);

  const float* sb =
      stats + (static_cast<size_t>(b) * ntiles + tile) * kStats;
  const int w0 = warp * 16 + gr;  // this thread's rows: w0, w0 + 8
  const float mr0 = sb[w0], mr1 = sb[w0 + 8];
  const float il0 = sb[kT + w0], il1 = sb[kT + w0 + 8];
  const float dd0 = sb[2 * kT + w0], dd1 = sb[2 * kT + w0 + 8];
  float dqa[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dqa[i] = 0.f;
  const uint32_t qa = vf::smem_u32(qs), ga = qa + kTile;
  const uint32_t ring_a = vf::smem_u32(ring);
  vf::mbar_wait(&bars[kQStages], 0);  // Q and G
  for (int j = 0; j < ntiles; ++j) {
    const int st = j % kQStages;
    vf::mbar_wait(&bars[st], (j / kQStages) & 1);
    const uint32_t ka = ring_a + 2 * st * kTile, va = ka + kTile;
    float s[32], dp[32];
#pragma unroll
    for (int x = 0; x < 32; ++x) s[x] = dp[x] = 0.f;
    fence_all(s);
    fence_all(dp);
    vf::wg_fence();
#pragma unroll
    for (int c = 0; c < 4; ++c)  // S = Q K^T
      vf::wgmma_m64n64k16_ss<0, 0>(s, kmajor(qa, c), kmajor(ka, c), c > 0);
#pragma unroll
    for (int t = 0; t < 3; ++t) {  // dP = G V^T
      if (t >= terms) break;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        vf::wgmma_m64n64k16_ss<0, 0>(dp, kmajor(ga + t * kTile, c),
                                     kmajor(va, c), t > 0 || c > 0);
    }
    vf::wg_commit();
    vf::wg_wait<0>();
    fence_all(s);
    fence_all(dp);

    const int k0 = j * kT;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool valid = k0 + 8 * n + 2 * t4 + e < S;
        const int x0 = 4 * n + e, x1 = x0 + 2;
        const float p0 = valid ? expf(s[x0] * scale - mr0) * il0 : 0.f;
        const float p1 = valid ? expf(s[x1] * scale - mr1) * il1 : 0.f;
        dp[x0] = p0 * (dp[x0] - dd0) * scale;
        dp[x1] = p1 * (dp[x1] - dd1) * scale;
      }
    uint32_t sa[3][4][4];
    split_frags(dp, sa);
    fence_all(dqa);
    vf::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t kd = nmajor(ka, kk);
#pragma unroll
      for (int t = 0; t < 3; ++t) vf::wgmma_rs<64>(dqa, sa[t][kk], kd);
    }
    vf::wg_commit();
    vf::wg_wait<0>();
    fence_all(dqa);
    __syncthreads();  // every warp is done with stage st
    issue(j + kQStages);
  }
  store_rows(dqa, dq, b, S, tile * kT + w0, t4);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// q, k, v: bf16 (B, S, 64) views with strides (bstride, rstride, 1);
// g: f32 (B, S, 64) contiguous; dq, dk, dv: bf16 (B, S, 64) contiguous;
// scratch the wrapper allocates (ops/attention.py attention_backward_plan):
// planes bf16 (3, B, S, 64), stats f32 (B, tiles, 3, 64), marks int32
// (B, tiles).  Three launches on `stream`.
extern "C" int vf_attention_bwd(const void* q, const void* k, const void* v,
                                const float* g, void* dq, void* dk, void* dv,
                                void* planes, float* stats, int* marks,
                                int B, int S, int C, long long bstride,
                                long long rstride, float scale,
                                void* stream) {
  if (C != kC || B < 1 || S < 1 || B > 65535 || rstride % 8 != 0 ||
      bstride % 8 != 0 || !vf::aligned(q, 16) || !vf::aligned(k, 16) ||
      !vf::aligned(v, 16) || !vf::aligned(planes, 16) ||
      !vf::aligned(stats, 16) || !vf::aligned(g, 8))
    return cudaErrorInvalidValue;
  static bool configured = false;  // once, so launches can be captured
  if (!configured) {
    cudaError_t err = allow_smem(attn_bwd_rows, kRowsSmem);
    if (err == cudaSuccess) err = allow_smem(attn_bwd_kv, kKvSmem);
    if (err == cudaSuccess) err = allow_smem(attn_bwd_q, kQSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  CUtensorMap maps[4];
  const void* bases[3] = {q, k, v};
  for (int i = 0; i < 3; ++i)
    if (!vf::encode_rows(&maps[i], bases[i], B, S, kC, bstride, rstride))
      return cudaErrorInvalidValue;
  if (!vf::encode_rows(&maps[3], planes, 3 * B, S, kC,
                       static_cast<long long>(S) * kC, kC))
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid((S + kT - 1) / kT, B);
  attn_bwd_rows<<<grid, kThreads, kRowsSmem, st>>>(
      maps[0], maps[1], maps[2], g, static_cast<__nv_bfloat16*>(planes),
      stats, marks, S, scale);
  attn_bwd_kv<<<grid, kThreads, kKvSmem, st>>>(
      maps[0], maps[1], maps[2], maps[3], stats, marks,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), S,
      scale);
  attn_bwd_q<<<grid, kThreads, kQSmem, st>>>(
      maps[0], maps[1], maps[2], maps[3], stats, marks,
      static_cast<__nv_bfloat16*>(dq), S, scale);
  return cudaGetLastError();
}
