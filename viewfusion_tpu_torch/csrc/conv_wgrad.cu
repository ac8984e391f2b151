// K4: weight gradient of a stride-1 SAME 3x3 conv for Hopper (sm_90a).
//
// Replaces viewfusion_tpu/ops/conv_wgrad.py `_wgrad_kernel` (reached
// through `conv3x3_wgrad`).
//
// Function, with x (B, H, W, Cin) the conv input and g (B, H, W, Cout) the
// output cotangent, both NHWC and of one dtype (bf16 or f32):
//   dW[di, dj, ci, co] = sum_{b,i,j} x[b, i+di-1, j+dj-1, ci] * g[b, i, j, co]
// with x zero outside the image; dW (3, 3, Cin, Cout) is f32 and the sums
// are f32 whatever the input dtype.
//
// Bound on the H100 at the UNet's shapes: operations.  Per pixel and
// channel pair the 9 taps do 18 flops against (Cin + Cout) * 2 bytes of
// bf16 input per pixel, i.e. ~9 * Cin * Cout / (Cin + Cout) flop/byte:
// 288 at Cin = Cout = 64, at the ~295 flop/byte ridge of the bf16 tensor
// cores, and above it at every wider 2-D site.  One training step at R =
// 98 rows (65 convs) is 1.86 TFLOP: 1.88 ms at 989 TFLOP/s.  It is a GEMM
// per tap with a long reduction (the pixels, up to 401,408) and a small
// output (9 * Cin * Cout).
//
// Work split (every path).  The TPU kernel carries an accumulator across
// a sequential grid over B; blocks on the card run in parallel, so the
// pixels are cut into chunks of TR image rows x TW columns, and the chunks
// are split over `splits` blocks per output tile, each summing its chunks
// in order.  With one split a block writes dW; otherwise it writes its
// (9, tile) partial to a (splits, 3, 3, Cin, Cout) workspace and a second
// kernel sums the splits in a fixed order: no atomics, so two calls give
// equal bits.  TR, TW and `splits` come from the wrapper
// (ops/conv_wgrad.py wgrad_plan); a block stages one chunk of g and the
// same chunk of x with a one-pixel halo (zeros outside the image: the
// SAME padding) and runs all 9 taps from it.
//
// wgrad_wgmma (bf16, Cin and Cout multiples of 8: 63 of the UNet's 65
// convs).  A block owns 64 Cin x 64 Cout and has three consumer
// warpgroups, one per tap row di, each holding its three taps (di, 0..2)
// as 3 x 64 x 64 f32 accumulators (96 registers a thread).  Per tap,
// dW_tap = X_tap^T G is wgmma m64n64k16 with K = 16 pixels:
//  * A = X_tap^T, M = 64 input channels, MN-major; B = G, N = 64 output
//    channels, N-major.  Both bf16 from shared memory, both transposed
//    operands (legal for 16-bit types).  bf16 products are exact in f32,
//    so this is the f32 math of the TPU kernel up to summation order.
//  * Layout: 128-byte swizzle.  A chunk's x halo tile and g tile are
//    pixel-major, one 128-byte row (64 channels) per pixel, their 16-byte
//    chunks permuted by pixel % 8, exactly as one TMA box with
//    SWIZZLE_128B writes them.  Descriptors (MN-major): SBO = 1 KB (next
//    8 pixels; for TW = 8 the 16 pixels of a k-slice span two image rows,
//    SBO = (TW + 2) * 128 in the halo tile).
//  * The tap shift is the descriptor's start address alone: tap (di, dj)
//    of the k-slice whose first pixel is (r, c) starts at halo pixel
//    ((r + di) * (TW + 2) + c + dj) * 128.  Any pixel row is a legal
//    start: the hardware swizzles by absolute address bits, as TMA does
//    (measured: a base offset of (addr >> 7) & 7 gives wrong results).
//    x is staged once per chunk, not per tap.
//  * TW is 8 or a multiple of 16, so a 16-pixel k-slice never crosses an
//    image row (TW = 8: exactly two rows).
//  * Staging: TMA.  Two tensor maps over x and g (dims C, W, H, B); per
//    chunk one thread issues one x box (64 channels x TW + 2 x TR + 2
//    pixels from (j0 - 1, i0 - 1): the halo; TMA fills what lies outside
//    the image with zeros, which is the SAME padding, with no masking
//    code) and one g box, 128 contiguous bytes per pixel (16-byte-wide
//    boxes, one per 8 channels, took 5.96 ms per training step against
//    4.97 on an H100 at 700 W, chip_smoke.py phase 12), completing on
//    the stage's mbarrier.  A ring of four stages: chunks i + 1 .. i + 3
//    fly while chunk i is multiplied.  A chunk is TR x TW ~ 128 pixels,
//    21-50 KB a stage (200 KB of shared memory at the 64 px sites).
//  * Splits: about one block per SM (sm_count / tiles blocks per tile):
//    (64, 64, 64, 64) at R = 98 is 1 tile x 131 splits; (8, 8, 320, 320)
//    25 tiles x 5 splits.
//
// wgrad_mma (bf16 with Cin or Cout not a multiple of 8: the two ragged
// Cin = 6 / Cout = 6 sites; TMA refuses their 12-byte pixel strides):
// element-wise staging into padded pixel-major tiles, ldmatrix .trans +
// mma.sync m16n8k16; each warp owns 16 Cin x 16 Cout for all 9 taps (72
// f32 accumulators a thread).
//
// wgrad_f32 (f32 inputs): a CUDA-core path (f32 FMAs) on the same staged
// tiles: it is off the training path (bf16) and keeps f32 products exact.
// The mma and f32 paths stage by cp.async into two buffers where every
// pixel row of the source is 16-byte aligned, element by element
// otherwise.

#include "common.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

struct Geometry {
  int B, H, W, Cin, Cout;
  int TR, TW;          // chunk rows and columns
  int n_rt, n_ct;      // chunks along H and W per image
  int n_chunks;        // B * n_rt * n_ct
  int per_split;       // chunks per block
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 16 : 0));  // 0 bytes read: zero fill
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage one chunk: x rows i0-1 .. i0+TR, columns j0-1 .. j0+TW (zero
// outside the image) for channels [c0, c0 + CT), and g rows i0 .. i0+TR-1,
// columns j0 .. j0+TW-1 (zero outside) for its channels.  Tiles are
// pixel-major with row strides ldx / ldg elements (multiples of the
// vector width).  With `vec` (every pixel row of the source 16-byte
// aligned: channels a multiple of the vector, aligned base) the copies
// are cp.async, in flight until the caller waits; otherwise element
// loads and stores.
template <typename T, int CT>
__device__ __forceinline__ void stage(const T* __restrict__ src, T* tile,
                                      int ld, int C, int c0, int b, int i0,
                                      int j0, int rows, int cols, int halo,
                                      const Geometry& geo, bool vec) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int NV = CT / VEC;  // vectors per staged pixel
  const int n = rows * cols * NV;
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    const int pix = idx / NV, cv = idx - pix * NV;
    const int r = pix / cols, c = pix - r * cols;
    const int i = i0 + r - halo, j = j0 + c - halo;
    const int ch = c0 + cv * VEC;
    const bool in = i >= 0 && i < geo.H && j >= 0 && j < geo.W && ch < C;
    const T* p = src;
    if (in)
      p += ((static_cast<size_t>(b) * geo.H + i) * geo.W + j) * C + ch;
    T* dst = tile + pix * ld + cv * VEC;
    if (vec) {
      cp_async16(dst, p, in);
      continue;
    }
    vf::Vec<T, VEC> val;
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      val.v[e] = (in && ch + e < C) ? p[e] : vf::from_f<T>(0.f);
    *reinterpret_cast<vf::Vec<T, VEC>*>(dst) = val;
  }
}

__device__ __forceinline__ void chunk_origin(const Geometry& geo, int chunk,
                                             int* b, int* i0, int* j0) {
  const int per_image = geo.n_rt * geo.n_ct;
  *b = chunk / per_image;
  const int rem = chunk - *b * per_image;
  const int rt = rem / geo.n_ct;
  *i0 = rt * geo.TR;
  *j0 = (rem - rt * geo.n_ct) * geo.TW;
}

// Write a block's (9, tile) result: to dW when there is one split, else to
// its split's slice of the workspace.
__device__ __forceinline__ void store_partial(float* out, const Geometry& geo,
                                              int tap, int ci, int co,
                                              float v) {
  if (ci < geo.Cin && co < geo.Cout)
    out[(static_cast<size_t>(tap) * geo.Cin + ci) * geo.Cout + co] = v;
}

// ---------------------------------------------------------------------
// bf16: wgmma (channels multiples of 8), TMA staging
// ---------------------------------------------------------------------
constexpr int kWgTile = 64;   // Cin and Cout per block: wgmma M and N
constexpr int kWgGroups = 3;  // consumer warpgroups, one per tap row
constexpr int kWgThreads = 128 * kWgGroups;
constexpr int kWgStages = 4;

// Bytes of a tile of `pixels` pixels of 64 channels (128-byte rows): a
// whole number of 1 KB swizzle atoms, where TMA's swizzled boxes start.
__host__ __device__ __forceinline__ uint32_t region_bytes(int pixels) {
  return static_cast<uint32_t>((pixels + 7) / 8 * 1024);
}

// Shared memory of one chunk stage: x with its halo and g.
size_t wg_stage_bytes(int TR, int TW) {
  return static_cast<size_t>(region_bytes((TR + 2) * (TW + 2))) +
         region_bytes(TR * TW);
}

// A descriptor of a 128-byte swizzled MN-major operand of 64 channels
// whose K (pixel) groups are `sbo` bytes apart.  Its start may be any
// pixel row of an atom: the swizzle follows the absolute address bits,
// as TMA's does, so no base offset is needed.
__device__ __forceinline__ uint64_t desc_px(uint32_t addr, uint32_t sbo) {
  return vf::wg_desc_sw128(addr, kWgTile * 128, sbo);
}

__global__ void __launch_bounds__(kWgThreads, 1)
    wgrad_wgmma(const __grid_constant__ CUtensorMap xmap,
                const __grid_constant__ CUtensorMap gmap,
                float* __restrict__ out, Geometry geo) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int TW = geo.TW, XW = TW + 2;
  const int XP = (geo.TR + 2) * XW, GP = geo.TR * TW;  // pixels staged
  const uint32_t xbytes = region_bytes(XP);
  const uint32_t stage_bytes = xbytes + region_bytes(GP);
  unsigned char* stages = smem_raw;
  const uint32_t stages_a = vf::smem_u32(stages);
  // the stages' mbarriers after the stages
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(stages + kWgStages * stage_bytes);

  const int tile = blockIdx.x, split = blockIdx.y;
  const int n_co = (geo.Cout + kWgTile - 1) / kWgTile;
  const int ci0 = (tile / n_co) * kWgTile, co0 = (tile % n_co) * kWgTile;
  const int tid = threadIdx.x, di = tid >> 7;  // warpgroup = tap row
  const int c_begin = split * geo.per_split;
  const int n = min(geo.n_chunks, c_begin + geo.per_split) - c_begin;
  const bool leader = tid == 0;
  const CUtensorMap *xp = &xmap, *gp = &gmap;

  // chunk c_begin + i into stage i % kWgStages, issued by one thread: one
  // x box (64 channels x TW + 2 columns x TR + 2 rows from (j0 - 1,
  // i0 - 1): the halo, zeros outside the image) and one g box
  auto load = [&](int i) {
    if (!leader || i >= n) return;
    int b, i0, j0;
    chunk_origin(geo, c_begin + i, &b, &i0, &j0);
    const int st = i % kWgStages;
    unsigned char* xs = stages + st * stage_bytes;
    vf::mbar_expect(&bars[st], 128 * (XP + GP));
    vf::tma_load_4d(xs, xp, &bars[st], ci0, j0 - 1, i0 - 1, b);
    vf::tma_load_4d(xs + xbytes, gp, &bars[st], co0, j0, i0, b);
  };
  if (leader) {
    for (int i = 0; i < kWgStages; ++i) vf::mbar_init(&bars[i], 1);
    vf::mbar_fence_init();
  }
  __syncthreads();
  for (int i = 0; i < kWgStages; ++i) load(i);

  float acc[3][32];  // taps (di, 0..2), 64 x 64 each
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[t][e] = 0.f;

  // x: the two 8-pixel halves of a k-slice, one row of the halo tile
  // apart when TW = 8, else adjacent
  const uint32_t sbo_x = TW == 8 ? XW * 128 : 1024;
  const int slices = GP / 16;
  for (int i = 0; i < n; ++i) {
    const int st = i % kWgStages;
    vf::mbar_wait(&bars[st], (i / kWgStages) & 1);
    const uint32_t xs = stages_a + st * stage_bytes;
    const uint32_t gs = xs + xbytes;
#pragma unroll
    for (int t = 0; t < 3; ++t)
#pragma unroll
      for (int e = 0; e < 32; ++e) vf::fence_reg(acc[t][e]);
    vf::wg_fence();
    for (int s = 0; s < slices; ++s) {
      int r, c0;  // the slice's first pixel in the chunk
      if (TW == 8) {
        r = 2 * s;
        c0 = 0;
      } else {
        r = (16 * s) / TW;
        c0 = 16 * s - r * TW;
      }
      const uint64_t bd = desc_px(gs + s * 2048, 1024);
      const uint32_t xa = xs + ((r + di) * XW + c0) * 128;
#pragma unroll
      for (int dj = 0; dj < 3; ++dj)
        vf::wgmma_m64n64k16_ss<1, 1>(acc[dj], desc_px(xa + dj * 128, sbo_x),
                                     bd, 1);
    }
    vf::wg_commit();
    vf::wg_wait<0>();
#pragma unroll
    for (int t = 0; t < 3; ++t)
#pragma unroll
      for (int e = 0; e < 32; ++e) vf::fence_reg(acc[t][e]);
    __syncthreads();  // every warpgroup is done with this stage
    load(i + kWgStages);
  }

  // accumulator (row = ci, column = co): warp w of the group holds rows
  // 16w + lane / 4 (+ 8), columns 8i + 2 (lane % 4) (+ 1)
  float* dst = out + static_cast<size_t>(split) * 9 * geo.Cin * geo.Cout;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int gr = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int dj = 0; dj < 3; ++dj)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ci = ci0 + warp * 16 + gr + 8 * h;
        const int co = co0 + 8 * i + 2 * t4;
        if (ci < geo.Cin && co < geo.Cout)
          *reinterpret_cast<float2*>(
              dst + (static_cast<size_t>(di * 3 + dj) * geo.Cin + ci) *
                        geo.Cout + co) =
              make_float2(acc[dj][4 * i + 2 * h], acc[dj][4 * i + 2 * h + 1]);
      }
}

// NHWC (B, H, W, C) bf16 map with boxes of 64 channels x bw x bh pixels,
// 128-byte swizzled.
bool encode_nhwc(CUtensorMap* map, const void* base, const Geometry& geo,
                 int C, int bw, int bh) {
  const uint64_t dims[4] = {static_cast<uint64_t>(C),
                            static_cast<uint64_t>(geo.W),
                            static_cast<uint64_t>(geo.H),
                            static_cast<uint64_t>(geo.B)};
  const uint64_t px = static_cast<uint64_t>(C) * 2;
  const uint64_t strides[3] = {px, px * geo.W, px * geo.W * geo.H};
  const uint32_t box[4] = {kWgTile, static_cast<uint32_t>(bw),
                           static_cast<uint32_t>(bh), 1};
  return vf::encode_bf16(map, base, 4, dims, strides, box,
                         CU_TENSOR_MAP_SWIZZLE_128B);
}

// ---------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* smem) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// WM x WN warps, each 16 Cin x 16 Cout for all 9 taps.
template <int WM, int WN>
__global__ void __launch_bounds__(32 * WM * WN)
    wgrad_mma(const __nv_bfloat16* __restrict__ x,
              const __nv_bfloat16* __restrict__ g, float* __restrict__ out,
              Geometry geo, bool vec_x, bool vec_g) {
  constexpr int CI_T = 16 * WM, CO_T = 16 * WN;
  constexpr int LDX = CI_T + 8, LDG = CO_T + 8;  // conflict-free ldmatrix
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int XW = geo.TW + 2;
  const int x_elems = (geo.TR + 2) * XW * LDX;
  const int buf_elems = x_elems + geo.TR * geo.TW * LDG;  // one buffer
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int tile = blockIdx.x, split = blockIdx.y;
  const int n_co = (geo.Cout + CO_T - 1) / CO_T;
  const int ci0 = (tile / n_co) * CI_T, co0 = (tile % n_co) * CO_T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % WM, wn = warp / WM;
  const int q = lane >> 3, l8 = lane & 7;

  float acc[9][2][4];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int n = 0; n < 2; ++n)
      acc[t][n][0] = acc[t][n][1] = acc[t][n][2] = acc[t][n][3] = 0.f;

  // lane offsets of the ldmatrix row addresses (matrix q, row l8):
  // x (A): channel half (q & 1), pixel half (q >> 1);
  // g (B): pixel half (q & 1), channel half (q >> 1).
  const int a_ch = wm * 16 + (q & 1) * 8, a_k = (q >> 1) * 8 + l8;
  const int b_ch = wn * 16 + (q >> 1) * 8, b_k = (q & 1) * 8 + l8;
  const int kpix = geo.TR * geo.TW;

  const int c_begin = split * geo.per_split;
  const int c_end = min(geo.n_chunks, c_begin + geo.per_split);
  auto load = [&](int chunk, int buf) {
    int b, i0, j0;
    chunk_origin(geo, chunk, &b, &i0, &j0);
    __nv_bfloat16* xs = smem + buf * buf_elems;
    stage<__nv_bfloat16, CI_T>(x, xs, LDX, geo.Cin, ci0, b, i0, j0,
                               geo.TR + 2, XW, 1, geo, vec_x);
    stage<__nv_bfloat16, CO_T>(g, xs + x_elems, LDG, geo.Cout, co0, b, i0,
                               j0, geo.TR, geo.TW, 0, geo, vec_g);
    cp_async_commit();
  };
  if (c_begin < c_end) load(c_begin, 0);
  for (int chunk = c_begin, buf = 0; chunk < c_end; ++chunk, buf ^= 1) {
    // the next chunk's copies fly while this one is computed
    if (chunk + 1 < c_end) {
      load(chunk + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this chunk's tiles are visible to every warp
    const __nv_bfloat16* xs = smem + buf * buf_elems;
    const __nv_bfloat16* gs = xs + x_elems;
    for (int k0 = 0; k0 < kpix; k0 += 16) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, gs + (k0 + b_k) * LDG + b_ch);
      const int k = k0 + a_k;
      const int r = k / geo.TW, c = k - r * geo.TW;
      const __nv_bfloat16* xa = xs + (r * XW + c) * LDX + a_ch;
#pragma unroll
      for (int di = 0; di < 3; ++di) {
#pragma unroll
        for (int dj = 0; dj < 3; ++dj) {
          uint32_t af[4];
          ldmatrix_x4_trans(af, xa + (di * XW + dj) * LDX);
          mma_bf16(acc[di * 3 + dj][0], af, bf[0], bf[1]);
          mma_bf16(acc[di * 3 + dj][1], af, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();  // this buffer is consumed before it is refilled
  }

  float* dst = out + static_cast<size_t>(split) * 9 * geo.Cin * geo.Cout;
  const int gr = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int ci = ci0 + wm * 16 + gr;
      const int co = co0 + wn * 16 + n * 8 + t4 * 2;
      store_partial(dst, geo, t, ci, co, acc[t][n][0]);
      store_partial(dst, geo, t, ci, co + 1, acc[t][n][1]);
      store_partial(dst, geo, t, ci + 8, co, acc[t][n][2]);
      store_partial(dst, geo, t, ci + 8, co + 1, acc[t][n][3]);
    }
}

// ---------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------
constexpr int kF32Tile = 32;  // Cin and Cout per block
constexpr int kF32Threads = 256;

__global__ void __launch_bounds__(kF32Threads)
    wgrad_f32(const float* __restrict__ x, const float* __restrict__ g,
              float* __restrict__ out, Geometry geo, bool vec_x,
              bool vec_g) {
  constexpr int LD = kF32Tile + 4;  // keeps 16-byte vector stores aligned
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int XW = geo.TW + 2;
  const int x_elems = (geo.TR + 2) * XW * LD;
  const int buf_elems = x_elems + geo.TR * geo.TW * LD;  // one buffer
  float* smem = reinterpret_cast<float*>(smem_raw);

  const int tile = blockIdx.x, split = blockIdx.y;
  const int n_co = (geo.Cout + kF32Tile - 1) / kF32Tile;
  const int ci0 = (tile / n_co) * kF32Tile, co0 = (tile % n_co) * kF32Tile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;  // co, ci

  float acc[9][2][2];
#pragma unroll
  for (int t = 0; t < 9; ++t)
    acc[t][0][0] = acc[t][0][1] = acc[t][1][0] = acc[t][1][1] = 0.f;

  const int kpix = geo.TR * geo.TW;
  const int c_begin = split * geo.per_split;
  const int c_end = min(geo.n_chunks, c_begin + geo.per_split);
  auto load = [&](int chunk, int buf) {
    int b, i0, j0;
    chunk_origin(geo, chunk, &b, &i0, &j0);
    float* xs = smem + buf * buf_elems;
    stage<float, kF32Tile>(x, xs, LD, geo.Cin, ci0, b, i0, j0, geo.TR + 2,
                           XW, 1, geo, vec_x);
    stage<float, kF32Tile>(g, xs + x_elems, LD, geo.Cout, co0, b, i0, j0,
                           geo.TR, geo.TW, 0, geo, vec_g);
    cp_async_commit();
  };
  if (c_begin < c_end) load(c_begin, 0);
  for (int chunk = c_begin, buf = 0; chunk < c_end; ++chunk, buf ^= 1) {
    if (chunk + 1 < c_end) {
      load(chunk + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* xs = smem + buf * buf_elems;
    const float* gs = xs + x_elems;
    for (int k = 0; k < kpix; ++k) {
      const int r = k / geo.TW, c = k - r * geo.TW;
      const float g0 = gs[k * LD + tx], g1 = gs[k * LD + tx + 16];
      const float* xa = xs + (r * XW + c) * LD + ty;
#pragma unroll
      for (int di = 0; di < 3; ++di)
#pragma unroll
        for (int dj = 0; dj < 3; ++dj) {
          const float* xp = xa + (di * XW + dj) * LD;
          const float x0 = xp[0], x1 = xp[16];
          float(&a)[2][2] = acc[di * 3 + dj];
          a[0][0] = fmaf(x0, g0, a[0][0]);
          a[0][1] = fmaf(x0, g1, a[0][1]);
          a[1][0] = fmaf(x1, g0, a[1][0]);
          a[1][1] = fmaf(x1, g1, a[1][1]);
        }
    }
    __syncthreads();
  }

  float* dst = out + static_cast<size_t>(split) * 9 * geo.Cin * geo.Cout;
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int v = 0; v < 2; ++v)
        store_partial(dst, geo, t, ci0 + ty + 16 * u, co0 + tx + 16 * v,
                      acc[t][u][v]);
}

// dW = the sum of the splits' partials, in split order.
__global__ void wgrad_reduce(const float* __restrict__ ws,
                             float* __restrict__ dw, int splits, size_t n) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int j = 0; j < splits; ++j) s += ws[j * n + i];
    dw[i] = s;
  }
}

// ---------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------
enum class Path { kWgmma, kMma, kF32 };

int cdiv(int a, int b) { return (a + b - 1) / b; }

struct Shape {
  Path path;
  int wm, wn;  // mma: warps along Cin and Cout
  int tiles;   // output tiles
  size_t smem;
};

// The path and block shape for a dtype and channel counts (ops/conv_wgrad.py
// wgrad_plan makes the same choice and counts the same tiles).
Shape shape_of(const Geometry& geo, int dtype) {
  Shape s{};
  const size_t xpix = static_cast<size_t>(geo.TR + 2) * (geo.TW + 2);
  const size_t gpix = static_cast<size_t>(geo.TR) * geo.TW;
  if (dtype == vf::kBFloat16 && geo.Cin % 8 == 0 && geo.Cout % 8 == 0) {
    s.path = Path::kWgmma;
    s.tiles = cdiv(geo.Cin, kWgTile) * cdiv(geo.Cout, kWgTile);
    s.smem = kWgStages * wg_stage_bytes(geo.TR, geo.TW) + vf::kBarBytes;
  } else if (dtype == vf::kBFloat16) {
    s.path = Path::kMma;
    s.wm = geo.Cin <= 16 ? 1 : (geo.Cin <= 32 ? 2 : 4);
    s.wn = geo.Cout <= 16 ? 1 : 2;
    const int ci_t = 16 * s.wm, co_t = 16 * s.wn;
    s.tiles = cdiv(geo.Cin, ci_t) * cdiv(geo.Cout, co_t);
    s.smem = 2 * (xpix * (ci_t + 8) + gpix * (co_t + 8)) * 2;  // 2 buffers
  } else {
    s.path = Path::kF32;
    s.tiles = cdiv(geo.Cin, kF32Tile) * cdiv(geo.Cout, kF32Tile);
    s.smem = 2 * (xpix + gpix) * (kF32Tile + 4) * 4;
  }
  return s;
}

// Chunk shapes each path takes: the mma path's 16-pixel steps need
// TR * TW a multiple of 16 with TW a multiple of 8; the wgmma path's
// k-slices need TW = 8 with TR even, or TW a multiple of 16.
bool chunk_fits(const Geometry& geo, Path path) {
  if (geo.TR < 1 || geo.TW < 8 || geo.TW % 8) return false;
  if (path == Path::kWgmma)
    return geo.TW == 8 ? geo.TR % 2 == 0 : geo.TW % 16 == 0;
  if (path == Path::kMma) return (geo.TR * geo.TW) % 16 == 0;
  return true;
}

template <typename K>
cudaError_t allow_smem(K kernel, bool* configured) {
  // once per instantiation (not per launch, so that launches can be
  // captured into a CUDA graph)
  if (*configured) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
  if (err == cudaSuccess) *configured = true;
  return err;
}

template <int WM, int WN>
int launch_mma(const void* x, const void* g, float* out, const Geometry& geo,
               const Shape& s, int splits, bool vx, bool vg,
               cudaStream_t st) {
  static bool configured = false;
  cudaError_t err = allow_smem(wgrad_mma<WM, WN>, &configured);
  if (err != cudaSuccess) return err;
  wgrad_mma<WM, WN><<<dim3(s.tiles, splits), 32 * WM * WN, s.smem, st>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(g), out, geo, vx, vg);
  return cudaGetLastError();
}

}  // namespace

// dW of x (B, H, W, Cin) and g (B, H, W, Cout) into dw (3, 3, Cin, Cout)
// f32, with chunks of TR x TW pixels split over `splits` blocks per output
// tile (ops/conv_wgrad.py wgrad_plan); ws holds splits * 9 * Cin * Cout
// floats when splits > 1.
extern "C" int vf_conv3x3_wgrad(const void* x, const void* g, void* dw,
                                void* ws, int B, int H, int W, int Cin,
                                int Cout, int TR, int TW, int splits,
                                int dtype, void* stream) {
  if (B < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1 || splits < 1)
    return cudaErrorInvalidValue;
  if (dtype != vf::kBFloat16 && dtype != vf::kFloat32)
    return cudaErrorInvalidValue;
  Geometry geo{B, H, W, Cin, Cout, TR, TW, 0, 0, 0, 0};
  const Shape s = shape_of(geo, dtype);
  if (!chunk_fits(geo, s.path) || s.smem > 227 * 1024)
    return cudaErrorInvalidValue;
  geo.n_rt = cdiv(H, TR);
  geo.n_ct = cdiv(W, TW);
  geo.n_chunks = B * geo.n_rt * geo.n_ct;
  if (splits > geo.n_chunks) return cudaErrorInvalidValue;
  geo.per_split = cdiv(geo.n_chunks, splits);
  if (cdiv(geo.n_chunks, geo.per_split) != splits)
    return cudaErrorInvalidValue;  // a split would be empty
  if (splits > 1 && ws == nullptr) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(splits > 1 ? ws : dw);
  int err = cudaSuccess;
  if (s.path == Path::kWgmma) {
    CUtensorMap xmap, gmap;
    if (!vf::aligned(x, 16) || !vf::aligned(g, 16) ||
        !encode_nhwc(&xmap, x, geo, Cin, TW + 2, TR + 2) ||
        !encode_nhwc(&gmap, g, geo, Cout, TW, TR))
      return cudaErrorInvalidValue;
    static bool configured = false;
    err = allow_smem(wgrad_wgmma, &configured);
    if (err != cudaSuccess) return err;
    wgrad_wgmma<<<dim3(s.tiles, splits), kWgThreads, s.smem, st>>>(
        xmap, gmap, out, geo);
    err = cudaGetLastError();
  } else if (s.path == Path::kMma) {
    const bool vx = Cin % 8 == 0 && vf::aligned(x, 16);
    const bool vg = Cout % 8 == 0 && vf::aligned(g, 16);
#define VF_WGRAD_CASE(M, N)                                                 \
  if (s.wm == M && s.wn == N)                                               \
    err = launch_mma<M, N>(x, g, out, geo, s, splits, vx, vg, st);
    VF_WGRAD_CASE(1, 1)
    VF_WGRAD_CASE(1, 2)
    VF_WGRAD_CASE(2, 1)
    VF_WGRAD_CASE(2, 2)
    VF_WGRAD_CASE(4, 1)
    VF_WGRAD_CASE(4, 2)
#undef VF_WGRAD_CASE
  } else {
    static bool configured = false;
    err = allow_smem(wgrad_f32, &configured);
    if (err != cudaSuccess) return err;
    wgrad_f32<<<dim3(s.tiles, splits), kF32Threads, s.smem, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(g), out,
        geo, Cin % 4 == 0 && vf::aligned(x, 16),
        Cout % 4 == 0 && vf::aligned(g, 16));
    err = cudaGetLastError();
  }
  if (err != cudaSuccess || splits == 1) return err;
  const size_t n = static_cast<size_t>(9) * Cin * Cout;
  const int threads = 256;
  const size_t want = (n + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  wgrad_reduce<<<blocks, threads, 0, st>>>(static_cast<const float*>(ws),
                                           static_cast<float*>(dw), splits, n);
  return cudaGetLastError();
}
