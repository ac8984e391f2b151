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
// 288 at Cin = Cout = 64, above the ~295 flop/byte ridge of the bf16
// tensor cores at every 2-D site except the ragged Cin = 6 / Cout = 6
// ones.  It is a GEMM with a long reduction (M = B*H*W pixels, up to
// 401,408) and a small output (9 * Cin * Cout).
//
// Design.  The TPU kernel turns the 9 taps into one (3 Cin, 3 Cout)
// product per sample with an accumulator carried across a sequential grid
// over B.  Blocks on the card run in parallel, so here:
//  * The pixels are cut into chunks of TR image rows x TW columns (about
//    128 pixels), and the chunks are split over `splits` blocks per output
//    tile, each summing its chunks in order into registers.  Each block
//    writes its (9, tile) partial to a (splits, 3, 3, Cin, Cout) workspace
//    and a second kernel sums the splits in a fixed order: no atomics, so
//    two calls give equal bits.  Where the output tiles alone fill the
//    card (the 8 px sites) there is one split and no second pass.
//  * The taps share their operands: a block stages one chunk of g and the
//    same chunk of x with a one-pixel halo in shared memory (zeros outside
//    the image: the SAME padding), and runs all 9 taps from it.  Tap
//    (di, dj) reads x at staged row r + di, column c + dj.
//  * bf16 (the training path): mma.sync m16n8k16 bf16 with f32
//    accumulation.  A product of two bf16 values is exact in f32, so this
//    is the f32 math of the TPU kernel up to summation order.  The staged
//    tiles are pixel-major (channels contiguous), and ldmatrix .trans turns
//    them into fragments whose pairs run along the pixel (reduction) axis.
//    Each warp owns 16 Cin x 16 Cout of the tile for all 9 taps (72 f32
//    accumulators a thread); per 16 pixels it loads the g fragment once
//    and one x fragment per tap.  Warps per block follow the channel
//    counts, so the Cin = 6 and Cout = 6 sites do not run 64-wide tiles.
//  * f32 inputs take a CUDA-core path (f32 FMAs) on the same staged tiles:
//    it is off the training path (bf16) and keeps f32 products exact.
//  * Staging is cp.async (16 bytes a copy, zero-filled at the padding)
//    into two buffers: the next chunk's copies are in flight while the
//    MMAs run on this one, so a thread does not wait out a global-load
//    latency per staged vector.
//  * Channel counts that are not a multiple of the 16-byte vector (Cin = 6)
//    are staged element by element, synchronously; image edges and chunk
//    edges are masks of the staging, never of the product.

#include "common.cuh"

namespace {

constexpr int kChunkPixels = 128;  // pixels staged per chunk (about)
constexpr int kMaxTileW = 64;      // chunk width in pixels (at most)

struct Geometry {
  int B, H, W, Cin, Cout;
  int TR, TW;          // chunk rows and columns (TW a multiple of 8)
  int n_rt, n_ct;      // chunks along H and W per image
  int n_chunks;        // B * n_rt * n_ct
  int per_split;       // chunks per block
};

Geometry make_geometry(int B, int H, int W, int Cin, int Cout) {
  Geometry g{};
  g.B = B, g.H = H, g.W = W, g.Cin = Cin, g.Cout = Cout;
  g.TW = ((W + 7) / 8) * 8;
  if (g.TW > kMaxTileW) g.TW = kMaxTileW;
  int tr = kChunkPixels / g.TW;
  if ((tr * g.TW) % 16) --tr;  // TW = 8 (mod 16) needs an even TR
  const int h2 = ((H + 1) / 2) * 2;
  if (tr > h2) tr = h2;        // even, so TR * TW stays a multiple of 16
  g.TR = tr < 1 ? 1 : tr;
  g.n_rt = (H + g.TR - 1) / g.TR;
  g.n_ct = (W + g.TW - 1) / g.TW;
  g.n_chunks = B * g.n_rt * g.n_ct;
  g.per_split = g.n_chunks;
  return g;
}

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
struct Shape {
  int wm, wn;  // bf16: warps along Cin and Cout
  int tiles;   // output tiles
  size_t smem;
};

Shape shape_of(const Geometry& geo, int dtype) {
  Shape s{};
  const size_t xpix = static_cast<size_t>(geo.TR + 2) * (geo.TW + 2);
  const size_t gpix = static_cast<size_t>(geo.TR) * geo.TW;
  if (dtype == vf::kBFloat16) {
    s.wm = geo.Cin <= 16 ? 1 : (geo.Cin <= 32 ? 2 : 4);
    s.wn = geo.Cout <= 16 ? 1 : 2;
    const int ci_t = 16 * s.wm, co_t = 16 * s.wn;
    s.tiles = ((geo.Cin + ci_t - 1) / ci_t) * ((geo.Cout + co_t - 1) / co_t);
    s.smem = 2 * (xpix * (ci_t + 8) + gpix * (co_t + 8)) * 2;  // 2 buffers
  } else {
    s.wm = s.wn = 0;
    s.tiles = ((geo.Cin + kF32Tile - 1) / kF32Tile) *
              ((geo.Cout + kF32Tile - 1) / kF32Tile);
    s.smem = 2 * (xpix + gpix) * (kF32Tile + 4) * 4;
  }
  return s;
}

// Splits of the pixel chunks: enough blocks for two per SM, at most one
// split per chunk; a last split that would be empty is dropped.
int split_count(const Geometry& geo, const Shape& s, int sm_count) {
  const int want = (2 * sm_count + s.tiles - 1) / s.tiles;
  int splits = want < 1 ? 1 : want;
  if (splits > geo.n_chunks) splits = geo.n_chunks;
  const int per = (geo.n_chunks + splits - 1) / splits;
  return (geo.n_chunks + per - 1) / per;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem, bool* configured) {
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
  cudaError_t err = allow_smem(wgrad_mma<WM, WN>, s.smem, &configured);
  if (err != cudaSuccess) return err;
  wgrad_mma<WM, WN><<<dim3(s.tiles, splits), 32 * WM * WN, s.smem, st>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(g), out, geo, vx, vg);
  return cudaGetLastError();
}

bool valid(int B, int H, int W, int Cin, int Cout) {
  return B >= 1 && H >= 1 && W >= 1 && Cin >= 1 && Cout >= 1;
}

}  // namespace

// The number of pixel splits (partials in the workspace) that
// vf_conv3x3_wgrad uses for this shape; the workspace holds
// splits * 9 * Cin * Cout floats when it is above 1.  Returns 0 for a
// shape it does not take.
extern "C" int vf_conv3x3_wgrad_splits(int B, int H, int W, int Cin,
                                       int Cout, int dtype, int sm_count) {
  if (!valid(B, H, W, Cin, Cout) || sm_count < 1) return 0;
  if (dtype != vf::kBFloat16 && dtype != vf::kFloat32) return 0;
  const Geometry geo = make_geometry(B, H, W, Cin, Cout);
  return split_count(geo, shape_of(geo, dtype), sm_count);
}

extern "C" int vf_conv3x3_wgrad(const void* x, const void* g, void* dw,
                                void* ws, int B, int H, int W, int Cin,
                                int Cout, int splits, int dtype,
                                void* stream) {
  if (!valid(B, H, W, Cin, Cout) || splits < 1) return cudaErrorInvalidValue;
  Geometry geo = make_geometry(B, H, W, Cin, Cout);
  if (splits > geo.n_chunks) return cudaErrorInvalidValue;
  geo.per_split = (geo.n_chunks + splits - 1) / splits;
  if ((geo.n_chunks + geo.per_split - 1) / geo.per_split != splits)
    return cudaErrorInvalidValue;  // a split would be empty
  if (splits > 1 && ws == nullptr) return cudaErrorInvalidValue;
  const Shape s = shape_of(geo, dtype);
  if (s.smem > 227 * 1024) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(splits > 1 ? ws : dw);
  int err = cudaSuccess;
  if (dtype == vf::kBFloat16) {
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
  } else if (dtype == vf::kFloat32) {
    static bool configured = false;
    err = allow_smem(wgrad_f32, s.smem, &configured);
    if (err != cudaSuccess) return err;
    wgrad_f32<<<dim3(s.tiles, splits), kF32Threads, s.smem, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(g), out,
        geo, Cin % 4 == 0 && vf::aligned(x, 16),
        Cout % 4 == 0 && vf::aligned(g, 16));
    err = cudaGetLastError();
  } else {
    return cudaErrorInvalidValue;
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
