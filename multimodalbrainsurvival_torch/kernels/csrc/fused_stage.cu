// One folded-BN bottleneck block (K4), for Hopper (sm_90a): the three
// products, the biases, the ReLUs and the residual add in one launch, with
// the intermediates y1 and y2 kept in shared memory.
//
// Replaces the TPU kernel `fused_bottleneck_stage` / `_stage_kernel`
// (multimodalbrainsurvival_tpu/ops/pallas/fused_stage.py, retired in commit
// 183b10c; pallas_call at :150, the block at `_block_step` :40), which ran
// a chain of stride-1 folded bottleneck blocks on one whole image per
// program. A stride-1 block on an NHWC input x (H, W, Cin) of type T
// (bfloat16 or float32) computes, with float32 sums and float32 biases:
//
//     y1  = T(relu(x . w1^T + b1))                    1x1, Cin -> Cm
//     y2  = T(relu(im2col3x3(y1) . w2^T + b2))        3x3, pad 1, Cm -> Cm
//     z   = T(y2 . w3^T + b3)                         1x1, Cm -> Cout
//     r   = T(x . wd^T + bd)  (projection)  or  x     1x1, Cin -> Cout
//     out = T(relu(z + r))
//
// The 3x3 zero padding applies to y1: a halo pixel outside the image is 0,
// not relu(b1). Weights are (N, K) with K contiguous ("packed" by
// kernels/fused_stage.py::pack_bottleneck): w2's K is in (dy, dx, c) order,
// as the TPU kernel's (3, 3, Cm, Cm) -> (9 Cm, Cm) reshape gives.
//
// What the TPU design cannot do here. The TPU kernel kept a whole image in
// VMEM: 56 x 56 x 256 bf16 is 1.6 MB, 7x the 227 KB of shared memory a
// block may use. So a block of this kernel owns a TH x TW tile of output
// pixels of one image and computes y1 over the tile plus a one-pixel halo
// ((TH + 2) x (TW + 2) pixels; the halo's 1x1 product is recomputed by the
// neighbouring tiles), then y2 over the tile, both in shared memory, then
// the last product and the residual in column passes of NB channels (a
// projection's rounded output goes to shared memory first; an identity
// residual is read from x in the epilogue). Tile edges need not divide H
// or W.
//
// bfloat16: wgmma fed by a TMA ring (the served path). A persistent block
// (one per SM) walks its tiles; each tile is a fixed sequence of k-chunks of
// 64 channels (128 bytes): the 1x1 product into y1 over the halo (A: the x
// halo, one 4-d TMA box whose pixels outside the image read as zero), the
// 3x3 product (K = 9 Cm), then in passes of NB = 128 output channels the
// projection (A: the x tile) and the last product. Every chunk's weight
// tile, and the x boxes, come by TMA with the 128-byte swizzle into a ring
// of 2-4 stages (as many as fit). The block is warp-specialised: a producer
// warpgroup (one thread issues the loads; setmaxnreg gives its registers to
// the others) fills the ring across tile boundaries, each stage behind a
// `full` and an `empty` mbarrier, and two consumer warpgroups issue wgmma
// m64n64k16, keep one group in flight while they wait for the next stage,
// and free a stage as soon as the group that read it has completed; a named
// barrier over the consumers orders only the y1 / y2 / residual handoffs
// (3 per tile, 2 more per projection pass). The products of x take A from
// shared memory by descriptor; the 3x3 product
// reads shifted views of the y1 halo, which are no strided matrix, so its A
// comes from registers (ldmatrix of the y1 rows a tap needs, the layout of
// mma.sync's A fragment, which wgmma's register A shares), and so does the
// last product's (y2). Tile and halo rows are padded to 64; the host picks
// the tile whose warpgroups do the least work, padding included, and that
// fits in shared memory with 2-4 stages (8 x 14 for layer1's 56 x 56: 112
// -> 128 rows, its 10 x 16 halo 160 -> 192; 4 x 28 for layer2's 28 x 28:
// 112 -> 128, its 6 x 30 halo 180 -> 192). Variants (ring depth, no wgmma in
// flight, a consumer barrier on every chunk as the first design had, no
// products) are timed on the card by tools/kernel_variants.py.
//
// float32: plain FMA (no TF32, so the card's float32 path can be held to
// the CPU's) in mma.sync's fragment ownership, the weights streamed in K
// chunks of 32 through a two-stage cp.async buffer; the tile and the
// halo's 1x1 product as above, in 16-row granularity, one block per SM.
//
// Bound on the card, one block of 256 images (224-px patches). layer1
// block 1: 802,816 pixels x (256.64 + 9.64.64 + 64.256) multiply-adds =
// 112 GFLOP, 0.113 ms at 989 TFLOP/s bf16, against 822 MB in and out, 0.245
// ms at 3.35 TB/s: bound by memory. The whole stage (3 blocks, 342 GFLOP,
// 514 MB in and out once) is bound by operations (0.346 ms), but this
// kernel launches once per block, so the residual stream between blocks
// goes through device memory: 2.16 GB for layer1 (0.64 ms) and 1.23 GB for
// layer2's tail (0.37 ms) instead of 514 MB and 411 MB. A stage-resident
// design (halo recompute across blocks) would save that traffic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int KC = 32;                     // K elements per staged chunk
constexpr int MAXI = 4;                    // 16 x 32 output items per warp
constexpr int MAX_ITEMS = MAXI * WARPS;
constexpr int MAX_P = 128;                 // output pixels per tile
constexpr int SMEM_MAX = 232448;           // a block's shared memory cap

// float32 path (below, up to `wgmma path`): one block per SM; its FMA loop
// spills badly at two (46 against 75 ms for layer1). Row padding (elements)
// of every shared-memory matrix: the 8 rows a warp's fragment loads touch
// then start in 8 different 4-bank groups.
constexpr int F32_PAD = 4;

struct Layout {
  int TH, TW, tiles_h, tiles_w;
  int P, PP, PH, PHP;    // tile and halo pixels, and both rounded up to 16
  int NB, brows;         // columns per pass of the last product; B rows staged
  int ldy, ldr, ldk;     // row strides (elements) of y1/y2, r, staged chunks
  int off_y2, off_a, off_b;  // offsets (elements) in shared memory
  int bytes;
  long long cost;        // padded multiply-adds of the whole image
};

struct Args {
  const void* x;
  void* out;
  const void* w1;
  const float* b1;
  const void* w2;
  const float* b2;
  const void* w3;
  const float* b3;
  const void* wd;  // nullptr: identity residual
  const float* bd;
  int H, W, Cin, Cm, Cout;
  Layout L;
};

using hopper::cp_async16;
using hopper::cp_async_commit;

__device__ __forceinline__ void cp_async_wait_one() {
  hopper::cp_async_wait<1>();
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 round_to<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T> struct Pair;
template <> struct Pair<float> { typedef float2 type; };
template <> struct Pair<bf16> { typedef __nv_bfloat162 type; };

// two adjacent elements, rounded to T
template <typename T>
__device__ __forceinline__ void store_pair(T* p, float a, float b) {
  typename Pair<T>::type v;
  v.x = round_to<T>(a);
  v.y = round_to<T>(b);
  *reinterpret_cast<typename Pair<T>::type*>(p) = v;
}

template <typename T>
__device__ __forceinline__ float2 load_pair(const T* p) {
  const typename Pair<T>::type v =
      *reinterpret_cast<const typename Pair<T>::type*>(p);
  return make_float2(to_float(v.x), to_float(v.y));
}

// A warp's output items of a (16 mtiles) x (32 ngroups) product: item i =
// warp + t * WARPS is rows 16 (i / ngroups) .., columns 32 (i % ngroups) ...
// n is the same for every lane, so branches on it do not diverge.
struct Items {
  int n;
  int row[MAXI];
  int col[MAXI];
};

__device__ __forceinline__ Items warp_items(int mtiles, int ngroups, int warp) {
  Items it;
  it.n = 0;
#pragma unroll
  for (int t = 0; t < MAXI; ++t) {
    const int i = warp + t * WARPS;
    it.row[t] = 0;
    it.col[t] = 0;
    if (i < mtiles * ngroups) {
      it.row[t] = (i / ngroups) * 16;
      it.col[t] = (i % ngroups) * 32;
      it.n = t + 1;
    }
  }
  return it;
}

// Where A[row, k] lies: base + rowoff(row) + koff(k). koff is taken at k a
// multiple of 8, and k .. k + 7 are contiguous (every channel count is a
// multiple of 8). Staged x rows are ldk apart (gemm_x).
struct StagedA {  // a K chunk of x staged at k0
  int k0;
  __device__ int koff(int k) const { return k - k0; }
};

struct RowsA {  // y2, row stride ld
  int ld;
  __device__ int rowoff(int r) const { return r * ld; }
  __device__ int koff(int k) const { return k; }
};

struct TapsA {  // im2col of the y1 halo: k = (dy * 3 + dx) * Cm + c
  int ld, TW, P, Cm;
  __device__ int rowoff(int r) const {
    if (r >= P) r = 0;  // padding rows read any finite row
    const int i = r / TW;
    return (i * (TW + 2) + r - i * TW) * ld;
  }
  __device__ int koff(int k) const {
    const int tap = k / Cm;
    const int dy = tap / 3;
    return (dy * (TW + 2) + tap - dy * 3) * ld + k - tap * Cm;
  }
};

// acc += A[:, k0 .. k0 + KC) . B^T over one staged chunk of B (rows =
// columns of the output, row stride ldk), by FMA in the ownership of
// mma.sync's fragments (acc[t][j][0..1] row grp, columns 2 tig + {0, 1} of
// n8 tile j; [2..3] row grp + 8). A's k >= K is not read; B's was
// zero-filled when staged.
template <typename A>
__device__ __forceinline__ void chunk_product(
    float (&acc)[MAXI][4][4], const Items& it, const int (&ro)[MAXI][2],
    const float* abase, const A& asrc, const float* Bs, int ldk, int k0, int K,
    int grp, int tig) {
  for (int kk = 0; kk < KC; kk += 8) {
    const int k = k0 + kk;
    if (k >= K) break;
    const int ko = asrc.koff(k);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
#pragma unroll
      for (int t = 0; t < MAXI; ++t) {
        if (t >= it.n) break;
        const float alo = abase[ro[t][0] + ko + e];
        const float ahi = abase[ro[t][1] + ko + e];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* b = Bs + (it.col[t] + j * 8 + 2 * tig) * ldk + kk + e;
          const float b0 = b[0], b1 = b[ldk];
          acc[t][j][0] = fmaf(alo, b0, acc[t][j][0]);
          acc[t][j][1] = fmaf(alo, b1, acc[t][j][1]);
          acc[t][j][2] = fmaf(ahi, b0, acc[t][j][2]);
          acc[t][j][3] = fmaf(ahi, b1, acc[t][j][3]);
        }
      }
    }
  }
}

// Stage columns k0 .. k0 + cols of `rows` rows of x into rows ld apart:
// row r < nrows is pixel (h0 + r / span, w0 + r % span) of the image at
// x + img; zero outside the image, past nrows and past Cin.
template <typename T>
__device__ __forceinline__ void stage_x(T* dst, int ld, const T* x, size_t img,
                                        const Args& a, int h0, int w0,
                                        int span, int rows, int nrows, int k0,
                                        int cols) {
  constexpr int V = 16 / sizeof(T);
  const int cpr = cols / V;
  for (int q = threadIdx.x; q < rows * cpr; q += THREADS) {
    const int r = q / cpr;
    const int kc = (q - r * cpr) * V;
    const int k = k0 + kc;
    const int dh = r / span;
    const int h = h0 + dh, w = w0 + r - dh * span;
    const bool ok =
        r < nrows && k < a.Cin && h >= 0 && h < a.H && w >= 0 && w < a.W;
    const T* src = ok ? x + img + ((size_t)h * a.W + w) * a.Cin + k : x;
    cp_async16(dst + r * ld + kc, src, ok);
  }
}

// Stage columns k0 .. k0 + KC of weight rows n0 .. n0 + rows of the (N, K)
// weight w; zero past N and K.
template <typename T>
__device__ __forceinline__ void stage_w(T* Bs, int ldk, const T* w, int n0,
                                        int rows, int N, int K, int k0) {
  constexpr int V = 16 / sizeof(T);
  constexpr int CPR = KC / V;
  for (int q = threadIdx.x; q < rows * CPR; q += THREADS) {
    const int r = q / CPR;
    const int kc = (q - r * CPR) * V;
    const int n = n0 + r, k = k0 + kc;
    const bool ok = n < N && k < K;
    cp_async16(Bs + r * ldk + kc, ok ? w + (size_t)n * K + k : w, ok);
  }
}

__device__ __forceinline__ void zero(float (&acc)[MAXI][4][4]) {
#pragma unroll
  for (int t = 0; t < MAXI; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][j][e] = 0.f;
}

// acc = xrows . w[n0 ..]^T over K = Cin: x's rows (see stage_x) and the
// weight both staged, two chunks in flight
template <typename T>
__device__ void gemm_x(float (&acc)[MAXI][4][4], const Items& it,
                       const Args& a, const T* x, size_t img, int h0, int w0,
                       int span, int rows, int nrows, const T* w, int n0,
                       int N, T* As, T* Bs, int grp, int tig) {
  const Layout& L = a.L;
  const int ldk = L.ldk, K = a.Cin;
  const int a_stage = L.PHP * ldk, b_stage = L.brows * ldk;
  int ro[MAXI][2];
#pragma unroll
  for (int t = 0; t < MAXI; ++t) {
    ro[t][0] = (it.row[t] + grp) * ldk;
    ro[t][1] = (it.row[t] + grp + 8) * ldk;
  }
  zero(acc);
  const int nk = (K + KC - 1) / KC;
  stage_x(As, ldk, x, img, a, h0, w0, span, rows, nrows, 0, KC);
  stage_w(Bs, ldk, w, n0, L.brows, N, K, 0);
  cp_async_commit();
  for (int c = 0; c < nk; ++c) {
    // the other buffers were last read in step c - 1, behind its barrier
    if (c + 1 < nk) {
      const int s = (c + 1) & 1;
      stage_x(As + s * a_stage, ldk, x, img, a, h0, w0, span, rows, nrows,
              (c + 1) * KC, KC);
      stage_w(Bs + s * b_stage, ldk, w, n0, L.brows, N, K, (c + 1) * KC);
    }
    cp_async_commit();  // possibly empty: keeps the group count uniform
    cp_async_wait_one();  // chunk c has landed
    __syncthreads();
    chunk_product(acc, it, ro, As + (c & 1) * a_stage, StagedA{c * KC},
                  Bs + (c & 1) * b_stage, ldk, c * KC, K, grp, tig);
    __syncthreads();
  }
}

// acc = A . w[n0 ..]^T with A already in shared memory; the weight staged
template <typename T, typename A>
__device__ void gemm_smem(float (&acc)[MAXI][4][4], const Items& it,
                          const T* abase, const A& asrc, int K, const T* w,
                          int n0, int N, T* Bs, const Layout& L, int grp,
                          int tig) {
  const int ldk = L.ldk, b_stage = L.brows * ldk;
  int ro[MAXI][2];
#pragma unroll
  for (int t = 0; t < MAXI; ++t) {
    ro[t][0] = asrc.rowoff(it.row[t] + grp);
    ro[t][1] = asrc.rowoff(it.row[t] + grp + 8);
  }
  zero(acc);
  const int nk = (K + KC - 1) / KC;
  stage_w(Bs, ldk, w, n0, L.brows, N, K, 0);
  cp_async_commit();
  for (int c = 0; c < nk; ++c) {
    if (c + 1 < nk)
      stage_w(Bs + ((c + 1) & 1) * b_stage, ldk, w, n0, L.brows, N, K,
              (c + 1) * KC);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    chunk_product(acc, it, ro, abase, asrc, Bs + (c & 1) * b_stage, ldk,
                  c * KC, K, grp, tig);
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    fused_block_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const smem = reinterpret_cast<T*>(smem_raw);
  const Layout& L = a.L;
  T* const y1 = smem;  // (PHP, ldy) y1 halo; then (PP, ldr) rounded residual
  T* const y2 = smem + L.off_y2;  // (PP, ldy)
  T* const As = smem + L.off_a;   // 2 x (PHP, ldk)
  T* const Bs = smem + L.off_b;   // 2 x (brows, ldk)
  const T* const x = static_cast<const T*>(a.x);
  T* const out = static_cast<T*>(a.out);

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int grp = lane / 4, tig = lane % 4;  // mma fragment coordinates
  const int tiles = L.tiles_h * L.tiles_w;
  const int img = blockIdx.x / tiles;
  const int tile = blockIdx.x - img * tiles;
  const int oh0 = (tile / L.tiles_w) * L.TH;
  const int ow0 = (tile % L.tiles_w) * L.TW;
  const size_t x_img = (size_t)img * a.H * a.W * a.Cin;
  const size_t o_img = (size_t)img * a.H * a.W * a.Cout;
  const int cm_groups = (a.Cm + 31) / 32;
  const int span = L.TW + 2;  // halo width
  float acc[MAXI][4][4];

  // 1. y1 = relu(x . w1^T + b1) on the tile and its halo, 0 outside the image
  {
    const Items it = warp_items(L.PHP / 16, cm_groups, warp);
    gemm_x<T>(acc, it, a, x, x_img, oh0 - 1, ow0 - 1, span, L.PHP, L.PH,
              static_cast<const T*>(a.w1), 0, a.Cm, As, Bs, grp, tig);
#pragma unroll
    for (int t = 0; t < MAXI; ++t) {
      if (t >= it.n) break;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = it.col[t] + j * 8 + 2 * tig;
        if (n >= a.Cm) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = it.row[t] + grp + 8 * h;
          const int dh = r / span;
          const int ih = oh0 - 1 + dh, iw = ow0 - 1 + r - dh * span;
          const bool in =
              r < L.PH && ih >= 0 && ih < a.H && iw >= 0 && iw < a.W;
          const float v0 = in ? fmaxf(acc[t][j][2 * h] + a.b1[n], 0.f) : 0.f;
          const float v1 =
              in ? fmaxf(acc[t][j][2 * h + 1] + a.b1[n + 1], 0.f) : 0.f;
          store_pair(y1 + r * L.ldy + n, v0, v1);
        }
      }
    }
  }
  __syncthreads();

  // 2. y2 = relu(im2col(y1) . w2^T + b2), K = 9 Cm in (dy, dx, c) order
  {
    const Items it = warp_items(L.PP / 16, cm_groups, warp);
    gemm_smem<T>(acc, it, y1, TapsA{L.ldy, L.TW, L.P, a.Cm}, 9 * a.Cm,
                 static_cast<const T*>(a.w2), 0, a.Cm, Bs, L, grp, tig);
#pragma unroll
    for (int t = 0; t < MAXI; ++t) {
      if (t >= it.n) break;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = it.col[t] + j * 8 + 2 * tig;
        if (n >= a.Cm) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = it.row[t] + grp + 8 * h;
          const bool in = r < L.P;
          const float v0 = in ? fmaxf(acc[t][j][2 * h] + a.b2[n], 0.f) : 0.f;
          const float v1 =
              in ? fmaxf(acc[t][j][2 * h + 1] + a.b2[n + 1], 0.f) : 0.f;
          store_pair(y2 + r * L.ldy + n, v0, v1);
        }
      }
    }
  }
  __syncthreads();

  // 3. in passes of NB output channels: the residual r = T(x . wd^T + bd),
  // or x's channels, into the y1 buffer (y1 is dead), then out =
  // T(relu(T(y2 . w3^T + b3) + r))
  const Items it = warp_items(L.PP / 16, L.NB / 32, warp);
  for (int n0 = 0; n0 < a.Cout; n0 += L.NB) {
    if (a.wd == nullptr) {
      // lands while the last product runs: its first wait and barrier cover
      // this older group
      stage_x(y1, L.ldr, x, x_img, a, oh0, ow0, L.TW, L.PP, L.P, n0, L.NB);
      cp_async_commit();
    } else {
      gemm_x<T>(acc, it, a, x, x_img, oh0, ow0, L.TW, L.PP, L.P,
                static_cast<const T*>(a.wd), n0, a.Cout, As, Bs, grp, tig);
#pragma unroll
      for (int t = 0; t < MAXI; ++t) {
        if (t >= it.n) break;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int nl = it.col[t] + j * 8 + 2 * tig;
          if (n0 + nl >= a.Cout) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = it.row[t] + grp + 8 * h;
            store_pair(y1 + r * L.ldr + nl, acc[t][j][2 * h] + a.bd[n0 + nl],
                       acc[t][j][2 * h + 1] + a.bd[n0 + nl + 1]);
          }
        }
      }
      __syncthreads();
    }
    gemm_smem<T>(acc, it, y2, RowsA{L.ldy}, a.Cm, static_cast<const T*>(a.w3),
                 n0, a.Cout, Bs, L, grp, tig);
#pragma unroll
    for (int t = 0; t < MAXI; ++t) {
      if (t >= it.n) break;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nl = it.col[t] + j * 8 + 2 * tig;
        const int n = n0 + nl;
        if (n >= a.Cout) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = it.row[t] + grp + 8 * h;
          if (r >= L.P) continue;
          const int i = r / L.TW;
          const int oh = oh0 + i, ow = ow0 + r - i * L.TW;
          if (oh >= a.H || ow >= a.W) continue;
          const size_t pix = (size_t)oh * a.W + ow;
          const float z0 = to_float(round_to<T>(acc[t][j][2 * h] + a.b3[n]));
          const float z1 =
              to_float(round_to<T>(acc[t][j][2 * h + 1] + a.b3[n + 1]));
          const float2 res = load_pair(y1 + r * L.ldr + nl);
          store_pair(out + o_img + pix * a.Cout + n, fmaxf(z0 + res.x, 0.f),
                     fmaxf(z1 + res.y, 0.f));
        }
      }
    }
    __syncthreads();  // the residual buffer and the stages are reused
  }
}

int round_up(int v, int m) { return (v + m - 1) / m * m; }
int imax(int a, int b) { return a > b ? a : b; }

// The layout of a TH x TW tile, or false when it breaks a limit of the
// kernel (items per warp, shared memory).
bool make_layout(int elem, int pad, int H, int W, int Cin, int Cm, int Cout,
                 bool proj, int TH, int TW, Layout* out) {
  Layout l{};
  l.TH = TH;
  l.TW = TW;
  l.tiles_h = (H + TH - 1) / TH;
  l.tiles_w = (W + TW - 1) / TW;
  l.P = TH * TW;
  l.PP = round_up(l.P, 16);
  l.PH = (TH + 2) * (TW + 2);
  l.PHP = round_up(l.PH, 16);
  const int cm_groups = (Cm + 31) / 32;
  // y1's product has the most rows (PHP > PP): it bounds the items of both
  // Cm-wide products
  if ((l.PHP / 16) * cm_groups > MAX_ITEMS) return false;
  const int groups = MAX_ITEMS / (l.PP / 16);
  const int passes = (Cout + 32 * groups - 1) / (32 * groups);
  l.NB = round_up((Cout + passes - 1) / passes, 32);
  l.brows = imax(32 * cm_groups, l.NB);
  l.ldk = KC + pad;
  l.ldy = Cm + pad;
  l.ldr = l.NB + pad;
  const int align = 16 / elem;
  l.off_y2 = round_up(imax(l.PHP * l.ldy, l.PP * l.ldr), align);
  l.off_a = l.off_y2 + round_up(l.PP * l.ldy, align);
  l.off_b = l.off_a + round_up(2 * l.PHP * l.ldk, align);
  const long long bytes = ((long long)l.off_b + 2LL * l.brows * l.ldk) * elem;
  if (bytes > SMEM_MAX) return false;
  l.bytes = (int)bytes;
  l.cost = (long long)l.tiles_h * l.tiles_w *
           ((long long)l.PHP * Cin * Cm +
            (long long)l.PP * (9LL * Cm * Cm + (long long)Cm * Cout +
                               (proj ? (long long)Cin * Cout : 0LL)));
  *out = l;
  return true;
}

// The float32 tile with the least padded work that fits in shared memory.
bool plan_f32(int H, int W, int Cin, int Cm, int Cout, bool proj, Layout* best) {
  bool found = false;
  for (int TH = 1; TH <= H && TH <= MAX_P; ++TH) {
    for (int TW = 1; TW <= W && TH * TW <= MAX_P; ++TW) {
      Layout l;
      if (!make_layout(sizeof(float), F32_PAD, H, W, Cin, Cm, Cout, proj, TH,
                       TW, &l))
        continue;
      if (!found || l.cost < best->cost ||
          (l.cost == best->cost && l.P > best->P)) {
        *best = l;
        found = true;
      }
    }
  }
  return found;
}

bool valid_shape(int H, int W, int Cin, int Cm, int Cout, bool proj) {
  return H > 0 && W > 0 && Cin > 0 && Cm > 0 && Cout > 0 && Cin % 8 == 0 &&
         Cm % 8 == 0 && Cout % 8 == 0 && (proj || Cin == Cout);
}

int launch_f32(Args a, int batch, cudaStream_t s) {
  const long long blocks = (long long)batch * a.L.tiles_h * a.L.tiles_w;
  if (blocks <= 0 || blocks > INT_MAX) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      fused_block_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      a.L.bytes);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(fused_block_kernel<float>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  fused_block_kernel<float><<<(unsigned)blocks, THREADS, a.L.bytes, s>>>(a);
  return cudaGetLastError();
}

// --- wgmma path (bfloat16) -------------------------------------------------

namespace wg {

constexpr int KCH = 64;        // K elements per chunk: one 128-byte row
constexpr int NB = 128;        // output channels per pass of the last product
constexpr int MAXI = 4;        // 64 x 64 items per warpgroup and product
constexpr int MAX_STAGES = 4;
constexpr int B_BYTES = 128 * 128;  // a weight chunk: up to 128 rows

struct Plan {
  int TH, TW, tiles_h, tiles_w;
  int P, PP, PH, PHP;    // tile and halo pixels, and both rounded up to 64
  int cm64;              // Cm rounded up to 64: the N of the Cm-wide products
  int ldy, ldr;          // row strides (elements) of y1 / y2 and the residual
  int a_bytes, stages;   // A part of a ring stage (PHP rows of 128 bytes)
  int off_y1, off_y2, off_bias, off_zero, off_bar;  // bytes after the ring
  int cout128;           // Cout rounded up to 128: the bias arrays' length
  int bytes;             // dynamic shared memory, 1024 bytes of slack included
  long long cost;        // multiply-adds of a warpgroup, whole image
};

struct Maps {
  CUtensorMap x_halo;  // x, boxes of 64 channels x (TW + 2) x (TH + 2) pixels
  CUtensorMap x_tile;  // x, boxes of 64 channels x TW x TH pixels
  CUtensorMap w1, w2;  // boxes of 64 (K) x cm64 rows
  CUtensorMap w3, wd;  // boxes of 64 (K) x NB rows
};

struct WArgs {
  const bf16* x;
  bf16* out;
  const float *b1, *b2, *b3, *bd;
  int proj, batch, H, W, Cin, Cm, Cout;
  Plan L;
};

int ceil_div(int a, int b) { return (a + b - 1) / b; }
__device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// The chunk sequence of one tile: n1 chunks of the halo product, n2 of the
// 3x3, then per pass nd of the projection and n3 of the last product.
struct Seq {
  int n1, n2, nd, n3, passes, per_tile;
};

__device__ __forceinline__ Seq sequence(const WArgs& a) {
  Seq q;
  q.n1 = cdiv(a.Cin, KCH);
  q.n2 = cdiv(9 * a.Cm, KCH);
  q.nd = a.proj ? q.n1 : 0;
  q.n3 = cdiv(a.Cm, KCH);
  q.passes = cdiv(a.Cout, NB);
  q.per_tile = q.n1 + q.n2 + q.passes * (q.nd + q.n3);
  return q;
}

struct Tile {
  int img, oh0, ow0;
};

__device__ __forceinline__ Tile tile_of(const WArgs& a, int t) {
  const int per_img = a.L.tiles_h * a.L.tiles_w;
  Tile r;
  r.img = t / per_img;
  const int rem = t - r.img * per_img;
  r.oh0 = (rem / a.L.tiles_w) * a.L.TH;
  r.ow0 = (rem % a.L.tiles_w) * a.L.TW;
  return r;
}

// Item t (of MAXI) of warpgroup w in a product over `slices` x `nsub` 64 x
// 64 items. A products from shared memory (`by_rows` false) deal the items
// round robin; register-A products keep one slice per warpgroup, so its A
// fragments serve all its items. Returns false for a warpgroup's item past
// the product (an odd count), whose sl and j then name the last item: the
// wgmma issue loops run both warpgroups over `per_wg` items, a count
// derived from kernel parameters alone, since a wgmma behind a branch on the
// warpgroup makes ptxas serialize every wgmma of the kernel; the epilogues
// skip the duplicate.
__device__ __forceinline__ bool item(int w, int t, int slices, int nsub,
                                     bool by_rows, int* sl, int* j) {
  if (by_rows && slices == 2) {
    *sl = w;
    *j = t;
    return t < nsub;
  }
  if (by_rows) {  // one slice: split its columns
    const int jj = w + 2 * t;
    *sl = 0;
    *j = min(jj, nsub - 1);
    return jj < nsub;
  }
  const int id = w + 2 * t;
  const int idc = min(id, slices * nsub - 1);
  *sl = idc / nsub;
  *j = idc - *sl * nsub;
  return id < slices * nsub;
}

// The items each warpgroup issues in such a product (both the same).
__host__ __device__ __forceinline__ int per_wg(int slices, int nsub,
                                               bool by_rows) {
  if (by_rows && slices == 2) return nsub;
  if (by_rows) return (nsub + 1) / 2;
  return (slices * nsub + 1) / 2;
}

// The bias of a thread's accumulator columns 8 q + {0, 1}, q = 0..7, from
// the block's zero-padded copy in shared memory.
__device__ __forceinline__ void load_bias(float (&bv)[16], const float* b) {
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const float2 v = *reinterpret_cast<const float2*>(b + 8 * q);
    bv[2 * q] = v.x;
    bv[2 * q + 1] = v.y;
  }
}

__device__ __forceinline__ void zero(float (&acc)[MAXI][32]) {
#pragma unroll
  for (int t = 0; t < MAXI; ++t)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[t][i] = 0.f;
}

template <int R>
__device__ __forceinline__ void fence_all(float (&acc)[R][32]) {
#pragma unroll
  for (int t = 0; t < R; ++t) hopper::fence_regs(acc[t]);
}

// Warp roles: warpgroup 0 is the producer (one thread issues every TMA load
// of the block, the others leave), warpgroups 1 and 2 the consumers, which
// take the producer's registers. A ring stage is filled when its `full`
// barrier completes (the producer's expect-tx plus TMA's bytes) and free
// again when both consumer warpgroups have arrived on its `empty` barrier,
// after their wgmma that read it completed; the consumers keep one wgmma
// group in flight behind the next stage's wait and A loads. Named barrier 1
// orders the consumers' writes and reads of y1, y2 and the residual.
constexpr int WG_THREADS = 384;
constexpr int CONSUMERS = 256;
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;

__device__ __forceinline__ void consumer_sync() {
  hopper::bar_sync(1, CONSUMERS);
}

__global__ void __launch_bounds__(WG_THREADS, 1)
    fused_block_wgmma(const __grid_constant__ Maps maps, const WArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const base =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  const Plan& L = a.L;
  const int stage_bytes = L.a_bytes + B_BYTES;
  unsigned char* const ring = base;
  bf16* const y1 = reinterpret_cast<bf16*>(base + L.off_y1);  // and residual
  bf16* const y2 = reinterpret_cast<bf16*>(base + L.off_y2);
  bf16* const zrow = reinterpret_cast<bf16*>(base + L.off_zero);
  const int S = L.stages;
  uint64_t* const full = reinterpret_cast<uint64_t*>(base + L.off_bar);
  uint64_t* const empty = full + S;

  const Seq q = sequence(a);
  const int tiles = a.batch * L.tiles_h * L.tiles_w;
  const int my_tiles = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) / gridDim.x;
  const int total = my_tiles * q.per_tile;

  // the biases, zero past their length: b1 and b2 (cm64 each), b3 and bd
  // (cout128 each)
  float* const bias = reinterpret_cast<float*>(base + L.off_bias);
  float* const sb1 = bias;
  float* const sb2 = bias + L.cm64;
  float* const sb3 = bias + 2 * L.cm64;
  float* const sbd = sb3 + L.cout128;
  for (int i = threadIdx.x; i < L.cm64; i += WG_THREADS) {
    sb1[i] = i < a.Cm ? a.b1[i] : 0.f;
    sb2[i] = i < a.Cm ? a.b2[i] : 0.f;
  }
  for (int i = threadIdx.x; i < L.cout128; i += WG_THREADS) {
    sb3[i] = i < a.Cout ? a.b3[i] : 0.f;
    sbd[i] = a.proj && i < a.Cout ? a.bd[i] : 0.f;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    *reinterpret_cast<int4*>(zrow) = make_int4(0, 0, 0, 0);
    hopper::fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // the producer: step it is chunk it % per_tile of the block's tile
    // it / per_tile, into stage it % S once the consumers freed its last use
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x != 0) return;
    const uint32_t halo_tx = 128u * (L.TW + 2) * (L.TH + 2);
    const uint32_t tile_tx = 128u * L.TW * L.TH;
    for (int it = 0; it < total; ++it) {
      if (it >= S) hopper::mbar_wait(&empty[it % S], ((it / S) - 1) & 1);
      const Tile tl = tile_of(a, blockIdx.x + (it / q.per_tile) * gridDim.x);
      int c = it % q.per_tile;
      unsigned char* const A = ring + (it % S) * stage_bytes;
      unsigned char* const B = A + L.a_bytes;
      uint64_t* const bar = &full[it % S];
      if (c < q.n1) {
        hopper::mbar_arrive_expect_tx(bar, halo_tx + 128u * L.cm64);
        hopper::tma_load_4d(A, &maps.x_halo, bar, c * KCH, tl.ow0 - 1,
                            tl.oh0 - 1, tl.img);
        hopper::tma_load_2d(B, &maps.w1, bar, c * KCH, 0);
        continue;
      }
      c -= q.n1;
      if (c < q.n2) {
        hopper::mbar_arrive_expect_tx(bar, 128u * L.cm64);
        hopper::tma_load_2d(B, &maps.w2, bar, c * KCH, 0);
        continue;
      }
      c -= q.n2;
      const int n0 = (c / (q.nd + q.n3)) * NB;
      c %= q.nd + q.n3;
      if (c < q.nd) {
        hopper::mbar_arrive_expect_tx(bar, tile_tx + 128u * NB);
        hopper::tma_load_4d(A, &maps.x_tile, bar, c * KCH, tl.ow0, tl.oh0,
                            tl.img);
        hopper::tma_load_2d(B, &maps.wd, bar, c * KCH, n0);
      } else {
        hopper::mbar_arrive_expect_tx(bar, 128u * NB);
        hopper::tma_load_2d(B, &maps.w3, bar, (c - q.nd) * KCH, n0);
      }
    }
    return;
  }
  hopper::setmaxnreg_inc<CONSUMER_REGS>();

  const int tid = threadIdx.x - 128;
  const int wgi = tid / 128, warp4 = (tid % 128) / 32, lane = tid % 32;
  const bool leader = tid % 128 == 0;  // arrives for its warpgroup

  int it = 0;  // the consumers' step, in the producer's order
  // the stage of step it, once it has landed
  auto wait_full = [&]() -> unsigned char* {
    hopper::mbar_wait(&full[it % S], (it / S) & 1);
    return ring + (it % S) * stage_bytes;
  };
  float acc[MAXI][32];
  // after committing chunk c's group (step it): wait for the group before
  // it, free that group's stage and go on to the next step
  auto retire = [&](int c) {
    hopper::wgmma_wait<1>();
    fence_all(acc);
    if (c > 0 && leader) hopper::mbar_arrive(&empty[(it - 1) % S]);
    ++it;
  };
  // after a product's last chunk: its last group done, its stage freed
  auto drain = [&]() {
    hopper::wgmma_wait<0>();
    fence_all(acc);
    if (leader) hopper::mbar_arrive(&empty[(it - 1) % S]);
  };

  // A from shared memory (the x halo or tile in the stage), items dealt
  // round robin over `slices` x `nsub`
  auto ss_product = [&](int n, int slices, int nsub) {
    zero(acc);
    for (int c = 0; c < n; ++c) {
      unsigned char* const A = wait_full();
      const unsigned char* const B = A + L.a_bytes;
      fence_all(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int t = 0; t < MAXI; ++t) {
        if (t >= per_wg(slices, nsub, false)) break;
        int sl, j;
        item(wgi, t, slices, nsub, false, &sl, &j);
        const uint64_t da = hopper::desc_sw128(A + sl * 8192);
        const uint64_t db = hopper::desc_sw128(B + j * 8192);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          hopper::wgmma_bf16_ss_n64(acc[t], hopper::desc_add(da, 32 * ks),
                                    hopper::desc_add(db, 32 * ks), 1);
      }
      hopper::wgmma_commit();
      retire(c);
    }
    drain();
  };

  // this lane's row of an ldmatrix.x4 of a 16-row A fragment: lanes 8 m ..
  // 8 m + 7 address matrix m (rows + 8 (m % 2), columns + 8 (m / 2))
  const int lrow = warp4 * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lcol = (lane >> 4) * 8;
  // accumulator i of a thread: row 16 warp4 + lane / 4 + 8 ((i / 2) % 2) of
  // its 64-row slice, column 8 (i / 4) + 2 (lane % 4) + i % 2 of its item
  const int arow = warp4 * 16 + lane / 4;
  const int acol = 2 * (lane % 4);

  // A from registers: src(k) is the shared-memory row this lane's ldmatrix
  // reads for columns k .. k + 7 of its A row; items dealt by rows. Chunks
  // alternate between two fragment buffers, since the group of the chunk
  // before may still read the other.
  uint32_t af0[4][4], af1[4][4];
  auto rs_chunk = [&](int c, uint32_t (&af)[4][4], int slices, int nsub,
                      const auto& src) {
    unsigned char* const A = wait_full();
    const unsigned char* const B = A + L.a_bytes;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      hopper::ldmatrix_x4(af[ks], src(c * KCH + ks * 16 + lcol));
    fence_all(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int t = 0; t < MAXI; ++t) {
      if (t >= per_wg(slices, nsub, true)) break;
      int s2, j;
      item(wgi, t, slices, nsub, true, &s2, &j);
      const uint64_t db = hopper::desc_sw128(B + j * 8192);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        hopper::wgmma_bf16_rs_n64(acc[t], af[ks], hopper::desc_add(db, 32 * ks),
                                  1);
    }
    hopper::wgmma_commit();
    retire(c);
  };
  auto rs_product = [&](int n, int slices, int nsub, const auto& src) {
    zero(acc);
    for (int c = 0; c < n; c += 2) {
      rs_chunk(c, af0, slices, nsub, src);
      if (c + 1 < n) rs_chunk(c + 1, af1, slices, nsub, src);
    }
    drain();
  };

  for (int lt = 0; lt < my_tiles; ++lt) {
    const Tile tl = tile_of(a, blockIdx.x + lt * gridDim.x);
    const size_t x_img = (size_t)tl.img * a.H * a.W * a.Cin;
    const size_t o_img = (size_t)tl.img * a.H * a.W * a.Cout;

    // 1. y1 = relu(x . w1^T + b1) over the halo, 0 outside the image
    {
      const int slices = L.PHP / 64, nsub = L.cm64 / 64;
      ss_product(q.n1, slices, nsub);
      consumer_sync();  // the last tile's reads of the y1 buffer are done
#pragma unroll
      for (int t = 0; t < MAXI; ++t) {
        int sl, j;
        if (!item(wgi, t, slices, nsub, false, &sl, &j)) continue;
        float bv[16];
        load_bias(bv, sb1 + j * 64 + acol);
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int n = j * 64 + 8 * (i / 4) + acol;
          if (n >= a.Cm) continue;
          const int r = sl * 64 + arow + 8 * ((i / 2) % 2);
          const int dh = r / (L.TW + 2);
          const int ih = tl.oh0 - 1 + dh, iw = tl.ow0 - 1 + r - dh * (L.TW + 2);
          const bool in = r < L.PH && ih >= 0 && ih < a.H && iw >= 0 && iw < a.W;
          store_pair(y1 + r * L.ldy + n,
                     in ? fmaxf(acc[t][i] + bv[(i / 4) * 2], 0.f) : 0.f,
                     in ? fmaxf(acc[t][i + 1] + bv[(i / 4) * 2 + 1], 0.f) : 0.f);
        }
      }
      consumer_sync();  // y1 is whole
    }

    // 2. y2 = relu(im2col(y1) . w2^T + b2), K = 9 Cm in (dy, dx, c) order;
    // A from registers: the y1 rows of each tap, a zero row past K
    {
      const int slices = L.PP / 64, nsub = L.cm64 / 64;
      const int sl = slices == 2 ? wgi : 0;
      int r = sl * 64 + lrow;
      if (r >= L.P) r = 0;  // padding rows read any finite row
      const int ti = r / L.TW;
      const int hbase = ti * (L.TW + 2) + r - ti * L.TW;  // its halo pixel
      rs_product(q.n2, slices, nsub, [&](int kk) -> const bf16* {
        if (kk >= 9 * a.Cm) return zrow;
        const int tap = kk / a.Cm;
        const int dy = tap / 3;
        return y1 + (hbase + dy * (L.TW + 2) + tap - 3 * dy) * L.ldy + kk -
               tap * a.Cm;
      });
#pragma unroll
      for (int t = 0; t < MAXI; ++t) {
        int s2, j;
        if (!item(wgi, t, slices, nsub, true, &s2, &j)) continue;
        float bv[16];
        load_bias(bv, sb2 + j * 64 + acol);
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int n = j * 64 + 8 * (i / 4) + acol;
          if (n >= a.Cm) continue;
          const int rr = s2 * 64 + arow + 8 * ((i / 2) % 2);
          const bool in = rr < L.P;
          store_pair(y2 + rr * L.ldy + n,
                     in ? fmaxf(acc[t][i] + bv[(i / 4) * 2], 0.f) : 0.f,
                     in ? fmaxf(acc[t][i + 1] + bv[(i / 4) * 2 + 1], 0.f) : 0.f);
        }
      }
      consumer_sync();  // y2 is whole, and y1's last reads are done
    }

    // 3. in passes of NB output channels: a projection residual T(x . wd^T
    // + bd) into the y1 buffer (y1 is dead), then out = T(relu(T(y2 . w3^T
    // + b3) + r)), r from that buffer or from x
    const int slices = L.PP / 64, nsub = NB / 64;
    const int sl = slices == 2 ? wgi : 0;
    for (int n0 = 0; n0 < a.Cout; n0 += NB) {
      if (a.proj) {
        ss_product(q.nd, slices, nsub);
        if (n0 > 0) consumer_sync();  // the last pass's residual reads are done
#pragma unroll
        for (int t = 0; t < MAXI; ++t) {
          int s2, j;
          if (!item(wgi, t, slices, nsub, false, &s2, &j)) continue;
          float bv[16];
          load_bias(bv, sbd + n0 + j * 64 + acol);
#pragma unroll
          for (int i = 0; i < 32; i += 2) {
            const int nl = j * 64 + 8 * (i / 4) + acol;
            if (n0 + nl >= a.Cout) continue;
            const int r = s2 * 64 + arow + 8 * ((i / 2) % 2);
            store_pair(y1 + r * L.ldr + nl, acc[t][i] + bv[(i / 4) * 2],
                       acc[t][i + 1] + bv[(i / 4) * 2 + 1]);
          }
        }
        consumer_sync();  // the residual is whole
      }
      rs_product(q.n3, slices, nsub, [&](int kk) -> const bf16* {
        return kk < a.Cm ? y2 + (sl * 64 + lrow) * L.ldy + kk : zrow;
      });
      // the thread's two output pixels (rows arow and arow + 8 of its
      // slice), or -1 outside the tile or the image
      long long pix[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = sl * 64 + arow + 8 * h;
        const int ti = r / L.TW;
        const int oh = tl.oh0 + ti, ow = tl.ow0 + r - ti * L.TW;
        pix[h] = (r < L.P && oh < a.H && ow < a.W) ? (long long)oh * a.W + ow : -1;
      }
#pragma unroll
      for (int t = 0; t < MAXI; ++t) {
        int s2, j;
        if (!item(wgi, t, slices, nsub, true, &s2, &j)) continue;
        float bv[16];
        load_bias(bv, sb3 + n0 + j * 64 + acol);
        // the residual pairs, all loaded before any is used
        uint32_t rv[16];
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int nl = j * 64 + 8 * (i / 4) + acol;
          const int h = (i / 2) % 2;
          const int r = s2 * 64 + arow + 8 * h;
          rv[i / 2] = 0u;
          if (n0 + nl >= a.Cout || pix[h] < 0) continue;
          rv[i / 2] = a.proj ? *reinterpret_cast<const uint32_t*>(y1 + r * L.ldr + nl)
                             : __ldg(reinterpret_cast<const unsigned int*>(
                                   a.x + x_img + pix[h] * a.Cin + n0 + nl));
        }
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int nl = j * 64 + 8 * (i / 4) + acol;
          const int n = n0 + nl;
          const int h = (i / 2) % 2;
          if (n >= a.Cout || pix[h] < 0) continue;
          const float z0 = to_float(round_to<bf16>(acc[t][i] + bv[(i / 4) * 2]));
          const float z1 =
              to_float(round_to<bf16>(acc[t][i + 1] + bv[(i / 4) * 2 + 1]));
          const float2 res = load_pair(reinterpret_cast<const bf16*>(&rv[i / 2]));
          store_pair(a.out + o_img + pix[h] * a.Cout + n, fmaxf(z0 + res.x, 0.f),
                     fmaxf(z1 + res.y, 0.f));
        }
      }
    }
  }
}

bool make_plan(int H, int W, int Cin, int Cm, int Cout, bool proj, int TH,
               int TW, Plan* out) {
  Plan l{};
  l.TH = TH;
  l.TW = TW;
  l.tiles_h = ceil_div(H, TH);
  l.tiles_w = ceil_div(W, TW);
  l.P = TH * TW;
  l.PP = round_up(l.P, 64);
  l.PH = (TH + 2) * (TW + 2);
  l.PHP = round_up(l.PH, 64);
  l.cm64 = round_up(Cm, 64);
  if (l.PP > 128 || l.PHP > 256 || l.cm64 > 128 || TW + 2 > 256 || TH + 2 > 256)
    return false;
  if ((l.PHP / 64) * (l.cm64 / 64) > 2 * MAXI) return false;
  l.ldy = Cm + 8;
  l.ldr = NB + 8;
  l.cout128 = round_up(Cout, 128);
  l.a_bytes = l.PHP * 128;  // the A part of a stage: the x halo
  const int y1_bytes =
      round_up(2 * imax(l.PHP * l.ldy, proj ? l.PP * l.ldr : 0), 1024);
  const int y2_bytes = round_up(2 * l.PP * l.ldy, 1024);
  const int bias_bytes = 4 * (2 * l.cm64 + 2 * l.cout128);
  const int fixed = 1024 + y1_bytes + y2_bytes + bias_bytes + 16 + 16 * MAX_STAGES;
  l.stages = (SMEM_MAX - fixed) / (l.a_bytes + B_BYTES);
  if (l.stages > MAX_STAGES) l.stages = MAX_STAGES;
  if (l.stages < 2) return false;
  const int ring = l.stages * (l.a_bytes + B_BYTES);
  l.off_y1 = ring;
  l.off_y2 = ring + y1_bytes;
  l.off_bias = l.off_y2 + y2_bytes;
  l.off_zero = l.off_bias + bias_bytes;
  l.off_bar = l.off_zero + 16;
  l.bytes = 1024 + l.off_bar + 16 * l.stages;  // full and empty
  // the time of a product is a warpgroup's: items x K
  const long long cin64 = round_up(Cin, 64), k2 = round_up(9 * Cm, 64);
  const long long passes = ceil_div(Cout, NB);
  const int s1 = l.PHP / 64, s2 = l.PP / 64;
  const long long per_tile =
      (long long)per_wg(s1, l.cm64 / 64, false) * cin64 +
      (long long)per_wg(s2, l.cm64 / 64, true) * k2 +
      passes * ((long long)per_wg(s2, NB / 64, true) * l.cm64 +
                (proj ? (long long)per_wg(s2, NB / 64, false) * cin64 : 0));
  l.cost = (long long)l.tiles_h * l.tiles_w * per_tile * 64 * 64;
  *out = l;
  return true;
}

// The tile with the least work for a warpgroup, padding included; ties go
// to the fewer halo pixels loaded per image (8 x 14 over 4 x 32 at 56 x 56:
// 4,480 against 5,712, 4% faster on the card), then to the larger tile.
bool plan(int H, int W, int Cin, int Cm, int Cout, bool proj, Plan* best) {
  if (!valid_shape(H, W, Cin, Cm, Cout, proj)) return false;
  bool found = false;
  long long best_halo = 0;
  for (int TH = 1; TH <= H; ++TH) {
    for (int TW = 1; TW <= W && TH * TW <= 128; ++TW) {
      Plan l;
      if (!make_plan(H, W, Cin, Cm, Cout, proj, TH, TW, &l)) continue;
      const long long halo = (long long)l.tiles_h * l.tiles_w * l.PH;
      if (!found || l.cost < best->cost ||
          (l.cost == best->cost &&
           (halo < best_halo || (halo == best_halo && l.P > best->P)))) {
        best_halo = halo;
        *best = l;
        found = true;
      }
    }
  }
  return found;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 132;
  }
  return n;
}

bool encode_w(CUtensorMap* m, const void* w, int K, int N, int rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)N};
  const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t box[2] = {KCH, (cuuint32_t)rows};
  return hopper_host::encode_sw128(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w,
                                   dims, strides, box);
}

bool encode_x(CUtensorMap* m, const void* x, int batch, int H, int W, int C,
              int bw, int bh) {
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                 (cuuint64_t)H * W * C * 2};
  const cuuint32_t box[4] = {KCH, (cuuint32_t)bw, (cuuint32_t)bh, 1};
  return hopper_host::encode_sw128(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, x,
                                   dims, strides, box);
}

int launch(const Args& g, int batch, cudaStream_t s) {
  WArgs a{static_cast<const bf16*>(g.x), static_cast<bf16*>(g.out),
          g.b1, g.b2, g.b3, g.bd, g.wd != nullptr, batch, g.H, g.W, g.Cin,
          g.Cm, g.Cout, {}};
  if (!plan(g.H, g.W, g.Cin, g.Cm, g.Cout, a.proj != 0, &a.L))
    return cudaErrorInvalidValue;
  const long long tiles = (long long)batch * a.L.tiles_h * a.L.tiles_w;
  if (tiles <= 0 || tiles > INT_MAX) return cudaErrorInvalidValue;
  Maps m;
  memset(&m, 0, sizeof(m));
  bool ok = encode_x(&m.x_halo, g.x, batch, g.H, g.W, g.Cin, a.L.TW + 2,
                     a.L.TH + 2) &&
            encode_x(&m.x_tile, g.x, batch, g.H, g.W, g.Cin, a.L.TW, a.L.TH) &&
            encode_w(&m.w1, g.w1, g.Cin, g.Cm, a.L.cm64) &&
            encode_w(&m.w2, g.w2, 9 * g.Cm, g.Cm, a.L.cm64) &&
            encode_w(&m.w3, g.w3, g.Cm, g.Cout, NB);
  if (ok && a.proj) ok = encode_w(&m.wd, g.wd, g.Cin, g.Cout, NB);
  if (!ok) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      fused_block_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
      a.L.bytes);
  if (e != cudaSuccess) return e;
  const int grid = (int)(tiles < sm_count() ? tiles : sm_count());
  fused_block_wgmma<<<grid, WG_THREADS, a.L.bytes, s>>>(m, a);
  return cudaGetLastError();
}

}  // namespace wg

}  // namespace

extern "C" {

// The tile the kernel takes for this block shape (dtype 0 float32, 1
// bfloat16): plan[0..4] = TH, TW, NB, shared memory bytes, tiles per image.
// Returns 0, or cudaErrorInvalidValue for a shape the kernel does not take.
int fused_bottleneck_plan(int dtype, int H, int W, int Cin, int Cm, int Cout,
                          int proj, int* plan_out) {
  if (dtype == 1) {
    wg::Plan l;
    if (!wg::plan(H, W, Cin, Cm, Cout, proj != 0, &l))
      return cudaErrorInvalidValue;
    const int v[5] = {l.TH, l.TW, wg::NB, l.bytes, l.tiles_h * l.tiles_w};
    for (int i = 0; i < 5; ++i) plan_out[i] = v[i];
    return 0;
  }
  Layout l;
  if (dtype != 0 || !valid_shape(H, W, Cin, Cm, Cout, proj != 0) ||
      !plan_f32(H, W, Cin, Cm, Cout, proj != 0, &l))
    return cudaErrorInvalidValue;
  const int v[5] = {l.TH, l.TW, l.NB, l.bytes, l.tiles_h * l.tiles_w};
  for (int i = 0; i < 5; ++i) plan_out[i] = v[i];
  return 0;
}

// One stride-1 folded bottleneck block. x: (batch, H, W, Cin) NHWC; out:
// (batch, H, W, Cout); w1 (Cm, Cin), w2 (Cm, 9 Cm), w3 (Cout, Cm), wd
// (Cout, Cin) or NULL for the identity residual (then Cin == Cout), all of
// dtype (0 float32, 1 bfloat16), contiguous and 16-byte aligned; biases
// float32. Channel counts are multiples of 8; in bfloat16 Cm <= 128.
// Returns the CUDA error code of the launch (0 = cudaSuccess); nothing is
// synchronised.
int fused_bottleneck_block(int dtype, const void* x, void* out,
                           const void* w1, const float* b1, const void* w2,
                           const float* b2, const void* w3, const float* b3,
                           const void* wd, const float* bd, int batch, int H,
                           int W, int Cin, int Cm, int Cout, void* stream) {
  Args a{x, out, w1, b1, w2, b2, w3, b3, wd, bd, H, W, Cin, Cm, Cout, {}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return wg::launch(a, batch, s);
  if (dtype != 0 || !valid_shape(H, W, Cin, Cm, Cout, wd != nullptr) ||
      !plan_f32(H, W, Cin, Cm, Cout, wd != nullptr, &a.L))
    return cudaErrorInvalidValue;
  return launch_f32(a, batch, s);
}

}  // extern "C"
