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
// the last product and the residual in column passes of NB channels (the
// residual, x's channels or the projection's rounded output, goes to shared
// memory first). The host picks (TH, TW) per shape: the least padded work
// that fits in shared memory, two blocks per SM in bf16 where possible (8 x
// 14 for layer1's 56 x 56, 4 x 14 for layer2's 28 x 28). Tile edges need
// not divide H or W.
//
// Products. Every product is A (rows, K) . B^T with B = the (N, K) weight.
// The weight is streamed from L2 in K chunks of 32 through a two-stage
// cp.async double buffer (layer2's w2 alone is 295 KB bf16); A is x staged
// the same way (the 1x1 products) or read in place from shared memory (the
// 3x3 product, as an implicit GEMM over shifted views of the y1 halo; the
// last product, from y2). bfloat16 runs mma.sync.m16n8k16 bf16 -> f32;
// float32 runs plain FMA in the same fragment ownership (no TF32), so the
// card's float32 path can be held to the CPU's. Each warp owns up to MAXI
// output items of 16 rows x 32 columns.
//
// Bound on the card, one block of 256 images (224-px patches). layer1
// block 1: 802,816 pixels x (256.64 + 9.64.64 + 64.256) multiply-adds =
// 112 GFLOP, 0.113 ms at 989 TFLOP/s bf16, against 822 MB in and out, 0.245
// ms at 3.35 TB/s: bound by memory. The whole stage (3 blocks, 342 GFLOP,
// 514 MB in and out once) is bound by operations (0.346 ms), but this
// kernel launches once per block, so the residual stream between blocks
// goes through device memory: 2.16 GB for layer1 (0.64 ms) and 1.23 GB for
// layer2's tail (0.37 ms) instead of 514 MB and 411 MB. A stage-resident
// design (halo recompute across blocks), wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int KC = 32;                     // K elements per staged chunk
constexpr int MAXI = 4;                    // 16 x 32 output items per warp
constexpr int MAX_ITEMS = MAXI * WARPS;
constexpr int MAX_P = 128;                 // output pixels per tile
constexpr int SMEM_MAX = 232448;           // a block's shared memory cap
constexpr int SMEM_PER_SM = 233472;        // 228 KB, 1 KB of it per block

// Blocks per SM the kernel is compiled for (__launch_bounds__). bfloat16:
// two, at 128 registers (some spill: measured faster than one block at
// 228 registers without spills); float32: one, whose FMA loop spills badly
// at 128 registers (46 against 75 ms for layer1).
template <typename T> struct BlocksPerSM;
template <> struct BlocksPerSM<bf16> { static constexpr int value = 2; };
template <> struct BlocksPerSM<float> { static constexpr int value = 1; };

// Row padding (elements) of every shared-memory matrix: the 8 rows a warp's
// fragment loads touch then start in 8 different 4-bank groups.
template <typename T> struct Pad;
template <> struct Pad<bf16> { static constexpr int value = 8; };
template <> struct Pad<float> { static constexpr int value = 4; };

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool full) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_size = full ? 16 : 0;  // 0: write 16 zero bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_size));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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
// columns of the output, row stride ldk). A's k >= K reads as zero; B's
// was zero-filled when staged.
template <typename A>
__device__ __forceinline__ void chunk_product(
    float (&acc)[MAXI][4][4], const Items& it, const int (&ro)[MAXI][2],
    const bf16* abase, const A& asrc, const bf16* Bs, int ldk, int k0, int K,
    int grp, int tig) {
#pragma unroll
  for (int kk = 0; kk < KC; kk += 16) {
    const int k = k0 + kk;
    if (k >= K) break;
    const bool hi = k + 8 < K;
    const int klo = asrc.koff(k) + 2 * tig;
    const int khi = hi ? asrc.koff(k + 8) + 2 * tig : 0;
#pragma unroll
    for (int t = 0; t < MAXI; ++t) {
      if (t >= it.n) break;
      uint32_t a[4];
      a[0] = ld_u32(abase + ro[t][0] + klo);
      a[1] = ld_u32(abase + ro[t][1] + klo);
      a[2] = hi ? ld_u32(abase + ro[t][0] + khi) : 0u;
      a[3] = hi ? ld_u32(abase + ro[t][1] + khi) : 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bf16* b = Bs + (it.col[t] + j * 8 + grp) * ldk + kk + 2 * tig;
        mma_bf16(acc[t][j], a, ld_u32(b), ld_u32(b + 8));
      }
    }
  }
}

// float32: the same ownership as the mma fragments (acc[t][j][0..1] row
// grp, columns 2 tig + {0, 1} of n8 tile j; [2..3] row grp + 8), by FMA
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
__global__ void __launch_bounds__(THREADS, BlocksPerSM<T>::value)
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

// The tile with the least padded work, among the layouts that leave room
// for BlocksPerSM<T> blocks on an SM if there are any, else among all.
template <typename T>
bool plan(int H, int W, int Cin, int Cm, int Cout, bool proj, Layout* best) {
  const int caps[2] = {SMEM_PER_SM / BlocksPerSM<T>::value - 1024, SMEM_MAX};
  for (int cap : caps) {
    bool found = false;
    for (int TH = 1; TH <= H && TH <= MAX_P; ++TH) {
      for (int TW = 1; TW <= W && TH * TW <= MAX_P; ++TW) {
        Layout l;
        if (!make_layout(sizeof(T), Pad<T>::value, H, W, Cin, Cm, Cout, proj,
                         TH, TW, &l) ||
            l.bytes > cap)
          continue;
        if (!found || l.cost < best->cost ||
            (l.cost == best->cost && l.P > best->P)) {
          *best = l;
          found = true;
        }
      }
    }
    if (found) return true;
  }
  return false;
}

bool plan_for(int dtype, int H, int W, int Cin, int Cm, int Cout, bool proj,
              Layout* l) {
  if (H <= 0 || W <= 0 || Cin <= 0 || Cm <= 0 || Cout <= 0 || Cin % 8 ||
      Cm % 8 || Cout % 8 || (!proj && Cin != Cout))
    return false;
  if (dtype == 0) return plan<float>(H, W, Cin, Cm, Cout, proj, l);
  if (dtype == 1) return plan<bf16>(H, W, Cin, Cm, Cout, proj, l);
  return false;
}

template <typename T>
int launch(Args a, int batch, cudaStream_t s) {
  const long long blocks = (long long)batch * a.L.tiles_h * a.L.tiles_w;
  if (blocks <= 0 || blocks > INT_MAX) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      fused_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      a.L.bytes);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(fused_block_kernel<T>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  fused_block_kernel<T><<<(unsigned)blocks, THREADS, a.L.bytes, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The tile the kernel takes for this block shape (dtype 0 float32, 1
// bfloat16): plan[0..4] = TH, TW, NB, shared memory bytes, tiles per image.
// Returns 0, or cudaErrorInvalidValue for a shape the kernel does not take.
int fused_bottleneck_plan(int dtype, int H, int W, int Cin, int Cm, int Cout,
                          int proj, int* plan_out) {
  Layout l;
  if (!plan_for(dtype, H, W, Cin, Cm, Cout, proj != 0, &l))
    return cudaErrorInvalidValue;
  plan_out[0] = l.TH;
  plan_out[1] = l.TW;
  plan_out[2] = l.NB;
  plan_out[3] = l.bytes;
  plan_out[4] = l.tiles_h * l.tiles_w;
  return 0;
}

// One stride-1 folded bottleneck block. x: (batch, H, W, Cin) NHWC; out:
// (batch, H, W, Cout); w1 (Cm, Cin), w2 (Cm, 9 Cm), w3 (Cout, Cm), wd
// (Cout, Cin) or NULL for the identity residual (then Cin == Cout), all of
// dtype (0 float32, 1 bfloat16), contiguous and 16-byte aligned; biases
// float32. Channel counts are multiples of 8. Returns the CUDA error code
// of the launch (0 = cudaSuccess); nothing is synchronised.
int fused_bottleneck_block(int dtype, const void* x, void* out,
                           const void* w1, const float* b1, const void* w2,
                           const float* b2, const void* w3, const float* b3,
                           const void* wd, const float* bd, int batch, int H,
                           int W, int Cin, int Cm, int Cout, void* stream) {
  Args a{x, out, w1, b1, w2, b2, w3, b3, wd, bd, H, W, Cin, Cm, Cout, {}};
  if (!plan_for(dtype, H, W, Cin, Cm, Cout, wd != nullptr, &a.L))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch<bf16>(a, batch, s) : launch<float>(a, batch, s);
}

}  // extern "C"
