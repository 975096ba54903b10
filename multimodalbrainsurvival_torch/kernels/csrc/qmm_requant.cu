// int8 x int8 -> int32 product with a fused requant epilogue (K3), for
// Hopper (sm_90a), as an implicit-GEMM convolution over an NHWC input, with
// an optional residual epilogue; and the int8 stem's requant + max-pool pass.
//
// Replaces the TPU kernel `qmm_requant` / `_kern`
// (benchmarks/int8_pallas_probe.py:55,45; pallas_call at :80), which
// computes the live 1x1 stride-1 branch of the JAX package's int8 conv
// (`models/quantize.py::_qconv_q`, :197-211):
//
//     acc[m, n] = sum_k a[m, k] * w[n, k]                 (exact, int32)
//     y         = acc * scale[n] + bias[n]                (float32, no FMA)
//     y         = max(y, 0)                               (when relu)
//     out[m, n] = int8(clip(rint(y), -127, 127))          (half to even)
//
// The residual form (`qconv_residual_requant`) ends the same product with
// the JAX package's `_residual_relu_q` (models/quantize.py:214-221) on the
// int8 skip branch r of the output's shape:
//
//     t   = clip(rint(acc * scale[n] + bias[n]), -127, 127)   (relu off)
//     y   = t * s_t + r * s_r                                  (float32)
//     out = int8(clip(rint(max(y, 0) / s_out), -127, 127))
//
// with the three scales read from device memory (no host sync).
//
// PyTorch has no int8 convolution on the card, so this kernel also takes
// the 3x3 convolutions and the 1x1 stride-2 downsamples, which the JAX
// package leaves to XLA: row m of A is the output pixel (image, oh, ow) of
// an NHWC int8 input (batch, H, W, C), and column k = (r * kw + s) * C + c
// of that row is the input pixel (oh * stride - pad + r, ow * stride - pad
// + s), channel c, or zero outside the image. The weight is (N, kh, kw, C)
// int8, that is (N, K) with the same k order.
//
// Numerics: the int32 sum is exact (|acc| <= 127^2 * K, 74.3 M at K =
// 4,608). Every float operation is written as an _rn intrinsic, so nvcc
// cannot contract a multiply and an add into an FMA, and rounds with rintf
// (half to even, as jnp.round and torch.round do): the kernel is bit-
// identical to its plain version (kernels/qmm_requant.py).
//
// Bound on the card. At the main path's shapes (256 patches) the 1x1 convs
// of layers 1-2 are bound by memory (e.g. M = 802,816, K = 64, N = 256:
// 257 MB read once and written once, 0.077 ms at 3.35 TB/s, against 26.3
// GOP, 0.013 ms at 1,979 TOP/s) and those of layers 3-4 by operations. The
// int32 accumulator never leaves registers; only int8 reaches memory. The
// residual form reads r once more (the output's size) and saves the int8 t
// round trip and a float32 pass over both branches.
//
// Design. A block computes 128 x BN tiles of out with two warpgroups, each
// issuing wgmma m64nBNk32 s8 for its 64 rows; BN (64, 128 or 256) is the
// smallest of those that covers N, so a layer1-2 1x1 conv reads its A once.
// The block is persistent (one per SM, 254 registers a thread at BN = 256)
// and walks its tiles' k-tiles of 128 bytes as one sequence through a ring
// of 3-8 stages in shared memory (as many as fit), loading 2-6 k-tiles
// ahead: the short-K 1x1 convs (one k-tile a tile) are bound by
// memory, and the ring keeps the next tiles' loads in flight during a
// tile's products and epilogue. The weight tile comes by TMA (128-byte
// swizzle, zero past N and K; completion on an mbarrier), the A tile (the
// implicit-GEMM gather: 3x3 taps, stride, zero padding) by cp.async in
// 16-byte chunks written straight into the same swizzled K-major layout
// that the wgmma descriptors read. When C is not a multiple of 16 or an
// operand is not 16-byte aligned, both tiles are gathered byte by byte
// instead (no main-path conv does that). The epilogue rounds the
// accumulators into an int8 tile in shared memory, then writes it (and
// reads r, all of a thread's chunks at once) in coalesced 16-byte chunks.
//
// The stem pass (`stem_requant_pool`) replaces the int8 stem's eager
// bias + ReLU + requant + 3x3 stride-2 max-pool + NHWC permute: it reads the
// float32 stem conv output (NHWC) once and writes the int8 map once. The
// max of requantized values equals the requantized max (requant is
// monotone), so each output is one requant of its window's max.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128;      // rows per tile: two warpgroups of 64
constexpr int BK = 128;      // bytes of K per k-tile (one swizzle row)
constexpr int THREADS = 256;
constexpr int A_TILE = BM * BK;  // 16 KB
constexpr int A_CHUNKS = BM * (BK / 16) / THREADS;  // 16-byte chunks a thread
static_assert(A_CHUNKS * THREADS == BM * (BK / 16), "A loader mapping");

// Ring depth per N tile: as many stages as fit beside the output tile in
// the 227 KB a block may use. With 6 or more stages the products of a
// k-tile may still run while the next are issued (LAG 1) and loads run
// STAGES - 2 k-tiles ahead; with 3, the products are waited for at once and
// loads run 2 ahead.
template <int BN>
__host__ __device__ constexpr int stages() { return BN == 256 ? 3 : BN == 128 ? 6 : 8; }
template <int BN>
__host__ __device__ constexpr int lag() { return stages<BN>() >= 6 ? 1 : 0; }

enum Epilogue { kRequant = 0, kResidual = 1 };

struct Geometry {
  int batch, H, W, C;  // NHWC input
  int kh, kw, stride, pad;
  int Ho, Wo;
  int M, K, N;  // M = batch * Ho * Wo, K = kh * kw * C
};

struct Params {
  const signed char* x;
  const signed char* w;
  const float* scale;
  const float* bias;
  signed char* out;
  // residual form: r (M, N) int8 and the scales s_t, s_r, s_out (device)
  const signed char* r;
  const float* s_t;
  const float* s_r;
  const float* s_out;
  Geometry g;
  int relu;
};

__device__ __forceinline__ signed char requant(int acc, float s, float b,
                                               bool relu) {
  float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), s), b);
  if (relu) y = fmaxf(y, 0.f);
  y = fminf(fmaxf(rintf(y), -127.f), 127.f);
  return static_cast<signed char>(__float2int_rn(y));
}

// relu(t * s_t + r * s_r) requantized to s_out, as `_residual_relu_q`; a
// y <= 0 gives 0 without the division (0 / s_out rounds to 0)
__device__ __forceinline__ signed char residual(signed char t, signed char r,
                                                float st, float sr, float so) {
  const float y = __fadd_rn(__fmul_rn(static_cast<float>(t), st),
                            __fmul_rn(static_cast<float>(r), sr));
  if (!(y > 0.f)) return 0;
  const float q = fminf(rintf(__fdiv_rn(y, so)), 127.f);
  return static_cast<signed char>(__float2int_rn(q));
}

// One output row's gather state: the image's offset in x, the top-left
// input pixel of its window, and whether the row exists.
struct RowInfo {
  size_t img;
  int ih0, iw0;
  bool valid;
};

__device__ __forceinline__ RowInfo row_info(const Geometry& g, int m) {
  RowInfo r;
  r.valid = m < g.M;
  const int mm = r.valid ? m : 0;
  const int hw = g.Ho * g.Wo;
  const int n_img = mm / hw;
  const int rem = mm - n_img * hw;
  const int oh = rem / g.Wo;
  const int ow = rem - oh * g.Wo;
  r.img = (size_t)n_img * g.H * g.W * g.C;
  r.ih0 = oh * g.stride - g.pad;
  r.iw0 = ow * g.stride - g.pad;
  return r;
}

// Where column k of A lies: tap (kr, ks) of the window, channel c.
struct Tap {
  int k, kr, ks, c;
};

__device__ __forceinline__ Tap tap_of(const Geometry& g, int k) {
  Tap t;
  t.k = k;
  const int rs = k / g.C;
  t.c = k - rs * g.C;
  t.kr = rs / g.kw;
  t.ks = rs - t.kr * g.kw;
  return t;
}

// the tap of column k + d, d > 0, without a division
__device__ __forceinline__ void advance(const Geometry& g, Tap& t, int d) {
  t.k += d;
  t.c += d;
  while (t.c >= g.C) {
    t.c -= g.C;
    if (++t.ks == g.kw) {
      t.ks = 0;
      ++t.kr;
    }
  }
}

// Offset in x of A[row, k], or -1 for a zero (padding, or past M or K).
__device__ __forceinline__ long long a_offset(const Geometry& g,
                                              const RowInfo& r, const Tap& t) {
  if (!r.valid || t.k >= g.K) return -1;
  const int ih = r.ih0 + t.kr;
  const int iw = r.iw0 + t.ks;
  if (ih < 0 || ih >= g.H || iw < 0 || iw >= g.W) return -1;
  return (long long)(r.img + ((size_t)ih * g.W + iw) * g.C + t.c);
}

template <int BN>
struct Wgmma;
template <> struct Wgmma<64> {
  static __device__ __forceinline__ void run(int (&d)[32], uint64_t a, uint64_t b) {
    wgmma_s8_ss_n64(d, a, b, 1);
  }
};
template <> struct Wgmma<128> {
  static __device__ __forceinline__ void run(int (&d)[64], uint64_t a, uint64_t b) {
    wgmma_s8_ss_n128(d, a, b, 1);
  }
};
template <> struct Wgmma<256> {
  static __device__ __forceinline__ void run(int (&d)[128], uint64_t a, uint64_t b) {
    wgmma_s8_ss_n256(d, a, b, 1);
  }
};

template <int BN>
__host__ __device__ constexpr int ldo() { return BN + 16; }  // output tile row, bytes

template <int BN>
constexpr int smem_bytes() {
  return 1024 /* alignment slack */ + stages<BN>() * (A_TILE + BN * BK) +
         BM * ldo<BN>() + 8 * BN /* epilogue scales */ +
         stages<BN>() * 8 /* mbarriers */;
}

// A persistent block walks over the (BM x BN) output tiles blockIdx.x,
// blockIdx.x + gridDim.x, ...; its k-tiles of all its tiles form one
// sequence through the ring, so the loads of the next tile run during this
// tile's last products and epilogue. VEC: C % 16 == 0 and x, w 16-byte
// aligned: A by cp.async, the weight by TMA. Otherwise both are gathered
// byte by byte.
template <int BN, bool VEC, int EPI>
__global__ void __launch_bounds__(THREADS, 1)
    qconv_requant_kernel(const __grid_constant__ CUtensorMap wmap,
                         const Params p) {
  constexpr int S = stages<BN>();
  constexpr int LAG = lag<BN>();
  constexpr int AHEAD = S - 1 - LAG;
  constexpr int LDO = ldo<BN>();
  extern __shared__ unsigned char smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: align the tiles to it
  unsigned char* const smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* const As = smem;                   // S x A_TILE
  unsigned char* const Bs = smem + S * A_TILE;      // S x BN x BK
  signed char* const tile = reinterpret_cast<signed char*>(Bs + S * BN * BK);
  // the tile's columns n0 + 2 i, n0 + 2 i + 1: {scale, scale, bias, bias}
  float4* const sb = reinterpret_cast<float4*>(tile + BM * LDO);
  uint64_t* const full = reinterpret_cast<uint64_t*>(sb + BN / 2);

  const Geometry& g = p.g;
  const int tid = threadIdx.x;
  const int wg = tid / 128;  // the warpgroup: rows 64 wg .. 64 wg + 63
  const int nk = (g.K + BK - 1) / BK;
  const int tiles_n = (g.N + BN - 1) / BN;
  const int tiles = ((g.M + BM - 1) / BM) * tiles_n;
  const int my_tiles = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) / gridDim.x;
  const int steps = my_tiles * nk;

  if (VEC && tid == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) mbar_init(&full[s], 1);
    fence_mbar_init();
  }

  // loader: chunk q = tid + i * THREADS is row q / 8, bytes 16 (q % 8) ..
  // of the k-tile; the chunk column is the same for all i. Steps are
  // loaded in order, so the rows are computed once per tile and the tap
  // advances by BK from one k-tile to the next.
  const int kc = (tid % (BK / 16)) * 16;
  RowInfo rows[A_CHUNKS];
  Tap tap{};
  // step `it` of this block: k-tile it % nk of its tile it / nk
  auto load = [&](int it) {
    if (it >= steps) return;
    const int t = blockIdx.x + (it / nk) * gridDim.x;
    const int m0 = (t / tiles_n) * BM, n0 = (t % tiles_n) * BN;
    const int kt = it % nk;
    const int k0 = kt * BK;
    const int s = it % S;
    unsigned char* const a = As + s * A_TILE;
    unsigned char* const b = Bs + s * BN * BK;
    if (kt == 0) {
#pragma unroll
      for (int i = 0; i < A_CHUNKS; ++i)
        rows[i] = row_info(g, m0 + (tid + i * THREADS) / (BK / 16));
      tap = tap_of(g, kc);
    } else {
      advance(g, tap, BK);
    }
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int row = (tid + i * THREADS) / (BK / 16);
      unsigned char* dst = a + sw128_offset(row, kc);
      if (VEC) {
        const long long off = a_offset(g, rows[i], tap);
        cp_async16(dst, p.x + (off < 0 ? 0 : off), off >= 0);
      } else {
        Tap tj = tap;
#pragma unroll 1
        for (int j = 0; j < 16; ++j) {
          const long long off = a_offset(g, rows[i], tj);
          dst[j] = off < 0 ? 0 : p.x[off];
          advance(g, tj, 1);
        }
      }
    }
    if (VEC) {
      if (tid == 0) {
        mbar_arrive_expect_tx(&full[s], BN * BK);
        tma_load_2d(b, &wmap, &full[s], k0, n0);
      }
    } else {
      for (int q = tid; q < BN * BK; q += THREADS) {
        const int row = q / BK, kb = q % BK;
        const int n = n0 + row, k = k0 + kb;
        b[sw128_offset(row, kb)] =
            (n < g.N && k < g.K) ? p.w[(size_t)n * g.K + k] : 0;
      }
    }
  };

  float st = 0.f, sr = 0.f, so = 1.f;
  if (EPI == kResidual) {
    st = *p.s_t;
    sr = *p.s_r;
    so = *p.s_out;
  }
  const bool vec_out = g.N % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(p.out) % 16 == 0 &&
                       (EPI != kResidual ||
                        reinterpret_cast<uintptr_t>(p.r) % 16 == 0);
  const bool rl = EPI == kRequant && p.relu != 0;
  const int lane = tid % 32;
  // accumulator i of a thread is row 16 (warp % 4) + lane / 4 + 8 ((i / 2)
  // % 2) of its warpgroup's 64, column 8 (i / 4) + 2 (lane % 4) + i % 2
  const int row0 = wg * 64 + ((tid % 128) / 32) * 16 + lane / 4;

  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  __syncthreads();  // barriers initialised
#pragma unroll
  for (int it = 0; it < AHEAD; ++it) {
    load(it);
    cp_async_commit();
  }
  for (int it = 0; it < steps; ++it) {
    cp_async_wait<AHEAD - 1>();  // this thread's part of step it landed
    fence_proxy_async();
    // every thread's part landed; every warpgroup finished the products of
    // step it - 1 - LAG, whose stage the next load reuses, and the last
    // epilogue's reads of the output tile
    __syncthreads();
    load(it + AHEAD);
    cp_async_commit();
    const int s = it % S;
    const int kt = it % nk;
    if (VEC) mbar_wait(&full[s], (it / S) & 1);
    const uint64_t da = desc_sw128(As + s * A_TILE + wg * 64 * BK);
    const uint64_t db = desc_sw128(Bs + s * BN * BK);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks)
      Wgmma<BN>::run(acc, desc_add(da, 32 * ks), desc_add(db, 32 * ks));
    wgmma_commit();
    if (kt != nk - 1) {
      wgmma_wait<LAG>();
      continue;
    }
    wgmma_wait<0>();
    fence_regs(acc);

    // the tile's epilogue: its columns' scales and biases to shared memory
    // (the last epilogue's reads of them are behind this step's barrier) ...
    const int t = blockIdx.x + (it / nk) * gridDim.x;
    const int m0 = (t / tiles_n) * BM, n0 = (t % tiles_n) * BN;
    if (tid < BN / 2) {
      const int n = n0 + 2 * tid;
      sb[tid] = make_float4(n < g.N ? p.scale[n] : 0.f,
                            n + 1 < g.N ? p.scale[n + 1] : 0.f,
                            n < g.N ? p.bias[n] : 0.f,
                            n + 1 < g.N ? p.bias[n + 1] : 0.f);
    }
    __syncthreads();
    // ... then requant into the (BM, BN) int8 tile ...
#pragma unroll
    for (int i = 0; i < BN / 2; i += 2) {
      const int col = 8 * (i / 4) + 2 * (lane % 4);
      const int row = row0 + 8 * ((i / 2) % 2);
      const float4 sbv = sb[col / 2];
      char2 v;
      v.x = requant(acc[i], sbv.x, sbv.z, rl);
      v.y = requant(acc[i + 1], sbv.y, sbv.w, rl);
      *reinterpret_cast<char2*>(tile + row * LDO + col) = v;
      acc[i] = acc[i + 1] = 0;  // the next tile's sums start here
    }
    __syncthreads();
    // ... then to out, 16 bytes a thread where the rows allow, the skip
    // branch's chunks all loaded before any is used
    if (vec_out) {
      constexpr int CPR = BN / 16;  // chunks per row
      constexpr int CPT = BM * CPR / THREADS;  // chunks per thread
      int4 rv[CPT];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int q = tid + j * THREADS;
        const int m = m0 + q / CPR, n = n0 + (q % CPR) * 16;
        if (EPI == kResidual && m < g.M && n < g.N)
          rv[j] = __ldg(reinterpret_cast<const int4*>(p.r + (size_t)m * g.N + n));
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int q = tid + j * THREADS;
        const int row = q / CPR, col = (q % CPR) * 16;
        const int m = m0 + row, n = n0 + col;
        if (m >= g.M || n >= g.N) continue;
        int4 v = *reinterpret_cast<const int4*>(tile + row * LDO + col);
        if (EPI == kResidual) {
          signed char* tv = reinterpret_cast<signed char*>(&v);
          const signed char* r = reinterpret_cast<const signed char*>(&rv[j]);
#pragma unroll
          for (int e = 0; e < 16; ++e) tv[e] = residual(tv[e], r[e], st, sr, so);
        }
        *reinterpret_cast<int4*>(p.out + (size_t)m * g.N + n) = v;
      }
    } else {
      for (int q = tid; q < BM * BN; q += THREADS) {
        const int row = q / BN, col = q % BN;
        const int m = m0 + row, n = n0 + col;
        if (m >= g.M || n >= g.N) continue;
        const size_t o = (size_t)m * g.N + n;
        signed char v = tile[row * LDO + col];
        if (EPI == kResidual) v = residual(v, p.r[o], st, sr, so);
        p.out[o] = v;
      }
    }
  }
  cp_async_wait<0>();
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

template <int BN, bool VEC, int EPI>
int launch_bn(const CUtensorMap& map, const Params& p, cudaStream_t s) {
  auto kernel = qconv_requant_kernel<BN, VEC, EPI>;
  constexpr int bytes = smem_bytes<BN>();
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  const long long tiles =
      (long long)((p.g.M + BM - 1) / BM) * ((p.g.N + BN - 1) / BN);
  const int grid = (int)(tiles < sm_count() ? tiles : sm_count());
  kernel<<<grid, THREADS, bytes, s>>>(map, p);
  return cudaGetLastError();
}

template <bool VEC, int EPI>
int launch_vec(const CUtensorMap& map, const Params& p, int bn,
               cudaStream_t s) {
  if (bn == 64) return launch_bn<64, VEC, EPI>(map, p, s);
  if (bn == 128) return launch_bn<128, VEC, EPI>(map, p, s);
  return launch_bn<256, VEC, EPI>(map, p, s);
}

// The N tile: the smallest of 64, 128, 256 that covers N, else 256.
int tile_n(int N) { return N <= 64 ? 64 : N <= 128 ? 128 : 256; }

int launch(Params& p, int epi, cudaStream_t s) {
  Geometry& g = p.g;
  g.M = g.batch * g.Ho * g.Wo;
  g.K = g.kh * g.kw * g.C;
  if (g.M <= 0 || g.N <= 0 || g.K <= 0) return cudaErrorInvalidValue;
  const bool vec = g.C % 16 == 0 && reinterpret_cast<uintptr_t>(p.x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(p.w) % 16 == 0;
  const int bn = tile_n(g.N);
  CUtensorMap map{};
  if (vec) {
    // the (N, K) weight, K innermost; boxes of BK bytes x bn rows
    const cuuint64_t dims[2] = {(cuuint64_t)g.K, (cuuint64_t)g.N};
    const cuuint64_t strides[1] = {(cuuint64_t)g.K};
    const cuuint32_t box[2] = {BK, (cuuint32_t)bn};
    if (!hopper_host::encode_sw128(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                                   p.w, dims, strides, box))
      return cudaErrorInvalidValue;
  }
  if (epi == kResidual)
    return vec ? launch_vec<true, kResidual>(map, p, bn, s)
               : launch_vec<false, kResidual>(map, p, bn, s);
  return vec ? launch_vec<true, kRequant>(map, p, bn, s)
             : launch_vec<false, kRequant>(map, p, bn, s);
}

// --- the stem pass ------------------------------------------------------------

// y: (batch, H, W, C) float32 NHWC; one thread per output pixel and V
// channels (V = 4: 16-byte loads, 4-byte stores); 32-bit indices (the
// wrapper keeps y under 2^31 elements)
template <int V>
__global__ void stem_requant_pool_kernel(const float* __restrict__ y,
                                         const float* __restrict__ bias,
                                         const float* __restrict__ s_stem,
                                         signed char* __restrict__ out,
                                         int batch, int H, int W, int C,
                                         int Ho, int Wo) {
  const int groups = C / V;
  const int total = batch * Ho * Wo * groups;
  const float s = *s_stem;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    const int c = (i % groups) * V;
    int pix = i / groups;
    const int ow = pix % Wo;
    pix /= Wo;
    const int oh = pix % Ho;
    const int img = pix / Ho;
    float b[V], m[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      b[e] = bias[c + e];
      // every window holds a real pixel (padding 1 < kernel 3), and the
      // values are >= 0 after relu: 0 is a safe start
      m[e] = 0.f;
    }
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const int ih = 2 * oh - 1 + dy;
      if (ih < 0 || ih >= H) continue;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int iw = 2 * ow - 1 + dx;
        if (iw < 0 || iw >= W) continue;
        const float* src = y + ((img * H + ih) * W + iw) * C + c;
        float v[V];
        if (V == 4) {
          const float4 q = __ldg(reinterpret_cast<const float4*>(src));
          v[0] = q.x;
          v[1] = q.y;
          v[2] = q.z;
          v[3] = q.w;
        } else {
          v[0] = __ldg(src);
        }
#pragma unroll
        for (int e = 0; e < V; ++e) m[e] = fmaxf(m[e], __fadd_rn(v[e], b[e]));
      }
    }
    signed char q[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float r = fminf(fmaxf(rintf(__fdiv_rn(m[e], s)), -127.f), 127.f);
      q[e] = static_cast<signed char>(__float2int_rn(r));
    }
    signed char* dst = out + (size_t)i * V;
    if (V == 4) {
      char4 o;
      o.x = q[0];
      o.y = q[1];
      o.z = q[2];
      o.w = q[3];
      *reinterpret_cast<char4*>(dst) = o;
    } else {
      dst[0] = q[0];
    }
  }
}

}  // namespace

extern "C" {

// x: (batch, H, W, C) int8 NHWC; w: (N, kh, kw, C) int8; scale, bias: (N,)
// float32; out: (batch, Ho, Wo, N) int8, all contiguous on the device.
// Returns the CUDA error code of the launch (0 = cudaSuccess); nothing is
// synchronised.
int qconv_requant_s8(const signed char* x, const signed char* w,
                     const float* scale, const float* bias, signed char* out,
                     int batch, int H, int W, int C, int kh, int kw,
                     int stride, int pad, int Ho, int Wo, int N, int relu,
                     void* stream) {
  Params p{x, w, scale, bias, out, nullptr, nullptr, nullptr, nullptr,
           Geometry{batch, H, W, C, kh, kw, stride, pad, Ho, Wo, 0, 0, N},
           relu};
  return launch(p, kRequant, static_cast<cudaStream_t>(stream));
}

// The residual form: as qconv_requant_s8 with relu off, then relu(t * s_t +
// r * s_r) requantized to s_out; r: (batch, Ho, Wo, N) int8; s_t, s_r,
// s_out: one float32 each, on the device.
int qconv_residual_requant_s8(const signed char* x, const signed char* w,
                              const float* scale, const float* bias,
                              const signed char* r, const float* s_t,
                              const float* s_r, const float* s_out,
                              signed char* out, int batch, int H, int W, int C,
                              int kh, int kw, int stride, int pad, int Ho,
                              int Wo, int N, void* stream) {
  Params p{x, w, scale, bias, out, r, s_t, s_r, s_out,
           Geometry{batch, H, W, C, kh, kw, stride, pad, Ho, Wo, 0, 0, N}, 0};
  return launch(p, kResidual, static_cast<cudaStream_t>(stream));
}

// The stem pass: y (batch, H, W, C) float32 NHWC, bias (C,) float32,
// s_stem one float32 on the device -> out (batch, Ho, Wo, C) int8 NHWC,
// Ho = (H - 1) / 2 + 1 (3x3 stride-2 max-pool, padding 1).
int stem_requant_pool_s8(const float* y, const float* bias,
                         const float* s_stem, signed char* out, int batch,
                         int H, int W, int C, void* stream) {
  if (batch <= 0 || H <= 0 || W <= 0 || C <= 0) return cudaErrorInvalidValue;
  const int Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1;
  if ((long long)batch * H * W * C >= (1LL << 31)) return cudaErrorInvalidValue;
  const bool vec = C % 4 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const long long total = (long long)batch * Ho * Wo * (vec ? C / 4 : C);
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  const int grid = (int)(blocks < 132LL * 16 ? blocks : 132LL * 16);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec)
    stem_requant_pool_kernel<4><<<grid, threads, 0, st>>>(
        y, bias, s_stem, out, batch, H, W, C, Ho, Wo);
  else
    stem_requant_pool_kernel<1><<<grid, threads, 0, st>>>(
        y, bias, s_stem, out, batch, H, W, C, Ho, Wo);
  return cudaGetLastError();
}

}  // extern "C"
