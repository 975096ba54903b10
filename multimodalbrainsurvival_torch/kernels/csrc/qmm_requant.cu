// int8 x int8 -> int32 product with a fused requant epilogue (K3), for
// Hopper (sm_90a), as an implicit-GEMM convolution over an NHWC input.
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
// PyTorch has no int8 convolution on the card, so this kernel also takes
// the 3x3 convolutions and the 1x1 stride-2 downsamples, which the JAX
// package leaves to XLA: row m of A is the output pixel (image, oh, ow) of
// an NHWC int8 input (batch, H, W, C), and column k = (r * kw + s) * C + c
// of that row is the input pixel (oh * stride - pad + r, ow * stride - pad
// + s), channel c, or zero outside the image. The weight is (N, kh, kw, C)
// int8, that is (N, K) with the same k order. A 1x1 stride-1 conv is the
// plain GEMM: A is the NHWC activation itself.
//
// Numerics: the int32 sum is exact (|acc| <= 127^2 * K, 74.3 M at K =
// 4,608). The epilogue is written as __fadd_rn(__fmul_rn(float(acc), s), b)
// so that nvcc cannot contract it into an FMA, and rounds with rintf (half
// to even, as jnp.round and torch.round do), so the kernel is bit-identical
// to its plain version (kernels/qmm_requant.py::qmm_requant_plain).
//
// Bound on the card. At the main path's shapes (256 patches) the 1x1 convs
// of layers 1-2 are bound by memory (e.g. M = 802,816, K = 64, N = 256:
// 257 MB read once and written once, 0.077 ms at 3.35 TB/s, against 26.3
// GOP, 0.013 ms at 1,979 TOP/s) and those of layers 3-4 by operations. The
// int32 accumulator never leaves registers; only int8 reaches memory.
//
// Design (a first kernel: right and simple; wgmma, TMA and a persistent
// layout are later work). A block computes a BM x BN tile of out with 8
// warps (2 along M, 4 along N), each warp a 64 x 32 tile of
// mma.sync.m16n8k32 s8 products. K is walked in BK = 64 byte stages, two
// stages in shared memory: when C is a multiple of 16 (every conv of the
// main path but the stem, which is not int8) each thread gathers 16-byte
// chunks of A and W with cp.async, zero-filled outside the image and past
// M, N and K; otherwise it gathers byte by byte. Rows in shared memory are
// padded to 80 bytes, so the fragment loads of a warp hit 32 different
// banks. Ragged M, N and K are masked; nothing is padded in memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 64;  // bytes of K per stage
constexpr int WARPS_M = 2;
constexpr int WARPS_N = 4;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;  // 256
constexpr int WM = BM / WARPS_M;                 // 64 rows per warp
constexpr int WN = BN / WARPS_N;                 // 32 columns per warp
constexpr int MT = WM / 16;                      // m16 tiles per warp
constexpr int NT = WN / 8;                       // n8 tiles per warp
constexpr int LDS = BK + 16;                     // padded row, bytes
constexpr int CHUNKS_PER_ROW = BK / 16;
constexpr int A_CHUNKS = BM * CHUNKS_PER_ROW / THREADS;  // per thread
constexpr int B_CHUNKS = BN * CHUNKS_PER_ROW / THREADS;
constexpr int STAGES = 2;
static_assert(A_CHUNKS * THREADS == BM * CHUNKS_PER_ROW, "A loader mapping");
static_assert(B_CHUNKS * THREADS == BN * CHUNKS_PER_ROW, "B loader mapping");
static_assert(LDS % 16 == 0, "cp.async needs 16-byte aligned rows");

struct Geometry {
  int batch, H, W, C;  // NHWC input
  int kh, kw, stride, pad;
  int Ho, Wo;
  int M, K, N;  // M = batch * Ho * Wo, K = kh * kw * C
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

__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ signed char requant(int acc, float s, float b,
                                               bool relu) {
  float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), s), b);
  if (relu) y = fmaxf(y, 0.f);
  y = fminf(fmaxf(rintf(y), -127.f), 127.f);
  return static_cast<signed char>(__float2int_rn(y));
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

// Offset in x of A[row, k], or -1 for a zero (padding, or past M or K).
__device__ __forceinline__ long long a_offset(const Geometry& g,
                                              const RowInfo& r, int k) {
  if (!r.valid || k >= g.K) return -1;
  const int rs = k / g.C;
  const int c = k - rs * g.C;
  const int kr = rs / g.kw;
  const int ks = rs - kr * g.kw;
  const int ih = r.ih0 + kr;
  const int iw = r.iw0 + ks;
  if (ih < 0 || ih >= g.H || iw < 0 || iw >= g.W) return -1;
  return (long long)(r.img + ((size_t)ih * g.W + iw) * g.C + c);
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
qconv_requant_kernel(const signed char* __restrict__ x,
                     const signed char* __restrict__ w,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias,
                     signed char* __restrict__ out, Geometry g, int relu) {
  __shared__ __align__(16) signed char As[STAGES][BM][LDS];
  __shared__ __align__(16) signed char Bs[STAGES][BN][LDS];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int warp_m = warp / WARPS_N;
  const int warp_n = warp % WARPS_N;
  const int grp = lane / 4;  // groupID of the mma fragment layouts
  const int tig = lane % 4;  // thread in group
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // loader: chunk q = tid + i * THREADS covers row q / CHUNKS_PER_ROW,
  // bytes kc .. kc + 15 of the stage; kc is the same for all i
  const int kc = (tid % CHUNKS_PER_ROW) * 16;
  RowInfo arow[A_CHUNKS];
#pragma unroll
  for (int i = 0; i < A_CHUNKS; ++i)
    arow[i] = row_info(g, m0 + (tid + i * THREADS) / CHUNKS_PER_ROW);

  auto load_stage = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      signed char* dst = &As[stage][(tid + i * THREADS) / CHUNKS_PER_ROW][kc];
      if (VEC) {
        const long long off = a_offset(g, arow[i], k0 + kc);
        cp_async16(dst, x + (off < 0 ? 0 : off), off >= 0);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const long long off = a_offset(g, arow[i], k0 + kc + j);
          dst[j] = off < 0 ? 0 : x[off];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < B_CHUNKS; ++i) {
      const int row = (tid + i * THREADS) / CHUNKS_PER_ROW;
      const int n = n0 + row;
      signed char* dst = &Bs[stage][row][kc];
      if (VEC) {
        const bool full = n < g.N && k0 + kc < g.K;
        cp_async16(dst, w + (full ? (size_t)n * g.K + k0 + kc : 0), full);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int k = k0 + kc + j;
          dst[j] = (n < g.N && k < g.K) ? w[(size_t)n * g.K + k] : 0;
        }
      }
    }
  };

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int n_stages = (g.K + BK - 1) / BK;
  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < n_stages; ++kt) {
    // the other buffer was last read in step kt - 1, behind its barrier
    if (kt + 1 < n_stages) load_stage((kt + 1) % STAGES, (kt + 1) * BK);
    cp_async_commit();  // possibly empty: keeps the group count uniform
    cp_async_wait_one();  // stage kt has landed
    __syncthreads();
    const int st = kt % STAGES;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      unsigned a[MT][4], b[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = warp_m * WM + i * 16 + grp;
        a[i][0] = *reinterpret_cast<const unsigned*>(&As[st][r][kk + tig * 4]);
        a[i][1] =
            *reinterpret_cast<const unsigned*>(&As[st][r + 8][kk + tig * 4]);
        a[i][2] =
            *reinterpret_cast<const unsigned*>(&As[st][r][kk + 16 + tig * 4]);
        a[i][3] = *reinterpret_cast<const unsigned*>(
            &As[st][r + 8][kk + 16 + tig * 4]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = warp_n * WN + j * 8 + grp;
        b[j][0] = *reinterpret_cast<const unsigned*>(&Bs[st][c][kk + tig * 4]);
        b[j][1] =
            *reinterpret_cast<const unsigned*>(&Bs[st][c][kk + 16 + tig * 4]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

  // epilogue: acc[i][j][0..1] are row grp, columns 2 * tig + {0, 1} of the
  // m16n8 tile; acc[i][j][2..3] the same columns of row grp + 8
  const bool rl = relu != 0;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = n0 + warp_n * WN + j * 8 + tig * 2;
    const float s0 = n < g.N ? scale[n] : 0.f;
    const float b0 = n < g.N ? bias[n] : 0.f;
    const float s1 = n + 1 < g.N ? scale[n + 1] : 0.f;
    const float b1 = n + 1 < g.N ? bias[n + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + warp_m * WM + i * 16 + grp + h * 8;
        if (m >= g.M) continue;
        signed char* o = out + (size_t)m * g.N + n;
        const signed char q0 = requant(acc[i][j][2 * h], s0, b0, rl);
        const signed char q1 = requant(acc[i][j][2 * h + 1], s1, b1, rl);
        if (n + 1 < g.N && (g.N % 2) == 0) {
          char2 v;
          v.x = q0;
          v.y = q1;
          *reinterpret_cast<char2*>(o) = v;
        } else {
          if (n < g.N) o[0] = q0;
          if (n + 1 < g.N) o[1] = q1;
        }
      }
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
  Geometry g{batch, H, W, C, kh, kw, stride, pad, Ho, Wo,
             batch * Ho * Wo, kh * kw * C, N};
  if (g.M <= 0 || g.N <= 0 || g.K <= 0) return cudaErrorInvalidValue;
  const bool vec = C % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const dim3 grid((g.M + BM - 1) / BM, (g.N + BN - 1) / BN);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    qconv_requant_kernel<true>
        <<<grid, THREADS, 0, s>>>(x, w, scale, bias, out, g, relu);
  else
    qconv_requant_kernel<false>
        <<<grid, THREADS, 0, s>>>(x, w, scale, bias, out, g, relu);
  return cudaGetLastError();
}

}  // extern "C"
