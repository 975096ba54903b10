// Seeded dropout fused into a float32 matrix product (K2a), and the same
// dropout applied alone (K2b), for Hopper (sm_90a).
//
// Replaces the TPU kernels of
// multimodalbrainsurvival_tpu/ops/pallas/dropout_matmul.py (deleted in commit
// 4fbc57a): `_forward` / `_dropout_matmul_kernel` (pallas_call at :160) and
// `apply_seeded_dropout` / `_apply_dropout_kernel` (pallas_call at :135).
//
// K2a:  out[m, n] = sum_k (M ⊙ x)[m, k] * s * w[n, k]
//       x (M, K) row-major, w (N, K) row-major (the nn.Linear layout, read
//       directly: no transposed copy of the 209 MB RNA weight per step),
//       out (M, N) float32.
// K2b:  out[m, k] = M[m, k] ? x[m, k] * s : 0          (M, K) → (M, K)
//
// The keep-mask M is a pure function of (seed, row, col): a murmur3-style
// finalizer of gidx = row * 65536 + col (mod 2^32) xor seed * 0x9E3779B1,
// kept iff the hash >= threshold = min(int(p * 2^32), 2^32 - 1); s is
// float32(1 / (1 - p)). It is a copy of `_mask_block` (:52-71) and one
// device function, `keep`, serves both kernels, so the forward's mask and
// the mask the backward regenerates cannot drift apart. Columns alias at
// K > 65536; the wrapper refuses such widths.
//
// What bounds it on this card: at the RNA encoder's first layer (M = 256,
// K = 12,778, N = 4,096) the product is 26.8 GFLOP against 227 MB of
// traffic, so operations bound it: 0.40 ms at the 67 TFLOP/s float32 FMA
// rate (the port keeps float32 products out of TF32, as the reference
// computes them in full float32). This first kernel is a plain shared-memory
// FMA tiling: 64 x 64 output tiles, 256 threads each holding a 4 x 4 block
// of sums, depth steps of 32 staged through registers into a second shared
// buffer while the first is consumed. The mask is hashed as each x tile is
// loaded, once per output column tile, which costs integer operations but
// no memory traffic. K2b is one pass over memory, bound by bytes.
//
// Both functions launch on the caller's stream, allocate nothing, and
// return cudaGetLastError() of the launch.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int A_LOADS = BM * BK / THREADS;      // 8
constexpr int B_LOADS = BN * BK / THREADS;      // 8
constexpr int PAD = 4;  // keeps rows 16-byte aligned for float4 reads

struct Mask {
  uint32_t seed_mix;   // seed * 0x9E3779B1 (mod 2^32)
  uint32_t threshold;  // keep iff hash >= threshold
  float scale;         // float32(1 / (1 - p))
  int on;              // 0: plain product, no mask (p == 0)
};

__device__ __forceinline__ bool keep(uint32_t row, uint32_t col, const Mask& mask) {
  uint32_t h = (row * 65536u + col) ^ mask.seed_mix;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h >= mask.threshold;
}

__global__ void __launch_bounds__(THREADS)
dropout_matmul_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      float* __restrict__ out, int M, int N, int K, Mask mask) {
  __shared__ __align__(16) float As[2][BK][BM + PAD];  // As[k][m]
  __shared__ __align__(16) float Bs[2][BK][BN + PAD];  // Bs[k][n]
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int ty = tid / (BN / TN);
  const int tx = tid % (BN / TN);

  float ra[A_LOADS];
  float rb[B_LOADS];
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // a warp reads 32 consecutive k of one row of x and of w: coalesced
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / BK, c = idx % BK;
      const int row = m0 + r, col = k0 + c;
      float v = 0.f;
      if (row < M && col < K) {
        v = x[static_cast<size_t>(row) * K + col];
        if (mask.on) v = keep(row, col, mask) ? __fmul_rn(v, mask.scale) : 0.f;
      }
      ra[i] = v;
    }
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / BK, c = idx % BK;
      const int row = n0 + r, col = k0 + c;
      rb[i] = (row < N && col < K) ? w[static_cast<size_t>(row) * K + col] : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      const int idx = tid + i * THREADS;
      As[buf][idx % BK][idx / BK] = ra[i];
    }
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i) {
      const int idx = tid + i * THREADS;
      Bs[buf][idx % BK][idx / BK] = rb[i];
    }
  };

  const int nk = (K + BK - 1) / BK;
  load(0);
  store(0);
  __syncthreads();
  for (int t = 0; t < nk; ++t) {
    const int buf = t & 1;
    if (t + 1 < nk) load((t + 1) * BK);  // in flight while this tile is used
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[buf][kk][ty * TM]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * TN]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    // buf ^ 1 was last read before the previous barrier: free to refill
    if (t + 1 < nk) store(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty * TM + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx * TN + j;
      if (col < N) out[static_cast<size_t>(row) * N + col] = acc[i][j];
    }
  }
}

__global__ void seeded_dropout_kernel(const float* __restrict__ x,
                                      float* __restrict__ out, long long total,
                                      int K, Mask mask) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const uint32_t row = static_cast<uint32_t>(i / K);
    const uint32_t col = static_cast<uint32_t>(i % K);
    out[i] = keep(row, col, mask) ? __fmul_rn(x[i], mask.scale) : 0.f;
  }
}

Mask make_mask(uint32_t seed, uint32_t threshold, float scale, int on) {
  return Mask{seed * 0x9E3779B1u, threshold, scale, on};
}

}  // namespace

extern "C" int dropout_matmul_f32(const float* x, const float* w, float* out,
                                  int M, int N, int K, uint32_t seed,
                                  uint32_t threshold, float scale, int apply_mask,
                                  void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  dropout_matmul_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w, out, M, N, K, make_mask(seed, threshold, scale, apply_mask));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int seeded_dropout_f32(const float* x, float* out, long long total,
                                  int K, uint32_t seed, uint32_t threshold,
                                  float scale, void* stream) {
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132LL * 32) blocks = 132LL * 32;  // grid-stride beyond this
  if (blocks < 1) blocks = 1;
  seeded_dropout_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      x, out, total, K, make_mask(seed, threshold, scale, 1));
  return static_cast<int>(cudaGetLastError());
}
