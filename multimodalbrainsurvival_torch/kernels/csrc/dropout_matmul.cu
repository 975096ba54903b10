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
// traffic (mostly the 209 MB weight, read once). In float32 FMA that is
// bound by operations: 0.40 ms at 67 TFLOP/s. The first version of this
// kernel (64 x 64 FMA tiles, 4 x 4 sums a thread, loads staged through
// registers, the mask hashed 64 times over x; 128 blocks of 4,096 depth at
// the second layer, one per SM) took 1.85 / 0.60 ms at the two layers
// (PERF.md).
//
// Design. K2a is splitk_tn.cuh's product with x as A and the weight as B,
// both K-major as stored:
//   - 3xTF32 on the tensor cores (hi·hi + hi·lo + lo·hi, each value split
//     once in shared memory; 3 x 26.8 GFLOP at 495 TFLOP/s is 0.163 ms),
//     float32 to within 1e-4 of the float32 FMA product at both layers, each
//     k-tile's sum added into registers in IEEE float32;
//   - 128 x 128 output tiles, so each x value is masked once per 128
//     columns (32 times over dense_0's x), and K split over a cluster of
//     2 (dense_0, 64 tiles: 128 blocks) or 3 (dense_1, 32 tiles: 96
//     blocks) blocks, one wave each; the cluster adds its float32 tiles in
//     a fixed order through distributed shared memory;
//   - the mask is hashed as each x k-tile lies in shared memory, with
//     global (row, col) indices, just before the hi/lo split: never a pass
//     of its own, and k-tile i + 1's hashing runs while the tensor cores
//     work on k-tile i;
//   - loads by TMA where rows are 16-byte aligned (K % 4 == 0: dense_1),
//     else by cp.async in 8-byte (K even: dense_0's 51,112-byte rows) or
//     4-byte pieces; the route follows from K and the base addresses alone.
// K2b is one pass over memory, bound by bytes.
//
// Both functions launch on the caller's stream, allocate nothing, and
// return the CUDA error code of the launch.

#include <cstdint>

#include <cuda_runtime.h>

#include "splitk_tn.cuh"

namespace {

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

__device__ __forceinline__ float dropped(float v, uint32_t row, uint32_t col,
                                         const Mask& mask) {
  return keep(row, col, mask) ? __fmul_rn(v, mask.scale) : 0.f;
}

// K2a's parts of the product: the mask on x's k-tiles, and the store of C.
struct Dropout {
  struct Params {
    float* out;  // (M, N)
    Mask mask;
  };
  struct Cols {};
  static __device__ __forceinline__ Cols cols(const Params&, const splitk::Problem&,
                                              int, int) {
    return Cols{};
  }
  static __device__ __forceinline__ void transform(const Params& ep, float4& v,
                                                   int m, int k) {
    if (!ep.mask.on) return;
    v.x = dropped(v.x, m, k, ep.mask);
    v.y = dropped(v.y, m, k + 1, ep.mask);
    v.z = dropped(v.z, m, k + 2, ep.mask);
    v.w = dropped(v.w, m, k + 3, ep.mask);
  }
  static __device__ __forceinline__ void row(const Params& ep,
                                             const splitk::Problem& p,
                                             const Cols&, int m, int n_tile,
                                             int lane, float4 c) {
    const int n = n_tile * splitk::BN + 4 * lane;
    if (m >= p.M || n >= p.N) return;
    float* const dst = ep.out + (size_t)m * p.N + n;
    if (p.N % 4 == 0) {  // rows 16-byte aligned (the output is fresh)
      *reinterpret_cast<float4*>(dst) = c;
      return;
    }
    const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (n + e < p.N) dst[e] = cv[e];
  }
};

__global__ void seeded_dropout_kernel(const float* __restrict__ x,
                                      float* __restrict__ out, long long total,
                                      int K, Mask mask) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const uint32_t row = static_cast<uint32_t>(i / K);
    const uint32_t col = static_cast<uint32_t>(i % K);
    out[i] = dropped(x[i], row, col, mask);
  }
}

Mask make_mask(uint32_t seed, uint32_t threshold, float scale, int on) {
  return Mask{seed * 0x9E3779B1u, threshold, scale, on};
}

}  // namespace

// out (M, N) = dropout(x (M, K)) @ w (N, K)^T, all float32 row-major on
// the device; out must be 16-byte aligned.
extern "C" int dropout_matmul_f32(const float* x, const float* w, float* out,
                                  int M, int N, int K, uint32_t seed,
                                  uint32_t threshold, float scale, int apply_mask,
                                  void* stream) {
  const splitk::Problem p{x, w, M, N, K, 0, 0};
  const Dropout::Params ep{out, make_mask(seed, threshold, scale, apply_mask)};
  return static_cast<int>(splitk::launch<float, Dropout>(
      p, ep, static_cast<cudaStream_t>(stream)));
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
