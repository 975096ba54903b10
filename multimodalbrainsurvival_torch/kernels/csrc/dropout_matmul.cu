// Seeded dropout fused into a float32 or bf16 matrix product (K2a), and the
// same dropout applied alone (K2b), for Hopper (sm_90a).
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
//       and its paired form, two (M, K) tensors under one mask in one
//       launch (the backward of an inner layer masks both g·W and x).
//
// The keep-mask M is a pure function of (seed, row, col): a murmur3-style
// finalizer of gidx = row * 65536 + col (mod 2^32) xor seed * 0x9E3779B1,
// kept iff the hash >= threshold = min(int(p * 2^32), 2^32 - 1); s is
// float32(1 / (1 - p)). It is a copy of `_mask_block` (:52-71) and one
// device function, `keep`, serves both kernels, so the forward's mask and
// the mask the backward regenerates cannot drift apart. Columns alias at
// col0 + K > 65536; the wrapper refuses such widths.
//
// Every entry takes (row0, col0), the tensor's offset in a larger mask:
// the hash is of (row0 + row, col0 + col), so a rank that holds rows
// [row0, row0 + M) of a data-parallel batch, or hidden columns [col0,
// col0 + K) of a tensor-parallel layer, draws the part of the mask that
// the unsharded call draws there. The offset enters as one add per index,
// (row0 * 65536 + col0) mod 2^32 precomputed in the Mask.
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
// K2b is one pass over memory, bound by bytes: 8 bytes an element (16 for
// the pair), 26.2 / 8.4 MB at the RNA layers (dense_0 / dense_1), 7.8 /
// 2.5 us at 3.35 TB/s.
// Its first version was a grid-stride loop of scalar loads that took
// (row, col) from a 64-bit i / K and i % K per element, on a grid capped
// at a constant. Now:
//   - a row-indexed grid: blocks stride over rows, threads span columns,
//     so the hash takes (row, col) from the loop counters and nothing
//     divides;
//   - 16-byte loads and stores where every tensor's rows start at the same
//     offset from a 16-byte boundary (dense_1; dense_0, whose 51,112-byte
//     rows alternate between 16- and 8-byte alignment, through a scalar
//     head of 0 or 2 values), else 8- or 4-byte pieces; the route follows
//     from the base addresses alone (piece_width);
//   - each thread loads up to 4 pieces of each tensor before it hashes, and
//     the grid is one wave sized from the SM count and the occupancy query;
//   - the inputs are read once, with streaming loads;
//   - the pair hashes each mask value once for both tensors.
// With the L2 scrubbed before each launch, a launch that does nothing takes
// ~5.4 us on an H100 (PERF.md), so at dense_1 most of K2b's time is not
// its bytes.
//
// The bf16 form (the joint model's RNA encoder in compute_dtype bfloat16,
// as the TPU kernel took a bf16 x): x and w bf16, the mask the same
// function of (seed, row, col), a kept value float32(x) * s rounded once to
// bf16, the products on the bf16 wgmma path K1 uses (splitk_tn.cuh), float32
// sums and a float32 (M, N) output. splitk_tn.cuh masks each bf16 k-tile of
// x in shared memory after it lands. dense_0's bf16 rows are 25,556 bytes,
// 4 bytes off a 16-byte boundary: that layer takes cp.async in 4-byte
// pieces, the 4,096-wide rows TMA; an odd K has no route (the wrapper
// refuses it). K2b's bf16 forms mask bf16 tensors the same way, in pieces
// of up to 8 values.
//
// Every entry launches on the caller's stream, allocates nothing, and
// returns the CUDA error code of the launch.

#include <cstdint>
#include <cstring>
#include <initializer_list>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "splitk_tn.cuh"

namespace {

struct Mask {
  uint32_t seed_mix;   // seed * 0x9E3779B1 (mod 2^32)
  uint32_t threshold;  // keep iff hash >= threshold
  float scale;         // float32(1 / (1 - p))
  int on;              // 0: plain product, no mask (p == 0)
  uint32_t offset;     // row0 * 65536 + col0 (mod 2^32)
};

// The hash of key = (row0 + row) * 65536 + col0 + col (mod 2^32).
__device__ __forceinline__ bool keep_key(uint32_t key, const Mask& mask) {
  uint32_t h = key ^ mask.seed_mix;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h >= mask.threshold;
}

__device__ __forceinline__ bool keep(uint32_t row, uint32_t col, const Mask& mask) {
  return keep_key(row * 65536u + mask.offset + col, mask);
}

// A kept value: v * scale in float32, rounded once to T (bf16: round to
// nearest even), as the plain version's (x.float() * s).to(dtype).
__device__ __forceinline__ float scaled(float v, float s) { return __fmul_rn(v, s); }
__device__ __forceinline__ __nv_bfloat16 scaled(__nv_bfloat16 v, float s) {
  return __float2bfloat16_rn(__fmul_rn(__bfloat162float(v), s));
}
template <typename T>
__device__ __forceinline__ T zero() {
  return T(0.f);
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

template <typename T>
__device__ __forceinline__ T dropped(T v, uint32_t row, uint32_t col, const Mask& mask) {
  return keep(row, col, mask) ? scaled(v, mask.scale) : zero<T>();
}

// K2a's parts of the product: the mask on x's k-tiles (float32 as they are
// split, bf16 in place), and the store of C.
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
  static __device__ __forceinline__ bool masks(const Params& ep) { return ep.mask.on; }
  // x[m, k .. k + 7] in bf16
  static __device__ __forceinline__ void transform_bf16(const Params& ep, uint4& v,
                                                        int m, int k) {
    __nv_bfloat16 e[8];
    memcpy(e, &v, sizeof(v));
#pragma unroll
    for (int i = 0; i < 8; ++i) e[i] = dropped(e[i], m, k + i, ep.mask);
    memcpy(&v, e, sizeof(v));
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

// K2b's launch: THREADS a block, each thread with up to ILP pieces of V
// values (of each tensor) loaded before it hashes, so that a block has
// ILP x THREADS x V x sizeof(T) bytes in flight.
constexpr int K2B_THREADS = 256;
constexpr int K2B_ILP = 4;

// V consecutive values of T, loaded and stored as one access of their
// bytes (ld.global.v4.u32 / .v2.u32 / .u32 / .u16) where the address is
// aligned to them.
template <typename T, int V>
struct alignas(sizeof(T) * V) Piece {
  T f[V];
};
template <int BYTES>
struct Word;
template <>
struct Word<16> {
  using type = uint4;
};
template <>
struct Word<8> {
  using type = uint2;
};
template <>
struct Word<4> {
  using type = unsigned int;
};
template <>
struct Word<2> {
  using type = unsigned short;
};

// K2b reads each input once, so its loads are streaming (ld.global.cs:
// evicted from L2 first), which keeps its outputs, read next by the
// product of dW, in L2 in their place.
template <typename T, int V>
__device__ __forceinline__ Piece<T, V> take(const T* p) {
  using W = typename Word<sizeof(T) * V>::type;
  const W w = __ldcs(reinterpret_cast<const W*>(p));
  Piece<T, V> r;
  memcpy(&r, &w, sizeof(W));
  return r;
}

template <typename T, int V>
__device__ __forceinline__ void put(T* p, const Piece<T, V>& v) {
  *reinterpret_cast<Piece<T, V>*>(p) = v;
}

// out_a = M ⊙ a · s and, for PAIR, out_b = M ⊙ b · s with the same mask
// hashed once, all (M, K) row-major. Block (bx, by) takes rows by, by +
// gridDim.y, ...; in a row its threads span the columns, so (row, col) come
// from the loop counters and no element divides. A row is a scalar head up
// to the first V-value boundary, pieces of V values, and a scalar tail; the
// launch makes every tensor's base the same offset from a piece boundary,
// so the head is the same in all of them.
template <typename T, int V, bool PAIR>
__global__ void __launch_bounds__(K2B_THREADS)
    seeded_dropout_kernel(const T* __restrict__ a, const T* __restrict__ b,
                          T* __restrict__ out_a, T* __restrict__ out_b,
                          int M, int K, Mask mask) {
  const int step = K2B_THREADS * gridDim.x;
  for (int row = blockIdx.y; row < M; row += gridDim.y) {
    const size_t base = static_cast<size_t>(row) * K;
    // the row's key: each value's is key + its column
    const uint32_t key = static_cast<uint32_t>(row) * 65536u + mask.offset;
    const int misaligned = static_cast<int>(
        (reinterpret_cast<uintptr_t>(a + base) / sizeof(T)) & (V - 1));
    const int head = min((V - misaligned) & (V - 1), K);
    const int pieces = static_cast<unsigned>(K - head) / V;
    const T* const ra = a + base + head;
    const T* const rb = PAIR ? b + base + head : nullptr;
    T* const wa = out_a + base + head;
    T* const wb = PAIR ? out_b + base + head : nullptr;
    for (int p0 = blockIdx.x * K2B_THREADS + threadIdx.x; p0 < pieces;
         p0 += K2B_ILP * step) {
      Piece<T, V> va[K2B_ILP], vb[K2B_ILP];
#pragma unroll
      for (int j = 0; j < K2B_ILP; ++j) {
        const int p = p0 + j * step;
        if (p < pieces) {
          va[j] = take<T, V>(ra + p * V);
          if (PAIR) vb[j] = take<T, V>(rb + p * V);
        }
      }
#pragma unroll
      for (int j = 0; j < K2B_ILP; ++j) {
        const int p = p0 + j * step;
        if (p < pieces) {
          const uint32_t col = head + p * V;
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const bool kept = keep_key(key + col + e, mask);
            va[j].f[e] = kept ? scaled(va[j].f[e], mask.scale) : zero<T>();
            if (PAIR) vb[j].f[e] = kept ? scaled(vb[j].f[e], mask.scale) : zero<T>();
          }
          put(wa + p * V, va[j]);
          if (PAIR) put(wb + p * V, vb[j]);
        }
      }
    }
    // the head (threads 0 .. V-2) and the tail (threads 32 .. 32+V-2) of the
    // row, in two warps of the row's first block
    if (blockIdx.x == 0) {
      const int tail = K - head - pieces * V;
      const int t = threadIdx.x;
      const int col = t < head ? t
                      : (t >= 32 && t - 32 < tail) ? head + pieces * V + t - 32 : -1;
      if (col >= 0) {
        const bool kept = keep_key(key + col, mask);
        out_a[base + col] = kept ? scaled(a[base + col], mask.scale) : zero<T>();
        if (PAIR) out_b[base + col] = kept ? scaled(b[base + col], mask.scale) : zero<T>();
      }
    }
  }
}

// The widest piece (16, 8 or 4 bytes; else one value) at which every base
// is the same offset from a piece boundary (the bases congruent modulo the
// piece's bytes): then every row of every tensor starts at the same offset
// too, whatever K. Returns the piece's values.
template <typename T>
int piece_width(std::initializer_list<const void*> bases) {
  for (int bytes = 16; bytes > static_cast<int>(sizeof(T)); bytes /= 2) {
    const uintptr_t m = bytes - 1;
    const uintptr_t r = reinterpret_cast<uintptr_t>(*bases.begin()) & m;
    bool same = true;
    for (const void* p : bases) same = same && (reinterpret_cast<uintptr_t>(p) & m) == r;
    if (same) return bytes / static_cast<int>(sizeof(T));
  }
  return 1;
}

// Blocks of seeded_dropout_kernel<T, V, PAIR> that fit on the card at once
// (SM count x occupancy), asked once; 0 if the runtime cannot say.
template <typename T, int V, bool PAIR>
int resident_blocks() {
  static int n = -1;
  if (n < 0) {
    int dev = 0, sms = 0, per_sm = 0;
    n = (cudaGetDevice(&dev) == cudaSuccess &&
         cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) ==
             cudaSuccess &&
         cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, seeded_dropout_kernel<T, V, PAIR>, K2B_THREADS, 0) ==
             cudaSuccess)
            ? sms * per_sm
            : 0;
  }
  return n;
}

// One wave: gridDim.x blocks span a row's pieces at up to ILP a thread,
// gridDim.y as many rows as the card holds blocks of the rest.
template <typename T, int V, bool PAIR>
cudaError_t launch_dropout(const T* a, const T* b, T* out_a, T* out_b, int M, int K,
                           const Mask& mask, cudaStream_t stream) {
  const int resident = resident_blocks<T, V, PAIR>();
  if (resident < 1) return cudaErrorInvalidConfiguration;
  const int per_block = K2B_THREADS * K2B_ILP;
  const int gx = K / V > per_block ? (K / V + per_block - 1) / per_block : 1;
  int gy = resident / gx;
  gy = gy < 1 ? 1 : gy > M ? M : gy > 65535 ? 65535 : gy;
  seeded_dropout_kernel<T, V, PAIR>
      <<<dim3(gx, gy), K2B_THREADS, 0, stream>>>(a, b, out_a, out_b, M, K, mask);
  return cudaGetLastError();
}

template <typename T, bool PAIR>
int seeded_dropout_launch(const T* a, const T* b, T* out_a, T* out_b, int M, int K,
                          const Mask& mask, void* stream) {
  if (M <= 0 || K <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int v = PAIR ? piece_width<T>({a, b, out_a, out_b}) : piece_width<T>({a, out_a});
  cudaError_t err;
  if constexpr (sizeof(T) == 2) {
    err = v == 8   ? launch_dropout<T, 8, PAIR>(a, b, out_a, out_b, M, K, mask, s)
          : v == 4 ? launch_dropout<T, 4, PAIR>(a, b, out_a, out_b, M, K, mask, s)
          : v == 2 ? launch_dropout<T, 2, PAIR>(a, b, out_a, out_b, M, K, mask, s)
                   : launch_dropout<T, 1, PAIR>(a, b, out_a, out_b, M, K, mask, s);
  } else {
    err = v == 4   ? launch_dropout<T, 4, PAIR>(a, b, out_a, out_b, M, K, mask, s)
          : v == 2 ? launch_dropout<T, 2, PAIR>(a, b, out_a, out_b, M, K, mask, s)
                   : launch_dropout<T, 1, PAIR>(a, b, out_a, out_b, M, K, mask, s);
  }
  return static_cast<int>(err);
}

Mask make_mask(uint32_t seed, uint32_t threshold, float scale, int on, uint32_t row0,
               uint32_t col0) {
  return Mask{seed * 0x9E3779B1u, threshold, scale, on, row0 * 65536u + col0};
}

template <typename T>
int dropout_matmul_launch(const T* x, const T* w, float* out, int M, int N, int K,
                          uint32_t seed, uint32_t threshold, float scale,
                          int apply_mask, uint32_t row0, uint32_t col0, void* stream) {
  const splitk::Problem p{x, w, M, N, K, 0, 0};
  const Dropout::Params ep{out,
                           make_mask(seed, threshold, scale, apply_mask, row0, col0)};
  return static_cast<int>(splitk::launch<T, Dropout>(
      p, ep, static_cast<cudaStream_t>(stream)));
}

}  // namespace

extern "C" {

// Every entry masks with the part of a larger mask at (row0, col0): rows
// [row0, row0 + M) and columns [col0, col0 + K) of it.

// out (M, N) = dropout(x (M, K)) @ w (N, K)^T, x and w float32 row-major on
// the device, out float32 and 16-byte aligned.
int dropout_matmul_f32(const float* x, const float* w, float* out, int M, int N,
                       int K, uint32_t seed, uint32_t threshold, float scale,
                       int apply_mask, uint32_t row0, uint32_t col0, void* stream) {
  return dropout_matmul_launch(x, w, out, M, N, K, seed, threshold, scale,
                               apply_mask, row0, col0, stream);
}

// The same with x and w bf16 (rows and bases 4-byte aligned: K even), the
// products on the bf16 tensor cores, float32 sums and output.
int dropout_matmul_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w, float* out,
                        int M, int N, int K, uint32_t seed, uint32_t threshold,
                        float scale, int apply_mask, uint32_t row0, uint32_t col0,
                        void* stream) {
  return dropout_matmul_launch(x, w, out, M, N, K, seed, threshold, scale,
                               apply_mask, row0, col0, stream);
}

// out (M, K) = dropout(x (M, K)), float32 row-major on the device.
int seeded_dropout_f32(const float* x, float* out, int M, int K, uint32_t seed,
                       uint32_t threshold, float scale, uint32_t row0, uint32_t col0,
                       void* stream) {
  return seeded_dropout_launch<float, false>(
      x, nullptr, out, nullptr, M, K, make_mask(seed, threshold, scale, 1, row0, col0),
      stream);
}

// out_a = dropout(a), out_b = dropout(b) with one mask, all (M, K) float32
// row-major on the device; each mask value hashed once.
int seeded_dropout_pair_f32(const float* a, const float* b, float* out_a, float* out_b,
                            int M, int K, uint32_t seed, uint32_t threshold,
                            float scale, uint32_t row0, uint32_t col0, void* stream) {
  return seeded_dropout_launch<float, true>(
      a, b, out_a, out_b, M, K, make_mask(seed, threshold, scale, 1, row0, col0),
      stream);
}

// The bf16 forms of the two: kept values scaled in float32 and rounded once.
int seeded_dropout_bf16(const __nv_bfloat16* x, __nv_bfloat16* out, int M, int K,
                        uint32_t seed, uint32_t threshold, float scale, uint32_t row0,
                        uint32_t col0, void* stream) {
  return seeded_dropout_launch<__nv_bfloat16, false>(
      x, nullptr, out, nullptr, M, K, make_mask(seed, threshold, scale, 1, row0, col0),
      stream);
}

int seeded_dropout_pair_bf16(const __nv_bfloat16* a, const __nv_bfloat16* b,
                             __nv_bfloat16* out_a, __nv_bfloat16* out_b, int M, int K,
                             uint32_t seed, uint32_t threshold, float scale,
                             uint32_t row0, uint32_t col0, void* stream) {
  return seeded_dropout_launch<__nv_bfloat16, true>(
      a, b, out_a, out_b, M, K, make_mask(seed, threshold, scale, 1, row0, col0),
      stream);
}

}  // extern "C"
