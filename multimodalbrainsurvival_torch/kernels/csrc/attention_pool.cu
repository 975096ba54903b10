// Fused gated tanh-attention bag pool, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `fused_gated_attention_pool` / `_pool_forward`
// (multimodalbrainsurvival_tpu/ops/pallas/tanh_attention.py, retired in
// commit 183b10c; pallas_call at :111, body `_kernel` at :40). It computes
// what TanhAttention + masked_bag_mean compute (models/aggregators.py:52-73,
// models/mil.py:22-28):
//
//     logits[b, t] = tanh(x[b, t, :] @ W^T) . v          (W: nn.Linear layout)
//     w[b, :]      = masked softmax over the bag (-1e30 pads, the sum
//                    clamped at 1e-30, so an all-masked bag gives zeros)
//     out[b, :]    = sum_t w[b, t] x[b, t, :]
//
// x and W are float32 or bfloat16; every product and sum is float32 (plain
// FMA, never TF32: the softmax amplifies error in the logits). Outputs are
// float32.
//
// Bound on the card. At the serving shape (B * bag = 256 rows, D = 2048,
// bfloat16) the work is 2 * 256 * 2048^2 = 2.15 GFLOP (2.2 us at 989
// TFLOP/s) against about 9.4 MB of traffic, mostly W (2.8 us at 3.35 TB/s),
// so the kernel is bound by memory. This first version uses plain FMA tiles
// and sits far from that bound; wgmma, TMA and a single read of x per
// sample are later work.
//
// Design. The TPU kernel walked W's column tiles in a sequential grid and
// accumulated the logits in scratch. Blocks on Hopper run in no order, so
// the work is split into two launches with no atomics (deterministic):
//   1. project_gate_kernel: grid (column tiles of D) x (row tiles of B*bag).
//      Each block computes a BM x BN tile of x @ W^T through shared memory,
//      applies tanh, multiplies by v and sums over its columns, writing one
//      partial logit per row to partial[col_tile, row].
//   2. softmax_pool_kernel: grid (B) x (slices of D). Each block sums its
//      sample's partials in a fixed order, applies the mask and the softmax,
//      and writes its slice of out; the first slice's block also writes w.
// Ragged edges (rows, columns, depth) are masked in the kernels; nothing is
// padded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;  // rows of x per block
constexpr int BN = 64;  // columns of W per block
constexpr int BK = 16;  // depth of one shared-memory stage
constexpr int TM = 4;   // rows per thread
constexpr int TN = 4;   // columns per thread
constexpr int PROJ_THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int POOL_THREADS = 256;
constexpr float NEG_INF = -1e30f;
// the loader gives each thread 4 k of one row of x and the same row of W
static_assert(BM == BN && PROJ_THREADS == BM * BK / 4, "loader mapping");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(PROJ_THREADS)
project_gate_kernel(const T* __restrict__ x, const T* __restrict__ weight,
                    const float* __restrict__ v, float* __restrict__ partial,
                    int R, int D) {
  __shared__ float As[BK][BM];
  __shared__ float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);  // column group: 16 neighbouring lanes
  const int ty = tid / (BN / TN);  // row group
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  // loader: each thread brings 4 consecutive k of one row of x and of W
  const int lrow = tid / (BK / 4);
  const int lk = (tid % (BK / 4)) * 4;
  const int r_load = row0 + lrow;
  const int c_load = col0 + lrow;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < D; k0 += BK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + lk + i;
      As[lk + i][lrow] =
          (r_load < R && k < D) ? to_f32(x[(size_t)r_load * D + k]) : 0.f;
      Bs[lk + i][lrow] =
          (c_load < D && k < D) ? to_f32(weight[(size_t)c_load * D + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float part[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    part[i] = 0.f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx * TN + j;
      if (c < D) part[i] = fmaf(tanhf(acc[i][j]), v[c], part[i]);
    }
  }
  // sum over the block's columns: the 16 tx of one ty are one half-warp
#pragma unroll
  for (int off = (BN / TN) / 2; off > 0; off >>= 1)
#pragma unroll
    for (int i = 0; i < TM; ++i)
      part[i] += __shfl_xor_sync(0xffffffffu, part[i], off);
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = row0 + ty * TM + i;
      if (r < R) partial[(size_t)blockIdx.x * R + r] = part[i];
    }
  }
}

// Every thread returns the same value; `red` is free again on return.
template <bool IS_MAX>
__device__ float block_reduce(float val, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float other = __shfl_xor_sync(0xffffffffu, val, off);
    val = IS_MAX ? fmaxf(val, other) : val + other;
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) red[warp] = val;
  __syncthreads();
  val = red[0];
  for (int i = 1; i < (int)(blockDim.x / 32); ++i)
    val = IS_MAX ? fmaxf(val, red[i]) : val + red[i];
  __syncthreads();
  return val;
}

template <typename T>
__global__ void __launch_bounds__(POOL_THREADS)
softmax_pool_kernel(const T* __restrict__ x, const float* __restrict__ partial,
                    const unsigned char* __restrict__ mask,
                    float* __restrict__ out, float* __restrict__ attn, int B,
                    int bag, int D, int n_col_tiles) {
  extern __shared__ float w[];  // (bag,) logits, then weights
  __shared__ float red[POOL_THREADS / 32];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t R = (size_t)B * bag;
  const size_t base = (size_t)b * bag;

  float lmax = NEG_INF;
  for (int t = tid; t < bag; t += blockDim.x) {
    float l = NEG_INF;
    if (mask[base + t]) {
      l = 0.f;
      for (int j = 0; j < n_col_tiles; ++j) l += partial[j * R + base + t];
    }
    w[t] = l;
    lmax = fmaxf(lmax, l);
  }
  lmax = block_reduce<true>(lmax, red);

  float sum = 0.f;
  for (int t = tid; t < bag; t += blockDim.x) {
    const float e = mask[base + t] ? expf(w[t] - lmax) : 0.f;
    w[t] = e;
    sum += e;
  }
  const float denom = fmaxf(block_reduce<false>(sum, red), 1e-30f);
  for (int t = tid; t < bag; t += blockDim.x) {
    w[t] = w[t] / denom;
    if (blockIdx.y == 0) attn[base + t] = w[t];
  }
  __syncthreads();

  const int d = blockIdx.y * blockDim.x + tid;
  if (d < D) {
    const T* xb = x + base * D + d;
    float acc = 0.f;
    for (int t = 0; t < bag; ++t) acc = fmaf(w[t], to_f32(xb[(size_t)t * D]), acc);
    out[(size_t)b * D + d] = acc;
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* weight, const float* v,
                   const unsigned char* mask, float* partial, float* out,
                   float* attn, int B, int bag, int D, cudaStream_t stream) {
  const int R = B * bag;
  const int n_col = (D + BN - 1) / BN;
  const size_t smem = (size_t)bag * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        softmax_pool_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid1(n_col, (R + BM - 1) / BM);
  project_gate_kernel<T><<<grid1, PROJ_THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(weight), v, partial, R,
      D);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid2(B, (D + POOL_THREADS - 1) / POOL_THREADS);
  softmax_pool_kernel<T><<<grid2, POOL_THREADS, smem, stream>>>(
      static_cast<const T*>(x), partial, mask, out, attn, B, bag, D, n_col);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows of the (n_col_tiles, B * bag) float32 scratch the caller allocates.
int attention_pool_col_tiles(int D) { return (D + BN - 1) / BN; }

// dtype: 0 = float32, 1 = bfloat16 (x and weight). Returns the CUDA error
// code of the launches (0 = cudaSuccess); nothing is synchronised.
int attention_pool_forward(const void* x, const void* weight, const float* v,
                           const unsigned char* mask, float* partial,
                           float* out, float* attn, int B, int bag, int D,
                           int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, weight, v, mask, partial, out, attn, B, bag, D, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, weight, v, mask, partial, out, attn, B,
                                 bag, D, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
