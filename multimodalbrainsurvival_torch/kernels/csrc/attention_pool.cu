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
// x and W are float32 or bfloat16; tanh, the logits and every sum are
// float32 (the softmax amplifies error in the logits). Outputs are float32.
//
// Bound on the card. At the serving shape (B * bag = 256 rows, D = 2048,
// bfloat16) the work is 2 * 256 * 2048^2 = 2.15 GFLOP (2.2 us at 989
// TFLOP/s) against about 9.4 MB of traffic, mostly W (2.8 us at 3.35 TB/s),
// so the kernel is bound by memory: W has to come from device memory about
// once, on enough SMs to draw the card's bandwidth. The first version of
// this kernel (float32 FMA tiles, no tensor core, one element a load, W
// read four times and x 32 times) took 0.156 ms there (PERF.md).
//
// Design. Two launches, no atomics (deterministic):
//   1. the projection and gate: splitk_tn.cuh's product x W^T (x as (B *
//      bag, D), W in nn.Linear layout: both K-major as stored), bf16 wgmma
//      or 3xTF32 wgmma in float32, fed by TMA into a ring of swizzled
//      tiles; 128 x 128 tiles with D split over a cluster (at the serving
//      shape 2 x 16 tiles x 3 blocks along D = 96 blocks in one wave; W
//      read from device memory once, x 16 times from L2). Its epilogue adds the cluster's
//      float32 sums, applies tanh(.) . v and sums over the tile's 128
//      columns, one warp a row, writing one partial logit per row to
//      partial[column tile, row].
//   2. softmax_pool_kernel: grid (B) x (slices of D). Each block sums its
//      sample's partials in a fixed order, applies the mask and the softmax,
//      and writes its slice of out, reading x (L2-resident) once; the first
//      slice's block also writes w. It is launched with programmatic stream
//      serialization: scheduled while the projection runs, it waits for the
//      projection's end on the device, so no launch gap separates the two.
// x and W must have 16-byte-aligned rows and bases (D a multiple of 8 in
// bf16, of 4 in float32): the wrapper refuses others.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "splitk_tn.cuh"

namespace {

constexpr int POOL_THREADS = 256;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The product's epilogue: logit part of row m over column tile n_tile,
// sum_n tanh(h[m, n]) v[n], in a fixed order (4 columns a lane, then a
// butterfly over the warp).
struct Gate {
  struct Params {
    const float* v;
    float* partial;  // (n_col_tiles, B * bag)
  };
  struct Cols {
    float v[4];  // the gate vector at the lane's columns (0 past D)
  };
  static __device__ __forceinline__ void transform(const Params&, float4&, int, int) {}
  static __device__ __forceinline__ Cols cols(const Params& ep,
                                              const splitk::Problem& p,
                                              int n_tile, int lane) {
    const int n = n_tile * splitk::BN + 4 * lane;
    Cols c;
#pragma unroll
    for (int e = 0; e < 4; ++e) c.v[e] = n + e < p.N ? ep.v[n + e] : 0.f;
    return c;
  }
  static __device__ __forceinline__ void row(const Params& ep,
                                             const splitk::Problem& p,
                                             const Cols& cols, int m,
                                             int n_tile, int lane, float4 h) {
    const int n = n_tile * splitk::BN + 4 * lane;
    const float hv[4] = {h.x, h.y, h.z, h.w};
    float part = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (n + e < p.N) part = fmaf(tanhf(hv[e]), cols.v[e], part);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (lane == 0 && m < p.M) ep.partial[(size_t)n_tile * p.M + m] = part;
  }
};

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
  hopper::pdl_wait();  // the projection's partial logits are written

  float lmax = NEG_INF;
  for (int t = tid; t < bag; t += blockDim.x) {
    float l = NEG_INF;
    if (mask[base + t]) {
      l = 0.f;
#pragma unroll 8
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
#pragma unroll 8
    for (int t = 0; t < bag; ++t) acc = fmaf(w[t], to_f32(xb[(size_t)t * D]), acc);
    out[(size_t)b * D + d] = acc;
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* weight, const float* v,
                   const unsigned char* mask, float* partial, float* out,
                   float* attn, int B, int bag, int D, cudaStream_t stream) {
  const int R = B * bag;
  const int n_col = (D + splitk::BN - 1) / splitk::BN;
  const size_t smem = (size_t)bag * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        softmax_pool_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  if (R <= 0 || D <= 0 || splitk::route_of<T>(x, weight, D) != splitk::kTma)
    return cudaErrorInvalidValue;  // the wrapper refuses such inputs first
  const splitk::Problem p{x, weight, R, D, D, 0, 0};
  cudaError_t err = splitk::launch_route<T, splitk::kTma, Gate>(
      p, Gate::Params{v, partial}, stream);
  if (err != cudaSuccess) return err;
  // launched behind the projection with programmatic stream serialization:
  // its blocks are scheduled while the projection runs and wait for it in
  // pdl_wait, so no launch gap separates the two
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B, (D + POOL_THREADS - 1) / POOL_THREADS);
  cfg.blockDim = dim3(POOL_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, softmax_pool_kernel<T>, static_cast<const T*>(x),
                           static_cast<const float*>(partial), mask, out, attn, B,
                           bag, D, n_col);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows of the (n_col_tiles, B * bag) float32 scratch the caller allocates.
int attention_pool_col_tiles(int D) {
  return (D + splitk::BN - 1) / splitk::BN;
}

// dtype: 0 = float32, 1 = bfloat16 (x and weight, rows and bases 16-byte
// aligned). Returns the CUDA error code of the launches (0 = cudaSuccess);
// nothing is synchronised.
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
