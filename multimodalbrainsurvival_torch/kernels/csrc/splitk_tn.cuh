// A split-K product of two K-major operands on Hopper (sm_90a), the core
// that the attention pool (K1, attention_pool.cu) and the seeded
// dropout-matmul (K2a, dropout_matmul.cu) share:
//
//     C[m, n] = sum_k A'[m, k] B[n, k]          A (M, K), B (N, K), row-major
//
// where A' is A after the caller's per-element transform (K2a's dropout
// mask, in float32 and bf16; K1 leaves A as it is), and C goes to the
// caller's epilogue one row
// of a tile at a time (K1: tanh, the gate vector and a sum over the row;
// K2a: a store). Both operands are read as they lie in memory: x (B·bag or
// batch rows) and an nn.Linear weight are K-major already.
//
// Tiles. A block of two warpgroups computes a 128 x 128 tile of C, each
// warpgroup issuing wgmma m64n128 for its 64 rows. The tiles are few at
// the main path's shapes (32 at the pool's 256 x 2048 x 2048 and at the
// RNA encoder's second layer, 64 at its first, 256 x 12,778 x 4,096), so K
// is split over a cluster of up to 8 blocks. A cluster lies within one GPC,
// so with one ~197 KB block an SM, clusters of 4 or more blocks leave SMs
// of a GPC unused and do not all fit in one wave; the host picks the split
// from the card's cluster occupancy: the fewest waves x k-tiles a block
// (3 blocks for 32 tiles, 2 for 64, on an H100). Each
// block sums its share of K in registers; the cluster then adds its blocks'
// float32 tiles through distributed shared memory, every block a slice of
// the rows, in rank order: the sum has a fixed order and no atomics, so it
// is deterministic, and no partial tile goes to device memory.
//
// Loads. A k-tile is 128 bytes of K (64 bf16 or 32 float32) for 128 rows of
// each operand, in the 128-byte-swizzled K-major layout the wgmma
// descriptors read (hopper.cuh). When both operands' rows and bases are
// 16-byte aligned, TMA loads them (one thread, an mbarrier per stage);
// otherwise every thread copies its own 16-byte chunks by cp.async in
// 8- or 4-byte pieces (rows of 12,778 float32 are 8 bytes off a 16-byte
// boundary, and rows of 12,778 bf16 4 bytes, so no tensor map can
// describe them; bf16 rows must be 4-byte aligned, K even). Elements past M, N or K
// read as zero. A ring of 3 (float32) or 6 (bf16) stages keeps the next
// k-tiles' loads in flight: a stage is refilled as soon as its products are
// done. In bf16 one wgmma group stays in flight across steps.
//
// Products. bf16: one wgmma per k16 step, float32 sums. float32: 3xTF32.
// Each float32 value is split once in shared memory into tf32 hi and lo
// (`tf32_split`), and hi·hi + hi·lo + lo·hi run on the TF32 tensor cores
// (495 TFLOP/s against 67 for float32 FMA, 3x the work: 2.4x the rate),
// within about 2^-21 of each product. The tensor cores' float32
// accumulation is not IEEE round-to-nearest, and a sum carried through
// thousands of wgmma steps drifts: at the RNA encoder's first layer its
// error against the float32 product grows from 9e-6 to 3.5e-4 (PERF.md).
// So in float32 each k-tile's products start a fresh accumulator, and the
// block adds it into a second one in registers with IEEE float32
// additions. The split and the caller's transform of k-tile i + 1 run
// while the tensor cores work on k-tile i. In bf16 a caller with a
// transform (`transform_bf16`) rewrites A's k-tile in shared memory, 8
// values a 16-byte chunk, after it lands and before the products read it.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace splitk {

namespace cg = cooperative_groups;
using namespace hopper;

constexpr int BM = 128;          // rows of A per tile: two warpgroups of 64
constexpr int BN = 128;          // rows of B per tile (columns of C)
constexpr int ROW = 128;         // bytes of K per k-tile: one swizzle row
constexpr int THREADS = 256;
constexpr int TILE = BM * ROW;   // 16 KB: one operand's k-tile (BM == BN)
constexpr int CHUNKS = TILE / 16 / THREADS;  // 16-byte chunks a thread, per operand
constexpr int MAX_SPLIT = 8;     // blocks along K: the portable cluster size
constexpr int LDC = BN + 8;      // floats a row of the sum tile (no bank conflicts)
static_assert(BM == BN && CHUNKS == 4, "loader mapping");

// How the operands are loaded: TMA, or cp.async in pieces of 8 or 4 bytes.
enum Route { kTma = 16, kCp8 = 8, kCp4 = 4 };

template <typename T>
struct Prec;
// LAG: wgmma groups left in flight at the end of a step (float32 waits for
// its products to add their sum into registers)
template <>
struct Prec<__nv_bfloat16> {
  static constexpr int STAGES = 6;
  static constexpr int TILES = 2;  // A, B
  static constexpr int LAG = 1;
  static constexpr bool TF32X3 = false;
  static constexpr CUtensorMapDataType MAP = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <>
struct Prec<float> {
  static constexpr int STAGES = 3;
  static constexpr int TILES = 4;  // A hi, B hi, A lo, B lo
  static constexpr int LAG = 0;
  static constexpr bool TF32X3 = true;
  static constexpr CUtensorMapDataType MAP = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};

// Whether the epilogue Epi masks A in bf16 (K2a: `transform_bf16`, and
// `masks(ep)` saying whether this launch applies it).
template <class Epi, class = void>
struct TransformsBf16 : std::false_type {};
template <class Epi>
struct TransformsBf16<Epi, std::void_t<decltype(&Epi::transform_bf16)>>
    : std::true_type {};

template <typename T>
constexpr int smem_bytes() {
  return 1024 /* alignment slack */ + Prec<T>::STAGES * Prec<T>::TILES * TILE +
         Prec<T>::STAGES * 8 /* mbarriers */;
}
static_assert(BM * LDC * 4 <= 3 * 2 * TILE, "the sum tile fits in the ring");

struct Problem {
  const void* a;   // (M, K)
  const void* b;   // (N, K)
  int M, N, K;
  int nkt;         // k-tiles over K
  int kt_split;    // k-tiles per block along K (the last block may have fewer)
};

// A block: tile (blockIdx.z, blockIdx.y) of C, k-tiles [blockIdx.x *
// kt_split, ...) of K; the cluster is the blocks along x. Epi supplies
//   Epi::transform(ep, float4& v, m, k): A[m, k .. k + 3] as loaded -> A'
//     (float32);
//   Epi::transform_bf16(ep, uint4& v, m, k), optional: A[m, k .. k + 7]
//     as loaded -> A' (bf16), where Epi::masks(ep);
//   Epi::cols(ep, p, n_tile, lane) -> Epi::Cols: what a lane's columns of
//     the tile need, loaded once for all its rows;
//   Epi::row(ep, p, cols, m, n_tile, lane, float4 c): C[m, n_tile * BN +
//     4 lane .. + 3], called by the 32 lanes of a warp together for one row
//     m (m and the columns may lie past M and N).
template <typename T, int ROUTE, class Epi>
__global__ void __launch_bounds__(THREADS, 1)
    splitk_kernel(const __grid_constant__ CUtensorMap amap,
                  const __grid_constant__ CUtensorMap bmap, const Problem p,
                  const typename Epi::Params ep) {
  using P = Prec<T>;
  constexpr int S = P::STAGES;
  constexpr int LAG = P::LAG;
  // k-tiles in flight: step i refills the stage of step i - LAG, whose
  // products are done, with k-tile i - LAG + S
  constexpr int AHEAD = S - LAG;
  constexpr int STAGE = P::TILES * TILE;
  constexpr int EPR = ROW / sizeof(T);  // elements of K per k-tile
  constexpr int EPC = 16 / sizeof(T);   // elements of K per 16-byte chunk
  // elements of K per cp.async piece (the route keeps K a multiple of it)
  constexpr int EPP = ROUTE / sizeof(T);
  extern __shared__ unsigned char smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: align the tiles to it
  unsigned char* const smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem + S * STAGE);

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int n0 = blockIdx.y * BN;
  const int m0 = blockIdx.z * BM;
  const int kt0 = blockIdx.x * p.kt_split;
  const int steps = min(p.nkt - kt0, p.kt_split);  // >= 1 (the host's split)

  // a grid queued behind this one with programmatic stream serialization
  // (the pool's softmax) may be scheduled now and waits for this one's end
  pdl_launch_dependents();
  if constexpr (ROUTE == kTma) {
    if (tid == 0) {
#pragma unroll
      for (int s = 0; s < S; ++s) mbar_init(&full[s], 1);
      fence_mbar_init();
    }
  }
  __syncthreads();

  // chunk i of this thread (i < CHUNKS: of A, else of B) is row q / 8,
  // logical 16-byte chunk q % 8 of its operand's k-tile, q = tid + 256 (i %
  // CHUNKS): the cp.async loader and the split use the same map, so a
  // thread splits only what it copied itself
  auto load = [&](int it) {
    if (it >= steps) return;
    unsigned char* const stage = smem + (it % S) * STAGE;
    const int k0 = (kt0 + it) * EPR;
    if constexpr (ROUTE == kTma) {
      if (tid == 0) {
        uint64_t* const bar = &full[it % S];
        mbar_arrive_expect_tx(bar, 2 * TILE);
        tma_load_2d(stage, &amap, bar, k0, m0);
        tma_load_2d(stage + TILE, &bmap, bar, k0, n0);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 2 * CHUNKS; ++i) {
        const bool is_a = i < CHUNKS;
        const int q = tid + (i % CHUNKS) * THREADS;
        const int row = (is_a ? m0 : n0) + q / 8;
        const bool row_ok = row < (is_a ? p.M : p.N);
        const T* const src = static_cast<const T*>(is_a ? p.a : p.b) +
                             (row_ok ? (size_t)row * p.K : 0);
        unsigned char* const dst =
            stage + (is_a ? 0 : TILE) + sw128_offset(q / 8, 16 * (q % 8));
#pragma unroll
        for (int j = 0; j < 16 / ROUTE; ++j) {
          const int k = k0 + EPC * (q % 8) + j * EPP;
          const bool ok = row_ok && k < p.K;
          cp_async_small<ROUTE>(dst + j * ROUTE, src + (ok ? k : 0), ok);
        }
      }
    }
  };

  // k-tile `it` landed, transformed and split (float32), and visible to the
  // async proxy; the caller's barrier then hands it to both warpgroups
  auto prepare = [&](int it) {
    if constexpr (ROUTE == kTma) mbar_wait(&full[it % S], (it / S) & 1);
    if constexpr (P::TF32X3) {
      unsigned char* const stage = smem + (it % S) * STAGE;
      const int k0 = (kt0 + it) * EPR;
#pragma unroll
      for (int i = 0; i < 2 * CHUNKS; ++i) {
        const bool is_a = i < CHUNKS;
        const int q = tid + (i % CHUNKS) * THREADS;
        float4* const hi = reinterpret_cast<float4*>(
            stage + (is_a ? 0 : TILE) + sw128_offset(q / 8, 16 * (q % 8)));
        float4* const lo = reinterpret_cast<float4*>(
            reinterpret_cast<unsigned char*>(hi) + 2 * TILE);
        float4 v = *hi, h, l;
        if (is_a) Epi::transform(ep, v, m0 + q / 8, k0 + 4 * (q % 8));
        tf32_split(v.x, h.x, l.x);
        tf32_split(v.y, h.y, l.y);
        tf32_split(v.z, h.z, l.z);
        tf32_split(v.w, h.w, l.w);
        *hi = h;
        *lo = l;
      }
      fence_proxy_async();
    } else {
      bool wrote = ROUTE != kTma;  // cp.async writes are the generic proxy's
      if constexpr (TransformsBf16<Epi>::value) {
        if (Epi::masks(ep)) {
          unsigned char* const stage = smem + (it % S) * STAGE;
          const int k0 = (kt0 + it) * EPR;
#pragma unroll
          for (int i = 0; i < CHUNKS; ++i) {  // A's chunks only
            const int q = tid + i * THREADS;
            uint4* const c =
                reinterpret_cast<uint4*>(stage + sw128_offset(q / 8, 16 * (q % 8)));
            uint4 v = *c;
            Epi::transform_bf16(ep, v, m0 + q / 8, k0 + EPC * (q % 8));
            *c = v;
          }
          wrote = true;
        }
      }
      if (wrote) fence_proxy_async();
    }
  };

  // the tensor cores' accumulator, and (float32) the IEEE sum of its k-tiles
  float acc[BN / 2], sum[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = sum[i] = 0.f;

#pragma unroll
  for (int it = 0; it < AHEAD; ++it) {
    load(it);
    cp_async_commit();
  }
  cp_async_wait<AHEAD - 1>();  // this thread's pieces of k-tile 0
  prepare(0);
  __syncthreads();
  for (int it = 0; it < steps; ++it) {
    unsigned char* const stage = smem + (it % S) * STAGE;
    const uint64_t da = desc_sw128(stage + wg * 64 * ROW);
    const uint64_t db = desc_sw128(stage + TILE);
    fence_regs(acc);
    wgmma_fence();
    if constexpr (P::TF32X3) {
      const uint64_t da_lo = desc_add(da, 2 * TILE);
      const uint64_t db_lo = desc_add(db, 2 * TILE);
#pragma unroll
      for (int ks = 0; ks < ROW / 32; ++ks) {
        wgmma_tf32_ss_n128(acc, desc_add(da_lo, 32 * ks), desc_add(db, 32 * ks), ks != 0);
        wgmma_tf32_ss_n128(acc, desc_add(da, 32 * ks), desc_add(db_lo, 32 * ks), 1);
        wgmma_tf32_ss_n128(acc, desc_add(da, 32 * ks), desc_add(db, 32 * ks), 1);
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < ROW / 32; ++ks)
        wgmma_bf16_ss_n128(acc, desc_add(da, 32 * ks), desc_add(db, 32 * ks), 1);
    }
    wgmma_commit();
    // the next k-tile's wait, transform and split overlap these products
    if (it + 1 < steps) {
      cp_async_wait<AHEAD - 2>();
      prepare(it + 1);
    }
    wgmma_wait<LAG>();
    if constexpr (P::TF32X3) {
      fence_regs(acc);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sum[i] = __fadd_rn(sum[i], acc[i]);
    }
    // both warpgroups are done with stage (it - LAG) % S, and k-tile it + 1
    // is ready in its stage; refill stage (it - LAG) % S
    __syncthreads();
    load(it + AHEAD);
    cp_async_commit();
  }
  wgmma_wait<0>();
  fence_regs(acc);
  cp_async_wait<0>();
  if constexpr (!P::TF32X3) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sum[i] = acc[i];
  }

  // this block's sums into its (BM, LDC) float32 tile over the ring (no
  // load is in flight: load() issues none past `steps`; every warp is past
  // its products, LAG 0, or waits for them below the barrier). Accumulator i of
  // a thread is row 16 (warp % 4) + lane / 4 + 8 ((i / 2) % 2) of its
  // warpgroup's 64, column 8 (i / 4) + 2 (lane % 4) + i % 2.
  if constexpr (LAG != 0) __syncthreads();  // the other warpgroup's last products
  float* const tile = reinterpret_cast<float*>(smem);
  const int lane = tid % 32;
  const int r0 = wg * 64 + ((tid % 128) / 32) * 16 + lane / 4;
#pragma unroll
  for (int i = 0; i < BN / 2; i += 2) {
    const int row = r0 + 8 * ((i / 2) % 2);
    const int col = 8 * (i / 4) + 2 * (lane % 4);
    *reinterpret_cast<float2*>(tile + row * LDC + col) = make_float2(sum[i], sum[i + 1]);
  }

  // the cluster's sum, in rank order: block r of the cluster adds rows
  // [r * rows, (r + 1) * rows) of every block's tile and hands them to the
  // epilogue, a warp a row, 4 columns a lane; a row's remote loads are all
  // issued before the first is added
  cg::cluster_group cluster = cg::this_cluster();
  const typename Epi::Cols cols = Epi::cols(ep, p, (int)blockIdx.y, lane);
  cluster.sync();  // every block's tile is written
  const int nsplit = (int)gridDim.x;
  const int rows = (BM + nsplit - 1) / nsplit;
  const int rb = (int)blockIdx.x * rows;
  const int re = min(BM, rb + rows);
  for (int row = rb + tid / 32; row < re; row += THREADS / 32) {
    float4 v[MAX_SPLIT];
#pragma unroll
    for (int r = 0; r < MAX_SPLIT; ++r)
      if (r < nsplit)
        v[r] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(tile + row * LDC + 4 * lane, r));
    float4 c = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < MAX_SPLIT; ++r)
      if (r < nsplit) {
        c.x = __fadd_rn(c.x, v[r].x);
        c.y = __fadd_rn(c.y, v[r].y);
        c.z = __fadd_rn(c.z, v[r].z);
        c.w = __fadd_rn(c.w, v[r].w);
      }
    Epi::row(ep, p, cols, m0 + row, (int)blockIdx.y, lane, c);
  }
  cluster.sync();  // no block leaves while another reads its tile
}

// The launch of `kernel` in clusters of `split` blocks along x.
inline cudaLaunchConfig_t cluster_config(int split, int tiles_n, int tiles_m,
                                         int bytes, cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, tiles_n, tiles_m);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = split;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Blocks along K for `tiles` tiles of C and `nkt` k-tiles: the split whose
// slowest SM runs the fewest k-tiles, waves x k-tiles a block, where a wave
// is as many clusters as the card holds at once (a cluster lies within one
// GPC, so clusters of 4 blocks of this size fill fewer SMs than clusters of
// 2); ties go to the smaller split. `resident[s]` caches the clusters of s
// blocks the card holds, per kernel.
template <class K>
int plan_split(K kernel, int bytes, int tiles, int nkt, int (&resident)[MAX_SPLIT + 1]) {
  int best = 1;
  long long best_cost = -1;
  for (int s = 1; s <= MAX_SPLIT && s <= nkt; ++s) {
    if (resident[s] == 0) {
      cudaLaunchAttribute attr;
      const cudaLaunchConfig_t cfg = cluster_config(s, 1, 1, bytes, 0, &attr);
      int n = 0;
      if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess || n < 1)
        n = -1;  // not launchable in clusters of s
      resident[s] = n;
    }
    if (resident[s] < 0) continue;
    const long long waves = (tiles + resident[s] - 1) / resident[s];
    const long long cost = waves * ((nkt + s - 1) / s);
    if (best_cost < 0 || cost < best_cost) {
      best = s;
      best_cost = cost;
    }
  }
  return best;
}

template <typename T>
bool encode_operand(CUtensorMap* map, const void* base, int rows, int K) {
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)(ROW / sizeof(T)), (cuuint32_t)BM};
  return hopper_host::encode_sw128(map, Prec<T>::MAP, 2, base, dims, strides, box);
}

// The route the operands' alignment allows: TMA when every row starts on a
// 16-byte boundary, else cp.async in the largest piece (8 or 4 bytes) that
// keeps every copy aligned; 0 when no piece does (bf16 rows of an odd K).
template <typename T>
int route_of(const void* a, const void* b, int K) {
  const uintptr_t bases = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b);
  const size_t row = (size_t)K * sizeof(T);
  if (row % 16 == 0 && bases % 16 == 0) return kTma;
  if (row % 8 == 0 && bases % 8 == 0) return kCp8;
  if (row % 4 == 0 && bases % 4 == 0) return kCp4;
  return 0;
}

template <typename T, int ROUTE, class Epi>
cudaError_t launch_route(Problem p, const typename Epi::Params& ep,
                         cudaStream_t stream) {
  CUtensorMap amap{}, bmap{};
  if (ROUTE == kTma && (!encode_operand<T>(&amap, p.a, p.M, p.K) ||
                        !encode_operand<T>(&bmap, p.b, p.N, p.K)))
    return cudaErrorInvalidValue;
  const int tiles_m = (p.M + BM - 1) / BM, tiles_n = (p.N + BN - 1) / BN;
  p.nkt = (int)(((size_t)p.K * sizeof(T) + ROW - 1) / ROW);
  auto kernel = splitk_kernel<T, ROUTE, Epi>;
  constexpr int bytes = smem_bytes<T>();
  static int resident[MAX_SPLIT + 1] = {};
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  const int want = plan_split(kernel, bytes, tiles_m * tiles_n, p.nkt, resident);
  p.kt_split = (p.nkt + want - 1) / want;
  const int split = (p.nkt + p.kt_split - 1) / p.kt_split;  // none empty
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(split, tiles_n, tiles_m, bytes, stream, &attr);
  e = cudaLaunchKernelEx(&cfg, kernel, amap, bmap, p, ep);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// C = A' B^T through Epi, on the route A's and B's alignment allows.
template <typename T, class Epi>
cudaError_t launch(const Problem& p, const typename Epi::Params& ep,
                   cudaStream_t stream) {
  if (p.M <= 0 || p.N <= 0 || p.K <= 0) return cudaErrorInvalidValue;
  const int route = route_of<T>(p.a, p.b, p.K);
  if (route == kTma) return launch_route<T, kTma, Epi>(p, ep, stream);
  if (route == kCp8) return launch_route<T, kCp8, Epi>(p, ep, stream);
  if (route == kCp4) return launch_route<T, kCp4, Epi>(p, ep, stream);
  return cudaErrorInvalidValue;  // rows no 4-byte piece can copy
}

}  // namespace splitk
