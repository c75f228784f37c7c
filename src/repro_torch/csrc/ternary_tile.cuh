// The tile machinery shared by the dense-code ternary MACs ternary_mac.cu
// (#1, the clamped CiM MAC) and ternary_exact.cu (#5, the exact dot), for
// Hopper (sm_90a). Each .cu supplies a MAC policy (what one ring stage
// adds into the int32 fragments) and its C launcher; everything else is
// here.
//
// Operands: x (M, K) and w (K, N) int8 codes in {-1, 0, +1}, contiguous;
// out (M, N) f32. Any M, K and N.
//
// Orientation: the int8 tensor-core MMA computes out^T = w^T . x^T, so
// the MMA's 16 rows are 16 output columns and its n8 is eight x rows (the
// decode class M <= 8 fills it with no padded row tiles). A block owns
// kCols = 16 output columns and MT x rows (8 at decode, 32 at prefill).
//
// The grid: (N/16 column tiles, M/MT row tiles, S), launched as clusters
// of (1, 1, S) blocks. The S blocks of a cluster split the K extent at
// 16-row block boundaries (rank r takes blocks [r*kb/S, (r+1)*kb/S) of
// kb = ceil(K/16); ternary_mac.py::k_split mirrors it), so the clamp of
// #1 stays per 16-row block and every partial is an exact int32. The
// ranks add their partials into rank 0's tile in shared memory through
// distributed shared memory (cluster.map_shared_rank, integer atomics:
// exact in any order), and rank 0 stores the tile: no atomics in device
// memory, no scratch buffer, no second launch. One split cluster barrier
// orders it: every rank arrives once its tile is zeroed and waits only
// after its K loop, so the first phase costs nothing; rank 0 alone waits
// on the second before it stores. The host picks S (ternary_mac.py::
// launch_plan) so that the grid fills the card's SMs; a launch the
// runtime refuses (a cluster too large, say) returns its error.
//
// Staging: each of a block's 4 warps streams its own K stages (stage s of
// the block's range goes to warp s % 4) through a private kRing-deep ring
// in shared memory. A stage is 64 K rows: the w tile (64 rows x 16
// columns) and the x tile (MT rows x 64 K bytes). Both arrive by 16-byte
// cp.async copies (cp.async.cg, LDGSTS in the SASS; the .L2::128B hint
// brings the whole 128-byte line, which the neighbouring column tiles
// read, into L2 with one request) with one commit group per stage; the
// warp waits with cp.async.wait_group and __syncwarp, so the main loop
// has no block-wide barrier and up to 4 x kRing stages (768 K rows) of a
// block are in flight at once: the whole K range of every smollm-135m
// layer. Copies past the block's K range, the last x row or the last
// column are zero-filled by the copy (src-size 0); zero rows add nothing
// to either MAC. The 16-byte path needs N and K multiples of 16 and
// 16-byte aligned operands (every served shape); other shapes take a
// masked byte-load path into the same staged layout (CW = 1).
//
// Fragments: the MMA wants w K-contiguous per output column, but w is
// N-contiguous. Each lane reads the 4x4 byte block (4 K rows x the 4
// columns holding its column) as four 32-bit words from the staged tile
// and transposes its column out with __byte_perm. Staged w rows are 16
// bytes apart with a 16-byte pad after every 8 rows, and staged x rows 80
// bytes apart, so these fragment loads hit 32 distinct banks (16- and
// 64-byte strides would put two lanes on one bank).
#pragma once

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace ternary_tile {

namespace cg = cooperative_groups;

constexpr int kBlock = 16;                   // rows of one CiM block (N_A)
constexpr int kCols = 16;                    // output columns per block
constexpr int kStageRows = 64;               // K rows per ring stage
constexpr int kWarps = 4;                    // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kRing = 3;                     // stages in flight per warp
constexpr int kWStageBytes = (kStageRows + kStageRows / 8) * kCols;
constexpr int kXRowBytes = kStageRows + 16;  // x row stride in a stage

template <int MT>
constexpr int kSlotBytes = kWStageBytes + MT * kXRowBytes;  // one ring slot

// byte offset of staged w row r: 16 bytes a row, a 16-byte pad per 8 rows
__device__ __forceinline__ int w_row(int r) { return (r + (r >> 3)) * kCols; }

// One chunk of CW bytes (16 or 1) from device memory to shared memory;
// a chunk that is not valid is zero-filled (src-size 0 for cp.async).
template <int CW>
__device__ __forceinline__ void copy_chunk(uint8_t* dst, const int8_t* src,
                                           bool valid) {
  if constexpr (CW == 16) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(valid ? 16 : 0));
  } else {
    *dst = valid ? static_cast<uint8_t>(*src) : 0;
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the two halves of a cluster barrier (release on arrive, acquire on wait)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Stage the kStageRows K rows from k0 (rows at or past k_end read as
// zero): w rows k0.. at columns n0..n0+15, and x rows m0..m0+MT-1 at K k0...
template <int MT, int CW>
__device__ __forceinline__ void fetch_stage(uint8_t* slot, const int8_t* x,
                                            const int8_t* w, int M, int K,
                                            int N, int m0, int n0, int k0,
                                            int k_end, int lane) {
  constexpr int kWChunks = kCols / CW;
  for (int e = lane; e < kStageRows * kWChunks; e += 32) {
    const int r = e / kWChunks;
    const int c = (e - r * kWChunks) * CW;
    const int k = k0 + r;
    const int n = n0 + c;
    const bool ok = k < k_end && n < N;
    copy_chunk<CW>(slot + w_row(r) + c, ok ? w + static_cast<size_t>(k) * N + n : w,
                   ok);
  }
  uint8_t* xs = slot + kWStageBytes;
  constexpr int kXChunks = kStageRows / CW;
  for (int e = lane; e < MT * kXChunks; e += 32) {
    const int r = e / kXChunks;
    const int c = (e - r * kXChunks) * CW;
    const int m = m0 + r;
    const int k = k0 + c;
    const bool ok = m < M && k < k_end;
    copy_chunk<CW>(xs + r * kXRowBytes + c,
                   ok ? x + static_cast<size_t>(m) * K + k : x, ok);
  }
}

// The A fragment word of output column `col` (0..15) at staged K rows
// kr..kr+3 (kr a multiple of 4): byte j is w[kr + j][col].
__device__ __forceinline__ uint32_t w_frag(const uint8_t* ws, int kr, int col) {
  const uint8_t* p = ws + w_row(kr) + (col & ~3);
  const uint32_t r0 = *reinterpret_cast<const uint32_t*>(p);
  const uint32_t r1 = *reinterpret_cast<const uint32_t*>(p + kCols);
  const uint32_t r2 = *reinterpret_cast<const uint32_t*>(p + 2 * kCols);
  const uint32_t r3 = *reinterpret_cast<const uint32_t*>(p + 3 * kCols);
  const unsigned c = col & 3;
  const unsigned sel = c | ((c + 4) << 4);  // byte c of the first, of the second
  return __byte_perm(__byte_perm(r0, r1, sel), __byte_perm(r2, r3, sel), 0x5410);
}

// The B fragment word of staged x row `row` at K kc..kc+3 (as stored).
__device__ __forceinline__ uint32_t x_frag(const uint8_t* xs, int row, int kc) {
  return *reinterpret_cast<const uint32_t*>(xs + row * kXRowBytes + kc);
}

// d = A (16x16 s8) . B (16x8 s8), from a zero accumulator
__device__ __forceinline__ void mma_k16(int (&d)[4], uint32_t a0, uint32_t a1,
                                        uint32_t b0) {
  asm("mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%7,%7,%7,%7};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a0), "r"(a1), "r"(b0), "r"(0));
}

// d += A (16x32 s8) . B (32x8 s8)
__device__ __forceinline__ void mma_k32(int (&d)[4], uint32_t a0, uint32_t a1,
                                        uint32_t a2, uint32_t a3, uint32_t b0,
                                        uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One block of the grid. Mac::stage<MT>(acc, slot, lane) adds one staged
// K slice into the warp's fragments acc[j] (x rows j*8.. of the tile);
// fragment element i of lane (g, t) is output column g + 8*(i/2), x row
// t*2 + i%2.
template <class Mac, int MT, int CW>
__global__ void __launch_bounds__(kThreads)
tile_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
            float* __restrict__ out, int M, int K, int N, Mac mac) {
  __shared__ __align__(16) uint8_t ring[kWarps][kRing][kSlotBytes<MT>];
  __shared__ int tile[MT * kCols];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * kCols;
  const int m0 = blockIdx.y * MT;
  // this rank's K rows: 16-row blocks [rank*kb/ranks, (rank+1)*kb/ranks)
  const int kb = (K + kBlock - 1) / kBlock;
  const int k_lo = rank * kb / ranks * kBlock;
  const int k_hi = min((rank + 1) * kb / ranks * kBlock, K);
  const int stages = (k_hi - k_lo + kStageRows - 1) / kStageRows;
  const int mine = warp < stages ? (stages - warp + kWarps - 1) / kWarps : 0;
  for (int e = threadIdx.x; e < MT * kCols; e += kThreads) tile[e] = 0;
  cluster_arrive();  // phase 1: this rank has started and zeroed its tile

  int acc[MT / 8][4];
#pragma unroll
  for (int j = 0; j < MT / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0;

  // this warp's i-th stage is stage warp + 4i of the range
  auto fetch = [&](int i) {
    fetch_stage<MT, CW>(ring[warp][i % kRing], x, w, M, K, N, m0, n0,
                        k_lo + (warp + i * kWarps) * kStageRows, k_hi, lane);
  };
#pragma unroll
  for (int i = 0; i < kRing - 1; ++i) {
    if (i < mine) fetch(i);
    cp_async_commit();
  }
  for (int i = 0; i < mine; ++i) {
    // refill the slot consumed at i-1 (the __syncwarp below freed it)
    if (i + kRing - 1 < mine) fetch(i + kRing - 1);
    cp_async_commit();
    cp_async_wait<kRing - 1>();  // this lane's copies of stage i landed
    __syncwarp();                // ... and every lane's
    mac.template stage<MT>(acc, ring[warp][i % kRing], lane);
    __syncwarp();
  }
  cp_async_wait<0>();

  // add the fragments into rank 0's tile: at decode straight from each
  // warp; at prefill (4x the elements) into this block's tile first, so
  // that each rank adds each element into rank 0's tile once
  const int g = lane >> 2;
  const int t = lane & 3;
  int* sum = cluster.map_shared_rank(tile, 0);
  cluster_wait();  // phase 1: every rank's tile is zeroed
  int* dst = MT == 8 ? sum : tile;
#pragma unroll
  for (int j = 0; j < MT / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      atomicAdd(&dst[(j * 8 + t * 2 + (i & 1)) * kCols + g + 8 * (i >> 1)],
                acc[j][i]);
  if (MT != 8) {
    __syncthreads();  // this block's tile is complete
    if (rank != 0)
      for (int e = threadIdx.x; e < MT * kCols; e += kThreads)
        atomicAdd(&sum[e], tile[e]);
  }
  cluster_arrive();  // phase 2: this rank's additions are done
  if (rank == 0) {
    cluster_wait();
    for (int e = threadIdx.x; e < MT * kCols; e += kThreads) {
      const int m = m0 + e / kCols;
      const int n = n0 + e % kCols;
      if (m < M && n < N) out[static_cast<size_t>(m) * N + n] = static_cast<float>(tile[e]);
    }
  }
}

template <class Mac, int MT, int CW>
int launch_cw(const int8_t* x, const int8_t* w, float* out, int M, int K, int N,
              int cluster, Mac mac, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kCols - 1) / kCols, (M + MT - 1) / MT, cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = cluster;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, tile_kernel<Mac, MT, CW>, x, w, out, M, K, N, mac);
  const cudaError_t last = cudaGetLastError();  // clears a refused launch
  return static_cast<int>(err != cudaSuccess ? err : last);
}

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The launch for `rows_per_block` (8 or 32) x rows per block and a
// cluster of `cluster` blocks splitting K; the copy width follows the
// operands' alignment. Returns the CUDA error of the launch (0 on success).
template <class Mac>
int launch(const void* x, const void* w, void* out, int M, int K, int N,
           int rows_per_block, int cluster, Mac mac, void* stream) {
  const auto* xs = static_cast<const int8_t*>(x);
  const auto* ws = static_cast<const int8_t*>(w);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (cluster < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool wide = N % 16 == 0 && K % 16 == 0 && aligned(x, 16) && aligned(w, 16);
  if (rows_per_block == 8) {
    return wide ? launch_cw<Mac, 8, 16>(xs, ws, o, M, K, N, cluster, mac, s)
                : launch_cw<Mac, 8, 1>(xs, ws, o, M, K, N, cluster, mac, s);
  }
  if (rows_per_block == 32) {
    return wide ? launch_cw<Mac, 32, 16>(xs, ws, o, M, K, N, cluster, mac, s)
                : launch_cw<Mac, 32, 1>(xs, ws, o, M, K, N, cluster, mac, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace ternary_tile
