// The tile machinery shared by the five kernels of the port, for Hopper
// (sm_90a): ternary_mac.cu (#1, the clamped CiM MAC on int8 codes),
// ternary_exact.cu (#5, the exact dot on int8 codes), packed_mac.cu (#4
// and #2, either MAC from the two stored bitplanes, f32 or int32 out) and
// packed_stream.cu (#3, either MAC from one plane-interleaved array). A
// kernel is
// tile_kernel<Mac, Src, MT, CW, OutT, RING>: a MAC policy (CimMac or
// ExactMac: what one ring stage adds into the int32 fragments), a weight
// source (DenseCodes, PlanePair or Interleaved: how the w part of a stage
// is staged and how its int8 fragment words are read), MT x rows per
// block, the copy width CW, the output type and the ring depth. Each .cu
// holds its source note and its C launcher; everything else is here.
//
// Operands: x (M, K) int8 codes in {-1, 0, +1}, contiguous (row stride
// K); out (M, N) contiguous, f32 or int32. K is x's extent: the K loop
// ends at x's last 16-row block, so weight rows past it (the canonical K
// pad of stored planes) are never read. Only the N logical columns are
// stored. Any M, K and N.
//
// Orientation: the int8 tensor-core MMA computes out^T = w^T . x^T, so
// the MMA's 16 rows are 16 output columns and its n8 is eight x rows (the
// decode class M <= 8 fills it with no padded row tiles). A block owns
// kCols = 16 output columns and MT x rows (8 at decode, 32 at prefill).
//
// The grid: (N/16 column tiles, M/MT row tiles, S), launched as clusters
// of (1, 1, S) blocks. The S blocks of a cluster split the K extent at
// 16-row block boundaries (rank r takes blocks [r*kb/S, (r+1)*kb/S) of
// kb = ceil(K/16); kernels/plan.py::k_split mirrors it), so the clamp of
// the CiM MAC stays per 16-row block and every partial is an exact int32.
// The ranks add their partials into rank 0's tile in shared memory
// through distributed shared memory (cluster.map_shared_rank, integer
// atomics: exact in any order), and rank 0 stores the tile: no atomics in
// device memory, no scratch buffer, no second launch. One split cluster
// barrier orders it: every rank arrives once its tile is zeroed and waits
// only after its K loop, so the first phase costs nothing; rank 0 alone
// waits on the second before it stores. The host picks S
// (kernels/plan.py::launch_plan) so that the grid fills the card's SMs; a
// launch the runtime refuses (a cluster too large, say) returns its
// error.
//
// Staging: each of a block's 4 warps streams its own K stages (stage s of
// the block's range goes to warp s % 4) through a private RING-deep ring
// in shared memory. A stage is 64 K rows: the source's w part and the x
// tile (MT rows x 64 K bytes). Both arrive by 16-byte cp.async copies
// (cp.async.cg, LDGSTS in the SASS; the .L2::128B hint brings the whole
// 128-byte line, which the neighbouring column tiles read, into L2 with
// one request) with one commit group per stage; the warp waits with
// cp.async.wait_group and __syncwarp, so the main loop has no block-wide
// barrier and up to 4 x RING stages (768 K rows at RING = 3) of a block
// are in flight at once: the whole K range of every smollm-135m layer.
// Copies past the block's K range, the last x row, the last weight row
// or the last column are zero-filled by the copy (src-size 0); zero x
// rows add nothing to either MAC, whatever the weight bytes beside them.
// The 16-byte path needs 16-byte aligned operands, row strides and column
// extents (every served shape); other shapes take a masked byte-load path
// into the same staged layout (CW = 1).
//
// Weight sources, and the fragment word they give: the MMA's A word of
// output column `col` at stage K rows kr..kr+3 (kr a multiple of 4) holds
// w[kr + j][col] in byte j.
//   * DenseCodes: w (K, N) int8 codes, row stride ld. The stage holds 64
//     rows x 16 columns; the MMA wants w K-contiguous per column, so each
//     lane reads the 4x4 byte block (4 K rows x the 4 columns holding its
//     column) as four words and transposes its column out with
//     __byte_perm. Staged rows are 16 bytes apart with a 16-byte pad
//     after every 8 rows, and staged x rows 80 bytes apart, so these
//     loads hit 32 distinct banks.
//   * PlanePair: the stored (M1, M2) planes, two (rows, *) uint8 arrays
//     with row strides ldp and ldn, bit j of byte-row r = K row 8r+j. A
//     stage is 8 byte-rows of each plane: 16 copies of 16 bytes.
//   * Interleaved: plane layout 1, one (rows, *) uint8 array with row
//     stride ld whose byte-row 2r is pos byte-row r and 2r+1 neg byte-row
//     r (16-row block b: byte-rows 4b..4b+3 = pos lo, neg lo, pos hi, neg
//     hi). A stage is 16 consecutive byte-rows: both planes in one run.
//   For both plane sources a lane takes its column's pos and neg byte of
//   byte-row kr/8, keeps the nibble of rows kr..kr+3, spreads its 4 bits
//   into 4 bytes ((nib * 0x00204081) & 0x01010101: the four partial
//   products lie in disjoint bit ranges, so nothing carries) and forms
//   w = pos - neg per byte (__vsub4, no borrow between bytes). Both bits
//   set gives 0, as the reference's pos - neg does. The CiM policy then
//   takes |w| = w & 0x01010101 exactly as for int8 codes.
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
constexpr int kXRowBytes = kStageRows + 16;  // x row stride in a stage

// One chunk of CW bytes (16 or 1) from device memory to shared memory;
// a chunk that is not valid is zero-filled (src-size 0 for cp.async).
template <int CW>
__device__ __forceinline__ void copy_chunk(uint8_t* dst, const void* src,
                                           bool valid) {
  if constexpr (CW == 16) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(valid ? 16 : 0));
  } else {
    *dst = valid ? *static_cast<const uint8_t*>(src) : 0;
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

// ---------------------------------------------------------------------------
// weight sources: fetch<CW>(ws, n0, n_end, k0, k_end, lane) stages the w
// part of the stage at K rows k0.. (rows at or past k_end, columns at or
// past n_end read as zero); w_frag(ws, kr, col) is the A fragment word
// ---------------------------------------------------------------------------

// int8 codes (K, N), row stride ld
struct DenseCodes {
  const int8_t* w;
  int ld;

  static constexpr int kBytes = (kStageRows + kStageRows / 8) * kCols;

  // byte offset of staged w row r: 16 bytes a row, a 16-byte pad per 8 rows
  __device__ static __forceinline__ int row(int r) { return (r + (r >> 3)) * kCols; }

  template <int CW>
  __device__ __forceinline__ void fetch(uint8_t* ws, int n0, int n_end, int k0,
                                        int k_end, int lane) const {
    constexpr int kChunks = kCols / CW;
    for (int e = lane; e < kStageRows * kChunks; e += 32) {
      const int r = e / kChunks;
      const int c = (e - r * kChunks) * CW;
      const int k = k0 + r;
      const int n = n0 + c;
      const bool ok = k < k_end && n < n_end;
      copy_chunk<CW>(ws + row(r) + c, ok ? w + static_cast<size_t>(k) * ld + n : w, ok);
    }
  }

  __device__ static __forceinline__ uint32_t w_frag(const uint8_t* ws, int kr,
                                                    int col) {
    const uint8_t* p = ws + row(kr) + (col & ~3);
    const uint32_t r0 = *reinterpret_cast<const uint32_t*>(p);
    const uint32_t r1 = *reinterpret_cast<const uint32_t*>(p + kCols);
    const uint32_t r2 = *reinterpret_cast<const uint32_t*>(p + 2 * kCols);
    const uint32_t r3 = *reinterpret_cast<const uint32_t*>(p + 3 * kCols);
    const unsigned c = col & 3;
    const unsigned sel = c | ((c + 4) << 4);  // byte c of the first, of the second
    return __byte_perm(__byte_perm(r0, r1, sel), __byte_perm(r2, r3, sel), 0x5410);
  }
};

constexpr int kPlaneRows = kStageRows / 8;  // byte-rows of one plane per stage

// w rows kr..kr+3 of one column from its pos and neg bytes (bits kr%8..)
__device__ __forceinline__ uint32_t plane_word(uint32_t pos, uint32_t neg, int kr) {
  const uint32_t p = ((pos >> (kr & 4)) & 0xFu) * 0x00204081u;
  const uint32_t q = ((neg >> (kr & 4)) & 0xFu) * 0x00204081u;
  return __vsub4(p & 0x01010101u, q & 0x01010101u);
}

// the stored planes: two (rows, *) uint8 arrays, row strides ldp and ldn;
// staged as pos byte-rows 0..7, then neg byte-rows 0..7, 16 bytes each
struct PlanePair {
  const uint8_t* pos;
  const uint8_t* neg;
  int ldp, ldn, rows;

  static constexpr int kBytes = 2 * kPlaneRows * kCols;

  template <int CW>
  __device__ __forceinline__ void fetch(uint8_t* ws, int n0, int n_end, int k0,
                                        int k_end, int lane) const {
    constexpr int kChunks = kCols / CW;
    for (int e = lane; e < 2 * kPlaneRows * kChunks; e += 32) {
      const int sr = e / kChunks;  // staged byte-row: plane sr / 8, row sr % 8
      const int c = (e - sr * kChunks) * CW;
      const bool is_neg = sr >= kPlaneRows;
      const int r = k0 / 8 + sr - (is_neg ? kPlaneRows : 0);
      const int n = n0 + c;
      const bool ok = r < rows && 8 * r < k_end && n < n_end;
      const uint8_t* base = is_neg ? neg : pos;
      const size_t off = static_cast<size_t>(r) * (is_neg ? ldn : ldp) + n;
      copy_chunk<CW>(ws + sr * kCols + c, ok ? base + off : base, ok);
    }
  }

  __device__ static __forceinline__ uint32_t w_frag(const uint8_t* ws, int kr,
                                                    int col) {
    const int at = (kr >> 3) * kCols + col;
    return plane_word(ws[at], ws[kPlaneRows * kCols + at], kr);
  }
};

// plane layout 1: one (rows, *) uint8 array, row stride ld, byte-row 2r =
// pos byte-row r, 2r+1 = neg byte-row r; staged as its 16 byte-rows
struct Interleaved {
  const uint8_t* w;
  int ld, rows;

  static constexpr int kBytes = 2 * kPlaneRows * kCols;

  template <int CW>
  __device__ __forceinline__ void fetch(uint8_t* ws, int n0, int n_end, int k0,
                                        int k_end, int lane) const {
    constexpr int kChunks = kCols / CW;
    for (int e = lane; e < 2 * kPlaneRows * kChunks; e += 32) {
      const int sr = e / kChunks;
      const int c = (e - sr * kChunks) * CW;
      const int r = k0 / 4 + sr;  // interleaved byte-row: plane byte-row r / 2
      const int n = n0 + c;
      const bool ok = r < rows && 8 * (r >> 1) < k_end && n < n_end;
      copy_chunk<CW>(ws + sr * kCols + c,
                     ok ? w + static_cast<size_t>(r) * ld + n : w, ok);
    }
  }

  __device__ static __forceinline__ uint32_t w_frag(const uint8_t* ws, int kr,
                                                    int col) {
    const int at = 2 * (kr >> 3) * kCols + col;
    return plane_word(ws[at], ws[at + kCols], kr);
  }
};

// ---------------------------------------------------------------------------
// x staging, fragments and MMAs
// ---------------------------------------------------------------------------

template <class Src, int MT>
constexpr int kSlotBytes = Src::kBytes + MT * kXRowBytes;  // one ring slot

// Stage x rows m0..m0+MT-1 at K k0..k0+63 (columns at or past k_end and
// rows at or past M read as zero).
template <int MT, int CW>
__device__ __forceinline__ void fetch_x(uint8_t* xs, const int8_t* x, int M,
                                        int K, int m0, int k0, int k_end,
                                        int lane) {
  constexpr int kChunks = kStageRows / CW;
  for (int e = lane; e < MT * kChunks; e += 32) {
    const int r = e / kChunks;
    const int c = (e - r * kChunks) * CW;
    const int m = m0 + r;
    const int k = k0 + c;
    const bool ok = m < M && k < k_end;
    copy_chunk<CW>(xs + r * kXRowBytes + c,
                   ok ? x + static_cast<size_t>(m) * K + k : x, ok);
  }
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

// ---------------------------------------------------------------------------
// MAC policies: stage<Src, MT>(acc, slot, lane) adds one staged K slice
// into the warp's fragments acc[j] (x rows j*8.. of the tile)
// ---------------------------------------------------------------------------

// The clamped CiM MAC: per 16-row block and 8 x rows, two k16 MMAs give
// p = x.w and m = |x|.|w| (|v| = v & 1 for a ternary code); a = (m+p)>>1
// and b = (m-p)>>1 exactly (m+p = 2a), and min(a, adc_max) -
// min(b, adc_max) is added into the running int32 fragment.
struct CimMac {
  int adc_max;

  template <class Src, int MT>
  __device__ __forceinline__ void stage(int (&acc)[MT / 8][4], const uint8_t* slot,
                                        int lane) const {
    const int g = lane >> 2;
    const int t = lane & 3;
    const uint8_t* xs = slot + Src::kBytes;
#pragma unroll
    for (int kk = 0; kk < kStageRows; kk += kBlock) {
      const uint32_t a0 = Src::w_frag(slot, kk + t * 4, g);
      const uint32_t a1 = Src::w_frag(slot, kk + t * 4, g + 8);
      const uint32_t u0 = a0 & 0x01010101u;  // |w| of a ternary code
      const uint32_t u1 = a1 & 0x01010101u;
#pragma unroll
      for (int j = 0; j < MT / 8; ++j) {
        const uint32_t b = x_frag(xs, j * 8 + g, kk + t * 4);
        int p[4], m[4];
        mma_k16(p, a0, a1, b);
        mma_k16(m, u0, u1, b & 0x01010101u);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int a = (m[i] + p[i]) >> 1;
          const int bb = (m[i] - p[i]) >> 1;
          acc[j][i] += min(a, adc_max) - min(bb, adc_max);
        }
      }
    }
  }
};

// The exact dot: a k32 MMA per 32 K rows and 8 x rows, accumulating in
// int32 (exact: |partial| <= K < 2^31).
struct ExactMac {
  template <class Src, int MT>
  __device__ __forceinline__ void stage(int (&acc)[MT / 8][4], const uint8_t* slot,
                                        int lane) const {
    const int g = lane >> 2;
    const int t = lane & 3;
    const uint8_t* xs = slot + Src::kBytes;
#pragma unroll
    for (int kk = 0; kk < kStageRows; kk += 32) {
      const uint32_t a0 = Src::w_frag(slot, kk + t * 4, g);
      const uint32_t a1 = Src::w_frag(slot, kk + t * 4, g + 8);
      const uint32_t a2 = Src::w_frag(slot, kk + 16 + t * 4, g);
      const uint32_t a3 = Src::w_frag(slot, kk + 16 + t * 4, g + 8);
#pragma unroll
      for (int j = 0; j < MT / 8; ++j)
        mma_k32(acc[j], a0, a1, a2, a3, x_frag(xs, j * 8 + g, kk + t * 4),
                x_frag(xs, j * 8 + g, kk + 16 + t * 4));
    }
  }
};

// ---------------------------------------------------------------------------
// the kernel and its launch
// ---------------------------------------------------------------------------

// One block of the grid. Fragment element i of lane (g, t) is output
// column g + 8*(i/2), x row t*2 + i%2.
template <class Mac, class Src, int MT, int CW, typename OutT, int RING>
__global__ void __launch_bounds__(kThreads)
tile_kernel(const int8_t* __restrict__ x, Src src, OutT* __restrict__ out, int M,
            int K, int N, Mac mac) {
  __shared__ __align__(16) uint8_t ring[kWarps][RING][kSlotBytes<Src, MT>];
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
    uint8_t* slot = ring[warp][i % RING];
    const int k0 = k_lo + (warp + i * kWarps) * kStageRows;
    src.template fetch<CW>(slot, n0, N, k0, k_hi, lane);
    fetch_x<MT, CW>(slot + Src::kBytes, x, M, K, m0, k0, k_hi, lane);
  };
#pragma unroll
  for (int i = 0; i < RING - 1; ++i) {
    if (i < mine) fetch(i);
    cp_async_commit();
  }
  for (int i = 0; i < mine; ++i) {
    // refill the slot consumed at i-1 (the __syncwarp below freed it)
    if (i + RING - 1 < mine) fetch(i + RING - 1);
    cp_async_commit();
    cp_async_wait<RING - 1>();  // this lane's copies of stage i landed
    __syncwarp();               // ... and every lane's
    mac.template stage<Src, MT>(acc, ring[warp][i % RING], lane);
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
      if (m < M && n < N) out[static_cast<size_t>(m) * N + n] = static_cast<OutT>(tile[e]);
    }
  }
}

template <class Mac, class Src, int MT, int CW, typename OutT, int RING = kRing>
int launch_cw(const void* x, const Src& src, void* out, int M, int K, int N,
              int cluster, Mac mac, void* stream) {
  if (cluster < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kCols - 1) / kCols, (M + MT - 1) / MT, cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = cluster;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, tile_kernel<Mac, Src, MT, CW, OutT, RING>,
      static_cast<const int8_t*>(x), src, static_cast<OutT*>(out), M, K, N, mac);
  const cudaError_t last = cudaGetLastError();  // clears a refused launch
  return static_cast<int>(err != cudaSuccess ? err : last);
}

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The launch for MT x rows per block, a cluster of `cluster` blocks
// splitting K, and 16-byte copies where `wide`, else byte copies. Returns
// the CUDA error of the launch (0 on success).
template <class Mac, class Src, int MT, typename OutT>
int launch_rows(const void* x, const Src& src, void* out, int M, int K, int N,
                int cluster, bool wide, Mac mac, void* stream) {
  return wide ? launch_cw<Mac, Src, MT, 16, OutT>(x, src, out, M, K, N, cluster, mac, stream)
              : launch_cw<Mac, Src, MT, 1, OutT>(x, src, out, M, K, N, cluster, mac, stream);
}

// launch_rows for `rows_per_block` (8 or 32) chosen at run time.
template <class Mac, class Src, typename OutT>
int launch_src(const void* x, const Src& src, void* out, int M, int K, int N,
               int rows_per_block, int cluster, bool wide, Mac mac, void* stream) {
  if (rows_per_block == 8)
    return launch_rows<Mac, Src, 8, OutT>(x, src, out, M, K, N, cluster, wide, mac, stream);
  if (rows_per_block == 32)
    return launch_rows<Mac, Src, 32, OutT>(x, src, out, M, K, N, cluster, wide, mac, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The dense-code launch of #1 and #5: x (M, K), w (K, N) int8 codes, f32
// out; the copy width follows the operands' alignment.
template <class Mac>
int launch(const void* x, const void* w, void* out, int M, int K, int N,
           int rows_per_block, int cluster, Mac mac, void* stream) {
  const bool wide = N % 16 == 0 && K % 16 == 0 && aligned(x, 16) && aligned(w, 16);
  return launch_src<Mac, DenseCodes, float>(
      x, DenseCodes{static_cast<const int8_t*>(w), N}, out, M, K, N, rows_per_block,
      cluster, wide, mac, stream);
}

}  // namespace ternary_tile
