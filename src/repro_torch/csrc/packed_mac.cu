// Signed-ternary CiM MAC from the stored 2-bit (M1, M2) bitplanes, for
// Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of src/repro/kernels/packed_mac.py:
//   * packed_cim_matmul (body _packed_kernel): prefill-class M, f32
//     output — packed_cim_mac below, on the tile machinery of
//     ternary_tile.cuh;
//   * packed_cim_matmul_decode (body _packed_decode_kernel): M <= 8,
//     int32 output — packed_decode_mac below, a popcount kernel.
//
// The planes are (rows, *) uint8 with bit j of byte-row r = K row 8r+j
// (the SiTe cell's differential storage, 2 bits per ternary weight); the
// weight is w = pos - neg, so a weight with both bits set is 0, as in the
// reference. Both kernels compute, for each 16-deep K block, the event
// counts a = #(x=+1,w=+1) + #(x=-1,w=-1) and b = #(x=+1,w=-1) +
// #(x=-1,w=+1), and sum min(a, adc_max) - min(b, adc_max) (cim=1) or
// a - b (cim=0, the exact dot).
//
// What bounds it on the H100: at the serving shapes the work is a few
// MOPs per call, so the bound is the bytes: the plane read, 2 bits per
// weight (K*N/4 bytes), at decode; x (M*K bytes) at prefill M. At 0.1-1 MB
// a call, though, what sets the time is latency: how many SMs have work
// and how many bytes each keeps in flight.
//
// What the designs do about it.
//   * #4 is tile_kernel<CimMac|ExactMac, PlanePair, MT, CW, float> of
//     ternary_tile.cuh: the grid, the K split over a cluster
//     (kernels/plan.py::launch_plan), the per-warp 16-byte cp.async rings
//     and the int8 mma.sync MACs of #1 and #5, with the weight arriving
//     as bits. A 64-row stage holds 8 byte-rows of each plane (16 copies
//     of 16 bytes) beside its x tile; each lane turns its column's pos
//     and neg bytes into the int8 fragment word of 4 K rows (nibble
//     spread, then pos - neg per byte). The stage depth is #1's, 64 K
//     rows: a cluster rank's K range at the served shapes is 288-1536
//     rows at M = 128 (64-384 at decode, for #3), so 64-row stages give
//     all 4 warps of a block work at the shortest range, and a warp's
//     3-slot ring keeps 192 rows in flight; 256-row stages (1 KB of
//     planes) would leave 2-3 of the 4 warps idle at k, v and the decode
//     shapes, and cost 4x the x tile of shared memory at prefill.
//     Row strides are arguments, so the de-interleaved views of plane
//     layout 1 (row stride 2*ld, neg offset by ld) are read in place.
//     Shapes whose pointers, strides or column extent are not multiples
//     of 16 bytes take the byte-copy instance (CW = 1).
//   * #2 gives a block 32 output columns, one per lane; a lane reads its
//     column's two plane bytes per K block (coalesced along N across the
//     warp), the block's 16 warps split the K blocks between them and add
//     their integer partials in shared memory; x is staged once per block
//     as pos/neg masks and the inner loop is popcounts. Each weight's
//     bits are masked to w+ = pos & ~neg and w- = neg & ~pos at the load,
//     so overlapping planes count as the reference's pos - neg.
//
// Both read only x's K extent (the K loop ends at x's last 16-block, so
// the canonical K pad of the planes is never read) and store only the
// logical N columns.
#include "ternary_tile.cuh"

namespace {

using namespace ternary_tile;

constexpr int kDecodeRows = 8;   // rows of x: the decode class
constexpr int kDecodeCols = 32;  // output columns per block: one per lane
constexpr int kDecodeWarps = 16;  // warps splitting the K blocks
constexpr int kChunk = 64;       // 16-row K blocks of x staged per pass

__global__ void __launch_bounds__(32 * kDecodeWarps)
packed_decode_kernel(const int8_t* __restrict__ x,
                     const uint8_t* __restrict__ wpos,
                     const uint8_t* __restrict__ wneg, int32_t* __restrict__ out,
                     int M, int kx, int rows, int ldp, int ldn, int N,
                     int adc_max, int cim) {
  __shared__ uint16_t xpos[kDecodeRows][kChunk];
  __shared__ uint16_t xneg[kDecodeRows][kChunk];
  __shared__ int partial[kDecodeWarps][kDecodeRows][kDecodeCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * kDecodeCols + lane;
  // x is zero past kx, so later K blocks add nothing: stop at x's last
  // block and leave the canonical K pad rows of the planes unread
  const int kb_total = min((rows + 1) / 2, (kx + 15) / 16);

  int acc[kDecodeRows];
#pragma unroll
  for (int r = 0; r < kDecodeRows; ++r) acc[r] = 0;

  for (int kb0 = 0; kb0 < kb_total; kb0 += kChunk) {
    const int nkb = min(kChunk, kb_total - kb0);
    __syncthreads();
    for (int e = threadIdx.x; e < kDecodeRows * nkb; e += 32 * kDecodeWarps) {
      const int r = e / nkb;
      const int b = e - r * nkb;
      uint32_t p = 0, q = 0;
      if (r < M) {
        const int8_t* row = x + static_cast<size_t>(r) * kx;
        const int kbase = (kb0 + b) * 16;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int k = kbase + j;
          const int v = k < kx ? row[k] : 0;
          p |= static_cast<uint32_t>(v > 0) << j;
          q |= static_cast<uint32_t>(v < 0) << j;
        }
      }
      xpos[r][b] = static_cast<uint16_t>(p);
      xneg[r][b] = static_cast<uint16_t>(q);
    }
    __syncthreads();
    if (n < N) {
      for (int b = warp; b < nkb; b += kDecodeWarps) {
        const int r0 = 2 * (kb0 + b);
        uint32_t bp = wpos[static_cast<size_t>(r0) * ldp + n];
        uint32_t bn = wneg[static_cast<size_t>(r0) * ldn + n];
        if (r0 + 1 < rows) {
          bp |= static_cast<uint32_t>(wpos[static_cast<size_t>(r0 + 1) * ldp + n]) << 8;
          bn |= static_cast<uint32_t>(wneg[static_cast<size_t>(r0 + 1) * ldn + n]) << 8;
        }
        const uint32_t wp = bp & ~bn;  // w = +1: pos and not neg
        const uint32_t wn = bn & ~bp;  // w = -1: neg and not pos
#pragma unroll
        for (int r = 0; r < kDecodeRows; ++r) {
          const uint32_t xp = xpos[r][b];
          const uint32_t xn = xneg[r][b];
          const int a = __popc(xp & wp) + __popc(xn & wn);
          const int bb = __popc(xp & wn) + __popc(xn & wp);
          acc[r] += cim ? min(a, adc_max) - min(bb, adc_max) : a - bb;
        }
      }
    }
  }
  // add the warps' integer partials (exact in any order)
#pragma unroll
  for (int r = 0; r < kDecodeRows; ++r) partial[warp][r][lane] = acc[r];
  __syncthreads();
  for (int e = threadIdx.x; e < kDecodeRows * kDecodeCols; e += 32 * kDecodeWarps) {
    const int r = e / kDecodeCols;
    const int c = e - r * kDecodeCols;
    const int col = blockIdx.x * kDecodeCols + c;
    if (r < M && col < N) {
      int sum = 0;
#pragma unroll
      for (int v = 0; v < kDecodeWarps; ++v) sum += partial[v][r][c];
      out[static_cast<size_t>(r) * N + col] = sum;
    }
  }
}

}  // namespace

// #4. x: (M, kx) int8 contiguous; w_pos/w_neg: (rows, width) uint8 with
// unit column stride and row strides ldp/ldn; out: (M, N) f32
// contiguous, N <= width the logical columns. rows_per_block: the M tile
// (8 or 32); cluster: the blocks that split K (grid z, one cluster).
// Returns the CUDA error of the launch (0 on success).
extern "C" int packed_cim_mac(const void* x, const void* w_pos, const void* w_neg,
                              void* out, int M, int kx, int rows, int ldp, int ldn,
                              int width, int N, int adc_max, int cim,
                              int rows_per_block, int cluster, void* stream) {
  const PlanePair src{static_cast<const uint8_t*>(w_pos),
                      static_cast<const uint8_t*>(w_neg), ldp, ldn, rows};
  // a 16-byte copy at column tile n0 reads n0..n0+15 < width
  const bool wide = (N + kCols - 1) / kCols * kCols <= width && ldp % 16 == 0 &&
                    ldn % 16 == 0 && kx % 16 == 0 && aligned(x, 16) &&
                    aligned(w_pos, 16) && aligned(w_neg, 16);
  if (cim)
    return launch_src<CimMac, PlanePair, float>(x, src, out, M, kx, N, rows_per_block,
                                                cluster, wide, CimMac{adc_max}, stream);
  return launch_src<ExactMac, PlanePair, float>(x, src, out, M, kx, N, rows_per_block,
                                                cluster, wide, ExactMac{}, stream);
}

// #2. x: (M <= 8, kx) int8 contiguous; w_pos/w_neg: (rows, *) uint8 with
// unit column stride and row strides ldp/ldn; out: (M, N) int32
// contiguous. Returns cudaGetLastError() after the launch.
extern "C" int packed_decode_mac(const void* x, const void* w_pos, const void* w_neg,
                                 void* out, int M, int kx, int rows, int ldp, int ldn,
                                 int N, int adc_max, int cim, void* stream) {
  if (M > kDecodeRows) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + kDecodeCols - 1) / kDecodeCols);
  packed_decode_kernel<<<grid, 32 * kDecodeWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const uint8_t*>(w_pos),
      static_cast<const uint8_t*>(w_neg), static_cast<int32_t*>(out), M, kx, rows, ldp,
      ldn, N, adc_max, cim);
  return static_cast<int>(cudaGetLastError());
}
