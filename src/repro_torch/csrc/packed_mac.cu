// Signed-ternary CiM MAC from the stored 2-bit (M1, M2) bitplanes, for
// Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of src/repro/kernels/packed_mac.py:
//   * packed_cim_matmul (body _packed_kernel): prefill-class M, f32
//     output — packed_cim_mac below (#4);
//   * packed_cim_matmul_decode (body _packed_decode_kernel): M <= 8,
//     int32 output — packed_decode_mac below (#2).
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
// What the design does about it: both kernels are the PlanePair instances
// of tile_kernel in ternary_tile.cuh, #4 =
// tile_kernel<CimMac|ExactMac, PlanePair, 8|32, 16|1, float> and #2 =
// tile_kernel<CimMac|ExactMac, PlanePair, 8, 16|1, int32_t>: the grid, the
// K split over a cluster (kernels/plan.py::launch_plan), the per-warp
// 16-byte cp.async rings and the int8 mma.sync MACs of #1 and #5, with
// the weight arriving as bits. #2 is #4's 8-row tile with the int32
// store of #3, so at decode M the three plane kernels run one code path
// (#2 and #3 differ only in how a stage's plane bytes are fetched) and
// are bit-identical by construction. A 64-row stage holds 8 byte-rows of
// each plane (16 copies of 16 bytes) beside its x tile; each lane turns
// its column's pos and neg bytes into the int8 fragment word of 4 K rows
// (nibble spread, then pos - neg per byte, so overlapping planes read as
// the reference's pos - neg with no mask). The stage depth is #1's, 64 K
// rows: a cluster rank's K range at the served shapes is 288-1536 rows
// at M = 128 and 64-384 at decode, so 64-row stages give all 4 warps of
// a block work at the shortest range, and a warp's 3-slot ring keeps 192
// rows in flight; 256-row stages (1 KB of planes) would leave 2-3 of the
// 4 warps idle at k, v and the decode shapes, and cost 4x the x tile of
// shared memory at prefill. Row strides are arguments, so the
// de-interleaved views of plane layout 1 (row stride 2*ld, neg offset by
// ld) are read in place. Shapes whose pointers, strides or column extent
// are not multiples of 16 bytes take the byte-copy instance (CW = 1).
//
// Both read only x's K extent (the K loop ends at x's last 16-block, so
// the canonical K pad of the planes is never read) and store only the
// logical N columns.
#include "ternary_tile.cuh"

using namespace ternary_tile;

namespace {

// a 16-byte copy at column tile n0 reads n0..n0+15 < width
bool planes_wide(const void* x, const void* w_pos, const void* w_neg, int kx,
                 int ldp, int ldn, int width, int N) {
  return (N + kCols - 1) / kCols * kCols <= width && ldp % 16 == 0 && ldn % 16 == 0 &&
         kx % 16 == 0 && aligned(x, 16) && aligned(w_pos, 16) && aligned(w_neg, 16);
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
  const bool wide = planes_wide(x, w_pos, w_neg, kx, ldp, ldn, width, N);
  if (cim)
    return launch_src<CimMac, PlanePair, float>(x, src, out, M, kx, N, rows_per_block,
                                                cluster, wide, CimMac{adc_max}, stream);
  return launch_src<ExactMac, PlanePair, float>(x, src, out, M, kx, N, rows_per_block,
                                                cluster, wide, ExactMac{}, stream);
}

// #2. x: (M <= 8, kx) int8 contiguous; w_pos/w_neg as for #4; out: (M, N)
// int32 contiguous. cluster: the blocks that split K. Returns the CUDA
// error of the launch (0 on success).
extern "C" int packed_decode_mac(const void* x, const void* w_pos, const void* w_neg,
                                 void* out, int M, int kx, int rows, int ldp, int ldn,
                                 int width, int N, int adc_max, int cim, int cluster,
                                 void* stream) {
  if (M > 8) return static_cast<int>(cudaErrorInvalidValue);
  const PlanePair src{static_cast<const uint8_t*>(w_pos),
                      static_cast<const uint8_t*>(w_neg), ldp, ldn, rows};
  const bool wide = planes_wide(x, w_pos, w_neg, kx, ldp, ldn, width, N);
  if (cim)
    return launch_rows<CimMac, PlanePair, 8, int32_t>(x, src, out, M, kx, N, cluster,
                                                      wide, CimMac{adc_max}, stream);
  return launch_rows<ExactMac, PlanePair, 8, int32_t>(x, src, out, M, kx, N, cluster,
                                                      wide, ExactMac{}, stream);
}
