// Signed-ternary CiM MAC on dense int8 codes, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ternary_mac.py::ternary_cim_matmul, the
// Pallas TPU kernel (body _cim_mac_kernel) that every quantized dense
// layer of the served model reaches.
//
// Computes, for x (M, K) and w (K, N) with values in {-1, 0, +1} and each
// 16-deep K block: a = #(x=+1,w=+1) + #(x=-1,w=-1), b = #(x=+1,w=-1) +
// #(x=-1,w=+1) (the circuit's discharge-event counts), and sums
// min(a, adc_max) - min(b, adc_max) over the blocks. Output f32 (M, N).
//
// What bounds it on the H100: at the serving shapes (decode M <= 8,
// prefill M <= a few hundred; K, N <= 1536) the work is a few MOPs per
// call, so the bound is the weight read: K*N int8 bytes at 3.35 TB/s.
// At 0.1-1 MB a call, though, what sets the time is latency: how many
// SMs have work and how many bytes each keeps in flight.
//
// What the design does about it (the grid, the cluster K split at 16-row
// block boundaries, the 16-byte cp.async ring, the fragment transpose of
// the DenseCodes source and the CimMac policy are in ternary_tile.cuh,
// shared with the other tile kernels): one 16-deep CiM block is exactly
// one int8 tensor-core MMA, mma.sync m16n8k16 s8.s8.s32 (IMMA in the
// SASS). Two MMAs per block and 8 x rows, each from a zero accumulator,
// give p = x.w and m = |x|.|w| (|v| = v & 1 for a ternary code); then
// a = (m+p)>>1 and b = (m-p)>>1 exactly (m+p = 2a), and min(a, adc_max) -
// min(b, adc_max) is added into a running int32 fragment. Every partial
// is an integer, so the result does not depend on the K split, and is
// converted to f32 once, at the store.
#include "ternary_tile.cuh"

using namespace ternary_tile;

// x: (M, K) int8, w: (K, N) int8, out: (M, N) f32, all contiguous on the
// current device. rows_per_block: the M tile (8: decode, 32: prefill);
// cluster: the blocks that split K (grid z, one cluster). Returns the
// CUDA error of the launch (0 on success).
extern "C" int ternary_cim_mac(const void* x, const void* w, void* out, int M,
                               int K, int N, int adc_max, int rows_per_block,
                               int cluster, void* stream) {
  return launch(x, w, out, M, K, N, rows_per_block, cluster, CimMac{adc_max},
                stream);
}
