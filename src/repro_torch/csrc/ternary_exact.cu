// Exact signed-ternary matmul on dense int8 codes (the near-memory
// baseline), for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ternary_mac.py::ternary_exact_matmul, the
// Pallas TPU kernel (body _exact_mac_kernel) that every quantized dense
// layer reaches when the model serves under the exact/pallas spec (the
// paper's NM array).
//
// Computes out = x @ w for x (M, K) and w (K, N) with values in
// {-1, 0, +1}: the full-depth exact dot, no per-block ADC clamp. Output
// f32 (M, N); |out| <= K, so every value is an exact integer.
//
// What bounds it on the H100: at the serving shapes (decode M <= 8,
// prefill M <= a few hundred; K, N <= 1536) the work is a few MOPs per
// call, so the bound is the weight read: K*N int8 bytes at 3.35 TB/s.
// At 0.1-1 MB a call, though, what sets the time is latency: how many
// SMs have work and how many bytes each keeps in flight.
//
// What the design does about it (the grid, the cluster K split, the
// 16-byte cp.async ring, the fragment transpose of the DenseCodes source
// and the ExactMac policy are in ternary_tile.cuh, shared with the other
// tile kernels): the function is a plain int8 product, so every 32 K
// rows of a stage are one int8 tensor-core MMA per 8 x rows, mma.sync
// m16n8k32 s8.s8.s32 (IMMA in the SASS), accumulating in int32: exact,
// since |partial| <= K < 2^31. The sums are converted to f32 once, at
// the store. The grid (16-column tiles, K split
// over a cluster of up to 8 blocks) gives 144-192 blocks at the
// smollm-135m shapes with N >= 576 (96 at N = 192). Its times beside
// torch.mm on the same values are in PERF.md.
#include "ternary_tile.cuh"

using namespace ternary_tile;

// x: (M, K) int8, w: (K, N) int8, out: (M, N) f32, all contiguous on the
// current device. rows_per_block: the M tile (8: decode, 32: prefill);
// cluster: the blocks that split K (grid z, one cluster). Returns the
// CUDA error of the launch (0 on success).
extern "C" int ternary_exact_mac(const void* x, const void* w, void* out, int M,
                                 int K, int N, int rows_per_block, int cluster,
                                 void* stream) {
  return launch(x, w, out, M, K, N, rows_per_block, cluster, ExactMac{}, stream);
}
