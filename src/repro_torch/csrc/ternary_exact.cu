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
// 16-byte cp.async ring and the fragment transpose are in
// ternary_tile.cuh, shared with ternary_mac.cu): the function is a plain
// int8 product, so every 32 K rows of a stage are one int8 tensor-core
// MMA per 8 x rows, mma.sync m16n8k32 s8.s8.s32 (IMMA in the SASS),
// accumulating in int32: exact, since |partial| <= K < 2^31. The sums are
// converted to f32 once, at the store. The grid (16-column tiles, K split
// over a cluster of up to 8 blocks) gives 144-192 blocks at the
// smollm-135m shapes with N >= 576 (96 at N = 192). Its times beside
// torch.mm on the same values are in PERF.md.
#include "ternary_tile.cuh"

namespace {

using namespace ternary_tile;

struct ExactMac {
  // one stage: a k32 MMA per 32 K rows and 8 x rows
  template <int MT>
  __device__ __forceinline__ void stage(int (&acc)[MT / 8][4], const uint8_t* slot,
                                        int lane) const {
    const int g = lane >> 2;
    const int t = lane & 3;
    const uint8_t* xs = slot + kWStageBytes;
#pragma unroll
    for (int kk = 0; kk < kStageRows; kk += 32) {
      const uint32_t a0 = w_frag(slot, kk + t * 4, g);
      const uint32_t a1 = w_frag(slot, kk + t * 4, g + 8);
      const uint32_t a2 = w_frag(slot, kk + 16 + t * 4, g);
      const uint32_t a3 = w_frag(slot, kk + 16 + t * 4, g + 8);
#pragma unroll
      for (int j = 0; j < MT / 8; ++j)
        mma_k32(acc[j], a0, a1, a2, a3, x_frag(xs, j * 8 + g, kk + t * 4),
                x_frag(xs, j * 8 + g, kk + 16 + t * 4));
    }
  }
};

}  // namespace

// x: (M, K) int8, w: (K, N) int8, out: (M, N) f32, all contiguous on the
// current device. rows_per_block: the M tile (8: decode, 32: prefill);
// cluster: the blocks that split K (grid z, one cluster). Returns the
// CUDA error of the launch (0 on success).
extern "C" int ternary_exact_mac(const void* x, const void* w, void* out, int M,
                                 int K, int N, int rows_per_block, int cluster,
                                 void* stream) {
  return launch(x, w, out, M, K, N, rows_per_block, cluster, ExactMac{}, stream);
}
