// Streaming signed-ternary CiM MAC from ONE plane-interleaved array, for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/packed_mac.py::packed_cim_matmul_decode_stream,
// the Pallas TPU kernel (body _packed_decode_stream_kernel) that the
// stream spec's execute_packed runs at decode M (<= 8).
//
// The weight is one (rows, *) uint8 array in plane layout 1: byte-row 2r
// is pos byte-row r and 2r+1 is neg byte-row r, where bit j of pos/neg
// byte-row r is K row 8r+j, and w = pos - neg (both bits set is 0). A
// 16-deep K block b is the four byte-rows 4b..4b+3 (pos lo, neg lo, pos
// hi, neg hi), so one contiguous run of byte-rows holds both planes of a
// K range. The MAC is packed_mac.cu's exactly: for each block, the event
// counts a and b of w, summed as min(a, adc_max) - min(b, adc_max)
// (cim=1) or a - b (cim=0) in int32, so the output is bit-identical to
// packed_cim_matmul_decode's. Output int32 (M, N).
//
// What bounds it on the H100: the plane read, 2 bits per weight at
// 3.35 TB/s (the same bytes as the decode kernel of packed_mac.cu); at
// 0.1-0.5 MB a call, latency sets the time.
//
// What the design does about it: the kernel is
// tile_kernel<CimMac|ExactMac, Interleaved, 8, 16, int32_t, NBUF> of
// ternary_tile.cuh, so it shares #1's grid (16-column tiles, K split over
// a cluster of up to 8 blocks: 96-192 blocks at the smollm-135m shapes),
// its int8 mma.sync MACs and its per-warp cp.async rings. The stream
// kernel's ring depth nbuf in {2, 3} is the depth of each warp's ring
// (two compiled instances). A 64-row stage of the weight is one
// contiguous run of 16 layout-1 byte-rows, 16 copies of 16 bytes that
// bring both planes at once, beside the stage's x tile (8 rows x 64
// bytes). x is staged per stage, so K is not limited by shared memory.
// What stands in for the Pallas kernel's pinned 2 dma_start / 1
// dma_wait: the copies are cp.async (LDGSTS in the SASS) with one commit
// group per stage (LDGDEPBAR) and a wait_group nbuf-1 before each
// stage's MAC (DEPBAR): stages i+1 .. i+nbuf-1 of a warp are in flight
// while stage i's MMAs run. chip_smoke.py checks the three in the SASS of
// every instance. Only 16-byte copies are compiled: the wrapper checks
// the array's pointer, row stride and width, and x's pointer and K, are
// multiples of 16 bytes.
#include "ternary_tile.cuh"

using namespace ternary_tile;

// x: (M <= 8, kx) int8 contiguous, kx a multiple of 16; w_int: (rows, *)
// uint8 in plane layout 1, unit column stride, row stride ld; out:
// (M, N) int32 contiguous, N the logical columns. nbuf: ring slots per
// warp (2 or 3); cluster: the blocks that split K (grid z, one cluster).
// Returns the CUDA error of the launch (0 on success).
extern "C" int packed_stream_mac(const void* x, const void* w_int, void* out,
                                 int M, int kx, int rows, int ld, int N,
                                 int adc_max, int cim, int nbuf, int cluster,
                                 void* stream) {
  if (M > 8 || kx % 16 != 0 || ld % 16 != 0 || !aligned(x, 16) || !aligned(w_int, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const Interleaved src{static_cast<const uint8_t*>(w_int), ld, rows};
  const CimMac clamp{adc_max};
  if (nbuf == 2)
    return cim ? launch_cw<CimMac, Interleaved, 8, 16, int32_t, 2>(
                     x, src, out, M, kx, N, cluster, clamp, stream)
               : launch_cw<ExactMac, Interleaved, 8, 16, int32_t, 2>(
                     x, src, out, M, kx, N, cluster, ExactMac{}, stream);
  if (nbuf == 3)
    return cim ? launch_cw<CimMac, Interleaved, 8, 16, int32_t, 3>(
                     x, src, out, M, kx, N, cluster, clamp, stream)
               : launch_cw<ExactMac, Interleaved, 8, 16, int32_t, 3>(
                     x, src, out, M, kx, N, cluster, ExactMac{}, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
