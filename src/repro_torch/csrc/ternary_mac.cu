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
//
// What the design does about it: each weight byte is read from device
// memory once and turned into 16-bit pos/neg masks in registers; x is
// staged once per block in shared memory as pos/neg masks, so the inner
// loop is popcounts on registers with integer accumulators (exact, no
// float rounding). A block owns 32 output columns, one per lane, so a
// warp reads 32 neighbouring weight bytes per K row (coalesced); the
// block's warps split the K blocks between them (8-16x more loads in
// flight than one warp per column group, which is what decode widths
// need) and add their integer partials in shared memory, so the result
// is independent of the split. The K loop lives inside the block: no
// cross-block reduction, no output revisiting. Ragged M, N and K are
// masked here, so callers pass the logical extents. Still simple: byte
// loads, no TMA ring, no tensor cores (see PERF.md for its times).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 16;  // rows asserted per CiM cycle (N_A)
constexpr int kCols = 32;   // output columns per block: one per lane
constexpr int kChunk = 64;  // 16-row K blocks of x staged per pass

// MT rows of x per block; WARPS warps split the K blocks.
template <int MT, int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
cim_mac_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
               float* __restrict__ out, int M, int K, int N, int adc_max) {
  __shared__ uint16_t xpos[MT][kChunk];
  __shared__ uint16_t xneg[MT][kChunk];
  __shared__ int partial[WARPS][MT][kCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * kCols + lane;
  const int m0 = blockIdx.y * MT;
  const int kb_total = (K + kBlock - 1) / kBlock;

  int acc[MT];
#pragma unroll
  for (int r = 0; r < MT; ++r) acc[r] = 0;

  for (int kb0 = 0; kb0 < kb_total; kb0 += kChunk) {
    const int nkb = min(kChunk, kb_total - kb0);
    __syncthreads();  // the previous chunk's masks are consumed
    for (int e = threadIdx.x; e < MT * nkb; e += 32 * WARPS) {
      const int r = e / nkb;
      const int b = e - r * nkb;
      const int m = m0 + r;
      uint32_t p = 0, q = 0;
      if (m < M) {
        const int8_t* row = x + static_cast<size_t>(m) * K;
        const int kbase = (kb0 + b) * kBlock;
#pragma unroll
        for (int j = 0; j < kBlock; ++j) {
          const int k = kbase + j;
          const int v = k < K ? row[k] : 0;
          p |= static_cast<uint32_t>(v > 0) << j;
          q |= static_cast<uint32_t>(v < 0) << j;
        }
      }
      xpos[r][b] = static_cast<uint16_t>(p);
      xneg[r][b] = static_cast<uint16_t>(q);
    }
    __syncthreads();
    if (n < N) {
      for (int b = warp; b < nkb; b += WARPS) {
        const int kbase = (kb0 + b) * kBlock;
        uint32_t wp = 0, wn = 0;
#pragma unroll
        for (int j = 0; j < kBlock; ++j) {
          const int k = kbase + j;
          const int v = k < K ? w[static_cast<size_t>(k) * N + n] : 0;
          wp |= static_cast<uint32_t>(v > 0) << j;
          wn |= static_cast<uint32_t>(v < 0) << j;
        }
#pragma unroll
        for (int r = 0; r < MT; ++r) {
          const uint32_t xp = xpos[r][b];
          const uint32_t xn = xneg[r][b];
          const int a = __popc(xp & wp) + __popc(xn & wn);
          const int bb = __popc(xp & wn) + __popc(xn & wp);
          acc[r] += min(a, adc_max) - min(bb, adc_max);
        }
      }
    }
  }
  // add the warps' integer partials (exact in any order)
#pragma unroll
  for (int r = 0; r < MT; ++r) partial[warp][r][lane] = acc[r];
  __syncthreads();
  for (int e = threadIdx.x; e < MT * kCols; e += 32 * WARPS) {
    const int r = e / kCols;
    const int c = e - r * kCols;
    const int m = m0 + r;
    const int col = blockIdx.x * kCols + c;
    if (m < M && col < N) {
      int sum = 0;
#pragma unroll
      for (int v = 0; v < WARPS; ++v) sum += partial[v][r][c];
      out[static_cast<size_t>(m) * N + col] = static_cast<float>(sum);
    }
  }
}

template <int MT, int WARPS>
void launch(const int8_t* x, const int8_t* w, float* out, int M, int K, int N,
            int adc_max, cudaStream_t stream) {
  const dim3 grid((N + kCols - 1) / kCols, (M + MT - 1) / MT);
  cim_mac_kernel<MT, WARPS><<<grid, 32 * WARPS, 0, stream>>>(x, w, out, M, K, N,
                                                              adc_max);
}

}  // namespace

// x: (M, K) int8, w: (K, N) int8, out: (M, N) f32, all contiguous on the
// current device. rows_per_block selects the M tile (8: decode, 32:
// prefill). Returns cudaGetLastError() after the launch.
extern "C" int ternary_cim_mac(const void* x, const void* w, void* out, int M,
                               int K, int N, int adc_max, int rows_per_block,
                               void* stream) {
  const auto* xs = static_cast<const int8_t*>(x);
  const auto* ws = static_cast<const int8_t*>(w);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (rows_per_block == 8) {
    launch<8, 16>(xs, ws, o, M, K, N, adc_max, s);
  } else if (rows_per_block == 32) {
    launch<32, 8>(xs, ws, o, M, K, N, adc_max, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
