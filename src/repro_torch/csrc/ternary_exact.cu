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
// call, so the bound is the weight read: K*N int8 bytes (1 B per weight)
// at 3.35 TB/s, the same bytes as ternary_mac.cu.
//
// What the design does about it: ternary_mac.cu's structure without the
// clamp. Each weight byte is read from device memory once and turned
// into 32-bit pos/neg masks in registers, 32 K rows to a word (no clamp
// ties the word to the 16-row block here); x is staged once per block in
// shared memory as 32-bit pos/neg masks, and the inner loop is
//   p = popc(x+ & w+) + popc(x- & w-) - popc(x+ & w-) - popc(x- & w+)
// with int32 accumulators (exact, no float rounding). A block owns 32
// output columns, one per lane, so a warp reads 32 neighbouring weight
// bytes per K row (coalesced); the block's warps split the K words and
// add their integer partials in shared memory, so the result does not
// depend on the split. The K loop lives inside the block. Ragged M, N
// and K are masked here, so callers pass the logical extents. Simple:
// byte loads, no TMA ring, no tensor cores (see PERF.md for its times).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWord = 32;   // K rows per mask word
constexpr int kCols = 32;   // output columns per block: one per lane
constexpr int kChunk = 32;  // K words of x staged per pass (1024 rows)

// MT rows of x per block; WARPS warps split the K words.
template <int MT, int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
exact_mac_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 float* __restrict__ out, int M, int K, int N) {
  __shared__ uint32_t xpos[MT][kChunk];
  __shared__ uint32_t xneg[MT][kChunk];
  __shared__ int partial[WARPS][MT][kCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * kCols + lane;
  const int m0 = blockIdx.y * MT;
  const int kw_total = (K + kWord - 1) / kWord;

  int acc[MT];
#pragma unroll
  for (int r = 0; r < MT; ++r) acc[r] = 0;

  for (int kw0 = 0; kw0 < kw_total; kw0 += kChunk) {
    const int nkw = min(kChunk, kw_total - kw0);
    __syncthreads();  // the previous chunk's masks are consumed
    for (int e = threadIdx.x; e < MT * nkw; e += 32 * WARPS) {
      const int r = e / nkw;
      const int b = e - r * nkw;
      const int m = m0 + r;
      uint32_t p = 0, q = 0;
      if (m < M) {
        const int8_t* row = x + static_cast<size_t>(m) * K;
        const int kbase = (kw0 + b) * kWord;
#pragma unroll
        for (int j = 0; j < kWord; ++j) {
          const int k = kbase + j;
          const int v = k < K ? row[k] : 0;
          p |= static_cast<uint32_t>(v > 0) << j;
          q |= static_cast<uint32_t>(v < 0) << j;
        }
      }
      xpos[r][b] = p;
      xneg[r][b] = q;
    }
    __syncthreads();
    if (n < N) {
      for (int b = warp; b < nkw; b += WARPS) {
        const int kbase = (kw0 + b) * kWord;
        uint32_t wp = 0, wn = 0;
#pragma unroll
        for (int j = 0; j < kWord; ++j) {
          const int k = kbase + j;
          const int v = k < K ? w[static_cast<size_t>(k) * N + n] : 0;
          wp |= static_cast<uint32_t>(v > 0) << j;
          wn |= static_cast<uint32_t>(v < 0) << j;
        }
#pragma unroll
        for (int r = 0; r < MT; ++r) {
          const uint32_t xp = xpos[r][b];
          const uint32_t xn = xneg[r][b];
          acc[r] += __popc(xp & wp) + __popc(xn & wn) - __popc(xp & wn) -
                    __popc(xn & wp);
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
            cudaStream_t stream) {
  const dim3 grid((N + kCols - 1) / kCols, (M + MT - 1) / MT);
  exact_mac_kernel<MT, WARPS><<<grid, 32 * WARPS, 0, stream>>>(x, w, out, M, K, N);
}

}  // namespace

// x: (M, K) int8, w: (K, N) int8, out: (M, N) f32, all contiguous on the
// current device. rows_per_block selects the M tile (8: decode, 32:
// prefill). Returns cudaGetLastError() after the launch.
extern "C" int ternary_exact_mac(const void* x, const void* w, void* out, int M,
                                 int K, int N, int rows_per_block, void* stream) {
  const auto* xs = static_cast<const int8_t*>(x);
  const auto* ws = static_cast<const int8_t*>(w);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (rows_per_block == 8) {
    launch<8, 16>(xs, ws, o, M, K, N, s);
  } else if (rows_per_block == 32) {
    launch<32, 8>(xs, ws, o, M, K, N, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
