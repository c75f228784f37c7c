// Signed-ternary CiM MAC from the stored 2-bit (M1, M2) bitplanes, for
// Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of src/repro/kernels/packed_mac.py:
//   * packed_cim_matmul_decode (body _packed_decode_kernel): M <= 8,
//     int32 output — launched here with 8-row M tiles and int32 stores;
//   * packed_cim_matmul (body _packed_kernel): prefill-class M, f32
//     output — launched here with 32-row M tiles over blockIdx.y.
//
// The planes are (rows, N) uint8 with bit j of byte r = K row 8r+j (the
// SiTe cell's differential storage, 2 bits per ternary weight). For each
// 16-deep K block, bytes 2b and 2b+1 of a column are exactly the block's
// 16-bit pos/neg masks, so
//   a = popc(x+ & w+) + popc(x- & w-),  b = popc(x+ & w-) + popc(x- & w+)
// and the output sums min(a, adc_max) - min(b, adc_max) (cim=1) or a - b
// (cim=0, the exact dot).
//
// What bounds it on the H100: the plane read, 2 bits per weight (K*N/4
// bytes) at 3.35 TB/s, at decode; at prefill M the work is still only a
// few MOPs per call, so the plane read stays the bound.
//
// What the design does about it: planes are never unpacked to memory —
// a block owns 32 output columns, one per lane, and a lane reads its
// column's two plane bytes per K block (coalesced along N across the
// warp); the block's warps split the K blocks between them (many loads
// in flight at decode widths) and add their integer partials in shared
// memory, so the result is independent of the split. x is staged once
// per block in shared memory as pos/neg masks; the inner loop is
// popcounts with int32 accumulators. The K loop lives inside the block.
// Plane row strides are arguments, so the de-interleaved views of plane
// layout 1 are read in place; x columns beyond its logical K read as
// zero and the K loop ends at x's last 16-block, so the canonical K pad
// of the planes is neither read nor padded onto x per call; only the
// logical N columns are read and stored.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 32;   // output columns per block: one per lane
constexpr int kChunk = 64;  // 16-row K blocks of x staged per pass

// MT rows of x per block; WARPS warps split the K blocks.
template <int MT, int WARPS, typename OutT>
__global__ void __launch_bounds__(32 * WARPS)
packed_mac_kernel(const int8_t* __restrict__ x,
                  const uint8_t* __restrict__ wpos,
                  const uint8_t* __restrict__ wneg, OutT* __restrict__ out,
                  int M, int kx, int rows, int ldp, int ldn, int N,
                  int adc_max, int cim) {
  __shared__ uint16_t xpos[MT][kChunk];
  __shared__ uint16_t xneg[MT][kChunk];
  __shared__ int partial[WARPS][MT][kCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * kCols + lane;
  const int m0 = blockIdx.y * MT;
  // x is zero past kx, so later K blocks add nothing: stop at x's last
  // block and leave the canonical K pad rows of the planes unread
  const int kb_total = min((rows + 1) / 2, (kx + 15) / 16);

  int acc[MT];
#pragma unroll
  for (int r = 0; r < MT; ++r) acc[r] = 0;

  for (int kb0 = 0; kb0 < kb_total; kb0 += kChunk) {
    const int nkb = min(kChunk, kb_total - kb0);
    __syncthreads();
    for (int e = threadIdx.x; e < MT * nkb; e += 32 * WARPS) {
      const int r = e / nkb;
      const int b = e - r * nkb;
      const int m = m0 + r;
      uint32_t p = 0, q = 0;
      if (m < M) {
        const int8_t* row = x + static_cast<size_t>(m) * kx;
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
      for (int b = warp; b < nkb; b += WARPS) {
        const int r0 = 2 * (kb0 + b);
        uint32_t wp = wpos[static_cast<size_t>(r0) * ldp + n];
        uint32_t wn = wneg[static_cast<size_t>(r0) * ldn + n];
        if (r0 + 1 < rows) {
          wp |= static_cast<uint32_t>(wpos[static_cast<size_t>(r0 + 1) * ldp + n]) << 8;
          wn |= static_cast<uint32_t>(wneg[static_cast<size_t>(r0 + 1) * ldn + n]) << 8;
        }
#pragma unroll
        for (int r = 0; r < MT; ++r) {
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
      out[static_cast<size_t>(m) * N + col] = static_cast<OutT>(sum);
    }
  }
}

template <int MT, int WARPS, typename OutT>
void launch(const int8_t* x, const uint8_t* wp, const uint8_t* wn, void* out,
            int M, int kx, int rows, int ldp, int ldn, int N, int adc_max,
            int cim, cudaStream_t stream) {
  const dim3 grid((N + kCols - 1) / kCols, (M + MT - 1) / MT);
  packed_mac_kernel<MT, WARPS, OutT><<<grid, 32 * WARPS, 0, stream>>>(
      x, wp, wn, static_cast<OutT*>(out), M, kx, rows, ldp, ldn, N, adc_max, cim);
}

}  // namespace

// x: (M, kx) int8 contiguous; w_pos/w_neg: (rows, *) uint8 with unit
// column stride and row strides ldp/ldn; out: (M, N) contiguous, int32
// when decode != 0 (8-row M tiles), else f32 (32-row M tiles). Returns
// cudaGetLastError() after the launch.
extern "C" int packed_cim_mac(const void* x, const void* w_pos,
                              const void* w_neg, void* out, int M, int kx,
                              int rows, int ldp, int ldn, int N, int adc_max,
                              int cim, int decode, void* stream) {
  const auto* xs = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const uint8_t*>(w_pos);
  const auto* wn = static_cast<const uint8_t*>(w_neg);
  auto s = static_cast<cudaStream_t>(stream);
  if (decode) {
    launch<8, 16, int32_t>(xs, wp, wn, out, M, kx, rows, ldp, ldn, N, adc_max,
                           cim, s);
  } else {
    launch<32, 8, float>(xs, wp, wn, out, M, kx, rows, ldp, ldn, N, adc_max, cim,
                         s);
  }
  return static_cast<int>(cudaGetLastError());
}
