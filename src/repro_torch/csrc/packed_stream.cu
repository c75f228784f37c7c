// Streaming signed-ternary CiM MAC from ONE plane-interleaved array, for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/packed_mac.py::packed_cim_matmul_decode_stream,
// the Pallas TPU kernel (body _packed_decode_stream_kernel) that the
// stream spec's execute_packed runs at decode M (<= 8).
//
// The weight is one (rows, N) uint8 array in plane layout 1: byte-row 2r
// is pos byte-row r and 2r+1 is neg byte-row r, where bit j of pos/neg
// byte-row r is K row 8r+j. A 16-deep K block b is the four byte-rows
// 4b..4b+3 (pos lo, neg lo, pos hi, neg hi), so one contiguous run of
// byte-rows holds both planes of a K tile. The MAC is packed_mac.cu's
// exactly: for each block, a = popc(x+ & w+) + popc(x- & w-), b =
// popc(x+ & w-) + popc(x- & w+), summed as min(a, adc_max) -
// min(b, adc_max) (cim=1) or a - b (cim=0) in int32, so the output is
// bit-identical to packed_cim_matmul_decode's. Output int32 (M, N).
//
// What bounds it on the H100: the plane read, 2 bits per weight at
// 3.35 TB/s (the same bytes as the decode kernel of packed_mac.cu).
//
// What the design does about it, and what makes it the stream kernel: a
// block owns a 16-column tile and walks its whole K extent through an
// NBUF-stage ring (NBUF in {2, 3}) in shared memory. Each stage is one
// 256-deep K tile: 64 byte-rows x 16 bytes, fetched by 64 16-byte
// cp.async copies (one contiguous run of rows, both planes at once).
// Tiles i+1 .. i+NBUF-1 are in flight (commit_group / wait_group) while
// tile i's popcount MAC runs. x (<= 8 rows) is staged once per block as
// 16-bit pos/neg masks, overlapping the first copies. The 256 threads of
// a block are (16 K blocks) x (16 columns): each takes one K block of
// one column per tile and keeps its own int32 partial per row, and the
// partials are added in shared memory at the end (exact in any order).
//
// The column tile: 16 columns (one 16-byte copy per byte-row) gives 12,
// 36 and 96 blocks at N = 192, 576 and 1536, twice what the 32-column
// tile of packed_mac.cu gives; a narrower tile would need copies smaller
// than 16 bytes. K tiles past x's last 16-block are not fetched, so the
// canonical K pad of the planes is not read; byte-rows past the array's
// end are zero-filled by the copy (src-size 0).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMT = 8;                    // rows of x: the decode class
constexpr int kCols = 16;                 // output columns per block
constexpr int kTileBlocks = 16;           // 16-deep K blocks per K tile
constexpr int kTileRows = 4 * kTileBlocks;  // interleaved byte-rows per tile
constexpr int kStage = kTileRows * kCols;   // bytes per ring stage
constexpr int kThreads = kTileBlocks * kCols;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int NBUF>
__global__ void __launch_bounds__(kThreads)
packed_stream_kernel(const int8_t* __restrict__ x,
                     const uint8_t* __restrict__ w, int32_t* __restrict__ out,
                     int M, int kx, int rows, int ld, int N, int adc_max,
                     int cim) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int partial[kTileBlocks][kMT][kCols];
  uint8_t* ring = smem;
  // every block of x's K extent that the planes hold: 4 byte-rows each
  const int kb_total = min((rows + 3) / 4, (kx + 15) / 16);
  uint16_t* xpos = reinterpret_cast<uint16_t*>(smem + NBUF * kStage);
  uint16_t* xneg = xpos + kMT * kb_total;
  const int nk = (kb_total + kTileBlocks - 1) / kTileBlocks;
  const int col0 = blockIdx.x * kCols;
  const int tid = threadIdx.x;

  // one K tile into one ring stage: thread t < 64 copies byte-row t
  auto fetch = [&](int stage, int tile) {
    if (tid < kTileRows) {
      const int r = tile * kTileRows + tid;
      const uint8_t* src = w + static_cast<size_t>(r < rows ? r : 0) * ld + col0;
      cp_async16(ring + stage * kStage + tid * kCols, src, r < rows ? 16 : 0);
    }
  };

  // warm-up: the first NBUF-1 tiles go in flight before any MAC
#pragma unroll
  for (int s = 0; s < NBUF - 1; ++s) {
    if (s < nk) fetch(s, s);
    cp_async_commit();
  }

  // x as pos/neg masks, while the first tiles land
  for (int e = tid; e < kMT * kb_total; e += kThreads) {
    const int r = e / kb_total;
    const int b = e - r * kb_total;
    uint32_t p = 0, q = 0;
    if (r < M) {
      const int8_t* row = x + static_cast<size_t>(r) * kx;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int k = b * 16 + j;
        const int v = k < kx ? row[k] : 0;
        p |= static_cast<uint32_t>(v > 0) << j;
        q |= static_cast<uint32_t>(v < 0) << j;
      }
    }
    xpos[e] = static_cast<uint16_t>(p);
    xneg[e] = static_cast<uint16_t>(q);
  }

  const int c = tid % kCols;
  const int kbl = tid / kCols;
  int acc[kMT];
#pragma unroll
  for (int r = 0; r < kMT; ++r) acc[r] = 0;

  for (int i = 0; i < nk; ++i) {
    cp_async_wait<NBUF - 2>();  // this thread's copies of tile i landed
    // every thread's copies of tile i are visible, and every thread is
    // done with tile i-1's stage, which the prefetch below overwrites
    __syncthreads();
    if (i + NBUF - 1 < nk) fetch((i + NBUF - 1) % NBUF, i + NBUF - 1);
    cp_async_commit();

    const int b = i * kTileBlocks + kbl;
    if (b < kb_total) {
      const uint8_t* t = ring + (i % NBUF) * kStage + 4 * kbl * kCols + c;
      const uint32_t wp = t[0] | (static_cast<uint32_t>(t[2 * kCols]) << 8);
      const uint32_t wn = t[kCols] | (static_cast<uint32_t>(t[3 * kCols]) << 8);
#pragma unroll
      for (int r = 0; r < kMT; ++r) {
        const uint32_t xp = xpos[r * kb_total + b];
        const uint32_t xn = xneg[r * kb_total + b];
        const int a = __popc(xp & wp) + __popc(xn & wn);
        const int bb = __popc(xp & wn) + __popc(xn & wp);
        acc[r] += cim ? min(a, adc_max) - min(bb, adc_max) : a - bb;
      }
    }
  }
  cp_async_wait<0>();

  // add the K blocks' integer partials (exact in any order)
#pragma unroll
  for (int r = 0; r < kMT; ++r) partial[kbl][r][c] = acc[r];
  __syncthreads();
  if (tid < kMT * kCols) {
    const int r = tid / kCols;
    const int col = col0 + tid % kCols;
    if (r < M && col < N) {
      int sum = 0;
#pragma unroll
      for (int v = 0; v < kTileBlocks; ++v) sum += partial[v][r][tid % kCols];
      out[static_cast<size_t>(r) * N + col] = sum;
    }
  }
}

template <int NBUF>
int launch(const int8_t* x, const uint8_t* w, int32_t* out, int M, int kx,
           int rows, int ld, int N, int adc_max, int cim, cudaStream_t stream) {
  const int kb_total = min((rows + 3) / 4, (kx + 15) / 16);
  const size_t smem = NBUF * kStage + 2 * sizeof(uint16_t) * kMT * kb_total;
  const dim3 grid((N + kCols - 1) / kCols);
  packed_stream_kernel<NBUF><<<grid, kThreads, smem, stream>>>(
      x, w, out, M, kx, rows, ld, N, adc_max, cim);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (M <= 8, kx) int8 contiguous; w_int: (rows, *) uint8 in plane
// layout 1, unit column stride, row stride ld; the pointer, ld and the
// column count are multiples of 16 bytes (the wrapper checks). out:
// (M, N) int32 contiguous, N the logical columns. nbuf: ring stages (2
// or 3). Returns cudaGetLastError() after the launch.
extern "C" int packed_stream_mac(const void* x, const void* w_int, void* out,
                                 int M, int kx, int rows, int ld, int N,
                                 int adc_max, int cim, int nbuf, void* stream) {
  const auto* xs = static_cast<const int8_t*>(x);
  const auto* ws = static_cast<const uint8_t*>(w_int);
  auto* o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (M > kMT) return static_cast<int>(cudaErrorInvalidValue);
  if (nbuf == 2) return launch<2>(xs, ws, o, M, kx, rows, ld, N, adc_max, cim, s);
  if (nbuf == 3) return launch<3>(xs, ws, o, M, kx, rows, ld, N, adc_max, cim, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
