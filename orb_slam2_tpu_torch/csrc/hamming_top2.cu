// K4: the unmasked 256-bit Hamming top-2 search, for Hopper (sm_90a).
//
// Replaces the TPU kernel orb_slam2_tpu/matching/pallas_hamming.py:_kernel
// (wrapped by hamming_top2): per row the best and second-best column by
// Hamming distance, with column validity.  K2 and K3, the masked
// searches, are in masked_top2.cu.
//
// What bounds it on the H100: integer issue rate.  Per pair: 8 XOR +
// 8 POPC + ~6 compare/select; the operands are tiny (N*32 B + M*33 B),
// so device memory is not the limit.  The TPU ran the distance as a +-1
// bf16 matmul on its matrix unit; here XOR + __popc gives the same
// integers with no unpacking.
//
// Design.  CUDA blocks run in no order and carry nothing between them,
// so each block owns kRows rows and loops over ALL column tiles itself:
// each thread holds its row's 8 descriptor words and running (best,
// idx, second) in registers; every tile of kCols column descriptors and
// validity penalties is staged in shared memory and read as a broadcast.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;   // rows per block == threads per block
constexpr int kCols = 128;  // columns staged per shared-memory tile

// K4: unmasked top-2 with column validity.  An invalid column costs
// d + kBig, as the TPU kernel adds BIG to its distance, so a row with no
// valid column still returns (kBig + d, its lowest-index argmin).  Per
// row: best = min_j d'(i,j), idx = its lowest j, second =
// min(kBig, min_{j != idx} d'(i,j)).  The TPU kernel merges 128-column
// tiles with argmin inside a tile and a strict < across tiles, and puts
// kBig (not kBig + d) at each tile's argmin when it takes the tile's
// second; scanning the columns in order with a strict < and starting
// second at kBig gives the same three integers.

constexpr int kBig = 1 << 20;

__global__ void __launch_bounds__(kRows)
hamming_top2_kernel(const int* __restrict__ desc1,
                    const int* __restrict__ desc2,
                    const int* __restrict__ valid2, int n_cols,
                    int* __restrict__ best_out, int* __restrict__ idx_out,
                    int* __restrict__ second_out) {
  __shared__ int4 s_desc[kCols][2];
  __shared__ int s_pen[kCols];

  const int tid = threadIdx.x;
  const int i = blockIdx.x * kRows + tid;  // N % kRows == 0: always a row

  const int4* drow = reinterpret_cast<const int4*>(desc1) + (size_t)i * 2;
  const int4 a0 = drow[0];
  const int4 a1 = drow[1];

  int best = INT_MAX;
  int idx = 0;
  int second = kBig;
  for (int j0 = 0; j0 < n_cols; j0 += kCols) {
    __syncthreads();  // the previous tile is fully consumed
    for (int c = tid; c < kCols; c += kRows) {
      const int4* src = reinterpret_cast<const int4*>(desc2) +
                        (size_t)(j0 + c) * 2;
      s_desc[c][0] = src[0];
      s_desc[c][1] = src[1];
      s_pen[c] = valid2[j0 + c] ? 0 : kBig;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kCols; ++c) {
      const int4 b0 = s_desc[c][0];
      const int4 b1 = s_desc[c][1];
      const int d = __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) +
                    __popc(a0.z ^ b0.z) + __popc(a0.w ^ b0.w) +
                    __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) +
                    __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w) + s_pen[c];
      if (d < best) {
        second = min(second, best);
        best = d;
        idx = j0 + c;
      } else {
        second = min(second, d);
      }
    }
  }
  best_out[i] = best;
  idx_out[i] = idx;
  second_out[i] = second;
}

}  // namespace

// K4.  desc1 (N, 8) / desc2 (M, 8) int32 bit patterns of the uint32
// words, valid2 (M,) int32 0/1; N % 128 == 0, M % 128 == 0, all
// contiguous on the current device.  Writes best, idx, second (N,)
// int32.  Returns cudaGetLastError().
extern "C" int orb_hamming_top2(const int* desc1, const int* desc2,
                                const int* valid2, int n_rows, int n_cols,
                                int* best, int* idx, int* second,
                                void* stream) {
  hamming_top2_kernel<<<n_rows / kRows, kRows, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      desc1, desc2, valid2, n_cols, best, idx, second);
  return static_cast<int>(cudaGetLastError());
}
