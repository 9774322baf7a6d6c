// K2, K3 and K4: 256-bit Hamming top-2 searches, for Hopper (sm_90a).
//
// Replace the TPU kernels orb_slam2_tpu/matching/pallas_hamming.py:
//   K4 _kernel (wrapped by hamming_top2): unmasked top-2 with column
//      validity, below;
//   K2 _masked_kernel (wrapped by masked_top2_mutual): a pair (i, j)
//      counts when both are valid, column j lies in row i's Chebyshev
//      window and its octave is in row i's [lmin, lmax];
//   K3 _epi_kernel (wrapped by masked_top2_epi): the gate is
//      (a*x + b*y + c)^2 < thr with row i's pre-normalised epipolar line
//      and column j's point and chi2*sigma^2 threshold.
// A masked pair has distance MASK_D = 1023.  Outputs, all int32:
//   bkey[i] = min_j d(i,j)*4096 + j                      (best)
//   skey[i] = min( {key(i,j) : j != best}  U  {1023*4096 + best} )
//   ckey[j] = min_i d(i,j)*16384 + i                     (column best)
// Taking the min of packed keys reproduces argmin's lowest-index
// tie-break.  Keys need M <= 4096 and N <= 16384; the wrapper checks it.
//
// What bounds it on the H100: integer issue rate.  Per pair: 8 XOR +
// 8 POPC + the gate and the top-2 update, ~45 instructions; the operands
// are tiny (N*32 B + M*32 B of descriptors, 16-24 B of attributes per
// row or column), so device memory is not the limit.  The TPU ran the
// distance as a +-1 bf16 matmul on its matrix unit; here XOR + __popc
// gives the same integers with no unpacking.
//
// Design.  The TPU grid ran in order with the column index innermost,
// which let the kernel carry the running top-2 in its output block; CUDA
// blocks run in no order and carry nothing between them.  So each block
// owns kRows rows and loops over ALL column tiles itself: each thread
// holds its row's 8 descriptor words, gate attributes and running
// (best, second) keys in registers; every tile of kCols column
// descriptors and attributes is staged in shared memory and read as a
// broadcast.  Column best: per column a warp-wide __reduce_min_sync,
// the block's warps combined in shared memory, then one int32
// atomicMin per column and block into a buffer the wrapper fills with
// INT_MAX.  A min of integers is the same in any order, so results are
// deterministic.  K3's line test uses __fmul_rn/__fadd_rn, which the
// compiler never contracts into an FMA: the gate rounds exactly as the
// plain PyTorch version's separate multiply and add do.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;   // rows per block == threads per block
constexpr int kCols = 128;  // columns staged per shared-memory tile
constexpr int kWarps = kRows / 32;
constexpr int kColStride = 4096;
constexpr int kRowStride = 16384;
constexpr int kMaskD = 1023;

// K2 gate.  Row attributes (N, 6): u, v, radius, lmin, lmax, valid.
// Column attributes (M, 4): x, y, octave, valid.
struct WindowGate {
  static constexpr int kRowAttrs = 6;
  float u, v, rad, lmin, lmax;
  bool rvalid;
  __device__ __forceinline__ void load(const float* __restrict__ ra, int i) {
    const float* r = ra + (size_t)i * kRowAttrs;
    u = r[0];
    v = r[1];
    rad = r[2];
    lmin = r[3];
    lmax = r[4];
    rvalid = r[5] > 0.0f;
  }
  __device__ __forceinline__ bool ok(const float4 c) const {
    return rvalid && (c.w > 0.0f) && (fabsf(u - c.x) <= rad) &&
           (fabsf(v - c.y) <= rad) && (c.z >= lmin) && (c.z <= lmax);
  }
};

// K3 gate.  Row attributes (N, 4): a, b, c, valid (line normalised by
// 1/sqrt(a^2+b^2)).  Column attributes (M, 4): x, y, threshold, valid.
struct EpipolarGate {
  float a, b, c;
  bool rvalid;
  __device__ __forceinline__ void load(const float* __restrict__ ra, int i) {
    const float4 r = reinterpret_cast<const float4*>(ra)[i];
    a = r.x;
    b = r.y;
    c = r.z;
    rvalid = r.w > 0.0f;
  }
  __device__ __forceinline__ bool ok(const float4 col) const {
    const float e =
        __fadd_rn(__fadd_rn(__fmul_rn(a, col.x), __fmul_rn(b, col.y)), c);
    return rvalid && (col.w > 0.0f) && (__fmul_rn(e, e) < col.z);
  }
};

template <class Gate>
__global__ void __launch_bounds__(kRows)
masked_top2_kernel(const int* __restrict__ desc1, const int* __restrict__ desc2,
                   const float* __restrict__ row_attr,
                   const float* __restrict__ col_attr, int n_cols,
                   int* __restrict__ bkey, int* __restrict__ skey,
                   int* __restrict__ ckey) {
  __shared__ int4 s_desc[kCols][2];
  __shared__ float4 s_attr[kCols];
  __shared__ int s_wmin[kWarps][kCols];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int i = blockIdx.x * kRows + tid;  // N % kRows == 0: always a row

  const int4* drow = reinterpret_cast<const int4*>(desc1) + (size_t)i * 2;
  const int4 a0 = drow[0];
  const int4 a1 = drow[1];
  Gate gate;
  gate.load(row_attr, i);

  int best = INT_MAX;
  int second = INT_MAX;
  for (int j0 = 0; j0 < n_cols; j0 += kCols) {
    __syncthreads();  // the previous tile is fully consumed
    for (int c = tid; c < kCols; c += kRows) {
      const int4* src = reinterpret_cast<const int4*>(desc2) +
                        (size_t)(j0 + c) * 2;
      s_desc[c][0] = src[0];
      s_desc[c][1] = src[1];
      s_attr[c] = reinterpret_cast<const float4*>(col_attr)[j0 + c];
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kCols; ++c) {
      const int4 b0 = s_desc[c][0];
      const int4 b1 = s_desc[c][1];
      const int d = __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) +
                    __popc(a0.z ^ b0.z) + __popc(a0.w ^ b0.w) +
                    __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) +
                    __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
      const int dm = gate.ok(s_attr[c]) ? d : kMaskD;
      const int col = j0 + c;
      const int key = dm * kColStride + col;
      if (key < best) {
        // the old best becomes an ordinary candidate; the new best
        // contributes its masked replacement (the reference's key2)
        second = min(second, min(best, kMaskD * kColStride + col));
        best = key;
      } else {
        second = min(second, key);
      }
      const int wmin = __reduce_min_sync(0xffffffffu, dm * kRowStride + i);
      if (lane == 0) s_wmin[warp][c] = wmin;
    }
    __syncthreads();
    for (int c = tid; c < kCols; c += kRows) {
      int m = s_wmin[0][c];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) m = min(m, s_wmin[w][c]);
      atomicMin(ckey + j0 + c, m);
    }
  }
  bkey[i] = best;
  skey[i] = second;
}

template <class Gate>
int launch(const int* desc1, const int* desc2, const float* row_attr,
           const float* col_attr, int n_rows, int n_cols, int* bkey,
           int* skey, int* ckey, void* stream) {
  masked_top2_kernel<Gate>
      <<<n_rows / kRows, kRows, 0, static_cast<cudaStream_t>(stream)>>>(
          desc1, desc2, row_attr, col_attr, n_cols, bkey, skey, ckey);
  return static_cast<int>(cudaGetLastError());
}

// K4: unmasked top-2 with column validity.  An invalid column costs
// d + kBig, as the TPU kernel adds BIG to its distance, so a row with no
// valid column still returns (kBig + d, its lowest-index argmin).  Per
// row: best = min_j d'(i,j), idx = its lowest j, second =
// min(kBig, min_{j != idx} d'(i,j)).  The TPU kernel merges 128-column
// tiles with argmin inside a tile and a strict < across tiles, and puts
// kBig (not kBig + d) at each tile's argmin when it takes the tile's
// second; scanning the columns in order with a strict < and starting
// second at kBig gives the same three integers.
//
// Bound: as K2, integer issue (8 XOR + 8 POPC + ~6 compare/select per
// pair); the operands are (N + M) * 32 B.  Design: K2's, without the
// gate and the column best.  Each thread owns one row; a block stages
// kCols column descriptors and validity flags in shared memory per tile.
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

// desc1 (N, 8) / desc2 (M, 8) int32 bit patterns of the uint32 words;
// row_attr (N, 6) and col_attr (M, 4) float32; N % 128 == 0,
// M % 128 == 0, N <= 16384, M <= 4096, all contiguous on the current
// device.  ckey must hold INT_MAX on entry.  Returns cudaGetLastError().
extern "C" int orb_masked_top2_mutual(const int* desc1, const int* desc2,
                                      const float* row_attr,
                                      const float* col_attr, int n_rows,
                                      int n_cols, int* bkey, int* skey,
                                      int* ckey, void* stream) {
  return launch<WindowGate>(desc1, desc2, row_attr, col_attr, n_rows, n_cols,
                            bkey, skey, ckey, stream);
}

// As orb_masked_top2_mutual with row_attr (N, 4): the epipolar gate.
extern "C" int orb_masked_top2_epi(const int* desc1, const int* desc2,
                                   const float* row_attr,
                                   const float* col_attr, int n_rows,
                                   int n_cols, int* bkey, int* skey,
                                   int* ckey, void* stream) {
  return launch<EpipolarGate>(desc1, desc2, row_attr, col_attr, n_rows,
                              n_cols, bkey, skey, ckey, stream);
}
