// K2, K3 and K4: the 256-bit Hamming top-2 searches, for Hopper (sm_90a).
//
// Replace the TPU kernels of orb_slam2_tpu/matching/pallas_hamming.py:
//   K2 _masked_kernel (wrapped by masked_top2_mutual): a pair (i, j)
//      counts when both are valid, column j lies in row i's Chebyshev
//      window and its octave is in row i's [lmin, lmax];
//   K3 _epi_kernel (wrapped by masked_top2_epi): the gate is
//      (a*x + b*y + c)^2 < thr with row i's pre-normalised epipolar line
//      and column j's point and chi2*sigma^2 threshold;
//   K4 _kernel (wrapped by hamming_top2): no gate, column validity only.
// For K2 and K3 a masked pair has distance MASK_D = 1023.  Outputs, all
// int32:
//   bkey[i] = min_j d(i,j)*4096 + j                      (best)
//   skey[i] = min( {key(i,j) : j != best}  U  {1023*4096 + best} )
//   ckey[j] = min_i d(i,j)*16384 + i                     (column best)
// Taking the min of packed keys reproduces argmin's lowest-index
// tie-break.  Keys need M <= 4096 and N <= 16384; the wrapper checks it.
// K4 keeps the TPU kernel's semantics: an invalid column costs d + BIG,
// second never exceeds BIG.  Its key is (d + 257*invalid) * 2^21 + j, so
// every invalid key lies above every valid one; a row carries the best
// and true second key over all columns, merged across splits by the same
// rule, and after the last merge
//   best key valid:   best = d, idx = j, second = its d if valid, else BIG
//   best key invalid: best = BIG + d, idx = j, second = BIG
// which is the plain version's d + BIG with the lowest-index argmin and
// second <= BIG for rows with 0, 1 or more valid columns.  K4 has no
// column keys, so N is free; its keys need M <= 2^21.
//
// Distances on the tensor cores.  As the TPU kernel did on its matrix
// unit, a distance is (256 - x.y) / 2 for the descriptors' +-1 vectors
// x, y; here the product runs in int8 with int32 sums on
// mma.sync.m16n8k32 (8 k-steps per pair, exact).  A descriptor is
// staged in shared memory as 256 int8 +-1 values through a 256-entry
// byte -> 8 bytes table; within word w, byte t feeds the fragment slots
// k = t*4..t*4+3 (bits 0-3) and 16+t*4.. (bits 4-7), the same order for
// rows and columns.  A column's 8 bytes per (w, t) are stored together,
// so a thread's B fragment is one 8-byte load; rows g and g+8 of an m16
// tile are interleaved per (w, t) as {lo(g), lo(g+8), hi(g), hi(g+8)},
// so its A fragment is one 16-byte load already in mma's register order.
// Slots are XOR-swizzled so that a warp's fragment loads hit distinct
// banks.
//
// What bounds it on the H100: the epilogue on the CUDA cores, not the
// tensor cores or memory.  The compiled chunk loop issues ~22
// instructions a pair for K2/K3: the gate (2 FADD + 4 FSETP for K2,
// 3 FMUL + 2 FADD + 1 FSETP for K3), two packed keys (1 SEL + 2 IMAD),
// the row top-2 (3 integer min/max) and the column min, against 1/16 of
// an mma a pair; K4 has no gate and no column key: one IMAD (the
// column's key base, validity folded in, less acc * 2^20) and the row
// top-2.  The operands are only (N + M) * 32 B of descriptors and 1-24 B
// of attributes per row or column.  So the design keeps every pair's
// work in registers and fills the card (one kernel, the gate a template
// parameter):
//   - a block owns a 128-row tile (4 warps x 32 rows: two m16 tiles per
//     warp) and one of S column splits; the grid is S x N/128, with S
//     chosen by orb_masked_top2_splits from the card's SM count so that
//     the grid is one wave of kBlocksPerSm blocks on every SM;
//   - the split's columns stream through shared memory 32 at a time,
//     double-buffered: the next chunk's descriptors and attributes are
//     loaded into registers while the current one is computed;
//   - each accumulator element is gated (a masked one takes the acc of
//     d = 1023), turned into its two keys with one multiply-add each
//     (key = (256*2048 + col) - acc*2048), and folded into the thread's
//     running (best, true second) per row by one max and two mins;
//     validity is folded into the attributes (an invalid row or column
//     gets a NaN or -inf that fails the gate);
//   - rows: the 4 lanes that share an accumulator row merge by the TPU
//     kernel's rule best = min(b0, b1), second = min(max(b0, b1),
//     min(s0, s1)), exact for distinct keys; skey's masked replacement
//     of the best column is applied once at the end;
//   - columns (K2/K3): a min over the thread's 4 rows, shuffles across
//     the 8 lanes groups, a shared-memory atomicMin across warps, and one
//     global atomicMin per column and block into a buffer the wrapper
//     fills with INT_MAX; a min of integers is order-free, so results
//     are deterministic;
//   - splits merge inside the launch: every block writes its rows'
//     (best, second) to scratch, and the last block of a row tile to
//     arrive (an atomic counter per tile in an INT_MAX-filled buffer,
//     for K2/K3 the same one as ckey, after it, so it counts up from
//     INT_MAX) merges them in split order and writes the row outputs.
// K3's line test uses __fmul_rn/__fadd_rn, which the compiler never
// contracts into an FMA: the gate rounds exactly as the plain PyTorch
// version's separate multiply and add do.

#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;           // 4 warps
constexpr int kBlocksPerSm = 4;         // 128 registers a thread
constexpr int kTileRows = 128;          // rows per block, 32 per warp
constexpr int kChunk = 32;              // columns per staged chunk
constexpr int kNTiles = kChunk / 8;     // n8 tiles per chunk
constexpr int kDescBytes = 256;         // a descriptor as 256 int8 +-1
constexpr int kColStride = 4096;
constexpr int kRowStride = 16384;
constexpr int kMaskD = 1023;
constexpr int kMaskedAcc = 256 - 2 * kMaskD;   // the acc of d = kMaskD
constexpr unsigned kArrivalBase = 0x7FFFFFFFu;  // counters start at INT_MAX
// K4: key = (d + kInvalidD * invalid) << kK4ColBits | col
constexpr int kK4ColBits = 21;
constexpr int kK4MaxCols = 1 << kK4ColBits;
constexpr int kInvalidD = 257;                  // above every real d
constexpr int kBig = 1 << 20;                   // the TPU kernel's BIG

constexpr int kLutBytes = 256 * 8;
constexpr int kRowBytes = kTileRows * kDescBytes;
constexpr int kColBufBytes = kChunk * kDescBytes;
constexpr int kAttrBytes = kChunk * 16;
constexpr int kFixedSmem = kLutBytes + kRowBytes + 2 * kColBufBytes +
                           2 * kAttrBytes;
static_assert(kTileRows == kThreads, "each thread stages one row");
static_assert(kChunk * 4 == kThreads, "four threads stage each column");

// bits 0-3 of n as four int8 values, +1 for a set bit and -1 for a clear
__device__ __forceinline__ uint32_t expand4(uint32_t n) {
  const uint32_t s = (n & 1u) | ((n & 2u) << 7) | ((n & 4u) << 14) |
                     ((n & 8u) << 21);
  return ~(s * 0xFEu);
}

// byte offset of (word w, byte t) in a staged column at index idx
// (256 bytes per column, 8 per (w, t))
__device__ __forceinline__ int col_slot(int idx, int w, int t) {
  return (((w << 2) | t) ^ ((idx & 3) << 2)) << 3;
}

// byte offset of the 16-byte group of (word w, byte t) that holds row r
// of the staged row tile: rows g and g + 8 of m16 tile r / 16 share it
__device__ __forceinline__ int row_slot(int r, int w, int t) {
  const int g = r & 7;
  return ((((r >> 4) << 3) | g) * 32 + (((w << 2) | t) ^ ((g & 1) << 2))) << 4;
}

__device__ __forceinline__ void expand_col_word(unsigned char* desc, int idx,
                                                int w, uint32_t word,
                                                const uint2* lut) {
#pragma unroll
  for (int t = 0; t < 4; ++t)
    *reinterpret_cast<uint2*>(desc + col_slot(idx, w, t)) =
        lut[(word >> (8 * t)) & 0xFFu];
}

// c (+)= a.b on one m16n8k32 tile; the first k-step starts from zero
template <bool kFirst>
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint4 a,
                                       const uint2 b) {
  if (kFirst) {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
        : "=r"(c[0]), "=r"(c[1]), "=r"(c[2]), "=r"(c[3])
        : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b.x), "r"(b.y),
          "r"(0));
  } else {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b.x), "r"(b.y));
  }
}

// the TPU kernel's merge of two (best, second) pairs of distinct keys
__device__ __forceinline__ void merge2(int& b, int& s, int ob, int os) {
  s = min(max(b, ob), min(s, os));
  b = min(b, ob);
}

// skey: the true second, or the best column's masked key if lower
__device__ __forceinline__ int second_key(int b, int s) {
  return min(s, kMaskD * kColStride + (b & (kColStride - 1)));
}

// A gate: what a block stages per column (Attr: fetch loads it, fold
// prepares it), per row (load), whether a pair passes (ok), and whether
// the search has column keys.
//
// K2 gate.  Row attributes (N, 6): u, v, radius, lmin, lmax, valid.
// Column attributes (M, 4): x, y, octave, valid.  An invalid row gets
// radius -inf, an invalid column x = NaN: both fail |u - x| <= radius.
struct WindowGate {
  static constexpr bool kColumnKeys = true;
  using Attr = float4;
  __device__ __forceinline__ static float4 fetch(const void* ca, int j) {
    return static_cast<const float4*>(ca)[j];
  }
  float u, v, rad, lmin, lmax;
  __device__ __forceinline__ void load(const float* __restrict__ ra, int i) {
    const float* r = ra + (size_t)i * 6;
    u = r[0];
    v = r[1];
    rad = r[5] > 0.0f ? r[2] : -INFINITY;
    lmin = r[3];
    lmax = r[4];
  }
  __device__ __forceinline__ static float4 fold(float4 c, int) {
    if (!(c.w > 0.0f)) c.x = __int_as_float(0x7fc00000);
    return c;
  }
  __device__ __forceinline__ bool ok(const float4 c) const {
    return (fabsf(u - c.x) <= rad) & (fabsf(v - c.y) <= rad) &
           (c.z >= lmin) & (c.z <= lmax);
  }
};

// K3 gate.  Row attributes (N, 4): a, b, c, valid (line normalised by
// 1/sqrt(a^2+b^2)).  Column attributes (M, 4): x, y, threshold, valid.
// An invalid row gets a = NaN, an invalid column threshold NaN: both
// fail e*e < threshold.
struct EpipolarGate {
  static constexpr bool kColumnKeys = true;
  using Attr = float4;
  __device__ __forceinline__ static float4 fetch(const void* ca, int j) {
    return static_cast<const float4*>(ca)[j];
  }
  float a, b, c;
  __device__ __forceinline__ void load(const float* __restrict__ ra, int i) {
    const float4 r = reinterpret_cast<const float4*>(ra)[i];
    a = r.w > 0.0f ? r.x : __int_as_float(0x7fc00000);
    b = r.y;
    c = r.z;
  }
  __device__ __forceinline__ static float4 fold(float4 col, int) {
    if (!(col.w > 0.0f)) col.z = __int_as_float(0x7fc00000);
    return col;
  }
  __device__ __forceinline__ bool ok(const float4 col) const {
    const float e =
        __fadd_rn(__fadd_rn(__fmul_rn(a, col.x), __fmul_rn(b, col.y)), c);
    return __fmul_rn(e, e) < col.z;
  }
};

// K4 gate: every pair passes.  Column attributes (M,) bool, validity.
// A column stages its key base, (256 << 20) + (257 << 21 if invalid) + j,
// and a pair's key is base - acc * 2^20, as d * 2^21 = (256 - acc) * 2^20.
struct ValidGate {
  static constexpr bool kColumnKeys = false;
  using Attr = int;
  __device__ __forceinline__ static int fetch(const void* ca, int j) {
    return static_cast<const unsigned char*>(ca)[j];
  }
  __device__ __forceinline__ static int fold(int valid, int j) {
    return (256 << (kK4ColBits - 1)) + (valid ? 0 : kInvalidD << kK4ColBits) +
           j;
  }
  __device__ __forceinline__ void load(const float*, int) {}
};

// Row outputs: K2/K3 write bkey to out0 and skey to out1 (out2 unused);
// K4 writes best, idx and second to out0, out1, out2.  ckey (K2/K3 only)
// and counters (one per row tile) hold INT_MAX on entry.
template <class Gate>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
masked_top2_kernel(const int* __restrict__ desc1, const int* __restrict__ desc2,
                   const float* __restrict__ row_attr,
                   const void* __restrict__ col_attr, int n_rows, int n_cols,
                   int n_splits, int* __restrict__ out0,
                   int* __restrict__ out1, int* __restrict__ out2,
                   int* __restrict__ ckey, unsigned* __restrict__ counters,
                   int* __restrict__ part) {
  using Attr = typename Gate::Attr;
  extern __shared__ __align__(16) unsigned char smem[];
  uint2* lut = reinterpret_cast<uint2*>(smem);
  unsigned char* s_rows = smem + kLutBytes;
  unsigned char* s_cols = s_rows + kRowBytes;  // two chunk buffers
  Attr* s_attr = reinterpret_cast<Attr*>(s_cols + 2 * kColBufBytes);
  // the split's column keys (K2/K3)
  int* s_cmin =
      reinterpret_cast<int*>(s_cols + 2 * kColBufBytes + 2 * kAttrBytes);
  __shared__ int s_last;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // mma group: accumulator rows g, g + 8
  const int t = lane & 3;   // thread in group: columns 2t, 2t + 1
  const int split = blockIdx.x;
  const int row0 = blockIdx.y * kTileRows;
  const int n_chunks = n_cols / kChunk;
  const int c_begin = split * n_chunks / n_splits;
  const int c_end = (split + 1) * n_chunks / n_splits;
  const int col0 = c_begin * kChunk;
  const int n_split_cols = (c_end - c_begin) * kChunk;

  for (int v = tid; v < 256; v += kThreads)
    lut[v] = make_uint2(expand4(v & 15), expand4(v >> 4));
  if constexpr (Gate::kColumnKeys) {
    for (int j = tid; j < n_split_cols; j += kThreads) s_cmin[j] = INT_MAX;
  }

  // a chunk is staged by every thread: column tid/4, words 2*(tid%4) + 0..1
  const int pc = tid >> 2;
  const int pw = (tid & 3) * 2;
  int2 raw;
  Attr raw_attr{};
  int attr_col = 0;
  auto fetch = [&](int c) {
    raw = *reinterpret_cast<const int2*>(desc2 + (size_t)(c * kChunk + pc) * 8 +
                                         pw);
    attr_col = c * kChunk + tid;
    if (tid < kChunk) raw_attr = Gate::fetch(col_attr, attr_col);
  };
  auto stage = [&](int buf) {
    unsigned char* dst = s_cols + buf * kColBufBytes + pc * kDescBytes;
    expand_col_word(dst, pc, pw, static_cast<uint32_t>(raw.x), lut);
    expand_col_word(dst, pc, pw + 1, static_cast<uint32_t>(raw.y), lut);
    if (tid < kChunk)
      s_attr[buf * kChunk + tid] = Gate::fold(raw_attr, attr_col);
  };

  fetch(c_begin);
  const int4* rsrc = reinterpret_cast<const int4*>(desc1) +
                     (size_t)(row0 + tid) * 2;
  const int4 r_lo = rsrc[0];
  const int4 r_hi = rsrc[1];
  // this thread's accumulator rows: warp*32 + q*8 + g, q = 2*mtile + half
  Gate gate[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) gate[q].load(row_attr, row0 + warp * 32 + q * 8 + g);
  __syncthreads();  // the table is built

  {
    // row tid: its low nibbles at byte 4h of each 16-byte group, its
    // high nibbles at 8 + 4h (h: the row's half of its m16 tile); the
    // byte order rotates with the lane so a warp's stores spread
    const int words[8] = {r_lo.x, r_lo.y, r_lo.z, r_lo.w,
                          r_hi.x, r_hi.y, r_hi.z, r_hi.w};
    const int h4 = ((tid >> 3) & 1) * 4;
#pragma unroll
    for (int w = 0; w < 8; ++w) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = (k + ((tid >> 1) & 3)) & 3;
        const uint2 e = lut[(static_cast<uint32_t>(words[w]) >> (8 * t)) &
                            0xFFu];
        unsigned char* grp = s_rows + row_slot(tid, w, t);
        *reinterpret_cast<uint32_t*>(grp + h4) = e.x;
        *reinterpret_cast<uint32_t*>(grp + 8 + h4) = e.y;
      }
    }
  }
  stage(0);
  if (c_begin + 1 < c_end) fetch(c_begin + 1);
  __syncthreads();

  int best[4], second[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) best[q] = second[q] = INT_MAX;

  for (int c = c_begin; c < c_end; ++c) {
    const int buf = (c - c_begin) & 1;
    const unsigned char* sc = s_cols + buf * kColBufBytes;
    const Attr* sa = s_attr + buf * kChunk;

    int acc[2][kNTiles][4];
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      // every column this lane loads has index & 3 == g & 3
      const int so = col_slot(g, w, t);
      const uint4 a0 = *reinterpret_cast<const uint4*>(
          s_rows + row_slot(warp * 32 + g, w, t));
      const uint4 a1 = *reinterpret_cast<const uint4*>(
          s_rows + row_slot(warp * 32 + 16 + g, w, t));
#pragma unroll
      for (int n = 0; n < kNTiles; ++n) {
        const uint2 b = *reinterpret_cast<const uint2*>(
            sc + (n * 8 + g) * kDescBytes + so);
        if (w == 0) {
          mma_s8<true>(acc[0][n], a0, b);
          mma_s8<true>(acc[1][n], a1, b);
        } else {
          mma_s8<false>(acc[0][n], a0, b);
          mma_s8<false>(acc[1][n], a1, b);
        }
      }
    }

#pragma unroll
    for (int n = 0; n < kNTiles; ++n) {
      const int cl = n * 8 + t * 2;
      if constexpr (!Gate::kColumnKeys) {
        // K4: key = the column's base - acc * 2^20 (ValidGate::fold)
        const int base[2] = {sa[cl], sa[cl + 1]};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = base[e] - acc[q >> 1][n][2 * (q & 1) + e] *
                                          (1 << (kK4ColBits - 1));
            second[q] = min(second[q], max(best[q], key));
            best[q] = min(best[q], key);
          }
        }
      } else {
        const int col = c * kChunk + cl;
        const Attr ca[2] = {sa[cl], sa[cl + 1]};
        int cm[2] = {INT_MAX, INT_MAX};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int row = row0 + warp * 32 + q * 8 + g;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            // accumulator element (row, col + e): tile q >> 1, slot
            // 2 * (q & 1) + e; acc = 256 - 2d, so d*4096 = (256 - acc)*2048;
            // a masked pair takes the acc of d = 1023
            const int x = gate[q].ok(ca[e]) ? acc[q >> 1][n][2 * (q & 1) + e]
                                            : kMaskedAcc;
            const int key = (256 * 2048 + col + e) - x * 2048;
            const int ck = (256 * 8192 + row) - x * 8192;
            second[q] = min(second[q], max(best[q], key));
            best[q] = min(best[q], key);
            cm[e] = min(cm[e], ck);
          }
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
#pragma unroll
          for (int o = 4; o < 32; o <<= 1)
            cm[e] = min(cm[e], __shfl_xor_sync(0xffffffffu, cm[e], o));
        }
        if (g == 0) {
          atomicMin(s_cmin + col - col0, cm[0]);
          atomicMin(s_cmin + col - col0 + 1, cm[1]);
        }
      }
    }

    if (c + 1 < c_end) {
      stage(buf ^ 1);
      if (c + 2 < c_end) fetch(c + 2);
    }
    __syncthreads();
  }

  if constexpr (Gate::kColumnKeys) {
    for (int j = tid; j < n_split_cols; j += kThreads)
      atomicMin(ckey + col0 + j, s_cmin[j]);
  }

#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      const int ob = __shfl_xor_sync(0xffffffffu, best[q], o);
      const int os = __shfl_xor_sync(0xffffffffu, second[q], o);
      merge2(best[q], second[q], ob, os);
    }
  }

  int* part_b = part;
  int* part_s = part + (size_t)n_splits * n_rows;
  if (t == 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = row0 + warp * 32 + q * 8 + g;
      part_b[(size_t)split * n_rows + row] = best[q];
      part_s[(size_t)split * n_rows + row] = second[q];
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    s_last = atomicAdd(counters + blockIdx.y, 1u) ==
             kArrivalBase + (unsigned)n_splits - 1u;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int row = row0 + tid;
  int b = INT_MAX, s = INT_MAX;
  for (int sp = 0; sp < n_splits; ++sp)
    merge2(b, s, __ldcg(part_b + (size_t)sp * n_rows + row),
           __ldcg(part_s + (size_t)sp * n_rows + row));
  if constexpr (Gate::kColumnKeys) {
    out0[row] = b;
    out1[row] = second_key(b, s);
  } else {
    const int bd = b >> kK4ColBits;
    const int sd = s >> kK4ColBits;
    const bool valid = bd < kInvalidD;
    out0[row] = valid ? bd : kBig + bd - kInvalidD;
    out1[row] = b & (kK4MaxCols - 1);
    out2[row] = valid && sd < kInvalidD ? sd : kBig;
  }
}

// Column splits per row tile: the largest power of two whose grid fits
// in one wave of kBlocksPerSm blocks on each of n_sm SMs (the fastest on
// the H100 at both main-path shapes, PERF.md), at most one per chunk.
int splits_for(int n_sm, int n_rows, int n_cols) {
  int s = 1;
  while (2 * s * (n_rows / kTileRows) <= kBlocksPerSm * n_sm) s *= 2;
  const int most = n_cols / kChunk;
  return s < most ? s : most;
}

template <class Gate>
int launch(const int* desc1, const int* desc2, const float* row_attr,
           const void* col_attr, int n_rows, int n_cols, int n_splits,
           int* out0, int* out1, int* out2, int* ckey, unsigned* counters,
           int* part, void* stream) {
  // K2/K3 keep the split's column keys in shared memory, K4 has none
  constexpr int kColKeyBytes = Gate::kColumnKeys ? (int)sizeof(int) : 0;
  static const cudaError_t attr = cudaFuncSetAttribute(
      masked_top2_kernel<Gate>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kFixedSmem + kColStride * kColKeyBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int n_chunks = n_cols / kChunk;
  const int most_cols = Gate::kColumnKeys ? kColStride : kK4MaxCols;
  if (n_rows % kTileRows || n_cols % kChunk || n_cols > most_cols ||
      n_splits < 1 || n_splits > n_chunks)
    return static_cast<int>(cudaErrorInvalidValue);
  const int split_cols = (n_chunks + n_splits - 1) / n_splits * kChunk;
  const size_t smem = kFixedSmem + (size_t)split_cols * kColKeyBytes;
  const dim3 grid(n_splits, n_rows / kTileRows);
  masked_top2_kernel<Gate><<<grid, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      desc1, desc2, row_attr, col_attr, n_rows, n_cols, n_splits, out0, out1,
      out2, ckey, counters, part);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The column split count S that K2, K3 and K4 take for N x M on CUDA device
// `device` (N % 128 == 0, M % 32 == 0), or minus a cudaError_t.
extern "C" int orb_masked_top2_splits(int device, int n_rows, int n_cols) {
  if (n_rows < kTileRows || n_rows % kTileRows || n_cols < kChunk ||
      n_cols % kChunk)
    return -static_cast<int>(cudaErrorInvalidValue);
  int n_sm = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return splits_for(n_sm, n_rows, n_cols);
}

// desc1 (N, 8) / desc2 (M, 8) int32 bit patterns of the uint32 words;
// row_attr (N, 6) and col_attr (M, 4) float32; N % 128 == 0,
// M % 128 == 0, N <= 16384, M <= 4096, n_splits from
// orb_masked_top2_splits, all contiguous on the current device.  ckey
// holds M + N/128 int32, all INT_MAX on entry (the column keys, then the
// row tiles' arrival counters); part holds 2 * n_splits * N int32 of
// scratch.  Writes bkey, skey (N,) and ckey[:M].  Returns
// cudaGetLastError().
extern "C" int orb_masked_top2_mutual(const int* desc1, const int* desc2,
                                      const float* row_attr,
                                      const float* col_attr, int n_rows,
                                      int n_cols, int n_splits, int* bkey,
                                      int* skey, int* ckey, int* part,
                                      void* stream) {
  return launch<WindowGate>(desc1, desc2, row_attr, col_attr, n_rows, n_cols,
                            n_splits, bkey, skey, nullptr, ckey,
                            reinterpret_cast<unsigned*>(ckey + n_cols), part,
                            stream);
}

// As orb_masked_top2_mutual with row_attr (N, 4): the epipolar gate.
extern "C" int orb_masked_top2_epi(const int* desc1, const int* desc2,
                                   const float* row_attr,
                                   const float* col_attr, int n_rows,
                                   int n_cols, int n_splits, int* bkey,
                                   int* skey, int* ckey, int* part,
                                   void* stream) {
  return launch<EpipolarGate>(desc1, desc2, row_attr, col_attr, n_rows,
                              n_cols, n_splits, bkey, skey, nullptr, ckey,
                              reinterpret_cast<unsigned*>(ckey + n_cols), part,
                              stream);
}

// K4.  desc1 (N, 8) / desc2 (M, 8) int32 bit patterns of the uint32
// words, valid2 (M,) bool; N % 128 == 0, M % 128 == 0, M <= 2^21,
// n_splits from orb_masked_top2_splits, all contiguous on the current
// device.  counters holds N/128 int32, all INT_MAX on entry; part holds
// 2 * n_splits * N int32 of scratch.  Writes best, idx, second (N,)
// int32.  Returns cudaGetLastError().
extern "C" int orb_hamming_top2(const int* desc1, const int* desc2,
                                const unsigned char* valid2, int n_rows,
                                int n_cols, int n_splits, int* best, int* idx,
                                int* second, int* counters, int* part,
                                void* stream) {
  return launch<ValidGate>(desc1, desc2, nullptr, valid2, n_rows, n_cols,
                           n_splits, best, idx, second, nullptr,
                           reinterpret_cast<unsigned*>(counters), part,
                           stream);
}
