// K1: dense FAST-9/16 corner score maps of a frame's pyramid levels, in
// one launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel orb_slam2_tpu/ops/fast.py:_score_tile_kernel
// (built by _score_map_pallas, dispatched by score_map).  For each pixel
// p the score is the largest, over the 16 runs of 9 contiguous pixels on
// the radius-3 Bresenham ring, of min(ring - p) (bright arc) or
// min(p - ring) (dark arc): the largest threshold at which p is still a
// FAST-9 corner.
//
// Numerics: the roundings folded out of the arcs.  The plain version
// (ops/fast.py:fast_score_map) rounds the input to bf16, then each ring
// difference g(r) = bf16(fl32(r - p)), and takes max_k min_{arc k} g(r)
// (bright) and max_k min_{arc k} -g(r) (dark).  g is monotone
// non-decreasing, so it commutes with min and max:
//   bright = g(A), A = max_k min_{arc k} r,
//   dark = -g(B),  B = min_k max_{arc k} r.
// The kernel takes the arc extremes A and B on the bf16 pixels themselves
// (min and max select, so they are exact) and rounds twice a pixel, not
// 16 times: score = max(bf16(A - p), -bf16(B - p)), each difference in
// float32 before its rounding, as torch computes a bf16 difference.  The
// dark side negates the rounded difference (-(B - p), not p - B), as the
// plain version negates each rounded difference, so a zero keeps its
// sign up to the last max (where torch's and PTX's maximum may pick
// different zeros of a +0/-0 tie).  On the interior the result equals the
// plain version value for value; pixels outside the image read as 0 (the
// TPU kernel's zero halo) where the plain version wraps, so the outer
// 3 px differ, and the detector's 16 px border masks them.
//
// Arc extremes in three-input instructions.  Two horizontally adjacent
// pixels share one 32-bit lane as a bf16 pair (left pixel in the low
// half), so each min/max serves two pixels.  Hopper fuses min(min(a, b), c)
// into one VHMNMX, so a run of 9 is taken as three runs of 3 (arc_extreme):
// 40 instructions a side, 80 a pair, where two-input reductions would take
// 57 a side by van Herk / Gil-Werman (and the TPU kernel's log-doubling
// 79).  The packed min/max issue about once a clock per SM (PERF.md), so
// they, not memory, set the time.  The integer route (pairs staged as
// order-preserving int16 and reduced with sm_90's min.s16x2 / max.s16x2,
// fused into as many VIMNMX3) was no faster on the H100, and splitting A
// and B between the two routes was slower: they share one pipe.
//
// What bounds it on the H100, by the card's peaks: memory.  A pixel is
// read once (4 B) and its score written once (4 B): 8.56 Mpixel a
// 1920x1440 frame of 8 levels, 68 MB, 20.4 us at 3.35 TB/s; the fewest
// bf16 operations a pixel, 119 (2 x 57 arc reductions, 2 differences,
// 2 roundings, 1 max), take 15.2 us at 67 T/s.  Design:
//   - one launch for the frame: the levels' pointers and sizes travel in
//     a by-value kernel parameter with a prefix table of their tile
//     counts (no host-to-device copy, so the launch can be captured in a
//     CUDA graph); a block finds its level from blockIdx.x, and no tile
//     crosses levels;
//   - a block of 32 x 4 threads owns a 128 x 32 output tile and stages its
//     input (38 rows x 136 columns) in shared memory once, rounded to bf16
//     pairs, zeros outside the image;
//   - a thread owns 4 adjacent columns (two pairs) and walks down 8 rows
//     with the 7 ring rows x 6 words of its columns in registers: one row
//     (3 LDS.64, 24 B) enters the window per output row, so shared-memory
//     reads are 6 B a pixel (16 x 4 B before).  The 10 ring offsets with
//     odd dx take their pair from two words with one __byte_perm;
//   - scores leave through a shared-memory tile as coalesced rows.

#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreadsX = 32;
constexpr int kThreadsY = 4;
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kColsPerThread = 4;                 // two bf16 pairs
constexpr int kRowsPerThread = 8;
constexpr int kTileW = kThreadsX * kColsPerThread;   // 128
constexpr int kTileH = kThreadsY * kRowsPerThread;   // 32
constexpr int kHalo = 3;
constexpr int kInRows = kTileH + 2 * kHalo;          // 38
// staged columns x0 - 4 .. x0 + kTileW + 3, two to a word, so that a
// thread's 12 columns x - 4 .. x + 7 are 8-byte aligned words 2tx..2tx+5
constexpr int kInWords = (kTileW + 8) / 2;           // 68
constexpr int kWinWords = 6;
constexpr int kMaxLevels = 8;
static_assert(kTileW == kThreads, "one output column per thread on store");

struct Levels {
  const float* img[kMaxLevels];
  float* out[kMaxLevels];
  int height[kMaxLevels];
  int width[kMaxLevels];
  int tiles_x[kMaxLevels];
  int first_tile[kMaxLevels];  // prefix sums of the levels' tile counts
  int n;
};

struct MinBf16 {
  __device__ __forceinline__ static uint32_t op(uint32_t a, uint32_t b) {
    uint32_t r;
    asm("min.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
  }
};
struct MaxBf16 {
  __device__ __forceinline__ static uint32_t op(uint32_t a, uint32_t b) {
    uint32_t r;
    asm("max.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
  }
};

// Reduce each of the 16 circular runs r[k..k+8] with In, and the 16 run
// results with Out (A: In = min, Out = max; B: the mirror image).  A run
// of 9 is three runs of 3: t[k] = In(r[k..k+2]), run k = In(t[k], t[k+3],
// t[k+6]).  Every reduction is written In(In(a, b), c) with the inner
// result used once, which ptxas fuses into one three-input VHMNMX: 16 +
// 16 instructions for the runs and 8 for Out, 40 a side.
template <class In, class Out>
__device__ __forceinline__ uint32_t arc_extreme(const uint32_t (&r)[16]) {
  uint32_t t[16];
#pragma unroll
  for (int k = 0; k < 16; ++k)
    t[k] = In::op(In::op(r[k], r[(k + 1) & 15]), r[(k + 2) & 15]);
  uint32_t run[16];
#pragma unroll
  for (int k = 0; k < 16; ++k)
    run[k] = In::op(In::op(t[k], t[(k + 3) & 15]), t[(k + 6) & 15]);
  uint32_t m[6];
#pragma unroll
  for (int j = 0; j < 5; ++j)
    m[j] = Out::op(Out::op(run[3 * j], run[3 * j + 1]), run[3 * j + 2]);
  m[5] = run[15];
  return Out::op(Out::op(Out::op(m[0], m[1]), m[2]),
                 Out::op(Out::op(m[3], m[4]), m[5]));
}

// the pair of pixels (x + dx, x + dx + 1) of a window row whose word c
// holds the pair (x, x + 1)
__device__ __forceinline__ uint32_t pair_at(const uint32_t (&row)[kWinWords],
                                            int c, int dx) {
  if (dx & 1) {
    const int a = c + ((dx - 1) >> 1);
    return __byte_perm(row[a], row[a + 1], 0x5432);
  }
  return row[c + (dx >> 1)];
}

__device__ __forceinline__ float lo_f32(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_f32(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}
__device__ __forceinline__ uint32_t bf16x2_rn(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// scores of the pair in word c of the window's centre row (window row
// 3 + dy holds ring row dy)
__device__ __forceinline__ uint32_t pair_score(
    const uint32_t (&win)[7][kWinWords], int c) {
  const uint32_t r[16] = {
      pair_at(win[0], c, 0),  pair_at(win[0], c, 1),  pair_at(win[1], c, 2),
      pair_at(win[2], c, 3),  pair_at(win[3], c, 3),  pair_at(win[4], c, 3),
      pair_at(win[5], c, 2),  pair_at(win[6], c, 1),  pair_at(win[6], c, 0),
      pair_at(win[6], c, -1), pair_at(win[5], c, -2), pair_at(win[4], c, -3),
      pair_at(win[3], c, -3), pair_at(win[2], c, -3), pair_at(win[1], c, -2),
      pair_at(win[0], c, -1)};
  const uint32_t a = arc_extreme<MinBf16, MaxBf16>(r);
  const uint32_t b = arc_extreme<MaxBf16, MinBf16>(r);
  const uint32_t p = win[3][c];
  const uint32_t bright = bf16x2_rn(__fsub_rn(lo_f32(a), lo_f32(p)),
                                    __fsub_rn(hi_f32(a), hi_f32(p)));
  const uint32_t dark = bf16x2_rn(__fsub_rn(lo_f32(b), lo_f32(p)),
                                  __fsub_rn(hi_f32(b), hi_f32(p))) ^
                        0x80008000u;
  return MaxBf16::op(bright, dark);
}

__global__ void __launch_bounds__(kThreads)
fast_score_kernel(const __grid_constant__ Levels levels) {
  __shared__ __align__(16) uint32_t s_in[kInRows][kInWords];
  __shared__ __align__(16) float s_out[kTileH][kTileW];

  // this block's level: the last whose first tile is at or before it
  const int bid = blockIdx.x;
  const float* img = levels.img[0];
  float* out = levels.out[0];
  int height = levels.height[0], width = levels.width[0];
  int tiles_x = levels.tiles_x[0], first = 0;
#pragma unroll
  for (int l = 1; l < kMaxLevels; ++l) {
    if (l < levels.n && bid >= levels.first_tile[l]) {
      img = levels.img[l];
      out = levels.out[l];
      height = levels.height[l];
      width = levels.width[l];
      tiles_x = levels.tiles_x[l];
      first = levels.first_tile[l];
    }
  }
  const int tile = bid - first;
  const int ty0 = tile / tiles_x;
  const int x0 = (tile - ty0 * tiles_x) * kTileW;
  const int y0 = ty0 * kTileH;
  const int tx = threadIdx.x;
  const int tid = threadIdx.y * kThreadsX + tx;

  for (int i = tid; i < kInRows * kInWords; i += kThreads) {
    const int r = i / kInWords;
    const int c = i - r * kInWords;
    const int gy = y0 - kHalo + r;
    const int gx = x0 - 4 + 2 * c;
    float left = 0.0f, right = 0.0f;
    if (gy >= 0 && gy < height) {
      const float* row = img + (size_t)gy * width;
      if (gx >= 0 && gx < width) left = row[gx];
      if (gx + 1 >= 0 && gx + 1 < width) right = row[gx + 1];
    }
    s_in[r][c] = bf16x2_rn(left, right);
  }
  __syncthreads();

  // window rows: output row i of this thread has its ring rows in
  // win[0..6], staged rows r0 + i .. r0 + i + 6
  const int r0 = threadIdx.y * kRowsPerThread;
  uint32_t win[7][kWinWords];
  auto load_row = [&](uint32_t (&dst)[kWinWords], int r) {
    const uint2* src = reinterpret_cast<const uint2*>(&s_in[r][2 * tx]);
#pragma unroll
    for (int j = 0; j < kWinWords / 2; ++j) {
      const uint2 v = src[j];
      dst[2 * j] = v.x;
      dst[2 * j + 1] = v.y;
    }
  };
#pragma unroll
  for (int k = 0; k < 6; ++k) load_row(win[k], r0 + k);
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    load_row(win[6], r0 + i + 6);
    const uint32_t s01 = pair_score(win, 2);
    const uint32_t s23 = pair_score(win, 3);
    *reinterpret_cast<float4*>(&s_out[r0 + i][kColsPerThread * tx]) =
        make_float4(lo_f32(s01), hi_f32(s01), lo_f32(s23), hi_f32(s23));
#pragma unroll
    for (int k = 0; k < 6; ++k) {
#pragma unroll
      for (int j = 0; j < kWinWords; ++j) win[k][j] = win[k + 1][j];
    }
  }
  __syncthreads();

  const int gx = x0 + tid;
  if (gx < width) {
    for (int r = 0; r < kTileH && y0 + r < height; ++r)
      out[(size_t)(y0 + r) * width + gx] = s_out[r][tid];
  }
}

}  // namespace

// K1 for n_levels (1..8) images in one launch.  imgs[l], outs[l]: host
// arrays of device pointers to (heights[l], widths[l]) float32,
// contiguous, on the current device.  Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int orb_fast_score_levels(const void* const* imgs,
                                     void* const* outs, const int* heights,
                                     const int* widths, int n_levels,
                                     void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels)
    return static_cast<int>(cudaErrorInvalidValue);
  Levels levels{};
  long long tiles = 0;
  for (int l = 0; l < n_levels; ++l) {
    if (heights[l] < 1 || widths[l] < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    levels.img[l] = static_cast<const float*>(imgs[l]);
    levels.out[l] = static_cast<float*>(outs[l]);
    levels.height[l] = heights[l];
    levels.width[l] = widths[l];
    levels.tiles_x[l] = (widths[l] + kTileW - 1) / kTileW;
    levels.first_tile[l] = static_cast<int>(tiles);
    const int tiles_y = (heights[l] + kTileH - 1) / kTileH;
    tiles += (long long)levels.tiles_x[l] * tiles_y;
    if (tiles > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  }
  levels.n = n_levels;
  fast_score_kernel<<<static_cast<unsigned>(tiles), dim3(kThreadsX, kThreadsY),
                      0, static_cast<cudaStream_t>(stream)>>>(levels);
  return static_cast<int>(cudaGetLastError());
}
