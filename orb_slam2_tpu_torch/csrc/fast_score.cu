// K1: dense FAST-9/16 corner score map for Hopper (sm_90a).
//
// Replaces the TPU kernel orb_slam2_tpu/ops/fast.py:_score_tile_kernel
// (built by _score_map_pallas, dispatched by score_map).  For each pixel
// p the score is the largest, over the 16 runs of 9 contiguous pixels on
// the radius-3 Bresenham ring, of min(ring - p) (bright arc) or
// min(p - ring) (dark arc): the largest threshold at which p is still a
// FAST-9 corner.
//
// Numerics: the input is rounded to bf16 (__float2bfloat16_rn) and every
// ring difference is rounded back to bf16, as the TPU kernel and the
// plain version (fast_score_map) do; min and max are exact, so on the
// interior the result equals the plain version bit for bit.  Pixels
// outside the image read as 0 (the TPU kernel's zero halo); the plain
// version wraps instead, so the outer 3 px differ, and the detector's
// 16 px border masks them.
//
// What bounds it on the H100: memory.  Each pixel is read once from
// device memory (4 B) and written once (4 B); the 2 x 16 x 9 min/max
// operations per pixel are cheap next to that.  8 pyramid levels of a
// 1920x1440 frame are ~7.6 Mpixel, ~61 MB of traffic, ~20 us at
// 3.35 TB/s.  Design: a 32x8 block stages its output tile plus a 3 px
// halo in shared memory once (the 16 ring reads per pixel then hit
// shared memory, not L2), one thread per output pixel, the 16 diffs
// and both arc reductions fully unrolled in registers.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr int kHalo = 3;
constexpr int kSmemW = kTileW + 2 * kHalo;
constexpr int kSmemH = kTileH + 2 * kHalo;

// ring offsets (dy, dx) in circular order, ops/fast.py:CIRCLE
__constant__ int kRingDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3,
                                3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int kRingDx[16] = {0, 1, 2, 3, 3, 3, 2, 1,
                                0, -1, -2, -3, -3, -3, -2, -1};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__global__ void __launch_bounds__(kTileW * kTileH)
fast_score_kernel(const float* __restrict__ img, float* __restrict__ out,
                  int height, int width) {
  __shared__ float tile[kSmemH][kSmemW];
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  for (int i = tid; i < kSmemH * kSmemW; i += kTileW * kTileH) {
    const int ty = i / kSmemW;
    const int tx = i - ty * kSmemW;
    const int gy = y0 + ty - kHalo;
    const int gx = x0 + tx - kHalo;
    float v = 0.0f;
    if (gy >= 0 && gy < height && gx >= 0 && gx < width) {
      v = bf16_round(img[(size_t)gy * width + gx]);
    }
    tile[ty][tx] = v;
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  if (x >= width || y >= height) return;
  const int cy = threadIdx.y + kHalo;
  const int cx = threadIdx.x + kHalo;
  const float p = tile[cy][cx];
  float d[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    d[k] = bf16_round(tile[cy + kRingDy[k]][cx + kRingDx[k]] - p);
  }
  float bright = -INFINITY;  // max over arcs of min(ring - p)
  float dark = -INFINITY;    // max over arcs of min(p - ring)
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    float mn = d[k];
    float mx = d[k];
#pragma unroll
    for (int j = 1; j < 9; ++j) {
      const float v = d[(k + j) & 15];
      mn = fminf(mn, v);
      mx = fmaxf(mx, v);
    }
    bright = fmaxf(bright, mn);
    dark = fmaxf(dark, -mx);
  }
  out[(size_t)y * width + x] = fmaxf(bright, dark);
}

}  // namespace

// img, out: (height, width) float32, contiguous, on the current device.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int orb_fast_score(const float* img, float* out, int height,
                              int width, void* stream) {
  const dim3 block(kTileW, kTileH);
  const dim3 grid((width + kTileW - 1) / kTileW,
                  (height + kTileH - 1) / kTileH);
  fast_score_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      img, out, height, width);
  return static_cast<int>(cudaGetLastError());
}
