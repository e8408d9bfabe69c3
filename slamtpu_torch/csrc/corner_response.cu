// Kernel K1: fused FAST-9/16 score + strict 3x3 NMS + Harris ranking.
//
// Replaces the Pallas TPU kernel slamtpu/ops/pallas_corner.py::corner_response
// (body `_kernel`, pallas_call at pallas_corner.py:165). Plain PyTorch version:
// slamtpu_torch/ops/corner.py::corner_response_plain (fast_score -> nms3x3,
// harris_response).
//
// What bounds it on the H100: per pixel it reads 4 B and writes 4 B (8 B with
// the dense Harris map) and does ~264 f32 operations (FAST min/max trees
// dominate), so it sits near the balance point of HBM (3.35 TB/s) and the
// non-tensor FP32 rate (67 TFLOP/s): at the VO chunk's 46.2 M pixels both
// bounds are ~0.15-0.2 ms. The design keeps every intermediate (the FAST
// score, the gradient products, the vertical box sums) in shared memory, so
// HBM sees each input pixel once (plus a 4-pixel halo) and each output once;
// the unfused plain version materializes 16 shifted copies and a dozen
// full-size temporaries.
//
// Layout: one block per (frame, 16-row x 64-column output tile). The tile
// plus a 4-pixel halo (FAST radius 3 + NMS 1; Sobel 1 + box 3) is loaded
// once, with out-of-image reads clamped to the edge. The plain version rolls
// (wraps) instead, so Harris differs within 4 px of the border; the corner
// set is identical everywhere (the FAST score is zero on the 3-pixel border
// either way). The detector discards a 31-pixel border.
//
// Harris is computed with explicit round-to-nearest intrinsics in the plain
// version's summation order, so no multiply-add is contracted into an FMA
// and the interior values are bit-identical to the plain version on the card.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int TILE_H = 16;
constexpr int TILE_W = 64;
constexpr int HALO = 4;
constexpr int IMG_H = TILE_H + 2 * HALO;  // image rows y0-4 .. y0+19
constexpr int IMG_W = TILE_W + 2 * HALO;
constexpr int SC_H = TILE_H + 2;  // FAST score on output rows -1 .. TILE_H
constexpr int SC_W = TILE_W + 2;
constexpr int GR_H = TILE_H + 6;  // gradient products on rows -3 .. TILE_H+2
constexpr int GR_W = TILE_W + 6;
constexpr int THREADS = 256;

// Bresenham circle of radius 3, clockwise from 12 o'clock (ops/fast.py).
__device__ __constant__ int kCircleDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
__device__ __constant__ int kCircleDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

// max over the 16 circular arcs of min over 9 consecutive entries.
__device__ __forceinline__ float arc9_max_of_min(const float (&d)[16]) {
  float w2[16], w4[16], w8[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) w2[k] = fminf(d[k], d[(k + 1) & 15]);
#pragma unroll
  for (int k = 0; k < 16; ++k) w4[k] = fminf(w2[k], w2[(k + 2) & 15]);
#pragma unroll
  for (int k = 0; k < 16; ++k) w8[k] = fminf(w4[k], w4[(k + 4) & 15]);
  float best = -CUDART_INF_F;
#pragma unroll
  for (int k = 0; k < 16; ++k) best = fmaxf(best, fminf(w8[k], w8[(k + 1) & 15]));
  return best;
}

__global__ void __launch_bounds__(THREADS)
corner_kernel(const float* __restrict__ img, float* __restrict__ ranked,
              float* __restrict__ harris_out, int H, int W, float threshold) {
  __shared__ float s_img[IMG_H][IMG_W];
  __shared__ float s_score[SC_H][SC_W];
  __shared__ float s_p[3][GR_H][GR_W];
  __shared__ float s_v[3][TILE_H][GR_W];

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TILE_H;
  const int x0 = blockIdx.x * TILE_W;
  const size_t plane = (size_t)H * W;
  const float* src = img + b * plane;
  const int tid = threadIdx.x;

  // 1. Tile + halo, edge-clamped.
  for (int i = tid; i < IMG_H * IMG_W; i += THREADS) {
    const int r = i / IMG_W, c = i % IMG_W;
    const int gy = min(max(y0 - HALO + r, 0), H - 1);
    const int gx = min(max(x0 - HALO + c, 0), W - 1);
    s_img[r][c] = src[(size_t)gy * W + gx];
  }
  __syncthreads();

  // 2. FAST-9/16 score on the output tile plus a 1-pixel ring (for NMS).
  for (int i = tid; i < SC_H * SC_W; i += THREADS) {
    const int r = i / SC_W, c = i % SC_W;
    const int gy = y0 - 1 + r, gx = x0 - 1 + c;
    float score = 0.f;
    if (gy >= 3 && gy < H - 3 && gx >= 3 && gx < W - 3) {
      const int ty = r - 1 + HALO, tx = c - 1 + HALO;
      const float center = s_img[ty][tx];
      float d[16], nd[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        d[k] = s_img[ty + kCircleDy[k]][tx + kCircleDx[k]] - center;
        nd[k] = -d[k];
      }
      const float s = fmaxf(arc9_max_of_min(d), arc9_max_of_min(nd));
      score = s > threshold ? s : 0.f;
    }
    s_score[r][c] = score;
  }

  // 3. Sobel gradient products on the output tile plus a 3-pixel ring.
  for (int i = tid; i < GR_H * GR_W; i += THREADS) {
    const int r = i / GR_W, c = i % GR_W;
    const int ty = r - 3 + HALO, tx = c - 3 + HALO;
    const float gx = __fsub_rn(
        __fadd_rn(__fadd_rn(s_img[ty - 1][tx + 1], __fmul_rn(2.f, s_img[ty][tx + 1])), s_img[ty + 1][tx + 1]),
        __fadd_rn(__fadd_rn(s_img[ty - 1][tx - 1], __fmul_rn(2.f, s_img[ty][tx - 1])), s_img[ty + 1][tx - 1]));
    const float gy = __fsub_rn(
        __fadd_rn(__fadd_rn(s_img[ty + 1][tx - 1], __fmul_rn(2.f, s_img[ty + 1][tx])), s_img[ty + 1][tx + 1]),
        __fadd_rn(__fadd_rn(s_img[ty - 1][tx - 1], __fmul_rn(2.f, s_img[ty - 1][tx])), s_img[ty - 1][tx + 1]));
    s_p[0][r][c] = __fmul_rn(gx, gx);
    s_p[1][r][c] = __fmul_rn(gy, gy);
    s_p[2][r][c] = __fmul_rn(gx, gy);
  }
  __syncthreads();

  // 4. Vertical 7-sums (order: x, x-1, x+1, x-2, x+2, x-3, x+3).
  for (int i = tid; i < TILE_H * GR_W; i += THREADS) {
    const int r = i / GR_W, c = i % GR_W;
    const int pr = r + 3;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      float acc = s_p[q][pr][c];
#pragma unroll
      for (int d = 1; d <= 3; ++d) acc = __fadd_rn(__fadd_rn(acc, s_p[q][pr - d][c]), s_p[q][pr + d][c]);
      s_v[q][r][c] = acc;
    }
  }
  __syncthreads();

  // 5. Horizontal 7-sums, Harris, NMS, ranked output.
  for (int i = tid; i < TILE_H * TILE_W; i += THREADS) {
    const int r = i / TILE_W, c = i % TILE_W;
    const int gy = y0 + r, gx = x0 + c;
    if (gy >= H || gx >= W) continue;
    float s[3];
    const int pc = c + 3;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      float acc = s_v[q][r][pc];
#pragma unroll
      for (int d = 1; d <= 3; ++d) acc = __fadd_rn(__fadd_rn(acc, s_v[q][r][pc - d]), s_v[q][r][pc + d]);
      s[q] = acc;
    }
    const float det = __fsub_rn(__fmul_rn(s[0], s[1]), __fmul_rn(s[2], s[2]));
    const float tr = __fadd_rn(s[0], s[1]);
    const float h = __fsub_rn(det, __fmul_rn(__fmul_rn(0.04f, tr), tr));

    const float sc = s_score[r + 1][c + 1];
    float nmax = -CUDART_INF_F;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx)
        if (dy != 0 || dx != 0) nmax = fmaxf(nmax, s_score[r + 1 + dy][c + 1 + dx]);

    const size_t o = b * plane + (size_t)gy * W + gx;
    ranked[o] = (sc > nmax && sc > 0.f) ? h : -CUDART_INF_F;
    if (harris_out != nullptr) harris_out[o] = h;
  }
}

}  // namespace

// [B, H, W] f32 images -> ranked [B, H, W] (Harris where a FAST corner
// survives NMS, -inf elsewhere) and, when `harris` is not null, the dense
// Harris map. Launches on `stream`; returns cudaGetLastError().
extern "C" int launch_corner_response(const float* img, float* ranked, float* harris, int B, int H,
                                      int W, float threshold, void* stream) {
  const dim3 grid((W + TILE_W - 1) / TILE_W, (H + TILE_H - 1) / TILE_H, B);
  corner_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(img, ranked, harris, H, W,
                                                                         threshold);
  return static_cast<int>(cudaGetLastError());
}
