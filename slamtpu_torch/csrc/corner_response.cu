// Kernel K1: fused FAST-9/16 score + strict 3x3 NMS + Harris ranking, one
// launch over every pyramid level of a batch.
//
// Replaces the Pallas TPU kernel slamtpu/ops/pallas_corner.py::corner_response
// (body `_kernel`, pallas_call at pallas_corner.py:165). Plain PyTorch version:
// slamtpu_torch/ops/corner.py::corner_response_plain (fast_score -> nms3x3,
// harris_response).
//
// What bounds it on the H100. Per pixel it reads 4 B and writes 4 B (8 B
// where the dense Harris map is asked for): ~500 MB for a 32-frame chunk of
// 8 levels, 0.15 ms at 3.35 TB/s. The operations needed are fewer: a compass
// pre-test on every pixel, Harris on every pixel, and the full FAST tree
// only on the few pixels that pass the pre-test (~100 f32 operations a
// pixel, ~0.07 ms at 67 TFLOP/s). So bytes bind in principle; in practice
// the kernel is held by instruction issue (some 200 instructions a pixel
// against ~100 operations) and by the latency of the short per-candidate
// FAST trees between block barriers. The design answers what it can:
//
// * One launch for all levels. A per-level table (pointers, H, W, first
//   tile) travels by value in the kernel parameters; a persistent grid (as
//   many blocks as fit on the SMs: 3 a SM, ~75 KB of shared memory each)
//   walks the 32x58 output tiles of every frame of every level in order,
//   so the small levels leave no tail of their own and consecutive blocks
//   share halo rows in L2.
// * Overlapped, vectorised loads. The 40x66 tile (a 4-pixel halo) is copied
//   with cp.async into one of two shared buffers while the block computes
//   on the other: clear of the border as the 16-byte-aligned float4s around
//   each row (the rows of a level are not 16-byte aligned, so each row lands
//   shifted by 0-3 columns, a shift every reader adds), at the border one
//   edge-clamped float at a time.
// * FAST in two passes. (a) The compass pre-test of every pixel of the tile
//   and its 1-pixel NMS ring: every 9-long arc holds two adjacent compass
//   points (circle indices 0, 4, 8, 12), so a pixel without two adjacent
//   compass differences above the threshold (bright) or below its negative
//   (dark) scores exactly 0 (ops/fast.py::fast_candidates). It runs inside
//   the Harris column walk below, on that walk's register window of the
//   column. (b) Each warp compacts its survivors into its own list with
//   ballots, no atomics. (c) The same warp runs one 9-arc min-max tree per
//   survivor: on sgn * (circle - centre), sgn = -1 for a pixel that passed
//   only the dark test (the plain version's dark score is this tree on the
//   negated differences), +1 otherwise; the other side is at most the
//   threshold. Both trees run only where both tests passed.
// * Harris with few shared accesses. A thread walks one gradient column
//   down 8 output rows, keeps its 3x3 Sobel inputs and its last 7 gradient
//   products in registers and writes only the three vertical 7-sums. After
//   the block's barrier a thread walks 8 columns along one output row with
//   the vertical sums and the FAST scores of its 3x3 NMS window in
//   registers, and stages the ranked value and Harris in shared memory.
// * Two barriers a tile. The staged results of a tile are stored
//   row-contiguously at the start of the next tile, whose column walk and
//   FAST trees need no barrier between them (the trees read only their own
//   warp's list).
// * No integer division per element: every strided walk advances its row
//   and column incrementally; the phases are branch-free where they can be.
//
// Harris is computed with explicit round-to-nearest intrinsics in the plain
// version's summation order (Sobel as written, vertical sums before
// horizontal, each taken as x, x-1, x+1, x-2, x+2, x-3, x+3), so no
// multiply-add is contracted into an FMA and every pixel at least 4 px from
// the border is bit-identical to the plain version on the card. Within 4 px
// of the border the halo is clamped where the plain version wraps, so
// Harris differs there; the corner set is identical everywhere (the FAST
// score is zero on the 3-pixel border either way). The detector discards a
// 31-pixel border.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int TILE_H = 32;
constexpr int TILE_W = 58;
constexpr int HALO = 4;                   // FAST radius 3 + NMS 1; Sobel 1 + box 3
constexpr int IMG_H = TILE_H + 2 * HALO;  // image rows y0-4 .. y0+35
constexpr int IMG_W = TILE_W + 2 * HALO;
constexpr int IMG_V = (IMG_W + 3 + 3) / 4;  // float4s a row needs from any 16-byte alignment
constexpr int IMG_P = 4 * IMG_V;            // row pitch of the image buffer
constexpr int SC_H = TILE_H + 2;          // FAST scores on output rows -1 .. TILE_H
constexpr int SC_W = TILE_W + 2;
constexpr int SC_P = SC_W + 1;            // odd pitch: the row walk reads a column per warp
constexpr int GR_W = TILE_W + 6;          // gradient columns -3 .. TILE_W+2
constexpr int V_P = GR_W + 1;
constexpr int ST_P = TILE_W + 1;          // staged results
constexpr int SEG_ROWS = 8;               // column walk: output rows per thread
constexpr int SEG_COLS = 8;               // row walk: output columns per thread
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CAND_PER_WARP = 32 * (SEG_ROWS + 2);  // a warp's share of the ring at most
constexpr int LOADS = (IMG_H * IMG_W + THREADS - 1) / THREADS;     // tile elements per thread (at the border)
constexpr int LOADS_V = (IMG_H * IMG_V + THREADS - 1) / THREADS;   // tile float4s per thread (inside)
constexpr int STORES = (TILE_H * TILE_W + THREADS - 1) / THREADS;  // outputs per thread
constexpr int MIN_BLOCKS = 3;             // per SM, with ~75 KB of shared memory each
constexpr int MAX_LEVELS = 16;

static_assert(GR_W * (TILE_H / SEG_ROWS) == THREADS, "column walk: one thread per (gradient column, 8 rows)");
static_assert(TILE_H == 32 && (TILE_W + SEG_COLS - 1) / SEG_COLS == WARPS,
              "row walk: lane = output row, warp = 8-column segment");
static_assert(SC_H <= 64 && SC_W <= 64, "candidate positions pack into 6 + 6 bits");
static_assert(GR_W == SC_W + 4 && HALO == 4, "the column walk covers the ring's columns, 2 spare on each side");

struct Level {
  const float* img;  // [B, H, W]
  float* ranked;     // [B, H, W]
  float* harris;     // [B, H, W] or null
  int H, W, tiles_x, tiles_per_frame, first_tile;
};

struct Table {
  Level lv[MAX_LEVELS];
  int n_levels, total_tiles;
  float threshold;
};

struct Smem {
  float img[2][IMG_H][IMG_P];              // double-buffered tile + halo, row r shifted by Tile::shift(r)
  float score[SC_H][SC_P];                 // FAST score of the tile and its 1-pixel ring
  float v[3][TILE_H][V_P];                 // vertical 7-sums of gx*gx, gy*gy, gx*gy
  float ranked[TILE_H * ST_P];             // staged outputs of the previous tile
  float harris[TILE_H * ST_P];
  uint16_t cand[WARPS][CAND_PER_WARP];     // pre-test survivors: (kind << 12) | (row << 6) | col
};

constexpr unsigned BRIGHT = 1u << 12, DARK = 1u << 13;

// Bresenham circle of radius 3, clockwise from 12 o'clock (ops/fast.py).
// Compile-time offsets, so that an unrolled loop folds them into addresses.
__host__ __device__ constexpr int circle_dy(int k) {
  constexpr int dy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  return dy[k];
}
__host__ __device__ constexpr int circle_dx(int k) {
  constexpr int dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  return dx[k];
}

// max over the 16 circular arcs of min over 9 consecutive entries.
__device__ __forceinline__ float arc9_max_of_min(const float (&d)[16]) {
  float w2[16], w4[16], w8[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) w2[k] = fminf(d[k], d[(k + 1) & 15]);
#pragma unroll
  for (int k = 0; k < 16; ++k) w4[k] = fminf(w2[k], w2[(k + 2) & 15]);
#pragma unroll
  for (int k = 0; k < 16; ++k) w8[k] = fminf(w4[k], w4[(k + 4) & 15]);
  float m[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) m[k] = fminf(w8[k], w8[(k + 1) & 15]);
  // A balanced max: 4 dependent steps, not 16.
#pragma unroll
  for (int k = 0; k < 8; ++k) m[k] = fmaxf(m[k], m[k + 8]);
#pragma unroll
  for (int k = 0; k < 4; ++k) m[k] = fmaxf(m[k], m[k + 4]);
  return fmaxf(fmaxf(m[0], m[2]), fmaxf(m[1], m[3]));
}

// The 7-sum of a register window in the plain version's order.
__device__ __forceinline__ float sum7(const float (&w)[7]) {
  float acc = w[3];
  acc = __fadd_rn(__fadd_rn(acc, w[2]), w[4]);
  acc = __fadd_rn(__fadd_rn(acc, w[1]), w[5]);
  return __fadd_rn(__fadd_rn(acc, w[0]), w[6]);
}

// A thread's place in a walk over a [rows, WIDTH] grid in steps of THREADS.
template <int WIDTH>
struct Walk {
  int r, c;
  __device__ __forceinline__ explicit Walk(int i) : r(i / WIDTH), c(i % WIDTH) {}
  __device__ __forceinline__ void next() {
    r += THREADS / WIDTH;
    c += THREADS % WIDTH;
    if (c >= WIDTH) {
      c -= WIDTH;
      ++r;
    }
  }
};

struct Tile {
  int level, b, y0, x0;
  int s0, wm;  // image-buffer row r starts at column (s0 + r * wm) & 3
  __device__ __forceinline__ int shift(int r) const { return (s0 + r * wm) & 3; }
};

// Tile index -> (level, frame, origin); `level` only moves forward.
__device__ __forceinline__ void locate(const Table& tab, int t, Tile& out) {
  while (out.level + 1 < tab.n_levels && t >= tab.lv[out.level + 1].first_tile) ++out.level;
  const Level& L = tab.lv[out.level];
  const int local = t - L.first_tile;
  out.b = local / L.tiles_per_frame;
  const int rem = local - out.b * L.tiles_per_frame;
  const int ty = rem / L.tiles_x;
  out.y0 = ty * TILE_H;
  out.x0 = (rem - ty * L.tiles_x) * TILE_W;
}

// Tile + halo into `dst`, asynchronously (one commit group). Inside the
// image each row is copied as the 16-byte-aligned float4s around it, so
// element (r, c) lands at column c + t.shift(r); the aligned span reaches
// at most 3 floats before and 6 after the row's 66, which stay inside the
// frame because the tile's rows are neither its first nor its last. At the
// border every element is copied alone, edge-clamped, with no shift.
__device__ __forceinline__ void load_tile(float (*dst)[IMG_P], const Level& L, Tile& t, int tid) {
  const float* src = L.img + (size_t)t.b * L.H * L.W;
  const int W = L.W;
  if (t.y0 - HALO >= 1 && t.y0 - HALO + IMG_H < L.H && t.x0 >= HALO && t.x0 - HALO + IMG_W <= W) {
    const float* row0 = src + (size_t)(t.y0 - HALO) * W + (t.x0 - HALO);
    t.s0 = static_cast<int>((reinterpret_cast<uintptr_t>(row0) >> 2) & 3);
    t.wm = W & 3;
    Walk<IMG_V> w(tid);
#pragma unroll
    for (int i = 0; i < LOADS_V; ++i, w.next())
      if (w.r < IMG_H)
        __pipeline_memcpy_async(&dst[w.r][4 * w.c], row0 + (w.r * W - t.shift(w.r) + 4 * w.c), 16);
  } else {
    t.s0 = t.wm = 0;
    Walk<IMG_W> w(tid);
#pragma unroll
    for (int i = 0; i < LOADS; ++i, w.next()) {
      const int gy = min(max(t.y0 - HALO + w.r, 0), L.H - 1);
      const int gx = min(max(t.x0 - HALO + w.c, 0), W - 1);
      if (w.r < IMG_H) __pipeline_memcpy_async(&dst[w.r][w.c], src + (size_t)gy * W + gx, sizeof(float));
    }
  }
  __pipeline_commit();
}

// The staged ranked (and Harris) values of tile `t` to global memory,
// consecutive threads on consecutive columns of an output row.
__device__ __forceinline__ void store_tile(const Smem& s, const Level& L, const Tile& t, Walk<TILE_W> w) {
  const int H = L.H, W = L.W;
  const size_t base = (size_t)t.b * H * W + (size_t)t.y0 * W + t.x0;
  float* const ranked = L.ranked + base;
  float* const harris = L.harris == nullptr ? nullptr : L.harris + base;
  const bool inside = t.y0 + TILE_H <= H && t.x0 + TILE_W <= W;
#pragma unroll
  for (int i = 0; i < STORES; ++i, w.next()) {
    if ((w.r < TILE_H) & (inside | ((t.y0 + w.r < H) & (t.x0 + w.c < W)))) {
      const int o = w.r * W + w.c;
      ranked[o] = s.ranked[w.r * ST_P + w.c];
      if (harris != nullptr) harris[o] = s.harris[w.r * ST_P + w.c];
    }
  }
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) corner_kernel(const __grid_constant__ Table tab) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  const float thr = tab.threshold;
  const Walk<TILE_W> out_walk(tid);
  const int seg_r0 = (tid / GR_W) * SEG_ROWS, gc = tid % GR_W;  // column walk
  const int row_c0 = warp * SEG_COLS;                              // row walk (row = lane)

  int t = blockIdx.x;
  if (t >= tab.total_tiles) return;
  Tile cur{0, 0, 0, 0, 0, 0}, prev{-1, 0, 0, 0, 0, 0};
  locate(tab, t, cur);
  load_tile(s.img[0], tab.lv[cur.level], cur, tid);

  for (int buf = 0; t < tab.total_tiles; buf ^= 1) {
    const Level& L = tab.lv[cur.level];
    const int H = L.H, W = L.W, y0 = cur.y0, x0 = cur.x0;
    const float(*im)[IMG_P] = s.img[buf];
    const auto row = [&](int r) { return &im[r][0] + cur.shift(r); };  // image-buffer row r, column 0
    __pipeline_wait_prior(0);
    __syncthreads();  // this tile is in shared memory; the previous tile is staged

    // Prefetch the next tile into the other buffer while this one computes.
    const int t_next = t + gridDim.x;
    Tile nxt = cur;
    if (t_next < tab.total_tiles) {
      locate(tab, t_next, nxt);
      load_tile(s.img[buf ^ 1], tab.lv[nxt.level], nxt, tid);
    }
    if (prev.level >= 0) store_tile(s, tab.lv[prev.level], prev, out_walk);

    // Column walk: Sobel, gradient products and vertical 7-sums of output
    // rows seg_r0 .. seg_r0+7 at gradient column gc (tile column gc-3,
    // image-buffer column gc+1); gradient row k of the walk is output row
    // seg_r0-3+k, image-buffer row seg_r0+1+k. On the way, (a) the compass
    // pre-test of ring pixels in image-buffer column gc+1 (ring column gc-2),
    // rows seg_r0+3 .. seg_r0+10 (the last segment also the ring's last two
    // rows), from a 7-row register window of that column, and (b) per-warp
    // compaction of the survivors.
    uint16_t* const list = s.cand[warp];
    int n_cand = 0;  // warp-uniform
    {
      const bool clear = y0 >= 4 && y0 + SC_H + 2 <= H && x0 >= 4 && x0 + SC_W + 2 <= W;
      const bool ring_col = gc >= 2 && gc < SC_W + 2;
      const int gx = x0 - HALO + gc + 1;
      const bool col_ok = ring_col & (clear | ((gx >= 3) & (gx < W - 3)));
      const int lc = max(gc - 2, 0), rc = min(gc + 4, IMG_W - 1);  // compass columns (clamped off the ring)
      const int ring_rows = seg_r0 + SEG_ROWS == TILE_H ? SEG_ROWS + 2 : SEG_ROWS;
      const float* ra = row(seg_r0) + gc;
      const float* rb = row(seg_r0 + 1) + gc;
      float a0 = ra[0], a1 = ra[1], a2 = ra[2];
      float b0 = rb[0], b1 = rb[1], b2 = rb[2];
      float col[7] = {0.f, 0.f, 0.f, 0.f, 0.f, a1, b1};  // column gc+1, newest last
      float pxx[7] = {}, pyy[7] = {}, pxy[7] = {};
#pragma unroll
      for (int k = 0; k < SEG_ROWS + 6; ++k) {
        const int rk = seg_r0 + k + 2;
        const float* rc_ = row(rk) + gc;
        const float c0 = rc_[0], c1 = rc_[1], c2 = rc_[2];
#pragma unroll
        for (int q = 0; q < 6; ++q) col[q] = col[q + 1];
        col[6] = c1;
        if (k >= 4 && k - 4 < ring_rows) {  // warp-uniform
          const int y = rk - 3, sr = y - 3;  // compass centre: image-buffer row y, ring row sr
          const int gy = y0 - HALO + y;
          const float ctr = col[3];
          const float* ry = row(y);
          const float d0 = col[0] - ctr, d4 = ry[rc] - ctr, d8 = col[6] - ctr, d12 = ry[lc] - ctr;
          const bool valid = col_ok & (clear | ((gy >= 3) & (gy < H - 3)));
          // Two cyclically adjacent compass points pass iff one of the
          // opposite pair {0, 8} and one of {4, 12} do (on a 4-cycle
          // every point of one pair neighbours both of the other).
          const bool bright = (fmaxf(d0, d8) > thr) & (fmaxf(d4, d12) > thr);
          const bool dark = (-fminf(d0, d8) > thr) & (-fminf(d4, d12) > thr);
          const unsigned kind = valid ? (bright ? BRIGHT : 0u) | (dark ? DARK : 0u) : 0u;
          if (ring_col) s.score[sr][gc - 2] = 0.f;
          const unsigned ballot = __ballot_sync(0xffffffffu, kind != 0u);
          if (kind) list[n_cand + __popc(ballot & lanes_below)] = static_cast<uint16_t>(kind | (sr << 6) | (gc - 2));
          n_cand += __popc(ballot);
        }
        const float sx = __fsub_rn(__fadd_rn(__fadd_rn(a2, __fmul_rn(2.f, b2)), c2),
                                    __fadd_rn(__fadd_rn(a0, __fmul_rn(2.f, b0)), c0));
        const float sy = __fsub_rn(__fadd_rn(__fadd_rn(c0, __fmul_rn(2.f, c1)), c2),
                                    __fadd_rn(__fadd_rn(a0, __fmul_rn(2.f, a1)), a2));
#pragma unroll
        for (int q = 0; q < 6; ++q) {
          pxx[q] = pxx[q + 1];
          pyy[q] = pyy[q + 1];
          pxy[q] = pxy[q + 1];
        }
        pxx[6] = __fmul_rn(sx, sx);
        pyy[6] = __fmul_rn(sy, sy);
        pxy[6] = __fmul_rn(sx, sy);
        if (k >= 6) {
          const int r = seg_r0 + k - 6;
          s.v[0][r][gc] = sum7(pxx);
          s.v[1][r][gc] = sum7(pyy);
          s.v[2][r][gc] = sum7(pxy);
        }
        a0 = b0, a1 = b1, a2 = b2;
        b0 = c0, b1 = c1, b2 = c2;
      }
    }
    __syncwarp();

    // (c) The FAST tree on this warp's survivors only.
    for (int j = lane; j < n_cand; j += 32) {
      const int p = list[j], r = (p >> 6) & 63, c = p & 63;
      const int ty = r + HALO - 1, tx = c + HALO - 1;
      const float* rows[7];
#pragma unroll
      for (int i = 0; i < 7; ++i) rows[i] = row(ty - 3 + i) + tx;
      const float ctr = rows[3][0];
      const unsigned kind = p & (BRIGHT | DARK);
      // d = sgn * (circle - centre), one rounding: the plain differences,
      // negated for a pixel that passed only the dark test.
      const float sgn = kind == DARK ? -1.f : 1.f, nc = __fmul_rn(-ctr, sgn);
      float d[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) d[k] = __fmaf_rn(rows[3 + circle_dy(k)][circle_dx(k)], sgn, nc);
      float sc = arc9_max_of_min(d);
      if (kind == (BRIGHT | DARK)) {
#pragma unroll
        for (int k = 0; k < 16; ++k) d[k] = -d[k];
        sc = fmaxf(sc, arc9_max_of_min(d));
      }
      s.score[r][c] = sc > thr ? sc : 0.f;
    }

    __syncthreads();  // scores and vertical sums complete; the previous tile is stored

    // Row walk: horizontal 7-sums, Harris and NMS of output row `lane`,
    // columns row_c0 .. row_c0+7, staged for the store.
    {
      const int r = lane;
      const bool want_harris = L.harris != nullptr;
      float v0[7], v1[7], v2[7], n0[3], n1[3], n2[3], cmax[3];
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        v0[k + 1] = s.v[0][r][row_c0 + k];
        v1[k + 1] = s.v[1][r][row_c0 + k];
        v2[k + 1] = s.v[2][r][row_c0 + k];
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        n0[k + 1] = s.score[r][row_c0 + k];
        n1[k + 1] = s.score[r + 1][row_c0 + k];
        n2[k + 1] = s.score[r + 2][row_c0 + k];
        cmax[k + 1] = fmaxf(fmaxf(n0[k + 1], n1[k + 1]), n2[k + 1]);
      }
#pragma unroll
      for (int j = 0; j < SEG_COLS; ++j) {
        const int c = row_c0 + j;
        if (c >= TILE_W) break;  // the last warp's segment is short
#pragma unroll
        for (int k = 0; k < 6; ++k) v0[k] = v0[k + 1], v1[k] = v1[k + 1], v2[k] = v2[k + 1];
        v0[6] = s.v[0][r][c + 6];
        v1[6] = s.v[1][r][c + 6];
        v2[6] = s.v[2][r][c + 6];
#pragma unroll
        for (int k = 0; k < 2; ++k) n0[k] = n0[k + 1], n1[k] = n1[k + 1], n2[k] = n2[k + 1], cmax[k] = cmax[k + 1];
        n0[2] = s.score[r][c + 2];
        n1[2] = s.score[r + 1][c + 2];
        n2[2] = s.score[r + 2][c + 2];
        cmax[2] = fmaxf(fmaxf(n0[2], n1[2]), n2[2]);

        const float sxx = sum7(v0), syy = sum7(v1), sxy = sum7(v2);
        const float det = __fsub_rn(__fmul_rn(sxx, syy), __fmul_rn(sxy, sxy));
        const float tr = __fadd_rn(sxx, syy);
        const float h = __fsub_rn(det, __fmul_rn(__fmul_rn(0.04f, tr), tr));

        const float sc = n1[1];
        const float nmax = fmaxf(fmaxf(cmax[0], cmax[2]), fmaxf(n0[1], n2[1]));  // the 8 neighbours
        s.ranked[r * ST_P + c] = sc > nmax && sc > 0.f ? h : -CUDART_INF_F;
        if (want_harris) s.harris[r * ST_P + c] = h;
      }
    }
    prev = cur;
    t = t_next;
    cur = nxt;
  }
  __syncthreads();
  store_tile(s, tab.lv[prev.level], prev, out_walk);
}

}  // namespace

// One launch over `n_levels` pyramid levels of B frames each. `ptrs` holds
// three device pointers per level (image [B, H, W] f32, ranked output,
// dense Harris output or 0), `dims` H and W per level. ranked = Harris
// where a FAST corner survives NMS, -inf elsewhere. Launches on `stream`;
// returns a cudaError_t (0 on success, the launch checked).
extern "C" int launch_corner_levels(int n_levels, const unsigned long long* ptrs, const int* dims, int B,
                                    float threshold, void* stream) {
  if (n_levels < 0 || n_levels > MAX_LEVELS || B < 0) return static_cast<int>(cudaErrorInvalidValue);
  Table tab{};
  tab.threshold = threshold;
  int tiles = 0;
  for (int i = 0; i < n_levels; ++i) {
    const int H = dims[2 * i], W = dims[2 * i + 1];
    if (H <= 0 || W <= 0 || B == 0) continue;
    Level& L = tab.lv[tab.n_levels++];
    L.img = reinterpret_cast<const float*>(ptrs[3 * i]);
    L.ranked = reinterpret_cast<float*>(ptrs[3 * i + 1]);
    L.harris = reinterpret_cast<float*>(ptrs[3 * i + 2]);
    L.H = H;
    L.W = W;
    L.tiles_x = (W + TILE_W - 1) / TILE_W;
    L.tiles_per_frame = L.tiles_x * ((H + TILE_H - 1) / TILE_H);
    L.first_tile = tiles;
    tiles += B * L.tiles_per_frame;
  }
  tab.total_tiles = tiles;
  if (tiles == 0) return 0;

  static int grid_for_device[64];  // persistent grid size, found once per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (grid_for_device[dev] == 0) {
    err = cudaFuncSetAttribute(corner_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sizeof(Smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, corner_kernel, THREADS, sizeof(Smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    grid_for_device[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int grid = tiles < grid_for_device[dev] ? tiles : grid_for_device[dev];
  corner_kernel<<<grid, THREADS, sizeof(Smem), static_cast<cudaStream_t>(stream)>>>(tab);
  return static_cast<int>(cudaGetLastError());
}
