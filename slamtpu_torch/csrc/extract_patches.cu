// Kernel K2: one (2r+1) x (2r+1) window per keypoint, one launch over every
// pyramid level of a batch.
//
// Replaces the Pallas TPU kernel slamtpu/ops/pallas_patch.py::
// extract_patches_batched (body `_kernel`, pallas_call at pallas_patch.py:80).
// Plain PyTorch version: slamtpu_torch/ops/patch.py::extract_patches_plain
// (per-keypoint slices, the semantics of ops/brief.py::extract_patches).
//
// What bounds it on the H100: pure data movement, no arithmetic. A VO chunk
// (32 frames x 500 keypoints x 39 x 39 f32) writes 97 MB and reads the
// distinct window pixels, ~35 MB, about 0.04 ms at 3.35 TB/s. The TPU kernel
// needed aligned VMEM blocks and dynamic rolls to cut unaligned windows. On
// Hopper a warp reads its window's rows straight from global memory through
// the read-only path (__ldg; neighbouring windows overlap in L1 and L2). The
// design:
//
// * One launch for all levels. The output is one [B, K, size, size] tensor
//   whose K slots run through the levels in order (the detector's slot
//   order); a per-level table (image, H, W, first slot) travels by value in
//   the kernel parameters, and a slot finds its level from the first slots.
// * One warp per window, eight windows per block. The block's windows are
//   consecutive in the output (flattened frame x slot), so they start
//   16-byte aligned (a multiple of 4 x size^2 x 4 B); each warp gathers its
//   window into shared memory (47.5 KB for the block at r = 19) and the
//   block stores all eight as float4, consecutive threads on consecutive
//   addresses (on the H100 this beat both four windows a block and warps
//   storing their own window straight to global memory).
// * No integer division per element: the row and column of a lane's next
//   element advance incrementally.
//
// Starts (x0, y0) are clamped to [0, W-size] x [0, H-size], so every read is
// in bounds; the copy is bit-exact by construction. A level given without
// an image (too small for a window) fills its slots with zeros.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_LEVELS = 16;
constexpr int MAX_SMEM = 227 * 1024;

struct Level {
  const float* img;  // [B, H, W], or null: zero windows
  int H, W, first_slot;
};

struct Table {
  Level lv[MAX_LEVELS];
  int n_levels, K, size;
  long long total;    // B * K windows
  const int* starts;  // [B, K, 2] (x0, y0)
  float* out;         // [B, K, size, size]
};

__global__ void __launch_bounds__(THREADS) patch_kernel(const __grid_constant__ Table tab) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* const stage = reinterpret_cast<float*>(smem_raw);
  const int size = tab.size, n = size * size;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long g0 = (long long)blockIdx.x * WARPS;
  const long long g = g0 + warp;  // this warp's window: frame * K + slot

  if (g < tab.total) {
    const int b = static_cast<int>(g / tab.K), slot = static_cast<int>(g - (long long)b * tab.K);
    int lv = 0;
    while (lv + 1 < tab.n_levels && slot >= tab.lv[lv + 1].first_slot) ++lv;
    const Level& L = tab.lv[lv];
    float* const dst = stage + warp * n;
    if (L.img == nullptr) {
      for (int i = lane; i < n; i += 32) dst[i] = 0.f;
    } else {
      const int x0 = min(max(tab.starts[2 * g], 0), L.W - size);
      const int y0 = min(max(tab.starts[2 * g + 1], 0), L.H - size);
      const float* src = L.img + ((size_t)b * L.H + y0) * L.W + x0;
      const int dr = 32 / size, dc = 32 % size;
      int r = lane / size, c = lane % size;
      for (int i = lane; i < n; i += 32) {
        dst[i] = __ldg(src + (size_t)r * L.W + c);
        r += dr;
        c += dc;
        if (c >= size) {
          c -= size;
          ++r;
        }
      }
    }
  }
  __syncthreads();

  const long long left = tab.total - g0;
  const int n_floats = (left < WARPS ? static_cast<int>(left) : WARPS) * n;
  float* const out = tab.out + g0 * n;
  const int n4 = n_floats / 4;
  float4* const out4 = reinterpret_cast<float4*>(out);
  const float4* const stage4 = reinterpret_cast<const float4*>(stage);
  for (int i = threadIdx.x; i < n4; i += THREADS) out4[i] = stage4[i];
  for (int i = 4 * n4 + threadIdx.x; i < n_floats; i += THREADS) out[i] = stage[i];
}

}  // namespace

// One launch over `n_levels` pyramid levels of B frames each. `imgs` holds
// one device pointer per level (images [B, H, W] f32, or 0 for a level whose
// slots are zero), `dims` H, W and the slot count K_l per level. `starts`
// [B, K, 2] int32 (x0, y0) and `out` [B, K, size, size] with K = sum K_l,
// slots in level order. Requires H >= size and W >= size for every level
// with an image. Launches on `stream`; returns a cudaError_t (0 on success,
// the launch checked).
extern "C" int launch_extract_patches_levels(int n_levels, const unsigned long long* imgs, const int* dims,
                                             const int* starts, float* out, int B, int size, void* stream) {
  if (n_levels < 0 || n_levels > MAX_LEVELS || B < 0 || size <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Table tab{};
  int K = 0;
  for (int i = 0; i < n_levels; ++i) {
    const int k = dims[3 * i + 2];
    if (k <= 0) continue;
    Level& L = tab.lv[tab.n_levels++];
    L.img = reinterpret_cast<const float*>(imgs[i]);
    L.H = dims[3 * i];
    L.W = dims[3 * i + 1];
    L.first_slot = K;
    K += k;
  }
  tab.K = K;
  tab.size = size;
  tab.total = (long long)B * K;
  tab.starts = starts;
  tab.out = out;
  if (tab.total == 0) return 0;

  const size_t smem = sizeof(float) * WARPS * size * size;
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(patch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (tab.total + WARPS - 1) / WARPS;
  patch_kernel<<<static_cast<unsigned>(blocks), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(tab);
  return static_cast<int>(cudaGetLastError());
}
