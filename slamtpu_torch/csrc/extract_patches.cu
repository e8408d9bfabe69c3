// Kernel K2: one (2r+1) x (2r+1) window per keypoint.
//
// Replaces the Pallas TPU kernel slamtpu/ops/pallas_patch.py::
// extract_patches_batched (body `_kernel`, pallas_call at pallas_patch.py:80).
// Plain PyTorch version: slamtpu_torch/ops/patch.py::extract_patches_plain
// (per-keypoint slices, the semantics of ops/brief.py::extract_patches).
//
// What bounds it on the H100: pure data movement, no arithmetic. A VO chunk
// (32 frames x 500 keypoints x 39 x 39 f32) writes 97 MB and reads at most as
// many window bytes, ~0.06 ms at 3.35 TB/s. The TPU kernel needed aligned
// VMEM blocks and dynamic rolls to cut unaligned windows; on Hopper a block
// reads its window straight from global memory (rows of 39 contiguous floats,
// served through L1/L2, where neighbouring windows overlap), so the design
// is one block per (keypoint, frame) whose threads copy the window with
// consecutive threads on consecutive addresses. Fusing it with orientation
// and BRIEF, so windows never reach device memory, is left for later.
//
// Starts (x0, y0) are clamped to [0, W-size] x [0, H-size], so every read is
// in bounds; the copy is bit-exact by construction.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
patch_kernel(const float* __restrict__ img, const int* __restrict__ starts, float* __restrict__ out,
             int K, int H, int W, int size) {
  const int kp = blockIdx.x;
  const int b = blockIdx.y;
  const size_t slot = (size_t)b * K + kp;
  const int x0 = min(max(starts[2 * slot], 0), W - size);
  const int y0 = min(max(starts[2 * slot + 1], 0), H - size);
  const float* src = img + (size_t)b * H * W + (size_t)y0 * W + x0;
  float* dst = out + slot * size * size;
  const int n = size * size;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int r = i / size, c = i - r * size;
    dst[i] = src[(size_t)r * W + c];
  }
}

}  // namespace

// images [B, H, W] f32, starts [B, K, 2] int32 (x0, y0) -> out [B, K, size, size].
// Requires H >= size and W >= size. Returns cudaGetLastError().
extern "C" int launch_extract_patches(const float* img, const int* starts, float* out, int B, int K,
                                      int H, int W, int size, void* stream) {
  if (K == 0 || B == 0) return 0;
  const dim3 grid(K, B);
  patch_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(img, starts, out, K, H, W, size);
  return static_cast<int>(cudaGetLastError());
}
