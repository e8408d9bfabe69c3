// The null space of the 5-point design matrix: for each of m systems of five
// normalized correspondences, an orthonormal basis [4, 3, 3] of the kernel
// of the 5x9 matrix A (A[n, 3j+k] = x2[n][j] * x1[n][k], homogeneous points).
//
// Replaces no Pallas kernel: the JAX package calls jnp.linalg.qr in
// slamtpu/ops/five_point.py::_nullspace4. Plain PyTorch version:
// slamtpu_torch/ops/five_point.py::_nullspace4_plain (torch.linalg.qr of
// A^T, mode="complete", and Q's last four columns).
//
// Why it was added: on CUDA tensors torch.linalg.qr factors a batch of small
// matrices by a loop of cuSOLVER/cuBLAS calls, about 12 launches a system,
// ~780 launches and ~3.8 ms of host time a 32-frame-pair VO chunk, the
// largest span of the card's idle time. This is one launch a chunk.
//
// What bounds it on the H100: each system reads 80 bytes and writes 144, so a
// chunk of 4 x 32 pairs x 64 hypotheses (8,192 systems) moves 1.8 MB, 0.55 us
// at 3.35 TB/s; its 1,015 FLOP a system (an FMA counted as two: 45 to build
// A^T, 440 for the QR, 150 for the block reflector's T, 380 to form Q's last
// four columns), 8.3 MFLOP, take 0.12 us at 67 TFLOP/s. The kernel's time is
// launch latency plus one thread's dependent chain of five square roots and
// divisions: a few us.
//
// The design: one thread per system, 128 threads a block, no shared memory.
// A thread builds A^T (9x5) in registers and computes Q's last four columns
// with the library's arithmetic, operation for operation, so the basis is
// the library's to the bit (on the H100 the card tests hold it to
// torch.linalg.qr; where A is ill-conditioned, as in samples of small
// parallax, any other order of rounding moves the basis by eps cond(A), and
// five-point RANSAC then elects other winners):
//
// * Householder QR as the batched geqrf does it: column i's reflector from
//   beta = -sign(alpha) sqrt(fma(alpha, alpha, ||x||^2)), tau = (beta -
//   alpha) / beta, v = x * (1 / (alpha - beta)), tau = 0 when ||x|| = 0; each
//   trailing column c gets w = v^T a_c and a_c = fma(-(tau w), v, a_c). The
//   dot products are `red8`: eight lanes, lane l summing rows l and l + 8 by
//   an FMA chain, then a butterfly over the lanes.
// * Q = I - V T V^T on [0; I4] as orgqr's block reflector does it: T from
//   G = V^T V (`red8`) by T[j][i] = -tau_i (FMA chain over l of T[j][l]
//   G[l][i]); then W'[i] = sum_l V[5+q][l] T[i][l] and acc[r] = sum_i
//   V[r][i] W'[i], each as two FMA chains, over indices 0-2 and 3-4, added;
//   Q[r][5+q] = [r == 5+q] - acc[r].
//
// Every product, sum, FMA, division and square root is an explicit
// round-to-nearest intrinsic, so the compiler contracts nothing. Every loop
// has constant bounds and unrolls, so the ~90 live values stay in registers.
// Each system is solved on its own and nothing is reduced across systems: a
// system's basis is the same bits whatever batch it is solved in.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int ROWS = 9;  // A^T is 9 x 5
constexpr int COLS = 5;
constexpr int SPLIT = 3;  // orgqr's sums over the 5 reflectors: indices [0, 3) and [3, 5)

template <typename T>
struct Rn;
template <>
struct Rn<float> {
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float fma(float a, float b, float c) { return __fmaf_rn(a, b, c); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ float sqrt(float a) { return __fsqrt_rn(a); }
};
template <>
struct Rn<double> {
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double fma(double a, double b, double c) { return __fma_rn(a, b, c); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ double sqrt(double a) { return __dsqrt_rn(a); }
};

// Sum of x[r] * y[r] over rows lo..8: lane l (0-7) takes rows l and l + 8 in
// order (the first product rounded, the next by FMA), then the lanes are
// added pairwise at distances 4, 2, 1. A lane without a row adds nothing.
template <typename T>
__device__ __forceinline__ T red8(const T (&x)[ROWS], const T (&y)[ROWS], int lo) {
  using R = Rn<T>;
  T lane[8];
  bool has[8];
#pragma unroll
  for (int l = 0; l < 8; ++l) {
    has[l] = false;
    lane[l] = T(0);
#pragma unroll
    for (int r = l; r < ROWS; r += 8) {
      if (r < lo) continue;
      lane[l] = has[l] ? R::fma(x[r], y[r], lane[l]) : R::mul(x[r], y[r]);
      has[l] = true;
    }
  }
#pragma unroll
  for (int off = 4; off >= 1; off >>= 1) {
#pragma unroll
    for (int l = 0; l < off; ++l) {
      if (has[l] && has[l + off]) {
        lane[l] = R::add(lane[l], lane[l + off]);
      } else if (has[l + off]) {
        lane[l] = lane[l + off];
      }
      has[l] = has[l] || has[l + off];
    }
  }
  return lane[0];
}

// Sum of x[i] * y[i] over i in [lo, hi) as orgqr's block reflector sums over
// reflectors: an FMA chain over [lo, SPLIT) and one over [SPLIT, hi), added.
template <typename T>
__device__ __forceinline__ T split_sum(const T (&x)[COLS], const T (&y)[COLS], int lo, int hi) {
  using R = Rn<T>;
  T part[2] = {T(0), T(0)};
  bool has[2] = {false, false};
#pragma unroll
  for (int i = 0; i < COLS; ++i) {
    if (i < lo || i >= hi) continue;
    const int b = i < SPLIT ? 0 : 1;
    part[b] = has[b] ? R::fma(x[i], y[i], part[b]) : R::mul(x[i], y[i]);
    has[b] = true;
  }
  if (has[0] && has[1]) return R::add(part[0], part[1]);
  return has[0] ? part[0] : part[1];
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    nullspace4_kernel(int m, const T* __restrict__ pts1, const T* __restrict__ pts2, T* __restrict__ basis) {
  using R = Rn<T>;
  const int s = blockIdx.x * THREADS + threadIdx.x;
  if (s >= m) return;

  // a[r][c] = A^T[r][c] = x2[c][r / 3] * x1[c][r % 3]; the QR overwrites it
  // with R on and above the diagonal and the reflectors' vectors below it.
  T a[ROWS][COLS];
  const T* p1 = pts1 + (size_t)s * 10;
  const T* p2 = pts2 + (size_t)s * 10;
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    const T x1[3] = {p1[2 * c], p1[2 * c + 1], T(1)};
    const T x2[3] = {p2[2 * c], p2[2 * c + 1], T(1)};
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int k = 0; k < 3; ++k) a[3 * j + k][c] = R::mul(x2[j], x1[k]);
  }

  // geqrf. v[i] holds reflector i as a full column: 0 above row i, 1 at it.
  T tau[COLS];
  T v[COLS][ROWS];
#pragma unroll
  for (int i = 0; i < COLS; ++i) {
    T col[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) col[r] = a[r][i];
    const T alpha = col[i];
    const T xnorm2 = red8(col, col, i + 1);
    if (xnorm2 == T(0)) {
      tau[i] = T(0);  // H_i = I
#pragma unroll
      for (int r = 0; r < ROWS; ++r) v[i][r] = r < i ? T(0) : (r == i ? T(1) : col[r]);
    } else {
      const T norm = R::sqrt(R::fma(alpha, alpha, xnorm2));
      const T beta = alpha >= T(0) ? -norm : norm;
      tau[i] = R::div(R::add(beta, -alpha), beta);
      const T scale = R::div(T(1), R::add(alpha, -beta));
#pragma unroll
      for (int r = 0; r < ROWS; ++r) v[i][r] = r < i ? T(0) : (r == i ? T(1) : R::mul(col[r], scale));
    }
#pragma unroll
    for (int c = i + 1; c < COLS; ++c) {
      T ac[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) ac[r] = a[r][c];
      const T ntw = -R::mul(tau[i], red8(v[i], ac, i));
#pragma unroll
      for (int r = i; r < ROWS; ++r) a[r][c] = R::fma(ntw, v[i][r], a[r][c]);
    }
  }

  // larft: the upper triangular T of I - V T V^T.
  T t[COLS][COLS];
#pragma unroll
  for (int i = 0; i < COLS; ++i) {
    T g[COLS];
#pragma unroll
    for (int l = 0; l < i; ++l) g[l] = red8(v[l], v[i], i);
#pragma unroll
    for (int j = 0; j < i; ++j) {
      T y = R::mul(t[j][j], g[j]);
#pragma unroll
      for (int l = j + 1; l < i; ++l) y = R::fma(t[j][l], g[l], y);
      t[j][i] = R::mul(-tau[i], y);
    }
    t[i][i] = tau[i];
  }

  // Q e_j = e_j - V (T (V^T e_j)) for j = 5..8, written as basis[s, j - 5, 3, 3].
  T* out = basis + (size_t)s * 36;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int j = COLS + q;
    T vj[COLS], wp[COLS];
#pragma unroll
    for (int l = 0; l < COLS; ++l) vj[l] = v[l][j];
#pragma unroll
    for (int i = 0; i < COLS; ++i) {
      T ti[COLS];
#pragma unroll
      for (int l = 0; l < COLS; ++l) ti[l] = l < i ? T(0) : t[i][l];
      wp[i] = split_sum(vj, ti, i, COLS);
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      T vr[COLS];
#pragma unroll
      for (int i = 0; i < COLS; ++i) vr[i] = v[i][r];
      const T acc = split_sum(vr, wp, 0, r < COLS ? r + 1 : COLS);
      out[9 * q + r] = R::add(r == j ? T(1) : T(0), -acc);
    }
  }
}

template <typename T>
int launch(int m, const T* pts1, const T* pts2, T* basis, cudaStream_t stream) {
  if (m < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((m + THREADS - 1) / THREADS);
  nullspace4_kernel<T><<<blocks, THREADS, 0, stream>>>(m, pts1, pts2, basis);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// m systems: pts1, pts2 [m, 5, 2] normalized points (contiguous), basis
// [m, 4, 3, 3] out. Launches on `stream`; returns a cudaError_t (0 on
// success, the launch checked).
extern "C" int launch_nullspace4(int m, const float* pts1, const float* pts2, float* basis, cudaStream_t stream) {
  return launch<float>(m, pts1, pts2, basis, stream);
}

// The same in float64, for callers that hold their points in double.
extern "C" int launch_nullspace4_f64(int m, const double* pts1, const double* pts2, double* basis,
                                     cudaStream_t stream) {
  return launch<double>(m, pts1, pts2, basis, stream);
}
