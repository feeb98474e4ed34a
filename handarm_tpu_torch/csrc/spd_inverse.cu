// Batched inverse of small SPD matrices: Minv = (L^-1)^T L^-1 with M = L L^T.
//
// Replaces: handarm_tpu/ops/spd_inverse.py `_chol_inv_kernel` (launched by
// `_linv_pallas` via `spd_inverse`), together with the W^T W product that
// the JAX op forms after the Pallas call. The pivot floor is the same:
// 1/L_jj = rsqrt(max(s, 1e-12)).
//
// What bounds it on an H100: per env it reads n*n floats and writes n*n
// floats (17x17: 2.3 KB) against ~10 k flops, so at B = 8192 the least
// time is the 19 MB of traffic over 3.35 TB/s, about 6 us; the flops
// (~80 MFLOP) take a tenth of that at 67 TFLOP/s f32. The Cholesky itself is
// a chain of n dependent column steps, so latency, not bandwidth, is what a
// simple kernel actually pays.
//
// Design: one warp per matrix, the matrix staged in shared memory with a
// padded row stride. Lane i owns row i during the right-looking Cholesky
// (each column step is one rsqrt, a scale of the column and a rank-1
// update of the trailing rows, with __syncwarp between steps); lane r owns
// column r of W = L^-1 during the forward substitution (columns are
// independent); the 32 lanes then share the n*n dot products of W^T W.
// Loads and stores of the matrix are coalesced over the flat n*n block.
// The subtraction order of every sum matches the TPU kernel's.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 32;
constexpr int kWarpsPerBlock = 4;
constexpr int kStride = kMaxN + 1;  // padded row stride (bank spread)

__global__ void spd_inverse_kernel(const float* __restrict__ M,
                                   float* __restrict__ Minv, int B, int n) {
  __shared__ float A_s[kWarpsPerBlock][kMaxN * kStride];
  __shared__ float W_s[kWarpsPerBlock][kMaxN * kStride];
  __shared__ float D_s[kWarpsPerBlock][kMaxN];  // 1 / L_jj

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;  // whole warp exits together

  float* A = A_s[warp];
  float* W = W_s[warp];
  float* D = D_s[warp];
  const int nn = n * n;
  const float* Mb = M + (size_t)b * nn;
  for (int e = lane; e < nn; e += 32) A[(e / n) * kStride + e % n] = Mb[e];
  __syncwarp();

  // right-looking Cholesky on the lower triangle, lane = row
  for (int j = 0; j < n; ++j) {
    const float inv = rsqrtf(fmaxf(A[j * kStride + j], 1e-12f));
    if (lane == j) D[j] = inv;
    if (lane > j && lane < n) A[lane * kStride + j] *= inv;
    __syncwarp();
    if (lane > j && lane < n) {
      const float lij = A[lane * kStride + j];
      for (int k = j + 1; k <= lane; ++k)
        A[lane * kStride + k] -= lij * A[k * kStride + j];
    }
    __syncwarp();
  }

  // W = L^-1 column by column, lane = column
  if (lane < n) {
    const int r = lane;
    for (int i = 0; i < r; ++i) W[i * kStride + r] = 0.0f;
    W[r * kStride + r] = D[r];
    for (int i = r + 1; i < n; ++i) {
      float s = 0.0f;
      for (int k = r; k < i; ++k) s -= A[i * kStride + k] * W[k * kStride + r];
      W[i * kStride + r] = s * D[i];
    }
  }
  __syncwarp();

  // Minv = W^T W (W lower triangular: the sum starts at max(a, c))
  float* Ob = Minv + (size_t)b * nn;
  for (int e = lane; e < nn; e += 32) {
    const int a = e / n, c = e % n;
    float s = 0.0f;
    for (int k = a > c ? a : c; k < n; ++k)
      s += W[k * kStride + a] * W[k * kStride + c];
    Ob[e] = s;
  }
}

}  // namespace

extern "C" int spd_inverse_f32(const float* M, float* Minv, int B, int n,
                               void* stream) {
  if (n < 1 || n > kMaxN) return (int)cudaErrorInvalidValue;
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  spd_inverse_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                       (cudaStream_t)stream>>>(M, Minv, B, n);
  return (int)cudaGetLastError();
}
