// Batched inverse of small SPD matrices: Minv = (L^-1)^T L^-1 with M = L L^T.
//
// Replaces: handarm_tpu/ops/spd_inverse.py `_chol_inv_kernel` (launched by
// `_linv_pallas` via `spd_inverse`), together with the W^T W product that
// the JAX op forms after the Pallas call. The pivot floor is the same:
// 1/L_jj = rsqrt(max(s, 1e-12)), and so is the subtraction order of every
// sum of the factorization and of W = L^-1.
//
// What bounds it on an H100: per env it reads n*n floats and writes n*n
// floats (17x17: 2.3 KB) against ~5.2 k flops, so at B = 8192 the least
// time is the 19 MB of traffic over 3.35 TB/s, about 5.7 us; the flops
// (~43 MFLOP) take under 1 us at 67 TFLOP/s f32. At n = 9 (0.65 KB, ~0.9
// k flops) it is 5.3 MB, about 1.6 us: a launch costs more. The classic
// tasks' floating-base craft take n = 14 (Quadcopter: 1.6 KB a matrix,
// 12.8 MB at B = 8192, 3.8 us) and n = 8 (Ingenuity: 0.5 KB, 2.1 MB at B =
// 4096, 0.6 us); BallBalance's tripod n = 12 (1.2 KB, 4.7 MB at B = 4096,
// 1.4 us) and the ANYmal's n = 18 (2.6 KB, 10.6 MB at B = 4096, 3.2 us).
// The hands run at B = 16384: the Trifinger's n = 9 (10.6 MB, 3.2 us), the
// Allegro's n = 16 (2 KB a matrix, 33.6 MB, 10.0 us) and the Shadow's n = 24
// (4.6 KB, 75.5 MB, 22.5 us).
//
// Design: the TPU kernel's own formulation, with the batch on the lanes.
// Each thread owns one matrix and runs the fully unrolled left-looking
// Cholesky-Crout for a compile-time n, W = L^-1 in place, and Minv = W^T W,
// all in registers (the lower triangle: 153 floats at n = 17, 45 at 9), with no
// synchronization between the steps. A block is one warp of 32 matrices,
// so B = 8192 gives 256 blocks and every SM gets work. The block's 32
// matrices are one contiguous span of the flat [B, n, n] input: it is
// staged into shared memory with 16-byte asynchronous copies (no register
// holds a load in flight, so all of them are), each thread then reads its
// own matrix at a stride of n*n floats, odd for odd n, which puts the 32
// threads on 32 banks; Minv goes back through the same buffer so the
// stores are coalesced 16-byte writes. For even n (18, 14, 12, 8, 2) n*n
// is even and 32 threads at that stride would share banks (196 = 4 mod 32:
// 8-way; 64: 32-way), so each matrix takes n*n + 1 words of the buffer: the
// staging is then a coalesced copy of single floats, each placed at its
// padded offset, in and out. At n = 18 the lower triangle is 171 floats
// and the buffer 41.6 KB of shared memory, under the 48 KB of a static
// allocation; at n = 16 (the Allegro hand) 136 floats and 32.9 KB.
//
// At n = 27 the lower triangle alone is 378 floats, past what one thread
// can hold in registers (the n = 17 instance takes 191), so that n has a
// layout of its own (`spd_inverse_warp_kernel`): one warp per matrix, lane
// i holding row i. The warp's matrix is staged into shared memory with
// coalesced loads and each lane reads its row at a stride of 27 floats (odd:
// the 27 lanes fall on 27 banks). Cholesky step j needs row j of L in every
// lane: its j entries are broadcast from lane j with __shfl_sync, then the
// pivot's inverse. W = L^-1 goes row by row: at step k lane k's running
// sums for row k of W are broadcast and scaled by its 1 / L_kk, every lane
// below subtracts its L_ik times the row (so each W_ir sums over k
// ascending, as the TPU kernel's forward substitution does), and every
// lane a adds W_ka times the row to its row of Minv = W^T W (W_ka picked
// from the broadcast row by a select chain: no second round of shuffles).
// Each lane holds three rows of 27 floats (L, W's sums, Minv) and shared
// memory serves only the staging, in and out. Its 756 shuffles a matrix,
// each carrying one value, bound it (PERF.md section 6).
//
// The warp layout also takes an even n (the Shadow hand's 24): there the
// lanes' rows would sit at an even stride of n floats in shared memory and
// share banks (24 = 8 mod 32: lanes 0, 4, 8, ... on one bank), so a row
// takes LD = n | 1 words of the staging buffer (25 at n = 24), the stride
// odd and the lanes on distinct banks. The copies in and out place each
// float at its padded offset. At an odd n, LD = n and the code is the
// unpadded one: so at n = 23 (AllegroKuka's KUKA arm and Allegro hand, LD
// = 23; 4.2 KB a matrix, 34.7 MB at B = 8192, 10.4 us), whose lanes 23-31
// carry zeros.
//
// Past a warp's 32 lanes (33 <= n <= 64) a lane per row no longer fits,
// and three rows of n floats a thread would take more registers than the
// card gives. So those n have a third layout (`spd_inverse_block_kernel`):
// one block of two warps (64 threads) per matrix, the matrix in shared
// memory at an odd row stride LD = n | 1 (the 32 threads of a warp reading
// a column fall on 32 banks; 46 x 47 floats, 8.6 KB, at n = 46), thread i
// holding row i of L and of W's running sums in registers (threads n..63
// carry zeros):
//   - Cholesky-Crout, column j: every thread i >= j sums its row against
//     row j of L, read from shared memory (one address: a broadcast);
//     thread j publishes its sum, the pivot; a barrier; every thread takes
//     1 / L_jj = rsqrt(max(pivot, 1e-12)), scales its entry and stores it
//     in row i; a barrier. Two barriers a column.
//   - W = L^-1 row by row as in the warp layout: at step k thread k writes
//     row k of W (its running sums times 1 / L_kk) over row k of L, which no
//     thread reads any more; a barrier; every thread i > k subtracts L_ik
//     times that row from its sums (each W_ir sums over k ascending, as the
//     TPU kernel's forward substitution). One barrier a row.
//   - Minv = W^T W: one thread per entry of the lower triangle (1,081 at n
//     = 46, 17 a thread), each summing W_ka W_kc over k >= a from shared
//     memory; a barrier; the sums mirrored into the buffer; a barrier; the
//     buffer copied out.
// Nothing assumes the two arms' block-diagonal matrices: every entry is
// computed. At n = 46 (the two-arm AllegroKuka's 2 x 23 dofs: 8.5 KB a
// matrix, 138.7 MB at B = 8192, 41.4 us) the bytes bound it; the design is
// bound by its 138 barriers and the Gram phase's shared-memory loads.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMats = 32;  // matrices (= threads) per block

__host__ __device__ constexpr int tri(int i, int j) { return i * (i + 1) / 2 + j; }

template <int N>
__global__ void __launch_bounds__(kMats)
    spd_inverse_kernel(const float* __restrict__ M, float* __restrict__ Minv, int B) {
  constexpr int NN = N * N;
  constexpr bool kOdd = NN % 2 == 1;
  constexpr int NS = kOdd ? NN : NN + 1;  // a matrix's words in S: odd (bank spread)
  __shared__ __align__(16) float S[kMats * NS];
  const int t = threadIdx.x;
  const int b0 = blockIdx.x * kMats;
  const int count = min(kMats, B - b0);
  const int nfloat = count * NN;
  const int nvec = nfloat / 4;  // b0 * NN * 4 bytes is a multiple of 16
  const float* src = M + (size_t)b0 * NN;
  float* dst = Minv + (size_t)b0 * NN;

  if constexpr (kOdd) {
    for (int v = t; v < nvec; v += kMats) __pipeline_memcpy_async(S + 4 * v, src + 4 * v, 16);
    __pipeline_commit();
    for (int e = 4 * nvec + t; e < nfloat; e += kMats) S[e] = src[e];
    __pipeline_wait_prior(0);
  } else {
    for (int e = t; e < nfloat; e += kMats) S[e + e / NN] = src[e];
  }
  __syncthreads();

  if (t < count) {
    float* A = S + t * NS;
    float L[tri(N, 0)];  // lower triangle, row-packed
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j) L[tri(i, j)] = A[i * N + j];

    // Cholesky-Crout, column by column; the diagonal holds 1 / L_jj
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float s = L[tri(j, j)];
#pragma unroll
      for (int k = 0; k < j; ++k) s = s - L[tri(j, k)] * L[tri(j, k)];
      const float inv = rsqrtf(fmaxf(s, 1e-12f));
      L[tri(j, j)] = inv;
#pragma unroll
      for (int i = j + 1; i < N; ++i) {
        float a = L[tri(i, j)];
#pragma unroll
        for (int k = 0; k < j; ++k) a = a - L[tri(i, k)] * L[tri(j, k)];
        L[tri(i, j)] = a * inv;
      }
    }

    // W = L^-1 in place, column r ascending: W_ir replaces L_ir once row i
    // of column r is done, and no later column reads L_ir
#pragma unroll
    for (int r = 0; r < N; ++r)
#pragma unroll
      for (int i = r + 1; i < N; ++i) {
        float s = 0.0f;
#pragma unroll
        for (int k = r; k < i; ++k) s = s - L[tri(i, k)] * L[tri(k, r)];
        L[tri(i, r)] = s * L[tri(i, i)];
      }

    // Minv = W^T W: entry (a, c) sums W_ka W_kc over k >= max(a, c)
#pragma unroll
    for (int a = 0; a < N; ++a)
#pragma unroll
      for (int c = a; c < N; ++c) {
        float s = 0.0f;
#pragma unroll
        for (int k = c; k < N; ++k) s += L[tri(k, a)] * L[tri(k, c)];
        A[a * N + c] = s;
        A[c * N + a] = s;
      }
  }
  __syncthreads();

  if constexpr (kOdd) {
    const float4* S4 = reinterpret_cast<const float4*>(S);
    float4* dst4 = reinterpret_cast<float4*>(dst);
    for (int v = t; v < nvec; v += kMats) dst4[v] = S4[v];
    for (int e = 4 * nvec + t; e < nfloat; e += kMats) dst[e] = S[e];
  } else {
    for (int e = t; e < nfloat; e += kMats) dst[e] = S[e + e / NN];
  }
}

// One warp per matrix; see the header. N <= 32; LD, the row stride in
// shared memory, odd (bank spread).
constexpr int kWarps = 4;  // matrices (= warps) per block of the warp layout
constexpr unsigned kFull = 0xffffffffu;

// The shared-memory word of element e of a row-major N x N matrix whose rows
// are LD words apart.
template <int N, int LD>
__device__ __forceinline__ int padded(int e) {
  if constexpr (LD == N) {
    return e;
  } else {
    return e + (e / N) * (LD - N);
  }
}

template <int N, int LD = (N | 1)>
__global__ void __launch_bounds__(32 * kWarps)
    spd_inverse_warp_kernel(const float* __restrict__ M, float* __restrict__ Minv, int B) {
  static_assert(N <= 32, "a lane per row");
  static_assert(LD >= N && LD % 2 == 1, "an odd row stride");
  constexpr int NN = N * N;
  __shared__ float S[kWarps][N * LD];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarps + w;
  if (b >= B) return;  // the whole warp: no block-wide barrier follows
  float* Sw = S[w];
  const float* src = M + (size_t)b * NN;
  for (int e = lane; e < NN; e += 32) Sw[padded<N, LD>(e)] = src[e];
  __syncwarp();

  const int i = lane;  // the row this lane holds; lanes N..31 carry zeros
  float R[N];          // row i of M, then of L (the diagonal holds 1 / L_ii)
#pragma unroll
  for (int j = 0; j < N; ++j) R[j] = i < N ? Sw[i * LD + j] : 0.0f;

  // Cholesky-Crout, column by column, row j of L broadcast from lane j
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float a = R[j];
#pragma unroll
    for (int k = 0; k < j; ++k) a = a - R[k] * __shfl_sync(kFull, R[k], j);
    const float inv = rsqrtf(fmaxf(__shfl_sync(kFull, a, j), 1e-12f));
    R[j] = i == j ? inv : (i > j ? a * inv : 0.0f);
  }

  // W = L^-1 row by row and Minv = W^T W with it. Lane k's running sums
  // are broadcast at step k and scaled by 1 / L_kk in every lane; after
  // that they are dead, so the lanes update theirs unconditionally.
  float T[N];  // row i of W: running sums of -L_ik W_kr
  float G[N];  // row i of Minv
#pragma unroll
  for (int r = 0; r < N; ++r) T[r] = G[r] = 0.0f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float dk = __shfl_sync(kFull, R[k], k);  // 1 / L_kk
    float v[N];  // row k of W (entries 0..k), in every lane
#pragma unroll
    for (int r = 0; r < k; ++r) v[r] = __shfl_sync(kFull, T[r], k) * dk;
    v[k] = dk;
    float wka = 0.0f;  // W_ki of this lane's column i
#pragma unroll
    for (int r = 0; r <= k; ++r) {
      T[r] = T[r] - R[k] * v[r];
      wka = i == r ? v[r] : wka;
    }
#pragma unroll
    for (int c = 0; c <= k; ++c) G[c] += wka * v[c];
  }
  __syncwarp();
  if (i < N) {
#pragma unroll
    for (int c = 0; c < N; ++c) Sw[i * LD + c] = G[c];
  }
  __syncwarp();
  float* dst = Minv + (size_t)b * NN;
  for (int e = lane; e < NN; e += 32) dst[e] = Sw[padded<N, LD>(e)];
}

// One block of kBlockThreads per matrix; see the header. 33 <= N <= 64.
constexpr int kBlockThreads = 64;

template <int N, int LD = (N | 1)>
__global__ void __launch_bounds__(kBlockThreads)
    spd_inverse_block_kernel(const float* __restrict__ M, float* __restrict__ Minv, int B) {
  static_assert(N > 32 && N <= kBlockThreads, "a thread per row, past a warp's lanes");
  static_assert(LD >= N && LD % 2 == 1, "an odd row stride");
  constexpr int NN = N * N;
  constexpr int NT = tri(N, 0);  // entries of the lower triangle
  constexpr int kIter = (NT + kBlockThreads - 1) / kBlockThreads;
  __shared__ float S[N * LD];
  __shared__ float pivot;
  const int i = threadIdx.x;  // the row this thread holds; threads N..63 carry zeros
  const float* src = M + (size_t)blockIdx.x * NN;
  for (int e = i; e < NN; e += kBlockThreads) S[padded<N, LD>(e)] = src[e];
  __syncthreads();

  float R[N];  // row i of M, then of L (the diagonal holds 1 / L_ii)
#pragma unroll
  for (int j = 0; j < N; ++j) R[j] = i < N ? S[i * LD + j] : 0.0f;

  // Cholesky-Crout, column by column, row j of L read from shared memory
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float a = R[j];
    if (i >= j) {
#pragma unroll
      for (int k = 0; k < j; ++k) a = a - R[k] * S[j * LD + k];
    }
    if (i == j) pivot = a;
    __syncthreads();
    const float inv = rsqrtf(fmaxf(pivot, 1e-12f));
    R[j] = i == j ? inv : (i > j ? a * inv : 0.0f);
    if (i >= j && i < N) S[i * LD + j] = R[j];
    __syncthreads();
  }

  // W = L^-1 row by row: thread k writes row k of W, then every thread
  // below subtracts L_ik times it from its running sums
  float T[N];  // row i of W: running sums of -L_ik W_kr
#pragma unroll
  for (int r = 0; r < N; ++r) T[r] = 0.0f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (i == k) {
#pragma unroll
      for (int r = 0; r < k; ++r) S[k * LD + r] = T[r] * R[k];
      S[k * LD + k] = R[k];
    }
    __syncthreads();
    if (i > k && i < N) {
#pragma unroll
      for (int r = 0; r <= k; ++r) T[r] = T[r] - R[k] * S[k * LD + r];
    }
  }

  // Minv = W^T W: entry (a, c), a >= c, sums W_ka W_kc over k >= a
  float acc[kIter];
#pragma unroll
  for (int it = 0; it < kIter; ++it) {
    const int e = i + it * kBlockThreads;
    float s = 0.0f;
    if (e < NT) {
      int a = (int)((sqrtf(8.0f * e + 1.0f) - 1.0f) * 0.5f);
      while (tri(a + 1, 0) <= e) ++a;
      while (tri(a, 0) > e) --a;
      const int c = e - tri(a, 0);
      for (int k = a; k < N; ++k) s += S[k * LD + a] * S[k * LD + c];
    }
    acc[it] = s;
  }
  __syncthreads();
#pragma unroll
  for (int it = 0; it < kIter; ++it) {
    const int e = i + it * kBlockThreads;
    if (e < NT) {
      int a = (int)((sqrtf(8.0f * e + 1.0f) - 1.0f) * 0.5f);
      while (tri(a + 1, 0) <= e) ++a;
      while (tri(a, 0) > e) --a;
      const int c = e - tri(a, 0);
      S[a * LD + c] = acc[it];
      S[c * LD + a] = acc[it];
    }
  }
  __syncthreads();
  float* dst = Minv + (size_t)blockIdx.x * NN;
  for (int e = i; e < NN; e += kBlockThreads) dst[e] = S[padded<N, LD>(e)];
}

}  // namespace

extern "C" int spd_inverse_f32(const float* M, float* Minv, int B, int n,
                               void* stream) {
  if (B < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const int blocks = (B + kMats - 1) / kMats;
  const int warp_blocks = (B + kWarps - 1) / kWarps;
  if (n == 46) {  // the two-arm AllegroKuka's 2 x (7 + 16) dofs: a block per matrix
    spd_inverse_block_kernel<46><<<B, kBlockThreads, 0, (cudaStream_t)stream>>>(M, Minv, B);
    return (int)cudaGetLastError();
  }
  if (n == 27) {  // the Humanoid's 6 + 21 dofs: a warp per matrix
    spd_inverse_warp_kernel<27><<<warp_blocks, 32 * kWarps, 0, (cudaStream_t)stream>>>(
        M, Minv, B);
    return (int)cudaGetLastError();
  }
  if (n == 24) {  // the Shadow hand's 24 dofs: a warp per matrix, rows 25 words apart
    spd_inverse_warp_kernel<24><<<warp_blocks, 32 * kWarps, 0, (cudaStream_t)stream>>>(
        M, Minv, B);
    return (int)cudaGetLastError();
  }
  if (n == 23) {  // the KUKA arm's 7 + the Allegro hand's 16 dofs: a warp per matrix
    spd_inverse_warp_kernel<23><<<warp_blocks, 32 * kWarps, 0, (cudaStream_t)stream>>>(
        M, Minv, B);
    return (int)cudaGetLastError();
  }
  switch (n) {  // a thread per matrix: the Cartpole's 2 dofs, the Ingenuity's
                // 8, the Stretch's, the Franka's and the Trifinger's 9,
                // BallBalance's 12, the Quadcopter's and the Ant's 14, the
                // Allegro hand's 16, the UR5+SIH's 17, the ANYmal's 18
    case 2:
      spd_inverse_kernel<2><<<blocks, kMats, 0, (cudaStream_t)stream>>>(M, Minv, B);
      break;
    case 8:
      spd_inverse_kernel<8><<<blocks, kMats, 0, (cudaStream_t)stream>>>(M, Minv, B);
      break;
    case 9:
      spd_inverse_kernel<9><<<blocks, kMats, 0, (cudaStream_t)stream>>>(M, Minv, B);
      break;
    case 12:
      spd_inverse_kernel<12><<<blocks, kMats, 0, (cudaStream_t)stream>>>(M, Minv, B);
      break;
    case 14:
      spd_inverse_kernel<14><<<blocks, kMats, 0, (cudaStream_t)stream>>>(M, Minv, B);
      break;
    case 16:
      spd_inverse_kernel<16><<<blocks, kMats, 0, (cudaStream_t)stream>>>(M, Minv, B);
      break;
    case 17:
      spd_inverse_kernel<17><<<blocks, kMats, 0, (cudaStream_t)stream>>>(M, Minv, B);
      break;
    case 18:
      spd_inverse_kernel<18><<<blocks, kMats, 0, (cudaStream_t)stream>>>(M, Minv, B);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
