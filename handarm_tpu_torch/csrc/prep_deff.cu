// Robot-side effective mass of every contact slot and friction-basis
// direction: d[b, c, d] = v^T Minv v with
// v[u] = anc[c, u] * ((s_ang_u x p_c + s_lin_u) . w_d).
//
// Replaces: handarm_tpu/ops/prep_deff.py `_deff_kernel` (launched by
// `robot_deff`, called from solver._prepare at B * C >= 2^21 or with
// jacobi_impl="pallas"). Like the TPU kernel it never writes the
// [B, C, nv, 3] intermediates to device memory, and it is float32
// throughout.
//
// What bounds it on an H100: at B = 8192, C = 372, nv = 17 it must read
// pos and basis (12 floats per env) only for the slots with a robot dof
// (132 of the 372; the others give 0 whatever they hold), the screws and
// Minv, and write 3 [B, C] planes: ~101 MB, about 30 us at 3.35 TB/s.
// The work below is ~25K multiply-adds per env (~0.4 GFLOP in all), so
// the bytes set the bound (chip_smoke.py counts both from the run's masks).
//
// Design: the slots' dof masks take L distinct values (one per hand link;
// the tables of physics/solver.py `build_slot_groups` give each mask and
// each slot's group). With xi = (p x w, w), v_u = s_u . xi, so
// d = xi^T Phi_l xi with Phi_l = S_l Minv S_l^T, a symmetric 6 x 6 matrix
// per (env, link) over the mask's set dofs. One thread block per env:
//   1. the screws and Minv are staged in shared memory;
//   2. X_l[a][v] = sum_{u in l} s_au Minv_uv for the set dofs v of each
//      link (one thread per (l, v, a)), then the upper triangle of Phi_l
//      (one thread per entry), each loop walking only the mask's set bits;
//   3. one thread per slot: a slot without a robot dof writes zeros, a
//      robot slot reads its link's 21 values once and forms xi and
//      xi^T Phi xi for its 3 directions.
// Planes are read and written with neighbouring threads on neighbouring
// slots. nv needs no template: the loops run over set bits of a 64-bit
// mask (nv <= 64, L <= 64), one 32-bit word after the other (`dof_word`:
// a 64-bit shift or __ffsll costs several instructions on the card). The
// masks are staged first in shared memory, on an 8-byte boundary. At the
// two-arm AllegroKuka's nv = 46 and L = 46 the block's shared memory is
// about 67 KB, past the 48 KB of a default launch: the launch raises the
// kernel's limit first.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPhi = 37;  // floats per link of Phi (6 x 6, odd stride)

// Word h (0: dofs 0-31, 1: dofs 32-63) of a staged 64-bit dof mask.
__device__ __forceinline__ unsigned dof_word(const unsigned long long* bits, int l, int h) {
  return reinterpret_cast<const unsigned*>(bits + l)[h];
}

__global__ void __launch_bounds__(kThreads) prep_deff_kernel(
    const float* __restrict__ screws, const float* __restrict__ pos,
    const float* __restrict__ basis, const unsigned long long* __restrict__ link_bits,
    const int* __restrict__ slot_link, const float* __restrict__ minv2,
    float* __restrict__ out, int B, int C, int nv, int L) {
  extern __shared__ __align__(16) float sm[];
  // [L] dof masks at the start: 8-byte aligned
  unsigned long long* bits = reinterpret_cast<unsigned long long*>(sm);
  float* sc = reinterpret_cast<float*>(bits + L);  // [6][nv]
  float* mv = sc + 6 * nv;         // [nv][nv]
  float* X = mv + nv * nv;         // [L][6][nv]
  float* phi = X + L * 6 * nv;     // [L][kPhi], row-major 6 x 6, upper part
  const int b = blockIdx.x, t = threadIdx.x;
  for (int i = t; i < 6 * nv; i += kThreads)
    sc[i] = screws[(size_t)(i / nv) * B * nv + (size_t)b * nv + i % nv];
  for (int i = t; i < nv * nv; i += kThreads) mv[i] = minv2[(size_t)b * nv * nv + i];
  for (int i = t; i < L; i += kThreads) bits[i] = link_bits[i];
  __syncthreads();

  for (int j = t; j < L * nv * 6; j += kThreads) {
    const int l = j / (6 * nv), v = (j / 6) % nv, a = j % 6;
    if (!((dof_word(bits, l, v >> 5) >> (v & 31)) & 1u)) continue;
    float acc = 0.0f;
    for (int h = 0; h < 2; ++h)  // the set dofs u ascending
      for (unsigned r = dof_word(bits, l, h); r; r &= r - 1) {
        const int u = 32 * h + __ffs(r) - 1;
        acc += sc[a * nv + u] * mv[u * nv + v];
      }
    X[(l * 6 + a) * nv + v] = acc;
  }
  __syncthreads();
  for (int j = t; j < L * 36; j += kThreads) {
    const int l = j / 36, a = (j / 6) % 6, e = j % 6;
    if (e < a) continue;
    float acc = 0.0f;
    for (int h = 0; h < 2; ++h)
      for (unsigned r = dof_word(bits, l, h); r; r &= r - 1) {
        const int v = 32 * h + __ffs(r) - 1;
        acc += X[(l * 6 + a) * nv + v] * sc[e * nv + v];
      }
    phi[l * kPhi + a * 6 + e] = acc;
  }
  __syncthreads();

  const size_t BC = (size_t)B * C;
  for (int c = t; c < C; c += kThreads) {
    const size_t off = (size_t)b * C + c;
    const int l = __ldg(slot_link + c);
    if (l < 0) {
      out[off] = 0.0f;
      out[BC + off] = 0.0f;
      out[2 * BC + off] = 0.0f;
      continue;
    }
    const float* f = phi + l * kPhi;
    float P[21];
    int n = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a)
#pragma unroll
      for (int e = a; e < 6; ++e) P[n++] = f[a * 6 + e];
    const float px = pos[off], py = pos[BC + off], pz = pos[2 * BC + off];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float wx = basis[(3 * d + 0) * BC + off];
      const float wy = basis[(3 * d + 1) * BC + off];
      const float wz = basis[(3 * d + 2) * BC + off];
      const float xi[6] = {py * wz - pz * wy, pz * wx - px * wz, px * wy - py * wx,
                           wx, wy, wz};
      float acc = 0.0f;
      int k = 0;
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        float y = P[k++] * xi[a];
#pragma unroll
        for (int e = a + 1; e < 6; ++e) y += 2.0f * P[k++] * xi[e];
        acc += xi[a] * y;
      }
      out[d * BC + off] = acc;
    }
  }
}

size_t shared_bytes(int nv, int L) {
  return (size_t)(2 * L + 6 * nv + nv * nv + L * 6 * nv + L * kPhi) * 4;
}

bool valid(int nv, int L) {
  return nv >= 1 && nv <= 64 && L >= 0 && L <= 64 && shared_bytes(nv, L) <= 227 * 1024;
}

// The kernel's dynamic shared memory allowed past the 48 KB of a default
// launch where these sizes need it; the launch and the occupancy query both
// call it.
int allow_shared(size_t smem) {
  if (smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(prep_deff_kernel,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return 0;
}

}  // namespace

// Limits (checked again by ops/prep_deff.py): nv <= 64 (a dof mask is one
// 64-bit word), L <= 64.
extern "C" int prep_deff_f32(const float* screws, const float* pos,
                             const float* basis, const unsigned long long* link_bits,
                             const int* slot_link, const float* minv2,
                             float* out, int B, int C, int nv, int L,
                             void* stream) {
  if (B < 1 || C < 1 || !valid(nv, L)) return (int)cudaErrorInvalidValue;
  const size_t smem = shared_bytes(nv, L);
  const int e = allow_shared(smem);
  if (e != 0) return e;
  prep_deff_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      screws, pos, basis, link_bits, slot_link, minv2, out, B, C, nv, L);
  return (int)cudaGetLastError();
}

// The launch at these sizes: info = {threads per block, dynamic shared
// bytes, resident blocks per SM from the occupancy calculator}.
extern "C" int prep_deff_launch_info(int nv, int L, int* info) {
  info[0] = info[1] = info[2] = 0;
  if (!valid(nv, L)) return (int)cudaErrorInvalidValue;
  const size_t smem = shared_bytes(nv, L);
  info[0] = kThreads;
  info[1] = (int)smem;
  const int e = allow_shared(smem);
  if (e != 0) return e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[2], prep_deff_kernel,
                                                            kThreads, smem);
}
