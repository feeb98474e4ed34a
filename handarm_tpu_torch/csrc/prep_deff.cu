// Robot-side effective mass of every contact slot and friction-basis
// direction: d[b, c, d] = v^T Minv v with
// v[u] = anc[c, u] * ((s_ang_u x p_c + s_lin_u) . w_d).
//
// Replaces: handarm_tpu/ops/prep_deff.py `_deff_kernel` (launched by
// `robot_deff`, called from solver._prepare at B * C >= 2^21 or with
// jacobi_impl="pallas"). Like the TPU kernel it never writes the
// [B, C, nv, 3] intermediates to device memory, and it is float32
// throughout. The dof mask anc[c, :] (0/1) comes as one bit per dof.
//
// What bounds it on an H100: at B = 8192, C = 372, nv = 17 it must read
// pos and basis (12 floats per env) only for the slots with a robot dof
// (132 of the 372; the others give 0 whatever they hold), the screws and
// Minv, and write 3 [B, C] planes: ~101 MB, about 30 us at 3.35 TB/s.
// The arithmetic is ~2 m^2 flops per (robot slot, direction) for the
// quadratic form over the slot's m set dofs, about 1 GFLOP at these
// shapes: the bytes set the bound (chip_smoke.py counts both from the
// run's masks).
//
// Design: one thread block per env; the env's screws (6 nv floats) and
// Minv (nv^2) are staged in shared memory, and each thread walks slots
// c = t, t + blockDim, ... A slot with no robot dof writes zeros. For a
// robot slot and each direction the thread builds
// v_u = (s_ang_u x p + s_lin_u) . w for the set dofs in registers (nv is a
// template parameter, so the dof loops unroll and v stays in registers;
// the arm is rebuilt per direction rather than held, to keep the register
// count down), then d = sum_u v_u sum_w Minv_uw v_w, the screws and Minv
// read as broadcasts from shared memory. Planes are read and written with
// neighbouring threads on neighbouring slots.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

template <int NV>
__global__ void prep_deff_kernel(const float* __restrict__ screws,
                                 const float* __restrict__ pos,
                                 const float* __restrict__ basis,
                                 const int* __restrict__ anc_bits,
                                 const float* __restrict__ minv2,
                                 float* __restrict__ out, int B, int C) {
  __shared__ float sc[6 * NV];
  __shared__ float mv[NV * NV];
  const int b = blockIdx.x, t = threadIdx.x;
  for (int i = t; i < 6 * NV; i += blockDim.x)
    sc[i] = screws[(size_t)(i / NV) * B * NV + (size_t)b * NV + i % NV];
  for (int i = t; i < NV * NV; i += blockDim.x)
    mv[i] = minv2[(size_t)b * NV * NV + i];
  __syncthreads();

  const size_t BC = (size_t)B * C;
  for (int c = t; c < C; c += blockDim.x) {
    const size_t off = (size_t)b * C + c;
    const int bits = __ldg(anc_bits + c);
    if (bits == 0) {
      out[off] = 0.0f;
      out[BC + off] = 0.0f;
      out[2 * BC + off] = 0.0f;
      continue;
    }
    const float px = pos[off], py = pos[BC + off], pz = pos[2 * BC + off];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float wx = basis[(3 * d + 0) * BC + off];
      const float wy = basis[(3 * d + 1) * BC + off];
      const float wz = basis[(3 * d + 2) * BC + off];
      float v[NV];
#pragma unroll
      for (int u = 0; u < NV; ++u) {
        const float sax = sc[0 * NV + u], say = sc[1 * NV + u], saz = sc[2 * NV + u];
        const float ax = (say * pz - saz * py) + sc[3 * NV + u];
        const float ay = (saz * px - sax * pz) + sc[4 * NV + u];
        const float az = (sax * py - say * px) + sc[5 * NV + u];
        v[u] = ((bits >> u) & 1) ? ax * wx + ay * wy + az * wz : 0.0f;
      }
      float acc = 0.0f;
#pragma unroll
      for (int u = 0; u < NV; ++u) {
        float y = 0.0f;
#pragma unroll
        for (int w = 0; w < NV; ++w) y += mv[u * NV + w] * v[w];
        acc += v[u] * y;
      }
      out[d * BC + off] = acc;
    }
  }
}

template <int NV>
int launch(const float* screws, const float* pos, const float* basis,
           const int* anc_bits, const float* minv2, float* out, int B, int C,
           cudaStream_t stream) {
  prep_deff_kernel<NV><<<B, kThreads, 0, stream>>>(screws, pos, basis, anc_bits,
                                                   minv2, out, B, C);
  return (int)cudaGetLastError();
}

}  // namespace

// nv must be one of the instantiated dof counts (ops/prep_deff.py KERNEL_NV).
extern "C" int prep_deff_f32(const float* screws, const float* pos,
                             const float* basis, const int* anc_bits,
                             const float* minv2, float* out, int B, int C,
                             int nv, void* stream) {
  if (B < 1 || C < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (nv) {
    case 17:
      return launch<17>(screws, pos, basis, anc_bits, minv2, out, B, C, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
