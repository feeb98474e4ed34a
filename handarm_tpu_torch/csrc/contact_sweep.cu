// All relaxed-Jacobi sweeps of one anchored contact solve, warm start included.
//
// Replaces: handarm_tpu/ops/contact_sweep.py `_sweep_kernel` (launched by
// `fused_jacobi_sweeps`, called from solver.solve_anchored with
// apply_warm). Same update order and projection: the warm impulses are
// applied first, then each sweep (1) evaluates the relative velocity at
// every slot from the pre-sweep qd / object velocities, (2) projects the
// accumulated impulses (normal >= 0, Coulomb disk, omega * gate step), and
// (3) applies the impulse deltas to qd through Minv and to the objects
// through 1/m and the world inverse inertia. Only the order of the sums
// differs from the TPU kernel.
//
// What bounds it on an H100: each solve must read the 37 [B, C] planes,
// bias, lam0, screws, qd, Minv and write qd, object velocities and lam;
// at B = 8192, C = 127 that is ~200 MB, about 60 us at 3.35 TB/s, against
// ~2.5 GFLOP of f32 arithmetic (~40 us at 67 TFLOP/s). The sweeps are a
// dependent chain inside each env, so a simple kernel is bound by the
// latency of its per-sweep block reductions rather than by either.
//
// Design: one thread block per env, one thread per contact slot. The
// slot's planes, bias and impulses live in registers for all the sweeps, so
// every plane is read from device memory once per solve (the TPU kernel's
// VMEM residency, here in registers). The env's screws, qd, Minv (289
// floats) and object velocities live in shared memory. The one-hot
// couplings of the TPU kernel (an MXU idiom) become a per-slot dof bitmask
// and a per-side object index: the robot part of a slot velocity is a
// masked sum over the dofs, and the impulse apply is a block reduction
// (one thread per (screw component, dof) and per (side, component,
// object)) followed by gi = sum_a s_a T_a and qd += Minv gi.
// __syncthreads separates the phases; the sweep is Jacobi, so every slot
// reads the same pre-sweep velocities.

#include <cuda_runtime.h>

namespace {

constexpr int kNBase = 17;
constexpr int kNSide = 10;
constexpr int kMaxSides = 2;

struct Shared {
  float *sc, *qd, *minv, *sv, *T, *gi, *ob, *F, *G, *osum;
  int *bits, *oidx;
};

__device__ __forceinline__ Shared carve(float* sm, int C, int nv, int K, int S) {
  Shared s;
  s.sc = sm;                 // [6][nv] screws (ang xyz, lin xyz)
  s.qd = s.sc + 6 * nv;      // [nv]
  s.minv = s.qd + nv;        // [nv][nv]
  s.sv = s.minv + nv * nv;   // [6][nv] screw * qd
  s.T = s.sv + 6 * nv;       // [6][nv] slot sums of (p x dP, dP) per dof
  s.gi = s.T + 6 * nv;       // [nv] generalized impulse
  s.ob = s.gi + nv;          // [6][K] object lin / ang velocity
  s.F = s.ob + 6 * K;        // [6][C] per-slot (p x dP, dP)
  s.G = s.F + 6 * C;         // [S][6][C] per-slot object velocity deltas
  s.osum = s.G + S * 6 * C;  // [S][6][K]
  s.bits = reinterpret_cast<int*>(s.osum + S * 6 * K);  // [C]
  s.oidx = s.bits + C;       // [S][C]
  return s;
}

size_t shared_bytes(int C, int nv, int K, int S) {
  const size_t floats = 6 * nv + nv + nv * nv + 6 * nv + 6 * nv + nv + 6 * K +
                        6 * C + (size_t)S * 6 * C + (size_t)S * 6 * K;
  const size_t ints = C + (size_t)S * C;
  return (floats + ints) * 4;
}

// Apply slot impulses (dPx, dPy, dPz) to qd and the objects. Every thread of
// the block calls it; threads without a slot pass zeros.
__device__ __forceinline__ void apply_impulse(const Shared& s, bool slot, int c, int C, int nv,
                              int K, int S, int sign_bits, const float* pl,
                              const float (*sd)[kNSide], float dPx, float dPy,
                              float dPz) {
  const int t = threadIdx.x;
  if (slot) {
    const float px = pl[9], py = pl[10], pz = pl[11];
    s.F[0 * C + c] = py * dPz - pz * dPy;
    s.F[1 * C + c] = pz * dPx - px * dPz;
    s.F[2 * C + c] = px * dPy - py * dPx;
    s.F[3 * C + c] = dPx;
    s.F[4 * C + c] = dPy;
    s.F[5 * C + c] = dPz;
#pragma unroll
    for (int q = 0; q < kMaxSides; ++q) {
      if (q < S) {
        const float* d = sd[q];
        const float rx = d[0], ry = d[1], rz = d[2], invm = d[9];
        const float tx = ry * dPz - rz * dPy;
        const float ty = rz * dPx - rx * dPz;
        const float tz = rx * dPy - ry * dPx;
        float* g = s.G + q * 6 * C;
        g[0 * C + c] = dPx * invm;
        g[1 * C + c] = dPy * invm;
        g[2 * C + c] = dPz * invm;
        g[3 * C + c] = d[3] * tx + d[4] * ty + d[5] * tz;
        g[4 * C + c] = d[4] * tx + d[6] * ty + d[7] * tz;
        g[5 * C + c] = d[5] * tx + d[7] * ty + d[8] * tz;
      }
    }
  }
  __syncthreads();
  // reductions over the slots
  const int n_rob = 6 * nv;
  for (int j = t; j < n_rob + S * 6 * K; j += blockDim.x) {
    float acc = 0.0f;
    if (j < n_rob) {
      const int a = j / nv, u = j % nv;
      const float* f = s.F + a * C;
      for (int cc = 0; cc < C; ++cc)
        if ((s.bits[cc] >> u) & 1) acc += f[cc];
      s.T[j] = acc;
    } else {
      const int jj = j - n_rob;
      const int q = jj / (6 * K), comp = (jj / K) % 6, k = jj % K;
      const float* g = s.G + (q * 6 + comp) * C;
      const int* oi = s.oidx + q * C;
      for (int cc = 0; cc < C; ++cc)
        if (oi[cc] == k) acc += g[cc];
      s.osum[jj] = acc;
    }
  }
  __syncthreads();
  for (int j = t; j < nv + 6 * K; j += blockDim.x) {
    if (j < nv) {
      const int u = j;
      s.gi[u] = s.sc[0 * nv + u] * s.T[0 * nv + u] + s.sc[1 * nv + u] * s.T[1 * nv + u] +
                s.sc[2 * nv + u] * s.T[2 * nv + u] + s.sc[3 * nv + u] * s.T[3 * nv + u] +
                s.sc[4 * nv + u] * s.T[4 * nv + u] + s.sc[5 * nv + u] * s.T[5 * nv + u];
    } else {
      const int i = j - nv;  // comp * K + k
      float v = s.ob[i];
      for (int q = 0; q < S; ++q) {
        const float sg = ((sign_bits >> q) & 1) ? -1.0f : 1.0f;
        v = v + sg * s.osum[q * 6 * K + i];
      }
      s.ob[i] = v;
    }
  }
  __syncthreads();
  for (int u = t; u < nv; u += blockDim.x) {
    float acc = 0.0f;
    for (int v = 0; v < nv; ++v) acc += s.minv[u * nv + v] * s.gi[v];
    s.qd[u] = s.qd[u] + acc;
  }
  __syncthreads();
}

__global__ void contact_sweep_kernel(
    const float* __restrict__ planes, const float* __restrict__ bias,
    const float* __restrict__ screws, const float* __restrict__ qd_in,
    const float* __restrict__ minv2, const float* __restrict__ obj_in,
    const float* __restrict__ lam0, const int* __restrict__ anc_bits,
    const int* __restrict__ obj_idx, float* __restrict__ qd_out,
    float* __restrict__ obj_out, float* __restrict__ lam_out, int B, int C,
    int nv, int K, int S, int sign_bits, int iterations, float omega,
    int apply_warm) {
  extern __shared__ float sm[];
  const Shared s = carve(sm, C, nv, K, S);
  const int b = blockIdx.x, t = threadIdx.x;
  const size_t BC = (size_t)B * C;

  for (int i = t; i < 6 * nv; i += blockDim.x)
    s.sc[i] = screws[(size_t)(i / nv) * B * nv + (size_t)b * nv + i % nv];
  for (int i = t; i < nv; i += blockDim.x) s.qd[i] = qd_in[(size_t)b * nv + i];
  for (int i = t; i < nv * nv; i += blockDim.x)
    s.minv[i] = minv2[(size_t)b * nv * nv + i];
  for (int i = t; i < 6 * K; i += blockDim.x)
    s.ob[i] = obj_in[(size_t)(i / K) * B * K + (size_t)b * K + i % K];
  for (int i = t; i < C; i += blockDim.x) s.bits[i] = anc_bits[i];
  for (int i = t; i < S * C; i += blockDim.x) s.oidx[i] = obj_idx[i];

  const bool slot = t < C;
  const int c = slot ? t : 0;
  const size_t off = (size_t)b * C + c;
  float pl[kNBase];
  float sd[kMaxSides][kNSide];
  float lam[3] = {0.0f, 0.0f, 0.0f};
  float bs = 0.0f;
  int bits_c = 0;
  int oidx_c[kMaxSides] = {-1, -1};
#pragma unroll
  for (int p = 0; p < kNBase; ++p) pl[p] = slot ? planes[p * BC + off] : 0.0f;
#pragma unroll
  for (int q = 0; q < kMaxSides; ++q)
#pragma unroll
    for (int p = 0; p < kNSide; ++p)
      sd[q][p] = (slot && q < S) ? planes[(kNBase + q * kNSide + p) * BC + off] : 0.0f;
  if (slot) {
    for (int i = 0; i < 3; ++i) lam[i] = lam0[i * BC + off];
    bs = bias[off];
    bits_c = anc_bits[c];
#pragma unroll
    for (int q = 0; q < kMaxSides; ++q)
      if (q < S) oidx_c[q] = obj_idx[q * C + c];
  }
  __syncthreads();

  // plane layout (ops/contact_sweep.py BASE): n 0-2, t1 3-5, t2 6-8,
  // pos 9-11, mu 12, inv_d 13-15, gate 16
  const float nx = pl[0], ny = pl[1], nz = pl[2];
  const float t1x = pl[3], t1y = pl[4], t1z = pl[5];
  const float t2x = pl[6], t2y = pl[7], t2z = pl[8];
  const float px = pl[9], py = pl[10], pz = pl[11];
  const float mu = pl[12], id0 = pl[13], id1 = pl[14], id2 = pl[15], gate = pl[16];

  if (apply_warm) {
    apply_impulse(s, slot, c, C, nv, K, S, sign_bits, pl, sd,
                  lam[0] * nx + lam[1] * t1x + lam[2] * t2x,
                  lam[0] * ny + lam[1] * t1y + lam[2] * t2y,
                  lam[0] * nz + lam[1] * t1z + lam[2] * t2z);
  }

  for (int it = 0; it < iterations; ++it) {
    for (int j = t; j < 6 * nv; j += blockDim.x) s.sv[j] = s.sc[j] * s.qd[j % nv];
    __syncthreads();
    float dPx = 0.0f, dPy = 0.0f, dPz = 0.0f;
    if (slot) {
      float w[6];
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        float acc = 0.0f;
        for (int u = 0; u < nv; ++u)
          if ((bits_c >> u) & 1) acc += s.sv[a * nv + u];
        w[a] = acc;
      }
      float vx = w[3] + w[1] * pz - w[2] * py;
      float vy = w[4] + w[2] * px - w[0] * pz;
      float vz = w[5] + w[0] * py - w[1] * px;
#pragma unroll
      for (int q = 0; q < kMaxSides; ++q) {
        if (q < S && oidx_c[q] >= 0) {
          const int k = oidx_c[q];
          const float sg = ((sign_bits >> q) & 1) ? -1.0f : 1.0f;
          const float rx = sd[q][0], ry = sd[q][1], rz = sd[q][2];
          const float o0 = s.ob[0 * K + k], o1 = s.ob[1 * K + k], o2 = s.ob[2 * K + k];
          const float a0 = s.ob[3 * K + k], a1 = s.ob[4 * K + k], a2 = s.ob[5 * K + k];
          vx = vx + sg * (o0 + a1 * rz - a2 * ry);
          vy = vy + sg * (o1 + a2 * rx - a0 * rz);
          vz = vz + sg * (o2 + a0 * ry - a1 * rx);
        }
      }
      const float vn = vx * nx + vy * ny + vz * nz;
      const float vt1 = vx * t1x + vy * t1y + vz * t1z;
      const float vt2 = vx * t2x + vy * t2y + vz * t2z;
      const float new_n = fmaxf(lam[0] + (bs - vn) * id0, 0.0f);
      const float ft1 = lam[1] - vt1 * id1;
      const float ft2 = lam[2] - vt2 * id2;
      const float fmag = sqrtf(ft1 * ft1 + ft2 * ft2);
      const float fmax = mu * new_n;
      const float scale = fmag > fmax ? fmax / fmaxf(fmag, 1e-9f) : 1.0f;
      const float d0 = omega * (new_n - lam[0]) * gate;
      const float d1 = omega * (ft1 * scale - lam[1]) * gate;
      const float d2 = omega * (ft2 * scale - lam[2]) * gate;
      lam[0] += d0;
      lam[1] += d1;
      lam[2] += d2;
      dPx = d0 * nx + d1 * t1x + d2 * t2x;
      dPy = d0 * ny + d1 * t1y + d2 * t2y;
      dPz = d0 * nz + d1 * t1z + d2 * t2z;
    }
    apply_impulse(s, slot, c, C, nv, K, S, sign_bits, pl, sd, dPx, dPy, dPz);
  }

  for (int i = t; i < nv; i += blockDim.x) qd_out[(size_t)b * nv + i] = s.qd[i];
  for (int i = t; i < 6 * K; i += blockDim.x)
    obj_out[(size_t)(i / K) * B * K + (size_t)b * K + i % K] = s.ob[i];
  if (slot)
    for (int i = 0; i < 3; ++i) lam_out[i * BC + off] = lam[i];
}

}  // namespace

extern "C" int contact_sweep_f32(
    const float* planes, const float* bias, const float* screws,
    const float* qd, const float* minv2, const float* obj, const float* lam0,
    const int* anc_bits, const int* obj_idx, float* qd_out, float* obj_out,
    float* lam_out, int B, int C, int nv, int K, int S, int sign_bits,
    int iterations, float omega, int apply_warm, void* stream) {
  if (nv < 1 || nv > 31 || K < 1 || S < 0 || S > kMaxSides || C < 1)
    return (int)cudaErrorInvalidValue;
  int threads = C;
  if (6 * nv + S * 6 * K > threads) threads = 6 * nv + S * 6 * K;
  threads = (threads + 31) / 32 * 32;
  if (threads > 1024) return (int)cudaErrorInvalidValue;
  const size_t smem = shared_bytes(C, nv, K, S);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        contact_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  contact_sweep_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      planes, bias, screws, qd, minv2, obj, lam0, anc_bits, obj_idx, qd_out,
      obj_out, lam_out, B, C, nv, K, S, sign_bits, iterations, omega,
      apply_warm);
  return (int)cudaGetLastError();
}
