// Trilinear sample of voxel SDF fields (distance + 3 gradient channels) for
// every mesh-SDF query of one contact generation, each query against its
// own object, with the out-of-grid excess on the distance.
//
// Replaces: handarm_tpu/ops/sdf_gather.py `_kernel` (launched by
// `sdf_sample_pallas`, which handarm_tpu/physics/shapes.py `object_sdf`
// calls once per mesh object and query block), with the excess term that
// `sdf_sample_pallas` adds after the Pallas call. It computes what the TPU
// kernel computes, not how: the TPU kernel turns the gather into a one-hot
// matmul against a bf16 hi/lo table on the MXU; here every point does an
// f32 8-corner gather. Per query: u = clamp((p - lo_k) / spacing_k, 0, R - 1.001),
// i0 = floor(u), i1 = i0 + 1 (the clamp keeps i0 <= R - 2), lerp along z,
// then y, then x (the order of physics/sdf.py), and channel 0 +=
// |max(|u_raw - h| - h, 0)| * spacing_k with h = (R - 1) / 2.
//
// What bounds it on an H100: per query it reads 12 bytes and writes 16;
// the fields (K = 3 at R = 32: 1.57 MB) and the static table (8 bytes per
// query of a row) are read once. At the 1.2M queries of one multi-object
// contact generation (8192 envs x 147) that is ~35 MB, about 10.5 us at
// 3.35 TB/s, against ~135 MFLOP (2 us at 67 TFLOP/s f32): bytes.
//
// Design: one launch per contact generation. Thread i takes entry
// i mod Lq of the static table (position in the env's row of L queries,
// object) for env i / Lq. The table lists each object's queries together,
// so the 32 points of a warp mostly sample one field: one env's hand
// spheres or one object's surface points, in that object's frame, whose
// corner loads can share L1 lines. Points are read and results written at
// their slot positions, so the output needs no reordering. The fields stay
// in the 50 MB L2; each corner is one 16-byte load, and since i1 = i0 + 1
// the (z0, z1) pair is 32 contiguous bytes, loaded back to back. On an
// H100 the kernel runs at ~2.5x its byte bound, and neither the thread
// order nor fewer L2 sectors moved it: each warp-wide corner load touches
// up to 32 scattered lines. Texture filtering is not used: its 8-bit
// weights would break 1e-4 agreement.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float4 lerp4(float4 a, float4 b, float f) {
  const float g = 1.0f - f;
  return make_float4(a.x * g + b.x * f, a.y * g + b.y * f, a.z * g + b.z * f,
                     a.w * g + b.w * f);
}

__global__ void __launch_bounds__(kThreads)
    sdf_gather_kernel(const float4* __restrict__ field, const float* __restrict__ lo,
                      const float* __restrict__ spacing, const float* __restrict__ p,
                      const int2* __restrict__ table, float4* __restrict__ out,
                      int total, int L, int Lq, int K, int R) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const int b = i / Lq;
  const int2 e = __ldg(table + (i - b * Lq));  // (position, object)
  if (e.x < 0 || e.x >= L || e.y < 0 || e.y >= K) return;
  const size_t q = (size_t)b * L + e.x;
  const int k = e.y;
  const float sp = __ldg(spacing + k);
  const float umax = (float)((double)R - 1.001);  // as the f32 clamp bound
  const float half = ((float)R - 1.0f) * 0.5f;
  int i0[3];
  float fr[3];
  float ex2 = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float u_raw = (__ldg(p + 3 * q + a) - __ldg(lo + 3 * k + a)) / sp;
    const float u = fminf(fmaxf(u_raw, 0.0f), umax);
    const float f0 = floorf(u);
    i0[a] = (int)f0;
    fr[a] = u - f0;
    const float ex = fmaxf(fabsf(u_raw - half) - half, 0.0f);
    ex2 += ex * ex;
  }
  const int RR = R * R;
  const float4* c = field + (size_t)k * RR * R + (i0[0] * R + i0[1]) * R + i0[2];
  // the eight corners, all loads in flight together: (x, y) columns at
  // offsets 0, R, R^2, R^2 + R, each with its contiguous (z0, z1) pair
  const float4 a000 = __ldg(c), a001 = __ldg(c + 1);
  const float4 a010 = __ldg(c + R), a011 = __ldg(c + R + 1);
  const float4 a100 = __ldg(c + RR), a101 = __ldg(c + RR + 1);
  const float4 a110 = __ldg(c + RR + R), a111 = __ldg(c + RR + R + 1);
  const float4 c00 = lerp4(a000, a001, fr[2]);
  const float4 c01 = lerp4(a010, a011, fr[2]);
  const float4 c10 = lerp4(a100, a101, fr[2]);
  const float4 c11 = lerp4(a110, a111, fr[2]);
  const float4 c0 = lerp4(c00, c01, fr[1]);
  const float4 c1 = lerp4(c10, c11, fr[1]);
  float4 r = lerp4(c0, c1, fr[0]);
  r.x += sqrtf(ex2) * sp;
  out[q] = r;
}

}  // namespace

extern "C" int sdf_gather_f32(const float* field, const float* lo,
                              const float* spacing, const float* p,
                              const int* table, float* out, int B, int L,
                              int Lq, int K, int R, void* stream) {
  if (B < 0 || L < 0 || Lq < 0 || Lq > L || K < 1 || R < 2 ||
      (long long)B * Lq >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int total = B * Lq;
  if (total == 0) return (int)cudaSuccess;
  const int blocks = (total + kThreads - 1) / kThreads;
  sdf_gather_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(field), lo, spacing, p,
      reinterpret_cast<const int2*>(table), reinterpret_cast<float4*>(out),
      total, L, Lq, K, R);
  return (int)cudaGetLastError();
}
