// Trilinear sample of a voxel SDF field (distance + 3 gradient channels) at
// body-frame points, with the out-of-grid excess on the distance.
//
// Replaces: handarm_tpu/ops/sdf_gather.py `_kernel` (launched by
// `sdf_sample_pallas`, called from shapes.object_sdf for mesh-SDF objects),
// together with the excess term that `sdf_sample_pallas` adds after the
// Pallas call. It computes what the TPU kernel computes, not how: the TPU
// kernel turns the gather into a one-hot matmul against a bf16 hi/lo table
// on the MXU; here every point does an f32 8-corner gather. Per point:
// u = clamp((p - lo) / spacing, 0, R - 1.001), i0 = floor(u), i1 =
// min(i0 + 1, R - 1), lerp along z, then y, then x (the order of
// physics/sdf.py), and channel 0 += |max(|u_raw - h| - h, 0)| * spacing with
// h = (R - 1) / 2.
//
// What bounds it on an H100: per point it reads 12 bytes and writes 16,
// and the field (R = 32: 512 KB) is read once per launch; at the 270K
// points of one spheres-vs-object query that is ~8 MB, about 2.5 us at
// 3.35 TB/s, against ~30 MFLOP (under 1 us at 67 TFLOP/s f32).
//
// Design: one thread per point. The field is [x][y][z][4] floats, so each
// corner is one aligned 16-byte load (float4 through the read-only path);
// the 512 KB field stays in L2 across the launch. Points are read and the
// results written with neighbouring threads on neighbouring addresses; the
// ragged last block is masked.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float4 lerp4(float4 a, float4 b, float f) {
  const float g = 1.0f - f;
  return make_float4(a.x * g + b.x * f, a.y * g + b.y * f, a.z * g + b.z * f,
                     a.w * g + b.w * f);
}

__global__ void sdf_gather_kernel(const float4* __restrict__ field,
                                  const float* __restrict__ lo,
                                  const float* __restrict__ spacing,
                                  const float* __restrict__ p,
                                  float4* __restrict__ out, int N, int R) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const float sp = __ldg(spacing);
  const float umax = (float)((double)R - 1.001);  // as the f32 clamp bound
  const float half = ((float)R - 1.0f) * 0.5f;
  int i0[3], i1[3];
  float fr[3];
  float ex2 = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float u_raw = (__ldg(p + 3 * (size_t)i + a) - __ldg(lo + a)) / sp;
    const float u = fminf(fmaxf(u_raw, 0.0f), umax);
    const float f0 = floorf(u);
    i0[a] = (int)f0;
    i1[a] = min(i0[a] + 1, R - 1);
    fr[a] = u - f0;
    const float e = fmaxf(fabsf(u_raw - half) - half, 0.0f);
    ex2 += e * e;
  }
  const size_t R2 = (size_t)R * R;
  auto at = [&](int x, int y, int z) {
    return __ldg(field + (size_t)x * R2 + (size_t)y * R + z);
  };
  const float4 c00 = lerp4(at(i0[0], i0[1], i0[2]), at(i0[0], i0[1], i1[2]), fr[2]);
  const float4 c01 = lerp4(at(i0[0], i1[1], i0[2]), at(i0[0], i1[1], i1[2]), fr[2]);
  const float4 c10 = lerp4(at(i1[0], i0[1], i0[2]), at(i1[0], i0[1], i1[2]), fr[2]);
  const float4 c11 = lerp4(at(i1[0], i1[1], i0[2]), at(i1[0], i1[1], i1[2]), fr[2]);
  const float4 c0 = lerp4(c00, c01, fr[1]);
  const float4 c1 = lerp4(c10, c11, fr[1]);
  float4 r = lerp4(c0, c1, fr[0]);
  r.x += sqrtf(ex2) * sp;
  out[i] = r;
}

}  // namespace

extern "C" int sdf_gather_f32(const float* field, const float* lo,
                              const float* spacing, const float* p, float* out,
                              int N, int R, void* stream) {
  if (N < 0 || R < 2) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  const int blocks = (N + kThreads - 1) / kThreads;
  sdf_gather_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(field), lo, spacing, p,
      reinterpret_cast<float4*>(out), N, R);
  return (int)cudaGetLastError();
}
