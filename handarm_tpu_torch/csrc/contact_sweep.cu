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
// bias, lam0, screws, qd, Minv and write qd, object velocities and lam; at
// B = 8192, C = 372 that is ~550 MB, about 0.165 ms at 3.35 TB/s, against
// a few GFLOP of f32 arithmetic. The sweeps are a dependent chain inside
// each env, so the kernel is bound by the latency of its per-sweep phases
// and barriers: what the design cuts is the length of those phases.
//
// Design: one thread block per env, one thread per contact slot; the
// slot's planes, bias and impulses live in registers for all the sweeps,
// so every plane is read from device memory once per solve. The env's
// screws, qd, Minv and object velocities are staged in shared memory (all
// their loads in flight before any store). Every robot coupling goes
// through per-link aggregates: the slots' dof masks take L distinct values
// (one per hand link; at most nv on a kinematic tree), and the static
// tables of physics/solver.py `build_slot_groups` list each link's slots
// and each (side, object) bin's slots. Once per solve the block forms
// W = Minv J (nv x 6 L), J_u(a, l) = s_au for the dofs u of link l. Per
// sweep:
//   A. 6 L threads form the link velocities V_l = S_l qd over the mask's
//      set dofs;                                                  barrier 1
//   B. each slot takes its robot velocity V_lin + V_ang x p from its
//      link's 6 values, adds the object sides, projects, and writes its
//      wrench (p x dP, dP) and object velocity deltas;           barrier 2
//   C. the group sums: 8 lanes per link group, 4 groups to a warp, and a
//      whole warp per object bin; 6 sums per lane, then a fixed-order
//      __shfl_xor_sync tree (no atomics: launches are bit-identical);
//                                                                 barrier 3
//   D. qd += W F_l: 4 lanes per dof, each summing every 4th of the 6 L
//      link terms, then an xor tree; other warps add the bins' sums to
//      the object velocities.                                     barrier 4
// Four barriers per sweep (the warm apply is B-D: three). Slots are one
// thread each, so C <= 1024. A dof mask is one 64-bit word (nv <= 64, L
// <= 64 distinct masks), staged first in shared memory so that it sits on
// an 8-byte boundary; the loops over a mask's set dofs walk its two 32-bit
// words (`dof_word`: a 64-bit shift or __ffsll costs several instructions
// on the card), in ascending dof order. Every loop over links, dofs and bins strides by the
// block's threads, so a block with fewer threads than 6 L or 4 nv (a scene
// with few slots and many dofs) takes several passes. At the two-arm
// AllegroKuka's nv = 46, L = 46, K = 3, S = 2, C = 506 the env's shared
// memory is about 104 KB (W = Minv J alone 50 KB), past the 48 KB of a
// default launch: one block of 512 threads runs on an SM at a time, or two.

#include <cuda_runtime.h>

namespace {

constexpr int kNBase = 17;
constexpr int kNSide = 10;
constexpr int kMaxSides = 2;
constexpr unsigned kFull = 0xffffffffu;

struct Dims {
  int B, C, nv, K, S, L, NL, NO, sign_bits;
};

struct Shared {
  float *sc, *qd, *minv, *W, *V, *Fl, *ob, *Ok, *F, *G;
  unsigned long long* lbits;
  int *lptr, *lslots, *optr, *oslots;
};

__host__ __device__ inline size_t shared_bytes(const Dims& d) {
  const size_t floats = 6 * d.nv + d.nv + d.nv * d.nv + 6 * d.L * d.nv + 12 * d.L +
                        6 * d.K + (size_t)d.S * 6 * d.K + 6 * (size_t)d.C +
                        (size_t)d.S * 6 * d.C;
  const size_t ints = 2 * d.L + (d.L + 1) + d.NL + (d.S * d.K + 1) + d.NO;
  return (floats + ints) * 4;
}

// The staged words (the 64-bit masks as two words each, screws, qd, Minv,
// object velocities, then the int tables) come first and in one run, so
// that one loop copies them all.
__host__ __device__ inline int staged_words(const Dims& d) {
  return 2 * d.L + 6 * d.nv + d.nv + d.nv * d.nv + 6 * d.K + (d.L + 1) + d.NL +
         (d.S * d.K + 1) + d.NO;
}

__device__ __forceinline__ Shared carve(float* sm, const Dims& d) {
  Shared s;
  // [L] dof masks at the start: 8-byte aligned
  s.lbits = reinterpret_cast<unsigned long long*>(sm);
  s.sc = reinterpret_cast<float*>(s.lbits + d.L);  // [6][nv] screws (ang xyz, lin xyz)
  s.qd = s.sc + 6 * d.nv;           // [nv]
  s.minv = s.qd + d.nv;             // [nv][nv]
  s.ob = s.minv + d.nv * d.nv;      // [6][K] object lin / ang velocity
  s.lptr = reinterpret_cast<int*>(s.ob + 6 * d.K);  // [L + 1]
  s.lslots = s.lptr + d.L + 1;      // [NL]
  s.optr = s.lslots + d.NL;         // [S K + 1]
  s.oslots = s.optr + d.S * d.K + 1;  // [NO]
  s.W = reinterpret_cast<float*>(s.oslots + d.NO);  // [nv][6][L] Minv J
  s.V = s.W + 6 * d.L * d.nv;       // [6][L] link velocities (ang, lin)
  s.Fl = s.V + 6 * d.L;             // [6][L] link sums of (p x dP, dP)
  s.Ok = s.Fl + 6 * d.L;            // [S][6][K] object bin sums
  s.F = s.Ok + d.S * 6 * d.K;       // [6][C] per-slot (p x dP, dP)
  s.G = s.F + 6 * d.C;              // [S][6][C] per-slot object deltas
  return s;
}

// Word h (0: dofs 0-31, 1: dofs 32-63) of a staged 64-bit dof mask.
__device__ __forceinline__ unsigned dof_word(const unsigned long long* bits, int l, int h) {
  return reinterpret_cast<const unsigned*>(bits + l)[h];
}

struct Inputs {
  const float *screws, *qd, *minv2, *obj;
  const unsigned long long* link_bits;
  const int *link_ptr, *link_slots, *obj_ptr, *obj_slots;
};

// Source of staged word i of env b.
__device__ __forceinline__ const unsigned* staged_src(int i, int b, const Dims& d,
                                                      const Inputs& in) {
  const int nv = d.nv, K = d.K;
  auto f = [](const float* p) { return reinterpret_cast<const unsigned*>(p); };
  auto n = [](const int* p) { return reinterpret_cast<const unsigned*>(p); };
  if (i < 2 * d.L) return reinterpret_cast<const unsigned*>(in.link_bits) + i;
  i -= 2 * d.L;
  if (i < 6 * nv) return f(in.screws + (size_t)(i / nv) * d.B * nv + (size_t)b * nv + i % nv);
  i -= 6 * nv;
  if (i < nv) return f(in.qd + (size_t)b * nv + i);
  i -= nv;
  if (i < nv * nv) return f(in.minv2 + (size_t)b * nv * nv + i);
  i -= nv * nv;
  if (i < 6 * K) return f(in.obj + (size_t)(i / K) * d.B * K + (size_t)b * K + i % K);
  i -= 6 * K;
  if (i <= d.L) return n(in.link_ptr + i);
  i -= d.L + 1;
  if (i < d.NL) return n(in.link_slots + i);
  i -= d.NL;
  if (i <= d.S * K) return n(in.obj_ptr + i);
  return n(in.obj_slots + i - (d.S * K + 1));
}

// Copies the staged words with up to 4 loads in flight per thread before
// any store (the copies are independent).
__device__ __forceinline__ void stage(float* sm, int b, const Dims& d, const Inputs& in) {
  unsigned* dst = reinterpret_cast<unsigned*>(sm);
  const int n = staged_words(d), bd = blockDim.x;
  for (int i0 = threadIdx.x; i0 < n; i0 += 4 * bd) {
    unsigned v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = i0 + k * bd;
      v[k] = i < n ? __ldg(staged_src(i, b, d, in)) : 0u;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (i0 + k * bd < n) dst[i0 + k * bd] = v[k];
  }
}

// Phase C, as tasks spread over the warps: a task of 4 link groups, 8
// lanes each (a link has a few to a few tens of slots), or one object bin
// on a whole warp (bins hold tens to a hundred). Each lane keeps 6 sums;
// a fixed-order xor tree inside the group's lanes finishes them.
template <int kWidth>
__device__ __forceinline__ void reduce_list(const float* src, const int* list, int p0,
                                            int p1, int sub, int C, float* dst, int stride,
                                            bool write) {
  float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 2
  for (int p = p0 + sub; p < p1; p += kWidth) {
    const int c = list[p];
#pragma unroll
    for (int a = 0; a < 6; ++a) acc[a] += src[a * C + c];
  }
#pragma unroll
  for (int off = kWidth / 2; off > 0; off >>= 1)
#pragma unroll
    for (int a = 0; a < 6; ++a) acc[a] += __shfl_xor_sync(kFull, acc[a], off);
  if (write && sub == 0) {
#pragma unroll
    for (int a = 0; a < 6; ++a) dst[a * stride] = acc[a];
  }
}

__device__ __forceinline__ void reduce_groups(const Shared& s, const Dims& d) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int link_tasks = (d.L + 3) / 4;
  for (int task = warp; task < link_tasks + d.S * d.K; task += blockDim.x >> 5) {
    if (task < link_tasks) {  // warp-uniform branches: all lanes shuffle
      const int g = 4 * task + lane / 8;
      const bool ok = g < d.L;
      reduce_list<8>(s.F, s.lslots, ok ? s.lptr[g] : 0, ok ? s.lptr[g + 1] : 0, lane % 8,
                     d.C, s.Fl + (ok ? g : 0), d.L, ok);
    } else {
      const int j = task - link_tasks, q = j / d.K, k = j % d.K;  // bin q K + k
      reduce_list<32>(s.G + q * 6 * d.C, s.oslots, s.optr[j], s.optr[j + 1], lane, d.C,
                      s.Ok + q * 6 * d.K + k, d.K, true);
    }
  }
}

// Phase D: qd += W Fl, with 4 lanes per dof each summing every 4th of the
// 6 L link terms and a fixed-order xor tree; the object bin sums to the
// objects. Items [0, R) are the dofs' lanes, R a multiple of 32, so each
// warp's pass is all dof lanes or all object items.
__device__ __forceinline__ void to_dofs(const Shared& s, const Dims& d) {
  const int R = (4 * d.nv + 31) & ~31, n6 = 6 * d.L;
  for (int i = threadIdx.x; i < R + 6 * d.K; i += blockDim.x) {
    if (i < R) {
      const int u = i >> 2, part = i & 3;
      float acc = 0.0f;
      if (u < d.nv) {
        const float* w = s.W + u * n6;
#pragma unroll 4
        for (int k = part; k < n6; k += 4) acc += w[k] * s.Fl[k];
      }
      acc += __shfl_xor_sync(kFull, acc, 1);
      acc += __shfl_xor_sync(kFull, acc, 2);
      if (u < d.nv && part == 0) s.qd[u] += acc;
    } else {
      const int j = i - R;
      float v = s.ob[j];
      for (int q = 0; q < d.S; ++q) {
        const float sg = ((d.sign_bits >> q) & 1) ? -1.0f : 1.0f;
        v = v + sg * s.Ok[q * 6 * d.K + j];
      }
      s.ob[j] = v;
    }
  }
}

template <int kMaxThreads, int kMinBlocks>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks) contact_sweep_kernel(
    const float* __restrict__ planes, const float* __restrict__ bias,
    const float* __restrict__ screws, const float* __restrict__ qd_in,
    const float* __restrict__ minv2, const float* __restrict__ obj_in,
    const float* __restrict__ lam0, const unsigned long long* __restrict__ link_bits,
    const int* __restrict__ slot_link, const int* __restrict__ link_ptr,
    const int* __restrict__ link_slots, const int* __restrict__ obj_idx,
    const int* __restrict__ obj_ptr, const int* __restrict__ obj_slots,
    float* __restrict__ qd_out, float* __restrict__ obj_out,
    float* __restrict__ lam_out, const Dims d, int iterations, float omega,
    int apply_warm) {
  extern __shared__ __align__(16) float sm[];
  const Shared s = carve(sm, d);
  const int b = blockIdx.x, t = threadIdx.x, bd = blockDim.x;
  const int C = d.C, nv = d.nv, K = d.K, L = d.L;
  const size_t BC = (size_t)d.B * C;

  const bool slot = t < C;
  const int c = slot ? t : 0;
  const size_t off = (size_t)b * C + c;
  float pl[kNBase];
  float sd[kMaxSides][kNSide];
  float lam[3] = {0.0f, 0.0f, 0.0f};
  float bs = 0.0f;
  int link = -1;
  int oidx[kMaxSides] = {-1, -1};
#pragma unroll
  for (int p = 0; p < kNBase; ++p) pl[p] = slot ? planes[p * BC + off] : 0.0f;
#pragma unroll
  for (int q = 0; q < kMaxSides; ++q)
#pragma unroll
    for (int p = 0; p < kNSide; ++p)
      sd[q][p] = (slot && q < d.S) ? planes[(kNBase + q * kNSide + p) * BC + off] : 0.0f;
  if (slot) {
    for (int i = 0; i < 3; ++i) lam[i] = lam0[i * BC + off];
    bs = bias[off];
    link = slot_link[c];
#pragma unroll
    for (int q = 0; q < kMaxSides; ++q)
      if (q < d.S) oidx[q] = obj_idx[q * C + c];
  }
  stage(sm, b, d, Inputs{screws, qd_in, minv2, obj_in, link_bits, link_ptr, link_slots,
                         obj_ptr, obj_slots});
  __syncthreads();
  // W[u][a L + l] = sum over the set dofs v of link l of Minv_uv s_av
  for (int i = t; i < nv * 6 * L; i += bd) {
    const int u = i / (6 * L), k = i % (6 * L), l = k % L;
    const float* mu = s.minv + u * nv;
    const float* sa = s.sc + (k / L) * nv;
    float acc = 0.0f;
    for (int h = 0; h < 2; ++h)  // the link's set dofs v ascending
      for (unsigned r = dof_word(s.lbits, l, h); r; r &= r - 1) {
        const int v = 32 * h + __ffs(r) - 1;
        acc += mu[v] * sa[v];
      }
    s.W[i] = acc;
  }
  __syncthreads();

  // plane layout (ops/contact_sweep.py BASE): n 0-2, t1 3-5, t2 6-8,
  // pos 9-11, mu 12, inv_d 13-15, gate 16
  const float nx = pl[0], ny = pl[1], nz = pl[2];
  const float t1x = pl[3], t1y = pl[4], t1z = pl[5];
  const float t2x = pl[6], t2y = pl[7], t2z = pl[8];
  const float px = pl[9], py = pl[10], pz = pl[11];
  const float mu = pl[12], id0 = pl[13], id1 = pl[14], id2 = pl[15], gate = pl[16];

  // Phase B's writes: the slot's wrench and its object velocity deltas.
  auto write_slot = [&](float dPx, float dPy, float dPz) {
    if (!slot) return;
    if (link >= 0) {
      s.F[0 * C + c] = py * dPz - pz * dPy;
      s.F[1 * C + c] = pz * dPx - px * dPz;
      s.F[2 * C + c] = px * dPy - py * dPx;
      s.F[3 * C + c] = dPx;
      s.F[4 * C + c] = dPy;
      s.F[5 * C + c] = dPz;
    }
#pragma unroll
    for (int q = 0; q < kMaxSides; ++q) {
      if (q < d.S && oidx[q] >= 0) {
        const float* r = sd[q];
        const float rx = r[0], ry = r[1], rz = r[2], invm = r[9];
        const float tx = ry * dPz - rz * dPy;
        const float ty = rz * dPx - rx * dPz;
        const float tz = rx * dPy - ry * dPx;
        float* g = s.G + q * 6 * C;
        g[0 * C + c] = dPx * invm;
        g[1 * C + c] = dPy * invm;
        g[2 * C + c] = dPz * invm;
        g[3 * C + c] = r[3] * tx + r[4] * ty + r[5] * tz;
        g[4 * C + c] = r[4] * tx + r[6] * ty + r[7] * tz;
        g[5 * C + c] = r[5] * tx + r[7] * ty + r[8] * tz;
      }
    }
  };
  auto apply = [&]() {  // phases C and D, after phase B's writes
    __syncthreads();
    reduce_groups(s, d);
    __syncthreads();
    to_dofs(s, d);
    __syncthreads();
  };

  if (apply_warm) {
    write_slot(lam[0] * nx + lam[1] * t1x + lam[2] * t2x,
               lam[0] * ny + lam[1] * t1y + lam[2] * t2y,
               lam[0] * nz + lam[1] * t1z + lam[2] * t2z);
    apply();
  }

  for (int it = 0; it < iterations; ++it) {
    // Phase A: link velocities over each mask's set dofs.
    for (int j = t; j < 6 * L; j += bd) {
      const float* sa = s.sc + (j / L) * nv;
      float acc = 0.0f;
      for (int h = 0; h < 2; ++h)
        for (unsigned r = dof_word(s.lbits, j % L, h); r; r &= r - 1) {
          const int u = 32 * h + __ffs(r) - 1;
          acc += sa[u] * s.qd[u];
        }
      s.V[j] = acc;
    }
    __syncthreads();
    // Phase B: per slot.
    if (slot) {
      float w[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      if (link >= 0) {
#pragma unroll
        for (int a = 0; a < 6; ++a) w[a] = s.V[a * L + link];
      }
      float vx = w[3] + w[1] * pz - w[2] * py;
      float vy = w[4] + w[2] * px - w[0] * pz;
      float vz = w[5] + w[0] * py - w[1] * px;
#pragma unroll
      for (int q = 0; q < kMaxSides; ++q) {
        if (q < d.S && oidx[q] >= 0) {
          const int k = oidx[q];
          const float sg = ((d.sign_bits >> q) & 1) ? -1.0f : 1.0f;
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
      write_slot(d0 * nx + d1 * t1x + d2 * t2x, d0 * ny + d1 * t1y + d2 * t2y,
                 d0 * nz + d1 * t1z + d2 * t2z);
    }
    apply();
  }

  for (int i = t; i < nv; i += bd) qd_out[(size_t)b * nv + i] = s.qd[i];
  for (int i = t; i < 6 * K; i += bd)
    obj_out[(size_t)(i / K) * d.B * K + (size_t)b * K + i % K] = s.ob[i];
  if (slot)
    for (int i = 0; i < 3; ++i) lam_out[i * BC + off] = lam[i];
}

using Kernel = void (*)(const float*, const float*, const float*, const float*,
                        const float*, const float*, const float*, const unsigned long long*,
                        const int*, const int*, const int*, const int*, const int*,
                        const int*, float*, float*, float*, const Dims, int, float, int);

// The instantiation for a block of `threads` threads, its shared memory
// allowed; the launch and the occupancy query both take it from here. The
// register caps trade spills for resident blocks: on the card, 6 blocks of
// 128 threads (80 registers, a few spilled) and 2 of 384 beat the
// spill-free 4 and 1, and 3 of 384 spill too much.
int pick_kernel(int threads, size_t smem, Kernel* kernel) {
  if (threads <= 128)
    *kernel = contact_sweep_kernel<128, 6>;
  else if (threads <= 384)
    *kernel = contact_sweep_kernel<384, 2>;
  else
    *kernel = contact_sweep_kernel<1024, 1>;
  if (smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)smem);
  return 0;
}

// K = 0 (a robot alone over static geometry: the classic tasks' craft) takes
// S = 0: no object velocities are read or written, and no bins reduced.
bool valid(const Dims& d) {
  return d.B >= 1 && d.nv >= 1 && d.nv <= 64 && d.K >= (d.S > 0 ? 1 : 0) && d.K <= 8 &&
         d.S >= 0 &&
         d.S <= kMaxSides && d.C >= 1 && d.C <= 1024 && d.L >= 0 && d.L <= 64 &&
         d.NL >= 0 && d.NL <= d.C && d.NO >= 0 && d.NO <= d.S * d.C &&
         shared_bytes(d) <= 227 * 1024;
}

int threads_for(int C) { return C < 64 ? 64 : (C + 31) / 32 * 32; }

}  // namespace

// Limits (checked again by ops/contact_sweep.py): nv <= 64 (a dof mask is
// one 64-bit word), L <= 64, K <= 8 (K >= 1 where S > 0), S <= 2, C <= 1024
// (one thread per slot).
extern "C" int contact_sweep_f32(
    const float* planes, const float* bias, const float* screws,
    const float* qd, const float* minv2, const float* obj, const float* lam0,
    const unsigned long long* link_bits, const int* slot_link, const int* link_ptr,
    const int* link_slots, const int* obj_idx, const int* obj_ptr,
    const int* obj_slots, float* qd_out, float* obj_out, float* lam_out,
    int B, int C, int nv, int K, int S, int L, int NL, int NO, int sign_bits,
    int iterations, float omega, int apply_warm, void* stream) {
  const Dims d{B, C, nv, K, S, L, NL, NO, sign_bits};
  if (!valid(d)) return (int)cudaErrorInvalidValue;
  const int threads = threads_for(C);
  const size_t smem = shared_bytes(d);
  Kernel kernel;
  const int e = pick_kernel(threads, smem, &kernel);
  if (e != 0) return e;
  kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      planes, bias, screws, qd, minv2, obj, lam0, link_bits, slot_link,
      link_ptr, link_slots, obj_idx, obj_ptr, obj_slots, qd_out, obj_out,
      lam_out, d, iterations, omega, apply_warm);
  return (int)cudaGetLastError();
}

// The launch at these sizes: info = {threads per block, dynamic shared
// bytes, resident blocks per SM from the occupancy calculator}.
extern "C" int contact_sweep_launch_info(int C, int nv, int K, int S, int L, int NL,
                                         int NO, int* info) {
  const Dims d{1, C, nv, K, S, L, NL, NO, 0};
  info[0] = info[1] = info[2] = 0;
  if (!valid(d)) return (int)cudaErrorInvalidValue;
  info[0] = threads_for(C);
  const size_t smem = shared_bytes(d);
  info[1] = (int)smem;
  Kernel kernel;
  const int e = pick_kernel(info[0], smem, &kernel);
  if (e != 0) return e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[2], kernel, info[0], smem);
}
