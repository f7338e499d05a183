// Device functions shared by the MANO kernels: the prelude of every tiled
// kernel (tiled_phase_d.cuh's users: K1/K5 and K2 in fused_forward.cu and
// fused_posed.cu), and prepare_smem (K3 in skin.cu too). The build uses no
// --use_fast_math, so sinf/cosf/sqrtf and division are the accurate IEEE
// versions.
//
// The prelude of a block's tile of kRows batch rows, in three phases over
// the tile's shared memory (any struct with float* skin and jrest, int*
// parents and depth, and a coef row pointer of float or __nv_bfloat16):
//   A  per (row, joint): Rodrigues into the row's skin slots, (R - I) into
//      the row's blend coefficients (rodrigues_rows);
//   B  forward kinematics in place along the topologically ordered tree
//      (parents[j] < j), every (row, joint) of a tree level at once
//      (fk_levels; the levels from tree_depths, into the tile's depth);
//   C  per (row, joint): inverse bind, t <- world_t - world_R @ J_rest
//      (inverse_bind_rows).
// The rest joints (shaped by K1, gathered from the subject table by K2)
// are the caller's, in jrest before phase B. K2's bf16 tier (kBf16)
// rounds its coefficients after phase A and its skinning entries after
// phase C to bf16, and computes phases A-C as separately rounded
// operations (__fmul_rn, __fadd_rn: never contracted to FMA) in the order
// of the plain versions (ops/rodrigues.py, ops/fk.py), so that the
// rotations and skinning transforms equal theirs bit for bit and the bf16
// roundings of them agree; the fp32 kernels let the compiler fuse them
// into FMAs (the exact form made K1 measurably slower) and agree with the
// plain versions to fp32 rounding.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mano {

constexpr int kMaxJoints = 64;  // bounds the shared-memory tiles (< 227 KB)

// x rounded to bf16 (to nearest even) when kBf16, as fp32.
template <bool kBf16>
__device__ __forceinline__ float maybe_bf16(float x) {
  if constexpr (kBf16) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

// fp32 arithmetic of the prelude: separately rounded when kExact (never
// contracted to FMA), free for the compiler to fuse otherwise.
template <bool kExact>
__device__ __forceinline__ float mul(float a, float b) {
  if constexpr (kExact) return __fmul_rn(a, b);
  return a * b;
}
template <bool kExact>
__device__ __forceinline__ float add(float a, float b) {
  if constexpr (kExact) return __fadd_rn(a, b);
  return a + b;
}
template <bool kExact>
__device__ __forceinline__ float sub(float a, float b) {
  if constexpr (kExact) return __fsub_rn(a, b);
  return a - b;
}
// (u0 v0 + u1 v1) + u2 v2, the plain versions' 3-term dot.
template <bool kExact>
__device__ __forceinline__ float dot3(float u0, float u1, float u2, float v0,
                                      float v1, float v2) {
  return add<kExact>(add<kExact>(mul<kExact>(u0, v0), mul<kExact>(u1, v1)),
                     mul<kExact>(u2, v2));
}

// Taylor-guarded Rodrigues, the formula and operation order of
// ops/rodrigues.py: R = (1 - b t2) I + a K + b r r^T, a = sin(t)/t,
// b = (1 - cos(t))/t^2. Below t2 = 1e-8 the series is a = 1 and b = 0.5
// exactly in fp32.
template <bool kExact>
__device__ __forceinline__ void rodrigues(float x, float y, float z,
                                          float* R) {
  const auto mul = [](float u, float v) { return mano::mul<kExact>(u, v); };
  const auto add = [](float u, float v) { return mano::add<kExact>(u, v); };
  const auto sub = [](float u, float v) { return mano::sub<kExact>(u, v); };
  const float t2 = add(add(mul(x, x), mul(y, y)), mul(z, z));
  float a = 1.0f, b = 0.5f;
  if (!(t2 < 1e-8f)) {
    const float th = sqrtf(t2);
    a = __fdiv_rn(sinf(th), th);
    b = __fdiv_rn(sub(1.0f, cosf(th)), mul(th, th));
  }
  const float d = sub(1.0f, mul(b, t2));
  const float ax = mul(a, x), ay = mul(a, y), az = mul(a, z);
  const float bxy = mul(b, mul(x, y)), bxz = mul(b, mul(x, z)),
              byz = mul(b, mul(y, z));
  R[0] = add(d, mul(b, mul(x, x)));  R[1] = sub(bxy, az);  R[2] = add(bxz, ay);
  R[3] = add(bxy, az);  R[4] = add(d, mul(b, mul(y, y)));  R[5] = sub(byz, ax);
  R[6] = sub(bxz, ay);  R[7] = add(byz, ax);  R[8] = add(d, mul(b, mul(z, z)));
}

// Tile rows past the batch end replay the last row (never written out).
__device__ __forceinline__ int tile_row(int row0, int r, int B) {
  return min(row0 + r, B - 1);
}

__device__ __forceinline__ void store_coef(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_coef(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Phase A, rotations, by kThreads threads: local R of every (row, joint)
// into skin[r][j][0:9]; (R - I) of joints 1.. into coef[r * cstride + koff
// + 9 (j - 1) + e] (the reference's row-major pose feature, so the basis
// rows need no permutation), rounded to bf16 when kBf16. The local R (an
// FK input) is never rounded.
template <int kRows, int kThreads, bool kBf16, typename Tile>
__device__ __forceinline__ void rodrigues_rows(const float* __restrict__ pose,
                                               int B, int row0, int J,
                                               int cstride, int koff,
                                               const Tile& t) {
  for (int i = threadIdx.x; i < kRows * J; i += kThreads) {
    const int r = i / J, j = i - r * J;
    const float* q = pose + ((size_t)tile_row(row0, r, B) * J + j) * 3;
    float R[9];
    rodrigues<kBf16>(q[0], q[1], q[2], R);
    float* sk = t.skin + i * 12;
#pragma unroll
    for (int e = 0; e < 9; ++e) sk[e] = R[e];
    if (j > 0) {
      auto* c = t.coef + r * cstride + koff + (j - 1) * 9;
#pragma unroll
      for (int e = 0; e < 9; ++e)
        store_coef(c + e,
                   maybe_bf16<kBf16>(R[e] - ((e % 4 == 0) ? 1.0f : 0.0f)));
    }
  }
}

// Phase B for joint j > 0 of one row, in place over the row's slots sk
// [J][12] (rest joints jr [J][3]): world_R[j] = world_R[p] @ R[j],
// world_t[j] = world_R[p] @ (J_j - J_p) + world_t[p]. kExact: separately
// rounded, in the order of ops/fk.py.
template <bool kExact>
__device__ __forceinline__ void fk_joint(float* sk, const float* jr, int j,
                                         int p) {
  const auto add = [](float u, float v) { return mano::add<kExact>(u, v); };
  const auto sub = [](float u, float v) { return mano::sub<kExact>(u, v); };
  const float* P = sk + p * 12;
  float* W = sk + j * 12;
  float L[9];
#pragma unroll
  for (int e = 0; e < 9; ++e) L[e] = W[e];
  const float d0 = sub(jr[3 * j], jr[3 * p]);
  const float d1 = sub(jr[3 * j + 1], jr[3 * p + 1]);
  const float d2 = sub(jr[3 * j + 2], jr[3 * p + 2]);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = 0; b < 3; ++b)
      W[3 * a + b] = dot3<kExact>(P[3 * a], P[3 * a + 1], P[3 * a + 2], L[b],
                                  L[3 + b], L[6 + b]);
    W[9 + a] = add(dot3<kExact>(P[3 * a], P[3 * a + 1], P[3 * a + 2], d0, d1,
                                d2),
                   P[9 + a]);
  }
}

// The depth of every joint (the root 0, a child one more than its parent)
// into depth[0 .. J), and the number of levels into depth[J], by one
// thread; parents must be in shared memory.
__device__ __forceinline__ void tree_depths(const int* parents, int J,
                                            int* depth) {
  int levels = 1;
  depth[0] = 0;
  for (int j = 1; j < J; ++j) {
    depth[j] = depth[parents[j]] + 1;
    levels = max(levels, depth[j] + 1);
  }
  depth[J] = levels;
}

// Phase B level by level: every (row, joint) of one depth at once, a
// barrier between depths, each joint's arithmetic fk_joint's. Spreads the
// rows' chains over the block (one thread a row serialises a row tile's
// FK, and its rows J * 12 floats apart all fall in one bank: 0.020 ms of
// K2 at B = 1024). Starts and ends with a barrier.
template <int kRows, int kThreads, bool kExact, typename Tile>
__device__ __forceinline__ void fk_levels(const Tile& t, int J) {
  __syncthreads();
  const int* depth = t.depth;
  const int levels = depth[J];
  for (int r = threadIdx.x; r < kRows; r += kThreads) {
    float* sk = t.skin + r * J * 12;
    const float* jr = t.jrest + r * J * 3;
    sk[9] = jr[0];
    sk[10] = jr[1];
    sk[11] = jr[2];
  }
  for (int l = 1; l < levels; ++l) {
    __syncthreads();
    for (int i = threadIdx.x; i < kRows * J; i += kThreads) {
      const int r = i / J, j = i - r * J;
      if (depth[j] == l)
        fk_joint<kExact>(t.skin + r * J * 12, t.jrest + r * J * 3, j,
                         t.parents[j]);
    }
  }
  __syncthreads();
}

// Phase C: inverse bind per (row, joint): t <- world_t - world_R @ J_rest.
// kBf16: computed as ops/fk.py computes it, then the slot's 12 skinning
// entries rounded to bf16 (after FK).
template <int kRows, int kThreads, bool kBf16, typename Tile>
__device__ __forceinline__ void inverse_bind_rows(const Tile& t, int J) {
  for (int i = threadIdx.x; i < kRows * J; i += kThreads) {
    float* sk = t.skin + i * 12;
    const float* jr = t.jrest + i * 3;
    float u[3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
      u[a] = sub<kBf16>(sk[9 + a], dot3<kBf16>(sk[3 * a], sk[3 * a + 1],
                                               sk[3 * a + 2], jr[0], jr[1],
                                               jr[2]));
#pragma unroll
    for (int a = 0; a < 3; ++a) sk[9 + a] = maybe_bf16<kBf16>(u[a]);
    if constexpr (kBf16) {
#pragma unroll
      for (int e = 0; e < 9; ++e) sk[e] = maybe_bf16<true>(sk[e]);
    }
  }
}

// Phases B and C after A, the rest joints and tree_depths (visible after
// the first barrier); ends with the block synchronised.
template <int kRows, int kThreads, bool kBf16, typename Tile>
__device__ __forceinline__ void kinematics(const Tile& t, int J) {
  fk_levels<kRows, kThreads, kBf16>(t, J);
  inverse_bind_rows<kRows, kThreads, kBf16>(t, J);
  __syncthreads();
}

// Set the dynamic shared-memory ceiling of a kernel when the tile needs more
// than the default 48 KB; returns the CUDA error code (0 on success).
template <typename Kernel>
inline int prepare_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace mano
