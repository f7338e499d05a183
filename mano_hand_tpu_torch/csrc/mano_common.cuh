// Device functions shared by the MANO kernels: fused_posed.cu (K2) runs
// phases A-D below; fused_forward.cu (K1, K4, K5) takes rodrigues, dot3
// and tile_row, skin.cu (K3) prepare_smem. Plain fp32 FFMA
// throughout: no tensor cores, no TF32, and the build uses no
// --use_fast_math, so sinf/cosf/sqrtf and division are the accurate IEEE
// versions. K2's bf16 tier reads a bf16 basis and bf16 weights and rounds
// its coefficients and skinning entries to bf16 (the kBf16 template flags);
// its products of two bf16 values are exact in fp32 and accumulate in fp32.
//
// One block owns a tile of kTileRows batch rows and a tile of kThreads
// vertices. It runs in four phases:
//   A  per (row, joint): Rodrigues into the row's skin slots, (R - I) into
//      the row's blend coefficients, rest joints into shared memory;
//   B  per row: forward kinematics in place along the topologically ordered
//      tree (parents[j] < j), one thread per row;
//   C  per (row, joint): inverse bind, t <- world_t - world_R @ J_rest;
//   D  per vertex (one thread each): the blend v_posed = base + coef . basis
//      for kRowChunk rows at a time in registers (blend_rows), then linear
//      blend skinning sum_j W[v, j] (R_j, t_j) applied to v_posed, written to
//      [B, V, 3] (skin_apply).
// Phases A-C (about 2 KFLOP a row) are recomputed by every vertex tile of a
// batch tile; phase D (about 1 MFLOP a row) is the work. In the bf16 tier
// (kBf16) phases A-C use separately rounded operations (__fmul_rn,
// __fadd_rn: never contracted to FMA) in the order of the plain versions
// (ops/rodrigues.py, ops/fk.py), so the rotations and skinning transforms
// equal theirs bit for bit and the bf16 roundings of them agree; the fp32
// kernels let the compiler fuse them into FMAs (the exact form made K1
// measurably slower) and agree with the plain versions to fp32 rounding.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mano {

constexpr int kThreads = 128;   // vertices per block (one per thread)
constexpr int kTileRows = 32;   // batch rows per block
constexpr int kRowChunk = 8;    // rows whose blend sums sit in registers at once
constexpr int kMaxJoints = 64;  // bounds the shared-memory tile (< 227 KB)

// Shared-memory carve of one block. coef rows are kpad floats (kpad % 4 == 0)
// so phase D reads them as float4; each skin entry is 12 floats (R row-major,
// then t) so phase D reads it as three float4.
struct Tile {
  float* coef;    // [kTileRows][kpad] blend coefficients
  float* skin;    // [kTileRows][J][12] local R, then world (R, t), then skin (R, t)
  float* jrest;   // [kTileRows][J][3] rest joints
  int* parents;   // [J]
  int* rowsrc;    // [kTileRows] table row of each tile row (gathered kernel)
};

__host__ __device__ inline size_t tile_smem_bytes(int kpad, int J) {
  return sizeof(float) * (size_t)kTileRows * (kpad + J * 12 + J * 3) +
         sizeof(int) * (size_t)(J + kTileRows);
}

__device__ inline Tile carve(float* smem, int kpad, int J) {
  Tile t;
  t.coef = smem;
  t.skin = t.coef + kTileRows * kpad;
  t.jrest = t.skin + kTileRows * J * 12;
  t.parents = reinterpret_cast<int*>(t.jrest + kTileRows * J * 3);
  t.rowsrc = t.parents + J;
  return t;
}

// A value as fp32, from fp32 or bf16 storage (read-only cache).
__device__ __forceinline__ float ldg_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_f32(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

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

// Phase A, rotations: local R of every (row, joint) into skin[r][j][0:9];
// (R - I) of joints 1.. into coef[r][koff + 9 (j - 1) + e] (the reference's
// row-major pose feature, so the basis rows need no permutation), rounded
// to bf16 when kBf16. The local R (an FK input) is never rounded.
template <bool kBf16 = false>
__device__ inline void rodrigues_rows(const float* __restrict__ pose, int B,
                               int row0, int J, const Tile& t, int kpad,
                               int koff) {
  for (int i = threadIdx.x; i < kTileRows * J; i += blockDim.x) {
    const int r = i / J, j = i - r * J;
    const float* q = pose + ((size_t)tile_row(row0, r, B) * J + j) * 3;
    float R[9];
    rodrigues<kBf16>(q[0], q[1], q[2], R);
    float* sk = t.skin + (r * J + j) * 12;
#pragma unroll
    for (int e = 0; e < 9; ++e) sk[e] = R[e];
    if (j > 0) {
      float* c = t.coef + r * kpad + koff + (j - 1) * 9;
#pragma unroll
      for (int e = 0; e < 9; ++e)
        c[e] = maybe_bf16<kBf16>(R[e] - ((e % 4 == 0) ? 1.0f : 0.0f));
    }
  }
}

// Zero the coefficient padding [k, kpad) of every tile row.
__device__ inline void zero_coef_pad(const Tile& t, int k, int kpad) {
  const int w = kpad - k;
  for (int i = threadIdx.x; i < kTileRows * w; i += blockDim.x) {
    const int r = i / w;
    t.coef[r * kpad + k + (i - r * w)] = 0.0f;
  }
}

// Phase B: forward kinematics, one thread per row, in place over skin:
// world_R[j] = world_R[p] @ R[j], world_t[j] = world_R[p] @ (J_j - J_p)
// + world_t[p]. parents is topologically ordered, so p is final before j.
// kExact: separately rounded, in the order of ops/fk.py.
template <bool kExact = false>
__device__ inline void fk_rows(const Tile& t, int J) {
  const auto add = [](float u, float v) { return mano::add<kExact>(u, v); };
  const auto sub = [](float u, float v) { return mano::sub<kExact>(u, v); };
  for (int r = threadIdx.x; r < kTileRows; r += blockDim.x) {
    float* sk = t.skin + r * J * 12;
    const float* jr = t.jrest + r * J * 3;
    sk[9] = jr[0];
    sk[10] = jr[1];
    sk[11] = jr[2];
    for (int j = 1; j < J; ++j) {
      const int p = t.parents[j];
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
          W[3 * a + b] = dot3<kExact>(P[3 * a], P[3 * a + 1], P[3 * a + 2],
                                      L[b], L[3 + b], L[6 + b]);
        W[9 + a] = add(dot3<kExact>(P[3 * a], P[3 * a + 1], P[3 * a + 2], d0,
                                    d1, d2),
                       P[9 + a]);
      }
    }
  }
}

// Phase C: inverse bind per (row, joint): t <- world_t - world_R @ J_rest.
// kBf16: computed as ops/fk.py computes it, then the slot's 12 skinning
// entries rounded to bf16 (after FK).
template <bool kBf16 = false>
__device__ inline void inverse_bind_rows(const Tile& t, int J) {
  for (int i = threadIdx.x; i < kTileRows * J; i += blockDim.x) {
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

// Phase D, blend part: v_posed of vertex v for the kRowChunk tile rows from
// r0, into acc. basis is [kpad][3][V] (loads coalesced across v). base, when
// not null, is a [C][V][3] table whose row rowsrc[r] starts the sum (the
// gathered kernel); otherwise the sum starts at 0 and the template is a
// basis row driven by a constant-1 coefficient. TB is the basis' storage
// type (float, or __nv_bfloat16 for K2's bf16 tier).
template <typename TB>
__device__ __forceinline__ void blend_rows(const Tile& t, int kpad,
                                           const TB* __restrict__ basis,
                                           const float* __restrict__ base,
                                           int V, int v, int r0,
                                           float (&acc)[kRowChunk][3]) {
#pragma unroll
  for (int i = 0; i < kRowChunk; ++i) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
      acc[i][c] = base == nullptr
                      ? 0.0f
                      : __ldg(base + ((size_t)t.rowsrc[r0 + i] * V + v) * 3 + c);
  }
  for (int k = 0; k < kpad; k += 4) {
    float bv[4][3];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        bv[kk][c] = ldg_f32(basis + ((size_t)(k + kk) * 3 + c) * V + v);
#pragma unroll
    for (int i = 0; i < kRowChunk; ++i) {
      const float4 cf =
          *reinterpret_cast<const float4*>(t.coef + (r0 + i) * kpad + k);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        acc[i][c] += cf.x * bv[0][c];
        acc[i][c] += cf.y * bv[1][c];
        acc[i][c] += cf.z * bv[2][c];
        acc[i][c] += cf.w * bv[3][c];
      }
    }
  }
}

// Phase D, skin-apply part, for one (tile row, vertex): with M = sum_j w_j R_j
// and u = sum_j w_j t_j over the row's skin slots sk [J][12], writes
// o = M p + u. weight(j) returns W[v, j]. JT > 0 unrolls the joint loop JT
// times (guarded by J) so weights held in a register array stay in
// registers; JT == 0 loops J times (K2 reads W from global).
template <int JT, typename Weight>
__device__ __forceinline__ void skin_apply(const float* __restrict__ sk, int J,
                                           const Weight& weight, float px,
                                           float py, float pz,
                                           float* __restrict__ o) {
  float m[12];
#pragma unroll
  for (int e = 0; e < 12; ++e) m[e] = 0.0f;
  const float4* s4 = reinterpret_cast<const float4*>(sk);
  auto add = [&](int j) {
    const float w = weight(j);
    const float4 s0 = s4[3 * j], s1 = s4[3 * j + 1], s2 = s4[3 * j + 2];
    m[0] += w * s0.x;  m[1] += w * s0.y;  m[2] += w * s0.z;
    m[3] += w * s0.w;  m[4] += w * s1.x;  m[5] += w * s1.y;
    m[6] += w * s1.z;  m[7] += w * s1.w;  m[8] += w * s2.x;
    m[9] += w * s2.y;  m[10] += w * s2.z; m[11] += w * s2.w;
  };
  if constexpr (JT > 0) {
#pragma unroll
    for (int j = 0; j < JT; ++j)
      if (j < J) add(j);
  } else {
    for (int j = 0; j < J; ++j) add(j);
  }
#pragma unroll
  for (int a = 0; a < 3; ++a)
    o[a] = m[3 * a] * px + m[3 * a + 1] * py + m[3 * a + 2] * pz + m[9 + a];
}

// Phase D: blend + skin for this thread's vertex over the tile's live rows,
// kRowChunk rows of v_posed at a time in registers; wt is [J][V]. TB and TW
// are the basis' and the weights' storage types (float or __nv_bfloat16).
// Must run after the block's last __syncthreads: threads past V return.
template <typename TB, typename TW>
__device__ inline void blend_skin_rows(const Tile& t, int kpad, int J,
                                const TB* __restrict__ basis,
                                const TW* __restrict__ wt,
                                const float* __restrict__ base, int V, int B,
                                int row0, float* __restrict__ out) {
  const int v = blockIdx.y * blockDim.x + threadIdx.x;
  if (v >= V) return;
  const int rows_here = min(kTileRows, B - row0);
  const auto weight = [&](int j) { return ldg_f32(wt + (size_t)j * V + v); };
  for (int r0 = 0; r0 < rows_here; r0 += kRowChunk) {
    float acc[kRowChunk][3];
    blend_rows(t, kpad, basis, base, V, v, r0, acc);
#pragma unroll
    for (int i = 0; i < kRowChunk; ++i) {
      const int r = r0 + i;
      if (r >= rows_here) break;
      skin_apply<0>(t.skin + r * J * 12, J, weight, acc[i][0], acc[i][1],
                    acc[i][2], out + ((size_t)(row0 + r) * V + v) * 3);
    }
  }
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
