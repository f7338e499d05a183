// K1 and K5: the whole batched MANO forward in one launch, (pose, shape) ->
// verts, for one hand (K1) or several hands at once (K5); and K4, blend +
// skin from per-row coefficients and skinning transforms made outside.
//
// Replaces the TPU kernels mano_hand_tpu/ops/pallas_forward.py:
// forward_verts_fused_full (its pallas_call at :723),
// forward_verts_fused_full_hands (its pallas_call at :830) and
// blend_skin_fused (its pallas_calls at :228 and :239). The TPU pair
// mirrors its launch code line for line; here they are one kernel with a
// hand axis: blockIdx.z picks the hand, whose operands (basis, weights,
// joint basis, pose, shape, out) sit at a per-hand stride; the kinematic
// tree is shared. K1 is the H = 1 launch, K5 the H = 2 launch.
//
// What bounds it on an H100: fp32 operations. Per row the blend is
// 2 K 3V FLOP (K = S + 1 + 9 (J - 1) = 146 for MANO, about 0.68 MFLOP) and
// the skinning 2 (12 J + 12) V (about 0.32 MFLOP), against 12 V bytes
// written (9.3 KB) and 232 bytes read: some 100 FLOP a byte, far above the
// card's fp32 ridge (about 20). Every intermediate (rotations, world
// transforms, the coefficients, v_posed) stays on chip.
//
// The design. The blend is a product, coef [rows, kpad] x basis
// [kpad, 3V], whose epilogue is the skin; it runs as a tiled fp32-FFMA GEMM.
//   * One prelude per row tile. A block owns a row tile and a span of
//     vertex sub-tiles (kVertTile vertices each) that it walks in turn, so
//     Rodrigues, the shaped joints, FK and the inverse bind run once per
//     row tile and span, not once per 128 vertices. The span (the vertex
//     split) is chosen per launch from B so that small batches still reach
//     every SM; the row tile (64 rows, or 32, 16, 8) is the largest whose
//     shared memory fits (J sets it: 8 rows at J = 64), or a smaller one
//     a small batch still fills.
//   * The basis streams through a ring of kStages shared-memory stages of
//     kChunk k-rows x 3 x kVertTile floats, filled by 16-byte cp.async
//     (cp.async.cg: L2 only) while the previous chunk is multiplied, so
//     each basis element leaves L2 once per block and serves every row of
//     the tile. The operand is pre-tiled by ops/fused_forward.py:_pack
//     ([nsub, kpad, 3, kVertTile], V zero-padded), so a chunk is one
//     contiguous run.
//   * A register micro-tile: each thread accumulates 8 rows (fewer for a
//     small row tile) x kVpt = 4 adjacent vertices x 3 coordinates, 96
//     accumulators at 255 registers and one block an SM. Per 4 k-rows it
//     reads each row's coefficients as a float4 broadcast and the basis as
//     float4 (a warp reads 512 contiguous bytes: no bank conflict).
//   * The skin is the epilogue, in registers: per (row, vertex)
//     M = sum_j w_j (R_j, t_j) from the row's transforms in shared memory
//     (float4 broadcasts) and the sub-tile's weights, staged once per
//     sub-tile; v_posed never leaves registers. Each warp stages a row's
//     output through shared memory and stores it as 128-byte runs.
// Plain fp32 FFMA throughout (no tensor cores, no fast math); the prelude
// is the fp32 (FMA) form of mano_common.cuh's phases A-C.
//
// K4 is the same phase D (tiled_blend_skin, one function both kernels
// inline) behind a loader in place of the prelude: the block copies its
// rows' coefficients [beta | 1 | R - I | 0] and skinning transforms (R, t),
// made by the PyTorch pre-stage (ops/fused_forward.py:pre_stage, as
// pallas_forward.py:_pre_stage makes them), into the slots the prelude
// fills. Its row tile and vertex split are chosen as K1's.
//
// What was measured (scripts/time_fused_forward.py, NVIDIA H100 80GB HBM3
// at 700 W): about 0.31-0.33 ms for B = 8192, against the parent design's
// 0.57-0.60 and a bound of 0.122; variants without the basis copies or
// without the per-chunk barrier were only 3-6 % faster, and micro-tiles of
// 8 x 2 and 8 x 4 vertices, 32 or 64 rows, 1 or 2 blocks an SM all land
// within about 10 % of each other (PERF.md section 5).

#include <type_traits>

#include "cp_async.cuh"
#include "mano_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 1;  // the occupancy the register budget is cut for
constexpr int kVertTile = 128;   // ops/fused_forward.py VERT_TILE
constexpr int kVpt = 4;          // adjacent vertices of a thread
constexpr int kLanesV = kVertTile / kVpt;    // threads along a sub-tile
constexpr int kGroups = kThreads / kLanesV;  // row groups of a block
constexpr int kChunk = 32;                   // k-rows of one basis stage
constexpr int kStages = 2;
constexpr int kStageFloats = kChunk * 3 * kVertTile;
constexpr int kOutFloats = kThreads * kVpt * 3;  // one row of every thread
static_assert(kVpt == 4 && kLanesV % 32 == 0, "a warp holds one row group");
// Shared memory of one block at kBlocksPerSm blocks an SM: 228 KB less
// 1 KB reserved per block.
constexpr size_t kSmemBudget = (228 * 1024) / kBlocksPerSm - 1024;

// 4 contiguous floats of shared memory (16 bytes aligned) into x.
__device__ __forceinline__ void load_vec(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}

// Shared-memory carve of one block (every part a multiple of 4 floats).
struct Smem {
  float* coef;   // [kRows][kpad] blend coefficients [beta | 1 | R - I | 0]
  float* skin;   // [kRows][J][12] local R, then world (R, t), then skin (R, t)
  float* jrest;  // [kRows][J][3] rest joints
  float* wt;     // [J][kVertTile] weights of the current sub-tile
  float* stage;  // [kStages][kChunk][3][kVertTile] basis ring
  float* out;    // [warps][32 kVpt 3] a row of each warp's vertices
  int* parents;  // [J]
};

inline size_t smem_bytes(int rows, int kpad, int J) {
  return sizeof(float) * ((size_t)rows * (kpad + J * 15) +
                          (size_t)J * kVertTile + kStages * kStageFloats +
                          kOutFloats) +
         sizeof(int) * (size_t)J;
}

template <int kRows>
__device__ inline Smem carve(float* smem, int kpad, int J) {
  Smem t;
  t.coef = smem;
  t.skin = t.coef + kRows * kpad;
  t.jrest = t.skin + kRows * J * 12;
  t.wt = t.jrest + kRows * J * 3;
  t.stage = t.wt + J * kVertTile;
  t.out = t.stage + kStages * kStageFloats;
  t.parents = reinterpret_cast<int*>(t.out + kOutFloats);
  return t;
}

// Phases A-C for the tile's rows (mano_common.cuh's rodrigues_rows,
// fk_rows and inverse_bind_rows in their fp32 form, for kRows rows).
// Ends with the block synchronised.
template <int kRows>
__device__ void prelude(const float* __restrict__ pose,
                        const float* __restrict__ shape,
                        const float* __restrict__ jb,
                        const int* __restrict__ parents, int B, int row0,
                        int J, int S, int kpad, const Smem& t) {
  const int k = S + 1 + 9 * (J - 1);
  for (int i = threadIdx.x; i < J; i += kThreads) t.parents[i] = parents[i];
  // [beta | 1] and the zero padding; the 1 drives the template row.
  for (int i = threadIdx.x; i < kRows * kpad; i += kThreads) {
    const int r = i / kpad, c = i - r * kpad;
    if (c < S)
      t.coef[i] = shape[(size_t)mano::tile_row(row0, r, B) * S + c];
    else if (c == S)
      t.coef[i] = 1.0f;
    else if (c >= k)
      t.coef[i] = 0.0f;
  }
  // A: local R into the skin slots, (R - I) of joints 1.. into coef.
  for (int i = threadIdx.x; i < kRows * J; i += kThreads) {
    const int r = i / J, j = i - r * J;
    const float* q = pose + ((size_t)mano::tile_row(row0, r, B) * J + j) * 3;
    float R[9];
    mano::rodrigues<false>(q[0], q[1], q[2], R);
    float* sk = t.skin + i * 12;
#pragma unroll
    for (int e = 0; e < 9; ++e) sk[e] = R[e];
    if (j > 0) {
      float* c = t.coef + r * kpad + S + 1 + (j - 1) * 9;
#pragma unroll
      for (int e = 0; e < 9; ++e) c[e] = R[e] - ((e % 4 == 0) ? 1.0f : 0.0f);
    }
  }
  // Shaped rest joints: J_rest[j][c] = jb[j][c][S] + sum_s jb[j][c][s] beta_s.
  for (int i = threadIdx.x; i < kRows * J * 3; i += kThreads) {
    const int r = i / (J * 3), jc = i - r * J * 3;
    const float* g = jb + (size_t)jc * (S + 1);
    const float* beta = shape + (size_t)mano::tile_row(row0, r, B) * S;
    float acc = 0.0f;
    for (int s = 0; s < S; ++s) acc += g[s] * beta[s];
    t.jrest[i] = acc + g[S];
  }
  __syncthreads();
  // B: forward kinematics, one thread per row, in place over the slots.
  for (int r = threadIdx.x; r < kRows; r += kThreads) {
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
      const float d0 = jr[3 * j] - jr[3 * p];
      const float d1 = jr[3 * j + 1] - jr[3 * p + 1];
      const float d2 = jr[3 * j + 2] - jr[3 * p + 2];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
#pragma unroll
        for (int b = 0; b < 3; ++b)
          W[3 * a + b] = mano::dot3<false>(P[3 * a], P[3 * a + 1],
                                           P[3 * a + 2], L[b], L[3 + b],
                                           L[6 + b]);
        W[9 + a] = mano::dot3<false>(P[3 * a], P[3 * a + 1], P[3 * a + 2],
                                     d0, d1, d2) +
                   P[9 + a];
      }
    }
  }
  __syncthreads();
  // C: inverse bind, t <- world_t - world_R @ J_rest.
  for (int i = threadIdx.x; i < kRows * J; i += kThreads) {
    float* sk = t.skin + i * 12;
    const float* jr = t.jrest + i * 3;
    float u[3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
      u[a] = sk[9 + a] - mano::dot3<false>(sk[3 * a], sk[3 * a + 1],
                                           sk[3 * a + 2], jr[0], jr[1], jr[2]);
#pragma unroll
    for (int a = 0; a < 3; ++a) sk[9 + a] = u[a];
  }
  __syncthreads();
}

// The blend over 4 k-rows: acc[i][a][c] += sum_kk coef[i][kk] basis[kk][c][a]
// for the thread's kMr rows (coef rows kpad apart) and kVpt vertices (bs:
// the stage at the thread's first vertex). Operands are loaded first, and
// each accumulator's 4 updates are kMr kVpt 3 FFMAs apart.
template <int kMr>
__device__ __forceinline__ void blend4(const float* bs, const float* coef,
                                       int kpad,
                                       float (&acc)[kMr][kVpt][3]) {
  float b[4][3][kVpt];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      load_vec(bs + (kk * 3 + c) * kVertTile, b[kk][c]);
  float4 cf[kMr];
#pragma unroll
  for (int i = 0; i < kMr; ++i)
    cf[i] = *reinterpret_cast<const float4*>(coef + i * kpad);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < kMr; ++i) {
      const float x = kk == 0 ? cf[i].x
                    : kk == 1 ? cf[i].y
                    : kk == 2 ? cf[i].z
                              : cf[i].w;
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int a = 0; a < kVpt; ++a)
          acc[i][a][c] = fmaf(x, b[kk][c][a], acc[i][a][c]);
    }
}

// Phase D of the block's row tile over vertex sub-tiles [sub0, sub1) of
// one hand's tiled operands (basis [nsub, kpad, 3, VT], wt [nsub, J, VT]),
// into out [B, V, 3]. front() fills t.coef and t.skin of the tile's rows
// (the prelude, or K4's loader) while the first basis chunks are in flight,
// and ends with the block synchronised.
template <int kRows, typename Front>
__device__ __forceinline__ void tiled_blend_skin(
    const Smem& t, const float* __restrict__ basis,
    const float* __restrict__ wt, float* __restrict__ out, int B, int V,
    int J, int kpad, int row0, int sub0, int sub1, const Front& front) {
  constexpr int kMr = kRows / kGroups;  // rows of a thread's micro-tile
  // The basis stream: chunk q is k-rows [kChunk (q % nchunk), +kChunk) of
  // sub-tile sub0 + q / nchunk (the last chunk of a sub-tile may be short:
  // kpad is a multiple of 4), into stage q % kStages. Every call commits
  // one group (empty past the end) so wait_group counts chunks.
  const int nchunk = (kpad + kChunk - 1) / kChunk;
  const int total = (sub1 - sub0) * nchunk;
  const auto fetch = [&](int q) {
    if (q < total) {
      const int sub = sub0 + q / nchunk, k0 = (q % nchunk) * kChunk;
      const float4* src = reinterpret_cast<const float4*>(
          basis + ((size_t)sub * kpad + k0) * 3 * kVertTile);
      float4* dst =
          reinterpret_cast<float4*>(t.stage + (q % kStages) * kStageFloats);
      const int n = min(kChunk, kpad - k0) * 3 * kVertTile / 4;
      for (int i = threadIdx.x; i < n; i += kThreads)
        mano::cp_async<16>(dst + i, src + i);
    }
    mano::cp_async_commit();
  };
  for (int q = 0; q < kStages - 1; ++q) fetch(q);   // overlaps the front
  front();

  // Thread (g, p): rows g kMr .. + kMr of the tile, vertices kVpt p ..
  // + kVpt of the sub-tile. A warp's lanes share g.
  const int g = threadIdx.x / kLanesV, p = threadIdx.x - g * kLanesV;
  const int lane = threadIdx.x & 31;
  const int rows_here = min(kRows, B - row0);
  const float* coef = t.coef + g * kMr * kpad;
  float acc[kMr][kVpt][3];
  for (int q = 0; q < total; ++q) {
    const int ch = q % nchunk;
    const int sub = sub0 + q / nchunk;
    // The warp's first vertex; a warp wholly past V skips the arithmetic.
    const int vw = sub * kVertTile + kVpt * (p - lane % kLanesV);
    const bool live = vw < V;
    if (ch == 0) {
#pragma unroll
      for (int i = 0; i < kMr; ++i)
#pragma unroll
        for (int a = 0; a < kVpt; ++a)
#pragma unroll
          for (int c = 0; c < 3; ++c) acc[i][a][c] = 0.0f;
    }
    mano::cp_async_wait<kStages - 2>();   // this thread's copies of chunk q
    __syncthreads();                // everyone's; stage (q - 1) is free
    fetch(q + kStages - 1);
    if (live) {
      const float* bs = t.stage + (q % kStages) * kStageFloats + kVpt * p;
      const float* cf = coef + ch * kChunk;
      const int nk = min(kChunk, kpad - ch * kChunk);   // a multiple of 4
      if (nk == kChunk) {
#pragma unroll
        for (int u = 0; u < kChunk / 4; ++u)
          blend4(bs + 4 * u * 3 * kVertTile, cf + 4 * u, kpad, acc);
      } else {
        for (int u = 0; u < nk / 4; ++u)
          blend4(bs + 4 * u * 3 * kVertTile, cf + 4 * u, kpad, acc);
      }
    }
    if (ch != nchunk - 1) continue;

    // Epilogue of the sub-tile: stage its weights (the last reader of the
    // buffer, the previous epilogue, passed a barrier since), then skin.
    {
      const float4* src = reinterpret_cast<const float4*>(
          wt + (size_t)sub * J * kVertTile);
      float4* dst = reinterpret_cast<float4*>(t.wt);
      for (int i = threadIdx.x; i < J * kVertTile / 4; i += kThreads)
        dst[i] = __ldg(src + i);
    }
    __syncthreads();
    if (!live) continue;
#pragma unroll
    for (int i = 0; i < kMr; ++i) {
      const int r = g * kMr + i;
      if (r >= rows_here) break;
      float m[kVpt][12];
#pragma unroll
      for (int a = 0; a < kVpt; ++a)
#pragma unroll
        for (int e = 0; e < 12; ++e) m[a][e] = 0.0f;
      const float4* s4 = reinterpret_cast<const float4*>(t.skin + r * J * 12);
      for (int j = 0; j < J; ++j) {
        float w[kVpt];
        load_vec(t.wt + j * kVertTile + kVpt * p, w);
        const float4 s[3] = {s4[3 * j], s4[3 * j + 1], s4[3 * j + 2]};
#pragma unroll
        for (int a = 0; a < kVpt; ++a)
#pragma unroll
          for (int e = 0; e < 3; ++e) {
            m[a][4 * e] += w[a] * s[e].x;
            m[a][4 * e + 1] += w[a] * s[e].y;
            m[a][4 * e + 2] += w[a] * s[e].z;
            m[a][4 * e + 3] += w[a] * s[e].w;
          }
      }
      float o[kVpt][3];
#pragma unroll
      for (int a = 0; a < kVpt; ++a)
#pragma unroll
        for (int c = 0; c < 3; ++c)
          o[a][c] = m[a][3 * c] * acc[i][a][0] +
                    m[a][3 * c + 1] * acc[i][a][1] +
                    m[a][3 * c + 2] * acc[i][a][2] + m[a][9 + c];
      // The warp's 32 kVpt vertices of row r are contiguous floats of out:
      // stage them, then store them as 128-byte runs.
      constexpr int kWarpFloats = 32 * kVpt * 3;
      float* buf = t.out + (threadIdx.x >> 5) * kWarpFloats;
#pragma unroll
      for (int a = 0; a < kVpt; ++a)
#pragma unroll
        for (int c = 0; c < 3; ++c) buf[lane * kVpt * 3 + a * 3 + c] = o[a][c];
      __syncwarp();
      const int n = min(32 * kVpt, V - vw) * 3;
      float* dst = out + ((size_t)(row0 + r) * V + vw) * 3;
#pragma unroll
      for (int e = 0; e < kVpt * 3; ++e)
        if (lane + 32 * e < n) dst[lane + 32 * e] = buf[lane + 32 * e];
      __syncwarp();
    }
  }
  mano::cp_async_wait<0>();
}

template <int kRows>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
fused_forward_kernel(const float* __restrict__ pose,   // [H, B, J, 3]
                     const float* __restrict__ shape,  // [H, B, S]
                     const float* __restrict__ basis,  // [H, nsub, kpad, 3, VT]
                     const float* __restrict__ wt,     // [H, nsub, J, VT]
                     const float* __restrict__ jb,     // [H, J, 3, S + 1]
                     const int* __restrict__ parents,  // [J] (shared)
                     float* __restrict__ out,          // [H, B, V, 3]
                     int B, int V, int J, int S, int kpad, int per) {
  extern __shared__ float4 smem4[];
  const Smem t = carve<kRows>(reinterpret_cast<float*>(smem4), kpad, J);
  const int row0 = blockIdx.x * kRows;
  const int nsub = (V + kVertTile - 1) / kVertTile;
  const int sub0 = blockIdx.y * per;
  const int sub1 = min(nsub, sub0 + per);
  const size_t h = blockIdx.z;
  pose += h * B * J * 3;
  shape += h * B * S;
  basis += h * nsub * kpad * 3 * kVertTile;
  wt += h * nsub * J * kVertTile;
  jb += h * J * 3 * (S + 1);
  out += h * B * V * 3;
  tiled_blend_skin<kRows>(t, basis, wt, out, B, V, J, kpad, row0, sub0, sub1,
                          [&] {
                            prelude<kRows>(pose, shape, jb, parents, B, row0,
                                           J, S, kpad, t);
                          });
}

// K4's front: the tile's coefficient rows (float4: kpad % 4 == 0, coef
// 16-byte aligned) and skin slots (R row-major, then t) from memory, one
// row a warp; rows past the batch end replay the last row, as the prelude's
// do. Ends with the block synchronised.
template <int kRows>
__device__ void load_rows(const float* __restrict__ coef,
                          const float* __restrict__ rot,
                          const float* __restrict__ tr, int B, int row0,
                          int J, int kpad, const Smem& t) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kRows; r += kThreads / 32) {
    const size_t src = mano::tile_row(row0, r, B);
    const float4* c4 = reinterpret_cast<const float4*>(coef + src * kpad);
    float4* d4 = reinterpret_cast<float4*>(t.coef + r * kpad);
    for (int e = lane; e < kpad / 4; e += 32) d4[e] = __ldg(c4 + e);
    const float* R = rot + src * J * 9;
    const float* T = tr + src * J * 3;
    float* sk = t.skin + r * J * 12;
    for (int e = lane; e < J * 9; e += 32) {
      const int j = e / 9;
      sk[j * 12 + (e - 9 * j)] = __ldg(R + e);
    }
    for (int e = lane; e < J * 3; e += 32) {
      const int j = e / 3;
      sk[j * 12 + 9 + (e - 3 * j)] = __ldg(T + e);
    }
  }
  __syncthreads();
}

template <int kRows>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
blend_skin_kernel(const float* __restrict__ coef,   // [B, kpad]
                  const float* __restrict__ rot,    // [B, J, 3, 3]
                  const float* __restrict__ tr,     // [B, J, 3]
                  const float* __restrict__ basis,  // [nsub, kpad, 3, VT]
                  const float* __restrict__ wt,     // [nsub, J, VT]
                  float* __restrict__ out,          // [B, V, 3]
                  int B, int V, int J, int kpad, int per) {
  extern __shared__ float4 smem4[];
  const Smem t = carve<kRows>(reinterpret_cast<float*>(smem4), kpad, J);
  const int row0 = blockIdx.x * kRows;
  const int nsub = (V + kVertTile - 1) / kVertTile;
  const int sub0 = blockIdx.y * per;
  tiled_blend_skin<kRows>(
      t, basis, wt, out, B, V, J, kpad, row0, sub0, min(nsub, sub0 + per),
      [&] { load_rows<kRows>(coef, rot, tr, B, row0, J, kpad, t); });
}

// Launch kernel (K1/K5's or K4's at row tile kRows) over H hands with
// `split` vertex spans per row tile (0: chosen from B and the card); the
// kernel's last argument is the span length, appended here.
template <int kRows, typename Kernel, typename... Args>
int launch(Kernel kernel, int H, int B, int V, int J, int kpad, int split,
           cudaStream_t stream, Args... args) {
  const size_t smem = smem_bytes(kRows, kpad, J);
  int err = mano::prepare_smem(kernel, smem);
  if (err != 0) return err;
  const int nsub = (V + kVertTile - 1) / kVertTile;
  const int tiles = (B + kRows - 1) / kRows;
  if (split <= 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = (int)cudaGetDevice(&dev)) != 0) return err;
    if ((err = (int)cudaDeviceGetAttribute(
             &sms, cudaDevAttrMultiProcessorCount, dev)) != 0)
      return err;
    if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, kThreads, smem)) != 0)
      return err;
    // As many vertex spans as keep every block slot of the card busy,
    // without a second partial wave.
    const long slots = (long)sms * (per_sm > 0 ? per_sm : 1);
    split = (int)(slots / ((long)tiles * H));
  }
  split = split < 1 ? 1 : (split > nsub ? nsub : split);
  const int per = (nsub + split - 1) / split;
  split = (nsub + per - 1) / per;
  kernel<<<dim3(tiles, split, H), kThreads, smem, stream>>>(args..., per);
  return (int)cudaGetLastError();
}

// f(std::integral_constant<int, rows>) for the row tile: the largest whose
// shared memory leaves room for kBlocksPerSm blocks an SM, or a smaller one
// that the batch still fills (a small batch then computes fewer replayed
// rows).
template <typename F>
int with_row_tile(int B, int kpad, int J, const F& f) {
  constexpr int kR0 = kGroups * 8, kR1 = kGroups * 4, kR2 = kGroups * 2,
                kR3 = kGroups;
  const int rows[4] = {kR0, kR1, kR2, kR3};
  int pick = -1;
  for (int i = 0; i < 4; ++i)
    if (smem_bytes(rows[i], kpad, J) <= kSmemBudget &&
        (pick < 0 || B <= rows[i]))
      pick = i;
  switch (pick) {
    case 0: return f(std::integral_constant<int, kR0>{});
    case 1: return f(std::integral_constant<int, kR1>{});
    case 2: return f(std::integral_constant<int, kR2>{});
    default: return f(std::integral_constant<int, kR3>{});
  }
}

}  // namespace

// H hands: operands stacked on a leading hand axis (H = 1: K1, H > 1: K5).
// basis and wt are the vertex-tiled operands of ops/fused_forward.py:_pack.
// split: vertex sub-tile spans per row tile (0: chosen from B and the card).
extern "C" int mano_fused_forward(const void* pose, const void* shape,
                                  const void* basis, const void* wt,
                                  const void* jb, const void* parents,
                                  void* out, int H, int B, int V, int J,
                                  int S, int kpad, int split, void* stream) {
  return with_row_tile(B, kpad, J, [&](auto rows) {
    constexpr int kRows = decltype(rows)::value;
    return launch<kRows>(
        fused_forward_kernel<kRows>, H, B, V, J, kpad, split,
        static_cast<cudaStream_t>(stream), static_cast<const float*>(pose),
        static_cast<const float*>(shape), static_cast<const float*>(basis),
        static_cast<const float*>(wt), static_cast<const float*>(jb),
        static_cast<const int*>(parents), static_cast<float*>(out), B, V, J,
        S, kpad);
  });
}

// K4: coef [B, kpad] (16-byte aligned), rot [B, J, 3, 3], t [B, J, 3]; basis
// and wt the vertex-tiled operands; the vertex split as K1's automatic one.
extern "C" int mano_blend_skin(const void* coef, const void* rot,
                               const void* t, const void* basis,
                               const void* wt, void* out, int B, int V, int J,
                               int kpad, void* stream) {
  return with_row_tile(B, kpad, J, [&](auto rows) {
    constexpr int kRows = decltype(rows)::value;
    return launch<kRows>(
        blend_skin_kernel<kRows>, 1, B, V, J, kpad, 0,
        static_cast<cudaStream_t>(stream), static_cast<const float*>(coef),
        static_cast<const float*>(rot), static_cast<const float*>(t),
        static_cast<const float*>(basis), static_cast<const float*>(wt),
        static_cast<float*>(out), B, V, J, kpad);
  });
}

extern "C" const char* mano_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
