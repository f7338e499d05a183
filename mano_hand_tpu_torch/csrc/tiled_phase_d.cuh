// The tiled phase D of the fp32 kernels: the blend coef [rows, kpad] x
// basis [kpad, 3V] as a register-tiled fp32-FFMA GEMM whose epilogue is
// linear blend skinning, over a row tile's coefficients and skinning
// transforms in shared memory. K1/K5 and K4 (fused_forward.cu) and f32 K2
// (fused_posed.cu) inline the one function, tiled_blend_skin, each behind
// its own front (the prelude, K4's loader of rows made outside, or K2's
// gather and prelude) and base (the sum's start: zero, or K2's gathered
// template rows).
//
//   * One front per row tile. A block owns a row tile and a span of vertex
//     sub-tiles (kVertTile vertices each) that it walks in turn, so the
//     front runs once per row tile and span, not once per 128 vertices.
//     The row tile (64 rows, or 32, 16, 8) is the largest whose shared
//     memory fits (J sets it: 8 rows at J = 64) and whose row tiles times
//     vertex sub-tiles still reach every SM, so that small batches (the
//     serving engine's, B <= 256) fill the card (with_row_tile); the span
//     (the vertex split) is then chosen per launch from B.
//   * The basis streams through a ring of kStages shared-memory stages of
//     kChunk k-rows x 3 x kVertTile floats, filled by 16-byte cp.async
//     (cp.async.cg: L2 only) while the previous chunk is multiplied, so
//     each basis element leaves L2 once per block and serves every row of
//     the tile. The operand is pre-tiled ([nsub, kpad, 3, kVertTile], V
//     zero-padded: ops/fused_forward.py:_pack, ops/fused_posed.py), so a
//     chunk is one contiguous run.
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
// Plain fp32 FFMA throughout (no tensor cores, no fast math).

#pragma once

#include <type_traits>

#include "cp_async.cuh"
#include "mano_common.cuh"

namespace mano {
namespace tiled {

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
  float* coef;   // [kRows][kpad] blend coefficients
  float* skin;   // [kRows][J][12] local R, then world (R, t), then skin (R, t)
  float* jrest;  // [kRows][J][3] rest joints
  float* wt;     // [J][kVertTile] weights of the current sub-tile
  float* stage;  // [kStages][kChunk][3][kVertTile] basis ring
  float* out;    // [warps][32 kVpt 3] a row of each warp's vertices
  int* parents;  // [J]
  int* rowsrc;   // [kRows] subject-table row of each tile row (K2 only)
  int* depth;    // [J + 1] tree depths, then the level count (tree_depths)
};

// Bytes of a block's carve.
inline size_t smem_bytes(int rows, int kpad, int J) {
  return sizeof(float) * ((size_t)rows * (kpad + J * 15) +
                          (size_t)J * kVertTile + kStages * kStageFloats +
                          kOutFloats) +
         sizeof(int) * ((size_t)2 * J + rows + 1);
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
  t.rowsrc = t.parents + J;
  t.depth = t.rowsrc + kRows;
  return t;
}

// The sum's start when the template is a basis row (K1, K4): zero.
struct ZeroBase {
  template <int kMr>
  __device__ __forceinline__ void operator()(float (&acc)[kMr][kVpt][3], int,
                                             int) const {
#pragma unroll
    for (int i = 0; i < kMr; ++i)
#pragma unroll
      for (int a = 0; a < kVpt; ++a)
#pragma unroll
        for (int c = 0; c < 3; ++c) acc[i][a][c] = 0.0f;
  }
};

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
// while the first basis chunks are in flight, and ends with the block
// synchronised. base(acc, r, v) starts the thread's sums of rows r .. r +
// kMr and vertices v .. v + kVpt of each sub-tile (v may lie past V).
template <int kRows, typename Front, typename Base = ZeroBase>
__device__ __forceinline__ void tiled_blend_skin(
    const Smem& t, const float* __restrict__ basis,
    const float* __restrict__ wt, float* __restrict__ out, int B, int V,
    int J, int kpad, int row0, int sub0, int sub1, const Front& front,
    const Base& base = Base()) {
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
        cp_async<16>(dst + i, src + i);
    }
    cp_async_commit();
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
    if (ch == 0) base(acc, g * kMr, sub * kVertTile + kVpt * p);
    cp_async_wait<kStages - 2>();   // this thread's copies of chunk q
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
  cp_async_wait<0>();
}

// Launch kernel (row tile kRows, kThreads threads, `smem` bytes) over H
// hands with `split` vertex spans per row tile (0: chosen from B and the
// card); the kernel's last argument is the span length, appended here.
template <int kRows, typename Kernel, typename... Args>
int launch(Kernel kernel, size_t smem, int H, int B, int V, int split,
           cudaStream_t stream, Args... args) {
  int err = prepare_smem(kernel, smem);
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

// f(std::integral_constant<int, rows>) for the row tile of H hands' B rows
// over V vertices: of the tiles whose shared memory (bytes(rows)) leaves
// room for kBlocksPerSm blocks an SM, the largest whose row tiles times
// vertex sub-tiles reach every SM, else the smallest. Large batches take
// 64-row tiles; a small one takes fewer rows a tile and more blocks (and
// computes fewer replayed rows), which launch's vertex split alone cannot
// give it: a 64-row tile has at most 7 sub-tiles at V = 778.
template <typename Bytes, typename F>
int with_row_tile(int B, int H, int V, const Bytes& bytes, const F& f) {
  int dev = 0, sms = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err == 0)
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (err != 0) return err;
  const long subs = (long)H * ((V + kVertTile - 1) / kVertTile);
  constexpr int kR0 = kGroups * 8, kR1 = kGroups * 4, kR2 = kGroups * 2,
                kR3 = kGroups;
  const int rows[4] = {kR0, kR1, kR2, kR3};
  int pick = 3;
  for (int i = 0; i < 4; ++i) {
    if (bytes(rows[i]) > kSmemBudget) continue;
    pick = i;
    if ((B + rows[i] - 1) / rows[i] * subs >= sms) break;
  }
  switch (pick) {
    case 0: return f(std::integral_constant<int, kR0>{});
    case 1: return f(std::integral_constant<int, kR1>{});
    case 2: return f(std::integral_constant<int, kR2>{});
    default: return f(std::integral_constant<int, kR3>{});
  }
}

}  // namespace tiled
}  // namespace mano
