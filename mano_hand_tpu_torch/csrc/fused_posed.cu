// K2: the gathered pose-only serving forward in one launch,
// (subject table, idx, pose) -> verts, in fp32 and in the bf16 serving tier.
//
// Replaces the TPU kernel mano_hand_tpu/ops/pallas_posed.py:
// forward_posed_gather_fused (its pallas_call at :382; the bf16 tier is its
// compute_dtype=bf16 mode, :297-305).
//
// Row r runs the pose stage over subject idx[r]'s baked constants: its
// shaped template v_shaped[idx[r]] starts the blend sum and its rest joints
// joints[idx[r]] feed FK — both direct indexed loads (the TPU kernel's
// one-hot MXU gather and its 512-row VMEM capacity gate have no counterpart:
// any capacity serves). A negative index i selects row i + C, then every
// index is clamped to [0, C - 1]: the semantics of core.forward_posed_gather
// (the JAX package's XLA gather). The table is the engine's, updated a row
// at a time and never repacked; at V = 778 an odd row of v_shaped is only
// 8-byte aligned, so it is read by scalar loads.
//
// What bounds it on an H100. fp32: operations — per row the pose blend is
// 2 P 3V FLOP (P = 9 (J - 1) = 135 for MANO) plus 2 (12 J + 12) V for
// skinning, about 0.95 MFLOP, against 9.3 KB of gathered template read and
// 9.3 KB of verts written. bf16: bytes — the same contractions on the
// tensor cores take a few microseconds at B = 1024, leaving the gather and
// the write (about 19 MB), the prelude and the per-vertex apply.
//
// fp32 (posed_kernel): the tiled phase D of K1/K4 (tiled_phase_d.cuh), one
// function in both sources, behind K2's front — the gather of each tile
// row's subject index (rowsrc) and rest joints, then phases A-C of
// mano_common.cuh in their fp32 form, once per row tile and span — with
// the gathered template rows as the sums' start (GatheredBase). The pose
// basis and the weights are the vertex-tiled operands of
// ops/fused_posed.py ([nsub, Ppad, 3, 128], [nsub, J, 128]).
//
// bf16 (posed_bf16_kernel): the same front with the bf16 tier's exact
// prelude (kExact: the plain versions' rounding order), (R - I) and the
// 12 skinning entries rounded to bf16, and both contractions on bf16
// mma.sync.m16n8k16 with fp32 accumulators:
//   * Blend, transposed: v_posed^T [3 x 128 columns, rows] = basis^T
//     [columns, Ppad] x coef^T [Ppad, rows], P padded to Ppad = 144 with
//     zero coefficients and zero basis rows. Warp w owns vertices 16 w ..
//     16 w + 15 of the sub-tile in each of the 3 coordinate planes (three
//     16-column A tiles) and every row of the tile (kRows / 8 n-tiles):
//     up to 96 accumulators, which start at the gathered fp32 template
//     (the first mma's C operand). The basis ([nsub, Ppad, 3, 128] bf16)
//     streams through a 2-stage cp.async ring of kChunkB k-rows, each
//     staged k-row padded by 16 bytes (784 bytes: eight ldmatrix rows at
//     one column fall in eight bank groups); A fragments come in through
//     ldmatrix.trans, the coefficients' B fragments ([rows][Ppad + 8]
//     bf16, also conflict-free) through ldmatrix.
//   * Skin, per 8-row n-tile: M_e [16 vertices, 8 rows] = W [16, Jpad] x
//     S_e [Jpad, 8] for each of the 12 entries e (R row-major, then t):
//     12 mmas a 16-joint step. W's A fragments come straight from the
//     [nsub, 128, Jpad] bf16 weights into registers once per sub-tile;
//     S_e is staged once per tile as [12][rows][Jpad + 8] bf16. Because
//     the blend is transposed, M_e's accumulator layout (vertex = lane / 4
//     (+8), row = 2 (lane % 4) (+1)) is v_posed's: the per-vertex 3 x 3
//     apply needs no shuffle. Only the output passes through shared memory:
//     each warp stages an n-tile's rows and stores them as contiguous runs.
// Against the fp32 form the error is bounded by the stated 2e-3 m envelope
// of serving/precision.py.
//
// Both fronts run FK level by level (mano_common.cuh:fk_levels), as K1's
// prelude does, and take the row tile of tiled_phase_d.cuh:with_row_tile,
// the largest that still fills the SMs, so the engine's batches (B <= 256)
// reach the whole card. What was measured (scripts/time_fused_forward.py,
// NVIDIA H100 80GB HBM3 at 700 W, B = 1024 from C = 1000, this design and
// the parent design, one vertex a thread with the prelude per 128
// vertices, in one run; device time by CUDA-graph replay, back-to-back
// calls in brackets): fp32 0.051 (0.059-0.087) ms and bf16 0.033
// (0.054-0.056) against 0.109 (0.119-0.120) and 0.112-0.113
// (0.121-0.123). In an earlier run FK one thread a row cost 0.020 ms of
// device time, K1's former row tile half the time at B = 256, and the
// front alone took 0.011 (fp32) and 0.015 (bf16); a swizzled ring in
// place of the padded one and the bf16 skin on FFMA in place of the mmas
// (0.104 ms) were no faster (PERF.md section 5).

#include <cstdint>

#include "tiled_phase_d.cuh"

namespace {

using namespace mano::tiled;

// The table row of subject index i: i + C for a negative i, then clamped
// to [0, C - 1] (core.forward_posed_gather's semantics).
__device__ __forceinline__ int subject_row(int i, int C) {
  return min(max(i < 0 ? i + C : i, 0), C - 1);
}

// K2's front, by kThreads threads: the tree and its depths, each tile
// row's table row, the coefficients' zero padding [9 (J - 1), cstride),
// phase A, the gathered rest joints, phases B (level by level) and C
// (kBf16: the bf16 tier's exact rounding order and roundings). Ends with
// the block synchronised.
template <int kRows, bool kBf16, typename Tile>
__device__ void gather_front(const float* __restrict__ joints,
                             const int* __restrict__ idx,
                             const float* __restrict__ pose,
                             const int* __restrict__ parents, int B, int C,
                             int row0, int J, int cstride, const Tile& t) {
  for (int i = threadIdx.x; i < J; i += kThreads) t.parents[i] = parents[i];
  for (int r = threadIdx.x; r < kRows; r += kThreads)
    t.rowsrc[r] = subject_row(__ldg(idx + mano::tile_row(row0, r, B)), C);
  const int k = 9 * (J - 1), w = cstride - k;
  for (int i = threadIdx.x; i < kRows * w; i += kThreads) {
    const int r = i / w;
    mano::store_coef(t.coef + r * cstride + k + (i - r * w), 0.0f);
  }
  mano::rodrigues_rows<kRows, kThreads, kBf16>(pose, B, row0, J, cstride, 0,
                                               t);
  __syncthreads();  // rowsrc and parents are read below
  if (threadIdx.x == 0) mano::tree_depths(t.parents, J, t.depth);
  for (int i = threadIdx.x; i < kRows * J * 3; i += kThreads) {
    const int r = i / (J * 3), jc = i - r * J * 3;
    t.jrest[i] = __ldg(joints + (size_t)t.rowsrc[r] * J * 3 + jc);
  }
  mano::kinematics<kRows, kThreads, kBf16>(t, J);
}

// ------------------------------------------------------------------ fp32 K2

// The sums' start: the gathered template rows, v_shaped[rowsrc[r]][v][c]
// (scalar loads: a table row may be only 8-byte aligned), 0 past V.
struct GatheredBase {
  const float* v_shaped;   // [C, V, 3]
  const int* rowsrc;       // [kRows], shared memory
  int V;
  template <int kMr>
  __device__ __forceinline__ void operator()(float (&acc)[kMr][kVpt][3],
                                             int r, int v) const {
    const int n = max(0, min(kVpt, V - v)) * 3;
#pragma unroll
    for (int i = 0; i < kMr; ++i) {
      const float* src = v_shaped + ((size_t)rowsrc[r + i] * V + v) * 3;
#pragma unroll
      for (int a = 0; a < kVpt; ++a)
#pragma unroll
        for (int c = 0; c < 3; ++c)
          acc[i][a][c] = 3 * a + c < n ? __ldg(src + 3 * a + c) : 0.0f;
    }
  }
};

template <int kRows>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
posed_kernel(const float* __restrict__ v_shaped,  // [C, V, 3]
             const float* __restrict__ joints,    // [C, J, 3]
             const int* __restrict__ idx,         // [B]
             const float* __restrict__ pose,      // [B, J, 3]
             const float* __restrict__ basis,     // [nsub, kpad, 3, VT]
             const float* __restrict__ wt,        // [nsub, J, VT]
             const int* __restrict__ parents,     // [J]
             float* __restrict__ out,             // [B, V, 3]
             int B, int C, int V, int J, int kpad, int per) {
  extern __shared__ float4 smem4[];
  const Smem t = carve<kRows>(reinterpret_cast<float*>(smem4), kpad, J);
  const int row0 = blockIdx.x * kRows;
  const int nsub = (V + kVertTile - 1) / kVertTile;
  const int sub0 = blockIdx.y * per;
  tiled_blend_skin<kRows>(
      t, basis, wt, out, B, V, J, kpad, row0, sub0, min(nsub, sub0 + per),
      [&] {
        gather_front<kRows, false>(joints, idx, pose, parents, B, C, row0, J,
                                   kpad, t);
      },
      GatheredBase{v_shaped, t.rowsrc, V});
}

// ------------------------------------------------------------------ bf16 K2

constexpr int kChunkB = 48;                  // k-rows of one basis stage
constexpr int kRowB = 3 * kVertTile + 8;     // bf16 of a staged k-row (784 B)
constexpr int kStageB = kChunkB * kRowB;     // bf16 of one stage
constexpr int kWarps = kThreads / 32;
constexpr int kVw = kVertTile / kWarps;      // vertices of a warp: 16
constexpr int kOutRow = 52;                  // floats of a staged output row
static_assert(kVw == 16, "a warp owns one 16-vertex mma tile");

// Shared-memory carve of the bf16 kernel (every part a multiple of 16
// bytes; ldmatrix rows 16-byte aligned).
struct SmemB {
  __nv_bfloat16* coef;   // [kRows][kpad + 8] (R - I), bf16
  float* skin;           // [kRows][J][12] as Smem's
  float* jrest;          // [kRows][J][3]
  __nv_bfloat16* sk16;   // [12][kRows][jpad + 8] skinning entries, bf16
  __nv_bfloat16* stage;  // [kStages][kChunkB][kRowB] basis ring
  float* out;            // [kWarps][8][kOutRow] an n-tile of each warp
  int* parents;          // [J]
  int* rowsrc;           // [kRows]
  int* depth;            // [J + 1] as Smem's
};

inline size_t smem_bytes_bf16(int rows, int kpad, int J, int jpad) {
  return 2 * ((size_t)rows * (kpad + 8) + (size_t)12 * rows * (jpad + 8) +
              (size_t)kStages * kStageB) +
         4 * ((size_t)rows * J * 15 + (size_t)kWarps * 8 * kOutRow + 2 * J +
              rows + 1);
}

template <int kRows>
__device__ inline SmemB carve_bf16(char* smem, int kpad, int J, int jpad) {
  SmemB t;
  t.skin = reinterpret_cast<float*>(smem);
  t.jrest = t.skin + kRows * J * 12;
  t.out = t.jrest + kRows * J * 3;
  t.coef = reinterpret_cast<__nv_bfloat16*>(t.out + kWarps * 8 * kOutRow);
  t.sk16 = t.coef + kRows * (kpad + 8);
  t.stage = t.sk16 + 12 * kRows * (jpad + 8);
  t.parents = reinterpret_cast<int*>(t.stage + kStages * kStageB);
  t.rowsrc = t.parents + J;
  t.depth = t.rowsrc + kRows;
  return t;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices from shared memory (lane i addresses row i % 8 of
// matrix i / 8); kTrans transposes each.
template <bool kTrans>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  if constexpr (kTrans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// d += a b on the tensor cores: A 16x16 (row), B 16x8 (col), bf16; D fp32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Accumulator element i of a 16x8 tile: row (vertex) lane / 4 + 8 (i / 2),
// column (tile row) 2 (lane % 4) + i % 2.
template <int kRows>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
posed_bf16_kernel(const float* __restrict__ v_shaped,  // [C, V, 3]
                  const float* __restrict__ joints,    // [C, J, 3]
                  const int* __restrict__ idx,         // [B]
                  const float* __restrict__ pose,      // [B, J, 3]
                  // [nsub, kpad, 3, VT] and [nsub, VT, jpad]
                  const __nv_bfloat16* __restrict__ basis,
                  const __nv_bfloat16* __restrict__ wt,
                  const int* __restrict__ parents,     // [J]
                  float* __restrict__ out,             // [B, V, 3]
                  int B, int C, int V, int J, int kpad, int per) {
  constexpr int kNt = kRows / 8;   // 8-row n-tiles of the tile
  extern __shared__ float4 smem4[];
  const int jpad = (J + 15) / 16 * 16;
  const int cs = kpad + 8, js = jpad + 8;   // staged row strides (bf16)
  const SmemB t =
      carve_bf16<kRows>(reinterpret_cast<char*>(smem4), kpad, J, jpad);
  const int row0 = blockIdx.x * kRows;
  const int nsub = (V + kVertTile - 1) / kVertTile;
  const int sub0 = blockIdx.y * per;
  const int sub1 = min(nsub, sub0 + per);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;   // mma group, thread in group
  const int rows_here = min(kRows, B - row0);

  // The basis stream, as tiled_blend_skin's: chunk q is k-rows [kChunkB
  // (q % nchunk), +kChunkB) of sub-tile sub0 + q / nchunk into stage
  // q % kStages, each k-row (768 bytes, 48 16-byte copies) at a padded
  // stride; every call commits one group.
  const int nchunk = (kpad + kChunkB - 1) / kChunkB;
  const int total = (sub1 - sub0) * nchunk;
  const auto fetch = [&](int q) {
    if (q < total) {
      const int sub = sub0 + q / nchunk, k0 = (q % nchunk) * kChunkB;
      const __nv_bfloat16* src =
          basis + ((size_t)sub * kpad + k0) * 3 * kVertTile;
      __nv_bfloat16* dst = t.stage + (q % kStages) * kStageB;
      const int n = min(kChunkB, kpad - k0) * (3 * kVertTile / 8);
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const int r = i / (3 * kVertTile / 8), p = i - r * (3 * kVertTile / 8);
        mano::cp_async<16>(dst + r * kRowB + 8 * p,
                           src + (size_t)r * 3 * kVertTile + 8 * p);
      }
    }
    mano::cp_async_commit();
  };
  for (int q = 0; q < kStages - 1; ++q) fetch(q);   // overlaps the front
  gather_front<kRows, true>(joints, idx, pose, parents, B, C, row0, J, cs, t);
  // The skinning entries as the skin mma's B operand: sk16[e][r][j].
  for (int i = threadIdx.x; i < 12 * kRows * jpad; i += kThreads) {
    const int e = i / (kRows * jpad), rj = i - e * kRows * jpad;
    const int r = rj / jpad, j = rj - r * jpad;
    t.sk16[(e * kRows + r) * js + j] = __float2bfloat16_rn(
        j < J ? t.skin[(r * J + j) * 12 + e] : 0.0f);
  }
  __syncthreads();

  float acc[kNt][3][4];
  uint32_t wa[mano::kMaxJoints / 16][4];   // W's A fragments, 16 joints a step
  for (int q = 0; q < total; ++q) {
    const int ch = q % nchunk;
    const int sub = sub0 + q / nchunk;
    const int vw = sub * kVertTile + kVw * warp;   // the warp's first vertex
    const bool live = vw < V;
    if (ch == 0 && live) {
      // Start at the gathered template (scalar loads; 0 past V).
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int v = vw + gq + 8 * (i >> 1);
          const int src_row = t.rowsrc[nt * 8 + 2 * tq + (i & 1)];
          const float* src = v_shaped + ((size_t)src_row * V + v) * 3;
#pragma unroll
          for (int c = 0; c < 3; ++c)
            acc[nt][c][i] = v < V ? __ldg(src + c) : 0.0f;
        }
    }
    mano::cp_async_wait<kStages - 2>();   // this thread's copies of chunk q
    __syncthreads();                      // everyone's; stage (q - 1) free
    fetch(q + kStages - 1);
    if (live) {
      const __nv_bfloat16* st = t.stage + (q % kStages) * kStageB;
      const int nk = min(kChunkB, kpad - ch * kChunkB);   // a multiple of 16
      for (int kl = 0; kl < nk; kl += 16) {
        uint32_t a[3][4];
#pragma unroll
        for (int c = 0; c < 3; ++c)
          ldmatrix_x4<true>(a[c], st + (kl + (lane & 7) + 8 * (lane >> 4)) *
                                          kRowB +
                                      c * kVertTile + kVw * warp +
                                      8 * ((lane >> 3) & 1));
        const int k0 = ch * kChunkB + kl;
#pragma unroll
        for (int nt = 0; nt < kNt; nt += 2) {
          if (nt + 1 < kNt) {
            uint32_t b[4];
            ldmatrix_x4<false>(
                b, t.coef + (nt * 8 + (lane & 7) + 8 * (lane >> 4)) * cs +
                       k0 + 8 * ((lane >> 3) & 1));
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              mma_bf16(acc[nt][c], a[c], b[0], b[1]);
              mma_bf16(acc[nt + 1][c], a[c], b[2], b[3]);
            }
          } else {
            uint32_t b[2];
            ldmatrix_x2(b, t.coef + (nt * 8 + (lane & 7)) * cs + k0 +
                               8 * ((lane >> 3) & 1));
#pragma unroll
            for (int c = 0; c < 3; ++c) mma_bf16(acc[nt][c], a[c], b[0], b[1]);
          }
        }
      }
    }
    if (ch != nchunk - 1 || !live) continue;

    // Epilogue of the sub-tile: skin each 8-row n-tile on the tensor cores,
    // apply it to v_posed in registers, stage the rows, store them.
    const int nks = jpad / 16;
    {
      const __nv_bfloat16* w0 = wt + (size_t)vw * jpad + 2 * tq;
#pragma unroll
      for (int ks = 0; ks < mano::kMaxJoints / 16; ++ks) {
        if (ks >= nks) break;
        const __nv_bfloat16* w = w0 + 16 * ks;
        wa[ks][0] = __ldg(reinterpret_cast<const uint32_t*>(w + gq * jpad));
        wa[ks][1] =
            __ldg(reinterpret_cast<const uint32_t*>(w + (gq + 8) * jpad));
        wa[ks][2] = __ldg(reinterpret_cast<const uint32_t*>(w + gq * jpad + 8));
        wa[ks][3] =
            __ldg(reinterpret_cast<const uint32_t*>(w + (gq + 8) * jpad + 8));
      }
    }
    float* buf = t.out + warp * 8 * kOutRow;
    const int nv = min(kVw, V - vw) * 3;   // live floats of a staged row
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
      if (nt * 8 >= rows_here) break;
      float m[12][4];
#pragma unroll
      for (int e = 0; e < 12; ++e)
#pragma unroll
        for (int i = 0; i < 4; ++i) m[e][i] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < mano::kMaxJoints / 16; ++ks) {
        if (ks >= nks) break;
#pragma unroll
        for (int e = 0; e < 12; e += 2) {
          uint32_t b[4];
          ldmatrix_x4<false>(
              b, t.sk16 + ((e + (lane >> 4)) * kRows + nt * 8 + (lane & 7)) *
                              js +
                     16 * ks + 8 * ((lane >> 3) & 1));
          mma_bf16(m[e], wa[ks], b[0], b[1]);
          mma_bf16(m[e + 1], wa[ks], b[2], b[3]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float px = acc[nt][0][i], py = acc[nt][1][i], pz = acc[nt][2][i];
        float* o = buf + (2 * tq + (i & 1)) * kOutRow + (gq + 8 * (i >> 1)) * 3;
#pragma unroll
        for (int c = 0; c < 3; ++c)
          o[c] = m[3 * c][i] * px + m[3 * c + 1][i] * py +
                 m[3 * c + 2][i] * pz + m[9 + c][i];
      }
      __syncwarp();
      const int nr = min(8, rows_here - nt * 8);
      float* dst = out + ((size_t)(row0 + nt * 8) * V + vw) * 3;
      for (int e = lane; e < 8 * 3 * kVw; e += 32) {
        const int r = e / (3 * kVw), f = e - r * 3 * kVw;
        if (r < nr && f < nv) dst[(size_t)r * V * 3 + f] = buf[r * kOutRow + f];
      }
      __syncwarp();
    }
  }
  mano::cp_async_wait<0>();
}

}  // namespace

// bf16 != 0 launches the bf16 tier: basis [nsub, kpad, 3, 128] and wt
// [nsub, 128, jpad] (jpad = J rounded up to 16) are then __nv_bfloat16 and
// kpad a multiple of 16; else fp32 basis [nsub, kpad, 3, 128] and wt
// [nsub, J, 128], kpad a multiple of 4.
extern "C" int mano_fused_posed(const void* v_shaped, const void* joints,
                                const void* idx, const void* pose,
                                const void* basis, const void* wt,
                                const void* parents, void* out, int B, int C,
                                int V, int J, int kpad, int bf16,
                                void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    const int jpad = (J + 15) / 16 * 16;
    const auto bytes = [&](int rows) {
      return smem_bytes_bf16(rows, kpad, J, jpad);
    };
    return with_row_tile(B, 1, V, bytes, [&](auto rows) {
      constexpr int kRows = decltype(rows)::value;
      return launch<kRows>(
          posed_bf16_kernel<kRows>, bytes(kRows), 1, B, V, 0, s,
          static_cast<const float*>(v_shaped),
          static_cast<const float*>(joints), static_cast<const int*>(idx),
          static_cast<const float*>(pose),
          static_cast<const __nv_bfloat16*>(basis),
          static_cast<const __nv_bfloat16*>(wt),
          static_cast<const int*>(parents), static_cast<float*>(out), B, C, V,
          J, kpad);
    });
  }
  const auto bytes = [&](int rows) { return smem_bytes(rows, kpad, J); };
  return with_row_tile(B, 1, V, bytes, [&](auto rows) {
    constexpr int kRows = decltype(rows)::value;
    return launch<kRows>(
        posed_kernel<kRows>, bytes(kRows), 1, B, V, 0, s,
        static_cast<const float*>(v_shaped), static_cast<const float*>(joints),
        static_cast<const int*>(idx), static_cast<const float*>(pose),
        static_cast<const float*>(basis), static_cast<const float*>(wt),
        static_cast<const int*>(parents), static_cast<float*>(out), B, C, V, J,
        kpad);
  });
}
