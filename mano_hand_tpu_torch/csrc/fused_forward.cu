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
// [kpad, 3V], whose epilogue is the skin; it runs as the tiled fp32-FFMA
// GEMM of tiled_phase_d.cuh (one prelude per row tile and span of
// 128-vertex sub-tiles, the basis through a cp.async ring in shared
// memory from the vertex-tiled operand of ops/fused_forward.py:_pack,
// 8-row x 4-vertex x 3 register micro-tiles, the skin as epilogue). The
// prelude is the fp32 (FMA) form of mano_common.cuh's phases A-C.
//
// K4 is the same phase D (tiled_blend_skin, one function these kernels
// and f32 K2 inline) behind a loader in place of the prelude: the block
// copies its rows' coefficients [beta | 1 | R - I | 0] and skinning
// transforms (R, t), made by the PyTorch pre-stage
// (ops/fused_forward.py:pre_stage, as pallas_forward.py:_pre_stage makes
// them), into the slots the prelude fills. Its row tile and vertex split
// are chosen as K1's.
//
// What was measured (scripts/time_fused_forward.py, NVIDIA H100 80GB HBM3
// at 700 W): about 0.31-0.33 ms for B = 8192, against the parent design's
// 0.57-0.60 and a bound of 0.122; variants without the basis copies or
// without the per-chunk barrier were only 3-6 % faster, and micro-tiles of
// 8 x 2 and 8 x 4 vertices, 32 or 64 rows, 1 or 2 blocks an SM all land
// within about 10 % of each other (PERF.md section 5). FK level by level
// in place of one thread a row, and the row tile that fills the SMs,
// then took K1 at B = 1000 from 0.075 to 0.053 ms of device time (0.060
// with the FK alone) and at B = 256 from 0.075 to 0.031 (CUDA-graph
// replay, both designs in one run).

#include "tiled_phase_d.cuh"

namespace {

using namespace mano::tiled;

// K1's front: [beta | 1 | R - I | 0] into coef, the shaped rest joints,
// then phases A-C of mano_common.cuh in their fp32 form, for kRows rows.
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
  mano::rodrigues_rows<kRows, kThreads, false>(pose, B, row0, J, kpad,
                                               S + 1, t);
  __syncthreads();  // parents are read below
  if (threadIdx.x == 0) mano::tree_depths(t.parents, J, t.depth);
  // Shaped rest joints: J_rest[j][c] = jb[j][c][S] + sum_s jb[j][c][s] beta_s.
  for (int i = threadIdx.x; i < kRows * J * 3; i += kThreads) {
    const int r = i / (J * 3), jc = i - r * J * 3;
    const float* g = jb + (size_t)jc * (S + 1);
    const float* beta = shape + (size_t)mano::tile_row(row0, r, B) * S;
    float acc = 0.0f;
    for (int s = 0; s < S; ++s) acc += g[s] * beta[s];
    t.jrest[i] = acc + g[S];
  }
  // B, C: forward kinematics level by level and the inverse bind.
  mano::kinematics<kRows, kThreads, false>(t, J);
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

}  // namespace

// H hands: operands stacked on a leading hand axis (H = 1: K1, H > 1: K5).
// basis and wt are the vertex-tiled operands of ops/fused_forward.py:_pack.
// split: vertex sub-tile spans per row tile (0: chosen from B and the card).
// tile_rows (may be null): set to the row tile with_row_tile took.
extern "C" int mano_fused_forward(const void* pose, const void* shape,
                                  const void* basis, const void* wt,
                                  const void* jb, const void* parents,
                                  void* out, int H, int B, int V, int J,
                                  int S, int kpad, int split, void* stream,
                                  int* tile_rows) {
  const auto bytes = [&](int rows) { return smem_bytes(rows, kpad, J); };
  return with_row_tile(B, H, V, bytes, [&](auto rows) {
    constexpr int kRows = decltype(rows)::value;
    if (tile_rows != nullptr) *tile_rows = kRows;
    return launch<kRows>(
        fused_forward_kernel<kRows>, bytes(kRows), H, B, V, split,
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
  const auto bytes = [&](int rows) { return smem_bytes(rows, kpad, J); };
  return with_row_tile(B, 1, V, bytes, [&](auto rows) {
    constexpr int kRows = decltype(rows)::value;
    return launch<kRows>(
        blend_skin_kernel<kRows>, bytes(kRows), 1, B, V, 0,
        static_cast<cudaStream_t>(stream), static_cast<const float*>(coef),
        static_cast<const float*>(rot), static_cast<const float*>(t),
        static_cast<const float*>(basis), static_cast<const float*>(wt),
        static_cast<float*>(out), B, V, J, kpad);
  });
}

extern "C" const char* mano_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
