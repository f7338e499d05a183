// K4: blend + skin in one launch, (coef, R, t) -> verts, where v_posed =
// coef . basis never leaves the chip.
//
// Replaces the TPU kernel mano_hand_tpu/ops/pallas_forward.py:blend_skin_fused
// (its pallas_calls at :228 and :239). The per-row coefficients
// [beta | 1 | (R - I) | 0] and the skinning transforms come from the small
// PyTorch pre-stage (Rodrigues, shaped joints, FK, inverse bind;
// ops/fused_forward.py:pre_stage), as they come from _pre_stage there.
//
// What bounds it on an H100: fp32 operations, as for K1. Per row the blend is
// 2 K 3V FLOP (K = S + 1 + 9 (J - 1) = 146 for MANO, about 0.68 MFLOP) and
// the skinning 2 * 12 J V + 18 V (about 0.31 MFLOP), about 0.99 MFLOP
// against 4 (kpad + 12 J) bytes read and 12 V bytes written (10.7 KB): some
// 90 FLOP a byte, far above the card's fp32 ridge (about 20); at B = 8192
// the bound is about 0.122 ms. The design is K1's skeleton with phases A-C
// (Rodrigues, FK, inverse bind) replaced by the tile loaders of
// mano_common.cuh: the block stages its rows' coefficients and (R, t) in
// shared memory once (the same ~50 KB tile as K1), and phase D keeps
// kRowChunk rows of v_posed in registers between the blend and the skin.

#include "mano_common.cuh"

namespace {

__global__ void __launch_bounds__(mano::kThreads)
blend_skin_kernel(const float* __restrict__ coef,   // [B, kpad]
                  const float* __restrict__ rot,    // [B, J, 3, 3]
                  const float* __restrict__ tr,     // [B, J, 3]
                  const float* __restrict__ basis,  // [kpad, 3, V]
                  const float* __restrict__ wt,     // [J, V]
                  float* __restrict__ out,          // [B, V, 3]
                  int B, int V, int J, int kpad) {
  extern __shared__ float4 smem4[];
  const mano::Tile t = mano::carve(reinterpret_cast<float*>(smem4), kpad, J);
  const int row0 = blockIdx.x * mano::kTileRows;
  mano::load_coef_rows(coef, B, row0, kpad, t);
  mano::load_skin_rows(rot, tr, B, row0, J, t);
  __syncthreads();
  mano::blend_skin_rows(t, kpad, J, basis, wt, nullptr, V, B, row0, out);
}

}  // namespace

extern "C" int mano_blend_skin(const void* coef, const void* rot,
                               const void* t, const void* basis,
                               const void* wt, void* out, int B, int V, int J,
                               int kpad, void* stream) {
  const size_t smem = mano::tile_smem_bytes(kpad, J);
  const int err = mano::prepare_smem(blend_skin_kernel, smem);
  if (err != 0) return err;
  const dim3 grid((B + mano::kTileRows - 1) / mano::kTileRows,
                  (V + mano::kThreads - 1) / mano::kThreads);
  blend_skin_kernel<<<grid, mano::kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(coef), static_cast<const float*>(rot),
      static_cast<const float*>(t), static_cast<const float*>(basis),
      static_cast<const float*>(wt), static_cast<float*>(out), B, V, J, kpad);
  return (int)cudaGetLastError();
}
