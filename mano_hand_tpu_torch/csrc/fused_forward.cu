// K1 and K5: the whole batched MANO forward in one launch, (pose, shape) ->
// verts, for one hand (K1) or several hands at once (K5).
//
// Replaces the TPU kernels mano_hand_tpu/ops/pallas_forward.py:
// forward_verts_fused_full (its pallas_call at :723) and
// forward_verts_fused_full_hands (its pallas_call at :830). The TPU pair
// mirrors its launch code line for line; here they are one kernel with a
// hand axis: blockIdx.z picks the hand, whose operands (basis, weights,
// joint basis, pose, shape, out) sit at a per-hand stride; the kinematic
// tree is shared. K1 is the H = 1 launch, K5 the H = 2 launch.
//
// What bounds it on an H100: fp32 operations. Per row the blend is
// 2 K 3V FLOP (K = S + 1 + 9 (J - 1) = 146 for MANO, about 0.68 MFLOP) and the
// skinning 2 (12 J + 12) V (about 0.32 MFLOP), against 12 V bytes written
// (9.3 KB) and 232 bytes read: some 100 FLOP a byte, far above the card's
// fp32 ridge (about 20). The design keeps every intermediate — rotations,
// world transforms, the coefficient vector, v_posed — on chip: the prelude
// (Rodrigues, shaped joints, FK, inverse bind) lives in shared memory, and
// v_posed for kRowChunk rows at a time lives in registers, so device memory
// sees only pose/shape in, verts out, and the asset (1.4 MB a hand,
// L2-resident). The TPU layout machinery (lane permutation of the joints,
// bf16 hi/lo split, stacked skin dots, (8, 128) padding) has no counterpart
// here.

#include "mano_common.cuh"

namespace {

__global__ void __launch_bounds__(mano::kThreads)
fused_forward_kernel(const float* __restrict__ pose,   // [H, B, J, 3]
                     const float* __restrict__ shape,  // [H, B, S]
                     const float* __restrict__ basis,  // [H, kpad, 3, V]
                     const float* __restrict__ wt,     // [H, J, V]
                     const float* __restrict__ jb,     // [H, J, 3, S + 1]
                     const int* __restrict__ parents,  // [J] (shared)
                     float* __restrict__ out,          // [H, B, V, 3]
                     int B, int V, int J, int S, int kpad) {
  extern __shared__ float4 smem4[];
  const mano::Tile t = mano::carve(reinterpret_cast<float*>(smem4), kpad, J);
  const int row0 = blockIdx.x * mano::kTileRows;
  const int k = S + 1 + 9 * (J - 1);
  const size_t h = blockIdx.z;
  pose += h * B * J * 3;
  shape += h * B * S;
  basis += h * kpad * 3 * V;
  wt += h * J * V;
  jb += h * J * 3 * (S + 1);
  out += h * B * V * 3;

  for (int i = threadIdx.x; i < J; i += blockDim.x) t.parents[i] = parents[i];
  // Coefficients [beta | 1 | (R - I) ... | 0 pad]; the 1 drives the template row.
  for (int i = threadIdx.x; i < mano::kTileRows * (S + 1); i += blockDim.x) {
    const int r = i / (S + 1), c = i - r * (S + 1);
    t.coef[r * kpad + c] =
        c < S ? shape[(size_t)mano::tile_row(row0, r, B) * S + c] : 1.0f;
  }
  mano::zero_coef_pad(t, k, kpad);
  mano::rodrigues_rows(pose, B, row0, J, t, kpad, S + 1);
  // Shaped rest joints: J_rest[j][c] = jb[j][c][S] + sum_s jb[j][c][s] beta_s.
  for (int i = threadIdx.x; i < mano::kTileRows * J * 3; i += blockDim.x) {
    const int r = i / (J * 3), jc = i - r * J * 3;
    const float* g = jb + (size_t)jc * (S + 1);
    const float* beta = shape + (size_t)mano::tile_row(row0, r, B) * S;
    float acc = 0.0f;
    for (int s = 0; s < S; ++s) acc += g[s] * beta[s];
    t.jrest[i] = acc + g[S];
  }
  __syncthreads();
  mano::fk_rows(t, J);
  __syncthreads();
  mano::inverse_bind_rows(t, J);
  __syncthreads();
  mano::blend_skin_rows(t, kpad, J, basis, wt, nullptr, V, B, row0, out);
}

}  // namespace

// H hands: operands stacked on a leading hand axis (H = 1: K1, H > 1: K5).
extern "C" int mano_fused_forward(const void* pose, const void* shape,
                                  const void* basis, const void* wt,
                                  const void* jb, const void* parents,
                                  void* out, int H, int B, int V, int J,
                                  int S, int kpad, void* stream) {
  const size_t smem = mano::tile_smem_bytes(kpad, J);
  const int err = mano::prepare_smem(fused_forward_kernel, smem);
  if (err != 0) return err;
  const dim3 grid((B + mano::kTileRows - 1) / mano::kTileRows,
                  (V + mano::kThreads - 1) / mano::kThreads, H);
  fused_forward_kernel<<<grid, mano::kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pose), static_cast<const float*>(shape),
      static_cast<const float*>(basis), static_cast<const float*>(wt),
      static_cast<const float*>(jb), static_cast<const int*>(parents),
      static_cast<float*>(out), B, V, J, S, kpad);
  return (int)cudaGetLastError();
}

extern "C" const char* mano_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
