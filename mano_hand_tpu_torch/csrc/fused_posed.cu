// K2: the gathered pose-only serving forward in one launch,
// (subject table, idx, pose) -> verts.
//
// Replaces the TPU kernel mano_hand_tpu/ops/pallas_posed.py:
// forward_posed_gather_fused (its pallas_call at :382).
//
// Row r runs the pose stage over subject idx[r]'s baked constants: its
// shaped template v_shaped[idx[r]] starts the blend sum and its rest joints
// joints[idx[r]] feed FK — both direct indexed loads (the TPU kernel's
// one-hot MXU gather and its 512-row VMEM capacity gate have no counterpart:
// any capacity serves). An index outside [0, C - 1] is clamped, the
// semantics of core.forward_posed_gather.
//
// What bounds it on an H100: fp32 operations, as for K1 — per row the pose
// blend is 2 K 3V FLOP (K = 9 (J - 1) = 135 for MANO) plus 2 (12 J + 12) V
// for skinning, about 0.95 MFLOP, against 9.3 KB of gathered template read
// and 9.3 KB of verts written: some 50 FLOP a byte. The same device
// functions as K1 keep the prelude in shared memory and v_posed in registers.
//
// kBf16 is the bf16 serving tier (the TPU kernel's compute_dtype=bf16 mode,
// pallas_posed.py:297-305): the pose basis and the weights are read as bf16
// (half the bytes of the asset), the (R - I) coefficients are rounded to bf16
// after phase A and the 12 skinning entries after phases B and C. The FK
// inputs stay fp32 (rounding a local rotation or a rest joint would compound
// along the chain), the gathered v_shaped base stays fp32, and every product
// of two bf16 values accumulates in fp32 FFMA (the tensor cores are not used
// yet). Against the fp32 form the error is bounded by the stated 2e-3 m
// envelope of serving/precision.py.

#include "mano_common.cuh"

namespace {

template <bool kBf16, typename T>
__global__ void __launch_bounds__(mano::kThreads)
fused_posed_kernel(const float* __restrict__ v_shaped,  // [C, V, 3]
                   const float* __restrict__ joints,    // [C, J, 3]
                   const int* __restrict__ idx,         // [B]
                   const float* __restrict__ pose,      // [B, J, 3]
                   const T* __restrict__ basis,         // [kpad, 3, V]
                   const T* __restrict__ wt,            // [J, V]
                   const int* __restrict__ parents,     // [J]
                   float* __restrict__ out,             // [B, V, 3]
                   int B, int C, int V, int J, int kpad) {
  extern __shared__ float4 smem4[];
  const mano::Tile t = mano::carve(reinterpret_cast<float*>(smem4), kpad, J);
  const int row0 = blockIdx.x * mano::kTileRows;

  for (int i = threadIdx.x; i < J; i += blockDim.x) t.parents[i] = parents[i];
  for (int r = threadIdx.x; r < mano::kTileRows; r += blockDim.x)
    t.rowsrc[r] = min(max(idx[mano::tile_row(row0, r, B)], 0), C - 1);
  mano::zero_coef_pad(t, 9 * (J - 1), kpad);
  mano::rodrigues_rows<kBf16>(pose, B, row0, J, t, kpad, 0);
  __syncthreads();  // rowsrc is read below
  for (int i = threadIdx.x; i < mano::kTileRows * J * 3; i += blockDim.x) {
    const int r = i / (J * 3), jc = i - r * J * 3;
    t.jrest[i] = joints[(size_t)t.rowsrc[r] * J * 3 + jc];
  }
  __syncthreads();
  mano::fk_rows<kBf16>(t, J);
  __syncthreads();
  mano::inverse_bind_rows<kBf16>(t, J);
  __syncthreads();
  mano::blend_skin_rows(t, kpad, J, basis, wt, v_shaped, V, B, row0, out);
}

template <bool kBf16, typename T>
int launch(const void* v_shaped, const void* joints, const void* idx,
           const void* pose, const void* basis, const void* wt,
           const void* parents, void* out, int B, int C, int V, int J,
           int kpad, void* stream) {
  const size_t smem = mano::tile_smem_bytes(kpad, J);
  const int err = mano::prepare_smem(fused_posed_kernel<kBf16, T>, smem);
  if (err != 0) return err;
  const dim3 grid((B + mano::kTileRows - 1) / mano::kTileRows,
                  (V + mano::kThreads - 1) / mano::kThreads);
  fused_posed_kernel<kBf16, T><<<grid, mano::kThreads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v_shaped), static_cast<const float*>(joints),
      static_cast<const int*>(idx), static_cast<const float*>(pose),
      static_cast<const T*>(basis), static_cast<const T*>(wt),
      static_cast<const int*>(parents), static_cast<float*>(out), B, C, V, J,
      kpad);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 != 0 launches the bf16 tier: basis and wt are then __nv_bfloat16.
extern "C" int mano_fused_posed(const void* v_shaped, const void* joints,
                                const void* idx, const void* pose,
                                const void* basis, const void* wt,
                                const void* parents, void* out, int B, int C,
                                int V, int J, int kpad, int bf16,
                                void* stream) {
  if (bf16)
    return launch<true, __nv_bfloat16>(v_shaped, joints, idx, pose, basis,
                                       wt, parents, out, B, C, V, J, kpad,
                                       stream);
  return launch<false, float>(v_shaped, joints, idx, pose, basis, wt,
                              parents, out, B, C, V, J, kpad, stream);
}
