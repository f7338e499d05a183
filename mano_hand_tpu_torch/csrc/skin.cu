// K3: batched linear blend skinning in one launch, (W, R, t, v_posed) ->
// verts, out[b, v] = (sum_j W[v, j] R[b, j]) v_posed[b, v]
//                    + sum_j W[v, j] t[b, j].
//
// Replaces the TPU kernel mano_hand_tpu/ops/pallas_lbs.py:skin_batched (its
// pallas_call at :107). The backward of every differentiable route runs it
// too, with R transposed and t = 0 (dL/dv_posed = M^T g; ops/fused_skin.py).
//
// What bounds it on an H100: bytes. Per row it reads v_posed (12 V bytes) and
// R, t (48 J bytes) and writes 12 V bytes — 19.4 KB at MANO width — against
// 2 * 12 J V + 18 V FLOP (about 0.31 MFLOP): some 16 FLOP a byte, below the
// card's fp32 ridge (about 20), so at B = 8192 the bound is about 0.048 ms
// for 159 MB. The design moves each byte once: a block owns kTileRows rows
// and kThreads vertices, stages its rows' (R, t) in shared memory once
// (kTileRows * J * 48 bytes, 24.6 KB for J = 16), and each thread keeps its
// vertex's weights W[v, :] in registers for all the rows, so device memory
// sees v_posed in and verts out; the weights (50 KB) stay in L2. The blended
// [B, V, 3, 3] matrices of the plain version never exist. The TPU kernel's
// slab layout (nine rotation slabs, three coordinate planes, (8, 128)
// padding, MXU dots over J) has no counterpart here.

#include "mano_common.cuh"

namespace {

template <int JT>
__global__ void __launch_bounds__(mano::kThreads)
skin_kernel(const float* __restrict__ weights,  // [V, J]
            const float* __restrict__ rot,      // [B, J, 3, 3]
            const float* __restrict__ tr,       // [B, J, 3]
            const float* __restrict__ vp,       // [B, V, 3]
            float* __restrict__ out,            // [B, V, 3]
            int B, int V, int J) {
  extern __shared__ float4 smem4[];
  mano::Tile t{};
  t.skin = reinterpret_cast<float*>(smem4);
  const int row0 = blockIdx.x * mano::kTileRows;
  mano::load_skin_rows(rot, tr, B, row0, J, t);
  __syncthreads();
  const int v = blockIdx.y * blockDim.x + threadIdx.x;
  if (v >= V) return;
  float w[JT];
#pragma unroll
  for (int j = 0; j < JT; ++j)
    w[j] = j < J ? __ldg(weights + (size_t)v * J + j) : 0.0f;
  const auto weight = [&](int j) { return w[j]; };
  const int rows_here = min(mano::kTileRows, B - row0);
  for (int r = 0; r < rows_here; ++r) {
    const size_t at = ((size_t)(row0 + r) * V + v) * 3;
    mano::skin_apply<JT>(t.skin + r * J * 12, J, weight, __ldg(vp + at),
                         __ldg(vp + at + 1), __ldg(vp + at + 2), out + at);
  }
}

template <int JT>
int launch_skin(const float* weights, const float* rot, const float* tr,
                const float* vp, float* out, int B, int V, int J,
                cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)mano::kTileRows * J * 12;
  const int err = mano::prepare_smem(skin_kernel<JT>, smem);
  if (err != 0) return err;
  const dim3 grid((B + mano::kTileRows - 1) / mano::kTileRows,
                  (V + mano::kThreads - 1) / mano::kThreads);
  skin_kernel<JT><<<grid, mano::kThreads, smem, stream>>>(weights, rot, tr,
                                                          vp, out, B, V, J);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mano_skin(const void* weights, const void* rot, const void* t,
                         const void* v_posed, void* out, int B, int V, int J,
                         void* stream) {
  const auto* w = static_cast<const float*>(weights);
  const auto* r = static_cast<const float*>(rot);
  const auto* tr = static_cast<const float*>(t);
  const auto* vp = static_cast<const float*>(v_posed);
  auto* o = static_cast<float*>(out);
  auto* s = static_cast<cudaStream_t>(stream);
  // The register array of weights is sized by the smallest of these that
  // holds J (J <= kMaxJoints is checked by the wrapper).
  if (J <= 16) return launch_skin<16>(w, r, tr, vp, o, B, V, J, s);
  if (J <= 32) return launch_skin<32>(w, r, tr, vp, o, B, V, J, s);
  return launch_skin<mano::kMaxJoints>(w, r, tr, vp, o, B, V, J, s);
}
