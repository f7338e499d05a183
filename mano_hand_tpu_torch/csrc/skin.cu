// K3: batched linear blend skinning in one launch, (W, R, t, v_posed) ->
// verts, out[b, v] = (sum_j W[v, j] R[b, j]) v_posed[b, v]
//                    + sum_j W[v, j] t[b, j].
//
// Replaces the TPU kernel mano_hand_tpu/ops/pallas_lbs.py:skin_batched (its
// pallas_call at :107). The backward of every differentiable route runs it
// too, as dL/dv_posed = M^T g: the same kernel with R_j transposed and no
// translation term (transpose_r = 1, t = null; ops/fused_skin.py), read
// from the saved rotations with no copy.
//
// What bounds it on an H100: bytes, narrowly. Per row it reads v_posed
// (12 V bytes) and R, t (48 J bytes) and writes 12 V bytes — 19.4 KB at
// MANO width — against 2 * 12 J V + 18 V FLOP (about 0.31 MFLOP): 16 FLOP
// a byte, just under the card's fp32 ridge (about 20), so at B = 8192 the
// FFMA stream alone needs 80 % of the 0.048 ms bytes bound and has to run
// near its peak while the memory stream runs beside it. The design:
//   * A register tile of kVpt = 4 adjacent vertices a thread: per joint,
//     one float4 of the 4 vertices' weights (staged once per vertex tile,
//     transposed to [J][kVertTile] in shared memory) and three float4
//     broadcasts of the row's (R_j, t_j) feed 48 FFMA (36 without t).
//   * Coalesced rows: a warp owns one row's run of 128 vertices, which are
//     384 contiguous floats of v_posed and of out. The run comes into a
//     per-warp shared-memory slot by cp.async (16-byte copies where the
//     run's alignment allows, else 8 or 4), through a ring of kSlots slots
//     so that the warp's next rows are in flight while this row's
//     arithmetic runs; each lane reads its 12 floats as three
//     conflict-free float4 and writes its results back into the slot,
//     from which the warp stores the run as wide accesses.
//   * The unit's (R, t) (transposed in place for the backward's form) and
//     the vertex tile's weights are restaged by cp.async with
//     compile-time divisions only: the block waits for one memory latency
//     a unit, not one per loaded element.
//   * Whole waves: the work is (row tile, vertex tile) units; the grid is
//     the card's resident block count (SM count times the occupancy API's
//     blocks an SM) and each block walks an equal run of units, vertex tile
//     major, so it restages weights only when its vertex tile changes.
// What was measured (scripts/time_fused_forward.py, NVIDIA H100 80GB HBM3
// at 700 W, B = 8192): about 0.125 ms forward and 0.105 ms in the
// backward's form, against 0.16 for the per-vertex parent (whose backward
// also built a transposed copy); the joint loop runs at about 37 % of the
// fp32 FFMA peak and the row I/O alone at about 60 % of the memory rate.
// Packing several rows into the last vertex tile's idle lanes, 8 vertices
// a thread, deeper or shallower rings and other row tiles measured no
// faster (PERF.md section 5).
// Plain fp32 FFMA, no tensor cores, no fast math.

#include <cstdint>
#include <type_traits>

#include "cp_async.cuh"
#include "mano_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVpt = 4;                    // adjacent vertices of a thread
constexpr int kVertTile = 32 * kVpt;       // vertices of one warp pass
constexpr int kSlot = 3 * kVertTile + 8;   // floats of one stage slot
constexpr int kSlots = 4;                  // a warp's ring: passes in flight
constexpr int kMinBlocks = 2;              // blocks an SM the registers allow
constexpr int kMaxRows = 32;               // the largest row tile

inline size_t smem_bytes(int rows, int J) {
  return sizeof(float) * ((size_t)rows * J * 12 +
                          (size_t)J * kVertTile + kWarps * kSlots * kSlot);
}

// n floats from global src into shared dst (16-byte aligned), by the whole
// warp, as kBytes copies and 4-byte copies for the remainder; src must be
// kBytes-aligned.
template <int kBytes>
__device__ __forceinline__ void fetch_run(float* dst, const float* src,
                                          int n, int lane) {
  constexpr int f = kBytes / 4;
  const int m = n / f;
  for (int i = lane; i < m; i += 32) mano::cp_async<kBytes>(dst + f * i,
                                                            src + f * i);
  for (int i = m * f + lane; i < n; i += 32)
    mano::cp_async<4>(dst + i, src + i);
}

// n floats from shared src (16-byte aligned) to global dst, by the warp, as
// kBytes stores and 4-byte stores for the remainder; dst kBytes-aligned.
template <int kBytes>
__device__ __forceinline__ void store_run(float* dst, const float* src,
                                          int n, int lane) {
  constexpr int f = kBytes / 4;
  using Vec = typename std::conditional<
      kBytes == 16, float4,
      typename std::conditional<kBytes == 8, float2, float>::type>::type;
  const int m = n / f;
  for (int i = lane; i < m; i += 32)
    *reinterpret_cast<Vec*>(dst + f * i) =
        *reinterpret_cast<const Vec*>(src + f * i);
  for (int i = m * f + lane; i < n; i += 32) dst[i] = src[i];
}

// The widest copy an address allows (16, 8 or 4 bytes).
__device__ __forceinline__ int align_of(const float* p) {
  const auto a = static_cast<unsigned>(reinterpret_cast<uintptr_t>(p) & 15);
  return a == 0 ? 16 : (a & 7) == 0 ? 8 : 4;
}

// Row r's run of the unit's vertex tile [v0, v0 + width) into a slot, and
// back out of it.
__device__ __forceinline__ void fetch_row(float* slot,
                                          const float* __restrict__ vp, int V,
                                          int v0, int width, int r, int lane) {
  const float* src = vp + ((size_t)r * V + v0) * 3;
  switch (align_of(src)) {
    case 16: fetch_run<16>(slot, src, width * 3, lane); break;
    case 8: fetch_run<8>(slot, src, width * 3, lane); break;
    default: fetch_run<4>(slot, src, width * 3, lane);
  }
}

__device__ __forceinline__ void store_row(float* __restrict__ out,
                                          const float* slot, int V, int v0,
                                          int width, int r, int lane) {
  float* dst = out + ((size_t)r * V + v0) * 3;
  switch (align_of(dst)) {
    case 16: store_run<16>(dst, slot, width * 3, lane); break;
    case 8: store_run<8>(dst, slot, width * 3, lane); break;
    default: store_run<4>(dst, slot, width * 3, lane);
  }
}

// kT: with the translation term (the forward); without it (the backward's
// M^T g) the t slots are never read and 12 of the 48 FFMA a joint go.
template <bool kT>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
skin_kernel(const float* __restrict__ weights,  // [V, J]
            const float* __restrict__ rot,      // [B, J, 3, 3]
            const float* __restrict__ tr,       // [B, J, 3] (kT)
            const float* __restrict__ vp,       // [B, V, 3]
            float* __restrict__ out,            // [B, V, 3]
            int B, int V, int J, int rows, int transpose_r, int per) {
  extern __shared__ float4 smem4[];
  const int ss = J * 12;
  float* skin = reinterpret_cast<float*>(smem4);   // [rows][J][12]
  float* wt = skin + rows * ss;                     // [J][kVertTile]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* slots = wt + J * kVertTile + warp * kSlots * kSlot;  // the ring

  const int nrt = (B + rows - 1) / rows;
  const int nvt = (V + kVertTile - 1) / kVertTile;
  const int u0 = blockIdx.x * per, u1 = min(nrt * nvt, u0 + per);
  int staged_vt = -1;
  for (int u = u0; u < u1; ++u) {
    const int vt = u / nrt, rt = u - vt * nrt;
    const int v0 = vt * kVertTile, width = min(kVertTile, V - v0);
    const int row0 = rt * rows, rows_here = min(rows, B - row0);

    // Row r of the unit into ring slot `slot`; every call commits one
    // group, empty past the last row, so that wait_group<kSlots - 1>
    // before a row's inputs waits for that row.
    const auto fetch = [&](int r, int slot) {
      if (r < rows_here)
        fetch_row(slots + slot * kSlot, vp, V, v0, width, row0 + r, lane);
      mano::cp_async_commit();
    };
    __syncthreads();   // the previous unit's readers of skin and wt are done
    // Restage by cp.async: every copy is issued before any lands, so the
    // block waits for one memory latency, not one per element.
    if (vt != staged_vt) {
      for (int i = threadIdx.x; i < J * kVertTile; i += kThreads) {
        const int j = i / kVertTile, v = i - j * kVertTile;
        if (v < width)
          mano::cp_async<4>(wt + i, weights + (size_t)(v0 + v) * J + j);
        else
          wt[i] = 0.0f;
      }
      staged_vt = vt;
    }
    for (int r = warp; r < rows_here; r += kWarps) {
      const float* R = rot + (size_t)(row0 + r) * J * 9;
      float* sk = skin + r * ss;
      for (int e = lane; e < J * 9; e += 32) {
        const int j = e / 9, c = e - 9 * j;
        const int slot = transpose_r ? (c % 3) * 3 + c / 3 : c;
        mano::cp_async<4>(sk + j * 12 + slot, R + e);
      }
      if constexpr (kT) {
        const float* T = tr + (size_t)(row0 + r) * J * 3;
        for (int e = lane; e < J * 3; e += 32) {
          const int j = e / 3;
          mano::cp_async<4>(sk + j * 12 + 9 + (e - 3 * j), T + e);
        }
      }
    }
    mano::cp_async_commit();
    // The warp's first rows start copying while the restage lands.
    for (int i = 0; i < kSlots - 1; ++i) fetch(warp + i * kWarps, i);
    mano::cp_async_wait<kSlots - 1>();   // this thread's restage copies
    __syncthreads();                     // everyone's

    // Lane g's vertices v0 + kVpt g ..; in the last vertex tile lanes past
    // V compute on stale slot data (zero weights) and write past the run's
    // end, which is never stored.
    const float4* w4 = reinterpret_cast<const float4*>(wt) + lane;
    for (int k = 0, r = warp; r < rows_here; ++k, r += kWarps) {
      float* slot = slots + (k % kSlots) * kSlot;
      // The row kSlots - 1 ahead into the slot the previous row freed.
      fetch(r + (kSlots - 1) * kWarps, (k + kSlots - 1) % kSlots);
      float* mine = slot + lane * kVpt * 3;
      constexpr int kM = kT ? 12 : 9;
      float m[kVpt][kM];
#pragma unroll
      for (int a = 0; a < kVpt; ++a)
#pragma unroll
        for (int e = 0; e < kM; ++e) m[a][e] = 0.0f;
      const float4* s4 = reinterpret_cast<const float4*>(skin + r * ss);
      // Not unrolled: unrolled 2 or 4 it was no faster, and it spilled.
#pragma unroll 1
      for (int j = 0; j < J; ++j) {
        const float4 w = w4[j * (kVertTile / 4)];
        const float wa[kVpt] = {w.x, w.y, w.z, w.w};
        const float4 s0 = s4[3 * j], s1 = s4[3 * j + 1], s2 = s4[3 * j + 2];
        const float s[12] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y,
                             s1.z, s1.w, s2.x, s2.y, s2.z, s2.w};
#pragma unroll
        for (int a = 0; a < kVpt; ++a)
#pragma unroll
          for (int e = 0; e < kM; ++e) m[a][e] = fmaf(wa[a], s[e], m[a][e]);
      }
      // The inputs are waited for and read after the joint loop: the copy
      // has the loop's time to land, and their registers are not live
      // across it.
      mano::cp_async_wait<kSlots - 1>();
      __syncwarp();
      // A lane's 12 floats: 16-byte aligned, lanes 48 bytes apart (no bank
      // conflict).
      float q[kVpt][3];
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        const float4 x = reinterpret_cast<const float4*>(mine)[e];
        const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int f = 0; f < 4; ++f) q[(4 * e + f) / 3][(4 * e + f) % 3] = xs[f];
      }
      float o[kVpt][3];
#pragma unroll
      for (int a = 0; a < kVpt; ++a)
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float x = m[a][3 * c] * q[a][0] + m[a][3 * c + 1] * q[a][1] +
                          m[a][3 * c + 2] * q[a][2];
          if constexpr (kT) o[a][c] = x + m[a][9 + c];
          else o[a][c] = x;
        }
      __syncwarp();   // every lane has read its inputs from the slot
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        float xs[4];
#pragma unroll
        for (int f = 0; f < 4; ++f) xs[f] = o[(4 * e + f) / 3][(4 * e + f) % 3];
        reinterpret_cast<float4*>(mine)[e] =
            make_float4(xs[0], xs[1], xs[2], xs[3]);
      }
      __syncwarp();
      store_row(out, slot, V, v0, width, row0 + r, lane);
      __syncwarp();   // the slot is free for the next row's prefetch
    }
    mano::cp_async_wait<0>();
  }
}

// The row tile and the resident block count of kernel<kT> at J joints and a
// batch of B: kMaxRows rows (fewer where shared memory is short), or fewer
// still while the batch would leave block slots of the card empty. The
// occupancy of each (J, row tile) is read once and kept; the kernel's
// shared-memory ceiling only ever rises, so a launch planned before stays
// valid.
template <bool kT>
int plan(int B, int V, int J, int* rows, int* slots, size_t* smem) {
  constexpr size_t kSmemMax = 227 * 1024;
  static int sms = 0;
  static size_t ceiling = 0;
  static int per_sm[mano::kMaxJoints + 1][4];   // row tiles kMaxRows, / 2 ..
  int err = 0;
  if (sms == 0) {
    int dev = 0, n = 0;
    if ((err = (int)cudaGetDevice(&dev)) != 0) return err;
    if ((err = (int)cudaDeviceGetAttribute(
             &n, cudaDevAttrMultiProcessorCount, dev)) != 0)
      return err;
    sms = n;
  }
  const int nvt = (V + kVertTile - 1) / kVertTile;
  *rows = 0;
  for (int i = 0, r = kMaxRows; r >= 8; ++i, r /= 2) {
    const size_t bytes = smem_bytes(r, J);
    if (bytes > kSmemMax) continue;
    if (bytes > ceiling) {
      if ((err = mano::prepare_smem(skin_kernel<kT>, bytes)) != 0) return err;
      ceiling = bytes;
    }
    if (per_sm[J][i] == 0) {
      int n = 0;
      if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &n, skin_kernel<kT>, kThreads, bytes)) != 0)
        return err;
      per_sm[J][i] = n > 0 ? n : 1;
    }
    *rows = r;
    *slots = sms * per_sm[J][i];
    *smem = bytes;
    if (r == 8 || (long)((B + r - 1) / r) * nvt >= *slots) break;
  }
  return *rows == 0 ? (int)cudaErrorInvalidConfiguration : 0;
}

template <bool kT>
int launch_skin(const float* weights, const float* rot, const float* tr,
                const float* vp, float* out, int B, int V, int J,
                int transpose_r, cudaStream_t stream) {
  int rows = 0, slots = 0;
  size_t smem = 0;
  const int err = plan<kT>(B, V, J, &rows, &slots, &smem);
  if (err != 0) return err;
  const long units =
      (long)((B + rows - 1) / rows) * ((V + kVertTile - 1) / kVertTile);
  const int per = (int)((units + slots - 1) / slots);
  const int grid = (int)((units + per - 1) / per);
  skin_kernel<kT><<<grid, kThreads, smem, stream>>>(
      weights, rot, tr, vp, out, B, V, J, rows, transpose_r, per);
  return (int)cudaGetLastError();
}

}  // namespace

// t may be null (no translation term); transpose_r != 0 skins with R_j^T.
extern "C" int mano_skin(const void* weights, const void* rot, const void* t,
                         const void* v_posed, void* out, int B, int V, int J,
                         int transpose_r, void* stream) {
  const auto* w = static_cast<const float*>(weights);
  const auto* r = static_cast<const float*>(rot);
  const auto* tr = static_cast<const float*>(t);
  const auto* vp = static_cast<const float*>(v_posed);
  auto* o = static_cast<float*>(out);
  auto* s = static_cast<cudaStream_t>(stream);
  if (tr == nullptr)
    return launch_skin<false>(w, r, tr, vp, o, B, V, J, transpose_r, s);
  return launch_skin<true>(w, r, tr, vp, o, B, V, J, transpose_r, s);
}
