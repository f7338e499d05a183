// Asynchronous copies from global to shared memory (cp.async, sm_80 and
// later), shared by fused_forward.cu (K1, K4, K5) and skin.cu (K3). A copy
// is issued by one thread; cp_async_commit closes the thread's group of
// copies, and cp_async_wait<N> waits until at most N of its groups are
// still in flight. The copied data is visible to other threads only after
// a barrier (__syncwarp for a warp's own stage, __syncthreads for a
// block's).

#pragma once

namespace mano {

// kBytes (16, 8 or 4) from gmem to smem, both kBytes-aligned; 16 bytes
// go through L2 only (.cg), 8 and 4 through L1 too (.ca: .cg takes 16).
template <int kBytes>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  static_assert(kBytes == 16 || kBytes == 8 || kBytes == 4, "cp.async size");
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(gmem), "n"(kBytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace mano
