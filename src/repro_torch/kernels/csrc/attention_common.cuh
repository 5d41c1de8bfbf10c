// Shared pieces of the attention kernels (flash_attention.cu,
// decode_attention.cu): the reference's masked-score value, the
// asynchronous-copy helpers and the score scale.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace attn {

// the reference's NEG_INF: a finite -0.7 * float32 max, so a wholly
// masked block gives exp(0) terms that the next live block's rescale wipes
constexpr float NEG_INF = -0.7f * 3.402823466e38f;

// 16 bytes from global to shared memory without passing through registers;
// with pred false nothing is read and the 16 bytes are zero-filled
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 1/sqrt(D) rounded once to float32, as the plain version's scale is
inline float inv_sqrt(int D) {
  return static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
}

}  // namespace attn
