// Shared pieces of the flash-attention kernels (flash_fwd.cu,
// flash_bwd_dq.cu, flash_bwd_dkv.cu, through hopper_common.cuh): the
// element type traits, the causal fill, the reductions across the four
// lanes that share an accumulator row, and the dispatch of a (dtype, head
// dim) pair to a launcher. The layout of the operands and the row0
// convention of the causal mask are described in hopper_common.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rtt {

constexpr float kNegInf = -1e30f;  // the causal fill of the reference

// Element type traits: rounding of two floats into one packed register.
template <typename T> struct Elem;

template <> struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

template <> struct Elem<__half> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

// Max and sum across the four lanes that share an accumulator row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Dispatch a (dtype, head_dim) pair to a launcher templated on both.
// fp16 != 0 selects __half, else __nv_bfloat16.
#define RTT_DISPATCH(fp16, d, LAUNCH, ...)                                      \
  do {                                                                          \
    if ((d) == 64) {                                                            \
      return (fp16) ? LAUNCH<__half, 64>(__VA_ARGS__)                           \
                    : LAUNCH<__nv_bfloat16, 64>(__VA_ARGS__);                   \
    }                                                                           \
    if ((d) == 128) {                                                           \
      return (fp16) ? LAUNCH<__half, 128>(__VA_ARGS__)                          \
                    : LAUNCH<__nv_bfloat16, 128>(__VA_ARGS__);                  \
    }                                                                           \
    return static_cast<int>(cudaErrorInvalidValue);                             \
  } while (0)

}  // namespace rtt
