// Shared pieces of the flash-attention kernels: the mma.sync kernel
// flash_bwd_dq.cu, and the element type traits, quad reductions and
// dispatch that the TMA kernels (flash_fwd.cu, flash_bwd_dkv.cu, through
// hopper_common.cuh) reuse.
//
// Layout: the query-side tensors q, o, do, dq are [BH, tq, D] and the
// key-side tensors k, v, dk, dv are [BH, tk, D], row-major in bf16 or
// fp16; lse and delta are [BH, tq] float32. The square attention of one
// sequence is tq = tk = T; a band of the causal split (Pallas _rect_fwd /
// _rect_core_bwd) has tq <= tk (see Shape). The mma.sync kernel works on
// tiles of 64 rows held in shared memory as raw 16-bit words, with each
// row padded by 8 elements so that the fragment loads below hit 32
// distinct banks.
//
// Products run on the tensor cores through mma.sync.m16n8k16 with f32
// accumulation. A warp owns 16 rows of a tile; the fragment layouts are
// the PTX ISA's for m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16x16, row-major): a0 = A[g][2t..2t+1],   a1 = A[g+8][2t..2t+1],
//                         a2 = A[g][2t+8..2t+9], a3 = A[g+8][2t+8..2t+9]
//   B (16x8, k by n):     b0 = B[2t..2t+1][g],   b1 = B[2t+8..2t+9][g]
//   C (16x8, f32):        c0,c1 = C[g][2t..2t+1], c2,c3 = C[g+8][2t..2t+1]
// Two C tiles side by side (n = 0..7 and 8..15) hold exactly the values
// of one A fragment, which is how a probability tile P computed by one
// product feeds the next product without a trip through shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rtt {

constexpr int kTile = 64;       // rows of q (or of k) a block owns
constexpr int kThreads = 128;   // 4 warps x 16 rows
constexpr float kNegInf = -1e30f;  // the causal fill of the reference

// The shape of one call. Query row i sits at absolute row row0 + i, and
// the causal mask keeps key j for it iff j <= row0 + i: row0 = 0 for the
// square attention, tk - tq for a band (the diagonal bottom-right
// aligned, as _masked_scores(..., row0=tk - tq) in the reference). Rows
// of every input are contiguous (row stride D); each input has its own
// head stride, so that a band of a longer [BH, T, D] tensor is read in
// place (head stride T * D). Outputs are contiguous.
struct Shape {
  int tq, tk, row0;
  int q_hs, k_hs, v_hs, do_hs;  // head strides of q, k, v, do, in elements
};

inline Shape square_shape(int seq, int d) {
  return Shape{seq, seq, 0, seq * d, seq * d, seq * d, seq * d};
}

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_raw(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// Element type traits: rounding of two floats into one packed register,
// and the tensor-core product for that type.
template <typename T> struct Elem;

template <> struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

template <> struct Elem<__half> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

// Copy rows [first, first + ROWS) of one [rows, D] matrix into shared
// memory (row stride D + 8), 16 bytes a thread, zero-filling rows at or
// past `rows` so that a ragged last tile contributes exact zeros.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(uint16_t* s, const uint16_t* g, int first,
                                          int rows) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (first + r < rows)
      v = *reinterpret_cast<const uint4*>(g + static_cast<size_t>(first + r) * D + c);
    *reinterpret_cast<uint4*>(s + r * (D + 8) + c) = v;
  }
}

// A fragment of rows [row, row + 16), columns [col, col + 16) of a
// row-major shared tile with row stride LD.
template <int LD>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const uint16_t* s, int row,
                                       int col, int g, int t) {
  const uint16_t* p = s + (row + g) * LD + col + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * LD);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * LD + 8);
}

// B fragment for B = M^T, M row-major in shared memory: B[k][n] =
// M[n0 + n][k0 + k]. The pairs along k are contiguous in M.
template <int LD>
__device__ __forceinline__ void frag_b_trans(uint32_t& b0, uint32_t& b1,
                                             const uint16_t* m, int n0, int k0,
                                             int g, int t) {
  const uint16_t* p = m + (n0 + g) * LD + k0 + 2 * t;
  b0 = ld32(p);
  b1 = ld32(p + 8);
}

// B fragment for B = M, M row-major in shared memory: B[k][n] =
// M[k0 + k][n0 + n]. The pairs along k sit in two rows of M.
template <int LD>
__device__ __forceinline__ void frag_b(uint32_t& b0, uint32_t& b1, const uint16_t* m,
                                       int k0, int n0, int g, int t) {
  const uint16_t* p = m + (k0 + 2 * t) * LD + n0 + g;
  b0 = pack_raw(p[0], p[LD]);
  b1 = pack_raw(p[8 * LD], p[9 * LD]);
}

// Max and sum across the four lanes that share a fragment row.
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
