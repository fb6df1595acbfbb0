// Hopper (sm_90a) building blocks of the flash-attention kernels
// (flash_fwd.cu, flash_bwd_dq.cu, flash_bwd_dkv.cu), as inline PTX:
// mbarriers, TMA tile loads, wgmma descriptors and products; and, on the
// host, the encoding of a tensor map from the geometry the Python wrapper
// computes (flash_attention.tensor_map_geometry).
//
// Layout: the query-side tensors q, o, do, dq are [BH, tq, D] and the
// key-side tensors k, v, dk, dv are [BH, tk, D], rows contiguous, in bf16
// or fp16; lse and delta are [BH, tq] float32. Query row i sits at
// absolute row row0 + i, and the causal mask keeps key j for it iff j <=
// row0 + i: row0 = 0 for the square attention of one sequence (tq = tk),
// tk - tq for a band of the causal split (Pallas _rect_fwd /
// _rect_core_bwd; the diagonal bottom-right aligned, as
// _masked_scores(..., row0=tk - tq) in the reference). Each input is read
// through its own tensor map with its own head stride, so that a band of
// a longer [BH, T, D] tensor is read in place; outputs are contiguous.
//
// Tiles in shared memory are what a TMA load with
// CU_TENSOR_MAP_SWIZZLE_128B writes: a box of 64 columns (128 bytes of
// bf16/fp16) by R rows, row r at byte 128 * r, its 16-byte chunk c stored
// at chunk c ^ (r % 8). A head dim of 128 is two such boxes ("panels"),
// columns [0, 64) and [64, 128), one after the other. Every tile starts on
// a 1024-byte boundary, the period of the swizzle. wgmma reads these
// tiles through descriptors of the same 128-byte swizzle:
//   - K-major (the reduction index contiguous): q and k in q k^T, k and q
//     in k q^T, v and do in v do^T and do v^T. An 8-row group is 1024
//     bytes (SBO); a k16 step within a 64-column panel adds 32 bytes to
//     the start.
//   - MN-major (the output index contiguous, the transpose bit set): v in
//     p v, do in p^T do, q in ds^T q, k in ds k. The k16 step is 16 rows (2048
//     bytes); 8-row groups are 1024 bytes apart (SBO); each 64-column
//     panel is its own 64-wide product.
// Register layouts of wgmma m64nNk16 (warp w of the warpgroup owns rows
// 16w..16w+15; g = lane / 4, t = lane % 4): the f32 accumulator holds,
// for each 8-column chunk i, d[4i..4i+1] = D[g][8i+2t..8i+2t+1] and
// d[4i+2..4i+3] = D[g+8][8i+2t..]; the register A operand of one k16 step
// is the mma.sync m16n8k16 A fragment (a0 = A[g][2t..2t+1], a1 =
// A[g+8][2t..], a2 = A[g][2t+8..], a3 = A[g+8][2t+8..]). So the
// accumulator of one product, packed to the input type chunk pair by
// chunk pair (pack_a), is the A operand of the next.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no libcuda link)
#include <type_traits>

#include "flash_common.cuh"

namespace rtt {

// A block of the TMA kernels: WGS consumer warpgroups and a producer. With
// two, the producer is a warpgroup (one warp of it issues the loads) and
// setmaxnreg moves its registers to the consumers: ptxas gives each of the
// 384 threads 168 (__launch_bounds__(384, 1)), the producers keep
// kProducerRegs and the consumers take kConsumerRegs, 128 * 40 + 256 * 232
// = 384 * 168. With one, the producer is a single warp and two blocks
// share an SM, each thread with up to 200 registers.
template <int WGS>
struct BlockShape {
  static_assert(WGS == 1 || WGS == 2, "one or two consumer warpgroups");
  static constexpr int kConsumerThreads = 128 * WGS;
  static constexpr int kProducerWarp = kConsumerThreads / 32;
  static constexpr int kThreads = kConsumerThreads + (WGS == 2 ? 128 : 32);
  static constexpr int kMinBlocks = WGS == 2 ? 1 : 2;
  static constexpr bool kMoveRegs = WGS == 2;
};
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kPanelCols = 64;                      // columns of one TMA box
constexpr int kRowBytes = 128;                      // bytes of one box row
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// A wait this long (clock cycles, ~10 s) is a fault: trap, so that a broken
// pipeline ends the launch with an error instead of hanging the card.
constexpr long long kHangCycles = 1ll << 34;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte boundary at or after p (in the shared window).
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Set this warpgroup's registers per thread (every thread of the warpgroup
// executes it).
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// Named barrier `id` (1..15; 0 is __syncthreads) over `threads` threads:
// sync waits for all of them, arrive counts this thread and goes on.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------- mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// Makes the initialised barriers visible to every thread and to the TMA
// unit; a __syncthreads() follows it.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The current phase also waits for `bytes` more bytes of TMA writes.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Arrive, with release semantics: this thread's earlier shared-memory
// writes (and reads) are ordered before the phase completes.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` has completed (the first phase
// is 0; waiting on parity 1 of a fresh barrier returns at once).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  if (mbar_try_wait(a, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(a, parity)) {
    if (clock64() - t0 > kHangCycles) __trap();
  }
}

// --------------------------------------------------------------------- TMA

// One box of a 3-D tensor map (columns, rows, heads) into shared memory at
// dst, counted on bar's transaction count. Rows past the map's row count
// are zero-filled by the hardware.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int col, int row, int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(col), "r"(row), "r"(head)
      : "memory");
}

// Every 64-column panel of rows [row, row + rows) of one head of `map`
// into the panels of dst (rows * 128 bytes each).
template <int D>
__device__ __forceinline__ void tma_load_tile(uint8_t* dst, int rows, const CUtensorMap* map,
                                              uint64_t* bar, int row, int head) {
#pragma unroll
  for (int p = 0; p < D / kPanelCols; ++p)
    tma_load_3d(dst + p * rows * kRowBytes, map, bar, p * kPanelCols, row, head);
}

// ------------------------------------------------------------------- wgmma

// Descriptor of a 128-byte-swizzled shared-memory operand starting at p:
// 8-row groups 1024 bytes apart (SBO); LBO is unused by these layouts.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4)            // start address, 16-byte units
         | (uint64_t(1) << 16)              // LBO (unused)
         | (uint64_t(1024 >> 4) << 32)      // SBO
         | (uint64_t(1) << 62);             // layout: 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Tells the compiler the registers change here, so that no read of an
// accumulator moves above the wgmma wait before it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// The products, one macro per shape: PTX names every accumulator
// register as its own operand. AB is the input type, "bf16" or "f16".
// D[64 x 32] (+)= A[64 x 16] B[16 x 32], A and B in shared memory, both K-major.
#define RTT_WGMMA_SS_32(AB) \
  asm volatile(  \
    "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n" \
    "wgmma.mma_async.sync.aligned.m64n32k16.f32." AB "." AB " " \
    "{"  \
    "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15" \
    "}, %16, %17, p, 1, 1, 0, 0;\n}\n" \
    : \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),\
    "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
    : "l"(da), "l"(db), "r"(accumulate))

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B in shared memory, both K-major.
#define RTT_WGMMA_SS_64(AB) \
  asm volatile(  \
    "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
    "wgmma.mma_async.sync.aligned.m64n64k16.f32." AB "." AB " " \
    "{"  \
    "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
    "}, %32, %33, p, 1, 1, 0, 0;\n}\n" \
    : \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),\
    "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),\
    "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),\
    "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
    : "l"(da), "l"(db), "r"(accumulate))

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B in shared memory, both K-major.
#define RTT_WGMMA_SS_128(AB) \
  asm volatile(  \
    "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
    "wgmma.mma_async.sync.aligned.m64n128k16.f32." AB "." AB " " \
    "{"  \
    "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31," \
    "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
    "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" \
    "}, %64, %65, p, 1, 1, 0, 0;\n}\n" \
    : \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),\
    "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),\
    "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),\
    "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),\
    "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),\
    "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),\
    "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),\
    "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
    : "l"(da), "l"(db), "r"(accumulate))

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A in registers (a[0..3], the
// accumulator layout packed to the input type), B in shared memory MN-major
// (the transpose bit set: B's N index is the contiguous one).
#define RTT_WGMMA_RS_64_TN(AB) \
  asm volatile(  \
    "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
    "wgmma.mma_async.sync.aligned.m64n64k16.f32." AB "." AB " " \
    "{"  \
    "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
    "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n" \
    : \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),\
    "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),\
    "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),\
    "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
    : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate))


// d[64 x N] (+)= A B over one k16 step, A (64 x 16) and B (16 x N) in
// shared memory, both K-major; accumulate = 0 overwrites d.
template <typename T, int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int accumulate) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma_ss: N in {32, 64, 128}");
  if constexpr (std::is_same_v<T, __half>) {
    if constexpr (N == 32) RTT_WGMMA_SS_32("f16");
    else if constexpr (N == 64) RTT_WGMMA_SS_64("f16");
    else RTT_WGMMA_SS_128("f16");
  } else {
    if constexpr (N == 32) RTT_WGMMA_SS_32("bf16");
    else if constexpr (N == 64) RTT_WGMMA_SS_64("bf16");
    else RTT_WGMMA_SS_128("bf16");
  }
}

// d[64 x 64] (+)= A B over one k16 step, A in registers, B (16 x 64) in
// shared memory MN-major. d points at 32 accumulator registers.
template <typename T>
__device__ __forceinline__ void wgmma_rs_mn(float* d, const uint32_t (&a)[4], uint64_t db,
                                            int accumulate) {
  if constexpr (std::is_same_v<T, __half>) RTT_WGMMA_RS_64_TN("f16");
  else RTT_WGMMA_RS_64_TN("bf16");
}

// The A operands of the k16 steps of a product whose reduction index is
// the column index of acc (a 64 x 16 S accumulator): chunk pair (2s, 2s+1)
// packed to the input type.
template <typename T, int S>
__device__ __forceinline__ void pack_a(uint32_t (&a)[S][4], const float (&acc)[8 * S]) {
#pragma unroll
  for (int s = 0; s < S; ++s) {
#pragma unroll
    for (int j = 0; j < 4; ++j) a[s][j] = Elem<T>::pack(acc[8 * s + 2 * j], acc[8 * s + 2 * j + 1]);
  }
}

// ------------------------------------------------------------------- host

// SMs of the current card (queried once per process): a persistent
// kernel launches this many blocks times the blocks that fit on one.
inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 1;
  }
  return sms;
}

// Geometry of one tensor map, as flash_attention.tensor_map_geometry
// gives it: address, dims (D, rows, BH), byte strides (row, head), box
// (64, box rows, 1).
constexpr int kGeoWords = 9;

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda).
inline int encode_tiled_fn(EncodeTiledFn* out) {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 13000
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess || ptr == nullptr)
      return static_cast<int>(cudaErrorSymbolNotFound);
    fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  *out = fn;
  return 0;
}

// Encode the tensor map of geometry g for element type T. Returns 0, a
// cudaError_t (> 0; cudaErrorInvalidValue when g does not match the
// kernel's head dim d and box rows), or minus the CUresult of a failed
// encode.
template <typename T>
int make_tensor_map(CUtensorMap* map, const uint64_t* g, int d, int box_rows) {
  if (g[1] != static_cast<uint64_t>(d) || g[6] != kPanelCols ||
      g[7] != static_cast<uint64_t>(box_rows) || g[8] != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  EncodeTiledFn encode;
  const int err = encode_tiled_fn(&encode);
  if (err != 0) return err;
  const cuuint64_t dims[3] = {g[1], g[2], g[3]};
  const cuuint64_t strides[2] = {g[4], g[5]};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(g[6]), static_cast<cuuint32_t>(g[7]),
                             static_cast<cuuint32_t>(g[8])};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUtensorMapDataType type = std::is_same_v<T, __half>
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUresult r = encode(map, type, 3, reinterpret_cast<void*>(g[0]), dims, strides, box,
                            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -static_cast<int>(r);
}

}  // namespace rtt
