// Flash-attention backward, dk/dv half, for Hopper (sm_90a):
//   p^T  = exp(k q^T * scale - lse)          (masked entries are 0)
//   dv   = p^T do                            (p rounded to the input type)
//   ds^T = p^T * (v do^T - delta) * scale    (rounded to the input type)
//   dk   = ds^T q
// on q, do [BH, tq, D] against k, v [BH, tk, D], D in {64, 128}: the
// square attention (tq = tk, row0 = 0) or one band of the causal split
// (query row i at absolute row row0 + i, row0 = tk - tq); lse and delta
// are [BH, tq] f32, dk and dv [BH, tk, D].
//
// Replaces, of ray_tpu/ops/pallas/flash_attention.py, the dk and dv
// products of the single-block _bwd_fused_kernel (:296, launched by
// _flash_bwd_fused :332), the streaming _bwd_dkv_kernel (:255, launched
// by _flash_bwd :374) and the band kernel _bwd_rect_kernel (:436,
// launched by _rect_core_bwd :504). Blocks on the H100 run in parallel
// with no order, so the backward is split by output (flash_bwd_dq.cu
// holds the dq half): each work item is 64 key rows of one head, whose dk
// and dv are summed over the query tiles in registers. No atomics: the
// result is deterministic.
//
// What bounds it on the H100: four products of 2 * BH * T^2 * D / 2 FLOP
// each (s, dp, dv, dk) against reads of q, k, v, do and writes of dk, dv:
// about 340 FLOP per byte at T = 1024, D = 64, so the tensor cores bound
// it. The design:
//   - A block is one consumer warpgroup and one producer warp, and two
//     blocks share an SM, so that one's elementwise work (exp, ds) runs
//     beside the other's products. (Two consumer warpgroups a block with
//     setmaxnreg measure the same at D = 64, scripts/flash_variants.py.
//     Issuing tile i's s, dp products beside tile i - 1's dv, dk products
//     measured slower: the live accumulators of both products outgrow the
//     registers and ptxas serializes the wgmmas.)
//   - The kernel is persistent: each block walks over (head, key block)
//     items, low key blocks (the most queries) first. k and v are loaded
//     once per item by TMA into one of two buffers; q, do tiles of kBQ
//     rows stream through a ring of kStages stages that runs on across
//     items, with their lse and delta rows (read by the producer warp, lse
//     already in base-2 units), from the item's first causal query tile
//     (max(0, (k0 - row0) / kBQ)) down.
//   - All four products are wgmma with no transposed copy: s^T = k q^T and
//     dp^T = v do^T with both operands in shared memory, K-major; p^T and
//     ds^T, rounded in registers, are the register A operands of dv +=
//     p^T do and dk += ds^T q, with do and q read MN-major through the
//     transpose bit.
//   - The dk and dv accumulators are two 64 x D f32 tiles (64 registers a
//     thread at D = 64, 128 at D = 128); kBQ is 64 at D = 64 and 32 at
//     D = 128, so that the score and dp tiles fit beside them (ptxas'
//     counts: chip_smoke's build lines).
//   - The mask runs only on query tiles that cross the diagonal or the
//     ragged end. Rows past tq and keys past tk are zero-filled by the
//     TMA; a key row that no query reaches gets zeros.
#include "hopper_common.cuh"

namespace rtt {

constexpr int kDkvWGs = 1;            // consumer warpgroups of a block
constexpr int kDkvBK = 64 * kDkvWGs;  // key rows of a block: 64 per consumer warpgroup
using DkvBlock = BlockShape<kDkvWGs>;

template <int D>
struct DkvSmem {
  static constexpr int kBQ = D == 64 ? 64 : 32;  // query rows of one streamed tile
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kKBytes = kDkvBK * D * 2;  // the k (or v) rows of an item
  static constexpr int kQBytes = kBQ * D * 2;     // one q (or do) tile
  static constexpr int kBytes = 2 * 2 * kKBytes + 2 * kStages * kQBytes +
                                2 * kStages * kBQ * 4 + 1024;  // + alignment
};

struct DkvArgs {
  int bh, n_kb, tq, tk, row0, causal;
  float scale, scale_log2;
};

// Work item w of a launch: key block kb of head bh, the low key blocks
// (which see the most queries under the causal mask) first. Sets the
// item's first key row and first query tile; returns its query tiles.
template <int BQ>
__device__ __forceinline__ int dkv_item(const DkvArgs& a, int w, int& bh, int& k0,
                                        int& first) {
  bh = w % a.bh;
  k0 = (w / a.bh) * kDkvBK;
  // Causal: query rows above absolute row k0 (local row k0 - row0) see no
  // key of the block, so tiles wholly above it are skipped.
  first = a.causal ? max(0, (k0 - a.row0) / BQ) : 0;
  return (a.tq + BQ - 1) / BQ;
}

// A persistent kernel: each block takes work items w = blockIdx.x,
// blockIdx.x + gridDim.x, ... (dkv_item). k and v alternate between two
// buffers and the q/do tiles of consecutive items share one ring (a
// running tile count gives each its stage and phase), so that the
// producer loads the next item while the consumers finish this one.
template <typename T, int D>
__global__ void __launch_bounds__(DkvBlock::kThreads, DkvBlock::kMinBlocks)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap do_map,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     uint16_t* __restrict__ dk, uint16_t* __restrict__ dv, DkvArgs a) {
  using S = DkvSmem<D>;
  constexpr int kBQ = S::kBQ;
  constexpr int kStages = S::kStages;
  __shared__ __align__(8) uint64_t kv_full[2], kv_empty[2], q_full[kStages],
      q_empty[kStages];
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ks = align1024(smem_raw);               // buffer b at ks + 2 b kKBytes, v after k
  uint8_t* qs = ks + 4 * S::kKBytes;               // stage s at qs + s * kQBytes
  uint8_t* dos = qs + kStages * S::kQBytes;
  float* lse_s = reinterpret_cast<float*>(dos + kStages * S::kQBytes);  // [kStages][kBQ]
  float* delta_s = lse_s + kStages * kBQ;
  const int n_items = a.bh * a.n_kb;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(&kv_full[b], 1);
      mbar_init(&kv_empty[b], DkvBlock::kConsumerThreads);
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&q_full[s], 32);  // the producer warp's lanes (lse, delta rows)
      mbar_init(&q_empty[s], DkvBlock::kConsumerThreads);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= DkvBlock::kProducerWarp) {
    if constexpr (DkvBlock::kMoveRegs) setmaxnreg_dec<kProducerRegs>();
    if (warp > DkvBlock::kProducerWarp) return;
    int tile = 0;  // q/do tiles this block has loaded
    for (int w = blockIdx.x, n = 0; w < n_items; w += gridDim.x, ++n) {
      int bh, k0, first;
      const int n_qt = dkv_item<kBQ>(a, w, bh, k0, first);
      const int b = n & 1;
      mbar_wait(&kv_empty[b], ((n >> 1) & 1) ^ 1);
      if (lane == 0) {
        uint8_t* kb = ks + 2 * b * S::kKBytes;
        mbar_arrive_expect_tx(&kv_full[b], 2 * S::kKBytes);
        tma_load_tile<D>(kb, kDkvBK, &k_map, &kv_full[b], k0, bh);
        tma_load_tile<D>(kb + S::kKBytes, kDkvBK, &v_map, &kv_full[b], k0, bh);
      }
      const size_t row_base = static_cast<size_t>(bh) * a.tq;
      for (int iq = first; iq < n_qt; ++iq, ++tile) {
        const int s = tile % kStages;
        mbar_wait(&q_empty[s], ((tile / kStages) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(&q_full[s], 2 * S::kQBytes);
          tma_load_tile<D>(qs + s * S::kQBytes, kBQ, &q_map, &q_full[s], iq * kBQ, bh);
          tma_load_tile<D>(dos + s * S::kQBytes, kBQ, &do_map, &q_full[s], iq * kBQ, bh);
        }
        for (int i = lane; i < kBQ; i += 32) {
          const int qrow = iq * kBQ + i;
          const bool ok = qrow < a.tq;
          lse_s[s * kBQ + i] = ok ? lse[row_base + qrow] * kLog2e : 0.f;
          delta_s[s * kBQ + i] = ok ? delta[row_base + qrow] : 0.f;
        }
        mbar_arrive(&q_full[s]);
      }
    }
    return;
  }
  if constexpr (DkvBlock::kMoveRegs) setmaxnreg_inc<kConsumerRegs>();

  // Consumers: warpgroup wg owns key rows [k0 + 64 wg, k0 + 64 wg + 64) of
  // each item.
  const int wg = warp / 4;
  const int g = lane / 4, t = lane % 4;
  float dk_acc[D / 2], dv_acc[D / 2], sc[kBQ / 2], dp[kBQ / 2];
#pragma unroll
  for (int i = 0; i < kBQ / 2; ++i) sc[i] = dp[i] = 0.f;
  uint32_t pa[kBQ / 16][4], dsa[kBQ / 16][4];  // p^T, ds^T: A operands of dv, dk
  int tile = 0;                                // q/do tiles this block has consumed

  for (int w = blockIdx.x, n = 0; w < n_items; w += gridDim.x, ++n) {
    int bh, k0, first;
    const int n_qt = dkv_item<kBQ>(a, w, bh, k0, first);
    const int b = n & 1;
    const int kw = k0 + 64 * wg + 16 * (warp % 4);  // the warp's first key
    const int key[2] = {kw + g, kw + g + 8};
    const uint8_t* k_wg = ks + 2 * b * S::kKBytes + 64 * wg * kRowBytes;
    const uint8_t* v_wg = k_wg + S::kKBytes;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    mbar_wait(&kv_full[b], (n >> 1) & 1);

    for (int iq = first; iq < n_qt; ++iq, ++tile) {
      const int s = tile % kStages;
      const uint8_t* qt = qs + s * S::kQBytes;
      const uint8_t* dot = dos + s * S::kQBytes;
      const float* lse2 = lse_s + s * kBQ;
      const float* dlt = delta_s + s * kBQ;
      mbar_wait(&q_full[s], (tile / kStages) & 1);

      // s^T = k q^T and dp^T = v do^T: the warpgroup's 64 keys x kBQ
      // queries, both operands K-major.
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int pn = kk / 4, off = (kk % 4) * 32;
        wgmma_ss<T, kBQ>(sc, sw128_desc(k_wg + pn * kDkvBK * kRowBytes + off),
                         sw128_desc(qt + pn * kBQ * kRowBytes + off), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int pn = kk / 4, off = (kk % 4) * 32;
        wgmma_ss<T, kBQ>(dp, sw128_desc(v_wg + pn * kDkvBK * kRowBytes + off),
                         sw128_desc(dot + pn * kBQ * kRowBytes + off), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      // p^T = exp(s^T * scale - lse) (0 where masked), then ds^T = p^T *
      // (dp^T - delta) * scale. Queries at or past q_end are masked, and,
      // causal, keys past a query's diagonal.
      const int q0 = iq * kBQ;
      int q_end = a.tq;
      const bool masked = q0 + kBQ > q_end || (a.causal && kw + 15 > a.row0 + q0);
#pragma unroll
      for (int c = 0; c < kBQ / 8; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 8 * c + 2 * t + (e & 1);  // query within the tile
          float p = fast_exp2(fmaf(sc[4 * c + e], a.scale_log2, -lse2[qi]));
          if (masked && (q0 + qi >= q_end || (a.causal && key[e >> 1] > a.row0 + q0 + qi)))
            p = 0.f;
          sc[4 * c + e] = p;
          dp[4 * c + e] = p * (dp[4 * c + e] - dlt[qi]) * a.scale;
        }
      }
      pack_a<T>(pa, sc);
      pack_a<T>(dsa, dp);

      // dv += p^T do, dk += ds^T q (do and q MN-major).
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk) {
#pragma unroll
        for (int pn = 0; pn < D / kPanelCols; ++pn)
          wgmma_rs_mn<T>(dv_acc + 32 * pn, pa[kk],
                         sw128_desc(dot + pn * kBQ * kRowBytes + kk * 16 * kRowBytes), 1);
      }
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk) {
#pragma unroll
        for (int pn = 0; pn < D / kPanelCols; ++pn)
          wgmma_rs_mn<T>(dk_acc + 32 * pn, dsa[kk],
                         sw128_desc(qt + pn * kBQ * kRowBytes + kk * 16 * kRowBytes), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      mbar_arrive(&q_empty[s]);
    }
    mbar_arrive(&kv_empty[b]);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (key[r] >= a.tk) continue;
      const size_t off = (static_cast<size_t>(bh) * a.tk + key[r]) * D;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        *reinterpret_cast<uint32_t*>(dk + off + 8 * i + 2 * t) =
            Elem<T>::pack(dk_acc[4 * i + 2 * r], dk_acc[4 * i + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dv + off + 8 * i + 2 * t) =
            Elem<T>::pack(dv_acc[4 * i + 2 * r], dv_acc[4 * i + 2 * r + 1]);
      }
    }
  }
}

template <typename T, int D>
int launch_bwd_dkv(const uint64_t* maps, const void* lse, const void* delta, void* dk,
                   void* dv, DkvArgs args, cudaStream_t stream) {
  using S = DkvSmem<D>;
  CUtensorMap q_map, k_map, v_map, do_map;
  int err = make_tensor_map<T>(&q_map, maps, D, S::kBQ);
  if (err == 0) err = make_tensor_map<T>(&k_map, maps + kGeoWords, D, kDkvBK);
  if (err == 0) err = make_tensor_map<T>(&v_map, maps + 2 * kGeoWords, D, kDkvBK);
  if (err == 0) err = make_tensor_map<T>(&do_map, maps + 3 * kGeoWords, D, S::kBQ);
  if (err != 0) return err;
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int grid = min(args.bh * args.n_kb, sm_count() * DkvBlock::kMinBlocks);
  kernel<<<grid, DkvBlock::kThreads, S::kBytes, stream>>>(
      q_map, k_map, v_map, do_map, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<uint16_t*>(dk),
      static_cast<uint16_t*>(dv), args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rtt

// dk, dv [BH, tk, D] (contiguous) from q, do [BH, tq, D], k, v [BH, tk,
// D] read through the tensor maps of `maps` (q, k, v, do; see
// make_tensor_map) and lse, delta [BH, tq] (contiguous): the square
// attention with tq = tk, row0 = 0, or one causal band with row0 = tk -
// tq. Returns 0 when the launch was accepted, a cudaError_t, or minus the
// CUresult of a failed tensor-map encode.
extern "C" int rtt_flash_bwd_dkv(const uint64_t* maps, const void* lse, const void* delta,
                                 void* dk, void* dv, int bh, int tq, int tk, int row0, int d,
                                 float scale, int causal, int fp16, void* stream) {
  rtt::DkvArgs args;
  args.bh = bh;
  args.n_kb = (tk + rtt::kDkvBK - 1) / rtt::kDkvBK;
  args.tq = tq;
  args.tk = tk;
  args.row0 = row0;
  args.causal = causal;
  args.scale = scale;
  args.scale_log2 = scale * rtt::kLog2e;
  RTT_DISPATCH(fp16, d, rtt::launch_bwd_dkv, maps, lse, delta, dk, dv, args,
               static_cast<cudaStream_t>(stream));
}
