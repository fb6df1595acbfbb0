// Flash-attention backward, dq half, for Hopper (sm_90a):
//   p  = exp(q k^T * scale - lse)            (masked entries are 0)
//   ds = p * (do v^T - delta) * scale        (rounded to the input type)
//   dq = ds k                                (accumulated in f32)
// on q, do [BH, tq, D] against k, v [BH, tk, D], D in {64, 128}: the
// square attention (tq = tk, row0 = 0) or one band of the causal split
// (query row i at absolute row row0 + i, row0 = tk - tq); lse and delta
// are [BH, tq] f32, dq [BH, tq, D].
//
// Replaces, of ray_tpu/ops/pallas/flash_attention.py, the dq product of
// the single-block _bwd_fused_kernel (:296, launched by _flash_bwd_fused
// :332), the streaming _bwd_dq_kernel (:218, launched by _flash_bwd
// :355) and the dq product of the band kernel _bwd_rect_kernel (:436,
// launched by _rect_core_bwd :504). Blocks on the H100 run in parallel
// with no order, so the backward is split by output (flash_bwd_dkv.cu
// holds the dk/dv half): each work item is a query tile of one head,
// whose dq is summed over the key tiles in registers, in one fixed order.
// No atomics: the result is deterministic.
//
// What bounds it on the H100: three products of 2 * BH * T^2 * D / 2
// FLOP each (s, dp, ds k) against reads of q, k, v, do and a write of dq:
// about 300 FLOP per byte at T = 1024, D = 64, just over the card's 295
// FLOP/byte ridge, so the tensor cores bound it, barely. The design:
//   - A block is a producer warpgroup and two consumer warpgroups of 64
//     query rows each (BlockShape<2>; setmaxnreg moves the producers'
//     registers to the consumers), so each k/v tile in shared memory
//     serves 128 query rows. The dq accumulator is one 64 x D f32 tile a
//     warpgroup (32 registers a thread at D = 64, 64 at D = 128), half of
//     dk/dv's two, which leaves room for the overlap below.
//   - The kernel is persistent: each block walks over (head, query tile)
//     items, the heaviest tiles (the most keys under the causal mask)
//     first. One producer warp loads the item's q and do tiles by TMA into
//     one of two buffers, with its lse (in base-2 units) and delta rows,
//     and streams the k and v tiles through a ring of kStages mbarrier
//     stages that runs on across items (a running tile count gives each
//     tile its stage and phase). Key tiles wholly above the diagonal are
//     never loaded.
//   - All three products are wgmma with no transposed copy: s = q k^T and
//     dp = do v^T with both operands K-major in the 128-byte-swizzled
//     tiles; ds, computed in registers (base-2 exponent, scale folded into
//     its FMA) and rounded to the input type, is the register A operand
//     of dq += ds k, with k read MN-major through the transpose bit from
//     the same tile that served q k^T.
//   - Each warpgroup issues tile j's s and dp beside tile j - 1's ds k
//     (kDqOverlap), so that the exponentials of tile j run on the ALUs
//     while the tensor cores finish tile j - 1.
//   - The mask runs only on key tiles that cross the diagonal or the
//     ragged end. TMA zero-fills rows past tq and tk, but a zero k row
//     gives p = exp(-lse) != 0, so keys at or past tk are masked
//     explicitly; query rows at or past tq are not stored.
// A band is read in place through the head strides of its tensor maps.
// When kDqBQ divides row0 (every band of split 2 and 4: row0 is a
// multiple of 256), a band's rows meet the same key tiles in the same
// order as in the square kernel, so the split's dq equals the unsplit
// kernel's bit for bit.
#include "hopper_common.cuh"

namespace rtt {

constexpr int kDqWGs = 2;             // consumer warpgroups of a block
constexpr int kDqBQ = 64 * kDqWGs;    // query rows of an item: 64 per consumer warpgroup
constexpr bool kDqOverlap = true;     // tile j's s, dp issued beside tile j - 1's ds k
using DqBlock = BlockShape<kDqWGs>;

template <int D>
struct DqSmem {
  static constexpr int kBK = D == 64 ? 128 : 64;  // key rows of one k/v tile
  static constexpr int kStages = D == 64 ? 4 : 2;
  static constexpr int kQBytes = kDqBQ * D * 2;   // one q (or do) tile
  static constexpr int kTileBytes = kBK * D * 2;  // one k (or v) tile
  static constexpr int kBytes = 2 * 2 * kQBytes + 2 * kStages * kTileBytes +
                                2 * 2 * kDqBQ * 4 + 1024;  // + lse, delta; + alignment
};

struct DqArgs {
  int bh, n_qt, tq, tk, row0, causal;
  float scale, scale_log2;
};

// Work item w of a launch: query tile qt of head bh, the heaviest tiles
// first. Sets the item's first query row; returns its key tiles.
template <int BK>
__device__ __forceinline__ int dq_item(const DqArgs& a, int w, int& bh, int& q0) {
  bh = w % a.bh;
  q0 = (a.n_qt - 1 - w / a.bh) * kDqBQ;
  const int n_kt = (a.tk + BK - 1) / BK;
  // Causal: the tile's last row sits at absolute row row0 + q0 + kDqBQ - 1.
  return a.causal ? min(n_kt, (a.row0 + q0 + kDqBQ - 1) / BK + 1) : n_kt;
}

// A persistent kernel: each block takes work items w = blockIdx.x,
// blockIdx.x + gridDim.x, ... (dq_item). q and do alternate between two
// buffers and the k/v tiles of consecutive items share one ring, so that
// the producer loads the next item while the consumers finish this one.
template <typename T, int D>
__global__ void __launch_bounds__(DqBlock::kThreads, DqBlock::kMinBlocks)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __grid_constant__ CUtensorMap do_map,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    uint16_t* __restrict__ dq, DqArgs a) {
  using S = DqSmem<D>;
  constexpr int kBK = S::kBK;
  constexpr int kStages = S::kStages;
  __shared__ __align__(8) uint64_t q_full[2], q_empty[2], kv_full[kStages],
      kv_empty[kStages];
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align1024(smem_raw);            // buffer b at qs + b * kQBytes
  uint8_t* dos = qs + 2 * S::kQBytes;           // buffer b at dos + b * kQBytes
  uint8_t* ks = dos + 2 * S::kQBytes;           // stage s at ks + s * kTileBytes
  uint8_t* vs = ks + kStages * S::kTileBytes;
  float* lse_s = reinterpret_cast<float*>(vs + kStages * S::kTileBytes);  // [2][kDqBQ]
  float* delta_s = lse_s + 2 * kDqBQ;
  const int n_items = a.bh * a.n_qt;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(&q_full[b], 32);  // the producer warp's lanes (lse, delta rows)
      mbar_init(&q_empty[b], DqBlock::kConsumerThreads);
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&kv_full[s], 1);
      mbar_init(&kv_empty[s], DqBlock::kConsumerThreads);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= DqBlock::kProducerWarp) {
    if constexpr (DqBlock::kMoveRegs) setmaxnreg_dec<kProducerRegs>();
    if (warp > DqBlock::kProducerWarp) return;
    int tile = 0;  // k/v tiles this block has loaded
    for (int w = blockIdx.x, n = 0; w < n_items; w += gridDim.x, ++n) {
      int bh, q0;
      const int n_kt = dq_item<kBK>(a, w, bh, q0);
      const int b = n & 1;
      mbar_wait(&q_empty[b], ((n >> 1) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(&q_full[b], 2 * S::kQBytes);
        tma_load_tile<D>(qs + b * S::kQBytes, kDqBQ, &q_map, &q_full[b], q0, bh);
        tma_load_tile<D>(dos + b * S::kQBytes, kDqBQ, &do_map, &q_full[b], q0, bh);
      }
      const size_t row_base = static_cast<size_t>(bh) * a.tq;
      for (int i = lane; i < kDqBQ; i += 32) {
        const int qrow = q0 + i;
        const bool ok = qrow < a.tq;
        lse_s[b * kDqBQ + i] = ok ? lse[row_base + qrow] * kLog2e : 0.f;
        delta_s[b * kDqBQ + i] = ok ? delta[row_base + qrow] : 0.f;
      }
      mbar_arrive(&q_full[b]);
      for (int j = 0; j < n_kt; ++j, ++tile) {
        const int s = tile % kStages;
        mbar_wait(&kv_empty[s], ((tile / kStages) & 1) ^ 1);
        if (lane == 0) {
          mbar_arrive_expect_tx(&kv_full[s], 2 * S::kTileBytes);
          tma_load_tile<D>(ks + s * S::kTileBytes, kBK, &k_map, &kv_full[s], j * kBK, bh);
          tma_load_tile<D>(vs + s * S::kTileBytes, kBK, &v_map, &kv_full[s], j * kBK, bh);
        }
      }
    }
    return;
  }
  if constexpr (DqBlock::kMoveRegs) setmaxnreg_inc<kConsumerRegs>();

  // Consumers: warpgroup wg owns query rows [q0 + 64 wg, q0 + 64 wg + 64)
  // of each item.
  const int wg = warp / 4;
  const int g = lane / 4, t = lane % 4;
  float acc[D / 2], sc[kBK / 2], dp[kBK / 2];
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) sc[i] = dp[i] = 0.f;
  uint32_t dsa[kBK / 16][4];  // ds of a tile, the A operand of ds k
  int tile = 0;               // k/v tiles this block has consumed

  for (int w = blockIdx.x, n = 0; w < n_items; w += gridDim.x, ++n) {
    int bh, q0;
    const int n_kt = dq_item<kBK>(a, w, bh, q0);
    const int b = n & 1;
    const int wrow0 = q0 + 64 * wg + 16 * (warp % 4);  // the warp's first row
    const int row[2] = {wrow0 + g, wrow0 + g + 8};
    const uint8_t* q_wg = qs + b * S::kQBytes + 64 * wg * kRowBytes;
    const uint8_t* do_wg = dos + b * S::kQBytes + 64 * wg * kRowBytes;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    mbar_wait(&q_full[b], (n >> 1) & 1);
    float lse2[2], dlt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lse2[r] = lse_s[b * kDqBQ + row[r] - q0];
      dlt[r] = delta_s[b * kDqBQ + row[r] - q0];
    }

    // s = q k^T and dp = do v^T over D, both operands K-major.
    auto issue_s_dp = [&](int stage) {
      const uint8_t* kt = ks + stage * S::kTileBytes;
      const uint8_t* vt = vs + stage * S::kTileBytes;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int pn = kk / 4, off = (kk % 4) * 32;
        wgmma_ss<T, kBK>(sc, sw128_desc(q_wg + pn * kDqBQ * kRowBytes + off),
                         sw128_desc(kt + pn * kBK * kRowBytes + off), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int pn = kk / 4, off = (kk % 4) * 32;
        wgmma_ss<T, kBK>(dp, sw128_desc(do_wg + pn * kDqBQ * kRowBytes + off),
                         sw128_desc(vt + pn * kBK * kRowBytes + off), kk > 0);
      }
    };
    // acc += ds k over the tile's keys: ds the register A operand, k
    // MN-major.
    auto issue_dq = [&](int stage) {
      const uint8_t* kt = ks + stage * S::kTileBytes;
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
        for (int pn = 0; pn < D / kPanelCols; ++pn)
          wgmma_rs_mn<T>(acc + 32 * pn, dsa[kk],
                         sw128_desc(kt + pn * kBK * kRowBytes + kk * 16 * kRowBytes), 1);
      }
    };
    // p = exp(s * scale - lse) (0 where masked), then ds = p * (dp -
    // delta) * scale, left in sc. Columns at or past lim[r] of key tile j
    // are masked for row r: keys at or past tk and, causal, the keys past
    // the row's diagonal.
    auto ds_tile = [&](int j) {
      const int k0 = j * kBK;
      int lim[2] = {min(a.tk, a.causal ? a.row0 + row[0] + 1 : a.tk) - k0,
                    min(a.tk, a.causal ? a.row0 + row[1] + 1 : a.tk) - k0};
      bool masked = min(a.tk, a.causal ? a.row0 + wrow0 + 1 : a.tk) - k0 < kBK;
#pragma unroll
      for (int i = 0; i < kBK / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float p = fast_exp2(fmaf(sc[4 * i + e], a.scale_log2, -lse2[r]));
          if (masked && 8 * i + 2 * t + (e & 1) >= lim[r]) p = 0.f;
          sc[4 * i + e] = p * (dp[4 * i + e] - dlt[r]) * a.scale;
        }
      }
    };

    if constexpr (kDqOverlap) {
      // Step j issues s, dp of tile j and acc += ds k of tile j - 1 back
      // to back; ds of tile j is computed while the tensor cores finish
      // tile j - 1.
      const int s0 = tile % kStages;
      mbar_wait(&kv_full[s0], (tile / kStages) & 1);
      wgmma_fence();
      issue_s_dp(s0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      ds_tile(0);
      pack_a<T>(dsa, sc);
      for (int j = 1; j < n_kt; ++j) {
        const int cur = tile + j, s = cur % kStages, sp = (cur - 1) % kStages;
        mbar_wait(&kv_full[s], (cur / kStages) & 1);
        fence_regs(acc);
        wgmma_fence();
        issue_s_dp(s);
        wgmma_commit();
        issue_dq(sp);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(sc);
        fence_regs(dp);
        ds_tile(j);
        wgmma_wait<0>();
        fence_regs(acc);
        mbar_arrive(&kv_empty[sp]);
        pack_a<T>(dsa, sc);
      }
      mbar_arrive(&q_empty[b]);  // the item's last s, dp and lse, delta reads are done
      const int sl = (tile + n_kt - 1) % kStages;
      fence_regs(acc);
      wgmma_fence();
      issue_dq(sl);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&kv_empty[sl]);
    } else {
      for (int j = 0; j < n_kt; ++j) {
        const int cur = tile + j, s = cur % kStages;
        mbar_wait(&kv_full[s], (cur / kStages) & 1);
        wgmma_fence();
        issue_s_dp(s);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(dp);
        ds_tile(j);
        if (j == n_kt - 1) mbar_arrive(&q_empty[b]);
        pack_a<T>(dsa, sc);
        fence_regs(acc);
        wgmma_fence();
        issue_dq(s);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        mbar_arrive(&kv_empty[s]);
      }
    }
    tile += n_kt;

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row[r] >= a.tq) continue;
      uint16_t* out = dq + (static_cast<size_t>(bh) * a.tq + row[r]) * D;
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<uint32_t*>(out + 8 * i + 2 * t) =
            Elem<T>::pack(acc[4 * i + 2 * r], acc[4 * i + 2 * r + 1]);
    }
  }
}

template <typename T, int D>
int launch_bwd_dq(const uint64_t* maps, const void* lse, const void* delta, void* dq,
                  DqArgs args, cudaStream_t stream) {
  using S = DqSmem<D>;
  CUtensorMap q_map, k_map, v_map, do_map;
  int err = make_tensor_map<T>(&q_map, maps, D, kDqBQ);
  if (err == 0) err = make_tensor_map<T>(&k_map, maps + kGeoWords, D, S::kBK);
  if (err == 0) err = make_tensor_map<T>(&v_map, maps + 2 * kGeoWords, D, S::kBK);
  if (err == 0) err = make_tensor_map<T>(&do_map, maps + 3 * kGeoWords, D, kDqBQ);
  if (err != 0) return err;
  auto kernel = flash_bwd_dq_kernel<T, D>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int grid = min(args.bh * args.n_qt, sm_count() * DqBlock::kMinBlocks);
  kernel<<<grid, DqBlock::kThreads, S::kBytes, stream>>>(
      q_map, k_map, v_map, do_map, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<uint16_t*>(dq), args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rtt

// dq [BH, tq, D] (contiguous) from q, do [BH, tq, D], k, v [BH, tk, D]
// read through the tensor maps of `maps` (q, k, v, do; see
// make_tensor_map) and lse, delta [BH, tq] (contiguous): the square
// attention with tq = tk, row0 = 0, or one causal band with row0 = tk -
// tq. Returns 0 when the launch was accepted, a cudaError_t, or minus the
// CUresult of a failed tensor-map encode.
extern "C" int rtt_flash_bwd_dq(const uint64_t* maps, const void* lse, const void* delta,
                                void* dq, int bh, int tq, int tk, int row0, int d,
                                float scale, int causal, int fp16, void* stream) {
  rtt::DqArgs args;
  args.bh = bh;
  args.n_qt = (tq + rtt::kDqBQ - 1) / rtt::kDqBQ;
  args.tq = tq;
  args.tk = tk;
  args.row0 = row0;
  args.causal = causal;
  args.scale = scale;
  args.scale_log2 = scale * rtt::kLog2e;
  RTT_DISPATCH(fp16, d, rtt::launch_bwd_dq, maps, lse, delta, dq, args,
               static_cast<cudaStream_t>(stream));
}
