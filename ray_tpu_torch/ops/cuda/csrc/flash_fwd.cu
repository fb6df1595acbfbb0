// Flash-attention forward for Hopper (sm_90a): o = softmax(q k^T * scale) v
// and lse = m + log(l), causal or not, on q [BH, tq, D] against k, v
// [BH, tk, D] with D in {64, 128}: the square attention of one sequence
// (tq = tk, row0 = 0) or one band of the causal split (tq <= tk, query row
// i at absolute row row0 + i, row0 = tk - tq).
//
// Replaces the Pallas TPU kernels _fwd_single_kernel (flash_attention.py
// :122, launched by _flash_fwd_single :146), _fwd_kernel (:77, launched
// by _flash_fwd :168) and _fwd_rect_kernel (:418, launched by _rect_fwd
// :469) of ray_tpu/ops/pallas/flash_attention.py. The TPU keeps a whole
// 1024-long row of scores (or a whole [tq, tk] band) in VMEM; here a block
// owns 128 query rows and streams 128-row key/value tiles up to the
// diagonal with an online (running max, running sum) softmax.
//
// What bounds it on the H100: at GPT-2 shapes (D = 64, T = 1024) the
// causal work is 4 * BH * T^2 * D / 2 FLOP against 3 reads and 1 write of
// BH * T * D bf16 values, about 250 FLOP per byte, just under the card's
// 295 FLOP/byte ridge: the bytes bound it, the tensor cores nearly so
// (at T = 2048 the operations). The design:
//   - A block is a producer warpgroup and two consumer warpgroups of 64
//     query rows each (BlockShape<2>; setmaxnreg moves the producers'
//     registers to the consumers). Each k/v tile in shared memory serves
//     128 query rows.
//   - The producer loads each q tile once and streams k and v tiles
//     through a ring of kStages stages with TMA (cp.async.bulk.tensor,
//     128-byte swizzle), each stage guarded by full barriers (k, v) and an
//     empty barrier that the consumers release once their products on it
//     are done. Loads run ahead of the products.
//   - The kernel is persistent: one block per SM walks over (head, query
//     tile) items, heaviest first; the ring runs on across items and q
//     has two buffers, so the next item's loads hide behind this one's
//     products and no block pays a cold start.
//   - s = q k^T is one wgmma m64n128k16 per 16 columns of D, both operands
//     in shared memory. The softmax runs on the accumulator registers
//     (base-2 exponent, scale folded in). p, rounded to the input type, is
//     the register A operand of o += p v, with v read MN-major through the
//     transpose bit: no copy of v, no trip of p through shared memory.
//   - Each warpgroup issues s = q k^T of tile j together with p v of tile
//     j - 1, so that the softmax of tile j (exponentials, on the ALUs)
//     runs while the tensor cores finish tile j - 1; and the two
//     warpgroups take turns to issue (ping-pong), so that one's softmax
//     also runs beside the other's products.
//   - Key tiles above the diagonal are skipped; the mask runs only on
//     tiles that cross it or the ragged end. Rows past tq and keys past
//     tk are zero-filled by the TMA.
// A band is read in place through the head strides of its tensor maps.
// Its rows go through the same tiles in the same order as the square
// kernel's when row0 is a multiple of 128 (every band of split 2 and 4),
// so the split's o and lse equal the unsplit kernel's bit for bit.
//
// Rounding follows the reference: scores, max, sum and the accumulator
// are f32; p is rounded to the input type before p.v (:107-109, :429);
// the denominator is guarded at 1e-30.
#include "hopper_common.cuh"

namespace rtt {

constexpr int kFwdWGs = 2;             // consumer warpgroups of a block
constexpr int kFwdBQ = 64 * kFwdWGs;   // query rows of a block: 64 per consumer warpgroup
constexpr int kFwdBK = 128;            // key rows of one k/v tile
using FwdBlock = BlockShape<kFwdWGs>;

template <int D>
struct FwdSmem {
  static constexpr int kStages = D == 64 ? 5 : 2;
  static constexpr int kQBytes = kFwdBQ * D * 2;     // one of the two q buffers
  static constexpr int kTileBytes = kFwdBK * D * 2;  // one k (or v) tile
  static constexpr int kBytes = 2 * kQBytes + 2 * kStages * kTileBytes + 1024;  // + alignment
};

struct FwdArgs {
  int bh, n_qt, tq, tk, row0, causal;
  float scale_log2;  // scale * log2(e): the softmax runs in base 2
};

// Work item w of a launch: query tile qt of head bh, the heaviest tiles
// (the most key tiles under the causal mask) first; returns its key tiles.
__device__ __forceinline__ int fwd_item(const FwdArgs& a, int w, int& bh, int& q0) {
  bh = w % a.bh;
  q0 = (a.n_qt - 1 - w / a.bh) * kFwdBQ;
  const int n_kt = (a.tk + kFwdBK - 1) / kFwdBK;
  // Causal: the tile's last row sits at absolute row row0 + q0 + kFwdBQ - 1.
  return a.causal ? min(n_kt, (a.row0 + q0 + kFwdBQ - 1) / kFwdBK + 1) : n_kt;
}

// Mask columns at or past lim[r] of row r of one 64 x kFwdBK score tile
// (this thread's part; MASK), and take each row's max. Scores stay
// unscaled: scale > 0, so the max commutes with it, and the exponent
// folds it into one FMA.
template <bool MASK>
__device__ __forceinline__ void mask_max(float (&sc)[kFwdBK / 2], const int (&lim)[2], int t,
                                         float (&mx)[2]) {
#pragma unroll
  for (int i = 0; i < kFwdBK / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      if (MASK && 8 * i + 2 * t + (e & 1) >= lim[r]) sc[4 * i + e] = kNegInf;
      mx[r] = fmaxf(mx[r], sc[4 * i + e]);
    }
  }
}

// A persistent kernel: each block takes work items w = blockIdx.x,
// blockIdx.x + gridDim.x, ... (fwd_item). k/v tiles of consecutive items
// share one ring (a running tile count gives each its stage and phase),
// and q alternates between two buffers, so that the producer loads the
// next item while the consumers finish this one.
template <typename T, int D>
__global__ void __launch_bounds__(FwdBlock::kThreads, FwdBlock::kMinBlocks)
flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map, uint16_t* __restrict__ o,
                 float* __restrict__ lse, FwdArgs a) {
  using S = FwdSmem<D>;
  constexpr int kStages = S::kStages;
  __shared__ __align__(8) uint64_t q_full[2], q_empty[2], k_full[kStages], v_full[kStages],
      kv_empty[kStages];
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align1024(smem_raw);              // buffer b at qs + b * kQBytes
  uint8_t* ks = qs + 2 * S::kQBytes;              // stage s at ks + s * kTileBytes
  uint8_t* vs = ks + kStages * S::kTileBytes;
  const int n_items = a.bh * a.n_qt;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(&q_full[b], 1);
      mbar_init(&q_empty[b], FwdBlock::kConsumerThreads);
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&kv_empty[s], FwdBlock::kConsumerThreads);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= FwdBlock::kProducerWarp) {
    if constexpr (FwdBlock::kMoveRegs) setmaxnreg_dec<kProducerRegs>();
    if (warp == FwdBlock::kProducerWarp && lane == 0) {
      int tile = 0;  // k/v tiles this block has loaded
      for (int w = blockIdx.x, n = 0; w < n_items; w += gridDim.x, ++n) {
        int bh, q0;
        const int n_kt = fwd_item(a, w, bh, q0);
        const int b = n & 1;
        mbar_wait(&q_empty[b], ((n >> 1) & 1) ^ 1);
        mbar_arrive_expect_tx(&q_full[b], S::kQBytes);
        tma_load_tile<D>(qs + b * S::kQBytes, kFwdBQ, &q_map, &q_full[b], q0, bh);
        for (int j = 0; j < n_kt; ++j, ++tile) {
          const int s = tile % kStages;
          mbar_wait(&kv_empty[s], ((tile / kStages) & 1) ^ 1);
          mbar_arrive_expect_tx(&k_full[s], S::kTileBytes);
          tma_load_tile<D>(ks + s * S::kTileBytes, kFwdBK, &k_map, &k_full[s], j * kFwdBK, bh);
          mbar_arrive_expect_tx(&v_full[s], S::kTileBytes);
          tma_load_tile<D>(vs + s * S::kTileBytes, kFwdBK, &v_map, &v_full[s], j * kFwdBK, bh);
        }
      }
    }
    return;
  }
  if constexpr (FwdBlock::kMoveRegs) setmaxnreg_inc<kConsumerRegs>();

  // Consumers: warpgroup wg owns query rows [q0 + 64 wg, q0 + 64 wg + 64)
  // of each item.
  const int wg = warp / 4;
  const int g = lane / 4, t = lane % 4;
  float acc[D / 2], sc[kFwdBK / 2];
#pragma unroll
  for (int i = 0; i < kFwdBK / 2; ++i) sc[i] = 0.f;
  uint32_t pa[kFwdBK / 16][4];  // p of the previous tile, the A operand of p v
  int tile = 0;                 // k/v tiles this block has consumed
  // The consumer warpgroups take turns to issue their products (named
  // barriers 1 and 2), so that one's softmax runs beside the other's
  // products.
  auto my_turn = [&] {
    if constexpr (kFwdWGs == 2) named_sync(1 + wg, FwdBlock::kConsumerThreads);
  };
  auto their_turn = [&] {
    if constexpr (kFwdWGs == 2) named_arrive(2 - wg, FwdBlock::kConsumerThreads);
  };
  if (wg == 1) their_turn();  // warpgroup 0 issues first

  for (int w = blockIdx.x, n = 0; w < n_items; w += gridDim.x, ++n) {
    int bh, q0;
    const int n_kt = fwd_item(a, w, bh, q0);
    const int b = n & 1;
    const int wrow0 = q0 + 64 * wg + 16 * (warp % 4);  // the warp's first row
    const int row[2] = {wrow0 + g, wrow0 + g + 8};
    const uint8_t* q_wg = qs + b * S::kQBytes + 64 * wg * kRowBytes;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};  // this thread's share of the row sums

    // One online-softmax step on the scores of key tile j in sc: mask,
    // update m and l, leave p in sc, and set corr to the factor that
    // rescales the accumulator.
    auto softmax = [&](int j, float (&corr)[2]) {
      // Columns at or past lim[r] of this tile are masked for row r: the
      // ragged end of k and, causal, the keys past the row's diagonal.
      const int k0 = j * kFwdBK;
      int lim[2] = {min(a.tk, a.causal ? a.row0 + row[0] + 1 : a.tk) - k0,
                    min(a.tk, a.causal ? a.row0 + row[1] + 1 : a.tk) - k0};
      bool masked = min(a.tk, a.causal ? a.row0 + wrow0 + 1 : a.tk) - k0 < kFwdBK;
      float mx[2] = {kNegInf, kNegInf};
      if (masked)
        mask_max<true>(sc, lim, t, mx);
      else
        mask_max<false>(sc, lim, t, mx);
      // m is the running max in base-2 units (scaled); a row with every
      // column masked so far keeps kNegInf, which no exponent can reach.
      float ms[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(mx[r]) * a.scale_log2);
        corr[r] = fast_exp2(m[r] - m_new);
        m[r] = m_new;
        ms[r] = -m_new;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < kFwdBK / 2; ++i) {
        const float p = fast_exp2(fmaf(sc[i], a.scale_log2, ms[(i >> 1) & 1]));
        sc[i] = p;
        rs[(i >> 1) & 1] += p;
      }
      l[0] = l[0] * corr[0] + rs[0];
      l[1] = l[1] * corr[1] + rs[1];
    };
    // s = q k^T over D, both operands in shared memory.
    auto issue_s = [&](int stage) {
      const uint8_t* kt = ks + stage * S::kTileBytes;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int pn = kk / 4, off = (kk % 4) * 32;
        wgmma_ss<T, kFwdBK>(sc, sw128_desc(q_wg + pn * kFwdBQ * kRowBytes + off),
                            sw128_desc(kt + pn * kFwdBK * kRowBytes + off), kk > 0);
      }
    };
    // acc += p v over the tile's keys, p rounded to the input type (the
    // register A operand), v MN-major.
    auto issue_pv = [&](int stage) {
      const uint8_t* vt = vs + stage * S::kTileBytes;
#pragma unroll
      for (int kk = 0; kk < kFwdBK / 16; ++kk) {
#pragma unroll
        for (int pn = 0; pn < D / kPanelCols; ++pn)
          wgmma_rs_mn<T>(acc + 32 * pn, pa[kk],
                         sw128_desc(vt + pn * kFwdBK * kRowBytes + kk * 16 * kRowBytes), 1);
      }
    };

    mbar_wait(&q_full[b], (n >> 1) & 1);
    mbar_wait(&k_full[tile % kStages], (tile / kStages) & 1);
    my_turn();
    wgmma_fence();
    issue_s(tile % kStages);
    wgmma_commit();
    their_turn();
    wgmma_wait<0>();
    fence_regs(sc);
    float corr[2];
    softmax(0, corr);  // acc is still 0: nothing to rescale
    pack_a<T>(pa, sc);
    // Step j issues s = q k_j^T and acc += p_{j-1} v_{j-1} back to back;
    // the softmax of tile j runs while the tensor cores finish
    // p_{j-1} v_{j-1}.
    for (int j = 1; j < n_kt; ++j) {
      const int cur = tile + j, s = cur % kStages, sp = (cur - 1) % kStages;
      mbar_wait(&k_full[s], (cur / kStages) & 1);
      mbar_wait(&v_full[sp], ((cur - 1) / kStages) & 1);
      fence_regs(acc);
      my_turn();
      wgmma_fence();
      issue_s(s);
      wgmma_commit();
      issue_pv(sp);
      wgmma_commit();
      their_turn();
      wgmma_wait<1>();
      fence_regs(sc);
      softmax(j, corr);
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&kv_empty[sp]);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
      pack_a<T>(pa, sc);
    }
    mbar_arrive(&q_empty[b]);  // the item's last q k^T is done
    const int last = tile + n_kt - 1, sl = last % kStages;
    mbar_wait(&v_full[sl], (last / kStages) & 1);
    fence_regs(acc);
    my_turn();
    wgmma_fence();
    issue_pv(sl);
    wgmma_commit();
    their_turn();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&kv_empty[sl]);
    tile += n_kt;

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float lr = fmaxf(quad_sum(l[r]), 1e-30f);
      if (row[r] >= a.tq) continue;
      const float inv = 1.f / lr;
      const size_t out_row = static_cast<size_t>(bh) * a.tq + row[r];
      uint16_t* orow = o + out_row * D;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        *reinterpret_cast<uint32_t*>(orow + 8 * i + 2 * t) =
            Elem<T>::pack(acc[4 * i + 2 * r] * inv, acc[4 * i + 2 * r + 1] * inv);
      }
      if (t == 0) lse[out_row] = (m[r] + log2f(lr)) * kLn2;
    }
  }
}

template <typename T, int D>
int launch_fwd(const uint64_t* maps, void* o, void* lse, FwdArgs args, cudaStream_t stream) {
  using S = FwdSmem<D>;
  CUtensorMap q_map, k_map, v_map;
  int err = make_tensor_map<T>(&q_map, maps, D, kFwdBQ);
  if (err == 0) err = make_tensor_map<T>(&k_map, maps + kGeoWords, D, kFwdBK);
  if (err == 0) err = make_tensor_map<T>(&v_map, maps + 2 * kGeoWords, D, kFwdBK);
  if (err != 0) return err;
  auto kernel = flash_fwd_kernel<T, D>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int grid = min(args.bh * args.n_qt, sm_count() * FwdBlock::kMinBlocks);
  kernel<<<grid, FwdBlock::kThreads, S::kBytes, stream>>>(
      q_map, k_map, v_map, static_cast<uint16_t*>(o), static_cast<float*>(lse), args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rtt

// o [BH, tq, D] and lse [BH, tq] (contiguous) of q [BH, tq, D] against k,
// v [BH, tk, D], read through the tensor maps of `maps` (q, k, v; see
// make_tensor_map): the square attention with tq = tk, row0 = 0, or one
// causal band with row0 = tk - tq. Returns 0 when the launch was accepted,
// a cudaError_t, or minus the CUresult of a failed tensor-map encode.
extern "C" int rtt_flash_fwd(const uint64_t* maps, void* o, void* lse, int bh, int tq,
                             int tk, int row0, int d, float scale, int causal, int fp16,
                             void* stream) {
  rtt::FwdArgs args;
  args.bh = bh;
  args.n_qt = (tq + rtt::kFwdBQ - 1) / rtt::kFwdBQ;
  args.tq = tq;
  args.tk = tk;
  args.row0 = row0;
  args.causal = causal;
  args.scale_log2 = scale * rtt::kLog2e;
  RTT_DISPATCH(fp16, d, rtt::launch_fwd, maps, o, lse, args,
               static_cast<cudaStream_t>(stream));
}
