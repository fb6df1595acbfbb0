// Flash-attention forward for Hopper (sm_90a): o = softmax(q k^T * scale) v
// and lse = m + log(l), causal or not, on [BH, T, D] with D in {64, 128},
// and on one rectangular band of the causal split (q [BH, tq, D], k and v
// [BH, tk, D], the diagonal at row0 = tk - tq; see Shape).
//
// Replaces the Pallas TPU kernels _fwd_single_kernel (flash_attention.py
// :122, launched by _flash_fwd_single :146), _fwd_kernel (:77, launched
// by _flash_fwd :168) and _fwd_rect_kernel (:418, launched by _rect_fwd
// :469) of ray_tpu/ops/pallas/flash_attention.py. The TPU keeps a whole
// 1024-long row of scores (or a whole [tq, tk] band) in VMEM; here a row
// block of f32 scores does not fit in shared memory, so one streaming
// kernel serves all three: each block owns 64 query rows and walks 64-row
// key tiles up to the diagonal with an online (running max, running sum)
// softmax. A band is the same arithmetic, row for row, as the square
// kernel on the rows it covers: when row0 is a multiple of 64 its blocks
// visit the same key tiles in the same order, so its o and lse equal the
// square kernel's bit for bit.
//
// What bounds it on the H100: at GPT-2 shapes (D = 64, T = 1024) the
// causal work is 4 * BH * T^2 * D / 2 FLOP against 3 reads and 1 write of
// BH * T * D bf16 values, about 250 FLOP per byte, which sits just under
// the card's 295 FLOP/byte ridge: the bound is the bytes, the tensor
// cores nearly so. A band of tq rows does 4 * BH * D * (tq * row0 +
// tq^2 / 2) FLOP on 2 * tq + 2 * tk rows. The design keeps the score
// tile, the probabilities and the output accumulator in registers (never
// in device memory), reads each key/value tile once per query tile
// through shared memory, and skips key tiles above the diagonal. Query
// tiles run heaviest first so the causal imbalance does not leave a tail.
// Bands are read in place through per-input head strides. It uses
// mma.sync, not wgmma/TMA; those are for a later, faster version.
//
// Rounding follows the reference: scores, max, sum and the accumulator
// are f32; p is rounded to the input type before p.v (:107-109, :429);
// the denominator is guarded at 1e-30.
#include "flash_common.cuh"

namespace rtt {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                 const uint16_t* __restrict__ v, uint16_t* __restrict__ o,
                 float* __restrict__ lse, Shape sh, float scale, int causal) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* qs = smem;
  uint16_t* ks = qs + kTile * LD;
  uint16_t* vs = ks + kTile * LD;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // heaviest tiles first
  const uint16_t* qh = q + static_cast<size_t>(bh) * sh.q_hs;
  const uint16_t* kh = k + static_cast<size_t>(bh) * sh.k_hs;
  const uint16_t* vh = v + static_cast<size_t>(bh) * sh.v_hs;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = warp * 16;                 // the warp's rows within the tile
  const int row[2] = {q0 + wr + g, q0 + wr + g + 8};

  load_tile<D, kTile>(qs, qh, q0, sh.tq);

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums

  int n_kt = (sh.tk + kTile - 1) / kTile;
  // Causal: the tile's last row sits at absolute row row0 + q0 + 63.
  if (causal) n_kt = min(n_kt, (sh.row0 + q0 + kTile - 1) / kTile + 1);

  for (int j = 0; j < n_kt; ++j) {
    const int k0 = j * kTile;
    __syncthreads();  // every warp is done with the previous k/v tile
    load_tile<D, kTile>(ks, kh, k0, sh.tk);
    load_tile<D, kTile>(vs, vh, k0, sh.tk);
    __syncthreads();

    // s = q k^T for the warp's 16 rows x 64 keys.
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t a[4];
      frag_a<LD>(a, qs, wr, kk, g, t);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        uint32_t b0, b1;
        frag_b_trans<LD>(b0, b1, ks, n * 8, kk, g, t);
        Elem<T>::mma(s[n], a, b0, b1);
      }
    }

    // Scale, mask (absolute coordinates), running max.
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int col = k0 + n * 8 + 2 * t + (e & 1);
        float x = s[n][e] * scale;
        if (col >= sh.tk || (causal && col > sh.row0 + row[r])) x = kNegInf;
        s[n][e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      corr[r] = __expf(m[r] - m_new);
      m[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[n][e] - m[e >> 1]);
        s[n][e] = p;
        rs[e >> 1] += p;
      }
    }
    l[0] = l[0] * corr[0] + rs[0];
    l[1] = l[1] * corr[1] + rs[1];
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      acc[i][0] *= corr[0];
      acc[i][1] *= corr[0];
      acc[i][2] *= corr[1];
      acc[i][3] *= corr[1];
    }

    // acc += p v, p rounded to the input type.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {
          Elem<T>::pack(s[2 * kk][0], s[2 * kk][1]),
          Elem<T>::pack(s[2 * kk][2], s[2 * kk][3]),
          Elem<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          Elem<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        uint32_t b0, b1;
        frag_b<LD>(b0, b1, vs, kk * 16, i * 8, g, t);
        Elem<T>::mma(acc[i], a, b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lr = fmaxf(quad_sum(l[r]), 1e-30f);
    if (row[r] >= sh.tq) continue;
    const size_t out_row = static_cast<size_t>(bh) * sh.tq + row[r];
    uint16_t* orow = o + out_row * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      *reinterpret_cast<uint32_t*>(orow + i * 8 + 2 * t) =
          Elem<T>::pack(acc[i][2 * r] / lr, acc[i][2 * r + 1] / lr);
    }
    if (t == 0) lse[out_row] = m[r] + logf(lr);
  }
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
               Shape sh, float scale, int causal, cudaStream_t stream) {
  const int smem = 3 * kTile * (D + 8) * static_cast<int>(sizeof(uint16_t));
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (sh.tq + kTile - 1) / kTile);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<uint16_t*>(o),
      static_cast<float*>(lse), sh, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rtt

// Returns a cudaError_t; 0 means the launch was accepted.
extern "C" int rtt_flash_fwd(const void* q, const void* k, const void* v, void* o,
                             void* lse, int bh, int seq, int d, float scale,
                             int causal, int fp16, void* stream) {
  const rtt::Shape sh = rtt::square_shape(seq, d);
  RTT_DISPATCH(fp16, d, rtt::launch_fwd, q, k, v, o, lse, bh, sh, scale, causal,
               static_cast<cudaStream_t>(stream));
}

// One causal band: q [BH, tq, D] and k, v [BH, tk, D] (tk >= tq) with the
// given head strides; o [BH, tq, D] and lse [BH, tq] contiguous.
extern "C" int rtt_flash_fwd_rect(const void* q, const void* k, const void* v, void* o,
                                  void* lse, int bh, int tq, int tk, int q_hs, int k_hs,
                                  int v_hs, int d, float scale, int fp16, void* stream) {
  const int row0 = tk - tq;
  const rtt::Shape sh = {tq, tk, row0, q_hs, k_hs, v_hs, 0};
  RTT_DISPATCH(fp16, d, rtt::launch_fwd, q, k, v, o, lse, bh, sh, scale, 1,
               static_cast<cudaStream_t>(stream));
}
