// Flash-attention backward, dk/dv half, for Hopper (sm_90a):
//   p^T  = exp(k q^T * scale - lse)          (masked entries are 0)
//   dv   = p^T do                            (p rounded to the input type)
//   ds^T = p^T * (v do^T - delta) * scale    (rounded to the input type)
//   dk   = ds^T q
// on [BH, T, D] with D in {64, 128}; lse and delta are [BH, T] f32.
//
// Replaces, of ray_tpu/ops/pallas/flash_attention.py, the dk and dv
// products of the single-block _bwd_fused_kernel (:296, launched by
// _flash_bwd_fused :332) and the streaming _bwd_dkv_kernel (:255,
// launched by _flash_bwd :374). Each block owns 64 key rows and walks the
// query tiles from the diagonal down, so dk and dv are summed in
// registers with no atomics (see flash_bwd_dq.cu for the split).
//
// What bounds it on the H100: four products of 2 * BH * T^2 * D / 2 FLOP
// each (s, dp, dv, dk) against reads of q, k, v, do and writes of dk, dv:
// about 340 FLOP per byte at T = 1024, D = 64, so the tensor cores bound
// it. The design works on the transposed scores (keys as rows), which
// makes p^T and ds^T the A operands of the dv and dk products straight
// from their accumulator registers. For D = 128 the query tile is 32
// rows so that the two f32 accumulators of 16 x 128 per warp and the
// score tiles stay within the register file.
#include "flash_common.cuh"

namespace rtt {

template <typename T, int D, int BQ>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                     const uint16_t* __restrict__ v, const uint16_t* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     uint16_t* __restrict__ dk, uint16_t* __restrict__ dv, int seq,
                     float scale, int causal) {
  constexpr int LD = D + 8;
  constexpr int NT = BQ / 8;  // 8-wide query tiles of one product
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* ks = smem;
  uint16_t* vs = ks + kTile * LD;
  uint16_t* qs = vs + kTile * LD;
  uint16_t* dos = qs + BQ * LD;
  float* lse_s = reinterpret_cast<float*>(dos + BQ * LD);
  float* delta_s = lse_s + BQ;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kTile;  // low key tiles see the most queries: first
  const size_t base = static_cast<size_t>(bh) * seq * D;
  const size_t row_base = static_cast<size_t>(bh) * seq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = warp * 16;
  const int key[2] = {k0 + wr + g, k0 + wr + g + 8};

  load_tile<D, kTile>(ks, k + base, k0, seq);
  load_tile<D, kTile>(vs, v + base, k0, seq);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    dk_acc[i][0] = dk_acc[i][1] = dk_acc[i][2] = dk_acc[i][3] = 0.f;
    dv_acc[i][0] = dv_acc[i][1] = dv_acc[i][2] = dv_acc[i][3] = 0.f;
  }

  const int n_qt = (seq + BQ - 1) / BQ;
  const int first = causal ? k0 / BQ : 0;  // query tiles wholly above are masked

  for (int iq = first; iq < n_qt; ++iq) {
    const int q0 = iq * BQ;
    __syncthreads();
    load_tile<D, BQ>(qs, q + base, q0, seq);
    load_tile<D, BQ>(dos, dout + base, q0, seq);
    for (int i = threadIdx.x; i < BQ; i += kThreads) {
      const bool ok = q0 + i < seq;
      lse_s[i] = ok ? lse[row_base + q0 + i] : 0.f;
      delta_s[i] = ok ? delta[row_base + q0 + i] : 0.f;
    }
    __syncthreads();

    // p^T = exp(k q^T * scale - lse): 16 keys x BQ queries per warp.
    float p[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) p[n][0] = p[n][1] = p[n][2] = p[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t a[4];
      frag_a<LD>(a, ks, wr, kk, g, t);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t b0, b1;
        frag_b_trans<LD>(b0, b1, qs, n * 8, kk, g, t);
        Elem<T>::mma(p[n], a, b0, b1);
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = n * 8 + 2 * t + (e & 1);  // query within the tile
        const int qrow = q0 + qi;
        const int kr = key[e >> 1];
        const bool masked = qrow >= seq || kr >= seq || (causal && kr > qrow);
        p[n][e] = masked ? 0.f : __expf(p[n][e] * scale - lse_s[qi]);
      }
    }

    // dv += p^T do, p rounded to the input type.
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      const uint32_t a[4] = {
          Elem<T>::pack(p[2 * kk][0], p[2 * kk][1]),
          Elem<T>::pack(p[2 * kk][2], p[2 * kk][3]),
          Elem<T>::pack(p[2 * kk + 1][0], p[2 * kk + 1][1]),
          Elem<T>::pack(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        uint32_t b0, b1;
        frag_b<LD>(b0, b1, dos, kk * 16, i * 8, g, t);
        Elem<T>::mma(dv_acc[i], a, b0, b1);
      }
    }

    // dp^T = v do^T, then ds^T = p^T * (dp^T - delta) * scale in p.
    float dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t a[4];
      frag_a<LD>(a, vs, wr, kk, g, t);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t b0, b1;
        frag_b_trans<LD>(b0, b1, dos, n * 8, kk, g, t);
        Elem<T>::mma(dp[n], a, b0, b1);
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = n * 8 + 2 * t + (e & 1);
        p[n][e] = p[n][e] * (dp[n][e] - delta_s[qi]) * scale;
      }
    }

    // dk += ds^T q.
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      const uint32_t a[4] = {
          Elem<T>::pack(p[2 * kk][0], p[2 * kk][1]),
          Elem<T>::pack(p[2 * kk][2], p[2 * kk][3]),
          Elem<T>::pack(p[2 * kk + 1][0], p[2 * kk + 1][1]),
          Elem<T>::pack(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        uint32_t b0, b1;
        frag_b<LD>(b0, b1, qs, kk * 16, i * 8, g, t);
        Elem<T>::mma(dk_acc[i], a, b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= seq) continue;
    const size_t off = base + static_cast<size_t>(key[r]) * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      *reinterpret_cast<uint32_t*>(dk + off + i * 8 + 2 * t) =
          Elem<T>::pack(dk_acc[i][2 * r], dk_acc[i][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + i * 8 + 2 * t) =
          Elem<T>::pack(dv_acc[i][2 * r], dv_acc[i][2 * r + 1]);
    }
  }
}

template <typename T, int D>
int launch_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dk, void* dv, int bh,
                   int seq, float scale, int causal, cudaStream_t stream) {
  constexpr int BQ = D == 64 ? 64 : 32;
  const int smem = (2 * kTile + 2 * BQ) * (D + 8) * static_cast<int>(sizeof(uint16_t)) +
                   2 * BQ * static_cast<int>(sizeof(float));
  auto kernel = flash_bwd_dkv_kernel<T, D, BQ>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (seq + kTile - 1) / kTile);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<const uint16_t*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<uint16_t*>(dk), static_cast<uint16_t*>(dv), seq, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rtt

// Returns a cudaError_t; 0 means the launch was accepted.
extern "C" int rtt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta,
                                 void* dk, void* dv, int bh, int seq, int d,
                                 float scale, int causal, int fp16, void* stream) {
  RTT_DISPATCH(fp16, d, rtt::launch_bwd_dkv, q, k, v, dout, lse, delta, dk, dv, bh,
               seq, scale, causal, static_cast<cudaStream_t>(stream));
}
