// Flash-attention backward, dq half, for Hopper (sm_90a):
//   p  = exp(q k^T * scale - lse)            (masked entries are 0)
//   ds = p * (do v^T - delta) * scale        (rounded to the input type)
//   dq = ds k
// on [BH, T, D] with D in {64, 128}; lse and delta are [BH, T] f32.
//
// Replaces, of ray_tpu/ops/pallas/flash_attention.py, the dq product of
// the single-block _bwd_fused_kernel (:296, launched by _flash_bwd_fused
// :332) and the streaming _bwd_dq_kernel (:218, launched by _flash_bwd
// :355). The TPU's fused kernel computes dq, dk and dv from one score
// matrix held in VMEM; blocks on the H100 run in parallel with no order,
// so dq (a sum over keys) and dk/dv (sums over queries) are split into
// two kernels, each owning its output rows. No atomics: the result is
// deterministic.
//
// What bounds it on the H100: three products of 2 * BH * T^2 * D / 2
// FLOP each (s, do v^T, ds k) against reads of q, k, v, do and a write
// of dq: about 300 FLOP per byte at T = 1024, D = 64, so the tensor
// cores bound it, barely. The design keeps s, p, dp and ds in registers,
// feeds ds to the next product straight from its accumulator registers,
// and skips key tiles above the diagonal; query tiles run heaviest first.
#include "flash_common.cuh"

namespace rtt {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                    const uint16_t* __restrict__ v, const uint16_t* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    uint16_t* __restrict__ dq, int seq, float scale, int causal) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* qs = smem;
  uint16_t* dos = qs + kTile * LD;
  uint16_t* ks = dos + kTile * LD;
  uint16_t* vs = ks + kTile * LD;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const size_t base = static_cast<size_t>(bh) * seq * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = warp * 16;
  const int row[2] = {q0 + wr + g, q0 + wr + g + 8};

  load_tile<D, kTile>(qs, q + base, q0, seq);
  load_tile<D, kTile>(dos, dout + base, q0, seq);
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = row[r] < seq;
    row_lse[r] = ok ? lse[static_cast<size_t>(bh) * seq + row[r]] : 0.f;
    row_delta[r] = ok ? delta[static_cast<size_t>(bh) * seq + row[r]] : 0.f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  int n_kt = (seq + kTile - 1) / kTile;
  if (causal) n_kt = min(n_kt, q0 / kTile + 1);

  for (int j = 0; j < n_kt; ++j) {
    const int k0 = j * kTile;
    __syncthreads();
    load_tile<D, kTile>(ks, k + base, k0, seq);
    load_tile<D, kTile>(vs, v + base, k0, seq);
    __syncthreads();

    // s = q k^T and dp = do v^T, both 16 rows x 64 keys per warp.
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t aq[4], ado[4];
      frag_a<LD>(aq, qs, wr, kk, g, t);
      frag_a<LD>(ado, dos, wr, kk, g, t);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        uint32_t b0, b1;
        frag_b_trans<LD>(b0, b1, ks, n * 8, kk, g, t);
        Elem<T>::mma(s[n], aq, b0, b1);
        frag_b_trans<LD>(b0, b1, vs, n * 8, kk, g, t);
        Elem<T>::mma(dp[n], ado, b0, b1);
      }
    }

    // ds = p * (dp - delta) * scale, kept in s.
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int col = k0 + n * 8 + 2 * t + (e & 1);
        const bool masked = col >= seq || (causal && col > row[r]);
        const float p = masked ? 0.f : __expf(s[n][e] * scale - row_lse[r]);
        s[n][e] = p * (dp[n][e] - row_delta[r]) * scale;
      }
    }

    // acc += ds k.
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
        frag_b<LD>(b0, b1, ks, kk * 16, i * 8, g, t);
        Elem<T>::mma(acc[i], a, b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= seq) continue;
    uint16_t* out = dq + base + static_cast<size_t>(row[r]) * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<uint32_t*>(out + i * 8 + 2 * t) =
          Elem<T>::pack(acc[i][2 * r], acc[i][2 * r + 1]);
  }
}

template <typename T, int D>
int launch_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* delta, void* dq, int bh, int seq,
                  float scale, int causal, cudaStream_t stream) {
  const int smem = 4 * kTile * (D + 8) * static_cast<int>(sizeof(uint16_t));
  auto kernel = flash_bwd_dq_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (seq + kTile - 1) / kTile);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<const uint16_t*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<uint16_t*>(dq), seq, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rtt

// Returns a cudaError_t; 0 means the launch was accepted.
extern "C" int rtt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse, const void* delta,
                                void* dq, int bh, int seq, int d, float scale,
                                int causal, int fp16, void* stream) {
  RTT_DISPATCH(fp16, d, rtt::launch_bwd_dq, q, k, v, dout, lse, delta, dq, bh, seq,
               scale, causal, static_cast<cudaStream_t>(stream));
}
