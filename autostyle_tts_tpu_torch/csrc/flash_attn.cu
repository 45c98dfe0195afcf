// Causal, left-pad-aware flash attention for the token-LM prefill (sm_90a).
//
// Replaces: autostyle_tts_tpu/ops/pallas_attn.py::flash_attention
// (_flash_kernel), the Pallas TPU kernel the JAX prefill calls from
// models/transformer.py::_layer.
//
// Computes, for q [B,T,H,hd], k/v [B,S,K,hd] bf16 and offset [B] int32:
//   out[b,t,h] = softmax_j(q.k_j * hd^-0.5) . v_j over keys j with
//   offset[b] <= j <= t, kv head = h / (H/K); f32 softmax and accumulation,
//   bf16 output. Query rows t < offset[b] are pad rows; their output is
//   garbage here as on the TPU (no caller reads them).
//
// What bounds it on the H100: at the prefill shape (B=1, T=S=256, H=K=16,
// hd=64) one call moves ~2 MB and does ~0.13 GFLOP, a few microseconds at
// the card's memory rate or bf16 tensor-core rate. Neither is reached: the
// call is bound by launch latency and by how few blocks it has (64).
//
// Design: one block of 128 threads per (b, h, 64-query tile); two threads
// share one query row, each holding half of hd in registers (q pre-scaled,
// as in the reference, and the f32 accumulator). The block walks 64-key
// tiles from the first tile holding a key >= offset up to the diagonal
// (tiles above it are skipped), staging K and V in shared memory and the
// tile's scores in a padded shared array, with the running (max, sum, acc)
// online softmax of the reference. Masked scores are -1e30 exactly as in the
// reference, so a valid row's result does not depend on which masked tiles
// are visited. Plain CUDA cores, no tensor cores: simple and right first;
// wgmma/TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 2 * BQ;
constexpr float NEG_INF = -1e30f;

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int* __restrict__ offset,
                 __nv_bfloat16* __restrict__ out,
                 int T, int S, int H, int K, float scale) {
  constexpr int HALF = HD / 2;
  __shared__ __nv_bfloat16 ks[BK][HD];
  __shared__ __nv_bfloat16 vs[BK][HD];
  __shared__ float sc[BQ][BK + 1];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int row = tid >> 1, part = tid & 1;
  const int q_pos = qt * BQ + row;
  const int kvh = h / (H / K);
  const int off = offset[b];

  float qr[HALF], acc[HALF];
  const int qrow = q_pos < T ? q_pos : T - 1;
  const __nv_bfloat16* qp = q + ((size_t)(b * T + qrow) * H + h) * HD + part * HALF;
#pragma unroll
  for (int d = 0; d < HALF; ++d) {
    qr[d] = __bfloat162float(qp[d]) * scale;
    acc[d] = 0.f;
  }
  float m = NEG_INF, l = 0.f;

  const int last_q = min(qt * BQ + BQ - 1, T - 1);
  const int n_tiles = min(last_q / BK + 1, (S + BK - 1) / BK);
  const int first_tile = off / BK;

  for (int tile = first_tile; tile < n_tiles; ++tile) {
    __syncthreads();  // previous tile's K/V fully consumed
    for (int i = tid; i < BK * HD; i += THREADS) {
      const int j = i / HD, d = i % HD;
      const int kp = tile * BK + j;
      __nv_bfloat16 kv0 = __float2bfloat16(0.f), vv0 = kv0;
      if (kp < S) {
        const size_t idx = ((size_t)(b * S + kp) * K + kvh) * HD + d;
        kv0 = k[idx];
        vv0 = v[idx];
      }
      ks[j][d] = kv0;
      vs[j][d] = vv0;
    }
    __syncthreads();

    float tile_max = NEG_INF;
    for (int j = 0; j < BK; ++j) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < HALF; ++d)
        s += qr[d] * __bfloat162float(ks[j][part * HALF + d]);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      const int kp = tile * BK + j;
      const bool ok = kp <= q_pos && kp >= off && kp < S;
      s = ok ? s : NEG_INF;
      if (part == 0) sc[row][j] = s;
      tile_max = fmaxf(tile_max, s);
    }
    __syncwarp();
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < HALF; ++d) acc[d] *= alpha;
    for (int j = 0; j < BK; ++j) {
      const float p = expf(sc[row][j] - m_new);
      l += p;
#pragma unroll
      for (int d = 0; d < HALF; ++d)
        acc[d] += p * __bfloat162float(vs[j][part * HALF + d]);
    }
    m = m_new;
  }

  if (q_pos < T) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    __nv_bfloat16* op = out + ((size_t)(b * T + q_pos) * H + h) * HD + part * HALF;
#pragma unroll
    for (int d = 0; d < HALF; ++d) op[d] = __float2bfloat16(acc[d] * inv);
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              const void* offset, void* out, int B, int T,
                              int S, int H, int K, int hd, float scale,
                              void* stream) {
  const dim3 grid((T + BQ - 1) / BQ, H, B);
  cudaStream_t st = (cudaStream_t)stream;
  const auto* qp = (const __nv_bfloat16*)q;
  const auto* kp = (const __nv_bfloat16*)k;
  const auto* vp = (const __nv_bfloat16*)v;
  const auto* op = (const int*)offset;
  auto* o = (__nv_bfloat16*)out;
  switch (hd) {
    case 16: flash_fwd_kernel<16><<<grid, THREADS, 0, st>>>(qp, kp, vp, op, o, T, S, H, K, scale); break;
    case 32: flash_fwd_kernel<32><<<grid, THREADS, 0, st>>>(qp, kp, vp, op, o, T, S, H, K, scale); break;
    case 64: flash_fwd_kernel<64><<<grid, THREADS, 0, st>>>(qp, kp, vp, op, o, T, S, H, K, scale); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
