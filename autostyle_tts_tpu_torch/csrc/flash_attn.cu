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
// hd=64) one call moves ~2 MB and does ~0.13 GFLOP, well under a microsecond
// at the card's memory rate or tensor-core rate. What the call takes is the
// longest block's chain of tiles (load, QK^T, softmax, PV, four times for the
// last query rows) plus the launch, so the design goes for many small blocks
// and a short chain rather than for peak rate.
//
// Design: tensor cores through mma.sync.m16n8k16 (bf16 in, f32 out), one
// warp per 16 query rows, two warps (32 rows) per block: 128 blocks at the
// prefill shape, where wgmma's 64-row tiles would give 64. Q fragments are
// read once from global memory into registers. K/V tiles of 64 keys arrive
// by 16-byte cp.async into a two-stage ring in shared memory (rows padded by
// 16 bytes, so fragment reads and ldmatrix do not collide on banks); the
// next tile loads under the current one's math. Scores, the running
// (max, sum) and P stay in registers: the QK^T accumulators, scaled by
// hd^-0.5 * log2(e) in f32 (the reference scales q in f32; no bf16 rounding
// is added), are masked to -1e30 exactly as in the reference, so a real
// row does not depend on which masked tiles are visited; exp2 of them is
// packed to bf16 as the A operand of PV, whose V fragments come from
// ldmatrix.trans. The layouts [B,T,H,hd] / [B,S,K,hd] are read in place,
// GQA is an index, tiles above the diagonal and below `offset` are skipped,
// and the longest blocks (last query rows) are scheduled first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
constexpr int BQ_WARPS = 2;           // warps per block, 16 query rows each
constexpr int BQ = 16 * BQ_WARPS;     // query rows per block
constexpr int BK = 64;                // keys per tile
constexpr int THREADS = 32 * BQ_WARPS;
constexpr int STAGES = 2;
constexpr int PAD = 8;                // bf16 of padding per shared-memory row
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool real) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int bytes = real ? 16 : 0;    // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" :: "r"(d), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;" :: "n"(N)); }

__device__ __forceinline__ void mma16816(float* c, const unsigned* a, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned* r, const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ offset,
                 bf16* __restrict__ out, int T, int S, int H, int K, float scale) {
  constexpr int LD = HD + PAD;          // shared-memory row stride, bf16
  constexpr int KS = HD / 16;           // k-steps of QK^T
  constexpr int NT = BK / 8;            // score tiles of 8 keys
  constexpr int DT = HD / 8;            // output tiles of 8 channels
  constexpr int CPR = HD / 8;           // 16-byte chunks per K/V row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);             // [STAGES][BK][LD]
  bf16* vs = ks + STAGES * BK * LD;                         // [STAGES][BK][LD]

  const int qt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int kvh = h / (H / K);
  const int off = offset[b];
  const int row0 = qt * BQ + warp * 16 + g, row1 = row0 + 8;   // this thread's two query rows

  const int last_q = min(qt * BQ + BQ - 1, T - 1);
  const int n_tiles = min(last_q / BK + 1, (S + BK - 1) / BK);
  const int first_tile = off / BK;

  auto load_tile = [&](int tile, int stage) {
    bf16* kd = ks + stage * BK * LD;
    bf16* vd = vs + stage * BK * LD;
    for (int i = tid; i < BK * CPR; i += THREADS) {
      const int j = i / CPR, c = i % CPR;
      const int kp = tile * BK + j;
      const bool real = kp < S;
      const size_t idx = ((size_t)(b * S + (real ? kp : S - 1)) * K + kvh) * HD + c * 8;
      cp_async16(kd + j * LD + c * 8, k + idx, real);
      cp_async16(vd + j * LD + c * 8, v + idx, real);
    }
  };

  if (first_tile < n_tiles) load_tile(first_tile, 0);
  cp_async_commit();

  // Q fragments: rows row0 / row1, channels 16 ks + 2 tq (+8)
  unsigned qa[KS][4];
  {
    const bf16* q0 = q + ((size_t)(b * T + min(row0, T - 1)) * H + h) * HD;
    const bf16* q1 = q + ((size_t)(b * T + min(row1, T - 1)) * H + h) * HD;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      qa[s][0] = *reinterpret_cast<const unsigned*>(q0 + 16 * s + 2 * tq);
      qa[s][1] = *reinterpret_cast<const unsigned*>(q1 + 16 * s + 2 * tq);
      qa[s][2] = *reinterpret_cast<const unsigned*>(q0 + 16 * s + 2 * tq + 8);
      qa[s][3] = *reinterpret_cast<const unsigned*>(q1 + 16 * s + 2 * tq + 8);
    }
  }

  float o[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;   // rows row0 / row1; l is this lane's share
  const float sl = scale * LOG2E;

  for (int tile = first_tile; tile < n_tiles; ++tile) {
    const int stage = (tile - first_tile) & 1;
    if (tile + 1 < n_tiles) load_tile(tile + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();     // this tile's group has landed (the newest may be in flight)
    __syncthreads();
    const bf16* kt = ks + stage * BK * LD;
    const bf16* vt = vs + stage * BK * LD;

    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int c = 0; c < KS; ++c) {
        const bf16* kr = kt + (n * 8 + g) * LD + 16 * c + 2 * tq;
        mma16816(s[n], qa[c], *reinterpret_cast<const unsigned*>(kr),
                 *reinterpret_cast<const unsigned*>(kr + 8));
      }
    }
    // scale, mask, running max
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kp = tile * BK + n * 8 + 2 * tq + (i & 1);
        const int row = i < 2 ? row0 : row1;
        const bool ok = kp <= row && kp >= off && kp < S;
        s[n][i] = ok ? s[n][i] * sl : NEG_INF;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= al0;
    l1 *= al1;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      o[d][0] *= al0; o[d][1] *= al0;
      o[d][2] *= al1; o[d][3] *= al1;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = exp2f(s[n][0] - mn0); s[n][1] = exp2f(s[n][1] - mn0);
      s[n][2] = exp2f(s[n][2] - mn1); s[n][3] = exp2f(s[n][3] - mn1);
      l0 += s[n][0] + s[n][1];
      l1 += s[n][2] + s[n][3];
    }
    // O += P V, 16 keys a step; P from the score registers
#pragma unroll
    for (int c = 0; c < BK / 16; ++c) {
      unsigned pa[4];
      pa[0] = pack_bf16(s[2 * c][0], s[2 * c][1]);
      pa[1] = pack_bf16(s[2 * c][2], s[2 * c][3]);
      pa[2] = pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]);
      pa[3] = pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3]);
#pragma unroll
      for (int d = 0; d < DT; d += 2) {
        unsigned vb[4];
        ldmatrix_x4_trans(vb, vt + (16 * c + (lane & 7) + ((lane >> 3) & 1) * 8) * LD
                                  + (d + (lane >> 4)) * 8);
        mma16816(o[d], pa, vb[0], vb[1]);
        mma16816(o[d + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();   // the stage is free for the load after next
  }
  cp_async_wait<0>();

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float i0 = 1.f / fmaxf(l0, 1e-30f), i1 = 1.f / fmaxf(l1, 1e-30f);
  if (row0 < T) {
    bf16* op = out + ((size_t)(b * T + row0) * H + h) * HD + 2 * tq;
#pragma unroll
    for (int d = 0; d < DT; ++d)
      *reinterpret_cast<unsigned*>(op + 8 * d) = pack_bf16(o[d][0] * i0, o[d][1] * i0);
  }
  if (row1 < T) {
    bf16* op = out + ((size_t)(b * T + row1) * H + h) * HD + 2 * tq;
#pragma unroll
    for (int d = 0; d < DT; ++d)
      *reinterpret_cast<unsigned*>(op + 8 * d) = pack_bf16(o[d][2] * i1, o[d][3] * i1);
  }
}

template <int HD>
int launch(const bf16* q, const bf16* k, const bf16* v, const int* offset, bf16* out, int B, int T,
           int S, int H, int K, float scale, cudaStream_t st) {
  const size_t smem = (size_t)2 * STAGES * BK * (HD + PAD) * sizeof(bf16);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<HD>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((T + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<HD><<<grid, THREADS, smem, st>>>(q, k, v, offset, out, T, S, H, K, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Query rows per block: the grid is ceil(T / rows) x H x B blocks.
extern "C" int flash_attn_block_rows() { return BQ; }

// Launches on `stream`; returns the first CUDA error (0 on success;
// cudaErrorInvalidValue for a head width that is not built).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              const void* offset, void* out, int B, int T,
                              int S, int H, int K, int hd, float scale,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const auto* qp = (const bf16*)q;
  const auto* kp = (const bf16*)k;
  const auto* vp = (const bf16*)v;
  const auto* op = (const int*)offset;
  auto* o = (bf16*)out;
  switch (hd) {
    case 16: return launch<16>(qp, kp, vp, op, o, B, T, S, H, K, scale, st);
    case 32: return launch<32>(qp, kp, vp, op, o, B, T, S, H, K, scale, st);
    case 64: return launch<64>(qp, kp, vp, op, o, B, T, S, H, K, scale, st);
    case 128: return launch<128>(qp, kp, vp, op, o, B, T, S, H, K, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
