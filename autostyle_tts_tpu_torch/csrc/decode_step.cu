// One B=1 decode step of the int8 / int4 speech-token LM, as a chain of
// kernels launched by one host function (sm_90a), and its two half-layers as
// entry points of their own.
//
// Replaces, of autostyle_tts_tpu/ops/pallas_decode.py:
//   attn_step (_attn_kernel): rmsnorm, int8 QKV GEMV, RoPE, cache row write
//     at slot t, attention over [off, t) plus the current token, int8 wo +
//     residual  ->  norm_gemv_kernel, attn_kernel, gemv_residual_kernel;
//   mlp_step (_mlp_kernel): rmsnorm, int8 gate|up, silu(g)*u, int8 down +
//     residual  ->  gate_up_kernel, gemv_residual_kernel;
//   mega_decode_step (_mega_kernel), int8 and int4: embedding row of the previous token, RoPE
// from max(t-off, 0), L layers (rmsnorm, int8 QKV GEMV with post-scales,
// RoPE, cache row write at slot t, attention over [off, t) plus the current
// token, int8 wo + residual, rmsnorm, int8 gate|up, silu(g)*u, int8 down +
// residual), final rmsnorm, speech-head GEMV, pad/BOS (and EOS while
// `suppress`) masking, temperature, top-k with the reference's tie rule and
// a Gumbel-max sample.
//
// What bounds it on the H100: bytes. One step streams ~235 MB of int8 layer
// weights, ~4.2 MB of speech head and up to ~22 MB of bf16 cache (at the
// flagship width: L=14, D=1024, F=4096, V=4099, S=392), about 78 us at
// 3.35 TB/s; the arithmetic is ~0.5 GFLOP. In practice this first version is
// bound by its ~73 launches per step and by the host loop around it.
//
// Design: the TPU kernel relies on a grid that runs in order on one core
// and carries the residual stream in VMEM between grid steps. Blocks on the
// GPU run in parallel and share nothing, so the step is split where a
// dependence crosses the whole hidden vector: one launch per phase, all on
// one stream, from one C entry point. Weights are output-major int8
// ([rows, in]) so each warp streams whole rows in 16-byte loads; every GEMV
// block first recomputes the rmsnorm of the bf16 residual into shared
// memory (1024 values, cheaper than another launch). Rounding points follow
// the reference: the residual is bf16 between phases, q/k/v and logits are
// f32, the attention output and silu(g)*u are rounded to bf16 before their
// projections, norms and softmax are f32; the current token attends with
// its unrounded f32 k/v while the cache receives their bf16 rounding.
// Random bits come from Philox4x32-10 keyed by the step's seed, counter =
// vocab id; the plain twin in ops/decode_step.py draws the same bits.
// A persistent single kernel, wgmma and CUDA-graph capture are later work.
//
// int4 (BITS = 4): the TPU layout pairs output channels (c, c + C/2) in a
// byte so that Mosaic can unpack without shifts. Here a byte holds two
// consecutive contraction elements of one output-major row, both
// offset-binary (value + 8; low nibble = even index), so a warp still
// streams one contiguous row, now of C/2 bytes, 32 elements per 16-byte
// load, and unpacks with a mask and a shift. Scales stay per output channel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
constexpr float NEG_INF = -1e30f;
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = 2;               // output rows per warp in the GEMVs
constexpr int SAMPLE_THREADS = 1024;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_min_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum (IS_MAX=false) or max (IS_MAX=true) over the block; every thread
// must call it. `red` holds 32 floats of shared memory.
template <bool IS_MAX>
__device__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  const float ident = IS_MAX ? NEG_INF : 0.f;
  v = IS_MAX ? warp_max(v) : warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = threadIdx.x < nw ? red[threadIdx.x] : ident;
  if (warp == 0) v = IS_MAX ? warp_max(v) : warp_sum(v);
  if (threadIdx.x == 0) red[0] = v;
  __syncthreads();
  const float r = red[0];
  __syncthreads();
  return r;
}

__device__ int block_min_int(int v, float* red) {
  int* ired = reinterpret_cast<int*>(red);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  v = warp_min_int(v);
  if (lane == 0) ired[warp] = v;
  __syncthreads();
  v = threadIdx.x < nw ? ired[threadIdx.x] : 0x7fffffff;
  if (warp == 0) v = warp_min_int(v);
  if (threadIdx.x == 0) ired[0] = v;
  __syncthreads();
  const int r = ired[0];
  __syncthreads();
  return r;
}

// x_s[i] = bf16(h[i] * rsqrt(mean(h^2) + eps) * w[i]), kept as f32.
__device__ void rmsnorm_to_smem(const bf16* __restrict__ h, const float* __restrict__ w,
                                float eps, int D, float* x_s, float* red) {
  float ss = 0.f;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float f = __bfloat162float(h[i]);
    ss += f * f;
  }
  ss = block_reduce<false>(ss, red);
  const float inv = rsqrtf(ss / (float)D + eps);
  for (int i = threadIdx.x; i < D; i += blockDim.x)
    x_s[i] = bf16_round(__bfloat162float(h[i]) * inv * w[i]);
  __syncthreads();
}

// Bytes of a weight row of C elements at BITS bits each.
template <int BITS>
__host__ __device__ __forceinline__ size_t row_bytes(int C) { return (size_t)C * BITS / 8; }

// One warp: out[r] = sum_c W_r[c] * x_s[c] for ROWS rows of C elements at
// BITS bits (8: int8; 4: two offset-binary nibbles a byte, low = even
// index). 16 bytes per lane per load: C % 16 == 0 for int8, C % 32 == 0 for
// int4, rows 16-byte aligned.
template <int BITS>
__device__ __forceinline__ void rows_dot(const int8_t* const* wr, const float* x_s,
                                         int C, float* out) {
  constexpr int EPL = 16 * 8 / BITS;   // elements per 16-byte load
  const int lane = threadIdx.x & 31;
  float acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
  for (int c = lane * EPL; c < C; c += 32 * EPL) {
    float xv[EPL];
#pragma unroll
    for (int e = 0; e < EPL; e += 4) {
      const float4 x4 = *reinterpret_cast<const float4*>(x_s + c + e);
      xv[e] = x4.x; xv[e + 1] = x4.y; xv[e + 2] = x4.z; xv[e + 3] = x4.w;
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int4 pk = __ldg(reinterpret_cast<const int4*>(wr[r] + row_bytes<BITS>(c)));
      if constexpr (BITS == 8) {
        const int8_t* b = reinterpret_cast<const int8_t*>(&pk);
#pragma unroll
        for (int e = 0; e < 16; ++e) acc[r] += (float)b[e] * xv[e];
      } else {
        const uint8_t* b = reinterpret_cast<const uint8_t*>(&pk);
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          acc[r] += (float)((int)(b[e] & 15) - 8) * xv[2 * e];
          acc[r] += (float)((int)(b[e] >> 4) - 8) * xv[2 * e + 1];
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) out[r] = warp_sum(acc[r]);
}

__global__ void embed_kernel(const int* __restrict__ tok, const bf16* __restrict__ emb,
                             bf16* __restrict__ h, int D) {
  const size_t row = (size_t)tok[0] * D;
  for (int i = threadIdx.x; i < D; i += blockDim.x) h[i] = emb[row + i];
}

// out[r] = (W[r] . bf16(rmsnorm(h) * nw)) * s[r], r < R.  W: [R, D] at BITS.
template <int BITS>
__global__ void __launch_bounds__(THREADS)
norm_gemv_kernel(const bf16* __restrict__ h, const float* __restrict__ nw, float eps,
                 const int8_t* __restrict__ W, const float* __restrict__ s,
                 float* __restrict__ out, int R, int D) {
  extern __shared__ float smem[];
  float* x_s = smem;
  float* red = smem + D;
  rmsnorm_to_smem(h, nw, eps, D, x_s, red);
  const int r0 = (blockIdx.x * WARPS + (threadIdx.x >> 5)) * ROWS;
  if (r0 >= R) return;
  const int8_t* wr[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) wr[r] = W + (size_t)min(r0 + r, R - 1) * row_bytes<BITS>(D);
  float o[ROWS];
  rows_dot<BITS>(wr, x_s, D, o);
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      if (r0 + r < R) out[r0 + r] = o[r] * s[r0 + r];
  }
}

// act[i] = bf16(silu(g_i) * u_i), g_i/u_i = rows i and F+i of W . x.
template <int BITS>
__global__ void __launch_bounds__(THREADS)
gate_up_kernel(const bf16* __restrict__ h, const float* __restrict__ nw, float eps,
               const int8_t* __restrict__ W, const float* __restrict__ s,
               bf16* __restrict__ act, int F, int D) {
  extern __shared__ float smem[];
  float* x_s = smem;
  float* red = smem + D;
  rmsnorm_to_smem(h, nw, eps, D, x_s, red);
  const int i = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (i >= F) return;
  const int8_t* wr[ROWS] = {W + (size_t)i * row_bytes<BITS>(D),
                            W + (size_t)(F + i) * row_bytes<BITS>(D)};
  float o[ROWS];
  rows_dot<BITS>(wr, x_s, D, o);
  if ((threadIdx.x & 31) == 0) {
    const float g = o[0] * s[i];
    const float u = o[1] * s[F + i];
    act[i] = __float2bfloat16(g * (1.f / (1.f + expf(-g))) * u);
  }
}

// h[r] = bf16(h[r] + (W[r] . x) * s[r]).  W: [D, C] at BITS, x: [C] bf16.
template <int BITS>
__global__ void __launch_bounds__(THREADS)
gemv_residual_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ W,
                     const float* __restrict__ s, bf16* __restrict__ h, int D, int C) {
  extern __shared__ float x_s[];
  for (int c = threadIdx.x; c < C; c += blockDim.x) x_s[c] = __bfloat162float(x[c]);
  __syncthreads();
  const int r0 = (blockIdx.x * WARPS + (threadIdx.x >> 5)) * ROWS;
  if (r0 >= D) return;
  const int8_t* wr[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) wr[r] = W + (size_t)min(r0 + r, D - 1) * row_bytes<BITS>(C);
  float o[ROWS];
  rows_dot<BITS>(wr, x_s, C, o);
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      if (r0 + r < D)
        h[r0 + r] = __float2bfloat16(__bfloat162float(h[r0 + r]) + o[r] * s[r0 + r]);
  }
}

// One block per head: RoPE q/k at position max(t-off, 0), write the cache
// row t, attend over slots [off, t) plus the current token.
__global__ void __launch_bounds__(THREADS)
attn_kernel(const float* __restrict__ qkv, const float* __restrict__ invf,
            bf16* __restrict__ kc, bf16* __restrict__ vc, bf16* __restrict__ attn,
            int N, int hd, int t, int off, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + hd;
  float* v_s = k_s + hd;
  float* red = v_s + hd;
  float* p_s = red + 32;
  const int h = blockIdx.x, half = hd / 2, base = h * hd;
  const float pos = (float)max(t - off, 0);
  for (int i = threadIdx.x; i < hd; i += blockDim.x) {
    const bool first = i < half;
    const int partner = first ? i + half : i - half;
    const float ang = pos * invf[first ? i : i - half];
    const float c = cosf(ang), sn = sinf(ang);
    const float qi = qkv[base + i], qp = qkv[base + partner];
    const float ki = qkv[N + base + i], kp = qkv[N + base + partner];
    const float qr = first ? qi * c + (-qp) * sn : qi * c + qp * sn;
    const float kr = first ? ki * c + (-kp) * sn : ki * c + kp * sn;
    const float vi = qkv[2 * N + base + i];
    q_s[i] = qr;
    k_s[i] = kr;
    v_s[i] = vi;
    kc[(size_t)t * N + base + i] = __float2bfloat16(kr);
    vc[(size_t)t * N + base + i] = __float2bfloat16(vi);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = max(t - off, 0);
  for (int jj = warp; jj < n; jj += WARPS) {
    const bf16* krow = kc + (size_t)(off + jj) * N + base;
    float d = 0.f;
    for (int e = lane; e < hd; e += 32) d += q_s[e] * __bfloat162float(krow[e]);
    d = warp_sum(d);
    if (lane == 0) p_s[jj] = d * scale;
  }
  float cur = 0.f;
  for (int e = lane; e < hd; e += 32) cur += q_s[e] * k_s[e];
  cur = warp_sum(cur) * scale;
  __syncthreads();

  float mx = NEG_INF;
  for (int jj = threadIdx.x; jj < n; jj += blockDim.x) mx = fmaxf(mx, p_s[jj]);
  const float m = fmaxf(block_reduce<true>(mx, red), cur);
  float sum = 0.f;
  for (int jj = threadIdx.x; jj < n; jj += blockDim.x) {
    const float p = expf(p_s[jj] - m);
    p_s[jj] = p;
    sum += p;
  }
  const float pc = expf(cur - m);
  const float denom = block_reduce<false>(sum, red) + pc;
  for (int e = threadIdx.x; e < hd; e += blockDim.x) {
    float acc = 0.f;
    for (int jj = 0; jj < n; ++jj)
      acc += p_s[jj] * __bfloat162float(vc[(size_t)(off + jj) * N + base + e]);
    attn[base + e] = __float2bfloat16((acc + pc * v_s[e]) / denom);
  }
}

__device__ __forceinline__ uint32_t philox_c0(uint32_t ctr, uint32_t key) {
  uint32_t c0 = ctr, c1 = 0u, c2 = 0u, c3 = 0u, k0 = key, k1 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c0;
}

// Mask, temperature, top-k threshold (strip every value tied at the running
// max, k-1 times; the max of the rest is the k-th value), Gumbel-max; the
// picked id is the smallest id at the maximum.
__global__ void __launch_bounds__(SAMPLE_THREADS)
sample_kernel(const float* __restrict__ logits, int V, int pad_id, int bos_id,
              int eos_id, int suppress, int greedy, float temperature, int top_k,
              uint32_t seed, int* __restrict__ tok_out) {
  extern __shared__ float smem[];
  float* y = smem;
  float* cur = y + V;
  float* red = cur + V;
  const float tdiv = fmaxf(temperature, 1e-6f);
  for (int i = threadIdx.x; i < V; i += blockDim.x) {
    const bool bad = i == pad_id || i == bos_id || (i == eos_id && suppress);
    float v = bad ? NEG_INF : logits[i];
    if (!greedy) v = v / tdiv;
    y[i] = v;
    cur[i] = v;
  }
  __syncthreads();
  if (!greedy) {
    if (top_k > 0) {
      for (int it = 0; it < top_k - 1; ++it) {
        float mx = NEG_INF;
        for (int i = threadIdx.x; i < V; i += blockDim.x) mx = fmaxf(mx, cur[i]);
        mx = block_reduce<true>(mx, red);
        for (int i = threadIdx.x; i < V; i += blockDim.x)
          if (cur[i] >= mx) cur[i] = NEG_INF;
        __syncthreads();
      }
      float thr = NEG_INF;
      for (int i = threadIdx.x; i < V; i += blockDim.x) thr = fmaxf(thr, cur[i]);
      thr = block_reduce<true>(thr, red);
      for (int i = threadIdx.x; i < V; i += blockDim.x)
        if (y[i] < thr) y[i] = NEG_INF;
    }
    for (int i = threadIdx.x; i < V; i += blockDim.x) {
      const uint32_t bits = philox_c0((uint32_t)i, seed) >> 8;
      const float u = (float)bits * (1.f / 16777216.f) + 1e-9f;
      y[i] = y[i] - logf(-logf(u));
    }
    __syncthreads();
  }
  float mx = NEG_INF;
  for (int i = threadIdx.x; i < V; i += blockDim.x) mx = fmaxf(mx, y[i]);
  mx = block_reduce<true>(mx, red);
  int pick = 0x7fffffff;
  for (int i = threadIdx.x; i < V; i += blockDim.x)
    if (y[i] >= mx) pick = min(pick, i);
  pick = block_min_int(pick, red);
  if (threadIdx.x == 0) tok_out[0] = pick;
}

inline int blocks(int n, int per) { return (n + per - 1) / per; }

#define LAUNCH_CHECK()                          \
  do {                                          \
    const cudaError_t e = cudaGetLastError();   \
    if (e != cudaSuccess) return (int)e;        \
  } while (0)

// Attention half-layer of one layer: h <- h + wo . attn(rmsnorm(h)), cache
// row t written in place. Scratch: qkv f32 [3N], attn bf16 [N].
template <int BITS>
int attn_half(bf16* h, const float* nw, const int8_t* wqkv, const float* wqs,
              const int8_t* wo, const float* wos, const float* invf, bf16* kc, bf16* vc,
              float* qkv, bf16* attn, int D, int H, int hd, int S, int t, int off,
              float eps, float scale, cudaStream_t st) {
  const int N = H * hd;
  const size_t norm_smem = (size_t)(D + 32) * sizeof(float);
  const size_t attn_smem = (size_t)(3 * hd + 32 + S) * sizeof(float);
  norm_gemv_kernel<BITS><<<blocks(3 * N, WARPS * ROWS), THREADS, norm_smem, st>>>(
      h, nw, eps, wqkv, wqs, qkv, 3 * N, D);
  LAUNCH_CHECK();
  attn_kernel<<<H, THREADS, attn_smem, st>>>(qkv, invf, kc, vc, attn, N, hd, t, off, scale);
  LAUNCH_CHECK();
  gemv_residual_kernel<BITS><<<blocks(D, WARPS * ROWS), THREADS, (size_t)N * sizeof(float), st>>>(
      attn, wo, wos, h, D, N);
  LAUNCH_CHECK();
  return 0;
}

// MLP half-layer of one layer: h <- h + down . (silu(g) * u). Scratch: act
// bf16 [F].
template <int BITS>
int mlp_half(bf16* h, const float* nw, const int8_t* wgu, const float* wgus,
             const int8_t* wd, const float* wds, bf16* act, int D, int F, float eps,
             cudaStream_t st) {
  const size_t norm_smem = (size_t)(D + 32) * sizeof(float);
  gate_up_kernel<BITS><<<blocks(F, WARPS), THREADS, norm_smem, st>>>(h, nw, eps, wgu, wgus, act, F, D);
  LAUNCH_CHECK();
  gemv_residual_kernel<BITS><<<blocks(D, WARPS * ROWS), THREADS, (size_t)F * sizeof(float), st>>>(
      act, wd, wds, h, D, F);
  LAUNCH_CHECK();
  return 0;
}

template <int BITS>
int mega_step(const int* tok_in, const bf16* emb, const float* invf,
              const float* attn_norm, const int8_t* wqkv, const float* wqs,
              const int8_t* wo, const float* wos, const float* mlp_norm,
              const int8_t* wgu, const float* wgus, const int8_t* wd, const float* wds,
              const float* final_norm, const int8_t* head, const float* head_s,
              bf16* k_all, bf16* v_all, bf16* h, float* qkv, bf16* attn, bf16* act,
              float* logits, int* tok_out, int L, int D, int H, int hd, int F, int V, int S,
              int t, int off, int suppress, int seed, float eps, float scale,
              int pad_id, int bos_id, int eos_id, int greedy, float temperature,
              int top_k, cudaStream_t st) {
  const int N = H * hd;
  embed_kernel<<<1, 256, 0, st>>>(tok_in, emb, h, D);
  LAUNCH_CHECK();
  for (int l = 0; l < L; ++l) {
    int rc = attn_half<BITS>(
        h, attn_norm + (size_t)l * D, wqkv + (size_t)l * 3 * N * row_bytes<BITS>(D),
        wqs + (size_t)l * 3 * N, wo + (size_t)l * D * row_bytes<BITS>(N), wos + (size_t)l * D,
        invf, k_all + (size_t)l * S * N, v_all + (size_t)l * S * N, qkv, attn,
        D, H, hd, S, t, off, eps, scale, st);
    if (rc) return rc;
    rc = mlp_half<BITS>(
        h, mlp_norm + (size_t)l * D, wgu + (size_t)l * 2 * F * row_bytes<BITS>(D),
        wgus + (size_t)l * 2 * F, wd + (size_t)l * D * row_bytes<BITS>(F), wds + (size_t)l * D,
        act, D, F, eps, st);
    if (rc) return rc;
  }
  const size_t norm_smem = (size_t)(D + 32) * sizeof(float);
  norm_gemv_kernel<BITS><<<blocks(V, WARPS * ROWS), THREADS, norm_smem, st>>>(
      h, final_norm, eps, head, head_s, logits, V, D);
  LAUNCH_CHECK();
  const size_t sample_smem = (size_t)(2 * V + 32) * sizeof(float);
  sample_kernel<<<1, SAMPLE_THREADS, sample_smem, st>>>(
      logits, V, pad_id, bos_id, eos_id, suppress, greedy, temperature, top_k,
      (uint32_t)seed, tok_out);
  LAUNCH_CHECK();
  return 0;
}

}  // namespace

#define DISPATCH_BITS(fn, ...)                    \
  do {                                            \
    if (bits == 8) return fn<8>(__VA_ARGS__);     \
    if (bits == 4) return fn<4>(__VA_ARGS__);     \
    return (int)cudaErrorInvalidValue;            \
  } while (0)

// All entry points: `bits` is 8 (int8 weights, one value a byte) or 4 (two
// offset-binary values a byte along the contraction axis, low nibble = even
// index); weights are output-major rows; every pointer is device memory on
// `stream`'s device; the return value is the first CUDA error (or
// cudaErrorInvalidValue for another `bits`).

// One attention half-layer. h bf16 [D] and the caches kc/vc bf16 [S, N]
// (row t) are updated in place. wqkv [3N, D], wo [D, N]; scales f32 [3N],
// [D]; nw f32 [D]; invf f32 [hd/2]; scratch qkv f32 [3N], attn bf16 [N].
extern "C" int attn_step(void* h, const void* nw, const void* wqkv, const void* wqs,
                         const void* wo, const void* wos, const void* invf, void* kc,
                         void* vc, void* qkv, void* attn, int D, int H, int hd, int S,
                         int t, int off, float eps, float scale, int bits, void* stream) {
  DISPATCH_BITS(attn_half, (bf16*)h, (const float*)nw, (const int8_t*)wqkv, (const float*)wqs,
            (const int8_t*)wo, (const float*)wos, (const float*)invf, (bf16*)kc, (bf16*)vc,
            (float*)qkv, (bf16*)attn, D, H, hd, S, t, off, eps, scale, (cudaStream_t)stream);
}

// One MLP half-layer. h bf16 [D] is updated in place. wgu [2F, D] (gate
// rows then up rows), wd [D, F]; scales f32 [2F], [D]; scratch act bf16 [F].
extern "C" int mlp_step(void* h, const void* nw, const void* wgu, const void* wgus,
                        const void* wd, const void* wds, void* act, int D, int F,
                        float eps, int bits, void* stream) {
  DISPATCH_BITS(mlp_half, (bf16*)h, (const float*)nw, (const int8_t*)wgu, (const float*)wgus,
            (const int8_t*)wd, (const float*)wds, (bf16*)act, D, F, eps, (cudaStream_t)stream);
}

// One decode step. Weights stacked over layers: wqkv [L,3N,D], wo [L,D,N],
// wgu [L,2F,D] (gate rows then up rows), wd [L,D,F], head [V,D]; scales f32
// [L,3N], [L,D], [L,2F], [L,D], [V]; norms f32 [L,D] / [D]; emb bf16 [V,D];
// invf f32 [hd/2]. Caches k_all/v_all bf16 [L,S,N] are updated in place at
// row t. Scratch: h bf16 [D] (holds the last layer's residual on return),
// qkv f32 [3N], attn bf16 [N], act bf16 [F], logits f32 [V]. tok_in and
// tok_out are int32 [1] on the device.
extern "C" int mega_decode_step(
    const void* tok_in, const void* emb, const void* invf,
    const void* attn_norm, const void* wqkv, const void* wqs,
    const void* wo, const void* wos, const void* mlp_norm,
    const void* wgu, const void* wgus, const void* wd, const void* wds,
    const void* final_norm, const void* head, const void* head_s,
    void* k_all, void* v_all,
    void* h, void* qkv, void* attn, void* act, void* logits, void* tok_out,
    int L, int D, int H, int hd, int F, int V, int S,
    int t, int off, int suppress, int seed, float eps, float scale,
    int pad_id, int bos_id, int eos_id, int greedy, float temperature,
    int top_k, int bits, void* stream) {
  DISPATCH_BITS(mega_step, (const int*)tok_in, (const bf16*)emb, (const float*)invf,
            (const float*)attn_norm, (const int8_t*)wqkv, (const float*)wqs,
            (const int8_t*)wo, (const float*)wos, (const float*)mlp_norm,
            (const int8_t*)wgu, (const float*)wgus, (const int8_t*)wd, (const float*)wds,
            (const float*)final_norm, (const int8_t*)head, (const float*)head_s,
            (bf16*)k_all, (bf16*)v_all, (bf16*)h, (float*)qkv, (bf16*)attn, (bf16*)act,
            (float*)logits, (int*)tok_out, L, D, H, hd, F, V, S, t, off, suppress, seed,
            eps, scale, pad_id, bos_id, eos_id, greedy, temperature, top_k,
            (cudaStream_t)stream);
}
