// One B=1 decode step of the int8 / int4 speech-token LM for sm_90a, and its
// two half-layers as entry points of their own.
//
// Replaces, of autostyle_tts_tpu/ops/pallas_decode.py:
//   attn_step (_attn_kernel): rmsnorm, int8 QKV GEMV, RoPE, cache row write
//     at slot t, attention over [off, t) plus the current token, int8 wo +
//     residual  ->  gemv_kernel<QKV>, attn_kernel, gemv_kernel<WO>;
//   mlp_step (_mlp_kernel): rmsnorm, int8 gate|up, silu(g)*u, int8 down +
//     residual  ->  gemv_kernel<GATE_UP>, gemv_kernel<DOWN>;
//   mega_decode_step (_mega_kernel), int8 and int4: embedding row of the
//     previous token, the L layers above, final rmsnorm, speech-head GEMV,
//     pad/BOS (and EOS while `suppress`) masking, temperature, top-k with the
//     reference's tie rule and a Gumbel-max sample.
//
// What bounds it on the H100: bytes, in principle. One step streams ~235 MB
// of int8 layer weights, ~4.2 MB of speech head and up to ~22 MB of bf16
// cache (at the flagship width: L=14, D=1024, F=4096, V=4099, S=392), about
// 78 us at 3.35 TB/s; the arithmetic is ~0.5 GFLOP. In practice the step is
// a chain of 72 dependent phases of 1-8 MB each, and what it takes beyond
// its bytes is that chain's latency: per phase a grid-wide barrier (~1 us,
// more where the leaving poll queues behind 8 MB of weight loads), a
// prologue of one or two trips to L2, dot products that are bound by
// the rate of arithmetic (~3.3 operations per weight on 8 warps an SM), and an
// epilogue. PERF.md holds the measured split.
//
// Design. The TPU kernel runs its grid in order on one core and carries the
// residual in VMEM between grid steps; blocks on the GPU run in parallel and
// share nothing, so the step is split where a dependence crosses the whole
// hidden vector. Every phase is a __device__ function over (block id,
// block count) and a `Sync` that separates it from the phase before:
//   - GEMV phases (gemv_phase): weights are output-major ([rows, in]); a
//     warp owns ROWS rows and a lane starts its 16-byte loads of them (8 to
//     16 in flight per lane, the whole matrix in flight across the grid),
//     the rows' scales and (cp.async) the norm weights BEFORE it waits for
//     the previous phase, because none of them depends on it. Only then
//     comes the prologue (rmsnorm of the residual, or the merge of the
//     attention partials, into shared memory, laid out so that the lanes'
//     float4 reads hit 32 different banks), the dot products in f32 with
//     int-to-float done by one PRMT and one FADD per weight, and the
//     per-row scale. Grids are sized from the SM count.
//   - attention (attn_phase): a grid of (head, split): the live slots
//     [off, t) are cut into ceil(n / 24) splits (at most 16, or the blocks
//     there are per head), so the flagship state gives 160 blocks in the
//     half-layer chain and 128 in the step's kernel. Eight lanes span one hd=64
//     key row with 16-byte loads, a warp covers 4 keys a load and keeps two
//     loads of K and two of V in flight; every lane group carries a running
//     (max, sum, acc), merged over the warp by shuffles and over the block in
//     shared memory into one partial (acc[hd], m, l) per (head, split).
//     Split 0 also ropes k, writes cache row t and folds in the current
//     token's f32 k/v. The partials are merged in the prologue of the wo
//     GEMV (all loads started before the first use), where the attention
//     output is rounded to bf16 as before. No per-slot array remains, so the
//     cache length has no cap.
//   - the sampler (sample_phase): logits live in registers; each round of
//     the top-k search takes the two largest distinct values off the block
//     with one barrier (12 rounds for k = 25), and only entries that survive
//     the threshold draw their Gumbel noise.
// Two ways to run the phases:
//   - the whole step is one persistent cooperative kernel, one block an SM,
//     with a grid-wide barrier between phases: a block arrives, starts the
//     next phase's weight loads, and only then waits. One launch a step.
//   - a half-layer entry point is a chain of two or three kernels launched
//     with programmatic dependent launch: a kernel signals its dependents at
//     once, the next kernel starts, requests its weight loads and waits
//     (griddepcontrol.wait) for the previous one to finish. A whole step run
//     as such a chain (72 launches) was bound on the H100 by the host's ~5 us
//     per launch, which is why the step is the persistent kernel.
// Buffers another phase has written (residual, qkv, partials, act, logits,
// token) are read with ld.global.cg, never through L1.
//
// Rounding points follow the reference: the residual is bf16 between phases,
// q/k/v and logits are f32, the attention output and silu(g)*u are rounded
// to bf16 before their projections, norms and softmax are f32; the current
// token attends with its unrounded f32 k/v while the cache receives their
// bf16 rounding. Sums run in another order than the plain version's (four
// partial sums per 16-byte chunk, lanes, then splits): f32 rounding only.
// Random bits come from Philox4x32-10 keyed by the step's seed, counter =
// vocab id; the plain twin in ops/decode_step.py draws the same bits.
//
// int4 (BITS = 4): the TPU layout pairs output channels (c, c + C/2) in a
// byte so that Mosaic can unpack without shifts. Here a byte holds two
// consecutive contraction elements of one output-major row, both
// offset-binary (value + 8; low nibble = even index), so a warp still
// streams one contiguous row, now of C/2 bytes, 32 elements per 16-byte
// load, and unpacks with a mask and a shift. Scales stay per output channel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;
constexpr float NEG_INF = -1e30f;
constexpr int WARPS = 8;              // GEMV block
constexpr int THREADS = 32 * WARPS;
constexpr int ATTN_WARPS = 4;
constexpr int MAX_SPLITS = 16;        // attention partials per head
constexpr int SPLIT_KEYS = 24;        // live slots per split, until MAX_SPLITS caps it
constexpr int PART_PAD = 4;           // a partial is acc[hd], m, l, 2 unused floats
constexpr int SAMPLE_VPT = 32;        // logits per thread of a THREADS-wide block: V <= 8192

enum Kind { QKV, GATE_UP, WO, DOWN };   // the speech head runs as QKV (norm, GEMV, f32 out)

// Splits of n live slots: SPLIT_KEYS slots each until `cap` splits (at most
// MAX_SPLITS), then the splits grow.
__host__ __device__ __forceinline__ int attn_splits(int n, int cap = MAX_SPLITS) {
  const int s = (n + SPLIT_KEYS - 1) / SPLIT_KEYS;
  cap = cap > MAX_SPLITS ? MAX_SPLITS : (cap < 1 ? 1 : cap);
  return s < 1 ? 1 : (s > cap ? cap : s);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the block; every thread must call it. `red`: 32 floats.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < nw ? red[lane] : 0.f;
  v = warp_sum(v);
  __syncthreads();
  return v;
}

// A 16-byte piece of a weight row: read once, kept out of L1. Volatile, so
// it stays ahead of the wait that follows it in program order.
__device__ __forceinline__ int4 ld_weight(const int8_t* p) {
  int4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.s32 {%0,%1,%2,%3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" :: "l"(p));
}

// 16 bytes from global to shared memory without a register in between.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;" :: "r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;" ::: "memory"); }

// ---------------------------------------------------------------- phase separators

// Kernel chain: let the next kernel start now; wait for the previous kernel
// (complete, its writes visible) before touching anything it wrote.
struct ChainSync {
  __device__ __forceinline__ void start() { asm volatile("griddepcontrol.launch_dependents;"); }
  __device__ __forceinline__ void arrive() {}
  __device__ __forceinline__ void wait() { asm volatile("griddepcontrol.wait;" ::: "memory"); }
};

// Persistent kernel: a barrier over all (co-resident) blocks on a counter
// that the host zeroes before the launch, in two halves: `arrive` once the
// block's part of the previous phase is written, `wait` before it reads what
// others wrote. The next phase's weight loads go between the two, so the
// arrival does not queue behind them. With `stamps` ([barrier, block, 2]
// nanoseconds of %globaltimer) every block records when it arrived at and
// when it left each barrier, for the phase breakdown of a step.
struct GridSync {
  unsigned* ctr;
  unsigned target;
  unsigned nblk;
  unsigned long long* stamps;
  int idx;
  __device__ __forceinline__ void stamp(int which) {
    if (stamps != nullptr) {
      unsigned long long now;
      asm volatile("mov.u64 %0, %globaltimer;" : "=l"(now));
      stamps[((size_t)idx * nblk + blockIdx.x) * 2 + which] = now;
    }
  }
  __device__ __forceinline__ void arrive() {
    __syncthreads();
    target += nblk;
    if (threadIdx.x == 0) {
      stamp(0);
      __threadfence();
      atomicAdd(ctr, 1u);
    }
  }
  __device__ __forceinline__ void wait() {
    if (threadIdx.x == 0) {
      unsigned seen;
      do {
        asm volatile("ld.global.acquire.gpu.u32 %0, [%1];" : "=r"(seen) : "l"(ctr) : "memory");
      } while (seen < target);
      stamp(1);
    }
    ++idx;
    __syncthreads();
  }
};

// Eight bf16 of a 16-byte load as floats.
__device__ __forceinline__ void unpack8(const int4& pk, float* f) {
  const bf162* p = reinterpret_cast<const bf162*>(&pk);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(p[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

// ---------------------------------------------------------------- GEMV phases

struct GemvArgs {
  const int8_t* W;      // [R, C] at BITS, output-major
  const float* s;       // [R] per-row scales
  int R, C;
  bf16* h;              // residual [D]: normalised by QKV/GATE_UP (D = C), updated by WO/DOWN (D = R)
  const float* nw;      // norm weights [C]
  float eps;
  const int* tok;       // QKV of the first layer: the residual is emb[tok[0]] (copied to h), else null
  const bf16* emb;
  const bf16* xin;      // DOWN: bf16 [C]
  const float* part;    // WO: attention partials [C / hd, MAX_SPLITS, hd + PART_PAD]
  int hd, nsplit;
  float* out;           // QKV: f32 [R]
  bf16* act;            // GATE_UP: bf16 [R / 2]
};

// The byte `sel` of `word` (0..255) as the float 2^23 + byte: one PRMT puts
// it under the exponent of 2^23, where the mantissa's last bit weighs 1.
// (The constant goes first so that the selector stays an immediate.)
template <int SEL>
__device__ __forceinline__ float byte_as_float(unsigned word) {
  return __uint_as_float(__byte_perm(0x4B000000u, word, 0x3214 + SEL));
}

// sum_e W[e] * x[e] over one 16-byte chunk (16 int8 or 32 int4 elements),
// as four partial sums. Values become floats without an int-to-float
// conversion: int8 is flipped to offset-binary (b + 128), int4 nibbles
// already are (v + 8), and the offset leaves with the 2^23.
template <int BITS>
__device__ __forceinline__ float chunk_dot(const int4& pk, const float* xv) {
  const unsigned wd[4] = {(unsigned)pk.x, (unsigned)pk.y, (unsigned)pk.z, (unsigned)pk.w};
  float a[4] = {0.f, 0.f, 0.f, 0.f};
  if constexpr (BITS == 8) {
    constexpr float OFF = 8388608.f + 128.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned u = wd[i] ^ 0x80808080u;
      a[0] += (byte_as_float<0>(u) - OFF) * xv[4 * i];
      a[1] += (byte_as_float<1>(u) - OFF) * xv[4 * i + 1];
      a[2] += (byte_as_float<2>(u) - OFF) * xv[4 * i + 2];
      a[3] += (byte_as_float<3>(u) - OFF) * xv[4 * i + 3];
    }
  } else {
    constexpr float OFF = 8388608.f + 8.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {   // byte k of word i: elements 8 i + 2 k (low nibble) and + 1 (high)
      const unsigned lo = wd[i] & 0x0F0F0F0Fu, hi = (wd[i] >> 4) & 0x0F0F0F0Fu;
      const float* x = xv + 8 * i;
      a[0] += (byte_as_float<0>(lo) - OFF) * x[0];
      a[1] += (byte_as_float<0>(hi) - OFF) * x[1];
      a[2] += (byte_as_float<1>(lo) - OFF) * x[2];
      a[3] += (byte_as_float<1>(hi) - OFF) * x[3];
      a[0] += (byte_as_float<2>(lo) - OFF) * x[4];
      a[1] += (byte_as_float<2>(hi) - OFF) * x[5];
      a[2] += (byte_as_float<3>(lo) - OFF) * x[6];
      a[3] += (byte_as_float<3>(hi) - OFF) * x[7];
    }
  }
  return (a[0] + a[1]) + (a[2] + a[3]);
}

// Where element i of the input vector lives in shared memory: a lane reads
// chunk c = lane + 32 j of EPL elements four floats at a time, so the
// vector is stored as [j][float4 of the chunk][lane][4] and each of those
// reads is one contiguous 512-byte row of the 32 lanes (no bank conflicts).
template <int EPL>
__device__ __forceinline__ int xpos(int i) {
  const int c = i / EPL, r = i % EPL;
  return (((c >> 5) * (EPL / 4) + (r >> 2)) << 7) + ((c & 31) << 2) + (r & 3);
}
// Floats of shared memory the vector takes (C rounded up to 32 chunks).
__host__ __device__ __forceinline__ int xlen(int C, int epl) {
  return ((C / epl + 31) / 32) * 32 * epl;
}

// One GEMV phase over blocks bid, bid + nblk, ...: a block unit is
// blockDim/32 warps, a warp owns ROWS weight rows (GATE_UP: ROWS/2 gate rows
// and the ROWS/2 up rows F below them). smem: gemv_smem(C, BITS, phase
// normalises) bytes.
//   QKV:       out[r] = (W[r] . bf16(rmsnorm(h) * nw)) * s[r]
//   GATE_UP:   act[i] = bf16(silu(g_i) * u_i), g_i / u_i = rows i and F + i
//   WO:        h[r] = bf16(h[r] + (W[r] . bf16(merged attention)) * s[r])
//   DOWN:      h[r] = bf16(h[r] + (W[r] . xin) * s[r])
template <int BITS, int ROWS, int PF, int KIND, class Sync>
__device__ __forceinline__ void gemv_phase(const GemvArgs& a, float* smem, int bid, int nblk,
                                           Sync& sync) {
  // PF: 16-byte loads per row and lane in flight before the wait
  constexpr int EPL = 128 / BITS;         // elements per 16-byte load
  constexpr int OPW = KIND == GATE_UP ? ROWS / 2 : ROWS;   // outputs per warp
  static_assert(KIND != GATE_UP || ROWS >= 2, "gate|up needs a gate row and an up row");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int nout = KIND == GATE_UP ? a.R / 2 : a.R;
  const int C = a.C;
  const int nchunks = C / EPL;
  const size_t rb = (size_t)C * BITS / 8;
  const int units = (nout + OPW * nwarps - 1) / (OPW * nwarps);
  float* x_s = smem;        // the input vector, at xpos<EPL>(i)
  float* red = smem + xlen(C, EPL);
  float* nw_s = red + 32;   // norm weights (QKV, GATE_UP), in order

  int4 w[ROWS][PF];
  float sv[ROWS];           // the rows' scales
  auto row_of = [&](int o0, int r) -> int {
    if (KIND == GATE_UP) {
      const int i = min(o0 + (r % OPW), nout - 1);
      return r < OPW ? i : nout + i;
    }
    return min(o0 + r, nout - 1);
  };
  auto prefetch = [&](int o0) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int8_t* p = a.W + (size_t)row_of(o0, r) * rb;
#pragma unroll
      for (int j = 0; j < PF; ++j) {
        const int c = lane + 32 * j;
        w[r][j] = c < nchunks ? ld_weight(p + 16 * (size_t)c) : make_int4(0, 0, 0, 0);
      }
      sv[r] = __ldg(a.s + row_of(o0, r));
    }
  };

  int unit = bid;
  int o0 = (unit * nwarps + warp) * OPW;
  sync.arrive();
  if (unit < units) {
    prefetch(o0);
    if constexpr (KIND == QKV || KIND == GATE_UP) {   // constant too: fetch it now
      for (int i = threadIdx.x * 4; i < C; i += blockDim.x * 4) cp_async16(nw_s + i, a.nw + i);
      cp_async_commit();
    }
  }
  sync.wait();
  if (unit >= units) return;

  // prologue: the input vector as f32 in shared memory
  if constexpr (KIND == QKV || KIND == GATE_UP) {
    const bf16* hsrc = a.h;
    bool copy = false;
    if (KIND == QKV && a.tok != nullptr) {
      hsrc = a.emb + (size_t)__ldcg(a.tok) * C;
      copy = bid == 0;
    }
    float ss = 0.f;
#pragma unroll 4
    for (int i = threadIdx.x * 2; i < C; i += blockDim.x * 2) {
      const bf162 v = __ldcg(reinterpret_cast<const bf162*>(hsrc + i));
      const float2 f = __bfloat1622float2(v);
      *reinterpret_cast<float2*>(x_s + xpos<EPL>(i)) = f;
      ss += f.x * f.x + f.y * f.y;
      if (copy) *reinterpret_cast<bf162*>(a.h + i) = v;
    }
    cp_async_wait_all();
    ss = block_sum(ss, red);   // its barriers also publish nw_s
    const float inv = rsqrtf(ss / (float)C + a.eps);
    for (int i = threadIdx.x * 2; i < C; i += blockDim.x * 2) {
      float2* x2 = reinterpret_cast<float2*>(x_s + xpos<EPL>(i));
      const float2 f = *x2;
      *x2 = make_float2(bf16_round(f.x * inv * nw_s[i]), bf16_round(f.y * inv * nw_s[i + 1]));
    }
  } else if constexpr (KIND == DOWN) {
#pragma unroll 2
    for (int i = threadIdx.x * 8; i < C; i += blockDim.x * 8) {   // C % 16 == 0
      float f[8];
      unpack8(__ldcg(reinterpret_cast<const int4*>(a.xin + i)), f);
      *reinterpret_cast<float4*>(x_s + xpos<EPL>(i)) = make_float4(f[0], f[1], f[2], f[3]);
      *reinterpret_cast<float4*>(x_s + xpos<EPL>(i + 4)) = make_float4(f[4], f[5], f[6], f[7]);
    }
  } else {   // WO: merge the (head, split) partials; four channels of one head per thread
    const int stride = a.hd + PART_PAD;
    for (int i = threadIdx.x * 4; i < C; i += blockDim.x * 4) {
      const int hh = i / a.hd, e = i % a.hd;
      const float* p0 = a.part + (size_t)hh * MAX_SPLITS * stride;
      // every load is started before its first use: two trips to L2, not two per split
      float2 ml[MAX_SPLITS];
#pragma unroll
      for (int sp = 0; sp < MAX_SPLITS; ++sp)
        ml[sp] = sp < a.nsplit ? __ldcg(reinterpret_cast<const float2*>(p0 + sp * stride + a.hd))
                               : make_float2(NEG_INF, 0.f);
      float M = NEG_INF;
#pragma unroll
      for (int sp = 0; sp < MAX_SPLITS; ++sp) M = fmaxf(M, ml[sp].x);
      float L = 0.f;
      float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int s0 = 0; s0 < MAX_SPLITS; s0 += 8) {
        if (s0 < a.nsplit) {
          float4 v[8];
#pragma unroll
          for (int k = 0; k < 8; ++k)
            v[k] = s0 + k < a.nsplit ? __ldcg(reinterpret_cast<const float4*>(p0 + (s0 + k) * stride + e))
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            if (s0 + k < a.nsplit) {
              const float wgt = expf(ml[s0 + k].x - M);
              L += ml[s0 + k].y * wgt;
              A.x += v[k].x * wgt; A.y += v[k].y * wgt; A.z += v[k].z * wgt; A.w += v[k].w * wgt;
            }
          }
        }
      }
      *reinterpret_cast<float4*>(x_s + xpos<EPL>(i)) =
          make_float4(bf16_round(A.x / L), bf16_round(A.y / L), bf16_round(A.z / L), bf16_round(A.w / L));
    }
  }
  __syncthreads();

  for (;;) {
    if (o0 < nout) {
      float acc[ROWS], res[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        acc[r] = 0.f;
        res[r] = 0.f;
        if constexpr (KIND == WO || KIND == DOWN)   // the residual row, on its way during the dots
          if (lane == 0 && o0 + r < nout) res[r] = __bfloat162float(__ldcg(a.h + o0 + r));
      }
#pragma unroll
      for (int j = 0; j < PF; ++j) {
        const int c = lane + 32 * j;
        if (c < nchunks) {
          float xv[EPL];
#pragma unroll
          for (int e = 0; e < EPL; e += 4) {
            const float4 x4 = *reinterpret_cast<const float4*>(x_s + ((j * (EPL / 4) + e / 4) << 7) + (lane << 2));
            xv[e] = x4.x; xv[e + 1] = x4.y; xv[e + 2] = x4.z; xv[e + 3] = x4.w;
          }
#pragma unroll
          for (int r = 0; r < ROWS; ++r) acc[r] += chunk_dot<BITS>(w[r][j], xv);
        }
      }
      for (int c = lane + 32 * PF; c < nchunks; c += 32) {   // rows longer than the prefetch
        int4 pk[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) pk[r] = ld_weight(a.W + (size_t)row_of(o0, r) * rb + 16 * (size_t)c);
        float xv[EPL];
#pragma unroll
        for (int e = 0; e < EPL; e += 4) {
          const float4 x4 = *reinterpret_cast<const float4*>(x_s + xpos<EPL>(c * EPL + e));
          xv[e] = x4.x; xv[e + 1] = x4.y; xv[e + 2] = x4.z; xv[e + 3] = x4.w;
        }
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r] += chunk_dot<BITS>(pk[r], xv);
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = warp_sum(acc[r]);
      if (lane == 0) {
        if constexpr (KIND == QKV) {
#pragma unroll
          for (int r = 0; r < ROWS; ++r)
            if (o0 + r < nout) a.out[o0 + r] = acc[r] * sv[r];
        } else if constexpr (KIND == GATE_UP) {
#pragma unroll
          for (int r = 0; r < OPW; ++r) {
            const int i = o0 + r;
            if (i < nout) {
              const float g = acc[r] * sv[r];
              const float u = acc[OPW + r] * sv[OPW + r];
              a.act[i] = __float2bfloat16(g * (1.f / (1.f + expf(-g))) * u);
            }
          }
        } else {
#pragma unroll
          for (int r = 0; r < ROWS; ++r)
            if (o0 + r < nout)
              a.h[o0 + r] = __float2bfloat16(res[r] + acc[r] * sv[r]);
        }
      }
    }
    unit += nblk;
    if (unit >= units) break;
    o0 = (unit * nwarps + warp) * OPW;
    prefetch(o0);
  }
}

// ---------------------------------------------------------------- attention phase

// Attention of one token over cache slots [off, t) and itself, as partials
// per (head, split); blocks bid, bid + nblk, ... take the units. qkv f32
// [3N] from the QKV phase; kc/vc bf16 [S, N], row t written by split 0;
// part f32 [H, MAX_SPLITS, hd + PART_PAD]. hd / 8 lanes span one key row, so
// hd is 8, 16, 32, 64, 128 or 256. smem: 3 hd + 4 + (blockDim / 32)(hd + 2)
// floats.
template <class Sync>
__device__ __forceinline__ void attn_phase(const float* qkv, const float* invf, bf16* kc, bf16* vc,
                                           float* part, int H, int hd, int t, int off, int nsplit,
                                           float scale, float* smem, int bid, int nblk, Sync& sync) {
  const int N = H * hd, half = hd / 2;
  const int n = max(t - off, 0);
  const int units = H * nsplit;
  const int per = (n + nsplit - 1) / nsplit;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int lpk = hd / 8, kpl = 32 / lpk;       // lanes per key, keys per warp-wide load
  const int g = lane / lpk, dl = (lane % lpk) * 8;
  const int stride = nwarps * kpl;              // keys per block-wide load
  float* q_s = smem;
  float* k_s = q_s + hd;
  float* v_s = k_s + hd;
  float* cur_s = v_s + hd;
  float* wp = cur_s + 4;                        // [nwarps][hd + 2]

  sync.arrive();
  if (bid < units) {   // old cache rows do not depend on the previous phase: pull them into L2
    const int base = (bid / nsplit) * hd, j0 = (bid % nsplit) * per, j1 = min(n, j0 + per);
    for (int j = j0 + warp * kpl + g; j < j1; j += stride) {
      prefetch_l2(kc + (size_t)(off + j) * N + base + dl);
      prefetch_l2(vc + (size_t)(off + j) * N + base + dl);
    }
  }
  sync.wait();

  for (int unit = bid; unit < units; unit += nblk) {
    if (unit != bid) __syncthreads();
    const int hh = unit / nsplit, sp = unit % nsplit, base = hh * hd;
    const int j0 = sp * per, j1 = min(n, j0 + per);
    int jb = j0 + warp * kpl;
    int4 ka, kb, va, vb;
    auto load = [&](int jx) {
      const int ja = jx + g, jc = jx + stride + g;
      const int4 z = make_int4(0, 0, 0, 0);
      ka = ja < j1 ? __ldcg(reinterpret_cast<const int4*>(kc + (size_t)(off + ja) * N + base + dl)) : z;
      kb = jc < j1 ? __ldcg(reinterpret_cast<const int4*>(kc + (size_t)(off + jc) * N + base + dl)) : z;
      va = ja < j1 ? __ldcg(reinterpret_cast<const int4*>(vc + (size_t)(off + ja) * N + base + dl)) : z;
      vb = jc < j1 ? __ldcg(reinterpret_cast<const int4*>(vc + (size_t)(off + jc) * N + base + dl)) : z;
    };
    load(jb);

    // RoPE at position max(t - off, 0); split 0 also ropes k and writes row t
    const float pos = (float)n;
    for (int i = threadIdx.x; i < hd; i += blockDim.x) {
      const bool first = i < half;
      const int partner = first ? i + half : i - half;
      const float ang = pos * invf[first ? i : i - half];
      const float c = cosf(ang), sn = sinf(ang);
      const float qi = __ldcg(qkv + base + i), qp = __ldcg(qkv + base + partner);
      q_s[i] = first ? qi * c + (-qp) * sn : qi * c + qp * sn;
      if (sp == 0) {
        const float ki = __ldcg(qkv + N + base + i), kp = __ldcg(qkv + N + base + partner);
        const float kr = first ? ki * c + (-kp) * sn : ki * c + kp * sn;
        const float vi = __ldcg(qkv + 2 * N + base + i);
        k_s[i] = kr;
        v_s[i] = vi;
        kc[(size_t)t * N + base + i] = __float2bfloat16(kr);
        vc[(size_t)t * N + base + i] = __float2bfloat16(vi);
      }
    }
    __syncthreads();
    if (sp == 0 && warp == 0) {
      float cur = 0.f;
      for (int e = lane; e < hd; e += 32) cur += q_s[e] * k_s[e];
      cur = warp_sum(cur) * scale;
      if (lane == 0) cur_s[0] = cur;
    }
    float qv[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) qv[e] = q_s[dl + e];

    float m = NEG_INF, l = 0.f, acc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = 0.f;
    auto consume = [&](const int4& k4, const int4& v4, bool ok) {
      float kf[8], vf[8];
      unpack8(k4, kf);
      unpack8(v4, vf);
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) s += qv[e] * kf[e];
      for (int o = lpk >> 1; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      s *= scale;
      if (ok) {
        const float mn = fmaxf(m, s);
        const float al = expf(m - mn), p = expf(s - mn);
        l = l * al + p;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] = acc[e] * al + p * vf[e];
        m = mn;
      }
    };
    while (jb < j1) {   // warp-uniform
      consume(ka, va, jb + g < j1);
      consume(kb, vb, jb + stride + g < j1);
      jb += 2 * stride;
      if (jb < j1) load(jb);
    }
    // the warp's lane groups, then the block's warps
    for (int o = lpk; o < 32; o <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m, o);
      const float lo = __shfl_xor_sync(0xffffffffu, l, o);
      const float M = fmaxf(m, mo);
      const float wa = expf(m - M), wb = expf(mo - M);
      l = l * wa + lo * wb;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc[e] = acc[e] * wa + __shfl_xor_sync(0xffffffffu, acc[e], o) * wb;
      m = M;
    }
    if (lane < lpk) {
      float* w0 = wp + warp * (hd + 2);
#pragma unroll
      for (int e = 0; e < 8; ++e) w0[dl + e] = acc[e];
      if (lane == 0) {
        w0[hd] = m;
        w0[hd + 1] = l;
      }
    }
    __syncthreads();
    float* out = part + ((size_t)hh * MAX_SPLITS + sp) * (hd + PART_PAD);
    for (int e = threadIdx.x; e < hd; e += blockDim.x) {
      float M = NEG_INF;
      for (int wi = 0; wi < nwarps; ++wi) M = fmaxf(M, wp[wi * (hd + 2) + hd]);
      float L = 0.f, A = 0.f;
      for (int wi = 0; wi < nwarps; ++wi) {
        const float wgt = expf(wp[wi * (hd + 2) + hd] - M);
        L += wp[wi * (hd + 2) + hd + 1] * wgt;
        A += wp[wi * (hd + 2) + e] * wgt;
      }
      if (sp == 0) {   // the current token, from its f32 k and v
        const float cur = cur_s[0];
        const float M2 = fmaxf(M, cur);
        const float wa = expf(M - M2), pc = expf(cur - M2);
        L = L * wa + pc;
        A = A * wa + pc * v_s[e];
        M = M2;
      }
      out[e] = A;
      if (e == 0) {
        out[hd] = M;
        out[hd + 1] = L;
      }
    }
  }
}

// ---------------------------------------------------------------- sampler phase

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

// The two largest distinct values of (a1 > a2) and (b1 > b2); -inf = none.
__device__ __forceinline__ void merge_top2(float& a1, float& a2, float b1, float b2) {
  const float hi = fmaxf(a1, b1), lo_c = fminf(a1, b1);
  float lo = fmaxf(a2, b2);
  if (lo_c < hi) lo = fmaxf(lo, lo_c);
  a1 = hi;
  a2 = lo;
}

// The block's two largest distinct values, to every thread, with one
// barrier. `red`: 64 floats, not in use by another call in flight (callers
// alternate two of them).
__device__ void block_top2(float& h1, float& h2, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    merge_top2(h1, h2, __shfl_xor_sync(0xffffffffu, h1, o), __shfl_xor_sync(0xffffffffu, h2, o));
  if (lane == 0) {
    red[2 * warp] = h1;
    red[2 * warp + 1] = h2;
  }
  __syncthreads();
  h1 = red[2 * (lane % nw)];            // nw is a power of two: groups of nw lanes hold all warps
  h2 = red[2 * (lane % nw) + 1];
  for (int o = nw >> 1; o > 0; o >>= 1)
    merge_top2(h1, h2, __shfl_xor_sync(0xffffffffu, h1, o), __shfl_xor_sync(0xffffffffu, h2, o));
}

// Mask, temperature, top-k threshold, Gumbel-max; the picked id is the
// smallest id at the maximum. The reference strips every value tied at the
// running max k-1 times (stripped entries become -1e30) and takes the max of
// the rest: that is the k-th largest distinct value d_k, or -1e30 where
// fewer than k distinct values lie above it. Here each round strips the two
// largest distinct values off the block with one barrier. One block of NT
// threads; thread i owns logits i, i + NT, ... (VPT of them at most, V <= NT
// * VPT) in registers. smem: 192 floats.
template <int NT, int VPT>
__device__ void sample_phase(const float* logits, int V, int pad_id, int bos_id, int eos_id,
                             int suppress, int greedy, float temperature, int top_k, uint32_t seed,
                             int* tok_out, float* smem) {
  const int tid = threadIdx.x;
  const float tdiv = fmaxf(temperature, 1e-6f);
  const int nv = (V + NT - 1) / NT;   // logits a thread really holds; the loops below skip the rest
  float y[VPT];
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int i = tid + j * NT;
    float v = -INFINITY;
    if (i < V) {
      const bool bad = i == pad_id || i == bos_id || (i == eos_id && suppress);
      v = bad ? NEG_INF : __ldcg(logits + i);
      if (!greedy) v = v / tdiv;
    }
    y[j] = v;
  }
  if (!greedy) {
    if (top_k > 0) {
      float cur[VPT];
#pragma unroll
      for (int j = 0; j < VPT; ++j) cur[j] = y[j];
      int round = 0;
#pragma unroll 1
      for (int left = top_k - 1; left > 0; left -= 2, ++round) {
        float h1 = -INFINITY, h2 = -INFINITY;
#pragma unroll
        for (int j = 0; j < VPT; ++j) {
          if (j >= nv) break;
          const float v = cur[j];
          if (v > h1) {
            h2 = h1;
            h1 = v;
          } else if (v < h1 && v > h2) {
            h2 = v;
          }
        }
        block_top2(h1, h2, smem + 64 * (round & 1));
        const float cut = (left >= 2 && h2 > -INFINITY) ? h2 : h1;
#pragma unroll
        for (int j = 0; j < VPT; ++j)
          if (j < nv && cur[j] >= cut) cur[j] = -INFINITY;
      }
      float thr = -INFINITY, unused = -INFINITY;
#pragma unroll
      for (int j = 0; j < VPT; ++j) thr = fmaxf(thr, cur[j]);
      block_top2(thr, unused, smem + 64 * (round & 1));
      if (top_k >= 2) thr = fmaxf(thr, NEG_INF);
#pragma unroll
      for (int j = 0; j < VPT; ++j)
        if (tid + j * NT < V && y[j] < thr) y[j] = NEG_INF;
    }
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int i = tid + j * NT;
      if (i < V && y[j] > 0.5f * NEG_INF) {   // |noise| < 21: entries at -1e30 or below do not move
        const uint32_t bits = philox_c0((uint32_t)i, seed) >> 8;
        const float u = (float)bits * (1.f / 16777216.f) + 1e-9f;
        y[j] = y[j] - logf(-logf(u));
      }
    }
  }
  // max value, smallest id at it
  float bv = -INFINITY;
  int bi = 0x7fffffff;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int i = tid + j * NT;
    if (i < V && y[j] > bv) {   // ids rise with j: the first hit is the smallest
      bv = y[j];
      bi = i;
    }
  }
  auto better = [](float v, int i, float ov, int oi) { return ov > v || (ov == v && oi < i); };
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (better(bv, bi, ov, oi)) { bv = ov; bi = oi; }
  }
  float* rv = smem + 128;
  int* ri = reinterpret_cast<int*>(smem + 160);
  if (lane == 0) {
    rv[warp] = bv;
    ri[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    bv = lane < NT / 32 ? rv[lane] : -INFINITY;
    bi = lane < NT / 32 ? ri[lane] : 0x7fffffff;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (better(bv, bi, ov, oi)) { bv = ov; bi = oi; }
    }
    if (lane == 0) tok_out[0] = bi;
  }
}

// ---------------------------------------------------------------- kernels of the chain

template <int BITS, int ROWS, int KIND>
__global__ void __launch_bounds__(THREADS) gemv_kernel(GemvArgs a) {
  extern __shared__ __align__(16) float smem[];
  ChainSync sync;
  sync.start();
  gemv_phase<BITS, ROWS, 8 / ROWS, KIND>(a, smem, blockIdx.x, gridDim.x, sync);
}

__global__ void __launch_bounds__(32 * ATTN_WARPS)
attn_kernel(const float* qkv, const float* invf, bf16* kc, bf16* vc, float* part, int H, int hd,
            int t, int off, int nsplit, float scale) {
  extern __shared__ __align__(16) float smem[];
  ChainSync sync;
  sync.start();
  attn_phase(qkv, invf, kc, vc, part, H, hd, t, off, nsplit, scale, smem, blockIdx.x, gridDim.x, sync);
}

// ---------------------------------------------------------------- host side

struct DecodePlan {   // mirrored field by field in ops/decode_step.py
  const void *emb, *invf, *attn_norm, *wqkv, *wqs, *wo, *wos, *mlp_norm, *wgu, *wgus, *wd, *wds,
      *final_norm, *head, *head_s;
  void *k_all, *v_all, *h, *qkv, *part, *act, *logits, *tok_out, *bar, *stamps;
  int L, D, H, hd, F, V, S;
  int pad_id, bos_id, eos_id, greedy, top_k, bits;
  float eps, scale, temperature;
};

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// Launches on one stream with programmatic dependent launch; the first
// error sticks.
struct Chain {
  cudaStream_t st;
  cudaError_t err = cudaSuccess;

  template <class... P, class... A>
  void launch(void (*kernel)(P...), int grid, int block, size_t smem, A... args) {
    if (err != cudaSuccess) return;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(block);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, P(args)...);
  }
};

// Input vector, reduction scratch and, where the phase normalises, the norm weights.
inline size_t gemv_smem(int C, int bits, bool norm) {
  return (size_t)(xlen(C, 128 / bits) + 32 + (norm ? C : 0)) * sizeof(float);
}
inline size_t attn_smem(int hd, int nwarps) { return (size_t)(3 * hd + 4 + nwarps * (hd + 2)) * sizeof(float); }

// Rows a warp owns: as many as keep 8 loads a lane in flight, fewer while
// the grid would leave SMs without a block.
inline int pick_rows(int total_rows, int nchunks, int min_rows) {
  const int J = (nchunks + 31) / 32;
  int rows = J >= 8 ? 1 : (J >= 4 ? 2 : (J >= 2 ? 4 : 8));
  while (rows > min_rows && total_rows / rows < sm_count() * WARPS) rows /= 2;
  return rows < min_rows ? min_rows : rows;
}

template <int BITS, int KIND>
void launch_gemv(Chain& ch, const GemvArgs& a) {
  constexpr int EPL = 128 / BITS;
  constexpr int MIN_ROWS = KIND == GATE_UP ? 2 : 1;
  const int rows = pick_rows(a.R, a.C / EPL, MIN_ROWS);
  const int units = (a.R + rows * WARPS - 1) / (rows * WARPS);
  const size_t smem = gemv_smem(a.C, BITS, KIND == QKV || KIND == GATE_UP);
  switch (rows) {
    case 8: ch.launch(gemv_kernel<BITS, 8, KIND>, units, THREADS, smem, a); break;
    case 4: ch.launch(gemv_kernel<BITS, 4, KIND>, units, THREADS, smem, a); break;
    case 2: ch.launch(gemv_kernel<BITS, 2, KIND>, units, THREADS, smem, a); break;
    default:
      if constexpr (KIND != GATE_UP) ch.launch(gemv_kernel<BITS, 1, KIND>, units, THREADS, smem, a);
  }
}

inline GemvArgs gemv_args(const int8_t* W, const float* s, int R, int C) {
  GemvArgs a = {};
  a.W = W;
  a.s = s;
  a.R = R;
  a.C = C;
  return a;
}

// Attention half-layer: h <- h + wo . attn(rmsnorm(h)), cache row t written
// in place. Scratch: qkv f32 [3N], part f32 [H, MAX_SPLITS, hd + PART_PAD].
template <int BITS>
void attn_half(Chain& ch, bf16* h, const float* nw, const int8_t* wqkv, const float* wqs,
               const int8_t* wo, const float* wos, const float* invf, bf16* kc, bf16* vc,
               float* qkv, float* part, int D, int H, int hd, int t, int off, float eps,
               float scale) {
  const int N = H * hd;
  const int nsplit = attn_splits(t - off);
  GemvArgs a = gemv_args(wqkv, wqs, 3 * N, D);
  a.h = h; a.nw = nw; a.eps = eps; a.out = qkv;
  launch_gemv<BITS, QKV>(ch, a);
  ch.launch(attn_kernel, H * nsplit, 32 * ATTN_WARPS, attn_smem(hd, ATTN_WARPS),
            qkv, invf, kc, vc, part, H, hd, t, off, nsplit, scale);
  GemvArgs o = gemv_args(wo, wos, D, N);
  o.h = h; o.part = part; o.hd = hd; o.nsplit = nsplit;
  launch_gemv<BITS, WO>(ch, o);
}

// MLP half-layer: h <- h + down . (silu(g) * u). Scratch: act bf16 [F].
template <int BITS>
void mlp_half(Chain& ch, bf16* h, const float* nw, const int8_t* wgu, const float* wgus,
              const int8_t* wd, const float* wds, bf16* act, int D, int F, float eps) {
  GemvArgs a = gemv_args(wgu, wgus, 2 * F, D);
  a.h = h; a.nw = nw; a.eps = eps; a.act = act;
  launch_gemv<BITS, GATE_UP>(ch, a);
  GemvArgs d = gemv_args(wd, wds, D, F);
  d.h = h; d.xin = act;
  launch_gemv<BITS, DOWN>(ch, d);
}

template <int BITS>
__host__ __device__ __forceinline__ size_t row_bytes(int C) { return (size_t)C * BITS / 8; }

// ---------------------------------------------------------------- persistent kernel

// One block of THREADS an SM (what its registers allow); the rows a warp owns
// in each phase are set so that the flagship widths give every block one
// unit on 132 SMs; other widths and SM counts loop over units.
template <int BITS>
__global__ void __launch_bounds__(THREADS)
mega_persistent_kernel(DecodePlan p, const int* tok_in, int t, int off, int suppress, int seed) {
  extern __shared__ __align__(16) float smem[];
  GridSync sync{(unsigned*)p.bar, 0u, gridDim.x, (unsigned long long*)p.stamps, 0};
  const int bid = blockIdx.x, nblk = gridDim.x;
  const int N = p.H * p.hd, D = p.D, F = p.F, S = p.S;
  const int nsplit = attn_splits(t - off, nblk / p.H);   // one (head, split) unit a block at most
  bf16* h = (bf16*)p.h;
  for (int l = 0; l < p.L; ++l) {
    const int8_t* wqkv = (const int8_t*)p.wqkv + (size_t)l * 3 * N * row_bytes<BITS>(D);
    const int8_t* wo = (const int8_t*)p.wo + (size_t)l * D * row_bytes<BITS>(N);
    const int8_t* wgu = (const int8_t*)p.wgu + (size_t)l * 2 * F * row_bytes<BITS>(D);
    const int8_t* wd = (const int8_t*)p.wd + (size_t)l * D * row_bytes<BITS>(F);
    GemvArgs a = {};
    a.W = wqkv;
    a.s = (const float*)p.wqs + (size_t)l * 3 * N;
    a.R = 3 * N; a.C = D; a.h = h; a.nw = (const float*)p.attn_norm + (size_t)l * D; a.eps = p.eps;
    a.tok = l == 0 ? tok_in : nullptr; a.emb = (const bf16*)p.emb; a.out = (float*)p.qkv;
    gemv_phase<BITS, 4, 2, QKV>(a, smem, bid, nblk, sync);
    attn_phase((const float*)p.qkv, (const float*)p.invf, (bf16*)p.k_all + (size_t)l * S * N,
               (bf16*)p.v_all + (size_t)l * S * N, (float*)p.part, p.H, p.hd, t, off, nsplit,
               p.scale, smem, bid, nblk, sync);
    GemvArgs o = {};
    o.W = wo;
    o.s = (const float*)p.wos + (size_t)l * D;
    o.R = D; o.C = N; o.h = h; o.part = (const float*)p.part; o.hd = p.hd; o.nsplit = nsplit;
    gemv_phase<BITS, 1, 2, WO>(o, smem, bid, nblk, sync);
    GemvArgs g = {};
    g.W = wgu;
    g.s = (const float*)p.wgus + (size_t)l * 2 * F;
    g.R = 2 * F; g.C = D; g.h = h; g.nw = (const float*)p.mlp_norm + (size_t)l * D; g.eps = p.eps;
    g.act = (bf16*)p.act;
    gemv_phase<BITS, 8, 2, GATE_UP>(g, smem, bid, nblk, sync);
    GemvArgs d = {};
    d.W = wd;
    d.s = (const float*)p.wds + (size_t)l * D;
    d.R = D; d.C = F; d.h = h; d.xin = (const bf16*)p.act;
    gemv_phase<BITS, 1, 8, DOWN>(d, smem, bid, nblk, sync);
  }
  GemvArgs a = {};   // the head runs the QKV phase's code (no token: the residual is h)
  a.W = (const int8_t*)p.head; a.s = (const float*)p.head_s; a.R = p.V; a.C = D; a.h = h;
  a.nw = (const float*)p.final_norm; a.eps = p.eps; a.out = (float*)p.logits;
  gemv_phase<BITS, 4, 2, QKV>(a, smem, bid, nblk, sync);
  sync.arrive();
  sync.wait();
  if (bid == 0)
    sample_phase<THREADS, SAMPLE_VPT>((const float*)p.logits, p.V, p.pad_id, p.bos_id, p.eos_id,
                                       suppress, p.greedy, p.temperature, p.top_k, (uint32_t)seed,
                                       (int*)p.tok_out, smem);
  __syncthreads();
  if (threadIdx.x == 0) sync.stamp(0);   // the step's end, in the slot after the last barrier
}

template <int BITS>
int mega_persistent(const DecodePlan& p, const int* tok_in, int t, int off, int suppress, int seed,
                    cudaStream_t st) {
  size_t smem = gemv_smem(p.D, BITS, true);   // also holds the sampler's 192 floats
  const size_t wide = gemv_smem(max(p.H * p.hd, p.F), BITS, false);
  if (wide > smem) smem = wide;
  if (attn_smem(p.hd, WARPS) > smem) smem = attn_smem(p.hd, WARPS);
  int occ = 0;   // the grid is one block an SM, all co-resident
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &occ, mega_persistent_kernel<BITS>, THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  if (occ < 1) return (int)cudaErrorLaunchOutOfResources;
  e = cudaMemsetAsync(p.bar, 0, sizeof(unsigned), st);
  if (e != cudaSuccess) return (int)e;
  DecodePlan pv = p;
  void* args[] = {&pv, &tok_in, &t, &off, &suppress, &seed};
  e = cudaLaunchCooperativeKernel((void*)mega_persistent_kernel<BITS>, dim3(sm_count()),
                                  dim3(THREADS), args, smem, st);
  return (int)e;
}

}  // namespace

// All entry points: `bits` is 8 (int8 weights, one value a byte) or 4 (two
// offset-binary values a byte along the contraction axis, low nibble = even
// index); weights are output-major rows; every pointer is device memory on
// `stream`'s device; the return value is the first CUDA error (or
// cudaErrorInvalidValue for another `bits`).

// Attention partials per head that `part` buffers must hold, and the floats
// of one partial beyond its hd channels.
extern "C" int decode_max_splits() { return MAX_SPLITS; }
extern "C" int decode_part_pad() { return PART_PAD; }

// One attention half-layer. h bf16 [D] and the caches kc/vc bf16 [S, N]
// (row t) are updated in place. wqkv [3N, D], wo [D, N]; scales f32 [3N],
// [D]; nw f32 [D]; invf f32 [hd/2]; scratch qkv f32 [3N], part f32
// [H, MAX_SPLITS, hd + PART_PAD].
extern "C" int attn_step(void* h, const void* nw, const void* wqkv, const void* wqs,
                         const void* wo, const void* wos, const void* invf, void* kc,
                         void* vc, void* qkv, void* part, int D, int H, int hd, int S,
                         int t, int off, float eps, float scale, int bits, void* stream) {
  (void)S;
  Chain ch{(cudaStream_t)stream};
  if (bits == 8)
    attn_half<8>(ch, (bf16*)h, (const float*)nw, (const int8_t*)wqkv, (const float*)wqs,
                 (const int8_t*)wo, (const float*)wos, (const float*)invf, (bf16*)kc, (bf16*)vc,
                 (float*)qkv, (float*)part, D, H, hd, t, off, eps, scale);
  else if (bits == 4)
    attn_half<4>(ch, (bf16*)h, (const float*)nw, (const int8_t*)wqkv, (const float*)wqs,
                 (const int8_t*)wo, (const float*)wos, (const float*)invf, (bf16*)kc, (bf16*)vc,
                 (float*)qkv, (float*)part, D, H, hd, t, off, eps, scale);
  else
    return (int)cudaErrorInvalidValue;
  return (int)ch.err;
}

// One MLP half-layer. h bf16 [D] is updated in place. wgu [2F, D] (gate
// rows then up rows), wd [D, F]; scales f32 [2F], [D]; scratch act bf16 [F].
extern "C" int mlp_step(void* h, const void* nw, const void* wgu, const void* wgus,
                        const void* wd, const void* wds, void* act, int D, int F,
                        float eps, int bits, void* stream) {
  Chain ch{(cudaStream_t)stream};
  if (bits == 8)
    mlp_half<8>(ch, (bf16*)h, (const float*)nw, (const int8_t*)wgu, (const float*)wgus,
                (const int8_t*)wd, (const float*)wds, (bf16*)act, D, F, eps);
  else if (bits == 4)
    mlp_half<4>(ch, (bf16*)h, (const float*)nw, (const int8_t*)wgu, (const float*)wgus,
                (const int8_t*)wd, (const float*)wds, (bf16*)act, D, F, eps);
  else
    return (int)cudaErrorInvalidValue;
  return (int)ch.err;
}

// One decode step over a plan (the checked pointers and constants of one
// engine, cache and scratch). Weights stacked over layers: wqkv [L,3N,D],
// wo [L,D,N], wgu [L,2F,D] (gate rows then up rows), wd [L,D,F], head
// [V,D]; scales f32 [L,3N], [L,D], [L,2F], [L,D], [V]; norms f32 [L,D] /
// [D]; emb bf16 [V,D]; invf f32 [hd/2]. Caches k_all/v_all bf16 [L,S,N] are
// updated in place at row t. Scratch: h bf16 [D] (holds the last layer's
// residual on return), qkv f32 [3N], part f32 [H, MAX_SPLITS, hd +
// PART_PAD], act bf16 [F], logits f32 [V], tok_out int32 [1], bar uint32
// [1]; stamps is null or int64 [5 L + 3, SMs, 2] (when each block arrived
// at and left each grid barrier, in ns). tok_in is int32 [1] on the device
// (it may be tok_out).
extern "C" int mega_decode_step(const void* plan, const void* tok_in, int t, int off,
                                int suppress, int seed, void* stream) {
  const DecodePlan& p = *(const DecodePlan*)plan;
  cudaStream_t st = (cudaStream_t)stream;
  if (p.bits == 8) return mega_persistent<8>(p, (const int*)tok_in, t, off, suppress, seed, st);
  if (p.bits == 4) return mega_persistent<4>(p, (const int*)tok_in, t, off, suppress, seed, st);
  return (int)cudaErrorInvalidValue;
}
