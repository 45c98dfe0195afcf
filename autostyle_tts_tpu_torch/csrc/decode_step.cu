// One B=1 decode step of the int8 / int4 speech-token LM for sm_90a, and its
// two half-layers as entry points of their own.
//
// Replaces, of autostyle_tts_tpu/ops/pallas_decode.py:
//   attn_step (_attn_kernel): rmsnorm, QKV GEMV, RoPE, cache row write at
//     slot t, attention over [off, t) plus the current token, wo + residual
//     ->  attn_half_kernel (the device function attn_half);
//   mlp_step (_mlp_kernel): rmsnorm, gate|up, silu(g)*u, down + residual
//     ->  mlp_half_kernel (mlp_half);
//   mega_decode_step (_mega_kernel), int8 and int4: embedding row of the
//     previous token, the L layers above (attn_half, mlp_half), final
//     rmsnorm, speech-head GEMV, pad/BOS (and EOS while `suppress`)
//     masking, temperature, top-k with the reference's tie rule and a
//     Gumbel-max sample -> mega_persistent_kernel.
//
// What bounds it on the H100. Bytes, in principle: one step streams ~235 M
// layer weights and ~4.2 M of speech head (252.6 MB at int8, 133.1 MB at
// int4) and up to ~22 MB of bf16 cache (at the flagship width: L=14,
// D=1024, F=4096, V=4099, S=392): 75 / 40 us at 3.35 TB/s. In practice the
// step is a chain of 5 dependent phases a layer, and what it takes beyond
// its bytes is the chain's latency: per phase a wait for what other blocks
// wrote (one trip through L2 at the least, longer while the phase's weight
// loads crowd the memory system), a prologue, the dot products and an
// epilogue. Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md,
// scripts/time_decode_step.py), the int4 step spends ~17 us a layer, each
// phase's lap (last arrival to last arrival) 2.9-4.0 us, of which the
// slowest block's work is 1.3-2.9 us and the rest the wait; the head 5.7,
// the sampler's merge 8.4. Its parent spent 19.9 us a layer and 22 us in a
// sampler on one SM. A half-layer call moves 5.1 / 12.6 MB at int8 (1.5 /
// 3.8 us) and takes 11.6 / 11.3 us of device time (attention / MLP), 9.0 /
// 7.7 of it from its last block's start to its end: a launch, then a chain
// of three / two phases like the step's.
//
// Design. The TPU kernel runs its grid in order on one core and carries the
// residual in VMEM between grid steps; blocks on the GPU run in parallel and
// share nothing, so the step is split where a dependence crosses blocks.
// Every phase is a __device__ function over (block id, block count) and a
// `Sync` that separates it from the phase before:
//   - GEMV phases: weights are output-major; a block starts its 16-byte
//     loads of every weight row it owns (the whole matrix is in flight
//     across the grid), the rows' scales and (cp.async) the norm weights
//     BEFORE it waits for the previous phase, because none of them depends
//     on it. Then the prologue puts the input vector into shared memory
//     (the rmsnorm of the residual, the merge of the attention partials, or
//     the activation), rounded to bf16 as the reference rounds it.
//     int8 (gemv_phase): a warp owns ROWS rows; int-to-float by one PRMT and
//     one FADD a weight, f32 FMAs, four partial sums per 16-byte chunk.
//     int4 (gemv4_phase): the dots run on the tensor cores. The weights are
//     stored in mma fragment order (ops/decode_step.py pack4): a row-group
//     of 16 rows is cut into tiles of 64 contraction elements, and one
//     lane's 16 bytes of a tile are its A fragments of mma.sync.m16n8k16 for
//     the tile's four k-steps, so a warp's 512-byte load is one tile, read
//     once, already in the order the registers need (no shared-memory
//     staging, no ldmatrix: the packer does the permutation once; a width
//     of 32 mod 64 ends each row-group with a half tile, two k-steps, 8
//     bytes a lane). A nibble
//     becomes a bf16 by one LOP3 under the exponent of 128 and one packed
//     bf16 FMA that takes the 128 + 8 offset off (two weights an
//     instruction pair, against ~3.4 instructions a weight in f32); int4
//     values and the bf16 input are exact, so every product equals the
//     int8 path's and only the order of the f32 sums differs: two
//     accumulators a warp (even and odd k-steps), then the warps that split
//     a row-group's tiles in warp order, then the row's scale. B is the
//     input vector in every column (the other seven columns repeat the
//     first; at B=1 the tensor cores idle either way). A unit is two
//     row-groups (QKV, the head), four (gate|up: two gate, two up) or one
//     (wo, down), so that no block runs two units in turn at the flagship
//     widths.
//   - attention (attn_phase): a grid of (head, split), hd/8 lanes a key row,
//     running (max, sum, acc) merged over lanes, warps, and in the wo
//     phase's prologue over splits; split 0 ropes k, writes cache row t and
//     folds in the current token's f32 k/v. No per-slot array: the cache
//     length has no cap.
//   - the sampler (sample_local, sample_merge): fused into the head. A
//     block keeps the logits of each of its head units (32 rows; int4: two
//     row-groups, or the tail) in shared memory; a warp a unit sorts them
//     (bitonic, by value then id) and writes the unit's list: its distinct
//     levels (at most k) with, per level, the best Gumbel score and the
//     smallest id at or above it and the smallest id below it. The last
//     block to take a ticket (as csrc/log_mel.cu sums its partials) merges
//     the lists, two levels a round, into the k-th distinct value, then
//     picks the token from each list's record at that level. No block waits
//     on a grid barrier for the sampler, and no block runs it alone. One
//     warp merges up to 288 lists, so V <= 8192 on any SM count (a block
//     holds more than one unit where the lists outnumber the SMs).
// The step is one persistent cooperative kernel, one block an SM. The waits
// between its phases are as narrow as the dependence:
//   - the residual h and the activation pass between blocks as 32-bit words
//     (tag << 16 | bf16 bits; the tag counts the buffer's writes), q, k, v
//     as 64-bit words (tag << 32 | f32 bits): a reader spins on the words
//     themselves until each carries the tag it expects, so the wait and the
//     read are one trip to L2 and no counter is touched (rmsnorm before QKV
//     / gate|up / head, the residual of wo / down, the activation of down,
//     and the attention of head h, which needs only head h's q, k, v);
//   - only wo, which needs every head's partials, waits on a grid barrier.
// Measured against a grid barrier before every phase (the same sums, three
// calls), the narrow waits saved 22-25 us of the int4 step; the int8 one
// gained 7 and 10 us and lost 4.
// Tried and measured slower (PERF.md): a block a head doing its QKV and
// its whole attention (the key loop is latency-bound in one block);
// prefetching the next layer's weights into L2; polling the tagged words
// harder or with a pause.
// A half-layer is one persistent cooperative launch of its own on the same
// device functions as the step's layer loop (attn_half: QKV, attention, the
// grid barrier, wo; mlp_half: gate|up, down), so the three entry points run
// one device code. Its residual is the caller's plain bf16 h, read by the
// first phase and updated in place by the last; q, k, v and the activation
// pass as tagged words of the scratch, with even tags counted from the
// scratch's count of calls of that half (the step's are odd: the two may
// share a scratch). The last block to take the call's ticket raises that
// count and leaves the grid counter and the ticket at 0, so a call needs
// no host operation besides its launch.
// Buffers another phase wrote are read with ld.global.cg or ld.relaxed.gpu,
// never through L1. No float atomics: two runs give the same bits.
//
// Rounding points follow the reference: the residual is bf16 between phases,
// q/k/v and logits are f32, the attention output and silu(g)*u are rounded
// to bf16 before their projections, norms and softmax are f32; the current
// token attends with its unrounded f32 k/v while the cache receives their
// bf16 rounding. Random bits come from Philox4x32-10 keyed by the step's
// seed, counter = vocab id; the plain twin in ops/decode_step.py draws the
// same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;
constexpr float NEG_INF = -1e30f;
constexpr int WARPS = 8;              // GEMV block
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_SPLITS = 16;        // attention partials per head
constexpr int SPLIT_KEYS = 24;        // live slots per split, until MAX_SPLITS caps it
constexpr int PART_PAD = 4;           // a partial is acc[hd], m, l, 2 unused floats
constexpr int SAMPLE_ROWS = 32;       // logits of one head unit, the sampler's list of them
constexpr int MAX_LISTS = 288;        // lists one warp merges (9 a lane): V <= 8192 at either width
constexpr int CAND_WORDS = 4 + SAMPLE_ROWS + 4 * SAMPLE_ROWS;   // a list: header, levels, records
constexpr unsigned SPIN_LIMIT = 1u << 24;   // polls before a wait gives up and traps
// words of a scratch's `bar` buffer: the step's count of steps run (kept
// across steps), its grid counter and ticket (zeroed by the host before each
// step); then the half-layers' own, which no host operation touches: their
// counts of attention and of MLP calls (the tags' base) and their grid
// counter and ticket (left at 0 by the last block of each call)
constexpr int BAR_EPOCH = 0, BAR_GRID = 1, BAR_TICKET = 2, BAR_ATTN_CALLS = 3, BAR_MLP_CALLS = 4,
              BAR_HALF_GRID = 5, BAR_HALF_TICKET = 6, BAR_WORDS = 7;

enum Kind { QKV, GATE_UP, WO, DOWN, HEAD };   // HEAD: QKV's arithmetic, logits kept for the sampler

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

__device__ __forceinline__ void spin_guard(unsigned& n) {
  if (++n > SPIN_LIMIT) __trap();   // a wait that never ends fails the launch instead of hanging the card
}

// ---------------------------------------------------------------- tagged words

__device__ __forceinline__ uint4 ld_relaxed4(const unsigned* p) {
  uint4 v;
  asm volatile("ld.relaxed.gpu.global.v4.u32 {%0,%1,%2,%3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_relaxed(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" :: "l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// The tag of a buffer's n-th write by the step (odd) or by a half-layer
// (even): never 0 (what a fresh buffer holds), never the tag of the write
// before, and never a tag of the other kind, so that the step and the
// half-layers may share a scratch's q, k, v and activation words without
// one reading the other's as fresh.
__device__ __forceinline__ unsigned write_tag(unsigned n) { return 1u + 2u * (n % 32767u); }
__device__ __forceinline__ unsigned half_tag(unsigned n) { return 2u + 2u * (n % 32767u); }
__device__ __forceinline__ unsigned tag_word(float v, unsigned tag) {
  return (tag << 16) | (unsigned)__bfloat16_as_ushort(__float2bfloat16(v));
}
__device__ __forceinline__ float word_value(unsigned w) { return __uint_as_float(w << 16); }

// Four tagged words v loaded from p (16-byte aligned) as floats: where one
// does not carry `tag` yet, the four are read again until all do. A reader
// issues all its loads first and settles them after, so that waiting costs
// one trip to L2, not one a load.
__device__ __forceinline__ void settle4(uint4 v, const unsigned* p, unsigned tag, float* f) {
  unsigned n = 0;
  while ((v.x >> 16) != tag || (v.y >> 16) != tag || (v.z >> 16) != tag || (v.w >> 16) != tag) {
    spin_guard(n);
    v = ld_relaxed4(p);
  }
  f[0] = word_value(v.x); f[1] = word_value(v.y); f[2] = word_value(v.z); f[3] = word_value(v.w);
}

// q, k, v of the step pass from the QKV phase to the attention as 64-bit
// words (tag << 32 | f32 bits).
__device__ __forceinline__ unsigned long long ld_relaxed64(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ float settle64(unsigned long long v, const unsigned long long* p, unsigned tag) {
  unsigned n = 0;
  while ((unsigned)(v >> 32) != tag) {
    spin_guard(n);
    v = ld_relaxed64(p);
  }
  return __uint_as_float((unsigned)v);
}
__device__ __forceinline__ void st_tagged64(unsigned long long* p, float x, unsigned tag) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(((unsigned long long)tag << 32) | __float_as_uint(x)) : "memory");
}

// ---------------------------------------------------------------- phase separators

// The persistent kernels (the step, the half-layers). A phase's wait is one
// of two kinds:
//   - `grid`: a barrier over all (co-resident) blocks on the counter
//     bar[BAR_GRID], in two halves: `arrive` once the block's part of the
//     previous phase is written, `wait` before it reads what others wrote;
//     the next phase's weight loads go between the two;
//   - tagged input words: nothing to do; the prologue's reads spin
//     (`mark_left` or `input_ready` marks the end of the wait).
// With `stamps` ([wait, block, 2] nanoseconds of %globaltimer) every block
// records when it arrived at each wait (its part of the previous phase
// written) and when it left it, for the phase breakdown of a kernel.
struct StepSync {
  unsigned* ctr;
  unsigned target;
  unsigned nblk;
  unsigned long long* stamps;
  int idx;
  bool grid;
  bool left;
  __device__ __forceinline__ void stamp(int which) {
    if (stamps != nullptr) {
      unsigned long long now;
      asm volatile("mov.u64 %0, %globaltimer;" : "=l"(now));
      stamps[((size_t)idx * nblk + blockIdx.x) * 2 + which] = now;
    }
  }
  __device__ __forceinline__ void arrive() {
    left = false;
    __syncthreads();   // the block is done with the previous phase (and its shared memory)
    if (grid) {
      target += nblk;
      if (threadIdx.x == 0) {
        stamp(0);
        __threadfence();
        atomicAdd(ctr, 1u);
      }
    } else if (threadIdx.x == 0) {
      stamp(0);
    }
  }
  __device__ __forceinline__ void wait() {
    if (!grid) return;
    if (threadIdx.x == 0) {
      unsigned n = 0;
      while (ld_acquire(ctr) < target) spin_guard(n);
      stamp(1);
    }
    left = true;
    __syncthreads();
  }
  // The block has read what the phase waits for (after a block barrier).
  __device__ __forceinline__ void mark_left() {
    if (!left && threadIdx.x == 0) stamp(1);
    left = true;
  }
  // End of the phase's wait (after the prologue's block barrier, or at once
  // where the block has nothing to read): stamps the leave if no wait did.
  __device__ __forceinline__ void input_ready() {
    mark_left();
    ++idx;
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
  const int8_t* W;      // [R, C] at BITS, output-major (int4: mma fragment order, see pack4)
  const float* s;       // [R] per-row scales
  int R, C;
  const float* nw;      // norm weights [C] (QKV, GATE_UP, HEAD)
  float eps;
  // the residual: the vector QKV / GATE_UP / HEAD normalise, the rows WO /
  // DOWN add to; plain bf16 (hin) or tagged words (hinx, with hin_tag)
  const bf16* hin;
  const unsigned* hinx;
  unsigned hin_tag;
  // WO / DOWN: the new residual rows, plain (hout) and / or tagged (houtx)
  bf16* hout;
  unsigned* houtx;
  unsigned hout_tag;
  const unsigned* xinx; // DOWN: the activation [C] as tagged words (xin_tag)
  unsigned xin_tag;
  const float* part;    // WO: attention partials [C / hd, MAX_SPLITS, hd + PART_PAD]
  int hd, nsplit;
  float* out;           // HEAD: f32 [R]
  unsigned* actx;       // GATE_UP: the activation [R / 2] as tagged words (act_tag)
  unsigned act_tag;
  unsigned long long* outx;   // QKV: q, k, v [R] as tagged 64-bit words (out_tag)
  unsigned out_tag;
  float* slot_val;      // HEAD: the block's logits (SAMPLE_ROWS a unit) in shared memory, and their ids
  int* slot_id;
};

// The byte `sel` of `word` (0..255) as the float 2^23 + byte: one PRMT puts
// it under the exponent of 2^23, where the mantissa's last bit weighs 1.
// (The constant goes first so that the selector stays an immediate.)
template <int SEL>
__device__ __forceinline__ float byte_as_float(unsigned word) {
  return __uint_as_float(__byte_perm(0x4B000000u, word, 0x3214 + SEL));
}

// sum_e W[e] * x[e] over one 16-byte chunk (16 int8 or 32 int4 elements of
// the plain byte layout), as four partial sums. Values become floats
// without an int-to-float conversion: int8 is flipped to offset-binary
// (b + 128), int4 nibbles already are (v + 8), and the offset leaves with
// the 2^23.
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

// int8: where element i of the input vector lives in shared memory (f32).
// A lane reads chunk c = lane + 32 j of 16 elements four floats at a time,
// so the vector is stored as [j][float4 of the chunk][lane][4] and each of
// those reads is one contiguous 512-byte row of the 32 lanes.
__device__ __forceinline__ int xpos(int i) {
  constexpr int EPL = 16;
  const int c = i / EPL, r = i % EPL;
  return (((c >> 5) * (EPL / 4) + (r >> 2)) << 7) + ((c & 31) << 2) + (r & 3);
}
// int4: the 32-bit word (a bf16 pair k, k + 1; k even) of the input vector
// in B-fragment order: for tile kt (64 elements), lane group q = (k / 2) % 4
// reads its b0, b1 of the tile's four k-steps as 8 consecutive words.
__device__ __forceinline__ int frag_word(int k) {
  const int kt = k >> 6, s = (k >> 4) & 3, h = (k >> 3) & 1, q = (k >> 1) & 3;
  return (((kt << 2) + q) << 3) + (s << 1) + h;
}
// Floats of shared memory the input vector takes.
__host__ __device__ __forceinline__ int xlen(int C, int bits) {
  return bits == 8 ? ((C / 16 + 31) / 32) * 32 * 16 : (C + 63) / 64 * 32;   // int4: whole tiles
}

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16(lo)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16);
}

// Elements i..i+3 (i % 4 == 0, values already at bf16) into the vector.
template <int BITS>
__device__ __forceinline__ void put_x4(float* x_s, int i, float v0, float v1, float v2, float v3) {
  if constexpr (BITS == 8) {
    *reinterpret_cast<float4*>(x_s + xpos(i)) = make_float4(v0, v1, v2, v3);
  } else {
    unsigned* w = reinterpret_cast<unsigned*>(x_s);
    w[frag_word(i)] = pack_bf16x2(v0, v1);
    w[frag_word(i + 2)] = pack_bf16x2(v2, v3);
  }
}

// Four residual elements i..i+3, plain or tagged: the load, then its values.
__device__ __forceinline__ uint4 load_h4(const GemvArgs& a, int i) {
  if (a.hinx != nullptr) return ld_relaxed4(a.hinx + i);
  const uint2 v = __ldcg(reinterpret_cast<const uint2*>(a.hin + i));
  return make_uint4(v.x, v.y, 0u, 0u);
}
__device__ __forceinline__ void settle_h4(const GemvArgs& a, int i, uint4 v, float* f) {
  if (a.hinx != nullptr) {
    settle4(v, a.hinx + i, a.hin_tag, f);
  } else {
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const bf162*>(&v.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const bf162*>(&v.y));
    f[0] = lo.x; f[1] = lo.y; f[2] = hi.x; f[3] = hi.y;
  }
}
// A residual row, started before the dots: the raw word (tagged) or the
// bf16 bits (plain); `res_value` finishes it where the epilogue needs it.
__device__ __forceinline__ unsigned load_res(const GemvArgs& a, int r) {
  return a.hinx != nullptr ? ld_relaxed(a.hinx + r) : (unsigned)__bfloat16_as_ushort(__ldcg(a.hin + r)) << 16;
}
__device__ __forceinline__ float res_value(const GemvArgs& a, int r, unsigned w) {
  if (a.hinx == nullptr) return __uint_as_float(w);
  unsigned n = 0;
  while ((w >> 16) != a.hin_tag) {
    spin_guard(n);
    w = ld_relaxed(a.hinx + r);
  }
  return word_value(w);
}
__device__ __forceinline__ void store_h1(const GemvArgs& a, int r, float v) {
  if (a.houtx != nullptr) st_relaxed(a.houtx + r, tag_word(v, a.hout_tag));
  if (a.hout != nullptr) a.hout[r] = __float2bfloat16(v);
}
__device__ __forceinline__ void store_act1(const GemvArgs& a, int i, float v) {
  st_relaxed(a.actx + i, tag_word(v, a.act_tag));
}

// The prologue: the phase's input vector into shared memory at bf16.
//   QKV, GATE_UP, HEAD: bf16(rmsnorm(h) * nw); WO: the merged attention
//   partials; DOWN: the activation. `nw_s` is on its way by cp.async.
constexpr int NORM_GROUPS = 1;   // four elements a group, in registers: widths up to 1024 in one pass
constexpr int ACT_GROUPS = 2;    // eight elements a group: 4096 a round of loads
template <int BITS, int KIND>
__device__ __forceinline__ void input_prologue(const GemvArgs& a, float* x_s, float* red, const float* nw_s) {
  const int C = a.C;
  if constexpr (KIND == QKV || KIND == GATE_UP || KIND == HEAD) {
    // the first NORM_GROUPS groups of a thread stay in registers; a wider
    // vector reads the rest twice (once for the sum of squares)
    const int span = NORM_GROUPS * 4 * blockDim.x;
    float v[NORM_GROUPS][4];
    uint4 raw[NORM_GROUPS];
    float ss = 0.f;
    for (int c0 = 0; c0 < C; c0 += span) {
#pragma unroll
      for (int g = 0; g < NORM_GROUPS; ++g) {   // every load in flight before the first is used
        const int i = c0 + (threadIdx.x + g * blockDim.x) * 4;
        if (i < C) raw[g] = load_h4(a, i);
      }
#pragma unroll
      for (int g = 0; g < NORM_GROUPS; ++g) {
        const int i = c0 + (threadIdx.x + g * blockDim.x) * 4;
        if (i < C) {
          settle_h4(a, i, raw[g], v[g]);
          ss += v[g][0] * v[g][0] + v[g][1] * v[g][1] + v[g][2] * v[g][2] + v[g][3] * v[g][3];
        }
      }
    }
    cp_async_wait_all();
    ss = block_sum(ss, red);   // its barriers also publish nw_s
    const float inv = rsqrtf(ss / (float)C + a.eps);
    for (int c0 = 0; c0 < C; c0 += span) {
#pragma unroll
      for (int g = 0; g < NORM_GROUPS; ++g) {
        const int i = c0 + (threadIdx.x + g * blockDim.x) * 4;
        if (i < C) {
          if (c0 > 0) settle_h4(a, i, load_h4(a, i), v[g]);
          put_x4<BITS>(x_s, i, bf16_round(v[g][0] * inv * nw_s[i]), bf16_round(v[g][1] * inv * nw_s[i + 1]),
                       bf16_round(v[g][2] * inv * nw_s[i + 2]), bf16_round(v[g][3] * inv * nw_s[i + 3]));
        }
      }
    }
  } else if constexpr (KIND == DOWN) {   // eight elements a group, C % 16 == 0
    for (int c0 = 0; c0 < C; c0 += ACT_GROUPS * 8 * blockDim.x) {
      uint4 raw[ACT_GROUPS][2];
#pragma unroll
      for (int g = 0; g < ACT_GROUPS; ++g) {   // every load in flight before the first is used
        const int i = c0 + (threadIdx.x + g * blockDim.x) * 8;
        if (i < C) {
          raw[g][0] = ld_relaxed4(a.xinx + i);
          raw[g][1] = ld_relaxed4(a.xinx + i + 4);
        }
      }
#pragma unroll
      for (int g = 0; g < ACT_GROUPS; ++g) {
        const int i = c0 + (threadIdx.x + g * blockDim.x) * 8;
        if (i < C) {
          float f[8];
          settle4(raw[g][0], a.xinx + i, a.xin_tag, f);
          settle4(raw[g][1], a.xinx + i + 4, a.xin_tag, f + 4);
          put_x4<BITS>(x_s, i, f[0], f[1], f[2], f[3]);
          put_x4<BITS>(x_s, i + 4, f[4], f[5], f[6], f[7]);
        }
      }
    }
  } else {   // WO: merge the (head, split) partials; four channels of one head per thread
    const int stride = a.hd + PART_PAD;
    for (int i = threadIdx.x * 4; i < C; i += blockDim.x * 4) {
      const int hh = i / a.hd, e = i % a.hd;
      const float* p0 = a.part + (size_t)hh * MAX_SPLITS * stride;
      // eight splits a batch, each batch's loads started before their first use (one trip
      // to L2 up to 8 splits, the step's), merged online into (M, L, A)
      float M = NEG_INF, L = 0.f;
      float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int s0 = 0; s0 < a.nsplit; s0 += 8) {
        float2 ml[8];
        float4 v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const bool in = s0 + k < a.nsplit;
          ml[k] = in ? __ldcg(reinterpret_cast<const float2*>(p0 + (s0 + k) * stride + a.hd)) : make_float2(NEG_INF, 0.f);
          v[k] = in ? __ldcg(reinterpret_cast<const float4*>(p0 + (s0 + k) * stride + e)) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
        float Mb = M;
#pragma unroll
        for (int k = 0; k < 8; ++k) Mb = fmaxf(Mb, ml[k].x);
        const float r = expf(M - Mb);
        L *= r; A.x *= r; A.y *= r; A.z *= r; A.w *= r;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          if (s0 + k < a.nsplit) {
            const float wgt = expf(ml[k].x - Mb);
            L += ml[k].y * wgt;
            A.x += v[k].x * wgt; A.y += v[k].y * wgt; A.z += v[k].z * wgt; A.w += v[k].w * wgt;
          }
        }
        M = Mb;
      }
      put_x4<BITS>(x_s, i, bf16_round(A.x / L), bf16_round(A.y / L), bf16_round(A.z / L), bf16_round(A.w / L));
    }
  }
}

// The epilogue of one output row r (or, GATE_UP, output r from its gate
// and up sums); `res`: WO / DOWN's residual row, `slot`: HEAD's place for
// the logit in the block's list.
template <int KIND>
__device__ __forceinline__ void gemv_out(const GemvArgs& a, int r, float acc, float sc, float acc_u, float sc_u,
                                         unsigned res, int slot) {
  if constexpr (KIND == QKV) {
    st_tagged64(a.outx + r, acc * sc, a.out_tag);
  } else if constexpr (KIND == HEAD) {
    const float y = acc * sc;
    a.out[r] = y;
    a.slot_val[slot] = y;
    a.slot_id[slot] = r;
  } else if constexpr (KIND == GATE_UP) {
    const float g = acc * sc, u = acc_u * sc_u;
    store_act1(a, r, g * (1.f / (1.f + expf(-g))) * u);
  } else {
    store_h1(a, r, res_value(a, r, res) + acc * sc);
  }
}

// int8 GEMV phase over blocks bid, bid + nblk, ...: a block unit is
// blockDim/32 warps, a warp owns ROWS weight rows (GATE_UP: ROWS/2 gate rows
// and the ROWS/2 up rows F below them).
//   QKV / HEAD: out[r] = (W[r] . bf16(rmsnorm(h) * nw)) * s[r]
//   GATE_UP:    act[i] = bf16(silu(g_i) * u_i), g_i / u_i = rows i and F + i
//   WO:         h[r] = bf16(h[r] + (W[r] . bf16(merged attention)) * s[r])
//   DOWN:       h[r] = bf16(h[r] + (W[r] . act) * s[r])
template <int ROWS, int PF, int KIND, class Sync>
__device__ __forceinline__ void gemv_phase(const GemvArgs& a, float* smem, int bid, int nblk, Sync& sync) {
  // PF: 16-byte loads per row and lane in flight before the wait
  constexpr int EPL = 16;                 // elements per 16-byte load
  constexpr int OPW = KIND == GATE_UP ? ROWS / 2 : ROWS;   // outputs per warp
  static_assert(KIND != GATE_UP || ROWS >= 2, "gate|up needs a gate row and an up row");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int nout = KIND == GATE_UP ? a.R / 2 : a.R;
  const int C = a.C;
  const int nchunks = C / EPL;
  const size_t rb = (size_t)C;
  const int units = (nout + OPW * nwarps - 1) / (OPW * nwarps);
  float* x_s = smem;        // the input vector, at xpos(i)
  float* red = smem + xlen(C, 8);
  float* nw_s = red + 32;   // norm weights (QKV, GATE_UP, HEAD), in order

  int4 w[ROWS][PF];
  float sv[ROWS];           // the rows' scales
  unsigned res[ROWS];       // WO, DOWN: the residual rows (lane 0)
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

  int unit = bid, m = 0;   // m: the block's unit index (HEAD: which of its lists)
  int o0 = (unit * nwarps + warp) * OPW;
  sync.arrive();
  auto residual = [&](int o) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) res[r] = lane == 0 && o + r < nout ? load_res(a, o + r) : 0u;
  };
  if (unit < units) {
    prefetch(o0);
    if constexpr (KIND == QKV || KIND == GATE_UP || KIND == HEAD) {   // constant too: fetch it now
      for (int i = threadIdx.x * 4; i < C; i += blockDim.x * 4) cp_async16(nw_s + i, a.nw + i);
      cp_async_commit();
    }
  }
  sync.wait();
  if (unit < units) input_prologue<8, KIND>(a, x_s, red, nw_s);
  sync.input_ready();
  if (unit >= units) return;
  __syncthreads();

  for (;;) {
    if (o0 < nout) {
      float acc[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
      if constexpr (KIND == WO || KIND == DOWN)   // the residual rows, on their way during the dots
        residual(o0);
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
          for (int r = 0; r < ROWS; ++r) acc[r] += chunk_dot<8>(w[r][j], xv);
        }
      }
      for (int c = lane + 32 * PF; c < nchunks; c += 32) {   // rows longer than the prefetch
        int4 pk[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) pk[r] = ld_weight(a.W + (size_t)row_of(o0, r) * rb + 16 * (size_t)c);
        float xv[EPL];
#pragma unroll
        for (int e = 0; e < EPL; e += 4) {
          const float4 x4 = *reinterpret_cast<const float4*>(x_s + xpos(c * EPL + e));
          xv[e] = x4.x; xv[e + 1] = x4.y; xv[e + 2] = x4.z; xv[e + 3] = x4.w;
        }
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r] += chunk_dot<8>(pk[r], xv);
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = warp_sum(acc[r]);
      if (lane == 0) {
        if constexpr (KIND == GATE_UP) {
#pragma unroll
          for (int r = 0; r < OPW; ++r)
            if (o0 + r < nout) gemv_out<KIND>(a, o0 + r, acc[r], sv[r], acc[OPW + r], sv[OPW + r], 0u, 0);
        } else {
#pragma unroll
          for (int r = 0; r < ROWS; ++r)
            if (o0 + r < nout)
              gemv_out<KIND>(a, o0 + r, acc[r], sv[r], 0.f, 0.f, res[r], SAMPLE_ROWS * m + warp * ROWS + r);
        }
      }
    }
    unit += nblk;
    ++m;
    if (unit >= units) break;
    o0 = (unit * nwarps + warp) * OPW;
    prefetch(o0);
  }
}

// mma.sync m16n8k16, bf16 in, f32 accumulate: d += A . B.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One lane's word of an int4 tile (8 offset-binary nibbles; see pack4) ->
// its A fragment of one k-step as four bf16 pairs. Nibble t of the word
// pairs with nibble t + 4: (w >> 4t) & 0x000F000F under 0x4300 (bf16 128,
// whose last mantissa bit weighs 1) is the pair {128 + n_t, 128 + n_t+4};
// one FMA (x 1 - 136) makes it {v_t, v_t+4} exactly.
__device__ __forceinline__ void nibble_frag(unsigned w, unsigned (&fa)[4]) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const unsigned v = ((w >> (4 * t)) & 0x000F000Fu) | 0x43004300u;
    asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(fa[t]) : "r"(v), "r"(0x3F803F80u), "r"(0xC308C308u));
  }
}

// Row-groups of 16 rows in one int4 unit: QKV and the head take two
// consecutive ones, gate|up two gate row-groups and the two up row-groups
// F below them, wo and down one. At the flagship widths that leaves every
// block at most one unit a phase on 132 SMs.
template <int KIND>
__host__ __device__ constexpr int unit_rgs() {
  return KIND == GATE_UP ? 4 : (KIND == QKV || KIND == HEAD) ? 2 : 1;
}
// int4 units of a matrix of R rows (HEAD: and its tail of R % 16 plain rows).
template <int KIND>
__host__ __device__ __forceinline__ int units4(int R) {
  const int nrg = R / 16;
  if (KIND == GATE_UP) return nrg / 4;
  return (nrg + unit_rgs<KIND>() - 1) / unit_rgs<KIND>() + (KIND == HEAD && R % 16 ? 1 : 0);
}

// int4 GEMV phase on the tensor cores. A unit's row-groups each get WARPS /
// unit_rgs warps, which split the row-group's tiles of 64 contraction
// elements (warp ks of them takes tiles ks, ks + that count, ...; where C
// is 32 mod 64, the last tile is a half, two k-steps, 8 bytes a lane); each
// warp's partial sums are summed in warp order in shared memory, and one
// thread a row (gate|up: a gate row and its up row) applies the scales
// and the epilogue. Units bid, bid + nblk, ...: the first MU of them, TPW
// tiles a warp each, are loaded before the wait. HEAD's last unit may be
// a tail of R % 16 rows, stored in the plain byte layout: one warp a row.
template <int KIND, int MU, int TPW, class Sync>
__device__ __forceinline__ void gemv4_phase(const GemvArgs& a, float* smem, int bid, int nblk, Sync& sync) {
  constexpr int RG = unit_rgs<KIND>();
  constexpr int NSL = WARPS / RG;                          // warps that split a row-group's tiles
  constexpr int OUTS = KIND == GATE_UP ? 32 : 16 * RG;      // epilogue threads
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, tid = threadIdx.x;
  const int C = a.C, nk = C >> 6, nrg = a.R >> 4, tail = a.R & 15;
  const size_t rgb = (size_t)C * 8;                         // bytes of a row-group
  const int hrg = nrg >> 1;                                 // GATE_UP: the first up row-group
  const int nunits = units4<KIND>(a.R);
  const int nfull = nunits - (KIND == HEAD && tail > 0 ? 1 : 0);   // units in fragment order
  const int sel = warp / NSL, ks = warp % NSL;
  // row-group `sl` of a unit (GATE_UP: 0, 1 gate, 2, 3 up)
  auto rg_of = [&](int unit, int sl) {
    return KIND == GATE_UP ? (sl >= 2 ? hrg : 0) + 2 * unit + (sl & 1) : RG * unit + sl;
  };
  float* x_s = smem;
  const unsigned* xw = reinterpret_cast<const unsigned*>(smem);
  float* red = smem + xlen(C, 4);
  float* psum = red + 32;           // [WARPS][16] partial sums
  float* nw_s = psum + WARPS * 16;  // norm weights (QKV, GATE_UP, HEAD)

  int4 w[MU][TPW];
  float sv[MU], su[MU];
  unsigned rv[MU];   // WO, DOWN: the residual row (threads < 16)
  const int8_t* wl = a.W + lane * 16;
  auto load = [&](int unit, int4 (&wt)[TPW]) {
    const int rg = rg_of(unit, sel);
#pragma unroll
    for (int t = 0; t < TPW; ++t) {
      const int kt = ks + NSL * t;
      wt[t] = unit < nfull && rg < nrg && kt < nk ? ld_weight(wl + (size_t)rg * rgb + (size_t)kt * 512)
                                                   : make_int4(0, 0, 0, 0);
    }
  };
  auto scales = [&](int unit, float& s0, float& s1) {
    s0 = s1 = 0.f;
    if (tid < OUTS) {
      const int r = 16 * rg_of(unit, tid / 16) + tid % 16;
      if (r < a.R) s0 = __ldg(a.s + r);
      if (KIND == GATE_UP) s1 = __ldg(a.s + 16 * rg_of(unit, 2 + tid / 16) + tid % 16);
    }
  };
  // the tile's four k-steps (the half tile's first two): B from the vector
  // (the same 8 words for every lane of a lane group), A from the nibbles;
  // even and odd k-steps in two accumulators
  auto mma_tile = [&](float (&c)[2][4], const int4& q, int kt, int steps) {
    const uint4* xb = reinterpret_cast<const uint4*>(xw + (((kt << 2) + (lane & 3)) << 3));
    const uint4 b0 = xb[0], b1 = xb[1];
    const unsigned bw[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    const unsigned qw[4] = {(unsigned)q.x, (unsigned)q.y, (unsigned)q.z, (unsigned)q.w};
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (s < steps) {
        unsigned fa[4];
        nibble_frag(qw[s], fa);
        mma_bf16(c[s & 1], fa, bw[2 * s], bw[2 * s + 1]);
      }
    }
  };
  auto process = [&](int m, int unit, const int4 (&wt)[TPW], float s0, float s1, unsigned res) {
    if (unit >= nfull) {   // HEAD's tail: plain rows, one warp each
      for (int r16 = warp; r16 < tail; r16 += WARPS) {
        const int r = 16 * nrg + r16;
        const unsigned short* xh = reinterpret_cast<const unsigned short*>(xw);
        float acc = 0.f;
        for (int c = lane; c < C / 32; c += 32) {
          float xv[32];
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            const int k = 32 * c + e;
            xv[e] = __uint_as_float((unsigned)xh[2 * frag_word(k & ~1) + (k & 1)] << 16);
          }
          acc += chunk_dot<4>(ld_weight(a.W + (size_t)r * (C / 2) + 16 * (size_t)c), xv);
        }
        acc = warp_sum(acc);
        if (lane == 0) gemv_out<KIND>(a, r, acc, __ldg(a.s + r), 0.f, 0.f, 0u, SAMPLE_ROWS * m + r16);
      }
      return;
    }
    float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int t = 0; t < TPW; ++t)
      if (ks + NSL * t < nk) mma_tile(c, wt[t], ks + NSL * t, 4);
    const int rg = rg_of(unit, sel);
    for (int kt = ks + NSL * TPW; kt < nk && rg < nrg; kt += NSL)   // row-groups longer than the prefetch
      mma_tile(c, ld_weight(wl + (size_t)rg * rgb + (size_t)kt * 512), kt, 4);
    if ((C & 32) && nk % NSL == ks && rg < nrg) {   // C = 32 mod 64: a half tile ends the row-group
      const int2 q = __ldg(reinterpret_cast<const int2*>(a.W + (size_t)rg * rgb + (size_t)nk * 512 + lane * 8));
      mma_tile(c, make_int4(q.x, q.y, 0, 0), nk, 2);
    }
    if ((lane & 3) == 0) {   // c[.][0]: row lane / 4; c[.][2]: row lane / 4 + 8 (every column the same)
      psum[warp * 16 + (lane >> 2)] = c[0][0] + c[1][0];
      psum[warp * 16 + (lane >> 2) + 8] = c[0][2] + c[1][2];
    }
    __syncthreads();
    if (tid < OUTS && rg_of(unit, tid / 16) < nrg) {
      const int sl = tid / 16, r16 = tid % 16;
      float acc = 0.f, acc_u = 0.f;
#pragma unroll
      for (int k = 0; k < NSL; ++k) acc += psum[(sl * NSL + k) * 16 + r16];
      if constexpr (KIND == GATE_UP) {
#pragma unroll
        for (int k = 0; k < NSL; ++k) acc_u += psum[((2 + sl) * NSL + k) * 16 + r16];
      }
      gemv_out<KIND>(a, 16 * rg_of(unit, sl) + r16, acc, s0, acc_u, s1, res, SAMPLE_ROWS * m + tid);
    }
    __syncthreads();   // psum is written again by the next unit
  };

  sync.arrive();
#pragma unroll
  for (int m = 0; m < MU; ++m) {
    const int unit = bid + m * nblk;
    if (unit < nunits) {
      load(unit, w[m]);
      scales(unit, sv[m], su[m]);
      rv[m] = 0u;
      if constexpr (KIND == WO || KIND == DOWN)   // written phases before: read it before the wait
        if (tid < 16) rv[m] = load_res(a, 16 * unit + tid);
    }
  }
  if (bid < nunits) {
    if constexpr (KIND == QKV || KIND == GATE_UP || KIND == HEAD) {   // constant too: fetch it now
      for (int i = threadIdx.x * 4; i < C; i += blockDim.x * 4) cp_async16(nw_s + i, a.nw + i);
      cp_async_commit();
    }
  }
  sync.wait();
  if (bid < nunits) input_prologue<4, KIND>(a, x_s, red, nw_s);
  sync.input_ready();
  if (bid >= nunits) return;
  __syncthreads();
#pragma unroll
  for (int m = 0; m < MU; ++m) {
    const int unit = bid + m * nblk;
    if (unit < nunits) process(m, unit, w[m], sv[m], su[m], rv[m]);
  }
  for (int m = MU, unit = bid + MU * nblk; unit < nunits; ++m, unit += nblk) {
    int4 wt[TPW];
    float s0, s1;
    load(unit, wt);
    scales(unit, s0, s1);
    process(m, unit, wt, s0, s1, (KIND == WO || KIND == DOWN) && tid < 16 ? load_res(a, 16 * unit + tid) : 0u);
  }
}

// ---------------------------------------------------------------- attention phase

// Attention of one token over cache slots [off, t) and itself, as partials
// per (head, split); blocks bid, bid + nblk, ... take the units. qkvx: q, k,
// v [3N] from the QKV phase as tagged words (qkv_tag), read as soon as the
// head's own rows carry the tag, not after the whole QKV phase; kc/vc bf16
// [S, N], row t written by split 0; part f32 [H, MAX_SPLITS, hd +
// PART_PAD]. hd / 8 lanes span one key row, so hd is 8, 16, 32, 64, 128 or
// 256. smem: 3 hd + 4 + (blockDim / 32)(hd + 2) floats.
template <class Sync>
__device__ __forceinline__ void attn_phase(const unsigned long long* qkvx, unsigned qkv_tag, const float* invf,
                                           bf16* kc, bf16* vc, float* part, int H, int hd, int t, int off,
                                           int nsplit, float scale, float* smem, int bid, int nblk, Sync& sync) {
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
      const int at[5] = {base + i, base + partner, N + base + i, N + base + partner, 2 * N + base + i};
      float x[5];   // q_i, q_partner and (split 0) k_i, k_partner, v_i
      unsigned long long w[5];
#pragma unroll
      for (int j = 0; j < 5; ++j)
        if (j < 2 || sp == 0) w[j] = ld_relaxed64(qkvx + at[j]);
#pragma unroll
      for (int j = 0; j < 5; ++j)
        if (j < 2 || sp == 0) x[j] = settle64(w[j], qkvx + at[j], qkv_tag);
      const float ang = pos * invf[first ? i : i - half];
      const float c = cosf(ang), sn = sinf(ang);
      const float qi = x[0], qp = x[1];
      q_s[i] = first ? qi * c + (-qp) * sn : qi * c + qp * sn;
      if (sp == 0) {
        const float ki = x[2], kp = x[3];
        const float kr = first ? ki * c + (-kp) * sn : ki * c + kp * sn;
        const float vi = x[4];
        k_s[i] = kr;
        v_s[i] = vi;
        kc[(size_t)t * N + base + i] = __float2bfloat16(kr);
        vc[(size_t)t * N + base + i] = __float2bfloat16(vi);
      }
    }
    __syncthreads();
    sync.mark_left();
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
  sync.input_ready();
}

// ---------------------------------------------------------------- the sampler

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

// Float order as unsigned order, for redux.sync.
__device__ __forceinline__ unsigned float_order(float f) {
  const unsigned b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}
__device__ __forceinline__ float order_float(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u);
}

// The two largest distinct values of (a1 > a2) and (b1 > b2); -inf = none.
__device__ __forceinline__ void merge_top2(float& a1, float& a2, float b1, float b2) {
  const float hi = fmaxf(a1, b1), lo_c = fminf(a1, b1);
  float lo = fmaxf(a2, b2);
  if (lo_c < hi) lo = fmaxf(lo, lo_c);
  a1 = hi;
  a2 = lo;
}

// (score, id) ranks above (os, oi): the larger score, then the smaller id.
__device__ __forceinline__ bool ranks_above(float s, int i, float os, int oi) {
  return s > os || (s == os && i < oi);
}

struct SampleArgs {
  int V, pad_id, bos_id, eos_id, suppress, greedy, top_k;
  float temperature;
  uint32_t seed;
  unsigned* cand;       // [lists, CAND_WORDS]: header (levels, best score, best id, smallest id), levels, records
  int* tok_out;
};

// One head unit's part of the sampler, by one warp, from the logits the
// head left in `slot_val` / `slot_id` (id -1: empty), into list `list`.
// The reference masks, divides by the temperature (sampled), strips every
// value tied at the running max k - 1 times, keeps what is at or above the
// max of the rest (floored at -1e30 for k >= 2), adds Gumbel noise where
// the value is above -5e29, and takes the smallest id at the maximum. Per
// unit: the logits sorted by
// (value desc, id asc); level j = the j-th distinct value; its record:
// the best (score, id) at or above it, the smallest id below it. Header:
// the number of levels kept (at most k), the best (score, id) of all, the
// smallest id of all.
__device__ __noinline__ void sample_local(const SampleArgs& sa, const float* slot_val, const int* slot_id, int list) {
  const int lane = threadIdx.x & 31;
  const int id0 = slot_id[lane];
  const bool valid = id0 >= 0;
  const float tdiv = fmaxf(sa.temperature, 1e-6f);
  float y = -INFINITY;
  int id = 0x7FFFFFFF - lane;   // unique keys for the sort; empty entries sort last
  if (valid) {
    const bool bad = id0 == sa.pad_id || id0 == sa.bos_id || (id0 == sa.eos_id && sa.suppress);
    y = bad ? NEG_INF : slot_val[lane];
    if (!sa.greedy) y = y / tdiv;
    id = id0;
  }
  auto score_of = [&](float v, int i) {
    if (sa.greedy || !(v > 0.5f * NEG_INF)) return v;   // |noise| < 21: entries at -1e30 or below do not move
    const uint32_t bits = philox_c0((uint32_t)i, sa.seed) >> 8;
    const float u = (float)bits * (1.f / 16777216.f) + 1e-9f;
    return v - logf(-logf(u));
  };
  unsigned* rec = sa.cand + (size_t)list * CAND_WORDS;
  if (sa.greedy || sa.top_k <= 0) {   // no threshold: the unit's best is all it sends
    float bs = valid ? score_of(y, id) : -INFINITY;
    int bi = valid ? id : 0x7FFFFFFF;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float os = __shfl_xor_sync(0xffffffffu, bs, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (ranks_above(os, oi, bs, bi)) { bs = os; bi = oi; }
    }
    if (lane == 0) {
      rec[0] = 0u;
      rec[1] = __float_as_uint(bs);
      rec[2] = (unsigned)bi;
    }
    return;
  }
  // bitonic sort over the warp: lane 0 ends with the largest value (smallest id among ties)
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const float oy = __shfl_xor_sync(0xffffffffu, y, j);
      const int oi = __shfl_xor_sync(0xffffffffu, id, j);
      const bool first_kept = ((lane & k) == 0) == ((lane & j) == 0);
      const bool other_first = ranks_above(oy, oi, y, id);
      if (first_kept == other_first) { y = oy; id = oi; }
    }
  }
  const bool real = y > -INFINITY;
  const float prev = __shfl_up_sync(0xffffffffu, y, 1);
  const float next = __shfl_down_sync(0xffffffffu, y, 1);
  const bool opens = real && (lane == 0 || y != prev);
  const bool closes = real && (lane == 31 || y != next);
  const int level = __popc(__ballot_sync(0xffffffffu, opens) & (0xffffffffu >> (31 - lane))) - 1;
  // best (score, id) over lanes 0..lane
  float bs = real ? score_of(y, id) : -INFINITY;
  int bi = real ? id : 0x7FFFFFFF;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float os = __shfl_up_sync(0xffffffffu, bs, d);
    const int oi = __shfl_up_sync(0xffffffffu, bi, d);
    if (lane >= d && ranks_above(os, oi, bs, bi)) { bs = os; bi = oi; }
  }
  // smallest id over lanes lane+1..31
  int below = __shfl_down_sync(0xffffffffu, real ? id : 0x7FFFFFFF, 1);
  if (lane == 31) below = 0x7FFFFFFF;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_down_sync(0xffffffffu, below, d);
    if (lane + d < 32) below = min(below, o);
  }
  const int all_min = min(__shfl_sync(0xffffffffu, below, 0), __shfl_sync(0xffffffffu, real ? id : 0x7FFFFFFF, 0));
  const int nlev = min(__popc(__ballot_sync(0xffffffffu, opens)), sa.top_k);
  const unsigned last_real = __ballot_sync(0xffffffffu, real);
  const int top = last_real ? 31 - __clz(last_real) : 0;
  const float best_s = __shfl_sync(0xffffffffu, bs, top);
  const int best_i = __shfl_sync(0xffffffffu, bi, top);
  if (closes && level < nlev) {
    rec[4 + level] = __float_as_uint(y);
    unsigned* r = rec + 4 + SAMPLE_ROWS + 4 * level;
    r[0] = __float_as_uint(bs);
    r[1] = (unsigned)bi;
    r[2] = (unsigned)below;
  }
  if (lane == 0) {
    rec[0] = (unsigned)nlev;
    rec[1] = __float_as_uint(last_real ? best_s : -INFINITY);
    rec[2] = (unsigned)(last_real ? best_i : 0x7FFFFFFF);
    rec[3] = (unsigned)all_min;
  }
}

// The last block: merge the lists (one a head unit) into the k-th
// distinct value, threshold it as the reference does, and pick the token;
// LPL lists a lane (nlists <= 32 LPL). smem: nlists x (4 + SAMPLE_ROWS) words:
// each list's header and levels, loaded in one trip to L2.
template <int LPL>
__device__ __noinline__ void sample_merge(const SampleArgs& sa, int nlists, float* smem) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool thresholded = !sa.greedy && sa.top_k > 0;
  constexpr int Q = (4 + SAMPLE_ROWS) / 4;   // 16-byte pieces of a header and its levels
  constexpr int PER = (32 * LPL * Q + THREADS - 1) / THREADS;
  uint4* hl_s = reinterpret_cast<uint4*>(smem);
  if (thresholded) {
    uint4 v[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = threadIdx.x + j * THREADS;
      if (i < nlists * Q) v[j] = __ldcg(reinterpret_cast<const uint4*>(sa.cand + (size_t)(i / Q) * CAND_WORDS) + i % Q);
    }
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = threadIdx.x + j * THREADS;
      if (i < nlists * Q) hl_s[i] = v[j];
    }
    __syncthreads();
  }
  if (warp != 0) return;
  const unsigned* hl = reinterpret_cast<const unsigned*>(smem);   // [nlists][4 + SAMPLE_ROWS]
  auto lev = [&](int b, int p) { return __uint_as_float(hl[b * (4 + SAMPLE_ROWS) + 4 + p]); };
  float bs = -INFINITY;
  int bi = 0x7FFFFFFF, below = 0x7FFFFFFF;
  if (!thresholded) {
    uint4 r[LPL];
#pragma unroll
    for (int j = 0; j < LPL; ++j)
      if (lane + 32 * j < nlists) r[j] = __ldcg(reinterpret_cast<const uint4*>(sa.cand + (size_t)(lane + 32 * j) * CAND_WORDS));
#pragma unroll
    for (int j = 0; j < LPL; ++j) {
      if (lane + 32 * j < nlists) {
        const float s = __uint_as_float(r[j].y);
        const int i = (int)r[j].z;
        if (ranks_above(s, i, bs, bi)) { bs = s; bi = i; }
      }
    }
  } else {
    int pos[LPL], nl[LPL];
    float h1[LPL], h2[LPL];   // each list's first two levels not yet taken
#pragma unroll
    for (int j = 0; j < LPL; ++j) {
      const int b = lane + 32 * j;
      nl[j] = b < nlists ? (int)hl[b * (4 + SAMPLE_ROWS)] : 0;
      pos[j] = 0;
      h1[j] = nl[j] > 0 ? lev(b, 0) : -INFINITY;
      h2[j] = nl[j] > 1 ? lev(b, 1) : -INFINITY;
    }
    // a round takes the two largest distinct levels left over all lists (one
    // where one is left to find): ceil(k / 2) rounds find the k-th
    float dk = -INFINITY;
    bool full = true;   // k levels found: each list's cursor counts its levels at or above dk
    for (int left = sa.top_k; left > 0;) {
      float a1 = -INFINITY, a2 = -INFINITY;
#pragma unroll
      for (int j = 0; j < LPL; ++j) merge_top2(a1, a2, h1[j], h2[j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        merge_top2(a1, a2, __shfl_xor_sync(0xffffffffu, a1, o), __shfl_xor_sync(0xffffffffu, a2, o));
      if (a1 == -INFINITY) {
        full = false;
        break;
      }
      const bool two = left >= 2 && a2 > -INFINITY;
      dk = two ? a2 : a1;
      left -= two ? 2 : 1;
#pragma unroll
      for (int j = 0; j < LPL; ++j) {
        for (int step = 0; step < 2 && h1[j] >= dk; ++step) {
          ++pos[j];
          h1[j] = h2[j];
          h2[j] = pos[j] + 1 < nl[j] ? lev(lane + 32 * j, pos[j] + 1) : -INFINITY;
        }
      }
    }
    const float thr = sa.top_k >= 2 ? fmaxf(dk, NEG_INF) : dk;
    uint4 r[LPL];   // each list's record at its last level at or above thr (header: none), in one trip
    int cnt[LPL];
#pragma unroll
    for (int j = 0; j < LPL; ++j) {
      const int b = lane + 32 * j;
      cnt[j] = pos[j];   // levels at or above dk (thr, unless the -1e30 floor raised it)
      if (!full || thr != dk) {
        cnt[j] = 0;
        while (cnt[j] < nl[j] && lev(b, cnt[j]) >= thr) ++cnt[j];
      }
      if (b < nlists) {
        const unsigned* rec = sa.cand + (size_t)b * CAND_WORDS;
        r[j] = __ldcg(reinterpret_cast<const uint4*>(cnt[j] > 0 ? rec + 4 + SAMPLE_ROWS + 4 * (cnt[j] - 1) : rec));
      }
    }
#pragma unroll
    for (int j = 0; j < LPL; ++j) {
      if (lane + 32 * j < nlists) {
        if (cnt[j] > 0) {
          const float s = __uint_as_float(r[j].x);
          const int i = (int)r[j].y;
          if (ranks_above(s, i, bs, bi)) { bs = s; bi = i; }
          below = min(below, (int)r[j].z);
        } else {
          below = min(below, (int)r[j].w);
        }
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float os = __shfl_xor_sync(0xffffffffu, bs, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (ranks_above(os, oi, bs, bi)) { bs = os; bi = oi; }
    below = min(below, __shfl_xor_sync(0xffffffffu, below, o));
  }
  if (lane == 0) {   // what fell below the threshold is -1e30 in the reference, with the smallest id
    if (below != 0x7FFFFFFF && ranks_above(NEG_INF, below, bs, bi)) bi = below;
    sa.tok_out[0] = bi;
  }
}

// ---------------------------------------------------------------- host side

struct DecodePlan {   // mirrored field by field in ops/decode_step.py
  const void *emb, *invf, *attn_norm, *wqkv, *wqs, *wo, *wos, *mlp_norm, *wgu, *wgus, *wd, *wds,
      *final_norm, *head, *head_s;
  void *k_all, *v_all, *h, *part, *logits, *tok_out, *bar, *stamps, *hx, *actx, *cand, *qkvx;
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

// Input vector, reduction scratch, int4 partial sums and, where the phase
// normalises, the norm weights.
inline size_t gemv_smem(int C, int bits, bool norm) {
  return (size_t)(xlen(C, bits) + 32 + (bits == 4 ? WARPS * 16 : 0) + (norm ? C : 0)) * sizeof(float);
}
inline size_t attn_smem(int hd, int nwarps) { return (size_t)(3 * hd + 4 + nwarps * (hd + 2)) * sizeof(float); }

template <int BITS>
__host__ __device__ __forceinline__ size_t row_bytes(int C) { return (size_t)C * BITS / 8; }

// ---------------------------------------------------------------- the half-layers

// The phases of one step at one weight width: int8 rows a warp, int4 units
// and tiles in flight, both set so that the flagship widths give every
// block at most two units on 132 SMs and its loads in flight before each
// wait; other widths and SM counts loop.
template <int BITS, int KIND, class Sync>
__device__ __forceinline__ void step_gemv(const GemvArgs& a, float* smem, int bid, int nblk, Sync& sync) {
  static_assert(4 * WARPS == SAMPLE_ROWS && 16 * unit_rgs<HEAD>() == SAMPLE_ROWS, "a head unit is one list");
  if constexpr (BITS == 8) {
    if constexpr (KIND == QKV || KIND == HEAD) gemv_phase<4, 2, KIND>(a, smem, bid, nblk, sync);
    else if constexpr (KIND == WO) gemv_phase<1, 2, KIND>(a, smem, bid, nblk, sync);
    else if constexpr (KIND == GATE_UP) gemv_phase<8, 2, KIND>(a, smem, bid, nblk, sync);
    else gemv_phase<1, 8, KIND>(a, smem, bid, nblk, sync);
  } else {
    if constexpr (KIND == QKV || KIND == HEAD) gemv4_phase<KIND, 1, 4>(a, smem, bid, nblk, sync);
    else if constexpr (KIND == WO) gemv4_phase<KIND, 1, 2>(a, smem, bid, nblk, sync);
    else gemv4_phase<KIND, 1, 8>(a, smem, bid, nblk, sync);
  }
}

// Where a half-layer reads the residual h (plain bf16, or tagged words with
// the tag of their write) and where it writes the new one (plain and / or
// tagged).
struct Residual {
  const bf16* in;
  const unsigned* inx;
  unsigned in_tag;
  bf16* out;
  unsigned* outx;
  unsigned out_tag;
};

__device__ __forceinline__ void read_residual(GemvArgs& a, const Residual& r) {
  a.hin = r.in;
  a.hinx = r.inx;
  a.hin_tag = r.in_tag;
}

// Layer l's attention half over all blocks: QKV into the tagged q, k, v
// words (tag), the attention partials, one grid barrier, wo + residual.
template <int BITS>
__device__ __forceinline__ void attn_half(const DecodePlan& p, int l, const Residual& r, unsigned tag, int t,
                                          int off, int nsplit, float* smem, int bid, int nblk, StepSync& sync) {
  const int N = p.H * p.hd, D = p.D;
  GemvArgs a = {};
  a.W = (const int8_t*)p.wqkv + (size_t)l * 3 * N * row_bytes<BITS>(D);
  a.s = (const float*)p.wqs + (size_t)l * 3 * N;
  a.R = 3 * N; a.C = D; a.nw = (const float*)p.attn_norm + (size_t)l * D; a.eps = p.eps;
  read_residual(a, r);
  a.outx = (unsigned long long*)p.qkvx; a.out_tag = tag;
  step_gemv<BITS, QKV>(a, smem, bid, nblk, sync);
  attn_phase((const unsigned long long*)p.qkvx, tag, (const float*)p.invf, (bf16*)p.k_all + (size_t)l * p.S * N,
             (bf16*)p.v_all + (size_t)l * p.S * N, (float*)p.part, p.H, p.hd, t, off, nsplit, p.scale,
             smem, bid, nblk, sync);
  GemvArgs o = {};
  o.W = (const int8_t*)p.wo + (size_t)l * D * row_bytes<BITS>(N);
  o.s = (const float*)p.wos + (size_t)l * D;
  o.R = D; o.C = N; o.part = (const float*)p.part; o.hd = p.hd; o.nsplit = nsplit;
  read_residual(o, r);
  o.hout = r.out; o.houtx = r.outx; o.hout_tag = r.out_tag;
  sync.grid = true;   // every head's partials
  step_gemv<BITS, WO>(o, smem, bid, nblk, sync);
  sync.grid = false;
}

// Layer l's MLP half over all blocks: gate|up into the tagged activation
// words (tag), down + residual.
template <int BITS>
__device__ __forceinline__ void mlp_half(const DecodePlan& p, int l, const Residual& r, unsigned tag,
                                         float* smem, int bid, int nblk, StepSync& sync) {
  const int D = p.D, F = p.F;
  GemvArgs g = {};
  g.W = (const int8_t*)p.wgu + (size_t)l * 2 * F * row_bytes<BITS>(D);
  g.s = (const float*)p.wgus + (size_t)l * 2 * F;
  g.R = 2 * F; g.C = D; g.nw = (const float*)p.mlp_norm + (size_t)l * D; g.eps = p.eps;
  read_residual(g, r);
  g.actx = (unsigned*)p.actx; g.act_tag = tag;
  step_gemv<BITS, GATE_UP>(g, smem, bid, nblk, sync);
  GemvArgs d = {};
  d.W = (const int8_t*)p.wd + (size_t)l * D * row_bytes<BITS>(F);
  d.s = (const float*)p.wds + (size_t)l * D;
  d.R = D; d.C = F;
  d.xinx = (const unsigned*)p.actx; d.xin_tag = tag;
  read_residual(d, r);
  d.hout = r.out; d.houtx = r.outx; d.hout_tag = r.out_tag;
  step_gemv<BITS, DOWN>(d, smem, bid, nblk, sync);
}

// The end of a half-layer call: the last block to take the ticket leaves
// the call's words as the next call needs them (no grid counter or ticket
// left over, the next call's tags). Every block read the call count before
// its work and, where there is one, passed the grid barrier before its
// ticket, so none reads a word this block resets.
__device__ __forceinline__ void half_call_done(unsigned* bar, int calls_word, StepSync& sync) {
  __syncthreads();
  if (threadIdx.x == 0) {
    if (atomicAdd(bar + BAR_HALF_TICKET, 1u) == sync.nblk - 1) {
      bar[BAR_HALF_GRID] = 0u;
      bar[BAR_HALF_TICKET] = 0u;
      atomicAdd(bar + calls_word, 1u);
    }
    sync.stamp(0);   // the call's end, in the slot after the last wait
  }
}

// One half-layer a launch, one block of THREADS an SM, all co-resident, on
// a plan of one layer (L = 1): the residual is the plain bf16 h, read by
// the first phase and updated in place by the last. A block's first read
// of h happens before any block writes it: wo writes after the grid
// barrier, down once the whole activation is in, which every block that
// read h for gate|up wrote after reading it.
template <int BITS>
__global__ void __launch_bounds__(THREADS) attn_half_kernel(DecodePlan p, int t, int off) {
  extern __shared__ __align__(16) float smem[];
  unsigned* bar = (unsigned*)p.bar;
  StepSync sync{bar + BAR_HALF_GRID, 0u, gridDim.x, (unsigned long long*)p.stamps, 0, false, false};
  const unsigned tag = half_tag(__ldcg(bar + BAR_ATTN_CALLS));
  const Residual r{(const bf16*)p.h, nullptr, 0u, (bf16*)p.h, nullptr, 0u};
  attn_half<BITS>(p, 0, r, tag, t, off, attn_splits(t - off, gridDim.x / p.H), smem, blockIdx.x, gridDim.x, sync);
  half_call_done(bar, BAR_ATTN_CALLS, sync);
}

template <int BITS>
__global__ void __launch_bounds__(THREADS) mlp_half_kernel(DecodePlan p) {
  extern __shared__ __align__(16) float smem[];
  unsigned* bar = (unsigned*)p.bar;
  StepSync sync{bar + BAR_HALF_GRID, 0u, gridDim.x, (unsigned long long*)p.stamps, 0, false, false};
  const unsigned tag = half_tag(__ldcg(bar + BAR_MLP_CALLS));
  const Residual r{(const bf16*)p.h, nullptr, 0u, (bf16*)p.h, nullptr, 0u};
  mlp_half<BITS>(p, 0, r, tag, smem, blockIdx.x, gridDim.x, sync);
  half_call_done(bar, BAR_MLP_CALLS, sync);
}

// ---------------------------------------------------------------- the step

// The sampler's lists: one a head unit (int8: 32 rows; int4: two
// row-groups, and the tail of V % 16 rows).
template <int BITS>
__host__ __device__ __forceinline__ int head_lists(int V) {
  return BITS == 8 ? (V + SAMPLE_ROWS - 1) / SAMPLE_ROWS : units4<HEAD>(V);
}

// One block of THREADS an SM (what its registers allow), all co-resident.
// Dynamic shared memory: what the phases use, then from float `slot_base`
// the logits of the block's head units and their ids (SAMPLE_ROWS each).
template <int BITS>
__global__ void __launch_bounds__(THREADS)
mega_persistent_kernel(DecodePlan p, const int* tok_in, int t, int off, int suppress, int seed, int slot_base) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int is_last;
  unsigned* bar = (unsigned*)p.bar;
  StepSync sync{bar + BAR_GRID, 0u, gridDim.x, (unsigned long long*)p.stamps, 0, false, false};
  const int bid = blockIdx.x, nblk = gridDim.x;
  const int D = p.D, L = p.L;
  const int nsplit = attn_splits(t - off, nblk / p.H);   // one (head, split) unit a block at most
  const unsigned epoch = __ldcg(bar + BAR_EPOCH);        // steps this scratch has run: the tags' base
  const unsigned* hx = (const unsigned*)p.hx;
  const bf16* emb_row = (const bf16*)p.emb + (size_t)__ldcg(tok_in) * D;
  unsigned* hxo = (unsigned*)p.hx;
  for (int l = 0; l < L; ++l) {
    // the residual between the halves as tagged words, each write with the
    // tag of its count; layer 0 reads the token's embedding row
    const unsigned h_in = write_tag(epoch * 2u * L + 2u * l - 1u);   // DOWN of layer l - 1
    const unsigned h_mid = write_tag(epoch * 2u * L + 2u * l);       // WO of layer l
    const unsigned h_out = write_tag(epoch * 2u * L + 2u * l + 1u);  // DOWN of layer l
    const unsigned qkv_tag = write_tag(epoch * (unsigned)L + l);      // q, k, v and act of layer l
    const Residual ra{l == 0 ? emb_row : nullptr, l == 0 ? nullptr : hx, h_in, nullptr, hxo, h_mid};
    attn_half<BITS>(p, l, ra, qkv_tag, t, off, nsplit, smem, bid, nblk, sync);
    const Residual rm{nullptr, hx, h_mid, l == L - 1 ? (bf16*)p.h : nullptr, hxo, h_out};   // the last, also for the caller
    mlp_half<BITS>(p, l, rm, qkv_tag, smem, bid, nblk, sync);
  }
  // the block's head units' logits, past every phase's shared memory (the
  // head's barriers order these stores before its own)
  const int nlists = head_lists<BITS>(p.V);
  const int my_lists = bid < nlists ? (nlists - bid + nblk - 1) / nblk : 0;   // units bid, bid + nblk, ...
  float* slot_val = smem + slot_base;
  int* slot_id = reinterpret_cast<int*>(slot_val + SAMPLE_ROWS * my_lists);
  for (int i = threadIdx.x; i < SAMPLE_ROWS * my_lists; i += THREADS) slot_id[i] = -1;
  GemvArgs a = {};   // the head: the QKV phase's arithmetic, the block's logits kept for the sampler
  a.W = (const int8_t*)p.head; a.s = (const float*)p.head_s; a.R = p.V; a.C = D;
  a.hinx = hx; a.hin_tag = write_tag(epoch * 2u * L + 2u * L - 1u);
  a.nw = (const float*)p.final_norm; a.eps = p.eps; a.out = (float*)p.logits;
  a.slot_val = slot_val; a.slot_id = slot_id;
  step_gemv<BITS, HEAD>(a, smem, bid, nblk, sync);

  SampleArgs sa{p.V, p.pad_id, p.bos_id, p.eos_id, suppress, p.greedy, p.top_k, p.temperature,
                (uint32_t)seed, (unsigned*)p.cand, (int*)p.tok_out};
  __syncthreads();   // the block's logits are in slot_val
  for (int j = threadIdx.x >> 5; j < my_lists; j += WARPS)
    sample_local(sa, slot_val + SAMPLE_ROWS * j, slot_id + SAMPLE_ROWS * j, bid + j * nblk);
  __syncthreads();
  if (threadIdx.x == 0) {   // the ticket: the last block to take it merges
    sync.stamp(0);
    __threadfence();
    is_last = atomicAdd(bar + BAR_TICKET, 1u) == (unsigned)nblk - 1;
    if (is_last) __threadfence();
    sync.stamp(1);
  }
  __syncthreads();
  if (is_last) {
    if (nlists <= 160) sample_merge<5>(sa, nlists, smem);
    else sample_merge<MAX_LISTS / 32>(sa, nlists, smem);
    if (threadIdx.x == 0) bar[BAR_EPOCH] = epoch + 1;   // the next step's tags
  }
  ++sync.idx;
  if (threadIdx.x == 0) sync.stamp(0);   // the step's end, in the slot after the last wait
}

// ---------------------------------------------------------------- launches

// A persistent kernel's grid: one block an SM, all co-resident. Allows the
// kernel `smem` bytes of dynamic shared memory where that is above the
// default 48 KB (`allowed`: what it was allowed so far) and checks that a
// block fits an SM.
template <class... P>
cudaError_t fit_one_block_an_sm(void (*kernel)(P...), size_t smem, size_t& allowed) {
  if (smem > 48 * 1024 && smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    allowed = smem;
  }
  int occ = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, THREADS, smem);
  if (e != cudaSuccess) return e;
  return occ < 1 ? cudaErrorLaunchOutOfResources : cudaSuccess;
}

// Dynamic shared memory of each half-layer kernel: the largest of its phases'.
template <int BITS>
size_t attn_half_smem(const DecodePlan& p) {
  return std::max({gemv_smem(p.D, BITS, true), gemv_smem(p.H * p.hd, BITS, false), attn_smem(p.hd, WARPS)});
}
template <int BITS>
size_t mlp_half_smem(const DecodePlan& p) {
  return std::max(gemv_smem(p.D, BITS, true), gemv_smem(p.F, BITS, false));
}

template <int BITS>
cudaError_t fit_half_layers(const DecodePlan& p) {
  static size_t attn_allowed = 0, mlp_allowed = 0;
  const cudaError_t e = fit_one_block_an_sm(attn_half_kernel<BITS>, attn_half_smem<BITS>(p), attn_allowed);
  if (e != cudaSuccess) return e;
  return fit_one_block_an_sm(mlp_half_kernel<BITS>, mlp_half_smem<BITS>(p), mlp_allowed);
}

// A launch the kernel was not fitted to (fit_half_layers) fails and returns its error.
template <int BITS>
cudaError_t launch_attn_half(const DecodePlan& p, int t, int off, cudaStream_t st) {
  DecodePlan pv = p;
  void* args[] = {&pv, &t, &off};
  return cudaLaunchCooperativeKernel((void*)attn_half_kernel<BITS>, dim3(sm_count()), dim3(THREADS), args,
                                     attn_half_smem<BITS>(p), st);
}

template <int BITS>
cudaError_t launch_mlp_half(const DecodePlan& p, cudaStream_t st) {
  DecodePlan pv = p;
  void* args[] = {&pv};
  return cudaLaunchCooperativeKernel((void*)mlp_half_kernel<BITS>, dim3(sm_count()), dim3(THREADS), args,
                                     mlp_half_smem<BITS>(p), st);
}

template <int BITS>
int mega_persistent(const DecodePlan& p, const int* tok_in, int t, int off, int suppress, int seed,
                    cudaStream_t st) {
  const int nblk = sm_count(), nlists = head_lists<BITS>(p.V);
  if (nlists > MAX_LISTS) return (int)cudaErrorInvalidValue;
  size_t smem = gemv_smem(p.D, BITS, true);
  const size_t wide = gemv_smem(max(p.H * p.hd, p.F), BITS, false);
  if (wide > smem) smem = wide;
  if (attn_smem(p.hd, WARPS) > smem) smem = attn_smem(p.hd, WARPS);
  const size_t merge = (size_t)nlists * (4 + SAMPLE_ROWS) * sizeof(float);
  if (merge > smem) smem = merge;
  int slot_base = (int)(smem / sizeof(float));   // then the head's logits and ids, past every phase's
  smem += 2 * SAMPLE_ROWS * sizeof(float) * ((nlists + nblk - 1) / nblk);
  static size_t allowed = 0;
  cudaError_t e = fit_one_block_an_sm(mega_persistent_kernel<BITS>, smem, allowed);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemsetAsync((unsigned*)p.bar + BAR_GRID, 0, (BAR_TICKET + 1 - BAR_GRID) * sizeof(unsigned), st);
  if (e != cudaSuccess) return (int)e;
  DecodePlan pv = p;
  void* args[] = {&pv, &tok_in, &t, &off, &suppress, &seed, &slot_base};
  e = cudaLaunchCooperativeKernel((void*)mega_persistent_kernel<BITS>, dim3(nblk),
                                  dim3(THREADS), args, smem, st);
  return (int)e;
}

}  // namespace

// All entry points: `bits` is 8 (int8 weights, one value a byte) or 4 (two
// offset-binary values a byte, rows in complete groups of 16 in mma
// fragment order and the rest in plain byte order: ops/decode_step.py
// pack4); weights are output-major rows; every pointer is device memory on
// `stream`'s device; the return value is the first CUDA error (or
// cudaErrorInvalidValue for another `bits`).

// Attention partials per head that `part` buffers must hold, the floats of
// one partial beyond its hd channels, the words of a scratch's `bar` buffer,
// the words of one sampler list, and the lists of a step's sampler at
// vocabulary V and `bits`.
extern "C" int decode_max_splits() { return MAX_SPLITS; }
extern "C" int decode_part_pad() { return PART_PAD; }
extern "C" int decode_bar_words() { return BAR_WORDS; }
extern "C" int decode_cand_words() { return CAND_WORDS; }
extern "C" int decode_sample_lists(int V, int bits) { return bits == 4 ? head_lists<4>(V) : head_lists<8>(V); }

// The half-layers run on a plan of one layer (L = 1): attn_norm [D], wqkv
// [3N, D], wqs [3N], wo [D, N], wos [D], mlp_norm [D], wgu [2F, D] (gate
// rows then up rows), wgus [2F], wd [D, F], wds [D]; invf f32 [hd/2];
// k_all / v_all the layer's caches bf16 [S, N] (row t written in place);
// h bf16 [D], the residual, updated in place. Scratch: part f32 [H,
// MAX_SPLITS, hd + PART_PAD], bar uint32 [BAR_WORDS], qkvx uint64 [3N],
// actx uint32 [F] (bar, qkvx and actx zeroed once, when the scratch is
// made; a decode step's scratch serves, before, after or between steps);
// stamps null or int64 [4, SMs, 2] (each block's arrival at and leave from
// each of the call's waits, then its end, in ns). The other fields are not
// read. `half_layers_fit` once a plan, before its first call: it allows the
// kernels their shared memory and checks that one block an SM fits.
extern "C" int half_layers_fit(const void* plan) {
  const DecodePlan& p = *(const DecodePlan*)plan;
  if (p.bits == 8) return (int)fit_half_layers<8>(p);
  if (p.bits == 4) return (int)fit_half_layers<4>(p);
  return (int)cudaErrorInvalidValue;
}

// One attention half-layer: h <- h + wo . attn(rmsnorm(h)), cache row t.
extern "C" int attn_half_step(const void* plan, int t, int off, void* stream) {
  const DecodePlan& p = *(const DecodePlan*)plan;
  if (p.bits == 8) return (int)launch_attn_half<8>(p, t, off, (cudaStream_t)stream);
  if (p.bits == 4) return (int)launch_attn_half<4>(p, t, off, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

// One MLP half-layer: h <- h + down . (silu(g) * u).
extern "C" int mlp_half_step(const void* plan, void* stream) {
  const DecodePlan& p = *(const DecodePlan*)plan;
  if (p.bits == 8) return (int)launch_mlp_half<8>(p, (cudaStream_t)stream);
  if (p.bits == 4) return (int)launch_mlp_half<4>(p, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

// One decode step over a plan (the checked pointers and constants of one
// engine, cache and scratch). Weights stacked over layers: wqkv [L,3N,D],
// wo [L,D,N], wgu [L,2F,D] (gate rows then up rows), wd [L,D,F], head
// [V,D]; scales f32 [L,3N], [L,D], [L,2F], [L,D], [V]; norms f32 [L,D] /
// [D]; emb bf16 [V,D]; invf f32 [hd/2]. Caches k_all/v_all bf16 [L,S,N] are
// updated in place at row t. Scratch: h bf16 [D] (the last layer's
// residual on return), part f32 [H, MAX_SPLITS, hd + PART_PAD], logits f32
// [V], tok_out int32 [1], bar uint32 [BAR_WORDS], hx uint32 [D], actx
// uint32 [F], qkvx uint64 [3N] (bar, hx, actx and qkvx zeroed once, when
// the scratch is made), cand uint32 [decode_sample_lists(V, bits), CAND_WORDS]; stamps is null or
// int64 [5 L + 3, SMs, 2] (when each block arrived at and left each wait,
// in ns). tok_in is int32 [1] on the device (it may be tok_out). V <= 8192
// (the sampler's lists at most MAX_LISTS).
extern "C" int mega_decode_step(const void* plan, const void* tok_in, int t, int off,
                                int suppress, int seed, void* stream) {
  const DecodePlan& p = *(const DecodePlan*)plan;
  cudaStream_t st = (cudaStream_t)stream;
  if (p.bits == 8) return mega_persistent<8>(p, (const int*)tok_in, t, off, suppress, seed, st);
  if (p.bits == 4) return mega_persistent<4>(p, (const int*)tok_in, t, off, suppress, seed, st);
  return (int)cudaErrorInvalidValue;
}
