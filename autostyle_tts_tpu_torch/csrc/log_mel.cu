// Fused log-mel spectrogram (sm_90a): framed signal -> windowed real DFT ->
// power -> mel filterbank -> log, in one kernel.
//
// Replaces: autostyle_tts_tpu/ops/pallas_mel.py::fused_log_mel (_mel_kernel):
//   out = log(max(((frames . cos)^2 + (frames . sin)^2) . fb, eps))
// with frames [B, T, win] (any batch and frame stride: the overlapping view
// of the padded signal is read in place), cos/sin [win, n_bins] (the
// analysis window folded in), fb [n_bins, n_mels], f32 in and out. The
// [T, n_bins] power spectrogram never reaches device memory.
//
// What bounds it on the H100: operations, then latency. The DFT is one
// product [B*T, win] x [win, 2*n_bins]: at the prompt shapes (402 x 1024 x
// 1026 and 802 x 400 x 402) 0.85 and 0.26 GFLOP against 1 to 5 MB of
// operands that all stay in L2. The TPU kernel keeps both whole bases in
// fast memory per program; here they are 2 x 2.1 MB and fit no SM, so the
// product is tiled, and at 400 to 800 rows the whole call is one wave of
// about a hundred blocks: its time is one block's chain of stages.
//
// Design.
// - Tensor cores at f32 accuracy: mma.sync.m16n8k8 TF32 with both operands
//   split in the kernel into hi = tf32(x) and lo = x - hi cut to TF32, and
//   three products (lo.hi + hi.lo + hi.hi; lo.lo is below f32's last bit).
//   Each stage is summed in fresh accumulators and added to the running sum
//   in f32 on the CUDA cores, so the tensor cores' truncating adds never act
//   on a long sum. One TF32 pass alone keeps three decimal digits, which a
//   weak bin beside a strong tone does not survive. The three passes run
//   over all of a warp's accumulators in turn, so no mma waits for the one
//   before it; the split is integer arithmetic (cvt.rna.tf32 runs at a
//   quarter of that rate).
// - Tiling with reuse: a block owns 32 rows of the flattened [B*T] frames
//   and one chunk of 64 bins, cos and sin of a bin side by side (the power
//   needs both in one thread), and walks the window in stages of 128
//   samples, so any window length runs. 16 warps: four across the bins (32
//   rows x 16 bins each: per 8 samples 8 + 8 operand words feed 24 mma) times
//   four that share a stage's steps of 8 samples; their sums meet in shared
//   memory after the loop, in a fixed order. Long stages matter: a warp that
//   has several steps between two block barriers overlaps one step's reads
//   and splits with another's mma.
// - The packed basis (built once per pair of bases on the host,
//   ops/log_mel.py): [bin chunk][stage][window pair][(cos 64 | sin 64) x 2 +
//   pad], zero-padded to whole chunks and stages, so the ragged last chunk
//   (513 = 8*64 + 1) needs no masks (its warps without a bin skip the
//   products) and a stage's basis tile is one contiguous piece that lies in
//   global memory as it lies in shared memory: one bulk asynchronous copy
//   (TMA) per stage, reported to a transaction barrier. Thousands of 16-byte
//   cp.async a stage kept too few bytes in flight; a bulk copy per row was
//   slower still. Two consecutive window samples sit side by side, and a
//   lane takes them as one 8-byte read for the two k-slots of a fragment
//   (the order of a sum over the window is free as long as both operands
//   agree). Row strides are chosen so that no fragment read collides on banks.
// - Frames by stride: a thread loads its 2 x 16 bytes of the next stage's
//   frame tile into registers before it computes and stores them to shared
//   memory after (zero past B*T and past the window); 4-byte loads when the
//   base or a stride is not a multiple of 16 bytes (another instantiation).
// - Mel product and the sum across bin chunks: the block's powers go to
//   shared memory and through the same split product against its 64 rows
//   of fb (fetched under the main loop) into a partial [32, n_mels] in a
//   scratch; the block that arrives last at the row tile's ticket sums the
//   partials in chunk order, applies log(max(., eps)) and resets the ticket.
//   No float atomics: two calls give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 32;            // rows (frames) per block
constexpr int BN = 64;            // bins per block; 2 * BN basis columns
constexpr int BK = 128;           // window samples per stage
constexpr int STAGES = 2;
constexpr int BW = 4;             // warps across the bins: each 32 rows x 16 bins
constexpr int KG = 4;             // warp groups across the window: group q takes every KG-th step of 8 samples
constexpr int THREADS = 32 * BW * KG;
constexpr int SA = BK + 8;        // floats per row of the frame tile (stride = 8 mod 32)
constexpr int SB = 4 * BN + 8;    // floats per window pair of the basis tile (stride = 8 mod 32)
constexpr int SP = BN + 4;        // floats per row of the power tile (stride = 4 mod 32)
constexpr int A_STAGE = BM * SA;
constexpr int B_STAGE = (BK / 2) * SB;
constexpr int STAGE_FLOATS = A_STAGE + B_STAGE;
constexpr int SUMS = 32;          // accumulator words a thread holds: 2 row halves x 4 column groups x 4
constexpr int RED_FLOATS = (KG - 1) * SUMS * 32 * BW;     // the other groups' sums, handed to group 0
static_assert(RED_FLOATS + BM * SP <= STAGES * STAGE_FLOATS, "the epilogue reuses the ring");
static_assert((BK / 8) % KG == 0 && (BM * BK / 4) % THREADS == 0 && BK % (4 * THREADS / BM) == 0, "tile");

__host__ __device__ inline int fb_stride(int n_mels) {   // >= n_mels rounded to 8, = 8 mod 16
  const int n8 = (n_mels + 7) / 8 * 8;
  return n8 + ((n8 % 16 == 8) ? 0 : 8);
}

// bulk asynchronous copies (a contiguous piece of any size at once) that
// report to a transaction barrier in shared memory
__device__ __forceinline__ unsigned smem_addr(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }
__device__ __forceinline__ void mbar_init(uint64_t* bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(smem_addr(bar)), "r"(arrivals));
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {   // one arrival that announces `bytes`
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  unsigned done;
  do {
    asm volatile("{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; selp.u32 %0, 1, 0, p; }"
                 : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void fence_async_proxy() { asm volatile("fence.proxy.async.shared::cta;" ::: "memory"); }

// x = hi + lo up to 2^-21 |x|, both TF32 values: hi is x rounded to the
// nearest (ties away from zero), lo the exact rest cut to TF32's 10 mantissa
// bits.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[i][j] += a[i] . b[j] at f32 accuracy for I row halves and N column
// groups: lo.hi, hi.lo, then hi.hi, each pass over every accumulator before
// the next, so that no mma waits for the one before it
template <int I, int N>
__device__ __forceinline__ void mma_split(float (*c)[N][4], const uint32_t (*a_hi)[4],
                                          const uint32_t (*a_lo)[4], const uint32_t (*b_hi)[2],
                                          const uint32_t (*b_lo)[2]) {
#pragma unroll
  for (int pass = 0; pass < 3; ++pass)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const uint32_t* b = pass == 1 ? b_lo[j] : b_hi[j];
#pragma unroll
      for (int i = 0; i < I; ++i) mma_tf32(c[i][j], pass == 0 ? a_lo[i] : a_hi[i], b[0], b[1]);
    }
}

// VEC: every row of frames starts on a 16-byte address (16-byte loads; else 4-byte)
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
log_mel_kernel(const float* __restrict__ frames, long long batch_stride, long long frame_stride,
               const float* __restrict__ packed, const float* __restrict__ fb,
               float* __restrict__ partial, unsigned* __restrict__ tickets,
               float* __restrict__ out, int M, int T, int win, int n_bins, int n_mels,
               int n_chunks, int fb_vec, float eps) {
  extern __shared__ __align__(16) float smem[];
  __shared__ unsigned ticket_s;
  __shared__ __align__(8) uint64_t full[STAGES], fb_full;
  const int SF = fb_stride(n_mels);
  float* fb_s = smem;                          // [BN][SF], this chunk's rows of fb
  float* ring = smem + BN * SF;                // STAGES x (frame tile [BM][SA], basis tile [BK/2][SB])
  float* red_s = ring;                         // after the main loop: [KG - 1][SUMS][32 * BW]
  float* pw_s = ring + RED_FLOATS;             // ... and the powers [BM][SP]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bw = warp % BW, kg = warp / BW;    // this warp's 16 bins and its share of the window
  const int g = lane >> 2, t4 = lane & 3;
  const int chunk = blockIdx.x % n_chunks, tile = blockIdx.x / n_chunks;
  const int row0 = tile * BM, bin0 = chunk * BN;
  const int KT = (win + BK - 1) / BK;
  const int rows = min(BM, M - row0), bins = min(BN, n_bins - bin0);
  const float* basis = packed + (size_t)chunk * KT * B_STAGE;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mbar_init(full + s, 1);
    mbar_init(&fb_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // rows of fb past n_bins meet zero powers, but 0 x garbage is not 0
  if (bins < BN)
    for (int i = tid; i < (BN - bins) * SF; i += THREADS) fb_s[bins * SF + i] = 0.f;
  fence_async_proxy();
  __syncthreads();

  // this chunk's rows of fb (columns past n_mels only feed output columns that are never written)
  if (fb_vec) {           // rows of fb start on 16-byte addresses: one bulk copy a row
    if (warp == 1) {
      if (lane == 0) mbar_expect(&fb_full, bins * n_mels * 4);
      __syncwarp();
      for (int j = lane; j < bins; j += 32)
        bulk_copy(fb_s + j * SF, fb + (size_t)(bin0 + j) * n_mels, n_mels * 4, &fb_full);
    }
  } else {                // plain loads: the block barriers of the main loop publish them
    for (int i = tid; i < bins * n_mels; i += THREADS) {
      const int j = i / n_mels, m = i - j * n_mels;
      fb_s[j * SF + m] = __ldg(fb + (size_t)(bin0 + j) * n_mels + m);
    }
  }

  // the frame tile goes through registers: a thread loads its piece of a
  // later stage (16 bytes with VEC, else 4 x 4) before it computes and stores
  // it to the ring after, zero past M and past the window
  constexpr int A_PER = BM * BK / 4 / THREADS, A_HOP = 4 * THREADS / BM;   // pieces a thread, samples between them
  const int a_r = tid / (A_HOP / 4), a_k = (tid % (A_HOP / 4)) * 4;        // row and first sample of the first piece
  const float* a_src = nullptr;
  if (row0 + a_r < M) {
    const int row = row0 + a_r, b = row / T;
    a_src = frames + b * batch_stride + (row - b * T) * frame_stride + a_k;
  }
  float a_reg[A_PER][4];
  auto fetch_frames = [&](int kt) {
#pragma unroll
    for (int h = 0; h < A_PER; ++h) {
      const int k = kt * BK + h * A_HOP;
      const int left = a_src != nullptr ? win - (k + a_k) : 0;     // samples of the piece inside the window
      if (VEC && left >= 4) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(a_src + k));
        a_reg[h][0] = v.x, a_reg[h][1] = v.y, a_reg[h][2] = v.z, a_reg[h][3] = v.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) a_reg[h][e] = e < left ? __ldg(a_src + k + e) : 0.f;
      }
    }
  };
  auto store_frames = [&](int slot) {
#pragma unroll
    for (int h = 0; h < A_PER; ++h)
      *reinterpret_cast<float4*>(ring + slot * STAGE_FLOATS + a_r * SA + a_k + h * A_HOP) =
          make_float4(a_reg[h][0], a_reg[h][1], a_reg[h][2], a_reg[h][3]);
  };
  // the basis tile of a stage is one piece of the packed basis, padding included: one bulk copy
  auto fetch_basis = [&](int kt, int slot) {
    if (tid == 0) {
      mbar_expect(full + slot, B_STAGE * 4);
      bulk_copy(ring + slot * STAGE_FLOATS + A_STAGE, basis + (size_t)kt * B_STAGE, B_STAGE * 4, full + slot);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s)
    if (s < KT) {
      fetch_basis(s, s);
      fetch_frames(s);
      store_frames(s);
    }

  // column groups of this warp: cos of its bins 0-7 and 8-15, then sin of the same
  const bool has_bins = bin0 + bw * 16 < n_bins;     // else the packed basis holds zeros here
  float acc[2][4][4];     // [row half][column group][fragment]
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int kt = 0; kt < KT; ++kt) {
    mbar_wait(full + kt % STAGES, (kt / STAGES) & 1);
    __syncthreads();        // the tile of stage kt is whole; every warp is done with that of stage kt - 1
    const int ahead = kt + STAGES - 1;
    if (ahead < KT) {
      fetch_basis(ahead, ahead % STAGES);
      fetch_frames(ahead);
    }
    if (!has_bins) {
      if (ahead < KT) store_frames(ahead % STAGES);
      continue;
    }
    const float* a_s = ring + (kt % STAGES) * STAGE_FLOATS;
    const float* b_s = a_s + A_STAGE;
    float part[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
    for (int ks = kg; ks < BK / 8; ks += KG) {
      if (kt * BK + ks * 8 >= win) break;      // the window's zero padding
      // k-slots t4 and t4 + 4 of this step are window samples 8 ks + 2 t4 and + 1
      uint32_t a_hi[2][4], a_lo[2][4], b_hi[4][2], b_lo[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float2 top = *reinterpret_cast<const float2*>(a_s + (i * 16 + g) * SA + ks * 8 + 2 * t4);
        const float2 bot = *reinterpret_cast<const float2*>(a_s + (i * 16 + g + 8) * SA + ks * 8 + 2 * t4);
        split_tf32(top.x, a_hi[i][0], a_lo[i][0]);
        split_tf32(bot.x, a_hi[i][1], a_lo[i][1]);
        split_tf32(top.y, a_hi[i][2], a_lo[i][2]);
        split_tf32(bot.y, a_hi[i][3], a_lo[i][3]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = (j >> 1) * BN + bw * 16 + (j & 1) * 8 + g;    // cos | sin halves
        const float2 bv = *reinterpret_cast<const float2*>(b_s + (ks * 4 + t4) * SB + col * 2);
        split_tf32(bv.x, b_hi[j][0], b_lo[j][0]);
        split_tf32(bv.y, b_hi[j][1], b_lo[j][1]);
      }
      mma_split<2, 4>(part, a_hi, a_lo, b_hi, b_lo);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
    if (ahead < KT) store_frames(ahead % STAGES);
  }
  if (fb_vec) mbar_wait(&fb_full, 0);
  __syncthreads();          // every warp is done with the ring; fb_s has landed

  // the window groups' sums into group 0, in group order
  if (kg > 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          red_s[((kg - 1) * SUMS + (i * 4 + j) * 4 + e) * (32 * BW) + bw * 32 + lane] = acc[i][j][e];
  }
  __syncthreads();
  if (kg == 0) {
#pragma unroll
    for (int q = 0; q < KG - 1; ++q)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][j][e] += red_s[(q * SUMS + (i * 4 + j) * 4 + e) * (32 * BW) + bw * 32 + lane];
    // powers of this block's [32 rows][64 bins] (0 where there is no bin)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const float* re = acc[i][jj];
        const float* im = acc[i][2 + jj];
        const int col = bw * 16 + jj * 8 + 2 * t4;
        *reinterpret_cast<float2*>(pw_s + (i * 16 + g) * SP + col) =
            make_float2(re[0] * re[0] + im[0] * im[0], re[1] * re[1] + im[1] * im[1]);
        *reinterpret_cast<float2*>(pw_s + (i * 16 + g + 8) * SP + col) =
            make_float2(re[2] * re[2] + im[2] * im[2], re[3] * re[3] + im[3] * im[3]);
      }
  }
  __syncthreads();

  // partial[32, n_mels] = powers . fb rows of this chunk: a warp takes 8
  // mels, both row halves, even and odd steps of 8 bins in sums of their own
  // (four independent accumulators a pass)
  const int M_pad = gridDim.x / n_chunks * BM;
  float* my_partial = partial + ((size_t)chunk * M_pad + row0) * n_mels;
  const int k_steps = min(BN, n_bins - bin0 + 7) / 8;     // steps of 8 bins that hold a bin
  for (int nt = warp; nt * 8 < n_mels; nt += THREADS / 32) {
    float c[2][2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[h][i][e] = 0.f;
    for (int ks = 0; ks < k_steps; ks += 2) {
      uint32_t a_hi[2][2][4], a_lo[2][2][4], b_hi[2][2], b_lo[2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {      // a step past k_steps counts as zero powers
        const bool real = ks + h < k_steps;
        const float* f = fb_s + ((ks + h) * 8 + t4) * SF + nt * 8 + g;
        split_tf32(real ? f[0] : 0.f, b_hi[h][0], b_lo[h][0]);
        split_tf32(real ? f[4 * SF] : 0.f, b_hi[h][1], b_lo[h][1]);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float* p = pw_s + (i * 16 + g) * SP + (ks + h) * 8 + t4;
          split_tf32(real ? p[0] : 0.f, a_hi[h][i][0], a_lo[h][i][0]);
          split_tf32(real ? p[8 * SP] : 0.f, a_hi[h][i][1], a_lo[h][i][1]);
          split_tf32(real ? p[4] : 0.f, a_hi[h][i][2], a_lo[h][i][2]);
          split_tf32(real ? p[8 * SP + 4] : 0.f, a_hi[h][i][3], a_lo[h][i][3]);
        }
      }
#pragma unroll
      for (int pass = 0; pass < 3; ++pass)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            mma_tf32(c[h][i], pass == 0 ? a_lo[h][i] : a_hi[h][i], pass == 1 ? b_lo[h][0] : b_hi[h][0],
                     pass == 1 ? b_lo[h][1] : b_hi[h][1]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = i * 16 + g + (e >> 1) * 8, m = nt * 8 + 2 * t4 + (e & 1);
        if (m < n_mels) my_partial[(size_t)r * n_mels + m] = c[0][i][e] + c[1][i][e];
      }
  }

  // the last block to arrive at this row tile sums the partials in chunk order
  __threadfence();
  __syncthreads();
  if (tid == 0) ticket_s = atomicAdd(tickets + tile, 1u);
  __syncthreads();
  if (ticket_s != (unsigned)(n_chunks - 1)) return;
  __threadfence();
  if (tid == 0) tickets[tile] = 0;      // ready for the next launch on this stream
  const size_t chunk_stride = (size_t)M_pad * n_mels;
  if (fb_vec) {     // n_mels is a multiple of 4: four outputs a thread, a chunk's four in one load
    const float4* part4 = reinterpret_cast<const float4*>(partial + (size_t)row0 * n_mels);
    float4* out4 = reinterpret_cast<float4*>(out + (size_t)row0 * n_mels);
    for (int i = tid; i < rows * n_mels / 4; i += THREADS) {
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int c0 = 0; c0 < n_chunks; c0 += 8) {     // eight loads in flight, added in chunk order
        float4 v[8];
#pragma unroll
        for (int q = 0; q < 8; ++q)
          v[q] = c0 + q < n_chunks ? __ldcg(part4 + (c0 + q) * (chunk_stride / 4) + i) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int q = 0; q < 8; ++q) { sum.x += v[q].x; sum.y += v[q].y; sum.z += v[q].z; sum.w += v[q].w; }
      }
      out4[i] = make_float4(logf(fmaxf(sum.x, eps)), logf(fmaxf(sum.y, eps)), logf(fmaxf(sum.z, eps)),
                            logf(fmaxf(sum.w, eps)));
    }
  } else {
    for (int i = tid; i < rows * n_mels; i += THREADS) {
      const size_t at = (size_t)row0 * n_mels + i;
      float sum = 0.f;
      for (int c = 0; c < n_chunks; ++c) sum += __ldcg(partial + c * chunk_stride + at);
      out[at] = logf(fmaxf(sum, eps));
    }
  }
}

size_t smem_bytes(int n_mels) {
  return (size_t)(BN * fb_stride(n_mels) + STAGES * STAGE_FLOATS) * sizeof(float);
}

}  // namespace

// BM | BN << 8 | BK << 16 | pad << 24: the tile (and the padding of a window
// pair's row) the packed basis and the scratch are laid out for
extern "C" int fused_log_mel_layout() { return BM | (BN << 8) | (BK << 16) | ((SB - 4 * BN) << 24); }

// What stays the same from one call to the next for one geometry: element
// (b, t, w) of the frames is at frames[b * batch_stride + t * frame_stride + w];
// packed: [ceil(n_bins / BN)][ceil(win / BK) * BK / 2][2 * BN * 2 + pad], zero-padded
// (cos of the chunk's bins, then sin; two consecutive window samples of a
// column side by side); fb [n_bins, n_mels].
struct LogMelPlan {
  long long batch_stride, frame_stride;
  const void* packed;
  const void* fb;
  int B, T, win, n_bins, n_mels;
  float eps;
};

// partial: scratch of ceil(n_bins / BN) x ceil(B * T / BM) * BM x n_mels floats;
// tickets: one zeroed unsigned per row tile, left zeroed; out [B, T, n_mels].
// All f32 on the device of `stream`. Returns the first CUDA error
// (cudaErrorInvalidValue for a shape it cannot run).
extern "C" int fused_log_mel(const LogMelPlan* plan, const void* frames, void* partial, void* tickets,
                             void* out, void* stream) {
  const LogMelPlan& p = *plan;
  const long long M = (long long)p.B * p.T;
  const int n_chunks = (p.n_bins + BN - 1) / BN;
  const long long tiles = (M + BM - 1) / BM;
  const size_t smem = smem_bytes(p.n_mels);
  if (M < 1 || p.win < 1 || p.n_bins < 1 || p.n_mels < 1 || tiles * n_chunks > 0x7fffffffLL ||
      smem > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  const bool vec = ((uintptr_t)frames % 16 == 0) && (p.batch_stride % 4 == 0) && (p.frame_stride % 4 == 0);
  auto kernel = vec ? log_mel_kernel<true> : log_mel_kernel<false>;
  const int fb_vec = ((uintptr_t)p.fb % 16 == 0) && (p.n_mels % 4 == 0);
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)(tiles * n_chunks), THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)frames, p.batch_stride, p.frame_stride, (const float*)p.packed, (const float*)p.fb,
      (float*)partial, (unsigned*)tickets, (float*)out, (int)M, p.T, p.win, p.n_bins, p.n_mels, n_chunks,
      fb_vec, p.eps);
  return (int)cudaGetLastError();
}
