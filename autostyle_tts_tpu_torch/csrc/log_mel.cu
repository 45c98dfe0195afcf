// Fused log-mel spectrogram (sm_90a): framed signal -> windowed real DFT ->
// power -> mel filterbank -> log, in one kernel.
//
// Replaces: autostyle_tts_tpu/ops/pallas_mel.py::fused_log_mel (_mel_kernel):
//   out = log(max(((frames . cos)^2 + (frames . sin)^2) . fb, eps))
// with frames [B, T, win], cos/sin [win, n_bins] (the analysis window is
// folded into the bases), fb [n_bins, n_mels], everything f32. The
// [T, n_bins] power spectrogram never reaches device memory.
//
// What bounds it on the H100: operations. At the prompt shapes (T = 401,
// win = 400, n_bins = 201 and T = 201, win = 1024, n_bins = 513, B = 2) the
// two DFT products are 0.26 and 0.85 GFLOP of f32 FMA against 2 and 6 MB of
// operands, so the f32 pipes (67 TFLOP/s), not the memory, set the least
// time. This first version is far from that: it uses no tensor cores.
//
// Design: the TPU kernel keeps both whole bases in fast memory per program;
// at win = 1024 they are 2 x 2.1 MB and fit no SM. Here one block owns a
// tile of FT frames of one batch row, held transposed in shared memory
// ([win][FT], so one thread reads its FT frame samples as two float4
// broadcasts). A thread owns one frequency bin of the current chunk of BT
// bins and streams that bin's basis column from global memory (neighbouring
// threads read neighbouring bins, so a warp reads 128 contiguous bytes per
// basis row; the bases stay in L2 across blocks), keeping FT real and FT
// imaginary sums in registers. The chunk's powers go to shared memory and
// are folded into an [FT, n_mels] accumulator there, each (frame, mel) pair
// owned by one thread. Frames past T are zero in the tile and never
// written. All sums are f32 and sequential over the window / the bins.

#include <cuda_runtime.h>

namespace {

constexpr int FT = 8;     // frames per block
constexpr int BT = 128;   // threads per block = bins per chunk

__global__ void __launch_bounds__(BT)
log_mel_kernel(const float* __restrict__ frames, const float* __restrict__ cosb,
               const float* __restrict__ sinb, const float* __restrict__ fb,
               float* __restrict__ out, int T, int win, int n_bins, int n_mels, float eps) {
  extern __shared__ __align__(16) float smem[];
  float* fr_s = smem;                 // [win][FT]
  float* pw_s = fr_s + win * FT;      // [FT][BT]
  float* mel_s = pw_s + FT * BT;      // [FT][n_mels]
  const int b = blockIdx.y, t0 = blockIdx.x * FT;
  const int nf = min(FT, T - t0);
  const float* fr = frames + ((size_t)b * T + t0) * win;
  for (int i = threadIdx.x; i < FT * win; i += BT) {
    const int f = i / win, w = i - f * win;
    fr_s[w * FT + f] = f < nf ? fr[(size_t)f * win + w] : 0.f;
  }
  for (int i = threadIdx.x; i < FT * n_mels; i += BT) mel_s[i] = 0.f;
  __syncthreads();

  for (int c0 = 0; c0 < n_bins; c0 += BT) {
    const int bin = c0 + threadIdx.x;
    float re[FT], im[FT];
#pragma unroll
    for (int f = 0; f < FT; ++f) re[f] = im[f] = 0.f;
    if (bin < n_bins) {
      const float* cp = cosb + bin;
      const float* sp = sinb + bin;
#pragma unroll 4
      for (int w = 0; w < win; ++w) {
        const float c = __ldg(cp + (size_t)w * n_bins);
        const float s = __ldg(sp + (size_t)w * n_bins);
        const float4 a = *reinterpret_cast<const float4*>(fr_s + w * FT);
        const float4 d = *reinterpret_cast<const float4*>(fr_s + w * FT + 4);
        const float x[FT] = {a.x, a.y, a.z, a.w, d.x, d.y, d.z, d.w};
#pragma unroll
        for (int f = 0; f < FT; ++f) {
          re[f] += x[f] * c;
          im[f] += x[f] * s;
        }
      }
    }
#pragma unroll
    for (int f = 0; f < FT; ++f) pw_s[f * BT + threadIdx.x] = re[f] * re[f] + im[f] * im[f];
    __syncthreads();
    const int nb = min(BT, n_bins - c0);
    for (int o = threadIdx.x; o < FT * n_mels; o += BT) {
      const int f = o / n_mels, m = o - f * n_mels;
      const float* fbp = fb + (size_t)c0 * n_mels + m;
      const float* pw = pw_s + f * BT;
      float acc = mel_s[o];
      for (int j = 0; j < nb; ++j) acc += pw[j] * __ldg(fbp + (size_t)j * n_mels);
      mel_s[o] = acc;
    }
    __syncthreads();
  }
  for (int o = threadIdx.x; o < nf * n_mels; o += BT) {
    const int f = o / n_mels, m = o - f * n_mels;
    out[((size_t)b * T + t0 + f) * n_mels + m] = logf(fmaxf(mel_s[o], eps));
  }
}

}  // namespace

// Dynamic shared memory of one block, in bytes; the wrapper refuses shapes
// beyond the 48 KB a block gets without opting in.
extern "C" int fused_log_mel_smem_bytes(int win, int n_mels) {
  return (int)((size_t)(win * FT + FT * BT + FT * n_mels) * sizeof(float));
}

// frames [B, T, win], cosb/sinb [win, n_bins], fb [n_bins, n_mels],
// out [B, T, n_mels]; all f32, contiguous, on the device of `stream`.
// Returns the first CUDA error.
extern "C" int fused_log_mel(const void* frames, const void* cosb, const void* sinb,
                             const void* fb, void* out, int B, int T, int win, int n_bins,
                             int n_mels, float eps, void* stream) {
  const dim3 grid((T + FT - 1) / FT, B);
  log_mel_kernel<<<grid, BT, fused_log_mel_smem_bytes(win, n_mels), (cudaStream_t)stream>>>(
      (const float*)frames, (const float*)cosb, (const float*)sinb, (const float*)fb,
      (float*)out, T, win, n_bins, n_mels, eps);
  return (int)cudaGetLastError();
}
