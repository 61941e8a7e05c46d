// Fused log-mel spectrogram for Hopper (sm_90a), IEEE f32 throughout.
//
// Replaces the JAX package's Pallas TPU kernel `_mel_kernel`
// (ops/mel_pallas.py, launched by `log_mel_spectrogram_pallas` through
// pl.pallas_call). Same function, not the same block structure:
//
//   audio [B, N] --centre zero pad n_fft/2, frames at hop--> [T, n_fft]
//   re, im = frames @ DFT_re, frames @ DFT_im        (window folded in)
//   mag    = sqrt(re^2 + im^2 + 1e-12)
//   out    = log(max(mag @ mel_fb, log_clip_min))    -> [B, T, n_mels]
//
// The magnitude follows the JAX package's XLA path (and this package's
// plain version, ops/stft.py): a 1e-12 floor under the root. The Pallas
// kernel takes the root with no floor; the two differ by at most 1e-6 in a
// magnitude, far below the 1e-5 log clip.
//
// What bounds it on the card: operations. At B=8 x 10 s (T=862) the two
// DFT contractions are ~14.5 GFLOP against ~10 MB of unique bytes, far
// above the card's f32 balance point. TF32 tensor cores are not accurate
// enough (one reduced-precision pass cost ~1e-1 max-abs on the TPU), so
// this first version uses plain f32 FMAs on the CUDA cores.
//
// Design:
// * grid = (frame tiles of 32, batch rows); 256 threads per block.
// * The frame matrix is never materialised: a block stages the waveform
//   span its 32 frames cover ((32-1)*hop + n_fft samples) in shared memory
//   once, with the centre padding done by index arithmetic, and reads frame
//   t, sample n at wave[t*hop + n].
// * The DFT runs in passes of 64 bins; each pass streams the two DFT
//   matrices through shared memory in chunks of 32 rows. A thread owns
//   4 frames x 2 bins (re and im: 16 accumulators); the 4 frames of a warp
//   are the same for all its lanes, so their reads are broadcasts.
// * After each pass the block turns its [32, 64] re/im tile into
//   magnitudes in shared memory and folds them into the [32, n_mels] mel
//   accumulators (also in shared memory), so the [T, 513] spectrum never
//   reaches device memory.
// * The epilogue applies log(max(., clip)) and writes [B, T, n_mels].

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileT = 32;  // frames per block
constexpr int kTileF = 64;  // frequency bins per pass
constexpr int kTileN = 32;  // DFT rows per staged chunk
constexpr int kTT = 4;      // frames per thread: tt + 8*i
constexpr int kTF = 2;      // bins per thread:   tf + 32*j
static_assert((kTileT / kTT) * (kTileF / kTF) == kThreads, "thread layout");
static_assert(kTileF / kTF == 32, "one warp spans the bins of a pass");

__global__ void __launch_bounds__(kThreads)
log_mel_kernel(const float* __restrict__ audio,  // [B, N]
               const float* __restrict__ dft_re,  // [n_fft, n_freqs]
               const float* __restrict__ dft_im,  // [n_fft, n_freqs]
               const float* __restrict__ fb,      // [n_freqs, n_mels]
               float* __restrict__ out,           // [B, T, n_mels]
               int n_samples, int n_frames, int n_fft, int hop, int n_freqs,
               int n_mels, float log_clip_min) {
  extern __shared__ float smem[];
  const int seg_len = (kTileT - 1) * hop + n_fft;
  float* wave = smem;                       // [seg_len]
  float* w_re = wave + seg_len;             // [kTileN][kTileF]
  float* w_im = w_re + kTileN * kTileF;     // [kTileN][kTileF]
  float* mag = w_im + kTileN * kTileF;      // [kTileT][kTileF]
  float* mel = mag + kTileT * kTileF;       // [kTileT][n_mels]

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTileT;
  const float* x = audio + static_cast<size_t>(b) * n_samples;

  // Waveform span of this block's frames, zero outside [0, N): that is
  // the centre padding of n_fft/2 on each side.
  const int s0 = t0 * hop - n_fft / 2;
  for (int i = tid; i < seg_len; i += kThreads) {
    const int s = s0 + i;
    wave[i] = (s >= 0 && s < n_samples) ? x[s] : 0.0f;
  }
  for (int i = tid; i < kTileT * n_mels; i += kThreads) mel[i] = 0.0f;

  const int tf = tid % 32;
  const int tt = tid / 32;

  for (int f0 = 0; f0 < n_freqs; f0 += kTileF) {
    float acc_re[kTT][kTF];
    float acc_im[kTT][kTF];
#pragma unroll
    for (int i = 0; i < kTT; ++i)
#pragma unroll
      for (int j = 0; j < kTF; ++j) acc_re[i][j] = acc_im[i][j] = 0.0f;

    for (int n0 = 0; n0 < n_fft; n0 += kTileN) {
      // The previous chunk (or the previous pass's mel fold) is consumed.
      __syncthreads();
      for (int i = tid; i < kTileN * kTileF; i += kThreads) {
        const int nn = i / kTileF;
        const int f = f0 + i % kTileF;
        const size_t g = static_cast<size_t>(n0 + nn) * n_freqs + f;
        const bool ok = f < n_freqs;
        w_re[i] = ok ? dft_re[g] : 0.0f;
        w_im[i] = ok ? dft_im[g] : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int nn = 0; nn < kTileN; ++nn) {
        float xv[kTT];
#pragma unroll
        for (int i = 0; i < kTT; ++i)
          xv[i] = wave[(tt + 8 * i) * hop + n0 + nn];
#pragma unroll
        for (int j = 0; j < kTF; ++j) {
          const float wr = w_re[nn * kTileF + tf + 32 * j];
          const float wi = w_im[nn * kTileF + tf + 32 * j];
#pragma unroll
          for (int i = 0; i < kTT; ++i) {
            acc_re[i][j] = fmaf(xv[i], wr, acc_re[i][j]);
            acc_im[i][j] = fmaf(xv[i], wi, acc_im[i][j]);
          }
        }
      }
    }

#pragma unroll
    for (int i = 0; i < kTT; ++i)
#pragma unroll
      for (int j = 0; j < kTF; ++j) {
        const float re = acc_re[i][j];
        const float im = acc_im[i][j];
        mag[(tt + 8 * i) * kTileF + tf + 32 * j] =
            sqrtf(re * re + im * im + 1e-12f);
      }
    __syncthreads();

    // mel[t][m] += sum over this pass's bins of mag[t][f] * fb[f][m].
    const int nf = min(kTileF, n_freqs - f0);
    for (int i = tid; i < kTileT * n_mels; i += kThreads) {
      const int t = i / n_mels;
      const int m = i % n_mels;
      const float* mrow = mag + t * kTileF;
      const float* fcol = fb + static_cast<size_t>(f0) * n_mels + m;
      float s = mel[i];
      for (int fl = 0; fl < nf; ++fl)
        s = fmaf(mrow[fl], fcol[static_cast<size_t>(fl) * n_mels], s);
      mel[i] = s;
    }
  }

  // Each thread reads back only the mel entries it accumulated itself.
  for (int i = tid; i < kTileT * n_mels; i += kThreads) {
    const int t = t0 + i / n_mels;
    if (t < n_frames)
      out[(static_cast<size_t>(b) * n_frames + t) * n_mels + i % n_mels] =
          logf(fmaxf(mel[i], log_clip_min));
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns a cudaError_t (0 = launched).
// Does not synchronise: a fault during the run surfaces at the caller's
// next synchronisation.
int iris_log_mel(const float* audio, const float* dft_re,
                 const float* dft_im, const float* fb, float* out, int batch,
                 int n_samples, int n_frames, int n_fft, int hop, int n_freqs,
                 int n_mels, float log_clip_min, void* stream) {
  if (batch <= 0 || batch > 65535 || n_frames <= 0 || n_fft % kTileN != 0 ||
      hop <= 0 || n_freqs <= 0 || n_mels <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(float) *
      (static_cast<size_t>(kTileT - 1) * hop + n_fft + 2 * kTileN * kTileF +
       kTileT * kTileF + static_cast<size_t>(kTileT) * n_mels);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int max_smem = 0;
  err = cudaDeviceGetAttribute(
      &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > static_cast<size_t>(max_smem))
    return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(log_mel_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_frames + kTileT - 1) / kTileT, batch);
  log_mel_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      audio, dft_re, dft_im, fb, out, n_samples, n_frames, n_fft, hop,
      n_freqs, n_mels, log_clip_min);
  return static_cast<int>(cudaGetLastError());
}

const char* iris_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
