// Fused log-mel spectrogram for Hopper (sm_90a), IEEE f32 throughout.
//
// Replaces the JAX package's Pallas TPU kernel `_mel_kernel`
// (iris_tts_tpu/ops/mel_pallas.py, launched by `log_mel_spectrogram_pallas`
// through pl.pallas_call). Same function, another algorithm:
//
//   audio [B, N] --centre zero pad n_fft/2, frames at hop (never stored)-->
//   Hann window --> rfft --> sqrt(re^2 + im^2 + 1e-12) --> @ mel_fb
//   --> log(max(., log_clip_min)) --> [B, T, n_mels]
//
// The 1e-12 floor under the root is the one of this package's plain version
// and of the JAX package's XLA path (ops/stft.py).
//
// What bounds it on the card. The TPU kernel evaluates the DFT as two dense
// [T, n_fft] x [n_fft, n_freqs] products on the MXU, ~2.1 MFLOP a frame at
// n_fft 1024. An FFT needs ~26 kFLOP a frame, 80x fewer. With the FFT the
// whole function does ~0.2 GFLOP and moves ~9.3 MB at B=8 x 10 s: its least
// time on the card is ~3 us and it sits below the card's balance point, so
// tensor cores would buy FLOP/s that the function does not need. What costs
// time is inside the SM: the FFT's exchanges between threads go through
// shared memory, a load and a store of every complex point a stage, and
// each warp's chain of stages waits on them. So the design keeps every
// intermediate on chip, moves as few bytes as it can, and keeps 16 warps an
// SM in flight (128 registers, ~106 KB of shared memory a block):
//
// * One warp transforms a pair of frames: frame a as the real part, frame b
//   as the imaginary part of one complex n_fft-point FFT, split afterwards
//   by X_a[k] = (Z[k] + conj Z[N-k]) / 2, X_b[k] = (Z[k] - conj Z[N-k]) / 2i.
// * Radix-4 Stockham stages (one radix-2 stage first when log2 n_fft is
//   odd) in a warp-private n_fft-point buffer in shared memory. A stage
//   reads all its inputs into registers, __syncwarp, then writes its
//   outputs in place, so one buffer serves all stages. The first stage
//   reads the two frames straight from the staged waveform and applies the
//   window as it loads. Twiddles come from a table built on the host in
//   float64 (no __sincosf), read through the read-only cache: W^k a
//   butterfly, W^2k and W^3k by products. (Padding or swizzling the buffer
//   against the 2- to 4-way bank conflicts of the first stages' stores
//   measured slower: the extra addressing spilled past the 128 registers
//   that two blocks an SM allow.)
// * The epilogue splits the pair, turns the n_fft/2+1 bins of each frame
//   into magnitudes in the same buffer, folds them into n_mels outputs
//   through a sparse filterbank (each triangle's first bin and its run of
//   nonzero weights), applies the log and writes n_mels contiguous floats
//   a frame. Only the output reaches device memory. The filterbank tables
//   are copied into shared memory once a block.
// * A block (8 warps) owns a group of 16 frames at a time and stages the
//   group's waveform span, 15*hop + n_fft samples, in shared memory with
//   16-byte cp.async copies; samples outside [0, N) (the centre padding) are
//   zero-filled by index. Blocks are persistent, as many as fit on the card
//   (2 an SM at n_fft 1024), and double-buffer: the next group's span is in
//   flight while the current group is transformed.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kGroup = 2 * kWarps;  // frames per group: one pair per warp

__host__ __device__ constexpr int log2_of(int n) {
  return n <= 1 ? 0 : 1 + log2_of(n / 2);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// In-register DFT of size R, forward sign (W = exp(-2 pi i / R)).
template <int R>
__device__ __forceinline__ void dft(float2 (&v)[R]);

template <>
__device__ __forceinline__ void dft<2>(float2 (&v)[2]) {
  const float2 a = v[0];
  v[0] = make_float2(a.x + v[1].x, a.y + v[1].y);
  v[1] = make_float2(a.x - v[1].x, a.y - v[1].y);
}

template <>
__device__ __forceinline__ void dft<4>(float2 (&v)[4]) {
  const float2 a0 = make_float2(v[0].x + v[2].x, v[0].y + v[2].y);
  const float2 a1 = make_float2(v[0].x - v[2].x, v[0].y - v[2].y);
  const float2 a2 = make_float2(v[1].x + v[3].x, v[1].y + v[3].y);
  // (v1 - v3) * (-i)
  const float2 a3 = make_float2(v[1].y - v[3].y, v[3].x - v[1].x);
  v[0] = make_float2(a0.x + a2.x, a0.y + a2.y);
  v[1] = make_float2(a1.x + a3.x, a1.y + a3.y);
  v[2] = make_float2(a0.x - a2.x, a0.y - a2.y);
  v[3] = make_float2(a1.x - a3.x, a1.y - a3.y);
}

// First stage (Ns = 1, no twiddles): butterfly j reads samples j + r*N/R of
// frames a and b, windows them, and writes z[j*R + r].
template <int N, int R>
__device__ __forceinline__ void first_stage(float2* z, const float* fa,
                                            const float* fb,
                                            const float* __restrict__ window,
                                            int lane) {
  constexpr int kBfly = N / R;
#pragma unroll
  for (int i = 0; i < (kBfly + 31) / 32; ++i) {
    const int j = lane + 32 * i;
    if (kBfly % 32 == 0 || j < kBfly) {
      float2 v[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int n = j + r * kBfly;
        const float w = __ldg(window + n);
        v[r] = make_float2(fa[n] * w, fb[n] * w);
      }
      dft<R>(v);
#pragma unroll
      for (int r = 0; r < R; ++r) z[j * R + r] = v[r];
    }
  }
  __syncwarp();
}

// A later Stockham stage, in place: butterfly j reads z[j + r*N/R], applies
// the twiddle W_N^((j % Ns) * r * N / (Ns*R)) and writes
// z[(j / Ns) * Ns * R + j % Ns + r * Ns].
template <int N, int R, int Ns>
__device__ __forceinline__ void stockham_stage(float2* z,
                                               const float2* __restrict__ tw,
                                               int lane) {
  constexpr int kBfly = N / R;
  constexpr int kPer = (kBfly + 31) / 32;
  float2 v[kPer][R];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int j = lane + 32 * i;
    if (kBfly % 32 == 0 || j < kBfly) {
#pragma unroll
      for (int r = 0; r < R; ++r) v[i][r] = z[j + r * kBfly];
    }
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int j = lane + 32 * i;
    if (kBfly % 32 == 0 || j < kBfly) {
      // W^k from the table; W^2k and W^3k by products, which saves two
      // of three loads at a cost of an ulp or so.
      const int k = j % Ns;
      const float2 w1 = __ldg(tw + k * (N / (Ns * R)));
      v[i][1] = cmul(v[i][1], w1);
      if constexpr (R == 4) {
        const float2 w2 = cmul(w1, w1);
        v[i][2] = cmul(v[i][2], w2);
        v[i][3] = cmul(v[i][3], cmul(w1, w2));
      }
      dft<R>(v[i]);
      const int d = (j / Ns) * Ns * R + k;
#pragma unroll
      for (int r = 0; r < R; ++r) z[d + r * Ns] = v[i][r];
    }
  }
  __syncwarp();
}

template <int N, int Ns>
__device__ __forceinline__ void radix4_stages(float2* z,
                                              const float2* __restrict__ tw,
                                              int lane) {
  if constexpr (Ns < N) {
    stockham_stage<N, 4, Ns>(z, tw, lane);
    radix4_stages<N, Ns * 4>(z, tw, lane);
  }
}

// Z = FFT(window * (frame a + i frame b)), natural order, in z.
template <int N>
__device__ __forceinline__ void fft_pair(float2* z, const float* fa,
                                         const float* fb,
                                         const float* __restrict__ window,
                                         const float2* __restrict__ tw,
                                         int lane) {
  if constexpr (log2_of(N) % 2 == 1) {
    first_stage<N, 2>(z, fa, fb, window, lane);
    radix4_stages<N, 2>(z, tw, lane);
  } else {
    first_stage<N, 4>(z, fa, fb, window, lane);
    radix4_stages<N, 4>(z, tw, lane);
  }
}

// Splits Z into the two frames' spectra and overwrites the buffer with
// their magnitudes: frame a at floats [0, N/2], frame b at [N, N + N/2].
template <int N>
__device__ __forceinline__ void split_magnitudes(float2* z, int lane) {
  constexpr int kHalf = N / 2;
  constexpr int kPer = (kHalf + 31) / 32;
  float2 p[kPer], q[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int k = lane + 32 * i;
    if (kHalf % 32 == 0 || k < kHalf) {
      p[i] = z[k];
      q[i] = z[(N - k) & (N - 1)];
    }
  }
  const float2 mid = z[kHalf];  // its own conjugate partner
  __syncwarp();
  float* mag = reinterpret_cast<float*>(z);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int k = lane + 32 * i;
    if (kHalf % 32 == 0 || k < kHalf) {
      const float re_a = 0.5f * (p[i].x + q[i].x);
      const float im_a = 0.5f * (p[i].y - q[i].y);
      const float re_b = 0.5f * (p[i].y + q[i].y);
      const float im_b = 0.5f * (q[i].x - p[i].x);
      mag[k] = sqrtf(re_a * re_a + im_a * im_a + 1e-12f);
      mag[N + k] = sqrtf(re_b * re_b + im_b * im_b + 1e-12f);
    }
  }
  if (lane == 0) {
    mag[kHalf] = sqrtf(mid.x * mid.x + 1e-12f);
    mag[N + kHalf] = sqrtf(mid.y * mid.y + 1e-12f);
  }
  __syncwarp();
}

// Where group g's waveform span lies: row b, frames t0.., and the staged
// copy starting `shift` samples before the first frame's first sample so
// that every 16-byte chunk of the copy is aligned in device memory.
struct Span {
  int b;          // batch row
  long long row;  // offset of row b in audio
  int t0;         // first frame of the group
  int start;      // row-relative sample of staged element 0
  int shift;      // staged index of the first frame's first sample
  int chunks;     // 4-sample chunks to stage
};

__device__ __forceinline__ Span group_span(int g, int groups_per_row,
                                           const float* audio, int n_samples,
                                           int n_fft, int hop) {
  Span s;
  s.b = g / groups_per_row;
  s.t0 = (g % groups_per_row) * kGroup;
  s.row = static_cast<long long>(s.b) * n_samples;
  const int s0 = s.t0 * hop - n_fft / 2;
  const long long word = static_cast<long long>(
      reinterpret_cast<uintptr_t>(audio) / sizeof(float));
  s.shift = static_cast<int>((word + s.row + s0) & 3);
  s.start = s0 - s.shift;
  s.chunks = (s.shift + (kGroup - 1) * hop + n_fft + 3) / 4;
  return s;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most the newest committed group is still in flight.
__device__ __forceinline__ void cp_async_wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Starts the copy of a group's span into `dst`, zero outside [0, N).
__device__ __forceinline__ void stage_span(float* dst, const Span& s,
                                           const float* audio, int n_samples) {
  const float* row = audio + s.row;
  for (int c = threadIdx.x; c < s.chunks; c += kThreads) {
    const int first = s.start + 4 * c;
    float* d = dst + 4 * c;
    if (first >= 0 && first + 3 < n_samples) {
      cp_async16(d, row + first);
    } else if (first + 3 < 0 || first >= n_samples) {
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = first + e;
        if (i >= 0 && i < n_samples)
          cp_async4(d + e, row + i);
        else
          d[e] = 0.f;
      }
    }
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads, N <= 1024 ? 2 : 1)
log_mel_kernel(const float* __restrict__ audio,      // [B, n_samples]
               const float* __restrict__ window,     // [N]
               const float2* __restrict__ twiddles,  // [N]: W_N^k
               const int* __restrict__ fb_first,     // [n_mels]
               const int* __restrict__ fb_offset,    // [n_mels + 1]
               const float* __restrict__ fb_weights, // [nnz]
               float* __restrict__ out,              // [B, T, n_mels]
               int batch, int n_samples, int n_frames, int hop, int n_mels,
               int nnz, float log_clip_min, int wave_cap) {
  // Shared memory: two waveform spans, one FFT buffer a warp, and the
  // sparse filterbank, whose run-length loop would otherwise wait on the
  // cache at every step.
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float2* z = reinterpret_cast<float2*>(smem + 2 * wave_cap) + warp * N;
  float* weights = smem + 2 * wave_cap + 2 * kWarps * N;
  int* first = reinterpret_cast<int*>(weights + nnz);
  int* offset = first + n_mels;
  for (int i = threadIdx.x; i < nnz; i += kThreads) weights[i] = fb_weights[i];
  for (int i = threadIdx.x; i < n_mels; i += kThreads) first[i] = fb_first[i];
  for (int i = threadIdx.x; i <= n_mels; i += kThreads)
    offset[i] = fb_offset[i];
  const int groups_per_row = (n_frames + kGroup - 1) / kGroup;
  const int n_groups = batch * groups_per_row;

  int buf = 0;
  int g = blockIdx.x;
  if (g < n_groups)
    stage_span(smem, group_span(g, groups_per_row, audio, n_samples, N, hop),
               audio, n_samples);
  cp_async_commit();
  for (; g < n_groups; g += gridDim.x) {
    const int next = g + gridDim.x;
    if (next < n_groups)
      stage_span(smem + (buf ^ 1) * wave_cap,
                 group_span(next, groups_per_row, audio, n_samples, N, hop),
                 audio, n_samples);
    cp_async_commit();
    cp_async_wait_all_but_newest();
    __syncthreads();

    const Span s = group_span(g, groups_per_row, audio, n_samples, N, hop);
    const int ta = s.t0 + 2 * warp;
    if (ta < n_frames) {
      const float* fa = smem + buf * wave_cap + s.shift + 2 * warp * hop;
      fft_pair<N>(z, fa, fa + hop, window, twiddles, lane);
      split_magnitudes<N>(z, lane);
      const float* mag = reinterpret_cast<const float*>(z);
      const bool has_b = ta + 1 < n_frames;
      const long long frame0 = static_cast<long long>(s.b) * n_frames + ta;
      float* out_a = out + frame0 * n_mels;
      for (int m = lane; m < n_mels; m += 32) {
        const int o0 = offset[m];
        const int o1 = offset[m + 1];
        const int bin = first[m] - o0;  // bin of weight o: bin + o
        float sa = 0.f, sb = 0.f;
#pragma unroll 4
        for (int o = o0; o < o1; ++o) {
          sa = fmaf(mag[bin + o], weights[o], sa);
          sb = fmaf(mag[N + bin + o], weights[o], sb);
        }
        out_a[m] = logf(fmaxf(sa, log_clip_min));
        if (has_b) out_a[n_mels + m] = logf(fmaxf(sb, log_clip_min));
      }
    }
    // Every warp is done with this span before the next iteration stages
    // into it.
    __syncthreads();
    buf ^= 1;
  }
}

template <int N>
int launch(const float* audio, const float* window, const float* twiddles,
           const int* fb_first, const int* fb_offset, const float* fb_weights,
           float* out, int batch, int n_samples, int n_frames, int hop,
           int n_mels, int nnz, float log_clip_min, cudaStream_t stream) {
  const long long span = static_cast<long long>(kGroup - 1) * hop + N;
  const long long wave_cap = (span + 3 + 3) / 4 * 4;
  const long long smem =
      4 * (2 * wave_cap + 2LL * kWarps * N + nnz + 2LL * n_mels + 1);
  const long long groups =
      static_cast<long long>(batch) * ((n_frames + kGroup - 1) / kGroup);
  if (groups > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int max_smem = 0, sms = 0;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > max_smem) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(log_mel_kernel<N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, log_mel_kernel<N>, kThreads, static_cast<size_t>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long resident = static_cast<long long>(per_sm) * sms;
  const int blocks = static_cast<int>(groups < resident ? groups : resident);
  log_mel_kernel<N><<<blocks, kThreads, static_cast<size_t>(smem), stream>>>(
      audio, window, reinterpret_cast<const float2*>(twiddles), fb_first,
      fb_offset, fb_weights, out, batch, n_samples, n_frames, hop, n_mels,
      nnz, log_clip_min, static_cast<int>(wave_cap));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns a cudaError_t (0 = launched).
// n_fft is a power of two in [64, 2048]. Does not synchronise: a fault
// during the run surfaces at the caller's next synchronisation.
int iris_log_mel(const float* audio, const float* window,
                 const float* twiddles, const int* fb_first,
                 const int* fb_offset, const float* fb_weights, float* out,
                 int batch, int n_samples, int n_frames, int n_fft, int hop,
                 int n_mels, int nnz, float log_clip_min, void* stream) {
  if (batch <= 0 || n_samples < 0 || n_frames <= 0 || hop <= 0 ||
      n_mels <= 0 || nnz < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define IRIS_LOG_MEL_CASE(n)                                               \
  case n:                                                                  \
    return launch<n>(audio, window, twiddles, fb_first, fb_offset,         \
                     fb_weights, out, batch, n_samples, n_frames, hop,     \
                     n_mels, nnz, log_clip_min, s);
  switch (n_fft) {
    IRIS_LOG_MEL_CASE(64)
    IRIS_LOG_MEL_CASE(128)
    IRIS_LOG_MEL_CASE(256)
    IRIS_LOG_MEL_CASE(512)
    IRIS_LOG_MEL_CASE(1024)
    IRIS_LOG_MEL_CASE(2048)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef IRIS_LOG_MEL_CASE
}

const char* iris_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
