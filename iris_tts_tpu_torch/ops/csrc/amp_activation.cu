// BigVGAN's anti-aliased SnakeBeta activation (alias_free_activation's
// Activation1d with SnakeBeta), for Hopper (sm_90a), IEEE f32 throughout:
// f32 in and out, FFMA sums in f32, the accurate sinf and expf (no fast-math
// intrinsic: alpha * x reaches magnitudes where __sinf's error is large).
//
// Replaces no TPU kernel: the JAX package has no BigVGAN. Added because the
// plain composition, on each of a BigVGAN-v2 call's 109 activations, makes
// 9-10 passes over a tensor at twice the signal's rate (a replicate pad, a
// depthwise transposed conv, a scale and a crop, five elementwise SnakeBeta
// passes, a second replicate pad and a depthwise strided conv), and the
// activations move about 20x the bytes they need.
//
// A launch computes, for a [rows, T] input (rows = B * C, channel = row % C),
//
//     y = Down(SnakeBeta(Up(x)))
//
//   Up:   replicate-pad 5 a side, 2 * conv_transpose1d(h, stride 2), crop 15
//         a side: 2T samples. As two polyphase branches of 6 taps:
//           u[2p]     = 2 * sum_{i<6} h[2i + 1] * x[clamp(p + 2 - i)]
//           u[2p + 1] = 2 * sum_{i<6} h[2i]     * x[clamp(p + 3 - i)]
//         with clamp(j) = min(max(j, 0), T - 1), which is the replicate pad.
//   SnakeBeta: v = u + 1 / (beta + 1e-9) * sin(alpha * u)^2, alpha and beta
//         the exponentials of the channel's stored logarithms.
//   Down: replicate-pad (5, 6) of the activated 2T samples, conv1d(h,
//         stride 2): y[n] = sum_{k<12} h[k] * v[clamp2(2n - 5 + k)], clamp2
//         to [0, 2T - 1]: the edge samples are the activated ones.
//
// h is the 12-tap Kaiser-windowed sinc low-pass (cutoff 0.25, half width
// 0.3) that the wrapper passes by value.
//
// What bounds it: device memory and the issue rate together. 8 bytes a
// sample (x read, y written) against 24 FFMAs and two accurate sinf (about
// 20 instructions each on the fast path) a sample: about 10 instructions a
// byte, at the card's balance point. So the design cuts instructions that
// are not arithmetic: shared-memory loads, index arithmetic and branches.
// A block owns kTile outputs of one row:
//
// * It stages x from n0 - 6 over the tile and its halo (the replicate pad
//   by clamping the index) in shared memory, one coalesced read.
// * Up and SnakeBeta: a thread takes 4 consecutive input positions p and
//   writes the activated pair v(2p), v(2p + 1) of each: its 10 x values
//   come in as three 16-byte shared loads and stay in registers for the
//   48 FFMAs. Even and odd samples go to two arrays.
// * Down: a thread takes 4 consecutive outputs; y[n] = sum_i h[2i] *
//   v(2n - 5 + 2i) + h[2i + 1] * v(2n - 4 + 2i), i < 6, in the order
//   k = 0 ... 11, from six 16-byte shared loads. The outputs go through
//   shared memory to one coalesced write.
// * The outputs within 3 samples of a row's ends (where 2n - 5 + k leaves
//   [0, 2T)) take a plain path that reads v at the clamped index, so an
//   out-of-range sample is the activated edge sample, as the composition's
//   second pad makes it. It sums in the same order as the inner outputs,
//   so every output is summed in one fixed order whatever the tile's
//   start: a window of the signal gives the same samples as the whole
//   signal wherever both see the same inputs
//   (TTSPipeline.vocode_streaming).

#include <cuda_runtime.h>

namespace {

constexpr int kTaps = 12;
constexpr int kThreads = 256;
constexpr int kTile = 1024;      // outputs a block
constexpr int kP = kTile + 8;    // positions p = n0 - 3 + j with a pair v
constexpr int kXs = kTile + 16;  // x staged from n0 - 6

struct Taps {
  float h[kTaps];
};

__device__ __forceinline__ int clampi(int j, int hi) {
  return j < 0 ? 0 : (j > hi ? hi : j);
}

__device__ __forceinline__ void load12(float (&w)[12], const float* s) {
  const float4* v = reinterpret_cast<const float4*>(s);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float4 f = v[i];
    w[4 * i] = f.x;
    w[4 * i + 1] = f.y;
    w[4 * i + 2] = f.z;
    w[4 * i + 3] = f.w;
  }
}

__global__ void __launch_bounds__(kThreads)
    iris_amp_act_kernel(const float* __restrict__ x,
                        const float* __restrict__ alpha,
                        const float* __restrict__ beta,
                        float* __restrict__ y, int channels, int T,
                        int tiles, Taps taps) {
  __shared__ __align__(16) float xs[kXs];  // x, then the outputs
  __shared__ __align__(16) float ve[kP];   // v(2p)     at j = p - n0 + 3
  __shared__ __align__(16) float vo[kP];   // v(2p + 1)

  const long long row = blockIdx.x / tiles;
  const int n0 = (blockIdx.x % tiles) * kTile;
  const int c = static_cast<int>(row % channels);
  const float* xr = x + row * T;

  for (int j = threadIdx.x; j < kXs; j += kThreads)
    xs[j] = xr[clampi(n0 - 6 + j, T - 1)];

  const float a = expf(alpha[c]);
  const float inv = 1.0f / (expf(beta[c]) + 1e-9f);
  const float* h = taps.h;
  __syncthreads();

  // Up and SnakeBeta at p = n0 - 3 + 4g + r: x[p - 3 + i] = w[r + i].
  for (int g = threadIdx.x; g < kP / 4; g += kThreads) {
    float w[12];
    load12(w, xs + 4 * g);
    float e[4], o[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float ue = 0.f, uo = 0.f;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        ue = fmaf(h[2 * i + 1], w[r + 5 - i], ue);  // x[p + 2 - i]
        uo = fmaf(h[2 * i], w[r + 6 - i], uo);      // x[p + 3 - i]
      }
      ue = 2.0f * ue;
      uo = 2.0f * uo;
      const float se = sinf(a * ue), so = sinf(a * uo);
      e[r] = ue + inv * (se * se);
      o[r] = uo + inv * (so * so);
    }
    reinterpret_cast<float4*>(ve)[g] = make_float4(e[0], e[1], e[2], e[3]);
    reinterpret_cast<float4*>(vo)[g] = make_float4(o[0], o[1], o[2], o[3]);
  }
  __syncthreads();

  const int n_out = min(kTile, T - n0);
  float* yr = y + row * T + n0;
  for (int g = threadIdx.x; 4 * g < n_out; g += kThreads) {
    const int q0 = 4 * g;
    if (n0 + q0 >= 3 && n0 + q0 + 7 <= T) {
      // y[n0 + q] = sum_i h[2i] vo[q + i] + h[2i + 1] ve[q + 1 + i]
      float od[12], ev[12];
      load12(od, vo + q0);
      load12(ev, ve + q0);
      float out[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          acc = fmaf(h[2 * i], od[r + i], acc);
          acc = fmaf(h[2 * i + 1], ev[r + 1 + i], acc);
        }
        out[r] = acc;
      }
      reinterpret_cast<float4*>(xs)[g] =
          make_float4(out[0], out[1], out[2], out[3]);
    } else {  // within 3 outputs of a row's ends: v at the clamped index
      for (int q = q0; q < min(q0 + 4, n_out); ++q) {
        const int n = n0 + q;
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < kTaps; ++k) {
          const int m = clampi(2 * n - 5 + k, 2 * T - 1);
          const int j = (m >> 1) - n0 + 3;
          acc = fmaf(h[k], (m & 1) ? vo[j] : ve[j], acc);
        }
        xs[q] = acc;
      }
    }
  }
  __syncthreads();
  for (int q = threadIdx.x; q < n_out; q += kThreads) yr[q] = xs[q];
}

}  // namespace

extern "C" {

// y = Down(SnakeBeta(Up(x))) on x [rows, t] (rows = batch * channels) with
// per-channel log-alpha and log-beta [channels] and the 12 taps h (host floats). Device pointers; launches on `stream`
// and does not synchronise; returns a cudaError_t (0 = launched).
int iris_amp_act(const void* x, const void* alpha, const void* beta, void* y,
                 long long rows, int channels, int t, const float* h,
                 void* stream) {
  if (rows < 1 || channels < 1 || t < 1 || rows % channels != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (t + kTile - 1) / kTile;
  if (rows * tiles > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  Taps taps;
  for (int k = 0; k < kTaps; ++k) taps.h[k] = h[k];
  iris_amp_act_kernel<<<static_cast<unsigned>(rows * tiles), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(alpha),
      static_cast<const float*>(beta), static_cast<float*>(y), channels, t,
      static_cast<int>(tiles), taps);
  return static_cast<int>(cudaGetLastError());
}

const char* iris_amp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
