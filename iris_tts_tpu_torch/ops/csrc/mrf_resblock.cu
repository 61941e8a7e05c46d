// One layer of HiFiGAN's multi-receptive-field (MRF) residual blocks at narrow
// widths, for Hopper (sm_90a), IEEE f32 throughout: f32 in, FFMA
// accumulation in f32, f32 out. No tensor core, so PyTorch's TF32 switches
// do not reach it.
//
// Replaces no TPU kernel: the JAX package leaves HiFiGAN's convolutions to
// XLA (iris_tts_tpu/models/hifigan.py has no pallas_call). Added because at
// 8-32 channels cuDNN's f32 implicit-GEMM tiles put the output channels on
// one tile edge and leave most of each tile idle, and the chain of
// elementwise passes around the convs (two leaky ReLUs and a residual add a
// layer, the MRF sum and average) is about 30% of HiFiGAN V2's vocoder
// time; at these widths every one of them is a full pass over a tensor of
// 2048 floats a mel frame.
//
// A launch computes, for a [B, C, T] input x and one layer of a ResBlock,
//
//     y = x + conv2_{K,1}(lrelu(conv1_{K,d}(lrelu(x))))
//
// with torch's same-padding (zeros outside [0, T)), and on a block's last
// layer one step of the MRF average ``((o0 + o1) + o2) / n`` in the
// epilogue: the first block writes the sum buffer, a middle block adds to it
// (kAddSum), the last adds and finishes (kFinish): it multiplies by the f32
// reciprocal of n, as PyTorch's CUDA division by a Python number does, and
// applies the leaky ReLU that the next upsampler or conv_post would apply.
//
// What bounds it: FFMA. A layer does 2 * 2 * C * C * K flops a sample
// against 3 * 4 * C bytes of device memory (x read, x read again for the
// residual from L2, y written), 48-350 flops a byte at C = 32, above the
// card's f32 balance point (20). At C = 8, K = 3 it is near the balance
// point. The design keeps the FFMA pipes fed:
//
// * A block owns a tile of output samples of one row. It stages lrelu(x)
//   for all C channels over the tile plus conv2's reach ((K-1)/2 a side)
//   plus conv1's ((K-1)*d/2 a side) in shared memory, with zeros outside
//   [0, T), and conv1's packed weights [C_in][K][C_out], by cp.async copies
//   that are all in flight at once (a thread's loads one after another
//   left the tile waiting on memory latency: 19.3 ms against 13.9 ms for
//   V2's 32-channel stage at 32 rows x 742 frames on an H100 SXM, 700 W).
// * The block is kGroups groups of 128 threads. A thread computes kSteps
//   positions strided by 128 (so a warp reads 32 consecutive floats: no
//   bank conflict) times its group's C / kGroups output channels, in
//   registers. Per (c_in, k) it reads kSteps activations and its channels'
//   weights as float4 warp broadcasts, and issues kSteps * C / kGroups
//   FFMAs. Splitting the channels puts 16-32 warps on an SM: measured on
//   V2's stages at 32 rows x 742 frames on the same H100, more warps hid the
//   staging and the barriers better than more accumulators a thread did
//   (32 channels: 3 steps x 8 channels 10.5 ms, 3 x 16 11.0 ms, 3 x 32
//   13.9 ms).
// * conv1 covers the tile plus conv2's reach. Positions outside [0, T) are
//   set to zero, not computed from padding, which is what conv2's zero
//   padding sees on the unfused path. lrelu(conv1 + bias) then overwrites
//   the staged input in shared memory while conv2's weights are copied over
//   conv1's, and conv2 runs the same loop. The epilogue adds the bias, the
//   residual (read from device memory, an L2 hit) and the MRF step, and
//   writes once.
// * Every output sample is summed in one order, c_in outer and k inner,
//   bias last, whatever the tile's start: a window of the signal gives the
//   same samples as the whole signal wherever both see the same inputs
//   (TTSPipeline.vocode_streaming relies on this). That is also the order
//   of cuDNN's f32 implicit GEMM at these shapes: on the H100 the kernel's
//   output has equalled the library composition's bit for bit.
// * Shared memory: one conv's weights (45 KB at C = 32, K = 11) and the
//   staged tile (56 KB), so two blocks fit an SM.
//
// iris_mrf_pack transposes the 2 * layers convs of a stage from torch's
// [C_out, C_in, K] into the packed [C_in][K][C_out] + bias layout, in one
// launch, so the layer kernel's weight loads are contiguous float4 copies.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kLanes = 128;  // positions a group of threads covers at once
constexpr int kMaxSpan = 50;  // (K - 1) * d: conv1's reach over both sides
constexpr int kMaxConvs = 64;
constexpr float kSlope = 0.1f;  // HiFiGAN's LRELU_SLOPE

enum : int { kAddSum = 1, kFinish = 2 };

// Per width: positions a thread computes (strided by kLanes), and groups
// of threads that split the output channels between them, each group
// covering all of the tile's positions.
template <int C>
struct Shape;
template <>
struct Shape<8> {
  static constexpr int kSteps = 4, kGroups = 2;
};
template <>
struct Shape<16> {
  static constexpr int kSteps = 4, kGroups = 2;
};
template <>
struct Shape<32> {
  static constexpr int kSteps = 3, kGroups = 4;
};

template <int C, int K>
struct Plan {
  static constexpr int kSteps = Shape<C>::kSteps;
  static constexpr int kGroups = Shape<C>::kGroups;
  static constexpr int kThreads = kLanes * kGroups;
  static constexpr int kCo = C / kGroups;        // output channels a thread
  static constexpr int kP1 = kLanes * kSteps;    // conv1 positions a tile
  static constexpr int kHalf = (K - 1) / 2;      // conv2's reach a side
  static constexpr int kTile = kP1 - 2 * kHalf;  // output samples a tile
  static constexpr int kW = C * K * C;           // one conv's weights
  static constexpr int kRowH = kP1 + K - 1;      // conv1's row, zero tail
  static int smem_bytes(int d) {
    return 4 * (kW + C * (kP1 + (K - 1) * d));
  }
};

__device__ __forceinline__ float lrelu(float v) {
  return v > 0.f ? v : v * kSlope;
}

// Asynchronous copies to shared memory (cp.async): a thread keeps all its
// copies of a tile in flight at once and waits for them together.
__device__ __forceinline__ void copy4(float* s, const float* g, bool valid) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(sa),
               "l"(g), "r"(valid ? 4 : 0));  // zero-filled when not valid
}

__device__ __forceinline__ void copy16(float* s, const float* g) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa),
               "l"(g));
}

__device__ __forceinline__ void copies_done() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int N, int NT>
__device__ __forceinline__ void load_weights(float* s, const float* g) {
  for (int i = threadIdx.x; i < N / 4; i += NT) copy16(s + 4 * i, g + 4 * i);
}

// acc[j][c] = sum over ci, then k, of w[ci][k][c] * a[ci * row + j * kLanes
// + k * d]: `a` at the thread's first position, `w` at its first output
// channel (row stride C).
template <int C, int CO, int K, int S>
__device__ __forceinline__ void conv(float (&acc)[S][CO], const float* a,
                                     int row, int d, const float* w) {
#pragma unroll
  for (int j = 0; j < S; ++j)
#pragma unroll
    for (int c = 0; c < CO; ++c) acc[j][c] = 0.f;
#pragma unroll 1
  for (int ci = 0; ci < C; ++ci) {
    const float* ar = a + ci * row;
    const float4* wr = reinterpret_cast<const float4*>(w + ci * K * C);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float v[S];
#pragma unroll
      for (int j = 0; j < S; ++j) v[j] = ar[k * d + j * kLanes];
#pragma unroll
      for (int q = 0; q < CO / 4; ++q) {
        const float4 wq = wr[k * (C / 4) + q];
#pragma unroll
        for (int j = 0; j < S; ++j) {
          acc[j][4 * q + 0] = fmaf(wq.x, v[j], acc[j][4 * q + 0]);
          acc[j][4 * q + 1] = fmaf(wq.y, v[j], acc[j][4 * q + 1]);
          acc[j][4 * q + 2] = fmaf(wq.z, v[j], acc[j][4 * q + 2]);
          acc[j][4 * q + 3] = fmaf(wq.w, v[j], acc[j][4 * q + 3]);
        }
      }
    }
  }
}

template <int C, int K>
__global__ void __launch_bounds__(Plan<C, K>::kThreads)
    iris_mrf_layer_kernel(const float* __restrict__ x,   // [B, C, T]
                          const float* __restrict__ w1,  // packed conv1
                          const float* __restrict__ b1,  // [C]
                          const float* __restrict__ w2,  // packed conv2
                          const float* __restrict__ b2,  // [C]
                          const float* sum_in,  // [B, C, T]; may be `out`
                          float* out,           // [B, C, T]
                          int T, int d, int mode, int n_blocks) {
  using P = Plan<C, K>;
  constexpr int S = P::kSteps, CO = P::kCo, NT = P::kThreads;
  extern __shared__ float4 smem4[];
  float* s_w = reinterpret_cast<float*>(smem4);
  float* s_a = s_w + P::kW;
  const int span = (K - 1) * d;
  const int row_x = P::kP1 + span;
  const int tid = threadIdx.x;
  const int lane = tid % kLanes;
  const int c0 = (tid / kLanes) * CO;  // the thread's first output channel
  const int t0 = blockIdx.x * P::kTile;
  const size_t base = static_cast<size_t>(blockIdx.y) * C * T;
  const float* xb = x + base;

  // lrelu(x) at t0 - kHalf - span / 2 + p, p < row_x; zeros outside [0, T).
  const int xs = t0 - P::kHalf - span / 2;
  for (int p = tid; p < row_x; p += NT) {
    const int t = xs + p;
    const bool in = t >= 0 && t < T;
    const float* xt = xb + (in ? t : 0);
#pragma unroll
    for (int c = 0; c < C; ++c)
      copy4(s_a + c * row_x + p, xt + static_cast<size_t>(c) * T, in);
  }
  load_weights<P::kW, NT>(s_w, w1);
  copies_done();
  for (int p = tid; p < row_x; p += NT)
#pragma unroll
    for (int c = 0; c < C; ++c) s_a[c * row_x + p] = lrelu(s_a[c * row_x + p]);
  __syncthreads();

  float acc[S][CO];
  // conv1 at t0 - kHalf + p, p = lane + j * kLanes < kP1.
  conv<C, CO, K, S>(acc, s_a + lane, row_x, d, s_w + c0);
  __syncthreads();  // every thread is done with the input and conv1's weights
  load_weights<P::kW, NT>(s_w, w2);
#pragma unroll
  for (int c = 0; c < CO; ++c) {
    const float b = __ldg(b1 + c0 + c);
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const int p = lane + j * kLanes;
      const int t = t0 - P::kHalf + p;
      s_a[(c0 + c) * P::kRowH + p] =
          (t >= 0 && t < T) ? lrelu(acc[j][c] + b) : 0.f;
    }
  }
  for (int i = tid; i < C * (K - 1); i += NT)
    s_a[(i / (K - 1)) * P::kRowH + P::kP1 + i % (K - 1)] = 0.f;
  copies_done();
  __syncthreads();

  // conv2 at t0 + q, q = lane + j * kLanes; q < kTile are kept.
  conv<C, CO, K, S>(acc, s_a + lane, P::kRowH, 1, s_w + c0);
  const float inv_n = 1.0f / static_cast<float>(n_blocks);
#pragma unroll
  for (int c = 0; c < CO; ++c) {
    const float b = __ldg(b2 + c0 + c);
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const int q = lane + j * kLanes;
      const int t = t0 + q;
      if (q < P::kTile && t < T) {
        const size_t i = base + static_cast<size_t>(c0 + c) * T + t;
        float y = __ldg(x + i) + (acc[j][c] + b);
        if (mode & kAddSum) y = sum_in[i] + y;
        if (mode & kFinish) y = lrelu(y * inv_n);
        out[i] = y;
      }
    }
  }
}

struct PackArgs {
  const float* w[kMaxConvs];
  const float* b[kMaxConvs];
  int k[kMaxConvs];
  int off[kMaxConvs];
};

// Block n: conv n's [C_out, C_in, K] weight → [C_in][K][C_out] at off[n],
// its bias right after.
__global__ void iris_mrf_pack_kernel(PackArgs a, int c, float* packed) {
  const int n = blockIdx.x;
  const int K = a.k[n];
  const int nw = c * K * c;
  const float* w = a.w[n];
  float* dst = packed + a.off[n];
  for (int i = threadIdx.x; i < nw; i += blockDim.x) {
    const int co = i % c, r = i / c;  // r = ci * K + k
    const int ci = r / K, k = r - ci * K;
    dst[i] = w[(co * c + ci) * K + k];
  }
  for (int i = threadIdx.x; i < c; i += blockDim.x) dst[nw + i] = a.b[n][i];
}

template <int C, int K>
int launch(const float* x, const float* w1, const float* b1, const float* w2,
           const float* b2, const float* sum_in, float* out, int batch, int T,
           int d, int mode, int n_blocks, cudaStream_t stream) {
  using P = Plan<C, K>;
  const int smem = P::smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      iris_mrf_layer_kernel<C, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + P::kTile - 1) / P::kTile, batch);
  iris_mrf_layer_kernel<C, K><<<grid, P::kThreads, smem, stream>>>(
      x, w1, b1, w2, b2, sum_in, out, T, d, mode, n_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define IRIS_MRF_CASES(X) \
  X(8, 3) X(8, 7) X(8, 11) X(16, 3) X(16, 7) X(16, 11) X(32, 3) X(32, 7) X(32, 11)

extern "C" {

// Packs n convs of width c (weights w[i] [c, c, k[i]], biases b[i] [c],
// device pointers) into `packed` at float offsets off[i] (multiples of 4).
int iris_mrf_pack(const void* const* w, const void* const* b, const int* k,
                  const int* off, int n, int c, void* packed, void* stream) {
  if (n < 1 || n > kMaxConvs || c < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  PackArgs a;
  for (int i = 0; i < n; ++i) {
    a.w[i] = static_cast<const float*>(w[i]);
    a.b[i] = static_cast<const float*>(b[i]);
    a.k[i] = k[i];
    a.off[i] = off[i];
  }
  iris_mrf_pack_kernel<<<n, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      a, c, static_cast<float*>(packed));
  return static_cast<int>(cudaGetLastError());
}

// One ResBlock layer on x [batch, c, t] into out; w1/b1 and w2/b2 point
// into a packed buffer. mode: kAddSum adds sum_in, kFinish multiplies by
// 1/n_blocks and applies the leaky ReLU. Launches on `stream` and does not
// synchronise; returns a cudaError_t (0 = launched).
int iris_mrf_layer(const void* x, const void* w1, const void* b1,
                   const void* w2, const void* b2, const void* sum_in,
                   void* out, int batch, int c, int t, int k, int d, int mode,
                   int n_blocks, void* stream) {
  if (batch < 1 || batch > 65535 || t < 1 || d < 1 ||
      (k - 1) * d > kMaxSpan || n_blocks < 1 ||
      ((mode & kAddSum) && sum_in == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define IRIS_MRF_LAUNCH(C, K)                                                \
  if (c == C && k == K)                                                      \
    return launch<C, K>(                                                     \
        static_cast<const float*>(x), static_cast<const float*>(w1),         \
        static_cast<const float*>(b1), static_cast<const float*>(w2),        \
        static_cast<const float*>(b2), static_cast<const float*>(sum_in),    \
        static_cast<float*>(out), batch, t, d, mode, n_blocks, s);
  IRIS_MRF_CASES(IRIS_MRF_LAUNCH)
#undef IRIS_MRF_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* iris_mrf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
