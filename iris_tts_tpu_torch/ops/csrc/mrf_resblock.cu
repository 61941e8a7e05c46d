// HiFiGAN's multi-receptive-field (MRF) residual blocks, for Hopper (sm_90a),
// IEEE f32 throughout: f32 in, FFMA accumulation in f32, f32 out. No tensor
// core, so PyTorch's TF32 switches do not reach it.
//
// Replaces no TPU kernel: the JAX package leaves HiFiGAN's convolutions to
// XLA (iris_tts_tpu/models/hifigan.py has no pallas_call). Added because
// cuDNN's f32 implicit GEMM runs these convs at about half the card's FFMA
// rate, and the chain of elementwise passes around them (two leaky ReLUs and
// a residual add a layer, the MRF sum and average) is a full pass over a
// [B, C, T] tensor each: 16% of HiFiGAN V1's vocoder time, about 30% of V2's.
//
// Every ResBlock layer is
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
// Every output sample is summed in one order, c_in outer and k inner, bias
// last, whatever the tile's start: a window of the signal gives the same
// samples as the whole signal wherever both see the same inputs
// (TTSPipeline.vocode_streaming relies on this).
//
// Two tile plans, one per range of widths; the stage's channel count picks
// one.
//
// The narrow plan (8 and 16 channels; iris_mrf_layer_kernel), one launch a
// layer. At these widths cuDNN's tiles put the output channels on one tile
// edge and leave most of each tile idle, and a layer does 2 * 2 * C * C * K
// flops a sample against 3 * 4 * C bytes of device memory (x read, x read
// again for the residual from L2, y written): at C = 8, K = 3 near the
// card's f32 balance point (20 flops a byte), so one launch a layer, with
// no intermediate trip through device memory, is what pays. On V2's stages
// at 32 rows x 742 frames (H100 SXM, 700 W) the wide plan took 4.26 ms
// against this plan's 3.48 at 8 channels, and tied at 16 (5.85 against
// 5.84), where it would need a narrower slice to keep two blocks an SM.
//
// * A block owns a tile of output samples of one row. It stages lrelu(x)
//   for all C channels over the tile plus conv2's reach ((K-1)/2 a side)
//   plus conv1's ((K-1)*d/2 a side) in shared memory, with zeros outside
//   [0, T), and conv1's packed weights [C_in][K][C_out], by cp.async copies
//   that are all in flight at once (a thread's loads one after another
//   left the tile waiting on memory latency).
// * The block is kGroups groups of 128 threads. A thread computes kSteps
//   positions strided by 128 (so a warp reads 32 consecutive floats: no
//   bank conflict) times its group's C / kGroups output channels, in
//   registers. Per (c_in, k) it reads kSteps activations and its channels'
//   weights as float4 warp broadcasts, and issues kSteps * C / kGroups
//   FFMAs. Splitting the channels puts more warps on an SM, which hid the
//   staging and the barriers better than more accumulators a thread did.
// * conv1 covers the tile plus conv2's reach. Positions outside [0, T) are
//   set to zero, not computed from padding, which is what conv2's zero
//   padding sees on the unfused path. lrelu(conv1 + bias) then overwrites
//   the staged input in shared memory while conv2's weights are copied over
//   conv1's, and conv2 runs the same loop. The epilogue adds the bias, the
//   residual (read from device memory, an L2 hit) and the MRF step, and
//   writes once. The sum order is that of cuDNN's f32 implicit GEMM at these
//   shapes: on the H100 the output has equalled the library composition's
//   bit for bit.
//
// The wide plan (32 to 256 channels; iris_mrf_wide_kernel), two launches a
// layer: conv1 with the leaky ReLU of its input in the prologue and
// lrelu(conv1 + bias) in the epilogue, into a scratch tensor; then conv2
// with the bias, the residual and the MRF step in the epilogue. Here one
// conv's weights (180 KB at C = 64, K = 11; 2.9 MB at 256) do not fit beside
// a tile, and a conv is an FFMA-bound GEMM (2 * C * K flops an output
// against 8-12 bytes of device memory), so each launch is an f32 implicit
// GEMM. At 32 channels it took V1's stage in 36.8 ms against the narrow
// plan's 41.1 (32 rows x 742 frames, H100 SXM, 700 W): the 8 x 8 register
// tile outweighed the extra trip through device memory.
//
// * A block of 256 threads owns kBM output channels (C up to 128) by kBN
//   positions of one row, kBM * kBN = 16384: each thread an 8 x 8 register
//   tile of 8 output channels by 8 consecutive positions.
// * The reduction runs over slices of kBK input channels (16 at K = 3, else
//   8). cp.async stages a slice's weights, packed [C_in][K][C_out], and its
//   input rows over the tile plus the conv's reach ((K-1)*d/2 a side, zeros
//   outside [0, T)) into one half of a double-buffered ring while the block
//   computes on the other half. conv1's launch applies the leaky ReLU in
//   place, each thread to the values it copied.
// * Per input channel a thread reads its window of the staged row, 8 +
//   (K-1)*d values, as float4s, each just before the first tap that reaches
//   it, and reuses it for all K taps (tap k reads values k*d .. k*d+7); per
//   tap it reads its 8 weights as two float4s (a broadcast over the warp)
//   and issues 64 FFMAs: at K = 11, d = 1, 704 FFMAs against 27 loads.
// * The loop over a slice's channels is unrolled twice, not whole: fully
//   unrolled, a slice's code (~100 KB at K = 11) outgrew the instruction
//   cache, and V1's 128-channel stage ran at 63.6% of its FFMA bound against
//   72.2% (32 rows x 768 frames, H100 SXM, 700 W; the card sustained 95.4%
//   of 66.9 TFLOP/s on FFMAs alone). Launches run at 60-65% (K = 3), 69-74%
//   (K = 7) and 69-76% (K = 11), the dilated ones lowest: their windows
//   take more float4s, at a two-way bank conflict.
// * The epilogue writes each output once, float4-wide where the row allows.
//   conv1's output makes one trip through device memory (written, read back
//   by conv2's staging), against five elementwise passes on the library's
//   path.
// * Shared memory: two slices of weights and input, 101.6 KB at kBM = 128,
//   K = 11, d = 5; registers: at most 128 a thread, so two blocks (16 warps)
//   fit an SM. On the H100 the sum order has given cuDNN's f32 result bit
//   for bit here too.
//
// iris_mrf_pack transposes the 2 * layers convs of a stage from torch's
// [C_out, C_in, K] into the packed [C_in][K][C_out] + bias layout, in one
// launch, so the kernels' weight loads are contiguous float4 copies.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kLanes = 128;  // positions a group of threads covers at once
constexpr int kMaxSpan = 50;  // (K - 1) * d: conv1's reach over both sides
constexpr int kMaxConvs = 64;
constexpr float kSlope = 0.1f;  // HiFiGAN's LRELU_SLOPE

// kFirst: a wide plan's conv1 launch (leaky ReLU in and out, no residual).
enum : int { kAddSum = 1, kFinish = 2, kFirst = 4 };

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

__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N groups of this thread's copies are in flight.
template <int N>
__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// ---- The wide plan ----------------------------------------------------------

constexpr int kWideThreads = 256;

template <int C, int K, int D>
struct WidePlan {
  static constexpr int kBM = C < 128 ? C : 128;  // output channels a block
  static constexpr int kBN = 16384 / kBM;         // positions a block
  static constexpr int kTN = kBN / 8;             // threads along time
  static constexpr int kBK = K == 3 ? 16 : 8;     // input channels a slice
  // A warp's threads: kWarpTN along time by 32 / kWarpTN along channels.
  static constexpr int kWarpTN = 16;
  static constexpr int kSpan = (K - 1) * D;  // the conv's reach, both sides
  // A staged row: the tile and the reach, padded to whole float4s, so that
  // thread tn's window, values tn*8 .. tn*8 + 8 + kSpan, is kChunks float4s.
  static constexpr int kRow = (kBN + kSpan + 3) / 4 * 4;
  static constexpr int kChunks = (8 + kSpan + 3) / 4;
  static constexpr int kW = kBK * K * kBM;  // a slice's weights
  static constexpr int kX = kBK * kRow;     // a slice's input rows
  static constexpr int kStage = kW + kX;    // one half of the ring
  static constexpr int kSmem = 2 * 4 * kStage;
  static constexpr int kSlices = C / kBK;
  static_assert(C % kBM == 0 && C % kBK == 0 && kBM % 8 == 0 &&
                    kTN * (kBM / 8) == kWideThreads && kTN % kWarpTN == 0 &&
                    kBM / 8 % (32 / kWarpTN) == 0,
                "an 8 x 8 tile a thread, whole warps");
  static_assert(kRow >= kBN - 8 + 4 * kChunks, "a window inside its row");
};

// One conv of a wide stage's layer on `in` [B, C, T] into `out`, by
// 8 x 8 register tiles: with kFirst, out = lrelu(conv(lrelu(in)) + bias);
// else out = resid + (conv(in) + bias), then the MRF step of `mode`.
template <int C, int K, int D>
__global__ void __launch_bounds__(kWideThreads, 2)
    iris_mrf_wide_kernel(const float* __restrict__ in,    // [B, C, T]
                         const float* __restrict__ w,     // packed [C][K][C]
                         const float* __restrict__ bias,  // [C]
                         const float* resid,   // [B, C, T]; may be `out`
                         const float* sum_in,  // [B, C, T]; may be `out`
                         float* out,           // [B, C, T]
                         int T, int mode, int n_blocks) {
  using P = WidePlan<C, K, D>;
  constexpr int NT = kWideThreads;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  constexpr int kWarpsTN = P::kTN / P::kWarpTN;
  constexpr int kWarpTM = 32 / P::kWarpTN;
  // positions tn*8 .. tn*8+7 of the tile, output channels tm*8 .. tm*8+7
  // of the block
  const int tn = warp % kWarpsTN * P::kWarpTN + lane % P::kWarpTN;
  const int tm = warp / kWarpsTN * kWarpTM + lane / P::kWarpTN;
  const int t0 = blockIdx.x * P::kBN;
  const int co0 = blockIdx.y * P::kBM;
  const size_t base = static_cast<size_t>(blockIdx.z) * C * T;
  const float* inb = in + base;
  const int xs = t0 - P::kSpan / 2;  // the time of a staged row's first value
  const bool first = mode & kFirst;

  // Slice s into half s % 2 of the ring: its weights [kBK][K][kBM] and its
  // input rows [kBK][kRow], zeros outside [0, T).
  auto stage = [&](int s) {
    float* buf = smem + (s & 1) * P::kStage;
    const float* ws = w + static_cast<size_t>(s) * P::kBK * K * C + co0;
    for (int i = tid; i < P::kW / 4; i += NT) {
      const int r = i / (P::kBM / 4), q = i % (P::kBM / 4);
      copy16(buf + 4 * i, ws + static_cast<size_t>(r) * C + 4 * q);
    }
    const float* xb = inb + static_cast<size_t>(s) * P::kBK * T;
    for (int e = tid; e < P::kX; e += NT) {
      const int ci = e / P::kRow, t = xs + e % P::kRow;
      const bool valid = t >= 0 && t < T;
      copy4(buf + P::kW + e, xb + static_cast<size_t>(ci) * T + (valid ? t : 0),
            valid);
    }
    copies_commit();
  };

  float acc[8][8];
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[c][j] = 0.f;

  stage(0);
#pragma unroll 1
  for (int s = 0; s < P::kSlices; ++s) {
    if (s + 1 < P::kSlices) {
      stage(s + 1);
      copies_wait<1>();
    } else {
      copies_wait<0>();
    }
    float* buf = smem + (s & 1) * P::kStage;
    if (first)  // each thread on the values it copied itself
      for (int e = tid; e < P::kX; e += NT)
        buf[P::kW + e] = lrelu(buf[P::kW + e]);
    __syncthreads();
    const float* sw = buf + tm * 8;
    const float* sx = buf + P::kW + tn * 8;
    // Two input channels an iteration: unrolled wider, the loop outgrows
    // the instruction cache (see the header).
#pragma unroll 2
    for (int ci = 0; ci < P::kBK; ++ci) {
      const float* row = sx + ci * P::kRow;
      float a[4 * P::kChunks];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        // The float4s of the window that tap k (values k*D .. k*D+7) is the
        // first to reach, read just before it.
#pragma unroll
        for (int m = k == 0 ? 0 : ((k - 1) * D + 7) / 4 + 1;
             m <= (k * D + 7) / 4; ++m) {
          const float4 v = *reinterpret_cast<const float4*>(row + 4 * m);
          a[4 * m + 0] = v.x;
          a[4 * m + 1] = v.y;
          a[4 * m + 2] = v.z;
          a[4 * m + 3] = v.w;
        }
        const float* wk = sw + (ci * K + k) * P::kBM;
        const float4 w0 = *reinterpret_cast<const float4*>(wk);
        const float4 w1 = *reinterpret_cast<const float4*>(wk + 4);
        const float wc[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int c = 0; c < 8; ++c)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[c][j] = fmaf(wc[c], a[j + k * D], acc[c][j]);
      }
    }
    __syncthreads();  // every thread is done with this half of the ring
  }

  const float inv_n = 1.0f / static_cast<float>(n_blocks);
  const int tq = t0 + tn * 8;  // the thread's first position
  // Two aligned float4s of each row: `out` and `sum_in` are the wrapper's
  // own tensors; `resid` may be the caller's, at any offset.
  const bool whole =
      (T & 3) == 0 && tq + 8 <= T &&
      (first || (reinterpret_cast<size_t>(resid) & 15) == 0);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int co = co0 + tm * 8 + c;
    const float b = __ldg(bias + co);
    const size_t row = base + static_cast<size_t>(co) * T;
    float y[8];
    if (first) {
#pragma unroll
      for (int j = 0; j < 8; ++j) y[j] = lrelu(acc[c][j] + b);
    } else {
      float r[8], m[8] = {};
      if (whole) {
        const float4 r0 = *reinterpret_cast<const float4*>(resid + row + tq);
        const float4 r1 =
            *reinterpret_cast<const float4*>(resid + row + tq + 4);
        r[0] = r0.x, r[1] = r0.y, r[2] = r0.z, r[3] = r0.w;
        r[4] = r1.x, r[5] = r1.y, r[6] = r1.z, r[7] = r1.w;
        if (mode & kAddSum) {
          const float4 m0 =
              *reinterpret_cast<const float4*>(sum_in + row + tq);
          const float4 m1 =
              *reinterpret_cast<const float4*>(sum_in + row + tq + 4);
          m[0] = m0.x, m[1] = m0.y, m[2] = m0.z, m[3] = m0.w;
          m[4] = m1.x, m[5] = m1.y, m[6] = m1.z, m[7] = m1.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const bool in_row = tq + j < T;
          r[j] = in_row ? resid[row + tq + j] : 0.f;
          m[j] = in_row && (mode & kAddSum) ? sum_in[row + tq + j] : 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float v = r[j] + (acc[c][j] + b);
        if (mode & kAddSum) v = m[j] + v;
        if (mode & kFinish) v = lrelu(v * inv_n);
        y[j] = v;
      }
    }
    if (whole) {
      *reinterpret_cast<float4*>(out + row + tq) =
          make_float4(y[0], y[1], y[2], y[3]);
      *reinterpret_cast<float4*>(out + row + tq + 4) =
          make_float4(y[4], y[5], y[6], y[7]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (tq + j < T) out[row + tq + j] = y[j];
    }
  }
}

#ifndef IRIS_MRF_WIDE

struct PackArgs {
  const float* w[kMaxConvs];
  const float* b[kMaxConvs];
  int k[kMaxConvs];
  int off[kMaxConvs];
};

// Blocks (n, *): conv n's [C_out, C_in, K] weight → [C_in][K][C_out] at
// off[n], its bias right after; the blocks of one conv split its weights.
__global__ void iris_mrf_pack_kernel(PackArgs a, int c, float* packed) {
  const int n = blockIdx.x;
  const int K = a.k[n];
  const int nw = c * K * c;
  const float* w = a.w[n];
  float* dst = packed + a.off[n];
  const int stride = gridDim.y * blockDim.x;
  for (int i = blockIdx.y * blockDim.x + threadIdx.x; i < nw; i += stride) {
    const int co = i % c, r = i / c;  // r = ci * K + k
    const int ci = r / K, k = r - ci * K;
    dst[i] = w[(co * c + ci) * K + k];
  }
  if (blockIdx.y == 0)
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

#else

template <int C, int K, int D>
int launch_wide(const float* in, const float* w, const float* b,
                const float* resid, const float* sum_in, float* out, int batch,
                int T, int mode, int n_blocks, cudaStream_t stream) {
  using P = WidePlan<C, K, D>;
  cudaError_t err = cudaFuncSetAttribute(
      iris_mrf_wide_kernel<C, K, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + P::kBN - 1) / P::kBN, C / P::kBM, batch);
  iris_mrf_wide_kernel<C, K, D><<<grid, kWideThreads, P::kSmem, stream>>>(
      in, w, b, resid, sum_in, out, T, mode, n_blocks);
  return static_cast<int>(cudaGetLastError());
}

#endif

}  // namespace

// The source builds as one translation unit for the narrow plan, the pack
// and the error strings, and one a width for the wide plan, with that width
// in IRIS_MRF_WIDE, so that nvcc compiles the widths side by side.
#ifndef IRIS_MRF_WIDE

#define IRIS_MRF_CASES(X) \
  X(8, 3) X(8, 7) X(8, 11) X(16, 3) X(16, 7) X(16, 11)

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
  const dim3 grid(n, c < 64 ? 1 : c / 8);
  iris_mrf_pack_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
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

#else

// The wide plan's (K, d) at this width: HiFiGAN's resblocks (kernel sizes
// 3, 7, 11, dilations 1, 3, 5); conv2 is d = 1.
#define IRIS_MRF_WIDE_K(X, K) X(K, 1) X(K, 3) X(K, 5)
#define IRIS_MRF_WIDE_CASES(X) \
  IRIS_MRF_WIDE_K(X, 3) IRIS_MRF_WIDE_K(X, 7) IRIS_MRF_WIDE_K(X, 11)
#define IRIS_MRF_PASTE_(a, b) a##b
#define IRIS_MRF_PASTE(a, b) IRIS_MRF_PASTE_(a, b)

extern "C" {

// iris_mrf_wide_<C>: one conv of a wide stage's layer (c = IRIS_MRF_WIDE)
// on in [batch, c, t] into out; w/b point into a packed buffer. mode
// kFirst: out = lrelu(conv_{k,d}(lrelu(in)) + b). Otherwise out = resid +
// (conv_{k,d}(in) + b), then kAddSum adds sum_in and kFinish multiplies by
// 1/n_blocks and applies the leaky ReLU; resid and sum_in may be out.
// Launches on `stream` and does not synchronise; returns a cudaError_t
// (0 = launched).
int IRIS_MRF_PASTE(iris_mrf_wide_, IRIS_MRF_WIDE)(
    const void* in, const void* w, const void* b, const void* resid,
    const void* sum_in, void* out, int batch, int t, int k, int d, int mode,
    int n_blocks, void* stream) {
  const bool first = mode & kFirst;
  if (batch < 1 || batch > 65535 || t < 1 || n_blocks < 1 ||
      (!first && resid == nullptr) ||
      ((mode & kAddSum) && sum_in == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define IRIS_MRF_WIDE_LAUNCH(K, D)                                          \
  if (k == K && d == D)                                                     \
    return launch_wide<IRIS_MRF_WIDE, K, D>(                                \
        static_cast<const float*>(in), static_cast<const float*>(w),        \
        static_cast<const float*>(b), static_cast<const float*>(resid),     \
        static_cast<const float*>(sum_in), static_cast<float*>(out), batch, \
        t, mode, n_blocks, s);
  IRIS_MRF_WIDE_CASES(IRIS_MRF_WIDE_LAUNCH)
#undef IRIS_MRF_WIDE_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

#endif
