// The register-tiled dilated convolution of the whole-stage HiFi-GAN MRF
// kernel (mrf_stack_streamed.cu, one launch per stage), fp32 in, fp32
// accumulation.  (mrf_stack.cu runs on the tensor cores, mrf_mma.cuh.)
//
// A block of kThreads threads computes rows of a [rows, C] output from a
// [rows + halo, C] input held in shared memory: each thread owns 8 output
// channels (tc) of RM rows spaced kTR apart (tr), and the [C, C] tap
// weights stream through a small shared buffer in chunks of kChunk input
// channels, the next chunk's loads in flight in registers while the current
// one is used.
//
// Each library includes this header from one translation unit, so its
// definitions have internal linkage.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kTaps = 11;        // stacked weights pad every kernel to 11 taps
constexpr int kMaxSmem = 232448;  // shared memory a block may use on sm_90
constexpr float kSlope = 0.1f;

__device__ __forceinline__ float lrelu(float v) { return v >= 0.f ? v : v * kSlope; }

// Geometry of one residual pair (kernel K, any dilation) at width C.
template <int C, int K>
struct Shape {
  static_assert(C % 32 == 0 && C <= 256, "C must be 32, 64, 128 or 256");
  static constexpr int kCN = 8;                 // output channels per thread
  static constexpr int kTC = C / kCN;           // threads across channels
  static constexpr int kTR = kThreads / kTC;    // threads across frames
  static constexpr int kTile = 8 * kTR;         // output frames per pass
  static constexpr int kHalf = K / 2;
  static constexpr int kRM1 = 8 + (2 * kHalf + kTR - 1) / kTR;   // conv1 rows per thread
  static constexpr int kMid = kRM1 * kTR;       // conv1 rows per pass, >= kTile + 2 kHalf
  static constexpr int kLd = kTC < 32 ? C + 4 : C;   // row stride: a warp spanning
                                                     // several rows reads distinct banks
  static constexpr int kChunk = C >= 256 ? 8 : 16;   // weight rows staged at once
  // shared memory of one pass at dilation dil: the lrelu'd input window,
  // the conv1 output and the staged weights
  static size_t bytes(int dil) {
    return sizeof(float) * ((size_t)(2 * kMid + 2 * kHalf * dil) * kLd + kChunk * C);
  }
};

// acc[i][n] += sum over taps and input channels of
//   s_a[(tr + kTR*i + tap*dil) * kLd + ci] * w[tap][ci][tc*8 + n]
// w is [K, C, C] (input channel, output channel); chunk q of kChunk rows is
// contiguous at w + q * kChunk * C.
template <int C, int K, int RM>
__device__ __forceinline__ void conv_rows(float (&acc)[RM][8], const float* s_a,
                                          const float* __restrict__ w, float* s_w,
                                          int dil, int tr, int tc) {
  using S = Shape<C, K>;
  constexpr int kChunk4 = S::kChunk * C / 4;
  constexpr int kLoads = (kChunk4 + kThreads - 1) / kThreads;
  constexpr int kPerTap = C / S::kChunk;
  constexpr int kChunks = K * kPerTap;
  const int tid = threadIdx.x;
  const float4* w4 = reinterpret_cast<const float4*>(w);
  float4* s_w4 = reinterpret_cast<float4*>(s_w);
  float4 pre[kLoads];
  auto load = [&](int q) {
#pragma unroll
    for (int m = 0; m < kLoads; ++m) {
      const int i = tid + m * kThreads;
      if (i < kChunk4) pre[m] = __ldg(w4 + (size_t)q * kChunk4 + i);
    }
  };
  load(0);
  for (int q = 0; q < kChunks; ++q) {
    __syncthreads();
#pragma unroll
    for (int m = 0; m < kLoads; ++m) {
      const int i = tid + m * kThreads;
      if (i < kChunk4) s_w4[i] = pre[m];
    }
    __syncthreads();
    if (q + 1 < kChunks) load(q + 1);
    const int tap = q / kPerTap, ci0 = (q % kPerTap) * S::kChunk;
    const float* a0 = s_a + (tr + tap * dil) * S::kLd + ci0;
#pragma unroll
    for (int kk = 0; kk < S::kChunk; ++kk) {
      const float4 wl = *reinterpret_cast<const float4*>(s_w + kk * C + tc * 8);
      const float4 wh = *reinterpret_cast<const float4*>(s_w + kk * C + tc * 8 + 4);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float a = a0[i * S::kTR * S::kLd + kk];
        acc[i][0] = fmaf(a, wl.x, acc[i][0]);
        acc[i][1] = fmaf(a, wl.y, acc[i][1]);
        acc[i][2] = fmaf(a, wl.z, acc[i][2]);
        acc[i][3] = fmaf(a, wl.w, acc[i][3]);
        acc[i][4] = fmaf(a, wh.x, acc[i][4]);
        acc[i][5] = fmaf(a, wh.y, acc[i][5]);
        acc[i][6] = fmaf(a, wh.z, acc[i][6]);
        acc[i][7] = fmaf(a, wh.w, acc[i][7]);
      }
    }
  }
}

// One residual pair over output frames [u, u + kTile) of one batch row:
//   out = [out +] (y + conv2(lrelu(conv1(lrelu(y))))) [* scale]
// y and out are [T, C] signals held from frames y0 and out0 on (frame f of
// y at y + (f - y0) * C).  Frames outside [0, T) are zeroed before each conv
// (SAME padding) and never written.  kReadOnly reads y through the
// non-coherent cache, which is right only while nothing writes y during
// the launch.  smem holds Shape<C, K>::bytes(dil) bytes; the pass begins
// with a barrier, so passes may follow each other in one block.
template <int C, int K, bool kReadOnly>
__device__ __forceinline__ void pair_pass(const float* y, int y0, float* out, int out0,
                                          const float* __restrict__ w1,
                                          const float* __restrict__ b1,
                                          const float* __restrict__ w2,
                                          const float* __restrict__ b2, int u, int T,
                                          int dil, int accumulate, float scale,
                                          float* smem) {
  using S = Shape<C, K>;
  const int halo = S::kHalf * dil;
  const int rows_in = S::kMid + 2 * halo;
  float* s_in = smem;                              // lrelu(y), [rows_in][kLd]
  float* s_mid = s_in + rows_in * S::kLd;          // conv1 output, [kMid][kLd]
  float* s_w = s_mid + S::kMid * S::kLd;           // staged weights, [kChunk][C]
  const int tid = threadIdx.x, tr = tid / S::kTC, tc = tid % S::kTC;
  auto load_y = [&](int t, int c) {
    const float4* p = reinterpret_cast<const float4*>(y + (size_t)(t - y0) * C + c);
    return kReadOnly ? __ldg(p) : *p;
  };
  __syncthreads();

  // s_in row j holds frame u - kHalf - halo + j
  const int in0 = u - S::kHalf - halo;
  for (int i = tid; i < rows_in * (C / 4); i += kThreads) {
    const int r = i / (C / 4), c = (i % (C / 4)) * 4;
    const int t = in0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t >= 0 && t < T) {
      v = load_y(t, c);
      v = make_float4(lrelu(v.x), lrelu(v.y), lrelu(v.z), lrelu(v.w));
    }
    *reinterpret_cast<float4*>(s_in + r * S::kLd + c) = v;
  }

  // conv1 (dilated): s_mid row r holds frame u - kHalf + r
  {
    float acc[S::kRM1][8] = {};
    conv_rows<C, K, S::kRM1>(acc, s_in, w1, s_w, dil, tr, tc);
    float bias[8];
#pragma unroll
    for (int n = 0; n < 8; ++n) bias[n] = b1[tc * 8 + n];
#pragma unroll
    for (int i = 0; i < S::kRM1; ++i) {
      const int r = tr + S::kTR * i;
      const int t = u - S::kHalf + r;
      const bool inside = t >= 0 && t < T;
      float v[8];
#pragma unroll
      for (int n = 0; n < 8; ++n) v[n] = inside ? lrelu(acc[i][n] + bias[n]) : 0.f;
      float* dst = s_mid + r * S::kLd + tc * 8;
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
    }
  }

  // conv2, bias, residual, and the branch sum
  {
    float acc[8][8] = {};
    conv_rows<C, K, 8>(acc, s_mid, w2, s_w, 1, tr, tc);
    float bias[8];
#pragma unroll
    for (int n = 0; n < 8; ++n) bias[n] = b2[tc * 8 + n];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = u + tr + S::kTR * i;
      if (t < 0 || t >= T) continue;
      const float4 rl = load_y(t, tc * 8);
      const float4 rh = load_y(t, tc * 8 + 4);
      float v[8] = {rl.x, rl.y, rl.z, rl.w, rh.x, rh.y, rh.z, rh.w};
#pragma unroll
      for (int n = 0; n < 8; ++n) v[n] += acc[i][n] + bias[n];
      float* o = out + (size_t)(t - out0) * C + tc * 8;
      if (accumulate) {
        const float4 ol = *reinterpret_cast<const float4*>(o);
        const float4 oh = *reinterpret_cast<const float4*>(o + 4);
        v[0] = ol.x + v[0]; v[1] = ol.y + v[1]; v[2] = ol.z + v[2]; v[3] = ol.w + v[3];
        v[4] = oh.x + v[4]; v[5] = oh.y + v[5]; v[6] = oh.z + v[6]; v[7] = oh.w + v[7];
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) v[n] *= scale;
      *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(o + 4) = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
}

}  // namespace
