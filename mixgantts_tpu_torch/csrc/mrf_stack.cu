// HiFi-GAN's multi-receptive-field (MRF) stage, written by hand for Hopper
// (sm_90a), fp32 in, fp32 accumulation, fp32 out.
//
// Replaces the Pallas TPU kernels mixgantts_tpu/ops/pallas_vocoder.py::
// mrf_stack and ::mrf_stack_folded (the folding into 128 lanes serves the
// TPU's lane width; the folded layout holds the same bytes as [B, T, C], so
// both Python entry points in mixgantts_tpu_torch/ops/mrf.py launch this
// kernel on a [B, T, C] view).
//
// One stage, x [B, T, C]: for each branch (kernel k = 3, 7, 11), three
// residual pairs (dilation d = 1, 3, 5)
//   y = y + conv_k(lrelu(conv_{k,d}(lrelu(y)) + b1)) + b2      (lrelu 0.1)
// with zero ("SAME") padding at both ends of [0, T); the stage output is the
// mean of the branch outputs.
//
// What bounds it on an H100: a stage does 252 C^2 FLOP per frame, and a
// request at T_mel = 1000 runs four stages (C = 256, 128, 64, 32 at 8, 64,
// 128 and 256 frames per mel frame): ~594 GFLOP, ~8.9 ms at 67 TFLOP/s of
// fp32 on the CUDA cores, against ~0.1 GB of signal traffic (~30 us at
// 3.35 TB/s).  It is bound by operations.
//
// Design: one launch per (branch, pair).  A block owns a tile of frames of
// one batch row and all C channels.  It keeps lrelu(y) for the tile plus the
// pair's halo (k/2 * (d + 1) frames each side) in shared memory, computes
// the dilated conv for the tile plus the second conv's halo into a second
// shared buffer (the intermediate never reaches device memory), then the
// second conv, the bias and the residual add, and writes the tile.  The
// last pair of each branch adds into the stage output and the last branch
// scales by 1 / n_branches.  Both convs are register-tiled products: each
// thread owns 8 output channels of 8 or more frames, and the [C, C] tap
// weights stream through a small shared buffer in chunks whose loads are in
// flight while the previous chunk is used.  Frames outside [0, T) are
// zeroed before each conv, which is SAME padding exactly.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kTaps = 11;        // stacked weights pad every kernel to 11 taps
constexpr int kMaxSmem = 232448;  // shared memory a block may use on sm_90
constexpr float kSlope = 0.1f;

__device__ __forceinline__ float lrelu(float v) { return v >= 0.f ? v : v * kSlope; }

template <int C, int K>
struct Shape {
  static_assert(C % 32 == 0 && C <= 256, "C must be 32, 64, 128 or 256");
  static constexpr int kCN = 8;                 // output channels per thread
  static constexpr int kTC = C / kCN;           // threads across channels
  static constexpr int kTR = kThreads / kTC;    // threads across frames
  static constexpr int kTile = 8 * kTR;         // output frames per block
  static constexpr int kHalf = K / 2;
  static constexpr int kRM1 = 8 + (2 * kHalf + kTR - 1) / kTR;   // conv1 rows per thread
  static constexpr int kMid = kRM1 * kTR;       // conv1 rows per block, >= kTile + 2 kHalf
  static constexpr int kLd = kTC < 32 ? C + 4 : C;   // row stride: a warp spanning
                                                     // several rows reads distinct banks
  static constexpr int kChunk = C >= 256 ? 8 : 16;   // weight rows staged at once
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

// One residual pair: out = [out +] (y + conv2(lrelu(conv1(lrelu(y))))) [* scale]
template <int C, int K>
__global__ void __launch_bounds__(kThreads, 1)
mrf_pair(const float* __restrict__ y,    // [B, T, C] pair input
         float* __restrict__ out,        // [B, T, C]
         const float* __restrict__ w1,   // [K, C, C], dilated
         const float* __restrict__ b1,   // [C]
         const float* __restrict__ w2,   // [K, C, C]
         const float* __restrict__ b2,   // [C]
         int T, int dil, int accumulate, float scale) {
  using S = Shape<C, K>;
  extern __shared__ float4 smem4[];
  const int halo = S::kHalf * dil;
  const int rows_in = S::kMid + 2 * halo;
  float* s_in = reinterpret_cast<float*>(smem4);   // lrelu(y), [rows_in][kLd]
  float* s_mid = s_in + rows_in * S::kLd;          // conv1 output, [kMid][kLd]
  float* s_w = s_mid + S::kMid * S::kLd;           // staged weights, [kChunk][C]

  const int tid = threadIdx.x, tr = tid / S::kTC, tc = tid % S::kTC;
  const int t0 = blockIdx.x * S::kTile;
  const size_t base = (size_t)blockIdx.y * T * C;
  const float* yb = y + base;

  // s_in row j holds frame t0 - kHalf - halo + j
  const int in0 = t0 - S::kHalf - halo;
  for (int i = tid; i < rows_in * (C / 4); i += kThreads) {
    const int r = i / (C / 4), c = (i % (C / 4)) * 4;
    const int t = in0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t >= 0 && t < T) {
      v = __ldg(reinterpret_cast<const float4*>(yb + (size_t)t * C + c));
      v = make_float4(lrelu(v.x), lrelu(v.y), lrelu(v.z), lrelu(v.w));
    }
    *reinterpret_cast<float4*>(s_in + r * S::kLd + c) = v;
  }

  // conv1 (dilated): s_mid row r holds frame t0 - kHalf + r
  {
    float acc[S::kRM1][8] = {};
    conv_rows<C, K, S::kRM1>(acc, s_in, w1, s_w, dil, tr, tc);
    float bias[8];
#pragma unroll
    for (int n = 0; n < 8; ++n) bias[n] = b1[tc * 8 + n];
#pragma unroll
    for (int i = 0; i < S::kRM1; ++i) {
      const int r = tr + S::kTR * i;
      const int t = t0 - S::kHalf + r;
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
      const int t = t0 + tr + S::kTR * i;
      if (t >= T) continue;
      const size_t off = base + (size_t)t * C + tc * 8;
      const float4 rl = __ldg(reinterpret_cast<const float4*>(y + off));
      const float4 rh = __ldg(reinterpret_cast<const float4*>(y + off + 4));
      float v[8] = {rl.x, rl.y, rl.z, rl.w, rh.x, rh.y, rh.z, rh.w};
#pragma unroll
      for (int n = 0; n < 8; ++n) v[n] += acc[i][n] + bias[n];
      if (accumulate) {
        const float4 ol = *reinterpret_cast<const float4*>(out + off);
        const float4 oh = *reinterpret_cast<const float4*>(out + off + 4);
        v[0] = ol.x + v[0]; v[1] = ol.y + v[1]; v[2] = ol.z + v[2]; v[3] = ol.w + v[3];
        v[4] = oh.x + v[4]; v[5] = oh.y + v[5]; v[6] = oh.z + v[6]; v[7] = oh.w + v[7];
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) v[n] *= scale;
      *reinterpret_cast<float4*>(out + off) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(out + off + 4) = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
}

template <int C, int K>
int launch_pair(const float* y, float* out, const float* w1, const float* b1,
                const float* w2, const float* b2, int B, int T, int dil,
                int accumulate, float scale, cudaStream_t stream) {
  using S = Shape<C, K>;
  const size_t smem = S::bytes(dil);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mrf_pair<C, K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + S::kTile - 1) / S::kTile, B);
  mrf_pair<C, K><<<grid, kThreads, smem, stream>>>(y, out, w1, b1, w2, b2, T, dil,
                                                   accumulate, scale);
  return (int)cudaGetLastError();
}

template <int C>
int launch_pair_k(int k, const float* y, float* out, const float* w1, const float* b1,
                  const float* w2, const float* b2, int B, int T, int dil,
                  int accumulate, float scale, cudaStream_t stream) {
  switch (k) {
    case 3:
      return launch_pair<C, 3>(y, out, w1, b1, w2, b2, B, T, dil, accumulate, scale, stream);
    case 7:
      return launch_pair<C, 7>(y, out, w1, b1, w2, b2, B, T, dil, accumulate, scale, stream);
    case 11:
      return launch_pair<C, 11>(y, out, w1, b1, w2, b2, B, T, dil, accumulate, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x, out [B, T, C]; buf0, buf1 [B, T, C] scratch; w1, w2 [n_br, n_pair, 11,
// C, C] (taps centred in the 11, input channel, output channel); b1, b2
// [n_br, n_pair, C]; kernel_sizes [n_br] and dilations [n_pair] are host
// arrays.  Launches n_br * n_pair kernels on `stream` and returns the first
// CUDA error, or 0.
int mrf_stack_f32(const float* x, float* out, float* buf0, float* buf1,
                  const float* w1, const float* b1, const float* w2, const float* b2,
                  int B, int T, int C, int n_br, int n_pair,
                  const int* kernel_sizes, const int* dilations, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* bufs[2] = {buf0, buf1};
  for (int br = 0; br < n_br; ++br) {
    const int k = kernel_sizes[br];
    const int pad = (kTaps - k) / 2;
    for (int p = 0; p < n_pair; ++p) {
      const bool last = p == n_pair - 1;
      const float* src = p == 0 ? x : bufs[(p - 1) % 2];
      float* dst = last ? out : bufs[p % 2];
      const int accumulate = last && br > 0;
      const float scale = (last && br == n_br - 1) ? 1.f / (float)n_br : 1.f;
      const size_t pair = (size_t)br * n_pair + p;
      const float* w1p = w1 + (pair * kTaps + pad) * C * C;
      const float* w2p = w2 + (pair * kTaps + pad) * C * C;
      int err;
      switch (C) {
        case 32:
          err = launch_pair_k<32>(k, src, dst, w1p, b1 + pair * C, w2p, b2 + pair * C,
                                  B, T, dilations[p], accumulate, scale, s);
          break;
        case 64:
          err = launch_pair_k<64>(k, src, dst, w1p, b1 + pair * C, w2p, b2 + pair * C,
                                  B, T, dilations[p], accumulate, scale, s);
          break;
        case 128:
          err = launch_pair_k<128>(k, src, dst, w1p, b1 + pair * C, w2p, b2 + pair * C,
                                   B, T, dilations[p], accumulate, scale, s);
          break;
        case 256:
          err = launch_pair_k<256>(k, src, dst, w1p, b1 + pair * C, w2p, b2 + pair * C,
                                   B, T, dilations[p], accumulate, scale, s);
          break;
        default:
          err = (int)cudaErrorInvalidValue;
      }
      if (err != 0) return err;
    }
  }
  return 0;
}

// Dynamic shared memory a block uses for one pair at width C, kernel size
// k and dilation dil, or -1 for a width or kernel size it is not built for.
int mrf_stack_smem_bytes(int C, int k, int dil) {
#define MRF_SMEM(CC)                                   \
  case CC:                                             \
    switch (k) {                                       \
      case 3: return (int)Shape<CC, 3>::bytes(dil);    \
      case 7: return (int)Shape<CC, 7>::bytes(dil);    \
      case 11: return (int)Shape<CC, 11>::bytes(dil);  \
      default: return -1;                              \
    }
  switch (C) {
    MRF_SMEM(32)
    MRF_SMEM(64)
    MRF_SMEM(128)
    MRF_SMEM(256)
    default:
      return -1;
  }
#undef MRF_SMEM
}

const char* mrf_stack_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
