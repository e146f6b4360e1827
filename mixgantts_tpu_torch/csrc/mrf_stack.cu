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
// zeroed before each conv, which is SAME padding exactly.  The pass itself
// (pair_pass, conv_rows) lives in mrf_conv.cuh, which the whole-stage
// kernel mrf_stack_streamed.cu shares.

#include "mrf_conv.cuh"

namespace {

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
  extern __shared__ float4 smem4[];
  const size_t base = (size_t)blockIdx.y * T * C;
  pair_pass<C, K, true>(y + base, 0, out + base, 0, w1, b1, w2, b2,
                        blockIdx.x * Shape<C, K>::kTile, T, dil, accumulate, scale,
                        reinterpret_cast<float*>(smem4));
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
