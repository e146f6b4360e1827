// HiFi-GAN's multi-receptive-field (MRF) stage, written by hand for Hopper
// (sm_90a) on the tensor cores: bf16 operands, fp32 accumulation, fp32
// residual state.
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
// mean of the branch outputs.  The rounding points are the TPU kernel's
// (pallas_vocoder.py::_kernel, op_dtype = the weights' bf16): the stage input
// is rounded to bf16 (the TPU rounds its x tiles), each conv input
// lrelu(.) * mask is rounded to bf16, the products accumulate in fp32, and
// the biases, the residual y and the branch sum stay fp32.
//
// What bounds it on an H100: a stage does 252 C^2 FLOP per frame; a request
// at T_mel = 1000 runs four stages (C = 256, 128, 64, 32 at 8, 64, 128 and
// 256 frames per mel frame), 594 GFLOP, 0.60 ms at 989 TFLOP/s of bf16.  The
// signal moves through device memory between pairs: each launch reads y and
// writes fp32, 2 * 4 B * T * C per launch (plus the branch sum), which at
// C = 32 and 64 is as much time at 3.35 TB/s as the stage's FLOPs at the
// tensor-core peak.
//
// Design (mrf_mma.cuh holds the pass):
// - One launch per (branch, pair): a block owns kM2 output frames of one
//   batch row and all C channels.  Frames outside [0, T) are zeroed before
//   each conv, which is SAME padding exactly.
// - Both convs are implicit GEMMs on wgmma (m64nCk16): M = kRows = 64 MT WG
//   tile rows, N = C, K = taps x C.  conv1 computes the output tile plus
//   conv2's halo of k/2 frames each side, so its M is a whole number of
//   64-row wgmma tiles and kM2 = kRows - 2 (k/2) output frames; conv2
//   computes the same kRows rows and keeps the first kM2.
// - The bf16 activation tile (kRows + 2 (k/2) d rows, 16-byte padded rows)
//   is the A operand through ldmatrix: a tap is a row offset.  conv1's
//   epilogue bf16(lrelu(acc + b1) * mask) overwrites the same tile in
//   shared memory (it never reaches device memory).
// - The weights stream through a ring of S stages of KCH K rows each,
//   filled by one producer warp with cp.async.bulk (the weights were laid
//   out at stacking time in wgmma's order), so the next chunk's copy
//   overlaps the current chunk's wgmmas.
// - The two memory phases are bound by load latency, not bandwidth: the
//   tile's loads and the epilogue's loads run kBatch deep per thread, and
//   conv2's acc + b2 goes through shared memory (over the ring and the tile,
//   free by then) so that the residual, the branch sum and the fp32 store
//   are one coalesced float4 pass.
// - Per width (Cfg below; chosen by timing variants on the card, with no
//   register spills): a block of 9 warps gets at most 168 registers a
//   thread, so at C = 256 (a warpgroup's m64n256 accumulator is 128 of them)
//   a block holds 2 warpgroups x 64 rows and one block fits an SM (B = 1,
//   T = 8000 then fills only 64-68 of the 132 SMs).  At C <= 128 a block
//   holds one warpgroup (64 rows at C = 128, 128 at C = 64 and 32) and two
//   or three share an SM (shared memory permitting), so one's memory phases
//   overlap the others' wgmmas; at C = 128 and 64 four fragment buffers keep
//   three wgmma groups in flight, which the short n128 and n64 steps need.

#include "mrf_mma.cuh"

namespace {

constexpr int kTapsMax = 11;  // stacked weights reserve 11 taps per pair

// Per width: WG consumer warpgroups of MT 64-row tiles each, KCH K rows
// per ring stage, S stages, NB fragment buffers, and the blocks an SM must
// hold at once (which caps registers: an SM sub-partition's 16384 shared by
// the warps it gets).
template <int C>
struct Cfg;
template <>
struct Cfg<256> {
  static constexpr int kWG = 2, kMT = 1, kKCH = 32, kS = 4, kNB = 2, kMinBlocks = 1;
};
template <>
struct Cfg<128> {
  static constexpr int kWG = 1, kMT = 1, kKCH = 64, kS = 3, kNB = 4, kMinBlocks = 3;
};
template <>
struct Cfg<64> {
  static constexpr int kWG = 1, kMT = 2, kKCH = 64, kS = 4, kNB = 4, kMinBlocks = 3;
};
template <>
struct Cfg<32> {
  static constexpr int kWG = 1, kMT = 2, kKCH = 64, kS = 4, kNB = 2, kMinBlocks = 3;
};

template <int C, int K>
struct Pair {
  using G = Cfg<C>;
  using P = MmaPass<C, G::kMT, G::kKCH, G::kS, G::kWG>;
  static constexpr int kHalf = K / 2;
  static constexpr int kM2 = P::kRows - 2 * kHalf;              // output frames per block
  static constexpr int kQ = (K * C + G::kKCH - 1) / G::kKCH;    // ring chunks per conv
  static constexpr int kBarBytes = 128;                         // full[S], empty[S]
  static constexpr int kLdO = C + 4;                            // fp32 per staged output row
  static size_t bytes(int dil) {
    return kBarBytes + P::kRingBytes + (size_t)(P::kRows + 2 * kHalf * dil) * P::kLd * 2;
  }
  static_assert(kM2 * kLdO * 4 <= P::kRingBytes + (P::kRows + 2 * kHalf) * P::kLd * 2,
                "conv2's output tile must fit over the ring and the input tile");
};

constexpr int kBatch = 8;   // global loads in flight per thread in the memory phases

// The consumer warpgroups' part of one residual pair (see mrf_pair_mma).
template <int C, int K>
__device__ __forceinline__ void pair_consumers(const float* __restrict__ yb,
                                               float* __restrict__ ob,
                                               const float* __restrict__ b1,
                                               const float* __restrict__ b2,
                                               unsigned char* tile, uint32_t ring,
                                               uint32_t full, uint32_t empty, int u, int T,
                                               int dil, int round_in, int accumulate,
                                               int divide) {
  using Q = Pair<C, K>;
  using G = typename Q::G;
  using P = typename Q::P;
  constexpr int MT = G::kMT;
  const int tid = threadIdx.x;

  // the input tile: row r holds bf16(lrelu(y)) of frame u - k/2 - k/2 dil + r;
  // kBatch loads in flight per thread (the phase is bound by load latency)
  const int rows_in = P::kRows + 2 * Q::kHalf * dil;
  const int t_in = u - Q::kHalf - Q::kHalf * dil;
  constexpr int kN4 = C / 4;
  for (int i0 = tid; i0 < rows_in * kN4; i0 += kBatch * P::kConsumers) {
    float4 v[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * P::kConsumers, t = t_in + i / kN4;
      v[b] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < rows_in * kN4 && t >= 0 && t < T)
        v[b] = __ldg(reinterpret_cast<const float4*>(yb + (size_t)t * C + (i % kN4) * 4));
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * P::kConsumers;
      if (i >= rows_in * kN4) break;
      float4 w = v[b];
      if (round_in) w = make_float4(round_bf16(w.x), round_bf16(w.y), round_bf16(w.z),
                                    round_bf16(w.w));
      *reinterpret_cast<uint2*>(tile + 2 * ((i / kN4) * P::kLd + (i % kN4) * 4)) =
          make_uint2(pack_bf16(lrelu_f(w.x), lrelu_f(w.y)), pack_bf16(lrelu_f(w.z), lrelu_f(w.w)));
    }
  }
  consumer_sync<P::kConsumers>();

  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const bool leader = tid % 128 == 0;
  const uint32_t row_bytes = 2 * P::kLd;
  const uint32_t a_lane =
      smem_addr(tile) + 2 * ((wg * MT * 64 + warp * 16 + (lane & 15)) * P::kLd + (lane >> 4) * 8);
  const int row0 = wg * MT * 64 + warp * 16 + (lane >> 2);   // + 64 mt + 8 h
  const int col0 = 2 * (lane & 3);                            // + 8 g
  float acc[MT][C / 2];

  // conv1 (dilated); its output, tile row r = frame u - k/2 + r, replaces
  // the input tile once every warp is done reading it
  conv_mma<C, K, MT, G::kKCH, G::kS, G::kNB, G::kWG>(acc, a_lane, row_bytes, dil, ring,
                                                       full, empty, 0, leader);
  consumer_sync<P::kConsumers>();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int g = 0; g < C / 8; ++g) {
      const int n = 8 * g + col0;
      const float2 bias = __ldg(reinterpret_cast<const float2*>(b1 + n));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + 64 * mt + 8 * h;
        const int f = u - Q::kHalf + r;
        const bool inside = f >= 0 && f < T;
        const float v0 = inside ? lrelu_f(acc[mt][4 * g + 2 * h] + bias.x) : 0.f;
        const float v1 = inside ? lrelu_f(acc[mt][4 * g + 2 * h + 1] + bias.y) : 0.f;
        *reinterpret_cast<uint32_t*>(tile + 2 * (r * P::kLd + n)) = pack_bf16(v0, v1);
      }
    }
  consumer_sync<P::kConsumers>();

  // conv2; output row r = frame u + r, kept for r < kM2.  acc + b2 goes to
  // shared memory (fp32, over the ring and the tile, which nothing reads any
  // more), then one coalesced pass adds the residual and the branch sum with
  // kBatch loads in flight per thread.
  conv_mma<C, K, MT, G::kKCH, G::kS, G::kNB, G::kWG>(acc, a_lane, row_bytes, 1, ring,
                                                       full, empty, Q::kQ, leader);
  consumer_sync<P::kConsumers>();
  float* staged = reinterpret_cast<float*>(tile - P::kRingBytes);   // [kM2][kLdO]
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int g = 0; g < C / 8; ++g) {
      const int n = 8 * g + col0;
      const float2 bias = __ldg(reinterpret_cast<const float2*>(b2 + n));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + 64 * mt + 8 * h;
        if (r < Q::kM2)
          *reinterpret_cast<float2*>(staged + r * Q::kLdO + n) =
              make_float2(acc[mt][4 * g + 2 * h] + bias.x, acc[mt][4 * g + 2 * h + 1] + bias.y);
      }
    }
  consumer_sync<P::kConsumers>();
  const int n_out = min(Q::kM2, T - u) * kN4;
  for (int i0 = tid; i0 < n_out; i0 += kBatch * P::kConsumers) {
    float4 res[kBatch], prev[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * P::kConsumers;
      const size_t at = (size_t)(u + i / kN4) * C + (i % kN4) * 4;
      if (i < n_out) {
        res[b] = __ldg(reinterpret_cast<const float4*>(yb + at));
        if (accumulate) prev[b] = *reinterpret_cast<const float4*>(ob + at);
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * P::kConsumers;
      if (i >= n_out) break;
      const float4 a = *reinterpret_cast<const float4*>(staged + (i / kN4) * Q::kLdO + (i % kN4) * 4);
      float4 r = res[b];
      if (round_in) r = make_float4(round_bf16(r.x), round_bf16(r.y), round_bf16(r.z),
                                    round_bf16(r.w));
      float v[4] = {r.x + a.x, r.y + a.y, r.z + a.z, r.w + a.w};
      if (accumulate) {
        v[0] = prev[b].x + v[0];
        v[1] = prev[b].y + v[1];
        v[2] = prev[b].z + v[2];
        v[3] = prev[b].w + v[3];
      }
      if (divide) {
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = v[j] / (float)divide;
      }
      *reinterpret_cast<float4*>(ob + (size_t)(u + i / kN4) * C + (i % kN4) * 4) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// One residual pair: out = [out +] (y + conv2(lrelu(conv1(lrelu(y))))) [/ divide]
// y is rounded to bf16 on load where round_in is set (the stage input).
// The consumer warpgroups compute; one producer warp streams the weights.
template <int C, int K>
__global__ void __launch_bounds__(Pair<C, K>::P::kThreads, Cfg<C>::kMinBlocks)
mrf_pair_mma(const float* __restrict__ y,            // [B, T, C] pair input
             float* __restrict__ out,                // [B, T, C]
             const __nv_bfloat16* __restrict__ w1,   // K taps, wgmma order (dilated)
             const float* __restrict__ b1,           // [C]
             const __nv_bfloat16* __restrict__ w2,   // K taps, wgmma order
             const float* __restrict__ b2,           // [C]
             int T, int dil, int round_in, int accumulate, int divide) {
  using Q = Pair<C, K>;
  using G = typename Q::G;
  using P = typename Q::P;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t full = smem_addr(smem), empty = full + 8 * G::kS;
  const uint32_t ring = full + Q::kBarBytes;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < G::kS; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, P::kWG);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= P::kConsumers) {  // the producer warp: conv1's chunks, then conv2's
    if (tid == P::kConsumers) {
      produce<G::kS>(
          2 * Q::kQ, ring, P::kStageBytes, full, empty,
          [&](int q) {
            return (q < Q::kQ ? w1 : w2) + (size_t)(q % Q::kQ) * G::kKCH * C;
          },
          [&](int q) {
            const int rows = min(G::kKCH, K * C - (q % Q::kQ) * G::kKCH);
            return (uint32_t)(rows * C * 2);
          });
    }
  } else {
    const size_t row = (size_t)blockIdx.y * T * C;
    pair_consumers<C, K>(y + row, out + row, b1, b2, smem + Q::kBarBytes + P::kRingBytes, ring,
                         full, empty, blockIdx.x * Q::kM2, T, dil, round_in, accumulate,
                         divide);
  }
}

template <int C, int K>
struct Launch {
  static int get(const float* y, float* out, const __nv_bfloat16* w1, const float* b1,
                 const __nv_bfloat16* w2, const float* b2, int B, int T, int dil, int round_in,
                 int accumulate, int divide, cudaStream_t stream) {
    using Q = Pair<C, K>;
    const size_t smem = Q::bytes(dil);
    cudaError_t err = cudaFuncSetAttribute(
        mrf_pair_mma<C, K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((T + Q::kM2 - 1) / Q::kM2, B);
    mrf_pair_mma<C, K><<<grid, Q::P::kThreads, smem, stream>>>(y, out, w1, b1, w2, b2, T, dil,
                                                               round_in, accumulate, divide);
    return (int)cudaGetLastError();
  }
};

template <int C, int K>
struct SmemBytes {
  static int get(int dil) { return (int)Pair<C, K>::bytes(dil); }
};

template <int C, int K>
struct TileFrames {
  static int get() { return Pair<C, K>::kM2; }
};

// F<C, k>::get(args...) for a width and kernel size the library is built
// for, else `fallback`.
template <template <int, int> class F, class R, class... A>
R by_width_and_k(int C, int k, R fallback, A... args) {
  auto pick = [&](auto c) -> R {
    constexpr int CC = decltype(c)::value;
    switch (k) {
      case 3: return F<CC, 3>::get(args...);
      case 7: return F<CC, 7>::get(args...);
      case 11: return F<CC, 11>::get(args...);
      default: return fallback;
    }
  };
  switch (C) {
    case 32: return pick(std::integral_constant<int, 32>());
    case 64: return pick(std::integral_constant<int, 64>());
    case 128: return pick(std::integral_constant<int, 128>());
    case 256: return pick(std::integral_constant<int, 256>());
    default: return fallback;
  }
}

}  // namespace

extern "C" {

// x, out [B, T, C] fp32; buf0, buf1 [B, T, C] fp32 scratch; w1, w2 [n_br,
// n_pair, 11 C C] bf16, each (branch, pair) holding its k real taps first in
// wgmma order (ops/mrf.py::kernel_weights); b1, b2 [n_br, n_pair, C] fp32;
// kernel_sizes [n_br] and dilations [n_pair] are host arrays.  Launches
// n_br * n_pair kernels on `stream` and returns the first CUDA error, or 0.
int mrf_stack_bf16(const float* x, float* out, float* buf0, float* buf1,
                   const __nv_bfloat16* w1, const float* b1, const __nv_bfloat16* w2,
                   const float* b2, int B, int T, int C, int n_br, int n_pair,
                   const int* kernel_sizes, const int* dilations, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* bufs[2] = {buf0, buf1};
  for (int br = 0; br < n_br; ++br) {
    const int k = kernel_sizes[br];
    for (int p = 0; p < n_pair; ++p) {
      const bool last = p == n_pair - 1;
      const float* src = p == 0 ? x : bufs[(p - 1) % 2];
      float* dst = last ? out : bufs[p % 2];
      const int accumulate = last && br > 0;
      const int divide = (last && br == n_br - 1) ? n_br : 0;
      const size_t pair = (size_t)br * n_pair + p;
      const __nv_bfloat16* w1p = w1 + pair * kTapsMax * C * C;
      const __nv_bfloat16* w2p = w2 + pair * kTapsMax * C * C;
      const int err = by_width_and_k<Launch, int>(
          C, k, (int)cudaErrorInvalidValue, src, dst, w1p, b1 + pair * C, w2p, b2 + pair * C,
          B, T, dilations[p], (int)(p == 0), accumulate, divide, s);
      if (err != 0) return err;
    }
  }
  return 0;
}

// Dynamic shared memory a block uses for one pair at width C, kernel size
// k and dilation dil, or -1 for a width or kernel size it is not built for.
int mrf_stack_smem_bytes(int C, int k, int dil) {
  return by_width_and_k<SmemBytes, int>(C, k, -1, dil);
}

// Output frames a block owns at width C and kernel size k (blocks per
// launch = B * ceil(T / frames)), or -1.
int mrf_stack_tile_frames(int C, int k) { return by_width_and_k<TileFrames, int>(C, k, -1); }

const char* mrf_stack_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
