// HiFi-GAN's multi-receptive-field (MRF) stage, written by hand for Hopper
// (sm_90a) on the tensor cores: bf16 operands, fp32 accumulation, fp32
// residual state.
//
// Replaces the Pallas TPU kernels mixgantts_tpu/ops/pallas_vocoder.py::
// mrf_stack and ::mrf_stack_folded above 16 channels (the folding into 128
// lanes serves the TPU's lane width; the folded layout holds the same bytes
// as [B, T, C], so both Python entry points in
// mixgantts_tpu_torch/ops/mrf.py launch this kernel on a [B, T, C] view).
// Stages of C <= 16 run mrf_stage_narrow.cu, the whole stage in one launch;
// at 32 and 64 this kernel is the faster (that file's header).
//
// One stage, x [B, T, C]: for each branch (an odd kernel size k <= 11; V1:
// 3, 7, 11), a chain of residual pairs (dilations d; V1: 1, 3, 5)
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
// Shapes: the TPU kernels' own.  Every odd k up to 11 (the taps centred in
// 11, which is SAME padding only for an odd k), any number of branches and
// pairs, and any dilation schedule whose creep fits the TPU kernels' 64-frame
// halo: sum over pairs of (k/2)(d + 1) <= 64 per branch (ops/mrf.py checks
// it).  The dilation is a runtime argument; each launch sets its shared
// memory for its own reach (mrf_stack_smem_bytes, which ops/mrf.py reads).
// Widths: C in {32, 64, 128, 256} on the pair kernel below, and C = 512 on
// the wide kernels (ops/mrf.py runs any 16 < C <= 512 at the next of them
// with zero channels).
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
// - C = 512 (a stage of HiFi-GAN with upsample_initial_channel 1024) takes
//   two launches a pair, conv1's output through device memory in bf16: a
//   wgmma's N is at most 256, so each block owns one half of the output
//   channels (grid.z) of 64 frames, and conv2 needs all 512 of conv1's
//   output channels, which the other half's block computed.  Each launch
//   is one conv over a tile of all 512 input channels (64 rows + the halo:
//   (64 + 126) x 1040 B at the widest reach, beside a 2-stage ring).

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


// --- C = 512: two launches a pair, a block per half of the output channels

constexpr int kWideC = 512;   // the stage width
constexpr int kWideN = 256;   // output channels a block owns (wgmma's N)
// one consumer warpgroup of 64 rows; a 2-stage ring of 32 K rows, the most
// that fits beside the tile at the widest reach
struct WideCfg {
  static constexpr int kWG = 1, kMT = 1, kKCH = 32, kS = 2, kNB = 2;
};
using WideP = MmaPass<kWideC, WideCfg::kMT, WideCfg::kKCH, WideCfg::kS, WideCfg::kWG, kWideN>;

template <int K>
struct Wide {
  static constexpr int kHalf = K / 2;
  static constexpr int kRows = WideP::kRows;                    // output frames per block
  static constexpr int kQ = K * kWideC / WideCfg::kKCH;         // ring chunks per conv
  static constexpr int kBarBytes = 128;                         // full[S], empty[S]
  static constexpr int kLdH = kWideN + 8;                       // bf16 per staged conv1 row
  static constexpr int kLdO = kWideN + 4;                       // fp32 per staged conv2 row
  // conv1's tile has kRows + 2 (k/2) dil rows, conv2's kRows + 2 (k/2)
  static size_t bytes(int dil) {
    return kBarBytes + WideP::kRingBytes + (size_t)(kRows + 2 * kHalf * dil) * WideP::kLd * 2;
  }
  static_assert(kRows * kLdO * 4 <= WideP::kRingBytes + kRows * WideP::kLd * 2,
                "conv2's output tile must fit over the ring and the input tile");
  static_assert(kRows * kLdH <= kRows * WideP::kLd, "conv1's output tile must fit over its input");
};

// One conv of a residual pair at C = 512, for the output channels [256 z,
// 256 z + 256) (z = blockIdx.z) of kRows frames:
// - conv1 (kSecond false): h = bf16(lrelu(conv_{k,d}(bf16(lrelu(y))) + b1))
//   on [0, T), to h_out; y is rounded to bf16 on load where round_in is set;
// - conv2 (kSecond true): out = [out +] (y + conv_k(h) + b2) [/ divide].
// The consumer warpgroup computes; one producer warp streams this half's
// weights (one contiguous run, ops/mrf.py::_pack_taps).
template <int K, bool kSecond>
__global__ void __launch_bounds__(WideP::kThreads, 1)
mrf_wide_mma(const float* __restrict__ y,              // [B, T, 512] pair input
             const __nv_bfloat16* __restrict__ h_in,   // [B, T, 512] conv1's output (conv2)
             __nv_bfloat16* __restrict__ h_out,        // [B, T, 512] (conv1)
             float* __restrict__ out,                  // [B, T, 512] (conv2)
             const __nv_bfloat16* __restrict__ w,      // K taps, halves of 256, wgmma order
             const float* __restrict__ b,              // [512]
             int T, int dil, int round_in, int accumulate, int divide) {
  using Q = Wide<K>;
  using G = WideCfg;
  using P = WideP;
  constexpr int C = kWideC, N = kWideN;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t full = smem_addr(smem), empty = full + 8 * G::kS;
  const uint32_t ring = full + Q::kBarBytes;
  unsigned char* tile = smem + Q::kBarBytes + P::kRingBytes;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.z * N;          // this block's output channels
  const int u = blockIdx.x * Q::kRows;    // its first output frame
  const size_t row = (size_t)blockIdx.y * T * C;

  if (tid == 0) {
    for (int s = 0; s < G::kS; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, P::kWG);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= P::kConsumers) {   // the producer warp: this half's chunks
    if (tid == P::kConsumers) {
      const __nv_bfloat16* wz = w + (size_t)blockIdx.z * K * C * N;
      produce<G::kS>(
          Q::kQ, ring, P::kStageBytes, full, empty,
          [&](int q) { return wz + (size_t)q * G::kKCH * N; },
          [&](int) { return (uint32_t)P::kStageBytes; });
    }
  } else {
    // the input tile, row i = frame u - reach + i (0 outside [0, T)):
    // bf16(lrelu(y)) for conv1, h for conv2; kBatch loads in flight a thread.
    // The memory phases repeat pair_consumers' at other widths: shared as
    // functions, they made ptxas spill mrf_pair_mma<256, k> at its 168
    // registers a thread (460 B of spill stores at k = 11).
    const int reach = kSecond ? Q::kHalf : Q::kHalf * dil;
    const int rows_in = Q::kRows + 2 * reach, t_in = u - reach;
    if constexpr (!kSecond) {
      constexpr int kN4 = C / 4;
      for (int i0 = tid; i0 < rows_in * kN4; i0 += kBatch * P::kConsumers) {
        float4 v[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int i = i0 + j * P::kConsumers, t = t_in + i / kN4;
          v[j] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (i < rows_in * kN4 && t >= 0 && t < T)
            v[j] = __ldg(reinterpret_cast<const float4*>(y + row + (size_t)t * C + (i % kN4) * 4));
        }
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int i = i0 + j * P::kConsumers;
          if (i >= rows_in * kN4) break;
          float4 a = v[j];
          if (round_in) a = make_float4(round_bf16(a.x), round_bf16(a.y), round_bf16(a.z),
                                        round_bf16(a.w));
          *reinterpret_cast<uint2*>(tile + 2 * ((i / kN4) * P::kLd + (i % kN4) * 4)) =
              make_uint2(pack_bf16(lrelu_f(a.x), lrelu_f(a.y)), pack_bf16(lrelu_f(a.z), lrelu_f(a.w)));
        }
      }
    } else {
      constexpr int kN8 = C / 8;
      for (int i0 = tid; i0 < rows_in * kN8; i0 += kBatch * P::kConsumers) {
        uint4 v[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int i = i0 + j * P::kConsumers, t = t_in + i / kN8;
          v[j] = make_uint4(0u, 0u, 0u, 0u);
          if (i < rows_in * kN8 && t >= 0 && t < T)
            v[j] = __ldg(reinterpret_cast<const uint4*>(h_in + row + (size_t)t * C + (i % kN8) * 8));
        }
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int i = i0 + j * P::kConsumers;
          if (i >= rows_in * kN8) break;
          *reinterpret_cast<uint4*>(tile + 2 * ((i / kN8) * P::kLd + (i % kN8) * 8)) = v[j];
        }
      }
    }
    consumer_sync<P::kConsumers>();

    const int warp = tid / 32, lane = tid % 32;
    const bool leader = tid == 0;
    const uint32_t a_lane =
        smem_addr(tile) + 2 * ((warp * 16 + (lane & 15)) * P::kLd + (lane >> 4) * 8);
    const int row0 = warp * 16 + (lane >> 2);   // + 8 h
    const int col0 = 2 * (lane & 3);             // + 8 g
    float acc[1][N / 2];
    conv_mma<C, K, 1, G::kKCH, G::kS, G::kNB, 1, N>(acc, a_lane, 2 * P::kLd,
                                                     kSecond ? 1 : dil, ring, full,
                                                     empty, 0, leader);
    consumer_sync<P::kConsumers>();

    if constexpr (!kSecond) {
      // h over the input tile (nothing reads it any more), then one
      // coalesced pass of 16-byte stores
      __nv_bfloat16* staged = reinterpret_cast<__nv_bfloat16*>(tile);   // [kRows][kLdH]
#pragma unroll
      for (int g = 0; g < N / 8; ++g) {
        const int n = 8 * g + col0;
        const float2 bias = __ldg(reinterpret_cast<const float2*>(b + n0 + n));
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = row0 + 8 * hh;
          *reinterpret_cast<uint32_t*>(staged + r * Q::kLdH + n) =
              pack_bf16(lrelu_f(acc[0][4 * g + 2 * hh] + bias.x),
                        lrelu_f(acc[0][4 * g + 2 * hh + 1] + bias.y));
        }
      }
      consumer_sync<P::kConsumers>();
      constexpr int kN8 = N / 8;
      const int n_out = min(Q::kRows, T - u) * kN8;
      for (int i = tid; i < n_out; i += P::kConsumers)
        *reinterpret_cast<uint4*>(h_out + row + (size_t)(u + i / kN8) * C + n0 + (i % kN8) * 8) =
            *reinterpret_cast<const uint4*>(staged + (i / kN8) * Q::kLdH + (i % kN8) * 8);
    } else {
      // acc + b2 over the ring and the tile, then the residual, the branch
      // sum and the fp32 store in one coalesced pass, as mrf_pair_mma
      float* staged = reinterpret_cast<float*>(tile - P::kRingBytes);   // [kRows][kLdO]
#pragma unroll
      for (int g = 0; g < N / 8; ++g) {
        const int n = 8 * g + col0;
        const float2 bias = __ldg(reinterpret_cast<const float2*>(b + n0 + n));
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = row0 + 8 * hh;
          *reinterpret_cast<float2*>(staged + r * Q::kLdO + n) =
              make_float2(acc[0][4 * g + 2 * hh] + bias.x, acc[0][4 * g + 2 * hh + 1] + bias.y);
        }
      }
      consumer_sync<P::kConsumers>();
      constexpr int kN4 = N / 4;
      const int n_out = min(Q::kRows, T - u) * kN4;
      for (int i0 = tid; i0 < n_out; i0 += kBatch * P::kConsumers) {
        float4 res[kBatch], prev[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int i = i0 + j * P::kConsumers;
          const size_t at = row + (size_t)(u + i / kN4) * C + n0 + (i % kN4) * 4;
          if (i < n_out) {
            res[j] = __ldg(reinterpret_cast<const float4*>(y + at));
            if (accumulate) prev[j] = *reinterpret_cast<const float4*>(out + at);
          }
        }
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int i = i0 + j * P::kConsumers;
          if (i >= n_out) break;
          const float4 a =
              *reinterpret_cast<const float4*>(staged + (i / kN4) * Q::kLdO + (i % kN4) * 4);
          float4 r = res[j];
          if (round_in) r = make_float4(round_bf16(r.x), round_bf16(r.y), round_bf16(r.z),
                                        round_bf16(r.w));
          float v[4] = {r.x + a.x, r.y + a.y, r.z + a.z, r.w + a.w};
          if (accumulate) {
            v[0] = prev[j].x + v[0];
            v[1] = prev[j].y + v[1];
            v[2] = prev[j].z + v[2];
            v[3] = prev[j].w + v[3];
          }
          if (divide) {
#pragma unroll
            for (int e = 0; e < 4; ++e) v[e] = v[e] / (float)divide;
          }
          *reinterpret_cast<float4*>(out + row + (size_t)(u + i / kN4) * C + n0 + (i % kN4) * 4) =
              make_float4(v[0], v[1], v[2], v[3]);
        }
      }
    }
  }
}

// One residual pair on `stream` (hbuf: conv1's bf16 output at C = 512).
template <int C, int K>
struct Launch {
  static int get(const float* y, float* out, __nv_bfloat16*, const __nv_bfloat16* w1,
                 const float* b1, const __nv_bfloat16* w2, const float* b2, int B, int T,
                 int dil, int round_in, int accumulate, int divide, cudaStream_t stream) {
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

template <int K>
struct Launch<kWideC, K> {
  static int get(const float* y, float* out, __nv_bfloat16* hbuf, const __nv_bfloat16* w1,
                 const float* b1, const __nv_bfloat16* w2, const float* b2, int B, int T,
                 int dil, int round_in, int accumulate, int divide, cudaStream_t stream) {
    using Q = Wide<K>;
    if (!hbuf) return (int)cudaErrorInvalidValue;
    const dim3 grid((T + Q::kRows - 1) / Q::kRows, B, kWideC / kWideN);
    size_t smem = Q::bytes(dil);
    cudaError_t err = cudaFuncSetAttribute(
        mrf_wide_mma<K, false>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    mrf_wide_mma<K, false><<<grid, WideP::kThreads, smem, stream>>>(
        y, nullptr, hbuf, nullptr, w1, b1, T, dil, round_in, 0, 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    smem = Q::bytes(1);
    err = cudaFuncSetAttribute(mrf_wide_mma<K, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    mrf_wide_mma<K, true><<<grid, WideP::kThreads, smem, stream>>>(
        y, hbuf, nullptr, out, w2, b2, T, 1, round_in, accumulate, divide);
    return (int)cudaGetLastError();
  }
};

// Dynamic shared memory of one pair's (largest) launch at dilation dil.
template <int C, int K>
struct SmemBytes {
  static int get(int dil) { return (int)Pair<C, K>::bytes(dil); }
};
template <int K>
struct SmemBytes<kWideC, K> {
  static int get(int dil) { return (int)Wide<K>::bytes(dil); }
};

template <int C, int K>
struct TileFrames {
  static int get() { return Pair<C, K>::kM2; }
};
template <int K>
struct TileFrames<kWideC, K> {
  static int get() { return Wide<K>::kRows; }
};

// F<C, k>::get(args...) for a width and kernel size the library is built
// for (every odd k <= 11), else `fallback`.
template <template <int, int> class F, class R, class... A>
R by_width_and_k(int C, int k, R fallback, A... args) {
  auto pick = [&](auto c) -> R {
    constexpr int CC = decltype(c)::value;
    switch (k) {
      case 1: return F<CC, 1>::get(args...);
      case 3: return F<CC, 3>::get(args...);
      case 5: return F<CC, 5>::get(args...);
      case 7: return F<CC, 7>::get(args...);
      case 9: return F<CC, 9>::get(args...);
      case 11: return F<CC, 11>::get(args...);
      default: return fallback;
    }
  };
  switch (C) {
    case 32: return pick(std::integral_constant<int, 32>());
    case 64: return pick(std::integral_constant<int, 64>());
    case 128: return pick(std::integral_constant<int, 128>());
    case 256: return pick(std::integral_constant<int, 256>());
    case 512: return pick(std::integral_constant<int, 512>());
    default: return fallback;
  }
}

}  // namespace

extern "C" {

// x, out [B, T, C] fp32; buf0, buf1 [B, T, C] fp32 scratch; hbuf [B, T, C]
// bf16 scratch at C = 512 (else unused, may be null); w1, w2 [n_br, n_pair,
// 11 C C] bf16, each (branch, pair) holding its k real taps first in wgmma
// order (ops/mrf.py::kernel_weights); b1, b2 [n_br, n_pair, C] fp32;
// kernel_sizes [n_br] and dilations [n_pair] are host arrays.  Launches
// n_br * n_pair kernels on `stream` (twice as many at C = 512) and returns
// the first CUDA error, or 0.
int mrf_stack_bf16(const float* x, float* out, float* buf0, float* buf1, __nv_bfloat16* hbuf,
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
          C, k, (int)cudaErrorInvalidValue, src, dst, hbuf, w1p, b1 + pair * C, w2p,
          b2 + pair * C, B, T, dilations[p], (int)(p == 0), accumulate, divide, s);
      if (err != 0) return err;
    }
  }
  return 0;
}

// Dynamic shared memory a block uses for one pair at width C, kernel size
// k and dilation dil (its largest launch), or -1 for a width or kernel size
// it is not built for.  ops/mrf.py holds every launch to the card's limit
// with it.
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
