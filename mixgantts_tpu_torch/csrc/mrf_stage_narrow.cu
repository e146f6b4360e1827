// A whole HiFi-GAN MRF stage of C <= 16 channels in one launch, written by
// hand for Hopper (sm_90a) on the tensor cores: bf16 operands, fp32
// accumulation, fp32 residual state, branch sum and output.
//
// Replaces the Pallas TPU kernel mixgantts_tpu/ops/pallas_vocoder.py::
// mrf_stack_folded (body _kernel_folded) at the stages narrower than 32
// channels (HiFi-GAN V2's 16 and 8, the dryrun's 8 and 4), from both entry
// points of ops/mrf.py.  The TPU kernel folds time into its 128 lanes
// ([B, T/F, F C], F = 128 / C) and runs every branch and pair of the stage
// in one call, the residual state and the branch sum in VMEM scratch.  The
// fold serves the TPU's lane width; here the stage is a loop inside one
// block per tile of frames, and the signal stays [B, T, C] (ops/mrf.py
// views the folded layout as such).  C = 32 and 64 (V1's folded stages)
// stay on mrf_stack.cu's pair kernel, which is faster there (below).
//
// Math (as mrf_stack.cu and the TPU kernel with op_dtype = bf16): for each
// branch (an odd kernel size k <= 11), a chain of residual pairs (dilation d)
//   y = y + (conv_k(bf16(lrelu(conv_{k,d}(bf16(lrelu(y) * mask)) + b1) * mask)) + b2)
// with y starting from bf16(x) (the TPU rounds its x tiles), mask = [0, T)
// (SAME zero padding), products summed in fp32; the output is the sum of
// the branch outputs, in branch order, divided by the number of branches.
//
// Shapes: the TPU kernels'.  Any number of branches and pairs up to
// kMaxSteps each, every odd k <= 11, every dilation schedule whose creep
// fits the TPU kernels' 64-frame halo (sum over pairs of (k/2)(d + 1) <= 64
// per branch), B >= 1 and any T.  Widths C in {8, 16} (Cfg below);
// ops/mrf.py runs any C <= 16 at the next of them with zero channels.
//
// What bounds it on an H100: a stage does 252 C^2 FLOP per frame and moves
// x in and the output out, 8 C bytes per frame.  HiFi-GAN V2's C = 16 stage
// at bucket 1000 (128,000 frames): 8.26 GFLOP, 0.0083 ms at 989 TFLOP/s of
// bf16, and 16.4 MB, 0.0049 ms at 3.35 TB/s (operations); its C = 8 stage
// (256,000 frames): 4.13 GFLOP, 0.0042 ms, and 16.4 MB, 0.0049 ms (bytes).
// The pair kernel ran these stages at 32 channels (4x and 16x the work)
// and moved y through device memory between pairs; here nothing but x, the
// output and the weights (from L2) crosses the SM's boundary.  Measured
// (PERF.md, the narrow stages' kernel) it is latency-bound, ~15-25x these
// bounds: a pair's phases are short, and each waits on the last (four
// barriers a pair).
//
// Design (the mbarriers, the bulk copies, the weights' wgmma order and the
// wgmma calls come from mrf_mma.cuh):
// - A block owns a tile of `tile` output frames of one batch row and all C
//   channels, for the whole stage.  It keeps in shared memory bf16(x) over
//   the tile plus the widest creep (`lead`) each side (xs, read from device
//   memory once), the fp32 y of the current branch over the same rows (y),
//   the fp32 branch sum over the tile (sum) and one bf16 operand tile (X).
//   The output is written once, from sum, in one coalesced pass.
// - Tiles recompute their halo, so blocks never wait on each other.  Pair p
//   of a branch computes y only where the pairs after it still read it
//   (c_after): its window is the tile plus 2 c_after(p) frames.
// - Each conv of a pair is one pass of implicit GEMM on wgmma (m64nCk16,
//   N = 8 or 16): M = frames, in 64-row tiles, WG consumer warpgroups of
//   MT tiles each (kRows = 64 MT WG rows a pass), N = C, K = taps x C
//   rounded up to 16.  The host picks the tile so that every window fits
//   one pass (conv1 computes the window plus k/2 a side), and a warpgroup
//   runs only as many of its 64-row tiles as the window needs.  A comes
//   from X through ldmatrix: an 8-deep half of a K step is 8 channels of
//   one tap, a row offset of tap * d, so C = 8 packs two taps into one K
//   step (the half past an odd k's last tap reads tap 0 against zero
//   weights).
// - conv1 reads X = bf16(lrelu(y) * mask); its epilogue bf16(lrelu(acc +
//   b1) * mask) overwrites X once every warpgroup is done reading it; conv2
//   reads that, and its epilogue adds acc + b2 to y in place (y is read only
//   to build X, which is done by then), or, at the last pair, adds y + acc +
//   b2 to the branch sum.
// - The weights (ops/mrf.py::kernel_weights: per (branch, pair) K rows of
//   C, in wgmma's order, K padded to 16) stream through a ring of kS stages
//   of kKCH K rows, filled by one producer warp with cp.async.bulk, a whole
//   stage's worth per tile in the consumers' order, so the next chunk's
//   copy overlaps the current chunk's wgmmas.
// - Shared memory per block (Geom below): mbarriers 128 B, the ring, X of
//   kRows + the widest tap reach ((k - 1) d) rows, xs and y of tile +
//   2 lead rows, sum of tile rows.  The tile is the longest whose windows
//   fit one pass (kRows less conv1's widest window growth, 2 c_after + 2
//   (k/2), at most 126 frames) and whose buffers fit the block's share of
//   an SM's shared memory (115,712 B at two blocks an SM: V2's schedule at
//   C = 16 takes 98,944 B at 243 frames); every schedule within the halo
//   has one of at least 64 frames (tests/test_torch_gpu_kernels.py holds
//   every one- and two-pair schedule to it).
// - Every wait traps after a bounded number of polls (mbar_wait) instead of
//   holding the card.
//
// Why not C = 32 and 64: the same design there (output channels on M at 64,
// tiles of at most 146 frames at C = 64 and one block an SM) took 0.93 ms
// for HiFi-GAN V1's C = 64 stage and 0.62 ms for its C = 32 stage, against
// the pair kernel's 0.57 and 0.53 ms in the same call (PERF.md, the
// narrow stages' kernel).
// Its shared-memory phases (X's build and the two epilogues) took ~60% of
// a pair's cycles with nothing else on the SM to overlap them, and the
// halo recompute 1.43x the stage's FLOPs at C = 64 (2.47x at 32 with M
// padded to 64); the pair kernel runs three blocks an SM, whose memory
// phases overlap each other's wgmmas.

#include "mrf_mma.cuh"

// Phase stamps, empty here; tests/bench_torch_mrf.py defines them to time
// each phase of a pair.
#ifndef STAMP
#define STAMP(i)
#endif

namespace {

constexpr int kTapsMax = 11;      // stacked weights reserve 11 taps per pair
constexpr int kHalo = 64;         // a branch's creep fits the TPU kernels' halo
constexpr int kMaxSteps = 256;    // branches, and pairs per branch, a launch takes
constexpr int kMaxSmem = 232448;  // an H100 block's dynamic shared memory
constexpr int kSmSmem = 233472;   // an H100 SM's, less 1 KB a block the system keeps
constexpr int kBarBytes = 128;    // full[kS], empty[kS]
constexpr int kBuild = 2;         // X rows a thread loads at once building X
constexpr int kLoad = 4;          // and x rows, building xs

// Per width: WG consumer warpgroups of MT 64-row tiles each, KCH K rows per
// ring stage, S stages, NB A-fragment buffers (NB - 1 steps' wgmmas in
// flight), and the blocks an SM is to hold at once (which caps registers
// and each block's shared memory).  Two blocks an SM overlap one block's
// shared-memory phases with the other's wgmmas: against one block of 13
// or 17 warps, 21-24% off the C = 16 stage and ~10% off the C = 8 stage of
// a V2 request (tests/bench_torch_mrf.py narrow).  Two blocks of 9 or 13
// warps get at most 96 or 72 registers a thread (an SM sub-partition's
// 16,384 shared by the warps it gets), which the accumulators (MT C / 2)
// and NB MT 4 fragments fit without spilling (13 warps at C = 16 spill).
template <int C>
struct Cfg;
template <>
struct Cfg<16> {
  static constexpr int kWG = 2, kMT = 3, kKCH = 64, kS = 4, kNB = 2, kBlocks = 2;
};
template <>
struct Cfg<8> {
  static constexpr int kWG = 3, kMT = 2, kKCH = 32, kS = 4, kNB = 2, kBlocks = 2;
};

__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// K rows of a k-tap conv at width C: k C rounded up to a 16-deep step.
__host__ __device__ constexpr int kpad(int k, int C) { return (k * C + 15) / 16 * 16; }

template <int C>
struct Geo {
  using G = Cfg<C>;
  static constexpr int kConsumers = 128 * G::kWG;
  static constexpr int kThreads = kConsumers + 32;      // + one producer warp
  static constexpr int kRows = 64 * G::kMT * G::kWG;    // rows of a pass
  // bf16 per X row and fp32 per y row: X rows an odd multiple of 16 bytes
  // (ldmatrix without bank conflicts at any row offset), y rows 24 words
  // mod 32 (the epilogue's float2 pairs without conflicts)
  static constexpr int kLd = 24;
  static constexpr int kYld = 24;
  static constexpr int kStageBytes = G::kKCH * C * 2;
  static constexpr int kRingBytes = G::kS * kStageBytes;
  static constexpr int kRowBytes = 2 * kLd;
  static_assert(C == 8 || C == 16, "built for C = 8 and 16");
  static_assert((kRowBytes / 16) % 2 == 1, "X rows must be an odd multiple of 16 bytes");
  static_assert(2 * G::kS <= kBarBytes / 8, "the mbarriers must fit their 128 bytes");
};

// Ring chunks of one k-tap conv at width C and KCH K rows a chunk.
template <int C, int KCH>
__host__ __device__ constexpr int chunks(int k) {
  return (kpad(k, C) + KCH - 1) / KCH;
}

struct Steps {
  int n_br, n_pair;
  int k[kMaxSteps];   // kernel size per branch
  int d[kMaxSteps];   // dilation per pair
};

// Frames per side that the pairs after pair p of a kernel-k branch still
// widen the window by (p = -1: the branch's whole creep).
__host__ __device__ inline int c_after(const Steps& s, int k, int p) {
  int c = 0;
  for (int q = p + 1; q < s.n_pair; ++q) c += (k / 2) * (s.d[q] + 1);
  return c;
}

// Where a launch keeps its buffers (Geom).
struct Layout {
  int tile;     // output frames per block
  int lead;     // rows of xs and y before the tile (the widest creep)
  int xs_at;    // byte offsets of xs, y and sum
  int y_at;
  int sum_at;
};

// acc[mt] (64 x C, fp32), mt < ACT, = the k-tap conv of rows [64 mt, +64)
// of this warpgroup's part of X: sum over K rows kk = tap C + c of
// X[r + tap dil, c] W[kk][n].  `a_lane` is this lane's ldmatrix address of
// row 0 of its warp's first tile (lanes 16-31 read the K step's second
// half: 8 channels on at C >= 16, the next tap at C = 8, where the padding
// half of an odd k's last step reads tap 0 against its zero weights).  The weights
// are ring chunks q0 .. q0 + chunks(K) - 1; `leader` (one thread a
// warpgroup) releases each stage once the wgmmas that read it have
// completed.  A fragments rotate through NB register buffers, as
// mrf_mma.cuh's conv_mma (which takes C a multiple of 16 and a multiple of
// NB steps).
template <int C, int K, int ACT>
__device__ __forceinline__ void narrow_conv(float (&acc)[Cfg<C>::kMT][C / 2], uint32_t a_lane,
                                            int dil, uint32_t ring, uint32_t full,
                                            uint32_t empty, int q0, bool leader) {
  using G = Cfg<C>;
  using L = Geo<C>;
  constexpr int NB = G::kNB, kSPC = G::kKCH / 16;
  constexpr int kSteps = kpad(K, C) / 16;
  static_assert(NB >= 2 && NB <= 4, "2 to 4 fragment buffers");
  static_assert((G::kS - 1) * kSPC >= NB - 1, "the ring must run ahead of the fragments");
  uint32_t a[NB][ACT][4];

  const bool half = (threadIdx.x & 31) >= 16;
  auto load_a = [&](uint32_t (&frag)[ACT][4], int st) {
    uint32_t base;
    if constexpr (C == 8)   // K step st: taps 2 st and 2 st + 1
      base = a_lane + (uint32_t)((2 * st + (half && 2 * st + 1 < K)) * dil) * L::kRowBytes;
    else                    // one tap, channels 16 (st % (C / 16)) + 8 half
      base = a_lane + (uint32_t)((st / (C / 16)) * dil) * L::kRowBytes + (st % (C / 16)) * 32 +
             (half ? 16 : 0);
#pragma unroll
    for (int mt = 0; mt < ACT; ++mt) ldmatrix_x4(frag[mt], base + mt * 64 * L::kRowBytes);
  };
  auto stage_of = [&](int q) { return (uint32_t)(q % G::kS); };
  auto wait_full = [&](int q) { mbar_wait(full + 8 * stage_of(q), (uint32_t)((q / G::kS) & 1)); };
  auto release = [&](int done) {
    if (leader && ((done + 1) % kSPC == 0 || done == kSteps - 1))
      mbar_arrive(empty + 8 * stage_of(q0 + done / kSPC));
  };
  auto step = [&](auto buf, int st) {
    constexpr int B = decltype(buf)::value;
    constexpr int NX = (B + 1) % NB;
    const uint64_t desc = slab_desc(ring + stage_of(q0 + st / kSPC) * L::kStageBytes +
                                    (st % kSPC) * 32 * C);
    wgmma_fence();
#pragma unroll
    for (int mt = 0; mt < ACT; ++mt) Wgmma<C>::mma(acc[mt], a[B][mt], desc, st > 0);
    wgmma_commit();
    wgmma_wait<NB - 1>();   // step st - NB + 1 has completed
#pragma unroll
    for (int mt = 0; mt < ACT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) fence_reg(a[NX][mt][i]);
    if (st >= NB - 1) release(st - NB + 1);
    if (st + 1 < kSteps) {
      if ((st + 1) % kSPC == 0) wait_full(q0 + (st + 1) / kSPC);
      load_a(a[NX], st + 1);
    }
  };

  constexpr int kMain = kSteps - kSteps % NB;
  wait_full(q0);
  load_a(a[0], 0);
  for (int st = 0; st < kMain; st += NB) {
    step(std::integral_constant<int, 0>(), st);
    step(std::integral_constant<int, 1>(), st + 1);
    if constexpr (NB > 2) step(std::integral_constant<int, 2 % NB>(), st + 2);
    if constexpr (NB > 3) step(std::integral_constant<int, 3 % NB>(), st + 3);
  }
  if constexpr (kSteps % NB > 0) step(std::integral_constant<int, 0>(), kMain);
  if constexpr (kSteps % NB > 1) step(std::integral_constant<int, 1>(), kMain + 1);
  if constexpr (kSteps % NB > 2) step(std::integral_constant<int, 2 % NB>(), kMain + 2);
  wgmma_wait<0>();
#pragma unroll
  for (int mt = 0; mt < ACT; ++mt)
#pragma unroll
    for (int j = 0; j < C / 2; ++j) fence_reg(acc[mt][j]);
#pragma unroll
  for (int d = (kSteps - NB + 1 > 0 ? kSteps - NB + 1 : 0); d < kSteps; ++d) release(d);
}

// narrow_conv with ACT (1 .. MT) chosen at run time.
template <int C, int K, int A = Cfg<C>::kMT>
__device__ __forceinline__ void conv_act(int act, float (&acc)[Cfg<C>::kMT][C / 2],
                                         uint32_t a_lane, int dil, uint32_t ring, uint32_t full,
                                         uint32_t empty, int q0, bool leader) {
  if (act == A)
    narrow_conv<C, K, A>(acc, a_lane, dil, ring, full, empty, q0, leader);
  else if constexpr (A > 1)
    conv_act<C, K, A - 1>(act, acc, a_lane, dil, ring, full, empty, q0, leader);
}

// The warpgroup's conv at kernel size k over `act` of its 64-row tiles.
template <int C>
__device__ __forceinline__ void conv(int k, int act, float (&acc)[Cfg<C>::kMT][C / 2],
                                     uint32_t a_lane, int dil, uint32_t ring, uint32_t full,
                                     uint32_t empty, int q0, bool leader) {
  switch (k) {
    case 1: conv_act<C, 1>(act, acc, a_lane, dil, ring, full, empty, q0, leader); break;
    case 3: conv_act<C, 3>(act, acc, a_lane, dil, ring, full, empty, q0, leader); break;
    case 5: conv_act<C, 5>(act, acc, a_lane, dil, ring, full, empty, q0, leader); break;
    case 7: conv_act<C, 7>(act, acc, a_lane, dil, ring, full, empty, q0, leader); break;
    case 9: conv_act<C, 9>(act, acc, a_lane, dil, ring, full, empty, q0, leader); break;
    default: conv_act<C, 11>(act, acc, a_lane, dil, ring, full, empty, q0, leader);
  }
}

// The producer (one thread): both convs of every pair of every branch, in
// the consumers' order, in chunks of KCH K rows (the last of a conv may be
// shorter) through a ring of S stages.
template <int C, int KCH, int S>
__device__ __forceinline__ void produce_stage(const Steps& s, const __nv_bfloat16* w1,
                                              const __nv_bfloat16* w2, uint32_t ring,
                                              uint32_t full, uint32_t empty) {
  constexpr int kPair = kpad(kTapsMax, C) * C;
  int br = 0, p = 0, cv = 0, c = 0, n = 0;
  for (int i = 0; i < s.n_br; ++i) n += 2 * s.n_pair * chunks<C, KCH>(s.k[i]);
  produce_chunks<S>(n, ring, KCH * C * 2, full, empty, [&](int, uint32_t dst, uint32_t bar) {
    const int k = s.k[br];
    const int bytes = imin(KCH, kpad(k, C) - c * KCH) * C * 2;
    const __nv_bfloat16* src =
        (cv ? w2 : w1) + ((size_t)br * s.n_pair + p) * kPair + (size_t)c * KCH * C;
    mbar_expect_tx(bar, bytes);
    bulk_copy(dst, src, bytes, bar);
    if (++c < chunks<C, KCH>(k)) return;
    c = 0;
    if (++cv < 2) return;
    cv = 0;
    if (++p < s.n_pair) return;
    p = 0;
    ++br;
  });
}

// A warpgroup with no rows in a conv still releases each of its ring
// stages (chunks q .. q + n - 1) once it has landed.
template <int S>
__device__ __forceinline__ void drain(int q, int n, uint32_t full, uint32_t empty, bool leader) {
  if (!leader) return;
  for (int i = q; i < q + n; ++i) {
    mbar_wait(full + 8 * (i % S), (uint32_t)((i / S) & 1));
    mbar_arrive(empty + 8 * (i % S));
  }
}

__device__ __forceinline__ float4 lrelu4(float4 v) {
  return make_float4(lrelu_f(v.x), lrelu_f(v.y), lrelu_f(v.z), lrelu_f(v.w));
}

__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// Grid (ceil(T / tile), B); a block per tile of one batch row, for the whole
// stage.  The steps are read in place from the parameter block
// (__grid_constant__: no copy of their arrays per thread).
template <int C>
__global__ void __launch_bounds__(Geo<C>::kThreads, Cfg<C>::kBlocks)
mrf_stage_narrow(const float* __restrict__ x,                // [B, T, C]
                 float* __restrict__ out,                    // [B, T, C]
                 const __nv_bfloat16* __restrict__ w1,       // ops/mrf.py::kernel_weights
                 const float* __restrict__ b1,               // [n_br, n_pair, C]
                 const __nv_bfloat16* __restrict__ w2,
                 const float* __restrict__ b2,
                 int T, Layout lay, const __grid_constant__ Steps s) {
  using G = Cfg<C>;
  using L = Geo<C>;
  constexpr int MT = G::kMT, kC8 = C / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_addr(smem);
  const uint32_t full = base, empty = base + 8 * G::kS, ring = base + kBarBytes;
  unsigned char* xt = smem + kBarBytes + L::kRingBytes;                        // X, bf16
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + lay.xs_at);     // bf16(x)
  float* y = reinterpret_cast<float*>(smem + lay.y_at);
  float* sum = reinterpret_cast<float*>(smem + lay.sum_at);                 // [tile][kYld]
  const int tid = threadIdx.x;
  const int tile = lay.tile, t0 = blockIdx.x * tile, b = blockIdx.y;
  const int s0 = t0 - lay.lead;              // the frame of row 0 of xs and y
  const int rows_y = tile + 2 * lay.lead;
  const size_t row = (size_t)b * T * C;

  if (tid == 0) {
    for (int i = 0; i < G::kS; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, G::kWG);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= L::kConsumers) {
    if (tid == L::kConsumers)
      produce_stage<C, G::kKCH, G::kS>(s, w1, w2, ring, full, empty);
    return;
  }

  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const bool leader = tid % 128 == 0;
  const int wg_row = wg * MT * 64;                                  // this warpgroup's first row
  const int row0 = wg_row + warp * 16 + (lane >> 2);               // + 64 mt + 8 hh
  const int col0 = 2 * (lane & 3);                                  // + 8 g
  // this lane's ldmatrix row in X
  const uint32_t a_row = smem_addr(xt) + (wg_row + warp * 16 + (lane & 15)) * L::kRowBytes;
  float acc[MT][C / 2];

  STAMP(6)
  // xs = bf16(x) over [s0, s0 + rows_y), 0 outside [0, T); kLoad rows'
  // loads in flight a thread
  for (int i0 = tid; i0 < rows_y * kC8; i0 += kLoad * L::kConsumers) {
    float4 v[kLoad][2];
#pragma unroll
    for (int j = 0; j < kLoad; ++j) {
      const int i = i0 + j * L::kConsumers, f = s0 + i / kC8;
      v[j][0] = v[j][1] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < rows_y * kC8 && f >= 0 && f < T) {
        const float4* src =
            reinterpret_cast<const float4*>(x + row + (size_t)f * C + (i % kC8) * 8);
        v[j][0] = __ldg(src);
        v[j][1] = __ldg(src + 1);
      }
    }
#pragma unroll
    for (int j = 0; j < kLoad; ++j) {
      const int i = i0 + j * L::kConsumers;
      if (i >= rows_y * kC8) break;
      *reinterpret_cast<uint4*>(xs + (i / kC8) * C + (i % kC8) * 8) =
          make_uint4(pack_bf16(v[j][0].x, v[j][0].y), pack_bf16(v[j][0].z, v[j][0].w),
                     pack_bf16(v[j][1].x, v[j][1].y), pack_bf16(v[j][1].z, v[j][1].w));
    }
  }

  int q = 0;   // the ring chunk the next conv starts at
  for (int br = 0; br < s.n_br; ++br) {
    const int k = s.k[br], h = k / 2;
    const int nq = chunks<C, G::kKCH>(k);
    for (int p = 0; p < s.n_pair; ++p) {
      const int d = s.d[p];
      const bool first = p == 0, last = p == s.n_pair - 1;
      const int ca = c_after(s, k, p), cb = ca + h * (d + 1);   // this pair's creep, the last's
      const int lo = t0 - ca, n = tile + 2 * ca;                 // y's window after this pair
      const int in_lo = imax(0, t0 - cb), in_hi = imin(T, t0 + tile + cb);   // and before it
      const int m1 = (n + 2 * h + 63) / 64, m2 = (n + 63) / 64;  // 64-row tiles of each conv
      const int rows_in = 64 * m1 + (k - 1) * d;                 // X rows conv1 reads

      // X row i = bf16(lrelu(y) * mask) of frame lo - h - h d + i (0 outside
      // y's window and [0, T)); y is xs at a branch's first pair
      STAMP(0)
      consumer_sync<L::kConsumers>();
      const int f_in = lo - h - h * d;
      for (int i0 = tid; i0 < rows_in * kC8; i0 += kBuild * L::kConsumers) {
        float4 v[kBuild][2];
#pragma unroll
        for (int j = 0; j < kBuild; ++j) {
          const int i = i0 + j * L::kConsumers, f = f_in + i / kC8, c8 = i % kC8;
          v[j][0] = v[j][1] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (i < rows_in * kC8 && f >= in_lo && f < in_hi) {
            if (first) {
              const uint4 u = *reinterpret_cast<const uint4*>(xs + (f - s0) * C + c8 * 8);
              const float2 a0 = bf16x2_to_float2(u.x), a1 = bf16x2_to_float2(u.y);
              const float2 a2 = bf16x2_to_float2(u.z), a3 = bf16x2_to_float2(u.w);
              v[j][0] = make_float4(a0.x, a0.y, a1.x, a1.y);
              v[j][1] = make_float4(a2.x, a2.y, a3.x, a3.y);
            } else {
              const float4* src = reinterpret_cast<const float4*>(y + (f - s0) * L::kYld + c8 * 8);
              v[j][0] = src[0];
              v[j][1] = src[1];
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kBuild; ++j) {
          const int i = i0 + j * L::kConsumers;
          if (i >= rows_in * kC8) break;
          const float4 lo4 = lrelu4(v[j][0]), hi4 = lrelu4(v[j][1]);
          *reinterpret_cast<uint4*>(xt + (i / kC8) * L::kRowBytes + (i % kC8) * 16) =
              make_uint4(pack_bf16(lo4.x, lo4.y), pack_bf16(lo4.z, lo4.w),
                         pack_bf16(hi4.x, hi4.y), pack_bf16(hi4.z, hi4.w));
        }
      }
      consumer_sync<L::kConsumers>();
      STAMP(1)

      // conv1 (cv = 0): output row r is frame lo - h + r; conv2 (cv = 1):
      // output row r is frame lo + r, kept for r < n.  One call site, so
      // that the conv's variants are inlined once.
      for (int cv = 0; cv < 2; ++cv) {
        const int act = imin(imax((cv ? m2 : m1) - wg * MT, 0), MT), dil = cv ? 1 : d;
        if (act)
          conv<C>(k, act, acc, a_row, dil, ring, full, empty, q, leader);
        else
          drain<G::kS>(q, nq, full, empty, leader);
        q += nq;
        STAMP(2 + 2 * cv)
        if (cv == 0) {
          consumer_sync<L::kConsumers>();   // every warpgroup is done reading X
          // X row r = bf16(lrelu(conv1 + b1) * mask)
          const float* b1p = b1 + ((size_t)br * s.n_pair + p) * C;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            if (mt >= act) break;
#pragma unroll
            for (int g = 0; g < kC8; ++g) {
              const float2 bias = __ldg(reinterpret_cast<const float2*>(b1p + 8 * g + col0));
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                const int r = row0 + 64 * mt + 8 * hh, f = lo - h + r;
                const bool inside = f >= 0 && f < T;
                *reinterpret_cast<uint32_t*>(xt + r * L::kRowBytes + (8 * g + col0) * 2) =
                    inside ? pack_bf16(lrelu_f(acc[mt][4 * g + 2 * hh] + bias.x),
                                       lrelu_f(acc[mt][4 * g + 2 * hh + 1] + bias.y))
                           : 0u;
              }
            }
          }
          consumer_sync<L::kConsumers>();
          STAMP(3)
          continue;
        }
        // y += conv2 + b2 over the window (in place: X is built by now), or,
        // at the last pair, the branch's rows of the tile into the sum
        const float* b2p = b2 + ((size_t)br * s.n_pair + p) * C;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (mt >= act) break;
#pragma unroll
          for (int g = 0; g < kC8; ++g) {
            const float2 bias = __ldg(reinterpret_cast<const float2*>(b2p + 8 * g + col0));
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int r = row0 + 64 * mt + 8 * hh, f = lo + r;
              if (r >= n || f < 0 || f >= T) continue;
              const int at = f - s0, c = 8 * g + col0;
              const float2 old =
                  first ? bf16x2_to_float2(*reinterpret_cast<const uint32_t*>(xs + at * C + c))
                        : *reinterpret_cast<const float2*>(y + at * L::kYld + c);
              const float2 v = make_float2(old.x + (acc[mt][4 * g + 2 * hh] + bias.x),
                                           old.y + (acc[mt][4 * g + 2 * hh + 1] + bias.y));
              if (last) {   // r = f - t0: the tile's row
                float2* at_sum = reinterpret_cast<float2*>(sum + r * L::kYld + c);
                *at_sum = br ? make_float2(at_sum->x + v.x, at_sum->y + v.y) : v;
              } else {
                *reinterpret_cast<float2*>(y + at * L::kYld + c) = v;
              }
            }
          }
        }
      }
      STAMP(5)
    }
  }

  // the output, once: the branch sum over the tile's rows of [0, T)
  consumer_sync<L::kConsumers>();
  const float n_br = (float)s.n_br;
  const int n_out = imin(tile, T - t0) * (C / 4);
  for (int i = tid; i < n_out; i += L::kConsumers) {
    const float4 v =
        *reinterpret_cast<const float4*>(sum + (i / (C / 4)) * L::kYld + (i % (C / 4)) * 4);
    *reinterpret_cast<float4*>(out + row + (size_t)(t0 + i / (C / 4)) * C + (i % (C / 4)) * 4) =
        make_float4(v.x / n_br, v.y / n_br, v.z / n_br, v.w / n_br);
  }
  STAMP(7)
}

// The launch's steps from host arrays, or false for a shape it is not
// built for: 1 to kMaxSteps branches and pairs, odd k <= 11, d >= 1, and
// every branch's creep within the halo.
bool steps_of(int n_br, int n_pair, const int* kernel_sizes, const int* dilations, Steps* s) {
  if (n_br < 1 || n_br > kMaxSteps || n_pair < 1 || n_pair > kMaxSteps) return false;
  s->n_br = n_br;
  s->n_pair = n_pair;
  for (int i = 0; i < kMaxSteps; ++i) s->k[i] = s->d[i] = 0;
  for (int br = 0; br < n_br; ++br) {
    const int k = kernel_sizes[br];
    if (k < 1 || k > kTapsMax || k % 2 == 0) return false;
    s->k[br] = k;
  }
  for (int p = 0; p < n_pair; ++p) {
    if (dilations[p] < 1) return false;
    s->d[p] = dilations[p];
  }
  for (int br = 0; br < n_br; ++br)
    if (c_after(*s, s->k[br], -1) > kHalo) return false;
  return true;
}

// The shared-memory plan of a schedule at width C, from its widest creep
// (lead), conv1's widest window growth over the tile (grow: 2 c_after + 2
// (k/2)) and the widest tap reach of a conv ((k - 1) d): X of a pass plus
// that reach rows, xs and y of tile + 2 lead rows, sum of tile rows, all
// row-major.
template <int C>
struct Geom {
  using L = Geo<C>;
  static constexpr int kRows = L::kRows, kThreads = L::kThreads;
  int lead = 0, grow = 0, x_rows = L::kRows;
  explicit Geom(const Steps& s) {
    int reach = 0;
    for (int br = 0; br < s.n_br; ++br) {
      const int k = s.k[br];
      lead = imax(lead, c_after(s, k, -1));
      for (int p = 0; p < s.n_pair; ++p) {
        grow = imax(grow, 2 * c_after(s, k, p) + 2 * (k / 2));
        reach = imax(reach, (k - 1) * s.d[p]);
      }
    }
    x_rows += reach;
  }
  int xs_at() const { return kBarBytes + L::kRingBytes + x_rows * L::kRowBytes; }
  static constexpr int row_bytes() { return 2 * C + 4 * L::kYld; }   // xs and y a row
  static constexpr int sum_bytes() { return 4 * L::kYld; }            // sum a row
  int smem(int tile) const {
    return xs_at() + (tile + 2 * lead) * row_bytes() + tile * sum_bytes();
  }
  // the longest tile: every window in one pass, within a block's share of
  // an SM's shared memory
  int max_tile() const {
    const int budget = imin(kMaxSmem, kSmSmem / Cfg<C>::kBlocks - 1024);
    const int by_smem = (budget - xs_at() - 2 * lead * row_bytes()) / (row_bytes() + sum_bytes());
    return imin(L::kRows - grow, by_smem);
  }
  Layout layout(int tile) const {
    const int y_at = xs_at() + (tile + 2 * lead) * 2 * C;
    return {tile, lead, xs_at(), y_at, y_at + (tile + 2 * lead) * 4 * L::kYld};
  }
  // FLOPs of one tile: 64-row tiles of every conv, K padded to 16
  double flops(int tile, const Steps& s) const {
    double f = 0.0;
    for (int br = 0; br < s.n_br; ++br) {
      const int k = s.k[br], h = k / 2;
      for (int p = 0; p < s.n_pair; ++p) {
        const int n = tile + 2 * c_after(s, k, p);
        f += 2.0 * (64 * ((n + 2 * h + 63) / 64) + 64 * ((n + 63) / 64)) * kpad(k, C) * C;
      }
    }
    return f;
  }
  static auto kernel() { return &mrf_stage_narrow<C>; }
};

// Blocks of width C the current device holds at once at `smem` bytes
// each (SMs x blocks an SM).
template <int C>
int resident_blocks(int smem, int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(Geom<C>::kernel(), cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Geom<C>::kernel(),
                                                        Geom<C>::kThreads, smem);
  *out = sms * per_sm;
  return (int)err;
}

// The plan at B, T: plan[0..5] = tile (output frames per block), blocks a
// launch, blocks resident at once, dynamic shared memory per block, rows a
// pass, and the lead.  The tile is the longest that fits, shortened so
// that the blocks fill whole waves of the resident ones (and, for a
// launch that fills less than one wave, so that it has a block per
// resident slot, down to 64 frames).  tile 0: no tile fits.
template <int C>
int plan_for(int B, int T, const Steps& s, int* plan) {
  const Geom<C> geo(s);
  const int max_tile = geo.max_tile();
  for (int i = 0; i < 6; ++i) plan[i] = 0;
  plan[3] = geo.smem(max_tile > 0 ? max_tile : 1);
  plan[4] = Geom<C>::kRows;
  plan[5] = geo.lead;
  if (max_tile < 1) return 0;
  int resident = 0;
  const int err = resident_blocks<C>(geo.smem(max_tile), &resident);
  if (err != 0) return err;
  if (resident < 1) return (int)cudaErrorInvalidConfiguration;
  const long tiles_min = (T + max_tile - 1) / max_tile;
  const long waves = (B * tiles_min + resident - 1) / resident;
  const long per_row = tiles_min > waves * resident / B ? tiles_min : waves * resident / B;
  const int tile = imax((int)((T + per_row - 1) / per_row), imin(64, max_tile));
  plan[0] = tile;
  plan[1] = B * ((T + tile - 1) / tile);
  plan[2] = resident;
  plan[3] = geo.smem(tile);
  return 0;
}

// FLOPs a launch executes at B, T and `tile` (halo recompute, the tensor
// cores' row multiples and K's padding to 16 included).
template <int C>
double flops_for(int B, int T, int tile, const Steps& s) {
  return Geom<C>(s).flops(tile, s) * B * ((T + tile - 1) / tile);
}

template <int C>
int launch(const float* x, float* out, const __nv_bfloat16* w1, const float* b1,
           const __nv_bfloat16* w2, const float* b2, int B, int T, int tile, const Steps& s,
           cudaStream_t stream) {
  const Geom<C> geo(s);
  if (tile < 1 || tile > geo.max_tile()) return (int)cudaErrorInvalidValue;
  const int smem = geo.smem(tile);
  cudaError_t err = cudaFuncSetAttribute(Geom<C>::kernel(),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + tile - 1) / tile, B);
  Geom<C>::kernel()<<<grid, Geom<C>::kThreads, smem, stream>>>(x, out, w1, b1, w2, b2, T,
                                                                   geo.layout(tile), s);
  return (int)cudaGetLastError();
}

template <template <int> class F, class R, class... A>
R by_width(int C, R fallback, A... args) {
  switch (C) {
    case 8: return F<8>::get(args...);
    case 16: return F<16>::get(args...);
    default: return fallback;
  }
}

template <int C>
struct PlanOf {
  static int get(int B, int T, const Steps* s, int* plan) { return plan_for<C>(B, T, *s, plan); }
};
template <int C>
struct FlopsOf {
  static double get(int B, int T, int tile, const Steps* s) { return flops_for<C>(B, T, tile, *s); }
};
template <int C>
struct SmemOf {
  static int get(int tile, const Steps* s) { return Geom<C>(*s).smem(tile); }
};
template <int C>
struct MaxTileOf {
  static int get(const Steps* s) { return Geom<C>(*s).max_tile(); }
};
template <int C>
struct LaunchOf {
  static int get(const float* x, float* out, const __nv_bfloat16* w1, const float* b1,
                 const __nv_bfloat16* w2, const float* b2, int B, int T, int tile,
                 const Steps* s, cudaStream_t stream) {
    return launch<C>(x, out, w1, b1, w2, b2, B, T, tile, *s, stream);
  }
};

}  // namespace

extern "C" {

// The launch plan at B, T and width C (8, 16, 32 or 64) on the current
// device, into plan[0..5] (plan_for; tile 0 where no tile of this schedule
// fits a block's shared memory, which no schedule within the halo comes
// to).  Returns the CUDA error, or cudaErrorInvalidValue for a shape the
// kernel is not built for.
int mrf_stage_narrow_plan(int B, int T, int C, int n_br, int n_pair, const int* kernel_sizes,
                          const int* dilations, int* plan) {
  Steps s;
  if (B < 1 || T < 1 || !steps_of(n_br, n_pair, kernel_sizes, dilations, &s))
    return (int)cudaErrorInvalidValue;
  return by_width<PlanOf, int>(C, (int)cudaErrorInvalidValue, B, T, (const Steps*)&s, plan);
}

// Dynamic shared memory a block takes at width C, this schedule and
// `tile` frames, and the longest tile whose windows fit one pass and the
// card's 232,448 B (smem_and_tile[0], [1]); no device needed.  Returns
// cudaErrorInvalidValue for a shape the kernel is not built for.
int mrf_stage_narrow_smem_bytes(int C, int n_br, int n_pair, const int* kernel_sizes,
                                const int* dilations, int tile, int* smem_and_tile) {
  Steps s;
  if (!steps_of(n_br, n_pair, kernel_sizes, dilations, &s)) return (int)cudaErrorInvalidValue;
  smem_and_tile[0] = by_width<SmemOf, int>(C, -1, tile, (const Steps*)&s);
  smem_and_tile[1] = by_width<MaxTileOf, int>(C, -1, (const Steps*)&s);
  return smem_and_tile[0] < 0 ? (int)cudaErrorInvalidValue : 0;
}

// FLOPs a launch executes at B, T, C and tile, halo recompute included, or -1.
double mrf_stage_narrow_flops(int B, int T, int C, int tile, int n_br, int n_pair,
                              const int* kernel_sizes, const int* dilations) {
  Steps s;
  if (B < 1 || T < 1 || tile < 1 || !steps_of(n_br, n_pair, kernel_sizes, dilations, &s))
    return -1.0;
  return by_width<FlopsOf, double>(C, -1.0, B, T, tile, (const Steps*)&s);
}

// x, out [B, T, C] fp32 (C = 8, 16, 32 or 64); w1, w2 [n_br, n_pair,
// ceil(11 C / 16) 16 C] bf16 in wgmma order for kernel_sizes, K padded to 16
// (ops/mrf.py::kernel_weights); b1, b2 [n_br, n_pair, C] fp32; kernel_sizes
// [n_br] and dilations [n_pair] are host arrays; `tile` from the plan.  One
// launch on `stream`; returns its CUDA error, or 0.
int mrf_stage_narrow_bf16(const float* x, float* out, const __nv_bfloat16* w1, const float* b1,
                          const __nv_bfloat16* w2, const float* b2, int B, int T, int C,
                          int tile, int n_br, int n_pair, const int* kernel_sizes,
                          const int* dilations, void* stream) {
  Steps s;
  if (B < 1 || T < 1 || !steps_of(n_br, n_pair, kernel_sizes, dilations, &s))
    return (int)cudaErrorInvalidValue;
  return by_width<LaunchOf, int>(C, (int)cudaErrorInvalidValue, x, out, w1, b1, w2, b2, B, T,
                                 tile, (const Steps*)&s, static_cast<cudaStream_t>(stream));
}

const char* mrf_stage_narrow_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
