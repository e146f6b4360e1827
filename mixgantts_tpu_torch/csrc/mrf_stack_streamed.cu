// A whole HiFi-GAN MRF stage at C = 256 or 512 in one launch, written by
// hand for Hopper (sm_90a) on the tensor cores: bf16 operands, fp32
// accumulation, fp32 residual state and output.
//
// Replaces the Pallas TPU kernel mixgantts_tpu/ops/pallas_vocoder.py::
// mrf_stack_streamed (body _kernel_streamed).  That kernel's grid is
// (B, tiles, 9): its inner axis walks the 9 (branch, pair) steps in order,
// streaming one step's weights at a time while the signal tile and the
// residual and branch-sum state stay in VMEM scratch.  Here the 9 steps are
// a loop inside a thread-block cluster, and so is everything else.
//
// Math (as mrf_stack.cu and the TPU kernel with op_dtype = bf16): for each
// branch (an odd kernel size k <= 11), a chain of residual pairs (dilation d)
//   y = y + (conv_k(bf16(lrelu(conv_{k,d}(bf16(lrelu(y) * mask)) + b1) * mask)) + b2)
// with y starting from bf16(x) (the TPU rounds its x tiles), mask = [0, T)
// (SAME zero padding), products summed in fp32; the output is the sum of
// the branch outputs, in branch order, divided by the number of branches.
//
// Shapes: the TPU kernel's.  Any number of branches and pairs up to
// kMaxSteps each (a kernel parameter block's worth), every odd k <= 11, and
// every dilation schedule whose creep fits the TPU kernels' 64-frame halo
// (sum over pairs of (k/2)(d + 1) <= 64 per branch).  C = 256 runs in
// clusters of 4 CTAs, C = 512 in clusters of 8 (the portable limit);
// ops/mrf.py runs 128 < C <= 256 at 256 and 256 < C <= 512 at 512 with zero
// channels.  The host plans each launch's shared memory from its schedule
// (geom_of, pick_geom): the X buffer holds a pass plus the widest conv1
// reach R = max (k/2) d each side, the stash the widest h (d + 1) rows.  A
// pass takes three warpgroups where that fits the 232,448 B a block may
// hold, else two, else one.  At C = 512 a 64-row pass's X is 1,024 (64 + 2R)
// B, so the budget there is (mbarriers 128 B, a stage of the ring 16,384 B,
// S_y = max h (d + 1) rows of stash at 272 B):
//   y in place, 4 stages:     65,664 + 1,024 (64 + 2R) + 272 S_y <= 232,448
//     (R <= 43 at k = 3; V1's schedule, R = 25, takes 190,560 B);
//   y out of place, 2 stages: 32,896 + 1,024 (64 + 2R) <= 232,448, R <= 65,
// and the halo bounds R by 63 (k = 3, d = 63: 227,456 B), so every schedule
// the halo admits has a plan.  Out of place, y lives in two slabs of device
// memory (pair p reads one and writes the other), so no pass keeps rows
// back for the next: no stash, and no bound on h (d + 3) against a pass's
// rows, which in place rules out one-warpgroup passes at the halo's edge
// (k = 3, d = 63: 66 > 64).
//
// What bounds it on an H100: operations.  The stage does 252 C^2 FLOP per
// frame: 132 GFLOP at B = 1, T = 8000, 0.134 ms at 989 TFLOP/s of bf16; x in
// and the output out are 16 MB (5 us at 3.35 TB/s).
//
// Design (mbarriers, bulk copies, the weights' layout and the wgmma calls
// come from mrf_mma.cuh, the cluster's copies and barriers from
// cluster.cuh):
// - A cluster of kRanks = C / 64 CTAs owns a tile of `tile` output frames of one
//   batch row; CTA `rank` owns output channels [64 rank, 64 rank + 64) of
//   every conv (wgmma m64n64k16) and the fp32 y of those channels.  Tiles
//   recompute their halo, so clusters never wait on each other, and the
//   host picks the tile so that the B * ceil(T / tile) clusters are all
//   resident at once (an H100 holds 30 clusters of 4 at one CTA an SM: B = 1,
//   T = 8000 runs 30 clusters of 267 frames, B = 4, T = 4096 28 of 586).
// - The window of each pair shrinks to the tile: a branch starts from x
//   over the tile plus its whole creep, sum of k/2 (d + 1) over its pairs
//   (12, 36, 60 frames a side for k = 3, 7, 11), and pair p computes y only
//   where the pairs after it still read it (creep_after).  A window runs as
//   passes of up to 192 rows (three consumer warpgroups of 64; the last
//   pass takes as few warpgroups as it needs): conv1 computes the pass's
//   rows, conv2 keeps all but the last 2 (k/2), as in mrf_stack.cu.  FLOPs
//   executed over FLOPs needed (plan_of): 1.345 at B = 1, 1.163 at B = 4.
// - Both convs read a bf16 tile of all 256 input channels, K-major without
//   swizzle ([32 channel groups][rows][8 channels]): A comes from shared
//   memory by descriptor, and a tap is a 16-byte row step of it.  Each CTA
//   writes its own channels (lrelu(y) for conv1, conv1's output for conv2;
//   one contiguous run) and sends them to the other three with one bulk
//   copy each, completing on their mbarriers (a_bar, h_bar).  Both tiles use
//   one buffer (X); the free_bar mbarrier takes one arrival from every other
//   CTA when it is done reading X (after its conv1, after its conv2), and a
//   CTA writes into the cluster's X only once that phase has completed.
// - The weights are the whole stage's kernel_weights (ops/mrf.py, wgmma
//   order); a producer warp streams this CTA's 64 columns of each 16-deep K
//   slab (2 KB, one bulk copy each) through a ring of kS stages of kKCH K
//   rows, ahead across passes, pairs and branches.  A stage's wgmmas issue
//   back to back as one group, kFly groups in flight.
// - Shared memory per CTA at V1's schedule and C = 256: mbarriers 128 B,
//   ring 4 x 16 KB = 65,536 B, X 32 x 242 rows x 16 B = 123,904 B (192 rows
//   + the k = 11, d = 5 reach 2 x 25), a stash of 30 rows of y (8,160 B):
//   197,728 B, one CTA an SM.  At C = 512 X is twice as wide, and V1's
//   schedule runs passes of one warpgroup (64 rows): 190,560 B.
//   y itself, (tile + 2 x 60) rows x 272 B a CTA (68 floats: 64 + 4 against
//   bank conflicts), lives in a slab of device memory of its own (12.6 MB
//   at B = 1, T = 8000; 21.5 MB at B = 4, T = 4096; both fit L2): at these tiles
//   it needs 105-192 KB, which the 192-row pass and its ring took.  Loads
//   from it are batched (kBatch rows, kGroups column groups) to hide L2
//   latency.
// - y is updated in place where the plan's stash fits.  The last h (d + 1)
//   rows a pass keeps are the old rows the next pass of the pair still
//   reads: they wait in the stash until that pass has built its tile
//   (out of place, they go straight to the other slab).  The last pair of a branch adds its
//   rows of the tile into the output, which only this CTA writes: no
//   atomics, the same bits every run.
// - Every wait traps after a bounded number of polls (mbar_wait,
//   mbar_wait_cluster) instead of holding the card.
//
// Measured on an H100 (tests/bench_torch_mrf.py streamed; PERF.md): the
// pass with A from registers (mrf_mma.cuh's conv_mma, ldmatrix) took ~207
// cycles a 16-deep step for two warpgroups of m64n64 (31% of the tensor
// rate) whatever the ring's depth; A from shared memory with one wgmma
// group per chunk and a third warpgroup cut the stage from 0.93 to 0.68 ms
// at B = 1.  It stays slower than three one-branch mrf_stack calls.

#include "cluster.cuh"
#include "mrf_mma.cuh"

// Phase stamps, empty here; tests/bench_torch_mrf.py defines them to time
// each phase of a pass.
#ifndef STAMP
#define STAMP(i)
#endif

namespace {

constexpr int kN = 64;                     // output channels per CTA
constexpr int kWG = 3, kMT = 1;            // consumer warpgroups, 64-row tiles each
constexpr int kKCH = 128, kS = 4;          // K rows per ring stage, stages (2 for the widest reaches)
constexpr int kFly = 2;                    // wgmma groups (ring stages) in flight
constexpr int kMaxSteps = 256;             // branches, and pairs per branch, a launch takes
constexpr int kHalo = 64;                  // a branch's creep fits the TPU kernels' halo
constexpr int kTapsMax = 11;               // stacked weights reserve 11 taps per pair
constexpr int kSplit = 256;                // output channels of one run of the weights' layout
constexpr int kMaxSmem = 232448;           // an H100 block's dynamic shared memory

using P = MmaPass<kN, kMT, kKCH, kS, kWG>;
static_assert(kN == 64, "wgmma_ss is m64n64k16");
constexpr int kYld = kN + 4;                               // floats per y row
constexpr int kBarBytes = (2 * kS + 3 + 15) / 16 * 128;      // full[S], empty[S], 3 more

// Byte offset of X behind a ring of `stages` stages.
__host__ __device__ constexpr int x_at(int stages) { return kBarBytes + stages * P::kStageBytes; }
constexpr int kBatch = 2;   // rows of y a thread loads at once building a tile
constexpr int kGroups = 2;  // groups of 8 columns whose y it loads at once in the epilogue

// CTAs per cluster at stage width C: each owns kN output channels.
template <int C>
struct Width {
  static_assert(C == 256 || C == 512, "built for C = 256 and 512");
  static constexpr int kRanks = C / kN;
};

struct Steps {
  int n_br, n_pair;
  int k[kMaxSteps];   // kernel size per branch
  int d[kMaxSteps];   // dilation per pair
};

// A launch's shared-memory plan (geom_of).
struct Geom {
  int wgs;      // consumer warpgroups a pass uses (64 wgs rows), 0 if none fits
  int stages;   // ring stages: kS with y in place, or 2 with y out of place (out_of_place)
  int x_rows;   // rows of the X buffer: a pass plus the widest conv1 reach each side
  int stash;    // byte offset of the stash: rows y takes later (in place only)
  int smem;     // dynamic shared memory per CTA
};

// Frames per side that the pairs after pair p of a kernel-k branch still
// widen the window by (p = -1: the branch's whole creep).
__host__ __device__ inline int creep_after(const Steps& s, int k, int p) {
  int c = 0;
  for (int q = p + 1; q < s.n_pair; ++q) c += (k / 2) * (s.d[q] + 1);
  return c;
}

struct Win {
  int lo, hi;
};

// The frames pair p of a kernel-k branch computes y on (p = -1: y = x at
// the branch start), for the tile at t0, within [0, T).
__host__ __device__ inline Win window(const Steps& s, int k, int p, int t0, int tile, int T) {
  const int c = creep_after(s, k, p);
  const int lo = t0 - c, hi = (t0 + tile < T ? t0 + tile : T) + c;
  return {lo > 0 ? lo : 0, hi < T ? hi : T};
}

// Rows of a pass with `rem` frames of its window left: the fewest whole
// warpgroups whose conv2 keeps them all, else all `wgs` of them.
__host__ __device__ inline int pass_rows(int rem, int h, int wgs) {
  for (int w = 1; w < wgs; ++w)
    if (64 * kMT * w - 2 * h >= rem) return 64 * kMT * w;
  return 64 * kMT * wgs;
}

template <int C>
__host__ __device__ inline int chunks(int k) { return k * C / kKCH; }   // ring chunks per conv

int lead_of(const Steps& s) {
  int lead = 0;
  for (int br = 0; br < s.n_br; ++br) {
    const int c = creep_after(s, s.k[br], -1);
    lead = c > lead ? c : lead;
  }
  return lead;
}

// Whether a ring of `stages` stages updates y out of place, in two slabs
// (pair p reads one and writes the other, no stash), or in place (kS).
__host__ __device__ constexpr bool out_of_place(int stages) { return stages < kS; }

// The plan for passes of `wgs` warpgroups behind a ring of `stages`
// stages.  In place, valid where it fits a block's shared memory and every
// full pass keeps more rows than the next pass reads back (h (d + 1) + 2 h
// <= its rows: the stash holds the overlap of two passes only); out of
// place, where it fits.  Else wgs is 0.
template <int C>
Geom geom_of(const Steps& s, int wgs, int stages) {
  int reach = 0, stash = 0, overlap = 0;
  for (int br = 0; br < s.n_br; ++br)
    for (int p = 0; p < s.n_pair; ++p) {
      const int h = s.k[br] / 2, d = s.d[p];
      reach = h * d > reach ? h * d : reach;
      stash = h * (d + 1) > stash ? h * (d + 1) : stash;
      overlap = h * (d + 3) > overlap ? h * (d + 3) : overlap;
    }
  const bool oop = out_of_place(stages);
  Geom g;
  g.stages = stages;
  g.x_rows = 64 * kMT * wgs + 2 * reach;
  g.stash = x_at(stages) + C / 8 * g.x_rows * 16;
  g.smem = g.stash + (oop ? 0 : stash * kYld * 4);
  g.wgs = (oop || overlap <= 64 * kMT * wgs) && g.smem <= kMaxSmem ? wgs : 0;
  return g;
}

// The first valid plan, most warpgroups a pass first: y in place behind
// kS stages (every schedule at C = 256, and V1's at 512), else (C = 512
// only) y out of place behind 2 stages; the in-place plan of one
// warpgroup, with wgs 0, where none is valid.
template <int C>
Geom pick_geom(const Steps& s) {
  for (int wgs = kWG; wgs > 0; --wgs) {
    const Geom g = geom_of<C>(s, wgs, kS);
    if (g.wgs) return g;
  }
  if (C == 512)
    for (int wgs = kWG; wgs > 0; --wgs) {
      const Geom g = geom_of<C>(s, wgs, 2);
      if (g.wgs) return g;
    }
  return geom_of<C>(s, 1, kS);
}

// Ring chunks a CTA of the tile at t0 streams, and (flops != nullptr) the
// FLOPs its cluster executes, halo recompute included.
template <int C>
__host__ __device__ inline int plan_of(const Steps& s, int t0, int tile, int T, int wgs,
                                       double* flops) {
  int n = 0;
  for (int br = 0; br < s.n_br; ++br) {
    const int k = s.k[br], h = k / 2;
    for (int p = 0; p < s.n_pair; ++p) {
      const Win w = window(s, k, p, t0, tile, T);
      for (int u = w.lo; u < w.hi;) {
        const int m = pass_rows(w.hi - u, h, wgs);
        n += 2 * chunks<C>(k);
        if (flops) *flops += 2.0 * 2.0 * m * k * C * C;
        u += m - 2 * h;
      }
    }
  }
  return n;
}

// acc[mt] (64 x kN, fp32) = the conv of X rows [a0 / 16 + 64 mt, +64) (X
// K-major, `stride` bytes from one group of 8 channels to the next): sum
// over taps t < K and the C input channels of A[r + t dil, c] W[t][c][n],
// both operands from shared memory.  The weights are ring chunks q0 ..
// q0 + chunks(K) - 1; each chunk's wgmmas issue back to back as one group,
// kFly groups in flight, and `leader` releases a chunk's stage once its
// group has completed.
template <int C, int K, int S>
__device__ __forceinline__ void conv_ss(float (&acc)[kMT][kN / 2], uint32_t a0, uint32_t stride,
                                        int dil, uint32_t ring, uint32_t full, uint32_t empty,
                                        int q0, bool leader) {
  constexpr int kSPC = kKCH / 16, kChunks = K * C / kKCH, kPerTap = C / 16;
  static_assert(kChunks >= kFly && S >= kFly, "a conv fills the groups in flight");
  auto release = [&](int q) {
    if (leader) mbar_arrive(empty + 8 * (q % S));
  };
#pragma unroll 1
  for (int i = 0; i < kChunks; ++i) {
    const int q = q0 + i;
    mbar_wait(full + 8 * (q % S), (uint32_t)((q / S) & 1));
    const uint32_t b = ring + (q % S) * P::kStageBytes;
    // a fence before every group: without it ptxas puts its own in the
    // leader's divergent path and serializes the wgmmas (C7520)
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kSPC; ++j) {
      const int st = i * kSPC + j, tap = st / kPerTap, c0 = (st % kPerTap) * 16;
      const uint32_t a = a0 + (uint32_t)(tap * dil) * 16 + (c0 / 8) * stride;
      const uint64_t db = slab_desc(b + j * 32 * kN);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
        wgmma_ss(acc[mt], kmajor_desc(a + mt * 64 * 16, stride, 128), db, st > 0);
    }
    wgmma_commit();
    if (i >= kFly - 1) {
      wgmma_wait<kFly - 1>();   // chunk q - kFly + 1 has been read
      release(q - kFly + 1);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int j = 0; j < kN / 2; ++j) fence_reg(acc[mt][j]);
  for (int i = kChunks - kFly + 1; i < kChunks; ++i) release(q0 + i);
}

// The consumer warpgroup's conv of its rows at kernel size k.
template <int C, int S>
__device__ __forceinline__ void conv(int k, float (&acc)[kMT][kN / 2], uint32_t a0,
                                     uint32_t stride, int dil, uint32_t ring, uint32_t full,
                                     uint32_t empty, int q, bool leader) {
  switch (k) {
    case 1: conv_ss<C, 1, S>(acc, a0, stride, dil, ring, full, empty, q, leader); break;
    case 3: conv_ss<C, 3, S>(acc, a0, stride, dil, ring, full, empty, q, leader); break;
    case 5: conv_ss<C, 5, S>(acc, a0, stride, dil, ring, full, empty, q, leader); break;
    case 7: conv_ss<C, 7, S>(acc, a0, stride, dil, ring, full, empty, q, leader); break;
    case 9: conv_ss<C, 9, S>(acc, a0, stride, dil, ring, full, empty, q, leader); break;
    default: conv_ss<C, 11, S>(acc, a0, stride, dil, ring, full, empty, q, leader);
  }
}

// A warpgroup with no rows in a short pass still releases each ring stage
// of the conv (chunks q .. q + n - 1) once it has landed.
template <int S>
__device__ __forceinline__ void drain(int q, int n, uint32_t full, uint32_t empty, bool leader) {
  if (!leader) return;
  for (int i = q; i < q + n; ++i) {
    mbar_wait(full + 8 * (i % S), (uint32_t)((i / S) & 1));
    mbar_arrive(empty + 8 * (i % S));
  }
}

// Grid (kRanks * ceil(T / tile), B), clusters of kRanks CTAs along x, a
// ring of S stages; each CTA keeps y in its part of y_slab ([CTAs][tile +
// 2 lead][kYld] fp32, twice over out of place: pair p reads slab p % 2 and
// writes the other).  The steps are read in place from the parameter
// block (__grid_constant__: no copy of their arrays per thread).
template <int C, int S>
__global__ void __launch_bounds__(P::kThreads, 1)
mrf_stage_streamed(const float* __restrict__ x,                // [B, T, C]
                   float* __restrict__ out,                    // [B, T, C]
                   float* __restrict__ y_slab,
                   const __nv_bfloat16* __restrict__ w1,       // [n_br, n_pair, 11 C C], wgmma order
                   const float* __restrict__ b1,               // [n_br, n_pair, C]
                   const __nv_bfloat16* __restrict__ w2,
                   const float* __restrict__ b2,
                   int T, int tile, int lead, Geom geo, const __grid_constant__ Steps s) {
  constexpr int kRanks = Width<C>::kRanks;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_addr(smem);
  const uint32_t full = base, empty = base + 8 * S;
  const uint32_t a_bar = base + 16 * S, h_bar = a_bar + 8, free_bar = a_bar + 16;
  constexpr int kX = x_at(S);
  // out of place, one row and one column group of y at a time: the second
  // slab's pointer leaves no room for more under the 128 registers a thread
  // of 13 warps may hold (ptxas spills otherwise)
  constexpr int kBatchS = out_of_place(S) ? 1 : kBatch;
  constexpr int kGroupsS = out_of_place(S) ? 1 : kGroups;
  const uint32_t ring = base + kBarBytes, xt = base + kX;
  const int tid = threadIdx.x;
  const uint32_t rank = cluster_rank();
  const int ch0 = rank * kN;
  const int t0 = (blockIdx.x / kRanks) * tile, b = blockIdx.y;
  const int s0 = t0 - lead;   // the frame of y's row 0
  const size_t row = (size_t)b * T * C;

  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, kWG);
    }
    mbar_init(a_bar, 1);
    mbar_init(h_bar, 1);
    mbar_init(free_bar, kRanks - 1);
    mbar_init_fence();
  }
  __syncthreads();
  cluster_arrive();   // every CTA's mbarriers are ready before any copy or arrival
  cluster_wait();

  if (tid >= P::kConsumers) {
    if (tid == P::kConsumers) {
      // the producer: this CTA's columns of every conv of every pass, in the
      // consumers' order (in the weights' run of 256 output channels
      // ch0 / 256, ops/mrf.py::_pack_taps)
      int br = 0, p = 0, u = 0, hi = 0, cv = 0, c = 0;
      auto start_pair = [&]() {
        const Win w = window(s, s.k[br], p, t0, tile, T);
        u = w.lo;
        hi = w.hi;
      };
      start_pair();
      produce_chunks<S>(
          plan_of<C>(s, t0, tile, T, geo.wgs, nullptr), ring, P::kStageBytes, full, empty,
          [&](int, uint32_t dst, uint32_t bar) {
            const int k = s.k[br], h = k / 2;
            const __nv_bfloat16* src = (cv ? w2 : w1) +
                                       ((size_t)br * s.n_pair + p) * kTapsMax * C * C +
                                       (size_t)(ch0 / kSplit) * k * C * kSplit +
                                       (size_t)c * kKCH * kSplit + (ch0 % kSplit) * 16;
            mbar_expect_tx(bar, kKCH * kN * 2);
            for (int i = 0; i < kKCH / 16; ++i)
              bulk_copy(dst + i * 32 * kN, src + (size_t)i * 16 * kSplit, 32 * kN, bar);
            if (++c < chunks<C>(k)) return;
            c = 0;
            if (++cv < 2) return;
            cv = 0;
            u += pass_rows(hi - u, h, geo.wgs) - 2 * h;
            if (u < hi) return;
            if (++p == s.n_pair) {
              p = 0;
              ++br;
            }
            if (br < s.n_br) start_pair();
          });
    }
  } else {
    const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
    const bool leader = tid % 128 == 0;
    const int row0 = wg * kMT * 64 + warp * 16 + (lane >> 2);   // + 64 mt + 8 hh
    const int col0 = 2 * (lane & 3);                             // + 8 g
    const int wg_row = wg * kMT * 64;   // this warpgroup's first row of a pass
    const size_t cta_floats = (size_t)(tile + 2 * lead) * kYld;
    float* const y = y_slab + ((size_t)b * gridDim.x + blockIdx.x) * cta_floats;
    // pair p reads y (odd p: y2) and writes y2 (odd p: y): the same slab in place
    float* const y2 = out_of_place(S) ? y + (size_t)gridDim.y * gridDim.x * cta_floats : y;
    float* stash = reinterpret_cast<float*>(smem + geo.stash);
    float acc[kMT][kN / 2];
    int q = 0, pass = 0;

    // this CTA's channels of the X tile (rows of `stride`) to the other CTAs,
    // completing on their `bar` (one thread)
    auto all_gather = [&](uint32_t bar, int stride) {
      const uint32_t slice = xt + ch0 / 8 * stride * 16, bytes = kN / 8 * stride * 16;
      mbar_expect_tx(bar, (kRanks - 1) * bytes);
      for (int j = 1; j < kRanks; ++j) {
        const uint32_t peer = (rank + j) % kRanks;
        bulk_copy_peer(map_rank(slice, peer), slice, bytes, map_rank(bar, peer));
      }
    };
    auto arrive_peers = [&]() {
      for (int j = 1; j < kRanks; ++j) mbar_arrive_peer(free_bar, (rank + j) % kRanks);
    };

    for (int br = 0; br < s.n_br; ++br) {
      const int k = s.k[br], h = k / 2;
      // y = bf16(x) over the branch's window
      const Win w0 = window(s, k, -1, t0, tile, T);
      consumer_sync<P::kConsumers>();
      for (int i = tid; i < (w0.hi - w0.lo) * (kN / 4); i += P::kConsumers) {
        const int f = w0.lo + i / (kN / 4), c = (i % (kN / 4)) * 4;
        const float4 v = __ldg(reinterpret_cast<const float4*>(x + row + (size_t)f * C + ch0 + c));
        *reinterpret_cast<float4*>(y + (f - s0) * kYld + c) =
            make_float4(round_bf16(v.x), round_bf16(v.y), round_bf16(v.z), round_bf16(v.w));
      }
      consumer_sync<P::kConsumers>();

      for (int p = 0; p < s.n_pair; ++p) {
        const int d = s.d[p];
        const bool last = p == s.n_pair - 1;
        const float* yin = p % 2 ? y2 : y;
        float* yout = p % 2 ? y : y2;
        const size_t step = (size_t)br * s.n_pair + p;
        const Win w = window(s, k, p, t0, tile, T), w_in = window(s, k, p - 1, t0, tile, T);
        int pend_f = 0, pend_n = 0;   // stashed rows of the last pass, not yet in y
        for (int u = w.lo; u < w.hi;) {
          const int m = pass_rows(w.hi - u, h, geo.wgs), kept = m - 2 * h, sa = m + 2 * h * d;
          const bool active = wg * kMT * 64 < m;
          STAMP(0)
          // the other CTAs are done reading X (their conv2 of the last pass)
          if (pass > 0) mbar_wait_cluster(free_bar, 1);
          STAMP(1)

          // conv1's input, bf16(lrelu(y) * mask), this CTA's channels: tile
          // row i is frame u - h - h d + i; frames outside the window of y
          // (outside [0, T), or feeding only rows no pass keeps) are 0
          for (int i0 = tid; i0 < sa * (kN / 8); i0 += kBatchS * P::kConsumers) {
            float4 lo4[kBatchS], hi4[kBatchS];   // kBatchS rows' loads in flight
#pragma unroll
            for (int j = 0; j < kBatchS; ++j) {
              const int i = i0 + j * P::kConsumers, f = u - h - h * d + i % sa;
              lo4[j] = hi4[j] = make_float4(0.f, 0.f, 0.f, 0.f);
              if (i < sa * (kN / 8) && f >= w_in.lo && f < w_in.hi) {
                const float* yr = yin + (f - s0) * kYld + 8 * (i / sa);
                lo4[j] = *reinterpret_cast<const float4*>(yr);
                hi4[j] = *reinterpret_cast<const float4*>(yr + 4);
              }
            }
#pragma unroll
            for (int j = 0; j < kBatchS; ++j) {
              const int i = i0 + j * P::kConsumers;
              if (i >= sa * (kN / 8)) break;
              *reinterpret_cast<uint4*>(smem + kX + ((ch0 / 8 + i / sa) * sa + i % sa) * 16) =
                  make_uint4(pack_bf16(lrelu_f(lo4[j].x), lrelu_f(lo4[j].y)),
                             pack_bf16(lrelu_f(lo4[j].z), lrelu_f(lo4[j].w)),
                             pack_bf16(lrelu_f(hi4[j].x), lrelu_f(hi4[j].y)),
                             pack_bf16(lrelu_f(hi4[j].z), lrelu_f(hi4[j].w)));
            }
          }
          fence_proxy_async();
          consumer_sync<P::kConsumers>();
          if (tid == 0) all_gather(a_bar, sa);
          // every thread has read the old rows this pass shares with the last
          // one: the last one's stashed rows go into y
          for (int i = tid; i < pend_n * (kN / 4); i += P::kConsumers) {
            const int r = i / (kN / 4), c = (i % (kN / 4)) * 4, f = pend_f + r;
            if (f >= w.lo && f < w.hi) {
              float4* at = reinterpret_cast<float4*>(y + (f - s0) * kYld + c);
              const float4 a = *at, v = *reinterpret_cast<const float4*>(stash + r * kYld + c);
              *at = make_float4(a.x + v.x, a.y + v.y, a.z + v.z, a.w + v.w);
            }
          }
          mbar_wait(a_bar, (uint32_t)(pass & 1));
          STAMP(2)

          // conv1: output row r is frame u - h + r
          if (active)
            conv<C, S>(k, acc, xt + wg_row * 16, sa * 16, d, ring, full, empty, q, leader);
          else
            drain<S>(q, chunks<C>(k), full, empty, leader);
          q += chunks<C>(k);
          consumer_sync<P::kConsumers>();
          if (tid == 0) arrive_peers();
          STAMP(3)
          mbar_wait_cluster(free_bar, 0);   // every CTA is done reading X
          STAMP(4)

          // h = bf16(lrelu(conv1 + b1) * mask), this CTA's channels, into X
          if (active) {
            const float* b1p = b1 + step * C + ch0;
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
              for (int g = 0; g < kN / 8; ++g) {
                const float2 bias = __ldg(reinterpret_cast<const float2*>(b1p + 8 * g + col0));
#pragma unroll
                for (int hh = 0; hh < 2; ++hh) {
                  const int r = row0 + 64 * mt + 8 * hh, f = u - h + r;
                  const bool inside = f >= 0 && f < T;
                  *reinterpret_cast<uint32_t*>(smem + kX + ((ch0 / 8 + g) * m + r) * 16 +
                                               col0 * 2) =
                      inside ? pack_bf16(lrelu_f(acc[mt][4 * g + 2 * hh] + bias.x),
                                         lrelu_f(acc[mt][4 * g + 2 * hh + 1] + bias.y))
                             : 0u;
                }
              }
          }
          fence_proxy_async();
          consumer_sync<P::kConsumers>();
          if (tid == 0) all_gather(h_bar, m);
          mbar_wait(h_bar, (uint32_t)(pass & 1));
          STAMP(5)

          // conv2: output row r is frame u + r, kept for r < kept
          if (active)
            conv<C, S>(k, acc, xt + wg_row * 16, m * 16, 1, ring, full, empty, q, leader);
          else
            drain<S>(q, chunks<C>(k), full, empty, leader);
          q += chunks<C>(k);
          consumer_sync<P::kConsumers>();
          if (tid == 0) arrive_peers();
          STAMP(6)

          // y += conv2 + b2 on the kept rows of the window; in place, the last
          // `ov` of them go to the stash while the next pass of the pair
          // still reads their old values; the last pair adds y on the tile
          // into the branch sum (this CTA's rows and channels of the output)
          // instead
          const int ov = out_of_place(S) || last || u + kept >= w.hi ? 0 : h * (d + 1);
          if (active) {
            const float* b2p = b2 + step * C + ch0;
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
              for (int g0 = 0; g0 < kN / 8; g0 += kGroupsS) {
                // the loads of kGroupsS column groups first, then the stores
                float2 yv[kGroupsS][2], prev[kGroupsS][2];
#pragma unroll
                for (int g = g0; g < g0 + kGroupsS; ++g)
#pragma unroll
                  for (int hh = 0; hh < 2; ++hh) {
                    const int r = row0 + 64 * mt + 8 * hh, f = u + r;
                    yv[g - g0][hh] = prev[g - g0][hh] = make_float2(0.f, 0.f);
                    if (r < kept - ov && f >= w.lo && f < w.hi) {
                      yv[g - g0][hh] = *reinterpret_cast<const float2*>(
                          yin + (f - s0) * kYld + 8 * g + col0);
                      if (last && br > 0)
                        prev[g - g0][hh] = *reinterpret_cast<const float2*>(
                            out + row + (size_t)f * C + ch0 + 8 * g + col0);
                    }
                  }
#pragma unroll
                for (int g = g0; g < g0 + kGroupsS; ++g) {
                  const float2 bias = __ldg(reinterpret_cast<const float2*>(b2p + 8 * g + col0));
#pragma unroll
                  for (int hh = 0; hh < 2; ++hh) {
                    const int r = row0 + 64 * mt + 8 * hh, f = u + r;
                    if (r >= kept || f < w.lo || f >= w.hi) continue;
                    const float2 v = make_float2(acc[mt][4 * g + 2 * hh] + bias.x,
                                                 acc[mt][4 * g + 2 * hh + 1] + bias.y);
                    const float2 a = yv[g - g0][hh];
                    if (r >= kept - ov) {
                      *reinterpret_cast<float2*>(stash + (r - (kept - ov)) * kYld + 8 * g + col0) = v;
                    } else if (!last) {
                      *reinterpret_cast<float2*>(yout + (f - s0) * kYld + 8 * g + col0) =
                          make_float2(a.x + v.x, a.y + v.y);
                    } else {
                      float2 o = make_float2(a.x + v.x, a.y + v.y);
                      if (br > 0) o = make_float2(prev[g - g0][hh].x + o.x, prev[g - g0][hh].y + o.y);
                      if (br == s.n_br - 1)
                        o = make_float2(o.x / (float)s.n_br, o.y / (float)s.n_br);
                      *reinterpret_cast<float2*>(out + row + (size_t)f * C + ch0 + 8 * g + col0) = o;
                    }
                  }
                }
              }
          }
          pend_f = u + kept - ov;
          pend_n = ov;
          if (!ov) consumer_sync<P::kConsumers>();   // the next pass reads these rows
          STAMP(7)
          ++pass;
          u += kept;
        }
      }
    }
  }
  __syncwarp();
  // no CTA leaves while a copy or an arrival may still target it
  cluster_arrive();
  cluster_wait();
}

// The launch's steps from host arrays, or false for a shape it is not
// built for: 1 to kMaxSteps branches and pairs, odd k <= 11, d >= 1, and
// every branch's creep within the halo.
bool steps_of(int n_br, int n_pair, const int* kernel_sizes, const int* dilations,
              Steps* s) {
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
    if (creep_after(*s, s->k[br], -1) > kHalo) return false;   // the X buffer's halo
  return true;
}

template <int C>
cudaLaunchConfig_t launch_config(int B, int T, int tile, int smem, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = Width<C>::kRanks;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Width<C>::kRanks * ((T + tile - 1) / tile), B, 1);
  cfg.blockDim = dim3(P::kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of width C the current device holds at once, worked out once
// per device and width.  Every plan takes more than half an SM's shared
// memory, so a CTA has an SM to itself whatever its plan: the count at the
// largest plan is the count at every plan.
template <int C>
int resident_clusters(int* out) {
  constexpr int kDevices = 64;
  static int known[kDevices];   // clusters + 1, 0 until worked out
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < kDevices && known[dev] > 0) {
    *out = known[dev] - 1;
    return 0;
  }
  err = cudaFuncSetAttribute(mrf_stage_streamed<C, kS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config<C>(1, 1000, 1000, kMaxSmem, nullptr, &attr);
  err = cudaOccupancyMaxActiveClusters(
      out, reinterpret_cast<const void*>(mrf_stage_streamed<C, kS>), &cfg);
  if (err == cudaSuccess && dev < kDevices) known[dev] = *out + 1;
  return (int)err;
}

template <int C>
int plan_for(int B, int T, const Steps& s, int* plan) {
  const Geom g = pick_geom<C>(s);
  int resident = 0;
  const int err = resident_clusters<C>(&resident);
  if (err != 0) return err;
  const int per_row = resident / B > 1 ? resident / B : 1;
  const int tile = (T + per_row - 1) / per_row;
  plan[0] = tile;
  plan[1] = resident;
  plan[2] = (out_of_place(g.stages) ? 2 : 1) * B * ((T + tile - 1) / tile) * Width<C>::kRanks *
            (tile + 2 * lead_of(s)) * kYld;
  plan[3] = g.smem;
  plan[4] = Width<C>::kRanks;
  plan[5] = 64 * kMT * g.wgs;
  plan[6] = g.stages;
  plan[7] = out_of_place(g.stages);
  return 0;
}

template <int C>
double flops_for(int B, int T, int tile, const Steps& s) {
  const Geom g = pick_geom<C>(s);
  if (!g.wgs) return -1.0;
  double flops = 0.0;
  for (int t0 = 0; t0 < T; t0 += tile) plan_of<C>(s, t0, tile, T, g.wgs, &flops);
  return flops * B;
}

template <int C, int S>
int launch_with(const float* x, float* out, float* y_slab, const __nv_bfloat16* w1,
                const float* b1, const __nv_bfloat16* w2, const float* b2, int B, int T, int tile,
                const Steps& s, const Geom& g, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      mrf_stage_streamed<C, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config<C>(B, T, tile, g.smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, mrf_stage_streamed<C, S>, x, out, y_slab, w1, b1, w2, b2, T,
                           tile, lead_of(s), g, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int C>
int launch(const float* x, float* out, float* y_slab, const __nv_bfloat16* w1, const float* b1,
           const __nv_bfloat16* w2, const float* b2, int B, int T, int tile, const Steps& s,
           cudaStream_t stream) {
  const Geom g = pick_geom<C>(s);
  if (!g.wgs) return (int)cudaErrorInvalidValue;
  if (g.stages == kS)
    return launch_with<C, kS>(x, out, y_slab, w1, b1, w2, b2, B, T, tile, s, g, stream);
  if constexpr (C == 512)
    return launch_with<C, 2>(x, out, y_slab, w1, b1, w2, b2, B, T, tile, s, g, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The launch plan at B, T and width C (256 or 512) on the current device,
// into plan[0..7]: frames per cluster (the fewest that put every cluster on
// the card at once), clusters the device holds at once, floats of the y
// slab the caller allocates (both slabs out of place), dynamic shared
// memory per CTA, CTAs per cluster, rows a pass (0: no pass of this
// schedule fits a block's shared memory, and the launch refuses it; no
// schedule within the halo comes to that), ring stages, and 1 where y is
// updated out of place.  Returns the CUDA error, or
// cudaErrorInvalidValue for a shape the kernel is not built for.
int mrf_stack_streamed_plan(int B, int T, int C, int n_br, int n_pair, const int* kernel_sizes,
                            const int* dilations, int* plan) {
  Steps s;
  if (B < 1 || T < 1 || !steps_of(n_br, n_pair, kernel_sizes, dilations, &s))
    return (int)cudaErrorInvalidValue;
  switch (C) {
    case 256: return plan_for<256>(B, T, s, plan);
    case 512: return plan_for<512>(B, T, s, plan);
    default: return (int)cudaErrorInvalidValue;
  }
}

// FLOPs the launch executes at B, T, C and tile, halo recompute included,
// or -1.
double mrf_stack_streamed_flops(int B, int T, int C, int tile, int n_br, int n_pair,
                                const int* kernel_sizes, const int* dilations) {
  Steps s;
  if (B < 1 || T < 1 || tile < 1 || !steps_of(n_br, n_pair, kernel_sizes, dilations, &s))
    return -1.0;
  switch (C) {
    case 256: return flops_for<256>(B, T, tile, s);
    case 512: return flops_for<512>(B, T, tile, s);
    default: return -1.0;
  }
}

// x, out [B, T, C] fp32 (C = 256 or 512); y_slab as mrf_stack_streamed_plan
// says for this tile; w1, w2 [n_br, n_pair, 11 C C] bf16 in wgmma order for
// kernel_sizes (ops/mrf.py::kernel_weights); b1, b2 [n_br, n_pair, C] fp32;
// kernel_sizes [n_br] and dilations [n_pair] are host arrays.  One launch on
// `stream`; returns its CUDA error, or 0.
int mrf_stack_streamed_bf16(const float* x, float* out, float* y_slab, const __nv_bfloat16* w1,
                            const float* b1, const __nv_bfloat16* w2, const float* b2, int B,
                            int T, int C, int tile, int n_br, int n_pair,
                            const int* kernel_sizes, const int* dilations, void* stream) {
  Steps s;
  if (B < 1 || T < 1 || tile < 1 || !y_slab ||
      !steps_of(n_br, n_pair, kernel_sizes, dilations, &s))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 256: return launch<256>(x, out, y_slab, w1, b1, w2, b2, B, T, tile, s, st);
    case 512: return launch<512>(x, out, y_slab, w1, b1, w2, b2, B, T, tile, s, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* mrf_stack_streamed_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
