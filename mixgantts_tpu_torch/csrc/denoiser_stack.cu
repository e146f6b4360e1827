// The diffusion denoiser's gated residual stack, written by hand for Hopper
// (sm_90a) on the tensor cores: bf16 operands, fp32 accumulation, fp32
// residual and skip state.
//
// Replaces the Pallas TPU kernel mixgantts_tpu/ops/pallas.py::
// fused_residual_stack.  Python entry point:
// mixgantts_tpu_torch/ops/denoiser_stack.py::fused_residual_stack.
//
// Per layer l, with x and skip [B, T, C] fp32 (C = 256 for LJSpeech):
//   y0 = x + step_proj[l];   y = bf16((y0 + condp[l]) * [0 <= t < T])
//   z  = conv_k3(y) + conv_b                  (C -> 2C, zero padding)
//   g  = bf16(sigmoid(z[:, :C]) * tanh(z[:, C:]))
//   o  = g @ out_w + out_b                    (C -> 2C)
//   x' = (o[:, :C] + y0) / sqrt(2);   skip += o[:, C:]
// with conv_w and out_w in bf16 and every product summed in fp32: the
// rounding points of the TPU kernel (pallas.py::_kernel, whose operand type
// is the weights' bf16 on its chip).  step_proj and condp (the 1x1
// conditioner projection) of every layer are computed before the stack by
// two fp32 matrix products, as the TPU kernel's caller does.
//
// What bounds it on an H100: one request (B = 1, T = 1000, L = 20) is
// ~21 GFLOP of conv and output projection, ~21 us at 989 TFLOP/s of bf16,
// against 21 MB of bf16 weights and ~20 MB of condp (~12 us at 3.35 TB/s;
// condp comes as [B, T, L, C], one matrix product with its bias).
// A layer is ~1 us of tensor-core work, so what sets the pace is what each
// layer costs besides: the weights' way from L2 to every CTA, the exchange
// of y and g between the CTAs that share a frame tile, and the wait for the
// neighbour tiles (the k = 3 halo).
//
// Design (mbarriers, bulk copies and the B layout come from mrf_mma.cuh, the
// cluster's copies and barriers from cluster.cuh):
// - A thread-block cluster of C / 32 CTAs owns a 64-frame tile of one
//   batch row; CTA `rank` owns gate channels [32 rank, 32 rank + 32) with
//   the matching filter channels, and the same 32 channels of x' and of
//   skip.  At B = 1, T = 1000, C = 256 that is 16 clusters of 8: 128 CTAs.
//   C is 64, 128, 256 or 512 (clusters of 2, 4, 8 or 16; 16 is beyond the
//   portable cluster size of 8, so the kernel at 512 is allowed a
//   non-portable one); ops/denoiser_stack.py runs a narrower stack at the
//   next of them, with zero channels above its own (a zero gate channel
//   gives sigmoid(0) * tanh(0) = 0, so they stay zero).  At C = 256 a CTA
//   takes 107,648 bytes of shared memory, so two fit an SM and the card
//   holds 30 clusters at once (with a CTA a whole SM it holds 15); at
//   C = 512 a CTA takes 174,208 bytes, one an SM, and a cluster of 16 needs
//   16 SMs of one GPC.
// - One launch runs all L layers while a batch row's clusters fit the card
//   at once; a request with more rows than fit runs as a few such launches,
//   each over as many rows as fit.  These launches are cooperative: the
//   runtime starts one only when all its CTAs can be resident, which the
//   tiles' waits on each other need.  A CTA keeps its own rows of x, their
//   y0 and its skip sums in registers across the layers.  A tile depends
//   only on its two neighbours (the k = 3 halo): at the end of a layer a
//   CTA sends the first and last row of its x' to them as 64-bit words
//   tagged with the layer, and the next layer polls for exactly those
//   words; x reaches device memory only after the last layer.  A sequence
//   too long for a batch row to fit at once runs one launch per layer
//   instead (each after the first launched early, waiting in
//   griddepcontrol.wait), reading and writing x and skip in device memory.
// - The weights (each layer's conv 3C x 64 and output-projection C x 64
//   columns of the CTA, bf16, laid out at stacking time in wgmma's order by
//   ops/denoiser_stack.py::denoiser_kernel_weights) are one sequence of
//   8 KB chunks through a ring of five slots, landed by cp.async.bulk on
//   one mbarrier per slot; a slot is refilled as soon as the wgmmas that
//   read it have completed, so the next layer's first chunks land during
//   this layer's output projection.
// - Per layer each CTA builds its 32 channels of the tile's y (rows
//   t0 - 1 .. t0 + 64 with the halo; condp read before the wait for the
//   neighbours), and both y and, after the gate, g are all-gathered across
//   the cluster: each CTA's slice is one contiguous run of its tile, sent
//   by one bulk copy from shared memory to each other CTA's shared memory,
//   completing on that CTA's mbarrier.  No cluster barrier runs between the
//   start and the end: a CTA sends layer l's y only after it has every
//   other CTA's g of layer l - 1 (so they are past their conv and done with
//   y), and g only after every other CTA's y of layer l (so they are past
//   their output projection and done with g).
// - The tiles are K-major without swizzle, [C / 8 channel blocks][rows]
//   [8 channels], so a row is a 16-byte core-matrix row and both products
//   take A from shared memory by descriptor (wgmma m64n64k16, M = 64 frames,
//   N = 32 gate + 32 filter columns, or 32 x' + 32 skip columns): the k = 3
//   conv is an implicit GEMM (K = 3C) whose tap t is a descriptor t rows
//   down the y tile.  A chunk's four wgmmas issue back to back as one group,
//   two groups in flight.  The gate epilogue stays in registers: a thread
//   holds each gate column and its filter column.  Each CTA owns its x' and
//   skip columns: no atomics, the same result every run.
// - Every wait that could fail to complete traps (mbar_wait, get_halo)
//   instead of holding the card.
// - Above C = 512 (a cluster would need more than 16 CTAs) the stack runs
//   the wide route instead, two launches a layer with y and g built per
//   K chunk and g in device memory: wide_conv_gate and wide_out_proj below.

#include "cluster.cuh"
#include "mrf_mma.cuh"

// Phase stamps, empty here; tests/bench_torch_denoiser.py defines them to
// time each phase of a CTA.
#ifndef STAMP
#define STAMP(i)
#endif

namespace {

constexpr int kGroup = 32;               // gate channels (and x', skip channels) per CTA
constexpr int kN = 2 * kGroup;           // wgmma N: a CTA's gate and filter columns
constexpr int kTile = 64;                // frames per cluster: one m64 wgmma tile
constexpr int kRowsY = kTile + 2;        // with the k = 3 halo
constexpr int kThreads = 128;            // one warpgroup
constexpr int kSlabBytes = 16 * kN * 2;  // one 16-deep K slab of B
constexpr int kChunkSteps = 4;           // K steps per weight chunk (8 KB)
constexpr int kSlots = 5;                // chunks in shared memory at once
constexpr int kInFlight = 2;             // wgmma groups (chunks) in flight

template <int C>
struct Layout {
  static_assert(C == 64 || C == 128 || C == 256 || C == 512, "C must be 64, 128, 256 or 512");
  static constexpr int kRanks = C / kGroup;        // CTAs per cluster
  static constexpr int kConvSteps = 3 * C / 16;    // K = 3C
  static constexpr int kOutSteps = C / 16;         // K = C
  static constexpr int kConvChunks = kConvSteps / kChunkSteps;
  static constexpr int kChunks = kConvChunks + kOutSteps / kChunkSteps;
  static constexpr int kChunkBytes = kChunkSteps * kSlabBytes;
  static_assert(kConvSteps % kChunkSteps == 0 && kOutSteps % kChunkSteps == 0, "whole chunks");
  // shared memory: mbarriers, the weight ring, the y tile and the g tile,
  // each K-major without swizzle: [C / 8 channel blocks][rows][8 channels]
  static constexpr int kRing = 128;
  static constexpr int kY = kRing + kSlots * kChunkBytes;
  static constexpr int kG = kY + kRowsY * C * 2;
  static constexpr int kBytes = kG + kTile * C * 2;
};

// Byte offset of (row, channel c) in a tile of `rows` rows.
__device__ __forceinline__ int tile_at(int rows, int row, int c) {
  return ((c / 8) * rows + row) * 16 + (c % 8) * 2;
}

__device__ __forceinline__ float sigmoid(float v) { return __fdividef(1.f, 1.f + __expf(-v)); }

__device__ __forceinline__ float tanh_f(float v) { return __fdividef(2.f, 1.f + __expf(-2.f * v)) - 1.f; }

// --- programmatic dependent launch -----------------------------------------

// Wait until the grid before this one in the stream has completed and its
// writes are visible (a no-op for a launch without the PDL attribute).
__device__ __forceinline__ void wait_prior_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void allow_next_grid() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// A halo value travels between tiles as one 64-bit word, the value in the
// low half and the layer it belongs to in the high half: an aligned 8-byte
// store is seen whole, so the reader polls the word itself (no flag, no
// fence).  A wait that never completes traps after ~2^26 polls instead of
// holding the card.
__device__ __forceinline__ void put_halo(unsigned long long* at, float v, int tag) {
  const unsigned long long w = ((unsigned long long)(uint32_t)tag << 32) | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;\n" :: "l"(at), "l"(w) : "memory");
}

__device__ __forceinline__ float get_halo(const unsigned long long* at, int tag) {
  for (uint32_t polls = 0;; ++polls) {
    unsigned long long w;
    asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];\n" : "=l"(w) : "l"(at) : "memory");
    if ((int)(w >> 32) == tag) return __uint_as_float((uint32_t)w);
    if (polls == (1u << 26)) __trap();
  }
}

// --- the weight ring and the two products ----------------------------------

// The weights a CTA reads are one sequence of 16-deep K slabs: per layer
// from l_begin, the conv's 3C / 16 (tap-major), then the output
// projection's C / 16.  Chunk q (kChunkSteps slabs) lives in ring slot
// q % kSlots and completes on mbarrier q % kSlots, phase q / kSlots.
template <int C>
struct Ring {
  const __nv_bfloat16* conv_w;   // layer l_begin's conv slabs of this CTA
  const __nv_bfloat16* out_w;    // its output-projection slabs
  uint32_t bar, slots;
  int n_chunks;                  // chunks of all the layers this CTA runs

  // issue chunk q's copy (one thread)
  __device__ __forceinline__ void load(int q) const {
    using S = Layout<C>;
    const int l = q / S::kChunks, c = q % S::kChunks;
    const __nv_bfloat16* src = c < S::kConvChunks
        ? conv_w + (size_t)l * 3 * C * 2 * C + (size_t)c * kChunkSteps * 16 * kN
        : out_w + (size_t)l * C * 2 * C + (size_t)(c - S::kConvChunks) * kChunkSteps * 16 * kN;
    const uint32_t full = bar + 8 * (q % kSlots);
    mbar_expect_tx(full, S::kChunkBytes);
    bulk_copy(slots + (q % kSlots) * S::kChunkBytes, src, S::kChunkBytes, full);
  }
};

// acc (64 x kN, fp32) = A (64 x 16 n_chunks kChunkSteps, bf16; step st's
// descriptor a_desc(st)) times the ring's chunks q0 .. q0 + n_chunks - 1.
// Each chunk's wgmmas issue back to back as one group once its weights
// have landed; with kInFlight groups in flight (fewer if the pass is
// shorter), the slot of the chunk that completes is refilled (thread 0)
// kSlots chunks ahead.
template <int C, int kChunksHere, class ADesc>
__device__ __forceinline__ void mma_pass(float (&acc)[kN / 2], ADesc a_desc, const Ring<C>& ring,
                                         int q0) {
  constexpr int kFly = kChunksHere < kInFlight ? kChunksHere : kInFlight;
  auto retire = [&](int q) {   // chunk q's wgmmas have completed
    if (threadIdx.x == 0 && q + kSlots < ring.n_chunks) ring.load(q + kSlots);
  };
  wgmma_fence();
#pragma unroll 1
  for (int i = 0; i < kChunksHere; ++i) {
    const int q = q0 + i;
    mbar_wait(ring.bar + 8 * (q % kSlots), (uint32_t)((q / kSlots) & 1));
    const uint32_t b = ring.slots + (q % kSlots) * Layout<C>::kChunkBytes;
#pragma unroll
    for (int k = 0; k < kChunkSteps; ++k) {
      const int st = i * kChunkSteps + k;
      wgmma_ss(acc, a_desc(st), slab_desc(b + k * kSlabBytes), st > 0);
    }
    wgmma_commit();
    if (i >= kFly - 1) {
      wgmma_wait<kFly - 1>();            // chunk q - kFly + 1 has completed
      retire(q - kFly + 1);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < kN / 2; ++j) fence_reg(acc[j]);
#pragma unroll
  for (int i = kChunksHere - kFly + 1; i < kChunksHere; ++i) retire(q0 + i);
}

// All-gather of a tile across the cluster: this CTA's 32 channels of it
// (`rows` rows: 4 channel blocks, one contiguous run of bytes), written by
// its threads, go to the same place in every other CTA, each copy
// completing on that CTA's mbarrier `bar`; then this CTA waits on its own
// `bar` (phase `parity`) for the other CTAs' channels.  A CTA sends layer
// l's y only after it has received every other CTA's g of layer l - 1 (so
// they are past their conv of l - 1 and done with their y tile), and g only
// after every other CTA's y of layer l (so they are past their output
// projection of l - 1 and done with their g tile).
template <int C>
__device__ __forceinline__ void all_gather(uint32_t base, int tile, int rows, int ch0,
                                           uint32_t rank, uint32_t bar, uint32_t parity) {
  using S = Layout<C>;
  const uint32_t slice = base + tile + ch0 / 8 * rows * 16, bytes = rows * kGroup * 2;
  fence_proxy_async();        // this thread's part of the slice, for the copies and wgmma
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, (S::kRanks - 1) * bytes);
    for (int k = 1; k < S::kRanks; ++k) {
      const uint32_t peer = (rank + k) % S::kRanks;
      bulk_copy_peer(map_rank(slice, peer), slice, bytes, map_rank(bar, peer));
    }
  }
  mbar_wait(bar, parity);
}

// Layers l_begin .. l_end - 1 of batch rows b0 .. b0 + gridDim.y - 1.
// Grid (kRanks * ceil(T / 64), rows), clusters of kRanks CTAs along x,
// kThreads threads; two CTAs fit an SM at C = 256.  Layer l reads x_l
// (x for l = 0, then the ping-pong buffers, the last layer's output being
// x_out) and writes x_{l+1}.  Run over several layers (a cooperative
// launch: every CTA of the grid resident at once), a CTA keeps its own
// rows of x and its skip sums in registers, sends only the two rows of
// x_{l+1} its neighbour tiles need (tagged words in `halo`, [B, tiles,
// 2 layer parities, 2 edges, C]), and writes x only after its last layer.
// Run over one layer (one launch per layer), it waits for the grid before
// it where wait_prior is set, and reads and writes x and skip in device
// memory.
template <int C>
__global__ void __launch_bounds__(kThreads, 2)
residual_stack_mma(const float* __restrict__ x,               // [B, T, C]
                   const float* __restrict__ condp,           // [B, T, L, C], bias added
                   const float* __restrict__ step_proj,       // [L, B, C]
                   const __nv_bfloat16* __restrict__ conv_w,  // [L][C / 32][3C * 64], wgmma order
                   const float* __restrict__ conv_b,          // [L, 2C]
                   const __nv_bfloat16* __restrict__ out_w,   // [L][C / 32][C * 64], wgmma order
                   const float* __restrict__ out_b,           // [L, 2C]
                   float* x_out, float* scratch,              // [B, T, C] each
                   float* __restrict__ skip,                  // [B, T, C]
                   unsigned long long* __restrict__ halo,     // zeroed
                   int B, int T, int L, int l_begin, int l_end, int b0, int wait_prior) {
  using S = Layout<C>;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_addr(smem);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const uint32_t rank = cluster_rank();
  const int tiles = (T + kTile - 1) / kTile, tile = blockIdx.x / S::kRanks;
  const int b = b0 + blockIdx.y, t0 = tile * kTile, ch0 = rank * kGroup;
  const size_t row0 = (size_t)b * T;
  // the tagged halo words of tile k, edge e (0: first row, 1: last row) of x_l
  auto halo_at = [&](int k, int l, int e) {
    return halo + ((((size_t)b * tiles + k) * 2 + l % 2) * 2 + e) * C;
  };
  const Ring<C> ring{conv_w + (size_t)rank * 3 * C * kN + (size_t)l_begin * 3 * C * 2 * C,
                     out_w + (size_t)rank * C * kN + (size_t)l_begin * C * 2 * C, base,
                     base + S::kRing, (l_end - l_begin) * S::kChunks};
  auto buffer = [&](int l) { return ((L - 1 - l) % 2 == 0) ? x_out : scratch; };   // x_{l+1}
  STAMP(0)

  const uint32_t y_bar = base + 8 * kSlots, g_bar = y_bar + 8;   // the two all-gathers
  if (tid == 0) {
    for (int i = 0; i < kSlots + 2; ++i) mbar_init(base + 8 * i, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {   // the weights do not depend on the layer before
    for (int q = 0; q < kSlots && q < ring.n_chunks; ++q) ring.load(q);
  }
  allow_next_grid();          // the next launch may start and load its weights
  cluster_arrive();           // this CTA's mbarriers are ready (waited for before any copy)

  // This thread's elements of the tile are those of wgmma's accumulator
  // layout: acc[4 j + 2 h + e] is output row r_lo + 8 h, column 8 j + c_lo
  // + e, for this CTA's 32 channels; it keeps x, y0 and the skip sums of
  // those elements.  Threads 0..31 also build the two halo rows of y.
  const int r_lo = warp * 16 + lane / 4, c_lo = 2 * (lane % 4);
  float2 xr[kGroup / 8][2], y0[kGroup / 8][2], sk[kGroup / 8][2];
  const int halo_row = tid < 16 ? 0 : kRowsY - 1, halo_c = ch0 + 2 * (tid % 16);
  const int halo_t = t0 - 1 + halo_row;
  constexpr int kStepsPerTap = C / 16;
  const float kRsqrt2 = 0.70710678118654752f;

  for (int l = l_begin; l < l_end; ++l) {
    const float* cur = l == 0 ? x : buffer(l - 1);
    float* nxt = buffer(l);
    // condp and step_proj first (they do not depend on the layer before)
    const float* cp = condp + (row0 * L + l) * C;   // frame t at cp + t L C
    const float* sp = step_proj + ((size_t)l * B + b) * C;
    float2 cv[kGroup / 8][2], spv[kGroup / 8];
#pragma unroll
    for (int j = 0; j < kGroup / 8; ++j) {
      const int c = ch0 + 8 * j + c_lo;
      spv[j] = __ldg(reinterpret_cast<const float2*>(sp + c));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = t0 + r_lo + 8 * h;
        cv[j][h] = make_float2(0.f, 0.f);
        if (t < T) cv[j][h] = __ldg(reinterpret_cast<const float2*>(cp + (size_t)t * L * C + c));
      }
    }
    float2 hc = make_float2(0.f, 0.f), hs = make_float2(0.f, 0.f), hx = make_float2(0.f, 0.f);
    const bool in_halo = tid < 32 && halo_t >= 0 && halo_t < T;
    if (in_halo) {
      hc = __ldg(reinterpret_cast<const float2*>(cp + (size_t)halo_t * L * C + halo_c));
      hs = __ldg(reinterpret_cast<const float2*>(sp + halo_c));
    }
    if (l == l_begin) {
      if (wait_prior) wait_prior_grid();   // the launch before has written x and skip
      STAMP(1)
#pragma unroll
      for (int j = 0; j < kGroup / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = t0 + r_lo + 8 * h;
          const size_t at = (row0 + t) * C + ch0 + 8 * j + c_lo;
          xr[j][h] = sk[j][h] = make_float2(0.f, 0.f);
          if (t < T) {
            xr[j][h] = __ldcg(reinterpret_cast<const float2*>(cur + at));
            if (l_begin > 0) sk[j][h] = __ldcg(reinterpret_cast<const float2*>(skip + at));
          }
        }
      if (in_halo) hx = __ldcg(reinterpret_cast<const float2*>(cur + (row0 + halo_t) * C + halo_c));
    } else if (in_halo) {
      // the row before the tile is the last row of tile - 1, the row after
      // it the first row of tile + 1, once their CTAs have sent them
      const unsigned long long* at = halo_row == 0 ? halo_at(tile - 1, l, 1) + halo_c
                                                   : halo_at(tile + 1, l, 0) + halo_c;
      hx = make_float2(get_halo(at, l), get_halo(at + 1, l));
    }
    if (l > l_begin) {
      STAMP(1)
    }

    // y0 = x + step_proj;  y = bf16((y0 + condp) * [0 <= t < T]), into tile
    // row r + 1 for output row r
    uint32_t yv[kGroup / 8][2];
#pragma unroll
    for (int j = 0; j < kGroup / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        y0[j][h] = make_float2(xr[j][h].x + spv[j].x, xr[j][h].y + spv[j].y);
        yv[j][h] = t0 + r_lo + 8 * h < T
            ? pack_bf16(y0[j][h].x + cv[j][h].x, y0[j][h].y + cv[j][h].y) : 0u;
      }
    const uint32_t hy = in_halo ? pack_bf16((hx.x + hs.x) + hc.x, (hx.y + hs.y) + hc.y) : 0u;
    if (l == l_begin) cluster_wait();   // every CTA of the cluster runs
#pragma unroll
    for (int j = 0; j < kGroup / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(smem + S::kY + tile_at(kRowsY, r_lo + 8 * h + 1,
                                                           ch0 + 8 * j + c_lo)) = yv[j][h];
    if (tid < 32)
      *reinterpret_cast<uint32_t*>(smem + S::kY + tile_at(kRowsY, halo_row, halo_c)) = hy;
    const uint32_t parity = (l - l_begin) & 1;
    all_gather<C>(base, S::kY, kRowsY, ch0, rank, y_bar, parity);
    STAMP(2)

    // z = conv_k3(y): K = 3C, tap-major; tap t reads the tile from row t
    const int q0 = (l - l_begin) * S::kChunks;
    const float* cb = conv_b + (size_t)l * 2 * C + ch0;
    const float* ob = out_b + (size_t)l * 2 * C + ch0;
    float acc[kN / 2];
    mma_pass<C, S::kConvChunks>(
        acc,
        [&](int st) {
          const int tap = st / kStepsPerTap, c0 = (st % kStepsPerTap) * 16;
          return kmajor_desc(base + S::kY + tile_at(kRowsY, tap, c0), kRowsY * 16, 128);
        },
        ring, q0);
    STAMP(3)

    // g = bf16(sigmoid(z_gate + b) * tanh(z_filter + b)); the filter column
    // of gate column n is n + 32, 16 accumulators further
    uint32_t gv[kGroup / 8][2];
#pragma unroll
    for (int j = 0; j < kGroup / 8; ++j) {
      const int n = 8 * j + c_lo;
      const float2 bg = __ldg(reinterpret_cast<const float2*>(cb + n));
      const float2 bf = __ldg(reinterpret_cast<const float2*>(cb + C + n));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = 4 * j + 2 * h;
        gv[j][h] = pack_bf16(sigmoid(acc[e] + bg.x) * tanh_f(acc[e + 16] + bf.x),
                             sigmoid(acc[e + 1] + bg.y) * tanh_f(acc[e + 17] + bf.y));
      }
    }
    STAMP(4)
#pragma unroll
    for (int j = 0; j < kGroup / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(smem + S::kG + tile_at(kTile, r_lo + 8 * h,
                                                           ch0 + 8 * j + c_lo)) = gv[j][h];
    all_gather<C>(base, S::kG, kTile, ch0, rank, g_bar, parity);
    STAMP(5)

    // o = g @ out_w for this CTA's x' and skip columns: K = C
    mma_pass<C, S::kOutSteps / kChunkSteps>(
        acc,
        [&](int st) {
          return kmajor_desc(base + S::kG + tile_at(kTile, 0, 16 * st), kTile * 16, 128);
        },
        ring, q0 + S::kConvChunks);
    STAMP(6)

    // x' = (o_x + out_b + y0) / sqrt(2), kept for the next layer, its edge
    // rows sent to the neighbour tiles, written to device memory after the
    // last layer;  skip += o_skip + out_b
    const bool last = l + 1 == l_end;
#pragma unroll
    for (int j = 0; j < kGroup / 8; ++j) {
      const int n = 8 * j + c_lo;
      const float2 bx = __ldg(reinterpret_cast<const float2*>(ob + n));
      const float2 bs = __ldg(reinterpret_cast<const float2*>(ob + C + n));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r_lo + 8 * h, t = t0 + r, e = 4 * j + 2 * h;
        xr[j][h] = make_float2(((acc[e] + bx.x) + y0[j][h].x) * kRsqrt2,
                               ((acc[e + 1] + bx.y) + y0[j][h].y) * kRsqrt2);
        sk[j][h] = make_float2(sk[j][h].x + (acc[e + 16] + bs.x), sk[j][h].y + (acc[e + 17] + bs.y));
        if (t < T && last) *reinterpret_cast<float2*>(nxt + (row0 + t) * C + ch0 + n) = xr[j][h];
        if (t < T && !last && (r == 0 || r == kTile - 1)) {
          unsigned long long* at = halo_at(tile, l + 1, r != 0) + ch0 + n;
          put_halo(at, xr[j][h].x, l + 1);
          put_halo(at + 1, xr[j][h].y, l + 1);
        }
      }
    }
    STAMP(7)
  }
#pragma unroll
  for (int j = 0; j < kGroup / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t0 + r_lo + 8 * h;
      if (t < T) *reinterpret_cast<float2*>(skip + (row0 + t) * C + ch0 + 8 * j + c_lo) = sk[j][h];
    }
  // no CTA leaves while a copy from or to its shared memory may run
  cluster_arrive();
  cluster_wait();
  STAMP(8)
}

// attrs[0]: the cluster shape; attrs[1], where numAttrs is raised to 2:
// `second` (a cooperative launch, every CTA resident at once, or
// programmatic dependent launch).
template <int C>
cudaLaunchConfig_t launch_config(int rows, int T, cudaStream_t stream, cudaLaunchAttribute* attrs,
                                 cudaLaunchAttributeID second) {
  using S = Layout<C>;
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = S::kRanks;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = second;
  if (second == cudaLaunchAttributeCooperative)
    attrs[1].val.cooperative = 1;
  else
    attrs[1].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S::kRanks * ((T + kTile - 1) / kTile), rows, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = S::kBytes;
  cfg.stream = stream;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  return cfg;
}

// Raises the kernel's shared-memory limit on the current device (and, for
// clusters of more than 8 CTAs, allows a non-portable cluster size) and
// writes the clusters that device holds at once to *out.
template <int C>
int max_active_clusters(int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      residual_stack_mma<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<C>::kBytes);
  if (err == cudaSuccess && Layout<C>::kRanks > 8)
    err = cudaFuncSetAttribute(residual_stack_mma<C>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attrs[2];
  const cudaLaunchConfig_t cfg =
      launch_config<C>(1, 1000, nullptr, attrs, cudaLaunchAttributeProgrammaticStreamSerialization);
  return (int)cudaOccupancyMaxActiveClusters(
      out, reinterpret_cast<const void*>(residual_stack_mma<C>), &cfg);
}

// max_active_clusters, worked out once for each device the process uses.
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
  const int e = max_active_clusters<C>(out);
  if (e == 0 && dev < kDevices) known[dev] = *out + 1;
  return e;
}

// The L layers as few launches as the card holds: while a batch row's
// clusters all fit at once, each launch runs every layer for as many batch
// rows as fit, as a cooperative launch (all its CTAs resident at once,
// which its tiles' waits on each other need, whatever else runs on the
// card), after one memset of the halo words (their layer tags repeat from
// call to call); otherwise one launch per layer, each after the first
// launched early (programmatic dependent launch) to wait in the kernel for
// the one before.  *launches gets the number of launches.
template <int C>
int run_stack(const float* x, const float* condp, const float* step_proj,
              const __nv_bfloat16* conv_w, const float* conv_b, const __nv_bfloat16* out_w,
              const float* out_b, float* x_out, float* skip, float* scratch,
              unsigned long long* halo, int B, int T, int L, cudaStream_t stream, int* launches) {
  using S = Layout<C>;
  int resident = 0;   // clusters the card holds at once
  const int e = resident_clusters<C>(&resident);
  if (e != 0) return e;
  cudaLaunchAttribute attrs[2];
  const int tiles = (T + kTile - 1) / kTile;
  cudaError_t err = cudaSuccess;
  *launches = 0;
  if (tiles <= resident) {
    const int fit = resident / tiles, n = (B + fit - 1) / fit, rows = (B + n - 1) / n;
    err = cudaMemsetAsync(halo, 0, sizeof(unsigned long long) * (size_t)B * tiles * 4 * C, stream);
    for (int b0 = 0; err == cudaSuccess && b0 < B; b0 += rows) {
      cudaLaunchConfig_t cfg =
          launch_config<C>(min(rows, B - b0), T, stream, attrs, cudaLaunchAttributeCooperative);
      cfg.numAttrs = 2;
      err = cudaLaunchKernelEx(&cfg, residual_stack_mma<C>, x, condp, step_proj, conv_w, conv_b,
                               out_w, out_b, x_out, scratch, skip, halo, B, T, L, 0, L, b0, 0);
      *launches += err == cudaSuccess;
    }
  } else {
    cudaLaunchConfig_t cfg =
        launch_config<C>(B, T, stream, attrs, cudaLaunchAttributeProgrammaticStreamSerialization);
    for (int l = 0; err == cudaSuccess && l < L; ++l) {
      cfg.numAttrs = l > 0 ? 2 : 1;
      err = cudaLaunchKernelEx(&cfg, residual_stack_mma<C>, x, condp, step_proj, conv_w, conv_b,
                               out_w, out_b, x_out, scratch, skip, halo, B, T, L, l, l + 1, 0, 1);
      *launches += err == cudaSuccess;
    }
  }
  return (int)err;
}

// --- the wide route: C > 512, two launches a layer --------------------------
//
// Past C = 512 a cluster of C / 32 CTAs would exceed the 16 an H100 runs,
// and one CTA cannot hold a frame tile's y and g either (66 C and 64 C bf16:
// 135 KB and 131 KB at C = 1024).  So each layer runs as two launches whose
// operands go through device memory, for any C that is a multiple of
// kWideK (ops/denoiser_stack.py pads to it with zero channels):
// - wide_conv_gate: CTA (n, tile, b) computes gate columns [32 n, 32 n + 32)
//   and their filter columns of a 64-frame tile (wgmma m64n64k16, the same
//   B layout as residual_stack_mma's).  K = 3C runs as C / kWideK chunks of
//   kWideK input channels: per chunk the CTA builds y = bf16((x + step_proj)
//   + condp) on those channels for rows t0 - 1 .. t0 + 64 (two buffers, the
//   next built while the last one's wgmmas run) and the chunk's three taps
//   of weights (three 8 KB runs) land through a ring of kConvSlots slots by
//   cp.async.bulk.  The gate runs in the epilogue; g goes to device memory
//   in bf16, as [B, tiles, C / 8, 64, 8], a tile's channel block of 8 one
//   K-major core-matrix column.
// - wide_out_proj: CTA (n, tile, b) computes x' columns [32 n, 32 n + 32) and
//   the same skip columns: K = C in chunks of kWideK, each chunk's g (8 KB,
//   one contiguous run of that layout) and weights (8 KB) landing in one
//   ring slot.  The epilogue reads x and step_proj again for y0, writes x'
//   to the other of two buffers and adds into skip.
// Every CTA owns its output columns: no atomics, the same bits every run.
// The 2 L launches are chained by programmatic dependent launch: each loads
// its first weight chunks, lets the next launch start, and waits in
// griddepcontrol.wait for the one before.
//
// What bounds it: operations, 16 T C^2 FLOP a layer and batch row (0.339 ms
// at B = 1, T = 1000, C = 1024, L = 20).  This first design rebuilds y in
// every CTA of a tile (C / 32 of them) from fp32 x and condp, which L2
// serves: it is right first, and fast later.

constexpr int kWideK = 64;                              // input channels per K chunk
constexpr int kWideSteps = kWideK / 16;                 // 16-deep K steps per tap and chunk
constexpr int kTapBytes = kWideK * kN * 2;              // one tap's weights of a chunk: 8 KB
constexpr int kConvSlots = 3;                           // conv weight chunks in shared memory
constexpr int kConvSlotBytes = 3 * kTapBytes;           // a chunk's three taps
constexpr int kYChunkBytes = kRowsY * kWideK * 2;       // y rows t0 - 1 .. t0 + 64, kWideK channels
constexpr int kConvY = 128 + kConvSlots * kConvSlotBytes;
constexpr int kConvBytes = kConvY + 2 * kYChunkBytes;   // 90,752: two CTAs an SM
constexpr int kOutSlots = 4;                            // output-projection chunks
constexpr int kGChunkBytes = kTile * kWideK * 2;        // g of a chunk: 8 KB
constexpr int kOutSlotBytes = kGChunkBytes + kTapBytes; // g, then the weights
constexpr int kOutBytes = 128 + kOutSlots * kOutSlotBytes;   // 65,664: three CTAs an SM

// Layer l's conv: g = bf16(sigmoid(z_gate + b) tanh(z_filter + b)), z = the
// k = 3 conv of y = bf16((x + step_proj[l]) + condp[l]) (zero outside
// [0, T)).  Grid (C / 32, ceil(T / 64), B).
__global__ void __launch_bounds__(kThreads, 2)
wide_conv_gate(const float* __restrict__ x,               // x_l [B, T, C]
               const float* __restrict__ condp,           // [B, T, L, C], bias added
               const float* __restrict__ step_proj,       // [L, B, C]
               const __nv_bfloat16* __restrict__ conv_w,  // layer l's [C / 32][3C * 64], wgmma order
               const float* __restrict__ conv_b,          // layer l's [2C]
               __nv_bfloat16* __restrict__ g,             // [B, tiles, C / 8, 64, 8]
               int B, int T, int C, int L, int l) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_addr(smem), bar = base, slots = base + 128;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ch0 = blockIdx.x * kGroup, tile = blockIdx.y, b = blockIdx.z, t0 = tile * kTile;
  const int tiles = gridDim.y, n_chunks = C / kWideK;
  const size_t row0 = (size_t)b * T;
  const __nv_bfloat16* w = conv_w + (size_t)blockIdx.x * 3 * C * kN;
  // chunk q's three taps: K rows tap C + q kWideK .. + kWideK of this CTA's columns
  auto load = [&](int q) {
    const uint32_t full = bar + 8 * (q % kConvSlots), dst = slots + (q % kConvSlots) * kConvSlotBytes;
    mbar_expect_tx(full, kConvSlotBytes);
    for (int tap = 0; tap < 3; ++tap)
      bulk_copy(dst + tap * kTapBytes, w + ((size_t)tap * C + q * kWideK) * kN, kTapBytes, full);
  };
  auto retire = [&](int q) {   // chunk q's wgmmas have completed
    if (tid == 0 && q + kConvSlots < n_chunks) load(q + kConvSlots);
  };
  if (tid == 0) {
    for (int i = 0; i < kConvSlots; ++i) mbar_init(bar + 8 * i, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0)   // the weights do not depend on the launch before
    for (int q = 0; q < kConvSlots && q < n_chunks; ++q) load(q);
  allow_next_grid();
  wait_prior_grid();   // x_l is the launch before's output

  // y of chunk q into buffer q % 2, K-major [kWideK / 8][kRowsY][8]: item i
  // is row i / 8 (frame t0 - 1 + row), channel block i % 8
  const float* sp = step_proj + ((size_t)l * B + b) * C;
  auto build = [&](int q) {
    unsigned char* buf = smem + kConvY + (q % 2) * kYChunkBytes;
    for (int i = tid; i < kRowsY * (kWideK / 8); i += kThreads) {
      const int r = i / (kWideK / 8), cb = i % (kWideK / 8), t = t0 - 1 + r;
      const int c = q * kWideK + 8 * cb;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (t >= 0 && t < T) {
        const float4* xp = reinterpret_cast<const float4*>(x + (row0 + t) * C + c);
        const float4* cp = reinterpret_cast<const float4*>(condp + ((row0 + t) * L + l) * C + c);
        const float4* s = reinterpret_cast<const float4*>(sp + c);
        const float4 x0 = __ldcg(xp), x1 = __ldcg(xp + 1), c0 = __ldg(cp), c1 = __ldg(cp + 1);
        const float4 s0 = __ldg(s), s1 = __ldg(s + 1);
        v = make_uint4(pack_bf16((x0.x + s0.x) + c0.x, (x0.y + s0.y) + c0.y),
                       pack_bf16((x0.z + s0.z) + c0.z, (x0.w + s0.w) + c0.w),
                       pack_bf16((x1.x + s1.x) + c1.x, (x1.y + s1.y) + c1.y),
                       pack_bf16((x1.z + s1.z) + c1.z, (x1.w + s1.w) + c1.w));
      }
      *reinterpret_cast<uint4*>(buf + (cb * kRowsY + r) * 16) = v;
    }
    fence_proxy_async();   // for wgmma
    __syncthreads();
  };

  float acc[kN / 2];
  build(0);
#pragma unroll 1
  for (int q = 0; q < n_chunks; ++q) {
    mbar_wait(bar + 8 * (q % kConvSlots), (uint32_t)((q / kConvSlots) & 1));
    const uint32_t y = base + kConvY + (q % 2) * kYChunkBytes;
    const uint32_t wq = slots + (q % kConvSlots) * kConvSlotBytes;
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < 3; ++tap)
#pragma unroll
      for (int k = 0; k < kWideSteps; ++k)   // tap t reads the y chunk from row t
        wgmma_ss(acc, kmajor_desc(y + tile_at(kRowsY, tap, 16 * k), kRowsY * 16, 128),
                 slab_desc(wq + tap * kTapBytes + k * kSlabBytes), q > 0 || tap > 0 || k > 0);
    wgmma_commit();
    if (q + 1 < n_chunks) {
      wgmma_wait<1>();   // chunk q - 1 has completed: its slot and y buffer are free
      if (q > 0) retire(q - 1);
      build(q + 1);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < kN / 2; ++j) fence_reg(acc[j]);

  // g = bf16(sigmoid(z_gate + b) * tanh(z_filter + b)), as residual_stack_mma
  const int r_lo = warp * 16 + lane / 4, c_lo = 2 * (lane % 4);
  __nv_bfloat16* gt = g + ((size_t)b * tiles + tile) * C * kTile;
#pragma unroll
  for (int j = 0; j < kGroup / 8; ++j) {
    const int n = 8 * j + c_lo, c = ch0 + n;
    const float2 bg = __ldg(reinterpret_cast<const float2*>(conv_b + c));
    const float2 bf = __ldg(reinterpret_cast<const float2*>(conv_b + C + c));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = 4 * j + 2 * h, r = r_lo + 8 * h;
      *reinterpret_cast<uint32_t*>(gt + ((size_t)(c / 8) * kTile + r) * 8 + c % 8) =
          pack_bf16(sigmoid(acc[e] + bg.x) * tanh_f(acc[e + 16] + bf.x),
                    sigmoid(acc[e + 1] + bg.y) * tanh_f(acc[e + 17] + bf.y));
    }
  }
}

// Layer l's output projection: o = g @ out_w + out_b; x_next = (o_x + x +
// step_proj[l]) / sqrt(2); skip += o_skip (skip = o_skip at l = 0).  Grid
// (C / 32, ceil(T / 64), B).
__global__ void __launch_bounds__(kThreads, 3)
wide_out_proj(const float* __restrict__ x,                // x_l [B, T, C]
              const float* __restrict__ step_proj,        // [L, B, C]
              const __nv_bfloat16* __restrict__ g,        // [B, tiles, C / 8, 64, 8]
              const __nv_bfloat16* __restrict__ out_w,    // layer l's [C / 32][C * 64], wgmma order
              const float* __restrict__ out_b,            // layer l's [2C]
              float* __restrict__ x_next,                 // [B, T, C]
              float* __restrict__ skip,                   // [B, T, C]
              int B, int T, int C, int l) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_addr(smem), bar = base, slots = base + 128;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ch0 = blockIdx.x * kGroup, tile = blockIdx.y, b = blockIdx.z, t0 = tile * kTile;
  const int n_chunks = C / kWideK;
  const size_t row0 = (size_t)b * T;
  const __nv_bfloat16* w = out_w + (size_t)blockIdx.x * C * kN;
  const __nv_bfloat16* gt = g + ((size_t)b * gridDim.y + tile) * C * kTile;
  auto slot = [&](int q) { return slots + (q % kOutSlots) * kOutSlotBytes; };
  auto full = [&](int q) { return bar + 8 * (q % kOutSlots); };
  auto load_w = [&](int q) {   // the slot's expected bytes cover both halves
    mbar_expect_tx(full(q), kOutSlotBytes);
    bulk_copy(slot(q) + kGChunkBytes, w + (size_t)q * kWideK * kN, kTapBytes, full(q));
  };
  auto load_g = [&](int q) {
    bulk_copy(slot(q), gt + (size_t)q * kWideK * kTile, kGChunkBytes, full(q));
  };
  auto retire = [&](int q) {   // chunk q's wgmmas have completed
    if (tid == 0 && q + kOutSlots < n_chunks) {
      load_w(q + kOutSlots);
      load_g(q + kOutSlots);
    }
  };
  if (tid == 0) {
    for (int i = 0; i < kOutSlots; ++i) mbar_init(bar + 8 * i, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0)   // the weights do not depend on the launch before
    for (int q = 0; q < kOutSlots && q < n_chunks; ++q) load_w(q);
  allow_next_grid();
  wait_prior_grid();   // g is the launch before's output
  if (tid == 0)
    for (int q = 0; q < kOutSlots && q < n_chunks; ++q) load_g(q);

  float acc[kN / 2];
#pragma unroll 1
  for (int q = 0; q < n_chunks; ++q) {
    mbar_wait(full(q), (uint32_t)((q / kOutSlots) & 1));
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kWideSteps; ++k)
      wgmma_ss(acc, kmajor_desc(slot(q) + tile_at(kTile, 0, 16 * k), kTile * 16, 128),
               slab_desc(slot(q) + kGChunkBytes + k * kSlabBytes), q > 0 || k > 0);
    wgmma_commit();
    if (q > 0) {
      wgmma_wait<1>();   // chunk q - 1 has completed
      retire(q - 1);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < kN / 2; ++j) fence_reg(acc[j]);

  // x' = (o_x + out_b + y0) / sqrt(2) with y0 = x + step_proj, as
  // residual_stack_mma keeps them in registers;  skip += o_skip + out_b
  const int r_lo = warp * 16 + lane / 4, c_lo = 2 * (lane % 4);
  const float* sp = step_proj + ((size_t)l * B + b) * C;
  const float kRsqrt2 = 0.70710678118654752f;
#pragma unroll
  for (int j = 0; j < kGroup / 8; ++j) {
    const int c = ch0 + 8 * j + c_lo;
    const float2 bx = __ldg(reinterpret_cast<const float2*>(out_b + c));
    const float2 bs = __ldg(reinterpret_cast<const float2*>(out_b + C + c));
    const float2 s = __ldg(reinterpret_cast<const float2*>(sp + c));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t0 + r_lo + 8 * h, e = 4 * j + 2 * h;
      if (t >= T) continue;
      const size_t at = (row0 + t) * C + c;
      const float2 xv = __ldcg(reinterpret_cast<const float2*>(x + at));
      const float2 y0 = make_float2(xv.x + s.x, xv.y + s.y);
      float2 sk = make_float2(0.f, 0.f);
      if (l > 0) sk = __ldcg(reinterpret_cast<const float2*>(skip + at));
      *reinterpret_cast<float2*>(x_next + at) =
          make_float2(((acc[e] + bx.x) + y0.x) * kRsqrt2, ((acc[e + 1] + bx.y) + y0.y) * kRsqrt2);
      *reinterpret_cast<float2*>(skip + at) =
          make_float2(sk.x + (acc[e + 16] + bs.x), sk.y + (acc[e + 17] + bs.y));
    }
  }
}

// The L layers of the wide route as 2 L launches, each after the first
// launched early (programmatic dependent launch).  Layer l reads x_l (x for
// l = 0, then the ping-pong buffers, the last layer's output being x_out).
int run_wide(const float* x, const float* condp, const float* step_proj,
             const __nv_bfloat16* conv_w, const float* conv_b, const __nv_bfloat16* out_w,
             const float* out_b, float* x_out, float* skip, float* scratch, __nv_bfloat16* g,
             int B, int T, int C, int L, cudaStream_t stream, int* launches) {
  *launches = 0;
  if (C % kWideK != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(wide_conv_gate,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kConvBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(wide_out_proj, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kOutBytes);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C / kGroup, (T + kTile - 1) / kTile, B);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.stream = stream;
  cfg.attrs = &attr;
  for (int l = 0; err == cudaSuccess && l < L; ++l) {
    const float* cur = l == 0 ? x : ((L - l) % 2 == 0 ? x_out : scratch);   // x_l
    float* nxt = (L - 1 - l) % 2 == 0 ? x_out : scratch;                     // x_{l+1}
    cfg.dynamicSmemBytes = kConvBytes;
    cfg.numAttrs = l > 0 ? 1 : 0;
    err = cudaLaunchKernelEx(&cfg, wide_conv_gate, cur, condp, step_proj,
                             conv_w + (size_t)l * 3 * C * 2 * C, conv_b + (size_t)l * 2 * C, g,
                             B, T, C, L, l);
    *launches += err == cudaSuccess;
    if (err != cudaSuccess) break;
    cfg.dynamicSmemBytes = kOutBytes;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, wide_out_proj, cur, step_proj, g,
                             out_w + (size_t)l * C * 2 * C, out_b + (size_t)l * 2 * C, nxt, skip,
                             B, T, C, l);
    *launches += err == cudaSuccess;
  }
  return (int)err;
}

// CTAs of wide_conv_gate the current device holds at once, into *out.
int wide_resident(int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(wide_conv_gate, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kConvBytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, wide_conv_gate, kThreads,
                                                         kConvBytes);
  *out = per_sm * sms;
  return (int)err;
}

}  // namespace

extern "C" {

// x [B, T, C]; condp [B, T, L, C]; step_proj [L, B, C]; conv_w [L, C / 32,
// 3C * 64] and out_w [L, C / 32, C * 64] bf16 in wgmma order
// (ops/denoiser_stack.py::denoiser_kernel_weights); conv_b, out_b [L, 2C].
// Writes x_out and skip [B, T, C]; scratch [B, T, C] holds every other
// layer's x where layers run one launch each; halo [B, ceil(T / 64), 4, C]
// 64-bit words carry the tiles' edge rows where one launch runs them all.
// Launches on `stream`, writes the number of launches to *launches, and
// returns the first CUDA error, or 0.
int denoiser_stack_bf16(const float* x, const float* condp, const float* step_proj,
                        const __nv_bfloat16* conv_w, const float* conv_b,
                        const __nv_bfloat16* out_w, const float* out_b, float* x_out,
                        float* skip, float* scratch, unsigned long long* halo, int B, int T,
                        int C, int L, void* stream, int* launches) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 64:
      return run_stack<64>(x, condp, step_proj, conv_w, conv_b, out_w, out_b, x_out, skip,
                           scratch, halo, B, T, L, s, launches);
    case 128:
      return run_stack<128>(x, condp, step_proj, conv_w, conv_b, out_w, out_b, x_out, skip,
                            scratch, halo, B, T, L, s, launches);
    case 256:
      return run_stack<256>(x, condp, step_proj, conv_w, conv_b, out_w, out_b, x_out, skip,
                            scratch, halo, B, T, L, s, launches);
    case 512:
      return run_stack<512>(x, condp, step_proj, conv_w, conv_b, out_w, out_b, x_out, skip,
                            scratch, halo, B, T, L, s, launches);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The wide route (C > 512, a multiple of 64): x, condp, step_proj and the
// weights as denoiser_stack_bf16 takes them; g [B, ceil(T / 64), C / 8, 64, 8]
// bf16 scratch.  Launches 2 L kernels on `stream`, writes their number to
// *launches, and returns the first CUDA error, or 0.
int denoiser_stack_wide_bf16(const float* x, const float* condp, const float* step_proj,
                             const __nv_bfloat16* conv_w, const float* conv_b,
                             const __nv_bfloat16* out_w, const float* out_b, float* x_out,
                             float* skip, float* scratch, __nv_bfloat16* g, int B, int T, int C,
                             int L, void* stream, int* launches) {
  if (C <= 512) return (int)cudaErrorInvalidValue;
  return run_wide(x, condp, step_proj, conv_w, conv_b, out_w, out_b, x_out, skip, scratch, g, B,
                  T, C, L, static_cast<cudaStream_t>(stream), launches);
}

// Dynamic shared memory a CTA of the C-channel kernel uses (above 512, the
// wide route's conv kernel, the larger of its two), or -1.
int denoiser_stack_smem_bytes(int C) {
  switch (C) {
    case 64: return Layout<64>::kBytes;
    case 128: return Layout<128>::kBytes;
    case 256: return Layout<256>::kBytes;
    case 512: return Layout<512>::kBytes;
    default: return C > 512 && C % kWideK == 0 ? kConvBytes : -1;
  }
}

// CTAs per cluster (one cluster per 64-frame tile) at width C (1 above 512:
// the wide route runs no clusters), or -1.
int denoiser_stack_cluster_size(int C) {
  switch (C) {
    case 64: return Layout<64>::kRanks;
    case 128: return Layout<128>::kRanks;
    case 256: return Layout<256>::kRanks;
    case 512: return Layout<512>::kRanks;
    default: return C > 512 && C % kWideK == 0 ? 1 : -1;
  }
}

// Clusters of the C-channel kernel the current device holds at once (above
// 512, CTAs of the wide route's conv kernel), into *out; returns the CUDA
// error, or 0.
int denoiser_stack_max_active_clusters(int C, int* out) {
  switch (C) {
    case 64: return resident_clusters<64>(out);
    case 128: return resident_clusters<128>(out);
    case 256: return resident_clusters<256>(out);
    case 512: return resident_clusters<512>(out);
    default: return C > 512 && C % kWideK == 0 ? wide_resident(out) : (int)cudaErrorInvalidValue;
  }
}

const char* denoiser_stack_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
