// A whole HiFi-GAN MRF stage at C = 256 in one launch, written by hand for
// Hopper (sm_90a), fp32 in, fp32 accumulation, fp32 out.
//
// Replaces the Pallas TPU kernel mixgantts_tpu/ops/pallas_vocoder.py::
// mrf_stack_streamed (body _kernel_streamed).  That kernel's grid is
// (B, tiles, 9): its inner axis walks the 9 (branch, pair) steps in order,
// streaming one step's weights at a time while the signal tile and the
// residual and branch-sum state stay in VMEM scratch.  Here the 9 steps are
// a loop inside the block, and every step's [k, C, C] weights stream through
// shared memory chunk by chunk (conv_rows in mrf_conv.cuh: the next chunk's
// loads are in flight, in registers, while the current one is used).  A
// second shared stage for cp.async would not fit beside the k = 11, d = 5
// pass (223 KB of 227 KB), and the loads left unhidden, each pass's first
// chunk, are 16 per block per stage at 64-frame tiles and 25 at 128.
//
// Math (as mrf_stack.cu): for each branch (kernel k), three residual pairs
// (dilation d)  y = y + conv_k(lrelu(conv_{k,d}(lrelu(y)) + b1)) + b2, each
// branch starting from x, SAME zero padding of [0, T) before every conv, and
// the output is the mean of the branch outputs.
//
// What bounds it on an H100: operations.  The stage does 252 C^2 FLOP per
// frame (132 GFLOP at B = 1, T = 8000: 1.97 ms at 67 TFLOP/s of fp32 on the
// CUDA cores); x in and the output out are 16 MB (5 us at 3.35 TB/s).
//
// Two problems, and what the design does about them:
// - The state does not fit in shared memory.  The TPU kept y and the branch
//   sum for a tile plus a 2 x 64-frame halo in VMEM; at C = 256 that is 2 KB
//   a frame, and 227 KB of shared memory holds ~110 frames.  So each block
//   keeps y in two slabs of device memory of its own (ping-pong between
//   pairs; 24.6 MB each at B = 1, T = 8000 and 33.6 MB at B = 4, T = 4096,
//   so not all of it stays in the 50 MB L2, but a pass moves at most
//   0.26 MB of slab against up to 5.8 MB of weight chunks), and the branch
//   sum in the output rows, which only this block writes.  Shared memory
//   holds only what one pass of pair_pass (the same code as mrf_stack.cu's
//   kernel) needs: lrelu(y) for 64 output frames plus the pair's halo, the
//   conv1 output, and the staged weight chunk.
// - Halo against parallelism.  One block per SM (the k = 11, d = 5 pass
//   takes 223 KB), so a tile has to be small enough for B * T / tile blocks
//   to fill the 132 SMs, and a small tile repeats a larger share of halo.
//   Two things cut the halo: each branch restarts from x, so it carries only
//   its own creep, sum of k/2 (d + 1) over its pairs (12, 36 and 60 frames
//   per side for k = 3, 7, 11, not the TPU's 64 for all); and after each
//   pair only the frames the remaining pairs still need are computed, so the
//   window shrinks pair by pair to the tile itself.  The caller picks the
//   tile (a multiple of 64) as the smallest that gives at most one block per
//   SM: 64 frames at B = 1, T = 8000 (125 blocks) and 128 at B = 4, T = 4096
//   (128 blocks).  Rounding each pair's window up to 64-frame passes, the
//   FLOPs executed over the FLOPs needed (recompute share) are 2.02 at tile
//   64 and 1.56 at 128, against 1.10 for the one-pair-per-launch kernel.
//
// Slabs hold frames from t0 - lead on, where t0 is the tile's first frame
// and lead the widest creep after a branch's first pair.  A pass's last
// rows may read slab rows that the previous pair did not write; those feed
// only output frames beyond what later pairs use, never the tile.

#include "mrf_conv.cuh"

namespace {

constexpr int kC = 256;               // the stage width this kernel is built for
constexpr int kSub = Shape<kC, 3>::kTile;   // output frames of one pass: 64
constexpr int kMaxSteps = 4;          // branches, and pairs per branch, a launch takes

struct Steps {
  int n_br, n_pair;
  int k[kMaxSteps];   // kernel size per branch
  int d[kMaxSteps];   // dilation per pair
};

// Frames per side that the pairs after pair p of a kernel-k branch still
// widen the window by.
__host__ __device__ inline int creep_after(const Steps& s, int k, int p) {
  int c = 0;
  for (int q = p + 1; q < s.n_pair; ++q) c += (k / 2) * (s.d[q] + 1);
  return c;
}

__host__ __device__ inline int passes(int tile, int creep) {
  return (tile + 2 * creep + kSub - 1) / kSub;
}

int mid_rows(int k) {
  switch (k) {
    case 3: return Shape<kC, 3>::kMid;
    case 7: return Shape<kC, 7>::kMid;
    default: return Shape<kC, 11>::kMid;
  }
}

size_t pass_smem(int k, int dil) {
  switch (k) {
    case 3: return Shape<kC, 3>::bytes(dil);
    case 7: return Shape<kC, 7>::bytes(dil);
    default: return Shape<kC, 11>::bytes(dil);
  }
}

int lead_of(const Steps& s) {
  int lead = 0;
  for (int br = 0; br < s.n_br; ++br) {
    const int c = creep_after(s, s.k[br], 0);
    lead = c > lead ? c : lead;
  }
  return lead;
}

// Slab rows a block reads or writes, counted from frame t0 - lead.
int slab_rows_of(const Steps& s, int tile) {
  const int lead = lead_of(s);
  int rows = 0;
  for (int br = 0; br < s.n_br; ++br) {
    const int k = s.k[br], h = k / 2;
    for (int p = 0; p < s.n_pair; ++p) {
      const int creep = creep_after(s, k, p), n = passes(tile, creep);
      const int first = lead - creep;            // the pair's first output row
      if (p + 1 < s.n_pair && first + n * kSub > rows) rows = first + n * kSub;
      const int read_end = first + (n - 1) * kSub - h + mid_rows(k) + h * s.d[p];
      if (p > 0 && read_end > rows) rows = read_end;
    }
  }
  return rows;
}

__global__ void __launch_bounds__(kThreads, 1)
mrf_stage_streamed(const float* __restrict__ x,   // [B, T, C]
                   float* __restrict__ out,       // [B, T, C]
                   float* __restrict__ slab0,     // [blocks, slab_rows, C]
                   float* __restrict__ slab1,
                   const float* __restrict__ w1,  // [n_br, n_pair, 11, C, C]
                   const float* __restrict__ b1,  // [n_br, n_pair, C]
                   const float* __restrict__ w2,
                   const float* __restrict__ b2,
                   int T, int tile, int lead, int slab_rows, Steps s) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int t0 = blockIdx.x * tile;
  const size_t row = (size_t)blockIdx.y * T * kC;
  const size_t blk = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  float* slabs[2] = {slab0 + blk * slab_rows * kC, slab1 + blk * slab_rows * kC};
  const int s0 = t0 - lead;   // frame of slab row 0

  for (int br = 0; br < s.n_br; ++br) {
    const int k = s.k[br];
    const int pad = (kTaps - k) / 2;
    for (int p = 0; p < s.n_pair; ++p) {
      const bool last = p == s.n_pair - 1;
      const size_t step = (size_t)br * s.n_pair + p;
      const float* w1p = w1 + (step * kTaps + pad) * kC * kC;
      const float* w2p = w2 + (step * kTaps + pad) * kC * kC;
      const float* b1p = b1 + step * kC;
      const float* b2p = b2 + step * kC;
      // pair 0 reads x; the last pair adds the branch into the output rows
      const float* src = p == 0 ? x + row : slabs[(p - 1) & 1];
      const int src0 = p == 0 ? 0 : s0;
      float* dst = last ? out + row : slabs[p & 1];
      const int dst0 = last ? 0 : s0;
      const int accumulate = last && br > 0;
      const float scale = last && br == s.n_br - 1 ? 1.f / (float)s.n_br : 1.f;
      const int creep = creep_after(s, k, p);
      const int n = passes(tile, creep);
      for (int j = 0; j < n; ++j) {
        const int u = t0 - creep + j * kSub;
        switch (k) {
          case 3:
            pair_pass<kC, 3, false>(src, src0, dst, dst0, w1p, b1p, w2p, b2p, u, T,
                                    s.d[p], accumulate, scale, smem);
            break;
          case 7:
            pair_pass<kC, 7, false>(src, src0, dst, dst0, w1p, b1p, w2p, b2p, u, T,
                                    s.d[p], accumulate, scale, smem);
            break;
          default:
            pair_pass<kC, 11, false>(src, src0, dst, dst0, w1p, b1p, w2p, b2p, u, T,
                                     s.d[p], accumulate, scale, smem);
        }
      }
    }
  }
}

// The launch's steps from host arrays, or false for a shape it is not built for.
bool steps_of(int n_br, int n_pair, const int* kernel_sizes, const int* dilations,
              Steps* s) {
  if (n_br < 1 || n_br > kMaxSteps || n_pair < 1 || n_pair > kMaxSteps) return false;
  s->n_br = n_br;
  s->n_pair = n_pair;
  for (int i = 0; i < kMaxSteps; ++i) s->k[i] = s->d[i] = 0;
  for (int br = 0; br < n_br; ++br) {
    const int k = kernel_sizes[br];
    if (k != 3 && k != 7 && k != 11) return false;
    s->k[br] = k;
  }
  for (int p = 0; p < n_pair; ++p) {
    if (dilations[p] < 1 || dilations[p] > 5) return false;   // shared-memory window
    s->d[p] = dilations[p];
  }
  return true;
}

}  // namespace

extern "C" {

// Rows of each of the two slabs per block, for tile frames per block, or -1
// for a shape the kernel is not built for.  The caller allocates two slabs
// of B * ceil(T / tile) * rows * 256 floats.
int mrf_stack_streamed_slab_rows(int tile, int n_br, int n_pair, const int* kernel_sizes,
                                 const int* dilations) {
  Steps s;
  if (tile <= 0 || tile % kSub || !steps_of(n_br, n_pair, kernel_sizes, dilations, &s))
    return -1;
  return slab_rows_of(s, tile);
}

// FLOPs the launch executes at B, T and tile, halo recompute included, or -1.
double mrf_stack_streamed_flops(int B, int T, int tile, int n_br, int n_pair,
                                const int* kernel_sizes, const int* dilations) {
  Steps s;
  if (tile <= 0 || tile % kSub || !steps_of(n_br, n_pair, kernel_sizes, dilations, &s))
    return -1.0;
  double per_block = 0.0;
  for (int br = 0; br < n_br; ++br)
    for (int p = 0; p < n_pair; ++p)
      per_block += 2.0 * s.k[br] * kC * kC *
                   (double)passes(tile, creep_after(s, s.k[br], p)) *
                   (mid_rows(s.k[br]) + kSub);
  return per_block * B * ((T + tile - 1) / tile);
}

// x, out [B, T, 256]; slab0, slab1 as mrf_stack_streamed_slab_rows says;
// w1, w2 [n_br, n_pair, 11, 256, 256] (taps centred in the 11, input
// channel, output channel); b1, b2 [n_br, n_pair, 256]; kernel_sizes [n_br]
// and dilations [n_pair] are host arrays.  One launch on `stream`; returns
// its CUDA error, or 0.
int mrf_stack_streamed_f32(const float* x, float* out, float* slab0, float* slab1,
                           const float* w1, const float* b1, const float* w2,
                           const float* b2, int B, int T, int C, int tile, int n_br,
                           int n_pair, const int* kernel_sizes, const int* dilations,
                           void* stream) {
  Steps s;
  if (C != kC || B < 1 || T < 1 || tile <= 0 || tile % kSub ||
      !steps_of(n_br, n_pair, kernel_sizes, dilations, &s))
    return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  for (int br = 0; br < n_br; ++br)
    for (int p = 0; p < n_pair; ++p) {
      const size_t b = pass_smem(s.k[br], s.d[p]);
      smem = b > smem ? b : smem;
    }
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mrf_stage_streamed, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + tile - 1) / tile, B);
  mrf_stage_streamed<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, out, slab0, slab1, w1, b1, w2, b2, T, tile, lead_of(s), slab_rows_of(s, tile), s);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of one pass at width C, kernel size k and dilation
// dil (a launch takes the largest over its steps), or -1.
int mrf_stack_streamed_smem_bytes(int C, int k, int dil) {
  if (C != kC || (k != 3 && k != 7 && k != 11)) return -1;
  return (int)pass_smem(k, dil);
}

const char* mrf_stack_streamed_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
