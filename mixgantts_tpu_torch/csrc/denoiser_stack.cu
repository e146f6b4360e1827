// The diffusion denoiser's gated residual stack, written by hand for Hopper
// (sm_90a), fp32 in, fp32 accumulation, fp32 out.
//
// Replaces the Pallas TPU kernel mixgantts_tpu/ops/pallas.py::
// fused_residual_stack.  Python entry point:
// mixgantts_tpu_torch/ops/denoiser_stack.py::fused_residual_stack.
//
// Per layer l, with x and skip [B, T, C] (C = 256 for LJSpeech):
//   y0 = x + step_proj[l];   y = (y0 + condp[l]) * [0 <= t < T]
//   z  = conv_k3(y) + conv_b                  (C -> 2C, zero padding)
//   g  = sigmoid(z[:, :C]) * tanh(z[:, C:])
//   o  = g @ out_w + out_b                    (C -> 2C)
//   x' = (o[:, :C] + y0) / sqrt(2);   skip += o[:, C:]
// step_proj and condp (the 1x1 conditioner projection) of every layer are
// computed before the stack by two matrix products, as the TPU kernel's
// caller does.
//
// What bounds it on an H100: one request (B = 1, T = 1000, L = 20) is
// ~21 GFLOP against 42 MB of fp32 weights and ~20 MB of condp; at 67 TFLOP/s
// of fp32 on the CUDA cores that is ~0.31 ms of arithmetic and ~19 us of
// device-memory traffic, so it is bound by operations.  The per-layer
// activations (x, skip: 1 MB each at B = 1) stay in the 50 MB L2.
//
// Design: one launch per layer.  A block owns (batch row, 32-frame tile,
// 64-channel group of the gate).  It stages the tile's y (34 rows with the
// k = 3 halo) in shared memory, computes its group's 64 gate and 64 filter
// pre-activations over K = 3C from weight chunks staged through shared
// memory (the next chunk's loads are in flight while the current one is
// used), applies the gate, then multiplies its 64 gate channels by the
// matching 64 rows of out_w.  That splits the output projection's
// contraction over C / 64 blocks, whose partial sums are added with
// atomicAdd into x' (zeroed before the launch) and skip.  Splitting the
// channels gives C / 64 times more blocks than frame tiles alone (128
// blocks at B = 1, T = 1000 on 132 SMs) and keeps each block's weight reads
// to its own share of the conv weights.  The order of the atomic sums
// varies from run to run, so results agree with the plain version to fp32
// rounding, not bit for bit.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;    // 8 warps: warp w owns rows w, w+8, w+16, w+24
constexpr int kTile = 32;        // frames per block
constexpr int kGroup = 64;       // gate channels per block
constexpr int kConvChunk = 32;   // rows of the [3C, 2C] conv weight staged at once
constexpr int kOutChunk = 8;     // rows of the [C, 2C] output weight staged at once
constexpr int kRowsPerThread = kTile / (kThreads / 32);   // 4

template <int C>
struct Shape {
  static_assert(C % 128 == 0, "C must be a multiple of 128");
  static constexpr int kRowsY = kTile + 2;   // k = 3 halo on both sides
  static constexpr int kConvStage = kConvChunk * 2 * kGroup;
  static constexpr int kOutStage = kOutChunk * 2 * C;
  static constexpr int kStage = kConvStage > kOutStage ? kConvStage : kOutStage;
  static constexpr size_t kBytes =
      sizeof(float) * (size_t)(kRowsY * C + kStage + kTile * kGroup);
};

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

template <int C>
__global__ void __launch_bounds__(kThreads)
residual_layer(const float* __restrict__ x,          // [B, T, C]
               const float* __restrict__ condp,      // [B, T, C], bias added
               const float* __restrict__ step_proj,  // [B, C]
               const float* __restrict__ conv_w,     // [3, C, 2C]
               const float* __restrict__ conv_b,     // [2C]
               const float* __restrict__ out_w,      // [C, 2C]
               const float* __restrict__ out_b,      // [2C]
               float* __restrict__ x_next,           // [B, T, C], zeroed
               float* __restrict__ skip,             // [B, T, C]
               int T) {
  using S = Shape<C>;
  constexpr int kCols4 = 2 * C / 4;            // float4 per out_w row
  constexpr int kNJ = 2 * C / 128;             // float4 column groups per thread
  extern __shared__ float4 smem4[];
  float* s_y = reinterpret_cast<float*>(smem4);   // [kRowsY][C]
  float* s_w = s_y + S::kRowsY * C;               // staged weights
  float* s_g = s_w + S::kStage;                   // [kTile][kGroup]
  float4* s_w4 = reinterpret_cast<float4*>(s_w);

  const int tid = threadIdx.x, tr = tid >> 5, lane = tid & 31;
  const int t0 = blockIdx.x * kTile;
  const int grp = blockIdx.y, g0 = grp * kGroup;
  const size_t row0 = (size_t)blockIdx.z * T;
  const float* sp = step_proj + (size_t)blockIdx.z * C;

  // 1. y for frames t0 - 1 .. t0 + kTile, zero outside [0, T)
  for (int i = tid; i < S::kRowsY * (C / 4); i += kThreads) {
    const int r = i / (C / 4), c = (i % (C / 4)) * 4;
    const int t = t0 - 1 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t >= 0 && t < T) {
      const float4 xv = __ldg(reinterpret_cast<const float4*>(x + (row0 + t) * C + c));
      const float4 cv = __ldg(reinterpret_cast<const float4*>(condp + (row0 + t) * C + c));
      const float4 sv = __ldg(reinterpret_cast<const float4*>(sp + c));
      v = make_float4((xv.x + sv.x) + cv.x, (xv.y + sv.y) + cv.y,
                      (xv.z + sv.z) + cv.z, (xv.w + sv.w) + cv.w);
    }
    *reinterpret_cast<float4*>(s_y + r * C + c) = v;
  }

  // 2. gate (z[:, g0:g0+64]) and filter (z[:, C+g0:C+g0+64]) pre-activations.
  //    Thread (tr, lane): rows tr + 8i, channels g0 + 2*lane + {0, 1}.
  float zg[kRowsPerThread][2] = {}, zf[kRowsPerThread][2] = {};
  {
    constexpr int kChunks = 3 * C / kConvChunk;
    constexpr int kLoads = S::kConvStage / 4 / kThreads;   // 4
    float4 pre[kLoads];
    auto load = [&](int q) {
#pragma unroll
      for (int m = 0; m < kLoads; ++m) {
        const int i = tid + m * kThreads;
        const int r = i / 32, q4 = i % 32;   // 32 float4 per staged row
        const int col = q4 < 16 ? g0 + q4 * 4 : C + g0 + (q4 - 16) * 4;
        pre[m] = __ldg(reinterpret_cast<const float4*>(
            conv_w + (size_t)(q * kConvChunk + r) * (2 * C) + col));
      }
    };
    load(0);
    for (int q = 0; q < kChunks; ++q) {
      __syncthreads();
#pragma unroll
      for (int m = 0; m < kLoads; ++m) s_w4[tid + m * kThreads] = pre[m];
      __syncthreads();
      if (q + 1 < kChunks) load(q + 1);
      const int k0 = q * kConvChunk, tap = k0 / C, ci0 = k0 % C;
      const float* a0 = s_y + (tr + tap) * C + ci0;
#pragma unroll 8
      for (int kk = 0; kk < kConvChunk; ++kk) {
        const float2 wg = *reinterpret_cast<const float2*>(s_w + kk * 128 + 2 * lane);
        const float2 wf = *reinterpret_cast<const float2*>(s_w + kk * 128 + 64 + 2 * lane);
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          const float a = a0[i * 8 * C + kk];
          zg[i][0] = fmaf(a, wg.x, zg[i][0]);
          zg[i][1] = fmaf(a, wg.y, zg[i][1]);
          zf[i][0] = fmaf(a, wf.x, zf[i][0]);
          zf[i][1] = fmaf(a, wf.y, zf[i][1]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = g0 + 2 * lane + j;
      s_g[(tr + 8 * i) * kGroup + 2 * lane + j] =
          sigmoid(zg[i][j] + conv_b[c]) * tanhf(zf[i][j] + conv_b[C + c]);
    }
  }

  // 3. this group's share of o = g @ out_w: rows tr + 8i, columns
  //    4*lane + 128*j + {0..3} for j < kNJ.
  float acc[kRowsPerThread][kNJ][4] = {};
  {
    constexpr int kChunks = kGroup / kOutChunk;
    constexpr int kLoads = S::kOutStage / 4 / kThreads;
    float4 pre[kLoads];
    auto load = [&](int q) {
#pragma unroll
      for (int m = 0; m < kLoads; ++m) {
        const int i = tid + m * kThreads;
        pre[m] = __ldg(reinterpret_cast<const float4*>(
                           out_w + (size_t)(g0 + q * kOutChunk) * (2 * C)) + i);
      }
    };
    load(0);
    for (int q = 0; q < kChunks; ++q) {
      __syncthreads();
#pragma unroll
      for (int m = 0; m < kLoads; ++m) s_w4[tid + m * kThreads] = pre[m];
      __syncthreads();
      if (q + 1 < kChunks) load(q + 1);
#pragma unroll
      for (int kk = 0; kk < kOutChunk; ++kk) {
        float a[kRowsPerThread];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
          a[i] = s_g[(tr + 8 * i) * kGroup + q * kOutChunk + kk];
#pragma unroll
        for (int j = 0; j < kNJ; ++j) {
          const float4 w = s_w4[kk * kCols4 + lane + 32 * j];
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i) {
            acc[i][j][0] = fmaf(a[i], w.x, acc[i][j][0]);
            acc[i][j][1] = fmaf(a[i], w.y, acc[i][j][1]);
            acc[i][j][2] = fmaf(a[i], w.z, acc[i][j][2]);
            acc[i][j][3] = fmaf(a[i], w.w, acc[i][j][3]);
          }
        }
      }
    }
  }

  // 4. group 0 adds the biases and the residual; every group adds its part.
  const float kRsqrt2 = 0.70710678118654752f;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int t = t0 + tr + 8 * i;
    if (t >= T) continue;
    const size_t off = (row0 + t) * C;
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      const int c = 4 * lane + 128 * j;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float o = acc[i][j][e];
        if (c < C) {
          if (grp == 0) o += out_b[c + e] + (x[off + c + e] + sp[c + e]);
          atomicAdd(x_next + off + c + e, o * kRsqrt2);
        } else {
          if (grp == 0) o += out_b[c + e];
          atomicAdd(skip + off + (c - C) + e, o);
        }
      }
    }
  }
}

template <int C>
int run_stack(const float* x, const float* condp, const float* step_proj,
              const float* conv_w, const float* conv_b, const float* out_w,
              const float* out_b, float* x_out, float* skip, float* scratch,
              int B, int T, int L, cudaStream_t stream) {
  const size_t smem = Shape<C>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      residual_layer<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)B * T * C;
  err = cudaMemsetAsync(skip, 0, n * sizeof(float), stream);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + kTile - 1) / kTile, C / kGroup, B);
  const float* cur = x;
  for (int l = 0; l < L; ++l) {
    // ping-pong so that the last layer writes x_out
    float* nxt = ((L - 1 - l) % 2 == 0) ? x_out : scratch;
    err = cudaMemsetAsync(nxt, 0, n * sizeof(float), stream);
    if (err != cudaSuccess) return (int)err;
    residual_layer<C><<<grid, kThreads, smem, stream>>>(
        cur, condp + (size_t)l * n, step_proj + (size_t)l * B * C,
        conv_w + (size_t)l * 3 * C * 2 * C, conv_b + (size_t)l * 2 * C,
        out_w + (size_t)l * C * 2 * C, out_b + (size_t)l * 2 * C, nxt, skip, T);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    cur = nxt;
  }
  return (int)cudaSuccess;
}

}  // namespace

extern "C" {

// x [B, T, C]; condp [L, B, T, C]; step_proj [L, B, C]; conv_w [L, 3, C, 2C];
// conv_b [L, 2C]; out_w [L, C, 2C]; out_b [L, 2C].  Writes x_out and skip
// [B, T, C]; scratch [B, T, C] holds every other layer's x.  Launches L
// kernels on `stream` and returns the first CUDA error, or 0.
int denoiser_stack_f32(const float* x, const float* condp, const float* step_proj,
                       const float* conv_w, const float* conv_b, const float* out_w,
                       const float* out_b, float* x_out, float* skip, float* scratch,
                       int B, int T, int C, int L, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 128:
      return run_stack<128>(x, condp, step_proj, conv_w, conv_b, out_w, out_b,
                            x_out, skip, scratch, B, T, L, s);
    case 256:
      return run_stack<256>(x, condp, step_proj, conv_w, conv_b, out_w, out_b,
                            x_out, skip, scratch, B, T, L, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory a block of the C-channel kernel uses, or -1.
int denoiser_stack_smem_bytes(int C) {
  switch (C) {
    case 128:
      return (int)Shape<128>::kBytes;
    case 256:
      return (int)Shape<256>::kBytes;
    default:
      return -1;
  }
}

const char* denoiser_stack_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
