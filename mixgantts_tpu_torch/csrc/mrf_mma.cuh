// The bf16 tensor-core pass of the HiFi-GAN MRF kernels on Hopper (sm_90a):
// one dilated convolution as an implicit GEMM through wgmma, bf16 operands,
// fp32 accumulation.
//
// A conv of a [rows, C] activation tile with a k-tap kernel at dilation d is
//   out[r, n] = sum over taps t and input channels c of
//               A[r + t*d, c] * W[t][c][n]
// so with K = taps x C_in (tap-major, as the TPU kernel concatenates its taps
// into the contraction) each 16-deep K step reads the A tile at a row offset
// t*d and one 16 x C slab of the weights.  Shapes:
// - M: 64-row wgmma tiles; each consumer warpgroup owns MT of them.
// - N: all C output channels in one instruction (m64nCk16, C = 8..256),
//   or, at C = 512, the 256 of one half (a block owns one half of the
//   output channels; its tile holds all 512 input channels).
// - A comes from registers, loaded with ldmatrix from an unswizzled bf16
//   tile whose rows are padded by 16 bytes (conflict-free ldmatrix at any
//   row offset).  A wgmma shared-memory descriptor cannot start at an
//   arbitrary row of a swizzled tile; a register operand can.
// - B comes from shared memory, in wgmma's canonical K-major layout without
//   swizzle.  The weights are laid out once, at stacking time
//   (`ops/mrf.py::kernel_weights`), in exactly the order wgmma reads them:
//   per 16-deep slab s, per group g of 8 output channels, per half h of the
//   16 inputs, an 8 x 8 core matrix (row = output channel, 8 contiguous
//   input channels):  W[t][c][n] at element
//     ((s * C/8 + n/8) * 2 + h) * 64 + (n % 8) * 8 + c % 8,   16 s + 8 h + c % 8 = t*C + c
//   so the descriptor's leading byte offset (between the two K halves) is
//   128 bytes and its stride byte offset (between channel groups) 256.
//   Above 256 output channels the layout is split into halves of 256: each
//   half z (output channels [256 z, 256 z + 256)) holds the whole K axis in
//   the order above with N = 256, half after half, so one CTA's weights are
//   again one contiguous run.
//   A chunk of KCH K rows is one contiguous run of bytes: one cp.async.bulk
//   lands it in a stage of a shared-memory ring, completing on the stage's
//   "full" mbarrier; the consumers release the stage on its "empty"
//   mbarrier once the wgmmas that read it have completed.
//
// The narrow stages' kernel (mrf_stage_narrow.cu) takes the wgmma calls at
// N = 8 and 16, the mbarriers and the producer, with a pass of its own.
// The denoiser kernel (denoiser_stack.cu) and the whole-stage MRF kernel
// (mrf_stack_streamed.cu) take from it the mbarriers, bulk_copy, pack_bf16,
// smem_addr, kmajor_desc, slab_desc, the producer (produce_chunks) and the
// wgmma calls, with a pass of their own that reads both operands from
// shared memory (wgmma_ss).
//
// Each library includes this header from one translation unit, so its
// definitions have internal linkage.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr float kMmaSlope = 0.1f;

__device__ __forceinline__ float lrelu_f(float v) { return v >= 0.f ? v : v * kMmaSlope; }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// --- mbarriers and the bulk copy -------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Wait until the phase of `bar` with this parity has completed.  A wait
// that never completes (a fault in the pipeline) traps after ~2^28 polls,
// so the launch fails with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 28)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// bytes from global src to shared dst, completing on bar (16-byte aligned,
// a multiple of 16 bytes)
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// Named barrier 1 over the consumer warpgroups only (the producer warp
// never joins it).
template <int kThreads>
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kThreads) : "memory");
}

// --- wgmma ------------------------------------------------------------------

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keep a register's value where it is until this point: the A fragments
// of a wgmma in flight, and the accumulators read after a wait.
__device__ __forceinline__ void fence_reg(uint32_t& r) { asm volatile("" : "+r"(r) :: "memory"); }
__device__ __forceinline__ void fence_reg(float& r) { asm volatile("" : "+f"(r) :: "memory"); }

// Shared-memory descriptor of a K-major operand without swizzle: core
// matrices of 8 rows x 16 bytes, `lbo` bytes apart along K and `sbo` bytes
// apart along M (or N).
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// One 16 x N slab of the weights: leading byte offset 128 (the two 8-deep K
// halves), stride byte offset 256 (groups of 8 rows of N).
__device__ __forceinline__ uint64_t slab_desc(uint32_t addr) { return kmajor_desc(addr, 128, 256); }

// d[64 x N] (+)= a[64 x 16] (registers, bf16) * B[16 x N] (shared, bf16),
// fp32 accumulators; scale_d = 0 overwrites d.  Fragment layouts: a as
// ldmatrix.x4 gives it (rows 16 w .. 16 w + 15 for warp w of the
// warpgroup); d[j] of lane l in warp w is row 16 w + l / 4 + 8 ((j / 2) % 2),
// column 8 (j / 4) + 2 (l % 4) + j % 2.
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
};

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
};

template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void mma(float (&d)[128], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63,"
        " %64, %65, %66, %67, %68, %69, %70, %71,"
        " %72, %73, %74, %75, %76, %77, %78, %79,"
        " %80, %81, %82, %83, %84, %85, %86, %87,"
        " %88, %89, %90, %91, %92, %93, %94, %95,"
        " %96, %97, %98, %99, %100, %101, %102, %103,"
        " %104, %105, %106, %107, %108, %109, %110, %111,"
        " %112, %113, %114, %115, %116, %117, %118, %119,"
        " %120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
};

// d[64 x 64] (+)= A[64 x 16] * B[16 x 64], both from shared memory, bf16,
// fp32 accumulators (layout as Wgmma<N>); scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// --- one convolution over the ring -----------------------------------------

// Geometry of the pass over C input channels (the tile's width, and K =
// taps x C) into N output channels (wgmma's N; N = C unless the output
// channels are split over CTAs): WG consumer warpgroups of MT 64-row tiles
// each, KCH K rows per ring stage, S stages.
template <int C, int MT, int KCH, int S, int WG, int N = C>
struct MmaPass {
  static_assert(C % 32 == 0 && C <= 512, "C must be a multiple of 32 up to 512");
  static_assert(N % 32 == 0 && N <= 256, "N must be 32, 64, 128 or 256 (one wgmma)");
  static_assert(KCH % 32 == 0, "a stage holds an even number of 16-deep steps");
  static constexpr int kWG = WG;                      // consumer warpgroups
  static constexpr int kConsumers = 128 * kWG;
  static constexpr int kThreads = kConsumers + 32;    // + one producer warp
  static constexpr int kRows = 64 * MT * kWG;         // rows of one conv
  static constexpr int kLd = C + 8;                   // bf16 per tile row (16 B pad)
  static constexpr int kStageBytes = KCH * N * 2;
  static constexpr int kRingBytes = S * kStageBytes;
  static constexpr int kSPC = KCH / 16;               // 16-deep steps per stage
};

// acc[mt] (64 x N, fp32) = the conv of rows [64 (wg MT + mt), +64) of a
// tile of C channels: sum over taps t < K and input channels of
// A[r + t dil, c] W[t][c][n].
// `a_lane` is this lane's ldmatrix address of row 0 of its warp's first tile
// (rows 16 w + lane % 16, columns 8 (lane / 16)), `row_bytes` a tile row's
// bytes.  The weights are ring chunks q0 .. q0 + ceil(K C / KCH) - 1 (the
// producer's global order); `leader` (one thread per warpgroup) releases
// each stage once the wgmmas reading it have completed.
//
// A fragments rotate through NB register buffers: up to NB - 1 steps'
// wgmmas are in flight while the next step's ldmatrix runs, and a buffer is
// refilled only after the wgmma that read it has completed
// (wait_group NB - 1).
template <int C, int K, int MT, int KCH, int S, int NB, int WG, int N = C>
__device__ __forceinline__ void conv_mma(float (&acc)[MT][N / 2], uint32_t a_lane,
                                         uint32_t row_bytes, int dil, uint32_t ring,
                                         uint32_t full, uint32_t empty, int q0, bool leader) {
  using P = MmaPass<C, MT, KCH, S, WG, N>;
  constexpr int kSteps = K * C / 16;
  constexpr int kStepsPerTap = C / 16;
  static_assert(kSteps % NB == 0, "steps run in groups of NB");
  static_assert((S - 1) * P::kSPC >= NB - 1, "the ring must run ahead of the fragments");
  uint32_t a[NB][MT][4];

  auto load_a = [&](uint32_t (&frag)[MT][4], int st) {
    const int tap = st / kStepsPerTap, c0 = (st % kStepsPerTap) * 16;
    const uint32_t base = a_lane + (uint32_t)(tap * dil) * row_bytes + c0 * 2;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) ldmatrix_x4(frag[mt], base + mt * 64 * row_bytes);
  };
  auto stage_of = [&](int q) { return (uint32_t)(q % S); };
  auto wait_full = [&](int q) { mbar_wait(full + 8 * stage_of(q), (uint32_t)((q / S) & 1)); };
  // release the stage of step `done` if it is the last step of its chunk
  auto release = [&](int done) {
    if (leader && ((done + 1) % P::kSPC == 0 || done == kSteps - 1))
      mbar_arrive(empty + 8 * stage_of(q0 + done / P::kSPC));
  };

  // one 16-deep step with fragments in buffer B; then the next step's load
  auto step = [&](auto buf, int st) {
    constexpr int B = decltype(buf)::value;
    constexpr int NX = (B + 1) % NB;   // the next step's buffer
    const uint64_t desc = slab_desc(ring + stage_of(q0 + st / P::kSPC) * P::kStageBytes +
                                    (st % P::kSPC) * 32 * N);
    wgmma_fence();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) Wgmma<N>::mma(acc[mt], a[B][mt], desc, st > 0);
    wgmma_commit();
    wgmma_wait<NB - 1>();                  // step st - NB + 1 has completed
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) fence_reg(a[NX][mt][i]);
    if (st >= NB - 1) release(st - NB + 1);
    if (st + 1 < kSteps) {
      if ((st + 1) % P::kSPC == 0) wait_full(q0 + (st + 1) / P::kSPC);
      load_a(a[NX], st + 1);
    }
  };

  wait_full(q0);
  load_a(a[0], 0);
  for (int st = 0; st < kSteps; st += NB) {
    step(std::integral_constant<int, 0>(), st);
    if constexpr (NB > 1) step(std::integral_constant<int, 1 % NB>(), st + 1);
    if constexpr (NB > 2) step(std::integral_constant<int, 2 % NB>(), st + 2);
    if constexpr (NB > 3) step(std::integral_constant<int, 3 % NB>(), st + 3);
  }
  static_assert(NB >= 2 && NB <= 4, "2 to 4 fragment buffers");
  wgmma_wait<0>();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < N / 2; ++j) fence_reg(acc[mt][j]);
#pragma unroll
  for (int d = kSteps - NB + 1; d < kSteps; ++d) release(d);
}

// The producer (lane 0 of the producer warp): chunks 0 .. n_chunks - 1 of
// the ring in order, each into stage q % S once the consumers have released
// that stage's previous chunk: copy(q, dst, bar) sets bar's expected bytes
// and issues chunk q's bulk copies to shared address dst, completing on bar.
template <int S, class Copy>
__device__ __forceinline__ void produce_chunks(int n_chunks, uint32_t ring, int stage_bytes,
                                               uint32_t full, uint32_t empty, Copy copy) {
  for (int q = 0; q < n_chunks; ++q) {
    const uint32_t s = q % S;
    if (q >= S) mbar_wait(empty + 8 * s, (uint32_t)((q / S - 1) & 1));
    copy(q, ring + s * stage_bytes, full + 8 * s);
  }
}

// produce_chunks with one bulk copy per chunk: chunk q from src(q), bytes(q).
template <int S, class Src, class Bytes>
__device__ __forceinline__ void produce(int n_chunks, uint32_t ring, int stage_bytes,
                                        uint32_t full, uint32_t empty, Src src, Bytes bytes) {
  produce_chunks<S>(n_chunks, ring, stage_bytes, full, empty,
                    [&](int q, uint32_t dst, uint32_t bar) {
                      const uint32_t n = bytes(q);
                      mbar_expect_tx(bar, n);
                      bulk_copy(dst, src(q), n, bar);
                    });
}

}  // namespace
