// Hopper (sm_90a) PTX wrappers shared by the kernels that use the warpgroup
// matrix multiply: shared-memory matrix descriptors, wgmma with the A
// operand in shared memory or in registers, its fences, mbarriers, named
// barriers and the generic-to-async proxy fence.
#pragma once

#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Descriptor of a K-major bf16 operand without swizzle (layout type 0). The
// operand (A as M x K or B as N x K) is a grid of 8-row x 16-byte core
// matrices, each 128 contiguous bytes (row r of a core matrix at +16 r).
// `sbo` is the byte distance between core matrices along M (or N), `lbo`
// the distance between the two core matrices that make up K = 16. The start address needs 16-byte
// alignment only, which is what lets an operand start at any pixel.
__device__ __forceinline__ uint64_t matrix_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Returns once at most kPending committed groups are still in flight.
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}
// Pins accumulators in place across the asynchronous product: without it the
// compiler may read them before the wait that completes them.
template <int kN>
__device__ __forceinline__ void fence_acc(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Operand lists of 32 accumulator registers, d[0..31] and d[32..63].
#define TP_ACC_LO(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
  "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
  "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), \
  "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
  "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define TP_ACC_HI(d) \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), \
  "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), \
  "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), \
  "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define TP_REGS_LO \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define TP_REGS_HI \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"

// D (64 x 128 f32, in registers) = A (64 x 16 bf16) B (16 x 128 bf16) [+ D],
// both operands through descriptors. Thread t of the warpgroup (warp w = t /
// 32, g = t % 32 / 4, q = t % 4) holds D[16 w + g][8 j + 2 q + e] in d[4 j + e]
// and D[16 w + g + 8][8 j + 2 q + e] in d[4 j + 2 + e], j = 0..15.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" TP_REGS_LO ", " TP_REGS_HI
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : TP_ACC_LO(d), TP_ACC_HI(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// D (64 x 64 f32) = A (64 x 16) B (16 x 64) [+ D] with A in registers: a[0]
// = A[16 w + g][2 q, 2 q + 1], a[1] the same columns of row + 8, a[2] and a[3]
// those of columns + 8 (two bf16 per register, the lower column in the lower
// half); D as above with j = 0..7.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" TP_REGS_LO
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : TP_ACC_LO(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// Shared-memory writes made with ordinary stores become visible to wgmma's
// reads (the async proxy) only after this fence.
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Returns once the barrier's phase of the given parity has completed (a
// fresh barrier passes a wait on parity 1 at once).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Moves registers between warpgroups: all four warps of a warpgroup lower
// or raise their limit together (multiples of 8).
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

}  // namespace hopper
