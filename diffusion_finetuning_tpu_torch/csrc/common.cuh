// Small device helpers shared by the port's Hopper kernels (sm_90a).
//
// Fragment layouts are those of PTX `mma.sync.aligned.m16n8k16.row.col`
// with bf16 inputs and fp32 accumulators.  With g = lane / 4, t = lane % 4:
//   A (16x16, row-major)  reg0 = A[g][2t..2t+1]     reg1 = A[g+8][2t..2t+1]
//                         reg2 = A[g][2t+8..2t+9]   reg3 = A[g+8][2t+8..2t+9]
//   B (16x8, given as Bt = B^T, 8 rows of 16)
//                         reg0 = Bt[g][2t..2t+1]    reg1 = Bt[g][2t+8..2t+9]
//   C (16x8, fp32)        c0,c1 = C[g][2t..2t+1]    c2,c3 = C[g+8][2t..2t+1]
// Each 32-bit register holds two bf16 values, the lower column in the low half.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dft {

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x by the special-function unit alone (ex2.approx.ftz: relative error
// about 2^-22, subnormal results flushed to 0), where exp2f adds range
// handling around the same instruction
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a * b  (m16n8k16, bf16 inputs, fp32 accumulate)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte global -> shared copy; src_bytes = 0 writes 16 zero bytes.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace dft
