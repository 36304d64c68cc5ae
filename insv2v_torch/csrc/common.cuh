// Shared helpers of the insv2v_torch CUDA kernels.
//
// Every library exports plain C launchers that take device pointers and
// the CUDA stream as void*, launch on that stream, never synchronise,
// allocate nothing, and return cudaGetLastError() (0 on success). The
// Python wrappers (insv2v_torch/ops) allocate outputs and raise on a
// non-zero status.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define INSV2V_EXPORT extern "C" __attribute__((visibility("default")))

typedef __nv_bfloat16 bf16;

INSV2V_EXPORT const char* error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// --- tensor-core and async-copy primitives (sm_80+ PTX, run on sm_90a) ---

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy that bypasses the registers.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Waits until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices from shared memory; lane l gives the address of
// row (l % 8) of matrix (l / 8).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d (16x8 f32) += a (16x16 bf16, row-major) * b (16x8 bf16, column-major).
// Fragment layouts, g = lane / 4, c = lane % 4:
//   a: {(g, 2c..2c+1), (g+8, 2c..), (g, 2c+8..), (g+8, 2c+8..)}
//   b: {(k 2c..2c+1, n g), (k 2c+8.., n g)}
//   d: {(g, 2c), (g, 2c+1), (g+8, 2c), (g+8, 2c+1)}
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as a bf16 pair, `lo` in the low half (the lower address).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
