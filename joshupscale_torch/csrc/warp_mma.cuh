// Warp-level tensor-core and copy helpers of P2 (probe_patch_dot.cu),
// and the shared-address and persistent-grid helpers every bf16 kernel
// uses (K1 and P1 build on wgmma_tma.cuh).
//
// mma.sync.m16n8k16 (bf16 in, f32 accumulate) fragment layouts, with
// g = lane / 4 and t = lane % 4:
//   A (16 x 16, row-major): a0 = A[g][2t..2t+1],   a1 = A[g+8][2t..2t+1],
//                           a2 = A[g][2t+8..2t+9], a3 = A[g+8][2t+8..2t+9]
//   B (16 x 8, "col"):      b0 = B[2t..2t+1][g],   b1 = B[2t+8..2t+9][g]
//   C (16 x 8, f32):        c0, c1 = C[g][2t, 2t+1], c2, c3 = C[g+8][2t, 2t+1]
// ldmatrix_a loads the four A registers of a 16 x 16 tile of a row-major
// shared array; ldmatrix_b loads b0/b1 of two neighbouring n8 fragments
// (a 16 x 16 tile) of a row-major [k][n] shared array, transposing on
// the way.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace jt {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of the 16 x 16 tile whose top-left element is at `tile`
// (row stride `ld` elements, rows 16-byte aligned).
__device__ __forceinline__ void ldmatrix_a(uint32_t* r,
                                           const __nv_bfloat16* tile,
                                           int ld, int lane) {
  const __nv_bfloat16* p = tile + (lane & 15) * ld + (lane >> 4) * 8;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// B fragments of the 16 (k) x 16 (n) tile of a row-major [k][n] array
// whose top-left element is at `tile`: r[0], r[1] are b0, b1 of columns
// 0-7, r[2], r[3] those of columns 8-15.
__device__ __forceinline__ void ldmatrix_b(uint32_t* r,
                                           const __nv_bfloat16* tile,
                                           int ld, int lane) {
  const __nv_bfloat16* p =
      tile + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// acc += A @ B for one warp's 32 x (8 NF) output tile over 16 k16s of k:
// A's 32 rows at `a` (row stride lda), B's rows at `b` (row stride ldb,
// already offset to the warp's first column), both in shared memory.
template <int NF>
__device__ __forceinline__ void warp_tile_mma(float (&acc)[2][NF][4],
                                              const __nv_bfloat16* a,
                                              int lda,
                                              const __nv_bfloat16* b,
                                              int ldb, int k16s, int lane) {
#pragma unroll 4
  for (int k16 = 0; k16 < k16s; ++k16) {
    uint32_t af[2][4];
#pragma unroll
    for (int mf = 0; mf < 2; ++mf)
      ldmatrix_a(af[mf], a + mf * 16 * lda + k16 * 16, lda, lane);
#pragma unroll
    for (int nf2 = 0; nf2 < NF / 2; ++nf2) {
      uint32_t bf[4];
      ldmatrix_b(bf, b + k16 * 16 * ldb + nf2 * 16, ldb, lane);
#pragma unroll
      for (int mf = 0; mf < 2; ++mf) {
        mma_bf16(acc[mf][2 * nf2], af[mf], bf[0], bf[1]);
        mma_bf16(acc[mf][2 * nf2 + 1], af[mf], bf[2], bf[3]);
      }
    }
  }
}

// 16-byte asynchronous copy global -> shared; when !valid nothing is
// read and the 16 bytes are zero-filled (src must still be a valid
// address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

// Opt a kernel in to `smem` bytes of dynamic shared memory and return
// its persistent grid size on the current device (SMs x resident CTAs
// per SM), once per device; 0 on error (*err says which).
template <typename Kernel>
int persistent_grid(Kernel kernel, int threads, size_t smem, int* cache,
                    int max_devices, cudaError_t* err) {
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return 0;
  if (dev >= max_devices) {
    *err = cudaErrorInvalidDevice;
    return 0;
  }
  if (cache[dev] == 0) {
    *err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (*err != cudaSuccess) return 0;
    int sms = 0, per_sm = 0;
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (*err != cudaSuccess) return 0;
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                         threads, smem);
    if (*err != cudaSuccess) return 0;
    if (per_sm < 1) {
      *err = cudaErrorInvalidConfiguration;
      return 0;
    }
    cache[dev] = sms * per_sm;
  }
  *err = cudaSuccess;
  return cache[dev];
}

}  // namespace jt
