// Tensor-core building blocks for the port's bf16 attention kernels on
// Hopper (sm_90a): mma.sync.m16n8k16 bf16 -> fp32, ldmatrix, cp.async and
// the XOR swizzle of bf16 tiles in shared memory, and the backward's
// delta = rowsum(dO * O). Included by flash_attention.cu,
// sparse_attention.cu and supertile_attention.cu; each of them is built
// into a library of its own (ops/op_builder.py hashes this header with
// every source that includes it), so everything here has internal linkage.
//
// The conventions are those of flash_attention.cu, which proved them on
// this card: a warp owns 16 rows; two adjacent m16n8k16 accumulators,
// rounded to bf16, are the A operand of the next product without a trip
// through shared memory (a_from_acc); tiles are rows of W bf16 values
// (W a multiple of 16) whose 16-byte chunks are swizzled so that every
// ldmatrix is free of bank conflicts.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// A row of W bf16 values is CPR = W / 8 chunks of 16 bytes (CPR even, since
// W % 16 == 0). The physical chunk of logical chunk c in row r is chosen so
// that the eight rows an ldmatrix reads at one chunk (rows 8i .. 8i + 7)
// fall on eight distinct 16-byte bank groups (a 128-byte line holds eight):
//  * CPR % 8 == 0 (W 64, 128): the rows start on one group; c ^ (r & 7).
//  * CPR % 8 == 4 (W 32, 96): rows r and r + 1 already start four groups
//    apart; c ^ ((r >> 1) & 3), which stays inside c's group of four,
//    spreads the four pairs over the other four.
//  * CPR % 4 == 2 (W 16, 48, 80, 112): rows r .. r + 3 already start on
//    four distinct even (or odd) groups; c ^ ((r >> 2) & 1) moves rows
//    r + 4 .. r + 7 onto the other parity.
template <int W>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int CPR = W / 8;
  static_assert(W % 16 == 0, "rows of whole 16-value k steps");
  if constexpr (CPR % 8 == 0) {
    return c ^ (r & 7);
  } else if constexpr (CPR % 4 == 0) {
    return c ^ ((r >> 1) & 3);
  } else {
    return c ^ ((r >> 2) & 1);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled where !valid (src is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}
// 4 bytes global -> shared, zero-filled where !valid
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d (16 x 8, fp32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special function unit (ex2.approx, denormal results flushed
// to 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// two fp32 values rounded to bf16 (the reference's cast) in one register,
// the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The fragment layouts of m16n8k16 (lane = 4 g + t): an accumulator holds
// rows g and g + 8, columns 2t and 2t + 1 of a 16 x 8 tile; the A operand
// the same rows, columns 2t, 2t + 1 and 2t + 8, 2t + 9 of a 16 x 16 tile.
// So the accumulators of two adjacent 8-column tiles, packed to bf16, are
// the A operand of the 16 x 16 tile they form.
__device__ __forceinline__ void a_from_acc(uint32_t (&a)[4], const float (&lo)[4],
                                           const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// ldmatrix addresses for a tile of W-wide swizzled rows starting at
// ``tile``. A operand of the 16 x 16 block at rows r0.., chunks 2kk..:
// matrices (rows 0-7, k 0-7), (rows 8-15, k 0-7), (rows 0-7, k 8-15),
// (rows 8-15, k 8-15). The transposed B operand of a product that
// contracts over the tile's rows (P V, dS K, P^T dO, dS^T Q) has the same
// lane pattern, read with .trans: rows are the contracted index, chunks
// 2kk.. two 8-column tiles of the output.
template <int W>
__device__ __forceinline__ uint32_t a_addr(const bf16* tile, int r0, int kk, int lane) {
  const int r = r0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  return smem_u32(tile + r * W + swz<W>(r, 2 * kk + (lane >> 4)) * 8);
}
// B operand of two adjacent 8-column output tiles (rows n0.. and n0 + 8..
// of the stored tile, which is B transposed: S = Q K^T reads K's rows)
// over k chunks 2kk..: matrices (n 0-7, k 0-7), (n 0-7, k 8-15),
// (n 8-15, k 0-7), (n 8-15, k 8-15).
template <int W>
__device__ __forceinline__ uint32_t b_addr(const bf16* tile, int n0, int kk, int lane) {
  const int r = n0 + (lane & 7) + (lane >> 4) * 8;
  return smem_u32(tile + r * W + swz<W>(r, 2 * kk + ((lane >> 3) & 1)) * 8);
}

// the shared-memory address of chunk c of row r of a swizzled W-wide tile
template <int W>
__device__ __forceinline__ uint32_t chunk_addr(const bf16* tile, int r, int c) {
  return smem_u32(tile + r * W + swz<W>(r, c) * 8);
}

// Write a warp's (16, W) fp32 accumulator, rounded to bf16, through its own
// 16 swizzled rows of ``stage`` (rows r0..) to rows g0.. of ``dst``, a
// row-major matrix of ``ld`` columns: row g0 + i is written where g0 + i <
// n_rows, its first ``chunks`` 16-byte chunks, 16 bytes a lane.
template <int W>
__device__ __forceinline__ void store_rows(bf16* stage, int r0, const float (&acc)[W / 8][4],
                                           bf16* __restrict__ dst, int g0, int n_rows, int ld,
                                           int chunks, int lane) {
  constexpr int CPR = W / 8;
  const int g = lane >> 2;
  const int t = lane & 3;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < CPR; ++j) {
    const int ra = r0 + g;
    const int rb = r0 + g + 8;
    *reinterpret_cast<uint32_t*>(stage + ra * W + swz<W>(ra, j) * 8 + 2 * t) =
        pack_bf16(acc[j][0], acc[j][1]);
    *reinterpret_cast<uint32_t*>(stage + rb * W + swz<W>(rb, j) * 8 + 2 * t) =
        pack_bf16(acc[j][2], acc[j][3]);
  }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < (16 * CPR + 31) / 32; ++it) {
    const int i = lane + it * 32;
    const int r = i / CPR;
    const int c = i - r * CPR;
    if (r < 16 && c < chunks && g0 + r < n_rows) {
      *reinterpret_cast<uint4*>(dst + static_cast<long long>(g0 + r) * ld + c * 8) =
          *reinterpret_cast<const uint4*>(stage + (r0 + r) * W + swz<W>(r0 + r, c) * 8);
    }
  }
}

// delta = rowsum(dO * O) in fp32 over (rows, DH) row-major o and dout: the
// body of a 256-thread block over rows 64 blockIdx.x .., 4 lanes a row,
// 16-byte loads
template <typename T, int DH>
__device__ __forceinline__ void rowsum_dot(const T* __restrict__ o, const T* __restrict__ dout,
                                           float* __restrict__ delta, long long rows) {
  constexpr int EPV = 16 / static_cast<int>(sizeof(T));
  constexpr int VPR = DH / EPV;
  static_assert(VPR % 4 == 0, "whole vectors a lane");
  const long long row = static_cast<long long>(blockIdx.x) * 64 + (threadIdx.x >> 2);
  const int sub = threadIdx.x & 3;
  float sum = 0.f;
  if (row < rows) {
    const uint4* ov = reinterpret_cast<const uint4*>(o + row * DH);
    const uint4* dv = reinterpret_cast<const uint4*>(dout + row * DH);
#pragma unroll
    for (int c = sub; c < VPR; c += 4) {
      const uint4 a = ov[c];
      const uint4 b = dv[c];
      const T* ae = reinterpret_cast<const T*>(&a);
      const T* be = reinterpret_cast<const T*>(&b);
#pragma unroll
      for (int e = 0; e < EPV; ++e) sum = fmaf(to_f32(ae[e]), to_f32(be[e]), sum);
    }
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  if (row < rows && sub == 0) delta[row] = sum;
}

// One (registers, static smem, dynamic smem, local bytes a thread, threads,
// blocks an SM) record of a compiled kernel at its launch configuration.
template <typename K>
int kernel_info(K kernel, size_t smem, int threads, int* out) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = static_cast<int>(smem);
  out[3] = static_cast<int>(attr.localSizeBytes);
  out[4] = threads;
  out[5] = blocks;
  return 0;
}

}  // namespace
