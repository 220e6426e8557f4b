// Flash attention, forward and backward, for Hopper (sm_90a). Built by
// ops/op_builder.py with nvcc into a shared library that
// ops/flash_attention.py loads with ctypes; every entry point has a plain C
// interface, launches on the stream it is given, allocates nothing and
// returns cudaGetLastError() so the wrapper can raise on a refused launch.
//
// flash_fwd replaces both Pallas forwards of the reference: the streaming
// _flash_fwd (deeperspeed_tpu/ops/pallas/flash_attention.py) and the
// static-unrolled whole-S _fwd (ops/pallas/flash_static.py). flash_bwd
// replaces both backwards: flash_attention.py's _flash_bwd (its
// _bwd_dkdv_kernel and _bwd_dq_kernel) and flash_static.py's one-kernel
// _bwd. The two reference pairs compute the same function, causal or full
// softmax(Q K^T * scale) V with the fp32 logsumexp saved for a flash-2
// backward; they differ only in whether whole-S K and V fit the TPU's
// VMEM, which has no meaning here. So one forward and one backward take
// any S >= 1 (ragged S included) and Dh in {64, 96, 128}.
//
// What bounds them: at the training shape (2, 16, 1024, 128) causal the
// forward does ~8.6 GFLOP on ~34 MB and the backward ~21.6 GFLOP on
// ~68 MB, far above the H100's ~295 FLOP/byte ridge for bf16, so the
// tensor cores bound both; the CUDA cores' fp32 rate is 15x lower.
//
// The bf16 route (the training path) is FlashAttention-2 on
// mma.sync.m16n8k16 bf16 -> fp32:
//  * each warp owns 16 rows; a 4-warp block holds 64 rows and walks
//    tiles of the other side (64 keys; 16 or 32 queries in the dK/dV
//    kernel), which cp.async (16 bytes a thread) double-buffers so the
//    next tile's loads fly under this tile's products. Tiles sit in shared memory as bf16 with an XOR swizzle of
//    their 16-byte chunks (swz, tensor_core.cuh), so every ldmatrix (.trans for the
//    operands read across the row) is free of bank conflicts.
//  * the forward keeps Q's fragments in registers, runs the online
//    softmax on the S accumulators (row max and sum over the 4 lanes of a
//    quad; exponentials on ex2.approx) and packs P to bf16 in registers as
//    the A operand of P V: no S x S value, and no P, touches shared or
//    device memory.
//  * causal tiles above the diagonal are skipped, only tiles that cross
//    the diagonal or the ragged edge are masked element by element, and
//    the whole grid runs heaviest first: (batch * head) on blockIdx.x and
//    the reversed tile index on blockIdx.y, so that every head's longest
//    query tiles start in the first wave. (Reversing the tiles only within
//    each head, on blockIdx.x, left the last heads' longest tiles to the
//    end, and the causal pair took ~1.4x as long; PERF.md.)
//  * the backward stays deterministic (no atomics, no order that changes
//    from run to run: resumed and data-parallel runs are checked bit for
//    bit) in three launches: flash_bwd_delta, rowsum(dO * O) in fp32;
//    flash_bwd_dkdv, one block per key tile looping over query tiles,
//    computing S^T and dP^T so that P^T and dS^T are A operands straight
//    from registers; flash_bwd_dq, one block per query tile.
//  * rounding follows the reference: P is cast to bf16 before P V
//    (flash_static.py:236) and dS before its two products
//    (flash_static.py:245); the row sum l is taken over the uncast fp32 p;
//    lse and every accumulator stay fp32; masked scores are -1e30.
//
// The fp32 route keeps the first port's CUDA-core kernels (fp32 FMAs over
// fp32 tiles with a row stride of Dh + 1): TF32 tensor cores keep ~10
// mantissa bits, short of the fp32 tolerance the port holds. fp32 is not
// on the training path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tensor_core.cuh"

namespace {

// ------------------------------------------------------------------ //
// fp32 route: CUDA-core FMAs
// ------------------------------------------------------------------ //

constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;
constexpr int kTile = 64;        // rows of a query tile and of a key tile
constexpr int kThreads = 256;    // a 16 x 16 grid of threads, 4 x 4 each
constexpr int kPLd = kTile + 1;  // row stride of the (64, 64) P / dS tiles
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF: finite, no NaN

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T and back: the reference's cast before a matmul operand
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// max / sum over the 16 threads that share a row (lanes 0-15 or 16-31)
__device__ __forceinline__ float row16_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row16_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// rows [r0, r0 + 64) of a (S, DH) matrix into shared memory as fp32 with
// row stride DH + 1; rows at or past S load as zeros
template <typename T, int DH>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int r0,
                                          int S) {
  for (int idx = threadIdx.x; idx < kTile * DH; idx += kThreads) {
    const int r = idx / DH;
    const int d = idx - r * DH;
    const int gr = r0 + r;
    dst[r * (DH + 1) + d] = gr < S ? to_f32(src[static_cast<long long>(gr) * DH + d]) : 0.f;
  }
}

template <int DH>
constexpr size_t fwd_smem() {
  return (3 * kTile * (DH + 1) + kTile * kPLd) * sizeof(float);
}
template <int DH>
constexpr size_t dkdv_smem() {
  return (4 * kTile * (DH + 1) + 2 * kTile * kPLd + 2 * kTile) * sizeof(float);
}
template <int DH>
constexpr size_t dq_smem() {
  return (4 * kTile * (DH + 1) + kTile * kPLd) * sizeof(float);
}

// Thread (ty, tx) of the 16 x 16 grid owns rows ty + 16 i and columns
// tx + 16 j (i, j < 4) of a (64, 64) score tile, and rows ty + 16 i and
// columns tx + 16 j (j < DH / 16) of a (64, DH) accumulator.

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int S, float scale, bool causal) {
  constexpr int LD = DH + 1;
  constexpr int NJ = DH / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kTile * LD;
  float* vs = ks + kTile * LD;
  float* ps = vs + kTile * LD;
  const int q0 = blockIdx.x * kTile;
  const long long bh = blockIdx.y;
  const long long base = bh * S * DH;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile<T, DH>(qs, q + base, q0, S);
  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }
  const int nk = (S + kTile - 1) / kTile;
  const int kend = causal ? min(nk, (q0 + kTile - 1) / kTile + 1) : nk;
  for (int kt = 0; kt < kend; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's ks, vs and ps are consumed
    load_tile<T, DH>(ks, k + base, k0, S);
    load_tile<T, DH>(vs, v + base, k0, S);
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        float val = s[i][j] * scale;
        if (c >= S || (causal && c > r)) val = kNegInf;
        s[i][j] = val;
        mx = fmaxf(mx, val);
      }
      const float m_new = fmaxf(m[i], row16_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rowsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rowsum += p;
        ps[(ty + 16 * i) * kPLd + tx + 16 * j] = round_to<T>(p);
      }
      l[i] = l[i] * alpha + row16_sum(rowsum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = ps[(ty + 16 * i) * kPLd + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = vs[c * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pa[i], vv, acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= S) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      o[base + static_cast<long long>(r) * DH + tx + 16 * j] = from_f32<T>(acc[i][j] / l[i]);
    }
    if (tx == 0) lse[bh * S + r] = m[i] + logf(l[i]);
  }
}

// dK and dV for one key tile, looping over the query tiles that see it.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int S, float scale,
                          bool causal) {
  constexpr int LD = DH + 1;
  constexpr int NJ = DH / 16;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kTile * LD;
  float* qs = vs + kTile * LD;
  float* dos = qs + kTile * LD;
  float* ps = dos + kTile * LD;
  float* dss = ps + kTile * kPLd;
  float* lse_s = dss + kTile * kPLd;
  float* delta_s = lse_s + kTile;
  const int k0 = blockIdx.x * kTile;
  const long long bh = blockIdx.y;
  const long long base = bh * S * DH;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile<T, DH>(ks, k + base, k0, S);
  load_tile<T, DH>(vs, v + base, k0, S);
  float dk_acc[4][NJ], dv_acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dk_acc[i][j] = 0.f;
      dv_acc[i][j] = 0.f;
    }
  const int nq = (S + kTile - 1) / kTile;
  for (int qt = causal ? k0 / kTile : 0; qt < nq; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // the previous tile's qs, dos, ps, dss are consumed
    load_tile<T, DH>(qs, q + base, q0, S);
    load_tile<T, DH>(dos, dout + base, q0, S);
    if (threadIdx.x < kTile) {
      const int r = q0 + threadIdx.x;
      lse_s[threadIdx.x] = r < S ? lse[bh * S + r] : 0.f;
      delta_s[threadIdx.x] = r < S ? delta[bh * S + r] : 0.f;
    }
    __syncthreads();
    // scores and dP = dO V^T for query rows ty + 16 i, key columns tx + 16 j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = 0.f;
        dp[i][j] = 0.f;
      }
#pragma unroll 2
    for (int d = 0; d < DH; ++d) {
      float qa[4], da[4], kb[4], vb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qa[i] = qs[(ty + 16 * i) * LD + d];
        da[i] = dos[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kb[j] = ks[(tx + 16 * j) * LD + d];
        vb[j] = vs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
          dp[i][j] = fmaf(da[i], vb[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rl = ty + 16 * i;
      const int r = q0 + rl;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cl = tx + 16 * j;
        const int c = k0 + cl;
        const bool valid = r < S && c < S && !(causal && c > r);
        const float p = valid ? expf(s[i][j] * scale - lse_s[rl]) : 0.f;
        ps[rl * kPLd + cl] = round_to<T>(p);
        dss[rl * kPLd + cl] = round_to<T>(p * (dp[i][j] - delta_s[rl]) * scale);
      }
    }
    __syncthreads();
    // dV[c] += sum_r P[r][c] dO[r];  dK[c] += sum_r dS[r][c] Q[r], for key
    // rows c = ty + 16 i
#pragma unroll 2
    for (int r = 0; r < kTile; ++r) {
      float pa[4], sa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[i] = ps[r * kPLd + ty + 16 * i];
        sa[i] = dss[r * kPLd + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float dov = dos[r * LD + tx + 16 * j];
        const float qv = qs[r * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv_acc[i][j] = fmaf(pa[i], dov, dv_acc[i][j]);
          dk_acc[i][j] = fmaf(sa[i], qv, dk_acc[i][j]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = k0 + ty + 16 * i;
    if (c >= S) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const long long at = base + static_cast<long long>(c) * DH + tx + 16 * j;
      dk[at] = from_f32<T>(dk_acc[i][j]);
      dv[at] = from_f32<T>(dv_acc[i][j]);
    }
  }
}

// dQ for one query tile, looping over the key tiles it sees.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        T* __restrict__ dq, int S, float scale, bool causal) {
  constexpr int LD = DH + 1;
  constexpr int NJ = DH / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kTile * LD;
  float* ks = dos + kTile * LD;
  float* vs = ks + kTile * LD;
  float* dss = vs + kTile * LD;
  const int q0 = blockIdx.x * kTile;
  const long long bh = blockIdx.y;
  const long long base = bh * S * DH;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile<T, DH>(qs, q + base, q0, S);
  load_tile<T, DH>(dos, dout + base, q0, S);
  float lse_r[4], delta_r[4], dq_acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    lse_r[i] = r < S ? lse[bh * S + r] : 0.f;
    delta_r[i] = r < S ? delta[bh * S + r] : 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) dq_acc[i][j] = 0.f;
  }
  const int nk = (S + kTile - 1) / kTile;
  const int kend = causal ? min(nk, (q0 + kTile - 1) / kTile + 1) : nk;
  for (int kt = 0; kt < kend; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's ks, vs, dss are consumed
    load_tile<T, DH>(ks, k + base, k0, S);
    load_tile<T, DH>(vs, v + base, k0, S);
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = 0.f;
        dp[i][j] = 0.f;
      }
#pragma unroll 2
    for (int d = 0; d < DH; ++d) {
      float qa[4], da[4], kb[4], vb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qa[i] = qs[(ty + 16 * i) * LD + d];
        da[i] = dos[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kb[j] = ks[(tx + 16 * j) * LD + d];
        vb[j] = vs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
          dp[i][j] = fmaf(da[i], vb[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rl = ty + 16 * i;
      const int r = q0 + rl;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cl = tx + 16 * j;
        const int c = k0 + cl;
        const bool valid = r < S && c < S && !(causal && c > r);
        const float p = valid ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        dss[rl * kPLd + cl] = round_to<T>(p * (dp[i][j] - delta_r[i]) * scale);
      }
    }
    __syncthreads();
    // dQ[r] += sum_c dS[r][c] K[c]
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float sa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sa[i] = dss[(ty + 16 * i) * kPLd + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float kv = ks[c * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) dq_acc[i][j] = fmaf(sa[i], kv, dq_acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= S) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dq[base + static_cast<long long>(r) * DH + tx + 16 * j] = from_f32<T>(dq_acc[i][j]);
    }
  }
}

// ------------------------------------------------------------------ //
// bf16 route: tensor cores (mma.sync m16n8k16), cp.async, ldmatrix
// ------------------------------------------------------------------ //

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kBM = 16 * kMmaWarps;  // query rows of a forward / dQ block
constexpr int kBN = 64;              // key rows of a tile, and of a dK/dV block
// query rows of a dK/dV loop step: 16 at Dh 128, where 32 would need more
// than the 255 registers a thread may hold (the dK and dV accumulators
// alone take 128)
template <int DH>
constexpr int kBQ = DH == 128 ? 16 : 32;

// rows [r0, r0 + ROWS) of a (S, DH) bf16 matrix into a swizzled tile with
// cp.async; rows at or past S are zero-filled
template <int DH, int ROWS>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* __restrict__ src, int r0,
                                                int S, int tid) {
  constexpr int CPR = DH / 8;
  static_assert((ROWS * CPR) % kMmaThreads == 0, "whole chunks a thread");
#pragma unroll
  for (int it = 0; it < ROWS * CPR / kMmaThreads; ++it) {
    const int i = tid + it * kMmaThreads;
    const int r = i / CPR;
    const int c = i - r * CPR;
    const bool ok = r0 + r < S;
    const bf16* g = src + static_cast<long long>(ok ? r0 + r : 0) * DH + c * 8;
    cp_async16(smem_u32(dst + r * DH + swz<DH>(r, c) * 8), g, ok);
  }
}

// ROWS fp32 values (lse or delta) of rows [r0, r0 + ROWS), 0 past S
template <int ROWS>
__device__ __forceinline__ void load_rows_async(float* dst, const float* __restrict__ src,
                                                int r0, int S, int tid) {
  if (tid < ROWS) {
    const bool ok = r0 + tid < S;
    cp_async4(smem_u32(dst + tid), src + (ok ? r0 + tid : 0), ok);
  }
}

template <int DH>
constexpr size_t fwd_mma_smem() {  // Q, then two stages of K and of V
  return (kBM + 4 * kBN) * DH * sizeof(bf16);
}
template <int DH>
constexpr size_t dkdv_mma_smem() {  // K, V; two stages of Q, dO, lse, delta
  return (2 * kBN + 4 * kBQ<DH>) * DH * sizeof(bf16) + 4 * kBQ<DH> * sizeof(float);
}
template <int DH>
constexpr size_t dq_mma_smem() {  // Q, dO; two stages of K and of V
  return (2 * kBM + 4 * kBN) * DH * sizeof(bf16);
}

template <int DH>
__global__ void __launch_bounds__(kMmaThreads, 2)
    flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ o,
                         float* __restrict__ lse, int S, float scale, bool causal) {
  constexpr int KS = DH / 16;  // k steps over the head dim
  constexpr int ND = DH / 8;   // 8-column tiles of the output
  constexpr int NN = kBN / 8;  // 8-column tiles of a score tile
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + kBM * DH;
  bf16* vs = ks + 2 * kBN * DH;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w0 = (tid >> 5) * 16;  // the warp's first row of the tile
  const int g = lane >> 2;
  const int t = lane & 3;
  const int nq = (S + kBM - 1) / kBM;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.y)) * kBM;
  const long long bh = blockIdx.x;
  const long long base = bh * S * DH;
  const int nk = (S + kBN - 1) / kBN;
  const int kend = causal ? min(nk, (q0 + kBM - 1) / kBN + 1) : nk;

  load_tile_async<DH, kBM>(qs, q + base, q0, S, tid);
  load_tile_async<DH, kBN>(ks, k + base, 0, S, tid);
  load_tile_async<DH, kBN>(vs, v + base, 0, S, tid);
  cp_async_commit();

  uint32_t qf[KS][4];
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  // running max and the thread's part of the row sum, rows g and g + 8
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  for (int kt = 0; kt < kend; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < kend) {
      load_tile_async<DH, kBN>(ks + (st ^ 1) * kBN * DH, k + base, (kt + 1) * kBN, S, tid);
      load_tile_async<DH, kBN>(vs + (st ^ 1) * kBN * DH, v + base, (kt + 1) * kBN, S, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) ldsm_x4(a_addr<DH>(qs, w0, kk, lane), qf[kk]);
    }
    const bf16* kst = ks + st * kBN * DH;
    const bf16* vst = vs + st * kBN * DH;
    float s[NN][4];
#pragma unroll
    for (int j = 0; j < NN; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int np = 0; np < NN / 2; ++np) {
        uint32_t b[4];
        ldsm_x4(b_addr<DH>(kst, 16 * np, kk, lane), b);
        mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
      }
    }
    const int k0 = kt * kBN;
    const bool mask = k0 + kBN > S || (causal && k0 + kBN - 1 > q0 + w0);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NN; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float val = s[j][e] * scale;
        if (mask) {
          const int c = k0 + 8 * j + 2 * t + (e & 1);
          const int r = q0 + w0 + g + 8 * (e >> 1);
          if (c >= S || (causal && c > r)) val = kNegInf;
        }
        s[j][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = fast_exp2((m[i] - mx[i]) * kLog2e);
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < NN; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fast_exp2((s[j][e] - m[e >> 1]) * kLog2e);
        s[j][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }
    // O += P V: P's bf16 A operand straight from the score accumulators
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      uint32_t pa[4];
      a_from_acc(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp) {
        uint32_t b[4];
        ldsm_x4_trans(a_addr<DH>(vst, 16 * kk, dp, lane), b);
        mma_bf16(acc[2 * dp], pa, b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with stage st before it refills
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int j = 0; j < ND; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] /= l[e >> 1];
  }
  // o = acc / l; the warp's own rows of the Q tile (read only by this warp,
  // and only into qf) stage it
  store_rows<DH>(qs, w0, acc, o + base, q0 + w0, S, DH, DH / 8, lane);
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = q0 + w0 + g + 8 * i;
      if (r < S) lse[bh * S + r] = m[i] + logf(l[i]);
    }
  }
}

// delta = rowsum(dO * O) in fp32 over (rows, DH) row-major o and dout
template <typename T, int DH>
__global__ void __launch_bounds__(256)
    flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                          float* __restrict__ delta, long long rows) {
  rowsum_dot<T, DH>(o, dout, delta, rows);
}

// dK and dV for one 64-row key tile (warp w: keys 16w..), looping over
// kBQ-row query tiles. S^T = K Q^T and dP^T = V dO^T come out with keys as
// rows, so P^T and dS^T are the A operands of dV += P^T dO and
// dK += dS^T Q without leaving registers.
template <int DH>
__global__ void __launch_bounds__(kMmaThreads, 2)
    flash_bwd_dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const bf16* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              bf16* __restrict__ dk, bf16* __restrict__ dv, int S, float scale,
                              bool causal) {
  constexpr int KS = DH / 16;
  constexpr int ND = DH / 8;
  constexpr int BQ = kBQ<DH>;
  constexpr int NQ = BQ / 8;  // 8-column (query) tiles of S^T
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + kBN * DH;
  bf16* qs = vs + kBN * DH;      // [2][BQ][DH]
  bf16* dos = qs + 2 * BQ * DH;  // [2][BQ][DH]
  float* lse_s = reinterpret_cast<float*>(dos + 2 * BQ * DH);  // [2][BQ]
  float* dl_s = lse_s + 2 * BQ;                                // [2][BQ]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w0 = (tid >> 5) * 16;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int k0 = blockIdx.y * kBN;  // key tile 0, which every query sees, first
  const long long bh = blockIdx.x;
  const long long base = bh * S * DH;
  const float* lse_bh = lse + bh * S;
  const float* dl_bh = delta + bh * S;
  const int nqt = (S + BQ - 1) / BQ;
  const int qbeg = causal ? k0 / BQ : 0;

  load_tile_async<DH, kBN>(ks, k + base, k0, S, tid);
  load_tile_async<DH, kBN>(vs, v + base, k0, S, tid);
  load_tile_async<DH, BQ>(qs, q + base, qbeg * BQ, S, tid);
  load_tile_async<DH, BQ>(dos, dout + base, qbeg * BQ, S, tid);
  load_rows_async<BQ>(lse_s, lse_bh, qbeg * BQ, S, tid);
  load_rows_async<BQ>(dl_s, dl_bh, qbeg * BQ, S, tid);
  cp_async_commit();

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;
  }
  for (int qt = qbeg; qt < nqt; ++qt) {
    const int st = (qt - qbeg) & 1;
    if (qt + 1 < nqt) {
      const int n0 = (qt + 1) * BQ;
      load_tile_async<DH, BQ>(qs + (st ^ 1) * BQ * DH, q + base, n0, S, tid);
      load_tile_async<DH, BQ>(dos + (st ^ 1) * BQ * DH, dout + base, n0, S, tid);
      load_rows_async<BQ>(lse_s + (st ^ 1) * BQ, lse_bh, n0, S, tid);
      load_rows_async<BQ>(dl_s + (st ^ 1) * BQ, dl_bh, n0, S, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = qt * BQ;
    // a warp whose keys all follow every query of the tile gets P = 0
    if (!(causal && q0 + BQ - 1 < k0 + w0)) {
      const bf16* qst = qs + st * BQ * DH;
      const bf16* dost = dos + st * BQ * DH;
      float sT[NQ][4], dpT[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sT[j][e] = dpT[j][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ka[4], va[4];
        ldsm_x4(a_addr<DH>(ks, w0, kk, lane), ka);
        ldsm_x4(a_addr<DH>(vs, w0, kk, lane), va);
#pragma unroll
        for (int np = 0; np < NQ / 2; ++np) {
          uint32_t b[4];
          ldsm_x4(b_addr<DH>(qst, 16 * np, kk, lane), b);
          mma_bf16(sT[2 * np], ka, b[0], b[1]);
          mma_bf16(sT[2 * np + 1], ka, b[2], b[3]);
          ldsm_x4(b_addr<DH>(dost, 16 * np, kk, lane), b);
          mma_bf16(dpT[2 * np], va, b[0], b[1]);
          mma_bf16(dpT[2 * np + 1], va, b[2], b[3]);
        }
      }
      const bool mask =
          q0 + BQ > S || k0 + kBN > S || (causal && q0 < k0 + w0 + 15);
      const float* lse_t = lse_s + st * BQ;
      const float* dl_t = dl_s + st * BQ;
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = 8 * j + 2 * t + (e & 1);  // query of the tile
          float p = exp2f((sT[j][e] * scale - lse_t[qc]) * kLog2e);
          if (mask) {
            const int qg = q0 + qc;
            const int kg = k0 + w0 + g + 8 * (e >> 1);
            if (qg >= S || kg >= S || (causal && kg > qg)) p = 0.f;
          }
          sT[j][e] = p;
          dpT[j][e] = p * (dpT[j][e] - dl_t[qc]) * scale;
        }
      }
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t pa[4], da[4];
        a_from_acc(pa, sT[2 * kk], sT[2 * kk + 1]);
        a_from_acc(da, dpT[2 * kk], dpT[2 * kk + 1]);
#pragma unroll
        for (int dp = 0; dp < DH / 16; ++dp) {
          uint32_t b[4];
          ldsm_x4_trans(a_addr<DH>(dost, 16 * kk, dp, lane), b);
          mma_bf16(dva[2 * dp], pa, b[0], b[1]);
          mma_bf16(dva[2 * dp + 1], pa, b[2], b[3]);
          ldsm_x4_trans(a_addr<DH>(qst, 16 * kk, dp, lane), b);
          mma_bf16(dka[2 * dp], da, b[0], b[1]);
          mma_bf16(dka[2 * dp + 1], da, b[2], b[3]);
        }
      }
    }
    __syncthreads();
  }
  // the warp's own rows of the K and V tiles (read only by this warp) stage
  // dK and dV
  store_rows<DH>(ks, w0, dka, dk + base, k0 + w0, S, DH, DH / 8, lane);
  store_rows<DH>(vs, w0, dva, dv + base, k0 + w0, S, DH, DH / 8, lane);
}

// dQ for one 64-row query tile (warp w: rows 16w..), looping over the key
// tiles it sees: S = Q K^T and dP = dO V^T, then dQ += dS K.
template <int DH>
__global__ void __launch_bounds__(kMmaThreads, 2)
    flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const bf16* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            bf16* __restrict__ dq, int S, float scale, bool causal) {
  constexpr int KS = DH / 16;
  constexpr int ND = DH / 8;
  constexpr int NN = kBN / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + kBM * DH;
  bf16* ks = dos + kBM * DH;     // [2][kBN][DH]
  bf16* vs = ks + 2 * kBN * DH;  // [2][kBN][DH]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w0 = (tid >> 5) * 16;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int nq = (S + kBM - 1) / kBM;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.y)) * kBM;
  const long long bh = blockIdx.x;
  const long long base = bh * S * DH;
  const int nk = (S + kBN - 1) / kBN;
  const int kend = causal ? min(nk, (q0 + kBM - 1) / kBN + 1) : nk;

  load_tile_async<DH, kBM>(qs, q + base, q0, S, tid);
  load_tile_async<DH, kBM>(dos, dout + base, q0, S, tid);
  load_tile_async<DH, kBN>(ks, k + base, 0, S, tid);
  load_tile_async<DH, kBN>(vs, v + base, 0, S, tid);
  cp_async_commit();

  float lse_r[2], dl_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + w0 + g + 8 * i;
    lse_r[i] = r < S ? lse[bh * S + r] : 0.f;
    dl_r[i] = r < S ? delta[bh * S + r] : 0.f;
  }
  float dqa[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) dqa[j][0] = dqa[j][1] = dqa[j][2] = dqa[j][3] = 0.f;
  for (int kt = 0; kt < kend; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < kend) {
      load_tile_async<DH, kBN>(ks + (st ^ 1) * kBN * DH, k + base, (kt + 1) * kBN, S, tid);
      load_tile_async<DH, kBN>(vs + (st ^ 1) * kBN * DH, v + base, (kt + 1) * kBN, S, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kst = ks + st * kBN * DH;
    const bf16* vst = vs + st * kBN * DH;
    float s[NN][4], dp[NN][4];
#pragma unroll
    for (int j = 0; j < NN; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4], da[4];
      ldsm_x4(a_addr<DH>(qs, w0, kk, lane), qa);
      ldsm_x4(a_addr<DH>(dos, w0, kk, lane), da);
#pragma unroll
      for (int np = 0; np < NN / 2; ++np) {
        uint32_t b[4];
        ldsm_x4(b_addr<DH>(kst, 16 * np, kk, lane), b);
        mma_bf16(s[2 * np], qa, b[0], b[1]);
        mma_bf16(s[2 * np + 1], qa, b[2], b[3]);
        ldsm_x4(b_addr<DH>(vst, 16 * np, kk, lane), b);
        mma_bf16(dp[2 * np], da, b[0], b[1]);
        mma_bf16(dp[2 * np + 1], da, b[2], b[3]);
      }
    }
    const int k0 = kt * kBN;
    const bool mask = k0 + kBN > S || (causal && k0 + kBN - 1 > q0 + w0);
#pragma unroll
    for (int j = 0; j < NN; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float p = exp2f((s[j][e] * scale - lse_r[i]) * kLog2e);
        if (mask) {
          const int c = k0 + 8 * j + 2 * t + (e & 1);
          const int r = q0 + w0 + g + 8 * i;
          if (c >= S || (causal && c > r)) p = 0.f;
        }
        dp[j][e] = p * (dp[j][e] - dl_r[i]) * scale;
      }
    }
    // dQ += dS K, K read across its rows (.trans)
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      uint32_t sa[4];
      a_from_acc(sa, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int dp2 = 0; dp2 < DH / 16; ++dp2) {
        uint32_t b[4];
        ldsm_x4_trans(a_addr<DH>(kst, 16 * kk, dp2, lane), b);
        mma_bf16(dqa[2 * dp2], sa, b[0], b[1]);
        mma_bf16(dqa[2 * dp2 + 1], sa, b[2], b[3]);
      }
    }
    __syncthreads();
  }
  // the warp's own rows of the Q tile (read only by this warp) stage dQ
  store_rows<DH>(qs, w0, dqa, dq + base, q0 + w0, S, DH, DH / 8, lane);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// fp32: the CUDA-core kernels
template <int DH>
int launch_fwd_f32(const void* q, const void* k, const void* v, void* o, void* lse, int BH,
                   int S, float scale, bool causal, cudaStream_t s) {
  constexpr size_t smem = fwd_smem<DH>();
  cudaError_t err = allow_smem(flash_fwd_kernel<float, DH>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kTile - 1) / kTile, BH);
  flash_fwd_kernel<float, DH><<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), S, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_bwd_f32(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dq, void* dk, void* dv, int BH,
                   int S, float scale, bool causal, cudaStream_t s) {
  const dim3 grid((S + kTile - 1) / kTile, BH);
  constexpr size_t smem_kv = dkdv_smem<DH>();
  cudaError_t err = allow_smem(flash_bwd_dkdv_kernel<float, DH>, smem_kv);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_kernel<float, DH><<<grid, kThreads, smem_kv, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv), S,
      scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr size_t smem_q = dq_smem<DH>();
  err = allow_smem(flash_bwd_dq_kernel<float, DH>, smem_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<float, DH><<<grid, kThreads, smem_q, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq), S, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// bf16: the tensor-core kernels
template <int DH>
int launch_fwd_bf16(const void* q, const void* k, const void* v, void* o, void* lse, int BH,
                    int S, float scale, bool causal, cudaStream_t s) {
  constexpr size_t smem = fwd_mma_smem<DH>();
  cudaError_t err = allow_smem(flash_fwd_mma_kernel<DH>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, (S + kBM - 1) / kBM);
  flash_fwd_mma_kernel<DH><<<grid, kMmaThreads, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), S, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_bwd_bf16(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dq, void* dk, void* dv, int BH,
                    int S, float scale, bool causal, cudaStream_t s) {
  constexpr size_t smem_kv = dkdv_mma_smem<DH>();
  cudaError_t err = allow_smem(flash_bwd_dkdv_mma_kernel<DH>, smem_kv);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_mma_kernel<DH><<<dim3(BH, (S + kBN - 1) / kBN), kMmaThreads, smem_kv, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), S,
      scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr size_t smem_q = dq_mma_smem<DH>();
  err = allow_smem(flash_bwd_dq_mma_kernel<DH>, smem_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_mma_kernel<DH><<<dim3(BH, (S + kBM - 1) / kBM), kMmaThreads, smem_q, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), S, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DH>
int launch_delta(const void* o, const void* dout, void* delta, long long rows, cudaStream_t s) {
  flash_bwd_delta_kernel<T, DH><<<static_cast<unsigned>((rows + 63) / 64), 256, 0, s>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), static_cast<float*>(delta), rows);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int info_dh(int which, int dtype, int* out) {
  if (dtype == kDtypeBF16) {
    switch (which) {
      case 0: return kernel_info(flash_fwd_mma_kernel<DH>, fwd_mma_smem<DH>(), kMmaThreads, out);
      case 1:
        return kernel_info(flash_bwd_dkdv_mma_kernel<DH>, dkdv_mma_smem<DH>(), kMmaThreads,
                           out);
      case 2: return kernel_info(flash_bwd_dq_mma_kernel<DH>, dq_mma_smem<DH>(), kMmaThreads, out);
      case 3: return kernel_info(flash_bwd_delta_kernel<bf16, DH>, 0, 256, out);
    }
  } else if (dtype == kDtypeF32) {
    switch (which) {
      case 0: return kernel_info(flash_fwd_kernel<float, DH>, fwd_smem<DH>(), kThreads, out);
      case 1: return kernel_info(flash_bwd_dkdv_kernel<float, DH>, dkdv_smem<DH>(), kThreads, out);
      case 2: return kernel_info(flash_bwd_dq_kernel<float, DH>, dq_smem<DH>(), kThreads, out);
      case 3: return kernel_info(flash_bwd_delta_kernel<float, DH>, 0, 256, out);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// ``return call;`` with the constexpr DH bound to a supported head dim
#define DS_FLASH_BY_DH(dh, call)                                    \
  switch (dh) {                                                     \
    case 64: { constexpr int DH = 64; return call; }                \
    case 96: { constexpr int DH = 96; return call; }                \
    case 128: { constexpr int DH = 128; return call; }              \
    default: return static_cast<int>(cudaErrorInvalidValue);        \
  }

// BH is grid.y of the fp32 launches; the bf16 ones put S / 64 tiles there
bool bad_geometry(int BH, int S) {
  return BH <= 0 || BH > 65535 || S <= 0 || S > 65535 * kTile;
}

}  // namespace

extern "C" {

const char* ds_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, k, v, o: (BH, S, Dh) of dtype, contiguous, 16-byte aligned; lse: (BH, S) fp32.
int ds_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int BH,
                 int S, int Dh, float scale, int causal, int dtype, void* stream) {
  if (bad_geometry(BH, S)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool c = causal != 0;
  if (dtype == kDtypeF32) {
    DS_FLASH_BY_DH(Dh, launch_fwd_f32<DH>(q, k, v, o, lse, BH, S, scale, c, s));
  }
  if (dtype == kDtypeBF16) {
    DS_FLASH_BY_DH(Dh, launch_fwd_bf16<DH>(q, k, v, o, lse, BH, S, scale, c, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// o, dout: (BH, S, Dh) of dtype; delta: (BH, S) fp32 out, rowsum(dout * o).
int ds_flash_bwd_delta(const void* o, const void* dout, void* delta, int BH, int S, int Dh,
                       int dtype, void* stream) {
  if (bad_geometry(BH, S)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(BH) * S;
  if (dtype == kDtypeF32) {
    DS_FLASH_BY_DH(Dh, (launch_delta<float, DH>(o, dout, delta, rows, s)));
  }
  if (dtype == kDtypeBF16) {
    DS_FLASH_BY_DH(Dh, (launch_delta<bf16, DH>(o, dout, delta, rows, s)));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// q, k, v, dout, dq, dk, dv: (BH, S, Dh) of dtype; lse, delta: (BH, S) fp32.
int ds_flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                 const void* lse, const void* delta, void* dq, void* dk, void* dv, int BH,
                 int S, int Dh, float scale, int causal, int dtype, void* stream) {
  if (bad_geometry(BH, S)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool c = causal != 0;
  if (dtype == kDtypeF32) {
    DS_FLASH_BY_DH(Dh, launch_bwd_f32<DH>(q, k, v, dout, lse, delta, dq, dk, dv, BH, S, scale,
                                          c, s));
  }
  if (dtype == kDtypeBF16) {
    DS_FLASH_BY_DH(Dh, launch_bwd_bf16<DH>(q, k, v, dout, lse, delta, dq, dk, dv, BH, S,
                                           scale, c, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// which: 0 forward, 1 dK/dV, 2 dQ, 3 delta. out: 6 ints, see kernel_info.
int ds_flash_kernel_info(int which, int Dh, int dtype, int* out) {
  DS_FLASH_BY_DH(Dh, info_dh<DH>(which, dtype, out));
}

}  // extern "C"
