// Block-sparse attention, forward and backward, for Hopper (sm_90a). Built
// by ops/op_builder.py with nvcc into a shared library that
// ops/sparse_attention/block_sparse.py loads with ctypes; every entry point
// has a plain C interface, launches on the stream it is given, allocates
// nothing and returns cudaGetLastError() so the wrapper can raise on a
// refused launch.
//
// sparse_fwd replaces both Pallas forwards of the reference
// (deeperspeed_tpu/ops/sparse_attention/kernels.py): _bs_fwd_kernel over a
// flat LUT (launched by _bs_fwd) and _bs_fwd_res_kernel, which pins
// whole-S K and V in VMEM and walks 4 x 4 super-tiles through a bitmap LUT
// (launched by _bs_fwd_res). sparse_bwd replaces both backwards: _bs_bwd's
// dq and dk/dv kernels and _bs_bwd_res's. Both pairs compute block-sparse
// softmax(Q K^T * scale) V with the fp32 logsumexp saved for a flash-2
// backward; they differ in how the TPU's VMEM holds K and V, which has no
// meaning here. So one forward and one backward take every layout, through
// CSR tables the host builds once (ops/sparse_attention/kernels.py): per
// (head, q-block) the active k-blocks, after the causal filter, and per
// (head, k-block) the active q-blocks for dK/dV.
//
// What bounds them: at the path shape (1, 16, 4096, 64) bf16 with the
// Fixed block-16 layout (density 0.262) the forward does ~18 GFLOP on
// ~34 MB and the backward ~45 GFLOP on ~68 MB, above the H100's ~295
// FLOP/byte ridge, so operations bound both.
//
// Semantics both routes keep:
//  * causal: the host drops the blocks above the diagonal before it
//    builds the tables; inside the diagonal blocks the kernels mask
//    element by element.
//  * the optional key mask (B, S) fp32 is an added bias on the scores; a
//    key whose mask is <= NEG_INF / 2 counts as not visible. A row with no
//    visible key writes o = 0 and lse = NEG_INF (-1e30, finite, as in the
//    reference), and its backward gives zero gradients, not NaN.
//  * rounding follows the reference: P is cast to the input dtype before
//    P V (kernels.py:243-246) and before dV += P^T dO, dS before its two
//    products (kernels.py:318, :368); sums of P and all accumulators stay
//    fp32.
//  * the backward stays deterministic: every output row is written by one
//    warp, which sums its terms in one fixed order, with no atomics, so a
//    relaunch repeats bit for bit. delta = rowsum(dO * O) is a kernel of
//    its own (sparse_bwd_delta), launched first.
//
// sparse_fwd and sparse_bwd, bf16 (the training path): mma.sync.m16n8k16
// bf16 -> fp32 on the tensor cores, as flash_attention.cu's kernels, with
// the helpers of tensor_core.cuh:
//  * one warp per 16-row tile (block 16 is exactly m16), four warps a
//    block. The host groups tiles whose block lists are identical, up to
//    four to a group (ops/sparse_attention/kernels.py, build_groups), and
//    the four warps of a group share every gathered tile. In the path's
//    Fixed layout the four query blocks of a local window share their
//    list, and so do the key blocks of a window that no global row sees,
//    and the global key blocks of one head. The forward walks the dQ
//    groups: four query tiles against one gather of K and V.
//  * each step gathers 64 rows of the other side through the group's list
//    (kept in shared memory), across block edges: 16-byte cp.async copies
//    into swizzled bf16 tiles, double-buffered, read by ldmatrix(.trans).
//  * the forward (sparse_fwd_mma): S = Q K^T with Q's fragments held in
//    registers, scaled, plus a per-key bias that carries the key mask and
//    -inf for a key that is not visible (past the list or hidden by the
//    mask); inside a diagonal block a causal row masks element by element.
//    The online softmax runs on the accumulator fragments in fp32 (max
//    and row sum over the quad of lanes that share a row), P is rounded
//    to bf16 and packed from the accumulators into the A operand of
//    O += P V, and o and lse = m + log l are written once. What bounds it
//    at the path shape is operations (~18 GFLOP): the tensor cores take
//    them in place of fp32 FMAs, and each 64-key gather of bf16 K and V
//    feeds four query tiles, where the CUDA-core kernel gathered fp32
//    tiles for each 16-row query block alone.
//  * dQ (sparse_bwd_dq_mma): S = Q K^T and dP = dO V^T, then dQ += dS K
//    with dS rounded to bf16 and packed from the accumulators into the A
//    operand. dK/dV (sparse_bwd_dkdv_mma) computes S^T = K Q^T and
//    dP^T = V dO^T, so P^T and dS^T are the A operands of dV += P^T dO and
//    dK += dS^T Q without leaving registers. At Dh 128 a step is taken 32
//    keys (16 queries in dK/dV) at a time: the dK and dV accumulators
//    alone take 128 registers a thread there.
//  * the groups run heaviest first: the host orders them by the length of
//    their list, so a global key block, which every query block sees,
//    starts in the first wave and not in the last.
//
// fp32 keeps the first port's CUDA-core kernels, a route by dtype: fp32
// FMAs over fp32 shared-memory tiles with row stride Dh + 1 (TF32 tensor
// cores would keep ~10 mantissa bits, short of the port's fp32
// tolerance):
//  * one 256-thread block per (batch*head, T-row tile of a q-block row),
//    T = min(block, 64): a 128 block is two 64-row tiles. The block walks
//    its row's active k-blocks in steps of 64 keys, gathered through the
//    CSR table (four 16-key blocks, two 32-key blocks, or one 64-key half
//    of a larger block per step), with the online-softmax state (m, l) and
//    the accumulators in registers, fp32. Nothing of size S x S reaches
//    device memory, and the work scales with the active blocks.
//  * the fp32 dK/dV kernel is the mirror image: one block per T-key tile,
//    walking the q-blocks that see it through the transposed table, 64
//    queries a step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tensor_core.cuh"

namespace {

constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;
constexpr int kChunk = 64;           // keys (queries in dK/dV) a step gathers
constexpr int kThreads = 256;        // a 16 x 16 grid of threads
constexpr int kCLd = kChunk + 1;     // row stride of the (T, 64) P / dS tiles
constexpr float kNegInf = -1e30f;    // the reference's NEG_INF
constexpr float kHalfNegInf = -5e29f;

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

// rows [r0, r0 + n) of a (S, DH) matrix into shared memory as fp32 with row
// stride DH + 1 (free of bank conflicts along rows and along columns)
template <typename T, int DH>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int r0,
                                          int n) {
  for (int idx = threadIdx.x; idx < n * DH; idx += kThreads) {
    const int r = idx / DH;
    const int d = idx - r * DH;
    dst[r * (DH + 1) + d] = to_f32(src[static_cast<long long>(r0 + r) * DH + d]);
  }
}

// the kChunk rows at positions pos_s[0..kChunk) (-1: a zero row)
template <typename T, int DH>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src,
                                          const int* pos_s) {
  for (int idx = threadIdx.x; idx < kChunk * DH; idx += kThreads) {
    const int r = idx / DH;
    const int d = idx - r * DH;
    const int p = pos_s[r];
    dst[r * (DH + 1) + d] = p >= 0 ? to_f32(src[static_cast<long long>(p) * DH + d]) : 0.f;
  }
}

// Position of entry c of step ci of a walk over n_tiles T-wide tiles: tile
// t covers [ids[off + t / R] * block + (t % R) * T, ... + T); -1 past the
// end. kChunk / T tiles make one step.
template <int T>
__device__ __forceinline__ int walk_pos(const int* __restrict__ ids, int off, int n_tiles,
                                        int ci, int c, int R, int block) {
  const int t = ci * (kChunk / T) + c / T;
  if (t >= n_tiles) return -1;
  return ids[off + t / R] * block + (t % R) * T + c % T;
}

template <int DH, int T>
constexpr size_t fwd_smem() {
  return ((T + 2 * kChunk) * (DH + 1) + T * kCLd + 2 * kChunk) * sizeof(float);
}
template <int DH, int T>
constexpr size_t dq_smem() {
  return ((2 * T + 2 * kChunk) * (DH + 1) + T * kCLd + 2 * kChunk) * sizeof(float);
}
template <int DH, int T>
constexpr size_t dkdv_smem() {
  return ((2 * T + 2 * kChunk) * (DH + 1) + 2 * T * kCLd + 3 * kChunk) * sizeof(float);
}

// Thread (ty, tx) of the 16 x 16 grid owns rows ty + 16 i (i < T / 16) of
// the block's T-row tile; in a (T, 64) score tile the columns tx + 16 j
// (j < 4), in a (T, DH) accumulator the columns tx + 16 j (j < DH / 16).

template <typename Tp, int DH, int T>
__global__ void __launch_bounds__(kThreads)
    sparse_fwd_kernel(const Tp* __restrict__ q, const Tp* __restrict__ k,
                      const Tp* __restrict__ v, const float* __restrict__ mask,
                      const int* __restrict__ row_offsets, const int* __restrict__ row_cols,
                      Tp* __restrict__ o, float* __restrict__ lse, int H, int S, int block,
                      float scale, bool causal) {
  constexpr int LD = DH + 1;
  constexpr int NJ = DH / 16;
  constexpr int RPT = T / 16;
  constexpr int NC = kChunk / T;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + T * LD;
  float* vs = ks + kChunk * LD;
  float* ps = vs + kChunk * LD;
  float* bias_s = ps + T * kCLd;
  int* pos_s = reinterpret_cast<int*>(bias_s + kChunk);
  const int R = block / T;
  const int nb = S / block;
  const int q0 = blockIdx.x * T;
  const int qb = blockIdx.x / R;
  const long long bh = blockIdx.y;
  const int h = static_cast<int>(bh % H);
  const float* mrow = mask ? mask + (bh / H) * S : nullptr;
  const long long base = bh * S * DH;
  const int off = row_offsets[h * nb + qb];
  const int n_tiles = (row_offsets[h * nb + qb + 1] - off) * R;
  const int n_steps = (n_tiles + NC - 1) / NC;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile<Tp, DH>(qs, q + base, q0, T);
  float m[RPT], l[RPT], acc[RPT][NJ];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }
  for (int ci = 0; ci < n_steps; ++ci) {
    __syncthreads();  // the previous step's ks, vs, ps and positions are consumed
    if (threadIdx.x < kChunk) {
      int p = walk_pos<T>(row_cols, off, n_tiles, ci, threadIdx.x, R, block);
      float bias = 0.f;
      if (p >= 0 && mrow) {
        bias = mrow[p];
        if (bias <= kHalfNegInf) p = -1;
      }
      pos_s[threadIdx.x] = p;
      bias_s[threadIdx.x] = bias;
    }
    __syncthreads();
    load_rows<Tp, DH>(ks, k + base, pos_s);
    load_rows<Tp, DH>(vs, v + base, pos_s);
    __syncthreads();
    float s[RPT][4];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float qa[RPT], kb[4];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qa[i] = qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = q0 + ty + 16 * i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int p = pos_s[c];
        ok[j] = p >= 0 && !(causal && p > r);
        s[i][j] = ok[j] ? s[i][j] * scale + bias_s[c] : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row16_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rowsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        rowsum += p;
        ps[(ty + 16 * i) * kCLd + tx + 16 * j] = round_to<Tp>(p);
      }
      l[i] = l[i] * alpha + row16_sum(rowsum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kChunk; ++c) {
      float pa[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pa[i] = ps[(ty + 16 * i) * kCLd + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = vs[c * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][j] = fmaf(pa[i], vv, acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = q0 + ty + 16 * i;
    const bool alive = l[i] > 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      o[base + static_cast<long long>(r) * DH + tx + 16 * j] =
          from_f32<Tp>(alive ? acc[i][j] / l[i] : 0.f);
    }
    if (tx == 0) lse[bh * S + r] = alive ? m[i] + logf(l[i]) : kNegInf;
  }
}

// dQ for one T-row query tile, walking the key blocks its row sees.
template <typename Tp, int DH, int T>
__global__ void __launch_bounds__(kThreads)
    sparse_bwd_dq_kernel(const Tp* __restrict__ q, const Tp* __restrict__ k,
                         const Tp* __restrict__ v, const Tp* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const float* __restrict__ mask, const int* __restrict__ row_offsets,
                         const int* __restrict__ row_cols, Tp* __restrict__ dq, int H, int S,
                         int block, float scale, bool causal) {
  constexpr int LD = DH + 1;
  constexpr int NJ = DH / 16;
  constexpr int RPT = T / 16;
  constexpr int NC = kChunk / T;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + T * LD;
  float* ks = dos + T * LD;
  float* vs = ks + kChunk * LD;
  float* dss = vs + kChunk * LD;
  float* bias_s = dss + T * kCLd;
  int* pos_s = reinterpret_cast<int*>(bias_s + kChunk);
  const int R = block / T;
  const int nb = S / block;
  const int q0 = blockIdx.x * T;
  const int qb = blockIdx.x / R;
  const long long bh = blockIdx.y;
  const int h = static_cast<int>(bh % H);
  const float* mrow = mask ? mask + (bh / H) * S : nullptr;
  const long long base = bh * S * DH;
  const int off = row_offsets[h * nb + qb];
  const int n_tiles = (row_offsets[h * nb + qb + 1] - off) * R;
  const int n_steps = (n_tiles + NC - 1) / NC;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile<Tp, DH>(qs, q + base, q0, T);
  load_tile<Tp, DH>(dos, dout + base, q0, T);
  float lse_r[RPT], delta_r[RPT], dq_acc[RPT][NJ];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = q0 + ty + 16 * i;
    lse_r[i] = lse[bh * S + r];
    delta_r[i] = delta[bh * S + r];
#pragma unroll
    for (int j = 0; j < NJ; ++j) dq_acc[i][j] = 0.f;
  }
  for (int ci = 0; ci < n_steps; ++ci) {
    __syncthreads();  // the previous step's ks, vs, dss and positions are consumed
    if (threadIdx.x < kChunk) {
      int p = walk_pos<T>(row_cols, off, n_tiles, ci, threadIdx.x, R, block);
      float bias = 0.f;
      if (p >= 0 && mrow) {
        bias = mrow[p];
        if (bias <= kHalfNegInf) p = -1;
      }
      pos_s[threadIdx.x] = p;
      bias_s[threadIdx.x] = bias;
    }
    __syncthreads();
    load_rows<Tp, DH>(ks, k + base, pos_s);
    load_rows<Tp, DH>(vs, v + base, pos_s);
    __syncthreads();
    float s[RPT][4], dp[RPT][4];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = 0.f;
        dp[i][j] = 0.f;
      }
#pragma unroll 2
    for (int d = 0; d < DH; ++d) {
      float qa[RPT], da[RPT], kb[4], vb[4];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        qa[i] = qs[(ty + 16 * i) * LD + d];
        da[i] = dos[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kb[j] = ks[(tx + 16 * j) * LD + d];
        vb[j] = vs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
          dp[i][j] = fmaf(da[i], vb[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int rl = ty + 16 * i;
      const int r = q0 + rl;
      const bool alive = lse_r[i] > kHalfNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int p_at = pos_s[c];
        const bool ok = alive && p_at >= 0 && !(causal && p_at > r);
        const float p = ok ? expf(s[i][j] * scale + bias_s[c] - lse_r[i]) : 0.f;
        dss[rl * kCLd + c] = round_to<Tp>(p * (dp[i][j] - delta_r[i]) * scale);
      }
    }
    __syncthreads();
    // dQ[r] += sum_c dS[r][c] K[c]
#pragma unroll 4
    for (int c = 0; c < kChunk; ++c) {
      float sa[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) sa[i] = dss[(ty + 16 * i) * kCLd + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float kv = ks[c * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i) dq_acc[i][j] = fmaf(sa[i], kv, dq_acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = q0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dq[base + static_cast<long long>(r) * DH + tx + 16 * j] = from_f32<Tp>(dq_acc[i][j]);
    }
  }
}

// dK and dV for one T-key tile, walking the query blocks that see it
// through the transposed table.
template <typename Tp, int DH, int T>
__global__ void __launch_bounds__(kThreads)
    sparse_bwd_dkdv_kernel(const Tp* __restrict__ q, const Tp* __restrict__ k,
                           const Tp* __restrict__ v, const Tp* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           const float* __restrict__ mask, const int* __restrict__ col_offsets,
                           const int* __restrict__ col_rows, Tp* __restrict__ dk,
                           Tp* __restrict__ dv, int H, int S, int block, float scale,
                           bool causal) {
  constexpr int LD = DH + 1;
  constexpr int NJ = DH / 16;
  constexpr int RPT = T / 16;
  constexpr int NC = kChunk / T;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + T * LD;
  float* qs = vs + T * LD;
  float* dos = qs + kChunk * LD;
  float* ps = dos + kChunk * LD;
  float* dss = ps + T * kCLd;
  float* lse_s = dss + T * kCLd;
  float* delta_s = lse_s + kChunk;
  int* pos_s = reinterpret_cast<int*>(delta_s + kChunk);
  const int R = block / T;
  const int nb = S / block;
  const int k0 = blockIdx.x * T;
  const int kb = blockIdx.x / R;
  const long long bh = blockIdx.y;
  const int h = static_cast<int>(bh % H);
  const float* mrow = mask ? mask + (bh / H) * S : nullptr;
  const long long base = bh * S * DH;
  const int off = col_offsets[h * nb + kb];
  const int n_tiles = (col_offsets[h * nb + kb + 1] - off) * R;
  const int n_steps = (n_tiles + NC - 1) / NC;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile<Tp, DH>(ks, k + base, k0, T);
  load_tile<Tp, DH>(vs, v + base, k0, T);
  float kbias[RPT], dk_acc[RPT][NJ], dv_acc[RPT][NJ];
  bool kvis[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const float bias = mrow ? mrow[k0 + ty + 16 * i] : 0.f;
    kvis[i] = bias > kHalfNegInf;
    kbias[i] = bias;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dk_acc[i][j] = 0.f;
      dv_acc[i][j] = 0.f;
    }
  }
  for (int ci = 0; ci < n_steps; ++ci) {
    __syncthreads();  // the previous step's qs, dos, ps, dss and rows are consumed
    if (threadIdx.x < kChunk) {
      const int p = walk_pos<T>(col_rows, off, n_tiles, ci, threadIdx.x, R, block);
      pos_s[threadIdx.x] = p;
      lse_s[threadIdx.x] = p >= 0 ? lse[bh * S + p] : kNegInf;
      delta_s[threadIdx.x] = p >= 0 ? delta[bh * S + p] : 0.f;
    }
    __syncthreads();
    load_rows<Tp, DH>(qs, q + base, pos_s);
    load_rows<Tp, DH>(dos, dout + base, pos_s);
    __syncthreads();
    // S^T and dP^T = V dO^T for key rows ty + 16 i, query columns tx + 16 j
    float st[RPT][4], dpt[RPT][4];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        st[i][j] = 0.f;
        dpt[i][j] = 0.f;
      }
#pragma unroll 2
    for (int d = 0; d < DH; ++d) {
      float ka[RPT], va[RPT], qc[4], dc[4];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        ka[i] = ks[(ty + 16 * i) * LD + d];
        va[i] = vs[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qc[j] = qs[(tx + 16 * j) * LD + d];
        dc[j] = dos[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          st[i][j] = fmaf(ka[i], qc[j], st[i][j]);
          dpt[i][j] = fmaf(va[i], dc[j], dpt[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int kl = ty + 16 * i;
      const int kpos = k0 + kl;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int qpos = pos_s[c];
        const bool ok = kvis[i] && qpos >= 0 && !(causal && kpos > qpos) &&
                        lse_s[c] > kHalfNegInf;
        const float p = ok ? expf(st[i][j] * scale + kbias[i] - lse_s[c]) : 0.f;
        ps[kl * kCLd + c] = round_to<Tp>(p);
        dss[kl * kCLd + c] = round_to<Tp>(p * (dpt[i][j] - delta_s[c]) * scale);
      }
    }
    __syncthreads();
    // dV[key] += sum_c P[key][c] dO[c];  dK[key] += sum_c dS[key][c] Q[c]
#pragma unroll 2
    for (int c = 0; c < kChunk; ++c) {
      float pa[RPT], sa[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        pa[i] = ps[(ty + 16 * i) * kCLd + c];
        sa[i] = dss[(ty + 16 * i) * kCLd + c];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float dov = dos[c * LD + tx + 16 * j];
        const float qv = qs[c * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          dv_acc[i][j] = fmaf(pa[i], dov, dv_acc[i][j]);
          dk_acc[i][j] = fmaf(sa[i], qv, dk_acc[i][j]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const long long row = base + static_cast<long long>(k0 + ty + 16 * i) * DH;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dk[row + tx + 16 * j] = from_f32<Tp>(dk_acc[i][j]);
      dv[row + tx + 16 * j] = from_f32<Tp>(dv_acc[i][j]);
    }
  }
}

// delta = rowsum(dO * O) in fp32 over (rows, DH) row-major o and dout
template <typename T, int DH>
__global__ void __launch_bounds__(256)
    sparse_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                           float* __restrict__ delta, long long rows) {
  rowsum_dot<T, DH>(o, dout, delta, rows);
}

// ------------------------------------------------------------------ //
// bf16 sparse_bwd: tensor cores (mma.sync m16n8k16), cp.async, ldmatrix
// ------------------------------------------------------------------ //

constexpr int kTcWarps = 4;               // 16-row tiles of a group
constexpr int kTcThreads = 32 * kTcWarps;
// a group: the tile ids of its warps (h * S / 16 + tile; -1: no tile),
// then the offset and the length of its block list in the CSR ids
constexpr int kGroupInts = kTcWarps + 2;

// Position of row r (of kChunk) of step ci of a walk over a list of
// ``len`` blocks of 2^lb rows whose block ids sit in shared memory; -1
// past the end.
__device__ __forceinline__ int step_pos(const int* ids_s, int len, int lb, int ci, int r) {
  const int t = ci * kChunk + r;
  const int e = t >> lb;
  return e < len ? (ids_s[e] << lb) + (t & ((1 << lb) - 1)) : -1;
}

// rows pos(r), r < kChunk, of a (S, DH) bf16 matrix into a swizzled tile;
// rows at -1 are zero-filled
template <int DH>
__device__ __forceinline__ void gather_async(bf16* dst, const bf16* __restrict__ src,
                                             const int* ids_s, int len, int lb, int ci,
                                             int tid) {
  constexpr int CPR = DH / 8;
#pragma unroll
  for (int it = 0; it < kChunk * CPR / kTcThreads; ++it) {
    const int i = tid + it * kTcThreads;
    const int r = i / CPR;
    const int c = i - r * CPR;
    const int p = step_pos(ids_s, len, lb, ci, r);
    cp_async16(chunk_addr<DH>(dst, r, c),
               src + static_cast<long long>(p < 0 ? 0 : p) * DH + c * 8, p >= 0);
  }
}

// the rows of the group's own tiles (row r: warp r / 16's tile) of a
// (S, DH) bf16 matrix into a swizzled (kChunk, DH) tile; a warp with no
// tile gets zeros
template <int DH>
__device__ __forceinline__ void own_rows_async(bf16* dst, const bf16* __restrict__ src,
                                               const int* grp, int ntiles, int tid) {
  constexpr int CPR = DH / 8;
#pragma unroll
  for (int it = 0; it < kChunk * CPR / kTcThreads; ++it) {
    const int i = tid + it * kTcThreads;
    const int r = i / CPR;
    const int c = i - r * CPR;
    const int tile = grp[r >> 4];
    const int row = tile >= 0 ? (tile % ntiles) * 16 + (r & 15) : 0;
    cp_async16(chunk_addr<DH>(dst, r, c), src + static_cast<long long>(row) * DH + c * 8,
               tile >= 0);
  }
}

template <int DH>
constexpr size_t bwd_mma_smem() {  // own rows of two tensors; two stages of two
  return 6 * kChunk * DH * sizeof(bf16) + 6 * kChunk * sizeof(float);
}

template <int DH>
constexpr size_t fwd_mma_smem() {  // own Q rows; two stages of K and V, positions, biases
  return 5 * kChunk * DH * sizeof(bf16) + 4 * kChunk * sizeof(float);
}

// o and lse for the query tiles of one group (warp w: its tile's 16 rows),
// walking the group's key blocks 64 keys a step: S = Q K^T, scaled, plus
// the key bias; the online softmax in fp32 registers; O += P V with P
// rounded to bf16 and packed from the accumulators. Block x: group x / B
// of batch x % B.
template <int DH>
__global__ void __launch_bounds__(kTcThreads, 2)
    sparse_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const float* __restrict__ mask,
                          const int* __restrict__ groups, const int* __restrict__ ids,
                          bf16* __restrict__ o, float* __restrict__ lse, int B, int H, int S,
                          int lb, float scale, bool causal) {
  constexpr int KS = DH / 16;
  constexpr int ND = DH / 8;
  constexpr int NN = kChunk / 8;
  const float kInf = __int_as_float(0x7f800000);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kChunk][DH], warp w: rows 16w..
  bf16* ks = qs + kChunk * DH;                   // [2][kChunk][DH]
  bf16* vs = ks + 2 * kChunk * DH;               // [2][kChunk][DH]
  int* kpos_s = reinterpret_cast<int*>(vs + 2 * kChunk * DH);   // [2][kChunk]
  float* kb_s = reinterpret_cast<float*>(kpos_s + 2 * kChunk);  // [2][kChunk]
  int* ids_s = reinterpret_cast<int*>(kb_s + 2 * kChunk);       // [len <= S / block]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int* grp = groups + static_cast<long long>(blockIdx.x / B) * kGroupInts;
  const long long b = blockIdx.x % B;
  const int ntiles = S >> 4;
  const int tile = grp[warp];
  const int off = grp[kTcWarps];
  const int len = grp[kTcWarps + 1];
  const long long bh = b * H + grp[0] / ntiles;
  const long long base = bh * S * DH;
  const float* mrow = mask ? mask + b * S : nullptr;
  const int n_keys = len << lb;
  const int n_steps = (n_keys + kChunk - 1) / kChunk;

  for (int i = tid; i < len; i += kTcThreads) ids_s[i] = ids[off + i];
  own_rows_async<DH>(qs, q + base, grp, ntiles, tid);
  __syncthreads();  // ids_s

  // Thread tid < kChunk owns key tid of a step: its position (-1 past the
  // list) and its bias, the key mask's value, or -inf where the key is not
  // visible (past the list, or hidden by the mask), so that its p is 0.
  // The mask is read into a register when the step's gathers are issued
  // and published to shared memory once the step before it is done.
  int pos_n = -1;
  float bias_n = 0.f;
  auto issue = [&](int ci, int st) {
    gather_async<DH>(ks + st * kChunk * DH, k + base, ids_s, len, lb, ci, tid);
    gather_async<DH>(vs + st * kChunk * DH, v + base, ids_s, len, lb, ci, tid);
    if (tid < kChunk) {
      pos_n = step_pos(ids_s, len, lb, ci, tid);
      bias_n = mrow && pos_n >= 0 ? __ldg(mrow + pos_n) : 0.f;
    }
  };
  auto publish = [&](int st) {
    if (tid < kChunk) {
      kpos_s[st * kChunk + tid] = pos_n;
      kb_s[st * kChunk + tid] = pos_n >= 0 && bias_n > kHalfNegInf ? bias_n : -kInf;
    }
  };
  if (n_steps > 0) {
    issue(0, 0);
    publish(0);
  }
  cp_async_commit();

  // the thread's rows g and g + 8: running max (finite NEG_INF until a key
  // is visible) and the thread's part of the row sum of the unrounded p
  const int q0 = tile >= 0 ? (tile % ntiles) * 16 : 0;
  int row_r[2];
  float m[2], l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row_r[i] = q0 + g + 8 * i;
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  uint32_t qf[KS][4];
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int ci = 0; ci < n_steps; ++ci) {
    const int st = ci & 1;
    if (ci + 1 < n_steps) {
      issue(ci + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // stage st's tiles, positions and biases
    if (tile >= 0) {
      if (ci == 0) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) ldsm_x4(a_addr<DH>(qs, 16 * warp, kk, lane), qf[kk]);
      }
      const bf16* kst = ks + st * kChunk * DH;
      const bf16* vst = vs + st * kChunk * DH;
      const int* kp_s = kpos_s + st * kChunk;
      const float* kbias_s = kb_s + st * kChunk;
      // positions ascend along a list, so the step's last key is its
      // latest: only a step that reaches past the warp's first row holds
      // keys a causal row may not see (those of a diagonal block)
      const int last = min(kChunk, n_keys - ci * kChunk) - 1;
      const bool diag = causal && step_pos(ids_s, len, lb, ci, last) > q0;
      float s[NN][4];
#pragma unroll
      for (int j = 0; j < NN; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int np = 0; np < NN / 2; ++np) {
          uint32_t bk[4];
          ldsm_x4(b_addr<DH>(kst, 16 * np, kk, lane), bk);
          mma_bf16(s[2 * np], qf[kk], bk[0], bk[1]);
          mma_bf16(s[2 * np + 1], qf[kk], bk[2], bk[3]);
        }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < NN; ++j) {
        const int c = 8 * j + 2 * t;
        const float2 kb = *reinterpret_cast<const float2*>(kbias_s + c);
        int2 kp = make_int2(0, 0);
        if (diag) kp = *reinterpret_cast<const int2*>(kp_s + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float val = s[j][e] * scale + ((e & 1) ? kb.y : kb.x);
          if (diag && ((e & 1) ? kp.y : kp.x) > row_r[e >> 1]) val = -kInf;
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
          const float p = fast_exp2((s[j][e] - m[e >> 1]) * kLog2e);  // 0 at -inf
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
      // O += P V, P's bf16 A operand straight from the score accumulators,
      // V read across its rows (.trans)
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk) {
        uint32_t pa[4];
        a_from_acc(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int d2 = 0; d2 < DH / 16; ++d2) {
          uint32_t bv[4];
          ldsm_x4_trans(a_addr<DH>(vst, 16 * kk, d2, lane), bv);
          mma_bf16(acc[2 * d2], pa, bv[0], bv[1]);
          mma_bf16(acc[2 * d2 + 1], pa, bv[2], bv[3]);
        }
      }
    }
    if (ci + 1 < n_steps) publish(st ^ 1);
    __syncthreads();  // every warp is done with stage st before it refills
  }
  cp_async_wait<0>();
  __syncthreads();  // every copy has landed (with no step, the own rows)
  if (tile >= 0) {
    // o = acc / l, and o = 0 with lse = NEG_INF for a row that saw no key;
    // the warp's own rows of the Q tile (read only by this warp, and only
    // into qf) stage o
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
#pragma unroll
    for (int j = 0; j < ND; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float li = l[e >> 1];
        acc[j][e] = li > 0.f ? acc[j][e] / li : 0.f;
      }
    }
    store_rows<DH>(qs, 16 * warp, acc, o + base, q0, S, DH, DH / 8, lane);
    if (t == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        lse[bh * S + row_r[i]] = l[i] > 0.f ? m[i] + logf(l[i]) : kNegInf;
      }
    }
  }
}

// dQ for the query tiles of one group (warp w: its tile's 16 rows), walking
// the group's key blocks 64 keys a step: S = Q K^T, dP = dO V^T, then
// dQ += dS K. Block x: group x / B of batch x % B.
template <int DH>
__global__ void __launch_bounds__(kTcThreads, 2)
    sparse_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const bf16* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             const float* __restrict__ mask, const int* __restrict__ groups,
                             const int* __restrict__ ids, bf16* __restrict__ dq, int B, int H,
                             int S, int lb, float scale, bool causal) {
  constexpr int KS = DH / 16;
  constexpr int ND = DH / 8;
  constexpr int KSUB = DH == 128 ? 32 : 64;  // keys a sub-step (registers at Dh 128)
  constexpr int NN = KSUB / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kChunk][DH], warp w: rows 16w..
  bf16* dos = qs + kChunk * DH;                  // [kChunk][DH]
  bf16* ks = dos + kChunk * DH;                  // [2][kChunk][DH]
  bf16* vs = ks + 2 * kChunk * DH;               // [2][kChunk][DH]
  int* kpos_s = reinterpret_cast<int*>(vs + 2 * kChunk * DH);  // [2][kChunk]
  float* kb_s = reinterpret_cast<float*>(kpos_s + 2 * kChunk);  // [2][kChunk]
  int* ids_s = reinterpret_cast<int*>(kb_s + 2 * kChunk);       // [len <= S / block]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int* grp = groups + static_cast<long long>(blockIdx.x / B) * kGroupInts;
  const long long b = blockIdx.x % B;
  const int ntiles = S >> 4;
  const int tile = grp[warp];
  const int off = grp[kTcWarps];
  const int len = grp[kTcWarps + 1];
  const long long bh = b * H + grp[0] / ntiles;
  const long long base = bh * S * DH;
  const float* mrow = mask ? mask + b * S : nullptr;
  const int n_steps = ((len << lb) + kChunk - 1) / kChunk;

  for (int i = tid; i < len; i += kTcThreads) ids_s[i] = ids[off + i];
  own_rows_async<DH>(qs, q + base, grp, ntiles, tid);
  own_rows_async<DH>(dos, dout + base, grp, ntiles, tid);
  __syncthreads();  // ids_s

  auto issue = [&](int ci, int st) {
    gather_async<DH>(ks + st * kChunk * DH, k + base, ids_s, len, lb, ci, tid);
    gather_async<DH>(vs + st * kChunk * DH, v + base, ids_s, len, lb, ci, tid);
    if (tid < kChunk) {
      const int p = step_pos(ids_s, len, lb, ci, tid);
      kpos_s[st * kChunk + tid] = p;
      if (mrow) cp_async4(smem_u32(kb_s + st * kChunk + tid), mrow + (p < 0 ? 0 : p), p >= 0);
    }
  };
  if (n_steps > 0) issue(0, 0);
  cp_async_commit();

  // the thread's rows g and g + 8; a row with no visible key (lse NEG_INF)
  // takes lse = +inf, so that every p of it is 0
  const int q0 = tile >= 0 ? (tile % ntiles) * 16 : 0;
  float lse_r[2], dl_r[2];
  int row_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row_r[i] = q0 + g + 8 * i;
    const float l = tile >= 0 ? lse[bh * S + row_r[i]] : 0.f;
    lse_r[i] = l > kHalfNegInf ? l : __int_as_float(0x7f800000);  // +inf
    dl_r[i] = tile >= 0 ? delta[bh * S + row_r[i]] : 0.f;
  }
  float dqa[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) dqa[j][0] = dqa[j][1] = dqa[j][2] = dqa[j][3] = 0.f;

  for (int ci = 0; ci < n_steps; ++ci) {
    const int st = ci & 1;
    if (ci + 1 < n_steps) {
      issue(ci + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (tile >= 0) {
      const bf16* kst = ks + st * kChunk * DH;
      const bf16* vst = vs + st * kChunk * DH;
      const int* kp_s = kpos_s + st * kChunk;
      const float* kbias_s = kb_s + st * kChunk;
#pragma unroll 1
      for (int sub = 0; sub < kChunk / KSUB; ++sub) {
        const int c0 = sub * KSUB;
        float s[NN][4], dp[NN][4];
#pragma unroll
        for (int j = 0; j < NN; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
        }
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t qa[4], da[4];
          ldsm_x4(a_addr<DH>(qs, 16 * warp, kk, lane), qa);
          ldsm_x4(a_addr<DH>(dos, 16 * warp, kk, lane), da);
#pragma unroll
          for (int np = 0; np < NN / 2; ++np) {
            uint32_t bk[4];
            ldsm_x4(b_addr<DH>(kst, c0 + 16 * np, kk, lane), bk);
            mma_bf16(s[2 * np], qa, bk[0], bk[1]);
            mma_bf16(s[2 * np + 1], qa, bk[2], bk[3]);
            ldsm_x4(b_addr<DH>(vst, c0 + 16 * np, kk, lane), bk);
            mma_bf16(dp[2 * np], da, bk[0], bk[1]);
            mma_bf16(dp[2 * np + 1], da, bk[2], bk[3]);
          }
        }
#pragma unroll
        for (int j = 0; j < NN; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            const int c = c0 + 8 * j + 2 * t + (e & 1);
            const int kp = kp_s[c];
            const float kb = mrow ? kbias_s[c] : 0.f;
            const bool vis = kp >= 0 && kb > kHalfNegInf && !(causal && kp > row_r[i]);
            const float p = vis ? exp2f((s[j][e] * scale + kb - lse_r[i]) * kLog2e) : 0.f;
            dp[j][e] = p * (dp[j][e] - dl_r[i]) * scale;
          }
        }
        // dQ += dS K, K read across its rows (.trans)
#pragma unroll
        for (int kk = 0; kk < KSUB / 16; ++kk) {
          uint32_t sa[4];
          a_from_acc(sa, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
          for (int d2 = 0; d2 < DH / 16; ++d2) {
            uint32_t bk[4];
            ldsm_x4_trans(a_addr<DH>(kst, c0 + 16 * kk, d2, lane), bk);
            mma_bf16(dqa[2 * d2], sa, bk[0], bk[1]);
            mma_bf16(dqa[2 * d2 + 1], sa, bk[2], bk[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with stage st before it refills
  }
  cp_async_wait<0>();
  __syncthreads();  // every copy has landed (with no step, the own rows)
  // the warp's own rows of the Q tile (read only by this warp) stage dQ
  if (tile >= 0) store_rows<DH>(qs, 16 * warp, dqa, dq + base, q0, S, DH, DH / 8, lane);
}

// dK and dV for the key tiles of one group (warp w: its tile's 16 keys),
// walking the group's query blocks 64 queries a step. S^T = K Q^T and
// dP^T = V dO^T come out with keys as rows, so P^T and dS^T are the A
// operands of dV += P^T dO and dK += dS^T Q.
template <int DH>
__global__ void __launch_bounds__(kTcThreads, 2)
    sparse_bwd_dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                               const bf16* __restrict__ v, const bf16* __restrict__ dout,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               const float* __restrict__ mask, const int* __restrict__ groups,
                               const int* __restrict__ ids, bf16* __restrict__ dk,
                               bf16* __restrict__ dv, int B, int H, int S, int lb, float scale,
                               bool causal) {
  constexpr int KS = DH / 16;
  constexpr int ND = DH / 8;
  constexpr int QSUB = DH == 128 ? 16 : 32;  // queries a sub-step (registers at Dh 128)
  constexpr int NQ = QSUB / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [kChunk][DH], warp w: keys 16w..
  bf16* vs = ks + kChunk * DH;                   // [kChunk][DH]
  bf16* qs = vs + kChunk * DH;                   // [2][kChunk][DH]
  bf16* dos = qs + 2 * kChunk * DH;              // [2][kChunk][DH]
  int* qpos_s = reinterpret_cast<int*>(dos + 2 * kChunk * DH);  // [2][kChunk]
  float* lse_s = reinterpret_cast<float*>(qpos_s + 2 * kChunk);  // [2][kChunk]
  float* dl_s = lse_s + 2 * kChunk;                               // [2][kChunk]
  int* ids_s = reinterpret_cast<int*>(dl_s + 2 * kChunk);        // [len <= S / block]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int* grp = groups + static_cast<long long>(blockIdx.x / B) * kGroupInts;
  const long long b = blockIdx.x % B;
  const int ntiles = S >> 4;
  const int tile = grp[warp];
  const int off = grp[kTcWarps];
  const int len = grp[kTcWarps + 1];
  const long long bh = b * H + grp[0] / ntiles;
  const long long base = bh * S * DH;
  const float* lse_bh = lse + bh * S;
  const float* dl_bh = delta + bh * S;
  const float* mrow = mask ? mask + b * S : nullptr;
  const int n_steps = ((len << lb) + kChunk - 1) / kChunk;

  for (int i = tid; i < len; i += kTcThreads) ids_s[i] = ids[off + i];
  own_rows_async<DH>(ks, k + base, grp, ntiles, tid);
  own_rows_async<DH>(vs, v + base, grp, ntiles, tid);
  __syncthreads();  // ids_s

  auto issue = [&](int ci, int st) {
    gather_async<DH>(qs + st * kChunk * DH, q + base, ids_s, len, lb, ci, tid);
    gather_async<DH>(dos + st * kChunk * DH, dout + base, ids_s, len, lb, ci, tid);
    if (tid < kChunk) {
      const int p = step_pos(ids_s, len, lb, ci, tid);
      const int pc = p < 0 ? 0 : p;
      qpos_s[st * kChunk + tid] = p;
      cp_async4(smem_u32(lse_s + st * kChunk + tid), lse_bh + pc, p >= 0);
      cp_async4(smem_u32(dl_s + st * kChunk + tid), dl_bh + pc, p >= 0);
    }
  };
  if (n_steps > 0) issue(0, 0);
  cp_async_commit();

  // the thread's keys g and g + 8: position and added bias (-inf for a key
  // the mask hides, so that every p of it is 0)
  const int k0 = tile >= 0 ? (tile % ntiles) * 16 : 0;
  int key_r[2];
  float kb_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    key_r[i] = k0 + g + 8 * i;
    const float bias = mrow ? mrow[key_r[i]] : 0.f;
    kb_r[i] = bias > kHalfNegInf ? bias : -__int_as_float(0x7f800000);  // -inf
  }
  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;
  }

  for (int ci = 0; ci < n_steps; ++ci) {
    const int st = ci & 1;
    if (ci + 1 < n_steps) {
      issue(ci + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (tile >= 0) {
      const bf16* qst = qs + st * kChunk * DH;
      const bf16* dost = dos + st * kChunk * DH;
      const int* qp_s = qpos_s + st * kChunk;
      const float* ls = lse_s + st * kChunk;
      const float* dls = dl_s + st * kChunk;
#pragma unroll 1
      for (int sub = 0; sub < kChunk / QSUB; ++sub) {
        const int c0 = sub * QSUB;
        float sT[NQ][4], dpT[NQ][4];
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) sT[j][e] = dpT[j][e] = 0.f;
        }
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t ka[4], va[4];
          ldsm_x4(a_addr<DH>(ks, 16 * warp, kk, lane), ka);
          ldsm_x4(a_addr<DH>(vs, 16 * warp, kk, lane), va);
#pragma unroll
          for (int np = 0; np < NQ / 2; ++np) {
            uint32_t bq[4];
            ldsm_x4(b_addr<DH>(qst, c0 + 16 * np, kk, lane), bq);
            mma_bf16(sT[2 * np], ka, bq[0], bq[1]);
            mma_bf16(sT[2 * np + 1], ka, bq[2], bq[3]);
            ldsm_x4(b_addr<DH>(dost, c0 + 16 * np, kk, lane), bq);
            mma_bf16(dpT[2 * np], va, bq[0], bq[1]);
            mma_bf16(dpT[2 * np + 1], va, bq[2], bq[3]);
          }
        }
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            const int c = c0 + 8 * j + 2 * t + (e & 1);  // query of the step
            const int qp = qp_s[c];
            const float lr = ls[c];
            const bool vis = qp >= 0 && lr > kHalfNegInf && !(causal && key_r[i] > qp);
            const float p = vis ? exp2f((sT[j][e] * scale + kb_r[i] - lr) * kLog2e) : 0.f;
            sT[j][e] = p;
            dpT[j][e] = p * (dpT[j][e] - dls[c]) * scale;
          }
        }
#pragma unroll
        for (int kk = 0; kk < QSUB / 16; ++kk) {
          uint32_t pa[4], da[4];
          a_from_acc(pa, sT[2 * kk], sT[2 * kk + 1]);
          a_from_acc(da, dpT[2 * kk], dpT[2 * kk + 1]);
#pragma unroll
          for (int d2 = 0; d2 < DH / 16; ++d2) {
            uint32_t bq[4];
            ldsm_x4_trans(a_addr<DH>(dost, c0 + 16 * kk, d2, lane), bq);
            mma_bf16(dva[2 * d2], pa, bq[0], bq[1]);
            mma_bf16(dva[2 * d2 + 1], pa, bq[2], bq[3]);
            ldsm_x4_trans(a_addr<DH>(qst, c0 + 16 * kk, d2, lane), bq);
            mma_bf16(dka[2 * d2], da, bq[0], bq[1]);
            mma_bf16(dka[2 * d2 + 1], da, bq[2], bq[3]);
          }
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();  // every copy has landed (with no step, the own rows)
  // the warp's own rows of the K and V tiles (read only by this warp) stage
  // dK and dV
  if (tile >= 0) {
    store_rows<DH>(ks, 16 * warp, dka, dk + base, k0, S, DH, DH / 8, lane);
    store_rows<DH>(vs, 16 * warp, dva, dv + base, k0, S, DH, DH / 8, lane);
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const void* lse_in;
  void* delta;
  const float* mask;
  const int* offsets;
  const int* ids;
  const int* t_offsets;
  const int* t_ids;
  const int* q_groups;   // bf16 backward: the dQ groups (kGroupInts each)
  const int* kv_groups;  // and the dK/dV groups
  void* o;
  void* lse;
  void* dq;
  void* dk;
  void* dv;
  int BH, H, S, block;
  int n_q_groups, n_kv_groups;
  float scale;
  bool causal;
  cudaStream_t stream;
};

template <typename Tp, int DH, int T>
int launch_fwd(const Args& a) {
  constexpr size_t smem = fwd_smem<DH, T>();
  cudaError_t err = allow_smem(sparse_fwd_kernel<Tp, DH, T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.S / T, a.BH);
  sparse_fwd_kernel<Tp, DH, T><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const Tp*>(a.q), static_cast<const Tp*>(a.k), static_cast<const Tp*>(a.v),
      a.mask, a.offsets, a.ids, static_cast<Tp*>(a.o), static_cast<float*>(a.lse), a.H, a.S,
      a.block, a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tp, int DH, int T>
int launch_bwd(const Args& a) {
  const dim3 grid(a.S / T, a.BH);
  constexpr size_t smem_q = dq_smem<DH, T>();
  cudaError_t err = allow_smem(sparse_bwd_dq_kernel<Tp, DH, T>, smem_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  sparse_bwd_dq_kernel<Tp, DH, T><<<grid, kThreads, smem_q, a.stream>>>(
      static_cast<const Tp*>(a.q), static_cast<const Tp*>(a.k), static_cast<const Tp*>(a.v),
      static_cast<const Tp*>(a.dout), static_cast<const float*>(a.lse_in),
      static_cast<const float*>(a.delta), a.mask, a.offsets, a.ids, static_cast<Tp*>(a.dq),
      a.H, a.S, a.block, a.scale, a.causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr size_t smem_kv = dkdv_smem<DH, T>();
  err = allow_smem(sparse_bwd_dkdv_kernel<Tp, DH, T>, smem_kv);
  if (err != cudaSuccess) return static_cast<int>(err);
  sparse_bwd_dkdv_kernel<Tp, DH, T><<<grid, kThreads, smem_kv, a.stream>>>(
      static_cast<const Tp*>(a.q), static_cast<const Tp*>(a.k), static_cast<const Tp*>(a.v),
      static_cast<const Tp*>(a.dout), static_cast<const float*>(a.lse_in),
      static_cast<const float*>(a.delta), a.mask, a.t_offsets, a.t_ids,
      static_cast<Tp*>(a.dk), static_cast<Tp*>(a.dv), a.H, a.S, a.block, a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

int log2_block(int block) { return block == 16 ? 4 : block == 32 ? 5 : block == 64 ? 6 : 7; }

// bf16 forward: o and lse over the query groups
template <int DH>
int launch_fwd_mma(const Args& a) {
  const int B = a.BH / a.H;
  const int lb = log2_block(a.block);
  // a group's list in shared memory: at most S / block ids
  const size_t smem = fwd_mma_smem<DH>() + (a.S >> lb) * sizeof(int);
  cudaError_t err = allow_smem(sparse_fwd_mma_kernel<DH>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.n_q_groups > 0) {
    sparse_fwd_mma_kernel<DH>
        <<<static_cast<unsigned>(a.n_q_groups) * B, kTcThreads, smem, a.stream>>>(
            static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
            static_cast<const bf16*>(a.v), a.mask, a.q_groups, a.ids,
            static_cast<bf16*>(a.o), static_cast<float*>(a.lse), B, a.H, a.S, lb, a.scale,
            a.causal);
  }
  return static_cast<int>(cudaGetLastError());
}

// bf16 backward: dQ over the query groups, then dK/dV over the key groups
template <int DH>
int launch_bwd_mma(const Args& a) {
  const int B = a.BH / a.H;
  const int lb = log2_block(a.block);
  // a group's list in shared memory: at most S / block ids
  const size_t smem = bwd_mma_smem<DH>() + (a.S >> lb) * sizeof(int);
  cudaError_t err = allow_smem(sparse_bwd_dq_mma_kernel<DH>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.n_q_groups > 0) {
    sparse_bwd_dq_mma_kernel<DH>
        <<<static_cast<unsigned>(a.n_q_groups) * B, kTcThreads, smem, a.stream>>>(
            static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
            static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
            static_cast<const float*>(a.lse_in), static_cast<const float*>(a.delta), a.mask,
            a.q_groups, a.ids, static_cast<bf16*>(a.dq), B, a.H, a.S, lb, a.scale, a.causal);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = allow_smem(sparse_bwd_dkdv_mma_kernel<DH>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.n_kv_groups > 0) {
    sparse_bwd_dkdv_mma_kernel<DH>
        <<<static_cast<unsigned>(a.n_kv_groups) * B, kTcThreads, smem, a.stream>>>(
            static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
            static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
            static_cast<const float*>(a.lse_in), static_cast<const float*>(a.delta), a.mask,
            a.kv_groups, a.t_ids, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), B, a.H,
            a.S, lb, a.scale, a.causal);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename Tp, int DH>
int launch_delta(const Args& a) {
  const long long rows = static_cast<long long>(a.BH) * a.S;
  sparse_bwd_delta_kernel<Tp, DH><<<static_cast<unsigned>((rows + 63) / 64), 256, 0, a.stream>>>(
      static_cast<const Tp*>(a.o), static_cast<const Tp*>(a.dout),
      static_cast<float*>(a.delta), rows);
  return static_cast<int>(cudaGetLastError());
}

// the CUDA-core kernels; the tile height T = min(block, 64)
template <typename Tp, int DH, bool BWD, int T>
int launch_cuda_core(const Args& a) {
  if constexpr (BWD) {
    return launch_bwd<Tp, DH, T>(a);
  } else {
    return launch_fwd<Tp, DH, T>(a);
  }
}

template <typename Tp, int DH, bool BWD>
int by_block(const Args& a) {
  switch (a.block) {
    case 16: return launch_cuda_core<Tp, DH, BWD, 16>(a);
    case 32: return launch_cuda_core<Tp, DH, BWD, 32>(a);
    case 64:
    case 128: return launch_cuda_core<Tp, DH, BWD, 64>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the forward: the tensor-core kernel (bf16) or the CUDA-core one (fp32)
template <typename Tp, int DH>
int launch_forward(const Args& a) {
  if constexpr (sizeof(Tp) == 2) {
    return launch_fwd_mma<DH>(a);
  } else {
    return by_block<Tp, DH, false>(a);
  }
}

// the backward: delta, then the tensor-core kernels (bf16) or the
// CUDA-core ones (fp32)
template <typename Tp, int DH>
int launch_backward(const Args& a) {
  const int err = launch_delta<Tp, DH>(a);
  if (err != 0) return err;
  if constexpr (sizeof(Tp) == 2) {
    return launch_bwd_mma<DH>(a);
  } else {
    return by_block<Tp, DH, true>(a);
  }
}

template <typename Tp, bool BWD>
int by_head_dim(int dh, const Args& a) {
  if constexpr (BWD) {
    switch (dh) {
      case 64: return launch_backward<Tp, 64>(a);
      case 96: return launch_backward<Tp, 96>(a);
      case 128: return launch_backward<Tp, 128>(a);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    switch (dh) {
      case 64: return launch_forward<Tp, 64>(a);
      case 96: return launch_forward<Tp, 96>(a);
      case 128: return launch_forward<Tp, 128>(a);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
}

template <bool BWD>
int dispatch(int dtype, int dh, const Args& a) {
  if (a.BH <= 0 || a.BH > 65535 || a.H <= 0 || a.BH % a.H != 0 ||
      (a.block != 16 && a.block != 32 && a.block != 64 && a.block != 128) || a.S <= 0 ||
      a.S % a.block != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == kDtypeBF16 &&
      (a.n_q_groups < 0 || a.n_kv_groups < 0 ||
       static_cast<long long>(a.n_q_groups) * (a.BH / a.H) > 0x7fffffffLL ||
       static_cast<long long>(a.n_kv_groups) * (a.BH / a.H) > 0x7fffffffLL)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == kDtypeF32) return by_head_dim<float, BWD>(dh, a);
  if (dtype == kDtypeBF16) return by_head_dim<__nv_bfloat16, BWD>(dh, a);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int DH>
int info_dh(int which, int list_len, int* out) {
  const size_t list = static_cast<size_t>(list_len) * sizeof(int);
  switch (which) {
    case 0:
      return kernel_info(sparse_bwd_dq_mma_kernel<DH>, bwd_mma_smem<DH>() + list, kTcThreads,
                         out);
    case 1:
      return kernel_info(sparse_bwd_dkdv_mma_kernel<DH>, bwd_mma_smem<DH>() + list,
                         kTcThreads, out);
    case 2: return kernel_info(sparse_bwd_delta_kernel<bf16, DH>, 0, 256, out);
    case 3:
      return kernel_info(sparse_fwd_mma_kernel<DH>, fwd_mma_smem<DH>() + list, kTcThreads, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

const char* ds_sparse_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, k, v, o: (BH, S, Dh) of dtype, contiguous; lse: (BH, S) fp32; mask:
// (BH / H, S) fp32 or null; row_offsets (H * S / block + 1,) and row_cols
// int32, the CSR table of the causally filtered layout (fp32 walks it);
// for bf16 the query group table (n_q_groups rows of 6 int32: four tile
// ids, the offset and the length of the group's list in row_cols,
// heaviest first).
int ds_sparse_fwd(const void* q, const void* k, const void* v, const void* mask,
                  const void* row_offsets, const void* row_cols, const void* q_groups, void* o,
                  void* lse, int BH, int H, int S, int block, int Dh, int n_q_groups,
                  float scale, int causal, int dtype, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.mask = static_cast<const float*>(mask);
  a.offsets = static_cast<const int*>(row_offsets);
  a.ids = static_cast<const int*>(row_cols);
  a.q_groups = static_cast<const int*>(q_groups);
  a.n_q_groups = n_q_groups;
  a.o = o;
  a.lse = lse;
  a.BH = BH;
  a.H = H;
  a.S = S;
  a.block = block;
  a.scale = scale;
  a.causal = causal != 0;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch<false>(dtype, Dh, a);
}

// as ds_sparse_fwd, with o and dout (BH, S, Dh) and lse (BH, S) fp32 in;
// delta (BH, S) fp32 out (rowsum(dout * o), written first); the
// transposed table (col_offsets, col_rows) for dK/dV; for bf16 the dQ and
// dK/dV group tables (n_*_groups rows of 6 int32: four tile ids, the offset
// and the length of the group's list in row_cols / col_rows, heaviest
// first); dq, dk, dv (BH, S, Dh) out.
int ds_sparse_bwd(const void* q, const void* k, const void* v, const void* o,
                  const void* dout, const void* lse, void* delta, const void* mask,
                  const void* row_offsets, const void* row_cols, const void* col_offsets,
                  const void* col_rows, const void* q_groups, const void* kv_groups, void* dq,
                  void* dk, void* dv, int BH, int H, int S, int block, int Dh, int n_q_groups,
                  int n_kv_groups, float scale, int causal, int dtype, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = const_cast<void*>(o);
  a.dout = dout;
  a.lse_in = lse;
  a.delta = delta;
  a.mask = static_cast<const float*>(mask);
  a.offsets = static_cast<const int*>(row_offsets);
  a.ids = static_cast<const int*>(row_cols);
  a.t_offsets = static_cast<const int*>(col_offsets);
  a.t_ids = static_cast<const int*>(col_rows);
  a.q_groups = static_cast<const int*>(q_groups);
  a.kv_groups = static_cast<const int*>(kv_groups);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.BH = BH;
  a.H = H;
  a.S = S;
  a.block = block;
  a.n_q_groups = n_q_groups;
  a.n_kv_groups = n_kv_groups;
  a.scale = scale;
  a.causal = causal != 0;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch<true>(dtype, Dh, a);
}

// which: 0 the bf16 dQ kernel, 1 the bf16 dK/dV kernel, 2 delta (bf16), 3
// the bf16 forward, at head dim Dh and their launch configuration with a
// block list of list_len ids (S / block) in shared memory. out: 6 ints
// (registers, static smem, dynamic smem, local bytes a thread, threads,
// blocks an SM).
int ds_sparse_kernel_info(int which, int Dh, int list_len, int* out) {
  if (list_len < 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (Dh) {
    case 64: return info_dh<64>(which, list_len, out);
    case 96: return info_dh<96>(which, list_len, out);
    case 128: return info_dh<128>(which, list_len, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
