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
// ~34 MB, above the H100's ~295 FLOP/byte ridge, so operations bound it.
// This first version is the simple, right one: CUDA-core fp32 FMAs over
// shared-memory tiles, not the tensor cores (wgmma with TMA-fed tile rings
// is later work), so it runs far above its bf16 tensor-core bound. The
// design:
//  * one 256-thread block per (batch*head, T-row tile of a q-block row),
//    T = min(block, 64): a 128 block is two 64-row tiles. The block walks
//    its row's active k-blocks in steps of 64 keys, gathered through the
//    CSR table (four 16-key blocks, two 32-key blocks, or one 64-key half
//    of a larger block per step), with the online-softmax state (m, l) and
//    the accumulators in registers, fp32. Nothing of size S x S reaches
//    device memory, and the work scales with the active blocks.
//  * the dK/dV kernel is the mirror image: one block per T-key tile,
//    walking the q-blocks that see it through the transposed table, 64
//    queries a step.
//  * causal: the host drops the blocks above the diagonal before it
//    builds both tables; inside the diagonal blocks the kernels mask
//    element by element.
//  * the optional key mask (B, S) fp32 is an added bias on the scores; a
//    key whose mask is <= NEG_INF / 2 counts as not visible. A row with no
//    visible key writes o = 0 and lse = NEG_INF (-1e30, finite, as in the
//    reference), and its backward gives zero gradients, not NaN.
//  * rounding follows the reference: P is cast to the input dtype before
//    P V (kernels.py:243-246) and dS before its two products; sums of P and
//    all accumulators stay fp32.
//  * the backward is two launches (dQ per query tile over the row table,
//    dK/dV per key tile over the transposed table), so no block writes
//    another block's output and no atomics are needed: a run repeats bit
//    for bit. delta = rowsum(dO * O) comes in from the caller.
// What this first design loses: a block-16 layout gives each thread block
// only 16 query rows against 64-key steps, so each step's loads of K and V
// (64 x Dh each) feed few FMAs; rows of one layout differ in length
// (BigBird's global rows have 64 active blocks, its window rows 3-5) and
// nothing balances them across SMs; tiles are fp32 in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;
constexpr int kChunk = 64;           // keys (queries in dK/dV) a step gathers
constexpr int kThreads = 256;        // a 16 x 16 grid of threads
constexpr int kCLd = kChunk + 1;     // row stride of the (T, 64) P / dS tiles
constexpr float kNegInf = -1e30f;    // the reference's NEG_INF
constexpr float kHalfNegInf = -5e29f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

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
  const void* delta;
  const float* mask;
  const int* offsets;
  const int* ids;
  const int* t_offsets;
  const int* t_ids;
  void* o;
  void* lse;
  void* dq;
  void* dk;
  void* dv;
  int BH, H, S, block;
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

// the tile height T = min(block, 64)
template <typename Tp, int DH, bool BWD>
int by_block(const Args& a) {
  switch (a.block) {
    case 16: return BWD ? launch_bwd<Tp, DH, 16>(a) : launch_fwd<Tp, DH, 16>(a);
    case 32: return BWD ? launch_bwd<Tp, DH, 32>(a) : launch_fwd<Tp, DH, 32>(a);
    case 64:
    case 128: return BWD ? launch_bwd<Tp, DH, 64>(a) : launch_fwd<Tp, DH, 64>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename Tp, bool BWD>
int by_head_dim(int dh, const Args& a) {
  switch (dh) {
    case 64: return by_block<Tp, 64, BWD>(a);
    case 96: return by_block<Tp, 96, BWD>(a);
    case 128: return by_block<Tp, 128, BWD>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool BWD>
int dispatch(int dtype, int dh, const Args& a) {
  if (a.BH <= 0 || a.BH > 65535 || a.H <= 0 || a.BH % a.H != 0 || a.block <= 0 ||
      a.S <= 0 || a.S % a.block != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == kDtypeF32) return by_head_dim<float, BWD>(dh, a);
  if (dtype == kDtypeBF16) return by_head_dim<__nv_bfloat16, BWD>(dh, a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

const char* ds_sparse_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, k, v, o: (BH, S, Dh) of dtype, contiguous; lse: (BH, S) fp32; mask:
// (BH / H, S) fp32 or null; row_offsets (H * S / block + 1,) and row_cols
// int32, the CSR table of the causally filtered layout.
int ds_sparse_fwd(const void* q, const void* k, const void* v, const void* mask,
                  const void* row_offsets, const void* row_cols, void* o, void* lse, int BH,
                  int H, int S, int block, int Dh, float scale, int causal, int dtype,
                  void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.mask = static_cast<const float*>(mask);
  a.offsets = static_cast<const int*>(row_offsets);
  a.ids = static_cast<const int*>(row_cols);
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

// as ds_sparse_fwd, with dout (BH, S, Dh), lse and delta (BH, S) fp32 in,
// the transposed table (col_offsets, col_rows) for dK/dV, and dq, dk, dv
// (BH, S, Dh) out.
int ds_sparse_bwd(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* delta, const void* mask,
                  const void* row_offsets, const void* row_cols, const void* col_offsets,
                  const void* col_rows, void* dq, void* dk, void* dv, int BH, int H, int S,
                  int block, int Dh, float scale, int causal, int dtype, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse_in = lse;
  a.delta = delta;
  a.mask = static_cast<const float*>(mask);
  a.offsets = static_cast<const int*>(row_offsets);
  a.ids = static_cast<const int*>(row_cols);
  a.t_offsets = static_cast<const int*>(col_offsets);
  a.t_ids = static_cast<const int*>(col_rows);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.BH = BH;
  a.H = H;
  a.S = S;
  a.block = block;
  a.scale = scale;
  a.causal = causal != 0;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch<true>(dtype, Dh, a);
}

}  // extern "C"
