// Short-sequence ("super-tile") attention, forward and backward, for Hopper
// (sm_90a). Built by ops/op_builder.py with nvcc into a shared library that
// ops/flash_static.py loads with ctypes; every entry point has a plain C
// interface, launches on the stream it is given, allocates nothing and
// returns cudaGetLastError() so the wrapper can raise on a refused launch.
//
// supertile_fwd replaces the Pallas kernel _st_fwd_kernel
// (deeperspeed_tpu/ops/pallas/flash_static.py, launched by _st_fwd) and
// supertile_bwd replaces _st_bwd_kernel (launched by _st_vjp_bwd). They
// compute causal or full softmax(Q K^T * scale) V for sequences shorter than
// 256, with the fp32 logsumexp saved for the backward, on (B*H, S, Dh)
// tensors with 8 <= S < 256, S % 8 == 0, Dh % 8 == 0 and Dh <= 128.
//
// The TPU kernel packs G ~ 512/S whole sequences into one 512-row tile with a
// block-diagonal mask, so that its 128x128 matrix unit has work; that wastes
// (G-1)/G of the score tile, and Hopper needs no packing. These kernels
// compute what it computes, not how.
//
// What bounds them: at the BERT-large shape (64, 16, 128, 64) bf16 the
// forward moves ~67 MB (q, k, v in, o out), ~20 us at 3.35 TB/s, and does
// 4.3 GFLOP, ~4.3 us at the bf16 tensor-core rate, so bytes bound it; the
// backward moves 8 tensors of 16.8 MB (q, k, v, o, dO in; dq, dk, dv out),
// ~40 us, and does 10.7 GFLOP, ~11 us on the tensor cores.
//
// supertile_fwd, bf16 (the training path): mma.sync.m16n8k16 bf16 -> fp32,
// one block per sequence, so Q, K and V are read from device memory once:
//  * 16-byte cp.async copies put the whole sequence's Q, K and V (the head
//    dim zero-padded to W = 16 ceil(Dh / 16) columns) into swizzled bf16
//    tiles (tensor_core.cuh), V in a second copy group that lands while
//    the scores and the softmax are computed.
//  * one warp per 16 query rows, 8 at S 128. A warp keeps its rows' whole
//    scores in registers (16 x S fp32: 64 values a thread at S 128) and
//    runs the reference's single-pass softmax there: the max over the
//    whole row, no online rescale, the row sum of the unrounded p, and P
//    rounded to bf16 and packed straight into the A operand of P V. The
//    tiles are zero-padded to 64 or 128 rows, so a warp computes every
//    16-key unit of its row with no branch between them (masked past S and,
//    causal, above the diagonal): branches between the unrolled units kept
//    the scheduler from interleaving their products (PERF.md).
//  * above S 128 the rows and the O accumulator at Dh 128 would not fit a
//    thread's 255 registers, so the warp splits the row instead: one pass
//    over 16-key units takes the row max, a second recomputes each unit's
//    scores (the same products in the same order, so the same values) for
//    p; causal units above the warp's diagonal are skipped there.
//  * O = acc times one reciprocal of l a row is staged through the warp's
//    own rows of the Q tile to coalesced 16-byte stores; lse goes out in
//    fp32 for supertile_bwd.
//  * what holds it above its byte bound at the BERT shape is the latency of
//    the warps' dependent products, not the bytes (PERF.md): it needs the
//    two blocks an SM that 128 registers a thread allow.
//
// supertile_bwd, bf16 (the training path), on mma.sync.m16n8k16 as well,
// in one launch, deterministic (no atomics) and with no scratch:
//  * S <= 128: one block per sequence, one warp per 16 rows. The block
//    reads the sequence's Q, K, V and dO once, by 16-byte cp.async copies,
//    into swizzled bf16 tiles (64 KB at S 128, Dh 64), and O's rows into
//    registers while they land: delta = rowsum(dO * O) is computed in the
//    block, in fp32, so no torch op runs around the kernel.
//  * phase 1: warp w owns keys 16w .. 16w + 15. Over 16-query units it
//    computes S^T = K Q^T and dP^T = V dO^T (keys as rows), forms
//    P^T = exp(S^T * scale - lse) with the forward's lse (no softmax max)
//    and dS^T = P^T (dP^T - delta) * scale in registers, rounds both to
//    bf16 as the reference does (flash_static.py:443-452) and feeds them as
//    the A operands of dV += P^T dO and dK += dS^T Q; the same bf16 dS^T
//    goes to a shared (S, 128) tile (32 KB at S 128).
//  * phase 2, after one barrier: warp w owns queries 16w .. 16w + 15 and
//    computes dQ = dS K from that tile (dS read with ldmatrix.trans). dQ
//    never touches device memory before its one store.
//  * S > 128: Q, K, V and dO of one sequence (up to 256 KB at Dh 128) do
//    not fit a block's 227 KB, nor would the S x S dS, so the same launch
//    runs four blocks a sequence: two own 128 keys each (phase 1 over
//    every query, with the sequence's Q and dO resident, 194 KB at Dh
//    128) and two own 128 queries each and recompute S and dP for their
//    dQ (the flash pair's split, 7 products instead of 5), with the
//    sequence's K and V resident. No second launch, no scratch.
//  * causal units above the diagonal are skipped (measured faster than
//    masking them, unlike in the forward, which must keep its unrolled
//    rows branch-free; PERF.md); only units on the diagonal or the ragged
//    edge are masked element by element.
//  * dK, dV and dQ leave through the warp's own rows of a tile that no
//    other warp reads then, as 16-byte stores.
//
// supertile_fwd, fp32, and supertile_bwd, fp32, keep the first port's
// CUDA-core kernels (fp32 FMAs over fp32 shared-memory tiles with row
// stride Dh + 1; TF32 tensor cores would keep ~10 mantissa bits, short of
// the port's fp32 tolerance):
//  * supertile_fwd, fp32: one 256-thread block per (sequence, 64-row query
//    tile). The block keeps the query tile and the tile's whole score rows
//    (64 x up to 256 fp32) resident in shared memory, so the softmax is a
//    single pass over a resident row, as in the TPU kernel. Keys and
//    values stream through one 64-row chunk buffer, so the block's shared
//    memory stays within ~129 KB at every admitted shape (at fp32 with
//    S = 248 and Dh = 128, K and V of one sequence alone would be 254 KB,
//    more than the 227 KB a block may have).
//  * supertile_bwd: one launch, as the TPU's one-kernel backward, one block
//    per sequence. The block walks the sequence's 64-row key chunks; for
//    each it keeps dK and dV of that chunk in registers and loops over the
//    query tiles that see it, so dK and dV need no atomics and no second
//    pass. dQ gathers contributions from every key chunk: each thread owns
//    the same dQ elements in every chunk, so it accumulates them in an fp32
//    scratch row of its own in device memory (the wrapper passes it; mostly
//    L2-resident) and writes dQ in the input dtype at the last chunk that
//    reaches it. At S <= 64 there is one chunk and no scratch.
//  * rounding follows the reference: P is cast to V's dtype before P V
//    (flash_static.py:418-421) and dS to q's dtype before its two products
//    (flash_static.py:452); the row sum of P and all accumulators are fp32.
//    delta = rowsum(dO * O) comes from supertile_delta_f32_kernel, launched
//    just before it by the same entry point.
//  * head dims that are not a multiple of 16 are zero-padded in shared
//    memory to 16 * NJ columns; only the first Dh are read and written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tensor_core.cuh"

namespace {

constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;
constexpr int kTile = 64;        // rows of a query tile and of a key chunk
constexpr int kThreads = 256;    // a 16 x 16 grid of threads, 4 x 4 rows each
constexpr int kPLd = kTile + 1;  // row stride of the (64, 64) P / dS tiles
constexpr int kMaxSeq = 256;     // S < kMaxSeq (the port's shape gate)
constexpr int kMaxDh = 128;
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

// rows [r0, r0 + 64) of a (S, Dh) matrix into shared memory as fp32, DHP
// columns with row stride DHP + 1; rows at or past S and columns at or past
// Dh load as zeros
template <typename T, int DHP>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int r0,
                                          int S, int Dh) {
  for (int idx = threadIdx.x; idx < kTile * DHP; idx += kThreads) {
    const int r = idx / DHP;
    const int d = idx - r * DHP;
    const int gr = r0 + r;
    dst[r * (DHP + 1) + d] =
        (gr < S && d < Dh) ? to_f32(src[static_cast<long long>(gr) * Dh + d]) : 0.f;
  }
}

__host__ __device__ __forceinline__ int n_tiles(int S) { return (S + kTile - 1) / kTile; }

template <int NJ>
size_t fwd_smem(int S) {
  const int ld = 16 * NJ + 1;
  return (2 * kTile * ld + kTile * (n_tiles(S) * kTile + 1)) * sizeof(float);
}
template <int NJ>
size_t bwd_smem() {
  const int ld = 16 * NJ + 1;
  return (4 * kTile * ld + 2 * kTile * kPLd + 2 * kTile) * sizeof(float);
}

// Thread (ty, tx) of the 16 x 16 grid owns rows ty + 16 i (i < 4) of a
// 64-row tile: columns tx + 16 j (j < 4) of a (64, 64) score tile, and
// columns tx + 16 j (j < NJ) of a (64, 16 NJ) accumulator.

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
    supertile_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ o,
                         float* __restrict__ lse, int S, int Dh, float scale, bool causal) {
  constexpr int DHP = 16 * NJ;
  constexpr int LD = DHP + 1;
  extern __shared__ float smem[];
  const int nt = n_tiles(S);
  const int sld = nt * kTile + 1;  // row stride of the resident score rows
  float* qs = smem;
  float* kv = qs + kTile * LD;     // one key or value chunk at a time
  float* ss = kv + kTile * LD;     // (64, nt * 64) scores, then P
  const long long bh = blockIdx.x / nt;
  const int qt = blockIdx.x - static_cast<int>(bh * nt);
  const int q0 = qt * kTile;
  const long long base = bh * S * Dh;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  // causal: query tile qt sees key chunks 0..qt only
  const int kend = causal ? qt + 1 : nt;

  load_tile<T, DHP>(qs, q + base, q0, S, Dh);
  for (int kt = 0; kt < kend; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous chunk is consumed (and qs loaded)
    load_tile<T, DHP>(kv, k + base, k0, S, Dh);
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < Dh; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = kv[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        const bool keep = c < S && !(causal && c > r);
        ss[(ty + 16 * i) * sld + c] = keep ? s[i][j] * scale : kNegInf;
      }
    }
  }
  __syncthreads();
  // single-pass softmax over each resident row (columns [0, kend * 64));
  // the row sum is of the unrounded p, P is stored rounded to T
  const int ncol = kend * kTile;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* row = ss + (ty + 16 * i) * sld;
    float mx = kNegInf;
    for (int c = tx; c < ncol; c += 16) mx = fmaxf(mx, row[c]);
    m[i] = row16_max(mx);
    float sum = 0.f;
    for (int c = tx; c < ncol; c += 16) {
      const float p = expf(row[c] - m[i]);
      sum += p;
      row[c] = round_to<T>(p);
    }
    l[i] = row16_sum(sum);
  }
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  for (int kt = 0; kt < kend; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // P is complete; the previous value chunk is consumed
    load_tile<T, DHP>(kv, v + base, k0, S, Dh);
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = ss[(ty + 16 * i) * sld + k0 + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = kv[c * LD + tx + 16 * j];
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
      const int col = tx + 16 * j;
      if (col < Dh) o[base + static_cast<long long>(r) * Dh + col] = from_f32<T>(acc[i][j] / l[i]);
    }
    if (tx == 0) lse[bh * S + r] = m[i] + logf(l[i]);
  }
}

// dQ, dK and dV of one sequence per block, in one launch.
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
    supertile_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
                         float* __restrict__ dq_acc, int S, int Dh, float scale,
                         bool causal) {
  constexpr int DHP = 16 * NJ;
  constexpr int LD = DHP + 1;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kTile * LD;
  float* qs = vs + kTile * LD;
  float* dos = qs + kTile * LD;
  float* ps = dos + kTile * LD;
  float* dss = ps + kTile * kPLd;
  float* lse_s = dss + kTile * kPLd;
  float* delta_s = lse_s + kTile;
  const long long bh = blockIdx.x;
  const long long base = bh * S * Dh;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int nt = n_tiles(S);

  for (int kt = 0; kt < nt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous chunk's tiles are consumed
    load_tile<T, DHP>(ks, k + base, k0, S, Dh);
    load_tile<T, DHP>(vs, v + base, k0, S, Dh);
    float dk_acc[4][NJ], dv_acc[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        dk_acc[i][j] = 0.f;
        dv_acc[i][j] = 0.f;
      }
    // causal: key chunk kt is seen by query tiles kt..nt-1 only
    for (int qt = causal ? kt : 0; qt < nt; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();  // the previous tile's qs, dos, ps, dss are consumed
      load_tile<T, DHP>(qs, q + base, q0, S, Dh);
      load_tile<T, DHP>(dos, dout + base, q0, S, Dh);
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
      for (int d = 0; d < Dh; ++d) {
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
      // dQ[r] += sum_c dS[r][c] K[c] for query rows r = ty + 16 i: this
      // thread's elements, carried across key chunks in its own scratch
      float dq_part[4][NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) dq_part[i][j] = 0.f;
#pragma unroll 4
      for (int c = 0; c < kTile; ++c) {
        float sa[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) sa[i] = dss[(ty + 16 * i) * kPLd + c];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float kvv = ks[c * LD + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) dq_part[i][j] = fmaf(sa[i], kvv, dq_part[i][j]);
        }
      }
      const bool first = kt == 0;
      const bool last = kt == (causal ? qt : nt - 1);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = q0 + ty + 16 * i;
        if (r >= S) continue;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int col = tx + 16 * j;
          if (col >= Dh) continue;
          const long long at = base + static_cast<long long>(r) * Dh + col;
          const float val = first ? dq_part[i][j] : dq_acc[at] + dq_part[i][j];
          if (last) {
            dq[at] = from_f32<T>(val);
          } else {
            dq_acc[at] = val;
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
        const int col = tx + 16 * j;
        if (col >= Dh) continue;
        const long long at = base + static_cast<long long>(c) * Dh + col;
        dk[at] = from_f32<T>(dk_acc[i][j]);
        dv[at] = from_f32<T>(dv_acc[i][j]);
      }
    }
  }
}

// delta = rowsum(dO * O) in fp32 for the fp32 backward over (rows, Dh)
// row-major o and dout: 4 lanes a row, 16-byte loads (Dh % 8 == 0)
__global__ void __launch_bounds__(256)
    supertile_delta_f32_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                               float* __restrict__ delta, long long rows, int Dh) {
  const long long row = static_cast<long long>(blockIdx.x) * 64 + (threadIdx.x >> 2);
  float sum = 0.f;
  if (row < rows) {
    const float4* ov = reinterpret_cast<const float4*>(o + row * Dh);
    const float4* dv = reinterpret_cast<const float4*>(dout + row * Dh);
    for (int c = threadIdx.x & 3; c < Dh / 4; c += 4) {
      const float4 a = ov[c];
      const float4 b = dv[c];
      sum = fmaf(a.x, b.x, sum);
      sum = fmaf(a.y, b.y, sum);
      sum = fmaf(a.z, b.z, sum);
      sum = fmaf(a.w, b.w, sum);
    }
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  if (row < rows && (threadIdx.x & 3) == 0) delta[row] = sum;
}

// ------------------------------------------------------------------ //
// bf16 supertile_fwd: tensor cores (mma.sync m16n8k16), cp.async, ldmatrix
// ------------------------------------------------------------------ //

constexpr int kMmaWarps = 8;  // warps of a block, each on 16-row query tiles

// 16-key units whose scores a warp keeps in registers, for S up to 64 and
// up to 128; above that it recomputes them (0)
__host__ __device__ constexpr int resident_units(int S) {
  return S <= 64 ? 4 : (S <= 128 ? 8 : 0);
}

// rows of the Q, K and V tiles: S rounded up to the 16 NU keys a
// register-resident row holds (so that every unit is computed, with no
// branch between them), or to 16 when the scores are recomputed
__host__ __device__ constexpr int tile_rows(int S) {
  return resident_units(S) > 0 ? 16 * resident_units(S) : (S + 15) / 16 * 16;
}

// rows [0, S) of a (S, Dh) bf16 matrix into a swizzled (rows, W) tile with
// cp.async; rows at or past S and chunks at or past Dh / 8 are zero-filled
template <int W>
__device__ __forceinline__ void load_seq_async(bf16* dst, const bf16* __restrict__ src, int S,
                                               int rows, int Dh, int tid, int nthreads) {
  constexpr int CPR = W / 8;
  const int dchunks = Dh / 8;
  for (int i = tid; i < rows * CPR; i += nthreads) {
    const int r = i / CPR;
    const int c = i - r * CPR;
    const bool ok = r < S && c < dchunks;
    cp_async16(chunk_addr<W>(dst, r, c), src + (ok ? static_cast<long long>(r) * Dh + c * 8 : 0),
               ok);
  }
}

// S = Q K^T for the 16 query rows at q0 (A fragments qf) and keys 16u ..
// 16u + 15, accumulated into two 8-column tiles
template <int W>
__device__ __forceinline__ void score_unit(const uint32_t (&qf)[4], const bf16* ks, int u,
                                           int kk, int lane, float (&s)[2][4]) {
  uint32_t b[4];
  ldsm_x4(b_addr<W>(ks, 16 * u, kk, lane), b);
  mma_bf16(s[0], qf, b[0], b[1]);
  mma_bf16(s[1], qf, b[2], b[3]);
}

// unit u's scores times scale, NEG_INF past S and (causal) above the
// diagonal, folded into the row maxima mx of rows g and g + 8
__device__ __forceinline__ void mask_unit(float (&s)[2][4], int u, int q0, int S, float scale,
                                          bool causal, int g, int t, float (&mx)[2]) {
  const bool edge = 16 * u + 16 > S || (causal && 16 * u + 15 > q0);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float val = s[j][e] * scale;
      if (edge) {
        const int c = 16 * u + 8 * j + 2 * t + (e & 1);
        const int r = q0 + g + 8 * (e >> 1);
        if (c >= S || (causal && c > r)) val = kNegInf;
      }
      s[j][e] = val;
      mx[e >> 1] = fmaxf(mx[e >> 1], val);
    }
  }
}

// p = exp(s - m) of one unit in place, its unrounded values added to the
// row sums l
__device__ __forceinline__ void exp_unit(float (&s)[2][4], const float (&m)[2], float (&l)[2]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = fast_exp2((s[j][e] - m[e >> 1]) * kLog2e);
      s[j][e] = p;
      l[e >> 1] += p;
    }
  }
}

// acc += P V[16u .. 16u + 15], P rounded to bf16 and packed from the
// unit's p values into the A operand
template <int W>
__device__ __forceinline__ void pv_unit(const float (&p)[2][4], const bf16* vs, int u, int lane,
                                        float (&acc)[W / 8][4]) {
  uint32_t pa[4];
  a_from_acc(pa, p[0], p[1]);
#pragma unroll
  for (int dp = 0; dp < W / 16; ++dp) {
    uint32_t b[4];
    ldsm_x4_trans(a_addr<W>(vs, 16 * u, dp, lane), b);
    mma_bf16(acc[2 * dp], pa, b[0], b[1]);
    mma_bf16(acc[2 * dp + 1], pa, b[2], b[3]);
  }
}

__device__ __forceinline__ void quad_max(float (&mx)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
  }
}

// Stores o = acc / l (one reciprocal a row) and lse = m + log(l) of the 16
// query rows at q0 (rows at or past S dropped), o through the warp's own
// rows of the Q tile (read by no other warp).
template <int W>
__device__ __forceinline__ void finish_rows(bf16* qs, int q0, float (&acc)[W / 8][4],
                                            const float (&m)[2], float (&l)[2], int S, int Dh,
                                            bf16* __restrict__ o, float* __restrict__ lse,
                                            int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = 1.f / l[i];
  }
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] *= inv[e >> 1];
  }
  store_rows<W>(qs, q0, acc, o, q0, S, Dh, Dh / 8, lane);
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = q0 + g + 8 * i;
      if (r < S) lse[r] = m[i] + logf(l[i]);
    }
  }
}

// One block per sequence. Q and K are one copy group and V a second, so the
// scores and the softmax run while V lands. W: the head dim padded to a
// multiple of 16.
//  * NU > 0 (S <= 16 NU): warp w owns query rows 16w .. 16w + 15 (the
//    launch gives one warp per 16 rows of the tile) and keeps the scores of
//    all NU 16-key units (the whole row) in registers: the row max, p and
//    its row sums, then P V. Every unit is computed (the tiles are zero
//    past S; mask_unit hides those keys and, causal, those above the
//    diagonal), so no branch splits the unrolled units.
//  * NU == 0 (S > 128, where the scores and the O accumulator at Dh 128
//    would not fit a thread's 255 registers): warp w takes 16-row tiles w,
//    w + 8, ..., takes the row max in one pass over the units it sees and
//    recomputes each unit's scores (the same products in the same order,
//    so the same values) in a second.
// Two blocks an SM up to W 64.
template <int W, int NU>
__global__ void __launch_bounds__(32 * kMmaWarps, W <= 64 ? 2 : 1)
    supertile_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, bf16* __restrict__ o,
                             float* __restrict__ lse, int S, int Dh, float scale, bool causal) {
  constexpr int ND = W / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int rows = tile_rows(S);
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + rows * W;
  bf16* vs = ks + rows * W;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const long long bh = blockIdx.x;
  const long long base = bh * S * Dh;
  o += base;
  lse += bh * S;

  load_seq_async<W>(qs, q + base, S, rows, Dh, tid, nthreads);
  load_seq_async<W>(ks, k + base, S, rows, Dh, tid, nthreads);
  cp_async_commit();
  load_seq_async<W>(vs, v + base, S, rows, Dh, tid, nthreads);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  float acc[ND][4];
  float mx[2], l[2];
  if constexpr (NU > 0) {
    const int q0 = 16 * warp;
    float s[NU][2][4];
#pragma unroll
    for (int u = 0; u < NU; ++u) {
#pragma unroll
      for (int j = 0; j < 2; ++j) s[u][j][0] = s[u][j][1] = s[u][j][2] = s[u][j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < W / 16; ++kk) {
      uint32_t qf[4];
      ldsm_x4(a_addr<W>(qs, q0, kk, lane), qf);
#pragma unroll
      for (int u = 0; u < NU; ++u) score_unit<W>(qf, ks, u, kk, lane, s[u]);
    }
    mx[0] = mx[1] = kNegInf;
    l[0] = l[1] = 0.f;
#pragma unroll
    for (int u = 0; u < NU; ++u) mask_unit(s[u], u, q0, S, scale, causal, g, t, mx);
    quad_max(mx);
#pragma unroll
    for (int u = 0; u < NU; ++u) exp_unit(s[u], mx, l);
    cp_async_wait<0>();  // V
    __syncthreads();
#pragma unroll
    for (int j = 0; j < ND; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
    for (int u = 0; u < NU; ++u) pv_unit<W>(s[u], vs, u, lane, acc);
    finish_rows<W>(qs, q0, acc, mx, l, S, Dh, o, lse, lane);
  } else {
    cp_async_wait<0>();  // V
    __syncthreads();
    for (int q0 = 16 * warp; q0 < rows; q0 += 16 * (nthreads >> 5)) {
      const int uend = causal ? q0 / 16 + 1 : rows / 16;  // key units the tile sees
      mx[0] = mx[1] = kNegInf;
      l[0] = l[1] = 0.f;
      for (int u = 0; u < uend; ++u) {
        float sc[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < W / 16; ++kk) {
          uint32_t qf[4];
          ldsm_x4(a_addr<W>(qs, q0, kk, lane), qf);
          score_unit<W>(qf, ks, u, kk, lane, sc);
        }
        mask_unit(sc, u, q0, S, scale, causal, g, t, mx);
      }
      quad_max(mx);
#pragma unroll
      for (int j = 0; j < ND; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      for (int u = 0; u < uend; ++u) {
        float sc[2][4] = {};
        float unused[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int kk = 0; kk < W / 16; ++kk) {
          uint32_t qf[4];
          ldsm_x4(a_addr<W>(qs, q0, kk, lane), qf);
          score_unit<W>(qf, ks, u, kk, lane, sc);
        }
        mask_unit(sc, u, q0, S, scale, causal, g, t, unused);
        exp_unit(sc, mx, l);
        pv_unit<W>(sc, vs, u, lane, acc);
      }
      finish_rows<W>(qs, q0, acc, mx, l, S, Dh, o, lse, lane);
    }
  }
}

size_t fwd_mma_smem(int S, int W) {  // Q, K and V of one sequence
  return static_cast<size_t>(3) * tile_rows(S) * W * sizeof(bf16);
}

// ------------------------------------------------------------------ //
// bf16 supertile_bwd: tensor cores (mma.sync m16n8k16), cp.async, ldmatrix
// ------------------------------------------------------------------ //

constexpr int kFusedMaxSeq = 128;  // up to this S one block owns a sequence
constexpr int kDsWidth = 128;      // queries of a row of the shared dS^T tile
constexpr int kChunk = 128;        // rows a block owns above kFusedMaxSeq
constexpr int kBwdWarps = 8;

__host__ __device__ constexpr int rows16(int S) { return (S + 15) / 16 * 16; }

// delta = rowsum(dO * O) in fp32 for rows [0, n) of a tile of ``rows``
// rows (tile row i is row i of ``o``, whose rows have Dh columns), 4 lanes a
// row: load() reads O's rows from device memory into registers before the
// tiles land, finish() adds the products with dO's swizzled tile and writes
// dl[i] for every tile row (0 past n).
template <int W, int PASSES>
struct DeltaRows {
  static constexpr int NCH = (W / 8 + 3) / 4;  // 16-byte chunks a lane
  uint4 ov[PASSES][NCH];

  __device__ __forceinline__ void load(const bf16* __restrict__ o, int n, int Dh, int tid,
                                       int nthreads) {
    const int dchunks = Dh / 8;
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int i = (tid >> 2) + p * (nthreads >> 2);
#pragma unroll
      for (int j = 0; j < NCH; ++j) {
        const int c = (tid & 3) + 4 * j;
        ov[p][j] = (i < n && c < dchunks)
                       ? __ldg(reinterpret_cast<const uint4*>(o + static_cast<long long>(i) * Dh +
                                                              c * 8))
                       : make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }

  __device__ __forceinline__ void finish(const bf16* dos, float* dl, int n, int rows, int Dh,
                                         int tid, int nthreads) const {
    const int dchunks = Dh / 8;
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int i = (tid >> 2) + p * (nthreads >> 2);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NCH; ++j) {
        const int c = (tid & 3) + 4 * j;
        if (i < n && c < dchunks) {
          const uint4 d = *reinterpret_cast<const uint4*>(dos + i * W + swz<W>(i, c) * 8);
          const bf16* a = reinterpret_cast<const bf16*>(&ov[p][j]);
          const bf16* b = reinterpret_cast<const bf16*>(&d);
#pragma unroll
          for (int e = 0; e < 8; ++e) sum = fmaf(to_f32(a[e]), to_f32(b[e]), sum);
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if ((tid & 3) == 0 && i < rows) dl[i] = sum;
    }
  }
};

// lse * log2(e) of rows [0, rows) (row i is lse[i]; 0 at or past n), so that
// p = exp2(s * scale * log2(e) - lse2)
__device__ __forceinline__ void load_lse2(float* dst, const float* __restrict__ lse, int n,
                                          int rows, int tid, int nthreads) {
  for (int i = tid; i < rows; i += nthreads) dst[i] = i < n ? lse[i] * kLog2e : 0.f;
}

// One warp's phase 1: dV and dK of the 16 keys at tile row k0 of ks and vs
// (sequence keys kg0 + k0 ..), over the 16-query units [qbeg, qend) of the
// tiles qs and dos (tile row i is query i), whose lse2 and delta rows are
// lse2[i] and dl[i]. S^T = K Q^T and dP^T = V dO^T come out with keys as
// rows, so P^T and dS^T, rounded to bf16, are the A operands of
// dV += P^T dO and dK += dS^T Q without leaving registers; the same bf16
// dS^T goes to the swizzled (keys, kDsWidth) tile ds_t when it is given.
// dV and dK are stored to rows kg0 + k0 .. of dv and dk through the warp's
// own rows of vs (no other warp reads them).
template <int W>
__device__ __forceinline__ void dkdv_warp(const bf16* ks, bf16* vs, const bf16* qs,
                                          const bf16* dos, const float* lse2, const float* dl,
                                          bf16* ds_t, int k0, int kg0, int qbeg, int qend, int S,
                                          int Dh, float scale, float scale_log2, bool causal,
                                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                                          int lane) {
  constexpr int ND = W / 8;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int kgs = kg0 + k0;  // the warp's first key
  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;
  }
  for (int qu = qbeg; qu < qend; ++qu) {
    const int q0 = 16 * qu;
    float sT[2][4], dpT[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sT[j][e] = dpT[j][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < W / 16; ++kk) {
      uint32_t a[4], b[4];
      ldsm_x4(a_addr<W>(ks, k0, kk, lane), a);
      ldsm_x4(b_addr<W>(qs, q0, kk, lane), b);
      mma_bf16(sT[0], a, b[0], b[1]);
      mma_bf16(sT[1], a, b[2], b[3]);
      ldsm_x4(a_addr<W>(vs, k0, kk, lane), a);
      ldsm_x4(b_addr<W>(dos, q0, kk, lane), b);
      mma_bf16(dpT[0], a, b[0], b[1]);
      mma_bf16(dpT[1], a, b[2], b[3]);
    }
    const bool edge = q0 + 16 > S || kgs + 16 > S || (causal && q0 < kgs + 15);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = q0 + 8 * j + 2 * t + (e & 1);
        float p = fast_exp2(fmaf(sT[j][e], scale_log2, -lse2[qc]));
        if (edge) {
          const int kr = kgs + g + 8 * (e >> 1);
          if (qc >= S || kr >= S || (causal && kr > qc)) p = 0.f;
        }
        sT[j][e] = p;
        dpT[j][e] = p * (dpT[j][e] - dl[qc]) * scale;
      }
    }
    uint32_t pa[4], da[4];
    a_from_acc(pa, sT[0], sT[1]);
    a_from_acc(da, dpT[0], dpT[1]);
#pragma unroll
    for (int dp = 0; dp < W / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_trans(a_addr<W>(dos, q0, dp, lane), b);
      mma_bf16(dva[2 * dp], pa, b[0], b[1]);
      mma_bf16(dva[2 * dp + 1], pa, b[2], b[3]);
      ldsm_x4_trans(a_addr<W>(qs, q0, dp, lane), b);
      mma_bf16(dka[2 * dp], da, b[0], b[1]);
      mma_bf16(dka[2 * dp + 1], da, b[2], b[3]);
    }
    if (ds_t != nullptr) {
      // the A fragment's rows g, g + 8 and columns 2t, 2t + 8 (two bf16 each)
      const int ra = k0 + g;
      const int rb = ra + 8;
      const int ca = 2 * qu;  // the 16-byte chunk of queries q0 .. q0 + 7
      *reinterpret_cast<uint32_t*>(ds_t + ra * kDsWidth + swz<kDsWidth>(ra, ca) * 8 + 2 * t) =
          da[0];
      *reinterpret_cast<uint32_t*>(ds_t + rb * kDsWidth + swz<kDsWidth>(rb, ca) * 8 + 2 * t) =
          da[1];
      *reinterpret_cast<uint32_t*>(ds_t + ra * kDsWidth + swz<kDsWidth>(ra, ca + 1) * 8 +
                                   2 * t) = da[2];
      *reinterpret_cast<uint32_t*>(ds_t + rb * kDsWidth + swz<kDsWidth>(rb, ca + 1) * 8 +
                                   2 * t) = da[3];
    }
  }
  store_rows<W>(vs, k0, dva, dv, kgs, S, Dh, Dh / 8, lane);
  store_rows<W>(vs, k0, dka, dk, kgs, S, Dh, Dh / 8, lane);
}

// One warp's dQ of the 16 queries at tile row q0 of qs (sequence queries
// qg0 ..), over the key units [0, kend) of ks and vs (tile row i is key i),
// recomputing S = Q K^T and dP = dO V^T; lse2 and dl hold the tile's query
// rows. dS, rounded to bf16, is the A operand of dQ += dS K straight from
// the accumulators. Stored to rows qg0 .. of dq through the warp's own rows
// of qs.
template <int W>
__device__ __forceinline__ void dq_warp(bf16* qs, const bf16* dos, const bf16* ks,
                                        const bf16* vs, const float* lse2, const float* dl,
                                        int q0, int qg0, int kend, int S, int Dh, float scale,
                                        float scale_log2, bool causal, bf16* __restrict__ dq,
                                        int lane) {
  constexpr int ND = W / 8;
  const int g = lane >> 2;
  const int t = lane & 3;
  float lr[2], dlr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lr[i] = lse2[q0 + g + 8 * i];
    dlr[i] = dl[q0 + g + 8 * i];
  }
  float dqa[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) dqa[j][0] = dqa[j][1] = dqa[j][2] = dqa[j][3] = 0.f;
  for (int ku = 0; ku < kend; ++ku) {
    const int k0 = 16 * ku;
    float s[2][4], dp[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < W / 16; ++kk) {
      uint32_t a[4], b[4];
      ldsm_x4(a_addr<W>(qs, q0, kk, lane), a);
      ldsm_x4(b_addr<W>(ks, k0, kk, lane), b);
      mma_bf16(s[0], a, b[0], b[1]);
      mma_bf16(s[1], a, b[2], b[3]);
      ldsm_x4(a_addr<W>(dos, q0, kk, lane), a);
      ldsm_x4(b_addr<W>(vs, k0, kk, lane), b);
      mma_bf16(dp[0], a, b[0], b[1]);
      mma_bf16(dp[1], a, b[2], b[3]);
    }
    const bool edge = k0 + 16 > S || qg0 + 16 > S || (causal && k0 + 15 > qg0);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float p = fast_exp2(fmaf(s[j][e], scale_log2, -lr[i]));
        if (edge) {
          const int c = k0 + 8 * j + 2 * t + (e & 1);
          const int r = qg0 + g + 8 * i;
          if (c >= S || r >= S || (causal && c > r)) p = 0.f;
        }
        dp[j][e] = p * (dp[j][e] - dlr[i]) * scale;
      }
    }
    uint32_t sa[4];
    a_from_acc(sa, dp[0], dp[1]);
#pragma unroll
    for (int d2 = 0; d2 < W / 16; ++d2) {
      uint32_t b[4];
      ldsm_x4_trans(a_addr<W>(ks, k0, d2, lane), b);
      mma_bf16(dqa[2 * d2], sa, b[0], b[1]);
      mma_bf16(dqa[2 * d2 + 1], sa, b[2], b[3]);
    }
  }
  store_rows<W>(qs, q0, dqa, dq, qg0, S, Dh, Dh / 8, lane);
}

// W: the head dim padded to a multiple of 16.
//  * !kSplit (S <= kFusedMaxSeq): one block per sequence, one warp per 16
//    rows of the R = rows16(S) rows. Shared memory: Q, K, V, dO (R, W)
//    bf16 each, dS^T (R, kDsWidth) bf16, lse2 and delta (R) fp32. Phase 1
//    (warp w: keys 16w..) writes dS^T; after a barrier, phase 2 (warp w:
//    queries 16w..) computes dQ = dS K from it.
//  * kSplit (S > kFusedMaxSeq): grid (BH, chunks, 2), 8 warps. blockIdx.z
//    0: the block owns keys [128 c, 128 c + 128) (c = blockIdx.y), with K
//    and V of those keys and the whole sequence's Q and dO resident, and
//    runs phase 1 alone; 1: it owns those queries, with their Q and dO and
//    the whole sequence's K and V resident, and computes their dQ.
// Both leave delta to the block: O's rows are read while the tiles land.
template <int W, bool kSplit>
__global__ void __launch_bounds__(32 * kBwdWarps, W <= 64 ? 2 : 1)
    supertile_bwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const bf16* __restrict__ o,
                             const bf16* __restrict__ dout, const float* __restrict__ lse,
                             bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
                             int S, int Dh, float scale, bool causal) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int R = rows16(S);
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long bh = blockIdx.x;
  const long long base = bh * S * Dh;
  const float scale_log2 = scale * kLog2e;
  lse += bh * S;

  if constexpr (!kSplit) {
    bf16* qs = reinterpret_cast<bf16*>(smem_raw);
    bf16* ks = qs + R * W;
    bf16* vs = ks + R * W;
    bf16* dos = vs + R * W;
    bf16* ds_t = dos + R * W;
    float* lse2 = reinterpret_cast<float*>(ds_t + R * kDsWidth);
    float* dl = lse2 + R;
    load_seq_async<W>(ks, k + base, S, R, Dh, tid, nthreads);
    load_seq_async<W>(qs, q + base, S, R, Dh, tid, nthreads);
    load_seq_async<W>(vs, v + base, S, R, Dh, tid, nthreads);
    load_seq_async<W>(dos, dout + base, S, R, Dh, tid, nthreads);
    cp_async_commit();
    load_lse2(lse2, lse, S, R, tid, nthreads);
    DeltaRows<W, 2> delta;  // 2 passes of nthreads / 4 = R / 2 rows
    delta.load(o + base, S, Dh, tid, nthreads);
    cp_async_wait<0>();
    __syncthreads();
    delta.finish(dos, dl, S, R, Dh, tid, nthreads);
    __syncthreads();
    const int nu = R / 16;
    dkdv_warp<W>(ks, vs, qs, dos, lse2, dl, ds_t, 16 * warp, 0, causal ? warp : 0, nu, S, Dh,
                 scale, scale_log2, causal, dk + base, dv + base, lane);
    __syncthreads();  // dS^T is complete
    const int q0 = 16 * warp;
    const int kend = causal ? warp + 1 : nu;
    constexpr int ND = W / 8;
    float dqa[ND][4];
#pragma unroll
    for (int j = 0; j < ND; ++j) dqa[j][0] = dqa[j][1] = dqa[j][2] = dqa[j][3] = 0.f;
    for (int ku = 0; ku < kend; ++ku) {
      uint32_t sa[4];
      // dS (queries q0.., keys 16ku..) read across dS^T's rows
      ldsm_x4_trans(b_addr<kDsWidth>(ds_t, 16 * ku, warp, lane), sa);
#pragma unroll
      for (int d2 = 0; d2 < W / 16; ++d2) {
        uint32_t b[4];
        ldsm_x4_trans(a_addr<W>(ks, 16 * ku, d2, lane), b);
        mma_bf16(dqa[2 * d2], sa, b[0], b[1]);
        mma_bf16(dqa[2 * d2 + 1], sa, b[2], b[3]);
      }
    }
    // Q's rows are read by no warp in phase 2: the warp's own stage dQ
    store_rows<W>(qs, q0, dqa, dq + base, q0, S, Dh, Dh / 8, lane);
  } else {
    const int c0 = kChunk * blockIdx.y;  // the block's first key (or query)
    const int own = min(kChunk, R - c0);  // rows of the block's own chunk
    const bool keys = blockIdx.z == 0;
    // resident tiles: the own chunk's K, V (or Q, dO), the whole sequence's
    // Q, dO (or K, V)
    bf16* own_a = reinterpret_cast<bf16*>(smem_raw);
    bf16* own_b = own_a + kChunk * W;
    bf16* all_a = own_b + kChunk * W;
    bf16* all_b = all_a + R * W;
    float* lse2 = reinterpret_cast<float*>(all_b + R * W);
    float* dl = lse2 + R;
    const long long cbase = base + static_cast<long long>(c0) * Dh;
    load_seq_async<W>(own_a, (keys ? k : q) + cbase, S - c0, own, Dh, tid, nthreads);
    load_seq_async<W>(own_b, (keys ? v : dout) + cbase, S - c0, own, Dh, tid, nthreads);
    load_seq_async<W>(all_a, (keys ? q : k) + base, S, R, Dh, tid, nthreads);
    load_seq_async<W>(all_b, (keys ? dout : v) + base, S, R, Dh, tid, nthreads);
    cp_async_commit();
    // the queries whose lse and delta the block needs: all, or its own
    const int qr0 = keys ? 0 : c0;
    const int qrows = keys ? R : own;
    const int qvalid = min(S - qr0, qrows);
    load_lse2(lse2, lse + qr0, qvalid, qrows, tid, nthreads);
    DeltaRows<W, 4> delta;  // 4 passes of 64 rows cover R <= 256
    delta.load(o + base + static_cast<long long>(qr0) * Dh, qvalid, Dh, tid, nthreads);
    cp_async_wait<0>();
    __syncthreads();
    delta.finish(keys ? all_b : own_b, dl, qvalid, qrows, Dh, tid, nthreads);
    __syncthreads();
    const int r0 = 16 * warp;  // the warp's rows of the own chunk
    if (r0 >= own) return;     // no barrier follows
    if (keys) {
      const int kgs = c0 + r0;
      dkdv_warp<W>(own_a, own_b, all_a, all_b, lse2, dl, nullptr, r0, c0, causal ? kgs / 16 : 0,
                   R / 16, S, Dh, scale, scale_log2, causal, dk + base, dv + base, lane);
    } else {
      const int qg0 = c0 + r0;
      dq_warp<W>(own_a, own_b, all_a, all_b, lse2, dl, r0, qg0, causal ? qg0 / 16 + 1 : R / 16, S,
                 Dh, scale, scale_log2, causal, dq + base, lane);
    }
  }
}

size_t bwd_mma_smem(int S, int W) {
  const size_t R = static_cast<size_t>(rows16(S));
  if (S <= kFusedMaxSeq) {  // Q, K, V, dO, dS^T (bf16); lse2, delta (fp32)
    return (4 * R * W + R * kDsWidth) * sizeof(bf16) + 2 * R * sizeof(float);
  }
  return (2 * static_cast<size_t>(kChunk) + 2 * R) * W * sizeof(bf16) + 2 * R * sizeof(float);
}

// threads of a block: one warp per 16 rows of the sequence up to S 128,
// else kBwdWarps
int bwd_mma_threads(int S) { return S <= kFusedMaxSeq ? 2 * rows16(S) : 32 * kBwdWarps; }

// warps of a block: one per 16 rows of the tiles, at most kMmaWarps
int mma_warps(int S) {
  const int warps = tile_rows(S) / 16;
  return warps < kMmaWarps ? warps : kMmaWarps;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int NJ>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int BH,
               int S, int Dh, float scale, bool causal, cudaStream_t s) {
  const size_t smem = fwd_smem<NJ>(S);
  cudaError_t err = allow_smem(supertile_fwd_kernel<T, NJ>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(BH) * n_tiles(S);
  supertile_fwd_kernel<T, NJ><<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), S, Dh, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// fp32: delta, then the CUDA-core kernel. scratch: BH * S fp32 for delta,
// then BH * S * Dh fp32 for dq above one key chunk (S > 64)
template <int NJ>
int launch_bwd_f32(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const void* lse, void* dq, void* dk, void* dv,
                   void* scratch, int BH, int S, int Dh, float scale, bool causal,
                   cudaStream_t s) {
  const size_t smem = bwd_smem<NJ>();
  cudaError_t err = allow_smem(supertile_bwd_kernel<float, NJ>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(BH) * S;
  float* delta = static_cast<float*>(scratch);
  supertile_delta_f32_kernel<<<static_cast<unsigned>((rows + 63) / 64), 256, 0, s>>>(
      static_cast<const float*>(o), static_cast<const float*>(dout), delta, rows, Dh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  supertile_bwd_kernel<float, NJ><<<BH, kThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse), delta,
      static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv),
      S > kTile ? delta + rows : nullptr, S, Dh, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int W>
int launch_bwd_mma(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const void* lse, void* dq, void* dk, void* dv, int BH,
                   int S, int Dh, float scale, bool causal, cudaStream_t s) {
  const size_t smem = bwd_mma_smem(S, W);
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* ob = static_cast<const bf16*>(o);
  const bf16* db = static_cast<const bf16*>(dout);
  const float* lf = static_cast<const float*>(lse);
  bf16* dqb = static_cast<bf16*>(dq);
  bf16* dkb = static_cast<bf16*>(dk);
  bf16* dvb = static_cast<bf16*>(dv);
  cudaError_t err;
  if (S <= kFusedMaxSeq) {
    err = allow_smem(supertile_bwd_mma_kernel<W, false>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    supertile_bwd_mma_kernel<W, false><<<BH, bwd_mma_threads(S), smem, s>>>(
        qb, kb, vb, ob, db, lf, dqb, dkb, dvb, S, Dh, scale, causal);
  } else {
    err = allow_smem(supertile_bwd_mma_kernel<W, true>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(BH, (rows16(S) + kChunk - 1) / kChunk, 2);
    supertile_bwd_mma_kernel<W, true><<<grid, bwd_mma_threads(S), smem, s>>>(
        qb, kb, vb, ob, db, lf, dqb, dkb, dvb, S, Dh, scale, causal);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int NJ>
int bwd_mma_info(int S, int* out) {
  constexpr int W = 16 * NJ;
  const size_t smem = bwd_mma_smem(S, W);
  if (S <= kFusedMaxSeq) {
    return kernel_info(supertile_bwd_mma_kernel<W, false>, smem, bwd_mma_threads(S), out);
  }
  return kernel_info(supertile_bwd_mma_kernel<W, true>, smem, bwd_mma_threads(S), out);
}

template <int W, int NU>
int launch_fwd_mma(const void* q, const void* k, const void* v, void* o, void* lse, int BH, int S,
                   int Dh, float scale, bool causal, cudaStream_t s) {
  const size_t smem = fwd_mma_smem(S, W);
  cudaError_t err = allow_smem(supertile_fwd_mma_kernel<W, NU>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  supertile_fwd_mma_kernel<W, NU><<<BH, 32 * mma_warps(S), smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), S, Dh, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int NJ>
int fwd_mma_by_seq(const void* q, const void* k, const void* v, void* o, void* lse, int BH,
                   int S, int Dh, float scale, bool causal, cudaStream_t s) {
  switch (resident_units(S)) {
    case 4: return launch_fwd_mma<16 * NJ, 4>(q, k, v, o, lse, BH, S, Dh, scale, causal, s);
    case 8: return launch_fwd_mma<16 * NJ, 8>(q, k, v, o, lse, BH, S, Dh, scale, causal, s);
    default: return launch_fwd_mma<16 * NJ, 0>(q, k, v, o, lse, BH, S, Dh, scale, causal, s);
  }
}

template <int NJ>
int fwd_mma_info(int S, int* out) {
  constexpr int W = 16 * NJ;
  const int threads = 32 * mma_warps(S);
  const size_t smem = fwd_mma_smem(S, W);
  switch (resident_units(S)) {
    case 4: return kernel_info(supertile_fwd_mma_kernel<W, 4>, smem, threads, out);
    case 8: return kernel_info(supertile_fwd_mma_kernel<W, 8>, smem, threads, out);
    default: return kernel_info(supertile_fwd_mma_kernel<W, 0>, smem, threads, out);
  }
}

#define DS_SUPERTILE_NJ_CASES(CALL) \
  case 1: return CALL(1);           \
  case 2: return CALL(2);           \
  case 3: return CALL(3);           \
  case 4: return CALL(4);           \
  case 5: return CALL(5);           \
  case 6: return CALL(6);           \
  case 7: return CALL(7);           \
  case 8: return CALL(8);

template <typename T>
int dispatch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int BH,
                 int S, int Dh, float scale, bool causal, cudaStream_t s) {
#define DS_FWD(NJ) launch_fwd<T, NJ>(q, k, v, o, lse, BH, S, Dh, scale, causal, s)
  switch ((Dh + 15) / 16) {
    DS_SUPERTILE_NJ_CASES(DS_FWD)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DS_FWD
}

int dispatch_fwd_mma(const void* q, const void* k, const void* v, void* o, void* lse, int BH,
                     int S, int Dh, float scale, bool causal, cudaStream_t s) {
#define DS_FWD(NJ) fwd_mma_by_seq<NJ>(q, k, v, o, lse, BH, S, Dh, scale, causal, s)
  switch ((Dh + 15) / 16) {
    DS_SUPERTILE_NJ_CASES(DS_FWD)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DS_FWD
}

int dispatch_bwd_f32(const void* q, const void* k, const void* v, const void* o,
                     const void* dout, const void* lse, void* dq, void* dk, void* dv,
                     void* scratch, int BH, int S, int Dh, float scale, bool causal,
                     cudaStream_t s) {
#define DS_BWD(NJ) \
  launch_bwd_f32<NJ>(q, k, v, o, dout, lse, dq, dk, dv, scratch, BH, S, Dh, scale, causal, s)
  switch ((Dh + 15) / 16) {
    DS_SUPERTILE_NJ_CASES(DS_BWD)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DS_BWD
}

int dispatch_bwd_mma(const void* q, const void* k, const void* v, const void* o,
                     const void* dout, const void* lse, void* dq, void* dk, void* dv, int BH,
                     int S, int Dh, float scale, bool causal, cudaStream_t s) {
#define DS_BWD(NJ) \
  launch_bwd_mma<16 * NJ>(q, k, v, o, dout, lse, dq, dk, dv, BH, S, Dh, scale, causal, s)
  switch ((Dh + 15) / 16) {
    DS_SUPERTILE_NJ_CASES(DS_BWD)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DS_BWD
}

bool bad_geometry(int BH, int S, int Dh) {
  return BH <= 0 || S < 8 || S >= kMaxSeq || S % 8 || Dh < 8 || Dh > kMaxDh || Dh % 8;
}

}  // namespace

extern "C" {

const char* ds_supertile_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, k, v, o: (BH, S, Dh) of dtype, contiguous; lse: (BH, S) fp32.
int ds_supertile_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int BH,
                     int S, int Dh, float scale, int causal, int dtype, void* stream) {
  if (bad_geometry(BH, S, Dh)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeF32) {
    return dispatch_fwd<float>(q, k, v, o, lse, BH, S, Dh, scale, causal != 0, s);
  }
  if (dtype == kDtypeBF16) {
    return dispatch_fwd_mma(q, k, v, o, lse, BH, S, Dh, scale, causal != 0, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// q, k, v, o, dout, dq, dk, dv: (BH, S, Dh) of dtype; lse: (BH, S) fp32
// from ds_supertile_fwd. bf16 takes no scratch (may be null); fp32 takes
// BH * S fp32 for delta, plus BH * S * Dh fp32 for dq when S > 64.
int ds_supertile_bwd(const void* q, const void* k, const void* v, const void* o,
                     const void* dout, const void* lse, void* dq, void* dk, void* dv,
                     void* scratch, int BH, int S, int Dh, float scale, int causal, int dtype,
                     void* stream) {
  if (bad_geometry(BH, S, Dh)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeF32) {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return dispatch_bwd_f32(q, k, v, o, dout, lse, dq, dk, dv, scratch, BH, S, Dh, scale,
                            causal != 0, s);
  }
  if (dtype == kDtypeBF16) {
    return dispatch_bwd_mma(q, k, v, o, dout, lse, dq, dk, dv, BH, S, Dh, scale, causal != 0,
                            s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The bf16 backward kernel a (BH, S, Dh) call launches, at that S's launch
// configuration: out gets 6 ints as ds_supertile_fwd_kernel_info's.
int ds_supertile_bwd_kernel_info(int S, int Dh, int* out) {
  if (bad_geometry(1, S, Dh)) return static_cast<int>(cudaErrorInvalidValue);
#define DS_INFO(NJ) bwd_mma_info<NJ>(S, out)
  switch ((Dh + 15) / 16) {
    DS_SUPERTILE_NJ_CASES(DS_INFO)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DS_INFO
}

// The bf16 forward kernel a (BH, S, Dh) call launches, at that S's launch
// configuration: out gets 6 ints (registers, static smem, dynamic smem,
// local bytes a thread, threads, blocks an SM).
int ds_supertile_fwd_kernel_info(int S, int Dh, int* out) {
  if (bad_geometry(1, S, Dh)) return static_cast<int>(cudaErrorInvalidValue);
#define DS_INFO(NJ) fwd_mma_info<NJ>(S, out)
  switch ((Dh + 15) / 16) {
    DS_SUPERTILE_NJ_CASES(DS_INFO)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DS_INFO
}

}  // extern "C"
