// Flash attention, forward and backward, for Hopper (sm_90a). Built by
// ops/op_builder.py with nvcc into a shared library that
// ops/flash_attention.py loads with ctypes; every entry point has a plain C
// interface, launches on the stream it is given, allocates nothing and
// returns cudaGetLastError() so the wrapper can raise on a refused launch.
//
// flash_fwd replaces both Pallas forwards of the reference: the
// static-unrolled whole-S kernel _fwd_kernel (deeperspeed_tpu/ops/pallas/
// flash_static.py, launched by _fwd) and the streaming kernel _fwd_kernel
// (ops/pallas/flash_attention.py, launched by _flash_fwd). flash_bwd
// replaces both backwards: flash_static.py's one-kernel _bwd_kernel
// (launched by _bwd) and flash_attention.py's _bwd_dkdv_kernel +
// _bwd_dq_kernel (launched by _flash_bwd). The two reference pairs compute
// the same function, causal or full softmax(Q K^T * scale) V with the fp32
// logsumexp saved for a flash-2 backward; they differ only in whether
// whole-S K and V fit the TPU's VMEM, which has no meaning here. So one
// forward and one backward take any S >= 1 (ragged S included) and
// Dh in {64, 96, 128}.
//
// What bounds them: at the training shape (2, 16, 1024, 128) causal the
// forward does ~8.6 GFLOP on ~34 MB, far above the H100's ~295 FLOP/byte
// ridge, so operations bound it. This first version is the simple, right
// one: CUDA-core fp32 FMAs over shared-memory tiles, not the tensor cores
// (wgmma with TMA-fed tile rings is later work), so it runs far above its
// bf16 tensor-core bound. The design still keeps what matters for
// correctness and memory out of device memory:
//  * one 256-thread block per (batch*head, 64-row tile); a loop over
//    64-row tiles of the other side replaces the TPU's sequential grid
//    axis, with the online-softmax state (m, l) and the accumulators in
//    registers, fp32. Nothing of size S x S ever reaches device memory.
//  * causal tiles above the diagonal are skipped, the straddling tile is
//    masked element by element, and the ragged last tile is masked
//    (rows or columns >= S load as zeros and count as masked).
//  * tiles are held in shared memory as fp32 with a row stride of Dh + 1,
//    so both the row walk (x[r][d], d varying) and the column walk
//    (x[c][d], c varying) are free of bank conflicts.
//  * rounding follows the reference: P is cast to the input dtype before
//    P V (flash_static.py:236) and dS before its two products
//    (flash_static.py:245); sums of P and all accumulators stay fp32.
//  * the backward is two launches, as the streaming reference's: dK/dV per
//    key tile (looping over query tiles) and dQ per query tile (looping
//    over key tiles), so no block ever adds into another block's output
//    and no atomics are needed. delta = rowsum(dO * O) comes in from the
//    caller (the reference computes it in XLA outside both kernels).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;
constexpr int kTile = 64;        // rows of a query tile and of a key tile
constexpr int kThreads = 256;    // a 16 x 16 grid of threads, 4 x 4 each
constexpr int kPLd = kTile + 1;  // row stride of the (64, 64) P / dS tiles
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF: finite, no NaN

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

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int DH>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int BH,
               int S, float scale, bool causal, cudaStream_t s) {
  constexpr size_t smem = fwd_smem<DH>();
  cudaError_t err = allow_smem(flash_fwd_kernel<T, DH>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kTile - 1) / kTile, BH);
  flash_fwd_kernel<T, DH><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), S, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DH>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dq, void* dk, void* dv, int BH,
               int S, float scale, bool causal, cudaStream_t s) {
  const dim3 grid((S + kTile - 1) / kTile, BH);
  constexpr size_t smem_kv = dkdv_smem<DH>();
  cudaError_t err = allow_smem(flash_bwd_dkdv_kernel<T, DH>, smem_kv);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_kernel<T, DH><<<grid, kThreads, smem_kv, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), S, scale,
      causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr size_t smem_q = dq_smem<DH>();
  err = allow_smem(flash_bwd_dq_kernel<T, DH>, smem_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<T, DH><<<grid, kThreads, smem_q, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), S, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_fwd(int dh, const void* q, const void* k, const void* v, void* o, void* lse,
                 int BH, int S, float scale, bool causal, cudaStream_t s) {
  switch (dh) {
    case 64: return launch_fwd<T, 64>(q, k, v, o, lse, BH, S, scale, causal, s);
    case 96: return launch_fwd<T, 96>(q, k, v, o, lse, BH, S, scale, causal, s);
    case 128: return launch_fwd<T, 128>(q, k, v, o, lse, BH, S, scale, causal, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch_bwd(int dh, const void* q, const void* k, const void* v, const void* dout,
                 const void* lse, const void* delta, void* dq, void* dk, void* dv, int BH,
                 int S, float scale, bool causal, cudaStream_t s) {
  switch (dh) {
    case 64:
      return launch_bwd<T, 64>(q, k, v, dout, lse, delta, dq, dk, dv, BH, S, scale, causal, s);
    case 96:
      return launch_bwd<T, 96>(q, k, v, dout, lse, delta, dq, dk, dv, BH, S, scale, causal, s);
    case 128:
      return launch_bwd<T, 128>(q, k, v, dout, lse, delta, dq, dk, dv, BH, S, scale, causal,
                                s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool bad_geometry(int BH, int S) { return BH <= 0 || BH > 65535 || S <= 0; }

}  // namespace

extern "C" {

const char* ds_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, k, v, o: (BH, S, Dh) of dtype, contiguous; lse: (BH, S) fp32.
int ds_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int BH,
                 int S, int Dh, float scale, int causal, int dtype, void* stream) {
  if (bad_geometry(BH, S)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeF32) {
    return dispatch_fwd<float>(Dh, q, k, v, o, lse, BH, S, scale, causal != 0, s);
  }
  if (dtype == kDtypeBF16) {
    return dispatch_fwd<__nv_bfloat16>(Dh, q, k, v, o, lse, BH, S, scale, causal != 0, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// q, k, v, dout, dq, dk, dv: (BH, S, Dh) of dtype; lse, delta: (BH, S) fp32.
int ds_flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                 const void* lse, const void* delta, void* dq, void* dk, void* dv, int BH,
                 int S, int Dh, float scale, int causal, int dtype, void* stream) {
  if (bad_geometry(BH, S)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeF32) {
    return dispatch_bwd<float>(Dh, q, k, v, dout, lse, delta, dq, dk, dv, BH, S, scale,
                               causal != 0, s);
  }
  if (dtype == kDtypeBF16) {
    return dispatch_bwd<__nv_bfloat16>(Dh, q, k, v, dout, lse, delta, dq, dk, dv, BH, S,
                                       scale, causal != 0, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
