// Fused elementwise kernels for Hopper (sm_90a): LayerNorm, residual-add
// LayerNorm and bias+GeLU, forward and backward. Built by ops/op_builder.py with nvcc into a shared library that
// ops/fused_blocks.py loads with ctypes; every entry point below has a plain C
// interface, launches on the stream it is given, allocates nothing and
// returns cudaGetLastError() so the wrapper can raise on a refused launch.
//
// ln_fwd replaces the Pallas kernel _ln_fwd_kernel
// (deeperspeed_tpu/ops/pallas/fused_blocks.py, launched by _ln_fwd_call).
// bias_gelu_fwd replaces _bg_fwd_kernel (same file, launched by _bg).
// ln_bwd replaces _ln_bwd_kernel (launched by _ln_vjp_bwd) and
// bias_gelu_bwd replaces _bg_bwd_kernel (launched by _bg_vjp_bwd).
// add_ln_fwd replaces _aln_fwd_kernel (launched by _aln_fwd_call) and
// add_ln_bwd replaces _aln_bwd_kernel (launched by _aln_vjp_bwd): the BERT
// post-LN add&norm y = LN(x + r) * w + b. They are the LN kernels with the
// residual added on load (the ln kernels' template flag kAdd): both inputs
// are cast to fp32 before the add, where the reference rounds the sum, and
// the backward recomputes s = x + r from x and r rather than storing s. Its
// one output ds is the cotangent of both x and r. Add-LN moves 2 * R * D
// input elements where LN moves R * D, and is bound by those bytes the same
// way (at the BERT-large shape (8192, 1024) bf16: ~50 MB forward, ~15 us,
// and ~67 MB backward, ~20 us at 3.35 TB/s).
//
// All four are bound by device-memory bytes, not arithmetic: LayerNorm reads x
// once and writes y once (plus 8 bytes of statistics per row and the 2*D
// fp32 weights), bias+GeLU reads x once and writes y once. Their least time
// on an H100 SXM is those bytes over 3.35 TB/s. The designs keep every
// intermediate out of device memory:
//  * ln_fwd runs one 256-thread block per row. The block makes three passes
//    over its row (mean, variance of x - mean, normalize); only the first
//    pass reads device memory, the later ones hit L1/L2, since a row of
//    D = 2048 bf16 values is 4 KB. Statistics are fp32 and biased, over the
//    last axis, and the variance is mean((x - mu)^2), as in the reference.
//  * bias_gelu_fwd is one grid-stride elementwise pass in fp32, cast once.
// Ragged edges need no masking beyond the loop bounds: a block owns a whole
// row, and the grid-stride loop stops at n.
//
// The backwards read x, the cotangent g and (LN) the fp32 mean/rstd that
// ln_fwd wrote, and write dx once. Their weight/bias gradients are sums over
// rows, and Hopper's blocks run in no order, so each block of the first
// launch walks a strided set of rows and keeps column partials of its own
// (every column owned by one thread: no atomics, no races); it writes one
// fp32 partial row per block, and a second launch adds those rows per
// column in a fixed order. The result is the same bits from run to run.
//
// ln_bwd / add_ln_bwd (one template, kAdd) take the rows route wherever a
// row is whole 16-byte vectors (D % 8 bf16, D % 4 fp32, aligned) of at most
// 1024 of them (D 8192 bf16, 4096 fp32), which holds every width the
// models use:
//  * a team of WPR warps (WPR = 1, 2, 4, 8, the fewest whose lanes hold the
//    row in NV = 2 vectors each, or 8 warps of 4 vectors) owns a row at a
//    time; 16 / WPR teams a 512-thread block (8 / WPR of 256 threads at NV
//    4), one block an SM, the grid persistent, rows strided over the teams.
//    One block an SM halves the partial rows (below) against two smaller
//    ones: at the GPT shape (2048, 2048) those cost a third of the
//    kernel's own bytes at two 256-thread blocks an SM.
//  * a lane reads its vectors of x (and r), g once, 16 bytes a load, into
//    registers, and forms xhat and dy = g * w once, kept for dx; the next
//    row's loads then go into the same registers and fly while this row's
//    sums, barrier and dx run. w sits in shared memory.
//    c1 = mean(dy) and c2 = mean(dy * xhat) are warp-shuffle sums, added
//    across the team's warps through shared memory after one named barrier
//    (bar.sync over the team's threads, slots alternating by row) when
//    WPR > 1; no __syncthreads runs in the row loop. dx is written once,
//    16 bytes a store.
//  * the column partials of g * xhat and g stay in registers over the rows;
//    at the end the block's teams add them in a fixed tree through shared
//    memory (16-byte words, no bank conflicts) and write one partial row
//    of each.
//  * ln_bwd_reduce_kernel then sums the partial rows per column: 8 columns
//    x 32 row groups a block, 2 * ceil(D / 8) blocks (512 at D 2048), the 32
//    group sums added in a fixed tree. It replaces the two launches of
//    sum_partials_kernel, whose D / 256 blocks each walked all partial rows
//    in series (8 blocks at D 2048).
// Other widths (unaligned rows, D not a multiple of the vector, or wider)
// take the wide route: the first port's block-per-row kernel (ln_bwd_kernel,
// partials in shared memory, x and g re-read from L1/L2 for dx) with the
// same reduction. bias_gelu_bwd keeps sum_partials_kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "kernel_info.cuh"

namespace {

constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;
constexpr int kLnThreads = 256;
constexpr int kEwThreads = 256;
constexpr int kEwMaxBlocks = 132 * 32;  // 32 blocks per SM on the H100's 132
constexpr int kBwdBlocks = 132 * 2;     // row-walking backward blocks
constexpr int kSmemDefault = 48 * 1024;  // shared memory a block has without opt-in
constexpr int kStaticSmemMax = 1152;     // the most static shared memory of a kernel here

constexpr float kSqrt2OverPi = 0.7978845608028654f;
constexpr float kGeluC = 0.044715f;
constexpr float kInvSqrt2 = 0.7071067811865476f;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum of v over the block, returned to every thread. red holds 33 floats.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < nwarps ? red[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) red[32] = t;
  }
  __syncthreads();
  const float total = red[32];
  __syncthreads();  // red may be reused by the next call
  return total;
}

// x[i], or x[i] + r[i] in fp32 when kAdd (the residual-add LayerNorm)
template <bool kAdd, typename T>
__device__ __forceinline__ float load_in(const T* __restrict__ x,
                                         const T* __restrict__ r, long long i) {
  if (kAdd) return to_f32(x[i]) + to_f32(r[i]);
  return to_f32(x[i]);
}

template <typename T, bool kAdd>
__global__ void __launch_bounds__(kLnThreads)
    ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ r,
                  const float* __restrict__ w, const float* __restrict__ b,
                  T* __restrict__ y, float* __restrict__ mean,
                  float* __restrict__ rstd, int D, float eps) {
  __shared__ float red[33];
  const long long row = blockIdx.x;
  const T* xr = x + row * D;
  const T* rr = kAdd ? r + row * D : nullptr;
  T* yr = y + row * D;
  const float inv_d = 1.f / static_cast<float>(D);

  float s = 0.f;
  for (int i = threadIdx.x; i < D; i += blockDim.x) s += load_in<kAdd>(xr, rr, i);
  const float mu = block_sum(s, red) * inv_d;

  float ss = 0.f;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float d = load_in<kAdd>(xr, rr, i) - mu;
    ss += d * d;
  }
  const float rs = rsqrtf(block_sum(ss, red) * inv_d + eps);

  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    yr[i] = from_f32<T>((load_in<kAdd>(xr, rr, i) - mu) * rs * w[i] + b[i]);
  }
  if (threadIdx.x == 0) {
    mean[row] = mu;
    rstd[row] = rs;
  }
}

__device__ __forceinline__ float gelu_f32(float u, bool approximate) {
  if (approximate) {
    const float inner = kSqrt2OverPi * (u + kGeluC * u * u * u);
    return 0.5f * u * (1.f + tanhf(inner));
  }
  return 0.5f * u * (1.f + erff(u * kInvSqrt2));
}

template <typename T, typename B>
__global__ void __launch_bounds__(kEwThreads)
    bias_gelu_fwd_kernel(const T* __restrict__ x, const B* __restrict__ b,
                         T* __restrict__ y, long long n, int F,
                         bool approximate) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float u = to_f32(x[i]) + to_f32(b[i % F]);
    y[i] = from_f32<T>(gelu_f32(u, approximate));
  }
}

template <typename T, typename B>
void launch_bias_gelu(const void* x, const void* b, void* y, long long n, int F,
                      bool approximate, cudaStream_t stream) {
  long long blocks = (n + kEwThreads - 1) / kEwThreads;
  if (blocks > kEwMaxBlocks) blocks = kEwMaxBlocks;
  bias_gelu_fwd_kernel<T, B><<<static_cast<unsigned>(blocks), kEwThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const B*>(b), static_cast<T*>(y), n, F,
      approximate);
}

// dx = rs * (dy - mean(dy) - xhat * mean(dy * xhat)) with dy = g * w, as the
// reference's _ln_dx; dw/db partials of sum(g * xhat) and sum(g) per block.
// With kAdd the normalized input is s = x + r, recomputed here.
template <typename T, bool kAdd>
__global__ void __launch_bounds__(kLnThreads)
    ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ r,
                  const float* __restrict__ w,
                  const float* __restrict__ mean, const float* __restrict__ rstd,
                  const T* __restrict__ g, T* __restrict__ dx,
                  float* __restrict__ dw_part, float* __restrict__ db_part,
                  long long R, int D) {
  extern __shared__ float acc[];  // dw partials [D], then db partials [D]
  __shared__ float red[33];
  float* dw_acc = acc;
  float* db_acc = acc + D;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    dw_acc[i] = 0.f;
    db_acc[i] = 0.f;
  }
  const float inv_d = 1.f / static_cast<float>(D);
  // every thread of the block runs the same rows, so block_sum's barriers
  // are reached by all of them
  for (long long row = blockIdx.x; row < R; row += gridDim.x) {
    const T* xr = x + row * D;
    const T* rr = kAdd ? r + row * D : nullptr;
    const T* gr = g + row * D;
    T* dxr = dx + row * D;
    const float mu = mean[row];
    const float rs = rstd[row];
    float s1 = 0.f, s2 = 0.f;
    for (int i = threadIdx.x; i < D; i += blockDim.x) {
      const float xh = (load_in<kAdd>(xr, rr, i) - mu) * rs;
      const float gi = to_f32(gr[i]);
      const float dy = gi * w[i];
      s1 += dy;
      s2 += dy * xh;
      dw_acc[i] += gi * xh;
      db_acc[i] += gi;
    }
    const float c1 = block_sum(s1, red) * inv_d;
    const float c2 = block_sum(s2, red) * inv_d;
    for (int i = threadIdx.x; i < D; i += blockDim.x) {
      const float xh = (load_in<kAdd>(xr, rr, i) - mu) * rs;
      const float dy = to_f32(gr[i]) * w[i];
      dxr[i] = from_f32<T>(rs * (dy - c1 - xh * c2));
    }
  }
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    dw_part[static_cast<long long>(blockIdx.x) * D + i] = dw_acc[i];
    db_part[static_cast<long long>(blockIdx.x) * D + i] = db_acc[i];
  }
}

__device__ __forceinline__ float gelu_grad_f32(float u, bool approximate) {
  if (approximate) {
    const float inner = kSqrt2OverPi * (u + kGeluC * u * u * u);
    const float t = tanhf(inner);
    const float dinner = kSqrt2OverPi * (1.f + 3.f * kGeluC * u * u);
    return 0.5f * (1.f + t) + 0.5f * u * (1.f - t * t) * dinner;
  }
  const float phi = 0.5f * (1.f + erff(u * kInvSqrt2));
  return phi + u * expf(-0.5f * u * u) * kInvSqrt2Pi;
}

// dx = g * gelu'(x + b) in fp32, cast once; db partials of sum(dx) per block.
template <typename T, typename B>
__global__ void __launch_bounds__(kEwThreads)
    bias_gelu_bwd_kernel(const T* __restrict__ x, const B* __restrict__ b,
                         const T* __restrict__ g, T* __restrict__ dx,
                         float* __restrict__ db_part, long long R, int F,
                         bool approximate) {
  extern __shared__ float db_acc[];  // [F]
  for (int i = threadIdx.x; i < F; i += blockDim.x) db_acc[i] = 0.f;
  for (long long row = blockIdx.x; row < R; row += gridDim.x) {
    const long long base = row * F;
    for (int i = threadIdx.x; i < F; i += blockDim.x) {
      const float u = to_f32(x[base + i]) + to_f32(b[i]);
      const float d = to_f32(g[base + i]) * gelu_grad_f32(u, approximate);
      dx[base + i] = from_f32<T>(d);
      db_acc[i] += d;
    }
  }
  for (int i = threadIdx.x; i < F; i += blockDim.x) {
    db_part[static_cast<long long>(blockIdx.x) * F + i] = db_acc[i];
  }
}

// out[i] = sum over p of part[p, i], p in order: the second pass of
// bias_gelu_bwd's reduction.
__global__ void __launch_bounds__(kEwThreads)
    sum_partials_kernel(const float* __restrict__ part, int nparts, int D,
                        float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= D) return;
  float s = 0.f;
  for (int p = 0; p < nparts; ++p) s += part[static_cast<long long>(p) * D + i];
  out[i] = s;
}

// ------------------------------------------------------------------ //
// LayerNorm backward, rows route
// ------------------------------------------------------------------ //

// a 16-byte vector of T as fp32 values, and back (rounded to nearest even)
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& u, float (&f)[N]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ __forceinline__ static uint4 pack(const float (&f)[N]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(const uint4& u, float (&f)[N]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 h;
      *reinterpret_cast<uint32_t*>(&h) = w[i];
      const float2 p = __bfloat1622float2(h);
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  __device__ __forceinline__ static uint4 pack(const float (&f)[N]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// threads of a rows-route block: 16 warps at 2 vectors a lane (at most 128
// registers a thread), 8 at 4; one block an SM either way, so the grid
// writes one partial row per SM
__host__ __device__ constexpr int rows_threads(int nv) { return nv <= 2 ? 512 : 256; }

// a barrier over the nthreads threads of a team (named barrier id >= 1)
__device__ __forceinline__ void team_sync(int id, int nthreads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(nthreads) : "memory");
}

// a row's vectors of x (and r) and g, 16-byte loads; lanes past the row
// load nothing
template <typename T, bool kAdd, int NV, int TPR>
__device__ __forceinline__ void load_row(const T* __restrict__ x, const T* __restrict__ r,
                                         const T* __restrict__ g, long long off, int nvec, int tt,
                                         uint4 (&xv)[NV], uint4 (&rv)[NV], uint4 (&gv)[NV]) {
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int j = v * TPR + tt;
    if (j < nvec) {
      xv[v] = __ldg(reinterpret_cast<const uint4*>(x + off) + j);
      if (kAdd) rv[v] = __ldg(reinterpret_cast<const uint4*>(r + off) + j);
      gv[v] = __ldg(reinterpret_cast<const uint4*>(g + off) + j);
    }
  }
}

// dx of rows strided over the grid's teams of WPR warps and one partial row
// of dw and db per block (part: [2][gridDim.x][D]); see the file comment.
template <typename T, bool kAdd, int WPR, int NV>
__global__ void __launch_bounds__(rows_threads(NV), 1)
    ln_bwd_rows_kernel(const T* __restrict__ x, const T* __restrict__ r,
                       const float* __restrict__ w, const float* __restrict__ mean,
                       const float* __restrict__ rstd, const T* __restrict__ g,
                       T* __restrict__ dx, float* __restrict__ part, long long R, int D) {
  using V = Vec<T>;
  constexpr int VEC = V::N;
  constexpr int TPR = 32 * WPR;
  constexpr int NT = rows_threads(NV);
  constexpr int TEAMS = NT / TPR;
  extern __shared__ __align__(16) float smem[];  // w, then the teams' tree
  float* w_s = smem;
  float* cols = smem + (D + 3) / 4 * 4;
  __shared__ float red[2][TEAMS][WPR][2];  // the team's warp sums, by row parity
  const int team = threadIdx.x / TPR;
  const int tt = threadIdx.x - team * TPR;
  const int lane = threadIdx.x & 31;
  const int nvec = D / VEC;
  const float inv_d = 1.f / static_cast<float>(D);
  const long long stride = static_cast<long long>(gridDim.x) * TEAMS;
  long long row = static_cast<long long>(blockIdx.x) * TEAMS + team;
  uint4 xv[NV], rv[NV], gv[NV];
  float mu = 0.f, rs = 0.f;
  if (row < R) {
    load_row<T, kAdd, NV, TPR>(x, r, g, row * D, nvec, tt, xv, rv, gv);
    mu = mean[row];
    rs = rstd[row];
  }
  for (int i = threadIdx.x; i < D; i += NT) w_s[i] = w[i];
  float dwp[NV][VEC], dbp[NV][VEC];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) dwp[v][e] = dbp[v][e] = 0.f;
  }
  __syncthreads();  // w_s
  int parity = 0;
  for (; row < R; row += stride) {
    // xhat and dy = g * w of the lane's elements, kept for dx
    float xh[NV][VEC], dy[NV][VEC];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int j = v * TPR + tt;
      if (j < nvec) {
        float gf[VEC];
        V::unpack(xv[v], xh[v]);
        if (kAdd) {
          float rf[VEC];
          V::unpack(rv[v], rf);
#pragma unroll
          for (int e = 0; e < VEC; ++e) xh[v][e] += rf[e];
        }
        V::unpack(gv[v], gf);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          xh[v][e] = (xh[v][e] - mu) * rs;
          dy[v][e] = gf[e] * w_s[j * VEC + e];
          s1 += dy[v][e];
          s2 += dy[v][e] * xh[v][e];
          dwp[v][e] += gf[e] * xh[v][e];
          dbp[v][e] += gf[e];
        }
      }
    }
    // the next row's loads, into the registers this row no longer needs:
    // they fly while this row's sums, barrier and dx run
    const long long next = row + stride;
    float mu_n = 0.f, rs_n = 0.f;
    if (next < R) {
      load_row<T, kAdd, NV, TPR>(x, r, g, next * D, nvec, tt, xv, rv, gv);
      mu_n = mean[next];
      rs_n = rstd[next];
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if constexpr (WPR > 1) {
      if (lane == 0) {
        red[parity][team][tt >> 5][0] = s1;
        red[parity][team][tt >> 5][1] = s2;
      }
      team_sync(1 + team, TPR);
      s1 = s2 = 0.f;
#pragma unroll
      for (int i = 0; i < WPR; ++i) {
        s1 += red[parity][team][i][0];
        s2 += red[parity][team][i][1];
      }
      parity ^= 1;
    }
    const float c1 = s1 * inv_d;
    const float c2 = s2 * inv_d;
    const long long off = row * D;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int j = v * TPR + tt;
      if (j < nvec) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) dy[v][e] = rs * (dy[v][e] - c1 - xh[v][e] * c2);
        reinterpret_cast<uint4*>(dx + off)[j] = V::pack(dy[v]);
      }
    }
    mu = mu_n;
    rs = rs_n;
  }
  // the teams' column partials, added in a fixed tree: teams [h, 2h) put
  // theirs in slots [0, h), teams [0, h) add them. A slot holds a team's
  // 2 NV VEC / 4 float4 words of each thread as [word][thread in the
  // team], so a warp's words are consecutive (no bank conflicts) and the
  // adding thread, the writer's counterpart, finds its own columns.
  constexpr int WORDS = 2 * NV * VEC / 4;
#pragma unroll
  for (int half = TEAMS / 2; half >= 1; half >>= 1) {
    if (team >= half && team < 2 * half) {
      float4* slot =
          reinterpret_cast<float4*>(cols) + static_cast<size_t>(team - half) * WORDS * TPR;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
#pragma unroll
        for (int q = 0; q < VEC / 4; ++q) {
          const int k = v * VEC / 4 + q;
          slot[k * TPR + tt] = make_float4(dwp[v][4 * q], dwp[v][4 * q + 1], dwp[v][4 * q + 2],
                                           dwp[v][4 * q + 3]);
          slot[(WORDS / 2 + k) * TPR + tt] = make_float4(dbp[v][4 * q], dbp[v][4 * q + 1],
                                                         dbp[v][4 * q + 2], dbp[v][4 * q + 3]);
        }
      }
    }
    __syncthreads();
    if (team < half) {
      const float4* slot =
          reinterpret_cast<const float4*>(cols) + static_cast<size_t>(team) * WORDS * TPR;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
#pragma unroll
        for (int q = 0; q < VEC / 4; ++q) {
          const int k = v * VEC / 4 + q;
          const float4 a = slot[k * TPR + tt];
          const float4 c = slot[(WORDS / 2 + k) * TPR + tt];
          dwp[v][4 * q] += a.x;
          dwp[v][4 * q + 1] += a.y;
          dwp[v][4 * q + 2] += a.z;
          dwp[v][4 * q + 3] += a.w;
          dbp[v][4 * q] += c.x;
          dbp[v][4 * q + 1] += c.y;
          dbp[v][4 * q + 2] += c.z;
          dbp[v][4 * q + 3] += c.w;
        }
      }
    }
    __syncthreads();
  }
  if (team == 0) {
    float* dw_row = part + static_cast<long long>(blockIdx.x) * D;
    float* db_row = dw_row + static_cast<long long>(gridDim.x) * D;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int j = v * TPR + tt;
      if (j < nvec) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          dw_row[j * VEC + e] = dwp[v][e];
          db_row[j * VEC + e] = dbp[v][e];
        }
      }
    }
  }
}

constexpr int kRedCols = 8;   // columns of an ln_bwd_reduce_kernel block
constexpr int kRedGroups = kEwThreads / kRedCols;  // its row groups

// dw (blockIdx.y 0) or db (1) of the LN backwards from part ([2][nparts][D]):
// thread (group p, column c) adds partial rows p, p + 32, ... of its column,
// then a fixed tree adds the 32 group sums, so the bits do not depend on
// which block ran first. kAdd changes nothing but the name, so that a
// profile counts add_ln_bwd's reduction apart from ln_bwd's.
template <bool kAdd>
__global__ void __launch_bounds__(kEwThreads)
    ln_bwd_reduce_kernel(const float* __restrict__ part, int nparts, int D,
                         float* __restrict__ dw, float* __restrict__ db) {
  __shared__ float red[kRedGroups][kRedCols + 1];
  const int c = threadIdx.x % kRedCols;
  const int p0 = threadIdx.x / kRedCols;
  const int col = blockIdx.x * kRedCols + c;
  const float* src = part + static_cast<long long>(blockIdx.y) * nparts * D;
  float s = 0.f;
  if (col < D) {
#pragma unroll 4
    for (int p = p0; p < nparts; p += kRedGroups) s += src[static_cast<long long>(p) * D + col];
  }
  red[p0][c] = s;
  __syncthreads();
#pragma unroll
  for (int half = kRedGroups / 2; half > 0; half >>= 1) {
    if (p0 < half) red[p0][c] += red[p0 + half][c];
    __syncthreads();
  }
  if (p0 == 0 && col < D) (blockIdx.y == 0 ? dw : db)[col] = red[0][c];
}

int bwd_blocks(long long R) { return static_cast<int>(R < kBwdBlocks ? R : kBwdBlocks); }

// Opts a kernel in to ``bytes`` of dynamic shared memory where the default
// 48 KB might not hold them beside its static shared memory (at most 1152
// bytes here), which counts against the same limit.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes + kStaticSmemMax <= static_cast<size_t>(kSmemDefault)) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// the rows route's (warps a row, vectors a lane) pairs
#define DS_LN_ROWS_CASES(CALL) \
  CALL(1, 2)                   \
  CALL(2, 2)                   \
  CALL(4, 2)                   \
  CALL(8, 2)                   \
  CALL(8, 4)

template <typename T, bool kAdd, int WPR, int NV>
size_t ln_rows_smem(int D) {  // w (to a 16-byte boundary), then the teams' tree
  const size_t teams = rows_threads(NV) / (32 * WPR);
  return static_cast<size_t>((D + 3) / 4 * 4) * sizeof(float) +
         teams / 2 * 2 * NV * Vec<T>::N * (32 * WPR) * sizeof(float);
}

template <typename T, bool kAdd, int WPR, int NV>
cudaError_t launch_ln_bwd_rows(const T* x, const T* r, const float* w, const float* mean,
                               const float* rstd, const T* g, T* dx, float* part, int nparts,
                               long long R, int D, cudaStream_t s) {
  const size_t smem = ln_rows_smem<T, kAdd, WPR, NV>(D);
  cudaError_t err = allow_smem(ln_bwd_rows_kernel<T, kAdd, WPR, NV>, smem);
  if (err != cudaSuccess) return err;
  ln_bwd_rows_kernel<T, kAdd, WPR, NV><<<nparts, rows_threads(NV), smem, s>>>(
      x, r, w, mean, rstd, g, dx, part, R, D);
  return cudaGetLastError();
}

// wpr 0: the wide route, else the rows route with (wpr, nv); then the
// reduction of the nparts partial rows into dw and db
template <typename T, bool kAdd>
int launch_ln_bwd(const void* x, const void* r, const void* w, const void* mean,
                  const void* rstd, const void* g, void* dx, void* dw, void* db, void* part,
                  int nparts, int wpr, int nv, long long R, int D, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(r);
  const float* wf = static_cast<const float*>(w);
  const float* mf = static_cast<const float*>(mean);
  const float* sf = static_cast<const float*>(rstd);
  const T* gt = static_cast<const T*>(g);
  T* dxt = static_cast<T*>(dx);
  float* pf = static_cast<float*>(part);
  cudaError_t err = cudaErrorInvalidValue;
  if (wpr == 0) {
    const size_t smem = 2 * static_cast<size_t>(D) * sizeof(float);
    err = allow_smem(ln_bwd_kernel<T, kAdd>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ln_bwd_kernel<T, kAdd><<<nparts, kLnThreads, smem, s>>>(
        xt, rt, wf, mf, sf, gt, dxt, pf, pf + static_cast<long long>(nparts) * D, R, D);
    err = cudaGetLastError();
  }
#define DS_LN_ROWS(WPR, NV)                                                                   \
  else if (wpr == WPR && nv == NV) {                                                          \
    err = launch_ln_bwd_rows<T, kAdd, WPR, NV>(xt, rt, wf, mf, sf, gt, dxt, pf, nparts, R, D, \
                                               s);                                           \
  }
  DS_LN_ROWS_CASES(DS_LN_ROWS)
#undef DS_LN_ROWS
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((D + kRedCols - 1) / kRedCols, 2);
  ln_bwd_reduce_kernel<kAdd><<<grid, kEwThreads, 0, s>>>(pf, nparts, D, static_cast<float*>(dw),
                                                         static_cast<float*>(db));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kAdd>
int ln_bwd_info(int wpr, int nv, int D, int* out) {
  if (wpr == 0) {
    return kernel_info(ln_bwd_kernel<T, kAdd>, 2 * static_cast<size_t>(D) * sizeof(float),
                       kLnThreads, out);
  }
#define DS_LN_INFO(WPR, NV)                                                              \
  if (wpr == WPR && nv == NV) {                                                          \
    return kernel_info(ln_bwd_rows_kernel<T, kAdd, WPR, NV>,                             \
                       ln_rows_smem<T, kAdd, WPR, NV>(D), rows_threads(NV), out);        \
  }
  DS_LN_ROWS_CASES(DS_LN_INFO)
#undef DS_LN_INFO
  return static_cast<int>(cudaErrorInvalidValue);
}

// whether (wpr, nv) is a rows-route pair that holds a row of D values of
// itemsize bytes, or wpr == 0 (the wide route) with its partials in shared
// memory
bool ln_bwd_config_ok(int wpr, int nv, long long D, int itemsize) {
  if (wpr == 0) return 2 * D * static_cast<long long>(sizeof(float)) <= 232448;
  const int vec = 16 / itemsize;
  bool known = false;
#define DS_LN_KNOWN(WPR, NV) known = known || (wpr == WPR && nv == NV);
  DS_LN_ROWS_CASES(DS_LN_KNOWN)
#undef DS_LN_KNOWN
  return known && D % vec == 0 && D / vec <= 32LL * wpr * nv;
}

bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

template <typename T, typename B>
int launch_bias_gelu_bwd(const void* x, const void* b, const void* g, void* dx,
                         void* db, void* part, long long R, int F, bool approximate,
                         cudaStream_t s) {
  const int nb = bwd_blocks(R);
  const size_t smem = static_cast<size_t>(F) * sizeof(float);
  cudaError_t err = allow_smem(bias_gelu_bwd_kernel<T, B>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  bias_gelu_bwd_kernel<T, B><<<nb, kEwThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const B*>(b), static_cast<const T*>(g),
      static_cast<T*>(dx), static_cast<float*>(part), R, F, approximate);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_partials_kernel<<<(F + kEwThreads - 1) / kEwThreads, kEwThreads, 0, s>>>(
      static_cast<const float*>(part), nb, F, static_cast<float*>(db));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* ds_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x, y (and r when given): (R, D) of dtype; w, b: (D,) fp32; mean, rstd:
// (R,) fp32. r == nullptr is LayerNorm of x, else LayerNorm of x + r.
int ds_ln_fwd(const void* x, const void* r, const void* w, const void* b, void* y,
              void* mean, void* rstd, long long R, int D, float eps, int dtype,
              void* stream) {
  if (R <= 0 || R > 0x7fffffffLL || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(R));
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  float* mf = static_cast<float*>(mean);
  float* rf = static_cast<float*>(rstd);
  if (dtype == kDtypeF32) {
    const float* xf = static_cast<const float*>(x);
    const float* rr = static_cast<const float*>(r);
    float* yf = static_cast<float*>(y);
    if (r) {
      ln_fwd_kernel<float, true><<<grid, kLnThreads, 0, s>>>(xf, rr, wf, bf, yf, mf, rf, D, eps);
    } else {
      ln_fwd_kernel<float, false><<<grid, kLnThreads, 0, s>>>(xf, rr, wf, bf, yf, mf, rf, D, eps);
    }
  } else if (dtype == kDtypeBF16) {
    const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
    const __nv_bfloat16* rb = static_cast<const __nv_bfloat16*>(r);
    __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(y);
    if (r) {
      ln_fwd_kernel<__nv_bfloat16, true><<<grid, kLnThreads, 0, s>>>(xb, rb, wf, bf, yb, mf, rf,
                                                                     D, eps);
    } else {
      ln_fwd_kernel<__nv_bfloat16, false><<<grid, kLnThreads, 0, s>>>(xb, rb, wf, bf, yb, mf,
                                                                      rf, D, eps);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// x, y: n = R * F elements of x_dtype, row-major with F columns; b: (F,) of
// b_dtype (fp32 or x_dtype).
int ds_bias_gelu_fwd(const void* x, const void* b, void* y, long long n, int F,
                     int approximate, int x_dtype, int b_dtype, void* stream) {
  if (n <= 0 || F <= 0 || n % F) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool approx = approximate != 0;
  if (x_dtype == kDtypeF32 && b_dtype == kDtypeF32) {
    launch_bias_gelu<float, float>(x, b, y, n, F, approx, s);
  } else if (x_dtype == kDtypeBF16 && b_dtype == kDtypeBF16) {
    launch_bias_gelu<__nv_bfloat16, __nv_bfloat16>(x, b, y, n, F, approx, s);
  } else if (x_dtype == kDtypeBF16 && b_dtype == kDtypeF32) {
    launch_bias_gelu<__nv_bfloat16, float>(x, b, y, n, F, approx, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Number of partial rows bias_gelu_bwd writes into its scratch: the
// wrapper allocates ds_bwd_blocks(R) * F fp32 values.
int ds_bwd_blocks(long long R) { return R > 0 ? bwd_blocks(R) : 0; }

// x, g, dx (and r when given): (R, D) of dtype; w: (D,) fp32; mean, rstd:
// (R,) fp32 from ds_ln_fwd; dw, db: (D,) fp32; part: 2 * nparts * D fp32
// scratch. r == nullptr is the LayerNorm backward, else the residual-add
// LayerNorm's, whose dx is the cotangent of both x and r. wpr, nv: the
// rows route's warps a row and vectors a lane (ops/fused_blocks.py's
// ln_bwd_plan), or wpr 0 for the wide route; nparts: the first launch's
// blocks (each writes one partial row of dw and of db).
int ds_ln_bwd(const void* x, const void* r, const void* w, const void* mean,
              const void* rstd, const void* g, void* dx, void* dw, void* db, void* part,
              long long R, int D, int dtype, int wpr, int nv, int nparts, void* stream) {
  if (R <= 0 || D <= 0 || nparts <= 0 || (dtype != kDtypeF32 && dtype != kDtypeBF16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int itemsize = dtype == kDtypeF32 ? 4 : 2;
  if (!ln_bwd_config_ok(wpr, nv, D, itemsize)) return static_cast<int>(cudaErrorInvalidValue);
  if (wpr != 0 &&
      (misaligned(x) || misaligned(g) || misaligned(dx) || (r != nullptr && misaligned(r)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DS_LN_BWD(T, ADD) \
  launch_ln_bwd<T, ADD>(x, r, w, mean, rstd, g, dx, dw, db, part, nparts, wpr, nv, R, D, s)
  if (dtype == kDtypeF32) return r ? DS_LN_BWD(float, true) : DS_LN_BWD(float, false);
  return r ? DS_LN_BWD(__nv_bfloat16, true) : DS_LN_BWD(__nv_bfloat16, false);
#undef DS_LN_BWD
}

// The first kernel a ds_ln_bwd call with (wpr, nv) at width D launches
// (add != 0: add_ln_bwd's), at its launch configuration: out gets 6 ints
// (registers, static smem, dynamic smem, local bytes a thread, threads,
// blocks an SM).
int ds_ln_bwd_kernel_info(int wpr, int nv, int D, int dtype, int add, int* out) {
  if (D <= 0 || (dtype != kDtypeF32 && dtype != kDtypeBF16) ||
      !ln_bwd_config_ok(wpr, nv, D, dtype == kDtypeF32 ? 4 : 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == kDtypeF32) {
    return add ? ln_bwd_info<float, true>(wpr, nv, D, out)
               : ln_bwd_info<float, false>(wpr, nv, D, out);
  }
  return add ? ln_bwd_info<__nv_bfloat16, true>(wpr, nv, D, out)
             : ln_bwd_info<__nv_bfloat16, false>(wpr, nv, D, out);
}

// ln_bwd_reduce_kernel's record, as ds_ln_bwd_kernel_info's
int ds_ln_bwd_reduce_info(int* out) {
  return kernel_info(ln_bwd_reduce_kernel<false>, 0, kEwThreads, out);
}

// x, g, dx: (R, F) of x_dtype; b: (F,) of b_dtype (fp32 or x_dtype);
// db: (F,) fp32; part: ds_bwd_blocks(R) * F fp32 scratch.
int ds_bias_gelu_bwd(const void* x, const void* b, const void* g, void* dx,
                     void* db, void* part, long long R, int F, int approximate,
                     int x_dtype, int b_dtype, void* stream) {
  if (R <= 0 || F <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool approx = approximate != 0;
  if (x_dtype == kDtypeF32 && b_dtype == kDtypeF32) {
    return launch_bias_gelu_bwd<float, float>(x, b, g, dx, db, part, R, F, approx, s);
  }
  if (x_dtype == kDtypeBF16 && b_dtype == kDtypeBF16) {
    return launch_bias_gelu_bwd<__nv_bfloat16, __nv_bfloat16>(x, b, g, dx, db, part, R,
                                                              F, approx, s);
  }
  if (x_dtype == kDtypeBF16 && b_dtype == kDtypeF32) {
    return launch_bias_gelu_bwd<__nv_bfloat16, float>(x, b, g, dx, db, part, R, F,
                                                      approx, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
