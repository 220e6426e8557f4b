// Fused elementwise kernels for Hopper (sm_90a): LayerNorm and bias+GeLU,
// forward and backward. Built by ops/op_builder.py with nvcc into a shared library that
// ops/fused_blocks.py loads with ctypes; every entry point below has a plain C
// interface, launches on the stream it is given, allocates nothing and
// returns cudaGetLastError() so the wrapper can raise on a refused launch.
//
// ln_fwd replaces the Pallas kernel _ln_fwd_kernel
// (deeperspeed_tpu/ops/pallas/fused_blocks.py, launched by _ln_fwd_call).
// bias_gelu_fwd replaces _bg_fwd_kernel (same file, launched by _bg).
// ln_bwd replaces _ln_bwd_kernel (launched by _ln_vjp_bwd) and
// bias_gelu_bwd replaces _bg_bwd_kernel (launched by _bg_vjp_bwd).
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
// launch walks a strided set of rows and keeps its column partials in
// shared memory (every column is owned by one thread, so no atomics and no
// races); it writes one fp32 partial row per block, and a second launch
// (sum_partials_kernel) adds those rows per column in a fixed order. The
// result is deterministic from run to run. At most kBwdBlocks blocks (two
// per SM) keep the partials small: (kBwdBlocks, D) fp32, ~4 MB at D = 2048,
// against the 24 MB that ln_bwd moves at the (2048, 2048) bf16 training
// shape.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;
constexpr int kLnThreads = 256;
constexpr int kEwThreads = 256;
constexpr int kEwMaxBlocks = 132 * 32;  // 32 blocks per SM on the H100's 132
constexpr int kBwdBlocks = 132 * 2;     // row-walking backward blocks
constexpr int kSmemDefault = 48 * 1024;  // dynamic shared memory without opt-in

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

template <typename T>
__global__ void __launch_bounds__(kLnThreads)
    ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ b, T* __restrict__ y,
                  float* __restrict__ mean, float* __restrict__ rstd, int D,
                  float eps) {
  __shared__ float red[33];
  const long long row = blockIdx.x;
  const T* xr = x + row * D;
  T* yr = y + row * D;
  const float inv_d = 1.f / static_cast<float>(D);

  float s = 0.f;
  for (int i = threadIdx.x; i < D; i += blockDim.x) s += to_f32(xr[i]);
  const float mu = block_sum(s, red) * inv_d;

  float ss = 0.f;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float d = to_f32(xr[i]) - mu;
    ss += d * d;
  }
  const float rs = rsqrtf(block_sum(ss, red) * inv_d + eps);

  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    yr[i] = from_f32<T>((to_f32(xr[i]) - mu) * rs * w[i] + b[i]);
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
template <typename T>
__global__ void __launch_bounds__(kLnThreads)
    ln_bwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
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
    const T* gr = g + row * D;
    T* dxr = dx + row * D;
    const float mu = mean[row];
    const float rs = rstd[row];
    float s1 = 0.f, s2 = 0.f;
    for (int i = threadIdx.x; i < D; i += blockDim.x) {
      const float xh = (to_f32(xr[i]) - mu) * rs;
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
      const float xh = (to_f32(xr[i]) - mu) * rs;
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

// out[i] = sum over p of part[p, i], p in order: the second pass of both
// backward reductions.
__global__ void __launch_bounds__(kEwThreads)
    sum_partials_kernel(const float* __restrict__ part, int nparts, int D,
                        float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= D) return;
  float s = 0.f;
  for (int p = 0; p < nparts; ++p) s += part[static_cast<long long>(p) * D + i];
  out[i] = s;
}

int bwd_blocks(long long R) { return static_cast<int>(R < kBwdBlocks ? R : kBwdBlocks); }

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= static_cast<size_t>(kSmemDefault)) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
int launch_ln_bwd(const void* x, const void* w, const void* mean, const void* rstd,
                  const void* g, void* dx, void* dw, void* db, void* part,
                  long long R, int D, cudaStream_t s) {
  const int nb = bwd_blocks(R);
  const size_t smem = 2 * static_cast<size_t>(D) * sizeof(float);
  cudaError_t err = allow_smem(ln_bwd_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* dw_part = static_cast<float*>(part);
  float* db_part = dw_part + static_cast<long long>(nb) * D;
  ln_bwd_kernel<T><<<nb, kLnThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(mean), static_cast<const float*>(rstd),
      static_cast<const T*>(g), static_cast<T*>(dx), dw_part, db_part, R, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rb = (D + kEwThreads - 1) / kEwThreads;
  sum_partials_kernel<<<rb, kEwThreads, 0, s>>>(dw_part, nb, D, static_cast<float*>(dw));
  sum_partials_kernel<<<rb, kEwThreads, 0, s>>>(db_part, nb, D, static_cast<float*>(db));
  return static_cast<int>(cudaGetLastError());
}

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

// x, y: (R, D) of dtype; w, b: (D,) fp32; mean, rstd: (R,) fp32.
int ds_ln_fwd(const void* x, const void* w, const void* b, void* y, void* mean,
              void* rstd, long long R, int D, float eps, int dtype,
              void* stream) {
  if (R <= 0 || R > 0x7fffffffLL || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(R));
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  float* mf = static_cast<float*>(mean);
  float* rf = static_cast<float*>(rstd);
  if (dtype == kDtypeF32) {
    ln_fwd_kernel<float><<<grid, kLnThreads, 0, s>>>(
        static_cast<const float*>(x), wf, bf, static_cast<float*>(y), mf, rf, D, eps);
  } else if (dtype == kDtypeBF16) {
    ln_fwd_kernel<__nv_bfloat16><<<grid, kLnThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), wf, bf, static_cast<__nv_bfloat16*>(y),
        mf, rf, D, eps);
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

// Number of partial rows the two backwards write into their scratch: the
// wrapper allocates (2 *) ds_bwd_blocks(R) * D fp32 values.
int ds_bwd_blocks(long long R) { return R > 0 ? bwd_blocks(R) : 0; }

// x, g, dx: (R, D) of dtype; w: (D,) fp32; mean, rstd: (R,) fp32 from ln_fwd;
// dw, db: (D,) fp32; part: 2 * ds_bwd_blocks(R) * D fp32 scratch.
int ds_ln_bwd(const void* x, const void* w, const void* mean, const void* rstd,
              const void* g, void* dx, void* dw, void* db, void* part,
              long long R, int D, int dtype, void* stream) {
  if (R <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeF32) {
    return launch_ln_bwd<float>(x, w, mean, rstd, g, dx, dw, db, part, R, D, s);
  }
  if (dtype == kDtypeBF16) {
    return launch_ln_bwd<__nv_bfloat16>(x, w, mean, rstd, g, dx, dw, db, part, R, D, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
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
