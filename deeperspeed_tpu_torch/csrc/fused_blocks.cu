// Fused elementwise forward kernels for Hopper (sm_90a): LayerNorm and
// bias+GeLU. Built by ops/op_builder.py with nvcc into a shared library that
// ops/fused_blocks.py loads with ctypes; every entry point below has a plain C
// interface, launches on the stream it is given, allocates nothing and
// returns cudaGetLastError() so the wrapper can raise on a refused launch.
//
// ln_fwd replaces the Pallas kernel _ln_fwd_kernel
// (deeperspeed_tpu/ops/pallas/fused_blocks.py, launched by _ln_fwd_call).
// bias_gelu_fwd replaces _bg_fwd_kernel (same file, launched by _bg).
//
// Both are bound by device-memory bytes, not arithmetic: LayerNorm reads x
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;
constexpr int kLnThreads = 256;
constexpr int kEwThreads = 256;
constexpr int kEwMaxBlocks = 132 * 32;  // 32 blocks per SM on the H100's 132

constexpr float kSqrt2OverPi = 0.7978845608028654f;
constexpr float kGeluC = 0.044715f;
constexpr float kInvSqrt2 = 0.7071067811865476f;

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

}  // extern "C"
