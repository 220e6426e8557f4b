// Blockwise int8 wire-format kernels for Hopper (sm_90a): the quantize,
// dequantize-and-sum and dequantize passes of the data-parallel gradient
// reducer (runtime/comm/reducer.py). Built by ops/op_builder.py with nvcc
// into a shared library that ops/fused_quant.py loads with ctypes; each entry
// point has a plain C interface, launches on the stream it is given,
// allocates nothing and returns cudaGetLastError() so the wrapper can raise
// on a refused launch.
//
//   ds_quantize_rows    replaces _quant_kernel / _quant_residual_kernel
//                       (deeperspeed_tpu/ops/pallas/fused_quant.py,
//                       launched by quantize_rows): per block of `block`
//                       values of an (R, C) fp32 or bf16 row-major input,
//                       s = max|x| / 127 (1 where that is not > 0: an
//                       all-zero block, or one holding a NaN), q = rint(x/s)
//                       as int8 and, when asked, the error-feedback residual
//                       x - q*s, all from one read of x.
//   ds_dequant_sum_rows replaces _dequant_sum_kernel (launched by
//                       dequant_sum_rows): out[c] = sum over r of
//                       q[r, c] * s[r, c / block], q int8 or fp16 (the
//                       compressed wire's mantissas, whose scales are 2^e).
//   ds_dequant_rows     replaces _dequant_kernel (launched by dequant_rows):
//                       out[r, c] = (q[r, c] * s[r, c / block]) / divisor.
//
// Rounding: every operation is an explicitly rounded intrinsic (__fdiv_rn,
// __fmul_rn, __fadd_rn, __fsub_rn) taken in the order of the plain PyTorch
// versions in ops/fused_quant.py, so nvcc contracts nothing into an FMA and
// the kernels agree with them bit for bit: x / s is a true division (not a
// multiply by 1/s), q*s is rounded before it is subtracted or added, and the
// row sum runs over r in ascending order, one rounded add a row. rintf rounds
// half to even, as torch.round and jnp.rint do. The int8 cast saturates and
// maps NaN to 0, as PyTorch's CUDA cast and XLA's convert do; the max|x| of a
// block propagates NaN (fmaxf alone would drop it), as torch.amax and jnp.max
// do, so a block holding a NaN gets s = 1 on every route.
//
// Bound: device-memory bytes, all three (a few operations per byte). quantize
// reads 4 (fp32) or 2 (bf16) bytes an element and writes 1 (q) + 4 (the
// residual) + 4/block (s); dequant_sum reads R bytes (2R for fp16) plus the
// scales and writes 4; dequant reads 1 and writes 4. At the reducer's bucket
// shapes (millions of elements) the launches run for tens of microseconds.
//
// Design: quantize gives one warp to one block of values. For block 128 with
// 16-byte aligned rows each lane holds 4 consecutive values in registers (one
// 16-byte fp32 or 8-byte bf16 load), the max|x| is a 5-step shuffle
// reduction, and q, s and r are written from the registers: x is read once.
// Any other block (the config allows every block >= 8 that divides the
// bucket) takes a strided loop that reads its block twice, the second time
// from cache. dequant_sum gives one thread four consecutive output elements
// (a 4-byte int8 or 8-byte fp16 load a row, a 16-byte store) and walks the
// R rows in order; dequant_rows gives one thread four consecutive elements
// (a 4-byte load of q, a 16-byte store). Both take one element a thread
// where the shapes or the alignment do not allow four.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;
constexpr int kQInt8 = 0;
constexpr int kQF16 = 1;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float load_f32(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p,
                                          long long i) {
  return __bfloat162float(p[i]);
}

// max|x| over a warp, NaN propagating: a lane that saw a NaN sets the flag.
__device__ __forceinline__ float warp_absmax(float m, bool nan) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
  const bool any_nan = __any_sync(kFull, nan);
  return any_nan ? __int_as_float(0x7fc00000) : m;
}

__device__ __forceinline__ float block_scale(float absmax) {
  const float s = __fdiv_rn(absmax, 127.0f);
  return s > 0.0f ? s : 1.0f;  // all-zero block (or NaN): scale 1
}

// rint(v) as int8: saturating, NaN -> 0 (PyTorch's CUDA cast, XLA's convert)
__device__ __forceinline__ int8_t to_int8(float qf) {
  if (qf != qf) return 0;
  return static_cast<int8_t>(fminf(fmaxf(qf, -128.0f), 127.0f));
}

// block 128, rows 16-byte aligned: 4 values a lane, x read once
template <typename T>
__global__ void quantize128_kernel(const T* __restrict__ x,
                                   int8_t* __restrict__ q,
                                   float* __restrict__ s,
                                   float* __restrict__ r,
                                   long long nblocks) {
  const long long blk =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  if (blk >= nblocks) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const long long base = blk * 128 + lane * 4;
  float v[4];
  if constexpr (sizeof(T) == 4) {
    const float4 raw = *reinterpret_cast<const float4*>(x + base);
    v[0] = raw.x; v[1] = raw.y; v[2] = raw.z; v[3] = raw.w;
  } else {
    const uint2 raw = *reinterpret_cast<const uint2*>(x + base);
    const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = __bfloat162float(b[k]);
  }
  float m = 0.0f;
  bool nan = false;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float a = fabsf(v[k]);
    nan |= (a != a);
    m = fmaxf(m, a);
  }
  const float sc = block_scale(warp_absmax(m, nan));
  char4 qo;
  float qf[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) qf[k] = rintf(__fdiv_rn(v[k], sc));
  qo.x = to_int8(qf[0]); qo.y = to_int8(qf[1]);
  qo.z = to_int8(qf[2]); qo.w = to_int8(qf[3]);
  *reinterpret_cast<char4*>(q + base) = qo;
  if (r != nullptr) {
    float4 ro;
    ro.x = __fsub_rn(v[0], __fmul_rn(qf[0], sc));
    ro.y = __fsub_rn(v[1], __fmul_rn(qf[1], sc));
    ro.z = __fsub_rn(v[2], __fmul_rn(qf[2], sc));
    ro.w = __fsub_rn(v[3], __fmul_rn(qf[3], sc));
    *reinterpret_cast<float4*>(r + base) = ro;
  }
  if (lane == 0) s[blk] = sc;
}

// any block: a strided loop, x read twice (the second time from cache)
template <typename T>
__global__ void quantize_any_kernel(const T* __restrict__ x,
                                    int8_t* __restrict__ q,
                                    float* __restrict__ s,
                                    float* __restrict__ r,
                                    long long nblocks, int block) {
  const long long blk =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  if (blk >= nblocks) return;
  const int lane = threadIdx.x & 31;
  const long long base = blk * block;
  float m = 0.0f;
  bool nan = false;
  for (int i = lane; i < block; i += 32) {
    const float a = fabsf(load_f32(x, base + i));
    nan |= (a != a);
    m = fmaxf(m, a);
  }
  const float sc = block_scale(warp_absmax(m, nan));
  for (int i = lane; i < block; i += 32) {
    const float v = load_f32(x, base + i);
    const float qf = rintf(__fdiv_rn(v, sc));
    q[base + i] = to_int8(qf);
    if (r != nullptr) r[base + i] = __fsub_rn(v, __fmul_rn(qf, sc));
  }
  if (lane == 0) s[blk] = sc;
}

__device__ __forceinline__ float q_value(const int8_t* q, long long i) {
  return static_cast<float>(q[i]);
}
__device__ __forceinline__ float q_value(const __half* q, long long i) {
  return __half2float(q[i]);
}

// out[c] = sum_r q[r, c] * s[r, c / block], r ascending
template <typename Q>
__global__ void dequant_sum_kernel(const Q* __restrict__ q,
                                   const float* __restrict__ s,
                                   float* __restrict__ out, int rows,
                                   long long cols, int block) {
  const long long c =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  const long long nb = cols / block;
  const long long b = c / block;
  float acc = __fmul_rn(q_value(q, c), s[b]);
  for (int rr = 1; rr < rows; ++rr)
    acc = __fadd_rn(acc, __fmul_rn(q_value(q, rr * cols + c), s[rr * nb + b]));
  out[c] = acc;
}

// the same sum, four consecutive outputs a thread (one 4-byte int8 or
// 8-byte fp16 load a row): block % 4 == 0 keeps the four in one block
template <typename Q>
__global__ void dequant_sum4_kernel(const Q* __restrict__ q,
                                    const float* __restrict__ s,
                                    float* __restrict__ out, int rows,
                                    long long cols, int block) {
  using Vec = typename std::conditional<sizeof(Q) == 1, char4, uint2>::type;
  const long long j =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long c = j * 4;
  if (c >= cols) return;
  const long long nb = cols / block;
  const long long b = c / block;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int rr = 0; rr < rows; ++rr) {
    const Vec raw = *reinterpret_cast<const Vec*>(q + rr * cols + c);
    const Q* v = reinterpret_cast<const Q*>(&raw);
    const float sc = s[rr * nb + b];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float p = __fmul_rn(q_value(v, k), sc);
      acc[k] = rr == 0 ? p : __fadd_rn(acc[k], p);
    }
  }
  *reinterpret_cast<float4*>(out + c) =
      make_float4(acc[0], acc[1], acc[2], acc[3]);
}

// out[i] = (q[i] * s[i / block]) / divisor over the flat (R, C) index i,
// whose block index is i / block because block divides C
__global__ void dequant_kernel(const int8_t* __restrict__ q,
                               const float* __restrict__ s,
                               float* __restrict__ out, long long n,
                               int block, float divisor) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = __fdiv_rn(__fmul_rn(static_cast<float>(q[i]), s[i / block]),
                     divisor);
}

// four consecutive elements a thread (block % 4 == 0, n % 4 == 0, aligned)
__global__ void dequant4_kernel(const int8_t* __restrict__ q,
                                const float* __restrict__ s,
                                float* __restrict__ out, long long n4,
                                int block, float divisor) {
  const long long j =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= n4) return;
  const char4 qv = reinterpret_cast<const char4*>(q)[j];
  const float sc = s[(j * 4) / block];
  float4 o;
  o.x = __fdiv_rn(__fmul_rn(static_cast<float>(qv.x), sc), divisor);
  o.y = __fdiv_rn(__fmul_rn(static_cast<float>(qv.y), sc), divisor);
  o.z = __fdiv_rn(__fmul_rn(static_cast<float>(qv.z), sc), divisor);
  o.w = __fdiv_rn(__fmul_rn(static_cast<float>(qv.w), sc), divisor);
  reinterpret_cast<float4*>(out)[j] = o;
}

unsigned grid_for(long long items, int per_block) {
  return static_cast<unsigned>((items + per_block - 1) / per_block);
}

}  // namespace

extern "C" {

const char* ds_quant_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x: (rows, cols) row-major, x_dtype kDtypeF32 or kDtypeBF16; block | cols.
// q: (rows, cols) int8; s: (rows, cols / block) fp32; r: (rows, cols) fp32 or
// null. vec: 1 when block == 128 and x, q, r are 16-byte aligned.
int ds_quantize_rows(const void* x, int x_dtype, void* q, void* s, void* r,
                     long long rows, long long cols, int block, int vec,
                     cudaStream_t stream) {
  const long long nblocks = rows * (cols / block);
  if (nblocks == 0) return 0;
  const dim3 grid(grid_for(nblocks, kWarpsPerBlock));
  int8_t* qo = static_cast<int8_t*>(q);
  float* so = static_cast<float*>(s);
  float* ro = static_cast<float*>(r);
  if (x_dtype == kDtypeF32) {
    const float* xi = static_cast<const float*>(x);
    if (vec)
      quantize128_kernel<float><<<grid, kThreads, 0, stream>>>(
          xi, qo, so, ro, nblocks);
    else
      quantize_any_kernel<float><<<grid, kThreads, 0, stream>>>(
          xi, qo, so, ro, nblocks, block);
  } else {
    const __nv_bfloat16* xi = static_cast<const __nv_bfloat16*>(x);
    if (vec)
      quantize128_kernel<__nv_bfloat16><<<grid, kThreads, 0, stream>>>(
          xi, qo, so, ro, nblocks);
    else
      quantize_any_kernel<__nv_bfloat16><<<grid, kThreads, 0, stream>>>(
          xi, qo, so, ro, nblocks, block);
  }
  return static_cast<int>(cudaGetLastError());
}

// q: (rows, cols) int8 (q_dtype kQInt8) or fp16 (kQF16); s: (rows, cols /
// block) fp32; out: (cols,) fp32. vec: 1 when cols % 4 == 0, block % 4 == 0
// and q, out are aligned for 4-element loads and stores.
int ds_dequant_sum_rows(const void* q, int q_dtype, const void* s, void* out,
                        int rows, long long cols, int block, int vec,
                        cudaStream_t stream) {
  if (cols == 0) return 0;
  const float* si = static_cast<const float*>(s);
  float* o = static_cast<float*>(out);
  const dim3 grid(grid_for(vec ? cols / 4 : cols, kThreads));
  if (q_dtype == kQInt8) {
    const int8_t* qi = static_cast<const int8_t*>(q);
    if (vec)
      dequant_sum4_kernel<int8_t><<<grid, kThreads, 0, stream>>>(
          qi, si, o, rows, cols, block);
    else
      dequant_sum_kernel<int8_t><<<grid, kThreads, 0, stream>>>(
          qi, si, o, rows, cols, block);
  } else {
    const __half* qh = static_cast<const __half*>(q);
    if (vec)
      dequant_sum4_kernel<__half><<<grid, kThreads, 0, stream>>>(
          qh, si, o, rows, cols, block);
    else
      dequant_sum_kernel<__half><<<grid, kThreads, 0, stream>>>(
          qh, si, o, rows, cols, block);
  }
  return static_cast<int>(cudaGetLastError());
}

// q: (rows, cols) int8; s: (rows, cols / block) fp32; out: (rows, cols) fp32.
// vec: 1 when block % 4 == 0 and q, out are 4- and 16-byte aligned.
int ds_dequant_rows(const void* q, const void* s, void* out, long long rows,
                    long long cols, int block, float divisor, int vec,
                    cudaStream_t stream) {
  const long long n = rows * cols;
  if (n == 0) return 0;
  const int8_t* qi = static_cast<const int8_t*>(q);
  const float* si = static_cast<const float*>(s);
  float* o = static_cast<float*>(out);
  if (vec)
    dequant4_kernel<<<grid_for(n / 4, kThreads), kThreads, 0, stream>>>(
        qi, si, o, n / 4, block, divisor);
  else
    dequant_kernel<<<grid_for(n, kThreads), kThreads, 0, stream>>>(
        qi, si, o, n, block, divisor);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
