// Fused Adam / AdamW for Hopper (sm_90a): one multi-tensor launch updates
// every leaf of one dtype combination. Built by ops/op_builder.py with nvcc
// into a shared library that ops/fused_adam.py loads with ctypes; the entry
// point has a plain C interface, launches on the stream it is given,
// allocates nothing and returns cudaGetLastError() so the wrapper can raise
// on a refused launch.
//
// fused_adam replaces the Pallas kernel _adam_kernel
// (deeperspeed_tpu/ops/pallas/fused_adam.py, launched per leaf by
// fused_adam_leaf), whose capability is upstream DeepSpeed's
// csrc/adam/multi_tensor_adam.cu. Per element, all in fp32: the m/v update,
// bias correction, L2 (added to the gradient) or decoupled (AdamW) weight
// decay, the parameter step; p, m and v are written back in place in their
// storage dtypes, and optionally the new params in a compute dtype (the
// master path's fp32 -> bf16/fp16 cast, which then needs no pass of its own).
//
// Rounding: every operation is an explicitly rounded intrinsic (__fmul_rn,
// __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn) taken in the order of the
// plain PyTorch version (ops/fused_adam.py adam_plain), so nvcc contracts
// nothing into an FMA and the kernel agrees with the plain version bit for
// bit. lr and the two bias corrections arrive by value, computed on the host
// in fp32 as the plain version computes them: nothing is read back from the
// device, and the launch could be captured in a CUDA graph.
//
// Bound: device-memory bytes. Each element reads p, g, m, v once and writes
// p, m, v (and the cast) once: 14 bytes a parameter in masterless bf16 (p, g,
// m, v bf16), 30 with fp32 master state and a bf16 cast. The arithmetic, about
// 20 fp32 operations an element, is far below the card's fp32 rate. At
// GPT-NeoX-1.3B's 1.41 G parameters that is 19.8 GB, ~5.9 ms at 3.35 TB/s
// (42.4 GB, ~12.7 ms, on the master path).
//
// Design: the host builds a table of leaf pointers and element counts and
// passes it by value as a kernel parameter (under the 4 KB limit: at most
// kMaxLeaves leaves a launch; the wrapper splits longer lists). Each leaf is
// cut into chunks of kChunk elements; block b finds its leaf by a binary
// search over the table's chunk prefix and updates its chunk with 256
// threads, each handling kVec consecutive elements a step through 16-byte
// vector loads and stores when every pointer of the leaf is 16-byte aligned,
// with a scalar tail for a count that is no multiple of kVec. The TPU
// kernel's row-block geometry and its 16384-element launch gate have no
// counterpart: every leaf, a 0-d one too, rides the one launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;
constexpr int kDtypeF16 = 2;
constexpr int kNoCast = -1;
constexpr int kMaxLeaves = 64;
constexpr int kThreads = 256;
constexpr int kVec = 8;                     // elements a thread handles a step
constexpr long long kChunk = 1LL << 16;     // elements a block handles
constexpr int kDecayNone = 0;
constexpr int kDecayL2 = 1;                 // wd * p added to the gradient
constexpr int kDecayAdamW = 2;              // wd * p added to the update

// The leaves of one launch; ~3.4 KB, passed by value.
struct Table {
  void* p[kMaxLeaves];
  const void* g[kMaxLeaves];
  void* m[kMaxLeaves];
  void* v[kMaxLeaves];
  void* c[kMaxLeaves];          // the cast output, or nullptr
  long long n[kMaxLeaves];      // elements, > 0
  int chunk_start[kMaxLeaves + 1];
  int leaves;
};

struct Hyper {
  float lr, bc1, bc2, b1, one_minus_b1, b2, one_minus_b2, eps, wd;
  int decay;
};

struct NoCast {};

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
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// kVec elements at src (16-byte aligned) as fp32, through 16-byte loads.
template <typename T>
__device__ __forceinline__ void load_vec(const T* src, float (&out)[kVec]) {
  constexpr int kWords = kVec * sizeof(T) / 16;
  uint4 raw[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) raw[w] = reinterpret_cast<const uint4*>(src)[w];
  const T* vals = reinterpret_cast<const T*>(raw);
#pragma unroll
  for (int k = 0; k < kVec; ++k) out[k] = to_f32(vals[k]);
}

template <typename T>
__device__ __forceinline__ void store_vec(T* dst, const float (&in)[kVec]) {
  constexpr int kWords = kVec * sizeof(T) / 16;
  uint4 raw[kWords];
  T* vals = reinterpret_cast<T*>(raw);
#pragma unroll
  for (int k = 0; k < kVec; ++k) vals[k] = from_f32<T>(in[k]);
#pragma unroll
  for (int w = 0; w < kWords; ++w) reinterpret_cast<uint4*>(dst)[w] = raw[w];
}

// One element, in the plain version's order of operations.
__device__ __forceinline__ void adam_step(float& p, float g, float& m, float& v,
                                          const Hyper& h) {
  if (h.decay == kDecayL2) g = __fadd_rn(g, __fmul_rn(h.wd, p));
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.one_minus_b1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(h.one_minus_b2, __fmul_rn(g, g)));
  const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, h.bc2)), h.eps);
  float upd = __fdiv_rn(__fdiv_rn(m, h.bc1), denom);
  if (h.decay == kDecayAdamW) upd = __fadd_rn(upd, __fmul_rn(h.wd, p));
  p = __fsub_rn(p, __fmul_rn(h.lr, upd));
}

template <typename TP, typename TM, typename TV, typename TC>
__global__ void __launch_bounds__(kThreads)
    fused_adam_kernel(const Table t, const Hyper h) {
  constexpr bool kCast = !std::is_same<TC, NoCast>::value;
  const int chunk = static_cast<int>(blockIdx.x);
  // the leaf: the last one whose first chunk is at or before this one
  int lo = 0, hi = t.leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.chunk_start[mid] <= chunk) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const long long n = t.n[lo];
  const long long begin = static_cast<long long>(chunk - t.chunk_start[lo]) * kChunk;
  const long long end = begin + kChunk < n ? begin + kChunk : n;
  TP* p = static_cast<TP*>(t.p[lo]);
  const TP* g = static_cast<const TP*>(t.g[lo]);
  TM* m = static_cast<TM*>(t.m[lo]);
  TV* v = static_cast<TV*>(t.v[lo]);
  TC* c = static_cast<TC*>(t.c[lo]);

  uintptr_t bits = reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g) |
                   reinterpret_cast<uintptr_t>(m) | reinterpret_cast<uintptr_t>(v);
  if constexpr (kCast) bits |= reinterpret_cast<uintptr_t>(c);
  // begin is a multiple of kChunk, so with 16-byte aligned bases every step
  // of kVec elements (16 bytes or more) stays aligned
  long long vec_end = begin;
  if ((bits & 15) == 0) {
    vec_end = begin + (end - begin) / kVec * kVec;
    for (long long i = begin + static_cast<long long>(threadIdx.x) * kVec; i < vec_end;
         i += static_cast<long long>(kThreads) * kVec) {
      float pf[kVec], gf[kVec], mf[kVec], vf[kVec];
      load_vec(p + i, pf);
      load_vec(g + i, gf);
      load_vec(m + i, mf);
      load_vec(v + i, vf);
#pragma unroll
      for (int k = 0; k < kVec; ++k) adam_step(pf[k], gf[k], mf[k], vf[k], h);
      store_vec(p + i, pf);
      store_vec(m + i, mf);
      store_vec(v + i, vf);
      if constexpr (kCast) store_vec(c + i, pf);
    }
  }
  for (long long i = vec_end + threadIdx.x; i < end; i += kThreads) {
    float pf = to_f32(p[i]);
    float mf = to_f32(m[i]);
    float vf = to_f32(v[i]);
    adam_step(pf, to_f32(g[i]), mf, vf, h);
    p[i] = from_f32<TP>(pf);
    m[i] = from_f32<TM>(mf);
    v[i] = from_f32<TV>(vf);
    if constexpr (kCast) c[i] = from_f32<TC>(pf);
  }
}

template <typename TP, typename TM, typename TV, typename TC>
void launch(const Table& t, const Hyper& h, int chunks, cudaStream_t s) {
  fused_adam_kernel<TP, TM, TV, TC><<<chunks, kThreads, 0, s>>>(t, h);
}

}  // namespace

extern "C" {

const char* ds_adam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int ds_fused_adam_max_leaves() { return kMaxLeaves; }

// ptrs: leaves x 5 device addresses (p, g, m, v, cast; cast 0 without a cast
// output), counts: each leaf's element count (> 0). p and g share p_dtype.
// The dtype combinations the engine builds:
//   masterless bf16:  p, g, m bf16; v bf16 or fp32; no cast
//   fp32 master:      p, g, m, v fp32; cast bf16 or fp16
//   fp32:             p, g, m, v fp32; no cast
// Any other combination returns cudaErrorInvalidValue without a launch.
int ds_fused_adam(const long long* ptrs, const long long* counts, int leaves,
                  int p_dtype, int m_dtype, int v_dtype, int c_dtype, float lr,
                  float bc1, float bc2, float b1, float one_minus_b1, float b2,
                  float one_minus_b2, float eps, float wd, int decay, void* stream) {
  if (leaves <= 0 || leaves > kMaxLeaves || decay < kDecayNone || decay > kDecayAdamW) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Table t = {};
  long long chunks = 0;
  for (int l = 0; l < leaves; ++l) {
    if (counts[l] <= 0) return static_cast<int>(cudaErrorInvalidValue);
    t.p[l] = reinterpret_cast<void*>(ptrs[5 * l]);
    t.g[l] = reinterpret_cast<const void*>(ptrs[5 * l + 1]);
    t.m[l] = reinterpret_cast<void*>(ptrs[5 * l + 2]);
    t.v[l] = reinterpret_cast<void*>(ptrs[5 * l + 3]);
    t.c[l] = reinterpret_cast<void*>(ptrs[5 * l + 4]);
    if ((c_dtype == kNoCast) != (t.c[l] == nullptr)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    t.n[l] = counts[l];
    t.chunk_start[l] = static_cast<int>(chunks);
    chunks += (counts[l] + kChunk - 1) / kChunk;
    if (chunks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  }
  t.chunk_start[leaves] = static_cast<int>(chunks);
  t.leaves = leaves;
  const Hyper h = {lr, bc1, bc2, b1, one_minus_b1, b2, one_minus_b2, eps, wd, decay};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = static_cast<int>(chunks);
  using bf16 = __nv_bfloat16;
  if (p_dtype == kDtypeBF16 && m_dtype == kDtypeBF16 && c_dtype == kNoCast) {
    if (v_dtype == kDtypeBF16) {
      launch<bf16, bf16, bf16, NoCast>(t, h, grid, s);
    } else if (v_dtype == kDtypeF32) {
      launch<bf16, bf16, float, NoCast>(t, h, grid, s);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (p_dtype == kDtypeF32 && m_dtype == kDtypeF32 && v_dtype == kDtypeF32) {
    if (c_dtype == kNoCast) {
      launch<float, float, float, NoCast>(t, h, grid, s);
    } else if (c_dtype == kDtypeBF16) {
      launch<float, float, float, bf16>(t, h, grid, s);
    } else if (c_dtype == kDtypeF16) {
      launch<float, float, float, __half>(t, h, grid, s);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
