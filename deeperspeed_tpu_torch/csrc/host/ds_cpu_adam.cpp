// Host-side vectorized Adam/AdamW for offloaded optimizer shards.
//
// Re-implements the capability of the reference DeepSpeed CPU-Adam op
// (csrc/adam/cpu_adam.cpp: create_adam/destroy_adam per-id registry,
// adam_update, adam_update_copy with fused fp16 copy-back) for the TPU-VM
// host. Differences from the reference, by design:
//   - flat C ABI for ctypes (no pybind11 in this image);
//   - the fused low-precision copy-back emits bfloat16 (the TPU compute
//     dtype) instead of fp16;
//   - AVX-512F / AVX2+FMA intrinsic paths with a scalar fallback, selected
//     at compile time; OpenMP parallel over chunks like the reference's
//     TILE loop.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>

#if defined(__AVX512F__) || defined(__AVX2__)
#include <immintrin.h>
#endif

namespace {

struct AdamConfig {
    float alpha;
    float beta1;
    float beta2;
    float eps;
    float weight_decay;
    bool adamw_mode;  // decoupled weight decay (AdamW) vs L2-into-grad (Adam)
    bool bias_correction;
};

std::map<int, AdamConfig> g_optimizers;
std::mutex g_mu;

// bf16 <- fp32 with round-to-nearest-even (matches XLA's convert).
inline uint16_t f32_to_bf16(float f) {
    uint32_t x;
    memcpy(&x, &f, 4);
    uint32_t lsb = (x >> 16) & 1;
    x += 0x7fff + lsb;
    return (uint16_t)(x >> 16);
}

// Scalar core, one element. Mirrors the reference update
// (csrc/includes/cpu_adam.h Step math): bias correction 1 folded into
// step_size, bias correction 2 into the denominator; decoupled (AdamW)
// weight decay scales by raw lr, not lr/bc1.
inline void adam_scalar(float& p, float g, float& m, float& v, const AdamConfig& c,
                        float step_size, float bc2_sqrt, float lr) {
    if (!c.adamw_mode && c.weight_decay > 0) g += c.weight_decay * p;
    m = c.beta1 * m + (1.f - c.beta1) * g;
    v = c.beta2 * v + (1.f - c.beta2) * g * g;
    float denom = sqrtf(v) / bc2_sqrt + c.eps;
    float update = step_size * (m / denom);
    if (c.adamw_mode && c.weight_decay > 0) update += lr * c.weight_decay * p;
    p -= update;
}

#if defined(__AVX512F__)
constexpr int kSimd = 16;
inline void adam_simd(float* p, const float* g, float* m, float* v, int64_t i,
                      const AdamConfig& c, float step_size, float bc2_sqrt, float lr) {
    __m512 vp = _mm512_loadu_ps(p + i);
    __m512 vg = _mm512_loadu_ps(g + i);
    __m512 vm = _mm512_loadu_ps(m + i);
    __m512 vv = _mm512_loadu_ps(v + i);
    if (!c.adamw_mode && c.weight_decay > 0)
        vg = _mm512_fmadd_ps(_mm512_set1_ps(c.weight_decay), vp, vg);
    vm = _mm512_fmadd_ps(_mm512_set1_ps(1.f - c.beta1), vg,
                         _mm512_mul_ps(_mm512_set1_ps(c.beta1), vm));
    vv = _mm512_fmadd_ps(_mm512_mul_ps(_mm512_set1_ps(1.f - c.beta2), vg), vg,
                         _mm512_mul_ps(_mm512_set1_ps(c.beta2), vv));
    __m512 denom = _mm512_add_ps(
        _mm512_div_ps(_mm512_sqrt_ps(vv), _mm512_set1_ps(bc2_sqrt)),
        _mm512_set1_ps(c.eps));
    __m512 upd = _mm512_mul_ps(_mm512_set1_ps(step_size), _mm512_div_ps(vm, denom));
    if (c.adamw_mode && c.weight_decay > 0)
        upd = _mm512_fmadd_ps(_mm512_set1_ps(lr * c.weight_decay), vp, upd);
    vp = _mm512_sub_ps(vp, upd);
    _mm512_storeu_ps(p + i, vp);
    _mm512_storeu_ps(m + i, vm);
    _mm512_storeu_ps(v + i, vv);
}
#elif defined(__AVX2__)
constexpr int kSimd = 8;
inline void adam_simd(float* p, const float* g, float* m, float* v, int64_t i,
                      const AdamConfig& c, float step_size, float bc2_sqrt, float lr) {
    __m256 vp = _mm256_loadu_ps(p + i);
    __m256 vg = _mm256_loadu_ps(g + i);
    __m256 vm = _mm256_loadu_ps(m + i);
    __m256 vv = _mm256_loadu_ps(v + i);
    if (!c.adamw_mode && c.weight_decay > 0)
        vg = _mm256_fmadd_ps(_mm256_set1_ps(c.weight_decay), vp, vg);
    vm = _mm256_fmadd_ps(_mm256_set1_ps(1.f - c.beta1), vg,
                         _mm256_mul_ps(_mm256_set1_ps(c.beta1), vm));
    vv = _mm256_fmadd_ps(_mm256_mul_ps(_mm256_set1_ps(1.f - c.beta2), vg), vg,
                         _mm256_mul_ps(_mm256_set1_ps(c.beta2), vv));
    __m256 denom = _mm256_add_ps(
        _mm256_div_ps(_mm256_sqrt_ps(vv), _mm256_set1_ps(bc2_sqrt)),
        _mm256_set1_ps(c.eps));
    __m256 upd = _mm256_mul_ps(_mm256_set1_ps(step_size), _mm256_div_ps(vm, denom));
    if (c.adamw_mode && c.weight_decay > 0)
        upd = _mm256_fmadd_ps(_mm256_set1_ps(lr * c.weight_decay), vp, upd);
    vp = _mm256_sub_ps(vp, upd);
    _mm256_storeu_ps(p + i, vp);
    _mm256_storeu_ps(m + i, vm);
    _mm256_storeu_ps(v + i, vv);
}
#else
constexpr int kSimd = 1;
#endif

int adam_step_impl(int optimizer_id, int64_t step, float lr, float beta1_override,
                   float beta2_override, float eps_override, float wd_override,
                   float* params, const float* grads, float* exp_avg,
                   float* exp_avg_sq, int64_t n, uint16_t* bf16_out) {
    AdamConfig c;
    {
        std::lock_guard<std::mutex> g(g_mu);
        auto it = g_optimizers.find(optimizer_id);
        if (it == g_optimizers.end()) return -1;
        c = it->second;
    }
    if (beta1_override >= 0) c.beta1 = beta1_override;
    if (beta2_override >= 0) c.beta2 = beta2_override;
    if (eps_override >= 0) c.eps = eps_override;
    if (wd_override >= 0) c.weight_decay = wd_override;

    const float bc1 = c.bias_correction ? 1.f - powf(c.beta1, (float)step) : 1.f;
    const float bc2_sqrt =
        c.bias_correction ? sqrtf(1.f - powf(c.beta2, (float)step)) : 1.f;
    const float step_size = lr / bc1;

    const int64_t chunk = 1 << 16;
#pragma omp parallel for schedule(static)
    for (int64_t base = 0; base < n; base += chunk) {
        int64_t end = base + chunk < n ? base + chunk : n;
        int64_t i = base;
#if defined(__AVX512F__) || defined(__AVX2__)
        for (; i + kSimd <= end; i += kSimd)
            adam_simd(params, grads, exp_avg, exp_avg_sq, i, c, step_size, bc2_sqrt, lr);
#endif
        for (; i < end; ++i)
            adam_scalar(params[i], grads[i], exp_avg[i], exp_avg_sq[i], c, step_size,
                        bc2_sqrt, lr);
        if (bf16_out)
            for (int64_t j = base; j < end; ++j) bf16_out[j] = f32_to_bf16(params[j]);
    }
    return 0;
}

// ------------------------------------------------------------------ //
// Streamed-offload wire codec: fused dequant(grads) -> Adam -> quant(delta)
// for the quantized host<->device offload channel
// (deeperspeed_tpu/runtime/offload/streaming.py). One cache-friendly pass
// per wire block replaces ~10 numpy passes over multi-GB arrays on the
// single-core host.
//
// Wire layout (must match streaming._dev_quant / _dev_dequant): per leaf,
// the flat vector is zero-padded to nb*block elements. int8: one byte per
// element. int4: HALF-SPLIT nibbles — byte i carries element i (low) and
// element half+i (high), half = nb*block/2. Scales: nb floats per leaf,
// absmax/qmax per block. The uplink carries the delta (master - shadow)
// quantized round-to-nearest; the bf16 shadow then replays the exact
// dequantized delta, which is what makes the quantization residual carry
// into the next step (error feedback) instead of being lost.
// ------------------------------------------------------------------ //

inline float bf16_to_f32(uint16_t b) {
    uint32_t x = ((uint32_t)b) << 16;
    float f;
    memcpy(&f, &x, 4);
    return f;
}

inline int fetch_q(const unsigned char* packed, int64_t e, int bits,
                   int64_t half) {
    if (bits == 8) return (int)(int8_t)packed[e];
    unsigned char byte = (e < half) ? packed[e] : packed[e - half];
    int v = (e < half) ? (byte & 0x0F) : (byte >> 4);
    return v >= 8 ? v - 16 : v;
}

inline void adam_block(float* p, const float* g, float* m, float* v,
                       int64_t count, const AdamConfig& c, float step_size,
                       float bc2_sqrt, float lr) {
    int64_t i = 0;
#if defined(__AVX512F__) || defined(__AVX2__)
    for (; i + kSimd <= count; i += kSimd)
        adam_simd(p, g, m, v, i, c, step_size, bc2_sqrt, lr);
#endif
    for (; i < count; ++i)
        adam_scalar(p[i], g[i], m[i], v[i], c, step_size, bc2_sqrt, lr);
}

int stream_chunk_step_impl(int optimizer_id, int64_t step, float lr,
                           const unsigned char* g_packed,
                           const float* g_scales, float* master,
                           float* exp_avg, float* exp_avg_sq,
                           uint16_t* shadow, unsigned char* out_packed,
                           float* out_scales, const int64_t* leaf_sizes,
                           const int* leaf_bits, int64_t n_leaves,
                           int block) {
    AdamConfig c;
    {
        std::lock_guard<std::mutex> g(g_mu);
        auto it = g_optimizers.find(optimizer_id);
        if (it == g_optimizers.end()) return -1;
        c = it->second;
    }
    const float bc1 = c.bias_correction ? 1.f - powf(c.beta1, (float)step) : 1.f;
    const float bc2_sqrt =
        c.bias_correction ? sqrtf(1.f - powf(c.beta2, (float)step)) : 1.f;
    const float step_size = lr / bc1;

    // validate the whole wire BEFORE touching any state: a mid-loop
    // rejection would leave earlier leaves already stepped, and the
    // caller's numpy fallback would then double-apply them
    for (int64_t li = 0; li < n_leaves; ++li)
        if (leaf_bits[li] != 4 && leaf_bits[li] != 8)
            return -2;  // bf16/fp32 wires stay on the python path

    float* gbuf = new float[block];
    float* dbuf = new float[block];
    int64_t elem_off = 0, byte_off = 0, scale_off = 0;
    for (int64_t li = 0; li < n_leaves; ++li) {
        const int64_t n = leaf_sizes[li];
        const int bits = leaf_bits[li];
        const int64_t nb = (n + block - 1) / block;
        const int64_t padded = nb * block;
        const int64_t half = padded / 2;  // int4 half-split boundary
        const int64_t leaf_bytes = bits == 4 ? padded / 2 : padded;
        const unsigned char* gp = g_packed + byte_off;
        unsigned char* op = out_packed + byte_off;
        const float qmax = bits == 4 ? 7.f : 127.f;
        memset(op, 0, (size_t)leaf_bytes);
        float* mast = master + elem_off;
        float* ma = exp_avg + elem_off;
        float* va = exp_avg_sq + elem_off;
        uint16_t* sh = shadow + elem_off;
        for (int64_t b = 0; b < nb; ++b) {
            const int64_t e0 = b * block;
            const int64_t count = (e0 + block <= n) ? block : (n - e0);
            if (count <= 0) {  // pure padding block: zero delta, unit scale
                out_scales[scale_off + b] = 1.f;
                continue;
            }
            const float gs = g_scales[scale_off + b];
            for (int64_t j = 0; j < count; ++j)
                gbuf[j] = fetch_q(gp, e0 + j, bits, half) * gs;
            adam_block(mast + e0, gbuf, ma + e0, va + e0, count, c,
                       step_size, bc2_sqrt, lr);
            float absmax = 0.f;
            for (int64_t j = 0; j < count; ++j) {
                float d = mast[e0 + j] - bf16_to_f32(sh[e0 + j]);
                dbuf[j] = d;
                float a = fabsf(d);
                if (a > absmax) absmax = a;
            }
            float s = absmax > 0.f ? absmax / qmax : 1.f;
            out_scales[scale_off + b] = s;
            const float inv_s = 1.f / s;
            for (int64_t j = 0; j < count; ++j) {
                const int64_t e = e0 + j;
                float q = nearbyintf(dbuf[j] * inv_s);  // matches np.rint
                if (q > qmax) q = qmax;
                if (q < -qmax - 1) q = -qmax - 1;
                const int qi = (int)q;
                if (bits == 8) {
                    op[e] = (unsigned char)(int8_t)qi;
                } else if (e < half) {
                    op[e] |= (unsigned char)(qi & 0x0F);
                } else {
                    op[e - half] |= (unsigned char)((qi & 0x0F) << 4);
                }
                sh[e] = f32_to_bf16(bf16_to_f32(sh[e]) + q * s);
            }
        }
        elem_off += n;
        byte_off += leaf_bytes;
        scale_off += nb;
    }
    delete[] gbuf;
    delete[] dbuf;
    return 0;
}

// ------------------------------------------------------------------ //
// Generalized streamed chunk step (the 20B ZeRO-Infinity profile):
//   - optimizer state stored as fp32 OR bf16 bits (host_state='bf16':
//     master/exp_avg/exp_avg_sq are uint16 round-to-nearest-even images;
//     fp32 transients exist only per wire block, never per chunk — the
//     numpy path's 3x chunk-sized fp32 copies were both the 65min/step
//     host_opt cost and the arena-fragmentation OOM at 20B);
//   - uplink mode 0: error-fed delta against the bf16 shadow (identical
//     semantics to ds_stream_chunk_step above);
//   - uplink mode 1 (quant-resident): the uplink IS the new resident
//     representation quant(master) — per-leaf res_bits 4/8 codes + fp32
//     block scales, or bf16 bits for small (res_bits=16) leaves. No
//     error feedback: the master is authoritative and the device stores
//     the uplinked bytes verbatim (streaming._host_chunk_step contract).
// Wire/resident blocking both use the same `block`, so one pass over a
// leaf serves grad dequant, Adam, state writeback, and re-encode.
// ------------------------------------------------------------------ //

inline float sext4(int v) { return (float)(v >= 8 ? v - 16 : v); }

// Dequantize `count` wire elements of block b (block-local fp32 out).
// int4 is leaf-level HALF-SPLIT: element e rides byte e (low nibble) when
// e < half, byte e-half (high nibble) otherwise; a block can straddle the
// boundary, so the low/high runs are two separate (auto-vectorizable)
// loops.
inline void dequant_block(const unsigned char* gp, float gs, int64_t e0,
                          int64_t count, int bits, int64_t half,
                          float* out) {
    if (bits == 8) {
        for (int64_t j = 0; j < count; ++j)
            out[j] = (float)(int8_t)gp[e0 + j] * gs;
        return;
    }
    int64_t lo_n = half > e0 ? (half - e0 < count ? half - e0 : count) : 0;
    for (int64_t j = 0; j < lo_n; ++j)
        out[j] = sext4(gp[e0 + j] & 0x0F) * gs;
    for (int64_t j = lo_n; j < count; ++j)
        out[j] = sext4(gp[e0 + j - half] >> 4) * gs;
}

// Quantize `count` fp32 values into the wire/resident layout at block b.
// Writes the scale, ORs code nibbles into memset-0 output (two blocks
// share a byte across the half boundary), and optionally replays the
// dequantized values back into `replay` (error-feedback shadow advance).
inline float quant_block(const float* x, int64_t e0, int64_t count,
                         int bits, int64_t half, unsigned char* op,
                         float* scale_out, float* replay) {
    const float qmax = bits == 4 ? 7.f : 127.f;
    float absmax = 0.f;
    for (int64_t j = 0; j < count; ++j) {
        float a = fabsf(x[j]);
        if (a > absmax) absmax = a;
    }
    const float s = absmax > 0.f ? absmax / qmax : 1.f;
    *scale_out = s;
    const float inv_s = 1.f / s;
    if (bits == 8) {
        for (int64_t j = 0; j < count; ++j) {
            float q = nearbyintf(x[j] * inv_s);
            if (q > qmax) q = qmax;
            if (q < -qmax - 1) q = -qmax - 1;
            op[e0 + j] = (unsigned char)(int8_t)(int)q;
            if (replay) replay[j] = q * s;
        }
        return s;
    }
    int64_t lo_n = half > e0 ? (half - e0 < count ? half - e0 : count) : 0;
    for (int64_t j = 0; j < count; ++j) {
        float q = nearbyintf(x[j] * inv_s);
        if (q > qmax) q = qmax;
        if (q < -qmax - 1) q = -qmax - 1;
        const int qi = (int)q;
        if (j < lo_n)
            op[e0 + j] |= (unsigned char)(qi & 0x0F);
        else
            op[e0 + j - half] |= (unsigned char)((qi & 0x0F) << 4);
        if (replay) replay[j] = q * s;
    }
    return s;
}

// The generalized pass (ds_stream_chunk_step2). ds_stream_blocks_step2
// runs it over one leaf's wire blocks [b_begin, b_end) with the uplink
// left as the caller zeroed it: one code, so the same instructions and
// the same bytes whether a leaf is stepped whole or in pieces.
int stream_chunk_step2_impl(
    int optimizer_id, int64_t step, float lr, const unsigned char* g_packed,
    const float* g_scales, void* master, void* exp_avg, void* exp_avg_sq,
    int state_bf16, uint16_t* shadow, unsigned char* out_packed,
    float* out_scales, unsigned char* out_c, float* out_s, uint16_t* out_w,
    const int64_t* leaf_sizes, const int* leaf_bits, const int* res_bits,
    int64_t n_leaves, int block, int mode, int64_t b_begin = 0,
    int64_t b_end = -1, bool zero_uplink = true) {
    AdamConfig c;
    {
        std::lock_guard<std::mutex> g(g_mu);
        auto it = g_optimizers.find(optimizer_id);
        if (it == g_optimizers.end()) return -1;
        c = it->second;
    }
    const float bc1 = c.bias_correction ? 1.f - powf(c.beta1, (float)step) : 1.f;
    const float bc2_sqrt =
        c.bias_correction ? sqrtf(1.f - powf(c.beta2, (float)step)) : 1.f;
    const float step_size = lr / bc1;

    // whole-wire validation up front (a mid-loop rejection would leave
    // earlier leaves stepped; the caller would then numpy-fallback and
    // double-apply)
    for (int64_t li = 0; li < n_leaves; ++li) {
        if (leaf_bits[li] != 4 && leaf_bits[li] != 8) return -2;
        if (mode == 1 && res_bits[li] != 4 && res_bits[li] != 8 &&
            res_bits[li] != 16)
            return -2;
    }

    float* gbuf = new float[block];
    float* pbuf = new float[block];
    float* mbuf = new float[block];
    float* vbuf = new float[block];
    float* dbuf = new float[block];

    int64_t elem_off = 0, g_byte_off = 0, g_scale_off = 0;
    int64_t c_byte_off = 0, c_scale_off = 0, w_off = 0;
    for (int64_t li = 0; li < n_leaves; ++li) {
        const int64_t n = leaf_sizes[li];
        const int bits = leaf_bits[li];
        const int64_t nb = (n + block - 1) / block;
        const int64_t padded = nb * block;
        const int64_t half = padded / 2;
        const int64_t g_leaf_bytes = bits == 4 ? padded / 2 : padded;
        const unsigned char* gp = g_packed + g_byte_off;
        const int rb = mode == 1 ? res_bits[li] : 16;
        // uplink geometry for this leaf
        unsigned char* up_codes = nullptr;
        float* up_scales = nullptr;
        int up_bits = 0;
        if (mode == 0) {
            up_codes = out_packed + g_byte_off;  // wire-shaped delta uplink
            up_scales = out_scales + g_scale_off;
            up_bits = bits;
            if (zero_uplink) memset(up_codes, 0, (size_t)g_leaf_bytes);
        } else if (rb < 16) {
            up_codes = out_c + c_byte_off;
            up_scales = out_s + c_scale_off;
            up_bits = rb;
            if (zero_uplink)
                memset(up_codes, 0, (size_t)(rb == 4 ? padded / 2 : padded));
        }
        const int64_t b1 = b_end < 0 ? nb : b_end;
        for (int64_t b = b_begin; b < b1; ++b) {
            const int64_t e0 = b * block;
            const int64_t count = (e0 + block <= n) ? block : (n - e0);
            if (count <= 0) {  // pure padding block: zero codes, unit scale
                if (up_scales) up_scales[b] = 1.f;
                continue;
            }
            dequant_block(gp, g_scales[g_scale_off + b], e0, count, bits,
                          half, gbuf);
            float *p, *m, *v;
            if (state_bf16) {
                uint16_t* pm = (uint16_t*)master + elem_off + e0;
                uint16_t* mm = (uint16_t*)exp_avg + elem_off + e0;
                uint16_t* vm = (uint16_t*)exp_avg_sq + elem_off + e0;
                for (int64_t j = 0; j < count; ++j) pbuf[j] = bf16_to_f32(pm[j]);
                for (int64_t j = 0; j < count; ++j) mbuf[j] = bf16_to_f32(mm[j]);
                for (int64_t j = 0; j < count; ++j) vbuf[j] = bf16_to_f32(vm[j]);
                p = pbuf; m = mbuf; v = vbuf;
            } else {
                p = (float*)master + elem_off + e0;
                m = (float*)exp_avg + elem_off + e0;
                v = (float*)exp_avg_sq + elem_off + e0;
            }
            adam_block(p, gbuf, m, v, count, c, step_size, bc2_sqrt, lr);
            // uplink from the UNROUNDED fp32 update (the bf16 state store
            // below rounds; streaming.py's numpy path quantizes the fp32
            // transient before the writeback, so order matters for parity)
            if (mode == 0) {
                uint16_t* sh = shadow + elem_off + e0;
                for (int64_t j = 0; j < count; ++j)
                    dbuf[j] = p[j] - bf16_to_f32(sh[j]);
                quant_block(dbuf, e0, count, up_bits, half, up_codes,
                            up_scales + b, dbuf);
                for (int64_t j = 0; j < count; ++j)
                    sh[j] = f32_to_bf16(bf16_to_f32(sh[j]) + dbuf[j]);
            } else if (rb < 16) {
                quant_block(p, e0, count, up_bits, half, up_codes,
                            up_scales + b, nullptr);
            } else {
                uint16_t* w = out_w + w_off + e0;
                for (int64_t j = 0; j < count; ++j) w[j] = f32_to_bf16(p[j]);
            }
            if (state_bf16) {
                uint16_t* pm = (uint16_t*)master + elem_off + e0;
                uint16_t* mm = (uint16_t*)exp_avg + elem_off + e0;
                uint16_t* vm = (uint16_t*)exp_avg_sq + elem_off + e0;
                for (int64_t j = 0; j < count; ++j) pm[j] = f32_to_bf16(pbuf[j]);
                for (int64_t j = 0; j < count; ++j) mm[j] = f32_to_bf16(mbuf[j]);
                for (int64_t j = 0; j < count; ++j) vm[j] = f32_to_bf16(vbuf[j]);
            }
        }
        elem_off += n;
        g_byte_off += g_leaf_bytes;
        g_scale_off += nb;
        if (mode == 1) {
            if (rb < 16) {
                c_byte_off += rb == 4 ? padded / 2 : padded;
                c_scale_off += nb;
            } else {
                w_off += n;
            }
        }
    }
    delete[] gbuf;
    delete[] pbuf;
    delete[] mbuf;
    delete[] vbuf;
    delete[] dbuf;
    return 0;
}

}  // namespace

extern "C" {

int ds_adam_create(int optimizer_id, float alpha, float beta1, float beta2, float eps,
                   float weight_decay, int adamw_mode, int bias_correction) {
    std::lock_guard<std::mutex> g(g_mu);
    g_optimizers[optimizer_id] = AdamConfig{alpha, beta1, beta2, eps, weight_decay,
                                            adamw_mode != 0, bias_correction != 0};
    return 0;
}

int ds_adam_destroy(int optimizer_id) {
    std::lock_guard<std::mutex> g(g_mu);
    return g_optimizers.erase(optimizer_id) ? 0 : -1;
}

// One Adam step over a flat fp32 shard. Pass negative overrides to keep the
// values given at create time. Returns 0, or -1 for an unknown optimizer id.
int ds_adam_step(int optimizer_id, long long step, float lr, float beta1, float beta2,
                 float eps, float weight_decay, float* params, const float* grads,
                 float* exp_avg, float* exp_avg_sq, long long n) {
    return adam_step_impl(optimizer_id, step, lr, beta1, beta2, eps, weight_decay,
                          params, grads, exp_avg, exp_avg_sq, n, nullptr);
}

// Same, fused with a bf16 copy-back of the updated params (reference:
// adam_update_copy writes the fp16 device copy; here bf16 for TPU upload).
int ds_adam_step_copy_bf16(int optimizer_id, long long step, float lr, float beta1,
                           float beta2, float eps, float weight_decay, float* params,
                           const float* grads, float* exp_avg, float* exp_avg_sq,
                           long long n, unsigned short* bf16_params) {
    return adam_step_impl(optimizer_id, step, lr, beta1, beta2, eps, weight_decay,
                          params, grads, exp_avg, exp_avg_sq, n,
                          (uint16_t*)bf16_params);
}

// Fused streamed-offload chunk step: dequantize the int4/int8 wire grads,
// Adam-update the fp32 master/moments, quantize the (error-fed) param delta
// against the bf16 shadow, and advance the shadow — one pass per wire
// block. Buffers are the CONCATENATED per-leaf wire layout described above;
// leaf_sizes/leaf_bits give the per-leaf geometry. Returns 0; -1 unknown
// optimizer id; -2 unsupported per-leaf wire bits.
int ds_stream_chunk_step(int optimizer_id, long long step, float lr,
                         const unsigned char* g_packed, const float* g_scales,
                         float* master, float* exp_avg, float* exp_avg_sq,
                         unsigned short* shadow, unsigned char* out_packed,
                         float* out_scales, const long long* leaf_sizes,
                         const int* leaf_bits, long long n_leaves, int block) {
    return stream_chunk_step_impl(optimizer_id, step, lr, g_packed, g_scales,
                                  master, exp_avg, exp_avg_sq,
                                  (uint16_t*)shadow, out_packed, out_scales,
                                  (const int64_t*)leaf_sizes, leaf_bits,
                                  n_leaves, block);
}

// Generalized streamed chunk step. `state_bf16` selects uint16 bf16-bits
// state buffers (the 20B host_state='bf16' profile) vs fp32; `mode` 0 is
// the error-fed delta uplink against the bf16 `shadow` (out_packed/
// out_scales in wire geometry), mode 1 the quant-resident uplink
// (out_c/out_s/out_w in streaming._ChunkMeta.res_geometry layout;
// `shadow` unused). Returns 0; -1 unknown optimizer id; -2 unsupported
// leaf precisions (caller falls back to numpy).
int ds_stream_chunk_step2(int optimizer_id, long long step, float lr,
                          const unsigned char* g_packed,
                          const float* g_scales, void* master,
                          void* exp_avg, void* exp_avg_sq, int state_bf16,
                          unsigned short* shadow, unsigned char* out_packed,
                          float* out_scales, unsigned char* out_c,
                          float* out_s, unsigned short* out_w,
                          const long long* leaf_sizes, const int* leaf_bits,
                          const int* res_bits, long long n_leaves, int block,
                          int mode) {
    return stream_chunk_step2_impl(
        optimizer_id, step, lr, g_packed, g_scales, master, exp_avg,
        exp_avg_sq, state_bf16, (uint16_t*)shadow, out_packed, out_scales,
        out_c, out_s, (uint16_t*)out_w, (const int64_t*)leaf_sizes,
        leaf_bits, res_bits, n_leaves, block, mode);
}

// Blocks [b_begin, b_end) of ONE leaf of ds_stream_chunk_step2's pass,
// every pointer at that leaf's base (its wire, scales, state, shadow and
// uplink). The uplink codes are NOT zeroed here: the caller zeroes them
// once, and may then run disjoint block ranges on several threads, except
// that under a 4-bit uplink a block of the leaf's lower half and one of
// its upper half share bytes (streaming.py runs the halves one after the
// other). The bytes are those of ds_stream_chunk_step2 over the whole
// leaf. Returns 0; -1 unknown optimizer id; -2 unsupported precisions.
int ds_stream_blocks_step2(int optimizer_id, long long step, float lr,
                           const unsigned char* g_packed,
                           const float* g_scales, void* master,
                           void* exp_avg, void* exp_avg_sq, int state_bf16,
                           unsigned short* shadow, unsigned char* up_codes,
                           float* up_scales, unsigned short* out_w,
                           long long n, int bits, int res_bits, int block,
                           int mode, long long b_begin, long long b_end) {
    const int64_t size = n;
    // one leaf: its uplink is the wire-shaped delta (mode 0) or the
    // resident codes / words (mode 1) at the leaf's base
    return stream_chunk_step2_impl(
        optimizer_id, step, lr, g_packed, g_scales, master, exp_avg,
        exp_avg_sq, state_bf16, (uint16_t*)shadow, up_codes, up_scales,
        up_codes, up_scales, (uint16_t*)out_w, &size, &bits, &res_bits, 1,
        block, mode, b_begin, b_end, false);
}

// Introspection for ds_report.
const char* ds_adam_simd_width() {
#if defined(__AVX512F__)
    return "avx512";
#elif defined(__AVX2__)
    return "avx2";
#else
    return "scalar";
#endif
}

}  // extern "C"
