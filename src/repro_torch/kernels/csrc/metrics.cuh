// Shared metric math for the port's CUDA kernels: the __device__ twins of
// repro_torch/kernels/metrics_inkernel.py (rank_score, compound_lift and
// dequantize_metrics).
//
// Bitwise parity with the PyTorch versions rests on two build settings:
// -fmad=false (no multiply-add contraction) and the default IEEE divide
// (no --use_fast_math), so each expression below is the same sequence of
// correctly rounded f32 operations as its torch counterpart.
#pragma once

#include <cuda_runtime.h>

#define RT_CONVICTION_CAP 1e30f

// Metric ids follow metrics_inkernel.RANK_METRICS.
enum RankMetric {
    RT_SUPPORT = 0,
    RT_CONFIDENCE = 1,
    RT_LIFT = 2,
    RT_LEVERAGE = 3,
    RT_CONVICTION = 4,
};

__device__ __forceinline__ float rank_score(int metric, float s, float c,
                                            float l) {
    switch (metric) {
        case RT_SUPPORT:
            return s;
        case RT_CONFIDENCE:
            return c;
        case RT_LIFT:
            return l;
        case RT_LEVERAGE: {
            if (!(l > 0.0f)) return 0.0f;
            return __fsub_rn(s, __fdiv_rn(s, l));
        }
        default: {  // RT_CONVICTION
            if (!(l > 0.0f)) return 0.0f;
            if (!(c < 1.0f)) return RT_CONVICTION_CAP;
            float sup_c = __fdiv_rn(c, l);
            return __fdiv_rn(__fsub_rn(1.0f, sup_c), __fsub_rn(1.0f, c));
        }
    }
}

// The node columns a score reads (metrics_inkernel.METRIC_COLUMNS); a
// score pass loads these and no other.
__device__ __forceinline__ bool metric_reads_support(int metric) {
    return metric == RT_SUPPORT || metric == RT_LEVERAGE;
}
__device__ __forceinline__ bool metric_reads_confidence(int metric) {
    return metric == RT_CONFIDENCE || metric == RT_CONVICTION;
}
__device__ __forceinline__ bool metric_reads_lift(int metric) {
    return metric == RT_LIFT || metric == RT_LEVERAGE ||
           metric == RT_CONVICTION;
}

// Eq. 1-4: node lift for single-item consequents, compound confidence over
// the consequent-path Support otherwise (0 when that path is absent).
__device__ __forceinline__ float compound_lift(bool found, bool single,
                                               float node_lift, float conf,
                                               float con_support) {
    if (!found) return 0.0f;
    if (single) return node_lift;
    return con_support > 0.0f ? __fdiv_rn(conf, con_support) : 0.0f;
}

// ---------------------------------------------------------------------
// Quantized metric columns (the compressed layout).  A column arrives in
// its storage type and widens to f32 per element, in registers, with the
// arithmetic of metrics_inkernel.dequantize_metrics:
//   f32                          as stored
//   int32 support (tx counts)    count * inv_n, inv_n = f32(1 / max(n, 1))
//   bf16 (its 16 bits)           exact widening
//   int8 (quantize_int8 codes)   q * scale
// `scale` is inv_n for a support column and the column's int8 scale
// otherwise; the f32 and bf16 forms ignore it.
typedef unsigned short rt_bf16;  // bf16 bit pattern

// Storage type codes, as the wrappers pass them (metrics_inkernel.py).
enum RtSupportType { RT_SUP_F32 = 0, RT_SUP_I32 = 1, RT_SUP_BF16 = 2 };
enum RtColumnType { RT_COL_F32 = 0, RT_COL_BF16 = 1, RT_COL_I8 = 2 };

__device__ __forceinline__ float dequantize(float x, float) { return x; }
__device__ __forceinline__ float dequantize(rt_bf16 bits, float) {
    return __uint_as_float((unsigned int)bits << 16);
}
__device__ __forceinline__ float dequantize(signed char q, float scale) {
    return __fmul_rn((float)q, scale);
}
__device__ __forceinline__ float dequantize(int count, float inv_n) {
    return __fmul_rn(__int2float_rn(count), inv_n);
}

// Expands to a switch that returns FN<S, C>(...) for the support storage
// type S named by sup_type and the confidence/lift storage type C named
// by col_type: only the five pairs core.array_trie's
// quantize_metric_columns makes (metrics_inkernel.STORAGE_PAIRS), else
// cudaErrorInvalidValue.
#define RT_CASE_COLUMNS(sup_code, S, col_code, C, FN, ...) \
    case (sup_code) * 3 + (col_code):                      \
        return FN<S, C>(__VA_ARGS__);
#define RT_DISPATCH_COLUMNS(sup_type, col_type, FN, ...)                     \
    switch ((sup_type) * 3 + (col_type)) {                                   \
        RT_CASE_COLUMNS(RT_SUP_F32, float, RT_COL_F32, float, FN,            \
                        __VA_ARGS__)                                         \
        RT_CASE_COLUMNS(RT_SUP_I32, int, RT_COL_BF16, rt_bf16, FN,           \
                        __VA_ARGS__)                                         \
        RT_CASE_COLUMNS(RT_SUP_I32, int, RT_COL_I8, signed char, FN,         \
                        __VA_ARGS__)                                         \
        RT_CASE_COLUMNS(RT_SUP_BF16, rt_bf16, RT_COL_BF16, rt_bf16, FN,      \
                        __VA_ARGS__)                                         \
        RT_CASE_COLUMNS(RT_SUP_BF16, rt_bf16, RT_COL_I8, signed char, FN,    \
                        __VA_ARGS__)                                         \
        default:                                                             \
            return cudaErrorInvalidValue;                                    \
    }
