// Shared metric math for the port's CUDA kernels: the __device__ twins of
// repro_torch/kernels/metrics_inkernel.py (rank_score, compound_lift).
//
// Bitwise parity with the PyTorch versions rests on two build settings:
// -fmad=false (no multiply-add contraction) and the default IEEE divide
// (no --use_fast_math), so each expression below is the same sequence of
// correctly rounded f32 operations as its torch counterpart.
#pragma once

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

// Eq. 1-4: node lift for single-item consequents, compound confidence over
// the consequent-path Support otherwise (0 when that path is absent).
__device__ __forceinline__ float compound_lift(bool found, bool single,
                                               float node_lift, float conf,
                                               float con_support) {
    if (!found) return 0.0f;
    if (single) return node_lift;
    return con_support > 0.0f ? __fdiv_rn(conf, con_support) : 0.0f;
}
