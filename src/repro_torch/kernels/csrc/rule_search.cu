// Rule-search kernels: the fused CSR search of the plain layout, and the
// span search of the path-compressed layout.
//
// Fused rule-search kernel.
//
// Replaces the TPU kernel repro/kernels/rule_search.py::rule_search_fused_pallas:
// for each canonical query row (int32 items, -1 padding) it walks the trie
// from the root, one CSR bucket [co[n], co[n+1]) per item, keeps the
// compound confidence (product over the consequent steps), the final node's
// support and lift, and in the same pass walks the consequent items alone
// from the root for the consequent-path Support; then it selects the
// Eq. 1-4 compound lift in-kernel (metrics.cuh).
//
// What bounds it here: memory latency.  A row's work is a chain of
// dependent loads (offsets, then a binary search in the bucket, then the
// child id), two walks of L steps each; the bytes and flops are tiny.  So
// the kernel runs one thread per row, enough rows per block to keep many
// chains in flight, and reads each step's edge only once it is found.  The
// TPU kernel scans the whole bucket in block_f-lane chunks and max-reduces
// the match; because the items of a bucket are distinct and sorted
// (csr_offsets_from_edges), a binary search finds the same edge, and hub
// buckets (the 256-wide root) cost log2(256) = 8 probes, not a chunked sweep.
#include "metrics.cuh"

#define RS_THREADS 128

// Edge index of `item` in node's bucket, -1 if absent.
__device__ __forceinline__ int bucket_find(const int* __restrict__ co,
                                           const int* __restrict__ ei,
                                           int node, int item) {
    int lo = co[node], hi = co[node + 1];
    while (lo < hi) {
        int mid = (lo + hi) >> 1;
        if (ei[mid] < item) lo = mid + 1; else hi = mid;
    }
    return (lo < co[node + 1] && ei[lo] == item) ? lo : -1;
}

__global__ void __launch_bounds__(RS_THREADS)
rule_search_fused_kernel(const int* __restrict__ co, const int* __restrict__ ei,
                         const int* __restrict__ ec,
                         const float* __restrict__ econf,
                         const float* __restrict__ esup,
                         const float* __restrict__ elift,
                         const int* __restrict__ queries,
                         const int* __restrict__ ant_len, int q, int width,
                         int* __restrict__ node_out, int* __restrict__ found_out,
                         float* __restrict__ conf_out, float* __restrict__ sup_out,
                         float* __restrict__ lift_out,
                         float* __restrict__ csup_out) {
    int r = blockIdx.x * RS_THREADS + threadIdx.x;
    if (r >= q) return;
    const int* row = queries + (long long)r * width;
    const int al = ant_len[r];

    int node = 0, cnode = 0, seq_len = 0;
    bool ok = true, cok = true;
    float conf = 1.0f, sup = 0.0f, nlift = 0.0f, csup = 0.0f;
    for (int s = 0; s < width; ++s) {
        int item = row[s];
        if (item < 0) continue;
        ++seq_len;
        bool in_cons = s >= al;
        if (ok) {
            int j = bucket_find(co, ei, node, item);
            if (j >= 0) {
                node = ec[j];
                if (in_cons) conf = __fmul_rn(conf, econf[j]);
                sup = esup[j];
                nlift = elift[j];
            } else {
                ok = false;
            }
        }
        if (in_cons && cok) {
            int j = bucket_find(co, ei, cnode, item);
            if (j >= 0) {
                cnode = ec[j];
                csup = esup[j];
            } else {
                cok = false;
            }
        }
    }
    bool found = ok && node > 0;
    float con_sup = (cok && cnode > 0) ? csup : 0.0f;
    float fconf = found ? conf : 0.0f;
    node_out[r] = found ? node : -1;
    found_out[r] = found ? 1 : 0;
    conf_out[r] = fconf;
    sup_out[r] = found ? sup : 0.0f;
    lift_out[r] = compound_lift(found, seq_len - al == 1,
                                found ? nlift : 0.0f, fconf, con_sup);
    csup_out[r] = con_sup;
}

extern "C" int rule_search_fused_launch(
    const int* co, const int* edge_item, const int* edge_child,
    const float* edge_conf, const float* edge_sup, const float* edge_lift,
    const int* queries, const int* ant_len, int q, int width, int* node,
    int* found, float* conf, float* sup, float* lift, float* con_sup,
    void* stream) {
    int blocks = (q + RS_THREADS - 1) / RS_THREADS;
    rule_search_fused_kernel<<<blocks, RS_THREADS, 0, (cudaStream_t)stream>>>(
        co, edge_item, edge_child, edge_conf, edge_sup, edge_lift, queries,
        ant_len, q, width, node, found, conf, sup, lift, con_sup);
    return (int)cudaGetLastError();
}

// Span rule-search kernel (the path-compressed layout).
//
// Replaces the TPU kernel repro/kernels/rule_search.py::rule_search_span_pallas:
// the same two walks per query row (the full path, and the consequent items
// alone from the root) over the compressed layout, where every maximal
// single-child run is a contiguous DFS interval and only run heads, tails
// and branching nodes keep a CSR row.  Per walk the state is (pos, rem,
// ctail): the DFS position reached, the span steps left before the next CSR
// node, and the compressed id of the run's tail.  Inside a span (rem > 0)
// a step is one gather, node_item[pos + 1]; at a CSR node it is bucket_find
// over child_offsets[ctail]..[ctail + 1] on edge_item, then three gathers
// (edge_pos, edge_span, edge_tail).  A compressed bucket is item-sorted
// and item-unique (compress_pos_space sorts it by (parent, item)), so the
// binary search finds the edge the TPU kernel's masked max over block_f
// lanes finds.  The metric columns are indexed by DFS position and arrive
// in their storage types (f32, int32 counts or bf16 support; f32, bf16 or
// int8 confidence and lift), widened per gather (metrics.cuh).  The
// confidence product runs over the consequent steps; Eq. 1-4 lift is
// selected in-kernel.  Outputs: found, pos (a DFS position, -1 when
// absent), conf, sup, lift and con_support.
//
// What bounds it here: memory latency, as in the fused kernel: a chain of
// dependent gathers per row (about 2 x width), one thread per row.  The
// TPU knob span_bf sized the VMEM lanes of the bucket scan; a binary search
// has no such width, so it is not carried over.
struct SpanState {
    int pos, rem, ctail;
};

// One item of the span-aware descent; false (state unchanged) on a miss.
__device__ __forceinline__ bool span_step(
    SpanState& st, int item, const int* __restrict__ co,
    const int* __restrict__ ei, const int* __restrict__ epos,
    const int* __restrict__ espan, const int* __restrict__ etail,
    const int* __restrict__ node_item) {
    if (st.rem > 0) {
        if (node_item[st.pos + 1] != item) return false;
        ++st.pos;
        --st.rem;
        return true;
    }
    int j = bucket_find(co, ei, st.ctail, item);
    if (j < 0) return false;
    st.pos = epos[j];
    st.rem = espan[j];
    st.ctail = etail[j];
    return true;
}

template <class S, class C>
__global__ void __launch_bounds__(RS_THREADS)
rule_search_span_kernel(const int* __restrict__ co, const int* __restrict__ ei,
                        const int* __restrict__ epos,
                        const int* __restrict__ espan,
                        const int* __restrict__ etail,
                        const int* __restrict__ node_item,
                        const S* __restrict__ sup, const C* __restrict__ conf,
                        const C* __restrict__ lift, float inv_n,
                        float conf_scale, float lift_scale,
                        const int* __restrict__ queries,
                        const int* __restrict__ ant_len, int q, int width,
                        int* __restrict__ pos_out, int* __restrict__ found_out,
                        float* __restrict__ conf_out,
                        float* __restrict__ sup_out,
                        float* __restrict__ lift_out,
                        float* __restrict__ csup_out) {
    int r = blockIdx.x * RS_THREADS + threadIdx.x;
    if (r >= q) return;
    const int* row = queries + (long long)r * width;
    const int al = ant_len[r];

    SpanState st{0, 0, 0}, cst{0, 0, 0};
    bool ok = true, cok = true;
    int seq_len = 0;
    float cf = 1.0f;
    for (int s = 0; s < width; ++s) {
        int item = row[s];
        if (item < 0) continue;
        ++seq_len;
        bool in_cons = s >= al;
        if (ok) {
            ok = span_step(st, item, co, ei, epos, espan, etail, node_item);
            if (ok && in_cons)
                cf = __fmul_rn(cf, dequantize(conf[st.pos], conf_scale));
        }
        if (in_cons && cok)
            cok = span_step(cst, item, co, ei, epos, espan, etail, node_item);
    }
    bool found = ok && st.pos > 0;
    float con_sup =
        (cok && cst.pos > 0) ? dequantize(sup[cst.pos], inv_n) : 0.0f;
    float fconf = found ? cf : 0.0f;
    float nlift = found ? dequantize(lift[st.pos], lift_scale) : 0.0f;
    pos_out[r] = found ? st.pos : -1;
    found_out[r] = found ? 1 : 0;
    conf_out[r] = fconf;
    sup_out[r] = found ? dequantize(sup[st.pos], inv_n) : 0.0f;
    lift_out[r] = compound_lift(found, seq_len - al == 1, nlift, fconf,
                                con_sup);
    csup_out[r] = con_sup;
}

struct SpanArgs {
    const int *co, *edge_item, *edge_pos, *edge_span, *edge_tail, *node_item;
    const void *sup, *conf, *lift;
    float inv_n, conf_scale, lift_scale;
    const int *queries, *ant_len;
    int q, width;
    int *pos, *found;
    float *conf_out, *sup_out, *lift_out, *csup_out;
};

template <class S, class C>
static cudaError_t launch_span_typed(const SpanArgs& a, cudaStream_t stream) {
    int blocks = (a.q + RS_THREADS - 1) / RS_THREADS;
    rule_search_span_kernel<S, C><<<blocks, RS_THREADS, 0, stream>>>(
        a.co, a.edge_item, a.edge_pos, a.edge_span, a.edge_tail, a.node_item,
        (const S*)a.sup, (const C*)a.conf, (const C*)a.lift, a.inv_n,
        a.conf_scale, a.lift_scale, a.queries, a.ant_len, a.q, a.width,
        a.pos, a.found, a.conf_out, a.sup_out, a.lift_out, a.csup_out);
    return cudaGetLastError();
}

extern "C" int rule_search_span_launch(
    const int* co, const int* edge_item, const int* edge_pos,
    const int* edge_span, const int* edge_tail, const int* node_item,
    const void* sup, const void* conf, const void* lift, int sup_type,
    int col_type, float inv_n, float conf_scale, float lift_scale,
    const int* queries, const int* ant_len, int q, int width, int* pos,
    int* found, float* conf_out, float* sup_out, float* lift_out,
    float* con_sup, void* stream) {
    SpanArgs a{co, edge_item, edge_pos, edge_span, edge_tail, node_item,
               sup, conf, lift, inv_n, conf_scale, lift_scale, queries,
               ant_len, q, width, pos, found, conf_out, sup_out, lift_out,
               con_sup};
    cudaStream_t s = (cudaStream_t)stream;
    RT_DISPATCH_COLUMNS(sup_type, col_type, launch_span_typed, a, s)
}
