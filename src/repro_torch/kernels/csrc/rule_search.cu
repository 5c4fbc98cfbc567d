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
