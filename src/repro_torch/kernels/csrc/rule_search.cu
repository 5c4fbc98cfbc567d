// Rule-search kernels: the fused CSR search of the plain layout, the span
// search of the path-compressed layout, and the full sweep of the seed
// layout (no CSR offsets).
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

// Full-sweep rule-search kernels (the seed layout, no CSR offsets).
//
// They replace the TPU kernel
// repro/kernels/rule_search.py::rule_search_pallas: at every column s of a
// query row (int32 items, -1 padding) the row's (node, item) is compared
// with EVERY edge of the (parent, item) table;
// over the matching edges it takes the max child (-1 when none) and,
// independently, the max of each edge metric (0 when none; NaN when a
// matched value is NaN), then advances the row on a hit.  It keeps the max
// over matches, so a table that repeats a (parent, item) pair answers as
// the reference does, and it stays the O(active row-steps x E) baseline
// the fused search is measured against.  Outputs are node metrics only:
// found, node (-1 when absent), the confidence product over the steps at
// or past ant_len, the final node's support and node_lift.  Compound lift
// needs a second call over the consequent columns (kernels/ops.py).
//
// What bounds it here: integer compares, one per edge per active
// row-step, at 64 a clock per SM.  The design
// (ref.rule_search_sweep_split_ref runs it in plain PyTorch):
// - sweep_fingerprint_kernel, once a call: a 32-bit fingerprint of every
//   edge's (parent, item) pair (sweep_fp), so that a compare is one
//   32-bit equality; the table pads to whole 128-edge chunks.
// - per step s, sweep_advance_kernel: applies step s - 1's merged matches
//   to the rows that were active in it, then compacts the rows active at
//   s (still on the trie, an item in column s) into a dense list with
//   their (node, item) and fingerprint.  Dead rows, padding rows and blank
//   columns take no compares.  Launched once more after the last step to
//   write the outputs.
// - per step s, sweep_match_kernel: the list in tiles of SW_R rows, each
//   tile against every chunk of the table; the (tile, chunk) units split
//   evenly over a fixed grid of warps, so every warp does the same work
//   whatever the step's active count; a warp's share is one or two
//   (tile, chunk range) segments, more when it passes whole tiles.  A
//   warp holds its tile's SW_R row fingerprints in registers and every
//   lane reads its own 4 edge
//   fingerprints a chunk (one coalesced 16-byte load): 4 x SW_R compares
//   per load, one ISETP.EQ.OR each into four predicate chains.  Only a
//   lane with a chain set looks again (rare: about one true match per
//   row-step, and a fingerprint collision per 2^32 compares), finds the
//   (edge, row) pairs whose fingerprints agree, checks the exact 64-bit
//   pair, and merges a true match into the row's slots with atomicMax on
//   an order-free key (metric_key), so the merge of warps and splits gives
//   the same bits in any order.
// No host read and no sync: the grids follow from Q, width and E
// (rule_search.sweep_launch_shape), and a match launch reads its step's
// count from the device.
#define SW_R 32                    // rows a warp holds (tile)
#define SW_LANE_EDGES 4            // edge fingerprints a lane reads at once
#define SW_CHUNK (32 * SW_LANE_EDGES)  // edges a warp reads at once
#define SW_THREADS 256             // match block: 8 warps
#define SW_BLOCKS_PER_SM 4         // match blocks resident on an SM
#define SW_STEP_THREADS 256        // advance block
#define SW_CANON_NAN 0x7fc00000

// 32-bit fingerprint of a (parent, item) pair (ref.sweep_fingerprint_ref):
// a multiply-add, then murmur3's finalizer, a bijection of 32 bits
__device__ __forceinline__ unsigned sweep_fp(int parent, int item) {
    unsigned h = (unsigned)parent * 0x9E3779B1u + (unsigned)item;
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    h ^= h >> 16;
    return h;
}

// The order-free key of a metric value (ref.metric_key_ref): the bits of
// a value above 0, the canonical quiet NaN for any NaN, else 0 (+0.0, the
// fill).  Keys order as the values do, so atomicMax on keys is the
// NaN-propagating max over {0.0} and the matched values, and the key IS
// the answer's bits.
__device__ __forceinline__ int metric_key(float v) {
    return v != v ? SW_CANON_NAN : (v > 0.0f ? __float_as_int(v) : 0);
}

// Scratch of one call, int32 words (rule_search.sweep_launch_shape):
// the edge fingerprints, padded to whole chunks, then per step its active
// count, then per row its pending flag (active in the step just swept),
// its match slots (child and the three metric keys), and the active list
// (row, node, item, fingerprint).
struct SweepScratch {
    unsigned* fp;
    int *count, *pend, *child, *kconf, *ksup, *klift;
    int *act_row, *act_node, *act_item;
    unsigned* act_fp;
};

static SweepScratch sweep_scratch(int* words, int q, int width,
                                  int n_chunks) {
    SweepScratch s;
    long long off = (long long)n_chunks * SW_CHUNK;
    s.fp = (unsigned*)words;
    s.count = words + off;
    off += (width + 3) / 4 * 4;
    int** rows[] = {&s.pend, &s.child, &s.kconf, &s.ksup, &s.klift,
                    &s.act_row, &s.act_node, &s.act_item};
    for (int** p : rows) {
        *p = words + off;
        off += q;
    }
    s.act_fp = (unsigned*)(words + off);
    return s;
}

__global__ void __launch_bounds__(SW_STEP_THREADS)
sweep_fingerprint_kernel(const int* __restrict__ ep,
                         const int* __restrict__ ei, int e, int n_pad,
                         int width, SweepScratch sc) {
    int j = blockIdx.x * SW_STEP_THREADS + threadIdx.x;
    // a padding slot's fingerprint may agree with a row's; the exact check
    // (j < e) rejects it
    if (j < n_pad) sc.fp[j] = j < e ? sweep_fp(ep[j], ei[j]) : 0u;
    if (j < width) sc.count[j] = 0;
}

__global__ void __launch_bounds__(SW_STEP_THREADS)
sweep_advance_kernel(const int* __restrict__ queries,
                     const int* __restrict__ ant_len, int q, int width,
                     int s, SweepScratch sc, int* __restrict__ node_out,
                     int* __restrict__ found_out, float* __restrict__ conf_out,
                     float* __restrict__ sup_out,
                     float* __restrict__ lift_out) {
    const int r = blockIdx.x * SW_STEP_THREADS + threadIdx.x;
    const int lane = threadIdx.x & 31;
    bool active = false;
    int node = 0, item = -1;
    if (r < q) {
        // the row state lives in the outputs until the last launch
        bool ok = true;
        float conf = 1.0f, sup = 0.0f, nlift = 0.0f;
        if (s > 0) {
            node = node_out[r];
            ok = found_out[r] != 0;
            conf = conf_out[r];
            sup = sup_out[r];
            nlift = lift_out[r];
            if (sc.pend[r]) {
                const int child = sc.child[r];
                ok = child >= 0;
                if (ok) {
                    node = child;
                    if (s - 1 >= ant_len[r])
                        conf = __fmul_rn(conf, __int_as_float(sc.kconf[r]));
                    sup = __int_as_float(sc.ksup[r]);
                    nlift = __int_as_float(sc.klift[r]);
                }
            }
        }
        if (s < width) {
            item = queries[(long long)r * width + s];
            active = ok && item >= 0;
            sc.pend[r] = active;
            if (active) {
                sc.child[r] = -1;
                sc.kconf[r] = sc.ksup[r] = sc.klift[r] = 0;
            }
            node_out[r] = node;
            found_out[r] = ok;
            conf_out[r] = conf;
            sup_out[r] = sup;
            lift_out[r] = nlift;
        } else {
            const bool found = ok && node > 0;
            node_out[r] = found ? node : -1;
            found_out[r] = found;
            conf_out[r] = found ? conf : 0.0f;
            sup_out[r] = found ? sup : 0.0f;
            lift_out[r] = found ? nlift : 0.0f;
        }
    }
    // the warp's active rows take consecutive list slots (the list's order
    // does not reach the answer: the merge is order-free)
    const unsigned mask = __ballot_sync(0xffffffffu, active);
    if (!mask) return;
    const int leader = __ffs(mask) - 1;
    int base = 0;
    if (lane == leader) base = atomicAdd(sc.count + s, __popc(mask));
    base = __shfl_sync(0xffffffffu, base, leader);
    if (active) {
        const int pos = base + __popc(mask & ((1u << lane) - 1u));
        sc.act_row[pos] = r;
        sc.act_node[pos] = node;
        sc.act_item[pos] = item;
        sc.act_fp[pos] = sweep_fp(node, item);
    }
}

// The rows of a tile whose fingerprint equals `f` (bit i: row base + i).
__device__ __forceinline__ unsigned fp_rows(unsigned f,
                                            const unsigned (&rf)[SW_R]) {
    unsigned m = 0;
#pragma unroll
    for (int i = 0; i < SW_R; ++i) m |= (unsigned)(f == rf[i]) << i;
    return m;
}

// A lane's fingerprint hits in edge x: the exact pair check, and a true
// match merged into the row's slots.
__device__ __forceinline__ void sweep_merge(
    unsigned m, int x, int e, int base, const int* __restrict__ ep,
    const int* __restrict__ ei, const int* __restrict__ ec,
    const float* __restrict__ econf, const float* __restrict__ esup,
    const float* __restrict__ elift, const SweepScratch& sc) {
    if (x >= e) return;
    const int p = ep[x], it = ei[x];
    while (m) {
        const int a = base + __ffs(m) - 1;
        m &= m - 1;
        if (sc.act_node[a] != p || sc.act_item[a] != it) continue;
        const int row = sc.act_row[a];
        atomicMax(sc.child + row, ec[x]);
        atomicMax(sc.kconf + row, metric_key(econf[x]));
        atomicMax(sc.ksup + row, metric_key(esup[x]));
        atomicMax(sc.klift + row, metric_key(elift[x]));
    }
}

__global__ void __launch_bounds__(SW_THREADS, SW_BLOCKS_PER_SM)
sweep_match_kernel(const int* __restrict__ ep, const int* __restrict__ ei,
                   const int* __restrict__ ec,
                   const float* __restrict__ econf,
                   const float* __restrict__ esup,
                   const float* __restrict__ elift, int e, int n_chunks,
                   int s, SweepScratch sc) {
    const int n = sc.count[s];
    if (n == 0) return;
    const int lane = threadIdx.x & 31;
    const long long n_tiles = (n + SW_R - 1) / SW_R;
    const long long total = n_tiles * n_chunks;
    const long long warps = (long long)gridDim.x * (SW_THREADS / 32);
    const long long gw =
        (long long)blockIdx.x * (SW_THREADS / 32) + (threadIdx.x >> 5);
    const long long per = (total + warps - 1) / warps;
    long long u = gw * per;
    const long long u_end = min(total, u + per);
    const uint4* fp4 = reinterpret_cast<const uint4*>(sc.fp);
    while (u < u_end) {
        const int t = (int)(u / n_chunks);
        const int c0 = (int)(u - (long long)t * n_chunks);
        const int c1 = (int)min((long long)n_chunks, c0 + (u_end - u));
        u += c1 - c0;
        // the tile's row fingerprints; a short last tile repeats its last
        // row, whose hits the exact check then finds once
        const int base = t * SW_R;
        const int rows = min(SW_R, n - base);
        unsigned rf[SW_R];
#pragma unroll
        for (int i = 0; i < SW_R; ++i)
            rf[i] = sc.act_fp[base + min(i, rows - 1)];
        uint4 next = __ldg(fp4 + (long long)c0 * 32 + lane);
        for (int c = c0; c < c1; ++c) {
            const uint4 f = next;
            if (c + 1 < c1) next = __ldg(fp4 + (long long)(c + 1) * 32 + lane);
            // one compare instruction each: four predicate chains, one
            // per edge, or-ed over the tile's rows
            bool a0 = false, a1 = false, a2 = false, a3 = false;
#pragma unroll
            for (int i = 0; i < SW_R; ++i) {
                a0 |= f.x == rf[i];
                a1 |= f.y == rf[i];
                a2 |= f.z == rf[i];
                a3 |= f.w == rf[i];
            }
            if (a0 | a1 | a2 | a3) {
                // opaque copies, so that the row masks are made here, on
                // a hit, and not folded into the compare chains above
                unsigned fs[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
                for (int k = 0; k < 4; ++k) asm volatile("" : "+r"(fs[k]));
                const unsigned keep = rows == SW_R ? 0xffffffffu
                                                   : (1u << rows) - 1u;
                const int x = c * SW_CHUNK + lane * SW_LANE_EDGES;
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    const unsigned m = fp_rows(fs[k], rf) & keep;
                    if (m)
                        sweep_merge(m, x + k, e, base, ep, ei, ec, econf,
                                    esup, elift, sc);
                }
            }
        }
    }
}

extern "C" int rule_search_sweep_launch(
    const int* edge_parent, const int* edge_item, const int* edge_child,
    const float* edge_conf, const float* edge_sup, const float* edge_lift,
    int e, const int* queries, const int* ant_len, int q, int width,
    int n_chunks, int match_blocks, int* scratch, int* node, int* found,
    float* conf, float* sup, float* node_lift, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const SweepScratch sc = sweep_scratch(scratch, q, width, n_chunks);
    const int n_pad = n_chunks * SW_CHUNK;
    const int fp_blocks =
        ((n_pad > width ? n_pad : width) + SW_STEP_THREADS - 1) /
        SW_STEP_THREADS;
    const int row_blocks = (q + SW_STEP_THREADS - 1) / SW_STEP_THREADS;
    sweep_fingerprint_kernel<<<fp_blocks, SW_STEP_THREADS, 0, st>>>(
        edge_parent, edge_item, e, n_pad, width, sc);
    cudaError_t err = cudaGetLastError();
    for (int s = 0; s <= width && err == cudaSuccess; ++s) {
        sweep_advance_kernel<<<row_blocks, SW_STEP_THREADS, 0, st>>>(
            queries, ant_len, q, width, s, sc, node, found, conf, sup,
            node_lift);
        err = cudaGetLastError();
        if (s == width || err != cudaSuccess) break;
        sweep_match_kernel<<<match_blocks, SW_THREADS, 0, st>>>(
            edge_parent, edge_item, edge_child, edge_conf, edge_sup,
            edge_lift, e, n_chunks, s, sc);
        err = cudaGetLastError();
    }
    return (int)err;
}
