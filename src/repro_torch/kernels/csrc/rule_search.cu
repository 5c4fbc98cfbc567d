// Rule-search kernels: the fused CSR search of the plain layout, the span
// search of the path-compressed layout, and the full sweep of the seed
// layout (no CSR offsets).
//
// The two descent searches (fused and span) share one design.
//
// What bounds them here: memory latency.  A walk is a chain of dependent
// loads (a node's bucket bounds, its items, then the found edge's child),
// and a row runs two walks: the full path, and its consequent items alone
// from the root.  The bytes and flops are tiny, so the time is the longest
// chain times a load's latency.  The design cuts the chain:
// - a group of RS_GROUP lanes runs one walk.  Per step every lane reads
//   the bucket bounds co[node], co[node + 1] (one round), then the group
//   reads the bucket's items in one round of 16-byte loads, 4 a lane
//   (group_find), and finds the item by a ballot; a bucket wider than one
//   round covers takes pivot rounds first.  Buckets are item-sorted and
//   item-unique (csr_offsets_from_edges; compress_pos_space for the
//   compressed layout), so the first equal item is the edge the binary
//   search of the earlier design (and of the plain version) finds.  The
//   found edge's child and metric columns load together, in one round.
// - the two walks of a row run at once, in two groups of one block; they
//   meet at the end, through shared memory, for the Eq. 1-4 compound lift
//   (metrics.cuh).  The row's chain is the longer walk, not the sum.
// - every walk starts at the root: each block stages the table's first
//   RS_ROOT_CAP edges (the root's bucket, when the root's edges start the
//   table and fit) in shared memory, in the round that reads the row, so
//   a walk's first step reads no device memory.
// - a confidence factor loads beside the step that finds it and is
//   multiplied in at the next step, after that step's loads are issued:
//   the product stays in order (__fmul_rn, left to right over the
//   consequent steps) and off the chain.
// ref.rule_search_fused_group_ref and ref.rule_search_span_group_ref run
// the design in plain PyTorch and count each walk's rounds.
#include <stdint.h>

#include "metrics.cuh"

#define RS_GROUP 8                        // lanes of one walk
#define RS_ROUND (4 * RS_GROUP)           // items a round of int4 loads reads
#define RS_SLICE (RS_ROUND - 3)           // items it covers at any alignment
#define RS_THREADS 256                    // block
#define RS_WALKS (RS_THREADS / RS_GROUP)  // walks a block runs
#define RS_ROWS (RS_WALKS / 2)            // rows a block runs
#define RS_ROOT_CAP 256                   // root edges staged per block

// The lanes of this thread's walk in its warp, and its lane among them.
struct Group {
    unsigned mask;
    int lane, shift;  // lane in the group; warp lane of the group's lane 0
};

__device__ __forceinline__ Group this_group() {
    const int wl = threadIdx.x & 31;
    Group g;
    g.lane = wl % RS_GROUP;
    g.shift = wl - g.lane;
    g.mask = (unsigned)((1ull << RS_GROUP) - 1ull) << g.shift;
    return g;
}

// The group's lanes whose `p` holds, as bits at their warp lanes.
__device__ __forceinline__ unsigned group_ballot(const Group& g, bool p) {
    return __ballot_sync(g.mask, p) & g.mask;
}

// The warp lane of the n-th (from 0) set bit of m; n < __popc(m).
__device__ __forceinline__ int nth_bit(unsigned m, int n) {
    int at = 0;
#pragma unroll
    for (int w = 16; w; w >>= 1) {
        const unsigned low = m & ((1u << w) - 1u);
        const int c = __popc(low);
        if (n >= c) {
            n -= c;
            m >>= w;
            at += w;
        } else {
            m = low;
        }
    }
    return at;
}

// The first index i in [a, b) with items[i] == item, -1 if none (the
// range item-sorted; the same answer in every lane of the group).  While
// the range is wider than a round covers, a pivot round reads RS_ROUND
// pivots s apart (s = ceil(n / (RS_ROUND + 1)), 4 a lane) and keeps the
// s-wide slice after the last pivot below `item`: two rounds up to about
// RS_ROUND^2 items, a third past that.  Then one round of 16-byte loads
// from the aligned word at or below a reads the range; lanes whose word
// misses [a, b) load nothing, and items outside it are masked.  `items`
// is a device or a shared-memory array.
__device__ __forceinline__ int group_find(const Group& g,
                                          const int* __restrict__ items,
                                          int a, int b, int item) {
    while (b - a > RS_SLICE) {
        const int s = (b - a + RS_ROUND) / (RS_ROUND + 1);
        int below = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const int x = min(a + (g.lane * 4 + k + 1) * s - 1, b - 1);
            below += items[x] < item;
        }
        const int cnt = __reduce_add_sync(g.mask, below);
        const int a2 = min(a + cnt * s, b);
        b = min(a + (cnt + 1) * s, b);
        a = a2;
    }
    const int4* word = reinterpret_cast<const int4*>(
                           reinterpret_cast<uintptr_t>(items + a) &
                           ~(uintptr_t)15) +
                       g.lane;
    const long long i0 = reinterpret_cast<const int*>(word) - items;
    unsigned hit = 0;
    if (i0 < b && i0 + 4 > a) {
        const int4 v = *word;
        const int vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int k = 0; k < 4; ++k)
            hit |= (unsigned)(vs[k] == item && i0 + k >= a && i0 + k < b)
                   << k;
    }
    const unsigned lanes = group_ballot(g, hit != 0);
    if (!lanes) return -1;
    return __shfl_sync(g.mask, (int)i0 + __ffs(hit) - 1, __ffs(lanes) - 1);
}

// A walk's place in the launch: its row, which walk it is (the consequent
// walk when `cons`), and its row's slot in the block.
struct Walk {
    int row, slot;
    bool cons, live;
};

__device__ __forceinline__ Walk this_walk(int q) {
    const int w = threadIdx.x / RS_GROUP;
    Walk k;
    k.slot = w >> 1;
    k.row = blockIdx.x * RS_ROWS + k.slot;
    k.cons = w & 1;
    k.live = k.row < q;
    return k;
}

// The row's column c0 + lane (-1 past the width or for a dead row).
__device__ __forceinline__ int row_item(const int* __restrict__ queries,
                                        const Walk& k, const Group& g,
                                        int width, int c0) {
    const int c = c0 + g.lane;
    return k.live && c < width ? queries[(long long)k.row * width + c] : -1;
}

// Fused rule-search kernel.
//
// Replaces the TPU kernel repro/kernels/rule_search.py::rule_search_fused_pallas:
// for each canonical query row (int32 items, -1 padding) it walks the trie
// from the root, one CSR bucket [co[n], co[n+1]) per item, keeps the
// compound confidence (product over the consequent steps), the final node's
// support and lift, and, in the other walk, the consequent items alone from
// the root for the consequent-path Support; then it selects the Eq. 1-4
// compound lift in-kernel.  The TPU kernel scans the whole bucket in
// block_f-lane chunks and max-reduces the match; the group's rounds find
// the same edge.
__global__ void __launch_bounds__(RS_THREADS)
rule_search_fused_kernel(const int* __restrict__ co, const int* __restrict__ ei,
                         const int* __restrict__ ec,
                         const float* __restrict__ econf,
                         const float* __restrict__ esup,
                         const float* __restrict__ elift,
                         const int* __restrict__ queries,
                         const int* __restrict__ ant_len, int q, int width,
                         int e, int* __restrict__ node_out,
                         int* __restrict__ found_out,
                         float* __restrict__ conf_out,
                         float* __restrict__ sup_out,
                         float* __restrict__ lift_out,
                         float* __restrict__ csup_out) {
    __shared__ __align__(16) int s_item[RS_ROOT_CAP];
    __shared__ int s_child[RS_ROOT_CAP];
    __shared__ float s_csup[RS_ROWS];
    const Group g = this_group();
    const Walk k = this_walk(q);

    // round 1: the row's first columns, its ant_len, the root's bounds and
    // the staged edges
    int v = row_item(queries, k, g, width, 0);
    const int al = k.live ? ant_len[k.row] : 0;
    const int root_lo = co[0], root_hi = co[1];
    const int n_staged = min(e, RS_ROOT_CAP);
    for (int i = threadIdx.x; i < n_staged; i += RS_THREADS) {
        s_item[i] = ei[i];
        s_child[i] = ec[i];
    }
    __syncthreads();
    const bool staged = root_lo == 0 && root_hi <= n_staged;

    int node = 0, seq_len = 0;
    bool ok = true, pend = false;
    float conf = 1.0f, sup = 0.0f, nlift = 0.0f, factor = 1.0f;
    for (int c0 = 0; c0 < width; c0 += RS_GROUP) {
        if (c0) v = row_item(queries, k, g, width, c0);
        const unsigned valid = group_ballot(g, v >= 0);
        seq_len += __popc(valid);
        // the walk's items: every valid one, or for the consequent walk
        // those at or past ant_len
        unsigned todo =
            k.cons ? group_ballot(g, v >= 0 && c0 + g.lane >= al) : valid;
        while (ok && todo) {
            const int src = __ffs(todo) - 1;
            todo &= todo - 1;
            const int item = __shfl_sync(g.mask, v, src);
            int j, child = 0;
            if (node == 0 && staged) {
                j = group_find(g, s_item, 0, root_hi, item);
                if (j >= 0) child = s_child[j];
            } else {
                j = group_find(g, ei, co[node], co[node + 1], item);
                if (j >= 0) child = ec[j];
            }
            if (pend) conf = __fmul_rn(conf, factor);
            pend = false;
            if (j < 0) {
                ok = false;
                break;
            }
            node = child;
            sup = esup[j];
            if (!k.cons) {
                nlift = elift[j];
                if (c0 + src - g.shift >= al) {
                    factor = econf[j];
                    pend = true;
                }
            }
        }
    }
    if (pend) conf = __fmul_rn(conf, factor);
    if (k.cons && g.lane == 0) s_csup[k.slot] = ok && node > 0 ? sup : 0.0f;
    __syncthreads();
    if (k.cons || g.lane != 0 || !k.live) return;
    const int r = k.row;
    const bool found = ok && node > 0;
    const float con_sup = s_csup[k.slot];
    const float fconf = found ? conf : 0.0f;
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
    const int* queries, const int* ant_len, int q, int width, int e,
    int blocks, int* node, int* found, float* conf, float* sup, float* lift,
    float* con_sup, void* stream) {
    rule_search_fused_kernel<<<blocks, RS_THREADS, 0, (cudaStream_t)stream>>>(
        co, edge_item, edge_child, edge_conf, edge_sup, edge_lift, queries,
        ant_len, q, width, e, node, found, conf, sup, lift, con_sup);
    return (int)cudaGetLastError();
}

// Span rule-search kernel (the path-compressed layout).
//
// Replaces the TPU kernel repro/kernels/rule_search.py::rule_search_span_pallas:
// the same two walks per query row over the compressed layout, where
// every maximal single-child run is a contiguous DFS interval and only run
// heads, tails and branching nodes keep a CSR row.  Per walk the state is
// (pos, rem, ctail): the DFS position reached, the span steps left before
// the next CSR node, and the compressed id of the run's tail.  Inside a
// span (rem > 0) the group takes the next m <= min(rem, RS_GROUP) items of
// the walk in one round: lane i gathers node_item[pos + 1 + i] (and, on
// the full walk's consequent steps, the confidence there), and pos and rem
// advance by the matching prefix; one lane's order of multiplies keeps the
// product left to right.  At a CSR node a step is group_find over
// child_offsets[ctail]..[ctail + 1] on edge_item, then edge_pos, edge_span
// and edge_tail in one round.  The metric columns are indexed by DFS
// position and arrive in their storage types (f32, int32 counts or bf16
// support; f32, bf16 or int8 confidence and lift), widened per gather
// (metrics.cuh).  Outputs: found, pos (a DFS position, -1 when absent),
// conf, sup, lift and con_support.  The TPU knob span_bf sized the VMEM
// lanes of the bucket scan; the group's width is RS_GROUP here.
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
                        int e, int* __restrict__ pos_out,
                        int* __restrict__ found_out,
                        float* __restrict__ conf_out,
                        float* __restrict__ sup_out,
                        float* __restrict__ lift_out,
                        float* __restrict__ csup_out) {
    __shared__ __align__(16) int s_item[RS_ROOT_CAP];
    __shared__ int s_pos[RS_ROOT_CAP], s_span[RS_ROOT_CAP],
        s_tail[RS_ROOT_CAP];
    __shared__ float s_csup[RS_ROWS];
    const Group g = this_group();
    const Walk k = this_walk(q);

    int v = row_item(queries, k, g, width, 0);
    const int al = k.live ? ant_len[k.row] : 0;
    const int root_lo = co[0], root_hi = co[1];
    const int n_staged = min(e, RS_ROOT_CAP);
    for (int i = threadIdx.x; i < n_staged; i += RS_THREADS) {
        s_item[i] = ei[i];
        s_pos[i] = epos[i];
        s_span[i] = espan[i];
        s_tail[i] = etail[i];
    }
    __syncthreads();
    const bool staged = root_lo == 0 && root_hi <= n_staged;

    int pos = 0, rem = 0, ctail = 0, seq_len = 0;
    bool ok = true, pend = false;
    float cf = 1.0f, factor = 1.0f;
    for (int c0 = 0; c0 < width; c0 += RS_GROUP) {
        if (c0) v = row_item(queries, k, g, width, c0);
        const unsigned valid = group_ballot(g, v >= 0);
        seq_len += __popc(valid);
        unsigned todo =
            k.cons ? group_ballot(g, v >= 0 && c0 + g.lane >= al) : valid;
        while (ok && todo) {
            if (rem > 0) {
                // a span run: lane i takes the walk's i-th next item
                const int m = min(rem, __popc(todo));
                const bool mine = g.lane < m;
                const int src = mine ? nth_bit(todo, g.lane) : g.shift;
                const int item = __shfl_sync(g.mask, v, src);
                const bool in_cons = !k.cons && c0 + src - g.shift >= al;
                int at_item = -1;
                float c = 1.0f;
                if (mine) {
                    at_item = node_item[pos + 1 + g.lane];
                    if (in_cons)
                        c = dequantize(conf[pos + 1 + g.lane], conf_scale);
                }
                if (pend) cf = __fmul_rn(cf, factor);
                pend = false;
                const unsigned miss = group_ballot(g, mine && at_item != item);
                const unsigned mul = group_ballot(g, mine && in_cons);
                const int run = miss ? __ffs(miss) - 1 - g.shift : m;
                for (int i = 0; i < run; ++i) {
                    const float ci = __shfl_sync(g.mask, c, g.shift + i);
                    if (mul >> (g.shift + i) & 1u) cf = __fmul_rn(cf, ci);
                    todo &= todo - 1;
                }
                pos += run;
                rem -= run;
                if (run < m) ok = false;
                continue;
            }
            const int src = __ffs(todo) - 1;
            todo &= todo - 1;
            const int item = __shfl_sync(g.mask, v, src);
            int j, p2 = 0, r2 = 0, t2 = 0;
            if (ctail == 0 && staged) {
                j = group_find(g, s_item, 0, root_hi, item);
                if (j >= 0) {
                    p2 = s_pos[j];
                    r2 = s_span[j];
                    t2 = s_tail[j];
                }
            } else {
                j = group_find(g, ei, co[ctail], co[ctail + 1], item);
                if (j >= 0) {
                    p2 = epos[j];
                    r2 = espan[j];
                    t2 = etail[j];
                }
            }
            if (pend) cf = __fmul_rn(cf, factor);
            pend = false;
            if (j < 0) {
                ok = false;
                break;
            }
            pos = p2;
            rem = r2;
            ctail = t2;
            if (!k.cons && c0 + src - g.shift >= al) {
                factor = dequantize(conf[pos], conf_scale);
                pend = true;
            }
        }
    }
    if (pend) cf = __fmul_rn(cf, factor);
    const bool hit = ok && pos > 0;
    const float own_sup = hit ? dequantize(sup[pos], inv_n) : 0.0f;
    if (k.cons && g.lane == 0) s_csup[k.slot] = own_sup;
    __syncthreads();
    if (k.cons || g.lane != 0 || !k.live) return;
    const int r = k.row;
    const float con_sup = s_csup[k.slot];
    const float fconf = hit ? cf : 0.0f;
    const float nlift = hit ? dequantize(lift[pos], lift_scale) : 0.0f;
    pos_out[r] = hit ? pos : -1;
    found_out[r] = hit ? 1 : 0;
    conf_out[r] = fconf;
    sup_out[r] = own_sup;
    lift_out[r] = compound_lift(hit, seq_len - al == 1, nlift, fconf,
                                con_sup);
    csup_out[r] = con_sup;
}

struct SpanArgs {
    const int *co, *edge_item, *edge_pos, *edge_span, *edge_tail, *node_item;
    const void *sup, *conf, *lift;
    float inv_n, conf_scale, lift_scale;
    const int *queries, *ant_len;
    int q, width, e, blocks;
    int *pos, *found;
    float *conf_out, *sup_out, *lift_out, *csup_out;
};

template <class S, class C>
static cudaError_t launch_span_typed(const SpanArgs& a, cudaStream_t stream) {
    rule_search_span_kernel<S, C><<<a.blocks, RS_THREADS, 0, stream>>>(
        a.co, a.edge_item, a.edge_pos, a.edge_span, a.edge_tail, a.node_item,
        (const S*)a.sup, (const C*)a.conf, (const C*)a.lift, a.inv_n,
        a.conf_scale, a.lift_scale, a.queries, a.ant_len, a.q, a.width, a.e,
        a.pos, a.found, a.conf_out, a.sup_out, a.lift_out, a.csup_out);
    return cudaGetLastError();
}

extern "C" int rule_search_span_launch(
    const int* co, const int* edge_item, const int* edge_pos,
    const int* edge_span, const int* edge_tail, const int* node_item,
    const void* sup, const void* conf, const void* lift, int sup_type,
    int col_type, float inv_n, float conf_scale, float lift_scale,
    const int* queries, const int* ant_len, int q, int width, int e,
    int blocks, int* pos, int* found, float* conf_out, float* sup_out,
    float* lift_out, float* con_sup, void* stream) {
    SpanArgs a{co, edge_item, edge_pos, edge_span, edge_tail, node_item,
               sup, conf, lift, inv_n, conf_scale, lift_scale, queries,
               ant_len, q, width, e, blocks, pos, found, conf_out, sup_out,
               lift_out, con_sup};
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
