// Item-membership top-k kernel.
//
// Replaces the TPU kernel repro/kernels/item_index.py::rules_with_pallas:
// for each queried item, the top-k rules that involve it, by role --
//   consequent: node_item[p] == item;
//   antecedent: a strict ancestor carries the item;
//   any:        either.
// The reference tests membership per position with the laminar range
// count over the item's posting slice [plo, phi),
//   #(post_lo <= p) - #(post_hi <= p)   (minus the self hit: antecedent),
// two binary searches per position.  Here the members of a query are
// worked out once from the slice, in closed form, and only they are read.
//
// Invariants (core/array_trie.py::_sorted_posting_bounds and
// kernels/ops.py::item_rank_arrays establish them on both layouts):
//   - an item's slice holds every non-root node that carries it, with
//     post_lo (its DFS position) ascending;
//   - subtree ranges [post_lo, lo + subtree size) are laminar;
//   - post_hi holds the slice's range ends sorted ascending.
// Then posting j opens an OUTERMOST range iff j == plo or the j-th
// smallest end post_hi[j-1] <= post_lo[j] (every earlier range ends before
// it starts), and the outermost range opened at j ends at post_hi[j'-1],
// j' the next outermost posting (phi if none).  The members are
//   any:        the union of the outermost ranges [lo, hi);
//   antecedent: the union of (lo, hi), the outermost nodes themselves out
//               (a nested posting lies inside its outermost range);
//   consequent: the postings' positions post_lo[plo, phi), plus the root
//               (position 0) when node_item[0] is the queried id, as the
//               reference's self-hit test finds it for the absent item -1;
//               its depth-0 score is -inf unless min_depth is 0.
//
// Passes (one stream):
//   0. score_kernel (topk_select.cuh, shared with rank.cu): the masked
//      score column and the smallest 64-bit key of every 1024-position DFS
//      tile.
//   1. member_count_kernel / member_ranges_kernel (antecedent and any):
//      blocks of RT_POSTING_CHUNK postings flag the outermost ones with
//      coalesced reads of post_lo and post_hi, count them, then scan them
//      into the query's compacted range list (first position, flat index
//      of its first candidate).  A range's end never needs storing: the
//      end of the previous range is post_hi[j-1] at the next opening j, so
//      each flat index is a prefix sum of local terms.
//   2. member_plan_kernel: blocks per query in proportion to its
//      candidates, about work_blocks in all (topk_select.cuh::plan_blocks).
//   3. member_topk_kernel: each query's candidates in flat order (ranges
//      laid end to end, or the gathered postings) split evenly over its
//      blocks; a block finds its first range with one binary search, then
//      walks the ranges with a cursor: per tile of 1024 candidates, the
//      ranges that start in it are marked and a block max scan gives every
//      candidate its range (no search per position).  A range part whose
//      DFS tiles hold no key below the running k-th key is skipped (exact:
//      a tile's smallest key bounds every member in it), and a full list's
//      k-th key is shared by the query's blocks.  Survivors are sorted and
//      merged, and the query's last block to finish merges the other
//      blocks' lists and writes the row, with rank.cu's machinery
//      (topk_select.cuh: run_list, running_threshold, merge_candidates,
//      finish_query).
//
// What bounds it here: the candidates, not N.  A query reads 4 bytes of
// score per candidate (the postings' positions gathered for consequent),
// 8 bytes per posting and 8 per range; the TPU kernel, and this port's
// first version, swept all N positions for every query, with binary
// searches over the slice per tile and per surviving position.
#include "topk_select.cuh"

enum Role { RT_CONSEQUENT = 0, RT_ANTECEDENT = 1, RT_ANY = 2 };

#define RT_POSTING_CHUNK 2048  // postings per block of pass 1
#define RT_PER_THREAD (RT_POSTING_CHUNK / RT_THREADS)

// ---------------------------------------------------------------------
// pass 1: the outermost ranges of each query's posting slice
//
// meta holds, from the host: qoff[q] (the query's first slot in range_lo
// and range_cum), chunk_first[q] (its first posting chunk) and
// chunk_q[n_pchunks] (the query of every posting chunk).
struct RangeArgs {
    const int* post_lo;
    const int* post_hi;
    const int* plos;
    const int* phis;
    const int* qoff;
    const int* chunk_first;
    const int* chunk_q;
    int first_gap;  // 1 for antecedent: a range's members start after it
};

// The posting indices [j0, j1) of this block's chunk of query q's slice.
struct PostingChunk {
    int q, plo, phi, j0, j1;
};

__device__ __forceinline__ PostingChunk posting_chunk(const RangeArgs& a) {
    PostingChunk p;
    p.q = a.chunk_q[blockIdx.x];
    p.plo = a.plos[p.q];
    p.phi = a.phis[p.q];
    p.j0 = p.plo + ((int)blockIdx.x - a.chunk_first[p.q]) * RT_POSTING_CHUNK;
    p.j1 = min(p.phi, p.j0 + RT_POSTING_CHUNK);
    return p;
}

// Whether posting j opens an outermost range, and its term of the flat
// count: the end of the range it closes (post_hi[j-1]; none at plo) less
// its own first member.  The flat index of a range's first candidate is
// the inclusive sum of these terms plus that first member.
__device__ __forceinline__ bool opens_range(const RangeArgs& a, int plo,
                                            int j, long long* term) {
    const int lo = a.post_lo[j];
    const int prev_end = j > plo ? a.post_hi[j - 1] : 0;
    if (j > plo && prev_end > lo) return false;
    *term = (long long)prev_end - (lo + a.first_gap);
    return true;
}

__global__ void __launch_bounds__(RT_THREADS)
member_count_kernel(RangeArgs a, int* __restrict__ chunk_cnt,
                    long long* __restrict__ chunk_sum) {
    __shared__ int wc[RT_WARPS];
    __shared__ long long ws[RT_WARPS];
    const PostingChunk p = posting_chunk(a);
    int cnt = 0;
    long long sum = 0;
    for (int u = 0; u < RT_PER_THREAD; ++u) {
        const int j = p.j0 + threadIdx.x + u * RT_THREADS;
        long long term;
        if (j < p.j1 && opens_range(a, p.plo, j, &term)) {
            ++cnt;
            sum += term;
        }
    }
    int tc;
    long long ts;
    block_exclusive_sum(cnt, wc, &tc);
    block_exclusive_sum(sum, ws, &ts);
    if (threadIdx.x == 0) {
        chunk_cnt[blockIdx.x] = tc;
        chunk_sum[blockIdx.x] = ts;
    }
}

__global__ void __launch_bounds__(RT_THREADS)
member_ranges_kernel(RangeArgs a, const int* __restrict__ chunk_cnt,
                     const long long* __restrict__ chunk_sum,
                     int* __restrict__ range_lo, int* __restrict__ range_cum,
                     int* __restrict__ q_ranges) {
    __shared__ int wc[RT_WARPS];
    __shared__ long long ws[RT_WARPS];
    const PostingChunk p = posting_chunk(a);
    // the earlier chunks of the same query
    int base_c = 0;
    long long base_s = 0;
    for (int c = a.chunk_first[p.q] + threadIdx.x; c < (int)blockIdx.x;
         c += RT_THREADS) {
        base_c += chunk_cnt[c];
        base_s += chunk_sum[c];
    }
    block_exclusive_sum(base_c, wc, &base_c);
    block_exclusive_sum(base_s, ws, &base_s);
    // this thread's postings, consecutive, then a block scan
    const int j_first = p.j0 + threadIdx.x * RT_PER_THREAD;
    int cnt = 0;
    long long sum = 0;
    for (int u = 0; u < RT_PER_THREAD; ++u) {
        const int j = j_first + u;
        long long term;
        if (j < p.j1 && opens_range(a, p.plo, j, &term)) {
            ++cnt;
            sum += term;
        }
    }
    int tc;
    long long ts;
    int r = base_c + block_exclusive_sum(cnt, wc, &tc);
    long long s = base_s + block_exclusive_sum(sum, ws, &ts);
    int* rlo = range_lo + a.qoff[p.q];
    int* rcum = range_cum + a.qoff[p.q];
    for (int u = 0; u < RT_PER_THREAD; ++u) {
        const int j = j_first + u;
        long long term;
        if (j < p.j1 && opens_range(a, p.plo, j, &term)) {
            s += term;
            const int first = a.post_lo[j] + a.first_gap;
            rlo[r] = first;
            rcum[r] = (int)(s + first);
            ++r;
        }
    }
    if (p.j1 == p.phi && threadIdx.x == 0) {
        // the query's last chunk: its range count and candidate count
        // (the sum of every term, closed by the last range's end)
        q_ranges[2 * p.q] = base_c + tc;
        q_ranges[2 * p.q + 1] = (int)(base_s + ts + a.post_hi[p.phi - 1]);
    }
}

// ---------------------------------------------------------------------
// pass 2: a plan of blocks, so that the work follows the candidates
//
// One block lays out the top-k pass (topk_select.cuh::plan_blocks, with a
// query's tiles of candidates) and resets every query's shared threshold.
struct PlanArgs {
    const int* plos;
    const int* phis;
    const int* items;
    const int* node_item;
    const int* q_ranges;  // (range count, candidate count), ranges roles
    int q;
    int role;
    int min_tiles;
    int work_blocks;
    int grid;
    int* q_first;
    int* q_blocks;
    int* q_done;
    unsigned long long* q_thr;  // per query: a key k members beat
    int* block_q;
};

// A query's candidates: its postings (and the root when node_item[0] is
// its id) for consequent, the range pass's count otherwise.
__device__ __forceinline__ int query_candidates(const int* plos,
                                                const int* phis,
                                                const int* items,
                                                const int* node_item,
                                                const int* q_ranges, int role,
                                                int q) {
    const int len = max(phis[q] - plos[q], 0);
    if (role == RT_CONSEQUENT)
        return len + (node_item[0] == items[q] ? 1 : 0);
    return len > 0 ? q_ranges[2 * q + 1] : 0;
}

__global__ void __launch_bounds__(RT_THREADS)
member_plan_kernel(PlanArgs a) {
    for (int q = threadIdx.x; q < a.q; q += RT_THREADS)
        a.q_thr[q] = RT_EMPTY_KEY;
    plan_blocks(
        a.q,
        [&](int q) {
            return (query_candidates(a.plos, a.phis, a.items, a.node_item,
                                     a.q_ranges, a.role, q) +
                    RT_TILE - 1) / RT_TILE;
        },
        a.min_tiles, a.work_blocks, a.grid, a.q_first, a.q_blocks, a.q_done,
        a.block_q);
}

// ---------------------------------------------------------------------
// pass 3: top-k over each query's candidates
struct MemberArgs {
    const float* scores;
    const unsigned long long* tile_min;  // smallest key per DFS tile
    const int* node_item;
    const int* post_lo;
    const int* plos;
    const int* phis;
    const int* items;
    const int* qoff;
    const int* q_ranges;
    const int* range_lo;  // first member position of each range
    const int* range_cum; // flat index of its first candidate
    const int* q_first;
    const int* q_blocks;
    const int* block_q;
    int* q_done;
    unsigned long long* q_thr;
    int role;
};

// Block-wide inclusive max scan of mark[0, RT_TILE), four consecutive
// entries per thread, into v.
__device__ __forceinline__ void block_max_scan(const int* mark, int v[4],
                                               int* warp_max) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int u = 0; u < 4; ++u) {
        v[u] = mark[4 * threadIdx.x + u];
        if (u > 0) v[u] = max(v[u], v[u - 1]);
    }
    int inc = v[3];
    for (int o = 1; o < 32; o <<= 1) {
        int y = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc = max(inc, y);
    }
    if (lane == 31) warp_max[warp] = inc;
    int before = __shfl_up_sync(0xffffffffu, inc, 1);
    if (lane == 0) before = -1;
    __syncthreads();
    for (int w = 0; w < warp; ++w) before = max(before, warp_max[w]);
    for (int u = 0; u < 4; ++u) v[u] = max(v[u], before);
}

// Whether any DFS tile of the positions [p, p + len), len <= RT_TILE (so
// at most two tiles), holds a key below thr: if none does, no member
// there can enter the top-k.
__device__ __forceinline__ bool may_enter(const unsigned long long* tile_min,
                                          int p, int len,
                                          unsigned long long thr) {
    return tile_min[p / RT_TILE] < thr ||
           tile_min[(p + len - 1) / RT_TILE] < thr;
}

// Blocks of one query each keep their candidates' top k (topk_select.cuh::
// run_list: in dynamic shared memory sized for k while k <= RT_TILE, so
// that a small k leaves room for more blocks on an SM) and write it to
// their slot of lists; the query's last block to finish merges the other
// lists into its own and writes the query's row (finish_query).
__global__ void __launch_bounds__(RT_THREADS)
member_topk_kernel(MemberArgs a, int k, unsigned long long* lists,
                   float* list_vals, unsigned long long* alt,
                   float* alt_vals, float* out_vals, int* out_pos) {
    extern __shared__ unsigned long long smem[];  // run, nxt, rv, nv
    __shared__ unsigned long long cand[RT_TILE];
    __shared__ int mark[RT_TILE];  // 2 * range + (its members may enter)
    __shared__ int warp_max[RT_WARPS];
    __shared__ int n_cand, cursor, multi, last;
    const long long b = blockIdx.x;
    const int q = a.block_q[b];
    if (q < 0) return;  // past the plan's blocks
    RunList l = run_list(smem, k, b, lists, list_vals, alt, alt_vals);
    auto value = [&](unsigned long long key) {
        return a.scores[(int)(unsigned int)key];
    };

    const int plo = a.plos[q];
    const int len = max(a.phis[q] - plo, 0);
    const bool postings = a.role == RT_CONSEQUENT;
    const int extra = postings && a.node_item[0] == a.items[q] ? 1 : 0;
    const int m = !postings && len > 0 ? a.q_ranges[2 * q] : 0;
    const int total = query_candidates(a.plos, a.phis, a.items, a.node_item,
                                       a.q_ranges, a.role, q);
    const int* rlo = a.range_lo + (postings ? 0 : a.qoff[q]);
    const int* rcum = a.range_cum + (postings ? 0 : a.qoff[q]);
    // this block's share of the query's tiles of candidates
    const int first = a.q_first[q], n_blocks = a.q_blocks[q];
    const int tiles = (total + RT_TILE - 1) / RT_TILE;
    const int per = (tiles + n_blocks - 1) / n_blocks;
    const int t0 = ((int)b - first) * per, t1 = min(tiles, t0 + per);
    if (!postings && t0 < t1 && threadIdx.x == 0) {
        // the one search: the last range starting at or before the block's
        // first candidate
        int lo = 0, hi = m;
        const int f = t0 * RT_TILE;
        while (hi - lo > 1) {
            int mid = (lo + hi) >> 1;
            if (rcum[mid] <= f) lo = mid; else hi = mid;
        }
        cursor = lo;
    }
    // a full list of k keys bounds the whole query's top-k: shared through
    // q_thr, every block of the query admits only keys below the best bound
    unsigned long long published = RT_EMPTY_KEY;
    for (int t = t0; t < t1; ++t) {
        const int base = t * RT_TILE;
        const int cnt = min(RT_TILE, total - base);
        __syncthreads();  // publishes cursor and the running list
        const unsigned long long thr =
            running_threshold(l.run, k, &a.q_thr[q], &published);
        int pos[4];
        bool live[4];
        bool any = false;
        if (!postings) {
            // each candidate's range: mark the ranges that start in this
            // tile (and the cursor's, on offset 0), then a max scan; a
            // range whose part in the tile cannot enter marks itself dead
            const int c0 = cursor;
            for (int u = 0; u < 4; ++u)
                mark[4 * threadIdx.x + u] = -1;
            if (threadIdx.x == 0) {
                multi = 0;
                n_cand = 0;
            }
            __syncthreads();
            for (int r0 = c0;; r0 += RT_THREADS) {
                const int r = r0 + threadIdx.x;
                const bool in = r < m && rcum[r] < base + cnt;
                if (in) {
                    const int fa = max(rcum[r], base);
                    const int fb = min(r + 1 < m ? rcum[r + 1] : total,
                                       base + cnt);
                    const bool alive =
                        fb > fa && may_enter(a.tile_min,
                                             rlo[r] + fa - rcum[r], fb - fa,
                                             thr);
                    any |= alive;
                    const int o = fa - base;
                    atomicMax(&mark[o], 2 * r + (alive ? 1 : 0));
                    atomicMax(&cursor, r);  // the next tile's first range
                    if (o > 0) multi = 1;
                }
                // ranges start in order: go on while the last one is in
                if (!__syncthreads_or(in && threadIdx.x == RT_THREADS - 1))
                    break;
            }
            if (!__syncthreads_or(any)) continue;
            int rr[4];
            if (multi) {
                block_max_scan(mark, rr, warp_max);
            } else {
                for (int u = 0; u < 4; ++u) rr[u] = mark[0];
            }
            for (int u = 0; u < 4; ++u) {
                const int o = 4 * threadIdx.x + u, r = rr[u] >> 1;
                live[u] = o < cnt && (rr[u] & 1);
                pos[u] = live[u] ? rlo[r] + (base + o - rcum[r]) : 0;
            }
        } else {
            if (threadIdx.x == 0) n_cand = 0;
            for (int u = 0; u < 4; ++u) {
                const int f = base + 4 * threadIdx.x + u;
                pos[u] = f < extra ? 0
                         : f < total ? a.post_lo[plo + f - extra] : 0;
                live[u] = f < total && a.tile_min[pos[u] / RT_TILE] < thr;
                any |= live[u];
            }
            if (!__syncthreads_or(any)) continue;
        }
        unsigned long long key[4];
        bool ok[4];
        for (int u = 0; u < 4; ++u) {
            key[u] = live[u] ? topk_key(a.scores[pos[u]], pos[u])
                             : RT_EMPTY_KEY;
            ok[u] = key[u] < thr;
        }
        push_candidates(key, ok, cand, &n_cand);
        __syncthreads();
        const int c = n_cand;
        __syncthreads();  // every thread has c before the next reset
        if (c == 0) continue;
        merge_candidates(cand, c, k, l.run, l.rv, l.nxt, l.nv, value);
        swap_lists(l);
    }
    if (finish_query(l, k, b, first, n_blocks, &a.q_done[q], lists, value,
                     cand, &last))
        write_row(l, k, out_vals, out_pos, q);
}

extern "C" int rules_with_launch(
    const void* sup, const void* conf, const void* lift, int sup_type,
    int col_type, float inv_n, float conf_scale, float lift_scale,
    const int* depth, const int* node_item, int n, const int* post_lo,
    const int* post_hi, const int* plos, const int* phis, const int* items,
    int q, int k, int metric, int min_depth, int role, const int* meta,
    int n_pchunks, int* chunk_cnt, long long* chunk_sum, int* range_lo,
    int* range_cum, int* q_ranges, int* plan, unsigned long long* q_thr,
    int min_tiles, int work_blocks, float* scores,
    unsigned long long* tile_min, unsigned long long* lists,
    float* list_vals, unsigned long long* alt, float* alt_vals,
    float* out_vals, int* out_pos, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    // the grid: every query's blocks fit work_blocks + q (plan_blocks)
    const long long grid = (long long)work_blocks + q;
    if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    MetricColumns m{sup, conf, lift, sup_type, col_type,
                    inv_n, conf_scale, lift_scale};
    cudaError_t err = launch_scores(m, depth, n, metric, min_depth, scores,
                                    tile_min, nullptr, nullptr, 0, s);
    if (err != cudaSuccess) return (int)err;
    const int* qoff = meta;
    if (role != RT_CONSEQUENT && n_pchunks > 0) {
        RangeArgs ra{post_lo, post_hi, plos, phis, qoff, meta + q,
                     meta + 2 * q, role == RT_ANTECEDENT ? 1 : 0};
        member_count_kernel<<<n_pchunks, RT_THREADS, 0, s>>>(ra, chunk_cnt,
                                                             chunk_sum);
        member_ranges_kernel<<<n_pchunks, RT_THREADS, 0, s>>>(
            ra, chunk_cnt, chunk_sum, range_lo, range_cum, q_ranges);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    // plan: q_first, q_blocks, q_done (q each), block_q (grid)
    int* q_first = plan;
    int* q_blocks = plan + q;
    int* q_done = plan + 2 * q;
    int* block_q = plan + 3 * q;
    PlanArgs pa{plos, phis, items, node_item, q_ranges, q, role, min_tiles,
                work_blocks, (int)grid, q_first, q_blocks, q_done, q_thr,
                block_q};
    member_plan_kernel<<<1, RT_THREADS, 0, s>>>(pa);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    MemberArgs ma{scores, tile_min, node_item, post_lo, plos, phis, items,
                  qoff, q_ranges, range_lo, range_cum, q_first, q_blocks,
                  block_q, q_done, q_thr, role};
    const size_t lists_bytes = k <= RT_TILE ? 24 * (size_t)k : 0;
    member_topk_kernel<<<(unsigned int)grid, RT_THREADS, lists_bytes, s>>>(
        ma, k, lists, list_vals, alt, alt_vals, out_vals, out_pos);
    return (int)cudaGetLastError();
}
