// Segmented top-k rank kernel.
//
// Replaces the TPU kernel repro/kernels/rank.py::topk_rank_batch_pallas
// (and its Q=1 slice topk_rank_pallas): for each query, the top-k of
// rank_score(metric) over the DFS range [lo, hi), nodes at depth >= min_depth
// only, in (value desc, position asc) order with (-inf, -1) empty slots.
// The TPU kernel sweeps all N positions for every query and masks outside
// [lo, hi).
//
// Quantized columns (the compressed layout: int32 support counts, bf16 or
// int8 confidence and lift) are read in their storage types and widened in
// the score pass (topk_select.cuh), as the TPU kernel widens them per tile.
//
// What bounds it here: memory, the columns the metric reads once per
// position (the score pass), then 4 bytes of score per position a query
// reads; the few flops per position are far below the card's rate.  So
// the design reads as few positions as the answers allow:
//   1. Equal ranges are ranked once.  Each query claims its (lo, hi) in a
//      hash table; the first to claim it ranks the range, and the others
//      join its list, whose rows the range's writer fills.
//   2. A seeded threshold.  A range with at least k full DFS tiles (of
//      RT_TILE positions, the score pass's tiles) starts from the k-th
//      smallest of their tile keys: those keys belong to k distinct live
//      positions of the range, so its k-th best key is no larger, and the
//      seed itself is admitted (the threshold is seed + 1, compared
//      strictly).  A range with fewer full tiles but at least k full
//      groups of RT_GROUP positions starts from the k-th smallest of
//      their group keys, for the same reason.  Only tiles whose key is
//      below the threshold are read: at most k + 2 of them (those holding
//      the k full tiles or groups, and two partial edge tiles), about k
//      for a whole-trie range, where the sweep read all N / RT_TILE; and a
//      seeded range's blocks admit few candidates from their first tile.
//   3. One planned selection launch.  The last seed block plans the grid
//      (topk_select.cuh::plan_blocks) from the tiles each range will read;
//      a range's blocks share its running k-th key, and its last block to
//      finish merges their lists and writes its rows.
// Passes (one stream, three launches):
//   0. score_kernel: the masked score column, the tile and group keys; it
//      also sets the plan scratch below to ~0 (an empty hash table, list
//      heads -1, the seed blocks' done count at -1).
//   1. rank_seed_kernel (one block per query): the claim, the seed and the
//      compacted list of the range's tiles below it; the last block to
//      finish plans the grid.
//   2. rank_topk_kernel: each block streams its share of its range's
//      listed tiles, skipping a tile whose key is not below the running
//      threshold.
#include "topk_select.cuh"

// Plan scratch, in 32-bit words of one buffer (offsets in rank_layout):
//   slot_key[table]   u64, a claimed range (lo << 32 | hi), ~0 if free
//   q_thr[q]          u64, the range's shared threshold (strict)
//   slot_head[table]  first query of the slot's list, -1 at its end
//   done              seed blocks done, starting at -1 (~0)
//   q_next[q]         next query of the same slot
//   q_slot[q]         the slot of the query's range
//   q_tiles[q]        tiles the range reads; -1 for a query it copies
//   q_first, q_blocks, q_done[q], block_q[grid]: the plan
//   tile_list[q * list_cap]: each range's tiles below its seed, ascending
struct RankArgs {
    const float* scores;
    const unsigned long long* tile_min;
    const unsigned long long* group_min;
    const int* los;
    const int* his;
    int n;
    int q;
    int k;
    int table;  // a power of two >= 2 q
    int list_cap;
    unsigned long long* slot_key;
    unsigned long long* q_thr;
    int* slot_head;
    unsigned int* done;
    int* q_next;
    int* q_slot;
    int* q_tiles;
    int* q_first;
    int* q_blocks;
    int* q_done;
    int* block_q;
    int* tile_list;
    int min_tiles;
    int work_blocks;
    int grid;
};

// Words of the plan scratch the score pass clears, and the whole buffer.
static long long rank_clear_words(int q, int table) {
    return 2LL * table + 2LL * q + table + 1;
}

static long long rank_scratch_words(int q, int table, int grid,
                                    int list_cap) {
    return rank_clear_words(q, table) + 6LL * q + grid +
           (long long)q * list_cap;
}

static RankArgs rank_layout(int* ws, int q, int table, int grid,
                            int list_cap) {
    RankArgs a{};
    a.q = q;
    a.table = table;
    a.grid = grid;
    a.list_cap = list_cap;
    a.slot_key = (unsigned long long*)ws;
    a.q_thr = a.slot_key + table;
    int* w = (int*)(a.q_thr + q);
    a.slot_head = w;
    w += table;
    a.done = (unsigned int*)w;
    w += 1;
    a.q_next = w;
    a.q_slot = w + q;
    a.q_tiles = w + 2 * q;
    a.q_first = w + 3 * q;
    a.q_blocks = w + 4 * q;
    a.q_done = w + 5 * q;
    a.block_q = w + 6 * q;
    a.tile_list = a.block_q + grid;
    return a;
}

// The query's range, clamped to [0, n); every empty range is [0, 0).
__device__ __forceinline__ void query_range(const RankArgs& a, int q, int* lo,
                                            int* hi) {
    int l = max(a.los[q], 0), h = min(a.his[q], a.n);
    if (h <= l) l = h = 0;
    *lo = l;
    *hi = h;
}

// The k-th smallest (1-based, 1 <= k <= len) of keys[0, len), exactly: an
// 8-bit radix select from the top byte down, one histogram per byte over
// the keys that match the bytes chosen so far (one shared atomic per
// group of equal digits in a warp), until a single key matches and one
// sweep finds it.  (A bitonic sort of up to 1024 keys in shared memory
// took as long or longer on the main path's ranges.)
__device__ unsigned long long kth_smallest(const unsigned long long* keys,
                                           int len, int k) {
    __shared__ unsigned int hist[256];
    __shared__ unsigned long long s_prefix;
    __shared__ int s_rank, s_alone;
    const int lane = threadIdx.x & 31;
    unsigned long long prefix = 0;
    int rank = k;
    for (int shift = 56; shift >= 0; shift -= 8) {
        for (int i = threadIdx.x; i < 256; i += RT_THREADS) hist[i] = 0;
        __syncthreads();
        const unsigned long long high = shift == 56 ? 0 : ~0ULL << (shift + 8);
        for (int i0 = 0; i0 < len; i0 += 4 * RT_THREADS) {
            unsigned long long key[4];  // four loads in flight
            for (int u = 0; u < 4; ++u) {
                const int i = i0 + u * RT_THREADS + threadIdx.x;
                key[u] = i < len ? keys[i] : 0;
            }
            for (int u = 0; u < 4; ++u) {
                const bool in = i0 + u * RT_THREADS + threadIdx.x < len &&
                                (key[u] & high) == prefix;
                const unsigned int d = (unsigned int)(key[u] >> shift) & 255u;
                const unsigned int peers =
                    __match_any_sync(0xffffffffu, in ? d : 256u + lane);
                if (in && lane == __ffs(peers) - 1)
                    atomicAdd(&hist[d], (unsigned int)__popc(peers));
            }
        }
        __syncthreads();
        if (threadIdx.x < 32) {
            // warp 0 finds the digit: lane l holds bins 8 l .. 8 l + 7
            unsigned int c[8], own = 0;
            for (int j = 0; j < 8; ++j) {
                c[j] = hist[8 * lane + j];
                own += c[j];
            }
            const unsigned int inc = warp_inclusive_sum(own);
            unsigned int before = inc - own;
            if (before < (unsigned int)rank && (unsigned int)rank <= inc) {
                int j = 0;
                while (before + c[j] < (unsigned int)rank) before += c[j++];
                s_prefix = prefix | ((unsigned long long)(8 * lane + j) << shift);
                s_rank = rank - (int)before;
                s_alone = c[j] == 1;
            }
        }
        __syncthreads();
        prefix = s_prefix;
        rank = s_rank;
        if (s_alone && shift > 0) {
            const unsigned long long mask = ~0ULL << shift;
            __syncthreads();  // every thread has read s_prefix
            for (int i = threadIdx.x; i < len; i += RT_THREADS)
                if ((keys[i] & mask) == prefix) s_prefix = keys[i];
            __syncthreads();
            return s_prefix;
        }
    }
    return prefix;
}

__global__ void __launch_bounds__(RT_THREADS) rank_seed_kernel(RankArgs a) {
    __shared__ int s_rep, s_last, wsum[RT_WARPS];
    const int q = blockIdx.x;
    int lo, hi;
    query_range(a, q, &lo, &hi);
    if (threadIdx.x == 0) {
        // claim the range, or find its claim, by linear probing
        const unsigned long long key =
            ((unsigned long long)lo << 32) | (unsigned int)hi;
        int h = (int)((key * 0x9E3779B97F4A7C15ULL) >> 32) & (a.table - 1);
        int rep;
        while (true) {
            const unsigned long long prev =
                atomicCAS(&a.slot_key[h], RT_EMPTY_KEY, key);
            if (prev == RT_EMPTY_KEY || prev == key) {
                rep = prev == RT_EMPTY_KEY;
                break;
            }
            h = (h + 1) & (a.table - 1);
        }
        a.q_next[q] = atomicExch(&a.slot_head[h], q);
        a.q_slot[q] = h;
        s_rep = rep;
    }
    __syncthreads();
    if (!s_rep) {
        if (threadIdx.x == 0) a.q_tiles[q] = -1;
    } else {
        // the seed: from the full tiles, else from the full groups
        unsigned long long seed = RT_EMPTY_KEY;
        const int f0 = (lo + RT_TILE - 1) / RT_TILE, f1 = hi / RT_TILE;
        const int g0 = (lo + RT_GROUP - 1) / RT_GROUP, g1 = hi / RT_GROUP;
        if (f1 - f0 >= a.k)
            seed = kth_smallest(a.tile_min + f0, f1 - f0, a.k);
        else if (g1 - g0 >= a.k)
            seed = kth_smallest(a.group_min + g0, g1 - g0, a.k);
        const unsigned long long thr =
            seed == RT_EMPTY_KEY ? RT_EMPTY_KEY : seed + 1;
        // the range's tiles below thr, in order: at most k + 2 (the k full
        // tiles or groups up to the seed, two partial edge tiles), and at
        // most k + 1 unseeded (fewer than k full tiles, or fewer than k
        // live ones); list_cap is no less.  More would be a fault of this
        // code: the kernel stops rather than answer from a cut list.
        const int t0 = lo / RT_TILE;
        const int t1 = hi > lo ? (hi - 1) / RT_TILE + 1 : t0;
        int* list = a.tile_list + (long long)q * a.list_cap;
        int count = 0;
        for (int c0 = t0; c0 < t1; c0 += RT_THREADS) {
            const int t = c0 + threadIdx.x;
            const bool keep = t < t1 && a.tile_min[t] < thr;
            int round;
            const int o = block_exclusive_sum((int)keep, wsum, &round);
            if (count + round > a.list_cap) __trap();
            if (keep) list[count + o] = t;
            count += round;
        }
        if (threadIdx.x == 0) {
            a.q_tiles[q] = count;
            a.q_thr[q] = thr;
        }
    }
    // the last seed block plans the selection grid
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
        s_last = atomicAdd(a.done, 1u) + 1u == (unsigned int)(a.q - 1);
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    plan_blocks(a.q, [&](int i) { return __ldcg(&a.q_tiles[i]); },
                a.min_tiles, a.work_blocks, a.grid, a.q_first, a.q_blocks,
                a.q_done, a.block_q);
}

// Blocks of one range each keep their tiles' top k and write it to their
// slot of lists; the range's writer fills the row of every query of it.
__global__ void __launch_bounds__(RT_THREADS)
rank_topk_kernel(RankArgs a, unsigned long long* lists, float* list_vals,
                 unsigned long long* alt, float* alt_vals, float* out_vals,
                 int* out_pos) {
    extern __shared__ unsigned long long smem[];  // run, nxt, rv, nv
    __shared__ unsigned long long cand[RT_TILE];
    __shared__ int n_cand, last;
    const long long b = blockIdx.x;
    const int q = a.block_q[b];
    if (q < 0) return;  // past the plan's blocks
    const int k = a.k;
    RunList l = run_list(smem, k, b, lists, list_vals, alt, alt_vals);
    auto value = [&](unsigned long long key) {
        return a.scores[(int)(unsigned int)key];
    };
    int lo, hi;
    query_range(a, q, &lo, &hi);
    // this block's share of the range's listed tiles
    const int tiles = a.q_tiles[q];
    const int first = a.q_first[q], n_blocks = a.q_blocks[q];
    const int per = (tiles + n_blocks - 1) / n_blocks;
    const int t0 = ((int)b - first) * per, t1 = min(tiles, t0 + per);
    const int* list = a.tile_list + (long long)q * a.list_cap;
    unsigned long long published = RT_EMPTY_KEY;
    int tile = t0 < t1 ? list[t0] : 0;
    for (int t = t0; t < t1; ++t) {
        // the tile's key, its scores (four consecutive positions a thread:
        // the score column is padded to whole tiles) and the next tile's
        // index are loaded first, so that their latencies overlap
        const unsigned long long tile_key = a.tile_min[tile];
        const int p = tile * RT_TILE + 4 * threadIdx.x;
        const float4 s4 = *(const float4*)(a.scores + p);
        tile = t + 1 < t1 ? list[t + 1] : 0;
        if (threadIdx.x == 0) n_cand = 0;
        __syncthreads();  // publishes the running list
        const unsigned long long thr =
            running_threshold(l.run, k, &a.q_thr[q], &published);
        if (!__syncthreads_or(tile_key < thr)) continue;
        const float s[4] = {s4.x, s4.y, s4.z, s4.w};
        unsigned long long key[4];
        bool ok[4];
        for (int u = 0; u < 4; ++u) {
            key[u] = topk_key(s[u], p + u);
            ok[u] = p + u >= lo && p + u < hi && key[u] < thr;
        }
        push_candidates(key, ok, cand, &n_cand);
        __syncthreads();
        const int c = n_cand;
        __syncthreads();  // every thread has c before the next reset
        if (c == 0) continue;
        merge_candidates(cand, c, k, l.run, l.rv, l.nxt, l.nv, value);
        swap_lists(l);
    }
    if (!finish_query(l, k, b, first, n_blocks, &a.q_done[q], lists, value,
                      cand, &last))
        return;
    for (int r = a.slot_head[a.q_slot[q]]; r >= 0; r = a.q_next[r])
        write_row(l, k, out_vals, out_pos, r);
}

extern "C" int topk_rank_batch_launch(
    const void* sup, const void* conf, const void* lift, int sup_type,
    int col_type, float inv_n, float conf_scale, float lift_scale,
    const int* depth, int n, const int* los, const int* his, int q, int k,
    int metric, int min_depth, int table, int list_cap, int min_tiles,
    int work_blocks, float* scores, unsigned long long* tile_min,
    unsigned long long* group_min, int* ws,
    long long ws_words, unsigned long long* lists, float* list_vals,
    unsigned long long* alt, float* alt_vals, float* out_vals, int* out_pos,
    void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    // every range's blocks fit work_blocks + q (plan_blocks)
    const long long grid = (long long)work_blocks + q;
    if (n <= 0 || q <= 0 || k <= 0 || grid > 0x7fffffffLL ||
        (table & (table - 1)) != 0 || table < 2LL * q ||
        rank_scratch_words(q, table, (int)grid, list_cap) > ws_words)
        return (int)cudaErrorInvalidValue;
    RankArgs a = rank_layout(ws, q, table, (int)grid, list_cap);
    a.scores = scores;
    a.tile_min = tile_min;
    a.group_min = group_min;
    a.los = los;
    a.his = his;
    a.n = n;
    a.k = k;
    a.min_tiles = min_tiles;
    a.work_blocks = work_blocks;
    MetricColumns m{sup, conf, lift, sup_type, col_type,
                    inv_n, conf_scale, lift_scale};
    cudaError_t err = launch_scores(
        m, depth, n, metric, min_depth, scores, tile_min, group_min,
        (unsigned int*)ws, (int)rank_clear_words(q, table), s);
    if (err != cudaSuccess) return (int)err;
    rank_seed_kernel<<<q, RT_THREADS, 0, s>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const size_t lists_bytes = k <= RT_TILE ? 24 * (size_t)k : 0;
    rank_topk_kernel<<<(unsigned int)grid, RT_THREADS, lists_bytes, s>>>(
        a, lists, list_vals, alt, alt_vals, out_vals, out_pos);
    return (int)cudaGetLastError();
}
