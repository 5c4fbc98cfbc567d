// Segmented top-k selection, shared by the rank kernel (rank.cu) and the
// item-membership kernel (item_index.cu): the 64-bit key, the score pass
// with its per-tile keys, the plan of blocks, the running top-k list with
// the threshold a query's blocks share, and the last-block merge.
//
// Order: value descending, ties by ascending DFS position -- jax.lax.top_k
// order.  Each candidate becomes one 64-bit key that sorts ascending in that
// order: the high word is the bit-flipped order-preserving image of the f32
// score (+0.0 and -0.0 share it, as they compare equal), the low word the
// position.  Keys of live candidates are distinct because positions are.
// A masked or -inf candidate is the empty key ~0.
//
// Score pass (one thread per position): the masked score column, once per
// call (-inf below min_depth), so that the queries read 4 bytes per
// position instead of the metric's columns and depth, and the smallest key
// of every RT_TILE-position DFS tile (and, where asked, of every
// RT_GROUP-position group).  A tile's key bounds every position in the
// tile, in a query's range or not: a tile whose key is not below a query's
// threshold holds no candidate of it.
//
// Selection: a plan (one block, plan_blocks) gives each query blocks in
// proportion to the tiles it will read.  Each block keeps its candidates'
// running top-k sorted -- in shared memory while k <= RT_TILE, else in its
// slices of two global buffers -- and admits only keys below its
// threshold: the least of its own k-th key, the query's shared key (every
// block's full list bounds the query's top-k; a seed may start it) and, for
// a tile, nothing at all when the tile's key is not below it.  Survivors
// are sorted (bitonic) and merged in.  The query's last block to finish
// merges the other blocks' lists into its own (finish_query).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "metrics.cuh"

#define RT_TILE 1024
#define RT_GROUP 32  // positions per group key: one warp of the score pass
#define RT_THREADS 256
#define RT_WARPS (RT_THREADS / 32)
#define RT_EMPTY_KEY (~0ULL)

__device__ __forceinline__ unsigned long long topk_key(float score, int pos) {
    if (!(score > -INFINITY) && !(score != score)) return RT_EMPTY_KEY;
    float s = score == 0.0f ? 0.0f : score;  // one key for +0.0 and -0.0
    unsigned int u = __float_as_uint(s);
    u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);  // ascending image
    return ((unsigned long long)(~u) << 32) | (unsigned int)pos;
}

// The score pass reads the metric columns in their storage types (S: f32,
// int32 counts or bf16 support; C: f32, bf16 or int8 confidence and lift)
// and widens them in registers (metrics.cuh::dequantize), so a quantized
// trie's columns are never copied to f32 in device memory.  It loads only
// the columns the metric reads (metric_reads_*: the branch is uniform
// across the grid), together with the depth, so that the loads overlap.
template <class S, class C>
__device__ __forceinline__ float position_score(
    const S* __restrict__ sup, const C* __restrict__ conf,
    const C* __restrict__ lift, const int* __restrict__ depth, int i,
    int metric, int min_depth, float inv_n, float conf_scale,
    float lift_scale) {
    const int d = depth[i];
    float s = metric_reads_support(metric) ? dequantize(sup[i], inv_n) : 0.0f;
    float c = metric_reads_confidence(metric) ? dequantize(conf[i], conf_scale)
                                              : 0.0f;
    float l = metric_reads_lift(metric) ? dequantize(lift[i], lift_scale)
                                        : 0.0f;
    return d < min_depth ? -INFINITY : rank_score(metric, s, c, l);
}

// One block per tile.  group_min may be null.  `clear` (clear_words
// 32-bit words, may be none) is set to ~0 on the way: the caller's plan
// scratch, ready for the next pass.
template <class S, class C>
__global__ void __launch_bounds__(RT_TILE)
score_kernel(const S* __restrict__ sup, const C* __restrict__ conf,
             const C* __restrict__ lift, const int* __restrict__ depth,
             int n, int metric, int min_depth, float inv_n, float conf_scale,
             float lift_scale, float* __restrict__ out,
             unsigned long long* __restrict__ tile_min,
             unsigned long long* __restrict__ group_min,
             unsigned int* __restrict__ clear, int clear_words) {
    __shared__ unsigned long long warp_min[RT_TILE / 32];
    const int i = blockIdx.x * RT_TILE + threadIdx.x;
    for (long long w = i; w < clear_words; w += (long long)gridDim.x * RT_TILE)
        clear[w] = ~0u;
    unsigned long long key = RT_EMPTY_KEY;
    if (i < n) {
        float s = position_score(sup, conf, lift, depth, i, metric,
                                 min_depth, inv_n, conf_scale, lift_scale);
        out[i] = s;
        key = topk_key(s, i);
    }
    for (int o = 16; o > 0; o >>= 1) {
        unsigned long long other = __shfl_xor_sync(0xffffffffu, key, o);
        key = other < key ? other : key;
    }
    if ((threadIdx.x & 31) == 0) {
        warp_min[threadIdx.x >> 5] = key;
        if (group_min != nullptr && i < n) group_min[i / RT_GROUP] = key;
    }
    __syncthreads();
    if (threadIdx.x < 32) {
        key = warp_min[threadIdx.x];
        for (int o = 16; o > 0; o >>= 1) {
            unsigned long long other = __shfl_xor_sync(0xffffffffu, key, o);
            key = other < key ? other : key;
        }
        if (threadIdx.x == 0) tile_min[blockIdx.x] = key;
    }
}

// The metric columns and how to widen them: storage type codes
// (metrics.cuh) and the three dequantization scalars.
struct MetricColumns {
    const void* sup;
    const void* conf;
    const void* lift;
    int sup_type;
    int col_type;
    float inv_n;
    float conf_scale;
    float lift_scale;
};

template <class S, class C>
static cudaError_t launch_scores_typed(const MetricColumns& m,
                                       const int* depth, int n, int metric,
                                       int min_depth, float* scores,
                                       unsigned long long* tile_min,
                                       unsigned long long* group_min,
                                       unsigned int* clear, int clear_words,
                                       cudaStream_t stream) {
    score_kernel<S, C><<<(n + RT_TILE - 1) / RT_TILE, RT_TILE, 0, stream>>>(
        (const S*)m.sup, (const C*)m.conf, (const C*)m.lift, depth, n,
        metric, min_depth, m.inv_n, m.conf_scale, m.lift_scale, scores,
        tile_min, group_min, clear, clear_words);
    return cudaGetLastError();
}

// n >= 1.
static cudaError_t launch_scores(const MetricColumns& m, const int* depth,
                                 int n, int metric, int min_depth,
                                 float* scores, unsigned long long* tile_min,
                                 unsigned long long* group_min,
                                 unsigned int* clear, int clear_words,
                                 cudaStream_t stream) {
    RT_DISPATCH_COLUMNS(m.sup_type, m.col_type, launch_scores_typed, m,
                        depth, n, metric, min_depth, scores, tile_min,
                        group_min, clear, clear_words, stream)
}

// ---------------------------------------------------------------------
// block-wide scans

template <class T>
__device__ __forceinline__ T warp_inclusive_sum(T v) {
    const int lane = threadIdx.x & 31;
    for (int o = 1; o < 32; o <<= 1) {
        T y = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += y;
    }
    return v;
}

// Exclusive prefix sum of v over the block's threads; *total gets the sum.
// warp_tot: RT_WARPS elements of shared memory.
template <class T>
__device__ __forceinline__ T block_exclusive_sum(T v, T* warp_tot, T* total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    T inc = warp_inclusive_sum(v);
    if (lane == 31) warp_tot[warp] = inc;
    __syncthreads();
    if (warp == 0) {
        T w = lane < RT_WARPS ? warp_tot[lane] : T(0);
        w = warp_inclusive_sum(w);
        if (lane < RT_WARPS) warp_tot[lane] = w;
    }
    __syncthreads();
    T before = warp > 0 ? warp_tot[warp - 1] : T(0);
    *total = warp_tot[RT_WARPS - 1];
    __syncthreads();  // warp_tot may be reused
    return before + inc - v;
}

// ---------------------------------------------------------------------
// the plan: blocks in proportion to the tiles each query reads
//
// One block lays out a selection grid of `grid` blocks: query i takes
// n_i = max(1, ceil(tiles(i) / P)) blocks, or none when tiles(i) < 0,
// P = max(min_tiles, ceil(sum of tiles / work_blocks)), so a light query
// takes one block, a heavy one many, and sum n_i <= work_blocks + nq <=
// grid.  Writes each query's first block and block count, resets its
// finished-block count, and each block's query (-1 past the last).
template <class Tiles>
__device__ void plan_blocks(int nq, Tiles tiles, int min_tiles,
                            int work_blocks, int grid, int* q_first,
                            int* q_blocks, int* q_done, int* block_q) {
    __shared__ int wsum[RT_WARPS];
    int own = 0, all = 0, carry = 0;
    for (int i = threadIdx.x; i < nq; i += RT_THREADS)
        own += max(tiles(i), 0);
    block_exclusive_sum(own, wsum, &all);
    const int per = max(min_tiles, (all + work_blocks - 1) / work_blocks);
    // each query's blocks, scanned in rounds of RT_THREADS queries
    for (int i0 = 0; i0 < nq; i0 += RT_THREADS) {
        const int i = i0 + threadIdx.x;
        int nb = 0;
        if (i < nq) {
            const int t = tiles(i);
            nb = t < 0 ? 0 : max(1, (t + per - 1) / per);
        }
        int round;
        const int first = carry + block_exclusive_sum(nb, wsum, &round);
        if (i < nq) {
            q_first[i] = first;
            q_blocks[i] = nb;
            q_done[i] = 0;
            for (int j = 0; j < nb; ++j) block_q[first + j] = i;
        }
        carry += round;
    }
    for (int b = carry + threadIdx.x; b < grid; b += RT_THREADS)
        block_q[b] = -1;
}

// ---------------------------------------------------------------------
// the running top-k list of a block

// Number of keys < key in a sorted list (empty keys sort last).
__device__ __forceinline__ int count_below(const unsigned long long* list,
                                           int len, unsigned long long key) {
    int lo = 0, hi = len;
    while (lo < hi) {
        int mid = (lo + hi) >> 1;
        if (list[mid] < key) lo = mid + 1; else hi = mid;
    }
    return lo;
}

// Ascending bitonic sort of keys[0, n), n a power of two <= RT_TILE.
__device__ __forceinline__ void block_sort(unsigned long long* keys, int n) {
    for (int size = 2; size <= n; size <<= 1) {
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
            for (int p = threadIdx.x; p < n / 2; p += RT_THREADS) {
                // 2 stride (p / stride) + p % stride, stride a power of two
                int i = ((p & ~(stride - 1)) << 1) | (p & (stride - 1));
                int j = i + stride;
                bool up = (i & size) == 0;
                unsigned long long a = keys[i], c = keys[j];
                if ((a > c) == up) {
                    keys[i] = c;
                    keys[j] = a;
                }
            }
            __syncthreads();
        }
    }
}

// Merge the c > 0 collected candidate keys cand[0, c) (unsorted, c <=
// RT_TILE) into the block's running top-kk list (run, rv), writing the new
// list to (nxt, nv); value(key) is a candidate's score.  Sorts cand.
template <class ValueOf>
__device__ __forceinline__ void merge_candidates(
    unsigned long long* cand, int c, int kk, const unsigned long long* run,
    const float* rv, unsigned long long* nxt, float* nv, ValueOf value) {
    int p2 = 1;
    while (p2 < c) p2 <<= 1;
    for (int i = c + threadIdx.x; i < p2; i += RT_THREADS)
        cand[i] = RT_EMPTY_KEY;
    __syncthreads();
    block_sort(cand, p2);
    // top kk of run[0, kk) and cand[0, lc)
    const int lc = c < kk ? c : kk;
    const int live = count_below(run, kk, RT_EMPTY_KEY) + lc;
    for (int i = threadIdx.x; i < kk; i += RT_THREADS) {
        unsigned long long key = run[i];
        if (key != RT_EMPTY_KEY) {
            int r = i + count_below(cand, lc, key);
            if (r < kk) {
                nxt[r] = key;
                nv[r] = rv[i];
            }
        }
        if (i < lc) {
            key = cand[i];
            int r = i + count_below(run, kk, key);
            if (r < kk) {
                nxt[r] = key;
                nv[r] = value(key);
            }
        }
        if (i >= live) {
            nxt[i] = RT_EMPTY_KEY;
            nv[i] = -INFINITY;
        }
    }
}

// Append each admitted key[u] (ok[u]) of the calling threads to cand, one
// shared atomic per warp.  Every lane of the warp calls it.
__device__ __forceinline__ void push_candidates(
    const unsigned long long key[4], const bool ok[4],
    unsigned long long* cand, int* n_cand) {
    const int cnt = (int)ok[0] + (int)ok[1] + (int)ok[2] + (int)ok[3];
    const int inc = warp_inclusive_sum(cnt);
    const int total = __shfl_sync(0xffffffffu, inc, 31);
    int base = 0;
    if ((threadIdx.x & 31) == 31 && total > 0) base = atomicAdd(n_cand, total);
    int o = __shfl_sync(0xffffffffu, base, 31) + inc - cnt;
    for (int u = 0; u < 4; ++u)
        if (ok[u]) cand[o++] = key[u];
}

// A block's running list (run, rv) and its next version (nxt, nv): in
// dynamic shared memory (smem, 24 * k bytes) while k <= RT_TILE, else
// ping-ponging between the block's k-long slices of the query lists
// (lists, list_vals) and of (alt, alt_vals).  (ko, vo) is the block's
// slot of the query lists, which the query's last block reads.
struct RunList {
    unsigned long long* run;
    unsigned long long* nxt;
    float* rv;
    float* nv;
    unsigned long long* ko;
    float* vo;
};

__device__ __forceinline__ RunList run_list(unsigned long long* smem, int k,
                                            long long b,
                                            unsigned long long* lists,
                                            float* list_vals,
                                            unsigned long long* alt,
                                            float* alt_vals) {
    RunList l;
    l.ko = lists + b * (long long)k;
    l.vo = list_vals + b * (long long)k;
    const bool in_shared = k <= RT_TILE;
    float* sv = (float*)(smem + 2 * k);
    l.run = in_shared ? smem : l.ko;
    l.nxt = in_shared ? smem + k : alt + b * (long long)k;
    l.rv = in_shared ? sv : l.vo;
    l.nv = in_shared ? sv + k : alt_vals + b * (long long)k;
    for (int i = threadIdx.x; i < k; i += RT_THREADS) {
        l.run[i] = RT_EMPTY_KEY;
        l.rv[i] = -INFINITY;
    }
    return l;  // published by the caller's next __syncthreads
}

__device__ __forceinline__ void swap_lists(RunList& l) {
    unsigned long long* tk = l.run;
    l.run = l.nxt;
    l.nxt = tk;
    float* tv = l.rv;
    l.rv = l.nv;
    l.nv = tv;
}

// The key a candidate of the block must be below, after a __syncthreads
// that published the running list: the list's k-th key (empty until it is
// full) or the query's shared key q_thr, whichever is less.  Thread 0
// publishes the block's own k-th key to q_thr when it improves on what the
// block published before (*published, thread 0's own).  The shared key is
// read without a barrier, so threads may see different keys; each is an
// upper bound of the query's k-th key, and a stale one only admits more.
__device__ __forceinline__ unsigned long long running_threshold(
    const unsigned long long* run, int k, unsigned long long* q_thr,
    unsigned long long* published) {
    unsigned long long thr = run[k - 1];
    if (threadIdx.x == 0 && thr < *published) {
        atomicMin(q_thr, thr);
        *published = thr;
    }
    const unsigned long long shared_thr =
        *(volatile const unsigned long long*)q_thr;
    return shared_thr < thr ? shared_thr : thr;
}

// The block's list to its slot of the query lists, unless it is a global
// list that already lies there.
__device__ __forceinline__ void write_list(const RunList& l, int k) {
    __syncthreads();
    if (l.run == l.ko) return;
    for (int i = threadIdx.x; i < k; i += RT_THREADS) {
        l.ko[i] = l.run[i];
        l.vo[i] = l.rv[i];
    }
}

// After a block's last tile: with one block for its query (n_blocks == 1)
// it is the query's writer.  Else it writes its list to its slot, counts
// itself done in *done, and the query's last block to finish merges the
// keys of every other block's list (slots first .. first + n_blocks - 1 of
// lists, laid end to end) into its own, and is the writer.  It reads them
// RT_TILE at a time and collects those below its running k-th key; it
// merges once k are collected (so that its k-th key tightens) or when the
// next batch might not fit beside them, so that lists holding few live
// keys cost one merge.
// Returns whether the calling block is the writer (uniform).  cand (RT_TILE
// keys) and last are the block's shared scratch.
template <class ValueOf>
__device__ __forceinline__ bool finish_query(
    RunList& l, int k, long long b, int first, int n_blocks, int* done,
    const unsigned long long* lists, ValueOf value,
    unsigned long long* cand, int* last) {
    __shared__ int wsum[RT_WARPS];
    if (n_blocks > 1) {
        write_list(l, k);
        __threadfence();  // the list, before the count that publishes it
        __syncthreads();
        if (threadIdx.x == 0) *last = atomicAdd(done, 1) == n_blocks - 1;
        __syncthreads();
        if (!*last) return false;
        __threadfence();
        const long long others = (long long)(n_blocks - 1) * k;
        int c = 0;  // collected, uniform
        unsigned long long thr = l.run[k - 1];
        for (long long base = 0; base < others; base += RT_TILE) {
            unsigned long long key[4];
            bool ok[4];
            int cnt = 0;
            for (int u = 0; u < 4; ++u) {
                const long long f = base + u * RT_THREADS + threadIdx.x;
                const long long o = first + f / k;  // skipping this block's
                key[u] = f < others
                             ? __ldcg(lists + (o + (o >= b ? 1 : 0)) * k + f % k)
                             : RT_EMPTY_KEY;
                ok[u] = key[u] < thr;
                cnt += ok[u];
            }
            int total;
            int at = block_exclusive_sum(cnt, wsum, &total);
            if (c + total > RT_TILE) {
                merge_candidates(cand, c, k, l.run, l.rv, l.nxt, l.nv, value);
                swap_lists(l);
                c = 0;
                __syncthreads();  // cand is free again
            }
            for (int u = 0; u < 4; ++u)
                if (ok[u]) cand[c + at++] = key[u];
            c += total;
            __syncthreads();
            if (c >= k) {
                merge_candidates(cand, c, k, l.run, l.rv, l.nxt, l.nv, value);
                swap_lists(l);
                c = 0;
                __syncthreads();
            }
            thr = l.run[k - 1];
        }
        if (c > 0) {
            merge_candidates(cand, c, k, l.run, l.rv, l.nxt, l.nv, value);
            swap_lists(l);
        }
    }
    __syncthreads();
    return true;
}

// The running list as result row `row`: (f32 value, int32 position) with
// (-inf, -1) past the live count.
__device__ __forceinline__ void write_row(const RunList& l, int k,
                                          float* out_vals, int* out_pos,
                                          int row) {
    for (int i = threadIdx.x; i < k; i += RT_THREADS) {
        out_vals[(long long)row * k + i] = l.rv[i];
        out_pos[(long long)row * k + i] =
            l.run[i] == RT_EMPTY_KEY ? -1 : (int)(unsigned int)l.run[i];
    }
}
