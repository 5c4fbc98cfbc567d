// Segmented top-k selection shared by the rank kernel (rank.cu) and the
// item-membership kernel (item_index.cu).
//
// Order: value descending, ties by ascending DFS position -- jax.lax.top_k
// order.  Each candidate becomes one 64-bit key that sorts ascending in that
// order: the high word is the bit-flipped order-preserving image of the f32
// score (+0.0 and -0.0 share it, as they compare equal), the low word the
// position.  Keys of live candidates are distinct because positions are.
// A masked or -inf candidate is the empty key ~0.
//
// Pass 0: the masked score column, once per call (-inf below min_depth),
// so that the Q queries each read 4 bytes per position instead of the
// metric's columns and depth; it fits L2 up to ~12 M positions.
// Pass 1 (one block per (query, chunk of tiles)): stream the chunk's tiles
// of TILE positions, keep the chunk's best kk = min(k, chunk length) sorted
// -- in shared memory while kk <= TILE, else in the block's slices of the
// two global scratch buffers -- and write it as one list.  Only the
// candidates that beat the running kk-th key are sorted (bitonic) and
// merged in, and the costly part of a membership test runs only for them.
// Pass 2 (log2(chunks) launches): merge the lists pairwise.  A merge places
// every live element at its rank in the union -- its index in its own list
// plus a binary search in the other list -- so it takes any k; lists stay
// in global scratch.  Scratch is Q x chunks x kk, whatever k is.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "metrics.cuh"

#define RT_TILE 1024
#define RT_THREADS 256
#define RT_EMPTY_KEY (~0ULL)

__device__ __forceinline__ unsigned long long topk_key(float score, int pos) {
    if (!(score > -INFINITY) && !(score != score)) return RT_EMPTY_KEY;
    float s = score == 0.0f ? 0.0f : score;  // one key for +0.0 and -0.0
    unsigned int u = __float_as_uint(s);
    u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);  // ascending image
    return ((unsigned long long)(~u) << 32) | (unsigned int)pos;
}

// Pass 0 reads the metric columns in their storage types (S: f32, int32
// counts or bf16 support; C: f32, bf16 or int8 confidence and lift) and
// widens them in registers (metrics.cuh::dequantize), so a quantized
// trie's columns are never copied to f32 in device memory.  It loads only
// the columns the metric reads (metric_reads_*: the branch is uniform
// across the grid), and none below min_depth.
template <class S, class C>
__global__ void __launch_bounds__(RT_THREADS)
score_kernel(const S* __restrict__ sup, const C* __restrict__ conf,
             const C* __restrict__ lift, const int* __restrict__ depth,
             int n, int metric, int min_depth, float inv_n, float conf_scale,
             float lift_scale, float* __restrict__ out) {
    int i = blockIdx.x * RT_THREADS + threadIdx.x;
    if (i >= n) return;
    float score = -INFINITY;
    if (depth[i] >= min_depth) {
        float s = metric_reads_support(metric) ? dequantize(sup[i], inv_n)
                                               : 0.0f;
        float c = metric_reads_confidence(metric)
                      ? dequantize(conf[i], conf_scale)
                      : 0.0f;
        float l = metric_reads_lift(metric) ? dequantize(lift[i], lift_scale)
                                            : 0.0f;
        score = rank_score(metric, s, c, l);
    }
    out[i] = score;
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
                                       cudaStream_t stream) {
    score_kernel<S, C><<<(n + RT_THREADS - 1) / RT_THREADS, RT_THREADS, 0,
                         stream>>>(
        (const S*)m.sup, (const C*)m.conf, (const C*)m.lift, depth, n,
        metric, min_depth, m.inv_n, m.conf_scale, m.lift_scale, scores);
    return cudaGetLastError();
}

static cudaError_t launch_scores(const MetricColumns& m, const int* depth,
                                 int n, int metric, int min_depth,
                                 float* scores, cudaStream_t stream) {
    RT_DISPATCH_COLUMNS(m.sup_type, m.col_type, launch_scores_typed, m,
                        depth, n, metric, min_depth, scores, stream)
}

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
                int i = 2 * stride * (p / stride) + (p % stride);
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

// Pass 1.  One block per (query, chunk of tiles_per_chunk tiles); it keeps
// the chunk's running top-kk sorted, in shared memory for kk <= RT_TILE,
// else ping-ponging between its kk-long slices of (keys_out, vals_out) and
// (keys_alt, vals_alt).  A tile adds at most RT_TILE candidates, so those
// always fit shared memory.  For each tile, only candidates whose key beats
// the running kk-th key are collected, sorted and merged in, so once the
// list is full most tiles cost one streaming pass.  Src provides:
//   int tile_count(int q)            tiles in the query's candidate range
//   int tile_base(int q, int t)      first position of tile t of query q
//   bool tile_may_hit(int q, int base)  false if no position of the tile
//                                    starting at base can be a member
//   bool in_range(int q, int pos)    pos lies in the query's range
//   bool member(int q, int pos)      remaining membership test (costly)
//   const float* scores              pass 0's masked score column
template <class Src>
__global__ void __launch_bounds__(RT_THREADS)
chunk_topk_kernel(Src src, int n_chunks, int tiles_per_chunk, int kk,
                  unsigned long long* keys_out, float* vals_out,
                  unsigned long long* keys_alt, float* vals_alt) {
    __shared__ unsigned long long cand[RT_TILE];
    __shared__ float tile_vals[RT_TILE];
    __shared__ unsigned long long run_a[RT_TILE], run_b[RT_TILE];
    __shared__ float rv_a[RT_TILE], rv_b[RT_TILE];
    __shared__ int n_cand;
    const long long b = blockIdx.x;
    const int q = (int)(b / n_chunks);
    const int chunk = (int)(b % n_chunks);
    unsigned long long* ko = keys_out + b * (long long)kk;
    float* vo = vals_out + b * (long long)kk;
    const bool in_shared = kk <= RT_TILE;
    unsigned long long* run = in_shared ? run_a : ko;
    unsigned long long* nxt = in_shared ? run_b : keys_alt + b * (long long)kk;
    float* rv = in_shared ? rv_a : vo;
    float* nv = in_shared ? rv_b : vals_alt + b * (long long)kk;
    for (int i = threadIdx.x; i < kk; i += RT_THREADS) {
        run[i] = RT_EMPTY_KEY;
        rv[i] = -INFINITY;
    }
    int t_end = min(src.tile_count(q), (chunk + 1) * tiles_per_chunk);
    for (int t = chunk * tiles_per_chunk; t < t_end; ++t) {
        const int base = src.tile_base(q, t);
        if (!src.tile_may_hit(q, base)) continue;  // uniform over the block
        if (threadIdx.x == 0) n_cand = 0;
        __syncthreads();  // also publishes the running list
        const unsigned long long thr = run[kk - 1];
        for (int i = threadIdx.x; i < RT_TILE; i += RT_THREADS) {
            int pos = base + i;
            if (!src.in_range(q, pos)) continue;
            float s = src.scores[pos];
            unsigned long long key = topk_key(s, pos);
            if (key < thr && src.member(q, pos)) {
                tile_vals[i] = s;
                cand[atomicAdd(&n_cand, 1)] = key;
            }
        }
        __syncthreads();
        const int c = n_cand;
        __syncthreads();  // every thread has c before the next reset
        if (c == 0) continue;
        int p2 = 1;
        while (p2 < c) p2 <<= 1;
        for (int i = c + threadIdx.x; i < p2; i += RT_THREADS)
            cand[i] = RT_EMPTY_KEY;
        __syncthreads();
        block_sort(cand, p2);
        // merge: top kk of run[0, kk) and cand[0, lc)
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
                    nv[r] = tile_vals[(int)(unsigned int)key - base];
                }
            }
            if (i >= live) {
                nxt[i] = RT_EMPTY_KEY;
                nv[i] = -INFINITY;
            }
        }
        unsigned long long* tk = run;
        run = nxt;
        nxt = tk;
        float* tv = rv;
        rv = nv;
        nv = tv;
    }
    __syncthreads();
    if (run == ko) return;  // a global list that ended in place
    for (int i = threadIdx.x; i < kk; i += RT_THREADS) {
        ko[i] = run[i];
        vo[i] = rv[i];
    }
}

// Pass 2: lists 2p and 2p+1 (of n_in, each l_in long) of every query merge
// into list p (of n_out, l_out long).  The last level writes the caller's
// (f32 value, int32 position) rows with (-inf, -1) past the live count.
__global__ void __launch_bounds__(RT_THREADS)
merge_pairs_kernel(const unsigned long long* __restrict__ kin,
                   const float* __restrict__ vin, int n_in, int l_in,
                   unsigned long long* __restrict__ kout,
                   float* __restrict__ vout, int* __restrict__ pout,
                   int n_out, int l_out, int blocks_per_pair) {
    const long long pair = blockIdx.x / blocks_per_pair;  // q * n_out + p
    const int q = (int)(pair / n_out);
    const int p = (int)(pair % n_out);
    const int i = (blockIdx.x % blocks_per_pair) * RT_THREADS + threadIdx.x;
    const long long a_off = ((long long)q * n_in + 2 * p) * l_in;
    const unsigned long long* ka = kin + a_off;
    const float* va = vin + a_off;
    const bool has_b = 2 * p + 1 < n_in;
    const int lb = has_b ? l_in : 0;
    const unsigned long long* kb = ka + l_in;
    const float* vb = va + l_in;
    const long long o_off = pair * (long long)l_out;

    auto put = [&](int rank, unsigned long long key, float v) {
        if (pout) {
            vout[o_off + rank] = v;
            pout[o_off + rank] =
                key == RT_EMPTY_KEY ? -1 : (int)(unsigned int)key;
        } else {
            kout[o_off + rank] = key;
            vout[o_off + rank] = v;
        }
    };
    if (i < l_in) {
        unsigned long long key = ka[i];
        if (key != RT_EMPTY_KEY) {
            int rank = i + count_below(kb, lb, key);
            if (rank < l_out) put(rank, key, va[i]);
        }
        if (has_b) {
            key = kb[i];
            if (key != RT_EMPTY_KEY) {
                int rank = i + count_below(ka, l_in, key);
                if (rank < l_out) put(rank, key, vb[i]);
            }
        }
    }
    if (i < l_out) {
        int live = count_below(ka, l_in, RT_EMPTY_KEY) +
                   count_below(kb, lb, RT_EMPTY_KEY);
        if (i >= live) put(i, RT_EMPTY_KEY, -INFINITY);
    }
}

// Length of each chunk's list: k, or the chunk's positions if fewer.
static inline int chunk_list_len(int k, int tiles_per_chunk) {
    long long cap = (long long)tiles_per_chunk * RT_TILE;
    return k < cap ? k : (int)cap;
}

// Host side of pass 2: merge q * n_lists lists of kk (in buffer a) down to
// one row of k per query in (out_vals, out_pos).  a and b each hold
// scratch_cap elements; a level that would not fit is refused.
static cudaError_t merge_lists(
    int q, int n_lists, int kk, int k, unsigned long long* keys_a,
    float* vals_a, unsigned long long* keys_b, float* vals_b,
    long long scratch_cap, float* out_vals, int* out_pos,
    cudaStream_t stream) {
    int n = n_lists, l = kk;
    unsigned long long* kin = keys_a;
    float* vin = vals_a;
    unsigned long long* kalt = keys_b;
    float* valt = vals_b;
    while (true) {
        int n_out = (n + 1) / 2;
        bool last = n_out == 1;
        int l_out = last ? k : (2LL * l < k ? 2 * l : k);
        if (!last && (long long)q * n_out * l_out > scratch_cap)
            return cudaErrorInvalidValue;
        int work = l > l_out ? l : l_out;
        int bpp = (work + RT_THREADS - 1) / RT_THREADS;
        long long blocks = (long long)q * n_out * bpp;
        if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
        merge_pairs_kernel<<<(unsigned int)blocks, RT_THREADS, 0, stream>>>(
            kin, vin, n, l, last ? nullptr : kalt, last ? out_vals : valt,
            last ? out_pos : nullptr, n_out, l_out, bpp);
        cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess || last) return err;
        unsigned long long* tk = kin;
        float* tv = vin;
        kin = kalt;
        vin = valt;
        kalt = tk;
        valt = tv;
        n = n_out;
        l = l_out;
    }
}
