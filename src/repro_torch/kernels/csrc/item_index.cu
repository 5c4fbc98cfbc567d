// Item-membership top-k kernel.
//
// Replaces the TPU kernel repro/kernels/item_index.py::rules_with_pallas:
// for each queried item, the top-k rules that involve it, by role --
//   consequent: node_item[p] == item;
//   antecedent: a strict ancestor carries the item;
//   any:        either.
// Ancestor membership is the laminar range count over the item's posting
// slice [plo, phi):  #(post_lo <= p) - #(post_hi <= p), both sides sorted,
// so two binary searches per position; the antecedent role subtracts the
// node's own entry.
//
// Quantized columns (the compressed layout) are widened in the score pass,
// as in rank.cu.  On that layout the consequent role runs here too (there
// is no posting-ordered column block): its test is the node_item
// self-hit alone.
//
// What bounds it here: memory.  Every query visits all N positions (the
// candidate set is scattered over the DFS order), so the columns are read
// once into a masked score column (4 bytes per position, in L2 up to ~12 M
// positions) that the Q queries then stream.  Membership costs two
// dependent binary searches of log2(slice) steps over post_lo and post_hi;
// they run only for positions whose score beats the running k-th best
// (topk_select.cuh), and a tile no posting range touches is skipped whole.
// The TPU kernel's two posting layouts (whole arrays in VMEM, or per-query
// gathered windows) were VMEM residencies of one function; here the slice
// is read in place in device memory, through L2.
#include "topk_select.cuh"

enum Role { RT_CONSEQUENT = 0, RT_ANTECEDENT = 1, RT_ANY = 2 };

// |{j in [lo, hi) : arr[j] <= x}|, arr ascending on the slice
__device__ __forceinline__ int count_le(const int* arr, int lo, int hi, int x) {
    int a = lo, b = hi;
    while (a < b) {
        int mid = (a + b) >> 1;
        if (arr[mid] <= x) a = mid + 1; else b = mid;
    }
    return a - lo;
}

struct MemberSource {
    const float* scores;
    const int* node_item;
    const int* post_lo;
    const int* post_hi;
    const int* plos;
    const int* phis;
    const int* items;
    int n;
    int role;

    __device__ int tile_count(int) const { return (n + RT_TILE - 1) / RT_TILE; }
    __device__ int tile_base(int, int t) const { return t * RT_TILE; }
    // A member lies inside one of the item's posting ranges, so a tile
    // that no range covers at its first position and none starts in has
    // none: after the first tiles of a rare item most tiles skip whole.
    __device__ bool tile_may_hit(int q, int base) const {
        if (role == RT_CONSEQUENT) return true;
        int lo = plos[q], hi = phis[q];
        if (lo >= hi) return false;
        int last = min(base + RT_TILE, n) - 1;
        int starts = count_le(post_lo, lo, hi, base);
        return starts - count_le(post_hi, lo, hi, base) > 0 ||
               count_le(post_lo, lo, hi, last) > starts;
    }
    __device__ bool in_range(int, int pos) const { return pos < n; }
    __device__ bool member(int q, int pos) const {
        bool self_hit = node_item[pos] == items[q];
        if (role == RT_CONSEQUENT) return self_hit;
        int lo = plos[q], hi = phis[q];
        int cnt = count_le(post_lo, lo, hi, pos) - count_le(post_hi, lo, hi, pos);
        if (role == RT_ANTECEDENT) cnt -= self_hit ? 1 : 0;
        return cnt > 0;
    }
};

extern "C" int rules_with_launch(
    const void* sup, const void* conf, const void* lift, int sup_type,
    int col_type, float inv_n, float conf_scale, float lift_scale,
    const int* depth, const int* node_item, int n, const int* post_lo,
    const int* post_hi,
    const int* plos, const int* phis, const int* items, int q, int k,
    int metric, int min_depth, int role, int n_chunks, int tiles_per_chunk,
    float* scores, unsigned long long* keys_a, float* vals_a,
    unsigned long long* keys_b, float* vals_b, long long scratch_cap,
    float* out_vals, int* out_pos, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    int kk = chunk_list_len(k, tiles_per_chunk);
    long long blocks = (long long)q * n_chunks;
    if (blocks > 0x7fffffffLL || blocks * kk > scratch_cap)
        return (int)cudaErrorInvalidValue;
    MetricColumns m{sup, conf, lift, sup_type, col_type,
                    inv_n, conf_scale, lift_scale};
    cudaError_t err = launch_scores(m, depth, n, metric, min_depth, scores, s);
    if (err != cudaSuccess) return (int)err;
    MemberSource src{scores, node_item, post_lo, post_hi, plos, phis, items,
                     n, role};
    chunk_topk_kernel<MemberSource><<<(unsigned int)blocks, RT_THREADS, 0, s>>>(
        src, n_chunks, tiles_per_chunk, kk, keys_a, vals_a, keys_b, vals_b);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return (int)merge_lists(q, n_chunks, kk, k, keys_a, vals_a, keys_b,
                            vals_b, scratch_cap, out_vals, out_pos, s);
}
