// Segmented top-k rank kernel.
//
// Replaces the TPU kernel repro/kernels/rank.py::topk_rank_batch_pallas
// (and its Q=1 slice topk_rank_pallas): for each query, the top-k of
// rank_score(metric) over the DFS range [lo, hi), nodes at depth >= min_depth
// only, in (value desc, position asc) order with (-inf, -1) empty slots.
//
// Quantized columns (the compressed layout: int32 support counts, bf16 or
// int8 confidence and lift) are read in their storage types and widened in
// the score pass (topk_select.cuh), as the TPU kernel widens them per tile.
//
// What bounds it here: memory.  The columns (at most 16 bytes per
// position: three f32 metrics and the int32 depth) are read once into the
// masked score column, then each query reads 4 bytes per position of its
// range; the few flops per position are far below the card's rate.  The
// TPU kernel sweeps all N positions for every query and masks outside
// [lo, hi); here each query's blocks cover only its own range, and a block
// streams its chunk of tiles once, sorting only the few positions that beat
// its running k-th best (topk_select.cuh), then pairwise merges in global
// memory take any k.
#include "topk_select.cuh"

struct RangeSource {
    const float* scores;
    const int* los;  // clamped to [0, n] by the wrapper
    const int* his;

    __device__ int tile_count(int q) const {
        int span = his[q] - los[q];
        return span > 0 ? (span + RT_TILE - 1) / RT_TILE : 0;
    }
    __device__ int tile_base(int q, int t) const { return los[q] + t * RT_TILE; }
    __device__ bool tile_may_hit(int, int) const { return true; }
    __device__ bool in_range(int q, int pos) const { return pos < his[q]; }
    __device__ bool member(int, int) const { return true; }
};

extern "C" int topk_rank_batch_launch(
    const void* sup, const void* conf, const void* lift, int sup_type,
    int col_type, float inv_n, float conf_scale, float lift_scale,
    const int* depth, int n, const int* los, const int* his, int q, int k,
    int metric,
    int min_depth, int n_chunks, int tiles_per_chunk, float* scores,
    unsigned long long* keys_a, float* vals_a, unsigned long long* keys_b,
    float* vals_b, long long scratch_cap, float* out_vals, int* out_pos,
    void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    int kk = chunk_list_len(k, tiles_per_chunk);
    long long blocks = (long long)q * n_chunks;
    if (blocks > 0x7fffffffLL || blocks * kk > scratch_cap)
        return (int)cudaErrorInvalidValue;
    MetricColumns m{sup, conf, lift, sup_type, col_type,
                    inv_n, conf_scale, lift_scale};
    cudaError_t err = launch_scores(m, depth, n, metric, min_depth, scores, s);
    if (err != cudaSuccess) return (int)err;
    RangeSource src{scores, los, his};
    chunk_topk_kernel<RangeSource><<<(unsigned int)blocks, RT_THREADS, 0, s>>>(
        src, n_chunks, tiles_per_chunk, kk, keys_a, vals_a, keys_b, vals_b);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return (int)merge_lists(q, n_chunks, kk, k, keys_a, vals_a, keys_b,
                            vals_b, scratch_cap, out_vals, out_pos, s);
}
