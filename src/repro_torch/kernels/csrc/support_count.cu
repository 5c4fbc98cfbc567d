// Itemset support counting over vertical transaction bitmaps.
//
// Replaces the TPU kernel repro/kernels/support_count.py::support_count_pallas,
// which counts counts[c] = sum_t [(TX @ M^T)[t, c] == |c|] as a dense 0/1
// product on the matrix unit (TX: [T, I] transactions, M: [C, I] candidates).
// A candidate holds a handful of the thousands of items (at most 7 of 3,600
// at the retail operating point, about 0.2% dense), so that product is almost
// all zeros.  Here the same counts come from the vertical bitmaps of
// arm/transactions.py (uint32 [I, W], bit t of row i set when transaction t
// holds item i): counts[c] = popcount(AND of the bitmap rows of c's items).
//
// What bounds it on this card: bytes.  The work is 2 * sum_c |c| * W word
// operations (an AND and a popcount-add per word), far under the card's
// integer rate; the bitmaps (8 MB at the retail operating point) fit the
// 50 MB L2, so each candidate's rereads of its item rows are L2 traffic, and
// device memory sees each row about once, plus the candidate rows and the
// counts.
//
// Design, simple first: one warp per candidate row.  The warp walks the W
// words 32 at a time, one word per lane; for each chunk it loads the row's
// item ids (lane j holds item j), keeps the valid ones in a ballot mask, and
// broadcasts them one by one with __shfl_sync, ANDing that item's word into
// the lane's accumulator.  __popc per word, a __reduce_add_sync across the
// warp, and lane 0 writes the count.
//
// Semantics, matching the reference's distinct-set count (ops.py:419-421):
// a negative entry is skipped wherever it sits in the row; a repeated item
// counts once (AND is idempotent); a row with lengths <= 0 counts 0; a row
// with lengths > 0 and no valid item counts every transaction (Support of
// the empty set), which the tail mask makes exact: the accumulator starts
// all ones, and the padding bits past the last transaction are cleared.
// Item ids are < I (the wrapper checks).
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int SC_WARPS = 8;  // candidate rows per 256-thread block
constexpr unsigned SC_FULL = 0xffffffffu;

__global__ void __launch_bounds__(SC_WARPS * 32)
support_count_kernel(const uint32_t* __restrict__ bitmaps, int n_words,
                     const int* __restrict__ cand, int c, int k,
                     const int* __restrict__ lengths, uint32_t tail_mask,
                     int* __restrict__ counts) {
    const int lane = threadIdx.x & 31;
    const long long row = (long long)blockIdx.x * SC_WARPS + (threadIdx.x >> 5);
    if (row >= c) return;  // warp-uniform: the whole warp leaves together
    if (lengths[row] <= 0) {
        if (lane == 0) counts[row] = 0;
        return;
    }
    const int* items = cand + row * (long long)k;
    unsigned total = 0;
    for (int w0 = 0; w0 < n_words; w0 += 32) {
        const int w = w0 + lane;
        const bool live = w < n_words;
        uint32_t acc = SC_FULL;
        for (int j0 = 0; j0 < k; j0 += 32) {
            const int it = (j0 + lane < k) ? items[j0 + lane] : -1;
            unsigned valid = __ballot_sync(SC_FULL, it >= 0);
            while (valid) {
                const int src = __ffs(valid) - 1;
                valid &= valid - 1;
                const int item = __shfl_sync(SC_FULL, it, src);
                if (live) acc &= bitmaps[(long long)item * n_words + w];
            }
        }
        if (w == n_words - 1) acc &= tail_mask;
        if (live) total += __popc(acc);
    }
    total = __reduce_add_sync(SC_FULL, total);
    if (lane == 0) counts[row] = (int)total;
}

extern "C" int support_count_launch(const uint32_t* bitmaps, int n_words,
                                    const int* cand, int c, int k,
                                    const int* lengths, int n_transactions,
                                    int* counts, void* stream) {
    if (c <= 0) return (int)cudaSuccess;
    const int tail = n_transactions % 32;
    const uint32_t tail_mask = tail ? ((1u << tail) - 1u) : SC_FULL;
    const long long blocks = ((long long)c + SC_WARPS - 1) / SC_WARPS;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    support_count_kernel<<<(unsigned)blocks, SC_WARPS * 32, 0,
                           (cudaStream_t)stream>>>(
        bitmaps, n_words, cand, c, k, lengths, tail_mask, counts);
    return (int)cudaGetLastError();
}
