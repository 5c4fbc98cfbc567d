// Itemset support counting over vertical transaction bitmaps.
//
// Replaces the TPU kernel repro/kernels/support_count.py::support_count_pallas,
// which counts counts[c] = sum_t [(TX @ M^T)[t, c] == |c|] as a dense 0/1
// product on the matrix unit (TX: [T, I] transactions, M: [C, I] candidates),
// with a tile of transactions held in VMEM and multiplied against a whole
// tile of candidates.  A candidate holds a handful of the thousands of items
// (at most 7 of 3,600 at the retail operating point), so that product is
// almost all zeros.  Here the same counts come from the vertical bitmaps of
// arm/transactions.py (uint32 [I, W], bit t of row i set when transaction t
// holds item i): counts[c] = popcount(AND of the bitmap rows of c's items).
//
// What bounds it on this card.  Not device memory: one build's launches
// touch at most 462 distinct item rows, 1.04 MB of the 8.1 MB bitmap.  What
// the TPU kernel keeps in VMEM is the reuse of a transaction tile by every
// candidate.  The first port (one warp per candidate, each lane loading one
// 4-byte word of each item row from L2 through a dependent chain) dropped
// that reuse: one retail build (online_retail_db(), minsup 0.002, W = 563
// words, 8 launches, sum C = 196,804) read about 1.23 GB of item rows from
// L2, each word of a distinct row some 460 times at level 2.  Once the rows
// are on chip, what is left is the arithmetic and the on-chip reads: an AND
// per item and a popcount per word of each candidate, sum C x W = 1.1e8
// popcounts a build.  32-bit __popc issues at 16 a clock per SM on compute
// capability 9.0, so a build needs about 0.027 ms at 1.98 GHz whatever the
// design (level 2 alone, 106,491 x 563, about 0.015 ms); shared memory
// serves 32 words a clock per SM, K words per candidate word, the same
// order again.
//
// Design, from what the TPU kernel keeps out of device memory:
//   1. The pre-pass (a memset and support_mark_kernel): every block marks
//      the valid ids of its share of the matrix in a bitmask in shared
//      memory, ORs it into a global bitmask and adds the bits it set first
//      to D (atomicOr returns the word before), takes the largest id with
//      atomicMax, and zeroes its share of the counts, inside the plan.  The
//      wrapper reads (largest id, D) back in one 8-byte copy, raises on an
//      id >= I before the main launch, and sizes the main launch from D.
//   2. support_tile_kernel: grid (word tile of BW words) x (slice of
//      candidates), one block of SC_THREADS an SM.  A block scans the
//      bitmask into its slot map (slot = the named ids below, in ascending
//      id order) and stages its word tile of all D distinct item rows in
//      shared memory once, every row's copy in flight at once (cp.async,
//      4-byte, coalesced along the row: a row starts at item * W words,
//      16-byte aligned only when W is a multiple of 4), plus a mask row
//      (ones, the tail mask at word W - 1, zeros past W).  Every candidate
//      of its slice then reads its items' words from there: each thread
//      holds one candidate, ANDs its valid items' staged words in registers
//      (16-byte loads), popcounts and adds them, and sends the tile's
//      partial count to the output with one integer atomicAdd (none for a
//      zero partial).  The sum is exact in any order.
//      Layout, in place of a padded stride: rows are stored at a stride of BW
//      words, and at step s thread t reads quad s ^ (t mod BW/4) of each of
//      its rows, every item at the same quad.  For BW = 32 the eight threads
//      of a 16-byte access phase then read eight distinct bank quads whatever
//      their rows, so the reads are free of bank conflicts (a padded stride
//      with every thread at the same word leaves random rows colliding), and
//      each address is the row's plus one XOR.
//      One block of 768 threads an SM (its registers allow no second):
//      every block stages the whole tile, so fewer, larger blocks stage
//      less for as many warps.
//   3. Where the rows do not fit even at BW = 4 (about 11,000 distinct items
//      in one launch), the wrapper launches the same kernel with STAGED =
//      false: it reads the rows from device memory (L1 and L2) at BW = 32,
//      without staging.
//
// Semantics, matching the reference's distinct-set count (ops.py:419-421):
// a negative entry is skipped wherever it sits in the row; a repeated item
// counts once (AND is idempotent); a row with lengths <= 0 counts 0; a row
// with lengths > 0 and no valid item counts every transaction (Support of
// the empty set), which the mask row makes exact: the padding bits past the
// last transaction, and the words past W, are cleared.
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int SC_THREADS = 768;        // candidates a tile block holds at once
constexpr int SC_MARK_THREADS = 256;
constexpr int SC_MARK_BLOCKS = 512;    // most blocks of the mark pass
constexpr int SC_MARK_PER = 4;         // entries a mark thread loads at once
constexpr int SC_MARK_SMEM = 48 * 1024;  // its per-block bitmask, at most
constexpr int SC_GLOBAL_BW = 32;       // words a tile of the unstaged variant
constexpr unsigned SC_FULL = 0xffffffffu;

__device__ __forceinline__ uint32_t mask_word(long long w, int n_words,
                                              uint32_t tail_mask) {
    return w < n_words - 1 ? SC_FULL : (w == n_words - 1 ? tail_mask : 0u);
}

// Largest (or sum) of one int a thread over the block (blockDim.x a
// multiple of 32); every thread gets it.
template <bool SUM>
__device__ __forceinline__ int block_reduce(int v, int* warp_buf) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    v = SUM ? __reduce_add_sync(SC_FULL, v) : __reduce_max_sync(SC_FULL, v);
    __syncthreads();
    if (lane == 0) warp_buf[warp] = v;
    __syncthreads();
    v = lane < (int)(blockDim.x >> 5) ? warp_buf[lane] : (SUM ? 0 : -1);
    return SUM ? __reduce_add_sync(SC_FULL, v) : __reduce_max_sync(SC_FULL, v);
}

// Exclusive prefix sum of one int a thread, in thread order; *total gets
// the block's sum.
__device__ __forceinline__ int block_scan(int v, int* warp_buf, int* total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int incl = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(SC_FULL, incl, o);
        if (lane >= o) incl += u;
    }
    __syncthreads();
    if (lane == 31) warp_buf[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        int w = lane < (int)(blockDim.x >> 5) ? warp_buf[lane] : 0;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int u = __shfl_up_sync(SC_FULL, w, o);
            if (lane >= o) w += u;
        }
        warp_buf[lane] = w;
    }
    __syncthreads();
    *total = warp_buf[31];
    return (warp ? warp_buf[warp - 1] : 0) + incl - v;
}

// The pre-pass.  `zeroed` (cleared on the stream just before) holds the
// largest id + 1, D, and the bitmask of the named ids (ceil(I / 32) words).
// Every block marks its share of the entries in a shared bitmask (when it
// fits SC_MARK_SMEM, else straight into the global one), ORs it into the
// global bitmask, counting the bits it sets first (atomicOr returns the
// word before), adds them to D, and zeroes its share of the counts.
__global__ void __launch_bounds__(SC_MARK_THREADS)
support_mark_kernel(const int* __restrict__ cand, long long n_entries, int c,
                    int n_items, unsigned* __restrict__ zeroed,
                    int* __restrict__ counts, int smem_bits) {
    extern __shared__ unsigned sbits[];
    __shared__ int warp_buf[32];
    int* top_enc = reinterpret_cast<int*>(zeroed);
    int* n_named = reinterpret_cast<int*>(zeroed + 1);
    unsigned* bits = zeroed + 2;
    const int nw = (n_items + 31) >> 5;
    if (smem_bits) {
        for (int i = threadIdx.x; i < nw; i += blockDim.x) sbits[i] = 0u;
        __syncthreads();
    }
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long i0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    int top = -1, first = 0;
    // SC_MARK_PER entries a thread, their loads in flight together
    for (long long e0 = i0; e0 < n_entries; e0 += SC_MARK_PER * stride) {
        int id[SC_MARK_PER];
#pragma unroll
        for (int j = 0; j < SC_MARK_PER; ++j) {
            const long long e = e0 + j * stride;
            id[j] = e < n_entries ? cand[e] : -1;
        }
#pragma unroll
        for (int j = 0; j < SC_MARK_PER; ++j) {
            top = max(top, id[j]);
            if (id[j] >= 0 && id[j] < n_items) {
                const unsigned bit = 1u << (id[j] & 31);
                if (smem_bits)
                    atomicOr(sbits + (id[j] >> 5), bit);
                else
                    first += !(atomicOr(bits + (id[j] >> 5), bit) & bit);
            }
        }
    }
    for (long long i = i0; i < c; i += stride) counts[i] = 0;
    top = block_reduce<false>(top, warp_buf);  // also orders the shared marks
    if (smem_bits)
        for (int i = threadIdx.x; i < nw; i += blockDim.x)
            if (sbits[i])
                first += __popc(sbits[i] & ~atomicOr(bits + i, sbits[i]));
    first = block_reduce<true>(first, warp_buf);
    if (threadIdx.x == 0) {
        atomicMax(top_enc, max(top, -1) + 1);
        if (first) atomicAdd(n_named, first);
    }
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(bytes));
}

__device__ __forceinline__ void and_quads(uint4& a, const uint4 v) {
    a.x &= v.x; a.y &= v.y; a.z &= v.z; a.w &= v.w;
}

// Shared memory of a staged block: (d + 1) rows of BW words (the items by
// slot, then the mask row), ceil(I / 32) slot words (the named ids below
// word w << 32 | bitmask word w), then the d items' ids.
template <int BW, bool STAGED>
__global__ void __launch_bounds__(SC_THREADS, 1)
support_tile_kernel(const uint32_t* __restrict__ bitmaps, int n_words,
                    const int* __restrict__ cand, int c, int k,
                    const int* __restrict__ lengths, int n_items,
                    const unsigned* __restrict__ bits, int d,
                    uint32_t tail_mask, int per_slice,
                    int* __restrict__ counts) {
    constexpr int NQ = BW / 4;  // 16-byte quads a row of the tile
    static_assert(BW >= 4 && BW <= 32 && (BW & (BW - 1)) == 0,
                  "BW: a power of two in 4..32");
    extern __shared__ uint4 tile[];
    __shared__ int warp_buf[32];
    const long long w0 = (long long)blockIdx.x * BW;
    const bool last = blockIdx.x == gridDim.x - 1;  // holds word W - 1
    const int nw = (n_items + 31) >> 5;
    uint32_t* words = reinterpret_cast<uint32_t*>(tile);
    unsigned long long* slot_words =
        reinterpret_cast<unsigned long long*>(words + (d + 1) * BW);
    int* ids = reinterpret_cast<int*>(slot_words + nw);
    if (STAGED) {
        // the slot words: the named ids below each bitmask word, and it
        int base = 0;
        for (int wb = 0; wb < nw; wb += blockDim.x) {
            const int w = wb + threadIdx.x;
            const unsigned b = w < nw ? __ldg(bits + w) : 0u;
            int total;
            const int below = base + block_scan(__popc(b), warp_buf, &total);
            if (w < nw) slot_words[w] = (unsigned long long)below << 32 | b;
            base += total;
        }
        for (int i = threadIdx.x; i < BW; i += blockDim.x)
            words[d * BW + i] = mask_word(w0 + i, n_words, tail_mask);
        __syncthreads();
        // the ids by slot, every bit position of the bitmask in parallel
        for (int i = threadIdx.x; i < nw * 32; i += blockDim.x) {
            const unsigned long long e = slot_words[i >> 5];
            const unsigned b = (unsigned)e, below = b & ((1u << (i & 31)) - 1u);
            if ((b >> (i & 31)) & 1u) ids[(int)(e >> 32) + __popc(below)] = i;
        }
        __syncthreads();
        // every row's words in flight at once, coalesced along the row
        constexpr int RPW = 32 / BW;  // rows a warp copies at once
        const int lane = threadIdx.x & 31;
        const int sub = lane / BW, wi = lane & (BW - 1);
        const long long w = w0 + wi;
        const int step = (int)(blockDim.x >> 5) * RPW;
#pragma unroll 8
        for (int r = (int)(threadIdx.x >> 5) * RPW + sub; r < d; r += step) {
            const uint32_t* src = bitmaps + (long long)ids[r] * n_words;
            cp_async4(words + r * BW + wi, w < n_words ? src + w : src,
                      w < n_words ? 4 : 0);
        }
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        __syncthreads();
    }
    const int rot = STAGED ? (int)(threadIdx.x & (NQ - 1)) : 0;
    // acc = (or &=) the tile's words of item `it`'s row, quad s of acc
    // holding the row's quad s ^ rot
    auto row_quads = [&](uint4 (&acc)[NQ], int it, bool first) {
        if (STAGED) {
            const unsigned long long e = slot_words[it >> 5];
            const int sl = (int)(e >> 32) +
                           __popc((unsigned)e & ((1u << (it & 31)) - 1u));
            const uint4* r = tile + sl * NQ;
#pragma unroll
            for (int s = 0; s < NQ; ++s) {
                const uint4 v = r[s ^ rot];
                if (first) acc[s] = v; else and_quads(acc[s], v);
            }
        } else {
            const uint32_t* r = bitmaps + (long long)it * n_words + w0;
            const long long left = n_words - w0;  // words of this tile
#pragma unroll
            for (int s = 0; s < NQ; ++s) {
                const int w = 4 * s;
                const uint4 v = make_uint4(
                    w < left ? __ldg(r + w) : 0u,
                    w + 1 < left ? __ldg(r + w + 1) : 0u,
                    w + 2 < left ? __ldg(r + w + 2) : 0u,
                    w + 3 < left ? __ldg(r + w + 3) : 0u);
                if (first) acc[s] = v; else and_quads(acc[s], v);
            }
        }
    };
    const long long c0 = (long long)blockIdx.y * per_slice;
    const long long c1 = min((long long)c, c0 + per_slice);
    for (long long row = c0 + threadIdx.x; row < c1; row += blockDim.x) {
        // the length loads with the items: a row with lengths <= 0 is
        // counted too, and its count (0, set by the pre-pass) left
        const int len = lengths[row];
        const int* items = cand + row * k;
        uint4 acc[NQ];
        int j = 0, it = -1;
        for (; j < k; ++j)
            if ((it = items[j]) >= 0) break;
        if (j < k) {
            row_quads(acc, it, true);
            for (++j; j < k; ++j)
                if ((it = items[j]) >= 0) row_quads(acc, it, false);
        } else {  // no valid item: every transaction
#pragma unroll
            for (int s = 0; s < NQ; ++s)
                acc[s] = make_uint4(SC_FULL, SC_FULL, SC_FULL, SC_FULL);
        }
        if (last) {  // the tail mask at word W - 1, zeros past W
#pragma unroll
            for (int s = 0; s < NQ; ++s) {
                const int q = s ^ rot;
                if (STAGED) {
                    and_quads(acc[s], tile[d * NQ + q]);
                } else {
                    const long long w = w0 + 4 * q;
                    and_quads(acc[s],
                              make_uint4(mask_word(w, n_words, tail_mask),
                                         mask_word(w + 1, n_words, tail_mask),
                                         mask_word(w + 2, n_words, tail_mask),
                                         mask_word(w + 3, n_words, tail_mask)));
                }
            }
        }
        unsigned total = 0;
#pragma unroll
        for (int s = 0; s < NQ; ++s)
            total += __popc(acc[s].x) + __popc(acc[s].y) + __popc(acc[s].z) +
                     __popc(acc[s].w);
        if (total && len > 0) atomicAdd(counts + row, (int)total);
    }
}

// The pre-pass: `zeroed` holds 2 + ceil(n_items / 32) words of the
// wrapper's scratch (the largest id + 1, D, the bitmask of the named ids),
// cleared here; counts[c] is zeroed.
extern "C" int support_prepass_launch(const int* cand, int c, int k,
                                      int n_items, unsigned* zeroed,
                                      int* counts, void* stream) {
    if (c <= 0) return (int)cudaSuccess;
    cudaStream_t s = (cudaStream_t)stream;
    const int nw = (n_items + 31) / 32;
    cudaError_t err =
        cudaMemsetAsync(zeroed, 0, (size_t)(2 + nw) * sizeof(unsigned), s);
    if (err != cudaSuccess) return (int)err;
    const long long n_entries = (long long)c * k;
    const long long work = n_entries > c ? n_entries : c;
    const long long per_block = (long long)SC_MARK_THREADS * SC_MARK_PER;
    long long blocks = (work + per_block - 1) / per_block;
    if (blocks > SC_MARK_BLOCKS) blocks = SC_MARK_BLOCKS;
    const size_t smem = (size_t)nw * sizeof(unsigned);
    const int smem_bits = nw > 0 && smem <= SC_MARK_SMEM;
    support_mark_kernel<<<(unsigned)blocks, SC_MARK_THREADS,
                          smem_bits ? smem : 0, s>>>(
        cand, n_entries, c, n_items, zeroed, counts, smem_bits);
    return (int)cudaGetLastError();
}

template <int BW, bool STAGED>
static int launch_tiles(dim3 grid, size_t smem, cudaStream_t s,
                        const uint32_t* bitmaps, int n_words, const int* cand,
                        int c, int k, const int* lengths, int n_items,
                        const unsigned* bits, int d, uint32_t tail_mask,
                        int per_slice, int* counts) {
    if (STAGED) {
        // above the default 48 KB, and as much of the SM's memory shared
        // as it offers
        cudaError_t err = cudaFuncSetAttribute(
            support_tile_kernel<BW, STAGED>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(
                support_tile_kernel<BW, STAGED>,
                cudaFuncAttributePreferredSharedMemoryCarveout,
                (int)cudaSharedmemCarveoutMaxShared);
        if (err != cudaSuccess) return (int)err;
    }
    support_tile_kernel<BW, STAGED><<<grid, SC_THREADS, smem, s>>>(
        bitmaps, n_words, cand, c, k, lengths, n_items, bits, d, tail_mask,
        per_slice, counts);
    return (int)cudaGetLastError();
}

// The counts, after support_prepass_launch: `bw` words a tile (4, 8, 16 or
// 32; staged == 0 takes SC_GLOBAL_BW) and `smem` bytes a block, `slices`
// slices of the candidates.
extern "C" int support_count_launch(const uint32_t* bitmaps, int n_words,
                                    const int* cand, int c, int k,
                                    const int* lengths, int n_transactions,
                                    int n_items, const unsigned* bits, int d,
                                    int bw, int staged, int smem, int slices,
                                    int* counts, void* stream) {
    if (c <= 0 || n_words <= 0) return (int)cudaSuccess;
    if (!staged) bw = SC_GLOBAL_BW;
    if (slices < 1 || slices > 65535) return (int)cudaErrorInvalidValue;
    const int tail = n_transactions % 32;
    const uint32_t tail_mask = tail ? ((1u << tail) - 1u) : SC_FULL;
    const int per_slice = (int)(((long long)c + slices - 1) / slices);
    const dim3 grid((unsigned)((n_words + bw - 1) / bw), (unsigned)slices);
    cudaStream_t s = (cudaStream_t)stream;
    const size_t bytes = staged ? (size_t)smem : 0;
#define SC_ARGS grid, bytes, s, bitmaps, n_words, cand, c, k, lengths, \
                n_items, bits, d, tail_mask, per_slice, counts
    if (!staged) return launch_tiles<SC_GLOBAL_BW, false>(SC_ARGS);
    switch (bw) {
        case 4: return launch_tiles<4, true>(SC_ARGS);
        case 8: return launch_tiles<8, true>(SC_ARGS);
        case 16: return launch_tiles<16, true>(SC_ARGS);
        case 32: return launch_tiles<32, true>(SC_ARGS);
    }
#undef SC_ARGS
    return (int)cudaErrorInvalidValue;
}
