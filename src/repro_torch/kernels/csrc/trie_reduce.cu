// Full-ruleset traversal reduction: (n_rules, sum support, max confidence,
// sum confidence, mean confidence) over the nodes at depth > 0.
//
// Replaces the TPU kernel repro/kernels/trie_reduce.py::trie_reduce_pallas,
// which tiles the three node columns through VMEM and carries the four
// running values from one grid step to the next in its output block.  On
// this card the blocks run in parallel, so nothing carries over between
// them: each block reduces its share and the last block to finish folds
// the blocks' partials, inside the same launch.
//
// What bounds it: device memory.  It reads each node's support,
// confidence and depth once (12 bytes a node at f32, 8.5 at int32 + int8)
// and does three adds, a compare and a max per node.  At 2^20 nodes the
// bytes take 3.8 us at 3.35 TB/s, about what two launches' fixed cost
// takes, so the design is one launch that streams:
//   1. A persistent grid: trie_reduce.py's BLOCKS_PER_SM blocks an SM
//      (fewer when the columns hold fewer tiles), each walking tiles of
//      TR_THREADS x TR_TILE_NODES nodes, tile b, b + grid, ...  A vector
//      is 16 bytes of the confidence column (4 f32, 8 bf16 or 16 int8
//      nodes) and the same nodes of the other two columns, each read with
//      16-byte ld.global.nc loads (an int32 depth at 16 nodes is 4
//      loads).  A thread takes TR_TILE_NODES / V vectors of a tile (4 at
//      f32, 2 at bf16, 1 at int8: 12-16 loads of 16 bytes) and issues all
//      their loads before it widens any.
//   2. The wrapper passes `head`, the first node at which all three
//      columns are 16-byte aligned (a column may be a view at a storage
//      offset); the nodes before it and the ragged tail after the last
//      whole vector are read with scalar loads.  Columns whose offsets
//      allow no common head take the ALIGNED = false variant: the same
//      nodes to the same threads in the same order, read element by
//      element.
//   3. Exact count and max: the count is an int a thread, converted to f32
//      once at the end (equal to the reference's f32 count of an int
//      sum).  The max is IEEE 754's maximum, as jnp.max takes it: NaN
//      propagates and +0.0 is above -0.0 (fmaxf would drop a NaN).  A
//      thread keeps it as an int key in the values' total order, a NaN
//      of either sign above +inf, so that one integer max a node (not a
//      compare and branches on floats) keeps it exact in any order.
//   4. Sums in a fixed order, so that they repeat bitwise: a thread adds
//      its nodes in index order, a warp reduces with __shfl_xor_sync at
//      offsets 16, 8, 4, 2, 1, thread 0 folds the warps in warp order, and
//      the block writes its partial.  Then an acq_rel atomic ticket (the
//      release publishes the partial; no separate fences): the last block
//      to arrive folds every partial in block order (thread t takes
//      blocks t, t + TR_THREADS, ... in turn, then the same warp and
//      warp-order folds), whatever the arrival order, writes the five
//      outputs and sets the ticket back to 0 for the next launch.  A grid
//      of one block (a few tiles, where the ticket's round trips would
//      cost more than the block's own walk) writes its fold directly: the
//      same bits, since the fold of one partial adds only identities.
//      ref.trie_reduce_split_ref is this order in plain PyTorch.
//   5. The mean conf_sum / max(n, 1) with the IEEE divide, as
//      ops.trie_reduce computed it from the four outputs.
// The quantized columns (int32 support counts, bf16, int8) widen in
// registers with metrics.cuh's dequantize.
#include <cuda_runtime.h>
#include <stdint.h>

#include "metrics.cuh"

#define TR_THREADS 256                  // ref.py / trie_reduce.py THREADS
#define TR_TILE_NODES 16                // nodes a thread loads per tile
#define TR_WARPS (TR_THREADS / 32)
#define TR_FULL 0xffffffffu

// A block's partial, and a thread's running values: the max as its key.
struct __align__(16) TrPartial {
    int count;
    float sup;
    int kmax;
    float csum;
};

// The max's key: an int in IEEE 754's total order of the f32 values
// (-0.0 below +0.0) with a NaN of either sign above +inf, so that an int
// max is the IEEE maximum: a NaN propagates (the largest payload of |NaN|
// wins), +0.0 beats -0.0.  Exact, and free of any order.
__device__ __forceinline__ int max_key(float c) {
    const int b = __float_as_int(c != c ? fabsf(c) : c);
    return b ^ ((b >> 31) & 0x7fffffff);
}
__device__ __forceinline__ float from_key(int k) {
    return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}
#define TR_KEY_NONE (-0x7fffffff - 1)  // below every key: no live node

__device__ __forceinline__ void fold(TrPartial& a, const TrPartial& b) {
    a.count += b.count;
    a.sup = __fadd_rn(a.sup, b.sup);
    a.kmax = max(a.kmax, b.kmax);
    a.csum = __fadd_rn(a.csum, b.csum);
}

__device__ __forceinline__ TrPartial empty_partial() {
    TrPartial p;
    p.count = 0;
    p.sup = 0.0f;
    p.kmax = TR_KEY_NONE;
    p.csum = 0.0f;
    return p;
}

// One node, already widened.  A node that is not live adds +0.0 and no
// key, which leaves the running values as they are.
__device__ __forceinline__ void add_node(TrPartial& a, int d, float s,
                                         float c) {
    const bool live = d > 0;
    a.count += live ? 1 : 0;
    a.sup = __fadd_rn(a.sup, live ? s : 0.0f);
    a.kmax = max(a.kmax, live ? max_key(c) : TR_KEY_NONE);
    a.csum = __fadd_rn(a.csum, live ? c : 0.0f);
}

template <class S, class C>
__device__ __forceinline__ void add_scalar(TrPartial& a, const S* sup,
                                           const C* conf, const int* depth,
                                           int i, float inv_n,
                                           float conf_scale) {
    add_node(a, __ldg(depth + i), dequantize(__ldg(sup + i), inv_n),
             dequantize(__ldg(conf + i), conf_scale));
}

// ---------------------------------------------------------------------
// 16-byte streaming loads and the elements in them.
__device__ __forceinline__ uint4 ld_stream(const void* p) {
    uint4 r;
    asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
        : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
        : "l"(p));
    return r;
}

__device__ __forceinline__ uint32_t word(const uint4* w, int j) {
    const uint4 q = w[j >> 2];
    switch (j & 3) {
        case 0: return q.x;
        case 1: return q.y;
        case 2: return q.z;
        default: return q.w;
    }
}

// element i of the little-endian words w, as the column's storage type
template <class T>
__device__ __forceinline__ T element(const uint4* w, int i);
template <>
__device__ __forceinline__ float element<float>(const uint4* w, int i) {
    return __uint_as_float(word(w, i));
}
template <>
__device__ __forceinline__ int element<int>(const uint4* w, int i) {
    return (int)word(w, i);
}
template <>
__device__ __forceinline__ rt_bf16 element<rt_bf16>(const uint4* w, int i) {
    return (rt_bf16)(word(w, i >> 1) >> (16 * (i & 1)));
}
template <>
__device__ __forceinline__ signed char element<signed char>(const uint4* w,
                                                            int i) {
    return (signed char)(word(w, i >> 2) >> (8 * (i & 3)));
}

// A vector's nodes in all three columns: V nodes, one 16-byte load of
// confidence, V / 4 of depth and V * sizeof(S) / 16 of support.
template <class S, class C>
struct TrVector {
    static constexpr int V = 16 / sizeof(C);
    static constexpr int NS = V * sizeof(S) / 16;
    static constexpr int ND = V / 4;
    uint4 s[NS];
    uint4 c[1];
    uint4 d[ND];
};

template <class S, class C, bool ALIGNED>
__device__ __forceinline__ void load_vector(TrVector<S, C>& x, const S* sup,
                                            const C* conf, const int* depth,
                                            int first) {
    constexpr int V = TrVector<S, C>::V;
    if (ALIGNED) {
#pragma unroll
        for (int k = 0; k < TrVector<S, C>::ND; ++k)
            x.d[k] = ld_stream(depth + first + 4 * k);
#pragma unroll
        for (int k = 0; k < TrVector<S, C>::NS; ++k)
            x.s[k] = ld_stream(sup + first + k * (16 / (int)sizeof(S)));
        x.c[0] = ld_stream(conf + first);
    } else {
        // the same nodes element by element, packed as the vector loads
        // pack them
        uint32_t dw[V], sw[V], cw[V];
#pragma unroll
        for (int e = 0; e < V; ++e) {
            dw[e] = (uint32_t)__ldg(depth + first + e);
            S sv = __ldg(sup + first + e);
            C cv = __ldg(conf + first + e);
            uint32_t su = 0, cu = 0;
            memcpy(&su, &sv, sizeof(S));
            memcpy(&cu, &cv, sizeof(C));
            sw[e] = su;
            cw[e] = cu;
        }
#pragma unroll
        for (int k = 0; k < TrVector<S, C>::ND; ++k)
            x.d[k] = make_uint4(dw[4 * k], dw[4 * k + 1], dw[4 * k + 2],
                                dw[4 * k + 3]);
        uint32_t sp[4 * TrVector<S, C>::NS], cp[4];
#pragma unroll
        for (int j = 0; j < 4 * TrVector<S, C>::NS; ++j) sp[j] = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) cp[j] = 0;
#pragma unroll
        for (int e = 0; e < V; ++e) {
            const int sb = e * (int)sizeof(S), cb = e * (int)sizeof(C);
            sp[sb / 4] |= sw[e] << (8 * (sb % 4));
            cp[cb / 4] |= cw[e] << (8 * (cb % 4));
        }
#pragma unroll
        for (int k = 0; k < TrVector<S, C>::NS; ++k)
            x.s[k] = make_uint4(sp[4 * k], sp[4 * k + 1], sp[4 * k + 2],
                                sp[4 * k + 3]);
        x.c[0] = make_uint4(cp[0], cp[1], cp[2], cp[3]);
    }
}

template <class S, class C>
__device__ __forceinline__ void add_vector(TrPartial& a,
                                           const TrVector<S, C>& x,
                                           float inv_n, float conf_scale) {
#pragma unroll
    for (int e = 0; e < TrVector<S, C>::V; ++e)
        add_node(a, element<int>(x.d, e),
                 dequantize(element<S>(x.s, e), inv_n),
                 dequantize(element<C>(x.c, e), conf_scale));
}

// ---------------------------------------------------------------------
// The block's fold: the xor butterfly in each warp (every lane ends with
// the same sums; lane 0's values are kept), then thread 0 folds the warps
// in warp order.  The result is valid in thread 0.
__device__ __forceinline__ TrPartial block_fold(TrPartial a,
                                                TrPartial* wpart) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        TrPartial b;
        b.count = __shfl_xor_sync(TR_FULL, a.count, o);
        b.sup = __shfl_xor_sync(TR_FULL, a.sup, o);
        b.kmax = __shfl_xor_sync(TR_FULL, a.kmax, o);
        b.csum = __shfl_xor_sync(TR_FULL, a.csum, o);
        fold(a, b);
    }
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) wpart[warp] = a;
    __syncthreads();
    TrPartial p = empty_partial();
    if (threadIdx.x == 0) {
#pragma unroll
        for (int w = 0; w < TR_WARPS; ++w) fold(p, wpart[w]);
    }
    return p;
}

__device__ __forceinline__ void write_out(const TrPartial& p, float* out) {
    const float cnt = __int2float_rn(p.count);
    out[0] = cnt;
    out[1] = p.sup;
    out[2] = p.count > 0 ? from_key(p.kmax) : 0.0f;
    out[3] = p.csum;
    out[4] = __fdiv_rn(p.csum, fmaxf(cnt, 1.0f));
}

template <class S, class C, bool ALIGNED>
__global__ void __launch_bounds__(TR_THREADS)
    trie_reduce_kernel(const S* __restrict__ sup, const C* __restrict__ conf,
                       const int* __restrict__ depth, int n, int head,
                       float inv_n, float conf_scale,
                       TrPartial* __restrict__ partials,
                       unsigned* __restrict__ ticket, float* __restrict__ out) {
    constexpr int V = TrVector<S, C>::V;
    constexpr int UNROLL = TR_TILE_NODES / V;  // vectors a thread, a tile
    constexpr int TILE = TR_THREADS * UNROLL;
    __shared__ TrPartial wpart[TR_WARPS];
    __shared__ int last;
    // n < 2^31, so every node and vector index fits an int
    const int nv = (n - head) / V;
    const int gtid = blockIdx.x * TR_THREADS + threadIdx.x;
    TrPartial a = empty_partial();
    // the head (node j on global thread j), before the thread's vectors
    if (gtid < head)
        add_scalar(a, sup, conf, depth, gtid, inv_n, conf_scale);
    const int tiles = (nv + TILE - 1) / TILE;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        TrVector<S, C> x[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const int v = t * TILE + u * TR_THREADS + threadIdx.x;
            if (v < nv)
                load_vector<S, C, ALIGNED>(x[u], sup, conf, depth,
                                           head + v * V);
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const int v = t * TILE + u * TR_THREADS + threadIdx.x;
            if (v < nv) add_vector(a, x[u], inv_n, conf_scale);
        }
    }
    // the tail (node tail0 + j on global thread j), after them
    const int tail0 = head + nv * V;
    if (gtid < n - tail0)
        add_scalar(a, sup, conf, depth, tail0 + gtid, inv_n, conf_scale);

    TrPartial p = block_fold(a, wpart);
    if (gridDim.x == 1) {
        // one block: its fold is the whole (the fold of one partial below
        // adds only identities, so the bits are the same)
        if (threadIdx.x == 0) write_out(p, out);
        return;
    }
    if (threadIdx.x == 0) {
        partials[blockIdx.x] = p;
        // release: the partial before the ticket that publishes it;
        // acquire: every other block's partial, in the last block
        unsigned prev;
        asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
                     : "=r"(prev)
                     : "l"(ticket)
                     : "memory");
        last = prev == gridDim.x - 1;
    }
    __syncthreads();
    if (!last) return;
    // the last block: every partial in block order, read from L2
    TrPartial b = empty_partial();
    for (int i = threadIdx.x; i < (int)gridDim.x; i += TR_THREADS) {
        const int4 q = __ldcg(reinterpret_cast<const int4*>(partials + i));
        TrPartial r;
        r.count = q.x;
        r.sup = __int_as_float(q.y);
        r.kmax = q.z;
        r.csum = __int_as_float(q.w);
        fold(b, r);
    }
    p = block_fold(b, wpart);
    if (threadIdx.x == 0) {
        write_out(p, out);
        *ticket = 0u;  // every block has arrived: ready for the next launch
    }
}

template <class S, class C>
static int launch_typed(const void* sup, const void* conf, const int* depth,
                        int n, int head, int aligned, float inv_n,
                        float conf_scale, int blocks, TrPartial* partials,
                        unsigned* ticket, float* out, cudaStream_t s) {
    const S* sp = static_cast<const S*>(sup);
    const C* cp = static_cast<const C*>(conf);
    if (aligned)
        trie_reduce_kernel<S, C, true><<<(unsigned)blocks, TR_THREADS, 0, s>>>(
            sp, cp, depth, n, head, inv_n, conf_scale, partials, ticket, out);
    else
        trie_reduce_kernel<S, C, false><<<(unsigned)blocks, TR_THREADS, 0,
                                          s>>>(
            sp, cp, depth, n, 0, inv_n, conf_scale, partials, ticket, out);
    return (int)cudaGetLastError();
}

// support / confidence (lift unused: the wrappers' column convention),
// their storage codes, 1 / n_transactions and the confidence int8 scale;
// `n` nodes from `head` (the first node at which the three columns are
// 16-byte aligned; `aligned` 0 when there is none), `blocks` blocks,
// `scratch` holding the ticket (16 bytes; zero between launches) then
// `blocks` partials of 16 bytes, and the five f32 outputs.
extern "C" int trie_reduce_launch(const void* sup, const void* conf,
                                  const void* /*lift*/, int sup_type,
                                  int col_type, float inv_n, float conf_scale,
                                  float /*lift_scale*/, const void* depth,
                                  int n, int head, int aligned, int blocks,
                                  void* scratch, void* out, void* stream) {
    if (n <= 0 || blocks < 1 || head < 0 || head > n)
        return (int)cudaErrorInvalidValue;
    unsigned* ticket = static_cast<unsigned*>(scratch);
    TrPartial* partials = static_cast<TrPartial*>(scratch) + 1;
    const int* dp = static_cast<const int*>(depth);
    float* o = static_cast<float*>(out);
    cudaStream_t s = (cudaStream_t)stream;
    RT_DISPATCH_COLUMNS(sup_type, col_type, launch_typed, sup, conf, dp, n,
                        head, aligned, inv_n, conf_scale, blocks, partials,
                        ticket, o, s)
}
