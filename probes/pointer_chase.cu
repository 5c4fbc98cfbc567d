// Dependent-load latency probe (chip_smoke.py builds and launches it; the
// port's kernels never call it).
//
// One thread follows a chain of int32 indices: each load's address is the
// value the load before it read, so the loads run one at a time and the
// chain's time over its length is the latency of one.  __ldcg keeps the
// loads out of L1: a chain over lines the L2 does not hold (after a flush)
// reads device memory, one over a few MB read once before reads the L2.
#include <cuda_runtime.h>

__global__ void pointer_chase_kernel(const int* __restrict__ next, int start,
                                     int steps, int* __restrict__ out) {
    int i = start;
    for (int s = 0; s < steps; ++s) i = __ldcg(next + i);
    *out = i;
}

extern "C" int pointer_chase_launch(const int* next, int start, int steps,
                                    int* out, void* stream) {
    pointer_chase_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(next, start,
                                                            steps, out);
    return (int)cudaGetLastError();
}
