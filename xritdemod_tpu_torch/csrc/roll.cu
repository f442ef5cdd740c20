// Per-row cyclic roll of a (C, L) array of 32-bit words:
//   out[c, j] = x[c, (j - amt[c]) mod L].
//
// Replaces the Pallas probe kernel _kernel of tools/roll_probe.py (entry
// barrel), which builds the same result from log2(L) stages of roll-by-2^b
// and select because per-row offsets serialise on that hardware.  Here it is
// a copy at a per-row offset: a block handles ROLL_SPAN consecutive outputs
// of one row, neighbouring threads on neighbouring words, so both the read
// (a contiguous run, split once where it wraps) and the write are coalesced.
// float32, int32 and uint32 are the same kernel on the words' bits.  Bound
// by bytes: the array once in, once out.
#include <cuda_runtime.h>
#include <stdint.h>

#define ROLL_THREADS 256
#define ROLL_PER_THREAD 8
#define ROLL_SPAN (ROLL_THREADS * ROLL_PER_THREAD)

__global__ void roll_kernel(const uint32_t* __restrict__ x, const int* __restrict__ amt,
                            uint32_t* __restrict__ out, int L) {
    const int c = blockIdx.x;
    int a = amt[c] % L;
    if (a < 0) a += L;
    const uint32_t* row = x + (size_t)c * L;
    uint32_t* orow = out + (size_t)c * L;
    const int j0 = blockIdx.y * ROLL_SPAN + threadIdx.x;
#pragma unroll
    for (int k = 0; k < ROLL_PER_THREAD; ++k) {
        const int j = j0 + k * ROLL_THREADS;
        if (j < L) {
            int s = j - a;
            if (s < 0) s += L;
            orow[j] = row[s];
        }
    }
}

extern "C" int xrit_roll(const void* x, const void* amt, void* out, int C, int L,
                         void* stream) {
    if (C < 1 || L < 1) return (int)cudaErrorInvalidValue;
    dim3 grid(C, (L + ROLL_SPAN - 1) / ROLL_SPAN);
    roll_kernel<<<grid, ROLL_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)x, (const int*)amt, (uint32_t*)out, L);
    return (int)cudaGetLastError();
}
