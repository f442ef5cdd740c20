// Per-channel symbol ring between demodulator and decoder: append at the
// fill offset, frame-aligned pop at the sync position.
//
// Replaces the Pallas kernels _append_kernel / _extract_kernel of
// xritdemod_tpu/ops/ring_pallas.py.  There the per-row offsets needed barrel
// rolls; here a block per channel copies at its own offset.  Both kernels
// are bound by bytes: append moves the new symbols once, extract rewrites
// the ring once (out of place, so no thread reads what another has
// overwritten).
#include <cuda_runtime.h>

// ring (C, L) updated in place; new (C, S); fill/n (C,) -> fill_out, ovf.
__global__ void ring_append_kernel(float* __restrict__ ring, const float* __restrict__ nw,
                                   const int* __restrict__ fill, const int* __restrict__ n,
                                   int* __restrict__ fill_out, int* __restrict__ ovf,
                                   int L, int S) {
    int c = blockIdx.x;
    int f = fill[c], k = n[c];
    bool ok = f + k <= L;
    if (ok) {
        float* dst = ring + (size_t)c * L + f;
        const float* src = nw + (size_t)c * S;
        for (int i = blockIdx.y * blockDim.x + threadIdx.x; i < k;
             i += gridDim.y * blockDim.x)
            dst[i] = src[i];
    }
    if (blockIdx.y == 0 && threadIdx.x == 0) {
        fill_out[c] = ok ? f + k : f;      // an overflowing block is dropped
        ovf[c] = ok ? 0 : 1;
    }
}

// ring (C, L) -> ring_out (C, L), out (C, E), fill_out, ok.  A channel with
// fewer than pos+E symbols is copied through untouched and hands back its
// first E slots.
__global__ void ring_extract_kernel(const float* __restrict__ ring,
                                    const int* __restrict__ fill, const int* __restrict__ pos,
                                    float* __restrict__ ring_out, float* __restrict__ out,
                                    int* __restrict__ fill_out, int* __restrict__ okf,
                                    int L, int E) {
    int c = blockIdx.x;
    int f = fill[c], p = pos[c];
    bool ok = f >= p + E;
    int start = ok ? p : 0;                // first slot handed out
    int drop = ok ? p + E : 0;             // slots removed from the front
    int nf = f - drop;
    const float* src = ring + (size_t)c * L;
    float* dst = ring_out + (size_t)c * L;
    float* o = out + (size_t)c * E;
    int stride = gridDim.y * blockDim.x;
    int i0 = blockIdx.y * blockDim.x + threadIdx.x;
    for (int i = i0; i < E; i += stride) o[i] = src[start + i];
    for (int i = i0; i < L; i += stride) dst[i] = i < nf ? src[drop + i] : 0.0f;
    if (blockIdx.y == 0 && threadIdx.x == 0) {
        fill_out[c] = nf;
        okf[c] = ok ? 1 : 0;
    }
}

extern "C" int xrit_ring_append(void* ring, const void* nw, const void* fill,
                                const void* n, void* fill_out, void* ovf,
                                int C, int L, int S, void* stream) {
    dim3 grid(C, 8), block(256);
    ring_append_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (float*)ring, (const float*)nw, (const int*)fill, (const int*)n,
        (int*)fill_out, (int*)ovf, L, S);
    return (int)cudaGetLastError();
}

extern "C" int xrit_ring_extract(const void* ring, const void* fill, const void* pos,
                                 void* ring_out, void* out, void* fill_out, void* ok,
                                 int C, int L, int E, void* stream) {
    dim3 grid(C, 8), block(256);
    ring_extract_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const float*)ring, (const int*)fill, (const int*)pos,
        (float*)ring_out, (float*)out, (int*)fill_out, (int*)ok, L, E);
    return (int)cudaGetLastError();
}
