// Per-channel symbol ring between demodulator and decoder: append at the
// fill offset, frame-aligned pop at the sync position.
//
// Replaces the Pallas kernels _append_kernel / _extract_kernel of
// xritdemod_tpu/ops/ring_pallas.py.  There the per-row offsets needed barrel
// rolls; here a block per channel copies at its own offset.  Both kernels
// are bound by bytes: append moves the new symbols once, extract rewrites
// the ring once (out of place, so no thread reads what another has
// overwritten).
//
// The ring is stored as float32 or, as the Pallas kernels allow, bfloat16
// (the template's Sym): append rounds the float32 symbols to the ring's type
// (to nearest even), extract widens what it pops to float32, as the Pallas
// kernels convert at the edge of fast memory.  A bf16 ring moves half the
// bytes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <class Sym>
__device__ __forceinline__ Sym narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}

// ring (C, L) updated in place; new (C, S); fill/n (C,) -> fill_out, ovf.
template <class Sym>
__global__ void ring_append_kernel(Sym* __restrict__ ring, const float* __restrict__ nw,
                                   const int* __restrict__ fill, const int* __restrict__ n,
                                   int* __restrict__ fill_out, int* __restrict__ ovf,
                                   int L, int S) {
    int c = blockIdx.x;
    int f = fill[c], k = n[c];
    bool ok = f + k <= L;
    if (ok) {
        Sym* dst = ring + (size_t)c * L + f;
        const float* src = nw + (size_t)c * S;
        for (int i = blockIdx.y * blockDim.x + threadIdx.x; i < k;
             i += gridDim.y * blockDim.x)
            dst[i] = narrow<Sym>(src[i]);
    }
    if (blockIdx.y == 0 && threadIdx.x == 0) {
        fill_out[c] = ok ? f + k : f;      // an overflowing block is dropped
        ovf[c] = ok ? 0 : 1;
    }
}

// ring (C, L) -> ring_out (C, L), out (C, E) float32, fill_out, ok.  A
// channel with fewer than pos+E symbols is copied through untouched and
// hands back its first E slots.
template <class Sym>
__global__ void ring_extract_kernel(const Sym* __restrict__ ring,
                                    const int* __restrict__ fill, const int* __restrict__ pos,
                                    Sym* __restrict__ ring_out, float* __restrict__ out,
                                    int* __restrict__ fill_out, int* __restrict__ okf,
                                    int L, int E) {
    int c = blockIdx.x;
    int f = fill[c], p = pos[c];
    bool ok = f >= p + E;
    int start = ok ? p : 0;                // first slot handed out
    int drop = ok ? p + E : 0;             // slots removed from the front
    int nf = f - drop;
    const Sym* src = ring + (size_t)c * L;
    Sym* dst = ring_out + (size_t)c * L;
    float* o = out + (size_t)c * E;
    int stride = gridDim.y * blockDim.x;
    int i0 = blockIdx.y * blockDim.x + threadIdx.x;
    for (int i = i0; i < E; i += stride) o[i] = widen(src[start + i]);
    for (int i = i0; i < L; i += stride) dst[i] = i < nf ? src[drop + i] : narrow<Sym>(0.0f);
    if (blockIdx.y == 0 && threadIdx.x == 0) {
        fill_out[c] = nf;
        okf[c] = ok ? 1 : 0;
    }
}

template <class Sym>
static int append(void* ring, const void* nw, const void* fill, const void* n, void* fill_out,
                  void* ovf, int C, int L, int S, void* stream) {
    dim3 grid(C, 8), block(256);
    ring_append_kernel<Sym><<<grid, block, 0, (cudaStream_t)stream>>>(
        (Sym*)ring, (const float*)nw, (const int*)fill, (const int*)n,
        (int*)fill_out, (int*)ovf, L, S);
    return (int)cudaGetLastError();
}

template <class Sym>
static int extract(const void* ring, const void* fill, const void* pos, void* ring_out,
                   void* out, void* fill_out, void* ok, int C, int L, int E, void* stream) {
    dim3 grid(C, 8), block(256);
    ring_extract_kernel<Sym><<<grid, block, 0, (cudaStream_t)stream>>>(
        (const Sym*)ring, (const int*)fill, (const int*)pos,
        (Sym*)ring_out, (float*)out, (int*)fill_out, (int*)ok, L, E);
    return (int)cudaGetLastError();
}

extern "C" int xrit_ring_append(void* ring, const void* nw, const void* fill,
                                const void* n, void* fill_out, void* ovf,
                                int C, int L, int S, void* stream) {
    return append<float>(ring, nw, fill, n, fill_out, ovf, C, L, S, stream);
}

extern "C" int xrit_ring_extract(const void* ring, const void* fill, const void* pos,
                                 void* ring_out, void* out, void* fill_out, void* ok,
                                 int C, int L, int E, void* stream) {
    return extract<float>(ring, fill, pos, ring_out, out, fill_out, ok, C, L, E, stream);
}

// The same on a bfloat16 ring.
extern "C" int xrit_ring_append_bf16(void* ring, const void* nw, const void* fill,
                                     const void* n, void* fill_out, void* ovf,
                                     int C, int L, int S, void* stream) {
    return append<__nv_bfloat16>(ring, nw, fill, n, fill_out, ovf, C, L, S, stream);
}

extern "C" int xrit_ring_extract_bf16(const void* ring, const void* fill, const void* pos,
                                      void* ring_out, void* out, void* fill_out, void* ok,
                                      int C, int L, int E, void* stream) {
    return extract<__nv_bfloat16>(ring, fill, pos, ring_out, out, fill_out, ok, C, L, E,
                                  stream);
}
