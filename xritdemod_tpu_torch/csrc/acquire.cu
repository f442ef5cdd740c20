// Frame-sync acquisition of the fused receive: each channel's extraction
// position, decided on the device.
//
// Replaces no Pallas kernel.  The JAX package decides it inside its jitted
// step, xritdemod_tpu/models/receiver.py:164-191: `lax.cond(any(~locked))`
// over `do_acq` (a convolution of the hard signs with the +-1 word
// templates, `best_correlation`'s argmax), then the threshold and the lock
// select.  Its port ran that correlation as plain PyTorch and read the lock
// flags back to the host to skip it.  Here one launch gives every channel's
// position and nothing is read back:
//
//   - a locked channel reads its flag, writes 0 and touches nothing else
//     (so a steady step's launch reads C bytes and writes 4C);
//   - an unlocked one takes the hard signs of its ring's first P + 63
//     symbols (soft < 0 is bit 1; -0.0 and NaN are bit 0, as `soft < 0` is
//     false for them), 32 a ballot, into shared memory; at each lag p the
//     64-bit window starting there is two funnel shifts of three words, and
//     the matches with word w are 64 - popcount(window ^ word);
//   - the first maximum (the lowest word, then the lowest lag) is the
//     largest key (count << 24 | 0xFFFFFF - (w P + p)), one warp max; the
//     position is its lag where the count reaches the threshold, else 0.
//
// One warp a channel (`__launch_bounds__(32)`: no hand-off between warps).
// Counts are integers, so the result equals the plain version
// (ops/correlator.py::acquire_positions_plain) bit for bit.  Bound on an
// H100: the unlocked channels' window bytes (64 KiB a float32 channel), and
// at steady state the flags alone; the ballots' load latency (16 loads in
// flight a lane) and 2 x P popcounts a channel set its time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define ACQ_MAX_WORDS 4
#define ACQ_INFLIGHT 16
#define ACQ_FULL 0xffffffffu

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// ring (C, L) Sym; locked (C,) bool; templates (W, 64) f32 +-1; pos (C,) i32.
template <class Sym>
__global__ void __launch_bounds__(32)
acquire_kernel(const Sym* __restrict__ ring, const bool* __restrict__ locked,
               const float* __restrict__ templates, int* __restrict__ pos,
               int L, int P, int W, int thresh) {
    extern __shared__ uint32_t bits[];          // (P + 63 + 31) / 32 + 2 words
    const int c = blockIdx.x;
    const int lane = threadIdx.x;
    if (locked[c]) {
        if (lane == 0) pos[c] = 0;
        return;
    }
    const int N = P + 63;
    const int nw = (N + 31) >> 5;
    const Sym* row = ring + (size_t)c * L;
    for (int q0 = 0; q0 < nw; q0 += ACQ_INFLIGHT) {
        float v[ACQ_INFLIGHT];
#pragma unroll
        for (int i = 0; i < ACQ_INFLIGHT; ++i) {
            const int j = ((q0 + i) << 5) + lane;
            v[i] = (q0 + i < nw && j < N) ? widen(row[j]) : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < ACQ_INFLIGHT; ++i) {
            const uint32_t w = __ballot_sync(ACQ_FULL, v[i] < 0.0f);
            if (lane == 0 && q0 + i < nw) bits[q0 + i] = w;
        }
    }
    if (lane < 2) bits[nw + lane] = 0;

    // Word w's bit i: the sign template w expects at offset i (-1: bit 1).
    uint32_t mlo[ACQ_MAX_WORDS], mhi[ACQ_MAX_WORDS];
#pragma unroll
    for (int w = 0; w < ACQ_MAX_WORDS; ++w) {
        const bool on = w < W;
        mlo[w] = __ballot_sync(ACQ_FULL, on && templates[w * 64 + lane] < 0.0f);
        mhi[w] = __ballot_sync(ACQ_FULL, on && templates[w * 64 + 32 + lane] < 0.0f);
    }
    __syncwarp();

    // Lane r takes the lags 32 t + r: the three words are the same for the
    // whole warp (broadcast reads).
    uint32_t best = 0;
    const int groups = (P + 31) >> 5;
    for (int t = 0; t < groups; ++t) {
        const uint32_t a = bits[t], b = bits[t + 1], d = bits[t + 2];
        const uint32_t hlo = __funnelshift_r(a, b, lane);
        const uint32_t hhi = __funnelshift_r(b, d, lane);
        const int p = (t << 5) + lane;
        if (p < P) {
#pragma unroll
            for (int w = 0; w < ACQ_MAX_WORDS; ++w) {
                if (w < W) {
                    const uint32_t n = 64 - __popc(hlo ^ mlo[w]) - __popc(hhi ^ mhi[w]);
                    const uint32_t key = (n << 24) | (0xFFFFFFu - (uint32_t)(w * P + p));
                    best = key > best ? key : best;
                }
            }
        }
    }
    best = __reduce_max_sync(ACQ_FULL, best);
    if (lane == 0) {
        const int n = (int)(best >> 24);
        const int idx = (int)(0xFFFFFFu - (best & 0xFFFFFFu));
        pos[c] = n >= thresh ? idx % P : 0;
    }
}

template <class Sym>
static int launch(const void* ring, const void* locked, const void* templates, void* pos,
                  int C, int L, int P, int W, int thresh, cudaStream_t st) {
    if (C < 1 || P < 1 || W < 1 || W > ACQ_MAX_WORDS || P + 63 > L
        || (long long)W * P >= (1LL << 24))
        return (int)cudaErrorInvalidValue;
    const int words = (P + 63 + 31) / 32 + 2;
    acquire_kernel<Sym><<<C, 32, words * 4, st>>>(
        (const Sym*)ring, (const bool*)locked, (const float*)templates, (int*)pos,
        L, P, W, thresh);
    return (int)cudaGetLastError();
}

extern "C" int xrit_acquire(const void* ring, const void* locked, const void* templates,
                            void* pos, int C, int L, int P, int W, int thresh, void* stream) {
    return launch<float>(ring, locked, templates, pos, C, L, P, W, thresh,
                         (cudaStream_t)stream);
}

extern "C" int xrit_acquire_bf16(const void* ring, const void* locked, const void* templates,
                                 void* pos, int C, int L, int P, int W, int thresh,
                                 void* stream) {
    return launch<__nv_bfloat16>(ring, locked, templates, pos, C, L, P, W, thresh,
                                 (cudaStream_t)stream);
}
