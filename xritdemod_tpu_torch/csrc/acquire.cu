// Frame-sync acquisition of the fused receive: each channel's extraction
// position, decided on the device.
//
// Replaces no Pallas kernel.  The JAX package decides it inside its jitted
// step, xritdemod_tpu/models/receiver.py:164-191: `lax.cond(any(~locked))`
// over `do_acq` (a convolution of the hard signs with the +-1 word
// templates, `best_correlation`'s argmax), then the threshold and the lock
// select.  Its port ran that correlation as plain PyTorch and read the lock
// flags back to the host to skip it.  Here one launch gives every channel's
// position and nothing is read back.
//
// A block of 16 warps takes 8 channels (a float32 ring; bf16: 8 warps, 2
// channels):
//   - warp 0 reads their lock flags and writes 0 for the locked ones; a
//     block whose channels are all locked ends there (the steady step's
//     launch reads C bytes and writes 4C);
//   - each unlocked channel in turn is shared by the block's warps: they
//     take the hard signs of its ring's first P + 63 symbols (soft < 0 is
//     bit 1; -0.0 and NaN are bit 0, as `soft < 0` is false for them) with
//     16-byte loads, 4 float32 or 8 bf16 symbols a lane, the whole window
//     in flight at once, each lane's nibble or byte gathered into 32-bit
//     words by shuffles, into shared memory (about 2 KiB, two buffers): the
//     next unlocked channel's loads are in flight while this one's lags are
//     counted;
//   - the P lags are split between the warps; at lag p the 64-bit window
//     starting there is two funnel shifts of three words (kept in registers
//     as the lags advance), and the mismatches with word w are
//     popcount(window ^ word); where word 1 is the complement of word 0
//     (LRIT's two words) it takes 64 minus word 0's, with no popcount (an
//     instance of its own: a select would count both);
//   - the first maximum of the matches (the lowest word, then the lowest
//     lag) is the smallest key (mismatches << 24 | w P + p), one warp min,
//     then one over the warps; the position is its lag where the matches
//     reach the threshold, else 0.
// The words' sign masks are kernel arguments, packed once by the wrapper's
// caller (ops/acquire_cuda.py::pack_masks).  Counts are integers, so the
// result equals the plain version (ops/correlator.py::acquire_positions_plain)
// bit for bit.  Bound on an H100: the unlocked channels' window bytes (64 KiB
// a float32 channel, 32 KiB a bf16 one), and at steady state the flags
// alone; beside them, two popcounts and about ten integer operations a lag
// and word (LRIT's second word: three), which outweigh a bf16 window's
// bytes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define ACQ_MAX_WORDS 4
// Warps and channels a block, by symbol type: a float32 window takes 16
// warps to have all of its 64 KiB in flight at once, a bf16 one 8, and two
// channels a block (more blocks an SM, more windows in flight; a steady
// launch's blocks end at once whatever their number).
#define ACQ_F32_WARPS 16
#define ACQ_F32_CPB 8
#define ACQ_BF16_WARPS 8
#define ACQ_BF16_CPB 2
// 16-byte loads in flight a thread: a 16447-symbol window is 514 words of
// signs, 4112 float32 vectors (2056 bf16), one batch of 512 (256) threads' 9.
#define ACQ_INFLIGHT 9
#define ACQ_FULL 0xffffffffu

template <class Sym> struct Shape;
template <> struct Shape<float> {
    static constexpr int warps = ACQ_F32_WARPS, threads = 32 * warps, cpb = ACQ_F32_CPB;
};
template <> struct Shape<__nv_bfloat16> {
    static constexpr int warps = ACQ_BF16_WARPS, threads = 32 * warps, cpb = ACQ_BF16_CPB;
};

struct Masks {
    uint32_t lo[ACQ_MAX_WORDS], hi[ACQ_MAX_WORDS];   // bit i: word w expects soft < 0 at i
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// The sign bits of a 16-byte vector, element i at bit i.
__device__ __forceinline__ uint32_t signs(uint4 v, float) {
    return (__uint_as_float(v.x) < 0.0f) | (__uint_as_float(v.y) < 0.0f) << 1
           | (__uint_as_float(v.z) < 0.0f) << 2 | (__uint_as_float(v.w) < 0.0f) << 3;
}
// A bf16 is the high half of the float32 it widens to: compared as that
// float (on the float pipe; -0.0 and NaNs are not below 0).
__device__ __forceinline__ uint32_t signs(uint4 v, __nv_bfloat16) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    uint32_t s = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
        s |= (uint32_t)(__uint_as_float(w[i] << 16) < 0.0f) << (2 * i)
             | (uint32_t)(__uint_as_float(w[i] & 0xFFFF0000u) < 0.0f) << (2 * i + 1);
    return s;
}

// The lags of groups [t0, t1), lane r at 32 t + r, into `best`: the
// smallest key mismatches << 24 | (w P + p) is the first best match (the
// lowest word, then the lowest lag).  The window at lag p is the funnel
// shifts lo = (a, b) and hi = (b, d) of three words; the next lag's lo is
// this one's hi, so one shift a lag.  W words; COMP: W = 2 and word 1 is the
// complement of word 0, so its mismatches are 64 minus word 0's.  CHECK:
// some lags of the groups reach P (they take no key).
template <int W, bool COMP, bool CHECK>
__device__ __forceinline__ uint32_t lag_groups(const uint32_t* bits, int t0, int t1, int lane,
                                               const Masks& mk, int P, uint32_t best) {
    if (t0 >= t1) return best;
    uint32_t b = bits[t0 + 1];
    uint32_t hlo = __funnelshift_r(bits[t0], b, lane);
    uint32_t p = ((uint32_t)t0 << 5) + lane;
#pragma unroll 4
    for (int t = t0; t < t1; ++t) {
        const uint32_t d = bits[t + 2];
        const uint32_t hhi = __funnelshift_r(b, d, lane);
        const bool ok = !CHECK || p < (uint32_t)P;
        const uint32_t m0 = __popc(hlo ^ mk.lo[0]) + __popc(hhi ^ mk.hi[0]);
        best = min(best, ok ? (m0 << 24) + p : 0xFFFFFFFFu);
        if (COMP) {
            best = min(best, ok ? ((64 - m0) << 24) + (uint32_t)P + p : 0xFFFFFFFFu);
        } else {
#pragma unroll
            for (int w = 1; w < W; ++w) {
                const uint32_t m = __popc(hlo ^ mk.lo[w]) + __popc(hhi ^ mk.hi[w]);
                best = min(best, ok ? (m << 24) + (uint32_t)(w * P) + p : 0xFFFFFFFFu);
            }
        }
        p += 32;
        hlo = hhi;
        b = d;
    }
    return best;
}

// This warp's lags, groups [g0, g1), for W words.
template <int W, bool COMP>
__device__ __forceinline__ uint32_t count_lags(const uint32_t* bits, int g0, int g1, int lane,
                                               const Masks& mk, int P) {
    const int whole = P >> 5;                   // groups whose 32 lags are all below P
    const uint32_t best = lag_groups<W, COMP, false>(bits, g0, min(g1, whole), lane, mk, P,
                                                     0xFFFFFFFFu);
    return lag_groups<W, COMP, true>(bits, max(g0, whole), g1, lane, mk, P, best);
}

// A channel's 16-byte vectors [v0, v0 + threads ACQ_INFLIGHT), a thread's
// ACQ_INFLIGHT, as loads in flight.
template <class Sym>
__device__ __forceinline__ void load_batch(uint4 (&x)[ACQ_INFLIGHT], const Sym* row, int v0,
                                           int nvec, int tid) {
#pragma unroll
    for (int i = 0; i < ACQ_INFLIGHT; ++i) {
        const int v = v0 + i * Shape<Sym>::threads + tid;
        x[i] = v < nvec ? reinterpret_cast<const uint4*>(row)[v] : make_uint4(0, 0, 0, 0);
    }
}

// Their signs into `bits`: each lane's nibble (float32) or byte (bf16), bits
// past N cleared, gathered into 32-bit words by shuffles.
template <class Sym>
__device__ __forceinline__ void pack_batch(const uint4 (&x)[ACQ_INFLIGHT], uint32_t* bits,
                                           int v0, int nvec, int N, int tid, int lane) {
    constexpr int VEC = 16 / sizeof(Sym);       // symbols a 16-byte load
    constexpr int LPW = 32 / VEC;               // lanes a 32-bit word of signs
#pragma unroll
    for (int i = 0; i < ACQ_INFLIGHT; ++i) {
        const int v = v0 + i * Shape<Sym>::threads + tid;
        const int past = v * VEC + VEC - N;     // symbols of this vector at or past N
        uint32_t s = signs(x[i], Sym());
        if (past > 0) s &= past >= VEC ? 0u : (1u << (VEC - past)) - 1u;
        s <<= VEC * (lane % LPW);
#pragma unroll
        for (int o = 1; o < LPW; o <<= 1) s |= __shfl_xor_sync(ACQ_FULL, s, o);
        if (lane % LPW == 0 && v < nvec) bits[v / LPW] = s;
    }
}

// ring (C, L) Sym; locked (C,) bool; pos (C,) i32.  `vec`: the ring's rows
// start on 16-byte boundaries.
template <class Sym>
__global__ void __launch_bounds__(Shape<Sym>::threads, 1024 / Shape<Sym>::threads)
acquire_kernel(const Sym* __restrict__ ring, const bool* __restrict__ locked,
               int* __restrict__ pos, Masks mk, int C, int L, int P, int W, int thresh,
               int vec) {
    extern __shared__ uint32_t bits[];          // two buffers of (P + 63 + 31) / 32 + 2 words
    constexpr int WARPS = Shape<Sym>::warps, THREADS = Shape<Sym>::threads, CPB = Shape<Sym>::cpb;
    __shared__ uint32_t best_w[2][WARPS];
    __shared__ unsigned todo;
    constexpr int VEC = 16 / sizeof(Sym);
    constexpr int LPW = 32 / VEC;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int c0 = blockIdx.x * CPB;
    if (warp == 0) {
        const int c = c0 + lane;
        const bool mine = lane < CPB && c < C;
        const bool open = mine && !locked[c];
        if (mine && !open) pos[c] = 0;
        const unsigned m = __ballot_sync(ACQ_FULL, open);
        if (lane == 0) todo = m;
    }
    __syncthreads();
    unsigned todo_m = todo;
    if (todo_m == 0) return;

    const int N = P + 63;
    const int nw = (N + 31) >> 5;
    const int span = nw + 2;                    // words a buffer: the signs, then two zeros
    // Words by 16-byte loads: those inside the row (the loads may pass N,
    // not L); the rest (all of a ring whose rows are not 16-byte aligned) by
    // a ballot a word.
    const int full = vec ? min(nw, L / (VEC * LPW)) : 0;
    const int nvec = full * LPW;
    const bool comp = W == 2 && mk.lo[1] == ~mk.lo[0] && mk.hi[1] == ~mk.hi[0];
    const int groups = (P + 31) >> 5;
    const int g0 = warp * groups / WARPS, g1 = (warp + 1) * groups / WARPS;

    // The block's least key of channel c (its warps' keys in best_w[k]) to
    // its position.
    auto finish = [&](int k, int ch) {
        uint32_t key = best_w[k][0];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) key = min(key, best_w[k][w]);
        const int n = 64 - (int)(key >> 24);
        const int idx = (int)(key & 0xFFFFFFu);
        pos[ch] = n >= thresh ? idx % P : 0;
    };

    // The first batch of the next channel is in flight while this one is
    // counted: load the first, then for each channel pack it, sync, load
    // the next, count.
    auto row_of = [&](int ch) { return ring + (size_t)ch * L; };
    int c = c0 + __ffs(todo_m) - 1, prev = -1;
    todo_m &= todo_m - 1;
    uint4 x[ACQ_INFLIGHT];
    load_batch(x, row_of(c), 0, nvec, tid);
    int i = 0;
    for (;; ++i) {
        uint32_t* buf = bits + (i & 1) * span;
        const Sym* row = row_of(c);
        pack_batch<Sym>(x, buf, 0, nvec, N, tid, lane);
        for (int v0 = THREADS * ACQ_INFLIGHT; v0 < nvec; v0 += THREADS * ACQ_INFLIGHT) {
            load_batch(x, row, v0, nvec, tid);
            pack_batch<Sym>(x, buf, v0, nvec, N, tid, lane);
        }
        for (int q = full + warp; q < span; q += WARPS) {
            const int j = (q << 5) + lane;
            const uint32_t s = __ballot_sync(ACQ_FULL, j < N && widen(row[j]) < 0.0f);
            if (lane == 0) buf[q] = s;
        }
        __syncthreads();                        // buf filled; best_w[(i - 1) & 1] written
        if (prev >= 0 && tid == 0) finish((i - 1) & 1, prev);
        const bool more = todo_m != 0;
        const int next = more ? c0 + __ffs(todo_m) - 1 : c;
        if (more) {
            todo_m &= todo_m - 1;
            load_batch(x, row_of(next), 0, nvec, tid);
        }

        // ---- this warp's lags, then the least key of the block ---------
        uint32_t best = comp   ? count_lags<2, true>(buf, g0, g1, lane, mk, P)
                        : W == 1 ? count_lags<1, false>(buf, g0, g1, lane, mk, P)
                        : W == 2 ? count_lags<2, false>(buf, g0, g1, lane, mk, P)
                        : W == 3 ? count_lags<3, false>(buf, g0, g1, lane, mk, P)
                                 : count_lags<4, false>(buf, g0, g1, lane, mk, P);
        best = __reduce_min_sync(ACQ_FULL, best);
        if (lane == 0) best_w[i & 1][warp] = best;
        if (!more) break;
        prev = c;
        c = next;
    }
    __syncthreads();
    if (tid == 0) finish(i & 1, c);
}

template <class Sym>
static int launch(const void* ring, const void* locked, void* pos, const uint32_t* masks,
                  int C, int L, int P, int W, int thresh, cudaStream_t st) {
    if (C < 1 || P < 1 || W < 1 || W > ACQ_MAX_WORDS || P + 63 > L
        || (long long)W * P >= (1LL << 24))
        return (int)cudaErrorInvalidValue;
    Masks mk;
    for (int w = 0; w < ACQ_MAX_WORDS; ++w) {
        mk.lo[w] = w < W ? masks[2 * w] : 0;
        mk.hi[w] = w < W ? masks[2 * w + 1] : 0;
    }
    const int vec = ((uintptr_t)ring % 16 == 0) && ((size_t)L * sizeof(Sym)) % 16 == 0;
    const int words = (P + 63 + 31) / 32 + 2;
    const int grid = (C + Shape<Sym>::cpb - 1) / Shape<Sym>::cpb;
    acquire_kernel<Sym><<<grid, Shape<Sym>::threads, 2 * words * 4, st>>>(
        (const Sym*)ring, (const bool*)locked, (int*)pos, mk, C, L, P, W, thresh, vec);
    return (int)cudaGetLastError();
}

// masks: 2 W u32, word w's (lo, hi) (ops/acquire_cuda.py::pack_masks).
extern "C" int xrit_acquire(const void* ring, const void* locked, void* pos,
                            const uint32_t* masks, int C, int L, int P, int W, int thresh,
                            void* stream) {
    return launch<float>(ring, locked, pos, masks, C, L, P, W, thresh, (cudaStream_t)stream);
}

extern "C" int xrit_acquire_bf16(const void* ring, const void* locked, void* pos,
                                 const uint32_t* masks, int C, int L, int P, int W, int thresh,
                                 void* stream) {
    return launch<__nv_bfloat16>(ring, locked, pos, masks, C, L, P, W, thresh,
                                 (cudaStream_t)stream);
}
