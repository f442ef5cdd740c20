// Demodulator front end on channels-last (T, C) planes: AGC gain recursion,
// N-tap RRC FIR with carried history, order-2 Costas loop, in one kernel.
//
// Replaces the Pallas kernel _frontend_kernel of
// xritdemod_tpu/ops/frontend_pallas.py.
//
// What bounds it on an H100 is not bytes (the block once in, once out) and
// not arithmetic but the length of one thread's dependent chain: the AGC
// gain and the Costas phase of a channel are recursions over all T samples,
// and a warp that walks one runs every instruction of its loop body with
// nothing to interleave.  So the design takes everything out of the two
// chains that is not recursive, and runs the stages side by side instead of
// one after another.  One block serves 32 channels (lane = channel, so a
// tile row is one 128-byte line of the planes and of shared memory, free of
// bank conflicts) and walks the block in tiles of TR samples.  Its warps
// have one job each and hand tiles on through rings in shared memory,
// guarded by mbarriers (sync.cuh):
//
//   loader   cp.async of the next input tiles, NX tiles ahead;
//   mag      |x| of a whole tile (needs no state);
//   agc      the gain recursion alone, magnitudes taken to registers a batch
//            at a time, leaving the gain each sample met;
//   fir      six warps: x * gain into a ring of the last rows (which starts
//            as the carried history and ends as the new one), then the N-tap
//            product, FIR_R outputs per thread from a sliding register
//            window fed FIR_R ring rows at a time, each output's taps in
//            ascending order;
//   costas   the phase recursion alone, on a batch of filter outputs held in
//            registers, rotated in place;
//   store    finished tiles to device memory as whole rows.
//
// The kernel then takes what its slowest stage takes, the Costas chain,
// provided nothing else runs on that warp's scheduler: see `enum Role`.
// Loop bodies are kept small (CHAIN, one shared copy of the FIR loop): a
// lone warp that runs long straight-line code waits on instruction fetch.
// Nothing between the stages touches device memory.  Built without FMA
// contraction and without fast-math: each product and sum rounds as the
// plain PyTorch version's does, sine, cosine and sqrtf are the accurate
// forms, and the per-sample arithmetic is loops.cuh's, shared with stream.cu.
//
// More forms of the Pallas kernel, chosen per launch by template
// (frontend_kernel<TR, SLAB_AGC, SLAB_COSTAS, BF16>; <48, false, false,
// false> is the exact form):
//
//   SLAB   its block_k = K (SLAB_AGC and SLAB_COSTAS both: its block_stages
//          "both"; one of them: "agc" or "costas", the other loop exact):
//          the AGC warp computes a slab of K gains from an
//          affine prefix over the slab's magnitudes (ops/agc.agc_slab_gains:
//          log2 K passes, in registers for K <= 16 and over a per-lane
//          scratch column in shared memory above, the max-gain clamp exact
//          through a running minimum), and the Costas warp runs the slab
//          update of loops.cuh (K rotations that depend only on the slab's
//          first phase and freq, taken a batch at a time, then one update of
//          the loop filter): neither chain is a sample any more.  Which warp
//          sits where then changes (see Layout).  The AGC
//          needs whole slabs in a tile, so the tile is TR = 48 samples where
//          K divides 48 and 64 (eight FIR warps) where K divides 64; slabs
//          start at the block's first sample.  K is a launch argument.
//   BF16   its precision "bf16": the FIR warps round each AGC output and
//          each tap to bfloat16 (to nearest even) before the product, which
//          is then exact in float32; the sums stay float32 in ascending tap
//          order.  The carried history keeps the float32 AGC outputs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "loops.cuh"     // agc_mag, agc_gain_step, costas_step, costas_slab_*
#include "sync.cuh"      // mbarriers, cp.async

#define NX 3             // input tiles in flight
#define NF 3             // filter-output tiles in flight
#define FIR_R 8          // outputs per thread in the FIR
#define FIR_PAD (FIR_R - 1)
#define FIR_MAX_TAPS 256
#define CHAIN 4          // samples a chain warp holds in registers at a time
#define FIR_BARRIER 1

// A warp's scheduler is its index mod 4, and a scheduler is greedy: a warp
// with independent instructions ready (the FIR) holds back a warp that waits
// on its own last result (a chain).  So the Costas chain, which sets the
// kernel's time, has scheduler 3 to itself (warps 7 and 11 leave at once),
// and the FIR warps (TR / FIR_R: six at TR = 48) are two or three to each of
// the other three, followed there by the loader, magnitude, AGC and store
// warps.
enum Role { COSTAS = 3, IDLE7 = 7, IDLE11 = 11 };

// The warp index of the n-th warp off scheduler 3.
constexpr int off_costas_scheduler(int n) { return n + n / 3; }

// The Costas warp has scheduler 3 to itself in every form: the exact chain
// waits on its own last result, and the slab walk, which has independent
// work at every step, is issue-bound (among the FIR warps it makes the
// SLAB_COSTAS-only form half again as slow; tools/kernel_probe.py
// frontend_bk8_costas, PERF.md).  The AGC warp sits among the FIR warps: its
// exact chain keeps up there, and its slab prefix is no faster beside the
// exact Costas chain, which it then slows.  With both slabs it takes warp 7,
// beside the Costas slab walk on scheduler 3.
template <int TR, bool SLAB_AGC, bool SLAB_COSTAS>
struct Layout {
    static constexpr int FIR_WARPS = TR / FIR_R;
    static constexpr int FIR_THREADS = FIR_WARPS * 32;
    static constexpr int LOADER = off_costas_scheduler(FIR_WARPS),
                         MAG = off_costas_scheduler(FIR_WARPS + 1),
                         AGC = SLAB_AGC && SLAB_COSTAS ? IDLE7
                                                       : off_costas_scheduler(FIR_WARPS + 2),
                         STORE = off_costas_scheduler(FIR_WARPS + 3);
    static constexpr int NWARPS = STORE + 1;
    static_assert(TR % FIR_R == 0 && FIR_WARPS <= 8, "tile");
};
static_assert(Layout<48, false, false>::LOADER == 8 && Layout<48, false, false>::MAG == 9
              && Layout<48, false, false>::AGC == 10 && Layout<48, false, false>::STORE == 12
              && Layout<48, false, false>::NWARPS == 13, "the exact form's warps");

// The FIR index of a FIR warp.
template <int TR>
__device__ __forceinline__ int fir_index(int role) {
    if constexpr (TR / FIR_R <= 6) return role < COSTAS ? role : role - 1;
    else return role < COSTAS ? role : role < IDLE7 ? role - 1 : role - 2;
}

__device__ __forceinline__ float round_bf16(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

struct FrontArgs {
    const float *xr, *xi;              // (T, C) block
    const float *hr, *hi;              // (C, ntaps-1) history in
    float *hr_out, *hi_out;            // (C, ntaps-1) history out
    float *yr, *yi;                    // (T, C) output
    const float *taps;                 // (ntaps,)
    const float *gain_in;
    float *gain_out;
    const float *phase_in, *freq_in;
    float *phase_out, *freq_out;
    int T, C, ntaps, win;              // win: rows of the FIR ring, a power of two
    float rate, reference, max_gain;
    float alpha, beta, freq_min, freq_max;
    int bk, nwrap;                     // SLAB: samples a slab, Costas wrap steps a slab
};

// The fixed part of shared memory; the FIR ring (2 x win x 32 floats)
// follows, and with SLAB_AGC the AGC's scratch (3 x TR x 32 floats).
template <int TR>
struct Tiles {
    float xr[NX][TR][32];
    float xi[NX][TR][32];
    float mg[NX][TR][32];              // |x|, then the gain each sample met
    float fr[NF][TR][32];              // filter output, then the rotated output
    float fi[NF][TR][32];
    // taps[k + FIR_PAD] = tap k; zeros around them, so that the sliding
    // window of FIR_R outputs needs no edge cases and runs in whole blocks
    // of FIR_R rows (adding +-0 changes no sum).
    float taps[FIR_MAX_TAPS + 3 * FIR_R];
    uint64_t x_full[NX], m_full[NX], g_full[NX], x_free[NX];
    uint64_t f_full[NF], y_full[NF], f_free[NF];
};

struct Group {                         // what every role knows of its block
    int lane, c0, cc, ntiles;
    bool live;                         // dead lanes shadow channel C-1, store nothing
};

template <int TR>
__device__ __forceinline__ void load_tiles(const FrontArgs& a, Tiles<TR>& s, const Group& g) {
    for (int i = 0; i < g.ntiles; ++i) {
        const int xs = i % NX, turn = i / NX;
        mbar_wait(&s.x_free[xs], (turn & 1) ^ 1);
        const int s0 = i * TR;
        const int n = min(TR, a.T - s0);
        const float* pr = a.xr + (size_t)s0 * a.C + g.cc;
        const float* pi = a.xi + (size_t)s0 * a.C + g.cc;
#pragma unroll 8
        for (int r = 0; r < n; ++r) {
            cp_async_f32(&s.xr[xs][r][g.lane], pr + (size_t)r * a.C);
            cp_async_f32(&s.xi[xs][r][g.lane], pi + (size_t)r * a.C);
        }
        mbar_arrive_on_copies(&s.x_full[xs]);
    }
    cp_async_wait_all();
}

template <int TR>
__device__ __forceinline__ void magnitudes(Tiles<TR>& s, const Group& g) {
    for (int i = 0; i < g.ntiles; ++i) {
        const int xs = i % NX, turn = i / NX;
        mbar_wait(&s.x_full[xs], turn & 1);
#pragma unroll 8
        for (int r = 0; r < TR; ++r)
            s.mg[xs][r][g.lane] = agc_mag(s.xr[xs][r][g.lane], s.xi[xs][r][g.lane]);
        mbar_arrive(&s.m_full[xs]);
    }
}

// One slab of K rows of the magnitude tile m (element k at m[k * 32]) turned
// into the gains those rows met, from the slab's first gain g, which becomes
// the gain after the slab (ops/agc.agc_slab_gains).  A, B, Q: this lane's
// scratch columns, K rows each.
__device__ __forceinline__ void agc_slab(const FrontArgs& a, float* m, float* A, float* B,
                                         float* Q, float& g) {
    const int K = a.bk;
    const float rb = a.rate * a.reference;
    for (int k = 0; k < K; ++k) {
        A[k * 32] = 1.0f - a.rate * m[k * 32];
        B[k * 32] = rb;
    }
    // Hillis-Steele: row k combines with row k - s, rows taken downward so
    // that each pass reads the previous pass's values.
    for (int s = 1; s < K; s *= 2) {
        for (int k = K - 1; k >= s; --k) {
            B[k * 32] = A[k * 32] * B[(k - s) * 32] + B[k * 32];
            A[k * 32] = A[k * 32] * A[(k - s) * 32];
        }
    }
    const float g0 = g;
    if (a.max_gain > 0.0f) {
        for (int k = 0; k < K; ++k) Q[k * 32] = (a.max_gain - B[k * 32]) / A[k * 32];
        for (int s = 1; s < K; s *= 2)
            for (int k = K - 1; k >= s; --k) Q[k * 32] = fminf(Q[k * 32], Q[(k - s) * 32]);
        float met = g0;
#pragma unroll 4
        for (int k = 0; k < K; ++k) {
            const float gn = fminf(A[k * 32] * fminf(g0, Q[k * 32]) + B[k * 32], a.max_gain);
            m[k * 32] = met;
            met = gn;
        }
        g = met;
    } else {
        float met = g0;
#pragma unroll 4
        for (int k = 0; k < K; ++k) {
            const float gn = A[k * 32] * g0 + B[k * 32];
            m[k * 32] = met;
            met = gn;
        }
        g = met;
    }
}

// The same slab in registers, for K <= KMAX: every loop unrolled to KMAX with
// the rows past K idle, so the arrays never leave registers.
template <int KMAX>
__device__ __forceinline__ void agc_slab_regs(const FrontArgs& a, float* m, float& g) {
    const int K = a.bk;
    const float rb = a.rate * a.reference;
    float A[KMAX], B[KMAX], Q[KMAX];
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
        A[k] = k < K ? 1.0f - a.rate * m[k * 32] : 1.0f;
        B[k] = rb;
    }
#pragma unroll
    for (int s = 1; s < KMAX; s *= 2) {
        if (s < K) {
#pragma unroll
            for (int k = KMAX - 1; k >= s; --k) {
                B[k] = A[k] * B[k - s] + B[k];
                A[k] = A[k] * A[k - s];
            }
        }
    }
    const float g0 = g;
    float met = g0;
    if (a.max_gain > 0.0f) {
#pragma unroll
        for (int k = 0; k < KMAX; ++k) Q[k] = (a.max_gain - B[k]) / A[k];
#pragma unroll
        for (int s = 1; s < KMAX; s *= 2) {
            if (s < K) {
#pragma unroll
                for (int k = KMAX - 1; k >= s; --k) Q[k] = fminf(Q[k], Q[k - s]);
            }
        }
#pragma unroll
        for (int k = 0; k < KMAX; ++k) {
            if (k < K) {
                const float gn = fminf(A[k] * fminf(g0, Q[k]) + B[k], a.max_gain);
                m[k * 32] = met;
                met = gn;
            }
        }
    } else {
#pragma unroll
        for (int k = 0; k < KMAX; ++k) {
            if (k < K) {
                const float gn = A[k] * g0 + B[k];
                m[k * 32] = met;
                met = gn;
            }
        }
    }
    g = met;
}

template <int TR, bool SLAB_AGC>
__device__ __forceinline__ void agc_chain(const FrontArgs& a, Tiles<TR>& s, float* scratch,
                                          const Group& g) {
    float gain = a.gain_in[g.cc];
    for (int i = 0; i < g.ntiles; ++i) {
        const int xs = i % NX, turn = i / NX;
        mbar_wait(&s.m_full[xs], turn & 1);
        const int n = min(TR, a.T - i * TR);
        if constexpr (SLAB_AGC) {
            float* A = scratch + g.lane;
            if (a.bk <= 8) {
#pragma unroll 1
                for (int r0 = 0; r0 < n; r0 += a.bk) agc_slab_regs<8>(a, &s.mg[xs][r0][g.lane], gain);
            } else if (a.bk <= 16) {
#pragma unroll 1
                for (int r0 = 0; r0 < n; r0 += a.bk) agc_slab_regs<16>(a, &s.mg[xs][r0][g.lane], gain);
            } else {
                for (int r0 = 0; r0 < n; r0 += a.bk)
                    agc_slab(a, &s.mg[xs][r0][g.lane], A, A + TR * 32, A + 2 * TR * 32, gain);
            }
        } else if (n == TR) {
#pragma unroll 1
            for (int u0 = 0; u0 < TR; u0 += CHAIN) {
                float m[CHAIN];
#pragma unroll
                for (int u = 0; u < CHAIN; ++u) m[u] = s.mg[xs][u0 + u][g.lane];
#pragma unroll
                for (int u = 0; u < CHAIN; ++u) {
                    const float met = gain;
                    agc_gain_step(m[u], gain, a.rate, a.reference, a.max_gain);
                    m[u] = met;
                }
#pragma unroll
                for (int u = 0; u < CHAIN; ++u) s.mg[xs][u0 + u][g.lane] = m[u];
            }
        } else {
#pragma unroll 1
            for (int u = 0; u < n; ++u) {
                const float m = s.mg[xs][u][g.lane];
                s.mg[xs][u][g.lane] = gain;
                agc_gain_step(m, gain, a.rate, a.reference, a.max_gain);
            }
        }
        mbar_arrive(&s.g_full[xs]);
    }
    if (g.live) a.gain_out[g.c0 + g.lane] = gain;
}

template <int TR, bool BF16>
__device__ __forceinline__ void fir_stage(const FrontArgs& a, Tiles<TR>& s, float* er, float* ei,
                                          const Group& g, int w) {
    constexpr int FIR_WARPS = Layout<TR, false, false>::FIR_WARPS;
    constexpr int FIR_THREADS = Layout<TR, false, false>::FIR_THREADS;
    const int nh = a.ntaps - 1, mask = a.win - 1, lane = g.lane;
    const int blocks = (a.ntaps + FIR_PAD + FIR_R - 1) / FIR_R;    // of FIR_R ring rows
    for (int m = w * 32 + lane; m < (blocks + 1) * FIR_R; m += FIR_THREADS) {
        const int k = m - FIR_PAD;
        const float t = (k >= 0 && k < a.ntaps) ? a.taps[k] : 0.0f;
        s.taps[m] = BF16 ? round_bf16(t) : t;
    }
    // Ring row e holds row e of [history | AGC output], at e mod win.  The
    // ring starts as zeros: a row the products below reach before it is
    // written meets a zero tap, and must be finite.
    for (int k = w; k < a.win; k += FIR_WARPS) {
        er[k * 32 + lane] = k < nh ? a.hr[(size_t)g.cc * nh + k] : 0.0f;
        ei[k * 32 + lane] = k < nh ? a.hi[(size_t)g.cc * nh + k] : 0.0f;
    }
    for (int i = 0; i < g.ntiles; ++i) {
        const int xs = i % NX, turn = i / NX;
        const int s0 = i * TR;
        const int n = min(TR, a.T - s0);
        // The tile's AGC output: each sample times the gain it met.  Rows
        // past the block's end are written as zeros, never left unwritten.
        mbar_wait(&s.g_full[xs], turn & 1);
#pragma unroll
        for (int r = 0; r < FIR_R; ++r) {
            const int row = w * FIR_R + r;
            const float gain = s.mg[xs][row][lane];
            const int pos = ((s0 + nh + row) & mask) * 32 + lane;
            const bool in = row < n;
            er[pos] = in ? s.xr[xs][row][lane] * gain : 0.0f;
            ei[pos] = in ? s.xi[xs][row][lane] * gain : 0.0f;
        }
        mbar_arrive(&s.x_free[xs]);
        // One barrier a tile is enough: the ring is at least ntaps-1 + 2*TR
        // rows, so the rows a warp writes for the next tile are none of
        // those a slower warp still needs for this one.
        named_barrier(FIR_BARRIER, FIR_THREADS);

        // Outputs s0 + w*FIR_R + r, r < FIR_R.  Ring row e0 + j feeds output
        // r through tap j - r; rows come in ascending j, so every output
        // adds its taps in ascending order, product and sum rounded apart.
        // A block of FIR_R rows is taken to registers at a time (e0 and win
        // are multiples of FIR_R, so a block never wraps inside).
        float ar[FIR_R], ai[FIR_R], wt[FIR_R];
#pragma unroll
        for (int r = 0; r < FIR_R; ++r) {
            ar[r] = 0.0f; ai[r] = 0.0f;
            wt[r] = s.taps[FIR_PAD - r];
        }
        const int e0 = s0 + w * FIR_R;
#pragma unroll 1
        for (int jb = 0; jb < blocks; ++jb) {
            const int pos = ((e0 + jb * FIR_R) & mask) * 32 + lane;
            float vr[FIR_R], vi[FIR_R], tn[FIR_R];
#pragma unroll
            for (int jj = 0; jj < FIR_R; ++jj) {
                vr[jj] = er[pos + jj * 32];
                vi[jj] = ei[pos + jj * 32];
                if constexpr (BF16) {
                    vr[jj] = round_bf16(vr[jj]);
                    vi[jj] = round_bf16(vi[jj]);
                }
                tn[jj] = s.taps[jb * FIR_R + jj + 1 + FIR_PAD];
            }
#pragma unroll
            for (int jj = 0; jj < FIR_R; ++jj) {
#pragma unroll
                for (int r = 0; r < FIR_R; ++r) {
                    ar[r] = ar[r] + wt[r] * vr[jj];
                    ai[r] = ai[r] + wt[r] * vi[jj];
                }
#pragma unroll
                for (int r = FIR_R - 1; r > 0; --r) wt[r] = wt[r - 1];
                wt[0] = tn[jj];
            }
        }
        const int fs = i % NF, fturn = i / NF;
        mbar_wait(&s.f_free[fs], (fturn & 1) ^ 1);
#pragma unroll
        for (int r = 0; r < FIR_R; ++r) {
            s.fr[fs][w * FIR_R + r][lane] = ar[r];
            s.fi[fs][w * FIR_R + r][lane] = ai[r];
        }
        mbar_arrive(&s.f_full[fs]);
    }
    // The new history: the last ntaps-1 rows of [history | AGC output].
    // Every warp is past the last tile's barrier, so all of them are written.
    if (g.live) {
        for (int k = w; k < nh; k += FIR_WARPS) {
            const int pos = ((a.T + k) & mask) * 32 + lane;
            a.hr_out[(size_t)(g.c0 + lane) * nh + k] = er[pos];
            a.hi_out[(size_t)(g.c0 + lane) * nh + k] = ei[pos];
        }
    }
}

template <int TR, bool SLAB_COSTAS>
__device__ __forceinline__ void costas_chain(const FrontArgs& a, Tiles<TR>& s, const Group& g) {
    float phase = a.phase_in[g.cc], freq = a.freq_in[g.cc];
    CostasSlab slab{phase, freq, 0.0f, 0.0f, 0};
    for (int i = 0; i < g.ntiles; ++i) {
        const int fs = i % NF, fturn = i / NF;
        mbar_wait(&s.f_full[fs], fturn & 1);
        const int n = min(TR, a.T - i * TR);
        if constexpr (SLAB_COSTAS) {
            costas_slab_walk(&s.fr[fs][0][g.lane], &s.fi[fs][0][g.lane], 32, n, slab, a.bk,
                             a.alpha, a.beta, a.freq_min, a.freq_max, a.nwrap);
        } else if (n == TR) {
#pragma unroll 1
            for (int u0 = 0; u0 < TR; u0 += CHAIN) {
                float vr[CHAIN], vi[CHAIN];
#pragma unroll
                for (int u = 0; u < CHAIN; ++u) {
                    vr[u] = s.fr[fs][u0 + u][g.lane];
                    vi[u] = s.fi[fs][u0 + u][g.lane];
                }
#pragma unroll
                for (int u = 0; u < CHAIN; ++u) {
                    float orr, oi;
                    costas_step(vr[u], vi[u], phase, freq, a.alpha, a.beta,
                                a.freq_min, a.freq_max, orr, oi);
                    vr[u] = orr; vi[u] = oi;
                }
#pragma unroll
                for (int u = 0; u < CHAIN; ++u) {
                    s.fr[fs][u0 + u][g.lane] = vr[u];
                    s.fi[fs][u0 + u][g.lane] = vi[u];
                }
            }
        } else {
#pragma unroll 1
            for (int u = 0; u < n; ++u) {
                float orr, oi;
                costas_step(s.fr[fs][u][g.lane], s.fi[fs][u][g.lane], phase, freq,
                            a.alpha, a.beta, a.freq_min, a.freq_max, orr, oi);
                s.fr[fs][u][g.lane] = orr;
                s.fi[fs][u][g.lane] = oi;
            }
        }
        mbar_arrive(&s.y_full[fs]);
    }
    if constexpr (SLAB_COSTAS) {
        phase = slab.phase;
        freq = slab.freq;
    }
    if (g.live) {
        a.phase_out[g.c0 + g.lane] = phase;
        a.freq_out[g.c0 + g.lane] = freq;
    }
}

template <int TR>
__device__ __forceinline__ void store_tiles(const FrontArgs& a, Tiles<TR>& s, const Group& g) {
    for (int i = 0; i < g.ntiles; ++i) {
        const int fs = i % NF, fturn = i / NF;
        mbar_wait(&s.y_full[fs], fturn & 1);
        const int s0 = i * TR;
        const int n = min(TR, a.T - s0);
        if (g.live) {
            float* pr = a.yr + (size_t)s0 * a.C + g.c0 + g.lane;
            float* pi = a.yi + (size_t)s0 * a.C + g.c0 + g.lane;
#pragma unroll 8
            for (int r = 0; r < n; ++r) {
                pr[(size_t)r * a.C] = s.fr[fs][r][g.lane];
                pi[(size_t)r * a.C] = s.fi[fs][r][g.lane];
            }
        }
        mbar_arrive(&s.f_free[fs]);
    }
}

template <int TR, bool SLAB_AGC, bool SLAB_COSTAS, bool BF16>
__global__ void __launch_bounds__(Layout<TR, SLAB_AGC, SLAB_COSTAS>::NWARPS * 32, 1)
frontend_kernel(const FrontArgs a) {
    using L = Layout<TR, SLAB_AGC, SLAB_COSTAS>;
    constexpr int FIR_THREADS = L::FIR_THREADS;
    extern __shared__ __align__(16) unsigned char smem[];
    Tiles<TR>& s = *reinterpret_cast<Tiles<TR>*>(smem);
    float* er = reinterpret_cast<float*>(smem + sizeof(Tiles<TR>));
    float* ei = er + a.win * 32;

    if (threadIdx.x == 0) {
        for (int k = 0; k < NX; ++k) {
            mbar_init(&s.x_full[k], 32);
            mbar_init(&s.m_full[k], 32);
            mbar_init(&s.g_full[k], 32);
            mbar_init(&s.x_free[k], FIR_THREADS);
        }
        for (int k = 0; k < NF; ++k) {
            mbar_init(&s.f_full[k], FIR_THREADS);
            mbar_init(&s.y_full[k], 32);
            mbar_init(&s.f_free[k], 32);
        }
        mbar_init_fence();
    }
    __syncthreads();       // the last block-wide barrier: roles part here

    Group g;
    g.lane = threadIdx.x & 31;
    g.c0 = blockIdx.x * 32;
    g.live = g.c0 + g.lane < a.C;
    g.cc = g.live ? g.c0 + g.lane : a.C - 1;
    g.ntiles = (a.T + TR - 1) / TR;
    // One call of each role: six copies of the FIR loop would not share the
    // instruction cache of the schedulers they run on.
    const int role = threadIdx.x >> 5;
    const long long role_t0 = role_clock_start();
    if (role == L::LOADER) load_tiles(a, s, g);
    else if (role == L::MAG) magnitudes(s, g);
    else if (role == L::AGC) agc_chain<TR, SLAB_AGC>(a, s, ei + a.win * 32, g);
    else if (role == COSTAS) costas_chain<TR, SLAB_COSTAS>(a, s, g);
    else if (role == L::STORE) store_tiles(a, s, g);
    else if ((role & 3) != 3 && role < L::LOADER)
        fir_stage<TR, BF16>(a, s, er, ei, g, fir_index<TR>(role));
    role_clock_stop(role_t0);
}

// loops.cuh's sincos_exact against the library's sinf and cosf on n arguments
// spread evenly over [lo, hi]: *mismatches (zeroed by the caller) receives
// the number whose sine or cosine differs in any bit.
__global__ void trig_check_kernel(float lo, float hi, long long n, unsigned long long* mismatches) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    unsigned long long bad = 0;
    for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x; k < n; k += stride) {
        const float x = lo + (hi - lo) * (float)((double)k / (double)(n - 1));
        float sn, cs;
        sincos_exact(x, sn, cs);
        bad += __float_as_uint(sn) != __float_as_uint(sinf(x))
            || __float_as_uint(cs) != __float_as_uint(cosf(x));
    }
    if (bad) atomicAdd(mismatches, bad);
}

extern "C" int xrit_trig_mismatches(float lo, float hi, long long n, void* mismatches,
                                    void* stream) {
    if (n < 2) return (int)cudaErrorInvalidValue;
    trig_check_kernel<<<1024, 256, 0, (cudaStream_t)stream>>>(
        lo, hi, n, (unsigned long long*)mismatches);
    return (int)cudaGetLastError();
}

template <int TR, bool SLAB_AGC, bool SLAB_COSTAS, bool BF16>
static int launch_frontend(FrontArgs a, void* stream) {
    a.win = 64;
    while (a.win < a.ntaps - 1 + 2 * TR) a.win *= 2;
    const size_t shared = sizeof(Tiles<TR>) + (size_t)2 * a.win * 32 * sizeof(float)
        + (SLAB_AGC ? (size_t)3 * TR * 32 * sizeof(float) : 0);
    const auto kernel = frontend_kernel<TR, SLAB_AGC, SLAB_COSTAS, BF16>;
    int err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (err) return err;
    kernel<<<(a.C + 31) / 32, Layout<TR, SLAB_AGC, SLAB_COSTAS>::NWARPS * 32, shared,
             (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

// The slab forms of tile TR: stages 3 both loops, 1 the AGC, 2 the Costas.
template <int TR>
static int launch_slab(const FrontArgs& a, int stages, bool bf16, void* stream) {
    switch (stages * 2 + bf16) {
        case 6: return launch_frontend<TR, true, true, false>(a, stream);
        case 7: return launch_frontend<TR, true, true, true>(a, stream);
        case 2: return launch_frontend<TR, true, false, false>(a, stream);
        case 3: return launch_frontend<TR, true, false, true>(a, stream);
        case 4: return launch_frontend<TR, false, true, false>(a, stream);
        case 5: return launch_frontend<TR, false, true, true>(a, stream);
    }
    return (int)cudaErrorInvalidValue;
}

static FrontArgs front_args(
    const void* xr, const void* xi, const void* hr, const void* hi,
    void* hr_out, void* hi_out, void* yr, void* yi, const void* taps,
    const void* gain_in, void* gain_out,
    const void* phase_in, const void* freq_in, void* phase_out, void* freq_out,
    int T, int C, int ntaps,
    float rate, float reference, float max_gain,
    float alpha, float beta, float freq_min, float freq_max) {
    FrontArgs a;
    a.xr = (const float*)xr; a.xi = (const float*)xi;
    a.hr = (const float*)hr; a.hi = (const float*)hi;
    a.hr_out = (float*)hr_out; a.hi_out = (float*)hi_out;
    a.yr = (float*)yr; a.yi = (float*)yi;
    a.taps = (const float*)taps;
    a.gain_in = (const float*)gain_in; a.gain_out = (float*)gain_out;
    a.phase_in = (const float*)phase_in; a.freq_in = (const float*)freq_in;
    a.phase_out = (float*)phase_out; a.freq_out = (float*)freq_out;
    a.T = T; a.C = C; a.ntaps = ntaps;
    a.rate = rate; a.reference = reference; a.max_gain = max_gain;
    a.alpha = alpha; a.beta = beta; a.freq_min = freq_min; a.freq_max = freq_max;
    a.bk = 0; a.nwrap = 0;
    return a;
}

// x, y (T, C); hist in and out (C, ntaps-1); state vectors (C,).  One launch.
// The exact form.
extern "C" int xrit_frontend(
    const void* xr, const void* xi, const void* hr, const void* hi,
    void* hr_out, void* hi_out, void* yr, void* yi, const void* taps,
    const void* gain_in, void* gain_out,
    const void* phase_in, const void* freq_in, void* phase_out, void* freq_out,
    int T, int C, int ntaps,
    float rate, float reference, float max_gain,
    float alpha, float beta, float freq_min, float freq_max, void* stream) {
    if (ntaps < 1 || ntaps > FIR_MAX_TAPS || T < 1 || C < 1) return (int)cudaErrorInvalidValue;
    const FrontArgs a = front_args(xr, xi, hr, hi, hr_out, hi_out, yr, yi, taps, gain_in,
                                   gain_out, phase_in, freq_in, phase_out, freq_out, T, C,
                                   ntaps, rate, reference, max_gain, alpha, beta, freq_min,
                                   freq_max);
    return launch_frontend<48, false, false, false>(a, stream);
}

// The same with the slab form (block_k = bk > 0, T a multiple of bk, bk
// dividing 48 or 64; nwrap the Costas wrap steps a slab; stages which loops
// take it: 1 the AGC, 2 the Costas loop, 3 both) and / or the bf16 filter
// products (bf16 != 0).
extern "C" int xrit_frontend_form(
    const void* xr, const void* xi, const void* hr, const void* hi,
    void* hr_out, void* hi_out, void* yr, void* yi, const void* taps,
    const void* gain_in, void* gain_out,
    const void* phase_in, const void* freq_in, void* phase_out, void* freq_out,
    int T, int C, int ntaps,
    float rate, float reference, float max_gain,
    float alpha, float beta, float freq_min, float freq_max,
    int bk, int nwrap, int stages, int bf16, void* stream) {
    if (ntaps < 1 || ntaps > FIR_MAX_TAPS || T < 1 || C < 1 || bk < 0 || (bk && T % bk)
        || (bk && nwrap < 1) || (bk && (stages < 1 || stages > 3)))
        return (int)cudaErrorInvalidValue;
    FrontArgs a = front_args(xr, xi, hr, hi, hr_out, hi_out, yr, yi, taps, gain_in,
                             gain_out, phase_in, freq_in, phase_out, freq_out, T, C,
                             ntaps, rate, reference, max_gain, alpha, beta, freq_min,
                             freq_max);
    a.bk = bk;
    a.nwrap = nwrap;
    if (bk == 0) return bf16 ? launch_frontend<48, false, false, true>(a, stream)
                             : launch_frontend<48, false, false, false>(a, stream);
    if (48 % bk == 0) return launch_slab<48>(a, stages, bf16 != 0, stream);
    if (64 % bk == 0) return launch_slab<64>(a, stages, bf16 != 0, stream);
    return (int)cudaErrorInvalidValue;
}
