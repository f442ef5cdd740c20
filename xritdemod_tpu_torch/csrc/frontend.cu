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
// Its precision "bf16" is a second instance (frontend_kernel<BF16>): the
// FIR warps round each AGC output and each tap to bfloat16 (to nearest
// even) before the product, which is then exact in float32; the sums stay
// float32 in ascending tap order.  The carried history keeps the float32
// AGC outputs.  The slab forms (block_k) are frontend_slab_kernel, below.
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
// waits on its own last result, and a slab walk needs its issue (a
// one-lane walk among the FIR warps was half again as slow;
// tools/kernel_probe.py, PERF.md).  The AGC warp sits among the FIR warps:
// its exact chain keeps up there.  Both kernels take this layout of TR / 8
// FIR warps.
template <int TR>
struct Layout {
    static constexpr int FIR_WARPS = TR / FIR_R;
    static constexpr int FIR_THREADS = FIR_WARPS * 32;
    static constexpr int LOADER = off_costas_scheduler(FIR_WARPS),
                         MAG = off_costas_scheduler(FIR_WARPS + 1),
                         AGC = off_costas_scheduler(FIR_WARPS + 2),
                         STORE = off_costas_scheduler(FIR_WARPS + 3);
    static constexpr int NWARPS = STORE + 1;
    static_assert(TR % FIR_R == 0 && FIR_WARPS <= 8, "tile");
};
static_assert(Layout<48>::LOADER == 8 && Layout<48>::MAG == 9 && Layout<48>::AGC == 10
              && Layout<48>::STORE == 12 && Layout<48>::NWARPS == 13, "the exact form's warps");
constexpr int EXACT_TR = 48;           // the exact form's tile

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
// follows.
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

template <int TR>
__device__ __forceinline__ void agc_chain(const FrontArgs& a, Tiles<TR>& s, const Group& g) {
    float gain = a.gain_in[g.cc];
    for (int i = 0; i < g.ntiles; ++i) {
        const int xs = i % NX, turn = i / NX;
        mbar_wait(&s.m_full[xs], turn & 1);
        const int n = min(TR, a.T - i * TR);
        if (n == TR) {
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
    constexpr int FIR_WARPS = Layout<TR>::FIR_WARPS;
    constexpr int FIR_THREADS = Layout<TR>::FIR_THREADS;
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
    // Rows nh .. nh+TR-1, zeroed here by one warp, take the first tile's
    // AGC output from another: every warp zeroes before any writes a tile.
    named_barrier(FIR_BARRIER, FIR_THREADS);
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

template <int TR>
__device__ __forceinline__ void costas_chain(const FrontArgs& a, Tiles<TR>& s, const Group& g) {
    float phase = a.phase_in[g.cc], freq = a.freq_in[g.cc];
    for (int i = 0; i < g.ntiles; ++i) {
        const int fs = i % NF, fturn = i / NF;
        mbar_wait(&s.f_full[fs], fturn & 1);
        const int n = min(TR, a.T - i * TR);
        if (n == TR) {
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

template <bool BF16>
__global__ void __launch_bounds__(Layout<EXACT_TR>::NWARPS * 32, 1)
frontend_kernel(const FrontArgs a) {
    constexpr int TR = EXACT_TR;
    using L = Layout<TR>;
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
    else if (role == L::AGC) agc_chain<TR>(a, s, g);
    else if (role == COSTAS) costas_chain<TR>(a, s, g);
    else if (role == L::STORE) store_tiles(a, s, g);
    else if ((role & 3) != 3 && role < L::LOADER)
        fir_stage<TR, BF16>(a, s, er, ei, g, fir_index<TR>(role));
    role_clock_stop(role_t0);
}


// ---------------------------------------------------------------------------
// The slab forms: frontend_slab_kernel<TR, SLAB_AGC, SLAB_COSTAS, BF16, SK>.
//
// With the chains no longer a sample a step, the FIR's issue sets the slab
// forms' time: 2 planes x (a product and a sum) x 72 ring rows an output,
// ~2.4 G warp-instructions at C = 2048 x 131072, which 32 channels a block
// put on 64 SMs.  So a block here serves SCPB = 16 channels (grid 128 at C =
// 2048), and every role splits its warp in two halves of 16 lanes:
//
//   loader   half p copies plane p (re, im) of the next tile's rows;
//   mag      one warp or, beside the Costas slab walk, SLAB_MAG_WARPS
//            (SlabLayout): |x| of a whole tile and,
//            with SLAB_AGC, each slab's affine prefix over its magnitudes
//            (ops/agc.agc_slab_gains: a_k, b_k and the clamp's running
//            minimum q_k, which need no state), the tile's rows or slabs
//            dealt out to the warps' halves;
//   agc      lanes 0-15 (beside the Costas slab walk on scheduler 3): the
//            gain chain alone.  With SLAB_AGC one min(a * min(g, q) + b, M)
//            a slab, the slab's first gain left for the FIR warps; else the
//            exact recursion, leaving the gain each row met;
//   fir      TR / FIR_R warps: half p filters plane p, FIR_R outputs a
//            thread, as fir_stage does; with SLAB_AGC each row's gain from
//            its slab's first and the prefix of the row before it;
//   costas   with SK = K (a launch of that block_k), lanes 2c, 2c + 1 walk
//            channel c's slabs, each lane half the slab's rotations
//            (loops.cuh costas_slab_spread); with SK = 0 (any other K)
//            lanes 0-15 walk costas_slab_walk; without SLAB_COSTAS they run
//            the exact loop;
//   store    half p writes plane p of finished tiles.
//
// Planes of a tile lie 16 banks apart (PL = TR * 16 + 16 floats), so the two
// halves of a warp never share a bank, nor the two lanes of a channel in the
// Costas walk (rows one apart).  The warps sit as SlabLayout says: the
// Costas warp on scheduler 3, joined there, beside the slab walk, by the
// gain chain and magnitude warps, which among the FIR warps set the
// kernel's time (stage_clocks, PERF.md).
#define SCPB 16          // channels a block in the slab forms
#define SLAB_PREFIX_IN_MAG 1   // the AGC prefix in the magnitude warps (0: on the gain chain)
#define SLAB_AGC_WARP IDLE7    // the gain chain beside the Costas slab walk (scheduler 3)
#define SLAB_MAG_WARPS 3       // magnitude warps beside the Costas slab walk

// The slab kernel's warps.  Beside the exact Costas chain (SLAB_COSTAS
// false), which sets the time, nothing joins scheduler 3: Layout's warps.
// Beside the Costas slab walk, which leaves most of scheduler 3's issue
// free, the gain chain takes warp SLAB_AGC_WARP there (among the FIR warps,
// which a scheduler issues first, it waited on them), and the magnitudes
// take SLAB_MAG_WARPS warps: Layout's MAG, then the free slots (Layout's AGC
// or warp 7, then warp 11).
template <int TR, bool SLAB_COSTAS>
struct SlabLayout {
    using L = Layout<TR>;
    static constexpr int AGC = SLAB_COSTAS ? SLAB_AGC_WARP : L::AGC;
    static constexpr int MAGS = SLAB_COSTAS ? SLAB_MAG_WARPS : 1;
    static constexpr int FREE = AGC == L::AGC ? IDLE7 : L::AGC;
    static_assert(AGC == L::AGC || AGC == IDLE7, "the gain chain's warp");
    // The magnitude warp index of warp `role`, or -1.
    static __device__ __forceinline__ int mag(int role) {
        return role == L::MAG ? 0 : MAGS > 1 && role == FREE ? 1
             : MAGS > 2 && role == IDLE11 ? 2 : -1;
    }
};

template <int TR>
struct SlabTiles {
    static constexpr int PL = TR * SCPB + 16;   // floats from one plane to the next
    float x[NX][2][PL];
    float mg[NX][TR * SCPB];           // |x|; SLAB_AGC: then a_k; then the gain each row met
    float pb[NX][TR * SCPB];           // SLAB_AGC: b_k
    float pq[NX][TR * SCPB];           // SLAB_AGC: q_k (with a max gain)
    float gs[NX][TR * SCPB];           // SLAB_AGC: at a slab's first row, its first gain
    float f[NF][2][PL];                // filter output, then the rotated output
    float taps[FIR_MAX_TAPS + 3 * FIR_R];
    uint64_t x_full[NX], m_full[NX], g_full[NX], x_free[NX];
    uint64_t f_full[NF], y_full[NF], f_free[NF];
};

struct SlabGroup {                     // what every role knows of its block
    int lane, c, p, c0, cc, ntiles;    // c = lane % 16, p = lane / 16 (the half)
    bool live;                         // dead channels shadow channel C-1, store nothing
};

template <int TR>
__device__ __forceinline__ void slab_load(const FrontArgs& a, SlabTiles<TR>& s,
                                          const SlabGroup& g) {
    const float* src = (g.p ? a.xi : a.xr) + g.cc;
    for (int i = 0; i < g.ntiles; ++i) {
        const int xs = i % NX, turn = i / NX;
        mbar_wait(&s.x_free[xs], (turn & 1) ^ 1);
        const int s0 = i * TR;
        const int n = min(TR, a.T - s0);
        const float* ps = src + (size_t)s0 * a.C;
        float* dst = &s.x[xs][g.p][g.c];
#pragma unroll 8
        for (int r = 0; r < n; ++r) cp_async_f32(dst + r * SCPB, ps + (size_t)r * a.C);
        mbar_arrive_on_copies(&s.x_full[xs]);
    }
    cp_async_wait_all();
}

// One slab's prefix, K rows at stride SCPB from A (holding |x| on entry), B
// and Q; ops/agc.agc_slab_gains's order, as the exact form's AGC warp took
// it.  KMAX > 0 (8 at most: sixteen rows of three arrays no longer stay in
// registers): in registers, every loop unrolled to KMAX with the rows past K
// idle; KMAX = 0: in place in the tile (rows taken downward, so that each
// pass reads the previous pass's values).
template <int KMAX>
__device__ __forceinline__ void agc_prefix(const FrontArgs& a, int K, float* A, float* B,
                                           float* Q) {
    const float rb = a.rate * a.reference;
    if constexpr (KMAX > 0) {
        constexpr int LOG2_KMAX = KMAX >= 8 ? 3 : KMAX >= 4 ? 2 : KMAX >= 2 ? 1 : 0;
        static_assert((1 << LOG2_KMAX) == KMAX, "KMAX a power of two up to 8");
        float va[KMAX], vb[KMAX], vq[KMAX];
#pragma unroll
        for (int k = 0; k < KMAX; ++k) {
            va[k] = k < K ? 1.0f - a.rate * A[k * SCPB] : 1.0f;
            vb[k] = rb;
        }
        // The passes counted by log2 s, to a constant bound: a loop the
        // compiler cannot count is not unrolled, and its indices would put
        // the arrays in local memory.
#pragma unroll
        for (int lg = 0; lg < LOG2_KMAX; ++lg) {
            const int s = 1 << lg;
            if (s < K) {
#pragma unroll
                for (int k = KMAX - 1; k >= s; --k) {
                    vb[k] = va[k] * vb[k - s] + vb[k];
                    va[k] = va[k] * va[k - s];
                }
            }
        }
        if (a.max_gain > 0.0f) {
#pragma unroll
            for (int k = 0; k < KMAX; ++k) vq[k] = (a.max_gain - vb[k]) / va[k];
#pragma unroll
            for (int lg = 0; lg < LOG2_KMAX; ++lg) {
                const int s = 1 << lg;
                if (s < K) {
#pragma unroll
                    for (int k = KMAX - 1; k >= s; --k) vq[k] = fminf(vq[k], vq[k - s]);
                }
            }
#pragma unroll
            for (int k = 0; k < KMAX; ++k)
                if (k < K) Q[k * SCPB] = vq[k];
        }
#pragma unroll
        for (int k = 0; k < KMAX; ++k) {
            if (k < K) {
                A[k * SCPB] = va[k];
                B[k * SCPB] = vb[k];
            }
        }
    } else {
        for (int k = 0; k < K; ++k) {
            A[k * SCPB] = 1.0f - a.rate * A[k * SCPB];
            B[k * SCPB] = rb;
        }
        for (int s = 1; s < K; s *= 2) {
            for (int k = K - 1; k >= s; --k) {
                B[k * SCPB] = A[k * SCPB] * B[(k - s) * SCPB] + B[k * SCPB];
                A[k * SCPB] = A[k * SCPB] * A[(k - s) * SCPB];
            }
        }
        if (a.max_gain > 0.0f) {
            for (int k = 0; k < K; ++k) Q[k * SCPB] = (a.max_gain - B[k * SCPB]) / A[k * SCPB];
            for (int s = 1; s < K; s *= 2)
                for (int k = K - 1; k >= s; --k)
                    Q[k * SCPB] = fminf(Q[k * SCPB], Q[(k - s) * SCPB]);
        }
    }
}

// Magnitude warp m of MAGS: its half p is half h = 2m + p of H;
// it takes rows h, h + H, ... of each tile and, with SLAB_AGC, slabs h,
// h + H, ... (each slab's rows are then its own: its magnitudes are
// recomputed there rather than waited for).
template <int TR, bool SLAB_AGC, int SK, int MAGS>
__device__ __forceinline__ void slab_mag(const FrontArgs& a, SlabTiles<TR>& s,
                                         const SlabGroup& g, int m) {
    constexpr int H = 2 * MAGS;
    const int K = SK ? SK : a.bk, h = 2 * m + g.p;
    for (int i = 0; i < g.ntiles; ++i) {
        const int xs = i % NX, turn = i / NX;
        mbar_wait(&s.x_full[xs], turn & 1);
        const int n = min(TR, a.T - i * TR);
        if constexpr (SLAB_AGC && SLAB_PREFIX_IN_MAG) {
#pragma unroll 1
            for (int r0 = h * K; r0 < n; r0 += H * K) {
#pragma unroll 8
                for (int r = r0; r < r0 + K; ++r) {
                    const int e = r * SCPB + g.c;
                    s.mg[xs][e] = agc_mag(s.x[xs][0][e], s.x[xs][1][e]);
                }
                const int e = r0 * SCPB + g.c;
                float *A = &s.mg[xs][e], *B = &s.pb[xs][e], *Q = &s.pq[xs][e];
                if constexpr (SK > 0) agc_prefix<SK>(a, SK, A, B, Q);
                else if (K <= 8) agc_prefix<8>(a, K, A, B, Q);
                else agc_prefix<0>(a, K, A, B, Q);
            }
        } else {
#pragma unroll 8
            for (int r = h; r < TR; r += H) {
                const int e = r * SCPB + g.c;
                s.mg[xs][e] = agc_mag(s.x[xs][0][e], s.x[xs][1][e]);
            }
        }
        mbar_arrive(&s.m_full[xs]);
    }
}

// The gain chain, lanes 0-15 (lanes 16-31 only pass the tiles on).
template <int TR, bool SLAB_AGC, int SK>
__device__ __forceinline__ void slab_agc(const FrontArgs& a, SlabTiles<TR>& s,
                                         const SlabGroup& g) {
    const int K = SK ? SK : a.bk;
    const bool clamp = a.max_gain > 0.0f;
    float gain = a.gain_in[g.cc];
    for (int i = 0; i < g.ntiles; ++i) {
        const int xs = i % NX, turn = i / NX;
        mbar_wait(&s.m_full[xs], turn & 1);
        const int n = min(TR, a.T - i * TR);
        if (g.p == 0) {
            float* m = &s.mg[xs][g.c];
            if constexpr (SLAB_AGC) {
                // One step a slab: the gain after its last row from its
                // first; the gains its other rows met are the FIR warps'.
                float* B = &s.pb[xs][g.c];
                float* Q = &s.pq[xs][g.c];
                float* G = &s.gs[xs][g.c];
#pragma unroll 1
                for (int r0 = 0; r0 < n; r0 += K) {
                    if constexpr (!SLAB_PREFIX_IN_MAG) {
                        const int e = r0 * SCPB;
                        if constexpr (SK > 0) agc_prefix<SK>(a, SK, m + e, B + e, Q + e);
                        else if (K <= 8) agc_prefix<8>(a, K, m + e, B + e, Q + e);
                        else agc_prefix<0>(a, K, m + e, B + e, Q + e);
                    }
                    const int e = (r0 + K - 1) * SCPB;
                    G[r0 * SCPB] = gain;
                    gain = clamp ? fminf(m[e] * fminf(gain, Q[e]) + B[e], a.max_gain)
                                 : m[e] * gain + B[e];
                }
            } else if (n == TR) {
#pragma unroll 1
                for (int u0 = 0; u0 < TR; u0 += CHAIN) {
                    float v[CHAIN];
#pragma unroll
                    for (int u = 0; u < CHAIN; ++u) v[u] = m[(u0 + u) * SCPB];
#pragma unroll
                    for (int u = 0; u < CHAIN; ++u) {
                        const float met = gain;
                        agc_gain_step(v[u], gain, a.rate, a.reference, a.max_gain);
                        v[u] = met;
                    }
#pragma unroll
                    for (int u = 0; u < CHAIN; ++u) m[(u0 + u) * SCPB] = v[u];
                }
            } else {
#pragma unroll 1
                for (int u = 0; u < n; ++u) {
                    const float v = m[u * SCPB];
                    m[u * SCPB] = gain;
                    agc_gain_step(v, gain, a.rate, a.reference, a.max_gain);
                }
            }
        }
        mbar_arrive(&s.g_full[xs]);
    }
    if (g.p == 0 && g.live) a.gain_out[g.c0 + g.c] = gain;
}

// fir_stage on one plane: half p of warp w filters plane p.  With SLAB_AGC
// it forms the gain each of its rows met (agc_slab_gains's order): a slab's
// first row its first gain (gs, from the gain chain), any other row
// min(a * min(g, q) + b, M) (or a * g + b without a max gain) with the
// prefix of the row before it (from the magnitude warps).
template <int TR, bool BF16, bool SLAB_AGC, int SK>
__device__ __forceinline__ void slab_fir(const FrontArgs& a, SlabTiles<TR>& s, float* ring,
                                         const SlabGroup& g, int w) {
    constexpr int FIR_WARPS = TR / FIR_R;
    constexpr int FIR_THREADS = FIR_WARPS * 32;
    const int nh = a.ntaps - 1, mask = a.win - 1, c = g.c;
    const int blocks = (a.ntaps + FIR_PAD + FIR_R - 1) / FIR_R;    // of FIR_R ring rows
    float* er = ring + g.p * (a.win * SCPB + 16);                  // this half's plane
    // bf16: the operands as the products take them, each rounded once, in a
    // second ring (the first keeps the float32 AGC outputs for the history;
    // rounding at every read of a row, nine, is slower: PERF.md).
    float* eb = BF16 ? er + 2 * (a.win * SCPB + 16) : er;
    for (int m = w * 32 + g.lane; m < (blocks + 1) * FIR_R; m += FIR_THREADS) {
        const int k = m - FIR_PAD;
        const float t = (k >= 0 && k < a.ntaps) ? a.taps[k] : 0.0f;
        s.taps[m] = BF16 ? round_bf16(t) : t;
    }
    const float* hist = (g.p ? a.hi : a.hr) + (size_t)g.cc * nh;
    for (int k = w; k < a.win; k += FIR_WARPS) {
        er[k * SCPB + c] = k < nh ? hist[k] : 0.0f;
        if constexpr (BF16) eb[k * SCPB + c] = round_bf16(er[k * SCPB + c]);
    }
    named_barrier(FIR_BARRIER, FIR_THREADS);     // as in fir_stage: zeroes before tiles
    const int K = SK ? SK : a.bk;
    const bool clamp = a.max_gain > 0.0f;
    int kin[FIR_R];                    // each row's place in its slab
#pragma unroll
    for (int r = 0; r < FIR_R; ++r) kin[r] = SLAB_AGC ? (w * FIR_R + r) % K : 0;
    for (int i = 0; i < g.ntiles; ++i) {
        const int xs = i % NX, turn = i / NX;
        const int s0 = i * TR;
        const int n = min(TR, a.T - s0);
        mbar_wait(&s.g_full[xs], turn & 1);
#pragma unroll
        for (int r = 0; r < FIR_R; ++r) {
            const int row = w * FIR_R + r;
            float gain = s.mg[xs][row * SCPB + c];
            if constexpr (SLAB_AGC) {
                const int e = (row - kin[r]) * SCPB + c, d = (kin[r] ? row - 1 : row) * SCPB + c;
                const float g0 = s.gs[xs][e];
                const float A = s.mg[xs][d], B = s.pb[xs][d], Q = s.pq[xs][d];
                const float step = clamp ? fminf(A * fminf(g0, Q) + B, a.max_gain) : A * g0 + B;
                gain = kin[r] ? step : g0;
            }
            const int pos = ((s0 + nh + row) & mask) * SCPB + c;
            er[pos] = row < n ? s.x[xs][g.p][row * SCPB + c] * gain : 0.0f;
            if constexpr (BF16) eb[pos] = round_bf16(er[pos]);
        }
        mbar_arrive(&s.x_free[xs]);
        named_barrier(FIR_BARRIER, FIR_THREADS);

        float acc[FIR_R], wt[FIR_R];
#pragma unroll
        for (int r = 0; r < FIR_R; ++r) {
            acc[r] = 0.0f;
            wt[r] = s.taps[FIR_PAD - r];
        }
        const int e0 = s0 + w * FIR_R;
#pragma unroll 1
        for (int jb = 0; jb < blocks; ++jb) {
            const int pos = ((e0 + jb * FIR_R) & mask) * SCPB + c;
            float v[FIR_R], tn[FIR_R];
#pragma unroll
            for (int jj = 0; jj < FIR_R; ++jj) {
                v[jj] = eb[pos + jj * SCPB];
                tn[jj] = s.taps[jb * FIR_R + jj + 1 + FIR_PAD];
            }
#pragma unroll
            for (int jj = 0; jj < FIR_R; ++jj) {
#pragma unroll
                for (int r = 0; r < FIR_R; ++r) acc[r] = acc[r] + wt[r] * v[jj];
#pragma unroll
                for (int r = FIR_R - 1; r > 0; --r) wt[r] = wt[r - 1];
                wt[0] = tn[jj];
            }
        }
        const int fs = i % NF, fturn = i / NF;
        mbar_wait(&s.f_free[fs], (fturn & 1) ^ 1);
#pragma unroll
        for (int r = 0; r < FIR_R; ++r) s.f[fs][g.p][(w * FIR_R + r) * SCPB + c] = acc[r];
        mbar_arrive(&s.f_full[fs]);
    }
    if (g.live) {
        float* out = (g.p ? a.hi_out : a.hr_out) + (size_t)(g.c0 + c) * nh;
        for (int k = w; k < nh; k += FIR_WARPS) out[k] = er[((a.T + k) & mask) * SCPB + c];
    }
}

template <int TR, bool SLAB_COSTAS, int SK>
__device__ __forceinline__ void slab_costas(const FrontArgs& a, SlabTiles<TR>& s,
                                            const SlabGroup& g) {
    constexpr int PL = SlabTiles<TR>::PL;
    if constexpr (SLAB_COSTAS && SK > 0) {
        // Lanes 2c and 2c + 1: channel c, slab samples j, j + 2, ...
        constexpr int L = 32 / SCPB, N = SK / L;
        const int c = g.lane / L, j = g.lane % L;
        const int cc = min(g.c0 + c, a.C - 1);
        float phase = a.phase_in[cc], freq = a.freq_in[cc], kf[N];
#pragma unroll
        for (int q = 0; q < N; ++q) kf[q] = (float)(j + L * q);
        const uint32_t base = smem_addr(&s.f[0][0][j * SCPB + c]);
        constexpr uint32_t STAGE = 2 * PL * 4;
        for (int i = 0; i < g.ntiles; ++i) {
            const int fs = i % NF, fturn = i / NF;
            mbar_wait(&s.f_full[fs], fturn & 1);
            const int n = min(TR, a.T - i * TR);       // a multiple of SK
            uint32_t at = base + fs * STAGE;
            float vr[N], vi[N], nr[N], ni[N];
#pragma unroll
            for (int q = 0; q < N; ++q) {
                vr[q] = lds_f32<0>(at + 4 * SCPB * L * q);
                vi[q] = lds_f32<4 * PL>(at + 4 * SCPB * L * q);
            }
#pragma unroll 1
            for (int u = 0; u < n; u += SK, at += 4 * SCPB * SK) {
                const uint32_t next = u + SK < n ? at + 4 * SCPB * SK : at;
#pragma unroll
                for (int q = 0; q < N; ++q) {
                    nr[q] = lds_f32<0>(next + 4 * SCPB * L * q);
                    ni[q] = lds_f32<4 * PL>(next + 4 * SCPB * L * q);
                }
                costas_slab_spread<SK, L>(vr, vi, kf, phase, freq, a.alpha, a.beta,
                                          a.freq_min, a.freq_max, a.nwrap);
#pragma unroll
                for (int q = 0; q < N; ++q) {
                    sts_f32<0>(at + 4 * SCPB * L * q, vr[q]);
                    sts_f32<4 * PL>(at + 4 * SCPB * L * q, vi[q]);
                    vr[q] = nr[q];
                    vi[q] = ni[q];
                }
            }
            mbar_arrive(&s.y_full[fs]);
        }
        if (j == 0 && g.c0 + c < a.C) {
            a.phase_out[g.c0 + c] = phase;
            a.freq_out[g.c0 + c] = freq;
        }
    } else {
        float phase = a.phase_in[g.cc], freq = a.freq_in[g.cc];
        CostasSlab slab{phase, freq, 0.0f, 0.0f, 0};
        for (int i = 0; i < g.ntiles; ++i) {
            const int fs = i % NF, fturn = i / NF;
            mbar_wait(&s.f_full[fs], fturn & 1);
            const int n = min(TR, a.T - i * TR);
            float* fr = &s.f[fs][0][g.c];
            float* fi = &s.f[fs][1][g.c];
            if (g.p == 0) {
                if constexpr (SLAB_COSTAS) {
                    costas_slab_walk(fr, fi, SCPB, n, slab, a.bk, a.alpha, a.beta, a.freq_min,
                                     a.freq_max, a.nwrap);
                } else if (n == TR) {
#pragma unroll 1
                    for (int u0 = 0; u0 < TR; u0 += CHAIN) {
                        float vr[CHAIN], vi[CHAIN];
#pragma unroll
                        for (int u = 0; u < CHAIN; ++u) {
                            vr[u] = fr[(u0 + u) * SCPB];
                            vi[u] = fi[(u0 + u) * SCPB];
                        }
#pragma unroll
                        for (int u = 0; u < CHAIN; ++u) {
                            float orr, oi;
                            costas_step<true>(vr[u], vi[u], phase, freq, a.alpha, a.beta,
                                              a.freq_min, a.freq_max, orr, oi);
                            vr[u] = orr; vi[u] = oi;
                        }
#pragma unroll
                        for (int u = 0; u < CHAIN; ++u) {
                            fr[(u0 + u) * SCPB] = vr[u];
                            fi[(u0 + u) * SCPB] = vi[u];
                        }
                    }
                } else {
#pragma unroll 1
                    for (int u = 0; u < n; ++u) {
                        float orr, oi;
                        costas_step<true>(fr[u * SCPB], fi[u * SCPB], phase, freq, a.alpha,
                                          a.beta, a.freq_min, a.freq_max, orr, oi);
                        fr[u * SCPB] = orr;
                        fi[u * SCPB] = oi;
                    }
                }
            }
            mbar_arrive(&s.y_full[fs]);
        }
        if constexpr (SLAB_COSTAS) {
            phase = slab.phase;
            freq = slab.freq;
        }
        if (g.p == 0 && g.live) {
            a.phase_out[g.c0 + g.c] = phase;
            a.freq_out[g.c0 + g.c] = freq;
        }
    }
}

template <int TR>
__device__ __forceinline__ void slab_store(const FrontArgs& a, SlabTiles<TR>& s,
                                           const SlabGroup& g) {
    float* dst = (g.p ? a.yi : a.yr) + g.c0 + g.c;
    for (int i = 0; i < g.ntiles; ++i) {
        const int fs = i % NF, fturn = i / NF;
        mbar_wait(&s.y_full[fs], fturn & 1);
        const int s0 = i * TR;
        const int n = min(TR, a.T - s0);
        if (g.live) {
            const float* src = &s.f[fs][g.p][g.c];
            float* pd = dst + (size_t)s0 * a.C;
#pragma unroll 8
            for (int r = 0; r < n; ++r) pd[(size_t)r * a.C] = src[r * SCPB];
        }
        mbar_arrive(&s.f_free[fs]);
    }
}

template <int TR, bool SLAB_AGC, bool SLAB_COSTAS, bool BF16, int SK>
__global__ void __launch_bounds__(Layout<TR>::NWARPS * 32, 1)
frontend_slab_kernel(const FrontArgs a) {
    using L = Layout<TR>;
    using SL = SlabLayout<TR, SLAB_COSTAS>;
    constexpr int FIR_THREADS = L::FIR_THREADS;
    extern __shared__ __align__(16) unsigned char smem[];
    SlabTiles<TR>& s = *reinterpret_cast<SlabTiles<TR>*>(smem);
    float* ring = reinterpret_cast<float*>(smem + sizeof(SlabTiles<TR>));

    if (threadIdx.x == 0) {
        for (int k = 0; k < NX; ++k) {
            mbar_init(&s.x_full[k], 32);
            mbar_init(&s.m_full[k], 32 * SL::MAGS);
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

    SlabGroup g;
    g.lane = threadIdx.x & 31;
    g.c = g.lane % SCPB;
    g.p = g.lane / SCPB;
    g.c0 = blockIdx.x * SCPB;
    g.live = g.c0 + g.c < a.C;
    g.cc = g.live ? g.c0 + g.c : a.C - 1;
    g.ntiles = (a.T + TR - 1) / TR;
    const int role = threadIdx.x >> 5;
    const long long role_t0 = role_clock_start();
    const int mag = SL::mag(role);
    if (role == L::LOADER) slab_load(a, s, g);
    else if (mag >= 0) slab_mag<TR, SLAB_AGC, SK, SL::MAGS>(a, s, g, mag);
    else if (role == SL::AGC) slab_agc<TR, SLAB_AGC, SK>(a, s, g);
    else if (role == COSTAS) slab_costas<TR, SLAB_COSTAS, SK>(a, s, g);
    else if (role == L::STORE) slab_store(a, s, g);
    else if ((role & 3) != 3 && role < L::LOADER)
        slab_fir<TR, BF16, SLAB_AGC, SK>(a, s, ring, g, fir_index<TR>(role));
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

// loops.cuh's sincos_large_regs against the library's sinf and cosf at
// every float whose bits lie in [lo, hi) (the caller's range of large
// arguments): *mismatches (zeroed by the caller) receives the number whose
// sine or cosine differs in any bit.
__global__ void large_trig_check_kernel(unsigned int lo, unsigned int hi,
                                        unsigned long long* mismatches) {
    const unsigned int stride = gridDim.x * blockDim.x;
    unsigned long long bad = 0;
    for (unsigned int u = lo + blockIdx.x * blockDim.x + threadIdx.x; u < hi && u >= lo;
         u += stride) {
        const float x = __uint_as_float(u);
        float sn, cs;
        sincos_large_regs(x, sn, cs);
        bad += __float_as_uint(sn) != __float_as_uint(sinf(x))
            || __float_as_uint(cs) != __float_as_uint(cosf(x));
    }
    if (bad) atomicAdd(mismatches, bad);
}

extern "C" int xrit_large_trig_mismatches(unsigned int lo, unsigned int hi, void* mismatches,
                                          void* stream) {
    if (hi <= lo) return (int)cudaErrorInvalidValue;
    large_trig_check_kernel<<<4096, 256, 0, (cudaStream_t)stream>>>(
        lo, hi, (unsigned long long*)mismatches);
    return (int)cudaGetLastError();
}

extern "C" int xrit_trig_mismatches(float lo, float hi, long long n, void* mismatches,
                                    void* stream) {
    if (n < 2) return (int)cudaErrorInvalidValue;
    trig_check_kernel<<<1024, 256, 0, (cudaStream_t)stream>>>(
        lo, hi, n, (unsigned long long*)mismatches);
    return (int)cudaGetLastError();
}

template <bool BF16>
static int launch_frontend(FrontArgs a, void* stream) {
    constexpr int TR = EXACT_TR;
    a.win = 64;
    while (a.win < a.ntaps - 1 + 2 * TR) a.win *= 2;
    const size_t shared = sizeof(Tiles<TR>) + (size_t)2 * a.win * 32 * sizeof(float);
    const auto kernel = frontend_kernel<BF16>;
    int err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (err) return err;
    kernel<<<(a.C + 31) / 32, Layout<TR>::NWARPS * 32, shared,
             (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

template <int TR, bool SLAB_AGC, bool SLAB_COSTAS, bool BF16, int SK>
static int launch_slab_kernel(FrontArgs a, void* stream) {
    a.win = 64;
    while (a.win < a.ntaps - 1 + 2 * TR) a.win *= 2;
    const size_t shared = sizeof(SlabTiles<TR>)
        + (size_t)(BF16 ? 4 : 2) * (a.win * SCPB + 16) * sizeof(float);
    const auto kernel = frontend_slab_kernel<TR, SLAB_AGC, SLAB_COSTAS, BF16, SK>;
    int err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (err) return err;
    kernel<<<(a.C + SCPB - 1) / SCPB, Layout<TR>::NWARPS * 32, shared,
             (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

// The Costas walk spread over lanes for block_k 8 (the JAX package's on-chip
// K); any other K walks a lane a channel.
template <int TR, bool SLAB_AGC, bool SLAB_COSTAS, bool BF16>
static int launch_slab_form(const FrontArgs& a, void* stream) {
    if constexpr (SLAB_COSTAS && TR == 48)
        if (a.bk == 8) return launch_slab_kernel<TR, SLAB_AGC, SLAB_COSTAS, BF16, 8>(a, stream);
    return launch_slab_kernel<TR, SLAB_AGC, SLAB_COSTAS, BF16, 0>(a, stream);
}

// The slab forms of tile TR: stages 3 both loops, 1 the AGC, 2 the Costas.
template <int TR>
static int launch_slab(const FrontArgs& a, int stages, bool bf16, void* stream) {
    switch (stages * 2 + bf16) {
        case 6: return launch_slab_form<TR, true, true, false>(a, stream);
        case 7: return launch_slab_form<TR, true, true, true>(a, stream);
        case 2: return launch_slab_form<TR, true, false, false>(a, stream);
        case 3: return launch_slab_form<TR, true, false, true>(a, stream);
        case 4: return launch_slab_form<TR, false, true, false>(a, stream);
        case 5: return launch_slab_form<TR, false, true, true>(a, stream);
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
    return launch_frontend<false>(a, stream);
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
    if (bk == 0) return bf16 ? launch_frontend<true>(a, stream) : launch_frontend<false>(a, stream);
    if (48 % bk == 0) return launch_slab<48>(a, stages, bf16 != 0, stream);
    if (64 % bk == 0) return launch_slab<64>(a, stages, bf16 != 0, stream);
    return (int)cudaErrorInvalidValue;
}
