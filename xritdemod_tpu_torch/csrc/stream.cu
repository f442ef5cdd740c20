// Standalone AGC and Costas loops over a (C, T) block: the split front end's
// two feedback stages, each reading the block once and writing it once.
//
// Replaces the Pallas kernels _agc_kernel and _costas_kernel of
// xritdemod_tpu/ops/stream_pallas.py (entries agc_block_pallas and
// costas_block_pallas).  Those transpose to channels-last planes outside the
// kernel and back; here the kernel serves the (C, T) contract itself.
//
// What bounds them on an H100 is not bytes (the block once in, once out) but
// one channel's chain of T dependent steps, walked by one lane.  So, as in
// frontend.cu, everything that is not the recursion is taken off the warp
// that walks it and off that warp's scheduler.  One block serves CPB
// channels and walks the block in tiles of CPB channels x TS samples held in
// shared memory, NS tiles in flight, handed on between warps with one job
// each through mbarriers (sync.cuh):
//
//   loader  cp.async of the next tiles, one channel row at a time (lane =
//           sample: each row segment one coalesced 128-byte read); dead rows
//           (past channel C-1) shadow channel C-1;
//   mag     (AGC only) |x| of a whole tile, which needs no state; MAG_WARPS
//           warps take the tiles in turn;
//   chain   lane l walks row l: the AGC's gain recursion alone, reading the
//           magnitudes and leaving the gain each sample met, or the Costas
//           loop, rotating the samples in place; CHAIN samples in registers
//           at a time, shared addresses taken once before the loop;
//   store   finished tiles back to device memory as whole channel rows (the
//           AGC's store forms x * gain on the way); rows of dead channels and
//           samples past T are never stored.
//
// Rows are padded to TS + 1 floats: lane l, column u lies in bank (l + u) mod
// 32, so neither the row-wise copies nor the chain's column walk conflict.
// The chain warp has its scheduler (warp index mod 4) to itself: see `enum
// Role`.  The per-sample arithmetic is loops.cuh's, shared with frontend.cu,
// built without FMA contraction and without fast-math, so the AGC split into
// magnitude, gain chain and product rounds as ops/agc.agc_block does, and the
// Costas step as ops/costas.costas_block.
//
// The Costas kernel has a second form, the slab update of the Pallas fused
// kernel's block_k (ops/costas.costas_block_update): K samples rotated on the
// slab's frozen ramp (loops.cuh, the same device functions as frontend.cu's),
// independent of each other, and the loop updated once a slab.  For K 4, 8
// and 16 (costas_spread_kernel) a slab's rotations are spread over SLAB_LPC
// lanes a channel, four chain warps at K = 8: the walk's issue, which one
// lane a channel spends on K rotations a slab, is spread, and what stays on
// the chain is one rotation, a gather, the sums, the update and the wraps.
// Any other K walks a lane a channel (CostasSlabOp), slabs running on across
// tiles, from the block's first sample.
#include <cuda_runtime.h>
#include <stdint.h>

#include "loops.cuh"     // agc_mag, agc_gain_step, costas_step
#include "sync.cuh"      // mbarriers, cp.async, lds_f32 / sts_f32

// The sizes below were chosen on an H100 (80GB HBM3, 700 W) at C = 2048, T =
// 131072 with tools/kernel_probe.py, which times one-change variants; PERF.md
// has the figures.  Channels per block: 16 spreads the channels over 128 SMs,
// and the AGC then takes 40-50 % less time than with 32 (64 SMs cannot pull
// its bytes at the chain's pace); the Costas loop is its chain's either way.
// Tiles of 128 samples, six in flight, keep enough loads under way that the
// AGC's chain does not wait on them.  The AGC's magnitudes (an accurate
// sqrtf each) need more than one warp to keep up with its short chain.
#define CPB 16
#define TS 128           // samples per tile, a multiple of 32
#define ROW (TS + 1)     // padded row in shared memory, floats
#define NS 6             // tiles in flight
#define CHAIN 4          // samples a chain warp holds in registers at a time
#define MAG_WARPS 3      // the AGC's magnitude warps

static_assert(TS % 32 == 0 && TS % CHAIN == 0, "tile");
static_assert(32 % CPB == 0, "a chain warp's lanes cover whole rows");

// A warp's scheduler is its index mod 4, and a scheduler is greedy: a warp
// with independent work ready holds back a warp that waits on its own last
// result.  So the chain warp is warp 3, alone on scheduler 3; the loader,
// store and magnitude warps take the other three (magnitude warps beyond the
// first are warps 4, 5, 6).  The Costas kernel has no magnitude warp: its
// warp 1 leaves at once.
enum Role { LOADER, MAG, STORE, CHAIN_WARP };
static_assert(MAG_WARPS >= 1 && CHAIN_WARP + MAG_WARPS <= 7, "magnitude warps off scheduler 3");

constexpr int PLANE = CPB * ROW * 4;   // bytes from one plane of a tile to the next

struct Args {
    const float *xr, *xi;              // (C, T) block
    float *yr, *yi;                    // (C, T) output
    int C, T;
};

// A tile stage holds NP planes: re and im, and for the AGC the magnitudes,
// which the gain chain replaces by the gain each sample met.
template <int NP, int PITCH = ROW>
struct Shared {
    float t[NS][NP][CPB][PITCH];
    uint64_t x_full[NS], m_full[NS], c_full[NS], free_[NS];
};

struct Group {                         // what every role knows of its block
    int lane, c0, row, cc, ntiles;
    bool live;                         // owns a channel: lane < CPB and c0 + lane < C
};

// N consecutive floats from / to shared address a + OFFSET.
template <int OFFSET, int N>
__device__ __forceinline__ void lds_row(uint32_t a, float* v) {
    v[0] = lds_f32<OFFSET>(a);
    if constexpr (N > 1) lds_row<OFFSET + 4, N - 1>(a, v + 1);
}

template <int OFFSET, int N>
__device__ __forceinline__ void sts_row(uint32_t a, const float* v) {
    sts_f32<OFFSET>(a, v[0]);
    if constexpr (N > 1) sts_row<OFFSET + 4, N - 1>(a, v + 1);
}

// K5's chain: the gain recursion over one row of the magnitude plane at a,
// n samples, each magnitude replaced by the gain its sample met.  The next
// batch's magnitudes are read before this batch's steps, so the chain does
// not wait on shared memory.  CLAMP: max_gain > 0, decided once per launch;
// told so, the compiler drops agc_gain_step's test of it from the loop
// (else it splits every batch of the chain by a branch).
template <bool CLAMP>
struct AgcOp {
    static constexpr int NP = 3, CHAIN_PLANE = 2, MAGS = MAG_WARPS;
    static constexpr int WARPS = MAG_WARPS > 1 ? CHAIN_WARP + MAG_WARPS : CHAIN_WARP + 1;
    const float* gain_in;
    float* gain_out;
    float rate, reference, max_gain;
    float g;
    __device__ void load(int c) { g = gain_in[c]; }
    __device__ void save(int c) { gain_out[c] = g; }
    __device__ __forceinline__ void walk(uint32_t a, int n) {
        if constexpr (CLAMP) __builtin_assume(max_gain > 0.0f);
        const float most = CLAMP ? max_gain : 0.0f;
        int u = 0;
        float m[CHAIN];
        lds_row<0, CHAIN>(a, m);
#pragma unroll 1
        for (; u + CHAIN <= n; u += CHAIN, a += 4 * CHAIN) {
            float next[CHAIN];
            lds_row<0, CHAIN>(u + 2 * CHAIN <= n ? a + 4 * CHAIN : a, next);
#pragma unroll
            for (int k = 0; k < CHAIN; ++k) {
                const float met = g;
                agc_gain_step(m[k], g, rate, reference, most);
                m[k] = met;
            }
            sts_row<0, CHAIN>(a, m);
#pragma unroll
            for (int k = 0; k < CHAIN; ++k) m[k] = next[k];
        }
#pragma unroll 1
        for (; u < n; ++u, a += 4) {
            const float mag = lds_f32<0>(a);
            sts_f32<0>(a, g);
            agc_gain_step(mag, g, rate, reference, most);
        }
    }
};

// K6's chain: the Costas loop over one row at a (re plane; im one PLANE
// further), n samples rotated in place.
struct CostasOp {
    static constexpr int NP = 2, CHAIN_PLANE = 0, MAGS = 0, WARPS = CHAIN_WARP + 1;
    const float *phase_in, *freq_in;
    float *phase_out, *freq_out;
    float alpha, beta, freq_min, freq_max;
    float phase, freq;
    __device__ void load(int c) { phase = phase_in[c]; freq = freq_in[c]; }
    __device__ void save(int c) { phase_out[c] = phase; freq_out[c] = freq; }
    __device__ __forceinline__ void walk(uint32_t a, int n) {
        int u = 0;
#pragma unroll 1
        for (; u + CHAIN <= n; u += CHAIN, a += 4 * CHAIN) {
            float vr[CHAIN], vi[CHAIN];
            lds_row<0, CHAIN>(a, vr);
            lds_row<PLANE, CHAIN>(a, vi);
#pragma unroll
            for (int k = 0; k < CHAIN; ++k) {
                float orr, oi;
                costas_step(vr[k], vi[k], phase, freq, alpha, beta, freq_min, freq_max, orr, oi);
                vr[k] = orr; vi[k] = oi;
            }
            sts_row<0, CHAIN>(a, vr);
            sts_row<PLANE, CHAIN>(a, vi);
        }
#pragma unroll 1
        for (; u < n; ++u, a += 4) {
            float orr, oi;
            costas_step(lds_f32<0>(a), lds_f32<PLANE>(a), phase, freq, alpha, beta,
                        freq_min, freq_max, orr, oi);
            sts_f32<0>(a, orr);
            sts_f32<PLANE>(a, oi);
        }
    }
};

// K6's slab form: the same walk, a slab of K samples at a time; a slab may
// run on into the next tile.
struct CostasSlabOp {
    static constexpr int NP = 2, CHAIN_PLANE = 0, MAGS = 0, WARPS = CHAIN_WARP + 1;
    const float *phase_in, *freq_in;
    float *phase_out, *freq_out;
    float alpha, beta, freq_min, freq_max;
    int K, nwrap;
    CostasSlab st;
    __device__ void load(int c) { st = CostasSlab{phase_in[c], freq_in[c], 0.0f, 0.0f, 0}; }
    __device__ void save(int c) { phase_out[c] = st.phase; freq_out[c] = st.freq; }
    __device__ __forceinline__ void walk(uint32_t a, int n) {
        int u = 0;
        while (u < n) {
            const int m = min(K - st.k, n - u);
            float s = st.s, r = st.r;
            int j = 0;
#pragma unroll 1
            for (; j + SLAB_BATCH <= m; j += SLAB_BATCH) {
                const uint32_t at = a + 4 * (u + j);
                float vr[SLAB_BATCH], vi[SLAB_BATCH];
                lds_row<0, SLAB_BATCH>(at, vr);
                lds_row<PLANE, SLAB_BATCH>(at, vi);
                costas_slab_batch(vr, vi, st, st.k + j, K, s, r);
                sts_row<0, SLAB_BATCH>(at, vr);
                sts_row<PLANE, SLAB_BATCH>(at, vi);
            }
#pragma unroll 1
            for (; j < m; ++j) {
                const uint32_t at = a + 4 * (u + j);
                float orr, oi;
                costas_slab_rotate(lds_f32<0>(at), lds_f32<PLANE>(at), st, st.k + j, K, s, r,
                                   orr, oi);
                sts_f32<0>(at, orr);
                sts_f32<PLANE>(at, oi);
            }
            st.s = s;
            st.r = r;
            st.k += m;
            u += m;
            if (st.k == K) costas_slab_update(st, K, alpha, beta, freq_min, freq_max, nwrap);
        }
    }
};

template <int NP, int PITCH>
__device__ __forceinline__ void load_tiles(const Args& a, Shared<NP, PITCH>& s, const Group& g) {
    for (int i = 0; i < g.ntiles; ++i) {
        const int st = i % NS;
        mbar_wait(&s.free_[st], ((i / NS) & 1) ^ 1);
        const int t0 = i * TS;
        const int n = min(TS, a.T - t0);
#pragma unroll 4
        for (int r = 0; r < CPB; ++r) {
            const size_t o = (size_t)min(g.c0 + r, a.C - 1) * a.T + t0;
#pragma unroll
            for (int k = 0; k < TS / 32; ++k) {
                const int c = k * 32 + g.lane;
                if (c < n) {
                    cp_async_f32(&s.t[st][0][r][c], a.xr + o + c);
                    cp_async_f32(&s.t[st][1][r][c], a.xi + o + c);
                }
            }
        }
        mbar_arrive_on_copies(&s.x_full[st]);
    }
    cp_async_wait_all();
}

// Magnitude warp w of MAG_WARPS: tiles w, w + MAG_WARPS, ...  Columns past
// the block's end hold stale values; nothing reads what comes of them.
__device__ __forceinline__ void magnitudes(Shared<3>& s, const Group& g, int w) {
    for (int i = w; i < g.ntiles; i += MAG_WARPS) {
        const int st = i % NS;
        mbar_wait(&s.x_full[st], (i / NS) & 1);
#pragma unroll 4
        for (int r = 0; r < CPB; ++r) {
#pragma unroll
            for (int k = 0; k < TS / 32; ++k) {
                const int c = k * 32 + g.lane;
                s.t[st][2][r][c] = agc_mag(s.t[st][0][r][c], s.t[st][1][r][c]);
            }
        }
        mbar_arrive(&s.m_full[st]);
    }
}

template <class Op>
__device__ __forceinline__ void walk_chain(const Args& a, Op& op, Shared<Op::NP>& s,
                                           const Group& g) {
    op.load(g.cc);
    const uint32_t row0 = smem_addr(&s.t[0][Op::CHAIN_PLANE][g.row][0]);
    constexpr uint32_t STAGE = Op::NP * PLANE;
    for (int i = 0; i < g.ntiles; ++i) {
        const int st = i % NS;
        mbar_wait(Op::MAGS ? &s.m_full[st] : &s.x_full[st], (i / NS) & 1);
        op.walk(row0 + st * STAGE, min(TS, a.T - i * TS));
        mbar_arrive(&s.c_full[st]);
    }
    if (g.live) op.save(g.c0 + g.lane);
}

template <int NP, int PITCH>
__device__ __forceinline__ void store_tiles(const Args& a, Shared<NP, PITCH>& s, const Group& g) {
    const int rows = min(CPB, a.C - g.c0);
    for (int i = 0; i < g.ntiles; ++i) {
        const int st = i % NS;
        mbar_wait(&s.c_full[st], (i / NS) & 1);
        const int t0 = i * TS;
        const int n = min(TS, a.T - t0);
        const size_t o0 = (size_t)g.c0 * a.T + t0;
#pragma unroll 4
        for (int r = 0; r < rows; ++r) {
            const size_t o = o0 + (size_t)r * a.T;
#pragma unroll
            for (int k = 0; k < TS / 32; ++k) {
                const int c = k * 32 + g.lane;
                if (c < n) {
                    float vr = s.t[st][0][r][c], vi = s.t[st][1][r][c];
                    if constexpr (NP == 3) {
                        const float gain = s.t[st][2][r][c];
                        vr = vr * gain;
                        vi = vi * gain;
                    }
                    a.yr[o + c] = vr;
                    a.yi[o + c] = vi;
                }
            }
        }
        mbar_arrive(&s.free_[st]);
    }
}

template <class Op>
__global__ void __launch_bounds__(Op::WARPS * 32, 1) stream_kernel(const Args a, Op op) {
    extern __shared__ __align__(16) unsigned char smem[];
    Shared<Op::NP>& s = *reinterpret_cast<Shared<Op::NP>*>(smem);
    if (threadIdx.x == 0) {
        for (int k = 0; k < NS; ++k) {
            mbar_init(&s.x_full[k], 32);
            mbar_init(&s.m_full[k], 32);
            mbar_init(&s.c_full[k], 32);
            mbar_init(&s.free_[k], 32);
        }
        mbar_init_fence();
    }
    __syncthreads();       // the last block-wide barrier: roles part here

    Group g;
    g.lane = threadIdx.x & 31;
    g.c0 = blockIdx.x * CPB;
    g.row = g.lane % CPB;  // with CPB < 32, lanes past CPB walk a copy of a row
    g.live = g.lane < CPB && g.c0 + g.lane < a.C;
    g.cc = min(g.c0 + g.row, a.C - 1);      // dead rows shadow channel C-1
    g.ntiles = (a.T + TS - 1) / TS;
    const int role = threadIdx.x >> 5;
    const long long role_t0 = role_clock_start();
    if (role == LOADER) load_tiles(a, s, g);
    else if (role == STORE) store_tiles(a, s, g);
    else if (role == CHAIN_WARP) walk_chain(a, op, s, g);
    else if constexpr (Op::MAGS > 0) magnitudes(s, g, role == MAG ? 0 : role - CHAIN_WARP);
    role_clock_stop(role_t0);
}

template <class Op>
static int launch(const Args& a, const Op& op, void* stream) {
    const int shared = (int)sizeof(Shared<Op::NP>);
    int err = (int)cudaFuncSetAttribute(
        stream_kernel<Op>, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
    if (err) return err;
    stream_kernel<Op><<<(a.C + CPB - 1) / CPB, Op::WARPS * 32, shared, (cudaStream_t)stream>>>(
        a, op);
    return (int)cudaGetLastError();
}

// K6's slab form for K dividing TS (SpreadLayout): the walk of loops.cuh's
// costas_slab_spread, SLAB_LPC lanes a channel.  A tile then holds whole
// slabs (T and TS are multiples of K, slabs start at the block's first
// sample), so a group of lanes walks its row slab by slab, the next slab's
// samples read before this one's rotations.  With SLAB_LPC lanes, the CPB
// channels take CPB * SLAB_LPC / 32 chain warps (at least one), which sit
// one to a scheduler: warp 3 alone, then warp 1 (scheduler 1, free in the
// Costas kernels), then warps 4 and 6 beside the loader and the store warp.
// Rows are padded to TS + SLAB_LPC floats, so the L lanes of a channel and
// the channels of a warp read 32 different banks.
#define SLAB_LPC 8       // lanes a channel in the spread slab walk

template <int L>
struct SpreadLayout {
    static constexpr int CHAINS = CPB * L / 32 > 1 ? CPB * L / 32 : 1;
    static constexpr int WARPS = CHAINS <= 2 ? 4 : 7;
    static constexpr int PITCH = TS + L;
    static_assert(CHAINS == 1 || CHAINS == 2 || CHAINS == 4, "one chain warp a scheduler");
    // The chain index of warp w, or -1.
    static __device__ __forceinline__ int chain(int w) {
        return w == 3 ? 0 : CHAINS > 1 && w == 1 ? 1 : CHAINS > 2 && w == 4 ? 2
             : CHAINS > 2 && w == 6 ? 3 : -1;
    }
};

template <int K, int L>
__device__ __forceinline__ void spread_chain(const Args& a, const CostasSlabOp& op,
                                             Shared<2, TS + L>& s, int n_chain, int c0,
                                             int ntiles) {
    constexpr int N = K / L;
    constexpr int PL = CPB * (TS + L) * 4;             // bytes from the re plane to the im
    const int t = n_chain * 32 + (threadIdx.x & 31);
    const int row = t / L, j = t % L;
    const bool on = row < CPB;                         // L = 1: lanes past CPB idle
    const int cc = min(c0 + row, a.C - 1);
    float phase = 0.0f, freq = 0.0f, kf[N];
    if (on) {
        phase = op.phase_in[cc];
        freq = op.freq_in[cc];
    }
#pragma unroll
    for (int i = 0; i < N; ++i) kf[i] = (float)(j + L * i);
    const uint32_t row0 = smem_addr(&s.t[0][0][on ? row : 0][j]);
    constexpr uint32_t STAGE = 2 * PL;
    for (int i = 0; i < ntiles; ++i) {
        const int st = i % NS;
        mbar_wait(&s.x_full[st], (i / NS) & 1);
        const int n = min(TS, a.T - i * TS);           // a multiple of K
        if (on) {
            uint32_t at = row0 + st * STAGE;
            float vr[N], vi[N], nr[N], ni[N];
#pragma unroll
            for (int q = 0; q < N; ++q) {
                vr[q] = lds_f32<0>(at + 4 * L * q);
                vi[q] = lds_f32<PL>(at + 4 * L * q);
            }
#pragma unroll 1
            for (int u = 0; u < n; u += K, at += 4 * K) {
                const uint32_t next = u + K < n ? at + 4 * K : at;
#pragma unroll
                for (int q = 0; q < N; ++q) {
                    nr[q] = lds_f32<0>(next + 4 * L * q);
                    ni[q] = lds_f32<PL>(next + 4 * L * q);
                }
                costas_slab_spread<K, L>(vr, vi, kf, phase, freq, op.alpha, op.beta,
                                         op.freq_min, op.freq_max, op.nwrap);
#pragma unroll
                for (int q = 0; q < N; ++q) {
                    sts_f32<0>(at + 4 * L * q, vr[q]);
                    sts_f32<PL>(at + 4 * L * q, vi[q]);
                    vr[q] = nr[q];
                    vi[q] = ni[q];
                }
            }
        }
        mbar_arrive(&s.c_full[st]);
    }
    if (on && j == 0 && c0 + row < a.C) {
        op.phase_out[c0 + row] = phase;
        op.freq_out[c0 + row] = freq;
    }
}

template <int K, int L>
__global__ void __launch_bounds__(SpreadLayout<L>::WARPS * 32, 1)
costas_spread_kernel(const Args a, const CostasSlabOp op) {
    using SL = SpreadLayout<L>;
    extern __shared__ __align__(16) unsigned char smem[];
    Shared<2, SL::PITCH>& s = *reinterpret_cast<Shared<2, SL::PITCH>*>(smem);
    if (threadIdx.x == 0) {
        for (int k = 0; k < NS; ++k) {
            mbar_init(&s.x_full[k], 32);
            mbar_init(&s.c_full[k], 32 * SL::CHAINS);
            mbar_init(&s.free_[k], 32);
        }
        mbar_init_fence();
    }
    __syncthreads();       // the last block-wide barrier: roles part here

    Group g;
    g.lane = threadIdx.x & 31;
    g.c0 = blockIdx.x * CPB;
    g.row = g.lane % CPB;
    g.live = g.lane < CPB && g.c0 + g.lane < a.C;
    g.cc = min(g.c0 + g.row, a.C - 1);
    g.ntiles = (a.T + TS - 1) / TS;
    const int role = threadIdx.x >> 5;
    const long long role_t0 = role_clock_start();
    const int chain = SL::chain(role);
    if (role == LOADER) load_tiles(a, s, g);
    else if (role == STORE) store_tiles(a, s, g);
    else if (chain >= 0) spread_chain<K, L>(a, op, s, chain, g.c0, g.ntiles);
    role_clock_stop(role_t0);
}

template <int K>
static int launch_spread(const Args& a, const CostasSlabOp& op, void* stream) {
    constexpr int L = K < SLAB_LPC ? K : SLAB_LPC;
    using SL = SpreadLayout<L>;
    const int shared = (int)sizeof(Shared<2, SL::PITCH>);
    int err = (int)cudaFuncSetAttribute(
        costas_spread_kernel<K, L>, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
    if (err) return err;
    costas_spread_kernel<K, L><<<(a.C + CPB - 1) / CPB, SL::WARPS * 32, shared,
                                 (cudaStream_t)stream>>>(a, op);
    return (int)cudaGetLastError();
}

template <bool CLAMP>
static int launch_agc(const Args& a, const void* gain_in, void* gain_out,
                      float rate, float reference, float max_gain, void* stream) {
    AgcOp<CLAMP> op;
    op.gain_in = (const float*)gain_in;
    op.gain_out = (float*)gain_out;
    op.rate = rate; op.reference = reference; op.max_gain = max_gain;
    op.g = 0.0f;
    return launch(a, op, stream);
}

// x, y (C, T) planes; state vectors (C,).  One launch each.
extern "C" int xrit_agc_block(
    const void* xr, const void* xi, void* yr, void* yi,
    const void* gain_in, void* gain_out, int C, int T,
    float rate, float reference, float max_gain, void* stream) {
    if (C < 1 || T < 1) return (int)cudaErrorInvalidValue;
    const Args a{(const float*)xr, (const float*)xi, (float*)yr, (float*)yi, C, T};
    return max_gain > 0.0f
        ? launch_agc<true>(a, gain_in, gain_out, rate, reference, max_gain, stream)
        : launch_agc<false>(a, gain_in, gain_out, rate, reference, max_gain, stream);
}

extern "C" int xrit_costas_block(
    const void* xr, const void* xi, void* yr, void* yi,
    const void* phase_in, const void* freq_in, void* phase_out, void* freq_out,
    int C, int T, float alpha, float beta, float freq_min, float freq_max,
    void* stream) {
    if (C < 1 || T < 1) return (int)cudaErrorInvalidValue;
    const Args a{(const float*)xr, (const float*)xi, (float*)yr, (float*)yi, C, T};
    CostasOp op;
    op.phase_in = (const float*)phase_in; op.freq_in = (const float*)freq_in;
    op.phase_out = (float*)phase_out; op.freq_out = (float*)freq_out;
    op.alpha = alpha; op.beta = beta; op.freq_min = freq_min; op.freq_max = freq_max;
    op.phase = 0.0f; op.freq = 0.0f;
    return launch(a, op, stream);
}

// The slab form: T a multiple of K; nwrap the wrap steps a slab.
extern "C" int xrit_costas_slab(
    const void* xr, const void* xi, void* yr, void* yi,
    const void* phase_in, const void* freq_in, void* phase_out, void* freq_out,
    int C, int T, float alpha, float beta, float freq_min, float freq_max,
    int K, int nwrap, void* stream) {
    if (C < 1 || T < 1 || K < 1 || T % K || nwrap < 1) return (int)cudaErrorInvalidValue;
    const Args a{(const float*)xr, (const float*)xi, (float*)yr, (float*)yi, C, T};
    CostasSlabOp op;
    op.phase_in = (const float*)phase_in; op.freq_in = (const float*)freq_in;
    op.phase_out = (float*)phase_out; op.freq_out = (float*)freq_out;
    op.alpha = alpha; op.beta = beta; op.freq_min = freq_min; op.freq_max = freq_max;
    op.K = K; op.nwrap = nwrap;
    op.st = CostasSlab{0.0f, 0.0f, 0.0f, 0.0f, 0};
    switch (K) {
        case 4: return launch_spread<4>(a, op, stream);
        case 8: return launch_spread<8>(a, op, stream);
        case 16: return launch_spread<16>(a, op, stream);
    }
    return launch(a, op, stream);
}
