// CCSDS rate-1/2 K=7 Viterbi decoder: forward add-compare-select and
// traceback in one kernel, LPW lanes per window.
//
// Replaces the Pallas kernels _fwd_kernel / _fwd_kernel_reg / _back_kernel of
// xritdemod_tpu/ops/viterbi_pallas.py.  What bounds it on an H100 is the
// instruction rate: 64 add-compare-selects a step per window (5 instructions
// each) along a chain of T dependent steps, against 8 B of soft symbols in
// and 8 B of decisions out and back.  So the layout spends few instructions per
// window-step while still giving the schedulers warps enough:
//
//   - `viterbi_kernel<LPW>`: the LPW lanes of one window hold 64 / LPW
//     states' metrics each, in registers, every state index a compile-time
//     constant (no local memory; the TPU kernel's unrolled state axis, on a
//     few lanes).  The lanes swap predecessor metrics once a step through a
//     per-window slot of shared memory (16-byte accesses, the chunks of a
//     slot swizzled so a quarter-warp's accesses meet no bank twice).  The
//     wrapper picks LPW from the window count
//     (ops/viterbi_cuda.py::lanes_per_window): few lanes per window where
//     windows are many, a warp per window where they are few and a step's
//     latency is what counts.
//   - Branch metrics once a step: only a*g1 + b*g2 for g in {+-1}^2 occur.
//   - Soft symbols reach shared memory by cp.async, CH steps of every window
//     of the warp at a time, one chunk ahead of the steps that read them.
//   - Decisions are one 64-bit word per step and window, time-major
//     (T, NW), so a warp's stores and the traceback's loads are contiguous.
//     Bit n is state n's decision, except at LPW = 32, where two ballots
//     give even states in the low word and odd states in the high one.
//   - Traceback: the decision words of TB steps come into shared memory
//     ahead (their addresses depend on t only), one lane per window walks
//     them from registers, and the warp writes the bits out a row of TB
//     bytes at a time.
//
// Float order equals ops/viterbi.py bit for bit: branch metric a*g1 + b*g2
// with g = +-1 (compiled without FMA contraction; the products are exact, so
// the one rounded add is the plain version's), candidate = metric + branch,
// strict c1 > c0 so ties keep predecessor n>>1, no renormalisation,
// first-index argmax for the end state.
#include <cuda_runtime.h>
#include <stdint.h>

#define POLY_A 0x4F
#define POLY_B 0x6D
#define CH 32               // steps of soft symbols staged per chunk
#define TB 32               // steps of decisions staged per traceback chunk

__host__ __device__ constexpr int parity7(int x) {
    return (x ^ (x >> 1) ^ (x >> 2) ^ (x >> 3) ^ (x >> 4) ^ (x >> 5) ^ (x >> 6)) & 1;
}

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

// Bytes of shared memory of a block (one warp): soft symbols
// [2][WPW][CH+1] float2 during the forward pass, decisions [2][TB][WPW] u64
// during the traceback (the same bytes); the metric exchange [2][WPW][64]
// float; the bits of one traceback chunk [WPW][TB+4].  Rows are padded
// against bank conflicts.
template <int LPW>
struct Smem {
    static constexpr int WPW = 32 / LPW;
    static constexpr int SOFT = 2 * WPW * (CH + 1) * 8;
    static constexpr int DEC = 2 * TB * WPW * 8;
    static constexpr int STAGE = round16(SOFT > DEC ? SOFT : DEC);
    static constexpr int XCH = 2 * WPW * 64 * 4;
    static constexpr int BITROW = TB + 4;
    static constexpr int BITS = round16(WPW * BITROW);
    static constexpr int BYTES = STAGE + XCH + BITS;
};

__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool ok) {
    // Zero-fills the 8 bytes when !ok.
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;"
                 :: "r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src),
                    "r"(ok ? 8 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory"); }

// Soft symbols of steps [t0, t0 + CH) of the warp's windows -> dst[q][j].
template <int WPW>
__device__ __forceinline__ void load_soft(float2* dst, const float2* soft, int w0, int NW,
                                          int T, int t0, int lane) {
#pragma unroll
    for (int idx = lane; idx < WPW * CH; idx += 32) {
        int q = idx / CH, j = idx % CH, w = w0 + q, t = t0 + j;
        bool ok = w < NW && t < T;
        cp_async8(dst + q * (CH + 1) + j, ok ? soft + (size_t)w * T + t : soft, ok);
    }
}

// Decision words of steps [t0, t0 + TB) of the warp's windows -> dst[j][q].
template <int WPW>
__device__ __forceinline__ void load_dec(uint64_t* dst, const uint64_t* dec, int w0, int NW,
                                         int T, int t0, int lane) {
#pragma unroll
    for (int idx = lane; idx < WPW * TB; idx += 32) {
        int j = idx / WPW, q = idx % WPW, w = w0 + q, t = t0 + j;
        bool ok = w < NW && t < T;
        cp_async8(dst + idx, ok ? dec + (size_t)t * NW + w : dec, ok);
    }
}

// Where state s's decision sits in its step's word.
template <int LPW>
__device__ __forceinline__ int dpos(int s) {
    return LPW == 32 ? ((s & 1) << 5) | (s >> 1) : s;
}

// One step of the lane's SPL states: new state n = k*SPL + i takes old state
// n>>1 (lo[i>>1]) or n>>1 + 32 (hi[i>>1]).  u[x][y] = a*s(x^ka) + b*s(y^kb)
// where s(1) = +1, s(0) = -1 and ka, kb are the lane's share of the
// generator parities; state n's own parities add those of i.
//
// The survivor is fmaxf(c0, c1) and the decision the sign of c0 - c1, which
// for finite metrics is c1 > c0 (c0 - c1 is -0 only if c0 is -0, and no
// metric is: they start at +0 and x + y is -0 only for -0 + -0); where
// c0 == c1 both candidates have the same bits.  The sign bits shift into
// the decision word, state i at bit i.
template <int SPL>
__device__ __forceinline__ void acs(const float* lo, const float* hi, float* nm,
                                    uint32_t& dw, float u00, float u01, float u10, float u11) {
#pragma unroll
    for (int i = SPL - 1; i >= 0; --i) {
        const int pa = parity7(i & POLY_A), pb = parity7(i & POLY_B);
        // Predecessor n>>1 shifts in through the register with bit 6 clear,
        // n>>1 + 32 with it set; both generators tap bit 6, so the second
        // candidate's signs are the first's negated.
        float b0 = pa ? (pb ? u11 : u10) : (pb ? u01 : u00);
        float b1 = pa ? (pb ? u00 : u01) : (pb ? u10 : u11);
        float c0 = lo[i >> 1] + b0;
        float c1 = hi[i >> 1] + b1;
        nm[i] = fmaxf(c0, c1);
        dw = __funnelshift_l(__float_as_uint(c0 - c1), dw, 1);
    }
}

// One traceback step: write state's input bit, return its predecessor.
template <int LPW>
__device__ __forceinline__ int walk(uint2 d, int state, uint8_t* bit) {
    *bit = (uint8_t)(state & 1);
    const int p = dpos<LPW>(state);
    const uint32_t half = (p & 32) ? d.y : d.x;
    return (state >> 1) | (int)((half >> (p & 31)) & 1u) << 5;
}

template <int LPW>
__global__ void __launch_bounds__(32) viterbi_kernel(
        const float2* __restrict__ soft, uint64_t* __restrict__ dec,
        uint8_t* __restrict__ bits, int NW, int T) {
    constexpr int SPL = 64 / LPW, WPW = 32 / LPW;
    static_assert(SPL >= 2 && SPL <= 16, "a lane's decisions fill at most 16 bits");
    constexpr unsigned FULL = 0xffffffffu;
    using S = Smem<LPW>;
    __shared__ __align__(16) unsigned char smem[S::BYTES];
    const int lane = threadIdx.x;
    const int w0 = blockIdx.x * WPW;
    const int q = lane / LPW, k = lane % LPW, w = w0 + q;
    const bool live = w < NW;                   // lanes past NW run on zeros
    float2* stage = reinterpret_cast<float2*>(smem);
    float* xch = reinterpret_cast<float*>(smem + S::STAGE);
    uint8_t* bsm = smem + S::STAGE + S::XCH;

    // The lane's share of the generator parities, as the sign of a and b.
    const float sa = parity7((k * SPL) & POLY_A) ? 1.0f : -1.0f;
    const float sb = parity7((k * SPL) & POLY_B) ? 1.0f : -1.0f;
    float m[SPL];
#pragma unroll
    for (int i = 0; i < SPL; ++i) m[i] = 0.0f;

    const int nch = (T + CH - 1) / CH;
    load_soft<WPW>(stage, soft, w0, NW, T, 0, lane);
    cp_commit();
    int tog = 0;
    for (int c = 0; c < nch; ++c) {
        if (c + 1 < nch)
            load_soft<WPW>(stage + ((c + 1) & 1) * WPW * (CH + 1), soft, w0, NW, T,
                           (c + 1) * CH, lane);
        cp_commit();
        cp_wait<1>();
        __syncwarp();
        const float2* xs = stage + (c & 1) * WPW * (CH + 1) + q * (CH + 1);
        const int t0 = c * CH, steps = min(CH, T - t0);
        uint32_t ke = 0, ko = 0;                // LPW == 32: this lane's step's ballots
        // This lane's share of the step's decision word, one word-row a step.
        unsigned char* dp = reinterpret_cast<unsigned char*>(dec + (size_t)t0 * NW + w)
                            + k * (SPL / 8);
        const size_t row = (size_t)NW * 8;
#pragma unroll(LPW >= 8 ? 4 : 1)
        for (int j = 0; j < steps; ++j) {
            const float2 x = xs[j];
            const float A = x.x * sa, B = x.y * sb;   // exact: sa, sb are +-1
            const float u00 = A + B, u01 = A + (-B), u10 = (-A) + B, u11 = (-A) + (-B);
            float nm[SPL], lo[SPL / 2], hi[SPL / 2];
            uint32_t dw = 0;
            float* xb = xch + tog * WPW * 64 + q * 64;
            tog ^= 1;
            if constexpr (SPL >= 8) {
                // 16-byte chunk c of the slot (states 4c..4c+3) sits at
                // chunk c ^ (q & 3) ^ 7*(c >> 3).
                const int sw = q & 3;
#pragma unroll
                for (int r = 0; r < SPL / 4; ++r) {
                    const int c = k * (SPL / 4) + r;
                    *reinterpret_cast<float4*>(xb + 4 * (c ^ sw ^ ((c >> 3) * 7))) =
                        make_float4(m[4 * r], m[4 * r + 1], m[4 * r + 2], m[4 * r + 3]);
                }
                __syncwarp();
#pragma unroll
                for (int r = 0; r < SPL / 8; ++r) {
                    const int c = k * (SPL / 8) + r;
                    float4 l = *reinterpret_cast<const float4*>(xb + 4 * (c ^ sw));
                    float4 h = *reinterpret_cast<const float4*>(xb + 4 * ((c + 8) ^ sw ^ 7));
                    lo[4 * r] = l.x; lo[4 * r + 1] = l.y; lo[4 * r + 2] = l.z; lo[4 * r + 3] = l.w;
                    hi[4 * r] = h.x; hi[4 * r + 1] = h.y; hi[4 * r + 2] = h.z; hi[4 * r + 3] = h.w;
                }
            } else {
                *reinterpret_cast<float2*>(xb + k * SPL) = make_float2(m[0], m[1]);
                __syncwarp();
                lo[0] = xb[k];
                hi[0] = xb[32 + k];
            }
            acs<SPL>(lo, hi, nm, dw, u00, u01, u10, u11);
#pragma unroll
            for (int i = 0; i < SPL; ++i) m[i] = nm[i];

            if constexpr (LPW == 32) {
                uint32_t e = __ballot_sync(FULL, dw & 1u);
                uint32_t o = __ballot_sync(FULL, dw & 2u);
                if (lane == j) { ke = e; ko = o; }
            } else {
                if (live) {
                    if constexpr (SPL == 16)
                        *reinterpret_cast<uint16_t*>(dp) = (uint16_t)dw;
                    else
                        *dp = (uint8_t)dw;
                }
                dp += row;
            }
        }
        if constexpr (LPW == 32) {
            if (lane < steps)
                dec[(size_t)(t0 + lane) * NW + w] = ke | (uint64_t)ko << 32;
        }
        __syncwarp();                           // before chunk c + 2 lands here
    }

    // End state: first index of the largest metric.
    float bv = m[0];
    int bi = k * SPL;
#pragma unroll
    for (int i = 1; i < SPL; ++i)
        if (m[i] > bv) { bv = m[i]; bi = k * SPL + i; }
#pragma unroll
    for (int off = LPW / 2; off > 0; off >>= 1) {
        float ov = __shfl_xor_sync(FULL, bv, off);
        int oi = __shfl_xor_sync(FULL, bi, off);
        if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
    }

    // Traceback, TB steps at a time from the end; lane k == 0 walks.
    cp_wait<0>();
    __threadfence_block();                      // decisions visible warp-wide
    __syncwarp();
    uint64_t* dstage = reinterpret_cast<uint64_t*>(stage);
    const int ntb = (T + TB - 1) / TB;
    load_dec<WPW>(dstage + ((ntb - 1) & 1) * TB * WPW, dec, w0, NW, T, (ntb - 1) * TB, lane);
    cp_commit();
    int state = bi;
    for (int c = ntb - 1; c >= 0; --c) {
        if (c > 0)
            load_dec<WPW>(dstage + ((c - 1) & 1) * TB * WPW, dec, w0, NW, T, (c - 1) * TB, lane);
        cp_commit();
        cp_wait<1>();
        __syncwarp();
        const uint2* ds = reinterpret_cast<const uint2*>(dstage + (c & 1) * TB * WPW + q);
        const int t0 = c * TB, steps = min(TB, T - t0);
        if (k == 0) {
            uint8_t* out = bsm + q * S::BITROW;
            if (steps == TB) {
                // All TB words into registers first: the walk then waits on
                // nothing but its own few integer operations a step.
                uint2 d[TB];
#pragma unroll
                for (int j = 0; j < TB; ++j) d[j] = ds[j * WPW];
#pragma unroll
                for (int j = TB - 1; j >= 0; --j) state = walk<LPW>(d[j], state, out + j);
            } else {
                for (int j = steps - 1; j >= 0; --j) state = walk<LPW>(ds[j * WPW], state, out + j);
            }
        }
        __syncwarp();
#pragma unroll
        for (int qq = 0; qq < WPW; ++qq) {
            if (w0 + qq < NW) {
                uint8_t* out = bits + (size_t)(w0 + qq) * T + t0;
                for (int j = lane; j < steps; j += 32) out[j] = bsm[qq * S::BITROW + j];
            }
        }
        __syncwarp();                           // before chunk c - 2 lands here
    }
}

// One warp a block, so few warps spread evenly over the SMs.
template <int LPW>
static int launch(const void* soft, void* dec, void* bits, int NW, int T, cudaStream_t st) {
    constexpr int WPW = 32 / LPW;
    viterbi_kernel<LPW><<<(NW + WPW - 1) / WPW, 32, 0, st>>>(
        (const float2*)soft, (uint64_t*)dec, (uint8_t*)bits, NW, T);
    return (int)cudaGetLastError();
}

// soft (NW, 2T) f32; dec (T, NW) u64 scratch; bits (NW, T) u8; lanes: LPW.
extern "C" int xrit_viterbi(const void* soft, void* dec, void* bits, int NW, int T,
                            int lanes, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    switch (lanes) {
        case 4: return launch<4>(soft, dec, bits, NW, T, st);
        case 32: return launch<32>(soft, dec, bits, NW, T, st);
        default: return (int)cudaErrorInvalidValue;
    }
}
