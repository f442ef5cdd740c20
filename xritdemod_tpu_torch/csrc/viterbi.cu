// CCSDS rate-1/2 K=7 Viterbi decoder: forward add-compare-select and
// traceback in one kernel, one warp per window.
//
// Replaces the Pallas kernels _fwd_kernel / _fwd_kernel_reg / _back_kernel of
// xritdemod_tpu/ops/viterbi_pallas.py.  Lane l holds the path metrics of
// states 2l and 2l+1, which share the predecessors l and l+32; those sit in
// lanes l>>1 and 16+(l>>1), so one step is four metric shuffles, two
// add-compare-selects per lane and two ballots that pack the 64 decisions
// into two words (even states, odd states).  Soft symbols and decision words
// move through registers 32 steps at a time so every global access is one
// coalesced row per warp.  Decisions go to global memory (8 bytes per step
// per window) and are read back by the same warp for the traceback.
//
// Float order equals ops/viterbi.py bit for bit: branch metric a*g1 + b*g2
// with g = +-1 (compiled without FMA contraction), candidate = metric +
// branch, strict c1 > c0 so ties keep predecessor n>>1, first-index argmax
// for the end state.
#include <cuda_runtime.h>
#include <stdint.h>

#define POLY_A 0x4F
#define POLY_B 0x6D

__device__ __forceinline__ float sign_of(int sr, int poly) {
    // Coded bit = parity ^ 1; bit 1 maps to a negative symbol.
    return (__popc(sr & poly) & 1) ? 1.0f : -1.0f;
}

__global__ void viterbi_kernel(const float* soft, uint2* dec, uint8_t* bits,
                               int NW, int T) {
    const unsigned FULL = 0xffffffffu;
    int w = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    int lane = threadIdx.x & 31;
    if (w >= NW) return;                       // whole warps leave together
    const float2* x = reinterpret_cast<const float2*>(soft) + (size_t)w * T;
    uint2* d = dec + (size_t)w * T;
    uint8_t* out = bits + (size_t)w * T;

    // Branch signs of this lane's two next states (input bit 0 and 1) from
    // predecessor `lane` (register lane<<1|b) and `lane+32` (that plus 64).
    float g1[2][2], g2[2][2];
#pragma unroll
    for (int b = 0; b < 2; ++b) {
        int sr0 = (lane << 1) | b;
        int sr1 = sr0 | 64;
        g1[b][0] = sign_of(sr0, POLY_A); g2[b][0] = sign_of(sr0, POLY_B);
        g1[b][1] = sign_of(sr1, POLY_A); g2[b][1] = sign_of(sr1, POLY_B);
    }

    const int lo_src = lane >> 1, hi_src = 16 + (lane >> 1);
    const bool odd = lane & 1;
    float m0 = 0.0f, m1 = 0.0f;                // metrics of states 2l, 2l+1

    for (int t0 = 0; t0 < T; t0 += 32) {
        int steps = min(32, T - t0);
        float2 xv = make_float2(0.0f, 0.0f);
        if (lane < steps) xv = x[t0 + lane];
        unsigned ke = 0, ko = 0;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            if (i < steps) {
                float a = __shfl_sync(FULL, xv.x, i);
                float b = __shfl_sync(FULL, xv.y, i);
                float l0 = __shfl_sync(FULL, m0, lo_src);
                float l1 = __shfl_sync(FULL, m1, lo_src);
                float h0 = __shfl_sync(FULL, m0, hi_src);
                float h1 = __shfl_sync(FULL, m1, hi_src);
                float pj = odd ? l1 : l0;      // old metric of state lane
                float pk = odd ? h1 : h0;      // old metric of state lane+32
                float c00 = pj + (a * g1[0][0] + b * g2[0][0]);
                float c01 = pk + (a * g1[0][1] + b * g2[0][1]);
                float c10 = pj + (a * g1[1][0] + b * g2[1][0]);
                float c11 = pk + (a * g1[1][1] + b * g2[1][1]);
                bool d0 = c01 > c00;
                bool d1 = c11 > c10;
                m0 = d0 ? c01 : c00;
                m1 = d1 ? c11 : c10;
                unsigned e = __ballot_sync(FULL, d0);
                unsigned o = __ballot_sync(FULL, d1);
                if (lane == i) { ke = e; ko = o; }
            }
        }
        if (lane < steps) d[t0 + lane] = make_uint2(ke, ko);
    }

    // End state: first index of the largest metric.
    float bv = m0;
    int bi = 2 * lane;
    if (m1 > m0) { bv = m1; bi = 2 * lane + 1; }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        float ov = __shfl_xor_sync(FULL, bv, off);
        int oi = __shfl_xor_sync(FULL, bi, off);
        if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
    }
    int state = bi;

    __syncwarp();                               // decisions visible warp-wide
    for (int t0 = ((T - 1) / 32) * 32; t0 >= 0; t0 -= 32) {
        int steps = min(32, T - t0);
        uint2 dv = make_uint2(0u, 0u);
        if (lane < steps) dv = d[t0 + lane];
        unsigned kb = 0;
#pragma unroll
        for (int i = 31; i >= 0; --i) {
            if (i < steps) {
                unsigned e = __shfl_sync(FULL, dv.x, i);
                unsigned o = __shfl_sync(FULL, dv.y, i);
                unsigned bit = state & 1;
                unsigned word = bit ? o : e;
                unsigned took = (word >> (state >> 1)) & 1u;
                if (lane == i) kb = bit;
                state = (state >> 1) + 32 * (int)took;
            }
        }
        if (lane < steps) out[t0 + lane] = (uint8_t)kb;
    }
}

// soft (NW, 2T) f32; dec (NW, T, 2) u32 scratch; bits (NW, T) u8.
extern "C" int xrit_viterbi(const void* soft, void* dec, void* bits,
                            int NW, int T, void* stream) {
    const int warps = 4;
    dim3 grid((NW + warps - 1) / warps), block(32 * warps);
    viterbi_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const float*)soft, (uint2*)dec, (uint8_t*)bits, NW, T);
    return (int)cudaGetLastError();
}
