// Standalone AGC and Costas loops over a (C, T) block: the split front end's
// two feedback stages, each reading the block once and writing it once.
//
// Replaces the Pallas kernels _agc_kernel and _costas_kernel of
// xritdemod_tpu/ops/stream_pallas.py (entries agc_block_pallas and
// costas_block_pallas).  Those transpose to channels-last planes outside the
// kernel and back; here the kernel serves the (C, T) contract itself.
//
// Each channel is a chain of T dependent steps, so a thread walks one
// channel along time — but neighbouring threads would then read addresses T
// floats apart.  So a warp owns 32 channels and moves the block in tiles of
// 32 channels x 32 samples through shared memory:
//   - a tile is fetched row by row, each row (one channel, 32 consecutive
//     samples) one coalesced 128-byte read, with cp.async, one tile ahead of
//     the walk (two tile buffers), so the loads overlap the dependent chain;
//   - lane l then walks row l of the tile, replacing each sample by its
//     output in place (rows are padded to 33 floats: lane l, column u sits
//     in bank (l + u) mod 32, so neither the row-wise nor the lane-wise
//     access conflicts);
//   - the tile is written back row by row, coalesced again.
// The loop state stays in registers across tiles.  One warp per block
// spreads the channel groups over the SMs.  What bounds it on an H100 is not
// bytes (the block once in, once out) but the length of one thread's chain.
// The per-sample arithmetic is loops.cuh's, shared with frontend.cu.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "loops.cuh"

#define TILE 32          // samples per tile row = lanes of the warp
#define PAD (TILE + 1)   // padded row length in shared memory

struct AgcOp {
    const float* gain_in;
    float* gain_out;
    float rate, reference, max_gain;
    float g;
    __device__ void load(int c) { g = gain_in[c]; }
    __device__ void step(float xr, float xi, float& yr, float& yi) {
        agc_step(xr, xi, g, rate, reference, max_gain, yr, yi);
    }
    __device__ void store(int c) { gain_out[c] = g; }
};

struct CostasOp {
    const float *phase_in, *freq_in;
    float *phase_out, *freq_out;
    float alpha, beta, freq_min, freq_max;
    float phase, freq;
    __device__ void load(int c) { phase = phase_in[c]; freq = freq_in[c]; }
    __device__ void step(float xr, float xi, float& yr, float& yi) {
        costas_step(xr, xi, phase, freq, alpha, beta, freq_min, freq_max, yr, yi);
    }
    __device__ void store(int c) { phase_out[c] = phase; freq_out[c] = freq; }
};

template <class Op>
__global__ void stream_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                              float* __restrict__ yr, float* __restrict__ yi,
                              int C, int T, Op op) {
    __shared__ float sr[2][TILE][PAD];
    __shared__ float si[2][TILE][PAD];
    const int lane = threadIdx.x;
    const int c0 = blockIdx.x * 32;
    const int rows = min(32, C - c0);       // channels of this warp
    const bool live = lane < rows;
    if (live) op.load(c0 + lane);
    const int ntiles = (T + TILE - 1) / TILE;

    // Tile i -> buffer b: lane u copies column u of every row.
    auto fetch = [&](int i, int b) {
        const int t = i * TILE + lane;
        if (t < T) {
            for (int r = 0; r < rows; ++r) {
                const size_t o = (size_t)(c0 + r) * T + t;
                __pipeline_memcpy_async(&sr[b][r][lane], xr + o, sizeof(float));
                __pipeline_memcpy_async(&si[b][r][lane], xi + o, sizeof(float));
            }
        }
        __pipeline_commit();
    };

    fetch(0, 0);
    for (int i = 0; i < ntiles; ++i) {
        const int b = i & 1;
        // The next tile goes into the other buffer, whose write-back ended
        // at the last __syncwarp of the previous turn.  Past the last tile
        // the group is empty, so the wait below always leaves one behind.
        fetch(i + 1 < ntiles ? i + 1 : ntiles, b ^ 1);
        __pipeline_wait_prior(1);           // tile i has landed
        __syncwarp();
        const int t0 = i * TILE;
        const int n = min(TILE, T - t0);
        if (live) {
            for (int u = 0; u < n; ++u) {
                float outr, outi;
                op.step(sr[b][lane][u], si[b][lane][u], outr, outi);
                sr[b][lane][u] = outr;
                si[b][lane][u] = outi;
            }
        }
        __syncwarp();
        if (lane < n) {
            for (int r = 0; r < rows; ++r) {
                const size_t o = (size_t)(c0 + r) * T + t0 + lane;
                yr[o] = sr[b][r][lane];
                yi[o] = si[b][r][lane];
            }
        }
        __syncwarp();
    }
    if (live) op.store(c0 + lane);
}

// x, y (C, T) planes; state vectors (C,).
extern "C" int xrit_agc_block(
    const void* xr, const void* xi, void* yr, void* yi,
    const void* gain_in, void* gain_out, int C, int T,
    float rate, float reference, float max_gain, void* stream) {
    if (C < 1 || T < 1) return (int)cudaErrorInvalidValue;
    AgcOp op;
    op.gain_in = (const float*)gain_in;
    op.gain_out = (float*)gain_out;
    op.rate = rate; op.reference = reference; op.max_gain = max_gain;
    op.g = 0.0f;
    stream_kernel<AgcOp><<<(C + 31) / 32, 32, 0, (cudaStream_t)stream>>>(
        (const float*)xr, (const float*)xi, (float*)yr, (float*)yi, C, T, op);
    return (int)cudaGetLastError();
}

extern "C" int xrit_costas_block(
    const void* xr, const void* xi, void* yr, void* yi,
    const void* phase_in, const void* freq_in, void* phase_out, void* freq_out,
    int C, int T, float alpha, float beta, float freq_min, float freq_max,
    void* stream) {
    if (C < 1 || T < 1) return (int)cudaErrorInvalidValue;
    CostasOp op;
    op.phase_in = (const float*)phase_in; op.freq_in = (const float*)freq_in;
    op.phase_out = (float*)phase_out; op.freq_out = (float*)freq_out;
    op.alpha = alpha; op.beta = beta; op.freq_min = freq_min; op.freq_max = freq_max;
    op.phase = 0.0f; op.freq = 0.0f;
    stream_kernel<CostasOp><<<(C + 31) / 32, 32, 0, (cudaStream_t)stream>>>(
        (const float*)xr, (const float*)xi, (float*)yr, (float*)yi, C, T, op);
    return (int)cudaGetLastError();
}
