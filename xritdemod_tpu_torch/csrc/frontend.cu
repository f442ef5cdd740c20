// Demodulator front end on channels-last (T, C) planes: AGC gain recursion,
// N-tap RRC FIR with carried history, order-2 Costas loop.
//
// Replaces the Pallas kernel _frontend_kernel of
// xritdemod_tpu/ops/frontend_pallas.py.  The three stages have different
// parallelism, so they are three kernels launched back to back:
//   agc_kernel    one thread per channel walks the T samples (the gain
//                 recursion is sequential) and writes the scaled samples
//                 under the N-1 history rows of the FIR window buffer;
//   fir_kernel    fully parallel over (t, c): each thread forms R outputs
//                 of one channel from a sliding register window, taps in
//                 ascending order per output;
//   costas_kernel one thread per channel walks the T filtered samples and
//                 rotates them in place.
// Neighbouring threads are neighbouring channels, so every access is a
// coalesced row.  Built without FMA contraction and without fast-math:
// each product and sum rounds as the plain PyTorch version's does, and
// sinf/cosf/sqrtf are the accurate forms.
#include <cuda_runtime.h>
#include <math.h>

#include "loops.cuh"     // agc_step, costas_step: shared with stream.cu

#define FIR_R 8          // outputs per thread in the FIR
#define FIR_MAX_TAPS 256
#define SEQ_BATCH 16     // rows loaded ahead in the sequential stages

__global__ void agc_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                           const float* __restrict__ hr, const float* __restrict__ hi,
                           float* __restrict__ er, float* __restrict__ ei,
                           const float* __restrict__ gain_in, float* __restrict__ gain_out,
                           int T, int C, int nh,
                           float rate, float reference, float max_gain) {
    int c = blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= C) return;
    // History (C, nh) -> the first nh rows of the window buffer.
    for (int k = 0; k < nh; ++k) {
        er[(size_t)k * C + c] = hr[(size_t)c * nh + k];
        ei[(size_t)k * C + c] = hi[(size_t)c * nh + k];
    }
    float g = gain_in[c];
    float* orow = er + (size_t)nh * C + c;
    float* irow = ei + (size_t)nh * C + c;
    const float* pr = xr + c;
    const float* pi = xi + c;
    // Loads are batched ahead of the dependent gain chain so SEQ_BATCH rows
    // are in flight per thread.
    for (int t0 = 0; t0 < T; t0 += SEQ_BATCH) {
        float vr[SEQ_BATCH], vi[SEQ_BATCH];
#pragma unroll
        for (int u = 0; u < SEQ_BATCH; ++u) {
            bool in = t0 + u < T;
            vr[u] = in ? pr[(size_t)(t0 + u) * C] : 0.0f;
            vi[u] = in ? pi[(size_t)(t0 + u) * C] : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < SEQ_BATCH; ++u) {
            if (t0 + u < T) {
                float ore, oim;
                agc_step(vr[u], vi[u], g, rate, reference, max_gain, ore, oim);
                orow[(size_t)(t0 + u) * C] = ore;
                irow[(size_t)(t0 + u) * C] = oim;
            }
        }
    }
    gain_out[c] = g;
}

__global__ void fir_kernel(const float* __restrict__ er, const float* __restrict__ ei,
                           float* __restrict__ yr, float* __restrict__ yi,
                           const float* __restrict__ taps, int T, int C, int ntaps) {
    __shared__ float tp[FIR_MAX_TAPS];
    for (int k = threadIdx.x; k < ntaps; k += blockDim.x) tp[k] = taps[k];
    __syncthreads();
    int c = blockIdx.y * blockDim.x + threadIdx.x;
    int t0 = blockIdx.x * FIR_R;
    if (c >= C) return;
    float ar[FIR_R], ai[FIR_R];
#pragma unroll
    for (int r = 0; r < FIR_R; ++r) { ar[r] = 0.0f; ai[r] = 0.0f; }
    // Window row j feeds output t0+r through tap j-r; rows arrive in
    // ascending j, so each output accumulates its taps in ascending order.
    int rows = ntaps + FIR_R - 1;
    for (int j = 0; j < rows; ++j) {
        int row = t0 + j;
        if (row >= T + ntaps - 1) break;
        float vr = er[(size_t)row * C + c];
        float vi = ei[(size_t)row * C + c];
#pragma unroll
        for (int r = 0; r < FIR_R; ++r) {
            int k = j - r;
            if (k >= 0 && k < ntaps) {
                float w = tp[k];
                ar[r] = ar[r] + w * vr;
                ai[r] = ai[r] + w * vi;
            }
        }
    }
#pragma unroll
    for (int r = 0; r < FIR_R; ++r) {
        int t = t0 + r;
        if (t < T) {
            yr[(size_t)t * C + c] = ar[r];
            yi[(size_t)t * C + c] = ai[r];
        }
    }
}

__global__ void costas_kernel(float* __restrict__ yr, float* __restrict__ yi,
                              const float* __restrict__ phase_in,
                              const float* __restrict__ freq_in,
                              float* __restrict__ phase_out, float* __restrict__ freq_out,
                              int T, int C, float alpha, float beta,
                              float freq_min, float freq_max) {
    int c = blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= C) return;
    float phase = phase_in[c];
    float freq = freq_in[c];
    float* pr = yr + c;
    float* pi = yi + c;
    for (int t0 = 0; t0 < T; t0 += SEQ_BATCH) {
        float vr[SEQ_BATCH], vi[SEQ_BATCH];
#pragma unroll
        for (int u = 0; u < SEQ_BATCH; ++u) {
            bool in = t0 + u < T;
            vr[u] = in ? pr[(size_t)(t0 + u) * C] : 0.0f;
            vi[u] = in ? pi[(size_t)(t0 + u) * C] : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < SEQ_BATCH; ++u) {
            if (t0 + u < T) {
                float orr, oi;
                costas_step(vr[u], vi[u], phase, freq, alpha, beta, freq_min, freq_max,
                            orr, oi);
                pr[(size_t)(t0 + u) * C] = orr;
                pi[(size_t)(t0 + u) * C] = oi;
            }
        }
    }
    phase_out[c] = phase;
    freq_out[c] = freq;
}

// x (T, C); hist (C, nh); ext scratch (T+nh, C); y (T, C); state vectors (C,).
extern "C" int xrit_frontend(
    const void* xr, const void* xi, const void* hr, const void* hi,
    void* er, void* ei, void* yr, void* yi, const void* taps,
    const void* gain_in, void* gain_out,
    const void* phase_in, const void* freq_in, void* phase_out, void* freq_out,
    int T, int C, int ntaps,
    float rate, float reference, float max_gain,
    float alpha, float beta, float freq_min, float freq_max, void* stream) {
    if (ntaps < 1 || ntaps > FIR_MAX_TAPS) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    // One warp per block spreads the sequential stages over as many SMs as
    // there are channel groups.
    const int seq_threads = 32;
    dim3 seq_grid((C + seq_threads - 1) / seq_threads);
    agc_kernel<<<seq_grid, seq_threads, 0, s>>>(
        (const float*)xr, (const float*)xi, (const float*)hr, (const float*)hi,
        (float*)er, (float*)ei, (const float*)gain_in, (float*)gain_out,
        T, C, ntaps - 1, rate, reference, max_gain);
    int err = (int)cudaGetLastError();
    if (err) return err;
    const int fir_threads = 128;
    dim3 fir_grid((T + FIR_R - 1) / FIR_R, (C + fir_threads - 1) / fir_threads);
    fir_kernel<<<fir_grid, fir_threads, 0, s>>>(
        (const float*)er, (const float*)ei, (float*)yr, (float*)yi,
        (const float*)taps, T, C, ntaps);
    err = (int)cudaGetLastError();
    if (err) return err;
    costas_kernel<<<seq_grid, seq_threads, 0, s>>>(
        (float*)yr, (float*)yi, (const float*)phase_in, (const float*)freq_in,
        (float*)phase_out, (float*)freq_out, T, C, alpha, beta, freq_min, freq_max);
    return (int)cudaGetLastError();
}
