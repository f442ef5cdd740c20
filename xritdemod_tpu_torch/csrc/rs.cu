// CCSDS Reed-Solomon (255,223) decoder, every codeword of a batch in one
// launch: dual -> conventional basis, 32 syndromes, Berlekamp-Massey, Chien,
// Omega, Forney, the acceptance rule and conventional -> dual.
//
// Replaces no Pallas kernel.  The JAX package decodes in one XLA program,
// `rs_decode` / `_rs_correct` of xritdemod_tpu/ops/reed_solomon.py:313-518:
// GF(2) bit-matrix products for the syndromes, Chien and Forney, a
// `lax.scan` of 32 masked Berlekamp-Massey steps, and nested `lax.cond`s on
// device counts that pick the clean, the sparse or the full branch (its TPU
// serialises row gathers, so it compacts rows with one-hot matmuls).  Every
// branch gives the same rows, so here no branch is taken on the data: a
// codeword whose syndromes are all zero comes out as it came, every other
// codeword is corrected, and nothing is read back to the host.
//
// One warp a codeword, one warp a block (`__launch_bounds__(32)`: no
// hand-off between warps), each block walking codewords blockIdx.x,
// blockIdx.x + gridDim.x, ...  The GF(2^8) exp/log tables and the two basis
// maps (1280 bytes, ops/rs_cuda.py) come into shared memory once a block.
//   - syndromes: lane k evaluates S_k over the 255 bytes from shared memory
//     (the byte's log read once, the power stepped down by FCR + k a byte);
//   - Berlekamp-Massey: lane j holds Lambda_j and B_j (j < 32), every lane
//     the coefficient 32 (it never meets a syndrome: S_{rr-32} is out of
//     range); the discrepancy is a warp XOR-reduction; the update is the
//     plain version's, step for step (ops/reed_solomon.py::_rs_correct);
//   - Chien, Lambda' and Forney: the lanes by position p, eight a lane;
//     Omega_j = XOR_{i <= j} S_i Lambda_{j-i} on lane j.
// What bounds it on an H100: a clean codeword moves 2 x 255 + 4 bytes and
// costs 32 x 255 table multiplies (the syndromes), so a clean batch is bound
// by its operations, close to its bytes; an errored codeword adds a chain of
// 32 dependent BM steps (a reduction of five shuffles each) and 255 x 49
// multiplies of Chien and Forney, so an errored batch is bound by that chain
// at the warps the card holds.  Integer table arithmetic only: the result
// equals the plain version's bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#define RS_N 255
#define RS_T2 32             // parity symbols
#define RS_T 16              // correctable symbols
#define RS_FCR 112
#define RS_NOLOG 255         // the log of zero, as a sentinel
#define RS_TABLE_BYTES 1280  // exp[512], log[256], tal[256], tal1[256]

__device__ __forceinline__ int gf_mul(const uint8_t* ex, const uint8_t* lg, int a, int b) {
    return (a && b) ? ex[lg[a] + lg[b]] : 0;
}

__device__ __forceinline__ int gf_inv(const uint8_t* ex, const uint8_t* lg, int a) {
    return a ? ex[255 - lg[a]] : 0;
}

__device__ __forceinline__ int xor_reduce(int v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v ^= __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// in (B, 255) u8 dual basis; out (B, 255) u8 dual basis; nerr (B,) i32:
// corrected symbols, 0 for a clean codeword, -1 where decoding fails (the
// codeword then comes out as received).
__global__ void __launch_bounds__(32)
rs_decode_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                 int* __restrict__ nerr, const uint8_t* __restrict__ tables, int B) {
    __shared__ __align__(16) uint8_t tb[RS_TABLE_BYTES];
    __shared__ uint8_t r[256];        // the codeword, conventional basis
    __shared__ uint8_t lr[256];       // log of each byte (RS_NOLOG for 0)
    __shared__ uint8_t lsyn[RS_T2];   // log of each syndrome
    __shared__ uint8_t llam[RS_T2 + 1];
    __shared__ uint8_t lom[RS_T2];
    const uint8_t* ex = tb;
    const uint8_t* lg = tb + 512;
    const uint8_t* tal = tb + 768;
    const uint8_t* tal1 = tb + 1024;
    const int lane = threadIdx.x;

    for (int i = lane; i < RS_TABLE_BYTES / 4; i += 32)
        reinterpret_cast<uint32_t*>(tb)[i] = reinterpret_cast<const uint32_t*>(tables)[i];
    __syncwarp();

    for (int b = blockIdx.x; b < B; b += gridDim.x) {
        const uint8_t* row = in + (size_t)b * RS_N;
        uint8_t* orow = out + (size_t)b * RS_N;
        uint8_t x[8];
#pragma unroll
        for (int m = 0; m < 8; ++m) {
            const int j = lane + 32 * m;
            x[m] = j < RS_N ? row[j] : 0;
            if (j < RS_N) {
                const int v = tal1[x[m]];
                r[j] = v;
                lr[j] = v ? lg[v] : RS_NOLOG;
            }
        }
        __syncwarp();

        // ---- syndromes: S_k = XOR_i r_i beta^((FCR+k)(254-i)) on lane k
        const int sstep = RS_FCR + lane;                 // < 255
        int e = (sstep * 254) % 255;
        int s = 0;
        for (int i = 0; i < RS_N; ++i) {
            const int l = lr[i];
            if (l != RS_NOLOG) s ^= ex[l + e];
            e -= sstep;
            if (e < 0) e += 255;
        }
        if (!__any_sync(0xffffffffu, s != 0)) {
#pragma unroll
            for (int m = 0; m < 8; ++m) {
                const int j = lane + 32 * m;
                if (j < RS_N) orow[j] = x[m];
            }
            if (lane == 0) nerr[b] = 0;
            __syncwarp();
            continue;
        }
        lsyn[lane] = s ? lg[s] : RS_NOLOG;
        __syncwarp();

        // ---- Berlekamp-Massey: 32 masked steps ------------------------
        int lam = lane == 0, bp = lane == 0;   // coefficient `lane`
        int lam32 = 0, bp32 = 0;               // coefficient 32, on every lane
        int L = 0, binv = 1;
        for (int rr = 0; rr < RS_T2; ++rr) {
            int t = 0;
            if (lane <= rr && lam) {
                const int ls = lsyn[rr - lane];
                if (ls != RS_NOLOG) t = ex[lg[lam] + ls];
            }
            const int d = xor_reduce(t);
            int bx = __shfl_up_sync(0xffffffffu, bp, 1);
            if (lane == 0) bx = 0;
            const int bx32 = __shfl_sync(0xffffffffu, bp, 31);
            const int frac = gf_mul(ex, lg, d, binv);
            const int nlam = d ? lam ^ gf_mul(ex, lg, frac, bx) : lam;
            const int nlam32 = d ? lam32 ^ gf_mul(ex, lg, frac, bx32) : lam32;
            const bool grow = d != 0 && 2 * L <= rr;
            bp = grow ? lam : bx;
            bp32 = grow ? lam32 : bx32;
            if (grow) {
                binv = gf_inv(ex, lg, d);
                L = rr + 1 - L;
            }
            lam = nlam;
            lam32 = nlam32;
        }
        llam[lane] = lam ? lg[lam] : RS_NOLOG;
        if (lane == 0) llam[RS_T2] = lam32 ? lg[lam32] : RS_NOLOG;
        __syncwarp();

        // ---- Omega = S(x) Lambda(x) mod x^32, coefficient `lane` -------
        int om = 0;
        for (int i = 0; i <= lane; ++i) {
            const int a = lsyn[i], c = llam[lane - i];
            if (a != RS_NOLOG && c != RS_NOLOG) om ^= ex[a + c];
        }
        lom[lane] = om ? lg[om] : RS_NOLOG;
        __syncwarp();

        // ---- Chien, Lambda', Forney at p = lane + 32 m -------------------
        // Powers beta^((255-p) k); the error at power p sits at byte 254 - p.
        int nroots = 0;
        int fix[8];
#pragma unroll
        for (int m = 0; m < 8; ++m) {
            const int p = lane + 32 * m;
            const int step = (255 - p) % 255;
            int lam_e = 0, dlam = 0, num = 0, ek = 0;
            if (p < RS_N) {
                for (int k = 0; k <= RS_T2; ++k) {
                    const int l = llam[k];
                    if (l != RS_NOLOG) {
                        lam_e ^= ex[l + ek];
                        if (k & 1) dlam ^= ex[l + (ek >= step ? ek - step : ek + 255 - step)];
                    }
                    if (k < RS_T2) {
                        const int o = lom[k];
                        if (o != RS_NOLOG) num ^= ex[o + ek];
                    }
                    ek += step;
                    if (ek >= 255) ek -= 255;
                }
            }
            const bool root = p < RS_N && lam_e == 0;
            nroots += __popc(__ballot_sync(0xffffffffu, root));
            int ev = 0;
            if (root && dlam != 0 && num != 0) {
                const int xpow = (p * (255 - (RS_FCR - 1))) % 255;   // X^(1-FCR)
                const int n2 = ex[lg[num] + xpow];
                ev = ex[lg[n2] + 255 - lg[dlam]];
            }
            fix[m] = ev;
        }
        const bool ok = nroots == L && L > 0 && L <= RS_T;
#pragma unroll
        for (int m = 0; m < 8; ++m) {
            const int p = lane + 32 * m;
            if (p < RS_N) {
                const int j = RS_N - 1 - p;
                orow[j] = ok ? tal[r[j] ^ fix[m]] : row[j];
            }
        }
        if (lane == 0) nerr[b] = ok ? L : -1;
        __syncwarp();
    }
}

extern "C" int xrit_rs_decode(const void* in, void* out, void* nerr, const void* tables,
                              int B, void* stream) {
    if (B < 1) return (int)cudaErrorInvalidValue;
    static int sms = 0;
    if (sms == 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (sms <= 0) sms = 132;
    }
    const int grid = B < sms * 32 ? B : sms * 32;
    rs_decode_kernel<<<grid, 32, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)in, (uint8_t*)out, (int*)nerr, (const uint8_t*)tables, B);
    return (int)cudaGetLastError();
}
