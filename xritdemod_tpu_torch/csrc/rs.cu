// CCSDS Reed-Solomon (255,223) decoder, every codeword of a batch in one
// launch: syndromes (dual basis in, conventional out), Berlekamp-Massey,
// Chien, Omega, Forney and the acceptance rule; the corrections go back in
// the dual basis.
//
// Replaces no Pallas kernel.  The JAX package decodes in one XLA program,
// `rs_decode` / `_rs_correct` of xritdemod_tpu/ops/reed_solomon.py:313-518:
// GF(2) bit-matrix products for the syndromes, Chien and Forney, a
// `lax.scan` of 32 masked Berlekamp-Massey steps, and nested `lax.cond`s on
// device counts that pick the clean, the sparse or the full branch.  Every
// branch gives the same rows, so here no branch is taken on the data: a
// codeword whose syndromes are all zero comes out as it came, every other
// codeword is corrected, and nothing is read back to the host.
//
// Two entries share the kernel: `(B, 255)` codewords, and `(F, 1020)` frames
// whose codeword i is bytes i, i + 4, ... (the 4-way interleave, read and
// written in place: G codewords a row of the input, byte j of codeword r at
// (r / G) * 255 G + r % G + j G).  Either way a tile of 16 codewords is 4080
// contiguous bytes.
//
// Persistent blocks of 16 warps, two a streaming multiprocessor, each
// walking tiles blockIdx.x, blockIdx.x + gridDim.x, ...:
//   - the tables come into shared memory once a block: the syndrome map as
//     the MMA's B fragments (64 KiB) and the GF(2^8) exp/log and the dual
//     basis map (1 KiB), all built by ops/rs_cuda.py;
//   - a tile comes in with 16-byte loads and is laid out as 16 rows of 2048
//     bits (bit j of byte i at bit 8 i + j: the JAX package's `msyn` rows);
//   - syndromes: the tile's 16 x 2048 bits times `msyn`'s 2048 x 256 (the
//     dual -> conventional map folded in) on the tensor cores,
//     `mma.m16n8k256` b1 with AND + POPC (the layout of its fragments checked
//     on an H100), each warp two of the 32 syndrome bytes (eight k-steps
//     each); the parity of a count is a syndrome bit;
//   - the tile goes out as received, and its errored rows (their syndromes
//     and rows) to a queue in shared memory; when 16 are queued, and when
//     the block's tiles are done, they are corrected one warp a row, so a
//     rare errored row does not hold its tile's 15 warps idle:
//     Berlekamp-Massey as the plain version steps it (lane j holds
//     Lambda_j and B_j, every lane the coefficient 32, the incremental 1/b,
//     kept as its log; the discrepancy by one XOR reduction;
//     ops/reed_solomon.py::_rs_correct); where 0 < L <= 16, Chien over the
//     255 positions (eight a lane) keeps the odd part of Lambda, which is
//     Lambda' times X at each root; where the roots number L, Omega on lane
//     j and Forney at the roots only, one lane a root, each corrected byte
//     written over the received one, in ^ the error in the dual basis (the
//     basis map is linear).
// What bounds it on an H100: a clean tile moves 2 x 4080 bytes and costs
// 16 x 8 tensor-core products, so a clean batch is bound by its bytes; an
// errored codeword adds a chain of 32 dependent BM steps (a reduction and
// four dependent table lookups each) and Chien's 8 positions x (degree + 1)
// table multiplies a lane, so an errored batch is bound by that chain at the
// warps the card holds.
// Integer arithmetic only: the result equals the plain version's bit for
// bit.
#include <cuda_runtime.h>
#include <stdint.h>

#define RS_N 255
#define RS_T2 32                // parity symbols
#define RS_T 16                 // correctable symbols
#define RS_FCR 112
#define RS_NOLOG 255            // the log of zero, as a sentinel
#define RS_WARPS 16             // warps a block
#define RS_THREADS (RS_WARPS * 32)
#define RS_NT (RS_T2 / RS_WARPS)        // syndrome bytes (n-tiles) a warp
#define RS_BLOCKS_PER_SM 2
#define RS_TILE 16              // codewords a tile: the MMA's rows
#define RS_TILE_BYTES (RS_TILE * RS_N)
#define RS_RAW_BYTES 4096       // the tile as it lies in memory, zero padded
#define RS_ROW_WORDS 68         // 64 words of bits a row + 4: conflict-free fragment loads
#define RS_FRAG_BYTES 65536     // the syndrome map's B fragments: 32 n x 8 k x 32 lanes x 8 B
#define RS_GF_BYTES 1024        // exp[512], log[256], tal[256]
#define RS_TABLE_BYTES (RS_FRAG_BYTES + RS_GF_BYTES)
#define RS_SCRATCH 192          // a warp's bytes of Berlekamp-Massey, Omega and roots
#define RS_QUEUE 32             // errored rows held: up to RS_FLUSH - 1 + a tile's 16
#define RS_FLUSH 16             // rows queued that start their correction
#define RS_SMEM (RS_TABLE_BYTES + RS_RAW_BYTES + RS_TILE * RS_ROW_WORDS * 4 \
                 + (RS_TILE + RS_QUEUE) * RS_T2 + RS_WARPS * RS_SCRATCH + (RS_QUEUE + 1) * 4)

static_assert(RS_THREADS * 16 >= RS_TILE_BYTES, "a tile comes in as a 16-byte vector a thread");
static_assert(RS_T2 % RS_WARPS == 0, "the syndrome bytes split evenly between the warps");

// Berlekamp-Massey's discrepancy: the XOR of the warp's terms.
__device__ __forceinline__ int xor_reduce(int v) {
    return (int)__reduce_xor_sync(0xffffffffu, (unsigned)v);
}

// D += A (16 x 256 bits, row) . B (256 x 8 bits, col), AND then POPC.
__device__ __forceinline__ void mma_b1(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint2 b) {
    asm volatile("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
                 "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                 : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
                 : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b.x), "r"(b.y));
}

// Byte j of the tile's codeword r, as the input lays it out.
template <int G>
__device__ __forceinline__ int tile_byte(int r, int j) {
    return (r / G) * (RS_N * G) + r % G + j * G;
}

// One errored codeword, row r of the batch (its syndromes `s` on the
// lanes), on one warp, by the GF(2^8) exp/log tables (beta = alpha^11; exp
// doubled, so a sum of two logs needs no mod): returns nerr on every lane; a
// corrected codeword's
// errors go out in the dual basis, out = in ^ tal(e) at each error (the
// codeword went out as received with its tile).
template <int G>
__device__ int correct_row(int r, int s, const uint8_t* in, uint8_t* out, const uint8_t* ex,
                           const uint8_t* lg, const uint8_t* tal, uint8_t* scratch, int lane) {
    uint8_t* lsyn = scratch;              // log of each syndrome
    uint8_t* llam = scratch + 32;         // log of each Lambda coefficient (33)
    uint8_t* lom = scratch + 68;          // log of each Omega coefficient
    uint8_t* rootp = scratch + 100;       // root positions (at most 16 are kept)
    uint8_t* rodd = scratch + 132;        // the odd part of Lambda at each root
    lsyn[lane] = s ? lg[s] : RS_NOLOG;
    __syncwarp();

    // ---- Berlekamp-Massey: 32 masked steps -----------------------------
    // 1/b is kept as its log (b != 0), so frac = d / b is log(d) + lbinv.
    int lam = lane == 0, bp = lane == 0;   // coefficient `lane`
    int lam32 = 0, bp32 = 0;               // coefficient 32, on every lane
    int L = 0, lbinv = 0;
    for (int rr = 0; rr < RS_T2; ++rr) {
        int t = 0;
        if (lane <= rr && lam) {
            const int ls = lsyn[rr - lane];
            if (ls != RS_NOLOG) t = ex[lg[lam] + ls];
        }
        int bx = __shfl_up_sync(0xffffffffu, bp, 1);
        if (lane == 0) bx = 0;
        const int bx32 = __shfl_sync(0xffffffffu, bp, 31);
        const int lbx = lg[bx], lbx32 = lg[bx32];
        const int d = xor_reduce(t);
        const int ld = lg[d];
        int lfrac = ld + lbinv;
        if (lfrac >= 255) lfrac -= 255;
        const int nlam = d && bx ? lam ^ ex[lfrac + lbx] : lam;
        const int nlam32 = d && bx32 ? lam32 ^ ex[lfrac + lbx32] : lam32;
        const bool grow = d != 0 && 2 * L <= rr;
        bp = grow ? lam : bx;
        bp32 = grow ? lam32 : bx32;
        if (grow) {
            lbinv = ld ? 255 - ld : 0;       // log(1/d)
            L = rr + 1 - L;
        }
        lam = nlam;
        lam32 = nlam32;
    }
    if (L <= 0 || L > RS_T) return -1;          // uncorrectable whatever the roots
    llam[lane] = lam ? lg[lam] : RS_NOLOG;
    if (lane == 0) llam[RS_T2] = lam32 ? lg[lam32] : RS_NOLOG;
    const unsigned nz = __ballot_sync(0xffffffffu, lam != 0);
    const int deg = lam32 ? RS_T2 : 31 - __clz(nz);      // nz has bit 0 or the row is clean
    __syncwarp();

    // ---- Chien: Lambda at X = beta^(255 - p), p = lane + 32 m -----------
    // Even and odd parts apart: at a root, Lambda'(X) X = the odd part.
    int ev[8], od[8], e[8], step[8];
#pragma unroll
    for (int m = 0; m < 8; ++m) {
        const int p = lane + 32 * m;
        step[m] = (255 - p) % 255;
        ev[m] = od[m] = e[m] = 0;
    }
    for (int k = 0; k <= deg; ++k) {
        const int l = llam[k];
        if (l != RS_NOLOG) {
#pragma unroll
            for (int m = 0; m < 8; ++m) {
                const int v = ex[l + e[m]];
                if (k & 1) od[m] ^= v; else ev[m] ^= v;
            }
        }
#pragma unroll
        for (int m = 0; m < 8; ++m) {
            e[m] += step[m];
            if (e[m] >= 255) e[m] -= 255;
        }
    }
    int nroots = 0;
    unsigned roots[8];
#pragma unroll
    for (int m = 0; m < 8; ++m) {
        roots[m] = __ballot_sync(0xffffffffu, lane + 32 * m < RS_N && ev[m] == od[m]);
        nroots += __popc(roots[m]);
    }
    if (nroots != L) return -1;

    // ---- the roots, in order of position --------------------------------
    const unsigned below = (1u << lane) - 1u;
    int at = 0;
#pragma unroll
    for (int m = 0; m < 8; ++m) {
        if ((roots[m] >> lane) & 1u) {
            const int q = at + __popc(roots[m] & below);
            rootp[q] = lane + 32 * m;
            rodd[q] = od[m];
        }
        at += __popc(roots[m]);
    }

    // ---- Omega = S(x) Lambda(x) mod x^32, coefficient `lane` -------------
    int om = 0;
    for (int i = 0; i <= lane; ++i) {
        const int a = lsyn[i], c = llam[lane - i];
        if (a != RS_NOLOG && c != RS_NOLOG) om ^= ex[a + c];
    }
    lom[lane] = om ? lg[om] : RS_NOLOG;
    __syncwarp();

    // ---- Forney at root `lane`: e = X^(1-FCR) Omega(X) / Lambda'(X) ------
    if (lane < L) {
        const int p = rootp[lane];
        const int stp = (255 - p) % 255;
        int num = 0, ek = 0;
        for (int k = 0; k < RS_T2; ++k) {
            const int o = lom[k];
            if (o != RS_NOLOG) num ^= ex[o + ek];
            ek += stp;
            if (ek >= 255) ek -= 255;
        }
        const int odd = rodd[lane];
        if (odd != 0 && num != 0) {
            const int xpow = (p * (255 - (RS_FCR - 1))) % 255;   // X^(1-FCR)
            const int n2 = ex[lg[num] + xpow];
            int ldl = lg[odd] + p;                  // Lambda' = odd / X
            if (ldl >= 255) ldl -= 255;
            const size_t at = (size_t)(r / G) * (RS_N * G) + r % G + (size_t)(RS_N - 1 - p) * G;
            out[at] = in[at] ^ tal[ex[lg[n2] + 255 - ldl]];
        }
    }
    return L;
}

// in / out: B codewords as G-interleaved rows (G = 1: (B, 255); G = 4:
// (B / 4, 1020)); nerr (B,) i32: corrected symbols, 0 for a clean
// codeword, -1 where decoding fails (the codeword then comes out as
// received); tables: RS_TABLE_BYTES from ops/rs_cuda.py.
template <int G>
__global__ void __launch_bounds__(RS_THREADS, RS_BLOCKS_PER_SM)
rs_decode_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                 int* __restrict__ nerr, const uint8_t* __restrict__ tables, int B) {
    extern __shared__ __align__(16) uint8_t smem[];
    const uint2* frag = reinterpret_cast<const uint2*>(smem);
    const uint8_t* ex = smem + RS_FRAG_BYTES;
    const uint8_t* tal = ex + 768;
    uint8_t* raw = smem + RS_TABLE_BYTES;
    uint32_t* bits = reinterpret_cast<uint32_t*>(raw + RS_RAW_BYTES);
    uint8_t* syn = reinterpret_cast<uint8_t*>(bits + RS_TILE * RS_ROW_WORDS);
    uint8_t* qsyn = syn + RS_TILE * RS_T2;   // the queued rows' syndromes
    uint8_t* scratch = qsyn + RS_QUEUE * RS_T2;
    int* qrow = reinterpret_cast<int*>(scratch + RS_WARPS * RS_SCRATCH);   // their rows
    int* qlen = qrow + RS_QUEUE;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const bool vec = ((reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out)) & 15)
                     == 0;

    for (int i = tid; i < RS_TABLE_BYTES / 16; i += RS_THREADS)
        reinterpret_cast<uint4*>(smem)[i] = reinterpret_cast<const uint4*>(tables)[i];
    if (tid == 0) *qlen = 0;
    const uint8_t* lg = ex + 512;
    // The queued rows, one warp a row.
    auto correct = [&](int nq) {
        for (int q = warp; q < nq; q += RS_WARPS) {
            const int r = qrow[q];
            const int n = correct_row<G>(r, qsyn[q * RS_T2 + lane], in, out, ex, lg, tal,
                                         scratch + warp * RS_SCRATCH, lane);
            if (lane == 0) nerr[r] = n;
            __syncwarp();
        }
    };

    const int tiles = (B + RS_TILE - 1) / RS_TILE;
    int nq = 0;                                 // rows queued (the same on every thread)
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int rows = min(RS_TILE, B - tile * RS_TILE);
        const int nbytes = rows * RS_N;
        const size_t base = (size_t)tile * RS_TILE_BYTES;
        // ---- the tile in: a 16-byte vector a thread (255 of them) --------
        const int head = vec ? nbytes & ~15 : 0;
        if (tid < head / 16)
            reinterpret_cast<uint4*>(raw)[tid] = reinterpret_cast<const uint4*>(in + base)[tid];
        for (int i = head + tid; i < RS_RAW_BYTES; i += RS_THREADS)
            raw[i] = i < nbytes ? in[base + i] : 0;
        __syncthreads();

        // ---- as 16 rows of bits (byte 255 of a row is 0) ----------------
        for (int i = tid; i < RS_TILE * 64; i += RS_THREADS) {
            const int r = i >> 6, w = i & 63;
            uint32_t v = 0;
#pragma unroll
            for (int b = 0; b < 4; ++b) {
                const int j = 4 * w + b;
                if (j < RS_N) v |= (uint32_t)raw[tile_byte<G>(r, j)] << (8 * b);
            }
            bits[r * RS_ROW_WORDS + w] = v;
        }
        __syncthreads();

        // ---- syndromes: warp w takes S_(RS_NT w) ... S_(RS_NT w + RS_NT - 1)
        {
            int acc[RS_NT][4] = {};
            const uint32_t* ra = bits + g * RS_ROW_WORDS + t;
            const uint32_t* rb = ra + 8 * RS_ROW_WORDS;
#pragma unroll
            for (int c = 0; c < 8; ++c) {
                const uint32_t a0 = ra[8 * c], a1 = rb[8 * c], a2 = ra[8 * c + 4],
                               a3 = rb[8 * c + 4];
#pragma unroll
                for (int n = 0; n < RS_NT; ++n)
                    mma_b1(acc[n], a0, a1, a2, a3,
                           frag[((RS_NT * warp + n) * 8 + c) * 32 + lane]);
            }
#pragma unroll
            for (int n = 0; n < RS_NT; ++n) {
                // c0, c1: row g, bits 2t and 2t + 1; c2, c3: row g + 8.
                uint32_t lo = ((acc[n][0] & 1) | (acc[n][1] & 1) << 1) << (2 * t);
                uint32_t hi = ((acc[n][2] & 1) | (acc[n][3] & 1) << 1) << (2 * t);
                lo |= __shfl_xor_sync(0xffffffffu, lo, 1);
                hi |= __shfl_xor_sync(0xffffffffu, hi, 1);
                lo |= __shfl_xor_sync(0xffffffffu, lo, 2);
                hi |= __shfl_xor_sync(0xffffffffu, hi, 2);
                if (t == 0) {
                    syn[g * RS_T2 + RS_NT * warp + n] = (uint8_t)lo;
                    syn[(g + 8) * RS_T2 + RS_NT * warp + n] = (uint8_t)hi;
                }
            }
        }
        __syncthreads();

        // ---- the tile out as received; its errored rows to the queue ----
        if (tid < head / 16)
            reinterpret_cast<uint4*>(out + base)[tid] = reinterpret_cast<const uint4*>(raw)[tid];
        for (int i = head + tid; i < nbytes; i += RS_THREADS) out[base + i] = raw[i];
        if (warp == 0) {
            bool err = false;
            if (lane < rows) {
                const uint4* s = reinterpret_cast<const uint4*>(syn + lane * RS_T2);
                const uint4 u = s[0], v = s[1];
                err = (u.x | u.y | u.z | u.w | v.x | v.y | v.z | v.w) != 0;
                if (!err) nerr[tile * RS_TILE + lane] = 0;
            }
            const unsigned m = __ballot_sync(0xffffffffu, err);
            const int q0 = *qlen;
            if (err) {
                const int q = q0 + __popc(m & ((1u << lane) - 1u));
                qrow[q] = tile * RS_TILE + lane;
                const uint4* s = reinterpret_cast<const uint4*>(syn + lane * RS_T2);
                uint4* d = reinterpret_cast<uint4*>(qsyn + q * RS_T2);
                d[0] = s[0];
                d[1] = s[1];
            }
            __syncwarp();
            if (lane == 0) *qlen = q0 + __popc(m);
        }
        __syncthreads();

        // ---- a full queue is corrected, one warp a row -------------------
        nq = *qlen;
        if (nq >= RS_FLUSH) {
            correct(nq);
            nq = 0;
            __syncthreads();                    // every warp done with the queue
            if (tid == 0) *qlen = 0;
        }
    }
    correct(nq);                                // the rest, once the tiles are out
}

#define RS_MAX_DEVICES 64

template <int G>
static int launch(const void* in, void* out, void* nerr, const void* tables, int B,
                  cudaStream_t stream) {
    // Once a device: its SM count, and a block's shared memory over 48 KiB.
    static int sms[RS_MAX_DEVICES];
    int dev = 0;
    int err = (int)cudaGetDevice(&dev);
    if (err) return err;
    if (dev < 0 || dev >= RS_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    if (sms[dev] == 0) {
        err = (int)cudaFuncSetAttribute(rs_decode_kernel<G>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, RS_SMEM);
        if (err) return err;
        int n = 0;
        err = (int)cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
        if (err) return err;
        sms[dev] = n;
    }
    const int tiles = (B + RS_TILE - 1) / RS_TILE;
    const int grid = tiles < RS_BLOCKS_PER_SM * sms[dev] ? tiles : RS_BLOCKS_PER_SM * sms[dev];
    rs_decode_kernel<G><<<grid, RS_THREADS, RS_SMEM, stream>>>(
        (const uint8_t*)in, (uint8_t*)out, (int*)nerr, (const uint8_t*)tables, B);
    return (int)cudaGetLastError();
}

// B codewords, (B, 255) u8 dual basis in and out.
extern "C" int xrit_rs_decode(const void* in, void* out, void* nerr, const void* tables,
                              int B, void* stream) {
    if (B < 1) return (int)cudaErrorInvalidValue;
    return launch<1>(in, out, nerr, tables, B, (cudaStream_t)stream);
}

// F frames, (F, 1020) u8 in and out (codeword i: bytes i, i + 4, ...);
// nerr (F, 4).
extern "C" int xrit_rs_decode_frames(const void* in, void* out, void* nerr, const void* tables,
                                     int F, void* stream) {
    if (F < 1 || F > (1 << 29)) return (int)cudaErrorInvalidValue;
    return launch<4>(in, out, nerr, tables, 4 * F, (cudaStream_t)stream);
}
