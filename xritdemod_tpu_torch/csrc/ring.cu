// Per-channel symbol ring between demodulator and decoder: append at the
// fill offset, frame-aligned pop at the sync position.
//
// Replaces the Pallas kernels _append_kernel / _extract_kernel of
// xritdemod_tpu/ops/ring_pallas.py, which barrel-roll whole VMEM rows.
// Here each kernel moves only the slots its function must touch, with
// 16-byte accesses.  Both are bound by bytes:
//
//   - append reads a channel's n new float32 symbols and writes them at its
//     fill offset.  Neither end is 16-byte aligned (the source row starts at
//     c * S, the destination at fill[c]), so each thread loads the aligned
//     16-byte source vectors that cover its 16-byte destination vector and
//     funnel-shifts them into place (`Span` below); the middle of a span is
//     written with aligned 16-byte stores, its ragged ends one element at a
//     time.  A thread keeps RING_VPT such vectors in flight, and the grid is
//     sized by the work: (units of the longest row / RING_THREADS /
//     RING_VPT, C) blocks.
//
//   - extract works IN PLACE and touches only [0, fill) of each channel:
//     it reads [pos, pos + E) into `out`, moves [pos + E, fill) to the
//     front and zeroes what that vacates up to the old fill.  Slots at and
//     past fill are left alone: the ring's invariant (ring[c, fill[c]:] ==
//     0, which every append keeps) holds them at zero.  The shift to the
//     left is safe because slot i is stored from slot i + drop (drop =
//     pos + E >= 0): one thread-block cluster per channel (RING_CLUSTER
//     blocks; four time 1-4 % below one block and 4-8 % below eight on an
//     NVIDIA H100 80GB HBM3 at 700 W, `tools/kernel_probe.py ring`) sweeps
//     the row in ascending steps, each step loading all its sources before
//     a cluster barrier and storing after it, so a slot is never stored
//     before every thread has loaded it.  Blocks that are not so ordered must not share a channel.  A fill
//     past L is read as L, so a stale fill cannot reach past a row.
//
// The ring is stored as float32 or, as the Pallas kernels allow, bfloat16
// (the template's Sym): append rounds the float32 symbols to the ring's type
// (to nearest even, as `Tensor.to` does), extract widens what it pops to
// float32 (exactly), as the Pallas kernels convert at the edge of fast
// memory.  A bf16 ring moves half the bytes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sync.cuh"

// Threads of a block; 16-byte destination vectors a thread per step.
#define RING_THREADS 256
#define RING_VPT 4
// Blocks that share a channel of the extract (a thread-block cluster).
#define RING_CLUSTER 4
// 1: the append's blocks bring their source span into shared memory with
// one bulk copy (TMA) and realign from there.
#define RING_APPEND_TMA 0
// 1: the extract's sweep stages each step's source vectors in shared memory
// (each loaded once, 16 bytes a thread) and realigns from there.
#define RING_EXTRACT_STAGE 0

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <class Sym>
__device__ __forceinline__ Sym narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}

// ---------------------------------------------------------------------------
// A span: destination elements d[0, n) take s[i] for i < keep and zero past
// it.  The destination is cut into a head (up to its first 16-byte
// boundary), whole units of U elements (16-byte aligned: ND vectors of the
// destination, NS of the source and, where the source is misaligned, one
// more) and a tail.  A unit's source vectors are loaded as 32-bit words;
// the unit's U elements start r elements into them.
// ---------------------------------------------------------------------------

template <int Q, int SW, int NW>
__device__ __forceinline__ void take(const uint32_t (&w)[NW], uint32_t (&o)[SW]) {
#pragma unroll
    for (int i = 0; i < SW; ++i) o[i] = w[Q + i];
}

template <int Q, int SW, int NW>
__device__ __forceinline__ void funnel(const uint32_t (&w)[NW], uint32_t (&o)[SW], uint32_t sh) {
#pragma unroll
    for (int i = 0; i < SW; ++i) o[i] = __funnelshift_r(w[Q + i], w[Q + i + 1], sh);
}

// o = the SW words of source elements that start r elements into w.  r is
// the same for every unit of a span, so the switch does not diverge.
template <class SrcT, int SW, int NW>
__device__ __forceinline__ void shifted(const uint32_t (&w)[NW], int r, uint32_t (&o)[SW]) {
    if constexpr (sizeof(SrcT) == 4) {
        switch (r) {
            case 0: take<0>(w, o); break;
            case 1: take<1>(w, o); break;
            case 2: take<2>(w, o); break;
            default: take<3>(w, o); break;
        }
    } else {                      // two elements a word: whole words, then half a word
        const uint32_t sh = (r & 1) * 16;
        switch (r >> 1) {
            case 0: funnel<0>(w, o, sh); break;
            case 1: funnel<1>(w, o, sh); break;
            case 2: funnel<2>(w, o, sh); break;
            default: funnel<3>(w, o, sh); break;
        }
    }
}

// Source words to destination words: the same type, float32 -> bf16 (to
// nearest even) or bf16 -> float32 (exact).
template <class SrcT, class DstT, int SW, int DW>
__device__ __forceinline__ void convert(const uint32_t (&o)[SW], uint32_t (&d)[DW]) {
    if constexpr (sizeof(SrcT) == sizeof(DstT)) {
#pragma unroll
        for (int i = 0; i < DW; ++i) d[i] = o[i];
    } else if constexpr (sizeof(SrcT) == 4) {
#pragma unroll
        for (int i = 0; i < DW; ++i)
            d[i] = (uint32_t)__bfloat16_as_ushort(narrow<__nv_bfloat16>(__uint_as_float(o[2 * i])))
                 | ((uint32_t)__bfloat16_as_ushort(
                        narrow<__nv_bfloat16>(__uint_as_float(o[2 * i + 1]))) << 16);
    } else {
#pragma unroll
        for (int i = 0; i < SW; ++i) {
            d[2 * i] = o[i] << 16;
            d[2 * i + 1] = o[i] & 0xffff0000u;
        }
    }
}

// Zero destination elements lim.. of a unit.
template <class DstT, int DW>
__device__ __forceinline__ void zero_from(uint32_t (&d)[DW], int lim) {
#pragma unroll
    for (int i = 0; i < DW; ++i) {
        if constexpr (sizeof(DstT) == 4) {
            if (i >= lim) d[i] = 0;
        } else {
            if (2 * i >= lim) d[i] = 0;
            else if (2 * i + 1 >= lim) d[i] &= 0xffffu;
        }
    }
}

template <class SrcT, class DstT>
struct Span {
    static constexpr int WS = 16 / (int)sizeof(SrcT), WD = 16 / (int)sizeof(DstT);
    static constexpr int U = WS > WD ? WS : WD;       // elements of a unit
    static constexpr int NS = U / WS, ND = U / WD;    // 16-byte vectors of a unit
    static constexpr int NW = 4 * (NS + 1);           // words loaded for a unit
    static constexpr int SW = U * (int)sizeof(SrcT) / 4, DW = 4 * ND;

    DstT* d;
    const SrcT* s;
    int n, keep, head, units, r;
    const uint4* sa;      // the aligned source vector that holds s[head]
    uint4* da;            // d + head

    __device__ __forceinline__ Span(DstT* d_, const SrcT* s_, int n_, int keep_)
        : d(d_), s(s_), n(n_), keep(keep_) {
        head = (int)(((16 - ((uintptr_t)d & 15)) & 15) / sizeof(DstT));
        if (head > n) head = n;
        units = (n - head) / U;
        const uintptr_t sp = (uintptr_t)(s + head);
        r = (int)((sp & 15) / sizeof(SrcT));
        sa = (const uint4*)(sp - (sp & 15));
        da = (uint4*)(d + head);
    }

    // Source elements of unit j that are kept (<= 0: none, >= U: all).
    __device__ __forceinline__ int kept(int j) const { return keep - head - j * U; }

    // Does aligned source vector v (sa[v]) hold a kept element?
    __device__ __forceinline__ bool holds_kept(int v) const {
        return max(0, v * WS - r) < keep - head;
    }

    // Is source vector m of unit j needed?  Its first element the unit uses
    // is max(0, m * WS - r); the one past the last (m = NS) only if r > 0.
    __device__ __forceinline__ bool needs(int j, int m) const {
        return (m < NS || r > 0) && max(0, m * WS - r) < kept(j);
    }

    __device__ __forceinline__ void load(int j, uint32_t (&w)[NW]) const {
#pragma unroll
        for (int m = 0; m <= NS; ++m) {
            uint4 v = make_uint4(0, 0, 0, 0);
            if (needs(j, m)) v = sa[j * NS + m];
            w[4 * m] = v.x; w[4 * m + 1] = v.y; w[4 * m + 2] = v.z; w[4 * m + 3] = v.w;
        }
    }

    __device__ __forceinline__ void store(int j, const uint32_t (&w)[NW]) const {
        const int lim = kept(j);
        uint32_t o[SW], dw[DW];
        if (lim > 0) {
            shifted<SrcT>(w, r, o);
            convert<SrcT, DstT>(o, dw);
            if (lim < U) zero_from<DstT>(dw, lim);
        } else {
#pragma unroll
            for (int i = 0; i < DW; ++i) dw[i] = 0;
        }
#pragma unroll
        for (int m = 0; m < ND; ++m)
            da[j * ND + m] = make_uint4(dw[4 * m], dw[4 * m + 1], dw[4 * m + 2], dw[4 * m + 3]);
    }

    // The ragged ends, one element at a time: i-th of the head, then of the tail.
    __device__ __forceinline__ int ragged() const { return head + (n - head - units * U); }
    __device__ __forceinline__ int ragged_index(int i) const {
        return i < head ? i : head + units * U + (i - head);
    }
    __device__ __forceinline__ DstT ragged_value(int i) const {
        const int e = ragged_index(i);
        return e < keep ? narrow<DstT>(widen(s[e])) : narrow<DstT>(0.0f);
    }
    __device__ __forceinline__ void ragged_store(int i, DstT v) const { d[ragged_index(i)] = v; }
};

// ---------------------------------------------------------------------------
// K4a, append: ring (C, L) updated in place; new (C, S) float32; fill, n
// (C,) -> fill_out, ovf.  Block (b, c) moves units [b, b + 1) *
// RING_THREADS * RING_VPT of channel c; block 0 also the ragged ends.
// ---------------------------------------------------------------------------

template <class Sym>
__global__ void __launch_bounds__(RING_THREADS)
ring_append_kernel(Sym* __restrict__ ring, const float* __restrict__ nw,
                   const int* __restrict__ fill, const int* __restrict__ n,
                   int* __restrict__ fill_out, int* __restrict__ ovf, int L, int S) {
    using Sp = Span<float, Sym>;
    const int c = blockIdx.y, t = threadIdx.x;
    const int f = fill[c], k = n[c];
    const bool ok = f + k <= L;
    if (blockIdx.x == 0 && t == 0) {
        fill_out[c] = ok ? f + k : f;      // an overflowing block is dropped
        ovf[c] = ok ? 0 : 1;
    }
    if (!ok || k <= 0) return;
    const Sp sp(ring + (size_t)c * L + f, nw + (size_t)c * S, k, k);
    const int j0 = blockIdx.x * RING_THREADS * RING_VPT;
    if (j0 >= sp.units && blockIdx.x > 0) return;
    if (blockIdx.x == 0 && t < sp.ragged()) sp.ragged_store(t, sp.ragged_value(t));
#if RING_APPEND_TMA
    // The block's source vectors, [v0, v1), in one bulk copy; then each
    // unit's words come from shared memory.
    extern __shared__ __align__(16) uint4 stage[];
    __shared__ __align__(8) uint64_t bar;
    const int jl = min(sp.units, j0 + RING_THREADS * RING_VPT) - 1;   // last unit
    if (jl < j0) return;
    const int v0 = j0 * Sp::NS;
    const int v1 = jl * Sp::NS + (sp.needs(jl, Sp::NS) ? Sp::NS + 1 : Sp::NS);
    if (t == 0) {
        mbar_init(&bar, 1);
        mbar_init_fence();
    }
    __syncthreads();
    if (t == 0) {
        const uint32_t bytes = (uint32_t)(v1 - v0) * 16u;
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                     :: "r"(smem_addr(&bar)), "r"(bytes) : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
            " [%0], [%1], %2, [%3];"
            :: "r"(smem_addr(stage)), "l"(sp.sa + v0), "r"(bytes), "r"(smem_addr(&bar))
            : "memory");
    }
    mbar_wait(&bar, 0);
#pragma unroll
    for (int v = 0; v < RING_VPT; ++v) {
        const int j = j0 + v * RING_THREADS + t;
        if (j >= sp.units) break;
        uint32_t w[Sp::NW];
#pragma unroll
        for (int m = 0; m <= Sp::NS; ++m) {
            uint4 q = make_uint4(0, 0, 0, 0);
            if (sp.needs(j, m)) q = stage[j * Sp::NS + m - v0];
            w[4 * m] = q.x; w[4 * m + 1] = q.y; w[4 * m + 2] = q.z; w[4 * m + 3] = q.w;
        }
        sp.store(j, w);
    }
#else
    uint32_t w[RING_VPT][Sp::NW];
#pragma unroll
    for (int v = 0; v < RING_VPT; ++v) {
        const int j = j0 + v * RING_THREADS + t;
        if (j < sp.units) sp.load(j, w[v]);
    }
#pragma unroll
    for (int v = 0; v < RING_VPT; ++v) {
        const int j = j0 + v * RING_THREADS + t;
        if (j < sp.units) sp.store(j, w[v]);
    }
#endif
}

// ---------------------------------------------------------------------------
// K4b, extract in place: ring (C, L); fill, pos (C,) -> out (C, E) float32,
// fill_out, ok.  RING_CLUSTER blocks a channel, in one cluster.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void channel_barrier() {
#if RING_CLUSTER > 1
    asm volatile("barrier.cluster.arrive.release.aligned;\n"
                 "barrier.cluster.wait.acquire.aligned;" ::: "memory");
#else
    __syncthreads();
#endif
}

template <class Sym>
__global__ void __launch_bounds__(RING_THREADS)
ring_extract_kernel(Sym* ring, const int* __restrict__ fill, const int* __restrict__ pos,
                    float* __restrict__ out, int* __restrict__ fill_out,
                    int* __restrict__ okf, int L, int E) {
    constexpr int T = RING_THREADS, CL = RING_CLUSTER;
    const int c = blockIdx.x / CL, rank = blockIdx.x % CL, t = threadIdx.x;
    const int f = min(fill[c], L), p = pos[c];
    const bool ok = f >= p + E;
    const int start = ok ? p : 0;          // first slot handed out
    const int drop = ok ? p + E : 0;       // slots removed from the front
    if (rank == 0 && t == 0) {
        fill_out[c] = f - drop;
        okf[c] = ok ? 1 : 0;
    }
    Sym* row = ring + (size_t)c * L;

    // out <- [start, start + E): no slot of the ring is written here, and
    // the sweep's first barrier orders these loads before its first store.
    {
        using Sp = Span<Sym, float>;
        const Sp sp(out + (size_t)c * E, row + start, E, E);
        if (rank == 0 && t < sp.ragged()) sp.ragged_store(t, sp.ragged_value(t));
        for (int j0 = rank * T + t; j0 < sp.units; j0 += CL * T * RING_VPT) {
            uint32_t w[RING_VPT][Sp::NW];
#pragma unroll
            for (int v = 0; v < RING_VPT; ++v) {
                const int j = j0 + v * CL * T;
                if (j < sp.units) sp.load(j, w[v]);
            }
#pragma unroll
            for (int v = 0; v < RING_VPT; ++v) {
                const int j = j0 + v * CL * T;
                if (j < sp.units) sp.store(j, w[v]);
            }
        }
    }
    if (!ok) return;                       // not ok: nothing moves (a whole cluster returns)

    // [0, f) <- [drop, f) then zeros, in ascending steps of CL * T * RING_VPT
    // units: every source of a step is loaded before the barrier, every
    // destination stored after it.  A step's sources lie at or past its own
    // destinations (drop >= 0), so no earlier step has stored them.
    using Sp = Span<Sym, Sym>;
    const Sp sp(row, row + drop, f, f - drop);
    constexpr int STEP = CL * T * RING_VPT;
    const int steps = max(1, (sp.units + STEP - 1) / STEP);
    const int nr = sp.ragged();
#if RING_EXTRACT_STAGE
    // Two buffers of a step's source vectors (and the one after): a step
    // fills one while the threads of the step before may still read the
    // other; the barrier of the step between orders the reuse.
    static_assert(Sp::NS == 1, "one source vector a unit");
    __shared__ uint4 stage[2][STEP / CL + 1];
#endif
    for (int k = 0; k < steps; ++k) {
        const int j0 = k * STEP + rank * T + t;
        uint32_t w[RING_VPT][Sp::NW];
#if RING_EXTRACT_STAGE
        // This block's units of the step are [base, base + STEP / CL).
        const int base = k * STEP + rank * (STEP / CL);
        uint4* st = stage[k & 1];
        for (int i = t; i <= STEP / CL; i += T) {
            const int v = base + i;
            st[i] = v <= sp.units && sp.holds_kept(v) ? sp.sa[v] : make_uint4(0, 0, 0, 0);
        }
#else
#pragma unroll
        for (int v = 0; v < RING_VPT; ++v) {
            const int j = j0 + v * CL * T;
            if (j < sp.units) sp.load(j, w[v]);
        }
#endif
        // The head with the first step, the tail with the last: rank 0,
        // threads 0 .. nr - 1 (fewer than 2 U).
        const bool edge = rank == 0 && t < nr && (t < sp.head ? k == 0 : k == steps - 1);
        Sym e{};
        if (edge) e = sp.ragged_value(t);
        channel_barrier();
#pragma unroll
        for (int v = 0; v < RING_VPT; ++v) {
#if RING_EXTRACT_STAGE
            const int i = v * T + t, j = base + i;      // the block's units, in turn
            if (j < sp.units) {
                const uint4 a = st[i], b = st[i + 1];
                w[v][0] = a.x; w[v][1] = a.y; w[v][2] = a.z; w[v][3] = a.w;
                w[v][4] = b.x; w[v][5] = b.y; w[v][6] = b.z; w[v][7] = b.w;
                sp.store(j, w[v]);
            }
#else
            const int j = j0 + v * CL * T;
            if (j < sp.units) sp.store(j, w[v]);
#endif
        }
        if (edge) sp.ragged_store(t, e);
    }
}

// ---------------------------------------------------------------------------
// Launches.
// ---------------------------------------------------------------------------

template <class Sym>
static int append(void* ring, const void* nw, const void* fill, const void* n, void* fill_out,
                  void* ovf, int C, int L, int S, void* stream) {
    using Sp = Span<float, Sym>;
    // Units of the longest row (S symbols, at any alignment), then blocks.
    const int units = S / Sp::U + 1;
    const int per_block = RING_THREADS * RING_VPT;
    dim3 grid((units + per_block - 1) / per_block, C), block(RING_THREADS);
    size_t smem = 0;
#if RING_APPEND_TMA
    smem = (size_t)(per_block * Sp::NS + 1) * 16;
    cudaFuncSetAttribute(ring_append_kernel<Sym>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
#endif
    ring_append_kernel<Sym><<<grid, block, smem, (cudaStream_t)stream>>>(
        (Sym*)ring, (const float*)nw, (const int*)fill, (const int*)n,
        (int*)fill_out, (int*)ovf, L, S);
    return (int)cudaGetLastError();
}

template <class Sym>
static int extract(void* ring, const void* fill, const void* pos, void* out, void* fill_out,
                   void* ok, int C, int L, int E, void* stream) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(C * RING_CLUSTER);
    cfg.blockDim = dim3(RING_THREADS);
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = RING_CLUSTER;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = RING_CLUSTER > 1 ? 1 : 0;
    cudaError_t err = cudaLaunchKernelEx(
        &cfg, ring_extract_kernel<Sym>, (Sym*)ring, (const int*)fill, (const int*)pos,
        (float*)out, (int*)fill_out, (int*)ok, L, E);
    return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

extern "C" int xrit_ring_append(void* ring, const void* nw, const void* fill,
                                const void* n, void* fill_out, void* ovf,
                                int C, int L, int S, void* stream) {
    return append<float>(ring, nw, fill, n, fill_out, ovf, C, L, S, stream);
}

// In place: `ring` is updated, `out` (C, E) float32 receives the pop.
extern "C" int xrit_ring_extract(void* ring, const void* fill, const void* pos, void* out,
                                 void* fill_out, void* ok, int C, int L, int E, void* stream) {
    return extract<float>(ring, fill, pos, out, fill_out, ok, C, L, E, stream);
}

// The same on a bfloat16 ring.
extern "C" int xrit_ring_append_bf16(void* ring, const void* nw, const void* fill,
                                     const void* n, void* fill_out, void* ovf,
                                     int C, int L, int S, void* stream) {
    return append<__nv_bfloat16>(ring, nw, fill, n, fill_out, ovf, C, L, S, stream);
}

extern "C" int xrit_ring_extract_bf16(void* ring, const void* fill, const void* pos, void* out,
                                      void* fill_out, void* ok, int C, int L, int E,
                                      void* stream) {
    return extract<__nv_bfloat16>(ring, fill, pos, out, fill_out, ok, C, L, E, stream);
}
