// Hand-offs between the warps of one block: mbarriers in shared memory, and
// cp.async copies that report to them.  Shared by frontend.cu and clock.cu.
//
// A ring of N slots has a "full" and a "free" barrier per slot.  The i-th
// use of a slot is its turn u = i / N.  A consumer waits for full with
// parity u & 1; a producer waits for free with parity (u & 1) ^ 1, which
// passes at once on a fresh barrier (turn 0 finds the slot free).  Arrivals
// release and waits acquire at block scope, so what a warp wrote to shared
// memory before it arrived is visible to the warp whose wait returned.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int arrivals) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(smem_addr(bar)), "r"(arrivals) : "memory");
}

// After the last mbar_init and before the __syncthreads that publishes them.
__device__ __forceinline__ void mbar_init_fence() {
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                 :: "r"(smem_addr(bar)) : "memory");
}

// An arrival that fires once every cp.async this thread has started so far
// has landed.  It does not raise the barrier's pending count, so it is one
// of the arrivals the barrier was initialised with.
__device__ __forceinline__ void mbar_arrive_on_copies(uint64_t* bar) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
                 :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    return done != 0;
}

// A debug build (-DXRIT_STAGE_CLOCKS, made by `_build.stage_clocks`) counts,
// for block 0, the cycles each warp spends inside mbar_wait and the cycles of
// its whole role: the stage whose warp hardly waits sets the kernel's time.
#ifdef XRIT_STAGE_CLOCKS
__device__ unsigned long long xrit_wait_cycles[32];
__device__ unsigned long long xrit_role_cycles[32];

__device__ __forceinline__ long long role_clock_start() { return clock64(); }

__device__ __forceinline__ void role_clock_stop(long long t0) {
    if (blockIdx.x == 0 && (threadIdx.x & 31) == 0)
        xrit_role_cycles[threadIdx.x >> 5] = (unsigned long long)(clock64() - t0);
}

// Copies the two 32-entry tables out and clears the waits.
extern "C" int xrit_stage_clocks(unsigned long long* wait, unsigned long long* role) {
    int err = (int)cudaDeviceSynchronize();
    if (!err) err = (int)cudaMemcpyFromSymbol(wait, xrit_wait_cycles, sizeof(xrit_wait_cycles));
    if (!err) err = (int)cudaMemcpyFromSymbol(role, xrit_role_cycles, sizeof(xrit_role_cycles));
    const unsigned long long zeros[32] = {0};
    if (!err) err = (int)cudaMemcpyToSymbol(xrit_wait_cycles, zeros, sizeof(zeros));
    return err;
}
#else
__device__ __forceinline__ long long role_clock_start() { return 0; }
__device__ __forceinline__ void role_clock_stop(long long) {}
#endif

// A wait that never returns is a fault of the kernel's design; after
// MBAR_WAIT_LIMIT_NS of polling it becomes a launch error instead of a hung
// device.  The clock is read once per 1024 polls only.
#define MBAR_WAIT_LIMIT_NS 4000000000ull

__device__ __forceinline__ uint64_t global_timer_ns() {
    uint64_t t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
#ifdef XRIT_STAGE_CLOCKS
    const long long c0 = clock64();
#endif
    uint32_t spins = 0;
    uint64_t t0 = 0;
    while (!mbar_try_wait(bar, parity)) {
        if ((++spins & 1023u) == 0) {
            const uint64_t now = global_timer_ns();
            if (t0 == 0) t0 = now;
            else if (now - t0 > MBAR_WAIT_LIMIT_NS) __trap();
        }
    }
#ifdef XRIT_STAGE_CLOCKS
    if (blockIdx.x == 0 && (threadIdx.x & 31) == 0)
        atomicAdd(&xrit_wait_cycles[threadIdx.x >> 5], (unsigned long long)(clock64() - c0));
#endif
}

__device__ __forceinline__ void cp_async_f32(float* dst_shared, const float* src_global) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                 :: "r"(smem_addr(dst_shared)), "l"(src_global) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;" ::: "memory");
}

// Shared-memory access at a 32-bit shared address (smem_addr) plus a constant
// byte offset.  A chain warp takes its addresses once, before its loop, and
// the loop body then holds no address conversion.
template <int OFFSET>
__device__ __forceinline__ float lds_f32(uint32_t addr) {
    float v;
    asm volatile("ld.shared.f32 %0, [%1+%2];" : "=f"(v) : "r"(addr), "n"(OFFSET));
    return v;
}

template <int OFFSET>
__device__ __forceinline__ void sts_f32(uint32_t addr, float v) {
    asm volatile("st.shared.f32 [%0+%1], %2;" :: "r"(addr), "n"(OFFSET), "f"(v) : "memory");
}

// Barrier `id` (1..15) among `threads` threads of the block (whole warps).
__device__ __forceinline__ void named_barrier(int id, int threads) {
    asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(threads) : "memory");
}
