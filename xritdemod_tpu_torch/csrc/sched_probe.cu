// Which warps of a block share a scheduler, and what sharing costs?  A
// standalone program (not one of the kernel libraries): warps a and b of one
// block run a loop of independent FMAs that alone keeps a scheduler busy,
// the other warps leave at once.  Prints, for blocks of 9, 13 and 16 warps
// and a = 3 and a = 0, warp a's cycles against every b.  A pair that shares
// a scheduler takes longer than a pair that does not; on an H100 those are
// the pairs with equal index mod 4.  The front end's and the clock's warp
// layouts (frontend.cu, clock.cu) rest on this.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o sched_probe sched_probe.cu
#include <cuda_runtime.h>
#include <stdio.h>

__global__ void probe(int a, int b, int iters, long long* out, float* sink) {
    const int w = threadIdx.x >> 5;
    if (w != a && w != b) return;
    float x0 = threadIdx.x, x1 = 1, x2 = 2, x3 = 3, x4 = 4, x5 = 5, x6 = 6, x7 = 7;
    const long long t0 = clock64();
    for (int i = 0; i < iters; ++i) {
        x0 = fmaf(x0, 1.0001f, 0.5f); x1 = fmaf(x1, 1.0001f, 0.5f);
        x2 = fmaf(x2, 1.0001f, 0.5f); x3 = fmaf(x3, 1.0001f, 0.5f);
        x4 = fmaf(x4, 1.0001f, 0.5f); x5 = fmaf(x5, 1.0001f, 0.5f);
        x6 = fmaf(x6, 1.0001f, 0.5f); x7 = fmaf(x7, 1.0001f, 0.5f);
    }
    const long long t1 = clock64();
    if (w == a && (threadIdx.x & 31) == 0) *out = t1 - t0;
    if (x0 + x1 + x2 + x3 + x4 + x5 + x6 + x7 == 12345.f) *sink = 1;
}

int main() {
    long long* out;
    float* sink;
    if (cudaMalloc(&out, 8) != cudaSuccess || cudaMalloc(&sink, 4) != cudaSuccess) return 1;
    const int sizes[] = {9, 13, 16}, firsts[] = {3, 0};
    for (int nw : sizes) {
        for (int a : firsts) {
            printf("{\"warps\": %d, \"a\": %d, \"kilocycles_by_b\": [", nw, a);
            for (int b = 0; b < nw; ++b) {
                long long h = 0;
                probe<<<1, nw * 32>>>(a, b, 20000, out, sink);
                if (cudaMemcpy(&h, out, 8, cudaMemcpyDeviceToHost) != cudaSuccess) return 1;
                printf("%s%lld", b ? ", " : "", h / 1000);
            }
            printf("]}\n");
        }
    }
    return 0;
}
