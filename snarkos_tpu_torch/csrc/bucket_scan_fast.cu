// Kernel B6: the segmented bucket scan of kernel B5 (bucket_scan.cu, same
// chain layout) with the INCOMPLETE mixed addition, 11 Fq multiplies a step
// against up to 17, and a sticky per-chain exception flag. A step where the
// running sum P and the input Q have P == +-Q gives garbage (with Z = 0) and
// raises the chain's flag, unless the step is a segment head (its sum is
// overwritten) or its bucket key is 0 (`nonzero` == 0: bucket 0 is dropped
// downstream, and the scan and the cross-chain carries reset at every head, so
// its garbage never reaches a live bucket). exc is (1, chunk, K): entry
// r K + k is chain r K + k's flag. The caller reruns the complete engine (B5)
// when any flag is set.
//
// Replaces the TPU kernel snarkos_tpu/ops/msm_pallas.py `bucket_scan_fast` /
// `_scan_kernel_fast` (lines 94-169). There the flag lives in VMEM scratch
// and the whole (1, chunk, K) block is written back at every grid step; here
// each thread keeps its chain's flag in a register and writes it once, after
// its last step. One thread owns one chain (thread t = r K + k reads element i
// at flat position i chunk K + t), as in B5.
//
// Bound on this card: 32-bit integer multiplies (11 Fq products of 300 word
// products per non-head position). 32-thread blocks put one warp on each of
// up to 128 SMs for the 4096 chains of a 2^20-point MSM; the launch is bound
// by one thread's 256 dependent additions (see PERF.md).
#include "g1.cuh"

using namespace snark;

// Out of line on purpose: with g1_madd_incomplete inlined into the scan loop,
// cicc of nvcc 12.9 crashes (segmentation fault); the call builds.
__device__ __noinline__ bool madd_step(Jac& o, const Jac& p, const uint32_t* qx,
                                       const uint32_t* qy) {
    return g1_madd_incomplete(o, p, qx, qy);
}

__global__ void bucket_scan_fast_kernel(const int32_t* __restrict__ xs,
                                        const int32_t* __restrict__ ys,
                                        const int32_t* __restrict__ flags,
                                        const int32_t* __restrict__ nonzero,
                                        int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                                        int32_t* __restrict__ oz, int32_t* __restrict__ exc,
                                        int64_t m, int64_t K, int64_t chunk) {
    const int64_t kv = chunk * K;
    const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (t >= kv) return;
    const int64_t n = m * K;  // row stride of a limb in the (24, m, K) layout
    const int64_t mv = m / chunk;
    Jac acc, nxt;
#pragma unroll
    for (int i = 0; i < 12; ++i) acc.x[i] = acc.y[i] = acc.z[i] = 0;  // identity
    int32_t flag = 0;
    for (int64_t i = 0; i < mv; ++i) {
        const int64_t e = i * kv + t;
        uint32_t qx[12], qy[12];
        load<Fq>(qx, xs, n, e);
        load<Fq>(qy, ys, n, e);
        if (flags[e] != 0) {
            copy<Fq>(acc.x, qx);
            copy<Fq>(acc.y, qy);
#pragma unroll
            for (int w = 0; w < 12; ++w) acc.z[w] = FQ_ONE[w];
        } else {
            if (madd_step(nxt, acc, qx, qy) && nonzero[e] != 0) flag = 1;
            acc = nxt;
        }
        store_point(ox, oy, oz, acc, n, e);
    }
    exc[t] = flag;
}

extern "C" int bucket_scan_fast(const int32_t* xs, const int32_t* ys, const int32_t* flags,
                                const int32_t* nonzero, int32_t* ox, int32_t* oy, int32_t* oz,
                                int32_t* exc, int64_t m, int64_t K, int64_t chunk, void* stream) {
    constexpr int threads = 32;
    const int64_t blocks = (chunk * K + threads - 1) / threads;
    bucket_scan_fast_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(xs, ys, flags, nonzero, ox,
                                                                   oy, oz, exc, m, K, chunk);
    return static_cast<int>(cudaGetLastError());
}
