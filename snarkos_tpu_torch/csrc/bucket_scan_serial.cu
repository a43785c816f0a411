// Kernel B4: per-chain serial segmented inclusive scan of sorted affine
// points with the complete mixed addition. Inputs xs, ys are (24, m, K) limb
// tensors and flags (1, m, K); chain k owns the sorted run [k m, (k+1) m),
// laid out at column k, rows 0..m-1. The running sum resets to the input
// point at every segment head; every position's value is written out.
//
// Replaces the TPU kernel snarkos_tpu/ops/msm_pallas.py `bucket_scan_serial`
// / `_scan_kernel_serial` (lines 219-273). There the sequential grid carries
// the running sums in VMEM scratch from one step to the next; a CUDA block
// carries nothing, so here one thread owns one chain and walks its m points
// with the running Jacobian sum in registers (36 words plus temporaries).
//
// Bound on this card: 32-bit integer multiplies (11 Fq products of 300 word
// products per non-head position; 6 more where P == Q). At the path's shape
// (m = 128, K = 256) there are only 256 threads for 132 SMs: the launch is
// bound by the latency of one thread's 128 dependent mixed additions, not by
// the card's multiply rate (see PERF.md).
#include "g1.cuh"

using namespace snark;

__global__ void bucket_scan_serial_kernel(const int32_t* __restrict__ xs,
                                          const int32_t* __restrict__ ys,
                                          const int32_t* __restrict__ flags,
                                          int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                                          int32_t* __restrict__ oz, int64_t m, int64_t K) {
    const int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (k >= K) return;
    const int64_t n = m * K;  // row stride of a limb in the (24, m, K) layout
    Jac acc, nxt;
#pragma unroll
    for (int i = 0; i < 12; ++i) acc.x[i] = acc.y[i] = acc.z[i] = 0;  // identity
    for (int64_t j = 0; j < m; ++j) {
        const int64_t e = j * K + k;
        uint32_t qx[12], qy[12];
        load<Fq>(qx, xs, n, e);
        load<Fq>(qy, ys, n, e);
        if (flags[e] != 0) {
            copy<Fq>(acc.x, qx);
            copy<Fq>(acc.y, qy);
#pragma unroll
            for (int i = 0; i < 12; ++i) acc.z[i] = FQ_ONE[i];
        } else {
            g1_madd(nxt, acc, qx, qy);
            acc = nxt;
        }
        store_point(ox, oy, oz, acc, n, e);
    }
}

extern "C" int bucket_scan_serial(const int32_t* xs, const int32_t* ys, const int32_t* flags,
                                  int32_t* ox, int32_t* oy, int32_t* oz, int64_t m, int64_t K,
                                  void* stream) {
    constexpr int threads = 32;
    const int64_t blocks = (K + threads - 1) / threads;
    bucket_scan_serial_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                                static_cast<cudaStream_t>(stream)>>>(xs, ys, flags, ox, oy, oz,
                                                                     m, K);
    return static_cast<int>(cudaGetLastError());
}
