// Kernel B5: segmented inclusive scan of sorted affine points over KV =
// chunk * K independent virtual chains, with the complete mixed addition.
// Inputs xs, ys are (24, m, K) limb tensors and flags (1, m, K); with
// mv = m / chunk, chain l = r K + k (r < chunk) owns the sorted run
// [l mv, (l+1) mv), and its element i sits at row i chunk + r, column k. The
// running sum resets to the input point at every segment head; every
// position's value is written out.
//
// Replaces the TPU kernel snarkos_tpu/ops/msm_pallas.py `bucket_scan` /
// `_scan_kernel` (lines 66-91, 172-206). There one grid step adds one point
// to all chunk * K chains at once and the sequential grid carries the running
// sums in VMEM scratch. A CUDA block carries nothing across blocks, so here
// one thread owns one chain and walks its mv points with the running Jacobian
// sum in registers. Thread t = r K + k reads element i at flat position
// (i chunk + r) K + k = i KV + t, so a warp's loads of each limb row are
// consecutive words.
//
// Bound on this card: 32-bit integer multiplies (11 Fq products of 300 word
// products per non-head position, 6 more where P == Q). With KV = 2048 to
// 4096 chains there are 2048 to 4096 threads: 32-thread blocks put one warp
// on each of 64 to 128 SMs, and the launch is bound by the latency of one
// thread's mv dependent mixed additions, not by the card's multiply rate
// (see PERF.md).
#include "g1.cuh"

using namespace snark;

__global__ void bucket_scan_kernel(const int32_t* __restrict__ xs, const int32_t* __restrict__ ys,
                                   const int32_t* __restrict__ flags, int32_t* __restrict__ ox,
                                   int32_t* __restrict__ oy, int32_t* __restrict__ oz, int64_t m,
                                   int64_t K, int64_t chunk) {
    const int64_t kv = chunk * K;
    const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (t >= kv) return;
    const int64_t n = m * K;  // row stride of a limb in the (24, m, K) layout
    const int64_t mv = m / chunk;
    Jac acc, nxt;
#pragma unroll
    for (int i = 0; i < 12; ++i) acc.x[i] = acc.y[i] = acc.z[i] = 0;  // identity
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
            g1_madd(nxt, acc, qx, qy);
            acc = nxt;
        }
        store_point(ox, oy, oz, acc, n, e);
    }
}

extern "C" int bucket_scan(const int32_t* xs, const int32_t* ys, const int32_t* flags, int32_t* ox,
                           int32_t* oy, int32_t* oz, int64_t m, int64_t K, int64_t chunk,
                           void* stream) {
    constexpr int threads = 32;
    const int64_t blocks = (chunk * K + threads - 1) / threads;
    bucket_scan_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(xs, ys, flags, ox, oy, oz, m, K,
                                                              chunk);
    return static_cast<int>(cudaGetLastError());
}
