// Kernel B7: unsegmented inclusive scan of Jacobian points over KV =
// chunk * K virtual chains (the chain layout of B5, bucket_scan.cu) with the
// complete Jacobian addition; identities (Z = 0) are allowed anywhere, so no
// head flags are needed. Inputs and outputs are three (24, m, K) limb tensors
// each. The MSM's bucket total (`_weighted_bucket_total`) runs it twice a
// window to turn the width-B suffix sums into ~B additions.
//
// Replaces the TPU kernel snarkos_tpu/ops/msm_pallas.py `jadd_scan` /
// `_jadd_scan_kernel` (lines 282-323), whose sequential grid carries the
// running sums in VMEM scratch. Here one thread owns one chain, starts from
// the identity (all-zero limbs) and keeps its running sum in registers;
// thread t = r K + k reads element i at flat position i chunk K + t.
//
// Bound on this card: 32-bit integer multiplies (16 Fq products per
// addition of two finite points). At the path's shape (m = 72, K = 128,
// chunk 8) there are 1024 threads: 32-thread blocks put one warp on each of
// 32 SMs, and the launch is bound by one thread's 9 dependent additions.
#include "g1.cuh"

using namespace snark;

// Out of line on purpose: with g1_add inlined into the scan loop, cicc of
// nvcc 12.9 crashes (segmentation fault) at -O3 and at -O0; the call builds.
__device__ __noinline__ void add_step(Jac& o, const Jac& p, const Jac& q) { g1_add(o, p, q); }

__global__ void jadd_scan_kernel(const int32_t* __restrict__ xs, const int32_t* __restrict__ ys,
                                 const int32_t* __restrict__ zs, int32_t* __restrict__ ox,
                                 int32_t* __restrict__ oy, int32_t* __restrict__ oz, int64_t m,
                                 int64_t K, int64_t chunk) {
    const int64_t kv = chunk * K;
    const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (t >= kv) return;
    const int64_t n = m * K;  // row stride of a limb in the (24, m, K) layout
    const int64_t mv = m / chunk;
    Jac acc, q, nxt;
#pragma unroll
    for (int i = 0; i < 12; ++i) acc.x[i] = acc.y[i] = acc.z[i] = 0;  // identity
    for (int64_t i = 0; i < mv; ++i) {
        const int64_t e = i * kv + t;
        load_point(q, xs, ys, zs, n, e);
        add_step(nxt, acc, q);
        acc = nxt;
        store_point(ox, oy, oz, acc, n, e);
    }
}

extern "C" int jadd_scan(const int32_t* xs, const int32_t* ys, const int32_t* zs, int32_t* ox,
                         int32_t* oy, int32_t* oz, int64_t m, int64_t K, int64_t chunk,
                         void* stream) {
    constexpr int threads = 32;
    const int64_t blocks = (chunk * K + threads - 1) / threads;
    jadd_scan_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(xs, ys, zs, ox, oy, oz, m, K, chunk);
    return static_cast<int>(cudaGetLastError());
}
