// Kernel B2: complete Jacobian point addition over (24, n) coordinate
// tensors, one lane per thread.
//
// Replaces the TPU kernel snarkos_tpu/ops/g1_pallas.py `add` / `_add_kernel`
// (lines 67-92): g1.add_impl on 512-lane VMEM tiles.
//
// Bound on this card: 32-bit integer multiplies (16 Fq Montgomery products of
// 300 word products each per lane, 7 more where P == Q) against 864 bytes
// moved per lane. On the main path n is 264 or 8, far below one wave of the
// card, so a launch is latency-bound; the design keeps the whole point and
// every temporary in registers and computes the doubling branch only on the
// lanes that select it.
#include "g1.cuh"

using namespace snark;

__global__ void g1_add_kernel(const int32_t* __restrict__ ax, const int32_t* __restrict__ ay,
                              const int32_t* __restrict__ az, const int32_t* __restrict__ bx,
                              const int32_t* __restrict__ by, const int32_t* __restrict__ bz,
                              int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                              int32_t* __restrict__ oz, int64_t n) {
    const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (e >= n) return;
    Jac p, q, o;
    load_point(p, ax, ay, az, n, e);
    load_point(q, bx, by, bz, n, e);
    snark::g1_add(o, p, q);
    store_point(ox, oy, oz, o, n, e);
}

extern "C" int g1_add(const int32_t* ax, const int32_t* ay, const int32_t* az,
                      const int32_t* bx, const int32_t* by, const int32_t* bz,
                      int32_t* ox, int32_t* oy, int32_t* oz, int64_t n, void* stream) {
    constexpr int threads = 64;
    const int64_t blocks = (n + threads - 1) / threads;
    g1_add_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(ax, ay, az, bx, by, bz, ox, oy, oz, n);
    return static_cast<int>(cudaGetLastError());
}
