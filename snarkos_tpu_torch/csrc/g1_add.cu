// Kernel B2: the complete Jacobian point addition over (24, n) coordinate
// tensors, one lane per thread (g1_add: o = a + b). It gives the limbs of
// g1.add (ops/g1.py). The MSM's window tail, the other two compositions of
// the add (the Horner chain and the bucket fixup), is window_tail.cu.
//
// Replaces the TPU kernel snarkos_tpu/ops/g1_pallas.py `add` / `_add_kernel`
// (lines 67-92): g1.add_impl on 512-lane VMEM tiles.
//
// Bound on this card: 32-bit integer multiplies (16 Fq Montgomery products of
// 300 word products per generic add) against 864 bytes moved per lane. Its
// one caller, msm_dist's tree reduce, adds a few lanes, so a launch is bound
// by one thread's chain of 16 dependent products.
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

namespace {
constexpr int kThreads = 64;

unsigned blocks_for(int64_t n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }
}  // namespace

extern "C" int g1_add(const int32_t* ax, const int32_t* ay, const int32_t* az,
                      const int32_t* bx, const int32_t* by, const int32_t* bz,
                      int32_t* ox, int32_t* oy, int32_t* oz, int64_t n, void* stream) {
    g1_add_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        ax, ay, az, bx, by, bz, ox, oy, oz, n);
    return static_cast<int>(cudaGetLastError());
}
