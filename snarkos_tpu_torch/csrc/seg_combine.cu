// Kernel B3: the segmented-scan operator on (head flag, Jacobian point)
// pairs, one lane per thread: out = b if b is a segment head, else a + b
// (complete add); out flag = fa | fb.
//
// Replaces the TPU kernel snarkos_tpu/ops/g1_pallas.py `seg_combine` /
// `_seg_kernel` (lines 98-133).
//
// Bound on this card: as B2, 32-bit integer multiplies against about 870
// bytes per lane; at the path's widths (256 and 264 lanes) a launch is
// latency-bound. The lanes that keep b skip the addition.
#include "g1.cuh"

using namespace snark;

__global__ void seg_combine_kernel(const int32_t* __restrict__ fa, const int32_t* __restrict__ ax,
                                   const int32_t* __restrict__ ay, const int32_t* __restrict__ az,
                                   const int32_t* __restrict__ fb, const int32_t* __restrict__ bx,
                                   const int32_t* __restrict__ by, const int32_t* __restrict__ bz,
                                   int32_t* __restrict__ of, int32_t* __restrict__ ox,
                                   int32_t* __restrict__ oy, int32_t* __restrict__ oz, int64_t n) {
    const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (e >= n) return;
    const int32_t flag_b = fb[e];
    of[e] = fa[e] | flag_b;
    Jac q;
    load_point(q, bx, by, bz, n, e);
    if (flag_b != 0) {
        store_point(ox, oy, oz, q, n, e);
        return;
    }
    Jac p, o;
    load_point(p, ax, ay, az, n, e);
    snark::g1_add(o, p, q);
    store_point(ox, oy, oz, o, n, e);
}

extern "C" int seg_combine(const int32_t* fa, const int32_t* ax, const int32_t* ay,
                           const int32_t* az, const int32_t* fb, const int32_t* bx,
                           const int32_t* by, const int32_t* bz, int32_t* of, int32_t* ox,
                           int32_t* oy, int32_t* oz, int64_t n, void* stream) {
    constexpr int threads = 64;
    const int64_t blocks = (n + threads - 1) / threads;
    seg_combine_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(fa, ax, ay, az, fb, bx, by, bz,
                                                              of, ox, oy, oz, n);
    return static_cast<int>(cudaGetLastError());
}
