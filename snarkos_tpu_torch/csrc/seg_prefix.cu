// Kernel B3: the whole inclusive segmented prefix scan of (head flag,
// Jacobian point) lanes, Hillis-Steele, in one launch. Inputs are a (1, n)
// flag tensor and (24, n) x, y, z limb tensors. In round r, at distance
// d = 2^r, lane e >= d becomes b if b is a segment head, else a + b (the
// complete addition), with flag fa | fb, where a is lane e - d and b lane e
// of the previous round; lanes e < d keep their value. After
// steps = ceil(log2 n) rounds every lane holds its segmented inclusive sum.
// Round for round this is ops/msm.py `_hillis_steele_prefix` with the
// operator `seg_combine`, so the result is limb for limb the plain one.
//
// Replaces the TPU kernel snarkos_tpu/ops/g1_pallas.py `seg_combine` /
// `_seg_kernel` (lines 98-133), which computes one round and is launched
// once per round, with about a dozen rolls and selects around each launch.
// Here the rounds run inside one cooperative launch: ceil(n / 64) blocks of
// 64 threads (at most the co-resident count; threads stride over the lanes
// beyond it) with a grid-wide barrier between rounds. The rounds ping-pong
// between the output tensors and a scratch copy (at n = 4096 under 2.5 MB,
// which stays in L2); the last round writes the outputs. The loads of a
// round's operands go through L2 only (`__ldcg`): the lanes were written by
// other blocks in the round before, and the per-SM L1 is not coherent.
//
// Bound on this card: 32-bit integer multiplies of the (width - heads)
// additions a sequential scan needs, against about 600 bytes per lane moved
// once. The Hillis-Steele form does up to log2 n times that work, but at the
// paths' widths (33 to 4096 lanes) the launch is bound by the latency of
// ceil(log2 n) dependent additions, one per round.
#include <cooperative_groups.h>

#include "g1.cuh"

namespace cg = cooperative_groups;
using namespace snark;

// Out of line on purpose: with g1_add inlined into a loop, cicc of nvcc 12.9
// crashes (segmentation fault); the call builds (as in jadd_scan.cu).
__device__ __noinline__ void add_step(Jac& o, const Jac& p, const Jac& q) { g1_add(o, p, q); }

// load<Fq> through L2 only
__device__ __forceinline__ void load_cg(uint32_t* r, const int32_t* src, int64_t n, int64_t e) {
#pragma unroll
    for (int w = 0; w < 12; ++w) {
        uint32_t lo = static_cast<uint32_t>(__ldcg(src + (2 * w) * n + e)) & 0xFFFFu;
        uint32_t hi = static_cast<uint32_t>(__ldcg(src + (2 * w + 1) * n + e)) & 0xFFFFu;
        r[w] = lo | (hi << 16);
    }
}

__device__ __forceinline__ void load_point_cg(Jac& p, const int32_t* x, const int32_t* y,
                                              const int32_t* z, int64_t n, int64_t e) {
    load_cg(p.x, x, n, e);
    load_cg(p.y, y, n, e);
    load_cg(p.z, z, n, e);
}

// No __restrict__: every buffer but the inputs is written and read again
// within the launch.
__global__ void seg_prefix_kernel(const int32_t* fin, const int32_t* xin, const int32_t* yin,
                                  const int32_t* zin, int32_t* fo, int32_t* xo, int32_t* yo,
                                  int32_t* zo, int32_t* fs, int32_t* xs, int32_t* ys,
                                  int32_t* zs, int64_t n, int64_t steps) {
    cg::grid_group grid = cg::this_grid();
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    for (int64_t r = 0; r < steps; ++r) {
        const int64_t d = int64_t{1} << r;
        // round r writes the outputs when steps - 1 - r is even, so the last
        // round does; it reads what the round before wrote, the other buffer
        const bool to_out = ((steps - 1 - r) & 1) == 0;
        const int32_t* sf = r == 0 ? fin : (to_out ? fs : fo);
        const int32_t* sx = r == 0 ? xin : (to_out ? xs : xo);
        const int32_t* sy = r == 0 ? yin : (to_out ? ys : yo);
        const int32_t* sz = r == 0 ? zin : (to_out ? zs : zo);
        int32_t* df = to_out ? fo : fs;
        int32_t* dx = to_out ? xo : xs;
        int32_t* dy = to_out ? yo : ys;
        int32_t* dz = to_out ? zo : zs;
        for (int64_t e = first; e < n; e += stride) {
            const int32_t fb = __ldcg(sf + e);
            Jac b;
            load_point_cg(b, sx, sy, sz, n, e);
            if (e >= d) {
                df[e] = __ldcg(sf + e - d) | fb;
                if (fb == 0) {
                    Jac a, o;
                    load_point_cg(a, sx, sy, sz, n, e - d);
                    add_step(o, a, b);
                    store_point(dx, dy, dz, o, n, e);
                    continue;
                }
            } else {
                df[e] = fb;
            }
            store_point(dx, dy, dz, b, n, e);
        }
        if (r + 1 < steps) grid.sync();
    }
}

extern "C" int seg_prefix(const int32_t* fin, const int32_t* xin, const int32_t* yin,
                          const int32_t* zin, int32_t* fo, int32_t* xo, int32_t* yo, int32_t* zo,
                          int32_t* fs, int32_t* xs, int32_t* ys, int32_t* zs, int64_t n,
                          int64_t steps, void* stream) {
    constexpr int threads = 64;
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, seg_prefix_kernel, threads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    int64_t blocks = (n + threads - 1) / threads;
    const int64_t resident = static_cast<int64_t>(per_sm) * sms;
    if (blocks > resident) blocks = resident;
    if (blocks < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    void* args[] = {&fin, &xin, &yin, &zin, &fo, &xo, &yo, &zo,
                    &fs, &xs, &ys, &zs, &n, &steps};
    err = cudaLaunchCooperativeKernel((const void*)seg_prefix_kernel,
                                      dim3(static_cast<unsigned>(blocks)), dim3(threads), args, 0,
                                      static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}
