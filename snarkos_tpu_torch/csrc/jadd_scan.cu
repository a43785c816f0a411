// Kernel B7: the weighted bucket total of one MSM window,
//   T_w = sum_{b=1}^{B-1} b S_b = sum_{b=1}^{B-1} suffix_b,
//   suffix_b = sum_{i>=b} S_i,
// from the window's bucket sums S_0..S_{B-1}, three (24, B) Jacobian limb
// tensors (identities, Z = 0 with any X and Y, may sit anywhere); S_0 has
// weight 0 and is never read. The output is one point, three (24, 1)
// tensors. Optionally (scan_out not null) every suffix is written too:
// position b >= 1 gets suffix_b, position 0 the identity (all-zero limbs).
//
// Replaces the TPU kernel snarkos_tpu/ops/msm_pallas.py `jadd_scan` /
// `_jadd_scan_kernel` (lines 282-323) and the glue of its caller
// `_weighted_bucket_total` (snarkos_tpu/ops/msm.py:344-404). The TPU scans
// the sums twice over a chunk * K virtual-chain layout, because its
// sequential grid can carry sums in VMEM only along one axis, and folds the
// chains' carries back with a Hillis-Steele pass and a full-width add. Here
// the whole total is one cooperative launch over the n = B - 1 live buckets
// in reverse order: element r < n is S_{B-1-r}, so its inclusive prefix p_r
// is suffix_{B-1-r}, and T_w = sum_r p_r. G blocks of T threads (G capped at
// the co-resident count; s grows past the requested elements a thread when
// n needs more threads than fit); thread g owns elements [g s, g s + s):
//   1. its local sum of its s elements (s - 1 adds);
//   2. an inclusive Hillis-Steele scan of the local sums over the block in
//      shared memory (log2 T rounds): incl_t; the last thread's value is the
//      block's aggregate, written to global scratch;
//   -- grid barrier --
//   3. the block's carry C_b = sum of the aggregates of blocks 0..b-1, a tree
//      reduction over them in shared memory (about log2 G rounds), read
//      through L2 (__ldcg: they were written by other SMs in this launch,
//      and the per-SM L1 is not coherent);
//   4. the prefix of the thread's last element is C_b + incl_t (one add);
//      the thread walks its elements backwards, p_{r-1} = p_r - e_r, writes
//      each p_r to scan_out if given, and sums them: its partial total;
//   5. a tree reduction of the partial totals over the block (log2 T rounds),
//      written to global scratch; -- grid barrier --; block 0 reduces the G
//      block totals (about log2 G rounds) and writes T_w.
// A thread that owns no element adds the identity to the scans and its
// partial total is the identity. At s = 1, T = 128 and B = 2^13 + 1 (G = 64)
// the critical path is 7 + 6 + 1 + 7 + 6 = 27 dependent complete adds
// (2 log2(B - 1) + 1 for any T), against about 40 for the TPU design's two
// chunked scans with their B3 prefixes and B2 fold adds, in one launch
// instead of about 70 device operations.
//
// The additions are associated otherwise than a serial walk, so the outputs
// are other Jacobian representatives of the same points (compare with
// g1.same_points).
//
// Bound on this card: 32-bit integer multiplies of the 2(B - 1) complete
// additions a serial algorithm needs (16 Fq products each) against 3 x 24 x
// 4 bytes a bucket read once; the launch is bound by the latency of its
// ~27 dependent additions, one thread's chain of multiplies each.
#include <cooperative_groups.h>

#include "g1.cuh"

namespace cg = cooperative_groups;
using namespace snark;

// Out of line on purpose: with g1_add inlined into a loop, cicc of nvcc 12.9
// crashes (segmentation fault); the call builds.
__device__ __noinline__ void add_step(Jac& o, const Jac& p, const Jac& q) { g1_add(o, p, q); }

__device__ __forceinline__ void set_identity(Jac& p) {
#pragma unroll
    for (int i = 0; i < 12; ++i) p.x[i] = p.y[i] = p.z[i] = 0;
}

// element r of the reversed live range: bucket B - 1 - r
__device__ __forceinline__ void load_elem(Jac& p, const int32_t* xs, const int32_t* ys,
                                          const int32_t* zs, int64_t B, int64_t r) {
    load_point(p, xs, ys, zs, B, B - 1 - r);
}

// a point of the global scratch (36 packed words), through L2 only
__device__ __forceinline__ void load_cg(Jac& p, const Jac* src) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(src);
#pragma unroll
    for (int i = 0; i < 12; ++i) {
        p.x[i] = __ldcg(w + i);
        p.y[i] = __ldcg(w + 12 + i);
        p.z[i] = __ldcg(w + 24 + i);
    }
}

// The sum of vals[0..count) (global scratch, written by other blocks before
// the last grid barrier) over the block: thread j adds vals[j], vals[j + T],
// ..., then a tree over the first `slots` threads (a power of two, the same
// in every block). Every thread must call it; the sum is sh[0] afterwards.
__device__ void block_sum_global(Jac* sh, const Jac* vals, int64_t count, int slots) {
    const int tid = threadIdx.x;
    Jac acc;
    set_identity(acc);
    for (int64_t j = tid; j < count; j += blockDim.x) {
        Jac v, nxt;
        load_cg(v, vals + j);
        if (j == tid) {
            acc = v;
        } else {
            add_step(nxt, acc, v);
            acc = nxt;
        }
    }
    sh[tid] = acc;
    __syncthreads();
    for (int d = slots >> 1; d >= 1; d >>= 1) {
        Jac nxt;
        if (tid < d) add_step(nxt, sh[tid], sh[tid + d]);
        __syncthreads();
        if (tid < d) sh[tid] = nxt;
        __syncthreads();
    }
}

// No __restrict__ on the scratch: it is written and read again in the launch.
__global__ void __launch_bounds__(256)
bucket_total_kernel(const int32_t* __restrict__ xs, const int32_t* __restrict__ ys,
                    const int32_t* __restrict__ zs, int32_t* __restrict__ ox,
                    int32_t* __restrict__ oy, int32_t* __restrict__ oz, int32_t* sx,
                    int32_t* sy, int32_t* sz, Jac* agg, Jac* tot, int64_t B, int64_t s,
                    int slots) {
    extern __shared__ Jac sh[];
    cg::grid_group grid = cg::this_grid();
    const int tid = threadIdx.x;
    const int T = blockDim.x;
    const int64_t n = B - 1;
    const int64_t g = static_cast<int64_t>(blockIdx.x) * T + tid;
    const int64_t lo = g * s < n ? g * s : n;
    const int64_t hi = lo + s < n ? lo + s : n;

    // 1. the local sum of elements [lo, hi)
    Jac acc;
    set_identity(acc);
    for (int64_t r = lo; r < hi; ++r) {
        Jac e, nxt;
        load_elem(e, xs, ys, zs, B, r);
        if (r == lo) {
            acc = e;
        } else {
            add_step(nxt, acc, e);
            acc = nxt;
        }
    }

    // 2. inclusive scan of the local sums over the block
    sh[tid] = acc;
    __syncthreads();
    for (int d = 1; d < T; d <<= 1) {
        Jac nxt;
        if (tid >= d) add_step(nxt, sh[tid - d], acc);
        __syncthreads();
        if (tid >= d) {
            acc = nxt;
            sh[tid] = acc;
        }
        __syncthreads();
    }
    if (tid == T - 1) agg[blockIdx.x] = acc;  // acc is incl_t from here on
    grid.sync();

    // 3. the carry into the block, C_b in sh[0]: the aggregates of blocks
    // 0..b-1
    block_sum_global(sh, agg, blockIdx.x, slots);

    // 4. the prefixes of the thread's elements, last to first, and their sum
    Jac part;
    set_identity(part);
    if (lo < hi) {
        Jac p;
        add_step(p, sh[0], acc);  // p_{hi-1} = C_b + incl_t
        for (int64_t r = hi - 1;; --r) {
            if (sx != nullptr) store_point(sx, sy, sz, p, B, B - 1 - r);
            Jac nxt;
            if (r == hi - 1) {
                part = p;
            } else {
                add_step(nxt, part, p);
                part = nxt;
            }
            if (r == lo) break;
            Jac e;
            load_elem(e, xs, ys, zs, B, r);
            uint32_t zero[12] = {0};
            sub<Fq>(e.y, zero, e.y);  // -e_r
            add_step(nxt, p, e);
            p = nxt;
        }
    }
    if (sx != nullptr && g == 0) {
        Jac id;
        set_identity(id);
        store_point(sx, sy, sz, id, B, 0);
    }

    // 5. the partial totals over the block, then over the blocks
    __syncthreads();  // every thread is done with sh[0] (C_b)
    sh[tid] = part;
    __syncthreads();
    for (int d = T >> 1; d >= 1; d >>= 1) {
        Jac nxt;
        if (tid < d) add_step(nxt, sh[tid], sh[tid + d]);
        __syncthreads();
        if (tid < d) sh[tid] = nxt;
        __syncthreads();
    }
    if (tid == 0) tot[blockIdx.x] = sh[0];
    grid.sync();
    if (blockIdx.x != 0) return;
    block_sum_global(sh, tot, gridDim.x, slots);
    if (tid == 0) store_point(ox, oy, oz, sh[0], 1, 0);
}

// T_w of B >= 2 buckets in one cooperative launch of blocks of `threads`
// threads (a power of two, 32-256), each thread `per_thread` elements or,
// when the co-resident blocks cannot hold that many threads, as many more
// as they need. scratch holds 2 * 36 words a block of ceil((B - 1) /
// (threads * per_thread)) blocks. scan_out (sx, sy, sz) may be null. Returns
// a CUDA error code (cudaErrorInvalidValue for B < 2 or another block).
extern "C" int jadd_bucket_total(const int32_t* xs, const int32_t* ys, const int32_t* zs,
                                 int32_t* ox, int32_t* oy, int32_t* oz, int32_t* sx, int32_t* sy,
                                 int32_t* sz, int32_t* scratch, int64_t B, int64_t threads,
                                 int64_t per_thread, void* stream) {
    if (threads < 32 || threads > 256 || (threads & (threads - 1)) != 0 || per_thread < 1 ||
        B < 2)
        return static_cast<int>(cudaErrorInvalidValue);
    const int T = static_cast<int>(threads);
    const size_t smem = static_cast<size_t>(T) * sizeof(Jac);
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bucket_total_kernel, T, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t resident = static_cast<int64_t>(per_sm) * sms;
    if (resident < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    const int64_t n = B - 1;
    const int64_t blocks_max = (n + T * per_thread - 1) / (T * per_thread);
    int64_t s = per_thread;
    if (blocks_max > resident) s = (n + T * resident - 1) / (T * resident);
    int64_t blocks = (n + T * s - 1) / (T * s);
    int slots = 1;
    while (slots < blocks && slots < T) slots <<= 1;
    Jac* agg = reinterpret_cast<Jac*>(scratch);
    Jac* tot = agg + blocks_max;
    void* args[] = {&xs, &ys, &zs, &ox, &oy, &oz, &sx, &sy, &sz, &agg, &tot, &B, &s, &slots};
    err = cudaLaunchCooperativeKernel((const void*)bucket_total_kernel,
                                      dim3(static_cast<unsigned>(blocks)), dim3(T), args, smem,
                                      static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}
