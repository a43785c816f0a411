// Kernel B4: per-chain segmented inclusive scan of sorted affine points with
// the complete mixed addition. Inputs xs, ys are (24, m, K) limb tensors and
// flags (1, m, K); chain k owns the sorted run [k m, (k+1) m), laid out at
// column k, rows 0..m-1. The running sum resets to the input point at every
// segment head; every position's value is written out.
//
// Replaces the TPU kernel snarkos_tpu/ops/msm_pallas.py `bucket_scan_serial`
// / `_scan_kernel_serial` (lines 222-273). There the sequential grid carries
// the running sums in VMEM scratch and each of the K lanes walks its m points
// in order. Walked by one thread, a chain is m dependent additions, and the
// path's 256 chains give 256 threads on a card that holds tens of thousands.
// Here a block of T threads (a team) scans one chain in three phases:
//   1. thread t owns the s = ceil(m / T) rows [t s, (t+1) s) (none when
//      t s >= m) and scans them from the identity with the complete mixed
//      add, resetting at heads: its sub-run's sum F_t and H_t = "a head lies
//      in my rows";
//   2. an exclusive segmented scan of (H_t, F_t) over t in shared memory,
//      log2 T Hillis-Steele rounds of the complete add: carry_t, the sum
//      flowing into thread t's first row;
//   3. thread t rescans its rows from carry_t, resetting at heads, and writes
//      every position.
// A chain's depth falls from m dependent steps to about 2 s + log2 T. The
// additions are associated differently from the serial walk, so the outputs
// are other Jacobian representatives of the same points (compare
// projectively, g1.same_points).
//
// Bound on this card: 32-bit integer multiplies (11 Fq products of 300 word
// products per non-head position; 6 more where P == Q). The scan does about
// twice that (two passes plus the carry rounds); at the path's shape
// (m = 128, K = 256) the launch is still bound by the latency of the
// dependent additions along a chain (see PERF.md).
#include "g1.cuh"

using namespace snark;

// Out of line on purpose: with the curve additions inlined into a scan loop,
// cicc of nvcc 12.9 crashes (segmentation fault; see jadd_scan.cu and
// bucket_scan_fast.cu); the calls build.
__device__ __noinline__ void madd_step(Jac& o, const Jac& p, const uint32_t* qx,
                                       const uint32_t* qy) {
    g1_madd(o, p, qx, qy);
}

__device__ __noinline__ void add_step(Jac& o, const Jac& p, const Jac& q) { g1_add(o, p, q); }

// Scan rows [j0, j1) of column k into acc, resetting at heads; writes every
// position when `emit`. Returns whether a head lies in the rows.
__device__ __forceinline__ bool scan_rows(Jac& acc, const int32_t* __restrict__ xs,
                                          const int32_t* __restrict__ ys,
                                          const int32_t* __restrict__ flags,
                                          int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                                          int32_t* __restrict__ oz, int64_t j0, int64_t j1,
                                          int64_t k, int64_t K, int64_t n, bool emit) {
    bool head = false;
    for (int64_t j = j0; j < j1; ++j) {
        const int64_t e = j * K + k;
        uint32_t qx[12], qy[12];
        load<Fq>(qx, xs, n, e);
        load<Fq>(qy, ys, n, e);
        if (flags[e] != 0) {
            head = true;
            copy<Fq>(acc.x, qx);
            copy<Fq>(acc.y, qy);
#pragma unroll
            for (int i = 0; i < 12; ++i) acc.z[i] = FQ_ONE[i];
        } else {
            Jac nxt;
            madd_step(nxt, acc, qx, qy);
            acc = nxt;
        }
        if (emit) store_point(ox, oy, oz, acc, n, e);
    }
    return head;
}

// blockIdx.x = chain k, threadIdx.x = t < T = blockDim.x. Dynamic shared
// memory: T Jacobian points, then T head flags.
__global__ void bucket_scan_serial_kernel(const int32_t* __restrict__ xs,
                                          const int32_t* __restrict__ ys,
                                          const int32_t* __restrict__ flags,
                                          int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                                          int32_t* __restrict__ oz, int64_t m, int64_t K) {
    extern __shared__ uint32_t smem[];
    Jac* part = reinterpret_cast<Jac*>(smem);
    int* head = reinterpret_cast<int*>(part + blockDim.x);
    const int64_t k = blockIdx.x;
    const int t = threadIdx.x;
    const int T = blockDim.x;
    const int64_t n = m * K;  // row stride of a limb in the (24, m, K) layout
    const int64_t s = (m + T - 1) / T;
    const int64_t j0 = t * s < m ? t * s : m;
    const int64_t j1 = j0 + s < m ? j0 + s : m;

    // 1. the sub-run's own sum, from the identity (all-zero limbs)
    Jac acc;
#pragma unroll
    for (int i = 0; i < 12; ++i) acc.x[i] = acc.y[i] = acc.z[i] = 0;
    head[t] = scan_rows(acc, xs, ys, flags, ox, oy, oz, j0, j1, k, K, n, false) ? 1 : 0;
    part[t] = acc;
    __syncthreads();

    // 2. inclusive segmented scan over t: (H_a, F_a) then (H_b, F_b) gives
    // (H_a | H_b, H_b ? F_b : F_a + F_b)
    for (int d = 1; d < T; d <<= 1) {
        const bool upd = t >= d && head[t] == 0;
        Jac nxt;
        int hn = 0;
        if (upd) {
            add_step(nxt, part[t - d], part[t]);
            hn = head[t - d];
        }
        __syncthreads();
        if (upd) {
            part[t] = nxt;
            head[t] = hn;
        }
        __syncthreads();
    }

    // 3. rescan from the carry into the first row: thread t - 1's inclusive
    // value, the identity for t = 0
    if (t > 0) {
        acc = part[t - 1];
    } else {
#pragma unroll
        for (int i = 0; i < 12; ++i) acc.x[i] = acc.y[i] = acc.z[i] = 0;
    }
    scan_rows(acc, xs, ys, flags, ox, oy, oz, j0, j1, k, K, n, true);
}

extern "C" int bucket_scan_serial(const int32_t* xs, const int32_t* ys, const int32_t* flags,
                                  int32_t* ox, int32_t* oy, int32_t* oz, int64_t m, int64_t K,
                                  int64_t team, void* stream) {
    if (team < 1 || team > 256) return static_cast<int>(cudaErrorInvalidValue);  // 48 KB, 255 regs
    const size_t smem = static_cast<size_t>(team) * (sizeof(Jac) + sizeof(int));
    bucket_scan_serial_kernel<<<static_cast<unsigned>(K), static_cast<unsigned>(team), smem,
                                static_cast<cudaStream_t>(stream)>>>(xs, ys, flags, ox, oy, oz,
                                                                     m, K);
    return static_cast<int>(cudaGetLastError());
}
