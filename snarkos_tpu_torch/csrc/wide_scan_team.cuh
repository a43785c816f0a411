// The team scan of the wide-chain bucket scans: B6 (bucket_scan_fast.cu,
// the incomplete add and an exception flag) and B5 (bucket_scan.cu, the
// complete add, no flag). The two differ only in phase 3's step, a
// compile-time choice (kComplete).
//
// Layout: xs, ys are (24, m, K) limb tensors, flags (1, m, K); with
// mv = m / chunk, chain l = r K + k (r < chunk) owns the sorted run
// [l mv, (l+1) mv), and its element i sits at row i chunk + r, column k, that
// is at flat position i KV + l (KV = chunk K). The scan resets to the input
// point at every segment head and writes every position.
//
// A team of T threads scans one chain in three phases, as B4 does
// (bucket_scan_serial.cu) for its serial chains:
//   1. thread t owns the s = ceil(mv / T) elements [t s, (t+1) s) (none when
//      t s >= mv) and scans them from the identity with the COMPLETE mixed
//      add, resetting at heads: its sub-run's sum F_t and H_t = "a head lies in
//      my elements". The complete add keeps garbage out of the carries;
//   2. an inclusive segmented Hillis-Steele scan of (H_t, F_t) over the team
//      in shared memory with the complete add; carry_t is thread t - 1's
//      value, the identity for t = 0: the chain's running sum just before
//      element t s, exactly;
//   3. thread t rescans its elements from carry_t and writes every position.
//      B6 rescans with the incomplete mixed add, raising the thread's flag
//      where a step is exceptional in a live position; the chain's flag is
//      the OR over its team. B5 rescans with the complete mixed add and
//      reads no nonzero and writes no flag.
// Phase 3 replays each step of the serial walk once, on operands that are
// projectively the serial walk's own (for B6 up to the chain's first flagged
// step). So B6's flag equals the serial walk's bit for bit, and every value
// at a position of a live bucket in an unflagged chain is the serial value
// as another Jacobian representative; so is B5's value at every position
// (compare with g1.same_points).
//
// A block holds C = blockDim / T chains' teams; thread tid is member
// t = tid / C of chain c = tid % C, so a warp's loads of one limb row are
// runs of C consecutive words. Dynamic shared memory: blockDim Jacobian
// points, blockDim head flags, C chain flags.
#pragma once

#include "g1.cuh"

namespace snark {

// Out of line on purpose: with the curve additions inlined into a scan loop,
// cicc of nvcc 12.9 crashes (segmentation fault); the calls build.
__device__ __noinline__ void team_madd_step(Jac& o, const Jac& p, const uint32_t* qx,
                                            const uint32_t* qy) {
    g1_madd(o, p, qx, qy);
}

__device__ __noinline__ bool team_madd_incomplete_step(Jac& o, const Jac& p, const uint32_t* qx,
                                                       const uint32_t* qy) {
    return g1_madd_incomplete(o, p, qx, qy);
}

__device__ __noinline__ void team_add_step(Jac& o, const Jac& p, const Jac& q) {
    g1_add(o, p, q);
}

__device__ __forceinline__ void set_identity(Jac& p) {
#pragma unroll
    for (int i = 0; i < 12; ++i) p.x[i] = p.y[i] = p.z[i] = 0;
}

// Scan elements [i0, i1) of chain l into acc, resetting at heads. kRescan:
// phase 3, every position written, with the complete add (kComplete, returns
// false) or with the incomplete add (returns whether a live step was
// exceptional); else phase 1: the complete add, nothing written, returns
// whether a head lies in the elements.
template <bool kRescan, bool kComplete>
__device__ __forceinline__ bool team_scan_elements(
    Jac& acc, const int32_t* __restrict__ xs, const int32_t* __restrict__ ys,
    const int32_t* __restrict__ flags, const int32_t* __restrict__ nonzero,
    int32_t* __restrict__ ox, int32_t* __restrict__ oy, int32_t* __restrict__ oz, int64_t i0,
    int64_t i1, int64_t l, int64_t kv, int64_t n) {
    bool any = false;
    for (int64_t i = i0; i < i1; ++i) {
        const int64_t e = i * kv + l;
        uint32_t qx[12], qy[12];
        load<Fq>(qx, xs, n, e);
        load<Fq>(qy, ys, n, e);
        if (flags[e] != 0) {
            if (!kRescan) any = true;
            copy<Fq>(acc.x, qx);
            copy<Fq>(acc.y, qy);
#pragma unroll
            for (int w = 0; w < 12; ++w) acc.z[w] = FQ_ONE[w];
        } else {
            Jac nxt;
            if constexpr (kRescan && !kComplete) {
                if (team_madd_incomplete_step(nxt, acc, qx, qy) && nonzero[e] != 0) any = true;
            } else {
                team_madd_step(nxt, acc, qx, qy);
            }
            acc = nxt;
        }
        if (kRescan) store_point(ox, oy, oz, acc, n, e);
    }
    return any;
}

// One launch: ceil(KV / C) blocks of C T threads. exc is KV int32, chain l's
// flag at l; nonzero is (1, m, K). With kComplete both are unused (null).
template <bool kComplete>
__global__ void wide_scan_team_kernel(const int32_t* __restrict__ xs,
                                      const int32_t* __restrict__ ys,
                                      const int32_t* __restrict__ flags,
                                      const int32_t* __restrict__ nonzero,
                                      int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                                      int32_t* __restrict__ oz, int32_t* __restrict__ exc,
                                      int64_t m, int64_t K, int64_t chunk, int team) {
    extern __shared__ uint32_t smem[];
    const int T = team;
    const int C = blockDim.x / T;
    const int tid = threadIdx.x;
    const int c = tid % C;
    const int t = tid / C;
    Jac* part = reinterpret_cast<Jac*>(smem);
    int* head = reinterpret_cast<int*>(part + blockDim.x);
    int* chain_flag = head + blockDim.x;

    const int64_t kv = chunk * K;
    const int64_t l = static_cast<int64_t>(blockIdx.x) * C + c;
    const int64_t n = m * K;  // row stride of a limb in the (24, m, K) layout
    const int64_t mv = m / chunk;
    const int64_t s = (mv + T - 1) / T;
    // past the last chain, or past the chain's end: no elements
    const int64_t i0 = (l < kv && t * s < mv) ? t * s : mv;
    const int64_t i1 = i0 + s < mv ? i0 + s : mv;
    if (t == 0) chain_flag[c] = 0;

    // 1. the sub-run's own sum, from the identity (all-zero limbs)
    Jac acc;
    set_identity(acc);
    head[tid] =
        team_scan_elements<false, true>(acc, xs, ys, flags, nonzero, ox, oy, oz, i0, i1, l, kv, n)
            ? 1
            : 0;
    part[tid] = acc;
    __syncthreads();

    // 2. inclusive segmented scan over t (member t - d of the same chain is
    // thread tid - d C): (H_a, F_a) then (H_b, F_b) gives
    // (H_a | H_b, H_b ? F_b : F_a + F_b)
    for (int d = 1; d < T; d <<= 1) {
        const bool upd = t >= d && head[tid] == 0;
        Jac nxt;
        int hn = 0;
        if (upd) {
            team_add_step(nxt, part[tid - d * C], part[tid]);
            hn = head[tid - d * C];
        }
        __syncthreads();
        if (upd) {
            part[tid] = nxt;
            head[tid] = hn;
        }
        __syncthreads();
    }

    // 3. rescan from the carry into element t s: member t - 1's inclusive
    // value, the identity for t = 0
    if (t > 0) {
        acc = part[tid - C];
    } else {
        set_identity(acc);
    }
    if (team_scan_elements<true, kComplete>(acc, xs, ys, flags, nonzero, ox, oy, oz, i0, i1, l,
                                            kv, n))
        chain_flag[c] = 1;
    if constexpr (!kComplete) {
        __syncthreads();
        if (t == 0 && l < kv) exc[l] = chain_flag[c];
    }
}

// Threads a block of the team scan: C T with C = max(1, 128 / T).
inline int team_block_threads(int team) { return team < 128 ? 128 : team; }

inline size_t team_smem_bytes(int threads, int team) {
    return static_cast<size_t>(threads) * (sizeof(Jac) + sizeof(int)) +
           static_cast<size_t>(threads / team) * sizeof(int);
}

// The launch of B5 (kComplete) and B6: a team of T threads a chain, T a power
// of two up to 256 (48 KB of shared memory, 255 registers a thread); returns
// cudaGetLastError().
template <bool kComplete>
inline int launch_wide_scan_team(const int32_t* xs, const int32_t* ys, const int32_t* flags,
                                 const int32_t* nonzero, int32_t* ox, int32_t* oy, int32_t* oz,
                                 int32_t* exc, int64_t m, int64_t K, int64_t chunk, int64_t team,
                                 void* stream) {
    if (team < 1 || team > 256 || (team & (team - 1)) != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const int T = static_cast<int>(team);
    const int threads = team_block_threads(T);
    const int64_t per_block = threads / T;
    const int64_t blocks = (chunk * K + per_block - 1) / per_block;
    wide_scan_team_kernel<kComplete>
        <<<static_cast<unsigned>(blocks), threads, team_smem_bytes(threads, T),
           static_cast<cudaStream_t>(stream)>>>(xs, ys, flags, nonzero, ox, oy, oz, exc, m, K,
                                                chunk, T);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace snark
