// The team scan: a segmented inclusive scan of many independent chains, each
// scanned by a team of T threads. Three kinds, a compile-time choice:
//   kWideComplete    B5 (bucket_scan.cu): affine points in the wide-chain
//                    layout, the complete mixed add;
//   kWideIncomplete  B6 (bucket_scan_fast.cu): the same, with the incomplete
//                    mixed add in phase 3 and an exception flag;
//   kLanes           the generic engine's lane scan (lane_scan.cu): Jacobian
//                    points in sorted order, lane l owning positions
//                    [l len, (l+1) len), the complete Jacobian add; it also
//                    writes each lane's aggregate and first head.
//
// Wide layout: xs, ys are (24, m, K) limb tensors, flags (1, m, K); with
// mv = m / chunk, chain l = r K + k (r < chunk) owns the sorted run
// [l mv, (l+1) mv), and its element i sits at row i chunk + r, column k, that
// is at flat position i KV + l (KV = chunk K). The scan resets to the input
// point at every segment head and writes every position.
//
// A team of T threads scans one chain in three phases, as B4 does
// (bucket_scan_serial.cu) for its serial chains:
//   1. thread t owns the s = ceil(mv / T) elements [t s, (t+1) s) (none when
//      t s >= mv) and scans them from the identity with the COMPLETE add,
//      resetting at heads: its sub-run's sum F_t and H_t = "a head lies in
//      my elements". The complete add keeps garbage out of the carries;
//   2. an inclusive segmented Hillis-Steele scan of (H_t, F_t) over the team
//      in shared memory with the complete add; carry_t is thread t - 1's
//      value, the identity for t = 0: the chain's running sum just before
//      element t s, exactly;
//   3. thread t rescans its elements from carry_t and writes every position.
//      B6 rescans with the incomplete mixed add, raising the thread's flag
//      where a step is exceptional in a live position; the chain's flag is
//      the OR over its team. B5 and the lanes rescan with the complete add
//      and read no nonzero and write no flag.
// Phase 3 replays each step of the serial walk once, on operands that are
// projectively the serial walk's own (for B6 up to the chain's first flagged
// step). So B6's flag equals the serial walk's bit for bit, and every value
// at a position of a live bucket in an unflagged chain is the serial value
// as another Jacobian representative; so is B5's and the lanes' value at
// every position (compare with g1.same_points).
//
// A block holds C = blockDim / T chains' teams. In the wide layout thread
// tid is member t = tid / C of chain c = tid % C, so a warp's loads of one
// limb row are runs of C consecutive words; a lane's elements are
// consecutive words, so there thread tid is member t = tid % T of lane
// c = tid / T. Dynamic shared memory: blockDim Jacobian points, blockDim
// head flags, C chain flags.
#pragma once

#include "g1.cuh"

namespace snark {

enum TeamKind { kWideComplete, kWideIncomplete, kLanes };

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

// Scan elements [i0, i1) of one chain into acc, element i at flat position
// base + i stride, resetting at heads. kRescan: phase 3, every position
// written; for kWideIncomplete returns whether a live step was exceptional,
// else false. Else phase 1: the complete step, nothing written; returns
// whether a head lies in the elements, and for kLanes sets `first` to the
// first one's index (i1 if none).
template <int kKind, bool kRescan>
__device__ __forceinline__ bool team_scan_elements(
    Jac& acc, const int32_t* __restrict__ xs, const int32_t* __restrict__ ys,
    const int32_t* __restrict__ zs, const int32_t* __restrict__ flags,
    const int32_t* __restrict__ nonzero, int32_t* __restrict__ ox, int32_t* __restrict__ oy,
    int32_t* __restrict__ oz, int64_t i0, int64_t i1, int64_t base, int64_t stride, int64_t n,
    int64_t& first) {
    bool any = false;
    first = i1;
    for (int64_t i = i0; i < i1; ++i) {
        const int64_t e = base + i * stride;
        if constexpr (kKind == kLanes) {
            Jac q;
            load_point(q, xs, ys, zs, n, e);
            if (flags[e] != 0) {
                if (!kRescan && !any) first = i;
                if (!kRescan) any = true;
                acc = q;
            } else {
                Jac nxt;
                team_add_step(nxt, acc, q);
                acc = nxt;
            }
        } else {
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
                if constexpr (kRescan && kKind == kWideIncomplete) {
                    if (team_madd_incomplete_step(nxt, acc, qx, qy) && nonzero[e] != 0) any = true;
                } else {
                    team_madd_step(nxt, acc, qx, qy);
                }
                acc = nxt;
            }
        }
        if (kRescan) store_point(ox, oy, oz, acc, n, e);
    }
    return any;
}

// One launch: ceil(chains / C) blocks of C T threads; n positions (the row
// stride of a limb), chains of len elements. Wide kinds: chain l's element
// i at i chains + l (with chains = KV, len = mv, n = m K); exc is KV int32,
// chain l's flag at l (kWideIncomplete; nonzero is (1, m, K)). kLanes:
// lane l's element i at l len + i; agg_flag (1, chains), agg_x/y/z
// (24, chains) and first_head (chains,) take the lane outputs. Pointers a
// kind does not use are null.
template <int kKind>
__global__ void team_scan_kernel(const int32_t* __restrict__ xs, const int32_t* __restrict__ ys,
                                 const int32_t* __restrict__ zs,
                                 const int32_t* __restrict__ flags,
                                 const int32_t* __restrict__ nonzero, int32_t* __restrict__ ox,
                                 int32_t* __restrict__ oy, int32_t* __restrict__ oz,
                                 int32_t* __restrict__ exc, int32_t* __restrict__ agg_flag,
                                 int32_t* __restrict__ agg_x, int32_t* __restrict__ agg_y,
                                 int32_t* __restrict__ agg_z, int32_t* __restrict__ first_head,
                                 int64_t n, int64_t chains, int64_t len, int team) {
    extern __shared__ uint32_t smem[];
    constexpr bool kLane = kKind == kLanes;
    const int T = team;
    const int C = blockDim.x / T;
    const int tid = threadIdx.x;
    // neighbouring threads take neighbouring words of a limb row: one member
    // of C consecutive chains (wide layout), or consecutive members of one
    // lane (kLanes); member t - 1 of the same chain is thread tid - up
    const int c = kLane ? tid / T : tid % C;
    const int t = kLane ? tid % T : tid / C;
    const int up = kLane ? 1 : C;
    Jac* part = reinterpret_cast<Jac*>(smem);
    int* head = reinterpret_cast<int*>(part + blockDim.x);
    int* chain_flag = head + blockDim.x;

    const int64_t l = static_cast<int64_t>(blockIdx.x) * C + c;
    const int64_t s = (len + T - 1) / T;
    // past the last chain, or past the chain's end: no elements
    const int64_t i0 = (l < chains && t * s < len) ? t * s : len;
    const int64_t i1 = i0 + s < len ? i0 + s : len;
    const int64_t base = kLane ? l * len : l;
    const int64_t stride = kLane ? 1 : chains;
    if (t == 0) chain_flag[c] = 0;

    // 1. the sub-run's own sum, from the identity (all-zero limbs)
    Jac acc;
    set_identity(acc);
    int64_t first;
    const bool own_head = team_scan_elements<kKind, false>(acc, xs, ys, zs, flags, nonzero, ox, oy,
                                                           oz, i0, i1, base, stride, n, first);
    head[tid] = own_head ? 1 : 0;
    part[tid] = acc;
    __syncthreads();

    // 2. inclusive segmented scan over t: (H_a, F_a) then (H_b, F_b) gives
    // (H_a | H_b, H_b ? F_b : F_a + F_b)
    for (int d = 1; d < T; d <<= 1) {
        const bool upd = t >= d && head[tid] == 0;
        Jac nxt;
        int hn = 0;
        if (upd) {
            team_add_step(nxt, part[tid - d * up], part[tid]);
            hn = head[tid - d * up];
        }
        __syncthreads();
        if (upd) {
            part[tid] = nxt;
            head[tid] = hn;
        }
        __syncthreads();
    }

    // the lane's outputs for the carry pass: its first head (the first member
    // with a head of its own holds it; len if the lane has none) and its
    // aggregate (the OR of its heads, its value at the last position: member
    // T - 1's inclusive value)
    if constexpr (kLane) {
        if (l < chains) {
            if (own_head && (t == 0 || head[tid - up] == 0))
                first_head[l] = static_cast<int32_t>(first);
            if (t == T - 1) {
                if (head[tid] == 0) first_head[l] = static_cast<int32_t>(len);
                agg_flag[l] = head[tid];
                store_point(agg_x, agg_y, agg_z, part[tid], chains, l);
            }
        }
    }

    // 3. rescan from the carry into element t s: member t - 1's inclusive
    // value, the identity for t = 0
    if (t > 0) {
        acc = part[tid - up];
    } else {
        set_identity(acc);
    }
    if (team_scan_elements<kKind, true>(acc, xs, ys, zs, flags, nonzero, ox, oy, oz, i0, i1,
                                        base, stride, n, first))
        chain_flag[c] = 1;
    if constexpr (kKind == kWideIncomplete) {
        __syncthreads();
        if (t == 0 && l < chains) exc[l] = chain_flag[c];
    }
}

// Threads a block of the team scan: C T with C = max(1, 128 / T).
inline int team_block_threads(int team) { return team < 128 ? 128 : team; }

inline size_t team_smem_bytes(int threads, int team) {
    return static_cast<size_t>(threads) * (sizeof(Jac) + sizeof(int)) +
           static_cast<size_t>(threads / team) * sizeof(int);
}

// The launch of a team scan: a team of T threads a chain, T a power of two
// up to 256 (48 KB of shared memory, 255 registers a thread); returns
// cudaGetLastError().
template <int kKind>
inline int launch_team_scan(const int32_t* xs, const int32_t* ys, const int32_t* zs,
                            const int32_t* flags, const int32_t* nonzero, int32_t* ox,
                            int32_t* oy, int32_t* oz, int32_t* exc, int32_t* agg_flag,
                            int32_t* agg_x, int32_t* agg_y, int32_t* agg_z, int32_t* first_head,
                            int64_t n, int64_t chains, int64_t len, int64_t team, void* stream) {
    if (team < 1 || team > 256 || (team & (team - 1)) != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const int T = static_cast<int>(team);
    const int threads = team_block_threads(T);
    const int64_t per_block = threads / T;
    const int64_t blocks = (chains + per_block - 1) / per_block;
    team_scan_kernel<kKind><<<static_cast<unsigned>(blocks), threads, team_smem_bytes(threads, T),
                              static_cast<cudaStream_t>(stream)>>>(
        xs, ys, zs, flags, nonzero, ox, oy, oz, exc, agg_flag, agg_x, agg_y, agg_z, first_head, n,
        chains, len, T);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace snark
