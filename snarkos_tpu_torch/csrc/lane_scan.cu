// The generic MSM engine's chunked segmented scan (ops/msm.py
// `_seg_scan_chunked`): the inclusive segmented scan of (head flag, Jacobian
// point) pairs in sorted order, over n = K m positions seen as K lanes of m
// consecutive elements, in two launches around one B3 prefix
// (seg_prefix.cu) of the K lane aggregates:
//   g1_lane_scan   each lane's own segmented scan from the identity, written
//                  at every position, by a team of T threads a lane
//                  (wide_scan_team.cuh, kind kLanes: sub-run sums, a
//                  Hillis-Steele scan over the team in shared memory, a
//                  rescan from the previous member's carry); and per lane its
//                  aggregate (the OR of its heads, its value at its last
//                  position) and the index of its first head (m if none);
//   g1_lane_carry  at each position of lane k >= 1 before the lane's first
//                  head, the carry (the prefix's value of lane k - 1) plus the
//                  lane-local value, in place. Fully parallel over positions.
// The values are other Jacobian representatives of the serial scan's points
// at every position (compare with g1.same_points); the carry step's add
// gives g1.add's limbs.
//
// Replaces, at these call sites, the TPU kernel snarkos_tpu/ops/g1_pallas.py
// `seg_combine` / `_seg_kernel` (lines 98-133, pallas_call at :125), which
// the JAX engine launches 2 m times a window (snarkos_tpu/ops/msm.py:139-188):
// m steps of the combine at width K for the lane aggregates, then m more
// from the carries to emit every position. The port ran those steps as
// B2's g1_add at width K plus three selects and a flag OR in PyTorch, and
// stacked the steps; here a window is 2 launches and the prefix, and the
// output is written once, straight into the (24, n) coordinate tensors.
//
// Bound on this card: 32-bit integer multiplies, 16 Fq products of 300 word
// products for each non-head position (the serial scan's adds), against 72
// words a point read and written once. The team does about twice the adds
// (phase 1 and the rescan), plus up to T log2 T a lane in the team scan and
// one a position before a lane's first head in the carry pass. The team is
// two elements a thread up to 256 threads (msm_kernels.lane_team, from the
// sweep in PERF.md): at m = 16 (T = 8, about one wave of the card) a launch
// takes about the latency of a team's 2 s + log2 T dependent adds
// (s = m / T); at m = 256 and 4096 it is many waves of work.
#include "wide_scan_team.cuh"

using namespace snark;

__global__ void g1_lane_carry_kernel(int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                                     int32_t* __restrict__ oz, const int32_t* __restrict__ sx,
                                     const int32_t* __restrict__ sy,
                                     const int32_t* __restrict__ sz,
                                     const int32_t* __restrict__ first_head, int64_t m,
                                     int64_t K) {
    const int64_t n = m * K;
    const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (e >= n) return;
    const int64_t k = e / m;
    if (k == 0 || e - k * m >= first_head[k]) return;
    Jac carry, local, o;
    load_point(carry, sx, sy, sz, K, k - 1);
    load_point(local, ox, oy, oz, n, e);
    team_add_step(o, carry, local);
    store_point(ox, oy, oz, o, n, e);
}

// flags (1, n), x/y/z (24, n) -> ox/oy/oz (24, n) lane-local scans,
// agg_flag (1, K), agg_x/y/z (24, K), first_head (K,) int32; n = m K.
extern "C" int g1_lane_scan(const int32_t* flags, const int32_t* x, const int32_t* y,
                            const int32_t* z, int32_t* ox, int32_t* oy, int32_t* oz,
                            int32_t* agg_flag, int32_t* agg_x, int32_t* agg_y, int32_t* agg_z,
                            int32_t* first_head, int64_t m, int64_t K, int64_t team,
                            void* stream) {
    return launch_team_scan<kLanes>(x, y, z, flags, nullptr, ox, oy, oz, nullptr, agg_flag, agg_x,
                                    agg_y, agg_z, first_head, m * K, K, m, team, stream);
}

// ox/oy/oz (24, n) updated in place from the prefix sx/sy/sz (24, K) of the
// lane aggregates and first_head (K,).
extern "C" int g1_lane_carry(int32_t* ox, int32_t* oy, int32_t* oz, const int32_t* sx,
                             const int32_t* sy, const int32_t* sz, const int32_t* first_head,
                             int64_t m, int64_t K, void* stream) {
    constexpr int threads = 128;
    const int64_t blocks = (m * K + threads - 1) / threads;
    g1_lane_carry_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(ox, oy, oz, sx, sy, sz,
                                                                first_head, m, K);
    return static_cast<int>(cudaGetLastError());
}
