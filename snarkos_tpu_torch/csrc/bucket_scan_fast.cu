// Kernel B6: the segmented bucket scan of kernel B5 (bucket_scan.cu, same
// chain layout) with the INCOMPLETE mixed addition, 11 Fq multiplies a step
// against up to 17, and a per-chain exception flag. A step where the running
// sum P and the input Q have P == +-Q gives garbage (with Z = 0) and raises
// the chain's flag, unless the step is a segment head (its sum is
// overwritten) or its bucket key is 0 (`nonzero` == 0: bucket 0 is dropped
// downstream, and the scan and the cross-chain carries reset at every head, so
// its garbage never reaches a live bucket). exc is (1, chunk, K): entry
// r K + k is chain r K + k's flag. The caller reruns the complete engine (B5)
// when any flag is set.
//
// Replaces the TPU kernel snarkos_tpu/ops/msm_pallas.py `bucket_scan_fast` /
// `_scan_kernel_fast` (lines 94-169). There one grid step adds one point to
// all chunk K chains at once, the sequential grid carries the running sums and
// the sticky flag in VMEM scratch, and the whole (1, chunk, K) flag block is
// written back at every step. Walked by one thread, a chain is mv dependent
// additions, and a 2^20-point MSM's 4096 chains give one warp on each SM.
// Here a team of T threads scans each chain (wide_scan_team.cuh): sub-run
// sums with the complete add, a carry scan over the team in shared memory,
// and a rescan with the incomplete add that raises the flag. The depth of a
// chain falls from mv dependent steps to about 2 mv / T + log2 T, and the flag
// stays exact: the rescan replays every step of the serial walk once, from
// the true running sum.
//
// Bound on this card: 32-bit integer multiplies (11 Fq products of 300 word
// products per non-head position; the team does about twice that, plus
// T log2 T complete adds a chain in the carry scan). At the path's shape
// (mv = 256, KV = 4096) the launch is still bound by the latency of the
// dependent additions along a team (see PERF.md).
#include "wide_scan_team.cuh"

using namespace snark;

extern "C" int bucket_scan_fast(const int32_t* xs, const int32_t* ys, const int32_t* flags,
                                const int32_t* nonzero, int32_t* ox, int32_t* oy, int32_t* oz,
                                int32_t* exc, int64_t m, int64_t K, int64_t chunk, int64_t team,
                                void* stream) {
    return launch_wide_scan_team<false>(xs, ys, flags, nonzero, ox, oy, oz, exc, m, K, chunk,
                                        team, stream);
}
