// Kernel B5: segmented inclusive scan of sorted affine points over KV =
// chunk * K independent virtual chains, with the complete mixed addition.
// Inputs xs, ys are (24, m, K) limb tensors and flags (1, m, K); with
// mv = m / chunk, chain l = r K + k (r < chunk) owns the sorted run
// [l mv, (l+1) mv), and its element i sits at row i chunk + r, column k. The
// running sum resets to the input point at every segment head; every
// position's value is written out.
//
// Replaces the TPU kernel snarkos_tpu/ops/msm_pallas.py `bucket_scan` /
// `_scan_kernel` (lines 66-91, 172-206). There one grid step adds one point
// to all chunk * K chains at once and the sequential grid carries the running
// sums in VMEM scratch. A CUDA block carries nothing across blocks, and one
// thread walking a chain is mv dependent mixed additions with 2048 to 4096
// threads on the card. Here a team of T threads scans each chain
// (wide_scan_team.cuh, the body of B6 with the complete add in its rescan and
// no flag): sub-run sums, a carry scan over the team in shared memory, and a
// rescan that writes every position. The depth of a chain falls from mv
// dependent steps to about 2 mv / T + log2 T. The values are other Jacobian
// representatives of the serial walk's points, at every position.
//
// Bound on this card: 32-bit integer multiplies (11 Fq products of 300 word
// products per non-head position, 6 more where P == Q; the team does about
// twice that, plus T log2 T complete adds a chain in the carry scan). At the
// paths' shapes (mv = 32, KV = 2048 at batch 16; mv = 256, KV = 4096 at 2^20)
// the launch is still bound by the latency of the dependent additions along
// a team (see PERF.md).
#include "wide_scan_team.cuh"

using namespace snark;

extern "C" int bucket_scan(const int32_t* xs, const int32_t* ys, const int32_t* flags, int32_t* ox,
                           int32_t* oy, int32_t* oz, int64_t m, int64_t K, int64_t chunk,
                           int64_t team, void* stream) {
    return launch_wide_scan_team<true>(xs, ys, flags, nullptr, ox, oy, oz, nullptr, m, K, chunk,
                                       team, stream);
}
