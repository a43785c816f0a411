// The generic MSM engine's window (ops/msm.py `msm_generic`: the chunked
// segmented scan `_seg_scan_chunked` of the sorted Jacobian points, then the
// bucket sums at the runs' tails), in two launches around one B3 prefix
// (seg_prefix.cu) of the K lane aggregates:
//   g1_lane_buckets       the sorted window (int64 keys (n,), x, y, z
//                         (24, n)) as K lanes of m consecutive positions;
//                         each lane walked once, and the only points written
//                         are the bucket tails: at the last position of each
//                         key's run the run's lane-local sum into the (24, B)
//                         bucket arrays at that key's column (bucket 0 and
//                         the empty buckets get the identity); per lane its
//                         aggregate (the OR of its heads (1, K), its value at
//                         its last position (24, K)), its first head (K,)
//                         (m if none) and the key of its first tail where
//                         that run began in an earlier lane (K,) (-1 if
//                         none);
//   g1_lane_bucket_carry  for each lane k >= 1 with such a key b > 0: bucket
//                         b := B3's inclusive prefix at lane k - 1 + bucket
//                         b, in place; at most one add a lane.
// The bucket sums are other Jacobian representatives of the JAX order's
// (the fold's value at each bucket's last position; compare with
// g1.same_points); the flags, first heads and keys are exact.
//
// Replaces, at these call sites, the TPU kernel snarkos_tpu/ops/g1_pallas.py
// `seg_combine` / `_seg_kernel` (lines 98-133, pallas_call at :125), which
// the JAX engine launches 2 m times a window (snarkos_tpu/ops/msm.py:139-188,
// 220-226): m steps of the combine at width K for the lane aggregates, m
// more from the carries to emit every position, then a gather of the tails.
//
// Bound on this card: 32-bit integer multiplies, 16 Fq products of 300 word
// products for each non-head position (the serial scan's adds), against one
// read of the points (288 bytes a position) and the keys. Before this
// design (g1_lane_scan + g1_lane_carry, a Hillis-Steele team scan that
// rescanned and wrote every position) a window took 9.75 + 1.52 ms of
// device time at m = 256 and 198 + 13 ms at m = 4096, 17-20x its ops bound.
//
// Design. A lane is walked by M members (M a power of two), member t owning
// the s = ceil(m / M) positions [t s, (t+1) s) of it. A member is one
// thread: the complete add on that thread, its temporaries in registers, its
// operands in shared memory; `msm_kernels.lane_plan` picks (M, members a
// block) from the sweep in PERF.md. A member
//   1. stages its positions kTile at a time into shared memory (36 packed
//      words a point) with the keys around them, and walks them once from
//      its first element: at a head the running sum restarts, else one
//      complete add. At every tail (the next key differs) after its first
//      head the sum is final: it goes straight into its bucket, with the
//      identity into the empty buckets up to the next key. The tail before
//      its first head (its "open" tail) waits for the carry; the sum there
//      is kept;
//   2. joins a work-efficient segmented scan of the members' (own head, sum)
//      pairs in shared memory (an up-sweep and a down-sweep, log2 M levels
//      each, at most one add a member a level: about 2 adds a member in
//      all). The up-sweep's root is the lane aggregate; the down-sweep
//      leaves each member its carry, the lane-local sum before its first
//      position;
//   3. adds its carry to its open tail's sum (one add; member 0's carry is
//      the identity) and writes that bucket; where no head precedes the
//      open tail in the lane, the run began in an earlier lane and the key
//      goes to g1_lane_bucket_carry.
// So a window is about one add a non-head position plus three a member,
// with no rescan, and writes B + K points where the old pass wrote n. What
// bounds it on the card is the number of adds in flight: shared memory per
// member (752 bytes with kTile = 2, against 1,040 with 4-position tiles) and
// registers allow 256 threads an SM; the sweep found one thread an add (over
// window_tail.cu's teams of 4, a level's products side by side) and 8
// members a lane fastest at m = 16, 256 and 4096, and within 0.010 ms of
// the teams at m = 1 (PERF.md has the sweep).
// g1_lane_bucket_carry's one add a lane is a team of 4 threads
// (team_add), as window_tail.cu's.
// The complete add's special cases (P == Q doubles, P == -Q gives Z = 0,
// an identity operand passes the other through) are those of g1.cuh's
// g1_add, in its select form, with its field ops in its order: the same
// limbs. The steps stay out of line (__noinline__): with a G1 add inlined
// into a scan loop, cicc of nvcc 12.9 crashes.
#include "g1.cuh"

using namespace snark;

namespace {

constexpr int kTile = 2;                 // positions staged at a time
// threads (members) a block at most: the add keeps its temporaries in
// registers, 255 of them
constexpr int kMaxThreads = 256;
constexpr int kPoint = 36;               // packed words of a point
constexpr int kTemps = 12;               // a team's add temporaries, 12 words each

// a member's shared words: the tile (after the walk, its first point is the
// member's scan value), two running sums (ping-pong), the open prefix, the
// tile's keys (kTile + 2, int32, and 2 of padding)
struct Layout {
    static constexpr int tile = 0;
    static constexpr int scan = tile;
    static constexpr int acc = tile + kTile * kPoint;
    static constexpr int open = acc + 2 * kPoint;
    static constexpr int keys = open + kPoint;
    static constexpr int words = keys + kTile + 4;
};

// g1_lane_bucket_carry's team: kTeam threads an add
constexpr int kTeam = 4;

__device__ __forceinline__ void team_sync(unsigned mask) { __syncwarp(mask); }

__device__ __forceinline__ unsigned team_mask() {
    return ((1u << kTeam) - 1u) << ((threadIdx.x & 31u) & ~static_cast<unsigned>(kTeam - 1));
}

// o = a b over 12-word field elements in shared memory, on one thread's
// registers (o may alias a or b).
__device__ __noinline__ void mul_to(uint32_t* o, const uint32_t* a, const uint32_t* b) {
    uint32_t x[12], y[12], z[12];
    copy<Fq>(x, a);
    copy<Fq>(y, b);
    mont_mul<Fq>(z, x, y);
    copy<Fq>(o, z);
}

struct Prod {
    uint32_t* o;
    const uint32_t* a;
    const uint32_t* b;
};

// One level of a team: its k <= 4 independent products, product i on
// thread i % kTeam; then the team waits for all of them.
__device__ __forceinline__ void level(int r, unsigned mask, int k, Prod p0, Prod p1, Prod p2,
                                      Prod p3) {
    const Prod ps[4] = {p0, p1, p2, p3};
#pragma unroll
    for (int i = 0; i < 4; ++i)
        if (i < k && i % kTeam == r) mul_to(ps[i].o, ps[i].a, ps[i].b);
    team_sync(mask);
}

__device__ __forceinline__ uint32_t* tmp(uint32_t* T, int i) { return T + 12 * i; }

// o = 2 p by a team (dbl-2009-l, as g1.cuh's g1_double); o may not alias p.
__device__ __noinline__ void team_double(uint32_t* o, const uint32_t* p, uint32_t* T, int r,
                                           unsigned mask) {
    const uint32_t *X = p, *Y = p + 12, *Z = p + 24;
    uint32_t *A = tmp(T, 0), *Bq = tmp(T, 1), *YZ = tmp(T, 2), *XB = tmp(T, 3), *E = tmp(T, 4),
             *C = tmp(T, 5), *D = tmp(T, 6), *F = tmp(T, 7), *DX = tmp(T, 8), *EDX = tmp(T, 9);
    level(r, mask, 3, {A, X, X}, {Bq, Y, Y}, {YZ, Y, Z}, Prod{});
    if (r == 0) {
        add<Fq>(XB, X, Bq);
        mul3<Fq>(E, A);
        dbl<Fq>(o + 24, YZ);                                      // z3 = 2 y z
    }
    team_sync(mask);
    level(r, mask, 3, {C, Bq, Bq}, {D, XB, XB}, {F, E, E}, Prod{});
    if (r == 0) {
        sub<Fq>(D, D, A);
        sub<Fq>(D, D, C);
        dbl<Fq>(D, D);                                            // D = 2 ((x + B)^2 - A - C)
        uint32_t t[12];
        dbl<Fq>(t, D);
        sub<Fq>(o, F, t);                                         // x3 = F - 2D
        sub<Fq>(DX, D, o);
    }
    team_sync(mask);
    level(r, mask, 1, {EDX, E, DX}, Prod{}, Prod{}, Prod{});
    if (r == 0) {
        uint32_t c8[12];
        mul8<Fq>(c8, C);
        sub<Fq>(o + 12, EDX, c8);                                 // y3 = E (D - x3) - 8C
    }
    team_sync(mask);
}

// o = p + q by a team (add-2007-bl in five levels and the special cases of
// g1.cuh's g1_add); o may not alias p or q. The temporaries are reused as
// the levels free them: 12 of them.
__device__ __noinline__ void team_add(uint32_t* o, const uint32_t* p, const uint32_t* q,
                                        uint32_t* T, int r, unsigned mask) {
    const uint32_t *X1 = p, *Y1 = p + 12, *Z1 = p + 24, *X2 = q, *Y2 = q + 12, *Z2 = q + 24;
    uint32_t *Z1Z1 = tmp(T, 0), *Z2Z2 = tmp(T, 1), *S1 = tmp(T, 2), *S2 = tmp(T, 3),
             *U1 = tmp(T, 4), *U2 = tmp(T, 5), *I = tmp(T, 6), *ZZ = tmp(T, 7),
             *RR2 = tmp(T, 8), *J = tmp(T, 9), *V = tmp(T, 10), *VX = tmp(T, 11);
    // S1, S2 start as Y1 Z2, Y2 Z1 and are multiplied in place
    level(r, mask, 4, {Z1Z1, Z1, Z1}, {Z2Z2, Z2, Z2}, {S1, Y1, Z2}, {S2, Y2, Z1});
    level(r, mask, 4, {U1, X1, Z2Z2}, {U2, X2, Z1Z1}, {S1, S1, Z2Z2}, {S2, S2, Z1Z1});
    // the special cases, read by every thread of the team alike before the
    // slots are reused
    const bool p_inf = is_zero<Fq>(Z1);
    const bool q_inf = is_zero<Fq>(Z2);
    const bool x_eq = eq<Fq>(U1, U2);
    const bool y_eq = eq<Fq>(S1, S2);
    team_sync(mask);
    uint32_t *H = U2, *RR = S2, *H2 = I;
    if (r == 0) {
        sub<Fq>(H, U2, U1);
        sub<Fq>(RR, S2, S1);
        dbl<Fq>(RR, RR);
        dbl<Fq>(H2, H);
        add<Fq>(ZZ, Z1, Z2);
    }
    team_sync(mask);
    level(r, mask, 3, {I, H2, H2}, {RR2, RR, RR}, {ZZ, ZZ, ZZ}, Prod{});  // i = (2h)^2
    if (r == 0) {
        sub<Fq>(ZZ, ZZ, Z1Z1);
        sub<Fq>(ZZ, ZZ, Z2Z2);
    }
    team_sync(mask);
    level(r, mask, 3, {J, H, I}, {V, U1, I}, {o + 24, ZZ, H}, Prod{});
    if (r == 0) {
        uint32_t t[12], v2[12];
        sub<Fq>(t, RR2, J);
        dbl<Fq>(v2, V);
        sub<Fq>(o, t, v2);                                        // x3 = rr^2 - j - 2v
        sub<Fq>(VX, V, o);
    }
    team_sync(mask);
    uint32_t *T5 = Z1Z1, *S1J = Z2Z2;
    level(r, mask, 2, {T5, RR, VX}, {S1J, S1, J}, Prod{}, Prod{});
    if (r == 0) {
        uint32_t t[12];
        dbl<Fq>(t, S1J);
        sub<Fq>(o + 12, T5, t);                                   // y3 = rr (v - x3) - 2 s1 j
    }
    team_sync(mask);
    if (!p_inf && !q_inf && x_eq) {
        if (y_eq) {
            team_double(o, p, T, r, mask);
        } else if (r == 0) {
#pragma unroll
            for (int k = 0; k < 12; ++k) o[24 + k] = 0;
        }
    }
    if (r == 0 && (p_inf || q_inf)) {
        const uint32_t* src = p_inf ? q : p;
#pragma unroll 4
        for (int k = 0; k < kPoint; ++k) o[k] = src[k];
    }
    team_sync(mask);
}

// o = 2 p on one thread (g1.cuh's g1_double), the operand read from shared
// memory as it is needed and the temporaries in registers; o may not alias p.
__device__ __noinline__ void thread_double(uint32_t* o, const uint32_t* p) {
    uint32_t A[12], Bq[12], C[12], D[12], E[12], t[12], x[12];
    copy<Fq>(x, p);
    sqr<Fq>(A, x);
    copy<Fq>(t, p + 12);
    sqr<Fq>(Bq, t);
    sqr<Fq>(C, Bq);
    add<Fq>(D, x, Bq);
    sqr<Fq>(D, D);
    sub<Fq>(D, D, A);
    sub<Fq>(D, D, C);
    dbl<Fq>(D, D);                      // D = 2 ((x + B)^2 - A - C)
    mul3<Fq>(E, A);
    sqr<Fq>(A, E);                      // F = E^2
    dbl<Fq>(x, D);
    sub<Fq>(x, A, x);                   // x3 = F - 2D
    copy<Fq>(o, x);
    sub<Fq>(t, D, x);
    mont_mul<Fq>(t, E, t);
    mul8<Fq>(C, C);
    sub<Fq>(t, t, C);                   // y3 = E (D - x3) - 8C
    copy<Fq>(o + 12, t);
    copy<Fq>(t, p + 12);
    copy<Fq>(x, p + 24);
    mont_mul<Fq>(t, t, x);
    dbl<Fq>(t, t);                      // z3 = 2 y z
    copy<Fq>(o + 24, t);
}

// o = p + q on one thread (g1.cuh's g1_add, the same field ops in the same
// order), the operands read from shared memory as they are needed and the
// temporaries in registers; o may not alias p or q.
__device__ __noinline__ void thread_add(uint32_t* o, const uint32_t* p, const uint32_t* q) {
    uint32_t z1[12], z2[12], z1z1[12], z2z2[12], u1[12], s1[12], h[12], rr[12], t[12];
    copy<Fq>(z1, p + 24);
    copy<Fq>(z2, q + 24);
    const bool p_inf = is_zero<Fq>(z1);
    const bool q_inf = is_zero<Fq>(z2);
    sqr<Fq>(z1z1, z1);
    sqr<Fq>(z2z2, z2);
    copy<Fq>(t, p + 12);
    mont_mul<Fq>(s1, t, z2);
    mont_mul<Fq>(s1, s1, z2z2);         // s1 = y1 z2 z2z2
    copy<Fq>(t, q + 12);
    mont_mul<Fq>(rr, t, z1);
    mont_mul<Fq>(rr, rr, z1z1);         // s2 = y2 z1 z1z1
    copy<Fq>(t, p);
    mont_mul<Fq>(u1, t, z2z2);
    copy<Fq>(t, q);
    mont_mul<Fq>(h, t, z1z1);           // u2
    const bool x_eq = eq<Fq>(u1, h);
    const bool y_eq = eq<Fq>(s1, rr);
    sub<Fq>(h, h, u1);                  // h = u2 - u1
    sub<Fq>(rr, rr, s1);
    dbl<Fq>(rr, rr);                    // rr = 2 (s2 - s1)
    add<Fq>(t, z1, z2);
    sqr<Fq>(t, t);
    sub<Fq>(t, t, z1z1);
    sub<Fq>(z1, t, z2z2);               // (z1 + z2)^2 - z1z1 - z2z2
    uint32_t* i = z1z1;
    uint32_t* j = z2z2;
    dbl<Fq>(t, h);
    sqr<Fq>(i, t);                      // i = (2h)^2
    mont_mul<Fq>(j, h, i);
    mont_mul<Fq>(u1, u1, i);            // v = u1 i
    mont_mul<Fq>(t, z1, h);
    copy<Fq>(o + 24, t);                // z3
    sqr<Fq>(t, rr);
    sub<Fq>(t, t, j);
    dbl<Fq>(z2, u1);
    sub<Fq>(t, t, z2);                  // x3 = rr^2 - j - 2v
    copy<Fq>(o, t);
    sub<Fq>(z2, u1, t);
    mont_mul<Fq>(z2, rr, z2);
    mont_mul<Fq>(j, s1, j);
    dbl<Fq>(j, j);
    sub<Fq>(t, z2, j);                  // y3 = rr (v - x3) - 2 s1 j
    copy<Fq>(o + 12, t);
    if (!p_inf && !q_inf && x_eq) {
        if (y_eq) {
            thread_double(o, p);
        } else {
#pragma unroll
            for (int k = 0; k < 12; ++k) o[24 + k] = 0;
        }
    }
    if (p_inf || q_inf) {
        const uint32_t* src = p_inf ? q : p;
#pragma unroll 4
        for (int k = 0; k < kPoint; ++k) o[k] = src[k];
    }
}

__device__ __forceinline__ void copy_point(uint32_t* dst, const uint32_t* src) {
    for (int k = 0; k < kPoint; ++k) dst[k] = src[k];
}

__device__ __forceinline__ void zero_point(uint32_t* dst) {
    for (int k = 0; k < kPoint; ++k) dst[k] = 0;
}

// A packed point into column c of (24, w) limb tensors, word k by thread
// k % R.
template <int R>
__device__ __forceinline__ void store_col(int32_t* x, int32_t* y, int32_t* z, const uint32_t* src,
                                          int64_t w, int64_t c, int r) {
    for (int k = r; k < kPoint; k += R) {
        int32_t* dst = k < 12 ? x : k < 24 ? y : z;
        const int i = k % 12;
        dst[(2 * i) * w + c] = static_cast<int32_t>(src[k] & 0xFFFFu);
        dst[(2 * i + 1) * w + c] = static_cast<int32_t>(src[k] >> 16);
    }
}

template <int R>
__device__ __forceinline__ void load_col(uint32_t* dst, const int32_t* x, const int32_t* y,
                                         const int32_t* z, int64_t w, int64_t c, int r) {
    for (int k = r; k < kPoint; k += R) {
        const int32_t* src = k < 12 ? x : k < 24 ? y : z;
        const int i = k % 12;
        const uint32_t lo = static_cast<uint32_t>(src[(2 * i) * w + c]) & 0xFFFFu;
        const uint32_t hi = static_cast<uint32_t>(src[(2 * i + 1) * w + c]) & 0xFFFFu;
        dst[k] = lo | (hi << 16);
    }
}

// The identity (g1.infinity's limbs: X = Y = one, Z = 0) into buckets
// [lo, hi) of (24, B).
__device__ __forceinline__ void identity_cols(int32_t* bx, int32_t* by, int32_t* bz, int64_t B,
                                              int64_t lo, int64_t hi) {
    for (int64_t b = lo; b < hi; ++b) {
        for (int w = 0; w < 72; ++w) {
            const int row = w % 24;
            const uint32_t one = FQ_ONE[row / 2];
            const int32_t v = static_cast<int32_t>(row & 1 ? one >> 16 : one & 0xFFFFu);
            (w < 24 ? bx : w < 48 ? by : bz)[row * B + b] = w < 48 ? v : 0;
        }
    }
}

// A tail's bucket: the point, or the identity for bucket 0.
__device__ __forceinline__ void write_bucket(int32_t* bx, int32_t* by, int32_t* bz, int64_t B,
                                             int key, const uint32_t* v) {
    if (key == 0) {
        identity_cols(bx, by, bz, B, 0, 1);
    } else {
        store_col<1>(bx, by, bz, v, B, key, 0);
    }
}

// Lanes of m positions, M members a lane of s = ceil(m / M) positions, MB
// members (threads) a block (MB / M lanes).
__global__ void __launch_bounds__(kMaxThreads)
lane_buckets_kernel(const int64_t* __restrict__ keys, const int32_t* __restrict__ x,
                    const int32_t* __restrict__ y, const int32_t* __restrict__ z,
                    int32_t* __restrict__ bx, int32_t* __restrict__ by, int32_t* __restrict__ bz,
                    int32_t* __restrict__ agg_flag, int32_t* __restrict__ ax,
                    int32_t* __restrict__ ay, int32_t* __restrict__ az,
                    int32_t* __restrict__ first_head, int32_t* __restrict__ carry_key, int64_t n,
                    int64_t K, int64_t m, int64_t B, int M) {
    extern __shared__ uint32_t smem[];
    const int MB = blockDim.x;
    const int mb = threadIdx.x;
    const int t = mb % M;
    const int lane0 = mb - t;  // the lane's member 0 in the block
    const int64_t l = static_cast<int64_t>(blockIdx.x) * (MB / M) + mb / M;
    const bool live = l < K;
    uint32_t* base = smem + static_cast<int64_t>(mb) * Layout::words;
    int* own = reinterpret_cast<int*>(smem + static_cast<int64_t>(MB) * Layout::words);  // (MB,)
    int* subtree = own + MB;  // (MB,) the up-sweep's subtree flags
    uint32_t* tile = base + Layout::tile;
    uint32_t* acc = base + Layout::acc;
    uint32_t* open_sum = base + Layout::open;
    uint32_t* scan = base + Layout::scan;
    int* kt = reinterpret_cast<int*>(base + Layout::keys);

    const int64_t s = (m + M - 1) / M;
    const int64_t i0 = live && t * s < m ? t * s : m;
    const int64_t i1 = i0 + s < m ? i0 + s : m;
    const int64_t lb = l * m;

    // 1. the walk
    int cur = 0;
    bool own_head = false, open = true, has_open = false;
    int open_key = -1;
    int64_t first = m;
    for (int64_t i = i0; i < i1; ++i) {
        const int j = static_cast<int>((i - i0) % kTile);
        if (j == 0) {
            const int cnt = static_cast<int>(i1 - i < kTile ? i1 - i : kTile);
            const int64_t e0 = lb + i;
            // word k of position jj, a limb row's cnt positions side by side
            for (int p = 0; p < kPoint * cnt; ++p) {
                const int k = p / cnt, jj = p % cnt;
                const int32_t* src = k < 12 ? x : k < 24 ? y : z;
                const int64_t at = (2 * (k % 12)) * n + e0 + jj;
                tile[jj * kPoint + k] = (static_cast<uint32_t>(src[at]) & 0xFFFFu) |
                                        ((static_cast<uint32_t>(src[at + n]) & 0xFFFFu) << 16);
            }
            // keys of positions e0 - 1 .. e0 + cnt: -1 before the first, B
            // after the last
            for (int p = 0; p < cnt + 2; ++p) {
                const int64_t e = e0 - 1 + p;
                kt[p] = e < 0 ? -1 : e >= n ? static_cast<int>(B) : static_cast<int>(keys[e]);
            }
        }
        const uint32_t* q = tile + j * kPoint;
        const int prev = kt[j], key = kt[j + 1], next = kt[j + 2];
        const bool head = prev != key;
        const bool tail = next != key;
        uint32_t* a = acc + cur * kPoint;
        if (head || i == i0) {  // a restart, or the first element (identity + q = q)
            if (head) {
                if (!own_head) first = i;
                own_head = true;
                open = false;
            }
            copy_point(a, q);
        } else {
            thread_add(acc + (cur ^ 1) * kPoint, a, q);
            cur ^= 1;
            a = acc + cur * kPoint;
        }
        if (prev < 0) identity_cols(bx, by, bz, B, 0, key);  // below the first key
        if (tail) {
            if (open) {
                has_open = true;
                open_key = key;
                copy_point(open_sum, a);
                open = false;
            } else {
                write_bucket(bx, by, bz, B, key, a);
            }
            identity_cols(bx, by, bz, B, key + 1, next);  // empty buckets up to the next key
        }
    }
    if (i1 > i0) {
        copy_point(scan, acc + cur * kPoint);
    } else {
        zero_point(scan);
    }
    own[mb] = own_head ? 1 : 0;
    subtree[mb] = own_head ? 1 : 0;
    if (live && t == 0) carry_key[l] = -1;
    __syncthreads();

    // 2. the members' segmented scan: (f_a, v_a) then (f_b, v_b) gives
    // (f_a | f_b, f_b ? v_b : v_a + v_b). Up-sweep: member t = 2d - 1 mod 2d
    // takes in its left sibling's subtree at member t - d
    for (int d = 1; d < M; d <<= 1) {
        if (live && t % (2 * d) == 2 * d - 1) {
            uint32_t* left = smem + static_cast<int64_t>(mb - d) * Layout::words + Layout::scan;
            if (!subtree[mb]) {
                thread_add(acc, left, scan);
                copy_point(scan, acc);
            }
            subtree[mb] |= subtree[mb - d];
        }
        __syncthreads();
    }
    // the root is the lane aggregate; the carry into the lane is the identity
    if (live && t == M - 1) {
        agg_flag[l] = subtree[mb];
        store_col<1>(ax, ay, az, scan, K, l, 0);
        zero_point(scan);
    }
    __syncthreads();
    // down-sweep: member t = 2d - 1 mod 2d holds the carry c into its
    // subtree; the left half gets c, the right half c + (left sum), or the
    // left sum alone where the left half holds a head
    for (int d = M / 2; d >= 1; d >>= 1) {
        if (live && t % (2 * d) == 2 * d - 1) {
            uint32_t* left = smem + static_cast<int64_t>(mb - d) * Layout::words + Layout::scan;
            if (subtree[mb - d]) {
                copy_point(acc, left);
            } else {
                thread_add(acc, scan, left);
            }
            copy_point(left, scan);
            copy_point(scan, acc);
        }
        __syncthreads();
    }

    // 3. the open tail: carry + the open prefix's sum; the first member
    // with a head of its own gives the lane's first head
    if (live) {
        bool before = false;  // a head in the lane before this member
        for (int u = lane0; u < mb; ++u) before |= own[u] != 0;
        if (has_open) {
            const uint32_t* v = open_sum;
            if (t > 0) {
                thread_add(acc, scan, open_sum);
                v = acc;
            }
            write_bucket(bx, by, bz, B, open_key, v);
            if (!before) carry_key[l] = open_key;
        }
        if (own_head && !before) first_head[l] = static_cast<int32_t>(first);
        if (t == M - 1 && !before && !own_head) first_head[l] = static_cast<int32_t>(m);
    }
}

// One team a lane, 32 lanes a block.
constexpr int kCarryLanes = 32;

__global__ void __launch_bounds__(kTeam * kCarryLanes)
lane_bucket_carry_kernel(int32_t* __restrict__ bx, int32_t* __restrict__ by,
                         int32_t* __restrict__ bz, const int32_t* __restrict__ sx,
                         const int32_t* __restrict__ sy, const int32_t* __restrict__ sz,
                         const int32_t* __restrict__ carry_key, int64_t K, int64_t B) {
    __shared__ uint32_t scratch[kCarryLanes][3 * kPoint + 12 * kTemps];
    const int r = threadIdx.x % kTeam;
    const int64_t k = static_cast<int64_t>(blockIdx.x) * kCarryLanes + threadIdx.x / kTeam;
    if (k < 1 || k >= K) return;  // the whole team
    const int key = carry_key[k];
    if (key <= 0) return;
    const unsigned mask = team_mask();
    uint32_t* s = scratch[threadIdx.x / kTeam];
    load_col<kTeam>(s, sx, sy, sz, K, k - 1, r);
    load_col<kTeam>(s + kPoint, bx, by, bz, B, key, r);
    team_sync(mask);
    team_add(s + 2 * kPoint, s, s + kPoint, s + 3 * kPoint, r, mask);
    store_col<kTeam>(bx, by, bz, s + 2 * kPoint, B, key, r);
}

}  // namespace

// keys (n,) int64 sorted, each < B; x/y/z (24, n) -> bx/by/bz (24, B),
// agg_flag (1, K), ax/ay/az (24, K), first_head (K,), carry_key (K,) int32.
// members: M a lane (a power of two up to block_members); block_members: MB
// a block (a multiple of M, at most 256).
extern "C" int g1_lane_buckets(const int64_t* keys, const int32_t* x, const int32_t* y,
                               const int32_t* z, int32_t* bx, int32_t* by, int32_t* bz,
                               int32_t* agg_flag, int32_t* ax, int32_t* ay, int32_t* az,
                               int32_t* first_head, int32_t* carry_key, int64_t n, int64_t K,
                               int64_t B, int64_t members, int64_t block_members, void* stream) {
    const int64_t M = members, MB = block_members;
    if (K < 1 || n % K != 0 || M < 1 || (M & (M - 1)) != 0 || MB % M != 0 || MB > kMaxThreads)
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = static_cast<size_t>(MB) * (Layout::words * 4 + 2 * sizeof(int));
    static size_t allowed = 48 * 1024;  // the largest dynamic shared memory set so far
    if (smem > allowed) {
        const cudaError_t err = cudaFuncSetAttribute(
            lane_buckets_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) {
            cudaGetLastError();  // not left for the next launch's check
            return static_cast<int>(err);
        }
        allowed = smem;
    }
    const int64_t blocks = (K + MB / M - 1) / (MB / M);
    lane_buckets_kernel<<<static_cast<unsigned>(blocks), static_cast<unsigned>(MB), smem,
                          static_cast<cudaStream_t>(stream)>>>(
        keys, x, y, z, bx, by, bz, agg_flag, ax, ay, az, first_head, carry_key, n, K, n / K, B,
        static_cast<int>(M));
    return static_cast<int>(cudaGetLastError());
}

// bx/by/bz (24, B) updated in place from the prefix sx/sy/sz (24, K) of the
// lane aggregates and carry_key (K,).
extern "C" int g1_lane_bucket_carry(int32_t* bx, int32_t* by, int32_t* bz, const int32_t* sx,
                                    const int32_t* sy, const int32_t* sz,
                                    const int32_t* carry_key, int64_t K, int64_t B,
                                    void* stream) {
    const int64_t blocks = (K + kCarryLanes - 1) / kCarryLanes;
    lane_bucket_carry_kernel<<<static_cast<unsigned>(blocks), kTeam * kCarryLanes, 0,
                               static_cast<cudaStream_t>(stream)>>>(bx, by, bz, sx, sy, sz,
                                                                    carry_key, K, B);
    return static_cast<int>(cudaGetLastError());
}
