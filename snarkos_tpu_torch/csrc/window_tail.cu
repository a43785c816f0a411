// Kernel B2's window tail: the two compositions of the complete Jacobian add
// that end the MSM's window loop, built for the latency of a dependent chain
// of points:
//   g1_horner_chain  the whole Horner chain of a MSM in one launch: from the
//                    identity and the top window down, acc = 2^c acc + T_w
//                    over a (W, 24, n) stack of the windows' totals (c
//                    doublings, then one add, W times);
//   g1_bucket_fixup  a window's bucket sums from the window's raw inputs:
//                    each bucket finds its last sorted position by a binary
//                    search in the keys, its chain and its place in the
//                    chain layout, whether its run started in an earlier
//                    chain (a walk over the chain's head flags), and adds the
//                    carry into that chain (B3's inclusive prefix of the
//                    chain finals at chain l - 1) to the scan value there;
//                    the identity where the bucket is empty or bucket 0 of
//                    its batch.
// Each gives the limbs of the same composition of g1.add / g1.double calls as
// its plain version (ops/g1_kernels.py) and the JAX window loop
// (snarkos_tpu/ops/msm.py:524-566: fori_loop(0, c, dbl) and group.add).
//
// Replaces the TPU kernel snarkos_tpu/ops/g1_pallas.py `add` / `_add_kernel`
// (lines 67-92), which the JAX window loop calls c + 2 times a window.
//
// Bound on this card: 32-bit integer multiplies (an Fq product is 300 word
// products, 600 multiply-adds; a doubling 7 products, an add 16) against the
// bytes moved (a T_w read, the result written: 864 bytes a lane and window
// at most). At the main path's widths (1 to 16 lanes for the chain, 264 to
// 8193 buckets for the fixup) the card is nearly empty and both bounds are
// microseconds: a launch takes the time of one thread's chain of dependent
// products. Measured before this design (scripts/time_window_tail.py on the
// one-step entry it replaced, H100 80GB HBM3 at 700 W): a doubling 0.0283 ms
// (7 products, so ~4.0 us a product on the chain), a step's add with its
// loads and launch 0.045 ms (16 products), the same at widths 1, 8 and 32
// (the lanes of a warp run in lockstep), with 296 local loads and 236 local
// stores in the kernel's code (the points passed by reference to the
// out-of-line steps). The chain figure, the products on a lane's longest
// dependent path times that latency: 7 c + 16 products a window before, 3 c
// + 5 here (0.0283 / 7 ms each: 3.93 ms for b8's 43 windows of c = 6, 3.44
// ms for the 2^20 MSM's 19 of c = 14; 9.91 and 8.36 ms on one thread).
//
// Design: a team of kTeam = 4 threads a lane (8 lanes a warp), and the
// formulas cut into levels of independent products. The complete add
// (add-2007-bl) has 16 products but a longest dependent path of 5: {Z1^2,
// Z2^2, Y1 Z2, Y2 Z1}, {U1, U2, S1, S2}, {(2H)^2, R^2, (Z1 + Z2)^2}, {J, V,
// Z3}, {R (V - X3), S1 J}; the doubling (dbl-2009-l) 7 products on a path
// of 3: {X^2, Y^2, Y Z}, {B^2, (X + B)^2, E^2}, {E (D - X3)}. Thread r of a
// team computes the r-th product of a level; the threads of a warp run the
// same multiply on different operands in lockstep, so a level costs one
// product. The point and the temporaries live in the team's shared memory
// (operands are copied to registers for each product), the field adds and
// subtractions between levels run on the team's first thread, and
// __syncwarp over the team's four threads orders the levels. Measured with
// this design (the same script and card): a doubling 0.0068 ms and an add
// about 0.012 ms (a level, a product and its field adds, ~2.3 us), at
// widths 1, 8 and 32 alike, with no local loads or stores.
//
// Why not more: splitting one product over threads (the CIOS rows of
// field.cuh) needs a cross-thread exchange at every one of its 12 word rows
// (the running sum's low word and m = T_0 (-p^-1)), about 30 cycles each
// against the ~300 cycles a row takes on one thread's carry chain; the
// levels above leave at most 4 products side by side. The step functions
// stay out of line (__noinline__): with the curve formulas inlined into a
// loop, cicc of nvcc 12.9 crashes (segmentation fault; see jadd_scan.cu).
// The special cases keep the select form of g1.cuh's g1_add: the generic
// formula always, then the doubling for P == Q, Z := 0 for P == -Q, and the
// other operand where one is the identity.
#include "g1.cuh"

using namespace snark;

namespace {

constexpr int kTeam = 4;
constexpr int kLanes = 8;  // teams (lanes) a block: one warp
constexpr int kThreads = kTeam * kLanes;

// A team's scratch: kSlots field elements of 12 words. A point takes three
// consecutive slots (X, Y, Z).
enum Slot : int {
    kP0 = 0,     // a point: the chain's acc (ping-pong with kP1), the fixup's tail
    kP1 = 3,     // a point: the chain's other acc, the fixup's result
    kQ = 6,      // a point: T_w, the fixup's carry
    // the add's temporaries
    kZ1Z1 = 9, kZ2Z2, kTA, kTB, kU1, kU2, kS1, kS2, kH, kRR, kH2, kZZ, kI, kRR2, kZSQ, kZM,
    kJ, kV, kVX, kT5, kS1J,
    // the doubling's temporaries
    kDA, kDB, kDYZ, kDC, kDXB, kDD, kDE, kDF, kDDX, kDEDX,
    kSlots
};

__device__ __forceinline__ uint32_t* slot(uint32_t* s, int k) { return s + 12 * k; }

// s[o] = s[a] s[b], on one thread's registers.
__device__ __noinline__ void mul_slots(uint32_t* s, int o, int a, int b) {
    uint32_t x[12], y[12], z[12];
    copy<Fq>(x, slot(s, a));
    copy<Fq>(y, slot(s, b));
    mont_mul<Fq>(z, x, y);
    copy<Fq>(slot(s, o), z);
}

struct Prod {
    int o, a, b;
};

// One level of a team: thread r < k computes product r of the level; then
// the team waits for all of them.
__device__ __forceinline__ void level(uint32_t* s, int r, unsigned mask, int k, Prod p0,
                                      Prod p1, Prod p2, Prod p3) {
    const Prod p = r == 0 ? p0 : r == 1 ? p1 : r == 2 ? p2 : p3;
    if (r < k) mul_slots(s, p.o, p.a, p.b);
    __syncwarp(mask);
}

// out = 2 in (dbl-2009-l, as g1.cuh's g1_double); out may not alias in.
__device__ __noinline__ void team_double(uint32_t* s, int r, unsigned mask, int in, int out) {
    const int X = in, Y = in + 1, Z = in + 2;
    level(s, r, mask, 3, {kDA, X, X}, {kDB, Y, Y}, {kDYZ, Y, Z}, Prod{});
    if (r == 0) {
        add<Fq>(slot(s, kDXB), slot(s, X), slot(s, kDB));
        mul3<Fq>(slot(s, kDE), slot(s, kDA));
        dbl<Fq>(slot(s, out + 2), slot(s, kDYZ));                 // z3 = 2 y z
    }
    __syncwarp(mask);
    level(s, r, mask, 3, {kDC, kDB, kDB}, {kDD, kDXB, kDXB}, {kDF, kDE, kDE}, Prod{});
    if (r == 0) {
        uint32_t* D = slot(s, kDD);
        sub<Fq>(D, D, slot(s, kDA));
        sub<Fq>(D, D, slot(s, kDC));
        dbl<Fq>(D, D);                                            // D = 2 ((x + B)^2 - A - C)
        uint32_t t[12];
        dbl<Fq>(t, D);
        sub<Fq>(slot(s, out), slot(s, kDF), t);                   // x3 = F - 2D
        sub<Fq>(slot(s, kDDX), D, slot(s, out));
    }
    __syncwarp(mask);
    level(s, r, mask, 1, {kDEDX, kDE, kDDX}, Prod{}, Prod{}, Prod{});
    if (r == 0) {
        uint32_t c8[12];
        mul8<Fq>(c8, slot(s, kDC));
        sub<Fq>(slot(s, out + 1), slot(s, kDEDX), c8);            // y3 = E (D - x3) - 8C
    }
    __syncwarp(mask);
}

// out = p + q (add-2007-bl and the special cases of g1.cuh's g1_add); out
// may not alias p or q.
__device__ __noinline__ void team_add(uint32_t* s, int r, unsigned mask, int p, int q, int out) {
    const int X1 = p, Y1 = p + 1, Z1 = p + 2, X2 = q, Y2 = q + 1, Z2 = q + 2;
    level(s, r, mask, 4, {kZ1Z1, Z1, Z1}, {kZ2Z2, Z2, Z2}, {kTA, Y1, Z2}, {kTB, Y2, Z1});
    level(s, r, mask, 4, {kU1, X1, kZ2Z2}, {kU2, X2, kZ1Z1}, {kS1, kTA, kZ2Z2},
          {kS2, kTB, kZ1Z1});
    if (r == 0) {
        sub<Fq>(slot(s, kH), slot(s, kU2), slot(s, kU1));
        sub<Fq>(slot(s, kRR), slot(s, kS2), slot(s, kS1));
        dbl<Fq>(slot(s, kRR), slot(s, kRR));
        dbl<Fq>(slot(s, kH2), slot(s, kH));
        add<Fq>(slot(s, kZZ), slot(s, Z1), slot(s, Z2));
    }
    __syncwarp(mask);
    level(s, r, mask, 3, {kI, kH2, kH2}, {kRR2, kRR, kRR}, {kZSQ, kZZ, kZZ}, Prod{});
    if (r == 0) {
        sub<Fq>(slot(s, kZM), slot(s, kZSQ), slot(s, kZ1Z1));
        sub<Fq>(slot(s, kZM), slot(s, kZM), slot(s, kZ2Z2));
    }
    __syncwarp(mask);
    level(s, r, mask, 3, {kJ, kH, kI}, {kV, kU1, kI}, {out + 2, kZM, kH}, Prod{});
    if (r == 0) {
        uint32_t t[12];
        sub<Fq>(t, slot(s, kRR2), slot(s, kJ));
        uint32_t v2[12];
        dbl<Fq>(v2, slot(s, kV));
        sub<Fq>(slot(s, out), t, v2);                             // x3 = rr^2 - j - 2v
        sub<Fq>(slot(s, kVX), slot(s, kV), slot(s, out));
    }
    __syncwarp(mask);
    level(s, r, mask, 2, {kT5, kRR, kVX}, {kS1J, kS1, kJ}, Prod{}, Prod{});
    if (r == 0) {
        uint32_t t[12];
        dbl<Fq>(t, slot(s, kS1J));
        sub<Fq>(slot(s, out + 1), slot(s, kT5), t);               // y3 = rr (v - x3) - 2 s1 j
    }
    __syncwarp(mask);
    // the special cases, read by every thread of the team alike
    const bool p_inf = is_zero<Fq>(slot(s, Z1));
    const bool q_inf = is_zero<Fq>(slot(s, Z2));
    const bool x_eq = eq<Fq>(slot(s, kU1), slot(s, kU2));
    const bool y_eq = eq<Fq>(slot(s, kS1), slot(s, kS2));
    if (!p_inf && !q_inf && x_eq) {
        if (y_eq) {
            team_double(s, r, mask, p, out);
        } else if (r == 0) {
#pragma unroll
            for (int k = 0; k < 12; ++k) slot(s, out + 2)[k] = 0;
        }
    }
    if (r == 0 && (p_inf || q_inf)) {
        const uint32_t* src = slot(s, p_inf ? q : p);
#pragma unroll 4
        for (int k = 0; k < 36; ++k) slot(s, out)[k] = src[k];
    }
    __syncwarp(mask);
}

// The point at position e of (24, n) limb tensors into the three slots at
// dst, word k = coordinate * 12 + word by thread k % kTeam.
__device__ __forceinline__ void team_load(uint32_t* dst, const int32_t* x, const int32_t* y,
                                          const int32_t* z, int64_t n, int64_t e, int r) {
    for (int k = r; k < 36; k += kTeam) {
        const int32_t* src = k < 12 ? x : k < 24 ? y : z;
        const int w = k % 12;
        const uint32_t lo = static_cast<uint32_t>(src[(2 * w) * n + e]) & 0xFFFFu;
        const uint32_t hi = static_cast<uint32_t>(src[(2 * w + 1) * n + e]) & 0xFFFFu;
        dst[k] = lo | (hi << 16);
    }
}

__device__ __forceinline__ void team_store(int32_t* x, int32_t* y, int32_t* z,
                                           const uint32_t* src, int64_t n, int64_t e, int r) {
    for (int k = r; k < 36; k += kTeam) {
        int32_t* dst = k < 12 ? x : k < 24 ? y : z;
        const int w = k % 12;
        dst[(2 * w) * n + e] = static_cast<int32_t>(src[k] & 0xFFFFu);
        dst[(2 * w + 1) * n + e] = static_cast<int32_t>(src[k] >> 16);
    }
}

__device__ __forceinline__ unsigned team_mask() {
    return 0xFu << ((threadIdx.x & 31u) & ~3u);
}

// acc = the identity; for w = W - 1 down to 0: acc = 2^c acc + T_w. A
// doubling of an identity acc is skipped (add(acc, acc) returns it with its
// limbs), so the top window's add returns T_{W-1} as it is.
__global__ void __launch_bounds__(kThreads)
horner_chain_kernel(const int32_t* __restrict__ tx, const int32_t* __restrict__ ty,
                    const int32_t* __restrict__ tz, int32_t* __restrict__ ox,
                    int32_t* __restrict__ oy, int32_t* __restrict__ oz, int64_t W, int64_t n,
                    int64_t c) {
    __shared__ uint32_t scratch[kLanes][kSlots * 12];
    const int r = threadIdx.x % kTeam;
    const int64_t e = static_cast<int64_t>(blockIdx.x) * kLanes + threadIdx.x / kTeam;
    if (e >= n) return;  // the whole team
    const unsigned mask = team_mask();
    uint32_t* s = scratch[threadIdx.x / kTeam];
    int cur = kP0, nxt = kP1;
    if (r == 0) {
#pragma unroll
        for (int k = 0; k < 12; ++k) {
            slot(s, cur)[k] = slot(s, cur + 1)[k] = FQ_ONE[k];
            slot(s, cur + 2)[k] = 0;
        }
    }
    for (int64_t w = W - 1; w >= 0; --w) {
        const int64_t off = w * 24 * n;
        team_load(slot(s, kQ), tx + off, ty + off, tz + off, n, e, r);
        __syncwarp(mask);
        for (int64_t i = 0; i < c; ++i) {
            if (is_zero<Fq>(slot(s, cur + 2))) break;  // stays the identity, limbs kept
            team_double(s, r, mask, cur, nxt);
            const int t = cur;
            cur = nxt;
            nxt = t;
        }
        team_add(s, r, mask, cur, kQ, nxt);
        const int t = cur;
        cur = nxt;
        nxt = t;
    }
    team_store(ox, oy, oz, slot(s, cur), n, e, r);
}

// Bucket b of nbatch * B: keys (n,) the window's sorted buckets; heads (m K
// = n,) the segment heads in the chain layout; chain l = row K + col owns
// the sorted run [l mv, (l + 1) mv), mv = n / (K rows), its element i at
// layout position (i rows + row) K + col; scan (24, n) the bucket scan's
// outputs in that layout; summ (24, K rows) B3's inclusive prefix of the
// chain finals.
__global__ void __launch_bounds__(kThreads)
bucket_fixup_kernel(const int32_t* __restrict__ sx, const int32_t* __restrict__ sy,
                    const int32_t* __restrict__ sz, const int64_t* __restrict__ keys,
                    const int32_t* __restrict__ heads, const int32_t* __restrict__ cx,
                    const int32_t* __restrict__ cy, const int32_t* __restrict__ cz,
                    int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                    int32_t* __restrict__ oz, int64_t n, int64_t K, int64_t rows,
                    int64_t nbatch, int64_t B) {
    __shared__ uint32_t scratch[kLanes][kSlots * 12];
    const int r = threadIdx.x % kTeam;
    const int64_t nb = nbatch * B;
    const int64_t b = static_cast<int64_t>(blockIdx.x) * kLanes + threadIdx.x / kTeam;
    if (b >= nb) return;  // the whole team
    const unsigned mask = team_mask();
    uint32_t* s = scratch[threadIdx.x / kTeam];

    // pos = (keys <= b) - 1: the bucket's last sorted position
    int64_t lo = 0, hi = n;
    while (lo < hi) {
        const int64_t mid = (lo + hi) >> 1;
        if (keys[mid] <= b) {
            lo = mid + 1;
        } else {
            hi = mid;
        }
    }
    const int64_t pos = lo - 1;
    const int64_t posc = pos < 0 ? 0 : pos;
    const bool live = pos >= 0 && keys[posc] == b && b % B > 0;
    if (!live) {  // g1.infinity's limbs
        for (int k = r; k < 72; k += kTeam) {
            const int w = k % 24;
            const uint32_t one = FQ_ONE[w / 2];
            const int32_t v = static_cast<int32_t>(w & 1 ? one >> 16 : one & 0xFFFFu);
            (k < 24 ? ox : k < 48 ? oy : oz)[w * nb + b] = k < 48 ? v : 0;
        }
        return;
    }
    const int64_t mv = n / (K * rows);
    const int64_t l = posc / mv, i_of = posc % mv;
    const int64_t row = l / K, col = l % K;
    const int64_t flat = (i_of * rows + row) * K + col;

    // the run started in an earlier chain where no head precedes it in its
    // own: positions 0 .. i_of of chain l, a quarter on each thread
    int32_t any = 0;
    for (int64_t i = r; i <= i_of; i += kTeam) any |= heads[(i * rows + row) * K + col];
    any |= __shfl_xor_sync(mask, any, 1);
    any |= __shfl_xor_sync(mask, any, 2);
    if (any != 0 || l == 0) {  // the scan value as it is (chain 0's carry is the identity)
        for (int k = r; k < 72; k += kTeam) {
            const int w = k % 24;
            const int32_t* src = k < 24 ? sx : k < 48 ? sy : sz;
            (k < 24 ? ox : k < 48 ? oy : oz)[w * nb + b] = src[w * n + flat];
        }
        return;
    }
    team_load(slot(s, kP0), sx, sy, sz, n, flat, r);
    team_load(slot(s, kQ), cx, cy, cz, K * rows, l - 1, r);
    __syncwarp(mask);
    team_add(s, r, mask, kP0, kQ, kP1);
    team_store(ox, oy, oz, slot(s, kP1), nb, b, r);
}

unsigned blocks_for(int64_t lanes) { return static_cast<unsigned>((lanes + kLanes - 1) / kLanes); }

}  // namespace

extern "C" int g1_horner_chain(const int32_t* tx, const int32_t* ty, const int32_t* tz,
                               int32_t* ox, int32_t* oy, int32_t* oz, int64_t W, int64_t n,
                               int64_t c, void* stream) {
    horner_chain_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        tx, ty, tz, ox, oy, oz, W, n, c);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int g1_bucket_fixup(const int32_t* sx, const int32_t* sy, const int32_t* sz,
                               const int64_t* keys, const int32_t* heads, const int32_t* cx,
                               const int32_t* cy, const int32_t* cz, int32_t* ox, int32_t* oy,
                               int32_t* oz, int64_t n, int64_t K, int64_t rows, int64_t nbatch,
                               int64_t B, void* stream) {
    bucket_fixup_kernel<<<blocks_for(nbatch * B), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        sx, sy, sz, keys, heads, cx, cy, cz, ox, oy, oz, n, K, rows, nbatch, B);
    return static_cast<int>(cudaGetLastError());
}
