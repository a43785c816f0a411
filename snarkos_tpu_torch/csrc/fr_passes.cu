// Kernel B1's two Fr passes of the prover, each one launch:
//   fr_poseidon_permute  the Poseidon sponge of ops/poseidon.py (hash_fixed:
//                        the capacity seed, the absorbs, every permutation,
//                        the squeeze) or one permutation of a given state,
//                        one lane a thread: at widths t = 2 .. 9 the state
//                        in registers (a template a width), at any wider t
//                        in a global scratch (one kernel of runtime width);
//   fr_epoch_program     all steps of the epoch program of ops/puzzle.py
//                        (EpochProgram.apply), one cluster of blocks a
//                        nonce (16 from K = 16 lanes on), the nonce's state
//                        in the cluster's shared memory, for K up to 58,112
//                        lanes;
//   fr_epoch_program_global  the same steps for any B x K: one cooperative
//                        launch, the lanes in two global buffers with the B
//                        nonces of a lane side by side, a grid barrier a
//                        step. ops/puzzle.py: epoch_plan picks the variant
//                        on (B, K).
//
// Replace the TPU kernel snarkos_tpu/ops/modarith.py `_mont_mul_pallas`
// (lines 171-208) where the JAX package runs these passes as XLA-fused
// modarith ops under lax.scan (snarkos_tpu/ops/poseidon.py:69-88,
// snarkos_tpu/ops/puzzle.py:159-191).
//
// Bound on this card. The permutation: the 32-bit multiplies, one lane's
// being independent of every other's; the design cuts them with the sparse
// partial rounds of the Poseidon paper (appendix B; constants derived and
// packed by ops/poseidon.py: kernel_consts), each MDS row summed as
// unreduced 512-bit products and reduced once (in chunks of 13 products at
// the wide widths), and a squaring that forms each cross product once. What
// holds it at about twice that bound is the instructions issued (the
// chains' adds and moves): the squaring saves 28 of 64 word products and
// ties field.cuh's multiply on time (scripts/sweep_fr_passes.py). The wide
// kernel's state, 64 t bytes a lane, is read and written through L1 and
// L2. The epoch program: one product a lane a step before the bytes,
// and at the prover's widths the latency of its 12 dependent steps (a
// remote load, a product, a cluster barrier); the cluster variant keeps the
// state on chip between the steps. In global memory a step reads each lane,
// its partner and its constant and writes the lane; with a lane's B nonces
// side by side a partner is one run of B x 32 bytes, and a lane's constant
// and wiring word are read once for its B nonces.
#include <cooperative_groups.h>

#include "field.cuh"

using namespace snark;
namespace cg = cooperative_groups;

// -- wide products, one reduction ------------------------------------------------

constexpr int FN = Fr::N;       // 8 words an element
constexpr int WIDE = 2 * FN;    // 16 words a product

// t = e + o, 2N words each (the two halves of a wide product)
__device__ __forceinline__ void merge_wide(uint32_t* t, const uint32_t* e, const uint32_t* o) {
    t[0] = e[0];  // o[0] is never written
    t[1] = add_cc(e[1], o[1]);
#pragma unroll
    for (int k = 2; k < WIDE - 1; ++k) t[k] = addc_cc(e[k], o[k]);
    t[WIDE - 1] = addc(e[WIDE - 1], o[WIDE - 1]);
}

// t = a b as 2N words, operand scanning. For each word b_i the products a_j
// b_i of even j go to array e (low word at i + j, high at i + j + 1: one
// chain over words i .. i + N - 1), those of odd j to array o (words i + 1 ..
// i + N). Each chain carries into the word above it, which no earlier chain
// has reached (e[i + N], o[i + N + 1]), so no carry ripples further; o's last
// chain ends at word 2N - 1 and cannot carry out, since a b < 2^(64 N).
// Then t = e + o.
__device__ __forceinline__ void mul_wide(uint32_t* t, const uint32_t* a, const uint32_t* b) {
    uint32_t e[WIDE], o[WIDE];
#pragma unroll
    for (int k = 0; k < WIDE; ++k) e[k] = o[k] = 0;
#pragma unroll
    for (int i = 0; i < FN; ++i) {
        const uint32_t bi = b[i];
        e[i] = mad_lo_cc(a[0], bi, e[i]);
        e[i + 1] = madc_hi_cc(a[0], bi, e[i + 1]);
#pragma unroll
        for (int j = 2; j < FN; j += 2) {
            e[i + j] = madc_lo_cc(a[j], bi, e[i + j]);
            e[i + j + 1] = madc_hi_cc(a[j], bi, e[i + j + 1]);
        }
        e[i + FN] = addc(e[i + FN], 0);
        o[i + 1] = mad_lo_cc(a[1], bi, o[i + 1]);
        o[i + 2] = madc_hi_cc(a[1], bi, o[i + 2]);
#pragma unroll
        for (int j = 3; j < FN - 2; j += 2) {
            o[i + j] = madc_lo_cc(a[j], bi, o[i + j]);
            o[i + j + 1] = madc_hi_cc(a[j], bi, o[i + j + 1]);
        }
        o[i + FN - 1] = madc_lo_cc(a[FN - 1], bi, o[i + FN - 1]);
        if (i + 1 < FN) {
            o[i + FN] = madc_hi_cc(a[FN - 1], bi, o[i + FN]);
            o[i + FN + 1] = addc(o[i + FN + 1], 0);
        } else {
            o[i + FN] = madc_hi(a[FN - 1], bi, o[i + FN]);
        }
    }
    merge_wide(t, e, o);
}

// t = a^2 as 2N words: the cross products a_j a_i, j > i, once each (mul_wide's
// rows, row i keeping only j > i: the even-j chain covers words i + j0 .. i +
// N - 1 and carries into e[i + N], the odd-j chain words i + j1 .. i + N and
// carries into o[i + N + 1], none reached before), their sum x < 2^(64 N - 1)
// doubled, then the squares a_i^2 added at words 2i, 2i + 1 in one chain.
// 36 word products where a multiply has 64.
__device__ __forceinline__ void sqr_wide(uint32_t* t, const uint32_t* a) {
    uint32_t e[WIDE], o[WIDE], x[WIDE];
#pragma unroll
    for (int k = 0; k < WIDE; ++k) e[k] = o[k] = 0;
#pragma unroll
    for (int i = 0; i < FN - 1; ++i) {
        const uint32_t ai = a[i];
        const int j0 = (i + 2) & ~1;  // the first even j > i
        if (j0 < FN) {
            e[i + j0] = mad_lo_cc(a[j0], ai, e[i + j0]);
            e[i + j0 + 1] = madc_hi_cc(a[j0], ai, e[i + j0 + 1]);
#pragma unroll
            for (int j = j0 + 2; j < FN; j += 2) {
                e[i + j] = madc_lo_cc(a[j], ai, e[i + j]);
                e[i + j + 1] = madc_hi_cc(a[j], ai, e[i + j + 1]);
            }
            e[i + FN] = addc(e[i + FN], 0);
        }
        const int j1 = (i + 1) | 1;  // the first odd j > i
        o[i + j1] = mad_lo_cc(a[j1], ai, o[i + j1]);
        o[i + j1 + 1] = madc_hi_cc(a[j1], ai, o[i + j1 + 1]);
#pragma unroll
        for (int j = j1 + 2; j < FN; j += 2) {
            o[i + j] = madc_lo_cc(a[j], ai, o[i + j]);
            o[i + j + 1] = madc_hi_cc(a[j], ai, o[i + j + 1]);
        }
        o[i + FN + 1] = addc(o[i + FN + 1], 0);
    }
    merge_wide(x, e, o);
    t[0] = x[0] << 1;
#pragma unroll
    for (int k = 1; k < WIDE; ++k) t[k] = __funnelshift_l(x[k - 1], x[k], 1);
    t[0] = mad_lo_cc(a[0], a[0], t[0]);
    t[1] = madc_hi_cc(a[0], a[0], t[1]);
#pragma unroll
    for (int i = 1; i < FN - 1; ++i) {
        t[2 * i] = madc_lo_cc(a[i], a[i], t[2 * i]);
        t[2 * i + 1] = madc_hi_cc(a[i], a[i], t[2 * i + 1]);
    }
    t[WIDE - 2] = madc_lo_cc(a[FN - 1], a[FN - 1], t[WIDE - 2]);
    t[WIDE - 1] = madc_hi(a[FN - 1], a[FN - 1], t[WIDE - 1]);
}

// t += u, 2N words; the caller keeps the sum below 2^(64 N).
__device__ __forceinline__ void add_wide(uint32_t* t, const uint32_t* u) {
    t[0] = add_cc(t[0], u[0]);
#pragma unroll
    for (int k = 1; k < WIDE - 1; ++k) t[k] = addc_cc(t[k], u[k]);
    t[WIDE - 1] = addc(t[WIDE - 1], u[WIDE - 1]);
}

// One word of the reduction after the first: mont_row (field.cuh) with m p
// in place of its product. On entry ``even`` holds the word before's B and
// ``odd`` its A (A_0 == 0); T / 2^32 = (B + A_1) + 2^32 (A >> 64): B_0 + A_1
// gives the new A_0 and m, and the chain that shifts A down two words adds
// the odd words of m p and the carry of B_0 + A_1 (m's multiply between the
// two touches no carry flag), then the even words of m p zero the new A_0.
__device__ __forceinline__ void redc_row(uint32_t* even, uint32_t* odd) {
    uint32_t p[FN];
#pragma unroll
    for (int j = 0; j < FN; ++j) p[j] = Fr::p(j);
    even[0] = add_cc(even[0], odd[1]);
    const uint32_t m = even[0] * Fr::INV;
    madc_rshift<FN>(odd, p + 1, m);
    mad_even<FN>(even, p, m);
    odd[FN - 1] = addc(odd[FN - 1], 0);
}

// r = t R^-1 mod p, canonical, for t < p R (R = 2^256): the low half
// reduced word by word as field.cuh's mont_mul reduces (to (t_lo + M p) / R
// <= p), plus the high half t_hi < p, is below 2p; one conditional subtract.
__device__ __forceinline__ void redc_wide(uint32_t* r, const uint32_t* t) {
    uint32_t x[FN], y[FN], s[FN];
#pragma unroll
    for (int j = 0; j < FN; ++j) {
        x[j] = t[j];
        y[j] = 0;
    }
    mont_reduce<Fr>(x, y);
#pragma unroll
    for (int i = 1; i < FN; ++i) {
        if (i & 1) {
            redc_row(y, x);
        } else {
            redc_row(x, y);
        }
    }
    // N - 1 is odd: y holds A, x holds B; the low half's part is x + (y >> 32)
    s[0] = add_cc(x[0], y[1]);
#pragma unroll
    for (int j = 1; j < FN - 1; ++j) s[j] = addc_cc(x[j], y[j + 1]);
    s[FN - 1] = addc(x[FN - 1], 0);
    s[0] = add_cc(s[0], t[FN]);
#pragma unroll
    for (int j = 1; j < FN - 1; ++j) s[j] = addc_cc(s[j], t[FN + j]);
    s[FN - 1] = addc(s[FN - 1], t[WIDE - 1]);
    cond_sub_p<Fr>(r, s);
}

// r = a^2 R^-1 mod p: the Montgomery squaring of this pass (field.cuh's sqr,
// which the other kernels use, is mont_mul(a, a)).
__device__ __forceinline__ void fr_sqr(uint32_t* r, const uint32_t* a) {
    uint32_t t[WIDE];
    sqr_wide(t, a);
    redc_wide(r, t);
}

// r = sum_j m[j] s[j] R^-1 mod p, the T products summed unreduced and
// reduced once: for T <= 13 the sum is below T (p - 1)^2 < p R (Fr has 253
// bits, R / p = 13.7; tests/test_torch_fr_passes_b1.py checks the bound and
// that it fails at 14), as redc_wide needs. m: T constants (shared memory),
// s: T state slots (registers).
template <int T>
__device__ __forceinline__ void dot_row(uint32_t* r, const uint32_t (*m)[FN],
                                        const uint32_t (*s)[FN]) {
    static_assert(T <= 13, "the lazy row's bound holds for t <= 13");
    uint32_t acc[WIDE];
    mul_wide(acc, s[0], m[0]);
#pragma unroll
    for (int j = 1; j < T; ++j) {
        uint32_t prod[WIDE];
        mul_wide(prod, s[j], m[j]);
        add_wide(acc, prod);
    }
    redc_wide(r, acc);
}

// -- the Poseidon permutation over Fr, sparse partial rounds ---------------------

constexpr int POSEIDON_FULL = 8;
constexpr int POSEIDON_HALF_FULL = POSEIDON_FULL / 2;
constexpr int POSEIDON_PARTIAL = 31;

// Offsets, in elements, of ops/poseidon.py's kernel_layout(T).
template <int T>
struct PoseidonLayout {
    static constexpr int kArkFirst = 0;
    static constexpr int kMds = kArkFirst + POSEIDON_HALF_FULL * T;
    static constexpr int kMPre = kMds + T * T;
    static constexpr int kPre = kMPre + T * T;
    static constexpr int kPartial = kPre + T;  // post, row0 (T), w (T - 1) a round
    static constexpr int kArkLast = kPartial + POSEIDON_PARTIAL * 2 * T;
    static constexpr int kSize = kArkLast + POSEIDON_HALF_FULL * T;
};

// x = x^17 = ((((x^2)^2)^2)^2) x
__device__ __forceinline__ void sbox17(uint32_t* x) {
    uint32_t y[FN];
    copy<Fr>(y, x);
#pragma unroll 1
    for (int i = 0; i < 4; ++i) fr_sqr(y, y);
    mont_mul<Fr>(x, y, x);
}

// s[0 .. T-1] = s[1 .. T-1], s[0]: the loops over slots below run one copy of
// their body on s[0] and rotate, so that the code holds one s-box and one
// MDS row, not T.
template <int T>
__device__ __forceinline__ void rotate(uint32_t (*s)[FN]) {
    uint32_t first[FN];
    copy<Fr>(first, s[0]);
#pragma unroll
    for (int i = 0; i < T - 1; ++i) copy<Fr>(s[i], s[i + 1]);
    copy<Fr>(s[T - 1], first);
}

// s = m sbox(s + ark), m dense (T x T, row-major)
template <int T>
__device__ __forceinline__ void full_round(uint32_t (*s)[FN], const uint32_t (*ark)[FN],
                                           const uint32_t (*m)[FN]) {
#pragma unroll 1
    for (int i = 0; i < T; ++i) {
        add<Fr>(s[0], s[0], ark[i]);
        sbox17(s[0]);
        rotate<T>(s);
    }
    uint32_t out[T][FN] = {};
#pragma unroll 1
    for (int i = 0; i < T; ++i) {
        dot_row<T>(out[0], m + i * T, s);
        rotate<T>(out);  // row i ends in out[i] after the last turn
    }
#pragma unroll
    for (int i = 0; i < T; ++i) copy<Fr>(s[i], out[i]);
}

// x0 = sbox(s0) + post; s = (row0 . (x0, s1, ..), s1 + w_0 x0, .., s_{T-1} + w_{T-2} x0)
// with c = post, row0 (T), w (T - 1)
template <int T>
__device__ __forceinline__ void partial_round(uint32_t (*s)[FN], const uint32_t (*c)[FN]) {
    sbox17(s[0]);
    add<Fr>(s[0], s[0], c[0]);
    uint32_t new0[FN];
    dot_row<T>(new0, c + 1, s);
#pragma unroll
    for (int i = 1; i < T; ++i) {
        uint32_t p[FN];
        mont_mul<Fr>(p, s[0], c[T + i]);
        add<Fr>(s[i], s[i], p);
    }
    copy<Fr>(s[0], new0);
}

template <int T>
__device__ __forceinline__ void permute_state(uint32_t (*s)[FN], const uint32_t (*c)[FN]) {
    using Lay = PoseidonLayout<T>;
#pragma unroll 1
    for (int r = 0; r < POSEIDON_FULL; ++r) {
        const int ark = r < POSEIDON_HALF_FULL ? Lay::kArkFirst + r * T
                                               : Lay::kArkLast + (r - POSEIDON_HALF_FULL) * T;
        full_round<T>(s, c + ark, c + (r == POSEIDON_HALF_FULL - 1 ? Lay::kMPre : Lay::kMds));
        if (r == POSEIDON_HALF_FULL - 1) {
#pragma unroll
            for (int i = 0; i < T; ++i) add<Fr>(s[i], s[i], c[Lay::kPre + i]);
#pragma unroll 1
            for (int p = 0; p < POSEIDON_PARTIAL; ++p)
                partial_round<T>(s, c + Lay::kPartial + p * 2 * T);
        }
    }
}

// Absorb the next rate block: inputs k, k + 1, .. (those below n_in) added to
// slots 1, 2, ..
template <int T>
__device__ __forceinline__ void absorb(uint32_t (*s)[FN], const int32_t* __restrict__ inputs,
                                       int64_t B, int64_t e, int64_t& k, int64_t n_in) {
#pragma unroll
    for (int i = 1; i < T; ++i) {
        if (k < n_in) {
            uint32_t x[FN];
            load<Fr>(x, inputs + 16 * B * k, B, e);
            add<Fr>(s[i], s[i], x);
            ++k;
        }
    }
}

// Two modes, one lane a thread. state != null: s = state (T, 16, B), one
// permutation, out (T, 16, B) = s. Else the sponge of ref/poseidon.py's
// hash_many: s = (domain, 0, ..), the n_in inputs (n_in, 16, B) absorbed a
// rate block at a time with a permutation between blocks, then a permutation
// before each squeezed block of slots 1 .. T - 1 until out (n_out, 16, B) is
// full. consts: kernel_layout(T) elements of 16 limbs, which each block packs
// into shared memory once (every lane reads the same words: broadcast).
template <int T>
__global__ void __launch_bounds__(128)
    fr_poseidon_kernel(const int32_t* __restrict__ state, const int32_t* __restrict__ inputs,
                       const int32_t* __restrict__ domain, const int32_t* __restrict__ consts,
                       int32_t* __restrict__ out, int64_t B, int64_t n_in, int64_t n_out) {
    using Lay = PoseidonLayout<T>;
    __shared__ __align__(16) uint32_t c[Lay::kSize][FN];
    for (int k = threadIdx.x; k < Lay::kSize; k += blockDim.x) load<Fr>(c[k], consts + 16 * k, 1, 0);
    __syncthreads();
    const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (e >= B) return;

    uint32_t s[T][FN];
    if (state != nullptr) {
#pragma unroll
        for (int i = 0; i < T; ++i) load<Fr>(s[i], state + 16 * B * i, B, e);
    } else {
        load<Fr>(s[0], domain, 1, 0);
#pragma unroll
        for (int i = 1; i < T; ++i)
#pragma unroll
            for (int w = 0; w < FN; ++w) s[i][w] = 0;
    }
    const int first = state != nullptr ? 0 : 1;  // the first slot squeezed
    int64_t k = 0, o = 0;
    absorb<T>(s, inputs, B, e, k, n_in);
    for (;;) {
        permute_state<T>(s, c);
        if (k < n_in) {
            absorb<T>(s, inputs, B, e, k, n_in);
            continue;
        }
#pragma unroll
        for (int i = 0; i < T; ++i) {
            if (i >= first && o < n_out) {
                store<Fr>(out + 16 * B * o, s[i], B, e);
                ++o;
            }
        }
        if (o >= n_out) break;
    }
}

// Threads a block by lane count: the largest of 128, 64, 32 that still gives
// every SM a block, so that a narrow batch spreads over the card.
static int lane_threads(int64_t lanes) {
    static int sms = 0;
    if (sms == 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    int threads = 128;
    while (threads > 32 && (lanes + threads - 1) / threads < sms) threads /= 2;
    return threads;
}

template <int T>
static int launch_poseidon(const int32_t* state, const int32_t* inputs, const int32_t* domain,
                           const int32_t* consts, int32_t* out, int64_t B, int64_t n_in,
                           int64_t n_out, void* stream) {
    const int threads = lane_threads(B);
    const int64_t blocks = (B + threads - 1) / threads;
    fr_poseidon_kernel<T><<<static_cast<unsigned>(blocks), threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(state, inputs, domain, consts,
                                                                 out, B, n_in, n_out);
    return static_cast<int>(cudaGetLastError());
}

// -- the sponge at any width: the state in a global scratch -----------------------

// An MDS row's products summed unreduced at most this many at a time: the
// bound of dot_row, so that each chunk reduces once as redc_wide needs.
constexpr int ROW_CHUNK = 13;
constexpr int WIDE_THREADS = 64;

// One lane's t state slots in the scratch: slot i's word w at p[(i FN + w)
// stride], stride the lanes B, so that a warp's threads touch consecutive
// words.
struct Slots {
    uint32_t* p;
    int64_t stride;
    __device__ __forceinline__ void get(uint32_t* x, int i) const {
#pragma unroll
        for (int w = 0; w < FN; ++w) x[w] = p[(static_cast<int64_t>(i) * FN + w) * stride];
    }
    __device__ __forceinline__ void put(int i, const uint32_t* x) const {
#pragma unroll
        for (int w = 0; w < FN; ++w) p[(static_cast<int64_t>(i) * FN + w) * stride] = x[w];
    }
};

// constant k of the packed words (kernel_layout order, 32 bytes an element);
// every lane of a warp reads the same one
__device__ __forceinline__ void const_word(uint32_t* x, const uint4* __restrict__ cw, int64_t k) {
    const uint4 lo = __ldg(cw + 2 * k), hi = __ldg(cw + 2 * k + 1);
    x[0] = lo.x, x[1] = lo.y, x[2] = lo.z, x[3] = lo.w;
    x[4] = hi.x, x[5] = hi.y, x[6] = hi.z, x[7] = hi.w;
}

// r = sum_j c[m + j] s[j] R^-1 mod p over the t slots: chunks of at most
// ROW_CHUNK unreduced products, each reduced once to a canonical value, the
// chunks summed mod p.
__device__ __forceinline__ void wide_row(uint32_t* r, const uint4* __restrict__ cw, int64_t m,
                                         const Slots& s, int t) {
#pragma unroll 1
    for (int j0 = 0; j0 < t; j0 += ROW_CHUNK) {
        const int j1 = min(t, j0 + ROW_CHUNK);
        uint32_t acc[WIDE], a[FN], c[FN];
        s.get(a, j0);
        const_word(c, cw, m + j0);
        mul_wide(acc, a, c);
#pragma unroll 1
        for (int j = j0 + 1; j < j1; ++j) {
            uint32_t prod[WIDE];
            s.get(a, j);
            const_word(c, cw, m + j);
            mul_wide(prod, a, c);
            add_wide(acc, prod);
        }
        if (j0 == 0) {
            redc_wide(r, acc);
        } else {
            redc_wide(a, acc);
            add<Fr>(r, r, a);
        }
    }
}

// permute_state at runtime width t: s holds the state, o the second copy a
// full round writes; the two are swapped after each full round.
__device__ __forceinline__ void permute_wide(Slots& s, Slots& o, const uint4* __restrict__ cw,
                                             int t) {
    const int64_t tt = static_cast<int64_t>(t) * t;
    const int64_t mds = POSEIDON_HALF_FULL * t, m_pre = mds + tt, pre = m_pre + tt;
    const int64_t partial = pre + t, ark_last = partial + POSEIDON_PARTIAL * 2 * t;
#pragma unroll 1
    for (int r = 0; r < POSEIDON_FULL; ++r) {
        const int64_t ark = r < POSEIDON_HALF_FULL ? r * t : ark_last + (r - POSEIDON_HALF_FULL) * t;
        uint32_t x[FN], c[FN];
#pragma unroll 1
        for (int i = 0; i < t; ++i) {
            s.get(x, i);
            const_word(c, cw, ark + i);
            add<Fr>(x, x, c);
            sbox17(x);
            s.put(i, x);
        }
        const int64_t m = r == POSEIDON_HALF_FULL - 1 ? m_pre : mds;
#pragma unroll 1
        for (int i = 0; i < t; ++i) {
            wide_row(x, cw, m + static_cast<int64_t>(i) * t, s, t);
            o.put(i, x);
        }
        const Slots tmp = s;
        s = o;
        o = tmp;
        if (r == POSEIDON_HALF_FULL - 1) {
#pragma unroll 1
            for (int i = 0; i < t; ++i) {
                s.get(x, i);
                const_word(c, cw, pre + i);
                add<Fr>(x, x, c);
                s.put(i, x);
            }
#pragma unroll 1
            for (int p = 0; p < POSEIDON_PARTIAL; ++p) {  // post, row0 (t), w (t - 1)
                const int64_t k = partial + static_cast<int64_t>(p) * 2 * t;
                uint32_t x0[FN], new0[FN];
                s.get(x0, 0);
                sbox17(x0);
                const_word(c, cw, k);
                add<Fr>(x0, x0, c);
                s.put(0, x0);
                wide_row(new0, cw, k + 1, s, t);
#pragma unroll 1
                for (int i = 1; i < t; ++i) {
                    const_word(c, cw, k + t + i);
                    mont_mul<Fr>(c, x0, c);
                    s.get(x, i);
                    add<Fr>(x, x, c);
                    s.put(i, x);
                }
                s.put(0, new0);
            }
        }
    }
}

// fr_poseidon_kernel's two modes at any width t, one lane a thread, the
// lane's two state copies in ``scratch`` ((2 t, FN, B) words). cw: the
// constants as 32-byte Montgomery words (ops/poseidon.py: kernel_words),
// read through the read-only cache. A thread touches only its own lane's
// slots, so that it reads back what it wrote through its SM's L1: no
// barrier.
__global__ void __launch_bounds__(WIDE_THREADS)
    fr_poseidon_wide_kernel(const int32_t* __restrict__ state, const int32_t* __restrict__ inputs,
                            const int32_t* __restrict__ domain, const uint4* __restrict__ cw,
                            int32_t* __restrict__ out, uint32_t* scratch, int64_t B, int t,
                            int64_t n_in, int64_t n_out) {
    const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (e >= B) return;
    Slots s{scratch + e, B};
    Slots o{s.p + static_cast<int64_t>(t) * FN * B, B};
    uint32_t x[FN];
    if (state != nullptr) {
#pragma unroll 1
        for (int i = 0; i < t; ++i) {
            load<Fr>(x, state + 16 * B * i, B, e);
            s.put(i, x);
        }
    } else {
        load<Fr>(x, domain, 1, 0);
        s.put(0, x);
#pragma unroll
        for (int w = 0; w < FN; ++w) x[w] = 0;
#pragma unroll 1
        for (int i = 1; i < t; ++i) s.put(i, x);
    }
    const int first = state != nullptr ? 0 : 1;
    int64_t k = 0, n = 0;
    auto absorb = [&]() {
#pragma unroll 1
        for (int i = 1; i < t && k < n_in; ++i, ++k) {
            uint32_t y[FN];
            load<Fr>(y, inputs + 16 * B * k, B, e);
            s.get(x, i);
            add<Fr>(x, x, y);
            s.put(i, x);
        }
    };
    absorb();
    for (;;) {
        permute_wide(s, o, cw, t);
        if (k < n_in) {
            absorb();
            continue;
        }
#pragma unroll 1
        for (int i = first; i < t && n < n_out; ++i, ++n) {
            s.get(x, i);
            store<Fr>(out + 16 * B * n, x, B, e);
        }
        if (n >= n_out) break;
    }
}

static int launch_poseidon_wide(const int32_t* state, const int32_t* inputs,
                                const int32_t* domain, const int32_t* consts, int32_t* out,
                                int32_t* scratch, int64_t B, int t, int64_t n_in, int64_t n_out,
                                void* stream) {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    int threads = lane_threads(B);
    if (threads > WIDE_THREADS) threads = WIDE_THREADS;
    const int64_t blocks = (B + threads - 1) / threads;
    fr_poseidon_wide_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        state, inputs, domain, reinterpret_cast<const uint4*>(consts), out,
        reinterpret_cast<uint32_t*>(scratch), B, t, n_in, n_out);
    return static_cast<int>(cudaGetLastError());
}

// t = rate + 1 state slots, t >= 2. At t = 2 .. 9 (the rates 1 - 8:
// snarkVM's Poseidon2, 4 and 8 among them; the prover's leaves, the
// pipeline and the challenge use 2) the register template of that width,
// consts the limbs of kernel_consts, scratch unused; at any wider t the
// wide kernel, consts the words of kernel_words, scratch (2 t, 8, B) words.
// state null: the sponge (inputs, domain, n_in, n_out >= 1); else one
// permutation (n_in 0, n_out t).
extern "C" int fr_poseidon_permute(const int32_t* state, const int32_t* inputs,
                                   const int32_t* domain, const int32_t* consts, int32_t* out,
                                   int32_t* scratch, int64_t B, int64_t t, int64_t n_in,
                                   int64_t n_out, void* stream) {
    if (n_out < 1 || t < 2 || t > 0x7FFFFFFF || (state != nullptr && (n_in != 0 || n_out != t)) ||
        (state == nullptr && domain == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    if (t > 9)
        return launch_poseidon_wide(state, inputs, domain, consts, out, scratch, B,
                                    static_cast<int>(t), n_in, n_out, stream);
    switch (t) {
#define FR_POSEIDON_WIDTH(W) \
    case W:                  \
        return launch_poseidon<W>(state, inputs, domain, consts, out, B, n_in, n_out, stream);
        FR_POSEIDON_WIDTH(2)
        FR_POSEIDON_WIDTH(3)
        FR_POSEIDON_WIDTH(4)
        FR_POSEIDON_WIDTH(5)
        FR_POSEIDON_WIDTH(6)
        FR_POSEIDON_WIDTH(7)
        FR_POSEIDON_WIDTH(8)
        FR_POSEIDON_WIDTH(9)
#undef FR_POSEIDON_WIDTH
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}

// -- the epoch program ------------------------------------------------------------

constexpr int EPOCH_MAX_THREADS = 512;
constexpr int EPOCH_GLOBAL_THREADS = 256;
constexpr int EPOCH_MAX_CLUSTER = 16;
constexpr size_t EPOCH_MAX_SMEM = 227 * 1024;

// v, out: (16, B, K) limbs; ps: (steps, K) int32 wiring words, perm |
// sel << 30; cw: (steps, K) constants as 32-byte Montgomery words
// (ops/puzzle.py: side_tables, built once an epoch). Step s: lane (b, k)
// pairs v with its partner u = v at (b, perm) and takes, by sel, v u + c,
// v^2 + u, v c - u or (else) v^2 - u^2 + c, the last as (v - u)(v + u) + c:
// one product a lane, the operands picked by the selector, so that a warp's
// lanes never diverge on a product. A lane is 32 bytes in the buffers
// between steps (two 16-byte words, so that a partner comes in two loads).
constexpr uint32_t EPOCH_PERM_MASK = 0x3FFFFFFFu;

__device__ __forceinline__ void unpack(uint32_t* x, const uint4* src) {
    const uint4 lo = src[0], hi = src[1];
    x[0] = lo.x, x[1] = lo.y, x[2] = lo.z, x[3] = lo.w;
    x[4] = hi.x, x[5] = hi.y, x[6] = hi.z, x[7] = hi.w;
}

// unpack through L2 only: the lanes were written by other blocks in this
// launch, and the per-SM L1 is not coherent
__device__ __forceinline__ void unpack_cg(uint32_t* x, const uint4* src) {
    const uint4 lo = __ldcg(src), hi = __ldcg(src + 1);
    x[0] = lo.x, x[1] = lo.y, x[2] = lo.z, x[3] = lo.w;
    x[4] = hi.x, x[5] = hi.y, x[6] = hi.z, x[7] = hi.w;
}

// unpack through the read-only cache: a table no thread writes in the launch
__device__ __forceinline__ void unpack_ldg(uint32_t* x, const uint4* src) {
    const uint4 lo = __ldg(src), hi = __ldg(src + 1);
    x[0] = lo.x, x[1] = lo.y, x[2] = lo.z, x[3] = lo.w;
    x[4] = hi.x, x[5] = hi.y, x[6] = hi.z, x[7] = hi.w;
}

__device__ __forceinline__ void pack(uint4* dst, const uint32_t* x) {
    dst[0] = make_uint4(x[0], x[1], x[2], x[3]);
    dst[1] = make_uint4(x[4], x[5], x[6], x[7]);
}

// r = lane x's next value from its partner u, constant c and selector sl
__device__ __forceinline__ void epoch_lane(uint32_t* r, const uint32_t* x, const uint32_t* u,
                                           const uint32_t* cc, int sl) {
    uint32_t d[FN], e[FN], a[FN], y[FN];
    const bool f3 = sl != 0 && sl != 1 && sl != 2;  // the plain version's else
    sub<Fr>(d, x, u);
    add<Fr>(e, x, u);
#pragma unroll
    for (int w = 0; w < FN; ++w) {
        a[w] = f3 ? d[w] : x[w];
        y[w] = sl == 0 ? u[w] : (sl == 1 ? x[w] : (sl == 2 ? cc[w] : e[w]));
        e[w] = sl == 1 ? u[w] : cc[w];  // the addend of sels 0, 1, 3
    }
    mont_mul<Fr>(y, a, y);
    add<Fr>(r, y, e);
    sub<Fr>(d, y, u);
#pragma unroll
    for (int w = 0; w < FN; ++w) r[w] = sl == 2 ? d[w] : r[w];
}

__device__ __forceinline__ void prefetch_l1(const void* p) {
    asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
}

// Nonce b is one cluster of C blocks (C given at launch, a power of two up
// to 16 and at most K). Block rank q holds lanes [q kb, min(K, (q + 1) kb)),
// kb = ceil(K / C), so that the owner of partner j is j / kb; the last
// ranks hold fewer lanes, or none. Threads a block: kb rounded up to a warp,
// at most 512. A rank keeps its lanes in shared memory in two buffers of kb
// lanes: step s reads buffer s & 1, here and in the partner's block
// (distributed shared memory), and writes its lane into the other; one
// cluster barrier a step orders every read of a buffer before the step that
// overwrites it. Between its arrive and its wait a thread prefetches the
// next step's wiring word and constant of its first lane into L1. The
// leaves are read and the coefficients written once.
__global__ void __launch_bounds__(EPOCH_MAX_THREADS)
    fr_epoch_program_kernel(const int32_t* __restrict__ v, const int32_t* __restrict__ ps,
                            const uint4* __restrict__ cw, int32_t* __restrict__ out, int64_t B,
                            int64_t K, int64_t steps) {
    extern __shared__ uint4 buf[];  // [2][kb][2]
    cg::cluster_group cluster = cg::this_cluster();
    const int csize = static_cast<int>(cluster.num_blocks());
    const int rank = static_cast<int>(cluster.block_rank());
    const int64_t b = blockIdx.x / csize;
    const int kb = static_cast<int>((K + csize - 1) / csize);
    const int64_t n = B * K;
    const int64_t k0 = static_cast<int64_t>(rank) * kb;  // the block's first lane
    const int64_t left = K - k0;
    const int nb = left <= 0 ? 0 : (left < kb ? static_cast<int>(left) : kb);  // its lanes
    for (int kk = threadIdx.x; kk < nb; kk += blockDim.x) {
        uint32_t x[FN];
        load<Fr>(x, v + b * K, n, k0 + kk);
        pack(buf + 2 * kk, x);
    }
    cluster.sync();
    for (int64_t s = 0; s < steps; ++s) {
        const uint4* cur = buf + (s & 1) * 2 * kb;
        uint4* nxt = buf + ((s + 1) & 1) * 2 * kb;
        for (int kk = threadIdx.x; kk < nb; kk += blockDim.x) {
            const int64_t k = k0 + kk;
            const uint32_t word = static_cast<uint32_t>(__ldg(ps + s * K + k));
            const int j = static_cast<int>(word & EPOCH_PERM_MASK);
            uint32_t x[FN], u[FN], cc[FN], r[FN];
            unpack(x, cur + 2 * kk);
            unpack(u, cluster.map_shared_rank(cur, j / kb) + 2 * (j % kb));
            unpack_ldg(cc, cw + 2 * (s * K + k));
            epoch_lane(r, x, u, cc, static_cast<int>(word >> 30));
            pack(nxt + 2 * kk, r);
        }
        asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
        const int64_t k = k0 + threadIdx.x;
        if (threadIdx.x < nb && s + 1 < steps) {
            prefetch_l1(ps + (s + 1) * K + k);
            prefetch_l1(cw + 2 * ((s + 1) * K + k));  // 32 bytes, one line
        }
        asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
    }
    const uint4* fin = buf + (steps & 1) * 2 * kb;
    for (int kk = threadIdx.x; kk < nb; kk += blockDim.x) {
        uint32_t x[FN];
        unpack(x, fin + 2 * kk);
        store<Fr>(out + b * K, x, n, k0 + kk);
    }
}

// K lanes a nonce in clusters of ``cluster`` blocks: a power of two, at most
// 16 (above 8 a non-portable size, which this card allows) and at most K,
// with a block's two buffers of ceil(K / cluster) lanes (64 bytes a lane)
// in its 227 KiB of shared memory. ops/puzzle.py's epoch_plan picks
// min(16, the largest power of two <= K), so that this entry takes K = 1 ..
// 58,112; every other case is refused (cudaErrorInvalidValue). ps (steps,
// K) and cw (steps, K, 8) int32 as ops/puzzle.py: side_tables builds them.
extern "C" int fr_epoch_program(const int32_t* v, const int32_t* ps, const int32_t* cw,
                                int32_t* out, int64_t B, int64_t K, int64_t steps,
                                int64_t cluster, void* stream) {
    if (B < 1 || K < 1 || steps < 0 || cluster < 1 || cluster > EPOCH_MAX_CLUSTER ||
        (cluster & (cluster - 1)) != 0 || cluster > K || B * cluster > 0x7FFFFFFF)
        return static_cast<int>(cudaErrorInvalidValue);
    const int64_t kb = (K + cluster - 1) / cluster;
    const size_t smem = 2 * 2 * sizeof(uint4) * static_cast<size_t>(kb);
    if (smem > EPOCH_MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSuccess;
    if (smem > 48 * 1024)
        err = cudaFuncSetAttribute(fr_epoch_program_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem));
    if (err == cudaSuccess && cluster > 8)
        err = cudaFuncSetAttribute(fr_epoch_program_kernel,
                                   cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(cluster * B), 1, 1);
    cfg.blockDim = dim3(kb < EPOCH_MAX_THREADS ? static_cast<unsigned>((kb + 31) / 32 * 32)
                                               : EPOCH_MAX_THREADS, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, fr_epoch_program_kernel, v, ps,
                             reinterpret_cast<const uint4*>(cw), out, B, K, steps);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

// The same steps for any B x K, the lanes in global memory: one cooperative
// launch of at most the co-resident blocks, each thread walking the n = B K
// lanes grid-strided, one at a time. Between steps the lanes live in two
// buffers of ``scratch`` (64 n bytes, the size of the output), 32 bytes a
// lane, lane (b, k) at k B + b: the B nonces of a lane side by side, so
// that a partner's B values are one run of B x 32 bytes and the threads of
// a lane's B nonces sit side by side in a warp and read its wiring word and
// constant once between them. ps, cw: the side tables, as for the
// cluster variant. A first pass packs the leaves' limbs into buffer 0 (read
// nonce-major, b K + k, so that a warp's limb loads are consecutive; a
// partner read from the limbs would be 16 scattered sectors); step s reads
// buffer s & 1 through L2 (other blocks wrote it in this launch; the per-SM
// L1 is not coherent) and writes the other, the last step the output's
// limbs, nonce-major again. A grid barrier between passes. No __restrict__
// on scratch: it is written and read again within the launch.
__global__ void __launch_bounds__(EPOCH_GLOBAL_THREADS)
    fr_epoch_program_global_kernel(const int32_t* __restrict__ v, const int32_t* __restrict__ ps,
                                   const uint4* __restrict__ cw, int32_t* __restrict__ out,
                                   uint4* scratch, uint32_t B, uint32_t K, int64_t steps) {
    cg::grid_group grid = cg::this_grid();
    const uint32_t n = B * K;
    const uint32_t first = blockIdx.x * blockDim.x + threadIdx.x;
    const uint32_t stride = gridDim.x * blockDim.x;
    if (steps == 0) {
        for (uint32_t e = first; e < n; e += stride) {
            uint32_t x[FN];
            load<Fr>(x, v, n, e);
            store<Fr>(out, x, n, e);
        }
        return;
    }
    for (uint32_t e = first; e < n; e += stride) {  // the leaves into buffer 0
        const uint32_t b = e / K, k = e - b * K;
        uint32_t x[FN];
        load<Fr>(x, v, n, e);
        pack(scratch + 2 * (static_cast<int64_t>(k) * B + b), x);
    }
    grid.sync();
    for (int64_t s = 0; s < steps; ++s) {
        const uint4* cur = scratch + (s & 1) * 2 * static_cast<int64_t>(n);
        uint4* nxt = scratch + ((s + 1) & 1) * 2 * static_cast<int64_t>(n);
        const bool last = s + 1 == steps;  // writes the output's limbs: nonce-major
        const int32_t* ps_s = ps + s * K;
        const uint4* cw_s = cw + 2 * s * K;
        for (uint32_t e = first; e < n; e += stride) {
            uint32_t b, k;
            if (last) {
                b = e / K;
                k = e - b * K;
            } else {
                k = e / B;
                b = e - k * B;
            }
            const uint32_t word = static_cast<uint32_t>(__ldg(ps_s + k));
            const uint32_t j = word & EPOCH_PERM_MASK;
            uint32_t x[FN], u[FN], cc[FN], y[FN];
            unpack_cg(x, cur + 2 * (static_cast<int64_t>(k) * B + b));
            unpack_cg(u, cur + 2 * (static_cast<int64_t>(j) * B + b));
            unpack_ldg(cc, cw_s + 2 * static_cast<int64_t>(k));
            epoch_lane(y, x, u, cc, static_cast<int>(word >> 30));
            if (last) {
                store<Fr>(out, y, n, static_cast<int64_t>(b) * K + k);
            } else {
                pack(nxt + 2 * (static_cast<int64_t>(k) * B + b), y);
            }
        }
        if (!last) grid.sync();
    }
}

// Any B, K >= 1 with K < 2^30 (the wiring word) and B K < 2^31 (the leaves
// alone would then pass the card's memory); ps (steps, K) and cw (steps,
// K, 8) int32 as ops/puzzle.py: side_tables builds them; scratch holds 64 B
// K bytes (a (16, B, K) int32 tensor).
extern "C" int fr_epoch_program_global(const int32_t* v, const int32_t* ps, const int32_t* cw,
                                       int32_t* out, int32_t* scratch, int64_t B, int64_t K,
                                       int64_t steps, void* stream) {
    if (B < 1 || K < 1 || K > 0x3FFFFFFF || B * K > 0x7FFFFFFF || steps < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    constexpr int threads = EPOCH_GLOBAL_THREADS;
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, fr_epoch_program_global_kernel, threads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t n = B * K;
    int64_t blocks = (n + threads - 1) / threads;
    const int64_t resident = static_cast<int64_t>(per_sm) * sms;
    if (blocks > resident) blocks = resident;
    if (blocks < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    const uint4* words = reinterpret_cast<const uint4*>(cw);
    uint4* buf = reinterpret_cast<uint4*>(scratch);
    uint32_t b32 = static_cast<uint32_t>(B), k32 = static_cast<uint32_t>(K);
    void* args[] = {&v, &ps, &words, &out, &buf, &b32, &k32, &steps};
    err = cudaLaunchCooperativeKernel((const void*)fr_epoch_program_global_kernel,
                                      dim3(static_cast<unsigned>(blocks)), dim3(threads), args, 0,
                                      static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}
