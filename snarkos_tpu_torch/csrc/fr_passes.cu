// Kernel B1's two Fr passes of the prover, each one launch:
//   fr_poseidon_permute  the Poseidon sponge of ops/poseidon.py (hash_fixed:
//                        the capacity seed, the absorbs, every permutation,
//                        the squeeze) or one permutation of a given state,
//                        one lane a thread, the state in registers;
//   fr_epoch_program     all steps of the epoch program of ops/puzzle.py
//                        (EpochProgram.apply), one cluster of blocks a
//                        nonce (16 on the prover's path), the nonce's state
//                        in the cluster's shared memory.
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
// unreduced 512-bit products and reduced once, and a squaring that forms
// each cross product once. What holds it at about twice that bound is the
// instructions issued (the chains' adds and moves): the squaring saves 28
// of 64 word products and ties field.cuh's multiply on time
// (scripts/sweep_fr_passes.py). The epoch program: one product a lane a
// step before the bytes, and at the prover's widths the latency of its 12
// dependent steps (a remote load, a product, a cluster barrier); the design
// keeps the state on chip between the steps.
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
// reduced once: for T <= 5 the sum is below T (p - 1)^2 < p R (Fr has 253
// bits; tests/test_torch_fr_passes_b1.py checks the bound), as redc_wide
// needs. m: T constants (shared memory), s: T state slots (registers).
template <int T>
__device__ __forceinline__ void dot_row(uint32_t* r, const uint32_t (*m)[FN],
                                        const uint32_t (*s)[FN]) {
    static_assert(T <= 5, "the lazy row's bound holds for t <= 5");
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

// t = rate + 1 state slots: the rates 2 and 4 (the prover's leaves, the
// pipeline and the challenge use 2); any other width is refused. state null:
// the sponge (inputs, domain, n_in, n_out >= 1); else one permutation (n_in
// 0, n_out t).
extern "C" int fr_poseidon_permute(const int32_t* state, const int32_t* inputs,
                                   const int32_t* domain, const int32_t* consts, int32_t* out,
                                   int64_t B, int64_t t, int64_t n_in, int64_t n_out,
                                   void* stream) {
    if (n_out < 1 || (state != nullptr && (n_in != 0 || n_out != t)) ||
        (state == nullptr && domain == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    switch (t) {
        case 3:
            return launch_poseidon<3>(state, inputs, domain, consts, out, B, n_in, n_out, stream);
        case 5:
            return launch_poseidon<5>(state, inputs, domain, consts, out, B, n_in, n_out, stream);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}

// -- the epoch program ------------------------------------------------------------

constexpr int EPOCH_MAX_THREADS = 512;

// v, out: (16, B, K) limbs; perms, sels: (steps, K) int32; consts: (steps,
// 16, K) limbs. Step s: lane (b, k) pairs v with its partner u = v at (b,
// perms[s][k]) and takes, by sels[s][k], v u + c, v^2 + u, v c - u or (else)
// v^2 - u^2 + c, the last as (v - u)(v + u) + c: one product a lane, the
// operands picked by the selector, so that a warp's lanes never diverge on a
// product. Nonce b is one cluster of C blocks (C given at launch, K / C
// lanes a block, one a thread up to 512); block rank q holds lanes q K/C .. (q + 1)
// K/C - 1 in shared memory, 32 bytes a lane (two 16-byte words, so that a
// partner in another block's memory comes in two loads), in two buffers:
// step s reads buffer s & 1, here and in the partner's block (distributed
// shared memory), and writes its lane into the other; one cluster barrier a
// step orders every read of a buffer before the step that overwrites it.
// Between its arrive and its wait a thread prefetches the next step's
// perm, sel and constant of its first lane into L1. The leaves are read and the coefficients
// written once.
__device__ __forceinline__ void unpack(uint32_t* x, const uint4* src) {
    const uint4 lo = src[0], hi = src[1];
    x[0] = lo.x, x[1] = lo.y, x[2] = lo.z, x[3] = lo.w;
    x[4] = hi.x, x[5] = hi.y, x[6] = hi.z, x[7] = hi.w;
}

__device__ __forceinline__ void pack(uint4* dst, const uint32_t* x) {
    dst[0] = make_uint4(x[0], x[1], x[2], x[3]);
    dst[1] = make_uint4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void prefetch_l1(const void* p) {
    asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
}

__global__ void __launch_bounds__(EPOCH_MAX_THREADS)
    fr_epoch_program_kernel(const int32_t* __restrict__ v, const int32_t* __restrict__ perms,
                            const int32_t* __restrict__ sels, const int32_t* __restrict__ consts,
                            int32_t* __restrict__ out, int64_t B, int64_t K, int64_t steps) {
    extern __shared__ uint4 buf[];  // [2][K / C][2]
    cg::cluster_group cluster = cg::this_cluster();
    const int csize = static_cast<int>(cluster.num_blocks());
    const int rank = static_cast<int>(cluster.block_rank());
    const int64_t b = blockIdx.x / csize;
    const int kb = static_cast<int>(K / csize);
    const int64_t n = B * K;
    const int64_t k0 = static_cast<int64_t>(rank) * kb;  // the block's first lane
    for (int kk = threadIdx.x; kk < kb; kk += blockDim.x) {
        uint32_t x[FN];
        load<Fr>(x, v + b * K, n, k0 + kk);
        pack(buf + 2 * kk, x);
    }
    cluster.sync();
    for (int64_t s = 0; s < steps; ++s) {
        const uint4* cur = buf + (s & 1) * 2 * kb;
        uint4* nxt = buf + ((s + 1) & 1) * 2 * kb;
        for (int kk = threadIdx.x; kk < kb; kk += blockDim.x) {
            const int64_t k = k0 + kk;
            const int j = perms[s * K + k];
            const int sl = sels[s * K + k];
            uint32_t x[FN], u[FN], cc[FN], d[FN], e[FN], a[FN], y[FN], r[FN];
            unpack(x, cur + 2 * kk);
            unpack(u, cluster.map_shared_rank(cur, j / kb) + 2 * (j % kb));
            load<Fr>(cc, consts + s * 16 * K, K, k);
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
            pack(nxt + 2 * kk, r);
        }
        asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
        const int64_t k = k0 + threadIdx.x;
        if (threadIdx.x < kb && s + 1 < steps) {
            prefetch_l1(perms + (s + 1) * K + k);
            prefetch_l1(sels + (s + 1) * K + k);
#pragma unroll
            for (int l = 0; l < 16; ++l) prefetch_l1(consts + ((s + 1) * 16 + l) * K + k);
        }
        asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
    }
    const uint4* fin = buf + (steps & 1) * 2 * kb;
    for (int kk = threadIdx.x; kk < kb; kk += blockDim.x) {
        uint32_t x[FN];
        unpack(x, fin + 2 * kk);
        store<Fr>(out + b * K, x, n, k0 + kk);
    }
}

// K lanes a nonce and clusters of ``cluster`` blocks (8, the portable size,
// or 16, allowed here as a non-portable size): K a multiple of the cluster
// whose two buffers a block fit its shared memory; else refused.
extern "C" int fr_epoch_program(const int32_t* v, const int32_t* perms, const int32_t* sels,
                                const int32_t* consts, int32_t* out, int64_t B, int64_t K,
                                int64_t steps, int64_t cluster, void* stream) {
    constexpr size_t kMaxSmem = 227 * 1024;
    if (B < 1 || steps < 0 || (cluster != 8 && cluster != 16) || K < cluster || K % cluster)
        return static_cast<int>(cudaErrorInvalidValue);
    const int kb = static_cast<int>(K / cluster);
    const size_t smem = 2 * 2 * sizeof(uint4) * static_cast<size_t>(kb);
    if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
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
    cfg.blockDim = dim3(kb < EPOCH_MAX_THREADS ? (kb + 31) / 32 * 32 : EPOCH_MAX_THREADS, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, fr_epoch_program_kernel, v, perms, sels, consts, out, B, K,
                             steps);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}
