// Montgomery arithmetic over the BLS12-377 fields, one element per thread.
//
// Layout: the port keeps the JAX package's public layout, (L, n) int32
// tensors of 16-bit limbs, limb-major, in Montgomery form with R = 2^384
// (Fq, L = 24) or R = 2^256 (Fr, L = 16). A thread packs its element's 16-bit
// limbs pairwise into N = L/2 32-bit words on load; since R is unchanged this
// is a bit-pack, not a conversion. Neighbouring threads read neighbouring
// addresses of each limb row, so loads and stores coalesce.
//
// Every function returns canonical values (< p) for canonical inputs, so any
// sequence of these ops gives the same limbs as the same sequence in the JAX
// package (ops/modarith.py there) and in the plain PyTorch versions.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace snark {

static __constant__ uint32_t FQ_P[12] = {
    0x00000001u, 0x8508c000u, 0x30000000u, 0x170b5d44u, 0xba094800u, 0x1ef3622fu,
    0x00f5138fu, 0x1a22d9f3u, 0x6ca1493bu, 0xc63b05c0u, 0x17c510eau, 0x01ae3a46u};
// R mod p: the Montgomery form of 1
static __constant__ uint32_t FQ_ONE[12] = {
    0xffffff68u, 0x02cdffffu, 0x7fffffb1u, 0x51409f83u, 0x8a7d3ff2u, 0x9f7db3a9u,
    0x6e7c6305u, 0x7b4e97b7u, 0x803c84e8u, 0x4cf495bfu, 0xe2fdf49au, 0x008d6661u};
static __constant__ uint32_t FR_P[8] = {
    0x00000001u, 0x0a118000u, 0xd0000001u, 0x59aa76feu,
    0x5c37b001u, 0x60b44d1eu, 0x9a2ca556u, 0x12ab655eu};

struct Fq {
    static constexpr int N = 12;           // 32-bit words
    static constexpr uint32_t INV = 0xffffffffu;  // -p^-1 mod 2^32
    static __device__ __forceinline__ uint32_t p(int i) { return FQ_P[i]; }
};

struct Fr {
    static constexpr int N = 8;
    static constexpr uint32_t INV = 0xffffffffu;
    static __device__ __forceinline__ uint32_t p(int i) { return FR_P[i]; }
};

// -- loads and stores of (L, n) 16-bit limb tensors --------------------------

template <class F>
__device__ __forceinline__ void load(uint32_t* r, const int32_t* src, int64_t n, int64_t e) {
#pragma unroll
    for (int w = 0; w < F::N; ++w) {
        uint32_t lo = static_cast<uint32_t>(src[(2 * w) * n + e]) & 0xFFFFu;
        uint32_t hi = static_cast<uint32_t>(src[(2 * w + 1) * n + e]) & 0xFFFFu;
        r[w] = lo | (hi << 16);
    }
}

template <class F>
__device__ __forceinline__ void store(int32_t* dst, const uint32_t* r, int64_t n, int64_t e) {
#pragma unroll
    for (int w = 0; w < F::N; ++w) {
        dst[(2 * w) * n + e] = static_cast<int32_t>(r[w] & 0xFFFFu);
        dst[(2 * w + 1) * n + e] = static_cast<int32_t>(r[w] >> 16);
    }
}

template <class F>
__device__ __forceinline__ void copy(uint32_t* r, const uint32_t* a) {
#pragma unroll
    for (int i = 0; i < F::N; ++i) r[i] = a[i];
}

// -- comparisons ---------------------------------------------------------------

template <class F>
__device__ __forceinline__ bool is_zero(const uint32_t* a) {
    uint32_t acc = 0;
#pragma unroll
    for (int i = 0; i < F::N; ++i) acc |= a[i];
    return acc == 0;
}

template <class F>
__device__ __forceinline__ bool eq(const uint32_t* a, const uint32_t* b) {
    uint32_t acc = 0;
#pragma unroll
    for (int i = 0; i < F::N; ++i) acc |= a[i] ^ b[i];
    return acc == 0;
}

// -- add, sub ------------------------------------------------------------------

// r = t - p if t >= p else t, for t < 2p held in N words (2p < 2^(32 N)).
template <class F>
__device__ __forceinline__ void cond_sub_p(uint32_t* r, const uint32_t* t) {
    uint32_t d[F::N];
    uint64_t borrow = 0;
#pragma unroll
    for (int i = 0; i < F::N; ++i) {
        uint64_t v = static_cast<uint64_t>(t[i]) - F::p(i) - borrow;
        d[i] = static_cast<uint32_t>(v);
        borrow = v >> 63;
    }
    const bool ge = borrow == 0;
#pragma unroll
    for (int i = 0; i < F::N; ++i) r[i] = ge ? d[i] : t[i];
}

template <class F>
__device__ __forceinline__ void add(uint32_t* r, const uint32_t* a, const uint32_t* b) {
    uint32_t t[F::N];
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < F::N; ++i) {
        c += static_cast<uint64_t>(a[i]) + b[i];
        t[i] = static_cast<uint32_t>(c);
        c >>= 32;
    }
    cond_sub_p<F>(r, t);
}

template <class F>
__device__ __forceinline__ void sub(uint32_t* r, const uint32_t* a, const uint32_t* b) {
    uint32_t t[F::N];
    uint64_t borrow = 0;
#pragma unroll
    for (int i = 0; i < F::N; ++i) {
        uint64_t v = static_cast<uint64_t>(a[i]) - b[i] - borrow;
        t[i] = static_cast<uint32_t>(v);
        borrow = v >> 63;
    }
    // a < b: add p back (the sum wraps past 2^(32 N) to the right value)
    const uint32_t mask = borrow ? 0xFFFFFFFFu : 0u;
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < F::N; ++i) {
        c += static_cast<uint64_t>(t[i]) + (F::p(i) & mask);
        r[i] = static_cast<uint32_t>(c);
        c >>= 32;
    }
}

template <class F>
__device__ __forceinline__ void dbl(uint32_t* r, const uint32_t* a) { add<F>(r, a, a); }

// k * a for the small constants the curve formulas use (3, 4, 8), by the
// same add chain as the JAX package's mul_small (the value is what counts).
template <class F>
__device__ __forceinline__ void mul3(uint32_t* r, const uint32_t* a) {
    uint32_t t[F::N];
    add<F>(t, a, a);
    add<F>(r, a, t);
}

template <class F>
__device__ __forceinline__ void mul4(uint32_t* r, const uint32_t* a) {
    uint32_t t[F::N];
    add<F>(t, a, a);
    add<F>(r, t, t);
}

template <class F>
__device__ __forceinline__ void mul8(uint32_t* r, const uint32_t* a) {
    uint32_t t[F::N];
    add<F>(t, a, a);
    add<F>(t, t, t);
    add<F>(r, t, t);
}

// -- Montgomery multiply (B1) -------------------------------------------------
//
// CIOS over 32-bit words with PTX carry chains. The running sum is held in
// two N-word arrays, T = A + 2^32 B: the products a_j b_i of even j go to A
// (low word at j, high word at j + 1, so one chain of mad.lo / madc.hi adds
// them all with no carry fix-ups), those of odd j to B. For each word b_i:
//   1. A += the even products of a b_i, B += the odd ones (two chains);
//   2. m = A_0 (-p^-1) mod 2^32 (T's lowest word is A_0), and two more chains
//      add m p, which zeroes A_0;
//   3. T / 2^32 = (B + A_1) + 2^32 (A >> 64): B, with A_1 added to its lowest
//      word, becomes the next word's A, and A shifted down two words its B;
//      the shift and the carry of that add ride in the next word's odd chain
//      (madc_rshift).
// After the last word the arrays merge into T / 2^32 < 2p, and one
// conditional subtract makes it canonical: the same value and limbs as the
// JAX package's multiply. For a, b < p < 2^(32 N - 2) no chain carries out of
// the top word of B, so nothing is lost where a chain ends without a
// carry-out. 4 N + 4 instructions a word of b (624 for Fq, 288 for Fr), each a
// 32-bit multiply-add with carry, against about three for each of the
// 2 N^2 + N word products of CIOS with 64-bit accumulators.
//
// One PTX instruction per asm statement, all volatile: volatile asm keeps its
// order, so each chain's carry flag passes from one statement to the next,
// and no output can share a register with an input of its statement.

__device__ __forceinline__ uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
    uint32_t r;
    asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
    return r;
}

__device__ __forceinline__ uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
    uint32_t r;
    asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
    return r;
}

__device__ __forceinline__ uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
    uint32_t r;
    asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
    return r;
}

__device__ __forceinline__ uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c) {
    uint32_t r;
    asm volatile("madc.hi.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
    return r;
}

__device__ __forceinline__ uint32_t add_cc(uint32_t a, uint32_t b) {
    uint32_t r;
    asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
}

__device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b) {
    uint32_t r;
    asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
}

__device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b) {
    uint32_t r;
    asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
}

// acc += sum over even j < N of a[j] bi 2^(32 j), one chain started with no
// carry; the carry out of acc[N-1] is left in the flag.
template <int N>
__device__ __forceinline__ void mad_even(uint32_t* acc, const uint32_t* a, uint32_t bi) {
    acc[0] = mad_lo_cc(a[0], bi, acc[0]);
    acc[1] = madc_hi_cc(a[0], bi, acc[1]);
#pragma unroll
    for (int j = 2; j < N; j += 2) {
        acc[j] = madc_lo_cc(a[j], bi, acc[j]);
        acc[j + 1] = madc_hi_cc(a[j], bi, acc[j + 1]);
    }
}

// odd = (odd >> 64) + sum over even j < N of a[j] bi 2^(32 j) + the carry
// flag, one chain with no carry out.
template <int N>
__device__ __forceinline__ void madc_rshift(uint32_t* odd, const uint32_t* a, uint32_t bi) {
#pragma unroll
    for (int j = 0; j < N - 2; j += 2) {
        odd[j] = madc_lo_cc(a[j], bi, odd[j + 2]);
        odd[j + 1] = madc_hi_cc(a[j], bi, odd[j + 3]);
    }
    odd[N - 2] = madc_lo_cc(a[N - 2], bi, 0);
    odd[N - 1] = madc_hi(a[N - 2], bi, 0);
}

// Step 2: add m p with m = even[0] (-p^-1) mod 2^32; even[0] becomes 0.
template <class F>
__device__ __forceinline__ void mont_reduce(uint32_t* even, uint32_t* odd) {
    constexpr int N = F::N;
    uint32_t p[N];
#pragma unroll
    for (int j = 0; j < N; ++j) p[j] = F::p(j);
    const uint32_t m = even[0] * F::INV;
    mad_even<N>(odd, p + 1, m);
    mad_even<N>(even, p, m);
    odd[N - 1] = addc(odd[N - 1], 0);
}

// Steps 3, 1 and 2 for a word b_i after the first: on entry ``even`` holds
// the word before's B and ``odd`` its A (A_0 == 0); on return ``even`` holds
// the new A and ``odd`` the new B.
template <class F>
__device__ __forceinline__ void mont_row(uint32_t* even, uint32_t* odd, const uint32_t* a,
                                         uint32_t bi) {
    constexpr int N = F::N;
    even[0] = add_cc(even[0], odd[1]);
    madc_rshift<N>(odd, a + 1, bi);
    mad_even<N>(even, a, bi);
    odd[N - 1] = addc(odd[N - 1], 0);
    mont_reduce<F>(even, odd);
}

template <class F>
__device__ __forceinline__ void mont_mul(uint32_t* r, const uint32_t* a, const uint32_t* b) {
    constexpr int N = F::N;  // even for both fields
    uint32_t x[N], y[N];     // A, B of the words so far, swapping roles each word
#pragma unroll
    for (int j = 0; j < N; j += 2) {
        x[j] = a[j] * b[0];
        x[j + 1] = __umulhi(a[j], b[0]);
        y[j] = a[j + 1] * b[0];
        y[j + 1] = __umulhi(a[j + 1], b[0]);
    }
    mont_reduce<F>(x, y);
#pragma unroll
    for (int i = 1; i < N; ++i) {
        if (i & 1) {
            mont_row<F>(y, x, a, b[i]);
        } else {
            mont_row<F>(x, y, a, b[i]);
        }
    }
    // N - 1 is odd: y holds A, x holds B; T / 2^32 = x + (y >> 32)
    uint32_t t[N];
    t[0] = add_cc(x[0], y[1]);
#pragma unroll
    for (int j = 1; j < N - 1; ++j) t[j] = addc_cc(x[j], y[j + 1]);
    t[N - 1] = addc(x[N - 1], 0);
    cond_sub_p<F>(r, t);
}

template <class F>
__device__ __forceinline__ void sqr(uint32_t* r, const uint32_t* a) { mont_mul<F>(r, a, a); }

}  // namespace snark
