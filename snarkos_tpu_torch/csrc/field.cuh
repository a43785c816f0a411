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
// CIOS over 32-bit words with 32x32->64 products in 64-bit accumulators:
// after word i, t = (t + a * b_i + m p) / 2^32 with m = t_0 * (-p^-1) mod 2^32.
// For a, b < p the result is below 2p (p < R / 4 for both fields), and one
// conditional subtract makes it canonical. 2 N^2 + N word products: 300 for
// Fq, 136 for Fr, each one IMAD.WIDE-class pair of 32-bit multiplies.
template <class F>
__device__ __forceinline__ void mont_mul(uint32_t* r, const uint32_t* a, const uint32_t* b) {
    constexpr int N = F::N;
    uint32_t t[N + 2];
#pragma unroll
    for (int i = 0; i < N + 2; ++i) t[i] = 0;
#pragma unroll
    for (int i = 0; i < N; ++i) {
        uint64_t c = 0;
#pragma unroll
        for (int j = 0; j < N; ++j) {
            c += static_cast<uint64_t>(a[j]) * b[i] + t[j];
            t[j] = static_cast<uint32_t>(c);
            c >>= 32;
        }
        c += t[N];
        t[N] = static_cast<uint32_t>(c);
        t[N + 1] = static_cast<uint32_t>(c >> 32);
        const uint32_t m = t[0] * F::INV;
        c = (static_cast<uint64_t>(m) * F::p(0) + t[0]) >> 32;
#pragma unroll
        for (int j = 1; j < N; ++j) {
            c += static_cast<uint64_t>(m) * F::p(j) + t[j];
            t[j - 1] = static_cast<uint32_t>(c);
            c >>= 32;
        }
        c += t[N];
        t[N - 1] = static_cast<uint32_t>(c);
        t[N] = t[N + 1] + static_cast<uint32_t>(c >> 32);
    }
    cond_sub_p<F>(r, t);
}

template <class F>
__device__ __forceinline__ void sqr(uint32_t* r, const uint32_t* a) { mont_mul<F>(r, a, a); }

}  // namespace snark
