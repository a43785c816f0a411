// Kernel B1: elementwise Montgomery multiply a * b * R^-1 mod p over (L, n)
// limb tensors, for Fq (L = 24) and Fr (L = 16); and the two Fr passes of
// the prover that are made of it, each one launch:
//   fr_poseidon_permute  the whole Poseidon permutation (8 full and 31
//                        partial rounds) of ops/poseidon.py, one lane a
//                        thread, the state in registers;
//   fr_epoch_step        one step of the epoch program of ops/puzzle.py
//                        (EpochProgram.apply), one lane a thread.
//
// Replaces the TPU kernel snarkos_tpu/ops/modarith.py `_mont_mul_pallas`
// (lines 171-208, body `_mont_mul_unrolled` 314-361), which runs a 16-bit
// limb Karatsuba product and SOS reduction on 2048-lane VMEM tiles. The JAX
// package runs Poseidon and the epoch program under jit with lax.scan, so
// XLA fuses their multiplies and additions; eagerly, one launch a multiply
// made 626 launches a permutation and 48 an epoch program, each with its
// field additions as a dozen small PyTorch ops. The fused passes keep every
// intermediate in registers and read and write each lane once.
//
// Bound on this card. mont_mul: the bytes, at the paths' shapes (each
// element reads 2 L and writes L int32 limbs against 4 N + 4 multiply-adds a
// word, N = L / 2 words). fr_poseidon_permute: the multiplies (626 Fr
// products a lane); fr_epoch_step: the bytes (three 16-limb reads, one
// gathered, and one write a lane against one or two Fr products). The design
// keeps each element in registers as N packed 32-bit words, multiplies by
// CIOS with PTX carry chains (field.cuh), and reads and writes each limb row
// coalesced, one element a thread.
#include "field.cuh"

using namespace snark;

template <class F>
__global__ void mont_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                                int32_t* __restrict__ out, int64_t n) {
    const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (e >= n) return;
    uint32_t x[F::N], y[F::N], r[F::N];
    load<F>(x, a, n, e);
    load<F>(y, b, n, e);
    mont_mul<F>(r, x, y);
    store<F>(out, r, n, e);
}

template <class F>
static int launch(const int32_t* a, const int32_t* b, int32_t* out, int64_t n, void* stream) {
    constexpr int threads = 128;
    const int64_t blocks = (n + threads - 1) / threads;
    mont_mul_kernel<F><<<static_cast<unsigned>(blocks), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(a, b, out, n);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int mont_mul_fq(const int32_t* a, const int32_t* b, int32_t* out, int64_t n,
                           void* stream) {
    return launch<Fq>(a, b, out, n, stream);
}

extern "C" int mont_mul_fr(const int32_t* a, const int32_t* b, int32_t* out, int64_t n,
                           void* stream) {
    return launch<Fr>(a, b, out, n, stream);
}

// -- Poseidon permutation over Fr ----------------------------------------------

constexpr int POSEIDON_HALF_FULL = 4;  // full rounds before and after the partial ones
constexpr int POSEIDON_PARTIAL = 31;
constexpr int POSEIDON_ROUNDS = 2 * POSEIDON_HALF_FULL + POSEIDON_PARTIAL;

// x = x^17 = ((((x^2)^2)^2)^2) x, as ops/poseidon.py's _sbox
__device__ __forceinline__ void sbox17(uint32_t* x) {
    uint32_t y[Fr::N];
    sqr<Fr>(y, x);
#pragma unroll
    for (int i = 0; i < 3; ++i) sqr<Fr>(y, y);
    mont_mul<Fr>(x, y, x);
}

// state and out: (T, 16, B) int32 limbs, Montgomery form; consts: the round
// constants ark (39, T, 16) then the MDS matrix (T, T, 16), which each block
// packs into shared memory once (every lane reads the same words: broadcast).
template <int T>
__global__ void __launch_bounds__(128)
    fr_poseidon_permute_kernel(const int32_t* __restrict__ state,
                               const int32_t* __restrict__ consts, int32_t* __restrict__ out,
                               int64_t B) {
    constexpr int NC = POSEIDON_ROUNDS * T + T * T;
    __shared__ uint32_t c[NC][Fr::N];
    for (int k = threadIdx.x; k < NC; k += blockDim.x) load<Fr>(c[k], consts + 16 * k, 1, 0);
    __syncthreads();
    const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (e >= B) return;
    uint32_t(*mds)[Fr::N] = c + POSEIDON_ROUNDS * T;

    uint32_t s[T][Fr::N];
#pragma unroll
    for (int i = 0; i < T; ++i) load<Fr>(s[i], state + 16 * B * i, B, e);
#pragma unroll 1
    for (int rnd = 0; rnd < POSEIDON_ROUNDS; ++rnd) {
#pragma unroll
        for (int i = 0; i < T; ++i) add<Fr>(s[i], s[i], c[rnd * T + i]);
        sbox17(s[0]);
        if (rnd < POSEIDON_HALF_FULL || rnd >= POSEIDON_HALF_FULL + POSEIDON_PARTIAL) {
#pragma unroll
            for (int i = 1; i < T; ++i) sbox17(s[i]);
        }
        uint32_t mixed[T][Fr::N];  // out_i = sum_j mds[i][j] s_j
#pragma unroll
        for (int i = 0; i < T; ++i) {
            mont_mul<Fr>(mixed[i], mds[i * T], s[0]);
#pragma unroll
            for (int j = 1; j < T; ++j) {
                uint32_t term[Fr::N];
                mont_mul<Fr>(term, mds[i * T + j], s[j]);
                add<Fr>(mixed[i], mixed[i], term);
            }
        }
#pragma unroll
        for (int i = 0; i < T; ++i) copy<Fr>(s[i], mixed[i]);
    }
#pragma unroll
    for (int i = 0; i < T; ++i) store<Fr>(out + 16 * B * i, s[i], B, e);
}

template <int T>
static int launch_permute(const int32_t* state, const int32_t* consts, int32_t* out, int64_t B,
                          void* stream) {
    constexpr int threads = 128;
    const int64_t blocks = (B + threads - 1) / threads;
    fr_poseidon_permute_kernel<T><<<static_cast<unsigned>(blocks), threads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(state, consts, out, B);
    return static_cast<int>(cudaGetLastError());
}

// t = rate + 1 state slots: the rates 2 and 4 (the prover's leaves and
// challenge use 2); any other width is refused.
extern "C" int fr_poseidon_permute(const int32_t* state, const int32_t* consts, int32_t* out,
                                   int64_t B, int64_t t, void* stream) {
    switch (t) {
        case 3:
            return launch_permute<3>(state, consts, out, B, stream);
        case 5:
            return launch_permute<5>(state, consts, out, B, stream);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}

// -- one step of the epoch program ----------------------------------------------

// v, out: (16, B, K) limbs; perm, sel: (K,) int32; c: (16, K) limbs. Lane
// (b, k) reads v at (b, k) and its partner u at (b, perm[k]) and writes, by
// sel[k], v u + c, v^2 + u, v c - u or (else) v^2 - u^2 + c. The first
// product is shared by the four forms (v times u, v, c or v), so a warp's
// lanes diverge only on the additions and on sel 3's u^2.
__global__ void fr_epoch_step_kernel(const int32_t* __restrict__ v,
                                     const int32_t* __restrict__ perm,
                                     const int32_t* __restrict__ sel,
                                     const int32_t* __restrict__ c, int32_t* __restrict__ out,
                                     int64_t B, int64_t K) {
    const int64_t n = B * K;
    const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (e >= n) return;
    const int64_t k = e % K;
    uint32_t x[Fr::N], u[Fr::N], cc[Fr::N], y[Fr::N], r[Fr::N];
    load<Fr>(x, v, n, e);
    load<Fr>(u, v, n, e - k + perm[k]);
    load<Fr>(cc, c, K, k);
    const int s = sel[k];
#pragma unroll
    for (int w = 0; w < Fr::N; ++w) y[w] = s == 0 ? u[w] : (s == 2 ? cc[w] : x[w]);
    mont_mul<Fr>(y, x, y);
    if (s == 0) {
        add<Fr>(r, y, cc);
    } else if (s == 1) {
        add<Fr>(r, y, u);
    } else if (s == 2) {
        sub<Fr>(r, y, u);
    } else {
        sqr<Fr>(u, u);
        sub<Fr>(r, y, u);
        add<Fr>(r, r, cc);
    }
    store<Fr>(out, r, n, e);
}

extern "C" int fr_epoch_step(const int32_t* v, const int32_t* perm, const int32_t* sel,
                             const int32_t* c, int32_t* out, int64_t B, int64_t K, void* stream) {
    constexpr int threads = 128;
    const int64_t blocks = (B * K + threads - 1) / threads;
    fr_epoch_step_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(v, perm, sel, c, out, B, K);
    return static_cast<int>(cudaGetLastError());
}
