// Kernel B1: elementwise Montgomery multiply a * b * R^-1 mod p over (L, n)
// limb tensors, for Fq (L = 24) and Fr (L = 16). B1's two Fr passes of the
// prover, the Poseidon sponge and the epoch program, are fr_passes.cu; its
// NTT pass is ntt.cu.
//
// Replaces the TPU kernel snarkos_tpu/ops/modarith.py `_mont_mul_pallas`
// (lines 171-208, body `_mont_mul_unrolled` 314-361), which runs a 16-bit
// limb Karatsuba product and SOS reduction on 2048-lane VMEM tiles.
//
// Bound on this card: the bytes, at the paths' shapes (each element reads
// 2 L and writes L int32 limbs against 4 N + 4 multiply-adds a word, N = L / 2
// words). The design keeps each element in registers as N packed 32-bit
// words, multiplies by CIOS with PTX carry chains (field.cuh), and reads and
// writes each limb row coalesced, one element a thread.
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
