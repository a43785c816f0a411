// Kernel B1: elementwise Montgomery multiply a * b * R^-1 mod p over (L, n)
// limb tensors, for Fq (L = 24) and Fr (L = 16).
//
// Replaces the TPU kernel snarkos_tpu/ops/modarith.py `_mont_mul_pallas`
// (lines 171-208, body `_mont_mul_unrolled` 314-361), which runs a 16-bit
// limb Karatsuba product and SOS reduction on 2048-lane VMEM tiles.
//
// Bound on this card: at the path's shapes the bytes dominate. Each element
// reads 2 L and writes L int32 limbs (12 bytes per 16-bit limb moved) against
// 2 N^2 + N 32x32-bit products (N = L / 2 words). The design keeps the
// element in registers as N packed 32-bit words, runs CIOS with 64-bit
// accumulators (native 32x32->64 multiplies instead of the TPU's 16x16 ones),
// and reads and writes each limb row coalesced, one element per thread.
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
