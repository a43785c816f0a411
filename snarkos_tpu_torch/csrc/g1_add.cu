// Kernel B2: the complete Jacobian point addition over (24, n) coordinate
// tensors, one lane per thread, and the two compositions of it that the MSM's
// window loop runs:
//   g1_add           o = a + b;
//   g1_horner        o = 2^c acc + t, the Horner step that ends every window
//                    (c doublings, then one add) in one launch instead of c + 1;
//   g1_bucket_fixup  the window's bucket sums: the scan value at each bucket's
//                    last position, plus the chain carry where the bucket's run
//                    starts in an earlier chain, the identity where the bucket
//                    is empty or bucket 0, in one launch instead of an add and
//                    ten gathers and selects around it.
// Each gives the limbs of the same composition of g1.add calls (ops/g1.py).
//
// Replaces the TPU kernel snarkos_tpu/ops/g1_pallas.py `add` / `_add_kernel`
// (lines 67-92): g1.add_impl on 512-lane VMEM tiles, which the JAX window
// loop calls c + 2 times a window (snarkos_tpu/ops/msm.py:538-565).
//
// Bound on this card: 32-bit integer multiplies (16 Fq Montgomery products of
// 300 word products per generic add, 8 + 7 per doubling) against 864 bytes
// moved per add lane. On the main path n is 1 to 8193, far below one wave of
// the card, so a launch is bound by one thread's chain of dependent products:
// 16 for an add, 7 c + 16 for a Horner step. The design keeps every point and
// temporary of a thread in registers and fuses the window's c + 2 launches
// into two.
#include "g1.cuh"

using namespace snark;

// Out of line on purpose: with the curve formulas inlined into a loop, cicc of
// nvcc 12.9 crashes (segmentation fault; see jadd_scan.cu); the calls build.
__device__ __noinline__ void double_step(Jac& o, const Jac& p) { g1_double(o, p); }

__device__ __noinline__ void add_step(Jac& o, const Jac& p, const Jac& q) {
    snark::g1_add(o, p, q);
}

__global__ void g1_add_kernel(const int32_t* __restrict__ ax, const int32_t* __restrict__ ay,
                              const int32_t* __restrict__ az, const int32_t* __restrict__ bx,
                              const int32_t* __restrict__ by, const int32_t* __restrict__ bz,
                              int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                              int32_t* __restrict__ oz, int64_t n) {
    const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (e >= n) return;
    Jac p, q, o;
    load_point(p, ax, ay, az, n, e);
    load_point(q, bx, by, bz, n, e);
    snark::g1_add(o, p, q);
    store_point(ox, oy, oz, o, n, e);
}

// acc <- 2^c acc + t. add(acc, acc) doubles a finite acc and returns an
// identity acc (Z = 0) with its limbs as they are, so an identity lane is
// skipped rather than doubled: g1_double would give it other X and Y.
__global__ void g1_horner_kernel(const int32_t* __restrict__ ax, const int32_t* __restrict__ ay,
                                 const int32_t* __restrict__ az, const int32_t* __restrict__ tx,
                                 const int32_t* __restrict__ ty, const int32_t* __restrict__ tz,
                                 int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                                 int32_t* __restrict__ oz, int64_t n, int64_t c) {
    const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (e >= n) return;
    Jac acc, t, nxt;
    load_point(acc, ax, ay, az, n, e);
    load_point(t, tx, ty, tz, n, e);
    for (int64_t i = 0; i < c; ++i) {
        if (is_zero<Fq>(acc.z)) break;  // stays the identity, limbs kept
        double_step(nxt, acc);
        acc = nxt;
    }
    add_step(nxt, acc, t);
    store_point(ox, oy, oz, nxt, n, e);
}

// Bucket b's sum: the scan value at flat[b] (scan outputs (24, ns)), plus
// carry_in[chain_of[b]] ((24, nc)) where needs_carry[b], and g1.infinity's
// limbs (X = Y = Montgomery one, Z = 0) where not live[b].
__global__ void g1_bucket_fixup_kernel(const int32_t* __restrict__ sx,
                                       const int32_t* __restrict__ sy,
                                       const int32_t* __restrict__ sz,
                                       const int32_t* __restrict__ cx,
                                       const int32_t* __restrict__ cy,
                                       const int32_t* __restrict__ cz,
                                       const int64_t* __restrict__ flat,
                                       const int64_t* __restrict__ chain_of,
                                       const uint8_t* __restrict__ needs_carry,
                                       const uint8_t* __restrict__ live,
                                       int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                                       int32_t* __restrict__ oz, int64_t ns, int64_t nc,
                                       int64_t nb) {
    const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (b >= nb) return;
    Jac o;
    if (!live[b]) {
#pragma unroll
        for (int k = 0; k < 12; ++k) {
            o.x[k] = o.y[k] = FQ_ONE[k];
            o.z[k] = 0;
        }
    } else if (needs_carry[b]) {
        Jac tail, carry;
        load_point(tail, sx, sy, sz, ns, flat[b]);
        load_point(carry, cx, cy, cz, nc, chain_of[b]);
        add_step(o, tail, carry);
    } else {
        load_point(o, sx, sy, sz, ns, flat[b]);
    }
    store_point(ox, oy, oz, o, nb, b);
}

namespace {
constexpr int kThreads = 64;

unsigned blocks_for(int64_t n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }
}  // namespace

extern "C" int g1_add(const int32_t* ax, const int32_t* ay, const int32_t* az,
                      const int32_t* bx, const int32_t* by, const int32_t* bz,
                      int32_t* ox, int32_t* oy, int32_t* oz, int64_t n, void* stream) {
    g1_add_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        ax, ay, az, bx, by, bz, ox, oy, oz, n);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int g1_horner(const int32_t* ax, const int32_t* ay, const int32_t* az,
                         const int32_t* tx, const int32_t* ty, const int32_t* tz,
                         int32_t* ox, int32_t* oy, int32_t* oz, int64_t n, int64_t c,
                         void* stream) {
    g1_horner_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        ax, ay, az, tx, ty, tz, ox, oy, oz, n, c);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int g1_bucket_fixup(const int32_t* sx, const int32_t* sy, const int32_t* sz,
                               const int32_t* cx, const int32_t* cy, const int32_t* cz,
                               const int64_t* flat, const int64_t* chain_of,
                               const uint8_t* needs_carry, const uint8_t* live, int32_t* ox,
                               int32_t* oy, int32_t* oz, int64_t ns, int64_t nc, int64_t nb,
                               void* stream) {
    g1_bucket_fixup_kernel<<<blocks_for(nb), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        sx, sy, sz, cx, cy, cz, flat, chain_of, needs_carry, live, ox, oy, oz, ns, nc, nb);
    return static_cast<int>(cudaGetLastError());
}
