// Kernel B1's NTT entries: the radix-2 decimation-in-time NTT over Fr of
// ops/ntt.py, as one gather and log2(n) butterfly stages, each one launch:
//   fr_ntt_bitrev  out[:, r, i] = in[:, r, rev(i)], out of place, times a
//                  constant (n^-1 in Montgomery form, for the inverse) when
//                  one is given;
//   fr_ntt_stage   the stage of half-length m = 2^s, in place: thread t takes
//                  row r, group g and j < m, u = a[g 2m + j], v = a[g 2m + j +
//                  m], w = v W[j n / 2m], and writes u + w, u - w back. Each
//                  thread owns its pair, so nothing else reads or writes it.
// Arrays are (16, rows, n) int32 limb tensors, limb stride rows n; W is the
// (16, n/2) master table of ops/ntt.py, W[i] = omega^i, which every stage
// indexes with its own stride, so no per-stage tables exist.
//
// Replaces, on this path, the TPU kernel snarkos_tpu/ops/modarith.py
// `_mont_mul_pallas` (lines 171-208): the JAX NTT (snarkos_tpu/ops/ntt.py
// :172-189, the four-step path :214-284) has no kernel of its own, and XLA
// sends each stage's twiddle multiply of at least 2^13 elements to B1.
//
// Bound on this card: the bytes. A stage reads and writes each element once
// and reads m twiddles; at n = 2^22 that is 2^21 x (4 x 64 B + 64 B), about
// 0.67 GB or 0.2 ms at 3.35 TB/s, against 2^21 Fr products (about 0.04 ms of
// 32-bit multiplies). A whole transform needs at least one read and one
// write of the array (0.54 GB, 0.16 ms) and 2^21 x 22 products (about
// 0.37 ms). This design moves the array once a stage, log2(n) + 1 times in
// all, so it sits near ten times that bound by construction; running
// several stages a launch in shared memory is the way down.
//
// Each element is 8 packed 32-bit words in registers (field.cuh's load,
// store, add, sub, mont_mul), one butterfly or one element a thread;
// neighbouring threads take neighbouring j, so the limb rows of u and v
// coalesce once m >= 32. Offsets are 64-bit: rows n / 2 may pass 2^31.
#include "field.cuh"

using namespace snark;

constexpr int NTT_THREADS = 128;

__global__ void fr_ntt_bitrev_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out,
                                     const int32_t* __restrict__ scale, int64_t n, int64_t rows,
                                     int log_n) {
    const int64_t total = rows * n;
    const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (e >= total) return;
    const int64_t i = e & (n - 1);
    const int64_t src = (e - i) + (__brev(static_cast<uint32_t>(i)) >> (32 - log_n));
    uint32_t x[Fr::N];
    load<Fr>(x, in, total, src);
    if (scale != nullptr) {
        uint32_t c[Fr::N];
        load<Fr>(c, scale, 1, 0);
        mont_mul<Fr>(x, x, c);
    }
    store<Fr>(out, x, total, e);
}

__global__ void fr_ntt_stage_kernel(int32_t* __restrict__ a, const int32_t* __restrict__ master,
                                    int64_t n, int64_t rows, int s) {
    const int64_t half = n >> 1;
    const int64_t total = rows * half;
    const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (t >= total) return;
    const int log_half = __ffsll(half) - 1;
    const int64_t r = t >> log_half;          // row
    const int64_t k = t & (half - 1);         // butterfly within the row
    const int64_t j = k & ((int64_t(1) << s) - 1);
    const int64_t i0 = r * n + ((k >> s) << (s + 1)) + j;  // g 2m + j
    const int64_t i1 = i0 + (int64_t(1) << s);
    const int64_t len = rows * n;
    uint32_t u[Fr::N], v[Fr::N], w[Fr::N];
    load<Fr>(u, a, len, i0);
    load<Fr>(v, a, len, i1);
    load<Fr>(w, master, half, j << (log_half - s));  // W[j n / 2m]
    mont_mul<Fr>(v, v, w);
    add<Fr>(w, u, v);
    sub<Fr>(u, u, v);
    store<Fr>(a, w, len, i0);
    store<Fr>(a, u, len, i1);
}

static bool grid(int64_t threads, unsigned* blocks) {
    const int64_t b = (threads + NTT_THREADS - 1) / NTT_THREADS;
    if (b < 1 || b > 0x7FFFFFFF) return false;
    *blocks = static_cast<unsigned>(b);
    return true;
}

static bool valid_size(int64_t n, int64_t log_n) {
    return log_n >= 1 && log_n <= 31 && n == (int64_t(1) << log_n);
}

// in, out: (16, rows, n); scale: (16, 1) or null; n = 2^log_n >= 2
extern "C" int fr_ntt_bitrev(const int32_t* in, int32_t* out, const int32_t* scale, int64_t n,
                             int64_t rows, int64_t log_n, void* stream) {
    unsigned blocks;
    if (!valid_size(n, log_n) || rows < 1 || !grid(rows * n, &blocks))
        return static_cast<int>(cudaErrorInvalidValue);
    fr_ntt_bitrev_kernel<<<blocks, NTT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        in, out, scale, n, rows, static_cast<int>(log_n));
    return static_cast<int>(cudaGetLastError());
}

// a: (16, rows, n), in place; master: (16, n/2); 0 <= s < log2 n
extern "C" int fr_ntt_stage(int32_t* a, const int32_t* master, int64_t n, int64_t rows,
                            int64_t s, void* stream) {
    unsigned blocks;
    const int64_t log_n = 63 - __builtin_clzll(static_cast<unsigned long long>(n | 1));
    if (!valid_size(n, log_n) || s < 0 || s >= log_n || rows < 1 || !grid(rows * (n / 2), &blocks))
        return static_cast<int>(cudaErrorInvalidValue);
    fr_ntt_stage_kernel<<<blocks, NTT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        a, master, n, rows, static_cast<int>(s));
    return static_cast<int>(cudaGetLastError());
}
