// Kernel B1's NTT entry: the radix-2 decimation-in-time NTT over Fr of
// ops/ntt.py as a short plan of passes, each one launch of fr_ntt_pass that
// runs k consecutive stages [s0, s0 + k) in shared memory.
//
// Index bits of an element i of a row: [0, s0) the column, [s0, s0 + k) the
// tile row t, [s0 + k, log n) h. The butterflies of stages s0 .. s0 + k - 1
// mix only elements that differ in the bits [s0, s0 + k), so a block owns a
// tile of `cols` adjacent columns by all 2^k rows of one h and one batch row,
// loads it once, runs its k stages between __syncthreads(), and stores it
// once. The stage of half-length 2^s pairs tile rows t and t + 2^(s - s0)
// (bit s - s0 of t clear) and multiplies v by omega_{2^(s+1)}^j, j = i mod
// 2^s = c + 2^s0 (t mod 2^(s - s0)), entry 2^s - 1 + j of the per-stage table
// (ops/ntt.py `_stage_table`, (16, n - 1): stage s at offset 2^s - 1).
//
// The first pass (s0 = 0) also does the bit-reversal gather: with L = log n,
// rev_L(h 2^k + t) = rev_k(t) 2^(L-k) + rev_(L-k)(h), so the block that owns
// the output chunks h_c = rev_(L-k)(g cols + c), c < cols, reads source row q
// at q 2^(L-k) + g cols + c (cols adjacent words a limb plane), puts it at
// tile row rev_k(q), and writes each chunk's 2^k elements contiguously. It
// reads `in` and writes `out` (a new tensor: the caller's input stays), times
// n^-1 on load for the inverse, and holds its stages' 2^k - 1 twiddles in
// shared memory. Later passes run in place (in == out).
//
// Replaces, on this path, the TPU kernel snarkos_tpu/ops/modarith.py
// `_mont_mul_pallas` (lines 171-208): the JAX NTT (snarkos_tpu/ops/ntt.py
// :172-189, the four-step path :214-284) has no kernel of its own, and XLA
// sends each stage's twiddle multiply of at least 2^13 elements to B1.
//
// Bound on this card, at n = 2^22 in three passes: the multiplies. 2^21 x 22
// Fr products of 272 32-bit multiplies are 0.75 ms at 16.75 T/s; the bytes,
// a read and a write of the 268 MB array a pass and one read of the last
// pass's twiddles (about 268 MB), are 0.56 ms at 3.35 TB/s.
//
// What the design does about the first design's losses (one gather and one
// launch a stage):
//   - array passes: log2 n + 1 became len(plan), at most 3 at 2^22;
//   - twiddle reads: one table a stage, contiguous in j, so the threads of a
//     tile row read adjacent twiddles (whole sectors) where the master
//     table's stride 2^(log n - 1 - s) cost a sector a limb;
//   - gather reads: cols adjacent source words a limb plane in place of one
//     word a 32-B sector; the scatter happens in shared memory;
//   - launches: len(plan) a transform (the host's ctypes calls set the time
//     below 2^20).
//
// Shared memory holds the tile as 8 planes of 32-bit words (word-major), so
// the threads of a warp touch neighbouring words; a tile row is cols + 1
// words apart (odd), so walking down a column is free of bank conflicts as
// well. Elements are packed to 8 words on load (field.cuh's load, store,
// add, sub, mont_mul). Offsets into the arrays are 64-bit: rows n may reach
// 2^31.
#include "field.cuh"

using namespace snark;

constexpr int PASS_MAX_THREADS = 512;
constexpr int PASS_SMEM_MAX = 232448;  // bytes a block may use on sm_90

__device__ __forceinline__ uint32_t rev_bits(uint32_t x, int bits) {
    return bits == 0 ? 0u : __brev(x) >> (32 - bits);
}

__device__ __forceinline__ void sload(uint32_t* r, const uint32_t* sm, int plane, int e) {
#pragma unroll
    for (int w = 0; w < Fr::N; ++w) r[w] = sm[w * plane + e];
}

__device__ __forceinline__ void sstore(uint32_t* sm, const uint32_t* r, int plane, int e) {
#pragma unroll
    for (int w = 0; w < Fr::N; ++w) sm[w * plane + e] = r[w];
}

// in, out: (16, rows, n) with limb stride total = rows n; table: (16, n - 1);
// scale: (16, 1) or null (first pass only). Block b: batch row b >> log_per,
// group g = b mod 2^log_per of the row's tiles.
__global__ void __launch_bounds__(PASS_MAX_THREADS)
fr_ntt_pass_kernel(const int32_t* in, int32_t* out, const int32_t* __restrict__ table,
                   const int32_t* __restrict__ scale, int64_t n, int64_t total, int log_n,
                   int s0, int k, int log_cols) {
    extern __shared__ uint32_t sm[];
    const int cols = 1 << log_cols;
    const int tile_rows = 1 << k;
    const int tile = tile_rows << log_cols;
    const int pitch = cols + 1;
    const int plane = tile_rows * pitch;
    uint32_t* tw = sm + Fr::N * plane;  // first pass: its 2^k - 1 twiddles
    const int log_per = log_n - k - log_cols;
    const int64_t blk = blockIdx.x;
    const int64_t row0 = (blk >> log_per) << log_n;
    const int64_t g = blk & ((int64_t(1) << log_per) - 1);
    // later passes: h = g >> (s0 - log_cols), the column group the rest
    const int64_t col0 = s0 == 0 ? 0 : (g & ((int64_t(1) << (s0 - log_cols)) - 1)) << log_cols;
    const int64_t start = s0 == 0 ? 0 : row0 + ((g >> (s0 - log_cols)) << (s0 + k)) + col0;
    uint32_t x[Fr::N];

    if (s0 == 0) {
        uint32_t c_scale[Fr::N];
        if (scale != nullptr) load<Fr>(c_scale, scale, 1, 0);
        for (int e = threadIdx.x; e < tile; e += blockDim.x) {
            const int c = e & (cols - 1), q = e >> log_cols;
            load<Fr>(x, in, total, row0 + (int64_t(q) << (log_n - k)) + (g << log_cols) + c);
            if (scale != nullptr) mont_mul<Fr>(x, x, c_scale);
            sstore(sm, x, plane, static_cast<int>(rev_bits(q, k)) * pitch + c);
        }
        for (int e = threadIdx.x; e < tile_rows - 1; e += blockDim.x) {
            load<Fr>(x, table, n - 1, e);
            sstore(tw, x, tile_rows, e);
        }
    } else {
        for (int e = threadIdx.x; e < tile; e += blockDim.x) {
            const int c = e & (cols - 1), t = e >> log_cols;
            load<Fr>(x, in, total, start + (int64_t(t) << s0) + c);
            sstore(sm, x, plane, t * pitch + c);
        }
    }
    __syncthreads();

    for (int sp = 0; sp < k; ++sp) {
        for (int b = threadIdx.x; b < tile / 2; b += blockDim.x) {
            const int c = b & (cols - 1), q = b >> log_cols;
            const int lo = q & ((1 << sp) - 1);
            const int e0 = (((q >> sp) << (sp + 1)) | lo) * pitch + c;
            const int e1 = e0 + (pitch << sp);
            uint32_t u[Fr::N], v[Fr::N], w[Fr::N];
            if (s0 == 0) {
                sload(w, tw, tile_rows, (1 << sp) - 1 + lo);
            } else {
                load<Fr>(w, table, n - 1,
                         (int64_t(1) << (s0 + sp)) - 1 + col0 + c + (int64_t(lo) << s0));
            }
            sload(u, sm, plane, e0);
            sload(v, sm, plane, e1);
            mont_mul<Fr>(v, v, w);
            add<Fr>(w, u, v);
            sub<Fr>(u, u, v);
            sstore(sm, w, plane, e0);
            sstore(sm, u, plane, e1);
        }
        __syncthreads();
    }

    if (s0 == 0) {
        for (int e = threadIdx.x; e < tile; e += blockDim.x) {
            const int t = e & (tile_rows - 1), c = e >> k;
            const int64_t h = rev_bits(static_cast<uint32_t>((g << log_cols) + c), log_n - k);
            sload(x, sm, plane, t * pitch + c);
            store<Fr>(out, x, total, row0 + (h << k) + t);
        }
    } else {
        for (int e = threadIdx.x; e < tile; e += blockDim.x) {
            const int c = e & (cols - 1), t = e >> log_cols;
            sload(x, sm, plane, t * pitch + c);
            store<Fr>(out, x, total, start + (int64_t(t) << s0) + c);
        }
    }
}

static int log2_exact(int64_t v) {
    if (v < 1 || (v & (v - 1)) != 0) return -1;
    return 63 - __builtin_clzll(static_cast<unsigned long long>(v));
}

// in, out: (16, rows, n), out == in for s0 > 0; table: (16, n - 1), stage s
// at offset 2^s - 1; scale: (16, 1) or null, s0 == 0 only. Runs stages
// [s0, s0 + k) in tiles of cols x 2^k elements, `threads` threads a block.
extern "C" int fr_ntt_pass(const int32_t* in, int32_t* out, const int32_t* table,
                           const int32_t* scale, int64_t n, int64_t rows, int64_t s0, int64_t k,
                           int64_t cols, int64_t threads, void* stream) {
    const int log_n = log2_exact(n);
    const int log_cols = log2_exact(cols);
    if (log_n < 1 || log_n > 31 || rows < 1 || k < 1 || s0 < 0 || s0 + k > log_n ||
        log_cols < 0 || log_cols > (s0 == 0 ? log_n - k : s0) || (scale != nullptr && s0 != 0) ||
        (s0 == 0 && in == out) || (s0 != 0 && in != out) || threads < 32 ||
        threads > PASS_MAX_THREADS || threads % 32 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const int64_t tile = cols << k;
    const int64_t blocks = rows * n / tile;
    const int64_t words = Fr::N * ((int64_t(1) << k) * (cols + 1) + (s0 == 0 ? (int64_t(1) << k) : 0));
    if (rows * n > (int64_t(1) << 31) || blocks > 0x7FFFFFFF || words * 4 > PASS_SMEM_MAX)
        return static_cast<int>(cudaErrorInvalidValue);
    static bool smem_set = false;
    if (!smem_set) {
        const cudaError_t err = cudaFuncSetAttribute(
            fr_ntt_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, PASS_SMEM_MAX);
        if (err != cudaSuccess) return static_cast<int>(err);
        smem_set = true;
    }
    fr_ntt_pass_kernel<<<static_cast<unsigned>(blocks), static_cast<unsigned>(threads),
                         static_cast<size_t>(words * 4), static_cast<cudaStream_t>(stream)>>>(
        in, out, table, scale, n, rows * n, log_n, static_cast<int>(s0), static_cast<int>(k),
        log_cols);
    return static_cast<int>(cudaGetLastError());
}
