// BLS12-377 G1 host engine: Montgomery Fq (6x64 CIOS), Jacobian group law,
// windowed Pippenger MSM.
//
// The node's host side of the curve: the host KZG commitment and the SRS
// powers of a test setup (crypto/ref/kzg.py), the folds of Varuna's
// openings (crypto/ref/varuna.py), and the bases and CPU baseline of a
// benchmark. The card (snarkos_tpu_torch/ops/msm.py) keeps the large MSMs;
// this engine covers the small ones, where a launch costs more than the
// work.
//
// Exposed C ABI (ctypes, snarkos_tpu_torch/utils/native.py):
//   g1_msm(scalars_le[32*n], points_xy_le[96*n], n, out[144])
//   g1_scalar_mul(scalar_le[32], point_xy_le[96], out[144])
//   - scalars: canonical little-endian 32-byte Fr
//   - points: affine x||y, canonical little-endian 48+48 bytes
//   - out: Jacobian X||Y||Z canonical little-endian 48*3 bytes
// Returns 0 on success.

#include <algorithm>
#include <cstring>
#include <thread>
#include <vector>

#include "fq377.h"

struct G1 {
  Fq x, y, z;  // Jacobian, Montgomery coords; z == 0 -> infinity
};

static void g1_set_infinity(G1 &p) {
  std::memset(&p, 0, sizeof p);
  std::memcpy(p.x.v, FQ_ONE_MONT, sizeof p.x.v);
  std::memcpy(p.y.v, FQ_ONE_MONT, sizeof p.y.v);
}

static inline bool g1_is_infinity(const G1 &p) { return fq_is_zero(p.z); }

// dbl-2009-alnr (a = 0)
static void g1_double(G1 &out, const G1 &p) {
  if (g1_is_infinity(p)) {
    out = p;
    return;
  }
  Fq xx, yy, yyyy, zz, s, m, t0, t1;
  fq_sqr(xx, p.x);
  fq_sqr(yy, p.y);
  fq_sqr(yyyy, yy);
  fq_sqr(zz, p.z);
  fq_add(t0, p.x, yy);
  fq_sqr(t0, t0);
  fq_sub(t0, t0, xx);
  fq_sub(t0, t0, yyyy);
  fq_dbl(s, t0);
  fq_dbl(m, xx);
  fq_add(m, m, xx);
  Fq x3, y3, z3;
  fq_sqr(x3, m);
  fq_dbl(t0, s);
  fq_sub(x3, x3, t0);
  fq_sub(t0, s, x3);
  fq_mul(t0, m, t0);
  fq_dbl(t1, yyyy);
  fq_dbl(t1, t1);
  fq_dbl(t1, t1);
  fq_sub(y3, t0, t1);
  fq_add(z3, p.y, p.z);
  fq_sqr(z3, z3);
  fq_sub(z3, z3, yy);
  fq_sub(z3, z3, zz);
  out.x = x3;
  out.y = y3;
  out.z = z3;
}

// add-2007-bl with complete-case handling
static void g1_add(G1 &out, const G1 &p, const G1 &q) {
  if (g1_is_infinity(p)) {
    out = q;
    return;
  }
  if (g1_is_infinity(q)) {
    out = p;
    return;
  }
  Fq z1z1, z2z2, u1, u2, s1, s2, t;
  fq_sqr(z1z1, p.z);
  fq_sqr(z2z2, q.z);
  fq_mul(u1, p.x, z2z2);
  fq_mul(u2, q.x, z1z1);
  fq_mul(t, q.z, z2z2);
  fq_mul(s1, p.y, t);
  fq_mul(t, p.z, z1z1);
  fq_mul(s2, q.y, t);
  if (fq_eq(u1, u2)) {
    if (fq_eq(s1, s2)) {
      g1_double(out, p);
    } else {
      g1_set_infinity(out);
    }
    return;
  }
  Fq h, i, j, r, v;
  fq_sub(h, u2, u1);
  fq_dbl(i, h);
  fq_sqr(i, i);
  fq_mul(j, h, i);
  fq_sub(r, s2, s1);
  fq_dbl(r, r);
  fq_mul(v, u1, i);
  Fq x3, y3, z3;
  fq_sqr(x3, r);
  fq_sub(x3, x3, j);
  fq_sub(x3, x3, v);
  fq_sub(x3, x3, v);
  fq_sub(t, v, x3);
  fq_mul(t, r, t);
  fq_mul(y3, s1, j);
  fq_dbl(y3, y3);
  fq_sub(y3, t, y3);
  fq_add(z3, p.z, q.z);
  fq_sqr(z3, z3);
  fq_sub(z3, z3, z1z1);
  fq_sub(z3, z3, z2z2);
  fq_mul(z3, z3, h);
  out.x = x3;
  out.y = y3;
  out.z = z3;
}

// mixed add: q affine (z == 1 Montgomery)
static void g1_madd(G1 &out, const G1 &p, const Fq &qx, const Fq &qy) {
  if (g1_is_infinity(p)) {
    out.x = qx;
    out.y = qy;
    std::memcpy(out.z.v, FQ_ONE_MONT, sizeof out.z.v);
    return;
  }
  Fq z1z1, u2, s2, t;
  fq_sqr(z1z1, p.z);
  fq_mul(u2, qx, z1z1);
  fq_mul(t, p.z, z1z1);
  fq_mul(s2, qy, t);
  if (fq_eq(u2, p.x)) {
    if (fq_eq(s2, p.y)) {
      g1_double(out, p);
    } else {
      g1_set_infinity(out);
    }
    return;
  }
  Fq h, hh, i, j, r, v;
  fq_sub(h, u2, p.x);
  fq_sqr(hh, h);
  fq_dbl(i, hh);
  fq_dbl(i, i);
  fq_mul(j, h, i);
  fq_sub(r, s2, p.y);
  fq_dbl(r, r);
  fq_mul(v, p.x, i);
  Fq x3, y3, z3;
  fq_sqr(x3, r);
  fq_sub(x3, x3, j);
  fq_sub(x3, x3, v);
  fq_sub(x3, x3, v);
  fq_sub(t, v, x3);
  fq_mul(t, r, t);
  fq_mul(y3, p.y, j);
  fq_dbl(y3, y3);
  fq_sub(y3, t, y3);
  fq_add(z3, p.z, h);
  fq_sqr(z3, z3);
  fq_sub(z3, z3, z1z1);
  fq_sub(z3, z3, hh);
  out.x = x3;
  out.y = y3;
  out.z = z3;
}

static void load_scalar(u64 *out, const uint8_t *le32) {
  for (int i = 0; i < 4; i++) {
    u64 v = 0;
    for (int b = 7; b >= 0; b--) v = (v << 8) | le32[i * 8 + b];
    out[i] = v;
  }
}

static void load_affine(Fq &x, Fq &y, const uint8_t *xy96) {
  u64 canon[6];
  for (int i = 0; i < 6; i++) {
    u64 v = 0;
    for (int b = 7; b >= 0; b--) v = (v << 8) | xy96[i * 8 + b];
    canon[i] = v;
  }
  fq_from_canonical(x, canon);
  for (int i = 0; i < 6; i++) {
    u64 v = 0;
    for (int b = 7; b >= 0; b--) v = (v << 8) | xy96[48 + i * 8 + b];
    canon[i] = v;
  }
  fq_from_canonical(y, canon);
}

static void store_jacobian(uint8_t *out144, const G1 &p) {
  const Fq *coords[3] = {&p.x, &p.y, &p.z};
  for (int c = 0; c < 3; c++) {
    u64 canon[6];
    fq_to_canonical(canon, *coords[c]);
    for (int i = 0; i < 6; i++)
      for (int b = 0; b < 8; b++)
        out144[c * 48 + i * 8 + b] = (uint8_t)(canon[i] >> (8 * b));
  }
}

static void load_jacobian(G1 &p, const uint8_t *in144) {
  Fq *coords[3] = {&p.x, &p.y, &p.z};
  for (int c = 0; c < 3; c++) {
    u64 canon[6];
    for (int i = 0; i < 6; i++) {
      u64 v = 0;
      for (int b = 7; b >= 0; b--) v = (v << 8) | in144[c * 48 + i * 8 + b];
      canon[i] = v;
    }
    fq_from_canonical(*coords[c], canon);
  }
}

extern "C" {

// Pippenger MSM over affine points.
int g1_msm(const uint8_t *scalars_le, const uint8_t *points_xy_le, long n,
           uint8_t *out144) {
  if (n <= 0) {
    G1 inf;
    g1_set_infinity(inf);
    store_jacobian(out144, inf);
    return 0;
  }
  std::vector<Fq> px(n), py(n);
  std::vector<u64> ks(n * 4);
  for (long i = 0; i < n; i++) {
    load_affine(px[i], py[i], points_xy_le + 96 * i);
    load_scalar(&ks[i * 4], scalars_le + 32 * i);
  }
  int c = 4;
  long m = n;
  while (m > 32 && c < 13) {
    m >>= 1;
    c++;
  }
  int num_windows = (253 + c - 1) / c;
  u64 mask = (1ULL << c) - 1;
  std::vector<G1> buckets((size_t)1 << c);
  G1 acc;
  g1_set_infinity(acc);
  for (int w = num_windows - 1; w >= 0; w--) {
    for (int d = 0; d < c; d++) g1_double(acc, acc);
    for (auto &b : buckets) g1_set_infinity(b);
    int off = w * c;
    for (long i = 0; i < n; i++) {
      int limb = off >> 6, sh = off & 63;
      u64 d = ks[i * 4 + limb] >> sh;
      if (sh + c > 64 && limb < 3) d |= ks[i * 4 + limb + 1] << (64 - sh);
      d &= mask;
      if (d) g1_madd(buckets[d], buckets[d], px[i], py[i]);
    }
    G1 running, total;
    g1_set_infinity(running);
    g1_set_infinity(total);
    for (long b = (long)buckets.size() - 1; b >= 1; b--) {
      g1_add(running, running, buckets[b]);
      g1_add(total, total, running);
    }
    g1_add(acc, acc, total);
  }
  store_jacobian(out144, acc);
  return 0;
}

int g1_scalar_mul(const uint8_t *scalar_le, const uint8_t *point_xy_le,
                  uint8_t *out144) {
  return g1_msm(scalar_le, point_xy_le, 1, out144);
}

// Multi-threaded Pippenger: the points split across nthreads workers
// (each a full single-thread MSM on its slice — the same shard-and-
// reduce shape as parallel/msm_dist.py), partials combined with
// Jacobian adds.  nthreads <= 0 uses hardware_concurrency.  This is the
// CPU baseline at machine scale: a rayon backend parallelizes the same way
// across its cores.
int g1_msm_mt(const uint8_t *scalars_le, const uint8_t *points_xy_le, long n,
              int nthreads, uint8_t *out144) {
  if (nthreads <= 0) {
    unsigned hc = std::thread::hardware_concurrency();
    nthreads = hc ? (int)hc : 1;
  }
  if (nthreads == 1 || n < 2 * nthreads)
    return g1_msm(scalars_le, points_xy_le, n, out144);
  long per = (n + nthreads - 1) / nthreads;
  std::vector<std::vector<uint8_t>> outs(nthreads, std::vector<uint8_t>(144));
  std::vector<std::thread> ts;
  for (int t = 0; t < nthreads; t++) {
    long lo = t * per, hi = std::min(n, lo + per);
    if (lo >= hi) { G1 inf; g1_set_infinity(inf); store_jacobian(outs[t].data(), inf); continue; }
    ts.emplace_back([&, t, lo, hi]() {
      g1_msm(scalars_le + 32 * lo, points_xy_le + 96 * lo, hi - lo,
             outs[t].data());
    });
  }
  for (auto &th : ts) th.join();
  G1 acc, part;
  g1_set_infinity(acc);
  for (int t = 0; t < nthreads; t++) {
    load_jacobian(part, outs[t].data());
    g1_add(acc, acc, part);
  }
  store_jacobian(out144, acc);
  return 0;
}

}  // extern "C"  (reopened below for the fixed-base generator)

// ---------------------------------------------------------------------------
// Fixed-base batch generation of pseudo-random curve points: k_i * G for
// splitmix64-derived 64-bit k_i. Produces SRS-like (structure-free) bases for
// benchmarks and tests of the device MSM's fast path — structured bases
// such as (i+1)*G admit small-subset-sum collisions that constantly trip the
// incomplete add's exception flag (ops/msm_kernels.py), which real bases
// (powers of tau) never do.
// ---------------------------------------------------------------------------

#include <thread>

static const u64 GEN_X[6] = {0xeab9b16eb21be9efULL, 0xd5481512ffcd394eULL,
                             0x188282c8bd37cb5cULL, 0x85951e2caa9d41bbULL,
                             0xc8fc6225bf87ff54ULL, 0x008848defe740a67ULL};
static const u64 GEN_Y[6] = {0xfd82de55559c8ea6ULL, 0xc2fe3d3634a9591aULL,
                             0x6d182ad44fb82305ULL, 0xbd7fb348ca3e52d9ULL,
                             0x1f674f5d30afeec4ULL, 0x01914a69c5102effULL};

static u64 splitmix64(u64 &state) {
  u64 z = (state += 0x9e3779b97f4a7c15ULL);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  return z ^ (z >> 31);
}

// Batch-normalize jac[0..n) to affine Montgomery coords (Montgomery trick:
// one fq_inv per call). Inputs must be finite.
static void g1_batch_to_affine(G1 *jac, long n, Fq *ax, Fq *ay) {
  std::vector<Fq> prefix(n + 1);
  std::memcpy(prefix[0].v, FQ_ONE_MONT, sizeof prefix[0].v);
  for (long i = 0; i < n; i++) fq_mul(prefix[i + 1], prefix[i], jac[i].z);
  Fq inv;
  fq_inv(inv, prefix[n]);
  for (long i = n - 1; i >= 0; i--) {
    Fq zi, zi2;
    fq_mul(zi, prefix[i], inv);       // 1/z_i
    fq_mul(inv, inv, jac[i].z);       // strip z_i from the running inverse
    fq_sqr(zi2, zi);
    fq_mul(ax[i], jac[i].x, zi2);
    fq_mul(zi2, zi2, zi);
    fq_mul(ay[i], jac[i].y, zi2);
  }
}

extern "C" {

// out_xy: n * 96 bytes, canonical little-endian affine x||y of k_i * G with
// k_i = splitmix64(seed, i) | 1 (64-bit, odd => nonzero). Threaded.
int g1_fixed_base_gen(u64 seed, long n, uint8_t *out_xy) {
  if (n <= 0) return 0;
  // window tables: 8 windows x 255 entries, T[w][d-1] = d * 2^(8w) * G,
  // normalized to affine so the per-point loop uses the cheaper g1_madd.
  static const int W = 8, D = 255;
  std::vector<G1> table_jac(W * D);
  G1 base;
  fq_from_canonical(base.x, GEN_X);
  fq_from_canonical(base.y, GEN_Y);
  std::memcpy(base.z.v, FQ_ONE_MONT, sizeof base.z.v);
  for (int w = 0; w < W; w++) {
    G1 cur = base;
    for (int d = 0; d < D; d++) {
      table_jac[w * D + d] = cur;
      g1_add(cur, cur, base);
    }
    for (int b = 0; b < 8; b++) g1_double(base, base);
  }
  std::vector<Fq> tx(W * D), ty(W * D);
  g1_batch_to_affine(table_jac.data(), W * D, tx.data(), ty.data());

  unsigned nthreads = std::thread::hardware_concurrency();
  if (nthreads == 0) nthreads = 1;
  if (nthreads > 32) nthreads = 32;
  if ((long)nthreads > n) nthreads = (unsigned)n;
  std::vector<std::thread> threads;
  const long CHUNK_N = 4096;
  auto worker = [&](long lo, long hi) {
    std::vector<G1> jac(CHUNK_N);
    std::vector<Fq> ax(CHUNK_N), ay(CHUNK_N);
    for (long start = lo; start < hi; start += CHUNK_N) {
      long m = std::min(CHUNK_N, hi - start);
      for (long i = 0; i < m; i++) {
        u64 st = seed + (u64)(start + i) * 0x9e3779b97f4a7c15ULL;
        u64 k = splitmix64(st) | 1ULL;
        G1 acc;
        g1_set_infinity(acc);
        for (int w = 0; w < W; w++) {
          unsigned d = (unsigned)((k >> (8 * w)) & 0xFF);
          if (d) g1_madd(acc, acc, tx[w * D + d - 1], ty[w * D + d - 1]);
        }
        jac[i] = acc;  // k odd => never infinity
      }
      g1_batch_to_affine(jac.data(), m, ax.data(), ay.data());
      for (long i = 0; i < m; i++) {
        u64 canon[6];
        uint8_t *dst = out_xy + 96 * (start + i);
        fq_to_canonical(canon, ax[i]);
        for (int l = 0; l < 6; l++)
          for (int b = 0; b < 8; b++)
            dst[l * 8 + b] = (uint8_t)(canon[l] >> (8 * b));
        fq_to_canonical(canon, ay[i]);
        for (int l = 0; l < 6; l++)
          for (int b = 0; b < 8; b++)
            dst[48 + l * 8 + b] = (uint8_t)(canon[l] >> (8 * b));
      }
    }
  };
  long per = (n + nthreads - 1) / nthreads;
  for (unsigned t = 0; t < nthreads; t++) {
    long lo = t * per, hi = std::min<long>(n, lo + per);
    if (lo >= hi) break;
    threads.emplace_back(worker, lo, hi);
  }
  for (auto &th : threads) th.join();
  return 0;
}

}  // extern "C"
