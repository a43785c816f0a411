// BLS12-377 base field Fq: 6x64 Montgomery arithmetic (CIOS multiply).
// Shared by the host G1 engine (g1_msm.cpp) and the pairing engine
// (pairing377.cpp). Header-only; all functions static so each TU gets its
// own copy (both libraries are small). Built with g++ by
// snarkos_tpu_torch/ops/_build.py and bound by snarkos_tpu_torch/utils/native.py.
#pragma once

#include <cstdint>
#include <cstring>

typedef unsigned __int128 u128;
typedef uint64_t u64;

static const u64 FQ_Q[6] = {0x8508c00000000001ULL, 0x170b5d4430000000ULL,
                            0x1ef3622fba094800ULL, 0x1a22d9f300f5138fULL,
                            0xc63b05c06ca1493bULL, 0x01ae3a4617c510eaULL};
static const u64 FQ_R2[6] = {0xb786686c9400cd22ULL, 0x0329fcaab00431b1ULL,
                             0x22a5f11162d6b46dULL, 0xbfdf7d03827dc3acULL,
                             0x837e92f041790bf9ULL, 0x006dfccb1e914b88ULL};
static const u64 FQ_N0INV = 0x8508bfffffffffffULL;
static const u64 FQ_ONE_MONT[6] = {0x02cdffffffffff68ULL, 0x51409f837fffffb1ULL,
                                   0x9f7db3a98a7d3ff2ULL, 0x7b4e97b76e7c6305ULL,
                                   0x4cf495bf803c84e8ULL, 0x008d6661e2fdf49aULL};

struct Fq {
  u64 v[6];
};

static inline bool fq_is_zero(const Fq &a) {
  u64 acc = 0;
  for (int i = 0; i < 6; i++) acc |= a.v[i];
  return acc == 0;
}

static inline bool fq_eq(const Fq &a, const Fq &b) {
  u64 acc = 0;
  for (int i = 0; i < 6; i++) acc |= a.v[i] ^ b.v[i];
  return acc == 0;
}

static inline bool fq_geq_q(const u64 *a) {
  for (int i = 5; i >= 0; i--) {
    if (a[i] > FQ_Q[i]) return true;
    if (a[i] < FQ_Q[i]) return false;
  }
  return true;  // equal
}

static inline void fq_sub_q(u64 *a) {
  u128 borrow = 0;
  for (int i = 0; i < 6; i++) {
    u128 d = (u128)a[i] - FQ_Q[i] - borrow;
    a[i] = (u64)d;
    borrow = (d >> 64) & 1;
  }
}

static inline void fq_add(Fq &out, const Fq &a, const Fq &b) {
  u128 carry = 0;
  for (int i = 0; i < 6; i++) {
    u128 s = (u128)a.v[i] + b.v[i] + carry;
    out.v[i] = (u64)s;
    carry = s >> 64;
  }
  if (carry || fq_geq_q(out.v)) fq_sub_q(out.v);
}

static inline void fq_sub(Fq &out, const Fq &a, const Fq &b) {
  u128 borrow = 0;
  u64 t[6];
  for (int i = 0; i < 6; i++) {
    u128 d = (u128)a.v[i] - b.v[i] - borrow;
    t[i] = (u64)d;
    borrow = (d >> 64) & 1;
  }
  if (borrow) {
    u128 carry = 0;
    for (int i = 0; i < 6; i++) {
      u128 s = (u128)t[i] + FQ_Q[i] + carry;
      t[i] = (u64)s;
      carry = s >> 64;
    }
  }
  std::memcpy(out.v, t, sizeof t);
}

static inline void fq_neg(Fq &out, const Fq &a) {
  Fq zero;
  std::memset(zero.v, 0, sizeof zero.v);
  if (fq_is_zero(a)) {
    out = zero;
    return;
  }
  fq_sub(out, zero, a);
}

static inline void fq_dbl(Fq &out, const Fq &a) { fq_add(out, a, a); }

// CIOS Montgomery multiply: out = a * b * R^-1 mod q
static void fq_mul(Fq &out, const Fq &a, const Fq &b) {
  u64 t[8] = {0};
  for (int i = 0; i < 6; i++) {
    u128 carry = 0;
    u64 ai = a.v[i];
    for (int j = 0; j < 6; j++) {
      u128 s = (u128)ai * b.v[j] + t[j] + carry;
      t[j] = (u64)s;
      carry = s >> 64;
    }
    u128 s = (u128)t[6] + carry;
    t[6] = (u64)s;
    t[7] = (u64)(s >> 64);

    u64 m = t[0] * FQ_N0INV;
    carry = 0;
    u128 s0 = (u128)m * FQ_Q[0] + t[0];
    carry = s0 >> 64;
    for (int j = 1; j < 6; j++) {
      u128 sj = (u128)m * FQ_Q[j] + t[j] + carry;
      t[j - 1] = (u64)sj;
      carry = sj >> 64;
    }
    s0 = (u128)t[6] + carry;
    t[5] = (u64)s0;
    carry = s0 >> 64;
    t[6] = t[7] + (u64)carry;
    t[7] = 0;
  }
  std::memcpy(out.v, t, 6 * sizeof(u64));
  if (t[6] || fq_geq_q(out.v)) fq_sub_q(out.v);
}

static inline void fq_sqr(Fq &out, const Fq &a) { fq_mul(out, a, a); }

static void fq_from_canonical(Fq &out, const u64 *canon) {
  Fq tmp, r2;
  std::memcpy(tmp.v, canon, 6 * sizeof(u64));
  std::memcpy(r2.v, FQ_R2, 6 * sizeof(u64));
  fq_mul(out, tmp, r2);
}

static void fq_to_canonical(u64 *out, const Fq &a) {
  // multiply by 1 (non-Montgomery) = Montgomery reduce
  Fq one_raw, res;
  std::memset(one_raw.v, 0, sizeof one_raw.v);
  one_raw.v[0] = 1;
  fq_mul(res, a, one_raw);
  std::memcpy(out, res.v, 6 * sizeof(u64));
}

// Fermat inversion: a^(q-2). ~750 muls.
static void fq_inv(Fq &out, const Fq &a) {
  u64 e[6];
  std::memcpy(e, FQ_Q, sizeof e);
  e[0] -= 2;  // q is odd with q[0] >= 2: no borrow
  Fq base = a, acc;
  std::memcpy(acc.v, FQ_ONE_MONT, sizeof acc.v);
  for (int limb = 0; limb < 6; limb++) {
    u64 bits = e[limb];
    for (int b = 0; b < 64; b++) {
      if (bits & 1) fq_mul(acc, acc, base);
      fq_sqr(base, base);
      bits >>= 1;
    }
  }
  out = acc;
}

// Load a canonical little-endian 48-byte field element into Montgomery form.
static void fq_load_le48(Fq &out, const uint8_t *le48) {
  u64 canon[6];
  for (int i = 0; i < 6; i++) {
    u64 v = 0;
    for (int b = 7; b >= 0; b--) v = (v << 8) | le48[i * 8 + b];
    canon[i] = v;
  }
  fq_from_canonical(out, canon);
}

// Store Montgomery form as canonical little-endian 48 bytes.
static void fq_store_le48(uint8_t *le48, const Fq &a) {
  u64 canon[6];
  fq_to_canonical(canon, a);
  for (int i = 0; i < 6; i++)
    for (int b = 0; b < 8; b++) le48[i * 8 + b] = (uint8_t)(canon[i] >> (8 * b));
}
