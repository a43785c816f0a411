// BLS12-377 scalar field Fr: 4x64 Montgomery arithmetic (CIOS multiply).
// Used by the host Poseidon sponge (poseidon377.cpp) that runs the node's
// Fiat-Shamir transcripts, signatures and record hashes.
#pragma once

#include <cstdint>
#include <cstring>

typedef unsigned __int128 u128;
typedef uint64_t u64;

static const u64 FR_Q[4] = {0x0a11800000000001ULL, 0x59aa76fed0000001ULL,
                            0x60b44d1e5c37b001ULL, 0x12ab655e9a2ca556ULL};
static const u64 FR_R2[4] = {0x25d577bab861857bULL, 0xcc2c27b58860591fULL,
                             0xa7cc008fe5dc8593ULL, 0x011fdae7eff1c939ULL};
static const u64 FR_N0INV = 0x0a117fffffffffffULL;
static const u64 FR_ONE_MONT[4] = {0x7d1c7ffffffffff3ULL, 0x7257f50f6ffffff2ULL,
                                   0x16d81575512c0feeULL, 0x0d4bda322bbb9a9dULL};

struct Fr {
  u64 v[4];
};

static inline bool fr_geq_q(const u64 *a) {
  for (int i = 3; i >= 0; i--) {
    if (a[i] > FR_Q[i]) return true;
    if (a[i] < FR_Q[i]) return false;
  }
  return true;
}

static inline void fr_sub_q(u64 *a) {
  u128 borrow = 0;
  for (int i = 0; i < 4; i++) {
    u128 d = (u128)a[i] - FR_Q[i] - borrow;
    a[i] = (u64)d;
    borrow = (d >> 64) & 1;
  }
}

static inline void fr_add(Fr &out, const Fr &a, const Fr &b) {
  u128 carry = 0;
  for (int i = 0; i < 4; i++) {
    u128 s = (u128)a.v[i] + b.v[i] + carry;
    out.v[i] = (u64)s;
    carry = s >> 64;
  }
  if (carry || fr_geq_q(out.v)) fr_sub_q(out.v);
}

// CIOS Montgomery multiply: out = a * b * R^-1 mod r
static void fr_mul(Fr &out, const Fr &a, const Fr &b) {
  u64 t[6] = {0};
  for (int i = 0; i < 4; i++) {
    u128 carry = 0;
    u64 ai = a.v[i];
    for (int j = 0; j < 4; j++) {
      u128 s = (u128)ai * b.v[j] + t[j] + carry;
      t[j] = (u64)s;
      carry = s >> 64;
    }
    u128 s = (u128)t[4] + carry;
    t[4] = (u64)s;
    t[5] = (u64)(s >> 64);

    u64 m = t[0] * FR_N0INV;
    carry = 0;
    u128 s0 = (u128)m * FR_Q[0] + t[0];
    carry = s0 >> 64;
    for (int j = 1; j < 4; j++) {
      u128 sj = (u128)m * FR_Q[j] + t[j] + carry;
      t[j - 1] = (u64)sj;
      carry = sj >> 64;
    }
    s0 = (u128)t[4] + carry;
    t[3] = (u64)s0;
    carry = s0 >> 64;
    t[4] = t[5] + (u64)carry;
    t[5] = 0;
  }
  std::memcpy(out.v, t, 4 * sizeof(u64));
  if (t[4] || fr_geq_q(out.v)) fr_sub_q(out.v);
}

static inline void fr_sqr(Fr &out, const Fr &a) { fr_mul(out, a, a); }

static void fr_from_canonical(Fr &out, const u64 *canon) {
  Fr tmp, r2;
  std::memcpy(tmp.v, canon, 4 * sizeof(u64));
  std::memcpy(r2.v, FR_R2, 4 * sizeof(u64));
  fr_mul(out, tmp, r2);
}

static void fr_to_canonical(u64 *out, const Fr &a) {
  Fr one_raw, res;
  std::memset(one_raw.v, 0, sizeof one_raw.v);
  one_raw.v[0] = 1;
  fr_mul(res, a, one_raw);
  std::memcpy(out, res.v, 4 * sizeof(u64));
}

static void fr_load_le32(Fr &out, const uint8_t *le32) {
  u64 canon[4];
  for (int i = 0; i < 4; i++) {
    u64 v = 0;
    for (int b = 7; b >= 0; b--) v = (v << 8) | le32[i * 8 + b];
    canon[i] = v;
  }
  fr_from_canonical(out, canon);
}

static void fr_store_le32(uint8_t *le32, const Fr &a) {
  u64 canon[4];
  fr_to_canonical(canon, a);
  for (int i = 0; i < 4; i++)
    for (int b = 0; b < 8; b++) le32[i * 8 + b] = (uint8_t)(canon[i] >> (8 * b));
}
