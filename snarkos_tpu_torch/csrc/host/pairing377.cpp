// BLS12-377 pairing engine: Fq2/Fq6/Fq12 tower, G2 arithmetic, optimal ate
// Miller loop (projective, inversion-free line evaluation) and a fast final
// exponentiation (BLS12 hard-part addition chain).
//
// Why this exists: a node checks a pairing product for every block, every
// gossiped solution and every transaction's Varuna proof. The pure-Python
// pairing (snarkos_tpu_torch/crypto/ref/pairing.py, its plain version) costs
// ~1 s a pairing; this engine takes a few ms. A pairing check is one short
// chain of dependent Fq products, so it stays on the host: the card keeps
// the MSMs (snarkos_tpu_torch/ops/kzg.py).
//
// Tower (identical to crypto/ref/pairing.py so values are bit-exact):
//   Fq2  = Fq[u]/(u^2 + 5)
//   Fq6  = Fq2[v]/(v^3 - u)
//   Fq12 = Fq6[w]/(w^2 - v)        (flat basis: w^6 = u, v = w^2)
// Twist: E'(Fq2): y^2 = x^3 + b',  untwist psi(x,y) = (x w^2, y w^3).
//
// Exposed C ABI (ctypes, snarkos_tpu_torch/utils/native.py):
//   pairing377_multi(g1_xy[96n], g2_xy[192n], n, out[1152])
//     -> prod_i e(P_i, Q_i), flat-basis c0..c5 coefficients, each Fq2 as
//        (re, im) canonical little-endian 48-byte field elements.
//        Bit-exact vs crypto/ref/pairing.multi_pairing_plain.
//   pairing377_check(g1_xy, g2_xy, n) -> 1 if the product == 1 (skips the
//        cube-root correction: the final-exp image has prime order r and
//        gcd(3, r) = 1, so f^(3e) == 1 iff f^e == 1), 0 if not, -1 bad input.
//   g2_scalar_mul377(scalar_le32, g2_xy[192], out[192]) -> affine k*Q.
// Infinity convention: all-zero coordinate bytes ((0,0) is not on either
// curve since b != 0).

#include <cstdint>
#include <cstring>

#include "fq377.h"

// ------------------------------------------------------------------- Fq2 --
struct Fq2 {
  Fq c0, c1;
};

static Fq2 F2ZERO, F2ONE;  // set in init_consts

static inline bool f2_is_zero(const Fq2 &a) {
  return fq_is_zero(a.c0) && fq_is_zero(a.c1);
}

static inline bool f2_eq(const Fq2 &a, const Fq2 &b) {
  return fq_eq(a.c0, b.c0) && fq_eq(a.c1, b.c1);
}

static inline void f2_add(Fq2 &o, const Fq2 &a, const Fq2 &b) {
  fq_add(o.c0, a.c0, b.c0);
  fq_add(o.c1, a.c1, b.c1);
}

static inline void f2_sub(Fq2 &o, const Fq2 &a, const Fq2 &b) {
  fq_sub(o.c0, a.c0, b.c0);
  fq_sub(o.c1, a.c1, b.c1);
}

static inline void f2_neg(Fq2 &o, const Fq2 &a) {
  fq_neg(o.c0, a.c0);
  fq_neg(o.c1, a.c1);
}

static inline void f2_dbl(Fq2 &o, const Fq2 &a) { f2_add(o, a, a); }

// out = -5 * a  (multiplication by the Fq2 nonresidue u^2 = -5)
static inline void fq_mul_neg5(Fq &o, const Fq &a) {
  Fq t;
  fq_dbl(t, a);
  fq_dbl(t, t);
  fq_add(t, t, a);  // 5a
  fq_neg(o, t);
}

// Karatsuba: (a0 + a1 u)(b0 + b1 u) = a0b0 - 5 a1b1 + ((a0+a1)(b0+b1) - a0b0 - a1b1) u
static void f2_mul(Fq2 &o, const Fq2 &a, const Fq2 &b) {
  Fq v0, v1, s, t, u_;
  fq_mul(v0, a.c0, b.c0);
  fq_mul(v1, a.c1, b.c1);
  fq_add(s, a.c0, a.c1);
  fq_add(t, b.c0, b.c1);
  fq_mul(u_, s, t);
  fq_sub(u_, u_, v0);
  fq_sub(o.c1, u_, v1);
  fq_mul_neg5(t, v1);
  fq_add(o.c0, v0, t);
}

// Complex squaring: c0 = (a0+a1)(a0-5a1) + 4 a0a1 ... derived:
// c0 = a0^2 - 5 a1^2, c1 = 2 a0 a1.
// (a0+a1)(a0 + nr*a1) = a0^2 + nr a1^2 + (1+nr) a0a1; subtract (1+nr) v where v=a0a1.
static void f2_sq(Fq2 &o, const Fq2 &a) {
  Fq v, s, t, nr_a1;
  fq_mul(v, a.c0, a.c1);
  fq_add(s, a.c0, a.c1);
  fq_mul_neg5(nr_a1, a.c1);
  fq_add(t, a.c0, nr_a1);
  fq_mul(t, s, t);  // a0^2 + nr a1^2 + (1 + nr) a0a1
  // subtract (1 + nr) v = v + nr*v
  Fq nv;
  fq_mul_neg5(nv, v);
  fq_sub(t, t, v);
  fq_sub(o.c0, t, nv);
  fq_dbl(o.c1, v);
}

static inline void f2_scal(Fq2 &o, const Fq2 &a, const Fq &k) {
  fq_mul(o.c0, a.c0, k);
  fq_mul(o.c1, a.c1, k);
}

static void f2_inv(Fq2 &o, const Fq2 &a) {
  // (a0 - a1 u) / (a0^2 + 5 a1^2)
  Fq t0, t1, norm, ninv;
  fq_sqr(t0, a.c0);
  fq_sqr(t1, a.c1);
  fq_dbl(norm, t1);
  fq_dbl(norm, norm);
  fq_add(norm, norm, t1);  // 5 a1^2
  fq_add(norm, t0, norm);
  fq_inv(ninv, norm);
  fq_mul(o.c0, a.c0, ninv);
  Fq na1;
  fq_neg(na1, a.c1);
  fq_mul(o.c1, na1, ninv);
}

// u * (a0 + a1 u) = -5 a1 + a0 u
static inline void f2_mul_by_u(Fq2 &o, const Fq2 &a) {
  Fq t;
  fq_mul_neg5(t, a.c1);
  o.c1 = a.c0;
  o.c0 = t;
}

static void f2_pow_limbs(Fq2 &o, const Fq2 &base, const u64 *e, int nlimbs) {
  Fq2 acc = F2ONE, b = base;
  for (int i = 0; i < nlimbs; i++) {
    u64 bits = e[i];
    for (int j = 0; j < 64; j++) {
      if (bits & 1) f2_mul(acc, acc, b);
      f2_sq(b, b);
      bits >>= 1;
    }
  }
  o = acc;
}

// ------------------------------------------------------------------- Fq6 --
struct Fq6 {
  Fq2 c0, c1, c2;
};

static inline void f6_add(Fq6 &o, const Fq6 &a, const Fq6 &b) {
  f2_add(o.c0, a.c0, b.c0);
  f2_add(o.c1, a.c1, b.c1);
  f2_add(o.c2, a.c2, b.c2);
}

static inline void f6_sub(Fq6 &o, const Fq6 &a, const Fq6 &b) {
  f2_sub(o.c0, a.c0, b.c0);
  f2_sub(o.c1, a.c1, b.c1);
  f2_sub(o.c2, a.c2, b.c2);
}

static inline void f6_neg(Fq6 &o, const Fq6 &a) {
  f2_neg(o.c0, a.c0);
  f2_neg(o.c1, a.c1);
  f2_neg(o.c2, a.c2);
}

// Karatsuba-3 over v^3 = u.
static void f6_mul(Fq6 &o, const Fq6 &a, const Fq6 &b) {
  Fq2 v0, v1, v2, t0, t1, t2;
  f2_mul(v0, a.c0, b.c0);
  f2_mul(v1, a.c1, b.c1);
  f2_mul(v2, a.c2, b.c2);
  // c0 = v0 + u*((a1+a2)(b1+b2) - v1 - v2)
  f2_add(t0, a.c1, a.c2);
  f2_add(t1, b.c1, b.c2);
  f2_mul(t2, t0, t1);
  f2_sub(t2, t2, v1);
  f2_sub(t2, t2, v2);
  f2_mul_by_u(t2, t2);
  Fq2 c0;
  f2_add(c0, v0, t2);
  // c1 = (a0+a1)(b0+b1) - v0 - v1 + u*v2
  f2_add(t0, a.c0, a.c1);
  f2_add(t1, b.c0, b.c1);
  f2_mul(t2, t0, t1);
  f2_sub(t2, t2, v0);
  f2_sub(t2, t2, v1);
  Fq2 uv2;
  f2_mul_by_u(uv2, v2);
  Fq2 c1;
  f2_add(c1, t2, uv2);
  // c2 = (a0+a2)(b0+b2) - v0 - v2 + v1
  f2_add(t0, a.c0, a.c2);
  f2_add(t1, b.c0, b.c2);
  f2_mul(t2, t0, t1);
  f2_sub(t2, t2, v0);
  f2_sub(t2, t2, v2);
  f2_add(o.c2, t2, v1);
  o.c0 = c0;
  o.c1 = c1;
}

static inline void f6_sq(Fq6 &o, const Fq6 &a) { f6_mul(o, a, a); }

// v * (c0 + c1 v + c2 v^2) = u c2 + c0 v + c1 v^2
static inline void f6_mul_by_v(Fq6 &o, const Fq6 &a) {
  Fq2 t;
  f2_mul_by_u(t, a.c2);
  o.c2 = a.c1;
  o.c1 = a.c0;
  o.c0 = t;
}

static inline void f6_scal2(Fq6 &o, const Fq6 &a, const Fq2 &k) {
  f2_mul(o.c0, a.c0, k);
  f2_mul(o.c1, a.c1, k);
  f2_mul(o.c2, a.c2, k);
}

static void f6_inv(Fq6 &o, const Fq6 &a) {
  // Standard cubic-extension inversion with nonresidue u.
  Fq2 A, B, C, t0, t1, t2, F, Finv;
  f2_sq(t0, a.c0);
  f2_mul(t1, a.c1, a.c2);
  f2_mul_by_u(t1, t1);
  f2_sub(A, t0, t1);  // a0^2 - u a1 a2
  f2_sq(t0, a.c2);
  f2_mul_by_u(t0, t0);
  f2_mul(t1, a.c0, a.c1);
  f2_sub(B, t0, t1);  // u a2^2 - a0 a1
  f2_sq(t0, a.c1);
  f2_mul(t1, a.c0, a.c2);
  f2_sub(C, t0, t1);  // a1^2 - a0 a2
  // F = a0 A + u (a2 B + a1 C)
  f2_mul(t0, a.c2, B);
  f2_mul(t1, a.c1, C);
  f2_add(t0, t0, t1);
  f2_mul_by_u(t0, t0);
  f2_mul(t2, a.c0, A);
  f2_add(F, t2, t0);
  f2_inv(Finv, F);
  f2_mul(o.c0, A, Finv);
  f2_mul(o.c1, B, Finv);
  f2_mul(o.c2, C, Finv);
}

// ------------------------------------------------------------------ Fq12 --
struct Fq12 {
  Fq6 c0, c1;
};

static Fq12 F12ONE;  // set in init_consts

static inline bool f12_eq(const Fq12 &a, const Fq12 &b) {
  return f2_eq(a.c0.c0, b.c0.c0) && f2_eq(a.c0.c1, b.c0.c1) &&
         f2_eq(a.c0.c2, b.c0.c2) && f2_eq(a.c1.c0, b.c1.c0) &&
         f2_eq(a.c1.c1, b.c1.c1) && f2_eq(a.c1.c2, b.c1.c2);
}

static void f12_mul(Fq12 &o, const Fq12 &a, const Fq12 &b) {
  Fq6 v0, v1, t0, t1, t2;
  f6_mul(v0, a.c0, b.c0);
  f6_mul(v1, a.c1, b.c1);
  f6_add(t0, a.c0, a.c1);
  f6_add(t1, b.c0, b.c1);
  f6_mul(t2, t0, t1);
  f6_sub(t2, t2, v0);
  f6_sub(o.c1, t2, v1);
  f6_mul_by_v(t0, v1);
  f6_add(o.c0, v0, t0);
}

static void f12_sq(Fq12 &o, const Fq12 &a) {
  // c0 = (a0+a1)(a0 + v a1) - v0 - v v0,  c1 = 2 v0,  v0 = a0 a1
  Fq6 v0, t0, t1, t2;
  f6_mul(v0, a.c0, a.c1);
  f6_add(t0, a.c0, a.c1);
  f6_mul_by_v(t1, a.c1);
  f6_add(t1, a.c0, t1);
  f6_mul(t2, t0, t1);
  f6_sub(t2, t2, v0);
  f6_mul_by_v(t0, v0);
  f6_sub(o.c0, t2, t0);
  f6_add(o.c1, v0, v0);
}

static inline void f12_conj(Fq12 &o, const Fq12 &a) {
  o.c0 = a.c0;
  f6_neg(o.c1, a.c1);
}

static void f12_inv(Fq12 &o, const Fq12 &a) {
  Fq6 t0, t1, norm, ninv;
  f6_mul(t0, a.c0, a.c0);
  f6_mul(t1, a.c1, a.c1);
  f6_mul_by_v(t1, t1);
  f6_sub(norm, t0, t1);
  f6_inv(ninv, norm);
  f6_mul(o.c0, a.c0, ninv);
  Fq6 n1;
  f6_neg(n1, a.c1);
  f6_mul(o.c1, n1, ninv);
}

// ------------------------------------------------------------- Frobenius --
// gamma12 = u^((q-1)/6), gamma61 = gamma12^2 = u^((q-1)/3),
// gamma62 = gamma61^2 = u^(2(q-1)/3)  — all in Fq2.
static Fq2 GAMMA12, GAMMA61, GAMMA62;

static inline void f2_frob(Fq2 &o, const Fq2 &a) {
  o.c0 = a.c0;
  fq_neg(o.c1, a.c1);
}

static void f6_frob(Fq6 &o, const Fq6 &a) {
  f2_frob(o.c0, a.c0);
  Fq2 t;
  f2_frob(t, a.c1);
  f2_mul(o.c1, t, GAMMA61);
  f2_frob(t, a.c2);
  f2_mul(o.c2, t, GAMMA62);
}

static void f12_frob(Fq12 &o, const Fq12 &a) {
  f6_frob(o.c0, a.c0);
  Fq6 t;
  f6_frob(t, a.c1);
  f6_scal2(o.c1, t, GAMMA12);
}

// --------------------------------------------------------------- G2 / G1 --
static Fq2 TWIST_B;  // b' = (0, B1)

struct G2Jac {
  Fq2 x, y, z;  // z == 0 -> infinity
};

struct G1Aff {
  Fq x, y;
  bool inf;
};

struct G2Aff {
  Fq2 x, y;
  bool inf;
};

// dbl-2009-l (a = 0) over Fq2
static void g2_double(G2Jac &out, const G2Jac &p) {
  if (f2_is_zero(p.z)) {
    out = p;
    return;
  }
  Fq2 A, B, C, D, E, F, t;
  f2_sq(A, p.x);
  f2_sq(B, p.y);
  f2_sq(C, B);
  f2_add(t, p.x, B);
  f2_sq(t, t);
  f2_sub(t, t, A);
  f2_sub(t, t, C);
  f2_dbl(D, t);
  f2_dbl(E, A);
  f2_add(E, E, A);
  f2_sq(F, E);
  Fq2 x3, y3, z3;
  f2_dbl(t, D);
  f2_sub(x3, F, t);
  f2_sub(t, D, x3);
  f2_mul(t, E, t);
  Fq2 c8;
  f2_dbl(c8, C);
  f2_dbl(c8, c8);
  f2_dbl(c8, c8);
  f2_sub(y3, t, c8);
  f2_mul(z3, p.y, p.z);
  f2_dbl(z3, z3);
  out.x = x3;
  out.y = y3;
  out.z = z3;
}

// mixed add (q affine) over Fq2, madd-2007-bl
static void g2_madd(G2Jac &out, const G2Jac &p, const Fq2 &qx, const Fq2 &qy) {
  if (f2_is_zero(p.z)) {
    out.x = qx;
    out.y = qy;
    out.z = F2ONE;
    return;
  }
  Fq2 z1z1, u2, s2, t;
  f2_sq(z1z1, p.z);
  f2_mul(u2, qx, z1z1);
  f2_mul(t, p.z, z1z1);
  f2_mul(s2, qy, t);
  if (f2_eq(u2, p.x)) {
    if (f2_eq(s2, p.y)) {
      g2_double(out, p);
    } else {
      out.x = F2ONE;
      out.y = F2ONE;
      out.z = F2ZERO;
    }
    return;
  }
  Fq2 h, hh, i, j, r, v;
  f2_sub(h, u2, p.x);
  f2_sq(hh, h);
  f2_dbl(i, hh);
  f2_dbl(i, i);
  f2_mul(j, h, i);
  f2_sub(r, s2, p.y);
  f2_dbl(r, r);
  f2_mul(v, p.x, i);
  Fq2 x3, y3, z3;
  f2_sq(x3, r);
  f2_sub(x3, x3, j);
  f2_sub(x3, x3, v);
  f2_sub(x3, x3, v);
  f2_sub(t, v, x3);
  f2_mul(t, r, t);
  f2_mul(y3, p.y, j);
  f2_dbl(y3, y3);
  f2_sub(y3, t, y3);
  f2_add(z3, p.z, h);
  f2_sq(z3, z3);
  f2_sub(z3, z3, z1z1);
  f2_sub(z3, z3, hh);
  out.x = x3;
  out.y = y3;
  out.z = z3;
}

static bool g2_on_curve(const G2Aff &p) {
  if (p.inf) return true;
  Fq2 lhs, rhs;
  f2_sq(lhs, p.y);
  f2_sq(rhs, p.x);
  f2_mul(rhs, rhs, p.x);
  f2_add(rhs, rhs, TWIST_B);
  return f2_eq(lhs, rhs);
}

static bool g1_on_curve(const G1Aff &p) {
  if (p.inf) return true;
  Fq lhs, rhs, one;
  fq_sqr(lhs, p.y);
  fq_sqr(rhs, p.x);
  fq_mul(rhs, rhs, p.x);
  std::memcpy(one.v, FQ_ONE_MONT, sizeof one.v);
  fq_add(rhs, rhs, one);
  return fq_eq(lhs, rhs);
}

// ---------------------------------------------------------- Miller loop ---
// Sparse line l = a + b w + c w^3 with a, b, c in Fq2. In the nested tower
// this is (c0=(a,0,0), c1=(b,c,0)); multiply into f with 15 Fq2 muls.
static void f12_mul_by_line(Fq12 &f, const Fq2 &la, const Fq2 &lb,
                            const Fq2 &lc) {
  // v0 = f0 * (a,0,0)
  Fq6 v0, v1;
  f2_mul(v0.c0, f.c0.c0, la);
  f2_mul(v0.c1, f.c0.c1, la);
  f2_mul(v0.c2, f.c0.c2, la);
  // v1 = f1 * (b + c v):  (g0,g1,g2)(m0 + m1 v) =
  //   (g0 m0 + u g2 m1,  g1 m0 + g0 m1,  g2 m0 + g1 m1)
  {
    Fq2 t0, t1;
    f2_mul(t0, f.c1.c0, lb);
    f2_mul(t1, f.c1.c2, lc);
    f2_mul_by_u(t1, t1);
    f2_add(v1.c0, t0, t1);
    f2_mul(t0, f.c1.c1, lb);
    f2_mul(t1, f.c1.c0, lc);
    f2_add(v1.c1, t0, t1);
    f2_mul(t0, f.c1.c2, lb);
    f2_mul(t1, f.c1.c1, lc);
    f2_add(v1.c2, t0, t1);
  }
  // c1 = (f0 + f1)(l0 + l1) - v0 - v1, with l0 + l1 = (a + b) + c v
  Fq6 fsum, cross;
  f6_add(fsum, f.c0, f.c1);
  Fq2 m0;
  f2_add(m0, la, lb);
  {
    Fq2 t0, t1;
    f2_mul(t0, fsum.c0, m0);
    f2_mul(t1, fsum.c2, lc);
    f2_mul_by_u(t1, t1);
    f2_add(cross.c0, t0, t1);
    f2_mul(t0, fsum.c1, m0);
    f2_mul(t1, fsum.c0, lc);
    f2_add(cross.c1, t0, t1);
    f2_mul(t0, fsum.c2, m0);
    f2_mul(t1, fsum.c1, lc);
    f2_add(cross.c2, t0, t1);
  }
  f6_sub(cross, cross, v0);
  f6_sub(f.c1, cross, v1);
  // c0 = v0 + v * v1
  Fq6 vv1;
  f6_mul_by_v(vv1, v1);
  f6_add(f.c0, v0, vv1);
}

static const u64 BLS_X = 0x8508C00000000001ULL;

// f_{x,Q}(P); line evaluations are inversion-free (Jacobian denominators are
// absorbed into Fq2 factors, which the final exponentiation kills since
// Fq2* subset Fq6* has order dividing q^6 - 1).
static void miller_loop(Fq12 &f, const G1Aff &P, const G2Aff &Q) {
  f = F12ONE;
  if (P.inf || Q.inf) return;
  G2Jac T;
  T.x = Q.x;
  T.y = Q.y;
  T.z = F2ONE;
  // MSB-first over bits of BLS_X below the top bit.
  int top = 63;
  while (!((BLS_X >> top) & 1)) top--;
  for (int i = top - 1; i >= 0; i--) {
    // --- doubling step: tangent line at T, then T = 2T (shares A, B, E) ---
    {
      Fq2 A, B, C, ZZ, D, E, F_, t;
      f2_sq(A, T.x);
      f2_sq(B, T.y);
      f2_sq(C, B);
      f2_sq(ZZ, T.z);
      f2_add(t, T.x, B);
      f2_sq(t, t);
      f2_sub(t, t, A);
      f2_sub(t, t, C);
      f2_dbl(D, t);
      f2_dbl(E, A);
      f2_add(E, E, A);  // 3 X^2
      f2_sq(F_, E);
      Fq2 x3, y3, z3;
      f2_dbl(t, D);
      f2_sub(x3, F_, t);
      f2_sub(t, D, x3);
      f2_mul(t, E, t);
      Fq2 c8;
      f2_dbl(c8, C);
      f2_dbl(c8, c8);
      f2_dbl(c8, c8);
      f2_sub(y3, t, c8);
      f2_mul(z3, T.y, T.z);
      f2_dbl(z3, z3);  // Z3 = 2 Y Z
      // line: a = yP * (Z3 * ZZ);  b = -xP * (E * ZZ);  c = X*E - 2B
      Fq2 la, lb, lc;
      f2_mul(t, z3, ZZ);
      f2_scal(la, t, P.y);
      f2_mul(t, E, ZZ);
      f2_scal(lb, t, P.x);
      f2_neg(lb, lb);
      f2_mul(t, T.x, E);
      Fq2 twoB;
      f2_dbl(twoB, B);
      f2_sub(lc, t, twoB);
      T.x = x3;
      T.y = y3;
      T.z = z3;
      f12_sq(f, f);
      f12_mul_by_line(f, la, lb, lc);
    }
    if ((BLS_X >> i) & 1) {
      // --- addition step: line through T and Q, then T = T + Q ---
      Fq2 z1z1, u2, s2, theta, lam, t;
      f2_sq(z1z1, T.z);
      f2_mul(u2, Q.x, z1z1);
      f2_mul(t, T.z, z1z1);
      f2_mul(s2, Q.y, t);
      f2_sub(lam, u2, T.x);   // H = xQ Z^2 - X  ( = -lambda * Z^2 scaling)
      f2_sub(theta, s2, T.y); // r/2 = yQ Z^3 - Y
      // line through T(new)=T and Q scaled by 2*H*Z (see derivation in
      // docstring of the Python fallback): a = 2 H Z yP, b = -2 theta xP,
      // c = 2 theta xQ - 2 H Z yQ
      Fq2 HZ, la, lb, lc;
      f2_mul(HZ, lam, T.z);
      f2_dbl(HZ, HZ);  // 2 H Z
      f2_scal(la, HZ, P.y);
      Fq2 twoTheta;
      f2_dbl(twoTheta, theta);
      f2_scal(lb, twoTheta, P.x);
      f2_neg(lb, lb);
      f2_mul(t, twoTheta, Q.x);
      Fq2 hzy;
      f2_mul(hzy, HZ, Q.y);
      f2_sub(lc, t, hzy);
      f12_mul_by_line(f, la, lb, lc);
      // point: madd with H = lam, r = 2 theta
      Fq2 hh, i2, j, r, v;
      f2_sq(hh, lam);
      f2_dbl(i2, hh);
      f2_dbl(i2, i2);
      f2_mul(j, lam, i2);
      f2_dbl(r, theta);
      f2_mul(v, T.x, i2);
      Fq2 x3, y3, z3;
      f2_sq(x3, r);
      f2_sub(x3, x3, j);
      f2_sub(x3, x3, v);
      f2_sub(x3, x3, v);
      f2_sub(t, v, x3);
      f2_mul(t, r, t);
      f2_mul(y3, T.y, j);
      f2_dbl(y3, y3);
      f2_sub(y3, t, y3);
      f2_add(z3, T.z, lam);
      f2_sq(z3, z3);
      f2_sub(z3, z3, z1z1);
      f2_sub(z3, z3, hh);
      T.x = x3;
      T.y = y3;
      T.z = z3;
    }
  }
}

// ------------------------------------------------------ final exponent ----
static void f12_pow_u64(Fq12 &o, const Fq12 &a, u64 e) {
  Fq12 acc = F12ONE;
  int top = 63;
  while (top >= 0 && !((e >> top) & 1)) top--;
  for (int i = top; i >= 0; i--) {
    f12_sq(acc, acc);
    if ((e >> i) & 1) f12_mul(acc, acc, a);
  }
  if (top < 0) acc = F12ONE;
  o = acc;
}

static void f12_pow_limbs(Fq12 &o, const Fq12 &a, const u64 *e, int nlimbs) {
  Fq12 acc = F12ONE;
  Fq12 base = a;
  for (int i = 0; i < nlimbs; i++) {
    u64 bits = e[i];
    for (int j = 0; j < 64; j++) {
      if (bits & 1) f12_mul(acc, acc, base);
      f12_sq(base, base);
      bits >>= 1;
    }
  }
  o = acc;
}

// 3^-1 mod r: correction exponent turning m^(3*hard) into m^hard inside the
// order-r image of the final exponentiation.
static const u64 INV3_MOD_R[4] = {0xb161000000000001ULL, 0xe671a4a9e0000000ULL,
                                  0x95cd88bee8252000ULL, 0x0c72439466c86e39ULL};

// m -> m^((q^6-1)(q^2+1) * 3*(q^4-q^2+1)/r).
// Hard part uses (x-1)^2 (x+p) (x^2+p^2-1) + 3 == 3*(p^4-p^2+1)/r
// (verified numerically for BLS12-377's x; Hayashida–Hayasaka–Teruya chain).
static void final_exp_times3(Fq12 &o, const Fq12 &f) {
  // easy part: f^(q^6-1) = conj(f) * f^-1; then ^(q^2+1)
  Fq12 inv, m, t;
  f12_inv(inv, f);
  f12_conj(m, f);
  f12_mul(m, m, inv);
  f12_frob(t, m);
  f12_frob(t, t);
  f12_mul(m, t, m);
  // hard part (elements now lie in the cyclotomic subgroup; inverse = conj)
  Fq12 t0, t1, t2, t3, t4, t5, res;
  f12_pow_u64(t0, m, BLS_X - 1);
  f12_pow_u64(t0, t0, BLS_X - 1);  // m^((x-1)^2)
  f12_pow_u64(t1, t0, BLS_X);
  f12_frob(t2, t0);
  f12_mul(t1, t1, t2);  // t0^(x+p)
  f12_pow_u64(t3, t1, BLS_X);
  f12_pow_u64(t3, t3, BLS_X);  // t1^(x^2)
  f12_frob(t4, t1);
  f12_frob(t4, t4);     // t1^(p^2)
  f12_conj(t5, t1);     // t1^-1
  f12_mul(res, t3, t4);
  f12_mul(res, res, t5);  // t1^(x^2+p^2-1)
  f12_sq(t, m);
  f12_mul(t, t, m);  // m^3
  f12_mul(o, res, t);
}

// ------------------------------------------------------------- C ABI ------
// The constants are set exactly once, by the first caller, while any other
// caller waits (a function-local static's initialisation is thread-safe in
// C++11): ctypes releases the GIL, so the node's executor threads enter the
// entry points at once, and a second initialisation would re-zero F2ONE,
// F12ONE and TWIST_B under a thread already computing with them.
static void set_consts() {
  std::memset(&F2ZERO, 0, sizeof F2ZERO);
  std::memset(&F2ONE, 0, sizeof F2ONE);
  std::memcpy(F2ONE.c0.v, FQ_ONE_MONT, sizeof F2ONE.c0.v);
  std::memset(&F12ONE, 0, sizeof F12ONE);
  F12ONE.c0.c0 = F2ONE;
  // twist b' = (0, B1), B1 canonical from snarkos_tpu_torch/crypto/params.py
  static const u64 B1_CANON[6] = {
      0x1c9ed9999999999aULL, 0x0dd39e5c1ccccccdULL, 0x129207b63c6bf800ULL,
      0xdc7b4f91cd5fd889ULL, 0x43bd03737460c589ULL, 0x010222f6db0fd6f3ULL};
  std::memset(&TWIST_B, 0, sizeof TWIST_B);
  fq_from_canonical(TWIST_B.c1, B1_CANON);
  // gamma12 = u^((q-1)/6)
  u64 e[6];
  {
    // (q - 1) / 6 over limbs (q - 1: low limb ends in ...0000, no borrow)
    u64 qm1[6];
    std::memcpy(qm1, FQ_Q, sizeof qm1);
    qm1[0] -= 1;
    u64 rem = 0;
    for (int i = 5; i >= 0; i--) {
      u128 cur = ((u128)rem << 64) | qm1[i];
      e[i] = (u64)(cur / 6);
      rem = (u64)(cur % 6);
    }
  }
  Fq2 u_elem;
  std::memset(&u_elem, 0, sizeof u_elem);
  std::memcpy(u_elem.c1.v, FQ_ONE_MONT, sizeof u_elem.c1.v);
  f2_pow_limbs(GAMMA12, u_elem, e, 6);
  f2_sq(GAMMA61, GAMMA12);
  f2_sq(GAMMA62, GAMMA61);
}

static void init_consts() {
  static const bool done = (set_consts(), true);
  (void)done;
}

static bool load_g1(G1Aff &p, const uint8_t *xy96) {
  u64 acc = 0;
  for (int i = 0; i < 96; i++) acc |= xy96[i];
  if (acc == 0) {
    p.inf = true;
    return true;
  }
  p.inf = false;
  fq_load_le48(p.x, xy96);
  fq_load_le48(p.y, xy96 + 48);
  return g1_on_curve(p);
}

static bool load_g2(G2Aff &p, const uint8_t *xy192) {
  u64 acc = 0;
  for (int i = 0; i < 192; i++) acc |= xy192[i];
  if (acc == 0) {
    p.inf = true;
    return true;
  }
  p.inf = false;
  fq_load_le48(p.x.c0, xy192);
  fq_load_le48(p.x.c1, xy192 + 48);
  fq_load_le48(p.y.c0, xy192 + 96);
  fq_load_le48(p.y.c1, xy192 + 144);
  return g2_on_curve(p);
}

static void miller_product(Fq12 &f, const uint8_t *g1_xy, const uint8_t *g2_xy,
                           long n, bool &ok) {
  f = F12ONE;
  ok = true;
  for (long i = 0; i < n; i++) {
    G1Aff P;
    G2Aff Q;
    if (!load_g1(P, g1_xy + 96 * i) || !load_g2(Q, g2_xy + 192 * i)) {
      ok = false;
      return;
    }
    Fq12 mi;
    miller_loop(mi, P, Q);
    f12_mul(f, f, mi);
  }
}

extern "C" {

// prod_i e(P_i, Q_i), exact reduced pairing value. Output: flat basis
// c0..c5 over Fq2 (c_i = coefficient of w^i), each as 48-byte LE (re, im).
int pairing377_multi(const uint8_t *g1_xy, const uint8_t *g2_xy, long n,
                     uint8_t *out1152) {
  init_consts();
  Fq12 f;
  bool ok;
  miller_product(f, g1_xy, g2_xy, n, ok);
  if (!ok) return -1;
  Fq12 v, exact;
  final_exp_times3(v, f);
  f12_pow_limbs(exact, v, INV3_MOD_R, 4);
  // nested -> flat: c0=a.c0.c0 c1=a.c1.c0 c2=a.c0.c1 c3=a.c1.c1 c4=a.c0.c2 c5=a.c1.c2
  const Fq2 *flat[6] = {&exact.c0.c0, &exact.c1.c0, &exact.c0.c1,
                        &exact.c1.c1, &exact.c0.c2, &exact.c1.c2};
  for (int i = 0; i < 6; i++) {
    fq_store_le48(out1152 + i * 96, flat[i]->c0);
    fq_store_le48(out1152 + i * 96 + 48, flat[i]->c1);
  }
  return 0;
}

// 1 if prod_i e(P_i, Q_i) == 1 else 0; -1 on malformed input.
// Skips the cube-root correction (bijective on the order-r image).
int pairing377_check(const uint8_t *g1_xy, const uint8_t *g2_xy, long n) {
  init_consts();
  Fq12 f;
  bool ok;
  miller_product(f, g1_xy, g2_xy, n, ok);
  if (!ok) return -1;
  Fq12 v;
  final_exp_times3(v, f);
  return f12_eq(v, F12ONE) ? 1 : 0;
}

// k * Q on E'(Fq2), affine in / affine out (all-zero = infinity).
int g2_scalar_mul377(const uint8_t *scalar_le32, const uint8_t *g2_xy,
                     uint8_t *out192) {
  init_consts();
  G2Aff q;
  if (!load_g2(q, g2_xy)) return -1;
  u64 k[4];
  for (int i = 0; i < 4; i++) {
    u64 v = 0;
    for (int b = 7; b >= 0; b--) v = (v << 8) | scalar_le32[i * 8 + b];
    k[i] = v;
  }
  G2Jac acc;
  acc.x = F2ONE;
  acc.y = F2ONE;
  acc.z = F2ZERO;
  if (!q.inf) {
    // plain MSB-first double-and-add; double/madd handle infinity.
    for (int limb = 3; limb >= 0; limb--) {
      for (int bit = 63; bit >= 0; bit--) {
        g2_double(acc, acc);
        if ((k[limb] >> bit) & 1) g2_madd(acc, acc, q.x, q.y);
      }
    }
  }
  if (f2_is_zero(acc.z)) {
    std::memset(out192, 0, 192);
    return 0;
  }
  Fq2 zinv, zinv2, zinv3, ax, ay;
  f2_inv(zinv, acc.z);
  f2_sq(zinv2, zinv);
  f2_mul(zinv3, zinv2, zinv);
  f2_mul(ax, acc.x, zinv2);
  f2_mul(ay, acc.y, zinv3);
  fq_store_le48(out192, ax.c0);
  fq_store_le48(out192 + 48, ax.c1);
  fq_store_le48(out192 + 96, ay.c0);
  fq_store_le48(out192 + 144, ay.c1);
  return 0;
}

}  // extern "C"
