// BLS12-377 G1 in Jacobian coordinates over Fq, one point per thread.
//
// The formulas are those of the JAX package's ops/g1.py (double_impl,
// add_impl, madd_impl, madd_incomplete_impl), field op for field op, with the
// same special cases:
// the doubling when P == Q, Z := 0 (X, Y kept) when P == -Q, and the other
// operand passed through when one is the identity (Z == 0). Every field op
// returns canonical values, so a kernel built from these gives the same limbs
// as the JAX package and as the plain PyTorch versions (ops/g1.py here).
// Where the JAX code computes a branch and selects, these functions branch
// per thread and compute only what is selected; the result is the same.
#pragma once

#include "field.cuh"

namespace snark {

struct Jac {
    uint32_t x[12], y[12], z[12];
};

__device__ __forceinline__ void load_point(Jac& p, const int32_t* x, const int32_t* y,
                                           const int32_t* z, int64_t n, int64_t e) {
    load<Fq>(p.x, x, n, e);
    load<Fq>(p.y, y, n, e);
    load<Fq>(p.z, z, n, e);
}

__device__ __forceinline__ void store_point(int32_t* x, int32_t* y, int32_t* z,
                                            const Jac& p, int64_t n, int64_t e) {
    store<Fq>(x, p.x, n, e);
    store<Fq>(y, p.y, n, e);
    store<Fq>(z, p.z, n, e);
}

// dbl-2009-l (a = 0); the identity doubles to Z = 0.
__device__ __forceinline__ void g1_double(Jac& o, const Jac& p) {
    uint32_t A[12], B[12], C[12], D[12], E[12], F[12], t[12];
    sqr<Fq>(A, p.x);
    sqr<Fq>(B, p.y);
    sqr<Fq>(C, B);
    add<Fq>(t, p.x, B);
    sqr<Fq>(D, t);
    sub<Fq>(D, D, A);
    sub<Fq>(D, D, C);
    dbl<Fq>(D, D);
    mul3<Fq>(E, A);
    sqr<Fq>(F, E);
    dbl<Fq>(t, D);
    sub<Fq>(o.x, F, t);                 // x3 = F - 2D
    sub<Fq>(t, D, o.x);
    mont_mul<Fq>(t, E, t);              // E (D - x3)
    mul8<Fq>(C, C);
    sub<Fq>(o.y, t, C);                 // y3 = E (D - x3) - 8C
    mont_mul<Fq>(t, p.y, p.z);
    dbl<Fq>(o.z, t);                    // z3 = 2 y z
}

// Complete Jacobian addition: add-2007-bl plus the special cases of
// g1.add_impl. o may not alias p or q.
__device__ __forceinline__ void g1_add(Jac& o, const Jac& p, const Jac& q) {
    const bool p_inf = is_zero<Fq>(p.z);
    const bool q_inf = is_zero<Fq>(q.z);
    uint32_t z1z1[12], z2z2[12], u1[12], u2[12], s1[12], s2[12];
    uint32_t h[12], rr[12], i[12], j[12], v[12], t[12];
    sqr<Fq>(z1z1, p.z);
    sqr<Fq>(z2z2, q.z);
    mont_mul<Fq>(u1, p.x, z2z2);
    mont_mul<Fq>(u2, q.x, z1z1);
    mont_mul<Fq>(t, p.y, q.z);
    mont_mul<Fq>(s1, t, z2z2);
    mont_mul<Fq>(t, q.y, p.z);
    mont_mul<Fq>(s2, t, z1z1);
    const bool x_eq = eq<Fq>(u1, u2);
    const bool y_eq = eq<Fq>(s1, s2);

    sub<Fq>(h, u2, u1);
    sub<Fq>(rr, s2, s1);
    dbl<Fq>(rr, rr);
    dbl<Fq>(t, h);
    sqr<Fq>(i, t);                      // i = (2h)^2
    mont_mul<Fq>(j, h, i);
    mont_mul<Fq>(v, u1, i);
    sqr<Fq>(t, rr);
    sub<Fq>(t, t, j);
    dbl<Fq>(o.x, v);
    sub<Fq>(o.x, t, o.x);               // x3 = rr^2 - j - 2v
    sub<Fq>(t, v, o.x);
    mont_mul<Fq>(t, rr, t);
    mont_mul<Fq>(j, s1, j);
    dbl<Fq>(j, j);
    sub<Fq>(o.y, t, j);                 // y3 = rr (v - x3) - 2 s1 j
    add<Fq>(t, p.z, q.z);
    sqr<Fq>(t, t);
    sub<Fq>(t, t, z1z1);
    sub<Fq>(t, t, z2z2);
    mont_mul<Fq>(o.z, t, h);            // z3 = ((z1 + z2)^2 - z1z1 - z2z2) h

    const bool both_finite = !p_inf && !q_inf;
    if (both_finite && x_eq && y_eq) g1_double(o, p);
    if (both_finite && x_eq && !y_eq) {
#pragma unroll
        for (int k = 0; k < 12; ++k) o.z[k] = 0;
    }
    if (q_inf) o = p;
    if (p_inf) o = q;
}

// Complete mixed addition: Jacobian p + affine (qx, qy), madd-2007-bl plus
// the doubling branch 2 (qx, qy) (dbl-2009-alnr) of g1.madd_impl. The
// affine operand is a curve point, never the identity. o may not alias p.
__device__ __forceinline__ void g1_madd(Jac& o, const Jac& p, const uint32_t* qx,
                                        const uint32_t* qy) {
    const bool p_inf = is_zero<Fq>(p.z);
    uint32_t z1z1[12], u2[12], s2[12], h[12], rr[12], hh[12], i[12], t[12];
    sqr<Fq>(z1z1, p.z);
    mont_mul<Fq>(u2, qx, z1z1);
    mont_mul<Fq>(t, p.z, z1z1);
    mont_mul<Fq>(s2, qy, t);
    const bool x_eq = eq<Fq>(u2, p.x);
    const bool y_eq = eq<Fq>(s2, p.y);

    if (p_inf) {
        copy<Fq>(o.x, qx);
        copy<Fq>(o.y, qy);
#pragma unroll
        for (int k = 0; k < 12; ++k) o.z[k] = FQ_ONE[k];
        return;
    }
    if (x_eq && y_eq) {
        // 2 (qx, qy) from the affine coordinates
        uint32_t xx[12], em[12], yy[12], yyyy[12], s[12];
        sqr<Fq>(xx, qx);
        mul3<Fq>(em, xx);
        sqr<Fq>(yy, qy);
        sqr<Fq>(yyyy, yy);
        add<Fq>(t, qx, yy);
        sqr<Fq>(t, t);
        sub<Fq>(t, t, xx);
        sub<Fq>(t, t, yyyy);
        dbl<Fq>(s, t);
        sqr<Fq>(t, em);
        dbl<Fq>(xx, s);
        sub<Fq>(o.x, t, xx);            // dx3 = em^2 - 2s
        sub<Fq>(t, s, o.x);
        mont_mul<Fq>(t, em, t);
        mul8<Fq>(yyyy, yyyy);
        sub<Fq>(o.y, t, yyyy);          // dy3 = em (s - dx3) - 8 yyyy
        dbl<Fq>(o.z, qy);               // dz3 = 2 qy
        return;
    }
    sub<Fq>(h, u2, p.x);
    sub<Fq>(rr, s2, p.y);
    dbl<Fq>(rr, rr);
    sqr<Fq>(hh, h);
    mul4<Fq>(i, hh);
    uint32_t j[12], v[12];
    mont_mul<Fq>(j, h, i);
    mont_mul<Fq>(v, p.x, i);
    sqr<Fq>(t, rr);
    sub<Fq>(t, t, j);
    dbl<Fq>(o.x, v);
    sub<Fq>(o.x, t, o.x);               // x3 = rr^2 - j - 2v
    sub<Fq>(t, v, o.x);
    mont_mul<Fq>(t, rr, t);
    mont_mul<Fq>(j, p.y, j);
    dbl<Fq>(j, j);
    sub<Fq>(o.y, t, j);                 // y3 = rr (v - x3) - 2 y j
    add<Fq>(t, p.z, h);
    sqr<Fq>(t, t);
    sub<Fq>(t, t, z1z1);
    sub<Fq>(o.z, t, hh);                // z3 = (z + h)^2 - z1z1 - hh
    if (x_eq) {                          // P == -Q: Z = 0, X and Y kept
#pragma unroll
        for (int k = 0; k < 12; ++k) o.z[k] = 0;
    }
}

// Incomplete mixed addition (g1.madd_incomplete_impl): the generic
// madd-2007-bl path only, 11 Fq multiplies. Returns true where P == +-Q with P
// finite (u2 == X1); o then holds the generic formula's value, garbage with
// Z = 0 exactly (h = 0), as in the JAX package. o may not alias p.
__device__ __forceinline__ bool g1_madd_incomplete(Jac& o, const Jac& p, const uint32_t* qx,
                                                   const uint32_t* qy) {
    if (is_zero<Fq>(p.z)) {
        copy<Fq>(o.x, qx);
        copy<Fq>(o.y, qy);
#pragma unroll
        for (int k = 0; k < 12; ++k) o.z[k] = FQ_ONE[k];
        return false;
    }
    uint32_t z1z1[12], u2[12], s2[12], h[12], rr[12], hh[12], i[12], t[12];
    sqr<Fq>(z1z1, p.z);
    mont_mul<Fq>(u2, qx, z1z1);
    mont_mul<Fq>(t, p.z, z1z1);
    mont_mul<Fq>(s2, qy, t);
    const bool exc = eq<Fq>(u2, p.x);
    sub<Fq>(h, u2, p.x);
    sub<Fq>(rr, s2, p.y);
    dbl<Fq>(rr, rr);
    sqr<Fq>(hh, h);
    mul4<Fq>(i, hh);
    uint32_t j[12], v[12];
    mont_mul<Fq>(j, h, i);
    mont_mul<Fq>(v, p.x, i);
    sqr<Fq>(t, rr);
    sub<Fq>(t, t, j);
    dbl<Fq>(o.x, v);
    sub<Fq>(o.x, t, o.x);               // x3 = rr^2 - j - 2v
    sub<Fq>(t, v, o.x);
    mont_mul<Fq>(t, rr, t);
    mont_mul<Fq>(j, p.y, j);
    dbl<Fq>(j, j);
    sub<Fq>(o.y, t, j);                 // y3 = rr (v - x3) - 2 y j
    add<Fq>(t, p.z, h);
    sqr<Fq>(t, t);
    sub<Fq>(t, t, z1z1);
    sub<Fq>(o.z, t, hh);                // z3 = (z + h)^2 - z1z1 - hh
    return exc;
}

}  // namespace snark
