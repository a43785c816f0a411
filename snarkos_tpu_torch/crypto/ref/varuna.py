"""Varuna-style holographic AHP zkSNARK over KZG (the port's own copy of
``snarkos_tpu/crypto/ref/varuna.py``).

The reference node verifies a full Varuna (Marlin-family) proof inside
snarkVM on every gossiped transaction
(node/bft/ledger-service/src/ledger.rs:318-343). This
module implements that capability: a Marlin-style
algebraic holographic proof for R1CS over the BLS12-377 KZG commitment
scheme with a Poseidon-sponge Fiat-Shamir transcript:

  index    commit row/col/val interpolations per matrix (circuit setup)
  round 1  commit w_hat, z_A, z_B, z_C (hiding masks)  -> alpha, eta_A/B/C
  round 2  commit h_0 (rowcheck quotient), g_1, s_1
           (shifted degree-bound shadow), h_1          -> beta
  round 3  send sigma_M; commit g_2/h_2/s_2 per matrix -> delta
           (the holographic matrix sumcheck over K)
  openings 8 polynomials at beta, 18 at delta          -> xi
  batch    TWO xi-combined KZG witnesses (one per point; the final
           pairing check batches both into one 2-pairing product)

Checked identities:
  rowcheck   z_A z_B - z_C = h_0 * v_H                       (at beta)
  lincheck   r(alpha,beta) * sum_M eta_M z_M(beta)
               - rm(alpha,beta) * z(beta)
               = h_1(beta) v_H(beta) + beta g_1(beta)        (at beta)
  input      z(beta) = w_hat(beta) * v_I(beta) + x_hat(beta)
  matrix     rm(alpha,beta) = v_H(alpha) v_H(beta) / n * sum_M eta_M sigma_M,
             each sigma_M certified by a rational sumcheck over K:
               val_M(delta) - (alpha-row_M(delta))(beta-col_M(delta))
                 * (sigma_M/|K| + delta g_2M(delta))
               = h_2M(delta) * v_K(delta)                    (at delta)
  degrees    s_1 = X^(D-(n-2)) g_1 and s_2M = X^(D-(|K|-2)) g_2M checked
             at beta/delta (enforces deg g_1 <= n-2, deg g_2 <= |K|-2)

Hiding: w_hat/z_A/z_B/z_C carry random multiples of the vanishing
polynomial (degree-1 mask coefficients), so the single opened evaluation
of each witness-carrying polynomial leaks nothing (Marlin bounded-
independence zk); the masks vanish on H, leaving every identity intact.

The polynomial arithmetic and the transcript run on the host. Every
commitment goes through ``commit_fn`` where one is given (``prove``,
``get_index``): the node passes the device commitment over its SRS's powers
(``node/ledger.py``, ``ops/kzg.commit``); without one it is the plain host
``kzg.commit``. Points enter the transcript and the proof bytes in affine
form only, so a device MSM's Jacobian representative changes neither.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from snarkos_tpu_torch.crypto import params
from snarkos_tpu_torch.crypto.ref import g1, kzg, ntt, poseidon
from snarkos_tpu_torch.crypto.ref.r1cs import R1CS

R = params.FR_MODULUS

FS_DOMAIN = "snarkos_tpu.varuna.fs"
MASK_DOMAIN = b"snarkos_tpu.varuna.mask"


# --------------------------------------------------------------------------
# polynomial helpers (coefficient vectors, low-order first)
# --------------------------------------------------------------------------


def _interp(evals: list[int]) -> list[int]:
    """Coefficients of the degree-<n interpolation over H (iNTT)."""
    return ntt.ntt(list(evals), invert=True)


def _eval_domain(coeffs: list[int], size: int) -> list[int]:
    """Evaluations over the size-``size`` subgroup (zero-padded NTT)."""
    return ntt.ntt(list(coeffs) + [0] * (size - len(coeffs)))


def _poly_mul(a: list[int], b: list[int]) -> list[int]:
    n = 1
    while n < len(a) + len(b) - 1:
        n *= 2
    fa = _eval_domain(a, n)
    fb = _eval_domain(b, n)
    return ntt.ntt([x * y % R for x, y in zip(fa, fb)], invert=True)[: len(a) + len(b) - 1]


def _divmod_vanishing(p: list[int], n: int) -> tuple[list[int], list[int]]:
    """Divide p by v = X^n - 1: (quotient, remainder). deg p < 2n req'd not."""
    p = list(p)
    q = [0] * max(0, len(p) - n)
    for i in range(len(p) - 1, n - 1, -1):
        c = p[i] % R
        if c:
            q[i - n] = c
            p[i] = 0
            p[i - n] = (p[i - n] + c) % R
    return q, [x % R for x in p[:n]]


def _batch_inverse(xs: list[int]) -> list[int]:
    """Montgomery batch inversion: one pow, 3(n-1) muls."""
    prefix = [1] * (len(xs) + 1)
    for i, x in enumerate(xs):
        prefix[i + 1] = prefix[i] * x % R
    inv = pow(prefix[-1], -1, R)
    out = [0] * len(xs)
    for i in range(len(xs) - 1, -1, -1):
        out[i] = prefix[i] * inv % R
        inv = inv * xs[i] % R
    return out


def _div_vanishing_exact(p: list[int], n: int) -> list[int]:
    q, rem = _divmod_vanishing(p, n)
    assert all(x == 0 for x in rem), "not divisible by v_H"
    return q


def _add_vanishing_mask(coeffs: list[int], mask: list[int], n: int) -> list[int]:
    """coeffs + mask(X) * (X^n - 1): hides openings, vanishes on H."""
    out = list(coeffs) + [0] * max(0, n + len(mask) - len(coeffs))
    for i, m in enumerate(mask):
        out[n + i] = (out[n + i] + m) % R
        out[i] = (out[i] - m) % R
    return out


def _next_pow2(x: int) -> int:
    return 1 << max(x - 1, 1).bit_length()


# --------------------------------------------------------------------------
# Fiat-Shamir transcript (Poseidon sponge)
# --------------------------------------------------------------------------


class Transcript:
    """Poseidon-sponge transcript; commitments absorbed as affine coords."""

    def __init__(self):
        self.items: list[int] = []

    def absorb_field(self, x: int) -> None:
        self.items.append(x % R)

    def absorb_point(self, p) -> None:
        a = g1.affine(p)
        if a is None:
            self.items.extend([0, 0, 1])
        else:
            # Fq coords folded into Fr by split absorption (lo/hi 192 bits):
            # collision-free injection of the 377-bit coordinate
            for c in a:
                self.items.append(c & ((1 << 192) - 1))
                self.items.append(c >> 192)
            self.items.append(0)

    def challenge(self, label: str) -> int:
        out = poseidon.hash1(
            self.items + [poseidon._domain_to_field(label)], rate=2, domain=FS_DOMAIN
        )
        self.items.append(out)
        return out


# --------------------------------------------------------------------------
# the index (holographic circuit encoding; Marlin's "indexer")
# --------------------------------------------------------------------------


@dataclass
class Index:
    """Per-circuit commitments to the matrix polynomials. For each matrix
    M in (A, B, C), entry kappa=(i,j) of M contributes
    (row, col, val) = (omega^i, omega^j, M_ij * omega^j) over the entry
    domain K, so that

      r_M(alpha,beta) = v_H(alpha) v_H(beta) / n
                        * sum_K val(kappa) / ((alpha-row(kappa))(beta-col(kappa)))

    — the verifier never touches the O(nnz) matrices; it checks a rational
    sumcheck against these commitments (the third Varuna sumcheck)."""

    n: int
    k_size: int
    row_polys: list  # 3 coeff vectors over K (A, B, C)
    col_polys: list
    val_polys: list
    commitments: list  # 9 points: row_A, col_A, val_A, row_B, ..., val_C


def required_srs_degree(cs: R1CS) -> int:
    """Minimum SRS degree D for this circuit: the largest committed
    polynomial is h_2 (deg <= 2|K|-3); the shifted shadows have degree
    exactly D by construction."""
    nnz = max(sum(len(lc) for lc in rows)
              for rows in (cs.rows_a, cs.rows_b, cs.rows_c))
    k = _next_pow2(nnz)
    return max(2 * k, cs.n + 4)


_INDEX_CACHE: dict = {}


def srs_tag(srs: kzg.SRS) -> bytes:
    """Content key of an SRS: sha256 of its length and the affine tau G and
    last power (tau G fixes every power of a powers-of-tau SRS)."""
    h = hashlib.sha256(len(srs.powers_g1).to_bytes(8, "little"))
    for p in (srs.powers_g1[1 % len(srs.powers_g1)], srs.powers_g1[-1]):
        a = g1.affine(p)
        h.update(b"\x01" * 97 if a is None else
                 a[0].to_bytes(48, "little") + a[1].to_bytes(48, "little") + b"\x00")
    return h.digest()


def get_index(srs: kzg.SRS, cs: R1CS, commit_fn=None) -> Index:
    """The circuit's index over ``srs``, cached by content (``srs_tag`` and
    ``R1CS.digest``), never by object identity. ``commit_fn`` (coeffs ->
    point) makes the 9 commitments of an index not yet cached."""
    key = (srs_tag(srs), cs.digest())
    idx = _INDEX_CACHE.get(key)
    if idx is None:
        idx = index_circuit(srs, cs, commit_fn)
        if len(_INDEX_CACHE) > 32:
            _INDEX_CACHE.clear()
        _INDEX_CACHE[key] = idx
    return idx


def index_circuit(srs: kzg.SRS, cs: R1CS, commit_fn=None) -> Index:
    commit = commit_fn or (lambda coeffs: kzg.commit(srs, coeffs))
    n = cs.n
    dom = _domain(n)
    all_rows = (cs.rows_a, cs.rows_b, cs.rows_c)
    k_size = _next_pow2(max(sum(len(lc) for lc in rows) for rows in all_rows))
    row_polys, col_polys, val_polys, commitments = [], [], [], []
    for rows in all_rows:
        row_e, col_e, val_e = [], [], []
        for i, lc in enumerate(rows):
            for j, v in lc.items():
                row_e.append(dom[i])
                col_e.append(dom[j])
                val_e.append(v * dom[j] % R)
        pad = k_size - len(row_e)
        row_e += [1] * pad
        col_e += [1] * pad
        val_e += [0] * pad
        rp = ntt.ntt(row_e, invert=True)
        cp = ntt.ntt(col_e, invert=True)
        vp = ntt.ntt(val_e, invert=True)
        row_polys.append(rp)
        col_polys.append(cp)
        val_polys.append(vp)
        commitments += [commit(rp), commit(cp), commit(vp)]
    return Index(n=n, k_size=k_size, row_polys=row_polys, col_polys=col_polys,
                 val_polys=val_polys, commitments=commitments)


# --------------------------------------------------------------------------
# the proof
# --------------------------------------------------------------------------

# commitment layout (proof.commitments):
#   0..3  c_w, c_zA, c_zB, c_zC                 (round 1)
#   4..7  c_h0, c_g1, c_s1, c_h1                (round 2)
#   8..16 per matrix M in (A,B,C): c_g2M, c_h2M, c_s2M   (round 3)
# evaluation layout (proof.evals):
#   0..7  w, zA, zB, zC, h0, g1, s1, h1 at beta
#   8..25 per matrix M: row_M, col_M, val_M, g2M, h2M, s2M at delta
_N_BETA = 8
_N_DELTA = 18


@dataclass
class VarunaProof:
    commitments: list  # 17 Jacobian points (layout above)
    sigmas: list  # 3 field elements (matrix sumcheck claims)
    evals: list  # 26 field elements (8 at beta + 18 at delta)
    witness_beta: tuple  # KZG witness for the xi-combined opening at beta
    witness_delta: tuple  # ... at delta

    def serialize(self) -> bytes:
        from snarkos_tpu_torch.node.codec import Writer

        w = Writer()
        for c in self.commitments:
            _write_point(w, c)
        for s in self.sigmas:
            w.field(s)
        for y in self.evals:
            w.field(y)
        _write_point(w, self.witness_beta)
        _write_point(w, self.witness_delta)
        return w.out()

    @classmethod
    def deserialize(cls, data: bytes) -> "VarunaProof":
        from snarkos_tpu_torch.node.codec import Reader

        r = Reader(data)
        commitments = [_read_point(r) for _ in range(17)]
        sigmas = [r.field() for _ in range(3)]
        evals = [r.field() for _ in range(_N_BETA + _N_DELTA)]
        wb = _read_point(r)
        wd = _read_point(r)
        return cls(commitments, sigmas, evals, wb, wd)


def _write_point(w, p) -> None:
    a = g1.affine(p)
    if a is None:
        w.raw(bytes(48) + bytes(48) + b"\x01")
    else:
        w.raw(a[0].to_bytes(48, "little") + a[1].to_bytes(48, "little") + b"\x00")


def _read_point(r):
    x = int.from_bytes(r.take(48), "little")
    y = int.from_bytes(r.take(48), "little")
    inf = r.take(1)[0]
    if inf:
        return g1.INFINITY
    if x >= params.FQ_MODULUS or y >= params.FQ_MODULUS:
        raise ValueError("non-canonical G1 coordinate")
    pt = g1.from_affine((x, y))
    if not g1.on_curve(pt):
        raise ValueError("point not on curve")
    return pt


def _x_hat_coeffs(cs: R1CS, public: list[int]) -> list[int]:
    """Interpolation of the public inputs over I (size l, root omega^(n/l))."""
    l = cs.num_public
    # iNTT over the size-l subgroup
    coeffs = ntt.ntt(list(public), invert=True) if l > 1 else list(public)
    return coeffs


def _domain(n: int) -> list[int]:
    w = ntt.root_of_unity(n)
    out = [1] * n
    for i in range(1, n):
        out[i] = out[i - 1] * w % R
    return out


def _shift_poly(p: list[int], shift: int) -> list[int]:
    return [0] * shift + list(p)


def _mask_coeffs(seed: bytes, label: bytes, count: int = 2) -> list[int]:
    out = []
    for i in range(count):
        h = hashlib.sha256(MASK_DOMAIN + label + i.to_bytes(2, "little") + seed).digest()
        out.append(int.from_bytes(h, "little") % R)
    return out


def prove(srs: kzg.SRS, cs: R1CS, z: list[int], commit_fn=None,
          mask_seed: bytes | None = None) -> VarunaProof:
    """AHP prover. z: full assignment over H (satisfying). commit_fn:
    the MSM of every commitment, the index's included (coeffs -> point);
    defaults to the host ``kzg.commit``. mask_seed: hiding randomness
    (os.urandom if None; pass a secret-derived seed for deterministic
    proofs, e.g. the dev genesis)."""
    import os as _os

    n = cs.n
    l = cs.num_public
    D = len(srs.powers_g1) - 1
    commit = commit_fn or (lambda coeffs: kzg.commit(srs, coeffs))
    index = get_index(srs, cs, commit)
    k_size = index.k_size
    seed = mask_seed if mask_seed is not None else _os.urandom(32)
    public = [z[cs.public(i)] for i in range(l)]

    # round 1: masked witness + matrix-image polynomials. Masks are random
    # multiples of the vanishing polynomial: all H-evaluations (hence every
    # identity and sum below) are unchanged, but the single opened value of
    # each polynomial is blinded (zk bounded independence).
    x_hat = _x_hat_coeffs(cs, public)
    z_hat = _interp(z)
    r_z = _mask_coeffs(seed, b"z")
    # z_hat' = z_hat + r_z v_H; w_hat' = (z_hat' - x_hat)/v_I
    #        = w_hat + r_z * (v_H/v_I), with v_H/v_I = sum_k X^(k l) (l | n)
    diff = [(a - (x_hat[i] if i < len(x_hat) else 0)) % R for i, a in enumerate(z_hat)]
    w_hat = _div_vanishing_exact(diff, l)
    w_hat = list(w_hat) + [0] * (n + 2 - l - len(w_hat))
    for k in range(n // l):
        for i, m in enumerate(r_z):
            w_hat[k * l + i] = (w_hat[k * l + i] + m) % R
    z_hat = _add_vanishing_mask(z_hat, r_z, n)
    za_e = cs.matvec(cs.rows_a, z)
    zb_e = cs.matvec(cs.rows_b, z)
    zc_e = cs.matvec(cs.rows_c, z)
    za = _add_vanishing_mask(_interp(za_e), _mask_coeffs(seed, b"a"), n)
    zb = _add_vanishing_mask(_interp(zb_e), _mask_coeffs(seed, b"b"), n)
    zc = _add_vanishing_mask(_interp(zc_e), _mask_coeffs(seed, b"c"), n)

    tr = Transcript()
    for c in index.commitments:  # bind the circuit
        tr.absorb_point(c)
    c_w, c_za, c_zb, c_zc = commit(w_hat), commit(za), commit(zb), commit(zc)
    for c in (c_w, c_za, c_zb, c_zc):
        tr.absorb_point(c)
    alpha = tr.challenge("alpha")
    etas = [tr.challenge("eta_a"), tr.challenge("eta_b"), tr.challenge("eta_c")]

    # round 2a: rowcheck quotient h_0 = (z_A z_B - z_C) / v_H
    prod = _poly_mul(za, zb)
    num = [(prod[i] if i < len(prod) else 0) - (zc[i] if i < len(zc) else 0)
           for i in range(max(len(prod), len(zc)))]
    h0 = _div_vanishing_exact([x % R for x in num], n)

    # round 2b: univariate sumcheck for the lincheck
    # r(alpha, X) = sum_i alpha^(n-1-i) X^i  (coeffs: powers of alpha reversed)
    apow = [1] * n
    for i in range(1, n):
        apow[i] = apow[i - 1] * alpha % R
    r_alpha = apow[::-1]
    # r_M(alpha, .) evals over H: (r^T M)_j with r_i = r(alpha, omega^i)
    dom = _domain(n)
    r_vec = [ntt.poly_eval(r_alpha, w) for w in dom]
    rm_evals = [0] * n
    for eta, rows in zip(etas, (cs.rows_a, cs.rows_b, cs.rows_c)):
        for i, lc in enumerate(rows):
            ri = r_vec[i] * eta % R
            if ri:
                for j, v in lc.items():
                    rm_evals[j] = (rm_evals[j] + ri * v) % R
    rm = _interp(rm_evals)
    # q_1 = r(alpha,X) * (sum eta_M z_M) - rm(X) * z_hat(X)
    zsum = [(etas[0] * (za[i] if i < len(za) else 0)
             + etas[1] * (zb[i] if i < len(zb) else 0)
             + etas[2] * (zc[i] if i < len(zc) else 0)) % R
            for i in range(max(len(za), len(zb), len(zc)))]
    q1a = _poly_mul(r_alpha, zsum)
    q1b = _poly_mul(rm, z_hat)
    q1 = [((q1a[i] if i < len(q1a) else 0) - (q1b[i] if i < len(q1b) else 0)) % R
          for i in range(max(len(q1a), len(q1b)))]
    h1, rem = _divmod_vanishing(q1, n)
    assert rem[0] == 0, "sumcheck constant term nonzero (unsatisfied system?)"
    g1_poly = rem[1:]
    while g1_poly and g1_poly[-1] == 0:
        g1_poly.pop()
    s1_poly = _shift_poly(g1_poly, D - (n - 2))  # degree-bound shadow

    c_h0, c_g1, c_s1, c_h1 = commit(h0), commit(g1_poly), commit(s1_poly), commit(h1)
    for c in (c_h0, c_g1, c_s1, c_h1):
        tr.absorb_point(c)
    beta = tr.challenge("beta")

    # round 3: holographic matrix sumcheck over K, per matrix:
    #   f(kappa) = val(kappa) / ((alpha - row(kappa)) (beta - col(kappa)))
    #   sigma_M  = sum_K f;   f_hat = sigma_M/|K| + X g_2M(X)
    #   val - (alpha-row)(beta-col) f_hat = h_2M v_K     (rational check)
    sigmas, g2_polys, h2_polys, s2_polys = [], [], [], []
    big = 4 * k_size
    for m_i in range(3):
        rp, cp, vp = index.row_polys[m_i], index.col_polys[m_i], index.val_polys[m_i]
        row_e = ntt.ntt(list(rp) + [0] * (k_size - len(rp)))
        col_e = ntt.ntt(list(cp) + [0] * (k_size - len(cp)))
        val_e = ntt.ntt(list(vp) + [0] * (k_size - len(vp)))
        denom = [((alpha - re) * (beta - ce)) % R for re, ce in zip(row_e, col_e)]
        f_e = [v * iv % R for v, iv in zip(val_e, _batch_inverse(denom))]
        f_hat = ntt.ntt(f_e, invert=True)
        sigma = f_hat[0] * k_size % R
        g2 = list(f_hat[1:])
        while g2 and g2[-1] == 0:
            g2.pop()
        # h2 over the 4K domain: p = val - (alpha-row)(beta-col) f_hat
        row_b = _eval_domain(rp, big)
        col_b = _eval_domain(cp, big)
        val_b = _eval_domain(vp, big)
        f_b = _eval_domain(f_hat, big)
        p_e = [(v - (alpha - r_) * (beta - c_) % R * fv) % R
               for v, r_, c_, fv in zip(val_b, row_b, col_b, f_b)]
        p_coeffs = ntt.ntt(p_e, invert=True)
        h2 = _div_vanishing_exact(p_coeffs, k_size)
        while h2 and h2[-1] == 0:
            h2.pop()
        sigmas.append(sigma)
        g2_polys.append(g2)
        h2_polys.append(h2)
        s2_polys.append(_shift_poly(g2, D - (k_size - 2)))
    r3_commits = []
    for m_i in range(3):
        r3_commits += [commit(g2_polys[m_i]), commit(h2_polys[m_i]),
                       commit(s2_polys[m_i])]
    for s in sigmas:
        tr.absorb_field(s)
    for c in r3_commits:
        tr.absorb_point(c)
    delta = tr.challenge("delta")

    # openings
    beta_polys = [w_hat, za, zb, zc, h0, g1_poly, s1_poly, h1]
    delta_polys = []
    for m_i in range(3):
        delta_polys += [index.row_polys[m_i], index.col_polys[m_i],
                        index.val_polys[m_i], g2_polys[m_i], h2_polys[m_i],
                        s2_polys[m_i]]
    evals = [ntt.poly_eval(p, beta) for p in beta_polys]
    evals += [ntt.poly_eval(p, delta) for p in delta_polys]
    for y in evals:
        tr.absorb_field(y)
    xi = tr.challenge("xi")

    # two batch witnesses: P_beta = sum xi^i p_i, P_delta = sum xi^(8+j) q_j
    def _combine(polys, start_pow):
        maxlen = max(len(p) for p in polys)
        combined = [0] * maxlen
        coeff = pow(xi, start_pow, R)
        for p in polys:
            for i, c in enumerate(p):
                combined[i] = (combined[i] + coeff * c) % R
            coeff = coeff * xi % R
        return combined

    _, wb = _kzg_open(srs, _combine(beta_polys, 0), beta, commit)
    _, wd = _kzg_open(srs, _combine(delta_polys, _N_BETA), delta, commit)
    return VarunaProof(
        [c_w, c_za, c_zb, c_zc, c_h0, c_g1, c_s1, c_h1, *r3_commits],
        sigmas, evals, wb, wd,
    )


def _kzg_open(srs, coeffs, zpt, commit):
    y = ntt.poly_eval(coeffs, zpt)
    q = [0] * (len(coeffs) - 1)
    carry = 0
    for i in range(len(coeffs) - 1, 0, -1):
        carry = (coeffs[i] + carry * zpt) % R
        q[i - 1] = carry
    return y, (commit(q) if q else g1.INFINITY)


def verify(srs: kzg.SRS, cs: R1CS, public: list[int], proof: VarunaProof,
           pairing_check=None) -> bool:
    """AHP verifier: recompute transcript, check every polynomial identity,
    batch-verify the two KZG openings (one 2-pairing product)."""
    openings = verify_prepare(cs, public, proof, srs=srs)
    if openings is None:
        return False
    if pairing_check is not None:
        return all(pairing_check(srs, *o) for o in openings)
    return kzg.batch_verify(srs, openings)


def verify_prepare(cs: R1CS, public: list[int], proof: VarunaProof,
                   srs: kzg.SRS | None = None, index: Index | None = None):
    """All pairing-free verifier work: transcript recomputation, rowcheck/
    lincheck at beta, the three rational matrix sumchecks at delta, and
    the degree-bound shadow checks. Returns the two (C, z, y, W) KZG
    openings for (batched) pairing verification, or None if any check
    fails. Lets the block path batch ALL transmissions' pairings into one
    multi-pairing (ops/kzg.batch_verify), like the puzzle path.

    The index (the verifying key: 9 matrix-polynomial commitments) is
    resolved from ``index`` or computed/cached from (srs, cs) by the host
    ``kzg.commit``; the node passes the one it indexed on its device."""
    n = cs.n
    l = cs.num_public
    if index is None:
        if srs is None:
            raise ValueError("verify_prepare needs srs or index")
        index = get_index(srs, cs)
    k_size = index.k_size
    D = (len(srs.powers_g1) - 1) if srs is not None else None
    if D is None:
        raise ValueError("verify_prepare needs srs for the degree bounds")
    if (len(proof.commitments) != 17 or len(proof.sigmas) != 3
            or len(proof.evals) != _N_BETA + _N_DELTA):
        return None
    tr = Transcript()
    for c in index.commitments:
        tr.absorb_point(c)
    for c in proof.commitments[:4]:
        tr.absorb_point(c)
    alpha = tr.challenge("alpha")
    etas = [tr.challenge("eta_a"), tr.challenge("eta_b"), tr.challenge("eta_c")]
    for c in proof.commitments[4:8]:
        tr.absorb_point(c)
    beta = tr.challenge("beta")
    for s in proof.sigmas:
        tr.absorb_field(s)
    for c in proof.commitments[8:]:
        tr.absorb_point(c)
    delta = tr.challenge("delta")
    for y in proof.evals:
        tr.absorb_field(y)
    xi = tr.challenge("xi")

    (y_w, y_za, y_zb, y_zc, y_h0, y_g1, y_s1, y_h1) = [
        y % R for y in proof.evals[:_N_BETA]]
    d_evals = [y % R for y in proof.evals[_N_BETA:]]
    v_h_beta = (pow(beta, n, R) - 1) % R
    v_i_beta = (pow(beta, l, R) - 1) % R
    # x_hat(beta) via iNTT coefficients of the public inputs (O(l))
    x_hat = _x_hat_coeffs(cs, [p % R for p in public])
    x_beta = ntt.poly_eval(x_hat, beta)
    z_beta = (y_w * v_i_beta + x_beta) % R

    # rowcheck at beta
    if (y_za * y_zb - y_zc) % R != y_h0 * v_h_beta % R:
        return None

    # degree-bound shadows: s_1 = X^(D-(n-2)) g_1 (whp over beta)
    if y_s1 != pow(beta, D - (n - 2), R) * y_g1 % R:
        return None

    # matrix sumchecks at delta (the holographic third sumcheck): for each
    # matrix, the committed rational identity certifies sigma_M = sum_K f
    if alpha == beta or beta == delta or alpha == delta:
        return None
    v_k_delta = (pow(delta, k_size, R) - 1) % R
    k_inv = pow(k_size, -1, R)
    shift_d = pow(delta, D - (k_size - 2), R)
    for m_i in range(3):
        y_row, y_col, y_val, y_g2, y_h2, y_s2 = d_evals[6 * m_i: 6 * m_i + 6]
        if y_s2 != shift_d * y_g2 % R:  # deg g_2 <= |K|-2
            return None
        f_delta = (proof.sigmas[m_i] * k_inv + delta * y_g2) % R
        lhs = (y_val - (alpha - y_row) * (beta - y_col) % R * f_delta) % R
        if lhs != y_h2 * v_k_delta % R:
            return None

    # lincheck at beta. r(alpha,beta) = (v_H(alpha)-v_H(beta))/(alpha-beta);
    # rm(alpha,beta) from the certified sigmas — O(1), no matrix access.
    v_h_alpha = (pow(alpha, n, R) - 1) % R
    r_ab = (v_h_alpha - v_h_beta) * pow(alpha - beta, -1, R) % R
    n_inv = pow(n, -1, R)
    sigma_sum = sum(eta * s % R for eta, s in zip(etas, proof.sigmas)) % R
    rm_ab = v_h_alpha * v_h_beta % R * n_inv % R * sigma_sum % R
    zsum_beta = (etas[0] * y_za + etas[1] * y_zb + etas[2] * y_zc) % R
    lhs = (r_ab * zsum_beta - rm_ab * z_beta) % R
    rhs = (y_h1 * v_h_beta + beta * y_g1) % R
    if lhs != rhs:
        return None

    # xi-combined openings: C_P = sum xi^i C_i, y_P = sum xi^i y_i
    beta_comms = [proof.commitments[i] for i in range(8)]
    delta_comms = []
    for m_i in range(3):
        delta_comms += [index.commitments[3 * m_i], index.commitments[3 * m_i + 1],
                        index.commitments[3 * m_i + 2],
                        proof.commitments[8 + 3 * m_i],
                        proof.commitments[8 + 3 * m_i + 1],
                        proof.commitments[8 + 3 * m_i + 2]]

    def _combine_comms(comms, ys, start_pow):
        # 8 and 18 points: a host loop of scalar multiplications
        coeffs = []
        y_p = 0
        coeff = pow(xi, start_pow, R)
        for y in ys:
            coeffs.append(coeff)
            y_p = (y_p + coeff * y) % R
            coeff = coeff * xi % R
        c_p = g1.INFINITY
        for k, c in zip(coeffs, comms):
            c_p = g1.add(c_p, g1.scalar_mul(k, c))
        return c_p, y_p

    c_b, y_b = _combine_comms(beta_comms, proof.evals[:_N_BETA], 0)
    c_d, y_d = _combine_comms(delta_comms, d_evals, _N_BETA)
    return [(c_b, beta, y_b, proof.witness_beta),
            (c_d, delta, y_d, proof.witness_delta)]
