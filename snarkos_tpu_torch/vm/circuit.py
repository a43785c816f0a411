"""R1CS synthesis of Aleo-instructions function bodies — execution proofs.

The reference verifies, on every gossiped transaction, Varuna proofs of
the actual function execution (snarkVM's synthesizer compiles each
function to a circuit; proofs are created at
cli/src/commands/developer/execute.rs:88 and verified via
node/bft/ledger-service/src/ledger.rs:319-341).  This
module is the framework's own circuit compiler: it walks a function's
instruction list symbolically, emitting R1CS constraints over Fr
(crypto/ref/r1cs.py) whose satisfying assignments are exactly the valid
register traces.  The same walk in *trace mode* (concrete arguments)
produces the witness.

Statement layout (public inputs, power-of-two padded):

    [0] 1
    [1] fid       Poseidon binding of "<program>/<function>"
    [2] caller    Poseidon binding of the caller address (0 = anonymous)
    [3] C_in      Poseidon commitment to ALL private inputs (record
                  members + .private literals, in declaration order,
                  plus a hiding blind); constrained to 0 when the
                  function has no private inputs
    [..] then, in INPUT declaration order:
           record input  -> its serial (public; in-circuit Poseidon of
                            the member wires — double-spend tag)
           .public input -> its value field
           .private input -> (no slot; witness wire absorbed into C_in)
    [..] finalize args (always public: the on-chain state transition)
    [..] then, in OUTPUT declaration order:
           future        -> (no slot; finalize args already bound)
           record output -> commitment C_rec = Poseidon(members, blind)
           .public output -> its value field
           .private output -> (no slot; absorbed into C_privout)
    [last allocated] C_privout  (0 when no private literal outputs)

ZK semantics: private inputs and outputs are WITNESS
wires — the verifier rebuilds only fid/caller/serials/public literals
from the payload and claimed outputs and learns nothing else beyond the
hiding Poseidon commitments. Record ownership is enforced in-circuit
(owner member == caller slot) and record serials are derived in-circuit
(Poseidon over the member wires), so a spent record's plaintext never
appears on the wire. Checked integer semantics map to range
constraints: an overflowing trace has no satisfying assignment, so a
HaltError execution is unprovable — the circuit enforces the
interpreter's halt semantics rather than modelling them.

Provable subset (near-complete instruction coverage, reference:
snarkVM's synthesizer compiles every deployed function):
- all integer types INCLUDING signed (two's-complement encodings;
  checked ops surface halts as unsatisfiability, wrapped ops truncate),
- div/rem/mod, bitwise and/or/xor/nand/nor/not, shl/shr (+.w, dynamic
  amounts), pow/pow.w with constant exponents, checked + lossy casts,
- structs (flat; public/private inputs, outputs, finalize args — one
  statement slot per member for public positions),
- closures (inlined recursively, depth-capped),
- Edwards group ops (complete-law add/sub/double/neg, scalar mul via a
  canonical-bit double-and-add ladder, casts from uints/scalars) and
  canonical scalar wires,
- group-typed inputs/outputs: PUBLIC points take two slots (x, y) with
  on-curve enforced in-circuit and prime-subgroup membership validated
  host-side at parse; PRIVATE points and record group members are
  witness points with the full in-circuit subgroup ladder,
- hash.psd2 / hash.psd4 on field operands.
Still outside: dynamic CHECKED pow exponents (pow.w with dynamic
exponents IS provable), 128-bit mul/div/shift products (exceed the
field), non-psd hashes (byte-string encodings), cross-program calls,
group members inside structs.  Such functions raise
``SynthesisUnsupported`` and remain enforced by public re-execution
(node/ledger.py), exactly as before.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

from snarkos_tpu_torch.crypto import params
from snarkos_tpu_torch.crypto.ref import poseidon
from snarkos_tpu_torch.crypto.ref.r1cs import R1CS, LinComb, _lc_add, _lc_scale, _poseidon_circuit
from snarkos_tpu_torch.vm import values as V
from snarkos_tpu_torch.vm.program import Function, Program

R = params.FR_MODULUS

FID_DOMAIN = "snarkos_tpu.vm.fid"
HASH_DOMAIN = "snarkos_tpu.vm.hash.psd2"
ADDR_DOMAIN = "snarkos_tpu.vm.addr"
RID_DOMAIN = "snarkos_tpu.vm.rid"          # record-type binding id
PRIV_DOMAIN = "snarkos_tpu.vm.priv"        # C_in: private-input commitment
SERIAL_DOMAIN = "snarkos_tpu.vm.serial"    # record serial (in-circuit)
RECOUT_DOMAIN = "snarkos_tpu.vm.recout"    # record-output commitments
PRIVOUT_DOMAIN = "snarkos_tpu.vm.privout"  # private-literal-output commitment


class SynthesisUnsupported(Exception):
    """The function uses constructs outside the provable subset."""


UINT_BITS = {"u8": 8, "u16": 16, "u32": 32, "u64": 64, "u128": 128}
# all integer types: name -> (width, signed).  Signed values are carried
# as their two's-complement encoding in [0, 2^w) — the canonical public
# encoding AND the in-circuit wire value; the signed VALUE is recovered
# as enc - 2^w * msb where needed (comparisons, checked arithmetic).
INT_BITS = dict(V.INT_TYPES)
# literal types a circuit value can carry; 'address' is an opaque field;
# 'scalar' wires carry canonical (< subgroup-order) values
CIRCUIT_TYPES = set(INT_BITS) | {"field", "boolean", "address", "scalar"}
_CALL_DEPTH_MAX = 8  # closure inlining recursion cap


@dataclass
class CVal:
    ty: str
    lc: LinComb
    # cached little-endian bit LinCombs (integer types only) — filled by
    # range constraints and reused by sign/compare/bitwise gadgets so a
    # register is never decomposed twice
    bits: list | None = None


@dataclass
class RecVal:
    """A record value inside the circuit: its type name and per-member
    circuit values (witness-backed for record inputs)."""

    rec: str
    members: dict  # name -> CVal


@dataclass
class StructVal:
    """A (flat) struct value inside the circuit: type name + members."""

    struct: str
    members: dict  # name -> CVal


@dataclass
class GroupVal:
    """An Edwards-BLS12 point inside the circuit (affine coordinates over
    Fr — the curve's base field IS the circuit field, which is what makes
    group ops circuit-native).  Group values arise from literals, casts
    and group arithmetic; they are not statement-slot types."""

    x: LinComb
    y: LinComb


@dataclass
class FunctionCircuit:
    """A compiled function: the constraint system plus the statement
    layout needed to (re)build public inputs."""

    program_id: str
    fn_name: str
    cs: R1CS
    input_tys: list   # [(vis, ty)]: vis in {'public','private','record'}
    output_tys: list  # [(kind, ty)]: kind in
    #                   {'finalize','output','private_out','record_out'}

    @property
    def n_record_outs(self) -> int:
        return sum(1 for k, _ in self.output_tys if k == "record_out")

    @property
    def has_private(self) -> bool:
        return any(v != "public" for v, _ in self.input_tys) or any(
            k in ("private_out", "record_out") for k, _ in self.output_tys)


def _bytes_to_fields(data: bytes) -> list:
    fields = [len(data)]
    for i in range(0, len(data), 31):
        fields.append(int.from_bytes(data[i:i + 31], "little"))
    return fields


def function_id(program_id: str, fn_name: str) -> int:
    """fid: Poseidon binding of the fully-qualified function name."""
    data = f"{program_id}/{fn_name}".encode()
    return poseidon.hash1(_bytes_to_fields(data), rate=2, domain=FID_DOMAIN)


def address_field(addr) -> int:
    """Statement encoding of an address: Poseidon binding of the FULL
    32-byte compressed encoding (ZERO address -> 0, the anonymous caller).

    Binding the whole encoding — not the decoded x-coordinate — means
    (a) no curve decompression is needed, so a well-formed hex string
    that is not a canonical point (e.g. a burn address) encodes without
    error on both the prove and verify sides, and (b) the sign of y is
    bound, so the on-curve twin (x, -y) cannot be substituted for the
    committed address."""
    if not isinstance(addr, str):
        # a decoded edwards point (e.g. derived from an account pk)
        from snarkos_tpu_torch.crypto.ref import edwards

        raw = edwards.compress(addr)
    else:
        if not addr.startswith("aleo1"):
            raise SynthesisUnsupported(f"malformed address {addr!r}")
        try:
            raw = bytes.fromhex(addr[5:])
        except ValueError:
            raise SynthesisUnsupported(f"malformed address {addr!r}") from None
        if len(raw) != 32:
            raise SynthesisUnsupported(f"malformed address {addr!r}")
    if raw == bytes(32):
        return 0
    return poseidon.hash1(_bytes_to_fields(raw), rate=2, domain=ADDR_DOMAIN)


def value_to_public_field(v: V.Value) -> int:
    """Canonical ONE-field encoding of a circuit-supported literal.
    Signed integers encode as their two's-complement residue mod 2^w."""
    if v.ty == "field":
        return v.val % R
    if v.ty == "boolean":
        return 1 if v.val else 0
    if v.ty in INT_BITS:
        return v.val % (1 << INT_BITS[v.ty][0])
    if v.ty == "scalar":
        return v.val % R  # already < subgroup order < R
    if v.ty == "address":
        return address_field(v.val)
    raise SynthesisUnsupported(f"type {v.ty!r} has no public encoding")


def value_leaf_fields(v: V.Value) -> list:
    """Flattened field encoding: structs yield one field per member (in
    declaration order), group points yield [x, y], other leaves one
    field (value_to_public_field).  Mirrors the circuit's
    one-statement-slot-per-leaf layout."""
    if v.ty == "group":
        return [v.val[0] % R, v.val[1] % R]
    if isinstance(v.val, dict) and v.ty not in CIRCUIT_TYPES:
        out = []
        for m in v.val.values():
            out.extend(value_leaf_fields(m))
        return out
    return [value_to_public_field(v)]


def record_id(program_id: str, record_name: str) -> int:
    """rid: Poseidon binding of the record type name (a per-circuit
    constant — serials of different record types can never collide)."""
    data = f"{program_id}/{record_name}".encode()
    return poseidon.hash1(_bytes_to_fields(data), rate=2, domain=RID_DOMAIN)


def record_serial_field(program_id: str, record_name: str, v: V.Value) -> int:
    """The serial (spend tag) of a record value as a field element:
    Poseidon over [rid, member fields...] — EXACTLY the relation the
    circuit enforces on record-input wires (vm/interpreter.record_serial
    wraps this for the ledger's byte-keyed spent set)."""
    fields = [record_id(program_id, record_name)]
    for m in v.val.values():
        fields.extend(value_leaf_fields(m))
    return poseidon.hash1(fields, rate=2, domain=SERIAL_DOMAIN)


def derive_blinds(seed: bytes, n_rec_outs: int) -> tuple:
    """Deterministic hiding blinds from a prover-secret seed:
    (blind_in, [blind_recout_j...], blind_privout)."""
    import hashlib as _h

    def f(tag: bytes) -> int:
        return int.from_bytes(
            _h.sha256(b"snarkos_tpu.exec.blind" + tag + seed).digest(),
            "little") % R

    return (f(b"in"),
            [f(b"rec%d" % j) for j in range(n_rec_outs)],
            f(b"privout"))


# --------------------------------------------------------------------------
# the synthesizer (single walk, optional trace)
# --------------------------------------------------------------------------


class _Synth:
    def __init__(self, cs: R1CS, z: list | None):
        self.cs = cs
        self.z = z

    # -- allocation helpers --------------------------------------------------
    def alloc(self, value: int | None = None) -> int:
        idx = self.cs.alloc()
        if self.z is not None:
            self.z[idx] = (value or 0) % R
        return idx

    def val(self, lc: LinComb) -> int:
        assert self.z is not None
        return self.cs.eval_lc(lc, self.z)

    def enforce(self, a: LinComb, b: LinComb, c: LinComb):
        self.cs.enforce(a, b, c)

    def mul(self, a: LinComb, b: LinComb) -> LinComb:
        out = self.alloc(self.val(a) * self.val(b) % R if self.z is not None else None)
        self.enforce(a, b, {out: 1})
        return {out: 1}

    def bits(self, lc: LinComb, width: int) -> list:
        """Decompose lc into ``width`` boolean vars (little-endian) and
        enforce the recomposition — UNSATISFIABLE when value >= 2^width,
        which is how checked-arithmetic halts surface in the circuit."""
        v = self.val(lc) if self.z is not None else 0
        if self.z is not None and v >= (1 << width):
            raise V.HaltError(f"range check failed: {v} >= 2^{width}")
        out = []
        recomp: LinComb = {}
        for i in range(width):
            b = self.alloc((v >> i) & 1)
            self.enforce({b: 1}, _lc_add({self.cs.one: 1}, {b: R - 1}), {})
            recomp = _lc_add(recomp, {b: 1 << i})
            out.append({b: 1})
        self.enforce(_lc_add(lc, _lc_scale(recomp, R - 1)), {self.cs.one: 1}, {})
        return out

    def is_zero(self, d: LinComb) -> LinComb:
        """z = (d == 0) via the inverse trick."""
        if self.z is not None:
            dv = self.val(d)
            zv = 1 if dv == 0 else 0
            iv = 0 if dv == 0 else pow(dv, -1, R)
        else:
            zv = iv = None
        zvar = self.alloc(zv)
        ivar = self.alloc(iv)
        # d * inv = 1 - z ;  d * z = 0
        self.enforce(d, {ivar: 1}, _lc_add({self.cs.one: 1}, {zvar: R - 1}))
        self.enforce(d, {zvar: 1}, {})
        return {zvar: 1}

    def sponge_hash1(self, domain: str, fields: list, rate: int = 2) -> LinComb:
        """In-circuit Poseidon sponge over LinComb inputs, mirroring
        poseidon.hash1(fields, rate, domain) bit for bit (absorb into
        the rate slots, permute per full block, squeeze slot 1)."""
        dom = poseidon._domain_to_field(domain)
        zero: LinComb = {}
        state = [{self.cs.one: dom}] + [zero] * rate
        pos = 0
        for lc in fields:
            if pos == rate:
                state = _poseidon_circuit(self.cs, state, self.z, rate=rate)
                pos = 0
            state[1 + pos] = _lc_add(state[1 + pos], dict(lc))
            pos += 1
        state = _poseidon_circuit(self.cs, state, self.z, rate=rate)
        return state[1]

    # -- integer helpers -----------------------------------------------------
    def int_bits(self, cv: CVal) -> list:
        """LE bit LinCombs of an integer CVal's encoding, cached on the
        CVal so each register is decomposed at most once."""
        if cv.bits is None:
            cv.bits = self.bits(cv.lc, INT_BITS[cv.ty][0])
        return cv.bits

    def signed_lc(self, cv: CVal) -> LinComb:
        """The integer VALUE of cv as a field LinComb: the encoding for
        unsigned types, enc - 2^w * msb (two's complement) for signed."""
        w, signed = INT_BITS[cv.ty]
        if not signed:
            return cv.lc
        msb = self.int_bits(cv)[w - 1]
        return _lc_add(cv.lc, _lc_scale(msb, R - (1 << w)))

    def signed_result(self, ty: str, v: LinComb, v_int: int | None) -> CVal:
        """Checked signed result: enforce VALUE v in [-2^(w-1), 2^(w-1))
        (unsatisfiable otherwise — the halt) and return its
        two's-complement encoding with cached bits."""
        w = INT_BITS[ty][0]
        half = 1 << (w - 1)
        t = _lc_add(v, {self.cs.one: half})
        if self.z is not None and not (0 <= (self.val(v) + half) % R < (1 << w)):
            raise V.HaltError(f"{ty} result out of range")
        tb = self.bits(t, w)
        not_msb = _lc_add({self.cs.one: 1}, _lc_scale(tb[w - 1], R - 1))
        enc = _lc_add(_lc_add(t, {self.cs.one: R - half}),
                      _lc_scale(not_msb, 1 << w))
        # enc's bits are tb[0..w-2] + [1 - tb[w-1]] — cache them
        return CVal(ty, enc, bits=tb[:w - 1] + [not_msb])

    def wrapped_result(self, ty: str, t: LinComb, m: int,
                       t_int: int | None) -> CVal:
        """Result = (t mod 2^w) where t is a NON-NEGATIVE field value
        known to fit in m bits; returns encoding with cached bits."""
        w = INT_BITS[ty][0]
        if self.z is not None and self.val(t) >= (1 << m):
            raise V.HaltError(f"wrap gadget width exceeded for {ty}")
        tb = self.bits(t, m)
        enc: LinComb = {}
        for i in range(w):
            enc = _lc_add(enc, _lc_scale(tb[i], 1 << i))
        return CVal(ty, enc, bits=tb[:w])

    def neg_enc(self, cv: CVal) -> CVal:
        """Two's-complement negation of the ENCODING: (2^w - u) mod 2^w,
        i.e. multiply-free wrap-around negation (abs.w / sign fixups)."""
        w = INT_BITS[cv.ty][0]
        nz = _lc_add({self.cs.one: 1},
                     _lc_scale(self.is_zero(cv.lc), R - 1))
        # enc_out = (2^w - u) * nz   (u=0 -> 0, else 2^w - u < 2^w)
        out = self.mul(_lc_add({self.cs.one: 1 << w}, _lc_scale(cv.lc, R - 1)),
                       nz)
        return CVal(cv.ty, out)


def _int_like(ty: str) -> bool:
    return ty in INT_BITS


def _arith_binary(s: _Synth, op: str, a: CVal, b: CVal) -> CVal:
    if a.ty != b.ty:
        raise SynthesisUnsupported(f"{op} on mixed types {a.ty}/{b.ty}")
    ty = a.ty
    if ty == "field":
        if op == "add":
            return CVal("field", _lc_add(a.lc, b.lc))
        if op == "sub":
            return CVal("field", _lc_add(a.lc, _lc_scale(b.lc, R - 1)))
        if op == "mul":
            return CVal("field", s.mul(a.lc, b.lc))
        if op == "div":
            # q with q*b = a and b invertible (div-by-zero halts)
            binv = s.alloc(pow(s.val(b.lc), -1, R) if s.z is not None
                           and s.val(b.lc) != 0 else None)
            if s.z is not None and s.val(b.lc) == 0:
                raise V.HaltError("field div by zero")
            s.enforce(b.lc, {binv: 1}, {s.cs.one: 1})
            q = s.alloc(s.val(a.lc) * pow(s.val(b.lc), -1, R) % R
                        if s.z is not None else None)
            s.enforce({q: 1}, b.lc, a.lc)
            return CVal("field", {q: 1})
        raise SynthesisUnsupported(f"field op {op!r}")
    if _int_like(ty):
        w, signed = INT_BITS[ty]
        if op in ("add", "sub", "mul") and signed:
            va, vb = s.signed_lc(a), s.signed_lc(b)
            if op == "add":
                v = _lc_add(va, vb)
            elif op == "sub":
                v = _lc_add(va, _lc_scale(vb, R - 1))
            else:
                if w > 64:
                    raise SynthesisUnsupported("i128 mul exceeds the field")
                v = s.mul(va, vb)
            return s.signed_result(ty, v, None)
        if op == "add":
            out = _lc_add(a.lc, b.lc)
            bs = s.bits(out, w)  # no-overflow range check
            return CVal(ty, out, bits=bs)
        if op == "sub":
            out = _lc_add(a.lc, _lc_scale(b.lc, R - 1))
            bs = s.bits(out, w)  # underflow -> unsatisfiable
            return CVal(ty, out, bits=bs)
        if op == "mul":
            if w > 64:
                raise SynthesisUnsupported("u128 mul product exceeds the field")
            prod = s.mul(a.lc, b.lc)
            bs = s.bits(prod, w)
            return CVal(ty, prod, bits=bs)
        if op in ("add.w", "sub.w"):
            # wrap-around on the ENCODINGS is signedness-independent
            if op == "add.w":
                t = _lc_add(a.lc, b.lc)
            else:
                t = _lc_add(_lc_add(a.lc, _lc_scale(b.lc, R - 1)),
                            {s.cs.one: 1 << w})
            return s.wrapped_result(ty, t, w + 1, None)
        if op == "mul.w":
            if w > 64:
                raise SynthesisUnsupported("128-bit mul.w exceeds the field")
            t = s.mul(a.lc, b.lc)
            return s.wrapped_result(ty, t, 2 * w, None)
        if op in ("div", "rem", "mod", "div.w", "rem.w"):
            return _int_divrem(s, op, a, b)
        raise SynthesisUnsupported(f"integer op {op!r}")
    raise SynthesisUnsupported(f"{op} on {ty}")


def _int_divrem(s: _Synth, op: str, a: CVal, b: CVal) -> CVal:
    """Truncated division family.  Relation: |a| = q * |b| + r with
    0 <= r < |b| and q in [0, 2^w); signs reattached per Aleo semantics
    (quotient sign = sa^sb, remainder sign = sa).  Checked variants
    additionally enforce the signed quotient in range (iN::MIN / -1 and
    iN::MIN rem -1 halt); div-by-zero is unsatisfiable (r < 0)."""
    ty = a.ty
    w, signed = INT_BITS[ty]
    if w > 64:
        raise SynthesisUnsupported("128-bit div/rem exceeds the field")
    if op == "mod" and signed:
        raise V.HaltError("mod requires unsigned operands")
    if s.z is not None and s.val(b.lc) == 0:
        raise V.HaltError("division by zero")
    if signed:
        sa, sb = s.int_bits(a)[w - 1], s.int_bits(b)[w - 1]
        ua = _abs_enc(s, a, sa)
        ub = _abs_enc(s, b, sb)
    else:
        ua, ub = a.lc, b.lc
    if s.z is not None:
        uav, ubv = s.val(ua), s.val(ub)
        qv, rv = uav // ubv, uav % ubv
    else:
        qv = rv = None
    q = s.alloc(qv)
    r = s.alloc(rv)
    s.bits({q: 1}, w)
    s.bits({r: 1}, w)
    # ua = q * ub + r
    s.enforce({q: 1}, ub, _lc_add(ua, _lc_scale({r: 1}, R - 1)))
    # r < ub:  ub - 1 - r in [0, 2^w)
    s.bits(_lc_add(ub, _lc_add({s.cs.one: R - 1}, _lc_scale({r: 1}, R - 1))), w)
    if not signed:
        return CVal(ty, {q: 1} if op in ("div", "div.w") else {r: 1})
    # sign of the quotient: sa ^ sb (wrapped); of the remainder: sa
    sq = _lc_add(_lc_add(sa, sb), _lc_scale(s.mul(sa, sb), R - 2))
    if op in ("div", "rem"):
        # checked: signed quotient must be representable (MIN / -1 halts;
        # snarkVM also halts MIN rem -1 — same q-range violation)
        vq = s.mul(_lc_add({s.cs.one: 1}, _lc_scale(sq, R - 2)), {q: 1})
        qcv = s.signed_result(ty, vq, None)
        if op == "div":
            return qcv
    if op == "div.w":
        qn = s.neg_enc(CVal(ty, {q: 1}))
        return CVal(ty, _ternary(s, CVal("boolean", sq),
                                 qn, CVal(ty, {q: 1})).lc)
    # remainder (rem / rem.w): encoding = sa ? -r : r  (wrap; |r|<|b| so
    # the signed value is always representable)
    rn = s.neg_enc(CVal(ty, {r: 1}))
    return CVal(ty, _ternary(s, CVal("boolean", sa),
                             rn, CVal(ty, {r: 1})).lc)


def _abs_enc(s: _Synth, cv: CVal, msb: LinComb) -> LinComb:
    """|value| of a signed CVal as an UNSIGNED w-bit field value
    (|iN::MIN| = 2^(w-1) is representable)."""
    neg = s.neg_enc(cv)
    return _ternary(s, CVal("boolean", msb), neg, CVal(cv.ty, cv.lc)).lc


def _compare(s: _Synth, op: str, a: CVal, b: CVal) -> CVal:
    if a.ty != b.ty or not _int_like(a.ty):
        raise SynthesisUnsupported(f"compare on {a.ty}/{b.ty}")
    w, signed = INT_BITS[a.ty]
    alc, blc = a.lc, b.lc
    if signed:
        # bias to order-preserving unsigned form: enc - 2^w*msb + 2^(w-1)
        alc = _lc_add(s.signed_lc(a), {s.cs.one: 1 << (w - 1)})
        blc = _lc_add(s.signed_lc(b), {s.cs.one: 1 << (w - 1)})
    # a - b + 2^w in [1, 2^(w+1)): bit w of the decomposition is (a >= b)
    shifted = _lc_add(_lc_add(alc, _lc_scale(blc, R - 1)),
                      {s.cs.one: 1 << w})
    bs = s.bits(shifted, w + 1)
    ge = bs[w]
    if op in ("gte", "is.gte"):
        return CVal("boolean", ge)
    if op in ("lt", "is.lt"):
        return CVal("boolean", _lc_add({s.cs.one: 1}, _lc_scale(ge, R - 1)))
    # lte(a, b) == gte(b, a); gt(a, b) == lt(b, a) — handled by caller swap
    raise SynthesisUnsupported(f"compare {op!r}")


def _ternary(s: _Synth, c: CVal, a: CVal, b: CVal) -> CVal:
    if c.ty != "boolean" or a.ty != b.ty:
        raise SynthesisUnsupported("ternary types")
    t = s.mul(c.lc, _lc_add(a.lc, _lc_scale(b.lc, R - 1)))
    return CVal(a.ty, _lc_add(t, b.lc))


def _bit_logical(s: _Synth, op: str, alc: LinComb, blc: LinComb) -> LinComb:
    """One-bit gate over boolean-constrained LinCombs."""
    ab = s.mul(alc, blc)
    one: LinComb = {s.cs.one: 1}
    if op == "and":
        return ab
    if op == "or":
        return _lc_add(_lc_add(alc, blc), _lc_scale(ab, R - 1))
    if op == "xor":
        return _lc_add(_lc_add(alc, blc), _lc_scale(ab, R - 2))
    if op == "nand":
        return _lc_add(one, _lc_scale(ab, R - 1))
    if op == "nor":
        return _lc_add(one, _lc_scale(
            _lc_add(_lc_add(alc, blc), _lc_scale(ab, R - 1)), R - 1))
    raise SynthesisUnsupported(f"logical {op!r}")


def _logical(s: _Synth, op: str, a: CVal, b: CVal) -> CVal:
    if a.ty == "boolean" and b.ty == "boolean":
        return CVal("boolean", _bit_logical(s, op, a.lc, b.lc))
    if _int_like(a.ty) and a.ty == b.ty:
        # bitwise on integers (two's-complement encodings)
        w = INT_BITS[a.ty][0]
        abits, bbits = s.int_bits(a), s.int_bits(b)
        obits = [_bit_logical(s, op, abits[i], bbits[i]) for i in range(w)]
        enc: LinComb = {}
        for i, ob in enumerate(obits):
            enc = _lc_add(enc, _lc_scale(ob, 1 << i))
        return CVal(a.ty, enc, bits=obits)
    raise SynthesisUnsupported(f"{op} on {a.ty}/{b.ty}")


def _group_const(s: _Synth, p) -> GroupVal:
    """A constant point as a GroupVal."""
    x, y = p
    return GroupVal(x={s.cs.one: x % R} if x % R else {},
                    y={s.cs.one: y % R} if y % R else {})


def _group_add(s: _Synth, p: GroupVal, q: GroupVal) -> GroupVal:
    """Complete twisted-Edwards addition (a = -1, mirrors
    crypto/ref/edwards.add):  x3 = (x1 y2 + y1 x2) / (1 + d t),
    y3 = (y1 y2 + x1 x2) / (1 - d t)  with t = x1 x2 y1 y2.  The
    denominators are provably non-zero for subgroup points, so the
    quotient wires always exist."""
    D = __import__("snarkos_tpu_torch.crypto.ref.edwards",
                   fromlist=["D"]).D
    A = s.mul(p.x, q.x)           # x1 x2
    B = s.mul(p.y, q.y)           # y1 y2
    # (x1 + y1)(x2 + y2) = A + B + (x1 y2 + y1 x2)
    C = s.mul(_lc_add(p.x, p.y), _lc_add(q.x, q.y))
    T = _lc_scale(s.mul(A, B), D % R)   # d * x1 x2 y1 y2
    num_x = _lc_add(C, _lc_add(_lc_scale(A, R - 1), _lc_scale(B, R - 1)))
    num_y = _lc_add(A, B)
    den_x = _lc_add({s.cs.one: 1}, T)
    den_y = _lc_add({s.cs.one: 1}, _lc_scale(T, R - 1))
    if s.z is not None:
        x3 = s.val(num_x) * pow(s.val(den_x), -1, R) % R
        y3 = s.val(num_y) * pow(s.val(den_y), -1, R) % R
    else:
        x3 = y3 = None
    x3v, y3v = s.alloc(x3), s.alloc(y3)
    s.enforce({x3v: 1}, den_x, num_x)
    s.enforce({y3v: 1}, den_y, num_y)
    return GroupVal(x={x3v: 1}, y={y3v: 1})


def _group_neg(p: GroupVal) -> GroupVal:
    return GroupVal(x=_lc_scale(p.x, R - 1), y=dict(p.y))


def _group_mux(s: _Synth, c: LinComb, p: GroupVal, q: GroupVal) -> GroupVal:
    """c ? p : q  coordinate-wise."""
    tx = s.mul(c, _lc_add(p.x, _lc_scale(q.x, R - 1)))
    ty = s.mul(c, _lc_add(p.y, _lc_scale(q.y, R - 1)))
    return GroupVal(x=_lc_add(tx, q.x), y=_lc_add(ty, q.y))


def _group_scalar_mul(s: _Synth, kbits: list, p: GroupVal) -> GroupVal:
    """MSB-first double-and-add over bit LinCombs (kbits little-endian)."""
    acc = _group_const(s, (0, 1))  # identity
    for b in reversed(kbits):
        acc = _group_add(s, acc, acc)
        with_p = _group_add(s, acc, p)
        acc = _group_mux(s, b, with_p, acc)
    return acc


def _witness_group(s: _Synth, pt) -> GroupVal:
    """A PRIVATE (witness) Edwards point: allocate (x, y), enforce the
    on-curve equation and prime-subgroup membership in-circuit (a
    constant-bit ORDER ladder — cofactor-4 small-order points would
    otherwise satisfy the curve equation).  ``pt`` is the concrete
    (x, y) in trace mode, None in compile mode."""
    from snarkos_tpu_torch.crypto.ref import edwards as _ed

    if s.z is not None:
        if not _ed.in_subgroup(pt):
            raise V.HaltError("witness point outside the prime subgroup")
        xv, yv = pt[0] % R, pt[1] % R
    else:
        xv = yv = None
    x, y = s.alloc(xv), s.alloc(yv)
    gv = GroupVal(x={x: 1}, y={y: 1})
    x2 = s.mul(gv.x, gv.x)
    y2 = s.mul(gv.y, gv.y)
    x2y2 = s.mul(x2, y2)
    s.enforce(
        _lc_add(_lc_add(_lc_scale(x2, R - 1), y2),
                _lc_add({s.cs.one: R - 1}, _lc_scale(x2y2, (R - _ed.D) % R))),
        {s.cs.one: 1}, {})
    acc = _group_const(s, (0, 1))
    for bit in bin(_ed.ORDER)[2:]:
        acc = _group_add(s, acc, acc)
        if bit == "1":
            acc = _group_add(s, acc, gv)
    s.enforce(acc.x, {s.cs.one: 1}, {})
    s.enforce(_lc_add(acc.y, {s.cs.one: R - 1}), {s.cs.one: 1}, {})
    return gv


def _scalar_canon_bits(s: _Synth, cv: CVal) -> list:
    """Canonical bit decomposition of a scalar wire: value < subgroup
    order (soundness: two decompositions of the same field residue would
    change k*P)."""
    from snarkos_tpu_torch.crypto.ref import edwards

    nb = edwards.ORDER.bit_length()
    if cv.bits is None:
        bs = s.bits(cv.lc, nb)
        # ORDER - 1 - k in [0, 2^nb)
        s.bits(_lc_add({s.cs.one: edwards.ORDER - 1},
                       _lc_scale(cv.lc, R - 1)), nb)
        cv.bits = bs
    return cv.bits


def _pow2_of(s: _Synth, b: CVal, lg_w: int) -> tuple:
    """(2^(b mod w) as a LinComb, b's low-bit list).  Uses only the low
    lg_w bits of the shift amount b (w = 2^lg_w)."""
    bbits = s.int_bits(b)
    p: LinComb = {s.cs.one: 1}
    for i in range(lg_w):
        # p *= (1 + b_i * (2^(2^i) - 1))
        factor = _lc_add({s.cs.one: 1},
                         _lc_scale(bbits[i], (1 << (1 << i)) - 1))
        p = s.mul(p, factor)
    return p, bbits


def _shift(s: _Synth, op: str, a: CVal, b: CVal) -> CVal:
    """shl/shr and wrapped variants with a DYNAMIC u8/u16/u32 amount.
    Checked forms enforce amount < w (halt otherwise); wrapped forms use
    amount mod w.  128-bit operands exceed the field for the product
    relations and stay unsupported."""
    ty = a.ty
    if not _int_like(ty) or b.ty not in ("u8", "u16", "u32"):
        raise SynthesisUnsupported(f"{op} on {a.ty}/{b.ty}")
    w, signed = INT_BITS[ty]
    if w > 64:
        raise SynthesisUnsupported("128-bit shift exceeds the field")
    lg_w = w.bit_length() - 1
    checked = not op.endswith(".w")
    p2b, bbits = _pow2_of(s, b, lg_w)
    if checked:
        # amount < w: every bit above lg_w must be zero
        high = functools.reduce(_lc_add, bbits[lg_w:], {})
        if s.z is not None and s.val(high) != 0:
            raise V.HaltError("shift amount exceeds bit width")
        s.enforce(high, {s.cs.one: 1}, {})
    base = op.split(".")[0]
    if base == "shl":
        v = s.mul(s.signed_lc(a) if signed else a.lc, p2b)
        if checked:
            return s.signed_result(ty, v, None) if signed \
                else CVal(ty, v, bits=s.bits(v, w))
        # shl.w: wrap the (non-negative) encoding product to w bits
        t = s.mul(a.lc, p2b)
        return s.wrapped_result(ty, t, 2 * w, None)
    # shr: value = q * 2^b + rem with 0 <= rem < 2^b (floor semantics,
    # arithmetic shift for signed)
    if s.z is not None:
        va = s.val(s.signed_lc(a)) if signed else s.val(a.lc)
        if va >= R // 2:
            va -= R  # negative signed value
        sh = s.val(p2b)
        qv, remv = va // sh, va % sh
    else:
        qv = remv = None
    qenc = s.alloc(qv % (1 << w) if qv is not None else None)
    rem = s.alloc(remv)
    qcv = CVal(ty, {qenc: 1})
    qbits = s.int_bits(qcv)
    s.bits({rem: 1}, w)
    # rem < 2^b:  2^b - 1 - rem in [0, 2^w)
    s.bits(_lc_add(p2b, _lc_add({s.cs.one: R - 1},
                                _lc_scale({rem: 1}, R - 1))), w)
    vq = _lc_add({qenc: 1}, _lc_scale(qbits[w - 1], R - (1 << w))) \
        if signed else {qenc: 1}
    va_lc = s.signed_lc(a) if signed else a.lc
    s.enforce(vq, p2b, _lc_add(va_lc, _lc_scale({rem: 1}, R - 1)))
    return qcv


def _int_pow(s: _Synth, op: str, a: CVal, b: CVal, b_const: int | None) -> CVal:
    """pow/pow.w with a CONSTANT exponent (a literal operand); dynamic
    exponents are outside the provable subset.  Field base: square-and-
    multiply mod p.  Integer base checked: the exact integer a^e must fit
    the field (w*e <= 250) so the final range check mirrors snarkVM's
    check_int(a**e); integer pow.w wraps at every step."""
    if b_const is None:
        raise SynthesisUnsupported(f"{op} requires a constant exponent")
    e = b_const
    if a.ty == "field":
        if op != "pow":
            raise SynthesisUnsupported("pow.w on field")
        out = CVal("field", {s.cs.one: 1})
        for bit in bin(e)[2:]:
            out = CVal("field", s.mul(out.lc, out.lc))
            if bit == "1":
                out = CVal("field", s.mul(out.lc, a.lc))
        return out
    if not _int_like(a.ty):
        raise SynthesisUnsupported(f"pow on {a.ty}")
    w, signed = INT_BITS[a.ty]
    if op == "pow":
        if w * max(e, 1) > 250:
            raise SynthesisUnsupported("pow result exceeds the field")
        v = {s.cs.one: 1}
        va = s.signed_lc(a) if signed else a.lc
        for _ in range(e):
            v = s.mul(v, va)
        return s.signed_result(a.ty, v, None) if signed \
            else CVal(a.ty, v, bits=s.bits(v, w))
    # pow.w: wrapped square-and-multiply on encodings
    out = CVal(a.ty, {s.cs.one: 1})
    for bit in bin(e)[2:]:
        out = _arith_binary(s, "mul.w", out, out)
        if bit == "1":
            out = _arith_binary(s, "mul.w", out, a)
    return out


def _hash_psd(s: _Synth, rate: int, v: CVal) -> CVal:
    """In-circuit Poseidon-sponge hash of ONE field element (interpreter
    parity: vm/interpreter._value_to_fields encodes a field value as
    itself).  rate=2 -> hash.psd2, rate=4 -> hash.psd4."""
    if v.ty != "field":
        raise SynthesisUnsupported(
            f"hash.psd{rate} provable only for field operands")
    dom = poseidon._domain_to_field(f"snarkos_tpu.vm.hash.psd{rate}")
    zero: LinComb = {}
    state = [{s.cs.one: dom}, dict(v.lc)] + [zero] * (rate - 1)
    tz = s.z  # _poseidon_circuit consumes the shared trace list directly
    out = _poseidon_circuit(s.cs, state, tz, rate=rate)
    return CVal("field", out[1])


def _cast(s: _Synth, v: CVal, ty: str, lossy: bool = False) -> CVal:
    base = ty.split(".")[0]
    if base == v.ty:
        return v
    src_signed = _int_like(v.ty) and INT_BITS[v.ty][1]
    if base == "field":
        if v.ty in ("boolean", "scalar") or (_int_like(v.ty)
                                             and not src_signed):
            return CVal("field", v.lc)  # value already < order/2^128 < p
        if src_signed:
            # V.cast: value mod p (negative -> p + v), i.e. the VALUE lc
            return CVal("field", s.signed_lc(v))
        raise SynthesisUnsupported(f"cast {v.ty} -> field")
    if base == "boolean":
        if not _int_like(v.ty):
            raise SynthesisUnsupported(f"cast {v.ty} -> boolean")
        # requires encoding 0/1 (negative values encode large -> halt)
        if s.z is not None and s.val(v.lc) not in (0, 1):
            raise V.HaltError("cast to boolean requires 0/1")
        s.enforce(v.lc, _lc_add({s.cs.one: 1}, _lc_scale(v.lc, R - 1)), {})
        return CVal("boolean", v.lc)
    if _int_like(base):
        dst_w, dst_signed = INT_BITS[base]
        if v.ty == "boolean":
            return CVal(base, v.lc)
        if v.ty == "field" and not lossy:
            if dst_signed:
                # non-negative field value must fit [0, 2^(w-1))
                bs = s.bits(v.lc, dst_w - 1)
                return CVal(base, v.lc, bits=bs + [dict()])
            bs = s.bits(v.lc, dst_w)  # halt (unsat) when out of range
            return CVal(base, v.lc, bits=bs)
        if not _int_like(v.ty):
            raise SynthesisUnsupported(f"cast {v.ty} -> {ty}")
        src_w = INT_BITS[v.ty][0]
        if lossy:
            # wrap_int semantics: enc' = VALUE mod 2^dst_w
            if not src_signed and dst_w >= src_w:
                return CVal(base, v.lc, bits=v.bits)
            if dst_w <= src_w:
                # truncate the encoding (two's complement wrap)
                bs = s.int_bits(v)[:dst_w]
                enc: LinComb = {}
                for i, bb in enumerate(bs):
                    enc = _lc_add(enc, _lc_scale(bb, 1 << i))
                return CVal(base, enc, bits=list(bs))
            # signed widening: sign-extend via (value + 2^dst_w) mod 2^dst_w
            vv = s.signed_lc(v)
            return s.wrapped_result(
                base, _lc_add(vv, {s.cs.one: 1 << dst_w}), dst_w + 1, None)
        # checked int -> int: the VALUE must fit the destination range
        vv = s.signed_lc(v)
        off = 1 << (dst_w - 1) if dst_signed else 0
        t = _lc_add(vv, {s.cs.one: off}) if off else vv
        if s.z is not None and not (0 <= (s.val(vv) + off) % R < (1 << dst_w)):
            raise V.HaltError(f"cast out of range for {base}")
        if dst_signed:
            return s.signed_result(base, vv, None)
        bs = s.bits(t, dst_w)
        return CVal(base, t, bits=bs)
    raise SynthesisUnsupported(f"cast {v.ty} -> {ty}")


def _constrain_literal(s: _Synth, cv: CVal):
    """Type constraints on an unconstrained (witness or public) wire."""
    if cv.ty == "boolean":
        s.enforce(cv.lc, _lc_add({s.cs.one: 1}, _lc_scale(cv.lc, R - 1)), {})
    elif cv.ty in INT_BITS:
        cv.bits = s.bits(cv.lc, INT_BITS[cv.ty][0])
    elif cv.ty == "scalar":
        _scalar_canon_bits(s, cv)  # canonical: value < subgroup order


def _make_operand(s: _Synth, program: Program, regs: dict, caller_cv: CVal):
    """(operand, operand_any) resolvers over a register namespace."""

    def operand_any(tok: str):
        if tok in regs:
            return regs[tok]
        if "." in tok and tok.split(".")[0] in regs:
            base_reg, *path = tok.split(".")
            rv = regs[base_reg]
            for p in path:
                if isinstance(rv, (RecVal, StructVal)) and p in rv.members:
                    rv = rv.members[p]
                else:
                    raise SynthesisUnsupported(f"member access {tok!r}")
            return rv
        if tok in ("self.caller", "self.signer"):
            return caller_cv
        v = V.parse_literal(tok)
        if v.ty == "group":
            return _group_const(s, v.val)
        if v.ty == "scalar":
            return CVal("scalar", {s.cs.one: v.val % R})
        if v.ty not in CIRCUIT_TYPES:
            raise SynthesisUnsupported(f"literal {tok!r}")
        return CVal(v.ty, {s.cs.one: value_to_public_field(v)})

    def operand(tok: str) -> CVal:
        v = operand_any(tok)
        if isinstance(v, (RecVal, StructVal)):
            raise SynthesisUnsupported(f"composite {tok!r} used as literal")
        return v

    return operand, operand_any


def _leaf_cvals(v) -> list:
    """Flatten a circuit value to its leaf CVals (declaration order);
    group points expand to their (x, y) coordinate fields."""
    if isinstance(v, GroupVal):
        return [CVal("field", dict(v.x)), CVal("field", dict(v.y))]
    if isinstance(v, (RecVal, StructVal)):
        out = []
        for m in v.members.values():
            out.extend(_leaf_cvals(m))
        return out
    return [v]


def _eq_composite(s: _Synth, a, b) -> LinComb:
    """Boolean LinComb: all leaves equal (same composite type assumed)."""
    leaves_a, leaves_b = _leaf_cvals(a), _leaf_cvals(b)
    eq: LinComb = {s.cs.one: 1}
    for la, lb in zip(leaves_a, leaves_b):
        d = _lc_add(la.lc, _lc_scale(lb.lc, R - 1))
        eq = s.mul(eq, s.is_zero(d))
    return eq


def _same_composite(a, b) -> bool:
    if isinstance(a, RecVal) and isinstance(b, RecVal):
        return a.rec == b.rec
    if isinstance(a, StructVal) and isinstance(b, StructVal):
        return a.struct == b.struct
    return False


def _const_literal(tok: str):
    """The concrete value of a literal operand token, else None."""
    try:
        return V.parse_literal(tok)
    except Exception:
        return None


def _exec_body(s: _Synth, program: Program, caller_cv: CVal, regs: dict,
               instructions: list, depth: int = 0):
    """Symbolically execute an instruction list over ``regs`` (the single
    dispatch shared by function bodies and inlined closures)."""
    operand, operand_any = _make_operand(s, program, regs, caller_cv)
    for ins in instructions:
        op = ins.op
        if op in ("add", "sub", "mul", "div", "add.w", "sub.w", "mul.w",
                  "div.w", "rem", "rem.w", "mod"):
            a, b = operand(ins.operands[0]), operand(ins.operands[1])
            ga, gb = isinstance(a, GroupVal), isinstance(b, GroupVal)
            if ga or gb:
                if op == "add" and ga and gb:
                    regs[ins.dests[0]] = _group_add(s, a, b)
                elif op == "sub" and ga and gb:
                    regs[ins.dests[0]] = _group_add(s, a, _group_neg(b))
                elif op == "mul" and (ga != gb):
                    p = a if ga else b
                    k = b if ga else a
                    if not isinstance(k, CVal) or k.ty != "scalar":
                        raise SynthesisUnsupported("group mul needs a scalar")
                    ktok = ins.operands[1 if ga else 0]
                    kc = _const_literal(ktok)
                    if kc is not None and kc.ty == "scalar":
                        # constant scalar: constant bit pattern, no
                        # decomposition / canonicity constraints needed
                        kbits = [({s.cs.one: 1} if (kc.val >> i) & 1 else {})
                                 for i in range(kc.val.bit_length() or 1)]
                    else:
                        kbits = _scalar_canon_bits(s, k)
                    regs[ins.dests[0]] = _group_scalar_mul(s, kbits, p)
                else:
                    raise SynthesisUnsupported(f"group {op}")
                continue
            regs[ins.dests[0]] = _arith_binary(s, op, a, b)
        elif op == "square":
            a = operand(ins.operands[0])
            if not isinstance(a, CVal) or a.ty != "field":
                raise SynthesisUnsupported("square requires field")
            regs[ins.dests[0]] = _arith_binary(s, "mul", a, a)
        elif op == "double":
            a = operand(ins.operands[0])
            if isinstance(a, GroupVal):
                regs[ins.dests[0]] = _group_add(s, a, a)
                continue
            if a.ty != "field":
                raise SynthesisUnsupported("double requires field")
            regs[ins.dests[0]] = _arith_binary(s, "add", a, a)
        elif op == "neg":
            a = operand(ins.operands[0])
            if isinstance(a, GroupVal):
                regs[ins.dests[0]] = _group_neg(a)
                continue
            if a.ty == "field":
                regs[ins.dests[0]] = CVal("field", _lc_scale(a.lc, R - 1))
            elif _int_like(a.ty):
                w, signed = INT_BITS[a.ty]
                if signed:
                    v = _lc_scale(s.signed_lc(a), R - 1)
                    regs[ins.dests[0]] = s.signed_result(a.ty, v, None)
                else:
                    # checked -u is representable only for u == 0
                    if s.z is not None and s.val(a.lc) != 0:
                        raise V.HaltError("neg overflow")
                    s.enforce(a.lc, {s.cs.one: 1}, {})
                    regs[ins.dests[0]] = a
            else:
                raise SynthesisUnsupported("neg on non-numeric")
        elif op in ("abs", "abs.w"):
            a = operand(ins.operands[0])
            if not _int_like(a.ty):
                raise SynthesisUnsupported("abs on non-integer")
            w, signed = INT_BITS[a.ty]
            if not signed:
                regs[ins.dests[0]] = a
            else:
                msb = s.int_bits(a)[w - 1]
                enc = _abs_enc(s, a, msb)
                if op == "abs":
                    # checked: |iN::MIN| = 2^(w-1) halts
                    if s.z is not None and s.val(enc) >= (1 << (w - 1)):
                        raise V.HaltError("abs overflow")
                    bs = s.bits(enc, w - 1)
                    regs[ins.dests[0]] = CVal(a.ty, enc, bits=bs + [dict()])
                else:
                    regs[ins.dests[0]] = CVal(a.ty, enc)
        elif op == "inv":
            a = operand(ins.operands[0])
            one_cv = CVal("field", {s.cs.one: 1})
            regs[ins.dests[0]] = _arith_binary(s, "div", one_cv, a)
        elif op in ("and", "or", "xor", "nand", "nor"):
            a, b = operand(ins.operands[0]), operand(ins.operands[1])
            regs[ins.dests[0]] = _logical(s, op, a, b)
        elif op == "not":
            a = operand(ins.operands[0])
            if a.ty == "boolean":
                regs[ins.dests[0]] = CVal(
                    "boolean", _lc_add({s.cs.one: 1}, _lc_scale(a.lc, R - 1)))
            elif _int_like(a.ty):
                w = INT_BITS[a.ty][0]
                abits = s.int_bits(a)
                obits = [_lc_add({s.cs.one: 1}, _lc_scale(bb, R - 1))
                         for bb in abits]
                enc = _lc_add({s.cs.one: (1 << w) - 1}, _lc_scale(a.lc, R - 1))
                regs[ins.dests[0]] = CVal(a.ty, enc, bits=obits)
            else:
                raise SynthesisUnsupported("not on non-boolean/integer")
        elif op == "ternary":
            c = operand(ins.operands[0])
            va, vb = operand_any(ins.operands[1]), operand_any(ins.operands[2])
            if isinstance(va, GroupVal) or isinstance(vb, GroupVal):
                if not (isinstance(va, GroupVal) and isinstance(vb, GroupVal)):
                    raise SynthesisUnsupported("ternary group/non-group")
                if c.ty != "boolean":
                    raise SynthesisUnsupported("ternary condition type")
                regs[ins.dests[0]] = _group_mux(s, c.lc, va, vb)
            elif isinstance(va, (RecVal, StructVal)):
                if not _same_composite(va, vb):
                    raise SynthesisUnsupported("ternary on mixed composites")
                members = {
                    m: (_group_mux(s, c.lc, va.members[m], vb.members[m])
                        if isinstance(va.members[m], GroupVal)
                        else _ternary(s, c, va.members[m], vb.members[m]))
                    for m in va.members
                }
                regs[ins.dests[0]] = (
                    RecVal(rec=va.rec, members=members)
                    if isinstance(va, RecVal)
                    else StructVal(struct=va.struct, members=members))
            else:
                regs[ins.dests[0]] = _ternary(s, c, va, vb)
        elif op in ("is.eq", "is.neq"):
            a = operand_any(ins.operands[0])
            b = operand_any(ins.operands[1])
            if isinstance(a, GroupVal) or isinstance(b, GroupVal):
                if not (isinstance(a, GroupVal) and isinstance(b, GroupVal)):
                    raise SynthesisUnsupported("eq group/non-group")
                ex = s.is_zero(_lc_add(a.x, _lc_scale(b.x, R - 1)))
                ey = s.is_zero(_lc_add(a.y, _lc_scale(b.y, R - 1)))
                zb = s.mul(ex, ey)
                if op == "is.neq":
                    zb = _lc_add({s.cs.one: 1}, _lc_scale(zb, R - 1))
                regs[ins.dests[0]] = CVal("boolean", zb)
                continue
            if isinstance(a, (RecVal, StructVal)) or isinstance(
                    b, (RecVal, StructVal)):
                if not _same_composite(a, b):
                    raise SynthesisUnsupported("eq on mixed composites")
                zb = _eq_composite(s, a, b)
            elif a.ty != b.ty:
                zb = {}  # eq_values: different types are never equal
            else:
                d = _lc_add(a.lc, _lc_scale(b.lc, R - 1))
                zb = s.is_zero(d)
            if op == "is.neq":
                zb = _lc_add({s.cs.one: 1}, _lc_scale(zb, R - 1))
            regs[ins.dests[0]] = CVal("boolean", zb)
        elif op in ("assert.eq", "assert.neq"):
            a = operand_any(ins.operands[0])
            b = operand_any(ins.operands[1])
            if isinstance(a, GroupVal) or isinstance(b, GroupVal):
                if not (isinstance(a, GroupVal) and isinstance(b, GroupVal)):
                    raise SynthesisUnsupported("assert group/non-group")
                dx = _lc_add(a.x, _lc_scale(b.x, R - 1))
                dy = _lc_add(a.y, _lc_scale(b.y, R - 1))
                if op == "assert.eq":
                    if s.z is not None and (s.val(dx) or s.val(dy)):
                        raise V.HaltError("assert.eq failed")
                    s.enforce(dx, {s.cs.one: 1}, {})
                    s.enforce(dy, {s.cs.one: 1}, {})
                else:
                    if s.z is not None and not (s.val(dx) or s.val(dy)):
                        raise V.HaltError("assert.neq failed")
                    # NOT(dx == 0 AND dy == 0)
                    s.enforce(s.is_zero(dx), s.is_zero(dy), {})
                continue
            if isinstance(a, (RecVal, StructVal)) or isinstance(
                    b, (RecVal, StructVal)):
                if not _same_composite(a, b):
                    raise SynthesisUnsupported("assert on mixed composites")
                eq = _eq_composite(s, a, b)
                want = 1 if op == "assert.eq" else 0
                if s.z is not None and s.val(eq) != want:
                    raise V.HaltError(f"{op} failed")
                s.enforce(_lc_add(eq, {s.cs.one: R - want}), {s.cs.one: 1}, {})
                continue
            if a.ty != b.ty:
                # eq_values: never equal -> assert.eq always halts,
                # assert.neq always passes
                if op == "assert.eq":
                    if s.z is not None:
                        raise V.HaltError("assert.eq failed (type mismatch)")
                    s.enforce({s.cs.one: 1}, {s.cs.one: 1}, {})
                continue
            d = _lc_add(a.lc, _lc_scale(b.lc, R - 1))
            if op == "assert.eq":
                if s.z is not None and s.val(d) != 0:
                    raise V.HaltError("assert.eq failed")
                s.enforce(d, {s.cs.one: 1}, {})
            else:
                if s.z is not None and s.val(d) == 0:
                    raise V.HaltError("assert.neq failed")
                dinv = s.alloc(pow(s.val(d), -1, R) if s.z is not None else None)
                s.enforce(d, {dinv: 1}, {s.cs.one: 1})
        elif op in ("lt", "gt", "lte", "gte",
                    "is.lt", "is.gt", "is.lte", "is.gte"):
            a, b = operand(ins.operands[0]), operand(ins.operands[1])
            base = op.split(".")[-1]
            if base in ("gte", "lt"):
                regs[ins.dests[0]] = _compare(s, base, a, b)
            elif base == "lte":  # a <= b  ==  b >= a
                regs[ins.dests[0]] = _compare(s, "gte", b, a)
            else:  # gt: a > b == b < a
                regs[ins.dests[0]] = _compare(s, "lt", b, a)
        elif op in ("shl", "shl.w", "shr", "shr.w"):
            a, b = operand(ins.operands[0]), operand(ins.operands[1])
            regs[ins.dests[0]] = _shift(s, op, a, b)
        elif op in ("pow", "pow.w"):
            a = operand(ins.operands[0])
            b = operand(ins.operands[1])
            cb = _const_literal(ins.operands[1])
            if cb is None:
                # dynamic exponent: only pow.w is provable (wrapped
                # square-and-multiply over the exponent's bits; checked
                # pow needs the EXACT integer a^e, unbounded)
                if op != "pow.w" or not _int_like(a.ty) \
                        or b.ty not in ("u8", "u16", "u32"):
                    raise SynthesisUnsupported(
                        f"{op} requires a constant exponent")
                ebits = s.int_bits(b)
                out = CVal(a.ty, {s.cs.one: 1})
                for eb in reversed(ebits):
                    out = _arith_binary(s, "mul.w", out, out)
                    mul_a = _arith_binary(s, "mul.w", out, a)
                    sel = _ternary(s, CVal("boolean", eb), mul_a, out)
                    out = CVal(a.ty, sel.lc)
                regs[ins.dests[0]] = out
                continue
            if a.ty == "field":
                if cb.ty != "field":
                    raise SynthesisUnsupported("field pow exponent must be field")
            elif cb.ty not in ("u8", "u16", "u32"):
                raise SynthesisUnsupported("integer pow exponent must be u8/u16/u32")
            regs[ins.dests[0]] = _int_pow(s, op, a, b, cb.val)
        elif op in ("cast", "cast.lossy"):
            as_base = ins.as_type.split(".")[0]
            if as_base in program.structs and not op.endswith("lossy"):
                st = program.structs[as_base]
                if len(ins.operands) != len(st.members):
                    raise SynthesisUnsupported("struct cast arity")
                members = {}
                for (mname, mty), tok in zip(st.members.items(),
                                             ins.operands):
                    cv = operand(tok)
                    if cv.ty != mty.split(".")[0]:
                        raise SynthesisUnsupported(
                            f"struct member {mname}: {cv.ty} != {mty}")
                    members[mname] = cv
                regs[ins.dests[0]] = StructVal(struct=as_base, members=members)
                continue
            if as_base in program.records and ins.as_type.endswith(".record"):
                # record construction: members from operands (decl order)
                rec = program.records[as_base]
                if len(ins.operands) != len(rec.members):
                    raise SynthesisUnsupported("record cast arity")
                members = {}
                for (mname, mty), tok in zip(rec.members.items(),
                                             ins.operands):
                    cv = operand(tok)
                    mb = mty.split(".")[0]
                    if isinstance(cv, GroupVal):
                        if mb != "group":
                            raise SynthesisUnsupported(
                                f"record member {mname}: group != {mty}")
                    elif cv.ty != mb:
                        raise SynthesisUnsupported(
                            f"record member {mname}: {cv.ty} != {mty}")
                    members[mname] = cv
                regs[ins.dests[0]] = RecVal(rec=as_base, members=members)
                continue
            if len(ins.operands) != 1:
                raise SynthesisUnsupported("cast form")
            cv = operand(ins.operands[0])
            if isinstance(cv, GroupVal):
                if as_base != "field":
                    raise SynthesisUnsupported(f"cast group -> {as_base}")
                # x-coordinate projection (V.cast framework convention)
                regs[ins.dests[0]] = CVal("field", dict(cv.x))
                continue
            if as_base == "group":
                # k -> k*G with k reduced mod the subgroup order; every
                # unsigned/boolean value is already < ORDER
                if cv.ty == "boolean":
                    kbits = [cv.lc]
                elif cv.ty == "scalar":
                    kbits = _scalar_canon_bits(s, cv)
                elif _int_like(cv.ty) and not INT_BITS[cv.ty][1]:
                    kbits = s.int_bits(cv)
                else:
                    raise SynthesisUnsupported(f"cast {cv.ty} -> group")
                from snarkos_tpu_torch.crypto.ref import edwards as _ed

                regs[ins.dests[0]] = _group_scalar_mul(
                    s, kbits, _group_const(s, _ed.GENERATOR))
                continue
            if as_base == "scalar":
                # checked cast: value must be < the subgroup order; the
                # result wire is canonical by the same constraints
                if not (_int_like(cv.ty) and not INT_BITS[cv.ty][1]
                        and INT_BITS[cv.ty][0] <= 128) and cv.ty != "boolean":
                    raise SynthesisUnsupported(f"cast {cv.ty} -> scalar")
                regs[ins.dests[0]] = CVal("scalar", dict(cv.lc))
                continue
            regs[ins.dests[0]] = _cast(s, cv,
                                       ins.as_type, lossy=op.endswith("lossy"))
        elif op == "hash.psd2":
            regs[ins.dests[0]] = _hash_psd(s, 2, operand(ins.operands[0]))
        elif op == "hash.psd4":
            regs[ins.dests[0]] = _hash_psd(s, 4, operand(ins.operands[0]))
        elif op == "call":
            name = ins.operands[0]
            cl = program.closures.get(name)
            if cl is None:
                raise SynthesisUnsupported(f"call target {name!r}")
            if depth >= _CALL_DEPTH_MAX:
                raise SynthesisUnsupported("closure call depth exceeded")
            args = [operand_any(t) for t in ins.operands[1:]]
            if len(args) != len(cl.inputs):
                raise SynthesisUnsupported(f"call {name}: input arity")
            cregs: dict = {}
            for (reg, ty, *_), av in zip(cl.inputs, args):
                base = ty.split(".")[0]
                have = (av.rec if isinstance(av, RecVal)
                        else av.struct if isinstance(av, StructVal)
                        else av.ty)
                if have != base:
                    raise SynthesisUnsupported(
                        f"call {name} input {reg}: {have} != {ty}")
                cregs[reg] = av
            _exec_body(s, program, caller_cv, cregs, cl.instructions,
                       depth + 1)
            _, cl_any = _make_operand(s, program, cregs, caller_cv)
            outs = [cl_any(tok) for tok, *_ in cl.outputs]
            if len(outs) != len(ins.dests):
                raise SynthesisUnsupported(f"call {name}: output arity")
            for d, ov in zip(ins.dests, outs):
                regs[d] = ov
        else:
            raise SynthesisUnsupported(f"instruction {op!r}")


def _synthesize(program: Program, fn: Function, cs: R1CS,
                z: list | None, args: list | None, caller_f: int | None,
                blind_seed: bytes | None = None):
    """Walk the function; identical allocation order in both modes."""
    s = _Synth(cs, z)
    # -- bind statement head -------------------------------------------------
    input_tys, regs = [], {}
    slot = 1
    fid_slot = cs.public(slot); slot += 1
    caller_slot = cs.public(slot); slot += 1
    caller_cv = CVal("address", {caller_slot: 1})
    cin_slot = cs.public(slot); slot += 1
    if z is not None:
        z[fid_slot] = function_id(program.id, fn.name)
        z[caller_slot] = caller_f
    n_rec_outs = sum(1 for spec in fn.outputs
                     if spec[1].split(".")[0] in program.records
                     and not ("/" in spec[1] or spec[1].endswith(".future")))
    blinds = derive_blinds(blind_seed or b"", n_rec_outs)
    priv_fields: list = []  # LinCombs absorbed into C_in (decl order)

    # -- bind inputs (slots interleaved in declaration order) ---------------
    for i, (reg, ty, vis) in enumerate(fn.inputs):
        base = ty.split(".")[0]
        if base in program.records:
            # record input: members are WITNESS wires absorbed into C_in;
            # a PUBLIC serial slot carries the in-circuit Poseidon spend
            # tag; ownership (owner == caller) enforced in-circuit
            rec = program.records[base]
            members = {}
            arg = args[i] if z is not None else None
            for mname, mty in rec.members.items():
                mbase = mty.split(".")[0]
                if mbase == "group":
                    mv = None
                    if z is not None:
                        mv = arg.val.get(mname)
                        if mv is None or mv.ty != "group":
                            raise V.HaltError(
                                f"record missing member {mname!r}")
                        mv = mv.val
                    gv = _witness_group(s, mv)
                    members[mname] = gv
                    priv_fields.extend([gv.x, gv.y])
                    continue
                if mbase not in CIRCUIT_TYPES:
                    raise SynthesisUnsupported(
                        f"record member type {mty!r}")
                mval = None
                if z is not None:
                    mv = arg.val.get(mname)
                    if mv is None:
                        raise V.HaltError(f"record missing member {mname!r}")
                    mval = value_to_public_field(mv)
                w = s.alloc(mval)
                cv = CVal(mbase, {w: 1})
                _constrain_literal(s, cv)
                members[mname] = cv
                priv_fields.append(cv.lc)
            # ownership: the record's owner must BE the (authenticated)
            # caller — reference semantics: only the owner can spend
            if z is not None and s.val(members["owner"].lc) != s.val(caller_cv.lc):
                raise V.HaltError("record is not owned by the caller")
            s.enforce(_lc_add(members["owner"].lc,
                              _lc_scale(caller_cv.lc, R - 1)),
                      {cs.one: 1}, {})
            # serial slot: Poseidon([rid, members...]) — the double-spend
            # tag is PUBLIC while the plaintext stays hidden
            serial_slot = cs.public(slot); slot += 1
            rid = record_id(program.id, base)
            member_lcs = []
            for m in rec.members:
                member_lcs.extend(cv.lc for cv in _leaf_cvals(members[m]))
            ser = s.sponge_hash1(
                SERIAL_DOMAIN, [{cs.one: rid}] + member_lcs)
            s.enforce(_lc_add(ser, {serial_slot: R - 1}), {cs.one: 1}, {})
            if z is not None:
                z[serial_slot] = s.val(ser)
            regs[reg] = RecVal(rec=base, members=members)
            input_tys.append(("record", base))
            continue
        if base == "group":
            # group input: PUBLIC takes two statement slots (x, y) with
            # an in-circuit on-curve constraint (prime-subgroup
            # membership validated host-side at parse, node/ledger
            # _parse_payload_value); PRIVATE is a witness point with the
            # full in-circuit subgroup ladder, absorbed into C_in
            if vis != "public":
                pt = None
                if z is not None:
                    if args[i].ty != "group":
                        raise V.HaltError(f"input {i}: expected group")
                    pt = args[i].val
                gv = _witness_group(s, pt)
                priv_fields.extend([gv.x, gv.y])
                regs[reg] = gv
                input_tys.append(("private", "group"))
                continue
            from snarkos_tpu_torch.crypto.ref import edwards as _ed

            px = cs.public(slot); slot += 1
            py = cs.public(slot); slot += 1
            if z is not None:
                if args[i].ty != "group":
                    raise V.HaltError(f"input {i}: expected group")
                z[px], z[py] = args[i].val[0] % R, args[i].val[1] % R
            gv = GroupVal(x={px: 1}, y={py: 1})
            # -x^2 + y^2 = 1 + d x^2 y^2
            x2 = s.mul(gv.x, gv.x)
            y2 = s.mul(gv.y, gv.y)
            x2y2 = s.mul(x2, y2)
            s.enforce(
                _lc_add(_lc_add(_lc_scale(x2, R - 1), y2),
                        _lc_add({cs.one: R - 1},
                                _lc_scale(x2y2, (R - _ed.D) % R))),
                {cs.one: 1}, {})
            regs[reg] = gv
            input_tys.append(("public", "field"))
            input_tys.append(("public", "field"))
            continue
        if base in program.structs:
            # struct input: one wire per (flat) member — PUBLIC structs
            # take one statement slot per member, PRIVATE structs absorb
            # every member into C_in
            st = program.structs[base]
            members = {}
            arg = args[i] if z is not None else None
            for mname, mty in st.members.items():
                mbase = mty.split(".")[0]
                if mbase not in CIRCUIT_TYPES:
                    raise SynthesisUnsupported(f"struct member type {mty!r}")
                mval = None
                if z is not None:
                    mv = arg.val.get(mname)
                    if mv is None or mv.ty != mty:
                        raise V.HaltError(f"struct missing member {mname!r}")
                    mval = value_to_public_field(mv)
                if vis == "public":
                    p = cs.public(slot); slot += 1
                    if z is not None:
                        z[p] = mval
                    cv = CVal(mbase, {p: 1})
                    _constrain_literal(s, cv)
                    input_tys.append(("public", mbase))
                else:
                    w = s.alloc(mval)
                    cv = CVal(mbase, {w: 1})
                    _constrain_literal(s, cv)
                    priv_fields.append(cv.lc)
                members[mname] = cv
            if vis != "public":
                input_tys.append(("private", base))
            regs[reg] = StructVal(struct=base, members=members)
            continue
        if base not in CIRCUIT_TYPES:
            raise SynthesisUnsupported(f"input type {ty!r}")
        if vis == "public":
            p = cs.public(slot); slot += 1
            if z is not None:
                z[p] = value_to_public_field(args[i])
            cv = CVal(base, {p: 1})
            _constrain_literal(s, cv)
            regs[reg] = cv
            input_tys.append(("public", base))
        else:
            # private literal: witness wire, absorbed into C_in
            w = s.alloc(value_to_public_field(args[i]) if z is not None
                        else None)
            cv = CVal(base, {w: 1})
            _constrain_literal(s, cv)
            priv_fields.append(cv.lc)
            regs[reg] = cv
            input_tys.append(("private", base))

    # -- C_in: hiding commitment to every private input field --------------
    if priv_fields:
        blind_w = s.alloc(blinds[0] if z is not None else None)
        c_in = s.sponge_hash1(PRIV_DOMAIN, priv_fields + [{blind_w: 1}])
        s.enforce(_lc_add(c_in, {cin_slot: R - 1}), {cs.one: 1}, {})
        if z is not None:
            z[cin_slot] = s.val(c_in)
    else:
        s.enforce({cin_slot: 1}, {cs.one: 1}, {})  # no private inputs: 0

    # -- instructions (shared dispatch; closures inline recursively) --------
    _exec_body(s, program, caller_cv, regs, fn.instructions)
    operand, operand_any = _make_operand(s, program, regs, caller_cv)

    # -- bind outputs --------------------------------------------------------
    output_tys, out_slots = [], []
    for tok in fn.finalize_args:
        av = operand_any(tok)
        if isinstance(av, RecVal):
            raise SynthesisUnsupported(f"record {tok!r} as finalize arg")
        # structs flatten: one statement slot per (flat) member
        for cv in _leaf_cvals(av):
            output_tys.append(("finalize", cv.ty))
            out_slots.append(cv)
    privout_fields: list = []
    rec_idx = 0
    rec_out_slots: list = []
    for out_spec in fn.outputs:
        tok, ty = out_spec[0], out_spec[1]
        vis = out_spec[2] if len(out_spec) > 2 else None
        if vis == "future" or ty.endswith(".future") or "/" in ty:
            continue  # future handle: finalize args already bound above
        base = ty.split(".")[0]
        if base in program.records:
            # record output: PUBLIC hiding commitment over the members
            rv = operand_any(tok)
            if not isinstance(rv, RecVal) or rv.rec != base:
                raise SynthesisUnsupported(f"output {tok!r} is not a {base}")
            blind_w = s.alloc(blinds[1][rec_idx] if z is not None else None)
            fields = []
            for m in program.records[base].members:
                fields.extend(cv.lc for cv in _leaf_cvals(rv.members[m]))
            comm = s.sponge_hash1(RECOUT_DOMAIN, fields + [{blind_w: 1}])
            rec_out_slots.append(("record_out", base, comm))
            output_tys.append(("record_out", base))
            rec_idx += 1
            continue
        if base == "group":
            gv = operand_any(tok)
            if not isinstance(gv, GroupVal):
                raise SynthesisUnsupported(f"output {tok!r} is not a group")
            for cv in _leaf_cvals(gv):
                if vis == "private":
                    privout_fields.append(cv.lc)
                    output_tys.append(("private_out", "field"))
                else:
                    output_tys.append(("output", "field"))
                    out_slots.append(cv)
            continue
        if base in program.structs:
            sv = operand_any(tok)
            if not isinstance(sv, StructVal) or sv.struct != base:
                raise SynthesisUnsupported(f"output {tok!r} is not a {base}")
            for cv in _leaf_cvals(sv):
                if vis == "private":
                    privout_fields.append(cv.lc)
                    output_tys.append(("private_out", cv.ty))
                else:
                    output_tys.append(("output", cv.ty))
                    out_slots.append(cv)
            continue
        if base not in CIRCUIT_TYPES:
            raise SynthesisUnsupported(f"output type {ty!r}")
        cv = operand(tok)
        if vis == "private":
            privout_fields.append(cv.lc)
            output_tys.append(("private_out", cv.ty))
        else:
            output_tys.append(("output", cv.ty))
            out_slots.append(cv)
    for cv in out_slots:
        p = cs.public(slot); slot += 1
        if z is not None:
            z[p] = s.val(cv.lc)
        # (out_lc - pub_slot) * 1 = 0
        s.enforce(_lc_add(cv.lc, {p: R - 1}), {cs.one: 1}, {})
    for _kind, _base, comm in rec_out_slots:
        p = cs.public(slot); slot += 1
        if z is not None:
            z[p] = s.val(comm)
        s.enforce(_lc_add(comm, {p: R - 1}), {cs.one: 1}, {})
    # C_privout: hiding commitment over private literal outputs (0 if none)
    cpriv_slot = cs.public(slot); slot += 1
    if privout_fields:
        blind_w = s.alloc(blinds[2] if z is not None else None)
        c_priv = s.sponge_hash1(PRIVOUT_DOMAIN,
                                privout_fields + [{blind_w: 1}])
        s.enforce(_lc_add(c_priv, {cpriv_slot: R - 1}), {cs.one: 1}, {})
        if z is not None:
            z[cpriv_slot] = s.val(c_priv)
    else:
        s.enforce({cpriv_slot: 1}, {cs.one: 1}, {})
    return input_tys, output_tys, slot


def _synth_sized(program: Program, fn: Function, num_public: int, n: int,
                 z_fill: tuple | None):
    cs = R1CS(num_public=num_public, n=n)
    if z_fill is None:
        tys = _synthesize(program, fn, cs, None, None, None)
        return cs, tys
    args, caller_f, blind_seed = z_fill
    z = [0] * n
    z[cs.one] = 1
    tys = _synthesize(program, fn, cs, z, args, caller_f, blind_seed)
    return cs, tys, z


def _layout(program: Program, fn: Function):
    """First pass at a generous size to learn the dimensions."""
    for probe_log in (14, 16, 18):
        probe = R1CS(num_public=256, n=1 << probe_log)
        try:
            in_tys, out_tys, slots = _synthesize(program, fn, probe,
                                                 None, None, None)
            break
        except (IndexError, AssertionError):
            if probe_log == 18:
                raise SynthesisUnsupported("function too large to probe")
    num_public = 1
    while num_public < slots:
        num_public *= 2
    need = max(probe.num_constraints + 1, probe._next_aux + num_public + 1,
               2 * num_public)
    n = 1 << max(need - 1, 1).bit_length()
    n = max(n, 2 * num_public, 16)
    return in_tys, out_tys, num_public, n


@functools.lru_cache(maxsize=64)
def _compile_cached(program_key: str, fn_name: str):
    program = _PROGRAMS[program_key]
    fn = program.functions[fn_name]
    in_tys, out_tys, num_public, n = _layout(program, fn)
    cs, _ = _synth_sized(program, fn, num_public, n, None)
    return FunctionCircuit(program_id=program.id, fn_name=fn_name, cs=cs,
                           input_tys=in_tys, output_tys=out_tys)


# content-hash -> Program, bounded: keyed by source digest so re-parses of
# the same deploy (deployment_vk_check parses fresh objects per gossip)
# dedupe, and adversarial deploy spam cannot grow it without bound
#. Sized above the lru_cache so live cache entries
# always find their program; FIFO eviction of the oldest beyond that.
_PROGRAMS: dict = {}
_PROGRAMS_MAX = 256


def compile_function(program: Program, fn_name: str) -> FunctionCircuit:
    """Compile (and cache) the circuit for ``program.fn_name``.
    Raises SynthesisUnsupported outside the provable subset."""
    import hashlib as _hashlib

    key = _hashlib.sha256(program.source.encode()).hexdigest()
    if key not in _PROGRAMS:
        while len(_PROGRAMS) >= _PROGRAMS_MAX:
            _PROGRAMS.pop(next(iter(_PROGRAMS)))
        _PROGRAMS[key] = program
    return _compile_cached(key, fn_name)


def trace_execution(program: Program, fn_name: str, args: list,
                    caller_field: int, blind_seed: bytes = b""):
    """Concrete witness for a compiled function. args: list[V.Value]
    (record inputs as record Values). ``blind_seed`` derives the hiding
    blinds of the private-input/record-output commitments. Returns
    (circuit, z, publics). Raises HaltError on a faulting trace (which
    is also unprovable) and SynthesisUnsupported as compile."""
    circ = compile_function(program, fn_name)
    fn = program.functions[fn_name]
    cs2, _tys, z = _synth_sized(program, fn, circ.cs.num_public, circ.cs.n,
                                (args, caller_field, blind_seed))
    publics = [z[cs2.public(i)] for i in range(cs2.num_public)]
    return circ, z, publics


def vk_digest(circuit: FunctionCircuit, srs, commit_fn=None) -> bytes:
    """Deployment verifying-key digest: sha256 over the Varuna index
    commitments (the 9 matrix-polynomial commitments that ARE the
    verifying key) plus the domain sizes.  Reference deployments carry
    per-function verifying keys certified at admission (snarkVM
    check_deployment, reached via ledger.rs:319-341). ``commit_fn`` makes
    the index's commitments when it is not cached (``varuna.get_index``)."""
    import hashlib as _hashlib

    from snarkos_tpu_torch.crypto.ref import g1 as _g1
    from snarkos_tpu_torch.crypto.ref import varuna as _varuna

    index = _varuna.get_index(srs, circuit.cs, commit_fn)
    h = _hashlib.sha256()
    h.update(f"{circuit.program_id}/{circuit.fn_name}".encode())
    h.update(index.n.to_bytes(8, "little") + index.k_size.to_bytes(8, "little"))
    for c in index.commitments:
        a = _g1.affine(c)
        if a is None:
            h.update(bytes(97))
        else:
            h.update(a[0].to_bytes(48, "little") + a[1].to_bytes(48, "little") + b"\x00")
    return h.digest()


def statement_parts(circuit: FunctionCircuit, publics: list) -> dict:
    """Split a traced statement vector into its named components (the
    inverse of build_publics' layout)."""
    pos = 1
    fid = publics[pos]; pos += 1
    caller = publics[pos]; pos += 1
    c_in = publics[pos]; pos += 1
    serials, pub_inputs = [], []
    for vis, _ty in circuit.input_tys:
        if vis == "record":
            serials.append(publics[pos]); pos += 1
        elif vis == "public":
            pub_inputs.append(publics[pos]); pos += 1
    n_out = sum(1 for k, _ in circuit.output_tys if k in ("finalize", "output"))
    outs = publics[pos:pos + n_out]; pos += n_out
    rec_comms = publics[pos:pos + circuit.n_record_outs]
    pos += circuit.n_record_outs
    c_privout = publics[pos]; pos += 1
    return {"fid": fid, "caller": caller, "c_in": c_in, "serials": serials,
            "public_inputs": pub_inputs, "outputs": outs,
            "rec_comms": rec_comms, "c_privout": c_privout}


def build_publics(circuit: FunctionCircuit, caller_field: int,
                  input_fields: list, output_fields: list,
                  c_in: int = 0, serials: list | None = None,
                  rec_out_comms: list | None = None,
                  c_privout: int = 0) -> list | None:
    """Verifier-side statement vector from payload-derived values; None
    when any arity disagrees with the circuit.

    ``input_fields``: the PUBLIC input literal fields in declaration
    order; ``serials``: one per record input, in declaration order (the
    two interleave into slots per input_tys); ``output_fields``: finalize
    args followed by PUBLIC output literal fields; ``rec_out_comms``:
    one commitment per record output; ``c_in``/``c_privout``: the
    private-input / private-output commitments (0 when absent)."""
    serials = serials or []
    rec_out_comms = rec_out_comms or []
    n_pub_in = sum(1 for v, _ in circuit.input_tys if v == "public")
    n_rec_in = sum(1 for v, _ in circuit.input_tys if v == "record")
    n_out = sum(1 for k, _ in circuit.output_tys if k in ("finalize", "output"))
    n_rec_out = circuit.n_record_outs
    if (len(input_fields) != n_pub_in or len(serials) != n_rec_in
            or len(output_fields) != n_out
            or len(rec_out_comms) != n_rec_out):
        return None
    slots = [1, function_id(circuit.program_id, circuit.fn_name),
             caller_field % R, c_in % R]
    it_pub, it_ser = iter(input_fields), iter(serials)
    for vis, _ty in circuit.input_tys:
        if vis == "record":
            slots.append(next(it_ser) % R)
        elif vis == "public":
            slots.append(next(it_pub) % R)
    slots += [v % R for v in output_fields]
    slots += [v % R for v in rec_out_comms]
    slots.append(c_privout % R)
    if len(slots) > circuit.cs.num_public:
        return None
    slots += [0] * (circuit.cs.num_public - len(slots))
    return slots
