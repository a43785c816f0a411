"""Typed console values for the Aleo-instructions program layer.

The reference node executes programs through snarkVM's console/synthesizer
types (reached from snarkOS at e.g. node/src/validator/mod.rs:383-391
``ledger.vm().execute`` and the CLI developer deploy/execute commands,
cli/src/commands/developer/mod.rs:58-77). This module is the
framework's own value model with the same observable arithmetic semantics:
checked integer ops that HALT on overflow (with explicit ``.w`` wrapping
variants), field/scalar arithmetic over the BLS12-377 scalar field and the
Edwards-BLS12 subgroup for ``group``/``address``.

Representation choices that intentionally differ from snarkVM's byte-level
encodings (this framework defines its own wire formats throughout,
node/types.py): ``<n>group`` literals denote ``n * GEN`` rather than an
x-coordinate recovery, and addresses are the framework's aleo1+hex form.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from snarkos_tpu_torch.crypto import params
from snarkos_tpu_torch.crypto.ref import edwards

FIELD_P = params.FR_MODULUS          # console "field" = Fr of BLS12-377


class HaltError(Exception):
    """Raised when a checked operation faults (overflow, div by zero,
    failed assert) — the transaction's execution is aborted."""


INT_TYPES = {
    "u8": (8, False), "u16": (16, False), "u32": (32, False),
    "u64": (64, False), "u128": (128, False),
    "i8": (8, True), "i16": (16, True), "i32": (32, True),
    "i64": (64, True), "i128": (128, True),
}

LITERAL_TYPES = set(INT_TYPES) | {"boolean", "field", "scalar", "group", "address"}


def _int_bounds(ty: str) -> tuple[int, int]:
    bits, signed = INT_TYPES[ty]
    if signed:
        return -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    return 0, (1 << bits) - 1


@dataclass(frozen=True)
class Value:
    ty: str          # one of LITERAL_TYPES or a struct name
    val: Any         # int | bool | tuple (edwards point) | dict (struct)

    def __str__(self) -> str:
        return format_value(self)


def _scalar_order() -> int:
    # order of the Edwards-BLS12 prime subgroup (console "scalar")
    return edwards.ORDER


def check_int(ty: str, v: int) -> Value:
    lo, hi = _int_bounds(ty)
    if not (lo <= v <= hi):
        raise HaltError(f"{ty} overflow: {v}")
    return Value(ty, v)


def wrap_int(ty: str, v: int) -> Value:
    bits, signed = INT_TYPES[ty]
    v &= (1 << bits) - 1
    if signed and v >= (1 << (bits - 1)):
        v -= 1 << bits
    return Value(ty, v)


def parse_literal(tok: str) -> Value:
    """``5u64`` / ``true`` / ``1field`` / ``2group`` / ``aleo1...`` /
    ``3scalar`` / ``-7i8``."""
    if tok == "true":
        return Value("boolean", True)
    if tok == "false":
        return Value("boolean", False)
    if tok.startswith("aleo1"):
        # framework address form: aleo1 + 64 hex chars (a 32-byte compressed
        # encoding). Reject malformed forms HERE so both the prove and the
        # verify side fail identically at parse time.
        hexpart = tok[5:]
        if len(hexpart) != 64:
            raise HaltError(f"malformed address {tok!r}")
        try:
            bytes.fromhex(hexpart)
        except ValueError as exc:
            raise HaltError(f"malformed address {tok!r}") from exc
        return Value("address", tok)
    for ty in ("field", "scalar", "group"):
        if tok.endswith(ty):
            num = tok[: -len(ty)]
            try:
                v = int(num)
            except ValueError as exc:
                raise HaltError(f"bad literal {tok!r}") from exc
            if ty == "field":
                return Value("field", v % FIELD_P)
            if ty == "scalar":
                return Value("scalar", v % _scalar_order())
            return Value("group", edwards.scalar_mul(v % _scalar_order(), edwards.GENERATOR))
    for ty in INT_TYPES:
        if tok.endswith(ty) and tok[: -len(ty)].lstrip("-").isdigit():
            return check_int(ty, int(tok[: -len(ty)]))
    raise HaltError(f"bad literal {tok!r}")


def format_value(v: Value) -> str:
    if v.ty == "boolean":
        return "true" if v.val else "false"
    if v.ty == "address":
        return v.val
    if v.ty == "group":
        # canonical printable form: compressed point hex tagged as group
        return edwards.compress(v.val).hex() + "group"
    if isinstance(v.val, dict):  # struct
        inner = ", ".join(f"{k}: {format_value(x)}" for k, x in v.val.items())
        return "{ " + inner + " }"
    return f"{v.val}{v.ty}"


def parse_typed(tok: str, ty: str) -> Value:
    """Parse a token against an expected type (used for function inputs
    and mapping keys arriving as strings)."""
    if ty == "group" and tok.endswith("group") and len(tok) == 69:
        # compressed-point hex form emitted by format_value: exactly
        # 64 hex chars (32-byte point) + the "group" suffix
        return Value("group", edwards.decompress(bytes.fromhex(tok[:-5])))
    v = parse_literal(tok)
    if v.ty != ty:
        raise HaltError(f"type mismatch: {tok!r} is {v.ty}, expected {ty}")
    return v


# -- arithmetic --------------------------------------------------------------


def _as_int(a: Value) -> int:
    if a.ty not in INT_TYPES:
        raise HaltError(f"expected integer, got {a.ty}")
    return a.val


def _same(a: Value, b: Value):
    if a.ty != b.ty:
        raise HaltError(f"type mismatch: {a.ty} vs {b.ty}")


def add(a: Value, b: Value) -> Value:
    _same(a, b)
    if a.ty in INT_TYPES:
        return check_int(a.ty, a.val + b.val)
    if a.ty == "field":
        return Value("field", (a.val + b.val) % FIELD_P)
    if a.ty == "scalar":
        return Value("scalar", (a.val + b.val) % _scalar_order())
    if a.ty == "group":
        return Value("group", edwards.add(a.val, b.val))
    raise HaltError(f"add unsupported for {a.ty}")


def add_wrapped(a: Value, b: Value) -> Value:
    _same(a, b)
    return wrap_int(a.ty, _as_int(a) + _as_int(b))


def sub(a: Value, b: Value) -> Value:
    _same(a, b)
    if a.ty in INT_TYPES:
        return check_int(a.ty, a.val - b.val)
    if a.ty == "field":
        return Value("field", (a.val - b.val) % FIELD_P)
    if a.ty == "scalar":
        return Value("scalar", (a.val - b.val) % _scalar_order())
    if a.ty == "group":
        return Value("group", edwards.add(a.val, edwards.neg(b.val)))
    raise HaltError(f"sub unsupported for {a.ty}")


def sub_wrapped(a: Value, b: Value) -> Value:
    _same(a, b)
    return wrap_int(a.ty, _as_int(a) - _as_int(b))


def mul(a: Value, b: Value) -> Value:
    if a.ty == "group" and b.ty == "scalar":
        return Value("group", edwards.scalar_mul(b.val, a.val))
    if a.ty == "scalar" and b.ty == "group":
        return Value("group", edwards.scalar_mul(a.val, b.val))
    _same(a, b)
    if a.ty in INT_TYPES:
        return check_int(a.ty, a.val * b.val)
    if a.ty == "field":
        return Value("field", (a.val * b.val) % FIELD_P)
    if a.ty == "scalar":
        return Value("scalar", (a.val * b.val) % _scalar_order())
    raise HaltError(f"mul unsupported for {a.ty}")


def mul_wrapped(a: Value, b: Value) -> Value:
    _same(a, b)
    return wrap_int(a.ty, _as_int(a) * _as_int(b))


def div(a: Value, b: Value) -> Value:
    if a.ty in INT_TYPES:
        _same(a, b)
        if b.val == 0:
            raise HaltError("division by zero")
        q = abs(a.val) // abs(b.val)
        if (a.val < 0) != (b.val < 0):
            q = -q
        return check_int(a.ty, q)  # catches iN::MIN / -1
    if a.ty == "field":
        _same(a, b)
        if b.val == 0:
            raise HaltError("field division by zero")
        return Value("field", a.val * pow(b.val, -1, FIELD_P) % FIELD_P)
    raise HaltError(f"div unsupported for {a.ty}")


def div_wrapped(a: Value, b: Value) -> Value:
    _same(a, b)
    if _as_int(b) == 0:
        raise HaltError("division by zero")
    q = abs(a.val) // abs(b.val)
    if (a.val < 0) != (b.val < 0):
        q = -q
    return wrap_int(a.ty, q)


def rem(a: Value, b: Value) -> Value:
    _same(a, b)
    if _as_int(b) == 0:
        raise HaltError("rem by zero")
    bits, signed = INT_TYPES[a.ty]
    if signed and b.val == -1 and a.val == -(1 << (bits - 1)):
        # snarkVM checked_rem: iN::MIN rem -1 is overflow, not 0
        raise HaltError("rem overflow")
    q = abs(a.val) // abs(b.val)
    if (a.val < 0) != (b.val < 0):
        q = -q
    return check_int(a.ty, a.val - q * b.val)


def modulo(a: Value, b: Value) -> Value:
    _same(a, b)
    bits, signed = INT_TYPES[a.ty]
    if signed:
        raise HaltError("mod requires unsigned operands")
    if b.val == 0:
        raise HaltError("mod by zero")
    return Value(a.ty, a.val % b.val)


def pow_(a: Value, b: Value) -> Value:
    if a.ty == "field":
        if b.ty != "field":
            raise HaltError("field pow exponent must be field")
        return Value("field", pow(a.val, b.val, FIELD_P))
    if a.ty in INT_TYPES:
        if b.ty not in ("u8", "u16", "u32"):
            raise HaltError("integer pow exponent must be u8/u16/u32")
        return check_int(a.ty, a.val ** b.val)
    raise HaltError(f"pow unsupported for {a.ty}")


def pow_wrapped(a: Value, b: Value) -> Value:
    if b.ty not in ("u8", "u16", "u32"):
        raise HaltError("integer pow exponent must be u8/u16/u32")
    return wrap_int(a.ty, _as_int(a) ** b.val)


def shl(a: Value, b: Value) -> Value:
    bits, _ = INT_TYPES[a.ty]
    if b.ty not in ("u8", "u16", "u32"):
        raise HaltError("shift amount must be u8/u16/u32")
    if b.val >= bits:
        raise HaltError("shift amount exceeds bit width")
    return check_int(a.ty, _as_int(a) << b.val)


def shl_wrapped(a: Value, b: Value) -> Value:
    bits, _ = INT_TYPES[a.ty]
    if b.ty not in ("u8", "u16", "u32"):
        raise HaltError("shift amount must be u8/u16/u32")
    return wrap_int(a.ty, _as_int(a) << (b.val % bits))


def shr(a: Value, b: Value) -> Value:
    bits, _ = INT_TYPES[a.ty]
    if b.ty not in ("u8", "u16", "u32"):
        raise HaltError("shift amount must be u8/u16/u32")
    if b.val >= bits:
        raise HaltError("shift amount exceeds bit width")
    return Value(a.ty, _as_int(a) >> b.val)


def shr_wrapped(a: Value, b: Value) -> Value:
    bits, _ = INT_TYPES[a.ty]
    if b.ty not in ("u8", "u16", "u32"):
        raise HaltError("shift amount must be u8/u16/u32")
    return Value(a.ty, _as_int(a) >> (b.val % bits))


def neg(a: Value) -> Value:
    if a.ty in INT_TYPES:
        return check_int(a.ty, -_as_int(a))
    if a.ty == "field":
        return Value("field", (-a.val) % FIELD_P)
    if a.ty == "group":
        return Value("group", edwards.neg(a.val))
    raise HaltError(f"neg unsupported for {a.ty}")


def abs_(a: Value) -> Value:
    return check_int(a.ty, abs(_as_int(a)))


def abs_wrapped(a: Value) -> Value:
    return wrap_int(a.ty, abs(_as_int(a)))


def double(a: Value) -> Value:
    if a.ty == "field":
        return Value("field", (2 * a.val) % FIELD_P)
    if a.ty == "group":
        return Value("group", edwards.add(a.val, a.val))
    raise HaltError(f"double unsupported for {a.ty}")


def square(a: Value) -> Value:
    if a.ty != "field":
        raise HaltError("square requires field")
    return Value("field", a.val * a.val % FIELD_P)


def inv(a: Value) -> Value:
    if a.ty != "field":
        raise HaltError("inv requires field")
    if a.val == 0:
        raise HaltError("inverse of zero")
    return Value("field", pow(a.val, -1, FIELD_P))


def _bool(a: Value) -> bool:
    if a.ty != "boolean":
        raise HaltError(f"expected boolean, got {a.ty}")
    return a.val


def logical(op: str, a: Value, b: Value) -> Value:
    if a.ty == "boolean":
        x, y = _bool(a), _bool(b)
        return Value("boolean", {
            "and": x and y, "or": x or y, "xor": x != y,
            "nand": not (x and y), "nor": not (x or y),
        }[op])
    # bitwise on integers
    _same(a, b)
    bits, signed = INT_TYPES[a.ty]
    mask = (1 << bits) - 1
    x, y = a.val & mask, b.val & mask
    r = {"and": x & y, "or": x | y, "xor": x ^ y,
         "nand": (~(x & y)) & mask, "nor": (~(x | y)) & mask}[op]
    return wrap_int(a.ty, r)


def not_(a: Value) -> Value:
    if a.ty == "boolean":
        return Value("boolean", not a.val)
    bits, _ = INT_TYPES[a.ty]
    return wrap_int(a.ty, ~a.val)


def compare(op: str, a: Value, b: Value) -> Value:
    _same(a, b)
    if a.ty not in INT_TYPES and a.ty not in ("field", "scalar"):
        raise HaltError(f"compare unsupported for {a.ty}")
    x, y = a.val, b.val
    return Value("boolean", {
        "lt": x < y, "lte": x <= y, "gt": x > y, "gte": x >= y,
    }[op])


def eq_values(a: Value, b: Value) -> bool:
    return a.ty == b.ty and a.val == b.val


def cast(a: Value, ty: str, lossy: bool = False) -> Value:
    """Numeric casts with Aleo semantics: checked range (halt) unless
    ``lossy``, which truncates to the destination width."""
    if ty == a.ty:
        return a
    if a.ty == "boolean":
        v = int(a.val)
    elif a.ty in INT_TYPES or a.ty in ("field", "scalar"):
        v = a.val
    elif a.ty == "group" and ty == "field":
        # x-coordinate projection (framework convention)
        return Value("field", a.val[0] % FIELD_P)
    else:
        raise HaltError(f"cast {a.ty} -> {ty} unsupported")
    if ty in INT_TYPES:
        if lossy:
            return wrap_int(ty, v)
        return check_int(ty, v)
    if ty == "field":
        return Value("field", v % FIELD_P)
    if ty == "scalar":
        if not lossy and v >= _scalar_order():
            raise HaltError("cast overflow to scalar")
        return Value("scalar", v % _scalar_order())
    if ty == "boolean":
        if v in (0, 1):
            return Value("boolean", bool(v))
        raise HaltError("cast to boolean requires 0/1")
    if ty == "group":
        return Value("group", edwards.scalar_mul(v % _scalar_order(), edwards.GENERATOR))
    raise HaltError(f"cast to {ty} unsupported")


def ternary(c: Value, a: Value, b: Value) -> Value:
    _same(a, b)
    return a if _bool(c) else b
