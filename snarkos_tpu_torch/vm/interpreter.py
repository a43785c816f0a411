"""Interpreter for the Aleo-instructions subset: execute + on-chain finalize.

Capability analogue of snarkVM's ``VM::execute`` + ``finalize`` as reached
from the reference node (tx execution: node/src/validator/mod.rs:383-391;
speculation/finalization on block advance happens inside
``ledger.advance_to_next_block``, node/bft/ledger-service/src/ledger.rs:366-383).

Semantics:
- ``execute_function`` runs a function's instruction list over typed
  registers, returning outputs plus an optional FinalizeCall (from the
  function's ``async`` statement).
- ``execute_finalize`` runs the finalize block against a MappingStore
  (the on-chain state transition). Mapping writes are buffered and only
  applied on success — a HaltError rolls the whole transaction's finalize
  back, mirroring the reference's rejected/aborted transaction semantics.
- ``rand.chacha`` draws from a deterministic per-call stream seeded by
  (block height, transaction id, counter), so every validator computes
  the same state transition.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from snarkos_tpu_torch.vm import values as V
from snarkos_tpu_torch.vm.program import Closure, Finalize, Program
from snarkos_tpu_torch.vm.values import HaltError, Value

MAX_INSTRUCTIONS = 100_000  # finalize loop budget (branch/position can loop)


@dataclass
class FinalizeCall:
    program_id: str
    function: str
    args: list  # list[Value]


@dataclass
class ExecuteResult:
    outputs: list  # list[Value]
    finalize: FinalizeCall | None


class MappingStore:
    """Seam over the ledger's mapping state: string-keyed (program,
    mapping) -> {key_str: value_str}, values stored in canonical literal
    form so REST reads return printable values."""

    def __init__(self, backing: dict):
        self.backing = backing

    def get(self, program_id: str, mapping: str, key: str):
        return self.backing.get((program_id, mapping), {}).get(key)

    def set(self, program_id: str, mapping: str, key: str, value: str):
        self.backing.setdefault((program_id, mapping), {})[key] = value

    def remove(self, program_id: str, mapping: str, key: str):
        self.backing.get((program_id, mapping), {}).pop(key, None)

    def contains(self, program_id: str, mapping: str, key: str) -> bool:
        return key in self.backing.get((program_id, mapping), {})


def _value_to_fields(v: Value) -> list:
    """Canonical field-element encoding of a console value for hashing.

    Field values encode as THEMSELVES (one element) so the in-circuit
    Poseidon of vm/circuit.py can mirror hash.psd2 exactly; other types
    use the framework-own packing (the printable form's bytes in 31-byte
    field chunks, preceded by a type tag — injective per type)."""
    if v.ty == "field":
        return [v.val % V.FIELD_P]
    data = V.format_value(v).encode()
    out = [len(data)]
    for i in range(0, len(data), 31):
        out.append(int.from_bytes(data[i:i + 31], "little"))
    return out


class _Frame:
    def __init__(self):
        self.regs: dict[str, Value] = {}

    def get(self, tok: str) -> Value:
        if tok in self.regs:
            return self.regs[tok]
        if "." in tok and tok.split(".")[0] in self.regs:
            base, *path = tok.split(".")
            v = self.regs[base]
            for p in path:
                if not isinstance(v.val, dict) or p not in v.val:
                    raise HaltError(f"no member {p!r} in {base}")
                v = v.val[p]
            return v
        raise HaltError(f"unset register {tok!r}")

    def set(self, tok: str, v: Value):
        self.regs[tok] = v


@dataclass
class ExecContext:
    program: Program
    caller: str = "aleo1" + "0" * 64
    signer: str | None = None
    block_height: int = 0
    tx_seed: bytes = b"\x00" * 32
    # registry of on-chain programs for cross-program calls (imports);
    # None disables them
    programs: dict | None = None
    call_depth: int = 0
    _rand_counter: int = 0

    def special(self, tok: str) -> Value | None:
        if tok == "self.caller":
            return Value("address", self.caller)
        if tok == "self.signer":
            return Value("address", self.signer or self.caller)
        if tok == "block.height":
            return Value("u32", self.block_height & 0xFFFFFFFF)
        if tok == "network.id":
            return Value("u16", 0)
        return None

    def next_rand(self) -> bytes:
        self._rand_counter += 1
        return hashlib.sha256(
            self.tx_seed + self.block_height.to_bytes(8, "little")
            + self._rand_counter.to_bytes(8, "little")).digest()


def _operand(frame: _Frame, ctx: ExecContext, tok: str) -> Value:
    sp = ctx.special(tok)
    if sp is not None:
        return sp
    if tok.startswith("r") and tok[1:].split(".")[0].isdigit():
        return frame.get(tok)
    return V.parse_literal(tok)


def _hash_input_bytes(v: Value) -> bytes:
    return V.format_value(v).encode()


_BIN = {
    "add": V.add, "add.w": V.add_wrapped, "sub": V.sub, "sub.w": V.sub_wrapped,
    "mul": V.mul, "mul.w": V.mul_wrapped, "div": V.div, "div.w": V.div_wrapped,
    "rem": V.rem, "rem.w": V.rem, "mod": V.modulo,
    "pow": V.pow_, "pow.w": V.pow_wrapped,
    "shl": V.shl, "shl.w": V.shl_wrapped, "shr": V.shr, "shr.w": V.shr_wrapped,
}
_LOGIC = {"and", "or", "xor", "nand", "nor"}
_CMP = {"lt", "lte", "gt", "gte"}
_UNARY = {"abs": V.abs_, "abs.w": V.abs_wrapped, "neg": V.neg, "not": V.not_,
          "double": V.double, "square": V.square, "inv": V.inv}


def _run_instruction(ins, frame: _Frame, ctx: ExecContext):
    op = ins.op
    if op in _BIN:
        a, b = (_operand(frame, ctx, t) for t in ins.operands)
        frame.set(ins.dests[0], _BIN[op](a, b))
    elif op in _LOGIC:
        a, b = (_operand(frame, ctx, t) for t in ins.operands)
        frame.set(ins.dests[0], V.logical(op, a, b))
    elif op in _CMP:
        a, b = (_operand(frame, ctx, t) for t in ins.operands)
        frame.set(ins.dests[0], V.compare(op, a, b))
    elif op in _UNARY:
        frame.set(ins.dests[0], _UNARY[op](_operand(frame, ctx, ins.operands[0])))
    elif op == "ternary":
        c, a, b = (_operand(frame, ctx, t) for t in ins.operands)
        frame.set(ins.dests[0], V.ternary(c, a, b))
    elif op in ("is.eq", "is.neq"):
        a, b = (_operand(frame, ctx, t) for t in ins.operands)
        eq = V.eq_values(a, b)
        frame.set(ins.dests[0], Value("boolean", eq if op == "is.eq" else not eq))
    elif op in ("assert.eq", "assert.neq"):
        a, b = (_operand(frame, ctx, t) for t in ins.operands)
        eq = V.eq_values(a, b)
        if (op == "assert.eq") != eq:
            raise HaltError(f"{op} failed: {a} vs {b}")
    elif op in ("cast", "cast.lossy"):
        ty = ins.as_type
        base = ty.split(".")[0]
        composite = None
        if base in ctx.program.structs:
            composite = ctx.program.structs[base]
        elif base in ctx.program.records and ty.endswith(".record"):
            composite = ctx.program.records[base]
        if composite is not None:
            st = composite
            if len(ins.operands) != len(st.members):
                raise HaltError(f"cast to {ty}: wrong member count")
            members = {}
            for (name, mty), tok in zip(st.members.items(), ins.operands):
                v = _operand(frame, ctx, tok)
                if v.ty != mty:
                    raise HaltError(f"cast member {name}: {v.ty} != {mty}")
                members[name] = v
            frame.set(ins.dests[0], Value(base, members))
        else:
            if len(ins.operands) != 1:
                raise HaltError("cast expects one operand")
            v = _operand(frame, ctx, ins.operands[0])
            frame.set(ins.dests[0], V.cast(v, ty, lossy=op.endswith("lossy")))
    elif op in ("hash.psd2", "hash.psd4"):
        from snarkos_tpu_torch.crypto.ref import poseidon as ref_poseidon

        v = _operand(frame, ctx, ins.operands[0])
        rate = 2 if op.endswith("2") else 4
        h = ref_poseidon.hash1(_value_to_fields(v), rate=rate,
                               domain=f"snarkos_tpu.vm.{op}")
        frame.set(ins.dests[0], Value("field", h))
    elif op == "hash.bhp256":
        from snarkos_tpu_torch.crypto.ref import bhp as ref_bhp

        v = _operand(frame, ctx, ins.operands[0])
        h = ref_bhp.hash_bytes(V.format_value(v).encode(),
                               domain="snarkos_tpu.vm.hash.bhp256") % V.FIELD_P
        frame.set(ins.dests[0], Value("field", h))
    elif op == "commit.bhp256":
        from snarkos_tpu_torch.crypto.ref import bhp as ref_bhp

        v = _operand(frame, ctx, ins.operands[0])
        salt = _operand(frame, ctx, ins.operands[1])
        if salt.ty != "scalar":
            raise HaltError("commit salt must be scalar")
        data = V.format_value(v).encode() + b"\x00" + str(salt.val).encode()
        h = ref_bhp.hash_bytes(data,
                               domain="snarkos_tpu.vm.commit.bhp256") % V.FIELD_P
        frame.set(ins.dests[0], Value("field", h))
    elif op == "call":
        name = ins.operands[0]
        args = [_operand(frame, ctx, t) for t in ins.operands[1:]]
        if "/" in name:
            outs = _call_external(name, args, ctx)
        else:
            cl = ctx.program.closures.get(name)
            if cl is None:
                raise HaltError(f"unknown closure {name!r}")
            outs = _run_closure(cl, args, ctx)
        if len(outs) != len(ins.dests):
            raise HaltError(f"call {name}: {len(outs)} outputs, "
                            f"{len(ins.dests)} destinations")
        for d, v in zip(ins.dests, outs):
            frame.set(d, v)
    else:
        raise HaltError(f"unhandled instruction {op!r}")


def _bind_inputs(frame: _Frame, declared, args, what: str):
    if len(args) != len(declared):
        raise HaltError(f"{what}: expected {len(declared)} inputs, got {len(args)}")
    for decl, v in zip(declared, args):
        reg, ty = decl[0], decl[1]
        if ty in V.LITERAL_TYPES and v.ty != ty:
            raise HaltError(f"{what} input {reg}: {v.ty} != {ty}")
        frame.set(reg, v)


_CALL_DEPTH_MAX = 8


def program_address(program_id: str) -> str:
    """The deterministic address a program acts under when IT is the
    caller of a cross-program call (reference: snarkVM program addresses;
    `self.caller` in the callee is the calling program, `self.signer`
    stays the top-level account).  Derived from the program id, so no
    account can sign for it."""
    h = hashlib.sha256(b"snarkos_tpu.vm.progaddr" + program_id.encode())
    return "aleo1" + h.digest().hex()


def _call_external(name: str, args, ctx: ExecContext):
    """Cross-program call ``call <pid>/<fn> ...`` (requires ``import
    <pid>`` and the callee on-chain).  Supported callee shape: literal
    (non-record, non-struct) inputs and outputs and NO finalize block —
    the library-program pattern; richer compositions (record transfers,
    future composition) stay unsupported and halt."""
    pid, _, fname = name.partition("/")
    if pid not in ctx.program.imports:
        raise HaltError(f"call {name!r}: program {pid!r} is not imported")
    callee = (ctx.programs or {}).get(pid)
    if callee is None:
        raise HaltError(f"call {name!r}: imported program is not on-chain")
    fn = callee.functions.get(fname)
    if fn is None:
        raise HaltError(f"call {name!r}: no such function")
    if ctx.call_depth >= _CALL_DEPTH_MAX:
        raise HaltError("cross-program call depth exceeded")
    if fn.finalize_name is not None:
        raise HaltError(f"call {name!r}: callee finalize (future "
                        "composition) is not supported")
    for _r, ty, *_ in fn.inputs:
        if ty not in V.LITERAL_TYPES:
            raise HaltError(f"call {name!r}: non-literal input type {ty!r}")
    sub = ExecContext(program=callee, caller=program_address(ctx.program.id),
                      signer=ctx.signer or ctx.caller,
                      block_height=ctx.block_height, tx_seed=ctx.tx_seed,
                      programs=ctx.programs, call_depth=ctx.call_depth + 1)
    res = execute_function(callee, fname, args, sub)
    for v in res.outputs:
        if v.ty not in V.LITERAL_TYPES:
            raise HaltError(f"call {name!r}: non-literal output {v.ty!r}")
    return list(res.outputs)


def _run_closure(cl: Closure, args, ctx: ExecContext):
    frame = _Frame()
    _bind_inputs(frame, cl.inputs, args, f"closure {cl.name}")
    for ins in cl.instructions:
        _run_instruction(ins, frame, ctx)
    return [_operand(frame, ctx, tok) for tok, *_ in cl.outputs]


def execute_function(program: Program, fn_name: str, args, ctx: ExecContext
                     ) -> ExecuteResult:
    fn = program.functions.get(fn_name)
    if fn is None:
        raise HaltError(f"unknown function {fn_name!r}")
    frame = _Frame()
    _bind_inputs(frame, fn.inputs, args, f"function {fn_name}")
    for ins in fn.instructions:
        _run_instruction(ins, frame, ctx)
    outputs = []
    for tok, ty, *vis in fn.outputs:
        if (vis and vis[0] == "future") or ty.endswith("future") or "/" in ty:
            continue  # the future output is represented by FinalizeCall
        outputs.append(_operand(frame, ctx, tok))
    fin = None
    if fn.finalize_name:
        fin_args = [_operand(frame, ctx, t) for t in fn.finalize_args]
        fin = FinalizeCall(program_id=program.id, function=fn.finalize_name,
                           args=fin_args)
    return ExecuteResult(outputs=outputs, finalize=fin)


# -- records (private state; crypto/ref/records.py ECIES) --------------------


def parse_plaintext(text: str, members: dict) -> dict:
    """Parse a formatted FLAT composite value ``{ a: 1u64, b: aleo1... }``
    against a member spec (record or struct) -> member dict. Inverse of
    format_value for flat composites (nested composites unsupported)."""
    text = text.strip()
    if not (text.startswith("{") and text.endswith("}")):
        raise HaltError(f"bad composite literal: {text[:40]!r}")
    inner = text[1:-1].strip()
    parts = [p.strip() for p in inner.split(",") if p.strip()]
    if len(parts) != len(members):
        raise HaltError("composite member count mismatch")
    out = {}
    for part, (name, ty) in zip(parts, members.items()):
        key, _, val = part.partition(":")
        if key.strip() != name:
            raise HaltError(f"expected member {name!r}, got {key.strip()!r}")
        out[name] = V.parse_typed(val.strip(), ty)
    return out


def record_plaintext(v: Value) -> bytes:
    return V.format_value(v).encode()


def record_serial(program_id: str, record_name: str, v: Value) -> bytes:
    """Deterministic spend tag: consuming the same record plaintext twice
    is detectable ledger-side (the capability analogue of snarkVM serial
    numbers). Poseidon over [rid, member fields] — EXACTLY the relation
    vm/circuit.py enforces on record-input witness wires, so execution
    proofs derive the same serial in-circuit without revealing the
    plaintext. Records with members outside the circuit
    encoding fall back to the legacy sha256 tag (such records are only
    reachable through the public re-execution path anyway)."""
    from snarkos_tpu_torch.vm import circuit as vmc

    try:
        f = vmc.record_serial_field(program_id, record_name, v)
        return f.to_bytes(32, "little")
    except vmc.SynthesisUnsupported:
        return hashlib.sha256(
            b"snarkos_tpu.record.serial\x00" + program_id.encode() + b"/"
            + record_name.encode() + b"\x00" + record_plaintext(v)).digest()


def seal_record(program_id: str, record_name: str, v: Value) -> bytes:
    """ECIES-encrypt a record value to its owner -> b'record1' + blob."""
    from snarkos_tpu_torch.crypto.ref import records as ref_records
    from snarkos_tpu_torch.node.types import address_to_point

    owner = v.val.get("owner")
    if owner is None or owner.ty != "address":
        raise HaltError("record has no address owner")
    try:
        pk = address_to_point(owner.val)
    except (ValueError, AssertionError) as exc:
        raise HaltError(f"record owner is not a valid address: {exc}") from None
    body = (program_id + "/" + record_name + "\x00").encode() + record_plaintext(v)
    return b"record1" + ref_records.encrypt(pk, body)


def open_record(sk: int, blob: bytes, program: Program):
    """Decrypt a sealed record with the owner's view scalar -> (record
    name, Value). Raises ValueError if not the owner."""
    from snarkos_tpu_torch.crypto.ref import records as ref_records

    if not blob.startswith(b"record1"):
        raise ValueError("not a record blob")
    body = ref_records.decrypt(sk, blob[len(b"record1"):])
    head, _, plain = body.partition(b"\x00")
    pid, _, rname = head.decode().partition("/")
    rec = program.records.get(rname)
    if pid != program.id or rec is None:
        raise ValueError(f"record {rname!r} not of program {program.id!r}")
    members = parse_plaintext(plain.decode(), rec.members)
    return rname, Value(rname, members)


class _Buffered(MappingStore):
    """Write-buffer view: reads fall through to the base, writes/removes
    stage locally until commit()."""

    def __init__(self, base: MappingStore):
        self.base = base
        self.writes: dict = {}   # (p, m, k) -> value | None(removed)

    def get(self, p, m, k):
        key = (p, m, k)
        if key in self.writes:
            return self.writes[key]
        return self.base.get(p, m, k)

    def contains(self, p, m, k):
        key = (p, m, k)
        if key in self.writes:
            return self.writes[key] is not None
        return self.base.contains(p, m, k)

    def set(self, p, m, k, v):
        self.writes[(p, m, k)] = v

    def remove(self, p, m, k):
        self.writes[(p, m, k)] = None

    def commit(self):
        for (p, m, k), v in self.writes.items():
            if v is None:
                self.base.remove(p, m, k)
            else:
                self.base.set(p, m, k, v)


def execute_finalize(program: Program, call: FinalizeCall, store: MappingStore,
                     ctx: ExecContext) -> None:
    """Run the finalize block; atomically apply mapping writes on success,
    raise HaltError (no state change) on failure."""
    fin: Finalize = program.finalizes.get(call.function)
    if fin is None:
        raise HaltError(f"no finalize {call.function!r}")
    frame = _Frame()
    _bind_inputs(frame, fin.inputs, call.args, f"finalize {call.function}")
    buf = _Buffered(store)

    labels = {ins.label: i for i, ins in enumerate(fin.instructions)
              if ins.op == "position"}
    pc = 0
    steps = 0
    while pc < len(fin.instructions):
        steps += 1
        if steps > MAX_INSTRUCTIONS:
            raise HaltError("finalize instruction budget exceeded")
        ins = fin.instructions[pc]
        op = ins.op
        if op == "position":
            pc += 1
            continue
        if op in ("branch.eq", "branch.neq"):
            a = _operand(frame, ctx, ins.operands[0])
            b = _operand(frame, ctx, ins.operands[1])
            eq = V.eq_values(a, b)
            if (op == "branch.eq") == eq:
                if ins.label not in labels:
                    raise HaltError(f"unknown label {ins.label!r}")
                pc = labels[ins.label]
            else:
                pc += 1
            continue
        if op == "rand.chacha":
            seed_extra = b"".join(
                _hash_input_bytes(_operand(frame, ctx, t)) for t in ins.operands)
            raw = int.from_bytes(
                hashlib.sha256(ctx.next_rand() + seed_extra).digest(), "little")
            ty = ins.as_type
            if ty in V.INT_TYPES:
                frame.set(ins.dests[0], V.wrap_int(ty, raw))
            elif ty == "field":
                frame.set(ins.dests[0], Value("field", raw % V.FIELD_P))
            elif ty == "boolean":
                frame.set(ins.dests[0], Value("boolean", bool(raw & 1)))
            else:
                raise HaltError(f"rand.chacha as {ty} unsupported")
            pc += 1
            continue
        if op in ("contains", "get", "get.or_use", "set", "remove"):
            mp = program.mappings.get(ins.mapping)
            if mp is None:
                raise HaltError(f"unknown mapping {ins.mapping!r}")
            key_v = _operand(frame, ctx, ins.key)
            if key_v.ty != mp.key_type:
                raise HaltError(f"mapping {mp.name} key: {key_v.ty} != {mp.key_type}")
            key_s = V.format_value(key_v)
            if op == "contains":
                frame.set(ins.dests[0],
                          Value("boolean", buf.contains(program.id, mp.name, key_s)))
            elif op == "get":
                cur = buf.get(program.id, mp.name, key_s)
                if cur is None:
                    raise HaltError(f"get: missing key {key_s} in {mp.name}")
                frame.set(ins.dests[0], V.parse_typed(cur, mp.value_type))
            elif op == "get.or_use":
                cur = buf.get(program.id, mp.name, key_s)
                if cur is None:
                    dv = _operand(frame, ctx, ins.operands[0])
                    if dv.ty != mp.value_type:
                        raise HaltError("get.or_use default type mismatch")
                    frame.set(ins.dests[0], dv)
                else:
                    frame.set(ins.dests[0], V.parse_typed(cur, mp.value_type))
            elif op == "set":
                v = _operand(frame, ctx, ins.operands[0])
                if v.ty != mp.value_type:
                    raise HaltError(f"set: {v.ty} != {mp.value_type}")
                buf.set(program.id, mp.name, key_s, V.format_value(v))
            else:  # remove
                buf.remove(program.id, mp.name, key_s)
            pc += 1
            continue
        _run_instruction(ins, frame, ctx)
        pc += 1

    buf.commit()
