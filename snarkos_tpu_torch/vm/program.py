"""Parser for the Aleo-instructions program language (framework subset).

The reference node treats program sources as snarkVM ``Program<N>`` objects
(deployed via CLI developer deploy, cli/src/commands/developer/mod.rs:58-77,
and executed on-chain through ``ledger.vm()``,
node/src/validator/mod.rs:383-391). This parser accepts the
same surface grammar for the supported subset:

    program <id>.aleo;
    struct <name>:            # plaintext struct
        <member> as <type>;
    record <name>:            # private record (sealed to owner on commit)
        owner as address.private;
        <member> as <type>.<visibility>;
    mapping <name>:
        key as <type>.public;
        value as <type>.public;
    closure <name>:
        input r0 as <type>;
        <instructions>
        output r1 as <type>;
    function <name>:
        input r0 as <type>.{public|private};
        <instructions>
        async <name> <operands> into rN;      # schedule finalize
        output rN as <type>.{public|private} | <id>/<fn>.future;
    finalize <name>:
        input r0 as <type>.public;
        <instructions + mapping ops + branch/position>

Imports (`import <id>;` before the header) and cross-program calls
(`call <id>/<fn> ...`) are supported for library-shaped callees
(vm/interpreter._call_external); other unsupported snarkVM features
(signatures-in-programs) are rejected with a clear ParseError rather
than silently accepted.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from snarkos_tpu_torch.vm.values import LITERAL_TYPES


class ParseError(Exception):
    pass


_ID_RE = re.compile(r"^[a-z][a-z0-9_]*(\.aleo)?$")
_REG_RE = re.compile(r"^r\d+(\.[a-z][a-z0-9_]*)*$")

# instruction name -> operand count (None = variadic, checked by interpreter)
INSTRUCTIONS = {
    "abs": 1, "abs.w": 1, "add": 2, "add.w": 2, "and": 2,
    "assert.eq": 2, "assert.neq": 2, "cast": None, "cast.lossy": None,
    "div": 2, "div.w": 2, "double": 1, "gt": 2, "gte": 2,
    "hash.bhp256": 1, "hash.psd2": 1, "hash.psd4": 1,
    "commit.bhp256": 2, "inv": 1,
    "is.eq": 2, "is.neq": 2, "lt": 2, "lte": 2, "mod": 2,
    "mul": 2, "mul.w": 2, "nand": 2, "neg": 1, "nor": 2, "not": 1,
    "or": 2, "pow": 2, "pow.w": 2, "rem": 2, "rem.w": 2,
    "shl": 2, "shl.w": 2, "shr": 2, "shr.w": 2,
    "square": 1, "sub": 2, "sub.w": 2, "ternary": 3, "xor": 2,
    "call": None,
}

FINALIZE_ONLY = {"contains", "get", "get.or_use", "set", "remove",
                 "rand.chacha", "position", "branch.eq", "branch.neq"}


@dataclass
class Instruction:
    op: str
    operands: list          # raw tokens (registers/literals/specials)
    dests: list             # destination registers
    as_type: str | None = None   # for cast / rand.chacha
    mapping: str | None = None   # for mapping ops
    key: str | None = None       # mapping key operand token
    label: str | None = None     # for position / branch targets


@dataclass
class Mapping:
    name: str
    key_type: str
    value_type: str


@dataclass
class Struct:
    name: str
    members: dict  # name -> type


@dataclass
class Record:
    """Private-state record type: first member must be ``owner`` as
    address. Record outputs are sealed (ECIES-encrypted to the owner,
    crypto/ref/records.py) when the transaction commits."""

    name: str
    members: dict  # name -> type ('owner' first, type 'address')


@dataclass
class Function:
    name: str
    inputs: list            # [(register, type, visibility)]
    instructions: list = field(default_factory=list)
    outputs: list = field(default_factory=list)   # [(operand, type)]
    finalize_name: str | None = None
    finalize_args: list = field(default_factory=list)  # operand tokens of async


@dataclass
class Finalize:
    name: str
    inputs: list            # [(register, type)]
    instructions: list = field(default_factory=list)


@dataclass
class Closure:
    name: str
    inputs: list            # [(register, type)]
    instructions: list = field(default_factory=list)
    outputs: list = field(default_factory=list)   # [(operand, type)]


@dataclass
class Program:
    id: str
    structs: dict = field(default_factory=dict)
    records: dict = field(default_factory=dict)
    mappings: dict = field(default_factory=dict)
    closures: dict = field(default_factory=dict)
    functions: dict = field(default_factory=dict)
    finalizes: dict = field(default_factory=dict)
    imports: list = field(default_factory=list)  # imported program ids
    source: str = ""


def _strip(line: str) -> str:
    return line.split("//", 1)[0].strip().rstrip(";")


def _check_type(ty: str, program: "Program"):
    base = ty.split(".")[0]
    if (base not in LITERAL_TYPES and base not in program.structs
            and base not in program.records):
        raise ParseError(f"unknown type {ty!r}")


_MAPPING_OP_RE = re.compile(
    r"^(?P<op>contains|get\.or_use|get|set|remove)\s+(?P<rest>.*)$")
_BRACKET_RE = re.compile(r"^(?P<m>[a-z][a-z0-9_]*)\[(?P<k>[^\]]+)\]$")


def _parse_instruction(line: str, in_finalize: bool) -> Instruction:
    toks = line.split()
    op = toks[0]

    if op in ("position",):
        if not in_finalize:
            raise ParseError("position only allowed in finalize")
        return Instruction(op=op, operands=[], dests=[], label=toks[1])
    if op in ("branch.eq", "branch.neq"):
        if not in_finalize:
            raise ParseError(f"{op} only allowed in finalize")
        if len(toks) != 5 or toks[3] != "to":
            raise ParseError(f"bad branch: {line!r}")
        return Instruction(op=op, operands=[toks[1], toks[2]], dests=[],
                           label=toks[4])
    if op == "rand.chacha":
        if not in_finalize:
            raise ParseError("rand.chacha only allowed in finalize")
        # rand.chacha [operands...] into rN as <type>
        if "into" not in toks or toks[-2] != "as":
            raise ParseError(f"bad rand.chacha: {line!r}")
        i = toks.index("into")
        return Instruction(op=op, operands=toks[1:i], dests=[toks[i + 1]],
                           as_type=toks[-1])

    m = _MAPPING_OP_RE.match(line)
    if m and (m.group("op") in FINALIZE_ONLY):
        if not in_finalize:
            raise ParseError(f"{m.group('op')} only allowed in finalize")
        mop = m.group("op")
        rest = m.group("rest").split()
        if mop in ("contains", "get"):
            # <op> mapping[key] into rN
            br = _BRACKET_RE.match(rest[0])
            if not br or len(rest) != 3 or rest[1] != "into":
                raise ParseError(f"bad {mop}: {line!r}")
            return Instruction(op=mop, operands=[], dests=[rest[2]],
                               mapping=br.group("m"), key=br.group("k"))
        if mop == "get.or_use":
            br = _BRACKET_RE.match(rest[0])
            if not br or len(rest) != 4 or rest[2] != "into":
                raise ParseError(f"bad get.or_use: {line!r}")
            return Instruction(op=mop, operands=[rest[1]], dests=[rest[3]],
                               mapping=br.group("m"), key=br.group("k"))
        if mop == "set":
            # set rV into mapping[key]
            if len(rest) != 3 or rest[1] != "into":
                raise ParseError(f"bad set: {line!r}")
            br = _BRACKET_RE.match(rest[2])
            if not br:
                raise ParseError(f"bad set target: {line!r}")
            return Instruction(op=mop, operands=[rest[0]], dests=[],
                               mapping=br.group("m"), key=br.group("k"))
        if mop == "remove":
            br = _BRACKET_RE.match(rest[0])
            if not br or len(rest) != 1:
                raise ParseError(f"bad remove: {line!r}")
            return Instruction(op=mop, operands=[], dests=[],
                               mapping=br.group("m"), key=br.group("k"))

    if op not in INSTRUCTIONS:
        raise ParseError(f"unknown instruction {op!r}")

    if "into" not in toks:
        if op.startswith("assert."):
            return Instruction(op=op, operands=toks[1:], dests=[])
        raise ParseError(f"missing 'into': {line!r}")
    i = toks.index("into")
    operands, rest = toks[1:i], toks[i + 1:]
    as_type = None
    if op in ("cast", "cast.lossy", "rand.chacha"):
        if len(rest) != 3 or rest[1] != "as":
            raise ParseError(f"bad cast: {line!r}")
        dests, as_type = [rest[0]], rest[2]
    else:
        dests = rest
        arity = INSTRUCTIONS[op]
        if arity is not None and len(operands) != arity:
            raise ParseError(f"{op} expects {arity} operands: {line!r}")
        if op != "call" and len(dests) != 1:
            raise ParseError(f"{op} expects one destination: {line!r}")
    return Instruction(op=op, operands=operands, dests=dests, as_type=as_type)


def parse_program(source: str) -> Program:
    lines = [_strip(l) for l in source.splitlines()]
    lines = [(i + 1, l) for i, l in enumerate(lines) if l]
    if not lines:
        raise ParseError("empty program")
    # import declarations precede the program header (snarkVM layout:
    # `import credits.aleo;` — the imported program must exist on-chain
    # at deploy time, node/ledger.py enforces it)
    imports = []
    while lines and lines[0][1].startswith("import "):
        no, l = lines.pop(0)
        dep = l[len("import "):].strip()
        if not _ID_RE.match(dep):
            raise ParseError(f"line {no}: bad import id {dep!r}")
        if dep in imports:
            raise ParseError(f"line {no}: duplicate import {dep!r}")
        imports.append(dep)
    if not lines:
        raise ParseError("empty program")
    for no, l in lines:
        if l.startswith("import"):
            raise ParseError(f"line {no}: 'import' must precede the header")

    no, head = lines[0]
    if not head.startswith("program "):
        raise ParseError("program header missing")
    pid = head[len("program "):].strip()
    if not _ID_RE.match(pid):
        raise ParseError(f"bad program id {pid!r}")
    if pid in imports:
        raise ParseError("program cannot import itself")
    prog = Program(id=pid, imports=imports, source=source)

    ctx = None  # current block object
    kind = None
    for no, line in lines[1:]:
        try:
            if line.startswith("record "):
                ctx = Record(name=line.split()[1].rstrip(":"), members={})
                prog.records[ctx.name] = ctx
                kind = "record"
            elif line.startswith("struct "):
                ctx = Struct(name=line.split()[1].rstrip(":"), members={})
                prog.structs[ctx.name] = ctx
                kind = "struct"
            elif line.startswith("mapping "):
                ctx = Mapping(name=line.split()[1].rstrip(":"), key_type="",
                              value_type="")
                prog.mappings[ctx.name] = ctx
                kind = "mapping"
            elif line.startswith("closure "):
                ctx = Closure(name=line.split()[1].rstrip(":"), inputs=[])
                prog.closures[ctx.name] = ctx
                kind = "closure"
            elif line.startswith("function "):
                ctx = Function(name=line.split()[1].rstrip(":"), inputs=[])
                prog.functions[ctx.name] = ctx
                kind = "function"
            elif line.startswith("finalize "):
                name = line.split()[1].rstrip(":")
                if name not in prog.functions:
                    raise ParseError(f"finalize {name!r} has no function")
                ctx = Finalize(name=name, inputs=[])
                prog.finalizes[name] = ctx
                kind = "finalize"
            elif kind == "struct":
                m = re.match(r"^([a-z][a-z0-9_]*) as ([a-z0-9_.]+)$", line)
                if not m:
                    raise ParseError(f"bad struct member: {line!r}")
                _check_type(m.group(2), prog)
                ctx.members[m.group(1)] = m.group(2)
            elif kind == "record":
                m = re.match(
                    r"^([a-z][a-z0-9_]*) as ([a-z0-9_]+)(\.(public|private))?$",
                    line)
                if not m:
                    raise ParseError(f"bad record member: {line!r}")
                _check_type(m.group(2), prog)
                if not ctx.members and (m.group(1) != "owner"
                                        or m.group(2) != "address"):
                    raise ParseError(
                        "record's first member must be 'owner as address'")
                ctx.members[m.group(1)] = m.group(2)
            elif kind == "mapping":
                m = re.match(r"^(key|value) as ([a-z0-9_]+)\.public$", line)
                if not m:
                    raise ParseError(f"bad mapping line: {line!r}")
                _check_type(m.group(2), prog)
                if m.group(1) == "key":
                    ctx.key_type = m.group(2)
                else:
                    ctx.value_type = m.group(2)
            elif line.startswith("input "):
                m = re.match(
                    r"^input (r\d+) as ([a-z0-9_]+)(\.(public|private|record))?$", line)
                if not m:
                    raise ParseError(f"bad input: {line!r}")
                _check_type(m.group(2), prog)
                if kind == "function":
                    ctx.inputs.append((m.group(1), m.group(2), m.group(4) or "private"))
                elif kind in ("closure", "finalize"):
                    ctx.inputs.append((m.group(1), m.group(2)))
                else:
                    raise ParseError("input outside block")
            elif line.startswith("output "):
                m = re.match(
                    r"^output (\S+) as ([a-z0-9_./]+?)(\.(public|private|future|record))?$",
                    line)
                if not m or kind not in ("function", "closure"):
                    raise ParseError(f"bad output: {line!r}")
                # keep the declared visibility (default private — Aleo
                # semantics; the circuit layer hides .private outputs)
                ctx.outputs.append(
                    (m.group(1), m.group(2), m.group(4) or "private"))
            elif line.startswith("async "):
                if kind != "function":
                    raise ParseError("async outside function")
                toks = line.split()
                if "into" not in toks:
                    raise ParseError(f"bad async: {line!r}")
                i = toks.index("into")
                ctx.finalize_name = toks[1]
                ctx.finalize_args = toks[2:i]
                if ctx.finalize_name != ctx.name:
                    raise ParseError("async must target the enclosing function")
            else:
                if kind not in ("function", "closure", "finalize"):
                    raise ParseError(f"instruction outside block: {line!r}")
                ctx.instructions.append(
                    _parse_instruction(line, in_finalize=(kind == "finalize")))
        except ParseError as exc:
            raise ParseError(f"line {no}: {exc}") from None

    for mp in prog.mappings.values():
        if not mp.key_type or not mp.value_type:
            raise ParseError(f"mapping {mp.name!r} missing key/value")
    for fin in prog.finalizes.values():
        fn = prog.functions[fin.name]
        if fn.finalize_name != fin.name:
            raise ParseError(f"function {fin.name!r} has finalize but no async")
    for fn in prog.functions.values():
        if fn.finalize_name and fn.finalize_name not in prog.finalizes:
            raise ParseError(f"async {fn.finalize_name!r} has no finalize block")
    return prog
