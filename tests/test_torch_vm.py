"""The port's VM (snarkos_tpu_torch/vm) and state tree against the JAX
package's, on the CPU: the same programs parse alike, execute to the same
outputs and finalize effects on seeded inputs, compile to the same R1CS,
and the two state trees give the same roots on the same inserts. Every
comparison is exact (formatted values, mapping contents, bytes)."""

import numpy as np
import pytest

from snarkos_tpu import vm as jvm
from snarkos_tpu.node import ledger as jledger, state_tree as jst, types as jtypes
from snarkos_tpu.vm import circuit as jcircuit
from snarkos_tpu_torch import vm
from snarkos_tpu_torch.crypto.ref import edwards
from snarkos_tpu_torch.node import ledger, state_tree as st, types
from snarkos_tpu_torch.vm import circuit

TALLY_SRC = """program tally.aleo;

mapping tally:
    key as u64.public;
    value as u64.public;

function bump:
    input r0 as u64.public;
    input r1 as field.private;
    mul r1 r1 into r2;
    hash.psd2 r2 into r3;
    async bump r0 into r4;
    output r3 as field.public;
    output r4 as tally.aleo/bump.future;

finalize bump:
    input r0 as u64.public;
    get.or_use tally[r0] 0u64 into r1;
    add r1 1u64 into r2;
    set r2 into tally[r0];
"""


def _addresses(seed, n):
    rng = np.random.default_rng(seed)
    return [edwards.Account.new(seed=rng.bytes(32)).address for _ in range(n)]


def _run(mod, src, fn, args, mappings, caller):
    """Execute ``fn`` and its finalize against ``mappings`` in one VM:
    (formatted outputs, finalize args, mappings after)."""
    prog = mod.parse_program(src)
    ctx = mod.ExecContext(program=prog, caller=caller, block_height=3, tx_seed=b"seed",
                          programs={prog.id: prog})
    vals = [mod.parse_typed(tok, ty) for tok, (_r, ty, _v) in zip(args, prog.functions[fn].inputs)]
    res = mod.execute_function(prog, fn, vals, ctx)
    store = {k: dict(v) for k, v in mappings.items()}
    fin = None
    if res.finalize is not None:
        fin = [mod.format_value(v) for v in res.finalize.args]
        mod.execute_finalize(prog, res.finalize, mod.MappingStore(store), ctx)
    return [mod.format_value(v) for v in res.outputs], fin, store


CASES = [  # (function, args from the seeded addresses a0..a2 and amounts)
    ("transfer_public", lambda a, n: [a[1], f"{n}u64"]),
    ("bond_public", lambda a, n: [f"{n}u64"]),
    ("unbond_public", lambda a, n: [f"{n // 2}u64"]),
    ("transfer_public_to_private", lambda a, n: [a[2], f"{n}u64"]),
]


@pytest.mark.parametrize("fn,make_args", CASES, ids=[c[0] for c in CASES])
def test_credits_functions_execute_alike(fn, make_args):
    addrs = _addresses(11, 3)
    n = int(np.random.default_rng(5).integers(1, 1000))
    caller = addrs[0]
    mappings = {("credits.aleo", "account"): {caller: "10000u64"},
                ("credits.aleo", "bonded"): {caller: "500u64"}}
    args = make_args(addrs, n)
    out_j = _run(jvm, jledger.CREDITS_PROGRAM, fn, args, mappings, caller)
    out_p = _run(vm, ledger.CREDITS_PROGRAM, fn, args, mappings, caller)
    assert out_p == out_j
    assert out_p[2] != mappings or fn == "transfer_public_to_private"


def test_finalize_program_executes_alike():
    rng = np.random.default_rng(3)
    caller = _addresses(12, 1)[0]
    mappings = {("tally.aleo", "tally"): {"7u64": "4u64"}}
    for key in (7, int(rng.integers(0, 1 << 60))):
        args = [f"{key}u64", f"{int(rng.integers(1, 1 << 62))}field"]
        out_j = _run(jvm, TALLY_SRC, "bump", args, mappings, caller)
        out_p = _run(vm, TALLY_SRC, "bump", args, mappings, caller)
        assert out_p == out_j
        assert out_p[2][("tally.aleo", "tally")][f"{key}u64"] == (
            "5u64" if key == 7 else "1u64")


def test_halt_alike():
    """A u64 underflow in finalize halts both VMs."""
    caller = _addresses(13, 1)[0]
    mappings = {("credits.aleo", "account"): {caller: "3u64"}}
    for mod, src in ((jvm, jledger.CREDITS_PROGRAM), (vm, ledger.CREDITS_PROGRAM)):
        with pytest.raises(mod.HaltError):
            _run(mod, src, "bond_public", ["4u64"], mappings, caller)


def test_private_record_transfer_alike():
    """transfer_private on a seeded record: the same record outputs and
    serial in both VMs."""
    addrs = _addresses(14, 2)
    outs = []
    for mod in (jvm, vm):
        prog = mod.parse_program((jledger if mod is jvm else ledger).CREDITS_PROGRAM)
        rec = mod.Value("credits", {"owner": mod.parse_literal(addrs[0]),
                                    "microcredits": mod.Value("u64", 900)})
        ctx = mod.ExecContext(program=prog, caller=addrs[0], block_height=1, tx_seed=b"s")
        res = mod.execute_function(prog, "transfer_private",
                                   [rec, mod.parse_literal(addrs[1]), mod.Value("u64", 250)],
                                   ctx)
        outs.append(([mod.format_value(v) for v in res.outputs],
                      mod.record_serial(prog.id, "credits", rec)))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("fn", ["transfer_public", "bond_public"])
def test_compile_function_same_r1cs(fn):
    cj = jcircuit.compile_function(jledger.credits_program(), fn)
    cp = circuit.compile_function(ledger.credits_program(), fn)
    assert (cp.cs.n, cp.cs.num_public) == (cj.cs.n, cj.cs.num_public)
    for rows_p, rows_j in ((cp.cs.rows_a, cj.cs.rows_a), (cp.cs.rows_b, cj.cs.rows_b),
                           (cp.cs.rows_c, cj.cs.rows_c)):
        assert [list(r.items()) for r in rows_p] == [list(r.items()) for r in rows_j]
    assert (cp.input_tys, cp.output_tys) == (cj.input_tys, cj.output_tys)


def test_trace_execution_alike():
    """The witness and statement of a traced transfer_public agree."""
    addrs = _addresses(15, 2)
    res = []
    for mod, lmod, cmod in ((jvm, jledger, jcircuit), (vm, ledger, circuit)):
        prog = lmod.credits_program()
        args = [mod.parse_literal(addrs[1]), mod.Value("u64", 77)]
        _c, z, publics = cmod.trace_execution(prog, "transfer_public", args,
                                              cmod.address_field(addrs[0]), b"blind")
        res.append((z, publics))
    assert res[0] == res[1]


def test_state_trees_same_roots():
    """Both trees over the same blocks and mapping states: the same root at
    every height, and the same inclusion paths."""
    rng = np.random.default_rng(21)
    members = {a: 100 for a in _addresses(16, 4)}
    jt, pt = jst.StateTree(), st.StateTree()
    comm_j, comm_p = jtypes.Committee.new(1, members), types.Committee.new(1, members)
    blk_j, blk_p = jtypes.genesis_block(comm_j), types.genesis_block(comm_p)
    mappings = {}
    for h in range(4):
        payloads = [rng.bytes(int(rng.integers(1, 40))) for _ in range(int(rng.integers(0, 4)))]
        tx = [dict(payload=p, fee=h, auth_tag=int(rng.integers(0, 1 << 62)), proof=b"\x00" * 8)
              for p in payloads]
        if h:
            blk_j = jtypes.Block(height=h, previous_hash=blk_j.hash, timestamp=h, round=2 * h,
                                 epoch_hash=b"\x05" * 32, proof_target=256, subdag=None,
                                 transmissions=tuple(jtypes.Transmission.from_transaction(
                                     jtypes.Transaction(**t)) for t in tx))
            blk_p = types.Block.from_bytes(blk_j.to_bytes())
        key = f"{int(rng.integers(0, 50))}u64"
        mappings.setdefault(("p.aleo", "m"), {})[key] = f"{h}u64"
        assert pt.append_block(blk_p, mappings) == jt.append_block(blk_j, mappings)
        assert pt.state_roots == jt.state_roots
    assert pt.mapping_path("p.aleo", "m", key) == jt.mapping_path("p.aleo", "m", key)
    assert st.verify_mapping_path(pt.mapping_path("p.aleo", "m", key))
