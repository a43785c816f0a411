"""Ledger: the chain state machine + the LedgerService seams (the port of
``snarkos_tpu/node/ledger.py``).

Re-creates the reference's ledger abstraction (SURVEY.md §2.6,
node/bft/ledger-service/src/traits.rs:30-123) with four implementations:
``CoreLedgerService`` (real chain), ``MockLedgerService`` (fixed committee,
no verification — BFT unit tests), ``TranslucentLedgerService`` (skips
check_next_block — devnet e2e), ``ProverLedgerService`` (solution checks
only). The chain itself is an append-only block log with in-memory
indices.

Its device work runs on the ledger's ``device`` (None: the card, and no
card raises; tests pass "cpu", where every kernel runs its plain version):
  - the solutions' epoch binding, ``Puzzle.check_binding`` of
    ``global_puzzle(device=...)`` (B1's sponge, epoch program and
    multiplies);
  - the block's one KZG batch, ``ops/kzg.batch_verify`` (two device MSMs,
    two host pairings); the pinpointing loop after a failed batch stays on
    the host;
  - every Varuna commitment, the indexes' included: ``device_commit``, the
    fused MSM engine over the SRS powers (``ops/kzg.commit``);
  - the SRSs above the puzzle's degree, built from the dev tau by the
    per-lane scalar multiply (``PuzzleSRS.dev_powers``).
The Varuna polynomial arithmetic, the transcripts, the VM, the state tree and
the pairings run on the host.
"""

from __future__ import annotations

import hashlib
import os
import threading
from typing import Optional

import torch

from snarkos_tpu_torch.crypto import params
from snarkos_tpu_torch.crypto.ref import g1 as ref_g1, kzg as ref_kzg, poseidon as ref_poseidon
from snarkos_tpu_torch.node import types
from snarkos_tpu_torch.node.types import (
    Block,
    Committee,
    Solution,
    Subdag,
    Transaction,
    Transmission,
    TransmissionID,
    genesis_block,
    sha256d,
)
from snarkos_tpu_torch.ops import _build, g1 as g1_ops, kzg as kzg_ops
from snarkos_tpu_torch.ops.fieldspec import FR
from snarkos_tpu_torch.ops.puzzle import PuzzleSRS, global_puzzle

R = params.FR_MODULUS
TX_CHALLENGE_DOMAIN = "snarkos_tpu.transaction.challenge"

MAX_SOLUTIONS_PER_BLOCK = 4

# Dynamic committee (reference: committees derive from on-chain bonding with
# per-round lookback — ledger-service/src/ledger.rs:156-198, snarkVM
# Committee::COMMITTEE_LOOKBACK_RANGE). The lookback keeps every validator's
# view of "the committee for round r" stable while bonding transactions land.
COMMITTEE_LOOKBACK_RANGE = 100
# minimum bonded stake to enter the committee (reference MIN_VALIDATOR_STAKE
# is 1M credits; scaled to this build's dev-genesis stake unit)
MIN_VALIDATOR_STAKE = 100

# the all-zero address: the unauthenticated default caller (no private key
# exists for it, so it can never control funds or bonded state)
ZERO_ADDRESS = "aleo1" + "0" * 64
CALLER_AUTH_DOMAIN = b"snarkos_tpu.caller.auth"


def caller_auth_message(payload_without_sig: bytes, fee: int) -> bytes:
    """The bytes a caller signs to authorize an execute payload: the full
    payload with its own sig token removed, bound to the fee."""
    return CALLER_AUTH_DOMAIN + fee.to_bytes(8, "little") + payload_without_sig


def _check_caller_auth(tx: "Transaction", caller: str, sig_tok: str | None) -> None:
    """Verify the caller's Schnorr signature over (payload minus sig token,
    fee). The reference binds the caller via the execution authorization
    inside the proof (snarkVM); an unauthenticated caller token would let
    any party debit arbitrary accounts. Raises
    vm.HaltError (aborting the transaction's state transition) on failure."""
    from snarkos_tpu_torch import vm as avm
    from snarkos_tpu_torch.crypto.ref import edwards
    from snarkos_tpu_torch.node.types import address_to_point

    if not sig_tok:
        raise avm.HaltError("missing caller signature")
    raw = sig_tok[len("sig:"):]
    try:
        sig = (int(raw[:64], 16), int(raw[64:128], 16))
        if len(raw) != 128:
            raise ValueError("bad signature length")
        pk = address_to_point(caller)
    except Exception:
        raise avm.HaltError("malformed caller signature") from None
    unsigned = tx.payload.replace((" " + sig_tok).encode(), b"", 1)
    if not edwards.verify_bytes(pk, caller_auth_message(unsigned, tx.fee), sig):
        raise avm.HaltError("caller signature verification failed")

# -- genesis quorum synthesis -------------------------------------------------
# The reference synthesizes a dev genesis with vm.genesis_quorum
# (cli/src/commands/start.rs:764-767): a block carrying the credits program
# state — committee bonding, public balances — plus proven deployment. Here
# the genesis block carries a Varuna-proven deployment of the framework's
# credits.aleo (the staking/balances program, executable by the on-chain VM,
# snarkos_tpu_torch/vm), and block-0 indexing applies the ratification-equivalent
# bonding state for every committee member (bonded/committee/account
# mappings), so a fresh node answers the same program/mapping queries the
# reference answers at height 0.

GENESIS_STARTING_BALANCE = 10_000_000_000  # public credits per member
_GENESIS_TX_KEY = 0x6765_6E65_7369_73  # deterministic: same tx on every node

CREDITS_PROGRAM = """\
program credits.aleo;

mapping account:
    key as address.public;
    value as u64.public;

mapping bonded:
    key as address.public;
    value as u64.public;

mapping committee:
    key as address.public;
    value as boolean.public;

record credits:
    owner as address.private;
    microcredits as u64.private;

function transfer_public:
    input r0 as address.public;
    input r1 as u64.public;
    async transfer_public self.caller r0 r1 into r2;
    output r2 as credits.aleo/transfer_public.future;

finalize transfer_public:
    input r0 as address.public;
    input r1 as address.public;
    input r2 as u64.public;
    get account[r0] into r3;
    sub r3 r2 into r4;
    set r4 into account[r0];
    get.or_use account[r1] 0u64 into r5;
    add r5 r2 into r6;
    set r6 into account[r1];

function transfer_public_to_private:
    input r0 as address.private;
    input r1 as u64.public;
    cast r0 r1 into r2 as credits.record;
    async transfer_public_to_private self.caller r1 into r3;
    output r2 as credits.record;
    output r3 as credits.aleo/transfer_public_to_private.future;

finalize transfer_public_to_private:
    input r0 as address.public;
    input r1 as u64.public;
    get account[r0] into r2;
    sub r2 r1 into r3;
    set r3 into account[r0];

function transfer_private:
    input r0 as credits.record;
    input r1 as address.private;
    input r2 as u64.private;
    sub r0.microcredits r2 into r3;
    cast r0.owner r3 into r4 as credits.record;
    cast r1 r2 into r5 as credits.record;
    output r4 as credits.record;
    output r5 as credits.record;

function transfer_private_to_public:
    input r0 as credits.record;
    input r1 as address.public;
    input r2 as u64.public;
    sub r0.microcredits r2 into r3;
    cast r0.owner r3 into r4 as credits.record;
    async transfer_private_to_public r1 r2 into r5;
    output r4 as credits.record;
    output r5 as credits.aleo/transfer_private_to_public.future;

finalize transfer_private_to_public:
    input r0 as address.public;
    input r1 as u64.public;
    get.or_use account[r0] 0u64 into r2;
    add r2 r1 into r3;
    set r3 into account[r0];

function bond_public:
    input r0 as u64.public;
    async bond_public self.caller r0 into r1;
    output r1 as credits.aleo/bond_public.future;

finalize bond_public:
    input r0 as address.public;
    input r1 as u64.public;
    get account[r0] into r2;
    sub r2 r1 into r3;
    set r3 into account[r0];
    get.or_use bonded[r0] 0u64 into r4;
    add r4 r1 into r5;
    set r5 into bonded[r0];

function unbond_public:
    input r0 as u64.public;
    async unbond_public self.caller r0 into r1;
    output r1 as credits.aleo/unbond_public.future;

finalize unbond_public:
    input r0 as address.public;
    input r1 as u64.public;
    get bonded[r0] into r2;
    sub r2 r1 into r3;
    set r3 into bonded[r0];
    get account[r0] into r4;
    add r4 r1 into r5;
    set r5 into account[r0];
"""

_GENESIS_CACHE: dict[bytes, Block] = {}
# the process-wide lazy builds (the genesis, the authorization circuit's
# context, the execution SRSs) happen once: validators that share a process
# check from several executor threads at once
_LAZY_LOCK = threading.RLock()


def make_genesis(committee: Committee, device=None) -> Block:
    """Genesis block carrying the proven credits.aleo deployment
    (vm.genesis_quorum capability; deterministic across validators: the
    same bytes on every device). Cached per committee id."""
    device = _build.resolve_device(device)
    with _LAZY_LOCK:
        cached = _GENESIS_CACHE.get(committee.id)
        if cached is None:
            import dataclasses

            deploy = create_transaction(CREDITS_PROGRAM.encode(), is_deploy=True,
                                        key=_GENESIS_TX_KEY, device=device)
            cached = dataclasses.replace(
                genesis_block(committee),
                transmissions=(Transmission(types.TX_TRANSACTION, deploy.to_bytes()),),
            )
            _GENESIS_CACHE[committee.id] = cached
        return cached


def transaction_challenge(payload: bytes, commitment: bytes) -> int:
    """Fiat-Shamir opening point binding the payload to the commitment."""
    ph = int.from_bytes(hashlib.sha256(payload).digest(), "little") % R
    cx = int.from_bytes(commitment[:48], "little") % R
    return ref_poseidon.hash1([ph, cx], rate=2, domain=TX_CHALLENGE_DOMAIN)


class Ledger:
    """The chain: blocks, indices, committee, epoch state. Its checks run
    their device work on ``device`` (None: the card; raises without one)."""

    def __init__(self, committee: Committee, storage_path: Optional[str] = None,
                 device=None):
        self.device = _build.resolve_device(device)
        self.committee = committee
        # committee history [(starting_round, Committee)] ascending: entry i
        # governs rounds starting_round_i .. starting_round_{i+1}-1. Rebuilt
        # deterministically from the chain (bonding state) on load/replay.
        self.committee_history: list[tuple[int, Committee]] = [(0, committee)]
        self.storage_path = storage_path
        self.blocks: list[Block] = []
        self.block_index: dict[bytes, int] = {}
        self.committed_ids: set[TransmissionID] = set()
        self.committed_cert_ids: set[bytes] = set()
        # program store (reference: snarkVM program/mapping state reached via
        # REST lib.rs:132-191 program routes). Deploy transactions whose
        # payload is b"program <id>\n<source>" register a program; execute
        # transactions with payload b"call <id>/<mapping> <key>=<value>"
        # update that program's mapping. Rebuilt deterministically from the
        # committed chain on load.
        self.programs: dict[str, str] = {}
        self.parsed_programs: dict[str, object] = {}  # id -> vm.Program
        self.mappings: dict[tuple[str, str], dict[str, str]] = {}
        self.aborted_tx_ids: set[bytes] = set()  # failed execute/finalize
        # private records: sealed outputs per height + spend tags of
        # consumed record inputs (snarkVM records capability; the spend
        # proof-in-circuit is the Varuna layer's job — here the plaintext
        # rides the payload and the serial blocks replays)
        self.record_ciphertexts: dict[int, list[bytes]] = {}
        self.spent_serials: set[bytes] = set()
        # Merkle ledger state tree (reference routes.rs:252-269): per-height
        # roots over (block history + transmission ids + mapping state),
        # rebuilt deterministically during replay by _index_block.
        from snarkos_tpu_torch.node.state_tree import StateTree

        self.state_tree = StateTree()
        self.lock = threading.RLock()
        self._load_or_init()

    # -- persistence ---------------------------------------------------------
    def _load_or_init(self):
        loaded = False
        if self.storage_path and os.path.exists(self.storage_path):
            with open(self.storage_path, "rb") as f:
                data = f.read()
            pos = 0
            while pos + 4 <= len(data):
                ln = int.from_bytes(data[pos : pos + 4], "little")
                blk = Block.from_bytes(data[pos + 4 : pos + 4 + ln])
                self._index_block(blk)
                pos += 4 + ln
            loaded = bool(self.blocks)
        if not loaded:
            self._index_block(make_genesis(self.committee, self.device))
            self._persist(self.blocks[0])

    def _persist(self, block: Block):
        if not self.storage_path:
            return
        os.makedirs(os.path.dirname(self.storage_path) or ".", exist_ok=True)
        raw = block.to_bytes()
        with open(self.storage_path, "ab") as f:
            f.write(len(raw).to_bytes(4, "little") + raw)

    def _index_block(self, block: Block):
        self.blocks.append(block)
        self.block_index[block.hash] = block.height
        for t in block.transmissions:
            self.committed_ids.add(t.id)
            if t.kind == types.TX_TRANSACTION:
                try:
                    self._apply_program_ops(t.deserialize(), block.height)
                except Exception:
                    pass  # non-program payloads carry arbitrary bytes
        if block.subdag:
            for cert in block.subdag.all_certificates():
                self.committed_cert_ids.add(cert.id)
        # state root AFTER this block's program ops are applied
        self.state_tree.append_block(block, self.mappings)
        if block.height == 0:
            self._apply_genesis_ratifications()
        self._update_committee_from_state(block)

    def _update_committee_from_state(self, block: Block) -> None:
        """Derive the committee from the credits.aleo bonding mappings after
        each committed block (reference: committees come from on-chain
        bonding, updated at block boundaries; ledger-service/src/ledger.rs
        get_committee_for_round reads them back per starting round).

        Membership = bonded stake >= MIN_VALIDATOR_STAKE, capped at
        MAX_COMMITTEE_SIZE by stake. A change appends a new committee
        STARTING AT block.round + 1 (it can never retroactively govern
        rounds at or before the block that introduced it)."""
        bonded = self.mappings.get(("credits.aleo", "bonded"), {})
        members: dict[str, int] = {}
        for addr, v in bonded.items():
            try:
                stake = int(v.removesuffix("u64"))
            except ValueError:
                continue
            if stake >= MIN_VALIDATOR_STAKE:
                members[addr] = stake
        if not members:
            return  # a committee can never become empty; keep the last one
        if len(members) > Committee.MAX_COMMITTEE_SIZE:
            top = sorted(members.items(), key=lambda kv: (-kv[1], kv[0]))
            members = dict(top[: Committee.MAX_COMMITTEE_SIZE])
        # reflect derived membership in the on-chain committee mapping
        cmap = self.mappings.setdefault(("credits.aleo", "committee"), {})
        for addr in list(cmap):
            if addr not in members:
                cmap[addr] = "false"
        for addr in members:
            cmap[addr] = "true"
        current = {a: s for a, s, _ in self.committee.members}
        if members == current:
            return
        starting = max(block.round + 1, self.committee_history[-1][0] + 1)
        new = Committee.new(starting, members)
        self.committee_history.append((starting, new))
        self.committee = new

    def committee_for_round(self, round_: int) -> Committee:
        """The committee governing ``round_``: the last history entry whose
        starting round is <= round_ (ledger.rs get_committee_for_round)."""
        import bisect

        idx = bisect.bisect_right(self.committee_history, round_,
                                  key=lambda e: e[0]) - 1
        return self.committee_history[max(idx, 0)][1]

    def committee_lookback_for_round(self, round_: int) -> Committee:
        """Reference lookback semantics (ledger.rs:185-198): committees are
        updated in even rounds, so look back from round-1 (even) / round-2
        (odd), then a further COMMITTEE_LOOKBACK_RANGE rounds."""
        previous = round_ - 1 if round_ % 2 == 0 else round_ - 2
        lookback = max(previous - COMMITTEE_LOOKBACK_RANGE, 0)
        return self.committee_for_round(lookback)

    def _apply_genesis_ratifications(self) -> None:
        """Block-0 bonding state (the reference's genesis ratifications,
        produced by vm.genesis_quorum): every committee member is bonded at
        its stake, marked in the committee mapping, and funded with a
        public starting balance."""
        for addr, stake, _open in self.committee.members:
            self.mappings.setdefault(("credits.aleo", "bonded"), {})[addr] = f"{stake}u64"
            self.mappings.setdefault(("credits.aleo", "committee"), {})[addr] = "true"
            self.mappings.setdefault(("credits.aleo", "account"), {})[addr] = \
                f"{GENESIS_STARTING_BALANCE}u64"

    def _apply_program_ops(self, tx: Transaction, block_height: int = 0) -> None:
        """Deterministic program-state transition for committed transactions.

        Deploys carrying a well-formed Aleo-instructions source are parsed
        and registered for execution (snarkos_tpu_torch/vm); executes of the form
        ``execute <program>/<function> [caller:<addr> sig:<hex>] [args...]``
        (signature REQUIRED for non-zero callers — see _check_caller_auth;
        build with create_transaction(account=...)) run the function
        and its finalize block against the mapping store — a halt aborts the
        transaction's state transition (recorded in aborted_tx_ids) without
        rejecting the block, mirroring the reference's aborted-transaction
        semantics on advance (ledger-service/src/ledger.rs:366-383).
        Legacy trivial payload forms (raw deploy source, ``call p/m k=v``)
        remain accepted for non-program byte payloads.
        """
        from snarkos_tpu_torch import vm as avm

        payload = tx.payload
        if tx.is_deploy and _is_program_source(payload):
            source = payload.decode(errors="replace")
            try:
                prog = avm.parse_program(source)
                # imports must resolve against programs already on-chain
                # (or deployed earlier in this block) — reference rejects
                # deployments with missing imports; here the deploy aborts
                # (aborted_tx_ids) without rejecting the block
                if any(dep not in self.parsed_programs
                       for dep in prog.imports):
                    self.aborted_tx_ids.add(tx.id.digest)
                    return
                if prog.id not in self.programs:
                    self.programs[prog.id] = source
                    self.parsed_programs[prog.id] = prog
                return
            except avm.ParseError:
                pass  # legacy raw-source deploy below
            if not payload.startswith(b"program "):
                return  # malformed import-prefixed source: ignore
            head, _, src = payload.partition(b"\n")
            program_id = head[len(b"program "):].strip().decode()
            if program_id and program_id not in self.programs:
                self.programs[program_id] = src.decode(errors="replace")
        elif not tx.is_deploy and payload.startswith(b"execute "):
            body = payload[len(b"execute "):].decode(errors="replace")
            toks = body.split()
            program_id, _, fn_name = toks[0].partition("/")
            prog = self.parsed_programs.get(program_id)
            if prog is None or not fn_name:
                return
            args_toks = toks[1:]
            # the caller is a DISTINCT `caller:<addr>` token (never inferred
            # from a bare address argument — ambiguous and
            # unauthenticated), optionally followed by its `sig:<hex>` token
            caller = ZERO_ADDRESS
            sig_tok = None
            if args_toks and args_toks[0].startswith("caller:"):
                caller = args_toks[0][len("caller:"):]
                args_toks = args_toks[1:]
                if args_toks and args_toks[0].startswith("sig:"):
                    sig_tok, args_toks = args_toks[0], args_toks[1:]
            ctx = avm.ExecContext(program=prog, caller=caller,
                                  block_height=block_height,
                                  tx_seed=tx.id.digest,
                                  programs=self.parsed_programs)
            try:
                # a non-zero caller must prove control of the address: the
                # reference binds the caller cryptographically inside the
                # execution authorization (snarkVM); here the equivalent is
                # a Schnorr signature over (payload minus sig token, fee)
                if caller != ZERO_ADDRESS:
                    _check_caller_auth(tx, caller, sig_tok)
                fn = prog.functions.get(fn_name)
                if fn is None:
                    raise avm.HaltError(f"unknown function {fn_name!r}")
                if len(args_toks) != len(fn.inputs):
                    raise avm.HaltError("input arity mismatch")
                # SNARK-verified path: a transaction carrying a (gossip/
                # block-admission-verified) execution proof for a provable
                # function commits WITHOUT re-executing the body — the
                # claimed finalize args are exactly what the proof binds
                # (reference semantics: the transition proof enforces the
                # function, finalize runs on-chain, ledger.rs:366-383).
                # Record inputs arrive as PUBLIC serial tokens (the proof
                # derives them in-circuit from the hidden plaintext);
                # record outputs as commitments + sealed ciphertexts.
                if tx.exec_proof and exec_circuit_for(prog, fn_name, self.device) is not None:
                    claimed = _parse_exec_outs(prog, fn_name, tx.exec_outs)
                    if claimed is None:
                        raise avm.HaltError("malformed exec outputs")
                    serials = []
                    for t, (_r, ty, _v) in zip(args_toks, fn.inputs):
                        if ty in prog.records:
                            if not t.startswith("serial:"):
                                raise avm.HaltError("record input needs serial")
                            raw = bytes.fromhex(t[len("serial:"):])
                            if raw in self.spent_serials or raw in serials:
                                raise avm.HaltError("record already spent")
                            serials.append(raw)
                    if fn.finalize_name is not None:
                        n_fin = len(prog.finalizes[fn.finalize_name].inputs)
                        call = avm.FinalizeCall(
                            program_id=prog.id, function=fn.finalize_name,
                            args=claimed["values"][:n_fin])
                        store = avm.MappingStore(self.mappings)
                        avm.execute_finalize(prog, call, store, ctx)
                    self.spent_serials.update(serials)
                    for ct in claimed["rec_cts"]:
                        self.record_ciphertexts.setdefault(
                            block_height, []).append(ct)
                    return
                args, serials = [], []
                for t, (_, ty, _) in zip(args_toks, fn.inputs):
                    if ty in prog.records:
                        if not t.startswith("record:"):
                            raise avm.HaltError("record input must be record:<hex>")
                        from snarkos_tpu_torch.vm.values import Value as VmValue

                        text = bytes.fromhex(t[len("record:"):]).decode()
                        members = avm.parse_plaintext(
                            text, prog.records[ty].members)
                        val = VmValue(ty, members)
                        serial = avm.record_serial(prog.id, ty, val)
                        if serial in self.spent_serials or serial in serials:
                            # covers both previously-committed spends AND the
                            # same record passed twice in ONE transaction
                            raise avm.HaltError("record already spent")
                        serials.append(serial)
                        args.append(val)
                    else:
                        # same parser as the SNARK path: plain:<hex>
                        # structs and the group subgroup gate apply to
                        # re-executed functions too
                        args.append(_parse_payload_value(prog, t, ty))
                result = avm.execute_function(prog, fn_name, args, ctx)
                if result.finalize is not None:
                    store = avm.MappingStore(self.mappings)
                    avm.execute_finalize(prog, result.finalize, store, ctx)
                self.spent_serials.update(serials)
                for out in result.outputs:
                    if out.ty in prog.records:
                        sealed = avm.seal_record(prog.id, out.ty, out)
                        self.record_ciphertexts.setdefault(
                            block_height, []).append(sealed)
            except avm.HaltError:
                self.aborted_tx_ids.add(tx.id.digest)
        elif not tx.is_deploy and payload.startswith(b"call "):
            # call <program_id>/<mapping> <key>=<value>
            body = payload[len(b"call "):].decode(errors="replace")
            target, _, assignment = body.partition(" ")
            program_id, _, mapping = target.partition("/")
            key, sep, value = assignment.partition("=")
            if program_id in self.programs and mapping and sep:
                self.mappings.setdefault((program_id, mapping), {})[key.strip()] = value.strip()

    # -- program queries (REST program routes) --------------------------------
    def get_program(self, program_id: str) -> Optional[str]:
        return self.programs.get(program_id)

    def program_mappings(self, program_id: str) -> list[str]:
        return sorted(m for (p, m) in self.mappings if p == program_id)

    def get_mapping_value(self, program_id: str, mapping: str, key: str) -> Optional[str]:
        return self.mappings.get((program_id, mapping), {}).get(key)

    def get_mapping(self, program_id: str, mapping: str) -> dict[str, str]:
        return dict(self.mappings.get((program_id, mapping), {}))

    # -- state tree (reference routes.rs:252-269, 331-338) -------------------
    @property
    def latest_state_root(self) -> bytes:
        return self.state_tree.state_roots[-1]

    def state_root_at(self, height: int) -> Optional[bytes]:
        return self.state_tree.state_root(height)

    def find_block_height_by_state_root(self, root: bytes) -> Optional[int]:
        return self.state_tree.height_of_root(root)

    def state_path_for_transmission(self, tid_digest: bytes,
                                    at_height: Optional[int] = None) -> Optional[dict]:
        with self.lock:
            return self.state_tree.transmission_path(self.blocks, tid_digest,
                                                     at_height)

    def state_path_for_mapping(self, program: str, mapping: str, key: str,
                               at_height: Optional[int] = None) -> Optional[dict]:
        with self.lock:
            return self.state_tree.mapping_path(program, mapping, key,
                                                at_height)

    def mapping_history(self, height: int, mapping: str):
        """Mapping content as of a historical height (None outside the
        retained snapshot window) — reference GET
        /block/{h}/history/{mapping} (rest/src/routes.rs:453-464)."""
        with self.lock:
            return self.state_tree.mapping_history(height, mapping)

    # -- queries -------------------------------------------------------------
    @property
    def latest_block(self) -> Block:
        return self.blocks[-1]

    @property
    def latest_height(self) -> int:
        return self.blocks[-1].height

    @property
    def latest_round(self) -> int:
        return self.blocks[-1].round

    @property
    def latest_epoch_hash(self) -> bytes:
        return self.blocks[-1].epoch_hash

    @property
    def latest_proof_target(self) -> int:
        return self.blocks[-1].proof_target

    def get_block(self, height: int) -> Block:
        if not 0 <= height < len(self.blocks):
            raise KeyError(f"no block at height {height}")
        return self.blocks[height]

    def get_hash(self, height: int) -> bytes:
        return self.get_block(height).hash

    def contains_block_height(self, height: int) -> bool:
        return 0 <= height < len(self.blocks)

    def contains_transmission(self, tid: TransmissionID) -> bool:
        return tid in self.committed_ids

    def contains_certificate(self, cid: bytes) -> bool:
        return cid in self.committed_cert_ids

    # -- block construction --------------------------------------------------
    def _next_epoch_hash(self, height: int) -> bytes:
        """Epoch rotates every EPOCH_BLOCKS; derived from the epoch index
        and the hash of the epoch's starting block."""
        epoch_index = height // Block.EPOCH_BLOCKS
        start = epoch_index * Block.EPOCH_BLOCKS
        anchor = self.blocks[min(start, len(self.blocks) - 1)].hash
        return sha256d(b"snarkos_tpu.epoch" + epoch_index.to_bytes(8, "little") + anchor)

    def prepare_advance_to_next_quorum_block(
        self, subdag: Subdag, transmissions: list[Transmission]
    ) -> Block:
        """ledger-service/src/ledger.rs:344-365 equivalent: build the next
        block from a committed subdag."""
        prev = self.latest_block
        height = prev.height + 1
        # cap solutions per block, preserve commit order
        n_sol = 0
        kept = []
        for t in transmissions:
            if t.kind == types.TX_SOLUTION:
                if n_sol >= MAX_SOLUTIONS_PER_BLOCK:
                    continue
                n_sol += 1
            kept.append(t)
        # deterministic timestamp: median of the anchor round's certificate
        # timestamps (every correct node computes the same block bytes)
        anchor_ts = sorted(c.batch_header.timestamp for c in subdag.rounds[-1][1])
        median_ts = anchor_ts[len(anchor_ts) // 2]
        return Block(
            height=height,
            previous_hash=prev.hash,
            timestamp=max(median_ts, prev.timestamp + 1),
            round=subdag.anchor_round,
            epoch_hash=self._next_epoch_hash(height),
            proof_target=prev.proof_target,
            subdag=subdag,
            transmissions=tuple(kept),
        )

    def check_next_block(self, block: Block) -> None:
        """Raises on invalid block (structure + subdag + transmissions)."""
        prev = self.latest_block
        if block.height != prev.height + 1:
            raise ValueError(f"height {block.height} != {prev.height + 1}")
        if block.previous_hash != prev.hash:
            raise ValueError("previous hash mismatch")
        if block.timestamp <= prev.timestamp:
            raise ValueError("non-increasing timestamp")
        if block.epoch_hash != self._next_epoch_hash(block.height):
            raise ValueError("wrong epoch hash")
        for t in block.transmissions:
            if t.id in self.committed_ids:
                raise ValueError(f"transmission {t.id} already committed")
        if block.subdag is not None:
            self._check_subdag(block)
        # verify transmissions (the [HOT] path): structural checks per
        # item, then ALL pairing equations collapse into one 2-pairing
        # KZG batch (ops/kzg.batch_verify; device MSM point side) — the
        # reference verifies each transmission's proof separately on CPU
        # rayon threads (ledger.rs:319-342)

        # same-block deploy->execute: executes must verify against an
        # OVERLAY registry that registers deploys in transmission order —
        # exactly the order _index_block applies them — else an execute of
        # a program deployed earlier in this block would require no proof
        # here yet take the SNARK fast path at commit
        overlay = dict(self.parsed_programs)
        openings = []
        for t in block.transmissions:
            obj = t.deserialize()
            if isinstance(obj, Solution):
                opening = self._solution_opening_for(obj, block)
                if opening is None:
                    raise ValueError("invalid solution in block")
                openings.append(opening)
            else:
                # [beta, delta] pairs for auth AND (if provable) execution
                tx_openings = transaction_opening(obj, overlay, self.device)
                if tx_openings is None:
                    raise ValueError("invalid transaction in block")
                openings.extend(tx_openings)
                if obj.is_deploy and _is_program_source(obj.payload):
                    from snarkos_tpu_torch import vm as avm

                    try:
                        prog = avm.parse_program(
                            obj.payload.decode(errors="replace"))
                        overlay.setdefault(prog.id, prog)
                    except avm.ParseError:
                        pass
        # the point side of the batch is two MSMs on the ledger's device;
        # its default gamma (5^8) is crypto/ref/kzg.batch_verify's
        srs = global_puzzle(device=self.device).srs.srs_ref
        if openings and not kzg_ops.batch_verify(srs, openings, device=self.device):
            # pinpoint the offender for the error message (rare path)
            for i, (c, z, y, w) in enumerate(openings):
                if not ref_kzg.verify(srs, c, z, y, w):
                    raise ValueError(f"invalid proof for transmission #{i} in block")
            raise ValueError("batch proof verification failed")

    def _check_subdag(self, block: Block):
        sub = block.subdag
        if not sub.rounds:
            raise ValueError("empty subdag")
        if sub.anchor_round % 2 != 0:
            raise ValueError("anchor round must be even")
        if block.round != sub.anchor_round:
            raise ValueError("block round != anchor round")
        leader_cert = sub.leader_certificate
        # per-round lookback committees (a block near a committee boundary
        # carries certificates signed under the OLD committee)
        committee = self.committee_lookback_for_round(sub.anchor_round)
        expected_leader = committee.get_leader(sub.anchor_round)
        if leader_cert.author != expected_leader:
            raise ValueError("wrong leader certificate")
        for round_, certs in sub.rounds:
            round_committee = self.committee_lookback_for_round(round_)
            for cert in certs:
                if not cert.verify(round_committee):
                    raise ValueError("invalid certificate in subdag")

    def _verify_solution_for(self, sol: Solution, block: Block) -> bool:
        opening = self._solution_opening_for(sol, block)
        if opening is None:
            return False
        c, z, y, w = opening
        return ref_kzg.verify(global_puzzle(device=self.device).srs.srs_ref, c, z, y, w)

    def _solution_opening_for(self, sol: Solution, block: Block):
        """Structural + epoch-binding checks for a solution inside
        ``block``; returns the (C, z, y, W) opening for batched pairing
        verification or None. The binding runs on the ledger's device."""
        # the solution must target the PREVIOUS block's epoch (it was mined
        # before this block existed)
        prev = self.blocks[block.height - 1] if block.height >= 1 else self.latest_block
        if sol.epoch_hash != prev.epoch_hash:
            return None
        pz = global_puzzle(device=self.device)
        opening = pz.check_structural(
            sol.commitment, sol.eval_y, sol.witness, prev.proof_target
        )
        if opening is None:
            return None
        # the committed polynomial must BE the epoch-program-derived one
        # (ops/puzzle.check_binding; rejects prior-epoch relations)
        if not pz.check_binding(sol.epoch_hash, sol.address, sol.nonce,
                                sol.commitment, sol.eval_y):
            return None
        return opening

    def advance_to_next_block(self, block: Block) -> None:
        with self.lock:
            self._index_block(block)
            self._persist(block)

    # -- sync helpers --------------------------------------------------------
    def latest_block_locators(self):
        from snarkos_tpu_torch.node.messages import BlockLocators

        h = self.latest_height
        lo = max(0, h - BlockLocators.NUM_RECENTS + 1)
        recents = tuple((i, self.get_hash(i)) for i in range(lo, h + 1))
        checkpoints = tuple(
            (i, self.get_hash(i))
            for i in range(0, h + 1, BlockLocators.CHECKPOINT_INTERVAL)
        )
        return BlockLocators(recents=recents, checkpoints=checkpoints)


# --------------------------------------------------------------------------
# transaction verification ([HOT]: Varuna AHP verify — the reference runs
# snarkVM Varuna on every gossiped transaction, ledger.rs:318-343)
# --------------------------------------------------------------------------

_VARUNA_CTX: dict = {}


def device_commit(srs: PuzzleSRS):
    """The Varuna ``commit_fn`` over ``srs``: coefficients (host ints) ->
    sum_i c_i tau^i G as a host Jacobian tuple, computed by
    ``ops/kzg.commit`` over the SRS powers on their device (the fused MSM
    engine on the card)."""
    device = srs.points.x.device

    def commit(coeffs):
        if len(coeffs) > srs.degree + 1:
            raise ValueError(f"{len(coeffs)} coefficients over an SRS of degree {srs.degree}")
        if not coeffs:
            return ref_g1.INFINITY
        mont = torch.from_numpy(FR.encode_fast([c % R for c in coeffs], mont=True))
        return g1_ops.decode_points(kzg_ops.commit(srs.points, mont.to(device).contiguous()))[0]

    return commit


def varuna_index(srs: PuzzleSRS, cs):
    """The Varuna index of ``cs`` over ``srs``, committed on the SRS's
    device when it is not cached (``varuna.get_index``)."""
    from snarkos_tpu_torch.crypto.ref import varuna

    return varuna.get_index(srs.srs_ref, cs, device_commit(srs))


class SRSTooSmall(RuntimeError):
    """A circuit needs a larger SRS than the ceremony artifact: the JAX
    ledger's RuntimeError, named so that the block sync can tell this
    refusal of a block's content from a device fault."""


def _trimmed_srs(need: int, device, what: str) -> PuzzleSRS:
    """The dev-tau family's SRS of degree exactly ``need`` on ``device``:
    the puzzle SRS's first powers, or, above its degree, the powers built
    on the device from the same tau."""
    puzzle_srs = global_puzzle(device=device).srs
    if len(puzzle_srs.srs_ref.powers_g1) >= need + 1:
        return puzzle_srs.trim(need)
    if not puzzle_srs.is_dev:
        # artifact mode: minting a fresh dev-tau SRS here would
        # silently reintroduce the known tau
        raise SRSTooSmall(f"SRS artifact too small: {what} needs degree {need}")
    return PuzzleSRS.dev_powers(need, device)


def global_varuna(device=None):
    """Process-wide (circuit, key-var, SRS) for the authorization relation,
    one per device; the SRS is a ``PuzzleSRS`` (its powers on ``device``,
    ``srs_ref`` on the host). Uses the SAME deterministic tau as the puzzle
    SRS so block-level batch verification can combine solution and
    transaction pairings into ONE multi-pairing. The SRS is TRIMMED to
    exactly the circuit's required degree: the degree-bound shadow
    commitments (s_1/s_2) are only sound when the committer key has no slack
    above the enforced bound."""
    device = _build.resolve_device(device)
    with _LAZY_LOCK:
        ctx = _VARUNA_CTX.get(device)
        if ctx is None:
            from snarkos_tpu_torch.crypto.ref import r1cs as r1cs_mod
            from snarkos_tpu_torch.crypto.ref import varuna

            cs, k_var = r1cs_mod.auth_circuit()
            srs = _trimmed_srs(varuna.required_srs_degree(cs), device, "auth circuit")
            # the index (verifying key: matrix-polynomial commitments) is
            # computed once here — O(nnz) at startup, O(1) per verification
            varuna_index(srs, cs)
            ctx = _VARUNA_CTX[device] = (cs, k_var, srs)
        return ctx


def transaction_binding(payload: bytes, fee: int) -> int:
    """The public binding field m for the authorization statement."""
    h = hashlib.sha256(b"snarkos_tpu.tx.m" + payload + fee.to_bytes(8, "little")).digest()
    return int.from_bytes(h, "little") % R


# --------------------------------------------------------------------------
# execution proofs (vm/circuit.py): per-function Varuna proofs of the
# register trace, the analogue of snarkVM's per-transition execution
# proofs created at cli/src/commands/developer/execute.rs:88 and verified
# at ledger-service/src/ledger.rs:319-341
# --------------------------------------------------------------------------

_EXEC_SRS_CACHE: dict = {}
_CREDITS_PARSED = None


def credits_program():
    """The built-in credits.aleo Program (parsed once)."""
    global _CREDITS_PARSED
    if _CREDITS_PARSED is None:
        from snarkos_tpu_torch import vm as avm

        _CREDITS_PARSED = avm.parse_program(CREDITS_PROGRAM)
    return _CREDITS_PARSED


def execution_srs(need: int, device=None) -> PuzzleSRS:
    """Trimmed SRS for an execution circuit (same tau family as the
    puzzle/auth SRS so all pairings batch into one multi-pairing; the
    trim is REQUIRED for the degree-bound shadow soundness), cached in
    memory per (need, device). Dev SRSs larger than the puzzle base
    (record/privacy circuits reach degree 2^15) are built on the device
    (``PuzzleSRS.dev_powers``); nothing is read from or written to disk."""
    device = _build.resolve_device(device)
    with _LAZY_LOCK:
        srs = _EXEC_SRS_CACHE.get((need, device))
        if srs is None:
            srs = _EXEC_SRS_CACHE[(need, device)] = _trimmed_srs(
                need, device, "execution circuit")
        return srs


def _address_field(addr: str) -> int:
    """Public-input encoding of a caller address (0 for anonymous):
    Poseidon binding of the full compressed encoding (vm/circuit.py
    address_field — no decompression, both coordinates bound)."""
    if not addr or addr == ZERO_ADDRESS:
        return 0
    from snarkos_tpu_torch.vm import circuit as vmc

    return vmc.address_field(addr)


def _is_program_source(payload: bytes) -> bool:
    """A deploy payload carrying Aleo-instructions source (optionally
    preceded by `import <id>;` lines)."""
    return payload.startswith(b"program ") or payload.startswith(b"import ")


def _parse_execute_payload(payload: bytes):
    """-> (program_id, fn_name, caller, sig_tok, args_toks) or None."""
    if not payload.startswith(b"execute "):
        return None
    toks = payload[len(b"execute "):].decode(errors="replace").split()
    if not toks:
        return None
    program_id, _, fn_name = toks[0].partition("/")
    args_toks = toks[1:]
    caller, sig_tok = ZERO_ADDRESS, None
    if args_toks and args_toks[0].startswith("caller:"):
        caller = args_toks[0][len("caller:"):]
        args_toks = args_toks[1:]
        if args_toks and args_toks[0].startswith("sig:"):
            sig_tok, args_toks = args_toks[0], args_toks[1:]
    return program_id, fn_name, caller, sig_tok, args_toks


def exec_circuit_for(program, fn_name: str, device=None):
    """(circuit, trimmed srs on ``device``) for a provable function, else
    None."""
    from snarkos_tpu_torch.crypto.ref import varuna
    from snarkos_tpu_torch.vm import circuit as vmc

    try:
        circ = vmc.compile_function(program, fn_name)
    except vmc.SynthesisUnsupported:
        return None
    except Exception:
        return None
    srs = execution_srs(varuna.required_srs_degree(circ.cs), device)
    return circ, srs


def _is_future_output(spec, program) -> bool:
    ty = spec[1]
    vis = spec[2] if len(spec) > 2 else None
    return vis == "future" or ty.endswith(".future") or "/" in ty


def _exec_output_types(program, fn_name: str) -> list | None:
    """Declared claimed-VALUE-token types: finalize input types, then
    PUBLIC literal (non-future, non-record, non-private) output types.
    Private outputs and record outputs never appear as value tokens —
    they are carried as commitments/ciphertexts (vm/circuit.py layout)."""
    fn = program.functions.get(fn_name)
    if fn is None:
        return None
    tys = []
    if fn.finalize_name is not None:
        fin = program.finalizes.get(fn.finalize_name)
        if fin is None or len(fin.inputs) != len(fn.finalize_args):
            return None
        tys += [ty for (_r, ty) in fin.inputs]
    for spec in fn.outputs:
        if _is_future_output(spec, program):
            continue
        ty = spec[1]
        vis = spec[2] if len(spec) > 2 else None
        if ty.split(".")[0] in program.records:
            continue
        if vis == "private":
            continue
        tys.append(ty)
    return tys


def _n_record_outputs(program, fn_name: str) -> int:
    fn = program.functions[fn_name]
    return sum(1 for spec in fn.outputs
               if not _is_future_output(spec, program)
               and spec[1].split(".")[0] in program.records)


def _parse_payload_value(program, tok: str, ty: str):
    """Parse a payload/exec_outs token against a declared type.  Structs
    travel as ``plain:<hex-of-plaintext>`` (their printable form contains
    whitespace, which the token format cannot carry)."""
    from snarkos_tpu_torch import vm as avm

    if ty in program.structs:
        if not tok.startswith("plain:"):
            raise avm.HaltError(f"struct value must be plain:<hex>, got {tok[:20]!r}")
        text = bytes.fromhex(tok[len("plain:"):]).decode()
        members = avm.parse_plaintext(text, program.structs[ty].members)
        return avm.Value(ty, members)
    v = avm.parse_typed(tok, ty)
    if ty == "group":
        # statement-entering points must be in the prime-order subgroup
        # (decompress only guarantees on-curve; cofactor 4)
        from snarkos_tpu_torch.crypto.ref import edwards as _ed

        if not _ed.in_subgroup(v.val):
            raise avm.HaltError("group value outside the prime subgroup")
    return v


def _format_payload_value(program, v) -> str:
    """Inverse of _parse_payload_value."""
    from snarkos_tpu_torch import vm as avm

    if v.ty in program.structs:
        return "plain:" + avm.format_value(v).encode().hex()
    return avm.format_value(v)


def _parse_exec_outs(program, fn_name: str, exec_outs: bytes):
    """Claimed outputs -> dict with keys c_in, values (list[vm Value] —
    finalize args then public outputs), rec_comms, c_privout, rec_cts;
    or None if malformed. Token format (prove_execution emits it):

        cin:<hex> <value tokens...> [reccomm:<hex>]* cpriv:<hex>
        [recct:<hex>]*
    """
    from snarkos_tpu_torch import vm as avm

    tys = _exec_output_types(program, fn_name)
    if tys is None:
        return None
    n_rec = _n_record_outputs(program, fn_name)
    toks = exec_outs.decode(errors="replace").split()
    try:
        if not toks or not toks[0].startswith("cin:"):
            return None
        c_in = int(toks[0][len("cin:"):], 16)
        toks = toks[1:]
        if len(toks) < len(tys):
            return None
        values = [_parse_payload_value(program, t, ty)
                  for t, ty in zip(toks, tys)]
        toks = toks[len(tys):]
        rec_comms = []
        for _ in range(n_rec):
            if not toks or not toks[0].startswith("reccomm:"):
                return None
            rec_comms.append(int(toks[0][len("reccomm:"):], 16))
            toks = toks[1:]
        if not toks or not toks[0].startswith("cpriv:"):
            return None
        c_privout = int(toks[0][len("cpriv:"):], 16)
        toks = toks[1:]
        rec_cts = []
        for _ in range(n_rec):
            if not toks or not toks[0].startswith("recct:"):
                return None
            rec_cts.append(bytes.fromhex(toks[0][len("recct:"):]))
            toks = toks[1:]
        if toks:
            return None
        if not (0 <= c_in < R and 0 <= c_privout < R
                and all(0 <= c < R for c in rec_comms)):
            return None
    except Exception:
        return None
    return {"c_in": c_in, "values": values, "rec_comms": rec_comms,
            "c_privout": c_privout, "rec_cts": rec_cts}


def execution_openings(tx: Transaction, programs: dict, device=None):
    """Verify the execution proof of an execute transaction (pairing-free
    part) and return its KZG openings for batching; an index not yet cached
    is committed on ``device``.

    Returns [] when no execution proof is required (unknown program,
    unsupported function, non-execute payload) and None when a required
    proof is missing or invalid."""
    from snarkos_tpu_torch.crypto.ref import varuna
    from snarkos_tpu_torch.vm import circuit as vmc

    parts = _parse_execute_payload(tx.payload)
    if parts is None:
        return []
    program_id, fn_name, caller, _sig, args_toks = parts
    program = programs.get(program_id)
    if program is None or fn_name not in program.functions:
        return []
    ctx = exec_circuit_for(program, fn_name, device)
    if ctx is None:
        return []
    circ, srs = ctx
    if not tx.exec_proof:
        return None
    from snarkos_tpu_torch import vm as avm

    fn = program.functions[fn_name]
    if len(args_toks) != len(fn.inputs):
        return None
    # input tokens by declared visibility: public -> value field;
    # record -> serial token (the public spend tag); private -> '-'
    # placeholder (the value is witness-only, bound by C_in)
    input_fields, serials = [], []
    try:
        for t, (_r, ty, vis) in zip(args_toks, fn.inputs):
            if ty in program.records:
                if not t.startswith("serial:"):
                    return None
                raw = bytes.fromhex(t[len("serial:"):])
                if len(raw) != 32:
                    return None
                sf = int.from_bytes(raw, "little")
                if sf >= R:
                    return None
                serials.append(sf)
            elif vis == "public":
                input_fields.extend(vmc.value_leaf_fields(
                    _parse_payload_value(program, t, ty)))
            else:
                if t != "-":
                    return None
        caller_field = _address_field(caller)
    except Exception:
        return None
    parsed = _parse_exec_outs(program, fn_name, tx.exec_outs)
    if parsed is None:
        return None
    try:
        output_fields = []
        for v in parsed["values"]:
            output_fields.extend(vmc.value_leaf_fields(v))
    except vmc.SynthesisUnsupported:
        return None
    publics = vmc.build_publics(circ, caller_field, input_fields,
                                output_fields, c_in=parsed["c_in"],
                                serials=serials,
                                rec_out_comms=parsed["rec_comms"],
                                c_privout=parsed["c_privout"])
    if publics is None:
        return None
    try:
        proof = varuna.VarunaProof.deserialize(tx.exec_proof)
    except Exception:
        return None
    return varuna.verify_prepare(circ.cs, publics, proof, srs=srs.srs_ref,
                                 index=varuna_index(srs, circ.cs))


def deployment_vk_check(tx: Transaction, device=None) -> bool:
    """Deployment verifying-key certification: the deploy must carry the
    digest of every provable function's Varuna index, and they must match
    local synthesis (reference: snarkVM check_deployment certifies the
    deployment's verifying keys at admission)."""
    from snarkos_tpu_torch import vm as avm

    if not _is_program_source(tx.payload):
        return True  # legacy non-program deploys carry no circuits
    try:
        program = avm.parse_program(tx.payload.decode(errors="replace"))
    except avm.ParseError:
        return True
    expected = deployment_vk_digests(program, device)
    claimed = dict(
        tok.split(":", 1) for tok in tx.exec_outs.decode(errors="replace").split()
        if ":" in tok
    ) if tx.exec_outs else {}
    return claimed == {fn: d.hex() for fn, d in expected.items()}


def deployment_vk_digests(program, device=None) -> dict:
    """fn name -> vk digest for every provable function of ``program``.

    Each digest hashes the function's Varuna index, committed on ``device``
    the first time and then held in memory by ``varuna.get_index`` (keyed by
    the SRS's and the circuit's content): every gossiped deploy recomputes
    the full digest map (deployment_vk_check) from the cached indexes."""
    from snarkos_tpu_torch.vm import circuit as vmc

    out = {}
    for fn_name in program.functions:
        # cheap pre-screen: compile (cached, no indexing) before the SRS
        try:
            vmc.compile_function(program, fn_name)
        except Exception:
            continue
        ctx = exec_circuit_for(program, fn_name, device)
        if ctx is None:
            continue
        circ, srs = ctx
        out[fn_name] = vmc.vk_digest(circ, srs.srs_ref, device_commit(srs))
    return out


def prove_execution(payload: bytes, fee: int, key: int, program,
                    private_args: list | None = None, device=None) -> tuple:
    """(exec_proof, exec_outs) for an execute payload, or (b"", b"") when
    the target function is not provable. Raises on a faulting trace.

    ``private_args``: list aligned with the function's inputs supplying
    the vm Values for ``.private`` literal inputs (payload token ``-``)
    and record inputs (payload token ``serial:<hex>`` — the PUBLIC spend
    tag; the plaintext never enters the payload). Entries for public
    inputs are ignored. The proof's commitments run on ``device``."""
    from snarkos_tpu_torch import vm as avm
    from snarkos_tpu_torch.crypto.ref import varuna
    from snarkos_tpu_torch.vm import circuit as vmc

    parts = _parse_execute_payload(payload)
    if parts is None or program is None:
        return b"", b""
    program_id, fn_name, caller, _sig, args_toks = parts
    if isinstance(program, str):
        program = avm.parse_program(program)
    if program.id != program_id or fn_name not in program.functions:
        return b"", b""
    ctx = exec_circuit_for(program, fn_name, device)
    if ctx is None:
        return b"", b""
    circ, srs = ctx
    fn = program.functions[fn_name]
    if len(args_toks) != len(fn.inputs):
        raise avm.HaltError("input arity mismatch")
    args = []
    for i, (t, (_r, ty, vis)) in enumerate(zip(args_toks, fn.inputs)):
        if ty in program.records:
            v = private_args[i] if private_args else None
            if v is None or v.ty != ty:
                raise avm.HaltError(
                    f"record input {i} requires its Value in private_args")
            expected = "serial:" + avm.record_serial(program.id, ty, v).hex()
            if t != expected:
                raise avm.HaltError("payload serial does not match the record")
            args.append(v)
        elif vis == "public":
            args.append(_parse_payload_value(program, t, ty))
        else:
            v = private_args[i] if private_args else None
            if t != "-" or v is None:
                raise avm.HaltError(
                    f"private input {i} requires '-' token and private_args")
            if v.ty != ty:
                raise avm.HaltError(f"private input {i}: {v.ty} != {ty}")
            args.append(v)
    # interpreter pass for the claimed outputs (printable tokens)
    ectx = avm.ExecContext(program=program, caller=caller, block_height=0,
                           tx_seed=b"prove")
    result = avm.execute_function(program, fn_name, args, ectx)
    blind_seed = hashlib.sha256(b"snarkos_tpu.exec.blind"
                                + key.to_bytes(32, "little") + payload).digest()
    _circ, z, publics = vmc.trace_execution(program, fn_name, args,
                                            _address_field(caller), blind_seed)
    stmt = vmc.statement_parts(circ, publics)
    toks = [f"cin:{stmt['c_in']:x}"]
    if result.finalize is not None:
        toks += [_format_payload_value(program, v)
                 for v in result.finalize.args]
    rec_values = []
    outs_nonfuture = [s for s in fn.outputs if not _is_future_output(s, program)]
    for out, spec in zip(result.outputs, outs_nonfuture):
        ty = spec[1]
        vis = spec[2] if len(spec) > 2 else None
        if ty.split(".")[0] in program.records:
            rec_values.append((ty.split(".")[0], out))
            continue
        if vis == "private":
            continue  # bound by C_privout, never revealed
        toks.append(_format_payload_value(program, out))
    toks += [f"reccomm:{c:x}" for c in stmt["rec_comms"]]
    toks.append(f"cpriv:{stmt['c_privout']:x}")
    for base, v in rec_values:
        toks.append("recct:" + avm.seal_record(program.id, base, v).hex())
    exec_outs = " ".join(toks).encode()
    mask_seed = hashlib.sha256(b"snarkos_tpu.exec.mask"
                               + key.to_bytes(32, "little") + payload).digest()
    proof = varuna.prove(srs.srs_ref, circ.cs, z, commit_fn=device_commit(srs),
                         mask_seed=mask_seed)
    return proof.serialize(), exec_outs


def transaction_opening(tx: Transaction, programs: dict | None = None, device=None):
    """Pairing-free Varuna verification (full transcript, rowcheck,
    lincheck, holographic matrix sumchecks, degree-bound shadows);
    returns the final LIST of (C, z, y, W) openings (beta + delta points)
    for (batched) pairing verification, or None if any check fails.

    With ``programs`` (the ledger's parsed-program registry) the
    EXECUTION proof is also required and checked for provable functions
    (vm/circuit.py), and deployments must carry matching verifying-key
    digests — the reference semantics of ledger.rs:319-341 +
    check_deployment. Indexes not yet cached are committed on ``device``."""
    from snarkos_tpu_torch.crypto.ref import varuna

    cs, _, srs = global_varuna(device)
    if not (0 <= tx.auth_tag < R):
        return None
    try:
        proof = varuna.VarunaProof.deserialize(tx.proof)
    except Exception:
        return None
    m = transaction_binding(tx.payload, tx.fee)
    openings = varuna.verify_prepare(cs, [1, m, tx.auth_tag, 0], proof, srs=srs.srs_ref,
                                     index=varuna_index(srs, cs))
    if openings is None:
        return None
    if programs is not None:
        if tx.is_deploy:
            if not deployment_vk_check(tx, device):
                return None
        else:
            exec_ops = execution_openings(tx, programs, device)
            if exec_ops is None:
                return None
            openings = openings + exec_ops
    return openings


def verify_transaction(tx: Transaction, programs: dict | None = None,
                       device=None) -> bool:
    """FULL verification, pairings included — the per-gossip admission
    check (reference verifies every gossiped tx completely,
    ledger.rs:318-343). The openings' batch runs on ``device``
    (``ops/kzg.batch_verify``)."""
    device = _build.resolve_device(device)
    srs = global_varuna(device)[2]
    openings = transaction_opening(tx, programs, device)
    if openings is None:
        return False
    return kzg_ops.batch_verify(srs.srs_ref, openings, device=device)


def sign_execute_payload(payload: bytes, fee: int, account) -> bytes:
    """Insert ``caller:<addr>`` (if absent) and ``sig:<hex>`` tokens into an
    execute payload: the Schnorr signature by ``account`` binds the caller
    address to the payload+fee (verified by _check_caller_auth on commit)."""
    from snarkos_tpu_torch.crypto.ref import edwards
    from snarkos_tpu_torch.node.types import point_to_address

    addr = point_to_address(account.pk)
    toks = payload.decode().split()
    if len(toks) < 2 or toks[0] != "execute":
        raise ValueError("not an execute payload")
    rest = toks[2:]
    if rest and rest[0].startswith("caller:"):
        if rest[0][len("caller:"):] != addr:
            raise ValueError("payload caller differs from the signing account")
        rest = rest[1:]
        if rest and rest[0].startswith("sig:"):
            rest = rest[1:]  # re-sign
    unsigned = " ".join(toks[:2] + [f"caller:{addr}"] + rest).encode()
    sig = edwards.sign_bytes(account.sk, account.pk, caller_auth_message(unsigned, fee))
    sig_tok = f"sig:{sig[0]:064x}{sig[1]:064x}"
    return " ".join(toks[:2] + [f"caller:{addr}", sig_tok] + rest).encode()


def create_transaction(payload: bytes, fee: int = 0, key: int | None = None,
                       is_deploy: bool = False, account=None,
                       program=None, private_args: list | None = None,
                       device=None) -> Transaction:
    """Build a valid transaction: prove knowledge of the authorization key
    k with Poseidon2(k, m) = auth_tag by the Varuna prover
    (``crypto/ref/varuna.prove``): its polynomial arithmetic and transcript
    on the host, every commitment an MSM on ``device`` (None: the card; raises
    without one) through ``device_commit``. Passing ``account`` (an
    edwards.Account) signs an execute payload's caller binding
    (sign_execute_payload).

    Execute payloads against a provable function additionally carry a
    Varuna EXECUTION proof of the register trace (vm/circuit.py);
    ``program`` supplies the parsed Program (or source) — credits.aleo is
    resolved automatically. Deploys of parsable programs carry their
    verifying-key digests (certified at admission)."""
    from snarkos_tpu_torch.crypto.ref import r1cs as r1cs_mod
    from snarkos_tpu_torch.crypto.ref import varuna

    device = _build.resolve_device(device)
    if account is not None and not is_deploy and payload.startswith(b"execute "):
        payload = sign_execute_payload(payload, fee, account)
    cs, k_var, srs = global_varuna(device)
    if key is None:
        key = int.from_bytes(
            hashlib.sha256(b"snarkos_tpu.tx.k" + payload).digest(), "little") % R
    m = transaction_binding(payload, fee)
    tag = r1cs_mod.auth_statement(key, m)
    z = r1cs_mod.auth_assignment(cs, k_var, key, m, tag)
    # deterministic hiding seed derived from the SECRET key: zk against
    # observers (who don't know k), reproducible across nodes for the
    # deterministic dev-genesis transaction
    mask_seed = hashlib.sha256(
        b"snarkos_tpu.tx.mask" + key.to_bytes(32, "little")
        + fee.to_bytes(8, "little") + payload).digest()
    proof = varuna.prove(srs.srs_ref, cs, z, commit_fn=device_commit(srs), mask_seed=mask_seed)
    exec_proof = exec_outs = b""
    if not is_deploy and payload.startswith(b"execute "):
        parts = _parse_execute_payload(payload)
        if program is None and parts is not None and parts[0] == "credits.aleo":
            program = credits_program()
        if program is not None:
            exec_proof, exec_outs = prove_execution(payload, fee, key, program,
                                                    private_args=private_args,
                                                    device=device)
    elif is_deploy and _is_program_source(payload):
        from snarkos_tpu_torch import vm as avm

        try:
            prog = avm.parse_program(payload.decode(errors="replace"))
            digests = deployment_vk_digests(prog, device)
            exec_outs = " ".join(
                f"{fn}:{d.hex()}" for fn, d in sorted(digests.items())).encode()
        except avm.ParseError:
            pass
    return Transaction(
        payload=payload, fee=fee, auth_tag=tag,
        proof=proof.serialize(), is_deploy=is_deploy,
        exec_proof=exec_proof, exec_outs=exec_outs,
    )


# --------------------------------------------------------------------------
# LedgerService seams (traits.rs:30-123 equivalents)
# --------------------------------------------------------------------------


class LedgerService:
    """The interface consensus/sync/workers program against."""

    def latest_round(self) -> int: raise NotImplementedError
    def latest_height(self) -> int: raise NotImplementedError
    def latest_block(self) -> Block: raise NotImplementedError
    def get_block(self, height: int) -> Block: raise NotImplementedError

    def get_block_hash(self, height: int):
        """Canonical hash at height, or None (traits.rs get_block_hash)."""
        if height > self.latest_height():
            return None
        try:
            return self.get_block(height).hash
        except Exception:
            return None
    def current_committee(self) -> Committee: raise NotImplementedError
    def committee_lookback_for(self, round_: int) -> Committee: raise NotImplementedError
    def contains_certificate(self, cid: bytes) -> bool: raise NotImplementedError
    def contains_transmission(self, tid: TransmissionID) -> bool: raise NotImplementedError
    def check_solution_basic(self, sol: Solution) -> None: raise NotImplementedError
    def check_transaction_basic(self, tx: Transaction) -> None: raise NotImplementedError
    def check_next_block(self, block: Block) -> None: raise NotImplementedError
    def prepare_advance_to_next_quorum_block(self, subdag, transmissions) -> Block:
        raise NotImplementedError
    def advance_to_next_block(self, block: Block) -> None: raise NotImplementedError


class CoreLedgerService(LedgerService):
    def __init__(self, ledger: Ledger):
        self.ledger = ledger
        self._seen_tx_cache: dict[TransmissionID, bool] = {}

    def latest_round(self): return self.ledger.latest_round
    def latest_height(self): return self.ledger.latest_height
    def latest_block(self): return self.ledger.latest_block
    def get_block(self, height): return self.ledger.get_block(height)
    def current_committee(self): return self.ledger.committee

    def committee_lookback_for(self, round_):
        # dynamic: derived from on-chain bonding with reference lookback
        # semantics (ledger.rs:185-198, gateway.rs:328-376)
        return self.ledger.committee_lookback_for_round(round_)

    def contains_certificate(self, cid): return self.ledger.contains_certificate(cid)
    def contains_transmission(self, tid): return self.ledger.contains_transmission(tid)

    def check_solution_basic(self, sol: Solution) -> None:
        if sol.epoch_hash != self.ledger.latest_epoch_hash:
            raise ValueError("solution targets a stale epoch")
        ok = global_puzzle(device=self.ledger.device).verify(
            sol.epoch_hash, sol.address, sol.nonce, sol.commitment,
            sol.eval_y, sol.witness, self.ledger.latest_proof_target,
        )
        if not ok:
            raise ValueError("invalid puzzle solution")

    def check_transaction_basic(self, tx: Transaction) -> None:
        tid = tx.id
        cached = self._seen_tx_cache.get(tid)
        if cached is True:
            return
        if cached is False:
            raise ValueError("invalid transaction (cached)")
        ok = verify_transaction(tx, programs=self.ledger.parsed_programs,
                                device=self.ledger.device)
        if len(self._seen_tx_cache) > 10000:
            self._seen_tx_cache.clear()
        self._seen_tx_cache[tid] = ok
        if not ok:
            raise ValueError("invalid transaction")

    def check_next_block(self, block): self.ledger.check_next_block(block)

    def prepare_advance_to_next_quorum_block(self, subdag, transmissions):
        return self.ledger.prepare_advance_to_next_quorum_block(subdag, transmissions)

    def advance_to_next_block(self, block): self.ledger.advance_to_next_block(block)


class TranslucentLedgerService(CoreLedgerService):
    """check_next_block is a no-op (devnet e2e; translucent.rs:36-60)."""

    def check_next_block(self, block):
        pass


class MockLedgerService(LedgerService):
    """Fixed committee, no verification (ledger-service/src/mock.rs:34-51).

    Unlike the reference mock, committed transmission ids ARE tracked —
    the commit path's cross-block dedup (consensus _commit_anchor checks
    ledger.contains_transmission) is a safety invariant the tests assert,
    and a mock that always answers False silently disables it."""

    def __init__(self, committee: Committee, device=None):
        self.committee = committee
        self._height = 0
        self._blocks = [make_genesis(committee, device)]
        self._committed_tids: set = set()

    def latest_round(self): return self._blocks[-1].round
    def latest_height(self): return self._blocks[-1].height
    def latest_block(self): return self._blocks[-1]
    def get_block(self, height): return self._blocks[height]
    def current_committee(self): return self.committee
    def committee_lookback_for(self, round_): return self.committee
    def contains_certificate(self, cid): return False
    def contains_transmission(self, tid): return tid in self._committed_tids
    def check_solution_basic(self, sol): pass
    def check_transaction_basic(self, tx): pass
    def check_next_block(self, block): pass

    def prepare_advance_to_next_quorum_block(self, subdag, transmissions):
        prev = self._blocks[-1]
        return Block(
            height=prev.height + 1, previous_hash=prev.hash,
            timestamp=prev.timestamp + 1, round=subdag.anchor_round,
            epoch_hash=prev.epoch_hash, proof_target=prev.proof_target,
            subdag=subdag, transmissions=tuple(transmissions),
        )

    def advance_to_next_block(self, block):
        self._blocks.append(block)
        for t in block.transmissions:
            self._committed_tids.add(t.id)


class ProverLedgerService(LedgerService):
    """Everything fails except solution checks are no-ops
    (prover.rs:32-187)."""

    def __init__(self):
        self._latest_epoch_hash = b"\x00" * 32
        self._latest_proof_target = 1 << 8
        self._latest_height = 0

    def latest_round(self): return 0
    def latest_height(self): return self._latest_height
    def latest_block(self): raise RuntimeError("prover has no ledger")
    def get_block(self, height): raise RuntimeError("prover has no ledger")
    def current_committee(self): raise RuntimeError("prover has no committee")
    def committee_lookback_for(self, round_): raise RuntimeError("prover has no committee")
    def contains_certificate(self, cid): return False
    def contains_transmission(self, tid): return False
    def check_solution_basic(self, sol): pass
    def check_transaction_basic(self, tx): raise RuntimeError("prover cannot check transactions")
    def check_next_block(self, block): raise RuntimeError("prover cannot check blocks")
    def prepare_advance_to_next_quorum_block(self, subdag, transmissions):
        raise RuntimeError("prover cannot build blocks")
    def advance_to_next_block(self, block): raise RuntimeError("prover cannot advance blocks")
