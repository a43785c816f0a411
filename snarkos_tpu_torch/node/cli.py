"""CLI entrypoint: `python -m snarkos_tpu_torch.node.cli` (cli/src semantics).

Commands (SURVEY.md §2.9 cli rows): ``account new|sign|verify``,
``clean``, ``start`` with the reference's ``--dev <id>`` convention
(deterministic accounts/committee from a fixed seed; ports 4130+id /
5000+id / 3030+id; node i connects to peers 0..i — start.rs:333-372).

The port of ``snarkos_tpu/node/cli.py``: the same commands and options,
the same dev accounts and committee, the same data directory and store
format. ``start`` takes one option more, ``--device`` (default ``cuda``,
the card; ``cpu`` runs the plain versions), which the node's roles resolve
before they bind a socket; without a card ``start`` raises "no CUDA
device". The ``developer`` commands create their transactions on the card.
``start`` returns 1 when the node stopped on a device fault (the roles'
fault rule, ``roles.py``), and when the CDN bootstrap raised one; 0 after
SIGINT or SIGTERM.
"""

from __future__ import annotations

import argparse
import asyncio
import hashlib
import json
import logging
import os
import shutil
import sys

from snarkos_tpu_torch.crypto.ref import edwards
from snarkos_tpu_torch.node.types import Committee, point_to_address

DEV_SEED = 1234567890  # start.rs:57 equivalent
DEFAULT_DATA_DIR = os.path.expanduser("~/.snarkos_tpu")


def dev_account(index: int) -> edwards.Account:
    seed = hashlib.sha256(b"snarkos_tpu.dev" + DEV_SEED.to_bytes(8, "little")
                          + index.to_bytes(4, "little")).digest()
    return edwards.Account.new(seed=seed)


def _record_blob(tok: str) -> bytes:
    """Accept both record-ciphertext encodings: ``record1<hex-body>``
    (printable form) and plain hex of the full blob (REST /records/{h})."""
    if tok.startswith("record1"):
        return b"record1" + bytes.fromhex(tok[len("record1"):])
    raw = bytes.fromhex(tok)
    if not raw.startswith(b"record1"):
        raise ValueError("not a record ciphertext")
    return raw


def dev_committee(num_validators: int) -> Committee:
    members = {
        point_to_address(dev_account(i).pk): 100 for i in range(num_validators)
    }
    return Committee.new(1, members)


def _add_start_args(p: argparse.ArgumentParser):
    p.add_argument("--validator", action="store_true")
    p.add_argument("--client", action="store_true")
    p.add_argument("--prover", action="store_true")
    p.add_argument("--dev", type=int, default=None, help="dev node id")
    p.add_argument("--dev-num-validators", type=int, default=4)
    p.add_argument("--node", default=None, help="ip:port for the node listener")
    p.add_argument("--bft", default=None, help="ip:port for the BFT gateway")
    p.add_argument("--rest", default=None, help="REST port (default 3030+dev id)")
    p.add_argument("--norest", action="store_true")
    p.add_argument("--peers", default="", help="comma-separated trusted peers ip:port")
    p.add_argument("--validators", default="", help="comma-separated trusted validators ip:port")
    p.add_argument("--private-key-seed", default=None)
    p.add_argument("--storage", default=None)
    p.add_argument("--translucent", action="store_true",
                   help="skip block verification (devnet)")
    p.add_argument("--dev-txs", action="store_true", help="generate dev transactions")
    p.add_argument("--puzzle-log-degree", type=int, default=None)
    p.add_argument("--srs", default=None,
                   help="powers-of-tau SRS artifact (crypto/srs_artifact.py "
                        "format); REQUIRED outside --dev mode")
    p.add_argument("--srs-digest", default=None,
                   help="pinned sha256 hex of the --srs artifact")
    p.add_argument("--allow-dev-srs", action="store_true",
                   help="explicitly accept the KNOWN dev tau outside --dev "
                        "mode (UNSOUND: anyone can forge proofs)")
    p.add_argument("--verbosity", type=int, default=1,
                   help="0-6: deeper layers log debug as it grows "
                        "(consensus, bft, gateway, router, sync, tcp)")
    p.add_argument("--logfile", default=None,
                   help="append log sink alongside stdout")
    p.add_argument("--cdn", default=None,
                   help="CDN base URL for ledger bootstrap (disabled in --dev mode)")
    p.add_argument("--metrics", action="store_true", help="serve Prometheus metrics")
    p.add_argument("--metrics-port", type=int, default=9000)
    p.add_argument("--device", default="cuda",
                   help="the node's device: cuda (the card, the default) or cpu")


def _parse_hostport(s: str, default_port: int) -> tuple:
    if not s:
        return ("127.0.0.1", default_port)
    if ":" in s:
        host, port = s.rsplit(":", 1)
        return (host or "127.0.0.1", int(port))
    return ("127.0.0.1", int(s))


def _parse_peer_list(s: str) -> tuple:
    out = []
    for item in s.split(","):
        item = item.strip()
        if item:
            host, port = item.rsplit(":", 1)
            out.append((host, int(port)))
    return tuple(out)


def _check_resources(is_validator: bool) -> None:
    """Startup resource checks (start.rs:53-54,576-582 equivalents):
    raise the fd soft limit toward 2048 and warn on low-spec validators."""
    try:
        import resource

        soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
        if soft < 2048:
            try:
                resource.setrlimit(resource.RLIMIT_NOFILE,
                                   (min(2048, hard), hard))
            except (ValueError, OSError):
                print(f"warning: open-files limit is {soft} (< 2048); "
                      "raise `ulimit -n` for a busy node", file=sys.stderr)
    except ImportError:
        pass
    if is_validator:
        cores = os.cpu_count() or 1
        if cores < 4:
            print(f"warning: {cores} cores detected; the reference "
                  "validator spec calls for far more (README.md:52-67)",
                  file=sys.stderr)


def _setup_logging(verbosity: int, logfile: str | None) -> None:
    """Verbosity 0-6 maps to per-layer levels like the reference's
    per-crate trace directives (cli/src/helpers/logger.rs:32-165):
    higher verbosity turns on debug for deeper layers
    (consensus/bft -> gateway -> router -> sync -> tcp). Dual sinks:
    stdout plus an optional append logfile."""
    handlers: list = [logging.StreamHandler()]
    if logfile:
        os.makedirs(os.path.dirname(logfile) or ".", exist_ok=True)
        handlers.append(logging.FileHandler(logfile))
    base = {0: logging.ERROR, 1: logging.INFO}.get(verbosity, logging.INFO)
    logging.basicConfig(level=base, handlers=handlers,
                        format="%(asctime)s %(levelname).1s %(name)s: %(message)s")
    layer_order = [
        "snarkos_tpu_torch.node.consensus", "snarkos_tpu_torch.node.bft",
        "snarkos_tpu_torch.node.gateway", "snarkos_tpu_torch.node.router",
        "snarkos_tpu_torch.node.block_sync", "snarkos_tpu_torch.node.tcp",
    ]
    for i, name in enumerate(layer_order):
        if verbosity >= i + 2:
            logging.getLogger(name).setLevel(logging.DEBUG)


class AccountView:
    def __init__(self, acct):
        self.sk, self.pk = acct.sk, acct.pk
        self.address = point_to_address(acct.pk)


def make_node(args):
    """The role ``args`` (parsed ``start`` options) asks for, built and not
    started: its device resolved first, its ledger (Validator, Client) or
    its genesis hash (Prover) on that device."""
    from snarkos_tpu_torch.node.roles import Client, Prover, Validator
    from snarkos_tpu_torch.node.ledger import make_genesis
    from snarkos_tpu_torch.ops import _build

    device = _build.resolve_device(args.device)
    committee = dev_committee(args.dev_num_validators)
    if args.dev is not None:
        account = dev_account(args.dev)
        node_addr = ("127.0.0.1", 4130 + args.dev)
        bft_addr = ("127.0.0.1", 5000 + args.dev)
        rest_port = None if args.norest else 3030 + args.dev
        trusted_peers = tuple(("127.0.0.1", 4130 + i) for i in range(args.dev))
        trusted_validators = tuple(
            ("127.0.0.1", 5000 + i) for i in range(args.dev_num_validators) if i != args.dev
        )
        storage = args.storage or os.path.join(
            DEFAULT_DATA_DIR, f"dev-{args.dev}", "ledger.dat"
        )
    else:
        if args.private_key_seed is None:
            print("--private-key-seed is required outside --dev mode", file=sys.stderr)
            sys.exit(1)
        account = edwards.Account.new(
            seed=hashlib.sha256(args.private_key_seed.encode()).digest()
        )
        node_addr = _parse_hostport(args.node, 4130)
        bft_addr = _parse_hostport(args.bft, 5000)
        rest_port = None if args.norest else (int(args.rest) if args.rest else 3030)
        trusted_peers = _parse_peer_list(args.peers)
        trusted_validators = _parse_peer_list(args.validators)
        storage = args.storage or os.path.join(DEFAULT_DATA_DIR, "ledger.dat")

    # production SRS story (r4 missing #3): outside --dev mode the node
    # refuses to run on the KNOWN dev tau — a real powers-of-tau artifact
    # (digest-pinned, pairing-validated at load) is required, unless the
    # operator explicitly opts into unsoundness with --allow-dev-srs.
    if args.srs:
        os.environ["SNARKOS_TPU_SRS_PATH"] = args.srs
        if args.srs_digest:
            os.environ["SNARKOS_TPU_SRS_DIGEST"] = args.srs_digest
    elif args.dev is None and not args.allow_dev_srs:
        print("--srs <artifact> is required outside --dev mode (the dev SRS "
              "tau is public knowledge; pass --allow-dev-srs to override)",
              file=sys.stderr)
        sys.exit(1)

    if args.puzzle_log_degree is not None:
        os.environ["SNARKOS_TPU_PUZZLE_LOG_DEGREE"] = str(args.puzzle_log_degree)

    av = AccountView(account)
    print(f"node address: {av.address}")

    if args.prover:
        node = Prover(av, make_genesis(committee, device).hash,
                      node_ip=node_addr[0], node_port=node_addr[1],
                      trusted_peers=trusted_peers,
                      log_degree=args.puzzle_log_degree, device=device)
    elif args.client:
        node = Client(av, committee, node_ip=node_addr[0], node_port=node_addr[1],
                      rest_port=rest_port, storage_path=storage,
                      trusted_peers=trusted_peers, device=device)
    else:
        node = Validator(av, committee,
                         node_ip=node_addr[0], node_port=node_addr[1],
                         bft_port=bft_addr[1], rest_port=rest_port,
                         storage_path=storage, trusted_peers=trusted_peers,
                         trusted_validators=trusted_validators,
                         translucent=args.translucent,
                         dev_tx_interval=0.5 if args.dev_txs else None,
                         device=device)
    return node


async def _run_start(args) -> int:
    from snarkos_tpu_torch.node.ledger import is_device_fault

    _setup_logging(args.verbosity, args.logfile)
    _check_resources(is_validator=not (args.client or args.prover))
    node = make_node(args)
    rest_port = getattr(node, "rest_port", None)

    # CDN fast-bootstrap before joining the network (node/cdn semantics;
    # disabled in dev mode like start.rs:261-291)
    if args.cdn and args.dev is None and not args.prover:
        from snarkos_tpu_torch.node import cdn

        try:
            synced = await cdn.sync_ledger_with_cdn(args.cdn, node.ledger_service)
            print(f"cdn: synced {synced} blocks")
        except Exception as exc:
            if is_device_fault(exc):
                logging.getLogger(__name__).error(
                    "cdn bootstrap: device fault, not starting the node", exc_info=exc)
                return 1
            print(f"cdn bootstrap failed (continuing with p2p sync): {exc}",
                  file=sys.stderr)

    if args.metrics:
        from snarkos_tpu_torch.node import metrics

        await metrics.serve(args.metrics_port)
        print(f"metrics: 127.0.0.1:{args.metrics_port}/metrics")

    await node.start()
    role = "prover" if args.prover else ("client" if args.client else "validator")
    print(f"{role} started: node={node.router.local_addr}"
          + (f" bft={node.gateway.local_addr}" if hasattr(node, 'gateway') else "")
          + (f" rest=127.0.0.1:{rest_port}" if rest_port else ""))

    stop = asyncio.Event()
    import signal

    loop = asyncio.get_event_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, stop.set)
        except NotImplementedError:
            pass
    # a signal, or the node stopping itself on a device fault
    waits = [asyncio.ensure_future(e.wait()) for e in (stop, node.halted)]
    await asyncio.wait(waits, return_when=asyncio.FIRST_COMPLETED)
    for w in waits:
        w.cancel()
    print("shutting down...")
    await node.shut_down()
    from snarkos_tpu_torch.ops import _build

    print("kernel launches: " + json.dumps(_build.launch_counts()))
    if node.fault is not None:
        print(f"{role} stopped on a device fault: {node.fault}", file=sys.stderr)
        return 1
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="snarkos-tpu", description=__doc__)
    sub = parser.add_subparsers(dest="command", required=True)

    p_start = sub.add_parser("start", help="start a node")
    _add_start_args(p_start)

    p_account = sub.add_parser("account", help="account tools")
    acct_sub = p_account.add_subparsers(dest="account_command", required=True)
    p_new = acct_sub.add_parser("new")
    p_new.add_argument("--seed", default=None)
    p_new.add_argument("--vanity", default=None,
                       help="search for an address containing this substring "
                            "(commands/account.rs vanity mode)")
    p_new.add_argument("--discreet", action="store_true",
                       help="do not print the private key to the terminal")
    p_sign = acct_sub.add_parser("sign")
    p_sign.add_argument("--seed", required=True)
    p_sign.add_argument("--message", required=True)
    p_verify = acct_sub.add_parser("verify")
    p_verify.add_argument("--address", required=True)
    p_verify.add_argument("--message", required=True)
    p_verify.add_argument("--signature", required=True)

    p_clean = sub.add_parser("clean", help="remove the ledger data directory")
    p_clean.add_argument("--dev", type=int, default=None)

    p_dev = sub.add_parser("developer", help="build and broadcast transactions")
    dev_sub = p_dev.add_subparsers(dest="dev_command", required=True)
    p_exec = dev_sub.add_parser("execute", help="create + broadcast a transaction")
    p_exec.add_argument("--payload", default=None,
                        help="raw payload bytes (exclusive with --program)")
    p_exec.add_argument("--program", default=None,
                        help="program id for an on-chain function execution "
                             "(reference: developer execute <program> <function>, "
                             "cli/src/commands/developer/execute.rs)")
    p_exec.add_argument("--function", default=None)
    p_exec.add_argument("--inputs", default="",
                        help="space-separated typed literals, e.g. '5u64 true'")
    p_exec.add_argument("--caller", default=None,
                        help="caller address for self.caller (defaults to zero; "
                             "non-zero callers require --seed to sign)")
    p_exec.add_argument("--seed", default=None,
                        help="account seed: signs the caller binding so "
                             "self.caller is authenticated on-chain")
    p_exec.add_argument("--fee", type=int, default=0)
    p_exec.add_argument("--broadcast", default=None,
                        help="REST base url, e.g. http://127.0.0.1:3030/testnet")
    p_exec.add_argument("--private-inputs", default="",
                        help="space-separated typed literals for .private "
                             "inputs (consumed in declaration order; the "
                             "payload carries '-' placeholders + a hiding "
                             "commitment instead of the values)")
    p_exec.add_argument("--records", default="",
                        help="space-separated record ciphertexts (hex) for "
                             "record inputs, decrypted with --seed; the "
                             "payload carries only their serials")
    p_exec.add_argument("--program-source", default=None,
                        help="path to the program source (needed for "
                             "private/record inputs of non-credits programs; "
                             "fetched from --broadcast endpoint otherwise)")
    p_tp = dev_sub.add_parser(
        "transfer-private",
        help="spend a private credits record (reference: developer "
             "transfer_private, cli/src/commands/developer/mod.rs:58-77)")
    p_tp.add_argument("--seed", required=True, help="owner account seed")
    p_tp.add_argument("--record", required=True,
                      help="credits record ciphertext (hex, record1-prefixed)")
    p_tp.add_argument("--recipient", required=True)
    p_tp.add_argument("--amount", type=int, required=True)
    p_tp.add_argument("--fee", type=int, default=0)
    p_tp.add_argument("--broadcast", default=None)
    p_deploy = dev_sub.add_parser("deploy", help="create + broadcast a deployment")
    p_deploy.add_argument("--payload", required=True,
                          help="program source (with --program-id) or raw payload")
    p_deploy.add_argument("--program-id", default=None,
                          help="register the payload as this program's source; "
                               "readable via GET /program/{id} once committed")
    p_deploy.add_argument("--fee", type=int, default=0)
    p_deploy.add_argument("--broadcast", default=None)
    p_scan = dev_sub.add_parser("scan", help="scan blocks via a REST endpoint")
    p_scan.add_argument("--endpoint", required=True)
    p_scan.add_argument("--start", type=int, default=0)
    p_scan.add_argument("--end", type=int, default=10)
    p_scan.add_argument("--seed", default=None,
                        help="view-key seed: also decrypt owned private records")
    p_xfer = dev_sub.add_parser(
        "seal-payload", help="create a tx whose payload only the recipient "
                             "can read (legacy pre-record form; for private "
                             "credits transfers use transfer-private)")
    p_xfer.add_argument("--recipient", required=True, help="recipient address")
    p_xfer.add_argument("--payload", required=True)
    p_xfer.add_argument("--fee", type=int, default=0)
    p_xfer.add_argument("--broadcast", default=None)
    p_decrypt = dev_sub.add_parser("decrypt", help="decrypt a private record")
    p_decrypt.add_argument("--seed", required=True, help="owner view-key seed")
    p_decrypt.add_argument("--record", required=True, help="record ciphertext (hex)")

    p_update = sub.add_parser("update", help="check for and install updates")
    p_update.add_argument("--check", action="store_true", help="check only")
    p_update.add_argument(
        "--repo", default="https://github.com/snarkos-tpu/snarkos-tpu",
        help="release repository base URL")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    if args.command == "start":
        return asyncio.run(_run_start(args))

    if args.command == "account":
        if args.account_command == "new":
            if args.vanity:
                # vanity search over the address body (commands/account.rs:40-92;
                # addresses here are "aleo1" + hex, so the alphabet is hex)
                needle = args.vanity.lower()
                if not set(needle) <= set("0123456789abcdef") or not 0 < len(needle) <= 6:
                    print("vanity string must be 1-6 hex characters "
                          "(addresses are aleo1<hex>)", file=sys.stderr)
                    return 1
                attempts = 0
                while True:
                    seed = os.urandom(32)
                    acct = edwards.Account.new(seed=seed)
                    addr = point_to_address(acct.pk)
                    attempts += 1
                    if needle in addr[5:]:
                        break
                    if attempts % 10_000 == 0:
                        print(f"... {attempts} attempts", file=sys.stderr)
            else:
                seed = (hashlib.sha256(args.seed.encode()).digest()
                        if args.seed else os.urandom(32))
                acct = edwards.Account.new(seed=seed)
            if args.discreet:
                print("  Private Key (seed)  <hidden; derive from your seed input>")
            else:
                print(f"  Private Key (seed)  {seed.hex()}")
            print(f"       Address        {point_to_address(acct.pk)}")
            return 0
        if args.account_command == "sign":
            seed = hashlib.sha256(args.seed.encode()).digest()
            acct = edwards.Account.new(seed=seed)
            sig = edwards.sign_bytes(acct.sk, acct.pk, args.message.encode())
            print(f"sign1{sig[0]:064x}{sig[1]:064x}")
            return 0
        if args.account_command == "verify":
            raw = args.signature.removeprefix("sign1")
            sig = (int(raw[:64], 16), int(raw[64:128], 16))
            try:
                from snarkos_tpu_torch.node.types import address_to_point

                pk = address_to_point(args.address)
                ok = edwards.verify_bytes(pk, args.message.encode(), sig)
            except Exception:
                ok = False
            print("verified" if ok else "INVALID")
            return 0 if ok else 1

    if args.command == "developer":
        import json as _json
        import urllib.request

        if args.dev_command in ("execute", "deploy"):
            from snarkos_tpu_torch.node.ledger import create_transaction

            account = None
            if args.dev_command == "execute" and getattr(args, "seed", None):
                account = edwards.Account.new(
                    seed=hashlib.sha256(args.seed.encode()).digest())
            private_args = None
            program_obj = None
            if args.dev_command == "execute" and getattr(args, "program", None):
                if not args.function:
                    print("--function is required with --program")
                    return 1
                parts = [f"execute {args.program}/{args.function}"]
                if args.caller and account is None:
                    print("warning: --caller without --seed produces an "
                          "unsigned caller; the execution will abort on-chain")
                    parts.append(f"caller:{args.caller}")
                want_priv = bool(args.private_inputs or args.records)
                if want_priv:
                    # private/record inputs: resolve the program, build the
                    # '-'/serial tokens, and keep the values OFF the wire
                    from snarkos_tpu_torch import vm as avm
                    from snarkos_tpu_torch.node import ledger as _L
                    from snarkos_tpu_torch.vm import values as _V

                    source = None
                    if args.program == "credits.aleo":
                        program_obj = _L.credits_program()
                    elif args.program_source:
                        source = open(args.program_source).read()
                    elif args.broadcast:
                        with urllib.request.urlopen(
                                f"{args.broadcast.rstrip('/')}/program/"
                                f"{args.program}", timeout=30) as r:
                            source = _json.loads(r.read().decode())
                    else:
                        print("--program-source or --broadcast is required "
                              "to resolve private inputs")
                        return 1
                    if program_obj is None:
                        program_obj = avm.parse_program(source)
                    fn = program_obj.functions.get(args.function)
                    if fn is None:
                        print(f"unknown function {args.function!r}")
                        return 1
                    pubs = args.inputs.split() if args.inputs else []
                    privs = (args.private_inputs.split()
                             if args.private_inputs else [])
                    rec_cts = args.records.split() if args.records else []
                    private_args, toks = [], []
                    for _reg, ty, vis in fn.inputs:
                        if ty in program_obj.records:
                            if not rec_cts:
                                print("not enough --records for the record "
                                      "inputs")
                                return 1
                            if account is None:
                                print("--seed is required to decrypt records")
                                return 1
                            name, rec = avm.open_record(
                                account.sk, _record_blob(rec_cts.pop(0)),
                                program_obj)
                            serial = avm.record_serial(program_obj.id, name,
                                                       rec)
                            toks.append(f"serial:{serial.hex()}")
                            private_args.append(rec)
                        elif vis == "public":
                            if not pubs:
                                print("not enough --inputs for the public "
                                      "inputs")
                                return 1
                            toks.append(pubs.pop(0))
                            private_args.append(None)
                        else:
                            if not privs:
                                print("not enough --private-inputs")
                                return 1
                            toks.append("-")
                            private_args.append(
                                _V.parse_typed(privs.pop(0), ty))
                    parts += toks
                elif args.inputs:
                    parts.append(args.inputs)
                payload = " ".join(parts).encode()
            elif args.payload is not None:
                payload = args.payload.encode()
            else:
                print("--payload or --program is required")
                return 1
            if args.dev_command == "deploy" and getattr(args, "program_id", None):
                payload = f"program {args.program_id}\n".encode() + payload
            tx = create_transaction(payload, fee=args.fee,
                                    is_deploy=args.dev_command == "deploy",
                                    account=account, program=program_obj,
                                    private_args=private_args)
            print(f"transaction id: {tx.id.digest.hex()}")
            if args.broadcast:
                req = urllib.request.Request(
                    f"{args.broadcast.rstrip('/')}/transaction/broadcast",
                    data=_json.dumps(tx.to_bytes().hex()).encode(),
                    headers={"Content-Type": "application/json"}, method="POST",
                )
                with urllib.request.urlopen(req, timeout=30) as r:
                    print("broadcast:", r.read().decode())
            else:
                print(tx.to_bytes().hex())
            return 0
        if args.dev_command == "scan":
            view_sk = None
            if args.seed:
                view_sk = edwards.Account.new(
                    seed=hashlib.sha256(args.seed.encode()).digest()).sk
            for h in range(args.start, args.end):
                try:
                    with urllib.request.urlopen(
                        f"{args.endpoint.rstrip('/')}/block/{h}", timeout=10
                    ) as r:
                        blk = _json.loads(r.read())
                    print(f"{h}: hash={blk['hash'][:16]} txs={blk['num_transmissions']}")
                    if view_sk is not None:
                        from snarkos_tpu_torch.crypto.ref import records
                        from snarkos_tpu_torch.node.types import Reader, Transaction

                        for t in blk.get("transmissions", []):
                            if t.get("kind") != 1:
                                continue
                            try:
                                tx = Transaction.from_reader(
                                    Reader(bytes.fromhex(t["data"])))
                                if tx.payload.startswith(b"record1"):
                                    plain = records.decrypt(view_sk, tx.payload[7:])
                                    print(f"   owned record: {plain!r}")
                            except (ValueError, KeyError):
                                continue
                        # VM-sealed record outputs at this height
                        try:
                            with urllib.request.urlopen(
                                f"{args.endpoint.rstrip('/')}/records/{h}",
                                timeout=10,
                            ) as r2:
                                for blob_hex in _json.loads(r2.read()):
                                    try:
                                        blob = bytes.fromhex(blob_hex)
                                        plain = records.decrypt(view_sk, blob[7:])
                                        print(f"   owned record: {plain!r}")
                                    except ValueError:
                                        continue
                        except Exception:
                            pass
                except Exception as exc:
                    print(f"{h}: <unavailable: {exc}>")
                    break
            return 0
        if args.dev_command == "seal-payload":
            from snarkos_tpu_torch.crypto.ref import records
            from snarkos_tpu_torch.node.ledger import create_transaction
            from snarkos_tpu_torch.node.types import address_to_point

            pk = address_to_point(args.recipient)
            record = b"record1" + records.encrypt(pk, args.payload.encode())
            tx = create_transaction(record, fee=args.fee)
            print(f"transaction id: {tx.id.digest.hex()}")
            if args.broadcast:
                req = urllib.request.Request(
                    f"{args.broadcast.rstrip('/')}/transaction/broadcast",
                    data=_json.dumps(tx.to_bytes().hex()).encode(),
                    headers={"Content-Type": "application/json"}, method="POST",
                )
                with urllib.request.urlopen(req, timeout=30) as r:
                    print("broadcast:", r.read().decode())
            else:
                print(tx.to_bytes().hex())
            return 0
        if args.dev_command == "transfer-private":
            # the reference's developer transfer_private: spend a private
            # credits record — the amount and recipient travel as witness
            # data behind commitments, the payload carries only the serial
            from snarkos_tpu_torch import vm as avm
            from snarkos_tpu_torch.crypto.ref import records
            from snarkos_tpu_torch.node import ledger as _L
            from snarkos_tpu_torch.node.ledger import (create_transaction,
                                                 sign_execute_payload)
            from snarkos_tpu_torch.vm import values as _V

            account = edwards.Account.new(
                seed=hashlib.sha256(args.seed.encode()).digest())
            prog = _L.credits_program()
            try:
                name, rec = avm.open_record(account.sk,
                                            _record_blob(args.record), prog)
            except ValueError as exc:
                print(f"cannot decrypt record: {exc}", file=sys.stderr)
                return 1
            if name != "credits":
                print(f"not a credits record: {name}", file=sys.stderr)
                return 1
            serial = avm.record_serial("credits.aleo", "credits", rec)
            payload = (f"execute credits.aleo/transfer_private "
                       f"serial:{serial.hex()} - -").encode()
            payload = sign_execute_payload(payload, args.fee, account)
            tx = create_transaction(
                payload, fee=args.fee, program=prog,
                private_args=[rec, _V.parse_literal(args.recipient),
                              _V.Value("u64", args.amount)])
            print(f"transaction id: {tx.id.digest.hex()}")
            if args.broadcast:
                req = urllib.request.Request(
                    f"{args.broadcast.rstrip('/')}/transaction/broadcast",
                    data=_json.dumps(tx.to_bytes().hex()).encode(),
                    headers={"Content-Type": "application/json"}, method="POST",
                )
                with urllib.request.urlopen(req, timeout=30) as r:
                    print("broadcast:", r.read().decode())
            else:
                print(tx.to_bytes().hex())
            return 0
        if args.dev_command == "decrypt":
            from snarkos_tpu_torch.crypto.ref import records

            sk = edwards.Account.new(
                seed=hashlib.sha256(args.seed.encode()).digest()).sk
            raw = _record_blob(args.record)[len(b"record1"):]
            try:
                print(records.decrypt(sk, raw).decode(errors="replace"))
                return 0
            except ValueError as exc:
                print(f"decryption failed: {exc}", file=sys.stderr)
                return 1

    if args.command == "update":
        # the reference self-updates from GitHub releases
        # (cli/src/commands/update.rs); this build checks the release
        # endpoint and reports — binary replacement is n/a for a package
        import json as _json
        import urllib.request

        url = f"{args.repo.rstrip('/')}/releases/latest"
        try:
            with urllib.request.urlopen(url, timeout=10) as r:
                data = _json.loads(r.read())
            latest = data.get("tag_name", "unknown")
            print(f"latest release: {latest}")
            if not args.check:
                print("run `git pull && pip install -e .` to update a source checkout")
            return 0
        except Exception as exc:
            print(f"update check failed (offline?): {exc}", file=sys.stderr)
            return 1

    if args.command == "clean":
        target = (os.path.join(DEFAULT_DATA_DIR, f"dev-{args.dev}")
                  if args.dev is not None else DEFAULT_DATA_DIR)
        if os.path.exists(target):
            shutil.rmtree(target)
            print(f"removed {target}")
        else:
            print(f"nothing to remove at {target}")
        return 0

    return 1


if __name__ == "__main__":
    sys.exit(main())
