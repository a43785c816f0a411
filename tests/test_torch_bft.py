"""The port's Narwhal storage, proposal cache, mempool partition and BFT
commit rule (snarkos_tpu_torch/node/bft/, proposal_cache.py) against the
JAX package's (snarkos_tpu/node/bft/, proposal_cache.py), on the host.

One certificate DAG is built per module with the JAX types and the four dev
accounts: rounds 1-10, round 4 without its leader's certificate, and
round 6's leader linked from one round-7 certificate only, below the
availability threshold, so that it is committed by the walk back from
round 8's leader. It crosses to the port by its bytes. Fed in the same
order to both packages' ``BFT._on_primary_certificate``, each over a mock
ledger and with no timer running, it commits the same subdags byte for
byte, with the same transmissions.

The commit rule and the storage read no signature but the certificate
check's: the DAG's signatures are a keyed hash of (signer, message)
(``torch_bft_support.standin_signature``), and the storage test puts the
same hash in place of the Schnorr check in both packages (a certificate
takes four pure-Python Schnorr verifies, the slowest part of the test).
The real signatures cross the packages in test_torch_consensus.py."""

import asyncio
import functools
import hashlib
import random

import pytest

from snarkos_tpu.crypto.ref import edwards as jedwards
from snarkos_tpu.node import cli as jcli, proposal_cache as jpc, types as jtypes
from snarkos_tpu.node.bft import bft as jbft, primary as jprimary, storage as jstorage
from snarkos_tpu_torch import convert
from snarkos_tpu_torch.crypto.ref import edwards
from snarkos_tpu_torch.node import proposal_cache as pc, types
from snarkos_tpu_torch.node.bft import bft, primary, storage

import torch_bft_support as sup

N_ROUNDS = 10
NO_LEADER_ROUND = 4   # no certificate of this round's leader
WEAK_LEADER_ROUND = 6  # one round-7 certificate links this round's leader
TIMESTAMP = 1_700_000_000


@functools.lru_cache(maxsize=1)
def accounts():
    """The dev accounts 0-3 of both packages (the port's from
    torch_bft_support, the JAX package's from its CLI) and their
    addresses."""
    port = [sup.dev_account(i) for i in range(4)]
    jax = [jcli.dev_account(i) for i in range(4)]
    return port, jax, [a.address for a in jax]


def test_dev_accounts_and_committee_match_the_cli_and_the_fixture():
    import torch_node_support as nsup

    port, jax, addrs = accounts()
    assert [(a.sk, a.pk) for a in port] == [(a.sk, a.pk) for a in jax]
    assert sup.dev_committee(4).to_bytes() == jcli.dev_committee(4).to_bytes() == \
        bytes.fromhex(nsup.fixture()["committee"])
    assert sorted(sup.dev_committee(4).addresses) == sorted(addrs)


def _transmission(tag: bytes):
    sol = jtypes.Solution(epoch_hash=hashlib.sha256(tag).digest(), address=accounts()[2][0],
                          nonce=int.from_bytes(tag[:4], "little"), commitment=bytes(97),
                          eval_y=len(tag), witness=bytes(97))
    return jtypes.Transmission.from_solution(sol)


@functools.lru_cache(maxsize=1)
def jax_dag():
    """The DAG as bytes, in insertion order: [(certificate bytes,
    [transmission bytes])], and the committee's bytes."""
    addrs = accounts()[2]
    comm = jcli.dev_committee(4)
    shared = _transmission(b"in every round-1 batch")
    rounds: dict[int, dict[str, jtypes.BatchCertificate]] = {}
    out = []
    for r in range(1, N_ROUNDS + 1):
        leader = comm.get_leader(r)
        prev = rounds.get(r - 1, {})
        rounds[r] = {}
        for i, author in enumerate(a for a in addrs if not (r == NO_LEADER_ROUND and a == leader)):
            if r == WEAK_LEADER_ROUND + 1:
                weak = comm.get_leader(WEAK_LEADER_ROUND)
                others = [c.id for a, c in prev.items() if a != weak]
                prev_ids = (others[:2] + [prev[weak].id]) if i == 0 else others
            else:
                prev_ids = [c.id for c in prev.values()]
            own = [_transmission(b"batch %d %d" % (r, i))]
            if r == 1:
                own.append(shared)
            hdr = jtypes.BatchHeader(
                author=author, round=r, timestamp=TIMESTAMP + r, committee_id=comm.id,
                transmission_ids=tuple(t.id for t in own),
                previous_certificate_ids=tuple(sorted(prev_ids)), signature=(0, 0))
            author_pk = bytes.fromhex(author[5:])
            hdr = jtypes.BatchHeader(**{**hdr.__dict__, "signature": sup.standin_signature(
                author_pk, hdr._unsigned_bytes())})
            endorsers = [a for a in addrs if a != author][:2]
            cert = jtypes.BatchCertificate(batch_header=hdr, signatures=tuple(sorted(
                (a, sup.standin_signature(bytes.fromhex(a[5:]), hdr.batch_id)) for a in endorsers)))
            rounds[r][author] = cert
            out.append((cert.to_bytes(), [t.to_bytes() for t in own]))
    return out, comm.to_bytes()


def _decode_transmissions(mod, raws):
    from snarkos_tpu.node.codec import Reader as JReader
    from snarkos_tpu_torch.node.codec import Reader

    reader = JReader if mod is jtypes else Reader
    ts = [mod.Transmission.from_reader(reader(raw)) for raw in raws]
    return {t.id: t for t in ts}


async def _commit_all(bft_mod, primary_mod, storage_mod, types_mod, dag, comm_raw):
    """Feed the DAG to one package's BFT; returns the commits as bytes and
    the DAG's state after them."""
    comm = jcli.dev_committee(4) if types_mod is jtypes else convert.committee(comm_raw)
    assert comm.to_bytes() == comm_raw
    ledger = sup.StubLedger(comm)
    store = storage_mod.NarwhalStorage(ledger, storage_mod.BFTMemoryService())
    acct = accounts()[1][0] if types_mod is jtypes else accounts()[0][0]
    prim = primary_mod.Primary(acct, ledger, store, transport=None)
    commits = []

    async def on_commit(subdag, transmissions):
        commits.append((subdag.to_bytes(), [t.to_bytes() for t in transmissions.values()]))
        ledger.committed.update(transmissions)

    committer = bft_mod.BFT(prim, on_commit=on_commit)
    for cert_raw, t_raws in dag:
        cert = types_mod.BatchCertificate.from_bytes(cert_raw)
        store._insert_unchecked(cert, _decode_transmissions(types_mod, t_raws))
        await committer._on_primary_certificate(cert)
    return commits, committer.dag.last_committed_round, sorted(committer.dag.recent_committed_ids)


def test_commit_rule_commits_the_same_subdags():
    dag, comm_raw = jax_dag()
    want = asyncio.run(_commit_all(jbft, jprimary, jstorage, jtypes, dag, comm_raw))
    got = asyncio.run(_commit_all(bft, primary, storage, types, dag, comm_raw))
    assert got == want
    commits = want[0]
    anchors = [convert.subdag(s).anchor_round for s, _ in commits]
    # round 2 commits at round 3; round 4 has no leader; round 6's leader
    # lacks availability at round 7 and is committed by the walk back from
    # round 8's leader (linked through round 7)
    assert anchors == [2, 6, 8]
    assert want[1] == 8
    comm = sup.dev_committee(4)
    for s, ts in commits:
        sub = convert.subdag(s)
        assert sub.leader_certificate.author == comm.get_leader(sub.anchor_round)
        assert len(ts) == len(set(ts))
    committed = [t for _, ts in commits for t in ts]
    assert len(committed) == len(set(committed))  # each transmission once


def _storage_state(st):
    return {
        "current": st.current_round(), "gc": st.gc_round(),
        "rounds": {r: sorted(cs) for r, cs in st.rounds.items() if cs},
        "certs": sorted(st.certificates), "batches": sorted(st.batch_ids.items()),
        "store": sorted((tid.to_bytes(), t.to_bytes(), sorted(ids))
                        for tid, (t, ids) in st.store.transmissions.items()),
    }


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except ValueError as exc:
        return ("raised", str(exc))


@pytest.fixture
def standin_signatures(monkeypatch):
    """The keyed hash in place of the Schnorr check, in both packages."""
    monkeypatch.setattr(edwards, "verify_bytes", sup.standin_verify)
    monkeypatch.setattr(jedwards, "verify_bytes", sup.standin_verify)


def test_storage_matches(standin_signatures):
    """Checked inserts of rounds 1-6 (a duplicate, one with a transmission
    missing), a batch header check, then the GC of a 3-round window."""
    dag, comm_raw = jax_dag()
    sts = []
    for mod, tmod in ((jstorage, jtypes), (storage, types)):
        comm = convert.committee(comm_raw) if tmod is types else jcli.dev_committee(4)
        sts.append((mod.NarwhalStorage(sup.StubLedger(comm), mod.BFTMemoryService(), gc_rounds=3),
                    tmod))
    outcomes = [[], []]
    head = [d for d in dag if jtypes.BatchCertificate.from_bytes(d[0]).round <= 6]
    for k, (cert_raw, t_raws) in enumerate(head):
        for j, (st, tmod) in enumerate(sts):
            cert = tmod.BatchCertificate.from_bytes(cert_raw)
            ts = _decode_transmissions(tmod, t_raws if k != 3 else t_raws[:0])
            outcomes[j].append(_outcome(st.insert_certificate, cert, ts))
            if k == 0:
                outcomes[j].append(_outcome(st.insert_certificate, cert, ts))
    assert outcomes[0] == outcomes[1]
    assert [o[0] for o in outcomes[0]].count("raised") == 2
    assert _storage_state(sts[0][0]) == _storage_state(sts[1][0])
    # a round-7 header over the stored round 6; its transmission unknown
    cert7 = next(c for c in (jtypes.BatchCertificate.from_bytes(d[0]) for d in dag)
                 if c.round == 7)
    hdr_raw = cert7.batch_header.to_bytes()
    missing = []
    for st, tmod in sts:
        from snarkos_tpu.node.codec import Reader as JReader
        from snarkos_tpu_torch.node.codec import Reader

        hdr = tmod.BatchHeader.from_reader((JReader if tmod is jtypes else Reader)(hdr_raw))
        res = _outcome(st.check_batch_header, hdr, {})
        missing.append((res[0], [t.to_bytes() for t in res[1]] if res[0] == "ok" else res[1]))
    assert missing[0] == missing[1] and missing[0][0] == "ok" and len(missing[0][1]) == 1
    for st, _ in sts:
        st.increment_to_next_round(7)
    state = [_storage_state(st) for st, _ in sts]
    assert state[0] == state[1]
    assert state[0]["gc"] == 4 and min(state[0]["rounds"]) == 5


def test_persistent_service_files_cross(tmp_path):
    """A BFTPersistentService journal written by the JAX package loads in
    the port, and the port writes the same bytes for the same inserts."""
    dag, _ = jax_dag()
    jpath, ppath = str(tmp_path / "jax.log"), str(tmp_path / "port.log")
    jsvc, psvc = jstorage.BFTPersistentService(jpath), storage.BFTPersistentService(ppath)
    for cert_raw, t_raws in dag[:6]:
        cid = jtypes.BatchCertificate.from_bytes(cert_raw).id
        jts, pts = _decode_transmissions(jtypes, t_raws), _decode_transmissions(types, t_raws)
        jsvc.insert_transmissions(cid, list(jts), jts)
        psvc.insert_transmissions(cid, list(pts), pts)
    jsvc._fh.close()
    psvc._fh.close()
    with open(jpath, "rb") as a, open(ppath, "rb") as b:
        assert a.read() == b.read()
    # replayed, the journal gives each transmission the certificate that
    # first stored it (a later certificate's reference is not journalled)
    loaded = storage.BFTPersistentService(jpath), jstorage.BFTPersistentService(ppath)
    state = []
    for svc in loaded:
        svc._fh.close()
        state.append(sorted((tid.to_bytes(), t.to_bytes(), sorted(ids))
                            for tid, (t, ids) in svc.transmissions.items()))
    assert state[0] == state[1] and len(state[0]) == len(jsvc.transmissions) == 7


def test_proposal_cache_crosses(tmp_path):
    """proposal_cache.store writes the same bytes in both packages, and each
    loads what the other wrote."""
    dag, _ = jax_dag()
    port_accts, _, addrs = accounts()
    cert_raws = [c for c, _ in dag[:5]]
    t_raws = dag[0][1]
    sig = sup.standin_signature(b"x", b"y")
    paths = {}
    for name, mod, tmod, prim in (("jax", jpc, jtypes, jprimary), ("port", pc, types, primary)):
        cert = tmod.BatchCertificate.from_bytes(cert_raws[0])
        prop = prim.Proposal(batch_header=cert.batch_header,
                             transmissions=_decode_transmissions(tmod, t_raws),
                             signatures={addrs[1]: sig})
        paths[name] = str(tmp_path / name / mod.cache_path("d", dev_id=0).replace("/", "_"))
        mod.store(paths[name], addrs[0], 7, prop, {addrs[2]: (6, bytes(range(32)), sig)},
                  [tmod.BatchCertificate.from_bytes(c) for c in cert_raws[1:]])
    assert pc.cache_path("d", dev_id=3) == jpc.cache_path("d", dev_id=3)
    with open(paths["jax"], "rb") as a, open(paths["port"], "rb") as b:
        assert a.read() == b.read()

    def flat(loaded):
        rnd, (hdr, ts, sigs), signed, certs = loaded
        return (rnd, hdr.to_bytes(), sorted(t.to_bytes() for t in ts.values()), sigs, signed,
                [c.to_bytes() for c in certs])

    assert flat(pc.load(paths["jax"], addrs[0])) == flat(jpc.load(paths["port"], addrs[0]))
    assert pc.load(paths["jax"], addrs[1]) is None and jpc.load(paths["port"], addrs[1]) is None
    assert port_accts[0].address == addrs[0]


def test_assign_to_worker_matches_native_sha256d():
    rng = random.Random(4096)
    for _ in range(256):
        kind, digest = rng.choice([0, 1]), bytes(rng.randrange(256) for _ in range(32))
        jtid, ptid = jtypes.TransmissionID(kind, digest), types.TransmissionID(kind, digest)
        for workers in range(1, 5):
            assert primary.assign_to_worker(ptid, workers) == \
                jprimary.assign_to_worker(jtid, workers)


def test_timers_and_limits_are_the_jax_packages():
    names = ("MAX_BATCH_DELAY_S", "MIN_BATCH_DELAY_S", "MAX_FETCH_TIMEOUT_S",
             "MAX_LEADER_CERTIFICATE_DELAY_S", "MAX_TIMESTAMP_DELTA_S", "PRIMARY_PING_S",
             "WORKER_PING_S", "MAX_WORKERS", "MAX_TRANSMISSIONS_PER_BATCH")
    assert {n: getattr(primary, n) for n in names} == {n: getattr(jprimary, n) for n in names}
    assert storage.MAX_GC_ROUNDS == jstorage.MAX_GC_ROUNDS
