"""The port's node types, codec and messages (snarkos_tpu_torch/node) and its
accounts and signatures (crypto/ref/edwards.py) against the JAX package's,
on the CPU: every object of the golden chain (tests/fixtures/
torch_ledger_dev4.json, made by the JAX ledger) decodes and re-encodes to the
same bytes with the same ids and hashes, and addresses, points and Schnorr
signatures agree on keys made from a numpy seed. Exact throughout."""

import numpy as np
import pytest

from snarkos_tpu.crypto.ref import edwards as jedwards
from snarkos_tpu.node import codec as jcodec, messages as jmessages, types as jtypes
from snarkos_tpu_torch import convert
from snarkos_tpu_torch.crypto.ref import edwards
from snarkos_tpu_torch.node import codec, messages, types

import torch_node_support as sup


def _blocks():
    doc = sup.fixture()
    out = [("genesis", doc["genesis"])]
    out += [(f"block{i + 1}", raw) for i, raw in enumerate(doc["blocks"])]
    out += [(f"tampered-{k}", v["block"]) for k, v in doc["tampered"].items()]
    return out


@pytest.mark.parametrize("name,raw", _blocks(), ids=[b[0] for b in _blocks()])
def test_block_round_trip(name, raw):
    data = bytes.fromhex(raw)
    blk, jblk = convert.block(data), jtypes.Block.from_bytes(data)
    assert blk.to_bytes() == data
    assert blk.hash == jblk.hash
    assert (blk.height, blk.round, blk.epoch_hash, blk.proof_target) == (
        jblk.height, jblk.round, jblk.epoch_hash, jblk.proof_target)
    assert len(blk.transmissions) == len(jblk.transmissions)
    for t, jt in zip(blk.transmissions, jblk.transmissions):
        obj, jobj = t.deserialize(), jt.deserialize()
        assert obj.to_bytes() == jobj.to_bytes() == t.data
        assert (obj.id.kind, obj.id.digest) == (jobj.id.kind, jobj.id.digest)
        assert (t.id.kind, t.id.digest) == (jt.id.kind, jt.id.digest)
        conv = (convert.solution if isinstance(obj, types.Solution) else convert.transaction)
        assert conv(t.data) == obj
        if isinstance(obj, types.Transaction):
            assert convert.varuna_proof(obj.proof).serialize() == obj.proof
    if blk.subdag is not None:
        assert blk.subdag.to_bytes() == jblk.subdag.to_bytes()
        assert [c.id for c in blk.subdag.all_certificates()] == [
            c.id for c in jblk.subdag.all_certificates()]


def test_committee_round_trip():
    data = bytes.fromhex(sup.fixture()["committee"])
    comm = convert.committee(data)
    r = jcodec.Reader(data)
    jcomm = jtypes.Committee.from_reader(r)
    assert comm.to_bytes() == data == jcomm.to_bytes()
    assert comm.id == jcomm.id
    assert len(comm.members) == sup.fixture()["num_validators"] == 4
    for rnd in (2, 4, 6, 100):
        assert comm.get_leader(rnd) == jcomm.get_leader(rnd)
    assert comm.quorum_threshold() == jcomm.quorum_threshold()


def test_certificates_verify_alike():
    """The golden blocks' anchor certificates verify under the committee in
    both packages, and a flipped signature fails in both."""
    doc = sup.fixture()
    comm = convert.committee(bytes.fromhex(doc["committee"]))
    jcomm = jtypes.Committee.from_reader(jcodec.Reader(bytes.fromhex(doc["committee"])))
    cert = convert.block(bytes.fromhex(doc["blocks"][0])).subdag.leader_certificate
    jcert = jtypes.BatchCertificate.from_bytes(cert.to_bytes())
    assert cert.verify(comm) and jcert.verify(jcomm)
    (addr, (c, s)), *rest = cert.signatures
    bad = types.BatchCertificate(cert.batch_header, ((addr, (c, (s + 1) % edwards.ORDER)), *rest))
    jbad = jtypes.BatchCertificate.from_bytes(bad.to_bytes())
    assert not bad.verify(comm) and not jbad.verify(jcomm)


def _accounts(n):
    rng = np.random.default_rng(2024)
    seeds = [rng.bytes(32) for _ in range(n)]
    return [(edwards.Account.new(seed=s), jedwards.Account.new(seed=s)) for s in seeds]


def test_accounts_and_addresses_agree():
    for acct, jacct in _accounts(4):
        assert (acct.sk, acct.pk, acct.address) == (jacct.sk, jacct.pk, jacct.address)
        assert types.address_to_point(acct.address) == jtypes.address_to_point(acct.address)
        assert types.point_to_address(acct.pk) == jtypes.point_to_address(jacct.pk)
        assert edwards.decompress(edwards.compress(acct.pk)) == acct.pk


def test_signatures_agree():
    rng = np.random.default_rng(7)
    for acct, jacct in _accounts(3):
        msg = rng.bytes(int(rng.integers(1, 200)))
        nonce = int(rng.integers(1, 1 << 62))
        sig = edwards.sign_bytes(acct.sk, acct.pk, msg, nonce)
        assert sig == jedwards.sign_bytes(jacct.sk, jacct.pk, msg, nonce)
        assert edwards.verify_bytes(acct.pk, msg, sig) and jedwards.verify_bytes(jacct.pk, msg, sig)
        rsig = edwards.sign_bytes(acct.sk, acct.pk, msg)  # a random nonce
        assert jedwards.verify_bytes(jacct.pk, msg, rsig)
        assert not edwards.verify_bytes(acct.pk, msg + b"\x00", sig)
        assert not jedwards.verify_bytes(jacct.pk, msg + b"\x00", sig)


def test_block_locators_round_trip():
    rng = np.random.default_rng(3)
    recents = tuple((i, rng.bytes(32)) for i in range(5, 9))
    checkpoints = ((0, rng.bytes(32)),)
    loc = messages.BlockLocators(recents=recents, checkpoints=checkpoints)
    w, jw = codec.Writer(), jcodec.Writer()
    loc.write(w)
    jmessages.BlockLocators(recents=recents, checkpoints=checkpoints).write(jw)
    assert w.out() == jw.out()
    back = messages.BlockLocators.read(codec.Reader(w.out()))
    assert back == loc and back.is_well_formed() and back.latest_height == 8
