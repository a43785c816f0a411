"""Crash-recovery proposal cache (helpers/proposal_cache.rs semantics).

On shutdown the primary persists: current round, its in-flight proposal
(+transmissions), the signed-proposals map, and the pending DAG
certificates; at startup the cache is reloaded (validated against the
account address) and replayed (SURVEY.md §6.4 mechanism 2).

The port of ``snarkos_tpu/node/proposal_cache.py``: the same file format.
"""

from __future__ import annotations

import logging
import os

from snarkos_tpu_torch.node.codec import Reader, Writer
from snarkos_tpu_torch.node.types import BatchCertificate, BatchHeader, Transmission

log = logging.getLogger(__name__)


def cache_path(data_dir: str, network: str = "testnet", dev_id: int | None = None) -> str:
    suffix = f"-{dev_id}" if dev_id is not None else ""
    return os.path.join(data_dir, f".current-proposal-cache-{network}{suffix}")


def store(path: str, address: str, current_round: int, proposal, signed_proposals: dict,
          pending_certificates: list) -> None:
    w = Writer()
    w.bytes_var(address.encode())
    w.u64(current_round)
    w.bool_(proposal is not None)
    if proposal is not None:
        w.bytes_var(proposal.batch_header.to_bytes())
        w.u32(len(proposal.transmissions))
        for tid, t in proposal.transmissions.items():
            w.bytes_var(t.to_bytes())
        w.u32(len(proposal.signatures))
        for signer, sig in proposal.signatures.items():
            w.bytes_var(signer.encode())
            w.field(sig[0]).field(sig[1])
    w.u32(len(signed_proposals))
    for author, (round_, batch_id, sig) in signed_proposals.items():
        w.bytes_var(author.encode())
        w.u64(round_)
        w.raw(batch_id)
        w.field(sig[0]).field(sig[1])
    w.u32(len(pending_certificates))
    for cert in pending_certificates:
        w.bytes_var(cert.to_bytes())
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(w.out())


def load(path: str, expected_address: str):
    """Returns (current_round, proposal_parts, signed_proposals, certificates)
    or None. proposal_parts = (header, transmissions dict, signatures dict)."""
    if not os.path.exists(path):
        return None
    try:
        with open(path, "rb") as f:
            r = Reader(f.read())
        address = r.bytes_var().decode()
        if address != expected_address:
            log.warning("proposal cache belongs to %s, ignoring", address[:16])
            return None
        current_round = r.u64()
        proposal = None
        if r.bool_():
            header = BatchHeader.from_reader(Reader(r.bytes_var()))
            transmissions = {}
            for _ in range(r.u32()):
                t = Transmission.from_reader(Reader(r.bytes_var()))
                transmissions[t.id] = t
            signatures = {}
            for _ in range(r.u32()):
                signer = r.bytes_var().decode()
                signatures[signer] = (r.field(), r.field())
            proposal = (header, transmissions, signatures)
        signed_proposals = {}
        for _ in range(r.u32()):
            author = r.bytes_var().decode()
            signed_proposals[author] = (r.u64(), r.take(32), (r.field(), r.field()))
        certificates = [
            BatchCertificate.from_bytes(r.bytes_var()) for _ in range(r.u32())
        ]
        r.expect_done()
        return current_round, proposal, signed_proposals, certificates
    except Exception as exc:
        log.warning("failed to load proposal cache: %s", exc)
        return None
