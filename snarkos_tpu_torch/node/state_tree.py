"""Merkle ledger state tree: verifiable state roots and inclusion paths.

Reference parity: snarkOS serves `stateRoot/latest`, `stateRoot/{height}`,
`statePath/{commitment}` and `find/blockHeight/{stateRoot}` from snarkVM's
ledger Merkle tree (node/rest/src/routes.rs:252-269,
331-338). A state root equal to the block hash and a path made of the
hash chain would commit to no mapping or program state, and a light client
would have nothing to verify against.

This module is the real thing, designed for this framework's ledger shape:

    state_root(h) = sha256d(0x02 || block_root(h) || mapping_root(h))

      block_root(h)   = Merkle root over block leaves for heights 0..h,
                        leaf = sha256d(0x00 || height || block_hash || tx_root)
                        where tx_root is the Merkle root of the block's
                        transmission-id digests (so a transmission's
                        inclusion is provable through two nested paths).
      mapping_root(h) = Merkle root over the key-sorted on-chain mapping
                        entries after executing block h,
                        leaf = sha256d(0x01 || program || mapping || key || value)

Odd nodes promote unchanged (no duplicate-last), which keeps audit paths
unambiguous. Proofs are lists of (sibling_hex, sibling_is_right) steps;
``verify_*`` functions are self-contained so an external light client can
re-implement them from this docstring alone.
"""

from __future__ import annotations

import hashlib
from typing import Optional


def _sha256d(data: bytes) -> bytes:
    return hashlib.sha256(hashlib.sha256(data).digest()).digest()


def _enc_str(s: str) -> bytes:
    b = s.encode()
    return len(b).to_bytes(2, "little") + b


def mapping_leaf(program: str, mapping: str, key: str, value: str) -> bytes:
    return _sha256d(b"\x01" + _enc_str(program) + _enc_str(mapping)
                    + _enc_str(key) + _enc_str(value))


def block_leaf(height: int, block_hash: bytes, tx_root: bytes) -> bytes:
    return _sha256d(b"\x00" + height.to_bytes(4, "little") + block_hash + tx_root)


def tx_leaf(tid_digest: bytes) -> bytes:
    return _sha256d(b"\x03" + tid_digest)


def combine_roots(block_root: bytes, mapping_root: bytes) -> bytes:
    return _sha256d(b"\x02" + block_root + mapping_root)


_EMPTY = _sha256d(b"\x04empty")


def merkle_root(leaves: list[bytes]) -> bytes:
    """Binary Merkle root; odd node promotes unchanged; empty -> fixed tag."""
    if not leaves:
        return _EMPTY
    level = list(leaves)
    while len(level) > 1:
        nxt = []
        for i in range(0, len(level) - 1, 2):
            nxt.append(_sha256d(b"\x05" + level[i] + level[i + 1]))
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
    return level[0]


def audit_path(leaves: list[bytes], index: int) -> list[tuple[bytes, bool]]:
    """Siblings from leaf to root: [(sibling, sibling_is_right), ...].
    Levels where the node is a promoted odd tail contribute no step."""
    assert 0 <= index < len(leaves)
    path = []
    level = list(leaves)
    idx = index
    while len(level) > 1:
        if idx % 2 == 0:
            if idx + 1 < len(level):
                path.append((level[idx + 1], True))
        else:
            path.append((level[idx - 1], False))
        nxt = []
        for i in range(0, len(level) - 1, 2):
            nxt.append(_sha256d(b"\x05" + level[i] + level[i + 1]))
        if len(level) % 2:
            nxt.append(level[-1])
        # promoted odd tail keeps its position at the end of the next level
        idx = idx // 2 if idx + 1 < len(level) or idx % 2 else len(nxt) - 1
        level = nxt
    return path


def follow_path(leaf: bytes, path: list[tuple[bytes, bool]]) -> bytes:
    node = leaf
    for sibling, sibling_is_right in path:
        if sibling_is_right:
            node = _sha256d(b"\x05" + node + sibling)
        else:
            node = _sha256d(b"\x05" + sibling + node)
    return node


def verify_path(root: bytes, leaf: bytes, path: list[tuple[bytes, bool]]) -> bool:
    return follow_path(leaf, path) == root


# -------------------------------------------------------------------- tree --


def mapping_leaves(mappings: dict) -> list[bytes]:
    """Key-sorted leaves over {(program, mapping): {key: value}}."""
    entries = []
    for (program, mapping), kv in mappings.items():
        for key, value in kv.items():
            entries.append((program, mapping, key, value))
    entries.sort()
    return [mapping_leaf(*e) for e in entries]


class StateTree:
    """Incrementally-maintained ledger state tree.

    ``append_block`` is called once per indexed block (including replay at
    load) with the block and the mappings AFTER executing it; it records
    the per-height state root. Mapping leaves are rebuilt per block —
    O(M log M) with M = total mapping entries, fine at devnet scale; the
    block-leaf list grows append-only.
    """

    # heights of retained mapping-entry snapshots: historical mapping
    # proofs are servable this far back (matching the reference's
    # recent-locator window); block-side proofs are servable at EVERY
    # height (block leaves are append-only)
    MAPPING_HISTORY = 100

    def __init__(self):
        self.block_leaves: list[bytes] = []
        self.tx_roots: list[bytes] = []  # per height
        self.state_roots: list[bytes] = []  # per height
        self.mapping_roots: list[bytes] = []  # per height
        self.root_index: dict[bytes, int] = {}  # state_root -> height
        self._entries_by_height: dict[int, list] = {}  # recent snapshots

    @property
    def _mapping_entries(self) -> list:
        """Sorted mapping entries at the latest height."""
        h = len(self.state_roots) - 1
        return self._entries_by_height.get(h, [])

    def mapping_history(self, height: int, mapping: str):
        """The full content of every mapping named ``mapping`` as of
        ``height`` (reference: GET /block/{h}/history/{mapping},
        rest/src/routes.rs:453-464 behind the "history" feature), or
        None when the snapshot is outside the retained window."""
        entries = self._entries_by_height.get(height)
        if entries is None:
            return None
        return [{"program": p, "key": k, "value": v}
                for (p, m, k, v) in entries if m == mapping]

    def append_block(self, block, mappings: dict) -> bytes:
        tx_root = merkle_root([tx_leaf(t.id.digest) for t in block.transmissions])
        self.tx_roots.append(tx_root)
        self.block_leaves.append(block_leaf(block.height, block.hash, tx_root))
        entries = []
        for (program, mapping), kv in mappings.items():
            for key, value in kv.items():
                entries.append((program, mapping, key, value))
        entries.sort()
        h = len(self.state_roots)
        self._entries_by_height[h] = entries
        self._entries_by_height.pop(h - self.MAPPING_HISTORY, None)
        mapping_root = merkle_root([mapping_leaf(*e) for e in entries])
        self.mapping_roots.append(mapping_root)
        root = combine_roots(merkle_root(self.block_leaves), mapping_root)
        self.state_roots.append(root)
        self.root_index[root] = block.height
        return root

    def state_root(self, height: int) -> Optional[bytes]:
        if 0 <= height < len(self.state_roots):
            return self.state_roots[height]
        return None

    def height_of_root(self, root: bytes) -> Optional[int]:
        return self.root_index.get(root)

    # -- proofs (latest root by default, or any historical root by height
    #    — reference routes.rs:252-269 serves statePath against the root
    #    a light client trusts, not only the tip) ---------

    def _resolve_height(self, at_height: Optional[int]) -> Optional[int]:
        last = len(self.state_roots) - 1
        h = last if at_height is None else at_height
        return h if 0 <= h <= last else None

    def transmission_path(self, blocks, tid_digest: bytes,
                          at_height: Optional[int] = None) -> Optional[dict]:
        """Inclusion proof of a transmission id under the state root at
        ``at_height`` (default: latest): tid -> tx_root (inner path) ->
        block leaf -> block_root (outer path) -> state root. ``blocks``
        is the ledger's block list. Servable at EVERY height: the outer
        path is computed over the block-leaf prefix [0..h]."""
        h = self._resolve_height(at_height)
        if h is None:
            return None
        for block in reversed(blocks[:h + 1]):
            ids = [t.id.digest for t in block.transmissions]
            if tid_digest in ids:
                tx_index = ids.index(tid_digest)
                leaves = [tx_leaf(d) for d in ids]
                inner = audit_path(leaves, tx_index)
                outer = audit_path(self.block_leaves[:h + 1], block.height)
                return {
                    "type": "transmission",
                    "transmission_id": tid_digest.hex(),
                    "block_height": block.height,
                    "block_hash": block.hash.hex(),
                    "tx_root": self.tx_roots[block.height].hex(),
                    "tx_path": [[s.hex(), r] for s, r in inner],
                    "block_path": [[s.hex(), r] for s, r in outer],
                    "mapping_root": self.mapping_roots[h].hex(),
                    "state_root": self.state_roots[h].hex(),
                }
        return None

    def mapping_path(self, program: str, mapping: str, key: str,
                     at_height: Optional[int] = None) -> Optional[dict]:
        """Inclusion proof of a (program, mapping, key) -> value entry
        under the state root at ``at_height`` (default: latest). Mapping
        snapshots are retained for the last MAPPING_HISTORY heights;
        older heights return None."""
        h = self._resolve_height(at_height)
        if h is None:
            return None
        entries = self._entries_by_height.get(h)
        if entries is None:
            return None
        for i, e in enumerate(entries):
            if e[:3] == (program, mapping, key):
                leaves = [mapping_leaf(*x) for x in entries]
                path = audit_path(leaves, i)
                return {
                    "type": "mapping",
                    "program": program,
                    "mapping": mapping,
                    "key": key,
                    "value": e[3],
                    "mapping_path": [[s.hex(), r] for s, r in path],
                    "block_root": merkle_root(self.block_leaves[:h + 1]).hex(),
                    "state_root": self.state_roots[h].hex(),
                }
        return None


# ------------------------------------------------------- proof verification --


def verify_transmission_path(proof: dict) -> bool:
    """Light-client check of a ``transmission_path`` proof: recomputes the
    nested Merkle walk and the state-root combination."""
    try:
        tid = bytes.fromhex(proof["transmission_id"])
        inner = [(bytes.fromhex(s), bool(r)) for s, r in proof["tx_path"]]
        outer = [(bytes.fromhex(s), bool(r)) for s, r in proof["block_path"]]
        tx_root = follow_path(tx_leaf(tid), inner)
        if tx_root != bytes.fromhex(proof["tx_root"]):
            return False
        leaf = block_leaf(proof["block_height"],
                          bytes.fromhex(proof["block_hash"]), tx_root)
        block_root = follow_path(leaf, outer)
        root = combine_roots(block_root, bytes.fromhex(proof["mapping_root"]))
        return root == bytes.fromhex(proof["state_root"])
    except (KeyError, ValueError, TypeError):
        return False


def verify_mapping_path(proof: dict) -> bool:
    try:
        leaf = mapping_leaf(proof["program"], proof["mapping"], proof["key"],
                            proof["value"])
        path = [(bytes.fromhex(s), bool(r)) for s, r in proof["mapping_path"]]
        mapping_root = follow_path(leaf, path)
        root = combine_roots(bytes.fromhex(proof["block_root"]), mapping_root)
        return root == bytes.fromhex(proof["state_root"])
    except (KeyError, ValueError, TypeError):
        return False
