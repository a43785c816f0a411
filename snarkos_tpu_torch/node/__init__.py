"""The node, the port of ``snarkos_tpu/node/``: the wire codec, the chain
types, the messages, the state tree and the ledger with its service seams;
the BFT events, the Narwhal storage and DAG, the primary, the BFT commit
rule, the proposal cache, the metrics and ``Consensus`` (``bft/``,
``events``, ``consensus``); the network planes: the TCP stack, the public
router, the validators' gateway and the block sync (``tcp``, ``router``,
``gateway``, ``block_sync``). The roles, REST, the CDN, the display and the
CLI are not ported yet; a node runs them through
``snarkos_tpu_torch/node_seam.py``.
"""
