"""The node's chain layer, the port of the ledger slice of
``snarkos_tpu/node/``: the wire codec, the chain types, the messages, the
state tree and the ledger with its service seams. The network, BFT, roles,
REST and CLI modules are not ported yet; a node runs them through
``snarkos_tpu_torch/node_seam.py``.
"""
