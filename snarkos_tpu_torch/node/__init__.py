"""The node, the port of ``snarkos_tpu/node/``: the wire codec, the chain
types, the messages, the state tree and the ledger with its service seams;
the BFT events, the Narwhal storage and DAG, the primary, the BFT commit
rule, the proposal cache, the metrics and ``Consensus`` (``bft/``,
``events``, ``consensus``); the network planes: the TCP stack, the public
router, the validators' gateway and the block sync (``tcp``, ``router``,
``gateway``, ``block_sync``); the node's roles, its REST API, the CDN
bootstrap, the terminal display and the CLI (``roles``, ``rest``, ``cdn``,
``display``, ``cli``): ``python -m snarkos_tpu_torch.node.cli start``
starts a Validator, Client or Prover on the card.
"""
