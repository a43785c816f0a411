"""The puzzle's leaves and epoch program: the counter-mode Poseidon sponge
(``ops/poseidon.hash_fixed``) and the 12 steps of ``ops/puzzle``'s
``EpochProgram.apply``. Work: the sponge's permutations in their least form
and one Fr product a lane a step."""

from benchmark import work as w

LAYER = "leaves and epoch program (ops/poseidon, ops/puzzle)"
TARGETS = ["snarkos_tpu_torch.ops.poseidon:hash_fixed",
           "snarkos_tpu_torch.ops.puzzle:EpochProgram.apply"]


def work(target: str, args: dict) -> tuple:
    if target.endswith("hash_fixed"):  # inputs (n, L, lanes)
        n_in, _, lanes = args["inputs"].shape
        return w.sponge_work(lanes, args["rate"], n_in, args["num_outputs"])
    _, nonces, k = args["leaves"].shape  # (L, B, K)
    return w.epoch_program_work(nonces, k)
