"""Golden puzzle solutions at degree 2^12 for the PyTorch port's chip check.

Builds (commitment hex, eval_y, witness hex, solution_id) for epoch
b"\\x01" * 32, address "aleo1benchprover", nonces 0-7 from the JAX package's
host reference of the prover pipeline (the one tests/test_puzzle.py builds):
host Poseidon leaves, ``EpochProgram.apply_host``, the Fiat-Shamir challenge,
and the KZG commitment and witness. Because the dev SRS's tau is known, the
commitment sum_i c_i (tau^i G) is computed as p(tau) G and the witness as
q(tau) G with q(tau) = (p(tau) - y) / (tau - z): the same group elements as
the reference's MSMs, at one scalar multiplication each.

    python scripts/make_torch_puzzle_fixture.py [out.json]

Writes tests/fixtures/torch_puzzle_k12_b8.json by default, in seconds on a
CPU with the repository's native Poseidon library (2.6 s measured on an
8-core x86 CPU).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from snarkos_tpu.crypto import params  # noqa: E402
from snarkos_tpu.crypto.ref import g1 as ref_g1, ntt as ref_ntt, poseidon as ref_poseidon  # noqa: E402
from snarkos_tpu.ops.puzzle import (COEFF_DOMAIN, EpochProgram, Puzzle, _g1_to_bytes,  # noqa: E402
                                    sha64)

R = params.FR_MODULUS
LOG_DEGREE = 12
EPOCH_HASH = b"\x01" * 32
ADDRESS = "aleo1benchprover"
NONCES = list(range(8))
TAU = pow(params.FR_GENERATOR, 0xDEADBEEF, R)  # snarkos_tpu/ops/puzzle.py:129


def solution(prog: EpochProgram, nonce: int) -> dict:
    k = 1 << LOG_DEGREE
    seed = Puzzle._seed_field(None, EPOCH_HASH, ADDRESS, nonce)
    leaves = [ref_poseidon.hash_many([seed, i], rate=2, domain=COEFF_DOMAIN)[0]
              for i in range(k)]
    coeffs = prog.apply_host(leaves)
    p_tau = ref_ntt.poly_eval(coeffs, TAU)
    c_bytes = _g1_to_bytes(ref_g1.scalar_mul(p_tau, ref_g1.GENERATOR))
    z = Puzzle._challenge(None, c_bytes)
    y = ref_ntt.poly_eval(coeffs, z)
    q_tau = (p_tau - y) * pow(TAU - z, -1, R) % R
    w_bytes = _g1_to_bytes(ref_g1.scalar_mul(q_tau, ref_g1.GENERATOR))
    return {"nonce": nonce, "commitment": c_bytes.hex(), "eval_y": str(y),
            "witness": w_bytes.hex(),
            "solution_id": str(sha64(c_bytes, y.to_bytes(32, "little")))}


def main() -> None:
    out = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "tests", "fixtures",
        "torch_puzzle_k12_b8.json")
    t0 = time.time()
    prog = EpochProgram(EPOCH_HASH, 1 << LOG_DEGREE)
    rows = [solution(prog, n) for n in NONCES]
    doc = {"log_degree": LOG_DEGREE, "epoch_hash": EPOCH_HASH.hex(), "address": ADDRESS,
           "solutions": rows}
    with open(out, "w") as fh:
        json.dump(doc, fh, indent=1)
        fh.write("\n")
    print(f"wrote {out} in {time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
