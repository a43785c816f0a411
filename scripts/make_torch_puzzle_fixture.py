"""Golden puzzle solutions for the PyTorch port's tests and chip check.

Builds (commitment hex, eval_y, witness hex, solution_id) for epoch
b"\\x01" * 32, address "aleo1benchprover", nonces 0 .. N - 1 (N = 8 unless
``--nonces`` says otherwise) at degree 2^LOG (12 unless ``--log-degree``
says otherwise) from the JAX package's
host reference of the prover pipeline (the one tests/test_puzzle.py builds):
host Poseidon leaves, ``EpochProgram.apply_host``, the Fiat-Shamir challenge,
and the KZG commitment and witness. Because the dev SRS's tau is known, the
commitment sum_i c_i (tau^i G) is computed as p(tau) G and the witness as
q(tau) G with q(tau) = (p(tau) - y) / (tau - z): the same group elements as
the reference's MSMs, at one scalar multiplication each.

    python scripts/make_torch_puzzle_fixture.py [--log-degree LOG] [--nonces N] [out.json]

Writes tests/fixtures/torch_puzzle_k{LOG}_b{N}.json by default. With the
repository's native Poseidon library on an 8-core x86 CPU: the default
(2^12, 8 nonces) in 2.6 s; the committed fixtures at log degree 0-3 (8
nonces) in seconds, 16 (8 nonces) and 20 (2 nonces) in minutes, the time
going to the host epoch program and the leaves. At log degree 0 the
quotient is 0 and the witness is the identity.
"""

import argparse
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
EPOCH_HASH = b"\x01" * 32
ADDRESS = "aleo1benchprover"
TAU = pow(params.FR_GENERATOR, 0xDEADBEEF, R)  # snarkos_tpu/ops/puzzle.py:129


def solution(prog: EpochProgram, log_degree: int, nonce: int) -> dict:
    k = 1 << log_degree
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
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log-degree", type=int, default=12)
    ap.add_argument("--nonces", type=int, default=8, help="nonces 0 .. N - 1")
    ap.add_argument("out", nargs="?", help="default tests/fixtures/torch_puzzle_k{LOG}_b{N}.json")
    args = ap.parse_args()
    out = args.out or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "tests", "fixtures",
        f"torch_puzzle_k{args.log_degree}_b{args.nonces}.json")
    t0 = time.time()
    prog = EpochProgram(EPOCH_HASH, 1 << args.log_degree)
    rows = [solution(prog, args.log_degree, n) for n in range(args.nonces)]
    doc = {"log_degree": args.log_degree, "epoch_hash": EPOCH_HASH.hex(), "address": ADDRESS,
           "solutions": rows}
    with open(out, "w") as fh:
        json.dump(doc, fh, indent=1)
        fh.write("\n")
    print(f"wrote {out} in {time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
